"""Carry state from the reference package into this one.

The reference (``grayscott_jl_tpu``) holds its params as a NamedTuple
of JAX scalars and its fields as JAX arrays; handed over as numpy, they
become this package's params (0-dim tensors) and fields (tensors) with
no rounding in between. The tests use these to feed both packages the
same state; restarting from a checkpoint written by the reference is the
file form of the same hand-over. :func:`blocks_from_reference` hands a
reference run's global fields to a sharded simulation of this package,
block by block. bfloat16 arrays (``ml_dtypes`` arrays on the reference
side) cross as float32, which holds every bf16 value exactly.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .io.bplite import BF16, dtype_name


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, dtype_name(dtype))


def _numpy(a) -> np.ndarray:
    """``a`` as a numpy array torch can take: a bfloat16 array widened
    exactly to float32."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == BF16 else a


def params_from_reference(params_np: Mapping, dtype, device, model=None):
    """The reference's params — a mapping of field name to a numpy
    scalar, e.g. ``{k: np.asarray(v) for k, v in params._asdict().items()}``
    — as this package's Params of ``model`` (Gray-Scott by default):
    0-dim tensors of ``dtype`` on ``device``."""
    if model is None:
        from .models.grayscott import MODEL as model
    dtype = _torch_dtype(dtype)
    missing = set(model.params_cls._fields) - set(params_np)
    if missing:
        raise ValueError(f"params lack {sorted(missing)}")
    return model.params_cls(**{
        f: torch.tensor(_numpy(params_np[f]), dtype=dtype, device=device)
        for f in model.params_cls._fields
    })


def fields_from_reference(fields_np: Sequence, device):
    """The reference's fields, as numpy arrays, as contiguous tensors
    of the same dtype on ``device``."""
    return tuple(
        torch.from_numpy(np.array(_numpy(f), copy=True, order="C")).to(
            device=device, dtype=_torch_dtype(np.asarray(f).dtype))
        for f in fields_np
    )


def blocks_from_reference(fields_np: Sequence, sim):
    """The reference's global fields — numpy arrays of ``L^3`` or of a
    sharded run's padded storage shape, as ``np.asarray`` of its field
    arrays gives them — as ``sim``'s per-block tensors, bitwise: each
    block's box on that block's device. Assign the result to
    ``sim.blocks`` to step the same state in both packages."""
    fields_np = [np.asarray(f) for f in fields_np]
    if len(fields_np) != sim.model.n_fields:
        raise ValueError(
            f"got {len(fields_np)} fields; model {sim.model.name!r} "
            f"declares {sim.model.n_fields}"
        )
    want = dtype_name(sim.dtype)
    shapes = ((sim.settings.L,) * 3, tuple(sim.domain.storage_shape))
    for f in fields_np:
        if f.dtype.name != want or f.shape not in shapes:
            raise ValueError(
                f"reference field {f.dtype} {f.shape} does not match the "
                f"run's {want} {shapes[0]} (or storage {shapes[1]})"
            )
    return sim.scatter([_numpy(f) for f in fields_np])
