"""Carry state from the reference package into this one.

The reference (``grayscott_jl_tpu``) holds its params as a NamedTuple
of JAX scalars and its fields as JAX arrays; handed over as numpy, they
become this package's params (0-dim tensors) and fields (tensors) with
no rounding in between. The tests use these to feed both packages the
same state; restarting from a checkpoint written by the reference is the
file form of the same hand-over.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


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
        f: torch.tensor(np.asarray(params_np[f]), dtype=dtype,
                        device=device)
        for f in model.params_cls._fields
    })


def fields_from_reference(fields_np: Sequence, device):
    """The reference's fields, as numpy arrays, as contiguous tensors
    of the same dtype on ``device``."""
    return tuple(
        torch.from_numpy(np.array(f, copy=True, order="C")).to(device)
        for f in fields_np
    )
