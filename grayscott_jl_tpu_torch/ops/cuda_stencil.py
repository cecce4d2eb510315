"""Fused stencil kernel dispatch (counterpart of
``grayscott_jl_tpu/ops/pallas_stencil.py``).

:func:`fused_step` advances a model's interior-shaped fields ``fuse``
explicit-Euler steps with the same contract as the reference's
``pallas_stencil.fused_step``. For tensors on the card it launches the
hand-written CUDA kernel ``ops/csrc/stencil_chain.cu`` — or raises: a
build or launch error, a model the kernel does not carry, or a dtype it
does not take stops the run. For tensors on the CPU it runs the plain
torch version of the same function (:func:`plain_chain`), which is also
the kernel's oracle on the card.

The plain versions: :func:`plain_step` is the torch form of the
reference's ``_xla_fallback`` (one step on ghost-padded fields with the
position-keyed noise), and :func:`plain_chain` is ``fuse`` plain steps
with the seed step advanced — which the kernel's ``fuse``-stage chain
equals bitwise, as the reference's chain equals ``fuse`` single steps.

The shared-memory ledger (:func:`smem_bytes`, :func:`max_feasible_fuse`)
replaces the reference's VMEM slab ledger: the kernel keeps two
ping-pong buffers of each field's window — the ``TILE`` plus a
``fuse``-cell halo per side — in shared memory, and a requested depth
above what fits runs as a sequence of shallower launches.

``LAUNCHES`` counts kernel launches (not plain-path calls): a run
reads it to show that its steps went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import kernelgen, stencil
from .noise import uniform_pm1_block

#: Launches of the CUDA kernel since the process started (or the
#: caller last set it to 0).
LAUNCHES = 0

#: Interior tile of one thread block, (x, y, z); z is contiguous. Must
#: equal TX/TY/TZ in stencil_chain.cu (checked when the library loads).
TILE = (8, 8, 32)

#: Shared memory one block may use on Hopper (227 KB of the SM's 256).
SMEM_LIMIT = 232_448

#: Ping-pong window buffers per field.
N_BUFFERS = 2

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def smem_bytes(itemsize: int, fuse: int, n_fields: int = 2,
               tile: Tuple[int, int, int] = TILE) -> int:
    """Dynamic shared memory of one block at chain depth ``fuse``."""
    window = math.prod(t + 2 * fuse for t in tile)
    return n_fields * N_BUFFERS * window * itemsize


def max_feasible_fuse(itemsize: int, n_fields: int = 2,
                      limit: int = SMEM_LIMIT) -> int:
    """Deepest chain whose windows fit in shared memory: 5 for float32,
    2 for float64 with two fields."""
    k = 0
    while smem_bytes(itemsize, k + 1, n_fields) <= limit:
        k += 1
    return k


def plain_step(fields, params, seeds, *, spec, use_noise=True,
               offsets=None, row=None):
    """One step on interior-shaped fields in plain torch (the reference's
    ``_xla_fallback`` with ``faces=None``): pad with the frozen boundary,
    draw the step's noise at the block's global ``offsets``, and apply
    :func:`~.stencil.reaction_update`."""
    pads = tuple(
        stencil.pad_with_boundary(f, bv)
        for f, bv in zip(fields, spec.boundaries)
    )
    shape = fields[0].shape
    if use_noise:
        unit = uniform_pm1_block(
            seeds[:2], seeds[2], offsets or (0, 0, 0), shape,
            shape[2] if row is None else row, fields[0].dtype,
            device=fields[0].device,
        )
        noise_term = params.noise * unit
    else:
        noise_term = 0.0
    return stencil.reaction_update(pads, noise_term, params, spec.model)


def plain_chain(fields, params, seeds, *, spec, use_noise=True, fuse=1,
                offsets=None, row=None):
    """``fuse`` plain steps, step ``s`` seeded at ``seeds[2] + s``."""
    fields = tuple(fields)
    for s in range(fuse):
        fields = plain_step(
            fields, params, (seeds[0], seeds[1], seeds[2] + s), spec=spec,
            use_noise=use_noise, offsets=offsets, row=row,
        )
    return fields


def _check_faces(faces, n_f, fuse, name):
    """The reference's arity checks on ``faces``; every valid form is a
    multi-device mode, which this package does not have yet."""
    x_chain = len(faces) == 2 * n_f
    if not x_chain and len(faces) != 6 * n_f:
        raise ValueError(
            f"faces for the {n_f}-field model {name!r} must be the "
            f"{2 * n_f}-tuple x-chain form or the {6 * n_f}-tuple 3D "
            f"form; got {len(faces)}"
        )
    if fuse > 1 and not x_chain:
        raise ValueError(
            "temporal blocking with faces requires the x-chain mode "
            "(1D-sharded, two fuse-wide x faces per field); the "
            "full-faces 3D mode is fuse=1 only"
        )
    if x_chain and fuse < 2:
        raise ValueError("the x-chain faces mode requires fuse >= 2")
    raise NotImplementedError(
        "halo faces (the sharded 6n-face, x-chain and xy-chain modes) "
        "arrive with the multi-GPU slice 2 (ROADMAP Queue 2 items 6-8)"
    )


def fused_step(fields, params, seeds, faces=None, *, spec, use_noise=True,
               fuse=1, offsets=None, row=None):
    """``fuse`` fused steps of ``spec``'s model on interior-shaped
    fields (an n-tuple of (nx, ny, nz) tensors in declaration order).

    ``seeds`` is ``(k0, k1, step)``: the key words and the absolute step
    of the first of the ``fuse`` steps, as Python ints. ``offsets`` is
    the block's global origin (default zeros) and ``row`` the global
    grid side (default nz); both key the noise. ``faces`` must be None.

    CUDA tensors go through the kernel (or raise); CPU tensors through
    :func:`plain_chain`. Returns the new field tuple."""
    fields = tuple(fields)
    n_f = spec.n_fields
    if len(fields) != n_f:
        raise ValueError(
            f"model {spec.name!r} declares {n_f} field(s); "
            f"got {len(fields)}"
        )
    if faces is not None:
        _check_faces(faces, n_f, fuse, spec.name)
    if fuse < 1:
        raise ValueError(f"fuse must be >= 1, got {fuse}")
    offsets = tuple(int(o) for o in (offsets or (0, 0, 0)))
    nz = fields[0].shape[2]
    row = nz if row is None else int(row)
    if not fields[0].is_cuda:
        return plain_chain(fields, params, seeds, spec=spec,
                           use_noise=use_noise, fuse=fuse,
                           offsets=offsets, row=row)
    cap = max_feasible_fuse(fields[0].element_size(), n_f)
    step = int(seeds[2])
    done = 0
    while done < fuse:
        k = min(cap, fuse - done)
        fields = _launch(fields, params, (seeds[0], seeds[1], step + done),
                         spec=spec, use_noise=use_noise, fuse=k,
                         offsets=offsets, row=row)
        done += k
    return fields


def _lib():
    from . import _build

    lib = _build.load("stencil_chain")
    if not getattr(lib, "_gs_ready", False):
        tile = (ctypes.c_int * 3)()
        lib.gs_tile_shape.argtypes = [ctypes.c_void_p]
        lib.gs_tile_shape.restype = None
        lib.gs_tile_shape(ctypes.cast(tile, ctypes.c_void_p))
        if tuple(tile) != TILE:
            raise RuntimeError(
                f"stencil_chain.cu tile {tuple(tile)} != ledger TILE {TILE}"
            )
        lib.gs_error_string.argtypes = [ctypes.c_int]
        lib.gs_error_string.restype = ctypes.c_char_p
        for suffix, scalar in (("f32", ctypes.c_float),
                               ("f64", ctypes.c_double)):
            fn = getattr(lib, f"gs_stencil_chain_{suffix}")
            fn.argtypes = (
                [ctypes.c_void_p] * 5
                + [ctypes.c_uint32] * 3
                + [ctypes.c_int] * 3
                + [ctypes.c_uint32]
                + [ctypes.c_int] * 5
                + [scalar, scalar, ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
        lib._gs_ready = True
    return lib


def _launch(fields, params, seeds, *, spec, use_noise, fuse, offsets, row):
    """One kernel launch advancing ``fuse`` steps (``fuse`` <= the
    ledger's cap)."""
    global LAUNCHES
    reason = kernelgen.generation_gate_reason(spec.model)
    if reason is not None:
        raise kernelgen.KernelGenError(reason)
    u, v = fields
    dtype = u.dtype
    if dtype not in _DTYPES:
        raise TypeError(
            f"the CUDA kernel takes float32 or float64 fields, got {dtype}"
        )
    for f in fields:
        if f.device != u.device or f.dtype != dtype or f.shape != u.shape:
            raise ValueError(
                "fields must share device, dtype and shape; got "
                f"{[(t.device, t.dtype, tuple(t.shape)) for t in fields]}"
            )
        if f.dim() != 3 or not f.is_contiguous():
            raise ValueError("fields must be contiguous 3D tensors")
    nx, ny, nz = u.shape
    if u.numel() >= 2**31:
        raise ValueError(f"field shape {tuple(u.shape)} is too large")
    params_vec = torch.stack(
        [getattr(params, f).to(device=u.device, dtype=dtype)
         for f in spec.param_fields]
    )
    u_out = torch.empty_like(u)
    v_out = torch.empty_like(v)
    fn = getattr(_lib(), f"gs_stencil_chain_{_DTYPES[dtype]}")
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = fn(
            u.data_ptr(), v.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
            params_vec.data_ptr(),
            int(seeds[0]) & 0xFFFFFFFF, int(seeds[1]) & 0xFFFFFFFF,
            int(seeds[2]) & 0xFFFFFFFF,
            offsets[0], offsets[1], offsets[2], row & 0xFFFFFFFF,
            nx, ny, nz, fuse, int(bool(use_noise)),
            spec.boundaries[0], spec.boundaries[1], stream,
        )
    if rc != 0:
        msg = _lib().gs_error_string(rc).decode()
        raise RuntimeError(
            f"stencil_chain launch failed (fuse={fuse}, shape="
            f"{tuple(u.shape)}, {dtype}): CUDA error {rc}: {msg}"
        )
    LAUNCHES += 1
    return u_out, v_out

