"""Fused stencil kernel dispatch (counterpart of
``grayscott_jl_tpu/ops/pallas_stencil.py``).

:func:`fused_step` advances a model's interior-shaped fields ``fuse``
explicit-Euler steps with the same contract as the reference's
``pallas_stencil.fused_step``, in its three forms: no faces (a whole
grid with a frozen ghost shell), the 6n-face form (one step of a block
of a 3D-sharded grid) and the 2n-face x-chain form (``fuse`` steps
across an x shard boundary, also run on the y-extended operand of
``parallel/temporal.xy_chain``). For tensors on the card it launches the
model's kernel, generated by ``ops/kernelgen.py`` from the hand-written
template ``ops/csrc/stencil_chain.cu`` (one library per model, built by
``ops/_build.py``) — or raises: a build or launch error, or a dtype it
does not take, stops the run; a model the generator refuses has no
spec. For tensors on the CPU it runs the plain torch version of the
same function, which is also the kernel's oracle on the card.

The plain versions: :func:`plain_step` is the torch form of the
reference's ``_xla_fallback`` (one step on ghost-padded fields with the
position-keyed noise; with 6n faces the ghosts come from
:func:`pad_from_faces`), :func:`plain_chain` is ``fuse`` plain steps
with the seed step advanced — which the kernel's ``fuse``-stage chain
equals bitwise, as the reference's chain equals ``fuse`` single steps —
and :func:`plain_xchain` is ``_xla_xchain_fallback``.

The shared-memory ledger (:func:`smem_bytes`, :func:`max_feasible_fuse`)
replaces the reference's VMEM slab ledger: the kernel keeps two
ping-pong buffers of the window of each of the model's fields — the
``TILE`` plus a ``fuse``-cell halo per side — in shared memory. Without
faces, a requested depth above what fits runs as a sequence of
shallower launches; an x-chain's depth is its slabs' width, so the
caller caps it (the simulation does, with a warning) and a deeper one
raises.

``LAUNCHES`` counts kernel launches (not plain-path calls),
``MODE_LAUNCHES`` splits them by mode and ``MODEL_LAUNCHES`` by model:
a run reads them to show that its steps went through the kernel
generated for its model.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import stencil
from .noise import uniform_pm1_block

#: Launches of the CUDA kernel since the process started (or the
#: caller last reset them).
LAUNCHES = 0

#: The kernel's modes: no faces (``chain``), 6n faces (``faces6``), the
#: x-chain (``xchain``) and the x-chain on the xy-chain's y-extended
#: operand (``xychain``). The integer is the kernel's ``Mode``.
MODES: Dict[str, int] = {"chain": 0, "faces6": 1, "xchain": 2, "xychain": 2}

#: Launches per mode, counted beside :data:`LAUNCHES`.
MODE_LAUNCHES: Dict[str, int] = dict.fromkeys(MODES, 0)

#: Launches per model (the generated kernel that ran), counted beside
#: :data:`LAUNCHES`.
MODEL_LAUNCHES: Dict[str, int] = {}

#: Interior tile of one thread block, (x, y, z); z is contiguous. Must
#: equal TX/TY/TZ in stencil_chain.cu (checked when the library loads).
TILE = (8, 8, 32)

#: Shared memory one block may use on Hopper (227 KB of the SM's 256).
SMEM_LIMIT = 232_448

#: Ping-pong window buffers per field.
N_BUFFERS = 2

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def reset_launches() -> None:
    """Set :data:`LAUNCHES` and every :data:`MODE_LAUNCHES` and
    :data:`MODEL_LAUNCHES` count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    for mode in MODE_LAUNCHES:
        MODE_LAUNCHES[mode] = 0
    MODEL_LAUNCHES.clear()


def smem_bytes(itemsize: int, fuse: int, n_fields: int = 2,
               tile: Tuple[int, int, int] = TILE) -> int:
    """Dynamic shared memory of one block at chain depth ``fuse``."""
    window = math.prod(t + 2 * fuse for t in tile)
    return n_fields * N_BUFFERS * window * itemsize


def max_feasible_fuse(itemsize: int, n_fields: int = 2,
                      limit: int = SMEM_LIMIT) -> int:
    """Deepest chain whose windows fit in shared memory: 5 for float32
    and 2 for float64 with two fields, 8 and 5 with one. The face modes
    use the same window, so this also caps the x-chain and the
    xy-chain."""
    k = 0
    while smem_bytes(itemsize, k + 1, n_fields) <= limit:
        k += 1
    return k


def pad_from_faces(x, xlo, xhi, ylo, yhi, zlo, zhi):
    """Ghost-pad an interior block with resolved halo faces (the
    reference's ``_pad_from_faces``; edge and corner ghosts get zeros —
    the 7-point stencil never reads them)."""
    x = torch.cat([xlo, x, xhi], dim=0)
    x = torch.cat([F.pad(ylo, (0, 0, 0, 0, 1, 1)), x,
                   F.pad(yhi, (0, 0, 0, 0, 1, 1))], dim=1)
    return torch.cat([F.pad(zlo, (0, 0, 1, 1, 1, 1)), x,
                      F.pad(zhi, (0, 0, 1, 1, 1, 1))], dim=2)


def _model(spec):
    """The model declaration of a kernel spec; the plain versions also
    take the declaration itself as ``spec`` (they need nothing else, and
    a model the generator refuses has no spec)."""
    return getattr(spec, "model", spec)


def plain_step(fields, params, seeds, faces=None, *, spec, use_noise=True,
               offsets=None, row=None):
    """One step on interior-shaped fields in plain torch (the reference's
    ``_xla_fallback``): pad with the frozen boundary, or with the 6n
    ``faces`` of a sharded block, draw the step's noise at the block's
    global ``offsets``, and apply :func:`~.stencil.reaction_update`."""
    n_f = spec.n_fields
    if faces is None:
        pads = tuple(
            stencil.pad_with_boundary(f, bv)
            for f, bv in zip(fields, spec.boundaries)
        )
    else:
        pads = tuple(
            pad_from_faces(
                fields[i], faces[2 * i], faces[2 * i + 1],
                faces[2 * n_f + 2 * i], faces[2 * n_f + 2 * i + 1],
                faces[4 * n_f + 2 * i], faces[4 * n_f + 2 * i + 1],
            )
            for i in range(n_f)
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
    return stencil.reaction_update(pads, noise_term, params, _model(spec))


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


def plain_xchain(fields, params, seeds, faces, *, spec, fuse, use_noise,
                 offsets, row):
    """The x-chain in plain torch (the reference's
    ``_xla_xchain_fallback``): ``fuse`` stages on the x-extended window
    ``[lo face | block | hi face]``, y and z re-padded with the boundary
    value each stage, and every mid-stage cell whose GLOBAL coordinate
    (``offsets`` + local) lies outside ``[0, row)`` on any axis pinned to
    it. The final stage is unpinned: the out-of-domain rows of a
    y-extended operand hold computed values, as in the kernel."""
    n_f = spec.n_fields
    nx, ny, nz = fields[0].shape
    dtype, device = fields[0].dtype, fields[0].device
    k = fuse
    wins = [
        torch.cat([faces[2 * i], fields[i], faces[2 * i + 1]], dim=0)
        for i in range(n_f)
    ]

    def in_domain(origin, n):
        g = origin + torch.arange(n, device=device)
        return (g >= 0) & (g < row)

    valid_yz = (in_domain(offsets[1], ny)[None, :, None]
                & in_domain(offsets[2], nz)[None, None, :])
    for s in range(k):
        m_out = k - 1 - s
        w_out = nx + 2 * m_out
        if use_noise:
            unit = uniform_pm1_block(
                seeds[:2], seeds[2] + s,
                (offsets[0] - m_out, offsets[1], offsets[2]),
                (w_out, ny, nz), row, dtype, device=device,
            )
            noise_term = params.noise * unit
        else:
            noise_term = 0.0
        wins = list(stencil.reaction_update(
            tuple(F.pad(w, (1, 1, 1, 1), value=bv)
                  for w, bv in zip(wins, spec.boundaries)),
            noise_term, params, _model(spec),
        ))
        if s == k - 1:
            break
        valid = in_domain(offsets[0] - m_out, w_out)[:, None, None] & valid_yz
        wins = [torch.where(valid, w, bv)
                for w, bv in zip(wins, spec.boundaries)]
    return tuple(wins)


def _check_faces(faces, shape, n_f, fuse, name) -> str:
    """The reference's arity checks on ``faces``, plus each face's
    shape (the kernel reads them by index); returns the mode."""
    if faces is None:
        return "chain"
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
    nx, ny, nz = shape
    if x_chain:
        want = [(fuse, ny, nz)] * len(faces)
    else:
        want = ([(1, ny, nz)] * 2 * n_f + [(nx, 1, nz)] * 2 * n_f
                + [(nx, ny, 1)] * 2 * n_f)
    for f, w in zip(faces, want):
        if tuple(f.shape) != w:
            kind = "x-chain" if x_chain else "6n"
            raise ValueError(
                f"{kind} faces must be {w} for a {tuple(shape)} block; "
                f"got {tuple(f.shape)}"
            )
    return "xchain" if x_chain else "faces6"


def fused_step(fields, params, seeds, faces=None, *, spec, use_noise=True,
               fuse=1, offsets=None, row=None, y_halo=0):
    """``fuse`` fused steps of ``spec``'s model on interior-shaped
    fields (an n-tuple of (nx, ny, nz) tensors in declaration order).

    ``seeds`` is ``(k0, k1, step)``: the key words and the absolute step
    of the first of the ``fuse`` steps, as Python ints. ``offsets`` is
    the block's global origin (default zeros) and ``row`` the global
    grid side (default nz); both key the noise, and the x-chain pins on
    them. ``faces`` is None, the 6n-tuple (fuse=1; axis-major, then
    field-major, then lo/hi; x faces (1, ny, nz), y faces (nx, 1, nz),
    z faces (nx, ny, 1)) or the 2n-tuple x-chain form (fuse >= 2; each
    (fuse, ny, nz)). ``y_halo`` is the depth of the exchanged y halo
    the operand carries — the xy-chain's y-extended operand, whose rows
    cover global ``[offsets[1], offsets[1] + ny)``; it must equal
    ``fuse``, and the launch counts as an ``xychain`` one.

    CUDA tensors go through the kernel (or raise); CPU tensors through
    the plain versions. Returns the new field tuple."""
    fields = tuple(fields)
    n_f = spec.n_fields
    if len(fields) != n_f:
        raise ValueError(
            f"model {spec.name!r} declares {n_f} field(s); "
            f"got {len(fields)}"
        )
    if fuse < 1:
        raise ValueError(f"fuse must be >= 1, got {fuse}")
    mode = _check_faces(faces, fields[0].shape, n_f, fuse, spec.name)
    if y_halo:
        if mode != "xchain" or y_halo != fuse:
            raise ValueError(
                "a y-extended operand (y_halo) is the xy-chain's: it "
                f"takes x-chain faces with y_halo == fuse; got mode "
                f"{mode!r}, y_halo={y_halo}, fuse={fuse}"
            )
        mode = "xychain"
    offsets = tuple(int(o) for o in (offsets or (0, 0, 0)))
    nz = fields[0].shape[2]
    row = nz if row is None else int(row)
    if not fields[0].is_cuda:
        if mode == "chain":
            return plain_chain(fields, params, seeds, spec=spec,
                               use_noise=use_noise, fuse=fuse,
                               offsets=offsets, row=row)
        if mode == "faces6":
            return plain_step(fields, params, seeds, faces, spec=spec,
                              use_noise=use_noise, offsets=offsets, row=row)
        return plain_xchain(fields, params, seeds, faces, spec=spec,
                            fuse=fuse, use_noise=use_noise, offsets=offsets,
                            row=row)
    cap = max_feasible_fuse(fields[0].element_size(), n_f)
    if mode != "chain":
        if fuse > cap:
            raise ValueError(
                f"{mode} depth {fuse} exceeds the shared-memory ledger's "
                f"cap {cap} for {fields[0].dtype}: the exchange width "
                "must be capped with max_feasible_fuse"
            )
        return _launch(fields, params, seeds, spec=spec, use_noise=use_noise,
                       fuse=fuse, offsets=offsets, row=row, faces=faces,
                       mode=mode)
    step = int(seeds[2])
    done = 0
    while done < fuse:
        k = min(cap, fuse - done)
        fields = _launch(fields, params, (seeds[0], seeds[1], step + done),
                         spec=spec, use_noise=use_noise, fuse=k,
                         offsets=offsets, row=row)
        done += k
    return fields


def _lib(spec):
    """The loaded library of ``spec``'s generated kernel, its layout
    checked against the ledger and its entry points typed."""
    from . import _build

    lib = _build.load(spec)
    if not getattr(lib, "_gs_ready", False):
        layout = (ctypes.c_int * 5)()
        lib.gs_layout.argtypes = [ctypes.c_void_p]
        lib.gs_layout.restype = None
        lib.gs_layout(ctypes.cast(layout, ctypes.c_void_p))
        want = TILE + (spec.n_fields, len(spec.param_fields))
        if tuple(layout) != want:
            raise RuntimeError(
                f"the {spec.name!r} kernel's (tile, fields, params) "
                f"{tuple(layout)} != the ledger's {want}"
            )
        lib.gs_error_string.argtypes = [ctypes.c_int]
        lib.gs_error_string.restype = ctypes.c_char_p
        for suffix in _DTYPES.values():
            fn = getattr(lib, f"gs_stencil_chain_{suffix}")
            fn.argtypes = (
                [ctypes.c_void_p] * 5
                + [ctypes.c_int]
                + [ctypes.c_uint32] * 3
                + [ctypes.c_int] * 3
                + [ctypes.c_uint32]
                + [ctypes.c_int] * 5
                + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
        lib._gs_ready = True
    return lib


def _pointers(tensors):
    """A host array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _launch(fields, params, seeds, *, spec, use_noise, fuse, offsets, row,
            faces=None, mode="chain"):
    """One launch of ``spec``'s generated kernel advancing ``fuse``
    steps (``fuse`` <= the ledger's cap) in ``mode``; returns the new
    field tuple."""
    global LAUNCHES
    first = fields[0]
    dtype = first.dtype
    if dtype not in _DTYPES:
        raise TypeError(
            f"the CUDA kernel takes float32 or float64 fields, got {dtype}"
        )
    for f in fields:
        if (f.device != first.device or f.dtype != dtype
                or f.shape != first.shape):
            raise ValueError(
                "fields must share device, dtype and shape; got "
                f"{[(t.device, t.dtype, tuple(t.shape)) for t in fields]}"
            )
        if f.dim() != 3 or not f.is_contiguous():
            raise ValueError("fields must be contiguous 3D tensors")
    nx, ny, nz = first.shape
    if first.numel() >= 2**31:
        raise ValueError(f"field shape {tuple(first.shape)} is too large")
    face_ptrs = None
    if faces is not None:
        # Exchanged y and z faces are strided views of the stacked
        # slabs; the kernel reads each face densely.
        faces = [f.contiguous() for f in faces]
        for f in faces:
            if f.device != first.device or f.dtype != dtype:
                raise ValueError(
                    "faces must share the fields' device and dtype; got "
                    f"{f.device} {f.dtype} for {first.device} {dtype}"
                )
        face_ptrs = _pointers(faces)
    params_vec = torch.stack(
        [getattr(params, f).to(device=first.device, dtype=dtype)
         for f in spec.param_fields]
    )
    outs = tuple(torch.empty_like(f) for f in fields)
    bounds = (ctypes.c_double * spec.n_fields)(*spec.boundaries)
    lib = _lib(spec)
    fn = getattr(lib, f"gs_stencil_chain_{_DTYPES[dtype]}")
    in_ptrs, out_ptrs = _pointers(fields), _pointers(outs)
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream(first.device).cuda_stream
        rc = fn(
            ctypes.cast(in_ptrs, ctypes.c_void_p),
            ctypes.cast(out_ptrs, ctypes.c_void_p),
            params_vec.data_ptr(),
            ctypes.cast(face_ptrs, ctypes.c_void_p) if faces else None,
            ctypes.cast(bounds, ctypes.c_void_p),
            MODES[mode],
            int(seeds[0]) & 0xFFFFFFFF, int(seeds[1]) & 0xFFFFFFFF,
            int(seeds[2]) & 0xFFFFFFFF,
            offsets[0], offsets[1], offsets[2], row & 0xFFFFFFFF,
            nx, ny, nz, fuse, int(bool(use_noise)), stream,
        )
    if rc != 0:
        msg = lib.gs_error_string(rc).decode()
        raise RuntimeError(
            f"stencil_chain launch failed (model={spec.name}, mode={mode}, "
            f"fuse={fuse}, shape={tuple(first.shape)}, {dtype}): CUDA error "
            f"{rc}: {msg}"
        )
    LAUNCHES += 1
    MODE_LAUNCHES[mode] += 1
    MODEL_LAUNCHES[spec.name] = MODEL_LAUNCHES.get(spec.name, 0) + 1
    return outs
