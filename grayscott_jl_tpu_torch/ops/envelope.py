"""The envelope probes of the stencil chain (counterpart of the two
``pl.pallas_call``s in ``benchmarks/envelope_probe.py``).

The TPU probes take the TPU kernel apart; these take apart the port's
kernel, ``ops/csrc/stencil_chain.cu``, and are modes of it (built into
Gray-Scott's second library, ``ops/_build.py``), so they replay its
8 x 8 x 32 tiles, its ``fuse``-cell halo, its window load (TMA or
``cp.async``), its stage function and its dynamic shared memory
(:func:`~.cuda_stencil.smem_bytes`):

* :func:`copy_walk` (``dma_walk``, ``envelope_probe.py:164``): every
  block loads its window as the production chain does at depth
  ``fuse`` — every field, tile plus halo, out-of-grid cells set to the
  boundary value — and writes its tile back from shared memory, with no
  arithmetic: the identity on every field, bitwise, at the production
  footprint and occupancy. Its time against :func:`torch_copy`'s is the
  chain's copy envelope.
* :func:`compute_walk` (``compute_walk``, ``envelope_probe.py:400``):
  every block loads the one resident window of tile (0,0,0), runs the
  production stage chain on it with its own block coordinates for pins
  and noise keys, and keeps its last stage in shared memory; only block
  (0,0,0) writes its tile. The defined output is that tile
  (:func:`defined_tile`), equal to the production chain's tile (0,0,0)
  bitwise; the rest of the output is left unwritten (NaN on the CPU).
  ``variant`` (:data:`VARIANTS`) selects the probe's variants
  (``envelope_probe.py:452-465``): ``nonoise`` (no noise term),
  ``noselect`` (no pin of out-of-grid cells in mid stages), ``noyz``
  (the four y/z neighbours read as the centre and, as the JAX case sets
  ``selects=False`` too, no pins), ``fma`` (the dt-folded coefficient
  form, one rounding per operation), ``minimal`` (one multiply per field
  per stage, the same window reads and stores) and ``nomid`` (every
  stage from the input window at the tile's cells into an accumulator,
  one store, cell by cell).

Each has a plain torch version (:func:`plain_copy_walk`,
:func:`plain_compute_walk`) performing the same rounded operations in
the same order; the kernel equals it bitwise on the card. On the CPU
the entry points run the plain versions; on the card they launch the
kernel or raise. Launches count in ``cuda_stencil.LAUNCHES``, in
``cuda_stencil.MODE_LAUNCHES`` under ``copy_walk`` and
``compute_walk``, per variant in ``cuda_stencil.VARIANT_LAUNCHES`` and
per window load path in ``cuda_stencil.LOAD_PATH_LAUNCHES``.

What bounds them on the card: the copy walk moves each field's bytes
once each way plus the halo re-reads (device-memory bytes); the compute
walk reads about one window from device memory and does the chain's
operations in every block (operations; :func:`work` counts both).
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from . import cuda_stencil, stencil
from .cuda_stencil import _pointers
from .noise import uniform_pm1_block

#: The compute walk's variants, in the order of the kernel's
#: ``Variant`` enum (``ops/csrc/stencil_chain.cu``).
VARIANTS = cuda_stencil.PROBE_VARIANTS

#: Variants that pin out-of-grid cells to the boundary value in mid
#: stages, as the production chain does.
_PINNED = ("chain", "nonoise", "fma")


def _gray_scott_spec():
    from ..models import grayscott
    from . import kernelgen

    return kernelgen.get_spec(grayscott.MODEL)


def _check_spec(spec):
    if spec.name != "grayscott":
        raise ValueError(
            "the envelope probes take apart Gray-Scott's kernel (as "
            f"benchmarks/envelope_probe.py does); got model {spec.name!r}")


def defined_tile(shape) -> Tuple[slice, slice, slice]:
    """The cells :func:`compute_walk` defines in an output of ``shape``:
    tile (0,0,0), cut to the grid."""
    return tuple(slice(0, min(n, t)) for n, t in zip(shape, cuda_stencil.TILE))


def _check_fields(fields, fuse, name):
    """The wrapper's checks (as ``cuda_stencil._launch`` makes them):
    two float32 contiguous 3D fields of one device and shape, and a
    depth the shared-memory ledger admits."""
    fields = tuple(fields)
    if len(fields) != 2:
        raise ValueError(f"{name} takes Gray-Scott's two fields; got "
                         f"{len(fields)}")
    first = fields[0]
    for f in fields:
        if f.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 fields (as the TPU probe);"
                            f" got {f.dtype}")
        if f.device != first.device or f.shape != first.shape:
            raise ValueError(
                "fields must share device and shape; got "
                f"{[(t.device, tuple(t.shape)) for t in fields]}")
        if f.dim() != 3 or not f.is_contiguous():
            raise ValueError("fields must be contiguous 3D tensors")
    if first.numel() >= 2**31:
        raise ValueError(f"field shape {tuple(first.shape)} is too large")
    cap = cuda_stencil.max_feasible_fuse(4)
    if not 1 <= fuse <= cap:
        raise ValueError(f"{name} depth must be in [1, {cap}] (the "
                         f"shared-memory ledger's cap); got {fuse}")
    return fields


def plain_copy_walk(fields, *, fuse):
    """The copy walk in plain torch: each field padded with its
    boundary value ``fuse`` cells deep, as the windows are filled, and
    its interior copied out."""
    spec = _gray_scott_spec()
    h = fuse
    return tuple(
        F.pad(f, (h,) * 6, value=bv)[h:-h, h:-h, h:-h].clone()
        for f, bv in zip(fields, spec.boundaries))


def _origin_windows(fields, boundaries, h):
    """The window of tile (0,0,0) of each field: tile plus ``h`` cells
    per side from global ``-h``, the cells outside the grid holding the
    boundary value."""
    shape = tuple(t + 2 * h for t in cuda_stencil.TILE)
    wins = []
    for f, bv in zip(fields, boundaries):
        w = torch.full(shape, bv, dtype=f.dtype, device=f.device)
        n = [min(s, t + h) for s, t in zip(f.shape, cuda_stencil.TILE)]
        w[h:h + n[0], h:h + n[1], h:h + n[2]] = f[:n[0], :n[1], :n[2]]
        wins.append(w)
    return wins


def _nsum(w, yz=True):
    """The six neighbours of each interior cell of ``w`` summed in the
    kernel's order (x-1, x+1, y-1, y+1, z-1, z+1); without ``yz`` the
    four y/z neighbours are the centre."""
    c = w[1:-1, 1:-1, 1:-1]
    if yz:
        ym, yp = w[1:-1, :-2, 1:-1], w[1:-1, 2:, 1:-1]
        zm, zp = w[1:-1, 1:-1, :-2], w[1:-1, 1:-1, 2:]
    else:
        ym = yp = zm = zp = c
    return w[:-2, 1:-1, 1:-1] + w[2:, 1:-1, 1:-1] + ym + yp + zm + zp


def _folded(params, inv6):
    """The fma and minimal variants' coefficients
    (``envelope_probe.py:264-270``), each op rounded as the kernel
    rounds it."""
    one = torch.ones((), dtype=inv6.dtype, device=inv6.device)
    Du, Dv, F_, K, dt, noise = (params.Du, params.Dv, params.F, params.k,
                                params.dt, params.noise)
    return dict(
        au=one - dt * (Du + F_), bu=dt * Du * inv6, cu=dt * F_,
        av=one - dt * (Dv + F_ + K), bv2=dt * Dv * inv6, noise_dt=noise * dt,
    )


def _walk_stage(wins, params, spec, unit, variant, fold, inv6):
    """One stage of the compute walk on the windows ``wins`` (the next,
    one cell smaller per side, unpinned); ``unit`` is the stage's noise
    unit or None."""
    u_w, v_w = wins
    centres = tuple(w[1:-1, 1:-1, 1:-1] for w in wins)
    if variant == "minimal":
        return centres[0] * fold["au"], centres[1] * fold["av"]
    if variant == "fma":
        u, v = centres
        uvv_dt = u * v * v * params.dt
        u_new = u * fold["au"] + fold["bu"] * _nsum(u_w) + fold["cu"] - uvv_dt
        v_new = v * fold["av"] + fold["bv2"] * _nsum(v_w) + uvv_dt
        if unit is not None:
            u_new = u_new + fold["noise_dt"] * unit
        return u_new, v_new
    noise_term = (stencil.scaled_noise(params.noise, unit)
                  if unit is not None else 0.0)
    if variant == "noyz":
        laps = tuple(_nsum(w, yz=False) * inv6 - c
                     for w, c in zip(wins, centres))
        derivs = spec.model.reaction(centres, laps, noise_term, params)
        return tuple(c + d * params.dt for c, d in zip(centres, derivs))
    return stencil.reaction_update(wins, noise_term, params, spec.model)


def plain_compute_walk(fields, params, seeds, *, spec, fuse, use_noise,
                       variant="chain", row=None):
    """The compute walk's defined output in plain torch: the chain of
    tile (0,0,0) on its window, per ``variant``, stage ``s`` keyed at
    step ``seeds[2] + s`` and at the stage's global coordinates. Returns
    the tile (:func:`defined_tile`) of each field."""
    _check_spec(spec)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}; got {variant!r}")
    fields = tuple(fields)
    shape = tuple(fields[0].shape)
    device, dtype = fields[0].device, fields[0].dtype
    row = shape[2] if row is None else int(row)
    h = fuse
    inv6 = torch.tensor(1.0 / 6.0, dtype=dtype, device=device)
    fold = (_folded(params, inv6) if variant in ("fma", "minimal")
            else None)
    noisy = use_noise and variant not in ("nonoise", "minimal")
    wins = _origin_windows(fields, spec.boundaries, h)

    def unit_at(s, origin, out_shape):
        if not noisy:
            return None
        return uniform_pm1_block(seeds[:2], seeds[2] + s, origin, out_shape,
                                 row, torch.float32, device=device)

    tile = cuda_stencil.TILE
    if variant == "nomid":
        ring = [w[h - 1:h + tile[0] + 1, h - 1:h + tile[1] + 1,
                  h - 1:h + tile[2] + 1] for w in wins]
        acc = [w[1:-1, 1:-1, 1:-1] for w in ring]
        for s in range(fuse):
            new = _walk_stage(ring, params, spec, unit_at(s, (0, 0, 0), tile),
                              "chain", fold, inv6)
            acc = [a + n for a, n in zip(acc, new)]
        out = acc
    else:
        for s in range(fuse):
            origin = s + 1 - h
            out_shape = tuple(n - 2 for n in wins[0].shape)
            new = _walk_stage(wins, params, spec,
                              unit_at(s, (origin,) * 3, out_shape), variant,
                              fold, inv6)
            if variant in _PINNED:
                valid = None
                for axis, n in enumerate(shape):
                    g = origin + torch.arange(out_shape[axis], device=device)
                    ok = ((g >= 0) & (g < n)).view(
                        [-1 if a == axis else 1 for a in range(3)])
                    valid = ok if valid is None else valid & ok
                new = tuple(torch.where(valid, x, bv)
                            for x, bv in zip(new, spec.boundaries))
            wins = list(new)
        out = wins
    cut = defined_tile(shape)
    return tuple(x[cut] for x in out)


def copy_walk(fields, *, fuse):
    """One pass of the copy walk at depth ``fuse`` over Gray-Scott's
    two float32 fields: the kernel on the card (or a raise), the plain
    version on the CPU. Returns new tensors equal to ``fields``."""
    fields = _check_fields(fields, fuse, "copy_walk")
    if not fields[0].is_cuda:
        return plain_copy_walk(fields, fuse=fuse)
    spec = _gray_scott_spec()
    nx, ny, nz = fields[0].shape
    outs = tuple(torch.empty_like(f) for f in fields)
    bounds = (ctypes.c_double * 2)(*spec.boundaries)
    lib = _lib(spec)
    in_ptrs, out_ptrs = _pointers(fields), _pointers(outs)
    with torch.cuda.device(fields[0].device):
        path, maps = cuda_stencil.window_maps(lib, fields, fuse)
        stream = torch.cuda.current_stream(fields[0].device).cuda_stream
        rc = lib.gs_envelope_copy_walk_f32(
            ctypes.cast(in_ptrs, ctypes.c_void_p),
            ctypes.cast(out_ptrs, ctypes.c_void_p),
            cuda_stencil.maps_address(maps),
            ctypes.cast(bounds, ctypes.c_void_p),
            nx, ny, nz, fuse, stream)
    _raise_on(lib, rc, f"copy_walk (fuse={fuse}, shape={(nx, ny, nz)}, "
                       f"load {path})")
    cuda_stencil.count_launch("copy_walk", path)
    return outs


def compute_walk(fields, params, seeds, *, spec, fuse, use_noise,
                 variant="chain", row=None):
    """One pass of the compute walk (``variant`` of :data:`VARIANTS`)
    at depth ``fuse``: ``seeds`` is ``(k0, k1, step)`` as for
    ``cuda_stencil.fused_step``, ``row`` the noise's grid side (default
    nz). Returns full-shaped outputs whose :func:`defined_tile` holds
    tile (0,0,0) of the chain; the rest is unwritten on the card and NaN
    on the CPU."""
    _check_spec(spec)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}; got {variant!r}")
    fields = _check_fields(fields, fuse, "compute_walk")
    nx, ny, nz = fields[0].shape
    row = nz if row is None else int(row)
    if not fields[0].is_cuda:
        outs = tuple(torch.full_like(f, math.nan) for f in fields)
        tile = plain_compute_walk(fields, params, seeds, spec=spec, fuse=fuse,
                                  use_noise=use_noise, variant=variant,
                                  row=row)
        for o, t in zip(outs, tile):
            o[defined_tile(o.shape)] = t
        return outs
    params_vec = torch.stack(
        [getattr(params, f) for f in spec.param_fields]
    ).to(device=fields[0].device, dtype=torch.float32)
    outs = tuple(torch.empty_like(f) for f in fields)
    bounds = (ctypes.c_double * 2)(*spec.boundaries)
    lib = _lib(spec)
    in_ptrs, out_ptrs = _pointers(fields), _pointers(outs)
    with torch.cuda.device(fields[0].device):
        path, maps = cuda_stencil.window_maps(lib, fields, fuse)
        stream = torch.cuda.current_stream(fields[0].device).cuda_stream
        rc = lib.gs_envelope_compute_walk_f32(
            ctypes.cast(in_ptrs, ctypes.c_void_p),
            ctypes.cast(out_ptrs, ctypes.c_void_p), params_vec.data_ptr(),
            cuda_stencil.maps_address(maps),
            ctypes.cast(bounds, ctypes.c_void_p),
            VARIANTS.index(variant),
            int(seeds[0]) & 0xFFFFFFFF, int(seeds[1]) & 0xFFFFFFFF,
            int(seeds[2]) & 0xFFFFFFFF, row & 0xFFFFFFFF, nx, ny, nz, fuse,
            int(bool(use_noise)), stream)
    _raise_on(lib, rc, f"compute_walk (variant={variant}, fuse={fuse}, "
                       f"shape={(nx, ny, nz)}, load {path})")
    cuda_stencil.count_launch("compute_walk", path)
    cuda_stencil.VARIANT_LAUNCHES[variant] += 1
    return outs


def torch_copy(fields, outs=None):
    """The library yardstick of :func:`copy_walk`: ``Tensor.copy_`` of
    each field into ``outs`` (new tensors when None); timed beside the
    probe, used nowhere in the port."""
    outs = outs or tuple(torch.empty_like(f) for f in fields)
    for o, f in zip(outs, fields):
        o.copy_(f)
    return tuple(outs)


def case_name(variant) -> str:
    """The probe case of a compute-walk variant, named as
    ``benchmarks/envelope_probe.py`` names it (``compute_walk``,
    ``compute_nonoise``, ...)."""
    return "compute_walk" if variant == "chain" else f"compute_{variant}"


def case_variant(case) -> str:
    """The variant of a compute-walk case (:func:`case_name`'s
    inverse)."""
    for variant in VARIANTS:
        if case_name(variant) == case:
            return variant
    raise ValueError(f"unknown probe case {case!r}")


def work(case, shape, fuse, use_noise=True):
    """What one pass of ``case`` must move and compute on fields of
    ``shape``: ``(unique_bytes, issued_bytes, flops)``.

    ``unique_bytes`` reads each input byte once and writes each output
    byte once (for the compute walk: the origin window in, one tile
    out); ``issued_bytes`` counts the window loads as the kernel issues
    them (tile plus halo, every tile, every field) plus the tile writes;
    ``flops`` are the float operations the pass performs (the chain's
    on every cell of every stage a block computes for the compute walk,
    which recomputes the halo ring; ``fuse`` steps of the program per
    cell for ``full``)."""
    tile = cuda_stencil.TILE
    nx, ny, nz = shape
    cells = nx * ny * nz
    n_tiles = math.prod(-(-n // t) for n, t in zip(shape, tile))
    window = math.prod(t + 2 * fuse for t in tile)
    tile_cells = math.prod(min(n, t) for n, t in zip(shape, tile))
    every = 2 * 2 * cells * 4
    walk_issued = 2 * (window * n_tiles + cells) * 4
    # The program's operations per cell and step, 3 of them the noise
    # term's.
    program = _gray_scott_spec().flops_per_cell_step()
    chain = program - (0 if use_noise else 3)
    if case == "torch_stream":
        return every, every, 2 * cells
    if case in ("torch_copy", "copy_walk"):
        return every, (walk_issued if case == "copy_walk" else every), 0
    if case == "full":
        return every, walk_issued, fuse * chain * cells
    variant = case_variant(case)
    origin = math.prod(min(n, t + fuse) for n, t in zip(shape, tile))
    unique = 2 * (origin + tile_cells) * 4
    issued = 2 * (window * n_tiles + tile_cells) * 4
    stage_cells = sum(math.prod(t + 2 * (fuse - 1 - s) for t in tile)
                      for s in range(fuse))
    per_cell = {
        "chain": chain, "noselect": chain, "noyz": chain,
        "nonoise": program - 3,
        # uvv_dt 3, u' 5 + the sum 5, v' 4 + 5, the noise term 4
        "fma": 22 + (4 if use_noise else 0),
        "minimal": 2,
        "nomid": chain + 2,
    }[variant]
    if variant == "nomid":
        return unique, issued, n_tiles * tile_cells * fuse * per_cell
    return unique, issued, n_tiles * stage_cells * per_cell


def _lib(spec):
    """The loaded probe library, its entry points typed."""
    from . import _build

    lib = _build.load(spec, envelope=True)
    if not getattr(lib, "_gs_probes_ready", False):
        cuda_stencil._type_common(lib)
        lib.gs_envelope_copy_walk_f32.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.gs_envelope_copy_walk_f32.restype = ctypes.c_int
        lib.gs_envelope_compute_walk_f32.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_uint32] * 4
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.gs_envelope_compute_walk_f32.restype = ctypes.c_int
        lib._gs_probes_ready = True
    return lib


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}: "
                           f"{lib.gs_error_string(rc).decode()}")
