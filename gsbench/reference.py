"""Plain reference of the Gray-Scott simulation, to judge the program by.

Plain PyTorch: nothing here imports the program (``grayscott_jl_tpu_torch``)
or JAX, and nothing takes a value the program made. It follows the
published model (GrayScott.jl, ``README.md``; Pearson 1993)::

    u_t = Du lap(u) - u v^2 + F (1 - u) + noise U(-1, 1)
    v_t = Dv lap(v) + u v^2 - (F + k) v

advanced by explicit Euler steps of ``dt`` on an ``L^3`` grid with a
frozen ghost shell (u = 1, v = 0), from u = 1, v = 0 with u = 0.25,
v = 0.33 on the cube ``[L/2 - 6, L/2 + 6]^3``. The Laplacian is the sum
of the six face neighbours (x-1, x+1, y-1, y+1, z-1, z+1, in that
order) times ``1/6`` less the centre, and each product and sum is its
own rounded operation, in the order the equations are written.

The noise is the position-keyed stream the program's settings state:
cell (x, y, z) at step t under key (k0, k1) draws
``hash32(hash32((y L + z) mod 2^32) ^ plane)`` with
``plane = hash32(hash32(hash32(k0) ^ k1) ^ hash32(hash32(t) ^ x))`` and
``hash32`` the lowbias32 finalizer; the top 23 bits make a float32 in
``[1, 2)``, and ``* 2 - 3`` maps it to ``[-1, 1)``. A seed ``s`` is the
key ``(0, s)``; ensemble member ``m`` draws from seed ``s + m``.

States are ``(u, v)`` of shape ``(members, nx, ny, nz)`` over a box of
the grid: its origin and the grid's side ``L``; the whole grid is the
box ``(L, L, L)`` at the origin. A step of a box gives its cells that
the box's own cells determine: the box less one cell on each side that
does not lie on the grid's edge, where the frozen shell stands
(:func:`box_after`). Steps run in x-slabs, so that a large box fits
beside the program's outputs.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

MASK32 = 0xFFFFFFFF
#: Half-width and values of the seeded centre cube; the frozen shell.
SEED_HALF_WIDTH = 6
SEED_U, SEED_V = 0.25, 0.33
BOUNDARY_U, BOUNDARY_V = 1.0, 0.0


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for uint32 values ``x`` held in int64 (or a
    Python int), with no intermediate above 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash32(x):
    """lowbias32 on uint32 values held in int64 tensors or Python ints."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def plane_seeds(key: Tuple[int, int], step: int, x0: int, x1: int, device):
    """Seeds of the x-planes ``x0 .. x1-1`` at ``step``, int64 ``(n,)``."""
    k0, k1 = (int(k) & MASK32 for k in key)
    head = hash32(hash32(k0) ^ k1)
    gx = torch.arange(x0, x1, dtype=torch.int64, device=device)
    return hash32(head ^ hash32(hash32(int(step) & MASK32) ^ gx))


_CELL: Dict[tuple, torch.Tensor] = {}


def cell_hashes(L: int, device, ys=None, zs=None) -> torch.Tensor:
    """``hash32((y L + z) mod 2^32)`` for every (y, z) of the ranges
    ``ys``, ``zs`` (``(start, stop)``; the whole side by default), int64
    ``(ny, nz)``."""
    ys, zs = ys or (0, L), zs or (0, L)
    ck = (L, tuple(ys), tuple(zs), str(device))
    if ck not in _CELL:
        y = torch.arange(*ys, dtype=torch.int64, device=device).view(-1, 1)
        z = torch.arange(*zs, dtype=torch.int64, device=device).view(1, -1)
        _CELL.clear()
        _CELL[ck] = hash32((y * L + z) & MASK32)
    return _CELL[ck]


def unit_noise(key, step: int, x0: int, x1: int, L: int, device, ys=None,
               zs=None):
    """Uniform [-1, 1) float32 draws of planes ``x0 .. x1-1`` over the
    rows ``ys`` and columns ``zs`` (the whole side by default),
    ``(n, ny, nz)``."""
    seeds = plane_seeds(key, step, x0, x1, device).view(-1, 1, 1)
    bits = hash32(cell_hashes(L, device, ys, zs).unsqueeze(0) ^ seeds)
    f12 = (0x3F800000 | (bits >> 9)).to(torch.int32).view(torch.float32)
    return f12 * 2.0 - 3.0


def initial_state(L: int, members: int = 1, device="cpu",
                  origin=(0, 0, 0), shape=None):
    """The initial ``(u, v)`` over the box of ``shape`` (the whole grid
    by default) at ``origin``, float32 ``(members, *shape)``."""
    if L % 2:
        raise ValueError(f"L must be even, got {L}")
    shape = tuple(shape or (L, L, L))
    u = torch.full((members, *shape), BOUNDARY_U, dtype=torch.float32,
                   device=device)
    v = torch.full((members, *shape), BOUNDARY_V, dtype=torch.float32,
                   device=device)
    lo, hi = L // 2 - SEED_HALF_WIDTH, L // 2 + SEED_HALF_WIDTH + 1
    cube = (slice(None),) + tuple(
        slice(min(max(lo - o, 0), n), min(max(hi - o, 0), n))
        for o, n in zip(origin, shape))
    u[cube] = SEED_U
    v[cube] = SEED_V
    return u, v


def box_after(origin, shape, L: int, nsteps: int = 1):
    """The box ``(origin, shape)`` whose cells ``nsteps`` steps of the
    box ``(origin, shape)`` give: one cell less a step on each side that
    does not lie on the grid's edge."""
    origin, shape = list(origin), list(shape)
    for _ in range(nsteps):
        for a in range(3):
            lo = origin[a] + (origin[a] > 0)
            hi = origin[a] + shape[a] - (origin[a] + shape[a] < L)
            if hi <= lo:
                raise ValueError("the box steps to nothing")
            origin[a], shape[a] = lo, hi - lo
    return tuple(origin), tuple(shape)


def crop(fields, origin, box_origin, box_shape):
    """Views of ``fields`` (over the box at ``origin``) on the box
    ``(box_origin, box_shape)``, which lies inside it."""
    box = (slice(None),) + tuple(slice(b - o, b - o + n) for o, b, n in
                                 zip(origin, box_origin, box_shape))
    return tuple(f[box] for f in fields)


class Params:
    """Per-member parameters as ``(members, 1, 1, 1)`` tensors of
    ``dtype``; ``rows`` is one dict of Du, Dv, F, k, dt, noise per
    member."""

    NAMES = ("Du", "Dv", "F", "k", "dt", "noise")

    def __init__(self, rows: Sequence[dict], dtype, device):
        for name in self.NAMES:
            col = torch.tensor([float(r[name]) for r in rows],
                               dtype=torch.float32, device=device)
            setattr(self, name, col.to(dtype).view(-1, 1, 1, 1))


def _padded(f: torch.Tensor, origin, lo, hi, L: int,
            bv: float) -> torch.Tensor:
    """The cells ``lo - 1 .. hi`` (global, per axis) of ``f`` over the
    box at ``origin``, with the ghost shell: the frozen value outside
    the grid."""
    idx, pads = [slice(None)], []
    for o, a, b in zip(origin, lo, hi):
        s, e = max(a - 1, 0), min(b + 1, L)
        idx.append(slice(s - o, e - o))
        pads.append((s - (a - 1), (b + 1) - e))
    (px, py, pz) = pads
    return F.pad(f[tuple(idx)], (*pz, *py, *px), mode="constant", value=bv)


def _laplacian(p: torch.Tensor, inv6: torch.Tensor) -> torch.Tensor:
    total = (p[:, :-2, 1:-1, 1:-1] + p[:, 2:, 1:-1, 1:-1]
             + p[:, 1:-1, :-2, 1:-1] + p[:, 1:-1, 2:, 1:-1]
             + p[:, 1:-1, 1:-1, :-2] + p[:, 1:-1, 1:-1, 2:])
    return total * inv6 - p[:, 1:-1, 1:-1, 1:-1]


def step(u: torch.Tensor, v: torch.Tensor, params: Params, keys, t: int,
         slab: int = 64, *, origin=(0, 0, 0), L=None):
    """One step of every member from ``(u, v)`` over the box at
    ``origin`` of the grid of side ``L`` (the box's own side by default:
    the whole grid) at absolute step ``t``: the new ``(u, v)`` over
    :func:`box_after` of the box, in the inputs' dtype, which is the
    precision the step computes in (``params`` in the same dtype).
    ``keys`` holds one ``(k0, k1)`` per member."""
    M = u.shape[0]
    L = u.shape[1] if L is None else int(L)
    dtype = u.dtype
    (lx, ly, lz), (nx, ny, nz) = box_after(origin, u.shape[1:], L)
    inv6 = torch.tensor(1.0 / 6.0, dtype=dtype, device=u.device)
    F_k = params.F + params.k
    out_u = torch.empty((M, nx, ny, nz), dtype=dtype, device=u.device)
    out_v = torch.empty_like(out_u)
    for x0 in range(lx, lx + nx, slab):
        x1 = min(x0 + slab, lx + nx)
        lo, hi = (x0, ly, lz), (x1, ly + ny, lz + nz)
        pu = _padded(u, origin, lo, hi, L, BOUNDARY_U)
        pv = _padded(v, origin, lo, hi, L, BOUNDARY_V)
        uc, vc = pu[:, 1:-1, 1:-1, 1:-1], pv[:, 1:-1, 1:-1, 1:-1]
        lap_u, lap_v = _laplacian(pu, inv6), _laplacian(pv, inv6)
        del pu, pv
        unit = torch.stack([
            unit_noise(keys[m], t, x0, x1, L, u.device, (ly, ly + ny),
                       (lz, lz + nz)) for m in range(M)]).to(dtype)
        noise_u = params.noise * unit
        del unit
        uvv = uc * vc * vc
        du = params.Du * lap_u - uvv + params.F * (1.0 - uc) + noise_u
        dv = params.Dv * lap_v + uvv - F_k * vc
        out_u[:, x0 - lx:x1 - lx] = uc + du * params.dt
        out_v[:, x0 - lx:x1 - lx] = vc + dv * params.dt
    return out_u, out_v


def advance(state, rows: Sequence[dict], keys, t0: int, nsteps: int,
            dtype=torch.float32, *, origin=(0, 0, 0), L=None):
    """``nsteps`` steps from ``state`` (float32 ``(u, v)`` over the box
    at ``origin`` of the grid of side ``L``; the whole grid by default)
    at absolute step ``t0``, computed in ``dtype``; the result, over
    :func:`box_after` of the box, as float32."""
    u, v = (f.to(dtype) for f in state)
    L = u.shape[1] if L is None else int(L)
    params = Params(rows, dtype, u.device)
    for s in range(nsteps):
        shape = u.shape[1:]
        u, v = step(u, v, params, keys, t0 + s, origin=origin, L=L)
        origin = box_after(origin, shape, L)[0]
    return u.float(), v.float()


def max_abs_gap(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor],
                slab: int = 64) -> float:
    """The largest ``|a - b|`` over every field, member and cell, taken
    in x-slabs on ``b``'s device; ``inf`` where either side is not
    finite."""
    worst = 0.0
    for fa, fb in zip(a, b):
        if fa.shape != fb.shape:
            raise ValueError(f"shapes differ: {tuple(fa.shape)} against "
                             f"{tuple(fb.shape)}")
        for x0 in range(0, fa.shape[1], slab):
            d = (fa[:, x0:x0 + slab].to(fb.device).float()
                 - fb[:, x0:x0 + slab].float())
            m = d.abs().max()
            if not torch.isfinite(m):
                return float("inf")
            worst = max(worst, float(m))
    return worst
