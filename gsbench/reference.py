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

States are ``(u, v)`` of shape ``(members, L, L, L)``; steps run in
x-slabs so that an ``L = 1024`` grid fits beside the program's outputs.
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


def cell_hashes(L: int, device) -> torch.Tensor:
    """``hash32((y L + z) mod 2^32)`` for every (y, z), int64 ``(L, L)``."""
    ck = (L, str(device))
    if ck not in _CELL:
        y = torch.arange(L, dtype=torch.int64, device=device).view(L, 1)
        z = torch.arange(L, dtype=torch.int64, device=device).view(1, L)
        _CELL.clear()
        _CELL[ck] = hash32((y * L + z) & MASK32)
    return _CELL[ck]


def unit_noise(key, step: int, x0: int, x1: int, L: int, device):
    """Uniform [-1, 1) float32 draws of planes ``x0 .. x1-1``, ``(n, L, L)``."""
    seeds = plane_seeds(key, step, x0, x1, device).view(-1, 1, 1)
    bits = hash32(cell_hashes(L, device).unsqueeze(0) ^ seeds)
    f12 = (0x3F800000 | (bits >> 9)).to(torch.int32).view(torch.float32)
    return f12 * 2.0 - 3.0


def initial_state(L: int, members: int = 1, device="cpu"):
    """The initial ``(u, v)``, float32 ``(members, L, L, L)``."""
    if L % 2:
        raise ValueError(f"L must be even, got {L}")
    u = torch.full((members, L, L, L), BOUNDARY_U, dtype=torch.float32,
                   device=device)
    v = torch.full((members, L, L, L), BOUNDARY_V, dtype=torch.float32,
                   device=device)
    lo, hi = L // 2 - SEED_HALF_WIDTH, L // 2 + SEED_HALF_WIDTH + 1
    u[:, lo:hi, lo:hi, lo:hi] = SEED_U
    v[:, lo:hi, lo:hi, lo:hi] = SEED_V
    return u, v


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


def _padded(f: torch.Tensor, x0: int, x1: int, bv: float) -> torch.Tensor:
    """Planes ``x0-1 .. x1`` of ``f`` ``(M, L, L, L)`` with the ghost
    shell: the frozen value outside the grid."""
    L = f.shape[1]
    lo, hi = max(x0 - 1, 0), min(x1 + 1, L)
    return F.pad(f[:, lo:hi], (1, 1, 1, 1, lo - (x0 - 1), (x1 + 1) - hi),
                 mode="constant", value=bv)


def _laplacian(p: torch.Tensor, inv6: torch.Tensor) -> torch.Tensor:
    total = (p[:, :-2, 1:-1, 1:-1] + p[:, 2:, 1:-1, 1:-1]
             + p[:, 1:-1, :-2, 1:-1] + p[:, 1:-1, 2:, 1:-1]
             + p[:, 1:-1, 1:-1, :-2] + p[:, 1:-1, 1:-1, 2:])
    return total * inv6 - p[:, 1:-1, 1:-1, 1:-1]


def step(u: torch.Tensor, v: torch.Tensor, params: Params, keys, t: int,
         slab: int = 64):
    """One step of every member from ``(u, v)`` at absolute step ``t``:
    the new ``(u, v)`` in the inputs' dtype, which is the precision the
    step computes in (``params`` in the same dtype). ``keys`` holds one
    ``(k0, k1)`` per member."""
    M, L = u.shape[0], u.shape[1]
    dtype = u.dtype
    inv6 = torch.tensor(1.0 / 6.0, dtype=dtype, device=u.device)
    F_k = params.F + params.k
    out_u, out_v = torch.empty_like(u), torch.empty_like(v)
    for x0 in range(0, L, slab):
        x1 = min(x0 + slab, L)
        pu = _padded(u, x0, x1, BOUNDARY_U)
        pv = _padded(v, x0, x1, BOUNDARY_V)
        uc, vc = pu[:, 1:-1, 1:-1, 1:-1], pv[:, 1:-1, 1:-1, 1:-1]
        lap_u, lap_v = _laplacian(pu, inv6), _laplacian(pv, inv6)
        del pu, pv
        unit = torch.stack([unit_noise(keys[m], t, x0, x1, L, u.device)
                            for m in range(M)]).to(dtype)
        noise_u = params.noise * unit
        del unit
        uvv = uc * vc * vc
        du = params.Du * lap_u - uvv + params.F * (1.0 - uc) + noise_u
        dv = params.Dv * lap_v + uvv - F_k * vc
        out_u[:, x0:x1] = uc + du * params.dt
        out_v[:, x0:x1] = vc + dv * params.dt
    return out_u, out_v


def advance(state, rows: Sequence[dict], keys, t0: int, nsteps: int,
            dtype=torch.float32):
    """``nsteps`` steps from ``state`` (float32 ``(u, v)``) at absolute
    step ``t0``, computed in ``dtype``; the result as float32."""
    u, v = (f.to(dtype) for f in state)
    params = Params(rows, dtype, u.device)
    for s in range(nsteps):
        u, v = step(u, v, params, keys, t0 + s)
    return u.float(), v.float()


def max_abs_gap(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor],
                slab: int = 64) -> float:
    """The largest ``|a - b|`` over every field, member and cell, taken
    in x-slabs; ``inf`` where either side is not finite."""
    worst = 0.0
    for fa, fb in zip(a, b):
        if fa.shape != fb.shape:
            raise ValueError(f"shapes differ: {tuple(fa.shape)} against "
                             f"{tuple(fb.shape)}")
        for x0 in range(0, fa.shape[1], slab):
            d = (fa[:, x0:x0 + slab].float() - fb[:, x0:x0 + slab].float())
            m = d.abs().max()
            if not torch.isfinite(m):
                return float("inf")
            worst = max(worst, float(m))
    return worst
