"""The Gray-Scott reaction-diffusion model (counterpart of
``grayscott_jl_tpu/models/grayscott.py``):

    u_t = Du * lap(u) - u*v^2 + F*(1-u) + noise*U(-1,1)
    v_t = Dv * lap(v) + u*v^2 - (F+k)*v

on a cubic grid of side ``L`` with a frozen ghost shell (u=1, v=0).
On the card it runs the kernel that ``ops/kernelgen.py`` generates from
this reaction, as every registered model does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

from . import base

U_BOUNDARY = 1.0
V_BOUNDARY = 0.0

#: Half-width and values of the seeded centre cube.
SEED_HALF_WIDTH = 6
SEED_U = 0.25
SEED_V = 0.33


class Params(NamedTuple):
    """Gray-Scott parameters as 0-dim tensors of the compute dtype."""

    Du: object
    Dv: object
    F: object
    k: object
    dt: object
    noise: object


def seed_bounds(L: int) -> Tuple[int, int]:
    """Global index range (inclusive) of the seeded centre cube."""
    if L % 2 != 0:
        raise ValueError(
            f"L must be even (reference requires Int(L/2)); got L={L}"
        )
    return L // 2 - SEED_HALF_WIDTH, L // 2 + SEED_HALF_WIDTH


def init_fields(
    L: int,
    dtype,
    *,
    offsets: Tuple[int, int, int] = (0, 0, 0),
    sizes: Optional[Tuple[int, int, int]] = None,
    device=None,
):
    """Initial (u, v) for a block of the global ``L^3`` grid: u=1, v=0
    except u=0.25, v=0.33 on the seeded cube."""
    return base.seeded_box_init(
        L, dtype,
        backgrounds=(U_BOUNDARY, V_BOUNDARY),
        seed_values=(SEED_U, SEED_V),
        half_width=SEED_HALF_WIDTH,
        offsets=offsets, sizes=sizes, device=device,
    )


def reaction(fields, laps, noise_u, params):
    """The Gray-Scott time derivatives. The operation order is that of
    the reference (``(u*v)*v``, then ``((Du*lap - uvv) + F*(1-u)) +
    noise``, then ``(Dv*lap + uvv) - (F+k)*v``); the generated CUDA
    kernel performs the traced operations in this order, which is what
    makes it equal this function bitwise."""
    u, v = fields
    lap_u, lap_v = laps
    uvv = u * v * v
    du = params.Du * lap_u - uvv + params.F * (1.0 - u) + noise_u
    dv = params.Dv * lap_v + uvv - (params.F + params.k) * v
    return du, dv


MODEL = base.register(base.Model(
    name="grayscott",
    field_names=("u", "v"),
    boundaries=(U_BOUNDARY, V_BOUNDARY),
    param_decls={"Du": 0.05, "Dv": 0.1, "F": 0.04, "k": 0.0},
    reaction=reaction,
    init=init_fields,
    params_cls=Params,
    legacy_keys={"Du": "Du", "Dv": "Dv", "F": "F", "k": "k"},
    description="Gray-Scott cubic autocatalysis (reference parity)",
))
