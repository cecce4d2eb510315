"""The Brusselator (counterpart of ``grayscott_jl_tpu/models/brusselator.py``):

    u_t = Du * lap(u) + A - (B+1)*u + u^2*v + noise*U(-1,1)
    v_t = Dv * lap(v) + B*u - u^2*v

On the card it runs the kernel that ``ops/kernelgen.py`` generates
from this reaction (bitwise equal to the plain torch version).
"""

from __future__ import annotations

from . import base

U_BOUNDARY = 1.0
V_BOUNDARY = 3.0
SEED_HALF_WIDTH = 6
SEED_U = 0.5
SEED_V = 2.0


def reaction(fields, laps, noise_u, params):
    u, v = fields
    lap_u, lap_v = laps
    uuv = u * u * v
    du = params.Du * lap_u + params.A - (params.B + 1.0) * u + uuv + noise_u
    dv = params.Dv * lap_v + params.B * u - uuv
    return du, dv


def init_fields(L, dtype, *, offsets=(0, 0, 0), sizes=None, device=None):
    return base.seeded_box_init(
        L, dtype,
        backgrounds=(U_BOUNDARY, V_BOUNDARY),
        seed_values=(SEED_U, SEED_V),
        half_width=SEED_HALF_WIDTH,
        offsets=offsets, sizes=sizes, device=device,
    )


MODEL = base.register(base.Model(
    name="brusselator",
    field_names=("u", "v"),
    boundaries=(U_BOUNDARY, V_BOUNDARY),
    param_decls={"A": 1.0, "B": 3.0, "Du": 0.2, "Dv": 0.02},
    reaction=reaction,
    init=init_fields,
    description="Brusselator trimolecular autocatalysis",
))
