"""Plain heat diffusion, one field (counterpart of
``grayscott_jl_tpu/models/heat.py``):

    T_t = D * lap(T) + noise*U(-1,1)

On the card it runs the one-field kernel that ``ops/kernelgen.py``
generates from this reaction (bitwise equal to the plain torch
version).
"""

from __future__ import annotations

from . import base

T_BOUNDARY = 0.0
SEED_HALF_WIDTH = 6
SEED_T = 1.0


def reaction(fields, laps, noise_t, params):
    (lap_t,) = laps
    return (params.D * lap_t + noise_t,)


def init_fields(L, dtype, *, offsets=(0, 0, 0), sizes=None, device=None):
    return base.seeded_box_init(
        L, dtype,
        backgrounds=(T_BOUNDARY,),
        seed_values=(SEED_T,),
        half_width=SEED_HALF_WIDTH,
        offsets=offsets, sizes=sizes, device=device,
    )


MODEL = base.register(base.Model(
    name="heat",
    field_names=("T",),
    boundaries=(T_BOUNDARY,),
    param_decls={"D": 0.2},
    reaction=reaction,
    init=init_fields,
    description="Plain heat diffusion (one field)",
))
