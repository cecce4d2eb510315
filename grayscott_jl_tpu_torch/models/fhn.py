"""FitzHugh-Nagumo (counterpart of ``grayscott_jl_tpu/models/fhn.py``):

    v_t = Dv * lap(v) + v - v^3/3 - w + I + noise*U(-1,1)
    w_t = Dw * lap(w) + eps * (v + a - b*w)

On the card it runs the kernel that ``ops/kernelgen.py`` generates
from this reaction (bitwise equal to the plain torch version).
"""

from __future__ import annotations

from . import base

V_BOUNDARY = 0.0
W_BOUNDARY = 0.0
SEED_HALF_WIDTH = 6
SEED_V = 1.0
SEED_W = 0.0


def reaction(fields, laps, noise_v, params):
    v, w = fields
    lap_v, lap_w = laps
    third = v.new_tensor(1.0 / 3.0)
    dv = (params.Dv * lap_v + v - v * v * v * third - w + params.I
          + noise_v)
    dw = params.Dw * lap_w + params.eps * (v + params.a - params.b * w)
    return dv, dw


def init_fields(L, dtype, *, offsets=(0, 0, 0), sizes=None, device=None):
    return base.seeded_box_init(
        L, dtype,
        backgrounds=(V_BOUNDARY, W_BOUNDARY),
        seed_values=(SEED_V, SEED_W),
        half_width=SEED_HALF_WIDTH,
        offsets=offsets, sizes=sizes, device=device,
    )


MODEL = base.register(base.Model(
    name="fhn",
    field_names=("v", "w"),
    boundaries=(V_BOUNDARY, W_BOUNDARY),
    param_decls={
        "a": 0.7, "b": 0.8, "eps": 0.08, "I": 0.5,
        "Dv": 0.2, "Dw": 0.0,
    },
    reaction=reaction,
    init=init_fields,
    description="FitzHugh-Nagumo excitable media",
))
