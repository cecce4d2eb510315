"""Plain-torch stencil ops: the model-generic compute core (counterpart
of ``grayscott_jl_tpu/ops/stencil.py``).

The 7-point Laplacian is ``sum(6 face neighbours) * (1/6) - centre``,
the neighbours summed in the reference's order (x-1, x+1, y-1, y+1,
z-1, z+1) with ``1/6`` rounded to the field dtype. Arrays here are
ghost-padded ``(nx+2, ny+2, nz+2)`` blocks; results are interior-shaped.
A leading member axis ``(N, ...)`` rides along: the stencil indexes the
last three axes, and member-stacked params (``(N, 1, 1, 1)`` leaves)
broadcast, so each member's cells see the same operations as a solo
block's.

Each line below is one torch operation, so on the card every product
and sum is rounded on its own (no fused multiply-add): the generated
kernel (``ops/csrc/stencil_chain.cu`` with the model's reaction emitted
by ``ops/kernelgen.py``, built with ``--fmad=false``) performs the same
IEEE operations in the same order and equals these functions bitwise.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def pad_with_boundary(x: torch.Tensor, value: float) -> torch.Tensor:
    """Add a 1-cell ghost shell holding the frozen boundary ``value``."""
    return F.pad(x, (1, 1, 1, 1, 1, 1), mode="constant", value=value)


def laplacian(padded: torch.Tensor) -> torch.Tensor:
    """7-point Laplacian of a ghost-padded block."""
    center = padded[..., 1:-1, 1:-1, 1:-1]
    inv6 = torch.tensor(1.0 / 6.0, dtype=padded.dtype, device=padded.device)
    total = (
        padded[..., :-2, 1:-1, 1:-1]
        + padded[..., 2:, 1:-1, 1:-1]
        + padded[..., 1:-1, :-2, 1:-1]
        + padded[..., 1:-1, 2:, 1:-1]
        + padded[..., 1:-1, 1:-1, :-2]
        + padded[..., 1:-1, 1:-1, 2:]
    )
    return total * inv6 - center


def scaled_noise(noise, unit: torch.Tensor) -> torch.Tensor:
    """``noise * unit`` in the dtype JAX promotes the pair to: torch
    keeps a dimensioned tensor's dtype against a 0-dim one, so a
    float32 ``noise`` times a bfloat16 ``unit`` would round the product
    to bfloat16, where the reference widens ``unit`` and multiplies in
    float32. Matching dtypes (float32, float64, pure bfloat16) multiply
    as they are."""
    return noise * unit.to(torch.promote_types(noise.dtype, unit.dtype))


def reaction_update(
    fields_pad: Sequence[torch.Tensor],
    noise_term,
    params,
    model,
    compute_dtype=None,
) -> Tuple[torch.Tensor, ...]:
    """One explicit-Euler step of ``model`` on ghost-padded fields:
    ``f_i' = f_i + d_i * dt`` with ``(d_1..d_n) = model.reaction(...)``.
    ``noise_term`` is the pre-scaled noise field (or ``0.0``).

    ``compute_dtype`` (the ``bf16_f32acc`` posture) widens the
    accumulation: the padded fields and the noise term are cast to it
    once, the step runs at that dtype, and the result rounds back to the
    fields' dtype once. ``None`` or the fields' own dtype casts
    nothing."""
    store_dtype = fields_pad[0].dtype
    if compute_dtype is not None and compute_dtype != store_dtype:
        fields_pad = tuple(f.to(compute_dtype) for f in fields_pad)
        if isinstance(noise_term, torch.Tensor):
            noise_term = noise_term.to(compute_dtype)
    else:
        compute_dtype = None
    fields = tuple(f[..., 1:-1, 1:-1, 1:-1] for f in fields_pad)
    laps = tuple(laplacian(f) for f in fields_pad)
    derivs = model.reaction(fields, laps, noise_term, params)
    out = tuple(f + d * params.dt for f, d in zip(fields, derivs))
    if compute_dtype is not None:
        out = tuple(f.to(store_dtype) for f in out)
    return out
