"""Kernel specs from model declarations (counterpart of
``grayscott_jl_tpu/ops/kernelgen.py``).

The reference generates its fused Pallas kernel from any model whose
reaction traces to elementwise JAX. This package has no generator yet
(ROADMAP Queue 2 item 4): its CUDA kernel carries the reactions written
into ``ops/csrc/stencil_chain.cu`` as device functions, which today is
Gray-Scott's alone. :func:`generation_gate_reason` states that gate,
and :class:`KernelSpec` is the static view of a declaration the
dispatch (``ops/cuda_stencil.py``) consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

#: Models whose reaction the CUDA source carries as a device function
#: (``grayscott_reaction`` in stencil_chain.cu).
DEVICE_REACTIONS = frozenset({"grayscott"})


class KernelGenError(ValueError):
    """A model declaration the kernel cannot serve; ``str(exc)`` is the
    reason."""


@dataclasses.dataclass(frozen=True, eq=False)
class KernelSpec:
    """Static view of a Model declaration for the kernel."""

    name: str
    n_fields: int
    field_names: Tuple[str, ...]
    boundaries: Tuple[float, ...]
    param_fields: Tuple[str, ...]
    params_cls: type
    reaction: Callable
    model: object


def generation_gate_reason(model) -> Optional[str]:
    """Why the CUDA kernel cannot run ``model``, or ``None`` when it
    can."""
    if model.name not in DEVICE_REACTIONS:
        return (
            f"the CUDA kernel carries no device reaction for model "
            f"{model.name!r} (only {sorted(DEVICE_REACTIONS)}); other "
            "models wait for the kernel generator (ROADMAP Queue 2 item 4)"
        )
    return None


def build_spec(model) -> KernelSpec:
    return KernelSpec(
        name=model.name,
        n_fields=len(model.field_names),
        field_names=tuple(model.field_names),
        boundaries=tuple(float(b) for b in model.boundaries),
        param_fields=tuple(model.params_cls._fields),
        params_cls=model.params_cls,
        reaction=model.reaction,
        model=model,
    )


_SPECS: dict = {}


def get_spec(model) -> KernelSpec:
    """The (memoized) spec of ``model``; works for every model, the
    plain path included — the CUDA gate is :func:`generation_gate_reason`."""
    key = (model.name, id(model))
    spec = _SPECS.get(key)
    if spec is None:
        spec = _SPECS[key] = build_spec(model)
    return spec
