"""The model framework: reaction-diffusion models as data.

Counterpart of ``grayscott_jl_tpu/models/base.py``. A model is a
declaration — named fields with per-field frozen-ghost boundary values,
typed params (model params with defaults, then the framework's ``dt``
and ``noise``), a pure ``reaction`` over field values, Laplacians and
pre-scaled noise, and an ``init`` for any sub-block of the grid — and
the execution code consumes only the declaration.

Params are a NamedTuple of 0-dim tensors at the compute dtype, made on
the run's device. Derived scalars such as ``F + k`` are then computed
as tensor operations at that dtype, the same single rounding the
reference performs; computing them from Python floats would round once
in double and then again on conversion.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple


class SettingsError(ValueError):
    """A configuration error the operator must fix, raised at
    parse/construction time."""


#: Framework-level parameters appended to every model's Params.
FRAMEWORK_PARAMS = ("dt", "noise")


class Model:
    """One registered reaction-diffusion model (see the module doc)."""

    def __init__(
        self,
        *,
        name: str,
        field_names: Sequence[str],
        boundaries: Sequence[float],
        param_decls: Mapping[str, Optional[float]],
        reaction: Callable,
        init: Callable,
        params_cls: Optional[type] = None,
        legacy_keys: Optional[Mapping[str, str]] = None,
        description: str = "",
    ):
        if len(field_names) != len(boundaries):
            raise ValueError(
                f"model {name!r}: {len(field_names)} fields but "
                f"{len(boundaries)} boundary values"
            )
        overlap = set(param_decls) & set(FRAMEWORK_PARAMS)
        if overlap:
            raise ValueError(
                f"model {name!r} redeclares framework params "
                f"{sorted(overlap)}"
            )
        self.name = str(name)
        self.field_names: Tuple[str, ...] = tuple(field_names)
        self.boundaries: Tuple[float, ...] = tuple(
            float(b) for b in boundaries
        )
        self.param_names: Tuple[str, ...] = tuple(param_decls)
        self.param_defaults: Dict[str, Optional[float]] = dict(param_decls)
        self.reaction = reaction
        self.init = init
        self.legacy_keys = dict(legacy_keys or {})
        self.description = description
        self.params_cls = params_cls or namedtuple(
            f"{self.name.capitalize()}Params",
            self.param_names + FRAMEWORK_PARAMS,
        )
        missing = set(self.param_names + FRAMEWORK_PARAMS) - set(
            self.params_cls._fields
        )
        if missing:
            raise ValueError(
                f"model {name!r}: params_cls lacks fields {sorted(missing)}"
            )

    @property
    def n_fields(self) -> int:
        return len(self.field_names)

    def validate_table(self, table: Mapping) -> None:
        """Reject a ``[model]`` table with unknown or missing keys,
        naming the model."""
        unknown = set(table) - set(self.param_names)
        if unknown:
            raise SettingsError(
                f"[model] table for model {self.name!r} has unknown "
                f"parameter keys {sorted(unknown)}; accepted: "
                f"{sorted(self.param_names)}"
            )
        missing = [
            p for p in self.param_names
            if p not in table and self.param_defaults[p] is None
            and p not in self.legacy_keys
        ]
        if missing:
            raise SettingsError(
                f"model {self.name!r} requires parameter(s) "
                f"{sorted(missing)} in the [model] table"
            )
        for key, value in table.items():
            if isinstance(value, bool) or not isinstance(
                value, (int, float)
            ):
                raise SettingsError(
                    f"[model] parameter {key!r} for model {self.name!r} "
                    f"must be a number, got {value!r}"
                )

    def resolve_param_values(self, settings) -> Dict[str, float]:
        """Model parameter values for one run: ``[model]`` table entry
        > legacy flat Settings key > declared default."""
        table = dict(getattr(settings, "model_params", None) or {})
        self.validate_table(table)
        values: Dict[str, float] = {}
        for p in self.param_names:
            if p in table:
                values[p] = float(table[p])
            elif p in self.legacy_keys:
                values[p] = float(getattr(settings, self.legacy_keys[p]))
            else:
                default = self.param_defaults[p]
                if default is None:
                    raise SettingsError(
                        f"model {self.name!r} requires parameter {p!r}"
                    )
                values[p] = float(default)
        return values

    def make_params(self, settings, dtype, device):
        """The typed Params for one run: 0-dim tensors of ``dtype`` on
        ``device``."""
        import torch

        values = self.resolve_param_values(settings)
        values["dt"] = float(settings.dt)
        values["noise"] = float(settings.noise)
        return self.params_cls(**{
            f: torch.tensor(values[f], dtype=dtype, device=device)
            for f in self.params_cls._fields
        })


_REGISTRY: Dict[str, Model] = {}


def register(model: Model) -> Model:
    """Register ``model`` under its name."""
    existing = _REGISTRY.get(model.name)
    if existing is not None and existing is not model:
        raise ValueError(f"model {model.name!r} is already registered")
    _REGISTRY[model.name] = model
    return model


def available_models() -> Tuple[str, ...]:
    """Names of the registered models, sorted."""
    return tuple(sorted(_REGISTRY))


def get_model(name: str) -> Model:
    """Look up a registered model; unknown names list the registry."""
    try:
        return _REGISTRY[str(name).lower()]
    except KeyError:
        raise SettingsError(
            f"Unknown model {name!r}; registered models: "
            f"{', '.join(sorted(_REGISTRY))}"
        ) from None


def seeded_box_init(
    L: int,
    dtype,
    *,
    backgrounds: Sequence[float],
    seed_values: Sequence[float],
    half_width: int,
    offsets: Tuple[int, int, int] = (0, 0, 0),
    sizes: Optional[Tuple[int, int, int]] = None,
    device=None,
):
    """Uniform backgrounds with a seeded centre cube
    ``[L/2-half_width, L/2+half_width]^3`` (inclusive), for the block
    at ``offsets``/``sizes`` of the global grid. Even ``L`` only."""
    import torch

    if L % 2 != 0:
        raise ValueError(
            f"L must be even (reference requires Int(L/2)); got L={L}"
        )
    if sizes is None:
        sizes = (L, L, L)
    lo, hi = L // 2 - half_width, L // 2 + half_width
    fields = [
        torch.full(sizes, bg, dtype=dtype, device=device)
        for bg in backgrounds
    ]
    slices = []
    for off, size in zip(offsets, sizes):
        a = max(lo - off, 0)
        b = min(hi + 1 - off, size)
        if a >= b:
            return tuple(fields)
        slices.append(slice(a, b))
    for f, sv in zip(fields, seed_values):
        f[tuple(slices)] = sv
    return tuple(fields)
