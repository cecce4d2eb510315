"""Ensemble parameter specification: the ``[ensemble]`` TOML table
(counterpart of ``grayscott_jl_tpu/ensemble/spec.py``, which imports
nothing of JAX; this is the port's own copy over its own ``models``).

An ensemble runs N independent parameter sets **of one registered
model** (the run's ``[model]`` selection; Gray-Scott by default) in ONE
launch of the kernel per block and round (``ensemble/engine``): the
fields carry a leading member axis through the whole step loop, and
``member_shards`` splits the members over groups of the mesh's block
slots. This module owns
the *description* of that ensemble — which members exist and what
parameters each carries — with three equivalent TOML spellings
(mixable; members concatenate in order):

``presets``
    Named parameter sets, namespaced per model
    (:data:`MODEL_PRESETS`); for Gray-Scott these are the Pearson
    phase-diagram classes::

        [ensemble]
        presets = ["spots", "stripes", "waves", "mitosis", "chaos"]

``[[ensemble.member]]`` tables
    Explicit per-member parameter tables over the model's declared
    parameter names (plus the framework's ``dt``/``noise``);
    unspecified fields inherit the base config values::

        [[ensemble.member]]
        F = 0.03
        k = 0.062

``[ensemble.sweep]``
    Linspace sweeps over ``members = N`` points; every swept key takes
    ``{ from = a, to = b }`` (inclusive endpoints) or an explicit
    N-long list; unswept parameters inherit the base config::

        [ensemble]
        members = 8
        [ensemble.sweep]
        F = { from = 0.01, to = 0.06 }
        k = { from = 0.045, to = 0.065 }

``member_shards = m`` splits the members over ``m`` groups of the
selected devices' block slots (must divide both the member count and
the slot count). ``seeds = [..]`` pins per-member noise seeds; the
default is ``base_seed + index`` (resolved at Simulation construction,
so a solo run with ``seed = base_seed + k`` reproduces member ``k``
bit-for-bit — the equality contract the tests assert). A seed is in
``[0, 2**32)``, the port's rule (``simulation.base_key``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..models import FRAMEWORK_PARAMS, get_model

#: Gray-Scott member parameter fields — the historical flat tuple, kept
#: as the compat alias; the generic form is :func:`member_param_fields`
#: over the run's model declaration.
PARAM_FIELDS = ("Du", "Dv", "F", "k", "dt", "noise")

#: Named Gray-Scott phase-diagram parameter sets (Pearson 1993
#: classes): the (F, k) pairs that land the classic regimes with the
#: standard diffusion ratio Du = 2*Dv. The compat alias for
#: ``MODEL_PRESETS["grayscott"]``.
PRESETS: Dict[str, Dict[str, float]] = {
    "spots":   {"F": 0.030, "k": 0.062, "Du": 0.2, "Dv": 0.1},
    "stripes": {"F": 0.055, "k": 0.062, "Du": 0.2, "Dv": 0.1},
    "waves":   {"F": 0.018, "k": 0.051, "Du": 0.2, "Dv": 0.1},
    "mitosis": {"F": 0.037, "k": 0.065, "Du": 0.2, "Dv": 0.1},
    "chaos":   {"F": 0.026, "k": 0.051, "Du": 0.2, "Dv": 0.1},
}

#: Presets namespaced per registered model: ``presets = [...]`` in the
#: ``[ensemble]`` table resolves against the RUN's model, so a
#: Brusselator ensemble can never silently inherit Gray-Scott numbers.
MODEL_PRESETS: Dict[str, Dict[str, Dict[str, float]]] = {
    "grayscott": PRESETS,
    "brusselator": {
        # Distance from the Hopf/Turing thresholds at A=1 (B_c = 1+A^2).
        "steady":      {"A": 1.0, "B": 1.7, "Du": 0.2, "Dv": 0.02},
        "turing":      {"A": 1.0, "B": 3.0, "Du": 0.2, "Dv": 0.02},
        "oscillatory": {"A": 1.0, "B": 2.4, "Du": 0.2, "Dv": 0.02},
    },
    "fhn": {
        "excitable":   {"a": 0.7, "b": 0.8, "eps": 0.08, "I": 0.5},
        "oscillatory": {"a": 0.7, "b": 0.8, "eps": 0.08, "I": 1.0},
        "stiff":       {"a": 0.7, "b": 0.8, "eps": 0.02, "I": 0.5},
    },
    "heat": {
        "slow": {"D": 0.1},
        "fast": {"D": 0.4},
    },
}


def member_param_fields(model) -> Tuple[str, ...]:
    """The member parameter universe for one model: its declared params
    plus the framework-level ``dt`` and ``noise``."""
    return tuple(model.param_names) + FRAMEWORK_PARAMS


def _model_for(base):
    return get_model(getattr(base, "model", "grayscott") or "grayscott")


@dataclasses.dataclass(frozen=True)
class MemberSpec:
    """One ensemble member's parameter set, model-generic.

    ``values`` is the ordered ``(param, value)`` tuple over
    :func:`member_param_fields`; parameters read as attributes
    (``member.F``) for the two-field classics. ``seed`` is Optional:
    ``None`` resolves to ``base_seed + index`` at Simulation
    construction (``engine.EnsembleSimulation``), so the spec stays
    independent of the launch seed.
    """

    values: Tuple[Tuple[str, float], ...]
    seed: Optional[int] = None
    name: str = ""
    #: False marks an IDLE pack slot (``serve/scheduler.py`` pads a
    #: partially-filled batch up to a canonical executable shape so the
    #: warm-compile cache stays warm): the member still advances inside
    #: the vmapped launch (one program for all slots), but it writes no
    #: stores, is excluded from health attribution and from the
    #: aggregate cell-updates/s, and restores by re-initialization.
    #: TOML-declared members are always active.
    active: bool = True

    def params(self) -> Dict[str, float]:
        return dict(self.values)

    def value(self, key: str) -> float:
        for k, v in self.values:
            if k == key:
                return v
        raise KeyError(key)

    def __getattr__(self, key: str) -> float:
        # Only consulted for names not found normally — parameter
        # attribute access (member.F, member.noise).
        if key.startswith("_"):
            raise AttributeError(key)
        for k, v in self.__dict__.get("values", ()):
            if k == key:
                return v
        raise AttributeError(key)

    def describe(self) -> dict:
        d = dict(self.values)
        if self.seed is not None:
            d["seed"] = self.seed
        if self.name:
            d["name"] = self.name
        if not self.active:
            d["idle"] = True
        return d


@dataclasses.dataclass(frozen=True)
class EnsembleSettings:
    """Parsed ``[ensemble]`` table: the members plus the mesh split."""

    members: Tuple[MemberSpec, ...]
    member_shards: int = 1
    #: The registered model the members parametrize (every member is
    #: the same physics; ensembles sweep parameters, not equations).
    model: str = "grayscott"

    @property
    def n(self) -> int:
        return len(self.members)

    @property
    def active(self) -> Tuple[bool, ...]:
        """Per-slot activity mask (``MemberSpec.active``); idle pack
        slots (scheduler padding) read False."""
        return tuple(m.active for m in self.members)

    @property
    def active_n(self) -> int:
        """Real members only — what health attribution and aggregate
        throughput are scaled by; idle pack slots never count."""
        return sum(1 for m in self.members if m.active)

    def describe(self) -> dict:
        return {
            "model": self.model,
            "members": self.n,
            "active_members": self.active_n,
            "member_shards": self.member_shards,
            "params": [m.describe() for m in self.members],
        }


def _base_params(base) -> Dict[str, float]:
    """Every member parameter's base-config value, resolved through the
    model declaration (``[model]`` table > legacy flat keys >
    defaults)."""
    model = _model_for(base)
    vals = model.resolve_param_values(base)
    vals["dt"] = float(base.dt)
    vals["noise"] = float(base.noise)
    return vals


def _member(defaults: Dict[str, float], fields, *, seed=None,
            name="") -> MemberSpec:
    return MemberSpec(
        values=tuple((f, float(defaults[f])) for f in fields),
        seed=seed, name=name,
    )


def _linspace(a: float, b: float, n: int) -> List[float]:
    if n == 1:
        return [a]
    return [a + (b - a) * i / (n - 1) for i in range(n)]


def _sweep_members(table: dict, base, n: Optional[int]) -> List[MemberSpec]:
    model = _model_for(base)
    fields = member_param_fields(model)
    sweep = table["sweep"]
    if not isinstance(sweep, dict) or not sweep:
        raise ValueError("[ensemble.sweep] must be a non-empty table")
    # Resolve every swept key to an N-long value list first, inferring
    # N from explicit lists when `members` was not given.
    lists: Dict[str, List[float]] = {}
    for key, spec in sweep.items():
        if key not in fields:
            raise ValueError(
                f"[ensemble.sweep] key {key!r} is not a member parameter "
                f"of model {model.name!r} (one of {', '.join(fields)})"
            )
        if isinstance(spec, dict):
            if not {"from", "to"} <= set(spec):
                raise ValueError(
                    f"[ensemble.sweep] {key} needs 'from' and 'to'"
                )
            if n is None:
                raise ValueError(
                    "[ensemble] sweeps with from/to need an explicit "
                    "'members = N' count"
                )
            lists[key] = _linspace(float(spec["from"]), float(spec["to"]), n)
        elif isinstance(spec, (list, tuple)):
            lists[key] = [float(v) for v in spec]
            if n is None:
                n = len(lists[key])
        else:
            raise ValueError(
                f"[ensemble.sweep] {key} must be {{from=,to=}} or a list"
            )
    assert n is not None
    for key, vals in lists.items():
        if len(vals) != n:
            raise ValueError(
                f"[ensemble.sweep] {key} has {len(vals)} values, "
                f"expected {n}"
            )
    defaults = _base_params(base)
    out = []
    for i in range(n):
        params = dict(defaults)
        for key, vals in lists.items():
            params[key] = vals[i]
        out.append(_member(params, fields, name=f"sweep{i}"))
    return out


def from_toml(table: dict, base) -> EnsembleSettings:
    """Parse the ``[ensemble]`` TOML table against base settings.

    ``base`` supplies the model selection (``base.model``) and the
    default value for every member parameter the table leaves
    unspecified (duck-typed: anything carrying the model's parameter
    attributes works). Member parameter names, sweeps, and presets all
    resolve against the selected model's declaration.
    """
    if not isinstance(table, dict):
        raise ValueError("[ensemble] must be a TOML table")
    known = {"presets", "member", "sweep", "members", "member_shards",
             "seeds"}
    unknown = set(table) - known
    if unknown:
        raise ValueError(
            f"[ensemble] has unknown keys {sorted(unknown)}; "
            f"supported: {sorted(known)}"
        )
    model = _model_for(base)
    fields = member_param_fields(model)
    defaults = _base_params(base)
    model_presets = MODEL_PRESETS.get(model.name, {})
    members: List[MemberSpec] = []

    presets = table.get("presets")
    if presets is not None:
        if isinstance(presets, str):
            presets = (
                list(model_presets) if presets == "all" else [presets]
            )
        for name in presets:
            if name not in model_presets:
                raise ValueError(
                    f"Unknown ensemble preset {name!r} for model "
                    f"{model.name!r}; available: "
                    f"{', '.join(sorted(model_presets)) or '(none)'}"
                )
            members.append(_member(
                {**defaults, **model_presets[name]}, fields, name=name,
            ))

    for i, m in enumerate(table.get("member", []) or []):
        if not isinstance(m, dict):
            raise ValueError("[[ensemble.member]] entries must be tables")
        bad = set(m) - set(fields) - {"seed", "name"}
        if bad:
            raise ValueError(
                f"[[ensemble.member]] has unknown keys {sorted(bad)} "
                f"for model {model.name!r}"
            )
        params = {f: float(m.get(f, defaults[f])) for f in fields}
        members.append(_member(
            params, fields,
            seed=int(m["seed"]) if "seed" in m else None,
            name=str(m.get("name", f"member{i}")),
        ))

    if "sweep" in table:
        n = int(table["members"]) if "members" in table else None
        members.extend(_sweep_members(table, base, n))
    elif "members" in table and int(table["members"]) != len(members):
        raise ValueError(
            f"[ensemble] members = {table['members']} does not match the "
            f"{len(members)} members declared by presets/member tables"
        )

    if not members:
        raise ValueError(
            "[ensemble] declares no members (need presets, "
            "[[ensemble.member]] tables, or an [ensemble.sweep])"
        )

    seeds = table.get("seeds")
    if seeds is not None:
        if len(seeds) != len(members):
            raise ValueError(
                f"[ensemble] seeds has {len(seeds)} entries for "
                f"{len(members)} members"
            )
        members = [dataclasses.replace(m, seed=int(s))
                   for m, s in zip(members, seeds)]

    shards = int(table.get("member_shards", 1))
    if shards < 1:
        raise ValueError(f"member_shards must be >= 1, got {shards}")
    if len(members) % shards:
        raise ValueError(
            f"member_shards = {shards} does not divide the member "
            f"count {len(members)}"
        )
    return EnsembleSettings(
        members=tuple(members), member_shards=shards, model=model.name,
    )


def resolve_seeds(ens: EnsembleSettings, base_seed: int) -> List[int]:
    """Per-member PRNG seeds: the spec's pinned seed, else
    ``base_seed + index`` — the contract that makes member ``k`` of an
    ensemble reproduce a solo run with ``seed = base_seed + k``."""
    return [
        m.seed if m.seed is not None else base_seed + i
        for i, m in enumerate(ens.members)
    ]
