"""The serve job-spec protocol: client JSON -> validated spec
(counterpart of ``grayscott_jl_tpu/serve/protocol.py``).

One job is one scenario of one registered model — exactly what a solo
CLI launch runs, and exactly what one MEMBER of a batched ensemble runs.
The scheduler uses that equivalence: a request validates here into a
:class:`JobSpec`, packs with compatible requests (same :func:`pack_key`)
into one ``[ensemble]``-shaped batch, and its stores are byte-identical
to the solo run it describes.

Validation is loud and happens at admission: an unknown model, a
misspelled parameter, a missing required parameter or a mistyped value
raises :class:`~..models.base.SettingsError` naming the problem, with
the reference's messages and limits, and the HTTP layer hands that text
back as the 400 body.

One difference from the reference, by design: :func:`batch_settings`
takes the service's ``backend``. ``"CUDA"`` (the default) runs the
batch on the card through the batched kernel (``kernel_language =
"CUDA"``, one launch per step for every slot); ``"CPU"`` gives the
reference's settings exactly (``backend = "CPU"``, ``kernel_language =
"Plain"``). A card that is asked for and absent raises when the batch
is built (``config/settings.resolve_device``); nothing falls back.

This module imports neither torch nor JAX itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from ..config.settings import PRECISIONS, Settings
from ..ensemble.spec import EnsembleSettings, MemberSpec, member_param_fields
from ..models import get_model
from ..models.base import SettingsError

__all__ = [
    "BACKENDS",
    "JobSpec",
    "PRIORITIES",
    "batch_settings",
    "pack_key",
    "parse_job",
    "resolved_params",
]

#: Named priority levels -> numeric rank (higher runs first). Clients
#: may also send a bare integer in [0, 9].
PRIORITIES: Dict[str, int] = {"low": 2, "normal": 5, "high": 8}

#: Keys a job-spec payload may carry; anything else is a loud error.
JOB_SPEC_KEYS = frozenset({
    "tenant", "priority", "model", "params", "L", "steps", "plotgap",
    "checkpoint_freq", "dt", "noise", "seed", "precision",
    "halo_depth",
})

#: The service's backends -> the batch's ``(backend, kernel_language)``:
#: the card runs the kernel; the host runs the reference's settings.
BACKENDS: Dict[str, Tuple[str, str]] = {
    "CUDA": ("CUDA", "CUDA"),
    "CPU": ("CPU", "Plain"),
}


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One validated simulation request.

    ``params`` is the model-declared parameter table (defaults resolved
    at batch-build time as a ``[model]`` TOML table resolves). The other
    fields mirror the Settings keys that shape the step program — the
    packing axes (:func:`pack_key`) — plus the per-member values
    (params, dt, noise, seed) that ride as launch arguments.
    """

    tenant: str
    model: str
    L: int
    steps: int
    params: Tuple[Tuple[str, float], ...]
    dt: float = 0.2
    noise: float = 0.0
    seed: int = 0
    priority: int = PRIORITIES["normal"]
    plotgap: int = 0
    checkpoint_freq: int = 0
    precision: str = "Float32"
    halo_depth: int = 0

    def describe(self) -> dict:
        return {
            "tenant": self.tenant,
            "model": self.model,
            "L": self.L,
            "steps": self.steps,
            "params": dict(self.params),
            "dt": self.dt,
            "noise": self.noise,
            "seed": self.seed,
            "priority": self.priority,
            "plotgap": self.plotgap,
            "checkpoint_freq": self.checkpoint_freq,
            "precision": self.precision,
            "halo_depth": self.halo_depth,
        }


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SettingsError(msg)


def _as_int(payload: dict, key: str, default: int, lo: int,
            hi: int) -> int:
    v = payload.get(key, default)
    _require(
        isinstance(v, int) and not isinstance(v, bool),
        f"job spec {key!r} must be an integer, got {v!r}",
    )
    _require(
        lo <= v <= hi,
        f"job spec {key!r} must be in [{lo}, {hi}], got {v}",
    )
    return int(v)


def _as_float(payload: dict, key: str, default: float) -> float:
    v = payload.get(key, default)
    _require(
        isinstance(v, (int, float)) and not isinstance(v, bool),
        f"job spec {key!r} must be a number, got {v!r}",
    )
    return float(v)


def parse_job(payload: Any, *, max_l: int = 256,
              max_steps: int = 1_000_000) -> JobSpec:
    """Validate one client payload into a :class:`JobSpec`.

    ``max_l`` / ``max_steps`` are the service's size caps
    (``GS_SERVE_MAX_L`` / ``GS_SERVE_MAX_STEPS``): an oversized request
    is a spec error at the front door. Raises :class:`SettingsError`
    with a client-presentable message.
    """
    _require(isinstance(payload, dict),
             f"job spec must be a JSON object, got {type(payload).__name__}")
    unknown = set(payload) - JOB_SPEC_KEYS
    _require(
        not unknown,
        f"job spec has unknown keys {sorted(unknown)}; accepted: "
        f"{sorted(JOB_SPEC_KEYS)}",
    )
    tenant = payload.get("tenant", "")
    _require(
        isinstance(tenant, str) and 0 < len(tenant) <= 64,
        "job spec needs a 'tenant' string (1-64 chars)",
    )
    model_name = payload.get("model", "grayscott")
    _require(isinstance(model_name, str),
             f"job spec 'model' must be a string, got {model_name!r}")
    model = get_model(model_name)  # unknown -> SettingsError w/ registry

    raw_params = payload.get("params", {})
    _require(isinstance(raw_params, dict),
             "job spec 'params' must be an object of model parameters")
    model.validate_table(raw_params)

    precision = payload.get("precision", "Float32")
    _require(
        precision in PRECISIONS,
        f"job spec 'precision' must be one of "
        f"{sorted(PRECISIONS)}, got {precision!r}",
    )

    prio = payload.get("priority", "normal")
    if isinstance(prio, str):
        _require(
            prio in PRIORITIES,
            f"job spec 'priority' must be one of "
            f"{sorted(PRIORITIES)} or an integer 0-9, got {prio!r}",
        )
        prio = PRIORITIES[prio]
    _require(
        isinstance(prio, int) and not isinstance(prio, bool)
        and 0 <= prio <= 9,
        f"job spec 'priority' must be 0-9, got {prio!r}",
    )

    L = _as_int(payload, "L", 32, 4, max_l)
    steps = _as_int(payload, "steps", 100, 1, max_steps)
    plotgap = _as_int(payload, "plotgap", 0, 0, max_steps)
    ckpt = _as_int(payload, "checkpoint_freq", 0, 0, max_steps)
    seed = _as_int(payload, "seed", 0, 0, 2**31 - 1)
    halo_depth = _as_int(payload, "halo_depth", 0, 0, 16)
    dt = _as_float(payload, "dt", 0.2)
    noise = _as_float(payload, "noise", 0.0)
    _require(dt > 0, f"job spec 'dt' must be > 0, got {dt}")

    return JobSpec(
        tenant=tenant,
        model=model.name,
        L=L,
        steps=steps,
        params=tuple(sorted(
            (k, float(v)) for k, v in raw_params.items()
        )),
        dt=dt,
        noise=noise,
        seed=seed,
        priority=int(prio),
        plotgap=plotgap,
        checkpoint_freq=ckpt,
        precision=precision,
        halo_depth=halo_depth,
    )


def pack_key(spec: JobSpec) -> Tuple:
    """The compatibility class two requests must share to ride one
    batched launch.

    Everything that shapes the step program or the step schedule is a
    key axis: the model, L, steps and the output/checkpoint cadence (one
    launch advances all members on one boundary schedule), precision,
    the s-step exchange depth, and whether ANY noise is drawn. Member
    params, dt, noise magnitude and seeds are launch arguments, so they
    are deliberately NOT key axes.
    """
    return (
        spec.model, spec.L, spec.steps, spec.plotgap,
        spec.checkpoint_freq, spec.precision, spec.halo_depth,
        spec.noise != 0.0,
    )


def _member_values(spec: JobSpec, model) -> Tuple[Tuple[str, float], ...]:
    """The ordered member-parameter tuple for one job, defaults
    resolved through the model declaration like a ``[model]`` table."""
    table = dict(spec.params)
    values = {}
    for p in model.param_names:
        if p in table:
            values[p] = float(table[p])
        else:
            default = model.param_defaults[p]
            _require(
                default is not None,
                f"model {model.name!r} requires parameter {p!r}",
            )
            values[p] = float(default)
    values["dt"] = float(spec.dt)
    values["noise"] = float(spec.noise)
    fields = member_param_fields(model)
    return tuple((f, values[f]) for f in fields)


def resolved_params(spec: JobSpec) -> Tuple[Tuple[str, float], ...]:
    """The fully resolved, canonically ordered member parameters of one
    job — model defaults filled, dt and noise included, field order
    fixed by ``member_param_fields``: exactly what a packed slot
    receives, and so the parameter half of the result-cache identity
    (``serve/cache.py``)."""
    return _member_values(spec, get_model(spec.model))


def batch_settings(specs, *, n_slots: int, output: str,
                   checkpoint_output: str, names=None,
                   supervise: bool = False, max_restarts: int = 3,
                   backend: str = "CUDA") -> Settings:
    """The Settings one packed launch runs: the shared pack-key axes as
    scalar settings, the jobs as ``[ensemble]`` members (slot order),
    and ``n_slots - len(specs)`` trailing IDLE padding members — copies
    of slot 0's parameters with ``active=False`` — so the launch keeps a
    canonical member count (the warm-engine key) while the padding
    writes no stores.

    ``backend`` is the service's (:data:`BACKENDS`): ``"CUDA"`` runs the
    kernel on the card, ``"CPU"`` the reference's ``CPU``/``Plain``
    settings. The batch runs headless inside a worker thread: the hang
    watchdog and the signal-based graceful shutdown are off (signal
    handlers belong to the serving process); supervision is the worker
    fleet's call.
    """
    _require(backend in BACKENDS,
             f"serve backend must be one of {sorted(BACKENDS)}, got "
             f"{backend!r}")
    specs = list(specs)
    _require(bool(specs), "a batch needs at least one job")
    _require(n_slots >= len(specs),
             f"{len(specs)} jobs cannot ride {n_slots} slots")
    key = pack_key(specs[0])
    for s in specs[1:]:
        _require(
            pack_key(s) == key,
            "all jobs of a batch must share one pack key "
            f"({pack_key(s)} != {key})",
        )
    head = specs[0]
    model = get_model(head.model)
    names = list(names or [])
    members = []
    for i, s in enumerate(specs):
        members.append(MemberSpec(
            values=_member_values(s, model),
            seed=int(s.seed),
            name=str(names[i]) if i < len(names) else f"job{i}",
        ))
    for i in range(len(specs), n_slots):
        members.append(MemberSpec(
            values=_member_values(head, model),
            seed=0,
            name=f"idle{i}",
            active=False,
        ))
    ens = EnsembleSettings(
        members=tuple(members), member_shards=1, model=model.name,
    )
    checkpoint = head.checkpoint_freq > 0
    device, language = BACKENDS[backend]
    return Settings(
        L=head.L,
        steps=head.steps,
        plotgap=head.plotgap,
        dt=head.dt,
        noise=head.noise,
        output=output,
        checkpoint=checkpoint,
        checkpoint_freq=head.checkpoint_freq or 0,
        checkpoint_output=checkpoint_output,
        precision=head.precision,
        backend=device,
        kernel_language=language,
        halo_depth=head.halo_depth,
        model=model.name,
        supervise=supervise,
        max_restarts=max_restarts,
        watchdog="off",
        graceful_shutdown=False,
        ensemble=ens,
    )
