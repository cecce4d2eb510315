"""Field health guard (counterpart of
``grayscott_jl_tpu/resilience/health.py``).

A blown-up run (too large a ``dt``, a bad parameter region) turns every
later output step into NaN. The guard probes the fields at each output
or checkpoint boundary — an ``isfinite`` AND over every field and each
field's min and max, reduced on the device by
``Simulation.snapshot(health=True)`` before the host copy and resolved
with it — and acts on the report before anything is written.

Policy (``GS_HEALTH_POLICY`` wins over the ``health_policy`` key):

``abort`` (default)
    Raise :class:`HealthError` at the boundary: the poisoned step is
    never written and the run stops.
``warn``
    Log and write the step anyway.
``off``
    No probe at all.
``rollback``
    Raise :class:`HealthError` with ``policy == "rollback"``, which the
    supervisor (``resilience/supervisor.py``) classifies as ``health``
    and restarts from the latest durable checkpoint. It needs
    supervision (``GS_SUPERVISE=1`` or ``supervise = true``): without,
    :func:`resolve_policy` raises at start-up, since nothing would roll
    back.

:class:`DriftGate` is the same gate over the numerics probes' drift
signal (``obs/numerics.py``): ``GS_DRIFT_POLICY`` ``warn`` (default)
records each trip as a ``drift`` event, ``abort`` raises
:class:`DriftError` at the probe, ``rollback`` raises it for the
supervisor to restart (and, like the health guard's, raises at start-up
without supervision), ``off`` gates nothing; ``GS_DRIFT_LIMIT`` (default
0.5) is the trip threshold.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config.env import env_raw

__all__ = [
    "DRIFT_POLICIES",
    "POLICIES",
    "DriftError",
    "DriftGate",
    "EnsembleHealthReport",
    "HealthError",
    "HealthGuard",
    "HealthReport",
    "device_probe",
    "member_probe",
    "resolve_policy",
]

POLICIES = ("abort", "rollback", "warn", "off")

DRIFT_POLICIES = ("warn", "abort", "rollback", "off")


def _check_rollback(what: str, settings=None) -> None:
    """``rollback`` restarts through the supervisor: without supervision
    it raises at start-up."""
    from .supervisor import supervision_enabled

    if not supervision_enabled(settings):
        raise ValueError(
            f"{what} 'rollback' restarts the run from its latest durable "
            "checkpoint through the supervisor; arm supervision "
            "(GS_SUPERVISE=1 or supervise = true) or use another policy")


class HealthReport:
    """The resolved probe of one boundary: ``finite`` over every field
    and one ``(min, max)`` range per field, with the model's field
    names (``u``/``v`` for two unnamed fields, ``f0``... otherwise)."""

    def __init__(self, finite, *minmax, names=None, ranges=None):
        self.finite = bool(finite)
        if ranges is None:
            if len(minmax) % 2:
                raise ValueError(
                    "HealthReport needs (min, max) pairs per field")
            ranges = tuple((float(minmax[i]), float(minmax[i + 1]))
                           for i in range(0, len(minmax), 2))
        self.ranges = tuple((float(lo), float(hi)) for lo, hi in ranges)
        if names is None:
            names = ("u", "v")[:len(self.ranges)]
            if len(names) < len(self.ranges):
                names = tuple(f"f{i}" for i in range(len(self.ranges)))
        self.names = tuple(names)

    @property
    def u_min(self) -> float:
        return self.ranges[0][0]

    @property
    def u_max(self) -> float:
        return self.ranges[0][1]

    @property
    def v_min(self) -> float:
        return self.ranges[1][0]

    @property
    def v_max(self) -> float:
        return self.ranges[1][1]

    def range_summary(self) -> str:
        return ", ".join(f"{n} in [{lo}, {hi}]"
                         for n, (lo, hi) in zip(self.names, self.ranges))

    def describe(self) -> dict:
        return {
            "finite": self.finite,
            **{f"{n}_range": [lo, hi]
               for n, (lo, hi) in zip(self.names, self.ranges)},
        }


class EnsembleHealthReport:
    """Per-member probe results of an ensemble boundary (the reference's
    ``EnsembleHealthReport``): each member's :class:`HealthReport`, from
    one probe reduced over the spatial axes only, so that ONE diverging
    member is named by its index (:attr:`bad_members`) in the report,
    the :class:`HealthError` and the journal. ``active`` masks idle
    slots (None: every slot is a real member): an idle slot is left out
    of the verdict, the ranges and the attribution."""

    def __init__(self, members, active=None):
        self.members = tuple(members)
        self.active = None if active is None else tuple(active)

    def _active(self, i: int) -> bool:
        return self.active is None or bool(self.active[i])

    @property
    def active_members(self) -> list:
        return [m for i, m in enumerate(self.members) if self._active(i)]

    @property
    def finite(self) -> bool:
        return all(m.finite for m in self.active_members)

    @property
    def bad_members(self) -> list:
        return [i for i, m in enumerate(self.members)
                if self._active(i) and not m.finite]

    @property
    def names(self) -> tuple:
        return self.members[0].names

    @property
    def ranges(self) -> tuple:
        live = self.active_members
        return tuple((min(m.ranges[i][0] for m in live),
                      max(m.ranges[i][1] for m in live))
                     for i in range(len(self.members[0].ranges)))

    @property
    def u_min(self) -> float:
        return self.ranges[0][0]

    @property
    def u_max(self) -> float:
        return self.ranges[0][1]

    @property
    def v_min(self) -> float:
        return self.ranges[1][0]

    @property
    def v_max(self) -> float:
        return self.ranges[1][1]

    def range_summary(self) -> str:
        return ", ".join(f"{n} in [{lo}, {hi}]"
                         for n, (lo, hi) in zip(self.names, self.ranges))

    def describe(self) -> dict:
        out = {
            "finite": self.finite,
            "members": len(self.members),
            "bad_members": self.bad_members,
            **{f"{n}_range": [lo, hi]
               for n, (lo, hi) in zip(self.names, self.ranges)},
        }
        if self.active is not None and not all(self.active):
            out["active_members"] = len(self.active_members)
        return out


class HealthError(RuntimeError):
    """A field failed the health check at a boundary (an ensemble's
    message names its non-finite members)."""

    def __init__(self, step: int, report, policy: str):
        bad = getattr(report, "bad_members", None)
        detail = f"; non-finite members={bad}" if bad is not None else ""
        super().__init__(
            f"field health check failed at step {step} "
            f"(finite={report.finite}, {report.range_summary()}{detail}); "
            f"policy={policy}")
        self.step = step
        self.report = report
        self.policy = policy


class DriftError(HealthError):
    """The numerics drift gate tripped under the ``abort`` or
    ``rollback`` policy (a :class:`HealthError`, so that the supervisor
    classifies ``rollback`` as ``health``)."""

    def __init__(self, step: int, event: dict, policy: str):
        tripped = event.get("tripped", {})
        RuntimeError.__init__(
            self,
            f"numerics drift gate tripped at step {step}: "
            + ", ".join(f"{k}={v:+.3f}" for k, v in tripped.items())
            + f" (|drift| > {event.get('limit')}); policy={policy}")
        self.step = step
        self.report = None
        self.event = dict(event)
        self.policy = policy


class DriftGate:
    """Policy gate over the numerics drift signal (``GS_DRIFT_POLICY``,
    ``GS_DRIFT_LIMIT``): :meth:`check` judges one probe's drifts and
    returns the trip's event, :meth:`enforce` raises
    :class:`DriftError` for it under ``abort`` and ``rollback``."""

    def __init__(self, policy: str = "warn", limit: float = 0.5):
        if policy not in DRIFT_POLICIES:
            raise ValueError(
                f"Unsupported drift policy: {policy!r}. "
                f"Supported: {', '.join(DRIFT_POLICIES)}")
        if limit <= 0:
            raise ValueError(f"drift limit must be > 0, got {limit}")
        self.policy = policy
        self.limit = float(limit)

    @classmethod
    def from_env(cls, settings=None) -> "DriftGate":
        policy = (env_raw("GS_DRIFT_POLICY") or "warn").lower()
        raw = (env_raw("GS_DRIFT_LIMIT") or "").strip()
        try:
            limit = float(raw) if raw else 0.5
        except ValueError as e:
            raise ValueError(
                f"GS_DRIFT_LIMIT must be a number, got {raw!r}") from e
        if policy == "rollback":
            _check_rollback("drift policy", settings)
        return cls(policy, limit)

    @property
    def raising(self) -> bool:
        """Does a trip unwind the run rather than only record it?"""
        return self.policy in ("abort", "rollback")

    def check(self, step: int, drifts: dict) -> Optional[dict]:
        """The trip's event (``policy``, ``limit``, ``tripped``) when any
        of one probe's drifts (``"field.stat" -> relative change``)
        exceeds the limit under an active policy, else None."""
        if self.policy == "off":
            return None
        tripped = {k: v for k, v in drifts.items() if abs(v) > self.limit}
        if not tripped:
            return None
        return {"policy": self.policy, "limit": self.limit,
                "tripped": tripped}

    def enforce(self, step: int, event: dict) -> None:
        """Raise :class:`DriftError` for a trip under ``abort`` or
        ``rollback``."""
        if event is not None and self.raising:
            raise DriftError(step, event, self.policy)


def device_probe(*fields) -> torch.Tensor:
    """The probe of one block, reduced on the fields' device: a float64
    vector ``(finite, min_0, max_0, ..., min_n, max_n)`` (finite as 1.0
    or 0.0; a NaN anywhere in a field makes its min and max NaN, as
    the reference's reduction does). Enqueued only: nothing waits."""
    finite = torch.stack([torch.isfinite(f).all() for f in fields]).all()
    parts = [finite.to(torch.float64).reshape(1)]
    for f in fields:
        lo, hi = torch.aminmax(f)
        parts.append(torch.stack([lo, hi]).to(torch.float64))
    return torch.cat(parts)


def member_probe(*fields) -> torch.Tensor:
    """:func:`device_probe` of each member of member-stacked fields
    ``(N, nx, ny, nz)``: an ``(N, 1 + 2n)`` float64 matrix, one row per
    member, reduced over the spatial axes only."""
    flat = [f.reshape(f.shape[0], -1) for f in fields]
    finite = torch.stack([torch.isfinite(f).all(1) for f in flat], 1).all(1)
    parts = [finite.to(torch.float64).reshape(-1, 1)]
    for f in flat:
        lo, hi = torch.aminmax(f, dim=1)
        parts.append(torch.stack([lo, hi], 1).to(torch.float64))
    return torch.cat(parts, 1)


def report_of(probes, names, reduce=None) -> HealthReport:
    """The boundary's :class:`HealthReport` from the host copies of the
    blocks' :func:`device_probe` vectors: finite if every block is, the
    ranges the blocks' min of mins and max of maxes (NaN wins).
    ``reduce`` combines this process's vector with the other processes'
    (``parallel/distributed.reduce_probe``), so that every process reads
    the same report."""
    probes = np.asarray([np.asarray(p, dtype=np.float64)[:1 + 2 * len(names)]
                         for p in probes])
    # np.min/np.max propagate NaN: a NaN in any block wins its entry.
    vec = np.concatenate([probes[:, :1].min(0),
                          np.stack([probes[:, 1::2].min(0),
                                    probes[:, 2::2].max(0)], 1).reshape(-1)])
    if reduce is not None:
        vec = reduce(vec)
    ranges = [(float(vec[1 + 2 * i]), float(vec[2 + 2 * i]))
              for i in range(len(names))]
    return HealthReport(bool(vec[0]), names=names, ranges=ranges)


def resolve_policy(settings=None) -> str:
    """``GS_HEALTH_POLICY``, else the ``health_policy`` key, else
    ``abort``. An unknown value raises at start-up, and so does
    ``rollback`` without supervision."""
    policy = env_raw("GS_HEALTH_POLICY")
    if policy is None and settings is not None:
        policy = getattr(settings, "health_policy", "")
    policy = (policy or "abort").strip().lower()
    if policy not in POLICIES:
        raise ValueError(
            f"Unsupported health policy: {policy!r}. "
            f"Supported: {', '.join(POLICIES)}")
    if policy == "rollback":
        _check_rollback("health policy", settings)
    return policy


class HealthGuard:
    """Boundary-time enforcement of the policy over resolved reports."""

    def __init__(self, policy: str = "abort"):
        if policy not in POLICIES:
            raise ValueError(f"Unsupported health policy: {policy!r}")
        self.policy = policy

    @classmethod
    def from_env(cls, settings=None) -> "HealthGuard":
        return cls(resolve_policy(settings))

    @property
    def enabled(self) -> bool:
        return self.policy != "off"

    @staticmethod
    def record_metrics(report, metrics) -> None:
        """Mirror one boundary's probe into the metrics registry
        (``obs/metrics.py``): the ``field_finite`` gauge and each
        field's ``field_min``/``field_max``; for an ensemble also
        ``ensemble_members_bad`` and each real member's
        ``ensemble_member_finite``."""
        if metrics is None or report is None:
            return
        metrics.gauge("field_finite").set(int(report.finite))
        for name, (lo, hi) in zip(report.names, report.ranges):
            metrics.gauge("field_min", field=name).set(lo)
            metrics.gauge("field_max", field=name).set(hi)
        members = getattr(report, "members", None)
        if members is not None:
            metrics.gauge("ensemble_members_bad").set(len(report.bad_members))
            for i, m in enumerate(members):
                if report._active(i):
                    metrics.gauge("ensemble_member_finite",
                                  member=str(i)).set(int(m.finite))

    def check(self, step: int, report, *, log=None,
              metrics=None) -> Optional[dict]:
        """Enforce the policy on one boundary's report, after mirroring
        it into ``metrics`` (healthy ones too). Healthy (or disabled)
        returns None; unhealthy under ``warn`` logs and returns the
        event; under ``abort`` and ``rollback`` raises :class:`HealthError`
        (the supervisor acts on the policy)."""
        if not self.enabled or report is None:
            return None
        self.record_metrics(report, metrics)
        if report.finite:
            return None
        if self.policy == "warn":
            event = {"event": "health", "kind": "health", "step": step,
                     "policy": "warn", "action": "continued",
                     **report.describe()}
            if log is not None:
                log.warn(f"field health check failed at step {step} "
                         f"(non-finite values); policy=warn, continuing")
            return event
        raise HealthError(step, report, self.policy)
