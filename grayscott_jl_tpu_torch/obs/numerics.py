"""Numerics probes: per-field statistics of the live fields (counterpart
of ``grayscott_jl_tpu/obs/numerics.py``).

Per field **min / max / mean / L2 / non-finite count**, reduced on the
fields' device beside the health probe, resolved on the host into
gauges, a ``numerics`` record per probe on the event stream
(``GS_EVENTS``) and a windowed **drift** signal (the relative change of
each statistic against a trailing window), whose trips land as ``drift``
records and go through the policy gate
(``resilience.health.DriftGate``).

Knob (``GS_NUMERICS`` wins over the ``numerics`` key):

``off`` (default)
    No probe, no recorder.
``boundary``
    The probe runs in the boundary snapshot's pass over the pristine
    fields (``Simulation.snapshot_async(numerics=True)``), and its
    scalars come back beside the health probe's.
``every_round``
    A probe-only reduction also runs after every round of steps
    (``Simulation.numerics_stats``), boundaries included.

The probe only reads the fields: the stores are bitwise the same with it
on or off.

The reduction (:func:`device_partials`): each block reduces to six
partials per field — min, max, sum, sum of squares, cell count and
non-finite count — over the block's stored (padded) cells, widened to
float32 whatever the field dtype, as the reference does; the sums
accumulate in float64. :func:`combine` merges the partials of every
block (of every process: a run of several processes gathers them), a
NaN anywhere winning min and max as in the reference's single
reduction, and :func:`report_of` turns them into
the :class:`NumericsReport` the reference's reduction over the global
array gives: ``min``/``max``/``nonfinite`` equal, ``mean``/``l2``
within the last bits of float32 (another summation order).
"""

from __future__ import annotations

import math
import os
from collections import deque
from typing import Dict, List, Optional, Sequence

__all__ = [
    "DRIFT_STATS",
    "MODES",
    "NumericsRecorder",
    "NumericsReport",
    "PARTIALS",
    "STATS",
    "combine",
    "device_partials",
    "member_partials",
    "report_of",
    "resolve_numerics",
    "resolve_report",
    "resolve_window",
]

MODES = ("off", "boundary", "every_round")

#: Per-field statistics of a report, in the reference's order.
STATS = ("min", "max", "mean", "l2", "nonfinite")

#: The statistics the drift signal tracks (``nonfinite`` is the health
#: guard's).
DRIFT_STATS = ("min", "max", "mean", "l2")

#: Per-field partials of one block, in :func:`device_partials`' order.
PARTIALS = ("min", "max", "sum", "sumsq", "count", "nonfinite")


def resolve_numerics(settings=None) -> str:
    """``GS_NUMERICS`` wins over the ``numerics`` key; default ``off``.
    Unknown values raise at start-up."""
    mode = os.environ.get("GS_NUMERICS")
    if mode is None and settings is not None:
        mode = getattr(settings, "numerics", "")
    mode = (mode or "off").lower()
    if mode not in MODES:
        raise ValueError(
            f"Unsupported numerics mode: {mode!r}. "
            f"Supported: {', '.join(MODES)}"
        )
    return mode


def resolve_window(default: int = 8) -> int:
    """Length of the drift signal's reference window
    (``GS_NUMERICS_WINDOW``, default 8 probes)."""
    raw = os.environ.get("GS_NUMERICS_WINDOW", "").strip()
    if not raw:
        return default
    try:
        w = int(raw)
    except ValueError as e:
        raise ValueError(
            f"GS_NUMERICS_WINDOW must be an integer, got {raw!r}"
        ) from e
    if w < 1:
        raise ValueError(f"GS_NUMERICS_WINDOW must be >= 1, got {w}")
    return w


def device_partials(*fields):
    """One block's partials, reduced on the fields' device: a float64
    vector of :data:`PARTIALS` per field, in declaration order. The
    fields are widened to float32 (bfloat16 exactly); the sums
    accumulate in float64. Enqueued only: nothing waits."""
    import torch

    parts = []
    for f in fields:
        g = f.float()
        lo, hi = torch.aminmax(g)
        parts.append(torch.stack([
            lo.double(), hi.double(),
            torch.sum(g, dtype=torch.float64),
            torch.sum(g * g, dtype=torch.float64),
            g.new_full((), float(g.numel()), dtype=torch.float64),
            (~torch.isfinite(g)).sum().double(),
        ]))
    return torch.cat(parts)


def member_partials(*fields):
    """:func:`device_partials` of each member of member-stacked fields
    ``(N, nx, ny, nz)``: an ``(N, 6n)`` float64 matrix, one row per
    member, each a reduction over the spatial axes only."""
    import torch

    parts = []
    for f in fields:
        g = f.float().reshape(f.shape[0], -1)
        lo, hi = torch.aminmax(g, dim=1)
        parts.append(torch.stack([
            lo.double(), hi.double(),
            torch.sum(g, 1, dtype=torch.float64),
            torch.sum(g * g, 1, dtype=torch.float64),
            torch.full_like(lo, float(g.shape[1]), dtype=torch.float64),
            (~torch.isfinite(g)).sum(1).double(),
        ], 1))
    return torch.cat(parts, 1)


def _nan_min(xs) -> float:
    return math.nan if any(math.isnan(x) for x in xs) else min(xs)


def _nan_max(xs) -> float:
    return math.nan if any(math.isnan(x) for x in xs) else max(xs)


def _sum(xs) -> float:
    """The correctly rounded sum (so the order of the blocks does not
    matter); NaN where +inf meets -inf."""
    try:
        return math.fsum(xs)
    except ValueError:
        return math.nan


def identity_partials(n_fields: int) -> List[float]:
    """The partials of no cells for ``n_fields`` fields: :func:`combine`
    merges them with any rows to the same bits as without them."""
    row = {"min": math.inf, "max": -math.inf}
    return [row.get(stat, 0.0) for stat in PARTIALS] * n_fields


def combine(rows: Sequence[Sequence[float]]) -> List[float]:
    """Merge the partial vectors of blocks into one: the mins by min and
    the maxes by max (a NaN wins), the rest by their correctly rounded
    sum, so that any split of the same blocks (among processes, in any
    order) merges to the same bits."""
    rows = [[float(x) for x in r] for r in rows]
    n = len(PARTIALS)
    out = []
    for j in range(len(rows[0])):
        col = [r[j] for r in rows]
        stat = PARTIALS[j % n]
        out.append(_nan_min(col) if stat == "min"
                   else _nan_max(col) if stat == "max" else _sum(col))
    return out


def report_of(partials: Sequence[float], names) -> "NumericsReport":
    """The :class:`NumericsReport` of merged partials (:func:`combine`)."""
    n = len(PARTIALS)
    raw = []
    for i in range(len(names)):
        lo, hi, total, sumsq, count, bad = partials[i * n:(i + 1) * n]
        raw += [lo, hi, total / count, math.sqrt(sumsq), bad]
    return resolve_report(raw, names)


def resolve_report(raw, names) -> "NumericsReport":
    """One probe's flat scalars (:data:`STATS` per field) as a
    :class:`NumericsReport`."""
    n = len(STATS)
    fields: Dict[str, dict] = {}
    for i, name in enumerate(names):
        vals = raw[i * n:(i + 1) * n]
        fields[name] = {
            "min": float(vals[0]),
            "max": float(vals[1]),
            "mean": float(vals[2]),
            "l2": float(vals[3]),
            "nonfinite": int(vals[4]),
        }
    return NumericsReport(fields)


class NumericsReport:
    """One probe's per-field statistics: ``fields`` maps each model field
    name to its :data:`STATS` dict. ``members``, for an ensemble, holds
    one such mapping per member, and ``fields`` is then their aggregate
    over the active members (:meth:`aggregate_members`), so that the
    gauges and the drift window read an ensemble's report as a solo
    one's."""

    def __init__(self, fields: Dict[str, dict],
                 members: Optional[List[Dict[str, dict]]] = None):
        self.fields = fields
        self.members = members

    @classmethod
    def aggregate_members(cls, members: List[Dict[str, dict]],
                          active=None) -> "NumericsReport":
        """The reference's cross-member aggregate: min of mins, max of
        maxes, mean of means, root of the summed squares and the summed
        non-finite counts over the members ``active`` marks (None: all);
        ``members`` keeps every slot's rows for attribution."""
        live = (members if active is None or all(active)
                else [m for i, m in enumerate(members) if active[i]])
        agg = {}
        for name in members[0]:
            rows = [m[name] for m in live]
            agg[name] = {
                "min": min(r["min"] for r in rows),
                "max": max(r["max"] for r in rows),
                "mean": sum(r["mean"] for r in rows) / len(rows),
                "l2": sum(r["l2"] ** 2 for r in rows) ** 0.5,
                "nonfinite": sum(r["nonfinite"] for r in rows),
            }
        return cls(agg, members=members)

    @property
    def finite(self) -> bool:
        return all(r["nonfinite"] == 0 for r in self.fields.values())

    def describe(self) -> dict:
        out = {"fields": self.fields}
        if self.members is not None:
            out["members"] = self.members
        return out


class NumericsRecorder:
    """Consumer of resolved probes: gauges, events, drift.

    Per probe it sets every field statistic as a
    ``numerics_<stat>{field=...}`` gauge, emits one ``numerics`` record,
    updates the trailing window and sets each statistic's drift as a
    ``numerics_drift{field,stat}`` gauge. A trip (any |drift| above the
    gate's limit) is logged, emitted as a ``drift`` record and then
    enforced by the gate (``DriftError`` under ``abort`` and
    ``rollback``). With a fault journal (``resilience/supervisor.py``) a
    raising trip is journaled, and the journal mirrors it onto the
    stream."""

    enabled = True

    def __init__(self, names, *, metrics=None, events=None, gate=None,
                 log=None, labels=None, window: Optional[int] = None,
                 journal=None):
        self.names = tuple(names)
        self.journal = journal
        self.metrics = metrics
        self.events = events
        self.gate = gate
        self.log = log
        self.labels = dict(labels or {})
        self.window = resolve_window() if window is None else int(window)
        self.probes = 0
        self.drift_trips = 0
        self.last: Optional[NumericsReport] = None
        self.max_drift: Dict[str, float] = {}
        self._hist: Dict[tuple, deque] = {}

    def _drift(self, field: str, stat: str, value: float
               ) -> Optional[float]:
        """Bounded relative change of ``value`` against the trailing
        window's mean, ``(value - ref) / max(|ref|, |value|)`` (0.5: the
        statistic doubled; ±1: it appeared from or collapsed to zero;
        beyond ±1: it crossed sign). None until the window has a value;
        ``value`` joins the window after the comparison."""
        key = (field, stat)
        hist = self._hist.get(key)
        if hist is None:
            hist = self._hist[key] = deque(maxlen=self.window)
        drift = None
        if hist:
            ref = sum(hist) / len(hist)
            drift = (value - ref) / max(abs(ref), abs(value), 1e-30)
        hist.append(value)
        return drift

    def observe(self, step, report, boundary: bool = False) -> None:
        """Consume one :class:`NumericsReport`."""
        if report is None:
            return
        self.probes += 1
        self.last = report
        m = self.metrics
        drifts: Dict[str, float] = {}
        for field, stats in report.fields.items():
            if m is not None:
                for stat in STATS:
                    m.gauge(f"numerics_{stat}", field=field,
                            **self.labels).set(stats[stat])
            for stat in DRIFT_STATS:
                d = self._drift(field, stat, stats[stat])
                if d is None:
                    continue
                key = f"{field}.{stat}"
                drifts[key] = round(d, 9)
                prev = self.max_drift.get(key)
                if prev is None or abs(d) > abs(prev):
                    self.max_drift[key] = round(d, 9)
                if m is not None:
                    m.gauge("numerics_drift", field=field, stat=stat,
                            **self.labels).set(round(d, 9))
        if self.events is not None:
            self.events.emit(
                "numerics", phase="io" if boundary else "step_round",
                step=step, **report.describe(),
            )
        if self.gate is not None and drifts:
            event = self.gate.check(step, drifts)
            if event is not None:
                self.drift_trips += 1
                if self.log is not None:
                    tripped = event.get("tripped", {})
                    self.log.warn(
                        f"numerics drift at step {step}: "
                        + ", ".join(
                            f"{k}={v:+.3f}" for k, v in tripped.items()
                        )
                        + f" (|drift| > {event.get('limit')}, "
                        f"policy={event.get('policy')})"
                    )
                if self.gate.raising and self.journal is not None:
                    # The journal mirrors onto the stream: one drift
                    # record either way.
                    self.journal.record(event="drift", step=step, **event)
                elif self.events is not None:
                    self.events.emit("drift", step=step, **event)
                # The trip is on the stream before an abort unwinds.
                self.gate.enforce(step, event)

    def describe(self) -> dict:
        """The ``RunStats`` ``numerics`` section: probe count, the last
        statistics and each statistic's worst drift."""
        return {
            "probes": self.probes,
            "window": self.window,
            "drift_trips": self.drift_trips,
            "last": self.last.describe() if self.last else None,
            "max_drift": dict(self.max_drift),
        }
