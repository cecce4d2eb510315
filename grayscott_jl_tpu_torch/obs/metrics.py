"""Metrics registry: counters, gauges, ring-buffer histograms
(counterpart of ``grayscott_jl_tpu/obs/metrics.py``).

``GS_METRICS=path`` arms the process-wide registry; the driver and what
it owns (the output writer, the health guard, the numerics recorder)
register instruments once at run start and touch them with plain
``inc`` / ``set`` / ``observe`` calls at the boundaries. Snapshots
flush as interval JSONL records (``metrics_interval_s`` key /
``GS_METRICS_INTERVAL_S``; 0 = only at run end) and, for scrapers, as
a one-shot Prometheus text dump (``GS_METRICS_PROM``).

Off means off: every constructor returns the shared
:data:`NULL_METRIC`, whose methods are no-ops.

The histogram is a fixed-capacity ring buffer: p50 / p95 / p99
(numpy's 'linear' interpolation, :func:`quantile`) cover the retained
window, ``count`` / ``sum`` / ``min`` / ``max`` the whole stream.
stdlib only.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import _proc_index, rank_path

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_METRIC",
    "get_metrics",
    "quantile",
    "reset_metrics",
    "resolve_interval_s",
]


def quantile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) of ``values`` with numpy's
    default 'linear' interpolation."""
    if not values:
        raise ValueError("quantile of an empty sequence")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"quantile q must be in [0, 100], got {q}")
    vs = sorted(values)
    rank = (q / 100.0) * (len(vs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(vs) - 1)
    frac = rank - lo
    return vs[lo] * (1.0 - frac) + vs[hi] * frac


class _NullMetric:
    """The shared off-switch: one instance stands in for every counter,
    gauge and histogram when metrics are off."""

    __slots__ = ()

    def inc(self, n=1) -> None:
        pass

    def set(self, value) -> None:
        pass

    def observe(self, value) -> None:
        pass


NULL_METRIC = _NullMetric()


class Counter:
    """Monotone event count (steps, rounds, steps written)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def as_dict(self) -> dict:
        return {"name": self.name, "labels": self.labels,
                "value": self.value}


class Gauge:
    """Last-written value (queue depth, memory in use, field ranges)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self.value = None

    def set(self, value) -> None:
        self.value = value

    def as_dict(self) -> dict:
        return {"name": self.name, "labels": self.labels,
                "value": self.value}


class Histogram:
    """Ring-buffer distribution with streaming count/sum/min/max.

    ``observe`` is O(1): once ``capacity`` is reached the newest sample
    overwrites the oldest, so the percentiles describe the trailing
    window and the scalar aggregates the whole stream."""

    __slots__ = ("name", "labels", "capacity", "count", "total",
                 "vmin", "vmax", "_buf", "_idx")

    def __init__(self, name: str = "", labels: Optional[dict] = None,
                 capacity: int = 1024):
        if capacity <= 0:
            raise ValueError(f"histogram capacity must be > 0, got "
                             f"{capacity}")
        self.name = name
        self.labels = dict(labels or {})
        self.capacity = capacity
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None
        self._buf: List[float] = []
        self._idx = 0

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if self.vmin is None or value < self.vmin:
            self.vmin = value
        if self.vmax is None or value > self.vmax:
            self.vmax = value
        if len(self._buf) < self.capacity:
            self._buf.append(value)
        else:
            self._buf[self._idx] = value
            self._idx = (self._idx + 1) % self.capacity

    @property
    def window(self) -> List[float]:
        """The retained samples (unordered)."""
        return list(self._buf)

    def percentile(self, q: float) -> Optional[float]:
        if not self._buf:
            return None
        return quantile(self._buf, q)

    def summary(self) -> dict:
        out = {
            "count": self.count,
            "sum": round(self.total, 9),
            "min": self.vmin,
            "max": self.vmax,
            "mean": (round(self.total / self.count, 9)
                     if self.count else None),
            "window": len(self._buf),
        }
        for q in (50, 95, 99):
            p = self.percentile(q)
            out[f"p{q}"] = round(p, 9) if p is not None else None
        return out

    def as_dict(self) -> dict:
        return {"name": self.name, "labels": self.labels,
                **self.summary()}


def resolve_interval_s(settings=None) -> float:
    """Flush cadence: ``GS_METRICS_INTERVAL_S`` wins over the
    ``metrics_interval_s`` key; 0 (the default) flushes only at run
    end."""
    raw = os.environ.get("GS_METRICS_INTERVAL_S")
    if raw is None or raw.strip() == "":
        v = float(getattr(settings, "metrics_interval_s", 0.0) or 0.0)
    else:
        try:
            v = float(raw)
        except ValueError as e:
            raise ValueError(
                f"GS_METRICS_INTERVAL_S must be a number, got {raw!r}"
            ) from e
    if v < 0:
        raise ValueError(f"metrics interval must be >= 0, got {v}")
    return v


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    n = _PROM_BAD.sub("_", name)
    return n if not n[:1].isdigit() else f"_{n}"


def _prom_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{_PROM_BAD.sub("_", k)}="{v}"'
             for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricsRegistry:
    """Get-or-create instrument registry with JSONL and Prometheus
    export. Instruments are keyed by ``(kind, name, labels)``: asking
    twice returns the same object. A disabled registry hands out
    :data:`NULL_METRIC` and never builds a table. The table is guarded
    by a lock, since the output writer's thread registers and sets its
    instruments beside the driver thread."""

    def __init__(self, path: Optional[str] = None,
                 interval_s: float = 0.0, proc: Optional[int] = None,
                 enabled: Optional[bool] = None):
        self.path = path
        self.interval_s = float(interval_s)
        self.proc = _proc_index() if proc is None else proc
        self.enabled = bool(path) if enabled is None else bool(enabled)
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple, object] = {}
        self._t0 = time.monotonic()
        self._last_flush = time.monotonic()
        self.flushes = 0

    def _get(self, kind: str, cls, name: str, labels: dict, **kw):
        key = (kind, name, tuple(sorted(labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, dict(labels), **kw)
        return m

    def counter(self, name: str, **labels):
        if not self.enabled:
            return NULL_METRIC
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels):
        if not self.enabled:
            return NULL_METRIC
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, capacity: int = 1024, **labels):
        if not self.enabled:
            return NULL_METRIC
        return self._get("histogram", Histogram, name, labels,
                         capacity=capacity)

    def snapshot(self) -> dict:
        """JSON-able state of every registered instrument."""
        with self._lock:
            items = list(self._metrics.items())
        out = {"counters": [], "gauges": [], "histograms": []}
        for (kind, _, _), m in items:
            out[kind + "s"].append(m.as_dict())
        return out

    def due(self) -> bool:
        """Would :meth:`maybe_flush` write now?"""
        return (self.enabled and bool(self.path)
                and self.interval_s > 0
                and time.monotonic() - self._last_flush
                >= self.interval_s)

    def maybe_flush(self, force: bool = False,
                    on_flush=None) -> Optional[str]:
        """Append one interval snapshot record when due (or forced).
        ``on_flush`` runs just before the write: the driver refreshes
        its device-memory gauges there, only when a record lands."""
        if not (self.enabled and self.path):
            return None
        if not force and not self.due():
            return None
        if on_flush is not None:
            on_flush()
        rec = {
            "ts": round(time.time(), 6),
            "uptime_s": round(time.monotonic() - self._t0, 6),
            "proc": self.proc,
            **self.snapshot(),
        }
        self._last_flush = time.monotonic()
        self.flushes += 1
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
        return self.path

    def prometheus_text(self) -> str:
        """Prometheus text exposition of the current state: counters as
        ``counter``, gauges as ``gauge``, histograms as ``summary``
        (quantile series and ``_count``/``_sum``)."""
        lines: List[str] = []
        snap = self.snapshot()
        for kind, prom_type in (("counters", "counter"),
                                ("gauges", "gauge")):
            seen = set()
            for m in snap[kind]:
                name = _prom_name(m["name"])
                if name not in seen:
                    lines.append(f"# TYPE {name} {prom_type}")
                    seen.add(name)
                v = m["value"]
                if v is None or isinstance(v, bool):
                    v = int(bool(v)) if isinstance(v, bool) else "NaN"
                lines.append(f"{name}{_prom_labels(m['labels'])} {v}")
        seen = set()
        for m in snap["histograms"]:
            name = _prom_name(m["name"])
            if name not in seen:
                lines.append(f"# TYPE {name} summary")
                seen.add(name)
            for q in (50, 95, 99):
                v = m.get(f"p{q}")
                if v is None:
                    continue
                qlabel = 'quantile="0.%d"' % q
                lines.append(
                    f"{name}{_prom_labels(m['labels'], qlabel)} {v}"
                )
            lines.append(
                f"{name}_count{_prom_labels(m['labels'])} {m['count']}"
            )
            lines.append(
                f"{name}_sum{_prom_labels(m['labels'])} {m['sum']}"
            )
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.prometheus_text())
        return path

    def describe(self) -> dict:
        with self._lock:
            n = len(self._metrics)
        return {"enabled": self.enabled, "path": self.path,
                "interval_s": self.interval_s, "instruments": n,
                "flushes": self.flushes}


_registry = None


def get_metrics(settings=None) -> MetricsRegistry:
    """The process-wide registry: armed when ``GS_METRICS`` names a path
    (``.rank<N>``-suffixed in a run of several processes), else a
    disabled registry. ``settings`` matters only at the first call (it
    resolves ``metrics_interval_s``)."""
    global _registry
    if _registry is None:
        path = os.environ.get("GS_METRICS", "").strip()
        _registry = MetricsRegistry(
            path=rank_path(path) if path else None,
            interval_s=resolve_interval_s(settings),
        )
    return _registry


def reset_metrics() -> None:
    """Drop the singleton (tests; re-resolved from the environment at
    the next use)."""
    global _registry
    _registry = None
