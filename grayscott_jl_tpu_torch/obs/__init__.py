"""Observability: span tracing, metrics, the run event stream and the
numerics probes (counterpart of ``grayscott_jl_tpu/obs/``).

* :mod:`.trace` — nestable host-side spans exported as Chrome
  trace-event JSON (``GS_TRACE=path``; opens in Perfetto), fed by the
  driver's phase edges, ``RunStats`` phases and the output writer's
  phases on its own thread; and the hot path's ranges and counters
  (rounds, launches, the exchange), armed by ``GS_TRACE`` or a live
  ``torch.profiler`` capture (:func:`~.trace.hot_armed`).
* :mod:`.metrics` — counters / gauges / ring-buffer histograms
  (p50/p95/p99) flushed as interval JSONL (``GS_METRICS=path``,
  ``metrics_interval_s``) with a one-shot Prometheus dump
  (``GS_METRICS_PROM=path``).
* :mod:`.events` — one schema ``(ts, proc, kind, phase, step, attrs)``
  for the run's lifecycle markers, shutdown requests, integrity records
  and numerics/drift records (``GS_EVENTS=path``), merged across
  processes on read (:func:`~.events.parse_events_multi`).
* :mod:`.numerics` — per-field min/max/mean/L2/non-finite reductions on
  the fields' device (``GS_NUMERICS=boundary|every_round``), resolved
  into gauges, ``numerics`` events and a windowed drift signal gated by
  ``resilience.health.DriftGate``.

Contract, as in the reference: obs on or off leaves the stores bitwise
the same — every hook observes host-side control flow or only reads the
fields. Each sink resolves its path from the environment once (a
process-wide singleton, ``.rank<N>``-suffixed in a run of several
processes) and is a no-op when its variable is unset.

* :mod:`.xstats` — build and launch analytics (``GS_XSTATS``): each
  library built or loaded and each kernel entry launched, with the
  card's attributes and the launch's cost, and the exchange census.
* :class:`~.trace.ProfileWindow` — a ``torch.profiler`` capture of a
  step range (``GS_PROFILE``); ``utils/profiler.trace`` captures a
  whole run (``GS_TPU_PROFILE``).
* :mod:`.report` — the run report over these artifacts
  (``python -m grayscott_jl_tpu_torch.obs.report``).
"""

from .events import (  # noqa: F401
    EventStream,
    get_events,
    parse_events,
    parse_events_multi,
)
from .metrics import Histogram, MetricsRegistry, get_metrics  # noqa: F401
from .numerics import NumericsRecorder, NumericsReport  # noqa: F401
from .trace import ProfileWindow, SpanTracer, get_tracer  # noqa: F401

__all__ = [
    "EventStream",
    "Histogram",
    "MetricsRegistry",
    "NumericsRecorder",
    "NumericsReport",
    "ProfileWindow",
    "SpanTracer",
    "get_events",
    "get_metrics",
    "get_tracer",
    "parse_events",
    "parse_events_multi",
]
