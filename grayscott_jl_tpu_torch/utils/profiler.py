"""Run metrics: the ``RunStats`` phase timer (counterpart of
``grayscott_jl_tpu/utils/profiler.py``).

Per-phase host wall clock (compute, device_to_host, output,
checkpoint, io_drain), step counters, and a JSON summary with
cell-updates/s, written where ``GS_TPU_STATS`` points. The driver closes
the compute phase with a device synchronise, so "compute" is device time
plus launch overhead, not enqueue time. Phases and counters may be added
to from any thread (the asynchronous writer's included). With the output
pipeline (``io/async_writer.py``), ``output`` and ``checkpoint`` are the
driver's own time on them (all of it at ``GS_ASYNC_IO_DEPTH=0``, the
time blocked on the pipeline otherwise), and the summary's ``io`` holds
the pipeline's ``overlap_stats``: each phase's writer time split into
``hidden_s`` (behind compute) and ``exposed_s``, and their totals.

With a span tracer (``obs/trace.py``, ``GS_TRACE``), every
:meth:`RunStats.phase` is also a span on the calling thread's track.
:meth:`RunStats.record_metrics`, :meth:`~RunStats.record_obs` and
:meth:`~RunStats.record_numerics` attach the run-end metrics snapshot,
the sinks' provenance and the numerics section, and
:meth:`~RunStats.record_watchdog` and :meth:`~RunStats.record_faults`
the hang watchdog's provenance and the fault journal, and
:meth:`~RunStats.record_comm` the fabric model's exchange budget
(``parallel/icimodel.comm_report``), under the reference's summary keys
(``metrics``, ``obs``, ``numerics``, ``watchdog``, ``faults``,
``comm``), and :meth:`~RunStats.record_executables` the build and
launch analytics (``executables``). :func:`trace` is the
``GS_TPU_PROFILE`` capture of a whole run.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, Optional

from ..config.env import env_raw


class RunStats:
    """Accumulates per-phase timings and counters for one run."""

    def __init__(self, L: int, config: Optional[dict] = None,
                 tracer=None):
        self.L = L
        #: Span tracer (``obs/trace.py``); None or the null tracer for
        #: none.
        self.tracer = tracer
        self.config = dict(config or {})
        self.phases: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}
        #: The output pipeline's overlap accounting (:meth:`record_io`).
        self.io: Optional[dict] = None
        #: The run-end metrics snapshot (:meth:`record_metrics`).
        self.metrics: Optional[dict] = None
        #: The armed sinks' ``describe()`` (:meth:`record_obs`).
        self.obs: Optional[dict] = None
        #: The numerics recorder's section (:meth:`record_numerics`).
        self.numerics: Optional[dict] = None
        #: The hang watchdog's provenance (:meth:`record_watchdog`).
        self.watchdog: Optional[dict] = None
        #: The run's fault journal (:meth:`record_faults`).
        self.faults: Optional[list] = None
        #: The exchange budget the fabric model projects for the run's
        #: config (:meth:`record_comm`): µs/step hidden and exposed by the
        #: split round, exchanges and halo bytes per step.
        self.comm: Optional[dict] = None
        #: The ensemble section (:meth:`record_ensemble`): the members'
        #: params and seeds, the member split and the latest per-member
        #: health; it also scales ``cell_updates_per_s`` by the active
        #: members.
        self.ensemble: Optional[dict] = None
        #: The build and launch analytics (:meth:`record_executables`).
        self.executables: Optional[dict] = None
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def add(self, name: str, seconds: float) -> None:
        """Add ``seconds`` to phase ``name``."""
        with self._lock:
            self.phases[name] = self.phases.get(name, 0.0) + seconds

    @contextlib.contextmanager
    def phase(self, name: str, step: Optional[int] = None):
        """Time a block under phase ``name``; with a tracer, also a span
        (``step`` in its args). Yields the span's args, which the block
        may add to, or None without a tracer."""
        tr = self.tracer
        span = (tr.span(name, phase=name, step=step)
                if tr is not None and tr.enabled
                else contextlib.nullcontext())
        with span as args:
            t = time.perf_counter()
            try:
                yield args
            finally:
                self.add(name, time.perf_counter() - t)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def record_io(self, overlap: Optional[dict]) -> None:
        """Attach the pipeline's ``overlap_stats()``, with the hidden and
        exposed totals over its phases."""
        if not overlap:
            self.io = None
            return
        self.io = dict(overlap)
        self.io["hidden_total_s"] = round(
            sum(overlap["hidden_s"].values()), 6)
        self.io["exposed_total_s"] = round(
            sum(overlap["exposed_s"].values()), 6)

    def record_faults(self, events: Optional[list]) -> None:
        """Attach the fault journal's records (injected faults, health
        trips, recoveries)."""
        self.faults = [dict(e) for e in events] if events else None

    def record_watchdog(self, info: Optional[dict]) -> None:
        """Attach the hang watchdog's provenance
        (``Watchdog.describe()``, or ``{"enabled": False}``)."""
        self.watchdog = dict(info) if info else None

    def record_comm(self, report: Optional[dict]) -> None:
        """Attach the fabric model's exchange budget
        (``parallel/icimodel.comm_report``)."""
        self.comm = dict(report) if report else None

    def record_metrics(self, snapshot: Optional[dict]) -> None:
        """Attach the run-end ``MetricsRegistry.snapshot()``."""
        self.metrics = dict(snapshot) if snapshot else None

    def record_obs(self, info: Optional[dict]) -> None:
        """Attach the sinks' provenance (trace / events / metrics
        ``describe()``)."""
        self.obs = dict(info) if info else None

    def record_numerics(self, info: Optional[dict]) -> None:
        """Attach the numerics section (``NumericsRecorder.describe()``
        and the mode)."""
        self.numerics = dict(info) if info else None

    def record_ensemble(self, info: Optional[dict]) -> None:
        """Attach the ensemble section (``EnsembleSettings.describe()``
        with the member split and the resolved seeds)."""
        self.ensemble = dict(info) if info else None

    def record_member_health(self, step: int, report) -> None:
        """Record the latest per-member health probe (an
        ``EnsembleHealthReport``) in the ensemble section: its ranges and
        the members, if any, that went non-finite, with the step."""
        if self.ensemble is None:
            self.ensemble = {}
        self.ensemble["health"] = {
            "step": step,
            **report.describe(),
            "member_reports": [m.describe() for m in report.members],
        }

    def record_executables(self, info: Optional[dict]) -> None:
        """Attach the build and launch analytics (``obs/xstats.py``): the
        ``summarize`` header, ``records`` and the fabric model's
        residual keys."""
        self.executables = dict(info) if info else None

    def summary(self) -> dict:
        total = time.perf_counter() - self._t0
        with self._lock:
            phases = dict(self.phases)
            counters = dict(self.counters)
        steps = counters.get("steps", 0)
        compute = phases.get("compute", total)
        # The aggregate over the ACTIVE members of an ensemble (1 solo):
        # idle slots advance in the launches but do no asked-for work.
        members = (int(self.ensemble.get("active_members",
                                         self.ensemble.get("members", 1)))
                   if self.ensemble else 1)
        return {
            "L": self.L,
            "config": dict(self.config),
            "steps": steps,
            "wall_s": round(total, 6),
            "phases_s": {k: round(v, 6) for k, v in phases.items()},
            "counters": counters,
            "cell_updates_per_s": (
                round(self.L**3 * steps * members / compute, 3)
                if compute > 0 else None
            ),
            "io": self.io,
            "comm": self.comm,
            "watchdog": self.watchdog,
            "faults": self.faults,
            "metrics": self.metrics,
            "obs": self.obs,
            "numerics": self.numerics,
            "ensemble": self.ensemble,
            "executables": self.executables,
        }

    def maybe_write(self) -> Optional[str]:
        """Write the summary where ``GS_TPU_STATS`` points (if set); in a
        run of several processes each writes its own, the path suffixed
        ``.rank<N>``, as in the reference."""
        path = env_raw("GS_TPU_STATS")
        if not path:
            return None
        from ..parallel import distributed

        if distributed.process_count() > 1:
            path = f"{path}.rank{distributed.process_index()}"
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.summary(), f)
            f.write("\n")
        return path


@contextlib.contextmanager
def trace(cuda: bool = False):
    """A ``torch.profiler`` capture of the run when ``GS_TPU_PROFILE``
    names a directory (the reference's ``jax.profiler`` trace): its
    Chrome trace ``gs_tpu_profile.json`` (``.rank<N>`` in a run of
    several processes) is written there when the run leaves, with the
    card's activity when ``cuda``. A profiler that fails to start or
    stop warns; the run goes on."""
    out = env_raw("GS_TPU_PROFILE")
    if not out:
        yield
        return
    import os
    import sys

    from ..obs.trace import profiler_capture

    try:
        cap = profiler_capture(os.path.join(out, "gs_tpu_profile.json"),
                               cuda)
    except Exception as e:  # noqa: BLE001 — never stop the run
        print(f"gray-scott-torch: warning: torch.profiler start failed "
              f"({e}); GS_TPU_PROFILE skipped", file=sys.stderr)
        yield
        return
    try:
        yield
    finally:
        try:
            cap.stop()
        except Exception as e:  # noqa: BLE001
            print(f"gray-scott-torch: warning: torch.profiler stop failed "
                  f"({e}); no GS_TPU_PROFILE trace", file=sys.stderr)
