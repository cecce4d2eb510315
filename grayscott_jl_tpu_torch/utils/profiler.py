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

    def __init__(self, L: int, config: Optional[dict] = None):
        self.L = L
        self.config = dict(config or {})
        self.phases: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}
        #: The output pipeline's overlap accounting (:meth:`record_io`).
        self.io: Optional[dict] = None
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def add(self, name: str, seconds: float) -> None:
        """Add ``seconds`` to phase ``name``."""
        with self._lock:
            self.phases[name] = self.phases.get(name, 0.0) + seconds

    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        try:
            yield
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

    def summary(self) -> dict:
        total = time.perf_counter() - self._t0
        with self._lock:
            phases = dict(self.phases)
            counters = dict(self.counters)
        steps = counters.get("steps", 0)
        compute = phases.get("compute", total)
        return {
            "L": self.L,
            "config": dict(self.config),
            "steps": steps,
            "wall_s": round(total, 6),
            "phases_s": {k: round(v, 6) for k, v in phases.items()},
            "counters": counters,
            "cell_updates_per_s": (
                round(self.L**3 * steps / compute, 3)
                if compute > 0 else None
            ),
            "io": self.io,
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
