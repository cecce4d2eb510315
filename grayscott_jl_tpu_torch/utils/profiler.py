"""Run metrics: the ``RunStats`` phase timer (counterpart of
``grayscott_jl_tpu/utils/profiler.py``).

Per-phase host wall clock (compute, device_to_host, output,
checkpoint), step counters, and a JSON summary with cell-updates/s,
written where ``GS_TPU_STATS`` points. The driver closes the compute
phase with a device synchronise, so "compute" is device time plus
launch overhead, not enqueue time.
"""

from __future__ import annotations

import contextlib
import json
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
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t
            )

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def summary(self) -> dict:
        total = time.perf_counter() - self._t0
        steps = self.counters.get("steps", 0)
        compute = self.phases.get("compute", total)
        return {
            "L": self.L,
            "config": dict(self.config),
            "steps": steps,
            "wall_s": round(total, 6),
            "phases_s": {k: round(v, 6) for k, v in self.phases.items()},
            "counters": dict(self.counters),
            "cell_updates_per_s": (
                round(self.L**3 * steps / compute, 3)
                if compute > 0 else None
            ),
        }

    def maybe_write(self) -> Optional[str]:
        """Write the summary where ``GS_TPU_STATS`` points (if set)."""
        path = env_raw("GS_TPU_STATS")
        if not path:
            return None
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.summary(), f)
            f.write("\n")
        return path
