"""The one timing discipline of the port (counterpart of
``grayscott_jl_tpu/utils/benchmark.py``'s ``time_sim_rounds``): the
autotuner's measurements and the fabric probe go through it, so that
the warmup and the completion rule cannot drift between them."""

from __future__ import annotations

import statistics
import time
from typing import Dict


def time_sim_rounds(sim, steps: int, rounds: int, deadline: float = None
                    ) -> Dict[str, object]:
    """Per-round seconds per step of ``steps`` simulation steps, after
    an untimed warmup chunk of the same size (it builds or loads the
    kernels and pays the first launches).

    Completion is forced with ``sim.block_until_ready()`` (a
    ``torch.cuda.synchronize`` of each of the run's cards) after the
    warmup and after every round. ``deadline`` (a ``time.monotonic()``
    instant, the autotuner's budget) stops adding rounds after the first
    once it has passed — the first always completes; in a run of several
    processes the processes agree on it, so that each runs the same
    rounds. Returns the chronological ``rounds_s_per_step``, ``best``
    and ``median``."""
    from ..parallel import distributed

    sim.iterate(steps)
    sim.block_until_ready()
    per_round = []
    for i in range(rounds):
        if i and deadline is not None:
            passed = time.monotonic() >= deadline
            if sim.processes > 1:
                passed = distributed.any_process(passed)
            if passed:
                break
        t0 = time.perf_counter()
        sim.iterate(steps)
        sim.block_until_ready()
        per_round.append((time.perf_counter() - t0) / steps)
    return {
        "rounds_s_per_step": per_round,
        "best": min(per_round),
        "median": statistics.median(per_round),
    }
