"""Host microseconds of the port's own work per kernel launch: the
program's counters ``cuda_stencil.timings()`` (``dispatch_ns``, the time
in its ``gs_launch`` calls less the library calls and the operand ops
inside them, so no wait on a full launch queue, over ``launches``, the
launches timed), both zeroed at the window's start, counted while the
run's capture was live and read by each process after its window; the
most of any process.

None where a process timed no launch, or where its timed launches are
not its window's launches (the counters did not cover exactly the
window, or the program has no such counters)."""

UNIT = "us"
LAYER = "simulation and dispatch (simulation.py, ops/cuda_stencil.py)"
MOVES = "cell_updates_per_s"


def read(run):
    out = None
    for r in run["ranks"]:
        t = r.get("timings")
        if not t or not t["launches"] or t["launches"] != r["launches"]:
            return None
        us = t["dispatch_ns"] / 1e3 / t["launches"]
        out = us if out is None else max(out, us)
    return out
