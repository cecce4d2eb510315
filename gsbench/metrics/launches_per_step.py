"""Kernel launches per step in the window: the program's counter
``cuda_stencil.LAUNCHES`` (zeroed at the window's start) over the
window's steps, the most of any process."""

UNIT = "1/step"
LAYER = "simulation and dispatch (simulation.py, ops/cuda_stencil.py)"
MOVES = "cell_updates_per_s"


def read(run):
    return max(r["launches"] for r in run["ranks"]) / run["steps"]
