"""Ensemble members advanced by one kernel launch: the program's counter
``cuda_stencil.MODE_MEMBERS`` (the most per mode) over the window."""

UNIT = "1"
LAYER = "ensemble (ensemble/engine.py)"
MOVES = "cell_updates_per_s"


def read(run):
    vals = [r["members_per_launch"] for r in run["ranks"]
            if r["members_per_launch"]]
    return float(max(vals)) if vals else None
