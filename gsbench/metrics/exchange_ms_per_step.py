"""Device milliseconds per step in the halo exchange's NCCL kernels:
each process's device operations of the traced window whose name holds
``nccl`` (the ``device_ops`` of its trace), over the window's steps; the
most of any card.

None where a process has no trace, or no NCCL kernel ran in the window
(a cell of one block exchanges nothing)."""

UNIT = "ms"
LAYER = "halo exchange (parallel/halo.py, parallel/distributed.py)"
MOVES = "cell_updates_per_s"


def read(run):
    worst = 0.0
    for r in run["ranks"]:
        t = r["trace"]
        if not t:
            return None
        worst = max(worst, sum(s for name, s in t["device_ops"]
                               if "nccl" in name.lower()))
    return worst * 1e3 / run["steps"] if worst > 0 else None
