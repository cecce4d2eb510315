"""The share of the traced window in which no operation ran on the
device (the union of every device event of the ``torch.profiler``
capture), averaged over the cards."""

UNIT = "%"
LAYER = "device"
MOVES = "cell_updates_per_s"


def read(run):
    traces = [r["trace"] for r in run["ranks"]]
    if any(t is None or t["window_s"] <= 0 for t in traces):
        return None
    busy = sum(t["busy_s"] for t in traces)
    window = sum(t["window_s"] for t in traces)
    return 100.0 * (1.0 - busy / window)
