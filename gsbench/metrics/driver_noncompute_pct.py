"""The share of the driver's run wall (``RunStats`` ``wall_s`` of the
window's ``run_once`` calls) spent outside its ``compute`` phase, the
most of any process."""

UNIT = "%"
LAYER = "driver (driver.py)"
MOVES = "cell_updates_per_s"


def read(run):
    out = None
    for r in run["ranks"]:
        wall = r["stats_wall_s"]
        if wall <= 0:
            return None
        share = 100.0 * (wall - r["stats_compute_s"]) / wall
        out = share if out is None else max(out, share)
    return out
