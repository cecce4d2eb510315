"""The stencil kernel's share of its roofline over the traced window:
the least time of the counted launches (``yardstick.window_least_ms``,
bytes and float operations from the shapes at the published peaks) per
launch, over the device time per launch of the kernel's traced events,
averaged over the processes."""

from gsbench import yardstick

UNIT = "%"
LAYER = "kernel (ops/csrc/stencil_chain.cu via ops/cuda_stencil.py)"
MOVES = "cell_updates_per_s"


def read(run):
    cell = run["cell"]
    model = cell.settings.get("model", "grayscott")
    shares = []
    for r in run["ranks"]:
        t = r["trace"]
        counted = sum(r["modes"].values())
        if not t or not t["kernel_events"] or not counted:
            return None
        least = yardstick.window_least_ms(
            r["modes"], steps=r["steps"], blocks=r["blocks"],
            shape=r["local_shape"], members=r["members_per_launch"] or 1,
            flops=yardstick.FLOPS_PER_CELL_STEP[model],
            itemsize=yardstick.ITEMSIZE[cell.settings["precision"]],
            n_fields=2)
        if least is None:
            return None
        per_launch_s = t["kernel_s"] / t["kernel_events"]
        shares.append(100.0 * least / counted / 1e3 / per_launch_s)
    return sum(shares) / len(shares)
