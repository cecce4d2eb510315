"""Host microseconds of the port's own work per kernel launch: the
program's counters ``cuda_stencil.DISPATCH_NS`` (time in its
``gs_launch`` calls less the library calls and the operand ops inside
them, so no wait on a full launch queue) over
``cuda_stencil.TIMED_LAUNCHES``, both zeroed at the window's start and
counted while the run's capture was live.

Read in the process that ran the window: None in a cell of several
processes (this process ran none), where no launch was timed, or where
the timed launches are not the window's launches (the counters did not
cover exactly the window, or the program has no such counters)."""

UNIT = "us"
LAYER = "simulation and dispatch (simulation.py, ops/cuda_stencil.py)"
MOVES = "cell_updates_per_s"


def read(run):
    ranks = run["ranks"]
    if run["cell"].processes > 1 or len(ranks) != 1:
        return None
    # Imported here, not at the top: the readers load before set-up.
    from grayscott_jl_tpu_torch.ops import cuda_stencil

    timed = getattr(cuda_stencil, "TIMED_LAUNCHES", 0)
    if not timed or timed != ranks[0]["launches"]:
        return None
    return cuda_stencil.DISPATCH_NS / 1e3 / timed
