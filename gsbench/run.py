"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m gsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. A cell on one card runs in this process; a
cell of several processes starts one process per card with the
program's launch variables (those of ``grayscott_jl_tpu_torch/launch.py``)
and waits for them. The last line of standard output is the result; the
compared numbers and their limits are the last lines of standard error.
Exits 2, printing no result, without the cards the cell asks for.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

T_START_EPOCH = time.time()

from . import harness  # noqa: E402

#: A process of a cell of several processes gets this long.
CHILD_TIMEOUT_S = 330
#: The program's own lower-precision path: float32 fields with bfloat16
#: mid windows, at chain depth 2.
MID_BF16 = {"GS_MID_BF16": "1", "GS_FUSE": "2"}


def parse(argv):
    p = argparse.ArgumentParser(prog="gsbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # Internal: one process of a cell of several (the launcher's child);
    # and the calibration's seeds, control, and the program's own
    # lower-precision path, whose knobs (MID_BF16) every process of the
    # run sets after its scrub of the environment (gsbench.calibrate).
    p.add_argument("--rank-workdir", default=None, help=argparse.SUPPRESS)
    p.add_argument("--seeds", default=None, help=argparse.SUPPRESS)
    p.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--mid-bf16", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def seeds_of(args):
    return ([int(s) for s in args.seeds.split(",")] if args.seeds
            else [args.seed])


def run_ranks(cell, args, workdir, marks=None):
    """This process's rank of the cell, once per seed: one reading dict
    per seed. The first seed's ``setup_marks`` hold the set-up's phase
    edges from ``marks`` (this process's, by default) on."""
    marks = [["start", T_START_EPOCH]] if marks is None else marks
    rank = harness.Rank(cell, workdir, marks)
    out = []
    for s in seeds_of(args):
        out.append(rank.run(s, args.seconds, bool(args.trace),
                            control=args.control))
        del marks[1:]
    return out


def run_cell(cell, args, argv, workdir, root, marks=None, procs=None):
    """Every seed's readings, each a list by rank (``procs``: the cell's
    processes, already started)."""
    if cell.processes > 1:
        by_rank = wait(cell, procs or start(cell, argv, workdir, root),
                       workdir)
        return [list(per_seed) for per_seed in zip(*by_rank)]
    return [[r] for r in run_ranks(cell, args, workdir, marks)]


def launch_env(rank: int, nprocs: int, port: int, root: str) -> dict:
    """The environment of process ``rank`` of ``nprocs``: the program's
    launch variables, as its ``launch.py`` sets them (set here, so that
    this process starts its children before it imports torch)."""
    env = dict(os.environ)
    env.pop("GS_TPU_DISTRIBUTED", None)
    env.update({
        "GS_TPU_COORDINATOR": f"127.0.0.1:{port}",
        "GS_TPU_NUM_PROCESSES": str(nprocs),
        "GS_TPU_PROCESS_ID": str(rank),
        "LOCAL_RANK": str(rank),
        "LOCAL_WORLD_SIZE": str(nprocs),
        "PYTHONPATH": root + (os.pathsep + env["PYTHONPATH"]
                              if env.get("PYTHONPATH") else ""),
    })
    return env


def start(cell, argv, workdir, root):
    """Start the cell's processes, one per card."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    try:
        for r in range(cell.processes):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "gsbench.run", *argv,
                 "--rank-workdir", workdir],
                cwd=root, env=launch_env(r, cell.processes, port, root),
                stdout=sys.stderr, stderr=sys.stderr))
    except BaseException:
        stop(procs)
        raise
    return procs


def stop(procs):
    """End every process still running and wait for each."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def wait(cell, procs, workdir):
    """Wait for the cell's processes (a failed one ends the rest); their
    readings by rank."""
    try:
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        stop(procs)
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"the cell's processes exited {codes}")
    out = []
    for r in range(cell.processes):
        with open(os.path.join(workdir, f"rank{r}.json"),
                  encoding="utf-8") as f:
            out.append(json.load(f))
    return out


def compose(cell, ranks, trace: bool, readers):
    """The result line's object from every process's readings of one
    run, and the compared numbers with their limits."""
    r0 = ranks[0]
    steps = r0["steps"]
    elapsed = max(r["elapsed_s"] for r in ranks)
    checks = r0["checks"]
    limits = harness.limits_of(cell)
    forbidden = sorted({m for r in ranks for m in r["forbidden"]})
    correct = harness.judge(checks, cell) and not forbidden
    device = {"platform": "gpu", "kind": r0["device_kind"],
              "count": cell.chips,
              "memory_peak_bytes": max(r["memory_peak_bytes"]
                                       for r in ranks)}
    metrics = {}
    breakdown = None
    if trace:
        traces = [r["trace"] for r in ranks]
        if all(t is not None for t in traces):
            device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
            device["window_s"] = (sum(t["window_s"] for t in traces)
                                  / len(traces))
            breakdown = {"device_ops": traces[0]["device_ops"],
                         "idle_gaps": traces[0]["idle_gaps"]}
        run = {"cell": cell, "steps": steps, "ranks": ranks}
        for rd in readers:
            if rd.workloads is not None and cell.name not in rd.workloads:
                continue
            value = rd.read(run)
            if value is not None:
                metrics[rd.name] = {"value": value, "unit": rd.unit}
    else:
        cells = cell.L**3 * cell.members * steps
        metrics["cell_updates_per_s"] = {"value": cells / elapsed / 1e9,
                                         "unit": "Gcell/s"}
        metrics["setup_s"] = {"value": r0["t0_epoch"] - T_START_EPOCH,
                              "unit": "s"}
    compared = {name: {"value": checks.get(name), "limit": lim}
                for name, lim in limits.items()}
    line = {"correct": correct, "attempted": steps,
            "failed": 0 if correct else steps, "metrics": metrics,
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = compared
    return line, forbidden


def main(argv=None, *, root=harness.ROOT, require_cards=True) -> int:
    """The run; ``require_cards=False`` (tests) skips the look for the
    cards, for cells whose configuration runs on the CPU."""
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    harness.scrub_env()
    if args.mid_bf16:
        os.environ.update(MID_BF16)
    cell = harness.load_cell(args.workload, root)
    if args.rank_workdir is not None:
        from grayscott_jl_tpu_torch import launch

        launch.die_with_parent()
        readings = run_ranks(cell, args, args.rank_workdir,
                             [["process_start", T_START_EPOCH]])
        rank = int(os.environ["GS_TPU_PROCESS_ID"])
        with open(os.path.join(args.rank_workdir, f"rank{rank}.json"), "w",
                  encoding="utf-8") as f:
            json.dump(readings, f)
        return 0

    marks = [["start", T_START_EPOCH]]
    readers = harness.load_readers(root)
    workdir = tempfile.mkdtemp(prefix="gsbench-")
    procs = None
    try:
        if cell.processes > 1:
            # The processes import and start while this one looks for
            # the cards.
            procs = start(cell, argv, workdir, root)
            harness.mark_setup(marks, "processes_started")
        import torch

        if procs is None:
            harness.mark_setup(marks, "import_torch")
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if require_cards and (have < cell.chips or not cell.on_card):
            if procs:
                stop(procs)
            print(f"gsbench: {args.workload} needs {cell.chips} CUDA "
                  f"card(s), {have} visible", file=sys.stderr)
            return 2
        ranks = run_cell(cell, args, argv, workdir, root, marks, procs)[0]
        line, forbidden = compose(cell, ranks, bool(args.trace), readers)
    finally:
        if procs:
            stop(procs)
        shutil.rmtree(workdir, ignore_errors=True)
    forbidden = sorted(set(forbidden) | set(harness.forbidden_modules()))
    if forbidden:
        print(f"gsbench: modules loaded that a run may not hold: "
              f"{', '.join(forbidden)}", file=sys.stderr)
        return 1
    edges = (marks if cell.processes > 1 else []) + ranks[0]["setup_marks"]
    print("gsbench setup_s by phase: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(edges, edges[1:])),
        file=sys.stderr)
    print("gsbench peaks (bytes, the fullest process): window card "
          f"{line['device']['memory_peak_bytes']}, check card "
          f"{max(r['check_peak_bytes'] for r in ranks)}, host "
          f"{max(r['host_peak_bytes'] for r in ranks)}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"gsbench check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
