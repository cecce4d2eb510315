"""Readings to set a cell's limits from: the program's and the control's.

    python3 -m gsbench.calibrate --workload <cell> --seeds 1,2,3 --seconds 3 \\
        [--mid-bf16] [--out chiprun_out/calib.jsonl]

Runs the cell once per seed in one set of processes (set-up is paid
once per process, not per seed), each run as the benchmark runs it, and
reads beside each compared number the control's: the reference computed
in bfloat16, the precision below the configuration's float32, put in the
program's place. Prints one JSON line per seed and a summary line: the
largest and the smallest reading of the program and the smallest of the
control, per number.

``--mid-bf16`` runs the program's own lower-precision path in its place:
float32 fields with bfloat16 mid windows (``GS_MID_BF16=1``) at chain
depth 2 (``GS_FUSE=2``), the program's second control. Cells of one
process only (each process of a cell of several scrubs the program's
knobs).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

from . import harness, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gsbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--mid-bf16", action="store_true")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    harness.scrub_env()
    cell = harness.load_cell(a.workload)
    if a.mid_bf16:
        if cell.processes > 1:
            p.error("--mid-bf16 takes a cell of one process")
        os.environ.update(GS_MID_BF16="1", GS_FUSE="2")
    seeds = a.seeds.split(",")
    argv_run = ["--workload", a.workload, "--seed", seeds[0], "--seconds",
                str(a.seconds), "--trace", "0", "--seeds", a.seeds,
                "--control"]
    args = run.parse(argv_run)
    workdir = tempfile.mkdtemp(prefix="gsbench-cal-")
    try:
        per_seed = run.run_cell(cell, args, argv_run, workdir, harness.ROOT)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    lines = []
    for ranks in per_seed:
        r0 = ranks[0]
        cells = cell.L**3 * cell.members * r0["steps"]
        lines.append({
            "workload": a.workload, "mid_bf16": a.mid_bf16,
            "seed": r0["seed"],
            "checks": r0["checks"],
            "correct": harness.judge(r0["checks"], cell),
            "cell_updates_per_s": cells / max(r["elapsed_s"] for r in ranks)
            / 1e9,
            "steps": r0["steps"], "mesh_dims": r0["mesh_dims"],
            "fuse": r0["fuse"], "device_kind": r0["device_kind"],
            "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks)})
    names = sorted(lines[0]["checks"])
    summary = {"workload": a.workload, "mid_bf16": a.mid_bf16,
               "seeds": len(lines),
               "max": {n: max(ln["checks"][n] for ln in lines)
                       for n in names if not n.endswith("_control")},
               "min": {n: min(ln["checks"][n] for ln in lines)
                       for n in names if not n.endswith("_control")},
               "min_control": {n: min(ln["checks"][n] for ln in lines)
                               for n in names if n.endswith("_control")},
               "all_correct": all(ln["correct"] for ln in lines)}
    text = "\n".join(json.dumps(x) for x in lines + [summary])
    print(text)
    if a.out:
        with open(a.out, "a", encoding="utf-8") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
