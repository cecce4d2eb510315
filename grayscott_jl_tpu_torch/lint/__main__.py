"""gslint for the port — its contracts, statically enforced.

    python -m grayscott_jl_tpu_torch.lint [paths...]          # default: the port
    python -m grayscott_jl_tpu_torch.lint --json [paths...]   # stable tooling output
    python -m grayscott_jl_tpu_torch.lint --list              # pass catalog
    python -m grayscott_jl_tpu_torch.lint --select env-knobs,layering [paths...]

Runs without torch or JAX (stdlib and this package).  Exit code: 0 when
no error-severity findings remain after per-line suppressions and the
(always-empty, committed) baseline at ``gslint-baseline.json``; 1
otherwise.  Warnings print but do not fail.  The options, the output
and the ``--json`` schema (``gslint/1``) are those of the reference's
``scripts/gslint.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from . import PASSES, findings_to_json, load_baseline, run_lint

#: The checkout this package lives in.
REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

#: Default lint surface: the port's package and its card smoke run.
DEFAULT_TARGETS = ("grayscott_jl_tpu_torch", "chip_smoke.py")

BASELINE = os.path.join(REPO, "gslint-baseline.json")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="gslint",
        description="static analysis of grayscott_jl_tpu_torch's contracts",
    )
    ap.add_argument(
        "paths",
        nargs="*",
        default=None,
        help=f"files/dirs to lint (default: {' '.join(DEFAULT_TARGETS)})",
    )
    ap.add_argument(
        "--json",
        action="store_true",
        dest="as_json",
        help="emit the stable gslint/1 JSON document to stdout",
    )
    ap.add_argument(
        "--list", action="store_true", help="list available passes and exit"
    )
    ap.add_argument(
        "--select",
        default="",
        help="comma-separated pass ids to run (default: all)",
    )
    ap.add_argument(
        "--baseline",
        default=BASELINE,
        help="baseline file of finding keys to ignore "
        "(committed empty by contract)",
    )
    ap.add_argument(
        "--root",
        default=REPO,
        help="repo root paths are resolved against (default: the "
        "checkout containing this package)",
    )
    args = ap.parse_args(argv)

    if args.list:
        for pass_id in sorted(PASSES):
            doc = (
                (sys.modules[PASSES[pass_id].__module__].__doc__ or "")
                .strip()
                .splitlines()
            )
            print(f"{pass_id:<14} {doc[0] if doc else ''}")
        return 0

    targets = args.paths or list(DEFAULT_TARGETS)
    select = [s.strip() for s in args.select.split(",") if s.strip()]
    baseline: List[str] = []
    if args.baseline and os.path.isfile(args.baseline):
        baseline = load_baseline(args.baseline)

    findings = run_lint(
        args.root, targets, select=select or None, baseline=baseline
    )
    errors = [f for f in findings if f.severity == "error"]
    if args.as_json:
        print(
            json.dumps(
                findings_to_json(findings, args.root, targets),
                indent=2,
                sort_keys=True,
            )
        )
    else:
        for f in findings:
            print(f.render())
        n_warn = len(findings) - len(errors)
        print(
            f"gslint: {len(errors)} error(s), {n_warn} warning(s) "
            f"over {len(targets)} target(s)"
        )
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
