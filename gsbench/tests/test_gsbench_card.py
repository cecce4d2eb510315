"""The check at each cell's own size, on the card.

    python -m pytest -m cuda gsbench/tests/test_gsbench_card.py

For each cell whose cards are visible, ``gsbench.calibrate`` runs the
cell on three seeds with short windows: the program must read within
every limit, and each control above one of them: the reference in
bfloat16 in the program's place, and the program's own bfloat16 mid
windows at chain depth 2. Skips without the cards.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from gsbench import harness

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
SEEDS = "2147483659,2147483693,3000000019"


def calibrate(name, *extra):
    """``gsbench.calibrate`` on cell ``name`` over :data:`SEEDS`: its
    summary line. Skips without the cell's cards."""
    import torch

    cell = harness.load_cell(name)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        pytest.skip(f"needs {cell.chips} CUDA card(s) (run: pytest -m cuda "
                    "on the H100)")
    p = subprocess.run(
        [sys.executable, "-m", "gsbench.calibrate", "--workload", name,
         "--seeds", SEEDS, "--seconds", "1", *extra],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    summary = json.loads(p.stdout.strip().splitlines()[-1])
    assert summary["seeds"] == 3
    return cell, summary


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_within_limits_and_control_outside(name):
    cell, summary = calibrate(name)
    assert summary["all_correct"]
    limits = harness.limits_of(cell)
    for n, v in summary["max"].items():
        assert v <= limits[n], (n, v)
    assert any(v > limits[n[:-len("_control")]]
               for n, v in summary["min_control"].items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_mid_bf16_path_fails_the_limits(name):
    """The program's own lower-precision path, in float32 fields, reads
    above a limit on every seed."""
    cell, summary = calibrate(name, "--mid-bf16")
    limits = harness.limits_of(cell)
    assert not summary["all_correct"]
    assert any(v > limits[n] for n, v in summary["min"].items())
