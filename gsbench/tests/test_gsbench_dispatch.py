"""The reader of ``dispatch_us_per_launch`` on the program's counters:
synthetic states of ``cuda_stencil``'s timed counters, and a traced run
of a CPU cell, where the plain path counts no launch."""

from __future__ import annotations

import os
import types

import pytest

from gsbench import harness
from gsbench.tests import support
from grayscott_jl_tpu_torch.ops import cuda_stencil


@pytest.fixture
def env():
    """Restore the environment the run scrubs."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


def _reader():
    (rd,) = [r for r in harness.load_readers()
             if r.name == "dispatch_us_per_launch"]
    assert rd.workloads is None and rd.unit == "us"
    return rd.read


def _run(launches, processes=1):
    cell = types.SimpleNamespace(processes=processes)
    ranks = [{"launches": launches} for _ in range(processes)]
    return {"cell": cell, "steps": launches, "ranks": ranks}


@pytest.mark.parametrize("timed,launches,processes,want", [
    (4000, 4000, 1, 150.0),   # the window's launches, all timed
    (3999, 4000, 1, None),    # the counters missed a launch
    (4001, 4000, 1, None),    # ... or counted one outside the window
    (0, 0, 1, None),          # no launch (the plain path)
    (0, 4000, 1, None),       # nothing armed
    (4000, 4000, 4, None),    # a cell of child processes
], ids=["matching", "short", "over", "zero", "unarmed", "children"])
def test_reader_on_counter_states(monkeypatch, timed, launches, processes,
                                  want):
    monkeypatch.setattr(cuda_stencil, "TIMED_LAUNCHES", timed)
    monkeypatch.setattr(cuda_stencil, "DISPATCH_NS", 150_000 * timed)
    got = _reader()(_run(launches, processes))
    assert got == (pytest.approx(want) if want is not None else None)


def test_reader_on_a_program_without_the_counters(monkeypatch):
    monkeypatch.delattr(cuda_stencil, "TIMED_LAUNCHES")
    assert _reader()(_run(4000)) is None


def test_cpu_cell_traced_line_leaves_it_out(tmp_path, env):
    """The CPU cell's plain path launches no kernel: the traced line has
    no ``dispatch_us_per_launch``, and the run is correct."""
    tree = support.make_tree(str(tmp_path))
    rc, line = support.run_line(tree, "cpu.gs", trace=1)
    assert rc == 0 and line["correct"] is True
    assert "dispatch_us_per_launch" not in line["metrics"]
    assert "launches_per_step" in line["metrics"]
    assert _reader()(_run(cuda_stencil.LAUNCHES)) is None
