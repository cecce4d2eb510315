"""The reader of ``dispatch_us_per_launch`` on the program's counters:
synthetic readings of ``cuda_stencil.timings()`` from one process and
from several, and a traced run of a CPU cell, where the plain path
counts no launch."""

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


def _run(launches, processes=1, timings=None):
    """A run's readings: ``launches`` window launches in each of
    ``processes`` processes, each with the timed counters ``timings``
    (one dict, or one a process)."""
    if not isinstance(timings, list):
        timings = [timings] * processes
    cell = types.SimpleNamespace(processes=processes)
    ranks = [{"launches": launches, "timings": t} for t in timings]
    return {"cell": cell, "steps": launches, "ranks": ranks}


def _timed(launches, us):
    return {"launches": launches, "dispatch_ns": int(us * 1e3 * launches),
            "call_ns": 0, "ops_ns": 0, "sync_ns": 0, "exchange_ns": 0}


@pytest.mark.parametrize("timed,launches,processes,want", [
    ([(4000, 150.0)], 4000, 1, 150.0),   # the window's launches, all timed
    ([(3999, 150.0)], 4000, 1, None),    # the counters missed a launch
    ([(4001, 150.0)], 4000, 1, None),    # ... or counted one outside
    ([(0, 0.0)], 0, 1, None),            # no launch (the plain path)
    ([(0, 0.0)], 4000, 1, None),         # nothing armed
    ([(4000, 150.0), (4000, 151.5), (4000, 162.25), (4000, 149.0)], 4000,
     4, 162.25),                         # children: the most of any
    ([(4000, 150.0), (3999, 150.0), (4000, 150.0), (4000, 150.0)], 4000,
     4, None),                           # one child's counters missed one
], ids=["matching", "short", "over", "zero", "unarmed", "children",
        "child-short"])
def test_reader_on_counter_states(timed, launches, processes, want):
    got = _reader()(_run(launches, processes,
                         [_timed(n, us) for n, us in timed]))
    assert got == (pytest.approx(want) if want is not None else None)


def test_reader_on_a_program_without_the_counters():
    assert _reader()(_run(4000)) is None
    assert _reader()(_run(4000, 4)) is None


def test_reader_reads_what_the_counters_say(monkeypatch):
    """One process's value is the module's counters over its launches,
    as read in the process that ran the window."""
    monkeypatch.setattr(cuda_stencil, "TIMED_LAUNCHES", 4000)
    monkeypatch.setattr(cuda_stencil, "DISPATCH_NS", 150_000 * 4000)
    got = _reader()(_run(4000, 1, cuda_stencil.timings()))
    assert got == (cuda_stencil.DISPATCH_NS / 1e3
                   / cuda_stencil.TIMED_LAUNCHES)


def test_cpu_cell_traced_line_leaves_it_out(tmp_path, env):
    """The CPU cell's plain path launches no kernel: the traced line has
    no ``dispatch_us_per_launch``, and the run is correct."""
    tree = support.make_tree(str(tmp_path))
    rc, line = support.run_line(tree, "cpu.gs", trace=1)
    assert rc == 0 and line["correct"] is True
    assert "dispatch_us_per_launch" not in line["metrics"]
    assert "launches_per_step" in line["metrics"]
    assert _reader()(_run(cuda_stencil.LAUNCHES, 1,
                          cuda_stencil.timings())) is None
