"""The check by block on the CPU: each process judges its own blocks
from a box around each, its margin sent by the processes that hold it.
A cell of four ``gloo`` processes on a (2, 2, 1) mesh is correct; a
fault in one block, on a face, an edge or a corner of it, and a margin
from the wrong process are caught; the one-process cells read what the
harness that gathered the whole field read; the program's mid-bfloat16
knobs reach a cell's child processes; and the readers of several
processes' readings."""

from __future__ import annotations

import contextlib
import io
import json
import os
import tempfile
import types

import pytest

from gsbench import calibrate, harness, run
from gsbench.tests import support


@pytest.fixture
def env():
    """Restore the environment the run scrubs."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return support.make_tree(str(tmp_path_factory.mktemp("tree")))


# ------------------------------------------------------------- the plan


def test_margin_plan_fills_each_grown_block_once():
    """On a (2, 2, 1) mesh of 8 x 8 x 16 blocks, each block grown by 2
    is filled by its own block and by its neighbours' faces, edge and
    corner, every cell once; no grown box is the whole grid."""
    L, margin = 16, 2
    boxes = [(r, 0, (8 * (r // 2), 8 * (r % 2), 0), (8, 8, 16))
             for r in range(4)]
    plan = harness.margin_plan(boxes, margin, L)
    for dst, _, offs, shape in boxes:
        go, gn = harness.grow(offs, shape, margin, L)
        assert gn == (10, 10, 16)
        parts = [p for p in plan if p[2] == dst]
        assert sorted(p[0] for p in parts) == [0, 1, 2, 3]
        cells = 0
        seen = set()
        for src, _, _, _, sbox, dbox in parts:
            n = [b.stop - b.start for b in dbox[1:]]
            assert n == [b.stop - b.start for b in sbox[1:]]
            cells += n[0] * n[1] * n[2]
            seen |= {(x, y) for x in range(dbox[1].start, dbox[1].stop)
                     for y in range(dbox[2].start, dbox[2].stop)}
        assert cells == gn[0] * gn[1] * gn[2] and len(seen) == 100


# ----------------------------------------------------- four processes


def test_cpu_cell_of_four_processes_is_correct(tree, env):
    rc, line = support.run_line(tree, "cpu.procs")
    assert rc == 0 and line["correct"] is True
    assert all(c["value"] == 0.0 for c in line["checks"].values())


@pytest.mark.parametrize("patch", ["fault:face", "fault:edge",
                                   "fault:corner", "wrong-neighbour"])
def test_fault_in_one_process_is_caught(tree, env, monkeypatch, patch):
    support.patch_children(monkeypatch, patch)
    rc, line = support.run_line(tree, "cpu.procs")
    assert rc == 0 and line["correct"] is False
    end = line["checks"]["end_max_abs"]
    assert end["value"] > end["limit"]


# ------------------------------------------------------- one process

#: The compared numbers of the harness that gathered the whole field
#: onto one process, on the same runs (seeds, a one-step long call,
#: with the control; ``altered``: 0.05 added to one cell after each
#: ``iterate``): (start, its control, end, its control) a seed.
PARENT = {
    ("cpu.gs", None): [
        (0.0, 0.0098114013671875, 0.0, 0.007996320724487305),
        (0.0, 0.009037971496582031, 0.0, 0.008984804153442383)],
    ("cpu.gs", "altered"): [
        (0.04999999701976776, 0.0098114013671875, 0.050000011920928955,
         0.007996320724487305),
        (0.04999999701976776, 0.009037971496582031, 0.04999999701976776,
         0.008984804153442383)],
    ("cpu.ens", None): [
        (0.0, 0.008990287780761719, 0.0, 0.008544445037841797),
        (0.0, 0.009232401847839355, 0.0, 0.008192896842956543)],
    ("cpu.ens", "altered"): [
        (0.050000011920928955, 0.008990287780761719, 0.050000011920928955,
         0.008544445037841797),
        (0.050000011920928955, 0.009232401847839355, 0.050000011920928955,
         0.008192896842956543)],
    ("cpu.mesh", None): [
        (0.0, 0.0098114013671875, 0.0, 0.007996320724487305),
        (0.0, 0.009037971496582031, 0.0, 0.008984804153442383)],
    ("cpu.mesh", "altered"): [
        (0.04999999701976776, 0.0098114013671875, 0.050000011920928955,
         0.007996320724487305),
        (0.050000011920928955, 0.009037971496582031, 0.04999999701976776,
         0.008984804153442383)],
}
PARENT_SEEDS = "2147483659,3000000019"


@pytest.mark.parametrize("cell,fault", list(PARENT))
def test_one_process_cells_read_what_the_gathering_harness_read(
        tree, env, monkeypatch, cell, fault):
    from grayscott_jl_tpu_torch.simulation import Simulation

    if cell == "cpu.mesh":
        support.mesh_of_four(monkeypatch)
    if fault:
        orig = Simulation.iterate

        def iterate(self, nsteps=1):
            orig(self, nsteps)
            u = self.blocks[0][0]
            u.view(-1)[u.numel() // 3] += 0.05

        monkeypatch.setattr(Simulation, "iterate", iterate)
    monkeypatch.setenv("PYTHONPATH", harness.ROOT)
    # A long call of one step (the least whole round), as the parent's
    # runs had: the compared numbers do not hang on the host's pace.
    argv = ["--workload", cell, "--seed", "1", "--seconds", "1e-6",
            "--trace", "0", "--seeds", PARENT_SEEDS, "--control"]
    with tempfile.TemporaryDirectory() as workdir:
        got = run.run_cell(harness.load_cell(cell, tree), run.parse(argv),
                           argv, workdir, tree)
    for (ranks,), want in zip(got, PARENT[(cell, fault)]):
        c = ranks["checks"]
        assert (c["start_max_abs"], c["start_max_abs_control"],
                c["end_max_abs"], c["end_max_abs_control"]) == want
        assert c["step_count_gap"] == c["launch_mix_gap"] == 0.0


# ---------------------------------------------------------- calibrate


@pytest.mark.parametrize("mid_bf16", [False, True])
def test_calibrate_mid_bf16_reaches_the_children(tree, env, monkeypatch,
                                                 mid_bf16):
    """The children of a cell of several processes scrub the program's
    knobs, then set the run's: their launches take the ``f32_mid_bf16``
    entry at depth 2 under ``--mid-bf16``, and not without it."""
    support.patch_children(monkeypatch, "entries")
    monkeypatch.setenv("PYTHONPATH", harness.ROOT)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = calibrate.main(["--workload", "cpu.procs", "--seeds",
                             "2147483659", "--seconds", "0.3"]
                            + (["--mid-bf16"] if mid_bf16 else []),
                            root=tree)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[0])
    entries = {tuple(e) for e in line["entries"]}
    if mid_bf16:
        assert entries == {("chain", "f32_mid_bf16", 2)}
        assert line["fuse"] == 2
    else:
        assert entries and all(e[1] == "f32" for e in entries)


# ------------------------------------------------------------ readers


def _reader(name):
    (rd,) = [r for r in harness.load_readers() if r.name == name]
    return rd


def _trace(*ops):
    return {"window_s": 10.0, "busy_s": 9.0, "kernel_events": 1,
            "kernel_s": 8.0, "device_ops": [list(o) for o in ops],
            "idle_gaps": []}


@pytest.mark.parametrize("traces,want", [
    ([_trace(("stencil_chain_kernel<float>", 8.0),
             ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
              0.5)),
      _trace(("stencil_chain_kernel<float>", 8.1),
             ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
              0.7), ("ncclKernel_AllGather", 0.1)),
      _trace(("ncclDevKernel_SendRecv(x)", 0.2))], 2.0),
    ([_trace(("stencil_chain_kernel<float>", 8.0))] * 4, None),
    ([_trace(("ncclDevKernel_SendRecv(x)", 0.5)), None], None),
], ids=["most-of-any-card", "no-nccl", "missing-trace"])
def test_exchange_reader(traces, want):
    rd = _reader("exchange_ms_per_step")
    assert rd.workloads == ["gs-f32.l1792-4card"] and rd.unit == "ms"
    run_ = {"cell": types.SimpleNamespace(processes=len(traces)),
            "steps": 400, "ranks": [{"trace": t} for t in traces]}
    got = rd.read(run_)
    assert got == (pytest.approx(want) if want is not None else None)


def test_every_metric_without_a_list_reads_on_a_mesh_of_processes():
    """The readers with no ``workloads`` list read a value from the
    readings of four processes on the (2, 2, 1) mesh's face kernel."""
    cell = harness.load_cell("gs-f32.l1792-4card")
    rank = {"launches": 600, "steps": 600, "blocks": 1,
            "modes": {"faces6": 600}, "members_per_launch": None,
            "local_shape": [896, 896, 1792], "stats_wall_s": 10.0,
            "stats_compute_s": 9.99,
            "timings": {"launches": 600, "dispatch_ns": 90_000_000,
                        "call_ns": 0, "ops_ns": 0, "sync_ns": 0,
                        "exchange_ns": 0},
            "trace": _trace(("stencil_chain_kernel<float, float, 1, 0>",
                             9.0), ("ncclDevKernel_SendRecv(x)", 1.2))}
    rank["trace"]["kernel_events"], rank["trace"]["kernel_s"] = 600, 9.0
    run_ = {"cell": cell, "steps": 600, "ranks": [dict(rank)] * 4}
    for rd in harness.load_readers():
        if rd.workloads is None or cell.name in rd.workloads:
            assert rd.read(run_) is not None, rd.name
