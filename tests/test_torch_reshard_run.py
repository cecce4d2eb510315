"""Elastic resharding end to end through the CLI driver
(``driver.main``, ``python -m grayscott_jl_tpu_torch.launch``): a run
stopped on one mesh resumes on another, and every store serves the
values of the run that never moved.

"Value-identical" is held at the strongest level each store admits, as
the reference's functional test does: the assembled arrays of every
step of the ``.bp`` stores (and their attributes) bitwise — a store
that changed mesh mid-life frames its blocks by whoever wrote each
step — and the ``.vtk`` series, written from the assembled grid by one
writer, byte for byte. The unmoved runs are held against the
reference's live run within atol 1e-5 (the ground rules' tolerance).

* (2,2,2) stopped by an injected preemption, resumed on (1,2,2): the
  ``reshard`` event, the stats echo and the "Resharded restore" line.
* Two supervised processes on (2,2,2) sent SIGTERM through the launcher
  (exit 75), relaunched as two processes on (1,2,2): the journal marker
  resumes them across the shape change, with the ``mesh_agreement`` and
  ``reshard`` records.
* One block stopped, resumed on (2,2,1), for Gray-Scott and the
  one-field heat model.

L=16, 20 steps, plotgap 5, a checkpoint every 10."""

import json
import signal
import subprocess
import sys
import time

import pytest

from grayscott_jl_tpu import driver as ref_driver
from grayscott_jl_tpu_torch import driver, launch
from grayscott_jl_tpu_torch.chaos import trees_equal
from grayscott_jl_tpu_torch.resilience.faults import (EXIT_PREEMPTED,
                                                      PreemptionError)
from test_torch_reshard import (ATOL, assert_stores_equal, attributes, run,
                                store_arrays, write_config)

STEPS = dict(L=16, steps=20, plotgap=5, checkpoint_freq=10, verbose=True)


def _cfg(path, **kw):
    return write_config(path, **{**STEPS, **kw})


def assert_same_stores(base, d, vtk=True):
    """``d``'s stores serve ``base``'s values at every step (attributes
    included); the ``.vtk`` series byte for byte."""
    for store, names in (("gs.bp", ("U", "V")), ("ckpt.bp", ("u", "v"))):
        assert_stores_equal(base / store, d / store, names)
        assert attributes(base / store) == attributes(d / store), store
    if vtk:
        assert not trees_equal(str(base / "gs.vtk"), str(d / "gs.vtk"))


@pytest.fixture(scope="module")
def unmoved(tmp_path_factory):
    """The uninterrupted (2,2,2) run, held against the reference's."""
    mp = pytest.MonkeyPatch()
    try:
        d = tmp_path_factory.mktemp("unmoved")
        run(mp, driver.main, _cfg(d / "c.toml"), 8)
        ref = tmp_path_factory.mktemp("ref")
        run(mp, ref_driver.main, _cfg(ref / "c.toml"), 8)
        assert_stores_equal(ref / "gs.bp", d / "gs.bp", ("U", "V"),
                            atol=ATOL)
    finally:
        mp.undo()
    return d


def test_stopped_on_222_resumes_on_122_value_identical(tmp_path, monkeypatch,
                                                        capsys, unmoved):
    """An injected preemption stops the (2,2,2) run after its step-10
    checkpoint; the restart on four blocks shaped (1,2,2) reads its new
    blocks' boxes from the same store and finishes it."""
    cfg = _cfg(tmp_path / "c.toml")
    with pytest.raises(PreemptionError):
        run(monkeypatch, driver.main, cfg, 8,
            {"GS_FAULTS": "step=15:kind=preempt"})
    assert [s for s, _ in store_arrays(tmp_path / "ckpt.bp", ())] == [10]
    capsys.readouterr()
    resume = _cfg(tmp_path / "r.toml", restart=True)
    sim = run(monkeypatch, driver.main, resume, 4, {
        "GS_TPU_MESH_DIMS": "1,2,2",
        "GS_TPU_STATS": str(tmp_path / "stats.json"),
        "GS_EVENTS": str(tmp_path / "events.jsonl")})
    out = capsys.readouterr().out
    assert tuple(sim.domain.dims) == (1, 2, 2)
    assert "at step 10" in out and "Resharded restore: layout 2x2x2" in out
    assert_same_stores(unmoved, tmp_path)
    rec = json.loads((tmp_path / "stats.json").read_text())["config"]
    assert rec["reshard"]["changed"] is True and rec["mesh_dims"] == [1, 2, 2]
    assert (rec["reshard"]["old"]["mesh_dims"],
            rec["reshard"]["new"]["mesh_dims"]) == ([2, 2, 2], [1, 2, 2])
    evs = [json.loads(x) for x in
           (tmp_path / "events.jsonl").read_text().splitlines()]
    moves = [e for e in evs if e["kind"] == "reshard"
             and "new_mesh" in e["attrs"]]
    assert [e["attrs"]["new_mesh"] for e in moves] == [[1, 2, 2]]
    assert moves[0]["attrs"]["path"] == "ckpt"


def _journal(d, rank):
    path = d / f"gs.bp.faults.jsonl.rank{rank}"
    if not path.exists():
        return []
    return [json.loads(x) for x in path.read_text().splitlines() if x]


def test_sigterm_then_supervised_relaunch_on_a_new_mesh(tmp_path, unmoved):
    """Two supervised processes of the (2,2,2) run, stalled at the
    step-10 boundary (an unwatched ``hang``), get SIGTERM through the
    launcher: they write the boundary, journal ``graceful_shutdown`` and
    exit 75. Relaunched as two processes of two blocks with
    ``GS_TPU_MESH_DIMS=1,2,2``, each resumes from its journal's marker:
    the processes agree on the step and on the mesh (``mesh_agreement``)
    and restore across the shape change (``reshard``). The two-writer
    stores serve the unmoved run's values."""
    from test_torch_multiprocess import TIMEOUT, clean_env

    cfg = _cfg(tmp_path / "c.toml", kernel_language="Plain", verbose=False)
    env = clean_env({"GS_SUPERVISE": "1", "GS_RESTART_BACKOFF_S": "0",
                     "GS_FAULTS": "step=10:kind=hang", "GS_WATCHDOG": "off",
                     "GS_HANG_BOUND_S": "60"})
    proc = subprocess.Popen(
        [sys.executable, "-m", "grayscott_jl_tpu_torch.launch", "2", cfg,
         "4"], cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    t0 = time.monotonic()
    while (time.monotonic() - t0 < TIMEOUT and proc.poll() is None
           and not all(any(e["event"] == "injected" for e in _journal(
               tmp_path, r)) for r in (0, 1))):
        time.sleep(0.05)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == EXIT_PREEMPTED, out[-3000:]
    for r in (0, 1):
        assert _journal(tmp_path, r)[-1]["event"] == "graceful_shutdown"
    relaunch = clean_env({"GS_SUPERVISE": "1", "GS_RESTART_BACKOFF_S": "0",
                          "GS_TPU_MESH_DIMS": "1,2,2"})
    log = tmp_path / "relaunch.log"
    with open(log, "w") as f:
        codes = launch.launch(2, cfg, 2, env=relaunch, cwd=str(tmp_path),
                              timeout=TIMEOUT, stdout=f, stderr=f)
    assert codes == [0, 0], log.read_text()[-3000:]
    for r in (0, 1):
        events = _journal(tmp_path, r)
        kinds = [e["event"] for e in events]
        assert kinds[-4:] == ["rendezvous", "mesh_agreement", "recovery",
                              "reshard"], kinds
        mesh = events[-3]
        assert (mesh["devices"], mesh["dims"], mesh["procs"]) == (
            4, [1, 2, 2], 2)
        assert events[-2]["action"] == "resumed_from_checkpoint_step_10"
        assert events[-2]["after"] == "graceful_shutdown"
        move = events[-1]
        assert (move["old"]["mesh_dims"], move["new"]["mesh_dims"]) == (
            [2, 2, 2], [1, 2, 2])
        assert (move["old"]["process_count"],
                move["new"]["process_count"]) == (2, 2)
    # Two writers frame the .vtk series as per-writer pieces.
    for store, names in (("gs.bp", ("U", "V")), ("ckpt.bp", ("u", "v"))):
        assert_stores_equal(unmoved / store, tmp_path / store, names)


@pytest.mark.parametrize("model", ["grayscott", "heat"])
def test_single_block_resumes_on_221(tmp_path, monkeypatch, model):
    """The grow direction: one block stopped after its step-10
    checkpoint resumes on four blocks shaped (2,2,1), every store equal
    to the single block's uninterrupted run."""
    base, d = tmp_path / "base", tmp_path / "move"
    run(monkeypatch, driver.main, _cfg(base / "c.toml", model=model), 1)
    with pytest.raises(PreemptionError):
        run(monkeypatch, driver.main, _cfg(d / "c.toml", model=model), 1,
            {"GS_FAULTS": "step=15:kind=preempt"})
    sim = run(monkeypatch, driver.main,
              _cfg(d / "r.toml", model=model, restart=True), 4,
              {"GS_TPU_MESH_DIMS": "2,2,1"})
    assert tuple(sim.domain.dims) == (2, 2, 1)
    assert sim.reshard["old"]["mesh_dims"] == [1, 1, 1]
    names = ("U", "V") if model == "grayscott" else ("T",)
    assert_stores_equal(base / "gs.bp", d / "gs.bp", names)
    assert attributes(base / "ckpt.bp") == attributes(d / "ckpt.bp")
    assert not trees_equal(str(base / "gs.vtk"), str(d / "gs.vtk"))



def test_chaos_scenario_5_on_the_cpu(tmp_path, capsys):
    """``python -m grayscott_jl_tpu_torch.chaos --scenarios 5`` (the solo
    half of the reference's chaos scenario 5) holds on the CPU: the
    SIGTERMed (2,2,2) run relaunched on (1,2,2) through the journal's
    marker, a ``reshard`` event from the restore, every store serving
    the uninterrupted run's values."""
    from grayscott_jl_tpu_torch import chaos

    assert 5 in chaos.SCENARIOS
    rc = chaos.main(["--backend", "CPU", "--L", "16", "--steps", "40",
                     "--scenarios", "5", "--seed", "1",
                     "--workdir", str(tmp_path)])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, result
    assert (result["scenario"], result["ok"], result["path"]) == (
        5, True, "ckpt")
