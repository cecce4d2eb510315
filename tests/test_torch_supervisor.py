"""Supervised runs end to end on the CPU (grayscott_jl_tpu_torch/
resilience/supervisor.py through driver.main), the counterparts of
tests/functional/test_supervisor.py and tests/functional/test_sdc_run.py:
a fault changes when a run computes, never what it writes.

For each fault kind — ``io_error``, ``preempt``, ``nan`` under
``health_policy = "rollback"``, ``drift`` under ``GS_DRIFT_POLICY=
rollback``, ``kernel`` (fatal, then a relaunch from the checkpoint),
``hang`` (the watchdog, a 1 s step-round deadline), ``ckpt_corrupt``
(replica failover), ``bitflip`` (``GS_CKPT_VERIFY=full``) and ``sdc``
(``GS_SDC_CHECK=spot``) — a supervised run on one block and on the
(2,2,2) mesh writes stores byte-identical to the uninterrupted run's
(the primary checkpoint store after ``ckpt_corrupt`` differs by the
flipped byte; its replica is compared). The journals are held against
the reference's in tests/test_torch_supervisor_journal.py. Then: the
supervisor gives up past ``max_restarts``, ``abort`` is fatal, SIGTERM
exits 75 and a wedge the watchdog cannot interrupt exits 76, a
supervised relaunch resuming from either marker, and two processes on
gloo restart together and match one process."""

import filecmp
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from grayscott_jl_tpu_torch import driver
from grayscott_jl_tpu_torch.obs import events, metrics, trace
from grayscott_jl_tpu_torch.resilience.health import HealthError
from grayscott_jl_tpu_torch.resilience.faults import InjectedKernelError

REPO = Path(__file__).resolve().parents[1]

#: Every variable these runs set; cleared before each.
_VARS = ("GS_SUPERVISE", "GS_MAX_RESTARTS", "GS_RESTART_BACKOFF_S",
         "GS_FAULTS", "GS_FAULT_JOURNAL", "GS_HEALTH_POLICY",
         "GS_DRIFT_POLICY", "GS_DRIFT_LIMIT", "GS_NUMERICS", "GS_WATCHDOG",
         "GS_WATCHDOG_STEP_ROUND_S", "GS_CKPT_REPLICAS", "GS_CKPT_VERIFY",
         "GS_ASYNC_IO_DEPTH", "GS_SDC_CHECK", "GS_SDC_EVERY",
         "GS_DEVICE_BLOCKLIST", "GS_FAULT_DEVICE", "GS_TPU_STATS",
         "GS_EVENTS", "GS_METRICS", "GS_TRACE", "GS_HALO_DEPTH",
         "GS_TPU_MESH_DIMS", "GS_FUSE", "GS_COMM_OVERLAP", "GS_SEED")

SUPERVISED = {"GS_SUPERVISE": "1", "GS_MAX_RESTARTS": "5",
              "GS_RESTART_BACKOFF_S": "0"}

#: kind -> (fault plan, extra environment, config overrides). The drift
#: case runs L=32 for 30 steps, where no statistic drifts past the
#: limit by itself (the reference's drift case, whose L=32 this is).
CASES = {
    "io_error": ("step=25:kind=io_error", {}, {}),
    "preempt": ("step=25:kind=preempt", {}, {}),
    "nan": ("step=25:kind=nan", {"GS_HEALTH_POLICY": "rollback"}, {}),
    "drift": ("step=15:kind=drift",
              {"GS_DRIFT_POLICY": "rollback", "GS_NUMERICS": "boundary",
               "GS_DRIFT_LIMIT": "0.7"}, {"L": 32, "steps": 30}),
    "kernel": ("step=25:kind=kernel", {}, {}),
    "hang": ("step=25:kind=hang", {"GS_WATCHDOG_STEP_ROUND_S": "1"}, {}),
    "ckpt_corrupt": ("step=21:kind=ckpt_corrupt;step=31:kind=preempt",
                     {"GS_CKPT_REPLICAS": "2", "GS_CKPT_VERIFY": "full",
                      "GS_ASYNC_IO_DEPTH": "0"}, {}),
    "bitflip": ("step=25:kind=bitflip", {"GS_CKPT_VERIFY": "full"}, {}),
    "sdc": ("step=25:kind=sdc", {"GS_SDC_CHECK": "spot"}, {}),
}

#: The uninterrupted run's environment for a case: what changes the
#: stores' bytes (the integrity sidecars, the replica) and nothing
#: else, so that screening, the numerics probes and the policies are
#: held to leaving the stores as they were.
BASE_ENV = {"ckpt_corrupt": ("GS_CKPT_REPLICAS", "GS_CKPT_VERIFY",
                             "GS_ASYNC_IO_DEPTH"),
            "bitflip": ("GS_CKPT_VERIFY",)}


def write_config(d: Path, **kw) -> str:
    d.mkdir(parents=True, exist_ok=True)
    base = dict(L=16, Du=0.2, Dv=0.1, F=0.02, k=0.048, dt=1.0, plotgap=10,
                steps=40, noise=0.1, checkpoint=True, checkpoint_freq=20,
                output=str(d / "gs.bp"), checkpoint_output=str(d / "ckpt.bp"),
                precision="Float32", backend="CPU", kernel_language="Pallas")
    base.update(kw)
    lines = []
    for key, value in base.items():
        if isinstance(value, bool):
            lines.append(f"{key} = {'true' if value else 'false'}")
        elif isinstance(value, str):
            lines.append(f'{key} = "{value}"')
        else:
            lines.append(f"{key} = {value}")
    (d / "config.toml").write_text("\n".join(lines) + "\n")
    return str(d / "config.toml")


def _reset_sinks():
    events.reset_events()
    metrics.reset_metrics()
    trace.reset_tracer()


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    # quarantine_device writes GS_DEVICE_BLOCKLIST itself: save and
    # restore it around every test.
    saved = os.environ.get("GS_DEVICE_BLOCKLIST")
    for var in _VARS:
        monkeypatch.delenv(var, raising=False)
    _reset_sinks()
    yield
    _reset_sinks()
    os.environ.pop("GS_DEVICE_BLOCKLIST", None)
    if saved is not None:
        os.environ["GS_DEVICE_BLOCKLIST"] = saved


def run(monkeypatch, d: Path, env, n_devices=None, **cfg):
    """``driver.main`` on a fresh config under ``env``. The mesh runs at
    depth 1 unless ``env`` says otherwise (the 6n-face rounds, the
    card's default depth)."""
    if n_devices is not None:
        env = {"GS_FUSE": "1", **env}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _reset_sinks()
    try:
        return driver.main([write_config(d, **cfg)], n_devices=n_devices)
    finally:
        for k in env:
            monkeypatch.delenv(k, raising=False)


def journal(d: Path):
    path = d / "gs.bp.faults.jsonl"
    return [json.loads(x) for x in path.read_text().splitlines()]


def differing(a: Path, b: Path):
    """The files that differ between two store trees."""
    out = []

    def walk(c, rel):
        out.extend(f"{rel}/{n}" for n in c.left_only + c.right_only)
        out.extend(f"{rel}/{n}" for n in c.common_files
                   if not filecmp.cmp(os.path.join(c.left, n),
                                      os.path.join(c.right, n),
                                      shallow=False))
        for n, sub in c.subdirs.items():
            walk(sub, f"{rel}/{n}")

    assert a.is_dir() and b.is_dir(), (a, b)
    walk(filecmp.dircmp(a, b), a.name)
    return out


_BASES = {}


def baseline(monkeypatch, tmp_path_factory, case, n_devices):
    """The uninterrupted run of ``case``'s settings (one per case and
    layout in this process)."""
    faults, env, cfg = CASES[case]
    env = {k: env[k] for k in BASE_ENV.get(case, ())}
    key = (tuple(sorted(env.items())), tuple(sorted(cfg.items())), n_devices)
    if key not in _BASES:
        d = tmp_path_factory.mktemp("base")
        run(monkeypatch, d, env, n_devices=n_devices, **cfg)
        _BASES[key] = d
    return _BASES[key]


@pytest.mark.parametrize("n_devices", [None, 8], ids=["block", "mesh"])
@pytest.mark.parametrize("case", list(CASES))
def test_supervised_fault_run_is_byte_identical(monkeypatch, tmp_path,
                                                tmp_path_factory, case,
                                                n_devices):
    base = baseline(monkeypatch, tmp_path_factory, case, n_devices)
    faults, env, cfg = CASES[case]
    stats = tmp_path / "stats.json"
    env = {**SUPERVISED, **env, "GS_FAULTS": faults,
           "GS_TPU_STATS": str(stats)}
    if case == "kernel":
        # A kernel failure stops the supervised run (the card runs the
        # CUDA kernels or nothing); the user's relaunch, once the kernel
        # is repaired, resumes from the durable checkpoint.
        with pytest.raises(InjectedKernelError, match="at step 25"):
            run(monkeypatch, tmp_path, env, n_devices=n_devices, **cfg)
        stopped = journal(tmp_path)
        assert [(e["event"], e.get("kind")) for e in stopped] == [
            ("injected", "kernel"), ("attempt_phases", "kernel"),
            ("gave_up", "kernel")]
        assert "InjectedKernelError" in stopped[-1]["error"]
        assert "kernel failure" in stopped[-1]["reason"]
        del env["GS_FAULTS"]
        cfg = {**cfg, "restart": True, "restart_step": 20,
               "restart_input": str(tmp_path / "ckpt.bp")}
    sim = run(monkeypatch, tmp_path, env, n_devices=n_devices, **cfg)
    assert sim.sharded == (n_devices == 8)
    stores = ["gs.bp", "gs.vtk"]
    if case == "ckpt_corrupt":
        # The primary keeps the flipped byte; the replica that served
        # the restore equals the uninterrupted primary.
        assert not differing(base / "ckpt.bp", tmp_path / "ckpt.bp.r1")
        assert differing(base / "ckpt.bp", tmp_path / "ckpt.bp")
    else:
        stores.append("ckpt.bp")
    for store in stores:
        assert not differing(base / store, tmp_path / store), store
    events_ = journal(tmp_path)
    kinds = [(e["event"], e.get("kind")) for e in events_]
    recoveries = [e for e in events_ if e["event"] == "recovery"]
    summary = json.loads(stats.read_text())
    # The kernel path all the way, in every case.
    assert "degraded_from" not in (summary["config"]["kernel_selection"]
                                   or {})
    assert summary["config"]["kernel_language"] == "cuda"
    # The relaunch after the kernel failure is a first attempt with
    # nothing to recover; every other case recovers once in process.
    attempt = 0 if case == "kernel" else 1
    assert len(recoveries) == attempt, kinds
    # The relaunch's journal in memory holds its own records: none.
    assert [e["event"] for e in summary["faults"] or []] == (
        [] if case == "kernel" else [e["event"] for e in events_])
    assert summary["config"]["attempt"] == attempt
    assert summary["watchdog"]["enabled"] and summary["watchdog"][
        "attempt"] == attempt
    if case == "hang":
        hang = next(e for e in events_ if e["event"] == "hang")
        assert hang["phase"] == "step_round" and hang["threads"]
    if case == "sdc":
        mism = next(e for e in events_ if e["event"] == "sdc_mismatch")
        assert mism["device"] == "cpu"
        assert mism["block"] == (7 if n_devices == 8 else 0)
        assert summary["config"]["sdc"]["mode"] == "spot"
        assert summary["config"]["sdc"]["verified_step"] == 40


@pytest.mark.parametrize("depth,halo", [("0", None), ("2", None),
                                        ("2", "2")])
def test_restart_determinism_across_depth_and_halo(monkeypatch, tmp_path,
                                                   depth, halo):
    """A preemption resumed from checkpoint 20 gives the uninterrupted
    stores at pipeline depth 0 and 2, and at ``GS_HALO_DEPTH=2`` on the
    (2,2,2) mesh at ``GS_FUSE=2``."""
    env = {"GS_ASYNC_IO_DEPTH": depth}
    n = None
    if halo is not None:
        env.update({"GS_HALO_DEPTH": halo, "GS_FUSE": "2"})
        n = 8
    run(monkeypatch, tmp_path / "base", env, n_devices=n)
    run(monkeypatch, tmp_path / "chaos", {**SUPERVISED, **env,
                                          "GS_FAULTS": "step=25:kind=preempt"},
        n_devices=n)
    for store in ("gs.bp", "gs.vtk", "ckpt.bp"):
        assert not differing(tmp_path / "base" / store,
                             tmp_path / "chaos" / store)


def test_sdc_spot_leaves_the_stores_as_they_were(monkeypatch, tmp_path):
    run(monkeypatch, tmp_path / "off", {})
    run(monkeypatch, tmp_path / "spot", {"GS_SDC_CHECK": "spot",
                                         "GS_SDC_EVERY": "1"})
    for store in ("gs.bp", "gs.vtk", "ckpt.bp"):
        assert not differing(tmp_path / "off" / store,
                             tmp_path / "spot" / store)


def test_sdc_repeat_quarantines_and_gives_up(monkeypatch, tmp_path):
    """Two flips on the one CPU device: the second quarantines it, and
    with no device left the supervisor gives up."""
    from grayscott_jl_tpu_torch.resilience.sdc import SDCError

    with pytest.raises(SDCError):
        run(monkeypatch, tmp_path, {
            **SUPERVISED, "GS_SDC_CHECK": "spot",
            "GS_FAULTS": "step=25:kind=sdc;step=35:kind=sdc"})
    ev = journal(tmp_path)
    q = [e for e in ev if e["event"] == "device_quarantined"]
    assert len(q) == 1 and q[0]["device"] == "cpu"
    gave = [e for e in ev if e["event"] == "gave_up"]
    assert gave[-1]["kind"] == "sdc"
    assert "every device quarantined" in gave[-1]["reason"]


def test_supervisor_gives_up_past_max_restarts(monkeypatch, tmp_path):
    from grayscott_jl_tpu_torch.resilience.faults import PreemptionError

    with pytest.raises(PreemptionError):
        run(monkeypatch, tmp_path, {
            **SUPERVISED, "GS_MAX_RESTARTS": "1",
            "GS_FAULTS": "step=15:kind=preempt;step=25:kind=preempt"})
    ev = journal(tmp_path)
    assert [e["event"] for e in ev if e["event"] in (
        "recovery", "gave_up")] == ["recovery", "gave_up"]
    assert ev[-1]["attempt"] == 1 and ev[-1]["kind"] == "preemption"


def test_health_abort_is_fatal_and_closes_the_stores(monkeypatch, tmp_path):
    from grayscott_jl_tpu_torch.io.bplite import BpReader

    with pytest.raises(HealthError, match="policy=abort"):
        run(monkeypatch, tmp_path, {**SUPERVISED,
                                    "GS_FAULTS": "step=25:kind=nan"})
    ev = journal(tmp_path)
    assert [e["event"] for e in ev][-1] == "gave_up"
    assert ev[-1]["kind"] == "fatal"
    assert json.loads((tmp_path / "gs.bp" / "md.json").read_text())[
        "complete"] is True
    with BpReader(str(tmp_path / "gs.bp")) as r:
        assert [int(r.get("step", step=i)) for i in range(r.num_steps())] \
            == [10, 20]


def test_unsupervised_fault_raises_and_journals_in_memory(monkeypatch,
                                                          tmp_path):
    from grayscott_jl_tpu_torch.resilience.faults import PreemptionError

    with pytest.raises(PreemptionError, match="planned step 25"):
        run(monkeypatch, tmp_path, {"GS_FAULTS": "step=25:kind=preempt"})
    assert not (tmp_path / "gs.bp.faults.jsonl").exists()


def test_hang_without_watchdog_resolves_transparently(monkeypatch,
                                                      tmp_path):
    run(monkeypatch, tmp_path / "base", {})
    t0 = time.monotonic()
    run(monkeypatch, tmp_path / "hang", {"GS_FAULTS": "step=15:kind=hang",
                                         "GS_HANG_BOUND_S": "0.3"})
    assert time.monotonic() - t0 >= 0.3
    for store in ("gs.bp", "ckpt.bp"):
        assert not differing(tmp_path / "base" / store,
                             tmp_path / "hang" / store)


def _env(extra):
    env = {k: v for k, v in os.environ.items() if k not in _VARS}
    env["PYTHONPATH"] = str(REPO) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    env.update(extra)
    return env


def test_sigterm_exits_75_and_a_supervised_relaunch_resumes(monkeypatch,
                                                            tmp_path):
    """The CLI in a subprocess, supervised, stalled at the step-20
    boundary (an unwatched ``hang``): SIGTERM there writes the boundary,
    journals ``graceful_shutdown`` and exits 75; the relaunch resumes
    from the marker and the output stores equal the uninterrupted run's."""
    run(monkeypatch, tmp_path / "base", {})
    d = tmp_path / "chaos"
    cfg = write_config(d)
    proc = subprocess.Popen(
        [sys.executable, "-m", "grayscott_jl_tpu_torch", cfg],
        env=_env({**SUPERVISED, "GS_FAULTS": "step=20:kind=hang",
                  "GS_WATCHDOG": "off", "GS_HANG_BOUND_S": "60"}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    path = d / "gs.bp.faults.jsonl"
    t0 = time.monotonic()
    while (time.monotonic() - t0 < 120 and proc.poll() is None
           and not (path.exists() and "injected" in path.read_text())):
        time.sleep(0.05)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 75, out
    assert "GS_SUPERVISE=1" in out
    assert journal(d)[-1]["event"] == "graceful_shutdown"
    res = subprocess.run([sys.executable, "-m", "grayscott_jl_tpu_torch", cfg],
                         env=_env(SUPERVISED), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    rec = [e for e in journal(d) if e["event"] == "recovery"]
    assert rec[-1]["after"] == "graceful_shutdown"
    assert rec[-1]["action"] == "resumed_from_checkpoint_step_20"
    for store in ("gs.bp", "gs.vtk"):
        assert not differing(tmp_path / "base" / store, d / store)


def test_two_processes_restart_together(monkeypatch, tmp_path):
    """Two processes on gloo, four blocks each, supervised with a
    ``preempt`` plan: both raise at the same boundary, agree through the
    rendezvous (the restart step, then the mesh), resume from the same
    checkpoint and write the store of one process."""
    from test_torch_multiprocess import (assert_stores_bitwise, run_pair,
                                         run_single)

    one = tmp_path / "one"
    run_single(monkeypatch, one, write_config(one, kernel_language="Plain"))
    pair = tmp_path / "pair"
    run_pair(pair, write_config(pair, kernel_language="Plain"),
             extra={**SUPERVISED, "GS_FAULTS": "step=25:kind=preempt"})
    assert_stores_bitwise(str(one / "gs.bp"), str(pair / "gs.bp"),
                          ("U", "V"))
    assert_stores_bitwise(str(one / "ckpt.bp"), str(pair / "ckpt.bp"),
                          ("u", "v"))
    for rank in (0, 1):
        ev = [json.loads(x) for x in (
            pair / f"gs.bp.faults.jsonl.rank{rank}").read_text().splitlines()]
        assert [e["event"] for e in ev] == [
            "injected", "attempt_phases", "rendezvous", "mesh_agreement",
            "recovery"]
        assert all(e["proc"] == rank for e in ev)
        rdv = ev[2]
        assert (rdv["procs"], rdv["quorum_step"], rdv["attempt"]) == (2, 20, 0)
        # The mesh agreed in the same round: eight blocks, no proposal.
        mesh = ev[3]
        assert (mesh["devices"], mesh["dims"], mesh["procs"]) == (8, None, 2)
        assert ev[4]["action"] == "resumed_from_checkpoint_step_20"


HARD_HANG = r"""
import ctypes, sys
from grayscott_jl_tpu_torch import julia_main
from grayscott_jl_tpu_torch.simulation import Simulation

iterate = Simulation.iterate


def wedged(self, n=1):
    if self.step >= 20:
        # A wait in C that the watchdog's interrupt cannot reach, as a
        # device wait on the card.
        ctypes.CDLL(None).sleep(120)
    iterate(self, n)


Simulation.iterate = wedged
sys.exit(julia_main([sys.argv[1]]))
"""


def test_hard_hang_exits_76_and_a_relaunch_resumes(monkeypatch, tmp_path):
    """A supervised CLI wedged in C at step 20: the watchdog journals the
    hang, then after the grace period ``hang_exit`` and exit 76; a
    supervised relaunch resumes from that marker at the step-20
    checkpoint and the stores equal the uninterrupted run's."""
    run(monkeypatch, tmp_path / "base", {})
    d = tmp_path / "chaos"
    cfg = write_config(d)
    res = subprocess.run(
        [sys.executable, "-c", HARD_HANG, cfg],
        env=_env({**SUPERVISED, "GS_WATCHDOG_STEP_ROUND_S": "1",
                  "GS_WATCHDOG_GRACE_S": "0.5"}),
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 76, res.stdout + res.stderr
    ev = journal(d)
    assert [e["event"] for e in ev] == ["hang", "hang_exit"]
    assert ev[1]["exit_code"] == 76 and ev[1]["phase"] == "step_round"
    res = subprocess.run([sys.executable, "-m", "grayscott_jl_tpu_torch", cfg],
                         env=_env(SUPERVISED), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    rec = journal(d)[-1]
    assert (rec["event"], rec["kind"], rec["after"], rec["action"]) == (
        "recovery", "hang", "hang_exit", "resumed_from_checkpoint_step_20")
    for store in ("gs.bp", "gs.vtk", "ckpt.bp"):
        assert not differing(tmp_path / "base" / store, d / store)
