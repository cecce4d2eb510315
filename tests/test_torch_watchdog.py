"""The hang watchdog, the graceful-shutdown listener's watchdog hook and
the resume markers (grayscott_jl_tpu_torch/resilience/watchdog.py,
faults.py, supervisor.py) against the reference's, the counterparts of
tests/unit/test_watchdog.py. Host-side only; the run-level recoveries
(an injected hang restarted byte-identical, the hard exit 76 and its
resume) are in tests/test_torch_supervisor.py."""

import json
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.resilience import watchdog as ref_wd
from grayscott_jl_tpu_torch import Settings
from grayscott_jl_tpu_torch.resilience.faults import (
    EXIT_HANG, EXIT_PREEMPTED, GracefulShutdown, PreemptionError,
    ShutdownListener, injected_hang_wait)
from grayscott_jl_tpu_torch.resilience.supervisor import (FaultJournal,
                                                          classify_failure,
                                                          resume_marker)
from grayscott_jl_tpu_torch.resilience.watchdog import (DEFAULT_DEADLINES,
                                                        HangError, Watchdog,
                                                        resolve_watchdog)

REPO = Path(__file__).resolve().parents[1]

_VARS = ("GS_WATCHDOG", "GS_SUPERVISE", "GS_WATCHDOG_DEADLINE_S",
         "GS_WATCHDOG_GRACE_S") + tuple(
             f"GS_WATCHDOG_{p.upper()}_S" for p in DEFAULT_DEADLINES)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in _VARS:
        monkeypatch.delenv(var, raising=False)


def _both(**kw):
    return Settings(**kw), RefSettings(**kw)


def test_resolve_watchdog_auto_follows_supervision(monkeypatch):
    for kw in ({}, {"supervise": True}):
        s, r = _both(**kw)
        assert resolve_watchdog(s) == ref_wd.resolve_watchdog(r)
    assert resolve_watchdog(Settings()) is None
    assert resolve_watchdog(Settings(supervise=True)) is not None
    monkeypatch.setenv("GS_SUPERVISE", "1")
    assert resolve_watchdog(Settings()) is not None
    monkeypatch.setenv("GS_WATCHDOG", "off")
    assert resolve_watchdog(Settings(supervise=True)) is None
    monkeypatch.setenv("GS_WATCHDOG", "on")
    monkeypatch.delenv("GS_SUPERVISE")
    assert resolve_watchdog(Settings()) == ref_wd.resolve_watchdog(
        RefSettings())


@pytest.mark.parametrize("env,key", [
    ({}, None),
    ({"GS_WATCHDOG_DEADLINE_S": "7.5"}, None),
    ({"GS_WATCHDOG_DEADLINE_S": "7.5", "GS_WATCHDOG_STEP_ROUND_S": "2.5"},
     None),
    ({"GS_WATCHDOG_COMPILE_S": "3"}, 9.0),
    ({}, 9.0),
    ({"GS_WATCHDOG_RESHAPE_S": "12"}, None),
])
def test_resolve_watchdog_deadlines_match_the_reference(monkeypatch, env,
                                                        key):
    monkeypatch.setenv("GS_WATCHDOG", "on")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = {"watchdog_deadline_s": key} if key is not None else {}
    s, r = _both(**kw)
    assert resolve_watchdog(s) == ref_wd.resolve_watchdog(r)
    assert resolve_watchdog(s).keys() == ref_wd.DEFAULT_DEADLINES.keys()


@pytest.mark.parametrize("var,value", [
    ("GS_WATCHDOG", "sideways"), ("GS_WATCHDOG_DEADLINE_S", "soon"),
    ("GS_WATCHDOG_STEP_ROUND_S", "-1"), ("GS_WATCHDOG_IO_S", "0"),
])
def test_bad_watchdog_knobs_raise_as_the_reference(monkeypatch, var, value):
    monkeypatch.setenv("GS_WATCHDOG", "on")
    monkeypatch.setenv(var, value)
    with pytest.raises(ValueError) as a:
        resolve_watchdog(Settings())
    with pytest.raises(ValueError) as b:
        ref_wd.resolve_watchdog(RefSettings())
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("value", ["x", "-2"])
def test_bad_grace_raises_as_the_reference(monkeypatch, value):
    monkeypatch.setenv("GS_WATCHDOG_GRACE_S", value)
    with pytest.raises(ValueError) as a:
        Watchdog({"io": 1.0})
    with pytest.raises(ValueError) as b:
        ref_wd.Watchdog({"io": 1.0})
    assert str(a.value) == str(b.value)


def _quiet_watchdog(deadlines, journal=None, grace_s=0):
    """A watchdog that never interrupts the test runner's main thread."""
    return Watchdog(deadlines, journal=journal, grace_s=grace_s,
                    on_expire=lambda: None)


def test_watchdog_fires_after_deadline_and_journals_stacks():
    j = FaultJournal(None)
    with _quiet_watchdog({"step_round": 0.15}, journal=j) as wd:
        wd.heartbeat("step_round", 42)
        time.sleep(0.6)
        assert wd.expired is not None
        with pytest.raises(HangError, match="step_round.*step 42"):
            wd.check()
    events = [e for e in j.events if e["event"] == "hang"]
    assert len(events) == 1
    e = events[0]
    assert (e["kind"], e["phase"], e["step"]) == ("hang", "step_round", 42)
    assert any("MainThread" in t["thread"] and t["stack"]
               for t in e["threads"])
    assert wd.describe()["expired"]["phase"] == "step_round"
    # The message is the reference's.
    assert str(HangError("io", 3, 2.0)) == str(ref_wd.HangError("io", 3, 2.0))


def test_watchdog_heartbeats_keep_it_alive_and_stop_disarms():
    with _quiet_watchdog({"step_round": 0.3}) as wd:
        for i in range(6):
            wd.heartbeat("step_round", i)
            time.sleep(0.1)
        assert wd.expired is None
    assert wd.describe()["heartbeats"] == 6
    wd2 = _quiet_watchdog({"step_round": 0.15}).start()
    wd2.heartbeat("step_round", 0)
    wd2.stop()
    time.sleep(0.4)
    assert wd2.expired is None


def test_watchdog_touch_only_rearms_the_armed_phase():
    with _quiet_watchdog({"drain": 0.3, "io": 0.3}) as wd:
        wd.heartbeat("drain", 1)
        for _ in range(5):
            time.sleep(0.1)
            wd.touch("io", 9)
        assert wd.expired is not None and wd.expired["phase"] == "drain"
    with _quiet_watchdog({"drain": 0.3}) as wd:
        wd.heartbeat("drain", 1)
        for _ in range(5):
            time.sleep(0.1)
            wd.touch("drain", 2)
        assert wd.expired is None


def test_watchdog_interrupts_main_thread():
    """The default expiry interrupts the main thread: a Python-level
    stall unwinds."""
    wd = Watchdog({"step_round": 0.2}, grace_s=0).start()
    wd.heartbeat("step_round", 7)
    t0 = time.monotonic()
    with pytest.raises(KeyboardInterrupt):
        while time.monotonic() - t0 < 5.0:
            time.sleep(0.05)
    wd.stop()
    assert wd.expired is not None and time.monotonic() - t0 < 4.0


def test_injected_hang_wait_bounded_and_watchdog_aware(monkeypatch):
    t0 = time.monotonic()
    injected_hang_wait(bound_s=0.2)
    assert 0.15 <= time.monotonic() - t0 < 2.0
    monkeypatch.setenv("GS_HANG_BOUND_S", "0.2")
    t0 = time.monotonic()
    injected_hang_wait()
    assert time.monotonic() - t0 < 2.0
    # Under the watchdog: its interrupt reaches the stall through the
    # listener (as in driver.run_once) and unwinds it; the expiry then
    # reads as the HangError run_once raises, and nothing lands after.
    t0 = time.monotonic()
    with Watchdog({"step_round": 0.15}, grace_s=0) as wd:
        with ShutdownListener(watchdog=wd):
            wd.heartbeat("step_round", 3)
            with pytest.raises(KeyboardInterrupt, match="watchdog"):
                injected_hang_wait(bound_s=30.0)
        with pytest.raises(HangError, match="step_round.*step 3"):
            wd.check()
        time.sleep(0.4)
    assert time.monotonic() - t0 < 5.0

    class _Shutdown:
        requested = True
        signum = signal.SIGTERM

    t0 = time.monotonic()
    injected_hang_wait(shutdown=_Shutdown(), bound_s=30.0)
    assert time.monotonic() - t0 < 2.0


def test_hang_and_graceful_shutdown_classification():
    assert classify_failure(HangError("step_round", 40, 2.0)) == "hang"
    g = GracefulShutdown(signal.SIGTERM, 30, 30)
    assert isinstance(g, PreemptionError)
    assert classify_failure(g) == "preemption"
    assert "SIGTERM" in str(g) and "step 30" in str(g)
    assert (EXIT_PREEMPTED, EXIT_HANG) == (75, 76)
    assert EXIT_HANG == ref_wd.EXIT_HANG


def test_shutdown_listener_first_signal_requests_second_forces():
    lis = ShutdownListener()
    with lis:
        assert not lis.requested
        signal.raise_signal(signal.SIGTERM)
        assert lis.requested and lis.signum == signal.SIGTERM
        with pytest.raises(KeyboardInterrupt, match="second signal"):
            signal.raise_signal(signal.SIGTERM)
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


def test_shutdown_listener_reraises_watchdog_interrupt():
    class _Expired:
        expired = {"phase": "step_round"}

    with ShutdownListener(watchdog=_Expired()):
        with pytest.raises(KeyboardInterrupt, match="watchdog"):
            signal.raise_signal(signal.SIGINT)


def test_resume_marker_reads_trailing_marker_only(tmp_path):
    path = tmp_path / "j.jsonl"
    j = FaultJournal(str(path))
    j.record(event="injected", kind="hang", step=30)
    assert resume_marker(str(path)) is None
    j.record(event="graceful_shutdown", signal=15, step=30,
             checkpoint_step=30)
    m = resume_marker(str(path))
    assert m["event"] == "graceful_shutdown" and m["checkpoint_step"] == 30
    j.record(event="recovery", kind="preemption", attempt=0, action="x")
    assert resume_marker(str(path)) is None
    j.record(event="hang_exit", kind="hang", phase="step_round", step=40)
    assert resume_marker(str(path))["event"] == "hang_exit"
    with open(path, "a") as f:
        f.write('{"event": "hang_ex')
    assert resume_marker(str(path))["event"] == "hang_exit"
    assert resume_marker(str(tmp_path / "missing.jsonl")) is None


def test_fault_journal_tags_process_index_and_fsyncs_lines(tmp_path):
    j = FaultJournal(str(tmp_path / "j.jsonl"), process_index=1)
    j.record(event="injected", kind="preempt", step=5)
    assert j.events[0]["proc"] == 1
    line = json.loads((tmp_path / "j.jsonl").read_text())
    assert line["proc"] == 1 and line["step"] == 5
    j0 = FaultJournal(None)
    j0.record(event="injected", kind="nan", step=1)
    assert "proc" not in j0.events[0]


def test_hard_exit_after_grace_leaves_76_and_the_marker(tmp_path):
    """A stall in C that the interrupt cannot reach (a stand-in for a
    device wait: libc ``sleep`` through ctypes): the watchdog journals
    the hang, then after the grace period ``hang_exit`` and exits 76."""
    journal = tmp_path / "j.jsonl"
    script = textwrap.dedent(f"""
        import ctypes, sys
        sys.path.insert(0, {str(REPO)!r})
        from grayscott_jl_tpu_torch.resilience.supervisor import FaultJournal
        from grayscott_jl_tpu_torch.resilience.watchdog import Watchdog
        wd = Watchdog({{"step_round": 0.3}}, grace_s=0.5,
                      journal=FaultJournal({str(journal)!r})).start()
        wd.heartbeat("step_round", 120)
        ctypes.CDLL(None).sleep(60)
        sys.exit(3)
    """)
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-c", script], timeout=60,
                         capture_output=True, text=True)
    assert res.returncode == EXIT_HANG, res.stderr
    assert time.monotonic() - t0 < 30
    events = [json.loads(line) for line in journal.read_text().splitlines()]
    assert [e["event"] for e in events] == ["hang", "hang_exit"]
    assert events[1]["exit_code"] == 76 and events[1]["step"] == 120
    assert resume_marker(str(journal))["event"] == "hang_exit"
