"""Graceful shutdown (grayscott_jl_tpu_torch/resilience/faults.py and
the driver's shutdown path) on the CPU: SIGTERM to a running CLI
process gives exit code 75 and a checkpoint at the next boundary, and a
restart from that checkpoint is bitwise equal to the uninterrupted
run."""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from grayscott_jl_tpu.resilience import faults as ref_faults
from grayscott_jl_tpu_torch import Settings, driver
from grayscott_jl_tpu_torch.config.settings import parse_settings_toml
from grayscott_jl_tpu_torch.io.bplite import BpReader
from grayscott_jl_tpu_torch.resilience import faults

REPO = Path(__file__).resolve().parents[1]

BASE = dict(L=16, F=0.02, k=0.048, dt=1.0, Du=0.2, Dv=0.1, noise=0.1,
            precision="Float32", backend="CPU", verbose=True)


def _config(path, **kw):
    base = dict(BASE, output=str(path.parent / "gs.bp"))
    base.update(kw)
    lines = []
    for key, value in base.items():
        if isinstance(value, bool):
            lines.append(f"{key} = {'true' if value else 'false'}")
        elif isinstance(value, str):
            lines.append(f'{key} = "{value}"')
        else:
            lines.append(f"{key} = {value}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _run_and_signal(cfg, cwd, sig=signal.SIGTERM, env=None):
    """Start the CLI on ``cfg``, send ``sig`` once it has written its
    first output step, and return (exit code, output)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env or {}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "grayscott_jl_tpu_torch", cfg], cwd=cwd,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if "writing output step" in line:
                proc.send_signal(sig)
                break
        out, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, "".join(lines) + out


def test_sigterm_checkpoints_exits_75_and_restarts_bitwise(tmp_path):
    ckpt = str(tmp_path / "ckpt.bp")
    cfg = _config(tmp_path / "run.toml", steps=200000, plotgap=20,
                  checkpoint=True, checkpoint_freq=1000000,
                  checkpoint_output=ckpt)
    rc, out = _run_and_signal(cfg, tmp_path)
    assert rc == faults.EXIT_PREEMPTED == ref_faults.EXIT_PREEMPTED, out
    assert "graceful shutdown on SIGTERM" in out
    with BpReader(ckpt) as r:
        assert r.num_steps() == 1
        at = int(r.get("step", step=0))
    with BpReader(str(tmp_path / "gs.bp")) as r:
        written = [int(r.get("step", step=i)) for i in range(r.num_steps())]
    # The checkpoint is at the first boundary the run reached after the
    # signal, after that boundary's output step.
    assert at % 20 == 0 and at == written[-1]
    assert f"at step {at} (checkpoint durable at step {at})" in out

    end = at + 40
    resumed = driver.main([_config(
        tmp_path / "resume.toml", steps=end, plotgap=20, restart=True,
        restart_input=ckpt, output=str(tmp_path / "resumed.bp"))])
    whole = driver.main([_config(
        tmp_path / "whole.toml", steps=end, plotgap=20,
        output=str(tmp_path / "whole.bp"))])
    assert resumed.step == whole.step == end
    for a, b in zip(resumed.get_fields(), whole.get_fields()):
        np.testing.assert_array_equal(a, b)


def test_sigint_without_checkpoints_exits_75(tmp_path):
    cfg = _config(tmp_path / "run.toml", steps=200000, plotgap=20)
    rc, out = _run_and_signal(cfg, tmp_path, sig=signal.SIGINT)
    assert rc == 75, out
    assert "no checkpoint store configured" in out


def test_disabled_listener_leaves_sigterm_fatal(tmp_path):
    cfg = _config(tmp_path / "run.toml", steps=200000, plotgap=20,
                  graceful_shutdown=False)
    rc, _ = _run_and_signal(cfg, tmp_path)
    assert rc == -signal.SIGTERM


def test_resolve_graceful_shutdown(monkeypatch):
    monkeypatch.delenv("GS_GRACEFUL_SHUTDOWN", raising=False)
    assert faults.resolve_graceful_shutdown(Settings()) is True
    assert faults.resolve_graceful_shutdown(
        Settings(graceful_shutdown=False)) is False
    monkeypatch.setenv("GS_GRACEFUL_SHUTDOWN", "off")
    assert faults.resolve_graceful_shutdown(Settings()) is False
    monkeypatch.setenv("GS_GRACEFUL_SHUTDOWN", "yes")
    assert faults.resolve_graceful_shutdown(
        Settings(graceful_shutdown=False)) is True
    monkeypatch.setenv("GS_GRACEFUL_SHUTDOWN", "maybe")
    with pytest.raises(ValueError, match="boolean"):
        faults.resolve_graceful_shutdown(Settings())


def test_listener_records_the_first_signal_and_raises_on_a_second():
    listener = faults.ShutdownListener()
    assert not listener.requested
    listener._handle(signal.SIGTERM, None)
    assert listener.requested and listener.signum == signal.SIGTERM
    with pytest.raises(KeyboardInterrupt, match="second signal"):
        listener._handle(signal.SIGINT, None)


def test_graceful_shutdown_message_matches_the_reference():
    ours = faults.GracefulShutdown(signal.SIGTERM, 40, 40)
    ref = ref_faults.GracefulShutdown(signal.SIGTERM, 40, 40)
    assert str(ours) == str(ref)
    assert isinstance(ours, faults.PreemptionError)
    assert str(faults.GracefulShutdown(signal.SIGINT, 7)) == str(
        ref_faults.GracefulShutdown(signal.SIGINT, 7))


def test_request_before_a_boundary_checkpoints_there(tmp_path, monkeypatch):
    """A request seen at a boundary that writes nothing (the run's last,
    off the plot grid) still checkpoints there."""
    calls = []
    real = faults.ShutdownListener.requested

    def requested(self):
        # Checked after the writes at steps 10 and 20, then at 25.
        calls.append(1)
        return len(calls) >= 3 or real.fget(self)

    monkeypatch.setattr(faults.ShutdownListener, "requested",
                        property(requested))
    ckpt = str(tmp_path / "ckpt.bp")
    cfg = parse_settings_toml(Path(_config(
        tmp_path / "a.toml", steps=25, plotgap=10, checkpoint=True,
        checkpoint_freq=100, checkpoint_output=ckpt,
        verbose=False)).read_text())
    with pytest.raises(faults.GracefulShutdown) as e:
        driver.run_once(cfg)
    assert e.value.step == e.value.checkpoint_step == 25
    with BpReader(ckpt) as r:
        assert [int(r.get("step", step=i))
                for i in range(r.num_steps())] == [25]
    with BpReader(str(tmp_path / "gs.bp")) as r:
        assert r.num_steps() == 2


class _SignalAt(driver.Simulation):
    """A simulation that sends itself SIGTERM when it steps on from
    ``AT`` (a request mid-run, seen at the next boundary)."""

    AT = 20

    def iterate(self, nsteps=1):
        if self.step == self.AT:
            os.kill(os.getpid(), signal.SIGTERM)
        super().iterate(nsteps)


@pytest.mark.parametrize("depth", [0, 2])
def test_shutdown_drains_the_pipeline_and_restarts_bitwise(tmp_path,
                                                           monkeypatch,
                                                           depth):
    """At depth 0 and 2 alike, a SIGTERM leads to a checkpoint at the
    next boundary, after every accepted step is written, and the restart
    from it is bitwise equal to the uninterrupted run."""
    monkeypatch.setenv("GS_ASYNC_IO_DEPTH", str(depth))
    ckpt = str(tmp_path / "ckpt.bp")
    cfg = parse_settings_toml(Path(_config(
        tmp_path / "run.toml", steps=200, plotgap=10, checkpoint=True,
        checkpoint_freq=1000, checkpoint_output=ckpt,
        verbose=False)).read_text())
    with pytest.raises(faults.GracefulShutdown) as e:
        driver.run_once(cfg, sim_factory=lambda s, **kw: _SignalAt(s, **kw))
    assert e.value.step == e.value.checkpoint_step == 30
    with BpReader(ckpt) as r:
        assert [int(r.get("step", step=i))
                for i in range(r.num_steps())] == [30]
    with BpReader(str(tmp_path / "gs.bp")) as r:
        assert [int(r.get("step", step=i))
                for i in range(r.num_steps())] == [10, 20, 30]
    resumed = driver.main([_config(
        tmp_path / "resume.toml", steps=50, plotgap=10, restart=True,
        restart_input=ckpt, output=str(tmp_path / "resumed.bp"),
        verbose=False)])
    whole = driver.main([_config(
        tmp_path / "whole.toml", steps=50, plotgap=10,
        output=str(tmp_path / "whole.bp"), verbose=False)])
    for a, b in zip(resumed.get_fields(), whole.get_fields()):
        np.testing.assert_array_equal(a, b)
