"""The field health guard (grayscott_jl_tpu_torch/resilience/health.py)
against the reference's on the CPU: a run that blows up raises
HealthError at the same boundary as a live reference run and writes no
step under the default policy; ``warn`` and ``off`` write the NaN steps;
an unknown policy, and ``rollback`` without supervision, raise at
start-up (under supervision ``rollback`` restarts the run:
tests/test_torch_supervisor.py). The probe is reduced in the snapshot."""

import math

import numpy as np
import pytest
import torch

from grayscott_jl_tpu import driver as ref_driver
from grayscott_jl_tpu.resilience.health import HealthError as RefHealthError
from grayscott_jl_tpu_torch import Settings, Simulation, driver, julia_main
from grayscott_jl_tpu_torch.io.bplite import BpReader
from grayscott_jl_tpu_torch.resilience import health
from grayscott_jl_tpu_torch.resilience.health import HealthError

#: The blow-up configuration (ROADMAP F1): dt = 400 at L = 16 turns
#: every cell NaN by step 10.
F1 = dict(L=16, F=0.02, k=0.048, dt=400.0, Du=0.2, Dv=0.1, noise=0.0,
          steps=20, plotgap=10, precision="Float32", backend="CPU")


def _config(path, **kw):
    base = dict(F1, output=str(path.parent / "gs.bp"))
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


def _steps(store):
    with BpReader(store) as r:
        return r.num_steps()


@pytest.fixture(autouse=True)
def _no_policy_env(monkeypatch):
    monkeypatch.delenv("GS_HEALTH_POLICY", raising=False)


def test_f1_raises_at_the_reference_step_and_writes_nothing(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref_cfg = _config(tmp_path / "ref" / "cfg.toml",
                      output=str(tmp_path / "ref" / "gs.bp"),
                      kernel_language="Plain")
    port_cfg = _config(tmp_path / "port" / "cfg.toml",
                       output=str(tmp_path / "port" / "gs.bp"))
    with pytest.raises(RefHealthError) as ref:
        ref_driver.main([ref_cfg], n_devices=1)
    with pytest.raises(HealthError) as port:
        driver.main([port_cfg])
    assert port.value.step == ref.value.step == 10
    assert port.value.policy == "abort"
    assert not port.value.report.finite
    assert "finite=False, u in [nan, nan], v in [nan, nan]" in str(port.value)
    assert _steps(str(tmp_path / "port" / "gs.bp")) == 0
    assert _steps(str(tmp_path / "ref" / "gs.bp")) == 0


def test_f1_cli_exits_1(tmp_path):
    assert julia_main([_config(tmp_path / "cfg.toml")]) == 1
    assert _steps(str(tmp_path / "gs.bp")) == 0


@pytest.mark.parametrize("how", ["key", "env"])
def test_off_writes_the_nan_steps(tmp_path, monkeypatch, how):
    if how == "env":
        monkeypatch.setenv("GS_HEALTH_POLICY", "off")
        cfg = _config(tmp_path / "cfg.toml", health_policy="abort")
    else:
        cfg = _config(tmp_path / "cfg.toml", health_policy="off")
    driver.main([cfg])
    with BpReader(str(tmp_path / "gs.bp")) as r:
        assert r.num_steps() == 2
        for i in range(2):
            assert np.isnan(r.get("U", step=i)).all()


def test_warn_writes_the_nan_steps_and_logs(tmp_path, capsys):
    driver.main([_config(tmp_path / "cfg.toml", health_policy="warn")])
    assert _steps(str(tmp_path / "gs.bp")) == 2
    out = capsys.readouterr().out
    assert out.count("field health check failed") == 2
    assert "policy=warn, continuing" in out


def test_healthy_run_is_unchanged_by_the_guard(tmp_path):
    """The probe reads the fields; it changes no value written."""
    kw = dict(dt=1.0, noise=0.1)
    a = driver.main([_config(tmp_path / "a.toml", **kw,
                             output=str(tmp_path / "a.bp"))])
    b = driver.main([_config(tmp_path / "b.toml", **kw, health_policy="off",
                             output=str(tmp_path / "b.bp"))])
    for x, y in zip(a.get_fields(), b.get_fields()):
        np.testing.assert_array_equal(x, y)
    with BpReader(str(tmp_path / "a.bp")) as ra, \
            BpReader(str(tmp_path / "b.bp")) as rb:
        np.testing.assert_array_equal(ra.get("V", step=1),
                                      rb.get("V", step=1))


@pytest.mark.parametrize("value", ["explode", "rollback"])
def test_unknown_policy_and_rollback_raise_at_start_up(tmp_path, value):
    cfg = _config(tmp_path / "cfg.toml", health_policy=value, dt=1.0)
    with pytest.raises(ValueError, match="health policy"):
        driver.main([cfg])
    assert not (tmp_path / "gs.bp").exists()


def test_env_wins_over_the_key(monkeypatch):
    monkeypatch.setenv("GS_HEALTH_POLICY", "WARN")
    assert health.resolve_policy(Settings(health_policy="off")) == "warn"
    monkeypatch.delenv("GS_HEALTH_POLICY")
    assert health.resolve_policy(Settings(health_policy="off")) == "off"
    assert health.resolve_policy(Settings()) == "abort"
    monkeypatch.setenv("GS_HEALTH_POLICY", "rollback")
    # rollback acts under supervision and raises without it.
    monkeypatch.delenv("GS_SUPERVISE", raising=False)
    with pytest.raises(ValueError, match="arm supervision"):
        health.resolve_policy(Settings())
    assert health.resolve_policy(Settings(supervise=True)) == "rollback"
    monkeypatch.setenv("GS_SUPERVISE", "1")
    assert health.resolve_policy(Settings()) == "rollback"


def test_snapshot_fuses_the_probe():
    sim = Simulation(Settings(L=8, noise=0.1, backend="CPU",
                              precision="Float32"))
    sim.iterate(3)
    snap = sim.snapshot(health=True)
    u, v = sim.get_fields()
    report = snap.health
    assert report.finite and report.names == ("u", "v")
    assert report.ranges == ((float(u.min()), float(u.max())),
                             (float(v.min()), float(v.max())))
    assert sim.snapshot().health is None


def test_probe_over_a_mesh_reduces_every_block():
    s = Settings(L=8, noise=0.1, backend="CPU", precision="Float32")
    mesh = Simulation(s, n_devices=8)
    mesh.iterate(2)
    one = Simulation(s)
    one.iterate(2)
    a, b = mesh.snapshot(health=True).health, one.snapshot(health=True).health
    assert a.finite and a.ranges == b.ranges
    mesh.blocks[5] = (mesh.blocks[5][0].clone().fill_(math.nan),
                      mesh.blocks[5][1])
    bad = mesh.snapshot(health=True).health
    assert not bad.finite and math.isnan(bad.u_min)
    assert bad.ranges[1] == a.ranges[1]


def test_device_probe_matches_the_reference_probe():
    """finite AND over every field, then (min, max) per field, as the
    reference's device_probe; NaN propagates into the range."""
    from grayscott_jl_tpu.resilience.health import device_probe as ref_probe
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    fields = [rng.random((4, 5, 6)).astype(np.float32) for _ in range(3)]
    fields[1][2, 3, 4] = np.inf
    got = health.device_probe(*(torch.from_numpy(f) for f in fields))
    want = ref_probe(*(jnp.asarray(f) for f in fields))
    assert got.tolist() == [float(w) for w in want]


def test_guard_check_policies():
    good = health.HealthReport(True, 0.0, 1.0, 0.0, 1.0)
    bad = health.HealthReport(False, math.nan, math.nan, 0.0, 1.0)
    assert health.HealthGuard("abort").check(3, good) is None
    with pytest.raises(HealthError, match="step 3"):
        health.HealthGuard("abort").check(3, bad)
    event = health.HealthGuard("warn").check(3, bad)
    assert event["action"] == "continued" and event["finite"] is False
    assert health.HealthGuard("off").check(3, bad) is None
    assert not health.HealthGuard("off").enabled
    # rollback raises for the supervisor, which reads the policy.
    with pytest.raises(HealthError, match="policy=rollback") as e:
        health.HealthGuard("rollback").check(3, bad)
    assert e.value.policy == "rollback"
    with pytest.raises(ValueError):
        health.HealthGuard("restart")


@pytest.mark.parametrize("depth", [0, 2])
def test_f1_holds_at_every_pipeline_depth(tmp_path, monkeypatch, depth):
    """The guard acts on the driver thread before a step is submitted
    to the output pipeline: at depth 0 and 2 alike, abort raises at step
    10 with no step written, and warn writes both NaN steps."""
    monkeypatch.setenv("GS_ASYNC_IO_DEPTH", str(depth))
    (tmp_path / "abort").mkdir()
    (tmp_path / "warn").mkdir()
    with pytest.raises(HealthError) as e:
        driver.main([_config(tmp_path / "abort" / "cfg.toml",
                             output=str(tmp_path / "abort" / "gs.bp"))])
    assert e.value.step == 10
    assert _steps(str(tmp_path / "abort" / "gs.bp")) == 0
    driver.main([_config(tmp_path / "warn" / "cfg.toml", health_policy="warn",
                         output=str(tmp_path / "warn" / "gs.bp"))])
    assert _steps(str(tmp_path / "warn" / "gs.bp")) == 2


@pytest.mark.parametrize("depth", [0, 2])
def test_a_later_blow_up_keeps_the_healthy_steps(tmp_path, monkeypatch,
                                                 depth):
    """Steps accepted before the poisoned boundary are drained into the
    store before the HealthError leaves (dt = 10 turns the fields
    non-finite at step 9): the store holds steps 2..8, not step 10."""
    monkeypatch.setenv("GS_ASYNC_IO_DEPTH", str(depth))
    with pytest.raises(HealthError) as e:
        driver.main([_config(tmp_path / "cfg.toml", dt=10.0, plotgap=2)])
    assert e.value.step == 10
    with BpReader(str(tmp_path / "gs.bp")) as r:
        assert [int(r.get("step", step=i))
                for i in range(r.num_steps())] == [2, 4, 6, 8]
