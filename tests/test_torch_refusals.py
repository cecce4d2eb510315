"""The settings the reference acts on that the port accepted and
ignored (ROADMAP Queue 3, F3): each environment variable whose subsystem
is still to come raises at construction naming the ROADMAP item that
ports it, with its "off" values still running; one that its item has
since ported now acts (``GS_CKPT_VERIFY=full``, Queue 1 item 7 with
16b's device checksum, in the settings and in the reader; ``GS_EVENTS``,
``GS_METRICS`` and ``GS_TRACE``, item 21a: a run writes the sink;
``GS_PROFILE`` and ``GS_TPU_PROFILE``, item 21b: a run writes its
profiler capture;
``GS_DEVICE_BLOCKLIST``, item 17: a quarantined device is left out); and
``reshard = "off"`` / ``GS_RESHARD=off`` refuses a restore from a store
recorded on another mesh, as the reference does."""

from pathlib import Path

import numpy as np
import pytest
import torch

from grayscott_jl_tpu.config.settings import resolve_reshard as ref_resolve
from grayscott_jl_tpu.resilience import integrity as ref_integrity
from grayscott_jl_tpu_torch import Settings, Simulation, driver
from grayscott_jl_tpu_torch.config.settings import (NOT_PORTED_ENV,
                                                    resolve_reshard)
from grayscott_jl_tpu_torch.io import bplite
from grayscott_jl_tpu_torch.io.checkpoint import ReshardError
from grayscott_jl_tpu_torch.models import SettingsError
from grayscott_jl_tpu_torch.obs import events, metrics, trace
from grayscott_jl_tpu_torch.parallel.mesh import select_devices
from grayscott_jl_tpu_torch.resilience import integrity, sdc

#: The sinks Queue 1 item 21a ported: variable -> (the process-wide
#: sink, its reset).
SINKS = {"GS_EVENTS": (events.get_events, events.reset_events),
         "GS_METRICS": (metrics.get_metrics, metrics.reset_metrics),
         "GS_TRACE": (trace.get_tracer, trace.reset_tracer)}


@pytest.mark.parametrize("var,value,off,item", [
    ("GS_EVENTS", "/tmp/events.jsonl", "", "Queue 1 item 21a"),
    ("GS_METRICS", "/tmp/metrics.jsonl", "", "Queue 1 item 21a"),
    ("GS_TRACE", "/tmp/trace.json", "", "Queue 1 item 21a"),
    ("GS_PROFILE", "10:20", "", "Queue 1 item 21b"),
    ("GS_TPU_PROFILE", "/tmp/profile", "", "Queue 1 item 21b"),
    ("GS_DEVICE_BLOCKLIST", "cuda:1", "", "Queue 1 item 17"),
    ("GS_CKPT_VERIFY", "full", "read", "Queue 1 item 16b"),
])
def test_ignored_env_vars_now_raise_naming_the_item(var, value, off, item,
                                                    monkeypatch, tmp_path):
    if var in SINKS:
        # Ported by ``item``: a run writes the sink (in the test's own
        # directory, under the value's file name), and the "off" value
        # leaves it unarmed.
        assert var not in NOT_PORTED_ENV
        path = tmp_path / value.rsplit("/", 1)[1]
        monkeypatch.setenv(var, str(path))
        SINKS[var][1]()
        try:
            driver.main([_config(tmp_path / "c.toml")])
            assert SINKS[var][0]().enabled
        finally:
            SINKS[var][1]()
        assert path.is_file() and path.stat().st_size > 0
        monkeypatch.setenv(var, off)
        try:
            assert not SINKS[var][0]().enabled
        finally:
            SINKS[var][1]()
        return
    if var in ("GS_PROFILE", "GS_TPU_PROFILE"):
        # Ported by ``item``: the value acts. The window (10:20 over 20
        # steps, boundaries every 5) captures the rounds from steps 10
        # and 15; the whole-run capture writes its trace, with every
        # round; the "off" value writes none. Either way the stores are
        # the same.
        import json

        assert var not in NOT_PORTED_ENV
        out = tmp_path / ("profile" if var == "GS_PROFILE"
                          else value.rsplit("/", 1)[1])
        cfg = _config(tmp_path / "c.toml", steps=20)
        monkeypatch.setenv(var, value if var == "GS_PROFILE" else str(out))
        monkeypatch.setenv("GS_PROFILE_DIR", str(out))
        driver.main([cfg])
        (trace_file,) = out.iterdir()
        doc = json.loads(trace_file.read_text())
        rounds = sorted((e["name"] for e in doc["traceEvents"]
                         if e.get("name", "").startswith("gs_round")),
                        key=lambda n: int(n.rsplit("=", 1)[1]))
        assert rounds == [f"gs_round step={s}" for s in (
            (0, 5, 10, 15) if var == "GS_TPU_PROFILE" else (10, 15))]
        on = (tmp_path / "gs.bp" / "data.0").read_bytes()
        monkeypatch.setenv(var, off)
        monkeypatch.setenv("GS_PROFILE_DIR", str(tmp_path / "none"))
        driver.main([cfg])
        assert not (tmp_path / "none").exists()
        assert (tmp_path / "gs.bp" / "data.0").read_bytes() == on
        return
    if var == "GS_CKPT_VERIFY":
        # Ported by ``item``: the value acts. A snapshot carries the
        # device checksum and verifies its landed bytes against it.
        assert var not in NOT_PORTED_ENV
        monkeypatch.setenv(var, value)
        sim = Simulation(Settings(L=8, backend="CPU", noise=0.1))
        sim.iterate(1)
        assert integrity.resolve_config()["verify"] == value
        snap = sim.snapshot_async(checksum=True)
        assert set(snap.checksum_report()) == {"u", "v"}
        assert len(snap.blocks()) == 1
        monkeypatch.setenv(var, off)
        assert integrity.resolve_verify() == off
        return
    if var == "GS_DEVICE_BLOCKLIST":
        # Ported by ``item``: the value acts. A quarantined card is left
        # out of the mesh's devices (two cards, ``cuda:1`` quarantined:
        # one left), and quarantining the only device of a run refuses
        # to start it; the "off" value quarantines nothing.
        assert var not in NOT_PORTED_ENV
        monkeypatch.setenv(var, value)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        assert select_devices("cuda") == [torch.device("cuda", 0)]
        assert sdc.usable_devices("cuda") == [torch.device("cuda", 0)]
        with pytest.raises(ValueError, match="GS_DEVICE_BLOCKLIST=cuda:1"):
            select_devices("cuda", 2)
        Simulation(Settings(L=8, backend="CPU")).iterate(1)
        monkeypatch.setenv(var, "cpu")
        with pytest.raises(SettingsError, match="quarantined"):
            Simulation(Settings(L=8, backend="CPU"))
        monkeypatch.setenv(var, off)
        assert select_devices("cuda") == [torch.device("cuda", i)
                                          for i in range(2)]
        Simulation(Settings(L=8, backend="CPU")).iterate(1)
        return
    assert var in NOT_PORTED_ENV
    monkeypatch.setenv(var, value)
    with pytest.raises(SettingsError, match=f"{var}.*{item}"):
        Simulation(Settings(L=8, backend="CPU"))
    monkeypatch.setenv(var, off)
    Simulation(Settings(L=8, backend="CPU")).iterate(1)


@pytest.mark.parametrize("mode", ["off", "read", "full"])
def test_ckpt_verify_full_raises_in_the_reader(mode, monkeypatch, tmp_path):
    """Every mode of the reference is accepted now (``full`` no longer
    raises): ``read`` and ``full`` check each block's CRC on read,
    ``off`` does not; a value outside the modes still raises."""
    monkeypatch.setenv("GS_CKPT_VERIFY", mode)
    assert bplite.resolve_verify() == mode
    assert bplite.VERIFY_MODES == ref_integrity.VERIFY_MODES
    store = str(tmp_path / "s.bp")
    w = bplite.BpWriter(store)
    w.define_variable("x", np.float32, (4,))
    w.begin_step()
    w.put("x", np.arange(4, dtype=np.float32))
    w.end_step()
    w.close()
    integrity.corrupt_store_byte(store)
    with bplite.BpReader(store) as r:
        if mode == "off":
            assert r.get("x", step=0).shape == (4,)
        else:
            with pytest.raises(bplite.CorruptionError, match="CRC"):
                r.get("x", step=0)
    monkeypatch.setenv("GS_CKPT_VERIFY", "sometimes")
    with pytest.raises(ValueError, match="GS_CKPT_VERIFY"):
        bplite.resolve_verify()


@pytest.mark.parametrize("key,env,want", [
    ("auto", None, "auto"), ("off", None, "off"), ("", None, "auto"),
    ("auto", "off", "off"), ("off", "1", "auto"), ("off", "FALSE", "off"),
])
def test_resolve_reshard_matches_the_reference(key, env, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("GS_RESHARD", raising=False)
    else:
        monkeypatch.setenv("GS_RESHARD", env)
    assert resolve_reshard(Settings(reshard=key)) == want
    assert ref_resolve(Settings(reshard=key)) == want


def test_resolve_reshard_refuses_other_values(monkeypatch):
    monkeypatch.setenv("GS_RESHARD", "sometimes")
    with pytest.raises(SettingsError, match="auto/off"):
        resolve_reshard(Settings())


def _config(path, **kw):
    base = dict(L=12, steps=10, plotgap=5, F=0.02, k=0.048, Du=0.2,
                Dv=0.1, dt=1.0, noise=0.1, precision="Float32",
                backend="CPU", output=str(path.parent / "gs.bp"))
    base.update(kw)
    lines = [f'{k} = "{v}"' if isinstance(v, str)
             else f"{k} = {'true' if v else 'false'}" if isinstance(v, bool)
             else f"{k} = {v}" for k, v in base.items()]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture
def mesh_checkpoint(tmp_path, monkeypatch):
    """A checkpoint written by a (2,2,2) mesh at step 5."""
    monkeypatch.delenv("GS_RESHARD", raising=False)
    ckpt = str(tmp_path / "ckpt.bp")
    driver.main([_config(tmp_path / "a.toml", checkpoint=True,
                         checkpoint_freq=5, checkpoint_output=ckpt)],
                n_devices=8)
    return ckpt


def _restart(tmp_path, ckpt, name, **kw):
    return _config(tmp_path / f"{name}.toml", restart=True,
                   restart_input=ckpt, restart_step=5,
                   output=str(tmp_path / f"{name}.bp"), **kw)


def test_reshard_off_refuses_another_layout(tmp_path, mesh_checkpoint):
    """The reference's refusal: the recorded layout (mesh dims and
    process count) against the run's."""
    with pytest.raises(ReshardError, match=r"mesh 2x2x2 \(1 process\(es\)\)"
                       r".*adopts 1x1x1 \(1 process\(es\)\).*reshard='off'"):
        driver.main([_restart(tmp_path, mesh_checkpoint, "one",
                              reshard="off")])


def test_gs_reshard_off_wins_over_the_key(tmp_path, mesh_checkpoint,
                                          monkeypatch):
    monkeypatch.setenv("GS_RESHARD", "off")
    with pytest.raises(ReshardError):
        driver.main([_restart(tmp_path, mesh_checkpoint, "env",
                              reshard="auto")])


def test_reshard_off_restores_the_same_layout_bitwise(tmp_path,
                                                      mesh_checkpoint):
    same = driver.main([_restart(tmp_path, mesh_checkpoint, "same",
                                 reshard="off")], n_devices=8)
    moved = driver.main([_restart(tmp_path, mesh_checkpoint, "moved")])
    assert same.step == moved.step == 10
    for a, b in zip(same.get_fields(), moved.get_fields()):
        np.testing.assert_array_equal(a, b)
