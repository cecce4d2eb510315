"""The driver's output pipeline and integrity layer on the CPU
(grayscott_jl_tpu_torch/driver.py with io/async_writer.py and
resilience/integrity.py), against the reference's driver where it runs
the same configuration: the CLI's stores at ``GS_ASYNC_IO_DEPTH`` 0 and
2 are byte-identical, on one block and on a (2,2,2) mesh, and match the
reference's store at the ROADMAP tolerance (atol 1e-5, the XLA:CPU FMA
drift); a bad depth raises as the reference does; ``GS_CKPT_VERIFY=full``
with the bitflip hook raises ``CorruptionError`` before the boundary
reaches any store; with ``GS_CKPT_REPLICAS=2`` a restart from a
corrupted primary fails over and is bitwise equal to the uninterrupted
run; ``GS_SCRUB=1`` quarantines a corrupted entry mid-run."""

import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from grayscott_jl_tpu import driver as ref_driver
from grayscott_jl_tpu.io.bplite import BpReader as RefReader
from grayscott_jl_tpu_torch import Simulation, driver
from grayscott_jl_tpu_torch.config.settings import parse_settings_toml
from grayscott_jl_tpu_torch.io import vtk
from grayscott_jl_tpu_torch.io.async_writer import AsyncIOError
from grayscott_jl_tpu_torch.io.bplite import BpReader
from grayscott_jl_tpu_torch.io.checkpoint import latest_durable_step
from grayscott_jl_tpu_torch.resilience import integrity
from grayscott_jl_tpu_torch.resilience.integrity import CorruptionError

BASE = dict(L=16, steps=20, plotgap=5, F=0.02, k=0.048, Du=0.2, Dv=0.1,
            dt=1.0, noise=0.1, precision="Float32", backend="CPU",
            kernel_language="Pallas", checkpoint=True, checkpoint_freq=10)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("GS_ASYNC_IO_DEPTH", "GS_TPU_NATIVE_IO", "GS_CKPT_REPLICAS",
                "GS_CKPT_VERIFY", "GS_SCRUB", "GS_SCRUB_EVERY",
                "GS_TPU_STATS"):
        monkeypatch.delenv(var, raising=False)


def _config(d: Path, **kw):
    d.mkdir(parents=True, exist_ok=True)
    base = dict(BASE, output=str(d / "gs.bp"),
                checkpoint_output=str(d / "ckpt.bp"))
    base.update(kw)
    lines = []
    for key, value in base.items():
        if isinstance(value, bool):
            lines.append(f"{key} = {'true' if value else 'false'}")
        elif isinstance(value, str):
            lines.append(f'{key} = "{value}"')
        else:
            lines.append(f"{key} = {value}")
    (d / "cfg.toml").write_text("\n".join(lines) + "\n")
    return str(d / "cfg.toml")


def _tree(d: Path):
    """Every file the run wrote under ``d`` (the stores and the .vti
    series), by relative path."""
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*"))
            if p.is_file() and p.suffix not in (".toml", ".json")
            or p.name in ("md.json", "integrity.json", "quarantine.json")}


def _steps(store):
    with BpReader(store) as r:
        return [int(r.get("step", step=i)) for i in range(r.num_steps())]


def _stats(monkeypatch, d: Path):
    path = d / "stats.json"
    monkeypatch.setenv("GS_TPU_STATS", str(path))
    return path


@pytest.mark.parametrize("n_devices", [None, 8], ids=["block", "mesh"])
def test_depths_write_byte_identical_stores_matching_the_reference(
        tmp_path, monkeypatch, n_devices):
    trees = {}
    for depth in (0, 2):
        monkeypatch.setenv("GS_ASYNC_IO_DEPTH", str(depth))
        d = tmp_path / f"d{depth}"
        stats = _stats(monkeypatch, d)
        sim = driver.main([_config(d)], n_devices=n_devices)
        assert sim.domain.n_blocks == (n_devices or 1)
        trees[depth] = _tree(d)
        summary = json.loads(stats.read_text())
        cfg = summary["config"]
        assert cfg["async_io_depth"] == depth
        assert cfg["io_engine"] == "native"
        assert cfg["integrity"] == {"replicas": 1, "verify": "read",
                                    "scrub": False, "scrub_every": 1}
        io = summary["io"]
        assert io["depth"] == depth
        assert io["steps_accepted"] == io["steps_written"] == 4
        # The copies land on the writer thread only when it runs.
        assert set(io["busy_s"]) == {"output", "checkpoint"} | (
            {"device_to_host"} if depth else set())
        assert io["hidden_total_s"] + io["exposed_total_s"] == (
            pytest.approx(sum(io["busy_s"].values()), abs=1e-5))
        if depth == 0:
            assert io["hidden_total_s"] == 0.0
    assert sorted(trees[0]) == sorted(trees[2])
    assert "gs.bp/md.json" in trees[0] and "ckpt.bp/data.0" in trees[0]
    assert any(name.endswith(".vti") for name in trees[0])
    for name in trees[0]:
        assert trees[0][name] == trees[2][name], name
    # The reference's driver on the same configuration.
    ref = tmp_path / "ref"
    ref_driver.main([_config(ref)], n_devices=n_devices or 1)
    with RefReader(str(ref / "gs.bp")) as a, \
            RefReader(str(tmp_path / "d2" / "gs.bp")) as b:
        assert a.attributes() == b.attributes()
        assert a.num_steps() == b.num_steps() == 4
        for i in range(4):
            assert int(a.get("step", step=i)) == int(b.get("step", step=i))
            for name in ("U", "V"):
                np.testing.assert_allclose(b.get(name, step=i),
                                           a.get(name, step=i),
                                           rtol=0, atol=1e-5)


def test_python_engine_stores_equal_the_native_engines(tmp_path,
                                                       monkeypatch):
    """``GS_TPU_NATIVE_IO=0`` writes with the Python engine: the same
    payloads and sidecars, the same metadata."""
    for engine in ("1", "0"):
        monkeypatch.setenv("GS_TPU_NATIVE_IO", engine)
        d = tmp_path / f"e{engine}"
        stats = _stats(monkeypatch, d)
        driver.main([_config(d)])
        assert json.loads(stats.read_text())["config"]["io_engine"] == (
            "native" if engine == "1" else "python")
    a, b = _tree(tmp_path / "e1"), _tree(tmp_path / "e0")
    assert sorted(a) == sorted(b)
    for name in a:
        if name.endswith("md.json"):
            assert json.loads(a[name]) == json.loads(b[name])
        else:
            assert a[name] == b[name], name


@pytest.mark.parametrize("depth", [0, 2])
def test_vti_writes_run_on_the_writer_thread(tmp_path, monkeypatch, depth):
    threads = []
    real = vtk.write_vti

    def spy(*a, **kw):
        threads.append(threading.current_thread())
        return real(*a, **kw)

    monkeypatch.setattr(vtk, "write_vti", spy)
    monkeypatch.setenv("GS_ASYNC_IO_DEPTH", str(depth))
    driver.main([_config(tmp_path)])
    assert len(threads) == 4
    on_driver = {t is threading.main_thread() for t in threads}
    assert on_driver == {depth == 0}


@pytest.mark.parametrize("value", ["-1", "abc"])
def test_bad_depth_raises_as_the_reference(tmp_path, monkeypatch, value):
    monkeypatch.setenv("GS_ASYNC_IO_DEPTH", value)
    with pytest.raises(ValueError) as ref:
        ref_driver.main([_config(tmp_path / "ref")], n_devices=1)
    with pytest.raises(ValueError) as ours:
        driver.main([_config(tmp_path / "port")])
    assert str(ours.value) == str(ref.value)
    assert "GS_ASYNC_IO_DEPTH" in str(ours.value) or "non-negative" in str(
        ours.value)
    # Refused before any store was opened.
    assert not (tmp_path / "port" / "gs.bp").exists()


class _FlipAt(Simulation):
    """A simulation whose snapshot at ``FLIP_STEP`` goes through the
    bitflip hook (the boundary's bytes silently wrong)."""

    FLIP_STEP = 10

    def snapshot_async(self, **kw):
        if self.step == self.FLIP_STEP and kw.get("exact", True):
            kw["bitflip"] = True
        return super().snapshot_async(**kw)


@pytest.mark.parametrize("depth", [0, 2])
def test_verify_full_stops_the_bitflip_before_any_store(tmp_path,
                                                        monkeypatch, depth):
    monkeypatch.setenv("GS_CKPT_VERIFY", "full")
    monkeypatch.setenv("GS_ASYNC_IO_DEPTH", str(depth))
    settings = parse_settings_toml(Path(_config(tmp_path)).read_text())
    with pytest.raises((CorruptionError, AsyncIOError)) as e:
        driver.run_once(settings, sim_factory=lambda s, **kw: _FlipAt(s,
                                                                      **kw))
    err = e.value if depth == 0 else e.value.original
    assert isinstance(err, CorruptionError)
    if depth:
        assert e.value.step == 10
    assert err.step == 10 and err.var == "u"
    assert "checksum mismatch" in str(err)
    # Step 5 is written with its device checksums; step 10 reached no
    # store, and nothing after it was written.
    assert _steps(str(tmp_path / "gs.bp")) == [5]
    assert _steps(str(tmp_path / "ckpt.bp")) == []
    side = json.loads((tmp_path / "gs.bp" / "integrity.json").read_text())
    assert set(side["device"][0]) == {"u", "v"}


def test_verify_full_records_checksums_and_reads_back(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("GS_CKPT_VERIFY", "full")
    stats = _stats(monkeypatch, tmp_path)
    sim = driver.main([_config(tmp_path)])
    assert json.loads(stats.read_text())["config"]["integrity"][
        "verify"] == "full"
    side = json.loads((tmp_path / "ckpt.bp" / "integrity.json").read_text())
    snap = sim.snapshot_async(checksum=True)
    assert side["device"][-1] == snap.checksum_report()
    assert integrity.verify_store(str(tmp_path / "ckpt.bp"))["corrupt"] == []


@pytest.mark.parametrize("depth", [0, 2])
def test_replicas_fail_over_and_restart_bitwise(tmp_path, monkeypatch,
                                                depth):
    monkeypatch.setenv("GS_CKPT_REPLICAS", "2")
    monkeypatch.setenv("GS_ASYNC_IO_DEPTH", str(depth))
    run = tmp_path / "run"
    driver.main([_config(run)])
    ckpt = str(run / "ckpt.bp")
    assert _steps(ckpt) == _steps(ckpt + ".r1") == [10, 20]
    info = integrity.corrupt_store_byte(ckpt)
    assert info["step_index"] == 1
    stats = _stats(monkeypatch, tmp_path / "resume")
    resumed = driver.main([_config(
        tmp_path / "resume", steps=30, restart=True, restart_input=ckpt,
        checkpoint=False)])
    events = json.loads(stats.read_text())["config"]["integrity"]["events"]
    whole = driver.main([_config(tmp_path / "whole", steps=30,
                                 checkpoint=False)])
    assert resumed.step == whole.step == 30
    for a, b in zip(resumed.get_fields(), whole.get_fields()):
        np.testing.assert_array_equal(a, b)
    assert events[0]["event"] == "replica_failover"
    assert events[0]["next"] == ckpt + ".r1"
    # With the mirror gone, the corrupt primary alone refuses loudly.
    import shutil

    shutil.rmtree(ckpt + ".r1")
    with pytest.raises(CorruptionError, match="CRC mismatch"):
        driver.main([_config(tmp_path / "again", steps=30, restart=True,
                             restart_input=ckpt, checkpoint=False)])


class _CorruptAt(Simulation):
    """A simulation that corrupts its primary checkpoint's step-10 entry
    once that entry is durable, before stepping on from step 10."""

    def iterate(self, nsteps=1):
        if self.step == 10:
            ckpt = self.settings.checkpoint_output
            deadline = time.monotonic() + 30
            while latest_durable_step(ckpt) != 10:
                assert time.monotonic() < deadline, "step 10 never landed"
                time.sleep(0.01)
            info = integrity.corrupt_store_byte(ckpt)
            assert info["step_index"] == 1
        super().iterate(nsteps)


@pytest.mark.parametrize("depth", [0, 2])
def test_scrub_quarantines_a_corrupted_entry_mid_run(tmp_path, monkeypatch,
                                                     depth):
    monkeypatch.setenv("GS_SCRUB", "1")
    monkeypatch.setenv("GS_ASYNC_IO_DEPTH", str(depth))
    stats = _stats(monkeypatch, tmp_path)
    settings = parse_settings_toml(Path(_config(
        tmp_path, checkpoint_freq=5)).read_text())
    driver.run_once(settings, sim_factory=lambda s, **kw: _CorruptAt(s, **kw))
    ckpt = str(tmp_path / "ckpt.bp")
    assert integrity.read_quarantine(ckpt) == {1}
    assert _steps(ckpt) == [5, 15, 20]  # the reader hides the entry
    with RefReader(ckpt) as r:
        assert r.num_steps() == 3
    cfg = json.loads(stats.read_text())["config"]["integrity"]
    assert cfg["scrub"] is True and cfg["corrupt_found"] == 1
    assert cfg["audits"] == 4
    kinds = [e["event"] for e in cfg["events"]]
    assert kinds.count("corruption") == 1 and kinds.count("scrub") == 4
