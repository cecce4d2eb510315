"""Ensemble runs through the port's CLI driver on the CPU
(``python -m grayscott_jl_tpu_torch``, ``driver.main``), held against
solo port runs of each member and against the reference's driver.

* ``examples/settings-ensemble-phases.toml`` (``backend = "CPU"``, its
  depth cut) writes ``gs.m00.bp`` .. ``gs.m04.bp`` with their ``.vtk``
  series and checkpoint stores, each byte-equal to a solo port run of
  that member and readable by the reference's ``BpReader``.
* The member stores of a (2,2,2) mesh run equal the solo mesh runs'; the
  member stores' attributes equal the reference's member stores'.
* ``RunStats``: the ensemble section and the aggregate cell-updates/s.
* ``GS_FAULT_MEMBER``: a ``nan`` named in the report, the
  ``HealthError``, the journal and ``RunStats``; a ``bitflip`` named in
  the ``CorruptionError``.
* Chaos scenario 4 and the ensemble half of scenario 5.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from grayscott_jl_tpu import driver as ref_driver
from grayscott_jl_tpu.io.bplite import BpReader as RefReader

from grayscott_jl_tpu_torch import chaos, driver
from grayscott_jl_tpu_torch.config.settings import get_settings
from grayscott_jl_tpu_torch.ensemble.io import member_path, member_settings
from grayscott_jl_tpu_torch.io.bplite import BpReader

REPO = Path(__file__).resolve().parents[1]
PHASES = REPO / "examples" / "settings-ensemble-phases.toml"
RUN_VARS = ("GS_FAULTS", "GS_FAULT_MEMBER", "GS_FAULT_JOURNAL",
            "GS_SUPERVISE", "GS_TPU_STATS", "GS_CKPT_VERIFY",
            "GS_CKPT_REPLICAS", "GS_HEALTH_POLICY", "GS_AUTOTUNE")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch, tmp_path):
    for var in RUN_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("GS_AUTOTUNE_CACHE", str(tmp_path / "tune"))


def write_config(path, presets, **kw):
    """A TOML config at ``path`` with an ``[ensemble]`` of ``presets``
    and its stores beside it."""
    d = path.parent
    d.mkdir(parents=True, exist_ok=True)
    base = dict(L=16, steps=10, plotgap=5, Du=0.2, Dv=0.1, dt=1.0,
                noise=0.1, precision="Float32", backend="CPU",
                checkpoint=True, checkpoint_freq=5,
                output=str(d / "gs.bp"), checkpoint_output=str(d / "ckpt.bp"))
    base.update(kw)
    lines = []
    for key, value in base.items():
        if isinstance(value, bool):
            lines.append(f"{key} = {'true' if value else 'false'}")
        elif isinstance(value, str):
            lines.append(f'{key} = "{value}"')
        else:
            lines.append(f"{key} = {value}")
    lines += ["", "[ensemble]",
              "presets = [" + ", ".join(f'"{p}"' for p in presets) + "]"]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def member_stores(settings, k):
    """Member ``k``'s stores: output, ``.vtk`` series, checkpoint."""
    ms = member_settings(settings, k)
    return [ms.output, os.path.splitext(ms.output)[0] + ".vtk",
            ms.checkpoint_output]


def solo_run(settings, k, d, n_devices=None):
    """Member ``k`` as a solo run (seed ``k``) writing into ``d``."""
    ms = member_settings(settings, k)
    ms = dataclasses.replace(
        ms, output=str(d / os.path.basename(ms.output)),
        checkpoint_output=str(d / os.path.basename(ms.checkpoint_output)))
    d.mkdir(parents=True, exist_ok=True)
    driver.run_once(ms, seed=k, n_devices=n_devices)
    return [ms.output, os.path.splitext(ms.output)[0] + ".vtk",
            ms.checkpoint_output]


def assert_members_equal_solo(settings, tmp_path, n_devices=None):
    for k in range(settings.ensemble.n):
        solo = solo_run(settings, k, tmp_path / f"solo{k}", n_devices)
        for a, b in zip(member_stores(settings, k), solo):
            assert not chaos.trees_equal(a, b), (k, a)


def test_cli_runs_the_ensemble_phases_example(tmp_path):
    text = PHASES.read_text()
    # The example at its width, its depth and cadence cut.
    for old, new in (("steps = 5000", "steps = 20"),
                     ("plotgap = 100", "plotgap = 10"),
                     ("checkpoint_freq = 1000", "checkpoint_freq = 10"),
                     ('output = "gs.bp"', f'output = "{tmp_path / "gs.bp"}"'),
                     ('checkpoint_output = "ckpt.bp"',
                      f'checkpoint_output = "{tmp_path / "ckpt.bp"}"')):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    cfg = tmp_path / "phases.toml"
    cfg.write_text(text)
    # One compute thread: the test runs beside the suite's other workers.
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "grayscott_jl_tpu_torch",
                           str(cfg)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "for 5 ensemble members" in proc.stderr + proc.stdout
    settings = get_settings([str(cfg)])
    for k in range(5):
        for path in member_stores(settings, k):
            assert os.path.isdir(path), path
        with RefReader(member_path(settings.output, k, 5)) as r:
            assert r.num_steps() == 2
            assert np.isfinite(r.get("U", step=1)).all()
    assert not (tmp_path / "gs.bp").exists()
    assert_members_equal_solo(settings, tmp_path)


def test_mesh_member_stores_equal_solo_mesh_runs(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_FUSE", "2")
    cfg = write_config(tmp_path / "ens" / "cfg.toml",
                       ["spots", "stripes", "chaos"], kernel_language="Pallas")
    sim = driver.main([cfg], n_devices=8)
    assert sim.domain.dims == (2, 2, 2) and sim.n_members == 3
    assert_members_equal_solo(get_settings([cfg]), tmp_path, n_devices=8)


def test_member_stores_match_the_reference_stores(tmp_path, monkeypatch):
    """The same TOML through both drivers: each member store's
    attributes equal the reference's member store's, and its arrays
    agree within the ground rules' tolerance."""
    presets = ["spots", "chaos"]
    port_cfg = write_config(tmp_path / "port" / "cfg.toml", presets)
    ref_cfg = write_config(tmp_path / "ref" / "cfg.toml", presets)
    driver.main([port_cfg])
    ref_driver.main([ref_cfg], n_devices=1)
    ps, rs = get_settings([port_cfg]), get_settings([ref_cfg])
    for k in range(2):
        for store, names in ((0, ("U", "V")), (2, ("u", "v"))):
            a = member_stores(ps, k)[store]
            b = member_stores(rs, k)[store]
            with RefReader(a) as x, RefReader(b) as y:
                assert x.attributes() == y.attributes()
                assert x.num_steps() == y.num_steps() == 2
                for i in range(2):
                    for n in names:
                        d = np.abs(np.asarray(x.get(n, step=i), np.float64)
                                   - np.asarray(y.get(n, step=i)))
                        assert d.max() <= 1e-6


def test_runstats_ensemble_section(tmp_path, monkeypatch):
    presets = ["spots", "stripes", "chaos"]
    stats = {}
    for name, main in (("port", driver.main), ("ref", ref_driver.main)):
        cfg = write_config(tmp_path / name / "cfg.toml", presets)
        path = tmp_path / f"{name}.json"
        monkeypatch.setenv("GS_TPU_STATS", str(path))
        main([cfg], n_devices=1)
        stats[name] = json.loads(path.read_text())
    port, ref = stats["port"], stats["ref"]
    assert port["config"]["ensemble"] == ref["config"]["ensemble"] == {
        "members": 3, "member_shards": 1}
    for key in ("model", "members", "active_members", "member_shards",
                "params", "seeds"):
        assert port["ensemble"][key] == ref["ensemble"][key], key
    health = port["ensemble"]["health"]
    assert health["step"] == 10 and health["bad_members"] == []
    assert len(health["member_reports"]) == 3
    compute = port["phases_s"]["compute"]
    assert port["cell_updates_per_s"] == pytest.approx(
        16**3 * 10 * 3 / compute, rel=1e-3)


def test_fault_member_nan_is_named(tmp_path, monkeypatch):
    from grayscott_jl_tpu_torch.resilience.health import HealthError

    presets = ["spots", "stripes", "chaos"]
    monkeypatch.setenv("GS_FAULT_MEMBER", "1")
    monkeypatch.setenv("GS_FAULTS", "step=5:kind=nan")
    journal = tmp_path / "journal.jsonl"
    monkeypatch.setenv("GS_FAULT_JOURNAL", str(journal))
    cfg = write_config(tmp_path / "abort" / "cfg.toml", presets)
    with pytest.raises(HealthError, match=r"non-finite members=\[1\]"):
        driver.main([cfg])
    rec = [json.loads(line) for line in journal.read_text().splitlines()]
    health = [r for r in rec if r["event"] == "health"]
    assert health and health[0]["bad_members"] == [1]
    # Under warn the run goes on: RunStats carries the member.
    stats = tmp_path / "stats.json"
    monkeypatch.setenv("GS_TPU_STATS", str(stats))
    cfg = write_config(tmp_path / "warn" / "cfg.toml", presets,
                       health_policy="warn")
    driver.main([cfg])
    out = json.loads(stats.read_text())
    assert out["ensemble"]["health"]["bad_members"] == [1]
    assert any(f.get("bad_members") == [1] for f in out["faults"])
    with BpReader(str(tmp_path / "warn" / "gs.m00.bp")) as r:
        assert np.isfinite(r.get("U", step=1)).all()


def test_fault_member_bitflip_is_named(tmp_path, monkeypatch):
    from grayscott_jl_tpu_torch.io.async_writer import AsyncIOError
    from grayscott_jl_tpu_torch.io.bplite import CorruptionError

    monkeypatch.setenv("GS_FAULT_MEMBER", "2")
    monkeypatch.setenv("GS_FAULTS", "step=5:kind=bitflip")
    monkeypatch.setenv("GS_CKPT_VERIFY", "full")
    cfg = write_config(tmp_path / "e" / "cfg.toml",
                       ["spots", "stripes", "chaos"])
    with pytest.raises((CorruptionError, AsyncIOError), match="member 2"):
        driver.main([cfg])


def test_verified_replicated_member_stores_equal_solo(tmp_path, monkeypatch):
    """``GS_CKPT_VERIFY=full`` and two checkpoint replicas: each member's
    stores, sidecars and mirror equal a solo run's under the same
    variables."""
    monkeypatch.setenv("GS_CKPT_VERIFY", "full")
    monkeypatch.setenv("GS_CKPT_REPLICAS", "2")
    cfg = write_config(tmp_path / "ens" / "cfg.toml", ["spots", "chaos"])
    driver.main([cfg])
    settings = get_settings([cfg])
    assert_members_equal_solo(settings, tmp_path)
    for k in range(2):
        mirror = member_path(settings.checkpoint_output, k, 2) + ".r1"
        assert os.path.isdir(mirror)
        sidecar = json.loads(
            (Path(member_stores(settings, k)[0]) / "integrity.json")
            .read_text())
        assert sidecar


def test_snapshot_bits_are_ignored_with_a_warning(tmp_path, capsys):
    exact = write_config(tmp_path / "exact" / "cfg.toml", ["spots", "chaos"])
    coded = write_config(tmp_path / "coded" / "cfg.toml", ["spots", "chaos"],
                         snapshot_bits="8", verbose=True)
    driver.main([exact])
    driver.main([coded])
    out = capsys.readouterr()
    assert "snapshot_bits ignored for ensemble runs" in out.out + out.err
    for k in range(2):
        a = member_path(str(tmp_path / "exact" / "gs.bp"), k, 2)
        b = member_path(str(tmp_path / "coded" / "gs.bp"), k, 2)
        with BpReader(a) as x, BpReader(b) as y:
            for i in range(x.num_steps()):
                assert np.array_equal(x.get("U", step=i), y.get("U", step=i))


def test_chaos_ensemble_scenarios_on_the_cpu(tmp_path, capsys):
    """Chaos scenario 4 (a supervised ensemble preempted mid-sweep: every
    member store byte-identical) and scenario 5 with its ensemble half
    (resumed grown by one member)."""
    assert {4, 5} <= set(chaos.SCENARIOS)
    rc = chaos.main(["--backend", "CPU", "--L", "16", "--scenarios", "4,5",
                     "--seed", "3", "--workdir", str(tmp_path / "w")])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert rc == 0, lines
    assert [r["scenario"] for r in lines] == [4, 5]
    assert all(r["ok"] for r in lines), lines
    grown = tmp_path / "w" / "s5e"
    for k in range(3):
        assert (grown / f"gs.m0{k}.bp").is_dir()
    shutil.rmtree(tmp_path / "w")


def test_two_processes_equal_one(tmp_path):
    """An ensemble as two processes of four CPU blocks (``launch.py``,
    gloo; the per-member health reduced across them): every member
    store serves the one-process 8-block run's arrays."""
    presets = ["spots", "chaos"]
    cfg = write_config(tmp_path / "mp" / "cfg.toml", presets,
                       output="gs.bp", checkpoint_output="ckpt.bp")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               GS_AUTOTUNE_CACHE=str(tmp_path / "tune"))
    proc = subprocess.run([sys.executable, "-m",
                           "grayscott_jl_tpu_torch.launch", "2", cfg, "4"],
                          cwd=tmp_path / "mp", env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    one = write_config(tmp_path / "one" / "cfg.toml", presets)
    driver.main([one], n_devices=8)
    for k in range(2):
        for store, name in (("gs", "U"), ("ckpt", "u")):
            a = tmp_path / "mp" / f"{store}.m0{k}.bp"
            b = tmp_path / "one" / f"{store}.m0{k}.bp"
            with BpReader(str(a)) as x, BpReader(str(b)) as y:
                assert x.num_steps() == y.num_steps() == 2
                for i in range(2):
                    assert np.array_equal(x.get(name, step=i),
                                          y.get(name, step=i))
