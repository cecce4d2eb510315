"""A run of two processes on the CPU (grayscott_jl_tpu_torch/launch.py,
parallel/distributed.py, the multi-writer stores and the ``.pvti``
series): two real processes on gloo over 127.0.0.1, four CPU blocks
each, one (2,2,2) mesh whose process boundary cuts x.

The two-process store must be bitwise equal to the one-process 8-block
store of the same mesh (the noise is keyed by position, so the split
among processes changes nothing), within atol 1e-5 of the reference's
live single-device run (the tolerance of tests/test_torch_sharded.py),
open in the reference's merging reader, and its ``.pvti`` pieces must
reassemble to the store's arrays. Only process 0 logs ``info``, and a
restart from the two-writer checkpoint continues bitwise.

The sizes are those of tests/functional/test_multihost.py: L=16, 20
steps, plotgap 10, checkpoint every 10. Every process has a timeout of
120 s and the pair is killed on failure."""

import glob
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.io.bplite import BpReader as RefReader
from grayscott_jl_tpu.io.vtk import read_vti
from grayscott_jl_tpu.simulation import Simulation as RefSimulation
from grayscott_jl_tpu_torch import driver, launch
from grayscott_jl_tpu_torch.io.bplite import BpReader

REPO = Path(__file__).resolve().parents[1]

#: Seconds any process of these tests may run.
TIMEOUT = 120

BASE = dict(L=16, Du=0.2, Dv=0.1, F=0.02, k=0.048, dt=1.0, plotgap=10,
            steps=20, noise=0.1, checkpoint=True, checkpoint_freq=10,
            mesh_type="image", precision="Float32", backend="CPU",
            kernel_language="Plain", verbose=True)

#: Launch and test-harness variables that must not leak into a run.
LAUNCH_VARS = ("GS_TPU_COORDINATOR", "GS_TPU_NUM_PROCESSES",
               "GS_TPU_PROCESS_ID", "GS_TPU_DISTRIBUTED", "LOCAL_RANK",
               "LOCAL_WORLD_SIZE", "RANK", "WORLD_SIZE", "MASTER_ADDR",
               "MASTER_PORT", "GS_FUSE", "GS_TPU_MESH_DIMS",
               "GS_COMM_OVERLAP", "GS_TPU_STATS", "GS_LOG_FORMAT")


def write_config(d: Path, **kw) -> str:
    """``d/config.toml`` with the stores in ``d``."""
    d.mkdir(parents=True, exist_ok=True)
    base = dict(BASE, output=str(d / "out.bp"),
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
    (d / "config.toml").write_text("\n".join(lines) + "\n")
    return str(d / "config.toml")


def clean_env(extra=None) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env["PYTHONPATH"] = str(REPO)
    env.update(extra or {})
    return env


def run_pair(d: Path, cfg: str, extra=None, devices_per_proc=4):
    """The CLI on ``cfg`` as two processes through ``launch.py``; returns
    the combined output, asserting both exited 0."""
    log = d / "launch.log"
    with open(log, "w") as f:
        codes = launch.launch(2, cfg, devices_per_proc, env=clean_env(extra),
                              cwd=str(d), timeout=TIMEOUT, stdout=f,
                              stderr=subprocess.STDOUT)
    out = log.read_text()
    assert codes == [0, 0], out
    return out


def spawn_pair(d: Path, argv, extra=None, drop=()):
    """Two processes of ``argv`` with the launch variables (less
    ``drop``), each with its own output; returns ``[(code, stdout,
    stderr)]``. The pair is killed when either runs past the timeout."""
    port = launch.free_port()
    envs = [launch.process_env(r, 2, port, clean_env(extra))
            for r in range(2)]
    for env in envs:
        for var in drop:
            env.pop(var)
    procs = [subprocess.Popen(
        [sys.executable, *argv], cwd=str(d), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for env in envs]
    outs = []
    deadline = time.monotonic() + TIMEOUT
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def run_single(monkeypatch, d: Path, cfg: str, n=8, extra=None):
    """The same CLI run in this process, on ``n`` CPU blocks."""
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    for k, v in (extra or {}).items():
        monkeypatch.setenv(k, v)
    return driver.main([cfg], n_devices=n)


def store_steps(store, names):
    with BpReader(store) as r:
        return [(int(r.get("step", step=i)),
                 [r.get(n, step=i) for n in names])
                for i in range(r.num_steps())]


def assert_stores_bitwise(a, b, names):
    sa, sb = store_steps(a, names), store_steps(b, names)
    assert [s for s, _ in sa] == [s for s, _ in sb] and sa
    for (_, fa), (_, fb) in zip(sa, sb):
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def pair_run(tmp_path_factory):
    """The standard config on two processes, with JSON logs and stats."""
    d = tmp_path_factory.mktemp("pair")
    cfg = write_config(d)
    out = run_pair(d, cfg, extra={"GS_LOG_FORMAT": "json",
                                  "GS_TPU_STATS": str(d / "stats.json")})
    return d, out


@pytest.fixture(scope="module")
def single_run(tmp_path_factory):
    """The standard config in one process on the 8-block mesh."""
    d = tmp_path_factory.mktemp("single")
    cfg = write_config(d)
    with pytest.MonkeyPatch.context() as mp:
        run_single(mp, d, cfg)
    return d


@pytest.mark.parametrize("store,names", [("out.bp", ("U", "V")),
                                         ("ckpt.bp", ("u", "v"))])
def test_two_process_store_equals_one_process_store(pair_run, single_run,
                                                    store, names):
    d, _ = pair_run
    assert_stores_bitwise(str(single_run / store), str(d / store), names)
    with open(d / store / "md.json") as f:
        assert json.load(f)["nwriters"] == 2
    assert (d / store / "md.1.json").is_file()
    assert (d / store / "data.1").is_file()


def test_each_process_records_its_place(pair_run):
    d, _ = pair_run
    for rank in range(2):
        stats = json.loads((d / f"stats.json.rank{rank}").read_text())
        cfg = stats["config"]
        assert cfg["process_index"] == rank and cfg["process_count"] == 2
        assert cfg["backend"] == "gloo" and cfg["n_devices"] == 8
        assert cfg["mesh_dims"] == [2, 2, 2]
        # Only x crosses: the plain path's chain of depth 2 exchanges a
        # 2-deep slab of the 12x12 padded face per field, 4 blocks a
        # side, once every 2 steps; y and z stay inside each process.
        assert cfg["fuse"] == 2
        assert cfg["p2p"]["bytes"] == (20 // 2) * 4 * 2 * (2 * 12 * 12) * 4
    assert not (d / "stats.json").exists()


def test_two_process_store_matches_reference_live_run(pair_run):
    d, _ = pair_run
    ref = RefSimulation(RefSettings(
        **{k: v for k, v in BASE.items()
           if k not in ("checkpoint", "checkpoint_freq", "mesh_type",
                        "verbose")}), n_devices=1)
    with RefReader(str(d / "out.bp")) as r:
        for i in range(r.num_steps()):
            ref.iterate(10)
            for name, want in zip(("U", "V"), ref.get_fields()):
                np.testing.assert_allclose(r.get(name, step=i), want,
                                           rtol=0, atol=1e-5)


@pytest.mark.parametrize("store,names", [("out.bp", ("U", "V")),
                                         ("ckpt.bp", ("u", "v"))])
def test_reference_reader_merges_the_two_writers(pair_run, store, names):
    d, _ = pair_run
    mine = store_steps(str(d / store), names)
    with RefReader(str(d / store)) as r:
        assert r.num_steps() == len(mine) == 2
        for i, (step, fields) in enumerate(mine):
            assert int(r.get("step", step=i)) == step == 10 * (i + 1)
            for name, f in zip(names, fields):
                np.testing.assert_array_equal(r.get(name, step=i), f)
    with BpReader(str(d / store)) as r:
        assert [len(r.boxes(names[0], i)) for i in range(2)] == [8, 8]


@pytest.mark.parametrize("step", [10, 20])
def test_pvti_pieces_reassemble_to_the_store(pair_run, step):
    d, _ = pair_run
    vtk = d / "out.vtk"
    pieces = sorted(glob.glob(str(vtk / f"step_{step:07d}_b*.vti")))
    assert len(pieces) == 8
    index = (vtk / f"step_{step:07d}.pvti").read_text()
    assert sorted(re.findall(r'Source="([^"]+)"', index)) == sorted(
        os.path.basename(p) for p in pieces)
    assert 'WholeExtent="0 16 0 16 0 16"' in index
    arrays = {n: np.full((16,) * 3, np.nan, np.float32) for n in "UV"}
    for p in pieces:
        extent, fields = read_vti(p)
        box = tuple(slice(lo, hi) for lo, hi in extent)
        assert all(hi - lo == 8 for lo, hi in extent)
        for n in "UV":
            arrays[n][box] = fields[n]
    with BpReader(str(d / "out.bp")) as r:
        i = [int(r.get("step", step=k)) for k in range(r.num_steps())
             ].index(step)
        for n in "UV":
            np.testing.assert_array_equal(arrays[n], r.get(n, step=i))
    pvd = (vtk / "series.pvd").read_text()
    assert re.findall(r'file="([^"]+)"', pvd) == [
        "step_0000010.pvti", "step_0000020.pvti"]
    assert not glob.glob(str(vtk / "step_???????.vti"))


def test_only_process_zero_logs_info(pair_run):
    _, out = pair_run
    records = [json.loads(line) for line in out.splitlines()
               if line.startswith("{")]
    info = [r for r in records if r["level"] == "info"]
    assert info and {r["proc"] for r in info} == {0}
    writing = [r["msg"] for r in info if "writing output step" in r["msg"]]
    assert writing == ["Simulation at step 10 writing output step 1",
                       "Simulation at step 20 writing output step 2"]
    for rank in range(2):
        assert f"process {rank} of 2 started (gloo, CPU)" in out


def test_restart_from_the_two_writer_checkpoint_is_bitwise(
        tmp_path, monkeypatch):
    """A two-process run to step 20, restarted by two processes from its
    checkpoint to step 30, equals an uninterrupted 30-step run."""
    run = tmp_path / "run"
    cfg = write_config(run)
    run_pair(run, cfg)
    write_config(run, steps=30, restart=True,
                 restart_input=str(run / "ckpt.bp"))
    run_pair(run, cfg)
    whole = tmp_path / "whole"
    run_single(monkeypatch, whole, write_config(whole, steps=30))
    assert_stores_bitwise(str(whole / "out.bp"), str(run / "out.bp"),
                          ("U", "V"))
    assert_stores_bitwise(str(whole / "ckpt.bp"), str(run / "ckpt.bp"),
                          ("u", "v"))
    assert [s for s, _ in store_steps(str(run / "out.bp"), "U")] == [
        10, 20, 30]


def test_coded_output_across_processes_equals_one_process(tmp_path,
                                                          monkeypatch):
    """The lossy codec's range is global: each process quantizes its
    blocks with the min and max over every process's, so the coded
    two-writer store (payloads and ranges) equals the one-process
    one."""
    kw = dict(snapshot_bits="u:8,v:12", checkpoint=False)
    pair = tmp_path / "pair"
    run_pair(pair, write_config(pair, **kw))
    one = tmp_path / "one"
    run_single(monkeypatch, one, write_config(one, **kw))
    assert_stores_bitwise(str(one / "out.bp"), str(pair / "out.bp"),
                          ("U", "V", "U__qlo", "U__qhi", "V__qlo",
                           "V__qhi"))


def test_each_writer_checks_its_own_blocks(pair_run, tmp_path):
    """``GS_CKPT_VERIFY=full``'s read-back and the scrubber run per
    writer: a byte flipped in writer 1's payload of the last step is
    found by writer 1's read-back and scrub, not by writer 0's."""
    import shutil

    from grayscott_jl_tpu_torch.io.bplite import CorruptionError
    from grayscott_jl_tpu_torch.resilience import integrity

    d, _ = pair_run
    store = str(tmp_path / "ckpt.bp")
    shutil.copytree(d / "ckpt.bp", store)
    for w in range(2):
        integrity.verify_last_step(store, w, 2)
    with open(os.path.join(store, "data.1"), "r+b") as f:
        f.seek(-1, os.SEEK_END)
        byte = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([byte[0] ^ 1]))
    integrity.verify_last_step(store, 0, 2)
    with pytest.raises(CorruptionError, match="writer 1 step entry 1"):
        integrity.verify_last_step(store, 1, 2)
    clean = integrity.scrub_store(store, writers=[0], quarantine=False)
    assert clean["corrupt"] == [] and clean["steps_audited"] == 2
    bad = integrity.scrub_store(store, writers=[1], quarantine=False)
    assert bad["corrupt"] == [1] and bad["steps_audited"] == 2


def test_launch_times_probe_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``probes/launch_times.py``, the script that times a run of several
    processes against one process, on the CPU at L=16 with four
    processes of two blocks: its rows, and the stores bitwise."""
    from grayscott_jl_tpu_torch.probes import launch_times

    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    out = tmp_path / "times.json"
    assert launch_times.main(["--cpu", "--l", "16", "--steps", "50",
                              "--procs", "4", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [r["processes"] for r in rows] == [1, 4]
    assert all(r["bitwise"] for r in rows)
    for r in rows[1:]:
        assert r["backend"] == ["gloo"] * r["processes"]
        assert r["exchange_ms_per_step"] > 0 and r["ms_per_step"] > 0
    # On the CPU the kernels' plain versions run: no launch counted.
    assert all(x == {"modes": {}, "bands": 0}
               for r in rows for x in r["launches"])
    assert capsys.readouterr().out.count('"processes"') == 2
