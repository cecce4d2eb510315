"""The port's driver on a sharded mesh (grayscott_jl_tpu_torch/driver.py,
io/): a sharded CLI run writes one block per mesh position into each
store step; the store must serve the single-block run's arrays and
attributes bitwise and open in the reference's reader, and a
checkpoint must restart a run on another layout bitwise."""

import json
from pathlib import Path

import numpy as np
import pytest

from grayscott_jl_tpu.io.bplite import BpReader as RefReader
from grayscott_jl_tpu_torch import Simulation, driver
from grayscott_jl_tpu_torch.io import open_reader
from test_torch_driver import _config


def _steps(store, names=("U", "V")):
    with open_reader(store) as r:
        return [
            (int(r.get("step", step=i)), [r.get(n, step=i) for n in names])
            for i in range(r.num_steps())
        ]


def _assert_stores_equal(a, b):
    sa, sb = _steps(a), _steps(b)
    assert [s for s, _ in sa] == [s for s, _ in sb]
    for (_, fa), (_, fb) in zip(sa, sb):
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("L,dims,fuse", [(16, "2,2,2", "1"),
                                         (16, "2,2,2", "2"),
                                         (20, "3,1,1", "2")])
def test_sharded_cli_store_equals_single_block(tmp_path, monkeypatch, L,
                                               dims, fuse):
    (tmp_path / "one").mkdir()
    (tmp_path / "mesh").mkdir()
    monkeypatch.setenv("GS_FUSE", fuse)
    one = _config(tmp_path / "one" / "cfg.toml", L=L,
                  output=str(tmp_path / "one" / "gs.bp"))
    mesh = _config(tmp_path / "mesh" / "cfg.toml", L=L,
                   output=str(tmp_path / "mesh" / "gs.bp"))
    driver.main([one])
    n = int(np.prod([int(d) for d in dims.split(",")]))
    monkeypatch.setenv("GS_TPU_MESH_DIMS", dims)
    monkeypatch.setenv("GS_TPU_STATS", str(tmp_path / "stats.json"))
    sim = driver.main([mesh], n_devices=n)
    assert sim.sharded and sim.domain.n_blocks == n
    _assert_stores_equal(str(tmp_path / "one" / "gs.bp"),
                         str(tmp_path / "mesh" / "gs.bp"))
    ref_one = RefReader(str(tmp_path / "one" / "gs.bp"))
    ref_mesh = RefReader(str(tmp_path / "mesh" / "gs.bp"))
    assert ref_mesh.attributes() == ref_one.attributes()
    assert ref_mesh.num_steps() == 4
    u = ref_mesh.get("U", step=3)
    assert u.shape == (L,) * 3 and u.dtype == np.float32
    np.testing.assert_array_equal(u, ref_one.get("U", step=3))
    stats = json.loads(Path(tmp_path / "stats.json").read_text())
    assert stats["config"]["n_devices"] == n
    assert stats["config"]["mesh_dims"] == [int(d) for d in dims.split(",")]


@pytest.mark.parametrize("write_on,restart_on", [(1, 8), (8, 1), (8, 4)])
def test_restart_across_layouts_is_bitwise(tmp_path, monkeypatch, write_on,
                                           restart_on):
    """A checkpoint written on one layout restarts a run on another and
    reproduces the uninterrupted run's last step bitwise."""
    monkeypatch.setenv("GS_FUSE", "2")
    ckpt = str(tmp_path / "ckpt.bp")
    full = _config(tmp_path / "full.toml", checkpoint=True,
                   checkpoint_freq=10, checkpoint_output=ckpt)
    driver.main([full], n_devices=write_on)
    want = _steps(str(tmp_path / "gs.bp"))[-1]
    resumed = _config(tmp_path / "resume.toml", restart=True,
                      restart_input=ckpt, restart_step=10,
                      output=str(tmp_path / "resumed.bp"))
    sim = driver.main([resumed], n_devices=restart_on)
    assert sim.step == 20 and sim.domain.n_blocks == restart_on
    got = _steps(str(tmp_path / "resumed.bp"))[-1]
    assert got[0] == want[0] == 20
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)


def test_run_once_takes_a_sim_factory(tmp_path):
    """The factory places the mesh's blocks (here: four blocks on the
    one CPU device, as the smoke run puts eight on one card)."""
    from grayscott_jl_tpu_torch.config.settings import get_settings

    seen = {}

    def factory(settings, *, n_devices, seed):
        seen.update(n_devices=n_devices, seed=seed)
        return Simulation(settings, seed=seed, mesh_dims=(2, 2, 1),
                          devices=["cpu"] * 4)

    cfg = _config(tmp_path / "cfg.toml", steps=10)
    sim = driver.run_once(get_settings([cfg]), seed=5, sim_factory=factory)
    assert seen == {"n_devices": None, "seed": 5}
    assert sim.domain.dims == (2, 2, 1) and sim.step == 10
    single = Simulation(get_settings([cfg]), seed=5)
    single.iterate(10)
    for a, b in zip(single.get_fields(), sim.get_fields()):
        np.testing.assert_array_equal(a, b)
