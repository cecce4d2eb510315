"""The ``.vti`` series (grayscott_jl_tpu_torch/io/vtk.py, wired into
io/stream.py) against the reference's on the CPU: the port writes the
same files as the reference for the same run (values at the runs'
float32 tolerance, the rest exactly), each holding the store's values;
a mesh's blocks are assembled; coded fields are decoded; a restart
keeps the earlier frames; ``mesh_type`` other than ``"image"`` writes
none."""

import os
from pathlib import Path

import numpy as np
import pytest

from grayscott_jl_tpu import driver as ref_driver
from grayscott_jl_tpu.io import vtk as ref_vtk
from grayscott_jl_tpu_torch import driver
from grayscott_jl_tpu_torch.config.settings import parse_settings_toml
from grayscott_jl_tpu_torch.io import vtk
from grayscott_jl_tpu_torch.io.bplite import BpReader

BASE = dict(L=16, steps=20, plotgap=5, F=0.02, k=0.048, Du=0.2, Dv=0.1,
            dt=1.0, noise=0.1, precision="Float32", backend="CPU")


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


def _series(directory):
    return sorted(os.listdir(directory))


def test_series_matches_the_reference_and_holds_the_store(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref_driver.main([_config(tmp_path / "ref" / "cfg.toml",
                             output=str(tmp_path / "ref" / "gs.bp"))],
                    n_devices=1)
    driver.main([_config(tmp_path / "port" / "cfg.toml",
                         output=str(tmp_path / "port" / "gs.bp"))])
    ref_dir, port_dir = tmp_path / "ref" / "gs.vtk", tmp_path / "port" / "gs.vtk"
    names = _series(port_dir)
    assert names == _series(ref_dir) == [
        "series.pvd", "step_0000005.vti", "step_0000010.vti",
        "step_0000015.vti", "step_0000020.vti"]
    assert (port_dir / "series.pvd").read_text() == (
        ref_dir / "series.pvd").read_text()
    with BpReader(str(tmp_path / "port" / "gs.bp")) as store:
        for i, name in enumerate(names[1:]):
            extent, got = vtk.read_vti(str(port_dir / name))
            ref_extent, want = vtk.read_vti(str(ref_dir / name))
            assert extent == ref_extent == ((0, 16),) * 3
            assert sorted(got) == sorted(want) == ["U", "V"]
            for var in ("U", "V"):
                assert got[var].dtype == want[var].dtype == np.float32
                np.testing.assert_allclose(got[var], want[var], rtol=0,
                                           atol=1e-5)
                np.testing.assert_array_equal(got[var],
                                              store.get(var, step=i))


def test_write_vti_is_byte_identical_to_the_reference(tmp_path):
    rng = np.random.default_rng(5)
    arrays = [rng.random((4, 4, 4)).astype(np.float32) for _ in range(2)]
    vtk.write_vti(str(tmp_path / "a.vti"), 4, 3, *arrays)
    ref_vtk.write_vti(str(tmp_path / "b.vti"), 4, 3, *arrays)
    assert (tmp_path / "a.vti").read_bytes() == (
        tmp_path / "b.vti").read_bytes()
    ext, back = ref_vtk.read_vti(str(tmp_path / "a.vti"))
    assert ext == ((0, 4),) * 3
    np.testing.assert_array_equal(back["V"], arrays[1])


def test_mesh_blocks_are_assembled(tmp_path):
    one = tmp_path / "one"
    mesh = tmp_path / "mesh"
    one.mkdir()
    mesh.mkdir()
    driver.main([_config(one / "cfg.toml", L=12, output=str(one / "gs.bp"))])
    driver.main([_config(mesh / "cfg.toml", L=12,
                         output=str(mesh / "gs.bp"))], n_devices=8)
    for name in ("step_0000010.vti", "step_0000020.vti"):
        _, a = vtk.read_vti(str(one / "gs.vtk" / name))
        _, b = vtk.read_vti(str(mesh / "gs.vtk" / name))
        for var in ("U", "V"):
            np.testing.assert_array_equal(a[var], b[var])


def test_coded_fields_are_decoded(tmp_path):
    driver.main([_config(tmp_path / "cfg.toml", snapshot_bits="v:8")])
    with BpReader(str(tmp_path / "gs.bp")) as store:
        v = store.get("V", step=3)
        u = store.get("U", step=3)
    _, got = vtk.read_vti(str(tmp_path / "gs.vtk" / "step_0000020.vti"))
    np.testing.assert_array_equal(got["V"], v)
    np.testing.assert_array_equal(got["U"], u)


def test_bf16_fields_are_widened_to_float32(tmp_path):
    driver.main([_config(tmp_path / "cfg.toml", precision="BFloat16",
                         steps=5)])
    _, got = vtk.read_vti(str(tmp_path / "gs.vtk" / "step_0000005.vti"))
    with BpReader(str(tmp_path / "gs.bp")) as store:
        np.testing.assert_array_equal(got["U"], store.get("U", step=0))
    assert got["U"].dtype == np.float32


def test_restart_keeps_the_earlier_frames(tmp_path):
    ckpt = str(tmp_path / "ckpt.bp")
    driver.main([_config(tmp_path / "a.toml", steps=10, checkpoint=True,
                         checkpoint_freq=5, checkpoint_output=ckpt)])
    driver.main([_config(tmp_path / "b.toml", steps=20, restart=True,
                         restart_input=ckpt, restart_step=5)])
    pvd = (tmp_path / "gs.vtk" / "series.pvd").read_text()
    assert [f"step_{s:07d}.vti" in pvd for s in (5, 10, 15, 20)] == [True] * 4
    assert pvd.count("<DataSet") == 4


@pytest.mark.parametrize("mesh_type", ["image", "Image", "none"])
def test_mesh_type_selects_the_series(tmp_path, mesh_type):
    driver.main([_config(tmp_path / "cfg.toml", steps=5,
                         mesh_type=mesh_type)])
    assert (tmp_path / "gs.vtk").exists() == (mesh_type.lower() == "image")
    assert parse_settings_toml('L = 8').mesh_type == "image"
