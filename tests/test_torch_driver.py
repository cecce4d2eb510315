"""The port's CLI driver, output store and checkpoint/restart against
the reference package on the CPU (grayscott_jl_tpu_torch/driver.py,
io/).

Stores are BP-lite in both packages: the port's store must open in the
reference's reader with identical attributes, and a checkpoint the
reference wrote must restart the port. Field values are compared at
atol 1e-5 (the float32 FMA-contraction drift of XLA:CPU over 20 steps,
see test_torch_stencil.py); within the port, restart is bitwise."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from grayscott_jl_tpu import driver as ref_driver
from grayscott_jl_tpu.io.bplite import BpReader as RefReader
from grayscott_jl_tpu_torch import driver, julia_main
from grayscott_jl_tpu_torch.io import open_reader
from grayscott_jl_tpu_torch.io.bplite import BpReader, CorruptionError
from grayscott_jl_tpu_torch.io.checkpoint import load_checkpoint
from grayscott_jl_tpu_torch.io.stream import fides_vtk_schemas
from grayscott_jl_tpu_torch.config.settings import parse_settings_toml

REPO = Path(__file__).resolve().parents[1]


def _config(path, **kw):
    base = dict(
        L=16, steps=20, plotgap=5, F=0.02, k=0.048, Du=0.2, Dv=0.1,
        dt=1.0, noise=0.1, precision="Float32", backend="CPU",
        kernel_language="Pallas", output=str(path.parent / "gs.bp"),
    )
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


def _last(store, names=("U", "V")):
    with open_reader(store) as r:
        i = r.num_steps() - 1
        return int(r.get("step", step=i)), [r.get(n, step=i) for n in names]


def test_cli_subprocess_writes_a_reference_readable_store(tmp_path):
    cfg = _config(tmp_path / "cfg.toml", checkpoint=True,
                  checkpoint_freq=10,
                  checkpoint_output=str(tmp_path / "ckpt.bp"))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "grayscott_jl_tpu_torch", cfg],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "seconds" in proc.stderr
    r = RefReader(str(tmp_path / "gs.bp"))
    assert r.num_steps() == 4
    assert [int(r.get("step", step=i)) for i in range(4)] == [5, 10, 15, 20]
    u = r.get("U", step=3)
    assert u.shape == (16, 16, 16) and u.dtype == np.float32
    assert np.isfinite(u).all() and -0.2 <= u.min() and u.max() <= 1.5
    c = RefReader(str(tmp_path / "ckpt.bp"))
    assert [int(c.get("step", step=i)) for i in range(2)] == [10, 20]


def test_store_attributes_and_values_match_reference_run(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref_cfg = _config(tmp_path / "ref" / "cfg.toml",
                      output=str(tmp_path / "ref" / "gs.bp"))
    port_cfg = _config(tmp_path / "port" / "cfg.toml",
                       output=str(tmp_path / "port" / "gs.bp"))
    ref_driver.main([ref_cfg], n_devices=1)
    driver.main([port_cfg])
    ref = RefReader(str(tmp_path / "ref" / "gs.bp"))
    port = RefReader(str(tmp_path / "port" / "gs.bp"))
    assert port.attributes() == ref.attributes()
    assert port.available_variables().keys() == ref.available_variables().keys()
    assert port.num_steps() == ref.num_steps() == 4
    for i in range(4):
        assert int(port.get("step", step=i)) == int(ref.get("step", step=i))
        for name in ("U", "V"):
            np.testing.assert_allclose(port.get(name, step=i),
                                       ref.get(name, step=i),
                                       rtol=0, atol=1e-5)


def test_reference_checkpoint_restarts_the_port(tmp_path):
    (tmp_path / "ref").mkdir()
    ckpt = str(tmp_path / "ref" / "ckpt.bp")
    ref_cfg = _config(tmp_path / "ref" / "cfg.toml", checkpoint=True,
                      checkpoint_freq=10, checkpoint_output=ckpt,
                      output=str(tmp_path / "ref" / "gs.bp"))
    ref_driver.main([ref_cfg], n_devices=1)
    port_cfg = _config(tmp_path / "restart.toml", restart=True,
                       restart_input=ckpt, restart_step=10,
                       output=str(tmp_path / "port.bp"))
    sim = driver.main([port_cfg])
    assert sim.step == 20
    step, (u, v) = _last(str(tmp_path / "port.bp"))
    with RefReader(str(tmp_path / "ref" / "gs.bp")) as r:
        ref_u, ref_v = r.get("U", step=3), r.get("V", step=3)
    assert step == 20
    np.testing.assert_allclose(u, ref_u, rtol=0, atol=1e-5)
    np.testing.assert_allclose(v, ref_v, rtol=0, atol=1e-5)


def test_port_restart_is_bitwise(tmp_path):
    ckpt = str(tmp_path / "ckpt.bp")
    full = _config(tmp_path / "full.toml", checkpoint=True,
                   checkpoint_freq=10, checkpoint_output=ckpt)
    driver.main([full])
    _, want = _last(str(tmp_path / "gs.bp"))
    fields = load_checkpoint(ckpt, parse_settings_toml(
        Path(full).read_text()), restart_step=10)
    assert fields[-1] == 10
    resumed = _config(tmp_path / "resume.toml", restart=True,
                      restart_input=ckpt, restart_step=10,
                      output=str(tmp_path / "resumed.bp"))
    driver.main([resumed])
    step, got = _last(str(tmp_path / "resumed.bp"))
    assert step == 20
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_restart_refuses_mismatched_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt.bp")
    driver.main([_config(tmp_path / "a.toml", checkpoint=True,
                         checkpoint_freq=10, checkpoint_output=ckpt)])
    bad = _config(tmp_path / "b.toml", restart=True, restart_input=ckpt,
                  precision="Float64", output=str(tmp_path / "b.bp"))
    with pytest.raises(ValueError, match="precision"):
        driver.main([bad])
    missing = _config(tmp_path / "c.toml", restart=True,
                      restart_input=ckpt, restart_step=7,
                      output=str(tmp_path / "c.bp"))
    with pytest.raises(ValueError, match="available steps"):
        driver.main([missing])


def test_reader_detects_corrupt_payload(tmp_path):
    driver.main([_config(tmp_path / "a.toml", steps=5)])
    store = tmp_path / "gs.bp"
    data = bytearray((store / "data.0").read_bytes())
    data[-3] ^= 0xFF
    (store / "data.0").write_bytes(bytes(data))
    with BpReader(str(store)) as r:
        with pytest.raises(CorruptionError, match="CRC mismatch"):
            r.get("V", step=0)


def test_julia_main_exit_codes(tmp_path):
    assert julia_main([str(tmp_path / "cfg.yaml")]) == 1
    cfg = _config(tmp_path / "ok.toml", steps=2, plotgap=1)
    assert julia_main([cfg]) == 0


def test_fides_schema_names_the_fields():
    attrs = fides_vtk_schemas(8, ["U", "V"])
    assert attrs["Fides_Variable_List"] == ["U", "V"]
    assert 'WholeExtent="0 8 0 8 0 8"' in attrs["vtk.xml"]
