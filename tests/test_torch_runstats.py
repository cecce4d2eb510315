"""ROADMAP Queue 3 F6 and F7: the compile cache acts, and ``RunStats``
carries the reference's keys.

F6: ``compile_cache`` / ``GS_COMPILE_CACHE`` resolve as the reference's
``resolve_compile_cache`` does, the resolved directory is where the
kernels (``ops/_build.py``, here with a stand-in ``nvcc`` that copies
its input) and the native store engine (``io/native.py``, with the real
``g++``) are built, ``Simulation.compile_cache_dir`` holds it and the
stats record it; ``off`` keeps the package's own build directories. On
the CPU a cache that was asked for is dropped with a warning unless
``GS_COMPILE_CACHE_FORCE=1``, as in the reference.

F7: for one TOML on the CPU, the port's ``RunStats.config`` keys contain
the reference's, both from live runs."""

import json
import os
import shutil
import stat
import textwrap

import pytest

from grayscott_jl_tpu import driver as ref_driver
from grayscott_jl_tpu.config import settings as ref_settings
from grayscott_jl_tpu_torch import Settings, Simulation, driver
from grayscott_jl_tpu_torch.config import settings
from grayscott_jl_tpu_torch.io import native
from grayscott_jl_tpu_torch.models import get_model
from grayscott_jl_tpu_torch.ops import _build, kernelgen
from test_torch_driver import _config

CACHE_VARS = ("GS_COMPILE_CACHE", "GS_COMPILE_CACHE_FORCE", "GS_SUPERVISE",
              "GS_AUTOTUNE", "GS_TPU_STATS")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for var in CACHE_VARS:
        monkeypatch.delenv(var, raising=False)
    # A Simulation points both builds at its cache: put them back after.
    monkeypatch.setattr(_build, "CACHE_DIR", None)
    monkeypatch.setattr(native, "CACHE_DIR", None)


def _stand_in_nvcc(tmp_path):
    """A CUDA root whose ``bin/nvcc`` copies its source to ``-o``."""
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(textwrap.dedent("""\
        #!/bin/sh
        out=""; src=""
        while [ $# -gt 0 ]; do
          case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac
          shift
        done
        cp "$src" "$out"
        """))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return cuda


@pytest.mark.parametrize("env,key,supervise,want", [
    (None, "", False, None),
    (None, "/tmp/gs_cache", False, "/tmp/gs_cache"),
    ("off", "/tmp/gs_cache", False, None),
    ("0", "", True, None),
    ("~/gs_cache", "", False, "~/gs_cache"),
    (None, "  no ", False, None),
    ("FALSE", "x", False, None),
])
def test_resolve_compile_cache_matches_the_reference(monkeypatch, env, key,
                                                     supervise, want):
    if env is not None:
        monkeypatch.setenv("GS_COMPILE_CACHE", env)
    port = settings.resolve_compile_cache(
        Settings(compile_cache=key, supervise=supervise))
    ref = ref_settings.resolve_compile_cache(
        ref_settings.Settings(compile_cache=key, supervise=supervise))
    assert port == ref == (os.path.expanduser(want) if want else None)


@pytest.mark.parametrize("sup_env", [None, "1"])
def test_compile_cache_defaults_on_under_supervision(monkeypatch, sup_env):
    """As in the reference, unset resolves to a directory under
    ``~/.cache`` when supervision is armed, so that a supervised run's
    restarted processes reuse their builds."""
    if sup_env is not None:
        monkeypatch.setenv("GS_SUPERVISE", sup_env)
    s = Settings(supervise=sup_env is None)
    got = settings.resolve_compile_cache(s)
    ref = ref_settings.resolve_compile_cache(
        ref_settings.Settings(supervise=sup_env is None))
    assert ref is not None and got is not None
    assert got.startswith(os.path.join(os.path.expanduser("~"), ".cache"))


@pytest.mark.parametrize("env,key,want", [
    (None, "", "cached"), (None, "off", "off"), ("OFF", "cached", "off"),
    ("quick", "", "quick"),
])
def test_resolve_autotune_matches_the_reference(monkeypatch, env, key,
                                                want):
    if env is not None:
        monkeypatch.setenv("GS_AUTOTUNE", env)
    assert settings.resolve_autotune(Settings(autotune=key)) == want
    assert ref_settings.resolve_autotune(
        ref_settings.Settings(autotune=key)) == want


def test_bad_autotune_raises_as_the_reference(monkeypatch):
    monkeypatch.setenv("GS_AUTOTUNE", "always")
    with pytest.raises(ValueError) as want:
        ref_settings.resolve_autotune(ref_settings.Settings())
    with pytest.raises(ValueError) as got:
        settings.resolve_autotune(Settings())
    assert str(got.value) == str(want.value)


def test_compile_cache_is_where_the_builds_go(tmp_path, monkeypatch,
                                             capsys):
    """``GS_COMPILE_CACHE=<dir>`` (forced on the CPU): the kernel built
    by a stand-in nvcc and the native store engine land in ``<dir>``,
    the simulation holds the path and the run's stats record it."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("GS_COMPILE_CACHE", str(cache))
    monkeypatch.setenv("GS_COMPILE_CACHE_FORCE", "1")
    monkeypatch.setenv("CUDA_HOME", str(_stand_in_nvcc(tmp_path)))
    sim = Simulation(Settings(L=8, backend="CPU"))
    assert sim.compile_cache_dir == str(cache)
    assert _build.build_dir() == str(cache)
    spec = kernelgen.get_spec(get_model("heat"))
    built = _build.build_all([spec])["heat"]
    assert os.path.dirname(built["path"]) == str(cache)
    names = [os.path.basename(built[k]) for k in ("source", "path")]
    if shutil.which("g++"):
        # The cache arms the build analytics, as in the reference: they
        # built the store engine into it at construction.
        names.append(os.path.basename(native.library_path()))
        assert [r["name"] for r in sim.executables] == ["libbplite"]
    assert sorted(os.listdir(cache)) == sorted(names)
    if shutil.which("g++"):
        assert os.path.dirname(native.build()) == str(cache)
    stats = tmp_path / "stats.json"
    monkeypatch.setenv("GS_TPU_STATS", str(stats))
    driver.main([_config(tmp_path / "c.toml", steps=4, plotgap=2)])
    assert json.loads(stats.read_text())["config"]["compile_cache"] == str(
        cache)
    assert "compile cache" not in capsys.readouterr().err


@pytest.mark.parametrize("value", ["off", ""])
def test_compile_cache_off_keeps_the_package_directories(monkeypatch,
                                                         value):
    monkeypatch.setenv("GS_COMPILE_CACHE", value)
    monkeypatch.setenv("GS_COMPILE_CACHE_FORCE", "1")
    sim = Simulation(Settings(L=8, backend="CPU"))
    assert sim.compile_cache_dir is None
    assert _build.build_dir() == _build.BUILD_DIR
    spec = kernelgen.get_spec(get_model("heat"))
    assert os.path.dirname(_build.library_path(spec)) == _build.BUILD_DIR
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR


@pytest.mark.parametrize("via", ["env", "key"])
def test_cpu_drops_an_asked_for_cache_with_a_warning(tmp_path, monkeypatch,
                                                     capsys, via):
    cache = str(tmp_path / "cache")
    if via == "env":
        monkeypatch.setenv("GS_COMPILE_CACHE", cache)
        s = Settings(L=8, backend="CPU")
    else:
        s = Settings(L=8, backend="CPU", compile_cache=cache)
    sim = Simulation(s)
    assert sim.compile_cache_dir is None
    assert _build.build_dir() == _build.BUILD_DIR
    assert "GS_COMPILE_CACHE_FORCE=1" in capsys.readouterr().err
    assert not os.path.exists(cache)


def test_runstats_config_has_every_reference_key(tmp_path, monkeypatch):
    """Live runs of one TOML in both packages on 8 blocks: the port's
    config keys contain the reference's, with the reference's values
    where both packages know them."""
    cfg = _config(tmp_path / "c.toml", steps=4, plotgap=2, checkpoint=True,
                  checkpoint_freq=2,
                  checkpoint_output=str(tmp_path / "ckpt.bp"))
    configs = {}
    for name, main in (("ref", ref_driver.main), ("port", driver.main)):
        stats = tmp_path / f"{name}.json"
        monkeypatch.setenv("GS_TPU_STATS", str(stats))
        main([cfg], n_devices=8)
        configs[name] = json.loads(stats.read_text())["config"]
    ref, port = configs["ref"], configs["port"]
    missing = sorted(set(ref) - set(port))
    assert not missing, missing
    for key in ("attempt", "model", "fields", "mesh_dims", "padded_storage",
                "precision", "compute_precision", "n_devices",
                "n_processes", "halo_depth", "reshard", "compile_cache",
                "autotune_mode", "process_index", "ensemble", "numerics",
                "async_io_depth"):
        assert port[key] == ref[key], key
    # The port's own keys stay.
    for key in ("process_count", "io_engine", "launches",
                "host_ring_bytes", "backend"):
        assert key in port, key


def test_padded_storage_is_recorded_on_a_padded_mesh(tmp_path, monkeypatch):
    stats = tmp_path / "stats.json"
    monkeypatch.setenv("GS_TPU_STATS", str(stats))
    monkeypatch.setenv("GS_TPU_MESH_DIMS", "3,1,1")
    driver.main([_config(tmp_path / "c.toml", L=10, steps=2, plotgap=2)],
                n_devices=3)
    cfg = json.loads(stats.read_text())["config"]
    assert cfg["padded_storage"] == [12, 10, 10]
    assert cfg["mesh_dims"] == [3, 1, 1] and cfg["n_processes"] == 1
