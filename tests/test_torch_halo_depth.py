"""The s-step exchange depth (``halo_depth``) of the port's sharded path
(grayscott_jl_tpu_torch/simulation.py) against the reference's
(tests/unit/test_halo_depth.py) on the 8 virtual CPU devices, and
against itself; and the run statistics that record the schedule
(driver.py).

``halo_depth = k`` at chain depth d is the depth-k·d chain: one
k·d-deep exchange per round, so it equals ``GS_FUSE = k·d`` bitwise in
the port, composed with the split-phase round too. The kernel path's
gate (``cuda_stencil.max_feasible_chain_depth``: the chain's geometry
and the shared-memory ledger) steps an infeasible k down with a
warning; the plain path refuses a k its blocks cannot serve. Against
the reference: atol 1e-5 over 20 float32 steps (the tolerance of
tests/test_torch_sharded.py), and the same resolution, errors and gate
decisions."""

import json
import math
from pathlib import Path

import numpy as np
import pytest

import jax

from grayscott_jl_tpu import driver as ref_driver
from grayscott_jl_tpu.config import settings as ref_config
from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.config.settings import SettingsError as RefSettingsError
from grayscott_jl_tpu.simulation import Simulation as RefSimulation
from grayscott_jl_tpu_torch import Settings, Simulation, driver
from grayscott_jl_tpu_torch.config import settings as config
from grayscott_jl_tpu_torch.models import SettingsError
from grayscott_jl_tpu_torch.ops import cuda_stencil
from test_torch_driver import _config

GS = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0)
STEPS = 20
MESHES = [((8, 1, 1), 32), ((2, 2, 2), 16), ((2, 2, 1), 16)]

requires8 = pytest.mark.skipif(len(jax.devices()) < 8,
                               reason="needs 8 virtual CPU devices")


def _settings(cls, lang="Pallas", L=16, noise=0.1, **kw):
    return cls(**{**dict(L=L, noise=noise, precision="Float32",
                         backend="CPU", kernel_language=lang),
                  **GS, **kw})


def _run(k, fuse, monkeypatch, dims=(2, 2, 2), L=16, steps=8, lang="Pallas",
         seed=3, overlap="auto", **kw):
    """The port's fields after ``steps`` at s-step depth ``k`` over chain
    depth ``fuse``."""
    monkeypatch.setenv("GS_FUSE", str(fuse))
    n = math.prod(dims)
    sim = Simulation(_settings(Settings, lang, L, halo_depth=k,
                               comm_overlap=overlap, **kw),
                     n_devices=n, mesh_dims=dims if n > 1 else None,
                     seed=seed)
    assert sim.halo_depth == k
    sim.iterate(steps)
    return sim


def _equal(a, b):
    for x, y in zip(a.get_fields(), b.get_fields()):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------- against the reference

@requires8
@pytest.mark.parametrize("dims,L", MESHES)
@pytest.mark.parametrize("lang", ["Pallas", "Plain"])
def test_halo_depth_2_matches_reference(dims, L, lang, monkeypatch):
    """``halo_depth = 2`` at ``GS_FUSE=1``: within atol 1e-5 of the
    reference, with the same applied depth and the same split phase
    (both arm it under the default "auto")."""
    n = math.prod(dims)
    monkeypatch.setenv("GS_FUSE", "1")
    monkeypatch.setenv("GS_TPU_MESH_DIMS", ",".join(map(str, dims)))
    ref = RefSimulation(_settings(RefSettings, lang, L, halo_depth=2),
                        n_devices=n, seed=3)
    port = Simulation(_settings(Settings, lang, L, halo_depth=2),
                      n_devices=n, seed=3)
    assert port.halo_depth == ref.halo_depth == 2
    assert port.halo_depth_gate is None and ref.halo_depth_gate is None
    ref.iterate(STEPS)
    port.iterate(STEPS)
    assert port.overlap_applied == ref.overlap_applied
    assert port.exchange_rounds == STEPS // 2
    for a, b in zip(ref.get_fields(), port.get_fields()):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


@pytest.mark.parametrize("env,key,want", [
    (None, 0, (False, 1)), (None, 3, (True, 3)), ("2", 3, (True, 2)),
    ("auto", 3, (False, 1)), ("", 2, (False, 1)), (" 4 ", 0, (True, 4)),
    ("1", 0, (True, 1)),
])
def test_resolve_halo_depth_equals_reference(env, key, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("GS_HALO_DEPTH", raising=False)
    else:
        monkeypatch.setenv("GS_HALO_DEPTH", env)
    got = config.resolve_halo_depth(Settings(halo_depth=key))
    assert got == want == ref_config.resolve_halo_depth(
        RefSettings(halo_depth=key))


@pytest.mark.parametrize("env,key", [("1.5", 0), ("deep", 0), ("-2", 0),
                                     (None, -1)])
def test_halo_depth_bad_value_raises_as_reference(env, key, monkeypatch):
    if env is None:
        monkeypatch.delenv("GS_HALO_DEPTH", raising=False)
    else:
        monkeypatch.setenv("GS_HALO_DEPTH", env)
    with pytest.raises(ValueError) as ref_err:
        ref_config.resolve_halo_depth(RefSettings(halo_depth=key))
    with pytest.raises(ValueError) as err:
        config.resolve_halo_depth(Settings(halo_depth=key))
    assert str(err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="halo_depth|GS_HALO_DEPTH"):
        Simulation(_settings(Settings, L=8, halo_depth=key))


@requires8
def test_gate_geometry_bound_equals_reference(monkeypatch, capsys):
    """chain depth 1 x k=4 needs a 4-deep chain, but the (8,1,1) blocks
    of L=16 are 2 planes deep: both step down to k=2, loudly."""
    monkeypatch.setenv("GS_TPU_MESH_DIMS", "8,1,1")
    monkeypatch.setenv("GS_FUSE", "1")
    ref = RefSimulation(_settings(RefSettings, halo_depth=4), n_devices=8)
    port = Simulation(_settings(Settings, halo_depth=4), n_devices=8)
    assert port.halo_depth == ref.halo_depth == 2
    gate, ref_gate = port.halo_depth_gate, ref.halo_depth_gate
    for key in ("requested", "applied", "kind"):
        assert gate[key] == ref_gate[key]
    for key in ("path", "local_shape", "fuse_base", "requested_depth",
                "feasible_depth", "itemsize", "n_fields"):
        assert gate["geometry"][key] == ref_gate["geometry"][key], key
    assert "halo_depth=4" in capsys.readouterr().err


@requires8
def test_plain_infeasible_k_raises_as_reference(monkeypatch):
    """chain depth 4 x k=4 needs a 16-deep exchange of owned cells; the
    8^3 blocks of the (2,2,2) mesh cannot serve it."""
    monkeypatch.setenv("GS_FUSE", "4")
    with pytest.raises(RefSettingsError) as ref_err:
        RefSimulation(_settings(RefSettings, "Plain", halo_depth=4),
                      n_devices=8)
    with pytest.raises(SettingsError) as err:
        Simulation(_settings(Settings, "Plain", halo_depth=4), n_devices=8)
    assert str(err.value) == str(ref_err.value)


# ------------------------------------------------------------- the gate

def test_gate_ledger_bound_steps_down(monkeypatch, capsys):
    """``GS_FUSE=2`` x k=3 on (2,2,2) blocks of 16^3: the geometry allows
    depth 6 (nz // 2 = 8), the shared-memory ledger caps float32 at 5,
    so k steps down to 2 (depth 4), with the ledger's numbers."""
    monkeypatch.setenv("GS_FUSE", "2")
    sim = Simulation(_settings(Settings, L=32, halo_depth=3), n_devices=8,
                     mesh_dims=(2, 2, 2))
    gate = sim.halo_depth_gate
    assert sim.halo_depth == 2
    assert (gate["requested"], gate["applied"]) == (3, 2)
    assert gate["kind"] == "geometry-infeasible"
    geo = gate["geometry"]
    assert geo["path"] == "xy-chain"
    assert (geo["requested_depth"], geo["feasible_depth"]) == (6, 4)
    assert geo["smem_bytes_requested"] == cuda_stencil.smem_bytes(4, 6)
    assert geo["smem_bytes_requested"] > geo["smem_limit_bytes"] == (
        cuda_stencil.SMEM_LIMIT)
    err = capsys.readouterr().err
    assert "halo_depth=3" in err and str(cuda_stencil.SMEM_LIMIT) in err
    sim.iterate(8)
    assert sim.exchange_rounds == 2


@pytest.mark.parametrize("local,dims,depth,want", [
    ((16, 16, 16), (2, 2, 2), 6, 5),   # the ledger's float32 cap
    ((16, 16, 16), (2, 2, 2), 4, 4),
    ((16, 16, 6), (2, 2, 2), 4, 3),    # z bands: nz // 2
    ((16, 16, 6), (2, 2, 1), 4, 4),
    ((2, 16, 16), (8, 1, 1), 4, 2),    # x-chain: nx
    ((16, 3, 16), (1, 2, 2), 4, 3),    # xy-chain: ny
    ((16, 16, 1), (2, 1, 2), 2, 0),    # not even depth 1
])
def test_max_feasible_chain_depth(local, dims, depth, want):
    assert cuda_stencil.max_feasible_chain_depth(local, dims, 4,
                                                 depth) == want


def test_gate_counts_the_kernel_path_ledger_per_dtype(monkeypatch):
    """float64 caps at 2: k=2 over depth 2 steps down to k=1."""
    monkeypatch.setenv("GS_FUSE", "2")
    sim = Simulation(_settings(Settings, L=32, precision="Float64",
                               halo_depth=2),
                     n_devices=4, mesh_dims=(4, 1, 1))
    assert sim.halo_depth == 1
    assert sim.halo_depth_gate["geometry"]["itemsize"] == 8


# ------------------------------------------------- inside the port, bitwise

@pytest.mark.parametrize("model", ["grayscott", "brusselator", "fhn", "heat"])
@pytest.mark.parametrize("dims,L", MESHES)
@pytest.mark.parametrize("lang", ["Pallas", "Plain"])
def test_halo_depth_k_is_the_deep_chain_bitwise(model, dims, L, lang,
                                                monkeypatch):
    """k=2 at depth 1 == depth 2, with half the exchange rounds of depth
    1, for every model."""
    kw = {} if model == "grayscott" else dict(model=model, dt=0.05)
    a = _run(2, 1, monkeypatch, dims, L, steps=7, lang=lang, **kw)
    b = _run(1, 2, monkeypatch, dims, L, steps=7, lang=lang, **kw)
    _equal(a, b)
    assert a.exchange_rounds == b.exchange_rounds == 4
    assert _run(1, 1, monkeypatch, dims, L, steps=7, lang=lang,
                **kw).exchange_rounds == 7


@pytest.mark.parametrize("dims,L", [((8, 1, 1), 64), ((2, 2, 2), 16),
                                   ((2, 2, 1), 16)])
@pytest.mark.parametrize("overlap", ["on", "off"])
def test_halo_depth_composes_with_chain_depth_bitwise(dims, L, overlap,
                                                      monkeypatch):
    """k=2 over depth 2 == one depth-4 chain, split or fused, and equal
    to the single block (8-plane x-chain blocks: the split needs nx >=
    2 x depth)."""
    a = _run(2, 2, monkeypatch, dims, L, overlap=overlap)
    b = _run(1, 4, monkeypatch, dims, L, overlap=overlap)
    one = _run(1, 1, monkeypatch, (1, 1, 1), L, lang="Plain")
    assert a.overlap_applied == (overlap == "on")
    _equal(a, b)
    _equal(a, one)


@pytest.mark.parametrize("dims,L", MESHES)
def test_split_round_at_k2_equals_fused_round_bitwise(dims, L, monkeypatch):
    """The reference's test_sstep_composes_with_overlap_bitwise on every
    chain form: a split s-step round equals the fused one."""
    a = _run(2, 1, monkeypatch, dims, L, seed=5, overlap="on")
    b = _run(2, 1, monkeypatch, dims, L, seed=5, overlap="off")
    assert a.overlap_applied and not b.overlap_applied
    _equal(a, b)


@pytest.mark.parametrize("L,dims", [(22, (1, 3, 2)), (20, (3, 1, 1)),
                                    (20, (2, 3, 1))])
@pytest.mark.parametrize("lang", ["Pallas", "Plain"])
def test_uneven_L_halo_depth_equals_single_block_bitwise(L, dims, lang,
                                                         monkeypatch):
    a = _run(2, 1, monkeypatch, dims, L, steps=5, lang=lang)
    one = _run(1, 1, monkeypatch, (1, 1, 1), L, steps=5, lang="Plain")
    assert a.domain.padded
    _equal(a, one)


def test_single_block_halo_depth_is_a_noop(monkeypatch):
    a = _run(4, 1, monkeypatch, (1, 1, 1), steps=6)
    b = _run(1, 1, monkeypatch, (1, 1, 1), steps=6)
    assert a.halo_depth_gate is None
    _equal(a, b)


# --------------------------------------------------- the run's statistics

@requires8
def test_run_stats_record_the_schedule_as_the_reference(tmp_path,
                                                        monkeypatch):
    """ROADMAP Queue 3 F5: under the default "auto" a sharded run has
    ``comm_overlap`` True, and both drivers' RunStats config carry
    ``comm_overlap`` and ``halo_depth``."""
    monkeypatch.setenv("GS_FUSE", "1")
    monkeypatch.setenv("GS_HALO_DEPTH", "2")
    cfgs = {}
    for name in ("ref", "port"):
        (tmp_path / name).mkdir()
        cfgs[name] = _config(tmp_path / name / "cfg.toml", steps=8,
                             plotgap=4,
                             output=str(tmp_path / name / "gs.bp"))
    stats = {}
    for name, drv in (("ref", ref_driver), ("port", driver)):
        path = tmp_path / name / "stats.json"
        monkeypatch.setenv("GS_TPU_STATS", str(path))
        sim = drv.main([cfgs[name]], n_devices=8)
        assert sim.comm_overlap is True and sim.overlap_applied is True
        stats[name] = json.loads(Path(path).read_text())["config"]
    for name in ("ref", "port"):
        assert stats[name]["comm_overlap"] is True
        assert stats[name]["halo_depth"] == 2
