"""The split-phase round (``comm_overlap``) of the port's sharded path
(grayscott_jl_tpu_torch/simulation.py, parallel/halo.py,
parallel/temporal.py) against the reference's
(tests/unit/test_overlap.py) on the 8 virtual CPU devices, and against
itself.

The round starts the exchange (``halo.start_exchange``), computes each
block's interior on frozen boundary values, then recomputes the k-thick
boundary bands from what arrived — on the kernel path with the x-chain
(``cuda_stencil.fused_step(..., band=True)``; ``plain_xchain`` on the
CPU), on the plain path with the window chain. Overlap only reorders
work, so inside the port every split run equals the fused run and the
single block bitwise. Against the reference: atol 1e-5 over 20 float32
steps, the tolerance of tests/test_torch_sharded.py (XLA:CPU's FMA
contraction), and ``overlap_applied`` equal on every mesh."""

import math

import numpy as np
import pytest
import torch

import jax

from grayscott_jl_tpu.config import settings as ref_config
from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.parallel import temporal as ref_temporal
from grayscott_jl_tpu.simulation import Simulation as RefSimulation
from grayscott_jl_tpu_torch import Settings, Simulation
from grayscott_jl_tpu_torch.config import settings as config
from grayscott_jl_tpu_torch.ops import cuda_stencil
from grayscott_jl_tpu_torch.parallel import halo, temporal
from grayscott_jl_tpu_torch.parallel.mesh import DeviceMesh

GS = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0)
STEPS = 20

#: (mesh, L): the x-chain, the xy-chain's frame form (z bands) and its
#: slab form.
MESHES = [((8, 1, 1), 32), ((2, 2, 2), 16), ((2, 2, 1), 16)]

requires8 = pytest.mark.skipif(len(jax.devices()) < 8,
                               reason="needs 8 virtual CPU devices")


def _settings(cls, lang="Pallas", L=16, noise=0.1, **kw):
    return cls(L=L, noise=noise, precision="Float32", backend="CPU",
               kernel_language=lang, **{**GS, **kw})


def _port(dims, lang="Pallas", L=16, overlap="on", seed=3, **kw):
    n = math.prod(dims)
    return Simulation(_settings(Settings, lang, L, comm_overlap=overlap,
                                **kw),
                      n_devices=n, mesh_dims=dims if n > 1 else None,
                      seed=seed)


def _equal(a, b):
    for x, y in zip(a.get_fields(), b.get_fields()):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------- against the reference

@requires8
@pytest.mark.parametrize("dims,L", MESHES)
@pytest.mark.parametrize("lang", ["Pallas", "Plain"])
def test_overlap_on_matches_reference(dims, L, lang, monkeypatch):
    """``comm_overlap = "on"`` at ``GS_FUSE=2``, 20 steps, seed 3: the
    port's fields within atol 1e-5 of the reference's, and the split
    phase engaged on the same meshes (the plain window chain splits on
    (n, 1, 1) meshes only, in both)."""
    n = math.prod(dims)
    monkeypatch.setenv("GS_FUSE", "2")
    monkeypatch.setenv("GS_TPU_MESH_DIMS", ",".join(map(str, dims)))
    ref = RefSimulation(_settings(RefSettings, lang, L, comm_overlap="on"),
                        n_devices=n, seed=3)
    port = Simulation(_settings(Settings, lang, L, comm_overlap="on"),
                      n_devices=n, seed=3)
    assert ref.comm_overlap and port.comm_overlap
    ref.iterate(STEPS)
    port.iterate(STEPS)
    assert port.overlap_applied == ref.overlap_applied
    assert port.overlap_applied == (lang == "Pallas" or dims[1:] == (1, 1))
    for a, b in zip(ref.get_fields(), port.get_fields()):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


@requires8
@pytest.mark.parametrize("dims,L,lang,n", [
    ((8, 1, 1), 22, "Pallas", 8),   # 3-plane blocks < 2k: fused round
    ((2, 2, 2), 16, "Plain", 8),    # window chain, multi-axis: fused
    ((2, 4, 1), 16, "Plain", 8),
    ((4, 2, 1), 16, "Pallas", 8),
    ((1, 1, 1), 8, "Plain", 1),     # one device never overlaps
])
def test_overlap_applied_equals_reference(dims, L, lang, n, monkeypatch):
    monkeypatch.setenv("GS_FUSE", "2")
    monkeypatch.setenv("GS_TPU_MESH_DIMS", ",".join(map(str, dims)))
    ref = RefSimulation(_settings(RefSettings, lang, L, comm_overlap="on"),
                        n_devices=n, seed=3)
    port = Simulation(_settings(Settings, lang, L, comm_overlap="on"),
                      n_devices=n, seed=3)
    assert port.comm_overlap == ref.comm_overlap
    ref.iterate(5)
    port.iterate(5)
    assert port.overlap_applied == ref.overlap_applied
    for a, b in zip(ref.get_fields(), port.get_fields()):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_xy_overlap_feasible_equals_reference():
    grid = [(local, dims, depth)
            for local in ((3, 3, 8), (8, 8, 16), (3, 8, 16), (8, 3, 16),
                          (4, 4, 4), (5, 7, 2))
            for dims in ((2, 2, 2), (2, 2, 1), (1, 2, 1), (4, 1, 2),
                         (2, 1, 1), (1, 2, 4))
            for depth in (1, 2, 3)]
    for local, dims, depth in grid:
        assert (temporal.xy_overlap_feasible(local, dims, depth)
                == ref_temporal.xy_overlap_feasible(local, dims, depth)), (
            local, dims, depth)


@pytest.mark.parametrize("env,key,want", [
    (None, "auto", "auto"), (None, "off", "off"), (None, "on", "on"),
    (None, "", "auto"), ("on", "off", "on"), ("0", "on", "off"),
    ("true", "off", "on"), ("no", "auto", "off"), (" Auto ", "off", "auto"),
])
def test_resolve_comm_overlap_equals_reference(env, key, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("GS_COMM_OVERLAP", raising=False)
    else:
        monkeypatch.setenv("GS_COMM_OVERLAP", env)
    got = config.resolve_comm_overlap(Settings(comm_overlap=key))
    assert got == want == ref_config.resolve_comm_overlap(
        RefSettings(comm_overlap=key))


@pytest.mark.parametrize("env,key", [("sideways", "auto"), (None, "maybe")])
def test_comm_overlap_bad_value_raises_as_reference(env, key, monkeypatch):
    if env is None:
        monkeypatch.delenv("GS_COMM_OVERLAP", raising=False)
    else:
        monkeypatch.setenv("GS_COMM_OVERLAP", env)
    with pytest.raises(ValueError) as ref_err:
        ref_config.resolve_comm_overlap(RefSettings(comm_overlap=key))
    with pytest.raises(ValueError) as err:
        config.resolve_comm_overlap(Settings(comm_overlap=key))
    assert str(err.value) == str(ref_err.value)
    assert "GS_COMM_OVERLAP" in str(err.value)
    # A sharded run resolves it at construction, as the reference does.
    with pytest.raises(ValueError, match="GS_COMM_OVERLAP"):
        _port((2, 1, 1), L=8, overlap=key)


def test_comm_overlap_toml_key():
    s = config.parse_settings_toml('comm_overlap = "off"\nL = 16\n')
    assert s.comm_overlap == "off"
    assert config.resolve_comm_overlap(s) == "off"


@pytest.mark.parametrize("overlap,sharded,want", [
    ("auto", True, True), ("on", True, True), ("off", True, False),
    ("on", False, False), ("auto", False, False),
])
def test_comm_overlap_flag_auto_is_on_for_sharded_runs(overlap, sharded,
                                                       want):
    """"auto" arms the split phase for every sharded run, as in the
    reference (ROADMAP Queue 3 F5); one block never overlaps."""
    sim = _port((2, 2, 1) if sharded else (1, 1, 1), overlap=overlap)
    assert sim.comm_overlap is want
    assert not sim.overlap_applied
    sim.iterate(4)
    assert sim.overlap_applied is want


# ------------------------------------------------- inside the port, bitwise

@pytest.mark.parametrize("model", ["grayscott", "brusselator", "fhn", "heat"])
@pytest.mark.parametrize("dims,L", MESHES)
def test_split_equals_fused_and_single_block_bitwise(model, dims, L,
                                                     monkeypatch):
    """Three rounds and a remainder at ``GS_FUSE=2``, noise on: split ==
    fused == the single block, for every model (one field for heat)."""
    monkeypatch.setenv("GS_FUSE", "2")
    kw = {} if model == "grayscott" else dict(model=model, dt=0.05)
    on = _port(dims, L=L, overlap="on", **kw)
    off = _port(dims, L=L, overlap="off", **kw)
    one = _port((1, 1, 1), "Plain", L=L, overlap="off", **kw)
    for sim in (on, off, one):
        sim.iterate(7)
    assert on.overlap_applied and not off.overlap_applied
    _equal(on, off)
    _equal(on, one)


@pytest.mark.parametrize("model", ["grayscott", "heat"])
@pytest.mark.parametrize("fuse", [1, 2, 3])
def test_plain_window_split_equals_fused_bitwise(model, fuse, monkeypatch):
    """The plain path's split window chain on (8,1,1), depth 1 included
    (one step splits too, as in the reference)."""
    monkeypatch.setenv("GS_FUSE", str(fuse))
    kw = {} if model == "grayscott" else dict(model=model, dt=0.05)
    on = _port((8, 1, 1), "Plain", L=32, overlap="on", **kw)
    off = _port((8, 1, 1), "Plain", L=32, overlap="off", **kw)
    for sim in (on, off):
        sim.iterate(2 * fuse + 1)
    assert on.overlap_applied
    _equal(on, off)


@pytest.mark.parametrize("L,dims", [
    (20, (3, 1, 1)), (20, (2, 3, 1)), (22, (1, 3, 2)), (20, (3, 3, 3)),
    (44, (8, 1, 1)),
])
@pytest.mark.parametrize("lang", ["Pallas", "Plain"])
def test_uneven_L_split_equals_single_block_bitwise(L, dims, lang,
                                                    monkeypatch):
    """Pad-and-mask blocks: the bands write pad cells too, and the pins
    after each round keep them at the boundary value."""
    monkeypatch.setenv("GS_FUSE", "2")
    sim = _port(dims, lang, L=L)
    one = _port((1, 1, 1), "Plain", L=L, overlap="off")
    assert sim.domain.padded
    sim.iterate(9)
    one.iterate(9)
    assert sim.overlap_applied == (lang == "Pallas" or dims[1:] == (1, 1))
    _equal(sim, one)


def test_shallow_block_takes_the_fused_round(monkeypatch):
    """L=22 on (8,1,1) at depth 2: 3-plane blocks have no interior
    (nx < 2k), so the round stays fused, and bitwise."""
    monkeypatch.setenv("GS_FUSE", "2")
    sim = _port((8, 1, 1), L=22)
    one = _port((1, 1, 1), "Plain", L=22, overlap="off")
    sim.iterate(5)
    one.iterate(5)
    assert sim.comm_overlap and not sim.overlap_applied
    _equal(sim, one)


def test_chunking_invariance_with_overlap_bitwise(monkeypatch):
    monkeypatch.setenv("GS_FUSE", "3")
    a = _port((2, 2, 2))
    b = _port((2, 2, 2))
    a.iterate(13)
    for n in (5, 1, 4, 3):
        b.iterate(n)
    _equal(a, b)


def test_split_run_launches_nothing_on_cpu(monkeypatch):
    monkeypatch.setenv("GS_FUSE", "2")
    sim = _port((8, 1, 1), L=32)
    n, bands = cuda_stencil.LAUNCHES, cuda_stencil.BAND_LAUNCHES
    sim.iterate(4)
    assert sim.overlap_applied
    assert (cuda_stencil.LAUNCHES, cuda_stencil.BAND_LAUNCHES) == (n, bands)


# ------------------------------------------------------------ the helpers

def _blocks(dims, shape, n_fields=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [tuple(torch.rand(shape, generator=gen) for _ in range(n_fields))
            for _ in range(math.prod(dims))]


@pytest.mark.parametrize("dims", [(2, 2, 2), (4, 1, 1), (1, 2, 2)])
@pytest.mark.parametrize("width", [1, 2, 3])
def test_start_exchange_finish_equals_halo_pad_wide(dims, width):
    mesh = DeviceMesh(dims, ["cpu"] * math.prod(dims))
    blocks = _blocks(dims, (6, 5, 7))
    bvs = (1.0, 0.0)
    want = halo.halo_pad_wide(blocks, bvs, mesh, width)
    got = halo.start_exchange(blocks, bvs, mesh, width).finish()
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    slabs = halo.start_exchange(blocks, bvs, mesh, width,
                                exchange=halo.exchange_x_slabs).finish()
    for a, b in zip(slabs, halo.exchange_x_slabs(blocks, bvs, mesh, width)):
        for (lo, hi), (lo2, hi2) in zip(a, b):
            assert torch.equal(lo, lo2) and torch.equal(hi, hi2)


def test_frozen_stand_ins_are_the_boundary_value():
    """``frozen_frame`` is what ``halo_pad_wide`` gives a block alone on
    its mesh; ``frozen_slabs`` what ``exchange_x_slabs`` gives it."""
    blocks = _blocks((1, 1, 1), (4, 5, 6))
    bvs = (1.0, 0.0)
    mesh = DeviceMesh((1, 1, 1), ["cpu"])
    for w in (1, 2):
        frame = halo.frozen_frame(blocks[0], bvs, w)
        for x, y in zip(frame, halo.halo_pad_wide(blocks, bvs, mesh, w)[0]):
            assert torch.equal(x, y)
        slabs = halo.frozen_slabs(blocks[0], bvs, 0, w)
        for (lo, hi), (lo2, hi2) in zip(
                slabs, halo.exchange_x_slabs(blocks, bvs, mesh, w)[0]):
            assert torch.equal(lo, lo2) and torch.equal(hi, hi2)
            assert lo.shape == (w, 5, 6)
