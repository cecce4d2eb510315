"""The port's sharded main path (grayscott_jl_tpu_torch/simulation.py on
an in-process mesh, parallel/, the kernel's face modes' CPU path)
against the reference's sharded runs on the 8 virtual CPU devices, and
against itself.

Against the reference: whole runs for meshes (2,2,2), (8,1,1), (4,1,1),
(2,2,1) and (1,2,2), kernel languages Pallas and Plain, ``GS_FUSE`` 1,
2 and 3 — off the TPU the reference's sharded runs take
``_xla_fallback`` and ``_xla_xchain_fallback``, the functions the
port's CPU path mirrors. Tolerance as tests/test_torch_simulation.py:
atol 1e-5 over 20 float32 steps (1e-12 for float64), the XLA:CPU
FMA-contraction drift compounded.

Inside the port everything is bitwise: every sharded run equals the
single-block run, depth k equals k x depth 1, and non-divisible L
(pad-and-mask) runs equal their single-block runs."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.simulation import Simulation as RefSimulation
from grayscott_jl_tpu_torch import Settings, Simulation
from grayscott_jl_tpu_torch.carry import blocks_from_reference
from grayscott_jl_tpu_torch.config.settings import NOT_PORTED_ENV
from grayscott_jl_tpu_torch.models import SettingsError
from grayscott_jl_tpu_torch.ops import cuda_stencil

GS = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0)
MESHES = [(2, 2, 2), (8, 1, 1), (4, 1, 1), (2, 2, 1), (1, 2, 2)]
STEPS = 20


@pytest.fixture
def x64():
    prior = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prior)


def _settings(cls, lang, L=16, noise=0.1, precision="Float32"):
    return cls(L=L, noise=noise, precision=precision, backend="CPU",
               kernel_language=lang, **GS)


def _port(lang, dims, L=16, noise=0.1, precision="Float32", seed=3):
    n = math.prod(dims)
    return Simulation(_settings(Settings, lang, L, noise, precision),
                      n_devices=n, mesh_dims=dims if n > 1 else None,
                      seed=seed)


def _mesh_env(monkeypatch, dims, fuse):
    monkeypatch.setenv("GS_FUSE", str(fuse))
    monkeypatch.setenv("GS_TPU_MESH_DIMS", ",".join(map(str, dims)))


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("lang", ["Pallas", "Plain"])
@pytest.mark.parametrize("fuse", [1, 2, 3])
def test_sharded_run_matches_reference(dims, lang, fuse, monkeypatch):
    n = math.prod(dims)
    if len(jax.devices()) < n:
        pytest.skip("needs 8 virtual CPU devices")
    _mesh_env(monkeypatch, dims, fuse)
    ref = RefSimulation(_settings(RefSettings, lang), n_devices=n, seed=3)
    port = Simulation(_settings(Settings, lang), n_devices=n, seed=3)
    assert ref.domain.dims == port.domain.dims == dims
    assert port.sharded and len(port.blocks) == n
    ref.iterate(STEPS)
    port.iterate(STEPS)
    for a, b in zip(ref.get_fields(), port.get_fields()):
        assert b.shape == (16, 16, 16)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_sharded_float64_matches_reference(monkeypatch, x64):
    _mesh_env(monkeypatch, (2, 2, 2), 2)
    ref = RefSimulation(_settings(RefSettings, "Pallas",
                                  precision="Float64"), n_devices=8, seed=3)
    port = Simulation(_settings(Settings, "Pallas", precision="Float64"),
                      n_devices=8, seed=3)
    ref.iterate(10)
    port.iterate(10)
    for a, b in zip(ref.get_fields(), port.get_fields()):
        assert b.dtype == np.float64
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("lang", ["Pallas", "Plain"])
@pytest.mark.parametrize("fuse", [1, 2, 3])
def test_sharded_equals_single_block_bitwise(dims, lang, fuse, monkeypatch):
    monkeypatch.setenv("GS_FUSE", str(fuse))
    single = _port("Plain", (1, 1, 1))
    sharded = _port(lang, dims)
    single.iterate(STEPS)
    sharded.iterate(STEPS)
    for a, b in zip(single.get_fields(), sharded.get_fields()):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("dims", [(2, 2, 2), (8, 1, 1), (2, 2, 1)])
@pytest.mark.parametrize("depth", [2, 3])
def test_depth_k_equals_k_rounds_of_depth_1_bitwise(dims, depth,
                                                    monkeypatch):
    """One depth-k round (one k-deep exchange) against k depth-1 rounds
    (k 6n-face exchanges), from the same state."""
    monkeypatch.setenv("GS_FUSE", "1")
    one = _port("Pallas", dims)
    monkeypatch.setenv("GS_FUSE", str(depth))
    deep = _port("Pallas", dims)
    for sim in (one, deep):
        sim.iterate(3)  # off the seed state: a mid-run round
    one.iterate(depth)
    deep.iterate(depth)
    for a, b in zip(one.get_fields(), deep.get_fields()):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("L,dims", [
    (18, (4, 1, 1)), (20, (3, 1, 1)), (20, (2, 3, 1)), (22, (1, 3, 2)),
    (20, (3, 3, 3)),
])
@pytest.mark.parametrize("lang", ["Pallas", "Plain"])
@pytest.mark.parametrize("fuse", [1, 2, 3])
def test_uneven_L_sharded_equals_single_block_bitwise(L, dims, lang, fuse,
                                                      monkeypatch):
    """Pad-and-mask: the blocks hold ceil(L/d) cells per axis, the pad
    cells are re-pinned after every round, and the outputs are clipped
    to L^3."""
    monkeypatch.setenv("GS_FUSE", str(fuse))
    single = _port("Plain", (1, 1, 1), L=L)
    sharded = _port(lang, dims, L=L)
    assert sharded.domain.padded
    single.iterate(9)
    sharded.iterate(9)
    for a, b in zip(single.get_fields(), sharded.get_fields()):
        assert b.shape == (L,) * 3
        np.testing.assert_array_equal(b, a)
    for offs, sizes, *fields in sharded.snapshot():
        for f in fields:
            assert f.shape == tuple(sizes)
            assert all(o + s <= L for o, s in zip(offs, sizes))


def test_uneven_L_matches_reference(monkeypatch):
    """After the reference's test_uneven_L_sharded_matches_single_device:
    L=18 on a (4,1,1) mesh, its runs against the port's."""
    _mesh_env(monkeypatch, (4, 1, 1), 2)
    ref = RefSimulation(_settings(RefSettings, "Pallas", L=18),
                        n_devices=4, seed=3)
    port = Simulation(_settings(Settings, "Pallas", L=18), n_devices=4,
                      seed=3)
    ref.iterate(STEPS)
    port.iterate(STEPS)
    for a, b in zip(ref.get_fields(), port.get_fields()):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_chunking_invariance_sharded_bitwise(monkeypatch):
    monkeypatch.setenv("GS_FUSE", "3")
    a = _port("Pallas", (2, 2, 2))
    b = _port("Pallas", (2, 2, 2))
    a.iterate(13)
    for n in (5, 1, 4, 3):
        b.iterate(n)
    for x, y in zip(a.get_fields(), b.get_fields()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fuse,dtype,cap,path", [
    (7, "Float32", 5, "x-chain"), (3, "Float64", 2, "xy-chain"),
])
def test_chain_depth_is_capped_by_the_ledger(fuse, dtype, cap, path,
                                             monkeypatch):
    """A depth above the shared-memory ledger's cap steps down with a
    warning and stays bitwise."""
    monkeypatch.setenv("GS_FUSE", str(fuse))
    dims = (4, 1, 1) if path == "x-chain" else (2, 2, 1)
    sim = _port("Pallas", dims, L=32, precision=dtype)
    ref = _port("Plain", (1, 1, 1), L=32, precision=dtype)
    with pytest.warns(RuntimeWarning, match=f"{path} depth capped at {cap}"):
        sim.iterate(fuse)
    ref.iterate(fuse)
    for a, b in zip(ref.get_fields(), sim.get_fields()):
        np.testing.assert_array_equal(b, a)


def test_carry_reference_sharded_state_into_port(monkeypatch):
    """The reference's sharded fields (its padded storage arrays) become
    the port's blocks bitwise, and one step from the carried state
    matches the reference's step."""
    _mesh_env(monkeypatch, (3, 1, 1), 2)
    ref = RefSimulation(_settings(RefSettings, "Pallas", L=20),
                        n_devices=3, seed=3)
    port = Simulation(_settings(Settings, "Pallas", L=20), n_devices=3,
                      seed=3)
    ref.iterate(4)
    storage = [np.asarray(f) for f in ref.fields]
    assert storage[0].shape == (21, 20, 20)
    port.blocks = blocks_from_reference(storage, port)
    port.step = ref.step
    for a, b in zip(ref.get_fields(), port.get_fields()):
        np.testing.assert_array_equal(b, a)
    assert [tuple(f.shape) for f in port.blocks[0]] == [(7, 20, 20)] * 2
    ref.iterate(2)
    port.iterate(2)
    for a, b in zip(ref.get_fields(), port.get_fields()):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="does not match"):
        blocks_from_reference([s.astype(np.float64) for s in storage], port)
    with pytest.raises(ValueError, match="declares 2"):
        blocks_from_reference(storage[:1], port)


def test_restore_fields_scatters_into_blocks():
    a = _port("Pallas", (1, 1, 1), L=20)
    a.iterate(5)
    b = _port("Pallas", (3, 1, 1), L=20)
    b.restore_fields(a.get_fields(), a.step)
    assert b.step == 5
    a.iterate(4)
    b.iterate(4)
    for x, y in zip(a.get_fields(), b.get_fields()):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="does not match"):
        b.restore_fields([np.zeros((21, 20, 20))] * 2, 0)


def test_sharded_run_launches_nothing_on_cpu():
    sim = _port("Pallas", (2, 2, 2))
    n = cuda_stencil.LAUNCHES
    sim.iterate(4)
    assert cuda_stencil.LAUNCHES == n


def test_sharded_fields_property_refuses():
    sim = _port("Pallas", (2, 1, 1))
    with pytest.raises(ValueError, match="per block"):
        sim.fields
    with pytest.raises(ValueError, match="per block"):
        sim.fields = sim.blocks[0]


def test_mesh_the_devices_or_L_cannot_hold_raises(monkeypatch):
    s = _settings(Settings, "Pallas", L=8)
    with pytest.raises(ValueError, match="do not factor"):
        Simulation(s, n_devices=4, mesh_dims=(2, 1, 1))
    with pytest.raises(ValueError, match="too small"):
        # ceil(10/8) = 2 cells per block: block 7 would own none.
        Simulation(dataclasses.replace(s, L=10), n_devices=8,
                   mesh_dims=(8, 1, 1))
    with pytest.raises(ValueError, match="disagrees"):
        Simulation(s, n_devices=2, devices=["cpu"] * 3)
    with pytest.raises(SettingsError, match="not of the settings' backend"):
        Simulation(s, devices=["meta", "meta"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 cuda devices"):
        Simulation(dataclasses.replace(s, backend="CUDA"), n_devices=2)


@pytest.mark.parametrize("key,value,item", [
    ("comm_overlap", "on", "Queue 1 item 13a"),
    ("halo_depth", 2, "Queue 1 item 13b"),
])
def test_unported_mesh_options_raise_naming_the_item(key, value, item):
    """Both options were refused until their items were ported; now each
    acts on a sharded run (tests/test_torch_overlap.py and
    tests/test_torch_halo_depth.py hold them to the reference): the
    split-phase round engages, or one exchange round feeds two steps,
    bitwise equal to the run without the option."""
    s = dataclasses.replace(_settings(Settings, "Pallas", L=8),
                            **{key: value})
    sim = Simulation(s, n_devices=2, seed=3)
    plain = Simulation(dataclasses.replace(s, comm_overlap="off",
                                           halo_depth=1),
                       n_devices=2, seed=3)
    assert not plain.comm_overlap and plain.halo_depth == 1
    for x in (sim, plain):
        x.iterate(4)
    if key == "comm_overlap":
        assert sim.comm_overlap and sim.overlap_applied
        assert not plain.overlap_applied
    else:
        assert sim.halo_depth == 2
        assert (sim.exchange_rounds, plain.exchange_rounds) == (1, 2)
    for a, b in zip(sim.get_fields(), plain.get_fields()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("var,value,item", [
    ("GS_COMM_OVERLAP", "on", "13a"), ("GS_HALO_DEPTH", "3", "13b"),
    ("GS_TPU_COORDINATOR", "127.0.0.1:1234", "14"),
    ("GS_TPU_DISTRIBUTED", "auto", "14"),
])
def test_unported_env_overrides_raise(var, value, item, monkeypatch):
    """Every variable acts since its item was ported: ``GS_COMM_OVERLAP``
    and ``GS_HALO_DEPTH`` win over the settings' keys, and the launch
    variables (item 14) start a multi-process run — so an incomplete
    launch raises, naming what is missing: ``GS_TPU_NUM_PROCESSES``
    after ``GS_TPU_COORDINATOR``, torchrun's variables after
    ``GS_TPU_DISTRIBUTED=auto`` (tests/test_torch_distributed.py and
    tests/test_torch_multiprocess*.py run the complete ones)."""
    for launch_var in ("GS_TPU_NUM_PROCESSES", "GS_TPU_PROCESS_ID",
                       "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                       "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(launch_var, raising=False)
    monkeypatch.setenv(var, value)
    s = _settings(Settings, "Pallas", L=8)
    if item == "14":
        assert var not in NOT_PORTED_ENV
        missing = ("GS_TPU_NUM_PROCESSES" if var == "GS_TPU_COORDINATOR"
                   else "MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE")
        with pytest.raises(SettingsError, match=f"{var}.*{missing}"):
            Simulation(s, n_devices=2)
        return
    monkeypatch.setenv("GS_FUSE", "1")
    sim = Simulation(dataclasses.replace(s, comm_overlap="off",
                                         halo_depth=1), n_devices=2)
    if var == "GS_COMM_OVERLAP":
        assert sim.comm_overlap
    else:
        assert sim.halo_depth == 3 and sim.halo_depth_gate is None
        sim.iterate(3)
        assert sim.exchange_rounds == 1


@pytest.mark.parametrize("model", ["heat", "brusselator", "fhn"])
@pytest.mark.parametrize("fuse", [1, 2])
def test_other_models_sharded_plain_equals_single_block(model, fuse,
                                                        monkeypatch):
    """The exchange and the window chain are model-generic (1 field for
    heat, 2 for the others): the plain path on a (2,2,1) mesh equals the
    single-block run bitwise."""
    monkeypatch.setenv("GS_FUSE", str(fuse))

    def sim(n, dims):
        return Simulation(
            Settings(L=16, noise=0.05, precision="Float32", backend="CPU",
                     kernel_language="Plain", dt=0.05, model=model),
            n_devices=n, mesh_dims=dims, seed=2)

    single, mesh = sim(1, None), sim(4, (2, 2, 1))
    single.iterate(7)
    mesh.iterate(7)
    for a, b in zip(single.get_fields(), mesh.get_fields()):
        np.testing.assert_array_equal(b, a)
