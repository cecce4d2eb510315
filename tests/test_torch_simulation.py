"""The port's single-device Simulation and settings
(grayscott_jl_tpu_torch/simulation.py, config/settings.py) against the
reference Simulation on the CPU.

Tolerance for trajectories: atol 1e-5 over 20 float32 steps (1e-12 for
float64) — the per-step few-ulp FMA-contraction drift of XLA:CPU (see
test_torch_stencil.py), compounded. Initial fields, chunking and fusion
invariance, and carried state are bitwise."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.models import get_model as ref_get_model
from grayscott_jl_tpu.simulation import Simulation as RefSimulation
from grayscott_jl_tpu_torch import Settings, Simulation, parse_settings_toml
from grayscott_jl_tpu_torch import simulation
from grayscott_jl_tpu_torch.carry import (
    fields_from_reference,
    params_from_reference,
)
from grayscott_jl_tpu_torch.config import settings as config
from grayscott_jl_tpu_torch.models import SettingsError, base, get_model
from grayscott_jl_tpu_torch.ops import cuda_stencil

GS = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0)
MODELS = ("grayscott", "brusselator", "fhn", "heat")


@pytest.fixture
def x64():
    prior = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prior)


def _pair(lang, L=16, noise=0.1, precision="Float32", seed=3, **kw):
    kw = {**GS, **kw}
    ref = RefSimulation(
        RefSettings(L=L, noise=noise, precision=precision, backend="CPU",
                    kernel_language=lang, **kw),
        n_devices=1, seed=seed,
    )
    port = Simulation(
        Settings(L=L, noise=noise, precision=precision, backend="CPU",
                 kernel_language=lang, **kw),
        seed=seed,
    )
    return ref, port


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("precision", ["Float32", "Float64"])
@pytest.mark.parametrize("L", [16, 32])
def test_initial_fields_bitwise(model, precision, L, x64):
    dtype = "float32" if precision == "Float32" else "float64"
    want = ref_get_model(model).init(L, jnp.dtype(dtype))
    got = get_model(model).init(L, getattr(torch, dtype))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.numpy().dtype == np.asarray(w).dtype


@pytest.mark.parametrize("lang", ["Plain", "Pallas"])
def test_simulation_matches_reference_20_steps(lang):
    ref, port = _pair(lang)
    ref.iterate(20)
    port.iterate(20)
    for a, b in zip(ref.get_fields(), port.get_fields()):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_simulation_matches_reference_float64(x64):
    ref, port = _pair("Pallas", precision="Float64")
    ref.iterate(10)
    port.iterate(10)
    for a, b in zip(ref.get_fields(), port.get_fields()):
        assert b.dtype == np.float64
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)


@pytest.mark.parametrize("model", ["brusselator", "fhn", "heat"])
def test_other_models_match_reference_on_plain_path(model):
    ref = RefSimulation(
        RefSettings(L=16, noise=0.05, precision="Float32", backend="CPU",
                    kernel_language="Plain", dt=0.05, model=model),
        n_devices=1, seed=2,
    )
    port = Simulation(
        Settings(L=16, noise=0.05, precision="Float32", backend="CPU",
                 kernel_language="Plain", dt=0.05, model=model),
        seed=2,
    )
    ref.iterate(10)
    port.iterate(10)
    for a, b in zip(ref.get_fields(), port.get_fields()):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


@pytest.mark.parametrize("lang", ["Plain", "Pallas"])
def test_chunking_invariance_bitwise(lang):
    _, a = _pair(lang)
    _, b = _pair(lang)
    a.iterate(20)
    for n in (7, 1, 5, 7):
        b.iterate(n)
    assert a.step == b.step == 20
    for x, y in zip(a.get_fields(), b.get_fields()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fuse", ["1", "3", "5"])
def test_fuse_invariance_bitwise(fuse, monkeypatch):
    _, plain = _pair("Plain")
    monkeypatch.setenv("GS_FUSE", fuse)
    _, fused = _pair("Pallas")
    assert fused.fuse == int(fuse)
    plain.iterate(17)
    fused.iterate(17)
    for x, y in zip(plain.get_fields(), fused.get_fields()):
        np.testing.assert_array_equal(x, y)


def test_restore_fields_round_trip():
    _, a = _pair("Pallas")
    a.iterate(6)
    _, b = _pair("Pallas")
    b.restore_fields(a.get_fields(), a.step)
    a.iterate(5)
    b.iterate(5)
    for x, y in zip(a.get_fields(), b.get_fields()):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="does not match"):
        b.restore_fields([np.zeros((4, 4, 4))] * 2, 0)
    with pytest.raises(ValueError, match="declares 2"):
        b.restore_fields([np.zeros((16,) * 3)], 0)


def test_carry_round_trips_reference_state():
    """The reference's params and fields carried into the port are the
    same bits, and one step from the carried state matches the
    reference's step."""
    ref, port = _pair("Plain")
    ref.iterate(4)
    params = params_from_reference(
        {k: np.asarray(v) for k, v in ref.params._asdict().items()},
        torch.float32, "cpu",
    )
    for name in params._fields:
        assert getattr(params, name).item() == float(
            np.asarray(getattr(ref.params, name)))
        assert getattr(params, name).dtype == torch.float32
        assert torch.equal(getattr(params, name),
                           getattr(port.params, name))
    host = ref.get_fields()
    fields = fields_from_reference(host, "cpu")
    for t, h in zip(fields, host):
        np.testing.assert_array_equal(t.numpy(), h)
    port.fields = fields
    port.step = ref.step
    ref.iterate(1)
    port.iterate(1)
    for a, b in zip(ref.get_fields(), port.get_fields()):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="lack"):
        params_from_reference({"F": np.float32(0.1)}, torch.float32, "cpu")


def test_iterate_launches_nothing_on_cpu():
    """CPU tensors never reach the kernel; the plain chain runs."""
    _, port = _pair("Pallas")
    n = cuda_stencil.LAUNCHES
    port.iterate(4)
    assert cuda_stencil.LAUNCHES == n


def test_cuda_backend_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Simulation(Settings(L=8, backend="CUDA"))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Simulation(Settings(L=8, backend="GPU", kernel_language="Plain"))


def test_default_backend_is_the_card(monkeypatch):
    assert Settings().backend == "CUDA"
    assert config.load_backend_and_lang(Settings()) == ("cuda", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Simulation(Settings(L=8))


def test_kernel_path_refuses_uncarried_model_on_card(monkeypatch):
    """On a (monkeypatched) card, heat under Auto builds with its
    generated kernel; a model the generator refuses raises under CUDA
    and takes the plain path under Auto, with the gate recorded."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    # Blocks on the host's device: the gate is all this test reaches.
    monkeypatch.setattr(simulation, "select_devices",
                        lambda kind, n, devices: [torch.device("cpu")])
    sim = Simulation(Settings(L=8, model="heat", kernel_language="Auto"))
    assert sim.kernel_language == "cuda"
    assert sim.kernel_selection["kernel_gate"] == {
        "model": "heat", "generated": True, "reason": None}
    assert sim.spec.n_fields == 1 and sim.spec.name == "heat"

    def reaction(fields, laps, noise, params):
        (t,) = fields
        return (params.D * laps[0] + t.mean() - t,)

    heat = get_model("heat")
    base.register(type(heat)(name="mean_fixture", field_names=("t",),
                             boundaries=(0.0,), param_decls={"D": 0.1},
                             reaction=reaction, init=heat.init))
    try:
        with pytest.raises(SettingsError, match="'mean'"):
            Simulation(Settings(L=8, model="mean_fixture",
                                kernel_language="CUDA"))
        sim = Simulation(Settings(L=8, model="mean_fixture",
                                  kernel_language="Auto"))
        assert sim.kernel_language == "plain"
        assert sim.kernel_selection["kernel_gate"]["generated"] is False
    finally:
        base._REGISTRY.pop("mean_fixture", None)


@pytest.mark.parametrize("backend", ["TPU", "AMDGPU", "quantum"])
def test_unsupported_backend_names_accepted_values(backend):
    with pytest.raises(SettingsError, match="accepted: \\['cpu', 'cuda', 'gpu'\\]"):
        config.load_backend_and_lang(Settings(backend=backend))


@pytest.mark.parametrize("lang,path", [
    ("Pallas", "cuda"), ("Auto", "cuda"), ("CUDA", "cuda"),
    ("Plain", "plain"), ("XLA", "plain"), ("KernelAbstractions", "plain"),
])
def test_kernel_language_mapping(lang, path):
    s = Settings(backend="CPU", kernel_language=lang)
    assert config.load_backend_and_lang(s) == ("cpu", path)


def test_unsupported_precision_raises():
    with pytest.raises(SettingsError, match="Float16"):
        config.resolve_precision(Settings(precision="Float16"))


@pytest.mark.parametrize("key,value,dtype", [
    ("precision", "BFloat16", torch.bfloat16),
    ("compute_precision", "bf16_f32acc", torch.bfloat16),
    ("snapshot_bits", "8", torch.float32),
    ("snapshot_bits_ckpt", True, torch.float32),
])
def test_precision_settings_run(key, value, dtype):
    """The settings that raised before the bf16 path was ported now run:
    the fields take the posture's storage dtype and stay finite."""
    s = dataclasses.replace(Settings(L=8, backend="CPU", noise=0.1,
                                     precision="Float32", **GS),
                            **{key: value})
    sim = Simulation(s)
    sim.iterate(3)
    assert all(f.dtype == dtype and torch.isfinite(f).all()
               for f in sim.blocks[0])


@pytest.mark.parametrize("key,value", [
    ("halo_depth", 2), ("autotune", "quick"), ("supervise", True),
    ("faults", "step=3:kind=nan"), ("numerics", "boundary"),
    ("watchdog", "on"), ("xstats", "on"),
])
def test_unported_keys_raise_at_construction(key, value, monkeypatch,
                                            tmp_path):
    """Each key whose item is not ported raises. ``halo_depth`` acts
    since item 13b was ported: on one block there is no exchange to
    save, so the run is the default one, bitwise; so does ``autotune``
    since item 20 was ported. ``numerics`` acts
    since item 16b was ported: the mode resolves and the probe runs.
    ``supervise``, ``faults`` and ``watchdog`` act since item 17 was
    ported: a simulation builds, and the key resolves as the
    reference's. ``xstats`` acts since item 21b was ported: the
    analytics arm and the run is the default one, bitwise."""
    s = dataclasses.replace(Settings(L=8, backend="CPU"), **{key: value})
    if key in ("supervise", "faults", "watchdog"):
        from grayscott_jl_tpu.resilience import faults as ref_faults
        from grayscott_jl_tpu.resilience import supervisor as ref_sup
        from grayscott_jl_tpu.resilience import watchdog as ref_wd
        from grayscott_jl_tpu_torch.resilience import (faults, supervisor,
                                                       watchdog)

        Simulation(s).iterate(1)
        assert (supervisor.supervision_enabled(s)
                == ref_sup.supervision_enabled(s))
        assert (faults.FaultPlan.from_env(s).describe()
                == ref_faults.FaultPlan.from_env(s).describe())
        assert (watchdog.resolve_watchdog(s)
                == ref_wd.resolve_watchdog(s))
        return
    if key == "numerics":
        from grayscott_jl_tpu_torch.obs.numerics import resolve_numerics

        assert resolve_numerics(s) == value
        sim = Simulation(s)
        sim.iterate(3)
        assert sim.numerics_stats().finite
        return
    if key == "autotune":
        # Item 20 is ported: the key acts. Under Auto the tuner times the
        # shortlist (one plain candidate for a block on the CPU), and the
        # run is the default one, bitwise.
        monkeypatch.setenv("GS_AUTOTUNE_CACHE", str(tmp_path))
        sim, base = Simulation(s), Simulation(Settings(L=8, backend="CPU"))
        prov = sim.kernel_selection["autotune"]
        assert (prov["mode"], prov["source"]) == ("quick", "measured")
        assert prov["winner"]["kernel"] == sim.kernel_language == "plain"
        for x in (sim, base):
            x.iterate(3)
        for a, b in zip(sim.get_fields(), base.get_fields()):
            np.testing.assert_array_equal(a, b)
        return
    if key == "xstats":
        # Item 21b is ported: the key acts, as the reference's does. The
        # run records its store engine's library, bitwise the run
        # without analytics.
        from grayscott_jl_tpu.obs.xstats import resolve_xstats as ref_resolve
        from grayscott_jl_tpu_torch.config.settings import resolve_xstats

        assert resolve_xstats(s) is ref_resolve(s) is True
        sim, base = Simulation(s), Simulation(Settings(L=8, backend="CPU"))
        assert sim.xstats_enabled and not base.xstats_enabled
        assert [r["name"] for r in sim.executables] == ["libbplite"]
        for x in (sim, base):
            x.iterate(3)
        for a, b in zip(sim.get_fields(), base.get_fields()):
            np.testing.assert_array_equal(a, b)
        return
    if key == "halo_depth":
        sim, base = Simulation(s), Simulation(Settings(L=8, backend="CPU"))
        assert sim.halo_depth == value and sim.halo_depth_gate is None
        for x in (sim, base):
            x.iterate(3)
        for a, b in zip(sim.get_fields(), base.get_fields()):
            np.testing.assert_array_equal(a, b)
        return
    with pytest.raises(SettingsError, match=key):
        Simulation(s)


def test_mesh_override_raises(monkeypatch):
    """A mesh the devices cannot hold raises; one that factors them is
    taken (and, as in the reference, one device ignores the override)."""
    monkeypatch.setenv("GS_TPU_MESH_DIMS", "2,1,1")
    with pytest.raises(ValueError, match="GS_TPU_MESH_DIMS"):
        Simulation(Settings(L=8, backend="CPU"), n_devices=4)
    assert Simulation(Settings(L=8, backend="CPU"),
                      n_devices=2).domain.dims == (2, 1, 1)
    assert not Simulation(Settings(L=8, backend="CPU")).sharded
    monkeypatch.setenv("GS_TPU_MESH_DIMS", "1,1,1")
    Simulation(Settings(L=8, backend="CPU"))


def test_toml_parse_ignores_unknown_keys_and_reads_model_table():
    s = parse_settings_toml(
        'L = 12\nbogus_key = 3\nadios_config = "x.xml"\n'
        'backend = "CPU"\n[model]\nname = "heat"\nD = 0.3\n'
    )
    assert s.L == 12 and s.model == "heat"
    assert s.model_params == {"D": 0.3}
    with pytest.raises(SettingsError, match="unknown"):
        parse_settings_toml('[model]\nname = "heat"\nDx = 1.0\n')


def test_params_are_compute_dtype_tensors():
    """F + k computed from the 0-dim float32 params equals float32
    arithmetic, not a double sum rounded once."""
    s = Simulation(Settings(L=8, backend="CPU", precision="Float32",
                            F=0.1, k=0.2))
    for name in s.params._fields:
        p = getattr(s.params, name)
        assert p.dim() == 0 and p.dtype == torch.float32
    fk = (s.params.F + s.params.k).item()
    assert fk == float(np.float32(0.1) + np.float32(0.2))


@pytest.mark.parametrize("L", [12, 16, 64])
def test_seed_bounds_match_reference(L):
    from grayscott_jl_tpu.models import grayscott as ref_gs
    from grayscott_jl_tpu_torch.models import grayscott as port_gs

    assert port_gs.seed_bounds(L) == ref_gs.seed_bounds(L)
    with pytest.raises(ValueError, match="even"):
        port_gs.seed_bounds(L + 1)


@pytest.mark.parametrize("n", [1, 2, 6, 8, 12, 64])
def test_domain_copy_matches_reference(n):
    from grayscott_jl_tpu.parallel import domain as ref_domain
    from grayscott_jl_tpu_torch.parallel import domain

    assert domain.dims_create(n) == ref_domain.dims_create(n)
    a = domain.CartDomain.create(n, 30)
    b = ref_domain.CartDomain.create(n, 30)
    assert (a.dims, a.local_shape, a.storage_shape, a.padded) == (
        b.dims, b.local_shape, b.storage_shape, b.padded)
