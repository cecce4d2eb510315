"""The bfloat16 precision path of the port (``precision = "BFloat16"``,
``compute_precision = "bf16_f32acc"``/``"equality"``, ``GS_MID_BF16``)
against the reference on the CPU, and the environment variables the
port acts on or refuses.

Two plain versions exist for bf16 fields (ops/cuda_stencil.py): the
kernel's oracle (widen to float32, draw the noise unit in float32, round
once per stage), held against the reference's Pallas kernel in interpret
mode, and the Plain language (the reference's XLA path: the unit in the
storage dtype, accumulation in the params' dtype), held against the
reference's ``kernel_language = "Plain"``.

Tolerances: the oracle against the interpret kernel, one bf16 ulp
(rtol 2**-8; measured bitwise); ``GS_MID_BF16`` chains atol 2e-7 (the
float32 FMA contraction of XLA:CPU inside the interpreted kernel,
~6e-8 measured); one plain step of ``reaction_update`` one bf16 ulp
(measured bitwise); 10 Plain steps at L=16 atol 2e-2, the max reported
(measured bitwise). Inside the port every bf16 invariance is bitwise."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grayscott_jl_tpu.config import settings as ref_config
from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.models import get_model as ref_get_model
from grayscott_jl_tpu.ops import kernelgen as ref_kernelgen
from grayscott_jl_tpu.ops import noise as ref_noise
from grayscott_jl_tpu.ops import pallas_stencil
from grayscott_jl_tpu.ops import stencil as ref_stencil
from grayscott_jl_tpu.simulation import Simulation as RefSimulation
from grayscott_jl_tpu_torch import Settings, Simulation, driver
from grayscott_jl_tpu_torch.carry import params_from_reference
from grayscott_jl_tpu_torch.config import settings as config
from grayscott_jl_tpu_torch.io.bplite import BpReader, bf16_round
from grayscott_jl_tpu_torch.io.checkpoint import CheckpointWriter
from grayscott_jl_tpu_torch.models import SettingsError, get_model
from grayscott_jl_tpu_torch.obs.numerics import resolve_numerics
from grayscott_jl_tpu_torch.ops import cuda_stencil, kernelgen, stencil
from grayscott_jl_tpu_torch.ops.noise import uniform_pm1_block
from grayscott_jl_tpu_torch.resilience import integrity

GS = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0)
PHYSICS = {
    "grayscott": GS,
    "fhn": dict(model="fhn", dt=0.05, model_params={
        "a": 0.7, "b": 0.8, "eps": 0.08, "I": 0.5, "Dv": 0.2, "Dw": 0.0}),
    "brusselator": dict(model="brusselator", dt=0.05, model_params={
        "A": 1.0, "B": 3.0, "Du": 0.2, "Dv": 0.02}),
    "heat": dict(model="heat", dt=0.05, model_params={"D": 0.2}),
}
BF16_ULP = 2.0 ** -8
POSTURES = {"BFloat16": dict(precision="BFloat16"),
            "bf16_f32acc": dict(precision="Float32",
                                compute_precision="bf16_f32acc")}


def _bf16_fields(L, n, seed, shape=None):
    """``n`` fields of bf16 values (float32 arrays), u in [0, 1) and the
    others in [0, 0.5), from a numpy seed."""
    rng = np.random.default_rng(seed)
    shape = shape or (L, L, L)
    return [bf16_round(rng.uniform(0.0, 1.0 if i == 0 else 0.5, shape))
            for i in range(n)]


def _params(name, pdt, noise=0.1):
    """The reference's params of model ``name`` at ``pdt`` and the same
    values as the port's params."""
    ref = ref_get_model(name).make_params(
        RefSettings(noise=noise, **PHYSICS[name]), jnp.dtype(pdt))
    port = params_from_reference(
        {k: np.asarray(v) for k, v in ref._asdict().items()}, pdt, "cpu",
        model=get_model(name))
    return ref, port


def _port(arrays, dtype=torch.bfloat16):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
                 for a in arrays)


def _ref(arrays, dtype=jnp.bfloat16):
    return tuple(jnp.asarray(a).astype(dtype) for a in arrays)


def _assert_within_bf16_ulp(got, want, what):
    for g, w in zip(got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w).astype(np.float32)
        n_diff = int((g != w).sum())
        np.testing.assert_allclose(
            g, w, rtol=BF16_ULP, atol=BF16_ULP * 1e-3,
            err_msg=f"{what}: {n_diff} cells differ")


# ------------------------------------------------------------ postures

@pytest.mark.parametrize("precision,key,env", [
    ("Float32", "", None), ("Float32", "bf16_f32acc", None),
    ("Float32", "", "bf16_f32acc"), ("Float32", "bf16_f32acc", "equality"),
    ("Float32", "FP32", None), ("BFloat16", "", None),
    ("Float64", "bf16_f32acc", None), ("BFloat16", "bf16_f32acc", None),
    ("Float32", "fp16", None), ("Float32", "", " Equality "),
])
def test_compute_precision_resolves_as_the_reference(precision, key, env,
                                                     monkeypatch):
    """``GS_COMPUTE_PRECISION`` wins over the key; ``bf16_f32acc`` needs
    ``Float32``; unknown postures raise — as the reference resolves
    them."""
    if env is None:
        monkeypatch.delenv("GS_COMPUTE_PRECISION", raising=False)
    else:
        monkeypatch.setenv("GS_COMPUTE_PRECISION", env)
    try:
        want = ref_config.resolve_compute_precision(RefSettings(
            precision=precision, compute_precision=key))
    except ValueError as e:
        want = type(e)
    try:
        got = config.resolve_compute_precision(Settings(
            precision=precision, compute_precision=key))
    except SettingsError as e:
        got = type(e)
    if isinstance(want, type):
        assert got is SettingsError
    else:
        assert got == want


@pytest.mark.parametrize("precision,posture,dtype,params", [
    ("Float32", "", torch.float32, torch.float32),
    ("BFloat16", "", torch.bfloat16, torch.bfloat16),
    ("Float32", "bf16_f32acc", torch.bfloat16, torch.float32),
    ("Float32", "equality", torch.float32, torch.float32),
    ("Float64", "", torch.float64, torch.float64),
])
def test_simulation_splits_storage_and_compute(precision, posture, dtype,
                                               params):
    """The fields take the storage dtype, the params the compute dtype,
    as the reference's ``Simulation`` splits them."""
    sim = Simulation(Settings(L=8, backend="CPU", precision=precision,
                              compute_precision=posture))
    assert sim.dtype == dtype and sim.compute_dtype == params
    assert all(f.dtype == dtype for f in sim.blocks[0])
    assert all(p.dtype == params for p in sim.params)
    assert sim.compute_precision == (posture or "f32")


# --------------------------------------------------------------- noise

@pytest.mark.parametrize("offsets,row", [((0, 0, 0), 12), ((5, -3, 7), 40)])
def test_bf16_unit_noise_matches_reference_bitwise(offsets, row):
    want = ref_noise.uniform_pm1_block(
        jnp.asarray([3, 4], jnp.int32), 7, jnp.asarray(offsets, jnp.int32),
        (6, 12, 12), row, jnp.bfloat16)
    got = uniform_pm1_block((3, 4), 7, offsets, (6, 12, 12), row,
                            torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))


# ------------------------------------------------------------- stencil

@pytest.mark.parametrize("name", ["grayscott", "fhn"])
@pytest.mark.parametrize("pdt", ["bfloat16", "float32"])
def test_reaction_update_compute_dtype_matches_reference(name, pdt):
    """One plain step on bf16 padded fields, accumulated in float32
    (``bf16_f32acc``, params float32) or in bf16 (``BFloat16``)."""
    fields = _bf16_fields(10, 2, seed=11)
    noise_unit = bf16_round(np.random.default_rng(12).uniform(
        -1, 1, (8, 8, 8)))
    ref_params, params = _params(name, pdt)
    acc = jnp.float32 if pdt == "float32" else None
    want = ref_stencil.reaction_update(
        _ref(fields), ref_params.noise * jnp.asarray(noise_unit, jnp.bfloat16),
        ref_params, ref_get_model(name), compute_dtype=acc)
    got = stencil.reaction_update(
        _port(fields), stencil.scaled_noise(
            params.noise, torch.from_numpy(noise_unit).to(torch.bfloat16)),
        params, get_model(name),
        compute_dtype=torch.float32 if acc is not None else None)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _assert_within_bf16_ulp(got, want, f"{name} {pdt}")


def test_reaction_update_matching_dtype_casts_nothing():
    """``compute_dtype`` equal to the fields' dtype is the historical
    dataflow, bit for bit."""
    rng = np.random.default_rng(3)
    pads = tuple(torch.from_numpy(rng.uniform(0, 1, (6, 6, 6)))
                 .float() for _ in range(2))
    params = get_model("grayscott").make_params(Settings(**GS),
                                                torch.float32, "cpu")
    a = stencil.reaction_update(pads, 0.0, params, get_model("grayscott"))
    b = stencil.reaction_update(pads, 0.0, params, get_model("grayscott"),
                                compute_dtype=torch.float32)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------ kernel oracle

@pytest.mark.parametrize("name", ["grayscott", "fhn"])
@pytest.mark.parametrize("pdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("fuse", [1, 2])
def test_kernel_oracle_matches_reference_interpret(name, pdt, fuse):
    """The bf16 kernel's oracle against the reference's Pallas kernel in
    interpret mode, no faces: bf16 params (``BFloat16``) and float32
    params (``bf16_f32acc``)."""
    L = 16
    fields = _bf16_fields(L, 2, seed=fuse)
    ref_params, params = _params(name, pdt)
    spec_r = ref_kernelgen.get_spec(ref_get_model(name))
    want = pallas_stencil.fused_step(
        _ref(fields), ref_params, jnp.asarray((3, 4, 7), jnp.int32), None,
        spec=spec_r, fuse=fuse, allow_interpret=True)
    got = cuda_stencil.plain_chain(
        _port(fields), params, (3, 4, 7), spec=kernelgen.get_spec(
            get_model(name)), fuse=fuse, oracle=True)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _assert_within_bf16_ulp(got, want, f"{name} {pdt} fuse={fuse}")


@pytest.mark.parametrize("pdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("fuse", [2, 3])
def test_kernel_oracle_xchain_matches_reference_interpret(pdt, fuse):
    """The x-chain form on a y-extended operand (rows from global
    y = -1): pinning on global coordinates, the last stage unpinned."""
    nx, ny, nz = 8, 12, 16
    fields = _bf16_fields(0, 2, seed=20 + fuse, shape=(nx, ny, nz))
    faces = _bf16_fields(0, 4, seed=30 + fuse, shape=(fuse, ny, nz))
    ref_params, params = _params("grayscott", pdt)
    offs = (8, -1, 0)
    want = pallas_stencil.fused_step(
        _ref(fields), ref_params, jnp.asarray((3, 4, 7), jnp.int32),
        _ref(faces), spec=ref_kernelgen.get_spec(ref_get_model("grayscott")),
        fuse=fuse, allow_interpret=True,
        offsets=jnp.asarray(offs, jnp.int32), row=16)
    got = cuda_stencil.plain_xchain(
        _port(fields), params, (3, 4, 7), _port(faces),
        spec=kernelgen.get_spec(get_model("grayscott")), fuse=fuse,
        use_noise=True, offsets=offs, row=16, oracle=True)
    _assert_within_bf16_ulp(got, want, f"xchain {pdt} fuse={fuse}")


@pytest.mark.parametrize("fuse", [2, 3, 4])
def test_mid_bf16_oracle_matches_reference_interpret(fuse, monkeypatch):
    """``GS_MID_BF16=1`` on float32 fields: the first ``fuse - 1``
    stages round through bf16, as the reference kernel's bf16 mid
    windows do (atol 2e-7)."""
    monkeypatch.setenv("GS_MID_BF16", "1")
    rng = np.random.default_rng(fuse)
    fields = [rng.uniform(0, 1, (16, 16, 16)).astype(np.float32),
              rng.uniform(0, 0.5, (16, 16, 16)).astype(np.float32)]
    ref_params, params = _params("grayscott", "float32")
    want = pallas_stencil.fused_step(
        _ref(fields, jnp.float32), ref_params,
        jnp.asarray((3, 4, 7), jnp.int32), None,
        spec=ref_kernelgen.get_spec(ref_get_model("grayscott")), fuse=fuse,
        allow_interpret=True)
    assert cuda_stencil.mid_bf16_requested(torch.float32)
    got = cuda_stencil.plain_chain(
        _port(fields, torch.float32), params, (3, 4, 7),
        spec=kernelgen.get_spec(get_model("grayscott")), fuse=fuse,
        oracle=True, mid_bf16=True)
    exact = cuda_stencil.plain_chain(
        _port(fields, torch.float32), params, (3, 4, 7),
        spec=kernelgen.get_spec(get_model("grayscott")), fuse=fuse)
    for g, w, e in zip(got, want, exact):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-7)
        assert not torch.equal(g, e)  # the bf16 mids are not exact


def test_oracle_is_the_plain_version_for_float32_and_float64():
    """Without bf16 the oracle computes what the plain version does."""
    for dtype in (torch.float32, torch.float64):
        rng = np.random.default_rng(5)
        f = tuple(torch.from_numpy(rng.uniform(0, 1, (10, 10, 10))).to(dtype)
                  for _ in range(2))
        params = get_model("grayscott").make_params(
            Settings(noise=0.1, **GS), dtype, "cpu")
        spec = kernelgen.get_spec(get_model("grayscott"))
        a = cuda_stencil.plain_chain(f, params, (0, 1, 2), spec=spec, fuse=3)
        b = cuda_stencil.plain_chain(f, params, (0, 1, 2), spec=spec, fuse=3,
                                     oracle=True)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_ledger_counts_window_and_mid_itemsizes():
    """bf16 windows are 2 B/cell (two fields: depth 8, 221,184 B of
    cells, a 128 B lead zone per window and the mbarrier); bf16
    mids on float32 keep the float32 input window (depth 5); every
    window at the padded z stride."""
    bars = cuda_stencil.BARRIER_BYTES
    assert cuda_stencil.smem_bytes(2, 8) == (
        (64 + 24 * 24 * 48) * 2 * 2 * 2 + bars)
    assert cuda_stencil.max_feasible_fuse(2) == 8
    assert cuda_stencil.max_feasible_fuse(4, mid_itemsize=2) == 5
    assert cuda_stencil.smem_bytes(4, 1, mid_itemsize=2) == (
        2 * (32 + 10 * 10 * 36 + 16) * 4 + bars)
    assert cuda_stencil.smem_bytes(4, 3, mid_itemsize=2) == (
        2 * (32 + 14 * 14 * 40) * (4 + 2 * 2) + bars)
    assert cuda_stencil.chain_cap(torch.bfloat16, 1) == 12


# ------------------------------------------------------- the Plain path

@pytest.mark.parametrize("posture", sorted(POSTURES))
@pytest.mark.parametrize("name", ["grayscott", "fhn"])
def test_plain_path_matches_reference_plain(posture, name):
    """10 steps at L=16, noise 0.1, the Plain language in both packages
    (atol 2e-2; the max is reported)."""
    kw = dict(L=16, noise=0.1, backend="CPU", kernel_language="Plain",
              **PHYSICS[name], **POSTURES[posture])
    ref = RefSimulation(RefSettings(**kw), n_devices=1, seed=3)
    port = Simulation(Settings(**kw), seed=3)
    assert port.dtype == torch.bfloat16
    ref.iterate(10)
    port.iterate(10)
    for a, b in zip(ref.get_fields(), port.get_fields()):
        a = np.asarray(a).astype(np.float32)
        err = float(np.abs(a - b).max())
        assert b.dtype == np.float32 and err <= 2e-2, (posture, name, err)


# ------------------------------------------------ bitwise in the port

def _settings(posture, **kw):
    return Settings(L=16, noise=0.1, backend="CPU",
                    kernel_language="Pallas", **GS, **POSTURES[posture],
                    **kw)


@pytest.mark.parametrize("posture", sorted(POSTURES))
@pytest.mark.parametrize("fuse", ["1", "2"])
def test_bf16_mesh_equals_single_block_bitwise(posture, fuse, monkeypatch):
    monkeypatch.setenv("GS_FUSE", fuse)
    single = Simulation(_settings(posture), seed=2)
    mesh = Simulation(_settings(posture), seed=2, mesh_dims=(2, 2, 2),
                      devices=["cpu"] * 8)
    single.iterate(6)
    mesh.iterate(6)
    for a, b in zip(single.get_fields(), mesh.get_fields()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("posture", sorted(POSTURES))
def test_bf16_fused_chain_equals_single_steps_bitwise(posture, monkeypatch):
    steps = Simulation(_settings(posture), seed=2)
    for _ in range(6):
        steps.iterate(1)
    monkeypatch.setenv("GS_FUSE", "2")
    chain = Simulation(_settings(posture), seed=2)
    chain.iterate(6)
    for a, b in zip(steps.get_fields(), chain.get_fields()):
        assert np.array_equal(a, b)


def _write(path, posture, **kw):
    base = dict(L=16, steps=8, plotgap=4, noise=0.1, backend="CPU",
                kernel_language="Pallas", **GS, **POSTURES[posture],
                output=str(path / "gs.bp"), checkpoint=True,
                checkpoint_freq=4, checkpoint_output=str(path / "ckpt.bp"))
    base.update(kw)
    lines = [f"{k} = {str(v).lower() if isinstance(v, bool) else repr(v)}"
             for k, v in base.items()]
    cfg = path / f"{base.get('restart', False)}.toml"
    cfg.write_text("\n".join(lines).replace("'", '"') + "\n")
    return str(cfg)


@pytest.mark.parametrize("posture", sorted(POSTURES))
def test_bf16_restart_is_bitwise(posture, tmp_path):
    """A bf16 checkpoint (stored as ``"bfloat16"``) restarts the run
    bitwise; the store holds the bf16 values."""
    driver.main([_write(tmp_path, posture)])
    with BpReader(str(tmp_path / "ckpt.bp")) as r:
        assert r.inquire_variable("u").stored == "bfloat16"
    with BpReader(str(tmp_path / "gs.bp")) as r:
        end = [r.get(n, step=1) for n in ("U", "V")]
    driver.main([_write(tmp_path, posture, restart=True,
                        restart_input=str(tmp_path / "ckpt.bp"),
                        restart_step=4, output=str(tmp_path / "re.bp"),
                        checkpoint=False)])
    with BpReader(str(tmp_path / "re.bp")) as r:
        again = [r.get(n, step=r.num_steps() - 1) for n in ("U", "V")]
    sim = Simulation(_settings(posture), seed=0)
    sim.iterate(8)
    for a, b, c in zip(end, again, sim.get_fields()):
        assert a.dtype == np.float32
        assert np.array_equal(a, b) and np.array_equal(a, c)
        assert np.array_equal(a, bf16_round(a))


# ------------------------------------------------------ environment

@pytest.mark.parametrize("var,value,off,item", [
    ("GS_NUMERICS", "boundary", "off", "Queue 1 item 16"),
    ("GS_SUPERVISE", "1", "0", "Queue 1 item 17"),
    ("GS_FAULTS", "step=3:kind=nan", "", "Queue 1 item 17"),
    ("GS_WATCHDOG", "on", "auto", "Queue 1 item 17"),
    ("GS_SDC_CHECK", "spot", "off", "Queue 1 item 17"),
    ("GS_CKPT_REPLICAS", "2", "1", "Queue 1 item 7"),
    ("GS_SCRUB", "1", "false", "Queue 1 item 7"),
    ("GS_AUTOTUNE", "quick", "cached", "Queue 1 item 20"),
    ("GS_XSTATS", "on", "off", "Queue 1 item 21"),
])
def test_unported_env_vars_raise_naming_the_item(var, value, off, item,
                                                 monkeypatch, tmp_path):
    """A variable that turns on a subsystem the port lacks raises at
    construction, naming its ROADMAP item; its "off" values run. The
    integrity variables' item has ported them, ``GS_NUMERICS``'s (item
    16b), the supervisor's, fault plans', watchdog's and SDC screen's
    (item 17), ``GS_AUTOTUNE``'s (item 20) and ``GS_XSTATS``'s (item
    21b): they act now."""
    if var in ("GS_SUPERVISE", "GS_FAULTS", "GS_WATCHDOG", "GS_SDC_CHECK"):
        from grayscott_jl_tpu_torch.resilience import (faults, sdc,
                                                       supervisor, watchdog)

        assert var not in config.NOT_PORTED_ENV
        resolved = {
            "GS_SUPERVISE": lambda: supervisor.supervision_enabled(),
            "GS_FAULTS": lambda: faults.FaultPlan.from_env().describe(),
            "GS_WATCHDOG": lambda: watchdog.resolve_watchdog() is not None,
            "GS_SDC_CHECK": lambda: sdc.resolve_sdc()["mode"],
        }[var]
        monkeypatch.setenv(var, value)
        Simulation(Settings(L=8, backend="CPU")).iterate(1)
        on = resolved()
        monkeypatch.setenv(var, off)
        Simulation(Settings(L=8, backend="CPU")).iterate(1)
        assert (on, resolved()) == {
            "GS_SUPERVISE": (True, False),
            "GS_FAULTS": ([{"step": 3, "kind": "nan", "fired": False}], []),
            "GS_WATCHDOG": (True, False),
            "GS_SDC_CHECK": ("spot", "off"),
        }[var]
        return
    if var == "GS_NUMERICS":
        assert var not in config.NOT_PORTED_ENV
        monkeypatch.setenv(var, value)
        sim = Simulation(Settings(L=8, backend="CPU"))
        sim.iterate(1)
        assert resolve_numerics(sim.settings) == value
        rep = sim.snapshot_async(numerics=True).numerics_report()
        assert set(rep.fields) == {"u", "v"} and rep.finite
        monkeypatch.setenv(var, off)
        assert resolve_numerics(Settings()) == off
        return
    if var in ("GS_CKPT_REPLICAS", "GS_SCRUB"):
        assert var not in config.NOT_PORTED_ENV
        monkeypatch.setenv(var, value)
        Simulation(Settings(L=8, backend="CPU")).iterate(1)
        if var == "GS_CKPT_REPLICAS":
            assert integrity.resolve_replicas() == int(value)
            w = CheckpointWriter(Settings(
                L=4, checkpoint_output=str(tmp_path / "c.bp")), np.float32)
            w.close()
            assert w.paths == [str(tmp_path / "c.bp"),
                               str(tmp_path / "c.bp.r1")]
        else:
            assert integrity.resolve_scrub() == (True, 1)
        monkeypatch.setenv(var, off)
        Simulation(Settings(L=8, backend="CPU")).iterate(1)
        cfg = integrity.resolve_config()
        assert (cfg["replicas"], cfg["scrub"]) == (1, False)
        return
    if var == "GS_XSTATS":
        # Ported by ``item`` (21b): the build and launch analytics arm,
        # recording the store engine's library; "off" leaves them
        # unarmed.
        assert var not in config.NOT_PORTED_ENV
        monkeypatch.setenv(var, value)
        sim = Simulation(Settings(L=8, backend="CPU"))
        sim.iterate(1)
        assert sim.xstats_enabled
        assert [r["name"] for r in sim.executables] == ["libbplite"]
        monkeypatch.setenv(var, off)
        sim = Simulation(Settings(L=8, backend="CPU"))
        assert not sim.xstats_enabled and sim.executables == []
        return
    if var == "GS_AUTOTUNE":
        # Ported by ``item``: the tuner measures the shortlist, stores
        # the winner in GS_AUTOTUNE_CACHE, and the "off" value reads it
        # back under ``cached``.
        assert var not in config.NOT_PORTED_ENV
        monkeypatch.setenv("GS_AUTOTUNE_CACHE", str(tmp_path / "tune"))
        monkeypatch.setenv(var, value)
        prov = Simulation(Settings(L=8, backend="CPU")).kernel_selection[
            "autotune"]
        assert (prov["mode"], prov["source"]) == (value, "measured")
        assert prov["candidates_timed"] >= 1
        monkeypatch.setenv(var, off)
        sim = Simulation(Settings(L=8, backend="CPU"))
        assert sim.kernel_selection["autotune"]["cache"] == "hit"
        sim.iterate(1)
        return
    monkeypatch.setenv(var, value)
    with pytest.raises(SettingsError, match=f"{var}.*{item}"):
        Simulation(Settings(L=8, backend="CPU"))
    monkeypatch.setenv(var, off)
    Simulation(Settings(L=8, backend="CPU")).iterate(1)


def test_reference_environment_no_longer_ignored(monkeypatch):
    """The environment the reference acts on: the subsystems the port
    lacks raise; the postures it has act (bf16 fields, a coded store,
    the numerics probe over the bf16 fields), and so does supervision
    (Queue 1 item 17)."""
    for var, value in (("GS_COMPUTE_PRECISION", "bf16_f32acc"),
                       ("GS_SNAPSHOT_BITS", "8"), ("GS_NUMERICS", "boundary"),
                       ("GS_CKPT_REPLICAS", "2")):
        monkeypatch.setenv(var, value)
    s = Settings(L=16, backend="CPU", precision="Float32")
    # The build and launch analytics are ported (Queue 1 item 21b): they
    # act.
    monkeypatch.setenv("GS_XSTATS", "1")
    assert Simulation(s).xstats_enabled
    monkeypatch.delenv("GS_XSTATS")
    # Supervision is ported (Queue 1 item 17): it acts.
    monkeypatch.setenv("GS_SUPERVISE", "1")
    from grayscott_jl_tpu_torch.resilience.supervisor import (
        supervision_enabled)

    assert supervision_enabled(s)
    Simulation(s)
    monkeypatch.delenv("GS_SUPERVISE")
    # The numerics probes are ported (Queue 1 item 16b): they act.
    assert resolve_numerics(s) == "boundary"
    rep = Simulation(s).snapshot_async(numerics=True).numerics_report()
    assert rep.fields["u"]["max"] == 1.0
    # Checkpoint replicas are ported (ROADMAP Queue 1 item 7): they act.
    assert integrity.resolve_replicas() == 2
    sim = Simulation(s)
    assert sim.dtype == torch.bfloat16
    assert sim.compute_dtype == torch.float32
    assert sim.snapshot_codec.posture() == "u:8,v:8"
    assert not sim.snapshot_codec.ckpt
    monkeypatch.setenv("GS_SNAPSHOT_BITS_CKPT", "1")
    assert Simulation(s).snapshot_codec.posture() == "u:8,v:8+ckpt"


def test_mid_bf16_env_is_read_for_float32_only(monkeypatch):
    monkeypatch.setenv("GS_MID_BF16", "1")
    assert cuda_stencil.mid_bf16_requested(torch.float32)
    assert not cuda_stencil.mid_bf16_requested(torch.bfloat16)
    assert not cuda_stencil.mid_bf16_requested(torch.float64)
    assert cuda_stencil.chain_cap(torch.float32) == 5
    monkeypatch.setenv("GS_MID_BF16", "true")  # only "1" arms it
    assert not cuda_stencil.mid_bf16_requested(torch.float32)
    assert pallas_stencil.mid_itemsize_for(jnp.float32) == 4


def test_kernel_selection_records_the_posture():
    sim = Simulation(Settings(L=8, backend="CPU", kernel_language="Auto",
                              compute_precision="bf16_f32acc",
                              precision="Float32", snapshot_bits="v:6"))
    assert sim.kernel_selection["compute_precision"] == "bf16_f32acc"
    assert sim.kernel_selection["snapshot_codec"] == "v:6"
