"""The port's plain stencil core against the reference
(grayscott_jl_tpu_torch/ops/stencil.py vs grayscott_jl_tpu/ops/stencil.py),
for every registered model's reaction.

Tolerance: atol 1e-6 (float32) and 1e-13 (float64). The two compute the
same expression in the same order, but XLA:CPU contracts some
multiply-adds into FMAs and torch eager rounds every operation, so the
results differ by a few ulps; the reference's own stepwise and fused
paths differ the same way on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grayscott_jl_tpu import models as ref_models
from grayscott_jl_tpu.ops import stencil as ref_stencil
from grayscott_jl_tpu_torch import models
from grayscott_jl_tpu_torch.carry import params_from_reference
from grayscott_jl_tpu_torch.config.settings import Settings
from grayscott_jl_tpu_torch.ops import stencil

ATOL = {"float32": 1e-6, "float64": 1e-13}
MODELS = ("grayscott", "brusselator", "fhn", "heat")


@pytest.fixture
def x64():
    prior = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prior)


def _padded(rng, n, dtype, nf=1):
    return [rng.uniform(0.0, 1.0, (n + 2,) * 3).astype(dtype)
            for _ in range(nf)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_laplacian_matches_reference(dtype, x64):
    rng = np.random.default_rng(1)
    (x,) = _padded(rng, 12, dtype)
    want = np.asarray(ref_stencil.laplacian(jnp.asarray(x)))
    got = stencil.laplacian(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("value", [0.0, 1.0, 3.0])
def test_pad_with_boundary_matches_reference(value):
    x = np.random.default_rng(2).uniform(size=(3, 4, 5)).astype(np.float32)
    want = np.asarray(ref_stencil.pad_with_boundary(jnp.asarray(x), value))
    got = stencil.pad_with_boundary(torch.from_numpy(x), value).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("with_noise", [False, True])
def test_reaction_update_matches_reference(model, dtype, with_noise, x64):
    rng = np.random.default_rng(4)
    ref_model = ref_models.get_model(model)
    port_model = models.get_model(model)
    nf = port_model.n_fields
    pads = _padded(rng, 10, dtype, nf)
    settings = Settings(noise=0.1, dt=0.5, Du=0.2, Dv=0.1, F=0.02, k=0.048)
    ref_params = ref_model.make_params(settings, jnp.dtype(dtype))
    params = params_from_reference(
        {k: np.asarray(v) for k, v in ref_params._asdict().items()},
        dtype, "cpu", model=port_model,
    )
    if with_noise:
        unit = rng.uniform(-1, 1, (10, 10, 10)).astype(dtype)
        ref_nz = ref_params.noise * jnp.asarray(unit)
        nz = params.noise * torch.from_numpy(unit)
    else:
        ref_nz = jnp.asarray(0.0, dtype)
        nz = 0.0
    want = ref_stencil.reaction_update(
        tuple(jnp.asarray(p) for p in pads), ref_nz, ref_params, ref_model
    )
    got = stencil.reaction_update(
        tuple(torch.from_numpy(p) for p in pads), nz, params, port_model
    )
    assert len(got) == nf
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL[dtype])
