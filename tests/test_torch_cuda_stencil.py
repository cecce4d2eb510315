"""The fused-step dispatch (grayscott_jl_tpu_torch/ops/cuda_stencil.py).

On the CPU: the port's ``fused_step`` (whose CPU path is the plain
chain) against the reference's ``pallas_stencil.fused_step`` run in
interpret mode, as ``tests/unit/test_pallas.py`` runs it; the
shared-memory ledger; the faces and arity checks. The CUDA kernel
itself is held against the plain version on the card by
tests/test_torch_card.py and chip_smoke.py.

Tolerance against the reference: atol 2e-6 (float32) and 1e-13
(float64) over at most three steps from random fields. Both sides
compute the same expressions in the same order; XLA:CPU contracts
multiply-adds into FMAs inside the interpreted kernel and torch does
not, so the float32 results drift by a few ulps per step."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.models import grayscott as ref_gs
from grayscott_jl_tpu.ops import kernelgen as ref_kernelgen
from grayscott_jl_tpu.ops import pallas_stencil
from grayscott_jl_tpu_torch.carry import (
    fields_from_reference,
    params_from_reference,
)
from grayscott_jl_tpu_torch.models import get_model, grayscott
from grayscott_jl_tpu_torch.ops import cuda_stencil, kernelgen

ATOL = {"float32": 2e-6, "float64": 1e-13}
REF_SPEC = ref_kernelgen.get_spec(ref_gs.MODEL)
SPEC = kernelgen.get_spec(grayscott.MODEL)
KW = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0)


@pytest.fixture
def x64():
    prior = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prior)


def _state(L, dtype, noise, seed=0):
    rng = np.random.default_rng(seed)
    fields = [rng.uniform(0.0, 1.0, (L, L, L)).astype(dtype)
              for _ in range(2)]
    ref_params = ref_gs.Params.from_settings(
        RefSettings(noise=noise, **KW), jnp.dtype(dtype)
    )
    params = params_from_reference(
        {k: np.asarray(v) for k, v in ref_params._asdict().items()},
        dtype, "cpu",
    )
    return fields, ref_params, params


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("noise", [0.0, 0.1])
@pytest.mark.parametrize("fuse", [1, 2, 3])
def test_fused_step_matches_reference_interpret(dtype, noise, fuse, x64):
    L = 8
    fields, ref_params, params = _state(L, dtype, noise, seed=fuse)
    seeds = (9, 17, 5)
    want = pallas_stencil.fused_step(
        tuple(jnp.asarray(f) for f in fields), ref_params,
        jnp.asarray(seeds, jnp.int32), None, spec=REF_SPEC,
        use_noise=noise != 0, fuse=fuse,
    )
    launches = cuda_stencil.LAUNCHES
    got = cuda_stencil.fused_step(
        fields_from_reference(fields, "cpu"), params, seeds, spec=SPEC,
        use_noise=noise != 0, fuse=fuse,
    )
    assert cuda_stencil.LAUNCHES == launches  # CPU tensors: plain path
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL[dtype])


@pytest.mark.parametrize("fuse", [2, 3, 7])
def test_fused_chain_is_k_single_steps_bitwise(fuse):
    fields, _, params = _state(12, "float32", 0.1)
    f0 = fields_from_reference(fields, "cpu")
    chain = cuda_stencil.fused_step(f0, params, (0, 3, 10), spec=SPEC,
                                    fuse=fuse)
    steps = f0
    for s in range(fuse):
        steps = cuda_stencil.plain_step(steps, params, (0, 3, 10 + s),
                                        spec=SPEC)
    for a, b in zip(chain, steps):
        assert torch.equal(a, b)


def test_noise_offsets_and_row_key_the_draw():
    """A block at a global offset draws the noise of those global cells:
    stepping the whole grid equals stepping with the block's own
    offsets, cell for cell, away from the block edges."""
    fields, _, params = _state(8, "float32", 0.5)
    f = fields_from_reference(fields, "cpu")
    whole = cuda_stencil.plain_step(f, params, (0, 1, 2), spec=SPEC, row=8)
    part = cuda_stencil.plain_step(
        tuple(x[4:].contiguous() for x in f), params, (0, 1, 2), spec=SPEC,
        offsets=(4, 0, 0), row=8,
    )
    for a, b in zip(whole, part):
        assert torch.equal(a[5:], b[1:])


@pytest.mark.parametrize("itemsize,cap", [(4, 5), (8, 2)])
def test_shared_memory_ledger_caps(itemsize, cap):
    assert cuda_stencil.max_feasible_fuse(itemsize) == cap
    assert cuda_stencil.smem_bytes(itemsize, cap) <= cuda_stencil.SMEM_LIMIT
    assert cuda_stencil.smem_bytes(itemsize, cap + 1) > cuda_stencil.SMEM_LIMIT
    # float32 at fuse=5: 2 fields x 2 buffers x (a 128 B lead zone and
    # 18 x 18 x 44 cells, the 42-cell z rows padded to 16 B, rounded up
    # to 128 B) x 4 B, and the mbarrier.
    assert cuda_stencil.smem_bytes(4, 5) == (
        2 * 2 * (32 + 18 * 18 * 44 + 16) * 4 + cuda_stencil.BARRIER_BYTES)
    assert cuda_stencil.max_feasible_fuse(itemsize, n_fields=1) >= cap


def test_faces_raise():
    """The reference's arity checks on ``faces`` and the faces' shapes
    (the kernel reads them by index); the valid forms run."""
    fields, _, params = _state(4, "float32", 0.0)
    f = fields_from_reference(fields, "cpu")
    face = torch.zeros((2, 4, 4))
    out = cuda_stencil.fused_step(f, params, (0, 0, 0), (face,) * 4,
                                  spec=SPEC, fuse=2)
    assert out[0].shape == (4, 4, 4)
    with pytest.raises(ValueError, match=r"x-chain faces must be \(3, 4, 4\)"):
        cuda_stencil.fused_step(f, params, (0, 0, 0), (face,) * 4,
                                spec=SPEC, fuse=3)
    with pytest.raises(ValueError, match=r"6n faces must be \(1, 4, 4\)"):
        cuda_stencil.fused_step(f, params, (0, 0, 0), (face,) * 12,
                                spec=SPEC, fuse=1)
    with pytest.raises(ValueError, match="y_halo == fuse"):
        cuda_stencil.fused_step(f, params, (0, 0, 0), (face,) * 4,
                                spec=SPEC, fuse=2, y_halo=1)
    with pytest.raises(ValueError, match="x-chain form or the 12-tuple"):
        cuda_stencil.fused_step(f, params, (0, 0, 0), (face,) * 5,
                                spec=SPEC)
    with pytest.raises(ValueError, match="full-faces 3D mode is fuse=1"):
        cuda_stencil.fused_step(f, params, (0, 0, 0), (face,) * 12,
                                spec=SPEC, fuse=2)
    with pytest.raises(ValueError, match="requires fuse >= 2"):
        cuda_stencil.fused_step(f, params, (0, 0, 0), (face,) * 4,
                                spec=SPEC, fuse=1)


def test_arity_and_depth_checks():
    fields, _, params = _state(4, "float32", 0.0)
    f = fields_from_reference(fields, "cpu")
    with pytest.raises(ValueError, match="declares 2 field"):
        cuda_stencil.fused_step(f[:1], params, (0, 0, 0), spec=SPEC)
    with pytest.raises(ValueError, match="fuse must be >= 1"):
        cuda_stencil.fused_step(f, params, (0, 0, 0), spec=SPEC, fuse=0)


def test_generation_gate_names_the_generator():
    """Every built-in model passes the generator's gate; a reaction with
    a cross-cell op is refused with the generator's reason, which names
    the op."""
    for name in ("grayscott", "brusselator", "fhn", "heat"):
        assert kernelgen.generation_gate_reason(get_model(name)) is None
        assert kernelgen.get_spec(get_model(name)).n_fields == (
            get_model(name).n_fields)

    def reaction(fields, laps, noise, params):
        (t,) = fields
        return (params.D * laps[0] + t.sum() - t,)

    heat = get_model("heat")
    refused = type(heat)(name="sum_fixture", field_names=("t",),
                         boundaries=(0.0,), param_decls={"D": 0.1},
                         reaction=reaction, init=heat.init)
    reason = kernelgen.generation_gate_reason(refused)
    assert reason.startswith("reaction uses non-elementwise primitive(s)")
    assert "'sum'" in reason
    with pytest.raises(kernelgen.KernelGenError, match="sum_fixture"):
        kernelgen.get_spec(refused)
