"""The face modes' plain versions (grayscott_jl_tpu_torch/ops/
cuda_stencil.py: ``plain_step`` with 6n faces, ``plain_xchain``)
against the reference's ``_xla_fallback`` with faces and
``_xla_xchain_fallback`` on the CPU — the functions the reference's
sharded runs take off the TPU, and the oracles the CUDA kernel's face
modes are held to bitwise on the card (tests/test_torch_card.py,
chip_smoke.py).

Inputs are random fields and faces from a seeded numpy generator.
Tolerance: atol 2e-6 (float32) and 1e-13 (float64) over at most four
stages, as tests/test_torch_cuda_stencil.py: the same operations in the
same order, with XLA:CPU free to contract multiply-adds into FMAs. The
whole output is compared, the computed out-of-domain rows of a
y-extended operand included."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.models import grayscott as ref_gs
from grayscott_jl_tpu.ops import kernelgen as ref_kernelgen
from grayscott_jl_tpu.ops import pallas_stencil
from grayscott_jl_tpu_torch.carry import params_from_reference
from grayscott_jl_tpu_torch.models import grayscott
from grayscott_jl_tpu_torch.ops import cuda_stencil, kernelgen

ATOL = {"float32": 2e-6, "float64": 1e-13}
REF_SPEC = ref_kernelgen.get_spec(ref_gs.MODEL)
SPEC = kernelgen.get_spec(grayscott.MODEL)
KW = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0)
SEEDS = (9, 17, 5)


@pytest.fixture
def x64():
    prior = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prior)


def _params(dtype, noise):
    ref = ref_gs.Params.from_settings(
        RefSettings(noise=noise, **KW), jnp.dtype(dtype))
    port = params_from_reference(
        {k: np.asarray(v) for k, v in ref._asdict().items()}, dtype, "cpu")
    return ref, port


def _arrays(rng, shapes, dtype):
    return [rng.uniform(0.0, 1.0, s).astype(dtype) for s in shapes]


def _compare(want, got, dtype):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("noise", [0.0, 0.1])
@pytest.mark.parametrize("shape,offsets", [
    ((6, 7, 9), (6, 7, 0)), ((8, 8, 8), (0, 8, 16)),
])
def test_faces6_step_matches_reference(dtype, noise, shape, offsets, x64):
    rng = np.random.default_rng([len(dtype), int(noise * 10), *shape])
    nx, ny, nz = shape
    fields = _arrays(rng, [shape] * 2, dtype)
    faces = _arrays(rng, [(1, ny, nz)] * 4 + [(nx, 1, nz)] * 4
                    + [(nx, ny, 1)] * 4, dtype)
    ref_params, params = _params(dtype, noise)
    want = pallas_stencil._xla_fallback(
        tuple(map(jnp.asarray, fields)), ref_params,
        jnp.asarray(SEEDS, jnp.int32), tuple(map(jnp.asarray, faces)),
        spec=REF_SPEC, use_noise=noise != 0,
        offsets=jnp.asarray(offsets, jnp.int32), row=24,
    )
    launches = cuda_stencil.LAUNCHES
    got = cuda_stencil.fused_step(
        tuple(map(torch.from_numpy, fields)), params, SEEDS,
        tuple(map(torch.from_numpy, faces)), spec=SPEC,
        use_noise=noise != 0, offsets=offsets, row=24,
    )
    assert cuda_stencil.LAUNCHES == launches  # CPU tensors: plain path
    _compare(want, got, dtype)
    direct = cuda_stencil.plain_step(
        tuple(map(torch.from_numpy, fields)), params, SEEDS,
        tuple(map(torch.from_numpy, faces)), spec=SPEC,
        use_noise=noise != 0, offsets=offsets, row=24,
    )
    for a, b in zip(got, direct):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("noise", [0.0, 0.1])
@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("y_extended", [False, True])
def test_xchain_matches_reference(dtype, noise, depth, y_extended, x64):
    """The x-chain at depths 2 to 4, on a block that spans y (the 1D
    x-chain) and on the xy-chain's y-extended operand, whose rows start
    at a negative global y (``offsets[1] = -depth``)."""
    rng = np.random.default_rng(depth * 10 + y_extended)
    nx, ny, nz = 6, 7, 9
    if y_extended:
        ny += 2 * depth
        offsets, row = (6, -depth, 0), 12
    else:
        offsets, row = (6, 0, 0), 18
    fields = _arrays(rng, [(nx, ny, nz)] * 2, dtype)
    faces = _arrays(rng, [(depth, ny, nz)] * 4, dtype)
    ref_params, params = _params(dtype, noise)
    want = pallas_stencil._xla_xchain_fallback(
        tuple(map(jnp.asarray, fields)), ref_params,
        jnp.asarray(SEEDS, jnp.int32), tuple(map(jnp.asarray, faces)),
        spec=REF_SPEC, fuse=depth, use_noise=noise != 0,
        offsets=jnp.asarray(offsets, jnp.int32), row=row,
    )
    got = cuda_stencil.fused_step(
        tuple(map(torch.from_numpy, fields)), params, SEEDS,
        tuple(map(torch.from_numpy, faces)), spec=SPEC,
        use_noise=noise != 0, fuse=depth, offsets=offsets, row=row,
        y_halo=depth if y_extended else 0,
    )
    _compare(want, got, dtype)


def test_xchain_interior_equals_single_steps_bitwise():
    """Inside the port: an x-chain over a block whose x slabs are cut
    from a larger grid equals ``depth`` single plain steps of that grid
    on the block's cells, bitwise."""
    rng = np.random.default_rng(7)
    L, k = 12, 3
    grid = [torch.from_numpy(a) for a in _arrays(rng, [(L, L, L)] * 2,
                                                    "float32")]
    _, params = _params("float32", 0.1)
    whole = cuda_stencil.plain_chain(grid, params, SEEDS, spec=SPEC,
                                     fuse=k, row=L)
    x0, x1 = 4, 8
    block = tuple(g[x0:x1].contiguous() for g in grid)
    faces = tuple(x for g in grid for x in (g[x0 - k:x0], g[x1:x1 + k]))
    got = cuda_stencil.fused_step(block, params, SEEDS, faces, spec=SPEC,
                                  fuse=k, offsets=(x0, 0, 0), row=L)
    for a, b in zip(got, whole):
        assert torch.equal(a, b[x0:x1])


def test_mode_launch_counters():
    """One count per kernel mode beside the total; the xy-chain is the
    x-chain kernel on another operand, counted on its own."""
    assert cuda_stencil.MODES == {"chain": 0, "faces6": 1, "xchain": 2,
                                  "xychain": 2}
    cuda_stencil.MODE_LAUNCHES["faces6"] = 3
    cuda_stencil.reset_launches()
    assert cuda_stencil.LAUNCHES == 0
    assert set(cuda_stencil.MODE_LAUNCHES.values()) == {0}
