"""The port's position-keyed noise stream equals the reference's bit
for bit (grayscott_jl_tpu_torch/ops/noise.py vs grayscott_jl_tpu/ops/noise.py).

Inputs are integers, so the comparison is exact: the float32 draws are
compared as their uint32 bit patterns, across block shapes, negative
(wrapping) offsets, steps up to 2**31 - 1 and keys."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grayscott_jl_tpu.ops import noise as ref_noise
from grayscott_jl_tpu_torch.ops import noise
from grayscott_jl_tpu_torch.simulation import base_key

CASES = [
    # key, step, offsets, shape, row
    ((0, 0), 0, (0, 0, 0), (4, 4, 4), 4),
    ((0, 7), 3, (0, 0, 0), (5, 6, 7), 7),
    ((123, 456), 2**31 - 1, (-3, -1, 5), (4, 9, 3), 100),
    ((-5, 2**31 - 1), 0, (-100, 7, -2**31), (3, 3, 3), 2**31 - 1),
    ((17, 29), 4, (8, 0, 16), (8, 8, 8), 32),
    ((0, 1), 99, (0, -2, -2), (2, 20, 20), 16),
    ((2**31 - 1, -1), 12345, (-1, -1, -1), (6, 2, 9), 9),
    ((9, 17), 5, (1000, 2000, 3000), (3, 5, 11), 4096),
]


def _ref_bits(key, step, offsets, shape, row, dtype=jnp.float32):
    out = ref_noise.uniform_pm1_block(
        jnp.asarray(key, jnp.int32), step, jnp.asarray(offsets, jnp.int32),
        shape, row, dtype,
    )
    return np.asarray(out)


@pytest.mark.parametrize("key,step,offsets,shape,row", CASES)
def test_uniform_pm1_block_bits_equal_reference(key, step, offsets, shape,
                                                row):
    want = _ref_bits(key, step, offsets, shape, row)
    got = noise.uniform_pm1_block(key, step, offsets, shape, row,
                                  torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_pm1_block_float64_equals_reference():
    """The float64 draw is the float32 draw widened, in both packages."""
    key, step, offsets, shape, row = CASES[2]
    prior = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want = _ref_bits(key, step, offsets, shape, row, jnp.float64)
    finally:
        jax.config.update("jax_enable_x64", prior)
    got = noise.uniform_pm1_block(key, step, offsets, shape, row,
                                  torch.float64).numpy()
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.uint64),
                                  want.view(np.uint64))


def test_hash_pieces_equal_reference():
    """plane_seed / cell_hash / block_bits on raw uint32 values."""
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 2**32, size=64, dtype=np.uint64)
    x = torch.from_numpy(vals.astype(np.int64))
    np.testing.assert_array_equal(
        noise.hash32(x).numpy().astype(np.uint32),
        np.asarray(ref_noise.hash32(jnp.asarray(vals, jnp.uint32))),
    )
    gx = torch.arange(7)
    seed = noise.plane_seed(5, 6, 7, gx)
    ref_seed = ref_noise.plane_seed(5, 6, 7, jnp.arange(7, dtype=jnp.uint32))
    np.testing.assert_array_equal(seed.numpy().astype(np.uint32),
                                  np.asarray(ref_seed))
    iy = torch.arange(5).view(5, 1)
    iz = torch.arange(6).view(1, 6)
    bits = noise.block_bits(seed[3], iy, iz, 4099)
    ref = ref_noise.block_bits(
        ref_seed[3], jnp.arange(5, dtype=jnp.uint32)[:, None],
        jnp.arange(6, dtype=jnp.uint32)[None, :], 4099,
    )
    np.testing.assert_array_equal(bits.numpy().astype(np.uint32),
                                  np.asarray(ref))


def test_draws_are_uniform_and_step_dependent():
    a = noise.uniform_pm1_block((0, 3), 1, (0, 0, 0), (16, 16, 16), 16,
                                torch.float32)
    b = noise.uniform_pm1_block((0, 3), 2, (0, 0, 0), (16, 16, 16), 16,
                                torch.float32)
    assert float(a.min()) >= -1.0 and float(a.max()) < 1.0
    assert abs(float(a.mean())) < 4.0 / np.sqrt(a.numel())
    assert abs(float(a.std()) - 1 / np.sqrt(3)) < 0.02
    assert not torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, 2**32 - 1])
def test_base_key_is_the_reference_prng_key(seed):
    want = np.asarray(
        jax.lax.bitcast_convert_type(jax.random.PRNGKey(seed), jnp.int32)
    ).astype(np.int64) & 0xFFFFFFFF
    assert base_key(seed) == tuple(int(w) for w in want)
