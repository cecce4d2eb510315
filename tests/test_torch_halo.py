"""The port's halo exchange over an in-process mesh
(grayscott_jl_tpu_torch/parallel/halo.py, parallel/mesh.py) against the
reference's exchange run under ``shard_map`` on the 8 virtual CPU
devices (as tests/unit/test_sharded.py builds its mesh).

The exchange is pure data movement, so every result is compared
bitwise: the same random blocks (numpy, from a seed) go through both,
and each block's padded frame, faces or slabs must be the same bits."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, PartitionSpec as P

from grayscott_jl_tpu.parallel import halo as ref_halo
from grayscott_jl_tpu.simulation import (
    _SHARD_MAP_CHECK_FLAG,
    AXIS_NAMES,
    shard_map,
)
from grayscott_jl_tpu_torch.parallel import halo
from grayscott_jl_tpu_torch.parallel.mesh import DeviceMesh

BVS = (1.0, 0.0)
#: Block shape (distinct extents catch a transposed axis) and meshes.
BLOCK = (4, 5, 6)
MESHES = [(2, 2, 2), (8, 1, 1), (4, 1, 1), (2, 2, 1), (1, 2, 2), (1, 1, 4)]


def _globals(dims, seed=0):
    rng = np.random.default_rng(seed)
    shape = tuple(b * d for b, d in zip(BLOCK, dims))
    return [rng.uniform(0.0, 1.0, shape).astype(np.float32)
            for _ in BVS]


def _split(arr, dims):
    """Rank-ordered blocks of a global array (the shard_map layout)."""
    n = np.prod(dims)
    b = [s // d for s, d in zip(arr.shape, dims)]
    mesh = DeviceMesh(dims, ["cpu"] * n)
    out = []
    for r in range(n):
        c = mesh.coords(r)
        out.append(arr[tuple(slice(ci * bi, (ci + 1) * bi)
                             for ci, bi in zip(c, b))])
    return out


def _reference(fn, dims, arrays, n_out):
    """``fn(*local_arrays) -> tuple`` under shard_map; returns, per
    output, the rank-ordered per-block results."""
    n = int(np.prod(dims))
    if len(jax.devices()) < n:
        pytest.skip("needs 8 virtual CPU devices")
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(dims), AXIS_NAMES)
    spec = P(*AXIS_NAMES)
    mapped = shard_map(
        fn, mesh=mesh, in_specs=(spec,) * len(arrays),
        out_specs=(spec,) * n_out, **{_SHARD_MAP_CHECK_FLAG: False},
    )
    outs = jax.jit(mapped)(*arrays)
    return [_split(np.asarray(o), dims) for o in outs]


def _port(fn, dims, arrays):
    mesh = DeviceMesh(dims, ["cpu"] * int(np.prod(dims)))
    per_field = [_split(a, dims) for a in arrays]
    blocks = [tuple(torch.from_numpy(np.ascontiguousarray(f[r]))
                    for f in per_field)
              for r in range(mesh.n_blocks)]
    return fn(blocks, mesh)


def _assert_blocks_equal(want, got):
    """``want[out][rank]`` (reference) against ``got[rank][out]``."""
    assert len(got) == len(want[0])
    for r, outs in enumerate(got):
        assert len(outs) == len(want)
        for i, g in enumerate(outs):
            w = want[i][r]
            assert tuple(g.shape) == w.shape, (r, i)
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("dims", MESHES)
def test_exchange_faces_bitwise(dims):
    arrays = _globals(dims)
    want = _reference(
        lambda *a: ref_halo.exchange_faces(a, BVS, AXIS_NAMES, dims),
        dims, arrays, 6 * len(BVS))
    got = _port(lambda b, m: halo.exchange_faces(b, BVS, m), dims, arrays)
    _assert_blocks_equal(want, got)


@pytest.mark.parametrize("dims", MESHES)
def test_halo_pad_bitwise(dims):
    """Face ghosts from the neighbours; edge and corner ghosts at the
    boundary value (never read), as in the reference."""
    arrays = _globals(dims, seed=1)
    want = _reference(
        lambda *a: ref_halo.halo_pad(a, BVS, AXIS_NAMES, dims),
        dims, arrays, len(BVS))
    got = _port(lambda b, m: halo.halo_pad(b, BVS, m), dims, arrays)
    _assert_blocks_equal(want, got)


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("width", [1, 2, 3])
def test_halo_pad_wide_bitwise(dims, width):
    """Corner propagation: the x -> y -> z sequence fills edge and
    corner ghosts with the diagonal neighbours' cells."""
    arrays = _globals(dims, seed=2)
    want = _reference(
        lambda *a: ref_halo.halo_pad_wide(a, BVS, AXIS_NAMES, dims, width),
        dims, arrays, len(BVS))
    got = _port(lambda b, m: halo.halo_pad_wide(b, BVS, m, width), dims,
                arrays)
    _assert_blocks_equal(want, got)


@pytest.mark.parametrize("dims", [(8, 1, 1), (4, 1, 1), (2, 2, 2)])
@pytest.mark.parametrize("width", [2, 3])
def test_exchange_x_slabs_bitwise(dims, width):
    arrays = _globals(dims, seed=3)

    def ref(*a):
        pairs = ref_halo.exchange_x_slabs(a, BVS, "x", dims[0], width)
        return tuple(f for pr in pairs for f in pr)

    def port(blocks, mesh):
        return [tuple(f for pr in prs for f in pr)
                for prs in halo.exchange_x_slabs(blocks, BVS, mesh, width)]

    want = _reference(ref, dims, arrays, 2 * len(BVS))
    _assert_blocks_equal(want, _port(port, dims, arrays))


@pytest.mark.parametrize("dims", [(2, 2, 2), (2, 2, 1), (1, 2, 2),
                                  (1, 1, 4)])
@pytest.mark.parametrize("dim", [0, 1, 2])
def test_exchange_slabs_bitwise(dims, dim):
    arrays = _globals(dims, seed=4)

    def ref(*a):
        pairs = ref_halo.exchange_slabs(a, BVS, dim, AXIS_NAMES[dim],
                                        dims[dim], 2)
        return tuple(f for pr in pairs for f in pr)

    def port(blocks, mesh):
        return [tuple(f for pr in prs for f in pr)
                for prs in halo.exchange_slabs(blocks, BVS, dim, mesh, 2)]

    want = _reference(ref, dims, arrays, 2 * len(BVS))
    _assert_blocks_equal(want, _port(port, dims, arrays))


def test_ppermute_edges_and_devices():
    """Each receiver gets its lower (shift +1) or upper (shift -1)
    neighbour's tensor; the global edge receives None."""
    mesh = DeviceMesh((2, 3, 1), ["cpu"] * 6)
    tensors = [torch.tensor([r]) for r in range(6)]
    up = mesh.ppermute(tensors, 1, +1)
    down = mesh.ppermute(tensors, 1, -1)
    for r in range(6):
        cx, cy, cz = mesh.coords(r)
        assert mesh.rank((cx, cy, cz)) == r
        if cy == 0:
            assert up[r] is None
        else:
            assert int(up[r]) == mesh.rank((cx, cy - 1, cz))
        if cy == 2:
            assert down[r] is None
        else:
            assert int(down[r]) == mesh.rank((cx, cy + 1, cz))
    with pytest.raises(ValueError, match="6 blocks"):
        DeviceMesh((2, 3, 1), ["cpu"] * 5)
