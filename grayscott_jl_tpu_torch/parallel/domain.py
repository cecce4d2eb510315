"""3D Cartesian domain decomposition (a copy of
``grayscott_jl_tpu/parallel/domain.py``, which is framework-free).

The reference's MPI Cartesian machinery
(``src/simulation/communication.jl:59-96``) as pure data:
``MPI.Dims_create`` becomes :func:`dims_create` (same balanced
factorization) and the block layout a :class:`CartDomain`, whose
``coords``, ``proc_offsets``, ``local_shape`` and ``storage_shape``
place the blocks of the in-process device mesh (``parallel/mesh.py``).

Non-divisible L runs via **pad-and-mask** (r4): storage is padded to
equal ``ceil(L/d)`` blocks per axis (SPMD needs equal shards), pad
cells are pinned to the frozen boundary value by every step path, and
outputs are clipped back to the true ``L^3`` domain — fixing the
reference's ``InexactError`` on non-divisible L
(``communication.jl:73-87``, SURVEY defect #7) with integer math.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from ..config.env import env_str


def dims_create(nnodes: int, ndims: int = 3) -> Tuple[int, ...]:
    """Balanced factorization of ``nnodes`` into ``ndims`` dims.

    Semantics of ``MPI_Dims_create`` (reference ``communication.jl:63``):
    dims are as close to each other as possible and non-increasing.
    Prime factors are assigned largest-first to the currently smallest dim.
    """
    if nnodes < 1:
        raise ValueError(f"nnodes must be >= 1, got {nnodes}")
    factors: List[int] = []
    n = nnodes
    d = 2
    while d * d <= n:
        while n % d == 0:
            factors.append(d)
            n //= d
        d += 1
    if n > 1:
        factors.append(n)

    dims = [1] * ndims
    for f in sorted(factors, reverse=True):
        dims[dims.index(min(dims))] *= f
    return tuple(sorted(dims, reverse=True))


def block_size_offset(L: int, ndiv: int, coord: int) -> Tuple[int, int]:
    """TRUE-domain size and 0-based global offset of block ``coord`` of
    ``L`` over ``ndiv``.

    Pad-and-mask scheme (r4): SPMD compute needs EQUAL per-shard blocks,
    so storage is padded to ``ceil(L/ndiv) * ndiv`` and each block owns
    the clip of its equal slice to ``[0, L)`` — the high-coordinate
    block absorbs the shortfall. This actually runs non-divisible L on
    the sharded path, where the reference's remainder-spread attempt
    dies with InexactError (``communication.jl:73-87``, defect #7).
    """
    b = -(-L // ndiv)  # ceil: the equal storage block
    offset = min(b * coord, L)
    size = max(0, min(L - offset, b))
    return size, offset


@dataclasses.dataclass(frozen=True)
class CartDomain:
    """Static description of the 3D block decomposition of the L^3 grid.

    Replaces the reference's ``MPICartDomain`` (``Structs.jl:57-73``). This
    is global, pure data — every process/shard sees the same description.
    """

    L: int
    dims: Tuple[int, int, int]

    @classmethod
    def create(
        cls, n_devices: int, L: int,
        dims: "Tuple[int, int, int] | None" = None,
    ) -> "CartDomain":
        """Balanced MPI ``Dims_create`` factorization, overridable with
        ``GS_TPU_MESH_DIMS=nx,ny,nz`` (e.g. ``8,1,1`` selects the 1D
        x-sharded decomposition whose halos feed the Pallas kernel's
        in-kernel fused chain — the fastest pod-slice layout for the
        Pallas language at <=16 chips, see BASELINE.md).

        An explicit ``dims`` wins over the env override: it is the
        programmatic channel the live-reshape path uses to target a
        specific factorization without mutating process-global env
        state (thread-unsafe under the serve worker fleet)."""
        if dims is not None:
            dims = tuple(int(d) for d in dims)
            if len(dims) != 3 or any(d < 1 for d in dims):
                raise ValueError(
                    f"mesh dims {dims!r} must be three positive "
                    "integers"
                )
            if dims[0] * dims[1] * dims[2] != n_devices:
                raise ValueError(
                    f"mesh dims {dims!r} do not factor "
                    f"{n_devices} devices"
                )
            return cls._validated(L, dims, n_devices)
        override = env_str("GS_TPU_MESH_DIMS", "")
        if n_devices == 1:
            # A single device has exactly one decomposition; ignoring
            # the override here lets a pod config export
            # GS_TPU_MESH_DIMS for its multi-chip jobs without breaking
            # single-device runs (bench.py, smoke tests) in the same
            # shell.
            override = ""
        if override:
            try:
                dims = tuple(int(x) for x in override.split(","))
            except ValueError:
                raise ValueError(
                    f"GS_TPU_MESH_DIMS={override!r} is not 'nx,ny,nz'"
                ) from None
            if len(dims) != 3 or any(d < 1 for d in dims):
                raise ValueError(
                    f"GS_TPU_MESH_DIMS={override!r} must be three "
                    "positive integers"
                )
            if dims[0] * dims[1] * dims[2] != n_devices:
                raise ValueError(
                    f"GS_TPU_MESH_DIMS={override!r} does not factor "
                    f"{n_devices} devices"
                )
        else:
            dims = dims_create(n_devices, 3)
        return cls._validated(L, dims, n_devices)

    @classmethod
    def _validated(cls, L, dims, n_devices) -> "CartDomain":
        if n_devices > 1:
            for d in dims:
                # Non-divisible L runs via pad-and-mask (storage padded
                # to equal blocks, pad cells pinned to the boundary
                # value); the only hard requirement is that every block
                # owns at least one true-domain cell.
                if -(-L // d) * (d - 1) >= L:
                    raise ValueError(
                        f"L={L} is too small for mesh dims {dims}: block "
                        f"{d - 1} of axis size {d} would own no "
                        "true-domain cells"
                    )
        return cls(L=L, dims=dims)

    @property
    def n_blocks(self) -> int:
        dx, dy, dz = self.dims
        return dx * dy * dz

    def coords(self, rank: int) -> Tuple[int, int, int]:
        """Row-major rank -> (cx, cy, cz), like ``MPI.Cart_coords``."""
        dx, dy, dz = self.dims
        cz = rank % dz
        cy = (rank // dz) % dy
        cx = rank // (dz * dy)
        return cx, cy, cz

    def proc_sizes(self, coords: Tuple[int, int, int]) -> Tuple[int, int, int]:
        return tuple(
            block_size_offset(self.L, d, c)[0]
            for d, c in zip(self.dims, coords)
        )

    def proc_offsets(self, coords: Tuple[int, int, int]) -> Tuple[int, int, int]:
        return tuple(
            block_size_offset(self.L, d, c)[1]
            for d, c in zip(self.dims, coords)
        )

    def block_boxes(self):
        """Every block's ``(offsets, sizes)`` in the true ``L^3`` domain,
        in rank order: the storage blocks of :attr:`local_shape` at their
        mesh positions, a non-divisible L's pad cells cut off (the boxes
        the stores record)."""
        block = self.local_shape
        out = []
        for r in range(self.n_blocks):
            offs = tuple(c * b for c, b in zip(self.coords(r), block))
            out.append((offs, tuple(min(self.L - o, b)
                                    for o, b in zip(offs, block))))
        return out

    @property
    def local_shape(self) -> Tuple[int, int, int]:
        """Per-shard STORAGE block shape (equal blocks; sharded path
        only). For non-divisible L this is ``ceil(L/d)`` — the block
        includes pad cells past the true domain on the high edge."""
        return tuple(-(-self.L // d) for d in self.dims)

    @property
    def storage_shape(self) -> Tuple[int, int, int]:
        """Global padded array shape actually allocated when sharded:
        ``local_shape * dims`` per axis (== (L, L, L) for divisible L).
        Cells at global coordinate >= L are pad, pinned to the frozen
        boundary value by the step paths and stripped from every
        output."""
        return tuple(-(-self.L // d) * d for d in self.dims)

    @property
    def padded(self) -> bool:
        return self.storage_shape != (self.L,) * 3
