"""The in-process device mesh (counterpart of the reference's
``select_devices``/``mesh_for_topology``/``_build_mesh``,
``grayscott_jl_tpu/simulation.py``).

The reference drives every device of a host from one process: a
``jax.sharding.Mesh`` over ``shard_map``, with ``lax.ppermute`` moving
halo slabs between neighbours. Here one process holds one block per
mesh position, each on its device, and :meth:`DeviceMesh.ppermute`
moves per-block tensors along one mesh axis. Between two cards that is
a peer copy (``Tensor.to``), which PyTorch orders after the pending
work of the source device's current stream and before later work on
the destination's; on one device it is the tensor itself. The device
list may repeat a device: the CPU tests and a one-card run hold a whole
mesh on one device.

A run of several processes (``parallel/distributed.py``) splits the
mesh among them: process p holds the ranks ``[p * n, (p + 1) * n)`` of
its ``n`` blocks, in row-major order (the process-major order of the
reference's ``jax.devices()``), so the boundary between two processes
falls on x first. A block's neighbour in another process is reached by
a point-to-point transfer (``distributed.p2p``), one batch per
ppermute.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..config.settings import SettingsError


def select_devices(kind: str, n_devices: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> List[torch.device]:
    """The run's device list, one entry per block.

    An explicit ``devices`` list wins (it may repeat a device). On the
    card the default is every visible card, ``n_devices`` the first n of
    them; on the CPU the default is one block, and ``n_devices`` repeats
    the CPU device that many times. A device quarantined in
    ``GS_DEVICE_BLOCKLIST`` (``resilience/sdc.py``) is left out of the
    default lists (an explicit list is the caller's choice). Asking for
    more cards than are usable, or for devices of another kind than the
    settings' backend, raises."""
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if not out:
            raise ValueError("devices must name at least one device")
        wrong = sorted({str(d) for d in out if d.type != kind})
        if wrong:
            raise SettingsError(
                f"devices {wrong} are not of the settings' backend "
                f"device type {kind!r}"
            )
        if n_devices is not None and n_devices != len(out):
            raise ValueError(
                f"n_devices={n_devices} disagrees with the "
                f"{len(out)}-entry devices list"
            )
        return out
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    from ..resilience.sdc import resolve_blocklist

    blocked = resolve_blocklist()
    if kind == "cuda":
        cards = [i for i in range(torch.cuda.device_count())
                 if f"cuda:{i}" not in blocked]
        n = len(cards) if n_devices is None else n_devices
        if n > len(cards) or not cards:
            raise ValueError(
                f"requested {n} devices, only {len(cards)} cuda devices "
                "available"
                + (f" (quarantined: GS_DEVICE_BLOCKLIST="
                   f"{','.join(sorted(blocked))})" if blocked else "")
            )
        return [torch.device("cuda", i) for i in cards[:n]]
    if kind in blocked:
        raise SettingsError(
            f"every {kind} device is quarantined (GS_DEVICE_BLOCKLIST="
            f"{','.join(sorted(blocked))}); no device is left to run on")
    return [torch.device(kind)] * (1 if n_devices is None else n_devices)


class DeviceMesh:
    """Blocks of a ``dims`` Cartesian mesh placed on ``devices``: block
    rank ``first_rank + i`` (row-major, as ``CartDomain.coords``) lives
    on ``devices[i]``. In a run of one process the devices cover the
    whole mesh; with ``processes`` > 1 each process holds an equal,
    contiguous share, and ``first_rank`` is this process's first. The
    shares belong to the processes from ``first_process`` on (a member
    group's mesh spans some of the run's processes)."""

    def __init__(self, dims: Tuple[int, int, int], devices: Sequence, *,
                 first_rank: int = 0, processes: int = 1,
                 first_process: int = 0):
        self.dims = tuple(int(d) for d in dims)
        self.devices = [torch.device(d) for d in devices]
        n = self.dims[0] * self.dims[1] * self.dims[2]
        if len(self.devices) * processes != n:
            raise ValueError(
                f"a {self.dims} mesh has {n} blocks; got "
                f"{len(self.devices)} devices"
                + (f" in each of {processes} processes"
                   if processes > 1 else "")
            )
        if first_rank % len(self.devices) or not 0 <= first_rank < n:
            raise ValueError(
                f"first_rank {first_rank} is not the start of a share of "
                f"{len(self.devices)} blocks of {n}")
        self.first_rank = int(first_rank)
        #: The process that holds rank 0 of this mesh (a member group's
        #: mesh may start at another process than 0).
        self.first_process = int(first_process)
        self._side_streams = {}
        #: ppermute calls per axis, then the sends to other processes
        #: (:meth:`census`).
        self._calls = [0, 0, 0, 0]

    def census(self) -> List[int]:
        """ppermute calls along x, y and z since the mesh was built, and
        the point-to-point sends to other processes they made (the
        exchange census of ``obs/xstats.collective_counts``)."""
        return list(self._calls)

    @property
    def spatial_share(self) -> int:
        """The blocks of the spatial mesh this process holds (of each
        member group it holds, for an ensemble's group mesh)."""
        return len(self.devices)

    def side_stream(self, device: torch.device) -> "torch.cuda.Stream":
        """The card ``device``'s stream for the split-phase exchanges
        (``halo.start_exchange``), made at first use."""
        st = self._side_streams.get(device)
        if st is None:
            st = self._side_streams[device] = torch.cuda.Stream(device=device)
        return st

    @property
    def n_blocks(self) -> int:
        """The blocks this process holds (the whole mesh in a run of one
        process)."""
        return len(self.devices)

    def owner(self, rank: int) -> int:
        """The process that holds mesh rank ``rank``."""
        return self.first_process + rank // len(self.devices)

    def coords(self, rank: int) -> Tuple[int, int, int]:
        """Row-major rank -> (cx, cy, cz)."""
        _, dy, dz = self.dims
        return rank // (dy * dz), (rank // dz) % dy, rank % dz

    def rank(self, coords: Sequence[int]) -> int:
        _, dy, dz = self.dims
        cx, cy, cz = coords
        return (cx * dy + cy) * dz + cz

    def ppermute(self, tensors: Sequence, axis: int,
                 shift: int) -> List[Optional[torch.Tensor]]:
        """Send each block's tensor to its neighbour ``shift`` (+1 or
        -1) positions along ``axis`` — ``lax.ppermute`` with the
        permutation ``[(i, i + shift)]``. Returns, per receiving rank,
        the tensor it receives, on its own device, or ``None`` at the
        global edge where no neighbour sends."""
        if shift not in (1, -1):
            raise ValueError(f"shift must be +1 or -1, got {shift}")
        self._calls[axis] += 1
        first, n, me = self.first_rank, self.n_blocks, self.owner(
            self.first_rank)
        out: List[Optional[torch.Tensor]] = []
        remote = []  # (index in out, source rank) of faces from elsewhere
        sends = []
        for i in range(n):
            c = list(self.coords(first + i))
            c[axis] += shift  # where this block's tensor goes
            if 0 <= c[axis] < self.dims[axis]:
                dst = self.rank(c)
                if self.owner(dst) != me:
                    sends.append((self.owner(dst), dst, tensors[i]))
            c[axis] -= 2 * shift  # where this block's face comes from
            if not 0 <= c[axis] < self.dims[axis]:
                out.append(None)
                continue
            src = self.rank(c)
            if self.owner(src) == me:
                out.append(tensors[src - first].to(self.devices[i]))
            else:
                out.append(None)
                remote.append((i, src))
        if sends or remote:
            from . import distributed

            self._calls[3] += len(sends)
            # Every block's tensor of one call has the same shape.
            got = distributed.p2p(
                sends, [(self.owner(src), first + i, tensors[i],
                         self.devices[i]) for i, src in remote])
            for (i, _), t in zip(remote, got):
                out[i] = t
        return out
