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
    the CPU device that many times. Asking for more cards than the
    machine has, or for devices of another kind than the settings'
    backend, raises."""
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
    if kind == "cuda":
        available = torch.cuda.device_count()
        n = available if n_devices is None else n_devices
        if n > available:
            raise ValueError(
                f"requested {n} devices, only {available} cuda devices "
                "available"
            )
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device(kind)] * (1 if n_devices is None else n_devices)


class DeviceMesh:
    """Blocks of a ``dims`` Cartesian mesh placed on ``devices``: block
    rank r (row-major, as ``CartDomain.coords``) lives on
    ``devices[r]``."""

    def __init__(self, dims: Tuple[int, int, int], devices: Sequence):
        self.dims = tuple(int(d) for d in dims)
        self.devices = [torch.device(d) for d in devices]
        n = self.dims[0] * self.dims[1] * self.dims[2]
        if len(self.devices) != n:
            raise ValueError(
                f"a {self.dims} mesh has {n} blocks; got "
                f"{len(self.devices)} devices"
            )
        self._side_streams = {}

    def side_stream(self, device: torch.device) -> "torch.cuda.Stream":
        """The card ``device``'s stream for the split-phase exchanges
        (``halo.start_exchange``), made at first use."""
        st = self._side_streams.get(device)
        if st is None:
            st = self._side_streams[device] = torch.cuda.Stream(device=device)
        return st

    @property
    def n_blocks(self) -> int:
        return len(self.devices)

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
        out: List[Optional[torch.Tensor]] = []
        for r in range(self.n_blocks):
            c = list(self.coords(r))
            c[axis] -= shift
            if not 0 <= c[axis] < self.dims[axis]:
                out.append(None)
                continue
            out.append(tensors[self.rank(c)].to(self.devices[r]))
        return out
