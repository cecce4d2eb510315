"""Multi-process start-up and the collectives between processes
(counterpart of ``grayscott_jl_tpu/driver.py::maybe_initialize_distributed``
and of what ``jax.distributed`` gives the reference).

A run of N processes is one simulation: the mesh's blocks are split
among the processes in rank order (``parallel/mesh.py``), the halo
faces between blocks of two processes move point to point
(:func:`p2p`), the health probe is reduced over all of them
(:func:`reduce_probe`), the numerics probe's partials are gathered
(:func:`all_gather_f64`), and each process writes its own blocks to the
shared stores. :func:`start` brings the process group up from the launch
variables (:func:`~..config.settings.resolve_launch`); until then — and
in a run of one process — :func:`process_index` is 0 and
:func:`process_count` 1.

Placement and backend follow one rule, decided at start-up and never
after a failure (:func:`placement`): the host's visible cards are split
evenly among its processes in local-rank order. When each process has
cards of its own the backend is NCCL; when processes share a card (more
processes than cards) or run on the CPU it is gloo, and a card's faces
bound for another process are staged through pinned host buffers while
the compute stays on the card. NCCL refuses two ranks on one device, so
shared cards cannot use it; an NCCL start-up failure raises, and
nothing falls back to gloo or the CPU.

The group has a timeout of its own (:data:`GROUP_TIMEOUT_S`), so a peer
that died turns into an error in the survivors, not a hang.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import socket
import sys
import time
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.settings import Launch, resolve_launch

#: Seconds a collective or point-to-point transfer may wait for a peer
#: before it raises.
GROUP_TIMEOUT_S = 300.0


@dataclasses.dataclass
class Group:
    """This process's place in a started multi-process run."""

    rank: int
    world: int
    local_rank: int
    local_world: int
    #: ``"nccl"`` or ``"gloo"``.
    backend: str
    #: The cards this process owns (empty on the CPU).
    cards: List[int]
    #: The key-value store the processes met at (``resilience/rendezvous``).
    store: object
    #: A token shared by the processes of this launch and no other.
    launch_id: str
    #: Host seconds, calls and bytes of the point-to-point transfers.
    p2p_seconds: float = 0.0
    p2p_calls: int = 0
    p2p_bytes: int = 0

    @property
    def comm_device(self) -> torch.device:
        """Where the collectives' tensors live: the first card under
        NCCL, the host under gloo."""
        if self.backend == "nccl":
            return torch.device("cuda", self.cards[0])
        return torch.device("cpu")

    def describe(self) -> dict:
        return {"process_index": self.rank, "process_count": self.world,
                "backend": self.backend, "local_rank": self.local_rank,
                "local_world": self.local_world, "cards": list(self.cards)}


_GROUP: Optional[Group] = None


def group() -> Optional[Group]:
    """The started group, or None in a run of one process."""
    return _GROUP


def process_index() -> int:
    return _GROUP.rank if _GROUP is not None else 0


def process_count() -> int:
    return _GROUP.world if _GROUP is not None else 1


def backend() -> Optional[str]:
    return _GROUP.backend if _GROUP is not None else None


def describe() -> dict:
    """This process's place, as ``RunStats.config`` records it."""
    if _GROUP is None:
        return {"process_index": 0, "process_count": 1, "backend": None}
    return _GROUP.describe()


def placement(kind: str, n_cards: int, local_rank: int,
              local_world: int) -> Tuple[str, List[int]]:
    """``(backend, cards)`` of the process ``local_rank`` of
    ``local_world`` on a host with ``n_cards`` visible cards, for a run
    on ``kind`` (``"cuda"`` or ``"cpu"``): the cards split evenly in
    local-rank order, NCCL when each process has its own, gloo when
    processes share one (and on the CPU)."""
    if kind != "cuda":
        return "gloo", []
    if n_cards < 1:
        raise RuntimeError(
            "the run asks for the card, but no CUDA card is visible")
    if n_cards >= local_world:
        per = n_cards // local_world
        return "nccl", list(range(local_rank * per, (local_rank + 1) * per))
    return "gloo", [local_rank * n_cards // local_world]


def _local_by_host(store, launch: Launch) -> Tuple[int, int]:
    """This process's rank among the processes of its host, from every
    process's host name published in ``store``."""
    store.set(f"gs/host/{launch.rank}", socket.gethostname())
    names = [store.get(f"gs/host/{r}").decode()
             for r in range(launch.world)]
    mine = names[launch.rank]
    return names[:launch.rank].count(mine), names.count(mine)


def ensure_started(kind: str) -> Optional[Group]:
    """Start the group when the environment asks for a multi-process
    launch and it is not started yet; the started group (None for one
    process). Bad launch variables raise :class:`SettingsError`."""
    if _GROUP is not None:
        return _GROUP
    launch = resolve_launch()
    if launch is None:
        return None
    return start(launch, kind)


def start(launch: Launch, kind: str) -> Group:
    """Bring the process group up: meet at ``launch``'s address, decide
    the placement and backend (:func:`placement`), pin the process to
    its first card, and start the group with its timeout. Any failure
    raises."""
    global _GROUP
    import torch.distributed as dist

    if _GROUP is not None:
        raise RuntimeError("the process group is already started")
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    if launch.form == "coordinator":
        # The launch's own store, which the group is started on; the
        # rendezvous keeps using it.
        store = dist.TCPStore(launch.host, launch.port, launch.world,
                              is_master=launch.rank == 0, timeout=timeout)
        if launch.local_rank is None:
            local_rank, local_world = _local_by_host(store, launch)
        else:
            local_rank, local_world = launch.local_rank, launch.local_world
    else:
        store = None
        local_rank, local_world = launch.local_rank, launch.local_world
    n_cards = torch.cuda.device_count() if kind == "cuda" else 0
    backend_name, cards = placement(kind, n_cards, local_rank, local_world)
    kw = {}
    if cards:
        torch.cuda.set_device(cards[0])
    if backend_name == "nccl":
        kw["device_id"] = torch.device("cuda", cards[0])
    if store is not None:
        dist.init_process_group(backend_name, store=store, rank=launch.rank,
                                world_size=launch.world, timeout=timeout,
                                **kw)
    else:
        # torchrun's agent already serves the store at MASTER_ADDR:
        # MASTER_PORT; ``env://`` joins it.
        dist.init_process_group(
            backend_name, init_method="env://", rank=launch.rank,
            world_size=launch.world, timeout=timeout, **kw)
        store = dist.distributed_c10d._get_default_store()
    token = f"{launch.form}:{launch.host}:{launch.port}:{launch.world}"
    _GROUP = Group(
        rank=launch.rank, world=launch.world, local_rank=local_rank,
        local_world=local_world, backend=backend_name, cards=cards,
        store=store, launch_id=f"{zlib.crc32(token.encode()):08x}")
    # Every process reaches this collective, so the first transfer of
    # the run is not the one that connects the group.
    all_gather_int(0)
    print(f"gray-scott-torch: process {launch.rank} of {launch.world} "
          f"started ({backend_name}, "
          f"{'cards ' + str(cards) if cards else 'CPU'})", file=sys.stderr)
    atexit.register(stop)
    return _GROUP


def stop() -> None:
    """Tear the group down (at exit, or for a test)."""
    global _GROUP
    if _GROUP is None:
        return
    import torch.distributed as dist

    _GROUP = None
    if dist.is_initialized():
        dist.destroy_process_group()


def _require() -> Group:
    if _GROUP is None:
        raise RuntimeError("no multi-process group is started")
    return _GROUP


def all_gather_int(value: int) -> List[int]:
    """Every process's ``value``, in process order."""
    import torch.distributed as dist

    g = _require()
    t = torch.tensor([int(value)], dtype=torch.int64, device=g.comm_device)
    out = [torch.empty_like(t) for _ in range(g.world)]
    dist.all_gather(out, t)
    return [int(x.item()) for x in out]


def all_gather_f64(vec) -> List[np.ndarray]:
    """Every process's float64 vector (all of one length), in process
    order: the numerics probe's partials, merged on each process in the
    same order, so that every process reads the same report."""
    import torch.distributed as dist

    g = _require()
    t = torch.as_tensor(np.ascontiguousarray(vec, dtype=np.float64)).to(
        g.comm_device)
    out = [torch.empty_like(t) for _ in range(g.world)]
    dist.all_gather(out, t)
    return [x.cpu().numpy() for x in out]


def _all_min(vec: np.ndarray) -> np.ndarray:
    """The elementwise minimum of a float64 vector over the processes."""
    import torch.distributed as dist

    g = _require()
    t = torch.as_tensor(np.ascontiguousarray(vec, dtype=np.float64)).to(
        g.comm_device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return t.cpu().numpy()


def reduce_probe(vec: np.ndarray) -> np.ndarray:
    """The health probe ``(finite, min_0, max_0, ...)`` over every
    process: finite by MIN, the mins by MIN, the maxes by MAX, and a NaN
    anywhere wins its entry. One collective."""
    vec = np.asarray(vec, dtype=np.float64)
    nan = np.isnan(vec)
    n = (len(vec) - 1) // 2
    mins = np.where(nan[1::2], np.inf, vec[1::2])
    maxes = np.where(nan[2::2], -np.inf, vec[2::2])
    red = _all_min(np.concatenate([
        vec[:1], mins, -maxes, -nan.astype(np.float64)]))
    out = np.empty_like(vec)
    out[0] = red[0]
    out[1::2] = red[1:1 + n]
    out[2::2] = -red[1 + n:1 + 2 * n]
    out[-red[1 + 2 * n:] > 0] = np.nan
    return out


def global_range(lo: float, hi: float) -> Tuple[float, float]:
    """``(min lo, max hi)`` over the processes (the codec's range)."""
    red = _all_min(np.array([lo, -hi], dtype=np.float64))
    return float(red[0]), float(-red[1])


def any_process(flag: bool) -> bool:
    """True on every process when ``flag`` is true on any."""
    return bool(_all_min(np.array([-float(bool(flag))]))[0] < 0)


def block_layout(n_local: int) -> Tuple[int, int]:
    """``(global block count, this process's first rank)`` when every
    process holds ``n_local`` blocks: the mesh ranks ``[p * n_local,
    (p + 1) * n_local)`` are process p's, in row-major order. Unequal
    counts raise."""
    if _GROUP is None:
        return n_local, 0
    counts = all_gather_int(n_local)
    if len(set(counts)) != 1:
        raise ValueError(
            f"every process must hold the same number of blocks; the "
            f"processes hold {counts}")
    return n_local * _GROUP.world, n_local * _GROUP.rank


def process_devices(kind: str, n_devices: Optional[int]) -> List[torch.device]:
    """The device of each of this process's blocks: one per owned card
    by default, or ``n_devices`` blocks spread over the owned cards in
    order (a card repeats when there are fewer); on the CPU one block,
    or ``n_devices``."""
    g = _require()
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if kind != "cuda":
        return [torch.device(kind)] * (1 if n_devices is None else n_devices)
    n = len(g.cards) if n_devices is None else n_devices
    return [torch.device("cuda", g.cards[i * len(g.cards) // n])
            for i in range(n)]


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def p2p(sends: Sequence[Tuple[int, int, torch.Tensor]],
        recvs: Sequence[Tuple[int, int, torch.Tensor, torch.device]]
        ) -> List[torch.Tensor]:
    """One permutation's transfers between processes, as one
    ``batch_isend_irecv`` holding every send and receive, so neither
    backend can deadlock on the order of the pairs.

    ``sends`` are ``(peer, tag, tensor)``; ``recvs`` are ``(peer, tag,
    like, device)`` and the result holds, per receive, a tensor shaped
    and typed as ``like`` on ``device``. Between two processes, sends
    are matched with receives in order (the callers issue both in mesh
    rank order; gloo also matches the tags). Tensors travel as bytes.

    Under NCCL the transfers run on the group's stream after the work
    queued on the first card's current stream, and that stream waits on
    them (no host wait): the side stream of a split-phase exchange
    stays ordered. Under gloo each tensor on a card is first copied to
    pinned host memory on its current stream — after the kernel that
    wrote it — and the host waits for those copies before sending; what
    arrives is copied back to the card."""
    import torch.distributed as dist

    g = _require()
    t0 = time.perf_counter()
    nccl = g.backend == "nccl"
    comm = g.comm_device
    ops = []
    staged = []
    for peer, tag, t in sends:
        b = _bytes_of(t)
        if nccl:
            b = b.to(comm, non_blocking=True)
        elif b.is_cuda:
            host = torch.empty(b.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(b, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(b.device))
            staged.append(ev)
            b = host
        ops.append(dist.P2POp(dist.isend, b, peer, tag=tag))
    bufs = []
    for peer, tag, like, _ in recvs:
        nbytes = like.numel() * like.element_size()
        buf = torch.empty(nbytes, dtype=torch.uint8,
                          device=comm if nccl else "cpu",
                          pin_memory=(not nccl and torch.cuda.is_available()
                                      and like.is_cuda))
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
    for ev in staged:
        ev.synchronize()
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    out = []
    for buf, (_, _, like, device) in zip(bufs, recvs):
        t = buf.view(like.dtype).reshape(like.shape)
        out.append(t.to(device, non_blocking=True))
    g.p2p_seconds += time.perf_counter() - t0
    g.p2p_calls += 1
    g.p2p_bytes += sum(t.numel() * t.element_size() for _, _, t in sends)
    return out


def p2p_stats() -> Optional[dict]:
    """The point-to-point transfers' host seconds, calls and bytes sent
    by this process, or None for one process."""
    if _GROUP is None:
        return None
    return {"seconds": _GROUP.p2p_seconds, "calls": _GROUP.p2p_calls,
            "bytes": _GROUP.p2p_bytes}


def reset_p2p_stats() -> None:
    if _GROUP is not None:
        _GROUP.p2p_seconds = 0.0
        _GROUP.p2p_calls = 0
        _GROUP.p2p_bytes = 0
