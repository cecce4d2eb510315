"""Restart consensus between the processes of a run (counterpart of
``grayscott_jl_tpu/resilience/rendezvous.py``).

When a run of several processes restarts, every process must restart
together and from the same checkpoint step. :meth:`agree` gives that:

* each process publishes ``(attempt, latest durable checkpoint step)``
  for the round and gathers every peer's — publish-then-gather is
  itself the barrier;
* the **attempt** adopted is the maximum, so backoff and the restart
  budget stay the same on every process;
* the **restart step** adopted is the minimum of the durable steps (the
  checkpoint quorum): a step is resumable only if every process can
  restore it. A process with no durable checkpoint makes the quorum
  "restart from scratch".

Two transports, selected by :func:`from_env`:

* :class:`KVRendezvous` — the key-value store the process group met at
  (``parallel/distributed.py``), live whenever the group is started.
  Keys are unique per (launch, round, process), so none is written
  twice.
* :class:`FileRendezvous` — a shared directory (``GS_RENDEZVOUS_DIR``,
  default ``<output>.rendezvous/``), files published atomically (a
  temporary file, then a rename) and named by a launch id, so that a
  relaunch never reads a previous launch's rounds.

A process that never arrives trips the gather's timeout
(``GS_RENDEZVOUS_TIMEOUT_S``, default 120 s) with
:class:`RendezvousTimeout`. The supervisor (``resilience/supervisor.py``)
calls :meth:`agree` on every classified failure, then
:meth:`agree_mesh`: the processes adopt one mesh before the restoring
attempt builds its simulation, so that a relaunch on another shape
restores every process onto the same layout.
"""

from __future__ import annotations

import datetime
import json
import os
import time
import zlib
from typing import List, Optional, Tuple

from ..config.env import env_raw, env_str

__all__ = [
    "FileRendezvous",
    "KVRendezvous",
    "RendezvousTimeout",
    "atomic_publish",
    "from_env",
    "resolve_timeout_s",
]


def atomic_publish(path: str, payload: str) -> None:
    """Publish ``payload`` at ``path`` atomically (a temporary file,
    fsync, rename): readers see the old bytes or the new, never a torn
    write."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class RendezvousTimeout(RuntimeError):
    """A peer never published its restart vote within the timeout."""


def resolve_timeout_s() -> float:
    raw = os.environ.get("GS_RENDEZVOUS_TIMEOUT_S", "120")
    try:
        v = float(raw)
    except ValueError as e:
        raise ValueError(
            f"GS_RENDEZVOUS_TIMEOUT_S must be a number, got {raw!r}"
        ) from e
    if v <= 0:
        raise ValueError(f"GS_RENDEZVOUS_TIMEOUT_S must be > 0, got {v}")
    return v


def _decide(votes: List[dict]) -> Tuple[int, Optional[int]]:
    """(cluster attempt, quorum restart step) from every process's vote
    ``{"attempt": int, "ckpt": int}`` (-1 = no durable checkpoint)."""
    attempt = max(int(v["attempt"]) for v in votes)
    lowest = min(int(v["ckpt"]) for v in votes)
    return attempt, (None if lowest < 0 else lowest)


class _Rendezvous:
    """Publish and gather; the subclasses move the bytes."""

    def __init__(self, nprocs: int, proc: int, *, timeout_s: float):
        self.nprocs = int(nprocs)
        self.proc = int(proc)
        self.timeout_s = float(timeout_s)
        #: The round counter, the same on every process: every process
        #: calls :meth:`agree` for the same failures.
        self.round = 0

    def agree(self, attempt: int, ckpt_step: Optional[int]
              ) -> Tuple[int, Optional[int]]:
        """Publish this process's vote, gather every peer's and return
        ``(attempt, restart step)``, the same on every process."""
        self.round += 1
        self._publish(self.round, json.dumps(
            {"attempt": int(attempt),
             "ckpt": -1 if ckpt_step is None else int(ckpt_step)}))
        return _decide([json.loads(v) for v in self._gather(self.round)])

    def agree_mesh(self, local_blocks: int,
                   proposed_dims: Optional[Tuple] = None) -> dict:
        """The mesh-agreement round: each process publishes its local
        block count (one per card it owns by default; the reference's
        local device count) and its mesh proposal (``GS_TPU_MESH_DIMS``,
        or None to derive one), and every process adopts the same.
        Returns ``{"devices": total, "dims": adopted or None, "procs":
        n}``, the same on every process. Proposals that disagree, or one
        that does not factor the total, raise
        :class:`~..reshard.plan.ReshardError`: a run that cannot agree
        on its shape must not restore into it."""
        from ..reshard.plan import ReshardError

        self.round += 1
        self._publish(self.round, json.dumps({
            "devices": int(local_blocks),
            "dims": (None if proposed_dims is None
                     else [int(d) for d in proposed_dims]),
        }))
        votes = [json.loads(v) for v in self._gather(self.round)]
        total = sum(int(v["devices"]) for v in votes)
        proposals = {None if v["dims"] is None else tuple(v["dims"])
                     for v in votes}
        if len(proposals) > 1:
            raise ReshardError(
                f"mesh-agreement round {self.round}: processes disagree on "
                f"the target mesh ({sorted(p or () for p in proposals)}) "
                "— set the same GS_TPU_MESH_DIMS on every process, or none")
        adopted = proposals.pop()
        if adopted is not None:
            n = 1
            for d in adopted:
                n *= int(d)
            if n != total:
                raise ReshardError(
                    f"mesh-agreement round {self.round}: proposed mesh "
                    f"{adopted} does not factor the run's {total} blocks")
        return {"devices": total,
                "dims": None if adopted is None else list(adopted),
                "procs": self.nprocs}

    def _publish(self, round_no: int, payload: str) -> None:
        raise NotImplementedError

    def _gather(self, round_no: int) -> List[str]:
        raise NotImplementedError

    def describe(self) -> dict:
        return {"transport": type(self).__name__, "nprocs": self.nprocs,
                "proc": self.proc, "round": self.round}


class KVRendezvous(_Rendezvous):
    """Consensus over the process group's key-value store (a
    ``torch.distributed.Store``)."""

    def __init__(self, store, nprocs: int, proc: int, *, timeout_s: float,
                 launch_id: str = "0"):
        super().__init__(nprocs, proc, timeout_s=timeout_s)
        self._store = store
        self.launch_id = launch_id

    def _key(self, round_no: int, proc: int) -> str:
        return f"gs/restart_rdv/l{self.launch_id}/r{round_no}/p{proc}"

    def _publish(self, round_no: int, payload: str) -> None:
        self._store.set(self._key(round_no, self.proc), payload)

    def _gather(self, round_no: int) -> List[str]:
        keys = [self._key(round_no, p) for p in range(self.nprocs)]
        try:
            self._store.wait(keys, datetime.timedelta(seconds=self.timeout_s))
        except Exception as e:  # the store raises its own error types
            raise RendezvousTimeout(
                f"restart rendezvous round {round_no}: not every process "
                f"published within {self.timeout_s:.0f}s ({e})") from e
        return [self._store.get(k).decode() for k in keys]


class FileRendezvous(_Rendezvous):
    """Consensus over a shared directory (atomic per-process files)."""

    def __init__(self, directory: str, nprocs: int, proc: int, *,
                 timeout_s: float, launch_id: str = "0"):
        super().__init__(nprocs, proc, timeout_s=timeout_s)
        self.directory = directory
        self.launch_id = launch_id
        os.makedirs(directory, exist_ok=True)

    def _path(self, round_no: int, proc: int) -> str:
        return os.path.join(self.directory,
                            f"l{self.launch_id}.r{round_no}.p{proc}")

    def _publish(self, round_no: int, payload: str) -> None:
        atomic_publish(self._path(round_no, self.proc), payload)

    def _gather(self, round_no: int) -> List[str]:
        deadline = time.monotonic() + self.timeout_s
        out: List[Optional[str]] = [None] * self.nprocs
        while True:
            for p in range(self.nprocs):
                if out[p] is None:
                    try:
                        with open(self._path(round_no, p),
                                  encoding="utf-8") as f:
                            out[p] = f.read()
                    except FileNotFoundError:
                        pass
            if all(v is not None for v in out):
                return out  # type: ignore[return-value]
            if time.monotonic() > deadline:
                missing = [p for p, v in enumerate(out) if v is None]
                raise RendezvousTimeout(
                    f"restart rendezvous round {round_no}: processes "
                    f"{missing} never published within "
                    f"{self.timeout_s:.0f}s (dir {self.directory})")
            time.sleep(0.05)


def from_env(settings):
    """The rendezvous of this run, or None for a run of one process.
    ``GS_RENDEZVOUS_DIR`` forces the file transport; otherwise the
    process group's store; the file transport beside the output store
    when the group has none."""
    from ..parallel import distributed

    group = distributed.group()
    if group is None:
        return None
    timeout_s = resolve_timeout_s()
    forced_dir = env_raw("GS_RENDEZVOUS_DIR")
    if not forced_dir and group.store is not None:
        return KVRendezvous(group.store, group.world, group.rank,
                            timeout_s=timeout_s, launch_id=group.launch_id)
    directory = forced_dir or (settings.output + ".rendezvous")
    coord = env_str("GS_TPU_COORDINATOR", "")
    launch_id = (f"{zlib.crc32(coord.encode()):08x}" if coord
                 else group.launch_id)
    return FileRendezvous(directory, group.world, group.rank,
                          timeout_s=timeout_s, launch_id=launch_id)
