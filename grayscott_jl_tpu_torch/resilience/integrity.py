"""Data integrity: checksums, replicas, scrubbing (counterpart of
``grayscott_jl_tpu/resilience/integrity.py``).

**Checksums.** Every BP-lite payload block has a CRC32 in the store's
integrity sidecar (``integrity[.<w>].json``), and the reader recomputes
it on every block read (``GS_CKPT_VERIFY=read``, the default), raising
:class:`CorruptionError` instead of serving changed bytes.
``GS_CKPT_VERIFY=full`` adds (a) a read-back of every checkpoint step
after it is written and (b) the device-side field checksum
(:func:`device_field_checksum`): at each boundary the snapshot reduces
the wrapped uint32 sum of each field's raw words on the card, and the
host re-derives it from the bytes that landed
(:func:`host_field_checksum`) before anything reaches a store.

**Replicas.** ``GS_CKPT_REPLICAS=N`` mirrors every checkpoint write to
``<path>.r1`` .. ``<path>.r<N-1>``. A restore tries the candidates in
health order (most durable steps first, the primary winning ties) and
fails over on a corrupt or unreadable one; a sole corrupt replica
refuses loudly.

**Scrubbing.** ``GS_SCRUB=1`` arms :class:`Scrubber`: at checkpoint
boundaries (every ``GS_SCRUB_EVERY``-th) it audits the durable steps of
every checkpoint replica against the recorded CRCs and quarantines the
corrupt entries (``quarantine.json``; readers hide them).

The reference writes failovers and scrubs to its fault journal and
event stream; this package has neither yet (ROADMAP Queue 1 items 17
and 21), so they are logged and collected by an :class:`IntegrityLog`,
which the driver echoes into ``RunStats.config["integrity"]``.
"""

from __future__ import annotations

import glob
import json
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config.env import env_flag, env_int
from ..obs import events as obs_events
from ..io.bplite import (VERIFY_MODES, CorruptionError, read_quarantine,
                         resolve_verify as _resolve_verify_env)

__all__ = [
    "VERIFY_MODES",
    "CorruptionError",
    "IntegrityLog",
    "Scrubber",
    "add_quarantine",
    "apply_bitflip",
    "corrupt_store_byte",
    "device_field_checksum",
    "file_crc",
    "host_field_checksum",
    "latest_durable_step_replicated",
    "primary_checkpoint_path",
    "quarantine_path",
    "read_quarantine",
    "recoverable_restore_error",
    "remove_quarantine",
    "replica_paths",
    "replicate_store",
    "resolve_config",
    "resolve_replicas",
    "resolve_scrub",
    "resolve_verify",
    "restore_candidates",
    "restore_with_failover",
    "scrub_store",
    "verify_last_step",
    "verify_store",
]

_QUARANTINE = "quarantine.json"


class IntegrityLog:
    """Where failovers, corruptions and scrubs are recorded: each
    ``record(event=..., ...)`` keeps the event, hands it to the run's
    fault journal (``resilience/supervisor.FaultJournal``, which mirrors
    it to the run event stream), or with none mirrors it there itself
    (``obs/events.py``, ``GS_EVENTS``), and logs it (a warning for
    ``replica_failover`` and ``corruption``)."""

    def __init__(self, log=None, journal=None):
        self.log = log
        self.journal = journal
        self.events: List[dict] = []

    def record(self, **event) -> None:
        self.events.append(event)
        if self.journal is not None:
            self.journal.record(**dict(event))
        else:
            obs_events.emit_record(event)
        if self.log is None:
            return
        kind = event.get("event")
        detail = ", ".join(f"{k}={v}" for k, v in event.items()
                           if k != "event")
        if kind in ("replica_failover", "corruption"):
            self.log.warn(f"{kind}: {detail}")
        else:
            self.log.info(f"{kind}: {detail}")


# --------------------------------------------------------------- knobs


def resolve_replicas(settings=None) -> int:
    """``GS_CKPT_REPLICAS``: total checkpoint store copies, the primary
    included; default 1 (no mirrors)."""
    n = env_int("GS_CKPT_REPLICAS", 1)
    if n < 1:
        raise ValueError(f"GS_CKPT_REPLICAS must be >= 1, got {n}")
    return n


def resolve_verify(settings=None) -> str:
    """``GS_CKPT_VERIFY``: ``off`` | ``read`` (default) | ``full``."""
    return _resolve_verify_env()


def resolve_scrub(settings=None) -> Tuple[bool, int]:
    """``GS_SCRUB`` (default off) arms the checkpoint scrubber;
    ``GS_SCRUB_EVERY`` audits every N-th checkpoint boundary (default
    1)."""
    every = env_int("GS_SCRUB_EVERY", 1)
    if every < 1:
        raise ValueError(f"GS_SCRUB_EVERY must be >= 1, got {every}")
    return env_flag("GS_SCRUB", False), every


def resolve_config(settings=None) -> dict:
    """The resolved integrity configuration the driver echoes into
    ``RunStats.config["integrity"]``."""
    scrub, every = resolve_scrub(settings)
    return {
        "replicas": resolve_replicas(settings),
        "verify": resolve_verify(settings),
        "scrub": scrub,
        "scrub_every": every,
    }


# ------------------------------------------------------------ checksums


def file_crc(data) -> int:
    """CRC32 of one payload block's bytes (zlib, unsigned)."""
    return zlib.crc32(data) & 0xFFFFFFFF


def host_field_checksum(arr) -> int:
    """The wrapped (mod 2^32) sum of an array's raw bytes read as
    little-endian unsigned words: 16-bit words for a 2-byte dtype,
    32-bit words otherwise (two per float64). The host mirror of
    :func:`device_field_checksum`."""
    a = np.ascontiguousarray(arr)
    if a.size == 0:
        return 0
    word = "<u2" if a.dtype.itemsize == 2 else "<u4"
    words = a.reshape(-1).view(np.dtype(word))
    return int(words.sum(dtype=np.uint64) % (1 << 32))


def _words(f):
    """A tensor's storage as signed 16- or 32-bit words (torch has no
    uint32 arithmetic)."""
    import torch

    word = torch.int16 if f.element_size() == 2 else torch.int32
    return f.contiguous().reshape(-1).view(word)


def device_field_checksum(*fields):
    """Per field, the wrapped uint32 sum of its raw words, reduced on the
    field's device: one int64 scalar tensor each, enqueued only.

    The words are summed as signed integers into an int64 accumulator
    (no widened copy): a signed 32-bit word differs from its unsigned
    value by a multiple of 2^32, so the sum is right mod 2^32; a signed
    16-bit word differs by 2^16, which the count of negative words puts
    back. Exact at every size up to 2^32 words of a field, and
    independent of the order of the reduction."""
    import torch

    out = ()
    for f in fields:
        w = _words(f)
        total = w.sum(dtype=torch.int64)
        if w.dtype == torch.int16:
            total = total + (w < 0).sum(dtype=torch.int64) * (1 << 16)
        out += (total & 0xFFFFFFFF,)
    return out


def member_field_checksum(*fields):
    """:func:`device_field_checksum` of each member of member-stacked
    fields ``(N, nx, ny, nz)``: an ``(N, n)`` int64 tensor, member ``k``'s
    row equal to the checksum of member ``k``'s block alone."""
    import torch

    cols = []
    for f in fields:
        w = _words(f).reshape(f.shape[0], -1)
        total = w.sum(1, dtype=torch.int64)
        if w.dtype == torch.int16:
            total = total + (w < 0).sum(1, dtype=torch.int64) * (1 << 16)
        cols.append(total & 0xFFFFFFFF)
    return torch.stack(cols, 1)


def apply_bitflip(t, index: Sequence[int], bit: int = 0):
    """A copy of tensor ``t`` with one bit of one element's storage word
    flipped (the first word of the element at ``index``, zero-padded to
    ``t``'s rank): the test hook that makes a snapshot's bytes silently
    wrong. Any single-bit flip changes the wrapped word sum, so the
    device checksum catches it."""
    import torch

    out = t.detach().clone(memory_format=torch.contiguous_format)
    words = _words(out)
    per = out.element_size() // words.element_size()
    idx = tuple(index) + (0,) * (out.dim() - len(index))
    flat = int(np.ravel_multi_index(idx, tuple(out.shape))) if idx else 0
    nbits = 8 * words.element_size()
    mask = 1 << bit
    if mask >= 1 << (nbits - 1):
        mask -= 1 << nbits
    words[flat * per] ^= torch.tensor(mask, dtype=words.dtype,
                                      device=words.device)
    return out


# ------------------------------------------------------------- replicas


def replica_paths(path: str, n: Optional[int] = None) -> List[str]:
    """The write-side replica set of a checkpoint store: the primary
    plus ``<path>.r1`` .. ``<path>.r<n-1>``."""
    if n is None:
        n = resolve_replicas()
    return [path] + [f"{path}.r{k}" for k in range(1, n)]


def _existing_replicas(path: str) -> List[str]:
    """Mirrors of ``path`` present on disk (found, not configured: a
    restart with ``GS_CKPT_REPLICAS=1`` still fails over to mirrors an
    earlier run wrote)."""
    out = []
    for p in glob.glob(glob.escape(path) + ".r*"):
        tail = p[len(path) + 2:]
        if p[len(path):].startswith(".r") and tail.isdigit():
            out.append((int(tail), p))
    return [p for _, p in sorted(out)]


def restore_candidates(path: str) -> List[str]:
    """The stores a restore tries, in health order: the primary and every
    mirror on disk, by latest durable step descending, the primary
    winning ties."""
    from ..io.checkpoint import latest_durable_step

    cands = [path] + _existing_replicas(path)
    if len(cands) == 1:
        return cands

    def health(p: str) -> int:
        s = latest_durable_step(p)
        return -1 if s is None else s

    return sorted(cands, key=health, reverse=True)


def latest_durable_step_replicated(
        path: str, max_step: Optional[int] = None) -> Optional[int]:
    """The latest durable checkpoint step any replica of ``path`` holds
    (at most ``max_step`` when given)."""
    from ..io.checkpoint import latest_durable_step

    steps = [latest_durable_step(p, max_step=max_step)
             for p in [path] + _existing_replicas(path)]
    live = [s for s in steps if s is not None]
    return max(live) if live else None


def recoverable_restore_error(exc: BaseException) -> bool:
    """Is this restore failure worth trying another replica for?
    Corruption, unreadable stores and missing step entries are; errors
    of the config's identity (model, precision, L) would fail the same
    on every replica."""
    if isinstance(exc, CorruptionError):
        return True
    if isinstance(exc, (FileNotFoundError, OSError)):
        return True
    if isinstance(exc, RuntimeError):
        return "Unreadable BP-lite metadata" in str(exc)
    if isinstance(exc, ValueError):
        msg = str(exc)
        return ("contains no steps" in msg
                or "no entry for simulation step" in msg)
    return False


def restore_with_failover(path: str, attempt, *, journal=None, log=None):
    """``attempt(candidate)`` over the replica candidates of ``path`` in
    health order, failing over on a recoverable error with a
    ``replica_failover`` record per skipped candidate. When every
    candidate fails the last error is raised: with one corrupt store,
    the CRC mismatch itself."""
    candidates = restore_candidates(path)
    last: Optional[BaseException] = None
    for i, cand in enumerate(candidates):
        if last is not None:
            _announce_failover(path, cand, last, journal=journal, log=log)
        try:
            return attempt(cand)
        except BaseException as exc:  # noqa: BLE001 — filtered below
            if not recoverable_restore_error(exc) or (
                    i == len(candidates) - 1):
                raise
            last = exc
    raise last  # pragma: no cover — the loop returns or raises


def _announce_failover(path: str, next_path: str, exc: BaseException,
                       *, journal=None, log=None) -> None:
    detail = f"{type(exc).__name__}: {exc}"
    if journal is not None:
        journal.record(event="replica_failover", path=path, next=next_path,
                       detail=detail)
    else:
        obs_events.get_events().emit(
            "replica_failover", path=path, next=next_path, detail=detail)
    if journal is None or getattr(journal, "log", None) is None:
        from ..utils.log import Logger

        (log or Logger()).warn(
            f"checkpoint replica failover: {detail}; trying {next_path}")


# ----------------------------------------------------------- quarantine


def quarantine_path(store: str) -> str:
    return os.path.join(store, _QUARANTINE)


def add_quarantine(store: str, indices) -> None:
    """Extend the store's quarantine marker (atomically)."""
    merged = sorted(read_quarantine(store) | {int(i) for i in indices})
    tmp = quarantine_path(store) + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"quarantined": merged}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, quarantine_path(store))


def remove_quarantine(store: str) -> None:
    try:
        os.remove(quarantine_path(store))
    except (FileNotFoundError, NotADirectoryError):
        pass


# ------------------------------------------------------------- scrubber


def scrub_store(path: str, *, journal=None, quarantine: bool = True,
                writers: Optional[Sequence[int]] = None) -> Optional[dict]:
    """Audit every durable, not yet quarantined step entry of a BP-lite
    store against its recorded block CRCs and quarantine the corrupt
    ones. Returns the audit (None for a store with no metadata yet).
    Reads only the on-disk metadata, so a live writer is undisturbed.
    ``writers`` limits the audit to those writers' blocks (each process
    of a multi-process run scrubs its own). A real ADIOS2 store records
    no CRCs, so its blocks are skipped; its rollback sidecar, a BP-lite
    store with its own ledger, is audited in its place."""
    from ..io import _real_bp_evidence, bplite, sidecar

    if _real_bp_evidence(path):
        report = None
        if sidecar.read_keep_base(path) is not None:
            report = scrub_store(sidecar.sidecar_path(path), journal=journal,
                                 quarantine=quarantine, writers=writers)
        return dict(report or {"path": path, "steps_audited": 0,
                               "blocks_checked": 0, "corrupt": []},
                    unverified_base=path)
    md_path = os.path.join(path, "md.json")
    if not os.path.isfile(md_path):
        return None
    try:
        with open(md_path, encoding="utf-8") as f:
            md0 = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    nwriters = int(md0.get("nwriters", 1))
    already = read_quarantine(path)
    corrupt: Dict[int, str] = {}
    audited = 0
    checked = 0
    writers = range(nwriters) if writers is None else list(writers)
    for w in writers:
        name = "md.json" if w == 0 else f"md.{w}.json"
        try:
            with open(os.path.join(path, name), encoding="utf-8") as f:
                md = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if not md.get("variables"):
            md = dict(md, variables=md0.get("variables", {}))
        crcs = bplite.read_integrity_crcs(path, w)
        n = bplite.durable_step_count(md, path)
        for i, step_blocks in enumerate(md.get("steps", [])[:n]):
            if i in already or i in corrupt:
                continue
            if w == writers[0]:
                audited += 1
            bad, nblocks = _scrub_step(path, md, step_blocks, crcs)
            checked += nblocks
            if bad is not None:
                corrupt[i] = bad
    report = {
        "path": path,
        "steps_audited": audited,
        "blocks_checked": checked,
        "corrupt": sorted(corrupt),
    }
    if journal is not None:
        for i, detail in sorted(corrupt.items()):
            journal.record(event="corruption", path=path, step_index=i,
                           detail=detail)
    if corrupt and quarantine:
        add_quarantine(path, corrupt)
    if journal is not None:
        journal.record(event="scrub", path=path, steps_audited=audited,
                       corrupt=len(corrupt))
    return report


def _scrub_step(path: str, md: dict, step_blocks: dict, crcs: dict
                ) -> Tuple[Optional[str], int]:
    """CRC-audit one step entry: ``(first mismatch or None, blocks
    checked)``. Blocks with no recorded CRC are skipped."""
    from ..io.bplite import _block_nbytes

    checked = 0
    for var, blocks in step_blocks.items():
        if var.startswith("_"):
            continue
        for b in blocks:
            want = crcs.get((b.get("file"), int(b.get("offset", 0))))
            if want is None:
                continue
            nbytes = _block_nbytes(md.get("variables", {}), var, b)
            if nbytes is None:
                continue
            try:
                with open(os.path.join(path, b["file"]), "rb") as f:
                    f.seek(int(b["offset"]))
                    data = f.read(nbytes)
            except OSError as e:
                return (f"unreadable payload for {var!r}: {e}", checked)
            checked += 1
            got = file_crc(data)
            if got != int(want):
                return (
                    f"CRC mismatch for {var!r} in {b['file']} at "
                    f"offset {b['offset']}: recorded "
                    f"{int(want):#010x}, read {got:#010x}",
                    checked,
                )
    return (None, checked)


class Scrubber:
    """Boundary-time audit of the run's checkpoint stores: every
    ``every``-th call of :meth:`maybe_scrub` scrubs the primary and each
    mirror on disk."""

    def __init__(self, settings, *, journal=None, every: int = 1,
                 writer_id: Optional[int] = None):
        self.settings = settings
        self.journal = journal
        self.every = max(1, int(every))
        #: The writer whose blocks are audited (None: all).
        self.writer_id = writer_id
        self._boundaries = 0
        self.reports: List[dict] = []

    def _paths(self) -> List[str]:
        """Every checkpoint store the run writes: each replica, and of an
        ensemble each active member's."""
        root = self.settings.checkpoint_output
        ens = getattr(self.settings, "ensemble", None)
        roots = [root]
        if ens is not None:
            from ..ensemble.io import member_path

            roots = [member_path(root, i, ens.n)
                     for i in range(ens.n) if ens.members[i].active]
        return [p for r in roots for p in [r] + _existing_replicas(r)]

    def maybe_scrub(self, step: int) -> Optional[List[dict]]:
        self._boundaries += 1
        if (self._boundaries - 1) % self.every:
            return None
        reports = []
        for p in self._paths():
            rep = scrub_store(p, journal=self.journal,
                              writers=(None if self.writer_id is None
                                       else [self.writer_id]))
            if rep is not None:
                rep["step"] = step
                reports.append(rep)
        self.reports.extend(reports)
        return reports

    def describe(self) -> dict:
        return {
            "every": self.every,
            "audits": len(self.reports),
            "corrupt_found": sum(len(r["corrupt"]) for r in self.reports),
        }


# ------------------------------------------------------- write side etc


def verify_last_step(path: str, writer_id: int = 0,
                     nwriters: int = 1) -> None:
    """The write-side read-back (``GS_CKPT_VERIFY=full``): re-read every
    variable of the store's last durable step through the CRC-checked
    read, raising :class:`CorruptionError` if the bytes that landed are
    not the bytes checksummed at ``put``. A writer of a multi-writer
    store (``nwriters`` > 1) reads back its own last step against its
    own ``integrity.<w>.json``: the merged store shows a step only once
    every writer committed it."""
    if nwriters > 1:
        _verify_writer_last_step(path, writer_id)
        return
    from ..io.bplite import BpReader

    r = BpReader(path, verify="read")
    try:
        n = r.num_steps()
        if n == 0:
            return
        for name in r.available_variables():
            try:
                r.get(name, step=n - 1)
            except KeyError:
                continue
    finally:
        r.close()


def _verify_writer_last_step(path: str, writer_id: int) -> None:
    from ..io import bplite

    with open(os.path.join(path, "md.json"), encoding="utf-8") as f:
        md0 = json.load(f)
    md = md0
    if writer_id:
        with open(os.path.join(path, f"md.{writer_id}.json"),
                  encoding="utf-8") as f:
            md = json.load(f)
        if not md.get("variables"):
            md = dict(md, variables=md0.get("variables", {}))
    n = bplite.durable_step_count(md, path)
    if n == 0:
        return
    bad, _ = _scrub_step(path, md, md["steps"][n - 1],
                         bplite.read_integrity_crcs(path, writer_id))
    if bad is not None:
        raise CorruptionError(f"store {path} writer {writer_id} step "
                              f"entry {n - 1}: {bad}")


def verify_store(path: str) -> dict:
    """Full CRC audit of a finished store, never quarantining: raises
    :class:`CorruptionError` naming the corrupt entries, for a store with
    no readable metadata, or for a real ADIOS2 store, whose base records
    no CRCs: a cache must not vouch for a store it cannot verify."""
    report = scrub_store(path, quarantine=False)
    if report is None:
        raise CorruptionError(
            f"store {path} has no readable metadata — nothing to verify")
    if "unverified_base" in report:
        raise CorruptionError(
            f"store {path} is a real ADIOS2 BP store, whose base records "
            "no CRCs — it cannot be verified")
    if report["corrupt"]:
        raise CorruptionError(
            f"store {path}: CRC mismatch in step entr"
            f"{'ies' if len(report['corrupt']) > 1 else 'y'} "
            f"{report['corrupt']} ({report['steps_audited']} audited)")
    return report


def replicate_store(path: str, n: Optional[int] = None) -> List[str]:
    """Mirror a finished store to its ``.r1`` .. ``.r<n-1>`` paths
    (``GS_CKPT_REPLICAS`` when ``n`` is None), each atomically (a copy
    then a rename); mirrors already there are left alone. A rollback
    sidecar (``<store>.sidecar``) is mirrored beside its mirror, before
    it, so a mirror is never seen without its sidecar. Returns the
    mirrors written."""
    from ..io import sidecar

    if n is None:
        n = resolve_replicas()
    side = sidecar.sidecar_path(path)
    written = []
    for mirror in replica_paths(path, n)[1:]:
        if os.path.exists(mirror):
            continue
        if os.path.isdir(side):
            _copy_atomic(side, sidecar.sidecar_path(mirror))
        if _copy_atomic(path, mirror):
            written.append(mirror)
    return written


def _copy_atomic(src: str, dst: str) -> bool:
    """Copy directory ``src`` to ``dst`` through a temporary directory
    and a rename; False when ``dst`` was already there (left alone)."""
    import shutil

    if os.path.exists(dst):
        return False
    tmp = f"{dst}.copy.{os.getpid()}"
    try:
        shutil.copytree(src, tmp)
        os.rename(tmp, dst)
    except FileExistsError:
        shutil.rmtree(tmp, ignore_errors=True)
        return False
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return True


def primary_checkpoint_path(settings) -> str:
    """The primary checkpoint store a ``ckpt_corrupt`` fault targets: the
    solo store, or an ensemble's faulted member's (``GS_FAULT_MEMBER``,
    as for ``nan`` and ``bitflip``)."""
    ens = getattr(settings, "ensemble", None)
    if ens is None:
        return settings.checkpoint_output
    from ..config.env import env_int
    from ..ensemble.io import member_path

    return member_path(settings.checkpoint_output,
                       env_int("GS_FAULT_MEMBER", 0) % ens.n, ens.n)


def corrupt_store_byte(path: str) -> Optional[dict]:
    """XOR one payload byte of the latest durable step's first field
    block in store ``path``, leaving the metadata and recorded CRCs as
    they are: the silent corruption that verify-on-read, the scrubber
    and failover exist to catch. Returns what was flipped, or None when
    the store holds no durable field payload yet."""
    from ..io import bplite

    md_path = os.path.join(path, "md.json")
    if not os.path.isfile(md_path):
        return None
    try:
        with open(md_path, encoding="utf-8") as f:
            md = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    n = bplite.durable_step_count(md, path)
    for i in range(n - 1, -1, -1):
        for var, blocks in md.get("steps", [])[i].items():
            if var.startswith("_") or var == "step":
                continue
            for b in blocks:
                nbytes = bplite._block_nbytes(md.get("variables", {}), var,
                                              b)
                if not nbytes:
                    continue
                offset = int(b.get("offset", 0)) + nbytes // 2
                fpath = os.path.join(path, b["file"])
                with open(fpath, "r+b") as f:
                    f.seek(offset)
                    byte = f.read(1)
                    if not byte:
                        continue
                    f.seek(offset)
                    f.write(bytes([byte[0] ^ 0x01]))
                    f.flush()
                    os.fsync(f.fileno())
                return {"path": path, "file": b["file"], "offset": offset,
                        "var": var, "step_index": i}
    return None
