"""BP-lite: a streaming, step-based, self-describing array store.

A copy of ``grayscott_jl_tpu/io/bplite.py`` (the format's specification
and pure-Python engine), kept in this package so that it imports
nothing of the reference. The on-disk format, the attributes and the
integrity sidecar are byte-compatible: a store either package writes
opens in the other's reader. What differs from the reference module:
the integrity hooks it needs are local here (:class:`CorruptionError`,
:func:`resolve_verify`, :func:`read_quarantine`, which
``resilience/integrity.py`` re-exports), bfloat16 variables are stored
as their bit patterns under the dtype name ``"bfloat16"``, and a block
is checksummed and written from a byte view of its array, never a copy.
The native C++ engine (``io/native.py``) writes the same format.

Writer semantics are ADIOS2's (``begin_step / put / end_step``, global
arrays in per-writer ``(shape, start, count)`` blocks, typed
attributes); the reader streams steps with ``begin_step(timeout) -> OK |
NOT_READY | END_OF_STREAM``.

On-disk layout of ``name.bp`` (a directory)::

    name.bp/
      md.json     -- metadata: attributes, variables, per-step block index;
                     rewritten atomically (tmp + rename) at every end_step
      data.<w>    -- append-only binary payload of writer w (C-order raw
                     array bytes, little-endian)
      integrity[.<w>].json -- per-block CRC32 sidecar

``md.json`` schema::

    {
      "format": "bplite-1",
      "complete": false,            # true once the writer closed
      "attributes": {name: {"dtype": str, "value": scalar|list}},
      "variables":  {name: {"dtype": str, "shape": [..] | []}},
      "steps": [                    # one entry per completed step
        {name: [ {"file": "data.0", "offset": int,
                  "start": [..], "count": [..]} , ...] }
      ]
    }

Scalars are zero-dim variables with ``start=count=[]``. The reader
exposes only steps whose payload is durable, and verifies each block's
CRC on read (``GS_CKPT_VERIFY``: ``read`` by default, ``off`` to skip,
``full`` to also read back every checkpoint after it is written and
check the snapshot's device checksum, ``resilience/integrity.py``).
"""

from __future__ import annotations

import enum
import json
import os
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

FORMAT_NAME = "bplite-1"

#: Valid ``GS_CKPT_VERIFY`` modes, the reference's: ``full`` is ``read``
#: plus the checkpoint read-back and the snapshot's device checksum.
VERIFY_MODES = ("off", "read", "full")

#: The dtype name of bfloat16 variables (numpy has no bfloat16; the
#: reference names it so through ``ml_dtypes``).
BF16 = "bfloat16"


def dtype_name(dtype) -> str:
    """The store's name of a numpy dtype, a torch dtype or a dtype name;
    bfloat16 is ``"bfloat16"``."""
    name = str(dtype).replace("torch.", "")
    if name == BF16:
        return BF16
    return np.dtype(name if name.isidentifier() else dtype).name


def _storage_dtype(name: str) -> np.dtype:
    """The numpy dtype of a variable's payload bytes: bfloat16 values
    are read and written as their uint16 bit patterns."""
    return np.dtype(np.uint16) if name == BF16 else np.dtype(name)


def bf16_bits(a) -> np.ndarray:
    """Float values rounded to bfloat16 (nearest, ties to even; NaN
    stays NaN), as uint16 bit patterns. torch does the rounding (a
    vectorized pass; numpy has no bfloat16), imported here so that the
    format itself needs only numpy."""
    import torch

    a = np.ascontiguousarray(a, dtype=np.float32)
    return (torch.from_numpy(a).to(torch.bfloat16).view(torch.int16)
            .numpy().view(np.uint16))


def bf16_widen(bits) -> np.ndarray:
    """uint16 bfloat16 bit patterns as float32 values (exact)."""
    bits = np.ascontiguousarray(bits, dtype=np.uint16)
    return (bits.astype(np.uint32) << 16).view(np.float32)


def bf16_round(a) -> np.ndarray:
    """Float values rounded to bfloat16, as a float32 array."""
    return bf16_widen(bf16_bits(a))


class CorruptionError(RuntimeError):
    """A block's recorded and recomputed CRCs disagree (``member``: the
    ensemble member whose bytes did)."""

    def __init__(self, detail: str, *, path: Optional[str] = None,
                 file: Optional[str] = None, offset: Optional[int] = None,
                 step: Optional[int] = None, var: Optional[str] = None,
                 member: Optional[int] = None):
        where = []
        if var is not None:
            where.append(f"var {var!r}")
        if step is not None:
            where.append(f"step {step}")
        if member is not None:
            where.append(f"member {member}")
        if file is not None:
            where.append(f"file {file!r}"
                         + (f" offset {offset}" if offset is not None
                            else ""))
        if path is not None:
            where.append(f"store {path}")
        suffix = f" ({', '.join(where)})" if where else ""
        super().__init__(detail + suffix)
        self.detail = detail
        self.path = path
        self.file = file
        self.offset = offset
        self.step = step
        self.var = var
        self.member = member


def resolve_verify() -> str:
    """``GS_CKPT_VERIFY``: ``off`` | ``read`` (default) | ``full``; any
    other value raises."""
    mode = (os.environ.get("GS_CKPT_VERIFY", "read") or "read").strip().lower()
    if mode not in VERIFY_MODES:
        raise ValueError(
            f"GS_CKPT_VERIFY must be one of {'|'.join(VERIFY_MODES)}, "
            f"got {mode!r}"
        )
    return mode


def byte_view(arr: np.ndarray) -> memoryview:
    """The bytes of a C-contiguous array as a flat memoryview (no copy):
    what a writer checksums and writes."""
    return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def read_quarantine(store: str) -> frozenset:
    """Quarantined step-entry indices of a store (``quarantine.json``,
    written by the scrubber, ``resilience/integrity.py``); a missing or
    torn marker means none."""
    try:
        with open(os.path.join(store, "quarantine.json"),
                  encoding="utf-8") as f:
            doc = json.load(f)
        return frozenset(int(i) for i in doc["quarantined"])
    except (FileNotFoundError, NotADirectoryError, ValueError,
            TypeError, KeyError):
        return frozenset()


class StepStatus(enum.Enum):
    """Reader step states (ADIOS2 ``step_status_*`` analog)."""

    OK = "ok"
    NOT_READY = "not_ready"
    END_OF_STREAM = "end_of_stream"


def _md_path(path: str) -> str:
    return os.path.join(path, "md.json")


def _integrity_path(path: str, writer_id: int = 0) -> str:
    name = (
        "integrity.json" if writer_id == 0
        else f"integrity.{writer_id}.json"
    )
    return os.path.join(path, name)


def read_integrity_crcs(path: str, writer_id: int = 0) -> dict:
    """One writer's recorded block CRCs: ``(file, offset) -> crc32``.
    A missing or torn sidecar degrades to an empty map (unverified
    reads) — the sidecar is advisory metadata, never a read gate."""
    try:
        with open(_integrity_path(path, writer_id),
                  encoding="utf-8") as f:
            doc = json.load(f)
        out = {}
        for key, val in (doc.get("crc") or {}).items():
            fname, _, off = key.rpartition(":")
            out[(fname, int(off))] = int(val[1])
        return out
    except (FileNotFoundError, NotADirectoryError, ValueError,
            TypeError, AttributeError, json.JSONDecodeError):
        return {}


class IntegrityMeta:
    """Writer-side ledger behind the integrity sidecar file.

    ``crc`` maps ``"file:offset"`` to ``[nbytes, crc32]`` for every
    payload block this writer committed; ``device`` is a list aligned
    with this writer's step entries holding the in-graph device-side
    field checksums recorded for that step (None when the boundary ran
    without the device probe). Rewritten atomically at every
    ``end_step`` — same discipline as ``md.json`` — and pruned on
    rollback-append so a resumed store's sidecar is byte-identical to
    an uninterrupted run's."""

    def __init__(self, store: str, writer_id: int = 0):
        self.path = _integrity_path(store, writer_id)
        self.crc: Dict[str, list] = {}
        self.device: List[Optional[dict]] = []
        self._pending_device: Optional[dict] = None

    def load(self) -> "IntegrityMeta":
        try:
            with open(self.path, encoding="utf-8") as f:
                doc = json.load(f)
            self.crc = dict(doc.get("crc") or {})
            self.device = list(doc.get("device") or [])
        except (FileNotFoundError, NotADirectoryError, ValueError,
                TypeError, json.JSONDecodeError):
            self.crc, self.device = {}, []
        return self

    def prune(self, data_file: str, cut: Optional[int],
              keep_steps: int) -> None:
        """Rollback: drop CRC entries at-or-past the payload cut of
        ``data_file`` and device records past the kept step count."""
        if cut is not None:
            self.crc = {
                k: v for k, v in self.crc.items()
                if not (k.rpartition(":")[0] == data_file
                        and int(k.rpartition(":")[2]) >= cut)
            }
        self.device = self.device[:keep_steps]

    def record_block(self, data_file: str, offset: int,
                     data: bytes) -> None:
        self.crc[f"{data_file}:{offset}"] = [
            len(data), zlib.crc32(data) & 0xFFFFFFFF,
        ]

    def record_device(self, checksums: Optional[dict]) -> None:
        """Device-side field checksums for the step currently being
        written (flushed with that step's ``end_step``)."""
        self._pending_device = (
            {str(k): int(v) for k, v in checksums.items()}
            if checksums else None
        )

    def note_step(self, n_steps: int) -> None:
        """Align the device list with the writer's committed step
        count (called at ``end_step``; pads boundaries that ran
        without the device probe)."""
        while len(self.device) < n_steps - 1:
            self.device.append(None)
        if len(self.device) < n_steps:
            self.device.append(self._pending_device)
        self._pending_device = None

    def flush(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"crc": self.crc, "device": self.device}, f)
        os.replace(tmp, self.path)

    def remove(self) -> None:
        try:
            os.remove(self.path)
        except (FileNotFoundError, NotADirectoryError):
            pass


def _block_nbytes(variables: dict, name: str, block: dict) -> Optional[int]:
    """Byte length of one block's payload, or None when the metadata is
    too damaged to tell (unknown variable/dtype)."""
    var = variables.get(name)
    if var is None:
        return None
    try:
        itemsize = _storage_dtype(var["dtype"]).itemsize
    except (KeyError, TypeError):
        return None
    n = 1
    for c in block.get("count", []):
        n *= int(c)
    return n * itemsize


def durable_step_count(md: dict, dirpath: str) -> int:
    """Number of leading step entries whose every payload block lies
    fully inside its data file.

    A crash (or an injected fault) between ``begin_step`` and a durable
    ``end_step`` can leave a final step entry whose bytes never landed
    — e.g. metadata replicated before the payload reached disk, or a
    payload file truncated by the filesystem. Reads of such a step
    would raise mid-restore or return garbage; capping the visible step
    count here is what makes "latest durable checkpoint" well-defined
    for the supervisor (``resilience/supervisor.py``). Unverifiable
    metadata (unknown variable/dtype) is treated as non-durable.
    """
    variables = md.get("variables", {})
    sizes: Dict[str, int] = {}
    steps = md.get("steps", [])
    for i, step_blocks in enumerate(steps):
        for name, blocks in step_blocks.items():
            for b in blocks:
                nbytes = _block_nbytes(variables, name, b)
                if nbytes is None:
                    return i
                fname = b.get("file")
                if fname not in sizes:
                    try:
                        sizes[fname] = os.path.getsize(
                            os.path.join(dirpath, fname)
                        )
                    except (OSError, TypeError):
                        sizes[fname] = -1
                if sizes[fname] < int(b.get("offset", 0)) + nbytes:
                    return i
    return len(steps)


def data_end_offset(md: dict, data_file: str) -> Optional[int]:
    """End offset of the last payload byte ``data_file`` owns across
    every step entry of ``md``, or None when the metadata cannot be
    verified. ``0`` for a store whose steps never touched the file.

    The writer's rollback path truncates its append-only payload here:
    entries past ``keep_steps`` (and any torn tail from a crashed
    step) vanish from the *bytes*, not just the metadata, so a resumed
    run's store is byte-identical to an uninterrupted one.
    """
    variables = md.get("variables", {})
    end = 0
    for step_blocks in md.get("steps", []):
        for name, blocks in step_blocks.items():
            for b in blocks:
                if b.get("file") != data_file:
                    continue
                nbytes = _block_nbytes(variables, name, b)
                if nbytes is None:
                    return None
                end = max(end, int(b.get("offset", 0)) + nbytes)
    return end


class BpWriter:
    """Step-based writer engine (``ADIOS2.open(io, name, mode_write)``).

    Multi-writer stores (the ADIOS2 MPI-aggregated-I/O analog for JAX
    multi-host runs): each process opens the same store with its own
    ``writer_id`` and ``nwriters`` set; every writer owns its private
    ``data.<w>`` payload and metadata file (``md.json`` for writer 0 —
    which also carries the attribute/variable definitions and the writer
    count — ``md.<w>.json`` for the rest), so NO cross-process
    coordination is needed. The reader merges per-step blocks and
    publishes a step only once every writer has committed it.
    """

    #: The engine's name in ``RunStats.config["io_engine"]``.
    engine = "python"

    def __init__(
        self,
        path: str,
        *,
        writer_id: int = 0,
        nwriters: int = 1,
        append: bool = False,
        keep_steps: Optional[int] = None,
    ):
        """``keep_steps`` (append mode): keep only the first N existing
        step entries — the rollback path, dropping the abandoned
        trajectory's steps past a ``restart_step`` so the resumed run
        does not append duplicates after them. The payload is truncated
        to the kept entries' end (``data_end_offset``), so the resumed
        store is byte-identical to one that never rolled back."""
        self.path = path
        self.writer_id = writer_id
        self.nwriters = nwriters
        if not 0 <= writer_id < nwriters:
            raise ValueError(f"writer_id {writer_id} not in [0, {nwriters})")
        os.makedirs(path, exist_ok=True)
        self._md_path = (
            _md_path(path)
            if writer_id == 0
            else os.path.join(path, f"md.{writer_id}.json")
        )
        self._data_path = os.path.join(path, f"data.{writer_id}")
        self._integrity = IntegrityMeta(path, writer_id)
        if append and os.path.exists(self._md_path):
            with open(self._md_path, "r", encoding="utf-8") as f:
                self._md = json.load(f)
            self._md["complete"] = False
            if keep_steps is not None:
                self._md["steps"] = self._md["steps"][:keep_steps]
            self._offset = (
                os.path.getsize(self._data_path)
                if os.path.exists(self._data_path)
                else 0
            )
            # Trim the payload to the metadata-durable end: rolled-back
            # entries and any torn tail from a crashed step are removed
            # from the bytes too, so the resumed store stays
            # byte-identical to an uninterrupted run's. Unverifiable
            # metadata falls back to plain append (absolute offsets
            # keep orphan bytes harmless, as before).
            cut = data_end_offset(
                self._md, os.path.basename(self._data_path)
            )
            if cut is not None and cut < self._offset:
                os.truncate(self._data_path, cut)
                self._offset = cut
            # Rollback the integrity sidecar in lockstep: CRC entries
            # past the payload cut and device records past the kept
            # steps vanish too, keeping the sidecar byte-identical to
            # an uninterrupted run's.
            self._integrity.load()
            self._integrity.prune(
                os.path.basename(self._data_path), cut,
                len(self._md["steps"]),
            )
        else:
            self._md = {
                "format": FORMAT_NAME,
                "complete": False,
                "nwriters": nwriters,
                "attributes": {},
                "variables": {},
                "steps": [],
            }
            with open(self._data_path, "wb"):
                pass
            self._offset = 0
            # Fresh store: stale integrity/quarantine markers from a
            # previous run at this path would mis-verify the new bytes.
            self._integrity.remove()
            if writer_id == 0:
                try:
                    os.remove(os.path.join(path, "quarantine.json"))
                except OSError:
                    pass
        self._data = open(self._data_path, "ab")
        self._in_step = False
        self._step_blocks: Dict[str, List[dict]] = {}
        self._flush_md()

    # -- definition phase (ADIOS2 define_attribute / define_variable) ------

    def define_attribute(self, name: str, value: Any) -> None:
        if isinstance(value, (list, tuple, np.ndarray)):
            arr = np.asarray(value)
            self._md["attributes"][name] = {
                "dtype": arr.dtype.name if arr.dtype.kind != "U" else "string",
                "value": arr.tolist(),
            }
        elif isinstance(value, str):
            self._md["attributes"][name] = {"dtype": "string", "value": value}
        elif isinstance(value, bool):
            self._md["attributes"][name] = {"dtype": "bool", "value": value}
        elif isinstance(value, (int, np.integer)):
            self._md["attributes"][name] = {"dtype": "int64", "value": int(value)}
        elif isinstance(value, (float, np.floating)):
            self._md["attributes"][name] = {
                "dtype": "float64",
                "value": float(value),
            }
        else:
            raise TypeError(f"Unsupported attribute type for {name!r}: {type(value)}")

    def define_variable(
        self, name: str, dtype, shape: Sequence[int] = ()
    ) -> None:
        """Define ``name``; ``dtype`` is a numpy or torch dtype or a
        dtype name (``"bfloat16"`` for bf16)."""
        self._md["variables"][name] = {
            "dtype": dtype_name(dtype),
            "shape": [int(s) for s in shape],
        }

    # -- step phase --------------------------------------------------------

    def begin_step(self) -> None:
        if self._in_step:
            raise RuntimeError("begin_step called inside an open step")
        self._in_step = True
        self._step_blocks = {}

    def put(
        self,
        name: str,
        value,
        *,
        start: Optional[Sequence[int]] = None,
        count: Optional[Sequence[int]] = None,
    ) -> None:
        """Write one block of variable ``name`` for the current step.

        ``start``/``count`` give the block's box in the global array
        (``IO.jl:60-67`` semantics); both default to the full variable.
        A ``"bfloat16"`` variable takes float values, rounded to bf16
        (exact for values that are bf16 already).
        """
        if not self._in_step:
            raise RuntimeError("put called outside begin_step/end_step")
        var = self._md["variables"].get(name)
        if var is None:
            raise KeyError(f"Variable {name!r} not defined")
        shape = var["shape"]
        if var["dtype"] == BF16:
            arr = bf16_bits(value)
        else:
            arr = np.asarray(value, dtype=var["dtype"])
        if not shape:
            # scalar variable: ascontiguousarray would promote 0-d to 1-d
            arr = arr.reshape(())
        else:
            arr = np.ascontiguousarray(arr)
        if start is None:
            start = [0] * len(shape)
        if count is None:
            count = list(shape)
        if list(arr.shape) != [int(c) for c in count]:
            raise ValueError(
                f"{name!r}: data shape {arr.shape} != count {tuple(count)}"
            )
        block = {
            "file": os.path.basename(self._data_path),
            "offset": self._offset,
            "start": [int(s) for s in start],
            "count": [int(c) for c in count],
        }
        data = byte_view(arr)
        self._integrity.record_block(
            os.path.basename(self._data_path), self._offset, data
        )
        self._data.write(data)
        self._offset += len(data)
        self._step_blocks.setdefault(name, []).append(block)

    def record_device_checksums(self, step: int, checksums) -> None:
        """Attach the boundary's device-side field checksums
        (``resilience/integrity.device_field_checksum``) to the step
        being written; they land in the integrity sidecar next to the
        block CRCs."""
        self._integrity.record_device(checksums)

    def end_step(self) -> None:
        """Complete the step: payload is flushed, then the metadata index is
        atomically replaced — a streaming reader sees the step only after
        its data is durable (ADIOS2 deferred-put flush, ``IO.jl:91-95``)."""
        if not self._in_step:
            raise RuntimeError("end_step called outside a step")
        self._data.flush()
        os.fsync(self._data.fileno())
        self._md["steps"].append(self._step_blocks)
        # Sidecar before metadata: a crash between the two leaves CRC
        # entries for a step the metadata never committed (harmless —
        # keyed by payload offset, overwritten on the re-append) rather
        # than a committed step with no CRCs (silently unverifiable).
        self._integrity.note_step(len(self._md["steps"]))
        self._integrity.flush()
        self._flush_md()
        self._in_step = False
        self._step_blocks = {}

    def close(self) -> None:
        if self._in_step:
            raise RuntimeError("close called inside an open step")
        self._md["complete"] = True
        self._flush_md()
        self._data.close()

    def _flush_md(self) -> None:
        tmp = self._md_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self._md, f)
        os.replace(tmp, self._md_path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class VarInfo:
    """A variable's name, shape and the dtype :meth:`BpReader.get`
    returns (float32 for a ``"bfloat16"`` variable, whose stored name is
    ``stored``)."""

    def __init__(self, name: str, dtype: str, shape: Tuple[int, ...]):
        self.name = name
        self.stored = dtype
        self.dtype = np.dtype(np.float32 if dtype == BF16 else dtype)
        self.shape = shape

    def __repr__(self):
        return f"VarInfo({self.name!r}, {self.dtype}, {self.shape})"


class BpReader:
    """Streaming step reader (``ADIOS2.open(io, name, mode_read)``).

    Supports live coupling: ``begin_step`` polls ``md.json`` until a step
    beyond the last-consumed one appears (NOT_READY while the writer is
    alive, END_OF_STREAM once it closed with no new steps) — the semantics
    the reference's pdfcalc loop relies on (``pdfcalc.jl:112-123``).
    """

    def __init__(self, path: str, *, wait_for_writer: bool = False,
                 verify: Optional[str] = None):
        """``wait_for_writer=True`` tolerates a store that does not exist
        yet (no directory, or no committed ``md.json``): construction
        succeeds with zero visible steps and ``begin_step`` polls until
        the writer commits — the live-coupling form ``open_reader``
        uses, where the reader may attach during the writer's first-step
        compile window (20-60 s). The default is strict (immediate
        ``FileNotFoundError``), the right behavior for checkpoint
        restores where a missing store is an operator error.

        ``verify`` overrides the resolved ``GS_CKPT_VERIFY`` mode for
        this reader (any non-``off`` mode recomputes the CRC of every
        block read against the store's integrity sidecar)."""
        self.path = path
        self._wait_for_writer = wait_for_writer
        if verify is None:
            verify = resolve_verify()
        self._verify = verify != "off"
        if not wait_for_writer and not os.path.isdir(path):
            raise FileNotFoundError(f"No such BP-lite store: {path}")
        self._consumed = 0
        self._current: Optional[dict] = None
        self._selections: Dict[str, Tuple[List[int], List[int]]] = {}
        self._md: dict = {}
        self._crcs: Dict[Tuple[str, int], int] = {}
        self._load_md()

    def _load_md(self) -> None:
        # Writers replace their metadata files atomically; retry briefly on
        # the window where a JSON read could race a slow filesystem.
        md0 = self._load_one(
            _md_path(self.path), required=not self._wait_for_writer
        )
        if md0 is None:
            # Writer not started yet (wait_for_writer mode): nothing
            # visible; begin_step keeps polling until md.json appears.
            self._md = {
                "format": FORMAT_NAME, "complete": False, "steps": [],
                "attributes": {}, "variables": {},
            }
            return
        nwriters = int(md0.get("nwriters", 1))
        if self._verify:
            self._crcs = {}
            for w in range(nwriters):
                self._crcs.update(read_integrity_crcs(self.path, w))
        if nwriters == 1:
            # Publish only durable steps: a torn final entry (crash
            # between begin_step and a durable end_step) must not be
            # readable — it would raise mid-restore or return garbage.
            md0["steps"] = md0["steps"][:durable_step_count(md0, self.path)]
            self._drop_quarantined(md0)
            self._md = md0
            return
        # Multi-writer store: merge. A step is visible only once EVERY
        # writer has committed it durably; the stream is complete when all
        # writers closed and no unmerged steps remain.
        mds = [md0]
        for w in range(1, nwriters):
            md_w = self._load_one(
                os.path.join(self.path, f"md.{w}.json"), required=False
            )
            if md_w is None:  # writer not started yet: nothing visible
                md_w = {"complete": False, "steps": []}
            mds.append(md_w)
        for w, m in enumerate(mds):
            # Peer metadata normally carries its own variables table; a
            # (corrupt) one without falls back to writer 0's — LOUDLY:
            # a writer whose variable registry vanished is a damaged
            # store, and a silent fallback would hide the first symptom
            # of the corruption the integrity layer exists to surface.
            if w > 0 and m.get("steps") and not m.get("variables"):
                self._warn_corrupt_writer_md(w)
            checked = (
                m if m.get("variables")
                else dict(m, variables=md0.get("variables", {}))
            )
            m["steps"] = m.get("steps", [])[
                :durable_step_count(checked, self.path)
            ]
        n_steps = min(len(m["steps"]) for m in mds)
        steps = []
        for i in range(n_steps):
            merged: dict = {}
            for m in mds:
                for var, blocks in m["steps"][i].items():
                    merged.setdefault(var, []).extend(blocks)
            steps.append(merged)
        merged = {
            "format": md0.get("format", FORMAT_NAME),
            "complete": all(m.get("complete") for m in mds),
            "nwriters": nwriters,
            "attributes": md0.get("attributes", {}),
            "variables": md0.get("variables", {}),
            "steps": steps,
        }
        self._drop_quarantined(merged)
        self._md = merged

    def _drop_quarantined(self, md: dict) -> None:
        """Hide step entries the scrubber quarantined
        (``resilience/integrity.py``): a corrupt durable entry must
        not be served, and hiding it here is what lets "latest durable
        checkpoint" roll past it to the newest *healthy* entry."""
        bad = read_quarantine(self.path)
        if bad:
            md["steps"] = [
                s for i, s in enumerate(md["steps"]) if i not in bad
            ]

    def _warn_corrupt_writer_md(self, writer_id: int) -> None:
        """One ``corruption`` event + warn per reader for a writer
        whose metadata lost its variable registry (satellite fix for
        the old silent writer-0 fallback)."""
        if getattr(self, "_warned_writers", None) is None:
            self._warned_writers: set = set()
        if writer_id in self._warned_writers:
            return
        self._warned_writers.add(writer_id)
        fname = f"md.{writer_id}.json"
        detail = (
            f"writer {writer_id} metadata {fname} has steps but no "
            "variable registry; validating its payloads against "
            "writer 0's registry"
        )
        from ..obs import events as obs_events
        from ..utils.log import Logger

        obs_events.get_events().emit(
            "corruption", path=self.path, file=fname, detail=detail)
        Logger().warn(f"BP-lite store {self.path}: {detail}")

    def _load_one(self, path: str, *, required: bool):
        for _ in range(50):
            try:
                with open(path, "r", encoding="utf-8") as f:
                    return json.load(f)
            except FileNotFoundError:
                if not required:
                    return None
                time.sleep(0.01)
            except json.JSONDecodeError:
                time.sleep(0.01)
        raise RuntimeError(f"Unreadable BP-lite metadata at {path}")

    # -- step streaming ----------------------------------------------------

    def begin_step(self, timeout: float = 10.0) -> StepStatus:
        deadline = time.monotonic() + timeout
        while True:
            self._load_md()
            if self._consumed < len(self._md["steps"]):
                self._current = self._md["steps"][self._consumed]
                self._selections = {}
                return StepStatus.OK
            if self._md.get("complete"):
                return StepStatus.END_OF_STREAM
            if time.monotonic() >= deadline:
                return StepStatus.NOT_READY
            time.sleep(0.05)

    def current_step(self) -> int:
        return self._consumed

    def end_step(self) -> None:
        if self._current is None:
            raise RuntimeError("end_step without an open step")
        self._current = None
        self._consumed += 1

    # -- inquiry -----------------------------------------------------------

    def attributes(self) -> Dict[str, Any]:
        return {
            k: v["value"] for k, v in self._md.get("attributes", {}).items()
        }

    def available_variables(self) -> Dict[str, VarInfo]:
        return {
            name: VarInfo(name, v["dtype"], tuple(v["shape"]))
            for name, v in self._md.get("variables", {}).items()
        }

    def inquire_variable(self, name: str) -> Optional[VarInfo]:
        return self.available_variables().get(name)

    def boxes(self, name: str, step: int) -> List[Tuple[tuple, tuple]]:
        """The ``(start, count)`` box of each block of variable ``name``
        at ``step``, in the order they were written."""
        if not 0 <= step < len(self._md["steps"]):
            raise IndexError(f"step {step} out of range")
        return [(tuple(b["start"]), tuple(b["count"]))
                for b in self._md["steps"][step].get(name, [])]

    def num_steps(self) -> int:
        return len(self._md["steps"])

    def set_selection(
        self, name: str, start: Sequence[int], count: Sequence[int]
    ) -> None:
        """Select a box of the global array for the next ``get`` (ADIOS2
        ``set_selection``, used by pdfcalc's z-split, ``pdfcalc.jl:144``)."""
        self._selections[name] = (
            [int(s) for s in start],
            [int(c) for c in count],
        )

    # -- data --------------------------------------------------------------

    def _codec_info(self) -> Dict[str, dict]:
        """The store's snapshot-codec registry, ``{var_name: {"bits",
        "dtype"}}``; empty for exact stores."""
        from .codec import decode_attr

        return decode_attr(self.attributes())

    def get(
        self,
        name: str,
        *,
        step: Optional[int] = None,
        start: Optional[Sequence[int]] = None,
        count: Optional[Sequence[int]] = None,
    ) -> np.ndarray:
        """Read variable ``name`` at the current (or given) step, honoring
        any selection (``start``/``count`` here override a stored
        ``set_selection``). Assembles the box from the step's blocks.
        A CRC-mismatching block surfaces as a :class:`CorruptionError`
        naming the variable and step entry alongside the file/offset/CRC
        pair. A ``"bfloat16"`` variable is returned as float32 holding
        the bf16 values exactly. A variable the lossy snapshot codec
        wrote is CRC-checked as stored, then decoded against the step's
        ``<NAME>__qlo``/``__qhi`` range to its original dtype (float32
        for bfloat16)."""
        try:
            out = self._get(name, step=step, start=start, count=count)
        except CorruptionError as e:
            if e.var is None:
                raise CorruptionError(
                    e.detail, path=e.path or self.path, file=e.file,
                    offset=e.offset, var=name,
                    step=step if step is not None else self._consumed,
                ) from e
            raise
        info = self._codec_info().get(name)
        if info is not None:
            from .codec import dequantize, qhi_var, qlo_var

            idx = step if step is not None else self._consumed
            lo = float(self._get(qlo_var(name), step=idx))
            hi = float(self._get(qhi_var(name), step=idx))
            return dequantize(out, lo, hi, info["bits"], info["dtype"])
        return out

    def _get(
        self,
        name: str,
        *,
        step: Optional[int] = None,
        start: Optional[Sequence[int]] = None,
        count: Optional[Sequence[int]] = None,
    ) -> np.ndarray:
        if step is None:
            if self._current is None:
                raise RuntimeError("get outside begin_step/end_step "
                                   "(or pass step=...)")
            blocks = self._current.get(name)
        else:
            if not 0 <= step < len(self._md["steps"]):
                raise IndexError(f"step {step} out of range")
            blocks = self._md["steps"][step].get(name)
        if blocks is None:
            raise KeyError(f"Variable {name!r} has no data at this step")
        info = self.inquire_variable(name)
        stored = _storage_dtype(info.stored)
        if info.stored == BF16:
            return bf16_widen(self._get_stored(blocks, info, stored, start,
                                               count, name))
        return self._get_stored(blocks, info, stored, start, count, name)

    def _get_stored(self, blocks, info, stored, start, count, name):
        """The box of ``name`` from ``blocks`` as stored (``stored``)."""
        if not info.shape:  # scalar
            return self._read_block(blocks[0], stored, ())

        if start is None:
            sel = self._selections.get(name)
            if sel is None:
                start = [0] * len(info.shape)
                count = list(info.shape)
            else:
                start, count = sel
        else:
            start = [int(s) for s in start]
            count = [int(c) for c in count]
        out = np.empty(count, dtype=stored)
        filled = np.zeros(count, dtype=bool)
        sel_lo = np.array(start)
        sel_hi = sel_lo + np.array(count)
        for b in blocks:
            b_lo = np.array(b["start"])
            b_hi = b_lo + np.array(b["count"])
            lo = np.maximum(sel_lo, b_lo)
            hi = np.minimum(sel_hi, b_hi)
            if np.any(lo >= hi):
                continue
            data = self._read_block(b, stored, tuple(b["count"]))
            src = tuple(
                slice(int(l - bl), int(h - bl))
                for l, h, bl in zip(lo, hi, b_lo)
            )
            dst = tuple(
                slice(int(l - sl), int(h - sl))
                for l, h, sl in zip(lo, hi, sel_lo)
            )
            out[dst] = data[src]
            filled[dst] = True
        if not filled.all():
            raise ValueError(
                f"Selection {start}+{count} of {name!r} not fully covered "
                "by written blocks"
            )
        return out

    def _read_block(self, block: dict, dtype, shape) -> np.ndarray:
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize if shape else dtype.itemsize
        with open(os.path.join(self.path, block["file"]), "rb") as f:
            f.seek(block["offset"])
            buf = f.read(nbytes)
        if len(buf) != nbytes:
            raise IOError(
                f"Short read in {block['file']} at {block['offset']}"
            )
        if self._verify:
            # Verify-on-read: a payload whose recorded CRC mismatches
            # is never served (blocks written before the integrity
            # sidecar existed have no recorded CRC and read as before).
            want = self._crcs.get(
                (block["file"], int(block["offset"]))
            )
            if want is not None:
                got = zlib.crc32(buf) & 0xFFFFFFFF
                if got != want:
                    raise CorruptionError(
                        f"payload CRC mismatch: recorded {want:#010x}, "
                        f"read {got:#010x}",
                        path=self.path, file=block["file"],
                        offset=int(block["offset"]),
                    )
        arr = np.frombuffer(buf, dtype=dtype)
        return arr.reshape(shape) if shape else arr[0]

    def close(self) -> None:
        self._current = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
