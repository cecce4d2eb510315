"""The run event stream: one schema, one tailable file (counterpart of
``grayscott_jl_tpu/obs/events.py``).

Every discrete thing that happens to a run lands in ``GS_EVENTS=path``
as one JSONL record with one schema::

    {"ts": <unix seconds>, "proc": <process index>, "kind": <event kind>,
     "phase": <driver phase or null>, "step": <sim step or null>,
     "attrs": {...}}

The driver emits the lifecycle markers (``run_start``, ``output``,
``checkpoint``, ``run_complete``, ``run_error``) and
``shutdown_requested`` the moment a SIGTERM/SIGINT lands; the numerics
recorder emits ``numerics`` and ``drift`` (``obs/numerics.py``); the
integrity records (``resilience/integrity.IntegrityLog``: failovers,
corruptions, scrubs), the health guard's reports and the graceful-
shutdown marker are mirrored here as the reference's fault journal
mirrors its records (:func:`emit_record`), and the store reader's
``corruption`` warning too.

Emitting is best-effort: a sink that cannot write marks itself
``broken``, warns once and keeps the run alive. A run of several
processes writes one ``path.rank<N>`` file per process
(:func:`~.trace.rank_path`); :func:`parse_events_multi` merges them
into one time-ordered list. stdlib only.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import sys
import threading
import time
from typing import List, Optional

from .trace import _proc_index, rank_path

__all__ = [
    "EVENT_FIELDS",
    "EventStream",
    "NULL_EVENTS",
    "arm_events",
    "bound",
    "emit_record",
    "get_events",
    "parse_events",
    "parse_events_multi",
    "rank_files",
    "reset_events",
]

#: Thread-local attrs merged into every record the thread emits while
#: inside a :func:`bound` block (explicit emit attrs win on collision).
_BOUND = threading.local()


@contextlib.contextmanager
def bound(**attrs):
    """Bind default attrs to every event this thread emits inside the
    block. Nests; inner bindings win."""
    prev = getattr(_BOUND, "attrs", None)
    _BOUND.attrs = {**(prev or {}), **attrs}
    try:
        yield
    finally:
        _BOUND.attrs = prev


#: The flat record fields; everything else an emitter passes rides in
#: ``attrs``.
EVENT_FIELDS = ("ts", "proc", "kind", "phase", "step", "attrs")


class _NullEventStream:
    """Shared no-op stream for when ``GS_EVENTS`` is unset."""

    enabled = False
    emitted = 0

    def emit(self, kind, phase=None, step=None, **attrs):
        return None

    def subscribe(self, fn):
        """No events will ever flow; the unsubscribe is a no-op."""
        return lambda: None

    def describe(self) -> dict:
        return {"enabled": False}


NULL_EVENTS = _NullEventStream()


class EventStream:
    """Append-only JSONL event sink (one line per event, flushed so that
    a tail sees it at once)."""

    enabled = True

    def __init__(self, path: str, proc: Optional[int] = None):
        self.path = path
        self.proc = _proc_index() if proc is None else proc
        self.emitted = 0
        self.broken: Optional[str] = None
        # Reentrant: the SIGTERM handler emits shutdown_requested on the
        # main thread, possibly while that thread is inside an emit.
        self._lock = threading.RLock()
        self._subscribers: List = []

    def subscribe(self, fn):
        """Register an in-process consumer: ``fn(record)`` is called on
        the emitting thread for every event after it is written. Returns
        the unsubscribe callable. A subscriber's exception is
        swallowed."""
        self._subscribers.append(fn)

        def _unsubscribe():
            try:
                self._subscribers.remove(fn)
            except ValueError:
                pass

        return _unsubscribe

    def emit(self, kind, phase=None, step=None, **attrs):
        """Record one event; returns the record (None once the stream is
        broken). Thread-safe: called from the driver thread, the output
        writer's thread and signal handlers."""
        if self.broken is not None:
            return None
        tl = getattr(_BOUND, "attrs", None)
        if tl:
            attrs = {**tl, **attrs}
        event = {
            "ts": round(time.time(), 6),
            "proc": self.proc,
            "kind": str(kind),
            "phase": phase,
            "step": step,
            "attrs": attrs,
        }
        try:
            line = json.dumps(event)
        except (TypeError, ValueError):
            # A non-JSON attr must not kill the producer: stringify.
            event["attrs"] = {k: repr(v) for k, v in attrs.items()}
            line = json.dumps(event)
        try:
            with self._lock:
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
                    f.flush()
                self.emitted += 1
        except OSError as e:
            # Monitoring must never take the run down.
            self.broken = f"{type(e).__name__}: {e}"
            print(f"gray-scott: warning: event stream {self.path} "
                  f"failed ({self.broken}); further events are dropped",
                  file=sys.stderr)
            return None
        for fn in list(self._subscribers):
            try:
                fn(event)
            except Exception:  # noqa: BLE001 — consumer must not kill the run
                pass
        return event

    def describe(self) -> dict:
        return {"enabled": True, "path": self.path,
                "emitted": self.emitted, "broken": self.broken,
                "subscribers": len(self._subscribers)}


def emit_record(record: dict):
    """Emit a journal-style record (``{"event": ..., "kind": ...,
    "step": ..., ...}``) on the process-wide stream, mapped as the
    reference's fault journal mirrors its records
    (``resilience/supervisor.py``): ``event`` becomes the stream
    ``kind``, a ``kind`` attr becomes ``fault``, ``phase`` and ``step``
    the record's own, and ``t``/``proc`` are dropped."""
    stream = get_events()
    if not stream.enabled:
        return None
    attrs = dict(record)
    kind = attrs.pop("event", None) or attrs.pop("kind", "event")
    fault = attrs.pop("kind", None)
    if fault is not None:
        attrs["fault"] = fault
    attrs.pop("t", None)
    attrs.pop("proc", None)
    return stream.emit(kind, phase=attrs.pop("phase", None),
                       step=attrs.pop("step", None), **attrs)


def parse_events(path: str) -> List[dict]:
    """Every event of a stream file, oldest first. Corrupt lines (a torn
    tail of a killed process) are skipped."""
    out: List[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(ev, dict):
                out.append(ev)
    return out


def rank_files(path: str) -> List[str]:
    """The files one ``GS_EVENTS=path`` produced: the bare path (a run
    of one process) and every ``path.rank<N>`` sibling, N-sorted. Works
    for every ``.rank``-suffixed family (events, metrics, stats)."""
    out = [path] if os.path.isfile(path) else []
    ranked = []
    for p in glob.glob(f"{glob.escape(path)}.rank*"):
        m = re.fullmatch(r"\.rank(\d+)", p[len(path):])
        if m:
            ranked.append((int(m.group(1)), p))
    return out + [p for _, p in sorted(ranked)]


def parse_events_multi(path: str) -> List[dict]:
    """One time-ordered event list from every process's file
    (:func:`rank_files`); each record keeps its ``proc``. The sort is
    stable on the wall-clock ``ts``."""
    events: List[dict] = []
    for p in rank_files(path):
        events.extend(parse_events(p))
    events.sort(key=lambda e: e.get("ts") or 0)
    return events


_stream = None


def get_events():
    """The process-wide stream: an :class:`EventStream` when
    ``GS_EVENTS`` names a path (``.rank<N>``-suffixed in a run of
    several processes), else the shared no-op. Resolved once."""
    global _stream
    if _stream is None:
        path = os.environ.get("GS_EVENTS", "").strip()
        _stream = EventStream(rank_path(path)) if path else NULL_EVENTS
    return _stream


def arm_events(path: str, proc: Optional[int] = None) -> EventStream:
    """Point the process-wide stream at ``path`` with an explicit
    ``proc``, for processes that are not one multi-process run."""
    global _stream
    os.environ["GS_EVENTS"] = path
    _stream = EventStream(path, proc=proc)
    return _stream


def reset_events() -> None:
    """Drop the singleton (tests; re-resolved from the environment at
    the next use)."""
    global _stream
    _stream = None
