"""Host-side span tracer with Chrome trace-event export (counterpart of
``grayscott_jl_tpu/obs/trace.py``).

``GS_TRACE=path`` arms the process-wide tracer. The driver's phase
boundaries become spans (:meth:`SpanTracer.edge`, one per boundary, on
the "driver phases" track), and every ``RunStats.phase`` context
(``utils/profiler.py``) and the output writer's phases on its own
thread (``io/async_writer.py``) become nested spans on their thread's
track. The export is the Chrome trace-event JSON format (the
``traceEvents`` array of ``"X"`` complete events), loadable in
Perfetto or ``chrome://tracing``; :func:`validate_trace` checks a
document against the contract the tests hold it to.

* **stdlib only**, like the reference: the process index and count come
  from ``parallel/distributed.py`` (0 and 1 before and without a
  multi-process group), which replaces the reference's JAX probes.
* **crash-consistent**: :meth:`SpanTracer.flush` rewrites the whole file
  atomically (tmp + rename), so the file on disk is valid JSON after
  every run, including one that failed.
* **bounded**: at most ``GS_TRACE_MAX_EVENTS`` (default 200000) events
  are kept; later spans are counted as dropped.
* **balanced**: spans nest LIFO per thread and an edge span is closed
  before the next opens, so the exported intervals nest.

The device-side capture of a step range is :class:`ProfileWindow`
(``GS_PROFILE=start:stop``, ``GS_PROFILE_DIR``), over ``torch.profiler``:
the spans say which round was slow, the capture which kernel. The
capture of the whole run (``GS_TPU_PROFILE``) is
``utils/profiler.trace``; both export through :func:`profiler_capture`.

**One clock.** The file's ``ts`` are microseconds since its
``baseTimeNanoseconds``, the rule of ``torch.profiler``'s own Chrome
export, and that base is Unix-epoch nanoseconds (``time.time_ns``), the
clock the profiler's events carry, so a span lands at the same instant
in both files. Durations and the offsets from the base are read on
:data:`clock_ns`, a monotonic clock, so that a step of the wall clock
cannot break a span's nesting or a counter.

**The hot path** (the driver's round, ``ops/cuda_stencil.fused_step``,
the sharded round's exchange) is instrumented only while
:func:`hot_armed`: ``GS_TRACE`` is set or a ``torch.profiler`` capture
is live (``GS_PROFILE``, ``GS_TPU_PROFILE``, a benchmark's capture).
Off, it costs one such check a launch and reads no clock. On, each
:class:`HotRange` is a profiler range in the live capture (a launch's
only on one call in ``cuda_stencil.LAUNCH_RANGE_EVERY``: a range costs
the host microseconds under a capture of the card) and its nanoseconds
on :data:`clock_ns`, which the caller adds to its counters
(``cuda_stencil.timings``). The ranges, innermost last: ``gs_phase
<phase>`` (a driver phase edge to the next), ``gs_round step=<n>`` (a
driver round with its sync), ``gs_sync`` (the round's wait
for the device), ``gs_exchange`` (a sharded round's halo exchange),
``gs_launch`` (an outermost ``fused_step`` call) and ``gs_launch_call``
(the call into the kernel library's entry point).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import List, Optional

__all__ = [
    "NULL_TRACER",
    "HotRange",
    "ProfileWindow",
    "SpanTracer",
    "clock_ns",
    "get_tracer",
    "hot_armed",
    "rank_path",
    "reset_tracer",
    "validate_trace",
]

#: tid of the driver-phase edge track; real threads are numbered from 1
#: in the order they first record a span.
EDGE_TID = 0

#: The clock of every span's offset and duration and of the hot path's
#: counters: monotonic nanoseconds. A tracer pins it to Unix-epoch
#: nanoseconds, ``torch.profiler``'s clock, once, at its base.
clock_ns = time.perf_counter_ns


def _proc_index() -> int:
    """This process's index in a multi-process run, 0 otherwise."""
    from ..parallel import distributed

    return distributed.process_index()


def rank_path(path: str) -> str:
    """``path.rank<N>`` in a run of several processes (as ``GS_TPU_STATS``
    is), so that the processes do not write one file; ``path`` itself
    otherwise."""
    from ..parallel import distributed

    if distributed.process_count() > 1:
        return f"{path}.rank{distributed.process_index()}"
    return path


class _NullTracer:
    """Shared no-op tracer: ``GS_TRACE`` unset costs one attribute check
    and a no-op call per boundary."""

    enabled = False
    _cm = contextlib.nullcontext()

    def span(self, name, phase=None, step=None, **attrs):
        """Yields None: there are no args to add to."""
        return self._cm

    def edge(self, phase, step=None) -> None:
        pass

    def instant(self, name, step=None, **attrs) -> None:
        pass

    def flush(self) -> Optional[str]:
        return None

    def describe(self) -> dict:
        return {"enabled": False}


NULL_TRACER = _NullTracer()


class SpanTracer:
    """Nestable host-side spans -> Chrome trace-event JSON.

    Timestamps are microseconds on :data:`clock_ns` since the tracer's
    creation, whose Unix-epoch nanoseconds the file gives as
    ``baseTimeNanoseconds`` (and ``otherData.epoch_unix_s``, for
    correlation with the event stream).
    Thread-safe: spans come from the driver thread and the output
    writer's thread.
    """

    enabled = True

    def __init__(self, path: str, proc: Optional[int] = None,
                 max_events: Optional[int] = None):
        self.path = path
        self.proc = _proc_index() if proc is None else proc
        if max_events is None:
            max_events = int(os.environ.get("GS_TRACE_MAX_EVENTS",
                                            "200000"))
        if max_events <= 0:
            raise ValueError(
                f"GS_TRACE_MAX_EVENTS must be > 0, got {max_events}"
            )
        self.max_events = max_events
        self.dropped = 0
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._base_ns = time.time_ns()
        self._t0 = clock_ns()
        #: The open edge span: (phase, step, t_us).
        self._edge = None
        self._tids = {}  # thread ident -> small tid
        self._meta = [{
            "ph": "M", "name": "process_name", "pid": self.proc,
            "tid": EDGE_TID,
            "args": {"name": f"gray-scott proc {self.proc}"},
        }, {
            "ph": "M", "name": "thread_name", "pid": self.proc,
            "tid": EDGE_TID, "args": {"name": "driver phases"},
        }]

    def _now_us(self) -> float:
        return (clock_ns() - self._t0) / 1e3

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids) + 1
                self._meta.append({
                    "ph": "M", "name": "thread_name", "pid": self.proc,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name},
                })
        return tid

    def _add(self, event: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(event)

    def _complete(self, name, t0_us, dur_us, *, tid, phase=None,
                  step=None, attrs=None) -> None:
        args = {}
        if step is not None:
            args["step"] = step
        if attrs:
            args.update(attrs)
        self._add({
            "name": str(name),
            "cat": str(phase) if phase else "span",
            "ph": "X",
            "ts": round(t0_us, 3),
            "dur": round(max(dur_us, 0.0), 3),
            "pid": self.proc,
            "tid": tid,
            "args": args,
        })

    @contextlib.contextmanager
    def span(self, name, phase=None, step=None, **attrs):
        """A timing span around a host-side block, on this thread's
        track (LIFO per thread, so the intervals nest). Yields the span's
        args, which the block may add to before it closes."""
        t0 = self._now_us()
        try:
            yield attrs
        finally:
            self._complete(name, t0, self._now_us() - t0,
                           tid=self._tid(), phase=phase, step=step,
                           attrs=attrs)

    def edge(self, phase, step=None) -> None:
        """One driver phase boundary: close the open phase span and open
        the next."""
        now = self._now_us()
        with self._lock:
            prev, self._edge = self._edge, (str(phase), step, now)
        if prev is not None:
            self._complete(prev[0], prev[2], now - prev[2],
                           tid=EDGE_TID, phase=prev[0], step=prev[1])

    def instant(self, name, step=None, **attrs) -> None:
        """A zero-duration marker."""
        args = dict(attrs)
        if step is not None:
            args["step"] = step
        self._add({
            "name": str(name), "cat": "event", "ph": "i", "s": "p",
            "ts": round(self._now_us(), 3), "pid": self.proc,
            "tid": self._tid(), "args": args,
        })

    def describe(self) -> dict:
        with self._lock:
            n = len(self._events)
        return {"enabled": True, "path": self.path, "events": n,
                "dropped": self.dropped}

    def flush(self) -> Optional[str]:
        """Rewrite the whole trace file atomically. The open edge span
        is exported as running until now without being closed, so a
        flush mid-run keeps the file's nesting balanced and the edge
        open."""
        now = self._now_us()
        with self._lock:
            events = list(self._meta) + list(self._events)
            edge = self._edge
        if edge is not None:
            args = {} if edge[1] is None else {"step": edge[1]}
            events.append({
                "name": edge[0], "cat": edge[0], "ph": "X",
                "ts": round(edge[2], 3),
                "dur": round(max(now - edge[2], 0.0), 3),
                "pid": self.proc, "tid": EDGE_TID, "args": args,
            })
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "baseTimeNanoseconds": self._base_ns,
            "otherData": {
                "epoch_unix_s": round(self._base_ns / 1e9, 6),
                "proc": self.proc,
                "dropped_events": self.dropped,
            },
        }
        tmp = f"{self.path}.tmp{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
            f.write("\n")
        os.replace(tmp, self.path)
        return self.path


_tracer = None


def get_tracer():
    """The process-wide tracer: a :class:`SpanTracer` when ``GS_TRACE``
    names a path (``.rank<N>``-suffixed in a run of several processes),
    else the shared no-op. Resolved once, at the first call: the driver
    makes it after the process group has started."""
    global _tracer
    if _tracer is None:
        path = os.environ.get("GS_TRACE", "").strip()
        _tracer = SpanTracer(rank_path(path)) if path else NULL_TRACER
    return _tracer


def reset_tracer() -> None:
    """Drop the singleton (tests; re-resolved from the environment at
    the next use)."""
    global _tracer
    _tracer = None


# ---------------------------------------------------------- the hot path

#: ``torch.autograd._profiler_enabled`` and the profiler's range type,
#: bound at the first :func:`hot_armed` (this module imports no torch).
_profiler_enabled = None
_range = None


def _bind_profiler() -> None:
    global _profiler_enabled, _range
    import torch

    _range = getattr(torch._C._profiler, "_RecordFunctionFast",
                     torch.profiler.record_function)
    _profiler_enabled = torch.autograd._profiler_enabled


def hot_armed() -> bool:
    """Whether the hot path's instrumentation is on: ``GS_TRACE`` names
    a file or a ``torch.profiler`` capture is live. The one check the
    hot path makes when it is off."""
    if _profiler_enabled is None:
        _bind_profiler()
    return get_tracer().enabled or _profiler_enabled()


class HotRange:
    """One range of the hot path, opened only while :func:`hot_armed`:
    a ``torch.profiler`` range in a live capture (nothing without one,
    or with ``record`` false) and :attr:`ns`, its nanoseconds on
    :data:`clock_ns`, inside it."""

    __slots__ = ("ns", "_rf", "_t0")

    def __init__(self, name: str, record: bool = True):
        self._rf = _range(name) if record else None
        self.ns = 0

    def __enter__(self) -> "HotRange":
        if self._rf is not None:
            self._rf.__enter__()
        self._t0 = clock_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.ns = clock_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)


def validate_trace(doc) -> List[str]:
    """Problems with a Chrome trace-event document (empty list = valid):
    a ``traceEvents`` array whose ``"X"`` events each carry numeric
    ``pid``/``tid``/``ts``/``dur`` and a name, and whose spans nest
    without partial overlap on each ``(pid, tid)`` track."""
    problems: List[str] = []
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            return ["no traceEvents array"]
    elif isinstance(doc, list):
        events = doc
    else:
        return ["document is neither an object nor an array"]

    spans = {}
    for i, e in enumerate(events):
        if not isinstance(e, dict) or "ph" not in e:
            problems.append(f"event {i}: not an object with a ph field")
            continue
        if e["ph"] != "X":
            continue
        bad = [k for k in ("pid", "tid", "ts", "dur")
               if not isinstance(e.get(k), (int, float))
               or isinstance(e.get(k), bool)]
        if not isinstance(e.get("name"), str) or not e.get("name"):
            bad.append("name")
        if bad:
            problems.append(
                f"event {i} ({e.get('name')!r}): missing/invalid "
                f"{', '.join(sorted(bad))}"
            )
            continue
        if e["dur"] < 0:
            problems.append(f"event {i} ({e['name']!r}): negative dur")
            continue
        spans.setdefault((e["pid"], e["tid"]), []).append(e)

    eps = 1e-3  # exported timestamps are rounded to 1e-3 us
    for track, evs in spans.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[dict] = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] \
                    <= e["ts"] + eps:
                stack.pop()
            if stack:
                parent_end = stack[-1]["ts"] + stack[-1]["dur"]
                if e["ts"] + e["dur"] > parent_end + eps:
                    problems.append(
                        f"track {track}: span {e['name']!r} "
                        f"[{e['ts']}, {e['ts'] + e['dur']}] partially "
                        f"overlaps {stack[-1]['name']!r} ending at "
                        f"{parent_end} (nesting unbalanced)"
                    )
                    continue
            stack.append(e)
    return problems


# ------------------------------------------------------- profiler windows


class ProfilerCapture:
    """One ``torch.profiler`` capture, exported as a Chrome trace to
    ``path`` when it stops: CPU activity, and the card's (kernels,
    copies) when ``cuda``."""

    def __init__(self, path: str, cuda: bool):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.path = path
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()

    def stop(self) -> str:
        """Stop the capture and write its trace; returns the path."""
        self._prof.stop()
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        return self.path


def profiler_capture(path: str, cuda: bool) -> ProfilerCapture:
    """Start a capture that exports to ``path`` (``.rank<N>`` in a run of
    several processes)."""
    return ProfilerCapture(rank_path(path), cuda)


class ProfileWindow:
    """``torch.profiler`` capture bracketing a simulation-step range
    (the reference's ``jax.profiler`` window).

    ``GS_PROFILE=start:stop`` (simulation steps) opens the capture at
    the first driver boundary with ``step >= start`` and closes it at
    the first with ``step >= stop``; its Chrome trace lands in
    ``GS_PROFILE_DIR`` (default ``gs_profile``) as
    ``profile_<start>_<stop>.json`` (``.rank<N>`` in a run of several
    processes), with each round inside the window a ``gs_round`` range
    naming its first step (the driver's, :class:`HotRange`: the live
    capture arms it). It collects the card's activity with the
    host's when ``cuda`` (the driver sets it for a run on the card).
    Profiler failures warn and close the window: a profiling misconfig
    never stops a run."""

    def __init__(self, start: int, stop: int, out_dir: str):
        if start < 0 or stop <= start:
            raise ValueError(
                f"profile window needs 0 <= start < stop, got "
                f"{start}:{stop}"
            )
        self.start = start
        self.stop = stop
        self.out_dir = out_dir
        self.active = False
        self.cuda = False
        #: The trace written when the window closed, or None.
        self.path: Optional[str] = None
        self._capture = None
        self._done = False

    @classmethod
    def from_env(cls) -> Optional["ProfileWindow"]:
        spec = os.environ.get("GS_PROFILE", "").strip()
        if not spec:
            return None
        parts = spec.split(":")
        if len(parts) != 2:
            raise ValueError(
                f"GS_PROFILE must be start:stop (steps), got {spec!r}"
            )
        try:
            start, stop = int(parts[0]), int(parts[1])
        except ValueError as e:
            raise ValueError(
                f"GS_PROFILE must be start:stop integers, got {spec!r}"
            ) from e
        return cls(start, stop,
                   os.environ.get("GS_PROFILE_DIR", "gs_profile"))

    def _fail(self, what: str, exc: Exception) -> None:
        print(f"gray-scott-torch: warning: torch.profiler {what} failed "
              f"({exc}); profile window disabled", file=sys.stderr)
        self.active = False
        self._capture = None
        self._done = True

    def _close(self) -> None:
        try:
            self.path = self._capture.stop()
        except Exception as e:  # noqa: BLE001 — never stop the run
            self._fail("stop", e)
            return
        self.active = False
        self._capture = None
        self._done = True

    def on_boundary(self, step: int) -> None:
        """Called at every driver boundary with the current step."""
        if self._done:
            return
        if self.active and step >= self.stop:
            self._close()
        elif not self.active and self.start <= step < self.stop:
            try:
                self._capture = profiler_capture(
                    os.path.join(self.out_dir,
                                 f"profile_{self.start}_{self.stop}.json"),
                    self.cuda)
            except Exception as e:  # noqa: BLE001
                self._fail("start", e)
                return
            self.active = True

    def finish(self) -> None:
        """Close a still-open capture (the run ended inside the
        window)."""
        if self.active:
            self._close()
