"""The bounded asynchronous output pipeline (counterpart of
``grayscott_jl_tpu/io/async_writer.py``).

At each ``plotgap``/``checkpoint_freq`` boundary the driver takes a
:class:`~..simulation.FieldSnapshot` (its device-to-host copies already
in flight on a copy stream) and *submits* it here with its write
targets (``SimStream.write_step``, ``CheckpointWriter.save``); one
background thread resolves the snapshot and runs the targets while the
driver enqueues the next chunk of steps.

Guarantees, as in the reference:

* **strict step ordering**: one worker over a FIFO queue, so steps reach
  the stores in submission order;
* **bounded buffering with backpressure**: at most ``GS_ASYNC_IO_DEPTH``
  submitted-but-unwritten steps (default 2); a full pipeline blocks
  ``submit``. :meth:`AsyncStepWriter.reserve` also blocks a new snapshot
  while ``depth + 1`` steps are unwritten, so a ring of ``depth + 1``
  host buffers is never overwritten while a write reads it;
* **synchronous fallback**: ``GS_ASYNC_IO_DEPTH=0`` runs every target
  inline on the driver thread; the stores are byte-identical either way;
* **first-error capture**: a target's exception is kept with its step
  and raised on the driver thread as :class:`AsyncIOError` at the next
  ``submit`` or at ``close``; steps queued after it are discarded;
* **draining close**: ``close()`` returns once every accepted step is
  written (or the first error is raised).

Overlap accounting: the worker keeps busy seconds per phase
(``device_to_host``, ``output``, ``checkpoint``) and the driver side how
long it was blocked on the pipeline (backpressure, reservations, the
final drain); :meth:`AsyncStepWriter.overlap_stats` splits each phase's
busy time into ``hidden_s`` (behind compute) and ``exposed_s`` (the
driver waited), pro rata. The worker never synchronises the device: it
waits on each snapshot's own copy event.

Observability (``obs/``): with a metrics registry the pipeline keeps an
``async_io_queue_depth`` gauge and an ``io_steps_written`` counter, and
with ``stats`` carrying a span tracer the worker's phases (the copy
wait and each target) are spans on the worker thread's own track.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from typing import Optional, Sequence, Tuple

__all__ = ["AsyncIOError", "AsyncStepWriter", "resolve_depth", "with_io_fault"]


class AsyncIOError(RuntimeError):
    """A background write failed; re-raised on the driver thread."""

    def __init__(self, step: int, original: BaseException):
        super().__init__(
            f"async I/O writer failed at step {step}: "
            f"{type(original).__name__}: {original}"
        )
        #: Simulation step whose write raised.
        self.step = step
        #: The exception raised by the write target.
        self.original = original

    @property
    def transient(self) -> bool:
        """Is the wrapped failure an OS-level I/O error (full or flaky
        disk), the kind a supervisor may retry? A value, key or runtime
        error from a write target, a :class:`~..io.bplite.CorruptionError`
        included, is not."""
        return isinstance(self.original, OSError)


def with_io_fault(plan, journal, fn):
    """Write target ``fn`` with the fault plan's ``io_error`` armed: when
    one is due at the step being written, it is journaled as
    ``injected`` and :class:`~..resilience.faults.InjectedIOError` (an
    ``OSError``) raises inside the target, so that it reaches the driver
    as a transient :class:`AsyncIOError`, the path of a real disk error.
    Runs on the writer thread."""
    from ..resilience.faults import InjectedIOError

    def wrapped(step, blocks):
        fault = plan.take("io_error", step)
        if fault is not None:
            journal.record(event="injected", kind="io_error", step=step,
                           planned_step=fault.step)
            raise InjectedIOError(
                f"injected transient I/O error at step {step} "
                f"(planned step {fault.step})")
        return fn(step, blocks)

    return wrapped


def resolve_depth(depth: Optional[int] = None) -> int:
    """Pipeline depth: the argument, else ``GS_ASYNC_IO_DEPTH``
    (default 2). ``0`` means synchronous; negatives are invalid."""
    if depth is None:
        raw = os.environ.get("GS_ASYNC_IO_DEPTH", "2")
        try:
            depth = int(raw)
        except ValueError as e:
            raise ValueError(
                f"GS_ASYNC_IO_DEPTH must be a non-negative integer, "
                f"got {raw!r}"
            ) from e
    if depth < 0:
        raise ValueError(
            f"async I/O depth must be non-negative, got {depth}"
        )
    return depth


_SENTINEL = object()

#: Phase name for snapshot-to-host resolution time in the busy ledger.
_D2H = "device_to_host"


class AsyncStepWriter:
    """Bounded-queue background writer for simulation output steps.

    ``submit(step, snapshot, targets)`` hands one output boundary to the
    pipeline; ``targets`` is a sequence of ``(phase_name, fn)`` where
    ``fn(step, blocks)`` performs the write (phase names feed the
    overlap accounting and, in synchronous mode, the driver's
    ``RunStats`` phases, so depth 0 reproduces the synchronous flow).

    ``stats`` is an optional :class:`~..utils.profiler.RunStats`; when
    given, driver-side time is recorded under the target phase names
    (inline write time when synchronous, submit and backpressure time
    when asynchronous) and the drain under ``io_drain``, and its tracer
    (if any) gets the worker's phases as spans.

    ``metrics`` is an optional :class:`~..obs.metrics.MetricsRegistry`
    (the ``async_io_queue_depth`` gauge and the ``io_steps_written``
    counter; a disabled registry hands out the no-op instrument).

    ``progress`` is an optional ``progress(step)`` callback the worker
    calls after each step it has written: the hang watchdog's ``drain``
    heartbeat (``resilience/watchdog.Watchdog.touch``), so that only a
    stuck write trips the drain deadline. Its exceptions are swallowed.
    """

    def __init__(self, *, depth: Optional[int] = None, stats=None,
                 metrics=None, progress=None):
        self._progress = progress
        if metrics is None:
            from ..obs.metrics import NULL_METRIC

            self._m_depth = self._m_written = NULL_METRIC
        else:
            self._m_depth = metrics.gauge("async_io_queue_depth")
            self._m_written = metrics.counter("io_steps_written")
        tracer = getattr(stats, "tracer", None)
        self._tracer = (tracer if tracer is not None and tracer.enabled
                        else None)
        self.depth = resolve_depth(depth)
        self._stats = stats
        self._busy: dict = {}
        self._busy_lock = threading.Lock()
        self._submit_wait = 0.0
        self._drain_wait = 0.0
        self._queue_hwm = 0
        self._accepted = 0
        self._written = 0
        self._error: Optional[Tuple[int, BaseException]] = None
        self._raised = False
        self._thread: Optional[threading.Thread] = None
        self._q: Optional[queue.Queue] = None
        if self.depth > 0:
            self._q = queue.Queue(maxsize=self.depth)
            self._thread = threading.Thread(
                target=self._run, name="gs-async-io", daemon=True
            )
            self._thread.start()

    # ---------------------------------------------------------- properties

    @property
    def synchronous(self) -> bool:
        return self.depth == 0

    @property
    def steps_written(self) -> int:
        """Steps fully written so far (monotone; == accepted after a
        clean ``close``)."""
        return self._written

    # ------------------------------------------------------------- worker

    def _add_busy(self, phase: str, seconds: float) -> None:
        with self._busy_lock:
            self._busy[phase] = self._busy.get(phase, 0.0) + seconds

    def _span(self, phase: str, step: int):
        """A span of the worker's ``phase`` on its own trace track."""
        if self._tracer is None:
            return contextlib.nullcontext()
        return self._tracer.span(phase, phase=phase, step=step)

    def _write_one(self, step, snapshot, targets) -> None:
        t = time.perf_counter()
        with self._span(_D2H, step):
            blocks = snapshot.blocks()
        self._add_busy(_D2H, time.perf_counter() - t)
        for phase, fn in targets:
            t = time.perf_counter()
            with self._span(phase, step):
                fn(step, blocks)
            self._add_busy(phase, time.perf_counter() - t)
        self._written += 1
        self._m_written.inc()
        self._m_depth.set(self._q.qsize() if self._q is not None else 0)
        if self._progress is not None:
            try:
                self._progress(step)
            except Exception:  # noqa: BLE001 — monitoring must not kill writes
                pass

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            step, snapshot, targets = item
            # After a failure later steps are consumed but DISCARDED —
            # continuing to write would put steps after a hole — while
            # draining the queue keeps a backpressure-blocked submit
            # from deadlocking against a dead pipeline.
            if self._error is None:
                try:
                    self._write_one(step, snapshot, targets)
                except BaseException as e:  # noqa: BLE001 — must not die
                    self._error = (step, e)

    # ------------------------------------------------------------- driver

    def _raise_pending(self) -> None:
        if self._error is not None and not self._raised:
            self._raised = True
            step, exc = self._error
            raise AsyncIOError(step, exc) from exc

    def _phase_cm(self, name: str):
        if self._stats is None:
            return contextlib.nullcontext()
        return self._stats.phase(name)

    def submit(
        self, step: int, snapshot, targets: Sequence[Tuple[str, object]]
    ) -> None:
        """Hand one output step to the pipeline.

        Synchronous mode writes inline (under each target's stats
        phase). Async mode enqueues, blocking while the pipeline is at
        depth; a previously captured writer error re-raises here before
        anything new is accepted.
        """
        self._raise_pending()
        if self._raised:
            step0 = self._error[0] if self._error else "?"
            raise RuntimeError(
                f"async I/O writer already failed at step {step0}; "
                "no further steps are accepted"
            )
        targets = list(targets)
        if self.synchronous:
            blocks = snapshot.blocks()
            for phase, fn in targets:
                t = time.perf_counter()
                with self._phase_cm(phase):
                    fn(step, blocks)
                self._add_busy(phase, time.perf_counter() - t)
            self._written += 1
            self._m_written.inc()
            self._accepted += 1
            return
        with contextlib.ExitStack() as st:
            # Submit time (≈0 unless backpressured) lands in the same
            # stats phases the writes used to occupy, so phase output
            # keeps meaning "driver wall time spent on output".
            for phase, _ in targets:
                st.enter_context(self._phase_cm(phase))
            t = time.perf_counter()
            self._q.put((step, snapshot, targets))
            self._submit_wait += time.perf_counter() - t
        self._accepted += 1
        self._queue_hwm = max(self._queue_hwm, self._q.qsize())
        self._m_depth.set(self._q.qsize())

    def reserve(self, phases: Sequence[str] = ()) -> None:
        """Block while ``depth + 1`` accepted steps are unwritten (or
        until a writer error), so that the snapshot about to be taken
        may reuse the host buffer of the oldest written one: a ring of
        ``depth + 1`` buffers then never changes under a write. The wait
        is driver time blocked on the pipeline, recorded like
        ``submit``'s under the boundary's target ``phases``. Synchronous
        mode never waits (every step is written inside ``submit``)."""
        if self._thread is None:
            return
        with contextlib.ExitStack() as st:
            for phase in phases:
                st.enter_context(self._phase_cm(phase))
            t = time.perf_counter()
            while (self._error is None
                   and self._accepted - self._written > self.depth):
                time.sleep(0.0005)
            self._submit_wait += time.perf_counter() - t

    def drain(self) -> None:
        """Block until every accepted step is written (or the first
        failure has surfaced), without stopping the worker."""
        if self._thread is not None:
            with self._phase_cm("io_drain"):
                t = time.perf_counter()
                while (self._error is None
                       and self._written < self._accepted):
                    time.sleep(0.002)
                self._drain_wait += time.perf_counter() - t
        self._raise_pending()

    def close(self) -> None:
        """Drain and stop the worker; re-raise a pending writer error.

        Returns only once every accepted step is durably written (or
        the first failure has been surfaced). Idempotent."""
        if self._thread is not None:
            with self._phase_cm("io_drain"):
                t = time.perf_counter()
                self._q.put(_SENTINEL)
                self._thread.join()
                self._drain_wait += time.perf_counter() - t
            self._thread = None
        self._raise_pending()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
            return
        # Abort path: still drain (the worker must not outlive the
        # driver and a blocked peer must unwedge), but never let a
        # secondary writer error mask the in-flight exception.
        try:
            self.close()
        except AsyncIOError:
            pass

    # -------------------------------------------------------------- stats

    def overlap_stats(self) -> dict:
        """JSON-able overlap accounting for ``RunStats``.

        ``busy_s`` is worker (or inline) write time per phase;
        ``exposed_s`` splits the driver-blocked time (backpressure +
        drain; everything, in synchronous mode) across phases pro-rata
        by busy time, and ``hidden_s`` is the remainder — I/O that ran
        behind compute."""
        with self._busy_lock:
            busy = dict(self._busy)
        total_busy = sum(busy.values())
        if self.synchronous:
            exposed_total = total_busy
        else:
            exposed_total = min(
                self._submit_wait + self._drain_wait, total_busy
            )
        frac = exposed_total / total_busy if total_busy > 0 else 0.0
        exposed = {k: v * frac for k, v in busy.items()}
        hidden = {k: v - exposed[k] for k, v in busy.items()}
        rounded = lambda d: {k: round(v, 6) for k, v in d.items()}  # noqa: E731
        return {
            "depth": self.depth,
            "steps_accepted": self._accepted,
            "steps_written": self._written,
            "queue_depth_hwm": self._queue_hwm,
            "busy_s": rounded(busy),
            "hidden_s": rounded(hidden),
            "exposed_s": rounded(exposed),
            "submit_wait_s": round(self._submit_wait, 6),
            "drain_wait_s": round(self._drain_wait, 6),
        }
