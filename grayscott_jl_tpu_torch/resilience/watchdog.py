"""Hang watchdog: per-phase deadlines over the driver's heartbeat
(counterpart of ``grayscott_jl_tpu/resilience/watchdog.py``).

A wedged run never raises, so the supervisor has nothing to classify.
The watchdog gives it something:

* the driver (``driver.run_once``) heartbeats at its phase edges —
  ``compile`` (the simulation's construction and first round, the first
  use of a kernel's ``nvcc`` build included), ``step_round`` (one
  boundary-to-boundary round), ``io`` (the boundary's snapshot and
  submission), ``drain`` (the output pipeline's close), ``checkpoint``
  (the graceful-shutdown checkpoint), ``collective`` (the restart
  rendezvous) — and each heartbeat arms that phase's deadline; each is
  also the span tracer's phase edge (``obs/trace.py``);
* a monitor thread checks the armed deadline. On expiry it records
  every thread's stack in the fault journal (fsynced), interrupts the
  main thread so that a Python-level stall unwinds (as
  :class:`HangError`, which the supervisor restarts from the last
  checkpoint), and, if the run is still there ``GS_WATCHDOG_GRACE_S``
  later, journals ``hang_exit`` and leaves with ``os._exit``
  (:data:`~.faults.EXIT_HANG`, 76); the next supervised launch resumes
  from that marker.

On the card the hard exit is the real recovery: ``interrupt_main`` acts
between bytecodes only, so a main thread blocked in
``torch.cuda.synchronize()``, an event's ``synchronize()`` or an NCCL
``wait()`` never sees it.

Knobs (the environment wins over the ``watchdog`` /
``watchdog_deadline_s`` keys): ``GS_WATCHDOG`` = ``on`` | ``off`` |
``auto`` (armed exactly when supervision is), ``GS_WATCHDOG_DEADLINE_S``
(one deadline for every phase), ``GS_WATCHDOG_<PHASE>_S`` (one phase,
e.g. ``GS_WATCHDOG_STEP_ROUND_S``), ``GS_WATCHDOG_GRACE_S`` (seconds
from the interrupt to the hard exit, default 60; 0: no hard exit).
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Dict, Optional

from ..config.env import env_raw
from .faults import EXIT_HANG

__all__ = [
    "DEFAULT_DEADLINES",
    "HangError",
    "Watchdog",
    "resolve_grace_s",
    "resolve_watchdog",
]

#: Per-phase deadlines (seconds), the reference's: generous, to tell
#: "wedged" from "slow". ``reshape`` arms the driver's live move
#: between rounds (a target simulation plus the move); ``probe_loop`` is
#: the reference's bench probe loop, kept so that the same
#: ``GS_WATCHDOG_<PHASE>_S`` variables resolve.
DEFAULT_DEADLINES: Dict[str, float] = {
    "compile": 1800.0,
    "step_round": 600.0,
    "io": 300.0,
    "drain": 600.0,
    "checkpoint": 600.0,
    "collective": 300.0,
    "probe_loop": 360.0,
    "reshape": 1800.0,
}


class HangError(RuntimeError):
    """The watchdog expired: the run hung past a phase's deadline. The
    supervisor classifies it as ``hang`` and restarts from the last
    checkpoint."""

    def __init__(self, phase: str, step: Optional[int], deadline_s: float):
        at = f" at step {step}" if step is not None else ""
        super().__init__(
            f"watchdog: run hung in phase {phase!r}{at} "
            f"(no heartbeat for {deadline_s:.1f}s)")
        self.phase = phase
        self.step = step
        self.deadline_s = deadline_s


def _env_float(name: str) -> Optional[float]:
    raw = env_raw(name)
    if raw is None or raw.strip() == "":
        return None
    try:
        v = float(raw)
    except ValueError as e:
        raise ValueError(f"{name} must be a number, got {raw!r}") from e
    if v <= 0:
        raise ValueError(f"{name} must be > 0, got {v}")
    return v


def resolve_watchdog(settings=None) -> Optional[Dict[str, float]]:
    """The per-phase deadlines, or None when the watchdog is off.
    ``auto`` (the default) arms it exactly when supervision is armed;
    the deadlines are :data:`DEFAULT_DEADLINES`, all replaced by
    ``GS_WATCHDOG_DEADLINE_S`` (else a positive ``watchdog_deadline_s``
    key), then each by its ``GS_WATCHDOG_<PHASE>_S``."""
    raw = env_raw("GS_WATCHDOG")
    if raw is None:
        raw = getattr(settings, "watchdog", "") or "auto"
    mode = raw.strip().lower()
    mode = {"1": "on", "true": "on", "yes": "on",
            "0": "off", "false": "off", "no": "off", "": "auto"}.get(
                mode, mode)
    if mode not in ("on", "off", "auto"):
        raise ValueError(
            f"watchdog / GS_WATCHDOG must be on/off/auto, got {raw!r}")
    if mode == "off":
        return None
    if mode == "auto":
        from .supervisor import supervision_enabled

        if not supervision_enabled(settings):
            return None
    deadlines = dict(DEFAULT_DEADLINES)
    base = _env_float("GS_WATCHDOG_DEADLINE_S")
    if base is None and settings is not None:
        toml_base = float(getattr(settings, "watchdog_deadline_s", 0.0))
        if toml_base > 0:
            base = toml_base
    if base is not None:
        deadlines = {k: base for k in deadlines}
    for phase in deadlines:
        v = _env_float(f"GS_WATCHDOG_{phase.upper()}_S")
        if v is not None:
            deadlines[phase] = v
    return deadlines


def resolve_grace_s() -> float:
    """``GS_WATCHDOG_GRACE_S``: seconds from the interrupt to the hard
    exit (default 60; 0 disables the hard exit)."""
    raw = env_raw("GS_WATCHDOG_GRACE_S")
    if raw is None or raw.strip() == "":
        return 60.0
    try:
        grace = float(raw)
    except ValueError as e:
        raise ValueError(
            f"GS_WATCHDOG_GRACE_S must be a number, got {raw!r}") from e
    if grace < 0:
        raise ValueError(f"GS_WATCHDOG_GRACE_S must be >= 0, got {grace}")
    return grace


def _dump_stacks(skip_ident: Optional[int] = None, limit: int = 12) -> list:
    """Every live thread's stack tail, JSON-able."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        if ident == skip_ident:
            continue
        stack = [s.strip() for s in traceback.format_stack(frame)[-limit:]]
        out.append({"thread": names.get(ident, f"tid-{ident}"),
                    "stack": stack})
    return out


class Watchdog:
    """Deadline monitor over the driver's heartbeats.

    One phase is armed at a time (:meth:`heartbeat`). The monitor fires
    at most once; after expiry the event is frozen, so that the journal
    tells one story. Every method is thread-safe."""

    def __init__(self, deadlines: Optional[Dict[str, float]] = None, *,
                 journal=None, grace_s: Optional[float] = None,
                 on_expire=None, tracer=None):
        self.deadlines = dict(deadlines or DEFAULT_DEADLINES)
        if not self.deadlines:
            raise ValueError("watchdog needs at least one phase deadline")
        for phase, d in self.deadlines.items():
            if d <= 0:
                raise ValueError(
                    f"watchdog deadline for {phase!r} must be > 0, got {d}")
        self.journal = journal
        #: The span tracer fed one edge per heartbeat (None: the
        #: process-wide one, resolved at the first heartbeat).
        self._tracer = tracer
        self.grace_s = float(resolve_grace_s() if grace_s is None
                             else grace_s)
        #: Called from the monitor thread on expiry; by default it
        #: interrupts the main thread.
        self._on_expire = (on_expire if on_expire is not None
                           else self._interrupt_main)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._armed = None  # (phase, step, deadline_s, armed_at)
        self._expired: Optional[dict] = None
        self._heartbeats = 0
        self._thread: Optional[threading.Thread] = None
        # Often enough for the tightest deadline, never above 50 Hz.
        self._tick = min(0.5, max(0.02, min(self.deadlines.values()) / 5.0))

    @staticmethod
    def _interrupt_main() -> None:
        import _thread

        _thread.interrupt_main()

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run,
                                            name="gs-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Disarm and join the monitor: after ``stop`` no interrupt or
        hard exit can fire. Idempotent."""
        with self._lock:
            self._stop.set()
            self._armed = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def heartbeat(self, phase: str, step: Optional[int] = None) -> None:
        """Arm ``phase``'s deadline from now, replacing the armed phase;
        a phase without a deadline gets the tightest one. One heartbeat
        is one span edge in the trace."""
        tr = self._tracer
        if tr is None:
            from ..obs.trace import get_tracer

            tr = self._tracer = get_tracer()
        tr.edge(phase, step)
        deadline = self.deadlines.get(phase)
        if deadline is None:
            deadline = min(self.deadlines.values())
        with self._lock:
            if self._stop.is_set() or self._expired is not None:
                return
            self._heartbeats += 1
            self._armed = (phase, step, deadline, time.monotonic())

    def touch(self, phase: str, step: Optional[int] = None) -> None:
        """Re-arm only if ``phase`` is the armed phase: how the output
        pipeline's writer thread reports progress during ``drain``
        without masking a wedged driver."""
        with self._lock:
            if (self._armed is None or self._stop.is_set()
                    or self._expired is not None):
                return
            if self._armed[0] == phase:
                self._heartbeats += 1
                self._armed = (phase, step, self._armed[2], time.monotonic())

    def disarm(self) -> None:
        with self._lock:
            self._armed = None

    @property
    def expired(self) -> Optional[dict]:
        """The frozen expiry event, or None while healthy."""
        return self._expired

    def check(self) -> None:
        """Raise :class:`HangError` if the watchdog has expired."""
        e = self._expired
        if e is not None:
            raise HangError(e["phase"], e.get("step"), e["deadline_s"])

    def describe(self) -> dict:
        """JSON-able provenance for ``RunStats``."""
        e = self._expired
        return {
            "enabled": True,
            "deadlines_s": dict(self.deadlines),
            "grace_s": self.grace_s,
            "heartbeats": self._heartbeats,
            "expired": ({"phase": e["phase"], "step": e.get("step"),
                         "deadline_s": e["deadline_s"]}
                        if e is not None else None),
        }

    def _run(self) -> None:
        while not self._stop.wait(self._tick):
            with self._lock:
                if self._armed is None or self._expired is not None:
                    continue
                phase, step, deadline, t0 = self._armed
                if time.monotonic() - t0 < deadline:
                    continue
                event = {
                    "event": "hang", "kind": "hang", "phase": phase,
                    "step": step, "deadline_s": deadline,
                    "threads": _dump_stacks(skip_ident=threading.get_ident()),
                }
                self._expired = event
                self._armed = None
            # The journal and the interrupt outside the lock: record()
            # takes its own lock and fsyncs.
            if self._tracer is not None:
                self._tracer.instant("watchdog_expired", step=step,
                                     phase=phase, deadline_s=deadline)
            if self.journal is not None:
                try:
                    self.journal.record(**event)
                except Exception:  # noqa: BLE001 — diagnosis must not kill teardown
                    pass
            try:
                self._on_expire()
            except Exception:  # noqa: BLE001
                pass
            if self.grace_s > 0:
                # A wedge in C (a device wait, a collective) never sees
                # the interrupt: leave with the hang exit code and a
                # journal marker the next launch resumes from.
                if self._stop.wait(self.grace_s):
                    return
                if self.journal is not None:
                    try:
                        self.journal.record(
                            event="hang_exit", kind="hang", phase=phase,
                            step=step, exit_code=EXIT_HANG)
                    except Exception:  # noqa: BLE001
                        pass
                os._exit(EXIT_HANG)
            return
