"""Fault plans and graceful shutdown (counterpart of
``grayscott_jl_tpu/resilience/faults.py``).

A fault plan (``GS_FAULTS``, else the ``faults`` key) names which fault
fires at which step, e.g.
``GS_FAULTS="step=120:kind=io_error;step=300:kind=nan"``. The driver
takes each fault at the first boundary at or after its step, once per
plan; the supervisor (``resilience/supervisor.py``) holds one plan
across its attempts, so a fault that fired never fires again and a
chaos run is deterministic. The kinds (:data:`FAULT_KINDS`), as in the
reference: ``io_error`` (:class:`InjectedIOError` inside the write
target of the due step, surfacing as a transient ``AsyncIOError``),
``nan`` (``Simulation.poison_nan``), ``preempt``
(:class:`PreemptionError` before the boundary's writes), ``kernel``
(:class:`InjectedKernelError` before the round, armed while the run is
on the CUDA kernel; the supervisor stops on it, as on a real kernel
failure), ``hang`` (:func:`injected_hang_wait`, a stall the hang
watchdog turns into ``HangError``), ``bitflip`` (one bit of the
boundary snapshot's copy), ``ckpt_corrupt`` (one payload byte of the
latest durable checkpoint), ``drift`` (``Simulation.poison_drift``) and
``sdc`` (``Simulation.poison_sdc``: one mantissa bit of a live cell
before the round, for the SDC screen to catch).

In an ensemble run ``GS_FAULT_MEMBER`` (default 0) picks the member
that ``nan``, ``bitflip``, ``sdc`` and ``ckpt_corrupt`` hit
(``ensemble/engine.EnsembleSimulation.poison_nan``, its bitflip and sdc
sites, and the member's checkpoint store), so that the health report,
the checksum and the screen must name that member while the others stay
clean; a solo run ignores it, as the reference's does.

A scheduler that preempts a run sends SIGTERM (an operator, SIGINT).
With ``graceful_shutdown`` on (the default; ``GS_GRACEFUL_SHUTDOWN``
wins over the key), the :class:`ShutdownListener` turns the first such
signal into a request that the driver checks at the next boundary: it
writes a checkpoint there (when checkpointing is on and the boundary did
not write one), closes the stores and raises :class:`GracefulShutdown`,
which the CLI turns into exit code :data:`EXIT_PREEMPTED` — "resume me"
to a relauncher, which restarts from that checkpoint bitwise. A second
signal raises ``KeyboardInterrupt`` at once. The hang watchdog's hard
exit is :data:`EXIT_HANG` (76).
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import List, Optional

from ..config.env import env_float, env_raw

__all__ = [
    "EXIT_HANG",
    "EXIT_PREEMPTED",
    "FAULT_KINDS",
    "Fault",
    "FaultPlan",
    "GracefulShutdown",
    "InjectedIOError",
    "InjectedKernelError",
    "PreemptionError",
    "ShutdownListener",
    "injected_hang_wait",
    "resolve_graceful_shutdown",
]

FAULT_KINDS = (
    "io_error", "nan", "preempt", "kernel", "hang", "bitflip",
    "ckpt_corrupt", "drift", "sdc",
)

#: The process exit code of a graceful shutdown: a checkpoint was
#: written, resume the run (sysexits' "temporary failure").
EXIT_PREEMPTED = 75
#: The hang watchdog's hard exit: the stacks and a ``hang_exit`` marker
#: are in the journal; resume from the last durable checkpoint.
EXIT_HANG = 76


class InjectedIOError(OSError):
    """A planned transient I/O failure (raised inside a write target)."""


class PreemptionError(RuntimeError):
    """The run received SIGTERM/SIGINT and stopped at a boundary."""


class GracefulShutdown(PreemptionError):
    """The run shut itself down after a shutdown request, its
    checkpoint (if any) written and its stores closed."""

    def __init__(self, signum: int, step: int,
                 checkpoint_step: Optional[int] = None):
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        ck = (f"checkpoint durable at step {checkpoint_step}"
              if checkpoint_step is not None
              else "no checkpoint store configured")
        super().__init__(f"graceful shutdown on {name} at step {step} ({ck})")
        self.signum = signum
        self.step = step
        self.checkpoint_step = checkpoint_step


def resolve_graceful_shutdown(settings=None) -> bool:
    """``GS_GRACEFUL_SHUTDOWN``, else the ``graceful_shutdown`` key,
    default on; a value that is not a boolean raises."""
    raw = env_raw("GS_GRACEFUL_SHUTDOWN")
    if raw is not None:
        val = raw.strip().lower()
        if val in ("1", "true", "yes", "on"):
            return True
        if val in ("0", "false", "no", "off"):
            return False
        raise ValueError(
            f"GS_GRACEFUL_SHUTDOWN must be a boolean, got {raw!r}")
    return bool(getattr(settings, "graceful_shutdown", True))


class ShutdownListener:
    """SIGTERM/SIGINT -> a request checked at the next boundary.

    The first signal only records itself (:attr:`signum`); a second
    raises ``KeyboardInterrupt``. ``install``/``uninstall`` save and
    restore the previous handlers; installing is skipped when disabled
    and off the main thread (Python allows handlers there only).

    ``on_request(signum)``, when given, is called once, when the first
    signal lands (the driver emits ``shutdown_requested`` on the event
    stream there); its exceptions are swallowed, so a monitoring hook
    never turns the request into a crash.

    ``watchdog``: once the hang watchdog has expired, its interrupt of
    the main thread arrives through this handler; it is raised as
    ``KeyboardInterrupt`` rather than taken for a graceful request that
    the stalled driver would never check."""

    def __init__(self, *, enabled: bool = True, watchdog=None,
                 on_request=None):
        self.enabled = enabled
        self.signum: Optional[int] = None
        self._watchdog = watchdog
        self._on_request = on_request
        self._prev: dict = {}

    @property
    def requested(self) -> bool:
        return self.signum is not None

    def _handle(self, signum, frame) -> None:
        if self._watchdog is not None and self._watchdog.expired:
            raise KeyboardInterrupt(
                "watchdog interrupt (run hung past its deadline)")
        if self.signum is None:
            self.signum = signum
            if self._on_request is not None:
                try:
                    self._on_request(signum)
                except Exception:  # noqa: BLE001 — monitoring hook
                    pass
        else:
            raise KeyboardInterrupt(
                f"second signal {signum} during graceful shutdown")

    def install(self) -> "ShutdownListener":
        if (not self.enabled
                or threading.current_thread() is not threading.main_thread()):
            return self
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}

    def __enter__(self) -> "ShutdownListener":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


def injected_hang_wait(shutdown=None,
                       bound_s: Optional[float] = None) -> None:
    """The ``hang`` fault: stall the driver thread in 50 ms sleeps until
    a shutdown request arrives or ``bound_s`` passes (``GS_HANG_BOUND_S``,
    default 30 s), after which an unwatched run goes on: a fault changes
    when the run computes, never what. Under the hang watchdog the
    monitor's interrupt lands between two sleeps and unwinds the stall
    as ``KeyboardInterrupt``, which ``driver.run_once`` turns into
    ``HangError``: the path a real Python-level stall takes."""
    if bound_s is None:
        bound_s = env_float("GS_HANG_BOUND_S", 30.0)
    t0 = time.monotonic()
    while time.monotonic() - t0 < bound_s:
        time.sleep(0.05)
        if shutdown is not None and shutdown.requested:
            return


class InjectedKernelError(RuntimeError):
    """A planned CUDA kernel failure; the supervisor classifies it as
    ``kernel`` by its type."""

    def __init__(self, step: int):
        super().__init__(
            f"injected CUDA kernel launch failure at step {step}")
        self.step = step


@dataclasses.dataclass
class Fault:
    """One planned fault: fires at the first boundary >= ``step``."""

    step: int
    kind: str
    fired: bool = False

    def describe(self) -> dict:
        return {"step": self.step, "kind": self.kind, "fired": self.fired}


class FaultPlan:
    """An ordered set of planned faults, each taken once.

    ``take`` runs on the driver thread, and for ``io_error`` on the
    output pipeline's writer thread; each kind is polled from one
    thread only, and the fired flag is one attribute write."""

    def __init__(self, faults: Optional[List[Fault]] = None):
        self.faults = sorted(faults or [], key=lambda f: (f.step, f.kind))

    def __bool__(self) -> bool:
        return bool(self.faults)

    def __len__(self) -> int:
        return len(self.faults)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """``step=N:kind=K[;step=N:kind=K...]`` as a plan. An unknown
        kind or field, a missing field or a malformed entry raises
        ``ValueError`` naming the entry: a mistyped plan fails at
        start-up, it never injects nothing in silence."""
        faults = []
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            fields = {}
            for part in entry.split(":"):
                if "=" not in part:
                    raise ValueError(
                        f"GS_FAULTS entry {entry!r}: field {part!r} is not "
                        "key=value")
                k, v = part.split("=", 1)
                fields[k.strip()] = v.strip()
            unknown = set(fields) - {"step", "kind"}
            if unknown:
                raise ValueError(
                    f"GS_FAULTS entry {entry!r}: unknown field(s) "
                    f"{sorted(unknown)}")
            if "step" not in fields or "kind" not in fields:
                raise ValueError(
                    f"GS_FAULTS entry {entry!r} needs both step= and kind=")
            try:
                step = int(fields["step"])
            except ValueError as e:
                raise ValueError(
                    f"GS_FAULTS entry {entry!r}: step must be an integer"
                ) from e
            if step < 0:
                raise ValueError(
                    f"GS_FAULTS entry {entry!r}: step must be >= 0")
            kind = fields["kind"]
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"GS_FAULTS entry {entry!r}: unknown kind {kind!r} "
                    f"(supported: {', '.join(FAULT_KINDS)})")
            faults.append(Fault(step=step, kind=kind))
        return cls(faults)

    @classmethod
    def from_env(cls, settings=None) -> "FaultPlan":
        """The plan of ``GS_FAULTS``, else of the ``faults`` key (empty
        when neither is set)."""
        spec = env_raw("GS_FAULTS")
        if spec is None and settings is not None:
            spec = getattr(settings, "faults", "")
        return cls.parse(spec or "")

    def take(self, kind: str, step: int) -> Optional[Fault]:
        """The earliest unfired fault of ``kind`` due at or before
        ``step``, marked fired; else None."""
        for f in self.faults:
            if f.kind == kind and not f.fired and f.step <= step:
                f.fired = True
                return f
        return None

    def pending(self, kind: Optional[str] = None) -> List[Fault]:
        return [f for f in self.faults
                if not f.fired and (kind is None or f.kind == kind)]

    def describe(self) -> List[dict]:
        return [f.describe() for f in self.faults]
