"""Graceful shutdown (counterpart of the shutdown half of
``grayscott_jl_tpu/resilience/faults.py``).

A scheduler that preempts a run sends SIGTERM (an operator, SIGINT).
With ``graceful_shutdown`` on (the default; ``GS_GRACEFUL_SHUTDOWN``
wins over the key), the :class:`ShutdownListener` turns the first such
signal into a request that the driver checks at the next boundary: it
writes a checkpoint there (when checkpointing is on and the boundary did
not write one), closes the stores and raises :class:`GracefulShutdown`,
which the CLI turns into exit code :data:`EXIT_PREEMPTED` — "resume me"
to a relauncher, which restarts from that checkpoint bitwise. A second
signal raises ``KeyboardInterrupt`` at once.

Fault plans (``GS_FAULTS``) and the hang watchdog are not ported yet
(ROADMAP Queue 1 item 17); the settings refuse them.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional

from ..config.env import env_raw

__all__ = [
    "EXIT_PREEMPTED",
    "GracefulShutdown",
    "PreemptionError",
    "ShutdownListener",
    "resolve_graceful_shutdown",
]

#: The process exit code of a graceful shutdown: a checkpoint was
#: written, resume the run (sysexits' "temporary failure").
EXIT_PREEMPTED = 75


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
    never turns the request into a crash."""

    def __init__(self, *, enabled: bool = True, on_request=None):
        self.enabled = enabled
        self.signum: Optional[int] = None
        self._on_request = on_request
        self._prev: dict = {}

    @property
    def requested(self) -> bool:
        return self.signum is not None

    def _handle(self, signum, frame) -> None:
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
