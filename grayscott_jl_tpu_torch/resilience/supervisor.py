"""Run supervision: classify a failure, back off, resume (counterpart of
``grayscott_jl_tpu/resilience/supervisor.py``).

``supervise(settings)`` runs ``driver.run_once`` in a restart loop:

* **classify** the failure (:func:`classify_failure`): ``transient-io``
  (an ``AsyncIOError`` around an OS error, or a bare ``OSError``),
  ``preemption``, ``hang`` (the watchdog's :class:`~.watchdog.HangError`),
  ``health`` (``HealthError``/``DriftError`` under the ``rollback``
  policy), ``kernel``, ``corruption`` (a CRC or device-checksum
  mismatch; the same corrupt step twice gives up) and ``sdc`` (the SDC
  screen's :class:`~.sdc.SDCError`). Anything else re-raises at once.
* **retry** after ``GS_RESTART_BACKOFF_S * 2**attempt`` seconds (default
  base 0.5, cap 30) plus up to 25 % jitter from crc32 of the attempt and
  kind, so that a replayed chaos run sleeps the same schedule, at most
  ``GS_MAX_RESTARTS`` times (the ``max_restarts`` key, default 3).
* **resume** from the latest durable checkpoint any replica holds
  (``integrity.latest_durable_step_replicated``; for ``sdc`` at most the
  screen's last verified step), else from scratch.
* **stop** on a ``kernel`` failure (a kernel that does not build or
  launch, or the injected ``kernel`` fault that stands for one): the
  card runs the hand-written kernels or nothing, so the supervisor
  journals ``gave_up`` and re-raises, and the user (or a relauncher)
  sees the failure and resumes from the durable checkpoint once the
  kernel is repaired. The reference instead degrades Pallas to XLA and
  goes on. A sticky CUDA error (an illegal address, say) leaves the
  process's CUDA context unusable for any later attempt: whatever its
  class, the supervisor journals ``gave_up`` with "device context lost"
  and re-raises, and a relauncher restarts the process.
* **journal** every failure and recovery (:class:`FaultJournal`:
  fsynced JSONL, ``.rank<N>`` files in a run of several processes,
  mirrored onto the event stream); the completing attempt puts the
  journal into ``RunStats`` as its ``faults`` section.

A run of several processes restarts together: each failure is agreed
through ``resilience/rendezvous.agree`` (the attempt is the maximum,
the restart step the minimum durable step) and journaled as
``rendezvous``; in the same round the processes agree on the mesh
(``agree_mesh``: the block total and one ``GS_TPU_MESH_DIMS`` proposal,
pinned in ``GS_TPU_MESH_DIMS`` for the restoring attempt, which then
reshards onto it), journaled as ``mesh_agreement``. A
:class:`~.faults.GracefulShutdown`
is never restarted in the process: the CLI exits 75 and the journal's
``graceful_shutdown`` marker makes the next supervised launch resume
(:func:`resume_marker`); the watchdog's hard exit leaves ``hang_exit``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import threading
import time
import zlib
from typing import List, Optional

from ..config.env import env_float, env_raw
from ..obs import events as obs_events
from .faults import (FaultPlan, GracefulShutdown, InjectedKernelError,
                     PreemptionError)
from .health import HealthError
from .watchdog import HangError

__all__ = [
    "RESUME_MARKERS",
    "FaultJournal",
    "SupervisorContext",
    "classify_failure",
    "context_lost",
    "latest_durable_checkpoint",
    "restart_backoff",
    "resolve_max_restarts",
    "resume_marker",
    "supervise",
    "supervision_enabled",
]

#: Journal events that end a run an outside teardown interrupted (the
#: graceful-shutdown exit, the watchdog's hard exit): the next supervised
#: launch resumes from the durable checkpoint at once.
RESUME_MARKERS = ("graceful_shutdown", "hang_exit")

_TRUTHY = {"1", "true", "yes", "on"}
_FALSY = {"0", "false", "no", "off"}


def supervision_enabled(settings=None) -> bool:
    """``GS_SUPERVISE``, else the ``supervise`` key."""
    raw = env_raw("GS_SUPERVISE")
    if raw is not None:
        val = raw.strip().lower()
        if val in _TRUTHY:
            return True
        if val in _FALSY:
            return False
        raise ValueError(
            f"GS_SUPERVISE must be a boolean (0/1/true/false), got {raw!r}")
    return bool(getattr(settings, "supervise", False))


def resolve_max_restarts(settings=None) -> int:
    """``GS_MAX_RESTARTS``, else the ``max_restarts`` key."""
    raw = env_raw("GS_MAX_RESTARTS")
    if raw is not None:
        try:
            n = int(raw)
        except ValueError as e:
            raise ValueError(
                f"GS_MAX_RESTARTS must be an integer, got {raw!r}") from e
    else:
        n = int(getattr(settings, "max_restarts", 3))
    if n < 0:
        raise ValueError(f"max restarts must be >= 0, got {n}")
    return n


def restart_backoff(attempt: int, kind: str) -> float:
    """``base * 2**attempt`` seconds, capped at 30, plus up to 25 %
    jitter from crc32 of ``attempt:kind`` (no RNG: a replayed run sleeps
    the same schedule)."""
    base = env_float("GS_RESTART_BACKOFF_S", 0.5)
    if base < 0:
        raise ValueError(f"GS_RESTART_BACKOFF_S must be >= 0, got {base}")
    delay = min(base * (2 ** attempt), 30.0)
    frac = (zlib.crc32(f"{attempt}:{kind}".encode()) % 1000) / 1000.0
    return delay * (1.0 + 0.25 * frac)


class FaultJournal:
    """The append-only record of faults and recoveries.

    ``record`` is called from the driver thread, the output pipeline's
    writer thread (a fired ``io_error``) and the watchdog's monitor
    (``hang``), so the append holds a lock; every line is flushed and
    fsynced before ``record`` returns, so that a killed process leaves
    it whole. Each record is mirrored onto the run event stream
    (``obs/events.emit_record``: ``event`` becomes the stream's kind,
    ``kind`` the ``fault`` attribute). ``process_index`` (a run of
    several processes) is stamped on every record as ``proc``."""

    def __init__(self, path: Optional[str] = None,
                 process_index: Optional[int] = None):
        self.path = path
        self.process_index = process_index
        self.events: List[dict] = []
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, settings=None) -> "FaultJournal":
        """The journal at ``GS_FAULT_JOURNAL``; by default
        ``<output>.faults.jsonl`` under supervision, in memory only
        otherwise. In a run of several processes the path takes a
        ``.rank<N>`` suffix and each record the rank."""
        from ..parallel import distributed

        path = env_raw("GS_FAULT_JOURNAL")
        if not path and settings is not None and supervision_enabled(
                settings):
            path = settings.output + ".faults.jsonl"
        proc = None
        if distributed.process_count() > 1:
            proc = distributed.process_index()
            if path:
                path = f"{path}.rank{proc}"
        return cls(path or None, process_index=proc)

    def record(self, **event) -> dict:
        event.setdefault("t", round(time.time(), 3))
        if self.process_index is not None:
            event.setdefault("proc", self.process_index)
        with self._lock:
            self.events.append(event)
            if self.path:
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(event) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
        obs_events.emit_record(event)
        return event


def resume_marker(path: Optional[str]) -> Optional[dict]:
    """The journal's last record when it is a :data:`RESUME_MARKERS`
    event (the previous launch ended in a graceful shutdown or a hard
    hang exit, and nothing resumed it since), else None. Corrupt lines
    (a torn tail) are skipped."""
    if not path or not os.path.exists(path):
        return None
    last = None
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                last = json.loads(line)
            except json.JSONDecodeError:
                continue
    if isinstance(last, dict) and last.get("event") in RESUME_MARKERS:
        return last
    return None


@dataclasses.dataclass
class SupervisorContext:
    """The state the supervisor threads through ``run_once``."""

    plan: FaultPlan
    journal: FaultJournal
    attempt: int = 0
    #: The attempt's live ``RunStats`` (set by the driver): a failed
    #: attempt's phases are journaled as ``attempt_phases``.
    stats: Optional[object] = None


#: Messages of CUDA errors that leave the context unusable ("sticky"):
#: every later call in the process fails the same way.
_STICKY_MARKERS = ("illegal memory access", "illegal address",
                   "illegal instruction", "misaligned address",
                   "unspecified launch failure", "device-side assert",
                   "an illegal", "hardware stack error",
                   "uncorrectable ecc")


def context_lost(exc: BaseException) -> bool:
    """Is ``exc`` a sticky CUDA error, after which no attempt in this
    process can use the card (a kernel launch error with a sticky code,
    or a torch CUDA error naming one)?"""
    from ..ops.cuda_stencil import KernelLaunchError

    if isinstance(exc, KernelLaunchError):
        return exc.sticky
    msg = str(exc).lower()
    return "cuda" in msg and any(m in msg for m in _STICKY_MARKERS)


def classify_failure(exc: BaseException) -> Optional[str]:
    """The failure's recovery class, or None (fatal). Only classes with
    a known recovery are retried; ``AsyncIOError`` is judged by the
    error it wraps."""
    from ..io.async_writer import AsyncIOError
    from ..ops._build import KernelBuildError
    from ..ops.cuda_stencil import KernelLaunchError
    from .integrity import CorruptionError
    from .sdc import SDCError

    if isinstance(exc, SDCError):
        return "sdc"
    if isinstance(exc, PreemptionError):
        # GracefulShutdown too; supervise() re-raises it unrestarted.
        return "preemption"
    if isinstance(exc, HangError):
        return "hang"
    if isinstance(exc, HealthError):
        return "health" if exc.policy == "rollback" else None
    if isinstance(exc, (InjectedKernelError, KernelBuildError,
                        KernelLaunchError)):
        return "kernel"
    if isinstance(exc, CorruptionError):
        return "corruption"
    if isinstance(exc, AsyncIOError):
        if isinstance(exc.original, CorruptionError):
            return "corruption"
        return "transient-io" if exc.transient else None
    if isinstance(exc, OSError):
        return "transient-io"
    return None


def _corruption_signature(exc: BaseException):
    """``(step, var, file)`` of a (possibly wrapped) corruption: the
    supervisor restarts each signature once."""
    from ..io.async_writer import AsyncIOError
    from .integrity import CorruptionError

    e = exc.original if isinstance(exc, AsyncIOError) else exc
    if isinstance(e, CorruptionError):
        return (e.step, e.var, e.file)
    return (getattr(exc, "step", None), None, None)


def latest_durable_checkpoint(settings, max_step: Optional[int] = None
                              ) -> Optional[int]:
    """The latest step a complete checkpoint entry holds in any replica
    of ``checkpoint_output`` (at most ``max_step``), or None. An ensemble
    checkpoints into member-indexed stores (``ensemble/io.py``): its
    resumable step is the QUORUM, the minimum over the active members'
    stores, so that a crash between two members' saves rolls every
    member back to the step all of them hold (None while any lacks
    one)."""
    if not settings.checkpoint:
        return None
    from .integrity import latest_durable_step_replicated

    ens = getattr(settings, "ensemble", None)
    if ens is not None:
        from ..ensemble.io import member_path

        steps = [latest_durable_step_replicated(
            member_path(settings.checkpoint_output, i, ens.n),
            max_step=max_step)
            for i in range(ens.n) if ens.members[i].active]
        return None if any(s is None for s in steps) else min(steps)
    return latest_durable_step_replicated(settings.checkpoint_output,
                                          max_step=max_step)


def _apply_resume(settings, resume: Optional[int], actions: list) -> None:
    """Point ``settings`` at the agreed restart step (or from scratch)."""
    if resume is not None:
        settings.restart = True
        settings.restart_input = settings.checkpoint_output
        settings.restart_step = resume
        actions.append(f"resumed_from_checkpoint_step_{resume}")
    elif not settings.restart:
        actions.append("restarted_from_scratch")
    else:
        actions.append("restarted_from_configured_checkpoint")


def supervise(settings, *, n_devices: Optional[int] = None, seed: int = 0,
              sim_factory=None, reshape_poll=None):
    """``driver.run_once`` under the restart loop; returns the completed
    attempt's simulation. ``settings`` is changed across attempts (the
    restart target), so that it describes how the run finished.
    ``sim_factory`` is passed to every attempt (it places a mesh's
    blocks on chosen devices); the reference's serving use of it, a warm
    engine rebound per attempt, is Queue 1 item 22. ``reshape_poll``
    (the live move's between-rounds hook, ``driver.run_once``) is passed
    to every attempt too."""
    from ..config.env import env_str
    from ..config.settings import resolve_device
    from ..driver import run_once
    from ..obs import metrics as obs_metrics
    from ..parallel import distributed
    from ..utils.log import Logger
    from . import rendezvous as rdv_mod

    log = Logger(verbose=True)
    plan = FaultPlan.from_env(settings)
    journal = FaultJournal.from_env(settings)
    limit = resolve_max_restarts(settings)
    rdv = rdv_mod.from_env(settings)
    kind_of_device = resolve_device(settings).type
    attempt = 0
    corrupt_seen: set = set()
    # A device the screen blamed once; a second time quarantines it.
    sdc_seen: set = set()

    def agree(resume_local: Optional[int]):
        """The restart step (and attempt) agreed by every process; a run
        of one process keeps its own."""
        nonlocal attempt
        if rdv is None:
            return resume_local
        attempt, resume = rdv.agree(attempt, resume_local)
        journal.record(
            event="rendezvous", round=rdv.round, attempt=attempt,
            local_step=-1 if resume_local is None else resume_local,
            quorum_step=-1 if resume is None else resume, procs=rdv.nprocs)
        # The mesh, agreed before the restoring attempt builds its
        # simulation (pinned where an operator pins it); the restore
        # then reshards onto it.
        forced = env_str("GS_TPU_MESH_DIMS", "")
        proposal = (tuple(int(x) for x in forced.split(","))
                    if forced else None)
        local = (n_devices if n_devices is not None else len(
            distributed.process_devices(kind_of_device, None)))
        mesh = rdv.agree_mesh(local, proposal)
        if mesh["dims"] is not None:
            os.environ["GS_TPU_MESH_DIMS"] = ",".join(
                str(d) for d in mesh["dims"])
        journal.record(
            event="mesh_agreement", round=rdv.round, attempt=attempt,
            devices=mesh["devices"], dims=mesh["dims"], procs=mesh["procs"])
        return resume

    marker = resume_marker(journal.path)
    if marker is not None and not settings.restart:
        actions: list = []
        _apply_resume(settings, agree(latest_durable_checkpoint(settings)),
                      actions)
        journal.record(
            event="recovery",
            kind=("preemption" if marker["event"] == "graceful_shutdown"
                  else "hang"),
            attempt=attempt, after=marker["event"],
            action=";".join(actions))
        log.info(f"supervisor: resuming after {marker['event']} with "
                 f"[{', '.join(actions)}]")

    while True:
        ctx = SupervisorContext(plan=plan, journal=journal, attempt=attempt)
        try:
            return run_once(settings, n_devices=n_devices, seed=seed,
                            context=ctx, sim_factory=sim_factory,
                            reshape_poll=reshape_poll)
        except BaseException as exc:  # noqa: BLE001 — classify, then re-raise
            if isinstance(exc, GracefulShutdown):
                raise
            kind = classify_failure(exc)
            error = f"{type(exc).__name__}: {exc}"
            if ctx.stats is not None and ctx.stats.phases:
                journal.record(
                    event="attempt_phases", attempt=attempt,
                    kind=kind or "fatal",
                    phases_s={k: round(v, 6)
                              for k, v in ctx.stats.phases.items()},
                    steps=ctx.stats.counters.get("steps", 0))
            if context_lost(exc):
                journal.record(
                    event="gave_up", kind=kind or "fatal", attempt=attempt,
                    error=error,
                    reason="device context lost — a sticky CUDA error "
                           "leaves no attempt in this process a usable "
                           "card; relaunch the process to resume")
                raise
            if kind is None:
                journal.record(event="gave_up", kind="fatal",
                               attempt=attempt, error=error)
                raise
            if kind == "kernel":
                journal.record(
                    event="gave_up", kind=kind, attempt=attempt,
                    error=error,
                    reason="kernel failure — the card runs the CUDA "
                           "kernels or stops; repair the kernel and "
                           "resume from the durable checkpoint")
                raise
            if kind == "corruption":
                sig = _corruption_signature(exc)
                journal.record(event="corruption", step=sig[0],
                               detail=error)
                if sig in corrupt_seen:
                    journal.record(
                        event="gave_up", kind=kind, attempt=attempt,
                        error=error,
                        reason="repeated corruption of the same step — "
                               "non-transient, refusing to restart-loop")
                    raise
                corrupt_seen.add(sig)

            actions: list = []
            sdc_scratch = False
            if kind == "sdc":
                from .sdc import quarantine_device, usable_devices

                dev = getattr(exc, "device", None)
                if dev is not None and dev in sdc_seen:
                    quarantine_device(
                        dev, journal=journal, step=getattr(exc, "step", None),
                        reason="repeated SDC attribution to this device")
                    actions.append(f"quarantined_{dev}")
                    if not usable_devices(kind_of_device):
                        journal.record(
                            event="gave_up", kind=kind, attempt=attempt,
                            error=error,
                            reason="every device quarantined — no compute "
                                   "inventory left to restart on")
                        raise
                elif dev is not None:
                    sdc_seen.add(dev)
                if getattr(exc, "verified_step", None) is None:
                    # Nothing this attempt wrote was screened.
                    sdc_scratch = True
                    actions.append("no_verified_boundary")

            try:
                if kind == "sdc":
                    resume_local = (None if sdc_scratch else
                                    latest_durable_checkpoint(
                                        settings, max_step=exc.verified_step))
                else:
                    resume_local = latest_durable_checkpoint(settings)
                resume = agree(resume_local)
            except rdv_mod.RendezvousTimeout as e:
                journal.record(event="gave_up", kind=kind, attempt=attempt,
                               error=error,
                               reason=f"restart rendezvous failed: {e}")
                raise

            if attempt >= limit:
                journal.record(event="gave_up", kind=kind, attempt=attempt,
                               error=error)
                raise

            _apply_resume(settings, resume, actions)
            obs_metrics.get_metrics().counter("restarts", kind=kind).inc()
            delay = restart_backoff(attempt, kind)
            journal.record(event="recovery", kind=kind, attempt=attempt,
                           error=error, action=";".join(actions),
                           backoff_s=round(delay, 3))
            log.info(f"supervisor: {kind} failure ({error}); attempt "
                     f"{attempt + 1}/{limit} recovers with "
                     f"[{', '.join(actions)}] after {delay:.2f}s")
        # Out of the handler, the failed attempt's traceback (and with it
        # its simulation, host ring and streams) is gone: collect it
        # before the next attempt allocates its own.
        del ctx
        gc.collect()
        time.sleep(delay)
        attempt += 1
