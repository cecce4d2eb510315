"""Simulation driver: the reference's ``GrayScott.main`` step loop
(counterpart of ``grayscott_jl_tpu/driver.py``).

:func:`main` dispatches: with supervision armed (``GS_SUPERVISE`` /
``supervise``) it runs ``resilience/supervisor.supervise``, the restart
loop, else one :func:`run_once`. :func:`run_once` is one attempt: the
hang watchdog (``resilience/watchdog.py``) and the shutdown listener
bracket it, a watchdog interrupt leaves it as ``HangError``, and the
trace is flushed after it, failed or not.

Flow: settings -> simulation (restored from ``restart_input`` when
``restart = true``, through replica failover) -> output stream and
checkpoint store -> advance to each ``plotgap`` / ``checkpoint_freq``
boundary -> snapshot -> hand the output step and/or the checkpoint to
the output pipeline -> drain -> close. The steps between two boundaries
are enqueued on the device as one chunk; the host waits for the device
only at the boundary.

Output overlaps compute, as in the reference: each boundary takes a
:class:`~.simulation.FieldSnapshot` (its copies in flight on a copy
stream, into a ring of pinned host buffers) and submits it to the
bounded background writer (``io/async_writer.py``), so the stores are
written while the next chunk computes. ``GS_ASYNC_IO_DEPTH`` bounds the
steps in flight (default 2; 0 writes inline, the synchronous flow); the
stores are byte-identical at every depth. The pipeline keeps step
order, raises a writer's error on this thread as ``AsyncIOError``
naming the step, and is drained before the stores close, on every exit.

With the lossy snapshot codec (``snapshot_bits``), a boundary quantizes
the coded fields on the device and captures exact copies only when a
target needs them: the output store takes the codec form, checkpoints
stay exact unless ``snapshot_bits_ckpt`` codes them too.

A sharded run writes one block per mesh position into each store step,
each with its global ``(start, count)`` box; the store serves the same
assembled arrays as a single-block run's. A fresh checkpoint store
records the run's layout (``Simulation.layout()``), and a restart goes
through ``reshard/restore.restore_run``: the recorded layout is planned
against the run's (mesh dims and process count; ``reshard = "off"``
refuses a change, a store without a record restores anywhere), then each
process reads its new blocks' boxes, with a ``reshard`` record when the
layout changed.

Elastic resharding between rounds (``reshard/``, as in the reference):
``run_once(reshape_poll=...)`` polls at every round; a request
(``{"mesh_dims": [x, y, z]}``, or ``{"scale": "grow"|"shrink"}``, which
doubles or halves the block count over the usable devices) moves the
live fields onto the new mesh (``reshard/restore.reshape_live``; tier
``GS_RESHARD_DEVICE``) under the watchdog's ``reshape`` phase, after the
pipeline has drained; the stores reopen in append mode at the current
step on the new layout, so the steps written before the move stay, and
the run goes on. A request that cannot be met is a warning, not a
failure. A run of several processes agrees on the request (one
collective per round while a poll is given), so every process moves at
the same round. When a device the run computes on is quarantined
(``GS_DEVICE_BLOCKLIST``), the run moves to the largest feasible mesh
on the usable devices, or warns and stays where it is.

At every boundary the snapshot carries the health probe (unless
``health_policy = "off"``), resolved on this thread before the step is
submitted: ``abort`` raises ``HealthError``, so a blown-up step never
reaches a store; ``warn`` logs and writes. Data integrity
(``resilience/integrity.py``): ``GS_CKPT_VERIFY=full`` adds the device
checksum to every snapshot with exact copies (checked against the
landed bytes before any write, and recorded in the stores' integrity
sidecars) and reads every checkpoint back; ``GS_CKPT_REPLICAS`` mirrors
the checkpoints; ``GS_SCRUB`` audits them at checkpoint boundaries.
A SIGTERM or SIGINT is a shutdown request, checked after each chunk and
after each boundary's submission: the run submits a checkpoint at that
boundary (when checkpoints are on and the boundary wrote none), drains
the pipeline, closes its stores and raises ``GracefulShutdown``, which
the CLI turns into exit code 75.

A run of several processes (``GS_TPU_COORDINATOR`` with
``GS_TPU_NUM_PROCESSES`` and ``GS_TPU_PROCESS_ID``, or
``GS_TPU_DISTRIBUTED=auto`` under torchrun; ``launch.py`` starts one on
a host) is one simulation: the group starts before the simulation is
built (``parallel/distributed.py``), each process steps its share of the
mesh's blocks and writes them as writer ``process_index`` of
``process_count`` to the same stores (the readers merge the writers'
blocks; ``mesh_type = "image"`` writes ``.vti`` pieces and a ``.pvti``
index per step), a restart reads each process's own boxes from the
merged checkpoint, and the health report and the shutdown request are
agreed across the processes, so that all stop at the same boundary.

Observability (``obs/``), as in the reference and each a no-op unless
its variable is set: the span tracer (``GS_TRACE``; the phase edges
compile / step_round / io / checkpoint / drain, ``RunStats`` phases and
the writer's phases as spans, flushed after every run), the event
stream (``GS_EVENTS``: run_start, output, checkpoint, run_complete or
run_error, shutdown_requested, health, graceful_shutdown, the integrity
records, numerics and drift), the metrics registry (``GS_METRICS``:
``step_latency_us``, ``step_rounds``, ``steps``, the writer's queue
depth and steps written, ``io_hidden_s``/``io_exposed_s``, the field
ranges, the numerics gauges and the cards' memory, flushed every
``metrics_interval_s`` at a boundary and at the end;
``GS_METRICS_PROM`` writes the Prometheus dump), and the numerics
probes (``GS_NUMERICS``): ``boundary`` takes them in each boundary's
snapshot, ``every_round`` after every round too. Under a raising drift
policy (``GS_DRIFT_POLICY=abort``) a boundary's probe is judged before
its step is submitted, so a drifted step reaches no store; otherwise
after. The stores are bitwise the same with every sink on or off.

Resilience (``resilience/``), as in the reference: every phase edge is
a watchdog heartbeat (and the tracer's edge); the fault plan
(``GS_FAULTS``) is taken at each boundary in the reference's order —
``kernel`` and ``sdc`` before the round, then after it the SDC screen
(``GS_SDC_CHECK``: replay the round and compare checksums, before any
poison and any write), the ``nan``, ``drift``, ``preempt`` and ``hang``
faults, the screen's new anchor, and on the write path ``io_error``,
``bitflip`` and ``ckpt_corrupt``. Each fault is journaled as
``injected`` in the fault journal, which also takes the health trips,
the drift trips under a raising policy, the integrity records and the
``graceful_shutdown`` marker, and mirrors each onto the event stream.

The fabric model (``parallel/icimodel.py``) projects the run's exchange:
``RunStats.comm`` holds its budget from start-up, refreshed after a live
move, and the gauges ``comm_hidden_us_per_step``,
``comm_exposed_us_per_step``, ``comm_exchanges_per_step`` and
``comm_halo_bytes_per_step`` carry it; ``model_projected_step_us`` and
``model_vs_measured_residual_us`` (the observed ``step_latency_us`` p50
less the projection) are set whenever the metrics flush.

Ensembles (``ensemble/``), as in the reference: with an ``[ensemble]``
table the run is an :class:`~.ensemble.engine.EnsembleSimulation` (every
member of a block advanced by one kernel launch per round), the stores
are member-indexed (``ensemble/io.py``: ``gs.m00.bp`` ... each
byte-identical to a solo run of that member), a restart resumes from the
member stores' quorum step and may grow or shrink the member set
(``restore_ensemble``), the health report names a diverging member, the
``RunStats`` ``ensemble`` section carries the members, seeds and latest
per-member health, and ``cell_updates_per_s`` is the aggregate over the
active members. ``snapshot_bits`` is ignored with a warning (member
stores stay exact), as in the reference.

Build and launch analytics (``obs/xstats.py``; ``GS_XSTATS`` /
``xstats``, or any compile cache directory): each library the run builds
or loads (recorded at construction) and, at the end, each kernel entry
it launched, with the card's attributes and the launch's cost, land in
``sim.executables``, one ``executable`` event each, the ``compiles`` and
``compile_cache_*`` counters and the ``RunStats`` ``executables``
section (with the exchange census and the model's residual). Profiler
captures: ``GS_PROFILE=start:stop`` opens a ``torch.profiler`` window at
the first boundary at or past ``start`` and closes it at the first at or
past ``stop`` (``obs/trace.ProfileWindow``; the Chrome trace in
``GS_PROFILE_DIR``), ``GS_TPU_PROFILE=<dir>`` captures the whole step
loop (``utils/profiler.trace``). Neither changes a launch or a store.
While ``GS_TRACE`` is set or a capture is live (``obs/trace.hot_armed``,
checked once a round), each round is a ``gs_round step=<n>`` range with
its wait for the device a ``gs_sync`` range inside, the launches'
``gs_launch`` ranges between (``ops/cuda_stencil.py``), and the
``compute`` span's args carry the round's ``launches``,
``dispatch_us``, ``call_us``, ``ops_us``, ``sync_us`` and
``exchange_us``. Each phase edge is then a ``gs_phase <phase>`` range
too, until the next edge: the driver's own
set-up before the first round (``compile``) and its wind-down after the
last (``drain``) are named in a capture as in the trace file.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import List, Optional

import numpy as np

from .config.env import env_str
from .config.settings import (Settings, get_settings, load_backend_and_lang,
                              resolve_autotune, resolve_reshard)
from .io.checkpoint import CheckpointWriter
from .io.async_writer import AsyncStepWriter, resolve_depth, with_io_fault
from .io.stream import SimStream
from .ops import cuda_stencil
from .obs import events as obs_events
from .obs import metrics as obs_metrics
from .obs import numerics as obs_numerics
from .obs import xstats
from .obs.trace import HotRange, ProfileWindow, get_tracer, hot_armed
from .parallel import distributed, icimodel
from .reshard.plan import ReshardError
from .reshard.restore import reshape_live, restore_run
from .resilience import integrity
from .resilience import sdc as sdc_mod
from .resilience.faults import (FaultPlan, GracefulShutdown,
                                InjectedKernelError, PreemptionError,
                                ShutdownListener, injected_hang_wait,
                                resolve_graceful_shutdown)
from .resilience.health import DriftGate, HealthError, HealthGuard
from .resilience.supervisor import FaultJournal, supervise, supervision_enabled
from .resilience.watchdog import Watchdog, resolve_watchdog
from .simulation import HostRing, Simulation
from .utils.log import Logger
from .utils.profiler import RunStats, trace


def _next_boundary(step: int, period: int, limit: int) -> int:
    """Next multiple of ``period`` after ``step``, capped at ``limit``."""
    if period <= 0:
        return limit
    return min(limit, (step // period + 1) * period)


class _PhaseRanges:
    """The driver's phase edges as ``gs_phase <phase>`` ranges, each
    open from its edge to the next while the hot path is armed."""

    def __init__(self):
        self._open = None

    def edge(self, phase) -> None:
        self.close()
        if hot_armed():
            self._open = HotRange(f"gs_phase {phase}").__enter__()

    def close(self) -> None:
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None


def _timed_round(sim, steps: int, step: int, args) -> None:
    """One round from ``step`` under the hot path's instrumentation:
    ``gs_round step=<step>`` around the launches and the ``gs_sync``
    wait, the wait added to ``cuda_stencil.SYNC_NS``, and the round's
    counters into ``args`` (the ``compute`` span's, or None)."""
    before = cuda_stencil.timings()
    with HotRange(f"gs_round step={step}"):
        sim.iterate(steps)
        with HotRange("gs_sync") as sync:
            sim.block_until_ready()
    cuda_stencil.add_host_ns(sync=sync.ns)
    if args is not None:
        after = cuda_stencil.timings()
        args["launches"] = after["launches"] - before["launches"]
        for key in ("dispatch", "call", "ops", "sync", "exchange"):
            args[f"{key}_us"] = round(
                (after[f"{key}_ns"] - before[f"{key}_ns"]) / 1e3, 3)


def _resolve_reshape_dims(req, sim):
    """A live-reshape request -> the target mesh dims, or None for an
    infeasible or no-op one. ``{"mesh_dims": [x, y, z]}`` pins the
    target, placed over the run's own devices (blocks share a device
    where there are fewer, as a mesh on one card does);
    ``{"scale": "grow"|"shrink"}`` doubles or halves the block count,
    factored as ``dims_create`` does, and is refused, as in the
    reference, when the usable devices cannot hold one block each."""
    from .parallel.domain import CartDomain, dims_create

    if not isinstance(req, dict):
        return None
    if req.get("mesh_dims"):
        dims = tuple(int(d) for d in req["mesh_dims"])
    else:
        scale = req.get("scale")
        if scale == "grow":
            n = sim.domain.n_blocks * 2
        elif scale == "shrink":
            n = sim.domain.n_blocks // 2
        else:
            return None
        if n < 1 or n > len(sdc_mod.usable_devices(sim.device.type)):
            return None
        dims = dims_create(n, 3)
    try:
        CartDomain.create(math.prod(dims), sim.settings.L, dims=dims)
    except ValueError:
        return None
    if dims == tuple(sim.domain.dims):
        return None
    return dims


def _agreed_dims(dims):
    """The move every process makes this round: the target some process
    asked for, or None when none did or two asked for different ones
    (one collective in a run of several processes)."""
    if distributed.process_count() == 1:
        return dims
    asked = {tuple(int(x) for x in v) for v in distributed.all_gather_f64(
        np.array(dims or (0, 0, 0), dtype=np.float64))}
    asked.discard((0, 0, 0))
    return asked.pop() if len(asked) == 1 else None


def main(args: List[str], *, n_devices: Optional[int] = None,
         seed: int = 0):
    """Run a full simulation from CLI args, through the supervisor when
    supervision is armed. ``GS_SEED`` overrides the noise seed (default
    0). In a run of several processes ``n_devices`` is this process's
    number of blocks (``launch.py`` passes its ``devices_per_proc``)."""
    settings = get_settings(list(args))
    env_seed = env_str("GS_SEED", "").strip()
    if env_seed:
        seed = int(env_seed)
    # The group starts before the supervisor, whose restart rendezvous
    # uses its store.
    distributed.ensure_started(load_backend_and_lang(settings)[0])
    if supervision_enabled(settings):
        return supervise(settings, n_devices=n_devices, seed=seed)
    return run_once(settings, n_devices=n_devices, seed=seed)


def _with_checksums(fn, checksums):
    """A write target with the boundary's device checksums bound to its
    ``checksums`` argument."""

    def wrapped(step, blocks):
        return fn(step, blocks, checksums=checksums)

    return wrapped


def _close_quietly(store) -> None:
    """Close on the failure path without masking the error in flight."""
    if store is None:
        return
    try:
        store.close()
    except Exception:  # noqa: BLE001 — the original error wins
        pass


def run_once(settings: Settings, *, n_devices: Optional[int] = None,
             seed: int = 0, context=None, sim_factory=None,
             reshape_poll=None) -> Simulation:
    """One simulation attempt; returns the finished :class:`Simulation`.

    ``context`` is the supervisor's
    :class:`~.resilience.supervisor.SupervisorContext` (the fault plan
    and journal shared by the attempts); a run without one reads its
    plan and journal from the environment.
    ``sim_factory``, when given, builds the simulation instead of the
    constructor, called as ``sim_factory(settings, n_devices=...,
    seed=...)`` (e.g. to place a mesh's blocks on chosen devices).
    ``reshape_poll``, when given, is called at every round; a truthy
    request moves the live run onto another mesh (module docstring). In
    a run of several processes every process must be given one.
    Raises ``HealthError`` at a poisoned boundary under the ``abort``
    (and ``rollback``) policy, ``DriftError`` at a drifted probe under
    a raising drift policy, ``GracefulShutdown`` after a shutdown
    request, ``HangError`` when the watchdog expires, ``SDCError`` when
    the screen disagrees, and ``AsyncIOError`` (or, at depth 0, the
    error itself) when a write fails."""
    if context is not None:
        plan, journal = context.plan, context.journal
    else:
        plan = FaultPlan.from_env(settings)
        journal = FaultJournal.from_env(settings)
    guard = HealthGuard.from_env(settings)
    # Bad values raise at start-up; the restore and the moves read it.
    resolve_reshard(settings)
    depth = resolve_depth()
    icfg = integrity.resolve_config(settings)
    num_mode = obs_numerics.resolve_numerics(settings)
    scfg = sdc_mod.resolve_sdc(settings)
    deadlines = resolve_watchdog(settings)
    # The group starts before the simulation is built (the reference's
    # maybe_initialize_distributed before its Simulation), and the
    # sinks after it, so that their paths carry this process's rank.
    distributed.ensure_started(load_backend_and_lang(settings)[0])
    tracer = get_tracer()
    evs = obs_events.get_events()
    obs_metrics.get_metrics(settings)
    # The watchdog and the listener bracket the whole attempt,
    # construction included: the compile deadline is armed while the
    # kernels build, and a signal during set-up still leaves through
    # the first boundary.
    wd = (Watchdog(deadlines, journal=journal).start()
          if deadlines else None)
    shutdown = ShutdownListener(
        enabled=resolve_graceful_shutdown(settings), watchdog=wd,
        on_request=lambda signum: evs.emit("shutdown_requested",
                                           signum=signum)).install()
    phases = _PhaseRanges()
    try:
        return _run(settings, guard, shutdown, depth, icfg, num_mode, scfg,
                    plan=plan, journal=journal, wd=wd, context=context,
                    n_devices=n_devices, seed=seed, sim_factory=sim_factory,
                    reshape_poll=reshape_poll, phases=phases)
    except BaseException as exc:
        # The watchdog's interrupt unwinds as KeyboardInterrupt (through
        # the listener's handler): it is the classified hang it stands
        # for.
        if (wd is not None and wd.expired is not None
                and isinstance(exc, KeyboardInterrupt)):
            wd.check()
        raise
    finally:
        phases.close()
        shutdown.uninstall()
        if wd is not None:
            wd.stop()
        # The trace file is valid JSON after every attempt, failed or
        # not.
        try:
            tracer.flush()
        except OSError as e:
            print(f"gray-scott-torch: warning: could not write trace ({e})",
                  file=sys.stderr)


def _run(settings, guard, shutdown, depth, icfg, num_mode, scfg, *,
         plan, journal, wd, context, n_devices, seed, sim_factory,
         reshape_poll, phases) -> Simulation:
    tracer = get_tracer()
    evs = obs_events.get_events()
    metrics = obs_metrics.get_metrics(settings)
    attempt = context.attempt if context is not None else 0
    # Bad values raise before anything is built.
    profile = ProfileWindow.from_env()

    def mark(phase, at=None):
        """One phase edge: the watchdog's heartbeat (which is the
        tracer's edge too), else the edge alone; and its range."""
        if wd is not None:
            wd.heartbeat(phase, at)
        else:
            tracer.edge(phase, at)
        phases.edge(phase)

    mark("compile")
    ens = getattr(settings, "ensemble", None)
    if sim_factory is not None:
        sim = sim_factory(settings, n_devices=n_devices, seed=seed)
    elif ens is not None:
        # One launch per block and round advances every member; the
        # stores are member-indexed.
        from .ensemble.engine import EnsembleSimulation

        sim = EnsembleSimulation(settings, n_devices=n_devices, seed=seed)
    else:
        sim = Simulation(settings, n_devices=n_devices, seed=seed)
    log = Logger(verbose=settings.verbose)
    ilog = integrity.IntegrityLog(log, journal=journal)
    proc, nprocs = distributed.process_index(), distributed.process_count()
    on_card = sim.device.type == "cuda"
    if profile is not None:
        profile.cuda = on_card
    if nprocs > 1:
        log.info(f"{nprocs} processes ({distributed.backend()}), "
                 f"{sim.mesh.n_blocks} of the {sim.domain.n_blocks} blocks "
                 "in each")
    restart_step = 0
    if settings.restart:
        # The store's layout planned against this run's, then each
        # process reads its own boxes.
        restart_step, _ = restore_run(sim, settings, log=log,
                                      journal=journal, failover_journal=ilog)
        if ens is not None:
            log.info(f"Restarted {ens.n} ensemble members from "
                     f"{settings.restart_input} member stores at step "
                     f"{restart_step}")
        else:
            log.info(f"Restarted from {settings.restart_input} at step "
                     f"{restart_step}")
    resume = restart_step if settings.restart else None
    codec = sim.snapshot_codec
    if ens is not None and codec.enabled:
        # Per-member quantization ranges are a member-axis reduction the
        # codec does not take: member stores stay exact, as in the
        # reference.
        log.warn("snapshot_bits ignored for ensemble runs (member stores "
                 "stay exact); lossy output is a solo-run codec")
        from .io.codec import CodecConfig

        codec = CodecConfig({}, {})
    #: field index -> bits for the snapshot's device-side encoder.
    enc_spec = {
        i: codec.output[n.lower()]
        for i, n in enumerate(sim.model.field_names)
        if n.lower() in codec.output
    }
    ckpt_lossy = bool(codec.ckpt)
    snapshot_checksum = icfg["verify"] == "full"
    stream = ckpt = None
    step = restart_step
    launches0 = cuda_stencil.LAUNCHES
    modes0 = dict(cuda_stencil.MODE_LAUNCHES)
    entries0 = dict(cuda_stencil.ENTRY_LAUNCHES)
    bands0 = cuda_stencil.BAND_LAUNCHES
    selection = sim.kernel_selection

    def shutdown_requested() -> bool:
        """The shutdown request, agreed across the processes: a signal
        to any of them stops all at the same boundary."""
        if nprocs > 1:
            return distributed.any_process(shutdown.requested)
        return shutdown.requested

    def capture(targets, **kw):
        """A snapshot into the ring's next buffers, once the pipeline
        has written the step that used them last (that wait is recorded
        under the ``targets``' phases)."""
        pipe.reserve([phase for phase, _ in targets])
        with stats.phase("device_to_host", step=step):
            return sim.snapshot_async(ring=ring, **kw)

    def with_checksums(snap, targets):
        if not snap.has_checksums():
            return targets
        sums = snap.checksum_report()
        return [(phase, _with_checksums(fn, sums)) for phase, fn in targets]

    def graceful(at_step: int, ckpt_written: bool):
        """The shutdown path: a checkpoint at this boundary (unless it
        wrote one), the pipeline drained, the stores closed, then
        GracefulShutdown."""
        ckpt_step = None
        if ckpt is not None:
            if not ckpt_written:
                mark("checkpoint", at_step)
                targets = [("checkpoint", ckpt.save)]
                snap = capture(
                    targets, encode=enc_spec if ckpt_lossy else None,
                    exact=not ckpt_lossy,
                    checksum=snapshot_checksum and not ckpt_lossy)
                pipe.submit(at_step, snap, with_checksums(snap, targets))
                stats.count("checkpoints")
                log.info(f"Graceful-shutdown checkpoint at step {at_step}")
            ckpt_step = at_step
        # The marker the next supervised launch resumes from.
        journal.record(event="graceful_shutdown", signal=shutdown.signum,
                       step=at_step, checkpoint_step=ckpt_step)
        mark("drain", at_step)
        pipe.close()
        stream.close()
        if ckpt is not None:
            ckpt.close()
        raise GracefulShutdown(shutdown.signum, at_step, ckpt_step)

    def take(kind, at, **extra):
        """The plan's fault of ``kind`` due at ``at``, journaled as
        ``injected`` at ``step``; None when none is due."""
        fault = plan.take(kind, at)
        if fault is not None:
            journal.record(event="injected", kind=kind, step=step,
                           planned_step=fault.step, **extra)
        return fault

    def open_stores(run_settings, resume_step):
        """The output stream and the checkpoint writer (None without
        checkpoints): member-indexed ones for an ensemble."""
        if ens is not None:
            from .ensemble.io import EnsembleCheckpointWriter, EnsembleStream

            out = EnsembleStream(run_settings, sim.domain, sim.dtype,
                                 writer_id=proc, nwriters=nprocs,
                                 resume_step=resume_step)
        else:
            out = SimStream(run_settings, sim.domain, sim.dtype,
                            writer_id=proc, nwriters=nprocs,
                            resume_step=resume_step, codec=codec.output)
        if not settings.checkpoint:
            return out, None
        try:
            if ens is not None:
                return out, EnsembleCheckpointWriter(
                    run_settings, sim.dtype, writer_id=proc,
                    nwriters=nprocs, resume_step=resume_step,
                    layout=sim.layout())
            return out, CheckpointWriter(
                run_settings, sim.dtype, writer_id=proc, nwriters=nprocs,
                resume_step=resume_step, layout=sim.layout(),
                codec=codec.ckpt)
        except BaseException:
            # The output store is open (a rollback's sidecar marker
            # written): close it before the error leaves.
            _close_quietly(out)
            raise

    try:
        stream, ckpt = open_stores(settings, resume)
        # The reference's keys (its driver's RunStats config), then this
        # package's own.
        stats = RunStats(settings.L, tracer=tracer, config={
            "attempt": attempt,
            "model": sim.model.name,
            "fields": list(sim.model.field_names),
            "mesh_dims": list(sim.domain.dims),
            "padded_storage": (list(sim.domain.storage_shape)
                               if sim.sharded and sim.domain.padded
                               else None),
            "kernel_language": sim.kernel_language,
            "kernel_selection": selection,
            "precision": settings.precision,
            "compute_precision": sim.compute_precision,
            "snapshot_codec": codec.describe(),
            "n_devices": sim.domain.n_blocks,
            "n_processes": nprocs,
            "comm_overlap": sim.comm_overlap,
            "halo_depth": sim.halo_depth,
            # The restore's plan when it changed the layout.
            "reshard": sim.reshard,
            "compile_cache": sim.compile_cache_dir,
            "autotune_mode": resolve_autotune(settings),
            "ensemble": ({"members": ens.n,
                          "member_shards": sim.member_shards}
                         if ens is not None else None),
            "sdc": dict(scfg),
            "numerics": num_mode,
            "device": str(sim.device),
            "fuse": sim.fuse,
            "dtype": str(sim.dtype).replace("torch.", ""),
            **distributed.describe(),
            "io_engine": stream.engine,
            "async_io_depth": depth,
            "integrity": dict(icfg),
        })
        if ens is not None:
            # The members' params and seeds up front; the latest
            # per-member health lands here at each probed boundary.
            stats.record_ensemble({**ens.describe(),
                                   "member_shards": sim.member_shards,
                                   "seeds": list(sim.member_seeds)})
        if context is not None:
            # A failed attempt's phases outlive it in the journal.
            context.stats = stats
        stats.record_comm(icimodel.comm_report(sim))
        stats.record_watchdog({**wd.describe(), "attempt": attempt}
                              if wd is not None else {"enabled": False})
        scrubber = (
            integrity.Scrubber(settings, journal=ilog,
                               every=icfg["scrub_every"],
                               writer_id=proc if nprocs > 1 else None)
            if icfg["scrub"] and ckpt is not None else None
        )
        # Screening compares this process's blocks: a run of one
        # process only, as in the reference.
        screener = (
            sdc_mod.Screener(sim, mode=scfg["mode"], every=scfg["every"],
                             journal=journal, log=log.info)
            if scfg["mode"] != "off" and nprocs == 1 else None
        )
        if screener is not None:
            screener.rearm(restart_step)
        # Metrics instruments, labeled by the run's model, mesh and
        # kernel path; off, each is the shared no-op.
        mlabels = sim.metrics_labels()
        m_step_us = metrics.histogram("step_latency_us", **mlabels)
        m_rounds = metrics.counter("step_rounds", **mlabels)
        m_steps = metrics.counter("steps", **mlabels)
        m_sdc_checks = metrics.counter("sdc_checks", **mlabels)
        num_recorder = (
            obs_numerics.NumericsRecorder(
                sim.model.field_names, metrics=metrics, events=evs,
                gate=DriftGate.from_env(settings), log=log,
                labels=mlabels, journal=journal)
            if num_mode != "off" else None
        )

        def comm_gauges():
            """The fabric model's exchange budget and projection of the
            run's current layout."""
            nonlocal proj_us
            comm = stats.comm
            metrics.gauge("comm_hidden_us_per_step", **mlabels).set(
                comm.get("hidden_us"))
            metrics.gauge("comm_exposed_us_per_step", **mlabels).set(
                comm.get("exposed_us"))
            metrics.gauge("comm_exchanges_per_step", **mlabels).set(
                comm.get("exchanges_per_step"))
            metrics.gauge("comm_halo_bytes_per_step", **mlabels).set(
                comm.get("halo_bytes_per_step"))
            # Computed once per layout: the observed p50 moves, the
            # projection does not.
            proj_us = icimodel.projected_step_us_for(sim)

        proj_us = None
        comm_gauges()

        def refresh_device_gauges():
            """Per-card allocator gauges, and the model-vs-measured
            residual (the observed step-latency p50 less the fabric
            model's projection), refreshed only when a metrics record is
            about to land."""
            for ms in sim.device_memory_stats():
                metrics.gauge("device_bytes_in_use", device=ms["device"],
                              **mlabels).set(ms["bytes_in_use"])
                metrics.gauge("device_peak_bytes_in_use",
                              device=ms["device"],
                              **mlabels).set(ms["peak_bytes_in_use"])
            if proj_us is not None and hasattr(m_step_us, "percentile"):
                p50 = m_step_us.percentile(50)
                if p50 is not None:
                    metrics.gauge("model_projected_step_us",
                                  **mlabels).set(round(proj_us, 1))
                    metrics.gauge("model_vs_measured_residual_us",
                                  **mlabels).set(round(p50 - proj_us, 1))

        evs.emit("run_start", step=restart_step, attempt=attempt,
                 model=sim.model.name, L=settings.L, steps=settings.steps,
                 kernel=sim.kernel_language, mesh=list(sim.domain.dims),
                 restart=bool(settings.restart))
        # The writer's progress re-arms the drain deadline while close()
        # drains (touch re-arms only the armed phase).
        pipe = AsyncStepWriter(
            depth=depth, stats=stats, metrics=metrics,
            progress=(lambda s: wd.touch("drain", s)) if wd is not None
            else None)
        ring = HostRing(pipe.depth + 1)
        first_round = True
        m_reshards = metrics.counter("reshards", **mlabels)
        m_reshard_wall = metrics.gauge("reshard_wall_s", **mlabels)
        # Only a changed blocklist pays the quarantine check, so that a
        # move that cannot be made warns once, not every round.
        quarantine_handled = frozenset()

        def apply_reshape(dims, devices=None) -> bool:
            """Move the live run onto ``dims`` between rounds (the
            reference's ``_apply_reshape``): the pipeline drained, the
            target built and the fields moved (``reshape_live``), then
            the stores reopened in append mode at this step on the new
            layout. A refused move warns and the run stays."""
            nonlocal sim, stream, ckpt, ring, first_round
            # Its own deadline: a target simulation plus the move.
            mark("reshape", step)
            # The steps in flight are written to the old stores first.
            pipe.drain()
            try:
                new_sim, rplan = reshape_live(sim, mesh_dims=dims, seed=seed,
                                              devices=devices, log=log,
                                              journal=journal)
            except ReshardError as e:
                log.warn(f"live reshape refused: {e}")
                return False
            if not rplan.changed:
                return False
            stream.close()
            if ckpt is not None:
                ckpt.close()
            # The old simulation and its pinned buffers go with it; its
            # analytics records stay the run's.
            new_sim.executables[:0] = sim.executables
            sim = new_sim
            ring = HostRing(pipe.depth + 1)
            if screener is not None:
                # The next replay starts from the adopted layout.
                screener.rebind(sim)
                screener.rearm(step)
            # Append at this step, a fresh run included: the steps
            # written before the move stay (each step's blocks say which
            # layout wrote it).
            resumed = dataclasses.replace(settings, restart=True)
            stream, ckpt = open_stores(resumed, step)
            stats.config["reshard"] = sim.reshard
            stats.config["mesh_dims"] = list(sim.domain.dims)
            stats.config["n_devices"] = sim.domain.n_blocks
            # The comm section and its gauges describe the adopted mesh.
            stats.record_comm(icimodel.comm_report(sim))
            comm_gauges()
            m_reshards.inc()
            m_reshard_wall.set(sim.reshard.get("wall_s"))
            first_round = True
            return True

        t0 = time.perf_counter()
        if profile is not None:
            profile.on_boundary(step)
        with trace(cuda=on_card), pipe:
            while step < settings.steps:
                if reshape_poll is not None:
                    req = reshape_poll()
                    dims = _agreed_dims(
                        _resolve_reshape_dims(req, sim) if req else None)
                    if dims is not None:
                        apply_reshape(dims)
                blocked = sdc_mod.resolve_blocklist()
                if nprocs == 1 and blocked and blocked != quarantine_handled:
                    # A device this run computes on was quarantined: move
                    # onto the largest mesh the usable devices hold.
                    in_use = {sdc_mod.device_name(d)
                              for d in sim.mesh.devices}
                    if blocked & in_use:
                        usable = sdc_mod.usable_devices(sim.device.type)
                        dims = sdc_mod.feasible_dims(len(usable), settings.L)
                        moved = dims is not None and apply_reshape(
                            dims, usable[:math.prod(dims)])
                        if not moved:
                            log.warn(
                                "quarantined device(s) "
                                f"{sorted(blocked & in_use)} in use but no "
                                "feasible reshape target — continuing on "
                                "the current mesh")
                    quarantine_handled = blocked
                mark("compile" if first_round else "step_round", step)
                boundary = min(
                    _next_boundary(step, settings.plotgap, settings.steps),
                    _next_boundary(
                        step,
                        settings.checkpoint_freq if ckpt is not None else 0,
                        settings.steps,
                    ),
                )
                if sim.kernel_language == "cuda":
                    # Armed only on the kernel path; the supervisor
                    # stops on it as on a real kernel failure.
                    fault = plan.take("kernel", boundary)
                    if fault is not None:
                        journal.record(event="injected", kind="kernel",
                                       step=boundary,
                                       planned_step=fault.step)
                        raise InjectedKernelError(fault.step)
                fault = plan.take("sdc", boundary)
                if fault is not None:
                    # A live cell flipped before the round: an input of
                    # the step, unlike ``bitflip``'s snapshot copy.
                    name = sim.poison_sdc(
                        device=sdc_mod.resolve_fault_device(settings))
                    journal.record(event="injected", kind="sdc", step=step,
                                   planned_step=fault.step, device=name)
                armed = hot_armed()
                t_round = time.perf_counter()
                with stats.phase("compute", step=step) as span_args:
                    if armed:
                        _timed_round(sim, boundary - step, step, span_args)
                    else:
                        sim.iterate(boundary - step)
                        sim.block_until_ready()
                # One sample per round: the round's mean per step.
                m_step_us.observe((time.perf_counter() - t_round)
                                  / (boundary - step) * 1e6)
                m_rounds.inc()
                m_steps.inc(boundary - step)
                stats.count("steps", boundary - step)
                step = boundary
                first_round = False
                if num_recorder is not None and num_mode == "every_round":
                    # A probe of the live fields after every round,
                    # boundaries included.
                    num_recorder.observe(step, sim.numerics_stats())
                if profile is not None:
                    profile.on_boundary(step)
                if screener is not None:
                    # Before this boundary's poisons and writes: a
                    # mismatch unwinds before a byte is stored.
                    if screener.check(step):
                        m_sdc_checks.inc()
                if take("nan", step) is not None:
                    sim.poison_nan()
                if take("drift", step) is not None:
                    # Finite but wrong: the drift gate's to catch.
                    sim.poison_drift()
                fault = take("preempt", step)
                if fault is not None:
                    # Before this boundary's writes; accepted steps
                    # still drain on the way out.
                    raise PreemptionError(
                        f"injected preemption at step {step} "
                        f"(planned step {fault.step})")
                if take("hang", step) is not None:
                    injected_hang_wait(shutdown=shutdown)
                if screener is not None:
                    # After the poisons, so that the next replay starts
                    # from them.
                    screener.rearm(step)
                at_plot = settings.plotgap > 0 and step % settings.plotgap == 0
                at_ckpt = (
                    ckpt is not None and settings.checkpoint_freq > 0
                    and step % settings.checkpoint_freq == 0
                )
                if not (at_plot or at_ckpt):
                    if shutdown_requested():
                        graceful(step, ckpt_written=False)
                    continue
                mark("io", step)
                targets = []
                if at_plot:
                    log.info(
                        f"Simulation at step {step} writing output step "
                        f"{step // settings.plotgap}"
                    )
                    targets.append(("output", stream.write_step))
                if at_ckpt:
                    targets.append(("checkpoint", ckpt.save))
                if plan.pending("io_error"):
                    targets = [(phase, with_io_fault(plan, journal, fn))
                               for phase, fn in targets]
                # Write-path corruption of this boundary's snapshot copy:
                # the device checksum must catch it.
                bitflip = True if take("bitflip", step) is not None else None
                want_enc = bool(enc_spec) and (at_plot or (at_ckpt
                                                           and ckpt_lossy))
                want_exact = ((at_ckpt and not ckpt_lossy)
                              or (at_plot and not enc_spec))
                snap = capture(
                    targets, health=guard.enabled,
                    numerics=num_mode == "boundary",
                    checksum=snapshot_checksum and want_exact,
                    bitflip=bitflip if want_exact else None,
                    encode=enc_spec if want_enc else None,
                    exact=want_exact)
                if pipe.synchronous:
                    # Depth 0: the copies land (and are checked) here,
                    # and submit writes inline.
                    with stats.phase("device_to_host", step=step):
                        snap.blocks()
                targets = with_checksums(snap, targets)
                # Before the step is submitted: under abort or rollback
                # a poisoned step raises here and reaches no store. A
                # failing report is journaled before it unwinds.
                report = snap.health_report()
                if ens is not None and report is not None:
                    stats.record_member_health(step, report)
                try:
                    event = guard.check(step, report, log=log,
                                        metrics=metrics)
                except HealthError:
                    journal.record(event="health", kind="health", step=step,
                                   policy=guard.policy, action=guard.policy,
                                   **report.describe())
                    raise
                if event is not None:
                    journal.record(**event)
                gate_first = (num_mode == "boundary"
                              and num_recorder.gate.raising)
                if gate_first:
                    # A raising drift policy, like the health guard:
                    # the DriftError unwinds before the drifted step is
                    # submitted, so it reaches no store.
                    num_recorder.observe(step, snap.numerics_report(),
                                         boundary=True)
                pipe.submit(step, snap, targets)
                if num_mode == "boundary" and not gate_first:
                    # After the submission: the resolution waits only
                    # for the probe's scalars.
                    num_recorder.observe(step, snap.numerics_report(),
                                         boundary=True)
                if at_plot:
                    stats.count("output_steps")
                    evs.emit("output", phase="io", step=step,
                             output_step=step // settings.plotgap)
                if at_ckpt:
                    stats.count("checkpoints")
                    evs.emit("checkpoint", phase="io", step=step)
                # One payload byte of the latest durable checkpoint entry
                # of the primary store, its CRCs untouched.
                fault = plan.take("ckpt_corrupt", step)
                if fault is not None and ckpt is not None:
                    info = integrity.corrupt_store_byte(
                        integrity.primary_checkpoint_path(settings))
                    journal.record(event="injected", kind="ckpt_corrupt",
                                   step=step, planned_step=fault.step,
                                   **(info or {"corrupted": False}))
                if scrubber is not None and at_ckpt:
                    scrubber.maybe_scrub(step)
                metrics.maybe_flush(on_flush=refresh_device_gauges)
                if shutdown_requested():
                    # After this boundary's submission, so that a
                    # resumed run reproduces the uninterrupted stream.
                    graceful(step, ckpt_written=at_ckpt)
            # Inside the timed region: the run is complete once every
            # accepted step is written.
            mark("drain", step)
            pipe.close()
        elapsed = time.perf_counter() - t0
        stats.count("kernel_launches", cuda_stencil.LAUNCHES - launches0)
        # This process's launches by mode (each process of a multi-
        # process run counts its own blocks').
        stats.config["launches"] = {
            "modes": {m: n - modes0.get(m, 0)
                      for m, n in cuda_stencil.MODE_LAUNCHES.items()
                      if n - modes0.get(m, 0)},
            "bands": cuda_stencil.BAND_LAUNCHES - bands0}
        io_stats = pipe.overlap_stats()
        stats.record_io(io_stats)
        metrics.gauge("io_hidden_s", **mlabels).set(
            round(sum(io_stats["hidden_s"].values()), 6))
        metrics.gauge("io_exposed_s", **mlabels).set(
            round(sum(io_stats["exposed_s"].values()), 6))
        stats.config["overlap_applied"] = sim.overlap_applied
        if nprocs > 1:
            stats.config["p2p"] = distributed.p2p_stats()
        if screener is not None:
            stats.config["sdc"].update(screener.describe())
        if scrubber is not None:
            stats.config["integrity"].update(scrubber.describe())
        if ilog.events:
            stats.config["integrity"]["events"] = list(ilog.events)
        if wd is not None:
            # With the final heartbeat count.
            stats.record_watchdog({**wd.describe(), "attempt": attempt})
        if journal.events:
            stats.record_faults(journal.events)
        stats.config["host_ring_bytes"] = ring.nbytes
        # Only the ACTIVE members scale the aggregate.
        members = ens.active_n if ens is not None else 1
        cells = settings.L**3 * (settings.steps - restart_step) * members
        if ens is not None:
            log.info(
                f"Completed {settings.steps - restart_step} steps for "
                f"{members} ensemble members in {elapsed:.3f}s "
                f"({cells / max(elapsed, 1e-9):.3e} aggregate "
                "cell-updates/s)")
        else:
            log.info(
                f"Completed {settings.steps - restart_step} steps in "
                f"{elapsed:.3f}s ({cells / max(elapsed, 1e-9):.3e} "
                "cell-updates/s)"
            )
        if profile is not None:
            profile.finish()
        if sim.xstats_enabled:
            xstats.capture_launches(sim, entries0)
        evs.emit("run_complete", step=step, attempt=attempt,
                 wall_s=round(elapsed, 3),
                 steps=settings.steps - restart_step)
        refresh_device_gauges()
        metrics.maybe_flush(force=True)
        prom = env_str("GS_METRICS_PROM", "")
        if prom:
            metrics.write_prometheus(prom)
        if metrics.enabled:
            stats.record_metrics(metrics.snapshot())
        if tracer.enabled or evs.enabled or metrics.enabled:
            stats.record_obs({"trace": tracer.describe(),
                              "events": evs.describe(),
                              "metrics": metrics.describe()})
        if num_recorder is not None:
            stats.record_numerics({"mode": num_mode,
                                   **num_recorder.describe()})
        if sim.xstats_enabled:
            # The records, their summary and the exchange census, with
            # the fabric model's residual, as the reference's section.
            xinfo = xstats.summarize(sim.executables)
            xinfo["records"] = list(sim.executables)
            xinfo["collectives"] = xstats.collective_counts(sim)
            xinfo["model_projected_step_us"] = (
                round(proj_us, 1) if proj_us is not None else None)
            p50 = (m_step_us.percentile(50)
                   if hasattr(m_step_us, "percentile") else None)
            xinfo["observed_p50_us"] = p50
            xinfo["model_vs_measured_residual_us"] = (
                round(p50 - proj_us, 1)
                if p50 is not None and proj_us is not None else None)
            stats.record_executables(xinfo)
        stats.maybe_write()
        if settings.verbose:
            log.info(f"run stats: {stats.summary()}")
        stream.close()
        if ckpt is not None:
            ckpt.close()
    except GracefulShutdown:
        if profile is not None:
            profile.finish()
        raise
    except BaseException as exc:
        if profile is not None:
            profile.finish()
        evs.emit("run_error", step=step, attempt=attempt,
                 error=f"{type(exc).__name__}: {exc}")
        # The pipeline has drained (``with pipe``) before this closes
        # the stores.
        _close_quietly(stream)
        _close_quietly(ckpt)
        raise
    return sim
