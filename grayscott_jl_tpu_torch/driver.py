"""Simulation driver: the reference's ``GrayScott.main`` step loop
(counterpart of the core of ``grayscott_jl_tpu/driver.py::run_once``).

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
assembled arrays as a single-block run's, and a checkpoint restarts a
run on any mesh (unless ``reshard = "off"``, which refuses a layout
other than the checkpoint's).

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

Not here yet, each a later slice of the port (ROADMAP Queue 1): the
supervisor and fault injection, the hang watchdog, the observability
sinks and ensembles.
"""

from __future__ import annotations

import time
from typing import List, Optional

from .config.env import env_str
from .config.settings import (Settings, get_settings, load_backend_and_lang,
                              resolve_reshard)
from .io.async_writer import AsyncStepWriter, resolve_depth
from .io.checkpoint import CheckpointWriter, load_checkpoint
from .io.stream import SimStream
from .ops import cuda_stencil
from .parallel import distributed
from .resilience import integrity
from .resilience.faults import (GracefulShutdown, ShutdownListener,
                                resolve_graceful_shutdown)
from .resilience.health import HealthGuard
from .simulation import HostRing, Simulation
from .utils.log import Logger
from .utils.profiler import RunStats


def _next_boundary(step: int, period: int, limit: int) -> int:
    """Next multiple of ``period`` after ``step``, capped at ``limit``."""
    if period <= 0:
        return limit
    return min(limit, (step // period + 1) * period)


def main(args: List[str], *, n_devices: Optional[int] = None,
         seed: int = 0):
    """Run a full simulation from CLI args. ``GS_SEED`` overrides the
    noise seed (default 0). In a run of several processes ``n_devices``
    is this process's number of blocks (``launch.py`` passes its
    ``devices_per_proc``)."""
    settings = get_settings(list(args))
    env_seed = env_str("GS_SEED", "").strip()
    if env_seed:
        seed = int(env_seed)
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
             seed: int = 0, sim_factory=None) -> Simulation:
    """One simulation run; returns the finished :class:`Simulation`.
    ``sim_factory``, when given, builds the simulation instead of the
    constructor, called as ``sim_factory(settings, n_devices=...,
    seed=...)`` (e.g. to place a mesh's blocks on chosen devices).
    Raises ``HealthError`` at a poisoned boundary under the ``abort``
    policy, ``GracefulShutdown`` after a shutdown request, and
    ``AsyncIOError`` (or, at depth 0, the error itself) when a write
    fails."""
    guard = HealthGuard.from_env(settings)
    reshard = resolve_reshard(settings)
    depth = resolve_depth()
    icfg = integrity.resolve_config(settings)
    # The group starts before the simulation is built (the reference's
    # maybe_initialize_distributed before its Simulation).
    distributed.ensure_started(load_backend_and_lang(settings)[0])
    # The listener brackets the whole run, construction included: a
    # signal during set-up still leaves through the first boundary.
    with ShutdownListener(
            enabled=resolve_graceful_shutdown(settings)) as shutdown:
        return _run(settings, guard, shutdown, reshard, depth, icfg,
                    n_devices=n_devices, seed=seed, sim_factory=sim_factory)


def _run(settings, guard, shutdown, reshard, depth, icfg, *, n_devices,
         seed, sim_factory) -> Simulation:
    if sim_factory is not None:
        sim = sim_factory(settings, n_devices=n_devices, seed=seed)
    else:
        sim = Simulation(settings, n_devices=n_devices, seed=seed)
    log = Logger(verbose=settings.verbose)
    journal = integrity.IntegrityLog(log)
    proc, nprocs = distributed.process_index(), distributed.process_count()
    if nprocs > 1:
        log.info(f"{nprocs} processes ({distributed.backend()}), "
                 f"{sim.mesh.n_blocks} of the {sim.domain.n_blocks} blocks "
                 "in each")
    restart_step = 0
    if settings.restart:
        # Each process of a multi-process run reads its own boxes.
        boxes = sim.local_boxes() if nprocs > 1 else None
        *fields, restart_step = load_checkpoint(
            settings.restart_input, settings, settings.restart_step,
            layout=sim.block_boxes() if reshard == "off" else None,
            journal=journal, log=log, boxes=boxes,
        )
        if boxes is None:
            sim.restore_fields(fields, restart_step)
        else:
            sim.restore_blocks(fields[0], restart_step)
        log.info(
            f"Restarted from {settings.restart_input} at step {restart_step}"
        )
    resume = restart_step if settings.restart else None
    codec = sim.snapshot_codec
    #: field index -> bits for the snapshot's device-side encoder.
    enc_spec = {
        i: codec.output[n.lower()]
        for i, n in enumerate(sim.model.field_names)
        if n.lower() in codec.output
    }
    ckpt_lossy = bool(codec.ckpt)
    snapshot_checksum = icfg["verify"] == "full"
    stream = ckpt = None
    launches0 = cuda_stencil.LAUNCHES
    modes0 = dict(cuda_stencil.MODE_LAUNCHES)
    bands0 = cuda_stencil.BAND_LAUNCHES

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
        with stats.phase("device_to_host"):
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
                targets = [("checkpoint", ckpt.save)]
                snap = capture(
                    targets, encode=enc_spec if ckpt_lossy else None,
                    exact=not ckpt_lossy,
                    checksum=snapshot_checksum and not ckpt_lossy)
                pipe.submit(at_step, snap, with_checksums(snap, targets))
                stats.count("checkpoints")
                log.info(f"Graceful-shutdown checkpoint at step {at_step}")
            ckpt_step = at_step
        pipe.close()
        stream.close()
        if ckpt is not None:
            ckpt.close()
        raise GracefulShutdown(shutdown.signum, at_step, ckpt_step)

    try:
        stream = SimStream(settings, sim.domain, sim.dtype,
                           writer_id=proc, nwriters=nprocs,
                           resume_step=resume, codec=codec.output)
        if settings.checkpoint:
            ckpt = CheckpointWriter(settings, sim.dtype, writer_id=proc,
                                    nwriters=nprocs, resume_step=resume,
                                    codec=codec.ckpt)
        stats = RunStats(settings.L, config={
            "model": sim.model.name,
            "device": str(sim.device),
            "kernel_language": sim.kernel_language,
            "kernel_selection": sim.kernel_selection,
            "fuse": sim.fuse,
            "precision": settings.precision,
            "compute_precision": sim.compute_precision,
            "dtype": str(sim.dtype).replace("torch.", ""),
            "snapshot_codec": codec.describe(),
            "n_devices": sim.domain.n_blocks,
            "mesh_dims": list(sim.domain.dims),
            **distributed.describe(),
            "comm_overlap": sim.comm_overlap,
            "halo_depth": sim.halo_depth,
            "io_engine": stream.engine,
            "async_io_depth": depth,
            "integrity": dict(icfg),
        })
        scrubber = (
            integrity.Scrubber(settings, journal=journal,
                               every=icfg["scrub_every"],
                               writer_id=proc if nprocs > 1 else None)
            if icfg["scrub"] and ckpt is not None else None
        )
        pipe = AsyncStepWriter(depth=depth, stats=stats)
        ring = HostRing(pipe.depth + 1)
        step = restart_step
        t0 = time.perf_counter()
        with pipe:
            while step < settings.steps:
                boundary = min(
                    _next_boundary(step, settings.plotgap, settings.steps),
                    _next_boundary(
                        step,
                        settings.checkpoint_freq if ckpt is not None else 0,
                        settings.steps,
                    ),
                )
                with stats.phase("compute"):
                    sim.iterate(boundary - step)
                    sim.block_until_ready()
                stats.count("steps", boundary - step)
                step = boundary
                at_plot = settings.plotgap > 0 and step % settings.plotgap == 0
                at_ckpt = (
                    ckpt is not None and settings.checkpoint_freq > 0
                    and step % settings.checkpoint_freq == 0
                )
                if not (at_plot or at_ckpt):
                    if shutdown_requested():
                        graceful(step, ckpt_written=False)
                    continue
                targets = []
                if at_plot:
                    log.info(
                        f"Simulation at step {step} writing output step "
                        f"{step // settings.plotgap}"
                    )
                    targets.append(("output", stream.write_step))
                if at_ckpt:
                    targets.append(("checkpoint", ckpt.save))
                want_enc = bool(enc_spec) and (at_plot or (at_ckpt
                                                           and ckpt_lossy))
                want_exact = ((at_ckpt and not ckpt_lossy)
                              or (at_plot and not enc_spec))
                snap = capture(
                    targets, health=guard.enabled,
                    checksum=snapshot_checksum and want_exact,
                    encode=enc_spec if want_enc else None,
                    exact=want_exact)
                if pipe.synchronous:
                    # Depth 0: the copies land (and are checked) here,
                    # and submit writes inline.
                    with stats.phase("device_to_host"):
                        snap.blocks()
                targets = with_checksums(snap, targets)
                # Before the step is submitted: under abort a poisoned
                # step raises here and reaches no store.
                guard.check(step, snap.health_report(), log=log)
                pipe.submit(step, snap, targets)
                if at_plot:
                    stats.count("output_steps")
                if at_ckpt:
                    stats.count("checkpoints")
                    if scrubber is not None:
                        scrubber.maybe_scrub(step)
                if shutdown_requested():
                    # After this boundary's submission, so that a
                    # resumed run reproduces the uninterrupted stream.
                    graceful(step, ckpt_written=at_ckpt)
            # Inside the timed region: the run is complete once every
            # accepted step is written.
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
        stats.record_io(pipe.overlap_stats())
        stats.config["overlap_applied"] = sim.overlap_applied
        if nprocs > 1:
            stats.config["p2p"] = distributed.p2p_stats()
        if scrubber is not None:
            stats.config["integrity"].update(scrubber.describe())
        if journal.events:
            stats.config["integrity"]["events"] = list(journal.events)
        stats.config["host_ring_bytes"] = ring.nbytes
        cells = settings.L**3 * (settings.steps - restart_step)
        log.info(
            f"Completed {settings.steps - restart_step} steps in "
            f"{elapsed:.3f}s ({cells / max(elapsed, 1e-9):.3e} "
            "cell-updates/s)"
        )
        stats.maybe_write()
        if settings.verbose:
            log.info(f"run stats: {stats.summary()}")
        stream.close()
        if ckpt is not None:
            ckpt.close()
    except GracefulShutdown:
        raise
    except BaseException:
        # The pipeline has drained (``with pipe``) before this closes
        # the stores.
        _close_quietly(stream)
        _close_quietly(ckpt)
        raise
    return sim
