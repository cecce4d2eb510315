"""The serve worker fleet: batches in, supervised launches out
(counterpart of ``grayscott_jl_tpu/serve/worker.py``).

Each worker is a thread looping ``scheduler.next_batch`` ->
``driver.run_once`` (under ``resilience.supervisor.supervise`` when the
batch is supervised — the solo CLI's resilience story). Two pieces are
the service's own:

**Warm ensembles.** Member parameters, seeds and noise keys are launch
arguments of the batched kernel, so a worker keeps one
:class:`~..ensemble.engine.EnsembleSimulation` per launch shape (model
x L x slots x precision x schedule x backend — :func:`warm_key`) and
rebinds it to each new batch with ``repack``: the second batch of a
shape builds nothing. This is why the scheduler pads batches to
power-of-two slot counts. The cache is per worker thread: an engine is
never shared across threads.

**Requeue on worker death.** A launch failure that escapes supervision
(or a kill of the unsupervised kind — ``GS_SERVE_CHAOS`` models it) is
classified with the supervisor's taxonomy and handed back to the
scheduler as a batch-granular requeue: the relaunching worker resumes
every member from the member-store checkpoint quorum
(``ensemble/io.restore_ensemble``), or from scratch when nothing durable
exists yet; the member stores finish byte-identical to an uninterrupted
run either way (chaos scenario 6).

Several workers drive one card at once (``GS_SERVE_WORKERS >= 2``): the
kernel layer's first-use build, its tensor-map and key caches and its
replay flag are safe across threads (``ops/_build.py``,
``ops/cuda_stencil.py``). Launch counts stay process-wide; the per-batch
story is in the event stream.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from ..utils.log import Logger
from .scheduler import Batch, Scheduler, ServeConfig

__all__ = ["WorkerFleet", "warm_key"]


def warm_key(settings) -> Tuple:
    """The launch-shape signature a warm engine can be rebound across
    (everything ``EnsembleSimulation.repack`` refuses to change, and the
    backend, which ``repack`` does not check): model, L, slot count,
    member sharding, precision, kernel language, the halo/overlap
    schedule, whether noise is drawn, and the backend."""
    ens = settings.ensemble
    return (
        ens.model,
        settings.L,
        ens.n,
        ens.member_shards,
        settings.precision,
        settings.kernel_language,
        settings.halo_depth,
        settings.comm_overlap,
        any(m.value("noise") != 0.0 for m in ens.members),
        settings.backend,
    )


class WorkerFleet:
    """``cfg.workers`` threads draining one :class:`Scheduler`."""

    def __init__(self, scheduler: Scheduler, cfg: ServeConfig,
                 *, log: Optional[Logger] = None):
        self.scheduler = scheduler
        self.cfg = cfg
        self.log = log or Logger(verbose=False)
        self._threads: list = []
        self._stop = threading.Event()
        # Per-worker warm engine cache; an engine belongs to exactly one
        # thread for its whole life.
        self._warm: Dict[int, Dict[Tuple, object]] = {}
        self._busy: Dict[int, bool] = {}
        self._count = threading.Lock()
        self.launches = 0
        self.warm_hits = 0

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "WorkerFleet":
        for i in range(self.cfg.workers):
            t = threading.Thread(
                target=self._run, args=(i,),
                name=f"gs-serve-worker-{i}", daemon=True,
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
        self._threads = []

    # ------------------------------------------------------------- loop

    def _run(self, worker_id: int) -> None:
        while not self._stop.is_set():
            batch = self.scheduler.next_batch(timeout=0.2)
            if batch is None:
                continue
            self._busy[worker_id] = True
            try:
                self._launch(worker_id, batch)
            finally:
                self._busy[worker_id] = False

    def utilization(self) -> float:
        """Fraction of worker threads currently inside a launch — one of
        the two signals of the elastic policy (``serve/elastic.py``)."""
        n = len(self._threads)
        if n == 0:
            return 0.0
        return sum(1 for b in self._busy.values() if b) / n

    def _factory(self, worker_id: int, batch: Batch):
        """The driver's ``sim_factory`` seam: a warm engine rebound to
        this batch when the shape matches, else a fresh one kept warm."""

        def factory(settings, *, n_devices=None, seed: int = 0):
            from ..ensemble.engine import EnsembleSimulation

            cache = self._warm.setdefault(worker_id, {})
            key = warm_key(settings)
            sim = cache.get(key)
            if sim is not None:
                try:
                    sim.repack(settings, seed=seed)
                    batch.warm = True
                    with self._count:
                        self.warm_hits += 1
                    return sim
                except ValueError:
                    # The key covers repack's refusals; a refusal here
                    # still falls through to a fresh engine.
                    cache.pop(key, None)
            sim = EnsembleSimulation(settings, n_devices=n_devices, seed=seed)
            cache[key] = sim
            return sim

        return factory

    def _launch(self, worker_id: int, batch: Batch) -> None:
        from ..obs import events as obs_events
        from ..resilience.supervisor import (
            classify_failure,
            latest_durable_checkpoint,
        )

        settings = batch.settings
        if batch.attempt > 0:
            # Requeued batch: resume from the member-store checkpoint
            # quorum when one exists (idle slots re-initialize); a batch
            # that never checkpointed replays from scratch —
            # deterministic, so the stores come out identical either way.
            resume = (
                latest_durable_checkpoint(settings)
                if settings.checkpoint else None
            )
            if resume is not None:
                settings.restart = True
                settings.restart_input = settings.checkpoint_output
                settings.restart_step = -1
            else:
                settings.restart = False
        with self._count:
            self.launches += 1
        t0 = time.time()
        member = getattr(self.scheduler, "member_id", "") or "local"
        try:
            # Every event the launch emits from this thread carries the
            # batch id (the scheduler's progress tracking and the SSE
            # fan-out key on it) and the worker's fleet identity. The
            # driver polls ``reshape_poll`` each step round; a posted
            # request (consume-once) moves the live ensemble onto
            # another mesh with no checkpoint round-trip.
            def reshape_poll(batch_id=batch.id):
                return self.scheduler.take_reshape(batch_id)

            with obs_events.bound(batch=batch.id,
                                  worker=f"{member}.{worker_id}"):
                if batch.supervise:
                    from ..resilience.supervisor import supervise

                    supervise(
                        settings, seed=0,
                        sim_factory=self._factory(worker_id, batch),
                        reshape_poll=reshape_poll,
                    )
                else:
                    from ..driver import run_once

                    run_once(
                        settings, seed=0,
                        sim_factory=self._factory(worker_id, batch),
                        reshape_poll=reshape_poll,
                    )
        except BaseException as exc:  # noqa: BLE001 — classified below
            kind = classify_failure(exc)
            label = kind or f"fatal:{type(exc).__name__}"
            if kind == "sdc":
                # Compute-path corruption that escaped in-place recovery:
                # this process's devices are suspect. Mark the member
                # degraded BEFORE requeueing, so that the batch lands on
                # a healthy fleet peer.
                self.scheduler.mark_degraded(
                    f"sdc: {type(exc).__name__}: {exc}"
                )
            if kind is not None and batch.attempt < self.cfg.max_requeues:
                self.log.warn(
                    f"serve worker {worker_id}: batch {batch.id} died "
                    f"({label}); requeueing (attempt {batch.attempt + 1})"
                )
                self.scheduler.requeue(batch, fault=label)
                return
            self.log.warn(
                f"serve worker {worker_id}: batch {batch.id} FAILED "
                f"({type(exc).__name__}: {exc})"
            )
            self.scheduler.complete(
                batch, ok=False, error=f"{type(exc).__name__}: {exc}",
                wall_s=time.time() - t0,
            )
            return
        self.scheduler.complete(batch, ok=True, wall_s=time.time() - t0)
