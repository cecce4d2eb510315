"""Admission control, per-tenant quotas, priorities and request packing
(counterpart of ``grayscott_jl_tpu/serve/scheduler.py``).

The scheduler is the queue between the HTTP front door
(``serve/server.py``) and the worker fleet (``serve/worker.py``). A
request is a MEMBER of a batched ensemble, so batching is not a new
execution path: the scheduler groups compatible requests (same
:func:`~.protocol.pack_key`) into one ``[ensemble]``-shaped launch, pads
the batch to a canonical power-of-two slot count so that the worker's
warm engine stays warm (idle slots write no stores and count in no
statistic — ``ensemble/spec.MemberSpec.active``), and the ensemble engine
does the rest: on the card, one batched kernel launch per step for every
slot.

Admission control happens at submit time, loudly:

* spec validation (``protocol.parse_job``) raises ``SettingsError``
  -> HTTP 400 with the message;
* a full queue (``GS_SERVE_QUEUE_DEPTH``) or an exhausted per-tenant
  quota (``GS_SERVE_TENANT_QUOTA``) records a REJECTED job (so the
  client can still query why) and emits ``job_rejected`` -> HTTP 429.

Every lifecycle edge lands on the ``GS_EVENTS`` stream (``job_submitted``
/ ``job_packed`` / ``job_requeued`` / ``job_complete`` /
``job_rejected``; the schema of ``obs/report.py``) and in the metrics
registry — no second telemetry path.

:class:`ServeConfig` holds one field the reference's has not:
``backend`` (``"CUDA"`` by default, ``"CPU"`` on request; the CLI's
``--backend``), which picks where batches run (``protocol.BACKENDS``)
and enters the cache digest (``cache.canonical_spec``).

This module imports neither torch nor JAX itself; thread-safe (the HTTP
handler threads, the worker threads and the event subscriber all call
in).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..config.env import env_flag, env_float, env_int, env_str
from ..models.base import SettingsError
from . import cache as cache_mod
from . import protocol

__all__ = [
    "Batch",
    "Job",
    "JOB_STATES",
    "Scheduler",
    "ServeConfig",
    "resolve_serve_config",
]

#: Lifecycle states a job can be in (``Job.state``).
JOB_STATES = (
    "queued", "packed", "running", "complete", "failed", "cancelled",
    "rejected",
)


@dataclasses.dataclass
class ServeConfig:
    """Resolved service configuration (the ``GS_SERVE_*`` knob family)
    and the service's ``backend``."""

    host: str = "127.0.0.1"
    port: int = 8642
    workers: int = 1
    queue_depth: int = 256
    tenant_quota: int = 32
    pack_max: int = 8
    pack_window_s: float = 0.05
    slo_s: float = 60.0
    max_l: int = 256
    max_steps: int = 100_000
    state_dir: str = "serve-state"
    supervise: bool = True
    max_requeues: int = 2
    chaos: str = ""
    sse_queue: int = 256
    cache: bool = True
    cache_dir: str = ""
    cache_verify: bool = True
    fleet_dir: str = ""
    replica: str = ""
    fleet_rank: int = 0
    lease_ttl_s: float = 10.0
    heartbeat_s: float = 2.0
    #: Where batches run (``protocol.BACKENDS``): the card by default.
    backend: str = "CUDA"

    def describe(self) -> dict:
        return dataclasses.asdict(self)


def resolve_serve_config(settings=None) -> ServeConfig:
    """The ``GS_SERVE_*`` env knobs -> :class:`ServeConfig`, with the
    reference's defaults and refusals.

    Env-only (the service is launched by ``python -m
    grayscott_jl_tpu_torch.serve``, not by a simulation config); no
    variable carries ``backend``: the CLI's ``--backend`` sets it.
    ``GS_SERVE_CHAOS`` arms a consume-once fault-plan string
    (``resilience/faults.py`` syntax) applied to the FIRST batch
    launched — the worker-kill hook of chaos scenario 6 (``chaos.py``).
    """
    cfg = ServeConfig(
        host=env_str("GS_SERVE_HOST", "127.0.0.1"),
        port=env_int("GS_SERVE_PORT", 8642),
        workers=env_int("GS_SERVE_WORKERS", 1),
        queue_depth=env_int("GS_SERVE_QUEUE_DEPTH", 256),
        tenant_quota=env_int("GS_SERVE_TENANT_QUOTA", 32),
        pack_max=env_int("GS_SERVE_PACK_MAX", 8),
        pack_window_s=env_float("GS_SERVE_PACK_WINDOW_S", 0.05),
        slo_s=env_float("GS_SERVE_SLO_S", 60.0),
        max_l=env_int("GS_SERVE_MAX_L", 256),
        max_steps=env_int("GS_SERVE_MAX_STEPS", 100_000),
        state_dir=env_str("GS_SERVE_STATE_DIR", "serve-state"),
        supervise=env_flag("GS_SERVE_SUPERVISE", True),
        max_requeues=env_int("GS_SERVE_MAX_REQUEUES", 2),
        chaos=env_str("GS_SERVE_CHAOS", ""),
        sse_queue=env_int("GS_SERVE_SSE_QUEUE", 256),
        cache=cache_mod.resolve_cache_enabled(),
        cache_dir=cache_mod.resolve_cache_dir(),
        cache_verify=cache_mod.resolve_cache_verify(),
        fleet_dir=env_str("GS_SERVE_FLEET_DIR", ""),
        replica=env_str("GS_SERVE_REPLICA", ""),
        fleet_rank=env_int("GS_SERVE_FLEET_RANK", 0),
        lease_ttl_s=env_float("GS_SERVE_LEASE_TTL_S", 10.0),
        heartbeat_s=env_float("GS_SERVE_HEARTBEAT_S", 2.0),
    )
    if cfg.fleet_dir:
        # A fleet member may be a pure front door (workers=0): the
        # compute capacity lives in the shared fleet, not the process.
        if cfg.workers < 0:
            raise ValueError(
                f"GS_SERVE_WORKERS must be >= 0 in fleet mode, got "
                f"{cfg.workers}"
            )
    elif cfg.workers < 1:
        raise ValueError(f"GS_SERVE_WORKERS must be >= 1, got {cfg.workers}")
    if cfg.pack_max < 1:
        raise ValueError(f"GS_SERVE_PACK_MAX must be >= 1, got {cfg.pack_max}")
    if cfg.queue_depth < 1:
        raise ValueError(
            f"GS_SERVE_QUEUE_DEPTH must be >= 1, got {cfg.queue_depth}"
        )
    if cfg.tenant_quota < 1:
        raise ValueError(
            f"GS_SERVE_TENANT_QUOTA must be >= 1, got {cfg.tenant_quota}"
        )
    if cfg.pack_window_s < 0:
        raise ValueError(
            f"GS_SERVE_PACK_WINDOW_S must be >= 0, got {cfg.pack_window_s}"
        )
    if cfg.sse_queue < 1:
        raise ValueError(
            f"GS_SERVE_SSE_QUEUE must be >= 1, got {cfg.sse_queue}"
        )
    if cfg.fleet_rank < 0:
        raise ValueError(
            f"GS_SERVE_FLEET_RANK must be >= 0, got {cfg.fleet_rank}"
        )
    if cfg.lease_ttl_s <= 0:
        raise ValueError(
            f"GS_SERVE_LEASE_TTL_S must be > 0, got {cfg.lease_ttl_s}"
        )
    if not 0 < cfg.heartbeat_s < cfg.lease_ttl_s:
        raise ValueError(
            f"GS_SERVE_HEARTBEAT_S must be in (0, lease_ttl_s="
            f"{cfg.lease_ttl_s}), got {cfg.heartbeat_s} — a lease must "
            "outlive at least one missed heartbeat"
        )
    return cfg


class AdmissionError(Exception):
    """A structurally valid job the service refuses to queue (full
    queue, exhausted tenant quota, drain). Carries the rejected
    :class:`Job` record so the HTTP layer can return its id."""

    def __init__(self, job: "Job", reason: str):
        super().__init__(reason)
        self.job = job
        self.reason = reason


@dataclasses.dataclass
class Job:
    """One request's full lifecycle record."""

    id: str
    tenant: str
    spec: protocol.JobSpec
    state: str = "queued"
    seq: int = 0
    batch_id: Optional[str] = None
    slot: Optional[int] = None
    attempts: int = 0
    error: Optional[str] = None
    submitted_t: float = 0.0
    packed_t: Optional[float] = None
    started_t: Optional[float] = None
    first_step_t: Optional[float] = None
    finished_t: Optional[float] = None
    store: Optional[str] = None
    checkpoint_store: Optional[str] = None
    digest: Optional[str] = None
    cache: Optional[str] = None

    def describe(self) -> dict:
        out = {
            "job": self.id,
            "tenant": self.tenant,
            "state": self.state,
            "priority": self.spec.priority,
            "model": self.spec.model,
            "L": self.spec.L,
            "steps": self.spec.steps,
            "batch": self.batch_id,
            "slot": self.slot,
            "attempts": self.attempts,
            "error": self.error,
            "submitted_t": self.submitted_t,
            "packed_t": self.packed_t,
            "started_t": self.started_t,
            "first_step_t": self.first_step_t,
            "finished_t": self.finished_t,
            "store": self.store,
            "digest": self.digest,
            "cache": self.cache,
        }
        if self.first_step_t is not None:
            out["request_to_first_step_s"] = round(
                self.first_step_t - self.submitted_t, 6
            )
        return out


@dataclasses.dataclass
class Batch:
    """One packed launch: the jobs riding it (slot order) plus the
    launch Settings the worker hands to the driver."""

    id: str
    jobs: List[Job]
    key: Tuple
    n_slots: int
    settings: object  # config.settings.Settings
    dir: str
    supervise: bool = True
    attempt: int = 0
    warm: bool = False
    created_t: float = 0.0
    #: Pending live-reshape request for the worker running this batch
    #: (``{"scale": "grow"|"shrink"}`` or ``{"mesh_dims": [x, y, z]}``,
    #: ``driver.run_once``'s ``reshape_poll``). Consume-once via
    #: :meth:`Scheduler.take_reshape`.
    reshape_request: Optional[dict] = None

    @property
    def job_ids(self) -> List[str]:
        return [j.id for j in self.jobs]


def _pow2_slots(n: int, cap: int) -> int:
    """Canonical slot count: the smallest power of two >= n, capped at
    the pack limit — so a 3-job batch runs the same launch shape
    as a 4-job one and the worker's warm cache keeps hitting."""
    slots = 1
    while slots < n:
        slots *= 2
    return min(slots, max(cap, n))


class Scheduler:
    """The multi-tenant queue + packer."""

    def __init__(self, cfg: ServeConfig, *, events=None, metrics=None):
        self.cfg = cfg
        if events is None:
            from ..obs import events as obs_events

            events = obs_events.get_events()
        if metrics is None:
            from ..obs import metrics as obs_metrics

            metrics = obs_metrics.get_metrics()
        self.events = events
        self.metrics = metrics
        self.jobs: Dict[str, Job] = {}
        self.batches: Dict[str, Batch] = {}
        self._queue: List[Job] = []  # pending, FIFO within priority
        self._resume: List[Batch] = []  # requeued batches, FIFO
        self._cond = threading.Condition()
        # Launch nonce: job/batch ids must stay unique across service
        # restarts appending to ONE events file, or the per-tenant
        # report would merge two lives of "j000001" into nonsense.
        self._nonce = os.urandom(3).hex()
        self._seq = 0
        self._batch_seq = 0
        self._closed = False
        #: Set by mark_degraded (SDC quarantine, ``resilience/sdc.py``):
        #: this process's compute inventory is suspect. The solo
        #: scheduler only records it (no peers to route to); the
        #: cluster scheduler stops claiming fresh work.
        self.degraded: Optional[str] = None
        self._chaos_pending = cfg.chaos.strip()
        self._unsubscribe = None
        self.cache: Optional[cache_mod.ResultCache] = None
        if cfg.cache:
            root = cfg.cache_dir or os.path.join(
                cfg.fleet_dir or cfg.state_dir, "cache"
            )
            self.cache = cache_mod.ResultCache(
                root, events=self.events, metrics=self.metrics,
                verify=cfg.cache_verify, backend=cfg.backend,
            )

    # ------------------------------------------------------------ events

    def attach_events(self):
        """Subscribe to the unified event stream to track run progress
        (``run_start`` -> running, first ``output``/``checkpoint`` ->
        first-step timestamp) for batches carrying our batch-id bound
        attr. Returns self for chaining; idempotent."""
        if self._unsubscribe is None and self.events.enabled:
            self._unsubscribe = self.events.subscribe(self._on_event)
        return self

    def detach_events(self):
        if self._unsubscribe is not None:
            self._unsubscribe()
            self._unsubscribe = None

    def _on_event(self, record: dict) -> None:
        kind = record.get("kind")
        if kind not in ("run_start", "output", "checkpoint",
                        "run_complete"):
            return
        batch_id = (record.get("attrs") or {}).get("batch")
        if not batch_id:
            return
        with self._cond:
            batch = self.batches.get(batch_id)
            if batch is None:
                return
            ts = record.get("ts") or time.time()
            for job in batch.jobs:
                if kind == "run_start" and job.state == "packed":
                    job.state = "running"
                    job.started_t = job.started_t or ts
                elif kind in ("output", "checkpoint", "run_complete"):
                    # The first evidence of completed compute: the
                    # request-to-first-step clock's stop mark.
                    if job.first_step_t is None and job.state in (
                        "packed", "running",
                    ):
                        job.first_step_t = ts

    # ------------------------------------------------------------ submit

    def submit(self, payload) -> Job:
        """Admit one client payload. Raises
        :class:`~..models.base.SettingsError` on an invalid spec (HTTP
        400) and :class:`AdmissionError` on a valid-but-refused one
        (HTTP 429); otherwise returns the QUEUED job."""
        spec = protocol.parse_job(
            payload, max_l=self.cfg.max_l, max_steps=self.cfg.max_steps
        )
        # Cache probe OUTSIDE the lock: the CRC audit of a cached
        # artifact is I/O, and admission must not serialize behind it.
        digest = cached = None
        if self.cache is not None:
            digest = cache_mod.job_digest(spec, backend=self.cfg.backend)
            cached = self.cache.lookup(digest)
        with self._cond:
            self._seq += 1
            job = Job(
                id=f"j{self._nonce}-{self._seq:05d}",
                tenant=spec.tenant,
                spec=spec,
                seq=self._seq,
                submitted_t=time.time(),
                digest=digest,
            )
            if cached is not None and not self._closed:
                # The determinism dividend: this exact
                # physics already ran somewhere in the fleet and its
                # CRC-verified store is on disk — answer in
                # O(store-read), consuming no queue slot, no tenant
                # quota, and no worker launch.
                now = time.time()
                job.cache = "hit"
                job.state = "complete"
                job.store = cached["store"]
                job.first_step_t = job.finished_t = now
                self.jobs[job.id] = job
                self.metrics.counter("serve_cache_hits").inc()
                self.events.emit(
                    "job_submitted", job=job.id, tenant=job.tenant,
                    priority=spec.priority, model=spec.model, L=spec.L,
                    steps=spec.steps, cache="hit",
                )
                self.events.emit(
                    "cache_hit", digest=digest, job=job.id,
                    tenant=job.tenant,
                )
                self.events.emit(
                    "job_complete", job=job.id, tenant=job.tenant,
                    status="complete", cache="hit",
                    wall_s=round(now - job.submitted_t, 3),
                )
                self._cond.notify_all()
                return job
            reason = self._admission_reason(job)
            if reason is not None:
                job.state = "rejected"
                job.error = reason
                job.finished_t = time.time()
                self.jobs[job.id] = job
                self.metrics.counter(
                    "serve_jobs_rejected", reason=reason
                ).inc()
                self.events.emit(
                    "job_rejected", job=job.id, tenant=job.tenant,
                    reason=reason,
                )
                raise AdmissionError(job, reason)
            self.jobs[job.id] = job
            self._queue.append(job)
            self._queue.sort(key=lambda j: (-j.spec.priority, j.seq))
            self.metrics.counter("serve_jobs_submitted").inc()
            self.metrics.gauge("serve_queue_depth").set(
                len(self._queue)
            )
            self.events.emit(
                "job_submitted", job=job.id, tenant=job.tenant,
                priority=spec.priority, model=spec.model, L=spec.L,
                steps=spec.steps,
            )
            if self.cache is not None:
                job.cache = "miss"
                self.metrics.counter("serve_cache_misses").inc()
                self.events.emit(
                    "cache_miss", digest=digest, job=job.id,
                    tenant=job.tenant,
                )
            self._cond.notify_all()
            return job

    def _admission_reason(self, job: Job) -> Optional[str]:
        if self._closed:
            return "shutting_down"
        if len(self._queue) >= self.cfg.queue_depth:
            return "queue_full"
        live = sum(
            1 for j in self.jobs.values()
            if j.tenant == job.tenant
            and j.state in ("queued", "packed", "running")
        )
        if live >= self.cfg.tenant_quota:
            return "tenant_quota"
        return None

    # ------------------------------------------------------------ cancel

    def cancel(self, job_id: str) -> bool:
        """Cancel a QUEUED job (packed/running jobs are committed to a
        launch and refuse — HTTP 409). True on success."""
        with self._cond:
            job = self.jobs.get(job_id)
            if job is None or job.state != "queued":
                return False
            self._queue.remove(job)
            job.state = "cancelled"
            job.finished_t = time.time()
            self.metrics.gauge("serve_queue_depth").set(
                len(self._queue)
            )
            self.events.emit(
                "job_complete", job=job.id, tenant=job.tenant,
                status="cancelled",
            )
            return True

    # ------------------------------------------------------------- pack

    def next_batch(self, timeout: float = 0.5) -> Optional[Batch]:
        """The worker-facing pop: a requeued batch if one is waiting,
        else a freshly packed one. Blocks up to ``timeout`` for work,
        then up to ``GS_SERVE_PACK_WINDOW_S`` more for compatible
        requests to fill the batch — the latency/packing trade the SLO
        budget pays for throughput."""
        deadline = time.monotonic() + max(timeout, 0.0)
        with self._cond:
            while True:
                if self._resume:
                    return self._resume.pop(0)
                if self._queue:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closed:
                    return None
                self._cond.wait(remaining)
            head = self._queue[0]
            key = protocol.pack_key(head.spec)
            window_end = time.monotonic() + self.cfg.pack_window_s
            while True:
                compatible = [
                    j for j in self._queue
                    if protocol.pack_key(j.spec) == key
                ]
                if len(compatible) >= self.cfg.pack_max:
                    break
                remaining = window_end - time.monotonic()
                if remaining <= 0 or self._closed:
                    break
                self._cond.wait(remaining)
                if head.state != "queued":
                    # cancelled out from under us — restart the pop
                    return self.next_batch(timeout=0.0)
            jobs = compatible[: self.cfg.pack_max]
            for j in jobs:
                self._queue.remove(j)
            self.metrics.gauge("serve_queue_depth").set(
                len(self._queue)
            )
            return self._build_batch(jobs, key)

    def _build_batch(self, jobs: List[Job], key: Tuple) -> Batch:
        self._batch_seq += 1
        batch_id = f"b{self._nonce}-{self._batch_seq:04d}"
        n_slots = _pow2_slots(len(jobs), self.cfg.pack_max)
        bdir = os.path.join(self.cfg.state_dir, "batches", batch_id)
        os.makedirs(bdir, exist_ok=True)
        settings = protocol.batch_settings(
            [j.spec for j in jobs],
            n_slots=n_slots,
            output=os.path.join(bdir, "gs.bp"),
            checkpoint_output=os.path.join(bdir, "ckpt.bp"),
            names=[j.id for j in jobs],
            supervise=self.cfg.supervise,
            backend=self.cfg.backend,
        )
        supervise = self.cfg.supervise
        if self._chaos_pending:
            # Consume-once worker-kill chaos (GS_SERVE_CHAOS,
            # chaos scenario 6): the injected fault models the
            # worker process dying, so the launch runs UNsupervised —
            # recovery must come from the scheduler requeue, not from
            # an in-place supervisor restart.
            settings.faults = self._chaos_pending
            settings.supervise = False
            supervise = False
            self._chaos_pending = ""
        batch = Batch(
            id=batch_id, jobs=jobs, key=key, n_slots=n_slots,
            settings=settings, dir=bdir, supervise=supervise,
            created_t=time.time(),
        )
        self.batches[batch_id] = batch
        from ..ensemble.io import member_path

        now = time.time()
        for slot, job in enumerate(jobs):
            job.state = "packed"
            job.batch_id = batch_id
            job.slot = slot
            job.packed_t = now
            job.attempts += 1
            job.store = member_path(settings.output, slot, n_slots)
            if settings.checkpoint:
                job.checkpoint_store = member_path(
                    settings.checkpoint_output, slot, n_slots
                )
            self.events.emit(
                "job_packed", job=job.id, tenant=job.tenant,
                batch=batch_id, slot=slot, members=len(jobs),
                slots=n_slots,
            )
        self.metrics.histogram("serve_pack_members").observe(
            float(len(jobs))
        )
        return batch

    # ---------------------------------------------------------- requeue

    def requeue(self, batch: Batch, fault: str) -> None:
        """A worker died under this batch (or its launch failed with a
        classified-recoverable fault): hand the WHOLE batch back to the
        queue as a resume unit. The relaunching worker resumes every
        member from the member-store checkpoint quorum
        (``ensemble/io.restore_ensemble``) — or from scratch when no
        checkpoint exists yet; either way the member stores finish
        byte-identical to an uninterrupted run."""
        with self._cond:
            batch.attempt += 1
            # The chaos fault plan is consume-once at SERVICE level
            # (it modelled the worker that just died); a relaunch with
            # the plan still armed would re-kill itself forever.
            if getattr(batch.settings, "faults", ""):
                batch.settings.faults = ""
            for job in batch.jobs:
                job.state = "packed"
                job.attempts += 1
                self.events.emit(
                    "job_requeued", job=job.id, tenant=job.tenant,
                    batch=batch.id, fault=fault,
                    attempt=batch.attempt,
                )
            self.metrics.counter(
                "serve_batches_requeued", fault=fault
            ).inc()
            self._resume.append(batch)
            self._cond.notify_all()

    # --------------------------------------------------------- complete

    def complete(self, batch: Batch, *, ok: bool,
                 error: Optional[str] = None,
                 wall_s: Optional[float] = None) -> None:
        """Worker-reported batch outcome -> per-job terminal states +
        ``job_complete`` events."""
        with self._cond:
            now = time.time()
            for job in batch.jobs:
                job.state = "complete" if ok else "failed"
                job.error = None if ok else error
                job.finished_t = now
                if job.first_step_t is None and ok:
                    job.first_step_t = now
                self.events.emit(
                    "job_complete", job=job.id, tenant=job.tenant,
                    batch=batch.id,
                    status=job.state,
                    wall_s=(
                        round(wall_s, 3) if wall_s is not None else None
                    ),
                )
                if ok and job.first_step_t is not None:
                    self.metrics.histogram(
                        "serve_request_to_first_step_ms"
                    ).observe(
                        (job.first_step_t - job.submitted_t) * 1e3
                    )
            self.metrics.counter(
                "serve_batches_complete", ok=str(ok).lower()
            ).inc()
            self._cond.notify_all()
        if ok and self.cache is not None:
            # Publish OUTSIDE the lock: replication + the CRC audit are
            # store I/O, and admission must not stall behind them. A
            # job whose launch wrote no store (plotgap=0, no
            # checkpoints) simply isn't cacheable — publish declines
            # silently.
            for job in batch.jobs:
                if job.store:
                    self.cache.publish(
                        job.spec, job.store, job=job.id,
                        digest=job.digest,
                    )

    # ---------------------------------------------------------- elastic

    def queue_depth(self) -> int:
        """Current admitted-but-unpacked depth, refreshing the
        ``serve_queue_depth`` gauge as a side effect — the elastic
        controller (``serve/elastic.py``) polls this, so the gauge
        stays live even when no submit/cancel/pack mutation happens."""
        with self._cond:
            depth = len(self._queue)
            self.metrics.gauge("serve_queue_depth").set(depth)
            return depth

    def running_batches(self) -> List[Batch]:
        """Batches with at least one RUNNING member — the population
        the elastic policy may reshape (packed-but-unlaunched batches
        have no live state to move)."""
        with self._cond:
            return [
                b for b in self.batches.values()
                if any(j.state == "running" for j in b.jobs)
            ]

    def request_reshape(self, batch_id: str, req: dict) -> bool:
        """Post a live-reshape request against a RUNNING batch; the
        worker's between-rounds poll (:meth:`take_reshape`) consumes
        it. Latest-wins if one is already pending. False when the
        batch is unknown or has no running member."""
        with self._cond:
            batch = self.batches.get(batch_id)
            if batch is None or not any(
                j.state == "running" for j in batch.jobs
            ):
                return False
            batch.reshape_request = dict(req)
            self._cond.notify_all()
            return True

    def take_reshape(self, batch_id: str) -> Optional[dict]:
        """Consume-once pop of a pending reshape request (the worker's
        ``reshape_poll`` closure calls this between step rounds)."""
        with self._cond:
            batch = self.batches.get(batch_id)
            if batch is None or batch.reshape_request is None:
                return None
            req, batch.reshape_request = batch.reshape_request, None
            return req

    # ----------------------------------------------------------- status

    def status(self, job_id: str) -> Optional[dict]:
        with self._cond:
            # The depth gauge refreshes on the poll path too, so that a
            # poll-heavy idle service never reports a stale depth.
            self.metrics.gauge("serve_queue_depth").set(
                len(self._queue)
            )
            job = self.jobs.get(job_id)
            return None if job is None else job.describe()

    def drain(self) -> None:
        """Stop admitting; queued jobs stay queued for workers to
        finish. Submit rejects with ``shutting_down``."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def close(self) -> None:
        """Full teardown: drain + detach the event subscription. The
        fleet scheduler (``serve/cluster.py``) extends this with
        membership retirement; the server calls ``close`` uniformly."""
        self.drain()
        self.detach_events()

    def announce_endpoint(self, host: str, port: int) -> None:
        """Fleet replicas record their bound HTTP endpoint in the
        shared member doc (``ClusterScheduler``) so peers and
        launchers can discover ephemeral ports; the single-process
        scheduler has nobody to tell."""

    def idle(self) -> bool:
        """No queued work and no in-flight batches."""
        with self._cond:
            if self._queue or self._resume:
                return False
            return not any(
                j.state in ("packed", "running")
                for j in self.jobs.values()
            )

    def mark_degraded(self, reason: str = "") -> None:
        """Record that this process's devices are suspect (an SDC
        classification the supervisor could not recover in place,
        ``resilience/sdc.py``). The base scheduler only echoes it —
        with no peers there is nobody else to serve the queue."""
        self.degraded = reason or "degraded"
        self.events.emit("worker_degraded", reason=self.degraded)

    def describe(self) -> dict:
        with self._cond:
            states: Dict[str, int] = {}
            for j in self.jobs.values():
                states[j.state] = states.get(j.state, 0) + 1
            return {
                "queued": len(self._queue),
                "resume_batches": len(self._resume),
                "jobs": states,
                "batches": len(self.batches),
                "degraded": self.degraded,
                "config": self.cfg.describe(),
            }
