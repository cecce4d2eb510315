"""The distributed serve fleet: N front doors + M workers, one state
(counterpart of ``grayscott_jl_tpu/serve/cluster.py``).

The scheduler state moves into a shared filesystem KV namespace
(``GS_SERVE_FLEET_DIR``) built on the rendezvous publish primitive, so
ANY front-door replica can admit, route, status and fail over any job,
and ANY worker process can pull compatible work:

* **put** is :func:`~..resilience.rendezvous.atomic_publish` (tmp +
  fsync + rename): readers see whole documents or nothing;
* **claim** is ``O_EXCL`` create: exactly one creator wins;
* **take** is ``os.rename``: exactly one mover wins — the primitive
  under queue pops, lease expiry and resume adoption.

Namespace layout (all under the fleet dir), the reference's file for
file, so that either package reads the other's documents::

    members/<id>       role, pid, host:port, last heartbeat
    jobs/<id>          the full job document (spec + lifecycle)
    queue/<qkey>       pending-job markers; qkey sorts priority->FIFO
    claims/<id>/<qkey> claim-to-lease crash window markers
    leases/<batch>     running batch -> owning worker + expiry
    resume/<batch>     requeued batch awaiting re-adoption
    reshape/<batch>    a pending live-reshape request (the relay)
    quarantine/<dev>   a device the SDC screen quarantined, fleet-wide
    batches/<batch>/   the launch dirs (stores live here, shared FS)

**Fail-over.** A worker heartbeats its member doc and renews its batch
leases every ``GS_SERVE_HEARTBEAT_S``; when it dies, whichever
front-door replica's reaper first notices the expired lease takes it
and converts it into a ``resume/`` entry — the next free worker adopts
the batch and resumes from the member-store checkpoint quorum, exactly
the single-process requeue path. A worker that wedges past its lease
and then wakes can at worst run a batch twice; runs are bitwise
deterministic, so the duplicate writes the same bytes.

**Ids.** Job and batch ids carry a per-process nonce
(``j<nonce>-<seq>``), so replicas never mint colliding ids.

**Events.** Fleet members are separate processes, so each arms its own
``GS_EVENTS`` ``.rank<N>`` file (:func:`~..obs.events.arm_events`,
``GS_SERVE_FLEET_RANK``) and the readers' ``rank_files`` merge
(``obs/report.py``) tells one fleet-wide story.

**Processes on one card.** A worker process on the card opens its own
CUDA context; several worker processes may share ``cuda:0``.

This module imports neither torch nor JAX itself.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional

from ..resilience.rendezvous import atomic_publish
from ..utils.log import Logger
from . import protocol
from .scheduler import (
    AdmissionError,
    Batch,
    Job,
    Scheduler,
    ServeConfig,
)

__all__ = ["ClusterScheduler", "FleetKV", "arm_fleet_events",
           "resolve_fleet_events_path", "worker_main"]


def resolve_fleet_events_path(cfg: ServeConfig) -> str:
    """This member's own event-stream file: the fleet's shared logical
    path (``GS_EVENTS``, defaulting to ``<fleet_dir>/events.jsonl``)
    suffixed ``.rank<fleet_rank>`` — the writer-side half of the
    multi-rank merge every reader already does."""
    from ..config.env import env_str

    base = env_str("GS_EVENTS", "")
    if base.endswith(f".rank{cfg.fleet_rank}"):
        # Already armed (idempotent re-entry).
        base = base[: -len(f".rank{cfg.fleet_rank}")]
    if not base:
        base = os.path.join(cfg.fleet_dir, "events.jsonl")
    return f"{base}.rank{cfg.fleet_rank}"


def arm_fleet_events(cfg: ServeConfig):
    """Point this process's event singleton at its own ``.rank<N>``
    file with the fleet rank as the ``proc`` id
    (:func:`~..obs.events.arm_events`)."""
    from ..obs import events as obs_events

    return obs_events.arm_events(
        resolve_fleet_events_path(cfg), proc=cfg.fleet_rank
    )


class FleetKV:
    """The shared-directory KV namespace (docstring above): atomic
    whole-document puts, torn-tolerant gets, exclusive claims and
    takes. Keys are ``/``-separated paths; every segment is a plain
    filename."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, *key.split("/"))

    def put(self, key: str, doc: dict) -> None:
        """Last-writer-wins whole-document publish."""
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        atomic_publish(path, json.dumps(doc, sort_keys=True))

    def get(self, key: str) -> Optional[dict]:
        """The document, or None (missing, or mid-replace — the next
        read sees it)."""
        try:
            with open(self._path(key), encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        return doc if isinstance(doc, dict) else None

    def keys(self, prefix: str) -> List[str]:
        """Immediate child keys under ``prefix``, name-sorted (the
        queue's priority->FIFO order is encoded in the names)."""
        try:
            names = os.listdir(self._path(prefix))
        except OSError:
            return []
        return sorted(n for n in names if ".tmp." not in n)

    def claim(self, key: str, doc: dict) -> bool:
        """Create-exclusive: True for exactly one caller."""
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(json.dumps(doc, sort_keys=True))
        return True

    def take(self, src: str, dst: str) -> bool:
        """Atomically move ``src`` to ``dst``: True for exactly one
        caller (the losers' rename raises FileNotFoundError)."""
        dpath = self._path(dst)
        os.makedirs(os.path.dirname(dpath), exist_ok=True)
        try:
            os.rename(self._path(src), dpath)
        except OSError:
            return False
        return True

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except OSError:
            pass


class _JobsView:
    """Duck-typed stand-in for the in-memory ``Scheduler.jobs`` dict:
    the HTTP handlers only ever call ``.get`` — here it reconstructs a
    fresh :class:`Job` from the shared job document, so ANY replica
    can answer status/result/SSE for a job another replica admitted."""

    def __init__(self, sched: "ClusterScheduler"):
        self._sched = sched

    def get(self, job_id: str) -> Optional[Job]:
        return self._sched._load_job(job_id)


class ClusterScheduler(Scheduler):
    """The fleet-wide scheduler: same interface as
    :class:`~.scheduler.Scheduler` (the HTTP handler and
    :class:`~.worker.WorkerFleet` cannot tell them apart), state in
    the shared :class:`FleetKV` instead of process memory."""

    def __init__(self, cfg: ServeConfig, *, role: str = "frontdoor",
                 events=None, metrics=None, log: Optional[Logger] = None):
        if not cfg.fleet_dir:
            raise ValueError(
                "ClusterScheduler needs GS_SERVE_FLEET_DIR (the shared "
                "fleet state directory)"
            )
        super().__init__(cfg, events=events, metrics=metrics)
        self.role = role
        self.log = log or Logger(verbose=False)
        self._kv = FleetKV(cfg.fleet_dir)
        self.member_id = (
            cfg.replica or f"{role}{cfg.fleet_rank}-{self._nonce}"
        )
        #: Batches THIS process launched and still leases.
        self._held: Dict[str, Batch] = {}
        self._member_doc = {
            "member": self.member_id, "role": role, "pid": os.getpid(),
            "host": socket.gethostname(), "port": None,
            "degraded": None,
            "t": time.time(),
        }
        self._kv.put(f"members/{self.member_id}", self._member_doc)
        self.events.emit(
            "worker_join", worker=self.member_id, role=role,
        )
        self.metrics.counter("serve_fleet_joins", role=role).inc()
        self._bg_stop = threading.Event()
        self._bg: List[threading.Thread] = []
        self._start_thread(self._heartbeat_loop, "gs-fleet-heartbeat")
        if role == "frontdoor":
            self._start_thread(self._reaper_loop, "gs-fleet-reaper")
        self.jobs = _JobsView(self)  # type: ignore[assignment]

    def _start_thread(self, target, name: str) -> None:
        t = threading.Thread(target=target, name=name, daemon=True)
        t.start()
        self._bg.append(t)

    # -------------------------------------------------------- documents

    def _write_job(self, job: Job, **extra) -> None:
        doc = {
            "job": job.id, "tenant": job.tenant,
            "spec": job.spec.describe(), "state": job.state,
            "seq": job.seq, "batch": job.batch_id, "slot": job.slot,
            "attempts": job.attempts, "error": job.error,
            "submitted_t": job.submitted_t, "packed_t": job.packed_t,
            "started_t": job.started_t,
            "first_step_t": job.first_step_t,
            "finished_t": job.finished_t, "store": job.store,
            "checkpoint_store": job.checkpoint_store,
            "digest": job.digest, "cache": job.cache,
            **extra,
        }
        self._kv.put(f"jobs/{job.id}", doc)

    def _load_job(self, job_id: str) -> Optional[Job]:
        doc = self._kv.get(f"jobs/{job_id}")
        if doc is None:
            return None
        try:
            spec = protocol.parse_job(
                doc["spec"], max_l=self.cfg.max_l,
                max_steps=self.cfg.max_steps,
            )
        except Exception:  # noqa: BLE001 — torn/foreign doc: not a job
            return None
        return Job(
            id=doc["job"], tenant=doc["tenant"], spec=spec,
            state=doc.get("state", "queued"), seq=doc.get("seq", 0),
            batch_id=doc.get("batch"), slot=doc.get("slot"),
            attempts=doc.get("attempts", 0), error=doc.get("error"),
            submitted_t=doc.get("submitted_t", 0.0),
            packed_t=doc.get("packed_t"),
            started_t=doc.get("started_t"),
            first_step_t=doc.get("first_step_t"),
            finished_t=doc.get("finished_t"),
            store=doc.get("store"),
            checkpoint_store=doc.get("checkpoint_store"),
            digest=doc.get("digest"), cache=doc.get("cache"),
        )

    # ----------------------------------------------------------- submit

    def submit(self, payload) -> Job:
        from . import cache as cache_mod

        spec = protocol.parse_job(
            payload, max_l=self.cfg.max_l, max_steps=self.cfg.max_steps
        )
        digest = cached = None
        if self.cache is not None:
            digest = cache_mod.job_digest(spec, backend=self.cfg.backend)
            cached = self.cache.lookup(digest)
        with self._cond:
            self._seq += 1
            seq = self._seq
        job = Job(
            id=f"j{self._nonce}-{seq:05d}", tenant=spec.tenant,
            spec=spec, seq=seq, submitted_t=time.time(), digest=digest,
        )
        if cached is not None and not self._closed:
            now = time.time()
            job.cache = "hit"
            job.state = "complete"
            job.store = cached["store"]
            job.first_step_t = job.finished_t = now
            self._write_job(job)
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
            return job
        reason = self._admission_reason(job)
        if reason is not None:
            job.state = "rejected"
            job.error = reason
            job.finished_t = time.time()
            self._write_job(job)
            self.metrics.counter(
                "serve_jobs_rejected", reason=reason
            ).inc()
            self.events.emit(
                "job_rejected", job=job.id, tenant=job.tenant,
                reason=reason,
            )
            raise AdmissionError(job, reason)
        # Queue marker name: priority digit (inverted so lexicographic
        # = highest first), then admission nanotime, then the id — the
        # fleet-wide analogue of the in-memory (-priority, seq) sort.
        qkey = (
            f"p{9 - spec.priority}-{time.time_ns():020d}-{job.id}"
        )
        if self.cache is not None:
            job.cache = "miss"
        self._write_job(job, qkey=qkey)
        self._kv.put(f"queue/{qkey}", {"job": job.id, "t": time.time()})
        self.metrics.counter("serve_jobs_submitted").inc()
        self.events.emit(
            "job_submitted", job=job.id, tenant=job.tenant,
            priority=spec.priority, model=spec.model, L=spec.L,
            steps=spec.steps,
        )
        if self.cache is not None:
            self.metrics.counter("serve_cache_misses").inc()
            self.events.emit(
                "cache_miss", digest=digest, job=job.id,
                tenant=job.tenant,
            )
        return job

    def _admission_reason(self, job: Job) -> Optional[str]:
        if self._closed:
            return "shutting_down"
        if len(self._kv.keys("queue")) >= self.cfg.queue_depth:
            return "queue_full"
        live = 0
        for jid in self._kv.keys("jobs"):
            doc = self._kv.get(f"jobs/{jid}")
            if (doc and doc.get("tenant") == job.tenant
                    and doc.get("state") in ("queued", "packed",
                                             "running")):
                live += 1
        if live >= self.cfg.tenant_quota:
            return "tenant_quota"
        return None

    # ----------------------------------------------------------- cancel

    def cancel(self, job_id: str) -> bool:
        doc = self._kv.get(f"jobs/{job_id}")
        if doc is None or doc.get("state") != "queued":
            return False
        qkey = doc.get("qkey")
        if not qkey or not self._kv.take(
            f"queue/{qkey}", f"cancelled/{qkey}"
        ):
            return False  # a worker won the marker: committed
        self._kv.delete(f"cancelled/{qkey}")
        job = self._load_job(job_id)
        if job is None:
            return False
        job.state = "cancelled"
        job.finished_t = time.time()
        self._write_job(job)
        self.events.emit(
            "job_complete", job=job.id, tenant=job.tenant,
            status="cancelled",
        )
        return True

    # ------------------------------------------------------------- pack

    def next_batch(self, timeout: float = 0.5) -> Optional[Batch]:
        deadline = time.monotonic() + max(timeout, 0.0)
        while True:
            batch = self._adopt_resume()
            if batch is not None:
                return batch
            batch = self._claim_fresh()
            if batch is not None:
                return batch
            if time.monotonic() >= deadline or self._closed:
                return None
            time.sleep(0.05)

    def _adopt_resume(self) -> Optional[Batch]:
        if self.degraded:
            return None
        for bid in self._kv.keys("resume"):
            doc = self._kv.get(f"resume/{bid}")
            if doc is None:
                continue
            if not self._kv.take(f"resume/{bid}", f"leases/{bid}"):
                continue  # another worker adopted it first
            # Exclusive owner now — overwrite the moved marker with a
            # real lease before anything else, so a crash right here
            # still expires into another failover.
            batch = self._rebuild_batch(doc)
            if batch is None:
                # Unreconstructable right now (torn docs mid-publish):
                # hand the entry back for a later retry.
                self._kv.take(f"leases/{bid}", f"resume/{bid}")
                continue
            self._lease(batch)
            return batch
        return None

    def mark_degraded(self, reason: str = "") -> None:
        """Cluster form: publish the degraded flag in this member's
        doc (the heartbeat keeps republishing it) and stop claiming
        work — healthy fleet peers drain the queue instead. Leased
        batches this member already holds stay leased; a crash expires
        them into the normal failover."""
        super().mark_degraded(reason)
        self._member_doc["degraded"] = self.degraded
        self._kv.put(f"members/{self.member_id}", self._member_doc)

    def _claim_fresh(self) -> Optional[Batch]:
        if self.degraded:
            # Suspect compute must not claim fresh work (or adopt a
            # peer's failover — next_batch checks there too): the
            # queue drains through healthy members.
            return None
        head_doc = head_qkey = None
        for qkey in self._kv.keys("queue"):
            marker = self._kv.get(f"queue/{qkey}")
            if marker is None:
                continue
            if self._kv.take(
                f"queue/{qkey}", f"claims/{self.member_id}/{qkey}"
            ):
                head_doc, head_qkey = marker, qkey
                break
        if head_doc is None:
            return None
        claimed = [(head_qkey, head_doc["job"])]
        head = self._load_job(head_doc["job"])
        if head is None:
            self._kv.delete(f"claims/{self.member_id}/{head_qkey}")
            return None
        key = protocol.pack_key(head.spec)
        window_end = time.monotonic() + self.cfg.pack_window_s
        while len(claimed) < self.cfg.pack_max:
            grabbed = False
            for qkey in self._kv.keys("queue"):
                if len(claimed) >= self.cfg.pack_max:
                    break
                marker = self._kv.get(f"queue/{qkey}")
                if marker is None:
                    continue
                job = self._load_job(marker["job"])
                if job is None or protocol.pack_key(job.spec) != key:
                    continue
                if self._kv.take(
                    f"queue/{qkey}", f"claims/{self.member_id}/{qkey}"
                ):
                    claimed.append((qkey, marker["job"]))
                    grabbed = True
            if len(claimed) >= self.cfg.pack_max:
                break
            remaining = window_end - time.monotonic()
            if remaining <= 0:
                break
            if not grabbed:
                time.sleep(min(0.05, remaining))
        jobs = [j for _, jid in claimed
                if (j := self._load_job(jid)) is not None]
        batch = self._build_cluster_batch(jobs, key)
        self._lease(batch)
        for qkey, _ in claimed:
            self._kv.delete(f"claims/{self.member_id}/{qkey}")
        return batch

    def _batch_dir(self, batch_id: str) -> str:
        return os.path.join(self._kv.root, "batches", batch_id)

    def _build_cluster_batch(self, jobs: List[Job], key) -> Batch:
        from ..ensemble.io import member_path
        from .scheduler import _pow2_slots

        with self._cond:
            self._batch_seq += 1
            seq = self._batch_seq
        batch_id = f"b{self._nonce}-{seq:04d}"
        n_slots = _pow2_slots(len(jobs), self.cfg.pack_max)
        bdir = self._batch_dir(batch_id)
        os.makedirs(bdir, exist_ok=True)
        settings = protocol.batch_settings(
            [j.spec for j in jobs], n_slots=n_slots,
            output=os.path.join(bdir, "gs.bp"),
            checkpoint_output=os.path.join(bdir, "ckpt.bp"),
            names=[j.id for j in jobs], supervise=self.cfg.supervise,
            backend=self.cfg.backend,
        )
        batch = Batch(
            id=batch_id, jobs=jobs, key=key, n_slots=n_slots,
            settings=settings, dir=bdir, supervise=self.cfg.supervise,
            created_t=time.time(),
        )
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
            self._write_job(job)
            self.events.emit(
                "job_packed", job=job.id, tenant=job.tenant,
                batch=batch_id, slot=slot, members=len(jobs),
                slots=n_slots,
            )
        self.metrics.histogram("serve_pack_members").observe(
            float(len(jobs))
        )
        return batch

    def _rebuild_batch(self, resume_doc: dict) -> Optional[Batch]:
        """A resume entry (another worker's failed lease) back into a
        launchable :class:`Batch` — spec truth comes from the shared
        job docs, the launch dir is the original one (shared FS), so
        the checkpoint-quorum resume path is exactly the in-process
        requeue."""
        jobs = [j for jid in resume_doc.get("jobs", [])
                if (j := self._load_job(jid)) is not None]
        if not jobs:
            return None
        try:
            settings = protocol.batch_settings(
                [j.spec for j in jobs],
                n_slots=int(resume_doc["n_slots"]),
                output=os.path.join(resume_doc["dir"], "gs.bp"),
                checkpoint_output=os.path.join(
                    resume_doc["dir"], "ckpt.bp"
                ),
                names=[j.id for j in jobs],
                supervise=self.cfg.supervise,
                backend=self.cfg.backend,
            )
        except Exception:  # noqa: BLE001 — torn docs
            return None
        return Batch(
            id=resume_doc["batch"], jobs=jobs,
            key=protocol.pack_key(jobs[0].spec),
            n_slots=int(resume_doc["n_slots"]), settings=settings,
            dir=resume_doc["dir"], supervise=self.cfg.supervise,
            attempt=int(resume_doc.get("attempt", 1)),
            created_t=time.time(),
        )

    def _lease(self, batch: Batch) -> None:
        self._held[batch.id] = batch
        self._kv.put(f"leases/{batch.id}", {
            "batch": batch.id, "worker": self.member_id,
            "jobs": batch.job_ids, "attempt": batch.attempt,
            "dir": batch.dir, "n_slots": batch.n_slots,
            "expires_t": time.time() + self.cfg.lease_ttl_s,
        })

    # ---------------------------------------------------------- requeue

    def requeue(self, batch: Batch, fault: str) -> None:
        batch.attempt += 1
        if getattr(batch.settings, "faults", ""):
            batch.settings.faults = ""
        for job in batch.jobs:
            job.state = "packed"
            job.attempts += 1
            self._write_job(job)
            self.events.emit(
                "job_requeued", job=job.id, tenant=job.tenant,
                batch=batch.id, fault=fault, attempt=batch.attempt,
            )
        self._held.pop(batch.id, None)
        self._kv.delete(f"leases/{batch.id}")
        # A pending reshape request targeted live state that no longer
        # exists; the relaunch restores from the checkpoint quorum on
        # whatever mesh it starts with.
        self._kv.delete(f"reshape/{batch.id}")
        self._kv.put(f"resume/{batch.id}", {
            "batch": batch.id, "jobs": batch.job_ids,
            "attempt": batch.attempt, "dir": batch.dir,
            "n_slots": batch.n_slots,
        })
        self.metrics.counter(
            "serve_batches_requeued", fault=fault
        ).inc()

    # --------------------------------------------------------- complete

    def complete(self, batch: Batch, *, ok: bool,
                 error: Optional[str] = None,
                 wall_s: Optional[float] = None) -> None:
        now = time.time()
        for job in batch.jobs:
            job.state = "complete" if ok else "failed"
            job.error = None if ok else error
            job.finished_t = now
            if job.first_step_t is None and ok:
                job.first_step_t = now
            self._write_job(job)
            self.events.emit(
                "job_complete", job=job.id, tenant=job.tenant,
                batch=batch.id, status=job.state,
                wall_s=round(wall_s, 3) if wall_s is not None else None,
            )
            if ok and job.first_step_t is not None:
                self.metrics.histogram(
                    "serve_request_to_first_step_ms"
                ).observe((job.first_step_t - job.submitted_t) * 1e3)
        self._held.pop(batch.id, None)
        self._kv.delete(f"leases/{batch.id}")
        self._kv.delete(f"reshape/{batch.id}")
        self.metrics.counter(
            "serve_batches_complete", ok=str(ok).lower()
        ).inc()
        if ok and self.cache is not None:
            for job in batch.jobs:
                if job.store:
                    self.cache.publish(
                        job.spec, job.store, job=job.id,
                        digest=job.digest,
                    )

    # ----------------------------------------------------- run tracking

    def _on_event(self, record: dict) -> None:
        """Write the launch's progress through to the shared job docs
        (run_start -> running, first output/checkpoint -> first-step
        mark) for batches THIS process holds — other replicas read the
        docs, not this process's stream."""
        kind = record.get("kind")
        if kind not in ("run_start", "output", "checkpoint",
                        "run_complete"):
            return
        batch_id = (record.get("attrs") or {}).get("batch")
        if not batch_id:
            return
        batch = self._held.get(batch_id)
        if batch is None:
            return
        ts = record.get("ts") or time.time()
        for job in batch.jobs:
            if kind == "run_start" and job.state == "packed":
                job.state = "running"
                job.started_t = job.started_t or ts
                self._write_job(job)
            elif kind in ("output", "checkpoint", "run_complete"):
                if job.first_step_t is None and job.state in (
                    "packed", "running",
                ):
                    job.first_step_t = ts
                    self._write_job(job)

    # ------------------------------------------------------- background

    def _heartbeat_loop(self) -> None:
        """Every member: refresh the member doc; workers additionally
        renew their held leases — a live worker's lease never
        expires."""
        while not self._bg_stop.wait(self.cfg.heartbeat_s):
            self._member_doc["t"] = time.time()
            self._kv.put(
                f"members/{self.member_id}", self._member_doc
            )
            for batch in list(self._held.values()):
                lease = self._kv.get(f"leases/{batch.id}")
                if lease is None or lease.get("worker") != (
                    self.member_id
                ):
                    # Reaped out from under us (we stalled past the
                    # TTL): the batch now belongs to the fleet; let
                    # our duplicate run finish — deterministic bytes —
                    # but stop renewing.
                    self._held.pop(batch.id, None)
                    continue
                lease["expires_t"] = (
                    time.time() + self.cfg.lease_ttl_s
                )
                self._kv.put(f"leases/{batch.id}", lease)

    def _reaper_loop(self) -> None:
        """Front-door replicas: notice dead members (stale heartbeat),
        expired leases (dead worker mid-batch -> resume entry), and
        orphaned claims (dead worker between claim and lease ->
        re-enqueue). Every action is a take/claim — N replicas race,
        exactly one acts."""
        while not self._bg_stop.wait(self.cfg.heartbeat_s):
            now = time.time()
            try:
                self._reap_members(now)
                self._reap_leases(now)
                self._reap_claims(now)
            except Exception as e:  # noqa: BLE001 — reaper must survive
                self.log.warn(f"fleet reaper: {type(e).__name__}: {e}")

    def _reap_members(self, now: float) -> None:
        for mid in self._kv.keys("members"):
            doc = self._kv.get(f"members/{mid}")
            if doc is None or mid == self.member_id:
                continue
            if now - doc.get("t", 0) <= self.cfg.lease_ttl_s:
                continue
            if self._kv.take(f"members/{mid}", f"lost/{mid}"):
                self._kv.delete(f"lost/{mid}")
                self.events.emit("worker_lost", worker=mid)
                self.metrics.counter("serve_fleet_losses").inc()

    def _reap_leases(self, now: float) -> None:
        for bid in self._kv.keys("leases"):
            lease = self._kv.get(f"leases/{bid}")
            if lease is None or now <= lease.get("expires_t", 0):
                continue
            if not self._kv.take(
                f"leases/{bid}", f"reaped/{bid}"
            ):
                continue  # another replica noticed first
            self._kv.delete(f"reaped/{bid}")
            # Any in-flight reshape request dies with the worker: the
            # live state it addressed is gone, and the failover restore
            # is byte-identical without it.
            self._kv.delete(f"reshape/{bid}")
            attempt = int(lease.get("attempt", 0)) + 1
            dead_worker = lease.get("worker", "?")
            if attempt > self.cfg.max_requeues:
                # The batch has burned its fail-over budget: terminal.
                for jid in lease.get("jobs", []):
                    job = self._load_job(jid)
                    if job is None or job.state in (
                        "complete", "failed", "cancelled",
                    ):
                        continue
                    job.state = "failed"
                    job.error = (
                        f"worker {dead_worker} lost; requeue budget "
                        "exhausted"
                    )
                    job.finished_t = time.time()
                    self._write_job(job)
                    self.events.emit(
                        "job_complete", job=job.id, tenant=job.tenant,
                        batch=bid, status="failed",
                    )
                continue
            for jid in lease.get("jobs", []):
                job = self._load_job(jid)
                if job is None:
                    continue
                job.state = "packed"
                job.attempts += 1
                self._write_job(job)
                self.events.emit(
                    "job_failover", job=job.id, tenant=job.tenant,
                    batch=bid, worker=dead_worker,
                )
            self._kv.put(f"resume/{bid}", {
                "batch": bid, "jobs": lease.get("jobs", []),
                "attempt": attempt, "dir": lease.get("dir"),
                "n_slots": int(lease.get("n_slots", 1)),
            })
            self.metrics.counter("serve_fleet_failovers").inc()

    def _reap_claims(self, now: float) -> None:
        for mid in self._kv.keys("claims"):
            if self._kv.get(f"members/{mid}") is not None:
                continue  # claimant is alive; mid-pack is normal
            for qkey in self._kv.keys(f"claims/{mid}"):
                marker = self._kv.get(f"claims/{mid}/{qkey}")
                if marker is None:
                    continue
                if now - marker.get("t", now) <= self.cfg.lease_ttl_s:
                    continue
                if self._kv.take(
                    f"claims/{mid}/{qkey}", f"queue/{qkey}"
                ):
                    self.log.warn(
                        f"fleet reaper: re-enqueued orphaned claim "
                        f"{qkey} of dead member {mid}"
                    )

    # ---------------------------------------------------------- elastic

    def queue_depth(self) -> int:
        depth = len(self._kv.keys("queue"))
        self.metrics.gauge("serve_queue_depth").set(depth)
        return depth

    def running_batches(self) -> List[Batch]:
        """Every leased batch with a RUNNING member, fleet-wide: held
        launches directly, other members' through the shared job docs
        (a front-door elastic controller steers workers it never
        launched)."""
        out: List[Batch] = []
        for bid in self._kv.keys("leases"):
            lease = self._kv.get(f"leases/{bid}")
            if lease is None:
                continue
            held = self._held.get(bid)
            if held is not None:
                if any(j.state == "running" for j in held.jobs):
                    out.append(held)
                continue
            jobs = [j for jid in lease.get("jobs", [])
                    if (j := self._load_job(jid)) is not None]
            if not any(j.state == "running" for j in jobs):
                continue
            out.append(Batch(
                id=bid, jobs=jobs, key=(),
                n_slots=int(lease.get("n_slots", 1)), settings=None,
                dir=lease.get("dir") or "",
                created_t=float(
                    lease.get("expires_t", time.time())
                ) - self.cfg.lease_ttl_s,
            ))
        return out

    def request_reshape(self, batch_id: str, req: dict) -> bool:
        """Publish the request as a ``reshape/<batch>`` KV doc; the
        LEASING member's worker consumes it (:meth:`take_reshape`)
        at its next between-rounds poll — the relay that lets any
        replica steer any worker's live mesh. Latest-wins."""
        if self._kv.get(f"leases/{batch_id}") is None:
            return False
        self._kv.put(f"reshape/{batch_id}", {
            "batch": batch_id, "req": dict(req),
            "by": self.member_id, "t": time.time(),
        })
        return True

    def take_reshape(self, batch_id: str) -> Optional[dict]:
        taken = f"reshape-taken/{self.member_id}-{batch_id}"
        if not self._kv.take(f"reshape/{batch_id}", taken):
            return None
        doc = self._kv.get(taken)
        self._kv.delete(taken)
        req = (doc or {}).get("req")
        return req if isinstance(req, dict) else None

    # ----------------------------------------------------------- status

    def announce_endpoint(self, host: str, port: int) -> None:
        """Record the bound HTTP endpoint in the member doc — how
        launchers and tests discover a replica's ephemeral port."""
        self._member_doc["host"] = host
        self._member_doc["port"] = int(port)
        self._kv.put(f"members/{self.member_id}", self._member_doc)

    def status(self, job_id: str) -> Optional[dict]:
        job = self._load_job(job_id)
        return None if job is None else job.describe()

    def idle(self) -> bool:
        if (self._kv.keys("queue") or self._kv.keys("resume")
                or self._kv.keys("leases")):
            return False
        return not any(
            self._kv.keys(f"claims/{m}")
            for m in self._kv.keys("claims")
        )

    def describe(self) -> dict:
        members = {}
        for mid in self._kv.keys("members"):
            doc = self._kv.get(f"members/{mid}")
            if doc:
                members[mid] = {
                    "role": doc.get("role"), "port": doc.get("port"),
                }
        return {
            "member": self.member_id,
            "role": self.role,
            "queued": len(self._kv.keys("queue")),
            "resume_batches": len(self._kv.keys("resume")),
            "leases": len(self._kv.keys("leases")),
            "members": members,
            "config": self.cfg.describe(),
        }

    def close(self) -> None:
        self.drain()
        self._bg_stop.set()
        for t in self._bg:
            t.join(self.cfg.heartbeat_s + 1.0)
        self._kv.delete(f"members/{self.member_id}")
        self.detach_events()


def worker_main(argv=None, *, backend: Optional[str] = None) -> int:
    """Entry point of a pure fleet worker process (``python -m
    grayscott_jl_tpu_torch.serve --role worker``): no HTTP server — a
    :class:`ClusterScheduler` in worker role and a
    :class:`~.worker.WorkerFleet` draining the shared queue until
    SIGTERM/SIGINT. ``backend`` (else ``--backend`` in ``argv``) picks
    where its batches run."""
    import signal

    from .scheduler import resolve_serve_config
    from .server import check_backend, parse_args
    from .worker import WorkerFleet

    if backend is None:
        backend = parse_args(list(argv or []) + ["--role", "worker"]).backend
    cfg = resolve_serve_config()
    cfg.backend = backend
    if not cfg.fleet_dir:
        raise SystemExit("gs-serve worker role needs GS_SERVE_FLEET_DIR")
    if cfg.workers < 1:
        raise SystemExit("gs-serve worker role needs GS_SERVE_WORKERS >= 1")
    check_backend(cfg.backend)
    arm_fleet_events(cfg)
    log = Logger(verbose=True)
    sched = ClusterScheduler(cfg, role="worker", log=log)
    sched.attach_events()
    fleet = WorkerFleet(sched, cfg, log=log)
    from .elastic import ElasticController

    elastic = ElasticController(sched, fleet, log=log)
    stop = threading.Event()

    def _request_stop(signum, frame):  # noqa: ARG001
        stop.set()

    signal.signal(signal.SIGTERM, _request_stop)
    signal.signal(signal.SIGINT, _request_stop)
    fleet.start()
    elastic.start()
    log.info(
        f"gs-serve worker {sched.member_id}: draining fleet "
        f"{cfg.fleet_dir} ({cfg.workers} thread(s), {cfg.backend})"
    )
    try:
        while not stop.is_set():
            stop.wait(0.5)
    finally:
        elastic.close()
        fleet.stop()
        sched.close()
        log.info(f"gs-serve worker {sched.member_id}: bye")
    return 0
