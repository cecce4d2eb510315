"""Content-addressed result cache: a JobSpec digest IS its trajectory
(counterpart of ``grayscott_jl_tpu/serve/cache.py``).

Runs are bitwise deterministic — a packed member's store is
byte-identical to the solo run of the same spec, across restarts,
requeues and pack factors — so a finished trajectory is fully determined
by the spec fields that shape its bytes, and a repeated request is a
store READ, not a launch.

:func:`canonical_spec` fixes the identity: model, resolved member
parameters (defaults filled, canonically ordered, floats spelled as
``float.hex()``), seed, L, steps, the output/checkpoint cadence,
precision and the resolved compute-precision posture, halo_depth, and
the snapshot-codec posture. Deliberately excluded: tenant and priority.

The digest names the bytes THIS environment writes (the reference's
rule). A store the card's kernel computed need not be bitwise equal to
one from the host's plain path, so a service on the card adds one key,
``"device": "cuda"``; on the CPU the document and the digest equal the
reference's byte for byte.

:class:`ResultCache` maps ``digest -> finished store`` through the
shared filesystem: **publish** (batch completion) verifies the store's
CRC sidecars, mirrors it per ``GS_CKPT_REPLICAS`` and records the entry
atomically; **lookup** (admission) re-verifies the artifact before
vouching for it (``GS_CACHE_VERIFY``), fails over to an on-disk mirror,
and degrades to a miss — a fresh launch — when every copy is corrupt.

This module imports neither torch nor JAX itself.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from types import SimpleNamespace
from typing import Optional

from ..config.env import env_flag, env_str
from ..config.settings import resolve_compute_precision
from ..io.codec import resolve_snapshot_codec
from ..models import get_model
from ..resilience.integrity import (
    CorruptionError,
    _existing_replicas,
    replicate_store,
    verify_store,
)
from . import protocol

__all__ = [
    "ResultCache",
    "canonical_spec",
    "job_digest",
    "resolve_cache_dir",
    "resolve_cache_enabled",
    "resolve_cache_verify",
]


def resolve_cache_enabled() -> bool:
    """``GS_SERVE_CACHE`` — serve the result cache (default on)."""
    return env_flag("GS_SERVE_CACHE", True)


def resolve_cache_dir(default: str = "") -> str:
    """``GS_CACHE_DIR`` — the cache root; empty defers to the
    scheduler's default (``<state_dir>/cache``, or the shared
    ``<fleet_dir>/cache`` for fleet members)."""
    return env_str("GS_CACHE_DIR", default)


def resolve_cache_verify() -> bool:
    """``GS_CACHE_VERIFY`` — CRC-verify cached artifacts at lookup time
    (default on)."""
    return env_flag("GS_CACHE_VERIFY", True)


def canonical_spec(spec: protocol.JobSpec, *,
                   backend: str = "CUDA") -> dict:
    """The identity document of one job — every field that determines
    the finished store's bytes, spelled canonically (floats through
    ``float.hex()``; parameters default-filled and ordered by
    :func:`~.protocol.resolved_params`; postures through the resolvers
    the worker's launch uses). ``backend`` is the service's: on the
    card the document carries ``"device": "cuda"``; on the CPU it is
    the reference's document."""
    model = get_model(spec.model)
    stub = SimpleNamespace(compute_precision="", precision=spec.precision)
    doc = {
        "v": 1,
        "model": spec.model,
        "L": spec.L,
        "steps": spec.steps,
        "plotgap": spec.plotgap,
        "checkpoint_freq": spec.checkpoint_freq,
        "precision": spec.precision,
        "halo_depth": spec.halo_depth,
        "seed": spec.seed,
        "params": [
            [name, float(value).hex()]
            for name, value in protocol.resolved_params(spec)
        ],
        "compute_precision": resolve_compute_precision(stub),
        "snapshot_codec": resolve_snapshot_codec(
            stub, model.field_names
        ).posture(),
    }
    if backend == "CUDA":
        doc["device"] = "cuda"
    return doc


def job_digest(spec: protocol.JobSpec, *, backend: str = "CUDA") -> str:
    """sha256 of the canonical spec document (sorted keys, no
    whitespace) — the cache key."""
    blob = json.dumps(
        canonical_spec(spec, backend=backend), sort_keys=True,
        separators=(",", ":"),
    )
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


class ResultCache:
    """``digest -> finished member store`` over a (possibly shared)
    directory tree.

    Entries live at ``<root>/<digest[:2]>/<digest>.json`` and are
    published atomically. ``verifier`` is injectable for tests (default:
    the CRC audit :func:`~..resilience.integrity.verify_store`);
    ``backend`` is the service's, for a publish that names no digest.
    """

    def __init__(self, root: str, *, events=None, metrics=None,
                 verify: bool = True, verifier=None,
                 backend: str = "CUDA"):
        self.root = root
        if events is None:
            from ..obs import events as obs_events

            events = obs_events.get_events()
        if metrics is None:
            from ..obs import metrics as obs_metrics

            metrics = obs_metrics.get_metrics()
        self.events = events
        self.metrics = metrics
        self.verify = bool(verify)
        self.backend = backend
        self._verifier = verifier if verifier is not None else verify_store
        os.makedirs(root, exist_ok=True)

    # --------------------------------------------------------- entries

    def entry_path(self, digest: str) -> str:
        return os.path.join(self.root, digest[:2], f"{digest}.json")

    def _read_entry(self, digest: str) -> Optional[dict]:
        try:
            with open(self.entry_path(digest), encoding="utf-8") as f:
                entry = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        return entry if isinstance(entry, dict) else None

    # --------------------------------------------------------- publish

    def publish(self, spec: protocol.JobSpec, store: str, *,
                job: str = "", digest: Optional[str] = None
                ) -> Optional[dict]:
        """Record ``digest -> store`` after a batch finishes. Verifies
        the artifact before vouching for it, mirrors it per
        ``GS_CKPT_REPLICAS`` and writes the entry atomically. Idempotent
        (every publisher of a digest holds identical bytes). Returns the
        entry, or None when the store is missing or corrupt."""
        if digest is None:
            digest = job_digest(spec, backend=self.backend)
        if not store or not os.path.isdir(store):
            return None
        try:
            report = self._verifier(store)
        except CorruptionError:
            return None
        entry = {
            "digest": digest,
            "store": store,
            "job": job,
            "steps_audited": report["steps_audited"],
            "published_t": round(time.time(), 6),
        }
        from ..resilience.rendezvous import atomic_publish

        path = self.entry_path(digest)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        mirrors = replicate_store(store)
        atomic_publish(path, json.dumps(entry, sort_keys=True))
        self.metrics.counter("serve_cache_published").inc()
        self.events.emit(
            "cache_publish", digest=digest, job=job, store=store,
            mirrors=len(mirrors),
        )
        return entry

    # ---------------------------------------------------------- lookup

    def lookup(self, digest: str) -> Optional[dict]:
        """The verified entry for ``digest``, or None (a miss): the
        recorded store, then every on-disk ``.r<k>`` mirror, the first
        that passes the CRC audit winning. When every copy is corrupt or
        gone the entry is dropped and the lookup is a miss. Never
        returns an unverified store while ``verify`` is on."""
        entry = self._read_entry(digest)
        if entry is None:
            return None
        store = entry.get("store")
        if not store or not os.path.isdir(store):
            self._drop(digest, reason="store_missing")
            return None
        if not self.verify:
            return entry
        candidates = [store] + _existing_replicas(store)
        for candidate in candidates:
            try:
                self._verifier(candidate)
            except CorruptionError:
                continue
            if candidate != store:
                self.metrics.counter("serve_cache_failover").inc()
            return {**entry, "store": candidate}
        self._drop(digest, reason="all_replicas_corrupt")
        return None

    def _drop(self, digest: str, *, reason: str) -> None:
        """Retire an entry that can no longer be served: the caller
        launches fresh."""
        try:
            os.remove(self.entry_path(digest))
        except OSError:
            pass
        self.metrics.counter("serve_cache_dropped", reason=reason).inc()

    # -------------------------------------------------------- describe

    def describe(self) -> dict:
        entries = 0
        if os.path.isdir(self.root):
            for shard in os.listdir(self.root):
                sub = os.path.join(self.root, shard)
                if os.path.isdir(sub):
                    entries += sum(
                        1 for n in os.listdir(sub) if n.endswith(".json")
                    )
        return {"root": self.root, "entries": entries,
                "verify": self.verify}
