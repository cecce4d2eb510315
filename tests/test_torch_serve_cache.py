"""The port's result cache (``grayscott_jl_tpu_torch/serve/cache.py``)
against the reference's, on the CPU.

* ``canonical_spec`` and ``job_digest`` of a service on the CPU equal the
  reference's byte for byte, over parameter spellings, defaults, postures
  and deltas; on the card they differ by exactly ``"device": "cuda"``.
* ``GS_SERVE_CACHE``, ``GS_CACHE_DIR`` and ``GS_CACHE_VERIFY`` resolve as
  the reference's.
* ``ResultCache``: publish and lookup, the failover to a mirror, a
  corrupt or vanished entry dropped into a miss, ``verify`` off — the
  same outcome from the port's cache and the reference's on the same
  calls — and the scheduler's hit path (no queue slot, no quota).
"""

import json
import os
import shutil

import pytest

from grayscott_jl_tpu.obs.events import NULL_EVENTS as REF_NULL
from grayscott_jl_tpu.resilience.integrity import (
    CorruptionError as RefCorruption,
)
from grayscott_jl_tpu.serve import cache as ref_cache
from grayscott_jl_tpu.serve import protocol as ref_protocol

from grayscott_jl_tpu_torch.obs.events import NULL_EVENTS
from grayscott_jl_tpu_torch.resilience.integrity import CorruptionError
from grayscott_jl_tpu_torch.serve import cache, protocol
from grayscott_jl_tpu_torch.serve.scheduler import Scheduler, ServeConfig

SPEC = {
    "tenant": "alice", "model": "grayscott", "L": 16, "steps": 24,
    "plotgap": 8, "checkpoint_freq": 8,
    "params": {"F": 0.03, "k": 0.062, "Du": 0.2, "Dv": 0.1},
    "dt": 1.0, "noise": 0.1, "seed": 11,
}

PAYLOADS = [
    {},
    {"params": {"k": 0.062, "F": 0.03, "Dv": 0.1, "Du": 0.2}},
    {"params": {"F": 0.030, "k": 0.062, "Du": 2e-1, "Dv": 1e-1}},
    {"params": {"F": 3e-2, "k": 0.0620, "Du": 0.2, "Dv": 0.10}},
    {"params": {"F": 0.03 + 2 ** -52}},
    {"tenant": "bob", "priority": "high"},
    {"seed": 12},
    {"L": 32},
    {"steps": 48},
    {"plotgap": 4},
    {"checkpoint_freq": 0},
    {"precision": "Float64"},
    {"precision": "BFloat16"},
    {"halo_depth": 2},
    {"noise": 0.0},
    {"dt": 0.5},
    {"model": "heat", "params": {}},
    {"model": "fhn", "params": {"a": 0.7}},
]


def both(payload):
    p = {**SPEC, **payload}
    return protocol.parse_job(p), ref_protocol.parse_job(p)


@pytest.mark.parametrize("payload", PAYLOADS)
def test_digest_on_the_cpu_equals_the_reference(payload):
    job, ref = both(payload)
    assert cache.canonical_spec(job, backend="CPU") == (
        ref_cache.canonical_spec(ref))
    assert cache.job_digest(job, backend="CPU") == ref_cache.job_digest(ref)


@pytest.mark.parametrize("payload", PAYLOADS[:6])
def test_digest_on_the_card_names_the_device(payload):
    """A store the card's kernel wrote need not equal the host's bytes:
    the card's document adds ``"device"`` and nothing else."""
    job, _ = both(payload)
    card = cache.canonical_spec(job)
    host = cache.canonical_spec(job, backend="CPU")
    assert card.pop("device") == "cuda"
    assert card == host
    assert cache.job_digest(job) != cache.job_digest(job, backend="CPU")


@pytest.mark.parametrize("env", [
    {"GS_COMPUTE_PRECISION": "equality"},
    {"GS_SNAPSHOT_BITS": "8"},
    {"GS_SNAPSHOT_BITS": "u:8,v:12"},
])
def test_digest_tracks_postures_as_the_reference(monkeypatch, env):
    job, ref = both({})
    plain = cache.job_digest(job, backend="CPU")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert cache.job_digest(job, backend="CPU") == ref_cache.job_digest(ref)
    assert cache.job_digest(job, backend="CPU") != plain


def test_digest_spellings_collide_and_deltas_separate():
    digests = [cache.job_digest(both(p)[0]) for p in PAYLOADS]
    assert digests[0] == digests[1] == digests[2] == digests[3] == digests[5]
    rest = [digests[0]] + digests[4:5] + digests[6:]
    assert len(set(rest)) == len(rest)
    doc = cache.canonical_spec(both({})[0])
    assert json.loads(json.dumps(doc, sort_keys=True)) == doc


@pytest.mark.parametrize("env", [
    {},
    {"GS_SERVE_CACHE": "0"},
    {"GS_SERVE_CACHE": "yes", "GS_CACHE_DIR": "/tmp/c",
     "GS_CACHE_VERIFY": "off"},
    {"GS_CACHE_VERIFY": "1"},
])
def test_cache_variables_resolve_as_the_reference(monkeypatch, env):
    for var in ("GS_SERVE_CACHE", "GS_CACHE_DIR", "GS_CACHE_VERIFY"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for name in ("resolve_cache_enabled", "resolve_cache_dir",
                 "resolve_cache_verify"):
        assert getattr(cache, name)() == getattr(ref_cache, name)()


# ---------------------------------------------------------- ResultCache

PKGS = {
    "port": (cache, protocol, CorruptionError, NULL_EVENTS),
    "ref": (ref_cache, ref_protocol, RefCorruption, REF_NULL),
}


class FakeVerifier:
    """The CRC audit's stand-in: paths in ``bad`` raise, others pass."""

    def __init__(self, error):
        self.error = error
        self.bad = set()
        self.calls = []

    def __call__(self, path):
        self.calls.append(path)
        if path in self.bad:
            raise self.error(f"fake CRC mismatch in {path}")
        return {"path": path, "steps_audited": 3, "corrupt": []}


def story(pkg, tmp_path, monkeypatch):
    """Every ResultCache outcome on one sequence of calls, with paths
    relative to ``tmp_path``."""
    mod, proto, error, null = PKGS[pkg]
    root = tmp_path / pkg
    monkeypatch.setenv("GS_CKPT_REPLICAS", "2")
    fake = FakeVerifier(error)
    kw = {"backend": "CPU"} if pkg == "port" else {}
    rc = mod.ResultCache(str(root / "cache"), events=null, verifier=fake,
                         **kw)
    job = proto.parse_job(SPEC)
    digest = mod.job_digest(job, **kw)

    def store(name):
        d = root / name
        d.mkdir(parents=True)
        (d / "data.0").write_bytes(b"payload-bytes")
        return str(d)

    def rel(entry):
        return None if entry is None else os.path.relpath(
            entry["store"], root)

    out = [rc.publish(job, str(root / "nowhere")),
           rel(rc.publish(job, store("gs.m00.bp"), job="j1"))]
    out.append(rel(rc.lookup(digest)))
    fake.bad.add(str(root / "gs.m00.bp"))
    out.append(rel(rc.lookup(digest)))  # the mirror
    fake.bad.add(str(root / "gs.m00.bp.r1"))
    out.append(rel(rc.lookup(digest)))  # every copy corrupt: dropped
    out.append(os.path.exists(rc.entry_path(digest)))
    fake.bad.clear()
    rc.publish(job, str(root / "gs.m00.bp"))
    shutil.rmtree(root / "gs.m00.bp")
    out.append(rel(rc.lookup(digest)))  # vanished: dropped
    rc.verify = False
    rc.publish(job, store("other.bp"))
    fake.calls.clear()
    out += [rel(rc.lookup(digest)), fake.calls, rc.describe()["entries"]]
    return out


def test_result_cache_outcomes_equal_the_reference(tmp_path, monkeypatch):
    got = story("port", tmp_path, monkeypatch)
    assert got == story("ref", tmp_path, monkeypatch)
    assert got[1:5] == ["gs.m00.bp", "gs.m00.bp", "gs.m00.bp.r1", None]


def test_scheduler_serves_a_repeat_spec_from_the_cache(tmp_path,
                                                       monkeypatch):
    """A published digest completes a repeat submit without queueing:
    no queue slot, no quota charge, ``cache="hit"`` and the store; an
    unpublished spec is a ``miss`` that queues."""
    monkeypatch.delenv("GS_CKPT_REPLICAS", raising=False)
    sched = Scheduler(ServeConfig(
        state_dir=str(tmp_path / "state"), pack_window_s=0.0,
        supervise=False, queue_depth=1, tenant_quota=1, backend="CPU"),
        events=NULL_EVENTS)
    sched.cache = cache.ResultCache(
        str(tmp_path / "cache"), events=NULL_EVENTS, backend="CPU",
        verifier=FakeVerifier(CorruptionError))
    store = tmp_path / "gs.m00.bp"
    store.mkdir()
    sched.cache.publish(protocol.parse_job(SPEC), str(store))
    for _ in range(3):
        job = sched.submit(dict(SPEC))
        assert (job.cache, job.state, job.store) == (
            "hit", "complete", str(store))
    assert sched._queue == []
    miss = sched.submit({**SPEC, "seed": 12})
    assert (miss.cache, miss.state) == ("miss", "queued")
    assert miss.digest == cache.job_digest(
        protocol.parse_job({**SPEC, "seed": 12}), backend="CPU")
