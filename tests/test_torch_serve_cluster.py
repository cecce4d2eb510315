"""The port's serving fleet (``grayscott_jl_tpu_torch/serve/cluster.py``)
and its fleet quarantine documents (``resilience/sdc.py``) against the
reference's, on the CPU.

* ``FleetKV``: a namespace one package writes, the other reads — the
  documents of a front door of one package and a worker of the other
  (submit, claim, lease, complete, the reaper's failover and the
  adoption), in both directions.
* ``quarantine_device`` / ``resolve_blocklist``: a quarantine document
  published by either package is read by the other; the first verdict
  wins.
* Chaos scenarios 9 (front door and leaseholding worker SIGKILLed, the
  cache replay) and 10 (live reshapes through the relay, a worker
  SIGKILLed mid-request), as processes of ``python -m
  grayscott_jl_tpu_torch.serve --backend CPU``; their merged multi-rank
  streams pass the port's and the reference's ``--check``.
"""

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from grayscott_jl_tpu.obs.events import NULL_EVENTS as REF_NULL
from grayscott_jl_tpu.resilience import sdc as ref_sdc
from grayscott_jl_tpu.serve import cluster as ref_cluster
from grayscott_jl_tpu.serve import scheduler as ref_scheduler

from grayscott_jl_tpu_torch import chaos
from grayscott_jl_tpu_torch.obs.events import NULL_EVENTS
from grayscott_jl_tpu_torch.resilience import sdc
from grayscott_jl_tpu_torch.serve import cluster, scheduler

REPO = Path(__file__).resolve().parents[1]

SPEC = {
    "tenant": "alice", "model": "grayscott", "L": 16, "steps": 24,
    "plotgap": 8, "checkpoint_freq": 8,
    "params": {"F": 0.03, "k": 0.062, "Du": 0.2, "Dv": 0.1},
    "dt": 1.0, "noise": 0.1, "seed": 11,
}

PKGS = {"ref": (ref_cluster, ref_scheduler, REF_NULL),
        "port": (cluster, scheduler, NULL_EVENTS)}


@contextlib.contextmanager
def member(pkg, tmp_path, role, **kw):
    mod, sched_mod, null = PKGS[pkg]
    cfg = dict(state_dir=str(tmp_path / "state"),
               fleet_dir=str(tmp_path / "fleet"), pack_window_s=0.0,
               supervise=False, workers=0, lease_ttl_s=5.0, heartbeat_s=1.0,
               cache=False)
    cfg.update(kw)
    cfg = sched_mod.ServeConfig(**cfg)
    if pkg == "port":
        cfg.backend = "CPU"
    sched = mod.ClusterScheduler(cfg, role=role, events=null)
    try:
        yield sched
    finally:
        sched.close()


MIXED = [("ref", "port"), ("port", "ref"), ("port", "port")]


@pytest.mark.parametrize("front, back", MIXED)
def test_a_front_door_and_a_worker_of_either_package(tmp_path, front, back):
    """Jobs one package admits, the other's worker claims, leases and
    completes; the front door answers from the shared documents."""
    with member(front, tmp_path, "frontdoor") as fd, \
            member(back, tmp_path, "worker") as wk:
        a = fd.submit(dict(SPEC, seed=1))
        b = fd.submit(dict(SPEC, seed=2, priority="high"))
        kv = ref_cluster.FleetKV(fd.cfg.fleet_dir)
        assert [kv.get(f"queue/{q}")["job"] for q in kv.keys("queue")] == [
            b.id, a.id]
        batch = wk.next_batch(timeout=1.0)
        assert batch.job_ids == [b.id, a.id] and batch.n_slots == 2
        assert kv.keys("queue") == []
        assert kv.get(f"leases/{batch.id}")["worker"] == wk.member_id
        assert batch.settings.ensemble.n == 2
        assert fd.status(a.id)["state"] == "packed"
        assert fd.status(a.id)["store"].endswith("gs.m01.bp")
        wk.complete(batch, ok=True, wall_s=0.1)
        assert kv.get(f"leases/{batch.id}") is None
        assert [fd.status(j)["state"] for j in (a.id, b.id)] == [
            "complete"] * 2
        assert fd.idle() and wk.idle()
        members = fd.describe()["members"]
        assert {m["role"] for m in members.values()} == {"frontdoor",
                                                          "worker"}


@pytest.mark.parametrize("front, back", MIXED)
def test_an_expired_lease_fails_over_across_packages(tmp_path, front, back):
    """A dead worker's expired lease is reaped by the other package's
    front door into a resume entry that a surviving worker adopts."""
    with member(front, tmp_path, "frontdoor") as fd, \
            member(back, tmp_path, "worker") as dead, \
            member(back, tmp_path, "worker") as survivor:
        job = fd.submit(dict(SPEC))
        batch = dead.next_batch(timeout=1.0)
        kv = cluster.FleetKV(fd.cfg.fleet_dir)
        dead._held.pop(batch.id)
        lease = kv.get(f"leases/{batch.id}")
        lease["expires_t"] = time.time() - 1.0
        kv.put(f"leases/{batch.id}", lease)
        kv.put(f"reshape/{batch.id}", {"batch": batch.id,
                                       "req": {"scale": "grow"}})
        fd._reap_leases(time.time())
        assert kv.get(f"leases/{batch.id}") is None
        assert kv.get(f"reshape/{batch.id}") is None
        assert kv.get(f"resume/{batch.id}")["attempt"] == 1
        adopted = survivor.next_batch(timeout=1.0)
        assert (adopted.id, adopted.attempt, adopted.dir) == (
            batch.id, 1, batch.dir)
        survivor.complete(adopted, ok=True, wall_s=0.1)
        st = fd.status(job.id)
        assert (st["state"], st["attempts"]) == ("complete", 2)


@pytest.mark.parametrize("front", ["ref", "port"])
def test_the_reshape_relay_across_packages(tmp_path, front):
    back = "port" if front == "ref" else "ref"
    with member(front, tmp_path, "frontdoor") as fd, \
            member(back, tmp_path, "worker") as wk:
        fd.submit(dict(SPEC))
        batch = wk.next_batch(timeout=1.0)
        assert fd.request_reshape(batch.id, {"mesh_dims": [1, 2, 2]})
        assert wk.take_reshape(batch.id) == {"mesh_dims": [1, 2, 2]}
        assert wk.take_reshape(batch.id) is None


def test_job_documents_round_trip(tmp_path):
    with member("port", tmp_path, "frontdoor") as fd, \
            member("ref", tmp_path, "frontdoor") as rfd:
        job = fd.submit(dict(SPEC, priority=7))
        rjob = rfd.submit(dict(SPEC, tenant="bob"))
        assert rfd.status(job.id) == fd.status(job.id)
        assert fd.status(rjob.id) == rfd.status(rjob.id)
        assert fd.jobs.get(rjob.id).spec.describe() == (
            rfd.jobs.get(rjob.id).spec.describe())
        doc = cluster.FleetKV(fd.cfg.fleet_dir).get(f"jobs/{job.id}")
        rdoc = cluster.FleetKV(fd.cfg.fleet_dir).get(f"jobs/{rjob.id}")
        assert sorted(doc) == sorted(rdoc)


# ----------------------------------------------------------- quarantine


@pytest.fixture
def fleet_env(monkeypatch, tmp_path):
    monkeypatch.setenv("GS_DEVICE_BLOCKLIST", "")
    monkeypatch.setenv("GS_SERVE_FLEET_DIR", str(tmp_path / "fleet"))
    return monkeypatch


def test_a_port_quarantine_is_read_by_the_reference(fleet_env, tmp_path):
    sdc.quarantine_device("cuda:0", step=40, reason="repeated SDC")
    sdc.quarantine_device("cuda:0", step=90, reason="later")
    kv = ref_cluster.FleetKV(str(tmp_path / "fleet"))
    doc = kv.get("quarantine/cuda_0")
    assert (doc["device"], doc["step"], doc["reason"]) == (
        "cuda:0", 40, "repeated SDC")
    fleet_env.setenv("GS_DEVICE_BLOCKLIST", "")
    assert ref_sdc.resolve_blocklist() == frozenset({"cuda:0"})
    assert sdc.resolve_blocklist() == frozenset({"cuda:0"})


def test_a_reference_quarantine_is_read_by_the_port(fleet_env, tmp_path):
    ref_sdc.quarantine_device("cpu:5", step=3, reason="ref")
    fleet_env.setenv("GS_DEVICE_BLOCKLIST", "cuda:1")
    assert sdc.resolve_blocklist() == frozenset({"cpu:5", "cuda:1"})
    with open(tmp_path / "fleet" / "quarantine" / "cpu_5") as f:
        assert json.load(f)["device"] == "cpu:5"
    fleet_env.delenv("GS_SERVE_FLEET_DIR")
    assert sdc.resolve_blocklist() == frozenset({"cuda:1"})


def test_a_quarantined_card_leaves_the_usable_devices(fleet_env):
    sdc.quarantine_device("cpu")
    fleet_env.setenv("GS_DEVICE_BLOCKLIST", "")
    assert sdc.usable_devices("cpu") == []


# ---------------------------------------------------------------- chaos


@pytest.mark.parametrize("scenario", [9, 10])
def test_fleet_chaos_scenarios_on_the_cpu(tmp_path, capsys, scenario):
    rc = chaos.main(["--backend", "CPU", "--L", "16", "--steps", "40",
                     "--scenarios", str(scenario), "--seed", "3",
                     "--workdir", str(tmp_path / "w")])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert rc == 0, lines
    assert [(r["scenario"], r["ok"]) for r in lines] == [(scenario, True)]
    # The merged multi-rank stream passes the reference's check too.
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "gs_report.py"), "--check",
         "--events", str(tmp_path / "w" / f"s{scenario}" / "events.jsonl")],
        capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
