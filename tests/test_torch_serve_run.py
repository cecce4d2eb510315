"""The port's service end to end on the CPU (``backend = "CPU"``), held
against the port's solo CLI runs and against the reference's service
(the counterpart of ``tests/functional/test_serve_run.py``).

* Three jobs of one pack key form one batch of 4 slots; each member's
  ``.bp``, ``.vtk`` and checkpoint trees are byte-identical to the port's
  solo CLI run of that job, and within 1e-6 of the reference's served
  member stores; the idle slot writes nothing; ``/field`` serves a plane.
* Chaos scenario 6 (the worker killed mid-batch, requeued, byte-identical
  stores); the stream passes the port's ``obs/report --check`` and the
  reference's ``scripts/gs_report.py --check``, and renders the tenants
  and fleet sections.
* The SSE stream carries the lifecycle frames; a repeated spec is a
  ``cache="hit"`` with the same store and no launch; a corrupt cache
  entry is dropped under ``GS_CACHE_VERIFY`` and recomputed into equal
  bytes; the HTTP error codes; two worker threads; a 1,000-client load
  campaign (marked slow, as the reference's).
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from grayscott_jl_tpu_torch import chaos, driver
from grayscott_jl_tpu_torch.io.bplite import BpReader
from grayscott_jl_tpu_torch.resilience.integrity import corrupt_store_byte
from grayscott_jl_tpu_torch.serve.scheduler import ServeConfig
from grayscott_jl_tpu_torch.serve.server import ServeService

REPO = Path(__file__).resolve().parents[1]

SPECS = [
    {"tenant": "alice", "model": "grayscott", "L": 16, "steps": 24,
     "plotgap": 8, "checkpoint_freq": 8, "dt": 1.0, "noise": 0.1,
     "seed": 11 + i,
     "params": {"F": 0.03 + 0.005 * i, "k": 0.062, "Du": 0.2, "Dv": 0.1}}
    for i in range(3)
]

SOLO = """\
L = {L}
Du = {Du}
Dv = {Dv}
F = {F}
k = {k}
dt = {dt}
plotgap = {plotgap}
steps = {steps}
noise = {noise}
output = "{d}/gs.bp"
checkpoint = true
checkpoint_freq = {checkpoint_freq}
checkpoint_output = "{d}/ckpt.bp"
precision = "Float32"
backend = "CPU"
kernel_language = "Plain"
"""

SINK_VARS = ("GS_EVENTS", "GS_METRICS", "GS_TRACE", "GS_FAULTS",
             "GS_SUPERVISE", "GS_CKPT_REPLICAS", "GS_SERVE_FLEET_DIR",
             "GS_COMPILE_CACHE")


@pytest.fixture
def events(tmp_path, monkeypatch):
    """A fresh port event stream at ``tmp_path/events.jsonl``."""
    from grayscott_jl_tpu_torch.obs import events as ev
    from grayscott_jl_tpu_torch.obs import metrics

    for var in SINK_VARS:
        monkeypatch.delenv(var, raising=False)
    path = tmp_path / "events.jsonl"
    monkeypatch.setenv("GS_EVENTS", str(path))
    ev.reset_events()
    metrics.reset_metrics()
    yield path
    ev.reset_events()
    metrics.reset_metrics()


def start(tmp_path, name, **kw):
    cfg = dict(port=0, workers=1, pack_max=4, pack_window_s=0.2,
               state_dir=str(tmp_path / name), supervise=False,
               backend="CPU")
    cfg.update(kw)
    svc = ServeService(ServeConfig(**cfg)).start()
    return svc, f"http://127.0.0.1:{svc.port}"


def post(base, path, payload):
    try:
        return 200, chaos.post(base, path, payload)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def solo(tmp_path, name, spec):
    """The job as a solo CLI run (``driver.main``) of the port."""
    d = tmp_path / name
    d.mkdir()
    cfg = d / "config.toml"
    cfg.write_text(SOLO.format(d=d, **{**spec, **spec["params"]}))
    driver.main([str(cfg)], seed=spec["seed"])
    return d


def test_packed_members_equal_solo_runs_and_the_reference(tmp_path, events,
                                                          monkeypatch):
    svc, base = start(tmp_path, "svc")
    try:
        jobs = [chaos.post(base, "/v1/jobs", s)["job"] for s in SPECS]
        records = chaos.wait_terminal(base, jobs)
        assert [r["state"] for r in records] == ["complete"] * 3
        assert len({r["batch"] for r in records}) == 1
        stores = [r["store"] for r in records]
        assert [Path(s).name for s in stores] == [
            "gs.m00.bp", "gs.m01.bp", "gs.m02.bp"]
        batch_dir = Path(stores[0]).parent
        assert not any(p.name.startswith(("gs.m03", "ckpt.m03"))
                       for p in batch_dir.iterdir())
        health = chaos.get(base, "/v1/healthz")
        assert health["jobs"] == {"complete": 3}
        assert (health["launches"], health["config"]["backend"]) == (1, "CPU")
        plane = chaos.get(base, f"/v1/jobs/{jobs[0]}/field?field=u&z=8"
                                "&stride=4")
        assert (plane["shape"], plane["sim_step"]) == ([4, 4], 24)
    finally:
        svc.close()
    for i, spec in enumerate(SPECS):
        d = solo(tmp_path, f"solo{i}", spec)
        trees = chaos.member_trees(records[i]["store"])
        for kind, name in (("gs", "gs.bp"), ("vtk", "gs.vtk"),
                           ("ckpt", "ckpt.bp")):
            assert chaos.trees_equal(str(d / name), trees[kind]) == []

    # The reference's service on the same specs: the same steps within
    # 1e-6 (the port's plain path is not the reference's XLA program).
    from grayscott_jl_tpu.obs import events as ref_events
    from grayscott_jl_tpu.serve.scheduler import ServeConfig as RefConfig
    from grayscott_jl_tpu.serve.server import ServeService as RefService

    monkeypatch.setenv("GS_EVENTS", str(tmp_path / "ref_events.jsonl"))
    ref_events.reset_events()
    ref = RefService(RefConfig(port=0, workers=1, pack_max=4,
                               pack_window_s=0.2, supervise=False,
                               state_dir=str(tmp_path / "ref"))).start()
    try:
        rbase = f"http://127.0.0.1:{ref.port}"
        rjobs = [chaos.post(rbase, "/v1/jobs", s)["job"] for s in SPECS]
        refs = chaos.wait_terminal(rbase, rjobs)
    finally:
        ref.close()
        ref_events.reset_events()
    assert [r["state"] for r in refs] == ["complete"] * 3
    for got, want in zip(records, refs):
        for kind, names in (("gs", ("U", "V")), ("ckpt", ("u", "v"))):
            a = chaos.member_trees(got["store"])[kind]
            b = chaos.member_trees(want["store"])[kind]
            with BpReader(a) as x, BpReader(b) as y:
                assert x.num_steps() == y.num_steps() == 3
                for i in range(3):
                    for name in names:
                        u, w = x.get(name, step=i), y.get(name, step=i)
                        assert u.dtype == w.dtype
                        assert np.max(np.abs(u - w)) <= 1e-6


def test_chaos_worker_kill_requeue_and_the_reports(tmp_path, capsys):
    """Chaos scenario 6; its stream validates in both packages' report
    checks and renders the tenants and fleet sections."""
    rc = chaos.main(["--backend", "CPU", "--L", "16", "--steps", "40",
                     "--scenarios", "6", "--seed", "3",
                     "--workdir", str(tmp_path / "w")])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert rc == 0, lines
    assert [(r["scenario"], r["ok"]) for r in lines] == [(6, True)]
    stream = tmp_path / "w" / "s6" / "events.jsonl"
    kinds = [json.loads(x)["kind"] for x in stream.read_text().splitlines()]
    assert kinds.count("job_requeued") == 3
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "gs_report.py"), "--check",
         "--events", str(stream)],
        capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    from grayscott_jl_tpu_torch.obs import report

    assert report.main(["--events", str(stream)]) == 0
    out = capsys.readouterr().out
    assert "== tenants ==" in out and "chaos: 6 job(s), 6 complete" in out
    assert "== fleet ==" in out and "0 hit / 6 miss" in out


def test_sse_streams_the_lifecycle(tmp_path, events):
    import http.client

    svc, base = start(tmp_path, "svc", pack_window_s=0.0)
    try:
        job = chaos.post(base, "/v1/jobs", SPECS[0])["job"]
        conn = http.client.HTTPConnection("127.0.0.1", svc.port,
                                          timeout=120)
        conn.request("GET", f"/v1/jobs/{job}/events")
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "text/event-stream"
        seen, buf = [], b""
        deadline = time.time() + 120
        while time.time() < deadline and "done" not in seen:
            chunk = resp.read1(4096)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                frame, buf = buf.split(b"\n\n", 1)
                seen += [line[7:] for line in frame.decode().splitlines()
                         if line.startswith("event: ")]
        conn.close()
        assert seen[0] == "state" and seen[-1] == "done"
        assert "job_complete" in seen
    finally:
        svc.close()


def test_cache_hit_and_a_corrupt_entry(tmp_path, events):
    """A repeated spec is a ``cache="hit"`` naming the same store with no
    launch; a flipped byte in that store, under ``GS_CACHE_VERIFY``, drops
    the entry and the job recomputes into the same bytes."""
    svc, base = start(tmp_path, "svc", pack_window_s=0.0, cache_verify=True)
    try:
        first = chaos.wait_terminal(
            base, [chaos.post(base, "/v1/jobs", SPECS[0])["job"]])[0]
        snapshot = tmp_path / "snapshot.bp"
        shutil.copytree(first["store"], snapshot)
        launches = chaos.get(base, "/v1/healthz")["launches"]
        hit = chaos.post(base, "/v1/jobs", dict(SPECS[0], tenant="bob"))
        assert (hit["cache"], hit["state"], hit["store"]) == (
            "hit", "complete", first["store"])
        assert chaos.get(base, "/v1/healthz")["launches"] == launches
        assert corrupt_store_byte(first["store"]) is not None
        again = chaos.post(base, "/v1/jobs", SPECS[0])
        assert (again["cache"], again["state"]) == ("miss", "queued")
        redo = chaos.wait_terminal(base, [again["job"]])[0]
        assert redo["state"] == "complete"
        assert redo["store"] != first["store"]
        assert chaos.trees_equal(str(snapshot), redo["store"]) == []
        assert chaos.get(base, "/v1/healthz")["launches"] == launches + 1
    finally:
        svc.close()
    kinds = [json.loads(x)["kind"] for x in events.read_text().splitlines()]
    assert kinds.count("cache_hit") == 1 and kinds.count("cache_publish") == 2


def test_http_errors(tmp_path, events):
    svc, base = start(tmp_path, "svc", queue_depth=2, tenant_quota=2,
                      pack_window_s=10.0)
    try:
        code, body = post(base, "/v1/jobs", dict(SPECS[0], model="nope"))
        assert code == 400 and "Unknown model" in body["error"]
        code, body = post(base, "/v1/jobs",
                          dict(SPECS[0], params={"Fx": 1.0}))
        assert code == 400 and "unknown parameter" in body["error"]
        code, body = post(base, "/v1/jobs", dict(SPECS[0], L=512))
        assert code == 400 and "'L' must be in [4, 256]" in body["error"]
        queued = post(base, "/v1/jobs", dict(SPECS[0], tenant="bob"))[1]
        post(base, "/v1/jobs", dict(SPECS[1], tenant="bob"))
        code, body = post(base, "/v1/jobs", dict(SPECS[2], tenant="bob"))
        assert code == 429 and body["reason"] in ("queue_full",
                                                  "tenant_quota")
        code, body = post(base, "/v1/jobs/zzz/cancel", {})
        assert code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            chaos.get(base, f"/v1/jobs/{queued['job']}/result")
        assert e.value.code == 409
        with pytest.raises(urllib.error.HTTPError) as e:
            chaos.get(base, "/v1/nothing")
        assert e.value.code == 404
    finally:
        svc.close()


def test_the_card_is_asked_for_by_default(tmp_path, monkeypatch):
    """``python -m grayscott_jl_tpu_torch.serve`` runs batches on the card
    unless ``--backend CPU`` asks for the host: without a card it raises
    at start-up, and never falls back."""
    import torch

    from grayscott_jl_tpu_torch.serve import server

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.setenv("GS_SERVE_STATE_DIR", str(tmp_path / "st"))
    monkeypatch.setenv("GS_SERVE_PORT", "0")
    with pytest.raises(RuntimeError, match="CUDA card"):
        server.main([])
    with pytest.raises(RuntimeError, match="CUDA card"):
        ServeService(ServeConfig(port=0, state_dir=str(tmp_path / "s2")))
    assert server.parse_args(["--backend", "CPU"]).backend == "CPU"
    with pytest.raises(SystemExit):
        server.parse_args(["--backend", "TPU"])


def test_two_worker_threads(tmp_path, events):
    """``GS_SERVE_WORKERS=2``: two batches of different pack keys run at
    once, each member byte-identical to its solo run."""
    specs = [SPECS[0], dict(SPECS[1], steps=16)]
    svc, base = start(tmp_path, "svc", workers=2, pack_window_s=0.0)
    try:
        jobs = [chaos.post(base, "/v1/jobs", s)["job"] for s in specs]
        records = chaos.wait_terminal(base, jobs)
    finally:
        svc.close()
    assert [r["state"] for r in records] == ["complete"] * 2
    assert len({r["batch"] for r in records}) == 2
    workers = {json.loads(x)["attrs"].get("worker")
               for x in events.read_text().splitlines()
               if json.loads(x)["kind"] == "run_start"}
    assert workers == {"local.0", "local.1"}
    for i, spec in enumerate(specs):
        d = solo(tmp_path, f"solo{i}", spec)
        assert chaos.trees_equal(str(d / "gs.bp"), records[i]["store"]) == []


def campaign(tmp_path, clients, pack_max, steps=8, L=8):
    """``clients`` concurrent HTTP clients, one job each, against a fresh
    service; completion, request-to-first-step p99, aggregate cell-updates
    per second and the worker fleet's counters."""
    tenants = max(4, clients // 16)
    svc, base = start(tmp_path, f"pack{pack_max}", pack_max=pack_max,
                      pack_window_s=0.05, queue_depth=max(256, 2 * clients),
                      tenant_quota=max(64, clients), cache=False)
    jobs, errors = [None] * clients, []

    def client(i):
        try:
            jobs[i] = chaos.post(base, "/v1/jobs", {
                "tenant": f"tenant{i % tenants}", "model": "grayscott",
                "L": L, "steps": steps, "plotgap": 4, "checkpoint_freq": 0,
                "params": {"F": 0.01 + 0.05 * (i % 97) / 97.0, "k": 0.062,
                           "Du": 0.2, "Dv": 0.1},
                "dt": 1.0, "noise": 0.1, "seed": i})["job"]
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        assert not errors, errors[:3]
        records = chaos.wait_terminal(base, jobs, timeout=900)
        wall = time.perf_counter() - t0
        health = chaos.get(base, "/v1/healthz")
    finally:
        svc.close()
    done = [r for r in records if r["state"] == "complete"]
    rtfs = sorted(r["request_to_first_step_s"] for r in done)
    batches = {r["batch"] for r in records}
    shapes = {json.loads(x)["attrs"]["slots"]
              for x in (tmp_path / "events.jsonl").read_text().splitlines()
              if json.loads(x)["kind"] == "job_packed"
              and json.loads(x)["attrs"]["batch"] in batches}
    return {"completed": len(done), "shapes": len(shapes),
            "p99_s": rtfs[min(len(rtfs) - 1, int(0.99 * len(rtfs)))],
            "cells_per_s": L ** 3 * steps * len(done) / wall,
            "launches": health["launches"],
            "warm_hits": health["warm_hits"]}


@pytest.mark.slow
def test_load_1k_clients(tmp_path, events):
    """O(1k) concurrent clients, as the reference's slow test: all
    complete inside 300 s of request-to-first-step, packed 8 to a
    batch."""
    m = campaign(tmp_path, 1000, 8)
    assert m["completed"] == 1000
    assert m["p99_s"] <= 300
    assert m["launches"] <= 1000 // 4
    assert m["warm_hits"] == m["launches"] - m["shapes"]

