"""Observability end to end on the CPU (counterparts of
tests/functional/test_obs_run.py:63 and :314): every sink armed
(``GS_TRACE``, ``GS_EVENTS``, ``GS_METRICS`` at a 1 ms interval, so
that every boundary of these short runs flushes a record,
``GS_METRICS_PROM``, ``GS_NUMERICS=boundary``) leaves every store
byte-identical to the run with none, on one block and on the (2,2,2)
mesh and across two processes (gloo, the harness of
tests/test_torch_multiprocess.py); the sinks hold what the run did;
two processes' ``.rank<N>`` event files merge in the reference's
``parse_events_multi`` into one ordered timeline whose numerics
reports agree across the ranks and with the one-process run's; and a
drift abort leaves no drifted step in the store."""

import glob
import hashlib
import json
import os

import numpy as np
import pytest

from grayscott_jl_tpu.obs.events import parse_events_multi as ref_multi
from grayscott_jl_tpu.obs.trace import validate_trace as ref_validate
from grayscott_jl_tpu_torch import Simulation, driver
from grayscott_jl_tpu_torch.config.settings import get_settings
from grayscott_jl_tpu_torch.io.bplite import BpReader
from grayscott_jl_tpu_torch.obs import events, metrics, trace
from grayscott_jl_tpu_torch.resilience.health import DriftError
from test_torch_multiprocess import (LAUNCH_VARS, run_pair, run_single,
                                     write_config)

#: Every sink's variable (cleared before each run).
SINK_VARS = ("GS_TRACE", "GS_EVENTS", "GS_METRICS", "GS_METRICS_PROM",
             "GS_METRICS_INTERVAL_S", "GS_NUMERICS", "GS_NUMERICS_WINDOW",
             "GS_DRIFT_POLICY", "GS_DRIFT_LIMIT", "GS_TPU_STATS")

#: Relative tolerance of a report's ``mean``/``l2`` against a float64
#: numpy recomputation from the stored step (tests/test_torch_numerics.py).
RTOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_singletons(monkeypatch):
    for var in SINK_VARS + LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    events.reset_events()
    metrics.reset_metrics()
    trace.reset_tracer()
    yield
    events.reset_events()
    metrics.reset_metrics()
    trace.reset_tracer()


def sinks(d):
    """The sink variables of a run writing into ``d``."""
    return {"GS_TRACE": str(d / "trace.json"),
            "GS_EVENTS": str(d / "events.jsonl"),
            "GS_METRICS": str(d / "metrics.jsonl"),
            "GS_METRICS_INTERVAL_S": "0.001",
            "GS_METRICS_PROM": str(d / "prom.txt"),
            "GS_NUMERICS": "boundary",
            "GS_TPU_STATS": str(d / "stats.json")}


def store_files(d):
    """sha256 of every file the run wrote but the sinks' and the
    config."""
    out = {}
    for p in glob.glob(str(d / "**"), recursive=True):
        rel = os.path.relpath(p, d)
        if os.path.isfile(p) and not rel.startswith(
                ("trace.json", "events.jsonl", "metrics.jsonl", "prom.txt",
                 "stats.json", "config.toml", "launch.log")):
            with open(p, "rb") as f:
                out[rel] = hashlib.sha256(f.read()).hexdigest()
    return out


def run(monkeypatch, d, n, env=None, **kw):
    cfg = write_config(d, kernel_language="Auto", **kw)
    with monkeypatch.context() as mp:
        for k, v in (env or {}).items():
            mp.setenv(k, v)
        events.reset_events()
        metrics.reset_metrics()
        trace.reset_tracer()
        try:
            return driver.main([cfg], n_devices=n)
        finally:
            events.reset_events()
            metrics.reset_metrics()
            trace.reset_tracer()


def stored(store, names):
    with BpReader(store) as r:
        return {int(r.get("step", step=i)): [r.get(n, step=i) for n in names]
                for i in range(r.num_steps())}


def assert_reports_match_store(evs, store, names=("U", "V")):
    """Each ``numerics`` record's min/max equal a float64 numpy
    recomputation from the stored step, and mean/l2 within RTOL."""
    steps = stored(store, names)
    seen = 0
    for e in evs:
        if e["kind"] != "numerics" or e["step"] not in steps:
            continue
        seen += 1
        for name, arr in zip(("u", "v"), steps[e["step"]]):
            rep = e["attrs"]["fields"][name]
            a = np.asarray(arr, dtype=np.float64)
            assert rep["min"] == a.min() and rep["max"] == a.max()
            assert rep["nonfinite"] == 0
            np.testing.assert_allclose(rep["mean"], a.mean(), rtol=RTOL)
            np.testing.assert_allclose(rep["l2"], np.sqrt((a * a).sum()),
                                       rtol=RTOL)
    assert seen == len(steps)


@pytest.mark.parametrize("n", [1, 8], ids=["single", "mesh"])
def test_stores_byte_identical_with_every_sink_armed(tmp_path, monkeypatch,
                                                     n):
    off, on = tmp_path / "off", tmp_path / "on"
    run(monkeypatch, off, n)
    sim = run(monkeypatch, on, n, sinks(on))
    assert sim.domain.n_blocks == n
    want = store_files(off)
    assert want and store_files(on) == want
    doc = json.loads((on / "trace.json").read_text())
    assert ref_validate(doc) == [] and trace.validate_trace(doc) == []
    phases = {e["name"] for e in doc["traceEvents"]
              if e.get("ph") == "X" and e["tid"] == 0}
    assert {"compile", "step_round", "io", "drain"} <= phases
    assert any(e.get("name") == "output" and e["tid"] > 1
               for e in doc["traceEvents"])
    evs = events.parse_events(str(on / "events.jsonl"))
    kinds = [e["kind"] for e in evs]
    # Auto's decision comes first, in the compile phase, as the
    # reference's stream has it.
    assert kinds[:2] == ["autotune", "run_start"]
    assert kinds[-1] == "run_complete"
    assert evs[0]["attrs"]["mode"] == "cached"
    assert [e["step"] for e in evs if e["kind"] == "output"] == [10, 20]
    assert [e["step"] for e in evs if e["kind"] == "checkpoint"] == [10, 20]
    assert [e["step"] for e in evs if e["kind"] == "numerics"] == [10, 20]
    assert_reports_match_store(evs, str(on / "out.bp"))
    records = [json.loads(x) for x in
               (on / "metrics.jsonl").read_text().splitlines()]
    assert len(records) >= 2 and records[-1]["proc"] == 0
    prom = (on / "prom.txt").read_text()
    for name in ("step_latency_us", "step_rounds", "io_steps_written",
                 "numerics_l2", "field_finite", "io_hidden_s"):
        assert name in prom, name
    stats = json.loads((on / "stats.json").read_text())
    assert stats["numerics"]["mode"] == "boundary"
    assert stats["numerics"]["probes"] == 2
    assert stats["obs"]["events"]["emitted"] == len(evs)
    counters = {c["name"]: c["value"] for c in stats["metrics"]["counters"]}
    assert counters["steps"] == 20 and counters["io_steps_written"] == 2


def test_every_round_probes_every_round(tmp_path, monkeypatch):
    on = tmp_path / "on"
    env = dict(sinks(on), GS_NUMERICS="every_round")
    run(monkeypatch, on, 1, env, plotgap=5, checkpoint_freq=10)
    evs = events.parse_events(str(on / "events.jsonl"))
    num = [(e["step"], e["phase"]) for e in evs if e["kind"] == "numerics"]
    assert num == [(5, "step_round"), (10, "step_round"),
                   (15, "step_round"), (20, "step_round")]
    assert_reports_match_store(evs, str(on / "out.bp"))


def poisoning(at):
    """A ``sim_factory`` whose simulation scales the ``u`` corner
    (``poison_drift``) once its step reaches ``at``."""
    def factory(settings, *, n_devices, seed):
        sim = Simulation(settings, n_devices=n_devices, seed=seed)
        iterate = sim.iterate

        def stepped(n):
            iterate(n)
            if sim.step == at:
                sim.poison_drift()

        sim.iterate = stepped
        return sim

    return factory


@pytest.mark.parametrize("mode", ["boundary", "every_round"])
@pytest.mark.parametrize("policy", ["abort", "warn"])
def test_drift_abort_leaves_no_drifted_step(tmp_path, monkeypatch, mode,
                                            policy):
    """``poison_drift`` after step 6 of an L=32 run (plotgap 2): under
    ``abort`` the probe at step 6 raises ``DriftError`` before step 6 is
    submitted, so the stores hold steps 2 and 4 only; under ``warn`` the
    trip at step 6 is the run's first ``drift`` record and every step is
    written."""
    d = tmp_path / "run"
    cfg = write_config(d, L=32, steps=10, plotgap=2, checkpoint_freq=4,
                       kernel_language="Auto")
    for k, v in dict(sinks(d), GS_NUMERICS=mode,
                     GS_DRIFT_POLICY=policy).items():
        monkeypatch.setenv(k, v)
    settings = get_settings([cfg])
    if policy == "abort":
        with pytest.raises(DriftError, match="step 6.*u.max"):
            driver.run_once(settings, sim_factory=poisoning(6))
    else:
        driver.run_once(settings, sim_factory=poisoning(6))
    trace.reset_tracer()
    evs = events.parse_events(str(d / "events.jsonl"))
    drifts = [e for e in evs if e["kind"] == "drift"]
    assert drifts and drifts[0]["step"] == 6
    assert "u.max" in drifts[0]["attrs"]["tripped"]
    assert drifts[0]["attrs"]["policy"] == policy
    out = sorted(stored(str(d / "out.bp"), ("U",)))
    ckpt = sorted(stored(str(d / "ckpt.bp"), ("u",)))
    if policy == "abort":
        assert out == [2, 4] and ckpt == [4]
        assert evs[-1]["kind"] == "run_error"
        assert "DriftError" in evs[-1]["attrs"]["error"]
    else:
        assert out == [2, 4, 6, 8, 10] and ckpt == [4, 8]
        assert evs[-1]["kind"] == "run_complete"


def test_health_abort_is_on_the_stream(tmp_path, monkeypatch):
    """The F1 blow-up (dt=400) under ``abort``: the failing report and
    ``run_error`` are on the stream, and no step is written."""
    from grayscott_jl_tpu_torch.resilience.health import HealthError

    d = tmp_path / "f1"
    with pytest.raises(HealthError):
        run(monkeypatch, d, 1, {"GS_EVENTS": str(d / "events.jsonl")},
            dt=400.0, checkpoint=False)
    evs = events.parse_events(str(d / "events.jsonl"))
    assert [e["kind"] for e in evs] == ["autotune", "run_start", "health",
                                        "run_error"]
    assert evs[2]["step"] == 10 and evs[2]["attrs"]["finite"] is False
    assert evs[2]["attrs"]["fault"] == "health"
    assert stored(str(d / "out.bp"), ("U",)) == {}


@pytest.fixture(scope="module")
def pair_with_sinks(tmp_path_factory):
    """The standard two-process config (tests/test_torch_multiprocess.py)
    with every sink armed, and the same config without them."""
    d = tmp_path_factory.mktemp("pair_obs")
    run_pair(d, write_config(d), extra=sinks(d))
    plain = tmp_path_factory.mktemp("pair_plain")
    run_pair(plain, write_config(plain))
    return d, plain


def test_two_process_stores_byte_identical_with_sinks(pair_with_sinks):
    d, plain = pair_with_sinks
    want = store_files(plain)
    assert want and store_files(d) == want


def test_two_process_rank_files_merge_in_the_reference(pair_with_sinks,
                                                       tmp_path,
                                                       monkeypatch):
    d, _ = pair_with_sinks
    for sink in ("events.jsonl", "metrics.jsonl", "trace.json",
                 "stats.json"):
        assert not (d / sink).exists(), sink
        for rank in (0, 1):
            assert (d / f"{sink}.rank{rank}").is_file(), (sink, rank)
    for rank in (0, 1):
        doc = json.loads((d / f"trace.json.rank{rank}").read_text())
        assert ref_validate(doc) == []
        assert doc["otherData"]["proc"] == rank
    merged = ref_multi(str(d / "events.jsonl"))
    assert merged == events.parse_events_multi(str(d / "events.jsonl"))
    assert [e["ts"] for e in merged] == sorted(e["ts"] for e in merged)
    assert {e["proc"] for e in merged} == {0, 1}
    by_rank = {r: [e for e in merged if e["proc"] == r] for r in (0, 1)}
    for r, evs in by_rank.items():
        assert evs[0]["kind"] == "run_start"
        assert evs[-1]["kind"] == "run_complete"
    reports = {r: [(e["step"], e["attrs"]) for e in evs
                   if e["kind"] == "numerics"] for r, evs in by_rank.items()}
    assert [s for s, _ in reports[0]] == [10, 20]
    assert reports[0] == reports[1]
    # The one-process run of the same 8-block mesh reports the same
    # numbers, bit for bit.
    single = tmp_path / "single"
    single.mkdir()
    run_single(monkeypatch, single, write_config(single),
               extra=sinks(single))
    events.reset_events()
    metrics.reset_metrics()
    trace.reset_tracer()
    one = [(e["step"], e["attrs"])
           for e in events.parse_events(str(single / "events.jsonl"))
           if e["kind"] == "numerics"]
    assert one == reports[0]
    assert_reports_match_store(by_rank[0], str(d / "out.bp"))
