"""The observability sinks (grayscott_jl_tpu_torch/obs/events.py,
metrics.py, trace.py) against the reference's ``grayscott_jl_tpu/obs``:
the same sequence of ``emit`` / ``inc`` / ``set`` / ``observe`` /
``span`` calls through both gives equal event records (but ``ts``),
equal Prometheus text and snapshots, equal histogram quantiles, traces
both valid under the reference's ``validate_trace``, and rank files
that either package's ``parse_events_multi`` reads. Values are made
with numpy from a seed."""

import json
import os
import threading

import numpy as np
import pytest

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.obs import events as ref_events
from grayscott_jl_tpu.obs import metrics as ref_metrics
from grayscott_jl_tpu.obs import trace as ref_trace
from grayscott_jl_tpu_torch import Settings
from grayscott_jl_tpu_torch.obs import events, metrics, trace


@pytest.fixture(autouse=True)
def fresh_singletons():
    events.reset_events()
    metrics.reset_metrics()
    trace.reset_tracer()
    yield
    events.reset_events()
    metrics.reset_metrics()
    trace.reset_tracer()


def _calls(seed):
    """A seeded sequence of sink calls: ``("emit", kind, phase, step,
    attrs)``, ``("inc", name, labels, n)``, ``("set", ...)``,
    ``("observe", ...)``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        r = rng.integers(4)
        labels = {"model": "grayscott", "mesh": ["1x1x1", "2x2x2"][i % 2]}
        if r == 0:
            out.append(("emit", ["output", "checkpoint", "numerics"][i % 3],
                        ["io", None][i % 2], int(rng.integers(100)),
                        {"x": float(rng.random()), "tag": f"t{i}"}))
        elif r == 1:
            out.append(("inc", "steps", labels, int(rng.integers(1, 9))))
        elif r == 2:
            out.append(("set", ["field_min", "async_io_queue_depth"][i % 2],
                        labels, float(rng.normal())))
        else:
            out.append(("observe", "step_latency_us", labels,
                        float(rng.gamma(2.0, 50.0))))
    return out


def _replay(calls, stream, registry, capacity):
    for c in calls:
        if c[0] == "emit":
            stream.emit(c[1], phase=c[2], step=c[3], **c[4])
        elif c[0] == "inc":
            registry.counter(c[1], **c[2]).inc(c[3])
        elif c[0] == "set":
            registry.gauge(c[1], **c[2]).set(c[3])
        else:
            registry.histogram(c[1], capacity=capacity, **c[2]).observe(c[3])


def _without_ts(evs):
    return [{k: v for k, v in e.items() if k != "ts"} for e in evs]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("capacity", [4, 1024])
def test_event_and_metric_sequences_match_the_reference(tmp_path, seed,
                                                        capacity):
    calls = _calls(seed)
    port_s = events.EventStream(str(tmp_path / "p.jsonl"), proc=0)
    ref_s = ref_events.EventStream(str(tmp_path / "r.jsonl"), proc=0)
    port_m = metrics.MetricsRegistry(path=str(tmp_path / "pm.jsonl"), proc=0)
    ref_m = ref_metrics.MetricsRegistry(path=str(tmp_path / "rm.jsonl"),
                                        proc=0)
    _replay(calls, port_s, port_m, capacity)
    _replay(calls, ref_s, ref_m, capacity)
    assert port_s.emitted == ref_s.emitted > 0
    got = events.parse_events(port_s.path)
    assert _without_ts(got) == _without_ts(ref_events.parse_events(ref_s.path))
    assert all(tuple(e) == events.EVENT_FIELDS for e in got)
    assert port_m.snapshot() == ref_m.snapshot()
    assert port_m.prometheus_text() == ref_m.prometheus_text()
    drop_path = lambda d: {k: v for k, v in d.items()  # noqa: E731
                           if k != "path"}
    assert drop_path(port_m.describe()) == drop_path(ref_m.describe())
    port_m.maybe_flush(force=True)
    ref_m.maybe_flush(force=True)
    strip = lambda p: {k: v for k, v in json.loads(  # noqa: E731
        open(p).read()).items() if k not in ("ts", "uptime_s")}
    assert strip(port_m.path) == strip(ref_m.path)


@pytest.mark.parametrize("capacity,n", [(8, 5), (8, 30), (1024, 300)])
def test_histogram_quantiles_match_the_reference_and_numpy(capacity, n):
    rng = np.random.default_rng(n)
    xs = rng.lognormal(3.0, 1.0, n)
    port = metrics.Histogram("h", capacity=capacity)
    ref = ref_metrics.Histogram("h", capacity=capacity)
    for x in xs:
        port.observe(x)
        ref.observe(x)
    assert port.summary() == ref.summary()
    window = xs[-capacity:]
    for q in (50, 95, 99):
        assert port.percentile(q) == ref.percentile(q)
        np.testing.assert_allclose(port.percentile(q),
                                   np.percentile(window, q), rtol=1e-12)
        assert metrics.quantile(list(xs), q) == ref_metrics.quantile(
            list(xs), q)


def _trace_calls(tracer, lock_step):
    tracer.edge("compile")
    for step in (0, 5, 10):
        tracer.edge("step_round", step)
        with tracer.span("compute", phase="compute", step=step):
            with tracer.span("inner", phase="compute", tag="x"):
                lock_step()
        tracer.edge("io", step + 5)
        with tracer.span("device_to_host", phase="device_to_host",
                         step=step + 5):
            lock_step()
        tracer.instant("marker", step=step)
    tracer.edge("drain", 15)


def _worker_spans(tracer):
    def work():
        for step in (5, 10):
            with tracer.span("output", phase="output", step=step):
                pass
    t = threading.Thread(target=work, name="gs-async-io")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()


@pytest.mark.parametrize("max_events", [None, 5])
def test_traces_match_the_reference_and_validate(tmp_path, max_events):
    """The same spans through both tracers: both files pass the
    reference's ``validate_trace``, with the same events but the
    timestamps (the writer thread's spans on a track of their own)."""
    docs = []
    for mod, name in ((trace, "p.json"), (ref_trace, "r.json")):
        tr = mod.SpanTracer(str(tmp_path / name), proc=0,
                            max_events=max_events)
        _trace_calls(tr, lambda: None)
        _worker_spans(tr)
        assert tr.flush() == str(tmp_path / name)
        doc = json.loads((tmp_path / name).read_text())
        assert ref_trace.validate_trace(doc) == []
        assert trace.validate_trace(doc) == []
        docs.append((doc, tr.describe()["dropped"]))
    assert docs[0][1] == docs[1][1]
    assert (docs[0][1] > 0) == (max_events is not None)
    docs = [d for d, _ in docs]
    strip = lambda d: [{k: v for k, v in e.items()  # noqa: E731
                        if k not in ("ts", "dur")} for e in d["traceEvents"]]
    assert strip(docs[0]) == strip(docs[1])
    if max_events is None:
        tids = {e["tid"] for e in docs[0]["traceEvents"]
                if e.get("name") == "output"}
        assert tids and 0 not in tids and 1 not in tids


@pytest.mark.parametrize("doc,problem", [
    ({"traceEvents": [{"ph": "X", "name": "a", "pid": 0, "tid": 0,
                       "ts": 0, "dur": 10},
                      {"ph": "X", "name": "b", "pid": 0, "tid": 0,
                       "ts": 5, "dur": 10}]}, "partially overlaps"),
    ({"traceEvents": [{"ph": "X", "name": "a", "pid": 0, "tid": 0,
                       "ts": 0, "dur": -1}]}, "negative dur"),
    ({"events": []}, "no traceEvents"),
    ("x", "neither"),
])
def test_validate_trace_finds_what_the_reference_finds(doc, problem):
    got = trace.validate_trace(doc)
    assert got == ref_trace.validate_trace(doc)
    assert any(problem in p for p in got)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_rank_files_merge_in_either_package(tmp_path, writer):
    """One package writes ``.rank0``/``.rank1`` files; both packages'
    ``parse_events_multi`` merge them into the same ordered list."""
    mod = events if writer == "port" else ref_events
    base = str(tmp_path / "events.jsonl")
    streams = [mod.EventStream(f"{base}.rank{r}", proc=r) for r in (0, 1)]
    for step in range(6):
        streams[step % 2].emit("output", phase="io", step=step)
    (tmp_path / "events.jsonl.rank1.tmp").write_text("ignored\n")
    port = events.parse_events_multi(base)
    ref = ref_events.parse_events_multi(base)
    assert port == ref
    assert [e["step"] for e in port] == list(range(6))
    assert [e["proc"] for e in port] == [0, 1] * 3
    assert events.rank_files(base) == ref_events.rank_files(base)


def test_torn_lines_are_skipped(tmp_path):
    path = tmp_path / "e.jsonl"
    s = events.EventStream(str(path), proc=0)
    s.emit("run_start", step=0)
    with open(path, "a") as f:
        f.write('{"ts": 1, "kind": "out')
    assert events.parse_events(str(path)) == ref_events.parse_events(
        str(path))
    assert len(events.parse_events(str(path))) == 1


def test_a_stream_that_cannot_write_marks_itself_broken(tmp_path, capsys):
    s = events.EventStream(str(tmp_path / "missing" / "e.jsonl"), proc=0)
    assert s.emit("run_start") is None
    assert s.broken and "FileNotFoundError" in s.broken
    assert s.emit("output") is None
    assert s.describe()["broken"] == s.broken
    assert "further events are dropped" in capsys.readouterr().err


def test_bound_attrs_and_subscribers(tmp_path):
    s = events.EventStream(str(tmp_path / "e.jsonl"), proc=0)
    seen = []
    unsub = s.subscribe(seen.append)
    s.subscribe(lambda e: 1 / 0)
    with events.bound(batch="b1"):
        with events.bound(member=2):
            s.emit("output", step=3, member=5)
    unsub()
    s.emit("checkpoint")
    assert [e["attrs"] for e in seen] == [{"batch": "b1", "member": 5}]
    assert len(events.parse_events(s.path)) == 2


@pytest.mark.parametrize("var,path_attr,get", [
    ("GS_EVENTS", "path", events.get_events),
    ("GS_METRICS", "path", metrics.get_metrics),
    ("GS_TRACE", "path", trace.get_tracer),
])
def test_singletons_arm_from_the_environment_once(tmp_path, monkeypatch,
                                                  var, path_attr, get):
    monkeypatch.delenv(var, raising=False)
    assert get().enabled is False
    events.reset_events()
    metrics.reset_metrics()
    trace.reset_tracer()
    monkeypatch.setenv(var, str(tmp_path / "sink"))
    armed = get()
    assert armed.enabled and getattr(armed, path_attr) == str(
        tmp_path / "sink")
    monkeypatch.setenv(var, str(tmp_path / "other"))
    assert get() is armed


def test_null_sinks_do_nothing():
    assert metrics.NULL_METRIC.inc() is None
    assert metrics.NULL_METRIC.set(1) is None
    assert metrics.NULL_METRIC.observe(1.0) is None
    off = metrics.MetricsRegistry()
    assert off.counter("x") is metrics.NULL_METRIC
    assert off.maybe_flush(force=True) is None
    assert trace.NULL_TRACER.flush() is None
    with trace.NULL_TRACER.span("x"):
        pass
    assert events.NULL_EVENTS.emit("x") is None


@pytest.mark.parametrize("env,key,want", [
    (None, 0.0, 0.0), (None, 0.25, 0.25), ("0.05", 3.0, 0.05),
    ("", 2.0, 2.0),
])
def test_resolve_interval_matches_the_reference(monkeypatch, env, key,
                                                want):
    if env is None:
        monkeypatch.delenv("GS_METRICS_INTERVAL_S", raising=False)
    else:
        monkeypatch.setenv("GS_METRICS_INTERVAL_S", env)
    assert metrics.resolve_interval_s(
        Settings(metrics_interval_s=key)) == want
    assert ref_metrics.resolve_interval_s(
        RefSettings(metrics_interval_s=key)) == want


@pytest.mark.parametrize("var,value", [
    ("GS_METRICS_INTERVAL_S", "often"),
    ("GS_METRICS_INTERVAL_S", "-1"),
    ("GS_TRACE_MAX_EVENTS", "0"),
    ("GS_TRACE_MAX_EVENTS", "many"),
])
def test_bad_sink_knobs_raise_as_the_reference(tmp_path, monkeypatch, var,
                                               value):
    monkeypatch.setenv(var, value)
    monkeypatch.setenv("GS_TRACE", str(tmp_path / "t.json"))
    monkeypatch.setenv("GS_METRICS", str(tmp_path / "m.jsonl"))
    get = (metrics.get_metrics, ref_metrics.get_metrics) if var.startswith(
        "GS_METRICS") else (trace.get_tracer, ref_trace.get_tracer)
    ref_metrics.reset_metrics()
    ref_trace.reset_tracer()
    try:
        with pytest.raises(ValueError) as want:
            get[1]()
    finally:
        ref_metrics.reset_metrics()
        ref_trace.reset_tracer()
    with pytest.raises(ValueError) as got:
        get[0]()
    assert str(got.value) == str(want.value)


def test_rank_path_suffixes_only_across_processes(monkeypatch):
    from grayscott_jl_tpu_torch.parallel import distributed

    assert trace.rank_path("x.jsonl") == "x.jsonl"
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    assert trace.rank_path("x.jsonl") == "x.jsonl.rank1"
    assert events.EventStream("x.jsonl").proc == 1


def test_integrity_records_mirror_as_the_reference_journal(tmp_path,
                                                           monkeypatch):
    """``IntegrityLog.record`` lands on the stream as the reference's
    ``FaultJournal`` mirrors a record (``event`` -> kind, ``kind`` ->
    ``fault``), and a failover without a journal emits
    ``replica_failover`` itself."""
    from grayscott_jl_tpu.resilience import integrity as ref_integrity
    from grayscott_jl_tpu.resilience.supervisor import FaultJournal
    from grayscott_jl_tpu_torch.resilience import integrity

    rec = {"event": "scrub", "kind": "integrity", "step": 4,
           "store": "ckpt.bp", "checked": 2}
    for name, record in (("port", lambda: integrity.IntegrityLog().record(
            **rec)), ("ref", lambda: FaultJournal(
                str(tmp_path / "journal.jsonl")).record(**rec))):
        monkeypatch.setenv("GS_EVENTS", str(tmp_path / f"{name}.jsonl"))
        events.reset_events()
        ref_events.reset_events()
        try:
            record()
            err = OSError("disk")
            (integrity if name == "port" else ref_integrity
             )._announce_failover("a.bp", "a.bp.r1", err)
        finally:
            ref_events.reset_events()
    port = _without_ts(events.parse_events(str(tmp_path / "port.jsonl")))
    ref = _without_ts(events.parse_events(str(tmp_path / "ref.jsonl")))
    assert [e["kind"] for e in port] == ["scrub", "replica_failover"]
    assert port == ref
    assert port[0]["attrs"]["fault"] == "integrity"


def test_shutdown_listener_calls_on_request_once():
    import signal

    from grayscott_jl_tpu_torch.resilience.faults import ShutdownListener

    seen = []
    listener = ShutdownListener(on_request=seen.append)
    listener._handle(signal.SIGTERM, None)
    assert seen == [signal.SIGTERM] and listener.requested
    with pytest.raises(KeyboardInterrupt):
        listener._handle(signal.SIGINT, None)
    assert seen == [signal.SIGTERM]
    boom = ShutdownListener(on_request=lambda s: 1 / 0)
    boom._handle(signal.SIGTERM, None)
    assert boom.requested


def test_obs_package_exports_the_reference_names_but_profile_window():
    import grayscott_jl_tpu.obs as ref_obs
    import grayscott_jl_tpu_torch.obs as obs

    # The profiler window is ported (Queue 1 item 21b): every name.
    assert set(obs.__all__) == set(ref_obs.__all__)
    assert obs.ProfileWindow is trace.ProfileWindow
    assert os.path.basename(trace.__file__) == "trace.py"
