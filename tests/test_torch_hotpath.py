"""The hot path's instrumentation on CPU torch at L=16
(grayscott_jl_tpu_torch/obs/trace.py ``hot_armed`` / ``HotRange``, the
ranges of driver.py's round, ops/cuda_stencil.py's ``fused_step`` and
simulation.py's sharded exchange, and the counters of
``cuda_stencil.timings``).

* Off (no ``GS_TRACE``, no live capture), a 20-step run through
  ``driver.run_once`` reads the module's clock 0 times and opens no
  range.
* Under a CPU ``torch.profiler`` capture the ranges nest ``gs_phase``
  (the driver's phase edges) ⊃ ``gs_round`` ⊃ ``gs_launch`` ⊃ nothing of
  ours, one ``gs_launch`` per outermost ``fused_step`` call (an
  ensemble's batch of one member too) when every call is recorded, one
  in ``LAUNCH_RANGE_EVERY`` otherwise, one ``gs_sync`` per round beside
  them.
* A ``GS_TRACE`` span and a profiler range around the same block start
  within 100 µs of each other on the one clock, and a step of the wall
  clock moves no span's offset or duration.
* The ``compute`` span's args carry each round's counters, and they sum
  to the process's counters; a (2,1,1) sharded round's ``gs_exchange``
  ranges and its ``exchange_us`` likewise.

On the CPU the plain path runs inside ``gs_launch`` and counts no
launch; ``gs_launch_call`` and the launch counts are the card's
(tests/test_torch_card.py)."""

import json

import pytest
import torch

from grayscott_jl_tpu_torch import driver
from grayscott_jl_tpu_torch.config.settings import get_settings
from grayscott_jl_tpu_torch.obs import trace
from grayscott_jl_tpu_torch.ops import cuda_stencil
from test_torch_xstats import write_config

PHYSICS = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0)
#: 20 steps, a boundary every 5: four rounds, from steps 0, 5, 10, 15.
ROUNDS = (0, 5, 10, 15)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("GS_TRACE", "GS_PROFILE", "GS_PROFILE_DIR", "GS_TPU_PROFILE",
                "GS_TPU_STATS", "GS_FUSE", "GS_TPU_MESH_DIMS", "GS_XSTATS"):
        monkeypatch.delenv(var, raising=False)
    trace.reset_tracer()
    cuda_stencil.reset_launches()
    yield
    trace.reset_tracer()
    cuda_stencil.reset_launches()


def _settings(d, ensemble=False, **kw):
    """20 steps at L=16 through ``cuda_stencil.fused_step`` (the kernel
    language, which off the card runs the plain version)."""
    base = dict(steps=20, plotgap=5, checkpoint=False,
                kernel_language="CUDA")
    base.update(kw)
    cfg = write_config(d, **base, **PHYSICS)
    if ensemble:
        with open(cfg, "a") as f:
            f.write('[ensemble]\npresets = ["spots"]\n')
    return get_settings([cfg])


def _count_calls(monkeypatch):
    """Count the outermost ``fused_step`` calls (the simulation's)."""
    calls = []
    orig = cuda_stencil.fused_step

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(cuda_stencil, "fused_step", counted)
    return calls


def _ranges(prof):
    """Our ranges in a capture: ``(name, start_ns, end_ns)``."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("gs_")]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_off_reads_no_clock_and_opens_no_range(tmp_path, monkeypatch):
    assert not trace.hot_armed()  # binds the profiler's hooks
    reads, opened = [], []

    def clock():
        reads.append(1)
        return 0

    monkeypatch.setattr(trace, "clock_ns", clock)
    monkeypatch.setattr(trace, "_range", lambda name: opened.append(name))
    calls = _count_calls(monkeypatch)
    sim = driver.run_once(_settings(tmp_path), seed=3)
    assert sim.step == 20 and calls
    assert reads == [] and opened == []
    assert set(cuda_stencil.timings().values()) == {0}


@pytest.mark.parametrize("ensemble", [False, True], ids=["solo", "member1"])
def test_ranges_nest_under_a_cpu_capture(tmp_path, monkeypatch, ensemble):
    monkeypatch.setattr(cuda_stencil, "LAUNCH_RANGE_EVERY", 1)
    calls = _count_calls(monkeypatch)
    settings = _settings(tmp_path, ensemble=ensemble)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        driver.run_once(settings, seed=3)
    got = _ranges(prof)
    rounds = [r for r in got if r[0].startswith("gs_round")]
    launches = [r for r in got if r[0] == "gs_launch"]
    syncs = [r for r in got if r[0] == "gs_sync"]
    assert sorted(int(r[0].rsplit("=", 1)[1]) for r in rounds) == list(ROUNDS)
    assert calls and len(launches) == len(calls)
    assert len(syncs) == len(rounds)
    for r in launches + syncs:
        assert sum(_inside(r, o) for o in rounds) == 1, r
    phases = [r for r in got if r[0].startswith("gs_phase ")]
    assert {"gs_phase compile", "gs_phase drain"} <= {r[0] for r in phases}
    for r in rounds:
        assert sum(_inside(r, p) for p in phases) == 1, r
    for launch in launches:
        assert not [r for r in got if r is not launch and _inside(r, launch)]
    for s in syncs:
        assert not any(_inside(launch, s) or _inside(s, launch)
                       for launch in launches)
    t = cuda_stencil.timings()
    assert t["launches"] == cuda_stencil.LAUNCHES == 0
    assert t["dispatch_ns"] > 0 and t["call_ns"] == 0 and t["sync_ns"] > 0
    assert t["ops_ns"] == 0


@pytest.mark.parametrize("every", [3, 100])
def test_launch_ranges_sampled_counters_whole(tmp_path, monkeypatch, every):
    """One ``fused_step`` call in ``LAUNCH_RANGE_EVERY`` is a range in
    the capture (the first, then every N-th); each is timed, and every
    round is a range."""
    monkeypatch.setattr(cuda_stencil, "LAUNCH_RANGE_EVERY", every)
    calls = _count_calls(monkeypatch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        driver.run_once(_settings(tmp_path), seed=3)
    got = _ranges(prof)
    launches = [r for r in got if r[0] == "gs_launch"]
    assert len(calls) > 3
    assert len(launches) == -(-len(calls) // every)
    assert len([r for r in got if r[0].startswith("gs_round")]) == 4
    assert cuda_stencil._TIMED_CALLS == len(calls)
    assert cuda_stencil.timings()["dispatch_ns"] > 0


def test_trace_span_and_profiler_range_share_the_clock(tmp_path):
    tracer = trace.SpanTracer(str(tmp_path / "t.json"), proc=0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm"):
            pass
        with tracer.span("twin"):
            with torch.profiler.record_function("twin"):
                sum(range(1000))
    tracer.flush()
    doc = json.loads((tmp_path / "t.json").read_text())
    (span,) = [e for e in doc["traceEvents"] if e.get("name") == "twin"]
    at_ns = doc["baseTimeNanoseconds"] + span["ts"] * 1e3
    (twin,) = [e.start_ns() for e in prof.profiler.kineto_results.events()
               if e.name() == "twin"]
    assert abs(twin - at_ns) < 100e3
    assert doc["otherData"]["epoch_unix_s"] == round(
        doc["baseTimeNanoseconds"] / 1e9, 6)
    assert trace.validate_trace(doc) == []


def test_wall_clock_step_moves_no_span(tmp_path, monkeypatch):
    """The base is read on the wall clock once; offsets and durations
    on the monotonic one, so a wall clock set back mid-run leaves the
    spans nested and their durations whole."""
    tracer = trace.SpanTracer(str(tmp_path / "t.json"), proc=0)
    monkeypatch.setattr(trace.time, "time_ns", lambda: 0)
    with tracer.span("outer"):
        with tracer.span("inner"):
            with trace.HotRange("gs_sync", record=False) as rng:
                sum(range(1000))
    tracer.flush()
    doc = json.loads((tmp_path / "t.json").read_text())
    spans = {e["name"]: e for e in doc["traceEvents"] if e.get("ph") == "X"}
    outer, inner = spans["outer"], spans["inner"]
    assert 0 <= outer["ts"] <= inner["ts"] and inner["dur"] > 0
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert rng.ns > 0 and doc["baseTimeNanoseconds"] > 0
    assert trace.validate_trace(doc) == []


def _compute_spans(path):
    with open(path) as f:
        doc = json.load(f)
    assert trace.validate_trace(doc) == []
    return [e for e in doc["traceEvents"]
            if e.get("ph") == "X" and e.get("name") == "compute"]


def _assert_sums(spans, key):
    got = sum(e["args"][f"{key}_us"] for e in spans)
    want = cuda_stencil.timings()[f"{key}_ns"] / 1e3
    assert got == pytest.approx(want, abs=1e-3 * len(spans))


def test_compute_span_args_carry_the_rounds_counters(tmp_path, monkeypatch):
    path = tmp_path / "trace.json"
    monkeypatch.setenv("GS_TRACE", str(path))
    driver.run_once(_settings(tmp_path), seed=3)
    trace.get_tracer().flush()
    spans = _compute_spans(path)
    assert sorted(e["args"]["step"] for e in spans) == list(ROUNDS)
    for e in spans:
        a = e["args"]
        assert set(a) == {"step", "launches", "dispatch_us", "call_us",
                          "ops_us", "sync_us", "exchange_us"}
        assert a["launches"] == 0 and a["call_us"] == a["ops_us"] == 0
        assert a["exchange_us"] == 0
        assert 0 < a["dispatch_us"] + a["sync_us"] <= e["dur"]
    for key in ("dispatch", "sync"):
        _assert_sums(spans, key)


@pytest.mark.parametrize("language", ["CUDA", "Plain"])
def test_sharded_round_exchange_is_a_range(tmp_path, monkeypatch, language):
    """(2,1,1) on the one CPU device: every round's halo exchange is a
    ``gs_exchange`` range in its round and in no launch, and its time is
    the round's ``exchange_us``."""
    path = tmp_path / "trace.json"
    monkeypatch.setenv("GS_TRACE", str(path))
    monkeypatch.setenv("GS_TPU_MESH_DIMS", "2,1,1")
    settings = _settings(tmp_path, kernel_language=language)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sim = driver.run_once(settings, n_devices=2, seed=3)
    assert tuple(sim.domain.dims) == (2, 1, 1)
    trace.get_tracer().flush()
    got = _ranges(prof)
    rounds = [r for r in got if r[0].startswith("gs_round")]
    launches = [r for r in got if r[0] == "gs_launch"]
    exchanges = [r for r in got if r[0] == "gs_exchange"]
    assert len(rounds) == len(ROUNDS)
    assert len(exchanges) >= sim.exchange_rounds > 0
    for x in exchanges:
        assert sum(_inside(x, o) for o in rounds) == 1
        assert not any(_inside(x, launch) or _inside(launch, x)
                       for launch in launches)
    spans = _compute_spans(path)
    assert all(e["args"]["exchange_us"] > 0 for e in spans)
    _assert_sums(spans, "exchange")
