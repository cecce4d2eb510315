"""Build and launch analytics (grayscott_jl_tpu_torch/obs/xstats.py,
``GS_XSTATS`` / ``xstats``) on CPU torch at L <= 16, held against the
reference's ``grayscott_jl_tpu/obs/xstats.py``.

* ``resolve_xstats`` equals the reference's on every value (bad values
  raise ``ValueError`` in both), env over key.
* ``summarize`` and ``publish`` give the reference's keys, counters and
  event for the same record list.
* A run with ``GS_XSTATS=1`` writes the ``executables`` section with the
  reference's top-level keys, and its stores are bitwise the stores of
  the run without it, for all four models.
* A compile cache directory arms the analytics implicitly, as in the
  reference; the native engine's g++ build is a ``miss`` with its
  seconds into a fresh directory and a ``hit`` with 0 s after, and a
  kernel library build injected through the build seam
  (``xstats.library_builds``) is recorded the same way with its ptxas
  lines.
* The exchange census on in-process (2,2,2) and (2,1,1) meshes at depth
  1 and 2 against the reference's ``collective_counts`` of the same mesh
  and depth: the reference counts the collective-permute ops of its
  compiled round, the port its ppermute calls per round, one call per
  op, so the two are equal.
* Launch records: one per kernel entry launched, their cost the one
  reckoning of the smoke's bounds (row 1a at L=256: 0.0801 ms)."""

import glob
import hashlib
import json
import os

import pytest

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.obs import xstats as ref_xstats
from grayscott_jl_tpu.simulation import Simulation as RefSimulation
from grayscott_jl_tpu_torch import Settings, Simulation, driver
from grayscott_jl_tpu_torch.config import settings as config
from grayscott_jl_tpu_torch.models import get_model
from grayscott_jl_tpu_torch.obs import events, metrics, trace, xstats
from grayscott_jl_tpu_torch.ops import cuda_stencil, kernelgen
from test_torch_multiprocess import LAUNCH_VARS

PHYSICS = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0)

#: Every model, as its settings-file keys (examples/settings-*.toml).
MODELS = {
    "grayscott": dict(PHYSICS),
    "brusselator": {"dt": 0.05, "model": {"name": "brusselator", "A": 1.0,
                                          "B": 3.0, "Du": 0.2, "Dv": 0.02}},
    "fhn": {"dt": 0.05, "model": {"name": "fhn", "a": 0.7, "b": 0.8,
                                  "eps": 0.08, "I": 0.5, "Dv": 0.2,
                                  "Dw": 0.0}},
    "heat": {"dt": 0.05, "model": {"name": "heat", "D": 0.2}},
}

VARS = ("GS_XSTATS", "GS_COMPILE_CACHE", "GS_COMPILE_CACHE_FORCE",
        "GS_TPU_STATS", "GS_EVENTS", "GS_METRICS", "GS_TRACE", "GS_FUSE",
        "GS_TPU_MESH_DIMS", "GS_SUPERVISE", "GS_TPU_NATIVE_IO")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in VARS + LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    events.reset_events()
    metrics.reset_metrics()
    trace.reset_tracer()
    yield
    events.reset_events()
    metrics.reset_metrics()
    trace.reset_tracer()


def _toml_value(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return f'"{v}"'
    return repr(v)


def write_config(d, **kw):
    """``d/config.toml``: 10 steps at L=16, plotgap 5, a checkpoint at
    step 5, the stores in ``d``."""
    d.mkdir(parents=True, exist_ok=True)
    model = kw.pop("model", None)
    base = dict(L=16, steps=10, plotgap=5, noise=0.1, checkpoint=True,
                checkpoint_freq=5, precision="Float32", backend="CPU",
                output=str(d / "gs.bp"), checkpoint_output=str(d / "ck.bp"))
    base.update(kw)
    lines = [f"{k} = {_toml_value(v)}" for k, v in base.items()]
    if model:
        lines.append("[model]")
        lines += [f"{k} = {_toml_value(v)}" for k, v in model.items()]
    (d / "config.toml").write_text("\n".join(lines) + "\n")
    return str(d / "config.toml")


def store_files(d):
    """sha256 of every store file the run wrote in ``d``."""
    out = {}
    for p in glob.glob(str(d / "**"), recursive=True):
        rel = os.path.relpath(p, d)
        if os.path.isfile(p) and not rel.endswith((".json", ".toml")):
            with open(p, "rb") as f:
                out[rel] = hashlib.sha256(f.read()).hexdigest()
    return out


class Recorder:
    """A metrics registry and event stream that record what ``publish``
    does with them."""

    def __init__(self):
        self.calls = []

    def counter(self, name, **labels):
        return _Instrument(self.calls, "counter", name)

    def gauge(self, name, **labels):
        return _Instrument(self.calls, "gauge", name)

    def emit(self, kind, **attrs):
        self.calls.append(("emit", kind, attrs))


class _Instrument:
    def __init__(self, calls, kind, name):
        self.calls, self.kind, self.name = calls, kind, name

    def inc(self, n=1):
        self.calls.append((self.kind, self.name, "inc", n))

    def set(self, v):
        self.calls.append((self.kind, self.name, "set", v))


# ------------------------------------------------------------ resolution

@pytest.mark.parametrize("where", ["env", "key"])
@pytest.mark.parametrize("value", [
    None, "", "1", "on", "true", "yes", "ON", " 1 ", "0", "off", "false",
    "no", "maybe", "2", "enabled",
])
def test_resolve_xstats_matches_the_reference(value, where, monkeypatch):
    """The port's ``resolve_xstats`` (in ``config/settings.py``, and the
    name ``obs/xstats.py`` keeps) equals the reference's on every value,
    from the environment or the key; a bad value raises ``ValueError``
    in both."""
    assert xstats.resolve_xstats is config.resolve_xstats
    kw = {}
    if value is not None:
        if where == "env":
            monkeypatch.setenv("GS_XSTATS", value)
        else:
            kw["xstats"] = value
    port_s, ref_s = Settings(**kw), RefSettings(**kw)
    try:
        want = ref_xstats.resolve_xstats(ref_s)
    except ValueError as e:
        with pytest.raises(ValueError, match="GS_XSTATS / xstats"):
            xstats.resolve_xstats(port_s)
        assert "must be on or off" in str(e)
        return
    assert xstats.resolve_xstats(port_s) is want


def test_env_wins_over_the_key(monkeypatch):
    monkeypatch.setenv("GS_XSTATS", "off")
    s = Settings(xstats="on")
    assert xstats.resolve_xstats(s) is ref_xstats.resolve_xstats(s) is False
    assert "xstats" not in config.NOT_PORTED


# ------------------------------------------------------ summary and sinks

RECORDS = [
    {"name": "grayscott", "compile_s": 6.25, "record": "library",
     "cache": "miss"},
    {"name": "libbplite", "compile_s": 0.0, "record": "library",
     "cache": "hit"},
    {"name": "grayscott", "compile_s": 0.0, "record": "library",
     "cache": "unknown"},
    {"name": "kBlock[f32]", "compile_s": 0.0, "record": "launch",
     "launches": 200, "cost": {"bytes": 268435456}},
]


@pytest.mark.parametrize("n", [0, 1, 2, 4])
def test_summarize_matches_the_reference(n):
    records = RECORDS[:n]
    assert xstats.summarize(records) == ref_xstats.summarize(records)


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_publish_matches_the_reference(i):
    """The same counters, gauge and ``executable`` event as the
    reference's ``publish`` for the same record."""
    port, ref = Recorder(), Recorder()
    xstats.publish(RECORDS[i], metrics=port, events=port)
    ref_xstats.publish(RECORDS[i], metrics=ref, events=ref)
    assert port.calls == ref.calls
    assert port.calls[0] == ("emit", "executable",
                             {"phase": "compile", **RECORDS[i]})


def test_cache_listing_and_capture_match_the_reference(tmp_path):
    """A build that adds an entry is a miss, one that leaves the
    directory as it was a hit, and a missing listing unknown — in both
    packages."""
    before = xstats.cache_listing(str(tmp_path))
    assert before == ref_xstats.cache_listing(str(tmp_path)) == frozenset()
    assert xstats.cache_listing(None) is ref_xstats.cache_listing(None)
    (tmp_path / "lib.so").write_bytes(b"x")
    miss = xstats.capture(name="lib", compile_s=1.5, cache_dir=str(tmp_path),
                          cache_before=before)
    hit = xstats.capture(name="lib", compile_s=0, cache_dir=str(tmp_path),
                         cache_before=xstats.cache_listing(str(tmp_path)))
    unknown = xstats.capture(name="lib", compile_s=0,
                             cache_dir=str(tmp_path), cache_before=None)
    assert (miss["cache"], hit["cache"], unknown["cache"]) == (
        "miss", "hit", "unknown")
    assert miss == {"name": "lib", "compile_s": 1.5, "cache": "miss"}


# ----------------------------------------------------------------- runs


@pytest.fixture(scope="module")
def reference_section(tmp_path_factory):
    """The reference's ``executables`` section of a CPU run with
    ``GS_XSTATS=1`` (its driver, the XLA path)."""
    from grayscott_jl_tpu import driver as ref_driver

    d = tmp_path_factory.mktemp("ref")
    cfg = write_config(d, kernel_language="XLA", **PHYSICS)
    mp = pytest.MonkeyPatch()
    for var in VARS:
        mp.delenv(var, raising=False)
    mp.setenv("GS_XSTATS", "1")
    mp.setenv("GS_TPU_STATS", str(d / "stats.json"))
    try:
        ref_driver.main([cfg])
    finally:
        mp.undo()
    with open(d / "stats.json") as f:
        return json.load(f)["executables"]


def _run(monkeypatch, d, env, **kw):
    cfg = write_config(d, **kw)
    with monkeypatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        events.reset_events()
        metrics.reset_metrics()
        try:
            sim = driver.main([cfg])
        finally:
            events.reset_events()
            metrics.reset_metrics()
    return sim


@pytest.mark.parametrize("model", list(MODELS))
def test_xstats_run_writes_the_section_and_keeps_the_stores(
        model, tmp_path, monkeypatch, reference_section):
    """``GS_XSTATS=1``: the section carries the reference's top-level
    keys (and the port's exchange census), one record per library the
    run builds or loads (on the CPU the native store engine), the
    ``executable`` events and the counters; the stores are bitwise the
    run without analytics."""
    kw = dict(MODELS[model])
    off = _run(monkeypatch, tmp_path / "off", {}, **kw)
    assert not off.xstats_enabled and off.executables == []
    stats = tmp_path / "on" / "stats.json"
    on = _run(monkeypatch, tmp_path / "on", {
        "GS_XSTATS": "1", "GS_TPU_STATS": str(stats),
        "GS_EVENTS": str(tmp_path / "ev.jsonl"),
        "GS_METRICS": str(tmp_path / "m.jsonl")}, **kw)
    assert on.xstats_enabled
    assert store_files(tmp_path / "on") == store_files(tmp_path / "off")
    section = json.loads(stats.read_text())["executables"]
    assert set(reference_section) <= set(section)
    assert set(section) - set(reference_section) == {"collectives"}
    names = [r["name"] for r in section["records"]]
    assert names == ["libbplite"]
    assert section["compiles"] == 1 and section["records"][0]["cache"] in (
        "hit", "miss")
    evs = [json.loads(line) for line in open(tmp_path / "ev.jsonl")]
    assert [e["attrs"]["name"] for e in evs if e["kind"] == "executable"] == (
        names)
    snap = json.loads(stats.read_text())["metrics"]
    counters = {c["name"]: c["value"] for c in snap["counters"]}
    assert counters["compiles"] == 1
    assert section["collectives"] == {"ppermute": 0, "rounds": 0}


def test_compile_cache_arms_xstats_implicitly(tmp_path, monkeypatch):
    """A compile cache directory arms the analytics in both packages
    (GS_COMPILE_CACHE_FORCE=1 keeps a cache on the CPU in both): the
    store engine's g++ build is a miss with its seconds into the fresh
    directory, then a hit with 0 s."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("GS_COMPILE_CACHE", str(cache))
    monkeypatch.setenv("GS_COMPILE_CACHE_FORCE", "1")
    ref = RefSimulation(RefSettings(L=8, backend="CPU", precision="Float32",
                                    kernel_language="XLA"))
    assert ref.xstats_enabled
    first = Simulation(Settings(L=8, backend="CPU"))
    assert first.xstats_enabled and first.compile_cache_dir == str(cache)
    (rec,) = first.executables
    assert (rec["name"], rec["cache"], rec["compiler"]) == (
        "libbplite", "miss", "g++")
    assert rec["compile_s"] > 0
    assert os.listdir(cache)
    again = Simulation(Settings(L=8, backend="CPU"))
    assert [(r["name"], r["cache"], r["compile_s"])
            for r in again.executables] == [("libbplite", "hit", 0.0)]
    monkeypatch.setenv("GS_COMPILE_CACHE", "off")
    assert not Simulation(Settings(L=8, backend="CPU")).xstats_enabled


def test_a_kernel_build_through_the_seam(tmp_path, monkeypatch):
    """A kernel library's build, injected through the build seam (a
    build that writes its library into the cache directory and
    returns nvcc's seconds and log): a miss with its seconds and ptxas
    lines, then a hit with 0 s; a failing build is recorded, not
    raised."""
    cache = tmp_path / "kernels"
    log = ("ptxas info    : Compiling entry function 'kernel' for 'sm_90a'\n"
           "ptxas info    : Used 64 registers, used 1 barriers, 16 bytes smem\n"
           "ptxas info    : 0 bytes stack frame, 0 bytes spill stores\n")

    def build():
        path = cache / "grayscott.0123.so"
        if path.exists():
            return {"seconds": 0.0, "log": ""}
        cache.mkdir(exist_ok=True)
        path.write_bytes(b"\x7fELF")
        return {"seconds": 5.5, "log": log}

    def broken():
        raise RuntimeError("nvcc exited 1")

    seam = [("grayscott", build, str(cache),
             {"record": "library", "compiler": "nvcc"})]
    monkeypatch.setattr(xstats, "library_builds", lambda sim: list(seam))
    monkeypatch.setenv("GS_XSTATS", "1")
    first = Simulation(Settings(L=8, backend="CPU"))
    (rec,) = first.executables
    assert (rec["cache"], rec["compile_s"]) == ("miss", 5.5)
    assert rec["ptxas"] == [line.strip() for line in log.splitlines()]
    (rec,) = Simulation(Settings(L=8, backend="CPU")).executables
    assert (rec["cache"], rec["compile_s"], "ptxas" in rec) == (
        "hit", 0.0, False)
    seam[:] = [("grayscott", broken, str(cache), {"record": "library"})]
    (rec,) = Simulation(Settings(L=8, backend="CPU")).executables
    assert rec["cache"] == "unknown" and "nvcc exited 1" in rec["error"]


# -------------------------------------------------------------- census


@pytest.mark.parametrize("fuse", [1, 2])
@pytest.mark.parametrize("dims", [(2, 2, 2), (2, 1, 1)])
def test_collective_census_against_the_reference(dims, fuse, monkeypatch):
    """The reference's census counts the collective-permute ops of its
    compiled round (each ppermute one op, whatever the round count);
    the port's counts its ppermute calls per exchange round. On the same
    mesh and depth they are equal, and the port's splits by axis."""
    monkeypatch.setenv("GS_FUSE", str(fuse))
    monkeypatch.setenv("GS_XSTATS", "1")
    n = dims[0] * dims[1] * dims[2]
    ref = RefSimulation(RefSettings(L=16, backend="CPU", precision="Float32",
                                    kernel_language="XLA", noise=0.1,
                                    **PHYSICS),
                        n_devices=n, mesh_dims=dims)
    ref.iterate(4)
    (rec,) = ref.executables
    port = Simulation(Settings(L=16, backend="CPU", precision="Float32",
                               kernel_language="Pallas", noise=0.1,
                               **PHYSICS), n_devices=n, mesh_dims=dims)
    port.iterate(4)
    census = xstats.collective_counts(port)
    assert census["ppermute"] == rec["collectives"]["collective-permute"]
    assert census["rounds"] == 4 // fuse
    sharded = [a for a, d in zip("xyz", dims) if d > 1]
    assert {a: census[a] for a in sharded} == {a: 2 for a in sharded}
    assert "p2p_sends" not in census


# ---------------------------------------------------------------- launches


def test_launch_cost_is_the_smokes_reckoning():
    """Row 1a at L=256 (PERF.md §6): one float32 ``kBlock`` launch moves
    each field once each way, 0.0801 ms at 3.35 TB/s; a batched launch
    of N members N times that; the face modes as ``face_mode_work``."""
    flops = kernelgen.get_spec(get_model("grayscott")).flops_per_cell_step()
    cost = xstats.launch_cost("chain", (256,) * 3, 1, flops)
    assert cost["bytes"] == 2 * 2 * 4 * 256**3
    assert (cost["bound_ms"], cost["bound_by"]) == xstats.bound_ms(
        256, 1, flops)
    assert round(cost["bound_ms"], 4) == 0.0801
    five = xstats.launch_cost("chain", (256,) * 3, 1, flops, members=5)
    assert five["bytes"] == 5 * cost["bytes"]
    assert round(five["bound_ms"], 4) == 0.4006
    faces = xstats.launch_cost("faces6", (128,) * 3, 1, flops)
    assert (faces["bytes"], faces["flops"]) == xstats.face_mode_work(
        "faces6", (128,) * 3, 1, flops)
    assert round(faces["bound_ms"], 4) == 0.0103


def test_entry_launches_are_counted_and_recorded(monkeypatch):
    """Each launch counts under its entry's key (and is cleared with the
    other counts); a run's records name each entry it launched, with its
    cost and, off the card, the attribute query's error."""
    cuda_stencil.reset_launches()
    key = ("grayscott", "chain", "f32", 1, 1, (16, 16, 16), False)
    before = dict(cuda_stencil.ENTRY_LAUNCHES)
    for _ in range(3):
        cuda_stencil.count_launch("chain", "tma", entry="f32",
                                  model="grayscott", fuse=1,
                                  shape=(16, 16, 16))
    cuda_stencil.count_launch("copy_walk", "tma")
    assert cuda_stencil.ENTRY_LAUNCHES == {key: 3}
    sim = Simulation(Settings(L=16, backend="CPU"))
    xstats.capture_launches(sim, before)
    (rec,) = sim.executables
    assert (rec["name"], rec["record"], rec["launches"], rec["compile_s"]) == (
        "kBlock[f32]", "launch", 3, 0.0)
    assert rec["cost"] == xstats.launch_cost(
        "chain", (16, 16, 16), 1,
        kernelgen.get_spec(sim.model).flops_per_cell_step())
    assert "memory" not in rec and "error" in rec
    cuda_stencil.reset_launches()
    assert cuda_stencil.ENTRY_LAUNCHES == {}
