"""The numerics probes (grayscott_jl_tpu_torch/obs/numerics.py,
``Simulation.numerics_stats`` and ``snapshot_async(numerics=True)``) and
the drift gate (``resilience/health.DriftGate``) against the reference's
``obs/numerics.py`` and ``resilience/health.py``.

The port's probe reduces each block to partials (min, max, float64 sums
of the float32-widened cells and of their squares, the cell and
non-finite counts) and merges them; the reference reduces the global
array in float32 inside one jit. On the same fields ``min``, ``max``
and ``nonfinite`` are equal and ``mean``/``l2`` agree within
:data:`RTOL` = 1e-5 (relative): the reference's float32 sums round at
every addition (1.5e-6 was seen on ``l2`` of 1,080 bfloat16 cells),
the port's float64 ones hardly at all, so 1e-6 does not hold. Fields
are made with numpy from a seed."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.obs import numerics as ref_numerics
from grayscott_jl_tpu.obs.events import EventStream as RefEventStream
from grayscott_jl_tpu.obs.events import parse_events as ref_parse
from grayscott_jl_tpu.obs.metrics import MetricsRegistry as RefRegistry
from grayscott_jl_tpu.resilience import health as ref_health
from grayscott_jl_tpu.simulation import Simulation as RefSimulation
from grayscott_jl_tpu_torch import Settings, Simulation
from grayscott_jl_tpu_torch.carry import blocks_from_reference
from grayscott_jl_tpu_torch.obs import numerics
from grayscott_jl_tpu_torch.obs.events import EventStream
from grayscott_jl_tpu_torch.obs.metrics import MetricsRegistry
from grayscott_jl_tpu_torch.resilience import health

#: Relative tolerance of ``mean`` and ``l2`` against the reference.
RTOL = 1e-5

GS = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0)


def _fields(seed, shape=(12, 10, 9), bad=()):
    """Two float64 fields from a seed, with ``bad`` values planted."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.2, 1.3, shape)
    v = rng.uniform(0.0, 0.6, shape)
    for i, x in enumerate(bad):
        u.flat[7 * i + 3] = x
    return u, v


def _port_report(arrays, dtype, split=1):
    """The port's report of host ``arrays`` as ``dtype`` tensors, each
    cut into ``split`` blocks along x."""
    ts = [torch.from_numpy(a).to(dtype) for a in arrays]
    rows = [numerics.device_partials(*(t[sl] for t in ts)).numpy()
            for sl in (slice(i * ts[0].shape[0] // split,
                             (i + 1) * ts[0].shape[0] // split)
                       for i in range(split))]
    return numerics.report_of(numerics.combine(rows), ("u", "v"))


def _ref_report(arrays, dtype):
    raw = ref_numerics.device_numerics_probe(
        *(jnp.asarray(a).astype(dtype) for a in arrays))
    return ref_numerics.resolve_report(jax.device_get(raw), ("u", "v"))


def assert_reports_agree(port, ref):
    assert port.fields.keys() == ref.fields.keys()
    for name, want in ref.fields.items():
        got = port.fields[name]
        for stat in ("min", "max"):
            np.testing.assert_equal(got[stat], want[stat], err_msg=stat)
        assert got["nonfinite"] == want["nonfinite"]
        for stat in ("mean", "l2"):
            np.testing.assert_allclose(got[stat], want[stat], rtol=RTOL,
                                       equal_nan=True, err_msg=stat)


@pytest.fixture
def x64():
    prior = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prior)


@pytest.mark.parametrize("bad", [(), (math.nan,), (math.inf,),
                                 (-math.inf, 2.0), (math.inf, -math.inf)],
                         ids=["finite", "nan", "inf", "-inf", "inf-inf"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", [1, 3])
def test_probe_matches_reference(dtype, bad, split):
    arrays = _fields(4, bad=bad)
    port = _port_report(arrays, getattr(torch, dtype), split)
    assert_reports_agree(port, _ref_report(arrays, getattr(jnp, dtype)))
    assert port.finite == (not bad)


@pytest.mark.parametrize("bad", [(), (math.nan, math.inf)],
                         ids=["finite", "nan-inf"])
def test_probe_matches_reference_float64(bad, x64):
    """Float64 fields are widened to float32 first, as the reference
    does (its probe casts before reducing)."""
    arrays = _fields(5, bad=bad)
    assert_reports_agree(_port_report(arrays, torch.float64),
                         _ref_report(arrays, jnp.float64))


def test_merge_is_the_same_for_any_split_of_the_blocks():
    """Correctly rounded sums: the blocks merged in any order and any
    grouping give the same bits."""
    arrays = _fields(6, shape=(16, 8, 8))
    ts = [torch.from_numpy(a).float() for a in arrays]
    rows = [numerics.device_partials(*(t[i:i + 2] for t in ts)).numpy()
            for i in range(0, 16, 2)]
    once = numerics.combine(rows)
    rng = np.random.default_rng(0)
    shuffled = [rows[i] for i in rng.permutation(len(rows))]
    assert numerics.combine(shuffled) == once


def _mesh(monkeypatch, L=10, dims=(3, 1, 1)):
    n = math.prod(dims)
    if len(jax.devices()) < n:
        pytest.skip("needs 8 virtual CPU devices")
    monkeypatch.setenv("GS_TPU_MESH_DIMS", ",".join(map(str, dims)))
    ref = RefSimulation(RefSettings(L=L, noise=0.1, precision="Float32",
                                    backend="CPU", **GS), n_devices=n,
                        seed=3)
    port = Simulation(Settings(L=L, noise=0.1, precision="Float32",
                               backend="CPU", **GS), n_devices=n, seed=3)
    return ref, port


@pytest.mark.parametrize("steps", [0, 6])
def test_padded_mesh_probe_covers_the_pad_cells(monkeypatch, steps):
    """L=10 on (3,1,1) stores 12 planes in x, two of them pad: the
    reference's statistics cover the padded storage grid, and so do the
    port's (the reference's fields carried into the port's blocks)."""
    ref, port = _mesh(monkeypatch)
    ref.iterate(steps)
    storage = [np.asarray(f) for f in ref.fields]
    assert storage[0].shape == (12, 10, 10)
    port.blocks = blocks_from_reference(storage, port)
    want = ref_numerics.resolve_report(
        jax.device_get(ref_numerics.device_numerics_probe(*ref.fields)),
        ("u", "v"))
    stats = port.numerics_stats()
    assert_reports_agree(stats, want)
    snap = port.snapshot_async(health=True, numerics=True, checksum=True)
    assert snap.numerics_report().fields == stats.fields
    assert snap.health_report().finite
    assert set(snap.checksum_report()) == {"u", "v"}
    # The pad planes count, as in the reference's global array.
    rows = [numerics.device_partials(*b).numpy() for b in port.blocks]
    assert sum(r[numerics.PARTIALS.index("count")] for r in rows) == 1200
    for name, a in zip(("u", "v"), storage):
        np.testing.assert_allclose(stats.fields[name]["mean"],
                                   np.mean(a, dtype=np.float64), rtol=RTOL)


def test_snapshot_probe_reads_the_pristine_fields():
    """The probe in the snapshot sees the fields, not the bitflip hook's
    corrupted copy, and changes nothing: the blocks after it are the
    same as without it."""
    sim = Simulation(Settings(L=8, noise=0.1, precision="Float32",
                              backend="CPU", **GS), seed=1)
    sim.iterate(3)
    plain = sim.snapshot_async().blocks()
    snap = sim.snapshot_async(numerics=True, health=True)
    np.testing.assert_array_equal(snap.blocks()[0][2], plain[0][2])
    flipped = sim.snapshot_async(numerics=True, bitflip=True)
    assert not np.array_equal(flipped.blocks()[0][2], plain[0][2])
    u, _ = sim.get_fields()
    np.testing.assert_array_equal(u, plain[0][2])
    for s in (snap, flipped):
        rep = s.numerics_report().fields["u"]
        assert rep["min"] == float(u.min()) and rep["max"] == float(u.max())
        assert rep["mean"] == pytest.approx(
            float(np.mean(u, dtype=np.float64)), rel=RTOL)


def test_poison_drift_scales_the_corner_box_on_a_mesh(monkeypatch):
    """``poison_drift`` scales the global ``[0:2]^3`` corner of ``u``
    (in the block that holds it), as the reference's does, and the
    trajectory elsewhere is untouched."""
    ref, port = _mesh(monkeypatch, L=12, dims=(2, 2, 2))
    ref.iterate(2)
    port.iterate(2)
    before = port.get_fields()
    ref.poison_drift(factor=8.0)
    port.poison_drift(factor=8.0)
    after = port.get_fields()
    want = before[0].copy()
    want[:2, :2, :2] *= np.float32(8.0)
    np.testing.assert_array_equal(after[0], want)
    np.testing.assert_array_equal(after[1], before[1])
    np.testing.assert_allclose(after[0], np.asarray(ref.get_fields()[0]),
                               atol=1e-5)
    with pytest.raises(ValueError, match="unknown field"):
        port.poison_drift(field="w")


def _report_sequence(seed, n=7, trip_at=4):
    """``n`` per-field statistics dicts from a seed; the ``u`` max jumps
    8x at probe ``trip_at``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        fields = {}
        for name in ("u", "v"):
            lo, hi = rng.uniform(-0.1, 0.1), rng.uniform(0.9, 1.1)
            if name == "u" and i == trip_at:
                hi *= 8.0
            fields[name] = {"min": lo, "max": hi,
                            "mean": rng.uniform(0.4, 0.6),
                            "l2": rng.uniform(10.0, 11.0),
                            "nonfinite": 0}
        out.append(fields)
    return out


def _drive(recorder_cls, report_cls, gate, stream, registry, reports,
           window):
    rec = recorder_cls(("u", "v"), metrics=registry, events=stream,
                       gate=gate, labels={"model": "grayscott"},
                       window=window)
    raised = None
    for i, fields in enumerate(reports):
        try:
            rec.observe(10 * (i + 1), report_cls(
                {k: dict(v) for k, v in fields.items()}),
                boundary=bool(i % 2))
        except ref_health.HealthError as e:  # the reference's DriftError
            raised = (i, type(e).__name__, str(e))
            break
        except health.HealthError as e:
            raised = (i, type(e).__name__, str(e))
            break
    return rec, raised


def _without_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


@pytest.mark.parametrize("policy", ["warn", "abort", "off"])
@pytest.mark.parametrize("window", [1, 3, 8])
def test_recorder_and_gate_match_the_reference(tmp_path, policy, window):
    reports = _report_sequence(window)
    port_ev, ref_ev = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    port_m = MetricsRegistry(path=str(tmp_path / "pm"), proc=0)
    ref_m = RefRegistry(path=str(tmp_path / "rm"), proc=0)
    port, p_raised = _drive(
        numerics.NumericsRecorder, numerics.NumericsReport,
        health.DriftGate(policy, 0.5), EventStream(str(port_ev), proc=0),
        port_m, reports, window)
    ref, r_raised = _drive(
        ref_numerics.NumericsRecorder, ref_numerics.NumericsReport,
        ref_health.DriftGate(policy, 0.5),
        RefEventStream(str(ref_ev), proc=0), ref_m, reports, window)
    assert p_raised == r_raised
    if policy == "abort":
        assert p_raised is not None and p_raised[1] == "DriftError"
    assert _without_ts(ref_parse(str(port_ev))) == _without_ts(
        ref_parse(str(ref_ev)))
    assert port_m.snapshot() == ref_m.snapshot()
    assert port_m.prometheus_text() == ref_m.prometheus_text()
    assert port.describe() == ref.describe()


@pytest.mark.parametrize("env,key,want", [
    (None, "", "off"), (None, "boundary", "boundary"),
    ("every_round", "off", "every_round"), ("OFF", "boundary", "off"),
    ("", "every_round", "off"),
])
def test_resolve_numerics_matches_the_reference(monkeypatch, env, key,
                                                want):
    if env is None:
        monkeypatch.delenv("GS_NUMERICS", raising=False)
    else:
        monkeypatch.setenv("GS_NUMERICS", env)
    assert numerics.resolve_numerics(Settings(numerics=key)) == want
    assert ref_numerics.resolve_numerics(RefSettings(numerics=key)) == want


@pytest.mark.parametrize("var,value,fn", [
    ("GS_NUMERICS", "sometimes", "numerics"),
    ("GS_NUMERICS_WINDOW", "eight", "window"),
    ("GS_NUMERICS_WINDOW", "0", "window"),
    ("GS_DRIFT_POLICY", "explode", "gate"),
    ("GS_DRIFT_LIMIT", "big", "gate"),
    ("GS_DRIFT_LIMIT", "-1", "gate"),
])
def test_bad_numerics_knobs_raise_as_the_reference(monkeypatch, var, value,
                                                   fn):
    monkeypatch.setenv(var, value)
    calls = {
        "numerics": (lambda: numerics.resolve_numerics(Settings()),
                     lambda: ref_numerics.resolve_numerics(RefSettings())),
        "window": (numerics.resolve_window, ref_numerics.resolve_window),
        "gate": (health.DriftGate.from_env, ref_health.DriftGate.from_env),
    }[fn]
    with pytest.raises(ValueError) as want:
        calls[1]()
    with pytest.raises(ValueError) as got:
        calls[0]()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("raw,want", [(None, 8), ("3", 3), ("1", 1)])
def test_resolve_window_matches_the_reference(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("GS_NUMERICS_WINDOW", raising=False)
    else:
        monkeypatch.setenv("GS_NUMERICS_WINDOW", raw)
    assert numerics.resolve_window() == ref_numerics.resolve_window() == want


@pytest.mark.parametrize("policy,limit", [("warn", None), ("abort", "0.25"),
                                          ("off", "2"), ("WARN", "")])
def test_drift_gate_from_env_matches_the_reference(monkeypatch, policy,
                                                   limit):
    monkeypatch.setenv("GS_DRIFT_POLICY", policy)
    if limit is None:
        monkeypatch.delenv("GS_DRIFT_LIMIT", raising=False)
    else:
        monkeypatch.setenv("GS_DRIFT_LIMIT", limit)
    port, ref = health.DriftGate.from_env(), ref_health.DriftGate.from_env()
    assert (port.policy, port.limit, port.raising) == (
        ref.policy, ref.limit, ref.raising)
    drifts = {"u.max": 0.7, "v.min": -0.3}
    assert port.check(5, drifts) == ref.check(5, drifts)


def test_drift_rollback_raises_naming_the_supervisor_item(monkeypatch):
    """``rollback`` acts under supervision as the reference's (a raising
    policy whose DriftError the supervisor restarts), and raises at
    start-up naming supervision without it."""
    monkeypatch.setenv("GS_DRIFT_POLICY", "rollback")
    ref = ref_health.DriftGate.from_env()
    assert ref.policy == "rollback"
    monkeypatch.delenv("GS_SUPERVISE", raising=False)
    with pytest.raises(ValueError, match="supervisor"):
        health.DriftGate.from_env()
    monkeypatch.setenv("GS_SUPERVISE", "1")
    port = health.DriftGate.from_env()
    assert (port.policy, port.limit, port.raising) == (
        ref.policy, ref.limit, ref.raising)
    drifts = {"u.max": 0.9}
    event = port.check(5, drifts)
    assert event == ref.check(5, drifts)
    with pytest.raises(health.DriftError, match="policy=rollback") as e:
        port.enforce(5, event)
    assert isinstance(e.value, health.HealthError)
    assert health.DRIFT_POLICIES == ref_health.DRIFT_POLICIES


def test_stats_and_modes_match_the_reference():
    assert numerics.MODES == ref_numerics.MODES
    assert numerics.STATS == ref_numerics.STATS
    assert numerics.DRIFT_STATS == ref_numerics.DRIFT_STATS


def test_health_metrics_match_the_reference(tmp_path):
    """``HealthGuard.record_metrics``: the same gauges as the
    reference's for the same report."""
    port_m = MetricsRegistry(path=str(tmp_path / "p"), proc=0)
    ref_m = RefRegistry(path=str(tmp_path / "r"), proc=0)
    args = (False, -0.1, math.nan, 0.0, 0.5)
    health.HealthGuard("warn").check(
        3, health.HealthReport(*args), metrics=port_m)
    ref_health.HealthGuard("warn").check(
        3, ref_health.HealthReport(*args), metrics=ref_m)
    assert port_m.prometheus_text() == ref_m.prometheus_text()
