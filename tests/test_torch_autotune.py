"""The port's measured autotuner (``grayscott_jl_tpu_torch/tune/``) against
the reference's (``grayscott_jl_tpu/tune/``), case for case with
``tests/unit/test_autotune.py`` where a case has a counterpart.

Every decision path runs with an injected fake timer (no real
measurement); the two packages' tuners, given the same timer and the
same settings off the card, time the same shortlist in the same order,
pick the same winner and record the same provenance keys. A kernel
failure inside a measurement stops the tuner; an infeasible candidate is
recorded and the sweep goes on.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.parallel import icimodel as ref_icimodel
from grayscott_jl_tpu.tune import autotuner as ref_autotuner
from grayscott_jl_tpu.tune import cache as ref_cache
from grayscott_jl_tpu.tune import candidates as ref_candidates
from grayscott_jl_tpu_torch import Settings, Simulation
from grayscott_jl_tpu_torch.config.settings import resolve_autotune
from grayscott_jl_tpu_torch.models import SettingsError
from grayscott_jl_tpu_torch.ops import _build, cuda_stencil, kernelgen
from grayscott_jl_tpu_torch.parallel import icimodel
from grayscott_jl_tpu_torch.resilience.faults import InjectedKernelError
from grayscott_jl_tpu_torch.tune import autotuner, cache, candidates, measure


@pytest.fixture(autouse=True)
def _tmp_cache(tmp_path, monkeypatch):
    """Every test has its own tuning-cache root."""
    root = tmp_path / "tune_cache"
    monkeypatch.setenv("GS_AUTOTUNE_CACHE", str(root))
    for var in ("GS_AUTOTUNE", "GS_FUSE", "GS_AUTOTUNE_BUDGET_S",
                "GS_AUTOTUNE_TOPN", "GS_HALO_DEPTH", "GS_COMM_OVERLAP"):
        monkeypatch.delenv(var, raising=False)
    yield root


@pytest.fixture
def ref_tables(monkeypatch):
    """The plain path's coefficients set to the reference's XLA ones,
    so that both packages score off-card candidates alike."""
    monkeypatch.setattr(icimodel, "MEASURED_US", {
        ({"Pallas": "cuda", "XLA": "plain"}[lang], side): us
        for (lang, side), us in ref_icimodel.MEASURED_US.items()})
    monkeypatch.setattr(icimodel, "OVERLAP_EFFICIENCY",
                        ref_icimodel.OVERLAP_EFFICIENCY)
    monkeypatch.setattr(icimodel, "HALO_DEPTH_EFFICIENCY", {
        "plain": ref_icimodel.HALO_DEPTH_EFFICIENCY["xla"],
        "cuda": ref_icimodel.HALO_DEPTH_EFFICIENCY["pallas"]})
    monkeypatch.setattr(icimodel, "BF16_COMPUTE_RATIO",
                        ref_icimodel.BF16_COMPUTE_RATIO)


def _settings(cls=Settings, **kw):
    return cls(
        L=kw.pop("L", 16), Du=0.2, Dv=0.1, F=0.02, k=0.048, dt=1.0,
        noise=kw.pop("noise", 0.1), precision="Float32", backend="CPU",
        kernel_language=kw.pop("kernel_language", "Auto"), **kw,
    )


def _key(**kw):
    base = dict(device_kind="NVIDIA H100 80GB HBM3", platform="cuda",
                dims=(2, 2, 2), L=256, dtype="float32", noise=0.1,
                torch_version=torch.__version__, cuda_version="12.8")
    base.update(kw)
    return cache.cache_key(**base)


def _winner(**kw):
    w = dict(kernel="plain", fuse=2, comm_overlap=True)
    w.update(kw)
    return w


def _fake_timer(us_by_label):
    """A timer with the ``time_sim_rounds`` contract whose result depends
    only on the candidate pinned into the probe simulation; labels name
    the reference's language (``xla``) for either package."""

    def timer(sim, steps, rounds, deadline):
        lang = {"plain": "xla"}.get(sim.kernel_language, sim.kernel_language)
        label = (f"{lang}/fuse={os.environ['GS_FUSE']}/"
                 f"{'overlap' if sim.comm_overlap else 'fused'}")
        s = us_by_label.get(label, 999999.0) / 1e6
        return {"median": s, "best": s, "rounds_s_per_step": [s] * rounds}

    return timer


# ------------------------------------------------------- mode resolution

def test_mode_resolution_env_wins_and_validates(monkeypatch):
    from grayscott_jl_tpu.config.settings import (
        resolve_autotune as ref_resolve)

    assert resolve_autotune(_settings()) == "cached"
    assert resolve_autotune(_settings(autotune="full")) == "full"
    monkeypatch.setenv("GS_AUTOTUNE", "quick")
    assert resolve_autotune(_settings(autotune="full")) == "quick"
    assert ref_resolve(_settings(RefSettings, autotune="full")) == "quick"
    monkeypatch.setenv("GS_AUTOTUNE", "vibes")
    with pytest.raises(ValueError, match="GS_AUTOTUNE"):
        resolve_autotune(_settings())
    assert autotuner.MODES == ref_autotuner.MODES


def test_budget_resolution(monkeypatch):
    assert autotuner.resolve_budget_s() == 120.0
    monkeypatch.setenv("GS_AUTOTUNE_BUDGET_S", "7.5")
    assert autotuner.resolve_budget_s() == 7.5
    monkeypatch.setenv("GS_AUTOTUNE_BUDGET_S", "0")
    with pytest.raises(ValueError, match="GS_AUTOTUNE_BUDGET_S"):
        autotuner.resolve_budget_s()


def test_topn_resolution(monkeypatch):
    assert (autotuner._top_n("quick"), autotuner._top_n("full")) == (3, 8)
    monkeypatch.setenv("GS_AUTOTUNE_TOPN", "5")
    assert autotuner._top_n("quick") == 5 == ref_autotuner._top_n("quick")


# --------------------------------------------------------- cache contract

def test_cache_roundtrip_hit():
    key = _key()
    cache.store(key, {"winner": _winner()})
    rec = cache.load(key)
    assert rec is not None
    assert rec["winner"]["fuse"] == 2
    assert rec["key"] == key


@pytest.mark.parametrize("field,value", [
    ("L", 512), ("dims", (4, 2, 1)), ("dtype", "bfloat16"),
    ("device_kind", "NVIDIA A100"), ("platform", "cpu"), ("noise", 0.0),
    ("torch_version", "999.0"), ("cuda_version", "13.0"),
    ("halo_depth", 2), ("placement", "peer"), ("cards", 4), ("procs", 2),
])
def test_cache_key_field_mismatch_misses(field, value):
    cache.store(_key(), {"winner": _winner()})
    assert cache.load(_key(**{field: value})) is None


def test_the_packages_never_share_entries():
    """Its own schema and its torch/CUDA key: a reference entry for the
    same run is not the port's, nor the other way round."""
    port = _key(platform="cpu", device_kind="")
    cache.store(port, {"winner": _winner()})
    theirs = ref_cache.cache_key(
        device_kind="", platform="cpu", dims=(2, 2, 2), L=256,
        dtype="float32", noise=0.1, jax_version=jax.__version__)
    assert cache.entry_path(port) != ref_cache.entry_path(theirs)
    assert ref_cache.load(theirs) is None
    assert "jax_version" not in port and "torch_version" in port


def test_schema_version_bump_invalidates(monkeypatch):
    key = _key()
    cache.store(key, {"winner": _winner()})
    monkeypatch.setattr(cache, "SCHEMA_VERSION", cache.SCHEMA_VERSION + 1)
    assert cache.load(_key()) is None
    forged = _key()
    os.makedirs(os.path.dirname(cache.entry_path(forged)), exist_ok=True)
    import shutil

    shutil.copy(cache.entry_path(key), cache.entry_path(forged))
    assert cache.load(forged) is None


def test_corrupt_cache_degrades_with_warning(capsys):
    key = _key()
    path = cache.entry_path(key)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write('{"winner": {"kernel"')  # truncated mid-write
    assert cache.load(key) is None
    assert "tuning cache" in capsys.readouterr().err
    with open(path, "w", encoding="utf-8") as f:
        json.dump(["not", "a", "record"], f)
    assert cache.load(key) is None
    assert "stale or malformed" in capsys.readouterr().err


def test_atomic_write_survives_simulated_crash(monkeypatch):
    key = _key()
    path = cache.entry_path(key)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".tmp.12345", "w", encoding="utf-8") as f:
        f.write('{"half a reco')
    assert cache.load(key) is None
    real_dump = json.dump

    def exploding_dump(obj, fp, **kw):
        fp.write('{"winner": {')
        raise OSError("disk full")

    monkeypatch.setattr(json, "dump", exploding_dump)
    with pytest.raises(OSError):
        cache.store(key, {"winner": _winner()})
    monkeypatch.setattr(json, "dump", real_dump)
    assert not os.path.exists(path)
    assert cache.load(key) is None
    cache.store(key, {"winner": _winner()})
    assert cache.load(key)["winner"] == _winner()


# ------------------------------------------------------ candidate gating

def _generate(**kw):
    base = dict(dims=(2, 2, 2), L=256, platform="cuda", itemsize=4,
                fuse_cap=5, analytic_kernel="cuda", analytic_fuse=1,
                comm_overlap=True, overlap_toggle=True, top_n=50)
    base.update(kw)
    return candidates.generate(**base)


@pytest.mark.parametrize("kw", [
    dict(dims=(2, 2, 2), L=256),
    dict(dims=(2, 2, 1), L=32, analytic_fuse=1),
    dict(dims=(4, 1, 1), L=64, comm_overlap=False, overlap_toggle=False),
    dict(dims=(1, 1, 1), L=16, comm_overlap=False, overlap_toggle=False),
    dict(dims=(2, 2, 2), L=24, halo_depth=2, top_n=3),
    dict(dims=(2, 1, 1), L=16, compute_precision="bf16_f32acc", top_n=8),
    dict(dims=(3, 1, 1), L=30, fuse_cap=3, analytic_fuse=5),
])
def test_candidates_off_card_equal_reference(ref_tables, kw):
    """Off the card every candidate is the plain path, field for field
    the reference's off-TPU XLA candidates ("xla" read as "plain"; the
    reference's ``bx`` is None off the TPU and has no counterpart)."""
    base = dict(platform="cpu", itemsize=4, fuse_cap=5, analytic_fuse=2,
                comm_overlap=True, overlap_toggle=True, top_n=50)
    base.update(kw)
    theirs = ref_candidates.generate(analytic_kernel="xla", **base)
    mine = candidates.generate(analytic_kernel="plain", **base)
    want = []
    for c in theirs:
        d = c.as_dict()
        assert d.pop("bx") is None
        d["kernel"] = {"xla": "plain"}[d["kernel"]]
        want.append(d)
    assert [c.as_dict() for c in mine] == want


def test_candidates_off_card_are_plain():
    cands = _generate(platform="cpu", analytic_kernel="plain",
                      analytic_fuse=2)
    assert cands and all(c.kernel == "plain" for c in cands)
    assert any(c.analytic for c in cands)
    assert {c.comm_overlap for c in cands} == {True, False}


def test_candidates_respect_pinned_overlap():
    cands = _generate(overlap_toggle=False, comm_overlap=False)
    assert {c.comm_overlap for c in cands} == {False}


def test_candidates_on_the_card_are_the_kernels_gated_depths():
    """The plain path is never a candidate on the card; the depths are
    the face schedule and the chains the shared-memory ledger admits,
    each halo depth within the ledger at fuse x k."""
    cands = _generate()
    assert cands and all(c.kernel == "cuda" for c in cands)
    cap = cuda_stencil.max_feasible_fuse(4)
    assert {c.fuse for c in cands} == set(range(1, cap + 1))
    for c in cands:
        assert c.fuse * c.halo_depth <= cap or c.halo_depth == 1
    # A depth-1 round has no split form: not toggled there.
    assert all(c.comm_overlap for c in cands
               if c.fuse * c.halo_depth == 1)


def test_candidates_follow_the_ledger_for_bf16_and_thin_blocks():
    bf16 = _generate(compute_precision="bf16_f32acc")
    assert {c.compute_precision for c in bf16} == {"bf16_f32acc", "f32"}
    thin = _generate(dims=(8, 1, 1), L=16)  # local x = 2
    assert max(c.fuse for c in thin) == 2


def test_candidates_refused_model_on_the_card_are_plain():
    cands = _generate(kernel_allowed=False, analytic_kernel="plain",
                      analytic_fuse=2)
    assert cands and all(c.kernel == "plain" for c in cands)


def test_candidates_analytic_pick_always_present():
    cands = _generate(top_n=1)
    assert sum(1 for c in cands if c.analytic) == 1
    assert cands[0].analytic
    odd = _generate(analytic_fuse=9, top_n=2)  # outside the space
    assert odd[0].analytic and odd[0].fuse == 9
    assert odd[0].projected_step_us is None


def test_candidates_ensembles_are_item_19():
    # Ensembles (Queue 1 item 19) are ported: a 4-member ensemble on 8
    # slots is priced per batch and searches the other member splits.
    cands = _generate(ensemble=4, member_shards=1)
    assert cands[0].analytic and cands[0].member_shards == 1
    splits = {c.member_shards: c.mesh for c in cands if c.mesh is not None}
    assert splits == {2: (2, 2, 1), 4: (2, 1, 1)}
    solo = _generate()
    one = [c for c in cands if c.analytic][0]
    assert one.projected_step_us > [c for c in solo
                                    if c.analytic][0].projected_step_us


def test_candidate_dict_roundtrip():
    c = candidates.Candidate(kernel="cuda", fuse=4, comm_overlap=True,
                             halo_depth=2, projected_step_us=123.456)
    d = c.as_dict()
    assert d["projected_step_us"] == 123.5
    rt = candidates.from_dict(dict(d, future_field="ignored", bx=8))
    assert rt.kernel == "cuda" and rt.halo_depth == 2
    assert c.label() == "cuda/fuse=4/overlap/sk=2"


# --------------------------------------------- decision paths (fake timer)

def _autotune(settings, mode, timer=None, dims=(2, 2, 2), **kw):
    n = dims[0] * dims[1] * dims[2]
    base = dict(
        dims=dims, L=settings.L, platform="cpu", device_kind="",
        dtype="float32", noise=settings.noise, itemsize=4,
        devices=["cpu"] * n, seed=0, analytic_kernel="plain",
        analytic_fuse=2, comm_overlap=True, overlap_toggle=True,
        halo_depth=1,
    )
    base.update(kw)
    os.environ["GS_AUTOTUNE"] = mode
    try:
        return autotuner.autotune(settings, timer=timer, **base)
    finally:
        os.environ.pop("GS_AUTOTUNE", None)


def _ref_autotune(settings, mode, timer=None, dims=(2, 2, 2)):
    os.environ["GS_AUTOTUNE"] = mode
    try:
        return ref_autotuner.autotune(
            settings, dims=dims, L=settings.L, platform="cpu",
            device_kind="cpu", dtype="float32", noise=settings.noise,
            itemsize=4, n_devices=8, seed=0, analytic_kernel="xla",
            analytic_fuse=2, comm_overlap=True, overlap_toggle=True,
            halo_depth=1, timer=timer)
    finally:
        os.environ.pop("GS_AUTOTUNE", None)


def test_off_and_cached_miss_keep_the_analytic_pick():
    s = _settings()
    off = _autotune(s, "off")
    miss = _autotune(s, "cached")
    for d in (off, miss):
        assert d.kernel == "plain"
        assert d.fuse is None and d.comm_overlap is None
        assert d.provenance["source"] == "analytic"
        assert d.provenance["candidates_timed"] == 0
    assert off.provenance["cache"] is None
    assert miss.provenance["cache"] == "miss"


TIMES = {
    "xla/fuse=2/overlap": 900.0,  # the analytic pick
    "xla/fuse=2/fused": 700.0,    # the measured winner
    "xla/fuse=1/overlap": 950.0,
}


def test_quick_mode_measures_persists_and_replays():
    s = _settings()
    d = _autotune(s, "quick", timer=_fake_timer(TIMES))
    assert d.provenance["source"] == "measured"
    assert d.provenance["cache"] == "miss"
    assert d.provenance["candidates_timed"] >= 2
    assert d.provenance["tuning_s"] >= 0
    assert (d.kernel, d.fuse, d.comm_overlap) == ("plain", 2, False)
    assert d.provenance["model_pick_us"] == 900.0
    assert d.provenance["measured_pick_us"] == 700.0
    assert d.provenance["model_vs_measured_speedup"] == pytest.approx(
        900.0 / 700.0, abs=1e-3)
    hits = [_autotune(s, "cached"), _autotune(s, "cached")]
    for h in hits:
        assert h.provenance["cache"] == "hit"
        assert h.provenance["candidates_timed"] == 0
        assert h.provenance["tuning_s"] == 0.0
        assert (h.kernel, h.fuse, h.comm_overlap) == ("plain", 2, False)
    assert hits[0].provenance == hits[1].provenance


def test_quick_mode_equals_the_reference(ref_tables):
    """The same fake timer in both packages: the same shortlist in the
    same order, the same winner, the same provenance keys."""
    mine = _autotune(_settings(), "quick", timer=_fake_timer(TIMES))
    theirs = _ref_autotune(_settings(RefSettings), "quick",
                           timer=_fake_timer(TIMES))

    def shortlist(rec, kernel):
        out = []
        for m in rec["measurements"]:
            c = dict(m["candidate"])
            c.pop("bx", None)
            c["kernel"] = "plain" if c["kernel"] == kernel else c["kernel"]
            out.append((c, m.get("median_us_per_step"), m.get("error")))
        return out

    with open(mine.provenance["cache_path"], encoding="utf-8") as f:
        rec = json.load(f)
    with open(theirs.provenance["cache_path"], encoding="utf-8") as f:
        ref_rec = json.load(f)
    assert shortlist(rec, "plain") == shortlist(ref_rec, "xla")
    w, rw = dict(mine.provenance["winner"]), dict(theirs.provenance["winner"])
    assert rw.pop("bx") is None and rw.pop("kernel") == "xla"
    assert w.pop("kernel") == "plain" and w == rw
    rename = {"pallas_allowed": "kernel_allowed"}
    assert set(mine.provenance) == {rename.get(k, k)
                                    for k in theirs.provenance}
    for k in ("mode", "source", "cache", "candidates_timed",
              "candidates_skipped", "candidates_errored", "model_pick_us",
              "measured_pick_us", "model_vs_measured_speedup"):
        assert mine.provenance[k] == theirs.provenance[k], k


def test_quick_mode_budget_exhaustion_reports_skips(monkeypatch):
    def slow_timer(sim, steps, rounds, deadline):
        import time

        time.sleep(0.05)
        return {"median": 1e-3, "best": 1e-3, "rounds_s_per_step": [1e-3]}

    monkeypatch.setenv("GS_AUTOTUNE_BUDGET_S", "0.01")
    d = _autotune(_settings(), "quick", timer=slow_timer)
    assert d.provenance["candidates_timed"] == 1
    assert d.provenance["candidates_skipped"] >= 1
    assert d.provenance["source"] == "measured"


def test_quick_mode_all_failures_degrade_to_analytic():
    def broken_timer(sim, steps, rounds, deadline):
        raise RuntimeError("no backend today")

    d = _autotune(_settings(), "quick", timer=broken_timer)
    assert d.provenance["source"] == "analytic"
    assert d.kernel == "plain"
    assert d.provenance["candidates_errored"] >= 1
    assert d.provenance["candidates_timed"] == 0


def test_cached_mode_corrupt_entry_degrades_to_analytic(capsys):
    s = _settings()
    key = cache.cache_key(
        device_kind="", platform="cpu", dims=(2, 2, 2), L=s.L,
        dtype="float32", noise=s.noise, torch_version=torch.__version__,
        cuda_version=torch.version.cuda, halo_depth=1, cards=0)
    path = cache.entry_path(key)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write("{corrupt")
    d = _autotune(s, "cached")
    assert d.provenance["source"] == "analytic"
    assert "tuning cache" in capsys.readouterr().err


@pytest.mark.parametrize("exc", [
    cuda_stencil.KernelLaunchError("stencil launch failed", code=1),
    cuda_stencil.KernelLaunchError("illegal address", code=700),
    _build.KernelBuildError("nvcc not found"),
    InjectedKernelError(40),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
], ids=["launch", "sticky_launch", "build", "injected", "sticky_torch"])
def test_a_kernel_failure_stops_the_measurement(exc):
    """The card runs the hand-written kernels or stops: a kernel failure
    in a candidate propagates out of ``measure_candidates``."""
    def timer(sim, steps, rounds, deadline):
        raise exc

    cands = candidates.generate(
        dims=(2, 2, 1), L=16, platform="cpu", itemsize=4, fuse_cap=2,
        analytic_kernel="plain", analytic_fuse=2, comm_overlap=True,
        overlap_toggle=True, top_n=3)
    with pytest.raises(type(exc)):
        measure.measure_candidates(
            _settings(), cands, dims=(2, 2, 1), devices=["cpu"] * 4,
            deadline=float("inf"), steps=2, rounds=1, timer=timer)


def test_an_infeasible_candidate_is_recorded():
    """A candidate whose geometry the settings refuse records its
    ``SettingsError`` and the sweep goes on."""
    cands = [candidates.Candidate(kernel="plain", fuse=2,
                                  comm_overlap=False, halo_depth=8),
             candidates.Candidate(kernel="plain", fuse=1,
                                  comm_overlap=False)]
    ms, skipped = measure.measure_candidates(
        _settings(), cands, dims=(2, 2, 2), devices=["cpu"] * 8,
        deadline=float("inf"), steps=2, rounds=1,
        timer=_fake_timer({"xla/fuse=1/fused": 10.0}))
    assert skipped == 0
    assert ms[0].error.startswith("SettingsError") and not ms[0].ok()
    assert ms[1].ok() and measure.best(ms) is ms[1]


def test_pinned_settings_pin_the_candidate():
    c = candidates.Candidate(kernel="cuda", fuse=3, comm_overlap=True,
                             halo_depth=2, compute_precision="bf16_f32acc")
    p = measure.pinned_settings(_settings(supervise=True, checkpoint=True),
                                c)
    assert (p.kernel_language, p.comm_overlap, p.halo_depth,
            p.compute_precision, p.autotune) == (
        "CUDA", "on", 2, "bf16_f32acc", "off")
    assert not (p.supervise or p.restart or p.checkpoint)


def test_autotune_event_on_the_stream(tmp_path, monkeypatch):
    from grayscott_jl_tpu_torch.obs import events

    path = tmp_path / "ev.jsonl"
    monkeypatch.setenv("GS_EVENTS", str(path))
    events.reset_events()
    try:
        _autotune(_settings(), "quick", timer=_fake_timer(TIMES))
    finally:
        events.reset_events()
    (ev,) = events.parse_events(str(path))
    assert ev["kind"] == "autotune" and ev["phase"] == "compile"
    assert ev["attrs"]["source"] == "measured"


# ------------------------------------------- Simulation-level determinism

def _sim_key(s, **kw):
    base = dict(device_kind="", platform="cpu", dims=(2, 2, 2), L=s.L,
                dtype="float32", noise=s.noise,
                torch_version=torch.__version__,
                cuda_version=torch.version.cuda, cards=0,
                kernel_generator=kernelgen.GENERATOR_VERSION)
    base.update(kw)
    return cache.cache_key(**base)


def test_cached_miss_trajectory_bit_identical_to_off(monkeypatch):
    runs = {}
    for mode in ("cached", "off"):
        monkeypatch.setenv("GS_AUTOTUNE", mode)
        sim = Simulation(_settings(), n_devices=8, seed=3)
        sim.iterate(4)
        runs[mode] = (sim.kernel_language, sim.fuse, sim.comm_overlap,
                      sim.halo_depth, sim.get_fields())
    assert runs["cached"][:4] == runs["off"][:4]
    for a, b in zip(runs["cached"][4], runs["off"][4]):
        np.testing.assert_array_equal(a, b)


def test_cache_fixture_hit_applies_winner_and_is_restart_stable(
        monkeypatch):
    s = _settings()
    cache.store(_sim_key(s), {"winner": _winner(fuse=2, comm_overlap=True),
                              "created": "2026-08-04T00:00:00+00:00"})
    monkeypatch.setenv("GS_AUTOTUNE", "cached")
    hit = Simulation(s, n_devices=8, seed=3)
    assert hit.kernel_selection["autotune"]["cache"] == "hit"
    assert hit.kernel_language == "plain"
    assert hit.fuse == 2 and hit.comm_overlap is True
    hit.iterate(4)
    monkeypatch.setenv("GS_AUTOTUNE", "off")
    ref = Simulation(s, n_devices=8, seed=3)
    ref.iterate(4)
    for a, b in zip(hit.get_fields(), ref.get_fields()):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setenv("GS_AUTOTUNE", "cached")
    again = Simulation(s, n_devices=8, seed=3)
    assert (again.kernel_selection["autotune"]
            == hit.kernel_selection["autotune"])


def test_cache_hit_overrides_toward_measured_winner(monkeypatch):
    s = _settings()
    cache.store(_sim_key(s), {"winner": _winner(fuse=1, comm_overlap=False,
                                                halo_depth=2)})
    monkeypatch.setenv("GS_AUTOTUNE", "cached")
    sim = Simulation(s, n_devices=8, seed=3)
    assert sim.fuse == 1 and sim.comm_overlap is False
    assert sim.halo_depth == 2
    sim.iterate(2)
    assert np.isfinite(sim.get_fields()[0]).all()


def test_operator_pins_beat_the_cache(monkeypatch):
    s = _settings(comm_overlap="on", halo_depth=1)
    cache.store(_sim_key(s, halo_depth=1),
                {"winner": _winner(fuse=1, comm_overlap=False,
                                   halo_depth=2)})
    monkeypatch.setenv("GS_AUTOTUNE", "cached")
    monkeypatch.setenv("GS_FUSE", "3")
    sim = Simulation(s, n_devices=8, seed=3)
    assert sim.kernel_selection["autotune"]["cache"] == "hit"
    assert sim.fuse == 3  # GS_FUSE wins
    assert sim.comm_overlap is True  # the pinned setting wins
    assert sim.halo_depth == 1  # the pinned depth wins


def test_a_move_never_retunes(monkeypatch):
    """The live move's target is built with the language pinned and the
    tuner off (``reshard/restore.reshape_live``)."""
    from grayscott_jl_tpu_torch.reshard.restore import reshape_live

    monkeypatch.setenv("GS_AUTOTUNE", "quick")
    calls = []
    real = autotuner.autotune
    monkeypatch.setattr(autotuner, "autotune",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    import grayscott_jl_tpu_torch.tune as tune

    monkeypatch.setattr(tune, "autotune", autotuner.autotune)
    sim = Simulation(_settings(), n_devices=8, seed=3)
    assert calls == [1]
    target, plan = reshape_live(sim, mesh_dims=(2, 2, 1),
                                devices=["cpu"] * 4)
    assert calls == [1] and plan.changed
    assert target.kernel_selection is None
    assert target.settings.autotune == "off"


_TWO_PROCESSES = """
import json, os, sys, time
from grayscott_jl_tpu_torch import Settings
from grayscott_jl_tpu_torch.ops.cuda_stencil import KernelLaunchError
from grayscott_jl_tpu_torch.parallel import distributed
from grayscott_jl_tpu_torch.tune import measure
from grayscott_jl_tpu_torch.tune.candidates import Candidate

distributed.ensure_started("cpu")
rank, mode = distributed.process_index(), sys.argv[1]


class OneSided:
    # Process 1's depth-2 candidate fails; every other build succeeds.
    def __init__(self, settings, *, seed, mesh_dims, devices):
        if rank == 1 and os.environ["GS_FUSE"] == "2":
            if mode == "error":
                raise RuntimeError("CUDA out of memory on process 1")
            raise KernelLaunchError("stencil launch failed", code=1)


def timer(sim, steps, rounds, deadline):
    s = 1e-4 * (1 + rank)
    return {"median": s, "best": s, "rounds_s_per_step": [s]}


cands = [Candidate("cuda", k, False) for k in (1, 2, 3)]
try:
    out, skipped = measure.measure_candidates(
        Settings(L=16, backend="CPU"), cands, dims=(2, 1, 1),
        devices=["cpu"], deadline=time.monotonic() + 60, steps=1, rounds=1,
        timer=timer, sim_cls=OneSided, processes=2)
    res = {"measured": [m.median_us_per_step for m in out],
           "errors": [m.error for m in out], "skipped": skipped}
except Exception as e:
    res = {"raised": type(e).__name__, "msg": str(e)}
distributed.stop()
print(json.dumps(res))
"""


@pytest.mark.parametrize("mode", ["error", "kernel"])
def test_a_one_sided_candidate_failure_keeps_processes_in_step(tmp_path,
                                                               mode):
    """Two gloo processes; process 1's depth-2 candidate fails. Both
    processes agree on every candidate's outcome before the gather: a
    plain error is the candidate's error on both and the sweep goes on
    (the others timed at the slowest process's median); a kernel failure
    stops both."""
    from grayscott_jl_tpu_torch import launch

    port = launch.free_port()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("GS_TPU_", "MASTER_", "LOCAL_"))
            and k not in ("RANK", "WORLD_SIZE", "GS_FUSE")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO_PROCESSES, mode], cwd=str(tmp_path),
        env=launch.process_env(r, 2, port, base), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    if mode == "error":
        assert got[0]["measured"] == got[1]["measured"] == [200.0, None,
                                                            200.0]
        assert got[1]["errors"][1] == ("RuntimeError: CUDA out of memory "
                                       "on process 1")
        assert got[0]["errors"] == [None, "failed on process 1", None]
    else:
        assert got[1] == {"raised": "KernelLaunchError",
                          "msg": "stencil launch failed"}
        assert got[0]["raised"] == "KernelLaunchError"
        assert "process 1" in got[0]["msg"]
