"""Batched ensembles in the port (``grayscott_jl_tpu_torch/ensemble``)
against the reference's (``grayscott_jl_tpu/ensemble``), on the CPU.

* Parity: each member of the port's ensemble equals the same member of
  the reference's (its ``EnsembleSimulation`` on the CPU, the XLA path
  under vmap) within max |Δ| <= 1e-6 at L=16 over 10 steps — one block,
  a (2,2,2) mesh and ``member_shards = 2`` over four blocks — and a
  two-member Brusselator sweep.
* Inside the port, bitwise: member k of an N-member run equals a solo run
  of member k's params and seed ``base_seed + k`` (one block and the
  mesh, depth 1 and ``GS_FUSE=2``, the kernel structure and Plain), and a
  restore equals the uninterrupted run.
* The spec and the member store paths equal the reference's; the health,
  numerics and checksum probes resolve per member (the checksums equal
  the reference's bitwise on the same fields); the SDC screen and the
  health guard name the member; idle slots are masked.
* Elastic member resume: the quorum step, grow, shrink, the gap and
  ``reshard = "off"``; the live move grows and shrinks the member axis.
* The tuner's key, candidates and ``cached`` miss; ``repack``; and the
  kernel's schedule emulation with a member offset.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.config.settings import (
    parse_settings_toml as ref_parse,
)
from grayscott_jl_tpu.ensemble import engine as ref_engine
from grayscott_jl_tpu.ensemble import io as ref_io
from grayscott_jl_tpu.ensemble import spec as ref_spec

from grayscott_jl_tpu_torch import Settings, Simulation
from grayscott_jl_tpu_torch.config.settings import parse_settings_toml
from grayscott_jl_tpu_torch.ensemble import spec as ens_spec
from grayscott_jl_tpu_torch.ensemble.engine import (EnsembleSimulation,
                                                     member_blocks)
from grayscott_jl_tpu_torch.ensemble.io import (member_path, member_settings,
                                                member_tag)
from grayscott_jl_tpu_torch.ops import cuda_stencil

#: The ground rules' parity tolerance (max |Δ| on u and v).
ATOL = 1e-6
#: The other models' solo parity tolerance
#: (``test_torch_simulation.test_other_models_match_reference_on_plain_path``).
MODEL_ATOL = 1e-5
PHYSICS = dict(Du=0.2, Dv=0.1, F=0.02, k=0.048, dt=1.0)
THREE = ["spots", "stripes", "chaos"]
FOUR = ["spots", "stripes", "waves", "chaos"]

requires8 = pytest.mark.skipif(len(jax.devices()) < 8,
                               reason="needs 8 virtual CPU devices")


def _table(presets, member_shards=1, **extra):
    return {"presets": list(presets), "member_shards": member_shards,
            **extra}


def port_settings(presets=THREE, member_shards=1, L=16, noise=0.1,
                  kernel_language="Auto", **kw):
    s = Settings(L=L, noise=noise, backend="CPU",
                 kernel_language=kernel_language,
                 **{"precision": "Float32", **PHYSICS, **kw})
    s.ensemble = ens_spec.from_toml(_table(presets, member_shards), s)
    return s


def ref_settings(presets=THREE, member_shards=1, L=16, noise=0.1, **kw):
    s = RefSettings(L=L, noise=noise, precision="Float32", backend="CPU",
                    **{**PHYSICS, **kw})
    s.ensemble = ref_spec.from_toml(_table(presets, member_shards), s)
    return s


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


# ------------------------------------------------------------------ parity


@pytest.mark.parametrize("lang", ["Auto", "Pallas"])
@pytest.mark.parametrize("case", [
    pytest.param((THREE, 1, 1), id="one_block"),
    pytest.param((THREE, 1, 8), id="mesh_2x2x2", marks=requires8),
    pytest.param((FOUR, 2, 8), id="member_shards_2", marks=requires8),
])
def test_members_match_the_reference(case, lang):
    """Each member of the port's ensemble against the same member of the
    reference's at the ground rules' tolerance (measured max |Δ|: 2.4e-7
    on u, 1.8e-7 on v), the spatial mesh the reference's."""
    presets, shards, n = case
    ref = ref_engine.EnsembleSimulation(ref_settings(presets, shards),
                                        n_devices=n, seed=0)
    ref.iterate(10)
    port = EnsembleSimulation(port_settings(presets, shards,
                                            kernel_language=lang),
                              n_devices=n, seed=0)
    assert port.domain.dims == ref.domain.dims
    port.iterate(10)
    for a, b in zip(port.get_fields(), ref.get_fields()):
        assert a.shape == (len(presets), 16, 16, 16)
        assert _max_diff(a, b) <= ATOL


def test_brusselator_sweep_matches_the_reference():
    """Two Brusselator members of a B sweep, at the other models' solo
    tolerance (measured max |Δ| 1.07e-6, on values near 1.45)."""
    toml = """
L = 16
noise = 0.1
dt = 0.05
precision = "Float32"
backend = "CPU"
[model]
name = "brusselator"
A = 1.0
B = 3.0
Du = 0.2
Dv = 0.02
[ensemble]
members = 2
[ensemble.sweep]
B = { from = 2.4, to = 3.0 }
"""
    port = EnsembleSimulation(parse_settings_toml(toml), seed=4)
    ref = ref_engine.EnsembleSimulation(ref_parse(toml), n_devices=1, seed=4)
    port.iterate(10)
    ref.iterate(10)
    for a, b in zip(port.get_fields(), ref.get_fields()):
        assert _max_diff(a, b) <= MODEL_ATOL


# --------------------------------------------------- inside the port, bitwise


@pytest.mark.parametrize("lang", ["Plain", "Pallas"])
@pytest.mark.parametrize("n_devices,fuse", [(1, "1"), (1, "2"), (8, "1"),
                                            (8, "2")])
def test_member_equals_its_solo_run(monkeypatch, lang, n_devices, fuse):
    monkeypatch.setenv("GS_FUSE", fuse)
    s = port_settings(kernel_language=lang)
    ens = EnsembleSimulation(s, n_devices=n_devices, seed=7)
    ens.iterate(7)
    fields = ens.get_fields()
    for k in range(3):
        solo = Simulation(member_settings(s, k), n_devices=n_devices,
                          seed=7 + k)
        assert solo.domain.dims == ens.domain.dims
        solo.iterate(7)
        for a, b in zip(fields, solo.get_fields()):
            assert np.array_equal(a[k], b)


def test_member_shards_members_equal_their_solo_runs(monkeypatch):
    monkeypatch.setenv("GS_FUSE", "2")
    s = port_settings(FOUR, 2, kernel_language="Pallas")
    ens = EnsembleSimulation(s, n_devices=8, seed=5)
    assert ens.domain.dims == (2, 2, 1) and ens.mesh.n_blocks == 8
    ens.iterate(5)
    fields = ens.get_fields()
    for k in range(4):
        solo = Simulation(member_settings(s, k), n_devices=4, seed=5 + k)
        solo.iterate(5)
        for a, b in zip(fields, solo.get_fields()):
            assert np.array_equal(a[k], b)


def test_noise_free_member_adds_an_exact_zero():
    """A noise = 0 member in a noisy ensemble equals its noise-free solo
    run (the noise is traced in for the launch; its term is 0)."""
    s = Settings(L=16, noise=0.1, precision="Float32", backend="CPU",
                 **PHYSICS)
    s.ensemble = ens_spec.from_toml(
        {"member": [{"noise": 0.0}, {"noise": 0.1}]}, s)
    ens = EnsembleSimulation(s, seed=0)
    assert ens.use_noise
    ens.iterate(4)
    solo = Simulation(member_settings(s, 0), seed=0)
    assert not solo.use_noise
    solo.iterate(4)
    for a, b in zip(ens.get_fields(), solo.get_fields()):
        assert np.array_equal(a[0], b)


def test_restore_equals_the_uninterrupted_run():
    s = port_settings()
    base = EnsembleSimulation(s, n_devices=8, seed=2)
    base.iterate(4)
    u4, v4 = base.get_fields()
    base.iterate(3)
    resumed = EnsembleSimulation(s, n_devices=8, seed=2)
    resumed.restore_members([(u4[i], v4[i]) for i in range(3)], 4)
    resumed.iterate(3)
    for a, b in zip(base.get_fields(), resumed.get_fields()):
        assert np.array_equal(a, b)


def test_snapshot_blocks_split_into_solo_blocks():
    s = port_settings()
    ens = EnsembleSimulation(s, n_devices=8, seed=7)
    ens.iterate(3)
    blocks = ens.snapshot_async().blocks()
    solo = Simulation(member_settings(s, 1), n_devices=8, seed=8)
    solo.iterate(3)
    want = solo.snapshot_async().blocks()
    got = member_blocks(blocks, 1)
    assert len(got) == len(want) == 8
    for (o1, s1, *f1), (o2, s2, *f2) in zip(got, want):
        assert (tuple(o1), tuple(s1)) == (tuple(o2), tuple(s2))
        assert all(np.array_equal(a, b) for a, b in zip(f1, f2))


# -------------------------------------------------------- spec and io


TABLES = [
    _table(["spots", "chaos"]),
    {"presets": "all"},
    {"member": [{"F": 0.05, "seed": 42, "name": "custom"}, {"k": 0.06}]},
    {"members": 4, "sweep": {"F": {"from": 0.01, "to": 0.06},
                             "k": [0.045, 0.05, 0.055, 0.06]}},
    {"presets": ["spots", "waves"], "seeds": [9, 2**32 - 1],
     "member_shards": 2},
]


@pytest.mark.parametrize("table", TABLES)
def test_spec_equals_the_reference(table):
    port = Settings(L=16, noise=0.25, **PHYSICS)
    ref = RefSettings(L=16, noise=0.25, **PHYSICS)
    a = ens_spec.from_toml(table, port)
    b = ref_spec.from_toml(table, ref)
    assert a.describe() == b.describe()
    assert ens_spec.resolve_seeds(a, 3) == ref_spec.resolve_seeds(b, 3)


@pytest.mark.parametrize("table,match", [
    ({"presets": ["nope"]}, "Unknown ensemble preset"),
    ({"members": 3, "presets": ["spots"]}, "does not match"),
    ({"presets": ["spots", "chaos", "waves"], "member_shards": 2},
     "does not divide"),
    ({"bogus": 1}, "unknown keys"),
    ({}, "declares no members"),
])
def test_spec_refuses_what_the_reference_refuses(table, match):
    for mod, cls in ((ens_spec, Settings), (ref_spec, RefSettings)):
        with pytest.raises(ValueError, match=match):
            mod.from_toml(table, cls(L=16, **PHYSICS))


def test_the_table_parses_and_is_no_longer_refused():
    s = parse_settings_toml('L = 16\nbackend = "CPU"\n[ensemble]\n'
                            'presets = ["spots", "chaos"]\n')
    assert s.ensemble.n == 2
    from grayscott_jl_tpu_torch.config import settings as config

    assert "ensemble" not in config.NOT_PORTED
    config.check_ported(s)


@pytest.mark.parametrize("i,n", [(0, 2), (3, 5), (12, 64), (99, 100)])
def test_member_paths_equal_the_reference(i, n):
    assert member_tag(i, n) == ref_io.member_tag(i, n)
    for path in ("out/gs.bp", "ckpt.bp", "noext"):
        assert member_path(path, i, n) == ref_io.member_path(path, i, n)


def test_member_settings_equal_the_reference():
    port, ref = port_settings(FOUR), ref_settings(FOUR)
    for k in range(4):
        a, b = member_settings(port, k), ref_io.member_settings(ref, k)
        for key in ("dt", "noise", "F", "k", "Du", "Dv", "model",
                    "model_params", "output", "checkpoint_output",
                    "restart_input", "ensemble"):
            assert getattr(a, key) == getattr(b, key), key


# ------------------------------------------- health, numerics, checksums


def test_poisoned_member_is_named(monkeypatch):
    from grayscott_jl_tpu_torch.resilience.health import (HealthError,
                                                          HealthGuard)

    monkeypatch.setenv("GS_FAULT_MEMBER", "1")
    ens = EnsembleSimulation(port_settings(), n_devices=8, seed=7)
    ens.iterate(2)
    rep = ens.snapshot_async(health=True).health_report()
    assert rep.finite and rep.bad_members == [] and len(rep.members) == 3
    ens.poison_nan()
    rep = ens.snapshot_async(health=True).health_report()
    assert not rep.finite and rep.bad_members == [1]
    assert rep.members[0].finite and rep.members[2].finite
    with pytest.raises(HealthError, match=r"non-finite members=\[1\]"):
        HealthGuard("abort").check(20, rep)
    assert HealthGuard("warn").check(20, rep)["bad_members"] == [1]


def test_member_reports_equal_solo_reports():
    """Each member's health and numerics row equals its solo run's."""
    s = port_settings()
    ens = EnsembleSimulation(s, n_devices=8, seed=1)
    ens.iterate(3)
    snap = ens.snapshot_async(health=True, numerics=True)
    rep, num = snap.health_report(), snap.numerics_report()
    for k in range(3):
        solo = Simulation(member_settings(s, k), n_devices=8, seed=1 + k)
        solo.iterate(3)
        ss = solo.snapshot_async(health=True, numerics=True)
        assert rep.members[k].describe() == ss.health_report().describe()
        for name, stats in ss.numerics_report().fields.items():
            got = num.members[k][name]
            assert got["min"] == stats["min"] and got["max"] == stats["max"]
            assert got["mean"] == pytest.approx(stats["mean"], rel=1e-12)
    assert num.fields["u"]["min"] == min(m["u"]["min"] for m in num.members)


def test_member_checksums_equal_the_reference_bitwise():
    """The same member fields in both packages: each member's device
    checksum rows are equal, and the snapshot verifies."""
    rng = np.random.default_rng(3)
    members = [tuple(rng.random((16, 16, 16), dtype=np.float32)
                     for _ in range(2)) for _ in range(3)]
    port = EnsembleSimulation(port_settings(), n_devices=8, seed=0)
    port.restore_members(members, 0)
    ref = ref_engine.EnsembleSimulation(ref_settings(), n_devices=8, seed=0)
    ref.restore_members(members, 0)
    a = port.snapshot_async(checksum=True)
    b = ref.snapshot_async(checksum=True)
    assert a.checksum_report() == b.checksum_report()
    a.blocks()  # verified against the landed bytes


def test_bitflip_names_the_member(monkeypatch):
    from grayscott_jl_tpu_torch.io.bplite import CorruptionError

    monkeypatch.setenv("GS_FAULT_MEMBER", "2")
    ens = EnsembleSimulation(port_settings(), seed=0)
    ens.iterate(2)
    with pytest.raises(CorruptionError, match="member 2") as e:
        ens.snapshot_async(checksum=True, bitflip=True).blocks()
    assert e.value.member == 2


@pytest.mark.parametrize("member", [0, 2])
def test_sdc_screen_names_the_member(monkeypatch, member):
    from grayscott_jl_tpu_torch.resilience.sdc import Screener, SDCError

    monkeypatch.setenv("GS_FAULT_MEMBER", str(member))
    ens = EnsembleSimulation(port_settings(), n_devices=2, seed=0)
    screener = Screener(ens, mode="spot")
    ens.iterate(2)
    screener.rearm(2)
    ens.poison_sdc()
    ens.iterate(2)
    with pytest.raises(SDCError) as e:
        screener.check(4)
    assert e.value.member == member


def test_idle_slots_are_masked():
    s = port_settings()
    members = list(s.ensemble.members)
    members[1] = dataclasses.replace(members[1], active=False)
    s.ensemble = dataclasses.replace(s.ensemble, members=tuple(members))
    ens = EnsembleSimulation(s, seed=0)
    assert ens.active_member_count == 2
    ens.iterate(2)
    ens.poison_nan(member=1)
    snap = ens.snapshot_async(health=True, numerics=True)
    rep = snap.health_report()
    assert rep.finite and rep.bad_members == [] and not rep.members[1].finite
    assert rep.describe()["active_members"] == 2
    num = snap.numerics_report()
    assert num.fields["u"]["nonfinite"] == 0
    assert num.members[1]["u"]["nonfinite"] == 1


# --------------------------------------------------------------- resume


def _run_ckpt(tmp_path, presets, steps, name="run", **kw):
    """A CLI-driver ensemble run with checkpoints every 5 steps."""
    from grayscott_jl_tpu_torch import driver

    d = tmp_path / name
    d.mkdir(exist_ok=True)
    s = port_settings(presets, steps=steps, plotgap=5, checkpoint=True,
                      checkpoint_freq=5, output=str(d / "gs.bp"),
                      checkpoint_output=str(d / "ckpt.bp"),
                      restart_input=str(d / "ckpt.bp"), **kw)
    return driver.run_once(s, seed=0), s, d


def _resumed(s, presets, **kw):
    r = dataclasses.replace(s, **{"restart": True, **kw})
    r.ensemble = ens_spec.from_toml(_table(presets), r)
    return r


def test_quorum_step_after_an_uneven_crash(tmp_path):
    from grayscott_jl_tpu_torch.ensemble.io import restore_ensemble
    from grayscott_jl_tpu_torch.resilience.supervisor import (
        latest_durable_checkpoint)

    _, s, d = _run_ckpt(tmp_path, ["spots", "chaos"], 10)
    _, s5, d5 = _run_ckpt(tmp_path, ["spots", "chaos"], 5, name="short")
    # Member 1 crashed before its step-10 checkpoint.
    import shutil

    shutil.rmtree(d / "ckpt.m01.bp")
    shutil.copytree(d5 / "ckpt.m01.bp", d / "ckpt.m01.bp")
    assert latest_durable_checkpoint(s) == 5
    sim = EnsembleSimulation(s, seed=0)
    step, plan = restore_ensemble(sim, _resumed(s, ["spots", "chaos"]))
    assert step == 5 and not plan.changed
    assert plan.members == {"restored": 2, "grown": 0, "new_n": 2}


def test_grow_resume_adds_a_member_begun_at_the_resume_step(tmp_path):
    from grayscott_jl_tpu_torch.ensemble.io import restore_ensemble

    full, s, d = _run_ckpt(tmp_path, ["spots", "chaos"], 10)
    grown = _resumed(s, ["spots", "chaos", "waves"], restart_step=5)
    sim = EnsembleSimulation(grown, seed=0)
    step, plan = restore_ensemble(sim, grown)
    assert step == 5 and plan.changed
    assert plan.members == {"restored": 2, "grown": 1, "new_n": 3}
    sim.iterate(5)
    got = sim.get_fields()
    for a, b in zip(got, full.get_fields()):
        assert np.array_equal(a[:2], b)
    late = Simulation(member_settings(grown, 2), seed=2)
    late.restore_fields(sim.member_init_fields(), 5)
    late.iterate(5)
    for a, b in zip(got, late.get_fields()):
        assert np.array_equal(a[2], b)


def test_shrink_resume_drops_the_trailing_members(tmp_path):
    from grayscott_jl_tpu_torch.ensemble.io import restore_ensemble

    full, s, d = _run_ckpt(tmp_path, THREE, 10)
    shrunk = _resumed(s, THREE[:2], restart_step=5)
    sim = EnsembleSimulation(shrunk, seed=0)
    step, plan = restore_ensemble(sim, shrunk)
    assert plan.members == {"restored": 2, "grown": 0, "new_n": 2}
    sim.iterate(5)
    for a, b in zip(sim.get_fields(), full.get_fields()):
        assert np.array_equal(a, b[:2])
    assert (d / "ckpt.m02.bp").is_dir()  # left as it was


def test_a_gap_and_reshard_off_refuse(tmp_path):
    import shutil

    from grayscott_jl_tpu_torch.ensemble.io import restore_ensemble
    from grayscott_jl_tpu_torch.reshard.plan import ReshardError

    _, s, d = _run_ckpt(tmp_path, THREE, 5)
    grown = _resumed(s, THREE + ["waves"])
    with pytest.raises(ReshardError, match="reshard='off'"):
        restore_ensemble(EnsembleSimulation(grown, seed=0), grown,
                         allow="off")
    shutil.rmtree(d / "ckpt.m01.bp")
    again = _resumed(s, THREE)
    with pytest.raises(ReshardError, match="gap"):
        restore_ensemble(EnsembleSimulation(again, seed=0), again)


@pytest.mark.parametrize("presets", [THREE[:2], THREE + ["waves"]],
                         ids=["shrink", "grow"])
def test_live_move_changes_the_member_axis(presets):
    from grayscott_jl_tpu_torch.reshard.restore import reshape_live

    s = port_settings()
    live = EnsembleSimulation(s, n_devices=8, seed=0)
    live.iterate(3)
    target_settings = _resumed(s, presets, restart=False)
    moved, plan = reshape_live(live, mesh_dims=(2, 2, 1),
                               settings=target_settings)
    assert plan.changed and moved.n_members == len(presets)
    assert moved.domain.dims == (2, 2, 1)
    assert moved.reshard["members"]["new_n"] == len(presets)
    moved.iterate(3)
    ref = EnsembleSimulation(s, n_devices=8, seed=0)
    ref.iterate(6)
    keep = min(3, len(presets))
    for a, b in zip(moved.get_fields(), ref.get_fields()):
        assert np.array_equal(a[:keep], b[:keep])
    if len(presets) > 3:
        late = Simulation(member_settings(target_settings, 3), seed=3)
        late.restore_fields(moved.member_init_fields(), 3)
        late.iterate(3)
        for a, b in zip(moved.get_fields(), late.get_fields()):
            assert np.array_equal(a[3], b)


def test_live_member_move_refused_under_reshard_off():
    from grayscott_jl_tpu_torch.reshard.plan import ReshardError
    from grayscott_jl_tpu_torch.reshard.restore import reshape_live

    s = port_settings(reshard="off")
    live = EnsembleSimulation(s, seed=0)
    with pytest.raises(ReshardError, match="refused"):
        reshape_live(live, settings=_resumed(s, THREE[:2], restart=False))


# ------------------------------------------------------------------ tuner


def test_cache_key_differs_by_ensemble_size_and_split():
    from grayscott_jl_tpu_torch.tune import cache

    base = dict(device_kind="NVIDIA H100 80GB HBM3", platform="cuda",
                dims=(2, 2, 2), L=64, dtype="float32", noise=0.1,
                torch_version="2.x", cuda_version="12.8")
    keys = [cache.cache_key(**base), cache.cache_key(**base, ensemble=8),
            cache.cache_key(**base, ensemble=16),
            cache.cache_key(**base, ensemble=16, member_shards=2)]
    assert keys[0]["ensemble"] == 1 and keys[0]["schema"] >= 2
    assert len({cache.key_digest(k) for k in keys}) == 4


@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_candidates_span_the_member_splits(platform):
    from grayscott_jl_tpu_torch.tune import candidates

    kernel = "cuda" if platform == "cuda" else "plain"
    cands = candidates.generate(
        dims=(2, 2, 1), L=16, platform=platform, itemsize=4, fuse_cap=2,
        analytic_kernel=kernel, analytic_fuse=1, comm_overlap=False,
        overlap_toggle=False, top_n=32, ensemble=4, member_shards=2)
    assert {c.member_shards for c in cands} == {1, 2, 4}
    alt = next(c for c in cands if c.member_shards == 4)
    assert alt.mesh is not None and int(np.prod(alt.mesh)) == 2
    [pick] = [c for c in cands if c.analytic]
    assert pick.member_shards == 2
    rt = candidates.from_dict(alt.as_dict())
    assert (rt.mesh, rt.member_shards) == (alt.mesh, 4)


def test_batched_launch_is_priced_once():
    """The card's projection of a batched round: N members' device time,
    one launch floor (not N solo rounds)."""
    from grayscott_jl_tpu_torch.parallel import icimodel as im

    kw = dict(launch_us=im.LAUNCH_US, blocks=8)
    one = im.projected_step_us("cuda", (2, 2, 2), 256, 1, **kw)
    five = im.projected_step_us("cuda", (2, 2, 2), 256, 1, members=5, **kw)
    assert one < five < 5 * one


def test_cached_miss_is_bitwise_off(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_AUTOTUNE_CACHE", str(tmp_path / "tc"))
    runs = []
    for mode in ("off", "cached"):
        monkeypatch.setenv("GS_AUTOTUNE", mode)
        ens = EnsembleSimulation(port_settings(), n_devices=8, seed=0)
        prov = ens.kernel_selection["autotune"]
        assert prov["mode"] == mode and prov.get("source") != "measured"
        ens.iterate(4)
        runs.append(ens.get_fields())
    for a, b in zip(*runs):
        assert np.array_equal(a, b)


def test_measured_split_is_adopted(monkeypatch):
    """A decision carrying another member split is adopted before the
    blocks are built; the members still equal their solo runs."""
    from grayscott_jl_tpu_torch import tune
    from grayscott_jl_tpu_torch.tune.autotuner import TuneDecision

    real = tune.autotune

    def fake(settings, **kw):
        assert kw["ensemble"] == 4 and kw["member_shards"] == 1
        d = real(settings, **kw)
        return TuneDecision(kernel="plain", fuse=1, comm_overlap=False,
                            member_shards=2,
                            provenance={**d.provenance,
                                        "source": "measured"})

    monkeypatch.setattr(tune, "autotune", fake)
    s = port_settings(FOUR)
    ens = EnsembleSimulation(s, n_devices=8, seed=0)
    monkeypatch.setattr(tune, "autotune", real)
    assert ens.member_shards == 2 and ens.domain.dims == (2, 2, 1)
    assert ens.kernel_selection["autotune"]["adopted_member_shards"] == 2
    ens.iterate(3)
    for k in range(4):
        solo = Simulation(member_settings(s, k), n_devices=4, seed=k)
        solo.iterate(3)
        for a, b in zip(ens.get_fields(), solo.get_fields()):
            assert np.array_equal(a[k], b)


# ----------------------------------------------------------------- repack


def test_repack_rebinds_without_a_build(monkeypatch):
    from grayscott_jl_tpu_torch.ops import _build

    s = port_settings(kernel_language="Pallas")
    ens = EnsembleSimulation(s, seed=0)
    ens.iterate(2)

    def no_build(*a, **k):
        raise AssertionError("repack built a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    other = port_settings(["waves", "mitosis", "spots"],
                          kernel_language="Pallas")
    ens.repack(other, seed=4)
    assert ens.step == 0 and ens.reshard is None
    ens.iterate(3)
    fresh = EnsembleSimulation(other, seed=4)
    fresh.iterate(3)
    for a, b in zip(ens.get_fields(), fresh.get_fields()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("change", [
    dict(presets=THREE[:2]), dict(presets=FOUR, member_shards=2),
    dict(L=32), dict(precision="Float64"), dict(kernel_language="Plain"),
    dict(comm_overlap="off"), dict(halo_depth=2), dict(noise=0.0),
])
def test_repack_refuses_a_new_shape(change):
    ens = EnsembleSimulation(port_settings(kernel_language="Pallas"), seed=0)
    kw = dict(kernel_language="Pallas")
    kw.update(change)
    presets = kw.pop("presets", THREE)
    shards = kw.pop("member_shards", 1)
    with pytest.raises(ValueError, match="repack"):
        ens.repack(port_settings(presets, shards, **kw))


def test_repack_refuses_another_model():
    ens = EnsembleSimulation(port_settings(), seed=0)
    s = Settings(L=16, noise=0.1, precision="Float32", backend="CPU",
                 model="brusselator", dt=0.05)
    s.ensemble = ens_spec.from_toml({"presets": ["steady", "turing",
                                                 "oscillatory"]}, s)
    with pytest.raises(ValueError, match="model"):
        ens.repack(s)


# ------------------------------------------------- the kernel's schedule


@pytest.mark.parametrize("load", ["tma", "cp_async"])
@pytest.mark.parametrize("fuse", [1, 2])
def test_window_of_a_member_takes_its_own_edge(load, fuse):
    """``emulate_window`` with a member offset — the CPU stand-in of the
    batched launch's 4-D tensor map — loads member k's window: at the
    low x edge its ghosts are the boundary value, never member k - 1's
    last planes, which a 3-D view of the stacked fields would read."""
    g = torch.Generator().manual_seed(0)
    fields = [torch.rand((3, 16, 16, 40), generator=g) + 2.0
              for _ in range(2)]
    bvs = (1.0, 0.0)
    origin = (-fuse, 8 - fuse, 32 - fuse)
    wz = cuda_stencil.window_geometry(4, fuse)[2]
    for k in range(3):
        got = cuda_stencil.emulate_window(
            fields, fuse=fuse, origin=origin, boundaries=bvs, load=load,
            member=k)
        want = cuda_stencil.emulate_window(
            [f[k] for f in fields], fuse=fuse, origin=origin,
            boundaries=bvs, load=load)
        for a, b, bv in zip(got, want, bvs):
            assert torch.equal(a.nan_to_num(-9.0), b.nan_to_num(-9.0))
            assert bool((a[:fuse, :, :wz] == bv).all())
        if k:
            flat = [f.reshape(48, 16, 40) for f in fields]
            wrong = cuda_stencil.emulate_window(
                flat, fuse=fuse, origin=(16 * k - fuse,) + origin[1:],
                boundaries=bvs, load=load)
            assert not torch.equal(wrong[0][:fuse, :, :wz],
                                   got[0][:fuse, :, :wz])


def test_batched_plain_versions_equal_solo_calls():
    """The plain versions with a leading member axis (the CPU path of a
    batched call) equal the solo calls bitwise, every mode."""
    from grayscott_jl_tpu_torch.models import get_model

    model = get_model("grayscott")
    rows = [dict(Du=0.2, Dv=0.1, F=0.02 + 0.01 * i, k=0.05, dt=1.0,
                 noise=0.1) for i in range(3)]
    params = cuda_stencil.member_params(rows, model.params_cls,
                                        torch.float32)
    keys = [(0, 5), (0, 6), (0, 2**31 + 7)]
    seeds = cuda_stencil.member_seeds(keys, 3)
    g = torch.Generator().manual_seed(1)
    f = tuple(torch.rand((3, 6, 10, 12), generator=g) for _ in range(2))
    x2 = tuple(torch.rand((3, 2, 10, 12), generator=g) for _ in range(4))
    f6 = tuple(torch.rand((3,) + s, generator=g) for s in
               [(1, 10, 12)] * 4 + [(6, 1, 12)] * 4 + [(6, 10, 1)] * 4)
    calls = [(None, 1, {}), (None, 2, {}), (f6, 1, {}),
             (x2, 2, {"offsets": (6, 0, 0)})]
    for faces, fuse, kw in calls:
        got = cuda_stencil.fused_step(f, params, seeds, faces, spec=model,
                                      fuse=fuse, row=16, **kw)
        for m in range(3):
            solo = cuda_stencil.fused_step(
                tuple(x[m] for x in f), cuda_stencil.params_row(params, m),
                (keys[m][0], keys[m][1], 3),
                None if faces is None else tuple(x[m] for x in faces),
                spec=model, fuse=fuse, row=16, **kw)
            assert all(torch.equal(a[m], b) for a, b in zip(got, solo))
