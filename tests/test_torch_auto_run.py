"""Auto's decision end to end on the CPU: the measured tuner through the
driver, against the run pinned at its winner and against the
reference's run of the same settings; the ``RunStats`` ``comm`` section
and the fabric model's gauges; and, on a monkeypatched card, the mesh and
depth adoption of the fabric model, bitwise equal to the single block.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax  # noqa: F401 — the reference's modules below need it

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.simulation import Simulation as RefSimulation
from grayscott_jl_tpu_torch import Settings, Simulation, driver, simulation
from grayscott_jl_tpu_torch.config.settings import get_settings
from grayscott_jl_tpu_torch.io.bplite import BpReader
from grayscott_jl_tpu_torch.obs import metrics
from grayscott_jl_tpu_torch.parallel import icimodel

PHYS = dict(Du=0.2, Dv=0.1, F=0.02, k=0.048, dt=1.0, noise=0.1,
            precision="Float32")


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_AUTOTUNE_CACHE", str(tmp_path / "tune"))
    for var in ("GS_AUTOTUNE", "GS_FUSE", "GS_TPU_MESH_DIMS",
                "GS_HALO_DEPTH", "GS_COMM_OVERLAP", "GS_AUTOTUNE_TOPN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("GS_AUTOTUNE_STEPS", "2")
    monkeypatch.setenv("GS_AUTOTUNE_ROUNDS", "1")


def _config(path, **kw):
    base = dict(L=16, steps=10, plotgap=5, backend="CPU",
                kernel_language="Auto", output=str(path.parent / "gs.bp"),
                **PHYS)
    base.update(kw)
    lines = [f'{k} = "{v}"' if isinstance(v, str)
             else f"{k} = {'true' if v else 'false'}" if isinstance(v, bool)
             else f"{k} = {v}" for k, v in base.items()]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _store(path):
    with BpReader(path) as r:
        return [(int(r.get("step", step=i)), r.get("U", step=i),
                 r.get("V", step=i)) for i in range(r.num_steps())]


def _stats(monkeypatch, path, cfg, **kw):
    monkeypatch.setenv("GS_TPU_STATS", str(path))
    try:
        sim = driver.main([cfg], **kw)
    finally:
        monkeypatch.delenv("GS_TPU_STATS")
    return sim, json.loads(path.read_text())


def test_quick_on_a_cpu_mesh_equals_its_pinned_winner_and_the_reference(
        tmp_path, monkeypatch):
    """Auto + quick on the (2,2,1) mesh through the driver: the tuner
    times the shortlist and stores the winner; the fields are bitwise the
    run pinned at the winner's schedule, and within 1e-6 of the
    reference's Auto + quick run of the same settings and seed; then
    ``cached`` hits with no candidate timed and the same schedule."""
    monkeypatch.setenv("GS_AUTOTUNE", "quick")
    sim, stats = _stats(monkeypatch, tmp_path / "q.json",
                        _config(tmp_path / "q.toml"), n_devices=4)
    prov = sim.kernel_selection["autotune"]
    assert sim.domain.dims == (2, 2, 1)
    assert prov["source"] == "measured" and prov["candidates_timed"] >= 2
    assert stats["config"]["kernel_selection"]["autotune"] == prov
    assert stats["config"]["autotune_mode"] == "quick"
    win = prov["winner"]
    assert (sim.kernel_language, sim.fuse, sim.comm_overlap,
            sim.halo_depth) == (win["kernel"], win["fuse"],
                                win["comm_overlap"], win["halo_depth"])
    monkeypatch.setenv("GS_FUSE", str(win["fuse"]))
    pinned = Simulation(Settings(
        L=16, backend="CPU", **PHYS, kernel_language="Plain",
        comm_overlap="on" if win["comm_overlap"] else "off",
        halo_depth=win["halo_depth"]), n_devices=4)
    monkeypatch.delenv("GS_FUSE")
    pinned.iterate(10)
    for a, b in zip(sim.get_fields(), pinned.get_fields()):
        np.testing.assert_array_equal(a, b)

    monkeypatch.setenv("GS_AUTOTUNE_TOPN", "1")
    ref = RefSimulation(RefSettings(L=16, backend="CPU", **PHYS,
                                    kernel_language="Auto"), n_devices=4)
    assert ref.kernel_selection["autotune"]["source"] == "measured"
    ref.iterate(10)
    for a, b in zip(sim.get_fields(), ref.get_fields()):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)

    monkeypatch.setenv("GS_AUTOTUNE", "cached")
    again, _ = _stats(monkeypatch, tmp_path / "c.json",
                      _config(tmp_path / "c.toml",
                              output=str(tmp_path / "c.bp")), n_devices=4)
    hit = again.kernel_selection["autotune"]
    assert (hit["cache"], hit["candidates_timed"]) == ("hit", 0)
    assert hit["winner"] == win
    assert (again.fuse, again.comm_overlap, again.halo_depth) == (
        sim.fuse, sim.comm_overlap, sim.halo_depth)
    for (s1, u1, v1), (s2, u2, v2) in zip(_store(str(tmp_path / "gs.bp")),
                                          _store(str(tmp_path / "c.bp"))):
        assert s1 == s2
        np.testing.assert_array_equal(u1, u2)
        np.testing.assert_array_equal(v1, v2)


def test_runstats_comm_and_the_model_gauges(tmp_path, monkeypatch):
    """A sharded run writes the ``comm`` section and the fabric model's
    gauges, the residual against the observed step latency included; a
    single block's section is the reference's single-device one."""
    monkeypatch.setenv("GS_METRICS", str(tmp_path / "m.jsonl"))
    metrics.reset_metrics()
    try:
        sim, stats = _stats(monkeypatch, tmp_path / "s.json",
                            _config(tmp_path / "s.toml"), n_devices=8)
        snap = metrics.get_metrics().snapshot()
    finally:
        metrics.reset_metrics()
    comm = stats["comm"]
    assert comm == icimodel.comm_report(sim)
    assert comm["model"] == "fabric-projection"
    assert comm["mesh_dims"] == [2, 2, 2] and comm["placement"] == "shared"
    assert comm["kernel"] == "plain" and comm["comm_us_per_step"] > 0
    gauges = {g["name"]: g["value"] for g in snap["gauges"]}
    assert gauges["comm_exposed_us_per_step"] == comm["exposed_us"]
    assert gauges["comm_hidden_us_per_step"] == comm["hidden_us"]
    assert gauges["comm_exchanges_per_step"] == comm["exchanges_per_step"]
    assert gauges["comm_halo_bytes_per_step"] == comm["halo_bytes_per_step"]
    proj = icimodel.projected_step_us_for(sim)
    assert gauges["model_projected_step_us"] == round(proj, 1)
    assert "model_vs_measured_residual_us" in gauges

    one, stats1 = _stats(monkeypatch, tmp_path / "one.json",
                         _config(tmp_path / "one.toml",
                                 output=str(tmp_path / "one.bp")))
    from grayscott_jl_tpu.parallel import icimodel as ref_icimodel

    ref_single = ref_icimodel.comm_report(
        RefSimulation(RefSettings(L=16, backend="CPU", **PHYS), n_devices=1))
    assert stats1["comm"] == {**ref_single, "model": "fabric-projection"}


def test_a_live_move_refreshes_the_comm_section(tmp_path, monkeypatch):
    calls = [0]

    def poll():
        calls[0] += 1
        return {"mesh_dims": [1, 2, 2]} if calls[0] == 2 else None

    cfg = _config(tmp_path / "m.toml")
    monkeypatch.setenv("GS_TPU_STATS", str(tmp_path / "m.json"))
    try:
        sim = driver.run_once(get_settings([cfg]), n_devices=8,
                              reshape_poll=poll)
    finally:
        monkeypatch.delenv("GS_TPU_STATS")
    stats = json.loads((tmp_path / "m.json").read_text())
    assert sim.domain.dims == (1, 2, 2) and sim.reshard is not None
    assert stats["comm"]["mesh_dims"] == [1, 2, 2]
    assert stats["comm"] == icimodel.comm_report(sim)
    assert stats["config"]["mesh_dims"] == [1, 2, 2]


@pytest.fixture
def card(monkeypatch):
    """A monkeypatched card whose blocks live on the host's device: the
    kernel path runs its plain versions, the decision is the card's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(
        simulation, "select_devices",
        lambda kind, n, devices: ([torch.device("cpu")] * len(devices)
                                  if devices else
                                  [torch.device("cpu")] * (n or 1)))


def _card_settings(**kw):
    return Settings(L=kw.pop("L", 32), backend="CUDA", **PHYS,
                    kernel_language="Auto", **kw)


def test_the_card_adopts_the_models_mesh_and_depth(card):
    """Eight blocks with the mesh not pinned: the picked row's mesh and
    depth are adopted, and the fields equal the single block's."""
    sim = Simulation(_card_settings(), n_devices=8)
    sel = sim.kernel_selection
    row = sel["rows"][sel["pick"]]
    assert sim.kernel_language == "cuda"
    assert sim.domain.dims == tuple(int(x) for x in row["mesh"].split(","))
    assert sel.get("adopted_mesh", list(sim.domain.dims)) == list(
        sim.domain.dims)
    assert sim.fuse == row["fuse"]
    assert sel["placement"] == "shared" and sel["blocks"] == 8
    assert sel["generated"] is True and "generator_version" in sel
    assert sel["autotune"]["source"] == "analytic"
    one = Simulation(_card_settings(), n_devices=1)
    assert one.kernel_language == "cuda" and "rows" not in (
        one.kernel_selection)
    for s in (sim, one):
        s.iterate(6)
    for a, b in zip(sim.get_fields(), one.get_fields()):
        np.testing.assert_array_equal(a, b)


def test_the_card_respects_a_pinned_mesh_and_depth(card, monkeypatch):
    sim = Simulation(_card_settings(), n_devices=8, mesh_dims=(2, 2, 2))
    assert sim.domain.dims == (2, 2, 2)
    assert "adopted_mesh" not in sim.kernel_selection
    monkeypatch.setenv("GS_TPU_MESH_DIMS", "8,1,1")
    monkeypatch.setenv("GS_FUSE", "2")
    pinned = Simulation(_card_settings(), n_devices=8)
    assert pinned.domain.dims == (8, 1, 1) and pinned.fuse == 2
    assert "adopted_mesh" not in pinned.kernel_selection


def test_quick_on_the_card_times_kernel_candidates_only(card, monkeypatch):
    monkeypatch.setenv("GS_AUTOTUNE", "quick")
    sim = Simulation(_card_settings(L=16), n_devices=4,
                     mesh_dims=(2, 2, 1))
    prov = sim.kernel_selection["autotune"]
    assert prov["source"] == "measured" and prov["candidates_timed"] >= 2
    with open(prov["cache_path"], encoding="utf-8") as f:
        rec = json.load(f)
    assert {m["candidate"]["kernel"] for m in rec["measurements"]} == {
        "cuda"}
    assert rec["key"]["platform"] == "cuda"
    assert sim.kernel_language == "cuda" == prov["winner"]["kernel"]
    base = Simulation(dataclasses.replace(_card_settings(L=16),
                                          autotune="off"), n_devices=1)
    for s in (sim, base):
        s.iterate(4)
    for a, b in zip(sim.get_fields(), base.get_fields()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("overlap,armed", [("auto", False), ("on", True)])
def test_the_card_adopts_the_picks_round_under_auto(card, monkeypatch,
                                                   overlap, armed):
    """Under ``comm_overlap = "auto"`` the adopted chain runs the round
    the pick chose (fused on the card's table); a pinned ``"on"`` keeps
    the split round. The fields equal the single block's either way."""
    # Depth 2 at L=64: the chain's blocks are deep enough for the split
    # form (a geometry without it ties, and runs fused either way).
    monkeypatch.setenv("GS_FUSE", "2")
    sim = Simulation(_card_settings(L=64, comm_overlap=overlap),
                     n_devices=8)
    sel = sim.kernel_selection
    row = sel["rows"][sel["pick"]]
    assert row["schedule"] != "faces6"
    assert row.get("comm_overlap", True) is armed
    assert sim.comm_overlap is armed
    one = Simulation(_card_settings(L=64), n_devices=1)
    for s in (sim, one):
        s.iterate(6)
    assert sim.overlap_applied is armed
    for a, b in zip(sim.get_fields(), one.get_fields()):
        np.testing.assert_array_equal(a, b)


def test_a_model_too_wide_for_the_ledger_refuses_on_the_card(card):
    """Six float64 fields fit no schedule of the kernel: Auto on the
    card refuses at construction, naming the shared-memory ledger,
    instead of running the plain path there."""
    from grayscott_jl_tpu_torch.models import SettingsError, base

    def init(L, dtype, *, offsets=(0, 0, 0), sizes=None, device=None):
        return base.seeded_box_init(
            L, dtype, backgrounds=(0.0,) * 6, seed_values=(1.0,) * 6,
            half_width=2, offsets=offsets, sizes=sizes, device=device)

    def reaction(fields, laps, noise, params):
        return tuple(params.D * lap for lap in laps)

    base.register(base.Model(
        name="six_fields_fixture", field_names=tuple("abcdef"),
        boundaries=(0.0,) * 6, param_decls={"D": 0.1}, reaction=reaction,
        init=init))
    try:
        settings = Settings(L=16, backend="CUDA", precision="Float64",
                            kernel_language="Auto",
                            model="six_fields_fixture")
        for n in (1, 8):
            with pytest.raises(SettingsError, match="shared-memory ledger"):
                Simulation(settings, n_devices=n)
        cpu = Simulation(dataclasses.replace(settings, backend="CPU"),
                         n_devices=1)
        assert cpu.kernel_language == "plain"
    finally:
        base._REGISTRY.pop("six_fields_fixture", None)
