"""The port's fabric model (``grayscott_jl_tpu_torch/parallel/icimodel.py``)
against the reference's (``grayscott_jl_tpu/parallel/icimodel.py``), and
Auto's decision on the card and off it.

The projections are the reference's formulas with the card's
coefficients: with the port's tables set to the reference's literals,
and both packages given the port's shared-memory ledger as their
feasibility function, every projection row equals the reference's to
1e-12 (the reference's ``fuse_cost_ratio_interpolated`` flag aside: no
card ratio is interpolated). The cases below mirror
``tests/unit/test_auto_kernel.py`` where a case has a counterpart.
"""

import numpy as np
import pytest

import jax  # noqa: F401 — the reference's modules below need it

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.ops import pallas_stencil as ref_ps
from grayscott_jl_tpu.parallel import icimodel as ref
from grayscott_jl_tpu.simulation import Simulation as RefSimulation
from grayscott_jl_tpu_torch import Settings, Simulation
from grayscott_jl_tpu_torch.config.settings import parse_settings_toml
from grayscott_jl_tpu_torch.ops import cuda_stencil
from grayscott_jl_tpu_torch.parallel import icimodel

H100 = "NVIDIA H100 80GB HBM3"


def _settings(**kw):
    return Settings(
        L=kw.pop("L", 16), Du=0.2, Dv=0.1, F=0.02, k=0.048, dt=1.0,
        noise=kw.pop("noise", 0.1), precision="Float32", backend="CPU",
        kernel_language=kw.pop("kernel_language", "Auto"), **kw,
    )


@pytest.fixture
def ref_tables(monkeypatch):
    """The port's coefficient tables set to the reference's literals,
    both packages on the port's shared-memory ledger, no launch floor,
    and an s-step round priced at its base depth."""
    monkeypatch.setattr(icimodel, "FUSE_COST_RATIO",
                        dict(ref.FUSE_COST_RATIO))
    monkeypatch.setattr(icimodel, "MEASURED_US", {
        ({"Pallas": "cuda", "XLA": "plain"}[lang], side): us
        for (lang, side), us in ref.MEASURED_US.items()})
    monkeypatch.setattr(icimodel, "STAGE_RATIO", {
        "cuda": ref.STAGE_RATIO["Pallas"], "plain": ref.STAGE_RATIO["XLA"]})
    monkeypatch.setattr(icimodel, "OVERLAP_EFFICIENCY",
                        ref.OVERLAP_EFFICIENCY)
    monkeypatch.setattr(icimodel, "HALO_DEPTH_EFFICIENCY", {
        "plain": ref.HALO_DEPTH_EFFICIENCY["xla"],
        "cuda": ref.HALO_DEPTH_EFFICIENCY["pallas"]})
    monkeypatch.setattr(icimodel, "BF16_COMPUTE_RATIO",
                        ref.BF16_COMPUTE_RATIO)
    monkeypatch.setattr(icimodel, "Z_BAND_US_PER_CELL",
                        ref.MEASURED_US[("XLA", 256)] / 256**3)
    monkeypatch.setattr(icimodel, "SUBLANE", 8)
    monkeypatch.setattr(icimodel, "LAUNCH_US", 0.0)
    monkeypatch.setattr(icimodel, "SSTEP_AT_CHAIN_DEPTH", False)

    def ledger(local, itemsize, kmax, sublane=8, ypad=True, n_fields=2):
        # The reference applies its geometry caps before the call; the
        # port's ledger adds the same caps, so both compose alike.
        return cuda_stencil.max_feasible_chain_depth(
            local, (2, 2, 1) if ypad else (2, 1, 1), itemsize, kmax,
            n_fields)

    monkeypatch.setattr(ref, "_feasible_chain_depth", ledger)
    monkeypatch.setattr(ref_ps, "mosaic_gate_reason", lambda *a, **k: None)


def _same_row(port_row, ref_row):
    ref_row = {k: v for k, v in ref_row.items()
               if k != "fuse_cost_ratio_interpolated"}
    assert set(port_row) == set(ref_row)
    for k, v in ref_row.items():
        if isinstance(v, float):
            assert port_row[k] == pytest.approx(v, rel=1e-12, abs=0), k
        else:
            assert port_row[k] == v, k


# --------------------------------------- projections against the reference

@pytest.mark.parametrize("k,eff", [(1, None), (2, None), (4, None),
                                   (3, 0.5)])
def test_sstep_amortization_equals_reference(ref_tables, k, eff):
    for lang, ref_lang in (("plain", "xla"), ("cuda", "pallas")):
        assert icimodel.sstep_amortization(k, eff, lang) == pytest.approx(
            ref.sstep_amortization(k, eff, ref_lang), rel=1e-12)


@pytest.mark.parametrize("compute,comm,eff", [
    (100.0, 50.0, None), (10.0, 80.0, None), (0.0, 5.0, None),
    (30.0, 0.0, 0.5), (7.0, 3.0, 0.2)])
def test_overlap_fraction_equals_reference(ref_tables, compute, comm, eff):
    assert icimodel.overlap_fraction(compute, comm, eff) == pytest.approx(
        ref.overlap_fraction(compute, comm, eff), rel=1e-12, abs=0)


@pytest.mark.parametrize("local,fuse,kw", [
    (128, 1, {}), (64, 3, dict(stage_ratio=1.46, links=4)),
    (32, 2, dict(overlap="auto", halo_depth=2, itemsize=2)),
    (256, 5, dict(link_gbps=45.0, hop_us=3.0, n_fields=1)),
])
def test_project_equals_reference(ref_tables, local, fuse, kw):
    _same_row(icimodel.project(local, fuse, 123.4, **kw),
              ref.project(local, fuse, 123.4, **kw))


@pytest.mark.parametrize("n,L,fuse,kw", [
    (8, 256, 4, {}), (4, 128, 2, dict(links=1, overlap="auto")),
    (8, 256, 5, dict(local=(32, 256, 260), halo_depth=2)),
    (2, 64, 3, dict(itemsize=2, n_fields=3, hop_us=2.5)),
])
def test_project_1d_equals_reference(ref_tables, n, L, fuse, kw):
    base = ref.anchor_us("Pallas", L)
    _same_row(icimodel.project_1d(n, L, fuse, base, **kw),
              ref.project_1d(n, L, fuse, base, **kw))


@pytest.mark.parametrize("dims,L,fuse,kw", [
    ((2, 2, 2), 256, 4, dict(links=6)), ((2, 2, 2), 256, 4, dict(links=4)),
    ((3, 2, 1), 260, 3, dict(local=(87, 130, 260))),
    ((4, 2, 1), 128, 2, dict(overlap="auto", halo_depth=2)),
    ((2, 2, 4), 256, 5, dict(itemsize=2, sublane=16, n_fields=1)),
])
def test_project_chain_equals_reference(ref_tables, dims, L, fuse, kw):
    base = ref.anchor_us("Pallas", L)
    port_kw = {("band_us_per_cell" if k == "xla_us_per_cell" else k): v
               for k, v in kw.items()}
    _same_row(icimodel.project_chain(dims, L, fuse, base, **port_kw),
              ref.project_chain(dims, L, fuse, base, **kw))


@pytest.mark.parametrize("local,us,kmax", [(64, 80.0, 8), (16, 5.0, 4),
                                           (128, 400.0, 6)])
def test_best_fuse_equals_reference(ref_tables, local, us, kmax):
    _same_row(icimodel.best_fuse(local, us, kmax=kmax, overlap="auto"),
              ref.best_fuse(local, us, kmax=kmax, overlap="auto"))


@pytest.mark.parametrize("n,L,itemsize,kmax", [
    (8, 256, 4, 5), (4, 128, 4, 3), (16, 512, 2, 6), (8, 64, 4, 5)])
def test_best_chain_equals_reference(ref_tables, monkeypatch, n, L,
                                    itemsize, kmax):
    # The reference's sublane tile for 2-byte fields.
    monkeypatch.setattr(icimodel, "SUBLANE", 16 if itemsize == 2 else 8)
    base = ref.anchor_us("Pallas", L)
    kw = dict(itemsize=itemsize, kmax=kmax, links=4, overlap="auto")
    got = icimodel.best_chain(n, L, base, **kw)
    want = ref.best_chain(n, L, base, **kw)
    assert (got is None) == (want is None)
    if want is not None:
        _same_row(got, want)


@pytest.mark.parametrize("n_dev,L", [(8, 256), (4, 128), (16, 512)])
def test_swept_chain_row_equals_reference_pallas_row(ref_tables, monkeypatch,
                                                     n_dev, L):
    """Auto's chain row on a swept mesh: the reference's Pallas row (mesh,
    depth, efficiency) on the same fabric."""
    monkeypatch.setenv("GS_AUTO_LINK_GBPS", "90")
    monkeypatch.setenv("GS_AUTO_LINKS", "6")
    monkeypatch.setattr(icimodel, "_FABRICS", {"H100": {
        p: icimodel.Fabric(1.0, 6, 1.0) for p in icimodel.PLACEMENTS}})
    dims = _dims(n_dev)
    _, mine = icimodel.select_kernel(dims, L, platform="cuda",
                                     device_kind=H100, fuse=5,
                                     sweep_mesh=True)
    _, theirs = ref.select_kernel(dims, L, platform="tpu",
                                  device_kind="TPU v5p", fuse=5,
                                  sweep_mesh=True)
    row = next(r for r in mine["rows"] if r["schedule"] != "faces6")
    want = next(r for r in theirs["rows"] if r["kernel"] == "pallas")
    assert (row["mesh"], row["fuse"]) == (want["mesh"], want["fuse"])
    assert row["projected_weak_scaling_eff"] == pytest.approx(
        want["projected_weak_scaling_eff"], rel=1e-12)


def _dims(n):
    from grayscott_jl_tpu_torch.parallel.domain import dims_create

    return dims_create(n, 3)


def test_mesh_candidates_and_band_cells_equal_reference():
    for n, L in ((8, 256), (12, 96), (6, 60)):
        assert icimodel._mesh_candidates(n, L) == ref._mesh_candidates(n, L)
    for local, k in (((128, 128, 128), 2), ((32, 64, 16), 4)):
        assert (icimodel.band_cells_per_round(local, k)
                == ref.band_cells_per_round(local, k))


# ----------------------------------------------------- Auto's policy

def test_off_card_resolves_to_plain():
    lang, info = icimodel.select_kernel((2, 2, 2), 16, platform="cpu")
    assert lang == "plain"
    assert "off the card" in info["reason"]
    assert "rows" not in info


def test_single_card_resolves_to_cuda():
    lang, info = icimodel.select_kernel((1, 1, 1), 256, platform="cuda",
                                        device_kind=H100)
    assert lang == "cuda"
    assert "single block" in info["reason"]


def test_float64_chain_stays_within_its_ledger():
    """The kernel takes float64 (the reference's Pallas does not): Auto
    projects its chain only as deep as the float64 ledger admits."""
    cap = cuda_stencil.max_feasible_fuse(8)
    lang, info = icimodel.select_kernel(
        (2, 2, 2), 512, platform="cuda", device_kind=H100, itemsize=8,
        fuse=5, objective="throughput", sweep_mesh=True)
    assert lang == "cuda"
    chain = [r for r in info["rows"] if r["schedule"] != "faces6"]
    assert chain and all(r["fuse"] <= cap for r in chain)


def test_pinned_222_on_one_card_picks_the_face_schedule():
    """The z-band term: the (2,2,2) mesh pinned on one card is projected
    fastest at depth 1, not as a chain whose z bands run eager."""
    lang, info = icimodel.select_kernel(
        (2, 2, 2), 256, platform="cuda", device_kind=H100,
        placement="shared", blocks=8, fuse=5)
    row = info["rows"][info["pick"]]
    assert lang == "cuda" and row["schedule"] == "faces6"
    assert row["fuse"] == 1 and row["mesh"] == "2,2,2"
    chain = next(r for r in info["rows"] if r["schedule"] != "faces6")
    assert chain["z_band_us_per_step"] > 0


def test_efficiency_objective_picks_the_fastest_target_holder():
    for dims, L, kind, placement in (((2, 2, 2), 256, H100, "shared"),
                                     ((4, 2, 1), 512, H100, "nccl"),
                                     ((8, 1, 1), 1024, H100, "peer")):
        _, info = icimodel.select_kernel(dims, L, platform="cuda",
                                         device_kind=kind,
                                         placement=placement,
                                         eff_target=0.0)
        rows = info["rows"]
        assert info["eff_target_holders"] == [r["schedule"] for r in rows]
        assert info["pick"] == min(
            range(len(rows)), key=lambda i: rows[i]["projected_step_us"])


def test_throughput_objective_picks_the_fastest():
    _, info = icimodel.select_kernel(
        (8, 1, 1), 256, platform="cuda", device_kind=H100,
        objective="throughput", sweep_mesh=True, blocks=8)
    steps = [r["projected_step_us"] for r in info["rows"]]
    assert steps[info["pick"]] == min(steps)
    assert info["reason"] == "fastest projected absolute step time"


def test_fuse_1_suppresses_the_chain_candidate():
    lang, info = icimodel.select_kernel(
        (8, 1, 1), 256, platform="cuda", device_kind=H100, fuse=1,
        objective="throughput")
    assert lang == "cuda"
    assert [r["schedule"] for r in info["rows"]] == ["faces6"]


def test_bad_objective_raises():
    with pytest.raises(ValueError, match="GS_AUTO_OBJECTIVE"):
        icimodel.select_kernel((2, 2, 2), 16, platform="cuda",
                               objective="vibes")


def test_objective_from_the_environment(monkeypatch):
    monkeypatch.setenv("GS_AUTO_OBJECTIVE", "throughput")
    _, info = icimodel.select_kernel((2, 2, 2), 256, platform="cuda",
                                     device_kind=H100)
    assert info["objective"] == "throughput"
    monkeypatch.setenv("GS_AUTO_OBJECTIVE", "vibes")
    with pytest.raises(ValueError, match="GS_AUTO_OBJECTIVE"):
        icimodel.select_kernel((2, 2, 2), 256, platform="cuda")


def test_fabric_detection_and_env_override(monkeypatch):
    for placement in icimodel.PLACEMENTS:
        fab = icimodel.fabric_for(H100, placement)
        assert fab == icimodel._FABRICS["H100"][placement]
    # A card the table does not name gets the H100's, the one measured.
    assert icimodel.fabric_for("Some Other GPU", "peer") == (
        icimodel._FABRICS["H100"]["peer"])
    _, info = icimodel.select_kernel((2, 2, 2), 256, platform="cuda",
                                     device_kind=H100, placement="nccl")
    nccl = icimodel._FABRICS["H100"]["nccl"]
    assert (info["link_gbps"], info["links"], info["hop_us"]) == (
        nccl.link_gbps, nccl.links, nccl.hop_us)
    monkeypatch.setenv("GS_AUTO_LINK_GBPS", "123")
    monkeypatch.setenv("GS_AUTO_LINKS", "2")
    _, info = icimodel.select_kernel((2, 2, 2), 256, platform="cuda",
                                     device_kind=H100, placement="nccl")
    assert (info["link_gbps"], info["links"]) == (123.0, 2)
    with pytest.raises(ValueError, match="placement"):
        icimodel.fabric_for(H100, "carrier pigeon")


def test_sweep_mesh_finds_at_least_the_fixed_mesh():
    kw = dict(platform="cuda", device_kind=H100, objective="throughput",
              blocks=8)
    _, fixed = icimodel.select_kernel((2, 2, 2), 256, **kw)
    _, swept = icimodel.select_kernel((2, 2, 2), 256, sweep_mesh=True, **kw)
    row_f = next(r for r in fixed["rows"] if r["schedule"] != "faces6")
    row_s = next(r for r in swept["rows"] if r["schedule"] != "faces6")
    assert (row_s["projected_weak_scaling_eff"]
            >= row_f["projected_weak_scaling_eff"])
    assert "mesh" in row_s and "fuse" in row_s


def test_chain_projection_models_link_sharing():
    base = icimodel.anchor_us("cuda", 256)
    kw = dict(band_us_per_cell=0.0, link_gbps=5.0)  # the exchange alone
    r6 = icimodel.project_chain((2, 2, 2), 256, 4, base, links=6, **kw)
    r4 = icimodel.project_chain((2, 2, 2), 256, 4, base, links=4, **kw)
    assert (r4["links"], r6["links"]) == (4, 6)
    assert (r4["comm_us_per_step_exposed"]
            > r6["comm_us_per_step_exposed"])
    assert (r4["projected_weak_scaling_eff"]
            < r6["projected_weak_scaling_eff"])


def test_select_kernel_threads_fabric_links_into_rows(monkeypatch):
    monkeypatch.setenv("GS_AUTO_LINKS", "4")
    _, info = icimodel.select_kernel(
        (2, 2, 2), 256, platform="cuda", device_kind=H100,
        objective="throughput")
    for row in info["rows"]:
        assert row["links"] == 4, row["schedule"]


def test_1d_projection_accepts_links_and_local():
    base = icimodel.anchor_us("cuda", 256)
    r1 = icimodel.project_1d(8, 256, 4, base, links=1)
    r2 = icimodel.project_1d(8, 256, 4, base, links=2)
    assert r1["comm_us_per_step_exposed"] > r2["comm_us_per_step_exposed"]
    r = icimodel.project_1d(8, 256, 4, base, local=(32, 256, 260))
    assert r["local"] == 32


def test_chain_projection_accepts_caller_local_block():
    base = icimodel.anchor_us("cuda", 260)
    ceil_local = (-(-260 // 3), 130, 260)
    r = icimodel.project_chain((3, 2, 1), 260, 3, base, local=ceil_local)
    assert r["local"] == list(ceil_local)
    rf = icimodel.project_chain((3, 2, 1), 260, 3, base)
    assert rf["local"] == [260 // 3, 130, 260]
    assert r["compute_us_per_step"] == rf["compute_us_per_step"]
    assert r["x_ring_recompute"] < rf["x_ring_recompute"]


def test_1d_mesh_uses_xchain_projection():
    _, info = icimodel.select_kernel(
        (8, 1, 1), 256, platform="cuda", device_kind=H100,
        objective="throughput")
    row = next(r for r in info["rows"] if r["schedule"] != "faces6")
    assert row["mesh"] == "8,1,1" and row["schedule"] == "x-chain"
    assert "ring_recompute_ratio" in row  # project_1d's shape


# ----------------------------------------------- the card's own terms

def test_z_band_term_prices_the_eager_bands():
    base = icimodel.anchor_us("cuda", 256)
    local = (128, 128, 128)
    row = icimodel.project_chain((2, 2, 2), 256, 2, base)
    want = (icimodel.band_cells_per_round(local, 2)
            * icimodel.Z_BAND_US_PER_CELL / 2)
    assert row["z_band_us_per_step"] == pytest.approx(want, abs=0.01)
    flat = icimodel.project_chain((2, 2, 2), 256, 2, base,
                                  band_us_per_cell=0.0)
    assert (flat["projected_weak_scaling_eff"]
            > row["projected_weak_scaling_eff"])
    assert icimodel.project_chain((4, 2, 1), 256, 2, base)[
        "z_band_us_per_step"] == 0.0


def test_launch_floor_and_blocks():
    base = icimodel.anchor_us("cuda", 256) / 8
    free = icimodel.project(128, 1, base)
    floored = icimodel.project(128, 1, base, launch_us=1e4)
    assert (floored["projected_weak_scaling_eff"]
            < free["projected_weak_scaling_eff"])
    kw = dict(launch_us=icimodel.LAUNCH_US, hop_us=40.0)
    one = icimodel.projected_step_us("cuda", (2, 2, 2), 256, 1, **kw)
    eight = icimodel.projected_step_us("cuda", (2, 2, 2), 256, 1, blocks=8,
                                       **kw)
    assert eight == pytest.approx(8 * one, rel=1e-12)


@pytest.mark.parametrize("dims,local,depth,bands", [
    ((8, 1, 1), (32, 256, 256), 2, 2), ((8, 1, 1), (3, 256, 256), 2, 0),
    ((1, 8, 1), (256, 32, 256), 2, 2), ((4, 2, 1), (64, 128, 256), 2, 4),
    ((2, 2, 2), (128, 128, 128), 2, 4), ((1, 1, 8), (256, 256, 32), 2, 0),
    ((1, 8, 1), (256, 3, 256), 2, 0),
])
def test_split_band_launches_follow_the_runner(dims, local, depth, bands):
    assert icimodel.split_band_launches(dims, local, depth) == bands


def test_the_split_round_is_priced_by_its_band_launches():
    """Host-bound blocks: the split round's two band launches per round
    cost their host time, and on the card's table it hides nothing."""
    base = icimodel.anchor_us("cuda", 256)
    kw = dict(launch_us=icimodel.LAUNCH_US, hop_us=35.0, link_gbps=38.0)
    for dims in ((8, 1, 1), (1, 8, 1)):
        fused = icimodel.projected_step_us("cuda", dims, 256, 2,
                                           overlap=0.0, **kw)
        split = icimodel.projected_step_us("cuda", dims, 256, 2,
                                           overlap="auto", **kw)
        # Two band launches per two-step round over one launch.
        assert split - fused == pytest.approx(icimodel.LAUNCH_US, rel=1e-3)
    free = icimodel.project_1d(8, 256, 2, base, overlap="auto", hop_us=35.0)
    assert free["overlap"] == 0.0  # OVERLAP_EFFICIENCY is 0 on the card


def test_overlap_and_sstep_efficiencies_are_shares():
    assert 0.0 <= icimodel.OVERLAP_EFFICIENCY <= 1.0
    assert all(0.0 <= v <= 1.0
               for v in icimodel.HALO_DEPTH_EFFICIENCY.values())
    # A negative efficiency never makes the exchange grow with compute.
    assert icimodel.overlap_fraction(500.0, 10.0, efficiency=-3.0) == 0.0
    assert icimodel.overlap_fraction(500.0, 10.0, efficiency=0.5) == 1.0


def test_an_sstep_round_is_priced_at_its_chain_depth(monkeypatch):
    base = icimodel.anchor_us("cuda", 256)
    deep = icimodel.project_1d(8, 256, 2, base, halo_depth=2)
    assert deep["fuse_cost_ratio"] == icimodel.FUSE_COST_RATIO[4]
    assert icimodel.project_chain((4, 2, 1), 256, 2, base, halo_depth=2)[
        "fuse_cost_ratio"] == icimodel.FUSE_COST_RATIO[4]
    # No ratio at the round's depth: the base depth's, as the reference.
    assert icimodel.project_1d(8, 256, 5, base, halo_depth=2)[
        "fuse_cost_ratio"] == icimodel.FUSE_COST_RATIO[5]
    monkeypatch.setattr(icimodel, "SSTEP_AT_CHAIN_DEPTH", False)
    assert icimodel.project_1d(8, 256, 2, base, halo_depth=2)[
        "fuse_cost_ratio"] == icimodel.FUSE_COST_RATIO[2]


@pytest.mark.parametrize("L,placement,blocks", [
    (256, "shared", 8), (128, "shared", 8), (256, "peer", 4),
    (128, "peer", 4), (256, "peer", 8)])
def test_auto_decides_the_split_round_under_auto(L, placement, blocks):
    """Under ``comm_overlap = "auto"`` the chain row is the faster of its
    split and fused forms: on the card's table the fused one (the split
    round's bands cost launches and hide nothing), and the pick is
    projected faster than the (2,2,2)-style face schedule on the
    default mesh."""
    dims = _dims(blocks)
    kw = dict(platform="cuda", device_kind=H100, placement=placement,
              blocks=blocks, fuse=5, sweep_mesh=True)
    _, info = icimodel.select_kernel(dims, L, overlap_auto=True, **kw)
    chain = next(r for r in info["rows"] if r["schedule"] != "faces6")
    faces = info["rows"][0]
    assert chain["comm_overlap"] is False
    pick = info["rows"][info["pick"]]
    assert pick["projected_step_us"] <= faces["projected_step_us"]
    _, split = icimodel.select_kernel(dims, L, **kw)
    row = next(r for r in split["rows"] if r["schedule"] != "faces6")
    assert "comm_overlap" not in row
    assert (row["projected_weak_scaling_eff"]
            <= chain["projected_weak_scaling_eff"])


def test_a_model_too_wide_for_the_ledger_is_refused_on_the_card():
    """No schedule of the kernel fits six float64 fields: Auto raises on
    the card, naming the ledger, and never takes the plain path there."""
    from grayscott_jl_tpu_torch.models import SettingsError

    assert cuda_stencil.max_feasible_fuse(8, 6) == 0
    for dims in ((1, 1, 1), (2, 2, 2)):
        with pytest.raises(SettingsError, match="shared-memory ledger"):
            icimodel.select_kernel(dims, 64, platform="cuda",
                                   device_kind=H100, itemsize=8, n_fields=6)
    lang, _ = icimodel.select_kernel((1, 1, 1), 64, platform="cpu",
                                     itemsize=8, n_fields=6)
    assert lang == "plain"


def test_projected_step_us_single_block_and_unranked_depths():
    assert icimodel.projected_step_us("cuda", (1, 1, 1), 256, 1) == (
        pytest.approx(icimodel.anchor_us("cuda", 256)))
    assert icimodel.projected_step_us("cuda", (1, 1, 1), 256, 99) is None
    assert icimodel.projected_step_us("cuda", (8, 1, 1), 256, 99) is None
    plain = icimodel.projected_step_us("plain", (1, 1, 1), 128, 1)
    assert plain == pytest.approx(icimodel.anchor_us("plain", 128))


def test_placement_of():
    assert icimodel.placement_of(["cpu"] * 8) == "shared"
    assert icimodel.placement_of(["cuda:0"] * 8) == "shared"
    assert icimodel.placement_of(["cuda:0", "cuda:1"]) == "peer"
    assert icimodel.placement_of(["cuda:0"], 2, "gloo") == "gloo"
    assert icimodel.placement_of(["cuda:0"], 4, "nccl") == "nccl"


def test_every_coefficient_is_the_cards_own():
    """No literal of the reference's TPU tables carries over."""
    assert icimodel.FUSE_COST_RATIO[1] == 1.0
    assert all(v != ref.FUSE_COST_RATIO.get(k)
               for k, v in icimodel.FUSE_COST_RATIO.items())
    assert set(icimodel.MEASURED_US.values()).isdisjoint(
        ref.MEASURED_US.values())
    assert icimodel.OVERLAP_EFFICIENCY != ref.OVERLAP_EFFICIENCY
    assert icimodel.LAUNCH_US > 0 and icimodel.Z_BAND_US_PER_CELL > 0


# ------------------------------------------------- Simulation integration

def test_auto_settings_accepted_from_toml():
    s = parse_settings_toml('kernel_language = "Auto"\nL = 16\n')
    assert s.kernel_language == "Auto"


def test_simulation_auto_resolves_and_runs_single_device():
    sim = Simulation(_settings(), n_devices=1)
    assert sim.kernel_language == "plain"  # the CPU: off the card
    assert sim.kernel_selection is not None
    assert sim.kernel_selection["platform"] == "cpu"
    assert sim.kernel_selection["autotune"]["mode"] == "cached"
    sim.iterate(2)
    u, v = sim.get_fields()
    assert np.isfinite(u).all() and np.isfinite(v).all()


def test_simulation_explicit_language_has_no_selection():
    sim = Simulation(_settings(kernel_language="Plain", noise=0.0),
                     n_devices=1)
    assert sim.kernel_selection is None


def test_simulation_auto_matches_explicit_plain_sharded():
    auto = Simulation(_settings(), n_devices=8, seed=3)
    assert auto.kernel_language == "plain"
    auto.iterate(4)
    plain = Simulation(_settings(kernel_language="Plain"), n_devices=8,
                       seed=3)
    plain.iterate(4)
    np.testing.assert_array_equal(auto.get_fields()[0],
                                  plain.get_fields()[0])
    # and the reference's Auto, off the TPU, within the ground rules'
    # tolerance
    ref_auto = RefSimulation(RefSettings(
        L=16, Du=0.2, Dv=0.1, F=0.02, k=0.048, dt=1.0, noise=0.1,
        precision="Float32", backend="CPU", kernel_language="Auto"),
        n_devices=8, seed=3)
    assert ref_auto.kernel_language == "xla"
    ref_auto.iterate(4)
    np.testing.assert_allclose(auto.get_fields()[0],
                               np.asarray(ref_auto.get_fields()[0]),
                               rtol=0, atol=1e-6)


def test_the_probe_calibrates_through_the_model(monkeypatch):
    """``probes/fabric._calibrate`` inverts the model: step times the
    model projects for the (8,1,1) x-chain at depth 2 (split and fused,
    ``halo_depth`` 1 and 2) give back the efficiencies they were made
    with; a split round slower than the model prices at 0 fits below 0,
    and the coefficient is then 0."""
    from grayscott_jl_tpu_torch.probes import fabric

    monkeypatch.setattr(icimodel, "OVERLAP_EFFICIENCY", 0.3)
    monkeypatch.setattr(icimodel, "HALO_DEPTH_EFFICIENCY",
                        {"plain": 0.2, "cuda": 0.4})
    hop, launch, L = 30.0, 60.0, 256
    coef = {"anchors_us": {"cuda": {str(L): icimodel.anchor_us("cuda", L)},
                           "plain": {str(L): icimodel.anchor_us("plain",
                                                                L)}},
            "fuse_cost_ratio": {str(k): v for k, v in
                                icimodel.FUSE_COST_RATIO.items()},
            "launch_us": launch,
            "fabrics": {"shared": {"hop_us": hop, "link_gbps": 40.0,
                                   "links": 6}}}
    base = icimodel.anchor_us("cuda", L)
    kw = dict(hop_us=hop, launch_us=launch, link_gbps=40.0)

    def step(**more):
        row = icimodel.project_1d(8, L, 2, base, **kw, **more)
        return 8 * (base / 8) / row["projected_weak_scaling_eff"]

    def plain(**more):
        side = round((L // 8 * L * L) ** (1 / 3))
        b = icimodel.anchor_us("plain", L) / 8
        row = icimodel.project(side, 2, b, hop_us=hop, link_gbps=40.0,
                               **more)
        return 8 * b / row["projected_weak_scaling_eff"]

    got = fabric._calibrate(coef, L, step(overlap="auto"), step(),
                            step(halo_depth=2), 8, plain(),
                            plain(halo_depth=2))
    assert got["overlap_efficiency"] == pytest.approx(0.3, rel=1e-2)
    assert got["halo_depth_efficiency"]["cuda"] == pytest.approx(0.4,
                                                                 rel=2e-2)
    assert got["halo_depth_efficiency"]["plain"] == pytest.approx(
        0.2, rel=2e-2)
    assert icimodel.OVERLAP_EFFICIENCY == 0.3  # the tables restored
    slow = fabric._calibrate(coef, L, 3 * step(overlap="auto"), step(),
                             step(halo_depth=2), 8)
    assert slow["overlap_efficiency_fit"] < 0
    assert slow["overlap_efficiency"] == 0.0
