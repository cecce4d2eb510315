"""Compute-path SDC screening and device quarantine
(grayscott_jl_tpu_torch/resilience/sdc.py) against the reference's
(grayscott_jl_tpu/resilience/sdc.py), the counterparts of
tests/unit/test_sdc.py, on the CPU:

* the knobs resolve as the reference's, and ``bisect_failing`` and
  ``feasible_dims`` give the same answers;
* quarantine leaves a device out of the mesh's devices and journals it;
* on a (2,2,2) mesh the same global cell flipped in both packages is
  caught at the same step, and the reference's device id (8 virtual CPU
  devices, one block each) is the port's block rank (8 blocks on the
  one CPU device);
* screening leaves the trajectory bitwise as it was, the write path's
  ``bitflip`` stays invisible to it, and the replay leaves the live
  state and the launch counters alone;
* the supervisor's ladder: resume from the verified step, quarantine on
  a repeat, give up when no device is left."""

import os

import numpy as np
import pytest

import jax

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.resilience import sdc as ref_sdc
from grayscott_jl_tpu.simulation import Simulation as RefSimulation
from grayscott_jl_tpu_torch import Settings, Simulation
from grayscott_jl_tpu_torch.ops import cuda_stencil
from grayscott_jl_tpu_torch.resilience import sdc
from grayscott_jl_tpu_torch.resilience.sdc import (SDCError, Screener,
                                                   bisect_failing,
                                                   quarantine_device,
                                                   resolve_blocklist,
                                                   resolve_sdc)

GS_PARAMS = dict(Du=0.2, Dv=0.1, F=0.02, k=0.048, dt=1.0)

requires8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual CPU devices")

_SDC_ENV_VARS = ("GS_SDC_CHECK", "GS_SDC_EVERY", "GS_DEVICE_BLOCKLIST",
                 "GS_FAULT_DEVICE", "GS_FAULTS", "GS_SUPERVISE")


@pytest.fixture(autouse=True)
def _clean_sdc_env():
    """``quarantine_device`` writes ``GS_DEVICE_BLOCKLIST`` into the
    environment itself; save, clear and restore the variables around
    every test so that no quarantine leaks into another."""
    saved = {v: os.environ.pop(v, None) for v in _SDC_ENV_VARS}
    yield
    for v, val in saved.items():
        if val is None:
            os.environ.pop(v, None)
        else:
            os.environ[v] = val


def _settings(model="grayscott", L=8, noise=0.1, **kw):
    if model == "grayscott":
        kw = {**GS_PARAMS, **kw}
    else:
        kw.setdefault("dt", 0.05)
    s = Settings(L=L, noise=noise, precision="Float32", backend="CPU", **kw)
    s.model = model
    return s


class _Journal:
    def __init__(self):
        self.events = []

    def record(self, **event):
        self.events.append(event)
        return event


@pytest.mark.parametrize("check,every,key_check,key_every", [
    (None, None, "", 0), ("spot", "3", "", 0), ("SHADOW", None, "", 0),
    (None, None, "spot", 4), ("off", "2", "shadow", 0),
])
def test_resolve_sdc_matches_the_reference(monkeypatch, check, every,
                                           key_check, key_every):
    for var, val in (("GS_SDC_CHECK", check), ("GS_SDC_EVERY", every)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    s, r = Settings(), RefSettings()
    for x in (s, r):
        x.sdc_check, x.sdc_every = key_check, key_every
    assert resolve_sdc(s) == ref_sdc.resolve_sdc(r)


@pytest.mark.parametrize("check,every,match", [
    ("sideways", None, "GS_SDC_CHECK"), ("spot", "0", "GS_SDC_EVERY")])
def test_bad_sdc_knobs_raise_as_the_reference(monkeypatch, check, every,
                                              match):
    monkeypatch.setenv("GS_SDC_CHECK", check)
    if every is not None:
        monkeypatch.setenv("GS_SDC_EVERY", every)
    with pytest.raises(ValueError, match=match) as a:
        resolve_sdc(Settings())
    with pytest.raises(ValueError) as b:
        ref_sdc.resolve_sdc(RefSettings())
    assert str(a.value) == str(b.value)


def test_resolve_blocklist_and_fault_device(monkeypatch):
    assert resolve_blocklist() == frozenset()
    monkeypatch.setenv("GS_DEVICE_BLOCKLIST", " cuda:1, ,cpu ")
    assert resolve_blocklist() == {"cuda:1", "cpu"}
    assert sdc.resolve_fault_device() is None
    monkeypatch.setenv("GS_FAULT_DEVICE", "cuda:0")
    assert sdc.resolve_fault_device() == ref_sdc.resolve_fault_device()


def test_quarantine_device_extends_env_and_journals():
    j = _Journal()
    quarantine_device("cuda:3", journal=j, step=12, reason="why")
    quarantine_device("cuda:3", journal=j, step=13, reason="again")
    quarantine_device("cpu", journal=j)
    assert os.environ["GS_DEVICE_BLOCKLIST"] == "cuda:3,cpu"
    assert [(e["event"], e["kind"], e["device"]) for e in j.events] == [
        ("device_quarantined", "sdc", "cuda:3"),
        ("device_quarantined", "sdc", "cuda:3"),
        ("device_quarantined", "sdc", "cpu")]
    assert j.events[0]["step"] == 12 and j.events[0]["reason"] == "why"


def test_usable_devices_and_select_exclude_quarantined(monkeypatch):
    import torch

    from grayscott_jl_tpu_torch.parallel.mesh import select_devices

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    quarantine_device("cuda:2")
    assert [str(d) for d in sdc.usable_devices("cuda")] == [
        "cuda:0", "cuda:1", "cuda:3"]
    assert [str(d) for d in select_devices("cuda")] == [
        "cuda:0", "cuda:1", "cuda:3"]
    with pytest.raises(ValueError, match="quarantined"):
        select_devices("cuda", 4)
    assert sdc.usable_devices("cpu") == [torch.device("cpu")]
    quarantine_device("cpu")
    assert sdc.usable_devices("cpu") == []
    with pytest.raises(Exception, match="quarantined"):
        Simulation(_settings())


@pytest.mark.parametrize("n,L", [(8, 32), (7, 32), (5, 16), (3, 9),
                                 (1, 4), (6, 2)])
def test_feasible_dims_matches_the_reference(n, L):
    assert sdc.feasible_dims(n, L) == ref_sdc.feasible_dims(n, L)


@pytest.mark.parametrize("guilty", [(), (3,), (0, 7), (1, 2, 5), (4,)])
def test_bisect_failing_matches_the_reference(guilty):
    items = tuple(range(8))
    probes = {"port": [], "ref": []}

    def healthy(which):
        def fn(subset):
            probes[which].append(subset)
            return not set(subset) & set(guilty)
        return fn

    got = bisect_failing(items, healthy("port"))
    want = ref_sdc.bisect_failing(items, healthy("ref"))
    assert got == want == sorted(guilty)
    assert probes["port"] == probes["ref"]


@requires8
def test_spot_detects_and_attributes_like_the_reference():
    """The same global cell flipped before the round in both packages:
    both screens verify step 4, catch the flip at step 8, and the
    reference's device ``cpu:7`` (one block per virtual device) is the
    port's block 7 (eight blocks on the one CPU device)."""
    ref = RefSimulation(RefSettings(L=16, noise=0.1, precision="Float32",
                                    backend="CPU", **GS_PARAMS),
                        n_devices=8, seed=1)
    port = Simulation(_settings(L=16), n_devices=8, seed=1)
    assert tuple(port.domain.dims) == tuple(ref.domain.dims) == (2, 2, 2)
    rsc, psc = ref_sdc.Screener(ref, mode="spot"), Screener(port, mode="spot")
    for sc, sim in ((rsc, ref), (psc, port)):
        sc.rearm(0)
        sim.iterate(4)
        assert sc.check(4) and sc.verified_step == 4
    before = [np.asarray(f) for f in ref.get_fields()]
    assert ref.poison_sdc(device="cpu:7") == "cpu:7"
    ref_diff = np.argwhere(np.asarray(ref.get_fields()[0]) != before[0])
    before = port.get_fields()
    assert port.poison_sdc() == "cpu"
    port_diff = np.argwhere(port.get_fields()[0] != before[0])
    assert port_diff.tolist() == ref_diff.tolist() and len(port_diff) == 1
    errors = []
    for sc, sim, exc in ((rsc, ref, ref_sdc.SDCError), (psc, port,
                                                         SDCError)):
        sim.iterate(4)
        with pytest.raises(exc) as e:
            sc.check(8)
        errors.append(e.value)
    r, p = errors
    assert (r.step, r.verified_step) == (p.step, p.verified_step) == (8, 4)
    assert r.device == "cpu:7"
    assert p.device == "cpu" and p.block == int(r.device.split(":")[1])
    assert "block=7" in str(p) and p.mode == "spot"
    assert psc.mismatches == 1 and psc.describe()["checks"] == 2


def test_shadow_degrades_on_one_device():
    """Every block on the one CPU device: nothing to rotate, so shadow
    replays in place and says so, as the reference does on one device;
    it still catches a flip and names the block."""
    sim = Simulation(_settings(L=16), n_devices=8, seed=1)
    sc = Screener(sim, mode="shadow")
    assert sc.shadow_degraded and sc.describe()["shadow_degraded"]
    sc.rearm(0)
    sim.iterate(4)
    assert sc.check(4)
    sim.poison_sdc(device="cpu")
    sim.iterate(4)
    with pytest.raises(SDCError) as e:
        sc.check(8)
    assert (e.value.device, e.value.block, e.value.mode) == (
        "cpu", 7, "shadow")


@pytest.mark.parametrize("devices,want", [
    (["cuda:0"] * 8, None),
    (["cuda:0", "cuda:0", "cuda:1", "cuda:1", "cuda:2", "cuda:2", "cuda:3",
      "cuda:3"], ["cuda:1", "cuda:1", "cuda:2", "cuda:2", "cuda:3", "cuda:3",
                  "cuda:0", "cuda:0"]),
    (["cuda:0", "cuda:1"] * 4, ["cuda:1", "cuda:0"] * 4),
    (["cuda:0"] * 5 + ["cuda:1"] * 3, None),
])
def test_shadow_rotation_moves_every_block(devices, want):
    """Shadow replays on the smallest rotation of the block-to-device
    list that puts every block on another device (the reference rotates
    its one-shard-per-device list by one); with none, it degrades."""
    import torch

    class _Mesh:
        first_rank = 0

    class _Sim:
        mesh = _Mesh()

    _Sim.mesh.devices = [torch.device(d) for d in devices]
    sc = Screener(_Sim(), mode="shadow")
    assert sc.shadow_degraded == (want is None)
    got = sc._shadow
    assert (None if got is None else [str(d) for d in got]) == want


def test_every_n_cadence_rearms_every_boundary():
    """``every=2``: the anchor moves every boundary, a replay runs every
    second one and covers the steps since the last boundary."""
    sim = Simulation(_settings(L=8), seed=0)
    sc = Screener(sim, mode="spot", every=2)
    sc.rearm(0)
    sim.iterate(2)
    assert not sc.check(2)
    sc.rearm(2)
    sim.iterate(2)
    assert sc.check(4) and sc.verified_step == 4 and sc.checks == 1


def test_write_path_bitflip_is_invisible_to_screening():
    """``bitflip`` corrupts the snapshot's copy, not the live fields:
    the device checksum catches it, the screen must not."""
    from grayscott_jl_tpu_torch.resilience.integrity import CorruptionError

    sim = Simulation(_settings(L=16), n_devices=8, seed=1)
    sc = Screener(sim, mode="spot")
    sc.rearm(0)
    sim.iterate(4)
    snap = sim.snapshot_async(exact=True, bitflip=True, checksum=True)
    with pytest.raises(CorruptionError, match="checksum mismatch"):
        snap.blocks()
    assert sc.check(4)


@pytest.mark.parametrize("model,lang,posture,halo,n", [
    ("grayscott", "Plain", "", 1, 2),
    ("grayscott", "Pallas", "bf16_f32acc", 2, 8),
    ("brusselator", "Pallas", "", 1, 8),
    ("fhn", "Plain", "bf16_f32acc", 2, 2),
    ("heat", "Pallas", "", 2, 1),
    ("heat", "Plain", "bf16_f32acc", 1, 8),
])
def test_screening_is_bitwise_transparent(model, lang, posture, halo, n):
    """Screened equals unscreened bitwise, every check verifies, and the
    replay leaves the launch counters, the step and the exchange count
    as they were (the reference's matrix, tier-1 slice)."""
    kw = dict(kernel_language=lang, compute_precision=posture,
              halo_depth=halo)
    plain = Simulation(_settings(model=model, **kw), n_devices=n, seed=2)
    screened = Simulation(_settings(model=model, **kw), n_devices=n, seed=2)
    sc = Screener(screened, mode="shadow" if n > 1 else "spot")
    sc.rearm(0)
    for boundary in (2, 4):
        plain.iterate(2)
        screened.iterate(2)
        counts = (cuda_stencil.LAUNCHES, dict(cuda_stencil.MODE_LAUNCHES),
                  screened.step, screened.exchange_rounds)
        assert sc.check(boundary)
        assert counts == (cuda_stencil.LAUNCHES,
                          dict(cuda_stencil.MODE_LAUNCHES), screened.step,
                          screened.exchange_rounds)
        sc.rearm(boundary)
    assert sc.verified_step == 4
    for a, b in zip(plain.get_fields(), screened.get_fields()):
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_replay_reproduces_the_live_run_without_touching_it():
    sim = Simulation(_settings(L=16), n_devices=8, seed=4)
    anchor = sim.retain_fields()
    live = [tuple(f) for f in sim.blocks]
    replay = sim.replay_fields(anchor, 0, 3)
    assert sim.step == 0 and all(
        a is b for x, y in zip(live, sim.blocks) for a, b in zip(x, y))
    sim.iterate(3)
    assert sim.block_checksums() == sim.block_checksums(replay)
    for x, y in zip(sim.blocks, replay):
        for a, b in zip(x, y):
            assert np.array_equal(a.numpy(), b.numpy())


def test_replay_launches_are_counted_apart_from_the_run(monkeypatch):
    """A launch inside ``replaying()`` counts in ``REPLAY_LAUNCHES``
    only, and the screen reports its replays' share in ``describe()``;
    outside, every count of the run moves as before."""
    cuda_stencil.reset_launches()
    try:
        with cuda_stencil.replaying():
            cuda_stencil.count_launch("xchain", "tma", entry="f32",
                                      model="grayscott", band=True)
        assert cuda_stencil.REPLAY_LAUNCHES == 1
        assert (cuda_stencil.LAUNCHES, cuda_stencil.BAND_LAUNCHES) == (0, 0)
        assert not any(cuda_stencil.MODE_LAUNCHES.values())
        assert not any(cuda_stencil.DTYPE_LAUNCHES.values())
        assert not cuda_stencil.MODEL_LAUNCHES
        cuda_stencil.count_launch("xchain", "tma", entry="f32",
                                  model="grayscott", band=True)
        assert (cuda_stencil.LAUNCHES, cuda_stencil.BAND_LAUNCHES,
                cuda_stencil.MODE_LAUNCHES["xchain"],
                cuda_stencil.LOAD_PATH_LAUNCHES["tma"],
                cuda_stencil.DTYPE_LAUNCHES["f32"],
                cuda_stencil.MODEL_LAUNCHES["grayscott"],
                cuda_stencil.REPLAY_LAUNCHES) == (1, 1, 1, 1, 1, 1, 1)

        sim = Simulation(_settings(L=16), seed=4)
        replay_fields = sim.replay_fields

        def counting(*a, **kw):
            # A stand-in for the card, where each replayed round is a
            # launch; the CPU's plain path launches nothing.
            with cuda_stencil.replaying():
                cuda_stencil.count_launch("chain", "tma")
            return replay_fields(*a, **kw)

        monkeypatch.setattr(sim, "replay_fields", counting)
        sc = Screener(sim)
        sc.rearm(0)
        for step in (2, 4):
            sim.iterate(2)
            assert sc.check(step)
            sc.rearm(step)
        assert sc.describe()["replay_launches"] == 2
        assert cuda_stencil.LAUNCHES == 1
    finally:
        cuda_stencil.reset_launches()


# ---------------------------------------------------- supervisor ladder


class _FakeCkpt:
    """Serves a fixed durable step and records the caps it was asked
    for."""

    def __init__(self, durable):
        self.durable = durable
        self.caps = []

    def __call__(self, settings, max_step=None):
        self.caps.append(max_step)
        if self.durable is None or (max_step is not None
                                    and self.durable > max_step):
            return None
        return self.durable


def _supervise_with(monkeypatch, failures, durable=4):
    """``supervise`` over a stand-in ``run_once`` that raises
    ``failures`` in order, then succeeds."""
    from grayscott_jl_tpu_torch import driver as driver_mod
    from grayscott_jl_tpu_torch.resilience import supervisor as sup

    monkeypatch.setenv("GS_RESTART_BACKOFF_S", "0")
    seq = list(failures)
    calls = []

    def fake_run_once(settings, **kw):
        calls.append(dict(restart=settings.restart,
                          restart_step=settings.restart_step))
        if seq:
            raise seq.pop(0)
        return "done"

    monkeypatch.setattr(driver_mod, "run_once", fake_run_once)
    ckpt = _FakeCkpt(durable)
    monkeypatch.setattr(sup, "latest_durable_checkpoint", ckpt)
    events = []
    monkeypatch.setattr(sup.FaultJournal, "record",
                        lambda self, **e: events.append(e) or e)
    settings = _settings(L=8)
    try:
        outcome = sup.supervise(settings)
    except BaseException as exc:  # noqa: BLE001 — the tests read it
        outcome = exc
    return events, ckpt, settings, calls, outcome


def test_sdc_ladder_first_mismatch_resumes_from_verified(monkeypatch):
    events, ckpt, settings, calls, out = _supervise_with(
        monkeypatch, [SDCError("boom", step=8, verified_step=4,
                               device="cuda:5", block=3)])
    assert out == "done" and ckpt.caps == [4]
    assert settings.restart and settings.restart_step == 4
    rec = [e for e in events if e["event"] == "recovery"]
    assert rec[0]["kind"] == "sdc"
    assert "resumed_from_checkpoint_step_4" in rec[0]["action"]
    assert not [e for e in events if e["event"] == "device_quarantined"]
    assert "cuda:5" not in os.environ.get("GS_DEVICE_BLOCKLIST", "")


def test_sdc_ladder_same_device_repeat_quarantines(monkeypatch):
    events, ckpt, settings, calls, out = _supervise_with(
        monkeypatch, [SDCError("a", step=8, verified_step=4, device="cuda:5"),
                      SDCError("b", step=12, verified_step=8,
                               device="cuda:5")])
    assert out == "done"
    q = [e for e in events if e["event"] == "device_quarantined"]
    assert len(q) == 1 and q[0]["device"] == "cuda:5"
    assert "cuda:5" in resolve_blocklist()
    rec = [e for e in events if e["event"] == "recovery"]
    assert "quarantined_cuda:5" in rec[1]["action"]
    assert ckpt.caps == [4, 8]


def test_sdc_ladder_unverified_failure_restarts_from_scratch(monkeypatch):
    events, ckpt, settings, calls, out = _supervise_with(
        monkeypatch, [SDCError("x", step=2, verified_step=None,
                               device="cpu")])
    assert out == "done" and ckpt.caps == []
    rec = [e for e in events if e["event"] == "recovery"]
    assert "no_verified_boundary" in rec[0]["action"]
    assert "restarted_from_scratch" in rec[0]["action"]


def test_sdc_ladder_quarantine_exhaustion_gives_up(monkeypatch):
    events, ckpt, settings, calls, out = _supervise_with(
        monkeypatch, [SDCError("a", step=8, verified_step=4, device="cpu"),
                      SDCError("b", step=8, verified_step=4, device="cpu")])
    assert isinstance(out, SDCError)
    gave = [e for e in events if e["event"] == "gave_up"]
    assert gave and gave[0]["kind"] == "sdc"
    assert "every device quarantined" in gave[0]["reason"]
    assert len(calls) == 2


def test_classify_sdc_is_restartable():
    from grayscott_jl_tpu.resilience.supervisor import (
        classify_failure as ref_classify)
    from grayscott_jl_tpu_torch.resilience.supervisor import classify_failure

    e = SDCError("boom", step=8, verified_step=4, device="cuda:5", block=2)
    r = ref_sdc.SDCError("boom", step=8, verified_step=4, device="cpu:5")
    assert classify_failure(e) == ref_classify(r) == "sdc"
    assert str(e) == ("boom; step=8; device=cuda:5; block=2; "
                      "verified_step=4")
