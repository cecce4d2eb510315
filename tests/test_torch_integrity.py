"""The data-integrity layer (grayscott_jl_tpu_torch/resilience/integrity.py)
against the reference's (grayscott_jl_tpu/resilience/integrity.py) on
the CPU: the device checksum equals the reference's device checksum (JAX
on the CPU) and the host checksum bit for bit, in float32, float64 and
bfloat16; replica paths and health order; failover past a corrupt
replica and the refusal of a sole corrupt one; the scrubber quarantines
the entries the reference's scrubber quarantines on a copy of the same
store, and both packages' readers hide them; the checkpoint writer
replicates and reads back; the snapshot's checksum catches the bitflip
hook."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grayscott_jl_tpu.io.bplite import BpReader as RefBpReader
from grayscott_jl_tpu.resilience import integrity as ref_integrity
from grayscott_jl_tpu.simulation import Simulation as RefSimulation
from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu_torch import Settings, Simulation
from grayscott_jl_tpu_torch.carry import blocks_from_reference
from grayscott_jl_tpu_torch.io.bplite import BpReader, BpWriter
from grayscott_jl_tpu_torch.io.checkpoint import (CheckpointWriter,
                                                  latest_durable_step,
                                                  load_checkpoint)
from grayscott_jl_tpu_torch.resilience import integrity
from grayscott_jl_tpu_torch.resilience.integrity import (CorruptionError,
                                                         corrupt_store_byte,
                                                         host_field_checksum,
                                                         read_quarantine,
                                                         scrub_store)

GS = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0)


@pytest.fixture
def x64():
    prior = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prior)


def write_store(path, steps=3, shape=(4, 4), seed=0):
    """A small single-writer Python-engine store with recorded CRCs."""
    rng = np.random.default_rng(seed)
    w = BpWriter(str(path))
    w.define_variable("step", np.int32)
    w.define_variable("u", np.float32, shape)
    w.define_variable("v", np.float32, shape)
    for i in range(steps):
        w.begin_step()
        w.put("step", np.int32(i))
        w.put("u", rng.random(shape, dtype=np.float32))
        w.put("v", rng.random(shape, dtype=np.float32))
        w.end_step()
    w.close()
    return str(path)


# ------------------------------------------------------------- knobs


def test_resolve_knobs_defaults_match_the_reference(monkeypatch):
    for k in ("GS_CKPT_REPLICAS", "GS_CKPT_VERIFY", "GS_SCRUB",
              "GS_SCRUB_EVERY"):
        monkeypatch.delenv(k, raising=False)
    assert integrity.resolve_config() == ref_integrity.resolve_config() == {
        "replicas": 1, "verify": "read", "scrub": False, "scrub_every": 1}
    monkeypatch.setenv("GS_CKPT_REPLICAS", "3")
    monkeypatch.setenv("GS_CKPT_VERIFY", "FULL")
    monkeypatch.setenv("GS_SCRUB", "yes")
    monkeypatch.setenv("GS_SCRUB_EVERY", "4")
    assert integrity.resolve_config() == ref_integrity.resolve_config() == {
        "replicas": 3, "verify": "full", "scrub": True, "scrub_every": 4}


@pytest.mark.parametrize("knob,bad", [
    ("GS_CKPT_REPLICAS", "0"), ("GS_CKPT_REPLICAS", "two"),
    ("GS_CKPT_VERIFY", "paranoid"), ("GS_SCRUB_EVERY", "0"),
])
def test_resolve_knobs_invalid_raise_as_the_reference(knob, bad,
                                                      monkeypatch):
    monkeypatch.setenv(knob, bad)
    with pytest.raises(ValueError) as ref:
        ref_integrity.resolve_config()
    with pytest.raises(ValueError) as ours:
        integrity.resolve_config()
    assert str(ours.value) == str(ref.value)


# -------------------------------------------- device/host checksums


def _seeded(dtype, shape=(6, 5, 4), seed=3):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * 3).astype(np.float32)
    a.flat[0] = np.nan
    a.flat[1] = -0.0
    a.flat[2] = np.inf
    return a.astype(dtype) if dtype != "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_device_checksum_equals_the_reference_and_the_host(dtype, x64):
    a = _seeded(np.float64 if dtype == "float64" else np.float32)
    if dtype == "bfloat16":
        # The same bits in both (the two round a NaN's payload apart).
        t = torch.from_numpy(a).to(torch.bfloat16)
        host = t.view(torch.int16).numpy().view(np.uint16)
        j = jax.lax.bitcast_convert_type(jnp.asarray(host), jnp.bfloat16)
    else:
        t = torch.from_numpy(a)
        j = jnp.asarray(a)
        host = a
    assert j.dtype.name == dtype
    ours = int(integrity.device_field_checksum(t)[0])
    ref = int(np.asarray(jax.jit(ref_integrity.device_field_checksum)(j)[0]))
    assert ours == ref == host_field_checksum(host) == (
        ref_integrity.host_field_checksum(host))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_checksum_of_blocks_adds_up_mod_2_32(dtype):
    """The mesh's rule: the blocks' sums added mod 2^32 are the whole
    field's."""
    t = torch.from_numpy(_seeded(np.float32, (8, 6, 4))).to(dtype)
    whole = int(integrity.device_field_checksum(t)[0])
    parts = [t[:3], t[3:5], t[5:]]
    total = sum(int(integrity.device_field_checksum(p)[0])
                for p in parts) % (1 << 32)
    assert total == whole


def test_apply_bitflip_matches_the_reference():
    a = _seeded(np.float32, (3, 3, 3))
    a.flat[:3] = 1.0
    ours = integrity.apply_bitflip(torch.from_numpy(a), (1, 2, 0)).numpy()
    ref = np.asarray(ref_integrity.apply_bitflip(jnp.asarray(a), (1, 2, 0)))
    assert ours.view(np.uint32).tolist() == ref.view(np.uint32).tolist()
    diff = a.view(np.uint32) != ours.view(np.uint32)
    assert diff.sum() == 1 and diff[1, 2, 0]
    high = integrity.apply_bitflip(torch.from_numpy(a), (0, 0, 1), bit=31)
    assert high.numpy()[0, 0, 1] == -a[0, 0, 1]
    assert host_field_checksum(a) != host_field_checksum(ours)


def test_snapshot_checksum_equals_the_references_on_the_same_state():
    """The port's snapshot of the reference's state carries the same
    device checksums as the reference's own snapshot."""
    s = dict(L=16, noise=0.1, precision="Float32", backend="CPU",
             kernel_language="Plain", **GS)
    ref = RefSimulation(RefSettings(**s), n_devices=1, seed=3)
    ref.iterate(4)
    for n_devices in (None, 8):
        port = Simulation(Settings(**s), seed=3, n_devices=n_devices)
        port.blocks = blocks_from_reference(ref.get_fields(), port)
        snap = port.snapshot_async(checksum=True, health=True)
        want = ref.snapshot_async(checksum=True).checksum_report()
        assert snap.checksum_report() == want
        assert snap.health_report().finite
        assert len(snap.blocks()) == port.domain.n_blocks


@pytest.mark.parametrize("n_devices", [None, 8])
def test_snapshot_checksum_detects_the_bitflip_hook(n_devices):
    """A clean snapshot verifies and serves blocks; the bitflip hook's
    copy raises CorruptionError naming the field, and the live fields
    stay as they were."""
    sim = Simulation(Settings(L=8, noise=0.1, backend="CPU",
                              precision="Float32", **GS),
                     n_devices=n_devices)
    sim.iterate(2)
    before = [f.clone() for f in sim.blocks[0]]
    assert len(sim.snapshot_async(checksum=True).blocks()) >= 1
    for field in (True, "v"):
        bad = sim.snapshot_async(checksum=True, bitflip=field)
        with pytest.raises(CorruptionError) as e:
            bad.blocks()
        assert e.value.var == ("u" if field is True else "v")
        assert "checksum mismatch" in str(e.value)
    assert all(torch.equal(a, b) for a, b in zip(before, sim.blocks[0]))
    # Without the checksum the flip goes through unseen.
    blocks = sim.snapshot_async(bitflip=True).blocks()
    assert not np.array_equal(blocks[0][2], sim.snapshot()[0][2])


# ------------------------------------------------ replicas / failover


def test_replica_paths_and_health_order_match_the_reference(tmp_path):
    primary = write_store(tmp_path / "c.bp", steps=1)
    r1 = write_store(tmp_path / "c.bp.r1", steps=3)
    write_store(tmp_path / "c.bp.rx", steps=5)  # not a replica name
    assert integrity.replica_paths(primary, 3) == (
        ref_integrity.replica_paths(primary, 3)) == [
        primary, primary + ".r1", primary + ".r2"]
    assert integrity.restore_candidates(primary) == (
        ref_integrity.restore_candidates(primary)) == [r1, primary]
    assert integrity.latest_durable_step_replicated(primary) == 2
    assert integrity.latest_durable_step_replicated(primary, 1) == 1


def _attempt(tried):
    def attempt(path):
        tried.append(path)
        with BpReader(path, verify="read") as r:
            return [np.asarray(r.get("u", step=i)) for i in range(2)]
    return attempt


def test_failover_skips_a_corrupt_replica(tmp_path):
    primary = write_store(tmp_path / "c.bp", steps=2)
    write_store(tmp_path / "c.bp.r1", steps=2)
    corrupt_store_byte(primary)
    tried = []
    journal = integrity.IntegrityLog()
    out = integrity.restore_with_failover(primary, _attempt(tried),
                                          journal=journal)
    assert len(out) == 2
    assert tried == [primary, primary + ".r1"]
    (event,) = journal.events
    assert event["event"] == "replica_failover"
    assert "CRC mismatch" in event["detail"]


def test_a_sole_corrupt_replica_raises(tmp_path):
    primary = write_store(tmp_path / "c.bp", steps=2)
    corrupt_store_byte(primary)
    with pytest.raises(CorruptionError, match="CRC mismatch"):
        integrity.restore_with_failover(primary, _attempt([]))


def test_failover_never_retries_config_errors(tmp_path):
    primary = write_store(tmp_path / "c.bp", steps=2)
    write_store(tmp_path / "c.bp.r1", steps=2)
    calls = []

    def attempt(path):
        calls.append(path)
        raise ValueError("Checkpoint store holds model 'heat' ...")

    with pytest.raises(ValueError):
        integrity.restore_with_failover(primary, attempt)
    assert calls == [primary]
    for ours, ref in [(CorruptionError("x"),
                       ref_integrity.CorruptionError("x"))] + [
            (e, e) for e in (FileNotFoundError("x"),
                             ValueError("Checkpoint store s contains no steps"),
                             ValueError("shape mismatch"),
                             RuntimeError("Unreadable BP-lite metadata"),
                             KeyError("x"))]:
        assert integrity.recoverable_restore_error(ours) == (
            ref_integrity.recoverable_restore_error(ref))


# --------------------------------------------------- scrub/quarantine


def test_scrub_quarantines_what_the_reference_does(tmp_path):
    """On two copies of one corrupted store, the port's scrubber and the
    reference's quarantine the same entries, and both packages' readers
    then hide them."""
    store = write_store(tmp_path / "s.bp", steps=4)
    info = corrupt_store_byte(store)
    assert info["step_index"] == 3 and info["var"] == "u"
    copy = str(tmp_path / "copy.bp")
    shutil.copytree(store, copy)
    journal = integrity.IntegrityLog()
    ours = scrub_store(store, journal=journal)
    ref = ref_integrity.scrub_store(copy)
    assert ours["corrupt"] == ref["corrupt"] == [3]
    assert (ours["steps_audited"], ours["blocks_checked"]) == (
        ref["steps_audited"], ref["blocks_checked"])
    assert read_quarantine(store) == ref_integrity.read_quarantine(copy) == {
        3}
    assert (open(os.path.join(store, "quarantine.json"), "rb").read()
            == open(os.path.join(copy, "quarantine.json"), "rb").read())
    assert [e["event"] for e in journal.events] == ["corruption", "scrub"]
    for path in (store, copy):
        for reader in (BpReader(path), RefBpReader(path)):
            assert reader.num_steps() == 3
            assert [int(reader.get("step", step=i)) for i in range(3)] == [
                0, 1, 2]
            reader.close()
    # A second audit finds nothing new; a clean store nothing at all.
    assert scrub_store(store)["corrupt"] == []
    clean = write_store(tmp_path / "clean.bp", steps=2)
    assert scrub_store(clean)["corrupt"] == []
    assert read_quarantine(clean) == frozenset()


def test_latest_durable_step_rolls_past_a_quarantined_entry(tmp_path):
    store = write_store(tmp_path / "s.bp", steps=3)
    assert latest_durable_step(store) == 2
    corrupt_store_byte(store)
    scrub_store(store)
    assert latest_durable_step(store) == 1
    assert latest_durable_step(str(tmp_path / "none.bp")) is None


def test_scrubber_audits_every_replica_at_its_cadence(tmp_path):
    class S:
        checkpoint_output = str(tmp_path / "c.bp")

    write_store(tmp_path / "c.bp", steps=2)
    write_store(tmp_path / "c.bp.r1", steps=2)
    corrupt_store_byte(str(tmp_path / "c.bp.r1"))
    sc = integrity.Scrubber(S(), every=2)
    reports = sc.maybe_scrub(10)
    assert [r["path"] for r in reports] == [
        str(tmp_path / "c.bp"), str(tmp_path / "c.bp.r1")]
    assert sc.maybe_scrub(20) is None
    assert sc.describe() == {"every": 2, "audits": 2, "corrupt_found": 1}


def test_verify_store_and_replicate_store(tmp_path):
    store = write_store(tmp_path / "s.bp", steps=2)
    assert integrity.verify_store(store)["corrupt"] == []
    assert integrity.replicate_store(store, 3) == [store + ".r1",
                                                   store + ".r2"]
    assert integrity.replicate_store(store, 3) == []
    corrupt_store_byte(store)
    with pytest.raises(CorruptionError, match="CRC mismatch"):
        integrity.verify_store(store)
    assert read_quarantine(store) == frozenset()  # never quarantines
    with pytest.raises(CorruptionError, match="no readable metadata"):
        integrity.verify_store(str(tmp_path / "none.bp"))


# ------------------------------------------------- checkpoint writer


@pytest.mark.parametrize("engine", ["native", "python"])
def test_checkpoint_writer_replicates_and_reads_back(tmp_path, monkeypatch,
                                                     engine):
    monkeypatch.setenv("GS_CKPT_REPLICAS", "2")
    monkeypatch.setenv("GS_CKPT_VERIFY", "full")
    monkeypatch.setenv("GS_TPU_NATIVE_IO", "1" if engine == "native" else "0")
    s = Settings(L=4, steps=1, checkpoint=True,
                 checkpoint_output=str(tmp_path / "c.bp"))
    w = CheckpointWriter(s, np.float32)
    assert w.writer.engine == engine
    block = ((0, 0, 0), (4, 4, 4), np.ones((4, 4, 4), np.float32),
             np.zeros((4, 4, 4), np.float32))
    w.save(7, [block], checksums={"u": 123, "v": 456})
    w.close()
    for path in (str(tmp_path / "c.bp"), str(tmp_path / "c.bp.r1")):
        for reader in (BpReader(path, verify="read"), RefBpReader(path)):
            assert int(reader.get("step", step=0)) == 7
            np.testing.assert_array_equal(reader.get("u", step=0),
                                          np.ones((4, 4, 4), np.float32))
            reader.close()
        side = json.load(open(os.path.join(path, "integrity.json")))
        assert side["device"] == [{"u": 123, "v": 456}]
    for name in ("md.json", "data.0", "integrity.json"):
        assert (open(os.path.join(str(tmp_path / "c.bp"), name), "rb").read()
                == open(os.path.join(str(tmp_path / "c.bp.r1"), name),
                        "rb").read())


def test_checkpoint_readback_catches_a_lying_write(tmp_path, monkeypatch):
    """Under ``full`` the save reads its step back: bytes that landed
    other than they were checksummed raise before the save returns."""
    from grayscott_jl_tpu_torch.io import bplite

    monkeypatch.setenv("GS_CKPT_VERIFY", "full")
    monkeypatch.setenv("GS_TPU_NATIVE_IO", "0")
    real = bplite.IntegrityMeta.record_block

    def lying(self, data_file, offset, data):
        real(self, data_file, offset, bytes(data)[:-1] + b"\x7f")

    monkeypatch.setattr(bplite.IntegrityMeta, "record_block", lying)
    w = CheckpointWriter(Settings(L=4, checkpoint_output=str(
        tmp_path / "c.bp")), np.float32)
    block = ((0, 0, 0), (4, 4, 4), np.ones((4, 4, 4), np.float32),
             np.zeros((4, 4, 4), np.float32))
    with pytest.raises(CorruptionError, match="CRC mismatch"):
        w.save(7, [block])
    w.close()


def test_load_checkpoint_fails_over_to_a_replica(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_CKPT_REPLICAS", "2")
    s = Settings(L=4, checkpoint_output=str(tmp_path / "c.bp"))
    w = CheckpointWriter(s, np.float32)
    rng = np.random.default_rng(0)
    u, v = (rng.random((4, 4, 4), dtype=np.float32) for _ in range(2))
    w.save(5, [((0, 0, 0), (4, 4, 4), u, v)])
    w.close()
    corrupt_store_byte(str(tmp_path / "c.bp"))
    journal = integrity.IntegrityLog()
    got_u, got_v, step = load_checkpoint(str(tmp_path / "c.bp"), s,
                                         journal=journal)
    assert step == 5
    np.testing.assert_array_equal(got_u, u)
    np.testing.assert_array_equal(got_v, v)
    assert journal.events[0]["next"] == str(tmp_path / "c.bp.r1")
    shutil.rmtree(tmp_path / "c.bp.r1")
    with pytest.raises(CorruptionError):
        load_checkpoint(str(tmp_path / "c.bp"), s)
