"""Elastic resharding, the checkpoint path (grayscott_jl_tpu_torch/reshard/,
io/checkpoint.py), held against live runs of the reference package on
the 8 virtual CPU devices of tests/conftest.py.

* F8: a port checkpoint store records the reference's layout attributes
  (``LAYOUT_ATTRS``), equal to the reference's store's for the same run,
  and the reference's ``read_layout`` reads them.
* F9: ``reshard = "off"`` judges the recorded layout (mesh dims and
  process count), as the reference does: a one-process (2,2,2) store
  restored by two processes on (2,2,2) is refused, and a store without a
  layout record restores on another mesh.
* The plan (``shard_boxes``, ``overlapping_old_shards``, ``plan_restore``,
  ``member_map``, ``layout_attrs``, ``read_layout``) equals the
  reference's exactly over a matrix of layouts.
* Restores 1 -> 8, 8 -> 4 and 8 -> 1 blocks: bitwise equal to the port's
  unmoved run, within atol 1e-5 of the reference's (the ground rules'
  tolerance, tests/test_torch_sharded.py); the ``reshard`` event,
  journal record and ``RunStats.config["reshard"]`` equal to the
  reference's but for their times.
* ``agree_mesh`` as the reference's ``test_mesh_agreement_*``.

L <= 32, float32, a few steps."""

import dataclasses
import json
import threading

import numpy as np
import pytest

from grayscott_jl_tpu import driver as ref_driver
from grayscott_jl_tpu.io import checkpoint as ref_checkpoint
from grayscott_jl_tpu.obs import events as ref_events
from grayscott_jl_tpu.reshard import plan as ref_plan
from grayscott_jl_tpu.resilience.rendezvous import \
    FileRendezvous as RefFileRendezvous
from grayscott_jl_tpu.simulation import Simulation as RefSimulation
from grayscott_jl_tpu_torch import driver, launch
from grayscott_jl_tpu_torch.config.settings import Settings
from grayscott_jl_tpu_torch.io import checkpoint
from grayscott_jl_tpu_torch.io.bplite import BpReader
from grayscott_jl_tpu_torch.obs import events
from grayscott_jl_tpu_torch.reshard import plan
from grayscott_jl_tpu_torch.resilience.rendezvous import FileRendezvous

#: The ground rules' tolerance against the reference (float32).
ATOL = 1e-5

PHYSICS = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0, noise=0.1)

#: Environment a run of these tests sets; cleared around each run.
RUN_VARS = ("GS_TPU_MESH_DIMS", "GS_RESHARD", "GS_EVENTS", "GS_TPU_STATS",
            "GS_FAULT_JOURNAL", "GS_FAULTS", "GS_SUPERVISE", "GS_FUSE")


def write_config(path, **kw):
    """A TOML config at ``path`` with its stores beside it."""
    d = path.parent
    d.mkdir(parents=True, exist_ok=True)
    base = dict(L=16, steps=8, plotgap=4, precision="Float32", backend="CPU",
                checkpoint=True, checkpoint_freq=4,
                output=str(d / "gs.bp"), checkpoint_output=str(d / "ckpt.bp"),
                restart_input=str(d / "ckpt.bp"), **PHYSICS)
    base.update(kw)
    lines = []
    for key, value in base.items():
        if isinstance(value, bool):
            lines.append(f"{key} = {'true' if value else 'false'}")
        elif isinstance(value, str):
            lines.append(f'{key} = "{value}"')
        else:
            lines.append(f"{key} = {value}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def run(monkeypatch, main, cfg, n, env=None):
    """``main([cfg], n_devices=n)`` (either package's driver) with only
    ``env`` of :data:`RUN_VARS` set; the port's sinks re-read."""
    for var in RUN_VARS:
        monkeypatch.delenv(var, raising=False)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    for reset in (events.reset_events, ref_events.reset_events):
        reset()
    try:
        return main([cfg], n_devices=n)
    finally:
        for reset in (events.reset_events, ref_events.reset_events):
            reset()


def store_arrays(path, names):
    """Every step's assembled arrays of a store: ``[(step, {name: a})]``."""
    with BpReader(str(path)) as r:
        return [(int(r.get("step", step=i)),
                 {n: np.asarray(r.get(n, step=i)) for n in names})
                for i in range(r.num_steps())]


def assert_stores_equal(a, b, names, atol=0.0):
    """The assembled arrays of two stores at every step: bitwise, or
    within ``atol``."""
    sa, sb = store_arrays(a, names), store_arrays(b, names)
    assert [s for s, _ in sa] == [s for s, _ in sb]
    for (step, x), (_, y) in zip(sa, sb):
        for n in names:
            if atol:
                np.testing.assert_allclose(y[n], x[n], rtol=0, atol=atol,
                                           err_msg=f"{n} at step {step}")
            else:
                assert x[n].tobytes() == y[n].tobytes(), (n, step)


def attributes(path):
    with BpReader(str(path)) as r:
        return r.attributes()


# ------------------------------------------------------------------- F8


def test_f8_checkpoint_store_records_the_reference_layout(tmp_path,
                                                          monkeypatch):
    """The same TOML on 8 blocks in both packages: the port's checkpoint
    store carries every layout attribute, its attributes equal the
    reference's store's, and the reference reads its layout back as the
    reference's own (not as a store without a record)."""
    stores = {}
    for name, main in (("ref", ref_driver.main), ("port", driver.main)):
        cfg = write_config(tmp_path / name / "c.toml", steps=4, plotgap=2,
                           checkpoint_freq=2)
        run(monkeypatch, main, cfg, 8)
        stores[name] = tmp_path / name / "ckpt.bp"
    port_attrs = attributes(stores["port"])
    for name in plan.LAYOUT_ATTRS:
        assert name in port_attrs, name
    assert port_attrs == attributes(stores["ref"])
    layouts = []
    for store in stores.values():
        with BpReader(str(store)) as r:
            layouts.append(ref_checkpoint.read_layout(r))
    assert layouts[0] is not None and layouts[0] == layouts[1]
    assert layouts[1].mesh_dims == (2, 2, 2)
    with BpReader(str(stores["port"])) as r:
        assert checkpoint.read_layout(r) == plan.LayoutMeta(
            mesh_dims=(2, 2, 2), chain_fuse=2)


def test_f8_an_append_keeps_the_creation_layout(tmp_path, monkeypatch):
    """A resume on another mesh appends to the store and leaves the
    layout it was created with, as the reference's does."""
    cfg = write_config(tmp_path / "a" / "c.toml")
    run(monkeypatch, driver.main, cfg, 8)
    before = attributes(tmp_path / "a" / "ckpt.bp")
    resume = write_config(tmp_path / "a" / "r.toml", restart=True,
                          restart_step=4)
    run(monkeypatch, driver.main, resume, 4, {"GS_TPU_MESH_DIMS": "1,2,2"})
    assert attributes(tmp_path / "a" / "ckpt.bp") == before
    assert before["mesh_dims"] == [2, 2, 2]


# ------------------------------------------------------------------- F9


def test_f9_off_refuses_another_process_count(tmp_path, monkeypatch):
    """A (2,2,2) store written by one process (the reference's run),
    restored under ``reshard = "off"`` by two processes on the same
    (2,2,2) mesh: the block boxes
    are the same, but the recorded process count is not, so the
    reference's plan refuses it — and so does the port's run."""
    from test_torch_multiprocess import TIMEOUT, clean_env

    cfg = write_config(tmp_path / "c.toml", kernel_language="XLA")
    run(monkeypatch, ref_driver.main, cfg, 8)
    with BpReader(str(tmp_path / "ckpt.bp")) as r:
        old = ref_checkpoint.read_layout(r)
    assert (old.mesh_dims, old.process_count) == ((2, 2, 2), 1)
    with pytest.raises(ref_plan.ReshardError, match="reshard='off'"):
        ref_plan.plan_restore(old, ref_plan.LayoutMeta(
            mesh_dims=(2, 2, 2), process_count=2, chain_fuse=2),
            L=16, allow="off")
    resume = write_config(tmp_path / "r.toml", kernel_language="XLA",
                          restart=True, reshard="off",
                          output=str(tmp_path / "r.bp"),
                          checkpoint_output=str(tmp_path / "r_ckpt.bp"))
    log = tmp_path / "launch.log"
    with open(log, "w") as f:
        codes = launch.launch(2, resume, 4, env=clean_env(),
                              cwd=str(tmp_path), timeout=TIMEOUT, stdout=f,
                              stderr=f)
    out = log.read_text()
    # The launcher stops the other process once one has failed.
    assert 1 in codes and 0 not in codes, (codes, out)
    assert ("ReshardError: checkpoint was written on mesh 2x2x2 "
            "(1 process(es)) but this run adopts 2x2x2 (2 "
            "process(es))") in out, out


def test_f9_off_accepts_a_store_without_a_layout(tmp_path, monkeypatch):
    """A store with no layout record (written by the reference's writer
    without ``layout``) on (2,2,2), restored under ``reshard = "off"`` on
    one block: the reference restores it, and so does the port, to the
    reference's values within the tolerance."""
    monkeypatch.delenv("GS_TPU_MESH_DIMS", raising=False)
    ref_settings = ref_driver.get_settings(
        [write_config(tmp_path / "w.toml", L=16)])
    sim = RefSimulation(ref_settings, n_devices=8, seed=0)
    sim.iterate(4)
    w = ref_checkpoint.CheckpointWriter(ref_settings, sim.dtype)
    w.save(sim.step, sim.local_blocks())
    w.close()
    assert "layout_schema" not in attributes(tmp_path / "ckpt.bp")
    outs = {}
    for name, main in (("ref", ref_driver.main), ("port", driver.main)):
        cfg = write_config(tmp_path / name / "r.toml", restart=True,
                           reshard="off",
                           restart_input=str(tmp_path / "ckpt.bp"))
        sim = run(monkeypatch, main, cfg, 1)
        assert sim.reshard is None
        outs[name] = tmp_path / name / "gs.bp"
    assert_stores_equal(outs["ref"], outs["port"], ("U", "V"), atol=ATOL)


# ----------------------------------------------------------- the plan

LS = (24, 25, 32)
DIMS = ((1, 1, 1), (2, 2, 2), (1, 2, 2), (3, 1, 1), (8, 1, 1))


def _outcome(mod, fn):
    """``fn(mod)``'s value, or its error's class name and message."""
    try:
        return ("ok", fn(mod))
    except (mod.ReshardError, ValueError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("old_dims", DIMS)
@pytest.mark.parametrize("new_dims", DIMS)
def test_plan_equals_the_reference(L, old_dims, new_dims):
    """For every process count pair and both ``allow`` values: the plan
    (changed, boxes, describe) or the refusal, word for word; every new
    box's overlapping old shards; the boxes of both meshes."""
    assert plan.shard_boxes(L, new_dims) == ref_plan.shard_boxes(L, new_dims)
    for _, start, count in ref_plan.shard_boxes(L, new_dims):
        assert plan.overlapping_old_shards((start, count), L, old_dims) == (
            ref_plan.overlapping_old_shards((start, count), L, old_dims))
    for p_old in (1, 2):
        for p_new in (1, 2):
            for allow in ("auto", "off"):
                def make(mod):
                    p = mod.plan_restore(
                        mod.LayoutMeta(mesh_dims=old_dims,
                                       process_count=p_old),
                        mod.LayoutMeta(mesh_dims=new_dims,
                                       process_count=p_new, halo_depth=2),
                        L=L, allow=allow)
                    return (p.changed, p.boxes, p.L, p.describe())

                assert _outcome(plan, make) == _outcome(ref_plan, make)


@pytest.mark.parametrize("present,new_n,active", [
    ([True, True], 3, None), ([True, True, True], 2, None),
    ([True, False, True], 3, None), ([False, False], 2, None),
    ([True, False], 2, [True, False]), ([False, True], 2, [False, True]),
    ([True], 1, None), ([True, True], 4, [True, True, False]),
])
def test_member_map_equals_the_reference(present, new_n, active):
    def make(mod):
        return mod.member_map(present, new_n, active)

    assert _outcome(plan, make) == _outcome(ref_plan, make)


@pytest.mark.parametrize("attrs", [
    None, {}, {"L": 16},
    {"layout_schema": 1, "mesh_dims": [2, 2, 2], "axis_names": ["x", "y", "z"],
     "process_count": 2, "halo_depth": 3, "chain_fuse": 4,
     "ensemble_size": 1},
    {"layout_schema": 7, "mesh_dims": [1, 2, 2]},
    {"layout_schema": "x", "mesh_dims": "bad", "process_count": None},
])
def test_read_layout_and_layout_attrs_equal_the_reference(attrs):
    """Parsing (a newer schema, damaged attributes and a store with no
    record included) and the attributes a writer records."""
    got, want = plan.read_layout(attrs), ref_plan.read_layout(attrs)
    if want is None:
        assert got is None
    else:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        kw = dict(mesh_dims=want.mesh_dims, axis_names=want.axis_names,
                  process_count=want.process_count,
                  halo_depth=want.halo_depth, chain_fuse=want.chain_fuse,
                  ensemble_size=want.ensemble_size)
        assert plan.layout_attrs(**kw) == ref_plan.layout_attrs(**kw)
        assert list(plan.layout_attrs(**kw)) == list(plan.LAYOUT_ATTRS)
    assert plan.LAYOUT_ATTRS == ref_plan.LAYOUT_ATTRS
    assert plan.LAYOUT_SCHEMA_VERSION == ref_plan.LAYOUT_SCHEMA_VERSION


def test_checkpoint_reshard_error_is_the_plans():
    """``io/checkpoint.ReshardError`` is the plan's class, so every
    ``except``/``raises`` of either name catches both."""
    assert checkpoint.ReshardError is plan.ReshardError


# ------------------------------------------------------ restores, moved


@pytest.mark.parametrize("old_n,old_dims,new_n,new_dims", [
    (1, None, 8, "2,2,2"),
    (8, None, 4, "1,2,2"),
    (8, None, 1, None),
])
def test_restore_on_another_mesh(tmp_path, monkeypatch, old_n, old_dims,
                                 new_n, new_dims):
    """A checkpoint at step 4 on ``old_n`` blocks restored on ``new_n``:
    the port's store bitwise equal to its run that never moved, within
    the tolerance of the reference's moved run; the ``reshard`` event,
    journal record and stats echo equal to the reference's but for
    their times."""
    move_env = {"GS_TPU_MESH_DIMS": new_dims} if new_dims else {}
    out, records = {}, {}
    for name, main in (("ref", ref_driver.main), ("port", driver.main)):
        d = tmp_path / name
        run(monkeypatch, main, write_config(d / "c.toml"), old_n)
        resume = write_config(d / "r.toml", restart=True, restart_step=4,
                              output=str(d / "r.bp"))
        env = {**move_env, "GS_EVENTS": str(d / "events.jsonl"),
               "GS_FAULT_JOURNAL": str(d / "journal.jsonl"),
               "GS_TPU_STATS": str(d / "stats.json")}
        sim = run(monkeypatch, main, resume, new_n, env)
        assert tuple(sim.domain.dims) == (
            tuple(int(x) for x in new_dims.split(",")) if new_dims
            else (1, 1, 1))
        out[name] = d / "r.bp"
        evs = [json.loads(x) for x in
               (d / "events.jsonl").read_text().splitlines()]
        reshard_evs = [e for e in evs if e["kind"] == "reshard"]
        journal = [json.loads(x) for x in
                   (d / "journal.jsonl").read_text().splitlines()]
        stats = json.loads((d / "stats.json").read_text())["config"]
        records[name] = (
            [_timeless(e["attrs"]) | {"step": e.get("step")}
             for e in reshard_evs if "old_mesh" in e["attrs"]],
            [_timeless(e) for e in journal if e["event"] == "reshard"],
            _timeless(stats["reshard"]))
    assert records["port"] == records["ref"]
    events_, journal_, echo = records["port"]
    assert len(events_) == 1 and len(journal_) == 1
    assert echo["changed"] is True and echo["path"] == "ckpt"
    assert echo["bytes"] == 16 ** 3 * 2 * 4
    assert_stores_equal(out["ref"], out["port"], ("U", "V"), atol=ATOL)
    # The port's moved run against its own run that never moved.
    unmoved = tmp_path / "unmoved"
    cfg = write_config(unmoved / "c.toml")
    run(monkeypatch, driver.main, cfg, new_n, move_env)
    moved = store_arrays(out["port"], ("U", "V"))
    whole = dict(store_arrays(unmoved / "gs.bp", ("U", "V")))
    for step, arrays in moved:
        for n in ("U", "V"):
            assert arrays[n].tobytes() == whole[step][n].tobytes()


def _timeless(record):
    """A record without its times (``ts``, ``t``, ``wall_s``) and its
    stream framing."""
    return {k: v for k, v in record.items()
            if k not in ("ts", "t", "wall_s", "proc")}


def test_same_mesh_restore_is_not_a_reshard(tmp_path, monkeypatch):
    cfg = write_config(tmp_path / "c.toml")
    run(monkeypatch, driver.main, cfg, 8)
    resume = write_config(tmp_path / "r.toml", restart=True, restart_step=4,
                          output=str(tmp_path / "r.bp"))
    sim = run(monkeypatch, driver.main, resume, 8,
              {"GS_TPU_STATS": str(tmp_path / "stats.json")})
    assert sim.reshard is None
    stats = json.loads((tmp_path / "stats.json").read_text())["config"]
    assert stats["reshard"] is None


# ----------------------------------------------------- mesh agreement


def _mesh_pair(tmp_path, cls, proposals, devices):
    results, errors = [None, None], [None, None]

    def worker(p):
        rdv = cls(str(tmp_path / "rdv"), 2, p, timeout_s=20)
        try:
            results[p] = rdv.agree_mesh(devices[p], proposals[p])
        except Exception as e:  # noqa: BLE001 — compared below
            errors[p] = e

    threads = [threading.Thread(target=worker, args=(p,)) for p in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, errors


@pytest.mark.parametrize("proposals,devices,word", [
    (((1, 2, 2), (1, 2, 2)), (2, 2), None),
    ((None, None), (4, 4), None),
    (((4, 1, 1), (1, 2, 2)), (2, 2), "disagree"),
    (((1, 2, 2), (1, 2, 2)), (2, 1), "factor"),
])
def test_mesh_agreement_equals_the_reference(tmp_path, proposals, devices,
                                             word):
    """The reference's ``test_mesh_agreement_*`` cases through both
    packages' file rendezvous: the same adopted mesh, or the same
    refusal."""
    got = _mesh_pair(tmp_path / "port", FileRendezvous, proposals, devices)
    want = _mesh_pair(tmp_path / "ref", RefFileRendezvous, proposals,
                      devices)
    assert got[0] == want[0]
    if word is None:
        assert got[1] == want[1] == [None, None]
        assert got[0][0] == got[0][1]
    else:
        assert all(isinstance(e, plan.ReshardError) for e in got[1])
        assert all(isinstance(e, ref_plan.ReshardError) for e in want[1])
        assert word in str(got[1][0]) and word in str(want[1][0])


def test_settings_reshard_device_equals_the_reference(monkeypatch):
    """``GS_RESHARD_DEVICE``: the same modes and refusal as the
    reference's ``resolve_reshard_device``."""
    from grayscott_jl_tpu.config import settings as ref_settings
    from grayscott_jl_tpu_torch.config import settings as port_settings

    assert (port_settings.RESHARD_DEVICE_MODES
            == ref_settings.RESHARD_DEVICE_MODES)
    for raw in (None, "", "AUTO", "collective", "put", "host", "off"):
        if raw is None:
            monkeypatch.delenv("GS_RESHARD_DEVICE", raising=False)
        else:
            monkeypatch.setenv("GS_RESHARD_DEVICE", raw)
        assert (port_settings.resolve_reshard_device(Settings())
                == ref_settings.resolve_reshard_device(None))
    monkeypatch.setenv("GS_RESHARD_DEVICE", "teleport")
    with pytest.raises(ValueError, match="GS_RESHARD_DEVICE"):
        port_settings.resolve_reshard_device(Settings())
    with pytest.raises(ValueError, match="GS_RESHARD_DEVICE"):
        ref_settings.resolve_reshard_device(None)
