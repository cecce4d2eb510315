"""Elastic resharding, the live path (grayscott_jl_tpu_torch/reshard/
restore.py: ``device_all_to_all_restore``, ``reshape_live``; driver.py:
``run_once(reshape_poll=)`` and the quarantine poll), on CPU torch at
L <= 32, held against live runs of the reference package on the 8
virtual CPU devices of tests/conftest.py.

* Each tier, forced (``collective``, ``put``, ``host``, and ``auto``),
  continues bitwise equal to the run that never moved and to the
  ``host`` tier, a padded mesh included (mesh A's pad dropped, mesh B's
  rebuilt at the boundary values); the move within atol 1e-5 of the
  reference's ``reshape_live`` (the ground rules' tolerance).
* ``collective`` across device sets and ``off`` are refused with
  ``ReshardError``.
* The driver's ``reshape_poll``: (2,2,2) -> (1,2,2) after round one, the
  stores appended (steps ``[4, 8]``), equal to the unmoved run's; an
  infeasible request is refused and the run goes on; a quarantined
  device with nowhere to move to warns and the run goes on.
* Two processes over gloo move together, their store bitwise equal to
  the one-process run's.

On the CPU every block lives on the one CPU device, so ``auto`` takes
``collective``; the ``put`` tier across cards and the quarantine move
run on the card (tests/test_torch_card.py)."""

import json

import numpy as np
import pytest

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.driver import run_once as ref_run_once
from grayscott_jl_tpu.reshard.restore import reshape_live as ref_reshape_live
from grayscott_jl_tpu.simulation import Simulation as RefSimulation
from grayscott_jl_tpu_torch import Settings, Simulation, driver
from grayscott_jl_tpu_torch.reshard import ReshardError, restore
from test_torch_reshard import ATOL, assert_stores_equal, store_arrays

PHYSICS = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0, noise=0.1)

#: (L, source mesh, target mesh): shrink, a same-count relayout, grow
#: from one block, and a padded mesh both ways (L=26 on (3,1,1) stores
#: 27 planes of x).
MOVES = [
    (24, (2, 2, 2), (1, 2, 2)),
    (24, (2, 2, 2), (8, 1, 1)),
    (24, (1, 1, 1), (2, 1, 1)),
    (26, (3, 1, 1), (1, 2, 2)),
    (26, (1, 2, 2), (3, 1, 1)),
]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("GS_TPU_MESH_DIMS", "GS_RESHARD", "GS_RESHARD_DEVICE",
                "GS_DEVICE_BLOCKLIST", "GS_FAULTS", "GS_SUPERVISE"):
        monkeypatch.delenv(var, raising=False)
    # Depth 1: the reference's cross-mesh bitwise contract off the TPU.
    monkeypatch.setenv("GS_FUSE", "1")


def _sim(L, dims, steps):
    n = dims[0] * dims[1] * dims[2]
    sim = Simulation(Settings(L=L, precision="Float32", backend="CPU",
                              **PHYSICS), n_devices=n, mesh_dims=dims)
    sim.iterate(steps)
    return sim


def _bitwise(a, b):
    for x, y in zip(a.get_fields(), b.get_fields()):
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("L,src,dst", MOVES)
@pytest.mark.parametrize("mode", ["auto", "collective", "put", "host"])
def test_each_tier_continues_bitwise(L, src, dst, mode):
    """Four steps on ``src``, the move, four more on ``dst``: equal to
    eight steps on ``dst`` and to the ``host`` tier's move, with the
    plan and its provenance on ``target.reshard``."""
    unmoved = _sim(L, dst, 8)
    sim = _sim(L, src, 4)
    target, plan = restore.reshape_live(sim, mesh_dims=dst, mode=mode)
    assert plan.changed and tuple(target.domain.dims) == dst
    want_path = "collective" if mode == "auto" else mode
    rec = target.reshard
    assert rec["path"] == want_path
    assert rec["bytes"] == L ** 3 * 2 * 4 and rec["wall_s"] >= 0
    assert (rec["old"]["mesh_dims"], rec["new"]["mesh_dims"]) == (
        list(src), list(dst))
    assert target.step == 4 and target.kernel_language == sim.kernel_language
    target.iterate(4)
    _bitwise(unmoved, target)
    host, _ = restore.reshape_live(_sim(L, src, 4), mesh_dims=dst,
                                   mode="host")
    host.iterate(4)
    _bitwise(host, target)


def test_live_move_matches_the_reference():
    """(2,2,2) -> (1,2,2) at step 4 in both packages, four steps after:
    within the ground rules' tolerance."""
    ref = RefSimulation(RefSettings(L=24, precision="Float32", backend="CPU",
                                    kernel_language="XLA", **PHYSICS),
                        n_devices=8, seed=0, mesh_dims=(2, 2, 2))
    ref.iterate(4)
    ref_target, ref_plan = ref_reshape_live(ref, mesh_dims=(1, 2, 2))
    ref_target.iterate(4)
    target, plan = restore.reshape_live(_sim(24, (2, 2, 2), 4),
                                        mesh_dims=(1, 2, 2))
    target.iterate(4)
    assert plan.describe() == ref_plan.describe()
    for a, b in zip(ref_target.get_fields(), target.get_fields()):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=ATOL)


def test_collective_across_device_sets_and_off_are_refused(monkeypatch):
    """A pinned tier that cannot run raises: ``collective`` between two
    device sets (on the CPU the sets are one, so the target's is made to
    differ), and ``off`` before it looks at anything."""
    with pytest.raises(ReshardError, match="GS_RESHARD_DEVICE=off"):
        restore.device_all_to_all_restore(None, None, None, mode="off")
    monkeypatch.setenv("GS_RESHARD_DEVICE", "off")
    with pytest.raises(ReshardError, match="disabled"):
        restore.reshape_live(_sim(24, (2, 2, 2), 0), mesh_dims=(1, 2, 2))
    monkeypatch.delenv("GS_RESHARD_DEVICE")
    sim = _sim(24, (2, 2, 2), 2)
    real = restore._device_set
    monkeypatch.setattr(
        restore, "_device_set",
        lambda s: real(s) if s is sim else frozenset({"cuda:7"}))
    with pytest.raises(ReshardError, match="same device set"):
        restore.reshape_live(sim, mesh_dims=(1, 2, 2), mode="collective")
    # auto takes put there, and stays bitwise.
    target, _ = restore.reshape_live(sim, mesh_dims=(1, 2, 2))
    assert target.reshard["path"] == "put"
    target.iterate(2)
    _bitwise(_sim(24, (1, 2, 2), 4), target)


def test_reshard_off_refuses_a_live_move_before_building_it(monkeypatch):
    monkeypatch.setenv("GS_RESHARD", "off")
    built = []
    monkeypatch.setattr(restore, "placement",
                        lambda *a: built.append(a) or [])
    with pytest.raises(ReshardError, match="reshard='off'"):
        restore.reshape_live(_sim(24, (2, 2, 2), 0), mesh_dims=(1, 2, 2))
    assert not built


# ---------------------------------------------------------- the driver


def _settings(d, **kw):
    d.mkdir(parents=True, exist_ok=True)
    base = dict(L=24, steps=8, plotgap=4, precision="Float32", backend="CPU",
                output=str(d / "gs.bp"), checkpoint=True, checkpoint_freq=4,
                checkpoint_output=str(d / "ckpt.bp"),
                restart_input=str(d / "ckpt.bp"), **PHYSICS)
    base.update(kw)
    return base


def _poll_at(n, request):
    """A poll that asks for ``request`` on its ``n``-th call (the first
    call comes before round one)."""
    calls = [0]

    def poll():
        calls[0] += 1
        return request if calls[0] == n else None

    return poll


def _steps(store):
    return [s for s, _ in store_arrays(store, ())]


def test_driver_reshape_poll_moves_live_and_appends(tmp_path, monkeypatch):
    """``run_once(reshape_poll=...)`` asking for (1,2,2) after round one
    of a (2,2,2) run: the run ends on (1,2,2) with the move's record,
    both stores hold steps ``[4, 8]`` (the step written before the move
    survives), the stores equal the unmoved (2,2,2) run's bitwise and
    the reference's moved run within the tolerance."""
    stats = tmp_path / "stats.json"
    monkeypatch.setenv("GS_TPU_STATS", str(stats))
    moved = driver.run_once(Settings(**_settings(tmp_path / "moved")),
                            n_devices=8,
                            reshape_poll=_poll_at(2, {"mesh_dims": [1, 2, 2]}))
    monkeypatch.delenv("GS_TPU_STATS")
    assert tuple(moved.domain.dims) == (1, 2, 2)
    assert moved.reshard["path"] == "collective"
    assert moved.reshard["bytes"] == 24 ** 3 * 2 * 4
    cfg = json.loads(stats.read_text())["config"]
    assert cfg["reshard"]["new"]["mesh_dims"] == [1, 2, 2]
    assert (cfg["mesh_dims"], cfg["n_devices"]) == ([1, 2, 2], 4)
    for store in ("gs.bp", "ckpt.bp"):
        assert _steps(tmp_path / "moved" / store) == [4, 8]
    driver.run_once(Settings(**_settings(tmp_path / "unmoved")), n_devices=8)
    ref = ref_run_once(RefSettings(**_settings(tmp_path / "ref"),
                                   kernel_language="XLA", autotune="off"),
                       n_devices=8,
                       reshape_poll=_poll_at(2, {"mesh_dims": [1, 2, 2]}))
    assert tuple(ref.domain.dims) == (1, 2, 2)
    for store, names in (("gs.bp", ("U", "V")), ("ckpt.bp", ("u", "v"))):
        assert_stores_equal(tmp_path / "unmoved" / store,
                            tmp_path / "moved" / store, names)
        assert_stores_equal(tmp_path / "ref" / store,
                            tmp_path / "moved" / store, names, atol=ATOL)


@pytest.mark.parametrize("request_,env", [
    ({"scale": "grow"}, {}),
    ({"mesh_dims": [5, 5, 5]}, {}),
    ({"mesh_dims": [1, 2, 2]}, {"GS_RESHARD": "off"}),
    ({"mesh_dims": [1, 2, 2]}, {"GS_RESHARD_DEVICE": "off"}),
])
def test_refused_request_is_not_fatal(tmp_path, monkeypatch, capsys,
                                      request_, env):
    """A request the run cannot meet — more blocks than usable devices,
    a mesh the grid is too small for, a move under ``reshard = "off"``
    or ``GS_RESHARD_DEVICE=off`` — leaves the run on its mesh, with a
    warning where the move itself refused, as in the reference."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    sim = driver.run_once(Settings(**_settings(tmp_path, L=16)),
                          n_devices=8, reshape_poll=lambda: request_)
    assert tuple(sim.domain.dims) == (2, 2, 2) and sim.reshard is None
    out = capsys.readouterr().out
    assert ("live reshape refused" in out) == bool(env), out
    assert _steps(tmp_path / "gs.bp") == [4, 8]


def test_quarantine_with_nowhere_to_go_warns_and_continues(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    """The device the run computes on is quarantined mid-run (on the
    CPU, the only one): no usable device is left to move to, so the run
    warns once and finishes where it is, its store equal to an
    undisturbed run's."""
    def quarantine():
        monkeypatch.setenv("GS_DEVICE_BLOCKLIST", "cpu")

    sim = driver.run_once(Settings(**_settings(tmp_path / "q")), n_devices=8,
                          reshape_poll=quarantine)
    monkeypatch.delenv("GS_DEVICE_BLOCKLIST")
    assert tuple(sim.domain.dims) == (2, 2, 2)
    out = capsys.readouterr().out
    assert out.count("quarantined device(s) ['cpu'] in use but no feasible "
                     "reshape target — continuing on the current mesh") == 1
    driver.run_once(Settings(**_settings(tmp_path / "base")), n_devices=8)
    assert_stores_equal(tmp_path / "base" / "gs.bp", tmp_path / "q" / "gs.bp",
                        ("U", "V"))


def test_sdc_screen_follows_the_move(tmp_path, monkeypatch):
    """Under ``GS_SDC_CHECK=spot`` the screen re-anchors on the moved
    simulation (``Screener.rebind``): the replays after the move run on
    the new mesh and agree, and the stores equal the unscreened run's."""
    stats = tmp_path / "stats.json"
    monkeypatch.setenv("GS_SDC_CHECK", "spot")
    monkeypatch.setenv("GS_TPU_STATS", str(stats))
    sim = driver.run_once(Settings(**_settings(tmp_path / "s", steps=12)),
                          n_devices=8,
                          reshape_poll=_poll_at(2, {"mesh_dims": [1, 2, 2]}))
    monkeypatch.delenv("GS_SDC_CHECK")
    monkeypatch.delenv("GS_TPU_STATS")
    assert tuple(sim.domain.dims) == (1, 2, 2)
    screen = json.loads(stats.read_text())["config"]["sdc"]
    # Boundaries 4, 8 and 12 screened: the move at step 4 re-anchors
    # there, so 8 replays from 4 on the (1,2,2) mesh.
    assert (screen["checks"], screen["mismatches"],
            screen["verified_step"]) == (3, 0, 12), screen
    driver.run_once(Settings(**_settings(tmp_path / "u", steps=12)),
                    n_devices=8)
    assert_stores_equal(tmp_path / "u" / "gs.bp", tmp_path / "s" / "gs.bp",
                        ("U", "V"))


# ------------------------------------------------------ two processes

PAIR = r"""
import json, sys
from grayscott_jl_tpu_torch import driver
from grayscott_jl_tpu_torch.config.settings import get_settings
calls = [0]
def poll():
    calls[0] += 1
    return {"mesh_dims": [1, 2, 2]} if calls[0] == 2 else None
sim = driver.run_once(get_settings([sys.argv[1]]), n_devices=4,
                      reshape_poll=poll)
print(json.dumps({"dims": list(sim.domain.dims), "reshard": sim.reshard,
                  "blocks": len(sim.blocks)}))
"""


def test_two_processes_move_together(tmp_path, monkeypatch):
    """Two processes over gloo, four blocks each on (2,2,2), both asked
    to move after round one: each ends holding two blocks of (1,2,2),
    the overlaps that changed process sent in one batch, and the
    two-writer store bitwise equal to the one-process unmoved run's."""
    from test_torch_multiprocess import run_single, spawn_pair, write_config

    pair = tmp_path / "pair"
    cfg = write_config(pair, L=16, steps=8, plotgap=4, checkpoint_freq=4,
                       verbose=False)
    outs = spawn_pair(pair, ["-c", PAIR, cfg])
    for code, out, err in outs:
        assert code == 0, err[-3000:]
        got = json.loads(out.strip().splitlines()[-1])
        assert (got["dims"], got["blocks"]) == ([1, 2, 2], 2)
        assert got["reshard"]["path"] == "collective"
        assert got["reshard"]["new"]["process_count"] == 2
    one = tmp_path / "one"
    run_single(monkeypatch, one, write_config(one, L=16, steps=8, plotgap=4,
                                              checkpoint_freq=4,
                                              verbose=False))
    assert_stores_equal(one / "out.bp", pair / "out.bp", ("U", "V"))
    assert_stores_equal(one / "ckpt.bp", pair / "ckpt.bp", ("u", "v"))
    assert _steps(pair / "out.bp") == [4, 8]
