"""Member groups across processes and the member move's device tiers
(grayscott_jl_tpu_torch/ensemble/engine.py ``MemberGroupMesh``,
reshard/restore.py) on CPU torch over gloo, at L=16, 4 members, 10
steps, noise 0.1, ``member_shards = 2`` on (2,1,1) blocks per group.

* 2 processes of 2 blocks, one group each, and 4 processes of 1 block,
  each group spanning two of them (its halo exchange between the two):
  every member's assembled stores bitwise equal to the one-process
  ``member_shards = 2`` run's, and within 1e-6 of the reference's
  in-process ``EnsembleSimulation`` with ``member_shards = 2`` (the
  ensemble parity tolerance of tests/test_torch_ensemble.py). The 4-process run also moves live between rounds, each
  group's blocks crossing processes: the tier agreed ``collective``.
* Two processes under ``GS_AUTOTUNE=quick`` adopt the same measured
  member split, their stores again the one-process run's.
* In one process the member move under ``collective``, ``put``,
  ``auto`` and ``host`` continues bitwise equal to the unmoved run and
  to the host tier's move; a move that changes the member split takes
  the host tier under ``auto`` and is refused by a pinned device tier.

Every process has a timeout of 120 s; a run's processes are killed on
failure."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.ensemble import engine as ref_engine
from grayscott_jl_tpu.ensemble import spec as ref_spec
from grayscott_jl_tpu_torch import Settings, launch
from grayscott_jl_tpu_torch.ensemble import spec as ens_spec
from grayscott_jl_tpu_torch.ensemble.engine import EnsembleSimulation
from grayscott_jl_tpu_torch.ensemble.io import member_path
from grayscott_jl_tpu_torch.reshard import ReshardError, restore
from test_torch_multiprocess import TIMEOUT, clean_env, run_single
from test_torch_reshard import store_arrays

FOUR = ["spots", "stripes", "waves", "chaos"]
PHYSICS = dict(Du=0.2, Dv=0.1, F=0.02, k=0.048, dt=1.0)
#: The ensemble parity tolerance against the reference (max |Δ|;
#: tests/test_torch_ensemble.py).
ATOL = 1e-6

CONFIG = """L = 16
steps = 10
plotgap = 5
noise = 0.1
Du = 0.2
Dv = 0.1
dt = 1.0
checkpoint = true
checkpoint_freq = 5
output = "{d}/gs.bp"
checkpoint_output = "{d}/ck.bp"
precision = "Float32"
backend = "CPU"
kernel_language = "Pallas"
verbose = false

[ensemble]
presets = ["spots", "stripes", "waves", "chaos"]
member_shards = 2
"""

#: One process of a run that moves live after its first round.
MOVER = r"""
import json, sys
from grayscott_jl_tpu_torch import driver
from grayscott_jl_tpu_torch.config.settings import get_settings
calls = [0]
def poll():
    calls[0] += 1
    return {"mesh_dims": [1, 2, 1]} if calls[0] == 2 else None
sim = driver.run_once(get_settings([sys.argv[1]]), n_devices=1,
                      reshape_poll=poll)
print(json.dumps({"dims": list(sim.domain.dims), "held": sim.mesh.held,
                  "reshard": sim.reshard, "blocks": len(sim.blocks)}))
"""


def write(d):
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.toml").write_text(CONFIG.format(d=d))
    return str(d / "config.toml")


def member_stores(d, kind="gs"):
    names = ("U", "V") if kind == "gs" else ("u", "v")
    return [store_arrays(member_path(str(d / f"{kind}.bp"), k, 4), names)
            for k in range(4)]


def assert_members_bitwise(a, b):
    for kind in ("gs", "ck"):
        for ma, mb in zip(member_stores(a, kind), member_stores(b, kind)):
            assert [s for s, _ in ma] == [s for s, _ in mb] and ma
            for (step, x), (_, y) in zip(ma, mb):
                for n in x:
                    assert x[n].tobytes() == y[n].tobytes(), (kind, step, n)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The one-process run on four CPU blocks: 2 groups of (2,1,1)."""
    d = tmp_path_factory.mktemp("one")
    mp = pytest.MonkeyPatch()
    try:
        sim = run_single(mp, d, write(d), n=4)
    finally:
        mp.undo()
    assert (sim.member_shards, sim.domain.dims) == (2, (2, 1, 1))
    return d


@pytest.fixture(scope="module")
def reference():
    """The reference's member_shards = 2 ensemble on 4 devices, 10
    steps: (N, L, L, L) per field."""
    s = RefSettings(L=16, noise=0.1, precision="Float32", backend="CPU",
                    **PHYSICS)
    s.ensemble = ref_spec.from_toml({"presets": FOUR, "member_shards": 2}, s)
    ref = ref_engine.EnsembleSimulation(s, n_devices=4, seed=0)
    ref.iterate(10)
    return [np.asarray(f) for f in ref.get_fields()]


def assert_near_reference(d, ref):
    for k, member in enumerate(member_stores(d)):
        step, last = member[-1]
        assert step == 10
        for name, want in zip(("U", "V"), ref):
            diff = np.max(np.abs(last[name].astype(np.float64)
                                 - want[k].astype(np.float64)))
            assert diff <= ATOL, (k, name, diff)


def spawn(n, d, argv):
    """``n`` processes of ``argv`` with the launch variables; returns
    ``[(code, stdout, stderr)]``, all killed past the timeout."""
    port = launch.free_port()
    procs = [subprocess.Popen(
        [sys.executable, *argv], cwd=str(d),
        env=launch.process_env(r, n, port, clean_env()),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    outs = []
    deadline = time.monotonic() + TIMEOUT
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_processes_one_group_each(tmp_path, one_process, reference):
    """Each process holds one whole group: no exchange crosses
    processes; its member stores are written by both writers."""
    d = tmp_path / "two"
    cfg = write(d)
    log = d / "launch.log"
    with open(log, "w") as f:
        codes = launch.launch(2, cfg, 2, env=clean_env(
            {"GS_TPU_STATS": str(d / "stats.json"), "GS_XSTATS": "1"}),
            cwd=str(d), timeout=TIMEOUT, stdout=f, stderr=subprocess.STDOUT)
    assert codes == [0, 0], log.read_text()
    assert_members_bitwise(one_process, d)
    assert_near_reference(d, reference)
    for rank in range(2):
        stats = json.loads((d / f"stats.json.rank{rank}").read_text())
        assert stats["config"]["ensemble"]["member_shards"] == 2
        assert stats["config"]["mesh_dims"] == [2, 1, 1]
        census = stats["executables"]["collectives"]
        assert census["x"] == 2 and "p2p_sends" not in census


def test_four_processes_groups_span_two_and_move(tmp_path, one_process,
                                                 reference):
    """Each group's two blocks on two processes: its halo exchange
    crosses them, and after the first round every process moves onto
    (1,2,1) together (collective, the overlaps crossing processes)."""
    d = tmp_path / "four"
    cfg = write(d)
    outs = spawn(4, d, ["-c", MOVER, cfg])
    for rank, (code, out, err) in enumerate(outs):
        assert code == 0, err[-3000:]
        got = json.loads(out.strip().splitlines()[-1])
        assert (got["dims"], got["blocks"]) == ([1, 2, 1], 1)
        assert got["held"] == [rank // 2]
        assert got["reshard"]["path"] == "collective"
        assert got["reshard"]["new"]["process_count"] == 4
    assert_members_bitwise(one_process, d)
    assert_near_reference(d, reference)


def test_processes_adopt_the_same_measured_split(tmp_path, one_process):
    """Two processes under ``GS_AUTOTUNE=quick`` from ``member_shards =
    1``: the tuner's decision, agreed across the processes, may adopt a
    member split, and both adopt the same one; the members' stores are
    bitwise the one-process run's (member k is its solo run whatever the
    split)."""
    d = tmp_path / "tuned"
    cfg = write(d)
    text = (d / "config.toml").read_text().replace(
        'kernel_language = "Pallas"', 'kernel_language = "Auto"').replace(
        "member_shards = 2", "member_shards = 1")
    (d / "config.toml").write_text(text)
    log = d / "launch.log"
    with open(log, "w") as f:
        codes = launch.launch(2, cfg, 2, env=clean_env({
            "GS_AUTOTUNE": "quick", "GS_AUTOTUNE_CACHE": str(d / "tune"),
            "GS_TPU_STATS": str(d / "stats.json")}), cwd=str(d),
            timeout=TIMEOUT, stdout=f, stderr=subprocess.STDOUT)
    assert codes == [0, 0], log.read_text()
    splits = [json.loads((d / f"stats.json.rank{r}").read_text())[
        "config"]["ensemble"]["member_shards"] for r in range(2)]
    assert splits[0] == splits[1]
    assert_members_bitwise(one_process, d)


# ------------------------------------------------------- one process


def _settings(presets=FOUR, shards=2):
    s = Settings(L=16, noise=0.1, backend="CPU", precision="Float32",
                 kernel_language="Pallas", **PHYSICS)
    s.ensemble = ens_spec.from_toml({"presets": presets,
                                     "member_shards": shards}, s)
    return s


def _ens(dims, steps, **kw):
    n = dims[0] * dims[1] * dims[2] * 2
    e = EnsembleSimulation(_settings(**kw), n_devices=n, mesh_dims=dims)
    e.iterate(steps)
    return e


def _bitwise(a, b):
    for x, y in zip(a.get_fields(), b.get_fields()):
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("mode", ["auto", "collective", "put", "host"])
def test_member_move_on_each_tier(mode, monkeypatch):
    """(2,1,1) -> (1,2,1) per group at step 4, four steps after: equal to
    eight unmoved steps and to the host tier's move; every member's
    bytes counted."""
    monkeypatch.setenv("GS_FUSE", "1")
    unmoved = _ens((1, 2, 1), 8)
    target, plan = restore.reshape_live(_ens((2, 1, 1), 4),
                                        mesh_dims=(1, 2, 1), mode=mode)
    assert target.reshard["path"] == ("collective" if mode == "auto"
                                      else mode)
    assert target.reshard["bytes"] == 4 * 16**3 * 2 * 4
    assert (target.member_shards, target.domain.dims) == (2, (1, 2, 1))
    target.iterate(4)
    _bitwise(unmoved, target)
    host, _ = restore.reshape_live(_ens((2, 1, 1), 4), mesh_dims=(1, 2, 1),
                                   mode="host")
    host.iterate(4)
    _bitwise(host, target)


def test_a_move_that_regroups_members_takes_the_host(monkeypatch):
    """Growing 4 members to 6 under member_shards = 2 moves members
    between groups: ``auto`` takes the host tier, a pinned device tier
    raises."""
    monkeypatch.setenv("GS_FUSE", "1")
    six = _settings(presets=FOUR + ["mitosis", "spots"])
    with pytest.raises(ReshardError, match="member split or count"):
        restore.reshape_live(_ens((2, 1, 1), 2), settings=six,
                             mode="collective")
    target, plan = restore.reshape_live(_ens((2, 1, 1), 2), settings=six,
                                        mode="auto")
    assert target.reshard["path"] == "host"
    assert plan.members == {"restored": 4, "grown": 2, "new_n": 6}
