"""Start-up of a run of several processes (grayscott_jl_tpu_torch/
config/settings.resolve_launch, parallel/distributed.py,
parallel/mesh.py, launch.py) on the CPU: the launch variables as the
reference's ``maybe_initialize_distributed`` reads them, bad values
raising with the variable's name; the placement and backend rule with a
faked card count (the cards split evenly among a host's processes, NCCL
when each has its own, gloo when they share); the mesh's process
shares; the launcher killing the survivor when one process fails; and
two processes building the same kernel at once."""

import os
import stat
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from grayscott_jl_tpu_torch import launch
from grayscott_jl_tpu_torch.config.settings import Launch, resolve_launch
from grayscott_jl_tpu_torch.models import SettingsError
from grayscott_jl_tpu_torch.parallel import distributed
from grayscott_jl_tpu_torch.parallel.mesh import DeviceMesh

REPO = Path(__file__).resolve().parents[1]

LAUNCH_ENV = ("GS_TPU_COORDINATOR", "GS_TPU_NUM_PROCESSES",
              "GS_TPU_PROCESS_ID", "GS_TPU_DISTRIBUTED", "MASTER_ADDR",
              "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE")

TORCHRUN = {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500",
            "RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
            "LOCAL_WORLD_SIZE": "4"}


@pytest.fixture
def launch_env(monkeypatch):
    for var in LAUNCH_ENV:
        monkeypatch.delenv(var, raising=False)

    def set_env(**kw):
        for k, v in kw.items():
            monkeypatch.setenv(k, v)

    return set_env


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"GS_TPU_DISTRIBUTED": "0"}, None),
    ({"GS_TPU_DISTRIBUTED": "off"}, None),
    ({"GS_TPU_COORDINATOR": "127.0.0.1:1234", "GS_TPU_NUM_PROCESSES": "2",
      "GS_TPU_PROCESS_ID": "1"},
     Launch("coordinator", 1, 2, "127.0.0.1", 1234)),
    ({"GS_TPU_COORDINATOR": "node0:29400", "GS_TPU_NUM_PROCESSES": "4",
      "GS_TPU_PROCESS_ID": "0", "LOCAL_RANK": "0",
      "LOCAL_WORLD_SIZE": "2"},
     Launch("coordinator", 0, 4, "node0", 29400, 0, 2)),
    (dict(TORCHRUN, GS_TPU_DISTRIBUTED="auto"),
     Launch("torchrun", 3, 8, "10.0.0.1", 29500, 1, 4)),
])
def test_launch_variables_are_read(launch_env, env, want):
    launch_env(**env)
    assert resolve_launch() == want


@pytest.mark.parametrize("env,names", [
    ({"GS_TPU_COORDINATOR": "127.0.0.1:1234", "GS_TPU_PROCESS_ID": "0"},
     "GS_TPU_NUM_PROCESSES"),
    ({"GS_TPU_COORDINATOR": "127.0.0.1:1234", "GS_TPU_NUM_PROCESSES": "2"},
     "GS_TPU_PROCESS_ID"),
    ({"GS_TPU_COORDINATOR": "127.0.0.1:1234", "GS_TPU_NUM_PROCESSES": "2",
      "GS_TPU_PROCESS_ID": "2"}, r"GS_TPU_PROCESS_ID=2 is outside \[0, 2\)"),
    ({"GS_TPU_COORDINATOR": "127.0.0.1:1234", "GS_TPU_NUM_PROCESSES": "2",
      "GS_TPU_PROCESS_ID": "-1"}, "GS_TPU_PROCESS_ID=-1"),
    ({"GS_TPU_COORDINATOR": "127.0.0.1:1234", "GS_TPU_NUM_PROCESSES": "two",
      "GS_TPU_PROCESS_ID": "0"}, "GS_TPU_NUM_PROCESSES must be an integer"),
    ({"GS_TPU_COORDINATOR": "127.0.0.1:1234", "GS_TPU_NUM_PROCESSES": "0",
      "GS_TPU_PROCESS_ID": "0"}, "GS_TPU_NUM_PROCESSES=0"),
    ({"GS_TPU_COORDINATOR": "127.0.0.1", "GS_TPU_NUM_PROCESSES": "2",
      "GS_TPU_PROCESS_ID": "0"}, "GS_TPU_COORDINATOR must be host:port"),
    ({"GS_TPU_COORDINATOR": "127.0.0.1:99999", "GS_TPU_NUM_PROCESSES": "2",
      "GS_TPU_PROCESS_ID": "0"}, "GS_TPU_COORDINATOR must be host:port"),
    ({"GS_TPU_COORDINATOR": "h:1", "GS_TPU_NUM_PROCESSES": "2",
      "GS_TPU_PROCESS_ID": "0", "LOCAL_RANK": "2",
      "LOCAL_WORLD_SIZE": "2"}, "LOCAL_RANK=2"),
    ({"GS_TPU_DISTRIBUTED": "auto"},
     "MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK, "
     "LOCAL_WORLD_SIZE are not set"),
    (dict(TORCHRUN, GS_TPU_DISTRIBUTED="auto", LOCAL_WORLD_SIZE=""),
     "LOCAL_WORLD_SIZE is not set"),
    (dict(TORCHRUN, GS_TPU_DISTRIBUTED="auto", RANK="8"), "RANK=8"),
    ({"GS_TPU_DISTRIBUTED": "pod"}, "GS_TPU_DISTRIBUTED must be 'auto'"),
])
def test_bad_launch_variables_raise_naming_them(launch_env, env, names):
    launch_env(**env)
    with pytest.raises(SettingsError, match=names):
        resolve_launch()


@pytest.mark.parametrize("kind,cards,local_world,want", [
    ("cpu", 0, 2, [("gloo", []), ("gloo", [])]),
    ("cuda", 1, 1, [("nccl", [0])]),
    ("cuda", 8, 1, [("nccl", list(range(8)))]),
    ("cuda", 1, 2, [("gloo", [0]), ("gloo", [0])]),
    ("cuda", 4, 4, [("nccl", [0]), ("nccl", [1]), ("nccl", [2]),
                    ("nccl", [3])]),
    ("cuda", 4, 2, [("nccl", [0, 1]), ("nccl", [2, 3])]),
    ("cuda", 2, 4, [("gloo", [0]), ("gloo", [0]), ("gloo", [1]),
                    ("gloo", [1])]),
    ("cuda", 3, 2, [("nccl", [0]), ("nccl", [1])]),
])
def test_placement_splits_cards_and_picks_the_backend(kind, cards,
                                                      local_world, want):
    assert [distributed.placement(kind, cards, r, local_world)
            for r in range(local_world)] == want


def test_placement_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA card is visible"):
        distributed.placement("cuda", 0, 0, 2)


def _group(rank=1, world=2, cards=(2, 3), backend="nccl"):
    return distributed.Group(rank=rank, world=world, local_rank=rank,
                             local_world=world, backend=backend,
                             cards=list(cards), store=None, launch_id="0")


@pytest.mark.parametrize("kind,n,want", [
    ("cuda", None, ["cuda:2", "cuda:3"]),
    ("cuda", 4, ["cuda:2", "cuda:2", "cuda:3", "cuda:3"]),
    ("cuda", 1, ["cuda:2"]),
    ("cpu", None, ["cpu"]),
    ("cpu", 4, ["cpu"] * 4),
])
def test_process_devices_repeat_a_card_when_it_has_fewer(monkeypatch, kind,
                                                         n, want):
    monkeypatch.setattr(distributed, "_GROUP", _group())
    assert [str(d) for d in distributed.process_devices(kind, n)] == want
    assert distributed.process_index() == 1
    assert distributed.process_count() == 2
    assert distributed.describe()["backend"] == "nccl"


def test_one_process_reads_as_process_zero_of_one():
    assert distributed.group() is None
    assert (distributed.process_index(), distributed.process_count()) == (
        0, 1)
    assert distributed.block_layout(8) == (8, 0)
    assert distributed.describe() == {"process_index": 0,
                                      "process_count": 1, "backend": None}
    assert distributed.p2p_stats() is None


@pytest.mark.parametrize("dims,n_local,first,processes,ok", [
    ((2, 2, 2), 4, 0, 2, True),
    ((2, 2, 2), 4, 4, 2, True),
    ((2, 2, 2), 4, 2, 2, False),
    ((2, 2, 2), 4, 8, 2, False),
    ((2, 2, 2), 3, 0, 2, False),
    ((2, 2, 2), 4, 0, 1, False),
    ((4, 2, 1), 2, 6, 4, True),
])
def test_mesh_shares_are_contiguous_rank_ranges(dims, n_local, first,
                                                processes, ok):
    if not ok:
        with pytest.raises(ValueError):
            DeviceMesh(dims, ["cpu"] * n_local, first_rank=first,
                       processes=processes)
        return
    mesh = DeviceMesh(dims, ["cpu"] * n_local, first_rank=first,
                      processes=processes)
    assert mesh.n_blocks == n_local
    assert mesh.owner(first) == first // n_local
    assert [mesh.owner(r) for r in range(dims[0] * dims[1] * dims[2])] == [
        r // n_local for r in range(dims[0] * dims[1] * dims[2])]


def test_two_process_mesh_boundary_cuts_x():
    """(2,2,2) over two processes: process 0 holds x = 0, so only the x
    exchange crosses processes."""
    mesh = DeviceMesh((2, 2, 2), ["cpu"] * 4, first_rank=0, processes=2)
    assert {mesh.coords(r)[0] for r in range(4)} == {0}
    assert {mesh.coords(r)[0] for r in range(4, 8)} == {1}


@pytest.mark.parametrize("codes,rc", [
    ([0, 0], 0), ([75, 75], 75), ([0, 75], 75), ([-9, 1], 1),
    ([3, -9], 3), ([-9, -9], 1), ([75, 1], 1),
])
def test_launcher_exit_code(codes, rc):
    assert launch.exit_code(codes) == rc


def test_launcher_usage_error_exits_2(capsys):
    assert launch.main(["2"]) == 2
    assert "usage" in capsys.readouterr().err


def test_launcher_kills_the_survivor_when_one_process_fails(monkeypatch,
                                                            tmp_path):
    """Process 1 exits 1 at once; process 0 would run a minute: the
    launcher kills it and returns within seconds, exiting 1."""
    monkeypatch.setattr(launch, "CHILD", textwrap.dedent("""\
        import os, sys, time
        from grayscott_jl_tpu_torch import launch
        launch.die_with_parent()
        rank = int(os.environ["GS_TPU_PROCESS_ID"])
        assert os.environ["GS_TPU_NUM_PROCESSES"] == "2"
        assert os.environ["LOCAL_WORLD_SIZE"] == "2"
        assert sys.argv[1:] == ["cfg.toml", "4"]
        if rank == 1:
            sys.exit(1)
        time.sleep(60)
        """))
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    t0 = time.monotonic()
    codes = launch.launch(2, "cfg.toml", 4, env=env, cwd=str(tmp_path),
                          timeout=120)
    assert time.monotonic() - t0 < 30
    assert codes[1] == 1 and codes[0] < 0
    assert launch.exit_code(codes) == 1


def test_launcher_passes_the_launch_variables(tmp_path):
    env = launch.process_env(1, 3, 4321, {"PYTHONPATH": "/x",
                                          "GS_TPU_DISTRIBUTED": "auto"})
    assert env["GS_TPU_COORDINATOR"] == "127.0.0.1:4321"
    assert (env["GS_TPU_NUM_PROCESSES"], env["GS_TPU_PROCESS_ID"]) == (
        "3", "1")
    assert (env["LOCAL_RANK"], env["LOCAL_WORLD_SIZE"]) == ("1", "3")
    assert "GS_TPU_DISTRIBUTED" not in env
    assert env["PYTHONPATH"].split(os.pathsep) == [str(REPO), "/x"]


_BUILD = """\
import sys
from grayscott_jl_tpu_torch.models import get_model
from grayscott_jl_tpu_torch.ops import _build, kernelgen
_build.BUILD_DIR = sys.argv[1]
spec = kernelgen.get_spec(get_model("heat"))
out = _build.build_all([spec])
print(out[_build.target_name(spec)]["source"])
"""


def test_two_processes_building_one_kernel_at_once(tmp_path):
    """Each process writes the emitted source and the library under its
    own names and renames them into place: neither reads a file the
    other is writing, and the source left is the emitted one. (The
    compiler here is a stand-in that copies its input after a pause.)"""
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(textwrap.dedent("""\
        #!/bin/sh
        out=""; src=""
        while [ $# -gt 0 ]; do
          case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac
          shift
        done
        sleep 1
        cp "$src" "$out"
        """))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    build = tmp_path / "build"
    env = dict(os.environ, CUDA_HOME=str(cuda), PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
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
    sources = {out.strip() for out, _ in outs}
    assert len(sources) == 1
    from grayscott_jl_tpu_torch.models import get_model
    from grayscott_jl_tpu_torch.ops import _build, kernelgen

    spec = kernelgen.get_spec(get_model("heat"))
    (source,) = sources
    assert Path(source).read_text() == _build.emitted_source(spec)
    left = sorted(p.name for p in build.iterdir())
    assert [n.split(".")[-1] for n in left] == ["cu", "so"], left
    assert Path(source[:-3] + ".so").read_text() == Path(source).read_text()
