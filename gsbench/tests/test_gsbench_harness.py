"""The harness on the CPU: the contract of ``BENCHMARK.json``, cells and
metrics found by name, whole runs of CPU cells through ``gsbench.run``,
the faults the check must catch, the control, and the import rule."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from gsbench import harness, reference, run
from gsbench.tests import support

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
REPO = harness.ROOT


@pytest.fixture
def env():
    """Restore the environment the run scrubs."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return support.make_tree(str(tmp_path_factory.mktemp("tree")))


# ------------------------------------------------------------ the contract


def test_benchmark_json_keeps_the_contract():
    b = harness.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["gsbench"]
    assert b["command"][1:] == ["-m", "gsbench.run"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("gsbench/configs/")
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        harness.load_cell(w["name"])
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in b["workloads"]}
    assert len(harness.load_readers()) == len(b["per_layer"])


def test_full_check_fits_its_time_at_24_cells():
    b = harness.load_benchmark()
    runs = 2 + 14 * 24
    total = runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


# ------------------------------------------------------- found by name


def test_new_cell_and_metric_need_no_edit(tmp_path):
    root = support.make_tree(str(tmp_path))
    before = {p: open(os.path.join(root, "gsbench", p), "rb").read()
              for p in ("harness.py", "run.py", "devtrace.py")}
    with open(os.path.join(root, "gsbench", "workloads", "gs-f32.l128.toml"),
              "w", encoding="utf-8") as f:
        f.write(textwrap.dedent("""\
            config = "gs-f32"
            traffic = "l128"
            L = 128
            processes = 1
            warmup_steps = 3000
            start_steps = 3
            end_steps = 2
            [limits]
            start_max_abs = 1e-3
            end_max_abs = 1e-3
            """))
    with open(os.path.join(root, "gsbench", "metrics", "steps_run.py"), "w",
              encoding="utf-8") as f:
        f.write(textwrap.dedent("""\
            UNIT = "1"
            LAYER = "driver (driver.py)"
            MOVES = "cell_updates_per_s"


            def read(run):
                return float(run["steps"])
            """))
    bench = harness.load_benchmark(root)
    bench["workloads"].append({"name": "gs-f32.l128", "config": "gs-f32",
                               "traffic": "l128", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "steps_run", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "driver (driver.py)",
                               "moves": "cell_updates_per_s"})
    with open(os.path.join(root, "BENCHMARK.json"), "w",
              encoding="utf-8") as f:
        json.dump(bench, f)
    cell = harness.load_cell("gs-f32.l128", root)
    assert (cell.L, cell.config, cell.limits["end_max_abs"]) == (
        128, "gs-f32", 1e-3)
    readers = {r.name: r for r in harness.load_readers(root)}
    assert readers["steps_run"].read({"steps": 7}) == 7.0
    for p, text in before.items():
        assert open(os.path.join(root, "gsbench", p), "rb").read() == text


def test_reader_that_disagrees_with_its_entry_is_refused(tmp_path):
    root = support.make_tree(str(tmp_path))
    bench = harness.load_benchmark(root)
    bench["per_layer"][0]["unit"] = "ms"
    with open(os.path.join(root, "BENCHMARK.json"), "w",
              encoding="utf-8") as f:
        json.dump(bench, f)
    with pytest.raises(ValueError, match="UNIT"):
        harness.load_readers(root)


def test_settings_file_is_the_programs(tmp_path):
    from grayscott_jl_tpu_torch.config.settings import parse_settings_toml

    cell = harness.load_cell("gs-ens5-f32.l256")
    text = harness.settings_toml(dict(cell.settings, L=256, steps=9))
    s = parse_settings_toml(text)
    assert (s.L, s.steps, s.precision, s.noise) == (256, 9, "Float32", 0.01)
    assert s.ensemble.n == 5
    assert s.kernel_language == "CUDA" and s.backend == "CUDA"


# --------------------------------------------------------------- runs


@pytest.mark.parametrize("cell", ["cpu.gs", "cpu.ens", "cpu.mesh"])
def test_cpu_cell_runs_correct(tree, env, monkeypatch, cell):
    if cell == "cpu.mesh":
        support.mesh_of_four(monkeypatch)
    rc, line = support.run_line(tree, cell)
    assert rc == 0 and line["correct"] is True
    assert list(line)[-1] == "checks"
    for key in ("attempted", "failed", "metrics", "device"):
        assert key in line
    assert set(line["metrics"]) == {"cell_updates_per_s", "setup_s"}
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name


def test_each_process_holds_one_block_by_default(tree, env, monkeypatch):
    """The program's default, one block per visible card, would spread a
    one-card cell over every card of a larger machine: the harness asks
    for one block in every call."""
    from grayscott_jl_tpu_torch import driver

    asked = []
    orig = driver.run_once

    def run_once(settings, **kw):
        asked.append(kw.get("n_devices"))
        return orig(settings, **kw)

    monkeypatch.setattr(driver, "run_once", run_once)
    rc, line = support.run_line(tree, "cpu.gs")
    assert rc == 0 and line["correct"] is True
    assert asked and set(asked) == {1}


def test_cpu_cell_traced_line(tree, env):
    rc, line = support.run_line(tree, "cpu.ens", trace=1)
    assert rc == 0 and line["correct"] is True
    # Off the card there is no device trace: only counters and spans.
    assert "kernel_roofline_pct" not in line["metrics"]
    assert "driver_noncompute_pct" in line["metrics"]


def test_cpu_cell_of_four_processes(tree, env):
    rc, line = support.run_line(tree, "cpu.procs", seconds=0.3)
    assert rc == 0 and line["correct"] is True


def test_no_card_exits_2_with_no_result(env, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    rc = run.main(["--workload", "gs-f32.l512", "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    assert rc == 2 and capsys.readouterr().out == ""


def test_bare_tree_exits_nonzero(tmp_path):
    shutil.copytree(os.path.join(REPO, "gsbench"),
                    os.path.join(tmp_path, "gsbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    envv = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "gsbench.run", "--workload",
                        "gs-f32.l512", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=envv,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


# -------------------------------------------------------------- faults


def _fault_unchanged(monkeypatch):
    from grayscott_jl_tpu_torch.simulation import Simulation

    def iterate(self, nsteps=1):
        self.step += nsteps

    monkeypatch.setattr(Simulation, "iterate", iterate)


def _fault_half_members(monkeypatch):
    from grayscott_jl_tpu_torch.simulation import Simulation

    orig = Simulation.iterate

    def iterate(self, nsteps=1):
        kept = [tuple(f[f.shape[0] // 2:].clone() for f in b)
                for b in self.blocks]
        orig(self, nsteps)
        for b, k in zip(self.blocks, kept):
            for f, old in zip(b, k):
                f[f.shape[0] // 2:] = old

    monkeypatch.setattr(Simulation, "iterate", iterate)


def _fault_no_exchange(monkeypatch):
    from grayscott_jl_tpu_torch.parallel.mesh import DeviceMesh

    def ppermute(self, xs, *a, **kw):
        return [None] * len(xs)

    monkeypatch.setattr(DeviceMesh, "ppermute", ppermute)


def _fault_altered(monkeypatch):
    from grayscott_jl_tpu_torch.simulation import Simulation

    orig = Simulation.iterate

    def iterate(self, nsteps=1):
        orig(self, nsteps)
        u = self.blocks[0][0]
        u.view(-1)[u.numel() // 3] += 0.05

    monkeypatch.setattr(Simulation, "iterate", iterate)


#: Steps of the longest call the check replays; a call of more steps
#: is the window's long call (or the warm-up), which it does not.
CHECKED_STEPS = 8


def _counting(monkeypatch, kinds_of):
    """The plain path counts no kernel launches: count one launch a step
    of each kind ``kinds_of(nsteps)`` gives, as the card's kernel path
    counts its own, around each call of the simulation's ``iterate``.
    Each kind is ``(steps run, mode, depth)``."""
    from grayscott_jl_tpu_torch.ops import cuda_stencil as cs
    from grayscott_jl_tpu_torch.simulation import Simulation

    orig = Simulation.iterate

    def iterate(self, nsteps=1):
        for steps, mode, fuse in kinds_of(nsteps):
            orig(self, steps)
            for _ in range(steps // fuse):
                cs.count_launch(mode, "tma", entry="f32", model="grayscott",
                                members=1, fuse=fuse, shape=(16, 16, 16))
        self.step += nsteps - sum(k[0] for k in kinds_of(nsteps))

    monkeypatch.setattr(Simulation, "iterate", iterate)


def _fault_long_call_skips_steps(monkeypatch):
    """A long call runs half its steps and counts them all."""
    _counting(monkeypatch, lambda n: [(n // 2 if n > CHECKED_STEPS else n,
                                       "chain", 1)])


def _fault_long_call_fuses_deeper(monkeypatch):
    """A long call takes another kernel (a deeper chain) than the short
    call that the reference checks."""
    _counting(monkeypatch, lambda n: [(n, "chain", 2 if n > CHECKED_STEPS
                                       else 1)])


@pytest.mark.parametrize("cell,fault", [
    ("cpu.gs", _fault_unchanged), ("cpu.ens", _fault_unchanged),
    ("cpu.ens", _fault_half_members), ("cpu.mesh", _fault_no_exchange),
    ("cpu.gs", _fault_altered), ("cpu.ens", _fault_altered),
    ("cpu.mesh", _fault_altered), ("cpu.gs", _fault_long_call_skips_steps),
    ("cpu.ens", _fault_long_call_skips_steps),
    ("cpu.gs", _fault_long_call_fuses_deeper)])
def test_fault_under_the_timed_path_is_not_correct(tree, env, monkeypatch,
                                                   cell, fault):
    if cell == "cpu.mesh":
        support.mesh_of_four(monkeypatch)
    fault(monkeypatch)
    rc, line = support.run_line(tree, cell)
    assert rc == 0 and line["correct"] is False


def test_long_and_short_calls_counted_alike_are_correct(tree, env,
                                                        monkeypatch):
    """The launch counts of the fault cases, without the fault: the
    harness reads the same launches per step in both calls."""
    _counting(monkeypatch, lambda n: [(n, "chain", 1)])
    rc, line = support.run_line(tree, "cpu.gs")
    assert rc == 0 and line["correct"] is True
    assert line["checks"]["launch_mix_gap"]["value"] == 0.0


def test_launch_mix_gap_reads_launches_per_step():
    k0 = {("entry", "a"): 4}
    k1 = {("entry", "a"): 104, ("load", "tma"): 100}
    k2 = {("entry", "a"): 106, ("load", "tma"): 102}
    assert harness.launch_mix_gap(k0, k1, k2, 100, 2) == 0.0
    k2 = {("entry", "a"): 105, ("entry", "b"): 1, ("load", "tma"): 102}
    assert harness.launch_mix_gap(k0, k1, k2, 100, 2) == 0.5


@pytest.mark.parametrize("card_cell", [
    w["name"] for w in harness.load_benchmark()["workloads"]])
def test_control_fails_the_cells_limits(card_cell):
    """The reference in bfloat16 in the program's place, at a grid a test
    run holds, reads above the card cell's limits."""
    cell = harness.load_cell(card_cell)
    L, seed = 32, 2**31 + 11
    rows = cell.member_rows()
    keys = [(0, seed + m) for m in range(cell.members)]
    init = reference.initial_state(L, cell.members)
    want = reference.advance(init, rows, keys, 0, cell.start_steps)
    low = reference.advance(init, rows, keys, 0, cell.start_steps,
                            dtype=torch.bfloat16)
    assert reference.max_abs_gap(low, want) > cell.limits["start_max_abs"]
    later = reference.advance(want, rows, keys, 500, 40)
    want = reference.advance(later, rows, keys, 540, cell.end_steps)
    low = reference.advance(later, rows, keys, 540, cell.end_steps,
                            dtype=torch.bfloat16)
    assert reference.max_abs_gap(low, want) > cell.limits["end_max_abs"]


# --------------------------------------------------------- import rule


def test_run_loads_neither_jax_nor_the_jax_package(tree):
    code = textwrap.dedent(f"""
        import sys, json
        from gsbench import run
        rc = run.main(["--workload", "cpu.ens", "--seed", "5", "--seconds",
                       "0.2", "--trace", "1"], root={tree!r},
                      require_cards=False)
        top = sorted({{m.split(".")[0] for m in sys.modules}})
        print(json.dumps({{"rc": rc, "top": top}}))
        """)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0
    assert "grayscott_jl_tpu_torch" in got["top"]
    for name in ("jax", "jaxlib", "flax", "grayscott_jl_tpu"):
        assert name not in got["top"]


def test_harness_sources_import_no_jax():
    pat = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|flax|"
                     r"grayscott_jl_tpu)\b", re.M)
    for dirpath, _, files in os.walk(os.path.join(REPO, "gsbench")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name), encoding="utf-8") as f:
                    assert not pat.search(f.read()), name
