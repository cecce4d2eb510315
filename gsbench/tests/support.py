"""A copy of the benchmark's tree with cells that run on the CPU.

Each test cell is the matching card cell's configuration with
``backend = "CPU"`` and ``kernel_language = "Plain"`` (the program's
plain path, which the reference equals bit for bit), at a grid a test
run holds, with the card cell's limits.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import tomllib

from gsbench import harness, run

#: name -> (card cell whose config and limits it takes, L, processes).
#: ``cpu.mesh`` is ``cpu.gs`` again, run under :func:`mesh_of_four`.
CPU_CELLS = {
    "cpu.gs": ("gs-f32.l512", 16, 1),
    "cpu.ens": ("gs-ens5-f32.l256", 16, 1),
    "cpu.mesh": ("gs-f32.l512", 16, 1),
    "cpu.procs": ("gs-f32.l512", 16, 4),
}


def mesh_of_four(monkeypatch) -> None:
    """Have the run's process hold four blocks of the grid (the harness
    asks the program for one), so that the exchange between blocks is on
    the timed path."""
    from grayscott_jl_tpu_torch import driver

    orig = driver.run_once

    def run_once(settings, **kw):
        return orig(settings, **{**kw, "n_devices": 4})

    monkeypatch.setattr(driver, "run_once", run_once)


#: The stand-in for ``python -m gsbench.run`` in a patched cell's
#: processes, and the variable that names its patch.
CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "patched_child.py")
PATCH_ENV = "GSBENCH_TEST_PATCH"


def patch_children(monkeypatch, patch: str) -> None:
    """Start each process of a cell of several through
    :data:`CHILD` with ``patch`` (see its docstring) applied."""
    monkeypatch.setenv(PATCH_ENV, patch)
    orig = subprocess.Popen

    def popen(cmd, *a, **kw):
        if list(cmd[1:3]) == ["-m", "gsbench.run"]:
            cmd = [cmd[0], CHILD, *cmd[3:]]
        return orig(cmd, *a, **kw)

    monkeypatch.setattr(run.subprocess, "Popen", popen)


def _toml_line(k, v) -> str:
    return f"{k} = {harness._toml_value(v)}"


def make_tree(dst: str) -> str:
    """``dst`` holding ``BENCHMARK.json`` and ``gsbench/`` with the CPU
    cells added as files and entries; returns ``dst``."""
    shutil.copytree(os.path.join(harness.ROOT, "gsbench"),
                    os.path.join(dst, "gsbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = harness.load_benchmark()
    for name, (card, L, procs) in CPU_CELLS.items():
        src = harness.load_cell(card)
        config = f"cpu-{src.config}"
        cfg_path = os.path.join(dst, "gsbench", "configs", f"{config}.toml")
        if not os.path.exists(cfg_path):
            with open(os.path.join(harness.ROOT, "gsbench", "configs",
                                   f"{src.config}.toml"), "rb") as f:
                cfg = tomllib.load(f)
            s = dict(cfg["settings"], backend="CPU", kernel_language="Plain")
            body = harness.settings_toml(
                {k: v for k, v in s.items() if k != "ensemble"})
            ens = s.get("ensemble")
            text = "[settings]\n" + body
            if ens:
                text += "[settings.ensemble]\n" + "".join(
                    _toml_line(k, v) + "\n" for k, v in ens.items()
                    if k != "member")
                for m in ens["member"]:
                    text += "[[settings.ensemble.member]]\n" + "".join(
                        _toml_line(k, v) + "\n" for k, v in m.items())
            with open(cfg_path, "w", encoding="utf-8") as f:
                f.write(text)
            bench["configs"].append({
                "name": config, "source": "test", "file":
                f"gsbench/configs/{config}.toml", "reduced": [],
                "why": "test"})
        lines = [_toml_line("config", config), _toml_line("traffic", name),
                 _toml_line("L", L), _toml_line("processes", procs),
                 _toml_line("warmup_steps", 20),
                 _toml_line("start_steps", src.start_steps),
                 _toml_line("end_steps", src.end_steps), "[limits]"]
        lines += [_toml_line(k, v) for k, v in src.limits.items()]
        with open(os.path.join(dst, "gsbench", "workloads", f"{name}.toml"),
                  "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": name, "chips": 1,
                                   "why": "test"})
    with open(os.path.join(dst, "BENCHMARK.json"), "w",
              encoding="utf-8") as f:
        json.dump(bench, f, indent=1)
    return dst


def run_line(root: str, cell: str, *, seed=2**31 + 7, seconds=0.3,
             trace=0):
    """``gsbench.run.main`` on a CPU cell in this process: its exit code
    and its result object (None when it printed none). Sets
    ``PYTHONPATH``: restore the environment after it."""
    # The tree holds no program: its processes find it on the path.
    os.environ["PYTHONPATH"] = harness.ROOT + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else "")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)], root=root,
                      require_cards=False)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
