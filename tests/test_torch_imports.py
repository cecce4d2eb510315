"""The port stands alone: grayscott_jl_tpu_torch (and chip_smoke.py)
imports neither JAX nor the reference package, and runs with JAX
blocked — on one block and on an 8-block mesh (parallel/mesh.py,
halo.py, temporal.py)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "grayscott_jl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "grayscott_jl_tpu")

PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import grayscott_jl_tpu_torch as gs
names = [m.name for m in pkgutil.walk_packages(gs.__path__, gs.__name__ + ".")]
for name in names:
    importlib.import_module(name)
sim = gs.Simulation(gs.Settings(L=8, backend="CPU", noise=0.1,
                                precision="Float32"))
sim.iterate(3)
u, v = sim.get_fields()
assert u.shape == (8, 8, 8)
mesh = gs.Simulation(gs.Settings(L=8, backend="CPU", noise=0.1,
                                 precision="Float32"), n_devices=8)
mesh.iterate(3)
assert mesh.domain.dims == (2, 2, 2)
for a, b in zip(mesh.get_fields(), (u, v)):
    assert (a == b).all()
leaked = sorted(m for m in sys.modules
                if m == "grayscott_jl_tpu" or m.startswith("grayscott_jl_tpu."))
assert not leaked, leaked
print("ok", len(names))
"""


def test_port_imports_and_runs_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


SOURCES = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_jax_or_reference_imports(path):
    bad = [
        name for name in _imports(path)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


PROBE_CLI = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
from grayscott_jl_tpu_torch.probes import envelope_probe
rows = envelope_probe.run(8, 1, 1, 1, 0.1, cpu=True, variants=True)
leaked = sorted(m for m in sys.modules
                if m == "grayscott_jl_tpu" or m.startswith("grayscott_jl_tpu."))
assert not leaked, leaked
print("ok", len(rows))
"""


def test_envelope_probe_stands_alone():
    """The envelope probe and its kernels' wrappers are in the no-JAX
    check, and the probe runs its every case with JAX blocked."""
    checked = {p.relative_to(REPO).as_posix() for p in SOURCES}
    assert {"grayscott_jl_tpu_torch/ops/envelope.py",
            "grayscott_jl_tpu_torch/probes/envelope_probe.py",
            "grayscott_jl_tpu_torch/probes/__init__.py"} <= checked
    proc = subprocess.run(
        [sys.executable, "-c", PROBE_CLI], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "ok 11"


def test_resilience_and_vtk_stand_alone():
    """The health guard, graceful shutdown and .vti writer are in the
    no-JAX check, and import and run with JAX blocked."""
    checked = {p.relative_to(REPO).as_posix() for p in SOURCES}
    assert {"grayscott_jl_tpu_torch/resilience/__init__.py",
            "grayscott_jl_tpu_torch/resilience/health.py",
            "grayscott_jl_tpu_torch/resilience/faults.py",
            "grayscott_jl_tpu_torch/io/vtk.py"} <= checked
    probe = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import numpy as np, os, tempfile, torch
from grayscott_jl_tpu_torch.io import vtk
from grayscott_jl_tpu_torch.resilience import faults, health
d = tempfile.mkdtemp()
a = np.arange(8, dtype=np.float32).reshape(2, 2, 2)
vtk.write_vti(os.path.join(d, "a.vti"), 2, 0, a, a)
assert (vtk.read_vti(os.path.join(d, "a.vti"))[1]["U"] == a).all()
p = health.device_probe(torch.ones(2, 2, 2), torch.zeros(2, 2, 2))
assert p.tolist() == [1.0, 1.0, 1.0, 0.0, 0.0]
assert faults.EXIT_PREEMPTED == 75
leaked = sorted(m for m in sys.modules
                if m == "grayscott_jl_tpu" or m.startswith("grayscott_jl_tpu."))
assert not leaked, leaked
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "ok"


def test_pipeline_and_integrity_stand_alone():
    """The output pipeline, the native engine's binding and the
    integrity layer are in the no-JAX check, and a run through them
    (depth 2, the native engine, ``GS_CKPT_VERIFY=full``, two replicas,
    the scrubber) works with JAX blocked."""
    checked = {p.relative_to(REPO).as_posix() for p in SOURCES}
    assert {"grayscott_jl_tpu_torch/io/async_writer.py",
            "grayscott_jl_tpu_torch/io/native.py",
            "grayscott_jl_tpu_torch/resilience/integrity.py"} <= checked
    probe = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import os, tempfile
os.environ.update(GS_ASYNC_IO_DEPTH="2", GS_CKPT_VERIFY="full",
                  GS_CKPT_REPLICAS="2", GS_SCRUB="1")
import grayscott_jl_tpu_torch as gs
from grayscott_jl_tpu_torch import driver
from grayscott_jl_tpu_torch.io.bplite import BpReader
d = tempfile.mkdtemp()
s = gs.Settings(L=8, steps=4, plotgap=2, noise=0.1, backend="CPU",
                precision="Float32", checkpoint=True, checkpoint_freq=2,
                output=os.path.join(d, "gs.bp"),
                checkpoint_output=os.path.join(d, "ck.bp"))
driver.run_once(s)
for p in ("gs.bp", "ck.bp", "ck.bp.r1"):
    with BpReader(os.path.join(d, p)) as r:
        assert r.num_steps() == 2, p
from grayscott_jl_tpu_torch.io import native
assert native.available(), native.BUILD_ERROR
leaked = sorted(m for m in sys.modules
                if m == "grayscott_jl_tpu" or m.startswith("grayscott_jl_tpu."))
assert not leaked, leaked
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "ok"


def test_supervisor_watchdog_sdc_and_chaos_stand_alone():
    """The supervisor, watchdog, SDC screen and chaos scenarios are in
    the no-JAX check, and a supervised run with an injected fault and
    the SDC screen works with JAX blocked."""
    checked = {p.relative_to(REPO).as_posix() for p in SOURCES}
    assert {"grayscott_jl_tpu_torch/resilience/supervisor.py",
            "grayscott_jl_tpu_torch/resilience/watchdog.py",
            "grayscott_jl_tpu_torch/resilience/sdc.py",
            "grayscott_jl_tpu_torch/chaos.py"} <= checked
    probe = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import json, os, tempfile
os.environ.update(GS_SUPERVISE="1", GS_RESTART_BACKOFF_S="0",
                  GS_SDC_CHECK="spot",
                  GS_FAULTS="step=3:kind=preempt;step=5:kind=sdc")
import grayscott_jl_tpu_torch as gs
from grayscott_jl_tpu_torch import chaos, driver
d = tempfile.mkdtemp()
cfg = chaos.write_config(d, backend="CPU", L=8, steps=8, plotgap=2,
                         checkpoint_freq=2)
driver.main([cfg])
events = [json.loads(x)["event"] for x in open(os.path.join(d, "gs.bp.faults.jsonl"))]
assert events.count("recovery") == 2, events
leaked = sorted(m for m in sys.modules
                if m == "grayscott_jl_tpu" or m.startswith("grayscott_jl_tpu."))
assert not leaked, leaked
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_reshard_stands_alone():
    """The layout plan, the restore and the live move are in the no-JAX
    check (the port keeps its own copy of the reference's JAX-free
    ``reshard/plan.py``), and a restore onto another mesh and a live
    move work with JAX blocked."""
    checked = {p.relative_to(REPO).as_posix() for p in SOURCES}
    assert {"grayscott_jl_tpu_torch/reshard/__init__.py",
            "grayscott_jl_tpu_torch/reshard/plan.py",
            "grayscott_jl_tpu_torch/reshard/restore.py"} <= checked
    probe = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import dataclasses, os, tempfile
import grayscott_jl_tpu_torch as gs
from grayscott_jl_tpu_torch import driver
from grayscott_jl_tpu_torch.reshard import plan, restore
d = tempfile.mkdtemp()
s = gs.Settings(L=8, steps=4, plotgap=2, noise=0.1, backend="CPU",
                precision="Float32", checkpoint=True, checkpoint_freq=2,
                output=os.path.join(d, "gs.bp"),
                checkpoint_output=os.path.join(d, "ck.bp"),
                restart_input=os.path.join(d, "ck.bp"))
driver.run_once(s, n_devices=8)
r = dataclasses.replace(s, restart=True, restart_step=2,
                        output=os.path.join(d, "r.bp"))
moved = driver.run_once(r)
assert moved.reshard["old"]["mesh_dims"] == [2, 2, 2], moved.reshard
sim = gs.Simulation(s, n_devices=8)
sim.iterate(2)
target, p = restore.reshape_live(sim, mesh_dims=(1, 2, 2))
assert p.changed and target.reshard["path"] == "collective"
leaked = sorted(m for m in sys.modules
                if m == "grayscott_jl_tpu" or m.startswith("grayscott_jl_tpu."))
assert not leaked, leaked
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


AUTO_MODULES = ("parallel/icimodel.py", "probes/fabric.py",
                "utils/benchmark.py", "tune/__init__.py", "tune/cache.py",
                "tune/candidates.py", "tune/measure.py", "tune/autotuner.py")


@pytest.mark.parametrize("rel", AUTO_MODULES)
def test_the_auto_modules_are_checked(rel):
    """Auto's decision (the fabric model, its probe, the timing
    discipline and the tuner) is among the sources held to the rule."""
    assert PACKAGE / rel in SOURCES


ENSEMBLE_MODULES = ("ensemble/__init__.py", "ensemble/spec.py",
                    "ensemble/engine.py", "ensemble/io.py")


@pytest.mark.parametrize("rel", ENSEMBLE_MODULES)
def test_the_ensemble_modules_are_checked(rel):
    """The ensemble package (the port's own copies of the reference's
    JAX-free ``spec.py`` and ``io.py``, and the engine) is among the
    sources held to the rule."""
    assert PACKAGE / rel in SOURCES


def test_ensemble_stands_alone():
    """An ensemble run through the driver, its member stores and a grown
    resume work with JAX blocked."""
    probe = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import dataclasses, os, tempfile
import grayscott_jl_tpu_torch as gs
from grayscott_jl_tpu_torch import driver
from grayscott_jl_tpu_torch.config.settings import parse_settings_toml
d = tempfile.mkdtemp()
s = parse_settings_toml(f'''
L = 8
steps = 4
plotgap = 2
noise = 0.1
backend = "CPU"
precision = "Float32"
checkpoint = true
checkpoint_freq = 2
output = "{d}/gs.bp"
checkpoint_output = "{d}/ck.bp"
restart_input = "{d}/ck.bp"
[ensemble]
presets = ["spots", "chaos"]
''')
sim = driver.run_once(s, n_devices=8)
assert sim.n_members == 2 and sim.domain.dims == (2, 2, 2)
assert all(os.path.isdir(f"{d}/{n}") for n in
           ("gs.m00.bp", "gs.m01.bp", "ck.m00.bp", "ck.m01.bp"))
r = dataclasses.replace(s, restart=True, restart_step=2)
from grayscott_jl_tpu_torch.ensemble import spec
r.ensemble = spec.from_toml({"presets": ["spots", "chaos", "waves"]}, r)
grown = driver.run_once(r)
assert grown.reshard["members"]["grown"] == 1, grown.reshard
leaked = sorted(m for m in sys.modules
                if m == "grayscott_jl_tpu" or m.startswith("grayscott_jl_tpu."))
assert not leaked, leaked
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


OBS_MODULES = ("obs/xstats.py", "obs/report.py", "obs/trace.py",
               "utils/profiler.py")


@pytest.mark.parametrize("rel", OBS_MODULES)
def test_the_observability_modules_are_checked(rel):
    """Build and launch analytics, the run report and the profiler
    captures are among the sources held to the rule."""
    assert PACKAGE / rel in SOURCES


def test_member_groups_across_processes_stand_alone(tmp_path):
    """Two processes of a member_shards = 2 ensemble over gloo, one
    group each, with the analytics and a profiler window armed, run
    with JAX blocked in every process; the report checks the stats."""
    worker = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
from grayscott_jl_tpu_torch import driver
from grayscott_jl_tpu_torch.config.settings import get_settings
sim = driver.run_once(get_settings([sys.argv[1]]), n_devices=1)
assert sim.member_shards == 2 and len(sim.mesh.held) == 1
leaked = sorted(m for m in sys.modules
                if m == "grayscott_jl_tpu" or m.startswith("grayscott_jl_tpu."))
assert not leaked, leaked
print("ok")
"""
    from grayscott_jl_tpu_torch import launch

    cfg = tmp_path / "c.toml"
    cfg.write_text(f"""L = 8
steps = 4
plotgap = 2
noise = 0.1
backend = "CPU"
precision = "Float32"
kernel_language = "Pallas"
output = "{tmp_path}/gs.bp"
[ensemble]
presets = ["spots", "chaos"]
member_shards = 2
""")
    port = launch.free_port()
    env = {k: v for k, v in __import__("os").environ.items()
           if not k.startswith(("GS_", "LOCAL_"))}
    env.update(PYTHONPATH=str(REPO), GS_XSTATS="1", GS_PROFILE="0:2",
               GS_PROFILE_DIR=str(tmp_path / "prof"),
               GS_TPU_STATS=str(tmp_path / "stats.json"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(cfg)], cwd=tmp_path,
        env=launch.process_env(r, 2, port, env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert out.strip().splitlines()[-1] == "ok"
    assert sorted(x.name for x in (tmp_path / "prof").iterdir()) == [
        "profile_0_2.json.rank0", "profile_0_2.json.rank1"]
    for rank in range(2):
        proc = subprocess.run(
            [sys.executable, "-c", "import sys; sys.modules['jax'] = None; "
             "from grayscott_jl_tpu_torch.obs import report; "
             "sys.exit(report.main(sys.argv[1:]))", "--check", "--stats",
             str(tmp_path / f"stats.json.rank{rank}")],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr


SERVE_MODULES = ("serve/__init__.py", "serve/__main__.py",
                 "serve/protocol.py", "serve/cache.py", "serve/scheduler.py",
                 "serve/worker.py", "serve/server.py", "serve/cluster.py",
                 "serve/elastic.py")


@pytest.mark.parametrize("rel", SERVE_MODULES)
def test_the_serve_modules_are_checked(rel):
    """The serving package (the port's own copies of the reference's
    stdlib modules over the port's config, ensemble, io, obs and
    resilience) is among the sources held to the rule."""
    assert PACKAGE / rel in SOURCES


def test_a_service_runs_with_jax_blocked(tmp_path):
    """An in-process service on the CPU (one job, L=8) runs to a
    complete, cached job with JAX blocked."""
    probe = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
from grayscott_jl_tpu_torch import chaos
from grayscott_jl_tpu_torch.serve.scheduler import ServeConfig
from grayscott_jl_tpu_torch.serve.server import ServeService
svc = ServeService(ServeConfig(port=0, pack_window_s=0.0, supervise=False,
                               state_dir=sys.argv[1], backend="CPU")).start()
try:
    base = f"http://127.0.0.1:{svc.port}"
    spec = {"tenant": "a", "L": 8, "steps": 4, "plotgap": 2, "noise": 0.1}
    job = chaos.post(base, "/v1/jobs", spec)["job"]
    record, = chaos.wait_terminal(base, [job])
    assert record["state"] == "complete", record
    assert chaos.post(base, "/v1/jobs", spec)["cache"] == "hit"
finally:
    svc.close()
leaked = sorted(m for m in sys.modules
                if m == "grayscott_jl_tpu" or m.startswith("grayscott_jl_tpu."))
assert not leaked, leaked
print("ok")
"""
    env = {k: v for k, v in __import__("os").environ.items()
           if not k.startswith("GS_")}
    env.update(PYTHONPATH=str(REPO), GS_EVENTS=str(tmp_path / "ev.jsonl"))
    proc = subprocess.run([sys.executable, "-c", probe, str(tmp_path / "st")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


ANALYSIS_LINT_MODULES = (
    "analysis/__init__.py", "analysis/decomp.py", "analysis/gdsplot.py",
    "analysis/pdfcalc.py", "lint/__init__.py", "lint/__main__.py",
    "lint/astutil.py", "lint/context.py", "lint/donation.py",
    "lint/env_knobs.py", "lint/events_schema.py", "lint/layering.py",
    "lint/purity.py", "lint/trace_safety.py")


@pytest.mark.parametrize("rel", ANALYSIS_LINT_MODULES)
def test_the_analysis_and_lint_modules_are_checked(rel):
    """The analysis workflow and the port's gslint are among the sources
    held to the rule."""
    assert PACKAGE / rel in SOURCES


def test_analysis_runs_with_jax_blocked(tmp_path):
    """A CPU run (L=8), pdfcalc over its store on the CPU, a slice and
    the decomposition, with JAX blocked."""
    probe = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import grayscott_jl_tpu_torch as gs
from grayscott_jl_tpu_torch import driver
from grayscott_jl_tpu_torch.analysis import decomp, gdsplot, pdfcalc
from grayscott_jl_tpu_torch.config.settings import get_settings
driver.run_once(get_settings([sys.argv[1]]))
n = pdfcalc.read_data_write_pdf(sys.argv[2] + "/gs.bp", sys.argv[2] + "/pdf.bp",
                                16, device="cpu")
assert n == 2, n
assert gdsplot.load_slice(sys.argv[2] + "/pdf.bp", "U/pdf", axis="x",
                          index=0).shape == (16,)
assert "mesh dims" in decomp.describe(8, 8)
leaked = sorted(m for m in sys.modules
                if m == "grayscott_jl_tpu" or m.startswith("grayscott_jl_tpu."))
assert not leaked, leaked
print("ok")
"""
    cfg = tmp_path / "c.toml"
    cfg.write_text(f"""L = 8
steps = 4
plotgap = 2
noise = 0.1
backend = "CPU"
precision = "Float32"
output = "{tmp_path}/gs.bp"
""")
    env = {k: v for k, v in __import__("os").environ.items()
           if not k.startswith("GS_")}
    env.update(PYTHONPATH=str(REPO),
               GS_AUTOTUNE_CACHE=str(tmp_path / "tune"))
    proc = subprocess.run(
        [sys.executable, "-c", probe, str(cfg), str(tmp_path)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_adios2_engine_stands_alone():
    """``io.adios`` and ``io.sidecar`` are in the no-JAX check and import
    without JAX, the reference package and the adios2 bindings: the
    engine is then unavailable and output stays on BP-lite. No module of
    the package reaches the API fake under ``tests/support``."""
    checked = {p.relative_to(REPO).as_posix() for p in SOURCES}
    assert {"grayscott_jl_tpu_torch/io/adios.py",
            "grayscott_jl_tpu_torch/io/sidecar.py"} <= checked
    probe = r"""
import sys
for name in ("jax", "jaxlib", "grayscott_jl_tpu", "adios2"):
    sys.modules[name] = None
import os, tempfile
from grayscott_jl_tpu_torch.io import adios, open_reader, open_writer, sidecar
assert not adios.available()
d = tempfile.mkdtemp()
w = open_writer(os.path.join(d, "gs.bp"))
assert w.engine in ("native", "python"), w.engine
w.close()
assert sidecar.read_keep_base(os.path.join(d, "gs.bp")) is None
leaked = sorted(m for m in sys.modules if m.startswith("grayscott_jl_tpu.")
                or m.startswith("adios2") and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "ok"
    reach = [p.relative_to(REPO).as_posix()
             for p in sorted(PACKAGE.rglob("*.py"))
             if "tests/support" in p.read_text()
             or "adios2_fake" in p.read_text()]
    assert not reach, reach
