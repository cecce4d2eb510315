"""The port's gslint (grayscott_jl_tpu_torch/lint/): every pass has a
fixture that makes it fire and one that keeps it silent; the passes
whose contract the two packages share (purity, env-knobs, event-schema,
layering's model isolation and literal scan) give the reference's
findings on the same fixture written under each package's name; the
machinery (unknown pass, baseline, JSON document, CLI exit codes); the
self-check over the port; and the lint package importing with torch and
JAX both blocked. Fixture trees mimic the package layout under
tmp_path because the passes key on module paths."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from grayscott_jl_tpu import lint as ref_lint
from grayscott_jl_tpu_torch import lint
from grayscott_jl_tpu_torch.lint import findings_to_json, layering, run_lint

REPO = Path(__file__).resolve().parents[1]
PKG = "grayscott_jl_tpu_torch"
REF_PKG = "grayscott_jl_tpu"

#: The port's lint surface (the CLI's default targets).
TARGETS = [PKG, "chip_smoke.py"]

#: The registry file of each package's event-schema pass.
REGISTRY = {PKG: f"{PKG}/obs/report.py", REF_PKG: "scripts/gs_report.py"}


def make_repo(tmp_path, files, docs=None, name="repo"):
    """Write ``files`` (relpath -> source) and ``docs`` under a fresh
    fixture root and return it."""
    root = tmp_path / name
    for rel, src in {**files, **(docs or {})}.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    return str(root)


def lint_pass(root, pass_id, targets=(PKG,)):
    return run_lint(root, list(targets), select=[pass_id])


# ------------------------------------------- the contracts both share

#: pass id -> fixture case -> ({relpath with {pkg}: source}, docs).
SHARED = {
    "purity": {
        "impure": ({"{pkg}/models/evil.py": """
import os

def reaction(fields, laps, noise, params):
    gain = float(os.environ.get("MY_GAIN", "1.0"))
    print("gain", gain)
    return tuple(f * gain for f in fields)

def init(L, dtype, offsets, sizes):
    global CACHE
    with open("/tmp/seed.bin", "rb") as f:
        return f.read()
"""}, None),
        "pure": ({"{pkg}/models/nice.py": """
SEED_HALF_WIDTH = 4
U_BOUNDARY = 1.0

def _poly(u, v):
    return u * v * v

def reaction(fields, laps, noise, params):
    u, v = fields
    return (-_poly(u, v), _poly(u, v))

def init(L, dtype, offsets, sizes):
    return None

def dump_debug(path):
    print("debug", path)
"""}, None),
    },
    "layering": {
        "ops_imports_model": ({
            "{pkg}/ops/custom.py": """
from ..models import grayscott

def fused(u):
    from ..models.grayscott import MODEL
    return u + grayscott.U_BOUNDARY
""",
            "{pkg}/models/grayscott.py": "U_BOUNDARY = 1.0\n",
        }, None),
        "parallel_literals": ({"{pkg}/parallel/custom.py": """
U_BOUNDARY = 1.0
SEED_U = 0.5

def exchange(u):
    return u + U_BOUNDARY
"""}, None),
        "ops_model_base": ({"{pkg}/ops/generic.py": """
import {pkg}.models.base as protocol

def step(u, model):
    assert isinstance(model, protocol.Model)
    return model.reaction(u)
"""}, None),
    },
    "env-knobs": {
        "undocumented": ({"{pkg}/config/extra.py": """
import os

def resolve_widget():
    return os.environ.get("GS_WIDGET", "")
"""}, {"README.md": "no knob table here\n"}),
        "dead": ({"{pkg}/config/extra.py": """
import os

def resolve_widget():
    return os.environ.get("GS_WIDGET", "")
"""}, {"README.md": "`GS_WIDGET` and `GS_GHOST_KNOB` (read nowhere).\n"}),
        "raw_read": ({"{pkg}/ops/hot.py": """
import os

def hot_loop():
    return os.environ.get("GS_WIDGET", "")
"""}, {"README.md": "Knobs: `GS_WIDGET` toggles the widget.\n"}),
        "settings_module": ({"{pkg}/config/settings.py": """
import os

def widget_mode(settings):
    return os.environ.get("GS_WIDGET")
"""}, {"README.md": "Knobs: `GS_WIDGET` toggles the widget.\n"}),
        "family": ({"{pkg}/config/extra.py": """
import os

def resolve_phase_deadline(phase):
    key = f"GS_WIDGET_{phase.upper()}_S"
    return os.environ.get(key)
"""}, {"README.md": "Per-phase knobs: `GS_WIDGET_<PHASE>_S` (seconds).\n"}),
    },
    "event-schema": {
        "no_registry": ({"{pkg}/obs/custom_events.py": """
def tell(stream):
    stream.emit("zap", value=1)
"""}, None),
        "unregistered_and_dead": ({
            "{pkg}/obs/custom_events.py": """
def tell(stream):
    stream.emit("zap", value=1)
""",
            "{pkg}/resilience/custom.py": """
def fail(journal):
    journal.record(event="boom", step=3)
    event = {"event": "hang", "step": 4}
    journal.record(**event)
""",
            "{registry}": """
EVENT_KIND_SCHEMA = {
    "zap": ("value",),
    "unemitted": (),
}
""",
        }, None),
        "synced": ({
            "{pkg}/obs/custom_events.py": """
def tell(stream):
    stream.emit("zap", value=1)
""",
            "{registry}": 'EVENT_KIND_SCHEMA = {\n    "zap": ("value",),\n}\n',
        }, None),
    },
}

#: Shared cases that must stay silent in both packages.
SILENT = {("purity", "pure"), ("layering", "ops_model_base"),
          ("env-knobs", "settings_module"), ("env-knobs", "family"),
          ("event-schema", "synced")}


def _normalized(found, pkg):
    out = []
    for f in found:
        text = (f"{f.path}|{f.line}|{f.pass_id}|{f.severity}|"
                f"{f.message}").replace(REGISTRY[pkg], "REGISTRY")
        out.append(text.replace(pkg, "PKG"))
    return out


@pytest.mark.parametrize(
    "pass_id,case",
    [(p, c) for p, cases in SHARED.items() for c in cases],
)
def test_shared_contract_gives_the_reference_findings(tmp_path, pass_id,
                                                      case):
    files, docs = SHARED[pass_id][case]
    results = {}
    for pkg, module in ((PKG, lint), (REF_PKG, ref_lint)):
        tree = {rel.format(pkg=pkg, registry=REGISTRY[pkg]):
                src.replace("{pkg}", pkg) for rel, src in files.items()}
        root = make_repo(tmp_path, tree, docs, name=pkg)
        found = module.run_lint(root, [pkg], select=[pass_id])
        results[pkg] = sorted(_normalized(found, pkg))
    assert results[PKG] == results[REF_PKG]
    assert bool(results[PKG]) == ((pass_id, case) not in SILENT)


# --------------------------------------------------------- trace-safety

HAZARDS = {
    "item": "y = fields[0].item()",
    "tolist": "y = fields[0].tolist()",
    "cpu": "y = fields[0].cpu()",
    "numpy": "y = fields[0].numpy()",
    "cuda_sync": "torch.cuda.synchronize()",
    "event_sync": "done.synchronize()",
    "asarray": "y = np.asarray(fields[0])",
    "print": "print(fields)",
    "clock": "t = time.perf_counter()",
    "float_param": "y = float(fields)",
}


def _stencil(body):
    return f"""
import time

import numpy as np
import torch

def fused_step(fields, params, seeds, *, spec, fuse: int = 1, done=None):
    _launch(fields, int(fuse))
    return fields

def _launch(fields, fuse: int):
    {body}
    return fields
"""


@pytest.mark.parametrize("hazard", sorted(HAZARDS))
def test_trace_safety_fires_on_each_hazard(tmp_path, hazard):
    root = make_repo(tmp_path, {
        f"{PKG}/ops/cuda_stencil.py": _stencil(HAZARDS[hazard])})
    found = lint_pass(root, "trace-safety")
    assert len(found) == 1, found
    assert found[0].path == f"{PKG}/ops/cuda_stencil.py"
    assert found[0].line == 12 and "per-step '_launch'" in found[0].message


def test_trace_safety_follows_the_sharded_run_and_imports(tmp_path):
    """The sharded run's closures are roots; a helper imported from
    another module is followed into it."""
    root = make_repo(tmp_path, {
        f"{PKG}/simulation.py": """
from .ops.noise import unit_noise

class Simulation:
    def _sharded_run(self, blocks, nsteps):
        def chain(b):
            return unit_noise(b)
        return [chain(b) for b in blocks]
""",
        f"{PKG}/ops/noise.py": """
def unit_noise(block):
    return block.sum().item()
""",
    })
    found = lint_pass(root, "trace-safety")
    assert [(f.path, f.line) for f in found] == [(f"{PKG}/ops/noise.py", 3)]


def test_trace_safety_silent_on_host_code_and_shadowed_names(tmp_path):
    """float()/int() of a parameter annotated as a number, host code no
    root reaches, a local name that shadows a method, and a host-only
    subpackage stay silent."""
    root = make_repo(tmp_path, {
        f"{PKG}/simulation.py": """
def base_key(seed: int):
    return 0, int(seed)

class FieldSnapshot:
    def blocks(self):
        return self.host.numpy()

class Simulation:
    def _block_run(self, fields, nsteps: int):
        blocks = [fields]
        n = int(nsteps)
        return base_key(n), blocks

    def report(self, stats):
        print("mean:", float(stats["mean"]))
""",
        f"{PKG}/analysis/pdf.py": """
def fused_step(x):
    return x.cpu().numpy()
""",
    })
    assert lint_pass(root, "trace-safety") == []


def test_trace_safety_suppression(tmp_path):
    src = _stencil("y = fields[0].item()  # gslint: disable=trace-safety "
                   "— a deliberate host read")
    root = make_repo(tmp_path, {f"{PKG}/ops/cuda_stencil.py": src})
    assert lint_pass(root, "trace-safety") == []


def test_trace_safety_reports_a_missing_declared_root(tmp_path):
    """Linting the pass's own module checks that every declared root
    still exists, so a rename cannot empty the pass."""
    root = make_repo(tmp_path, {
        f"{PKG}/__init__.py": "",
        f"{PKG}/lint/trace_safety.py": "",
        f"{PKG}/ops/cuda_stencil.py": _stencil("return fields"),
    })
    found = lint_pass(root, "trace-safety")
    missing = {f.message.split()[3] for f in found}
    assert f"{PKG}.ops.cuda_stencil.fused_step" not in missing
    assert f"{PKG}.simulation.Simulation._block_run" in missing
    assert len(found) == 6


# ------------------------------------------------------------- purity

def test_purity_fires_on_env_io_and_globals(tmp_path):
    files, _ = SHARED["purity"]["impure"]
    root = make_repo(tmp_path, {k.format(pkg=PKG): v
                                for k, v in files.items()})
    msgs = "\n".join(f.message for f in lint_pass(root, "purity"))
    for word in ("os.environ", "print()", "open()", "mutates module globals"):
        assert word in msgs


def test_purity_silent_on_pure_declaration(tmp_path):
    files, _ = SHARED["purity"]["pure"]
    root = make_repo(tmp_path, {k.format(pkg=PKG): v
                                for k, v in files.items()})
    assert lint_pass(root, "purity") == []


# ----------------------------------------------------------- layering

@pytest.mark.parametrize("rel,src", [
    (f"{PKG}/obs/probe.py", "def f():\n    import jax\n    return jax\n"),
    (f"{PKG}/simulation.py", "import jaxlib\n"),
    (f"{PKG}/io/reader.py", "from grayscott_jl_tpu.io import bplite\n"),
    ("chip_smoke.py", "def main():\n    from grayscott_jl_tpu import driver\n"),
])
def test_layering_fires_on_jax_or_reference_imports(tmp_path, rel, src):
    root = make_repo(tmp_path, {rel: src})
    found = lint_pass(root, "layering", targets=(rel.split("/")[0],))
    assert len(found) == 1 and "neither JAX" in found[0].message


def test_layering_allows_the_port_itself(tmp_path):
    root = make_repo(tmp_path, {
        "chip_smoke.py": "import grayscott_jl_tpu_torch as gs\n"})
    assert lint_pass(root, "layering", targets=("chip_smoke.py",)) == []


@pytest.mark.parametrize("rel,src,word", [
    (f"{PKG}/config/extra.py", "import torch\n", "without torch"),
    (f"{PKG}/lint/extra.py", "from triton import language\n",
     "without torch"),
    (f"{PKG}/analysis/decomp.py", "from ..simulation import Simulation\n",
     "outside the torch-free set"),
    (f"{PKG}/io/bplite.py", "from . import checkpoint\n",
     "outside the torch-free set"),
])
def test_layering_fires_when_a_torch_free_module_pulls_torch(
        tmp_path, rel, src, word):
    root = make_repo(tmp_path, {rel: src,
                                f"{PKG}/simulation.py": "import torch\n",
                                f"{PKG}/io/checkpoint.py": "import torch\n"})
    found = lint_pass(root, "layering")
    assert [f.path for f in found] == [rel] and word in found[0].message


def test_layering_allows_lazy_torch_and_torch_free_siblings(tmp_path):
    root = make_repo(tmp_path, {
        f"{PKG}/obs/probe.py": """
from typing import TYPE_CHECKING

import numpy as np

from ..config.env import env_str
from ..io import open_reader

if TYPE_CHECKING:
    import torch

def capture():
    import torch

    return torch.zeros(1), np.zeros(1), env_str, open_reader
""",
        f"{PKG}/config/env.py": "import os\n",
        f"{PKG}/io/__init__.py": "def open_reader(path):\n    return path\n",
        f"{PKG}/ops/cuda_stencil.py": "import torch\n",
    })
    assert lint_pass(root, "layering") == []


def test_the_torch_free_set_imports_without_torch():
    """Every module the layering pass declares torch-free imports with
    torch (and JAX) blocked."""
    names = sorted(layering.TORCHFREE_EXACT) + [
        f"{p}.{m.stem}" for p in layering.TORCHFREE_PREFIXES
        for m in sorted((REPO / p.replace(".", "/")).glob("*.py"))
        if m.stem != "__init__"]
    code = (
        "import importlib, sys\n"
        "sys.modules['torch'] = None\n"
        "sys.modules['jax'] = None\n"
        "bad = []\n"
        f"for name in {names!r}:\n"
        "    try:\n"
        "        importlib.import_module(name)\n"
        "    except ImportError as e:\n"
        "        bad.append((name, str(e)))\n"
        "print(bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    assert {f"{PKG}.lint.layering", f"{PKG}.analysis.decomp"} <= set(names)


# ----------------------------------------------------------- env-knobs

def test_env_knobs_declared_gaps(tmp_path):
    """A knob of NOT_READ that the docs list and the port does not read
    is no dead knob; one the port reads is a stale entry."""
    docs = {"README.md": "`GS_WIDGET`, `GS_BX` and `GS_BENCH_ROUNDS`.\n"}
    reader = ("import os\n\ndef resolve_widget():\n"
              "    return os.environ.get(\"GS_WIDGET\")\n")
    root = make_repo(tmp_path, {f"{PKG}/config/extra.py": reader}, docs)
    assert lint_pass(root, "env-knobs") == []
    reads_bx = reader + "\ndef resolve_bx():\n    return os.environ.get(\"GS_BX\")\n"
    root = make_repo(tmp_path, {f"{PKG}/config/extra.py": reads_bx}, docs,
                     name="stale")
    found = lint_pass(root, "env-knobs")
    assert len(found) == 1 and "declared as not read" in found[0].message


def test_env_knobs_undocumented_dead_and_raw(tmp_path):
    for case, word in (("undocumented", "no knob table"),
                       ("dead", "GS_GHOST_KNOB"),
                       ("raw_read", "outside a resolver")):
        files, docs = SHARED["env-knobs"][case]
        root = make_repo(tmp_path, {k.format(pkg=PKG): v
                                    for k, v in files.items()}, docs,
                         name=case)
        found = lint_pass(root, "env-knobs")
        assert any(word in f.message for f in found), (case, found)


# ------------------------------------------------------------ donation

DONATION = {
    "build_in_for": ("""
from . import _build

def warm(specs):
    for spec in specs:
        _build.load(spec)
""", "inside a loop"),
    "compile_in_while": ("""
import torch

def warm(fn, n):
    while n:
        fn = torch.compile(fn)
        n -= 1
""", "inside a loop"),
    "graph_in_for": ("""
import torch

def capture(fns):
    for fn in fns:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
""", "inside a loop"),
    "read_after_reuse": ("""
def snap(ring, src):
    slot = ring.take()
    buf = ring.buffer(slot, "u", src)
    buf.copy_(src)
    other = ring.buffer(ring.take(), "u", src)
    return buf, other
""", "read again here"),
}

DONATION_SILENT = {
    "build_outside_loop": """
import re

from . import _build

def warm(specs):
    lib = _build.load(specs[0])
    for spec in specs:
        re.compile(spec)
        def later():
            return _build.load(spec)
    return lib, later
""",
    "rebind_after_take": """
def snap(ring, src):
    buf = ring.buffer(ring.take(), "u", src)
    buf.copy_(src)
    buf = ring.buffer(ring.take(), "u", src)
    return buf
""",
}


@pytest.mark.parametrize("case", sorted(DONATION))
def test_donation_fires(tmp_path, case):
    src, word = DONATION[case]
    root = make_repo(tmp_path, {f"{PKG}/ops/drive.py": src})
    found = lint_pass(root, "donation")
    assert found and all(word in f.message for f in found)
    assert all(f.severity == "warning" for f in found)


@pytest.mark.parametrize("case", sorted(DONATION_SILENT))
def test_donation_silent(tmp_path, case):
    root = make_repo(tmp_path, {f"{PKG}/ops/drive.py":
                                DONATION_SILENT[case]})
    assert lint_pass(root, "donation") == []


# --------------------------------------------------- harness mechanics

HOT = _stencil("y = fields[0].item()")


def test_unknown_pass_id_raises(tmp_path):
    root = make_repo(tmp_path, {f"{PKG}/ops/x.py": "A = 1\n"})
    with pytest.raises(ValueError, match="unknown pass"):
        run_lint(root, [PKG], select=["no-such-pass"])


def test_baseline_filters_by_key(tmp_path):
    root = make_repo(tmp_path, {f"{PKG}/ops/cuda_stencil.py": HOT})
    found = lint_pass(root, "trace-safety")
    assert found
    again = run_lint(root, [PKG], select=["trace-safety"],
                     baseline=[f.key() for f in found])
    assert again == []
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps([f.key() for f in found]))
    assert lint.load_baseline(str(path)) == [f.key() for f in found]
    path.write_text(json.dumps({"not": "a list"}))
    with pytest.raises(ValueError, match="JSON list"):
        lint.load_baseline(str(path))


def test_json_document_schema(tmp_path):
    root = make_repo(tmp_path, {f"{PKG}/ops/cuda_stencil.py": HOT})
    found = run_lint(root, [PKG])
    doc = findings_to_json(found, root, [PKG])
    assert doc["schema"] == "gslint/1"
    assert doc["passes"] == sorted(lint.PASSES)
    assert doc["errors"] >= 1 and doc["counts"]["trace-safety"] >= 1
    ref_doc = ref_lint.findings_to_json([], root, [PKG])
    assert set(doc) == set(ref_doc)
    for f in doc["findings"]:
        assert {"pass_id", "path", "line", "message", "hint",
                "severity"} <= set(f)
    json.dumps(doc)


def _cli(*args, cwd=None):
    return subprocess.run(
        [sys.executable, "-m", "grayscott_jl_tpu_torch.lint", *args],
        capture_output=True, text=True, cwd=cwd or REPO, timeout=120)


def test_cli_json_and_exit_codes(tmp_path):
    root = make_repo(tmp_path, {f"{PKG}/ops/cuda_stencil.py": HOT})
    proc = _cli("--root", root, "--json", "--select", "trace-safety", PKG)
    assert proc.returncode == 1
    doc = json.loads(proc.stdout)
    assert doc["errors"] >= 1
    clean = _cli("--root", root, "--select", "donation", PKG)
    assert clean.returncode == 0, clean.stdout + clean.stderr
    listed = _cli("--list")
    assert listed.returncode == 0
    assert [line.split()[0] for line in listed.stdout.splitlines()] == sorted(
        lint.PASSES)


# ------------------------------------------------------- the self-check

def test_gslint_zero_findings_over_the_port():
    """Every pass over the port's package and chip_smoke.py: zero
    findings, errors and warnings, with the committed (empty)
    baseline."""
    baseline = lint.load_baseline(str(REPO / "gslint-baseline.json"))
    assert baseline == []
    findings = run_lint(str(REPO), TARGETS, baseline=baseline)
    assert findings == [], (
        "gslint found contract violations:\n"
        + "\n".join(f.render() for f in findings))


def test_cli_over_the_port_exits_zero():
    proc = _cli("--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["targets"] == TARGETS
    assert doc["errors"] == 0 and doc["warnings"] == 0
    assert doc["findings"] == []


def test_the_event_registry_is_the_references():
    """The port's ``--check`` registry names every kind the reference's
    does: a kind the port stopped emitting is a fault of the port, not an
    entry to delete (the self-check then holds every kind emitted)."""
    from grayscott_jl_tpu.lint import events_schema as ref_events
    from grayscott_jl_tpu.lint.context import LintContext as RefContext
    from grayscott_jl_tpu_torch.lint import events_schema
    from grayscott_jl_tpu_torch.lint.context import LintContext

    ref = ref_events.registry_kinds(ref_events._registry_source(
        RefContext(str(REPO), [REF_PKG])))
    port = events_schema.registry_kinds(events_schema._registry_source(
        LintContext(str(REPO), [PKG])))
    assert ref and set(port) == set(ref)


def test_pass_catalog_is_the_references():
    assert set(lint.PASSES) == set(ref_lint.PASSES) == {
        "trace-safety", "purity", "layering", "env-knobs",
        "event-schema", "donation",
    }


def test_lint_imports_with_torch_and_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['torch'] = None\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "from grayscott_jl_tpu_torch.lint import __main__ as cli, run_lint\n"
        "from grayscott_jl_tpu_torch.analysis import decomp, gdsplot\n"
        "print(len(run_lint(cli.REPO, ['grayscott_jl_tpu_torch/lint'],\n"
        "                   select=['layering', 'trace-safety'])),\n"
        "      decomp.describe(2, 8).splitlines()[0])\n"
        "leaked = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('torch', 'jax', 'grayscott_jl_tpu') and sys.modules[m]]\n"
        "assert not leaked, leaked\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("0 devices = 2")


def test_models_base_names_are_the_protocol(tmp_path):
    """ops/ may look a model up through the declaration protocol's
    registry (``models.base``), never import one."""
    root = make_repo(tmp_path, {f"{PKG}/ops/envelope.py": """
def spec_of(name):
    from ..models.base import get_model

    return get_model(name)
"""})
    assert lint_pass(root, "layering") == []


def test_ruff_clean():
    pytest.importorskip("ruff")
    proc = subprocess.run(
        [sys.executable, "-m", "ruff", "check", f"{PKG}/lint",
         f"{PKG}/analysis"],
        capture_output=True, text=True, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    fmt = subprocess.run(
        [sys.executable, "-m", "ruff", "format", "--check", f"{PKG}/lint"],
        capture_output=True, text=True, cwd=str(REPO),
    )
    assert fmt.returncode == 0, fmt.stdout + fmt.stderr


def test_mypy_strict_on_the_lint_package():
    pytest.importorskip("mypy")
    proc = subprocess.run(
        [sys.executable, "-m", "mypy", "--strict", f"{PKG}/lint"],
        capture_output=True, text=True, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
