"""Pass ``layering`` — the import-graph contracts of the port's package.

Three checks, the port's form of ``grayscott_jl_tpu/lint/layering.py``:

* **model isolation** — ``ops/`` and ``parallel/`` are model-generic
  execution machinery: they must not import concrete ``models/*``
  modules, nor the bare ``models`` package whose import registers
  them (``models.base``, the declaration protocol with its registry
  lookup, is allowed, and so are the names imported from it).
  Function-local imports count: the kernel generator builds each
  model's kernel from the declaration it is handed.
* **the port's import contracts** — (1) no module imports ``jax``,
  ``jaxlib`` or the reference package ``grayscott_jl_tpu``, anywhere
  in the file (the port stands alone; ``tests/test_torch_imports.py``
  checks the same); (2) the modules that import without torch
  (:data:`TORCHFREE_PREFIXES`, :data:`TORCHFREE_EXACT`: the host-only
  tools and the layers they read) stay so, transitively: every
  import-time import is stdlib, a third-party module other than
  ``torch``/``triton``, or a module of the set.  ``TYPE_CHECKING``
  blocks and function-local imports are exempt — that is how a lazy
  torch dependency is spelled.
* **model-literal scan** — the reference's grep assertion, unchanged:
  no model seeding constants or boundary-value definitions in shared
  code.
"""

from __future__ import annotations

import ast
import os
import re
from typing import List, Tuple

from . import Finding
from .astutil import resolve_imports
from .context import PACKAGE, LintContext, SourceFile, in_package

PASS_ID = "layering"

#: Layered subpackages that must stay model-generic.
SHARED_SUBPACKAGES = (f"{PACKAGE}.ops", f"{PACKAGE}.parallel")

#: Top-level packages no module of the port may import.
FORBIDDEN_TOPS = ("jax", "jaxlib", "grayscott_jl_tpu")

#: Top-level packages a torch-free module may not import at module scope.
TORCH_TOPS = ("torch", "triton")

#: Subpackages whose every module imports without torch.
TORCHFREE_PREFIXES = tuple(
    f"{PACKAGE}.{p}" for p in ("config", "lint", "models", "obs", "tune")
)

#: Single modules that import without torch (a subpackage's
#: ``__init__`` by its package name).  Listed from a probe that imports
#: each module of the package with ``sys.modules["torch"] = None``.
TORCHFREE_EXACT = (PACKAGE,) + tuple(
    f"{PACKAGE}.{m}"
    for m in (
        "__main__",
        "analysis",
        "analysis.decomp",
        "analysis.gdsplot",
        "chaos",
        "ensemble",
        "ensemble.spec",
        "io",
        "io.adios",
        "io.async_writer",
        "io.bplite",
        "io.codec",
        "io.native",
        "io.sidecar",
        "io.stream",
        "io.vtk",
        "launch",
        "ops",
        "ops._build",
        "ops.kernelgen",
        "parallel",
        "parallel.domain",
        "parallel.icimodel",
        "probes",
        "probes.fabric",
        "probes.kernel_ab",
        "probes.launch_times",
        "resilience",
        "resilience.faults",
        "resilience.integrity",
        "resilience.rendezvous",
        "resilience.watchdog",
        "serve",
        "serve.cache",
        "serve.protocol",
        "serve.scheduler",
        "utils",
        "utils.benchmark",
        "utils.profiler",
    )
)

#: The literal-scan regexes (kept from the reference's grep test body).
_BANNED_TOKENS = re.compile(r"\bSEED_HALF_WIDTH\b|\bSEED_U\b|\bSEED_V\b|\bSEED_T\b")
_BOUNDARY_DEF = re.compile(r"^\s*[UVTW]_BOUNDARY\s*=")
_UNQUALIFIED_BOUNDARY = re.compile(r"(?<![\w.])[UVT]_BOUNDARY\b")


def in_torchfree_set(module: str) -> bool:
    """True for a module of the torch-free set."""
    return module in TORCHFREE_EXACT or any(
        in_package(module, p) for p in TORCHFREE_PREFIXES
    )


def _module_of(root: str, name: str) -> str:
    """The module a dotted import name denotes: the name itself when a
    file or package of that name exists under ``root``, else the module
    that holds it (``io.open_reader`` -> ``io``)."""
    parts = name.split(".")
    while len(parts) > 1:
        path = os.path.join(root, *parts)
        if os.path.isfile(path + ".py") or os.path.isdir(path):
            break
        parts = parts[:-1]
    return ".".join(parts)


def _is_type_checking_if(node: ast.AST) -> bool:
    if not isinstance(node, ast.If):
        return False
    t = node.test
    return (isinstance(t, ast.Name) and t.id == "TYPE_CHECKING") or (
        isinstance(t, ast.Attribute) and t.attr == "TYPE_CHECKING"
    )


def _import_time_imports(
    sf: SourceFile,
) -> List[Tuple[ast.AST, List[str]]]:
    """Imports executed when the module is imported: everything except
    function bodies and ``TYPE_CHECKING`` blocks."""
    out: List[Tuple[ast.AST, List[str]]] = []

    def walk(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
            ):
                continue
            if _is_type_checking_if(child):
                continue
            if isinstance(child, (ast.Import, ast.ImportFrom)):
                out.append((child, resolve_imports(sf, child)))
            else:
                walk(child)

    walk(sf.tree)
    return out


def _all_imports(sf: SourceFile) -> List[Tuple[ast.AST, List[str]]]:
    out: List[Tuple[ast.AST, List[str]]] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.append((node, resolve_imports(sf, node)))
    return out


def run(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for sf in ctx.files:
        findings.extend(_check_forbidden(sf))
    for sf in ctx.package_files():
        if any(sf.module.startswith(p + ".") for p in SHARED_SUBPACKAGES):
            findings.extend(_check_model_isolation(sf))
            findings.extend(_check_literals(sf))
        if in_torchfree_set(sf.module):
            findings.extend(_check_torchfree(ctx, sf))
    return findings


def _check_model_isolation(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    models = f"{PACKAGE}.models"
    for node, names in _all_imports(sf):
        for name in names:
            # The bare package import is as concrete as a module
            # import: ``import grayscott_jl_tpu_torch.models`` registers
            # every built-in model as a side effect.
            if not in_package(name, models) or in_package(
                name, f"{models}.base"
            ):
                continue
            findings.append(
                Finding(
                    PASS_ID,
                    sf.rel,
                    node.lineno,
                    f"shared code imports concrete model module "
                    f"{name!r} — ops/ and parallel/ must stay "
                    f"model-generic",
                    hint="consume the declaration passed in as the "
                    "`model` argument instead of importing one",
                )
            )
    return findings


def _check_forbidden(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    for node, names in _all_imports(sf):
        for name in names:
            if name.split(".", 1)[0] in FORBIDDEN_TOPS:
                findings.append(
                    Finding(
                        PASS_ID,
                        sf.rel,
                        node.lineno,
                        f"{sf.module} imports {name!r} — the port imports "
                        f"neither JAX nor the reference package",
                        hint="keep the port's own copy of what it needs",
                    )
                )
                break
    return findings


def _check_torchfree(ctx: LintContext, sf: SourceFile) -> List[Finding]:
    """One finding per import statement that breaks the property."""
    findings: List[Finding] = []
    for node, names in _import_time_imports(sf):
        for name in names:
            top = name.split(".", 1)[0]
            if top in TORCH_TOPS:
                message = (
                    f"{sf.module} must be importable without torch but "
                    f"imports {name!r} at module scope"
                )
                hint = "move the import inside the function that needs it"
            elif top == PACKAGE and not in_torchfree_set(
                _module_of(ctx.root, name)
            ):
                # Importing a sibling that is itself allowed to pull
                # torch breaks the property transitively.
                message = (
                    f"torch-free module {sf.module} imports {name!r}, "
                    f"which is outside the torch-free set"
                )
                hint = (
                    "import it lazily, or add the target to the "
                    "torch-free set if it genuinely avoids torch at import"
                )
            else:
                continue
            findings.append(Finding(PASS_ID, sf.rel, node.lineno, message, hint))
            break
    return findings


def _check_literals(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    in_parallel = sf.module.startswith(f"{PACKAGE}.parallel.")
    for i, line in enumerate(sf.lines, start=1):
        if _BANNED_TOKENS.search(line):
            findings.append(
                Finding(
                    PASS_ID,
                    sf.rel,
                    i,
                    "model seeding constants belong in models/",
                    hint="read them from the model declaration",
                )
            )
        if _BOUNDARY_DEF.search(line):
            findings.append(
                Finding(
                    PASS_ID,
                    sf.rel,
                    i,
                    "boundary values are model declarations — shared "
                    "code must not define them",
                    hint="thread the model's boundary constants through "
                    "the call instead",
                )
            )
        elif in_parallel and "BOUNDARY" in line:
            findings.append(
                Finding(
                    PASS_ID,
                    sf.rel,
                    i,
                    "parallel/ must receive boundaries via the model "
                    "declaration, not name them",
                )
            )
        elif not in_parallel and _UNQUALIFIED_BOUNDARY.search(line):
            findings.append(
                Finding(
                    PASS_ID,
                    sf.rel,
                    i,
                    "boundary constants must come from the model "
                    "declaration (qualified reads only)",
                )
            )
    return findings
