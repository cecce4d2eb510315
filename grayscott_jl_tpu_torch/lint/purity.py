"""Pass ``purity`` — registered models stay pure declarations.

The reference's contract (``grayscott_jl_tpu/lint/purity.py``) over the
port's ``models/*``.

A model's ``reaction`` is emitted into every generated kernel and
its ``init`` must produce identical blocks for identical ``(offsets,
sizes, seed)`` on every host; both promises die the moment a model
reaches for ambient process state.  This pass checks every function in
a concrete ``models/*`` module that is (or is reachable by name from)
a model's ``reaction``/``init`` for:

* environment access (``os.environ`` / ``os.getenv``),
* host I/O (``open``/``print``/``input``) and host entropy or clocks
  (``random``, ``np.random``, ``time``, ``datetime``, ``uuid``),
* ``global`` statements (mutable module state).

Module-scope *constants* (seeding geometry, boundary values) are the
declaration itself and remain fine — only behavior inside the model
callables is constrained.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from . import Finding
from .context import PACKAGE, LintContext, SourceFile
from .astutil import dotted, iter_functions

PASS_ID = "purity"

#: Entry points of the model contract.
MODEL_ENTRY_NAMES = ("reaction", "init")

#: Dotted-prefix accesses banned inside model callables.
_BANNED_PREFIXES = (
    "os.environ", "os.getenv", "np.random", "numpy.random",
    "random.", "time.", "datetime.", "uuid.",
)

#: Bare calls banned inside model callables.
_BANNED_CALLS = {"open", "print", "input", "eval", "exec",
                 "__import__"}


def _model_files(ctx: LintContext) -> List[SourceFile]:
    out = []
    for sf in ctx.package_files():
        if (sf.module.startswith(f"{PACKAGE}.models.")
                and sf.module != f"{PACKAGE}.models.base"):
            out.append(sf)
    return out


def _roots_and_index(
    sf: SourceFile,
) -> Tuple[Set[str], Dict[str, List[ast.AST]]]:
    """Model entry functions plus keyword-registered callables, and a
    name index of every function in the module."""
    index: Dict[str, List[ast.AST]] = {}
    for qual, fnode, parents in iter_functions(sf.tree):
        index.setdefault(fnode.name, []).append(fnode)
    roots = {n for n in MODEL_ENTRY_NAMES if n in index}
    # reaction=foo / init=bar keyword registrations (Model(...) calls).
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg in MODEL_ENTRY_NAMES:
                    name = dotted(kw.value)
                    if name and name.split(".")[-1] in index:
                        roots.add(name.split(".")[-1])
    return roots, index


def _reachable(
    roots: Set[str], index: Dict[str, List[ast.AST]]
) -> Set[str]:
    seen: Set[str] = set()
    work = list(roots)
    while work:
        name = work.pop()
        if name in seen:
            continue
        seen.add(name)
        for fnode in index.get(name, ()):
            for node in ast.walk(fnode):
                ref = None
                if isinstance(node, ast.Name):
                    ref = node.id
                elif isinstance(node, ast.Attribute):
                    ref = node.attr
                if ref and ref in index and ref not in seen:
                    work.append(ref)
    return seen


def run(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for sf in _model_files(ctx):
        roots, index = _roots_and_index(sf)
        if not roots:
            continue
        for name in sorted(_reachable(roots, index)):
            for fnode in index[name]:
                findings.extend(_check_function(sf, name, fnode))
    return findings


def _check_function(
    sf: SourceFile, name: str, fnode: ast.AST
) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(fnode):
        if isinstance(node, ast.Global):
            findings.append(Finding(
                PASS_ID, sf.rel, node.lineno,
                f"model callable {name!r} mutates module globals",
                hint="models are declarations — thread state through "
                     "params instead",
            ))
            continue
        ref = dotted(node) if isinstance(
            node, (ast.Attribute, ast.Name)
        ) else None
        if ref:
            for prefix in _BANNED_PREFIXES:
                if ref == prefix.rstrip(".") or ref.startswith(prefix):
                    findings.append(Finding(
                        PASS_ID, sf.rel, node.lineno,
                        f"model callable {name!r} touches ambient "
                        f"process state ({ref})",
                        hint="reaction/init must be pure functions "
                             "of their arguments (see "
                             "docs/MODELS.md)",
                    ))
                    break
        if isinstance(node, ast.Call):
            cname = dotted(node.func)
            if cname in _BANNED_CALLS:
                findings.append(Finding(
                    PASS_ID, sf.rel, node.lineno,
                    f"model callable {name!r} performs host I/O "
                    f"({cname}())",
                    hint="models must not read or write the host — "
                         "move I/O to the driver",
                ))
    # Deduplicate Attribute chains reported once per node walk
    # (``os.environ.get`` visits both ``os.environ.get`` and
    # ``os.environ``): keep the first per (line, message).
    seen: Set[Tuple[int, str]] = set()
    unique: List[Finding] = []
    for f in findings:
        k = (f.line, f.message)
        if k not in seen:
            seen.add(k)
            unique.append(f)
    return unique
