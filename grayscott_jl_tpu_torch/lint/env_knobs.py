"""Pass ``env-knobs`` — the ``GS_*`` knob registry, cross-checked.

The reference's three checks (``grayscott_jl_tpu/lint/env_knobs.py``)
over the port's reads.

The framework is steered by 60+ ``GS_*`` environment knobs whose
contract ("env wins over TOML", documented in the docs knob tables) is
only as good as the sync between code and docs.  This pass collects
every knob *read* in the linted tree (direct ``os.environ`` reads,
``os.getenv``, and calls through knob-accessor helpers such as
``config/env.py``'s typed resolvers) and checks:

* **undocumented** — a knob read in code but absent from every knob
  table (``docs/*.md``, ``README.md``, ``BASELINE.md``) is invisible
  to operators;
* **dead** — a knob documented but never read anywhere (the targets,
  the port's tests, the example launchers) is a doc lie — or, for the
  port, a knob it does not act on; the knobs it deliberately does not
  read are declared in :data:`NOT_READ`, each with its reason, so the
  port's known gaps stay enumerable (an entry the port now reads, or
  that no doc lists, is itself a finding);
* **resolver discipline** — a ``GS_*`` read belongs in a dedicated
  resolver helper (a ``resolve*``/``*_from_env`` function, or one of
  the config/obs resolver modules), not inline in execution code, so
  the registry stays enumerable and precedence lives in one place.

Dynamic keys built from a ``GS_``-prefixed f-string register the whole
family (``GS_WATCHDOG_<PHASE>_S`` -> ``GS_WATCHDOG_*``).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from . import Finding
from .context import PACKAGE, LintContext, SourceFile
from .astutil import dotted

PASS_ID = "env-knobs"

#: Modules whose whole body counts as resolver context: the config
#: layer and the env-resolved obs singletons.
RESOLVER_MODULES = (
    f"{PACKAGE}.config.settings",
    f"{PACKAGE}.config.env",
    f"{PACKAGE}.obs.",
)

#: Knobs the docs list that the port deliberately does not read, each
#: with its reason (ROADMAP "Not queued" and "Not faults"); a key that
#: ends in ``_`` declares the family of knobs it begins.
NOT_READ = {
    "GS_TPU_ADIOS2": "the ADIOS2 engine needs the adios2 wheel, which "
    "the port does not carry; it writes BP-lite, the reference's "
    "fallback without the wheel",
    "GS_TPU_PROBE_TIMEOUT": "it bounds the reference's TPU backend "
    "probe; the port asks torch.cuda for the card and has no probe",
    "GS_BX": "the port's tile is fixed (cuda_stencil.TILE), so there is "
    "no x block size to choose",
    "GS_BENCH_": "bench.py's knobs (BASELINE.md): the port has no bench "
    "yet; its counterpart comes with the port's benchmark (ROADMAP Queue 1 "
    "item 10)",
}

_KNOB_RE = re.compile(r"GS_[A-Z][A-Z0-9_]*")

#: This file, where a stale :data:`NOT_READ` entry is reported when the
#: whole package, this file included, is linted.
_SELF = f"{PACKAGE}/lint/env_knobs.py"
_SELF_MODULE = f"{PACKAGE}.lint.env_knobs"


def _declares(key: str, knob: str) -> bool:
    """Whether :data:`NOT_READ` entry ``key`` covers ``knob``."""
    return knob == key or (key.endswith("_") and knob.startswith(key))


def _not_read(knob: str) -> bool:
    return any(_declares(k, knob) for k in NOT_READ)


def _is_resolver_context(
    sf: SourceFile, func_names: List[str]
) -> bool:
    for m in RESOLVER_MODULES:
        if sf.module == m.rstrip(".") or (
            m.endswith(".") and sf.module.startswith(m)
        ):
            return True
    return any(
        n.lstrip("_").startswith("resolve") or n.endswith("from_env")
        for n in func_names
    )


class _Read:
    """One static knob read site."""

    def __init__(self, sf: SourceFile, line: int, knob: str,
                 family: bool, resolver: bool):
        self.sf = sf
        self.line = line
        self.knob = knob  #: exact name, or prefix when ``family``
        self.family = family
        self.resolver = resolver


def _environ_key(node: ast.AST) -> Optional[ast.expr]:
    """The key expression of an ``os.environ`` / ``os.getenv`` read,
    else None.  Stores (writes, ``pop``) are not reads."""
    if isinstance(node, ast.Subscript) and isinstance(
        node.ctx, ast.Load
    ):
        base = dotted(node.value)
        if base and base.split(".")[-1] == "environ":
            return node.slice
    if isinstance(node, ast.Call):
        name = dotted(node.func)
        if name and (
            name.endswith("environ.get") or name.endswith("getenv")
        ) and node.args:
            return node.args[0]
    return None


def _classify_key(
    key: ast.expr, scope: Optional[ast.AST]
) -> Tuple[Optional[str], bool]:
    """``(knob_or_prefix, is_family)`` for a key expression;
    ``(None, False)`` when the key cannot be resolved statically."""
    if isinstance(key, ast.Constant) and isinstance(key.value, str):
        if key.value.startswith("GS_"):
            return key.value, False
        return None, False
    if isinstance(key, ast.JoinedStr) and key.values:
        first = key.values[0]
        if isinstance(first, ast.Constant) and isinstance(
            first.value, str
        ) and first.value.startswith("GS_"):
            return first.value, True
    if isinstance(key, ast.Name) and scope is not None:
        # One-hop resolution: `name = f"GS_..."` / `name = "GS_..."`
        # in the same function.
        for stmt in ast.walk(scope):
            if (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == key.id):
                return _classify_key(stmt.value, None)
    return None, False


def _function_params(node: ast.AST) -> Set[str]:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = node.args
        return {
            p.arg for p in (
                a.posonlyargs + a.args + a.kwonlyargs
            )
        }
    return set()


FuncNode = ast.AST
_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _env_reads(
    sf: SourceFile,
) -> List[Tuple[ast.AST, ast.expr, Tuple[FuncNode, ...]]]:
    """Every ``os.environ``/``os.getenv`` read of a file with its key and
    its enclosing functions (outermost first), in one walk — the
    reference's order: the deepest functions' reads first, each
    function's in source order, module-scope reads last."""
    found: List[Tuple[ast.AST, ast.expr, Tuple[FuncNode, ...]]] = []
    order: Dict[int, int] = {}

    def walk(node: ast.AST, stack: Tuple[FuncNode, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            inner = stack
            if isinstance(child, _FUNC_DEFS):
                order[id(child)] = len(order)
                inner = stack + (child,)
            key = _environ_key(child)
            if key is not None:
                found.append((child, key, stack))
            walk(child, inner)

    walk(sf.tree, ())

    def rank(
        item: Tuple[ast.AST, ast.expr, Tuple[FuncNode, ...]],
    ) -> Tuple[int, int, int, int, int]:
        node, _, stack = item
        if not stack:
            return (1, 0, 0, node.lineno, node.col_offset)
        return (0, -len(stack), order[id(stack[-1])], node.lineno,
                node.col_offset)

    return sorted(found, key=rank)


def _collect(ctx: LintContext) -> Tuple[List[_Read], Set[str], Set[str]]:
    """One walk: direct reads, env writes, accessor helpers, and every
    ``GS_*`` token mentioned in a string constant (liveness only)."""
    reads: List[_Read] = []
    writes: Set[str] = set()
    mentions: Set[str] = set()
    accessors: Set[str] = set()  # function names reading env by param

    # First sweep: direct reads + accessor discovery.
    for sf in ctx.files:
        env_reads = _env_reads(sf)
        for node, key, stack in env_reads:
            if isinstance(key, ast.Name):
                for fnode in stack:
                    if key.id in _function_params(fnode):
                        accessors.add(fnode.name)
        _collect_file_reads(sf, env_reads, reads, writes, mentions)

    # Second sweep: accessor call sites register knobs too.
    for sf in ctx.files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            name = dotted(node.func)
            if not name or name.split(".")[-1] not in accessors:
                continue
            knob, family = _classify_key(node.args[0], None)
            if knob is not None:
                reads.append(_Read(
                    sf, node.lineno, knob, family, resolver=True
                ))
    return reads, writes, mentions


def _collect_file_reads(
    sf: SourceFile,
    env_reads: List[Tuple[ast.AST, ast.expr, Tuple[FuncNode, ...]]],
    reads: List[_Read],
    writes: Set[str],
    mentions: Set[str],
) -> None:
    # String-constant mentions (f-string fragments, literal key args):
    # liveness signal only.
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Constant) and isinstance(
            node.value, str
        ):
            mentions.update(_KNOB_RE.findall(node.value))
        if isinstance(node, ast.Subscript) and isinstance(
            node.ctx, ast.Store
        ):
            base = dotted(node.value)
            if base and base.split(".")[-1] == "environ":
                if isinstance(node.slice, ast.Constant) and isinstance(
                    node.slice.value, str
                ):
                    writes.add(node.slice.value)

    # Direct reads, attributed to their innermost enclosing function
    # (a read inside a nested resolver helper is credited to the
    # helper, not its host); module-scope reads are never resolver
    # context unless the module itself is.
    for node, key, stack in env_reads:
        names = [f.name for f in stack if isinstance(f, _FUNC_DEFS)]
        resolver = _is_resolver_context(sf, names)
        knob, family = _classify_key(key, stack[-1] if stack else None)
        if knob is None:
            continue  # dynamic non-GS key: not a knob read
        reads.append(_Read(sf, node.lineno, knob, family, resolver))


def _doc_tokens(ctx: LintContext) -> Dict[str, Tuple[str, int]]:
    """``token -> (doc rel path, line)`` for every GS_* token in the
    docs set (first occurrence wins)."""
    import os

    out: Dict[str, Tuple[str, int]] = {}
    for path in ctx.doc_files():
        rel = os.path.relpath(path, ctx.root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, start=1):
                for tok in _KNOB_RE.findall(line):
                    out.setdefault(tok, (rel, i))
    return out


def run(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    reads, writes, mentions = _collect(ctx)
    doc_tokens = _doc_tokens(ctx)
    doc_names = set(doc_tokens)

    # --- undocumented: first read site per knob reports it
    reported: Set[str] = set()
    for r in reads:
        if r.knob in reported:
            continue
        if r.family:
            documented = any(
                t == r.knob or t.startswith(r.knob)
                for t in doc_names
            )
        else:
            documented = r.knob in doc_names or any(
                t.endswith("_") and r.knob.startswith(t)
                for t in doc_names
            )
        if not documented:
            reported.add(r.knob)
            label = f"{r.knob}*" if r.family else r.knob
            findings.append(Finding(
                PASS_ID, r.sf.rel, r.line,
                f"env knob {label} is read here but appears in no "
                f"knob table (docs/, README.md, BASELINE.md)",
                hint="add a row to the relevant knob table, or delete "
                     "the dead read",
            ))

    # --- dead: documented but read nowhere
    exact_reads = {r.knob for r in reads if not r.family}
    family_reads = {r.knob for r in reads if r.family}
    aux_tokens = set(_KNOB_RE.findall(ctx.auxiliary_reader_text()))
    for tok, (rel, line) in sorted(doc_tokens.items()):
        if len(tok) <= len("GS_") or _not_read(tok):
            continue
        if tok.endswith("_"):  # documented family prefix
            alive = any(f.startswith(tok) or tok.startswith(f)
                        for f in family_reads) or any(
                e.startswith(tok) for e in exact_reads
            )
        else:
            alive = (
                tok in exact_reads
                or tok in writes
                or tok in mentions
                or tok in aux_tokens
                or any(tok.startswith(f) for f in family_reads)
            )
        if not alive:
            findings.append(Finding(
                PASS_ID, rel, line,
                f"documented env knob {tok} is never read anywhere "
                f"in the tree (dead knob)",
                hint="drop the table row, or wire the knob back up",
            ))

    # --- the declared gaps stay true
    for knob in sorted(NOT_READ):
        hits = [r for r in reads if _declares(knob, r.knob)]
        if hits:
            line = hits[0]
            findings.append(Finding(
                PASS_ID, line.sf.rel, line.line,
                f"env knob {knob} is read here but declared as not read "
                f"by the port (NOT_READ)",
                hint="drop its NOT_READ entry",
            ))
        elif ctx.module(PACKAGE) and ctx.module(_SELF_MODULE) and not any(
            _declares(knob, t) for t in doc_tokens
        ):
            findings.append(Finding(
                PASS_ID, _SELF, 1,
                f"NOT_READ declares {knob}, which no knob table lists",
                hint="drop its NOT_READ entry",
            ))

    # --- resolver discipline
    for r in reads:
        if not r.resolver:
            label = f"{r.knob}*" if r.family else r.knob
            findings.append(Finding(
                PASS_ID, r.sf.rel, r.line,
                f"raw os.environ read of {label} outside a resolver "
                f"helper",
                hint="route it through config/env.py's typed "
                     "accessors or a resolve_* helper so precedence "
                     "and parsing live in one place",
            ))
    return findings
