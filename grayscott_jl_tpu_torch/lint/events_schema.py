"""Pass ``event-schema`` — GS_EVENTS kinds vs the run report's --check.

The reference's pass (``grayscott_jl_tpu/lint/events_schema.py``) over
the port's producers and its registry.  The unified run event stream
(``obs/events.py``) promises one schema per record *kind*, and
``python -m grayscott_jl_tpu_torch.obs.report --check`` is the port's
validator of that promise.  The two drift independently: a producer
can invent a kind the checker never validates, and the checker can
keep validating a kind nothing emits anymore.  This pass closes the
loop statically:

* every kind emitted in the tree — a string-literal first argument to
  an ``.emit(...)`` call, or a ``journal.record(event="...")`` (the
  journal mirrors every record onto the stream with the ``event`` name
  as the stream kind) — must be a key of ``obs/report.py``'s
  ``EVENT_KIND_SCHEMA`` registry;
* every registry key must be emitted somewhere (no dead validators).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Tuple

from . import Finding
from .context import PACKAGE, LintContext, SourceFile
from .astutil import dotted

PASS_ID = "event-schema"

#: The registry the checker side must declare.
REGISTRY_NAME = "EVENT_KIND_SCHEMA"
REGISTRY_FILE = f"{PACKAGE}/obs/report.py"


def emitted_kinds(ctx: LintContext) -> Dict[str, Tuple[str, int]]:
    """``kind -> (rel path, line)`` of the first emit site found."""
    out: Dict[str, Tuple[str, int]] = {}
    for sf in ctx.package_files():
        for node in ast.walk(sf.tree):
            # Journal events built as dict literals and passed via
            # ``record(**event)`` (the watchdog's hang record, the
            # health guard's report) still name their kind statically.
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if (isinstance(k, ast.Constant)
                            and k.value == "event"
                            and isinstance(v, ast.Constant)
                            and isinstance(v.value, str)):
                        out.setdefault(v.value, (sf.rel, v.lineno))
                continue
            if not isinstance(node, ast.Call):
                continue
            # The receiver may be a call chain
            # (``get_events().emit``): classify by attribute tail,
            # not by a fully-resolvable dotted name.
            if isinstance(node.func, ast.Attribute):
                tail = node.func.attr
            else:
                name = dotted(node.func)
                tail = name.split(".")[-1] if name else None
            kind: Optional[str] = None
            if tail == "emit" and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(
                    arg.value, str
                ):
                    kind = arg.value
            elif tail == "record":
                for kw in node.keywords:
                    if kw.arg == "event" and isinstance(
                        kw.value, ast.Constant
                    ) and isinstance(kw.value.value, str):
                        kind = kw.value.value
            if kind is not None:
                out.setdefault(kind, (sf.rel, node.lineno))
    return out


def _registry_source(ctx: LintContext) -> Optional[SourceFile]:
    for sf in ctx.files:
        if sf.rel == REGISTRY_FILE:
            return sf
    path = os.path.join(ctx.root, REGISTRY_FILE)
    if os.path.isfile(path):
        return SourceFile(ctx.root, path)
    return None


def registry_kinds(
    sf: SourceFile,
) -> Optional[Dict[str, int]]:
    """``kind -> line`` of the checker's registry dict literal, or
    None when the registry assignment is missing entirely."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == REGISTRY_NAME
            for t in node.targets
        ):
            continue
        if not isinstance(node.value, ast.Dict):
            return None
        out: Dict[str, int] = {}
        for k in node.value.keys:
            if isinstance(k, ast.Constant) and isinstance(
                k.value, str
            ):
                out[k.value] = k.lineno
        return out
    return None


def run(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    emitted = emitted_kinds(ctx)
    if not emitted:
        return findings  # fixture trees without producers: nothing to sync
    reg_sf = _registry_source(ctx)
    if reg_sf is None:
        findings.append(Finding(
            PASS_ID, REGISTRY_FILE, 1,
            f"{REGISTRY_FILE} not found — the GS_EVENTS kinds have "
            f"no --check validator registry",
            hint=f"declare {REGISTRY_NAME} = {{kind: (required "
                 f"attrs...)}} in obs/report.py",
        ))
        return findings
    registry = registry_kinds(reg_sf)
    if registry is None:
        findings.append(Finding(
            PASS_ID, reg_sf.rel, 1,
            f"{REGISTRY_NAME} is missing (or not a dict literal) in "
            f"{reg_sf.rel}",
            hint="declare the kind registry as a plain dict literal "
                 "so it is statically enumerable",
        ))
        return findings
    for kind, (rel, line) in sorted(emitted.items()):
        if kind not in registry:
            findings.append(Finding(
                PASS_ID, rel, line,
                f"event kind {kind!r} is emitted here but has no "
                f"validator entry in {reg_sf.rel}:{REGISTRY_NAME}",
                hint="add the kind (and its required attrs) to the "
                     "registry so --check covers it",
            ))
    for kind, line in sorted(registry.items()):
        if kind not in emitted:
            findings.append(Finding(
                PASS_ID, reg_sf.rel, line,
                f"{REGISTRY_NAME} validates kind {kind!r}, which "
                f"nothing in the tree emits (dead validator)",
                hint="drop the registry entry, or restore the "
                     "producer",
            ))
    return findings
