"""Pass ``donation`` — rebuild-in-loop and reused-buffer hazards.

Best-effort *warnings*, the port's counterparts of the two jit
footguns ``grayscott_jl_tpu/lint/donation.py`` looks for:

* **build-in-loop** — a kernel library built or loaded
  (``ops/_build``'s ``build``/``build_all``/``load``), a
  ``torch.compile`` or a CUDA-graph capture (``torch.cuda.graph``,
  ``CUDAGraph``, ``capture_begin``) constructed inside a
  ``for``/``while`` body: at best a cache lookup per iteration, at
  worst an ``nvcc`` run or a fresh capture.  Construction belongs
  outside the loop, cached (as ``cuda_stencil`` keeps each library).
* **read-after-reuse** — a pinned host snapshot buffer of a
  ``HostRing`` (``ring.buffer(slot, ...)`` after ``ring.take()``) read
  under its old name in the same function after the ring's slot was
  taken again: the ring reuses a set after ``slots`` snapshots, and
  only the output pipeline's reserve keeps the old bytes alive until
  they are written, so the name may already show a later boundary.
  Rebinding the name (``buf = ring.buffer(ring.take(), ...)``) clears
  the hazard.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from . import Finding
from .astutil import dotted, iter_functions
from .context import LintContext, SourceFile

PASS_ID = "donation"

#: Call tails that build or load a kernel library, compile or capture.
_BUILD_TAILS = {
    "build",
    "build_all",
    "load",
    "compile",
    "graph",
    "CUDAGraph",
    "capture_begin",
}

#: Receivers a build tail must be called on (``_build.load``,
#: ``torch.compile``, ``torch.cuda.graph``); a bare ``CUDAGraph()``
#: or ``g.capture_begin()`` counts on any receiver.
_BUILD_RECEIVERS = {"_build", "torch", "torch.cuda"}
_ANY_RECEIVER = {"CUDAGraph", "capture_begin"}


def run(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for sf in ctx.package_files():
        findings.extend(_build_in_loop(sf))
        if ".buffer(" not in sf.text:
            continue
        for qual, fnode, parents in iter_functions(sf.tree):
            findings.extend(_read_after_reuse(sf, qual, fnode))
    return findings


def _is_build(call: ast.Call) -> bool:
    name = dotted(call.func)
    if not name:
        return False
    parts = name.split(".")
    tail, receiver = parts[-1], ".".join(parts[:-1])
    if tail in _ANY_RECEIVER:
        return True
    return tail in _BUILD_TAILS and receiver in _BUILD_RECEIVERS


def _build_in_loop(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []

    def walk(node: ast.AST, loop_depth: int) -> None:
        for child in ast.iter_child_nodes(node):
            d = loop_depth
            if isinstance(child, (ast.For, ast.While)):
                d += 1
            elif isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
            ):
                # A def inside a loop runs at call time, not per
                # iteration of this loop.
                d = 0
            if isinstance(child, ast.Call) and d > 0 and _is_build(child):
                findings.append(
                    Finding(
                        PASS_ID,
                        sf.rel,
                        child.lineno,
                        f"{dotted(child.func)} constructed inside a loop — "
                        f"every iteration rebuilds or recaptures",
                        hint="hoist construction out of the loop and "
                        "cache the built library or graph",
                        severity="warning",
                    )
                )
            walk(child, d)

    walk(sf.tree, 0)
    return findings


def _receiver(call: ast.Call, tail: str) -> str:
    """The dotted receiver of ``<receiver>.<tail>(...)``, else ``""``."""
    if isinstance(call.func, ast.Attribute) and call.func.attr == tail:
        return dotted(call.func.value) or ""
    return ""


def _read_after_reuse(
    sf: SourceFile, qual: str, fnode: ast.AST
) -> List[Finding]:
    # Ring buffers bound to a bare name: (line, var, ring); the ring's
    # take() lines; every store and load of a name.
    bound: List[Tuple[int, str, str]] = []
    takes: Dict[str, List[int]] = {}
    stores: Dict[str, List[int]] = {}
    loads: Dict[str, List[int]] = {}
    for node in ast.walk(fnode):
        if isinstance(node, ast.Name):
            target = stores if isinstance(node.ctx, ast.Store) else loads
            target.setdefault(node.id, []).append(node.lineno)
        elif isinstance(node, ast.Call) and not node.args:
            ring = _receiver(node, "take")
            if ring:
                takes.setdefault(ring, []).append(node.lineno)
        elif (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Call)
        ):
            ring = _receiver(node.value, "buffer")
            if ring:
                bound.append((node.lineno, node.targets[0].id, ring))
    if not bound:
        return []
    findings: List[Finding] = []
    for bind_line, var, ring in bound:
        retake = min(
            (ln for ln in takes.get(ring, ()) if ln > bind_line),
            default=None,
        )
        if retake is None:
            continue
        # The name is stale from the ring's next take() until it is
        # rebound; a rebind on the take's own line clears it.
        next_store = min(
            (ln for ln in stores.get(var, ()) if ln > bind_line and ln >= retake),
            default=None,
        )
        for ln in loads.get(var, ()):
            if ln <= retake:
                continue
            if next_store is not None and ln >= next_store:
                continue
            findings.append(
                Finding(
                    PASS_ID,
                    sf.rel,
                    ln,
                    f"{var!r} is a {ring}.buffer() bound at line "
                    f"{bind_line} in {qual!r} and read again here after "
                    f"{ring}.take() at line {retake} — the ring may have "
                    f"handed its slot to a later snapshot",
                    hint="rebind the buffer after the take, or read it "
                    "before the ring moves on",
                    severity="warning",
                )
            )
    return findings
