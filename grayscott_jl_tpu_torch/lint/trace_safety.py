"""Pass ``trace-safety`` — no host syncs inside the per-step bodies.

The port's form of ``grayscott_jl_tpu/lint/trace_safety.py``.  The port
has no ``jax.jit``, CUDA graph or ``torch.compile``, so no root is found
structurally: the per-step bodies are declared by qualified name in
:data:`ROOTS` — the single-block and sharded runs of ``Simulation``
(with the sharded run's closures), the ensemble's block run, the kernel
wrapper ``fused_step``, the halo exchange and the xy-chain.  When this
file is linted, a declared root that no longer exists is a finding, so
a rename cannot silently empty the pass.  From the roots the pass walks
the reference's call/reference closure over the package's functions
and flags host-sync and host-effect hazards inside it:

* ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` — device->host
  copies that stall the stream between launches;
* ``torch.cuda.synchronize()`` and ``.synchronize()`` on an event or a
  stream — a wait of the host for the card;
* ``np.asarray`` / ``np.array`` — host materialization of a tensor;
* ``print(...)`` — host output on every step;
* host clocks (``time.time`` etc.) — host work timed or paced per step;
* ``float(x)`` / ``int(x)`` applied to a *parameter* of a reachable
  function — a device->host read when the argument is a tensor.

Reachability follows only plausible function links — bare names
resolved in the referencing file (or through its in-package imports),
``self.method`` within the same file, ``module_alias.fn`` for
in-package module aliases, and the model-protocol tails
``reaction``/``init``.  Generic attribute tails (``somedict.get``,
``queue.put``) are not links.  A deliberate host read on the step path
takes a one-line ``# gslint: disable=trace-safety`` with its reason.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from . import Finding
from .context import PACKAGE, LintContext, SourceFile, in_package
from .astutil import dotted, iter_functions, resolve_imports

PASS_ID = "trace-safety"

#: The per-step bodies: (module, qualified name); a root's nested
#: functions are roots too.
ROOTS = tuple(
    (f"{PACKAGE}.{module}", qual)
    for module, qual in (
        ("simulation", "Simulation._block_run"),
        ("simulation", "Simulation._sharded_run"),
        ("ensemble.engine", "EnsembleSimulation._run_blocks"),
        ("ops.cuda_stencil", "fused_step"),
        ("parallel.halo", "exchange_faces"),
        ("parallel.halo", "start_exchange"),
        ("parallel.temporal", "xy_chain"),
    )
)

#: This module: the missing-root check runs when the whole package,
#: this module included, is linted.
_SELF_MODULE = f"{PACKAGE}.lint.trace_safety"
_SELF = f"{PACKAGE}/lint/trace_safety.py"

_SYNC_TAILS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_HOST_MATERIALIZE = {
    "np.asarray", "numpy.asarray", "np.array", "numpy.array",
}
_HOST_CLOCKS = {
    "time.time", "time.perf_counter", "time.monotonic", "time.sleep",
    "time.time_ns", "time.perf_counter_ns", "time.monotonic_ns",
}

#: Attribute tails always followed: the model protocol's callables
#: run on the step path whenever the machinery that receives a
#: ``model`` does.
_PROTOCOL_TAILS = {"reaction", "init"}

#: Host-only code: never on the step path, and full of legitimate
#: host constructs that would only feed name-collision noise.  The
#: analysis and lint tools, and the build-time code that generates and
#: compiles a kernel library once, at its first use, without touching
#: the card (the donation pass watches for a build inside a loop).
_HOST_ONLY_PREFIXES = (
    f"{PACKAGE}.lint",
    f"{PACKAGE}.analysis",
    f"{PACKAGE}.ops._build",
    f"{PACKAGE}.ops.kernelgen",
)

FuncEntry = Tuple[SourceFile, str, ast.AST]


class _Index:
    """Function definitions, resolvable per-file, per-module or
    package-wide."""

    def __init__(self, ctx: LintContext):
        self.by_file: Dict[str, Dict[str, List[FuncEntry]]] = {}
        self.by_module: Dict[str, Dict[str, List[FuncEntry]]] = {}
        self.global_: Dict[str, List[FuncEntry]] = {}
        self.aliases: Dict[str, Dict[str, str]] = {}
        self.classes: Dict[str, Dict[str, List[str]]] = {}
        #: Every package module, the host-only ones included: a link
        #: into one of those leads nowhere, rather than anywhere.
        self.modules = {sf.module for sf in ctx.package_files()}
        for sf in _device_files(ctx):
            per = self.by_file.setdefault(sf.rel, {})
            self.by_module[sf.module] = per
            for qual, fnode, parents in iter_functions(sf.tree):
                e = (sf, qual, fnode)
                per.setdefault(fnode.name, []).append(e)
                self.global_.setdefault(fnode.name, []).append(e)
            self.aliases[sf.rel] = _module_aliases(sf)
            self.classes[sf.rel] = {
                node.name: [b for b in map(dotted, node.bases) if b]
                for node in sf.tree.body
                if isinstance(node, ast.ClassDef)
            }

    def resolve_self(
        self, attr: str, sf: SourceFile, qual: str
    ) -> List[FuncEntry]:
        """Targets of ``self.attr`` inside ``qual``: the method ``attr``
        of its class or of a base class in the same file (an attribute
        that is no method links nowhere); outside a class, any function
        ``attr`` of the file."""
        classes = self.classes.get(sf.rel, {})
        cls = qual.split(".", 1)[0]
        if cls not in classes:
            return self.by_file.get(sf.rel, {}).get(attr, [])
        entries = self.by_file.get(sf.rel, {}).get(attr, [])
        todo: List[str] = [cls]
        seen: Set[str] = set()
        while todo:
            c = todo.pop(0)
            if c in seen or c not in classes:
                continue
            seen.add(c)
            found = [e for e in entries if e[1] == f"{c}.{attr}"]
            if found:
                return found
            todo.extend(classes[c])
        return []

    def _in_module(self, module: str, name: str) -> List[FuncEntry]:
        """Functions ``name`` of package module ``module`` (none when it
        is host-only); every function of that name when ``module`` is
        not a known module (a name re-exported by a package)."""
        if module in self.modules:
            return self.by_module.get(module, {}).get(name, [])
        return self.global_.get(name, [])

    def resolve(
        self, name: str, sf: SourceFile, scope: str
    ) -> List[FuncEntry]:
        """Targets a bare name may denote: a function of the same file,
        or the imported function it is bound to (``scope`` ``"global"``:
        every function of that name, for the protocol tails)."""
        if scope == "global":
            return self.global_.get(name, [])
        local = self.by_file.get(sf.rel, {}).get(name)
        if local:
            return local
        target = self.aliases.get(sf.rel, {}).get(name)
        if target is None:
            return []
        if target in self.modules:
            return []  # a module object, not a function
        module, _, attr = target.rpartition(".")
        return self._in_module(module, attr)

    def resolve_attr(
        self, alias: str, attr: str, sf: SourceFile
    ) -> List[FuncEntry]:
        """Targets of ``alias.attr`` for an in-package import ``alias``:
        the functions ``attr`` of the module it names."""
        target = self.aliases.get(sf.rel, {}).get(alias)
        if target is None:
            return []
        return self._in_module(target, attr)


def _device_files(ctx: LintContext) -> List[SourceFile]:
    return [
        sf for sf in ctx.package_files()
        if not any(in_package(sf.module, p) for p in _HOST_ONLY_PREFIXES)
    ]


def _module_aliases(sf: SourceFile) -> Dict[str, str]:
    """Names this file binds via in-package imports, each with the
    dotted name it binds — module aliases (``from .ops import
    cuda_stencil``) and imported functions (``from .noise import
    plane_seed``) alike."""
    out: Dict[str, str] = {}
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ImportFrom):
            names = resolve_imports(sf, node)
            if not names or not in_package(names[0]):
                continue
            for alias in node.names:
                out[alias.asname or alias.name] = f"{names[0]}.{alias.name}"
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if in_package(alias.name):
                    if alias.asname:
                        out[alias.asname] = alias.name
                    else:
                        top = alias.name.split(".")[0]
                        out[top] = top
    return out


def _own_nodes(fnode: ast.AST) -> List[ast.AST]:
    """The nodes of ``fnode``'s own body: nested ``def`` bodies are
    functions of their own (reached by name, or roots themselves)."""
    out: List[ast.AST] = []
    todo = list(ast.iter_child_nodes(fnode))
    while todo:
        node = todo.pop()
        out.append(node)
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            todo.extend(ast.iter_child_nodes(node))
    return out


def _local_names(fnode: ast.AST, nodes: List[ast.AST]) -> Set[str]:
    """Names ``fnode`` binds itself — its parameters, its lambdas'
    parameters and the names it assigns — which shadow any function of
    the same name (a parameter ``blocks`` is not
    ``FieldSnapshot.blocks``)."""
    out = set(_params(fnode)) | {"self", "cls"}
    for node in nodes:
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
        elif isinstance(node, ast.Lambda):
            out |= _params(node)
    return out


def _references(
    fnode: ast.AST, sf: SourceFile, qual: str, index: _Index
) -> List[FuncEntry]:
    out: List[FuncEntry] = []
    nodes = _own_nodes(fnode)
    local = _local_names(fnode, nodes)
    for node in nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A nested def is part of its host: follow it.
            out.extend(index.resolve(node.name, sf, "file"))
        elif isinstance(node, ast.Name):
            if node.id not in local:
                out.extend(index.resolve(node.id, sf, "file"))
        elif isinstance(node, ast.Attribute):
            if node.attr in _PROTOCOL_TAILS:
                out.extend(index.resolve(node.attr, sf, "global"))
            elif isinstance(node.value, ast.Name):
                base = node.value.id
                if base == "self":
                    out.extend(index.resolve_self(node.attr, sf, qual))
                elif base not in local:
                    out.extend(index.resolve_attr(base, node.attr, sf))
    return out


def _whole_package(ctx: LintContext) -> bool:
    return ctx.module(PACKAGE) is not None and ctx.module(
        _SELF_MODULE) is not None


def _roots(
    ctx: LintContext,
) -> Tuple[List[FuncEntry], List[Finding]]:
    """The declared roots found in the targets (each with its nested
    functions) and, when this module is linted, a finding for each
    declared root that does not exist."""
    roots: List[FuncEntry] = []
    missing: List[Finding] = []
    for module, qual in ROOTS:
        sf = ctx.module(module)
        found = []
        if sf is not None:
            found = [
                (sf, q, fnode)
                for q, fnode, parents in iter_functions(sf.tree)
                if q == qual or q.startswith(qual + ".")
            ]
        if not any(q == qual for _, q, _ in found) and _whole_package(ctx):
            missing.append(Finding(
                PASS_ID, _SELF, 1,
                f"declared per-step root {module}.{qual} no longer "
                f"exists",
                hint="point ROOTS at the function that now runs the "
                     "steps",
            ))
        roots.extend(found)
    return roots, missing


def run(ctx: LintContext) -> List[Finding]:
    index = _Index(ctx)
    roots, findings = _roots(ctx)
    seen: Set[int] = set()
    work = list(roots)
    while work:
        sf, qual, fnode = work.pop()
        if id(fnode) in seen:
            continue
        seen.add(id(fnode))
        findings.extend(_scan(sf, qual, fnode))
        work.extend(_references(fnode, sf, qual, index))
    return findings


def _params(fnode: ast.AST) -> Set[str]:
    if isinstance(
        fnode, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
    ):
        a = fnode.args
        names = {
            p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
        }
        names.discard("self")
        names.discard("cls")
        return names
    return set()


def _tensor_params(fnode: ast.AST) -> Set[str]:
    """The parameters that may hold a tensor: annotated with a type
    that names ``Tensor``, or not annotated at all.  ``seed: int`` is a
    host number, and ``float(seed)`` reads nothing from the card."""
    if not isinstance(fnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return _params(fnode)
    a = fnode.args
    return {
        p.arg
        for p in a.posonlyargs + a.args + a.kwonlyargs
        if p.arg not in ("self", "cls")
        and (p.annotation is None or "Tensor" in ast.unparse(p.annotation))
    }


def _scan(sf: SourceFile, qual: str, fnode: ast.AST) -> List[Finding]:
    findings: List[Finding] = []
    params = _tensor_params(fnode)
    for node in ast.walk(fnode):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        tail = name.split(".")[-1] if name else (
            node.func.attr if isinstance(node.func, ast.Attribute)
            else None
        )
        msg = hint = None
        if tail in _SYNC_TAILS and not node.args and (
            isinstance(node.func, ast.Attribute)
        ):
            msg = (f".{tail}() inside per-step {qual!r} makes the "
                   f"host wait for the card")
            hint = ("keep the value on the card, or read it at the "
                    "boundary, after the steps")
        elif name in _HOST_MATERIALIZE:
            msg = (f"{name} inside per-step {qual!r} copies a tensor "
                   f"to the host")
            hint = "use torch ops on the card inside the step path"
        elif name == "print":
            msg = f"print() inside per-step {qual!r} runs on every step"
            hint = "log at the call boundary"
        elif name in _HOST_CLOCKS:
            msg = (f"{name}() inside per-step {qual!r} puts host "
                   f"timing on the step path")
            hint = "time at the call boundary instead"
        elif name in ("float", "int") and len(node.args) == 1 and (
            isinstance(node.args[0], ast.Name)
            and node.args[0].id in params
        ):
            msg = (f"{name}() on argument {node.args[0].id!r} of "
                   f"per-step {qual!r} reads a tensor argument on the "
                   f"host")
            hint = ("keep the tensor on the card, or take the scalar "
                    "as a Python number at the call boundary")
        if msg:
            findings.append(Finding(
                PASS_ID, sf.rel, node.lineno, msg, hint=hint or ""
            ))
    return findings
