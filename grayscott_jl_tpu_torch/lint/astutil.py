"""Small AST helpers shared by the passes (a copy of
``grayscott_jl_tpu/lint/astutil.py``).  Stdlib only."""

from __future__ import annotations

import ast
import sys
from typing import Iterator, List, Optional, Tuple

from .context import SourceFile


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    """The dotted name a call targets, else None."""
    return dotted(call.func)


def tail_name(node: ast.AST) -> Optional[str]:
    """The final identifier of a Name/Attribute (``self._run`` ->
    ``_run``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def is_stdlib(module: str) -> bool:
    top = module.split(".", 1)[0]
    return top == "__future__" or top in sys.stdlib_module_names


def resolve_imports(sf: SourceFile, node: ast.AST) -> List[str]:
    """Absolute dotted module names an Import/ImportFrom statement
    references (relative imports resolved against the file's module).

    ``from ..models import grayscott`` in ``ops/envelope`` yields
    both ``grayscott_jl_tpu_torch.models`` and
    ``grayscott_jl_tpu_torch.models.grayscott`` — an imported *name* may be a
    submodule, and layering checks need to see it either way."""
    if isinstance(node, ast.Import):
        return [alias.name for alias in node.names]
    if not isinstance(node, ast.ImportFrom):
        return []
    if node.level == 0:
        base = node.module or ""
    else:
        parts = sf.module.split(".")
        if not sf.is_package:
            parts = parts[:-1]
        if node.level > 1:
            parts = parts[: len(parts) - (node.level - 1)]
        base = ".".join(parts)
        if node.module:
            base = f"{base}.{node.module}" if base else node.module
    out = [base] if base else []
    for alias in node.names:
        if alias.name != "*" and base:
            out.append(f"{base}.{alias.name}")
    return out


FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)


def iter_functions(
    tree: ast.Module,
) -> Iterator[Tuple[str, ast.AST, Tuple[ast.AST, ...]]]:
    """Yield ``(qualname, func_node, parents)`` for every function and
    lambda, with ``qualname`` like ``Simulation._sharded_run.<locals>.chain``
    abbreviated to dotted defs only (``Simulation._sharded_run.chain``)."""

    def walk(node: ast.AST, prefix: str, parents: Tuple[ast.AST, ...]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, FuncDef):
                qual = f"{prefix}{child.name}"
                yield qual, child, parents
                yield from walk(child, qual + ".", parents + (child,))
            elif isinstance(child, ast.ClassDef):
                yield from walk(
                    child, f"{prefix}{child.name}.", parents + (child,)
                )
            else:
                yield from walk(child, prefix, parents)

    yield from walk(tree, "", ())


def enclosing_function_names(
    parents: Tuple[ast.AST, ...]
) -> List[str]:
    return [
        p.name for p in parents if isinstance(p, FuncDef)
    ]
