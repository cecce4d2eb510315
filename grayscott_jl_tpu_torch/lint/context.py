"""Shared lint context: file discovery, parsing, suppressions (a copy of
``grayscott_jl_tpu/lint/context.py`` for the port's package).

Every pass sees the same :class:`LintContext` — one parse of each
target file, one suppression index, one place that knows how a file
path maps to a package module name.  Stdlib only.
"""

from __future__ import annotations

import ast
import glob
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: The package the passes hold to its contracts.
PACKAGE = "grayscott_jl_tpu_torch"

#: ``# gslint: disable=trace-safety,env-knobs`` (or ``all``) anywhere
#: on a line suppresses that line's findings for the named passes.
_SUPPRESS_RE = re.compile(r"#\s*gslint:\s*disable=([\w\-, ]+)")


def in_package(module: str, prefix: str = PACKAGE) -> bool:
    """True for ``prefix`` itself and the modules under it (a dotted
    prefix never matches a sibling that merely starts with its text)."""
    return module == prefix or module.startswith(prefix + ".")


class SourceFile:
    """One parsed target file."""

    def __init__(self, root: str, path: str):
        self.path = path
        self.rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=self.rel)
        #: dotted module name: ``grayscott_jl_tpu_torch/ops/stencil.py``
        #: -> ``grayscott_jl_tpu_torch.ops.stencil``; ``chip_smoke.py``
        #: -> ``chip_smoke``.
        mod = self.rel[:-3] if self.rel.endswith(".py") else self.rel
        self.is_package = mod.endswith("/__init__")
        if self.is_package:
            mod = mod[: -len("/__init__")]
        self.module = mod.replace("/", ".")
        self.suppressions = self._parse_suppressions()

    def _parse_suppressions(self) -> Dict[int, Tuple[str, ...]]:
        out: Dict[int, Tuple[str, ...]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                out[i] = tuple(
                    p.strip() for p in m.group(1).split(",") if p.strip()
                )
        return out


class LintContext:
    """The target file set plus repo-level lookups the passes share."""

    def __init__(self, root: str, targets: Sequence[str]):
        self.root = os.path.abspath(root)
        self.targets = list(targets)
        self.files: List[SourceFile] = []
        seen = set()
        for path in self._expand(targets):
            if path in seen:
                continue
            seen.add(path)
            self.files.append(SourceFile(self.root, path))
        self.files.sort(key=lambda f: f.rel)
        self._by_module = {f.module: f for f in self.files}

    def _expand(self, targets: Sequence[str]) -> Iterable[str]:
        for t in targets:
            path = t if os.path.isabs(t) else os.path.join(self.root, t)
            if os.path.isfile(path):
                yield path
            elif os.path.isdir(path):
                for dirpath, dirnames, filenames in os.walk(path):
                    dirnames[:] = [
                        d
                        for d in dirnames
                        if d != "__pycache__" and not d.startswith(".")
                    ]
                    for name in sorted(filenames):
                        if name.endswith(".py"):
                            yield os.path.join(dirpath, name)
            else:
                raise FileNotFoundError(f"lint target {t!r} not found")

    # ------------------------------------------------------- lookups

    def module(self, name: str) -> Optional[SourceFile]:
        return self._by_module.get(name)

    def package_files(self) -> List[SourceFile]:
        """Target files inside the ``grayscott_jl_tpu_torch`` package
        (and nothing of the reference package, whose name is a prefix
        of it)."""
        return [f for f in self.files if in_package(f.module)]

    def suppressed(self, rel: str, line: int, pass_id: str) -> bool:
        for f in self.files:
            if f.rel == rel:
                tags = f.suppressions.get(line, ())
                return pass_id in tags or "all" in tags
        return False

    # -------------------------------------------- repo-level sources

    def doc_files(self) -> List[str]:
        """The knob-table documentation set: ``docs/*.md``, README, and
        BASELINE.md (the bench contract doc)."""
        out = [
            p
            for p in (
                os.path.join(self.root, "README.md"),
                os.path.join(self.root, "BASELINE.md"),
            )
            if os.path.isfile(p)
        ]
        out.extend(sorted(glob.glob(os.path.join(self.root, "docs", "*.md"))))
        return out

    def doc_text(self) -> str:
        parts = []
        for p in self.doc_files():
            with open(p, encoding="utf-8") as f:
                parts.append(f.read())
        return "\n".join(parts)

    def auxiliary_reader_text(self) -> str:
        """Source text of the port's non-target knob *readers*: its own
        tests (``tests/test_torch_*.py``) and the example settings and
        launchers.  A knob only these read is still alive, so the
        dead-knob check scans them — as text, not AST.  The reference
        package's tests and benchmarks are not readers of the port."""
        parts = []
        patterns = (
            os.path.join(self.root, "tests", "test_torch_*.py"),
            os.path.join(self.root, "examples", "**", "*"),
        )
        for pattern in patterns:
            for p in sorted(glob.glob(pattern, recursive=True)):
                if os.path.isfile(p):
                    try:
                        with open(p, encoding="utf-8") as f:
                            parts.append(f.read())
                    except (OSError, UnicodeDecodeError):
                        continue
        return "\n".join(parts)
