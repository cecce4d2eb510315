"""gslint for the port — its contracts as machine-checked passes.

The counterpart of ``grayscott_jl_tpu/lint/`` over
``grayscott_jl_tpu_torch``: the same six pass ids, ``Finding``,
suppression syntax, baseline and ``gslint/1`` JSON document, with each
pass holding the port's own form of the contract (pure model
reactions, zero per-model code in ``ops``/``parallel``, no JAX or
reference import and the torch-free modules kept so, env knobs synced
with the docs knob tables, event kinds synced with ``obs/report.py``'s
``--check`` registry, no host syncs in the per-step bodies, and the
kernel-build and host-ring hazards).  Stdlib-only: it imports neither
torch nor JAX, and it lints itself.

Entry points:

* ``python -m grayscott_jl_tpu_torch.lint`` — the CLI (``--json`` for
  tooling), over ``grayscott_jl_tpu_torch`` and ``chip_smoke.py`` by
  default,
* :func:`run_lint` — the library call the tier-1 self-check test uses,
* per-line suppression: ``# gslint: disable=<pass>[,<pass>|all]``,
* ``gslint-baseline.json`` at the repo root — committed **empty** by
  contract; real findings get fixed, not baselined.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Sequence

from .context import LintContext

__all__ = [
    "Finding",
    "LintContext",
    "PASSES",
    "findings_to_json",
    "load_baseline",
    "run_lint",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation: where, which pass, what, and the fix."""

    pass_id: str
    path: str  #: repo-relative posix path
    line: int
    message: str
    hint: str = ""
    severity: str = "error"  #: "error" fails the CLI; "warning" reports

    def key(self) -> str:
        """Stable identity used by the (always-empty) baseline file."""
        return f"{self.pass_id}:{self.path}:{self.line}"

    def render(self) -> str:
        text = (f"{self.path}:{self.line}: [{self.pass_id}] "
                f"{self.severity}: {self.message}")
        if self.hint:
            text += f"\n    hint: {self.hint}"
        return text


def _registry() -> Dict[str, Callable[[LintContext], List[Finding]]]:
    # Imported lazily so a syntax error in one pass module does not
    # take down `import grayscott_jl_tpu_torch.lint` for the others' tests.
    from . import (
        donation,
        env_knobs,
        events_schema,
        layering,
        purity,
        trace_safety,
    )

    return {
        trace_safety.PASS_ID: trace_safety.run,
        purity.PASS_ID: purity.run,
        layering.PASS_ID: layering.run,
        env_knobs.PASS_ID: env_knobs.run,
        events_schema.PASS_ID: events_schema.run,
        donation.PASS_ID: donation.run,
    }


#: pass id -> pass callable; import-time stable so ``--list`` and the
#: docs catalog can enumerate without running anything.
PASSES: Dict[str, Callable[[LintContext], List[Finding]]] = _registry()


def run_lint(
    root: str,
    targets: Sequence[str],
    select: Optional[Sequence[str]] = None,
    baseline: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Run the selected passes (default: all) over ``targets`` and
    return unsuppressed, non-baselined findings, stable-sorted by
    (path, line, pass)."""
    ctx = LintContext(root, targets)
    selected = list(select) if select else sorted(PASSES)
    unknown = [p for p in selected if p not in PASSES]
    if unknown:
        raise ValueError(
            f"unknown pass id(s) {unknown}; available: {sorted(PASSES)}"
        )
    findings: List[Finding] = []
    for pass_id in selected:
        for f in PASSES[pass_id](ctx):
            if ctx.suppressed(f.path, f.line, f.pass_id):
                continue
            findings.append(f)
    baselined = set(baseline or ())
    findings = [f for f in findings if f.key() not in baselined]
    findings.sort(key=lambda f: (f.path, f.line, f.pass_id))
    return findings


def load_baseline(path: str) -> List[str]:
    """The committed baseline: a JSON list of finding keys. Empty by
    contract — the file exists so the *mechanism* stays exercised."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, list) or not all(
        isinstance(k, str) for k in data
    ):
        raise ValueError(
            f"baseline {path} must be a JSON list of finding keys"
        )
    return data


def findings_to_json(
    findings: Sequence[Finding], root: str, targets: Sequence[str]
) -> dict:
    """The stable ``--json`` document (the reference's ``gslint/1``
    schema, docs/ANALYSIS.md)."""
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.pass_id] = counts.get(f.pass_id, 0) + 1
    return {
        "schema": "gslint/1",
        "root": root,
        "targets": list(targets),
        "passes": sorted(PASSES),
        "counts": counts,
        "errors": sum(1 for f in findings if f.severity == "error"),
        "warnings": sum(
            1 for f in findings if f.severity == "warning"
        ),
        "findings": [dataclasses.asdict(f) for f in findings],
    }
