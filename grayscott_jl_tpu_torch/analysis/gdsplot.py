"""Plot simulation output: mid-plane slices and PDF heatmaps (a copy of
``grayscott_jl_tpu/analysis/gdsplot.py`` over the port's
``io.open_reader``; host-only, no torch; matplotlib imported at first
use, with the ``Agg`` backend).

CLI::

    python -m grayscott_jl_tpu_torch.analysis.gdsplot out.bp [--var U]
        [--step -1] [--axis x] [--index mid] [--output slice.png]

Renders a 2D mid-plane (or chosen) slice of U or V at a given output step,
or — with ``--pdf`` on a pdfcalc output store — the per-slice PDF heatmap.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from ..io import open_reader

_AXES = {"x": 0, "y": 1, "z": 2}


def load_slice(
    path: str,
    var: str = "U",
    step: int = -1,
    axis: str = "x",
    index: Optional[int] = None,
) -> np.ndarray:
    """A 2D slice of ``var`` at output step ``step`` (negative = from end)."""
    r = open_reader(path)
    n = r.num_steps()
    if n == 0:
        raise ValueError(f"{path} contains no steps")
    if step < 0:
        step = n + step
    data = r.get(var, step=step)
    ax = _AXES[axis]
    if index is None:
        index = data.shape[ax] // 2
    r.close()
    return np.take(data, index, axis=ax)


def plot_slice(
    path: str,
    var: str = "U",
    step: int = -1,
    axis: str = "x",
    index: Optional[int] = None,
    output: Optional[str] = None,
):
    """Render a slice with matplotlib; returns the output filename."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sl = load_slice(path, var, step, axis, index)
    fig, ax_ = plt.subplots(figsize=(6, 5))
    im = ax_.imshow(sl.T, origin="lower", cmap="viridis")
    ax_.set_title(f"{var} slice ({axis}={index if index is not None else 'mid'})")
    other = [a for a in _AXES if a != axis]
    ax_.set_xlabel(other[0])
    ax_.set_ylabel(other[1])
    fig.colorbar(im, ax=ax_)
    out = output or f"{var.lower()}_slice.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_pdf(
    path: str,
    var: str = "U",
    step: int = -1,
    output: Optional[str] = None,
):
    """Heatmap of a pdfcalc output store's per-slice PDFs."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    r = open_reader(path)
    n = r.num_steps()
    if step < 0:
        step = n + step
    pdf = r.get(f"{var}/pdf", step=step)
    bins = r.get(f"{var}/bins", step=step)
    r.close()

    fig, ax = plt.subplots(figsize=(7, 4))
    im = ax.imshow(
        pdf,
        origin="lower",
        aspect="auto",
        extent=(float(bins[0]), float(bins[-1]), 0, pdf.shape[0]),
        cmap="magma",
    )
    ax.set_xlabel(f"{var} value")
    ax.set_ylabel("slice index")
    ax.set_title(f"{var} per-slice PDF")
    fig.colorbar(im, ax=ax, label="count")
    out = output or f"{var.lower()}_pdf.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="gdsplot")
    p.add_argument("input", help="BP-lite store (simulation or pdfcalc output)")
    p.add_argument("--var", default="U", choices=["U", "V"])
    p.add_argument("--step", type=int, default=-1)
    p.add_argument("--axis", default="x", choices=list(_AXES))
    p.add_argument("--index", type=int, default=None)
    p.add_argument("--pdf", action="store_true", help="plot pdfcalc output")
    p.add_argument("--output", default=None)
    ns = p.parse_args(argv)
    if ns.pdf:
        out = plot_pdf(ns.input, ns.var, ns.step, ns.output)
    else:
        out = plot_slice(ns.input, ns.var, ns.step, ns.axis, ns.index, ns.output)
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
