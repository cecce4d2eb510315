"""Inspect the 3D domain decomposition (a copy of
``grayscott_jl_tpu/analysis/decomp.py`` over the port's
``parallel/domain.py``; host-only, no torch).

Given a device count and grid size, show how :func:`dims_create`
factorizes the mesh and which (sizes, offsets) block each shard owns —
the text of the reference's, character for character.

CLI::

    python -m grayscott_jl_tpu_torch.analysis.decomp 8 --L 256
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from ..parallel.domain import CartDomain, dims_create


def describe(n_devices: int, L: int) -> str:
    dims = dims_create(n_devices)
    lines = [
        f"devices = {n_devices} -> mesh dims {dims} "
        f"(axes x,y,z; like MPI_Dims_create)",
        f"global grid {L}^3, "
        + (
            "equal blocks "
            + "x".join(str(L // d) for d in dims)
            if all(L % d == 0 for d in dims)
            else "UNEVEN blocks (sharded path requires divisibility)"
        ),
        f"{'rank':>4} {'coords':>10} {'sizes':>15} {'offsets':>15}",
    ]
    dom = CartDomain(L=L, dims=dims)
    for r in range(n_devices):
        c = dom.coords(r)
        lines.append(
            f"{r:>4} {str(c):>10} {str(dom.proc_sizes(c)):>15} "
            f"{str(dom.proc_offsets(c)):>15}"
        )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="decomp")
    p.add_argument("n_devices", type=int)
    p.add_argument("--L", type=int, default=128)
    ns = p.parse_args(argv)
    print(describe(ns.n_devices, ns.L))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
