"""The yardstick: peaks of the card and the least time a launch can take.

Frozen copies, so that a later change to the program cannot move the
ruler it is measured with:

- the byte arithmetic of ``grayscott_jl_tpu_torch/obs/xstats.py``
  (``launch_cost``, ``face_mode_work``): each field read once and
  written once per launch, a chain of depth ``fuse`` moving the bytes of
  one step;
- the float operations of one cell and step, fixed per model from its
  equations (:data:`FLOPS_PER_CELL_STEP`), not from the program's own
  count;
- NVIDIA's published peaks of one H100 SXM at its 700 W limit.

Integer work (the noise hash) is not counted as float operations.
"""

from __future__ import annotations

from typing import Optional, Tuple

#: HBM3 bandwidth of one H100 SXM (data sheet), bytes per second.
HBM_BYTES_PER_S = 3.35e12
#: float32 rate outside the tensor cores of one H100 SXM (data sheet).
F32_FLOPS_PER_S = 67e12

#: Float operations of one cell and step, by model, from the equations.
#: Gray-Scott: per field the 7-point Laplacian (5 sums of the six
#: neighbours, the product by 1/6, the difference with the centre: 7)
#: and the Euler update (a product by dt and a sum: 2), 18 for two
#: fields; the noise unit's ``* 2 - 3`` and its product by ``noise`` (3);
#: the reaction ``u*v*v`` (2), ``Du*lap - uvv + F*(1-u) + noise`` (6) and
#: ``Dv*lap + uvv - (F+k)*v`` (5): 34 in all.
FLOPS_PER_CELL_STEP = {"grayscott": 34}

#: Bytes of one cell of one field, by the configuration's precision.
ITEMSIZE = {"Float32": 4, "Float64": 8, "BFloat16": 2}


def bound_of(bytes_moved: float, flops: float) -> Tuple[float, str]:
    """Least time (ms) for ``bytes_moved`` bytes and ``flops`` float32
    operations, and which of the two bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def face_mode_work(mode: str, shape, fuse: int, flops: int,
                   itemsize: int = 4, n_fields: int = 2) -> Tuple[int, int]:
    """Bytes and float operations of one launch of a face mode on a
    ``shape`` block: ``faces6`` reads the block and its six 1-thick face
    planes and writes the block; the x-chain (``xchain``, ``xychain``)
    reads ``nx + 2 fuse`` x-planes and writes ``nx``, its stage ``s``
    computing ``nx + 2 (fuse - 1 - s)`` planes."""
    nx, ny, nz = shape
    vol = nx * ny * nz
    if mode == "faces6":
        face_cells = 2 * (ny * nz + nx * nz + nx * ny)
        moved = n_fields * (2 * vol + face_cells) * itemsize
        cells = vol
    else:
        moved = n_fields * ((nx + 2 * fuse) + nx) * ny * nz * itemsize
        cells = sum((nx + 2 * (fuse - 1 - s)) * ny * nz for s in range(fuse))
    return moved, cells * flops


def launch_cost(mode: str, shape, fuse: int, flops: int, itemsize: int = 4,
                n_fields: int = 2, members: int = 1) -> dict:
    """One launch's ``bytes``, ``flops`` and least time ``bound_ms`` (with
    ``bound_by``): ``members`` members of a ``shape`` block in ``mode``
    (``chain``, ``faces6``, ``xchain``, ``xychain``) at depth ``fuse``."""
    if mode == "chain":
        cells = shape[0] * shape[1] * shape[2]
        moved, ops = 2 * n_fields * itemsize * cells, fuse * flops * cells
    else:
        moved, ops = face_mode_work(mode, shape, fuse, flops, itemsize,
                                    n_fields)
    moved, ops = moved * members, ops * members
    ms, by = bound_of(moved, ops)
    return {"bytes": int(moved), "flops": int(ops), "bound_ms": ms,
            "bound_by": by}


def window_least_ms(modes: dict, *, steps: int, blocks: int, shape,
                    members: int, flops: int, itemsize: int,
                    n_fields: int) -> Optional[float]:
    """Least device time (ms) of the kernel launches of a window, from
    the launches counted per mode (``modes``: mode -> launches) over
    ``steps`` steps of ``blocks`` blocks of ``shape``: a chain's depth is
    the steps its launches advance, ``steps * blocks / launches``; a
    ``faces6`` launch advances one step. None for a mode whose operand
    the counts do not fix (the xy-chain's padded operand, a split
    round's bands), or for no launch."""
    total = 0.0
    counted = 0
    for mode, n in modes.items():
        if not n:
            continue
        if mode in ("chain", "xchain"):
            # A chain's launches advance steps * blocks / n steps each on
            # average (a remainder launch is shallower).
            fuse = steps * blocks / n
            if fuse < 1 or (mode == "xchain" and fuse != int(fuse)):
                return None
            cost = launch_cost(mode, shape,
                               fuse if mode == "chain" else int(fuse), flops,
                               itemsize, n_fields, members)
        elif mode == "faces6":
            cost = launch_cost(mode, shape, 1, flops, itemsize, n_fields,
                               members)
        else:
            return None
        total += n * cost["bound_ms"]
        counted += n
    return total if counted else None
