"""Six-face halo exchange over an in-process device mesh (counterpart of
``grayscott_jl_tpu/parallel/halo.py``).

The reference runs these inside ``shard_map``, one ``lax.ppermute`` per
(axis, direction) carrying the boundary slabs of all fields stacked
along the transfer axis. Here each function takes the list of every
block's field tuple (rank order, :class:`~.mesh.DeviceMesh`) and
returns the per-block result; the stacking, the face order
(axis-major, then field-major, then lo/hi) and the sequential x -> y
-> z corner propagation are the reference's, so the exchanged values
are bitwise the same. The exchange is data movement — slicing,
concatenation and copies between devices — and runs no kernel.

Non-periodic boundaries: a block on the global edge has no neighbour on
that side, and its ghost slab is the field's frozen boundary value.
Edge and corner ghosts of the 1-deep forms are never read by the
7-point stencil and hold the boundary value (or zeros in the kernel's
faces operand, as in the reference).

The split-phase helpers (``frozen_slabs``, ``frozen_frame``,
``start_exchange``, ``PendingExchange``) come with the overlap slice
(ROADMAP Queue 1 item 13a).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .mesh import DeviceMesh

Blocks = Sequence[Sequence[torch.Tensor]]


def _slab(x: torch.Tensor, dim: int, index: int, width: int):
    """A ``width``-thick boundary slab along ``dim``; ``index`` 0 = first
    slab, -1 = last."""
    return x.narrow(dim, 0 if index == 0 else x.shape[dim] - width, width)


def _full_slab(a: torch.Tensor, dim: int, width: int, bv: float):
    shape = list(a.shape)
    shape[dim] = width
    return torch.full(shape, bv, dtype=a.dtype, device=a.device)


def _exchange_dim(blocks: Blocks, boundary_values: Sequence[float],
                  dim: int, mesh: DeviceMesh,
                  width: int = 1) -> List[List[Tuple[torch.Tensor, ...]]]:
    """Resolved (lo, hi) ``width``-thick ghost slabs along mesh axis
    ``dim`` for each field of each block: ``out[rank][field] = (lo,
    hi)``. One ppermute per direction carries all fields (stacked along
    ``dim``); global-edge blocks get the frozen boundary value, and a
    single block on the axis short-circuits to constants."""
    n = mesh.dims[dim]
    if n == 1:
        return [
            [(f, f) for f in (_full_slab(a, dim, width, bv)
                              for a, bv in zip(fields, boundary_values))]
            for fields in blocks
        ]
    n_arr = len(blocks[0])
    send_up = [torch.cat([_slab(a, dim, -1, width) for a in fields], dim)
               for fields in blocks]
    send_dn = [torch.cat([_slab(a, dim, 0, width) for a in fields], dim)
               for fields in blocks]
    from_lo = mesh.ppermute(send_up, dim, +1)  # lower neighbour's top
    from_hi = mesh.ppermute(send_dn, dim, -1)  # upper neighbour's bottom
    out = []
    for fields, lo_all, hi_all in zip(blocks, from_lo, from_hi):
        lo_faces = (torch.split(lo_all, width, dim) if lo_all is not None
                    else (None,) * n_arr)
        hi_faces = (torch.split(hi_all, width, dim) if hi_all is not None
                    else (None,) * n_arr)
        out.append([
            (lo if lo is not None else _full_slab(a, dim, width, bv),
             hi if hi is not None else _full_slab(a, dim, width, bv))
            for a, bv, lo, hi in zip(fields, boundary_values, lo_faces,
                                     hi_faces)
        ])
    return out


def halo_pad(blocks: Blocks, boundary_values: Sequence[float],
             mesh: DeviceMesh) -> List[Tuple[torch.Tensor, ...]]:
    """Ghost-pad each block's fields by one cell, filling the face
    ghosts from mesh neighbours (the frozen boundary value on the global
    edge); edge and corner ghosts keep the boundary value. The plain
    path's form; the kernel takes :func:`exchange_faces` instead."""
    padded = [
        [F.pad(a, (1,) * 6, value=bv)
         for a, bv in zip(fields, boundary_values)]
        for fields in blocks
    ]
    for dim, n in enumerate(mesh.dims):
        if n == 1:
            continue  # a single block on this axis: ghosts stay frozen
        faces = _exchange_dim(blocks, boundary_values, dim, mesh)
        for pads, pairs in zip(padded, faces):
            for p, (lo, hi) in zip(pads, pairs):
                inner = [slice(1, -1)] * 3
                inner[dim] = 0
                p[tuple(inner)] = lo.squeeze(dim)
                inner[dim] = -1
                p[tuple(inner)] = hi.squeeze(dim)
    return [tuple(p) for p in padded]


def halo_pad_wide(blocks: Blocks, boundary_values: Sequence[float],
                  mesh: DeviceMesh,
                  width: int) -> List[Tuple[torch.Tensor, ...]]:
    """Ghost-pad each block's fields ``width`` deep, **edge and corner
    ghosts included**: axes are exchanged in order x, y, z, and each
    slab spans the full padded extent of the axes exchanged before it
    (corner propagation). Each exchange trims its own axis's ghosts, so
    the slabs sent are the outermost OWNED cells."""
    w = width
    padded = [
        [F.pad(a, (w,) * 6, value=bv)
         for a, bv in zip(fields, boundary_values)]
        for fields in blocks
    ]
    for dim, n in enumerate(mesh.dims):
        if n == 1:
            continue  # a single block on this axis: ghosts stay frozen
        m = padded[0][0].shape[dim]
        trimmed = [[p.narrow(dim, w, m - 2 * w) for p in pads]
                   for pads in padded]
        pairs = _exchange_dim(trimmed, boundary_values, dim, mesh, w)
        for pads, prs in zip(padded, pairs):
            for p, (lo, hi) in zip(pads, prs):
                p.narrow(dim, 0, w).copy_(lo)
                p.narrow(dim, m - w, w).copy_(hi)
    return [tuple(p) for p in padded]


def exchange_slabs(blocks: Blocks, boundary_values: Sequence[float],
                   dim: int, mesh: DeviceMesh,
                   width: int) -> List[List[Tuple[torch.Tensor, ...]]]:
    """``width``-wide (lo, hi) boundary slabs along mesh axis ``dim`` for
    each field of each block (global-edge blocks get the boundary
    value). The xy-chain exchanges its y halos with this before the x
    slabs of the y-padded fields, so the x slabs carry the corners."""
    return _exchange_dim(blocks, boundary_values, dim, mesh, width)


def exchange_x_slabs(blocks: Blocks, boundary_values: Sequence[float],
                     mesh: DeviceMesh,
                     width: int) -> List[List[Tuple[torch.Tensor, ...]]]:
    """``width``-wide (lo, hi) x slabs for each field of each block: the
    x-chain's exchange, two ppermutes feeding ``width`` kernel steps."""
    return _exchange_dim(blocks, boundary_values, 0, mesh, width)


def exchange_faces(blocks: Blocks, boundary_values: Sequence[float],
                   mesh: DeviceMesh) -> List[Tuple[torch.Tensor, ...]]:
    """The 1-thick halo faces of each block, the kernel's 6n-face
    operand: for axes x, y, z in order and per field, ``(lo, hi)`` — for
    (u, v) that is ``(u_xlo, u_xhi, v_xlo, v_xhi, u_ylo, ..., v_zhi)``.
    On a global edge, or an axis with a single block, a face holds the
    frozen boundary value."""
    flat: List[List[torch.Tensor]] = [[] for _ in blocks]
    for dim in range(3):
        for out, pairs in zip(flat,
                              _exchange_dim(blocks, boundary_values, dim,
                                            mesh)):
            for lo_hi in pairs:
                out.extend(lo_hi)
    return [tuple(f) for f in flat]
