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

The split-phase round (``comm_overlap``) computes each block's
interior on frozen stand-ins (:func:`frozen_slabs`, :func:`frozen_frame`:
what a global-edge block resolves to) while the exchange is in flight
(:func:`start_exchange`), then recomputes the boundary bands from what
arrived (:class:`PendingExchange`). On the card the exchange runs on a
side stream of each device, ordered after the compute stream's pending
work by an event, so its copies can run beside the interior kernel; the
host never waits.

Every function takes the spatial axes as the LAST three of a field's
tensor (axis ``d`` is the tensor's ``d - 3``), so an ensemble's blocks,
stacked ``(N, nx, ny, nz)`` along a leading member axis, are exchanged
as they are: the member axis rides along in every slab, and nothing
here knows of members.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .mesh import DeviceMesh

Blocks = Sequence[Sequence[torch.Tensor]]


def _slab(x: torch.Tensor, dim: int, index: int, width: int):
    """A ``width``-thick boundary slab along spatial axis ``dim``;
    ``index`` 0 = first slab, -1 = last."""
    td = dim - 3
    return x.narrow(td, 0 if index == 0 else x.shape[td] - width, width)


def _full_slab(a: torch.Tensor, dim: int, width: int, bv: float):
    shape = list(a.shape)
    shape[dim - 3] = width
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
    td = dim - 3
    send_up = [torch.cat([_slab(a, dim, -1, width) for a in fields], td)
               for fields in blocks]
    send_dn = [torch.cat([_slab(a, dim, 0, width) for a in fields], td)
               for fields in blocks]
    from_lo = mesh.ppermute(send_up, dim, +1)  # lower neighbour's top
    from_hi = mesh.ppermute(send_dn, dim, -1)  # upper neighbour's bottom
    out = []
    for fields, lo_all, hi_all in zip(blocks, from_lo, from_hi):
        lo_faces = (torch.split(lo_all, width, td) if lo_all is not None
                    else (None,) * n_arr)
        hi_faces = (torch.split(hi_all, width, td) if hi_all is not None
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
                inner = [Ellipsis] + [slice(1, -1)] * 3
                inner[1 + dim] = 0
                p[tuple(inner)] = lo.squeeze(dim - 3)
                inner[1 + dim] = -1
                p[tuple(inner)] = hi.squeeze(dim - 3)
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
        td = dim - 3
        m = padded[0][0].shape[td]
        trimmed = [[p.narrow(td, w, m - 2 * w) for p in pads]
                   for pads in padded]
        pairs = _exchange_dim(trimmed, boundary_values, dim, mesh, w)
        for pads, prs in zip(padded, pairs):
            for p, (lo, hi) in zip(pads, prs):
                p.narrow(td, 0, w).copy_(lo)
                p.narrow(td, m - w, w).copy_(hi)
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


def frozen_slabs(arrays: Sequence[torch.Tensor],
                 boundary_values: Sequence[float], dim: int,
                 width: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Constant (lo, hi) ``width``-thick slabs along ``dim`` at each
    array's frozen boundary value: the stand-in the split-phase interior
    consumes instead of exchanged slabs (what a global-edge block, or
    an axis with a single block, resolves to)."""
    out = []
    for a, bv in zip(arrays, boundary_values):
        f = _full_slab(a, dim, width, bv)
        out.append((f, f))
    return out


def frozen_frame(arrays: Sequence[torch.Tensor],
                 boundary_values: Sequence[float],
                 width: int) -> Tuple[torch.Tensor, ...]:
    """Each array ghost-padded ``width`` deep with its frozen boundary
    value on every side: the :func:`halo_pad_wide` stand-in of the
    split-phase interior (as if every block were on the global edge of
    every axis)."""
    return tuple(F.pad(a, (width,) * 6, value=bv)
                 for a, bv in zip(arrays, boundary_values))


def _tensors(tree):
    """The tensors of a nest of lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)


class PendingExchange:
    """An exchange in flight (:func:`start_exchange`). On the card its
    work is queued on each device's side stream behind ``done`` events;
    :meth:`finish` is its first consumption point."""

    def __init__(self, result, events=None):
        self._result = result
        self._events = events or {}

    def finish(self):
        """The exchange's per-block result. On the card each device's
        current stream waits on the side stream's event (no host wait),
        and each result tensor is marked as used by that stream
        (``record_stream``), so that the allocator keeps its memory —
        allocated on the side stream — until the consumer is done."""
        if self._events:
            for d, ev in self._events.items():
                torch.cuda.current_stream(d).wait_event(ev)
            for t in _tensors(self._result):
                t.record_stream(torch.cuda.current_stream(t.device))
            self._events = {}
        return self._result


def start_exchange(blocks: Blocks, boundary_values: Sequence[float],
                   mesh: DeviceMesh, width: int,
                   exchange: Callable = halo_pad_wide) -> PendingExchange:
    """Issue ``exchange(blocks, boundary_values, mesh, width)`` — by
    default the corner-propagated frame of :func:`halo_pad_wide`; the
    x-chain passes :func:`exchange_x_slabs`, the xy-chain's slab form
    its y-then-x slab exchange — without tying it into the caller's
    compute: the same copies in the same order, consumed only through
    :meth:`PendingExchange.finish`.

    On the card, every device of the mesh has a side stream
    (:meth:`~.mesh.DeviceMesh.side_stream`) that waits on an event
    recorded on its current (compute) stream; the exchange runs with
    those side streams current (a copy between two cards runs on the
    source's and is ordered before the destination's), and a ``done``
    event is recorded on each. The blocks' tensors are marked
    as used by the side streams (``record_stream``), so a caller may
    drop them while the exchange still reads them. On the CPU the
    exchange runs at once."""
    devices = [d for d in dict.fromkeys(mesh.devices) if d.type == "cuda"]
    if not devices:
        return PendingExchange(exchange(blocks, boundary_values, mesh,
                                        width))
    streams = {}
    for d in devices:
        st = streams[d] = mesh.side_stream(d)
        st.wait_stream(torch.cuda.current_stream(d))
    for fields, d in zip(blocks, mesh.devices):
        for f in fields:
            f.record_stream(streams[d])
    with contextlib.ExitStack() as stack:
        for st in streams.values():
            stack.enter_context(torch.cuda.stream(st))
        result = exchange(blocks, boundary_values, mesh, width)
        events = {}
        for d, st in streams.items():
            ev = torch.cuda.Event()
            ev.record(st)
            events[d] = ev
    return PendingExchange(result, events)
