"""Cross-block temporal blocking for the sharded kernel path
(counterpart of ``grayscott_jl_tpu/parallel/temporal.py``).

The kernel chains ``k`` steps per launch on shrinking windows. Crossing
a block boundary with that chain needs k-deep halo data:

* **x**: the x-chain mode takes k-wide exchanged x slabs directly;
* **y**: :func:`xy_chain` extends the operand by a k-deep exchanged y
  halo, and the kernel's global-coordinate pinning makes in-domain halo
  rows recompute the y neighbour's values;
* **z**: the kernel runs with frozen z edges, which spoils the
  outermost k z-cells of each sharded z side (one cell per stage), and
  :func:`stitch_bands_from_frame` recomputes those k-wide bands with
  :func:`window_chain` in torch ops from a corner-propagated k-deep
  frame (``halo.halo_pad_wide``).

On the TPU the y extent is rounded up to Mosaic's sublane tile with
boundary-valued filler rows; the card has no such tile, and the filler
rows only push the spoiled front outward, so they are left out here and
change no value the caller keeps.

Every form reproduces the step-at-a-time trajectory bitwise (the same
per-cell operations in the same order, position-keyed noise): the
plain window chain, the kernel's chain and the band recompute agree
cell for cell, which the tests assert.

As in ``halo.py``, the spatial axes are a field tensor's last three: an
ensemble's member-stacked blocks ``(N, nx, ny, nz)`` pass through every
function here unchanged, with the member-stacked params and noise the
caller's ``params_of`` and ``unit_noise`` hand in.

The split-phase form (``xy_chain(..., overlap=True)``, gated by
:func:`xy_overlap_feasible`) issues the same exchange first
(``halo.start_exchange``), runs the kernel on frozen boundary values,
and recomputes the k-thick x and y boundary bands from what arrived
with ``band_kernel`` — the x-chain program on a thin body, the same
computation per cell as the fused round's — before the z bands. The
s-step schedule (``halo_depth = k``) runs either form unchanged at
depth ``fuse * k``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops import stencil
from . import halo
from .mesh import DeviceMesh


def pin_out_of_domain(arr: torch.Tensor, bv: float, origin,
                      row: int) -> torch.Tensor:
    """Pin every cell whose GLOBAL coordinate falls outside ``[0, row)``
    on any axis to the frozen boundary value ``bv``; ``origin`` is the
    global coordinate of ``arr[0, 0, 0]``. Pins pad cells inside a block
    of a non-divisible grid as well as ring cells outside the domain."""
    valid = None
    for dim in range(3):
        n = arr.shape[dim - 3]
        g = int(origin[dim]) + torch.arange(n, device=arr.device)
        view = [1, 1, 1]
        view[dim] = n
        vd = ((g >= 0) & (g < row)).view(view)
        valid = vd if valid is None else valid & vd
    return torch.where(valid, arr, bv)


def window_chain(fields_w, params, model, *, depth, step, origin, row,
                 use_noise, unit_noise, boundaries: Sequence[float],
                 final_pin: bool = True, compute_dtype=None):
    """``depth`` plain steps on ghost-inclusive field windows, shrinking
    one cell per side per stage; returns the (shape - 2*depth) cores.

    ``origin`` is the global coordinate of each window's ``[0, 0, 0]``;
    after each stage, cells outside the global domain are pinned to the
    per-field ``boundaries`` (:func:`pin_out_of_domain`).
    ``unit_noise(step, origin, shape, device)`` draws the
    position-keyed noise.
    ``final_pin=False`` skips the last stage's pin, legal when every
    output cell is in the domain. ``compute_dtype`` is
    :func:`~..ops.stencil.reaction_update`'s (``bf16_f32acc``): each
    stage accumulates in it and rounds back to the storage dtype. Same
    operations in the same order as the kernel, so a band computed here
    sits next to kernel cells seamlessly."""
    fields_w = tuple(fields_w)
    for s in range(depth):
        shape = tuple(d - 2 for d in fields_w[0].shape[-3:])
        o = tuple(int(c) + s + 1 for c in origin)
        if use_noise:
            noise_term = stencil.scaled_noise(params.noise, unit_noise(
                step + s, o, shape, fields_w[0].device))
        else:
            noise_term = 0.0
        fields_w = stencil.reaction_update(fields_w, noise_term, params,
                                           model, compute_dtype)
        if s + 1 < depth or final_pin:
            fields_w = tuple(
                pin_out_of_domain(f, bv, o, row)
                for f, bv in zip(fields_w, boundaries)
            )
    return fields_w


def stitch_bands_from_frame(fields_i, fields_w, params, model, *, depth,
                            step, offs, row, axis_sizes, use_noise,
                            unit_noise, boundaries: Sequence[float],
                            dims_to_stitch: Sequence[int] = (0, 1, 2),
                            compute_dtype=None):
    """Overwrite the ``depth``-thick boundary bands of one block's
    results ``fields_i`` with :func:`window_chain` recomputes from its
    exchanged corner-propagated frame ``fields_w``
    (``halo.halo_pad_wide``, width ``depth``). Each band is recomputed
    from a 3k-deep frame window spanning the frame's full extent on the
    other axes, so corner cells in two bands get the same values twice.
    Axes with a single block, or not in ``dims_to_stitch``, are skipped.
    ``offs`` is the block's global origin; ``compute_dtype`` is
    :func:`window_chain`'s. Returns new tensors."""
    k = depth
    fields_i = [f.clone() for f in fields_i]
    base = [int(o) - k for o in offs]  # global origin of the frame
    for dim in range(3):
        if axis_sizes[dim] == 1 or dim not in dims_to_stitch:
            continue
        td = dim - 3
        n_d = fields_i[0].shape[td]
        m = fields_w[0].shape[td]  # n_d + 2k
        for d0, w0 in ((0, 0), (n_d - k, m - 3 * k)):
            origin = list(base)
            origin[dim] += w0
            bands = window_chain(
                tuple(f.narrow(td, w0, 3 * k) for f in fields_w), params,
                model, depth=k, step=step, origin=origin, row=row,
                use_noise=use_noise, unit_noise=unit_noise,
                boundaries=boundaries, compute_dtype=compute_dtype,
            )
            for fi, b in zip(fields_i, bands):
                fi.narrow(td, d0, k).copy_(b)
    return tuple(fields_i)


def xy_overlap_feasible(local, dims, depth) -> bool:
    """Whether the split-phase form of :func:`xy_chain` applies: always
    in the frame form (z sharded); in the slab form only when every
    sharded slab axis is at least ``2 * depth`` deep (the band windows
    are cut from owned slices, and a shallower block has no interior to
    hide the exchange behind)."""
    if dims[2] > 1:
        return True
    k = depth
    return not ((dims[0] > 1 and local[0] < 2 * k) or local[1] < 2 * k)


def _slab_exchange(blocks, bvs, mesh: DeviceMesh, k: int):
    """The slab form's exchange: k-wide y slabs first, then the x slabs
    of the y-padded fields, so that the x slabs carry the y corners.
    Per block ``(y-padded fields, x pairs)``."""
    y_pairs = halo.exchange_slabs(blocks, bvs, 1, mesh, k)
    padded = [
        tuple(torch.cat([lo, f, hi], dim=-2)
              for f, (lo, hi) in zip(fields, pairs))
        for fields, pairs in zip(blocks, y_pairs)
    ]
    x_pairs = halo.exchange_slabs(padded, bvs, 0, mesh, k)
    return list(zip(padded, x_pairs))


def _interleave(los, his):
    """Field-major (lo, hi) faces tuple from per-field slabs."""
    return tuple(x for pair in zip(los, his) for x in pair)


def _band_jobs(cut, shape, offs, dims, k):
    """The split-phase x and y band recomputes of one block: ``[(body,
    faces, origin, kept rows, x/y position)]``. ``cut(xs, ys)`` is each
    field's exchanged cells at x range ``xs`` (owned coordinates, in
    ``[-k, nx + k)``: the x ghosts included) and y-extended row range
    ``ys`` (in ``[0, ny + 2k)``). y bands: 3k rows (the arrived slab and
    2k owned rows) over the owned planes, the x ghosts of those rows as
    faces; x bands: k planes over every y-extended row, the arrived x
    slab outside and the adjacent owned planes inside. The bodies are
    made contiguous here, once (the kernel reads dense fields)."""
    nx, ny, _ = shape
    m_y = ny + 2 * k
    jobs = []
    if dims[1] > 1:
        for y0, o_y, d_y in ((0, -k, 0), (m_y - 3 * k, ny - 2 * k, ny - k)):
            ys = (y0, y0 + 3 * k)
            jobs.append((
                tuple(b.contiguous() for b in cut((0, nx), ys)),
                _interleave(cut((-k, 0), ys), cut((nx, nx + k), ys)),
                (offs[0], offs[1] + o_y, offs[2]), (k, 2 * k), (0, d_y)))
    if dims[0] > 1:
        ally = (0, m_y)
        for x0, lo, hi in ((0, (-k, 0), (k, 2 * k)),
                           (nx - k, (nx - 2 * k, nx - k), (nx, nx + k))):
            jobs.append((
                tuple(b.contiguous() for b in cut((x0, x0 + k), ally)),
                _interleave(cut(lo, ally), cut(hi, ally)),
                (offs[0] + x0, offs[1] - k, offs[2]), (k, k + ny), (x0, 0)))
    return jobs


def xy_chain(blocks, params_of: Callable, model, *, depth, step, offsets,
             chain_kernel: Callable, use_noise, unit_noise, row,
             mesh: DeviceMesh, boundaries: Sequence[float],
             compute_dtype=None, overlap: bool = False,
             band_kernel: Optional[Callable] = None) -> List[tuple]:
    """``depth`` fused steps on every block of an (n, m, p) mesh: the
    kernel's chain crosses x and y block boundaries, and sharded z sides
    get the band recompute. ``blocks`` is every block's field tuple
    (rank order), ``offsets`` their global origins, ``params_of(rank)``
    the params on that block's device.

    ``params_of``, ``unit_noise`` and ``compute_dtype`` serve the z-band
    recompute (:func:`stitch_bands_from_frame`): the caller passes the
    kernel's posture there, so the bands equal the kernel's cells.
    ``chain_kernel(rank, fields_p, faces, step, offs_p)`` runs the
    kernel (or its plain version) at ``fuse=depth`` on one block's
    y-extended operand: ``fields_p`` are ``(nx, ny + 2k, nz)`` with rows
    covering global ``[offs_p[1], offs_p[1] + ny + 2k)``, ``faces`` the
    field-major (lo, hi) x slabs of the same rows. Returns the new
    per-block field tuples.

    With z sharded, one corner-propagated k-deep frame (6 ppermutes)
    serves the operand, its x faces and the z bands; otherwise k-wide y
    slabs are exchanged first and then the x slabs of the y-padded
    fields, so the x faces carry the corners (4 ppermutes).

    ``overlap=True`` is the split-phase form: the same exchange is
    started first (``halo.start_exchange``), the kernel runs on the
    fields y-padded with the boundary value and frozen x faces, and the
    k-thick x and y bands of every sharded axis are then recomputed
    from what arrived by ``band_kernel(rank, body, faces, step,
    origin)`` — the x-chain at ``fuse=depth`` on a body of 3k rows or k
    planes (:func:`_band_jobs`) — and written over the interior's,
    before the z bands. A geometry :func:`xy_overlap_feasible` refuses
    takes the fused round (bitwise the same)."""
    bvs = tuple(boundaries)
    dims = mesh.dims
    k = depth
    z_sharded = dims[2] > 1
    shape = tuple(blocks[0][0].shape[-3:])
    nx, ny, nz = shape
    if overlap and not xy_overlap_feasible(shape, dims, k):
        overlap = False  # no interior to hide the exchange behind
    if overlap and band_kernel is None:
        raise ValueError("xy_chain overlap=True requires band_kernel")

    if overlap:
        pending = halo.start_exchange(
            blocks, bvs, mesh, k,
            exchange=halo.halo_pad_wide if z_sharded else _slab_exchange)
        operands = []
        for fields in blocks:
            fields_p = tuple(F.pad(f, (0, 0, k, k), value=bv)
                             for f, bv in zip(fields, bvs))
            operands.append((fields_p, tuple(
                x for pr in halo.frozen_slabs(fields_p, bvs, 0, k)
                for x in pr)))
    elif z_sharded:
        frames = halo.halo_pad_wide(blocks, bvs, mesh, k)
        operands = [
            (tuple(w[..., k:k + nx, :, k:k + nz].contiguous() for w in fw),
             _interleave(tuple(w[..., 0:k, :, k:k + nz] for w in fw),
                         tuple(w[..., k + nx:, :, k:k + nz] for w in fw)))
            for fw in frames
        ]
    else:
        operands = [
            (fields_pr, _interleave(tuple(lo for lo, _ in pairs),
                                    tuple(hi for _, hi in pairs)))
            for fields_pr, pairs in _slab_exchange(blocks, bvs, mesh, k)
        ]

    out = []
    for rank, ((fields_p, faces), offs) in enumerate(zip(operands,
                                                         offsets)):
        offs_p = (offs[0], offs[1] - k, offs[2])
        res = chain_kernel(rank, fields_p, faces, step, offs_p)
        out.append(tuple(f[..., k:k + ny, :].contiguous() for f in res))

    if overlap:
        exchanged = pending.finish()
        if z_sharded:
            frames = exchanged
        for rank, res in enumerate(out):
            if z_sharded:
                def cut(xs, ys, fw=frames[rank]):
                    return tuple(w[..., xs[0] + k:xs[1] + k, ys[0]:ys[1],
                                   k:k + nz] for w in fw)
            else:
                def cut(xs, ys, ex=exchanged[rank]):
                    fields_pr, pairs = ex
                    if xs[0] < 0:
                        src, xs = [lo for lo, _ in pairs], (0, k)
                    elif xs[0] >= nx:
                        src, xs = [hi for _, hi in pairs], (0, k)
                    else:
                        src = fields_pr
                    return tuple(f[..., xs[0]:xs[1], ys[0]:ys[1], :]
                                 for f in src)
            for body, faces_b, origin, (r0, r1), (dx, dy) in _band_jobs(
                    cut, shape, offsets[rank], dims, k):
                band = band_kernel(rank, body, faces_b, step, origin)
                for o, b in zip(res, band):
                    o[..., dx:dx + b.shape[-3], dy:dy + r1 - r0, :].copy_(
                        b[..., r0:r1, :])

    if z_sharded:
        # The kernel ran with frozen z edges: its outermost k z-cells
        # are stale wherever a z neighbour exists (and exactly right on
        # global z edges). Recompute both k-wide bands from the frame;
        # the values are bitwise the same, so overwriting
        # unconditionally is right on edge blocks too.
        out = [
            stitch_bands_from_frame(
                res, frames[rank], params_of(rank), model, depth=k,
                step=step, offs=offsets[rank], row=row, axis_sizes=dims,
                use_noise=use_noise, unit_noise=unit_noise,
                boundaries=bvs, dims_to_stitch=(2,),
                compute_dtype=compute_dtype,
            )
            for rank, res in enumerate(out)
        ]
    return out
