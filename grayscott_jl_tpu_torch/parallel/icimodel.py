"""The fabric model behind ``kernel_language = "Auto"`` (counterpart of
``grayscott_jl_tpu/parallel/icimodel.py``).

The reference projects a sharded step from single-chip anchors, halo
bytes, link rates and hop latencies, and picks between its XLA and
Pallas languages. On the card the choice is between the two schedules
of the one CUDA kernel (``ops/csrc/stencil_chain.cu``):

* the depth-1 face schedule (``kFaces6``: one launch per block per step
  after an exchange of 6n faces), projected by :func:`project` at depth
  1, its per-stage cost :data:`STAGE_RATIO` over the single block;
* the chain schedules at depth k >= 2: the x-chain on ``(n, 1, 1)``
  meshes (:func:`project_1d`), the xy-chain on the others
  (:func:`project_chain`), with the z bands recomputed in eager torch
  ops when z is sharded (:data:`Z_BAND_US_PER_CELL`).

The plain torch path is the port's oracle, never a candidate on the
card; off the card Auto resolves to it (:func:`select_kernel`), as the
reference resolves to XLA off the TPU, and its projection is the
reference's XLA one (:func:`project` at every depth).

Three terms are the card's own. :data:`LAUNCH_US` is the host time of
one kernel launch through its wrapper: a block's round cannot take less
than its launches' host time (the sharded path on one card is
host-bound, PERF.md §5), and the split round issues the band launches
of :func:`split_band_launches` beside the interior's. The blocks one
process issues run one after another (on one card they share the
device, across cards the host issues them in turn), so a row's
``projected_step_us`` is the per-block step times the blocks of the
process. And the s-step schedule (``halo_depth``) runs the kernel's
chain at depth ``fuse * halo_depth``, so a round is priced at that
depth's :data:`FUSE_COST_RATIO` (:data:`SSTEP_AT_CHAIN_DEPTH`). At
``launch_us = 0`` and with that switch off every projection is the
reference's formula.

Under ``comm_overlap = "auto"`` the analytic pick also decides the
split round: :func:`select_kernel` projects each chain split and fused
and keeps the faster (``row["comm_overlap"]``), as the tuner toggles it.

Feasibility is the shared-memory ledger the runner applies
(``ops/cuda_stencil.max_feasible_chain_depth``), so the model never
projects a schedule the kernel would refuse.

Every coefficient was measured on an NVIDIA H100 80GB HBM3 at 700.00 W
(torch 2.11.0+cu128, CUDA 12.8) by ``python -m
grayscott_jl_tpu_torch.probes.fabric`` and copied from its JSON: the
one-card values from "fabric run b" (2026-10-17), the ``peer`` and
``nccl`` fabrics from the four-card "fabric quad" run (PERF.md, "The
fabric model's coefficients", lists both runs); no number here was
taken on a TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: Single-block per-step cost at chain depth k relative to depth 1 (the
#: card's best, ``simulation.MEASURED_BEST_FUSE``): float32 Gray-Scott
#: at L=256, noise 0.1, host clock over warm rounds (``probes.fabric``
#: "fuse_cost_ratio", fabric run b, H100 700 W). Depths past the float32
#: shared-memory cap (5) have no entry and are not ranked.
FUSE_COST_RATIO = {1: 1.0, 2: 1.5914, 3: 3.1041, 4: 3.6917, 5: 4.4847}

#: Single-block µs/step by (kernel path, L): the CUDA kernel at depth 1
#: and the plain torch path, float32 Gray-Scott, noise 0.1, host clock
#: with a device synchronise per round (``probes.fabric`` "anchors",
#: fabric run b, H100 700 W).
MEASURED_US = {
    ("cuda", 128): 74.42,
    ("cuda", 256): 190.53,
    ("cuda", 512): 1418.19,
    ("plain", 128): 1340.44,
    ("plain", 256): 5127.54,
}

#: Per-stage device cost of a sharded step over the single block's, for
#: the same cells: the 6n-face kernel on the (2,2,2) blocks of L=256
#: against the single-block kernel (the profiler's device time;
#: ``probes.fabric`` "stage_ratio", fabric run b, H100 700 W). The plain
#: path is stepwise on one block too, so its ratio is 1.0 by construction.
STAGE_RATIO = {"cuda": 1.7944, "plain": 1.0}

#: Host µs of one kernel launch through ``cuda_stencil.fused_step`` (the
#: wrapper's checks, tensor maps and the launch), on a block whose device
#: time is negligible (``probes.fabric`` "launch_us", fabric run b, H100
#: 700 W): the least time a block's round can take on the host.
LAUNCH_US = 125.76

#: Device time per member of a batched launch (the stencil kernel with
#: its members on the grid's y axis, ``ensemble/engine.py``) over the
#: solo launch's, float32 Gray-Scott at L=256: a batched round is priced
#: as N times the per-member device time, floored once at
#: :data:`LAUNCH_US` (one launch's host time for all members), where N
#: solo launches would pay the floor N times. ``chip_smoke.py`` phase 4
#: (ix) (e), N = 5 against N = 1, the profiler's device time (0.8883 ms
#: a launch of 5 members against 0.1857 ms of one; H100 80GB HBM3,
#: 700.00 W, PERF.md "ens_only run 1").
MEMBER_COST_RATIO = 0.9568

#: Share of the ideally hideable exchange the split-phase round hides
#: (``comm_overlap``), in [0, 1]: the realized overlap is
#: ``OVERLAP_EFFICIENCY * compute / comm``, at most 1. Calibrated
#: through this model (the split round's band launches priced) from the
#: split and fused rounds of the (8,1,1) x-chain at depth 2 on one card
#: (``probes.fabric._calibrate`` on fabric run b's step times, H100
#: 700 W): the fit is -0.3183 (2.4440 against 0.9578 ms/step fused; the
#: split round hides nothing there), so it is 0.
OVERLAP_EFFICIENCY = 0.0

#: Share of the ideal 1/k hop-latency saving the s-step schedule
#: (``halo_depth``) realizes, per kernel path, in [0, 1]: calibrated
#: through this model from ``halo_depth`` 1 against 2 on (8,1,1) at
#: depth 2 on one card (``probes.fabric._calibrate`` on fabric run b's
#: step times, H100 700 W), the kernel's round priced at its depth
#: (:data:`SSTEP_AT_CHAIN_DEPTH`). The fits are 1.2199 for the kernel
#: (1.0514 against 0.9578 ms/step: less than the depth-4 ratio prices)
#: and -1.8159 for the plain path (k=2 measured slower), so 1 and 0.
HALO_DEPTH_EFFICIENCY = {
    "plain": 0.0,
    "cuda": 1.0,
}

#: Price an s-step round (``halo_depth`` k > 1) at the kernel's chain
#: depth ``fuse * k``, which it runs, where :data:`FUSE_COST_RATIO` has
#: that depth. The reference prices it at the base depth and absorbs the
#: deeper walk in its ``HALO_DEPTH_EFFICIENCY`` (False: its formula).
SSTEP_AT_CHAIN_DEPTH = True

#: Single-block cost of the ``bf16_f32acc`` posture (bf16 fields, float32
#: arithmetic) over float32, L=256 depth 1 (``probes.fabric``
#: "bf16_compute_ratio", fabric run b, H100 700 W).
BF16_COMPUTE_RATIO = 0.9770

#: µs per output cell of the z-band recompute
#: (``parallel/temporal.stitch_bands_from_frame``, eager torch ops), on
#: the (2,2,2) blocks of L=256 at depth 2, host time (``probes.fabric``
#: "z_band_us_per_cell", fabric run b, H100 700 W). The reference prices
#: its bands at its XLA kernel's per-cell rate; on the card they are the
#: largest cost of a z-sharded chain (PERF.md §5).
Z_BAND_US_PER_CELL = 0.045872

#: The y operand's row alignment. The card has no sublane tile: the
#: xy-chain's operand is exactly ``ny + 2k`` rows.
SUBLANE = 1


@dataclasses.dataclass(frozen=True)
class Fabric:
    """How blocks exchange faces on one placement: the copy rate of one
    face (GB/s), how many faces move at once, and the host µs one face's
    exchange costs beside its bytes."""

    link_gbps: float
    links: int
    hop_us: float


#: Fabrics by device kind (a substring of ``torch.cuda.get_device_name``)
#: and placement: ``shared`` (blocks on one card, one process: the 6n-face
#: exchange of the (2,2,2) blocks of L=256, host µs per face and block,
#: the faces' bytes over its device time), ``peer`` (the same blocks over
#: four cards of one process), ``nccl`` and ``gloo`` (processes:
#: ``launch_times``' host µs per ppermute, bytes over that time). From
#: ``probes.fabric``: fabric run b on one H100 (700 W), the fabric quad
#: run on four.
_FABRICS = {
    "H100": {
        "shared": Fabric(37.759, 6, 35.392),
        "peer": Fabric(31.899, 6, 52.466),
        "nccl": Fabric(0.48462, 6, 270.46),
        "gloo": Fabric(0.12399, 6, 2114.31),
    },
}

#: The kind whose table serves a card the table does not name.
_DEFAULT_KIND = "H100"

#: Placements of :data:`_FABRICS`.
PLACEMENTS = ("shared", "peer", "nccl", "gloo")


def sstep_amortization(halo_depth: int, efficiency: float = None,
                       lang: str = "plain") -> float:
    """Share of the per-chain-round exchange hop latency that remains
    under s-step exchange at depth ``halo_depth``: 1.0 at k=1, ``1 -
    efficiency * (1 - 1/k)`` deeper (``lang``'s calibrated
    :data:`HALO_DEPTH_EFFICIENCY` when ``efficiency`` is None)."""
    k = max(1, int(halo_depth))
    if k == 1:
        return 1.0
    eff = HALO_DEPTH_EFFICIENCY[lang] if efficiency is None else efficiency
    return 1.0 - eff * (1.0 - 1.0 / k)


def overlap_fraction(compute_us: float, comm_us: float,
                     efficiency: float = None) -> float:
    """Calibrated overlap fraction for a config: the share of raw comm
    hidden behind ``compute_us`` of comm-independent interior work."""
    if comm_us <= 0 or compute_us <= 0:
        return 0.0
    eff = OVERLAP_EFFICIENCY if efficiency is None else efficiency
    return max(0.0, min(1.0, eff * compute_us / comm_us))


def _split(overlap) -> bool:
    """Whether a projection's ``overlap`` is the split round's (``"auto"``
    or a positive fraction) rather than the fused round's."""
    return overlap == "auto" or float(overlap) > 0


def split_band_launches(dims, local, depth: int) -> int:
    """Band launches the split round adds per block and round: two for
    each of x and y that is sharded (``parallel/temporal._band_jobs``,
    the x-chain's ``xchain_split``), where the runner takes the split
    form at this depth (``temporal.xy_overlap_feasible``; the x-chain
    needs ``nx >= 2 * depth``); 0 where it takes the fused round."""
    n, m, p = dims
    nx, ny, _ = local
    if m == 1 and p == 1:
        return 2 if n > 1 and nx >= 2 * depth else 0
    if p == 1 and ((n > 1 and nx < 2 * depth) or ny < 2 * depth):
        return 0
    return 2 * (n > 1) + 2 * (m > 1)


def _chain_ratio(fuse: int, s_steps: int) -> float:
    """The chain's per-step cost ratio: at the base depth ``fuse``, or at
    the s-step round's depth under :data:`SSTEP_AT_CHAIN_DEPTH`."""
    r = FUSE_COST_RATIO.get(fuse)
    if r is None:
        raise ValueError(f"no measured fuse-cost ratio for k={fuse}")
    if SSTEP_AT_CHAIN_DEPTH and s_steps > fuse:
        r = FUSE_COST_RATIO.get(s_steps, r)
    return r


def _resolve_overlap(overlap, compute_us: float, raw_comm_us: float):
    """Projection-row overlap: an explicit fraction, or ``"auto"`` for
    the calibrated ``overlap_fraction`` of this config."""
    if overlap == "auto":
        return overlap_fraction(compute_us, raw_comm_us)
    return float(overlap)


def anchor_us(lang: str, L: int) -> float:
    """Single-block µs/step for a full L^3 grid: the measured anchor with
    the closest side, rescaled throughput-flat."""
    sides = sorted(s for k, s in MEASURED_US if k == lang)
    side = min(sides, key=lambda s: abs(s - L))
    return MEASURED_US[(lang, side)] * (L / side) ** 3


def project(
    local: int,
    fuse: int,
    us_per_step: float,
    *,
    stage_ratio: float = 1.0,
    itemsize: int = 4,
    links: int = 6,
    link_gbps: float = 90.0,
    hop_us: float = 1.0,
    overlap: float = 0.0,
    halo_depth: int = 1,
    n_fields: int = 2,
    launch_us: float = 0.0,
) -> dict:
    """Weak-scaling projection for one cubic-local config, as the
    reference's: the per-stage ratio, the ring recompute of a k-step
    window chain, and the exposed exchange (serialization at the
    max-loaded link plus hop latency) amortized over the steps of a
    round. ``launch_us`` floors the compute at one launch's host time
    per block per round (0: the reference's formula)."""
    sk = max(1, int(halo_depth))
    s_steps = fuse * sk  # steps per exchange round
    wide = local + 2 * s_steps  # corner-propagated exchange slab
    face_bytes = wide * wide * s_steps * itemsize * n_fields
    total_bytes = 6 * face_bytes
    faces_per_link = -(-6 // links)  # ceil
    ser_us = faces_per_link * face_bytes / (link_gbps * 1e3) / s_steps
    lat_us = 6 * hop_us / fuse * sstep_amortization(sk)
    raw_us = ser_us + lat_us
    recompute = sum(
        (local + 2 * (s_steps - 1 - s)) ** 3 for s in range(s_steps)
    ) / (s_steps * local**3)
    compute = max(us_per_step * stage_ratio * recompute, launch_us / s_steps)
    ov = _resolve_overlap(overlap, compute, raw_us)
    comm_us = raw_us * (1.0 - ov)
    eff = us_per_step / (compute + comm_us)
    return {
        "local": local,
        "fuse": fuse,
        "halo_depth": sk,
        "stage_ratio": stage_ratio,
        "compute_us_per_step": round(us_per_step, 1),
        "ring_recompute_ratio": round(recompute, 4),
        "halo_bytes_per_round": total_bytes,
        "halo_bytes_per_step": round(total_bytes / s_steps),
        "exchanges_per_step": round(1.0 / s_steps, 4),
        "comm_us_per_step_exposed": round(comm_us, 2),
        "comm_us_per_step_hidden": round(raw_us - comm_us, 2),
        "links": links,
        "link_gbps": link_gbps,
        "overlap": round(ov, 4),
        "projected_weak_scaling_eff": round(eff, 4),
    }


def best_fuse(local, us_per_step, *, kmax=8, **kw):
    """The depth in [1, kmax] with the best projected efficiency."""
    return max(
        (project(local, k, us_per_step, **kw) for k in range(1, kmax + 1)),
        key=lambda r: r["projected_weak_scaling_eff"],
    )


def _feasible_chain_depth(local, dims, itemsize, kmax, n_fields=2):
    """Deepest chain depth <= ``kmax`` the runner's gates admit on blocks
    ``local`` of mesh ``dims``: the chain form's geometry caps and the
    shared-memory ledger (``cuda_stencil.max_feasible_chain_depth``)."""
    from ..ops import cuda_stencil

    return cuda_stencil.max_feasible_chain_depth(
        local, dims, itemsize, kmax, n_fields)


def band_cells_per_round(local, k):
    """Output cells of the two z-side band recomputes per k-step round
    (``parallel/temporal.stitch_bands_from_frame``): stage s shrinks the
    (nx+2k, ny+2k, 3k) window by one cell per side."""
    nx, ny, nz = local
    cells = 0
    for s in range(k):
        cells += ((nx + 2 * (k - s) - 2) * (ny + 2 * (k - s) - 2)
                  * (3 * k - 2 * s - 2))
    return 2 * cells


def project_chain(
    dims,
    L: int,
    fuse: int,
    base_us_full: float,
    *,
    local=None,
    itemsize: int = 4,
    sublane: int = None,
    links: int = 6,
    link_gbps: float = 90.0,
    hop_us: float = 1.0,
    overlap: float = 0.0,
    band_us_per_cell: float = None,
    halo_depth: int = 1,
    n_fields: int = 2,
    launch_us: float = 0.0,
) -> dict:
    """Weak-scaling projection for the xy-chain
    (``parallel/temporal.xy_chain``) on an (n, m, p) mesh, as the
    reference's: ``FUSE_COST_RATIO[fuse]`` over the depth-1 single
    block, the y-plane growth of the ``ny + 2k`` operand (rounded up to
    ``sublane``, default :data:`SUBLANE`), the x ring recompute, the z
    bands (p > 1) at ``band_us_per_cell`` (default
    :data:`Z_BAND_US_PER_CELL`) and the
    exposed exchange (4 slab ppermutes for (n, m, 1), 6 z-sharded, at
    the max-loaded link). ``halo_depth`` deepens the exchanged frame to
    ``fuse * halo_depth`` (priced at that depth's ratio, see
    :func:`_chain_ratio`). ``base_us_full`` is the single-block µs/step
    of the whole L^3 grid; ``local`` overrides the block (pad-and-mask
    ceil blocks). ``launch_us`` floors the kernel pass at its launches'
    host time per round, the split round's bands included."""
    n, m, p = dims
    if local is None:
        local = (L // n, L // m, L // p)
    nx, ny, nz = local
    if sublane is None:
        sublane = SUBLANE
    us_base = base_us_full / (n * m * p)
    k = fuse
    sk = max(1, int(halo_depth))
    s_steps = k * sk  # in-kernel steps per exchange round
    r = _chain_ratio(fuse, s_steps)
    ny_ext = ny + 2 * s_steps
    ny_ext += (-ny_ext) % sublane
    y_over = ny_ext / ny if (m > 1 or p > 1) else 1.0
    x_ring = 1.0 + (s_steps - 1) / nx
    launches = 1 + (split_band_launches(dims, local, s_steps)
                    if _split(overlap) else 0)
    compute_us = max(us_base * r * y_over * x_ring,
                     launch_us * launches / s_steps)

    if p > 1:
        if band_us_per_cell is None:
            band_us_per_cell = Z_BAND_US_PER_CELL
        band_us = (band_cells_per_round(local, s_steps) * band_us_per_cell
                   / s_steps)
        zx, zy = nz + 2 * s_steps, ny + 2 * s_steps
        face_bytes = max(
            zy * zx, (nx + 2 * s_steps) * zx, (nx + 2 * s_steps) * zy
        ) * itemsize * n_fields
        n_faces = 6
    else:
        band_us = 0.0
        face_bytes = max(ny_ext * nz, nx * nz) * itemsize * n_fields
        n_faces = (2 if n > 1 else 0) + (2 if m > 1 else 0)
    faces_per_link = -(-n_faces // links) if n_faces else 0
    ser_us = faces_per_link * face_bytes / (link_gbps * 1e3)
    lat_us = n_faces * hop_us / k * sstep_amortization(sk, lang="cuda")
    raw_us = ser_us + lat_us
    # Only the kernel pass is comm-independent in the split round; the
    # band recomputes consume the exchange.
    ov = _resolve_overlap(overlap, compute_us, raw_us)
    comm_us = raw_us * (1.0 - ov)

    eff = us_base / (compute_us + band_us + comm_us)
    return {
        "mesh": f"{n},{m},{p}",
        "local": list(local),
        "fuse": k,
        "halo_depth": sk,
        "fuse_cost_ratio": r,
        "compute_us_per_step": round(us_base, 1),
        "halo_bytes_per_step": round(n_faces * face_bytes / s_steps),
        "exchanges_per_step": (round(1.0 / s_steps, 4)
                               if n_faces else 0.0),
        "y_plane_overhead": round(y_over, 4),
        "x_ring_recompute": round(x_ring, 4),
        "z_band_us_per_step": round(band_us, 2),
        "comm_us_per_step_exposed": round(comm_us, 2),
        "comm_us_per_step_hidden": round(raw_us - comm_us, 2),
        "links": links,
        "link_gbps": link_gbps,
        "overlap": round(ov, 4),
        "projected_weak_scaling_eff": round(eff, 4),
    }


def _mesh_candidates(n_devices: int, L: int):
    """All (n, m, p) ordered factorizations of ``n_devices`` whose dims
    divide L — the mixed-mesh sweep space."""
    out = []
    for n in range(1, n_devices + 1):
        if n_devices % n or L % n:
            continue
        rest = n_devices // n
        for m in range(1, rest + 1):
            if rest % m or L % m:
                continue
            p = rest // m
            if L % p:
                continue
            out.append((n, m, p))
    return out


def best_chain_depth(dims, L, base_us_full, *, local=None, itemsize=4,
                     kmin=2, kmax=8, n_fields=2, **kw):
    """Best feasible chain row for ONE mesh: (n, 1, 1) to the x-chain
    model, every other mesh to the xy-chain model, each depth in [kmin,
    kmax] gated as the runner gates it (:func:`_feasible_chain_depth`)
    and ranked only where :data:`FUSE_COST_RATIO` has a ratio. ``None``
    when no depth survives."""
    n, m, p = dims
    if local is None:
        local = tuple(L // d for d in dims)
    if min(local) < 2:
        return None
    if m == 1 and p == 1:
        cap = _feasible_chain_depth(local, dims, itemsize,
                                    max(kmin, local[0]), n_fields)
        ks = [k for k in FUSE_COST_RATIO if kmin <= k <= min(cap, kmax)]
        rows = [project_1d(n, L, k, base_us_full, local=local,
                           itemsize=itemsize, n_fields=n_fields, **kw)
                for k in ks]
    else:
        cap = _feasible_chain_depth(local, dims, itemsize, kmax, n_fields)
        ks = [k for k in FUSE_COST_RATIO if kmin <= k <= cap]
        rows = [project_chain(dims, L, k, base_us_full, local=local,
                              itemsize=itemsize, n_fields=n_fields,
                              **kw)
                for k in ks]
    if not rows:
        return None
    return max(rows, key=lambda r: r["projected_weak_scaling_eff"])


def best_chain(n_devices, L, base_us_full, *, itemsize=4, kmax=8, **kw):
    """Sweep mesh factorization x feasible chain depth; the best row, or
    ``None`` when no factorization admits a feasible depth >= 2."""
    best = None
    for dims in _mesh_candidates(n_devices, L):
        r = best_chain_depth(dims, L, base_us_full, itemsize=itemsize,
                             kmax=kmax, **kw)
        if r is not None and (
            best is None
            or r["projected_weak_scaling_eff"]
            > best["projected_weak_scaling_eff"]
        ):
            best = r
    return best


def project_1d(
    n: int,
    L: int,
    fuse: int,
    base_us_per_step: float,
    *,
    local=None,
    itemsize: int = 4,
    links: int = 6,
    link_gbps: float = 90.0,
    hop_us: float = 1.0,
    overlap: float = 0.0,
    halo_depth: int = 1,
    n_fields: int = 2,
    launch_us: float = 0.0,
) -> dict:
    """Weak-scaling projection for the x-chain on an (n, 1, 1) mesh, as
    the reference's: ``FUSE_COST_RATIO[fuse]`` times the x ring
    recompute, and a k-wide x slab pair per round. ``base_us_per_step``
    is the single-block µs/step of the whole grid; ``local`` overrides
    the block; ``launch_us`` floors the kernel pass at its launches'
    host time per round, the split round's bands included."""
    if local is None:
        local = (L // n, L, L)
    nx, ny, nz = local
    us_base = base_us_per_step / n
    sk = max(1, int(halo_depth))
    s_steps = fuse * sk  # steps per exchange round (s-step exchange)
    recompute = 1.0 + (s_steps - 1) / nx  # ring grows only along x
    r = _chain_ratio(fuse, s_steps)
    faces_per_link = -(-2 // links)
    ser_us = (faces_per_link * ny * nz * itemsize * n_fields
              / (link_gbps * 1e3))
    lat_us = 2 * hop_us / fuse * sstep_amortization(sk, lang="cuda")
    raw_us = ser_us + lat_us
    launches = 1 + (split_band_launches((n, 1, 1), local, s_steps)
                    if _split(overlap) else 0)
    compute = max(us_base * r * recompute, launch_us * launches / s_steps)
    ov = _resolve_overlap(overlap, compute, raw_us)
    comm_us = raw_us * (1.0 - ov)
    eff = us_base / (compute + comm_us)
    return {
        "mesh": f"{n},1,1",
        "local": nx,
        "fuse": fuse,
        "halo_depth": sk,
        "fuse_cost_ratio": r,
        "compute_us_per_step": round(us_base, 1),
        "ring_recompute_ratio": round(recompute, 4),
        "halo_bytes_per_step": round(2 * ny * nz * itemsize * n_fields),
        "exchanges_per_step": round(1.0 / s_steps, 4),
        "comm_us_per_step_exposed": round(comm_us, 2),
        "comm_us_per_step_hidden": round(raw_us - comm_us, 2),
        "links": links,
        "link_gbps": link_gbps,
        "overlap": round(ov, 4),
        "projected_weak_scaling_eff": round(eff, 4),
    }


def best_fuse_1d(n, L, base_us, *, itemsize=4, **kw):
    """The x-chain's depth sweep including depth 1, gated as
    :func:`best_chain_depth` gates it."""
    return best_chain_depth((n, 1, 1), L, base_us, itemsize=itemsize,
                            kmin=1, kmax=max(FUSE_COST_RATIO), **kw)


# --------------------------------------------------------- Auto dispatch

def placement_of(devices, processes: int = 1, backend=None) -> str:
    """The placement of a run's blocks: the process group's backend
    (``nccl``/``gloo``) in a run of several processes, ``peer`` when
    this process's blocks span several cards, else ``shared``."""
    if processes > 1 and backend in ("nccl", "gloo"):
        return backend
    import torch

    cards = {torch.device(d) for d in devices
             if torch.device(d).type == "cuda"}
    return "peer" if len(cards) > 1 else "shared"


def fabric_for(device_kind: str, placement: str = "shared") -> Fabric:
    """The :class:`Fabric` of ``placement`` on a card of
    ``device_kind``; ``GS_AUTO_LINK_GBPS`` / ``GS_AUTO_LINKS`` override
    its rate and link count, as in the reference."""
    from ..config.env import env_float, env_int

    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}, got "
                         f"{placement!r}")
    kind = (device_kind or "").upper()
    table = next((t for sub, t in _FABRICS.items() if sub.upper() in kind),
                 _FABRICS[_DEFAULT_KIND])
    fab = table[placement]
    return dataclasses.replace(
        fab, link_gbps=env_float("GS_AUTO_LINK_GBPS", float(fab.link_gbps)),
        links=env_int("GS_AUTO_LINKS", int(fab.links)))


def _step_us(base: float, row: dict, blocks: int = 1) -> float:
    """A row's µs/step: the per-block step (``base`` over the row's
    efficiency, which the rows round to 1e-4 and a tiny grid can round to
    0: read as 1e-4) times the blocks of the process."""
    return blocks * base / max(row["projected_weak_scaling_eff"], 1e-4)


def _objective(objective):
    from ..config.env import env_str

    objective = objective or env_str("GS_AUTO_OBJECTIVE", "efficiency")
    if objective not in ("efficiency", "throughput"):
        raise ValueError(
            f"GS_AUTO_OBJECTIVE must be 'efficiency' or 'throughput', "
            f"got {objective!r}"
        )
    return objective


def select_kernel(
    dims,
    L: int,
    *,
    platform: str = "cuda",
    device_kind: str = "",
    placement: str = "shared",
    blocks: int = 1,
    itemsize: int = 4,
    fuse: int = 5,
    eff_target: float = 0.90,
    objective: str = None,
    overlap="auto",
    sweep_mesh: bool = False,
    n_fields: int = 2,
    overlap_auto: bool = False,
):
    """Resolve ``kernel_language = "Auto"`` for a concrete run config.

    Returns ``(lang, info)``: ``lang`` is ``"cuda"`` on the card and
    ``"plain"`` off it; ``info`` records the decision (rows, objective,
    reason) and, sharded, ``info["pick"]``, the index in ``info["rows"]``
    of the schedule to run:

    * off the card: the plain path (the kernel's plain version is the
      port's oracle, not a schedule to pick);
    * on the card, no schedule when the shared-memory ledger admits no
      depth for these fields: :class:`SettingsError` (the plain path is
      never the card's fallback);
    * one block: the kernel at its depth;
    * sharded: the depth-1 face schedule on ``dims`` (``"faces6"``) and
      the best chain at depth 2..``fuse`` (``"x-chain"`` or
      ``"xy-chain"``; on the best swept mesh under ``sweep_mesh``, the
      mesh not pinned) projected on ``placement``'s
      :func:`fabric_for`, and picked by ``objective`` as the reference
      picks: ``"efficiency"`` (default, ``GS_AUTO_OBJECTIVE``) the
      fastest of the rows projected >= ``eff_target``, else the fastest
      outright; ``"throughput"`` the fastest. ``fuse < 2`` leaves no
      chain to project. ``blocks`` is the blocks this process issues
      (their steps add up: the rows' ``projected_step_us``).
      ``overlap_auto`` (``comm_overlap = "auto"``) projects each chain
      both with ``overlap`` and fused and keeps the faster form; the
      chain row's ``comm_overlap`` says which (a tie keeps ``overlap``).
    """
    objective = _objective(objective)
    n, m, p = dims
    n_devices = n * m * p
    info = {
        "dims": list(dims), "L": L, "platform": platform,
        "objective": objective, "eff_target": eff_target,
    }
    if platform != "cuda":
        info["reason"] = (
            "off the card the kernel runs as its plain version, the "
            "port's oracle; the plain path is the compiled path here"
        )
        return "plain", info

    from ..models.base import SettingsError
    from ..ops import cuda_stencil

    feasible = cuda_stencil.max_feasible_fuse(itemsize, n_fields)
    if feasible < 1:
        need = cuda_stencil.smem_bytes(itemsize, 1, n_fields)
        raise SettingsError(
            f"kernel_language = 'Auto': no schedule of the CUDA kernel "
            f"fits {n_fields} fields of {itemsize} bytes on the card: the "
            f"shared-memory ledger needs {need} bytes at depth 1, limit "
            f"{cuda_stencil.SMEM_LIMIT} (use fewer fields or a narrower "
            f"precision, or kernel_language = 'Plain')"
        )
    if n_devices == 1:
        info["reason"] = (
            f"single block: generated CUDA kernel (shared-memory "
            f"ledger admits depth {feasible})"
        )
        return "cuda", info

    fab = fabric_for(device_kind, placement)
    info.update(placement=placement, blocks=blocks,
                link_gbps=fab.link_gbps, links=fab.links, hop_us=fab.hop_us,
                launch_us=LAUNCH_US)
    kw = dict(links=fab.links, link_gbps=fab.link_gbps, hop_us=fab.hop_us,
              n_fields=n_fields, launch_us=LAUNCH_US)
    local = tuple(-(-L // d) for d in dims)  # ceil: pad-and-mask storage
    side = round((local[0] * local[1] * local[2]) ** (1 / 3))
    base_full = anchor_us("cuda", L)
    base = base_full / n_devices
    # The face schedule runs every round fused (a depth-1 round has no
    # split form).
    faces_row = project(side, 1, base, stage_ratio=STAGE_RATIO["cuda"],
                        itemsize=itemsize, overlap=0.0, **kw)
    faces_row.update(kernel="cuda", schedule="faces6",
                     mesh=",".join(str(d) for d in dims))

    def chain_for(ov):
        if sweep_mesh:
            return best_chain(n_devices, L, base_full, itemsize=itemsize,
                              kmax=fuse, overlap=ov, **kw)
        return best_chain_depth(dims, L, base_full, local=local,
                                itemsize=itemsize, kmax=fuse, overlap=ov,
                                **kw)

    chain_row = None if fuse < 2 else chain_for(overlap)
    if chain_row is not None and overlap_auto:
        chain_row["comm_overlap"] = _split(overlap)
        other = chain_for(0.0 if _split(overlap) else "auto")
        if other is not None and (other["projected_weak_scaling_eff"]
                                  > chain_row["projected_weak_scaling_eff"]):
            chain_row = dict(other, comm_overlap=not _split(overlap))
    rows = [faces_row]
    if chain_row is not None:
        cm = tuple(int(x) for x in chain_row["mesh"].split(","))
        chain_row.update(kernel="cuda", schedule=(
            "x-chain" if cm[1] == 1 and cm[2] == 1 else "xy-chain"))
        rows.append(chain_row)
    for row in rows:
        row["projected_step_us"] = round(_step_us(base, row, blocks), 1)
    info["rows"] = rows
    meets = [i for i, r in enumerate(rows)
             if r["projected_weak_scaling_eff"] >= eff_target]
    info["eff_target_holders"] = [rows[i]["schedule"] for i in meets]
    if objective == "efficiency" and meets:
        pick = min(meets, key=lambda i: rows[i]["projected_step_us"])
        info["reason"] = (
            f"fastest among schedules projected >= {eff_target:.0%} "
            "weak-scaling"
        )
    else:
        pick = min(range(len(rows)),
                   key=lambda i: rows[i]["projected_step_us"])
        info["reason"] = (
            f"no schedule projected >= {eff_target:.0%} at this config; "
            "fastest outright" if objective == "efficiency"
            else "fastest projected absolute step time")
    info["pick"] = pick
    return "cuda", info


def precision_compute_ratio(compute_precision: str) -> float:
    """Anchor-cost multiplier of a compute-precision posture: 1.0 for
    f32/equality, :data:`BF16_COMPUTE_RATIO` for ``bf16_f32acc`` (whose
    halo side the caller prices through ``itemsize`` 2)."""
    return (BF16_COMPUTE_RATIO
            if compute_precision == "bf16_f32acc" else 1.0)


def projected_step_us(
    lang: str,
    dims,
    L: int,
    fuse: int,
    *,
    itemsize: int = 4,
    links: int = 6,
    link_gbps: float = 90.0,
    hop_us: float = 1.0,
    overlap="auto",
    local=None,
    halo_depth: int = 1,
    compute_precision: str = "f32",
    n_fields: int = 2,
    launch_us: float = 0.0,
    blocks: int = 1,
    members: int = 1,
) -> Optional[float]:
    """Model-projected µs/step for ONE concrete (path, mesh, depth)
    config — the scalar the autotuner ranks its shortlist by. ``"plain"``
    is the reference's XLA projection (:func:`project` at every depth);
    ``"cuda"`` the single block at :data:`FUSE_COST_RATIO`, the face
    schedule at depth 1, the x-chain or xy-chain deeper. ``blocks``
    multiplies the per-block step (the blocks of one process).
    ``members`` is the member count of a batched launch: its device time
    is ``members`` times a member's (:data:`MEMBER_COST_RATIO`), its
    launch floor is paid once; the plain path does ``members`` times the
    work. ``None`` when the model has nothing to say (no ratio at this
    depth)."""
    n, m, p = dims
    ndev = n * m * p
    ratio = precision_compute_ratio(compute_precision)
    if members > 1:
        ratio *= members * (MEMBER_COST_RATIO if lang == "cuda" else 1.0)
    if local is None:
        local = tuple(-(-L // d) for d in dims)
    side = max(2, round((local[0] * local[1] * local[2]) ** (1 / 3)))
    kw = dict(itemsize=itemsize, links=links, link_gbps=link_gbps,
              hop_us=hop_us, n_fields=n_fields)
    if lang == "plain":
        base = anchor_us("plain", L) / ndev * ratio
        if ndev == 1:
            return base
        row = project(side, max(1, fuse), base, overlap=overlap,
                      halo_depth=halo_depth, **kw)
        return _step_us(base, row, blocks)
    base_full = anchor_us("cuda", L) * ratio
    r = FUSE_COST_RATIO.get(fuse)
    if ndev == 1:
        return None if r is None else base_full * r
    base = base_full / ndev
    if fuse == 1:
        row = project(side, 1, base, stage_ratio=STAGE_RATIO["cuda"],
                      overlap=0.0, halo_depth=halo_depth,
                      launch_us=launch_us, **kw)
        return _step_us(base, row, blocks)
    if fuse < 2 or r is None:
        return None
    kw.update(local=local, overlap=overlap, halo_depth=halo_depth,
              launch_us=launch_us)
    if m == 1 and p == 1:
        row = project_1d(n, L, fuse, base_full, **kw)
    else:
        row = project_chain(dims, L, fuse, base_full, **kw)
    return _step_us(base, row, blocks)


def _sim_fabric(sim):
    """(device kind, placement, fabric) of a constructed simulation."""
    import torch

    from . import distributed

    kind = (torch.cuda.get_device_name(sim.device)
            if sim.device.type == "cuda" else "")
    placement = placement_of(sim.mesh.devices, sim.processes,
                             distributed.backend())
    return kind, placement, fabric_for(kind, placement)


def comm_report(sim) -> dict:
    """Per-step exchange budget of a constructed ``Simulation`` — the
    ``comm`` section of RunStats: the µs/step of exchange this model
    projects for the run's exact config, and how much of it the split
    round hides and exposes. A projection, not a measurement; the
    section says so (``"model"``) and records the knobs."""
    if not sim.sharded:
        return {
            "model": "fabric-projection",
            "mode": "single-device",
            "comm_us_per_step": 0.0,
            "hidden_us": 0.0,
            "exposed_us": 0.0,
            "overlap": 0.0,
            "halo_depth": 1,
            "exchanges_per_step": 0.0,
            "halo_bytes_per_step": 0,
        }
    dims = sim.domain.dims
    L = sim.settings.L
    itemsize = sim.blocks[0][0].element_size()
    kind, placement, fab = _sim_fabric(sim)
    overlap_on = bool(sim.comm_overlap)
    ov_arg = "auto" if overlap_on else 0.0
    fuse = max(1, int(sim.fuse))
    sk = max(1, int(sim.halo_depth))
    local = tuple(int(x) for x in sim.domain.local_shape)
    kw = dict(itemsize=itemsize, links=fab.links, link_gbps=fab.link_gbps,
              hop_us=fab.hop_us, n_fields=sim.model.n_fields)
    row = None
    if sim.kernel_language == "cuda" and fuse >= 2:
        k = max(f for f in FUSE_COST_RATIO if f <= fuse)
        base_full = anchor_us("cuda", L)
        kw.update(local=local, halo_depth=sk, overlap=ov_arg,
                  launch_us=LAUNCH_US)
        if dims[1] == 1 and dims[2] == 1:
            row = project_1d(dims[0], L, k, base_full, **kw)
        else:
            row = project_chain(dims, L, k, base_full, **kw)
    else:
        side = max(2, round((local[0] * local[1] * local[2]) ** (1 / 3)))
        n_dev = dims[0] * dims[1] * dims[2]
        if sim.kernel_language == "cuda":
            row = project(side, 1, anchor_us("cuda", L) / n_dev,
                          stage_ratio=STAGE_RATIO["cuda"], halo_depth=sk,
                          launch_us=LAUNCH_US, **kw)
        else:
            row = project(side, fuse, anchor_us("plain", L) / n_dev,
                          halo_depth=sk, overlap=ov_arg, **kw)
    exposed = row["comm_us_per_step_exposed"]
    hidden = row.get("comm_us_per_step_hidden", 0.0)
    return {
        "model": "fabric-projection",
        "mode": "overlap" if overlap_on else "fused",
        "device_kind": kind or None,
        "placement": placement,
        "kernel": sim.kernel_language,
        "mesh_dims": list(dims),
        "fuse": row.get("fuse", fuse),
        "halo_depth": row.get("halo_depth", sk),
        "exchanges_per_step": row.get("exchanges_per_step", 0.0),
        "halo_bytes_per_step": row.get("halo_bytes_per_step", 0),
        "links": fab.links,
        "link_gbps": fab.link_gbps,
        "hop_us": fab.hop_us,
        "comm_us_per_step": round(exposed + hidden, 2),
        "hidden_us": hidden,
        "exposed_us": exposed,
        "overlap": row["overlap"],
    }


def projected_step_us_for(sim) -> Optional[float]:
    """Model-projected µs/step of a constructed ``Simulation`` (every
    knob read off it): the reference side of the live
    ``model_vs_measured_residual_us`` gauge. None when the model has
    nothing to say; a gauge never kills a run."""
    try:
        kind, _, fab = _sim_fabric(sim)
        fuse = max(1, int(sim.fuse))
        if sim.kernel_language == "cuda" and fuse > 1:
            fuse = max(f for f in FUSE_COST_RATIO if f <= fuse)
        return projected_step_us(
            sim.kernel_language, sim.domain.dims, sim.settings.L, fuse,
            itemsize=sim.blocks[0][0].element_size(),
            links=fab.links, link_gbps=fab.link_gbps, hop_us=fab.hop_us,
            overlap="auto" if sim.comm_overlap else 0.0,
            local=tuple(int(x) for x in sim.domain.local_shape),
            halo_depth=sim.halo_depth, n_fields=sim.model.n_fields,
            launch_us=LAUNCH_US if sim.kernel_language == "cuda" else 0.0,
            blocks=sim.mesh.n_blocks,
            members=(getattr(sim, "n_members", 1)
                     // getattr(sim, "member_shards", 1)),
        )
    except Exception:  # noqa: BLE001 — a gauge must never kill a run
        return None
