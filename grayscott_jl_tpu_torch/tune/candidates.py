"""Candidate shortlist for the measured autotuner (counterpart of
``grayscott_jl_tpu/tune/candidates.py``).

The search space is every knob the runner resolves at construction: the
chain depth (``GS_FUSE``), the split-phase exchange
(``comm_overlap``), the s-step depth (``halo_depth``) and, under an
authorizing ``bf16_f32acc`` posture, the precision. On the card every
candidate is the CUDA kernel (the depth-1 face schedule, the chains
deeper), pruned by the same ``cuda_stencil.max_feasible_chain_depth`` the
runner applies; off the card every candidate is the plain path, as the
reference's off-TPU candidates are XLA. The plain path is never a
candidate on the card. The candidates are ranked by the fabric model
(``parallel/icimodel.projected_step_us``), and the analytic pick is
always in the shortlist. The port's tile is fixed, so the reference's
``bx`` slab variants have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..parallel import icimodel
from ..parallel.domain import dims_create


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One concrete schedule the tuner can pin and time."""

    kernel: str  # "cuda" | "plain"
    fuse: int  # chain depth (GS_FUSE)
    comm_overlap: bool  # split-phase exchange armed (comm_overlap)
    #: s-step exchange depth: one (fuse x halo_depth)-deep exchange per
    #: halo_depth chain rounds.
    halo_depth: int = 1
    projected_step_us: Optional[float] = None  # model rank, None = unscored
    analytic: bool = False  # this is the model's own pick
    #: Ensembles: the member split and the mesh it implies; None for a
    #: solo run (and for the mesh, the run's).
    member_shards: Optional[int] = None
    mesh: Optional[tuple] = None
    #: The compute-precision posture: "f32" or "bf16_f32acc".
    compute_precision: str = "f32"

    def label(self) -> str:
        parts = [self.kernel, f"fuse={self.fuse}",
                 "overlap" if self.comm_overlap else "fused"]
        if self.compute_precision != "f32":
            parts.insert(1, "bf16")
        if self.halo_depth != 1:
            parts.append(f"sk={self.halo_depth}")
        if self.member_shards is not None:
            parts.append(f"mshards={self.member_shards}")
        return "/".join(parts)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d["projected_step_us"] is not None:
            d["projected_step_us"] = round(d["projected_step_us"], 1)
        return d


def from_dict(d: dict) -> Candidate:
    """Inverse of :meth:`Candidate.as_dict` for cache records; unknown
    keys (a newer writer) are dropped rather than rejected."""
    fields = {f.name for f in dataclasses.fields(Candidate)}
    out = {k: v for k, v in d.items() if k in fields}
    if out.get("mesh") is not None:
        out["mesh"] = tuple(int(x) for x in out["mesh"])
    return Candidate(**out)


def _kernel_depths(local, itemsize: int, dims, kmax: int,
                   n_fields: int = 2) -> List[int]:
    """Depths of the CUDA kernel the runner runs on this block: one
    block, 1..the ledger's cap; sharded, depth 1 (the face schedule)
    and each chain depth within ``max_feasible_chain_depth`` and
    ``kmax`` — restricted to the depths the model ranks."""
    from ..ops import cuda_stencil

    if min(local) < 2:
        return []
    n, m, p = dims
    if n * m * p == 1:
        cap = cuda_stencil.max_feasible_fuse(itemsize, n_fields)
    else:
        cap = cuda_stencil.max_feasible_chain_depth(
            local, dims, itemsize, max(kmax, 1), n_fields)
    return [k for k in sorted(icimodel.FUSE_COST_RATIO) if 1 <= k <= cap]


def _plain_depths(local, dims, kmax: int) -> List[int]:
    n, m, p = dims
    if n * m * p == 1:
        # The single-block plain path is a per-step loop; depth is not a
        # knob there.
        return [1]
    return list(range(1, max(1, min(kmax, min(local))) + 1))


def generate(
    *,
    dims,
    L: int,
    platform: str,
    itemsize: int,
    fuse_cap: int,
    analytic_kernel: str,
    analytic_fuse: int,
    comm_overlap: bool,
    overlap_toggle: bool,
    link_gbps: float = 90.0,
    links: int = 6,
    hop_us: float = 1.0,
    top_n: int = 4,
    ensemble: int = 1,
    member_shards: int = 1,
    kernel_allowed: bool = True,
    halo_depth: int = 0,
    compute_precision: str = "f32",
    n_fields: int = 2,
    blocks: int = 1,
) -> List[Candidate]:
    """The ranked measurement shortlist for one run config, as the
    reference's ``generate`` ranks it.

    ``overlap_toggle`` searches the split-phase knob (only under
    ``comm_overlap = "auto"``; a pinned value is respected); a depth-1
    round of the kernel has no split form, so it is not toggled there.
    ``halo_depth`` 0 searches k in {1, 2, 4} wherever the schedule is
    feasible (plain: ``fuse * k`` within the block; CUDA: the chain
    ledger at ``fuse * k``), an explicit value is respected.
    ``bf16_f32acc`` adds the float32 variant of every point.
    ``kernel_allowed`` is the generator's gate: a model it refuses has
    plain candidates only. ``hop_us`` and ``blocks`` feed the card's
    projection (``icimodel.projected_step_us``).

    An ensemble (``ensemble > 1`` members, ``member_shards`` their
    configured split) is priced by the batch each launch carries
    (``ensemble / member_shards`` members on every block, the launch
    floor paid once), and the search adds every other split m' of the
    same block slots (m' dividing the member and slot counts): each
    trades members per launch against the spatial block, carries the
    mesh it implies, and is measured like the rest."""
    n, m, p = dims
    sharded = n * m * p > 1
    local = tuple(-(-L // d) for d in dims)
    overlaps = [comm_overlap]
    if sharded and overlap_toggle:
        overlaps.append(not comm_overlap)

    analytic_cp = (
        "bf16_f32acc" if compute_precision == "bf16_f32acc" else "f32"
    )
    precisions = (
        ["bf16_f32acc", "f32"] if compute_precision == "bf16_f32acc"
        else ["f32"]
    )

    def _isz(cp: str) -> int:
        return 2 if cp == "bf16_f32acc" else itemsize

    def _langs(cp: str) -> dict:
        if platform == "cuda" and kernel_allowed:
            return {"cuda": _kernel_depths(local, _isz(cp), dims, fuse_cap,
                                           n_fields=n_fields)}
        return {"plain": _plain_depths(local, dims, fuse_cap)}

    def score(kernel, fuse, ov, sk=1, cp="f32", mesh=dims, shards=None):
        shards = member_shards if shards is None else shards
        return icimodel.projected_step_us(
            kernel, mesh, L, fuse, itemsize=_isz(cp), links=links,
            link_gbps=link_gbps, hop_us=hop_us,
            local=tuple(-(-L // d) for d in mesh),
            overlap="auto" if ov else 0.0, halo_depth=sk,
            compute_precision=cp, n_fields=n_fields,
            launch_us=icimodel.LAUNCH_US if kernel == "cuda" else 0.0,
            blocks=blocks, members=max(1, ensemble // max(shards, 1)),
        )

    analytic_sk = max(1, int(halo_depth)) if halo_depth else 1

    def sstep_depths(kernel, fuse, cp="f32"):
        if not sharded:
            return [1]
        ks = [halo_depth] if halo_depth else [1, 2, 4]
        if kernel == "cuda":
            from ..ops import cuda_stencil

            return [k for k in ks if cuda_stencil.max_feasible_chain_depth(
                local, dims, _isz(cp), fuse * k, n_fields) == fuse * k] or [1]
        return [k for k in ks if fuse * k <= min(local)] or [1]

    ens_tag = member_shards if ensemble > 1 else None
    out = []
    for cp in precisions:
        for kernel, depths in _langs(cp).items():
            for fuse in depths:
                for ov in overlaps if sharded else [False]:
                    for sk in sstep_depths(kernel, fuse, cp):
                        if (kernel == "cuda" and fuse * sk == 1
                                and ov != comm_overlap):
                            continue
                        out.append(Candidate(
                            kernel=kernel, fuse=fuse, comm_overlap=ov,
                            halo_depth=sk,
                            projected_step_us=score(kernel, fuse, ov, sk,
                                                    cp),
                            analytic=(kernel == analytic_kernel
                                      and fuse == analytic_fuse
                                      and ov == comm_overlap
                                      and sk == analytic_sk
                                      and cp == analytic_cp),
                            member_shards=ens_tag,
                            compute_precision=cp,
                        ))
    if ensemble > 1:
        # The other member splits of the same slots: m' groups of
        # total / m' blocks, ensemble / m' members per launch.
        import math

        total = n * m * p * member_shards
        kernel = "cuda" if platform == "cuda" and kernel_allowed else "plain"
        for m_alt in range(1, math.gcd(ensemble, total) + 1):
            if m_alt == member_shards or ensemble % m_alt or total % m_alt:
                continue
            alt = dims_create(total // m_alt, 3)
            alt_local = tuple(-(-L // d) for d in alt)
            if any(x * (d - 1) >= L for x, d in zip(alt_local, alt)):
                continue  # a block would own no true-domain cells
            alt_sharded = total // m_alt > 1
            depths = (_kernel_depths(alt_local, _isz(analytic_cp), alt,
                                     fuse_cap, n_fields=n_fields)
                      if kernel == "cuda"
                      else _plain_depths(alt_local, alt, fuse_cap))
            for fuse in depths:
                ov = comm_overlap and alt_sharded
                out.append(Candidate(
                    kernel=kernel, fuse=fuse, comm_overlap=ov,
                    projected_step_us=score(kernel, fuse, ov, 1,
                                            analytic_cp, alt, m_alt),
                    member_shards=m_alt, mesh=tuple(alt),
                    compute_precision=analytic_cp,
                ))
    if not any(c.analytic for c in out):
        # The analytic pick fell outside the enumerable space: measure it
        # all the same — the model-vs-measured delta needs it.
        out.append(Candidate(
            kernel=analytic_kernel, fuse=analytic_fuse,
            comm_overlap=comm_overlap if sharded else False,
            halo_depth=analytic_sk if sharded else 1,
            projected_step_us=score(
                analytic_kernel, analytic_fuse,
                comm_overlap if sharded else False,
                analytic_sk if sharded else 1, analytic_cp),
            analytic=True,
            member_shards=ens_tag,
            compute_precision=analytic_cp,
        ))

    big = float("inf")
    out.sort(key=lambda c: (not c.analytic,
                            c.projected_step_us
                            if c.projected_step_us is not None else big))
    return out[:max(top_n, 1)]
