"""Elastic resharding: the old->new layout plan (a copy of
``grayscott_jl_tpu/reshard/plan.py``, which is framework-free; the port
keeps its own).

The mesh shape is a restore-time decision, not a checkpoint-time
constant: checkpoint stores are global-indexed (every block carries its
``(start, count)`` box in the L^3 domain, ``io/bplite.py``) and the
restore path reads per box, so the data itself never depended on the
writing decomposition. What this module adds is the *metadata* — which
layout wrote the store, and whether the target layout may adopt it:
pure planning over the layout attributes
:class:`~..io.checkpoint.CheckpointWriter` records
(:data:`LAYOUT_ATTRS`).

The plan is host math only (boxes, member maps, a loud
:class:`ReshardError` for infeasible targets); execution lives in
``reshard/restore.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..parallel.domain import block_size_offset

__all__ = [
    "LAYOUT_ATTRS",
    "LAYOUT_SCHEMA_VERSION",
    "LayoutMeta",
    "ReshardError",
    "ReshardPlan",
    "layout_attrs",
    "member_map",
    "plan_restore",
    "read_layout",
    "shard_boxes",
]

#: Version of the layout-attribute schema below. Bump when an attribute
#: changes meaning; readers treat a NEWER schema as best-effort (the
#: attributes below keep their meaning across versions by contract) and
#: a missing schema as "pre-elastic store" (layout unknown — restore is
#: still legal, the stores were always global-indexed).
LAYOUT_SCHEMA_VERSION = 1

#: The store attributes that make up the layout record, in write order.
LAYOUT_ATTRS = (
    "layout_schema",
    "mesh_dims",
    "axis_names",
    "process_count",
    "halo_depth",
    "chain_fuse",
    "ensemble_size",
)


class ReshardError(RuntimeError):
    """An infeasible or refused restore-time layout change.

    Raised LOUDLY (naming both layouts) instead of letting a mismatched
    restore limp along: a silently wrong decomposition would corrupt
    every downstream artifact that believes the stats' mesh echo.
    """


@dataclasses.dataclass(frozen=True)
class LayoutMeta:
    """One run layout, as recorded in (or derived for) a checkpoint
    store. ``mesh_dims`` is the SPATIAL decomposition — the member axis
    of an ensemble is deliberately absent: member stores are
    byte-identical to solo stores (the reference's ``ensemble/io.py``;
    ensembles are Queue 1 item 19), and the ensemble size is the count
    of member stores on disk, not an attribute."""

    schema: int = LAYOUT_SCHEMA_VERSION
    mesh_dims: Tuple[int, ...] = (1, 1, 1)
    axis_names: Tuple[str, ...] = ("x", "y", "z")
    process_count: int = 1
    halo_depth: int = 1
    chain_fuse: int = 1
    ensemble_size: int = 1

    @property
    def n_devices(self) -> int:
        n = 1
        for d in self.mesh_dims:
            n *= int(d)
        return n

    def describe(self) -> dict:
        return {
            "schema": self.schema,
            "mesh_dims": list(self.mesh_dims),
            "process_count": self.process_count,
            "halo_depth": self.halo_depth,
            "chain_fuse": self.chain_fuse,
            "ensemble_size": self.ensemble_size,
        }


def layout_attrs(
    *,
    mesh_dims: Sequence[int],
    axis_names: Sequence[str] = ("x", "y", "z"),
    process_count: int = 1,
    halo_depth: int = 1,
    chain_fuse: int = 1,
    ensemble_size: int = 1,
) -> dict:
    """The attribute dict a checkpoint writer records (name -> value),
    one entry per :data:`LAYOUT_ATTRS` name."""
    return {
        "layout_schema": int(LAYOUT_SCHEMA_VERSION),
        "mesh_dims": [int(d) for d in mesh_dims],
        "axis_names": [str(a) for a in axis_names],
        "process_count": int(process_count),
        "halo_depth": int(halo_depth),
        "chain_fuse": int(chain_fuse),
        "ensemble_size": int(ensemble_size),
    }


def read_layout(attrs: dict) -> Optional[LayoutMeta]:
    """Parse a store's attribute dict into a :class:`LayoutMeta`, or
    None for a pre-elastic store (no ``layout_schema`` attribute).

    Tolerant by design: a store written by a NEWER schema still parses
    (the attribute names keep their meaning by contract), and damaged
    individual attributes fall back to the dataclass defaults — the
    layout record is advisory provenance for the plan, never a
    load-bearing input to the selection reads themselves.
    """
    if attrs is None or "layout_schema" not in attrs:
        return None

    def _ints(name, default):
        try:
            v = attrs[name]
            return tuple(int(x) for x in v)
        except (KeyError, TypeError, ValueError):
            return default

    def _int(name, default):
        try:
            return int(attrs[name])
        except (KeyError, TypeError, ValueError):
            return default

    return LayoutMeta(
        schema=_int("layout_schema", LAYOUT_SCHEMA_VERSION),
        mesh_dims=_ints("mesh_dims", (1, 1, 1)),
        axis_names=tuple(
            str(a) for a in attrs.get("axis_names", ("x", "y", "z"))
        ),
        process_count=_int("process_count", 1),
        halo_depth=_int("halo_depth", 1),
        chain_fuse=_int("chain_fuse", 1),
        ensemble_size=_int("ensemble_size", 1),
    )


def shard_boxes(
    L: int, dims: Sequence[int]
) -> List[Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]]:
    """Every shard's ``(coords, start, count)`` box in the true L^3
    domain for a ``dims`` decomposition — the per-shard selection reads
    a restore on that mesh issues (count clipped to the true domain;
    storage pad cells are reconstructed at the boundary value, never
    read). Row-major coordinate order, matching ``CartDomain.coords``.
    """
    dims = tuple(int(d) for d in dims)
    out = []
    dx, dy, dz = dims
    for cx in range(dx):
        for cy in range(dy):
            for cz in range(dz):
                sizes, offsets = zip(*(
                    block_size_offset(L, d, c)
                    for d, c in zip(dims, (cx, cy, cz))
                ))
                out.append(((cx, cy, cz), tuple(offsets), tuple(sizes)))
    return out


def overlapping_old_shards(
    box: Tuple[Tuple[int, ...], Tuple[int, ...]],
    L: int,
    old_dims: Sequence[int],
) -> List[Tuple[int, ...]]:
    """Coordinates of the OLD shards whose boxes intersect one new
    shard's ``(start, count)`` box — the communication pattern of the
    live device path (``reshard/restore.py``): each new block is
    assembled from these blocks' overlaps."""
    start, count = box
    hits = []
    for coords, ostart, ocount in shard_boxes(L, old_dims):
        if all(
            os_ < s + c and s < os_ + oc
            for s, c, os_, oc in zip(start, count, ostart, ocount)
        ):
            hits.append(coords)
    return hits


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """The old->new restore plan for one run.

    ``changed`` is the headline: False means the store's recorded
    layout (if any) matches the adopting run and the restore is a plain
    same-shape resume; True means the selection reads below re-slice
    the global arrays into a genuinely different decomposition.
    """

    old: Optional[LayoutMeta]
    new: LayoutMeta
    L: int
    changed: bool
    #: Every new shard's (coords, start, count) selection-read box.
    boxes: Tuple = ()
    #: Elastic-ensemble record (the reference's ``restore_ensemble``):
    #: ``{"restored": k, "grown": g, "new_n": n}`` — None for solo runs.
    members: Optional[dict] = None

    def describe(self) -> dict:
        return {
            "changed": self.changed,
            "old": self.old.describe() if self.old is not None else None,
            "new": self.new.describe(),
            "n_shards": len(self.boxes),
            "members": self.members,
        }


def plan_restore(
    old: Optional[LayoutMeta],
    new: LayoutMeta,
    *,
    L: int,
    allow: str = "auto",
) -> ReshardPlan:
    """Compute (and validate) the restore plan adopting ``new``.

    ``allow`` is the resolved ``reshard`` knob
    (``config.resolve_reshard``): ``"off"`` refuses any layout change
    with a loud :class:`ReshardError` naming both sides — the operator
    contract for runs that must never silently move. Infeasible
    targets (a mesh axis owning no true-domain cells, a non-positive
    dim) are errors here even though ``Simulation`` would also refuse
    at construction — the plan is consulted on restore paths where the
    target simulation may already exist.
    """
    dims = tuple(int(d) for d in new.mesh_dims)
    if len(dims) != 3 or any(d < 1 for d in dims):
        raise ReshardError(
            f"target mesh {dims} is not a valid 3D decomposition"
        )
    for d in dims:
        if d > 1 and -(-L // d) * (d - 1) >= L:
            raise ReshardError(
                f"target mesh {dims} is infeasible for L={L}: a block "
                f"of axis size {d} would own no true-domain cells"
            )
    changed = old is not None and (
        tuple(old.mesh_dims) != dims
        or int(old.process_count) != int(new.process_count)
    )
    if changed and allow == "off":
        raise ReshardError(
            f"checkpoint was written on mesh "
            f"{'x'.join(str(d) for d in old.mesh_dims)} "
            f"({old.process_count} process(es)) but this run adopts "
            f"{'x'.join(str(d) for d in dims)} "
            f"({new.process_count} process(es)) and reshard='off' "
            "refuses restore-time layout changes; set reshard='auto' "
            "(or GS_RESHARD=auto) to allow elastic resume"
        )
    return ReshardPlan(
        old=old, new=new, L=int(L), changed=changed,
        boxes=tuple(shard_boxes(L, dims)),
    )


def member_map(
    present: Sequence[bool], new_n: int,
    active: Optional[Sequence[bool]] = None,
) -> List[Tuple[str, int]]:
    """The elastic ensemble member plan: ``[("restore"|"init", i)]``
    for each of the ``new_n`` members of the resuming run.

    ``present[i]`` says whether member ``i``'s checkpoint store holds a
    durable step. Grow (``new_n`` beyond the present prefix) initializes
    the new trailing members from their spec; shrink simply has fewer
    entries than there are stores (trailing old members are dropped,
    their stores left untouched). A GAP — a missing store *before* a
    present one — is a loud :class:`ReshardError`: that is a lost or
    corrupt member, not a grow, and silently re-initializing it would
    fork the ensemble's history.

    ``active`` masks IDLE pack slots (the reference's serving
    scheduler's padding, Queue 1 item 22): an idle slot deliberately wrote no store, so its
    absence is never a gap and its action is always ``"init"`` — a
    requeued packed batch resumes its real members from the store
    quorum while the padding just re-initializes.
    """
    present_l = [bool(p) for p in present[:new_n]]
    present_l += [False] * (new_n - len(present_l))
    if active is None:
        active_l = [True] * new_n
    else:
        active_l = [bool(a) for a in list(active)[:new_n]]
        active_l += [True] * (new_n - len(active_l))
    eff = [p and a for p, a in zip(present_l, active_l)]
    if not any(eff):
        raise ReshardError(
            "no member checkpoint store holds a durable step — nothing "
            "to resume (delete restart=true to start from scratch)"
        )
    last_present = max(i for i, e in enumerate(eff) if e)
    missing = [
        i for i in range(last_present)
        if active_l[i] and not present_l[i]
    ]
    if missing:
        raise ReshardError(
            f"member checkpoint stores {missing} are missing or hold no "
            f"durable step while later members exist — a gap is a lost "
            "member, not an ensemble grow; restore it or roll the whole "
            "ensemble back"
        )
    return [
        ("restore" if eff[i] else "init", i)
        for i in range(new_n)
    ]
