"""Elastic resharding: executing the restore plan (counterpart of
``grayscott_jl_tpu/reshard/restore.py``).

Two paths, one plan (``reshard/plan.py``):

* **The checkpoint path** (:func:`restore_run`): the restoring run reads
  exactly its new blocks' ``(start, count)`` boxes out of the
  global-indexed checkpoint store (each process its own), so the mesh
  is a restore-time decision. The plan judges the recorded layout
  against the run's (mesh dims and process count) and refuses a change
  under ``reshard = "off"``.
* **The live path** (:func:`device_all_to_all_restore`, driven by
  :func:`reshape_live`): the live fields of mesh A move onto mesh B
  between two rounds, with no checkpoint. ``GS_RESHARD_DEVICE`` picks
  the tier:

  - ``collective`` (both meshes on the same device set): each new block
    is assembled on its own device from the overlaps of the old blocks
    the plan names (``plan.overlapping_old_shards``), mesh A's storage
    pad dropped and mesh B's rebuilt at the model's frozen boundary
    values. Between processes the overlaps that change process travel
    in one ``batch_isend_irecv`` round (``parallel/distributed.p2p``:
    NCCL between cards, gloo where processes share a card or run on
    the CPU); nothing goes through the host otherwise.
  - ``put`` (across device sets): the same relayout assembled on mesh
    A's devices, then each block ``Tensor.to`` its new device.
  - ``host``: ``get_fields()`` then ``restore_fields`` (one process).
  - ``auto``: ``collective`` on the same device set, else ``put``,
    degrading to ``host`` where the reference does: when ``put`` raises
    in a run of one process.

  A pinned tier that cannot run raises :class:`ReshardError`, and
  ``off`` refuses the live path. The move is slicing and copying in
  torch ops (the reference's is ``jnp`` outside any Pallas kernel), and
  the continuation is bitwise the run that never moved.

Every move that changes the layout is recorded once, on the event
stream, in the fault journal and on ``sim.reshard`` (which
``RunStats.config["reshard"]`` echoes), with its ``path``, ``bytes`` and
``wall_s``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import torch

from ..config.settings import (RESHARD_DEVICE_MODES, Settings,
                               resolve_reshard, resolve_reshard_device)
from ..parallel import distributed
from . import plan as plan_mod
from .plan import LayoutMeta, ReshardError, ReshardPlan

__all__ = [
    "device_all_to_all_restore",
    "layout_of",
    "placement",
    "reshape_live",
    "restore_run",
]


def layout_of(sim, *, process_count: Optional[int] = None) -> LayoutMeta:
    """The :class:`LayoutMeta` of a live simulation: the record its
    checkpoints carry, and the "new" side of a restore plan. The halo
    depth is the one the run resolved (after its gate), the chain fuse
    the run's fuse base."""
    return LayoutMeta(
        mesh_dims=tuple(int(d) for d in sim.domain.dims),
        process_count=int(distributed.process_count()
                          if process_count is None else process_count),
        halo_depth=int(sim.halo_depth),
        chain_fuse=int(sim.fuse),
        ensemble_size=1,
    )


def _move_bytes(plan: ReshardPlan, sim) -> int:
    """Bytes the plan re-slices: every new block's true-domain box over
    all fields (and members) — what the live move writes, and what a
    checkpoint restore reads."""
    cells = 0
    for _coords, _start, count in plan.boxes:
        cells += int(count[0]) * int(count[1]) * int(count[2])
    itemsize = torch.empty((), dtype=sim.dtype).element_size()
    members = int(getattr(sim, "n_members", 1))
    return cells * sim.model.n_fields * members * itemsize


def _announce(sim, plan: ReshardPlan, *, log=None, journal=None,
              prov=None) -> None:
    """One ``reshard`` record on every observer: the event stream, the
    fault journal (and through it the final ``RunStats`` faults
    section) and the log, each with the tier's ``path`` / ``bytes`` /
    ``wall_s``."""
    from ..obs import events as obs_events

    prov = prov or {}
    old = plan.old.describe() if plan.old is not None else None
    obs_events.get_events().emit(
        "reshard", step=sim.step,
        old_mesh=(old or {}).get("mesh_dims"),
        new_mesh=list(plan.new.mesh_dims),
        old_procs=(old or {}).get("process_count"),
        new_procs=plan.new.process_count,
        members=plan.members,
        path=prov.get("path"),
        bytes=prov.get("bytes"),
        wall_s=prov.get("wall_s"),
    )
    if journal is not None:
        journal.record(
            event="reshard", step=sim.step,
            old=old, new=plan.new.describe(), members=plan.members,
            path=prov.get("path"), bytes=prov.get("bytes"),
            wall_s=prov.get("wall_s"),
        )
    if log is not None:
        old_mesh = ("x".join(str(d) for d in plan.old.mesh_dims)
                    if plan.old is not None else "?")
        new_mesh = "x".join(str(d) for d in plan.new.mesh_dims)
        log.info(
            f"Resharded restore: layout {old_mesh} "
            f"({plan.old.process_count if plan.old else '?'} proc) -> "
            f"adopted {new_mesh} ({plan.new.process_count} proc) "
            f"at step {sim.step} via {prov.get('path', '?')} "
            f"({prov.get('bytes', '?')} B in {prov.get('wall_s', '?')}s)")


def restore_run(sim, settings: Settings, *, log=None, journal=None,
                failover_journal=None) -> Tuple[int, ReshardPlan]:
    """Restore ``sim`` from ``restart_input`` onto its (already built)
    mesh, resharding when the store was written on another layout.

    Returns ``(restart_step, plan)``. The plan is made from the store's
    recorded layout (``io/checkpoint.read_layout``) against the run's
    (:func:`layout_of`) and refuses a change under ``reshard = "off"``;
    then each process reads its own blocks' boxes. Both happen inside
    the replica failover (``resilience/integrity``), so a corrupt
    candidate fails over to the next. ``journal`` takes the ``reshard``
    record, ``failover_journal`` (default ``journal``) the failovers.
    ``sim.reshard`` is the plan with its provenance, or None when the
    layout did not change. An ensemble restores through
    ``ensemble/io.restore_ensemble``: the member stores' quorum step,
    grown or shrunk member sets, each member's spatial reshard."""
    from ..io.checkpoint import open_checkpoint, read_entry, read_layout
    from ..resilience import integrity

    allow = resolve_reshard(settings)
    t0 = time.perf_counter()
    if getattr(settings, "ensemble", None) is not None:
        from ..ensemble.io import restore_ensemble

        step, plan = restore_ensemble(
            sim, settings, allow=allow, log=log,
            journal=journal if failover_journal is None else failover_journal)
        if plan.changed:
            prov = {"path": "ckpt", "bytes": _move_bytes(plan, sim),
                    "wall_s": round(time.perf_counter() - t0, 6)}
            sim.reshard = {**plan.describe(), **prov}
            _announce(sim, plan, log=log, journal=journal, prov=prov)
        else:
            sim.reshard = None
        return step, plan
    new = layout_of(sim)
    boxes = sim.local_boxes() if sim.processes > 1 else None

    def restore_from(candidate):
        reader, idx, step = open_checkpoint(candidate, settings,
                                            settings.restart_step)
        with reader:
            plan = plan_mod.plan_restore(read_layout(reader), new,
                                         L=settings.L, allow=allow)
            # The reshard is these reads: the new blocks' boxes.
            fields = read_entry(reader, idx, settings, boxes)
        return step, plan, fields

    step, plan, fields = integrity.restore_with_failover(
        settings.restart_input, restore_from,
        journal=journal if failover_journal is None else failover_journal,
        log=log)
    if boxes is None:
        sim.restore_fields(fields, step)
    else:
        sim.restore_blocks(fields[0], step)
    if plan.changed:
        prov = {"path": "ckpt", "bytes": _move_bytes(plan, sim),
                "wall_s": round(time.perf_counter() - t0, 6)}
        sim.reshard = {**plan.describe(), **prov}
        _announce(sim, plan, log=log, journal=journal, prov=prov)
    else:
        sim.reshard = None
    return step, plan


# --------------------------------------------------------------- live path


def placement(devices: Sequence, n: int) -> List[torch.device]:
    """The devices of ``n`` blocks taken from ``devices`` (a source
    mesh's, or the usable cards): their distinct devices in order, the
    first ``n`` when there are as many, else the ``n`` blocks spread
    over them, consecutive blocks together (a device holding several,
    as a one-card mesh does)."""
    uniq = list(dict.fromkeys(torch.device(d) for d in devices))
    if not uniq:
        raise ReshardError("no device to place the new mesh on")
    if n <= len(uniq):
        return uniq[:n]
    return [uniq[i * len(uniq) // n] for i in range(n)]


def _device_set(sim) -> frozenset:
    """The devices this process's blocks of ``sim`` live on."""
    from ..resilience.sdc import device_name

    return frozenset(device_name(d) for d in sim.mesh.devices)


def _group_meshes(sim, target):
    """The ``(groups, old mesh, new mesh, old blocks, first new block)``
    of each relayout a move makes: one for a solo or one-group run, one
    per member group this process holds otherwise (the groups and their
    processes are the same on both sides: the member split stays)."""
    if int(getattr(sim, "member_shards", 1)) == 1:
        return [(sim.mesh, target.mesh, list(sim.blocks), 0)]
    na, nb = len(sim.offsets), len(target.offsets)
    return [(sim.mesh.group(g), target.mesh.group(g),
             list(sim.blocks[i * na:(i + 1) * na]), i * nb)
            for i, g in enumerate(sim.mesh.held)]


def _relayout(sim, target, stage) -> List[tuple]:
    """This process's new blocks of ``target``, each assembled on
    ``stage(i)`` (the i-th local new block's device) from the overlaps
    of ``sim``'s old blocks: true-domain cells only (mesh A's pad is
    never read), mesh B's pad at the boundary values. Overlaps held by
    another process arrive in one ``distributed.p2p`` round; both sides
    walk the (new rank, old rank) pairs in the same order, so the
    transfers between two processes match. Under ``member_shards > 1``
    each member group's blocks move by their own relayout, between the
    processes that hold the group."""
    out = []
    for a_mesh, b_mesh, blocks, first in _group_meshes(sim, target):
        out += _relayout_mesh(sim, target, a_mesh, b_mesh, blocks,
                              lambda i, first=first: stage(first + i))
    return out


def _relayout_mesh(sim, target, a_mesh, b_mesh, blocks, stage):
    """One relayout from ``blocks`` on ``a_mesh`` (``sim``'s spatial
    mesh, or one member group's) onto ``b_mesh``."""
    L = sim.settings.L
    old_dims = sim.domain.dims
    old_boxes = plan_mod.shard_boxes(L, old_dims)
    new_boxes = plan_mod.shard_boxes(L, target.domain.dims)
    rank_of = {coords: r for r, (coords, _, _) in enumerate(old_boxes)}
    a_first, b_first = a_mesh.first_rank, b_mesh.first_rank
    me = distributed.process_index()
    # An ensemble's blocks carry the member axis in front: it rides
    # along every slice (the member set is adjusted by _adjust_members).
    lead = tuple(blocks[0][0].shape[:-3])
    block = lead + tuple(target.domain.local_shape)
    padded = target.domain.padded
    nf = target.model.n_fields
    out = []
    for i in range(b_mesh.n_blocks):
        dev = stage(i)
        out.append(tuple(
            torch.full(block, float(bv), dtype=target.dtype, device=dev)
            if padded else torch.empty(block, dtype=target.dtype, device=dev)
            for bv in target.model.boundaries))
    sends, recvs, landing = [], [], []
    for rb, (_, nstart, ncount) in enumerate(new_boxes):
        mine_b = b_mesh.owner(rb) == me
        for coords in plan_mod.overlapping_old_shards((nstart, ncount), L,
                                                      old_dims):
            ra = rank_of[coords]
            mine_a = a_mesh.owner(ra) == me
            if not (mine_a or mine_b):
                continue
            _, ostart, ocount = old_boxes[ra]
            lo = [max(a, b) for a, b in zip(nstart, ostart)]
            hi = [min(a + c, b + d)
                  for a, c, b, d in zip(nstart, ncount, ostart, ocount)]
            src = (Ellipsis,) + tuple(slice(x - o, y - o)
                                      for x, y, o in zip(lo, hi, ostart))
            dst = (Ellipsis,) + tuple(slice(x - s, y - s)
                                      for x, y, s in zip(lo, hi, nstart))
            tag = rb * len(old_boxes) + ra
            if mine_a and mine_b:
                for new, old in zip(out[rb - b_first], blocks[ra - a_first]):
                    new[dst].copy_(old[src])
            elif mine_a:
                piece = torch.stack([f[src] for f in blocks[ra - a_first]])
                sends.append((b_mesh.owner(rb), tag, piece))
            else:
                shape = (nf,) + lead + tuple(y - x for x, y in zip(lo, hi))
                like = torch.empty(shape, dtype=target.dtype, device="meta")
                recvs.append((a_mesh.owner(ra), tag, like,
                              out[rb - b_first][0].device))
                landing.append((rb - b_first, dst))
    if sends or recvs:
        for (i, dst), piece in zip(landing, distributed.p2p(sends, recvs)):
            for new, part in zip(out[i], piece):
                new[dst].copy_(part)
    return out


def _adjust_members(sim, target, blocks) -> List[tuple]:
    """An ensemble's relaid blocks with the member set of ``target``:
    the first members kept, grown members taking ``target``'s own
    (broadcast init) rows, the state ``restore_ensemble`` gives a grown
    member. Solo blocks pass through."""
    if not getattr(sim, "is_ensemble", False):
        return blocks
    old_n, new_n = int(sim.n_members), int(target.n_members)
    if old_n == new_n:
        return blocks
    out = []
    for fields, init in zip(blocks, target.blocks):
        out.append(tuple(
            torch.cat([f[:old_n], i[old_n:].to(f.device)])
            if new_n > old_n else f[:new_n].contiguous()
            for f, i in zip(fields, init)))
    return out


def _regroups(sim, target) -> bool:
    """Whether a move changes which member group a member is in: the
    member split or count changes where either side has more than one
    group (the device tiers move each group's blocks within the
    group)."""
    shards = [int(getattr(s, "member_shards", 1)) for s in (sim, target)]
    if max(shards) == 1:
        return False
    return (shards[0] != shards[1]
            or int(sim.n_members) != int(target.n_members))


def _collective_tier(sim, target) -> None:
    """Same device set: every new block assembled on its own device."""
    devices = target.mesh.devices
    target.blocks = _adjust_members(
        sim, target, _relayout(sim, target, lambda i: devices[i]))


def _put_tier(sim, target) -> None:
    """Across device sets: the relayout assembled on mesh A's devices,
    then each block copied to its new device."""
    src = sim.mesh.devices
    staged = _adjust_members(sim, target, _relayout(
        sim, target, lambda i: src[min(i, len(src) - 1)]))
    target.blocks = [tuple(f.to(d) for f in fields)
                     for fields, d in zip(staged, target.mesh.devices)]


def _host_tier(sim, target) -> None:
    """Through the host: the assembled true-domain fields, re-placed by
    the restore entry point. One process only: no process of a run of
    several holds the whole grid."""
    if sim.processes > 1:
        raise ReshardError(
            "GS_RESHARD_DEVICE=host gathers the whole grid on the host, "
            f"which no process of a {sim.processes}-process run holds; "
            "use auto/collective/put")
    if getattr(sim, "is_ensemble", False):
        old = sim.get_fields()  # (N, L, L, L) per field
        new_n = int(target.n_members)
        target.restore_members(
            [tuple(f[i] for f in old) if i < sim.n_members
             else target.member_init_fields() for i in range(new_n)],
            int(sim.step))
    else:
        target.restore_fields(sim.get_fields(), int(sim.step))


def device_all_to_all_restore(sim, plan: ReshardPlan, target, *,
                              mode: Optional[str] = None) -> dict:
    """Move ``sim``'s live fields onto ``target``'s layout per ``plan``,
    with no checkpoint; the continuation on ``target`` is bitwise the
    one a checkpoint restore of the same plan gives. ``mode`` (default
    ``resolve_reshard_device``) picks the tier (module docstring).
    Returns ``{"path", "bytes", "wall_s"}`` once the target's devices
    have synchronized."""
    from ..resilience.supervisor import context_lost

    if mode is None:
        mode = resolve_reshard_device(sim.settings)
    if mode == "off":
        raise ReshardError(
            "live device resharding is disabled (GS_RESHARD_DEVICE=off); "
            "use the checkpoint restore path (reshard.restore.restore_run)")
    if mode not in RESHARD_DEVICE_MODES:
        raise ReshardError(
            f"live reshard tier {mode!r} is not one of "
            f"{'/'.join(RESHARD_DEVICE_MODES)}")
    same_set = _device_set(sim) == _device_set(target)
    if sim.processes > 1:
        # Every process takes the same tier.
        same_set = not distributed.any_process(not same_set)
    t0 = time.perf_counter()
    regroup = _regroups(sim, target)
    if regroup and mode in ("auto", "host"):
        # The member split or count changes under member_shards > 1:
        # members change groups, which the host re-places.
        _host_tier(sim, target)
        path = "host"
    elif regroup:
        raise ReshardError(
            f"GS_RESHARD_DEVICE={mode} moves each member group's blocks "
            "within its group; this move changes the member split or "
            "count of a member_shards > 1 run: use auto or host")
    elif mode == "collective" or (mode == "auto" and same_set):
        if not same_set:
            raise ReshardError(
                "GS_RESHARD_DEVICE=collective needs mesh A and mesh B on "
                f"the same device set; old spans {len(_device_set(sim))} "
                f"device(s), new {len(_device_set(target))} — use "
                "auto/put/host")
        _collective_tier(sim, target)
        path = "collective"
    elif mode in ("put", "auto"):
        try:
            _put_tier(sim, target)
            path = "put"
        except Exception as e:  # noqa: BLE001 — auto degrades, as in the reference
            if mode == "put" or sim.processes > 1 or context_lost(e):
                raise
            _host_tier(sim, target)
            path = "host"
    else:
        _host_tier(sim, target)
        path = "host"
    target.step = int(sim.step)
    target.block_until_ready()
    return {"path": path, "bytes": _move_bytes(plan, target),
            "wall_s": round(time.perf_counter() - t0, 6)}


def reshape_live(sim, *, mesh_dims: Optional[Tuple[int, int, int]] = None,
                 settings: Optional[Settings] = None,
                 seed: Optional[int] = None, mode: Optional[str] = None,
                 devices: Optional[Sequence] = None, log=None, journal=None):
    """The live move between rounds: build the target simulation on
    ``mesh_dims`` and move ``sim``'s state onto it.

    Returns ``(target, plan)``; the caller swaps ``target`` in for
    ``sim``. The target is built with the source's resolved kernel
    language pinned and the autotuner off, with the source's noise seed
    unless ``seed`` is given, on ``devices`` (this process's share; by
    default :func:`placement` over the source's devices, so a mesh on
    one card stays on it). An infeasible target, or a change under
    ``reshard = "off"``, raises :class:`ReshardError` before the target
    is built. ``target.reshard`` carries the plan and its provenance,
    and the ``reshard`` record is emitted.

    ``settings`` with another ``[ensemble]`` member set grows or shrinks
    an ensemble's member axis between rounds: the first members keep
    their state, grown members start from the model's init (as in
    ``restore_ensemble``); ``reshard = "off"`` refuses the change."""
    settings = sim.settings if settings is None else settings
    dims = tuple(int(d) for d in (mesh_dims or sim.domain.dims))
    allow = resolve_reshard(settings)
    old = layout_of(sim)
    plan_mod.plan_restore(old, dataclasses.replace(old, mesh_dims=dims),
                          L=settings.L, allow=allow)
    ens = getattr(settings, "ensemble", None)
    old_n = int(getattr(sim, "n_members", 1))
    new_n = ens.n if ens is not None else 1
    if old_n != new_n and allow == "off":
        raise ReshardError(
            f"live member reshape {old_n} -> {new_n} refused: "
            "reshard='off' (set reshard='auto' / GS_RESHARD=auto)")
    n = dims[0] * dims[1] * dims[2] * (
        int(ens.member_shards) if ens is not None else 1)
    if n % sim.processes:
        raise ReshardError(
            f"a {dims} mesh has {n} blocks, which {sim.processes} "
            "processes cannot hold in equal shares")
    if devices is None:
        devices = placement(sim.mesh.devices, n // sim.processes)
    pinned = dataclasses.replace(settings, kernel_language=sim.kernel_language,
                                 autotune="off")
    target = type(sim)(pinned, seed=sim.seed if seed is None else seed,
                       mesh_dims=dims, devices=list(devices))
    plan = plan_mod.plan_restore(old, layout_of(target), L=settings.L,
                                 allow=allow)
    if old_n != new_n:
        plan = dataclasses.replace(plan, changed=True, members={
            "restored": min(old_n, new_n),
            "grown": max(0, new_n - old_n),
            "new_n": new_n,
        })
    prov = device_all_to_all_restore(sim, plan, target, mode=mode)
    if plan.changed:
        target.reshard = {**plan.describe(), **prov}
        _announce(target, plan, log=log, journal=journal, prov=prov)
    return target, plan
