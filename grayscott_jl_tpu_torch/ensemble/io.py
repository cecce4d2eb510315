"""Member-indexed output and checkpoint stores of an ensemble run
(counterpart of ``grayscott_jl_tpu/ensemble/io.py``).

Each member gets its OWN stores, named from the configured paths by an
index tag (``gs.bp`` -> ``gs.m00.bp``), each written by the solo writers
(``io/stream.SimStream``, ``io/checkpoint.CheckpointWriter``) under a
per-member Settings copy that carries the member's parameters, through
the same output pipeline, replicas and integrity sidecars. So:

* member ``k``'s stores are **byte-identical** to those of a solo run
  with member ``k``'s params and seed, provenance attributes and the
  spatial layout record included (the tests assert it);
* restart is per member: each member resumes from its own checkpoint
  store, and the resumable step of the ensemble is the minimum durable
  step over the member stores (the quorum step), so that a crash between
  two members' saves rolls every member back to the step all hold;
* every reader of a store (either package's ``BpReader``, ParaView) reads
  member stores as solo stores.

The writers mirror the solo interfaces (``write_step(step, blocks)``,
``save(step, blocks)``, ``close()``) over the ensemble snapshot's
member-stacked blocks; the member split (``engine.member_blocks``)
happens here, on the output pipeline's writer thread.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

from ..config.settings import Settings
from ..models import get_model
from .engine import member_blocks
from .spec import EnsembleSettings


def member_tag(i: int, n: int) -> str:
    """Zero-padded member tag, its width from the member count:
    ``m00`` .. ``m63``."""
    width = max(2, len(str(max(n - 1, 0))))
    return f"m{i:0{width}d}"


def member_path(path: str, i: int, n: int) -> str:
    """Member-indexed store path, the tag before the extension
    (``out/gs.bp`` -> ``out/gs.m03.bp``), so that derived files (the
    ``.vtk`` series, fault journals, sidecars) carry the tag too."""
    root, ext = os.path.splitext(path)
    return (f"{root}.{member_tag(i, n)}{ext}" if ext
            else f"{path}.{member_tag(i, n)}")


def member_settings(settings: Settings, i: int) -> Settings:
    """The Settings a SOLO run of member ``i`` would use: the member's
    parameters substituted, the store paths member-indexed, the ensemble
    table dropped. The one definition of "member i as a solo run": the
    writers, the restore and the equality tests build on it. The
    member's model parameters go into ``model_params`` and, where the
    model declares legacy flat keys (Gray-Scott's F, k, Du, Dv), into
    those attributes too; both resolve to the same values."""
    ens: EnsembleSettings = settings.ensemble
    n = ens.n
    model = get_model(ens.model)
    params = ens.members[i].params()
    dt = params.pop("dt")
    noise = params.pop("noise")
    flat = {model.legacy_keys[k]: v for k, v in params.items()
            if k in model.legacy_keys}
    return dataclasses.replace(
        settings,
        dt=dt, noise=noise, **flat,
        model=model.name,
        model_params={**(getattr(settings, "model_params", None) or {}),
                      **params},
        output=member_path(settings.output, i, n),
        checkpoint_output=member_path(settings.checkpoint_output, i, n),
        restart_input=member_path(settings.restart_input, i, n),
        ensemble=None,
    )


class EnsembleStream:
    """N member output streams behind the solo ``SimStream`` interface;
    idle slots get no stores at all."""

    def __init__(self, settings: Settings, domain, dtype, *,
                 writer_id: int = 0, nwriters: int = 1,
                 resume_step: Optional[int] = None):
        from ..io.stream import SimStream

        ens = settings.ensemble
        self.n = ens.n
        self.members: List[Optional[SimStream]] = [
            SimStream(member_settings(settings, i), domain, dtype,
                      writer_id=writer_id, nwriters=nwriters,
                      resume_step=resume_step)
            if ens.members[i].active else None
            for i in range(self.n)
        ]

    @property
    def engine(self) -> str:
        """The store engine of the member streams."""
        return next(s for s in self.members if s is not None).engine

    def write_step(self, step: int, blocks, checksums=None) -> None:
        blocks = list(blocks)
        for i, stream in enumerate(self.members):
            if stream is not None:
                stream.write_step(
                    step, member_blocks(blocks, i),
                    checksums=checksums[i] if checksums is not None else None)

    def close(self) -> None:
        for stream in self.members:
            if stream is not None:
                stream.close()


class EnsembleCheckpointWriter:
    """N member checkpoint stores behind the solo writer interface. Every
    member store records the same SPATIAL layout, what the equivalent
    solo run writes; idle slots checkpoint nothing (they restore by
    re-initialization, ``reshard/plan.member_map``)."""

    def __init__(self, settings: Settings, dtype, *, writer_id: int = 0,
                 nwriters: int = 1, resume_step: Optional[int] = None,
                 layout=None):
        from ..io.checkpoint import CheckpointWriter

        ens = settings.ensemble
        self.n = ens.n
        self.members: List[Optional[CheckpointWriter]] = [
            CheckpointWriter(member_settings(settings, i), dtype,
                             writer_id=writer_id, nwriters=nwriters,
                             resume_step=resume_step, layout=layout)
            if ens.members[i].active else None
            for i in range(self.n)
        ]

    def save(self, step: int, blocks, checksums=None) -> None:
        blocks = list(blocks)
        for i, writer in enumerate(self.members):
            if writer is not None:
                writer.save(
                    step, member_blocks(blocks, i),
                    checksums=checksums[i] if checksums is not None else None)

    def close(self) -> None:
        for writer in self.members:
            if writer is not None:
                writer.close()


def restore_ensemble(sim, settings: Settings, *, allow: str = "auto",
                     journal=None, log=None):
    """Restore the ensemble from its member-indexed checkpoint stores,
    elastically.

    ``restart_step = -1`` is the QUORUM step: the latest step every
    present member store holds durably (the minimum over the members'
    replicated latest steps). An explicit ``restart_step`` must exist in
    every present member store.

    The configured member count may differ from the checkpointed one.
    **Grow**: the members past the stores' prefix start from
    ``sim.member_init_fields()`` at the resume step (the noise is keyed
    on the absolute step, so a late member equals a solo run begun
    there); ``allow = "off"`` (``reshard = "off"``) refuses a grow.
    **Shrink**: only the first N stores are read; the others stay as
    they are. A GAP in the prefix raises
    :class:`~..reshard.plan.ReshardError` (``reshard/plan.member_map``).
    The spatial mesh may change at the same time: each member's restore
    reads its whole arrays. Each member store fails over to its replicas
    (``journal`` takes the failovers). Returns ``(step, ReshardPlan)``."""
    from ..io.checkpoint import open_checkpoint, read_layout
    from ..reshard import plan as plan_mod
    from ..reshard.restore import layout_of
    from ..resilience import integrity

    n = settings.ensemble.n
    active = settings.ensemble.active
    latest = [
        integrity.latest_durable_step_replicated(
            member_path(settings.restart_input, i, n))
        if active[i] else None
        for i in range(n)
    ]
    mapping = plan_mod.member_map([s is not None for s in latest], n,
                                  active=active)
    restored = [i for action, i in mapping if action == "restore"]
    grown = [i for action, i in mapping if action == "init"]
    grown_real = [i for i in grown if active[i]]
    if grown_real and allow == "off":
        raise plan_mod.ReshardError(
            f"resuming {len(restored)} checkpointed members as {n} "
            "(ensemble grow) is an elastic resume and reshard='off' refuses "
            "it; set reshard='auto' (or GS_RESHARD=auto)")
    want = settings.restart_step
    if want < 0:
        want = min(latest[i] for i in restored)

    names = get_model(settings.ensemble.model).field_names
    members = []
    old = None
    for action, i in mapping:
        if action == "init":
            members.append(sim.member_init_fields())
            continue
        ms = member_settings(settings, i)

        def read_member(candidate, ms=ms):
            reader, idx, _ = open_checkpoint(candidate, ms, want)
            with reader:
                return read_layout(reader), tuple(
                    reader.get(name, step=idx) for name in names)

        layout, fields = integrity.restore_with_failover(
            ms.restart_input, read_member, journal=journal, log=log)
        if old is None:
            # Member 0 speaks for the old spatial layout (member stores
            # are solo-identical: all carry the same record).
            old = layout
        members.append(fields)
    plan = plan_mod.plan_restore(old, layout_of(sim), L=settings.L,
                                 allow=allow)
    info = {"restored": len(restored), "grown": len(grown_real),
            "new_n": n}
    idle = n - sum(1 for a in active if a)
    if idle:
        info["idle"] = idle
    plan = dataclasses.replace(plan, members=info,
                               changed=plan.changed or bool(grown_real))
    sim.restore_members(members, want)
    return want, plan
