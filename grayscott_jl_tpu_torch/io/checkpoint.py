"""Checkpoint / restart (counterpart of ``grayscott_jl_tpu/io/checkpoint.py``).

Every ``checkpoint_freq`` steps the driver appends ``(step, *fields)``
to the BP-lite store ``checkpoint_output``; ``restart = true`` resumes
from ``restart_input``. The noise is keyed on the absolute step, so a
resumed run reproduces the uninterrupted trajectory. The store layout
and attributes are the reference's, so a checkpoint written by either
package restarts the other; a bfloat16 checkpoint restarts bitwise.
Checkpoints are exact unless ``snapshot_bits_ckpt`` opts them into the
lossy codec (``codec``), and a restart from a coded one is value-close.
A fresh store also records the writing run's layout (``layout=``, the
reference's :data:`~..reshard.plan.LAYOUT_ATTRS`: mesh dims, axis
names, process count, halo depth, chain fuse, ensemble size, schema);
an append keeps the creation layout. :func:`read_layout` reads it back
as the "old" side of a restore plan (``reshard/plan.plan_restore``),
which a restore on another mesh or process count passes unless
``reshard = "off"`` (``GS_RESHARD=off``) refuses it, as in the
reference (``reshard/restore.restore_run``).

Integrity (``resilience/integrity.py``): ``GS_CKPT_REPLICAS=N`` mirrors
every checkpoint write to ``<path>.r1`` .. ``<path>.r<N-1>``;
``GS_CKPT_VERIFY=full`` reads every saved step back against the CRCs
recorded at ``put`` before the boundary counts as written; and
:func:`load_checkpoint` tries the primary and the mirrors on disk in
health order, failing over on a corrupt or unreadable one (a sole
corrupt store raises its :class:`~.bplite.CorruptionError`).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np

from ..config.settings import Settings, resolve_model
from . import count_steps_upto, open_writer
from ..reshard.plan import ReshardError, layout_attrs  # noqa: F401
from ..reshard.plan import read_layout as _read_layout
from .bplite import BpReader, _md_path
from .codec import CODEC_ATTR, codec_attr_value
from .stream import define_fields, put_fields


class CheckpointWriter:
    """The checkpoint store of a run and its replicas (``paths``, the
    primary first), written in lockstep. ``layout`` (a
    :class:`~..reshard.plan.LayoutMeta`, or None) is written as the
    store's layout attributes on a fresh store only: an append (resume)
    keeps the creation layout, so that a resumed store's attributes
    equal an uninterrupted run's even when the resuming run adopted
    another mesh (each step's blocks say what wrote it)."""

    def __init__(
        self,
        settings: Settings,
        dtype,
        *,
        writer_id: int = 0,
        nwriters: int = 1,
        resume_step: Optional[int] = None,
        layout=None,
        codec: Optional[Dict[str, int]] = None,
    ):
        from ..resilience import integrity

        L = settings.L
        model = resolve_model(settings)
        self.codec = dict(codec or {})
        self.field_names = model.field_names
        self._verify = integrity.resolve_verify(settings) == "full"
        self.writer_id, self.nwriters = writer_id, nwriters
        #: Replica store paths, primary first.
        self.paths = integrity.replica_paths(
            settings.checkpoint_output, integrity.resolve_replicas(settings))
        self.path = self.paths[0]
        self.writers = []
        for path in self.paths:
            # On restart, append (checkpoint_output may be the store the
            # run resumed from), dropping entries past the resume point;
            # each replica counts its own (a stale mirror keeps fewer).
            keep = None
            if settings.restart and resume_step is not None:
                keep = count_steps_upto(path, resume_step)
            fresh = not (settings.restart and os.path.isfile(_md_path(path)))
            # Checkpoints stay on BP-lite with the adios2 bindings
            # importable: rollback-append and selection restores are
            # BP-lite semantics.
            w = open_writer(path, writer_id=writer_id, nwriters=nwriters,
                            append=settings.restart, keep_steps=keep,
                            prefer_adios2=False)
            if writer_id == 0:
                w.define_attribute("L", settings.L)
                w.define_attribute("precision", settings.precision)
                w.define_attribute("model", model.name)
                w.define_attribute("fields", list(self.field_names))
                if self.codec:
                    w.define_attribute(
                        CODEC_ATTR,
                        codec_attr_value(self.codec, self.field_names,
                                         dtype))
                if layout is not None and fresh:
                    for name, value in layout_attrs(
                            mesh_dims=layout.mesh_dims,
                            axis_names=layout.axis_names,
                            process_count=layout.process_count,
                            halo_depth=layout.halo_depth,
                            chain_fuse=layout.chain_fuse,
                            ensemble_size=layout.ensemble_size).items():
                        w.define_attribute(name, value)
            w.define_variable("step", np.int32)
            define_fields(w, self.field_names, dtype, L, self.codec)
            self.writers.append(w)

    @property
    def writer(self):
        """The primary store's writer."""
        return self.writers[0]

    def save(self, step: int, blocks, checksums=None) -> None:
        """``blocks``: a snapshot (``[(offsets, sizes, *field_blocks)]``
        in model declaration order, with the codec form on ``encoded``
        for a coded checkpoint). ``checksums`` (``{field: int}``, the
        boundary's device checksums) go into each store's integrity
        sidecar. Under ``GS_CKPT_VERIFY=full`` every replica's new step
        is read back before this returns."""
        for w in self.writers:
            w.begin_step()
            w.put("step", np.int32(step))
            if checksums is not None:
                w.record_device_checksums(step, checksums)
            put_fields(w, self.field_names, blocks, bool(self.codec))
            w.end_step()
        if self._verify:
            from ..resilience.integrity import verify_last_step

            for w, path in zip(self.writers, self.paths):
                if hasattr(w, "drain"):
                    w.drain()  # the native engine publishes on its thread
                verify_last_step(path, self.writer_id, self.nwriters)

    def close(self) -> None:
        """Close every replica's writer (all of them, even when one
        raises; the first error is raised after)."""
        first = None
        for w in self.writers:
            try:
                w.close()
            except Exception as e:  # noqa: BLE001 — raised below
                first = first or e
        if first is not None:
            raise first


def latest_durable_step(path: str,
                        max_step: Optional[int] = None) -> Optional[int]:
    """Simulation step of the latest complete checkpoint entry of
    ``path`` (at most ``max_step`` when given), or None for a missing,
    empty or unreadable store (with a warning for the last)."""
    try:
        r = BpReader(path)
    except FileNotFoundError:
        return None
    except Exception as e:  # noqa: BLE001 — a corrupt store, reported
        print(f"gray-scott-torch: warning: checkpoint store {path} is "
              f"unreadable ({type(e).__name__}: {e}); treating as no "
              "durable checkpoint", file=sys.stderr)
        return None
    try:
        for k in range(r.num_steps() - 1, -1, -1):
            s = int(r.get("step", step=k))
            if max_step is None or s <= max_step:
                return s
        return None
    except Exception as e:  # noqa: BLE001 — a torn step entry, reported
        print(f"gray-scott-torch: warning: checkpoint store {path} has no "
              f"readable step entries ({type(e).__name__}: {e}); treating "
              "as no durable checkpoint", file=sys.stderr)
        return None
    finally:
        r.close()


def read_layout(reader: BpReader):
    """The store's recorded layout (:class:`~..reshard.plan.LayoutMeta`),
    or None for a store that has none (a pre-elastic store): the "old"
    side of a restore plan."""
    try:
        attrs = reader.attributes()
    except Exception:  # noqa: BLE001 — the layout is advisory provenance
        return None
    return _read_layout(attrs)


def open_checkpoint(
    path: str, settings: Settings, restart_step: int = -1
) -> Tuple[BpReader, int, int]:
    """Open a checkpoint store and find the entry to restart from:
    ``restart_step`` selects the entry with that simulation step (the
    latest such), ``-1`` the latest entry. The store's L, model, fields
    and precision must match the run's. Returns ``(reader, step_index,
    sim_step)``."""
    r = BpReader(path)
    n = r.num_steps()
    if n == 0:
        raise ValueError(f"Checkpoint store {path} contains no steps")
    attrs = r.attributes()
    if int(attrs.get("L", settings.L)) != settings.L:
        raise ValueError(
            f"Checkpoint L={attrs['L']} does not match config L={settings.L}"
        )
    model = resolve_model(settings)
    stored_model = attrs.get("model")
    if stored_model is not None and str(stored_model) != model.name:
        raise ValueError(
            f"Checkpoint store {path} holds model {stored_model!r} but "
            f"this run integrates model {model.name!r}"
        )
    stored_fields = attrs.get("fields")
    if stored_fields is not None and list(stored_fields) != list(
        model.field_names
    ):
        raise ValueError(
            f"Checkpoint store {path} holds fields {list(stored_fields)} "
            f"but model {model.name!r} declares {list(model.field_names)}"
        )
    stored_precision = attrs.get("precision")
    if stored_precision is not None and str(stored_precision) != str(
        settings.precision
    ):
        raise ValueError(
            f"Checkpoint store {path} was written at precision "
            f"{stored_precision!r} but this run is configured for "
            f"{settings.precision!r}"
        )
    if restart_step < 0:
        idx = n - 1
        sim_step = int(r.get("step", step=idx))
    else:
        available = [int(r.get("step", step=i)) for i in range(n)]
        if restart_step not in available:
            raise ValueError(
                f"Checkpoint store {path} has no entry for simulation "
                f"step {restart_step}; available steps: {available}"
            )
        idx = n - 1 - available[::-1].index(restart_step)
        sim_step = restart_step
    return r, idx, sim_step


def load_checkpoint(
    path: str, settings: Settings, restart_step: int = -1, *,
    journal=None, log=None, boxes=None,
) -> Tuple:
    """``(*fields, step)`` of one checkpoint entry, fields in the
    model's declaration order (bfloat16 ones, and coded ones decoded, as
    float32 arrays). The primary and its mirrors on disk are tried in
    health order, a corrupt or unreadable one failing over to the next
    (``resilience/integrity.restore_with_failover``; each failover is
    recorded in ``journal`` and logged). With ``boxes`` (``[(start,
    count)]``, the blocks a process of a multi-process run holds) only
    those boxes are read: the result is ``(blocks, step)``, ``blocks``
    one tuple of field arrays per box. A run's restart goes through
    ``reshard/restore.restore_run``, which plans the layout change
    first."""
    from ..resilience.integrity import restore_with_failover

    def attempt(candidate):
        r, idx, step = open_checkpoint(candidate, settings, restart_step)
        with r:
            return read_entry(r, idx, settings, boxes) + (step,)

    return restore_with_failover(path, attempt, journal=journal, log=log)


def read_entry(reader: BpReader, idx: int, settings: Settings,
               boxes=None) -> Tuple:
    """The fields of entry ``idx`` of an open checkpoint store: a tuple
    of whole ``L^3`` arrays, or with ``boxes`` a one-tuple holding, per
    box, the tuple of its field arrays."""
    names = resolve_model(settings).field_names
    if boxes is not None:
        return ([tuple(reader.get(name, step=idx, start=o, count=c)
                       for name in names) for o, c in boxes],)
    return tuple(reader.get(name, step=idx) for name in names)
