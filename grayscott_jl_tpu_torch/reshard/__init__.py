"""Elastic resharding: checkpoint on one mesh, resume on another, or move
a live run between rounds (counterpart of ``grayscott_jl_tpu/reshard``).

``plan`` computes and validates the old->new layout plan from the
checkpoint store's layout attributes (pure host math); ``restore``
executes it: per-box reads of the new layout from the global-indexed
store (:func:`restore_run`), or the live move of the fields between two
meshes (:func:`~.restore.reshape_live`).
"""

from .plan import (  # noqa: F401
    LAYOUT_ATTRS,
    LAYOUT_SCHEMA_VERSION,
    LayoutMeta,
    ReshardError,
    ReshardPlan,
    layout_attrs,
    member_map,
    plan_restore,
    read_layout,
    shard_boxes,
)
from .restore import layout_of, restore_run  # noqa: F401
