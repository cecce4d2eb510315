"""Measured autotuner behind ``kernel_language = "Auto"`` (counterpart of
``grayscott_jl_tpu/tune/``): the fabric model
(``parallel/icimodel.py``) projects a shortlist, the tuner times it on
the real step function and remembers the winner.

* :mod:`~.candidates` — the top-N shortlist (chain depth x
  ``comm_overlap`` x ``halo_depth``, the precision under
  ``bf16_f32acc``), pruned by the runner's own shared-memory ledger;
* :mod:`~.measure` — build and time each candidate with
  ``utils/benchmark.time_sim_rounds`` under ``GS_AUTOTUNE_BUDGET_S``;
* :mod:`~.cache` — the versioned, atomically written tuning cache;
* :mod:`~.autotuner` — the mode (off | cached | quick | full) and the
  decision record in ``kernel_selection["autotune"]``.

The default mode is ``cached``: a miss leaves the analytic pick as it
is, so a run on a fresh machine is bitwise the tuner-less run.
"""

from .autotuner import TuneDecision, autotune, resolve_budget_s  # noqa: F401
from .cache import SCHEMA_VERSION, cache_key  # noqa: F401
