"""Batched ensembles: N parameter sets of one model, one kernel launch
per block and round (counterpart of ``grayscott_jl_tpu/ensemble``).

* :mod:`.spec` — the ``[ensemble]`` TOML table (presets, member tables,
  sweeps) -> :class:`~.spec.EnsembleSettings`;
* :mod:`.engine` — :class:`~.engine.EnsembleSimulation`, the member axis
  through the unchanged step loop and the kernel's member grid axis;
* :mod:`.io` — member-indexed output and checkpoint stores,
  byte-identical to solo stores, and the elastic member restore.

The spec module imports nothing of torch, so the config layer parses
ensemble tables without loading the engine.
"""

from .spec import (  # noqa: F401
    EnsembleSettings,
    MemberSpec,
    PRESETS,
    resolve_seeds,
)

__all__ = [
    "EnsembleSettings",
    "EnsembleSimulation",
    "MemberSpec",
    "PRESETS",
    "resolve_seeds",
]


def __getattr__(name):
    # The engine pulls in torch and the simulation; keep it lazy.
    if name == "EnsembleSimulation":
        from .engine import EnsembleSimulation

        return EnsembleSimulation
    raise AttributeError(name)
