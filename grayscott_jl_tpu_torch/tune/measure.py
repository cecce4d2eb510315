"""Time the tuner's candidates on the real step function (counterpart of
``grayscott_jl_tpu/tune/measure.py``).

Each candidate is pinned as an operator would pin it — an explicit
kernel language, ``comm_overlap``, ``halo_depth`` and
``compute_precision`` in the settings, ``GS_FUSE`` in the environment,
the run's mesh and devices — built as a fresh ``Simulation`` and timed
with the one timing discipline (``utils/benchmark.time_sim_rounds``).
A candidate is only started while the budget's ``deadline`` has not
passed, and a started one finishes its rounds; the ones never started
are counted.

A candidate whose geometry the settings refuse (``SettingsError``)
records the error and the sweep goes on, as in the reference. A kernel
failure — a build error, a launch error, the injected ``kernel`` fault
— and a sticky CUDA error are raised: on the card the run uses the
hand-written kernels or stops, and the tuner never swallows the reason.

In a run of several processes every process times the same candidates
in the same order and calls the same collectives: the budget check is
agreed (``any_process``), and after each candidate one gather carries
every process's outcome — a candidate that failed on any process is an
error on all of them, a kernel failure on any process stops every one,
and a timed candidate's times are the slowest process's — so that every
process picks the same winner. Tests pass ``timer=`` (the ``time_sim_rounds``
contract) to make the whole quick path deterministic.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional, Tuple

from .candidates import Candidate


@dataclasses.dataclass
class Measurement:
    """Timing outcome for one candidate."""

    candidate: Candidate
    median_us_per_step: Optional[float] = None
    best_us_per_step: Optional[float] = None
    rounds_us_per_step: Optional[list] = None
    error: Optional[str] = None

    def ok(self) -> bool:
        return self.error is None and self.median_us_per_step is not None

    def as_dict(self) -> dict:
        d = {"candidate": self.candidate.as_dict()}
        for k in ("median_us_per_step", "best_us_per_step",
                  "rounds_us_per_step", "error"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d


def pinned_settings(settings, candidate: Candidate):
    """A Settings copy with the candidate pinned the way an operator
    would pin it (an explicit language, so the measured simulation never
    re-enters Auto or the tuner), and supervision, restart and
    checkpoint off. An ensemble candidate's ``member_shards`` is pinned
    into the ensemble table the same way."""
    ens = getattr(settings, "ensemble", None)
    if ens is not None and candidate.member_shards is not None:
        settings = dataclasses.replace(settings, ensemble=dataclasses.replace(
            ens, member_shards=int(candidate.member_shards)))
    return dataclasses.replace(
        settings,
        kernel_language="CUDA" if candidate.kernel == "cuda" else "Plain",
        comm_overlap="on" if candidate.comm_overlap else "off",
        halo_depth=max(1, int(candidate.halo_depth)),
        compute_precision=candidate.compute_precision or "f32",
        autotune="off",
        supervise=False, restart=False, checkpoint=False,
    )


class _env_pins:
    """Scoped environment overrides, restored on exit even when the
    candidate's build raises."""

    def __init__(self, pins: dict):
        self.pins = {k: v for k, v in pins.items() if v is not None}
        self._saved = {}

    def __enter__(self):
        for k, v in self.pins.items():
            self._saved[k] = os.environ.get(k)
            os.environ[k] = str(v)
        return self

    def __exit__(self, *exc):
        for k, prior in self._saved.items():
            if prior is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = prior


def default_timer(sim, steps: int, rounds: int, deadline: float) -> dict:
    """The production timer: ``utils/benchmark.time_sim_rounds`` with the
    tuner's deadline."""
    from ..utils.benchmark import time_sim_rounds

    return time_sim_rounds(sim, steps, rounds, deadline=deadline)


def _fatal(exc: BaseException) -> bool:
    """A kernel failure or a sticky CUDA error: never a candidate's
    error."""
    from ..ops._build import KernelBuildError
    from ..ops.cuda_stencil import KernelLaunchError
    from ..resilience.faults import InjectedKernelError
    from ..resilience.supervisor import context_lost

    return (isinstance(exc, (KernelBuildError, KernelLaunchError,
                             InjectedKernelError))
            or context_lost(exc))


def measure_candidates(
    settings,
    cands: List[Candidate],
    *,
    dims,
    devices,
    seed: int = 0,
    deadline: float,
    steps: int,
    rounds: int,
    timer: Optional[Callable] = None,
    sim_cls=None,
    processes: int = 1,
) -> Tuple[List[Measurement], int]:
    """Time each candidate in shortlist order until the deadline, each on
    the run's mesh ``dims`` (a candidate's own ``mesh`` wins) and
    ``devices`` (this process's share). Returns ``(measurements,
    skipped)``: one measurement for every candidate started (timed or
    errored), and the count never started."""
    from ..models import SettingsError
    from ..parallel import distributed

    if sim_cls is None:
        from ..simulation import Simulation as sim_cls

    timer = default_timer if timer is None else timer
    out: List[Measurement] = []
    skipped = 0
    for i, cand in enumerate(cands):
        if out:
            passed = time.monotonic() >= deadline
            if processes > 1:
                passed = distributed.any_process(passed)
            if passed:
                skipped = len(cands) - i
                break
        mesh = tuple(cand.mesh if cand.mesh is not None else dims)
        pins = {"GS_FUSE": cand.fuse,
                # The settings' pins would lose to these in the
                # environment.
                "GS_COMM_OVERLAP": "on" if cand.comm_overlap else "off",
                "GS_HALO_DEPTH": max(1, int(cand.halo_depth)),
                "GS_COMPUTE_PRECISION": cand.compute_precision or "f32",
                "GS_AUTOTUNE": "off"}
        error, fatal = None, None
        try:
            with _env_pins(pins):
                sim = sim_cls(pinned_settings(settings, cand), seed=seed,
                              mesh_dims=mesh, devices=list(devices))
                t = timer(sim, steps, rounds, deadline)
                del sim
        except SettingsError as e:
            error = f"{type(e).__name__}: {e}"
        except Exception as e:  # noqa: BLE001 — sorted below
            if _fatal(e) and processes == 1:
                raise
            fatal = e if _fatal(e) else None
            error = f"{type(e).__name__}: {e}"
        if processes > 1:
            # Every process's outcome (0 timed, 1 an error, 2 a kernel
            # failure) and times, in one gather whatever happened here.
            status = 2 if fatal is not None else 1 if error else 0
            times = [t["median"], t["best"]] if status == 0 else [0.0, 0.0]
            rows = distributed.all_gather_f64([status, *times])
            worst = max(range(len(rows)), key=lambda i: rows[i][0])
            if fatal is not None:
                raise fatal
            if rows[worst][0] == 2:
                from ..ops.cuda_stencil import KernelLaunchError

                raise KernelLaunchError(
                    f"autotune: process {worst} stopped on a kernel "
                    f"failure in candidate {cand.label()}")
            if rows[worst][0] == 1 and error is None:
                error = f"failed on process {worst}"
        if error is not None:
            out.append(Measurement(candidate=cand, error=error))
            continue
        median, best_s = t["median"], t["best"]
        if processes > 1:
            # The slowest process's times: every process ranks alike.
            median = max(float(r[1]) for r in rows)
            best_s = max(float(r[2]) for r in rows)
        out.append(Measurement(
            candidate=cand,
            median_us_per_step=round(median * 1e6, 1),
            best_us_per_step=round(best_s * 1e6, 1),
            rounds_us_per_step=[round(s * 1e6, 1)
                                for s in t["rounds_s_per_step"]],
        ))
    return out, skipped


def best(measurements: List[Measurement]) -> Optional[Measurement]:
    """The fastest successful measurement by median, or None."""
    ok = [m for m in measurements if m.ok()]
    if not ok:
        return None
    return min(ok, key=lambda m: m.median_us_per_step)
