"""Mode knob and decision of the measured autotuner (counterpart of
``grayscott_jl_tpu/tune/autotuner.py``).

``GS_AUTOTUNE`` (wins) / the ``autotune`` key:

* ``off``    — the analytic pick of ``parallel/icimodel``, untouched;
  the cache is not read.
* ``cached`` — (default) a cache hit applies the measured winner with no
  measurement; a miss leaves the analytic pick unchanged, so a fresh
  machine runs bitwise what ``off`` runs.
* ``quick``  — on a miss, time the model's top-3 shortlist within
  ``GS_AUTOTUNE_BUDGET_S`` and store the winner.
* ``full``   — the same with the top 8 (the reference's ``bx`` variants
  have no counterpart: the port's tile is fixed).

The decision's provenance (mode, hit or miss, candidates timed, tuning
seconds, the model's pick against the measured one) rides in
``kernel_selection["autotune"]`` and the ``autotune`` event.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, Optional

from . import cache, candidates, measure
from ..config.env import env_int, env_str

MODES = ("off", "cached", "quick", "full")

#: Shortlist width per mode; ``GS_AUTOTUNE_TOPN`` overrides it.
_TOP_N = {"quick": 3, "full": 8}


def resolve_mode(settings=None) -> str:
    """``GS_AUTOTUNE`` > the ``autotune`` key > ``"cached"``."""
    from ..config.settings import resolve_autotune

    return resolve_autotune(settings)


def resolve_budget_s() -> float:
    """Wall budget of one tuning round (``GS_AUTOTUNE_BUDGET_S``,
    default 120 s): it bounds when candidates start; a started one runs
    its rounds."""
    raw = os.environ.get("GS_AUTOTUNE_BUDGET_S", "120")
    try:
        v = float(raw)
    except ValueError as e:
        raise ValueError(
            f"GS_AUTOTUNE_BUDGET_S must be a number, got {raw!r}"
        ) from e
    if v <= 0:
        raise ValueError(f"GS_AUTOTUNE_BUDGET_S must be > 0, got {v}")
    return v


def _top_n(mode: str) -> int:
    raw = env_str("GS_AUTOTUNE_TOPN", "")
    if raw:
        return max(1, int(raw))
    return _TOP_N[mode]


@dataclasses.dataclass
class TuneDecision:
    """What the run should do, and the story of why."""

    kernel: str
    fuse: Optional[int]  # None: leave the analytic/default depth alone
    comm_overlap: Optional[bool]  # None: leave the resolved value alone
    provenance: dict
    #: Ensembles (Queue 1 item 19): None for a solo run.
    member_shards: Optional[int] = None
    #: The s-step depth the winner measured fastest (None: leave it).
    halo_depth: Optional[int] = None
    #: The precision posture the winner measured fastest (None: leave
    #: it; only a ``bf16_f32acc`` run receives one).
    compute_precision: Optional[str] = None


def _emit_event(prov: dict, kernel: str) -> None:
    """The decision onto the run's event stream (``GS_EVENTS``), in the
    ``compile`` phase."""
    from ..obs import events as obs_events

    stream = obs_events.get_events()
    if not stream.enabled:
        return
    winner = prov.get("winner") or {}
    stream.emit(
        "autotune", phase="compile",
        mode=prov.get("mode"), source=prov.get("source"),
        cache=prov.get("cache"), kernel=kernel,
        halo_depth=winner.get("halo_depth"),
        candidates_timed=prov.get("candidates_timed"),
        tuning_s=prov.get("tuning_s"),
    )


def _analytic_decision(mode: str, analytic_kernel: str,
                       extra: Optional[dict] = None) -> TuneDecision:
    prov = {"mode": mode, "source": "analytic", "cache": None,
            "candidates_timed": 0, "tuning_s": 0.0}
    if extra:
        prov.update(extra)
    _emit_event(prov, analytic_kernel)
    return TuneDecision(kernel=analytic_kernel, fuse=None,
                        comm_overlap=None, provenance=prov)


def _winner_decision(mode: str, winner: dict, prov: dict) -> TuneDecision:
    ms = winner.get("member_shards")
    sk = winner.get("halo_depth")
    _emit_event(prov, winner["kernel"])
    return TuneDecision(
        kernel=winner["kernel"],
        fuse=int(winner["fuse"]),
        comm_overlap=bool(winner["comm_overlap"]),
        provenance=prov,
        member_shards=int(ms) if ms is not None else None,
        halo_depth=int(sk) if sk is not None else None,
        compute_precision=winner.get("compute_precision"),
    )


def autotune(
    settings,
    *,
    dims,
    L: int,
    platform: str,
    device_kind: str,
    dtype: str,
    noise: float,
    itemsize: int,
    devices,
    seed: int,
    analytic_kernel: str,
    analytic_fuse: int,
    comm_overlap: bool,
    overlap_toggle: bool,
    link_gbps: float = 90.0,
    links: int = 6,
    hop_us: float = 1.0,
    placement: str = "shared",
    timer: Optional[Callable] = None,
    ensemble: int = 1,
    member_shards: int = 1,
    sim_cls=None,
    model: str = "grayscott",
    n_fields: int = 2,
    kernel_allowed: bool = True,
    halo_depth: int = 0,
    procs: int = 1,
    compute_precision: str = "f32",
    snapshot_codec: str = "off",
    kernel_generator: int = 0,
) -> TuneDecision:
    """Resolve the measured schedule for one run config.

    Called from ``Simulation.__init__`` after the analytic Auto decision
    and its mesh adoption, so ``dims`` is the mesh the run uses and the
    key describes it. ``devices`` is this process's share of the run's
    devices (each candidate is built on them). ``timer`` is the test
    seam (the ``time_sim_rounds`` contract). ``ensemble`` is the member
    count of a batched run and ``member_shards`` its split (both in the
    key, so ensemble sizes and splits never share an entry); ``sim_cls``
    builds each candidate (``EnsembleSimulation`` for an ensemble)."""
    import torch

    mode = resolve_mode(settings)
    gate = {"model": model, "n_fields": n_fields,
            "kernel_allowed": bool(kernel_allowed),
            "kernel_generator": int(kernel_generator),
            "halo_depth_pin": int(halo_depth),
            "cache_schema": int(cache.SCHEMA_VERSION),
            "compute_precision": compute_precision,
            "snapshot_codec": snapshot_codec}
    if mode == "off":
        return _analytic_decision(mode, analytic_kernel, gate)

    cards = len({str(d) for d in devices if torch.device(d).type == "cuda"})
    key = cache.cache_key(
        device_kind=device_kind, platform=platform, dims=dims, L=L,
        dtype=dtype, noise=noise, torch_version=torch.__version__,
        cuda_version=torch.version.cuda, ensemble=ensemble, model=model,
        n_fields=n_fields, halo_depth=halo_depth,
        member_shards=member_shards, procs=procs, placement=placement,
        cards=cards, compute_precision=compute_precision,
        snapshot_codec=snapshot_codec, kernel_generator=kernel_generator,
    )
    rec = cache.load(key)
    if rec is not None:
        try:
            winner = dict(rec["winner"])
            prov = {
                "mode": mode, "source": "cache", "cache": "hit",
                "candidates_timed": 0, "tuning_s": 0.0,
                "winner": winner,
                "cache_created": rec.get("created"),
                "cache_path": cache.entry_path(key),
                **gate,
            }
            return _winner_decision(mode, winner, prov)
        except (KeyError, TypeError, ValueError) as e:
            print(f"gray-scott-torch: warning: tuning cache winner "
                  f"unusable ({e}); falling back to the analytic pick",
                  file=sys.stderr)

    if mode == "cached":
        # A miss changes nothing about the run.
        return _analytic_decision(mode, analytic_kernel,
                                  {"cache": "miss", **gate})

    budget_s = resolve_budget_s()
    t0 = time.monotonic()
    cands = candidates.generate(
        dims=dims, L=L, platform=platform, itemsize=itemsize,
        fuse_cap=max(analytic_fuse, 1), analytic_kernel=analytic_kernel,
        analytic_fuse=analytic_fuse, comm_overlap=comm_overlap,
        overlap_toggle=overlap_toggle, link_gbps=link_gbps, links=links,
        hop_us=hop_us, top_n=_top_n(mode), ensemble=ensemble,
        member_shards=member_shards, kernel_allowed=kernel_allowed,
        halo_depth=halo_depth, compute_precision=compute_precision,
        n_fields=n_fields,
        # The card's projection counts the blocks one process issues;
        # off the card the projection is the reference's.
        blocks=len(devices) if platform == "cuda" else 1,
    )
    steps = env_int("GS_AUTOTUNE_STEPS", 20)
    rounds = env_int("GS_AUTOTUNE_ROUNDS", 2 if mode == "quick" else 3)
    ms, skipped = measure.measure_candidates(
        settings, cands, dims=dims, devices=devices, seed=seed,
        deadline=t0 + budget_s, steps=steps, rounds=rounds, timer=timer,
        sim_cls=sim_cls, processes=procs,
    )
    tuning_s = round(time.monotonic() - t0, 3)
    win = measure.best(ms)
    pick = next((m for m in ms if m.candidate.analytic), None)
    prov = {
        "mode": mode, "cache": "miss", **gate,
        "candidates_timed": sum(1 for m in ms if m.ok()),
        "candidates_skipped": skipped,
        "candidates_errored": sum(1 for m in ms if not m.ok()),
        "tuning_s": tuning_s,
        "budget_s": budget_s,
    }
    if win is None:
        prov.update({"source": "analytic",
                     "reason": "no candidate measured successfully"})
        return _analytic_decision(mode, analytic_kernel, prov)

    winner = dict(win.candidate.as_dict())
    winner["median_us_per_step"] = win.median_us_per_step
    prov.update({
        "source": "measured",
        "winner": winner,
        "model_pick": (pick.candidate.as_dict() if pick else None),
        "model_pick_us": (pick.median_us_per_step
                          if pick and pick.ok() else None),
        "measured_pick_us": win.median_us_per_step,
    })
    if pick is not None and pick.ok() and pick.median_us_per_step:
        prov["model_vs_measured_speedup"] = round(
            pick.median_us_per_step / win.median_us_per_step, 4
        )
    from ..parallel import distributed

    if distributed.process_index() == 0:
        try:
            import datetime

            path = cache.store(key, {
                "winner": winner,
                "measurements": [m.as_dict() for m in ms],
                "provenance": {k: prov[k] for k in
                               ("mode", "candidates_timed", "tuning_s",
                                "budget_s")},
                "created": datetime.datetime.now(datetime.timezone.utc)
                .isoformat(timespec="seconds"),
            })
            prov["cache_path"] = path
        except OSError as e:
            print(f"gray-scott-torch: warning: could not persist tuning "
                  f"cache ({e}); this round's winner applies to this run "
                  "only", file=sys.stderr)
    return _winner_decision(mode, winner, prov)
