"""Elastic capacity control: queue pressure -> live mesh reshapes
(counterpart of ``grayscott_jl_tpu/serve/elastic.py``).

The scheduler measures load (the ``serve_queue_depth`` gauge, worker
utilization); the :class:`ElasticController` acts on it: a daemon
thread samples both signals every tick and, through the scheduler's
``request_reshape`` seam, posts live grow/shrink requests that the
worker's between-rounds ``reshape_poll`` turns into
:func:`~..reshard.restore.reshape_live` moves — no kill, no checkpoint
round-trip, the continuation bitwise identical.

The policy is hysteresis plus cooldown, as the reference's:

* **pressure** (queue depth >= ``GS_SERVE_ELASTIC_HIGH`` *and* every
  worker busy) for ``GS_SERVE_ELASTIC_SUSTAIN`` consecutive ticks ->
  SHRINK the oldest running batch's mesh;
* **relief** (queue depth <= ``GS_SERVE_ELASTIC_LOW`` *and* spare worker
  capacity) sustained the same way -> GROW it;
* any action arms a ``GS_SERVE_ELASTIC_COOLDOWN_S`` refractory window.

The controller posts *scale hints* (``{"scale": "grow"|"shrink"}``),
never meshes: the driver owns feasibility (``_resolve_reshape_dims``),
and refuses a hint the usable devices cannot hold — on one card a
single-block batch stays where it is. Off by default
(``GS_SERVE_ELASTIC=1`` opts in). Every action lands on the event stream
as an ``elastic`` record plus the ``serve_elastic_actions`` counter.
This module imports neither torch nor JAX itself.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

from ..config.env import env_flag, env_float, env_int
from ..utils.log import Logger

__all__ = [
    "ElasticConfig",
    "ElasticController",
    "resolve_elastic_config",
]


@dataclasses.dataclass
class ElasticConfig:
    """Resolved ``GS_SERVE_ELASTIC*`` knob family."""

    enabled: bool = False
    high: int = 4
    low: int = 0
    sustain: int = 2
    cooldown_s: float = 5.0
    tick_s: float = 0.5

    def describe(self) -> dict:
        return dataclasses.asdict(self)


def resolve_elastic_config(settings=None) -> ElasticConfig:
    """The ``GS_SERVE_ELASTIC*`` env knobs -> :class:`ElasticConfig`.

    Env-only, like :func:`~.scheduler.resolve_serve_config`.
    """
    cfg = ElasticConfig(
        enabled=env_flag("GS_SERVE_ELASTIC", False),
        high=env_int("GS_SERVE_ELASTIC_HIGH", 4),
        low=env_int("GS_SERVE_ELASTIC_LOW", 0),
        sustain=env_int("GS_SERVE_ELASTIC_SUSTAIN", 2),
        cooldown_s=env_float("GS_SERVE_ELASTIC_COOLDOWN_S", 5.0),
        tick_s=env_float("GS_SERVE_ELASTIC_TICK_S", 0.5),
    )
    if cfg.high < 1:
        raise ValueError(
            f"GS_SERVE_ELASTIC_HIGH must be >= 1, got {cfg.high}"
        )
    if not 0 <= cfg.low < cfg.high:
        raise ValueError(
            f"GS_SERVE_ELASTIC_LOW must be in [0, high={cfg.high}), "
            f"got {cfg.low} — overlapping thresholds defeat the "
            "hysteresis"
        )
    if cfg.sustain < 1:
        raise ValueError(
            f"GS_SERVE_ELASTIC_SUSTAIN must be >= 1, got {cfg.sustain}"
        )
    if cfg.cooldown_s < 0:
        raise ValueError(
            f"GS_SERVE_ELASTIC_COOLDOWN_S must be >= 0, got "
            f"{cfg.cooldown_s}"
        )
    if cfg.tick_s <= 0:
        raise ValueError(
            f"GS_SERVE_ELASTIC_TICK_S must be > 0, got {cfg.tick_s}"
        )
    return cfg


class ElasticController:
    """One daemon thread turning load signals into reshape requests.

    ``fleet`` is anything with a ``utilization() -> float`` (the local
    :class:`~.worker.WorkerFleet`); pass None on a pure front door —
    utilization then reads as fully busy, so only the queue signal
    drives the policy (a front door can still post requests that
    fleet workers consume through the cluster KV relay).
    """

    def __init__(self, scheduler, fleet=None,
                 cfg: Optional[ElasticConfig] = None, *,
                 events=None, metrics=None,
                 log: Optional[Logger] = None):
        self.scheduler = scheduler
        self.fleet = fleet
        self.cfg = cfg or resolve_elastic_config()
        if events is None:
            from ..obs import events as obs_events

            events = obs_events.get_events()
        if metrics is None:
            from ..obs import metrics as obs_metrics

            metrics = obs_metrics.get_metrics()
        self.events = events
        self.metrics = metrics
        self.log = log or Logger(verbose=False)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._pressure_ticks = 0
        self._relief_ticks = 0
        self._cooldown_until = 0.0
        self.actions = 0

    # ------------------------------------------------------- lifecycle

    def start(self) -> "ElasticController":
        """No-op unless ``GS_SERVE_ELASTIC=1``; idempotent."""
        if self.cfg.enabled and self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="gs-serve-elastic", daemon=True
            )
            self._thread.start()
        return self

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # ------------------------------------------------------------ loop

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.tick_s):
            try:
                self.tick()
            except Exception as e:  # pragma: no cover — keep sampling
                self.log.warn(f"elastic tick failed: {e}")

    def tick(self) -> Optional[str]:
        """One policy evaluation; returns the action taken (for
        tests), else None. Split from the thread loop so tests can
        drive the policy deterministically without sleeping."""
        depth = self.scheduler.queue_depth()
        util = (
            self.fleet.utilization() if self.fleet is not None else 1.0
        )
        pressure = depth >= self.cfg.high and util >= 1.0
        relief = depth <= self.cfg.low and util < 1.0
        self._pressure_ticks = (
            self._pressure_ticks + 1 if pressure else 0
        )
        self._relief_ticks = self._relief_ticks + 1 if relief else 0
        if time.monotonic() < self._cooldown_until:
            return None
        if pressure and self._pressure_ticks >= self.cfg.sustain:
            return self._act("shrink", depth, util)
        if relief and self._relief_ticks >= self.cfg.sustain:
            return self._act("grow", depth, util)
        return None

    def _act(self, scale: str, depth: int,
             util: float) -> Optional[str]:
        running = self.scheduler.running_batches()
        if not running:
            return None
        # Oldest running batch first: it has the most remaining value
        # from a grow and the most settled state to shrink.
        batch = min(running, key=lambda b: b.created_t)
        if not self.scheduler.request_reshape(
            batch.id, {"scale": scale}
        ):
            return None
        self.actions += 1
        self._pressure_ticks = self._relief_ticks = 0
        self._cooldown_until = time.monotonic() + self.cfg.cooldown_s
        self.metrics.counter(
            "serve_elastic_actions", action=scale
        ).inc()
        self.events.emit(
            "elastic", action=scale, batch=batch.id, depth=depth,
            utilization=round(util, 3),
        )
        self.log.info(
            f"elastic: {scale} {batch.id} "
            f"(depth={depth}, util={util:.2f})"
        )
        return scale
