"""Simulation as a service: the persistent multi-tenant front door
(counterpart of ``grayscott_jl_tpu/serve/``).

Clients submit JSON job specs over HTTP; the scheduler packs compatible
requests — keyed by ``(model, L, steps, cadence, precision, halo depth,
noise)`` — onto warm batched ensembles (a request is a MEMBER of an
``EnsembleSimulation``, so on the card a packed batch is one launch of
the batched kernel per step for every slot); a supervised worker fleet
runs the launches through the resilience stack; progress streams back
off the ``GS_EVENTS`` stream and the metrics registry.

Layering, as the reference's: ``protocol``, ``cache``, ``scheduler``,
``cluster`` and ``elastic`` import neither torch nor JAX; ``worker``
reaches the engine at launch time; ``server`` is the stdlib
``http.server`` front. ``cluster`` moves the scheduler state into a
shared filesystem namespace (N front doors and M worker processes act as
one service) and ``cache`` answers a repeated spec from a
content-addressed, CRC-verified store of finished trajectories.

Where the port differs from the reference, by design: batches run on the
card through the kernel (``ServeConfig.backend = "CUDA"``, the default),
where the reference's pin ``CPU``/``Plain``; ``--backend CPU`` gives the
reference's settings. The cache digest of a service on the card carries
``"device": "cuda"``.

    python -m grayscott_jl_tpu_torch.serve [--backend CUDA|CPU]
        [--role frontdoor|worker]
"""

from .cache import ResultCache, job_digest  # noqa: F401
from .protocol import JobSpec, pack_key, parse_job  # noqa: F401
from .scheduler import (  # noqa: F401
    Job,
    Scheduler,
    ServeConfig,
    resolve_serve_config,
)
