"""Public simulation API: settings -> model -> device -> fields -> step loop
(counterpart of ``grayscott_jl_tpu/simulation.py``, single device).

* :func:`initialization` parses the config and builds a ready
  :class:`Simulation`.
* :meth:`Simulation.iterate` advances n steps. On the kernel path it
  runs ``divmod(n, fuse)`` launches of the fused CUDA kernel, then one
  shallower launch for the remainder, each seeded by its absolute step;
  on the plain path, n plain torch steps. It never waits for the
  device: no ``.item()``, no copy to the host.
* :meth:`Simulation.get_fields` / :meth:`Simulation.snapshot` copy the
  fields to the host; :meth:`Simulation.restore_fields` loads them back.

The noise key is the integer pair ``(0, seed)``: the int32 words of the
reference's ``jax.random.PRNGKey(seed)``, so a seed draws the same
noise in both packages.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .config import settings as config
from .config.env import env_str
from .config.settings import Settings
from .models import SettingsError
from .ops import cuda_stencil, kernelgen
from .parallel.domain import CartDomain


#: Chain depth with the least time per step on the card at L=256
#: float32, as ``chip_smoke.py`` phase 5 measures it on an H100 (see
#: PERF.md): the chain kernel's deeper windows cost more in recompute
#: and occupancy than they save in bytes.
MEASURED_BEST_FUSE = 1


def default_fuse(dtype, device) -> int:
    """Temporal-blocking depth of the kernel path: ``GS_FUSE`` when set,
    else on the card :data:`MEASURED_BEST_FUSE` within the shared-memory
    ledger's cap for ``dtype``, and 2 on the CPU (the reference's
    off-chip depth)."""
    v = env_str("GS_FUSE", "")
    if v:
        try:
            return max(1, int(v))
        except ValueError as e:
            raise ValueError(
                f"GS_FUSE must be a positive integer, got {v!r}"
            ) from e
    if torch.device(device).type == "cuda":
        itemsize = torch.empty((), dtype=dtype).element_size()
        return min(MEASURED_BEST_FUSE,
                   cuda_stencil.max_feasible_fuse(itemsize))
    return 2


def base_key(seed: int) -> Tuple[int, int]:
    """The noise key words of ``seed`` (``jax.random.PRNGKey(seed)``
    bitcast to int32, for 0 <= seed < 2**32)."""
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return 0, int(seed)


class Simulation:
    """One registered model on one device (Gray-Scott by default)."""

    def __init__(self, settings: Settings, *, seed: int = 0):
        self.settings = settings
        config.check_ported(settings)
        self.model = config.resolve_model(settings)
        _, self.kernel_language = config.load_backend_and_lang(settings)
        self.device = config.resolve_device(settings)
        self.dtype = config.resolve_precision(settings)
        if self.kernel_language == "cuda" and self.device.type == "cuda":
            reason = kernelgen.generation_gate_reason(self.model)
            if reason is not None:
                raise SettingsError(
                    f"kernel_language = {settings.kernel_language!r} on "
                    f"the card cannot run model {self.model.name!r}: "
                    f"{reason} (use 'Plain')"
                )
        self.domain = CartDomain.create(1, settings.L)
        self.spec = kernelgen.get_spec(self.model)
        self.fuse = default_fuse(self.dtype, self.device)
        self.params = self.model.make_params(
            settings, self.dtype, self.device
        )
        self.use_noise = settings.noise != 0.0
        self.base_key = base_key(seed)
        self.step = 0
        self.fields = tuple(
            self.model.init(settings.L, self.dtype, device=self.device)
        )

    def _seeds(self, step: int) -> Tuple[int, int, int]:
        return self.base_key[0], self.base_key[1], step

    def iterate(self, nsteps: int = 1) -> None:
        """Advance ``nsteps`` steps; enqueues device work only."""
        if nsteps <= 0:
            return
        L = self.settings.L
        fields = self.fields
        step0 = self.step
        if self.kernel_language == "cuda":
            fuse = min(self.fuse, nsteps)
            rounds, rem = divmod(nsteps, fuse)
            for i in range(rounds):
                fields = cuda_stencil.fused_step(
                    fields, self.params, self._seeds(step0 + fuse * i),
                    spec=self.spec, use_noise=self.use_noise, fuse=fuse,
                    row=L,
                )
            if rem:
                fields = cuda_stencil.fused_step(
                    fields, self.params, self._seeds(step0 + fuse * rounds),
                    spec=self.spec, use_noise=self.use_noise, fuse=rem,
                    row=L,
                )
        else:
            for i in range(nsteps):
                fields = cuda_stencil.plain_step(
                    fields, self.params, self._seeds(step0 + i),
                    spec=self.spec, use_noise=self.use_noise, row=L,
                )
        self.fields = tuple(fields)
        self.step += nsteps

    def get_fields(self) -> Tuple[np.ndarray, ...]:
        """Host copies of the model's fields, declaration order."""
        return tuple(f.cpu().numpy() for f in self.fields)

    def snapshot(self):
        """The fields as host blocks ``[(offsets, sizes, *fields)]`` —
        one whole-grid block — for the output and checkpoint stores."""
        L = self.settings.L
        return [((0, 0, 0), (L, L, L)) + self.get_fields()]

    def restore_fields(self, fields, step: int) -> None:
        """Load host field arrays (declaration order) at ``step``."""
        fields = tuple(fields)
        if len(fields) != self.model.n_fields:
            raise ValueError(
                f"Checkpoint has {len(fields)} fields; model "
                f"{self.model.name!r} declares {self.model.n_fields}"
            )
        expected = (self.settings.L,) * 3
        for name, f in zip(self.model.field_names, fields):
            if tuple(np.shape(f)) != expected:
                raise ValueError(
                    f"Checkpoint shape {name}={np.shape(f)} does not match "
                    f"L={self.settings.L}"
                )
        self.fields = tuple(
            torch.tensor(np.asarray(f), dtype=self.dtype, device=self.device)
            for f in fields
        )
        self.step = int(step)

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def initialization(args, *, seed: int = 0):
    """Parse the config and build the simulation:
    ``(settings, domain, sim)``."""
    settings = config.get_settings(list(args))
    sim = Simulation(settings, seed=seed)
    return settings, sim.domain, sim

