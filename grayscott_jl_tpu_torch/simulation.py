"""Public simulation API: settings -> model -> devices -> blocks -> step
loop (counterpart of ``grayscott_jl_tpu/simulation.py``).

* :func:`initialization` parses the config and builds a ready
  :class:`Simulation`.
* :func:`select_kernel` applies the kernel generator's gate at
  construction: every model it accepts runs its generated CUDA kernel;
  one it refuses raises under ``CUDA``/``Pallas`` and runs the plain
  path under ``Auto``, the decision recorded in ``kernel_selection``.
* The grid is decomposed over a :class:`~.parallel.mesh.DeviceMesh`:
  one block per mesh position, each on its device (a device may hold
  several blocks). On the card the default mesh spans every visible
  card; on the CPU it is one block unless ``n_devices`` or ``devices``
  asks for more. ``GS_TPU_MESH_DIMS`` or ``mesh_dims`` picks the
  factorization, as in the reference.
* :meth:`Simulation.iterate` advances n steps. A single block runs
  ``divmod(n, fuse)`` launches of the model's fused CUDA kernel, then one
  shallower launch for the remainder, each seeded by its absolute step;
  on the plain path, n plain torch steps. A sharded run takes the
  reference's branches (``_local_run``) over all blocks: the 6n-face
  kernel at depth 1, the x-chain on ``(n, 1, 1)`` meshes and the
  xy-chain on the others at depth k >= 2, or the plain halo-padded step
  and window chain. It never waits for the device.
* :meth:`Simulation.get_fields` / :meth:`Simulation.snapshot` copy the
  fields to the host (bfloat16 fields as float32 arrays holding the bf16
  values; the snapshot quantizes coded fields on the device first);
  :meth:`Simulation.restore_fields` loads them back.
* Precision: ``precision`` gives the storage dtype; under
  ``compute_precision = "bf16_f32acc"`` a Float32 run stores bfloat16
  and accumulates in float32 (``compute_dtype``). The params live at the
  compute dtype. The kernel computes bfloat16 fields in float32 either
  way; the plain path computes in the params' dtype, as the reference's
  XLA path does.

The noise key is the integer pair ``(0, seed)``: the int32 words of the
reference's ``jax.random.PRNGKey(seed)``, so a seed draws the same
noise in both packages. The noise is keyed on global coordinates, so a
trajectory is the same bitwise for every mesh, depth and chunking.
"""

from __future__ import annotations

import sys
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import settings as config
from .config.env import env_str
from .config.settings import Settings
from .io.codec import (BoundaryBlocks, EncodedField, device_quantize,
                       resolve_snapshot_codec)
from .models import SettingsError
from .ops import cuda_stencil, kernelgen, stencil
from .ops.noise import uniform_pm1_block
from .parallel import halo, temporal
from .parallel.domain import CartDomain
from .parallel.mesh import DeviceMesh, select_devices
from .resilience.health import device_probe, report_of


#: Chain depth with the least time per step on the card at L=256
#: float32, as ``chip_smoke.py`` phase 5 measures it on an H100 (see
#: PERF.md): the chain kernel's deeper windows cost more in recompute
#: and occupancy than they save in bytes.
MEASURED_BEST_FUSE = 1


def default_fuse(dtype, device, n_fields: int = 2) -> int:
    """Temporal-blocking depth of the kernel path: ``GS_FUSE`` when set,
    else on the card :data:`MEASURED_BEST_FUSE` within the shared-memory
    ledger's cap for ``dtype`` (and ``GS_MID_BF16``), and 2 on the CPU
    (the reference's off-chip depth)."""
    v = env_str("GS_FUSE", "")
    if v:
        try:
            return max(1, int(v))
        except ValueError as e:
            raise ValueError(
                f"GS_FUSE must be a positive integer, got {v!r}"
            ) from e
    if torch.device(device).type == "cuda":
        return min(MEASURED_BEST_FUSE,
                   cuda_stencil.chain_cap(dtype, n_fields))
    return 2


def base_key(seed: int) -> Tuple[int, int]:
    """The noise key words of ``seed`` (``jax.random.PRNGKey(seed)``
    bitcast to int32, for 0 <= seed < 2**32)."""
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return 0, int(seed)


def select_kernel(model, language: str, lang: str):
    """The kernel path of a run and its provenance: ``(path,
    kernel_selection)`` for the settings' ``kernel_language`` string
    (``language``) resolved to ``lang`` (``"cuda"`` or ``"plain"``).

    The generator's gate (:func:`~.ops.kernelgen.generation_gate_reason`)
    decides, as in the reference (its ``simulation.py`` Pallas
    validation and Auto branch): a model it refuses raises under an
    explicit ``CUDA``/``Pallas``, and under ``Auto`` takes the plain
    path — on the run's device, the card included — with the reason
    recorded and printed once to stderr. ``Auto`` on a model it accepts
    records the generated kernel. Build and launch errors are not
    decided here: they raise where they happen."""
    if lang != "cuda":
        return lang, None
    reason = kernelgen.generation_gate_reason(model)
    auto = language.strip().lower() == "auto"
    if reason is None:
        if not auto:
            return "cuda", None
        return "cuda", {
            "reason": (f"generated CUDA kernel for model '{model.name}' "
                       f"(generator v{kernelgen.GENERATOR_VERSION})"),
            "kernel_gate": {"model": model.name, "generated": True,
                            "reason": None},
        }
    if not auto:
        raise SettingsError(
            f"kernel_language = {language!r} cannot be generated for "
            f"model {model.name!r}: {reason} (use 'Plain' or 'Auto')"
        )
    selection = {
        "reason": (f"no CUDA kernel can be generated for model "
                   f"'{model.name}' ({reason}); plain torch path"),
        "kernel_gate": {"model": model.name, "generated": False,
                        "reason": reason},
    }
    print(f"gray-scott-torch: {selection['reason']}", file=sys.stderr)
    return "plain", selection


class Simulation:
    """One registered model (Gray-Scott by default) on a mesh of
    blocks. ``devices`` is the explicit, possibly repeating, device list
    (one entry per block); ``n_devices`` and ``mesh_dims`` are as in the
    reference."""

    def __init__(self, settings: Settings, *,
                 n_devices: Optional[int] = None, seed: int = 0,
                 mesh_dims: Optional[Tuple[int, int, int]] = None,
                 devices: Optional[Sequence] = None):
        self.settings = settings
        config.check_ported(settings)
        self.model = config.resolve_model(settings)
        _, lang = config.load_backend_and_lang(settings)
        kind = config.resolve_device(settings).type
        self.dtype = config.resolve_precision(settings)
        #: The mixed-precision posture ("f32", "bf16_f32acc" or
        #: "equality"); under bf16_f32acc the fields are stored bf16 and
        #: the params (and the plain path's accumulation) stay float32.
        self.compute_precision = config.resolve_compute_precision(settings)
        self.compute_dtype = self.dtype
        if self.compute_precision == "bf16_f32acc":
            self.dtype = torch.bfloat16
        #: The lossy snapshot codec, resolved here so that a bad spec (an
        #: unknown field, equality with a codec) fails at construction.
        self.snapshot_codec = resolve_snapshot_codec(
            settings, self.model.field_names)
        #: The kernel path (``"cuda"`` or ``"plain"``) and, under
        #: ``Auto``, the decision's provenance (None for a language the
        #: user pinned), as the reference records it.
        self.kernel_language, self.kernel_selection = select_kernel(
            self.model, settings.kernel_language, lang)
        if isinstance(self.kernel_selection, dict):
            self.kernel_selection["compute_precision"] = (
                self.compute_precision)
            self.kernel_selection["snapshot_codec"] = (
                self.snapshot_codec.posture())
        devices = select_devices(kind, n_devices, devices)
        self.domain = CartDomain.create(len(devices), settings.L,
                                        dims=mesh_dims)
        self.mesh = DeviceMesh(self.domain.dims, devices)
        self.sharded = self.domain.n_blocks > 1
        self.device = devices[0]
        #: The generated kernel's spec; the plain path runs the model's
        #: declaration itself.
        self.spec = (kernelgen.get_spec(self.model)
                     if self.kernel_language == "cuda" else self.model)
        self.fuse = default_fuse(self.dtype, self.device,
                                 self.model.n_fields)
        self._params = {
            d: self.model.make_params(settings, self.compute_dtype, d)
            for d in dict.fromkeys(devices)
        }
        self.params = self._params[self.device]
        self.use_noise = settings.noise != 0.0
        self.base_key = base_key(seed)
        self.step = 0
        L = settings.L
        if self.sharded:
            block = self.domain.local_shape
            #: Global origin of each block's storage (rank order).
            self.offsets = [
                tuple(c * b for c, b in zip(self.domain.coords(r), block))
                for r in range(self.domain.n_blocks)
            ]
            self.blocks = [
                tuple(self.model.init(L, self.dtype, offsets=offs,
                                      sizes=block, device=dev))
                for offs, dev in zip(self.offsets, devices)
            ]
        else:
            self.offsets = [(0, 0, 0)]
            self.blocks = [
                tuple(self.model.init(L, self.dtype, device=self.device))
            ]

    @property
    def fields(self) -> Tuple[torch.Tensor, ...]:
        """The single block's field tensors (declaration order); a
        sharded run holds per-block tuples in :attr:`blocks`."""
        if self.sharded:
            raise ValueError(
                f"a sharded run ({self.domain.dims} mesh) holds its "
                "fields per block: use .blocks or get_fields()"
            )
        return self.blocks[0]

    @fields.setter
    def fields(self, value) -> None:
        if self.sharded:
            raise ValueError(
                "a sharded run holds its fields per block: use "
                "restore_fields() or carry.blocks_from_reference()"
            )
        self.blocks = [tuple(value)]

    def _seeds(self, step: int) -> Tuple[int, int, int]:
        return self.base_key[0], self.base_key[1], step

    def _params_of(self, rank: int):
        return self._params[self.mesh.devices[rank]]

    def iterate(self, nsteps: int = 1) -> None:
        """Advance ``nsteps`` steps; enqueues device work only."""
        if nsteps <= 0:
            return
        if self.sharded:
            self.blocks = self._sharded_run(self.blocks, nsteps)
        else:
            self.blocks = [self._block_run(self.blocks[0], nsteps)]
        self.step += nsteps

    def _block_run(self, fields, nsteps: int):
        """``nsteps`` steps of the whole grid as one block."""
        L = self.settings.L
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
        return tuple(fields)

    def _sharded_run(self, blocks, nsteps: int):
        """``nsteps`` steps over every block of the mesh: the reference's
        sharded ``_local_run`` branches, each round mapping the list of
        block field tuples to the next."""
        L = self.settings.L
        dims = self.domain.dims
        local = self.domain.local_shape
        bvs = self.model.boundaries
        mesh = self.mesh
        spec = self.spec
        step0 = self.step
        padded = self.domain.padded

        def pin_blocks(blocks):
            """Re-pin each block's pad cells (global coords >= L) to the
            boundary value after a round of a non-divisible grid: the
            chain's final stage writes them unpinned, and the next round
            reads them as the frozen ghost shell."""
            if not padded:
                return [tuple(f) for f in blocks]
            return [
                tuple(temporal.pin_out_of_domain(f, bv, offs, L)
                      for f, bv in zip(fields, bvs))
                for fields, offs in zip(blocks, self.offsets)
            ]

        def unit_noise(step_idx, origin, shape, device):
            return uniform_pm1_block(self.base_key, step_idx, origin, shape,
                                     L, self.dtype, device=device)

        def run_chain_rounds(chain, fuse, blocks):
            rounds, rem = divmod(nsteps, fuse)
            for i in range(rounds):
                blocks = chain(blocks, step0 + fuse * i, fuse)
            if rem:
                blocks = chain(blocks, step0 + fuse * rounds, rem)
            return blocks

        if self.kernel_language == "cuda":
            cap = cuda_stencil.chain_cap(self.dtype, spec.n_fields)
            # The z-band recompute of the xy-chain in the posture of what
            # runs the chain: on the card the kernel's (params and noise
            # unit at its compute dtype, one rounding per stage), on the
            # CPU the plain version's, so the bands equal its cells.
            band_params_of, band_unit_noise = self._params_of, unit_noise
            band_dtype = self.compute_dtype
            if self.device.type == "cuda":
                band_dtype = cuda_stencil.compute_dtype_of(self.dtype)

                def band_params_of(rank):
                    return cuda_stencil.widen_params(self._params_of(rank),
                                                      band_dtype)

                def band_unit_noise(step_idx, origin, shape, device):
                    return uniform_pm1_block(self.base_key, step_idx, origin,
                                             shape, L, band_dtype,
                                             device=device)

            def faces_round(blocks, step):
                faces = halo.exchange_faces(blocks, bvs, mesh)
                return pin_blocks([
                    cuda_stencil.fused_step(
                        fields, self._params_of(r), self._seeds(step),
                        faces[r], spec=spec, use_noise=self.use_noise,
                        fuse=1, offsets=self.offsets[r], row=L,
                    )
                    for r, fields in enumerate(blocks)
                ])

            if dims[1] == 1 and dims[2] == 1:
                # 1D x-sharded mesh: the only block boundaries are x
                # faces, so the kernel's chain runs across them from one
                # exchange of k-wide x slabs.
                fuse = min(self.fuse, max(nsteps, 1), local[0])
                fuse = self._cap_depth("x-chain", fuse, cap, local)

                def chain(blocks, step, depth):
                    if depth == 1:
                        return faces_round(blocks, step)
                    pairs = halo.exchange_x_slabs(blocks, bvs, mesh, depth)
                    return pin_blocks([
                        cuda_stencil.fused_step(
                            fields, self._params_of(r), self._seeds(step),
                            tuple(f for pr in pairs[r] for f in pr),
                            spec=spec, use_noise=self.use_noise,
                            fuse=depth, offsets=self.offsets[r], row=L,
                        )
                        for r, fields in enumerate(blocks)
                    ])

                return run_chain_rounds(chain, fuse, blocks)

            # xy-chain (+ z bands when z is sharded): the kernel's chain
            # crosses x and y block boundaries on a y-extended operand.
            caps = [local[0], local[1]]
            if dims[2] > 1:
                caps.append(local[2] // 2)  # z-band windows need nz >= 2k
            fuse = max(1, min(self.fuse, max(nsteps, 1), *caps))
            fuse = self._cap_depth("xy-chain", fuse, cap, local)

            def chain(blocks, step, depth):
                if depth == 1:
                    return faces_round(blocks, step)

                def chain_kernel(rank, fields_p, faces, stp, offs_p):
                    return cuda_stencil.fused_step(
                        fields_p, self._params_of(rank), self._seeds(stp),
                        faces, spec=spec, use_noise=self.use_noise,
                        fuse=depth, offsets=offs_p, row=L, y_halo=depth,
                    )

                return pin_blocks(temporal.xy_chain(
                    blocks, band_params_of, self.model, depth=depth,
                    step=step, offsets=self.offsets,
                    chain_kernel=chain_kernel, use_noise=self.use_noise,
                    unit_noise=band_unit_noise, row=L, mesh=mesh,
                    boundaries=bvs, compute_dtype=band_dtype,
                ))

            return run_chain_rounds(chain, fuse, blocks)

        # ---- plain path ----
        cdt = self.compute_dtype
        if nsteps < 2:
            pads = halo.halo_pad(blocks, bvs, mesh)
            out = []
            for r, fp in enumerate(pads):
                noise_term = 0.0
                if self.use_noise:
                    noise_term = stencil.scaled_noise(
                        self._params_of(r).noise,
                        unit_noise(step0, self.offsets[r], local,
                                   fp[0].device))
                out.append(stencil.reaction_update(
                    fp, noise_term, self._params_of(r), self.model, cdt))
            return pin_blocks(out)

        # One width-k exchange feeds k steps: each stage recomputes on a
        # window one cell narrower per side, neighbour-owned ring cells
        # reproducing the owner's values bitwise.
        fuse = min(self.fuse, nsteps, min(local))

        def chain(blocks, step, depth):
            frames = halo.halo_pad_wide(blocks, bvs, mesh, depth)
            return [
                temporal.window_chain(
                    fw, self._params_of(r), self.model, depth=depth,
                    step=step,
                    origin=tuple(o - depth for o in self.offsets[r]),
                    row=L, use_noise=self.use_noise, unit_noise=unit_noise,
                    boundaries=bvs, final_pin=padded, compute_dtype=cdt,
                )
                for r, fw in enumerate(frames)
            ]

        return run_chain_rounds(chain, fuse, blocks)

    def _cap_depth(self, path: str, fuse: int, cap: int, local) -> int:
        """The chain depth within the shared-memory ledger's cap, with
        the reference's step-down warning when the request is deeper."""
        if fuse <= cap:
            return fuse
        capped = max(cap, 1)
        warnings.warn(
            f"{path} depth capped at {capped} (fuse={fuse} does not fit "
            f"shared memory for local grid {tuple(local)}, {self.dtype})",
            RuntimeWarning, stacklevel=3,
        )
        return capped

    def get_fields(self) -> Tuple[np.ndarray, ...]:
        """Host copies of the model's fields (declaration order), the
        blocks assembled and clipped to the true ``L^3`` domain; bfloat16
        fields come back as float32 arrays holding their values (numpy
        has no bfloat16)."""
        if not self.sharded:
            return tuple(_host(f) for f in self.blocks[0])
        L = self.settings.L
        storage = self.domain.storage_shape
        out = [np.empty(storage, dtype=_host_dtype(self.dtype))
               for _ in self.blocks[0]]
        for offs, fields in zip(self.offsets, self.blocks):
            for o, f in zip(out, fields):
                o[tuple(slice(s, s + n) for s, n in zip(offs, f.shape))] = (
                    _host(f))
        return tuple(o[:L, :L, :L] for o in out)

    def snapshot(self, encode=None, exact: bool = True,
                 health: bool = False) -> BoundaryBlocks:
        """Host blocks ``[(offsets, sizes, *fields)]`` for the output and
        checkpoint stores: one per block, each clipped to the true
        domain (a non-divisible L stores pad cells past L); bfloat16
        fields as float32 arrays holding their values.

        ``health`` reduces the health probe on the device first
        (``resilience/health.device_probe``: every field finite, each
        field's min and max over each block's storage), copied back
        with the fields under the boundary's one synchronisation, and
        puts the :class:`~.resilience.health.HealthReport` on the
        result's ``health``.

        ``encode`` (``{field index: bits}``, the lossy snapshot codec)
        quantizes those fields on the device, with the global range over
        every block's storage (:func:`~.io.codec.device_quantize`), and
        puts the codec form on the result's ``encoded`` (coded fields as
        :class:`~.io.codec.EncodedField`); ``exact=False`` skips the
        exact copies (a boundary whose targets all take the codec
        form)."""
        if not exact and not encode:
            raise ValueError("snapshot(exact=False) needs an encode spec")
        probes = None
        if health:
            # Enqueued before the copies below, whose first wait covers
            # it: the probe adds no synchronisation of its own.
            probes = [device_probe(*fields).to("cpu", non_blocking=True)
                      for fields in self.blocks]
        clips = [(offs, true, tuple(slice(0, t) for t in true))
                 for offs, true in self.block_boxes()]
        out = BoundaryBlocks(
            [(offs, true) + tuple(_host(f)[sl] for f in fields)
             for (offs, true, sl), fields in zip(clips, self.blocks)]
            if exact else [])
        if encode:
            coded = {}
            for i, bits in encode.items():
                qs, lo, hi = device_quantize([b[i] for b in self.blocks],
                                             bits)
                coded[i] = (bits, qs, lo, hi)
            enc = []
            for r, ((offs, true, sl), fields) in enumerate(
                    zip(clips, self.blocks)):
                entries = []
                for i, f in enumerate(fields):
                    if i not in coded:
                        entries.append(_host(f)[sl])
                        continue
                    bits, qs, lo, hi = coded[i]
                    q = qs[r].cpu().numpy()
                    if bits > 8:
                        q = q.view(np.uint16)
                    entries.append(EncodedField(q[sl], lo, hi, bits,
                                                self.dtype))
                enc.append((offs, true) + tuple(entries))
            out.encoded = enc
        if probes is not None:
            for d in dict.fromkeys(self.mesh.devices):
                if d.type == "cuda":
                    torch.cuda.current_stream(d).synchronize()
            out.health = report_of(probes, self.model.field_names)
        return out

    def block_boxes(self) -> List[Tuple[tuple, tuple]]:
        """Each block's ``(offsets, sizes)`` in the true ``L^3`` domain
        (a non-divisible L's pad cells cut off), in rank order: the boxes
        the stores record."""
        L = self.settings.L
        return [(offs, tuple(min(L - o, s)
                             for o, s in zip(offs, fields[0].shape)))
                for offs, fields in zip(self.offsets, self.blocks)]

    def restore_fields(self, fields, step: int) -> None:
        """Load host field arrays (declaration order, ``L^3`` each) at
        ``step``, scattered into the blocks."""
        fields = tuple(np.asarray(f) for f in fields)
        if len(fields) != self.model.n_fields:
            raise ValueError(
                f"Checkpoint has {len(fields)} fields; model "
                f"{self.model.name!r} declares {self.model.n_fields}"
            )
        expected = (self.settings.L,) * 3
        for name, f in zip(self.model.field_names, fields):
            if f.shape != expected:
                raise ValueError(
                    f"Checkpoint shape {name}={f.shape} does not match "
                    f"L={self.settings.L}"
                )
        self.blocks = self.scatter(fields)
        self.step = int(step)

    def scatter(self, fields) -> List[tuple]:
        """Per-block tensors (this run's dtype, on each block's device)
        of global host arrays, ``L^3`` or the padded storage shape; the
        pad cells of an ``L^3`` array are rebuilt at the boundary
        value."""
        storage = self.domain.storage_shape
        arrays = []
        for f, bv in zip(fields, self.model.boundaries):
            f = np.asarray(f)
            if f.shape != storage:
                f = np.pad(f, [(0, g - n) for g, n in zip(storage, f.shape)],
                           constant_values=bv)
            arrays.append(f)
        block = self.domain.local_shape
        return [
            tuple(
                torch.tensor(
                    a[tuple(slice(o, o + b) for o, b in zip(offs, block))],
                    dtype=self.dtype, device=dev,
                )
                for a in arrays
            )
            for offs, dev in zip(self.offsets, self.mesh.devices)
        ]

    def block_until_ready(self) -> None:
        for d in dict.fromkeys(self.mesh.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)


def _host_dtype(dtype):
    """The numpy dtype of a field's host copy: float32 for bfloat16."""
    return np.float32 if dtype == torch.bfloat16 else (
        torch.empty((), dtype=dtype).numpy().dtype)


def _host(t: torch.Tensor) -> np.ndarray:
    """A field tensor as a host array (bfloat16 widened exactly to
    float32 after the copy, so only two bytes a cell cross to the
    host)."""
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def initialization(args, *, n_devices: Optional[int] = None, seed: int = 0):
    """Parse the config and build the simulation:
    ``(settings, domain, sim)``."""
    settings = config.get_settings(list(args))
    sim = Simulation(settings, n_devices=n_devices, seed=seed)
    return settings, sim.domain, sim
