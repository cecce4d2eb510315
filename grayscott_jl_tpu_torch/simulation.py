"""Public simulation API: settings -> model -> devices -> blocks -> step
loop (counterpart of ``grayscott_jl_tpu/simulation.py``).

* :func:`initialization` parses the config and builds a ready
  :class:`Simulation`.
* :func:`select_kernel` applies the kernel generator's gate at
  construction: every model it accepts runs its generated CUDA kernel;
  one it refuses raises under ``CUDA``/``Pallas`` and runs the plain
  path under ``Auto``, the decision recorded in ``kernel_selection``.
  ``Auto`` then decides as the reference's does
  (:meth:`Simulation._resolve_auto`): the fabric model
  (``parallel/icimodel.py``) picks the schedule, and the mesh, depth
  and (under ``comm_overlap = "auto"``) split or fused round where they
  are not pinned; the measured autotuner (``tune/``) may
  replace the pick with a cached or measured winner. Off the card Auto
  runs the plain path.
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
  and window chain. Under ``comm_overlap`` (on for every sharded run by
  default, as in the reference, unless Auto's pick turns it off) a round of depth k >= 2 runs
  split-phase: the exchange starts on a side stream, the interior runs
  on frozen boundary values, and the k-thick boundary bands are
  recomputed from what arrived — by the x-chain kernel on the kernel
  path — bitwise equal to the fused round. ``halo_depth`` (the s-step
  schedule) multiplies the depth a round exchanges for. It never waits
  for the device.
* :meth:`Simulation.get_fields` / :meth:`Simulation.snapshot` copy the
  fields to the host (bfloat16 fields as float32 arrays holding the bf16
  values; the snapshot quantizes coded fields on the device first);
  :meth:`Simulation.snapshot_async` starts those copies on a copy stream
  (into a :class:`HostRing` of pinned buffers) and returns a
  :class:`FieldSnapshot` that a writer thread resolves, with the health
  probe and the integrity checksum reduced on the device beside them;
  :meth:`Simulation.restore_fields` loads them back.
* Precision: ``precision`` gives the storage dtype; under
  ``compute_precision = "bf16_f32acc"`` a Float32 run stores bfloat16
  and accumulates in float32 (``compute_dtype``). The params live at the
  compute dtype. The kernel computes bfloat16 fields in float32 either
  way; the plain path computes in the params' dtype, as the reference's
  XLA path does.

The construction and runner seams (``_make_domain``, ``_build_mesh``,
``_make_params``, ``_resolve_use_noise``, ``_make_base_key``,
``_init_fields``, ``_tune_extras``, ``_apply_tune_extras``,
``_run_blocks`` and the snapshot's probe hooks) are the reference's: the
ensemble engine (``ensemble/engine.EnsembleSimulation``) overrides them
to thread a leading member axis through the same step loop, whose
kernel calls take the member-stacked blocks unchanged.

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
from .io import native
from .io.bplite import bf16_widen
from .io.codec import (BoundaryBlocks, EncodedField, device_quantize,
                       resolve_snapshot_codec)
from .models import SettingsError
from .obs import numerics as obs_numerics
from .obs.trace import HotRange, hot_armed
from .ops import _build, cuda_stencil, kernelgen, stencil
from .ops.noise import uniform_pm1_block
from .parallel import distributed, halo, temporal
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
    recorded (and printed by the Auto decision,
    ``Simulation._resolve_auto``). ``Auto`` on a model it accepts
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
    return "plain", {
        "reason": (f"no CUDA kernel can be generated for model "
                   f"'{model.name}' ({reason}); plain torch path"),
        "kernel_gate": {"model": model.name, "generated": False,
                        "reason": reason},
    }


class HostRing:
    """Host buffers for boundary snapshots, reused across boundaries:
    ``slots`` sets, each with one buffer per (block, field) — pinned
    for a card's tensors, so that its copies run asynchronously —
    allocated at first use. Each snapshot takes the next set round
    robin. The output pipeline keeps at most ``slots`` snapshots
    unwritten (``AsyncStepWriter.reserve``), so a set has been written
    before it is reused."""

    def __init__(self, slots: int):
        if slots < 1:
            raise ValueError(f"a HostRing needs at least one slot, got {slots}")
        self.slots = int(slots)
        self._next = 0
        self._bufs = {}

    def take(self) -> int:
        """The set the next snapshot uses."""
        slot = self._next
        self._next = (slot + 1) % self.slots
        return slot

    def buffer(self, slot: int, key, like: torch.Tensor) -> torch.Tensor:
        """Set ``slot``'s buffer ``key``, shaped and typed as ``like``."""
        buf = self._bufs.get((slot, key))
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = self._bufs[slot, key] = torch.empty(
                like.shape, dtype=like.dtype, pin_memory=like.is_cuda)
        return buf

    @property
    def nbytes(self) -> int:
        """Host bytes the ring holds."""
        return sum(b.numel() * b.element_size() for b in self._bufs.values())


class FieldSnapshot:
    """One boundary's capture, its device-to-host copies in flight
    (:meth:`Simulation.snapshot_async`).

    :meth:`health_report` and :meth:`checksum_report` wait only for the
    probes' scalars; :meth:`blocks` waits on the copies' own events
    (never a device-wide synchronise, so that it may run on a writer
    thread while the next chunk computes), checks the landed bytes
    against the device checksum when one was taken, and returns the
    host blocks. The snapshot holds its sources until its copies are
    done (``record_stream``), so later steps may drop them."""

    def __init__(self, step: int, parts, field_names, *, events=(),
                 probe_events=(), small=(), health: bool = False,
                 checksum: bool = False, numerics: bool = False,
                 enc_parts=None, enc_meta=None, reduce_probe=None,
                 gather=None):
        #: Simulation step the snapshot was taken at.
        self.step = step
        self.field_names = tuple(field_names)
        self._parts = parts  # [(offsets, true_sizes, *host buffers)]
        self._enc_parts = enc_parts
        self._enc_meta = enc_meta or {}
        self._events = list(events)
        self._probe_events = list(probe_events)
        self._small = list(small)
        self._small_host = None
        self._health = health
        self._checksum = checksum
        self._numerics = numerics
        self._reduce_probe = reduce_probe
        self._gather = gather
        self._report = None
        self._numerics_report = None
        self._blocks = None

    def _scalars(self):
        if self._small_host is None:
            for ev in self._probe_events:
                ev.synchronize()
            self._small_host = [t.numpy() for t in self._small]
        return self._small_host

    def health_report(self):
        """The boundary's :class:`~.resilience.health.HealthReport`, or
        None when no probe was taken. In a run of several processes it
        is the report over every process's blocks (one collective, made
        once), so that every process reads the same verdict."""
        if not self._health:
            return None
        if self._report is None:
            self._report = report_of(self._scalars(), self.field_names,
                                     reduce=self._reduce_probe)
        return self._report

    def numerics_report(self):
        """The boundary's :class:`~.obs.numerics.NumericsReport`, or None
        when no numerics probe was taken; waits only for the probes'
        scalars. In a run of several processes it is the report over
        every process's blocks (one collective, made once), the global
        report the reference's reduction gives."""
        if not self._numerics:
            return None
        if self._numerics_report is None:
            n = len(self.field_names)
            off = (1 + 2 * n if self._health else 0) + (
                n if self._checksum else 0)
            width = len(obs_numerics.PARTIALS) * n
            self._numerics_report = _numerics_of(
                [s[off:off + width] for s in self._scalars()],
                self.field_names, self._gather)
        return self._numerics_report

    def has_checksums(self) -> bool:
        return self._checksum

    def checksum_report(self):
        """The device checksums ``{field: int}`` (the blocks' sums added
        mod 2^32), or None when none was taken."""
        if not self._checksum:
            return None
        off = 1 + 2 * len(self.field_names) if self._health else 0
        totals = [0] * len(self.field_names)
        for s in self._scalars():
            for i in range(len(totals)):
                totals[i] = (totals[i] + int(s[off + i])) % (1 << 32)
        return dict(zip(self.field_names, totals))

    def _verify(self, hosts) -> None:
        """The landed bytes against the device checksums: a mismatch is
        data that changed between the card and here, and raises
        :class:`~.io.bplite.CorruptionError` before any store sees it."""
        from .resilience.integrity import CorruptionError, host_field_checksum

        want = self.checksum_report()
        for i, name in enumerate(self.field_names):
            got = 0
            for part in hosts:
                got = (got + host_field_checksum(part[2 + i])) % (1 << 32)
            if got != want[name]:
                raise CorruptionError(
                    f"device-side field checksum mismatch: device "
                    f"{want[name]:#010x}, host {got:#010x} — snapshot bytes "
                    "were silently corrupted in flight",
                    step=self.step, var=name)

    def blocks(self) -> BoundaryBlocks:
        """Host blocks ``[(offsets, sizes, *fields)]``, each clipped to
        the true domain, bfloat16 fields as float32 arrays holding their
        values; the codec form on ``encoded``. Resolved once."""
        if self._blocks is not None:
            return self._blocks
        for ev in self._events:
            ev.synchronize()
        out = BoundaryBlocks()
        if self._parts is not None:
            # The words as they landed, before any widening: what the
            # device checksum summed.
            hosts = [(offs, true) + tuple(_landed(b) for b in bufs)
                     for offs, true, *bufs in self._parts]
            if self._checksum:
                self._verify(hosts)
            for (offs, true, *arrs), (_, _, *bufs) in zip(hosts, self._parts):
                sl = tuple(slice(0, t) for t in true)
                out.append((offs, true) + tuple(
                    _widened(a, b)[sl] for a, b in zip(arrs, bufs)))
        if self._enc_parts is not None:
            enc = []
            for offs, true, *bufs in self._enc_parts:
                sl = tuple(slice(0, t) for t in true)
                entries = []
                for i, b in enumerate(bufs):
                    meta = self._enc_meta.get(i)
                    if meta is None:
                        entries.append(_widened(_landed(b), b)[sl])
                        continue
                    bits, lo, hi, dtype = meta
                    q = b.numpy()
                    if bits > 8:
                        q = q.view(np.uint16)
                    entries.append(EncodedField(q[sl], lo, hi, bits, dtype))
                enc.append((offs, true) + tuple(entries))
            out.encoded = enc
        self._blocks = out
        return out


class Simulation:
    """One registered model (Gray-Scott by default) on a mesh of
    blocks. ``devices`` is the explicit, possibly repeating, device list
    (one entry per block); ``n_devices`` and ``mesh_dims`` are as in the
    reference.

    When the launch variables ask for several processes
    (``parallel/distributed.py``), the group is started here if it is
    not yet, and this process builds, steps and snapshots only its own
    blocks: ``n_devices`` (or ``devices``) is then this process's share,
    by default one block per owned card (one on the CPU), and the mesh
    spans every process's share."""

    #: The snapshot container: the ensemble engine's resolves its probes
    #: per member.
    snapshot_cls = FieldSnapshot
    #: True on :class:`~.ensemble.engine.EnsembleSimulation`, whose blocks
    #: carry a leading member axis.
    is_ensemble = False

    def __init__(self, settings: Settings, *,
                 n_devices: Optional[int] = None, seed: int = 0,
                 mesh_dims: Optional[Tuple[int, int, int]] = None,
                 devices: Optional[Sequence] = None):
        self.settings = settings
        config.check_ported(settings)
        self.model = config.resolve_model(settings)
        _, lang = config.load_backend_and_lang(settings)
        kind = config.resolve_device(settings).type
        #: The compile cache (``compile_cache`` / ``GS_COMPILE_CACHE``):
        #: the directory the kernels and the native store engine are
        #: built into and loaded from, or None for the package's own. On
        #: the CPU no kernel is built, so a cache that was asked for is
        #: dropped with a warning, as the reference drops its CPU cache,
        #: unless ``GS_COMPILE_CACHE_FORCE=1``.
        self.compile_cache_dir = config.resolve_compile_cache(settings)
        if (self.compile_cache_dir and kind == "cpu"
                and env_str("GS_COMPILE_CACHE_FORCE", "") != "1"):
            if env_str("GS_COMPILE_CACHE", "") or settings.compile_cache:
                print("gray-scott-torch: warning: compile cache not used on "
                      "the CPU backend (no kernel is built for it; set "
                      "GS_COMPILE_CACHE_FORCE=1 to override)",
                      file=sys.stderr)
            self.compile_cache_dir = None
        _build.use_cache_dir(self.compile_cache_dir)
        native.use_cache_dir(self.compile_cache_dir)
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
        if distributed.ensure_started(kind) is not None and devices is None:
            devices = distributed.process_devices(kind, n_devices)
        else:
            devices = select_devices(kind, n_devices, devices)
        #: Processes of the run (``parallel/distributed.py``).
        self.processes = distributed.process_count()
        n_global, first = distributed.block_layout(len(devices))
        self.domain = self._make_domain(n_global, mesh_dims)
        self.mesh = self._build_mesh(devices, first)
        self.sharded = self.domain.n_blocks > 1
        self.device = devices[0]
        self.fuse = default_fuse(self.dtype, self.device,
                                 self.model.n_fields)
        #: The split-phase exchange (``comm_overlap`` /
        #: ``GS_COMM_OVERLAP``): ``"auto"`` is on for every sharded run,
        #: as in the reference. The values are bitwise the same either
        #: way; the round only stops the interior's kernels from waiting
        #: on the exchange.
        self.comm_overlap = (self.sharded and
                             config.resolve_comm_overlap(settings) != "off")
        #: True once a round ran split-phase (a geometry without an
        #: interior to hide the exchange behind takes the fused round
        #: even with overlap on).
        self.overlap_applied = False
        #: The s-step exchange depth (``halo_depth`` / ``GS_HALO_DEPTH``):
        #: one exchange round feeds ``fuse * halo_depth`` steps, the same
        #: program as a chain of that depth. 1 is the one-exchange-per-
        #: chain schedule; unpinned, the autotuner may adopt a deeper one.
        halo_pinned, self.halo_depth = config.resolve_halo_depth(settings)
        #: Build and launch analytics (``obs/xstats.py``): armed by
        #: ``GS_XSTATS`` / ``xstats``, or whenever the compile cache is,
        #: as in the reference. Each library the run builds or loads
        #: (here, before the tuner's launches) and, at the run's end,
        #: each kernel entry it launched appends its record.
        self.xstats_enabled = (config.resolve_xstats(settings)
                               or bool(self.compile_cache_dir))
        self.executables: list = []
        if self.xstats_enabled:
            from .obs import xstats

            xstats.capture_libraries(self)
        if settings.kernel_language.strip().lower() == "auto":
            self._resolve_auto(settings, kind, seed, halo_pinned,
                               mesh_forced=(mesh_dims is not None or bool(
                                   env_str("GS_TPU_MESH_DIMS", ""))),
                               n_global=n_global, first=first)
        if isinstance(self.kernel_selection, dict):
            self.kernel_selection["compute_precision"] = (
                self.compute_precision)
            self.kernel_selection["snapshot_codec"] = (
                self.snapshot_codec.posture())
            if self.kernel_language == "cuda":
                self.kernel_selection["generated"] = True
                self.kernel_selection["generator_version"] = (
                    kernelgen.GENERATOR_VERSION)
        #: The generated kernel's spec; the plain path runs the model's
        #: declaration itself.
        self.spec = (kernelgen.get_spec(self.model)
                     if self.kernel_language == "cuda" else self.model)
        #: Set when a requested ``halo_depth`` stepped down because the
        #: chain at ``fuse * halo_depth`` does not fit the block or the
        #: shared-memory ledger (the ledger's numbers ride along).
        self.halo_depth_gate = None
        if self.sharded and self.halo_depth > 1:
            self._gate_halo_depth()
        self._params = {d: self._make_params(d)
                        for d in dict.fromkeys(devices)}
        self.params = self._params[self.device]
        self.use_noise = self._resolve_use_noise()
        #: Per card, the stream the snapshots' copies run on.
        self._copy_streams = {}
        #: The run's noise seed (an ensemble's members draw from
        #: ``seed + k`` unless pinned).
        self.seed = int(seed)
        self.base_key = self._make_base_key(seed)
        self.step = 0
        #: The layout change this run adopted (a restore onto another
        #: mesh, or a live move): the plan's record with its ``path``,
        #: ``bytes`` and ``wall_s`` (``reshard/restore.py``); None when
        #: the run did not move.
        self.reshard = None
        #: Exchange rounds the sharded run has made (one per chain
        #: round: ``halo_depth = k`` divides them by k).
        self.exchange_rounds = 0
        if self.sharded:
            block = self.domain.local_shape
            first = self.mesh.first_rank
            #: Global origin of each of this process's blocks' storage
            #: (rank order).
            self.offsets = [
                tuple(c * b for c, b in zip(self.domain.coords(r), block))
                for r in range(first, first + self.mesh.spatial_share)
            ]
        else:
            self.offsets = [(0, 0, 0)]
        self.blocks = self._init_fields()

    # ------------------------------------------------ construction hooks
    # Overridden by ensemble/engine.EnsembleSimulation, which threads a
    # leading member axis through each while the step loop, the halo
    # exchange, the tuner and the output pipeline stay shared.

    def _make_domain(self, n_global: int, dims=None) -> CartDomain:
        """The spatial decomposition of ``n_global`` blocks."""
        return CartDomain.create(n_global, self.settings.L, dims=dims)

    def _build_mesh(self, devices, first: int = 0) -> DeviceMesh:
        """The mesh of this process's blocks on ``devices``."""
        return DeviceMesh(self.domain.dims, devices, first_rank=first,
                          processes=self.processes)

    def _make_params(self, device):
        """The model's params on ``device``, at the compute dtype."""
        return self.model.make_params(self.settings, self.compute_dtype,
                                      device)

    def _resolve_use_noise(self) -> bool:
        return self.settings.noise != 0.0

    def _make_base_key(self, seed: int):
        return base_key(seed)

    def _init_fields(self) -> List[tuple]:
        """Every block's initial field tuple (rank order)."""
        L = self.settings.L
        if not self.sharded:
            return [tuple(self.model.init(L, self.dtype, device=self.device))]
        block = self.domain.local_shape
        return [
            tuple(self.model.init(L, self.dtype, offsets=offs, sizes=block,
                                  device=dev))
            for offs, dev in zip(self.offsets, self.mesh.devices)
        ]

    def _tune_extras(self) -> dict:
        """Extra arguments of ``tune.autotune`` (the ensemble size)."""
        return {}

    def _apply_tune_extras(self, decision) -> None:
        """Apply a decision's fields beyond kernel, depth and schedule."""

    def _resolve_auto(self, settings, platform: str, seed: int,
                      halo_pinned: bool, *, mesh_forced: bool,
                      n_global: int, first: int) -> None:
        """``kernel_language = "Auto"``, as the reference decides it.

        After the generator's gate (:func:`select_kernel`), the fabric
        model (``parallel/icimodel.select_kernel``) projects the schedules
        for this run's mesh, L, dtype, card and placement. Sharded, the
        picked row's mesh is adopted when neither ``mesh_dims`` nor
        ``GS_TPU_MESH_DIMS`` pins it (``kernel_selection["adopted_mesh"]``),
        its depth unless ``GS_FUSE`` is set, and under ``comm_overlap =
        "auto"`` its split or fused round. Then the measured
        autotuner (``tune/``) is consulted on the adopted mesh, and a
        cached or measured winner's kernel, depth (unless ``GS_FUSE``),
        ``comm_overlap`` (only under ``"auto"``), ``halo_depth`` (only
        unpinned) and precision (only under ``bf16_f32acc``) are applied.
        The decision is printed once, on process 0."""
        from . import tune
        from .parallel import icimodel

        model = self.model
        kind = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "")
        placement = icimodel.placement_of(self.mesh.devices, self.processes,
                                          distributed.backend())
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        fuse_pinned = bool(env_str("GS_FUSE", ""))
        overlap_mode = config.resolve_comm_overlap(settings)
        refused = self.kernel_language == "plain"
        if not refused:
            gate = (self.kernel_selection or {}).get("kernel_gate")
            self.kernel_language, self.kernel_selection = (
                icimodel.select_kernel(
                    self.domain.dims, settings.L, platform=platform,
                    device_kind=kind, placement=placement,
                    blocks=self.mesh.n_blocks, itemsize=itemsize,
                    fuse=(self.fuse if fuse_pinned else
                          cuda_stencil.chain_cap(self.dtype, model.n_fields)),
                    n_fields=model.n_fields,
                    sweep_mesh=self.sharded and not mesh_forced,
                    # The pick must price the exchange this run exposes;
                    # under "auto" it also decides the split round.
                    overlap="auto" if self.comm_overlap else 0.0,
                    overlap_auto=self.sharded and overlap_mode == "auto",
                ))
            if gate is not None:
                self.kernel_selection["kernel_gate"] = gate
        sel = self.kernel_selection
        if self.sharded and "pick" in sel:
            row = sel["rows"][sel["pick"]]
            picked = tuple(int(x) for x in row["mesh"].split(","))
            if not mesh_forced and picked != self.domain.dims:
                self.domain = self._make_domain(n_global, picked)
                self.mesh = self._build_mesh(self.mesh.devices, first)
                sel["adopted_mesh"] = list(picked)
            if not fuse_pinned:
                self.fuse = int(row["fuse"])
            if "comm_overlap" in row:
                self.comm_overlap = bool(row["comm_overlap"])
        fab = icimodel.fabric_for(kind, placement)
        decision = tune.autotune(
            settings, dims=self.domain.dims, L=settings.L, platform=platform,
            device_kind=kind, dtype=str(self.dtype).replace("torch.", ""),
            noise=float(settings.noise), itemsize=itemsize,
            devices=self.mesh.devices, seed=seed,
            analytic_kernel=self.kernel_language,
            analytic_fuse=max(1, int(self.fuse)),
            comm_overlap=self.comm_overlap,
            overlap_toggle=self.sharded and overlap_mode == "auto",
            link_gbps=fab.link_gbps, links=fab.links, hop_us=fab.hop_us,
            placement=placement, model=model.name, n_fields=model.n_fields,
            kernel_allowed=not refused,
            halo_depth=self.halo_depth if halo_pinned else 0,
            procs=self.processes, compute_precision=self.compute_precision,
            snapshot_codec=self.snapshot_codec.posture(),
            kernel_generator=0 if refused else kernelgen.GENERATOR_VERSION,
            **self._tune_extras(),
        )
        sel["autotune"] = decision.provenance
        if decision.provenance.get("source") in ("cache", "measured"):
            self.kernel_language = decision.kernel
            if decision.fuse is not None and not fuse_pinned:
                self.fuse = decision.fuse
            if (decision.comm_overlap is not None and self.sharded
                    and overlap_mode == "auto"):
                self.comm_overlap = decision.comm_overlap
            if decision.halo_depth is not None and not halo_pinned:
                self.halo_depth = max(1, int(decision.halo_depth))
            if (decision.compute_precision in config.COMPUTE_PRECISIONS
                    and self.compute_precision == "bf16_f32acc"):
                # The posture may keep bf16 or fall back to float32 for
                # this config; the fields are built after this.
                self.compute_precision = decision.compute_precision
                self.dtype = (torch.bfloat16
                              if self.compute_precision == "bf16_f32acc"
                              else self.compute_dtype)
            self._apply_tune_extras(decision)
        if distributed.process_index() == 0:
            prov = decision.provenance
            print(f"gray-scott-torch: kernel_language=Auto resolved to "
                  f"{self.kernel_language!r} ({sel.get('reason', '')}; "
                  f"autotune {prov['mode']}, "
                  f"{prov.get('source', 'analytic')} pick)",
                  file=sys.stderr)

    def _gate_halo_depth(self) -> None:
        """Judge ``halo_depth`` against the mesh's blocks at
        construction, as the reference does. The kernel path's chain at
        depth ``fuse * k`` must fit the chain's geometry and the
        shared-memory ledger (``cuda_stencil.max_feasible_chain_depth``):
        an infeasible k steps down to the deepest feasible one, with a
        warning on stderr and the numbers in :attr:`halo_depth_gate`.
        The plain path exchanges one ``fuse * k``-deep frame of owned
        cells, so a k the blocks cannot serve raises."""
        local = tuple(int(x) for x in self.domain.local_shape)
        dims = self.domain.dims
        k = self.halo_depth
        if self.kernel_language != "cuda":
            d = max(1, min(self.fuse, min(local)))
            if d * k > min(local):
                raise SettingsError(
                    f"halo_depth={k} needs a {d * k}-deep ghost exchange "
                    f"(chain depth {d} x halo_depth), but the local block "
                    f"{self.domain.local_shape} supports at most "
                    f"{min(local)}; lower halo_depth/GS_FUSE or use fewer "
                    "devices per axis"
                )
            return
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        mid = 2 if cuda_stencil.mid_bf16_requested(self.dtype) else None
        nf = self.model.n_fields
        path = "x-chain" if dims[1] == 1 and dims[2] == 1 else "xy-chain"

        def cap(depth):
            return cuda_stencil.max_feasible_chain_depth(
                local, dims, itemsize, depth, nf, mid)

        d = max(1, cap(self.fuse))
        applied = next((j for j in range(k, 0, -1) if cap(d * j) == d * j),
                       1)
        if applied == k:
            return
        smem = cuda_stencil.smem_bytes(itemsize, d * k, nf,
                                       mid_itemsize=mid)
        limit = cuda_stencil.SMEM_LIMIT
        self.halo_depth_gate = {
            "requested": k,
            "applied": applied,
            "kind": "geometry-infeasible",
            "reason": (
                f"halo_depth={k} needs a {d * k}-deep chain (fuse base {d} "
                f"x halo_depth) on the CUDA {path}, but local block "
                f"{local} ({itemsize}-byte fields x {nf}) serves at most "
                f"depth {d * applied} under the chain geometry caps and "
                f"the shared-memory ledger ({smem} bytes at depth "
                f"{d * k}, limit {limit}); running halo_depth={applied}"
            ),
            "geometry": {
                "path": path,
                "local_shape": list(local),
                "fuse_base": d,
                "requested_depth": d * k,
                "feasible_depth": d * applied,
                "smem_bytes_requested": smem,
                "smem_limit_bytes": limit,
                "itemsize": itemsize,
                "n_fields": nf,
            },
        }
        if isinstance(self.kernel_selection, dict):
            self.kernel_selection["halo_depth_gate"] = self.halo_depth_gate
        print("gray-scott-torch: warning: " + self.halo_depth_gate["reason"],
              file=sys.stderr)
        self.halo_depth = applied

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
        self.blocks = self._run_blocks(self.blocks, nsteps)
        self.step += nsteps

    def _run_blocks(self, blocks, nsteps: int) -> List[tuple]:
        """``nsteps`` steps of every block from ``blocks`` (the live run
        and the SDC replay both go through here)."""
        if self.sharded:
            return self._sharded_run(blocks, nsteps)
        return [self._block_run(blocks[0], nsteps)]

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
        block field tuples to the next. While ``obs/trace.hot_armed``,
        each halo exchange this makes (its start and its finish in a
        split-phase round; the xy-chain's are ``temporal.xy_chain``'s) is
        a ``gs_exchange`` range, added to ``cuda_stencil.EXCHANGE_NS``."""
        L = self.settings.L
        dims = self.domain.dims
        local = self.domain.local_shape
        bvs = self.model.boundaries
        mesh = self.mesh
        spec = self.spec
        step0 = self.step
        padded = self.domain.padded
        armed = hot_armed()

        def exchanged(fn, *args, **kw):
            if not armed:
                return fn(*args, **kw)
            with HotRange("gs_exchange") as rng:
                out = fn(*args, **kw)
            cuda_stencil.add_host_ns(exchange=rng.ns)
            return out

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
            self.exchange_rounds += rounds + bool(rem)
            return blocks

        def deepen(fuse, *caps):
            """The s-step schedule: ``halo_depth`` times the chain depth
            per exchange round, within the same caps (the same program
            as a chain of that depth)."""
            if self.halo_depth > 1:
                fuse = max(1, min(fuse * self.halo_depth, max(nsteps, 1),
                                  *caps))
            return fuse

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
                faces = exchanged(halo.exchange_faces, blocks, bvs, mesh)
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
                fuse = deepen(fuse, local[0])
                fuse = self._cap_depth("x-chain", fuse, cap, local)

                def chain(blocks, step, depth):
                    if depth == 1:
                        return faces_round(blocks, step)
                    if self.comm_overlap and local[0] >= 2 * depth:
                        return xchain_split(blocks, step, depth)
                    pairs = exchanged(halo.exchange_x_slabs, blocks, bvs,
                                      mesh, depth)
                    return pin_blocks([
                        cuda_stencil.fused_step(
                            fields, self._params_of(r), self._seeds(step),
                            tuple(f for pr in pairs[r] for f in pr),
                            spec=spec, use_noise=self.use_noise,
                            fuse=depth, offsets=self.offsets[r], row=L,
                        )
                        for r, fields in enumerate(blocks)
                    ])

                def xchain_split(blocks, step, k):
                    """The split-phase round: the k-wide x slabs start
                    on their way, each block's chain runs on frozen
                    faces, then its two k-plane bands are recomputed by
                    the x-chain kernel from the arrived slab and the
                    adjacent owned planes, and written over the
                    interior's."""
                    self.overlap_applied = True
                    pending = exchanged(
                        halo.start_exchange, blocks, bvs, mesh, k,
                        exchange=halo.exchange_x_slabs)
                    interior = [
                        cuda_stencil.fused_step(
                            fields, self._params_of(r), self._seeds(step),
                            tuple(f for pr in halo.frozen_slabs(
                                fields, bvs, 0, k) for f in pr),
                            spec=spec, use_noise=self.use_noise, fuse=k,
                            offsets=self.offsets[r], row=L,
                        )
                        for r, fields in enumerate(blocks)
                    ]
                    pairs = exchanged(pending.finish)
                    nx = local[0]

                    def planes(f, a, b):
                        # x planes [a, b) of a block (of every member of a
                        # member-stacked one), dense, as the kernel reads.
                        return f[..., a:b, :, :].contiguous()

                    for r, (fields, res) in enumerate(zip(blocks, interior)):
                        ox, oy, oz = self.offsets[r]
                        jobs = (
                            (0, tuple(x for f, (lo, _) in zip(fields, pairs[r])
                                      for x in (lo, planes(f, k, 2 * k)))),
                            (nx - k, tuple(x for f, (_, hi) in zip(fields,
                                                                   pairs[r])
                                           for x in (planes(f, nx - 2 * k,
                                                            nx - k),
                                                     hi))),
                        )
                        for x0, faces_b in jobs:
                            band = cuda_stencil.fused_step(
                                tuple(planes(f, x0, x0 + k) for f in fields),
                                self._params_of(r), self._seeds(step),
                                faces_b, spec=spec, use_noise=self.use_noise,
                                fuse=k, offsets=(ox + x0, oy, oz), row=L,
                                band=True,
                            )
                            for o, b in zip(res, band):
                                o[..., x0:x0 + k, :, :].copy_(b)
                    return pin_blocks(interior)

                return run_chain_rounds(chain, fuse, blocks)

            # xy-chain (+ z bands when z is sharded): the kernel's chain
            # crosses x and y block boundaries on a y-extended operand.
            caps = [local[0], local[1]]
            if dims[2] > 1:
                caps.append(local[2] // 2)  # z-band windows need nz >= 2k
            fuse = max(1, min(self.fuse, max(nsteps, 1), *caps))
            fuse = deepen(fuse, *caps)
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

                def band_kernel(rank, body, faces, stp, origin):
                    # The x-chain kernel on a thin body: the same
                    # computation per cell as the chain's, so the band
                    # equals the fused round's cells bitwise.
                    return cuda_stencil.fused_step(
                        body, self._params_of(rank), self._seeds(stp),
                        faces, spec=spec, use_noise=self.use_noise,
                        fuse=depth, offsets=origin, row=L, band=True,
                    )

                ov = self.comm_overlap and temporal.xy_overlap_feasible(
                    local, dims, depth)
                if ov:
                    self.overlap_applied = True
                return pin_blocks(temporal.xy_chain(
                    blocks, band_params_of, self.model, depth=depth,
                    step=step, offsets=self.offsets,
                    chain_kernel=chain_kernel, use_noise=self.use_noise,
                    unit_noise=band_unit_noise, row=L, mesh=mesh,
                    boundaries=bvs, compute_dtype=band_dtype, overlap=ov,
                    band_kernel=band_kernel,
                ))

            return run_chain_rounds(chain, fuse, blocks)

        # ---- plain path ----
        cdt = self.compute_dtype
        # The split phase of the window chain runs on (n, 1, 1) meshes
        # only, as the reference gates it (its x-thin band windows are
        # the ones XLA:CPU compiles stably); the other meshes take the
        # fused round.
        overlap_plain = self.comm_overlap and dims[1] == 1 and dims[2] == 1
        if nsteps < 2 and not overlap_plain:
            self.exchange_rounds += 1
            pads = exchanged(halo.halo_pad, blocks, bvs, mesh)
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
        fuse = deepen(fuse, min(local))

        def chain(blocks, step, depth):
            if overlap_plain:
                # Split phase: the frame exchange starts, the chain runs
                # on frozen frames, then the k-thick bands of every
                # sharded face are recomputed from the arrived frames.
                self.overlap_applied = True
                pending = exchanged(halo.start_exchange, blocks, bvs, mesh,
                                    depth)
                interior = [
                    temporal.window_chain(
                        halo.frozen_frame(fields, bvs, depth),
                        self._params_of(r), self.model, depth=depth,
                        step=step,
                        origin=tuple(o - depth for o in self.offsets[r]),
                        row=L, use_noise=self.use_noise,
                        unit_noise=unit_noise, boundaries=bvs,
                        final_pin=padded, compute_dtype=cdt,
                    )
                    for r, fields in enumerate(blocks)
                ]
                frames = exchanged(pending.finish)
                return [
                    temporal.stitch_bands_from_frame(
                        fi, fw, self._params_of(r), self.model, depth=depth,
                        step=step, offs=self.offsets[r], row=L,
                        axis_sizes=dims, use_noise=self.use_noise,
                        unit_noise=unit_noise, boundaries=bvs,
                        compute_dtype=cdt,
                    )
                    for r, (fi, fw) in enumerate(zip(interior, frames))
                ]
            frames = exchanged(halo.halo_pad_wide, blocks, bvs, mesh,
                               depth)
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
        has no bfloat16). A run of several processes raises: no process
        holds the whole grid (read the stores, or :meth:`snapshot`'s
        blocks, instead)."""
        if self.processes > 1:
            raise ValueError(
                f"get_fields() needs the whole grid, but this process "
                f"holds {self.mesh.n_blocks} of the {self.domain.n_blocks} "
                f"blocks of a {self.processes}-process run; read the "
                "output store, or this process's blocks from snapshot()")
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

    def snapshot_async(self, *, health: bool = False,
                       numerics: bool = False, checksum: bool = False,
                       bitflip=None, encode=None, exact: bool = True,
                       ring=None) -> "FieldSnapshot":
        """Capture the fields for an output boundary without waiting for
        the copies: the returned :class:`FieldSnapshot` has every
        block's device-to-host copy in flight, and the caller may hand
        it to a writer thread (``io/async_writer.py``) and go on
        enqueueing steps.

        One pass of device work, in the reference's order: the copies
        (a field the ``bitflip`` hook targets is first copied on the
        device); ``health``, the probe (``resilience/health.device_probe``:
        every field finite, each field's min and max); ``numerics``, the
        numerics probe (``obs/numerics.device_partials``: each field's
        min, max, sum, sum of squares, cell and non-finite counts);
        ``encode``
        (``{field index: bits}``, the lossy codec's quantization with
        the global range, :func:`~.io.codec.device_quantize`);
        ``checksum``, each field's wrapped uint32 word sum
        (``resilience/integrity.device_field_checksum``), over the
        pristine fields; then ``bitflip`` (a field name, or True for the
        first field) flips one bit of the first block's *copy* of that
        field, so the checksum must catch it and the live fields stay
        as they are. ``exact=False`` skips the exact copies (a boundary
        whose targets all take the codec form).

        On the card the copies run on a copy stream of each device
        (``copy_stream.wait_stream`` of the compute stream, each source
        held by ``record_stream`` until its copy is done) into pinned
        host buffers: those of ``ring`` (a :class:`HostRing`, reused
        across boundaries) or fresh ones. The probes' few scalars come
        back on the compute stream. Nothing here waits: the snapshot
        waits on its own events."""
        if not exact and not encode:
            raise ValueError("snapshot(exact=False) needs an encode spec")
        if bitflip is not None and not exact:
            raise ValueError("the bitflip hook flips an exact copy: "
                             "snapshot with exact=True")
        from .resilience.integrity import apply_bitflip

        names = self.model.field_names
        sources = [list(fields) for fields in self.blocks]
        flip = None
        if bitflip is not None:
            flip = 0 if bitflip is True else names.index(str(bitflip))
            flip_block, flip_at = self._bitflip_site()
            # The copy of the field the hook corrupts, on the device.
            sources[flip_block][flip] = sources[flip_block][flip].clone()
        probes = ([self._probe_fn(fields) for fields in self.blocks]
                  if health else None)
        partials = ([self._partials_fn(fields) for fields in self.blocks]
                    if numerics else None)
        multi = self.processes > 1
        coded = {}
        for i, bits in (encode or {}).items():
            coded[i] = (bits,) + device_quantize(
                [b[i] for b in self.blocks], bits,
                reduce_range=distributed.global_range if multi else None)
        sums = ([self._checksum_fn(fields) for fields in self.blocks]
                if checksum and exact else None)
        if flip is not None:
            sources[flip_block][flip] = apply_bitflip(
                sources[flip_block][flip], flip_at)
        # The probes' scalars (a checksum below 2**32 is exact in
        # float64), back on the compute stream: the caller resolves them
        # before the copies land. A member-stacked block's are one row
        # per member.
        small = []
        if probes or sums or partials:
            for r in range(len(self.blocks)):
                vec = ([probes[r]] if probes else []) + (
                    [sums[r]] if sums else []) + (
                    [partials[r]] if partials else [])
                small.append(torch.cat(vec, -1).to("cpu", non_blocking=True))
        cuda_devices = [d for d in dict.fromkeys(self.mesh.devices)
                        if d.type == "cuda"]
        probe_events = []
        for d in cuda_devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            probe_events.append(ev)
        streams = {}
        for d in cuda_devices:
            st = self._copy_streams.get(d)
            if st is None:
                st = self._copy_streams[d] = torch.cuda.Stream(device=d)
            st.wait_stream(torch.cuda.current_stream(d))
            streams[d] = st
        slot = ring.take() if ring is not None else None

        def to_host(src, key):
            if ring is not None:
                buf = ring.buffer(slot, key, src)
            else:
                buf = torch.empty(src.shape, dtype=src.dtype,
                                  pin_memory=src.is_cuda)
            if src.is_cuda:
                st = streams[src.device]
                with torch.cuda.stream(st):
                    buf.copy_(src, non_blocking=True)
                src.record_stream(st)
            else:
                buf.copy_(src)
            return buf

        boxes = self._snapshot_boxes()
        parts = ([(offs, true) + tuple(to_host(f, (r, i))
                                       for i, f in enumerate(srcs))
                  for r, ((offs, true), srcs) in enumerate(zip(boxes,
                                                               sources))]
                 if exact else None)
        enc_parts = None
        if coded:
            enc_parts = []
            for r, ((offs, true), srcs) in enumerate(zip(boxes, sources)):
                entries = []
                for i, src in enumerate(srcs):
                    if i in coded:
                        entries.append(to_host(coded[i][1][r], ("q", r, i)))
                    elif parts is not None:
                        entries.append(parts[r][2 + i])
                    else:
                        entries.append(to_host(src, ("e", r, i)))
                enc_parts.append((offs, true) + tuple(entries))
        events = []
        for d in cuda_devices:
            ev = torch.cuda.Event()
            ev.record(streams[d])
            events.append(ev)
        return self.snapshot_cls(
            self.step, parts, names, events=events,
            probe_events=probe_events, small=small, health=health,
            checksum=sums is not None, numerics=numerics,
            enc_parts=enc_parts,
            enc_meta={i: (bits, lo, hi, self.dtype)
                      for i, (bits, _, lo, hi) in coded.items()},
            reduce_probe=distributed.reduce_probe if multi else None,
            gather=distributed.all_gather_f64 if multi else None)

    # ----------------------------------------------- snapshot probe hooks

    def _probe_fn(self, fields) -> torch.Tensor:
        """The health probe of one block (``health.device_probe``)."""
        return device_probe(*fields)

    def _partials_fn(self, fields) -> torch.Tensor:
        """The numerics partials of one block."""
        return obs_numerics.device_partials(*fields)

    def _checksum_fn(self, fields) -> torch.Tensor:
        """Each field's device checksum of one block, as float64 (exact
        below 2**32)."""
        from .resilience.integrity import device_field_checksum

        return torch.stack(device_field_checksum(*fields)).to(torch.float64)

    def _bitflip_site(self):
        """``(block, index)`` the snapshot's ``bitflip`` hook flips: the
        first element of the first block."""
        return 0, (0,) * self.blocks[0][0].dim()

    def _snapshot_boxes(self) -> List[Tuple[tuple, tuple]]:
        """The ``(offsets, true sizes)`` of each block's snapshot part."""
        return self.local_boxes()

    def snapshot(self, encode=None, exact: bool = True,
                 health: bool = False,
                 checksum: bool = False) -> BoundaryBlocks:
        """The synchronous form of :meth:`snapshot_async`: host blocks
        ``[(offsets, sizes, *fields)]`` for the output and checkpoint
        stores, one per block, each clipped to the true domain (a
        non-divisible L stores pad cells past L); bfloat16 fields as
        float32 arrays holding their values. The codec form is on the
        result's ``encoded`` (coded fields as
        :class:`~.io.codec.EncodedField`), the
        :class:`~.resilience.health.HealthReport` on its ``health`` when
        ``health``; ``checksum`` verifies the landed bytes against the
        device checksum. The buffers are the result's own."""
        snap = self.snapshot_async(health=health, checksum=checksum,
                                   encode=encode, exact=exact)
        out = snap.blocks()
        out.health = snap.health_report()
        return out

    def numerics_stats(self):
        """One numerics probe over the live fields, resolved to a
        :class:`~.obs.numerics.NumericsReport` (``GS_NUMERICS=every_round``
        runs it after every round). Only reads the fields; waits for the
        probe's scalars. A collective in a run of several processes."""
        vecs = [obs_numerics.device_partials(*fields).cpu()
                for fields in self.blocks]
        return _numerics_of(
            [v.numpy() for v in vecs], self.model.field_names,
            distributed.all_gather_f64 if self.processes > 1 else None)

    def _field_index(self, field) -> int:
        """A model field name, the ``"u"``/``"v"`` aliases, or an
        index, as the field's index."""
        if isinstance(field, int):
            return field
        names = self.model.field_names
        if field in names:
            return names.index(field)
        alias = {"u": 0, "v": 1}.get(field)
        if alias is not None and alias < self.model.n_fields:
            return alias
        raise ValueError(
            f"unknown field {field!r} for model {self.model.name!r} "
            f"(fields: {', '.join(names)})")

    def poison_drift(self, field="u", factor: float = 8.0) -> None:
        """Test hook: scale the global corner box ``[0:2]^3`` of
        ``field`` by ``factor`` — a large but finite excursion, as the
        reference's ``poison_drift``. The corner lies outside the
        reaction seed, so the health guard stays green while the field's
        statistics jump and the numerics drift gate must trip. The block
        holding the corner gets a new tensor (the live one may still be
        the source of a snapshot's copy in flight)."""
        i = self._field_index(field)
        for r, offs in enumerate(self.offsets):
            if any(offs):
                continue
            fields = list(self.blocks[r])
            scaled = fields[i].clone()
            box = (Ellipsis,) + (slice(0, 2),) * 3
            scaled[box] *= factor
            fields[i] = scaled
            self.blocks[r] = tuple(fields)

    def poison_nan(self, field="u") -> None:
        """Test hook (the ``nan`` fault): set the global cell ``(0, 0,
        0)`` of ``field`` to NaN, as the reference's ``poison_nan``, for
        the health guard to catch at the next boundary. The block
        holding it gets a new tensor."""
        i = self._field_index(field)
        for r, offs in enumerate(self.offsets):
            if any(offs):
                continue
            fields = list(self.blocks[r])
            poisoned = fields[i].clone()
            poisoned[(0,) * poisoned.dim()] = float("nan")
            fields[i] = poisoned
            self.blocks[r] = tuple(fields)

    def _sdc_site(self, device=None) -> Tuple[str, int]:
        """``(device name, block rank)`` the ``sdc`` poison hits: the
        highest-ranked block on ``device`` (default: the highest-indexed
        device holding a block)."""
        from .resilience.sdc import device_name

        names = [device_name(d) for d in self.mesh.devices]
        if device is None:
            device = max(names, key=lambda n: (
                n.split(":")[0], int(n.split(":")[1]) if ":" in n else 0))
        elif device not in names:
            raise ValueError(
                f"sdc fault device {device!r} owns no block (have: "
                f"{', '.join(sorted(set(names)))})")
        return device, max(r for r, n in enumerate(names) if n == device)

    def poison_sdc(self, device=None, field="u") -> str:
        """Test hook (the ``sdc`` fault): flip the mantissa's top bit
        (bit 22 of a 4-byte word, 6 of a 2-byte one) of the centre cell
        of the highest-ranked block on ``device`` before the round runs,
        as the reference's ``poison_sdc``: a finite wrong input to the
        step, which only the SDC screen can catch (the write path's
        ``bitflip`` must stay invisible to it). Returns the device's
        name. The block gets a new tensor."""
        from .resilience.integrity import apply_bitflip

        i = self._field_index(field)
        name, r = self._sdc_site(device)
        fields = list(self.blocks[r])
        arr = fields[i]
        bit = 6 if arr.element_size() == 2 else 22
        fields[i] = apply_bitflip(arr, self._sdc_index(r, arr), bit=bit)
        self.blocks[r] = tuple(fields)
        return name

    def _sdc_index(self, r: int, arr) -> tuple:
        """The cell of block ``r``'s ``arr`` the ``sdc`` poison flips:
        its centre."""
        return tuple(n // 2 for n in arr.shape)

    def retain_fields(self) -> List[tuple]:
        """Copies of every block's live fields, on their devices and
        stream: the SDC screen's anchor. A copy, so that nothing that
        later writes a block (a poison hook, an in-place kernel) can
        change the anchor."""
        return [tuple(f.clone() for f in fields) for fields in self.blocks]

    def replay_fields(self, fields, step0: int, nsteps: int,
                      devices=None) -> List[tuple]:
        """``nsteps`` steps from ``fields`` (every block's field tuple at
        absolute step ``step0``, as :meth:`retain_fields` gives them),
        returned as new block tuples; the live blocks, step, exchange
        counters and launch counters are left as they were. The replay
        runs the same launches as :meth:`iterate` (the same kernel,
        mode, depth, split round and halo depth), so on the card replay
        and live run are bit-equal by construction. ``devices`` (one per
        block, a permutation of the mesh's) places the replay's blocks
        elsewhere: the SDC screen's shadow mode."""
        if nsteps <= 0:
            return [tuple(f) for f in fields]
        saved = (self.step, self.exchange_rounds, self.overlap_applied,
                 self.mesh, self.blocks)
        try:
            self.step = int(step0)
            blocks = [tuple(f) for f in fields]
            if devices is not None:
                devices = [torch.device(d) for d in devices]
                self.mesh = self._build_mesh(devices, self.mesh.first_rank)
                blocks = [tuple(f.to(d) for f in b)
                          for b, d in zip(blocks, devices)]
            with cuda_stencil.replaying():
                return self._run_blocks(blocks, nsteps)
        finally:
            (self.step, self.exchange_rounds, self.overlap_applied,
             self.mesh, self.blocks) = saved

    def block_checksums(self, blocks=None) -> List[tuple]:
        """Per block, each field's wrapped uint32 word sum
        (``integrity.device_field_checksum``), reduced on the blocks'
        devices; one copy of the sums to the host."""
        from .resilience.integrity import device_field_checksum

        blocks = self.blocks if blocks is None else blocks
        sums = [torch.stack(device_field_checksum(*fields)).cpu()
                for fields in blocks]
        return [tuple(int(x) for x in s) for s in sums]

    def metrics_labels(self) -> dict:
        """The labels every metric of this run carries
        (``obs/metrics.py``): model, mesh and kernel path."""
        return {
            "model": self.model.name,
            "mesh": "x".join(str(d) for d in self.domain.dims),
            "kernel": self.kernel_language,
        }

    def device_memory_stats(self) -> list:
        """Per local card, the allocator's bytes in use and their peak
        (``torch.cuda.memory_allocated`` / ``max_memory_allocated``), for
        the metrics registry; empty on the CPU."""
        cards = dict.fromkeys(
            torch.cuda.current_device() if d.index is None else d.index
            for d in self.mesh.devices if d.type == "cuda")
        return [{
            "device": f"cuda:{i}",
            "bytes_in_use": int(torch.cuda.memory_allocated(i)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
        } for i in cards]

    def layout(self):
        """This run's :class:`~.reshard.plan.LayoutMeta`: what its
        checkpoints record, and the "new" side of a restore plan."""
        from .reshard.restore import layout_of

        return layout_of(self)

    def block_boxes(self) -> List[Tuple[tuple, tuple]]:
        """Every block's ``(offsets, sizes)`` in the true ``L^3`` domain
        (a non-divisible L's pad cells cut off), in rank order, over all
        processes: the layout the stores record."""
        return self.domain.block_boxes()

    def local_boxes(self) -> List[Tuple[tuple, tuple]]:
        """The boxes of this process's blocks (:meth:`block_boxes`'s
        share of the ranks it holds)."""
        first = self.mesh.first_rank
        return self.block_boxes()[first:first + self.mesh.n_blocks]

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

    def restore_blocks(self, boxes, step: int) -> None:
        """Load this process's blocks at ``step`` from host arrays, one
        tuple of field arrays (declaration order) per box of
        :meth:`local_boxes`; the pad cells of a non-divisible L are
        rebuilt at the boundary value."""
        block = self.domain.local_shape if self.sharded else (
            (self.settings.L,) * 3)
        blocks = []
        for arrays, dev in zip(boxes, self.mesh.devices):
            if len(arrays) != self.model.n_fields:
                raise ValueError(
                    f"Checkpoint has {len(arrays)} fields; model "
                    f"{self.model.name!r} declares {self.model.n_fields}")
            blocks.append(tuple(
                torch.tensor(np.pad(np.asarray(a), [
                    (0, b - n) for b, n in zip(block, np.shape(a))],
                    constant_values=bv), dtype=self.dtype, device=dev)
                for a, bv in zip(arrays, self.model.boundaries)))
        self.blocks = blocks
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


def _numerics_of(rows, names, gather=None):
    """The report of this process's blocks' numerics partials, with
    ``gather`` (``distributed.all_gather_f64``) those of every process's
    blocks, merged in one :func:`~.obs.numerics.combine`: the same bits
    on every process and for every split of the blocks among them."""
    rows = [np.asarray(r, dtype=np.float64) for r in rows]
    if gather is not None:
        width = rows[0].size
        rows = [v[i:i + width] for v in gather(np.concatenate(rows))
                for i in range(0, v.size, width)]
    return obs_numerics.report_of(obs_numerics.combine(rows), names)


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


def _landed(buf: torch.Tensor) -> np.ndarray:
    """A host buffer as numpy, bfloat16 as its uint16 bit patterns."""
    if buf.dtype == torch.bfloat16:
        return buf.view(torch.int16).numpy().view(np.uint16)
    return buf.numpy()


def _widened(arr: np.ndarray, buf: torch.Tensor) -> np.ndarray:
    """:func:`_landed`'s array with bfloat16 widened exactly to float32."""
    return bf16_widen(arr) if buf.dtype == torch.bfloat16 else arr


def initialization(args, *, n_devices: Optional[int] = None, seed: int = 0):
    """Parse the config and build the simulation:
    ``(settings, domain, sim)``."""
    settings = config.get_settings(list(args))
    sim = Simulation(settings, n_devices=n_devices, seed=seed)
    return settings, sim.domain, sim
