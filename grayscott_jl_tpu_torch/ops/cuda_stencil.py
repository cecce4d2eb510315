"""Fused stencil kernel dispatch (counterpart of
``grayscott_jl_tpu/ops/pallas_stencil.py``).

:func:`fused_step` advances a model's interior-shaped fields ``fuse``
explicit-Euler steps with the same contract as the reference's
``pallas_stencil.fused_step``, in its three forms: no faces (a whole
grid with a frozen ghost shell), the 6n-face form (one step of a block
of a 3D-sharded grid) and the 2n-face x-chain form (``fuse`` steps
across an x shard boundary, also run on the y-extended operand of
``parallel/temporal.xy_chain``). For tensors on the card it launches the
model's kernel, generated by ``ops/kernelgen.py`` from the hand-written
template ``ops/csrc/stencil_chain.cu`` (one library per model, built by
``ops/_build.py``) — or raises: a build or launch error, or a dtype it
does not take, stops the run; a model the generator refuses has no
spec. For tensors on the CPU it runs the plain torch version.

Precision postures (the reference's ``_compute_dtype`` and
``_mid_store_dtype``): float32 and float64 fields are computed in their
own dtype; bfloat16 fields are stored bf16 (in memory and in the
kernel's shared-memory windows) and computed in float32, rounding once
per stage; ``GS_MID_BF16=1`` keeps float32 fields and their input
window in float32 but stores the chain's mid-stage windows as bf16 (an
opt-in trade that is not bitwise equal to single steps).

The plain versions, and why there are two for bf16:

* :func:`plain_step` is the torch form of the reference's
  ``_xla_fallback`` (one step on ghost-padded fields with the
  position-keyed noise; with 6n faces the ghosts come from
  :func:`pad_from_faces`), :func:`plain_chain` is ``fuse`` plain steps
  with the seed step advanced, and :func:`plain_xchain` is
  ``_xla_xchain_fallback``. This is the port's Plain kernel language
  and its CPU path. Its noise unit is drawn in the storage dtype and it
  accumulates in the params' dtype when that differs from the storage
  (``bf16_f32acc``), so under ``BFloat16`` it computes in bf16.
* The same functions with ``oracle=True`` are the kernel's oracle: the
  padded fields and the params widened to the kernel's compute dtype,
  the noise unit drawn in it, one rounding to the stage's output dtype
  (the storage dtype, or the mid dtype for the first ``fuse - 1``
  stages of a chain). For float32 and float64 without ``GS_MID_BF16``
  this is the same computation as the plain one. The kernel equals its
  oracle bitwise, as the reference's bf16 kernel equals this emulation
  and not its own XLA path.

The shared-memory ledger (:func:`smem_bytes`, :func:`max_feasible_fuse`)
replaces the reference's VMEM slab ledger: the kernel keeps the window
of each of the model's fields — the ``TILE`` plus a ``fuse``-cell halo
per side, at the padded z stride of :func:`window_geometry` — in shared
memory, as two ping-pong buffers of the storage type, or, under
``GS_MID_BF16``, one float32 input window plus bf16 mid windows, and
the load's mbarrier. Without faces, a requested depth above what fits runs as
a sequence of shallower launches; an x-chain's depth is its slabs'
width, so the caller caps it (the simulation does, with a warning) and
a deeper one raises.

The window load: each field's window is one TMA box, from a tensor map
encoded on the host (``gs_window_map``) and cached per (data pointers,
shape, dtype, fuse); an operand TMA refuses loads the same padded window
by ``cp.async``. :func:`load_path` is the rule; :func:`emulate_window`
is the load in torch ops (padded stride, zero fill, then the ghost
pass), which the CPU tests hold to the window's definition in every
mode. ``LOAD_PATH_LAUNCHES`` counts the launches of each path.

The member axis (the reference's ensemble ``vmap`` of ``_fused_call``):
fields stacked as ``(N, nx, ny, nz)``, faces with the same leading axis,
params as :func:`member_params` (each leaf ``(N, 1, 1, 1)``) and the
seeds' key words as N-tuples (:func:`member_seeds`) advance all N
members in ONE launch of the kernel (its grid's ``blockIdx.y``), each
member bitwise equal to its own solo launch. The batched launch loads
through a 4-D tensor map (:func:`window_maps`), so a window past an x
edge of member k never reads member k - 1's planes; a stack of one
member takes the solo launch. The plain versions take the same leading
axis by broadcasting.

The schedule: a launch in ``chain`` mode at depth 1 on the TMA path
(:func:`schedule_of`) runs the march — one block per member's (y, z)
column walking ``span`` x-planes (:func:`march_grid`) over a ring of
plane slots that a producer warp fills by TMA (:func:`ring_geometry`,
:func:`ring_smem_bytes`), with tensor maps of one plane's box; every
other launch runs the window kernel. Both compute the same operations in
the same order (bitwise equal). ``SCHEDULE_LAUNCHES`` counts the
launches of each.

``LAUNCHES`` counts kernel launches (not plain-path calls),
``MODE_LAUNCHES`` splits them by mode, ``BAND_LAUNCHES`` counts the
x-chain launches that recompute a split-phase round's boundary bands
(``fused_step(..., band=True)``), ``MODEL_LAUNCHES`` by model and
``DTYPE_LAUNCHES`` by entry point (``f32``, ``f64``, ``bf16``,
``f32_mid_bf16``): a run reads them to show that its steps went through
the kernel generated for its model at its precision. The envelope
probes (``ops/envelope.py``) are modes of the same template: their
launches count in ``LAUNCHES`` and ``MODE_LAUNCHES`` (``copy_walk``,
``compute_walk``), the compute walk's also per variant in
``VARIANT_LAUNCHES``, and in neither per-model nor per-entry count.
The SDC screen's replays (inside ``replaying()``) count in
``REPLAY_LAUNCHES`` only. ``ENTRY_LAUNCHES`` counts the launches of each
kernel entry (model, mode, entry point, members, depth, operand shape),
and :func:`kernel_attributes` reads an entry's registers, shared bytes
and blocks per SM from the card: the build and launch analytics'
records (``obs/xstats.py``).

The launch path's host time, while ``obs/trace.hot_armed`` (``GS_TRACE``
or a live ``torch.profiler`` capture), beside ``LAUNCHES``: each
outermost :func:`fused_step` call is a ``gs_launch`` range and the call
into the library's entry point inside it a ``gs_launch_call`` range,
recorded in a capture on one call in :data:`LAUNCH_RANGE_EVERY` and
timed on every one. ``TIMED_LAUNCHES`` counts the launches timed,
``CALL_NS`` the nanoseconds in ``gs_launch_call`` (the entry queues the
kernel, and blocks while CUDA's launch queue is full), ``OPS_NS`` those
in the torch ops that build a launch's operands (the params vector's
stack, the outputs' allocation, the faces' copies: they queue device
work too, and wait the same way), ``DISPATCH_NS`` those in ``gs_launch``
less both: the host's own work a launch costs, whatever the queue holds
(on the CPU, where no launch counts, the plain path's). ``SYNC_NS`` and
``EXCHANGE_NS`` hold the driver's ``gs_sync`` and the sharded round's
``gs_exchange``; :func:`timings` reads them all. Off, a call costs one
check and reads no clock.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config.env import env_raw
from ..obs import trace as _trace
from . import stencil
from .noise import uniform_pm1_block

#: Launches of the CUDA kernel since the process started (or the
#: caller last reset them).
LAUNCHES = 0

#: Launches counted while the hot path's instrumentation was armed, and
#: the host nanoseconds it measured (module docstring; :func:`timings`).
TIMED_LAUNCHES = 0
DISPATCH_NS = 0
CALL_NS = 0
OPS_NS = 0
SYNC_NS = 0
EXCHANGE_NS = 0

#: A live capture records the ``gs_launch`` and ``gs_launch_call`` ranges
#: of the timed :func:`fused_step` calls 0, N, 2N, ... after
#: :func:`reset_launches`: the two ranges cost the host ~20 µs a launch
#: under a capture of the card, a tenth of the kernel's time at L=256.
LAUNCH_RANGE_EVERY = 100
_TIMED_CALLS = 0

#: The kernel's modes: no faces (``chain``), 6n faces (``faces6``), the
#: x-chain (``xchain``) and the x-chain on the xy-chain's y-extended
#: operand (``xychain``). The integer is the kernel's ``Mode``.
MODES: Dict[str, int] = {"chain": 0, "faces6": 1, "xchain": 2, "xychain": 2}

#: The envelope probes' modes (``Mode`` 3 and 4 of the kernel).
PROBE_MODES = ("copy_walk", "compute_walk")

#: The compute walk's variants, in the order of the kernel's ``Variant``.
PROBE_VARIANTS = ("chain", "nonoise", "noselect", "noyz", "fma", "minimal",
                  "nomid")

#: Launches per mode (the probes' too), counted beside :data:`LAUNCHES`.
MODE_LAUNCHES: Dict[str, int] = dict.fromkeys((*MODES, *PROBE_MODES), 0)

#: The most members one launch of each mode advanced (a batched launch
#: counts once in every count above, whatever its member count).
MODE_MEMBERS: Dict[str, int] = dict.fromkeys((*MODES, *PROBE_MODES), 0)

#: Launches that recompute the boundary bands of a split-phase round
#: (x-chain mode, counted in :data:`MODE_LAUNCHES` too).
BAND_LAUNCHES = 0

#: Compute-walk launches per variant.
VARIANT_LAUNCHES: Dict[str, int] = dict.fromkeys(PROBE_VARIANTS, 0)

#: Launches per model (the generated kernel that ran), counted beside
#: :data:`LAUNCHES`.
MODEL_LAUNCHES: Dict[str, int] = {}

#: The kernel's entry points: (field dtype, bf16 mids) -> the suffix of
#: ``gs_stencil_chain_<suffix>`` in the library.
ENTRIES: Dict[Tuple[torch.dtype, bool], str] = {
    (torch.float32, False): "f32",
    (torch.float64, False): "f64",
    (torch.bfloat16, False): "bf16",
    (torch.float32, True): "f32_mid_bf16",
}

#: Launches per entry point, counted beside :data:`LAUNCHES`.
DTYPE_LAUNCHES: Dict[str, int] = dict.fromkeys(ENTRIES.values(), 0)

#: Launches per kernel entry: ``(model, mode, entry point, members,
#: fuse, operand shape, band)`` -> count, beside :data:`LAUNCHES` (the
#: build and launch analytics' records, ``obs/xstats.py``).
ENTRY_LAUNCHES: Dict[tuple, int] = {}

#: Interior tile of one thread block, (x, y, z); z is contiguous. Must
#: equal TX/TY/TZ in stencil_chain.cu (checked when the library loads).
TILE = (8, 8, 32)

#: Shared memory one block may use on Hopper (227 KB of the SM's 256).
SMEM_LIMIT = 232_448

#: Ping-pong window buffers per field when the windows share one type.
N_BUFFERS = 2

#: The kernel's mbarrier of the TMA load, after the windows.
BARRIER_BYTES = 8

#: The window load paths: a TMA box per field, or ``cp.async`` for an
#: operand TMA refuses (:func:`load_path`).
LOAD_PATHS = ("tma", "cp_async")

#: Launches per load path (the probes' too), counted beside
#: :data:`LAUNCHES`.
LOAD_PATH_LAUNCHES: Dict[str, int] = dict.fromkeys(LOAD_PATHS, 0)

#: The kernel's schedules: the window kernel, or the march that a
#: depth-1 ``chain`` launch on the TMA path runs (:func:`schedule_of`).
SCHEDULES = ("window", "march")

#: Launches per schedule (the probes' too, all ``window``), counted
#: beside :data:`LOAD_PATH_LAUNCHES`.
SCHEDULE_LAUNCHES: Dict[str, int] = dict.fromkeys(SCHEDULES, 0)

#: The march's layout, as ``gs_layout`` reports it after the tile and the
#: counts: column rows, column z bytes (16 B a thread of a row's 16),
#: ring slots, threads (16 consumer warps and a producer), the least
#: span and the blocks a launch aims for (:func:`march_span`).
MARCH_ROWS = 32
MARCH_Z_BYTES = 256
RING_SLOTS = 4
MARCH_THREADS = 544
MARCH_MIN_SPAN = 16
MARCH_BLOCKS = 528
MARCH_LAYOUT = (MARCH_ROWS, MARCH_Z_BYTES, RING_SLOTS, MARCH_THREADS,
                MARCH_MIN_SPAN, MARCH_BLOCKS)

#: Bytes before the ring's slots (its 2 x RING_SLOTS mbarriers, padded to
#: TMA's 128 B destination alignment).
RING_HEAD = 128

#: A load path forced by :func:`override` (the parity checks run every
#: mode on both paths); None lets :func:`load_path` decide.
_FORCED_LOAD: Optional[str] = None

#: Encoded tensor maps of kernel inputs, by (data pointers, shape,
#: itemsize, fuse); a batched launch's shape carries its member count.
#: A few buffers cycle through the steps of a run.
_MAPS: Dict[tuple, ctypes.Array] = {}
_MAPS_LIMIT = 256

#: Bytes of one encoded ``CUtensorMap``.
MAP_BYTES = 128

#: Device arrays of a batched launch's key pairs, by (device, keys).
_KEYS: Dict[tuple, torch.Tensor] = {}
_KEYS_LIMIT = 64

#: Guards :data:`_MAPS`, :data:`_KEYS` and the launch counts: the serve
#: worker fleet drives one card from several threads at once.
_LOCK = threading.Lock()


def reset_launches() -> None:
    """Set :data:`LAUNCHES`, :data:`BAND_LAUNCHES`,
    :data:`REPLAY_LAUNCHES`, the timed counters (:func:`timings`) and
    every
    :data:`MODE_LAUNCHES`, :data:`MODE_MEMBERS`, :data:`VARIANT_LAUNCHES`,
    :data:`MODEL_LAUNCHES`, :data:`DTYPE_LAUNCHES`,
    :data:`ENTRY_LAUNCHES`, :data:`LOAD_PATH_LAUNCHES` and
    :data:`SCHEDULE_LAUNCHES` count to 0."""
    global LAUNCHES, BAND_LAUNCHES, REPLAY_LAUNCHES
    global TIMED_LAUNCHES, DISPATCH_NS, CALL_NS, OPS_NS, SYNC_NS
    global EXCHANGE_NS, _TIMED_CALLS
    LAUNCHES = BAND_LAUNCHES = REPLAY_LAUNCHES = 0
    TIMED_LAUNCHES = DISPATCH_NS = CALL_NS = OPS_NS = SYNC_NS = 0
    EXCHANGE_NS = _TIMED_CALLS = 0
    for counts in (MODE_LAUNCHES, MODE_MEMBERS, VARIANT_LAUNCHES,
                   DTYPE_LAUNCHES, LOAD_PATH_LAUNCHES, SCHEDULE_LAUNCHES):
        for key in counts:
            counts[key] = 0
    MODEL_LAUNCHES.clear()
    ENTRY_LAUNCHES.clear()


#: Launches inside :func:`replaying` (the SDC screen's replays), counted
#: here and in no count above: a run's counts stay those of its
#: trajectory. The screen reports its share as ``replay_launches``.
REPLAY_LAUNCHES = 0

#: Per thread: whether the thread is inside :func:`replaying`, so that
#: one serve worker's replay never counts another worker's launches.
_REPLAYING = threading.local()


def timings() -> Dict[str, int]:
    """The timed counters: ``launches`` (:data:`TIMED_LAUNCHES`) and
    ``dispatch_ns``, ``call_ns``, ``ops_ns``, ``sync_ns``,
    ``exchange_ns``."""
    with _LOCK:
        return {"launches": TIMED_LAUNCHES, "dispatch_ns": DISPATCH_NS,
                "call_ns": CALL_NS, "ops_ns": OPS_NS, "sync_ns": SYNC_NS,
                "exchange_ns": EXCHANGE_NS}


def add_host_ns(*, sync: int = 0, exchange: int = 0) -> None:
    """Add a ``gs_sync`` or ``gs_exchange`` range's nanoseconds."""
    global SYNC_NS, EXCHANGE_NS
    with _LOCK:
        SYNC_NS += sync
        EXCHANGE_NS += exchange


@contextlib.contextmanager
def replaying():
    """Count the launches this thread makes inside in
    :data:`REPLAY_LAUNCHES` only."""
    prev = getattr(_REPLAYING, "on", False)
    _REPLAYING.on = True
    try:
        yield
    finally:
        _REPLAYING.on = prev


class KernelLaunchError(RuntimeError):
    """A kernel launch (or its tensor map's encoding) failed on the
    card. ``code`` is the CUDA error, or None; ``sticky`` says whether
    the error leaves the process's CUDA context unusable."""

    def __init__(self, msg: str, code: Optional[int] = None):
        super().__init__(msg)
        self.code = code

    @property
    def sticky(self) -> bool:
        return self.code in STICKY_CUDA_ERRORS


#: CUDA runtime errors after which every later call of the process fails
#: (misaligned address, illegal address, launch failure, illegal
#: instruction, hardware stack error, the assert and ECC errors).
STICKY_CUDA_ERRORS = frozenset({214, 700, 710, 714, 715, 716, 717, 718,
                                719})


def load_path(shape: Sequence[int], itemsize: int,
              pointers: Sequence[int]) -> str:
    """The window load of a launch on inputs of ``shape`` (x, y, z),
    ``itemsize`` bytes a cell, at device addresses ``pointers``: ``"tma"``
    when every TMA rule holds — a row of nz cells (the tensor map's
    global stride) and every base address multiples of 16 B — else
    ``"cp_async"`` (e.g. nz = 250 float32). A path forced by
    :func:`override` wins; a forced TMA on an operand it refuses
    raises."""
    tma = (shape[2] * itemsize) % 16 == 0 and all(p % 16 == 0
                                                   for p in pointers)
    if _FORCED_LOAD == "cp_async":
        return "cp_async"
    if _FORCED_LOAD == "tma" and not tma:
        raise ValueError(
            f"TMA refuses inputs of shape {tuple(shape)} at {itemsize} B a "
            f"cell (pointers {[hex(p) for p in pointers]})")
    return "tma" if tma else "cp_async"


@contextlib.contextmanager
def override(load: Optional[str] = None):
    """Within the block, launch on the load path ``load`` (``"tma"`` or
    ``"cp_async"``; None: by :func:`load_path`'s rule) — for checks and
    timings that run one operand on both."""
    global _FORCED_LOAD
    if load not in (None, *LOAD_PATHS):
        raise ValueError(f"load must be one of {LOAD_PATHS}, got {load!r}")
    saved = _FORCED_LOAD
    _FORCED_LOAD = load
    try:
        yield
    finally:
        _FORCED_LOAD = saved


def window_geometry(itemsize: int, fuse: int,
                    tile: Tuple[int, int, int] = TILE):
    """The kernel's window at depth ``fuse`` for ``itemsize``-byte cells
    (``window_of`` in stencil_chain.cu): ``(WX, WY, WZ, WZP, lead,
    wvol)`` — the tile plus ``fuse`` cells per side; its rows stored at
    stride WZP (WZ rounded up until a row is a multiple of 16 B, TMA's
    rule for a box's inner dimension); ``lead``, the cells from the
    window's z origin (``fuse`` below a tile's) up to the next 16 B
    boundary, where TMA requires a box to start; ``wvol`` elements per
    field slot: a 128 B lead zone and the box rounded up to 128 B (TMA's
    alignment of a shared-memory destination)."""
    wx, wy, wz = (t + 2 * fuse for t in tile)
    zq, vq = 16 // itemsize, 128 // itemsize
    wzp = -(-wz // zq) * zq
    wvol = vq - (-(wx * wy * wzp) // vq) * vq
    return wx, wy, wz, wzp, fuse % zq, wvol


def ring_geometry(itemsize: int):
    """One plane slot of the march's ring for ``itemsize``-byte cells
    (``ring_of`` in stencil_chain.cu): ``(V, TZ, BZ, RY, box_bytes,
    slot_bytes)`` — V cells in a thread's 16 B; the column's TZ cells of
    z (:data:`MARCH_Z_BYTES`); the TMA box's BZ = TZ + 2 V cells of z,
    from V cells (16 B) below the column, so that it starts on a 16 B
    boundary; its RY = :data:`MARCH_ROWS` + 2 rows; its bytes; and one
    field's slot, rounded up to 128 B."""
    v = 16 // itemsize
    tz = MARCH_Z_BYTES // itemsize
    bz, ry = tz + 2 * v, MARCH_ROWS + 2
    box = ry * bz * itemsize
    return v, tz, bz, ry, box, -(-box // 128) * 128


def ring_smem_bytes(itemsize: int, n_fields: int = 2) -> int:
    """Dynamic shared memory of one march block: the ring's mbarriers
    (:data:`RING_HEAD`) and :data:`RING_SLOTS` slots of every field."""
    return RING_HEAD + RING_SLOTS * n_fields * ring_geometry(itemsize)[5]


def march_span(nx: int, tiles: int) -> int:
    """The x-planes one march block walks (``march_span`` in
    stencil_chain.cu), for ``nx`` planes and ``tiles`` = columns times
    members: enough segments for :data:`MARCH_BLOCKS` blocks, but none
    shorter than :data:`MARCH_MIN_SPAN` planes unless nx is."""
    segs = -(-MARCH_BLOCKS // tiles)
    segs = max(1, min(segs, nx // MARCH_MIN_SPAN))
    return -(-nx // segs)


def march_grid(shape: Sequence[int], itemsize: int, members: int = 1):
    """The march's grid on an (nx, ny, nz) operand of ``members``
    members: ``(columns, span, segments)``; it launches columns x
    segments blocks per member."""
    nx, ny, nz = shape
    tz = ring_geometry(itemsize)[1]
    cols = -(-nz // tz) * -(-ny // MARCH_ROWS)
    span = march_span(nx, cols * members)
    return cols, span, -(-nx // span)


def schedule_of(mode: str, fuse: int, shape: Sequence[int], itemsize: int,
                pointers: Sequence[int]) -> str:
    """The schedule of a launch (``march_engages`` in stencil_chain.cu):
    ``"march"`` for ``chain`` mode at depth 1 whose inputs and outputs
    (``pointers``) pass :func:`load_path`'s TMA rules — the march loads
    by TMA and stores 16 B a thread — else ``"window"``."""
    if mode != "chain" or fuse != 1:
        return "window"
    path = load_path(shape, itemsize, pointers)
    return "march" if path == "tma" else "window"


def compute_dtype_of(dtype: torch.dtype) -> torch.dtype:
    """The kernel's compute dtype for fields of ``dtype`` (the
    reference's ``_compute_dtype``): float32 for bfloat16, else the
    dtype itself."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def mid_bf16_requested(dtype: torch.dtype) -> bool:
    """Whether ``GS_MID_BF16=1`` stores the chain's mid windows as bf16
    for fields of ``dtype``: only float32 fields, read exactly as the
    reference's ``fused_step`` reads it."""
    return env_raw("GS_MID_BF16") == "1" and dtype == torch.float32


def mid_dtype_of(dtype: torch.dtype, mid_bf16: bool = False) -> torch.dtype:
    """The dtype the chain's mid stages are stored in (the reference's
    ``_mid_store_dtype``)."""
    return torch.bfloat16 if mid_bf16 else dtype


def smem_bytes(itemsize: int, fuse: int, n_fields: int = 2,
               tile: Tuple[int, int, int] = TILE,
               mid_itemsize: Optional[int] = None) -> int:
    """Dynamic shared memory of one block at chain depth ``fuse``: two
    ping-pong windows of ``itemsize`` per field, or — when the mid
    windows are narrower (``mid_itemsize``, ``GS_MID_BF16``) — one input
    window of ``itemsize`` plus the mid windows the chain needs (none at
    depth 1, one at depth 2, two deeper), as the reference's
    ``_slab_fits`` counts them; each window of
    :func:`window_geometry`'s ``wvol`` cells, and the load's mbarrier.
    This is the most a launch takes (the cap): a depth-1 launch requests
    one window per field, as it writes nothing back to shared memory, or
    marches in :func:`ring_smem_bytes`."""
    wvol = window_geometry(itemsize, fuse, tile)[5]
    if mid_itemsize is None or mid_itemsize == itemsize:
        return n_fields * N_BUFFERS * wvol * itemsize + BARRIER_BYTES
    n_mid = min(fuse - 1, N_BUFFERS)
    return (n_fields * wvol * (itemsize + n_mid * mid_itemsize)
            + BARRIER_BYTES)


def max_feasible_fuse(itemsize: int, n_fields: int = 2,
                      limit: int = SMEM_LIMIT,
                      mid_itemsize: Optional[int] = None) -> int:
    """Deepest chain whose windows fit in shared memory: with two fields
    8 for bfloat16, 5 for float32 (with or without bf16 mids) and 2 for
    float64; with one field 12, 8 and 5. The face modes use the same
    window, so this also caps the x-chain and the xy-chain."""
    k = 0
    while smem_bytes(itemsize, k + 1, n_fields,
                     mid_itemsize=mid_itemsize) <= limit:
        k += 1
    return k


def chain_cap(dtype: torch.dtype, n_fields: int = 2) -> int:
    """:func:`max_feasible_fuse` for fields of ``dtype`` under the
    current ``GS_MID_BF16`` setting."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    mid = 2 if mid_bf16_requested(dtype) else None
    return max_feasible_fuse(itemsize, n_fields, mid_itemsize=mid)


def max_feasible_chain_depth(local, dims, itemsize: int, depth: int,
                             n_fields: int = 2,
                             mid_itemsize: Optional[int] = None) -> int:
    """Deepest chain depth <= ``depth`` the sharded chain of mesh
    ``dims`` can run on blocks of shape ``local`` (the reference's
    ``pallas_stencil.max_feasible_chain_depth``): the geometry caps of
    the chain's form (x-chain on (n, 1, 1) meshes: depth <= nx;
    xy-chain: depth <= nx and ny, and <= nz // 2 when z is sharded, for
    the z bands) composed with the shared-memory ledger
    (:func:`max_feasible_fuse`, which does not depend on the block). 0
    when not even depth 1 fits."""
    nx, ny, nz = local
    cap = min(depth, nx)
    if not (dims[1] == 1 and dims[2] == 1):
        cap = min(cap, ny)
        if dims[2] > 1:
            cap = min(cap, nz // 2)
    if cap < 1:
        return 0
    return min(cap, max_feasible_fuse(itemsize, n_fields,
                                      mid_itemsize=mid_itemsize))


def pad_from_faces(x, xlo, xhi, ylo, yhi, zlo, zhi):
    """Ghost-pad an interior block with resolved halo faces (the
    reference's ``_pad_from_faces``; edge and corner ghosts get zeros —
    the 7-point stencil never reads them). A leading member axis rides
    along."""
    x = torch.cat([xlo, x, xhi], dim=-3)
    x = torch.cat([F.pad(ylo, (0, 0, 0, 0, 1, 1)), x,
                   F.pad(yhi, (0, 0, 0, 0, 1, 1))], dim=-2)
    return torch.cat([F.pad(zlo, (0, 0, 1, 1, 1, 1)), x,
                      F.pad(zhi, (0, 0, 1, 1, 1, 1))], dim=-1)


def emulate_window(fields, faces=None, *, mode="chain", fuse=1, origin,
                   boundaries, load="tma", member=None):
    """The kernel's window load for one tile, in torch ops: each field's
    ``(WX, WY, WZP)`` window (:func:`window_geometry`) whose origin in
    the operand's (x, y, z) coordinates is ``origin`` (negative at a low
    edge). The cells start undefined (NaN). ``load="tma"``: the box TMA
    copies, ``lead`` cells up in z, the cells outside the operand zero;
    ``"cp_async"``: every window cell below z = WZ, zero outside the
    operand. Then the ghost pass over the lead slab (TMA only: loaded,
    or by mode outside the operand) and the six boxes that make up the
    window's cells outside the operand above it, with each mode's value:
    the boundary value (``chain``), the face of the one axis a ghost lies
    across (``faces6``; the 6n faces as :func:`fused_step` takes them),
    the x slabs (``xchain``/``xychain``; the 2n-tuple). Returns the
    window tensors, in the fields' dtype.

    ``member`` (fields and faces stacked ``(N, ...)``) is the CTA's
    member of a batched launch: its 4-D tensor map's box is one member
    deep, so the copy, its zero fill and the ghost pass see member
    ``member``'s operand alone — a window past an x edge takes that
    member's ghosts, never the previous member's last planes."""
    if member is not None:
        fields = [f[member] for f in fields]
        faces = None if faces is None else [f[member] for f in faces]
    nx, ny, nz = fields[0].shape
    wx, wy, wz, wzp, lead, _ = window_geometry(fields[0].element_size(),
                                               fuse)
    if load == "cp_async":
        lead = 0
    o = tuple(int(v) for v in origin)
    # The copied cells: window z in [lead, lead + WZP) for the TMA box
    # (the part past WZP is the next row's lead, written over below),
    # [0, WZ) for cp.async.
    z_copy = (lead, wzp) if load == "tma" else (0, wz)
    box = ((0, wx), (0, wy), z_copy)
    lo = [max(a, -v) for (a, _), v in zip(box, o)]
    hi = [min(b, n - v) for (_, b), n, v in zip(box, (nx, ny, nz), o)]
    wins = []
    for f in fields:
        w = torch.full((wx, wy, wzp), math.nan, dtype=f.dtype,
                       device=f.device)
        w[:, :, z_copy[0]:z_copy[1]] = 0
        if all(b > a for a, b in zip(lo, hi)):
            w[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = f[
                o[0] + lo[0]:o[0] + hi[0], o[1] + lo[1]:o[1] + hi[1],
                o[2] + lo[2]:o[2] + hi[2]]
        wins.append(w)

    def clamp(v, n):
        return max(0, min(n, v))

    ix = (clamp(-o[0], wx), clamp(nx - o[0], wx))
    iy = (clamp(-o[1], wy), clamp(ny - o[1], wy))
    iz = (clamp(-o[2], wz), clamp(nz - o[2], wz))
    above = (lead, wz)
    boxes = (((0, wx), (0, wy), (0, lead)),
             ((0, ix[0]), (0, wy), above), ((ix[1], wx), (0, wy), above),
             (ix, (0, iy[0]), above), (ix, (iy[1], wy), above),
             (ix, iy, (lead, max(iz[0], lead))),
             (ix, iy, (max(iz[1], lead), wz)))
    for box in boxes:
        if any(b <= a for a, b in box):
            continue
        g = [torch.arange(a, b, device=fields[0].device) + v
             for (a, b), v in zip(box, o)]
        vals = _ghost_values(fields, faces, mode, fuse, boundaries,
                             g[0][:, None, None], g[1][None, :, None],
                             g[2][None, None, :])
        for w, v in zip(wins, vals):
            w[tuple(slice(a, b) for a, b in box)] = v
    return wins


def _ghost_values(fields, faces, mode, fuse, boundaries, gx, gy, gz):
    """Each field's value at the cells (gx, gy, gz) (a broadcast grid)
    as the kernel's ghost pass computes it: the field's own inside the
    operand, else by mode."""
    nx, ny, nz = fields[0].shape
    n_f = len(fields)
    in_x, in_y, in_z = ((g >= 0) & (g < n)
                        for g, n in ((gx, nx), (gy, ny), (gz, nz)))
    shape = torch.broadcast_shapes(gx.shape, gy.shape, gz.shape)

    def at(face, i, j, k):
        return face[i.clamp(0, face.shape[0] - 1),
                    j.clamp(0, face.shape[1] - 1),
                    k.clamp(0, face.shape[2] - 1)]

    out = []
    zero = torch.zeros_like(gx)
    for f in range(n_f):
        dtype = fields[f].dtype
        v = torch.full(shape, boundaries[f], dtype=dtype,
                       device=fields[f].device)
        inside = in_x & in_y & in_z
        v = torch.where(inside, at(fields[f], gx, gy, gz), v)
        if mode == "faces6":
            for axis, (g, n, take) in enumerate((
                    (gx, nx, lambda fc: at(fc, zero, gy, gz)),
                    (gy, ny, lambda fc: at(fc, gx, zero, gz)),
                    (gz, nz, lambda fc: at(fc, gx, gy, zero)))):
                others = [m for a, m in enumerate((in_x, in_y, in_z))
                          if a != axis]
                near = others[0] & others[1]
                lo_face = faces[2 * n_f * axis + 2 * f]
                hi_face = faces[2 * n_f * axis + 2 * f + 1]
                v = torch.where(near & (g == -1), take(lo_face), v)
                v = torch.where(near & (g == n), take(hi_face), v)
        elif mode in ("xchain", "xychain"):
            slab = in_y & in_z
            lo = slab & (gx >= -fuse) & (gx < 0)
            hi = slab & (gx >= nx) & (gx < nx + fuse)
            v = torch.where(lo, at(faces[2 * f], gx + fuse, gy, gz), v)
            v = torch.where(hi, at(faces[2 * f + 1], gx - nx, gy, gz), v)
        out.append(v)
    return out


def _model(spec):
    """The model declaration of a kernel spec; the plain versions also
    take the declaration itself as ``spec`` (they need nothing else, and
    a model the generator refuses has no spec)."""
    return getattr(spec, "model", spec)


def widen_params(params, dtype):
    """``params`` with every scalar cast to ``dtype`` (exact for a
    wider dtype), as the kernel reads its params vector."""
    return type(params)(*(p.to(dtype) for p in params))


def member_params(rows, params_cls, dtype, device=None):
    """Member-stacked params of ``params_cls``: every leaf the members'
    values as an ``(N, 1, 1, 1)`` tensor, which broadcasts against
    ``(N, nx, ny, nz)`` fields in the plain versions. ``rows`` is one
    mapping (field -> value) per member."""
    return params_cls(*(
        torch.tensor([float(r[f]) for r in rows], dtype=dtype,
                     device=device).reshape(-1, 1, 1, 1)
        for f in params_cls._fields))


def params_row(params, member: int):
    """Member ``member``'s params as a solo run holds them (0-d
    leaves)."""
    return type(params)(*(p.reshape(-1)[member] for p in params))


def member_seeds(keys, step: int):
    """The seeds of a batched call: ``(k0s, k1s, step)``, the key words
    of the N members as N-tuples, for ``keys`` = one ``(k0, k1)`` pair
    per member."""
    return (tuple(int(k[0]) for k in keys), tuple(int(k[1]) for k in keys),
            int(step))


def _members(seeds) -> Optional[int]:
    """The member count of a batched call's seeds, None for a solo one."""
    return len(seeds[0]) if isinstance(seeds[0], (tuple, list)) else None


def _stage(pads, params, spec, unit_at, *, use_noise, oracle, out_dtype):
    """One stage on ghost-padded fields ``pads`` (in the stage input's
    dtype): the Plain language's step, or with ``oracle`` the kernel's
    (see the module doc). ``unit_at(dtype)`` draws the unit noise."""
    dtype = pads[0].dtype
    if oracle:
        cdt = compute_dtype_of(dtype)
        pads = tuple(p.to(cdt) for p in pads)
        params = widen_params(params, cdt)
        unit_dtype, acc = cdt, None
    else:
        pdt = params.noise.dtype
        unit_dtype, acc = dtype, (None if pdt == dtype else pdt)
    noise_term = (stencil.scaled_noise(params.noise, unit_at(unit_dtype))
                  if use_noise else 0.0)
    out = stencil.reaction_update(pads, noise_term, params, _model(spec),
                                  compute_dtype=acc)
    if oracle:
        out = tuple(o.to(out_dtype or dtype) for o in out)
    return out


def plain_step(fields, params, seeds, faces=None, *, spec, use_noise=True,
               offsets=None, row=None, oracle=False, out_dtype=None):
    """One step on interior-shaped fields in plain torch (the reference's
    ``_xla_fallback``, or with ``oracle`` the kernel's computation, the
    result in ``out_dtype``, by default the fields' dtype): pad with the
    frozen boundary, or with the 6n ``faces`` of a sharded block, draw
    the step's noise at the block's global ``offsets``, and apply
    :func:`~.stencil.reaction_update`."""
    n_f = spec.n_fields
    if faces is None:
        pads = tuple(
            stencil.pad_with_boundary(f, bv)
            for f, bv in zip(fields, spec.boundaries)
        )
    else:
        pads = tuple(
            pad_from_faces(
                fields[i], faces[2 * i], faces[2 * i + 1],
                faces[2 * n_f + 2 * i], faces[2 * n_f + 2 * i + 1],
                faces[4 * n_f + 2 * i], faces[4 * n_f + 2 * i + 1],
            )
            for i in range(n_f)
        )
    shape = fields[0].shape[-3:]

    def unit_at(dtype):
        return uniform_pm1_block(
            seeds[:2], seeds[2], offsets or (0, 0, 0), shape,
            shape[2] if row is None else row, dtype,
            device=fields[0].device,
        )

    return _stage(pads, params, spec, unit_at, use_noise=use_noise,
                  oracle=oracle, out_dtype=out_dtype)


def plain_chain(fields, params, seeds, *, spec, use_noise=True, fuse=1,
                offsets=None, row=None, oracle=False, mid_bf16=False):
    """``fuse`` plain steps, step ``s`` seeded at ``seeds[2] + s``. With
    ``oracle`` and ``mid_bf16`` (float32 fields), the first ``fuse - 1``
    steps' results are stored as bf16, as the kernel's mid windows are
    under ``GS_MID_BF16=1``."""
    fields = tuple(fields)
    dtype = fields[0].dtype
    mid = mid_dtype_of(dtype, mid_bf16)
    for s in range(fuse):
        fields = plain_step(
            fields, params, (seeds[0], seeds[1], seeds[2] + s), spec=spec,
            use_noise=use_noise, offsets=offsets, row=row, oracle=oracle,
            out_dtype=dtype if s == fuse - 1 else mid,
        )
    return fields


def plain_xchain(fields, params, seeds, faces, *, spec, fuse, use_noise,
                 offsets, row, oracle=False, mid_bf16=False):
    """The x-chain in plain torch (the reference's
    ``_xla_xchain_fallback``, or with ``oracle`` the kernel's
    computation): ``fuse`` stages on the x-extended window ``[lo face |
    block | hi face]``, y and z re-padded with the boundary value each
    stage, and every mid-stage cell whose GLOBAL coordinate (``offsets``
    + local) lies outside ``[0, row)`` on any axis pinned to it. The
    final stage is unpinned: the out-of-domain rows of a y-extended
    operand hold computed values, as in the kernel."""
    n_f = spec.n_fields
    nx, ny, nz = fields[0].shape[-3:]
    dtype, device = fields[0].dtype, fields[0].device
    mid = mid_dtype_of(dtype, mid_bf16)
    k = fuse
    wins = [
        torch.cat([faces[2 * i], fields[i], faces[2 * i + 1]], dim=-3)
        for i in range(n_f)
    ]

    def in_domain(origin, n):
        g = origin + torch.arange(n, device=device)
        return (g >= 0) & (g < row)

    valid_yz = (in_domain(offsets[1], ny)[None, :, None]
                & in_domain(offsets[2], nz)[None, None, :])
    for s in range(k):
        m_out = k - 1 - s
        w_out = nx + 2 * m_out

        def unit_at(dt, s=s, m_out=m_out, w_out=w_out):
            return uniform_pm1_block(
                seeds[:2], seeds[2] + s,
                (offsets[0] - m_out, offsets[1], offsets[2]),
                (w_out, ny, nz), row, dt, device=device,
            )

        wins = list(_stage(
            tuple(F.pad(w, (1, 1, 1, 1), value=bv)
                  for w, bv in zip(wins, spec.boundaries)),
            params, spec, unit_at, use_noise=use_noise, oracle=oracle,
            out_dtype=dtype if s == k - 1 else mid,
        ))
        if s == k - 1:
            break
        valid = in_domain(offsets[0] - m_out, w_out)[:, None, None] & valid_yz
        wins = [torch.where(valid, w, bv)
                for w, bv in zip(wins, spec.boundaries)]
    return tuple(wins)


def _check_faces(faces, shape, n_f, fuse, name) -> str:
    """The reference's arity checks on ``faces``, plus each face's
    shape (the kernel reads them by index); returns the mode."""
    if faces is None:
        return "chain"
    x_chain = len(faces) == 2 * n_f
    if not x_chain and len(faces) != 6 * n_f:
        raise ValueError(
            f"faces for the {n_f}-field model {name!r} must be the "
            f"{2 * n_f}-tuple x-chain form or the {6 * n_f}-tuple 3D "
            f"form; got {len(faces)}"
        )
    if fuse > 1 and not x_chain:
        raise ValueError(
            "temporal blocking with faces requires the x-chain mode "
            "(1D-sharded, two fuse-wide x faces per field); the "
            "full-faces 3D mode is fuse=1 only"
        )
    if x_chain and fuse < 2:
        raise ValueError("the x-chain faces mode requires fuse >= 2")
    lead = tuple(shape[:-3])  # the member axis of a batched call
    nx, ny, nz = shape[-3:]
    if x_chain:
        want = [(fuse, ny, nz)] * len(faces)
    else:
        want = ([(1, ny, nz)] * 2 * n_f + [(nx, 1, nz)] * 2 * n_f
                + [(nx, ny, 1)] * 2 * n_f)
    want = [lead + w for w in want]
    for f, w in zip(faces, want):
        if tuple(f.shape) != w:
            kind = "x-chain" if x_chain else "6n"
            raise ValueError(
                f"{kind} faces must be {w} for a {tuple(shape)} block; "
                f"got {tuple(f.shape)}"
            )
    return "xchain" if x_chain else "faces6"


def fused_step(fields, params, seeds, faces=None, *, spec, use_noise=True,
               fuse=1, offsets=None, row: Optional[int] = None, y_halo=0,
               band=False):
    """``fuse`` fused steps of ``spec``'s model on interior-shaped
    fields (an n-tuple of (nx, ny, nz) tensors in declaration order).

    ``seeds`` is ``(k0, k1, step)``: the key words and the absolute step
    of the first of the ``fuse`` steps, as Python ints. ``offsets`` is
    the block's global origin (default zeros) and ``row`` the global
    grid side (default nz); both key the noise, and the x-chain pins on
    them. ``faces`` is None, the 6n-tuple (fuse=1; axis-major, then
    field-major, then lo/hi; x faces (1, ny, nz), y faces (nx, 1, nz),
    z faces (nx, ny, 1)) or the 2n-tuple x-chain form (fuse >= 2; each
    (fuse, ny, nz)). ``y_halo`` is the depth of the exchanged y halo
    the operand carries — the xy-chain's y-extended operand, whose rows
    cover global ``[offsets[1], offsets[1] + ny)``; it must equal
    ``fuse``, and the launch counts as an ``xychain`` one. ``band``
    marks an x-chain call that recomputes a split-phase round's
    boundary band (a body of k planes or 3k rows): its launch also
    counts in :data:`BAND_LAUNCHES`.

    CUDA tensors go through the kernel (or raise) at the fields' dtype
    (float32, float64 or bfloat16; ``GS_MID_BF16=1`` selects bf16 mids
    for float32); CPU tensors through the plain versions (the Plain
    language). Returns the new field tuple.

    Batched: fields ``(N, nx, ny, nz)``, faces with the same leading
    axis, params from :func:`member_params` and seeds from
    :func:`member_seeds` — one launch advances every member (one count
    in :data:`LAUNCHES`; :data:`MODE_MEMBERS` keeps N).

    While ``obs/trace.hot_armed``, the call adds to the timed counters
    (:func:`timings`), and is a ``gs_launch`` range in a live capture
    once in :data:`LAUNCH_RANGE_EVERY` calls."""
    if not _trace.hot_armed():
        return _fused_step(fields, params, seeds, faces, spec, use_noise,
                           fuse, offsets, row, y_halo, band, None)
    global TIMED_LAUNCHES, DISPATCH_NS, CALL_NS, OPS_NS, _TIMED_CALLS
    timed = _Timed(_TIMED_CALLS % LAUNCH_RANGE_EVERY == 0)
    with _trace.HotRange("gs_launch", timed.record) as launch:
        out = _fused_step(fields, params, seeds, faces, spec, use_noise,
                          fuse, offsets, row, y_halo, band, timed)
    with _LOCK:
        _TIMED_CALLS += 1
        if not getattr(_REPLAYING, "on", False):  # as LAUNCHES counts
            TIMED_LAUNCHES += timed.launches
            CALL_NS += timed.call_ns
            OPS_NS += timed.ops_ns
            DISPATCH_NS += launch.ns - timed.call_ns - timed.ops_ns
    return out


class _Timed:
    """One :func:`fused_step` call's timing under the instrumentation:
    its launches, the nanoseconds in their library calls and operand
    ops, and whether its ranges go into the capture."""

    __slots__ = ("record", "launches", "call_ns", "ops_ns")

    def __init__(self, record: bool):
        self.record = record
        self.launches = self.call_ns = self.ops_ns = 0


def _fused_step(fields, params, seeds, faces, spec, use_noise, fuse,
                offsets, row: Optional[int], y_halo, band, timed):
    """:func:`fused_step`'s work; ``timed`` (a :class:`_Timed`, or None)
    gathers the launches' times."""
    fields = tuple(fields)
    n_f = spec.n_fields
    if len(fields) != n_f:
        raise ValueError(
            f"model {spec.name!r} declares {n_f} field(s); "
            f"got {len(fields)}"
        )
    if fuse < 1:
        raise ValueError(f"fuse must be >= 1, got {fuse}")
    mode = _check_faces(faces, fields[0].shape, n_f, fuse, spec.name)
    if band and (mode != "xchain" or y_halo):
        raise ValueError("a band recompute runs in x-chain mode (2n "
                         f"faces, no y_halo); got mode {mode!r}")
    if y_halo:
        if mode != "xchain" or y_halo != fuse:
            raise ValueError(
                "a y-extended operand (y_halo) is the xy-chain's: it "
                f"takes x-chain faces with y_halo == fuse; got mode "
                f"{mode!r}, y_halo={y_halo}, fuse={fuse}"
            )
        mode = "xychain"
    offsets = tuple(int(o) for o in (offsets or (0, 0, 0)))
    nz = fields[0].shape[-1]
    row = nz if row is None else int(row)
    members = _members(seeds)
    if (fields[0].dim() == 4) != (members is not None) or (
            members is not None and members != fields[0].shape[0]):
        raise ValueError(
            "a batched call takes (N, nx, ny, nz) fields with N-tuples of "
            f"key words; got fields {tuple(fields[0].shape)} and seeds "
            f"{seeds!r}")
    if members == 1 and fields[0].is_cuda:
        # A stack of one member is a solo launch: its host key words and
        # 3-D tensor maps, inside this call's range.
        out = _fused_step(
            tuple(f[0] for f in fields), params_row(params, 0),
            (seeds[0][0], seeds[1][0], seeds[2]),
            None if faces is None else tuple(f[0] for f in faces),
            spec, use_noise, fuse, offsets, row, y_halo, band, timed)
        return tuple(o.unsqueeze(0) for o in out)
    if not fields[0].is_cuda:
        if mode == "chain":
            return plain_chain(fields, params, seeds, spec=spec,
                               use_noise=use_noise, fuse=fuse,
                               offsets=offsets, row=row)
        if mode == "faces6":
            return plain_step(fields, params, seeds, faces, spec=spec,
                              use_noise=use_noise, offsets=offsets, row=row)
        return plain_xchain(fields, params, seeds, faces, spec=spec,
                            fuse=fuse, use_noise=use_noise, offsets=offsets,
                            row=row)
    mid_bf16 = mid_bf16_requested(fields[0].dtype)
    cap = chain_cap(fields[0].dtype, n_f)
    if mode != "chain":
        if fuse > cap:
            raise ValueError(
                f"{mode} depth {fuse} exceeds the shared-memory ledger's "
                f"cap {cap} for {fields[0].dtype}: the exchange width "
                "must be capped with max_feasible_fuse"
            )
        return _launch(fields, params, seeds, spec=spec,
                       use_noise=use_noise, fuse=fuse, offsets=offsets,
                       row=row, faces=faces, mode=mode, mid_bf16=mid_bf16,
                       band=band, timed=timed)
    step = int(seeds[2])
    done = 0
    while done < fuse:
        k = min(cap, fuse - done)
        fields = _launch(fields, params, (seeds[0], seeds[1], step + done),
                         spec=spec, use_noise=use_noise, fuse=k,
                         offsets=offsets, row=row, mid_bf16=mid_bf16,
                         timed=timed)
        done += k
    return fields


def _lib(spec):
    """The loaded library of ``spec``'s generated kernel, its layout
    checked against the ledger and its entry points typed."""
    from . import _build

    lib = _build.load(spec)
    if not getattr(lib, "_gs_ready", False):
        with _build.LOCK:
            if not getattr(lib, "_gs_ready", False):
                _ready(lib, spec)
    return lib


def _ready(lib, spec):
    """Check ``lib``'s layout against the ledger and type its entry
    points (once, under the build lock)."""
    want = TILE + (spec.n_fields, len(spec.param_fields)) + MARCH_LAYOUT
    layout = (ctypes.c_int * len(want))()
    lib.gs_layout.argtypes = [ctypes.c_void_p]
    lib.gs_layout.restype = None
    lib.gs_layout(ctypes.cast(layout, ctypes.c_void_p))
    if tuple(layout) != want:
        raise KernelLaunchError(
            f"the {spec.name!r} kernel's (tile, fields, params, march) "
            f"{tuple(layout)} != the ledger's {want}"
        )
    _type_common(lib)
    lib.gs_kernel_attributes.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.gs_kernel_attributes.restype = ctypes.c_int
    for suffix in ENTRIES.values():
        fn = getattr(lib, f"gs_stencil_chain_{suffix}")
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int]
            + [ctypes.c_uint32] * 3
            + [ctypes.c_int] * 3
            + [ctypes.c_uint32]
            + [ctypes.c_int] * 5
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"gs_stencil_batch_{suffix}")
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_uint32]
            + [ctypes.c_int] * 3
            + [ctypes.c_uint32]
            + [ctypes.c_int] * 5
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    lib._gs_ready = True


def _type_common(lib):
    """Type the entry points every library of the template holds."""
    lib.gs_error_string.argtypes = [ctypes.c_int]
    lib.gs_error_string.restype = ctypes.c_char_p
    lib.gs_window_map.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
    lib.gs_window_map.restype = ctypes.c_int
    lib.gs_window_map4.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
    lib.gs_window_map4.restype = ctypes.c_int
    lib.gs_march_map.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
    lib.gs_march_map.restype = ctypes.c_int


def _pointers(tensors):
    """A host array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def window_maps(lib, fields, fuse, schedule="window"):
    """The load of a launch on ``fields`` at depth ``fuse``: ``(path,
    maps)`` — ``"tma"`` with a host buffer of one encoded tensor map per
    field (cached; 4-D, one member deep, for ``(N, nx, ny, nz)`` fields;
    with ``schedule="march"`` the ring's plane box, ``gs_march_map``), or
    ``"cp_async"`` with None (:func:`load_path`)."""
    first = fields[0]
    itemsize = first.element_size()
    ptrs = tuple(f.data_ptr() for f in fields)
    path = load_path(first.shape[-3:], itemsize, ptrs)
    if path != "tma":
        return path, None
    key = (ptrs, tuple(first.shape), itemsize, fuse, schedule)
    with _LOCK:
        maps = _MAPS.get(key)
    if maps is None:
        maps = (ctypes.c_ubyte * (MAP_BYTES * len(fields)))()
        nx, ny, nz = first.shape[-3:]
        for i, p in enumerate(ptrs):
            out = ctypes.addressof(maps) + MAP_BYTES * i
            if schedule == "march":
                rc = lib.gs_march_map(out, p, itemsize, nx, ny, nz,
                                      first.shape[0] if first.dim() == 4
                                      else 1)
            elif first.dim() == 4:
                rc = lib.gs_window_map4(out, p, itemsize, nx, ny, nz,
                                        first.shape[0], fuse)
            else:
                rc = lib.gs_window_map(out, p, itemsize, nx, ny, nz, fuse)
            if rc != 0:
                raise KernelLaunchError(
                    f"cuTensorMapEncodeTiled failed for a {tuple(first.shape)}"
                    f" {first.dtype} input at depth {fuse}: "
                    + ("the driver has no such entry point" if rc < 0
                       else f"CUresult {rc}"))
        with _LOCK:
            if len(_MAPS) >= _MAPS_LIMIT:
                _MAPS.clear()
            _MAPS[key] = maps
    return path, maps


def maps_address(maps):
    """The host address of a launch's tensor maps, or None (cp.async)."""
    return ctypes.addressof(maps) if maps is not None else None


def count_launch(mode, path, *, entry=None, model=None, band=False,
                 members=1, fuse=None, shape=None, schedule="window"):
    """Count one kernel launch of ``mode`` on load ``path`` under
    ``schedule`` (of entry point ``entry`` and ``model`` at depth
    ``fuse`` on a ``shape`` operand; ``band``: a band recompute;
    advancing ``members`` members), or, inside :func:`replaying`, in
    :data:`REPLAY_LAUNCHES` only. A batched launch counts once."""
    with _LOCK:
        _count_launch(mode, path, entry, model, band, members, fuse, shape,
                      schedule)


def _count_launch(mode, path, entry, model, band, members: int, fuse, shape,
                  schedule):
    global LAUNCHES, BAND_LAUNCHES, REPLAY_LAUNCHES
    if getattr(_REPLAYING, "on", False):
        REPLAY_LAUNCHES += 1
        return
    LAUNCHES += 1
    MODE_LAUNCHES[mode] += 1
    MODE_MEMBERS[mode] = max(MODE_MEMBERS[mode], int(members))
    LOAD_PATH_LAUNCHES[path] += 1
    SCHEDULE_LAUNCHES[schedule] += 1
    if entry is not None:
        DTYPE_LAUNCHES[entry] += 1
        key = (model, mode, entry, int(members), fuse, shape, bool(band))
        ENTRY_LAUNCHES[key] = ENTRY_LAUNCHES.get(key, 0) + 1
    if model is not None:
        MODEL_LAUNCHES[model] = MODEL_LAUNCHES.get(model, 0) + 1
    BAND_LAUNCHES += bool(band)


def _key_array(seeds, device) -> torch.Tensor:
    """The device array of a batched launch's key pairs, as uint32 words
    (int32 storage), cached per device and keys: one copy to the card
    per member set, not per launch."""
    key = (device, seeds[0], seeds[1])
    with _LOCK:
        arr = _KEYS.get(key)
    if arr is None:
        words = [[k & 0xFFFFFFFF for k in pair]
                 for pair in zip(seeds[0], seeds[1])]
        words = [[w - (1 << 32) if w >= 1 << 31 else w for w in pair]
                 for pair in words]
        arr = torch.tensor(words, dtype=torch.int32, device=device)
        with _LOCK:
            if len(_KEYS) >= _KEYS_LIMIT:
                _KEYS.clear()
            _KEYS[key] = arr
    return arr


def _launch(fields, params, seeds, *, spec, use_noise, fuse, offsets, row,
            faces=None, mode="chain", mid_bf16=False, band=False,
            timed=None):
    """One launch of ``spec``'s generated kernel advancing ``fuse``
    steps (``fuse`` <= the ledger's cap) in ``mode``; returns the new
    field tuple. ``(N, nx, ny, nz)`` fields with member seeds launch the
    batched entry point: one launch, N members on the grid's y axis.
    With ``timed`` (:func:`fused_step`'s :class:`_Timed`), the library
    call is a ``gs_launch_call`` range, and the launch, the call's
    nanoseconds and the operand ops' are added there."""
    first = fields[0]
    dtype = first.dtype
    entry = ENTRIES.get((dtype, bool(mid_bf16)))
    if entry is None:
        raise TypeError(
            "the CUDA kernel takes float32, float64 or bfloat16 fields "
            f"(bf16 mids for float32 only), got {dtype}"
            + (" with bf16 mids" if mid_bf16 else "")
        )
    for f in fields:
        if (f.device != first.device or f.dtype != dtype
                or f.shape != first.shape):
            raise ValueError(
                "fields must share device, dtype and shape; got "
                f"{[(t.device, t.dtype, tuple(t.shape)) for t in fields]}"
            )
    members = _members(seeds)
    for f in fields:
        if f.dim() != (3 if members is None else 4) or not f.is_contiguous():
            raise ValueError("fields must be contiguous 3D tensors (4D with "
                             "a leading member axis for a batched launch)")
    nx, ny, nz = first.shape[-3:]
    if first.numel() >= 2**31:
        raise ValueError(f"field shape {tuple(first.shape)} is too large")
    t_ops = _trace.clock_ns() if timed is not None else 0
    face_ptrs = None
    if faces is not None:
        # Exchanged y and z faces are strided views of the stacked
        # slabs; the kernel reads each face densely.
        faces = [f.contiguous() for f in faces]
        for f in faces:
            if f.device != first.device or f.dtype != dtype:
                raise ValueError(
                    "faces must share the fields' device and dtype; got "
                    f"{f.device} {f.dtype} for {first.device} {dtype}"
                )
        face_ptrs = _pointers(faces)
    # The params vector is at least float32, as the reference keeps its
    # SMEM scalars: bf16 fields take float32 params (bf16-valued ones
    # widen exactly) and compute in float32. One stack and at most one
    # cast: the wrapper's launches are host time on every call.
    if members is None:
        params_vec = torch.stack(
            [getattr(params, f) for f in spec.param_fields]
        ).to(device=first.device, dtype=compute_dtype_of(dtype))
    else:
        # One row of params per member, (N, kNP).
        params_vec = torch.stack(
            [getattr(params, f).reshape(-1) for f in spec.param_fields], 1
        ).to(device=first.device, dtype=compute_dtype_of(dtype)).contiguous()
    outs = tuple(torch.empty_like(f) for f in fields)
    if timed is not None:
        timed.ops_ns += _trace.clock_ns() - t_ops
    bounds = (ctypes.c_double * spec.n_fields)(*spec.boundaries)
    lib = _lib(spec)
    in_ptrs, out_ptrs = _pointers(fields), _pointers(outs)
    with torch.cuda.device(first.device):
        schedule = schedule_of(
            mode, fuse, (nx, ny, nz), first.element_size(),
            [t.data_ptr() for t in (*fields, *outs)])
        path, maps = window_maps(lib, fields, fuse, schedule)
        stream = torch.cuda.current_stream(first.device).cuda_stream
        head = (
            ctypes.cast(in_ptrs, ctypes.c_void_p),
            ctypes.cast(out_ptrs, ctypes.c_void_p),
            params_vec.data_ptr(),
            ctypes.cast(face_ptrs, ctypes.c_void_p) if faces else None,
            maps_address(maps),
            ctypes.cast(bounds, ctypes.c_void_p),
            MODES[mode],
        )
        tail = (int(seeds[2]) & 0xFFFFFFFF,
                offsets[0], offsets[1], offsets[2], row & 0xFFFFFFFF,
                nx, ny, nz, fuse, int(bool(use_noise)), stream)
        if members is None:
            fn = getattr(lib, f"gs_stencil_chain_{entry}")
            args = (*head, int(seeds[0]) & 0xFFFFFFFF,
                    int(seeds[1]) & 0xFFFFFFFF, *tail)
        else:
            keys = _key_array(seeds, first.device)
            fn = getattr(lib, f"gs_stencil_batch_{entry}")
            args = (*head, keys.data_ptr(), members, *tail)
        if timed is None:
            rc = fn(*args)
        else:
            with _trace.HotRange("gs_launch_call", timed.record) as call:
                rc = fn(*args)
            timed.call_ns += call.ns
    if rc != 0:
        msg = lib.gs_error_string(rc).decode()
        raise KernelLaunchError(
            f"stencil_chain launch failed (model={spec.name}, mode={mode}, "
            f"fuse={fuse}, shape={tuple(first.shape)}, {entry}, load "
            f"{path}, {schedule}): CUDA error {rc}: {msg}", code=rc)
    count_launch(mode, path, entry=entry, model=spec.name, band=band,
                 members=members or 1, fuse=fuse, shape=(nx, ny, nz),
                 schedule=schedule)
    if timed is not None:
        timed.launches += 1
    return outs


def kernel_attributes(spec, mode: str, entry: str, fuse: int,
                      device=None) -> dict:
    """The card's attributes of the kernel instance ``spec``'s entry
    point ``entry`` launches in ``mode`` at depth ``fuse``
    (``gs_kernel_attributes``: ``cudaFuncGetAttributes`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; launches
    nothing; ``chain`` at depth 1: the march, which a launch on the TMA
    path runs): ``registers``, ``local_bytes``, ``static_shared_bytes``,
    ``max_threads_per_block``, ``dynamic_shared_bytes`` (what such a
    launch requests), ``blocks_per_sm`` and ``threads_per_block``.
    Raises :class:`KernelLaunchError` when the query fails."""
    lib = _lib(spec)
    out = (ctypes.c_int * 7)()
    index = list(ENTRIES.values()).index(entry)
    with torch.cuda.device(device if device is not None else 0):
        rc = lib.gs_kernel_attributes(index, MODES[mode], int(fuse),
                                      ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise KernelLaunchError(
            f"gs_kernel_attributes({entry}, {mode}, fuse={fuse}) failed: "
            f"CUDA error {rc}: {lib.gs_error_string(rc).decode()}", code=rc)
    return dict(zip(("registers", "local_bytes", "static_shared_bytes",
                     "max_threads_per_block", "dynamic_shared_bytes",
                     "blocks_per_sm", "threads_per_block"),
                    (int(v) for v in out)))
