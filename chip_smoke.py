#!/usr/bin/env python3
"""Smoke run of ``grayscott_jl_tpu_torch`` on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and
``nvcc``. Every model's stencil kernel is generated from its reaction
(``ops/kernelgen.py``) into the template ``ops/csrc/stencil_chain.cu``.
Phases, each of which stops the run on failure:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build the generated kernel of every registered model (grayscott,
   brusselator, fhn, heat; one ``nvcc`` per model, all started
   together), timed;
3. every model's kernel in every mode against its plain torch version on
   the card: float32 and float64, and bfloat16 fields with bf16 params
   (``BFloat16``) and with float32 params (``bf16_f32acc``) against the
   oracle form of the plain version (widen, compute in float32, round
   once per stage), noise 0 and 0.1, every chain depth up to the
   model's shared-memory ledger cap (8 for two bf16 fields, 12 for
   one); and the float32 chain with bf16 mid windows (``GS_MID_BF16=1``,
   depth 2..cap at L = 100 and 256, and the xy-chain operand) against
   its oracle. The single-block chain at
   L = 64, 100 (ragged tiles) and 256, 12 steps from random fields,
   bitwise equal and depth k bitwise equal to k launches of depth 1;
   the 6n-face step at blocks (128,128,128) and (100,64,96), the x-chain
   at (32,256,256) and (34,100,100), and the xy-chain operand
   (128,128+2k,128) with ``offsets[1] = -k``, from random fields and
   faces, bitwise equal over the whole output. Every check runs on each
   window load the operand takes (``cuda_stencil.override``): TMA and
   cp.async; the L = 41 chain and the (20,24,41) 6n-face and (10,24,41)
   x-chain operands (rows of 41 cells, which TMA refuses) on cp.async;
   and Gray-Scott's x-chain on the split rounds' band bodies (k planes
   or 3k rows, thinner than a tile, at depth 2 and 4) against
   ``plain_xchain``; and the batched launch (``phase_batch_parity``: 3
   members on the grid's y axis, each its own params row and key pair)
   of the chain at depth 1 and 2, the 6n-face step, the x-chain, the
   xy-chain operand and a band body, float32, float64, bf16 and bf16
   mids, on each load path, one launch each, bitwise equal to the plain
   version with the same leading axis (bf16: its oracle) and to three
   solo launches;
4. the main paths, with the kernel launch counts set to 0 just before
   each and read just after. Gray-Scott: ``driver.main`` on an L=256
   float32 config with noise, plotgap 50, a checkpoint every 100 steps,
   200 steps, then the store read back (ranges, and bitwise equal to
   the plain path on the card), and a restart from the step-100
   checkpoint that must reproduce the stored step 200 bitwise; then the
   sharded main path: ``driver.run_once`` with a ``sim_factory`` that
   puts a (2,2,2) mesh's 8 blocks on ``cuda:0``, the same config at
   depth 1 — exactly 8 x 200 launches of the 6n-face kernel, a store
   equal to the single-block store bitwise at every step, and a restart
   from its step-100 checkpoint that reproduces step 200 bitwise; then
   50 steps at ``GS_FUSE=2`` on (8,1,1) (x-chain), (2,2,2) (xy-chain
   with z bands) and (2,2,1) (xy-chain slab form), each bitwise equal to
   the stored step 50, and L=250 on (3,1,1) (pad-and-mask) bitwise equal
   to a single-block run, its windows loaded by cp.async (1,000 B
   rows) — these ``GS_FUSE=2`` runs with ``comm_overlap = "off"``, the
   fused round; the Gray-Scott single-block and mesh paths all by TMA
   (``LOAD_PATH_LAUNCHES``). The other models, each with the physics of
   its ``examples/settings-<model>.toml`` (dt 0.05) at L=256, noise 0.1,
   ``kernel_language = "Auto"``: brusselator 100 steps (plotgap and
   checkpoint every 50), fhn and heat 50 steps (plotgap and checkpoint
   every 25) — every launch the model's generated kernel, the store
   bitwise equal to the plain path on the card, a restart from the last
   checkpoint before the end reproducing it, the (2,2,2) mesh on
   ``cuda:0`` (8 6n-face launches per step) and ``GS_FUSE=2`` on (8,1,1)
   and (2,2,2) up to the first stored step bitwise equal to the single
   block. The bf16 paths:
   ``precision = "BFloat16"`` at L=256, 200 steps (200 launches of the
   bf16 entry point, a store of bf16 values named ``"bfloat16"`` bitwise
   equal to the kernel's oracle run on the card, a bitwise restart, and
   ``GS_FUSE=2`` on (8,1,1) and (2,2,2) equal to its step 50);
   ``compute_precision = "bf16_f32acc"`` with ``snapshot_bits = "8"``,
   single block and a (2,2,2) mesh on ``cuda:0`` (the coded output
   within its error bound of the exact checkpoints, the mesh's payloads,
   ranges and checkpoints equal to the single block's); and
   ``GS_MID_BF16=1`` at ``GS_FUSE=2`` (100 launches of the bf16-mid
   entry point, the store equal to the oracle in the same rounds); and
   the blow-up configuration (ROADMAP F1: L=16, dt=400) that the health
   guard stops at step 10 with no step written (``warn`` writes both),
   at the output pipeline's default depth 2. Every main path writes
   through the pipeline (``io/async_writer.py``) and the native C++
   store engine (``io/native.py``, built with g++ at first use). Then
   (i) the output pipeline: Gray-Scott's config (a) (L=256, 200 steps,
   plotgap 50, a checkpoint every 100) at ``GS_ASYNC_IO_DEPTH`` 0 and 2,
   the single block in the order 0, 2, 2, 0 and the (2,2,2) mesh on
   ``cuda:0`` 0, 2: every run's files byte-identical to the other
   depth's and its store bitwise equal to phase 4's, the engine native,
   every device or stream synchronise on the driver thread (the writer
   waits on copy events), with wall, output, hidden and exposed
   seconds; (ii) integrity on (a) at depth 2 with
   ``GS_CKPT_VERIFY=full``, ``GS_CKPT_REPLICAS=2`` and ``GS_SCRUB=1``
   and the primary's step-100 checkpoint corrupted mid-run: the device
   checksums equal the host checksums of every stored step, the scrub
   quarantines the entry, a restart from step 100 fails over to the
   mirror and reproduces step 200 bitwise, the bitflip hook at step 100
   raises ``CorruptionError`` with only step 50 written, and the
   checksum's device time at L=256 (CUDA events) and the read-back's
   seconds; and F2 at depth 2 (a SIGTERM mid-run: a checkpoint at the
   next boundary, then a bitwise restart); (iii) the sharded round's
   exchange schedule (``phase_overlap``): the split-phase round at
   ``GS_FUSE=2`` on (8,1,1), (2,2,1) and (2,2,2) — per block and round
   the interior launch and two (x-chain) or four (xy-chain) band
   launches of the x-chain kernel, counted in ``BAND_LAUNCHES`` — and
   the same meshes fused (``comm_overlap = "off"``), L=250 split on
   (3,1,1), ``GS_HALO_DEPTH=2`` at depth 1 (half the exchange rounds)
   and at ``GS_FUSE=2`` (depth 4), ``GS_HALO_DEPTH=3`` stepping down
   to 2 with its warning, and ``driver.run_once`` of (b) at
   ``GS_FUSE=2 GS_HALO_DEPTH=2`` under "auto": every store bitwise equal
   to the single block's, every launch count exact; (iv) the run of
   several processes (``phase_multiprocess``): (b) as two processes of
   four blocks sharing ``cuda:0`` over gloo, through ``launch.py`` — its
   two-writer store bitwise equal to (b)'s, its ``.pvti`` pieces
   reassembling to the store, its checkpoint merged and a two-process
   restart from step 100 reproducing step 200, the processes' launches
   adding up to (b)'s — then, in one pair of processes, ``GS_FUSE=2`` on
   (8,1,1) and (4,2,1), split and fused, bitwise equal to their
   one-process runs with the launches adding up, and (b) once more,
   warm, for the 2-process ms/step and the cross-process exchange's
   host ms/step; (v) the observability sinks (``phase_obs``): (a) and
   (b) with obs off, on, on, off (``GS_EVENTS``, ``GS_METRICS`` at
   0.05 s, ``GS_METRICS_PROM``, ``GS_TRACE``, ``GS_NUMERICS=boundary``),
   every store byte-identical and equal to phase 4's, the trace valid,
   the events holding run_start, an output and a numerics record per
   stored step, a checkpoint per checkpoint step and run_complete, the
   Prometheus dump ``step_latency_us``, each numerics report's min/max
   equal to a float64 numpy recomputation from the stored step and
   mean/l2 within 1e-5 of it; (a) at ``GS_NUMERICS=every_round`` under
   ``GS_DRIFT_POLICY=abort`` with ``poison_drift`` after step 100,
   raising ``DriftError`` with only step 50 stored; the probe's device
   time on the L=256 fields beside its bound, and ``numerics_stats``'
   host ms on (a) and (b); (vi) the resilience layer
   (``phase_resilience``): (a) supervised (``GS_RESTART_BACKOFF_S=0``)
   under each fault plan — preempt at 120 with every sink armed,
   io_error at 50, nan at 120 under ``health_policy = "rollback"``,
   drift at 120 under ``GS_DRIFT_POLICY=rollback``, kernel at 160
   (fatal: ``gave_up`` and the error re-raised, then the user's relaunch
   from the step-100 checkpoint), ckpt_corrupt with two replicas,
   bitflip under ``GS_CKPT_VERIFY=full`` — each journal in the
   reference's order (the kernel plan's ends in ``gave_up``), each
   store equal file for file to phase 4's, launches counted and no
   degradation; (b) preempted at 120;
   (a) hung at 150 under a 5 s step-round deadline (``HangError``, the
   stacks journaled); (a) through the CLI in a subprocess sent SIGTERM
   after its step-100 checkpoint (exit 75) and relaunched (resumed from
   the marker); the SDC screen: (a) at ``spot`` and (b) at ``shadow``
   against ``off`` (stores equal, ``shadow_degraded`` on one card, the
   replays' launches equal to the run's and counted apart), one
   ``sdc`` flip caught and attributed to ``cuda:0`` block 0 and resumed
   from the verified step, two flips quarantining ``cuda:0`` until the
   supervisor gives up; with the time from each failure to the next
   attempt's first step, the card's allocated bytes and the pinned ring
   bytes at each attempt (flat), and the device ms of one replay and
   checksum of a 50-step chunk on (a) and (b) beside the chunk; (vii)
   elastic resharding (``phase_reshard``): (b) checkpointed at step 100
   on (2,2,2) and restarted in the same stores on (1,2,2) (4 x 100
   ``kFaces6`` launches after the restart), (b) moved live (2,2,2) ->
   (1,2,2) -> (2,2,2) at steps 50 and 150 through ``reshape_poll`` (8,
   then 4, then 8 launches a step), and (a) moved from its single block
   onto (2,2,2) at step 100, every store's assembled arrays bitwise and
   ``.vtk`` series byte-identical to phase 4's; each move's path, bytes
   and wall, the driver's whole move between rounds, and the relayout's
   device time at L=256 (CUDA events, profiler) beside its byte bound;
   (viii) Auto's decision (``phase_auto``; ``GS_AUTOTUNE_CACHE`` in the
   workdir, as for the whole run): (a) under ``kernel_language =
   "Auto"`` through ``driver.main`` with ``GS_AUTOTUNE=quick`` (budget
   60 s) — at least 2 candidates timed, each one's projected against
   measured µs/step printed, the run's launches exactly the adopted
   depth's and the tuning's exactly its candidates' rounds — then
   ``cached`` (a hit, 0 timed, the same depth); eight blocks on
   ``cuda:0`` with the mesh not pinned, the split round armed and off
   (the fabric model's mesh and
   depth adopted, the launches per mode equal to that schedule pinned,
   ``RunStats.comm`` its mesh's, projected against measured ms/step of
   it and of (2,2,2) at depth 1) and pinned at (2,2,2) (the analytic
   pick is depth 1, ``kFaces6``); (a) moved onto (2,2,2) at step 100
   (``RunStats.comm`` the new mesh's); every store equal to phase 4
   (a)'s (arrays bitwise, ``.vtk`` byte-identical, the checkpoint's
   layout record aside); (ix) ensembles (``phase_ensemble``): the five
   presets of ``examples/settings-ensemble-phases.toml`` at config (a)'s
   size through ``driver.run_once`` — 200 ``kBlock`` launches of 5
   members, solo (a)'s count — every member's stores byte-equal to a
   solo run of it; three members on (2,2,2) on ``cuda:0`` (1,600
   ``kFaces6`` launches of 3 members), on (8,1,1) at ``GS_FUSE=2`` fused
   and on (2,2,1) at ``GS_FUSE=2`` split (the xy-chain operand and its
   bands), 50 steps, each run's counts and stores the solo runs';
   ``member_shards = 2`` with four blocks of (2,2,1) per group on
   ``cuda:0``; chaos scenario 4 and the ensemble half of 5 at L=64, a
   ``nan`` at ``GS_FAULT_MEMBER=3`` named as member 3 under
   ``rollback`` (stores equal to the unfaulted run's), a live shrink 5
   -> 4 bitwise; and one batched ``kBlock`` launch at N = 1, 2, 5 at
   L=256 (CUDA events, profiler device time per member, host ms a
   call), with (a)'s compute ms/step against its five solo runs' and its
   steady ms/step without output, batched against the five solo runs in
   turn; (x) observability and member groups across processes, run
   right after (a) so that its profiler window is the process's first
   capture: (x-a) (``phase_observability``) (a) four times through
   ``driver.main`` — with nothing armed, with ``GS_XSTATS=1``, ``GS_PROFILE=50:150`` and a
   fresh ``GS_COMPILE_CACHE`` (the Gray-Scott kernel library and the
   native store engine each a ``miss`` with its build seconds, one
   launch record for the ``kBlock`` f32 entry with the card's registers,
   shared bytes and blocks per SM and row 1a's bytes and flops, the
   window's Chrome trace holding exactly the 100 launches of steps
   50-150), again on the same cache (every library a ``hit``, 0 s), and
   with ``GS_TPU_PROFILE`` alone (all 200 launches in its trace) — every
   store bitwise equal to (a)'s and byte-identical across the runs, then
   ``python -m grayscott_jl_tpu_torch.obs.report`` checking and
   rendering run 1's stats and events (exit 0), the walls against (a)'s,
   the build seconds and the launch record printed beside the card's
   name and power limit; (x-b) (``phase_member_procs``) four presets at
   L=256 with ``member_shards = 2``, 50 steps: one process (two groups
   of one block on ``cuda:0``), two processes over gloo on ``cuda:0``
   through ``launch.py`` (one group each, 50 batched ``kBlock`` launches
   of 2 members each) with every member's stores bitwise equal to the
   one-process run's, and the one-process run moved live onto (2,1,1)
   per group under ``GS_RESHARD_DEVICE=auto`` (``collective``), its
   stores equal to the unmoved run's; (xi) serving (``phase_serve``,
   right after (ix)): the service (``serve/``) in-process on port 0 with
   ``backend = "CUDA"``, a fresh state directory and unsupervised batches.
   (xi-a) three Gray-Scott jobs of one pack key over HTTP — L=256, the
   reference's ``GS_SERVE_MAX_L`` cap, 100 steps, plotgap 50, a
   checkpoint every 50, noise 0.1, three (F, k) and seeds — form one
   batch of 4 slots: exactly 100 batched ``kBlock`` f32 launches of 4
   members (``MODE_MEMBERS``, ``ENTRY_LAUNCHES``), no store of the idle
   slot, ``/field`` at ``sim_step`` 100, and each member's ``.bp``,
   ``.vtk`` and checkpoint trees byte-identical to that job's solo
   ``driver.main`` run on the card (``kernel_language = "CUDA"``); (xi-b)
   a second batch of the shape is a warm hit (no new engine, no build),
   job 1's spec again answers ``cache="hit"`` with its store and no
   launch, and a flipped byte of that store under ``GS_CACHE_VERIFY=1``
   drops the entry and the job recomputes into the same bytes; (xi-c)
   chaos scenario 6 at L=64 (the worker killed mid-batch, the stores
   byte-identical to an uninterrupted service's); (xi-d) a front door
   with no local worker and one ``--role worker`` process on ``cuda:0``
   sharing a fleet directory: job 1 again, its stores equal (xi-a)'s.
   ``obs/report --check`` passes on the service's stream and on the
   fleet's merged stream. Printed beside the card's name and power
   limit: the batch's wall against the three solo walls, request to
   first step cold and warm, the cache hit's round trip, and one N=4
   batched launch's CUDA-event time against its bound (4 x 0.0801 ms);
   (xii) the analysis workflow (``phase_analysis``, after (xi)): the
   CLI's entry on an L=256 float32 config, noise 0.1, 40 steps, plotgap
   10, while ``analysis/pdfcalc`` streams its store live from another
   thread at 1,000 bins with the histograms on the card — exactly 40
   ``kBlock`` f32 launches, 4 PDF steps whose every U and V histogram
   is bitwise equal to the CPU path's on the stored block, each slice
   counting 256^2 cells, three pinned blocks (``pdf_blocks``: one where
   a division by a host scalar moves cells, float64, a NaN) equal on
   the card and the CPU, and ``gdsplot``'s slice (its PNGs where
   matplotlib is installed); printed beside the card's name and power
   limit: ``compute_pdf``'s ms per field on the card (CUDA events) and
   on the CPU, and the streaming wall;
5. times at the main path's shapes (Gray-Scott: float32, L=256 at every
   chain depth and L=512 at depths 1 and 2, and each face mode at the sharded path's block
   shapes; the other models: L=256 at depth 1): the kernel (CUDA
   events, after warm-up, and the profiler's device time), its plain
   version, and the least time the card could take (each field read
   and written once over the memory rate, or the generated program's
   floating-point operations over the float32 rate); and the sharded
   path's ms per step on one card against the single block's, with the
   halo exchange timed on its own, the split round against the fused one
   and halo depth 1, 2 and 4 (with the profiler's busy share and the
   time the exchange's stream ran beside the kernel), and each band
   body's launch; then row 1f: the bf16 kernel at
   L=256 depth 1 and each bf16 face mode (bound: 2 B a cell a field),
   and the float32 chain with bf16 mids at depth 2..5 beside the exact
   float32 chain, interleaved; the window load's two paths in turns
   (TMA, cp.async) on the L=256 chain and the (128,128,128) 6n-face
   step, float32 and bf16; and the health probe's cost: the L=256
   single block's boundary snapshot with and without it, in turns;
6. the envelope probes (``ops/envelope.py``, built into Gray-Scott's
   second library in phase 2): the copy walk equal to its input bitwise
   at L = 256, (20,24,40) and (20,24,41), depth 1..5, on each load path
   the operand takes; the compute walk and its six
   variants equal to their plain versions bitwise on the defined tile
   (and the default to the production chain's tile (0,0,0)) at the same
   shapes, depths and noise 0 and 0.1; then the probe's entry point,
   ``probes/envelope_probe.main``, at L=256 noise 0.1, depth 1 and 2
   with the variants (``GS_PROBE_COMPUTE_VARIANTS=1``), depth 3 and 4,
   depth 5 with the variants, and
   L=512 depth 1, each with the launch counts set to 0 just before and
   read just after (one launch per pass of each probe case); the probe
   kernels' device times under the profiler and their plain versions'
   times at L=256 depth 1.

Prints the ensemble phase's numbers as a JSON line, the serving phase's
as another, the analysis phase's as a third, the kernels' JSON
line (each kernel with the load path its main path took, and for the
production modes the member count and launches of the ensemble phase's
batched runs), then the ``nvidia-smi`` line, then the
result line ``{"ok": true, "device": {...}}`` last; writes the full
report to ``chiprun_out/chip_smoke_report.json``. Exits non-zero with
no result line when there is no card or any phase fails. Imports
neither JAX nor the JAX package.

The bounds come from ``grayscott_jl_tpu_torch/obs/xstats.py``
(``bound_ms``, ``bound_of``, ``face_mode_work``), the reckoning the
launch records carry too.
"""

import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

MAIN_L = 256
MAIN_STEPS = 200
MESH = (2, 2, 2)
REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "grayscott_jl_tpu_torch/ops/csrc/stencil_chain.cu"

#: The kernels line's entries: kernel mode -> the TPU kernel it
#: replaces (the ``pl.pallas_call`` of ``_fused_call`` and the mode's
#: branch of ``_make_kernel``); the other models' kernels replace the
#: reference's generator.
REPLACES = {
    "chain": "grayscott_jl_tpu/ops/pallas_stencil.py:848",
    "faces6": "grayscott_jl_tpu/ops/pallas_stencil.py:636",
    "xchain": "grayscott_jl_tpu/ops/pallas_stencil.py:663",
    "xychain": "grayscott_jl_tpu/parallel/temporal.py:422",
    "generated": "grayscott_jl_tpu/ops/kernelgen.py:136",
    "bf16": "grayscott_jl_tpu/ops/pallas_stencil.py:173",
    "mid_bf16": "grayscott_jl_tpu/ops/pallas_stencil.py:181",
    "dma_walk": "benchmarks/envelope_probe.py:164",
    "compute_walk": "benchmarks/envelope_probe.py:400",
}

#: The operand shape each face-mode kernel takes on its main path (the
#: others take L^3 fields).
MAIN_SHAPES = {"stencil_faces6": (128, 128, 128),
               "stencil_xchain": (32, 256, 256),
               "stencil_xychain": (128, 132, 128),
               "stencil_xchain_band": (128, 6, 128)}

#: The envelope probe's runs in phase 6: (L, depth, with the variants).
PROBE_RUNS = ((MAIN_L, 1, True), (MAIN_L, 2, True), (MAIN_L, 3, False),
              (MAIN_L, 4, False), (MAIN_L, 5, True), (512, 1, False))
PROBE_STEPS = 20
PROBE_ROUNDS = 3

#: Gray-Scott's physics in the kernel checks and its main path.
GS_PHYSICS = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0)

#: The other models' physics (examples/settings-<model>.toml) and their
#: main paths: (steps, plotgap, checkpoint_freq).
PHYSICS = {
    "brusselator": {"A": 1.0, "B": 3.0, "Du": 0.2, "Dv": 0.02},
    "fhn": {"a": 0.7, "b": 0.8, "eps": 0.08, "I": 0.5, "Dv": 0.2,
            "Dw": 0.0},
    "heat": {"D": 0.2},
}
MODEL_PATHS = {"brusselator": (100, 50, 50), "fhn": (50, 25, 25),
               "heat": (50, 25, 25)}
MODELS = ("grayscott",) + tuple(MODEL_PATHS)

#: The parity phases' precision cases: (label, field dtype, params dtype,
#: compared with the kernel's oracle form of the plain version). float32
#: and float64 compare with the plain version itself (the same
#: computation); bf16 fields with bf16 params are ``BFloat16``, with
#: float32 params ``bf16_f32acc``.
PRECISION_CASES = (
    ("Float32", "float32", "float32", False),
    ("Float64", "float64", "float64", False),
    ("BFloat16", "bfloat16", "bfloat16", True),
    ("bf16_f32acc", "bfloat16", "float32", True),
)


def physics(name):
    """Settings keywords of model ``name``'s physics."""
    if name == "grayscott":
        return dict(GS_PHYSICS)
    return dict(model=name, model_params=dict(PHYSICS[name]), dt=0.05)


def log(msg):
    print(msg, flush=True)


def value_from_env(name, default=None):
    """The value of ``name`` in this process's environment, or
    ``default``: the variables a phase sets, saved to be put back."""
    return os.environ.get(name, default)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def timed(report, key, fn, *args, clean=None):
    """``fn(*args)``, its wall seconds recorded under ``report["phase_s"]``
    and logged. ``clean``: a work directory whose entries the phase adds
    are removed once it has returned (its checks done), so that the next
    phases write over freed blocks: a phase 4 run writes ~1.25 GiB, and
    the smoke's stores add up to ~66 GiB, more than a disk may take."""
    before = set(os.listdir(clean)) if clean else set()
    t0 = time.perf_counter()
    out = fn(*args)
    seconds = time.perf_counter() - t0
    report.setdefault("phase_s", {})[key] = seconds
    log(f"  [{key}: {seconds:.1f} s]")
    if clean:
        for name in set(os.listdir(clean)) - before:
            path = os.path.join(clean, name)
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
    return out


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _xstats():
    """``grayscott_jl_tpu_torch.obs.xstats``: the one reckoning of a
    launch's bytes, operations and least time (the build and launch
    analytics' records use it too)."""
    from grayscott_jl_tpu_torch.obs import xstats

    return xstats


def bound_ms(L, fuse, flops, itemsize=4, n_fields=2):
    """Least time of one launch advancing ``fuse`` steps on L^3
    (``xstats.bound_ms``) and which bound it is."""
    return _xstats().bound_ms(L, fuse, flops, itemsize, n_fields)


def bound_of(bytes_moved, flops):
    """Least time (ms) for ``bytes_moved`` bytes and ``flops`` float32
    operations on the card (``xstats.bound_of``)."""
    return _xstats().bound_of(bytes_moved, flops)


def face_mode_work(mode, shape, fuse, flops, itemsize=4, n_fields=2):
    """Bytes and float operations of one face-mode launch
    (``xstats.face_mode_work``)."""
    return _xstats().face_mode_work(mode, shape, fuse, flops, itemsize,
                                    n_fields)


def group(label):
    """The kernels-line group of a precision case: ``bf16`` for bf16
    fields, else ``f``."""
    return "bf16" if label in ("BFloat16", "bf16_f32acc") else "f"


def took(report, cuda_stencil, name):
    """Record the window load path kernel-line entry ``name`` took on its
    main path, read from ``LOAD_PATH_LAUNCHES`` just after that run
    (counts set to 0 just before it): every launch of the run must have
    gone through one path. Returns the path."""
    counts = dict(cuda_stencil.LOAD_PATH_LAUNCHES)
    total = cuda_stencil.LAUNCHES
    paths = [p for p, n in counts.items() if n]
    check(total > 0 and len(paths) == 1 and counts[paths[0]] == total,
          f"{name}: {total} launches loaded their windows {counts}, not "
          "all by one path")
    report.setdefault("load_path", {})[name] = {"path": paths[0],
                                                "launches": total}
    return paths[0]


def loads(torch, cuda_stencil, shape, dtype):
    """The load paths a parity check runs on an operand of ``shape``: TMA
    and cp.async where TMA takes the operand, cp.async alone where it
    refuses it."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if cuda_stencil.load_path(shape, itemsize, (0,)) == "tma":
        return ["tma", "cp_async"]
    return ["cp_async"]


def phase_parity(torch, gs, cuda_stencil, spec, report):
    """Kernel vs its plain version (for bf16 fields its oracle form),
    bitwise, and depth k vs k x depth 1, for the model of ``spec`` in
    every precision case; returns the worst |diff| per group."""
    steps = 12
    worst = {"f": 0.0, "bf16": 0.0}
    rows = []
    for prec, dname, pname, oracle in PRECISION_CASES:
        dtype, pdtype = getattr(torch, dname), getattr(torch, pname)
        cap = cuda_stencil.chain_cap(dtype, spec.n_fields)
        for L in (41, 64, 100, 256):
            for noise in (0.0, 0.1):
                settings = gs.Settings(L=L, noise=noise, **physics(spec.name))
                params = spec.model.make_params(settings, pdtype, "cuda")
                gen = torch.Generator(device="cuda").manual_seed(1000 + L)
                f0 = tuple(
                    torch.rand((L, L, L), generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
                    for _ in range(spec.n_fields)
                )
                seeds = (0, 11, 40)
                plain = cuda_stencil.plain_chain(
                    f0, params, seeds, spec=spec, use_noise=noise != 0,
                    fuse=steps, row=L, oracle=oracle,
                )
                by_fuse = {}
                for fuse in range(1, cap + 1):
                    for load in loads(torch, cuda_stencil, (L,) * 3, dtype):
                        f, done = f0, 0
                        with cuda_stencil.override(load):
                            while done < steps:
                                k = min(fuse, steps - done)
                                f = cuda_stencil.fused_step(
                                    f, params, (0, 11, 40 + done), spec=spec,
                                    use_noise=noise != 0, fuse=k, row=L,
                                )
                                done += k
                        torch.cuda.synchronize()
                        err = max(
                            (a.double() - b.double()).abs().max().item()
                            for a, b in zip(f, plain)
                        )
                        worst[group(prec)] = max(worst[group(prec)], err)
                        what = (f"{prec} L={L} noise={noise} fuse={fuse} "
                                f"load {load}")
                        check(all(torch.isfinite(a).all().item() for a in f),
                              f"non-finite {spec.name} kernel output {what}")
                        check(all(a.dtype == dtype and torch.equal(a, b)
                                  for a, b in zip(f, plain)),
                              f"{spec.name} kernel != plain: {what}, max "
                              f"|diff| {err}")
                        by_fuse.setdefault(fuse, f)
                        rows.append([prec, L, noise, fuse, load, err])
                for fuse, f in by_fuse.items():
                    check(all(torch.equal(a, b)
                              for a, b in zip(f, by_fuse[1])),
                          f"{spec.name} fuse={fuse} != {fuse} x fuse=1: "
                          f"{prec} L={L}")
        log(f"  {spec.name} {prec} L=41/64/100/256 noise 0/0.1: fuse "
            f"1..{cap}, on each load path the operand takes, bitwise equal "
            f"to {'the oracle' if oracle else 'plain'} and to k x fuse=1")
    report.setdefault("parity", {})[spec.name] = rows
    return worst


def phase_mid_bf16_parity(torch, gs, cuda_stencil, spec, report):
    """``GS_MID_BF16=1``: the float32 chain with bf16 mid windows at
    every depth 2..cap, and the xy-chain operand, bitwise equal to the
    oracle (the same rounds of the plain chain, mid stages stored as
    bf16); returns the worst |diff|."""
    os.environ["GS_MID_BF16"] = "1"
    worst = 0.0
    rows = []
    try:
        cap = cuda_stencil.chain_cap(torch.float32, spec.n_fields)
        gen = torch.Generator(device="cuda").manual_seed(77)
        for L in (100, 256):
            for noise in (0.0, 0.1):
                params = spec.model.make_params(
                    gs.Settings(noise=noise, **physics(spec.name)),
                    torch.float32, "cuda")
                f0 = tuple(torch.rand((L, L, L), generator=gen, device="cuda")
                           for _ in range(spec.n_fields))
                for fuse, load in (
                        (k, path) for k in range(2, cap + 1)
                        for path in loads(torch, cuda_stencil, (L,) * 3,
                                          torch.float32)):
                    got = want = f0
                    for done in range(0, 2 * fuse, fuse):
                        seeds = (0, 11, 40 + done)
                        with cuda_stencil.override(load):
                            got = cuda_stencil.fused_step(
                                got, params, seeds, spec=spec,
                                use_noise=noise != 0, fuse=fuse, row=L)
                        want = cuda_stencil.plain_chain(
                            want, params, seeds, spec=spec,
                            use_noise=noise != 0, fuse=fuse, row=L,
                            oracle=True, mid_bf16=True)
                    torch.cuda.synchronize()
                    err = max((a - b).abs().max().item()
                              for a, b in zip(got, want))
                    worst = max(worst, err)
                    check(all(torch.equal(a, b) for a, b in zip(got, want)),
                          f"{spec.name} GS_MID_BF16 chain != oracle: L={L} "
                          f"noise={noise} fuse={fuse} load {load}, max "
                          f"|diff| {err}")
                    rows.append(["chain", L, noise, fuse, load, err])
        shape = (64, 64, 64)
        for k in range(2, cap + 1):
            nx, ny, nz = shape[0], shape[1] + 2 * k, shape[2]
            f = tuple(torch.rand((nx, ny, nz), generator=gen, device="cuda")
                      for _ in range(spec.n_fields))
            faces = tuple(torch.rand((k, ny, nz), generator=gen,
                                     device="cuda")
                          for _ in range(2 * spec.n_fields))
            params = spec.model.make_params(
                gs.Settings(noise=0.1, **physics(spec.name)),
                torch.float32, "cuda")
            got = cuda_stencil.fused_step(
                f, params, (0, 11, 40), faces, spec=spec, fuse=k,
                offsets=(64, -k, 0), row=MAIN_L, y_halo=k)
            want = cuda_stencil.plain_xchain(
                f, params, (0, 11, 40), faces, spec=spec, fuse=k,
                use_noise=True, offsets=(64, -k, 0), row=MAIN_L,
                oracle=True, mid_bf16=True)
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            worst = max(worst, err)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"{spec.name} GS_MID_BF16 xy-chain != oracle: k={k}, "
                  f"max |diff| {err}")
            rows.append(["xychain", list(shape), 0.1, k, err])
    finally:
        del os.environ["GS_MID_BF16"]
    log(f"  {spec.name} GS_MID_BF16=1 float32: chain fuse 2..{cap} (L=100, "
        f"256) and xy-chain k=2..{cap} bitwise equal to the oracle")
    report.setdefault("mid_bf16_parity", {})[spec.name] = rows
    return worst


def phase_face_parity(torch, gs, cuda_stencil, spec, report):
    """Each face mode of the model's kernel against its plain version
    (for bf16 fields its oracle form), bitwise over the whole output
    (the computed out-of-domain rows of a y-extended operand included),
    from random fields and faces, in every precision case; returns the
    worst |diff| per (mode, group)."""
    worst = {(m, g): 0.0 for m in ("faces6", "xchain", "xychain")
             for g in ("f", "bf16")}
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(2024)

    def rand(shape, dtype):
        return torch.rand(shape, generator=gen, device="cuda",
                          dtype=torch.float32).to(dtype)

    def launch(shape, dtype, *args, **kw):
        """``fused_step`` on every load path the operand takes:
        ``[(path name, outputs)]``."""
        outs = []
        for load in loads(torch, cuda_stencil, shape, dtype):
            with cuda_stencil.override(load):
                outs.append((load, cuda_stencil.fused_step(*args, **kw)))
        return outs

    def compare(mode, prec, got, want, what):
        if isinstance(got, list):
            for name, out in got:
                compare(mode, prec, out, want, f"{what} load {name}")
            return
        torch.cuda.synchronize()
        err = max((a.double() - b.double()).abs().max().item()
                  for a, b in zip(got, want))
        worst[mode, group(prec)] = max(worst[mode, group(prec)], err)
        check(all(torch.isfinite(a).all().item() for a in got),
              f"non-finite {spec.name} {mode} output: {what}")
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{spec.name} {mode} kernel != plain: {what}, max |diff| "
              f"{err}")
        rows.append([mode, what, err])

    n = spec.n_fields
    for prec, dname, pname, oracle in PRECISION_CASES:
        dtype, pdtype = getattr(torch, dname), getattr(torch, pname)
        cap = cuda_stencil.chain_cap(dtype, n)
        for noise in (0.0, 0.1):
            params = spec.model.make_params(
                gs.Settings(noise=noise, **physics(spec.name)), pdtype,
                "cuda")
            use = noise != 0
            seeds = (0, 11, 40)
            for shape, offs in (((128, 128, 128), (128, 0, 128)),
                                ((100, 64, 96), (100, 64, 0)),
                                ((20, 24, 41), (20, 0, 41))):
                nx, ny, nz = shape
                f = tuple(rand(shape, dtype) for _ in range(n))
                faces = tuple(rand(x, dtype) for x in
                              [(1, ny, nz)] * (2 * n)
                              + [(nx, 1, nz)] * (2 * n)
                              + [(nx, ny, 1)] * (2 * n))
                got = launch(shape, dtype, f, params, seeds, faces,
                             spec=spec, use_noise=use, offsets=offs,
                             row=MAIN_L)
                want = cuda_stencil.plain_step(
                    f, params, seeds, faces, spec=spec, use_noise=use,
                    offsets=offs, row=MAIN_L, oracle=oracle)
                compare("faces6", prec, got, want,
                        f"{prec} {shape} noise={noise}")
            for shape, offs, row in (((32, 256, 256), (32, 0, 0), MAIN_L),
                                     ((34, 100, 100), (68, 0, 0), 100),
                                     ((10, 24, 41), (10, 0, 0), 41)):
                f = tuple(rand(shape, dtype) for _ in range(n))
                for k in range(2, cap + 1):
                    faces = tuple(rand((k,) + shape[1:], dtype)
                                  for _ in range(2 * n))
                    got = launch(shape, dtype, f, params, seeds, faces,
                                 spec=spec, use_noise=use, fuse=k,
                                 offsets=offs, row=row)
                    want = cuda_stencil.plain_xchain(
                        f, params, seeds, faces, spec=spec, use_noise=use,
                        fuse=k, offsets=offs, row=row, oracle=oracle)
                    compare("xchain", prec, got, want,
                            f"{prec} {shape} k={k} noise={noise}")
            for k in range(2, cap + 1):
                shape = (128, 128 + 2 * k, 128)
                f = tuple(rand(shape, dtype) for _ in range(n))
                faces = tuple(rand((k,) + shape[1:], dtype)
                              for _ in range(2 * n))
                offs = (128, -k, 0)
                got = launch(shape, dtype, f, params, seeds, faces,
                             spec=spec, use_noise=use, fuse=k, offsets=offs,
                             row=MAIN_L, y_halo=k)
                want = cuda_stencil.plain_xchain(
                    f, params, seeds, faces, spec=spec, use_noise=use,
                    fuse=k, offsets=offs, row=MAIN_L, oracle=oracle)
                compare("xychain", prec, got, want,
                        f"{prec} {shape} k={k} noise={noise}")
            log(f"  {spec.name} {prec} noise={noise}: 6n-face, x-chain "
                f"(k=2..{cap}) and xy-chain (k=2..{cap}), on each load path "
                f"the operand takes (TMA refuses the (20,24,41) and "
                f"(10,24,41) operands), bitwise equal to "
                f"{'the oracle' if oracle else 'plain'}")
    report.setdefault("face_parity", {})[spec.name] = rows
    return worst


def write_config(path, model=None, model_params=None, **kw):
    """A settings TOML file; ``model`` and ``model_params`` become its
    ``[model]`` table."""
    def line(key, value):
        if isinstance(value, bool):
            return f"{key} = {'true' if value else 'false'}"
        if isinstance(value, str):
            return f"{key} = \"{value}\""
        return f"{key} = {value}"

    lines = [line(key, value) for key, value in kw.items()]
    if model is not None:
        lines.append("\n[model]")
        lines.append(line("name", model))
        lines += [line(k, v) for k, v in (model_params or {}).items()]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def expected_launches(sim, chunks, cap):
    """Launches ``Simulation.iterate`` makes over these chunk sizes."""
    n = 0
    for chunk in chunks:
        fuse = min(sim.fuse, chunk)
        rounds, rem = divmod(chunk, fuse)
        n += rounds * math.ceil(fuse / cap)
        if rem:
            n += math.ceil(rem / cap)
    return n


def phase_main_path(torch, gs, cuda_stencil, workdir, report):
    from grayscott_jl_tpu_torch import driver
    from grayscott_jl_tpu_torch.io.bplite import BpReader

    common = main_settings()
    out = os.path.join(workdir, "gs.bp")
    ckpt = os.path.join(workdir, "ckpt.bp")
    cfg = os.path.join(workdir, "main.toml")
    write_config(cfg, **common, output=out, checkpoint=True,
                 checkpoint_freq=100, checkpoint_output=ckpt)

    stats_path = os.path.join(workdir, "stats.json")
    os.environ["GS_TPU_STATS"] = stats_path
    cuda_stencil.reset_launches()
    t0 = time.perf_counter()
    sim = driver.main([cfg])
    wall = time.perf_counter() - t0
    launches = cuda_stencil.LAUNCHES
    check(not sim.sharded, f"the main path ran sharded on "
          f"{torch.cuda.device_count()} cards; run this script on one")
    check(launches == cuda_stencil.MODE_LAUNCHES["chain"],
          f"the single-block path launched face modes: "
          f"{cuda_stencil.MODE_LAUNCHES}")
    check(cuda_stencil.MODEL_LAUNCHES == {"grayscott": launches},
          f"the main path launched {cuda_stencil.MODEL_LAUNCHES}, not only "
          "Gray-Scott's generated kernel")
    loads_main = dict(cuda_stencil.LOAD_PATH_LAUNCHES)
    check(took(report, cuda_stencil, "stencil_chain") == "tma",
          f"the L={MAIN_L} main path loaded its windows {loads_main}, not "
          "all by TMA")
    del os.environ["GS_TPU_STATS"]
    with open(stats_path, encoding="utf-8") as f:
        stats = json.load(f)

    cap = cuda_stencil.max_feasible_fuse(4)
    want = expected_launches(sim, [50] * (MAIN_STEPS // 50), cap)
    check(launches > 0, "the main path launched the kernel no time")
    check(launches == want,
          f"main path launched the kernel {launches} times, expected {want}")
    log(f"  driver.main: {MAIN_STEPS} steps at L={MAIN_L} in {wall:.3f} s, "
        f"fuse={sim.fuse}, {launches} kernel launches; phases (s): "
        f"{stats['phases_s']}")

    stored = read_store(out)
    with BpReader(out) as r:
        check(r.num_steps() == MAIN_STEPS // 50,
              f"store has {r.num_steps()} steps")
        for i in range(r.num_steps()):
            u = r.get("U", step=i)
            v = r.get("V", step=i)
            check(u.shape == (MAIN_L,) * 3 and u.dtype.name == "float32",
                  f"U shape/dtype {u.shape} {u.dtype}")
            check(bool((u >= -0.2).all() and (u <= 1.5).all()),
                  f"U out of [-0.2, 1.5] at step {i}: "
                  f"[{u.min()}, {u.max()}]")
            check(bool((v >= 0.0).all() and (v <= 1.0).all()),
                  f"V out of [0, 1] at step {i}: [{v.min()}, {v.max()}]")
        u_end = r.get("U", step=r.num_steps() - 1)
        v_end = r.get("V", step=r.num_steps() - 1)
        step_end = int(r.get("step", step=r.num_steps() - 1))
    check(step_end == MAIN_STEPS, f"last stored step {step_end}")
    log(f"  store: {MAIN_STEPS // 50} steps, U in "
        f"[{u_end.min():.4f}, {u_end.max():.4f}], V in "
        f"[{v_end.min():.4f}, {v_end.max():.4f}]")

    # The same run on the plain torch path on the card.
    import numpy as np

    ref = gs.Simulation(gs.Settings(**{**common, "kernel_language": "Plain"}))
    ref.iterate(MAIN_STEPS)
    u_ref, v_ref = ref.get_fields()
    check(np.array_equal(u_ref, u_end) and np.array_equal(v_ref, v_end),
          "main path store != plain path: max |diff| "
          f"{np.abs(u_ref - u_end).max()}, {np.abs(v_ref - v_end).max()}")
    log("  store step 200 bitwise equal to the plain path on the card")

    out2 = os.path.join(workdir, "restart.bp")
    cfg2 = os.path.join(workdir, "restart.toml")
    write_config(cfg2, **common, output=out2, restart=True,
                 restart_input=ckpt, restart_step=100)
    driver.main([cfg2])
    with BpReader(out2) as r:
        u2 = r.get("U", step=r.num_steps() - 1)
        v2 = r.get("V", step=r.num_steps() - 1)
    check(np.array_equal(u2, u_end) and np.array_equal(v2, v_end),
          "restart from the step-100 checkpoint != the stored step 200")
    log("  restart from step 100 reproduces step 200 bitwise")
    report["main_path"] = {
        "wall_s": wall, "launches": launches, "fuse": sim.fuse,
        "load_paths": loads_main,
        "run_stats": stats,
        "u_range": [float(u_end.min()), float(u_end.max())],
        "v_range": [float(v_end.min()), float(v_end.max())],
    }
    return launches, sim.fuse, stored


def phase_health(torch, gs, cuda_stencil, workdir, report):
    """The blow-up configuration (ROADMAP F1: L=16 float32, dt=400, 20
    steps, plotgap 10) through ``driver.main`` on the card: the health
    guard raises HealthError at step 10 under the default policy and the
    store holds no step; under ``warn`` both NaN steps are written."""
    from grayscott_jl_tpu_torch import driver
    from grayscott_jl_tpu_torch.io.bplite import BpReader
    from grayscott_jl_tpu_torch.resilience.health import HealthError

    f1 = dict(L=16, F=0.02, k=0.048, dt=400.0, Du=0.2, Dv=0.1, noise=0.0,
              steps=20, plotgap=10, precision="Float32", backend="CUDA")
    out = {}
    for policy in ("abort", "warn"):
        store = os.path.join(workdir, f"f1_{policy}.bp")
        cfg = os.path.join(workdir, f"f1_{policy}.toml")
        write_config(cfg, **f1, output=store, health_policy=policy)
        cuda_stencil.reset_launches()
        try:
            driver.main([cfg])
            raised = None
        except HealthError as e:
            raised = e
        with BpReader(store) as r:
            n = r.num_steps()
        out[policy] = {"raised_at": None if raised is None else raised.step,
                       "steps_written": n,
                       "launches": cuda_stencil.LAUNCHES,
                       "load_paths": dict(cuda_stencil.LOAD_PATH_LAUNCHES),
                       "message": None if raised is None else str(raised)}
    check(out["abort"]["raised_at"] == 10
          and out["abort"]["steps_written"] == 0
          and out["abort"]["launches"] == 10,
          f"F1 under abort: {out['abort']}")
    check(out["warn"]["raised_at"] is None
          and out["warn"]["steps_written"] == 2,
          f"F1 under warn: {out['warn']}")
    log(f"  F1 config on the card: HealthError at step 10 after "
        f"{out['abort']['launches']} launches, no step written "
        f"({out['abort']['message']}); warn writes both NaN steps")
    report["health"] = out


def read_store(path, names=("U", "V")):
    """``[(step, *fields)]`` of every step of a store; ``names`` are the
    store's variables (the model's field names, upper-cased)."""
    from grayscott_jl_tpu_torch.io.bplite import BpReader

    with BpReader(path) as r:
        return [(int(r.get("step", step=i)),)
                + tuple(r.get(n, step=i) for n in names)
                for i in range(r.num_steps())]


def phase_model_path(torch, gs, cuda_stencil, name, workdir, report):
    """Model ``name``'s main path on the card (``MODEL_PATHS``): the
    single block through ``driver.main`` with every launch the model's
    generated kernel, its store against the plain path on the card, a
    restart, the (2,2,2) mesh on ``cuda:0`` through ``driver.run_once``
    and ``GS_FUSE=2`` on (8,1,1) and (2,2,2), each bitwise. Returns the
    single block's launches."""
    import numpy as np

    from grayscott_jl_tpu_torch import driver
    from grayscott_jl_tpu_torch.config.settings import get_settings
    from grayscott_jl_tpu_torch.models import get_model

    steps, gap, freq = MODEL_PATHS[name]
    names = tuple(f.upper() for f in get_model(name).field_names)
    common = main_settings(steps=steps, plotgap=gap, noise=0.1,
                           kernel_language="Auto", **physics(name))
    for key in GS_PHYSICS:
        if key != "dt":
            common.pop(key)
    out = os.path.join(workdir, f"{name}.bp")
    ckpt = os.path.join(workdir, f"{name}_ckpt.bp")
    cfg = os.path.join(workdir, f"{name}.toml")
    write_config(cfg, **common, output=out, checkpoint=True,
                 checkpoint_freq=freq, checkpoint_output=ckpt)
    stats_path = os.path.join(workdir, f"{name}_stats.json")
    os.environ["GS_TPU_STATS"] = stats_path
    cuda_stencil.reset_launches()
    t0 = time.perf_counter()
    sim = driver.main([cfg])
    wall = time.perf_counter() - t0
    launches = cuda_stencil.LAUNCHES
    models = dict(cuda_stencil.MODEL_LAUNCHES)
    modes = dict(cuda_stencil.MODE_LAUNCHES)
    took(report, cuda_stencil, f"stencil_chain_{name}")
    del os.environ["GS_TPU_STATS"]
    with open(stats_path, encoding="utf-8") as f:
        stats = json.load(f)
    check(not sim.sharded and sim.fuse == 1,
          f"{name} main path ran on {sim.domain.dims} at fuse {sim.fuse}")
    check(stats["config"]["kernel_selection"]["kernel_gate"]["generated"],
          f"{name}: Auto did not select the generated kernel: "
          f"{stats['config']['kernel_selection']}")
    check(launches == steps and models == {name: steps}
          and modes["chain"] == steps,
          f"{name} main path launched {launches} ({models}, {modes}), "
          f"expected {steps} of its generated chain kernel")
    log(f"  {name}: driver.main {steps} steps at L={MAIN_L} in {wall:.3f} "
        f"s, {launches} launches of its generated kernel; phases (s): "
        f"{stats['phases_s']}")
    stored = read_store(out, names)
    check([s[0] for s in stored] == list(range(gap, steps + 1, gap)),
          f"{name} store steps {[s[0] for s in stored]}")
    for step, *fields in stored:
        for n, f in zip(names, fields):
            check(f.shape == (MAIN_L,) * 3 and f.dtype.name == "float32"
                  and bool(np.isfinite(f).all()),
                  f"{name} {n} at step {step}: {f.shape} {f.dtype}, "
                  "or non-finite")
    ref = gs.Simulation(gs.Settings(**{**common, "kernel_language": "Plain"}))
    ref.iterate(steps)
    for n, a, b in zip(names, ref.get_fields(), stored[-1][1:]):
        check(np.array_equal(a, b),
              f"{name} store {n} != plain path: max |diff| "
              f"{np.abs(a - b).max()}")
    cfg2 = os.path.join(workdir, f"{name}_restart.toml")
    out2 = os.path.join(workdir, f"{name}_restart.bp")
    write_config(cfg2, **common, output=out2, restart=True,
                 restart_input=ckpt, restart_step=steps - freq)
    driver.main([cfg2])
    end = read_store(out2, names)[-1]
    check(end[0] == steps and all(
        np.array_equal(a, b) for a, b in zip(end[1:], stored[-1][1:])),
        f"{name} restart from step {steps - freq} != the stored step {steps}")
    log(f"  {name}: store bitwise equal to the plain path on the card; "
        f"restart from step {steps - freq} reproduces step {steps}")

    def factory(settings, *, n_devices, seed):
        return mesh_sim(gs, settings, MESH, seed)

    cfg3 = os.path.join(workdir, f"{name}_mesh.toml")
    out3 = os.path.join(workdir, f"{name}_mesh.bp")
    write_config(cfg3, **common, output=out3)
    cuda_stencil.reset_launches()
    t0 = time.perf_counter()
    driver.run_once(get_settings([cfg3]), sim_factory=factory)
    mesh_wall = time.perf_counter() - t0
    counts = dict(cuda_stencil.MODE_LAUNCHES)
    n_blocks = MESH[0] * MESH[1] * MESH[2]
    check(counts["faces6"] == n_blocks * steps
          and cuda_stencil.MODEL_LAUNCHES == {name: n_blocks * steps},
          f"{name} (2,2,2) mesh launched {counts} "
          f"{cuda_stencil.MODEL_LAUNCHES}, expected {n_blocks * steps} "
          "6n-face launches of its kernel")
    got = read_store(out3, names)
    check(len(got) == len(stored) and all(
        a[0] == b[0] and all(np.array_equal(x, y)
                             for x, y in zip(a[1:], b[1:]))
        for a, b in zip(got, stored)),
        f"{name} (2,2,2) store != the single-block store")
    log(f"  {name}: (2,2,2) mesh on cuda:0, {counts['faces6']} 6n-face "
        f"launches in {mesh_wall:.3f} s, store bitwise equal at every step")
    fuse2 = {}
    first = stored[0]  # the first stored step, ``gap``
    os.environ["GS_FUSE"] = "2"
    try:
        for dims, mode in (((8, 1, 1), "xchain"), ((2, 2, 2), "xychain")):
            # The fused round (the split one is phase 4 (iii)'s).
            sim = mesh_sim(gs, gs.Settings(**common, comm_overlap="off"),
                           dims)
            cuda_stencil.reset_launches()
            sim.iterate(gap)
            sim.block_until_ready()
            counts = dict(cuda_stencil.MODE_LAUNCHES)
            # Rounds of depth 2, and one of depth 1 (6n faces) for an
            # odd ``gap``.
            n = 8 * -(-gap // 2)
            check(counts[mode] == 8 * (gap // 2)
                  and counts["faces6"] == n - 8 * (gap // 2)
                  and cuda_stencil.MODEL_LAUNCHES == {name: n},
                  f"{name} GS_FUSE=2 on {dims} launched {counts}")
            check(all(np.array_equal(a, b)
                      for a, b in zip(sim.get_fields(), first[1:])),
                  f"{name} GS_FUSE=2 on {dims} != the stored step {gap}")
            fuse2["x".join(map(str, dims))] = counts[mode]
    finally:
        del os.environ["GS_FUSE"]
    log(f"  {name}: GS_FUSE=2 on (8,1,1) and (2,2,2), {fuse2} launches, "
        f"bitwise equal to the stored step {gap}")
    report.setdefault("model_paths", {})[name] = {
        "steps": steps, "wall_s": wall, "launches": launches,
        "run_stats": stats, "mesh_wall_s": mesh_wall,
        "mesh_faces6_launches": n_blocks * steps, "fuse2_launches": fuse2,
    }
    return launches


def main_settings(**kw):
    """The main path's settings (phase 4), as keyword arguments."""
    base = dict(
        L=MAIN_L, Du=0.2, Dv=0.1, F=0.02, k=0.048, dt=1.0, noise=0.1,
        steps=MAIN_STEPS, plotgap=50, precision="Float32",
        backend="CUDA", kernel_language="Pallas",
    )
    base.update(kw)
    return base


def mesh_sim(gs, settings, dims, seed=0):
    """A ``dims`` mesh with every block on ``cuda:0``."""
    n = dims[0] * dims[1] * dims[2]
    return gs.Simulation(settings, seed=seed, mesh_dims=dims,
                         devices=["cuda:0"] * n)


def phase_sharded(torch, gs, cuda_stencil, workdir, stored, report):
    """The sharded main path: ``driver.run_once`` on a (2,2,2) mesh of
    blocks all on ``cuda:0``, at the card's default depth 1."""
    import numpy as np

    from grayscott_jl_tpu_torch import driver
    from grayscott_jl_tpu_torch.config.settings import get_settings

    def factory(settings, *, n_devices, seed):
        return mesh_sim(gs, settings, MESH, seed)

    out = os.path.join(workdir, "mesh.bp")
    ckpt = os.path.join(workdir, "mesh_ckpt.bp")
    cfg = os.path.join(workdir, "mesh.toml")
    write_config(cfg, **main_settings(), output=out, checkpoint=True,
                 checkpoint_freq=100, checkpoint_output=ckpt)
    stats_path = os.path.join(workdir, "mesh_stats.json")
    os.environ["GS_TPU_STATS"] = stats_path
    cuda_stencil.reset_launches()
    t0 = time.perf_counter()
    sim = driver.run_once(get_settings([cfg]), sim_factory=factory)
    wall = time.perf_counter() - t0
    counts = dict(cuda_stencil.MODE_LAUNCHES)
    loads_mesh = dict(cuda_stencil.LOAD_PATH_LAUNCHES)
    took(report, cuda_stencil, "stencil_faces6")
    del os.environ["GS_TPU_STATS"]
    with open(stats_path, encoding="utf-8") as f:
        stats = json.load(f)
    n = MESH[0] * MESH[1] * MESH[2]
    check(loads_mesh == {"tma": n * MAIN_STEPS, "cp_async": 0},
          f"the sharded main path loaded its windows {loads_mesh}")
    check(sim.domain.dims == MESH and sim.fuse == 1,
          f"sharded path ran {sim.domain.dims} at fuse {sim.fuse}")
    check(counts["faces6"] == n * MAIN_STEPS
          and sum(counts.values()) == counts["faces6"],
          f"sharded main path launched {counts}, expected "
          f"{n * MAIN_STEPS} 6n-face launches and no other")
    log(f"  driver.run_once on a {MESH} mesh on cuda:0: {MAIN_STEPS} steps "
        f"in {wall:.3f} s, {counts['faces6']} 6n-face launches; phases "
        f"(s): {stats['phases_s']}")
    got = read_store(out)
    check([s for s, *_ in got] == [s for s, *_ in stored],
          f"sharded store steps {[s for s, *_ in got]}")
    for (step, u, v), (_, u1, v1) in zip(got, stored):
        check(np.array_equal(u, u1) and np.array_equal(v, v1),
              f"sharded store != single-block store at step {step}")
    log(f"  sharded store bitwise equal to the single-block store at all "
        f"{len(got)} steps")

    out2 = os.path.join(workdir, "mesh_restart.bp")
    cfg2 = os.path.join(workdir, "mesh_restart.toml")
    write_config(cfg2, **main_settings(), output=out2, restart=True,
                 restart_input=ckpt, restart_step=100)
    driver.run_once(get_settings([cfg2]), sim_factory=factory)
    step2, u2, v2 = read_store(out2)[-1]
    step1, u1, v1 = stored[-1]
    check(step2 == step1 == MAIN_STEPS
          and np.array_equal(u2, u1) and np.array_equal(v2, v1),
          "sharded restart from step 100 != the stored step 200")
    log("  sharded restart from step 100 reproduces step 200 bitwise")
    report["sharded_main_path"] = {
        "mesh": list(MESH), "wall_s": wall, "launches": counts,
        "load_paths": loads_mesh, "run_stats": stats,
    }
    return counts["faces6"]


def tree_digest(root, skip=(".toml", ".json")):
    """sha256 of every file the run wrote under ``root`` (the stores, the
    .vti series; not its config and stats), by relative path. Store
    metadata (``md.json``, ``integrity.json``) is included."""
    import hashlib

    out = {}
    for dirpath, _, names in os.walk(root):
        for name in sorted(names):
            path = os.path.join(dirpath, name)
            if name.endswith(skip) and name not in ("md.json",
                                                    "integrity.json"):
                continue
            h = hashlib.sha256()
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 24), b""):
                    h.update(chunk)
            out[os.path.relpath(path, root)] = h.hexdigest()
    return out


def watch_synchronize(torch):
    """Record the thread of every device-wide or stream synchronise
    (``torch.cuda.synchronize``, ``Stream.synchronize``) and of every
    ``Event.synchronize`` until the returned ``stop()`` is called."""
    import threading

    calls = {"device": [], "event": []}
    real = (torch.cuda.synchronize, torch.cuda.Stream.synchronize,
            torch.cuda.Event.synchronize)

    def device_sync(*a, **k):
        calls["device"].append(threading.current_thread().name)
        return real[0](*a, **k)

    def stream_sync(self):
        calls["device"].append(threading.current_thread().name)
        return real[1](self)

    def event_sync(self):
        calls["event"].append(threading.current_thread().name)
        return real[2](self)

    torch.cuda.synchronize = device_sync
    torch.cuda.Stream.synchronize = stream_sync
    torch.cuda.Event.synchronize = event_sync

    def stop():
        (torch.cuda.synchronize, torch.cuda.Stream.synchronize,
         torch.cuda.Event.synchronize) = real
        return calls

    return stop


def run_store(torch, gs, cuda_stencil, workdir, name, depth, factory=None,
              env=None, **kw):
    """The main path's config (a) — ``main_settings()`` with a checkpoint
    every 100 steps — through ``driver.main`` (``driver.run_once`` with
    ``factory``) at ``GS_ASYNC_IO_DEPTH=depth``, under ``env``, with the
    launch counts set to 0 just before and read just after. Returns
    ``(run directory, RunStats summary, wall s, launches)``."""
    from grayscott_jl_tpu_torch import driver
    from grayscott_jl_tpu_torch.config.settings import get_settings

    d = os.path.join(workdir, name)
    os.makedirs(d)
    cfg = os.path.join(d, "cfg.toml")
    write_config(cfg, **{**main_settings(), **kw},
                 output=os.path.join(d, "gs.bp"), checkpoint=True,
                 checkpoint_freq=100,
                 checkpoint_output=os.path.join(d, "ckpt.bp"))
    stats = os.path.join(d, "stats.json")
    saved = {k: os.environ.get(k) for k in
             ["GS_ASYNC_IO_DEPTH", "GS_TPU_STATS"] + list(env or {})}
    os.environ.update({"GS_ASYNC_IO_DEPTH": str(depth),
                       "GS_TPU_STATS": stats, **(env or {})})
    try:
        cuda_stencil.reset_launches()
        t0 = time.perf_counter()
        if factory is None:
            driver.main([cfg])
        else:
            driver.run_once(get_settings([cfg]), sim_factory=factory)
        wall = time.perf_counter() - t0
        launches = cuda_stencil.LAUNCHES
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    with open(stats, encoding="utf-8") as f:
        summary = json.load(f)
    return d, summary, wall, launches


def output_breakdown(workdir, rounds=2):
    """Host seconds of the parts of one L=256 output step on the writer
    thread, each the mean of ``rounds`` in turns: the ``.vti`` file of u
    and v (``io/vtk.write_vti``: transposition and write), one store
    step of u and v on the native engine (staging and CRC32, then the
    drain: write and fsync on its thread) and on the Python engine
    (write, CRC32, fsync), and CRC32 alone over one field."""
    import zlib

    import numpy as np

    from grayscott_jl_tpu_torch.io import bplite, native, vtk

    rng = np.random.default_rng(0)
    u, v = (rng.random((MAIN_L,) * 3, dtype=np.float32) for _ in range(2))
    out = {"vti_s": [], "native_stage_s": [], "native_drain_s": [],
           "python_step_s": [], "crc32_field_s": []}
    for i in range(rounds):
        t0 = time.perf_counter()
        vtk.write_vti(os.path.join(workdir, f"b{i}.vti"), MAIN_L, 0, u, v)
        out["vti_s"].append(time.perf_counter() - t0)
        for engine in ("native", "python"):
            path = os.path.join(workdir, f"b{i}_{engine}.bp")
            w = (native.NativeBpWriter(path) if engine == "native"
                 else bplite.BpWriter(path))
            for name in ("U", "V"):
                w.define_variable(name, np.float32, (MAIN_L,) * 3)
            t0 = time.perf_counter()
            w.begin_step()
            w.put("U", u)
            w.put("V", v)
            w.end_step()
            t1 = time.perf_counter()
            if engine == "native":
                w.drain()
                out["native_stage_s"].append(t1 - t0)
                out["native_drain_s"].append(time.perf_counter() - t1)
            else:
                out["python_step_s"].append(t1 - t0)
            w.close()
            shutil.rmtree(path)
        t0 = time.perf_counter()
        zlib.crc32(u)
        out["crc32_field_s"].append(time.perf_counter() - t0)
        os.remove(os.path.join(workdir, f"b{i}.vti"))
    mean = {k: sum(x) / len(x) for k, x in out.items()}
    log("  one L=256 output step, host s (mean of "
        f"{rounds}): .vti {mean['vti_s']:.4f}; native store stage "
        f"{mean['native_stage_s']:.4f} + drain {mean['native_drain_s']:.4f};"
        f" Python store {mean['python_step_s']:.4f}; CRC32 of one field "
        f"{mean['crc32_field_s']:.4f}")
    return {"runs": out, "mean": mean}


def phase_async_main_path(torch, gs, cuda_stencil, workdir, stored, report):
    """Phase 4 (i): the main path's config (a) through the output
    pipeline at ``GS_ASYNC_IO_DEPTH`` 0 and 2 with the native engine, on
    the single block (runs in the order 0, 2, 2, 0) and on the (2,2,2)
    mesh on ``cuda:0`` (0, 2): every run's files byte-identical to the
    other depth's, its store bitwise equal to phase 4's, the engine
    native, and no device-wide or stream synchronise on the writer
    thread (it waits on each snapshot's copy event)."""
    import numpy as np

    def factory(settings, *, n_devices, seed):
        return mesh_sim(gs, settings, MESH, seed)

    rows = {}
    stop = watch_synchronize(torch)
    try:
        for layout, fac, order in (("single", None, (0, 2, 2, 0)),
                                   ("mesh", factory, (0, 2))):
            digests = {}
            for i, depth in enumerate(order):
                d, summary, wall, launches = run_store(
                    torch, gs, cuda_stencil, workdir,
                    f"async_{layout}_{depth}_{i}", depth, fac)
                cfg, io = summary["config"], summary["io"]
                check(cfg["io_engine"] == "native",
                      f"{layout} depth {depth}: store engine "
                      f"{cfg['io_engine']}, not native")
                check(cfg["async_io_depth"] == depth == io["depth"],
                      f"{layout}: depth {cfg['async_io_depth']} / "
                      f"{io['depth']}, asked {depth}")
                check(launches > 0, f"{layout} depth {depth}: no launch")
                digest = tree_digest(d)
                check(any(k.endswith(".vti") for k in digest)
                      and "gs.bp/data.0" in digest,
                      f"{layout}: files {sorted(digest)}")
                if depth in digests:
                    check(digest == digests[depth],
                          f"{layout} depth {depth}: files differ run to run")
                else:
                    got = read_store(os.path.join(d, "gs.bp"))
                    check([s for s, *_ in got] == [s for s, *_ in stored],
                          f"{layout} depth {depth}: steps "
                          f"{[s for s, *_ in got]}")
                    for (step, u, v), (_, u1, v1) in zip(got, stored):
                        check(np.array_equal(u, u1)
                              and np.array_equal(v, v1),
                              f"{layout} depth {depth}: store != phase 4's "
                              f"at step {step}")
                    digests[depth] = digest
                shutil.rmtree(d)
                row = {"wall_s": wall, "launches": launches,
                       "phases_s": summary["phases_s"],
                       "hidden_s": io["hidden_total_s"],
                       "exposed_s": io["exposed_total_s"],
                       "busy_s": io["busy_s"],
                       "submit_wait_s": io["submit_wait_s"],
                       "drain_wait_s": io["drain_wait_s"],
                       "queue_depth_hwm": io["queue_depth_hwm"],
                       "host_ring_bytes": cfg["host_ring_bytes"],
                       "engine": cfg["io_engine"]}
                rows.setdefault(layout, {}).setdefault(
                    str(depth), []).append(row)
                ph = summary["phases_s"]
                log(f"  {layout} depth {depth} ({cfg['io_engine']}): wall "
                    f"{wall:.4f} s, compute {ph.get('compute', 0):.4f}, "
                    f"device_to_host {ph.get('device_to_host', 0):.4f}, "
                    f"output {ph.get('output', 0):.4f}, checkpoint "
                    f"{ph.get('checkpoint', 0):.4f}, io_drain "
                    f"{ph.get('io_drain', 0):.4f}; writer busy "
                    f"{sum(io['busy_s'].values()):.4f} s = hidden "
                    f"{io['hidden_total_s']:.4f} + exposed "
                    f"{io['exposed_total_s']:.4f}; {launches} launches")
            if layout == "single":
                digests_single = digests
            check(digests[0] == digests[2],
                  f"{layout}: depth 0 and 2 files differ: "
                  f"{[k for k in digests[0] if digests[0][k] != digests[2].get(k)]}")
            log(f"  {layout}: depth 0 and 2 write byte-identical files "
                f"({len(digests[0])} files), equal to phase 4's store")
    finally:
        calls = stop()
    # The Python engine on the same run (depth 2), for the engines'
    # writer time side by side.
    d, summary, wall, _ = run_store(torch, gs, cuda_stencil, workdir,
                                    "async_single_python", 2,
                                    env={"GS_TPU_NATIVE_IO": "0"})
    check(summary["config"]["io_engine"] == "python",
          f"GS_TPU_NATIVE_IO=0 wrote with {summary['config']['io_engine']}")
    check(tree_digest(d)["gs.bp/data.0"] == digests_single[0]["gs.bp/data.0"],
          "the Python engine's payload != the native engine's")
    shutil.rmtree(d)
    io = summary["io"]
    rows["single_python"] = {"2": [{
        "wall_s": wall, "phases_s": summary["phases_s"],
        "hidden_s": io["hidden_total_s"], "exposed_s": io["exposed_total_s"],
        "busy_s": io["busy_s"], "engine": "python"}]}
    log(f"  single depth 2 (python engine): wall {wall:.4f} s; writer busy "
        f"{io['busy_s']}")
    rows["output_breakdown"] = output_breakdown(workdir)
    off_main = [t for t in calls["device"] if t != "MainThread"]
    check(not off_main, f"device or stream synchronise off the driver "
          f"thread: {sorted(set(off_main))}")
    writer_waits = sum(t == "gs-async-io" for t in calls["event"])
    check(writer_waits > 0, "the writer thread never waited on a copy event")
    log(f"  synchronise calls: {len(calls['device'])} device/stream, all on "
        f"the driver thread; {writer_waits} copy-event waits on the writer "
        "thread")
    report["async_main_path"] = {"rows": rows, "writer_event_waits":
                                 writer_waits,
                                 "device_syncs": len(calls["device"])}
    return rows


def phase_integrity(torch, gs, cuda_stencil, workdir, stored, report):
    """Phase 4 (ii): integrity on config (a) at depth 2. With
    ``GS_CKPT_VERIFY=full``, ``GS_CKPT_REPLICAS=2`` and ``GS_SCRUB=1``,
    and the primary checkpoint's step-100 entry corrupted once it is
    durable (before step 200's boundary): the run completes (the device
    and host checksums agreed at every boundary; each store's sidecar
    holds the device checksums, equal to the host checksums of the
    stored steps), the store equals phase 4's, the scrub quarantines the
    entry, and a restart from step 100 fails over to the mirror and
    reproduces step 200 bitwise. The bitflip hook at step 100 raises
    ``CorruptionError`` with only step 50 written. Then the checksum's
    device time at L=256 (CUDA events) beside the host's, and the
    read-back's seconds."""
    import numpy as np

    from grayscott_jl_tpu_torch import driver
    from grayscott_jl_tpu_torch.config.settings import get_settings
    from grayscott_jl_tpu_torch.io.async_writer import AsyncIOError
    from grayscott_jl_tpu_torch.io.bplite import BpReader
    from grayscott_jl_tpu_torch.io.checkpoint import latest_durable_step
    from grayscott_jl_tpu_torch.resilience import integrity

    env = {"GS_CKPT_VERIFY": "full", "GS_CKPT_REPLICAS": "2",
           "GS_SCRUB": "1"}

    class CorruptAt(gs.Simulation):
        def iterate(self, nsteps=1):
            if self.step == 150:
                # Once the writer is on step 150's output, step 100's
                # checkpoint is written and read back.
                out = self.settings.output
                deadline = time.monotonic() + 60
                while not os.path.isfile(os.path.join(out, "md.json")) or (
                        BpReader(out).num_steps() < 3):
                    check(time.monotonic() < deadline,
                          "output step 150 never became durable")
                    time.sleep(0.005)
                ckpt = self.settings.checkpoint_output
                check(latest_durable_step(ckpt) == 100,
                      f"checkpoint at {latest_durable_step(ckpt)}")
                info = integrity.corrupt_store_byte(ckpt)
                check(info is not None and info["step_index"] == 0,
                      f"corrupted {info}")
            super().iterate(nsteps)

    d, summary, wall, launches = run_store(
        torch, gs, cuda_stencil, workdir, "integrity", 2,
        lambda s, **kw: CorruptAt(s, **kw), env=env)
    icfg = summary["config"]["integrity"]
    check(icfg["verify"] == "full" and icfg["replicas"] == 2
          and icfg["scrub"] and icfg["corrupt_found"] == 1,
          f"integrity config {icfg}")
    got = read_store(os.path.join(d, "gs.bp"))
    for (step, u, v), (_, u1, v1) in zip(got, stored):
        check(np.array_equal(u, u1) and np.array_equal(v, v1),
              f"verify=full store != phase 4's at step {step}")
    check(len(got) == len(stored), f"{len(got)} steps")
    rows = []
    for store, steps, names in (("gs.bp", [s for s, *_ in stored],
                                 ("U", "V")),
                                ("ckpt.bp.r1", [100, 200], ("u", "v"))):
        with open(os.path.join(d, store, "integrity.json"),
                  encoding="utf-8") as f:
            device = json.load(f)["device"]
        with BpReader(os.path.join(d, store)) as r:
            check([int(r.get("step", step=i)) for i in
                   range(r.num_steps())] == steps, f"{store} steps")
            for i, step in enumerate(steps):
                host = {n.lower(): integrity.host_field_checksum(
                    r.get(n, step=i)) for n in names}
                check(device[i] == host,
                      f"{store} step {step}: device checksums {device[i]} "
                      f"!= host {host}")
                rows.append({"store": store, "step": step, **host})
    log(f"  verify=full: device == host checksum at all {len(rows)} "
        f"store steps (e.g. step {rows[0]['step']}: u {rows[0]['u']:#010x},"
        f" v {rows[0]['v']:#010x})")
    primary = os.path.join(d, "ckpt.bp")
    check(integrity.read_quarantine(primary) == {0},
          f"quarantine {integrity.read_quarantine(primary)}")
    t0 = time.perf_counter()
    integrity.verify_last_step(os.path.join(d, "ckpt.bp.r1"))
    readback_s = time.perf_counter() - t0
    log(f"  scrub quarantined the corrupted step-100 entry; read-back of "
        f"one L={MAIN_L} checkpoint step {readback_s:.4f} s; run wall "
        f"{wall:.4f} s, phases {summary['phases_s']}")

    # The same run with GS_CKPT_VERIFY=full alone and no corruption hook,
    # beside one without it, for the cost of the checksum and read-back.
    walls = {}
    for name, env_i in (("read", {}), ("full", {"GS_CKPT_VERIFY": "full"})):
        d_i, summary_i, wall_i, _ = run_store(
            torch, gs, cuda_stencil, workdir, f"verify_{name}", 2,
            env=env_i)
        shutil.rmtree(d_i)
        walls[name] = {"wall_s": wall_i, "busy_s": summary_i["io"]["busy_s"],
                       "hidden_s": summary_i["io"]["hidden_total_s"]}
    log(f"  depth 2: GS_CKPT_VERIFY=read wall {walls['read']['wall_s']:.4f}"
        f" s (writer {walls['read']['busy_s']}), full "
        f"{walls['full']['wall_s']:.4f} s (writer "
        f"{walls['full']['busy_s']})")

    # The restart from step 100: the primary's entry is corrupt (and
    # quarantined), the mirror's is whole.
    restart = os.path.join(workdir, "integrity_restart")
    os.makedirs(restart)
    cfg = os.path.join(restart, "cfg.toml")
    write_config(cfg, **main_settings(), output=os.path.join(restart,
                                                             "gs.bp"),
                 restart=True, restart_input=primary, restart_step=100)
    stats_path = os.path.join(restart, "stats.json")
    os.environ["GS_TPU_STATS"] = stats_path
    try:
        driver.main([cfg])
    finally:
        del os.environ["GS_TPU_STATS"]
    with open(stats_path, encoding="utf-8") as f:
        events = json.load(f)["config"]["integrity"].get("events", [])
    check(any(e["event"] == "replica_failover" for e in events),
          f"no failover recorded: {events}")
    step2, u2, v2 = read_store(os.path.join(restart, "gs.bp"))[-1]
    step1, u1, v1 = stored[-1]
    check(step2 == step1 and np.array_equal(u2, u1)
          and np.array_equal(v2, v1),
          "restart through failover != the stored step 200")
    log("  restart from step 100 failed over to the mirror and reproduced "
        "step 200 bitwise")
    shutil.rmtree(d)
    shutil.rmtree(restart)

    class FlipAt(gs.Simulation):
        def snapshot_async(self, **kw):
            if self.step == 100 and kw.get("exact", True):
                kw["bitflip"] = True
            return super().snapshot_async(**kw)

    try:
        run_store(torch, gs, cuda_stencil, workdir, "bitflip", 2,
                  lambda s, **kw: FlipAt(s, **kw), env=env)
        raised = None
    except AsyncIOError as e:
        raised = e
    check(raised is not None
          and isinstance(raised.original, integrity.CorruptionError)
          and raised.step == 100,
          f"the bitflip hook raised {raised!r}")
    flip = os.path.join(workdir, "bitflip")
    check([s for s, *_ in read_store(os.path.join(flip, "gs.bp"))] == [50]
          and read_store(os.path.join(flip, "ckpt.bp"), ("u", "v")) == [],
          "the bitflipped boundary reached a store")
    log(f"  bitflip at step 100: {raised.original}; only step 50 written")
    shutil.rmtree(flip)

    from grayscott_jl_tpu_torch.resilience.integrity import (
        device_field_checksum, host_field_checksum)

    sim = gs.Simulation(gs.Settings(**main_settings()))
    sim.iterate(10)
    u, v = sim.blocks[0]
    device_ms = time_calls(torch, lambda: device_field_checksum(u, v))
    want = [int(x) for x in device_field_checksum(u, v)]
    hu, hv = u.cpu().numpy(), v.cpu().numpy()
    check(want == [host_field_checksum(hu), host_field_checksum(hv)],
          "device != host checksum on the L=256 fields")
    t0 = time.perf_counter()
    for _ in range(5):
        host_field_checksum(hu), host_field_checksum(hv)
    host_ms = (time.perf_counter() - t0) * 1e3 / 5
    bytes_read = 2 * u.numel() * u.element_size()
    check_bound = bytes_read / _xstats().HBM_BYTES_PER_S * 1e3
    log(f"  checksum of u and v at L={MAIN_L}: device {device_ms:.4f} ms "
        f"(CUDA events; bound {check_bound:.4f} ms for "
        f"{bytes_read / 1e6:.1f} MB), host {host_ms:.3f} ms")
    del sim, u, v
    report["integrity"] = {
        "wall_s": wall, "launches": launches,
        "phases_s": summary["phases_s"], "io": summary["io"],
        "config": icfg, "checksums": rows, "readback_s": readback_s,
        "checksum_device_ms": device_ms, "checksum_host_ms": host_ms,
        "checksum_bound_ms": check_bound, "verify_walls": walls,
        "bitflip": str(raised.original),
    }


def phase_shutdown(torch, gs, cuda_stencil, workdir, report):
    """F2 on the card at depth 2: a SIGTERM while stepping from step 25
    (L=128, plotgap 25) gives ``GracefulShutdown`` after a checkpoint at
    step 50 with steps 25 and 50 written, and the restart from it
    reproduces the uninterrupted run's step 100 bitwise."""
    import numpy as np

    import signal

    from grayscott_jl_tpu_torch import driver
    from grayscott_jl_tpu_torch.config.settings import get_settings
    from grayscott_jl_tpu_torch.resilience.faults import GracefulShutdown

    class SignalAt(gs.Simulation):
        def iterate(self, nsteps=1):
            if self.step == 25:
                os.kill(os.getpid(), signal.SIGTERM)
            super().iterate(nsteps)

    common = main_settings(L=128, steps=100, plotgap=25)
    ckpt = os.path.join(workdir, "f2_ckpt.bp")
    cfg = os.path.join(workdir, "f2.toml")
    write_config(cfg, **common, output=os.path.join(workdir, "f2.bp"),
                 checkpoint=True, checkpoint_freq=1000,
                 checkpoint_output=ckpt)
    os.environ["GS_ASYNC_IO_DEPTH"] = "2"
    try:
        try:
            driver.run_once(get_settings([cfg]),
                            sim_factory=lambda s, **kw: SignalAt(s, **kw))
            raised = None
        except GracefulShutdown as e:
            raised = e
        check(raised is not None and raised.step == 50
              and raised.checkpoint_step == 50,
              f"F2 at depth 2: {raised!r}")
        written = [s for s, *_ in read_store(os.path.join(workdir,
                                                           "f2.bp"))]
        ckpts = [s for s, *_ in read_store(ckpt, ("u", "v"))]
        check(written == [25, 50] and ckpts == [50],
              f"F2 stores: output {written}, checkpoints {ckpts}")
        cfg2 = os.path.join(workdir, "f2_resume.toml")
        write_config(cfg2, **common,
                     output=os.path.join(workdir, "f2_resume.bp"),
                     restart=True, restart_input=ckpt)
        resumed = driver.main([cfg2])
        cfg3 = os.path.join(workdir, "f2_whole.toml")
        write_config(cfg3, **common,
                     output=os.path.join(workdir, "f2_whole.bp"))
        whole = driver.main([cfg3])
    finally:
        del os.environ["GS_ASYNC_IO_DEPTH"]
    check(all(np.array_equal(a, b) for a, b in
              zip(resumed.get_fields(), whole.get_fields())),
          "F2 restart != the uninterrupted run")
    log("  F2 at depth 2: SIGTERM -> checkpoint at step 50, steps 25 and 50 "
        "written, GracefulShutdown (exit 75); the restart reproduces step "
        "100 bitwise")
    report["shutdown"] = {"step": raised.step,
                          "checkpoint_step": raised.checkpoint_step}


def phase_fuse2(torch, gs, cuda_stencil, stored, report):
    """``GS_FUSE=2`` runs of 50 steps on the three chain forms, each
    bitwise equal to the stored step 50, and pad-and-mask L=250."""
    import numpy as np

    step50, u50, v50 = stored[0]
    check(step50 == 50, f"first stored step is {step50}")
    runs = {}
    os.environ["GS_FUSE"] = "2"
    try:
        for dims, mode in (((8, 1, 1), "xchain"), ((2, 2, 2), "xychain"),
                           ((2, 2, 1), "xychain")):
            n = dims[0] * dims[1] * dims[2]
            # The fused round (the split one is phase 4 (iii)'s).
            sim = mesh_sim(gs, gs.Settings(**main_settings(
                comm_overlap="off")), dims)
            cuda_stencil.reset_launches()
            t0 = time.perf_counter()
            sim.iterate(50)
            sim.block_until_ready()
            wall = time.perf_counter() - t0
            counts = dict(cuda_stencil.MODE_LAUNCHES)
            check(counts[mode] == n * 25
                  and sum(counts.values()) == counts[mode],
                  f"GS_FUSE=2 on {dims} launched {counts}, expected "
                  f"{n * 25} {mode} launches and no other")
            if dims != (2, 2, 1):  # the kernels line's x- and xy-chain
                took(report, cuda_stencil, f"stencil_{mode}")
            u, v = sim.get_fields()
            check(np.array_equal(u, u50) and np.array_equal(v, v50),
                  f"GS_FUSE=2 on {dims} != the stored step 50")
            runs["x".join(map(str, dims))] = {
                "mode": mode, "launches": counts[mode], "wall_s": wall}
            log(f"  GS_FUSE=2 on {dims}: {counts[mode]} {mode} launches, "
                "step 50 bitwise equal to the single-block store")
        L = 250
        settings = gs.Settings(**main_settings(L=L, comm_overlap="off"))
        single = gs.Simulation(settings)
        check(not single.sharded, "the L=250 reference run is sharded")
        sim = mesh_sim(gs, settings, (3, 1, 1))
        check(sim.domain.padded, "L=250 on (3,1,1) is not padded")
        cuda_stencil.reset_launches()
        sim.iterate(50)
        xchain = cuda_stencil.MODE_LAUNCHES["xchain"]
        check(xchain == 3 * 25, f"L=250 launched {xchain} x-chain kernels")
        loads_250 = dict(cuda_stencil.LOAD_PATH_LAUNCHES)
        check(loads_250 == {"tma": 0, "cp_async": xchain},
              f"L=250 (nz = 250: 1,000 B rows, which TMA refuses) loaded "
              f"its windows {loads_250}")
        single.iterate(50)
        for a, b in zip(single.get_fields(), sim.get_fields()):
            check(a.shape == (L,) * 3 and np.array_equal(a, b),
                  "L=250 on (3,1,1) != the single-block L=250 run")
        runs["L250_3x1x1"] = {"mode": "xchain", "launches": xchain,
                              "load_paths": loads_250}
        log("  L=250 on (3,1,1) (pad-and-mask, cp.async loads): bitwise "
            "equal to the single-block run")
    finally:
        del os.environ["GS_FUSE"]
    report["fuse2_runs"] = runs
    return runs


#: The split-phase meshes of phase 4 (iii) at depth 2: mesh -> the
#: launches per block per round by mode, and how many of them are band
#: recomputes (x-chain: the interior on frozen faces and two k-plane
#: bands; xy-chain: the interior and four bands, two of 3k rows and two
#: of k planes, in x-chain mode).
SPLIT_MESHES = {(8, 1, 1): ({"xchain": 3}, 2),
                (2, 2, 1): ({"xychain": 1, "xchain": 4}, 4),
                (2, 2, 2): ({"xychain": 1, "xchain": 4}, 4)}


def band_shapes(k):
    """The band bodies the split rounds launch at L=256 and depth k:
    (8,1,1)'s k planes of its (32,256,256) blocks, and the 3k rows and
    k planes of the y-extended operands of (2,2,1) ((128,128,256)
    blocks) and (2,2,2) ((128,128,128)), with a global origin for each
    (a low y band starts k rows outside the domain)."""
    return {
        "x_8x1x1": ((k, 256, 256), (32, 0, 0)),
        "y_2x2x1": ((128, 3 * k, 256), (128, -k, 0)),
        "x_2x2x1": ((k, 128 + 2 * k, 256), (128, 128 - k, 0)),
        "y_2x2x2": ((128, 3 * k, 128), (0, 256 - 3 * k, 128)),
        "x_2x2x2": ((k, 128 + 2 * k, 128), (128 - k, -k, 128)),
    }


def phase_band_parity(torch, gs, cuda_stencil, spec, report):
    """The x-chain kernel on the split rounds' band bodies — fewer x
    planes or y rows than its 8x8x32 tile — against ``plain_xchain``,
    bitwise over the whole output, float32, noise 0 and 0.1, depth 2
    and 4 (``GS_HALO_DEPTH=2`` over ``GS_FUSE=2``), on each load path the
    operand takes; and the L=250 (3,1,1) band (1,000 B rows) on
    cp.async. Every launch counts in ``BAND_LAUNCHES``. Returns the
    worst |diff|."""
    gen = torch.Generator(device="cuda").manual_seed(913)
    worst, rows = 0.0, []
    n = spec.n_fields
    cases = [(k, name, shape, offs) for k in (2, 4)
             for name, (shape, offs) in band_shapes(k).items()]
    cases.append((2, "x_3x1x1_L250", (2, 250, 250), (82, 0, 0)))
    for noise in (0.0, 0.1):
        params = spec.model.make_params(
            gs.Settings(noise=noise, **GS_PHYSICS), torch.float32, "cuda")
        for k, name, shape, offs in cases:
            row = 250 if name.endswith("L250") else MAIN_L
            f = tuple(torch.rand(shape, generator=gen, device="cuda")
                      for _ in range(n))
            faces = tuple(torch.rand((k,) + shape[1:], generator=gen,
                                     device="cuda") for _ in range(2 * n))
            want = cuda_stencil.plain_xchain(
                f, params, (0, 5, 60), faces, spec=spec, fuse=k,
                use_noise=noise != 0, offsets=offs, row=row)
            for load in loads(torch, cuda_stencil, shape, torch.float32):
                bands = cuda_stencil.BAND_LAUNCHES
                with cuda_stencil.override(load):
                    got = cuda_stencil.fused_step(
                        f, params, (0, 5, 60), faces, spec=spec,
                        use_noise=noise != 0, fuse=k, offsets=offs, row=row,
                        band=True)
                torch.cuda.synchronize()
                check(cuda_stencil.BAND_LAUNCHES == bands + 1,
                      f"band {name} k={k}: not counted as a band launch")
                err = max((a.double() - b.double()).abs().max().item()
                          for a, b in zip(got, want))
                worst = max(worst, err)
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"band {name} {shape} k={k} noise={noise} load {load}:"
                      f" kernel != plain_xchain, max |diff| {err}")
                rows.append([name, list(shape), k, noise, load, err])
    log(f"  {len(rows)} band launches ({len(cases)} bodies, depth 2 and 4, "
        "noise 0 and 0.1, each load path the body takes) bitwise equal to "
        "plain_xchain")
    report["band_parity"] = rows
    return worst


def phase_overlap(torch, gs, cuda_stencil, workdir, stored, report):
    """Phase 4 (iii), the sharded round's exchange schedule at config
    (a)'s settings, 50 steps, every store bitwise equal to the stored
    step 50 and every launch count exact: the split-phase round at
    ``GS_FUSE=2`` on (8,1,1), (2,2,1) and (2,2,2) (bands through the
    x-chain kernel) and the same meshes with ``comm_overlap = "off"``;
    L=250 split on (3,1,1) (cp.async); ``GS_HALO_DEPTH=2`` at depth 1 on
    (8,1,1) and (2,2,2) (half the exchange rounds), at ``GS_FUSE=2`` on
    (2,2,2) (depth 4), and ``GS_HALO_DEPTH=3`` at ``GS_FUSE=2`` (depth 6
    steps down to k=2, with the warning); then ``driver.run_once`` of
    (b) at ``GS_FUSE=2``, ``GS_HALO_DEPTH=2`` under "auto", its store
    equal to phase 4 (b)'s at every step. Returns the band launches of
    the (2,2,2) split run (the kernels line's band entry)."""
    import contextlib
    import io

    import numpy as np

    from grayscott_jl_tpu_torch import driver
    from grayscott_jl_tpu_torch.config.settings import get_settings

    step50, u50, v50 = stored[0]
    check(step50 == 50, f"first stored step is {step50}")
    runs = {}

    def run(label, dims, steps=50, want=None, **kw):
        """``steps`` steps on a ``dims`` mesh on cuda:0 with the counts set
        to 0 just before and read just after; the fields against the
        stored step (or ``want``)."""
        sim = mesh_sim(gs, gs.Settings(**main_settings(**kw)), dims)
        cuda_stencil.reset_launches()
        t0 = time.perf_counter()
        sim.iterate(steps)
        sim.block_until_ready()
        wall = time.perf_counter() - t0
        counts = {"modes": {m: c for m, c in
                            cuda_stencil.MODE_LAUNCHES.items() if c},
                  "bands": cuda_stencil.BAND_LAUNCHES,
                  "loads": dict(cuda_stencil.LOAD_PATH_LAUNCHES)}
        got = sim.get_fields()
        for a, b in zip(got, want if want is not None else (u50, v50)):
            check(np.array_equal(a, b),
                  f"{label} on {dims} != the single-block step {steps}")
        runs[label] = {"mesh": list(dims), "wall_s": wall,
                       "overlap_applied": sim.overlap_applied,
                       "halo_depth": sim.halo_depth,
                       "exchange_rounds": sim.exchange_rounds, **counts}
        return sim, counts

    def expect(label, counts, n, rounds, per_round, bands):
        want = {m: n * rounds * c for m, c in per_round.items()}
        check(counts["modes"] == want
              and counts["bands"] == n * rounds * bands,
              f"{label}: launched {counts}, expected {want} with "
              f"{n * rounds * bands} bands")

    band_launches = None
    saved = {v: os.environ.pop(v, None) for v in ("GS_FUSE", "GS_HALO_DEPTH")}
    try:
        os.environ["GS_FUSE"] = "2"
        for dims, (per_round, bands) in SPLIT_MESHES.items():
            n = dims[0] * dims[1] * dims[2]
            label = "split_" + "x".join(map(str, dims))
            sim, counts = run(label, dims, comm_overlap="on")
            check(sim.overlap_applied and sim.exchange_rounds == 25,
                  f"{label}: overlap_applied {sim.overlap_applied}, "
                  f"{sim.exchange_rounds} exchange rounds")
            expect(label, counts, n, 25, per_round, bands)
            check(counts["loads"]["cp_async"] == 0,
                  f"{label} loaded its windows {counts['loads']}")
            if dims == (2, 2, 2):
                band_launches = counts["bands"]
                report.setdefault("load_path", {})["stencil_xchain_band"] = {
                    "path": "tma", "launches": band_launches}
            mode = "xchain" if dims[1:] == (1, 1) else "xychain"
            off, counts = run("fused_" + "x".join(map(str, dims)), dims,
                              comm_overlap="off")
            check(not off.overlap_applied, f"{dims} off: split engaged")
            expect(f"{dims} off", counts, n, 25, {mode: 1}, 0)
            log(f"  GS_FUSE=2 on {dims}: split {runs[label]['modes']} "
                f"({runs[label]['bands']} bands), fused {counts['modes']}; "
                "both bitwise equal to the stored step 50")
        L = 250
        single = gs.Simulation(gs.Settings(**main_settings(L=L)))
        single.iterate(50)
        sim, counts = run("split_3x1x1_L250", (3, 1, 1), L=L,
                          want=single.get_fields())
        expect("L=250 split", counts, 3, 25, {"xchain": 3}, 2)
        check(counts["loads"]["tma"] == 0,
              f"L=250 split loaded its windows {counts['loads']}")
        log("  L=250 on (3,1,1) split (pad-and-mask, cp.async): bitwise "
            "equal to the single block")

        os.environ.update(GS_FUSE="1", GS_HALO_DEPTH="2")
        for dims, (per_round, bands) in (((8, 1, 1), SPLIT_MESHES[8, 1, 1]),
                                         ((2, 2, 2), SPLIT_MESHES[2, 2, 2])):
            n = dims[0] * dims[1] * dims[2]
            label = "halo2_fuse1_" + "x".join(map(str, dims))
            sim, counts = run(label, dims)
            check(sim.halo_depth == 2 and sim.exchange_rounds == 25,
                  f"{label}: halo_depth {sim.halo_depth}, "
                  f"{sim.exchange_rounds} exchange rounds (depth 1: 50)")
            expect(label, counts, n, 25, per_round, bands)
        os.environ["GS_FUSE"] = "2"
        sim, counts = run("halo2_fuse2_2x2x2", (2, 2, 2), comm_overlap="on")
        # Depth 4: 12 rounds and a remainder round of depth 2.
        check(sim.exchange_rounds == 13, f"depth 4 made "
              f"{sim.exchange_rounds} exchange rounds, not 13")
        expect("halo_depth=2 GS_FUSE=2", counts, 8, 13, SPLIT_MESHES[2, 2, 2][0],
               4)
        os.environ["GS_HALO_DEPTH"] = "3"
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            sim = mesh_sim(gs, gs.Settings(**main_settings()), MESH)
        gate = sim.halo_depth_gate
        check(sim.halo_depth == 2 and gate is not None
              and (gate["requested"], gate["applied"]) == (3, 2)
              and gate["geometry"]["requested_depth"] == 6
              and gate["geometry"]["smem_bytes_requested"]
              > cuda_stencil.SMEM_LIMIT
              and "halo_depth=3" in err.getvalue(),
              f"GS_HALO_DEPTH=3 at GS_FUSE=2: gate {gate}, stderr "
              f"{err.getvalue()!r}")
        runs["halo3_gate"] = gate
        log(f"  GS_HALO_DEPTH=3 GS_FUSE=2: {err.getvalue().strip()}")
        sim, counts = run("halo3_fuse2_2x2x2", MESH)
        check(sim.exchange_rounds == 13, "GS_HALO_DEPTH=3 did not run at "
              "depth 4")
        log(f"  GS_HALO_DEPTH=2: depth 2 on (8,1,1) and (2,2,2) in 25 "
            "exchange rounds (depth 1: 50), depth 4 at GS_FUSE=2 in 13; "
            "GS_HALO_DEPTH=3 stepped down to 2; every run bitwise equal to "
            "the stored step 50, the launches exact")

        os.environ["GS_HALO_DEPTH"] = "2"
        out = os.path.join(workdir, "overlap.bp")
        cfg = os.path.join(workdir, "overlap.toml")
        write_config(cfg, **main_settings(), output=out)
        stats_path = os.path.join(workdir, "overlap_stats.json")
        os.environ["GS_TPU_STATS"] = stats_path
        try:
            dsim = driver.run_once(
                get_settings([cfg]),
                sim_factory=lambda settings, *, n_devices, seed: mesh_sim(
                    gs, settings, MESH, seed))
        finally:
            del os.environ["GS_TPU_STATS"]
        with open(stats_path, encoding="utf-8") as f:
            dstats = json.load(f)["config"]
        check(dstats["comm_overlap"] is True and dstats["halo_depth"] == 2
              and dsim.overlap_applied and dsim.fuse == 2,
              f"driver run: config comm_overlap {dstats['comm_overlap']}, "
              f"halo_depth {dstats['halo_depth']}")
        got = read_store(out)
        check(len(got) == len(stored) and all(
            a[0] == b[0] and all(np.array_equal(x, y)
                                 for x, y in zip(a[1:], b[1:]))
            for a, b in zip(got, stored)),
            "the GS_HALO_DEPTH=2 split store != phase 4 (b)'s")
        runs["driver"] = {"exchange_rounds": dsim.exchange_rounds,
                          "config": {k: dstats[k] for k in (
                              "comm_overlap", "halo_depth", "fuse",
                              "mesh_dims")}}
        log(f"  driver.run_once on {MESH} at GS_FUSE=2 GS_HALO_DEPTH=2 "
            f"(auto: split): {dsim.exchange_rounds} exchange rounds, "
            "RunStats config comm_overlap true, halo_depth 2; store "
            "bitwise equal to phase 4 (b)'s at every step")
    finally:
        for v, x in saved.items():
            os.environ.pop(v, None)
            if x is not None:
                os.environ[v] = x
    report["overlap_runs"] = runs
    return band_launches


#: Phase 4 (iv)'s chain runs in one pair of processes: the worker each
#: process runs (its share, 4 blocks, on cuda:0), one JSON line per case.
MP_WORKER = """\
import json, os, sys, time
from grayscott_jl_tpu_torch import driver, launch
from grayscott_jl_tpu_torch.config.settings import get_settings
from grayscott_jl_tpu_torch.ops import cuda_stencil
from grayscott_jl_tpu_torch.parallel import distributed

launch.die_with_parent()
distributed.ensure_started("cuda")
for case in json.loads(sys.argv[1]):
    os.environ.update(case["env"])
    os.environ["GS_TPU_STATS"] = case["cfg"][:-len(".toml")] + "_stats.json"
    distributed.reset_p2p_stats()
    cuda_stencil.reset_launches()
    t0 = time.perf_counter()
    sim = driver.run_once(get_settings([case["cfg"]]), n_devices=4)
    wall = time.perf_counter() - t0
    print("CASE " + json.dumps({
        "label": case["label"], "rank": distributed.process_index(),
        "backend": distributed.backend(), "wall_s": wall,
        "modes": {m: c for m, c in cuda_stencil.MODE_LAUNCHES.items() if c},
        "bands": cuda_stencil.BAND_LAUNCHES,
        "overlap_applied": sim.overlap_applied,
        "devices": sorted({str(d) for d in sim.mesh.devices}),
        "p2p": distributed.p2p_stats()}), flush=True)
"""

#: Phase 4 (iv)'s chain cases: label -> (mesh, comm_overlap).
MP_CHAINS = {"split_8x1x1": ((8, 1, 1), "on"),
             "fused_8x1x1": ((8, 1, 1), "off"),
             "split_4x2x1": ((4, 2, 1), "on"),
             "fused_4x2x1": ((4, 2, 1), "off")}

#: The worker's last case: config (b) again, timed warm (the kernels
#: loaded and the group connected by the cases before it).
MP_WARM = "mesh_warm"


def phase_multiprocess(torch, gs, cuda_stencil, workdir, stored, report):
    """Phase 4 (iv), the run of two processes on ``cuda:0`` (gloo: the
    processes share the card), through ``launch.py``: config (b) — L=256,
    (2,2,2), 200 steps, plotgap 50, a checkpoint every 100, at
    ``GS_ASYNC_IO_DEPTH=2`` — four blocks in each process; its
    two-writer store bitwise equal to phase 4 (b)'s, its ``.pvti``
    pieces reassembling to the store, its checkpoint merged and a
    two-process restart from step 100 reproducing step 200, the
    processes' launches adding up to phase 4 (b)'s. Then the chains
    across the process boundary at ``GS_FUSE=2``, split and fused, in
    one pair of processes: (8,1,1) bitwise equal to phase 4 (iii)'s
    reference (the stored step 50), (4,2,1) to a one-process run of the
    same mesh made here, the launches adding up; last, config (b) once
    more in that pair, warm, its store bitwise again. Prints the warm
    2-process and phase 4 (b)'s 1-process ms/step and the cross-process
    exchange ms/step (host time in ``distributed.p2p``)."""
    import glob

    import numpy as np

    from grayscott_jl_tpu_torch import launch
    from grayscott_jl_tpu_torch.io.bplite import BpReader
    from grayscott_jl_tpu_torch.io.vtk import read_vti

    run = {}
    base_env = {k: v for k, v in os.environ.items()
                if k not in ("GS_TPU_STATS", "GS_FUSE", "GS_HALO_DEPTH",
                             "GS_TPU_MESH_DIMS", "GS_COMM_OVERLAP")}
    base_env["GS_ASYNC_IO_DEPTH"] = "2"

    def pair(name, cfg):
        """The CLI on ``cfg`` as two processes of 4 blocks; the ranks'
        RunStats summaries."""
        stats = os.path.join(workdir, f"{name}_stats.json")
        logf = os.path.join(workdir, f"{name}.log")
        t0 = time.perf_counter()
        with open(logf, "w", encoding="utf-8") as f:
            codes = launch.launch(2, cfg, 4, env={**base_env,
                                                  "GS_TPU_STATS": stats},
                                  cwd=workdir, timeout=300, stdout=f,
                                  stderr=subprocess.STDOUT)
        wall = time.perf_counter() - t0
        with open(logf, encoding="utf-8") as f:
            out = f.read()
        check(codes == [0, 0], f"the two-process {name} run exited {codes}:"
              f"\n{out[-4000:]}")
        ranks = []
        for r in range(2):
            with open(f"{stats}.rank{r}", encoding="utf-8") as f:
                ranks.append(json.load(f))
        return ranks, wall

    mp = os.path.join(workdir, "mp")
    os.makedirs(mp)
    out = os.path.join(mp, "mesh.bp")
    ckpt = os.path.join(mp, "mesh_ckpt.bp")
    cfg = os.path.join(mp, "mesh.toml")
    write_config(cfg, **main_settings(), output=out, checkpoint=True,
                 checkpoint_freq=100, checkpoint_output=ckpt)
    ranks, wall = pair("mesh", cfg)
    for r, st in enumerate(ranks):
        c = st["config"]
        check(c["process_index"] == r and c["process_count"] == 2
              and c["backend"] == "gloo" and c["cards"] == [0]
              and c["mesh_dims"] == list(MESH) and c["fuse"] == 1
              and c["async_io_depth"] == 2,
              f"process {r} recorded {c}")
    one = report["sharded_main_path"]
    summed = {}
    for st in ranks:
        for m, n in st["config"]["launches"]["modes"].items():
            summed[m] = summed.get(m, 0) + n
    want_b = {m: n for m, n in one["launches"].items() if n}
    check(summed == want_b and all(
              st["config"]["launches"]["modes"]["faces6"] * 2
              == want_b["faces6"] for st in ranks),
          f"the processes launched {[st['config']['launches'] for st in ranks]}"
          f", phase 4 (b) {want_b}")
    got = read_store(out)
    ref = read_store(os.path.join(workdir, "mesh.bp"))
    check([s for s, *_ in got] == [s for s, *_ in ref]
          and all(np.array_equal(x, y) for a, b in zip(got, ref)
                  for x, y in zip(a[1:], b[1:])),
          "the two-process store != phase 4 (b)'s")
    with BpReader(ckpt) as r:
        check(r.num_steps() == 2 and [len(r.boxes("u", i)) for i in (0, 1)]
              == [8, 8], "the two-writer checkpoint did not merge")
    step, u, v = got[-1]
    vtk = os.path.join(mp, "mesh.vtk")
    pieces = sorted(glob.glob(os.path.join(vtk, f"step_{step:07d}_b*.vti")))
    check(len(pieces) == 8 and os.path.isfile(
        os.path.join(vtk, f"step_{step:07d}.pvti")),
        f"{len(pieces)} .vti pieces of step {step}")
    whole = {"U": np.full_like(u, np.nan), "V": np.full_like(v, np.nan)}
    for piece in pieces:
        extent, fields = read_vti(piece)
        for name in whole:
            whole[name][tuple(slice(lo, hi) for lo, hi in extent)] = (
                fields[name])
    check(np.array_equal(whole["U"], u) and np.array_equal(whole["V"], v),
          "the .pvti pieces do not reassemble to the store's step "
          f"{step}")
    steps = MAIN_STEPS
    ms_cold = max(st["phases_s"]["compute"] for st in ranks) / steps * 1e3
    log(f"  config (b) as 2 processes of 4 blocks on cuda:0 (gloo): "
        f"launches {summed} add up to phase 4 (b)'s; store bitwise equal "
        f"to phase 4 (b)'s, 8 .pvti pieces reassemble to its step {step}; "
        f"wall {wall:.1f} s, {ms_cold:.3f} ms/step cold (the first steps "
        "load the kernels and connect the group)")
    run["mesh"] = {"wall_s": wall, "ms_per_step_cold": ms_cold,
                   "launches": [st["config"]["launches"] for st in ranks],
                   "p2p": [st["config"]["p2p"] for st in ranks],
                   "phases_s": [st["phases_s"] for st in ranks]}

    out2 = os.path.join(mp, "mesh_restart.bp")
    cfg2 = os.path.join(mp, "mesh_restart.toml")
    write_config(cfg2, **main_settings(), output=out2, restart=True,
                 restart_input=ckpt, restart_step=100)
    pair("mesh_restart", cfg2)
    step2, u2, v2 = read_store(out2)[-1]
    check(step2 == step == steps and np.array_equal(u2, u)
          and np.array_equal(v2, v),
          "the two-process restart from step 100 != step 200")
    log("  a two-process restart from the two-writer checkpoint at step "
        "100 reproduces step 200 bitwise")

    # The chains: one-process (4,2,1) runs first, then the pair.
    step50, u50, v50 = stored[0]
    want = {}
    saved = value_from_env("GS_FUSE")
    os.environ["GS_FUSE"] = "2"
    try:
        for label, (dims, ov) in MP_CHAINS.items():
            if dims != (4, 2, 1):
                rec = report["overlap_runs"][label]
                want[label] = (rec["modes"], rec["bands"], (u50, v50))
                continue
            sim = mesh_sim(gs, gs.Settings(**main_settings(
                comm_overlap=ov)), dims)
            cuda_stencil.reset_launches()
            sim.iterate(50)
            sim.block_until_ready()
            want[label] = ({m: c for m, c in
                            cuda_stencil.MODE_LAUNCHES.items() if c},
                           cuda_stencil.BAND_LAUNCHES, sim.get_fields())
            check(sim.overlap_applied == (ov == "on"),
                  f"one process {label}: overlap_applied "
                  f"{sim.overlap_applied}")
    finally:
        if saved is None:
            os.environ.pop("GS_FUSE", None)
        else:
            os.environ["GS_FUSE"] = saved
    cases = []
    for label, (dims, ov) in MP_CHAINS.items():
        cfg = os.path.join(mp, f"{label}.toml")
        write_config(cfg, **main_settings(steps=50, comm_overlap=ov),
                     output=os.path.join(mp, f"{label}.bp"))
        cases.append({"label": label, "cfg": cfg, "env": {
            "GS_FUSE": "2", "GS_TPU_MESH_DIMS": ",".join(map(str, dims))}})
    warm_cfg = os.path.join(mp, f"{MP_WARM}.toml")
    write_config(warm_cfg, **main_settings(),
                 output=os.path.join(mp, f"{MP_WARM}.bp"))
    cases.append({"label": MP_WARM, "cfg": warm_cfg, "env": {
        "GS_FUSE": "", "GS_TPU_MESH_DIMS": ",".join(map(str, MESH))}})
    port = launch.free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MP_WORKER, json.dumps(cases)], cwd=mp,
        env=launch.process_env(r, 2, port, base_env),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    chain_wall = time.perf_counter() - t0
    check(all(p.returncode == 0 for p in procs),
          "the two-process chain runs exited "
          f"{[p.returncode for p in procs]}:\n"
          + "\n".join(o[-3000:] for o in outs))
    results = {}
    for o in outs:
        for line in o.splitlines():
            if line.startswith("CASE "):
                r = json.loads(line[5:])
                results.setdefault(r["label"], []).append(r)
    chains = {}
    for label, (dims, ov) in MP_CHAINS.items():
        recs = sorted(results.get(label, []), key=lambda r: r["rank"])
        check(len(recs) == 2, f"{label}: results {recs}")
        modes, bands, fields = want[label]
        summed = {}
        for r in recs:
            for m, n in r["modes"].items():
                summed[m] = summed.get(m, 0) + n
        check(summed == modes and sum(r["bands"] for r in recs) == bands
              and all(r["overlap_applied"] == (ov == "on")
                      and r["backend"] == "gloo"
                      and r["devices"] == ["cuda:0"] for r in recs),
              f"{label}: the processes launched {recs}, one process "
              f"{modes} with {bands} bands")
        s50, *got = read_store(os.path.join(mp, f"{label}.bp"))[-1]
        check(s50 == 50 and all(np.array_equal(a, b)
                                for a, b in zip(got, fields)),
              f"{label} across two processes != its one-process run")
        chains[label] = {"mesh": list(dims), "modes": summed,
                         "bands": sum(r["bands"] for r in recs),
                         "p2p": [r["p2p"] for r in recs],
                         "wall_s": [r["wall_s"] for r in recs]}
    warm = sorted(results.get(MP_WARM, []), key=lambda r: r["rank"])
    check(len(warm) == 2 and sum(r["modes"].get("faces6", 0) for r in warm)
          == want_b["faces6"], f"{MP_WARM}: results {warm}")
    warm_store = read_store(os.path.join(mp, f"{MP_WARM}.bp"))
    check(len(warm_store) == len(ref) and all(
              np.array_equal(x, y) for a, b in zip(warm_store, ref)
              for x, y in zip(a, b)),
          "the warm two-process run of (b) != phase 4 (b)'s store")
    warm_stats = []
    for r in range(2):
        with open(os.path.join(mp, f"{MP_WARM}_stats.json.rank{r}"),
                  encoding="utf-8") as f:
            warm_stats.append(json.load(f))
    ms_one = one["run_stats"]["phases_s"]["compute"] / steps * 1e3
    ms_two = max(st["phases_s"]["compute"] for st in warm_stats) / steps * 1e3
    ms_x = max(st["config"]["p2p"]["seconds"]
               for st in warm_stats) / steps * 1e3
    log(f"  config (b) warm, 2 processes on cuda:0 (gloo): {ms_two:.3f} "
        f"ms/step (1 process, phase 4 (b): {ms_one:.3f}), cross-process "
        f"exchange {ms_x:.3f} ms/step of host time "
        f"({warm_stats[0]['config']['p2p']})")
    run["mesh_warm"] = {"ms_per_step_2proc": ms_two,
                        "ms_per_step_1proc": ms_one,
                        "exchange_ms_per_step": ms_x,
                        "p2p": [st["config"]["p2p"] for st in warm_stats],
                        "phases_s": [st["phases_s"] for st in warm_stats]}
    log(f"  GS_FUSE=2 across two processes on cuda:0, split and fused: "
        f"(8,1,1) bitwise equal to phase 4 (iii)'s step 50, (4,2,1) to "
        f"its one-process run; launches add up "
        f"({ {k: (v['modes'], v['bands']) for k, v in chains.items()} }); "
        f"wall {chain_wall:.1f} s")
    run["chains"] = chains
    report["multiprocess"] = run


#: Relative tolerance of a numerics report's ``mean`` and ``l2``
#: against a float64 numpy recomputation from the stored step (the
#: probe sums float32 cells in float64 on the card, in another order).
OBS_RTOL = 1e-5


def reset_sinks():
    """Drop the process-wide sinks, so that the next run resolves them
    from the environment."""
    from grayscott_jl_tpu_torch.obs import events, metrics, trace

    events.reset_events()
    metrics.reset_metrics()
    trace.reset_tracer()


def sink_env(d):
    """Every observability sink armed into directory ``d``."""
    return {"GS_EVENTS": os.path.join(d, "events.jsonl"),
            "GS_METRICS": os.path.join(d, "metrics.jsonl"),
            "GS_METRICS_INTERVAL_S": "0.05",
            "GS_METRICS_PROM": os.path.join(d, "prom.txt"),
            "GS_TRACE": os.path.join(d, "trace.json"),
            "GS_NUMERICS": "boundary"}


def check_sinks(sinks, store, summary, label):
    """Phase 4 (v)'s checks of one run's sinks: every file there, none
    broken, the trace valid, the events holding run_start, one output
    per stored step, one checkpoint per checkpoint step, one numerics
    record per write boundary and run_complete, the Prometheus dump
    holding ``step_latency_us``, and each numerics report's min/max
    equal to, and mean/l2 within ``OBS_RTOL`` of, a float64 numpy
    recomputation from the stored step. Returns the worst relative
    error of mean/l2 and the counts."""
    import numpy as np

    from grayscott_jl_tpu_torch.obs import events, trace

    for name in ("events.jsonl", "metrics.jsonl", "prom.txt", "trace.json"):
        check(os.path.isfile(os.path.join(sinks, name)),
              f"{label}: sink {name} missing")
    obs = summary["obs"]
    check(obs["events"]["broken"] is None and obs["trace"]["dropped"] == 0,
          f"{label}: a sink broke or dropped: {obs}")
    with open(os.path.join(sinks, "trace.json"), encoding="utf-8") as f:
        doc = json.load(f)
    problems = trace.validate_trace(doc)
    check(not problems, f"{label}: trace invalid: {problems[:3]}")
    evs = events.parse_events(os.path.join(sinks, "events.jsonl"))
    got = read_store(store)
    steps = [s for s, *_ in got]
    kinds = [e["kind"] for e in evs]
    at = lambda kind: [e["step"] for e in evs if e["kind"] == kind]  # noqa: E731
    check(kinds[0] == "run_start" and kinds[-1] == "run_complete",
          f"{label}: events {kinds}")
    check(at("output") == steps and at("numerics") == steps
          and at("checkpoint") == [100, 200],
          f"{label}: output {at('output')}, numerics {at('numerics')}, "
          f"checkpoint {at('checkpoint')}; stored {steps}")
    with open(os.path.join(sinks, "prom.txt"), encoding="utf-8") as f:
        check("step_latency_us" in f.read(),
              f"{label}: no step_latency_us in the Prometheus dump")
    with open(os.path.join(sinks, "metrics.jsonl"), encoding="utf-8") as f:
        records = len(f.read().splitlines())
    worst = 0.0
    by_step = {s: fields for s, *fields in got}
    for e in (e for e in evs if e["kind"] == "numerics"):
        for name, arr in zip(("u", "v"), by_step[e["step"]]):
            rep = e["attrs"]["fields"][name]
            a = np.asarray(arr, dtype=np.float64)
            want = {"min": a.min(), "max": a.max(), "mean": a.mean(),
                    "l2": math.sqrt(float(np.dot(a.ravel(), a.ravel())))}
            check(rep["min"] == want["min"] and rep["max"] == want["max"]
                  and rep["nonfinite"] == 0,
                  f"{label}: step {e['step']} {name}: {rep} vs {want}")
            for stat in ("mean", "l2"):
                err = abs(rep[stat] - want[stat]) / abs(want[stat])
                check(err <= OBS_RTOL, f"{label}: step {e['step']} {name} "
                      f"{stat} {rep[stat]} vs {want[stat]} (rel {err:.2e})")
                worst = max(worst, err)
    return {"max_rel_err": worst, "events": len(evs),
            "metrics_records": records, "trace_events": obs["trace"]["events"]}


def poisoning(gs, at, factory=None):
    """A ``sim_factory`` whose simulation scales the ``u`` corner
    (``Simulation.poison_drift``) once its step reaches ``at``."""
    def make(settings, *, n_devices, seed):
        sim = (factory(settings, n_devices=n_devices, seed=seed)
               if factory is not None
               else gs.Simulation(settings, n_devices=n_devices, seed=seed))
        iterate = sim.iterate

        def stepped(n):
            iterate(n)
            if sim.step == at:
                sim.poison_drift()

        sim.iterate = stepped
        return sim

    return make


def phase_obs(torch, gs, cuda_stencil, workdir, stored, report):
    """Phase 4 (v), the observability sinks (``obs/``) on the main paths:
    config (a) and the (2,2,2) mesh (b), each in the order obs off, on,
    on, off (``GS_EVENTS``, ``GS_METRICS`` at 0.05 s, ``GS_METRICS_PROM``,
    ``GS_TRACE`` and ``GS_NUMERICS=boundary`` armed): every store
    byte-identical to the others and bitwise equal to phase 4's, the
    sinks checked (``check_sinks``), the walls printed; then (a) at
    ``GS_NUMERICS=every_round`` with ``GS_DRIFT_POLICY=abort`` and
    ``poison_drift`` after step 100, which must raise ``DriftError`` at
    step 100 with no step after 100 stored; then the probe's device time
    on the L=256 fields beside its bound and the host ms of
    ``numerics_stats`` on (a) and (b)."""
    import numpy as np

    from grayscott_jl_tpu_torch import driver
    from grayscott_jl_tpu_torch.config.settings import get_settings
    from grayscott_jl_tpu_torch.obs import events
    from grayscott_jl_tpu_torch.obs import numerics as obs_numerics
    from grayscott_jl_tpu_torch.resilience.health import DriftError

    def factory(settings, *, n_devices, seed):
        return mesh_sim(gs, settings, MESH, seed)

    smi = nvidia_smi("name,power.limit")
    rows = {}
    for layout, fac in (("single", None), ("mesh", factory)):
        digests = []
        walls = {"off": [], "on": []}
        checks = []
        for i, mode in enumerate(("off", "on", "on", "off")):
            name = f"obs_{layout}_{mode}_{i}"
            sinks = os.path.join(workdir, name + "_sinks")
            os.makedirs(sinks)
            env = sink_env(sinks) if mode == "on" else {}
            reset_sinks()
            try:
                d, summary, wall, launches = run_store(
                    torch, gs, cuda_stencil, workdir, name, 2, fac, env=env)
            finally:
                reset_sinks()
            check(launches > 0, f"obs {layout} {mode}: no launch")
            walls[mode].append(wall)
            digests.append(tree_digest(d))
            if mode == "on":
                checks.append(check_sinks(sinks, os.path.join(d, "gs.bp"),
                                          summary, f"obs {layout} {i}"))
            else:
                check(summary["obs"] is None and summary["numerics"] is None,
                      f"obs {layout} off: sinks armed {summary['obs']}")
            if i == 0:
                got = read_store(os.path.join(d, "gs.bp"))
                check([s for s, *_ in got] == [s for s, *_ in stored]
                      and all(np.array_equal(a, b)
                              for (_, *fa), (_, *fb) in zip(got, stored)
                              for a, b in zip(fa, fb)),
                      f"obs {layout}: store != phase 4's")
            shutil.rmtree(d)
            shutil.rmtree(sinks)
        check(all(dg == digests[0] for dg in digests[1:]),
              f"obs {layout}: files differ between obs on and off: "
              f"{[k for k in digests[0] if digests[0][k] != digests[1].get(k)]}")
        row = {"wall_off_s": walls["off"], "wall_on_s": walls["on"],
               "files": len(digests[0]), "sinks": checks}
        rows[layout] = row
        log(f"  {layout}: stores byte-identical obs on/off ({row['files']} "
            f"files); wall obs off {walls['off']} s, on {walls['on']} s; "
            f"numerics mean/l2 worst rel err "
            f"{max(c['max_rel_err'] for c in checks):.2e}; {smi}")

    # The drift gate under abort, every round, the corner scaled 8x
    # after step 100.
    d = os.path.join(workdir, "obs_drift")
    os.makedirs(d)
    cfg = os.path.join(d, "cfg.toml")
    write_config(cfg, **main_settings(), output=os.path.join(d, "gs.bp"),
                 checkpoint=True, checkpoint_freq=100,
                 checkpoint_output=os.path.join(d, "ckpt.bp"))
    env = {"GS_EVENTS": os.path.join(d, "events.jsonl"),
           "GS_NUMERICS": "every_round", "GS_DRIFT_POLICY": "abort"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    raised = None
    reset_sinks()
    try:
        driver.run_once(get_settings([cfg]), sim_factory=poisoning(gs, 100))
    except DriftError as e:
        raised = e
    finally:
        reset_sinks()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(raised is not None and raised.step == 100,
          f"poison_drift after step 100 under abort raised {raised!r}")
    out_steps = [s for s, *_ in read_store(os.path.join(d, "gs.bp"))]
    ckpt_steps = [s for s, *_ in read_store(os.path.join(d, "ckpt.bp"),
                                            ("u", "v"))]
    check(out_steps == [50] and ckpt_steps == [],
          f"drift abort stored output {out_steps}, checkpoints {ckpt_steps}")
    evs = events.parse_events(env["GS_EVENTS"])
    drifts = [e for e in evs if e["kind"] == "drift"]
    check(len(drifts) == 1 and drifts[0]["step"] == 100
          and "u.max" in drifts[0]["attrs"]["tripped"]
          and evs[-1]["kind"] == "run_error",
          f"drift events {drifts}, last {evs[-1]['kind']}")
    log(f"  drift abort: DriftError at step 100 ({raised}); stored output "
        f"{out_steps}, checkpoints {ckpt_steps}")
    shutil.rmtree(d)

    # The probe's cost: device time on the L=256 fields, against the
    # bytes it must read; host ms of a probe on (a) and (b).
    settings = gs.Settings(**main_settings())
    sim = gs.Simulation(settings)
    sim.iterate(10)
    mesh = mesh_sim(gs, settings, MESH)
    mesh.iterate(10)
    torch.cuda.synchronize()
    fields = sim.blocks[0]
    prof = device_profile(torch,
                          lambda: obs_numerics.device_partials(*fields))
    ops = device_ops(torch, lambda: obs_numerics.device_partials(*fields))
    events_ms = time_calls(torch,
                           lambda: obs_numerics.device_partials(*fields))
    b_ms, b_by = bound_of(2 * MAIN_L**3 * 4, 0)
    host = {}
    for name, s in (("single", sim), ("mesh", mesh)):
        s.numerics_stats()
        t0 = time.perf_counter()
        for _ in range(10):
            s.numerics_stats()
        host[name] = (time.perf_counter() - t0) * 1e3 / 10
    probe = {"device_ms": None if prof is None else prof["device_busy_ms"],
             "events_ms": events_ms, "bound_ms": b_ms, "bound_by": b_by,
             "host_ms_single": host["single"], "host_ms_mesh": host["mesh"],
             "ops_ms": ops, "card": smi}
    log(f"  numerics probe (u, v at L={MAIN_L} float32): device "
        f"{probe['device_ms']} ms (profiler), {events_ms:.4f} ms (CUDA "
        f"events), bound {b_ms:.4f} ms ({b_by}); numerics_stats host "
        f"{host['single']:.3f} ms single block, {host['mesh']:.3f} ms "
        f"(2,2,2) mesh; {smi}")
    for name, ms in list(ops.items())[:8]:
        log(f"    {ms:.4f} ms/probe  {name[:90]}")
    del sim, mesh, fields
    report["obs"] = {"rows": rows, "probe": probe}
    return rows


#: Phase 4 (vi)'s supervised runs of (a): name -> (fault plan, extra
#: environment, the journal's events and kinds in the reference's
#: order). The order is the reference's for the same plan, as
#: tests/test_torch_supervisor_journal.py holds it on the CPU, but for
#: the kernel failure: fatal in the port, it ends in ``gave_up`` where
#: the reference recovers on XLA.
RESILIENCE_RUNS = {
    "preempt": ("step=120:kind=preempt", "sinks",
                [("injected", "preempt"), ("attempt_phases", "preemption"),
                 ("recovery", "preemption")]),
    "io_error": ("step=50:kind=io_error", {},
                 [("injected", "io_error"),
                  ("attempt_phases", "transient-io"),
                  ("recovery", "transient-io")]),
    "nan": ("step=120:kind=nan", {"GS_HEALTH_POLICY": "rollback"},
            [("injected", "nan"), ("health", "health"),
             ("attempt_phases", "health"), ("recovery", "health")]),
    "drift": ("step=120:kind=drift",
              {"GS_DRIFT_POLICY": "rollback", "GS_NUMERICS": "boundary",
               "GS_DRIFT_LIMIT": "0.7"},
              [("injected", "drift"), ("drift", None),
               ("attempt_phases", "health"), ("recovery", "health")]),
    "kernel": ("step=160:kind=kernel", {},
               [("injected", "kernel"), ("attempt_phases", "kernel"),
                ("gave_up", "kernel")]),
    "ckpt_corrupt": ("step=120:kind=ckpt_corrupt;step=160:kind=preempt",
                     {"GS_CKPT_REPLICAS": "2", "GS_ASYNC_IO_DEPTH": "0"},
                     [("injected", "ckpt_corrupt"), ("injected", "preempt"),
                      ("attempt_phases", "preemption"),
                      ("recovery", "preemption"),
                      ("replica_failover", None)]),
    "bitflip": ("step=120:kind=bitflip", {"GS_CKPT_VERIFY": "full"},
                [("injected", "bitflip"), ("attempt_phases", "corruption"),
                 ("corruption", None), ("recovery", "corruption")]),
}

#: What every supervised run of phase 4 (vi) sets.
SUPERVISED = {"GS_SUPERVISE": "1", "GS_MAX_RESTARTS": "3",
              "GS_RESTART_BACKOFF_S": "0"}


def memory_now(torch):
    """After a garbage collection: the card's allocated bytes
    (``torch.cuda.memory_allocated``) and the pinned host bytes held by
    live ``HostRing``s (the snapshots' buffers) — what a leaked attempt
    would keep."""
    import gc
    import warnings

    from grayscott_jl_tpu_torch.simulation import HostRing

    gc.collect()
    with warnings.catch_warnings():
        # isinstance() on every live object touches torch's deprecated
        # module attributes.
        warnings.simplefilter("ignore", FutureWarning)
        ring = sum(o.nbytes for o in gc.get_objects()
                   if isinstance(o, HostRing))
    return {"allocated_b": torch.cuda.memory_allocated(), "host_ring_b": ring}


def phase_resilience(torch, gs, cuda_stencil, workdir, report):
    """Phase 4 (vi), the supervisor, fault plans, watchdog and SDC screen
    on the card's main paths (``resilience/``), every supervised run
    with ``GS_RESTART_BACKOFF_S=0`` and its stores compared file by file
    (sha256, ``tree_digest``) with those phase 4 wrote for (a)
    (``gs.bp``, ``gs.vtk``, ``ckpt.bp``) and (b) (``mesh.bp``...):

    1. (a) supervised once per plan of :data:`RESILIENCE_RUNS` (preempt
       with every obs sink armed, io_error, nan under rollback, drift
       under rollback, kernel, ckpt_corrupt with two replicas — the
       replica compared —, bitflip under ``GS_CKPT_VERIFY=full`` — its
       integrity sidecars aside): the journal's records in the
       reference's order, the stores equal, launches counted in the
       attempt that completes and no degradation; a kernel failure is
       fatal (``InjectedKernelError`` re-raised after ``gave_up``), and
       the user's relaunch resumes from the step-100 checkpoint on the
       kernels;
    2. (b) supervised with preempt at step 120;
    3. (a) with hang at step 150 under ``GS_WATCHDOG_STEP_ROUND_S=5``:
       the ``hang`` record with the stack dump, a hang recovery;
    4. (a) through the CLI in a subprocess, stalled at step 150 (after
       the step-100 checkpoint) and sent SIGTERM: exit 75, then a
       supervised relaunch resumes from the marker; output stores equal;
    5. SDC: (a) at ``spot`` (and ``off``, for the wall); (a) with one
       ``sdc`` fault (``SDCError`` naming ``cuda:0`` and block 0, a
       restart from the verified step 100); (a) with two (quarantine,
       then ``gave_up`` "every device quarantined"); (b) at ``shadow``
       (and ``off``): ``shadow_degraded`` on one card;
    6. the time from each failure to the next attempt's first step,
       ``torch.cuda.memory_allocated`` and the pinned ring bytes at each
       attempt's start and after the run, and the device ms of one SDC
       replay and checksum of a 50-step chunk on (a) and (b) beside the
       chunk, each printed with the card's name and power limit."""
    import numpy as np

    from grayscott_jl_tpu_torch.config.settings import get_settings
    from grayscott_jl_tpu_torch.resilience import sdc as sdc_mod
    from grayscott_jl_tpu_torch.resilience.faults import InjectedKernelError
    from grayscott_jl_tpu_torch.resilience import supervisor

    smi = nvidia_smi("name,power.limit")
    stores = {"a": {s: tree_digest(os.path.join(workdir, s))
                    for s in ("gs.bp", "gs.vtk", "ckpt.bp")},
              "b": {s: tree_digest(os.path.join(workdir, m))
                    for s, m in (("gs.bp", "mesh.bp"), ("gs.vtk", "mesh.vtk"),
                                 ("ckpt.bp", "mesh_ckpt.bp"))}}

    def mesh_factory(settings, *, n_devices, seed):
        return mesh_sim(gs, settings, MESH, seed)

    out = {"card": smi, "runs": {}}

    def supervised(name, env, factory=None, layout="a", expect=None,
                   relaunch=None):
        """``supervise`` on config ``layout`` under ``env``, the attempts
        timed and their memory read through the simulation factory;
        ``relaunch``: the directory of a stopped run, resumed from its
        durable checkpoint. Returns (run dir, summary, journal,
        attempts, error)."""
        d = relaunch or os.path.join(workdir, f"res_{name}")
        os.makedirs(d, exist_ok=relaunch is not None)
        cfg = os.path.join(d, "cfg.toml")
        keys = dict(output=os.path.join(d, "gs.bp"), checkpoint=True,
                    checkpoint_freq=100,
                    checkpoint_output=os.path.join(d, "ckpt.bp"))
        if relaunch is not None:
            keys.update(restart=True, restart_input=keys["checkpoint_output"],
                        restart_step=supervisor.latest_durable_checkpoint(
                            get_settings([cfg])))
        write_config(cfg, **main_settings(), **keys)
        attempts = []

        def timing(settings, *, n_devices, seed):
            attempts.append({"start_t": time.time(), **memory_now(torch)})
            sim = (factory(settings, n_devices=n_devices, seed=seed)
                   if factory is not None
                   else gs.Simulation(settings, n_devices=n_devices,
                                      seed=seed))
            iterate, rec = sim.iterate, attempts[-1]

            def first(n):
                rec.setdefault("first_step_t", time.time())
                iterate(n)

            sim.iterate = first
            return sim

        stats = os.path.join(d, "stats.json")
        env = {**SUPERVISED, "GS_TPU_STATS": stats, **env}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        reset_sinks()
        error = None
        try:
            cuda_stencil.reset_launches()
            t0 = time.perf_counter()
            try:
                supervisor.supervise(get_settings([cfg]), sim_factory=timing)
            except Exception as e:  # noqa: BLE001 — judged below
                # Its frames would hold the failed attempt's simulation.
                e.__traceback__ = None
                error = e
            wall = time.perf_counter() - t0
            launches = cuda_stencil.LAUNCHES
        finally:
            reset_sinks()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        after = memory_now(torch)
        summary = None
        if os.path.exists(stats):
            with open(stats, encoding="utf-8") as f:
                summary = json.load(f)
        path = os.path.join(d, "gs.bp.faults.jsonl")
        events = []
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                events = [json.loads(x) for x in f if x.strip()]
        fails = [e["t"] for e in events if e["event"] == "attempt_phases"]
        for rec, t_fail in zip(attempts[1:], fails):
            rec["failure_to_first_step_s"] = rec["first_step_t"] - t_fail
        if expect is not None:
            got = [(e["event"], e.get("kind")) for e in events
                   if e["event"] != "sdc_check"]
            check(got == expect, f"{name}: journal {got}, expected {expect}")
        row = {"wall_s": wall, "launches": launches, "attempts": attempts,
               "after": after, "events": len(events),
               "error": None if error is None else repr(error)}
        if summary is not None:
            row["kernel_launches_last_attempt"] = summary["counters"].get(
                "kernel_launches", 0)
            row["kernel_selection"] = summary["config"]["kernel_selection"]
            row["sdc"] = summary["config"]["sdc"]
        out["runs"][name] = row
        return d, summary, events, attempts, error

    def same_stores(d, layout, name, skip=(), replica=False):
        for s, want in stores[layout].items():
            if s in skip:
                continue
            got = tree_digest(os.path.join(
                d, "ckpt.bp.r1" if replica and s == "ckpt.bp" else s))
            if name == "bitflip":
                got.pop("integrity.json", None)
                want = {k: v for k, v in want.items()
                        if k != "integrity.json"}
            check(got == want, f"{name}: {s} differs from phase 4's "
                  f"({layout}): {sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))[:5]}")

    def memory_flat(name, attempts, after):
        allocs = [a["allocated_b"] for a in attempts[1:]] + [
            after["allocated_b"]]
        rings = [a["host_ring_b"] for a in attempts[1:]] + [
            after["host_ring_b"]]
        check(max(allocs) <= attempts[0]["allocated_b"] + (1 << 20)
              and max(rings) == 0,
              f"{name}: memory grew with the attempts: allocated "
              f"{[a['allocated_b'] for a in attempts]} then "
              f"{after['allocated_b']}, host rings {rings}")

    # 1. (a), one supervised run per plan.
    for name, (plan, env, expect) in RESILIENCE_RUNS.items():
        sinks = None
        if env == "sinks":
            sinks = os.path.join(workdir, "res_sinks")
            os.makedirs(sinks)
            env = sink_env(sinks)
        d, summary, events, attempts, error = supervised(
            name, {**env, "GS_FAULTS": plan}, expect=expect)
        if name == "kernel":
            # Fatal: the run stops on the kernel path, and the user's
            # relaunch resumes from the step-100 checkpoint.
            check(isinstance(error, InjectedKernelError)
                  and out["runs"][name]["launches"] > 0
                  and "kernel failure" in events[-1].get("reason", ""),
                  f"kernel: raised {error!r} after "
                  f"{out['runs'][name]['launches']} launches, journal "
                  f"{events[-1:]}")
            memory_flat(name, attempts, out["runs"][name]["after"])
            name = "kernel_relaunch"
            n_before = len(events)
            d, summary, events, attempts, error = supervised(
                name, {}, relaunch=d)
            check(len(events) == n_before
                  and summary["config"]["attempt"] == 0
                  and summary["counters"].get("steps") == MAIN_STEPS - 100,
                  f"kernel relaunch: journal {events[n_before:]}, config "
                  f"attempt {summary['config'].get('attempt')}, "
                  f"{summary['counters'].get('steps')} steps")
        check(error is None, f"{name}: the supervised run raised {error!r}")
        same_stores(d, "a", name, replica=name == "ckpt_corrupt")
        row = out["runs"][name]
        check(row["launches"] > 0, f"{name}: no kernel launch")
        sel = summary["config"]["kernel_selection"] or {}
        check(row["kernel_launches_last_attempt"] > 0
              and "degraded_from" not in sel
              and summary["config"]["kernel_language"] == "cuda",
              f"{name}: later attempt launches "
              f"{row['kernel_launches_last_attempt']}, selection {sel}")
        memory_flat(name, attempts, row["after"])
        if sinks is not None:
            from grayscott_jl_tpu_torch.obs import events as obs_events

            kinds = [(e["kind"], e.get("attrs", {}).get("fault"))
                     for e in obs_events.parse_events(
                         os.path.join(sinks, "events.jsonl"))]
            check(("injected", "preempt") in kinds
                  and ("recovery", "preemption") in kinds
                  and os.path.isfile(os.path.join(sinks, "trace.json")),
                  f"preempt: the event stream holds {kinds[:12]}")
        log(f"  (a) supervised, {name} ({plan}): "
            f"{len(attempts)} attempts, {row['launches']} launches "
            f"({row['kernel_launches_last_attempt']} in the last), failure "
            f"to next first step "
            f"{[round(a.get('failure_to_first_step_s', 0), 4) for a in attempts[1:]]} s, "
            f"allocated {[a['allocated_b'] for a in attempts]} -> "
            f"{row['after']['allocated_b']} B, pinned rings "
            f"{[a['host_ring_b'] for a in attempts]} -> "
            f"{row['after']['host_ring_b']} B, wall {row['wall_s']:.3f} s; "
            f"stores equal to phase 4's [{smi}]")

    # 2. (b), preempt.
    d, summary, events, attempts, error = supervised(
        "mesh_preempt", {"GS_FAULTS": "step=120:kind=preempt"},
        factory=mesh_factory, layout="b",
        expect=RESILIENCE_RUNS["preempt"][2])
    check(error is None, f"(b) preempt raised {error!r}")
    same_stores(d, "b", "mesh_preempt")
    check(out["runs"]["mesh_preempt"]["kernel_launches_last_attempt"]
          == 8 * 100, f"(b) preempt: {out['runs']['mesh_preempt']}")
    memory_flat("mesh_preempt", attempts, out["runs"]["mesh_preempt"]["after"])
    log(f"  (b) supervised, preempt at 120: stores equal to phase 4's (b), "
        f"{out['runs']['mesh_preempt']['kernel_launches_last_attempt']} "
        f"6n-face launches in the resumed attempt [{smi}]")

    # 3. hang under the watchdog.
    d, summary, events, attempts, error = supervised(
        "hang", {"GS_FAULTS": "step=150:kind=hang",
                 "GS_WATCHDOG_STEP_ROUND_S": "5"},
        expect=[("injected", "hang"), ("hang", "hang"),
                ("attempt_phases", "hang"), ("recovery", "hang")])
    check(error is None, f"hang: {error!r}")
    hang = next(e for e in events if e["event"] == "hang")
    check(hang["phase"] == "step_round" and any(
        t["thread"] == "MainThread" and t["stack"] for t in hang["threads"]),
        f"hang: the record holds {hang.get('phase')}, "
        f"{[t['thread'] for t in hang.get('threads', [])]}")
    rec = next(e for e in events if e["event"] == "recovery")
    check("HangError" in rec["error"], f"hang: recovery {rec}")
    same_stores(d, "a", "hang")
    log(f"  (a) hang at 150 under a 5 s step_round deadline: HangError, "
        f"the stacks of {len(hang['threads'])} threads journaled, stores "
        f"equal [{smi}]")

    # 4. A real SIGTERM to the CLI, then a supervised relaunch.
    d = os.path.join(workdir, "res_sigterm")
    os.makedirs(d)
    cfg = os.path.join(d, "cfg.toml")
    write_config(cfg, **main_settings(), output=os.path.join(d, "gs.bp"),
                 checkpoint=True, checkpoint_freq=100,
                 checkpoint_output=os.path.join(d, "ckpt.bp"))
    env = dict(os.environ, **SUPERVISED, PYTHONPATH=REPO)
    env.update({"GS_FAULTS": "step=150:kind=hang", "GS_WATCHDOG": "off",
                "GS_HANG_BOUND_S": "300"})
    journal = os.path.join(d, "gs.bp.faults.jsonl")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "grayscott_jl_tpu_torch",
                             cfg], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        while proc.poll() is None and time.perf_counter() - t0 < 300:
            if os.path.exists(journal):
                with open(journal, encoding="utf-8") as f:
                    if '"injected"' in f.read():
                        break
            time.sleep(0.05)
        proc.send_signal(__import__("signal").SIGTERM)
        text, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 75,
          f"SIGTERM: the CLI exited {proc.returncode}: {text[-2000:]}")
    env.pop("GS_FAULTS")
    res = subprocess.run([sys.executable, "-m", "grayscott_jl_tpu_torch",
                          cfg], env=env, capture_output=True, text=True,
                         timeout=600)
    check(res.returncode == 0, f"SIGTERM relaunch: {res.stderr[-2000:]}")
    with open(journal, encoding="utf-8") as f:
        events = [json.loads(x) for x in f if x.strip()]
    kinds = [e["event"] for e in events]
    check(kinds == ["injected", "graceful_shutdown", "recovery"]
          and events[-1]["after"] == "graceful_shutdown"
          and events[-1]["action"] == "resumed_from_checkpoint_step_150",
          f"SIGTERM: journal {events}")
    same_stores(d, "a", "sigterm", skip=("ckpt.bp",))
    out["sigterm_s"] = time.perf_counter() - t0
    log(f"  (a) through the CLI: SIGTERM at step 150 -> exit 75, the "
        f"supervised relaunch resumed from the marker at step 150; output "
        f"stores equal ({out['sigterm_s']:.1f} s for both processes) "
        f"[{smi}]")

    # 5. SDC.
    walls = {}
    for layout, fac, modes in (("a", None, ("off", "spot")),
                               ("b", mesh_factory, ("off", "shadow"))):
        for mode in modes:
            d, summary, events, attempts, error = supervised(
                f"sdc_{layout}_{mode}", {"GS_SDC_CHECK": mode},
                factory=fac, layout=layout)
            check(error is None, f"SDC {layout} {mode}: {error!r}")
            same_stores(d, layout, f"sdc_{layout}_{mode}")
            walls[f"{layout}_{mode}"] = out["runs"][f"sdc_{layout}_{mode}"][
                "wall_s"]
            if mode != "off":
                # The replays cover the run's four chunks with the same
                # launches, counted apart from the run's.
                s = summary["config"]["sdc"]
                live = summary["counters"].get("kernel_launches", 0)
                check(s["checks"] == 4 and s["mismatches"] == 0
                      and s["verified_step"] == MAIN_STEPS
                      and s["shadow_degraded"] == (mode == "shadow")
                      and s["replay_launches"] == live > 0,
                      f"SDC {layout} {mode}: {s}, {live} live launches")
    log(f"  SDC screen: replay launches (a) "
        f"{out['runs']['sdc_a_spot']['sdc']['replay_launches']}, (b) "
        f"{out['runs']['sdc_b_shadow']['sdc']['replay_launches']}, each "
        f"equal to the run's own [{smi}]")
    log(f"  SDC screen: (a) spot {walls['a_spot']:.3f} s against off "
        f"{walls['a_off']:.3f} s; (b) shadow {walls['b_shadow']:.3f} s "
        f"against off {walls['b_off']:.3f} s (shadow_degraded on one "
        f"card); stores equal [{smi}]")
    d, summary, events, attempts, error = supervised(
        "sdc_one", {"GS_SDC_CHECK": "spot",
                    "GS_FAULTS": "step=120:kind=sdc"})
    check(error is None, f"SDC one fault: {error!r}")
    mism = [e for e in events if e["event"] == "sdc_mismatch"]
    rec = [e for e in events if e["event"] == "recovery"]
    check(len(mism) == 1 and mism[0]["device"] == "cuda:0"
          and mism[0]["block"] == 0 and mism[0]["step"] == 150
          and mism[0]["verified_step"] == 100 and len(rec) == 1
          and rec[0]["action"] == "resumed_from_checkpoint_step_100",
          f"SDC one fault: {mism} {rec}")
    same_stores(d, "a", "sdc_one")
    blocklist = value_from_env("GS_DEVICE_BLOCKLIST")
    try:
        d, summary, events, attempts, error = supervised(
            "sdc_two", {"GS_SDC_CHECK": "spot",
                        "GS_FAULTS": "step=120:kind=sdc;step=160:kind=sdc"})
        quarantined = value_from_env("GS_DEVICE_BLOCKLIST")
    finally:
        if blocklist is None:
            os.environ.pop("GS_DEVICE_BLOCKLIST", None)
        else:
            os.environ["GS_DEVICE_BLOCKLIST"] = blocklist
    q = [e for e in events if e["event"] == "device_quarantined"]
    gave = [e for e in events if e["event"] == "gave_up"]
    memory_flat("sdc_two", attempts, out["runs"]["sdc_two"]["after"])
    check(isinstance(error, sdc_mod.SDCError) and quarantined == "cuda:0"
          and [e["device"] for e in q] == ["cuda:0"] and gave
          and "every device quarantined" in gave[-1]["reason"],
          f"SDC two faults: {error!r}, blocklist {quarantined}, {q}, {gave}")
    log(f"  SDC: one flip at step 120 caught at 150 on cuda:0 block 0, "
        f"resumed from the verified step 100, stores equal; a second flip "
        f"quarantined cuda:0 and the supervisor gave up (every device "
        f"quarantined) [{smi}]")

    # 6. The replay's and the checksum's device time on (a) and (b).
    def cuda_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(True), torch.cuda.Event(True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    replay = {}
    for layout in ("a", "b"):
        s = gs.Settings(**main_settings())
        sim = (gs.Simulation(s) if layout == "a"
               else mesh_sim(gs, s, MESH))
        anchor = sim.retain_fields()
        chunk = cuda_ms(lambda: sim.replay_fields(anchor, 0, 50))
        ck = cuda_ms(lambda: sim.block_checksums(sim.blocks))

        def live():
            sim.iterate(50)

        live_ms = cuda_ms(live)
        replay[layout] = {"replay_ms": chunk, "checksum_ms": ck,
                          "chunk_ms": live_ms}
        del sim, anchor
    out["replay"] = replay
    log(f"  SDC replay of a 50-step chunk (device ms, CUDA events): (a) "
        f"{replay['a']['replay_ms']:.3f} ms + checksum "
        f"{replay['a']['checksum_ms']:.3f} ms against the chunk "
        f"{replay['a']['chunk_ms']:.3f} ms; (b) "
        f"{replay['b']['replay_ms']:.3f} + {replay['b']['checksum_ms']:.3f} "
        f"against {replay['b']['chunk_ms']:.3f} ms [{smi}]")
    report["resilience"] = out


def phase_reshard(torch, gs, cuda_stencil, workdir, report):
    """Phase 4 (vii), elastic resharding (``reshard/``) on config (b),
    L=256 float32 noise 0.1, every mesh on ``cuda:0``, each run with the
    launch counts set to 0 just before and read just after, and its
    stores held against phase 4's: the assembled arrays of ``gs.bp`` and
    ``ckpt.bp`` (and their attributes) bitwise at every step
    (``chaos.values_equal``: a store that changed mesh frames its blocks
    by whoever wrote each step) and the ``.vtk`` series byte for byte:

    1. the restore on another mesh: (b) run to its step-100 checkpoint
       on (2,2,2), then restarted in the same stores on (1,2,2) —
       exactly 4 x 100 ``kFaces6`` launches after the restart, a
       ``ckpt`` reshard of the store's recorded layout;
    2. the live move: (b) moved (2,2,2) -> (1,2,2) at step 50 and back
       at step 150 through ``run_once(reshape_poll=...)`` — 8 x 50 +
       4 x 100 + 8 x 50 ``kFaces6`` launches, two ``collective`` moves;
    3. (a) moved from its single block onto (2,2,2) at step 100 — 100
       ``kBlock`` and 8 x 100 ``kFaces6`` launches — against phase 4's
       (a) stores;
    4. each move's ``path``, ``bytes`` and ``wall_s`` (the move), the
       host wall of the driver's whole move between rounds (the trace's
       ``reshape`` span: drain, target, move, stores reopened), and the
       relayout's device time at L=256 (CUDA events around
       ``device_all_to_all_restore``, and the profiler's busy time)
       beside its byte bound, printed with the card's name and power
       limit. Every simulation runs ``kernel_language == "cuda"``, and
       after the live run the card's allocated bytes and the pinned ring
       bytes are back to what they were before it."""
    import numpy as np

    from grayscott_jl_tpu_torch import driver
    from grayscott_jl_tpu_torch.chaos import trees_equal, values_equal
    from grayscott_jl_tpu_torch.config.settings import get_settings
    from grayscott_jl_tpu_torch.reshard import plan as plan_mod
    from grayscott_jl_tpu_torch.reshard import restore

    smi = nvidia_smi("name,power.limit")
    mem0 = memory_now(torch)
    phase4 = {"a": ("gs.bp", "gs.vtk", "ckpt.bp"),
              "b": ("mesh.bp", "mesh.vtk", "mesh_ckpt.bp")}
    out = {"card": smi, "moves": {}}

    def on(dims):
        def make(settings, *, n_devices, seed):
            return mesh_sim(gs, settings, dims, seed)

        return None if dims == (1, 1, 1) else make

    def config(d, name="cfg", **kw):
        os.makedirs(d, exist_ok=True)
        cfg = os.path.join(d, f"{name}.toml")
        ckpt = os.path.join(d, "ckpt.bp")
        write_config(cfg, **{**main_settings(), **kw},
                     output=os.path.join(d, "gs.bp"), checkpoint=True,
                     checkpoint_freq=100, checkpoint_output=ckpt,
                     restart_input=ckpt)
        return cfg

    def same_as_phase4(d, layout, name):
        for got, want in zip(("gs.bp", "gs.vtk", "ckpt.bp"), phase4[layout]):
            g, w = os.path.join(d, got), os.path.join(workdir, want)
            bad = (trees_equal(w, g) if got.endswith(".vtk")
                   else values_equal(w, g))
            check(not bad, f"{name}: {got} differs from phase 4's ({layout})"
                  f": {bad[:5]}")

    def poll_at(requests):
        """A poll asking for ``requests[n]`` on its n-th call (the first
        comes before round one; a round is 50 steps)."""
        calls = [0]

        def poll():
            calls[0] += 1
            dims = requests.get(calls[0])
            return {"mesh_dims": list(dims)} if dims else None

        return poll

    def driven(cfg, dims, poll=None):
        """``run_once`` of ``cfg`` on ``dims``: (sim, launches by mode,
        wall s, the journal's reshard records, per move between rounds
        the trace's ``reshape`` span in s with its parts: the pipeline's
        drain (the ``io_drain`` spans inside it), ``reshape_live`` (the
        target built and the move) and the rest (the stores
        reopened))."""
        d = os.path.dirname(cfg)
        env = {"GS_FAULT_JOURNAL": os.path.join(d, "journal.jsonl"),
               "GS_TRACE": os.path.join(d, "trace.json")}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        reset_sinks()
        live_s = []
        real_live = driver.reshape_live

        def timed_live(*a, **k):
            t = time.perf_counter()
            try:
                return real_live(*a, **k)
            finally:
                live_s.append(time.perf_counter() - t)

        driver.reshape_live = timed_live
        try:
            cuda_stencil.reset_launches()
            t0 = time.perf_counter()
            sim = driver.run_once(get_settings([cfg]), sim_factory=on(dims),
                                  reshape_poll=poll)
            wall = time.perf_counter() - t0
            modes = {m: n for m, n in cuda_stencil.MODE_LAUNCHES.items() if n}
        finally:
            driver.reshape_live = real_live
            reset_sinks()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        moves = []
        if os.path.exists(env["GS_FAULT_JOURNAL"]):
            with open(env["GS_FAULT_JOURNAL"], encoding="utf-8") as f:
                moves = [e for e in map(json.loads, f)
                         if e["event"] == "reshard"]
        with open(env["GS_TRACE"], encoding="utf-8") as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
        spans = []
        for e, live in zip((e for e in events if e["name"] == "reshape"),
                           live_s):
            lo, hi = e["ts"], e["ts"] + e["dur"]
            drain = sum(x["dur"] for x in events if x["name"] == "io_drain"
                        and lo <= x["ts"] and x["ts"] + x["dur"] <= hi) / 1e6
            span = e["dur"] / 1e6
            spans.append({"span_s": span, "drain_s": drain,
                          "target_and_move_s": live,
                          "rest_s": span - drain - live})
        check(sim.kernel_language == "cuda",
              f"{cfg}: kernel_language {sim.kernel_language}")
        return sim, modes, wall, moves, spans

    def record(name, moves, spans, wall, modes):
        rows = [{"path": m["path"], "bytes": m["bytes"], "wall_s": m["wall_s"],
                 "old": m["old"]["mesh_dims"] if m["old"] else None,
                 "new": m["new"]["mesh_dims"], "step": m["step"]}
                for m in moves]
        for row, span in zip(rows, spans):
            row["between_rounds"] = span
        out["moves"][name] = {"moves": rows, "run_wall_s": wall,
                              "launches": modes}
        for row in rows:
            span = row.get("between_rounds")
            log(f"  {name}: {row['old']} -> {row['new']} at step "
                f"{row['step']} via {row['path']}, {row['bytes']} B, move "
                f"{row['wall_s']:.6f} s"
                + (f"; between rounds {span['span_s']:.3f} s = drain "
                   f"{span['drain_s']:.3f} + target and move "
                   f"{span['target_and_move_s']:.3f} + stores reopened "
                   f"{span['rest_s']:.3f}" if span else "") + f" [{smi}]")

    # 1. The restore on another mesh.
    d = os.path.join(workdir, "rs_ckpt")
    _, modes, _, _, _ = driven(config(d, steps=100), MESH)
    check(modes == {"faces6": 8 * 100},
          f"restore: the (2,2,2) run to step 100 launched {modes}")
    sim, modes, wall, moves, spans = driven(
        config(d, "resume", restart=True), (1, 2, 2))
    check(sim.domain.dims == (1, 2, 2) and modes == {"faces6": 4 * 100},
          f"restore on (1,2,2): {sim.domain.dims}, launched {modes}")
    check(sim.reshard is not None and sim.reshard["path"] == "ckpt"
          and [m["path"] for m in moves] == ["ckpt"],
          f"restore on (1,2,2): reshard {sim.reshard}, journal {moves}")
    same_as_phase4(d, "b", "restore on (1,2,2)")
    record("restore (b) 2x2x2 -> 1x2x2", moves, [], wall, modes)
    del sim

    # 2. The live move there and back.
    d = os.path.join(workdir, "rs_live")
    sim, modes, wall, moves, spans = driven(
        config(d), MESH, poll_at({2: (1, 2, 2), 4: MESH}))
    want = 8 * 50 + 4 * 100 + 8 * 50
    check(sim.domain.dims == MESH and modes == {"faces6": want},
          f"live (b): ended on {sim.domain.dims}, launched {modes}, "
          f"expected {want} 6n-face launches")
    check([(m["step"], m["path"]) for m in moves]
          == [(50, "collective"), (150, "collective")] and len(spans) == 2,
          f"live (b): moves {moves}, reshape spans {spans}")
    same_as_phase4(d, "b", "live (b)")
    record("live (b) 2x2x2 -> 1x2x2 -> 2x2x2", moves, spans, wall, modes)
    del sim
    # Nothing of the meshes moved from outlives the run.
    mem = memory_now(torch)
    check(mem["allocated_b"] <= mem0["allocated_b"] + (1 << 20)
          and mem["host_ring_b"] == mem0["host_ring_b"],
          f"live (b): {mem} held after the run, {mem0} before")
    out["memory_after_live"] = {"before": mem0, "after": mem}

    # 3. The single block onto a mesh.
    d = os.path.join(workdir, "rs_single")
    sim, modes, wall, moves, spans = driven(config(d), (1, 1, 1),
                                            poll_at({3: MESH}))
    check(sim.domain.dims == MESH
          and modes == {"chain": 100, "faces6": 8 * 100},
          f"single block -> (2,2,2): ended on {sim.domain.dims}, launched "
          f"{modes}")
    check([(m["step"], m["path"]) for m in moves] == [(100, "collective")],
          f"single block -> (2,2,2): moves {moves}")
    same_as_phase4(d, "a", "single block -> (2,2,2)")
    record("live (a) 1x1x1 -> 2x2x2", moves, spans, wall, modes)
    del sim

    # 4. The relayout's device time at L=256.
    def cuda_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(True), torch.cuda.Event(True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    settings = gs.Settings(**main_settings())
    relayout = {}
    for src_dims, dst_dims in ((MESH, (1, 2, 2)), ((1, 2, 2), MESH),
                               ((1, 1, 1), MESH)):
        src = (gs.Simulation(settings) if src_dims == (1, 1, 1)
               else mesh_sim(gs, settings, src_dims))
        src.iterate(2)
        dst = mesh_sim(gs, settings, dst_dims)
        plan = plan_mod.plan_restore(restore.layout_of(src),
                                     restore.layout_of(dst), L=MAIN_L)
        prov = restore.device_all_to_all_restore(src, plan, dst,
                                                 mode="collective")
        for a, b in zip(src.get_fields(), dst.get_fields()):
            check(np.array_equal(a, b), f"relayout {src_dims} -> {dst_dims} "
                  "changed the fields")
        ev = cuda_ms(lambda: restore.device_all_to_all_restore(
            src, plan, dst, mode="collective"))
        prof = device_profile(torch, lambda: restore._collective_tier(
            src, dst), reps=10)
        b_ms, b_by = bound_of(2 * prov["bytes"], 0)
        label = ("x".join(map(str, src_dims)) + " -> "
                 + "x".join(map(str, dst_dims)))
        relayout[label] = {"bytes": prov["bytes"], "events_ms": ev,
                           "profile": prof, "bound_ms": b_ms,
                           "bound_by": b_by, "move_wall_s": prov["wall_s"]}
        log(f"  relayout {label} at L={MAIN_L}: {prov['bytes']} B, CUDA "
            f"events {ev:.4f} ms, profiler device busy "
            f"{prof['device_busy_ms'] if prof else float('nan'):.4f} ms "
            f"(wall {prof['wall_ms'] if prof else float('nan'):.4f} ms), "
            f"bound {b_ms:.4f} ms ({b_by}) [{smi}]")
        del src, dst
    out["relayout"] = relayout
    report["reshard"] = out


def phase_auto(torch, gs, cuda_stencil, workdir, report):
    """Phase 4 (viii), Auto's decision on the card (``parallel/icimodel``,
    ``tune/``) on config (a), L=256 float32 noise 0.1, with
    ``GS_AUTOTUNE_CACHE`` in the workdir; each run with the launch counts
    set to 0 just before and read just after, and its stores held
    against phase 4 (a)'s (assembled arrays bitwise, ``.vtk``
    byte-identical):

    1. (a) under ``kernel_language = "Auto"`` through ``driver.main``:
       the analytic decision printed; under ``GS_AUTOTUNE=quick``
       (``GS_AUTOTUNE_BUDGET_S=60``) at least 2 candidates timed, the
       winner and each candidate's projected against measured µs/step
       printed, the run's launches exactly the adopted depth's and the
       tuning's exactly its candidates' rounds; then under ``cached``: a
       hit, 0 candidates timed, the same depth, every launch the run's;
    2. eight blocks on ``cuda:0`` with the mesh not pinned through
       ``driver.run_once``, under the default ``comm_overlap = "auto"``
       (the pick decides the split round): the adopted mesh, depth and
       round printed, its launches per mode equal to the same schedule
       pinned, its ``RunStats.comm`` the adopted mesh's; the projected
       against measured ms/step of the adopted schedule and of (2,2,2) at
       depth 1, the schedule an unpinned run took before Auto adopted
       meshes (timed in turn, twice each): the adopted one must be no
       slower; then the same blocks pinned at (2,2,2): the analytic pick
       is depth 1 (``kFaces6``);
    3. (a) moved onto (2,2,2) at step 100: ``RunStats.comm`` describes
       the new mesh.

    Every simulation runs ``kernel_language == "cuda"``."""
    from grayscott_jl_tpu_torch import driver
    from grayscott_jl_tpu_torch.chaos import trees_equal, values_equal
    from grayscott_jl_tpu_torch.config.settings import get_settings
    from grayscott_jl_tpu_torch.io.bplite import BpReader
    from grayscott_jl_tpu_torch.parallel import icimodel
    from grayscott_jl_tpu_torch.reshard.plan import LAYOUT_ATTRS
    from grayscott_jl_tpu_torch.utils.benchmark import time_sim_rounds

    smi = nvidia_smi("name,power.limit")
    out = {"card": smi}
    phase4 = ("gs.bp", "gs.vtk", "ckpt.bp")
    saved = {k: os.environ.get(k) for k in (
        "GS_AUTOTUNE", "GS_AUTOTUNE_CACHE", "GS_AUTOTUNE_BUDGET_S",
        "GS_TPU_STATS")}
    os.environ["GS_AUTOTUNE_CACHE"] = os.path.join(workdir, "tune_cache")
    os.environ["GS_AUTOTUNE_BUDGET_S"] = "60"

    def config(d, **kw):
        os.makedirs(d, exist_ok=True)
        cfg = os.path.join(d, "cfg.toml")
        ckpt = os.path.join(d, "ckpt.bp")
        write_config(cfg, **main_settings(kernel_language="Auto", **kw),
                     output=os.path.join(d, "gs.bp"), checkpoint=True,
                     checkpoint_freq=100, checkpoint_output=ckpt)
        return cfg

    def layout_only(a, b):
        """Whether the stores' attributes differ only in the layout
        record (``LAYOUT_ATTRS``: the mesh and depth that wrote them)."""
        with BpReader(a) as ra, BpReader(b) as rb:
            x, y = ra.attributes(), rb.attributes()
        diff = {k for k in set(x) | set(y) if str(x.get(k)) != str(y.get(k))}
        return diff <= set(LAYOUT_ATTRS)

    def same_as_phase4(d, name):
        for f in phase4:
            g, w = os.path.join(d, f), os.path.join(workdir, f)
            bad = (trees_equal(w, g) if f.endswith(".vtk")
                   else values_equal(w, g))
            if bad[:1] == ["attributes"] and layout_only(w, g):
                # A checkpoint records the schedule that wrote it.
                bad = bad[1:]
            check(not bad, f"{name}: {f} differs from phase 4 (a)'s: "
                  f"{bad[:5]}")

    def run(d, fn):
        """``fn()`` with the counts set to 0 and ``GS_TPU_STATS`` in
        ``d``: (sim, total launches, launches by mode, stats)."""
        os.environ["GS_TPU_STATS"] = os.path.join(d, "stats.json")
        cuda_stencil.reset_launches()
        t0 = time.perf_counter()
        sim = fn()
        wall = time.perf_counter() - t0
        total = cuda_stencil.LAUNCHES
        modes = {m: n for m, n in cuda_stencil.MODE_LAUNCHES.items() if n}
        os.environ.pop("GS_TPU_STATS")
        with open(os.path.join(d, "stats.json"), encoding="utf-8") as f:
            stats = json.load(f)
        check(sim.kernel_language == "cuda",
              f"{d}: kernel_language {sim.kernel_language}")
        return sim, total, modes, stats, wall

    def chunk_launches(fuse, steps, chunks):
        cap = cuda_stencil.max_feasible_fuse(4)
        n = 0
        for _ in range(chunks):
            f = min(fuse, steps)
            rounds, rem = divmod(steps, f)
            n += rounds * math.ceil(f / cap) + (
                math.ceil(rem / cap) if rem else 0)
        return n

    try:
        # 1. (a) under Auto: quick, then cached.
        os.environ["GS_AUTOTUNE"] = "quick"
        d = os.path.join(workdir, "auto_quick")
        sim, total, modes, stats, wall = run(
            d, lambda: driver.main([config(d)]))
        sel = sim.kernel_selection
        prov = sel["autotune"]
        log(f"  Auto on (a): {sel['reason']}; autotune {prov['mode']} "
            f"{prov['source']}, {prov['candidates_timed']} candidates timed "
            f"in {prov['tuning_s']:.3f} s, winner {prov.get('winner')}")
        check(prov["source"] == "measured" and prov["candidates_timed"] >= 2,
              f"quick on (a): {prov}")
        with open(prov["cache_path"], encoding="utf-8") as f:
            rec = json.load(f)
        cands = []
        for m in rec["measurements"]:
            c = m["candidate"]
            cands.append({"fuse": c["fuse"], "analytic": c["analytic"],
                          "projected_us": c["projected_step_us"],
                          "measured_us": m.get("median_us_per_step"),
                          "rounds": len(m.get("rounds_us_per_step") or [])})
            log(f"    candidate depth {c['fuse']}"
                f"{' (the analytic pick)' if c['analytic'] else ''}: "
                f"projected {c['projected_step_us']} us/step, measured "
                f"{m.get('median_us_per_step')} us/step [{smi}]")
        fuse = sim.fuse
        check(fuse == prov["winner"]["fuse"],
              f"quick adopted depth {fuse}, winner {prov['winner']}")
        run_launches = stats["counters"]["kernel_launches"]
        want = chunk_launches(fuse, 50, MAIN_STEPS // 50)
        steps = int(value_from_env("GS_AUTOTUNE_STEPS", "20"))
        tuning = sum((1 + c["rounds"]) * chunk_launches(c["fuse"], steps, 1)
                     for c in cands if c["measured_us"] is not None)
        check(run_launches == want and total == want + tuning
              and set(modes) == {"chain"},
              f"quick on (a): {total} launches ({modes}), the run's "
              f"{run_launches} (expected {want}) and the tuning's "
              f"{total - run_launches} (expected {tuning})")
        same_as_phase4(d, "Auto quick (a)")
        out["quick"] = {"wall_s": wall, "provenance": prov,
                        "candidates": cands, "launches": total,
                        "run_launches": run_launches}

        os.environ["GS_AUTOTUNE"] = "cached"
        d = os.path.join(workdir, "auto_cached")
        sim, total, modes, stats, wall = run(
            d, lambda: driver.main([config(d)]))
        hit = sim.kernel_selection["autotune"]
        check(hit["cache"] == "hit" and hit["candidates_timed"] == 0
              and sim.fuse == fuse and total == want,
              f"cached on (a): {hit}, depth {sim.fuse}, {total} launches "
              f"(expected {want})")
        same_as_phase4(d, "Auto cached (a)")
        log(f"  cached: hit, 0 candidates timed, depth {sim.fuse}, {total} "
            f"launches, (a) in {wall:.3f} s; stores equal to phase 4 (a)'s")
        out["cached"] = {"wall_s": wall, "provenance": hit,
                         "launches": total}

        # 2. Eight blocks on cuda:0, the mesh not pinned, the split round
        # left to the pick ("auto", the default).
        os.environ["GS_AUTOTUNE"] = "off"

        def eight(settings, *, n_devices, seed):
            return gs.Simulation(settings, seed=seed,
                                 devices=["cuda:0"] * 8)

        timing, eights = {}, {}
        overlap = "auto"
        d = os.path.join(workdir, f"auto_eight_{overlap}")
        sim, total, modes, stats, wall = run(
            d, lambda: driver.run_once(
                get_settings([config(d, comm_overlap=overlap)]),
                sim_factory=eight))
        sel = sim.kernel_selection
        row = sel["rows"][sel["pick"]]
        dims, fuse = sim.domain.dims, sim.fuse
        log(f"  eight blocks on cuda:0, mesh not pinned, comm_overlap "
            f"{overlap}: adopted {dims} at depth {fuse}, "
            f"{'split' if sim.comm_overlap else 'fused'} round "
            f"({row['schedule']}; {sel['reason']}); rows "
            + "; ".join(f"{r['schedule']} {r['mesh']} depth {r['fuse']}"
                        f": {r['projected_step_us']} us/step"
                        for r in sel["rows"]))
        check(dims == tuple(int(x) for x in row["mesh"].split(","))
              and fuse == row["fuse"]
              and sim.comm_overlap == row.get("comm_overlap",
                                              sim.comm_overlap),
              f"eight blocks: ran {dims} at depth {fuse} "
              f"(comm_overlap {sim.comm_overlap}), picked {row}")
        same_as_phase4(d, f"eight blocks, Auto, comm_overlap {overlap}")
        check(stats["comm"] == icimodel.comm_report(sim)
              and stats["comm"]["mesh_dims"] == list(dims),
              f"eight blocks: RunStats.comm {stats['comm']}")
        os.environ["GS_FUSE"] = str(fuse)
        try:
            pinned = gs.Simulation(gs.Settings(**main_settings(
                kernel_language="CUDA",
                comm_overlap="on" if sim.comm_overlap else "off")),
                mesh_dims=dims, devices=["cuda:0"] * 8)
        finally:
            del os.environ["GS_FUSE"]
        cuda_stencil.reset_launches()
        for _ in range(MAIN_STEPS // 50):
            pinned.iterate(50)
        pinned.block_until_ready()
        want = {m: n for m, n in cuda_stencil.MODE_LAUNCHES.items() if n}
        check(modes == want and pinned.comm_overlap == sim.comm_overlap,
              f"eight blocks: launched {modes}, the schedule pinned "
              f"{want}")
        eights[overlap] = {"mesh": list(dims), "fuse": fuse,
                           "comm_overlap": sim.comm_overlap,
                           "wall_s": wall, "launches": modes,
                           "selection": sel, "comm": stats["comm"]}
        timing[f"adopted, comm_overlap {overlap}"] = sim
        del pinned

        mesh222 = gs.Simulation(gs.Settings(**main_settings(
            kernel_language="Auto")), mesh_dims=MESH,
            devices=["cuda:0"] * 8)
        sel222 = mesh222.kernel_selection
        row222 = sel222["rows"][sel222["pick"]]
        check(mesh222.fuse == 1 and row222["schedule"] == "faces6",
              f"(2,2,2) pinned: the analytic pick is {row222}, not depth 1")
        timing["2x2x2 depth 1"] = mesh222
        # Each schedule timed in turn, twice: the mean of its medians.
        medians = {name: [] for name in timing}
        for _ in range(2):
            for name, s in timing.items():
                medians[name].append(time_sim_rounds(s, 20, 3)["median"])
        for name, s in list(timing.items()):
            measured = sum(medians[name]) / len(medians[name])
            proj = icimodel.projected_step_us_for(s)
            timing[name] = {"mesh": list(s.domain.dims), "fuse": s.fuse,
                            "comm_overlap": s.comm_overlap,
                            "measured_ms": measured * 1e3,
                            "medians_ms": [m * 1e3 for m in medians[name]],
                            "projected_ms": proj / 1e3,
                            "residual_share": (measured * 1e6 - proj)
                            / (measured * 1e6)}
            log(f"    {name} {s.domain.dims} depth {s.fuse}"
                f"{' split' if s.comm_overlap and s.fuse > 1 else ''}: "
                f"projected {proj / 1e3:.4f} ms/step, measured "
                f"{measured * 1e3:.4f} ms/step (medians "
                + ", ".join(f"{m * 1e3:.4f}" for m in medians[name])
                + f") [{smi}]")
        adopted = timing["adopted, comm_overlap auto"]["measured_ms"]
        faces = timing["2x2x2 depth 1"]["measured_ms"]
        check(adopted <= faces,
              f"eight blocks: the default's adopted schedule measured "
              f"{adopted:.4f} ms/step, slower than (2,2,2) at depth 1 "
              f"({faces:.4f})")
        log("  (2,2,2) pinned: the analytic pick is depth 1 (kFaces6); "
            "the eight-block runs' stores equal phase 4 (a)'s")
        out["eight"] = {"runs": eights, "timing": timing,
                        "pinned_222": row222}
        del sim, mesh222

        # 3. (a) moved onto (2,2,2): the comm section follows.
        calls = [0]

        def poll():
            calls[0] += 1
            return {"mesh_dims": list(MESH)} if calls[0] == 3 else None

        d = os.path.join(workdir, "auto_move")
        sim, total, modes, stats, wall = run(
            d, lambda: driver.run_once(get_settings([config(d)]),
                                       reshape_poll=poll))
        check(sim.domain.dims == MESH
              and stats["comm"]["mesh_dims"] == list(MESH)
              and stats["comm"] == icimodel.comm_report(sim),
              f"(a) moved onto (2,2,2): RunStats.comm {stats['comm']}")
        same_as_phase4(d, "(a) moved onto (2,2,2)")
        log(f"  (a) moved onto (2,2,2) at step 100: RunStats.comm "
            f"{stats['comm']}")
        out["moved_comm"] = stats["comm"]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    report["auto"] = out


def phase_band_times(torch, gs, cuda_stencil, spec, report):
    """Per-launch times of the band recomputes at the split rounds'
    depth-2 shapes (noise on): the kernel (CUDA events, and its device
    time under the profiler), ``plain_xchain``, and the bound of the
    work (each input read once, each output written once; the x-chain's
    widening stages). The kernels line's band entry is the mean of the
    (2,2,2) run's two shapes, launched equally often."""
    params = spec.model.make_params(gs.Settings(**main_settings()),
                                    torch.float32, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(17)
    k = 2
    rows = {}
    for name, (shape, offs) in band_shapes(k).items():
        f = tuple(torch.rand(shape, generator=gen, device="cuda")
                  for _ in range(2))
        faces = tuple(torch.rand((k,) + shape[1:], generator=gen,
                                 device="cuda") for _ in range(4))

        def kernel():
            return cuda_stencil.fused_step(
                f, params, (0, 3, 0), faces, spec=spec, fuse=k,
                offsets=offs, row=MAIN_L, band=True)

        def plain():
            return cuda_stencil.plain_xchain(
                f, params, (0, 3, 0), faces, spec=spec, fuse=k,
                use_noise=True, offsets=offs, row=MAIN_L)

        p1 = time_calls(torch, plain, 50.0)
        k1 = time_calls(torch, kernel)
        k2 = time_calls(torch, kernel)
        p2 = time_calls(torch, plain, 50.0)
        moved, flops = face_mode_work("xchain", shape, k,
                                      spec.flops_per_cell_step())
        b_ms, b_by = bound_of(moved, flops)
        prof = device_profile(torch, kernel)
        rows[name] = {"shape": list(shape), "fuse": k, "ms": (k1 + k2) / 2,
                      "ms_runs": [k1, k2], "plain_ms": (p1 + p2) / 2,
                      "bound_ms": b_ms, "bound_by": b_by, "bytes": moved,
                      "flops": flops, "profile": prof}
        dev = ("not measured" if prof is None
               else f"{prof['kernel_ms']:.4f} ms")
        log(f"  band {name} {shape} k={k}: kernel {(k1 + k2) / 2:.4f} ms/call "
            f"(device {dev}), plain {(p1 + p2) / 2:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
    pair = [rows["y_2x2x2"], rows["x_2x2x2"]]
    b_ms, b_by = bound_of(sum(r["bytes"] for r in pair) / 2,
                          sum(r["flops"] for r in pair) / 2)
    entry = {"ms": sum(r["ms"] for r in pair) / 2,
             "plain_ms": sum(r["plain_ms"] for r in pair) / 2,
             "bound_ms": b_ms, "bound_by": b_by}
    report["band_times"] = {"rows": rows, "entry": entry}
    return entry


def oracle_run(torch, cuda_stencil, sim, steps, fuse=1, mid_bf16=False):
    """``steps`` steps of ``sim``'s start fields through the kernel's
    oracle on the card, in rounds of ``fuse`` as the simulation launches
    them (the mid stages of a round stored as bf16 under
    ``mid_bf16``)."""
    f = sim.blocks[0]
    for step in range(0, steps, fuse):
        f = cuda_stencil.plain_chain(
            f, sim.params, sim._seeds(step), spec=sim.spec,
            use_noise=sim.use_noise, fuse=min(fuse, steps - step),
            row=sim.settings.L, oracle=True, mid_bf16=mid_bf16)
    return [x.float().cpu().numpy() for x in f]


def run_main(torch, gs, cuda_stencil, cfg, factory=None):
    """``driver.main`` (or ``driver.run_once`` with ``factory``) on
    ``cfg`` with the launch counts set to 0 just before and read just
    after; returns ``(sim, wall, counts)``."""
    from grayscott_jl_tpu_torch import driver
    from grayscott_jl_tpu_torch.config.settings import get_settings

    cuda_stencil.reset_launches()
    t0 = time.perf_counter()
    if factory is None:
        sim = driver.main([cfg])
    else:
        sim = driver.run_once(get_settings([cfg]), sim_factory=factory)
    sim.block_until_ready()
    wall = time.perf_counter() - t0
    counts = {"launches": cuda_stencil.LAUNCHES,
              "modes": dict(cuda_stencil.MODE_LAUNCHES),
              "entries": dict(cuda_stencil.DTYPE_LAUNCHES),
              "models": dict(cuda_stencil.MODEL_LAUNCHES)}
    return sim, wall, counts


def phase_bf16_main_path(torch, gs, cuda_stencil, workdir, report):
    """The ``BFloat16`` main path at L=256: 200 launches of the bf16
    entry, a store of bf16 values (dtype name ``"bfloat16"``) bitwise
    equal to the kernel's oracle run on the card, a bitwise restart, and
    ``GS_FUSE=2`` on (8,1,1) and (2,2,2) equal to the stored step 50."""
    import numpy as np

    from grayscott_jl_tpu_torch.io.bplite import BpReader, bf16_round

    common = main_settings(precision="BFloat16")
    out = os.path.join(workdir, "bf16.bp")
    ckpt = os.path.join(workdir, "bf16_ckpt.bp")
    cfg = os.path.join(workdir, "bf16.toml")
    write_config(cfg, **common, output=out, checkpoint=True,
                 checkpoint_freq=100, checkpoint_output=ckpt)
    sim, wall, counts = run_main(torch, gs, cuda_stencil, cfg)
    took(report, cuda_stencil, "stencil_chain_bf16")
    n = counts["launches"]
    check(sim.dtype == torch.bfloat16 and not sim.sharded,
          f"BFloat16 main path ran {sim.dtype} on {sim.domain.dims}")
    check(n == MAIN_STEPS // sim.fuse and counts["entries"]["bf16"] == n
          and counts["modes"]["chain"] == n,
          f"BFloat16 main path launched {counts}, expected "
          f"{MAIN_STEPS // sim.fuse} bf16 chain launches and no other")
    stored = read_store(out)
    with BpReader(out) as r:
        check(r.inquire_variable("U").stored == "bfloat16",
              f"bf16 store variable dtype {r.inquire_variable('U').stored}")
    for step, u, v in stored:
        check(np.array_equal(u, bf16_round(u))
              and bool((u >= -0.2).all() and (u <= 1.5).all())
              and bool((v >= 0.0).all() and (v <= 1.0).all()),
              f"bf16 store at step {step}: not bf16 values or out of range")
    want = oracle_run(torch, cuda_stencil, gs.Simulation(gs.Settings(
        **common)), MAIN_STEPS)
    check(all(np.array_equal(a, b) for a, b in zip(want, stored[-1][1:])),
          "BFloat16 store != the kernel's oracle on the card: max |diff| "
          f"{max(np.abs(a - b).max() for a, b in zip(want, stored[-1][1:]))}")
    out2 = os.path.join(workdir, "bf16_restart.bp")
    cfg2 = os.path.join(workdir, "bf16_restart.toml")
    write_config(cfg2, **common, output=out2, restart=True,
                 restart_input=ckpt, restart_step=100)
    run_main(torch, gs, cuda_stencil, cfg2)
    end = read_store(out2)[-1]
    check(end[0] == MAIN_STEPS and all(
        np.array_equal(a, b) for a, b in zip(end[1:], stored[-1][1:])),
        "BFloat16 restart from step 100 != the stored step 200")
    log(f"  BFloat16: driver.main {MAIN_STEPS} steps at L={MAIN_L} in "
        f"{wall:.3f} s, {n} bf16 launches; store (dtype name bfloat16) "
        "bitwise equal to the oracle on the card; restart bitwise")
    fuse2 = {}
    at50 = next(x for x in stored if x[0] == 50)
    os.environ["GS_FUSE"] = "2"
    try:
        for dims, mode in (((8, 1, 1), "xchain"), ((2, 2, 2), "xychain")):
            msim = mesh_sim(gs, gs.Settings(**common, comm_overlap="off"),
                            dims)
            cuda_stencil.reset_launches()
            msim.iterate(50)
            msim.block_until_ready()
            got = (cuda_stencil.MODE_LAUNCHES[mode],
                   cuda_stencil.DTYPE_LAUNCHES["bf16"], cuda_stencil.LAUNCHES)
            check(got == (8 * 25,) * 3,
                  f"BFloat16 GS_FUSE=2 on {dims} launched {got}")
            took(report, cuda_stencil, f"stencil_{mode}_bf16")
            check(all(np.array_equal(a, b)
                      for a, b in zip(msim.get_fields(), at50[1:])),
                  f"BFloat16 GS_FUSE=2 on {dims} != the stored step 50")
            fuse2["x".join(map(str, dims))] = got[0]
    finally:
        del os.environ["GS_FUSE"]
    log(f"  BFloat16 GS_FUSE=2 on (8,1,1) and (2,2,2): {fuse2} bf16 "
        "launches, bitwise equal to the stored step 50 (z bands in the "
        "kernel's posture)")
    report["bf16_main_path"] = {"wall_s": wall, "counts": counts,
                                "fuse2_launches": fuse2}
    return n, fuse2


def phase_bf16acc_codec(torch, gs, cuda_stencil, workdir, report):
    """``bf16_f32acc`` with ``snapshot_bits = "8"`` at L=256: the single
    block (200 bf16 launches) and a (2,2,2) mesh on ``cuda:0`` (1,600
    bf16 6n-face launches), coded output decoding within its bound of
    the exact checkpoints, the mesh's store equal to the single block's
    bitwise (payloads, ranges and checkpoints)."""
    import numpy as np

    from grayscott_jl_tpu_torch.io import codec
    from grayscott_jl_tpu_torch.io.bplite import BpReader

    common = main_settings(compute_precision="bf16_f32acc",
                           snapshot_bits="8")
    runs = {}
    for name, factory in (("single", None), ("mesh", lambda settings, *,
                          n_devices, seed: mesh_sim(gs, settings, MESH,
                                                    seed))):
        out = os.path.join(workdir, f"acc_{name}.bp")
        ckpt = os.path.join(workdir, f"acc_{name}_ckpt.bp")
        cfg = os.path.join(workdir, f"acc_{name}.toml")
        stats_path = os.path.join(workdir, f"acc_{name}_stats.json")
        write_config(cfg, **common, output=out, checkpoint=True,
                     checkpoint_freq=100, checkpoint_output=ckpt)
        os.environ["GS_TPU_STATS"] = stats_path
        try:
            sim, wall, counts = run_main(torch, gs, cuda_stencil, cfg,
                                         factory)
            if factory is not None:
                took(report, cuda_stencil, "stencil_faces6_bf16")
        finally:
            del os.environ["GS_TPU_STATS"]
        with open(stats_path, encoding="utf-8") as f:
            stats = json.load(f)
        check(stats["config"]["compute_precision"] == "bf16_f32acc"
              and stats["config"]["snapshot_codec"]["output"] == {
                  "u": 8, "v": 8},
              f"bf16_f32acc {name} RunStats config {stats['config']}")
        blocks = 1 if factory is None else MESH[0] * MESH[1] * MESH[2]
        mode = "chain" if factory is None else "faces6"
        check(sim.dtype == torch.bfloat16
              and counts["modes"][mode] == blocks * MAIN_STEPS
              and counts["entries"]["bf16"] == counts["launches"]
              == blocks * MAIN_STEPS,
              f"bf16_f32acc {name} launched {counts}")
        with BpReader(out) as r:
            attr = json.loads(r.attributes()["snapshot_codec"])
            check(attr == {"U": {"bits": 8, "dtype": "bfloat16"},
                           "V": {"bits": 8, "dtype": "bfloat16"}}
                  and r.inquire_variable("U").dtype == np.uint8,
                  f"coded store schema {attr}")
            coded = [(int(r.get("step", step=i)),)
                     + tuple((r.get(n, step=i),
                              float(r.get(f"{n}__qlo", step=i)),
                              float(r.get(f"{n}__qhi", step=i)))
                             for n in ("U", "V"))
                     for i in range(r.num_steps())]
        exact = read_store(ckpt, ("u", "v"))
        for step, *fields in exact:
            entry = next(c for c in coded if c[0] == step)
            for (dec, lo, hi), x in zip(entry[1:], fields):
                err = float(np.abs(dec - x).max())
                bound = codec.error_bound(lo, hi, 8, "bfloat16")
                check(err <= bound, f"{name} step {step}: codec error {err} "
                      f"> bound {bound}")
        runs[name] = {"wall_s": wall, "counts": counts, "coded": coded,
                      "exact": exact, "run_stats": stats}
    a, b = runs["single"], runs["mesh"]
    check(len(a["coded"]) == len(b["coded"]) == MAIN_STEPS // 50
          and all(x[0] == y[0] and all(
              np.array_equal(p[0], q[0]) and p[1:] == q[1:]
              for p, q in zip(x[1:], y[1:]))
              for x, y in zip(a["coded"], b["coded"])),
          "bf16_f32acc (2,2,2) coded store != the single block's")
    check(all(x[0] == y[0] and all(np.array_equal(p, q)
                                   for p, q in zip(x[1:], y[1:]))
              for x, y in zip(a["exact"], b["exact"])),
          "bf16_f32acc (2,2,2) checkpoints != the single block's")
    log(f"  bf16_f32acc + snapshot_bits=8: single block {a['wall_s']:.3f} s "
        f"({a['counts']['launches']} bf16 launches), (2,2,2) mesh "
        f"{b['wall_s']:.3f} s ({b['counts']['modes']['faces6']} bf16 6n-face "
        "launches); coded output within its bound of the exact checkpoints;"
        " the mesh's store bitwise equal to the single block's")
    report["bf16acc_codec"] = {
        k: {"wall_s": v["wall_s"], "counts": v["counts"],
            "run_stats": v["run_stats"],
            "ranges": [[c[0]] + [list(f[1:]) for f in c[1:]]
                       for c in v["coded"]]}
        for k, v in runs.items()}
    return a["counts"]["launches"], b["counts"]["modes"]["faces6"]


def phase_mid_bf16_path(torch, gs, cuda_stencil, workdir, report):
    """``GS_MID_BF16=1`` with ``GS_FUSE=2`` on the float32 main path:
    100 launches of the bf16-mid entry, the store's last step bitwise
    equal to the oracle in the same rounds."""
    import numpy as np

    common = main_settings()
    out = os.path.join(workdir, "mid.bp")
    cfg = os.path.join(workdir, "mid.toml")
    write_config(cfg, **common, output=out)
    os.environ.update(GS_MID_BF16="1", GS_FUSE="2")
    try:
        sim, wall, counts = run_main(torch, gs, cuda_stencil, cfg)
        took(report, cuda_stencil, "stencil_chain_mid_bf16")
        n = counts["launches"]
        check(sim.fuse == 2 and n == MAIN_STEPS // 2
              and counts["entries"]["f32_mid_bf16"] == n,
              f"GS_MID_BF16 main path launched {counts}")
        want = oracle_run(torch, cuda_stencil, gs.Simulation(gs.Settings(
            **common)), MAIN_STEPS, fuse=2, mid_bf16=True)
    finally:
        del os.environ["GS_MID_BF16"], os.environ["GS_FUSE"]
    end = read_store(out)[-1]
    check(end[0] == MAIN_STEPS and all(
        np.array_equal(a, b) for a, b in zip(want, end[1:])),
        "GS_MID_BF16 store != the oracle on the card")
    log(f"  GS_MID_BF16=1 GS_FUSE=2: driver.main {MAIN_STEPS} steps in "
        f"{wall:.3f} s, {n} launches of the bf16-mid entry; store bitwise "
        "equal to the oracle")
    report["mid_bf16_path"] = {"wall_s": wall, "counts": counts}
    return n


def time_calls(torch, fn, min_ms=200.0):
    """Mean ms per call of ``fn`` with CUDA events, after warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    once = max(e0.elapsed_time(e1), 1e-3)
    reps = int(min(200, max(3, min_ms / once)))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_profile(torch, fn, reps=20):
    """``fn`` run ``reps`` times under ``torch.profiler`` after a warm-up:
    the host wall of the window (ms, ending in a synchronise), the
    device-side events' summed time (kernels and copies; they run on one
    stream, so the sum is the device's busy time) and per-call device
    time of the stencil kernel. ``None`` when the profiler recorded no
    device event."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = kernel = 0.0
    launches = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        busy += ms
        if "stencil_chain_kernel" in e.name:
            kernel += ms
            launches += 1
    if busy == 0.0:
        return None
    return {"wall_ms": wall / reps, "device_busy_ms": busy / reps,
            "busy_share": busy / wall, "kernel_ms": kernel / reps,
            "kernel_launches": launches / reps}


def device_ops(torch, fn, reps=20):
    """Device ms per call of ``fn`` by kernel name under
    ``torch.profiler`` (after a warm-up), largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = (out.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3 / reps)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def phase_times(torch, gs, cuda_stencil, spec, report):
    rows = []
    settings = gs.Settings(L=8, noise=0.1, F=0.02, k=0.048, Du=0.2,
                           Dv=0.1, dt=1.0, precision="Float32")
    params = spec.model.make_params(settings, torch.float32, "cuda")
    cap = cuda_stencil.max_feasible_fuse(4)
    for L in (256, 512):
        gen = torch.Generator(device="cuda").manual_seed(7)
        f0 = tuple(torch.rand((L, L, L), generator=gen, device="cuda")
                   for _ in range(2))
        for fuse in range(1, (cap if L == MAIN_L else 2) + 1):
            def kernel():
                return cuda_stencil.fused_step(
                    f0, params, (0, 3, 0), spec=spec, fuse=fuse, row=L)

            def plain():
                return cuda_stencil.plain_chain(
                    f0, params, (0, 3, 0), spec=spec, fuse=fuse, row=L)

            p1 = time_calls(torch, plain, 100.0)
            k1 = time_calls(torch, kernel)
            k2 = time_calls(torch, kernel)
            p2 = time_calls(torch, plain, 100.0)
            k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
            b_ms, b_by = bound_ms(L, fuse, spec.flops_per_cell_step())
            rows.append({
                "L": L, "fuse": fuse, "ms": k_ms, "ms_runs": [k1, k2],
                "plain_ms": p_ms, "plain_ms_runs": [p1, p2],
                "bound_ms": b_ms, "bound_by": b_by,
                "ms_per_step": k_ms / fuse, "plain_ms_per_step": p_ms / fuse,
                "bound_ms_per_step": b_ms / fuse,
                "cell_updates_per_s": L**3 * fuse / (k_ms * 1e-3),
            })
            log(f"  L={L} fuse={fuse}: kernel {k_ms:.4f} ms/launch "
                f"({k_ms / fuse:.4f} ms/step, {L**3 * fuse / k_ms * 1e3:.4e} "
                f"cell-updates/s), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by})")
        del f0
    report["times"] = rows
    return rows


def phase_face_times(torch, gs, cuda_stencil, spec, report,
                     dtype_name="float32"):
    """Per-launch times of each face mode at the sharded path's block
    shapes (noise on, depth 2 for the chains), float32 or bfloat16 (bf16
    params and the oracle as the plain version)."""
    dtype = getattr(torch, dtype_name)
    oracle = dtype == torch.bfloat16
    itemsize = torch.empty((), dtype=dtype).element_size()
    params = spec.model.make_params(
        gs.Settings(noise=0.1, F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0),
        dtype, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)

    def rand(shape):
        return torch.rand(shape, generator=gen, device="cuda").to(dtype)

    k = 2
    cases = (
        ("faces6", (128, 128, 128), 1, (128, 128, 128), {}),
        ("xchain", (32, 256, 256), k, (32, 0, 0), {}),
        ("xychain", (128, 128 + 2 * k, 128), k, (128, 128 - k, 128),
         {"y_halo": k}),
    )
    rows = {}
    for mode, shape, fuse, offs, extra in cases:
        nx, ny, nz = shape
        f = (rand(shape), rand(shape))
        if mode == "faces6":
            faces = tuple(rand(x) for x in [(1, ny, nz)] * 4
                          + [(nx, 1, nz)] * 4 + [(nx, ny, 1)] * 4)

            def plain():
                return cuda_stencil.plain_step(
                    f, params, (0, 3, 0), faces, spec=spec, offsets=offs,
                    row=MAIN_L, oracle=oracle)
        else:
            faces = tuple(rand((fuse, ny, nz)) for _ in range(4))

            def plain():
                return cuda_stencil.plain_xchain(
                    f, params, (0, 3, 0), faces, spec=spec, fuse=fuse,
                    use_noise=True, offsets=offs, row=MAIN_L, oracle=oracle)

        def kernel():
            return cuda_stencil.fused_step(
                f, params, (0, 3, 0), faces, spec=spec, fuse=fuse,
                offsets=offs, row=MAIN_L, **extra)

        p1 = time_calls(torch, plain, 100.0)
        k1 = time_calls(torch, kernel)
        k2 = time_calls(torch, kernel)
        p2 = time_calls(torch, plain, 100.0)
        b_ms, b_by = bound_of(*face_mode_work(
            mode, shape, fuse, spec.flops_per_cell_step(), itemsize))
        prof = device_profile(torch, kernel)
        rows[mode] = {
            "shape": list(shape), "fuse": fuse, "ms": (k1 + k2) / 2,
            "ms_runs": [k1, k2], "plain_ms": (p1 + p2) / 2,
            "plain_ms_runs": [p1, p2], "bound_ms": b_ms, "bound_by": b_by,
            "profile": prof,
        }
        dev = ("not measured" if prof is None
               else f"{prof['kernel_ms']:.4f} ms")
        log(f"  {dtype_name} {mode} {shape} fuse={fuse}: kernel "
            f"{(k1 + k2) / 2:.4f} "
            f"ms/call (device time of the kernel alone {dev}), plain "
            f"{(p1 + p2) / 2:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    report["face_times" if not oracle else "face_times_bf16"] = rows
    return rows


def phase_load_times(torch, gs, cuda_stencil, spec, report):
    """The window load's two paths on one operand, in turns: TMA and
    cp.async — the chain at L=256 and the 6n-face step at
    (128,128,128), depth 1, float32 and bfloat16, noise on. CUDA-event
    ms per call (the runs in the order a b b a) and the profiler's
    device time per launch."""
    variants = ("tma", "cp_async")
    rows = []
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        params = spec.model.make_params(
            gs.Settings(noise=0.1, **GS_PHYSICS), dtype, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(9)

        def rand(shape):
            return torch.rand(shape, generator=gen, device="cuda").to(dtype)

        for mode, shape in (("chain", (MAIN_L,) * 3),
                            ("faces6", (128, 128, 128))):
            nx, ny, nz = shape
            f = (rand(shape), rand(shape))
            faces = None
            if mode == "faces6":
                faces = tuple(rand(x) for x in [(1, ny, nz)] * 4
                              + [(nx, 1, nz)] * 4 + [(nx, ny, 1)] * 4)

            def kernel():
                return cuda_stencil.fused_step(
                    f, params, (0, 3, 0), faces, spec=spec,
                    offsets=(128, 128, 128) if faces else None, row=MAIN_L)

            runs = {v: [] for v in variants}
            for v in variants + variants[::-1]:
                with cuda_stencil.override(v):
                    runs[v].append(time_calls(torch, kernel))
            for v in variants:
                with cuda_stencil.override(v):
                    prof = device_profile(torch, kernel)
                row = {"dtype": dname, "mode": mode, "shape": list(shape),
                       "load": v,
                       "ms": sum(runs[v]) / 2, "ms_runs": runs[v],
                       "device_ms": None if prof is None
                       else prof["kernel_ms"]}
                rows.append(row)
                dev = ("not measured" if prof is None
                       else f"{prof['kernel_ms']:.4f} ms")
                log(f"  {dname} {mode} {shape} load {v}: "
                    f"{row['ms']:.4f} ms/call (device time {dev})")
    report["load_times"] = rows
    return rows


def phase_health_times(torch, gs, report, reps=5):
    """The health probe's cost at a boundary: ``Simulation.snapshot``
    with and without it (host clock, each the mean of ``reps``
    snapshots, in the order with, without, without, with) on the L=256
    single block and the (2,2,2) mesh on ``cuda:0``, and the probe alone
    on the single block's fields (the profiler's device time)."""
    from grayscott_jl_tpu_torch.resilience.health import device_probe

    rows = {}
    for name, dims in (("single", None), ("mesh", MESH)):
        settings = gs.Settings(**main_settings())
        sim = (gs.Simulation(settings) if dims is None
               else mesh_sim(gs, settings, dims))
        sim.iterate(10)
        sim.block_until_ready()

        def snap(health):
            t0 = time.perf_counter()
            for _ in range(reps):
                out = sim.snapshot(health=health)
                check((out.health is not None) == health
                      and (not health or out.health.finite),
                      f"{name} snapshot(health={health}): {out.health}")
            return (time.perf_counter() - t0) * 1e3 / reps

        snap(True)
        runs = {True: [], False: []}
        for health in (True, False, False, True):
            runs[health].append(snap(health))
        row = {"with_ms": sum(runs[True]) / 2,
               "without_ms": sum(runs[False]) / 2,
               "with_runs": runs[True], "without_runs": runs[False]}
        if dims is None:
            prof = device_profile(torch, lambda: device_probe(*sim.blocks[0]))
            row["probe_device_ms"] = (None if prof is None
                                      else prof["device_busy_ms"])
        rows[name] = row
        log(f"  {name}: snapshot with the health probe {row['with_ms']:.3f}"
            f" ms, without {row['without_ms']:.3f} ms (runs "
            f"{runs[True]}, {runs[False]})"
            + ("" if dims is not None else
               f"; the probe's device time {row['probe_device_ms']} ms"))
        del sim
    report["health_times"] = rows
    return rows


def phase_model_times(torch, gs, cuda_stencil, spec, report):
    """Model ``spec``'s generated kernel at the main path's shape (L=256,
    float32, depth 1, noise on): CUDA-event ms per launch (two runs
    interleaved with two of the plain version), the profiler's device
    time, and the bound (each field read and written once; the
    generated program's operations)."""
    settings = gs.Settings(noise=0.1, precision="Float32",
                           **physics(spec.name))
    params = spec.model.make_params(settings, torch.float32, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    f0 = tuple(torch.rand((MAIN_L,) * 3, generator=gen, device="cuda")
               for _ in range(spec.n_fields))

    def kernel():
        return cuda_stencil.fused_step(f0, params, (0, 3, 0), spec=spec,
                                       row=MAIN_L)

    def plain():
        return cuda_stencil.plain_chain(f0, params, (0, 3, 0), spec=spec,
                                        row=MAIN_L)

    p1 = time_calls(torch, plain, 100.0)
    k1 = time_calls(torch, kernel)
    k2 = time_calls(torch, kernel)
    p2 = time_calls(torch, plain, 100.0)
    flops = spec.flops_per_cell_step()
    b_ms, b_by = bound_ms(MAIN_L, 1, flops, n_fields=spec.n_fields)
    prof = device_profile(torch, kernel)
    row = {"L": MAIN_L, "fuse": 1, "ms": (k1 + k2) / 2, "ms_runs": [k1, k2],
           "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2],
           "bound_ms": b_ms, "bound_by": b_by, "flops_per_cell_step": flops,
           "profile": prof}
    dev = "not measured" if prof is None else f"{prof['kernel_ms']:.4f} ms"
    log(f"  {spec.name} L={MAIN_L} fuse=1: kernel {row['ms']:.4f} ms/launch "
        f"(device time {dev}), plain {row['plain_ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; {flops} flop/cell/step)")
    report.setdefault("model_times", {})[spec.name] = row
    return row


def phase_bf16_times(torch, gs, cuda_stencil, spec, report):
    """Row 1f: the bf16 kernel at the main path's shape (L=256, fuse 1,
    bf16 params, noise on) against its oracle and its byte bound (2 B a
    cell a field); and the float32 chain with bf16 mids at fuse 2..cap
    against the exact float32 chain, interleaved (mid, exact, exact,
    mid)."""
    params = spec.model.make_params(
        gs.Settings(noise=0.1, **GS_PHYSICS), torch.bfloat16, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    f0 = tuple(torch.rand((MAIN_L,) * 3, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(2))

    def kernel():
        return cuda_stencil.fused_step(f0, params, (0, 3, 0), spec=spec,
                                       row=MAIN_L)

    def plain():
        return cuda_stencil.plain_chain(f0, params, (0, 3, 0), spec=spec,
                                        row=MAIN_L, oracle=True)

    p1 = time_calls(torch, plain, 100.0)
    k1 = time_calls(torch, kernel)
    k2 = time_calls(torch, kernel)
    p2 = time_calls(torch, plain, 100.0)
    flops = spec.flops_per_cell_step()
    b_ms, b_by = bound_ms(MAIN_L, 1, flops, itemsize=2)
    prof = device_profile(torch, kernel)
    row = {"L": MAIN_L, "fuse": 1, "ms": (k1 + k2) / 2, "ms_runs": [k1, k2],
           "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2],
           "bound_ms": b_ms, "bound_by": b_by, "profile": prof}
    dev = "not measured" if prof is None else f"{prof['kernel_ms']:.4f} ms"
    log(f"  bf16 L={MAIN_L} fuse=1: kernel {row['ms']:.4f} ms/launch (device "
        f"time {dev}), oracle {row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    del f0
    params32 = spec.model.make_params(
        gs.Settings(noise=0.1, **GS_PHYSICS), torch.float32, "cuda")
    f32 = tuple(torch.rand((MAIN_L,) * 3, generator=gen, device="cuda")
                for _ in range(2))
    mid_rows = []
    cap = cuda_stencil.max_feasible_fuse(4, mid_itemsize=2)
    for fuse in range(2, cap + 1):
        def exact():
            return cuda_stencil.fused_step(f32, params32, (0, 3, 0),
                                           spec=spec, fuse=fuse, row=MAIN_L)

        def mid():
            os.environ["GS_MID_BF16"] = "1"
            try:
                return exact()
            finally:
                del os.environ["GS_MID_BF16"]

        def mid_plain():
            return cuda_stencil.plain_chain(
                f32, params32, (0, 3, 0), spec=spec, fuse=fuse, row=MAIN_L,
                oracle=True, mid_bf16=True)

        m1 = time_calls(torch, mid)
        e1 = time_calls(torch, exact)
        e2 = time_calls(torch, exact)
        m2 = time_calls(torch, mid)
        mp = time_calls(torch, mid_plain, 100.0)
        mb_ms, mb_by = bound_ms(MAIN_L, fuse, flops)
        mid_rows.append({"fuse": fuse, "ms": (m1 + m2) / 2, "ms_runs": [m1, m2],
                         "exact_ms": (e1 + e2) / 2, "exact_runs": [e1, e2],
                         "plain_ms": mp, "bound_ms": mb_ms, "bound_by": mb_by})
        log(f"  float32 fuse={fuse}: bf16 mids {(m1 + m2) / 2:.4f} ms/launch, "
            f"exact {(e1 + e2) / 2:.4f} ms, oracle {mp:.4f} ms")
    report["bf16_times"] = {"bf16": row, "mid_bf16": mid_rows}
    return row, mid_rows


def phase_sharded_times(torch, gs, report):
    """ms per step of the sharded path on one card (8 blocks of the
    (2,2,2) mesh on cuda:0, and the GS_FUSE=2 chain forms) against the
    single block, host clock around 20 steps that end in a synchronise
    (after 20 of warm-up); and the 6n-face halo exchange alone. Then
    the exchange schedule: at GS_FUSE=2 on (8,1,1), (2,2,2) and (2,2,1)
    the split round against the fused one (in turns: on, off, off, on),
    each under the profiler (:func:`exchange_profile`: the device's busy
    share and how long the exchange's stream ran beside the stencil
    kernel, per round); and at fuse 1 on (2,2,2) halo depth 1, 2 and 4,
    split ("auto") and fused, with the exchange rounds per step."""
    from grayscott_jl_tpu_torch.parallel import halo

    steps = 20
    settings = gs.Settings(**main_settings())

    def per_step(sim):
        sim.iterate(steps)
        sim.block_until_ready()
        t0 = time.perf_counter()
        sim.iterate(steps)
        sim.block_until_ready()
        return (time.perf_counter() - t0) * 1e3 / steps

    one = gs.Simulation(settings)
    mesh = mesh_sim(gs, settings, MESH)
    o1, m1, m2, o2 = (per_step(one), per_step(mesh), per_step(mesh),
                      per_step(one))
    bvs = mesh.model.boundaries
    halo.exchange_faces(mesh.blocks, bvs, mesh.mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        halo.exchange_faces(mesh.blocks, bvs, mesh.mesh)
    torch.cuda.synchronize()
    exch = (time.perf_counter() - t0) * 1e3 / steps
    row = {
        "single_ms_per_step": (o1 + o2) / 2, "single_runs": [o1, o2],
        "mesh_ms_per_step": (m1 + m2) / 2, "mesh_runs": [m1, m2],
        "exchange_ms_per_step": exch,
        "exchange_share": exch / ((m1 + m2) / 2),
    }
    log(f"  one card, L={MAIN_L} depth 1: single block "
        f"{row['single_ms_per_step']:.4f} ms/step, {MESH} mesh "
        f"{row['mesh_ms_per_step']:.4f} ms/step, of which the 6n-face "
        f"exchange {exch:.4f} ms ({100 * row['exchange_share']:.1f} %)")
    for name, sim in (("single", one), ("mesh", mesh)):
        prof = device_profile(torch, lambda: sim.iterate(1), reps=steps)
        row[f"{name}_profile"] = prof
        if prof is None:
            log(f"  {name}: device busy share not measured (the profiler "
                "recorded no device event)")
            continue
        log(f"  {name} under the profiler: {prof['wall_ms']:.4f} ms/step "
            f"wall, device busy {prof['device_busy_ms']:.4f} ms "
            f"({100 * prof['busy_share']:.1f} %), stencil kernel "
            f"{prof['kernel_ms']:.4f} ms in {prof['kernel_launches']:.0f} "
            "launches")
    off = gs.Settings(**main_settings(comm_overlap="off"))
    saved = {v: os.environ.pop(v, None) for v in ("GS_FUSE", "GS_HALO_DEPTH")}
    try:
        os.environ["GS_FUSE"] = "2"
        fuse2, split = {}, {}
        for dims in ((8, 1, 1), (2, 2, 2), (2, 2, 1)):
            key = "x".join(map(str, dims))
            # The fused round (comm_overlap off) and the split one (on),
            # in turns: on, off, off, on.
            s_on, f_on = mesh_sim(gs, settings, dims), mesh_sim(gs, off, dims)
            r = [per_step(s_on), per_step(f_on), per_step(f_on),
                 per_step(s_on)]
            check(s_on.overlap_applied and not f_on.overlap_applied,
                  f"{dims}: the split and fused rounds did not run as set")
            fuse2[key] = (r[1] + r[2]) / 2
            split[key] = {"split_ms_per_step": (r[0] + r[3]) / 2,
                          "fused_ms_per_step": (r[1] + r[2]) / 2,
                          "runs_on_off_off_on": r}
            for name, sim in (("split", s_on), ("fused", f_on)):
                split[key][f"{name}_profile"] = exchange_profile(
                    torch, lambda: sim.iterate(2), reps=10)
        fuse2["single"] = per_step(gs.Simulation(settings))
        row["fuse2_ms_per_step"] = fuse2
        row["split_vs_fused"] = split
        log(f"  GS_FUSE=2 ms/step (fused round): {fuse2}")
        for key, r in split.items():
            prof = r["split_profile"]
            seen = ("not measured" if prof is None else
                    f"device busy {100 * prof['busy_share']:.1f} %, "
                    f"exchange-stream work beside the stencil kernel "
                    f"{prof['overlap_us']:.1f} us per round, band/interior "
                    f"kernels {prof['kernel_launches']:.0f} per round")
            log(f"  {key}: split {r['split_ms_per_step']:.4f} ms/step, fused "
                f"{r['fused_ms_per_step']:.4f} ({seen})")
        os.environ["GS_FUSE"] = "1"
        depths = {}
        for overlap in ("auto",):
            for k in (1, 2, 4):
                os.environ["GS_HALO_DEPTH"] = str(k)
                sim = mesh_sim(gs, gs.Settings(**main_settings(
                    comm_overlap=overlap)), MESH)
                ms = per_step(sim)
                rounds = sim.exchange_rounds / (2 * steps)
                depths[f"{overlap}_k{k}"] = {
                    "ms_per_step": ms, "exchange_rounds_per_step": rounds,
                    "overlap_applied": sim.overlap_applied,
                    "profile": exchange_profile(
                        torch, lambda: sim.iterate(4), reps=5)}
                log(f"  {MESH} fuse 1 halo_depth {k} ({overlap}): "
                    f"{ms:.4f} ms/step, {rounds:.3f} exchange rounds/step")
        row["halo_depth"] = depths
    finally:
        for v, x in saved.items():
            os.environ.pop(v, None)
            if x is not None:
                os.environ[v] = x
    report["sharded_times"] = row
    return row


def _union(intervals):
    """Sorted, merged ``(start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _intersection_ns(xs, ys):
    """Total length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def exchange_profile(torch, fn, reps=10):
    """``fn`` (one or more exchange rounds) ``reps`` times under
    ``torch.profiler`` after a warm-up: per call, the host wall, the
    device's busy time (the union of every device event), the stencil
    kernel's launches and time on its stream, the busy time of the other
    streams (the exchange's side stream), and how long both ran at once
    (the union of the kernel's events intersected with the side
    streams'). ``None`` when the profiler recorded no device event or
    the events carry no stream."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    try:
        events = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
        spans = [(e.name(), e.device_resource_id(), e.start_ns(),
                  e.start_ns() + e.duration_ns()) for e in events]
    except AttributeError:
        return None
    kernels = [sp for sp in spans if "stencil_chain_kernel" in sp[0]]
    if not kernels:
        return None
    streams = {sp[1] for sp in kernels}
    k_iv = _union([(a, b) for _, _, a, b in kernels])
    side = _union([(a, b) for _, st, a, b in spans if st not in streams])
    busy = sum(b - a for a, b in _union([(a, b) for *_, a, b in spans]))
    return {
        "wall_ms": wall / reps, "device_busy_ms": busy / 1e6 / reps,
        "busy_share": busy / 1e6 / wall,
        "kernel_ms": sum(b - a for *_, a, b in kernels) / 1e6 / reps,
        "kernel_launches": len(kernels) / reps,
        "side_stream_busy_ms": sum(b - a for a, b in side) / 1e6 / reps,
        "overlap_us": _intersection_ns(k_iv, side) / 1e3 / reps,
    }


def phase_envelope_parity(torch, cuda_stencil, spec, report):
    """The copy walk against its input and every compute-walk variant
    against its plain version, bitwise, at L=256 and (20,24,40), depth
    1..cap, noise 0 and 0.1; the default compute walk also against the
    production chain's tile (0,0,0). Returns the worst |diff| per
    kernel."""
    from grayscott_jl_tpu_torch.ops import envelope
    from grayscott_jl_tpu_torch.probes import envelope_probe

    cap = cuda_stencil.max_feasible_fuse(4)
    worst = dict.fromkeys(("copy_walk",) + envelope.VARIANTS, 0.0)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(31)

    def diff(got, want):
        return max((a - b).abs().max().item() for a, b in zip(got, want))

    for shape in ((MAIN_L,) * 3, (20, 24, 40), (20, 24, 41)):
        f = tuple(torch.rand(shape, generator=gen, device="cuda")
                  for _ in range(2))
        cut = envelope.defined_tile(shape)
        for fuse in range(1, cap + 1):
            for load in loads(torch, cuda_stencil, shape, torch.float32):
                with cuda_stencil.override(load):
                    got = envelope.copy_walk(f, fuse=fuse)
                torch.cuda.synchronize()
                err = diff(got, f)
                worst["copy_walk"] = max(worst["copy_walk"], err)
                check(all(torch.equal(a, b) for a, b in zip(got, f)),
                      f"copy_walk != its input: {shape} fuse={fuse} load "
                      f"{load}, max |diff| {err}")
                rows.append(["copy_walk", list(shape), None, fuse, load,
                             err])
        for noise in (0.0, 0.1):
            params = envelope_probe.make_params(noise, "cuda")
            for fuse in range(1, cap + 1):
                seeds = (1, 2, 3 * fuse)
                chain = cuda_stencil.fused_step(
                    f, params, seeds, spec=spec, use_noise=noise != 0,
                    fuse=fuse)
                for variant in envelope.VARIANTS:
                    got = envelope.compute_walk(
                        f, params, seeds, spec=spec, fuse=fuse,
                        use_noise=noise != 0, variant=variant)
                    want = envelope.plain_compute_walk(
                        f, params, seeds, spec=spec, fuse=fuse,
                        use_noise=noise != 0, variant=variant)
                    torch.cuda.synchronize()
                    tile = tuple(a[cut] for a in got)
                    err = diff(tile, want)
                    worst[variant] = max(worst[variant], err)
                    check(all(torch.isfinite(a).all().item() for a in tile)
                          and all(torch.equal(a, b)
                                  for a, b in zip(tile, want)),
                          f"compute_walk {variant} != plain: {shape} "
                          f"fuse={fuse} noise={noise}, max |diff| {err}")
                    if variant == "chain":
                        check(all(torch.equal(a, b[cut])
                                  for a, b in zip(tile, chain)),
                              f"compute_walk != the production chain's tile "
                              f"(0,0,0): {shape} fuse={fuse} noise={noise}")
                    rows.append([variant, list(shape), noise, fuse, err])
    log(f"  copy_walk bitwise equal to its input, the compute walk and its "
        f"six variants bitwise equal to their plain versions (the default "
        f"also to the production chain's tile (0,0,0)): L={MAIN_L}, "
        f"(20,24,40) and (20,24,41) (cp.async), fuse 1..{cap}, noise 0/0.1;"
        f" the copy walk on each load path")
    report["envelope_parity"] = rows
    return worst


def phase_envelope(torch, cuda_stencil, spec, workdir, report):
    """The probe's entry point (``envelope_probe.main``) at each of
    ``PROBE_RUNS``, the launch counts set to 0 just before each and read
    just after; then the probe kernels' device times (profiler) and their
    plain versions' times at L=256 depth 1. Returns the first run's
    launch counts, its rows by case, and the times."""
    import contextlib
    import io

    from grayscott_jl_tpu_torch.ops import envelope
    from grayscott_jl_tpu_torch.probes import envelope_probe

    runs = []
    first = None
    for L, fuse, variants in PROBE_RUNS:
        out = os.path.join(workdir, f"probe_{L}_{fuse}.jsonl")
        argv = ["--l", str(L), "--fuse", str(fuse), "--steps",
                str(PROBE_STEPS), "--rounds", str(PROBE_ROUNDS), "--noise",
                "0.1", "--out", out]
        os.environ["GS_PROBE_COMPUTE_VARIANTS"] = "1" if variants else "0"
        try:
            cuda_stencil.reset_launches()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = envelope_probe.main(argv)
            modes = dict(cuda_stencil.MODE_LAUNCHES)
            variant_counts = dict(cuda_stencil.VARIANT_LAUNCHES)
            if first is None:
                # Every launch of the run (both probes and the production
                # chain) took this path, so each probe's launches did.
                took(report, cuda_stencil, "envelope")
        finally:
            del os.environ["GS_PROBE_COMPUTE_VARIANTS"]
        with open(out, encoding="utf-8") as f:
            rows = [json.loads(line) for line in f]
        n_passes = max(1, PROBE_STEPS // fuse)
        per_case = n_passes * (1 + PROBE_ROUNDS)
        want_variants = envelope.VARIANTS if variants else ("chain",)
        check(rc == 0 and modes["copy_walk"] == per_case
              and modes["chain"] == per_case
              and variant_counts == {v: per_case if v in want_variants
                                     else 0 for v in envelope.VARIANTS}
              and modes["compute_walk"] == per_case * len(want_variants),
              f"envelope probe L={L} fuse={fuse} launched {modes} "
              f"{variant_counts}, expected {per_case} per case")
        check(all(r["timer"] == "cuda_events" and r["best_us_per_pass"] > 0
                  and math.isfinite(r["median_us_per_pass"]) for r in rows),
              f"envelope probe L={L} fuse={fuse} rows {rows}")
        for r in rows:
            log(f"  L={L} fuse={fuse} {r['case']:16s} median "
                f"{r['median_us_per_pass']:9.2f} us/pass (best "
                f"{r['best_us_per_pass']:9.2f}), bound "
                f"{r['bound_us_per_pass']:8.2f} ({r['bound_by']}), "
                f"{r['effective_gbps']:8.1f} GB/s unique")
        runs.append({"L": L, "fuse": fuse, "variants": variants,
                     "modes": modes, "variant_launches": variant_counts,
                     "rows": rows})
        if first is None:
            first = {"modes": modes, "variants": variant_counts,
                     "rows": {r["case"]: r for r in rows}}

    # Device time of each probe kernel and its plain version's time at
    # L=256 depth 1.
    gen = torch.Generator(device="cuda").manual_seed(32)
    f = tuple(torch.rand((MAIN_L,) * 3, generator=gen, device="cuda")
              for _ in range(2))
    params = envelope_probe.make_params(0.1, "cuda")
    times = {}

    def profile(fn):
        prof = device_profile(torch, fn)
        return None if prof is None else prof["kernel_ms"]

    times["copy_walk"] = {
        "device_ms": profile(lambda: envelope.copy_walk(f, fuse=1)),
        "plain_ms": time_calls(
            torch, lambda: envelope.plain_copy_walk(f, fuse=1), 100.0),
        "library_ms": time_calls(torch, lambda: envelope.torch_copy(f),
                                 100.0),
    }
    for variant in envelope.VARIANTS:
        kw = dict(spec=spec, fuse=1, use_noise=True, variant=variant)
        times[variant] = {
            "device_ms": profile(lambda: envelope.compute_walk(
                f, params, (1, 2, 0), **kw)),
            "plain_ms": time_calls(torch, lambda: envelope.plain_compute_walk(
                f, params, (1, 2, 0), **kw), 100.0),
            "library_ms": None,
        }
    for name, t in times.items():
        dev = ("not measured" if t["device_ms"] is None
               else f"{t['device_ms']:.4f} ms")
        log(f"  L={MAIN_L} fuse=1 {name}: device time {dev}, plain "
            f"{t['plain_ms']:.4f} ms"
            + ("" if t["library_ms"] is None
               else f", Tensor.copy_ {t['library_ms']:.4f} ms"))
    report["envelope"] = {"runs": runs, "times": times}
    return first, times


#: The ensemble phase (phase 4 (ix)): the five presets of
#: examples/settings-ensemble-phases.toml at config (a)'s size; three of
#: them on the meshes; four (two per group) for the member split.
ENS_PRESETS = ("spots", "stripes", "waves", "mitosis", "chaos")
ENS_MESH_PRESETS = ("spots", "stripes", "chaos")
ENS_SPLIT_PRESETS = ("spots", "stripes", "waves", "chaos")
#: The kernel checks of the batched launch: members per launch.
BATCH_N = 3


def ens_settings(presets, member_shards=1, **kw):
    """Config (a)'s settings as a TOML body with an ``[ensemble]`` of
    ``presets`` (the kernel language pinned, so that the launch counts
    are the schedule's)."""
    base = main_settings(kernel_language="CUDA")
    base.update(kw)
    return base, ("\n[ensemble]\npresets = ["
                  + ", ".join(f'"{p}"' for p in presets) + "]\n"
                  f"member_shards = {member_shards}\n")


def write_ens_config(path, presets, member_shards=1, **kw):
    """``write_config`` of :func:`ens_settings`."""
    body, table = ens_settings(presets, member_shards, **kw)
    write_config(path, **body)
    with open(path, "a", encoding="utf-8") as f:
        f.write(table)


def profiled_kernels(path):
    """The template's kernel launches (device events named
    ``stencil_chain_kernel``) in a ``torch.profiler`` Chrome trace, and
    the host's ``cudaLaunchKernel`` calls in it."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    kernels = runtime = 0
    for e in doc.get("traceEvents", []):
        name = e.get("name", "")
        if (str(e.get("cat", "")).lower() == "kernel"
                and "stencil_chain_kernel" in name):
            kernels += 1
        elif name == "cudaLaunchKernel":
            runtime += 1
    return kernels, runtime


def phase_observability(torch, gs, cuda_stencil, workdir, stored, report):
    """Phase 4 (x-a), build and launch analytics and the profiler
    captures on config (a) at L=256 through ``driver.main``, the launch
    counts set to 0 just before each run and read just after (run 0 has
    nothing armed):

    run 1: ``GS_XSTATS=1``, ``GS_PROFILE=50:150`` and a fresh
        ``GS_COMPILE_CACHE`` (with ``GS_EVENTS``): the Gray-Scott kernel
        library (nvcc) and the native store engine (g++) each recorded a
        ``miss`` with nonzero ``compile_s``; one launch record, the
        ``kBlock`` f32 entry's, with the card's registers, shared bytes
        and blocks per SM, and bytes and flops equal to row 1a's
        reckoning (0.0801 ms at L=256); the window's Chrome trace holding
        exactly the 100 launches of steps 50-150 (fuse 1) and no other;
    run 2: the same cache directory: every library a ``hit`` with 0 s;
    run 3: ``GS_TPU_PROFILE`` alone: its trace holds all 200 launches.

    Run 0, with nothing armed, first: the wall the others are read
    against in the same call. Every run's stores bitwise equal to phase
    4's (a), their files byte-identical across the runs. Then the run report
    (``python -m grayscott_jl_tpu_torch.obs.report``) checks run 1's
    stats and events (exit 0) and renders them (exit 0). Prints the
    walls against phase 4's (a), each library's build seconds and the
    launch record, each beside the card's name and power limit."""
    import numpy as np

    from grayscott_jl_tpu_torch.models import get_model
    from grayscott_jl_tpu_torch.ops import kernelgen

    smi = nvidia_smi("name,power.limit")
    spec = kernelgen.get_spec(get_model("grayscott"))
    flops = spec.flops_per_cell_step()
    cache = os.path.join(workdir, "x_cache")
    sinks = os.path.join(workdir, "x_sinks")
    os.makedirs(sinks)
    prof1 = os.path.join(sinks, "window")
    prof3 = os.path.join(sinks, "whole")
    runs = {}
    digests = []

    def one(name, env):
        reset_sinks()
        try:
            d, summary, wall, launches = run_store(
                torch, gs, cuda_stencil, workdir, name, 2, env=env)
        finally:
            reset_sinks()
        check(launches == MAIN_STEPS,
              f"(x-a) {name}: {launches} launches, expected {MAIN_STEPS}")
        got = read_store(os.path.join(d, "gs.bp"))
        check([st for st, *_ in got] == [st for st, *_ in stored]
              and all(np.array_equal(a, b)
                      for (_, *fa), (_, *fb) in zip(got, stored)
                      for a, b in zip(fa, fb)),
              f"(x-a) {name}: store != phase 4's (a)")
        digests.append(tree_digest(d))
        runs[name] = {"wall_s": wall, "summary": summary, "dir": d}
        return summary

    # Nothing armed: the wall the others are read against in this call.
    s0 = one("x_run0", {})
    check(s0["executables"] is None,
          f"(x-a) run 0 armed the analytics: {s0['executables']}")
    events_path = os.path.join(sinks, "events.jsonl")
    s1 = one("x_run1", {"GS_XSTATS": "1", "GS_PROFILE": "50:150",
                        "GS_PROFILE_DIR": prof1, "GS_COMPILE_CACHE": cache,
                        "GS_EVENTS": events_path})
    ex = s1["executables"]
    libs = {r["name"]: r for r in ex["records"]
            if r.get("record") == "library"}
    check(set(libs) == {"grayscott", "libbplite"}
          and all(r["cache"] == "miss" and r["compile_s"] > 0
                  for r in libs.values()),
          f"(x-a) run 1's library records: {libs}")
    launch_recs = [r for r in ex["records"] if r.get("record") == "launch"]
    check(len(launch_recs) == 1, f"(x-a) launch records {launch_recs}")
    rec = launch_recs[0]
    mem, occ, cost = (rec.get("memory") or {}, rec.get("occupancy") or {},
                      rec["cost"])
    check(rec["name"] == "kBlock[f32]" and rec["launches"] == MAIN_STEPS
          and rec["shape"] == [MAIN_L] * 3 and "error" not in rec
          and mem.get("registers", 0) > 0
          and mem.get("dynamic_shared_bytes", 0) > 0
          and occ.get("blocks_per_sm", 0) >= 1,
          f"(x-a) the kBlock f32 launch record: {rec}")
    b_ms, b_by = bound_ms(MAIN_L, 1, flops)
    check(cost["bytes"] == 2 * 2 * 4 * MAIN_L**3
          and cost["flops"] == flops * MAIN_L**3
          and cost["bound_ms"] == b_ms and round(b_ms, 4) == 0.0801,
          f"(x-a) launch cost {cost}, row 1a's bound {b_ms}")
    window = os.path.join(prof1, "profile_50_150.json")
    win_kernels, win_runtime = profiled_kernels(window)
    check(win_kernels == 100,
          f"(x-a) the 50:150 window holds {win_kernels} kernel launches "
          f"({win_runtime} cudaLaunchKernel calls), expected 100")

    s2 = one("x_run2", {"GS_XSTATS": "1", "GS_COMPILE_CACHE": cache})
    libs2 = {r["name"]: (r["cache"], r["compile_s"])
             for r in s2["executables"]["records"]
             if r.get("record") == "library"}
    check(libs2 == {"grayscott": ("hit", 0.0), "libbplite": ("hit", 0.0)},
          f"(x-a) run 2's library records: {libs2}")

    s3 = one("x_run3", {"GS_TPU_PROFILE": prof3})
    check(s3["executables"] is None,
          f"(x-a) run 3 armed the analytics: {s3['executables']}")
    whole_kernels, whole_runtime = profiled_kernels(
        os.path.join(prof3, "gs_tpu_profile.json"))
    check(whole_kernels == MAIN_STEPS,
          f"(x-a) GS_TPU_PROFILE holds {whole_kernels} kernel launches "
          f"({whole_runtime} cudaLaunchKernel calls), expected "
          f"{MAIN_STEPS}")
    check(all(dg == digests[0] for dg in digests[1:]),
          "(x-a) files differ between the runs: "
          f"{[k for k in digests[0] if digests[0][k] != digests[1].get(k)]}")

    # The run report on run 1's artifacts.
    stats1 = os.path.join(runs["x_run1"]["dir"], "stats.json")
    args = ["--stats", stats1, "--events", events_path]
    codes = {}
    for mode in (["--check"], []):
        proc = subprocess.run(
            [sys.executable, "-m", "grayscott_jl_tpu_torch.obs.report",
             *mode, *args], cwd=REPO, capture_output=True, text=True,
            timeout=120)
        codes["check" if mode else "render"] = proc.returncode
        check(proc.returncode == 0,
              f"(x-a) obs.report {' '.join(mode)} exited "
              f"{proc.returncode}: {proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        if not mode:
            check("== executables (3 compiles" in proc.stdout,
                  f"(x-a) the report's executables section: "
                  f"{proc.stdout[-2000:]}")

    base = report["main_path"]["wall_s"]
    walls = {k: v["wall_s"] for k, v in runs.items()}
    log(f"  (x-a) walls: run 0 (nothing armed) {walls['x_run0']:.4f} s, "
        f"run 1 (xstats, window 50:150, fresh cache) "
        f"{walls['x_run1']:.4f} s, run 2 (xstats, cached) "
        f"{walls['x_run2']:.4f} s, run 3 (GS_TPU_PROFILE) "
        f"{walls['x_run3']:.4f} s, against phase 4's (a) {base:.4f} s; "
        f"{smi}")
    log(f"  (x-a) builds: grayscott nvcc {libs['grayscott']['compile_s']} s, "
        f"libbplite g++ {libs['libbplite']['compile_s']} s (both miss); "
        f"run 2 both hit, 0 s; {smi}")
    log(f"  (x-a) launch record: {json.dumps(rec)}; {smi}")
    log(f"  (x-a) profiler: the window held {win_kernels} kernel launches "
        f"({win_runtime} cudaLaunchKernel), the whole run {whole_kernels} "
        f"({whole_runtime}); obs.report --check and render exited 0")
    report["observability"] = {
        "walls_s": walls, "main_path_wall_s": base, "nvidia_smi": smi,
        "libraries": libs, "launch_record": rec,
        "collectives": ex.get("collectives"),
        "window_kernels": win_kernels, "window_runtime": win_runtime,
        "whole_kernels": whole_kernels, "whole_runtime": whole_runtime,
        "report_codes": codes}
    for v in runs.values():
        shutil.rmtree(v["dir"])
    shutil.rmtree(sinks)
    shutil.rmtree(cache, ignore_errors=True)


def phase_member_procs(torch, gs, cuda_stencil, workdir, report):
    """Phase 4 (x-b), member groups across processes: four presets of
    ``examples/settings-ensemble-phases.toml`` at L=256, ``member_shards
    = 2``, 50 steps (plotgap 25, stores without the ``.vti`` series):
    one process with two groups of one block on ``cuda:0`` (100 batched
    ``kBlock`` launches of 2 members); the same as two processes over
    gloo on ``cuda:0`` through ``launch.py``, one group each (each
    process 50 launches of 2 members, by its counts and its launch
    record), every member's stores bitwise equal to the one-process
    run's; and the one-process run moved live between rounds onto
    (2,1,1) per group under ``GS_RESHARD_DEVICE=auto``: the path
    ``collective``, the stores equal to the unmoved run's."""
    import numpy as np

    from grayscott_jl_tpu_torch import driver, launch
    from grayscott_jl_tpu_torch.config.settings import get_settings
    from grayscott_jl_tpu_torch.ensemble.engine import EnsembleSimulation
    from grayscott_jl_tpu_torch.ensemble.io import member_path

    smi = nvidia_smi("name,power.limit")
    presets = ENS_SPLIT_PRESETS
    n = len(presets)
    steps = 50

    def config(name):
        d = os.path.join(workdir, name)
        os.makedirs(d)
        cfg = os.path.join(d, "cfg.toml")
        write_ens_config(cfg, presets, 2, steps=steps, plotgap=25,
                         mesh_type="none", output=os.path.join(d, "gs.bp"))
        return d, cfg

    def factory(s, *, n_devices, seed):
        return EnsembleSimulation(s, seed=seed, devices=["cuda:0"] * 2)

    def members(d):
        return [read_store(member_path(os.path.join(d, "gs.bp"), k, n))
                for k in range(n)]

    def same(a, b):
        return all([st for st, *_ in x] == [st for st, *_ in y]
                   and all(np.array_equal(p, q)
                           for (_, *fx), (_, *fy) in zip(x, y)
                           for p, q in zip(fx, fy))
                   for x, y in zip(a, b))

    out = {}
    saved = value_from_env("GS_RESHARD_DEVICE")
    os.environ["GS_RESHARD_DEVICE"] = "auto"
    try:
        d1, cfg1 = config("xb_one")
        cuda_stencil.reset_launches()
        t0 = time.perf_counter()
        sim = driver.run_once(get_settings([cfg1]), sim_factory=factory)
        out["one_wall_s"] = time.perf_counter() - t0
        modes = {m: c for m, c in cuda_stencil.MODE_LAUNCHES.items() if c}
        check(sim.member_shards == 2 and sim.mesh.held == [0, 1]
              and modes == {"chain": 2 * steps}
              and cuda_stencil.MODE_MEMBERS["chain"] == 2,
              f"(x-b) one process: {modes} of "
              f"{cuda_stencil.MODE_MEMBERS['chain']} members")
        one = members(d1)

        d2, cfg2 = config("xb_pair")
        env = {k: v for k, v in os.environ.items()
               if k not in ("GS_TPU_STATS", "GS_FUSE", "GS_HALO_DEPTH",
                            "GS_TPU_MESH_DIMS", "GS_COMM_OVERLAP")}
        stats = os.path.join(d2, "stats.json")
        env.update(GS_TPU_STATS=stats, GS_XSTATS="1")
        logf = os.path.join(d2, "launch.log")
        t0 = time.perf_counter()
        with open(logf, "w", encoding="utf-8") as f:
            codes = launch.launch(2, cfg2, 1, env=env, cwd=d2, timeout=300,
                                  stdout=f, stderr=subprocess.STDOUT)
        out["pair_wall_s"] = time.perf_counter() - t0
        with open(logf, encoding="utf-8") as f:
            text = f.read()
        check(codes == [0, 0],
              f"(x-b) the two-process run exited {codes}:\n{text[-4000:]}")
        per_rank = []
        for r in range(2):
            with open(f"{stats}.rank{r}", encoding="utf-8") as f:
                summary = json.load(f)
            recs = [x for x in summary["executables"]["records"]
                    if x.get("record") == "launch"]
            per_rank.append({"modes": summary["config"]["launches"]["modes"],
                             "records": [(x["name"], x["launches"],
                                          x["members"]) for x in recs],
                             "compute_s": summary["phases_s"].get("compute")})
            check(per_rank[-1]["modes"] == {"chain": steps}
                  and per_rank[-1]["records"] == [("kBlock[f32]x2", steps,
                                                   2)],
                  f"(x-b) process {r}: {per_rank[-1]}")
        check(same(one, members(d2)),
              "(x-b) the two-process member stores != the one-process run's")

        d3, cfg3 = config("xb_move")
        calls = [0]

        def poll():
            calls[0] += 1
            return {"mesh_dims": [2, 1, 1]} if calls[0] == 2 else None

        t0 = time.perf_counter()
        moved = driver.run_once(get_settings([cfg3]), sim_factory=factory,
                                reshape_poll=poll)
        out["move_wall_s"] = time.perf_counter() - t0
        check(moved.reshard is not None
              and moved.reshard["path"] == "collective"
              and moved.domain.dims == (2, 1, 1)
              and moved.member_shards == 2,
              f"(x-b) the live move: {moved.reshard}, {moved.domain.dims}")
        check(same(one, members(d3)),
              "(x-b) the moved member stores != the unmoved run's")
        out.update(per_rank=per_rank, move={
            k: moved.reshard[k] for k in ("path", "bytes", "wall_s")})
    finally:
        if saved is None:
            os.environ.pop("GS_RESHARD_DEVICE", None)
        else:
            os.environ["GS_RESHARD_DEVICE"] = saved
    log(f"  (x-b) member_shards = 2 at L={MAIN_L}, {n} members, {steps} "
        f"steps: one process {out['one_wall_s']:.3f} s (100 kBlock "
        f"launches of 2), two processes over gloo on cuda:0 "
        f"{out['pair_wall_s']:.3f} s ({per_rank[0]['records']} and "
        f"{per_rank[1]['records']}), stores bitwise equal; live move "
        f"(1,1,1) -> (2,1,1) per group {out['move']}; {smi}")
    report["member_procs"] = {**out, "nvidia_smi": smi}


def phase_batch_parity(torch, gs, cuda_stencil, spec, report):
    """The batched launch (members on the grid's y axis) of every
    production mode against its plain version with the same leading
    axis and against ``BATCH_N`` solo launches, bitwise, one launch
    each: the chain at depth 1 and 2 (L = 64 and 100, ragged tiles),
    the 6n-face step at (100,64,96), the x-chain at (34,100,100), the
    xy-chain operand (64,68,64) with ``offsets[1] = -2`` and a band body
    (2,64,64); float32, float64, bf16 (its oracle) and float32 with bf16
    mids at depth 2, noise 0.1, on each load path the operand takes.
    Every member has its own params row and key pair (one key with the
    top bit set). Returns the worst |diff| per mode."""
    rows = [dict(Du=0.2, Dv=0.1, F=f, k=k, dt=1.0, noise=0.1)
            for f, k in ((0.030, 0.062), (0.055, 0.062), (0.026, 0.051))]
    keys = [(0, 11), (0, 12), (0, 2**31 + 13)]
    gen = torch.Generator(device="cuda").manual_seed(19)
    worst = {}
    cases = [("chain", (64,) * 3, 1, {}), ("chain", (100,) * 3, 2, {}),
             ("faces6", (100, 64, 96), 1, {}),
             ("xchain", (34, 100, 100), 2, {"offsets": (34, 0, 0)}),
             ("xychain", (64, 68, 64), 2,
              {"offsets": (64, -2, 0), "y_halo": 2}),
             ("band", (2, 64, 64), 2, {"offsets": (62, 0, 64),
                                      "band": True})]
    n_checks = 0
    for dname in ("float32", "float64", "bfloat16", "mid_bf16"):
        dtype = torch.bfloat16 if dname == "bfloat16" else getattr(
            torch, dname.replace("mid_bf16", "float32"))
        oracle = dname in ("bfloat16", "mid_bf16")
        for mode, shape, fuse, kw in cases:
            if dname == "mid_bf16" and fuse < 2:
                continue
            nx, ny, nz = shape
            n = BATCH_N
            f = tuple((torch.rand((n,) + shape, generator=gen, device="cuda")
                       * 0.5 + 0.25).to(dtype) for _ in range(2))
            if mode == "faces6":
                fshapes = ([(1, ny, nz)] * 4 + [(nx, 1, nz)] * 4
                           + [(nx, ny, 1)] * 4)
            elif mode == "chain":
                fshapes = []
            else:
                fshapes = [(fuse, ny, nz)] * 4
            faces = tuple(torch.rand((n,) + s, generator=gen,
                                     device="cuda").to(dtype)
                          for s in fshapes) or None
            params = cuda_stencil.member_params(
                rows, spec.model.params_cls,
                cuda_stencil.compute_dtype_of(dtype), "cuda")
            seeds = cuda_stencil.member_seeds(keys, 40)
            args = dict(spec=spec, use_noise=True, fuse=fuse,
                        offsets=kw.get("offsets", (0, 0, 0)), row=128,
                        y_halo=kw.get("y_halo", 0),
                        band=kw.get("band", False))
            if dname == "mid_bf16":
                os.environ["GS_MID_BF16"] = "1"
            try:
                for load in loads(torch, cuda_stencil, shape, dtype):
                    with cuda_stencil.override(load=load):
                        n0 = cuda_stencil.LAUNCHES
                        got = cuda_stencil.fused_step(f, params, seeds,
                                                      faces, **args)
                        check(cuda_stencil.LAUNCHES - n0 == 1,
                              f"batched {mode} launched "
                              f"{cuda_stencil.LAUNCHES - n0} times")
                        solo = [cuda_stencil.fused_step(
                            tuple(x[m].contiguous() for x in f),
                            cuda_stencil.params_row(params, m),
                            (keys[m][0], keys[m][1], 40),
                            None if faces is None
                            else tuple(x[m].contiguous() for x in faces),
                            **args) for m in range(n)]
                    pkw = dict(spec=spec, use_noise=True,
                               offsets=args["offsets"], row=128,
                               oracle=oracle)
                    mid = dname == "mid_bf16"
                    if mode == "chain":
                        want = cuda_stencil.plain_chain(
                            f, params, seeds, fuse=fuse, mid_bf16=mid, **pkw)
                    elif mode == "faces6":
                        want = cuda_stencil.plain_step(f, params, seeds,
                                                       faces, **pkw)
                    else:
                        want = cuda_stencil.plain_xchain(
                            f, params, seeds, faces, fuse=fuse,
                            mid_bf16=mid, **pkw)
                    err = max(float((a.double() - b.double()).abs().max())
                              for a, b in zip(got, want))
                    worst[mode] = max(worst.get(mode, 0.0), err)
                    check(all(torch.equal(a, b) for a, b in zip(got, want)),
                          f"batched {mode} {dname} {shape} fuse={fuse} "
                          f"{load} != its plain version: max |diff| {err}")
                    check(all(torch.equal(g[m], s[i])
                              for m, s in enumerate(solo)
                              for i, g in enumerate(got)),
                          f"batched {mode} {dname} {shape} fuse={fuse} "
                          f"{load} != {n} solo launches")
                    n_checks += 1
            finally:
                os.environ.pop("GS_MID_BF16", None)
    log(f"  the batched launch ({BATCH_N} members, one launch) bitwise "
        f"equal to its plain version and to {BATCH_N} solo launches in "
        f"{n_checks} checks: chain (depth 1, 2), 6n faces, x-chain, "
        "xy-chain operand, band; f32, f64, bf16, bf16 mids; each load path")
    report["batch_parity"] = {"checks": n_checks, "worst": worst}
    return worst


#: The serving phase (phase 4 (xi)): three Gray-Scott jobs of one pack key
#: at the reference's serving cap (``GS_SERVE_MAX_L`` = 256), float32,
#: noise 0.1, steps cut to the smoke's limit; three (F, k) and seeds.
SERVE_STEPS = 100
SERVE_FK = ((0.02, 0.048), (0.03, 0.055), (0.04, 0.06))
SERVE_SLOTS = 4


def serve_job(i, seed=101):
    """Job ``i`` of the serving phase, as a client payload."""
    F, k = SERVE_FK[i]
    return {"tenant": "smoke", "model": "grayscott", "L": MAIN_L,
            "steps": SERVE_STEPS, "plotgap": 50, "checkpoint_freq": 50,
            "dt": 1.0, "noise": 0.1, "seed": seed + i,
            "params": {"F": F, "k": k, "Du": 0.2, "Dv": 0.1}}


def phase_serve(torch, gs, cuda_stencil, workdir, report):
    """Phase 4 (xi), serving on the card (``serve/``): the service
    in-process on port 0, ``backend = "CUDA"``, a fresh state directory,
    unsupervised batches (the kernels load from the build of phase 2).

    (a) three jobs of one pack key over HTTP form one batch of 4 slots:
    exactly 100 batched ``kBlock`` f32 launches of 4 members, no store of
    the idle slot, ``/field`` at ``sim_step`` 100, and each member's
    ``.bp``, ``.vtk`` and checkpoint trees byte-identical to that job's
    solo ``driver.main`` run on the card (``kernel_language = "CUDA"``);
    (b) a second batch of the shape is a warm hit (no new engine, no
    build); job 1's spec again is a ``cache="hit"`` with its store and no
    launch; a flipped byte of that store under ``GS_CACHE_VERIFY=1`` drops
    the entry and the job recomputes into the same bytes; (c) chaos
    scenario 6 at L=64; (d) a front door with no local worker and one
    ``--role worker`` process on ``cuda:0`` sharing a fleet directory:
    job 1 again, its stores equal (a)'s. ``obs/report --check`` passes
    on the service's stream and on the fleet's merged stream. Prints the
    walls, the request-to-first-step latencies, the cache hit's latency
    and the N=4 batched launch's CUDA-event time against its bound, each
    beside the card's name and power limit."""
    from grayscott_jl_tpu_torch import chaos, driver
    from grayscott_jl_tpu_torch.models import get_model
    from grayscott_jl_tpu_torch.obs import events as obs_events
    from grayscott_jl_tpu_torch.ops import _build, kernelgen
    from grayscott_jl_tpu_torch.resilience.integrity import (
        corrupt_store_byte)
    from grayscott_jl_tpu_torch.serve import cache as serve_cache
    from grayscott_jl_tpu_torch.serve.scheduler import ServeConfig
    from grayscott_jl_tpu_torch.serve.server import ServeService

    smi = nvidia_smi("name,power.limit")
    d = os.path.join(workdir, "serve")
    os.makedirs(d)
    saved = {k: os.environ.get(k)
             for k in ("GS_EVENTS", "GS_CACHE_VERIFY", "GS_SERVE_FLEET_DIR",
                       "GS_TPU_STATS")}
    events_path = os.path.join(d, "events.jsonl")
    os.environ["GS_EVENTS"] = events_path
    os.environ["GS_CACHE_VERIFY"] = "1"
    obs_events.reset_events()
    rec = {"card": smi}
    builds = dict(_build.BUILDS)
    entry = ("grayscott", "chain", "f32", SERVE_SLOTS, 1, (MAIN_L,) * 3,
             False)

    def trees(record):
        return chaos.member_trees(record["store"])

    def stats(path):
        """The run's wall, phases and writer time (``GS_TPU_STATS``)."""
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        io = doc.get("io") or {}
        return {"wall_s": doc["wall_s"], "phases_s": doc["phases_s"],
                "io_busy_s": io.get("busy_s")}

    def run_stream(path):
        proc = subprocess.run(
            [sys.executable, "-m", "grayscott_jl_tpu_torch.obs.report",
             "--check", "--events", path], cwd=REPO, capture_output=True,
            text=True, timeout=120)
        check(proc.returncode == 0, f"obs/report --check on {path}: "
              f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")

    try:
        svc = ServeService(ServeConfig(
            port=0, workers=1, pack_max=8, pack_window_s=0.5,
            state_dir=os.path.join(d, "state"), supervise=False,
            cache_verify=serve_cache.resolve_cache_verify(),
            backend="CUDA")).start()
        base = f"http://127.0.0.1:{svc.port}"
        try:
            # (a) Three jobs, one batch of 4 slots.
            os.environ["GS_TPU_STATS"] = os.path.join(d, "batch_stats.json")
            cuda_stencil.reset_launches()
            t0 = time.perf_counter()
            jobs = [chaos.post(base, "/v1/jobs", serve_job(i))["job"]
                    for i in range(3)]
            first = chaos.wait_terminal(base, jobs, timeout=300)
            batch_wall = time.perf_counter() - t0
            counts = {"launches": cuda_stencil.LAUNCHES,
                      "chain": cuda_stencil.MODE_LAUNCHES["chain"],
                      "members": cuda_stencil.MODE_MEMBERS["chain"],
                      "entry": cuda_stencil.ENTRY_LAUNCHES.get(entry, 0)}
            check([r["state"] for r in first] == ["complete"] * 3,
                  f"(xi-a) job states {[r['state'] for r in first]}")
            check(len({r["batch"] for r in first}) == 1,
                  "(xi-a) the three jobs did not form one batch")
            packed = [e["attrs"] for e in obs_events.parse_events(
                events_path) if e["kind"] == "job_packed"]
            check({p["slots"] for p in packed} == {SERVE_SLOTS},
                  f"(xi-a) slots {packed}")
            check(counts == {"launches": SERVE_STEPS, "chain": SERVE_STEPS,
                             "members": SERVE_SLOTS, "entry": SERVE_STEPS},
                  f"(xi-a) launch counts {counts}")
            batch_dir = os.path.dirname(first[0]["store"])
            idle = [n for n in os.listdir(batch_dir) if ".m03." in n]
            check(not idle, f"(xi-a) the idle slot wrote {idle}")
            plane = chaos.get(base, f"/v1/jobs/{jobs[0]}/field?field=u"
                                    "&stride=16")
            check(plane["sim_step"] == SERVE_STEPS
                  and plane["shape"] == [MAIN_L // 16] * 2,
                  f"(xi-a) /field gave {plane['sim_step']} {plane['shape']}")
            batch_stats = stats(os.path.join(d, "batch_stats.json"))
            solo_walls, solo_stats = [], []
            for i in range(3):
                sd = os.path.join(d, f"solo{i}")
                os.makedirs(sd)
                job = serve_job(i)
                cfg = os.path.join(sd, "config.toml")
                write_config(cfg, **main_settings(
                    kernel_language="CUDA", steps=SERVE_STEPS,
                    checkpoint=True, checkpoint_freq=50, **job["params"],
                    output=os.path.join(sd, "gs.bp"),
                    checkpoint_output=os.path.join(sd, "ckpt.bp")))
                os.environ["GS_TPU_STATS"] = os.path.join(sd, "stats.json")
                t1 = time.perf_counter()
                driver.main([cfg], seed=job["seed"])
                solo_walls.append(time.perf_counter() - t1)
                solo_stats.append(stats(value_from_env("GS_TPU_STATS")))
                for kind, name in (("gs", "gs.bp"), ("vtk", "gs.vtk"),
                                   ("ckpt", "ckpt.bp")):
                    bad = chaos.trees_equal(os.path.join(sd, name),
                                            trees(first[i])[kind])
                    check(not bad, f"(xi-a) job {i} {kind} differs from its "
                          f"solo run: {bad[:5]}")
                shutil.rmtree(sd)
            os.environ.pop("GS_TPU_STATS")
            rec["a"] = {"batch_wall_s": batch_wall,
                        "solo_walls_s": solo_walls, "counts": counts,
                        "batch_stats": batch_stats,
                        "solo_stats": solo_stats,
                        "request_to_first_step_s": [
                            r["request_to_first_step_s"] for r in first]}
            log(f"  (xi-a) 3 jobs -> 1 batch of {SERVE_SLOTS} slots: "
                f"{counts['entry']} batched kBlock f32 launches of "
                f"{counts['members']} members; member stores byte-identical "
                f"to the solo runs; batch wall {batch_wall:.4f} s against "
                f"solo walls {', '.join(f'{w:.4f}' for w in solo_walls)} s; "
                f"request to first step (cold) "
                f"{', '.join(f'{r:.4f}' for r in rec['a']['request_to_first_step_s'])}"
                f" s [{smi}]")
            log(f"  (xi-a) the batch's run (RunStats): wall "
                f"{batch_stats['wall_s']:.4f} s, phases "
                f"{batch_stats['phases_s']}, writer busy "
                f"{batch_stats['io_busy_s']} s; solo 0: wall "
                f"{solo_stats[0]['wall_s']:.4f} s, phases "
                f"{solo_stats[0]['phases_s']} [{smi}]")

            # (b) A warm second batch, a cache hit, a corrupt entry.
            warm0 = svc.fleet.warm_hits
            jobs2 = [chaos.post(base, "/v1/jobs", serve_job(i, 201))["job"]
                     for i in range(3)]
            second = chaos.wait_terminal(base, jobs2, timeout=300)
            check([r["state"] for r in second] == ["complete"] * 3,
                  f"(xi-b) job states {[r['state'] for r in second]}")
            check(svc.fleet.warm_hits == warm0 + 1,
                  f"(xi-b) warm hits {warm0} -> {svc.fleet.warm_hits}")
            check(_build.BUILDS == builds,
                  f"(xi-b) builds {builds} -> {_build.BUILDS}")
            cuda_stencil.reset_launches()
            t1 = time.perf_counter()
            hit = chaos.post(base, "/v1/jobs",
                             dict(serve_job(0), tenant="again"))
            hit_ms = (time.perf_counter() - t1) * 1e3
            check((hit["cache"], hit["state"], hit["store"])
                  == ("hit", "complete", first[0]["store"]),
                  f"(xi-b) the repeated spec answered {hit}")
            check(cuda_stencil.LAUNCHES == 0,
                  f"(xi-b) the cache hit launched {cuda_stencil.LAUNCHES}")
            snapshot = os.path.join(d, "snapshot.bp")
            shutil.copytree(first[0]["store"], snapshot)
            check(corrupt_store_byte(first[0]["store"]) is not None,
                  "(xi-b) no byte to flip")
            again = chaos.post(base, "/v1/jobs", serve_job(0))
            check((again["cache"], again["state"]) == ("miss", "queued"),
                  f"(xi-b) the corrupt entry answered {again}")
            redo = chaos.wait_terminal(base, [again["job"]], timeout=300)[0]
            bad = chaos.trees_equal(snapshot, redo["store"])
            check(redo["state"] == "complete" and not bad,
                  f"(xi-b) the recomputed store differs: {bad[:5]}")
            rec["b"] = {"warm_hits": svc.fleet.warm_hits - warm0,
                        "request_to_first_step_s": [
                            r["request_to_first_step_s"] for r in second],
                        "cache_hit_ms": hit_ms}
            log(f"  (xi-b) warm batch: warm hits +1, no build; request to "
                f"first step (warm) "
                f"{', '.join(f'{r:.4f}' for r in rec['b']['request_to_first_step_s'])}"
                f" s; cache hit {hit_ms:.3f} ms round trip, 0 launches; "
                f"a flipped byte dropped the entry and the recompute equals "
                f"the first store [{smi}]")
        finally:
            svc.close()
        run_stream(events_path)

        # (c) Chaos scenario 6 on the card.
        rc = chaos.main(["--L", "64", "--steps", "40", "--scenarios", "6",
                         "--seed", "5", "--workdir", os.path.join(d, "c")])
        check(rc == 0, "(xi-c) chaos scenario 6 failed")

        # (d) A worker process on cuda:0 behind a front door.
        fleet = os.path.join(d, "fleet")
        fleet_events = os.path.join(d, "fleet_events.jsonl")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("GS_")}
        env.update(PYTHONPATH=REPO, GS_SERVE_FLEET_DIR=fleet,
                   GS_SERVE_FLEET_RANK="1", GS_SERVE_WORKERS="1",
                   GS_SERVE_SUPERVISE="0", GS_EVENTS=fleet_events,
                   GS_SERVE_STATE_DIR=os.path.join(d, "wstate"))
        with open(os.path.join(d, "worker.log"), "w") as wlog:
            worker = subprocess.Popen(
                [sys.executable, "-m", "grayscott_jl_tpu_torch.serve",
                 "--role", "worker"], cwd=d, env=env, stdout=wlog,
                stderr=subprocess.STDOUT)
        try:
            os.environ["GS_EVENTS"] = fleet_events
            t1 = time.perf_counter()
            front = ServeService(ServeConfig(
                port=0, workers=0, fleet_dir=fleet, fleet_rank=0,
                state_dir=os.path.join(d, "fstate"), supervise=False,
                pack_window_s=0.0, backend="CUDA")).start()
            try:
                fbase = f"http://127.0.0.1:{front.port}"
                job = chaos.post(fbase, "/v1/jobs", serve_job(0))["job"]
                got = chaos.wait_terminal(fbase, [job], timeout=300)[0]
                fleet_wall = time.perf_counter() - t1
            finally:
                front.close()
        finally:
            worker.send_signal(signal.SIGTERM)
            try:
                worker.wait(timeout=60)
            except subprocess.TimeoutExpired:
                worker.kill()
                worker.wait()
        check(got["state"] == "complete", f"(xi-d) the fleet job: {got}")
        for kind in ("gs", "vtk", "ckpt"):
            # (b) flipped a byte of (a)'s job-1 store: its copy stands in.
            want = snapshot if kind == "gs" else trees(first[0])[kind]
            bad = chaos.trees_equal(want, trees(got)[kind])
            check(not bad, f"(xi-d) the worker process's {kind} differs "
                  f"from (xi-a)'s: {bad[:5]}")
        run_stream(fleet_events)
        rec["d"] = {"wall_s": fleet_wall, "worker_rc": worker.returncode,
                    "request_to_first_step_s": got[
                        "request_to_first_step_s"]}
        log(f"  (xi-d) a --role worker process on cuda:0: the job's stores "
            f"equal (xi-a)'s; submit to complete {fleet_wall:.4f} s "
            f"(the worker process reaching the card inside) [{smi}]")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        obs_events.reset_events()

    # The N=4 batched launch of (a), CUDA events, against its bound.
    spec = kernelgen.get_spec(get_model("grayscott"))
    rows = [dict(Du=0.2, Dv=0.1, F=F, k=k, dt=1.0, noise=0.1)
            for F, k in SERVE_FK + SERVE_FK[:1]]
    gen = torch.Generator(device="cuda").manual_seed(29)
    f = tuple(torch.rand((SERVE_SLOTS,) + (MAIN_L,) * 3, generator=gen,
                         device="cuda") for _ in range(2))
    params = cuda_stencil.member_params(rows, spec.model.params_cls,
                                        torch.float32, "cuda")
    seeds = cuda_stencil.member_seeds([(0, i) for i in range(SERVE_SLOTS)],
                                      0)
    ev_ms = time_calls(torch, lambda: cuda_stencil.fused_step(
        f, params, seeds, spec=spec, row=MAIN_L))
    b_ms, b_by = bound_of(2 * 2 * 4 * SERVE_SLOTS * MAIN_L**3,
                          SERVE_SLOTS * spec.flops_per_cell_step()
                          * MAIN_L**3)
    del f
    rec["launch"] = {"members": SERVE_SLOTS, "ms": ev_ms, "bound_ms": b_ms,
                     "bound_by": b_by}
    log(f"  (xi) one batched kBlock launch of {SERVE_SLOTS} members: "
        f"{ev_ms:.4f} ms (CUDA events) against a bound of {b_ms:.4f} ms "
        f"({b_by}) [{smi}]")
    report["serve"] = rec
    return rec


#: The analysis phase's run (phase 4 (xii)): steps, plotgap, bins.
ANALYSIS_STEPS = 40
ANALYSIS_PLOTGAP = 10
ANALYSIS_BINS = 1000


def pdf_blocks(np):
    """The analysis phase's pinned blocks, from seeds: the 64^3 float32
    block of values in [0.1, 0.8] where a product with the bin width's
    reciprocal puts cells in other bins than the division at 1,000
    bins, a float64 block, and a float32 block holding a NaN."""
    pinned = np.random.default_rng(0).uniform(
        0.1, 0.8, (64, 64, 64)).astype(np.float32)
    wide = np.random.default_rng(1).uniform(0.0, 1.0, (16, 32, 32))
    nan = np.random.default_rng(2).uniform(
        0.1, 0.8, (16, 32, 32)).astype(np.float32)
    nan[3, 4, 5] = np.nan
    return {"reciprocal": pinned, "float64": wide, "nan": nan}


def phase_analysis(torch, gs, cuda_stencil, workdir, report):
    """Phase 4 (xii), the analysis workflow on the card: the port's CLI
    entry (``julia_main``, what ``python -m grayscott_jl_tpu_torch``
    runs) on an L=256 float32 config with noise 0.1, 40 steps, plotgap
    10, in this thread, while ``analysis/pdfcalc.read_data_write_pdf``
    streams its store live from another thread at 1,000 bins with the
    histograms on the card. The launch counts are set to 0 just before
    and read just after: exactly 40 ``kBlock`` f32 launches. Then: 4 PDF
    steps, each U and V histogram (pdf and bins) bitwise equal to the
    port's CPU path on the same stored block, each slice's counts
    summing to 256^2; the pinned blocks (``pdf_blocks``) equal on the
    card and the CPU; ``gdsplot``'s mid-plane slice equal to the stored
    plane, and, where matplotlib is installed, the slice and the PDF
    heatmap written as PNGs.
    Times: ``compute_pdf`` per field on the card (CUDA events; from the
    host block, as the workflow calls it, and from a block already on
    the card) and on the CPU (host clock), and the streaming wall."""
    import threading

    import numpy as np

    from grayscott_jl_tpu_torch.analysis import gdsplot, pdfcalc
    from grayscott_jl_tpu_torch.io.bplite import BpReader

    out = os.path.join(workdir, "an.bp")
    pdf_out = os.path.join(workdir, "an_pdf.bp")
    cfg = os.path.join(workdir, "an.toml")
    write_config(cfg, **main_settings(steps=ANALYSIS_STEPS,
                                      plotgap=ANALYSIS_PLOTGAP), output=out)
    stream = {}

    def consume():
        t0 = time.perf_counter()
        try:
            stream["steps"] = pdfcalc.read_data_write_pdf(
                out, pdf_out, ANALYSIS_BINS, timeout=0.2, max_not_ready=300)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            stream["error"] = e
        stream["wall_s"] = time.perf_counter() - t0

    cuda_stencil.reset_launches()
    consumer = threading.Thread(target=consume)
    t0 = time.perf_counter()
    consumer.start()
    rc = gs.julia_main([cfg])
    sim_wall = time.perf_counter() - t0
    consumer.join(timeout=600)
    launches = cuda_stencil.LAUNCHES
    f32 = cuda_stencil.DTYPE_LAUNCHES["f32"]
    chain = cuda_stencil.MODE_LAUNCHES["chain"]
    check(not consumer.is_alive(), "pdfcalc did not finish the stream")
    if "error" in stream:
        raise stream["error"]
    check(rc == 0, f"the CLI exited {rc}")
    check(launches == f32 == chain == ANALYSIS_STEPS,
          f"(xii) {launches} launches ({f32} f32, {chain} chain), expected "
          f"exactly {ANALYSIS_STEPS} kBlock f32 launches")
    n_out = ANALYSIS_STEPS // ANALYSIS_PLOTGAP
    check(stream["steps"] == n_out,
          f"pdfcalc processed {stream['steps']} steps, expected {n_out}")

    sim = BpReader(out)
    pdfs = BpReader(pdf_out)
    check(pdfs.num_steps() == n_out and sim.num_steps() == n_out,
          f"{pdfs.num_steps()} PDF steps and {sim.num_steps()} stored")
    for i in range(n_out):
        step = int(pdfs.get("step", step=i))
        check(step == int(sim.get("step", step=i))
              == ANALYSIS_PLOTGAP * (i + 1), f"PDF step {i} is sim step {step}")
        for var in ("U", "V"):
            block = sim.get(var, step=i)
            pdf, bins = pdfcalc.compute_pdf(block, ANALYSIS_BINS,
                                            device="cpu")
            card_pdf = pdfs.get(f"{var}/pdf", step=i)
            card_bins = pdfs.get(f"{var}/bins", step=i)
            check(card_pdf.dtype == pdf.dtype and np.array_equal(card_pdf, pdf)
                  and np.array_equal(card_bins, bins),
                  f"(xii) {var} at step {step}: the card's histogram differs "
                  "from the CPU path's")
            check((pdf.sum(axis=1) == MAIN_L * MAIN_L).all(),
                  f"(xii) {var} at step {step}: a slice does not count "
                  f"{MAIN_L}^2 cells")
    field = sim.get("U", step=n_out - 1)
    sim.close()
    pdfs.close()

    pinned = {}
    for name, block in pdf_blocks(np).items():
        card = pdfcalc.compute_pdf(block, ANALYSIS_BINS)
        host = pdfcalc.compute_pdf(block, ANALYSIS_BINS, device="cpu")
        check(all(np.array_equal(a, b, equal_nan=True)
                  for a, b in zip(card, host)),
              f"(xii) the {name} block's histogram differs on the card")
        pinned[name] = "bitwise"
    # What a division by a host scalar would have done on this card.
    block = torch.from_numpy(pdf_blocks(np)["reciprocal"]).cuda()
    lo, hi = float(block.min()), float(block.max())
    width = (hi - lo) / ANALYSIS_BINS
    lo_t = torch.tensor(lo, device="cuda")
    divided = torch.floor((block - lo_t) / torch.tensor(width, device="cuda"))
    by_scalar = torch.floor((block - lo_t) / width)
    pinned["host_scalar_moved_cells"] = int((divided != by_scalar).sum())
    del block, divided, by_scalar

    card_ms = time_calls(torch, lambda: pdfcalc.compute_pdf(
        field, ANALYSIS_BINS), min_ms=500.0)
    on_card = torch.from_numpy(field).cuda()
    resident_ms = time_calls(torch, lambda: pdfcalc.compute_pdf(
        on_card, ANALYSIS_BINS), min_ms=500.0)
    del on_card
    reps = 3
    t1 = time.perf_counter()
    for _ in range(reps):
        pdfcalc.compute_pdf(field, ANALYSIS_BINS, device="cpu")
    cpu_ms = (time.perf_counter() - t1) / reps * 1e3
    smi = nvidia_smi("name,power.limit")
    rec = {"launches": launches, "steps": n_out, "bins": ANALYSIS_BINS,
           "cli_wall_s": sim_wall, "stream_wall_s": stream["wall_s"],
           "compute_pdf_ms": {"card_from_host": card_ms,
                              "card_resident": resident_ms, "cpu": cpu_ms},
           "pinned": pinned, "card": smi}
    report["analysis"] = rec
    log(f"  (xii) the CLI at L={MAIN_L}: {launches} kBlock f32 launches, "
        f"{sim_wall:.3f} s; pdfcalc streamed {n_out} steps at "
        f"{ANALYSIS_BINS} bins in {stream['wall_s']:.3f} s, every "
        f"histogram bitwise equal to the CPU path's; compute_pdf per field "
        f"{card_ms:.3f} ms on the card from the host block, "
        f"{resident_ms:.3f} ms from the card, {cpu_ms:.1f} ms on the CPU; "
        f"the pinned blocks bitwise ({pinned['host_scalar_moved_cells']} "
        f"cells a host-scalar division would move) [{smi}]")
    sl = gdsplot.load_slice(out, "U")
    check(np.array_equal(sl, field[MAIN_L // 2]),
          "gdsplot's mid-plane slice is not the stored plane")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        # matplotlib is not on every card's machine: gdsplot's slice is
        # checked, and nothing is drawn.
        rec["pngs"] = "matplotlib not installed; the slice checked, no PNG"
        log(f"  (xii) gdsplot: {rec['pngs']}")
        return rec
    png_slice = gdsplot.plot_slice(out, "U", output=os.path.join(
        workdir, "an_slice.png"))
    png_pdf = gdsplot.plot_pdf(pdf_out, "U", output=os.path.join(
        workdir, "an_pdf.png"))
    check(all(os.path.getsize(p) > 0 for p in (png_slice, png_pdf)),
          "gdsplot wrote an empty PNG")
    rec["pngs"] = [os.path.basename(png_slice), os.path.basename(png_pdf)]
    log(f"  (xii) gdsplot wrote {rec['pngs']}")
    return rec


def phase_ensemble(torch, gs, cuda_stencil, workdir, report):
    """Phase 4 (ix), the ensemble main path (``[ensemble]``; config (a)
    with members), the launch counts set to 0 just before each run and
    read just after, every member's stores compared file for file with
    a solo run of that member (its preset, seed ``k``):

    (a) the five presets on one block through ``driver.main``: 200
        ``kBlock`` launches of 5 members (solo (a)'s count, not 1,000);
    (b) three members on (2,2,2) on ``cuda:0`` at depth 1 (1,600
        ``kFaces6`` launches of 3 members), on (8,1,1) at ``GS_FUSE=2``
        fused (x-chain) and on (2,2,1) at ``GS_FUSE=2`` split (the
        xy-chain operand and the bands), 50 steps;
    (c) ``member_shards = 2``: four members, two groups of four blocks
        (2,2,1) on ``cuda:0``, 50 steps;
    (d) chaos scenario 4 and the ensemble half of 5 (L=64), a ``nan`` at
        ``GS_FAULT_MEMBER=3`` named as member 3 under ``rollback``, and a
        live shrink 5 -> 4 between rounds (``reshape_live(settings=)``)
        bitwise equal to the unmoved members;
    (e) times: one batched ``kBlock`` launch at N = 1, 2, 5 (L=256): device
        ms per member (CUDA events and profiler) and host ms per call;
        (a)'s compute ms/step against five solo runs', and its steady
        ms/step without output (a warm chunk of 50 steps, twice in turns).

    Returns ``{mode: (batched launches, members)}`` for the kernels
    line. The phase's tuning cache is a directory of its workdir."""
    saved = value_from_env("GS_AUTOTUNE_CACHE")
    os.environ["GS_AUTOTUNE_CACHE"] = os.path.join(workdir, "ens_tune")
    try:
        return _phase_ensemble(torch, gs, cuda_stencil, workdir, report)
    finally:
        if saved is None:
            os.environ.pop("GS_AUTOTUNE_CACHE", None)
        else:
            os.environ["GS_AUTOTUNE_CACHE"] = saved


def _phase_ensemble(torch, gs, cuda_stencil, workdir, report):
    import dataclasses

    import numpy as np

    from grayscott_jl_tpu_torch import chaos, driver
    from grayscott_jl_tpu_torch.config.settings import get_settings
    from grayscott_jl_tpu_torch.ensemble.engine import EnsembleSimulation
    from grayscott_jl_tpu_torch.ensemble.io import member_path, member_settings
    from grayscott_jl_tpu_torch.io.bplite import BpReader
    from grayscott_jl_tpu_torch.reshard.restore import reshape_live

    out = {}
    rec = {}

    def counts():
        return ({m: c for m, c in cuda_stencil.MODE_LAUNCHES.items() if c},
                {m: c for m, c in cuda_stencil.MODE_MEMBERS.items() if c},
                cuda_stencil.BAND_LAUNCHES)

    def compute_ms(stats_path, steps):
        with open(stats_path, encoding="utf-8") as f:
            stats = json.load(f)
        return stats["phases_s"]["compute"] * 1e3 / steps, stats

    def stores_of(settings, k):
        """Member ``k``'s store paths (output, .vtk series, checkpoint)."""
        ms = member_settings(settings, k)
        outs = [ms.output, os.path.splitext(ms.output)[0] + ".vtk"]
        if settings.checkpoint:
            outs.append(ms.checkpoint_output)
        return outs

    def solo_run(settings, k, d, factory=None, env=None):
        """Member ``k`` as a solo run into ``d``: its settings with the
        paths moved, seed ``k``; returns (paths, launch counts, stats)."""
        ms = member_settings(settings, k)
        ms = dataclasses.replace(
            ms, output=os.path.join(d, os.path.basename(ms.output)),
            checkpoint_output=os.path.join(
                d, os.path.basename(ms.checkpoint_output)))
        os.makedirs(d, exist_ok=True)
        stats_path = os.path.join(d, "stats.json")
        os.environ["GS_TPU_STATS"] = stats_path
        cuda_stencil.reset_launches()
        try:
            driver.run_once(ms, seed=k, sim_factory=factory)
        finally:
            os.environ.pop("GS_TPU_STATS", None)
        return ms, counts(), stats_path

    def same_as_solo(settings, k, ms, label):
        """Member ``k``'s stores against the solo run's, file for file."""
        for a, b in zip(stores_of(settings, k),
                        [ms.output, os.path.splitext(ms.output)[0] + ".vtk",
                         ms.checkpoint_output]):
            bad = chaos.trees_equal(a, b)
            check(not bad, f"{label}: member {k}'s {os.path.basename(a)} "
                  f"differs from the solo run's: {bad[:5]}")

    def ens_run(name, presets, factory=None, member_shards=1, **kw):
        cfg = os.path.join(workdir, f"{name}.toml")
        d = os.path.join(workdir, name)
        os.makedirs(d, exist_ok=True)
        write_ens_config(cfg, presets, member_shards,
                         output=os.path.join(d, "gs.bp"),
                         checkpoint_output=os.path.join(d, "ckpt.bp"), **kw)
        settings = get_settings([cfg])
        stats_path = os.path.join(d, "stats.json")
        os.environ["GS_TPU_STATS"] = stats_path
        cuda_stencil.reset_launches()
        t0 = time.perf_counter()
        try:
            sim = driver.run_once(settings, sim_factory=factory)
        finally:
            os.environ.pop("GS_TPU_STATS", None)
        wall = time.perf_counter() - t0
        return settings, sim, counts(), stats_path, wall

    # (a) One block, five members.
    settings, sim, (modes, members, _), stats_path, wall = ens_run(
        "ens_a", ENS_PRESETS, checkpoint=True, checkpoint_freq=100)
    settings_a = settings
    check(modes == {"chain": MAIN_STEPS} and members == {"chain": 5},
          f"(a) ensemble launched {modes} with members {members}, expected "
          f"{MAIN_STEPS} chain launches of 5 members")
    took(report, cuda_stencil, "ensemble_chain")
    ens_ms, ens_stats = compute_ms(stats_path, MAIN_STEPS)
    out["chain"] = (modes["chain"], 5)
    solo_ms = []
    for k in range(len(ENS_PRESETS)):
        ms, (s_modes, _, _), s_stats = solo_run(
            settings, k, os.path.join(workdir, f"ens_a_solo{k}"))
        check(s_modes == modes, f"(a) solo member {k} launched {s_modes}")
        same_as_solo(settings, k, ms, "(a)")
        solo_ms.append(compute_ms(s_stats, MAIN_STEPS)[0])
        with BpReader(member_path(settings.output, k, 5)) as r:
            u = r.get("U", step=r.num_steps() - 1)
            check(r.num_steps() == MAIN_STEPS // 50
                  and bool(np.isfinite(u).all()),
                  f"(a) member {k}'s store: {r.num_steps()} steps")
        for p in stores_of(settings, k):
            shutil.rmtree(p, ignore_errors=True)
        shutil.rmtree(os.path.join(workdir, f"ens_a_solo{k}"),
                      ignore_errors=True)
    rec["a"] = {"wall_s": wall, "launches": modes, "members": members,
                "compute_ms_per_step": ens_ms,
                "solo_compute_ms_per_step": solo_ms,
                "health": ens_stats.get("ensemble", {}).get("health"),
                "cell_updates_per_s": ens_stats["cell_updates_per_s"]}
    log(f"  (a) {len(ENS_PRESETS)} members on one block: {MAIN_STEPS} "
        f"kBlock launches in {wall:.2f} s, compute {ens_ms:.4f} ms/step "
        f"against {sum(solo_ms):.4f} for five solo runs; every member's "
        "stores byte-equal to its solo run's")

    # (b) The mesh: three members.
    def on_cuda0(dims):
        n = dims[0] * dims[1] * dims[2]

        def factory(s, *, n_devices, seed):
            cls = EnsembleSimulation if s.ensemble is not None else (
                gs.Simulation)
            return cls(s, seed=seed, mesh_dims=dims,
                       devices=["cuda:0"] * n)
        return factory

    meshes = [("b_2x2x2", (2, 2, 2), None, MAIN_STEPS, "off",
               {"faces6": 8 * MAIN_STEPS}),
              ("b_8x1x1", (8, 1, 1), "2", 50, "off", {"xchain": 8 * 25}),
              ("b_2x2x1", (2, 2, 1), "2", 50, "on",
               {"xychain": 4 * 25, "xchain": 4 * 4 * 25})]
    for name, dims, fuse, steps, overlap, want in meshes:
        if fuse:
            os.environ["GS_FUSE"] = fuse
        try:
            settings, sim, (modes, members, bands), _, wall = ens_run(
                name, ENS_MESH_PRESETS, factory=on_cuda0(dims),
                steps=steps, comm_overlap=overlap,
                checkpoint=steps == MAIN_STEPS, checkpoint_freq=100)
            check(modes == want and set(members.values()) == {3},
                  f"(b) {dims} launched {modes} with {members}, expected "
                  f"{want} of 3 members")
            if name == "b_2x2x2":
                took(report, cuda_stencil, "ensemble_faces6")
            for k in range(len(ENS_MESH_PRESETS)):
                ms, solo_counts, _ = solo_run(
                    settings, k, os.path.join(workdir, f"{name}_solo{k}"),
                    factory=on_cuda0(dims))
                check(solo_counts[0] == modes and solo_counts[2] == bands,
                      f"(b) {dims} solo member {k} launched {solo_counts}")
                same_as_solo(settings, k, ms, f"(b) {dims}")
                shutil.rmtree(os.path.join(workdir, f"{name}_solo{k}"))
        finally:
            os.environ.pop("GS_FUSE", None)
        shutil.rmtree(os.path.join(workdir, name))
        for mode, n in modes.items():
            key = "xchain_band" if (mode == "xchain" and bands) else mode
            out[key] = (n if key != "xchain_band" else bands, 3)
        rec[name] = {"wall_s": wall, "launches": modes, "bands": bands,
                     "members": members}
        log(f"  (b) 3 members on {dims} (GS_FUSE={fuse or 1}, "
            f"comm_overlap={overlap}): {modes} (bands {bands}) in "
            f"{wall:.2f} s, the solo runs' counts; stores byte-equal")


    # (c) The member split: two groups of four blocks on cuda:0.
    def split_factory(s, *, n_devices, seed):
        if s.ensemble is None:
            return gs.Simulation(s, seed=seed, devices=["cuda:0"] * 4)
        return EnsembleSimulation(s, seed=seed, devices=["cuda:0"] * 8)

    settings, sim, (modes, members, _), _, wall = ens_run(
        "c_split", ENS_SPLIT_PRESETS, factory=split_factory,
        member_shards=2, steps=50)
    check(sim.member_shards == 2 and sim.domain.dims == (2, 2, 1)
          and modes == {"faces6": 2 * 4 * 50} and members == {"faces6": 2},
          f"(c) member_shards=2 ran {sim.domain.dims} x "
          f"{sim.member_shards}: {modes} with {members}")
    for k in range(len(ENS_SPLIT_PRESETS)):
        ms, solo_counts, _ = solo_run(
            settings, k, os.path.join(workdir, f"c_solo{k}"),
            factory=split_factory)
        check(solo_counts[0] == {"faces6": 4 * 50},
              f"(c) solo member {k} launched {solo_counts}")
        same_as_solo(settings, k, ms, "(c)")
        shutil.rmtree(os.path.join(workdir, f"c_solo{k}"))
    shutil.rmtree(os.path.join(workdir, "c_split"))
    rec["c"] = {"wall_s": wall, "launches": modes, "members": members}
    log(f"  (c) member_shards = 2: two groups of (2,2,1) on cuda:0, "
        f"{modes} of 2 members in {wall:.2f} s; stores byte-equal")

    # (d) Resilience.
    d_dir = os.path.join(workdir, "chaos")
    ch = chaos.Chaos("CUDA", 64, 60, 7, d_dir)
    t0 = time.perf_counter()
    s4 = ch.scenario_4()
    grow = ch._ensemble_grow()
    check(s4["ok"] and not grow,
          f"(d) chaos scenario 4 {s4}; the grown resume: {grow}")
    nan_dir = os.path.join(workdir, "nan3")
    cfg = chaos.write_config(nan_dir, backend="CUDA", L=64, steps=60,
                             presets=ENS_PRESETS, health_policy="rollback")
    base_dir = os.path.join(workdir, "nan3_base")
    base_cfg = chaos.write_config(base_dir, backend="CUDA", L=64, steps=60,
                                  presets=ENS_PRESETS)
    check(chaos.run(base_cfg, {}) is None, "(d) the nan base run failed")
    err = chaos.run(cfg, {**chaos.SUPERVISED, "GS_FAULT_MEMBER": "3",
                          "GS_FAULTS": "step=30:kind=nan"})
    health = [e for e in chaos.journal(nan_dir) if e["event"] == "health"]
    check(err is None and health and health[0].get("bad_members") == [3],
          f"(d) nan at member 3: {err!r}, health records {health}")
    for store in ch.member_stores(len(ENS_PRESETS)):
        bad = chaos.trees_equal(os.path.join(base_dir, store),
                                os.path.join(nan_dir, store))
        check(not bad, f"(d) after the rollback {store} differs: {bad[:5]}")
    s5 = gs.Settings(L=64, noise=0.1, dt=1.0, precision="Float32",
                     backend="CUDA", kernel_language="CUDA")
    from grayscott_jl_tpu_torch.ensemble import spec as ens_spec

    s5.ensemble = ens_spec.from_toml({"presets": list(ENS_PRESETS)}, s5)
    s4m = dataclasses.replace(s5, ensemble=ens_spec.from_toml(
        {"presets": list(ENS_PRESETS[:4])}, s5))
    live = EnsembleSimulation(s5, seed=0)
    ref = EnsembleSimulation(s5, seed=0)
    live.iterate(20)
    live, plan = reshape_live(live, settings=s4m)
    live.iterate(20)
    ref.iterate(40)
    check(live.n_members == 4 and plan.changed
          and all(np.array_equal(a, b[:4]) for a, b in
                  zip(live.get_fields(), ref.get_fields())),
          f"(d) live shrink 5 -> 4: {plan.describe()}")
    rec["d"] = {"scenario_4": s4, "nan_member": health[0],
                "shrink": {"path": live.reshard.get("path"),
                           "wall_s": live.reshard.get("wall_s")},
                "seconds": time.perf_counter() - t0}
    log(f"  (d) chaos 4 (byte-identical member stores after a preemption) "
        f"and a resume grown 2 -> 3; nan at GS_FAULT_MEMBER=3 named as "
        f"members {health[0]['bad_members']} under rollback, stores equal; "
        f"live shrink 5 -> 4 ({live.reshard.get('path')}) bitwise")
    shutil.rmtree(d_dir, ignore_errors=True)

    # (e) Times of one batched kBlock launch.
    from grayscott_jl_tpu_torch.models import get_model
    from grayscott_jl_tpu_torch.ops import kernelgen

    spec = kernelgen.get_spec(get_model("grayscott"))
    gen = torch.Generator(device="cuda").manual_seed(23)
    times = []
    for n in (1, 2, 5):
        rows = [dict(Du=0.2, Dv=0.1, F=0.02 + 0.005 * i, k=0.048, dt=1.0,
                     noise=0.1) for i in range(n)]
        f = tuple(torch.rand((n,) + (MAIN_L,) * 3, generator=gen,
                             device="cuda") for _ in range(2))
        params = cuda_stencil.member_params(rows, spec.model.params_cls,
                                            torch.float32, "cuda")
        seeds = cuda_stencil.member_seeds([(0, i) for i in range(n)], 0)

        def launch():
            return cuda_stencil.fused_step(f, params, seeds, spec=spec,
                                           row=MAIN_L)

        ev_ms = time_calls(torch, launch)
        prof = device_profile(torch, launch)
        launch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            launch()
        host_ms = (time.perf_counter() - t0) * 1e3 / 20
        torch.cuda.synchronize()
        b_ms, b_by = bound_of(2 * 2 * 4 * n * MAIN_L**3,
                              n * spec.flops_per_cell_step() * MAIN_L**3)
        # Per launch the profiler recorded (it may drop events late in a
        # long run; the launches it kept are timed whole).
        row = {"members": n, "ms": ev_ms, "ms_per_member": ev_ms / n,
               "profiler_ms": (None if not prof or not prof["kernel_launches"]
                               else prof["kernel_ms"]
                               / prof["kernel_launches"]),
               "profiler_launches": None if not prof
               else prof["kernel_launches"],
               "host_ms_per_call": host_ms, "bound_ms": b_ms,
               "bound_by": b_by}
        times.append(row)
        log(f"  (e) N={n}: {ev_ms:.4f} ms a launch ({ev_ms / n:.4f} a "
            f"member; profiler "
            + ("not measured" if row["profiler_ms"] is None
               else f"{row['profiler_ms']:.4f}")
            + f"), host {host_ms:.4f} ms a call, bound {b_ms:.4f} ms")
        del f
    # (a)'s steady ms/step without output: the five members batched
    # against the five solo runs in turn, warm, a synchronised chunk of 50
    # steps each (host clock), twice in turns.
    def steady(sim):
        sim.iterate(10)
        sim.block_until_ready()
        t0 = time.perf_counter()
        sim.iterate(50)
        sim.block_until_ready()
        return (time.perf_counter() - t0) * 1e3 / 50

    rounds = []
    for _ in range(2):
        batched_ms = steady(EnsembleSimulation(settings_a, seed=0))
        solo_ms = [steady(gs.Simulation(member_settings(settings_a, k),
                                        seed=k))
                   for k in range(len(ENS_PRESETS))]
        rounds.append({"batched_ms_per_step": batched_ms,
                       "solo_ms_per_step": solo_ms,
                       "ratio": batched_ms / sum(solo_ms)})
        log(f"  (e) (a) steady: {batched_ms:.4f} ms/step batched against "
            f"{sum(solo_ms):.4f} for five solo runs "
            f"({batched_ms / sum(solo_ms):.4f})")
    # The fabric model's MEMBER_COST_RATIO: the profiler's device time
    # (the events of a host-bound N=1 launch include its gaps).
    prof = [t["profiler_ms"] for t in times]
    ratio = (prof[-1] / 5 / prof[0] if None not in prof
             else times[-1]["ms_per_member"] / times[0]["ms"])
    rec["e"] = {"launch": times, "member_cost_ratio": ratio,
                "steady": rounds}
    log(f"  (e) device time per member at N=5 over N=1 "
        f"(MEMBER_COST_RATIO): {ratio:.4f}")
    report["ensemble"] = rec
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    report = {}
    # No phase reads or leaves a tuning cache outside the run's own
    # directory (Auto's ``cached`` default reads one).
    tune_dir = tempfile.mkdtemp(prefix="gs_chip_smoke_tune_")
    os.environ["GS_AUTOTUNE_CACHE"] = tune_dir
    try:
        return _main(torch, report)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def _main(torch, report):
    import grayscott_jl_tpu_torch as gs
    from grayscott_jl_tpu_torch.models import get_model
    from grayscott_jl_tpu_torch.ops import _build, cuda_stencil, kernelgen

    smi = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: card {smi!r}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; device {kind!r}, count "
        f"{torch.cuda.device_count()}")
    report["card"] = {"nvidia_smi": smi, "torch_name": kind,
                      "torch": torch.__version__, "cuda": torch.version.cuda}

    import threading

    from grayscott_jl_tpu_torch.io import native

    t0 = time.perf_counter()
    # The store engine's library (g++) builds beside the kernels (nvcc).
    native_s = {}
    native_thread = threading.Thread(target=lambda: native_s.update(
        ok=native.available(),
        seconds=time.perf_counter() - t0))
    native_thread.start()
    built = _build.build_all(envelope=True)
    build_s = time.perf_counter() - t0
    native_thread.join()
    check(native_s["ok"], f"the native store engine did not build: "
          f"{native.BUILD_ERROR}")
    log(f"  the native store engine ({native.library_path()}) built with "
        f"g++ in {native_s['seconds']:.2f} s, beside nvcc")
    report["native_build_s"] = native_s["seconds"]
    libs = sorted(MODELS + ("grayscott_envelope",))
    check(sorted(built) == libs, f"built {sorted(built)}, expected {libs}")
    log(f"phase 2: built the generated kernels of {sorted(built)} in "
        f"{build_s:.2f} s (one nvcc each, in parallel)")
    ptxas = {name: [line.strip() for line in info["log"].splitlines()
                    if "Compiling" in line or "registers" in line
                    or "spill" in line]
             for name, info in built.items()}
    for name in ("grayscott", "grayscott_envelope"):
        for line in ptxas[name]:
            log(f"  {name}: {line}")
    report["build_s"] = build_s
    report["build"] = {n: {"source": os.path.relpath(i["source"], REPO),
                           "seconds": i["seconds"], "ptxas": ptxas[n]}
                       for n, i in built.items()}

    specs = {name: kernelgen.get_spec(get_model(name)) for name in MODELS}
    spec = specs["grayscott"]
    log("phase 3: every model's kernel vs plain (bf16: its oracle) on "
        "the card")
    worst = {}
    for name, sp in specs.items():
        args = (torch, gs, cuda_stencil, sp, report)
        chain = timed(report, f"parity {name}", phase_parity, *args)
        faces = timed(report, f"face parity {name}", phase_face_parity,
                      *args)
        mid = timed(report, f"mid_bf16 parity {name}",
                    phase_mid_bf16_parity, *args)
        worst[name] = {"chain": chain["f"], "chain_bf16": chain["bf16"],
                       "mid_bf16": mid}
        for (mode, grp), err in faces.items():
            worst[name][mode if grp == "f" else f"{mode}_bf16"] = err
    band_worst = timed(report, "band parity", phase_band_parity, torch, gs,
                       cuda_stencil, spec, report)
    batch_worst = timed(report, "batch parity", phase_batch_parity, torch,
                        gs, cuda_stencil, spec, report)

    log("phase 4: main paths, single block and sharded")
    workdir = tempfile.mkdtemp(prefix="gs_chip_smoke_")
    try:
        args = (torch, gs, cuda_stencil, workdir, report)
        launches, main_fuse, stored = timed(report, "main path",
                                            phase_main_path, *args)
        # First after (a), so that its profiler window is the process's
        # first capture.
        log("phase 4 (x): build and launch analytics, profiler windows "
            "and the run report on (a); member groups across processes")
        timed(report, "observability", phase_observability, torch, gs,
              cuda_stencil, workdir, stored, report, clean=workdir)
        timed(report, "member procs", phase_member_procs, torch, gs,
              cuda_stencil, workdir, report, clean=workdir)
        faces6_launches = timed(report, "sharded", phase_sharded, torch, gs,
                                cuda_stencil, workdir, stored, report)
        fuse2 = timed(report, "fuse2", phase_fuse2, torch, gs, cuda_stencil,
                      stored, report)
        log("phase 4 (iii): the split-phase round and the s-step depth")
        band_launches = timed(report, "overlap", phase_overlap, torch, gs,
                              cuda_stencil, workdir, stored, report)
        log("phase 4 (i): the output pipeline at depth 0 and 2")
        timed(report, "async main path", phase_async_main_path, torch, gs,
              cuda_stencil, workdir, stored, report, clean=workdir)
        log("phase 4 (ii): integrity (GS_CKPT_VERIFY=full, replicas, "
            "scrub, bitflip) and F2 at depth 2")
        timed(report, "integrity", phase_integrity, torch, gs, cuda_stencil,
              workdir, stored, report, clean=workdir)
        timed(report, "shutdown", phase_shutdown, *args, clean=workdir)
        log("phase 4 (iv): two processes on cuda:0 (launch.py, gloo)")
        timed(report, "multiprocess", phase_multiprocess, torch, gs,
              cuda_stencil, workdir, stored, report, clean=workdir)
        log("phase 4 (v): the observability sinks and numerics probes")
        timed(report, "obs", phase_obs, torch, gs, cuda_stencil, workdir,
              stored, report, clean=workdir)
        log("phase 4 (vi): the supervisor, fault plans, watchdog and SDC "
            "screen")
        timed(report, "resilience", phase_resilience, torch, gs,
              cuda_stencil, workdir, report, clean=workdir)
        log("phase 4 (vii): elastic resharding — a restore on another "
            "mesh and live moves between rounds")
        timed(report, "reshard", phase_reshard, torch, gs, cuda_stencil,
              workdir, report, clean=workdir)
        log("phase 4 (viii): Auto's decision — the fabric model, mesh and "
            "depth adoption, and the measured autotuner")
        timed(report, "auto", phase_auto, torch, gs, cuda_stencil, workdir,
              report, clean=workdir)
        log("phase 4 (ix): ensembles — one launch per block and round "
            "advances every member")
        batched = timed(report, "ensemble", phase_ensemble, torch, gs,
                        cuda_stencil, workdir, report, clean=workdir)
        log("phase 4 (xi): serving — packed jobs on the batched kernel, "
            "warm engines, the result cache, chaos 6 and a worker process")
        timed(report, "serve", phase_serve, torch, gs, cuda_stencil,
              workdir, report, clean=workdir)
        log("phase 4 (xii): the analysis workflow — pdfcalc streaming a "
            "live L=256 run, its histograms on the card; gdsplot")
        timed(report, "analysis", phase_analysis, torch, gs, cuda_stencil,
              workdir, report, clean=workdir)
        del stored
        model_launches = {
            name: timed(report, f"{name} path", phase_model_path, torch, gs,
                        cuda_stencil, name, workdir, report, clean=workdir)
            for name in MODEL_PATHS
        }
        bf16_launches, bf16_fuse2 = timed(report, "bf16 path",
                                          phase_bf16_main_path, *args,
                                          clean=workdir)
        acc_launches, acc_faces6 = timed(report, "bf16_f32acc codec path",
                                         phase_bf16acc_codec, *args,
                                         clean=workdir)
        mid_launches = timed(report, "mid_bf16 path", phase_mid_bf16_path,
                             *args, clean=workdir)
        timed(report, "health", phase_health, *args)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    log("phase 5: times (float32, then bfloat16)")
    report["clocks_before"] = nvidia_smi(
        "clocks.sm,power.draw,power.limit,temperature.gpu")
    args = (torch, gs, cuda_stencil, spec, report)
    rows = timed(report, "times", phase_times, *args)
    face_rows = timed(report, "face times", phase_face_times, *args)
    timed(report, "load times", phase_load_times, *args)
    timed(report, "health times", phase_health_times, torch, gs, report)
    model_rows = {name: phase_model_times(torch, gs, cuda_stencil,
                                          specs[name], report)
                  for name in MODEL_PATHS}
    timed(report, "sharded times", phase_sharded_times, torch, gs, report)
    band_entry = timed(report, "band times", phase_band_times, *args)
    bf16_row, mid_rows = timed(report, "bf16 times", phase_bf16_times,
                               *args)
    bf16_faces = timed(report, "bf16 face times", phase_face_times, *args,
                       "bfloat16")
    log("phase 6: the envelope probes")
    probe_worst = timed(report, "envelope parity", phase_envelope_parity,
                        torch, cuda_stencil, spec, report)
    probe_dir = tempfile.mkdtemp(prefix="gs_chip_smoke_probe_")
    try:
        probe_first, probe_times = timed(report, "envelope probe",
                                         phase_envelope, torch, cuda_stencil,
                                         spec, probe_dir, report)
    finally:
        shutil.rmtree(probe_dir, ignore_errors=True)
    report["clocks_after"] = nvidia_smi(
        "clocks.sm,power.draw,power.limit,temperature.gpu")
    main_row = next(r for r in rows
                    if r["L"] == MAIN_L and r["fuse"] == main_fuse)
    f0 = tuple(torch.rand((MAIN_L,) * 3, device="cuda") for _ in range(2))
    params = spec.model.make_params(gs.Settings(**main_settings()),
                                    torch.float32, "cuda")
    main_row["profile"] = device_profile(torch, lambda: cuda_stencil.fused_step(
        f0, params, (0, 3, 0), spec=spec, fuse=main_fuse, row=MAIN_L))
    del f0
    entries = [
        ("stencil_chain", "chain", launches, worst["grayscott"]["chain"],
         main_row),
        ("stencil_faces6", "faces6", faces6_launches,
         worst["grayscott"]["faces6"], face_rows["faces6"]),
        ("stencil_xchain", "xchain", fuse2["8x1x1"]["launches"],
         worst["grayscott"]["xchain"], face_rows["xchain"]),
        ("stencil_xychain", "xychain", fuse2["2x2x2"]["launches"],
         worst["grayscott"]["xychain"], face_rows["xychain"]),
        ("stencil_xchain_band", "xchain", band_launches, band_worst,
         band_entry),
    ] + [
        (f"stencil_chain_{name}", "generated", model_launches[name],
         max(worst[name].values()), model_rows[name])
        for name in MODEL_PATHS
    ] + [
        ("stencil_chain_bf16", "bf16", bf16_launches,
         worst["grayscott"]["chain_bf16"], bf16_row),
        ("stencil_faces6_bf16", "bf16", acc_faces6,
         worst["grayscott"]["faces6_bf16"], bf16_faces["faces6"]),
        ("stencil_xchain_bf16", "bf16", bf16_fuse2["8x1x1"],
         worst["grayscott"]["xchain_bf16"], bf16_faces["xchain"]),
        ("stencil_xychain_bf16", "bf16", bf16_fuse2["2x2x2"],
         worst["grayscott"]["xychain_bf16"], bf16_faces["xychain"]),
        ("stencil_chain_mid_bf16", "mid_bf16", mid_launches,
         worst["grayscott"]["mid_bf16"], mid_rows[0]),
    ]
    from grayscott_jl_tpu_torch.ops import envelope

    for variant in ("copy_walk",) + envelope.VARIANTS:
        case = ("copy_walk" if variant == "copy_walk"
                else envelope.case_name(variant))
        probe_row = probe_first["rows"][case]
        unique, _, flops = envelope.work(case, (MAIN_L,) * 3, 1)
        b_ms, b_by = bound_of(unique, flops)
        library = (probe_first["rows"]["torch_copy"]["median_us_per_pass"]
                   / 1e3 if variant == "copy_walk" else None)
        entries.append((
            f"envelope_{case}",
            "dma_walk" if variant == "copy_walk" else "compute_walk",
            (probe_first["modes"]["copy_walk"] if variant == "copy_walk"
             else probe_first["variants"][variant]),
            probe_worst[variant],
            {"ms": probe_row["median_us_per_pass"] / 1e3,
             "plain_ms": probe_times[variant]["plain_ms"], "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": library},
        ))
    report["bf16_acc_launches"] = acc_launches

    def load_of(name, n):
        """The load path entry ``name`` took on its main path (``took``,
        read in the run whose counts give its ``n`` launches; the probes
        share one run), checked against the path the shape rule picks
        for that operand."""
        probe = name.startswith("envelope_")
        rec = report["load_path"]["envelope" if probe else name]
        check(rec["launches"] >= n if probe else rec["launches"] == n,
              f"{name}: {n} launches, but its run counted {rec}")
        shape = MAIN_SHAPES.get(name.split("_bf16")[0].replace(
            "_mid", ""), (MAIN_L,) * 3)
        itemsize = 2 if "bf16" in name and "mid" not in name else 4
        rule = cuda_stencil.load_path(shape, itemsize, (0,))
        check(rec["path"] == rule,
              f"{name} loaded by {rec['path']}, the rule says {rule}")
        return rec["path"]

    #: The production modes' batched launches (phase 4 (ix)) and their
    #: member count, and the batched parity's mode (phase 3).
    batch_of = {"stencil_chain": ("chain", "chain"),
                "stencil_faces6": ("faces6", "faces6"),
                "stencil_xchain": ("xchain", "xchain"),
                "stencil_xychain": ("xychain", "xychain"),
                "stencil_xchain_band": ("xchain_band", "band")}

    def batch(name, err):
        ens_key, parity_key = batch_of.get(name, (None, None))
        n, members = batched.get(ens_key, (0, 1))
        return {"members": members, "batched_launches": n,
                "max_abs_err": max(err, batch_worst.get(parity_key, 0.0))}

    kernels = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[mode],
            "launches": n,
            "max_abs_err": err,
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
            "load_path": load_of(name, n),
            **batch(name, err),
        }
        for name, mode, n, err, row in entries
    ]}
    report["kernels"] = kernels["kernels"]
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke_report.json"),
              "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1)
    # The ensemble phase's numbers on a line of their own (the report
    # file stays beside the checkout that ran).
    ens = report["ensemble"]
    print(json.dumps({"ensemble": {
        "a": {k: ens["a"][k] for k in ("wall_s", "compute_ms_per_step",
                                       "solo_compute_ms_per_step")},
        "walls_s": {k: v["wall_s"] for k, v in ens.items() if "wall_s" in v},
        "launch": ens["e"]["launch"], "steady": ens["e"]["steady"],
        "member_cost_ratio": ens["e"]["member_cost_ratio"],
        "phase_s": report["phase_s"]["ensemble"]}}))
    print(json.dumps({"serve": {**report["serve"],
                                "phase_s": report["phase_s"]["serve"]}}))
    print(json.dumps({"analysis": {**report["analysis"],
                                   "phase_s": report["phase_s"]["analysis"]}}))
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
