"""Decompose one pass of the port's stencil chain into its copy and
compute envelopes (counterpart of ``benchmarks/envelope_probe.py``).

    python -m grayscott_jl_tpu_torch.probes.envelope_probe [--l 256]
        [--fuse 1] [--steps 100] [--rounds 6] [--noise 0.1] [--out F.jsonl]
        [--cpu]

The chain kernel (``ops/csrc/stencil_chain.cu``) reaches a fraction of
its byte bound at depth 1, and halving its bytes did not speed it up
(PERF.md). This probe times, in ONE process (so every case sees the
same clock and power state), the cases that take one pass apart:

  torch_stream  ``u * 1.0000001`` on both fields, one torch call each:
                the library's streaming rate for reading and writing
                two fields (xla_stream's counterpart);
  torch_copy    ``Tensor.copy_`` of both fields: the library yardstick
                of copy_walk;
  copy_walk     the chain's stage-0 window loads at depth ``fuse`` and
                the tile writes, no arithmetic (``ops/envelope.py``):
                the kernel's copy envelope at its own occupancy;
  compute_walk  the full stage chain in every block on one resident
                window (device memory serves about one window, L2 the
                rest), one tile written: the compute envelope;
  full          the production ``cuda_stencil.fused_step`` at depth
                ``fuse`` (``seeds = (1, 2, pass * fuse)``);

and with ``GS_PROBE_COMPUTE_VARIANTS=1`` the compute walk's variants
(``compute_nonoise``, ``compute_noselect``, ``compute_noyz``,
``compute_fma``, ``compute_minimal``, ``compute_nomid``), whose
differences from ``compute_walk`` isolate the noise hash, the pins, the
y/z neighbour reads, the coefficient form, the structural floor and the
mid-window round trips.

Reading it: every block of the compute walk still walks its window in
(from L2), and compute_minimal is that walk with one multiply a cell,
so compute_walk - compute_minimal is the stage arithmetic. full ~
copy_walk + that arithmetic means the window walk and the arithmetic
serialize, full ~ the larger of the two that they overlap; copy_walk
far above torch_copy means the walk, not the bytes, sets the copy
envelope.

Every case is warmed first, then the cases run round-robin for
``--rounds`` rounds; each timing is ``steps // fuse`` passes between two
CUDA events and one synchronise (on the CPU, ``--cpu``, the host
clock). Inputs are u = 1, v = 0 as in the TPU probe; the copy walk,
torch cases and ``full`` feed each pass's output to the next, the
compute walk reads the same inputs every pass. ``--bx`` has no
counterpart: the kernel's tile is the compile-time ``TILE`` (8, 8, 32).

Emits one JSON line per case (``--out`` appends them as JSONL) with the
TPU probe's keys (``case, L, fuse, noise, n_passes, rounds_us_per_pass,
best_us_per_pass, median_us_per_pass, traffic_mb_per_pass,
effective_gbps``) and ``unique_mb_per_pass`` (each field read and
written once; for the compute walk one window in, one tile out),
``bound_us_per_pass`` (those bytes over 3.35 TB/s against the pass's
float operations over 67 TFLOP/s, H100 SXM data-sheet peaks),
``bound_by``, ``timer`` and ``device`` (the ``nvidia-smi`` name and
power limit, or ``cpu``). ``traffic_mb_per_pass`` counts the window
loads as issued; ``effective_gbps`` divides the unique bytes by the
best time, so it reads against 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import List, Optional

import torch

from ..config.env import env_str
from ..models import grayscott
from ..ops import cuda_stencil, envelope, kernelgen

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and
#: non-tensor-core float32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

#: The physics of the TPU probe's compute walk and ``full`` case.
PHYSICS = dict(Du=0.2, Dv=0.1, F=0.02, k=0.048, dt=1.0)


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_params(noise: float, device):
    """The probe's Gray-Scott params, float32 on ``device``."""
    values = dict(PHYSICS, noise=noise)
    return grayscott.Params(**{
        f: torch.tensor(values[f], dtype=torch.float32, device=device)
        for f in grayscott.Params._fields
    })


def build_cases(L: int, fuse: int, noise: float, n_passes: int, device,
                variants: bool = False):
    """``[(case, fn)]``: each ``fn(u, v)`` runs ``n_passes`` passes of
    its case and returns the last pass's fields."""
    spec = kernelgen.get_spec(grayscott.MODEL)
    params = make_params(noise, device)
    use_noise = noise > 0
    scale = torch.tensor(1.0000001, dtype=torch.float32, device=device)
    shape = (L, L, L)
    bufs = [tuple(torch.empty(shape, device=device) for _ in range(2))
            for _ in range(2)]

    def torch_stream(u, v):
        for _ in range(n_passes):
            u, v = u * scale, v * scale
        return u, v

    def torch_copy(u, v):
        f = (u, v)
        for i in range(n_passes):
            f = envelope.torch_copy(f, bufs[i % 2])
        return f

    def copy_walk(u, v):
        for _ in range(n_passes):
            u, v = envelope.copy_walk((u, v), fuse=fuse)
        return u, v

    def compute(variant):
        def walk(u, v):
            out = (u, v)
            for _ in range(n_passes):
                out = envelope.compute_walk(
                    (u, v), params, (1, 2, 0), spec=spec, fuse=fuse,
                    use_noise=use_noise, variant=variant)
            return out

        return walk

    def full(u, v):
        for i in range(n_passes):
            u, v = cuda_stencil.fused_step(
                (u, v), params, (1, 2, i * fuse), spec=spec,
                use_noise=use_noise, fuse=fuse)
        return u, v

    cases = [("torch_stream", torch_stream), ("torch_copy", torch_copy),
             ("copy_walk", copy_walk), ("compute_walk", compute("chain")),
             ("full", full)]
    if variants:
        cases += [(envelope.case_name(v), compute(v))
                  for v in envelope.VARIANTS[1:]]
    return cases


def _pass_us(fn, u, v, on_card: bool, n_passes: int) -> float:
    """µs per pass of one timing of ``fn``."""
    if on_card:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(u, v)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) * 1e3 / n_passes
    t0 = time.perf_counter()
    fn(u, v)
    return (time.perf_counter() - t0) * 1e6 / n_passes


def run(L: int = 256, fuse: int = 1, steps: int = 100, rounds: int = 6,
        noise: float = 0.1, cpu: bool = False,
        variants: Optional[bool] = None, log=None) -> List[dict]:
    """Time every case (warm-up first, then ``rounds`` round-robin
    rounds) and return one result dict per case. On the card unless
    ``cpu``; a card asked for and absent raises."""
    if variants is None:
        variants = env_str("GS_PROBE_COMPUTE_VARIANTS", "0") != "0"
    if cpu:
        device, on_card, name = torch.device("cpu"), False, "cpu"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the envelope probe runs on the CUDA card, and "
                "torch.cuda.is_available() is False; pass --cpu to run "
                "the plain versions on the host")
        device, on_card, name = torch.device("cuda"), True, card_name()
    n_passes = max(1, steps // fuse)
    u = torch.ones((L, L, L), dtype=torch.float32, device=device)
    v = torch.zeros((L, L, L), dtype=torch.float32, device=device)
    cases = build_cases(L, fuse, noise, n_passes, device, variants)
    for case, fn in cases:
        t0 = time.perf_counter()
        fn(u, v)
        if on_card:
            torch.cuda.synchronize()
        if log:
            log(f"probe: warmed {case} in {time.perf_counter() - t0:.1f}s")
    times = {case: [] for case, _ in cases}
    for _ in range(rounds):
        for case, fn in cases:
            times[case].append(_pass_us(fn, u, v, on_card, n_passes))
    results = []
    for case, us in times.items():
        unique, issued, flops = envelope.work(case, (L, L, L), fuse,
                                              use_noise=noise > 0)
        t_bytes = unique / HBM_BYTES_PER_S * 1e6
        t_ops = flops / F32_FLOPS_PER_S * 1e6
        best = min(us)
        results.append({
            "case": case, "L": L, "fuse": fuse, "noise": noise,
            "n_passes": n_passes, "rounds_us_per_pass": us,
            "best_us_per_pass": best,
            "median_us_per_pass": statistics.median(us),
            "traffic_mb_per_pass": issued / 1e6,
            "effective_gbps": unique / best / 1e3,
            "unique_mb_per_pass": unique / 1e6,
            "bound_us_per_pass": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "timer": "cuda_events" if on_card else "host_clock",
            "device": name,
        })
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m grayscott_jl_tpu_torch.probes.envelope_probe",
        description="Time the stencil chain's copy and compute envelopes.")
    ap.add_argument("--l", type=int, default=256)
    ap.add_argument("--fuse", type=int, default=1,
                    help="chain depth (the card's measured best is 1)")
    ap.add_argument("--steps", type=int, default=100,
                    help="simulation steps per timing round; each case "
                    "runs steps // fuse passes")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--noise", type=float, default=0.1)
    ap.add_argument("--out", default=None,
                    help="append the JSON lines to this file")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the host")
    ap.add_argument("--bx", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.bx is not None:
        ap.error("--bx has no counterpart on the card: the kernel's tile "
                 f"is the compile-time TILE {cuda_stencil.TILE} (x, y, z), "
                 "not a slab width")
    cap = cuda_stencil.max_feasible_fuse(4)
    if not 1 <= args.fuse <= cap:
        ap.error(f"--fuse must be in [1, {cap}] for two float32 fields "
                 "(the shared-memory ledger's cap)")
    results = run(args.l, args.fuse, args.steps, args.rounds, args.noise,
                  args.cpu, log=lambda m: print(m, file=sys.stderr,
                                                flush=True))
    for r in results:
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "a", encoding="utf-8") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
