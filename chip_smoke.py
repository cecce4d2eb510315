#!/usr/bin/env python3
"""Smoke run of ``grayscott_jl_tpu_torch`` on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and
``nvcc``. Phases, each of which stops the run on failure:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build every CUDA kernel from ``grayscott_jl_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, all started together), timed;
3. every kernel against its plain torch version on the card: float32
   and float64, noise 0 and 0.1, every chain depth up to the
   shared-memory ledger's cap, L = 64, 100 (ragged tiles) and 256, 20
   steps from random fields — bitwise equal, and depth k bitwise equal
   to k launches of depth 1;
4. the main path: ``driver.main`` on an L=256 float32 config with noise,
   plotgap 50, a checkpoint every 100 steps, 200 steps — with the
   kernel launch counts set to 0 just before and read just after, then
   the store read back (ranges, and bitwise equal to the plain path on
   the card), and a restart from the step-100 checkpoint that must
   reproduce the stored step 200 bitwise;
5. times at the main path's shapes (L=256 and 512, float32, every chain
   depth): the kernel (CUDA events, after warm-up), its plain version,
   and the least time the card could take (bytes moved over the memory
   rate, or floating-point operations over the float32 rate).

Prints the kernels' JSON line, then the ``nvidia-smi`` line, then the
result line ``{"ok": true, "device": {...}}`` last; writes the full
report to ``chiprun_out/chip_smoke_report.json``. Exits non-zero with
no result line when there is no card or any phase fails. Imports
neither JAX nor the JAX package.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and
#: non-tensor-core float32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

#: Floating-point operations per cell and step of the Gray-Scott step
#: with noise: Laplacians 2 x 7, reaction 12, noise scaling 3 (the
#: uniform's ``* 2 - 3`` and ``noise *``), Euler update 2 x 2.
FLOPS_PER_CELL_STEP = 33

MAIN_L = 256
MAIN_STEPS = 200
REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "grayscott_jl_tpu_torch/ops/csrc/stencil_chain.cu"
REPLACES = "grayscott_jl_tpu/ops/pallas_stencil.py:848"


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(L, fuse, itemsize=4, n_fields=2):
    """Least time of one launch advancing ``fuse`` steps on L^3: each
    field read once and written once, against the float work."""
    cells = L**3
    t_bytes = 2 * n_fields * itemsize * cells / HBM_BYTES_PER_S
    t_ops = fuse * FLOPS_PER_CELL_STEP * cells / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_parity(torch, gs, cuda_stencil, spec, report):
    """Kernel vs plain, bitwise, and depth k vs k x depth 1."""
    steps = 20
    worst = 0.0
    rows = []
    for dtype, prec in ((torch.float32, "Float32"), (torch.float64, "Float64")):
        cap = cuda_stencil.max_feasible_fuse(
            torch.empty((), dtype=dtype).element_size()
        )
        for L in (64, 100, 256):
            for noise in (0.0, 0.1):
                settings = gs.Settings(
                    L=L, noise=noise, F=0.02, k=0.048, Du=0.2, Dv=0.1,
                    dt=1.0, precision=prec,
                )
                params = spec.model.make_params(settings, dtype, "cuda")
                gen = torch.Generator(device="cuda").manual_seed(1000 + L)
                f0 = tuple(
                    torch.rand((L, L, L), generator=gen, device="cuda",
                               dtype=dtype)
                    for _ in range(2)
                )
                seeds = (0, 11, 40)
                plain = cuda_stencil.plain_chain(
                    f0, params, seeds, spec=spec, use_noise=noise != 0,
                    fuse=steps, row=L,
                )
                by_fuse = {}
                for fuse in range(1, cap + 1):
                    f, done = f0, 0
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
                    worst = max(worst, err)
                    check(all(torch.isfinite(a).all().item() for a in f),
                          f"non-finite kernel output {prec} L={L} fuse={fuse}")
                    check(all(torch.equal(a, b) for a, b in zip(f, plain)),
                          f"kernel != plain: {prec} L={L} noise={noise} "
                          f"fuse={fuse}, max |diff| {err}")
                    by_fuse[fuse] = f
                    rows.append([prec, L, noise, fuse, err])
                for fuse, f in by_fuse.items():
                    check(all(torch.equal(a, b)
                              for a, b in zip(f, by_fuse[1])),
                          f"fuse={fuse} != {fuse} x fuse=1: {prec} L={L}")
                log(f"  {prec} L={L} noise={noise}: fuse 1..{cap} "
                    "bitwise equal to plain and to k x fuse=1")
    report["parity"] = rows
    return worst


def write_config(path, **kw):
    lines = []
    for key, value in kw.items():
        if isinstance(value, bool):
            lines.append(f"{key} = {'true' if value else 'false'}")
        elif isinstance(value, str):
            lines.append(f"{key} = \"{value}\"")
        else:
            lines.append(f"{key} = {value}")
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

    common = dict(
        L=MAIN_L, Du=0.2, Dv=0.1, F=0.02, k=0.048, dt=1.0, noise=0.1,
        steps=MAIN_STEPS, plotgap=50, precision="Float32",
        backend="CUDA", kernel_language="Pallas",
    )
    out = os.path.join(workdir, "gs.bp")
    ckpt = os.path.join(workdir, "ckpt.bp")
    cfg = os.path.join(workdir, "main.toml")
    write_config(cfg, **common, output=out, checkpoint=True,
                 checkpoint_freq=100, checkpoint_output=ckpt)

    stats_path = os.path.join(workdir, "stats.json")
    os.environ["GS_TPU_STATS"] = stats_path
    cuda_stencil.LAUNCHES = 0
    t0 = time.perf_counter()
    sim = driver.main([cfg])
    wall = time.perf_counter() - t0
    launches = cuda_stencil.LAUNCHES
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
        "run_stats": stats,
        "u_range": [float(u_end.min()), float(u_end.max())],
        "v_range": [float(v_end.min()), float(v_end.max())],
    }
    return launches, sim.fuse


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
        for fuse in range(1, cap + 1):
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
            b_ms, b_by = bound_ms(L, fuse)
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import grayscott_jl_tpu_torch as gs
    from grayscott_jl_tpu_torch.models import grayscott
    from grayscott_jl_tpu_torch.ops import _build, cuda_stencil, kernelgen

    report = {}
    smi = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: card {smi!r}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; device {kind!r}, count "
        f"{torch.cuda.device_count()}")
    report["card"] = {"nvidia_smi": smi, "torch_name": kind,
                      "torch": torch.__version__, "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"phase 2: built {sorted(built)} in {build_s:.2f} s")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    report["build_s"] = build_s

    spec = kernelgen.get_spec(grayscott.MODEL)
    log("phase 3: kernel vs plain on the card")
    worst = phase_parity(torch, gs, cuda_stencil, spec, report)

    log("phase 4: main path")
    workdir = tempfile.mkdtemp(prefix="gs_chip_smoke_")
    try:
        launches, main_fuse = phase_main_path(
            torch, gs, cuda_stencil, workdir, report)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    log("phase 5: times (float32)")
    report["clocks_before"] = nvidia_smi(
        "clocks.sm,power.draw,power.limit,temperature.gpu")
    rows = phase_times(torch, gs, cuda_stencil, spec, report)
    report["clocks_after"] = nvidia_smi(
        "clocks.sm,power.draw,power.limit,temperature.gpu")
    main_row = next(r for r in rows
                    if r["L"] == MAIN_L and r["fuse"] == main_fuse)
    kernels = {"kernels": [{
        "name": "stencil_chain",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": worst,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
    }]}
    report["kernels"] = kernels["kernels"]
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke_report.json"),
              "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
