"""Measure the fabric model's coefficients (``parallel/icimodel.py``) on
the card: the counterpart of the reference's ``update_fuse_ratio.py``,
``update_overlap.py``, ``update_halo_depth.py`` and ``ici_model.py``
calibration scripts, in one probe.

    python -m grayscott_jl_tpu_torch.probes.fabric [--cpu] [--l L]
        [--steps N] [--rounds R] [--parts P,...] [--out F.json]

Gray-Scott F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1, noise 0.1, float32 at
L (default 256). Step times are ``utils/benchmark.time_sim_rounds``
(warmup chunk, a device synchronise per round, the median of R rounds
of N steps); device times are ``torch.profiler``'s device events. The
parts (default ``one``; ``cards`` needs two cards or more):

* ``one``, on ``cuda:0``:
  - ``anchors``: µs/step of one block at depth 1 on the kernel at L =
    128, 256 and 512 and on the plain path at 128 and 256
    (``MEASURED_US``);
  - ``fuse_cost_ratio``: one block at depth k over depth 1, k up to the
    float32 ledger's cap (``FUSE_COST_RATIO``);
  - ``bf16_compute_ratio``: depth 1 under ``bf16_f32acc`` over float32;
  - ``stage_ratio``: the device time of the 6n-face kernel on the
    (2,2,2) blocks over the single block's (``STAGE_RATIO``);
  - ``launch_us``: host µs per ``fused_step`` call on an 8^3 block
    (``LAUNCH_US``);
  - the ``shared`` fabric: the 6n-face exchange of the (2,2,2) blocks
    on one card — host µs per face (``hop_us``) and face bytes over its
    device time (``link_gbps``);
  - ``z_band_us_per_cell``: the host time of the z-band recompute
    (``temporal.stitch_bands_from_frame``) in the (2,2,2) chain at depth
    2 per block and round, over its output cells;
  - ``overlap_efficiency`` and ``halo_depth_efficiency``: the (8,1,1)
    x-chain at depth 2 split against fused, and ``halo_depth`` 2 against
    1 (the plain path's too), each fitted through the model with the
    values above and clipped to [0, 1] (:func:`_calibrate`; the fits
    themselves in ``raw``);
  - the ``gloo`` fabric: ``probes/launch_times`` with 2 processes of 4
    blocks on the card — host µs per ppermute and bytes over that time;
* ``cards``, over every visible card: the ``peer`` fabric (the (2,2,2)
  blocks spread over the cards in one process, as ``shared``) and the
  ``nccl`` fabric (``launch_times`` with one process per card).

Prints the ``nvidia-smi`` name and power limit, then one JSON object:
``{"card", "torch", "cuda", "L", "coefficients": {...}, "raw": {...}}``;
``--out`` writes it too. ``--cpu`` runs the same on the host at a small
L (its numbers describe the host, not a card). Exits 2 without a card
unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

from ..tune.measure import _env_pins

PHYSICS = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0, noise=0.1,
               precision="Float32")


def _sync(torch, cpu):
    if not cpu:
        torch.cuda.synchronize()


def _sim(gs, L, backend, *, dims=(1, 1, 1), devices=None, **kw):
    """A simulation of the probe's physics on ``dims`` (the kernel, the
    fused round, unless ``kw`` says otherwise), every block on the first
    card (or the host) unless ``devices`` places them."""
    settings = gs.Settings(L=L, backend=backend, **{
        **PHYSICS, "kernel_language": "CUDA", "comm_overlap": "off", **kw})
    n = dims[0] * dims[1] * dims[2]
    if devices is None:
        devices = ["cpu" if backend == "CPU" else "cuda:0"] * n
    return gs.Simulation(settings, mesh_dims=dims, devices=devices)


def _us_per_step(sim, steps, rounds):
    from ..utils.benchmark import time_sim_rounds

    return time_sim_rounds(sim, steps, rounds)["median"] * 1e6


def _device_ms(torch, fn, reps, cpu):
    """Device ms per call of ``fn`` (the profiler's device events summed),
    or the host ms per call on the CPU."""
    fn()
    _sync(torch, cpu)
    if cpu:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy == 0:
        raise RuntimeError("the profiler recorded no device event")
    return busy / 1e3 / reps


def _host_ms(torch, fn, reps, cpu):
    """Host ms per call of ``fn``, the device drained before and after."""
    fn()
    _sync(torch, cpu)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(torch, cpu)
    return (time.perf_counter() - t0) * 1e3 / reps


def _exchange_fabric(torch, sim, reps, cpu):
    """``(hop_us, link_gbps)`` of the 6n-face exchange of ``sim``'s
    blocks: host µs per face and block, and the faces' bytes over the
    exchange's device time."""
    from ..parallel import halo

    bvs = sim.model.boundaries

    def ex():
        return halo.exchange_faces(sim.blocks, bvs, sim.mesh)

    host = _host_ms(torch, ex, reps, cpu)
    dev = _device_ms(torch, ex, reps, cpu)
    faces = ex()
    nbytes = sum(f.numel() * f.element_size()
                 for per in faces for f in per if f is not None)
    n = len(sim.blocks)
    return host * 1e3 / (n * 6), nbytes / (dev * 1e-3) / 1e9


def _band_us_per_block_round(torch, gs, L, backend, steps, cpu):
    """Host µs of one block's z-band recompute per round of the (2,2,2)
    chain at depth 2 (``temporal.stitch_bands_from_frame`` timed inside
    the run). The host's time, with no synchronise around the call: the
    recompute is many small eager ops, host-bound, and the device runs
    the previous block's work meanwhile, as in the run."""
    from ..parallel import temporal

    real = temporal.stitch_bands_from_frame
    spent = [0.0, 0]

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = real(*a, **k)
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return out

    with _env_pins({"GS_FUSE": 2}):
        sim = _sim(gs, L, backend, dims=(2, 2, 2))
        sim.iterate(2)
        temporal.stitch_bands_from_frame = timed
        try:
            t0 = time.perf_counter()
            sim.iterate(steps)
            sim.block_until_ready()
            wall = time.perf_counter() - t0
        finally:
            temporal.stitch_bands_from_frame = real
    return (spent[0] * 1e6 / spent[1], tuple(sim.domain.local_shape),
            wall * 1e6 / steps)


@contextlib.contextmanager
def _model_tables(**values):
    """``parallel/icimodel``'s coefficient tables set to ``values`` (this
    run's measurements) for a calibration, restored after."""
    from ..parallel import icimodel

    saved = {k: getattr(icimodel, k) for k in values}
    try:
        for k, v in values.items():
            setattr(icimodel, k, v)
        yield icimodel
    finally:
        for k, v in saved.items():
            setattr(icimodel, k, v)


def _calibrate(coef, L, T_split, T_fused, T_k2, blocks, plain_k1=None,
               plain_k2=None):
    """The two efficiencies, fitted through the model at the point the
    probe measured, with the rest of this run's coefficients: the (8,1,1)
    x-chain at depth 2 (``project_1d``; the plain path's ``project`` at
    its cubic-equivalent side). Each is a share in [0, 1]: the fit
    (``*_fit``, which a loss beyond what the model prices takes below 0)
    clipped.

    The split round hides ``efficiency`` x its kernel pass of the raw
    exchange, so the fit is the model's split-less-fused difference at
    efficiency 0 less the measured one (per block), over that pass. The
    s-step time is linear in its efficiency: the measured difference less
    the model's at 0, over the model's change per unit."""
    fabric = coef["fabrics"]["shared"]
    tables = dict(
        FUSE_COST_RATIO={int(k): v
                         for k, v in coef["fuse_cost_ratio"].items()},
        MEASURED_US={(lang, int(side)): us
                     for lang, sides in coef["anchors_us"].items()
                     for side, us in sides.items()},
        OVERLAP_EFFICIENCY=0.0, HALO_DEPTH_EFFICIENCY={"plain": 0.0,
                                                       "cuda": 0.0})
    kw = dict(hop_us=fabric["hop_us"], link_gbps=fabric["link_gbps"],
              links=fabric["links"])

    def share(fit):
        return min(1.0, max(0.0, fit))

    with _model_tables(**tables) as m:
        base_full = m.anchor_us("cuda", L)
        base = base_full / blocks

        def chain_row(**more):
            return m.project_1d(blocks, L, 2, base_full,
                                launch_us=coef["launch_us"], **kw, **more)

        def chain(**more):
            return base / chain_row(**more)["projected_weak_scaling_eff"]

        side = round((L // blocks * L * L) ** (1 / 3))
        base_p = m.anchor_us("plain", L) / blocks

        def plain(**more):
            row = m.project(side, 2, base_p, **kw, **more)
            return base_p / row["projected_weak_scaling_eff"]

        out = {}
        split0 = chain(overlap="auto")
        raw = chain_row(overlap="auto")["comm_us_per_step_exposed"]
        fit = 0.0
        if raw > 0:  # over the split round's kernel pass
            measured = (T_split - T_fused) / blocks
            fit = (split0 - chain() - measured) / (split0 - raw)
        out["overlap_efficiency_fit"] = fit
        out["overlap_efficiency"] = share(fit)
        fits = {"cuda": (chain, T_fused, T_k2)}
        if plain_k1 is not None:
            fits["plain"] = (plain, plain_k1, plain_k2)
        out["halo_depth_efficiency_fit"] = {}
        out["halo_depth_efficiency"] = {}
        for lang, (fn, t1, t2) in fits.items():
            zero = fn() - fn(halo_depth=2)
            m.HALO_DEPTH_EFFICIENCY = {"plain": 1.0, "cuda": 1.0}
            one = fn() - fn(halo_depth=2)
            m.HALO_DEPTH_EFFICIENCY = {"plain": 0.0, "cuda": 0.0}
            fit = ((t1 - t2) / blocks - zero) / (one - zero)
            out["halo_depth_efficiency_fit"][lang] = fit
            out["halo_depth_efficiency"][lang] = share(fit)
    return out


def part_one(torch, gs, L, steps, rounds, cpu, work):
    """The one-card coefficients (see the module docstring)."""
    from ..ops import cuda_stencil

    backend = "CPU" if cpu else "CUDA"
    coef, raw = {}, {}
    sides = (L // 2, L, 2 * L)
    anchors = {"cuda": {}, "plain": {}}
    for side in sides:
        anchors["cuda"][str(side)] = _us_per_step(
            _sim(gs, side, backend), steps, rounds)
    for side in sides[:2]:
        anchors["plain"][str(side)] = _us_per_step(
            _sim(gs, side, backend, kernel_language="Plain"),
            max(2, steps // 4), rounds)
    coef["anchors_us"] = anchors

    cap = cuda_stencil.chain_cap(torch.float32)
    per_k = {}
    for k in range(1, cap + 1):
        with _env_pins({"GS_FUSE": k}):
            per_k[k] = _us_per_step(_sim(gs, L, backend), 2 * k * 5, rounds)
    raw["fuse_us_per_step"] = {str(k): v for k, v in per_k.items()}
    coef["fuse_cost_ratio"] = {str(k): v / per_k[1]
                               for k, v in per_k.items()}
    bf16 = _us_per_step(_sim(gs, L, backend,
                             compute_precision="bf16_f32acc"), steps, rounds)
    raw["bf16_us_per_step"] = bf16
    coef["bf16_compute_ratio"] = bf16 / per_k[1]

    # The 6n-face kernel on the (2,2,2) blocks against one block.
    mesh = _sim(gs, L, backend, dims=(2, 2, 2))
    one = _sim(gs, L, backend)
    from ..parallel import halo

    faces = halo.exchange_faces(mesh.blocks, mesh.model.boundaries,
                                mesh.mesh)

    def faces6():
        for r, fields in enumerate(mesh.blocks):
            cuda_stencil.fused_step(
                fields, mesh._params_of(r), mesh._seeds(0), faces[r],
                spec=mesh.spec, fuse=1, offsets=mesh.offsets[r], row=L)

    def block():
        cuda_stencil.fused_step(one.blocks[0], one.params, one._seeds(0),
                                spec=one.spec, fuse=1, row=L)

    raw["faces6_device_ms"] = _device_ms(torch, faces6, 10, cpu)
    raw["block_device_ms"] = _device_ms(torch, block, 10, cpu)
    coef["stage_ratio"] = raw["faces6_device_ms"] / raw["block_device_ms"]

    tiny = _sim(gs, 8, backend)

    def tiny_call():
        cuda_stencil.fused_step(tiny.blocks[0], tiny.params, tiny._seeds(0),
                                spec=tiny.spec, fuse=1, row=8)

    coef["launch_us"] = _host_ms(torch, tiny_call, 200, cpu) * 1e3

    hop, gbps = _exchange_fabric(torch, mesh, 20, cpu)
    coef["fabrics"] = {"shared": {"hop_us": hop, "link_gbps": gbps,
                                  "links": 6}}
    del mesh, one, faces

    band_us, local, step_us = _band_us_per_block_round(torch, gs, L,
                                                       backend, 10, cpu)
    from ..parallel import icimodel

    cells = icimodel.band_cells_per_round(local, 2)
    raw["z_band_us_per_block_round"] = band_us
    raw["z_chain_us_per_step"] = step_us
    coef["z_band_us_per_cell"] = band_us / cells

    t = {}
    with _env_pins({"GS_FUSE": 2}):
        for name, kw in (("split", dict(comm_overlap="on")),
                         ("fused", {}),
                         ("k2", dict(halo_depth=2)),
                         ("plain_k1", dict(kernel_language="Plain")),
                         ("plain_k2", dict(kernel_language="Plain",
                                           halo_depth=2))):
            t[name] = _us_per_step(_sim(gs, L, backend, dims=(8, 1, 1),
                                        **kw), 4 * 2, rounds)
    raw["x_chain_us_per_step"] = t
    cal = _calibrate(coef, L, t["split"], t["fused"], t["k2"], 8,
                     t["plain_k1"], t["plain_k2"])
    raw["overlap_efficiency_fit"] = cal.pop("overlap_efficiency_fit")
    raw["halo_depth_efficiency_fit"] = cal.pop("halo_depth_efficiency_fit")
    coef.update(cal)

    coef["fabrics"]["gloo"] = _process_fabric(L, 8, 2, cpu, work)
    return coef, raw


def _process_fabric(L, blocks, procs, cpu, work):
    """A process fabric from ``launch_times``: host µs per ppermute, and
    the bytes sent over that host time."""
    from . import launch_times

    rows = launch_times.run(L, 100, blocks, [procs], cpu,
                            tempfile.mkdtemp(dir=work))
    row = rows[-1]
    if not row["bitwise"]:
        raise RuntimeError(f"{procs} processes disagree with one: {row}")
    p2p = max(row["p2p"], key=lambda x: x["seconds"])
    return {"hop_us": p2p["seconds"] * 1e6 / max(p2p["calls"], 1),
            "link_gbps": p2p["bytes"] / max(p2p["seconds"], 1e-12) / 1e9,
            "links": 6, "backend": row["backend"],
            "ms_per_step": row["ms_per_step"],
            "one_process_ms_per_step": rows[0]["ms_per_step"]}


def part_cards(torch, gs, L, cpu, work):
    """The ``peer`` and ``nccl`` fabrics over every visible card."""
    cards = 1 if cpu else torch.cuda.device_count()
    if cards < 2 and not cpu:
        raise RuntimeError(f"the cards part needs two cards or more, "
                           f"{cards} visible")
    backend = "CPU" if cpu else "CUDA"
    devices = (["cpu"] * 8 if cpu
               else [f"cuda:{r % cards}" for r in range(8)])
    mesh = _sim(gs, L, backend, dims=(2, 2, 2), devices=devices)
    hop, gbps = _exchange_fabric(torch, mesh, 20, cpu)
    out = {"peer": {"hop_us": hop, "link_gbps": gbps, "links": 6,
                    "cards": cards}}
    del mesh
    procs = 2 if cpu else cards
    out["nccl"] = _process_fabric(L, 8, procs, cpu, work)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--l", type=int, default=None)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--parts", default="one")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    import torch

    if not a.cpu and not torch.cuda.is_available():
        print("fabric: no CUDA card (use --cpu)", file=sys.stderr)
        return 2
    import grayscott_jl_tpu_torch as gs

    L = a.l or (32 if a.cpu else 256)
    card = "cpu"
    if not a.cpu:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        print(card)
    result = {"card": card, "device": "cpu" if a.cpu else
              torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "L": L, "coefficients": {}, "raw": {}}
    work = tempfile.mkdtemp(prefix="gs_fabric_")
    parts = a.parts.split(",")
    try:
        if "one" in parts:
            coef, raw = part_one(torch, gs, L, a.steps, a.rounds, a.cpu,
                                 work)
            result["coefficients"].update(coef)
            result["raw"].update(raw)
        if "cards" in parts:
            fabrics = result["coefficients"].setdefault("fabrics", {})
            fabrics.update(part_cards(torch, gs, L, a.cpu, work))
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(result))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w", encoding="utf-8") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
