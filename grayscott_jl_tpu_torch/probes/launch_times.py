"""Time a run of several processes against one process on the same
mesh, and check that their stores agree.

    python -m grayscott_jl_tpu_torch.probes.launch_times [--cpu] [--l L]
        [--steps N] [--blocks B] [--procs P,...] [--out F.json]

The run is chip_smoke's config (b): Gray-Scott F=0.02, k=0.048, Du=0.2,
Dv=0.1, dt=1, noise 0.1, float32, plotgap 50, a checkpoint every 100
steps, on a mesh of B blocks (``GS_TPU_MESH_DIMS`` or the default
factorization). First one process holds every block, spread over the
visible cards in rank order (``cuda:r % cards``); then, for each P, P
processes of B/P blocks, started with ``launch.py``'s launch variables
(the placement rule picks their cards and backend: NCCL with a card or
more each, gloo when they share one). Every run is made twice in its
processes and the second is timed: the first builds or loads the
kernels and makes the group's connections. Each run's store must equal
the one-process store bitwise.

Prints the ``nvidia-smi`` name and power limit, then one JSON line per
run: ``processes``, ``backend`` and ``cards`` per process, ``ms_per_step``
(the slowest process's ``RunStats`` compute seconds over the steps:
device work plus launch and exchange time, the boundaries' device
synchronise included) and ``exchange_ms_per_step`` (its host seconds in
``distributed.p2p``; under NCCL the issue time, under gloo the whole
transfer), ``p2p`` and ``launches`` per process, ``bitwise``. ``--out``
writes the lines as a JSON list. ``--cpu`` runs the same on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

#: What each process of a P-process run executes: ``driver.run_once``
#: on each config in turn (its share of the blocks), each with
#: ``GS_TPU_STATS`` beside the config.
WORKER = """\
import json, os, sys
from grayscott_jl_tpu_torch import driver, launch
from grayscott_jl_tpu_torch.config.settings import get_settings
from grayscott_jl_tpu_torch.parallel import distributed

launch.die_with_parent()
distributed.ensure_started(sys.argv[1])
for cfg in json.loads(sys.argv[3]):
    os.environ["GS_TPU_STATS"] = os.path.join(os.path.dirname(cfg),
                                              "stats.json")
    distributed.reset_p2p_stats()
    driver.run_once(get_settings([cfg]), n_devices=int(sys.argv[2]))
"""

#: Runs per configuration; the last is timed.
RUNS = 2


def _config(d: str, L: int, steps: int, backend: str) -> str:
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "cfg.toml")
    keys = dict(L=L, Du=0.2, Dv=0.1, F=0.02, k=0.048, dt=1.0, noise=0.1,
                steps=steps, plotgap=50, precision="Float32",
                backend=backend, kernel_language="Pallas",
                output=os.path.join(d, "gs.bp"), checkpoint=True,
                checkpoint_freq=100,
                checkpoint_output=os.path.join(d, "ckpt.bp"))
    with open(path, "w", encoding="utf-8") as f:
        for k, v in keys.items():
            if isinstance(v, bool):
                f.write(f"{k} = {'true' if v else 'false'}\n")
            elif isinstance(v, str):
                f.write(f'{k} = "{v}"\n')
            else:
                f.write(f"{k} = {v}\n")
    return path


def _store(d: str):
    from ..io.bplite import BpReader

    with BpReader(os.path.join(d, "gs.bp")) as r:
        return [(int(r.get("step", step=i)), r.get("U", step=i),
                 r.get("V", step=i)) for i in range(r.num_steps())]


def _same(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        x[0] == y[0] and np.array_equal(x[1], y[1])
        and np.array_equal(x[2], y[2]) for x, y in zip(a, b))


def run(L: int, steps: int, blocks: int, procs, cpu: bool, work: str):
    """The rows: one process, then each entry of ``procs``."""
    import torch

    from .. import Simulation, driver, launch
    from ..config.settings import get_settings

    backend = "CPU" if cpu else "CUDA"
    cards = 0 if cpu else torch.cuda.device_count()
    env = {k: v for k, v in os.environ.items() if k != "GS_TPU_STATS"}

    def factory(settings, *, n_devices, seed):
        devices = (["cpu"] * blocks if cpu else
                   [f"cuda:{r % cards}" for r in range(blocks)])
        return Simulation(settings, seed=seed, devices=devices)

    for i in range(RUNS):
        one = os.path.join(work, f"p1_{i}")
        cfg = _config(one, L, steps, backend)
        stats = os.path.join(one, "stats.json")
        os.environ["GS_TPU_STATS"] = stats
        try:
            driver.run_once(get_settings([cfg]), sim_factory=factory)
        finally:
            del os.environ["GS_TPU_STATS"]
    with open(stats, encoding="utf-8") as f:
        st = json.load(f)
    rows = [{"processes": 1, "backend": [None], "cards": [list(range(cards))],
             "ms_per_step": st["phases_s"]["compute"] / steps * 1e3,
             "exchange_ms_per_step": None,
             "launches": [st["config"]["launches"]], "bitwise": True}]
    want = _store(one)
    for p in procs:
        if blocks % p:
            raise ValueError(f"{blocks} blocks do not split over {p} "
                             "processes")
        cfgs = [_config(os.path.join(work, f"p{p}_{i}"), L, steps, backend)
                for i in range(RUNS)]
        d = os.path.dirname(cfgs[-1])
        stats = os.path.join(d, "stats.json")
        log = os.path.join(work, f"p{p}.log")
        port = launch.free_port()
        with open(log, "w", encoding="utf-8") as f:
            workers = [subprocess.Popen(
                [sys.executable, "-c", WORKER, backend.lower(),
                 str(blocks // p), json.dumps(cfgs)], cwd=work,
                env=launch.process_env(r, p, port, env), stdout=f,
                stderr=subprocess.STDOUT) for r in range(p)]
            deadline = time.monotonic() + 600
            try:
                for proc in workers:
                    proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            finally:
                for proc in workers:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
        codes = [proc.returncode for proc in workers]
        if codes != [0] * p:
            with open(log, encoding="utf-8") as f:
                raise RuntimeError(f"{p} processes exited {codes}:\n"
                                   f"{f.read()[-4000:]}")
        ranks = []
        for r in range(p):
            with open(f"{stats}.rank{r}", encoding="utf-8") as f:
                ranks.append(json.load(f))
        rows.append({
            "processes": p,
            "backend": [x["config"]["backend"] for x in ranks],
            "cards": [x["config"]["cards"] for x in ranks],
            "ms_per_step": max(x["phases_s"]["compute"]
                               for x in ranks) / steps * 1e3,
            "exchange_ms_per_step": max(x["config"]["p2p"]["seconds"]
                                        for x in ranks) / steps * 1e3,
            "p2p": [x["config"]["p2p"] for x in ranks],
            "launches": [x["config"]["launches"] for x in ranks],
            "bitwise": _same(_store(d), want),
        })
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--l", type=int, default=256)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--procs", default="2")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    import torch

    if not a.cpu and not torch.cuda.is_available():
        print("launch_times: no CUDA card (use --cpu)", file=sys.stderr)
        return 2
    if not a.cpu:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip())
    work = tempfile.mkdtemp(prefix="gs_launch_times_")
    try:
        rows = run(a.l, a.steps, a.blocks,
                   [int(p) for p in a.procs.split(",")], a.cpu, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for row in rows:
        print(json.dumps(row))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w", encoding="utf-8") as f:
            json.dump(rows, f, indent=1)
    return 0 if all(r["bitwise"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
