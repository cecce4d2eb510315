"""One run of one cell: set-up, the measured window, then the check.

A cell is the ``workloads`` entry of ``BENCHMARK.json`` with the same
name, its data file ``workloads/<cell>.toml`` (grid side, processes,
warm-up, the limits of the check) and its configuration
``configs/<config>.toml`` (the program's settings as run, with their
source). Per-layer metrics are the readers ``metrics/<metric>.py``.
Adding a cell or a metric adds files and entries and edits none.

The window drives the program's own entry,
``grayscott_jl_tpu_torch.driver.run_once`` (the CLI's path without the
argv parse), on one simulation object the set-up built:

1. set-up: ``run_once`` of ``start_steps`` steps builds the simulation
   (kernels built or loaded) and its state is copied to the host for the
   check of the start; a timed ``run_once`` of ``warmup_steps`` gives the
   rate from which the window's ``N`` steps are sized to ``--seconds``;
2. the window: a long ``run_once``, a device copy of the state, a short
   ``run_once`` of ``end_steps`` steps, a synchronize. Both calls take a
   whole number of the program's fused rounds (its chain depth
   ``fuse``, read from the simulation the set-up built), so that no call
   ends in a shallower remainder round. The rate is all the window's
   cell updates over all its host time;
3. the check, once the peak memory is read and the simulation freed:
   the reference replays ``start_steps`` steps from its own initial
   state against the program's state after them, and the short call's
   steps from the program's state before it against the window's output
   (the gathered field, in a run of several processes). The long call's
   steps are the program's alone: their count is checked against the
   program's step counter, and the kernel launches of each kind (model,
   mode, entry point, members, depth, operand, band; load path) per step
   against the short call's, which the reference checked.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
import time
import tomllib
from typing import Dict, List, Optional

from . import devtrace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Top-level module names no process of a run may hold.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "grayscott_jl_tpu"})
#: Environment variables of the program a run keeps (the launch's).
KEEP_ENV = frozenset({"GS_TPU_COORDINATOR", "GS_TPU_NUM_PROCESSES",
                      "GS_TPU_PROCESS_ID"})
#: Seeds are taken modulo this, so that every member's key fits 32 bits.
SEED_SPAN = 2**32 - 64


@dataclasses.dataclass
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    processes: int
    L: int
    warmup_steps: int
    start_steps: int
    end_steps: int
    limits: Dict[str, float]
    settings: dict

    @property
    def on_card(self) -> bool:
        return self.settings["backend"].strip().lower() in ("cuda", "gpu")

    @property
    def members(self) -> int:
        ens = self.settings.get("ensemble")
        return len(ens["member"]) if ens else 1

    def member_rows(self) -> List[dict]:
        """Each member's Du, Dv, F, k, dt, noise, from the configuration."""
        base = {k: self.settings[k]
                for k in ("Du", "Dv", "F", "k", "dt", "noise")}
        ens = self.settings.get("ensemble")
        return [{**base, **m} for m in ens["member"]] if ens else [base]


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def _toml(path: str) -> dict:
    with open(path, "rb") as f:
        return tomllib.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` from ``BENCHMARK.json`` and its data files."""
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = _toml(os.path.join(root, "gsbench", "workloads", f"{name}.toml"))
    cfg = _toml(os.path.join(root, "gsbench", "configs",
                             f"{entry['config']}.toml"))
    for key in ("config", "traffic"):
        if wl[key] != entry[key]:
            raise ValueError(f"workloads/{name}.toml has {key} = "
                             f"{wl[key]!r}, BENCHMARK.json {entry[key]!r}")
    return Cell(name=name, config=entry["config"], traffic=entry["traffic"],
                chips=int(entry["chips"]), processes=int(wl["processes"]),
                L=int(wl["L"]), warmup_steps=int(wl["warmup_steps"]),
                start_steps=int(wl["start_steps"]),
                end_steps=int(wl["end_steps"]),
                limits={k: float(v) for k, v in wl["limits"].items()},
                settings=dict(cfg["settings"]))


@dataclasses.dataclass
class Reader:
    name: str
    unit: str
    layer: str
    moves: str
    workloads: Optional[List[str]]
    read: object


def load_readers(root: str = ROOT) -> List[Reader]:
    """The per-layer metrics of ``BENCHMARK.json``, each with the reader
    of ``metrics/<name>.py``; the file's ``UNIT``, ``LAYER`` and ``MOVES``
    must agree with the entry."""
    out = []
    for m in load_benchmark(root)["per_layer"]:
        path = os.path.join(root, "gsbench", "metrics", f"{m['name']}.py")
        spec = importlib.util.spec_from_file_location(
            f"gsbench_metric_{m['name'].replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for key, attr in (("unit", "UNIT"), ("layer", "LAYER"),
                          ("moves", "MOVES")):
            if getattr(mod, attr) != m[key]:
                raise ValueError(f"metrics/{m['name']}.py {attr} = "
                                 f"{getattr(mod, attr)!r}, BENCHMARK.json "
                                 f"{m[key]!r}")
        out.append(Reader(m["name"], m["unit"], m["layer"], m["moves"],
                          m.get("workloads"), mod.read))
    return out


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, list):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"cannot write {v!r} to TOML")


def settings_toml(settings: dict) -> str:
    """The program's settings file for ``settings`` (scalars, then an
    ``[ensemble]`` table with its ``[[ensemble.member]]`` tables)."""
    lines = [f"{k} = {_toml_value(v)}" for k, v in settings.items()
             if not isinstance(v, dict)]
    ens = settings.get("ensemble")
    if ens:
        lines.append("[ensemble]")
        lines += [f"{k} = {_toml_value(v)}" for k, v in ens.items()
                  if k != "member"]
        for m in ens.get("member", []):
            lines.append("[[ensemble.member]]")
            lines += [f"{k} = {_toml_value(v)}" for k, v in m.items()]
    return "\n".join(lines) + "\n"


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & FORBIDDEN)


def scrub_env() -> None:
    """Drop the program's knobs from the environment (a cell states its
    settings in its files), keeping a launch's own variables."""
    for var in list(os.environ):
        if var.startswith("GS_") and var not in KEEP_ENV:
            del os.environ[var]


def mark_setup(marks: list, name: str) -> None:
    """Close the set-up phase ``name`` at this instant (epoch seconds)."""
    marks.append([name, time.time()])


class Rank:
    """One process of a run: the program's simulation on this process's
    card(s), driven through ``run_once``. ``marks`` collects the set-up's
    phase edges."""

    def __init__(self, cell: Cell, workdir: str, marks: list):
        import torch

        from grayscott_jl_tpu_torch import driver
        from grayscott_jl_tpu_torch.config.settings import parse_settings_toml
        from grayscott_jl_tpu_torch.ops import cuda_stencil
        from grayscott_jl_tpu_torch.parallel import distributed

        self.torch, self.driver = torch, driver
        self.cuda_stencil, self.distributed = cuda_stencil, distributed
        self.parse = parse_settings_toml
        self.cell, self.workdir, self.cuda = cell, workdir, cell.on_card
        self.marks = marks
        mark_setup(marks, "import_program")
        if self.cuda:
            torch.zeros(1, device="cuda")
        distributed.ensure_started("cuda" if self.cuda else "cpu")
        self.rank = distributed.process_index()
        self.world = distributed.process_count()
        mark_setup(marks, "cuda_init_and_group")

    # ------------------------------------------------------------ helpers

    def settings(self, steps: int):
        s = dict(self.cell.settings)
        s.update(L=self.cell.L, steps=int(steps), plotgap=0,
                 checkpoint=False,
                 output=os.path.join(self.workdir, "gs.bp"))
        return self.parse(settings_toml(s))

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def barrier(self) -> None:
        if self.world > 1:
            self.torch.distributed.barrier()

    def stats_to(self, name: str) -> str:
        """Have the next ``run_once`` write its ``RunStats`` summary under
        ``name``; the path it will write."""
        path = os.path.join(self.workdir, name)
        os.environ["GS_TPU_STATS"] = path
        return path + (f".rank{self.rank}" if self.world > 1 else "")

    @staticmethod
    def stats(path: str) -> dict:
        with open(path, encoding="utf-8") as f:
            return json.load(f)

    def state(self, sim, *, to_host=False, clone=False):
        """This process's blocks: ``[(offset, (u, v))]``, each field with
        a member axis in front."""
        out = []
        for offs, fields in zip(sim.offsets, sim.blocks):
            fs = tuple(f if sim.is_ensemble else f.unsqueeze(0)
                       for f in fields)
            if to_host:
                fs = tuple(f.to("cpu") for f in fs)
            elif clone:
                fs = tuple(f.clone() for f in fs)
            out.append((tuple(int(o) for o in offs), fs))
        return out

    def gather(self, blocks):
        """The whole field ``(u, v)``, ``(members, L, L, L)`` on this
        process's device, on process 0 (None elsewhere)."""
        torch = self.torch
        dev = torch.device("cuda") if self.cuda else torch.device("cpu")
        L, M = self.cell.L, self.cell.members
        if self.world > 1:
            dist = torch.distributed
            meta = [None] * self.world
            dist.all_gather_object(
                meta, [(o, tuple(f[0].shape)) for o, f in blocks])
        else:
            meta = [[(o, tuple(f[0].shape)) for o, f in blocks]]
        whole = None
        if self.rank == 0:
            whole = tuple(torch.empty((M, L, L, L), dtype=torch.float32,
                                      device=dev) for _ in range(2))
        for r, blocks_r in enumerate(meta):
            for i, (offs, shape) in enumerate(blocks_r):
                if r == self.rank:
                    fields = tuple(f.to(dev) for f in blocks[i][1])
                elif self.rank == 0:
                    fields = tuple(torch.empty(shape, dtype=torch.float32,
                                               device=dev) for _ in range(2))
                    for f in fields:
                        torch.distributed.recv(f, src=r)
                else:
                    continue
                if self.rank == 0:
                    box = (slice(None),) + tuple(
                        slice(o, min(o + n, L))
                        for o, n in zip(offs, shape[1:]))
                    for w, f in zip(whole, fields):
                        w[box] = f[(slice(None),) + tuple(
                            slice(0, b.stop - b.start) for b in box[1:])]
                else:
                    for f in fields:
                        torch.distributed.send(f.float().contiguous(), dst=0)
        return whole

    # --------------------------------------------------------------- run

    def run(self, seed: int, seconds: float, trace: bool,
            control: bool = False) -> dict:
        """One measured window from ``seed``; this process's readings."""
        torch, driver, cs = self.torch, self.driver, self.cuda_stencil
        cell = self.cell
        key_seed = int(seed) % SEED_SPAN
        k0, w = cell.start_steps, cell.warmup_steps
        # One block a process, on its own card: the program's default,
        # one block per visible card, would spread a one-card cell over
        # every card of a larger machine.
        sim = driver.run_once(self.settings(k0), n_devices=1, seed=key_seed)
        self.sync()
        mark_setup(self.marks, "first_run_once")
        start = self.state(sim, to_host=True)
        mark_setup(self.marks, "start_state_to_host")
        fuse = int(sim.fuse)
        k = -(-cell.end_steps // fuse) * fuse

        def same(*_a, **_kw):
            return sim

        self.barrier()
        self.sync()
        t = time.perf_counter()
        driver.run_once(self.settings(w), n_devices=1, seed=key_seed,
                        sim_factory=same)
        self.sync()
        self.barrier()
        rate = w / (time.perf_counter() - t)
        n_long = max(fuse, int(round(rate * seconds - k)) // fuse * fuse)
        if self.world > 1:
            box = [n_long]
            torch.distributed.broadcast_object_list(box, src=0)
            n_long = int(box[0])
        n = n_long + k
        mark_setup(self.marks, "warmup_run_once")

        cs.reset_launches()
        p2p0 = (self.distributed.p2p_stats() or {}).get("seconds", 0.0)
        prof = None
        if trace and self.cuda:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()

        def mark(name):
            return (torch.profiler.record_function(name)
                    if prof is not None else contextlib.nullcontext())

        stats1, stats2 = self.stats_to("window1.json"), None
        kinds0 = launch_kinds(cs)
        self.barrier()
        self.sync()
        mark_setup(self.marks, "window_start")
        t0_epoch = time.time()
        t0 = time.perf_counter()
        with mark(devtrace.WINDOW):
            with mark("gsbench.run_once"):
                driver.run_once(self.settings(n_long), n_devices=1,
                                seed=key_seed, sim_factory=same)
            peak = (torch.cuda.max_memory_allocated() if self.cuda else 0)
            with mark("gsbench.state_copy"):
                before_end = self.state(sim, clone=True)
                kinds1 = launch_kinds(cs)
            stats2 = self.stats_to("window2.json")
            with mark("gsbench.run_once"):
                driver.run_once(self.settings(k), n_devices=1,
                                seed=key_seed, sim_factory=same)
            self.sync()
        elapsed = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        os.environ.pop("GS_TPU_STATS", None)
        st1, st2 = self.stats(stats1), self.stats(stats2)
        kinds2 = launch_kinds(cs)
        launches = cs.LAUNCHES
        modes = {m: v for m, v in cs.MODE_LAUNCHES.items() if v}
        members = max([v for v in cs.MODE_MEMBERS.values() if v] or [0])
        p2p = (self.distributed.p2p_stats() or {}).get("seconds", 0.0) - p2p0
        out = {
            "rank": self.rank,
            "seed": int(seed),
            "steps": n,
            "elapsed_s": elapsed,
            "t0_epoch": t0_epoch,
            "memory_peak_bytes": int(peak),
            "launches": launches,
            "modes": modes,
            "members_per_launch": members or None,
            "p2p_s": p2p if self.world > 1 else None,
            "stats_wall_s": st1["wall_s"] + st2["wall_s"],
            "stats_compute_s": (st1["phases_s"].get("compute", 0.0)
                                + st2["phases_s"].get("compute", 0.0)),
            "local_shape": [int(x) for x in sim.domain.local_shape],
            "blocks": int(sim.mesh.n_blocks),
            "fuse": fuse,
            "mesh_dims": list(sim.domain.dims),
            "program_step": int(sim.step),
            "device_kind": (torch.cuda.get_device_name() if self.cuda
                            else "cpu"),
            "setup_marks": list(self.marks),
            "trace": None,
        }
        if prof is not None:
            out["trace"] = devtrace.summarize(prof)
            del prof
        end = self.state(sim)
        del sim
        if self.cuda:
            torch.cuda.empty_cache()
        mix_gap = launch_mix_gap(kinds0, kinds1, kinds2, n_long, k)
        out["checks"] = self.check(start, before_end, end, key_seed,
                                   t_end=k0 + w + n_long, end_steps=k,
                                   steps=n, program_step=out["program_step"],
                                   launch_mix_gap=mix_gap, control=control)
        out["forbidden"] = forbidden_modules()
        return out

    def check(self, start, before_end, end, key_seed: int, *, t_end: int,
              end_steps: int, steps: int, program_step: int,
              launch_mix_gap: float, control: bool) -> dict:
        """The compared numbers (process 0; ``{}`` elsewhere): each gap
        of the program from the reference, and with ``control`` the same
        gaps of the reference computed in bfloat16 in its place."""
        from . import reference as ref

        torch = self.torch
        cell = self.cell
        rows, M = cell.member_rows(), cell.members
        keys = [(0, key_seed + m) for m in range(M)]
        checks = {}
        # Gathered and judged one stage at a time, so that process 0
        # holds at most two whole fields of the program's beside the
        # reference's (8 GiB a field at L = 1024).
        prog_start = self.gather(start)
        del start
        if self.rank == 0:
            init = ref.initial_state(cell.L, M, device=prog_start[0].device)
            want = ref.advance(init, rows, keys, 0, cell.start_steps)
            checks["start_max_abs"] = ref.max_abs_gap(prog_start, want)
            del prog_start
            if control:
                low = ref.advance(init, rows, keys, 0, cell.start_steps,
                                  dtype=torch.bfloat16)
                checks["start_max_abs_control"] = ref.max_abs_gap(low, want)
                del low
            del init, want
        prog_before = self.gather(before_end)
        del before_end
        prog_end = self.gather(end)
        del end
        if self.rank != 0:
            return {}
        want = ref.advance(prog_before, rows, keys, t_end, end_steps)
        checks["end_max_abs"] = ref.max_abs_gap(prog_end, want)
        del prog_end
        if control:
            low = ref.advance(prog_before, rows, keys, t_end, end_steps,
                              dtype=torch.bfloat16)
            checks["end_max_abs_control"] = ref.max_abs_gap(low, want)
        expected = cell.start_steps + cell.warmup_steps + steps
        checks["step_count_gap"] = float(abs(program_step - expected))
        checks["launch_mix_gap"] = launch_mix_gap
        return checks


def launch_kinds(cs) -> Dict[tuple, int]:
    """The program's kernel launches so far, by kind: each entry of
    ``cuda_stencil.ENTRY_LAUNCHES`` and each load path."""
    kinds = {("entry",) + key: v for key, v in cs.ENTRY_LAUNCHES.items()}
    kinds.update({("load", p): v for p, v in cs.LOAD_PATH_LAUNCHES.items()})
    return kinds


def launch_mix_gap(k0: dict, k1: dict, k2: dict, long_steps: int,
                   short_steps: int) -> float:
    """The largest gap, over the kinds of launch, between the long
    call's launches per step (from ``k0`` to ``k1``) and the short
    call's (from ``k1`` to ``k2``). Exactly 0 where both calls launch
    the same kernels per step."""
    gap = 0.0
    for kind in set(k0) | set(k1) | set(k2):
        a = k1.get(kind, 0) - k0.get(kind, 0)
        b = k2.get(kind, 0) - k1.get(kind, 0)
        gap = max(gap, abs(a / long_steps - b / short_steps))
    return gap


def limits_of(cell: Cell) -> Dict[str, float]:
    """Each compared number's limit: the cell's, and 0 for the step
    count and the launches per step."""
    return {"start_max_abs": cell.limits["start_max_abs"],
            "end_max_abs": cell.limits["end_max_abs"],
            "step_count_gap": 0.0,
            "launch_mix_gap": 0.0}


def judge(checks: dict, cell: Cell) -> bool:
    lim = limits_of(cell)
    return all(name in checks and checks[name] <= lim[name] for name in lim)
