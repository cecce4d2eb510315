"""Chaos scenarios of the resilience layer (counterpart of
``scripts/chaos_smoke.sh``, for the scenarios whose modules the port
has)::

    python -m grayscott_jl_tpu_torch.chaos [--backend CUDA|CPU] [--L 32]
        [--steps 60] [--seed N] [--scenarios 1,2,...,11] [--workdir DIR]

Each scenario runs a supervised run that a fault interrupts and holds
its stores, byte for byte, against an uninterrupted run of the same
settings (faults change when a run computes, never what it writes):

1. a preemption at a pseudo-random step (``--seed``), with every
   observability sink armed (``GS_EVENTS``, ``GS_METRICS``,
   ``GS_TRACE``); the event stream must carry the injected fault;
2. a driver hang at a pseudo-random step: the watchdog expires
   (``GS_WATCHDOG_STEP_ROUND_S=1``), the stack dump lands in the
   journal, the supervisor restarts;
3. a real SIGTERM to the CLI in a subprocess after its first
   checkpoint: exit 75, then a supervised relaunch resumes from the
   journal's ``graceful_shutdown`` marker (the output stores are
   compared; the checkpoint store holds the extra grace entry);
4. an ensemble (``[ensemble] presets = ["spots", "chaos"]``) preempted
   mid-sweep: the supervised restart resumes every member from the
   member stores' quorum step, and every member-indexed store
   (``gs.m00.bp``, ``gs.m00.vtk``, ``ckpt.m00.bp``, ...) equals the
   uninterrupted ensemble's byte for byte;
5. elastic resharding, the solo half: a supervised (2,2,2) run in a
   subprocess stalled at its step-20 boundary gets SIGTERM (exit 75),
   and the supervised relaunch on a (1,2,2) mesh resumes from the
   journal's marker across the shape change, with a ``reshard`` event
   on ``GS_EVENTS``; every store serves the uninterrupted (2,2,2) run's
   values (the assembled arrays of the ``.bp`` stores bitwise, whose
   blocks follow the mesh that wrote each step, and the ``.vtk`` series
   byte for byte). Both meshes are placed over the usable devices, a
   device holding several blocks where there are fewer (one card holds
   the whole mesh). The ensemble half: scenario 4's ensemble preempted
   unsupervised, then resumed GROWN to three members
   (``restart = true``): the two old members' stores equal the
   uninterrupted ensemble's, and the grown member writes its own;
6. serving (``serve/``): three jobs packed onto one batch of 4 slots in
   an in-process service; ``GS_SERVE_CHAOS`` kills the worker mid-batch,
   the scheduler requeues the batch, the relaunch resumes from the
   member-store checkpoint quorum, and every member store (``gs``,
   ``.vtk``, ``ckpt``) equals an uninterrupted service's byte for byte;
   the stream (``job_*`` kinds included) passes ``obs/report --check``;
7. a corrupted byte in the primary checkpoint store, then a preemption:
   the restore fails over to the ``.r1`` replica; the output stores and
   the replica equal the uninterrupted run's;
8. lossy output (``GS_SNAPSHOT_BITS=8``) preempted and resumed from its
   exact checkpoint;
9. the serving fleet: two front-door processes and two worker processes
   (``python -m grayscott_jl_tpu_torch.serve``) share one
   ``GS_SERVE_FLEET_DIR``; one front door and the worker holding a batch
   lease are SIGKILLed mid-batch, the surviving front door's reaper
   expires the lease and the surviving worker adopts the batch; every
   accepted job completes, a repeated spec is a ``cache="hit"`` with a
   byte-identical store, and the merged multi-rank stream passes
   ``--check`` with ``worker_lost``, ``job_failover`` and ``cache_hit``;
10. live reshapes in the fleet: one front door and two workers, two
    running batches; one is moved live through the ``reshape/<batch>``
    relay onto (2,2,2) and then (1,2,2) (``mesh_dims`` requests: the
    driver refuses ``scale`` hints the usable devices cannot hold, and
    one card or the CPU holds one), while the other's worker is
    SIGKILLed the moment its own request lands (the reaper drops the
    orphaned request, the survivor resumes the batch); every store
    equals an uninterrupted no-reshape service run's: ``.vtk`` series
    byte for byte, ``.bp`` stores by value (:func:`values_equal`; their
    blocks follow the mesh that wrote each step);
11. a flipped mantissa bit in a live cell under ``GS_SDC_CHECK=spot``:
    the screen catches it, attributes it to the device and block, the
    run restarts from the last verified checkpoint; a second flip on the
    same device quarantines it, and with no device left the supervisor
    gives up ("every device quarantined").

Exit code 0 when every scenario held, 1 otherwise; one JSON line per
scenario on stdout. The runs are in-process except scenario 3's and 5's
signalled children and the fleets of 9 and 10 (and in those, the
uninterrupted service run). A batch in 9 and 10 stalls at its step-10
and step-30 boundaries (a ``hang`` fault bounded at 2 s, which changes
when a run computes, never what), so that the kills and requests land
mid-batch. They run on the card (``--backend CUDA``, the default) unless
``--backend CPU`` asks for the host.
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

SCENARIOS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11)

#: The ensemble of scenarios 4 and 5 (grown by ``GROWN`` in 5).
PRESETS = ("spots", "chaos")
GROWN = ("spots", "chaos", "waves")

#: Supervision settings shared by every supervised run.
SUPERVISED = {"GS_SUPERVISE": "1", "GS_MAX_RESTARTS": "5",
              "GS_RESTART_BACKOFF_S": "0"}

#: Variables a scenario sets; cleared around each run.
_VARS = ("GS_SUPERVISE", "GS_MAX_RESTARTS", "GS_RESTART_BACKOFF_S",
         "GS_FAULTS", "GS_FAULT_JOURNAL", "GS_EVENTS", "GS_METRICS",
         "GS_TRACE", "GS_WATCHDOG", "GS_WATCHDOG_STEP_ROUND_S",
         "GS_CKPT_REPLICAS", "GS_CKPT_VERIFY", "GS_ASYNC_IO_DEPTH",
         "GS_SNAPSHOT_BITS", "GS_SDC_CHECK", "GS_SDC_EVERY",
         "GS_DEVICE_BLOCKLIST", "GS_FAULT_DEVICE", "GS_TPU_STATS",
         "GS_SERVE_FLEET_DIR", "GS_SERVE_CHAOS", "GS_HANG_BOUND_S")


def write_config(d: str, *, backend: str, L: int, steps: int,
                 presets=None, **extra) -> str:
    """``d/config.toml``: plotgap 10, a checkpoint every 20 steps; with
    ``presets``, an ``[ensemble]`` of them."""
    os.makedirs(d, exist_ok=True)
    kw = dict(L=L, Du=0.2, Dv=0.1, F=0.02, k=0.048, dt=1.0, noise=0.1,
              steps=steps, plotgap=10, checkpoint=True, checkpoint_freq=20,
              output=os.path.join(d, "gs.bp"),
              checkpoint_output=os.path.join(d, "ckpt.bp"),
              precision="Float32", backend=backend)
    kw.update(extra)
    lines = []
    for key, value in kw.items():
        if isinstance(value, bool):
            lines.append(f"{key} = {'true' if value else 'false'}")
        elif isinstance(value, str):
            lines.append(f'{key} = "{value}"')
        else:
            lines.append(f"{key} = {value}")
    if presets:
        lines += ["", "[ensemble]",
                  "presets = [" + ", ".join(f'"{p}"' for p in presets) + "]"]
    path = os.path.join(d, "config.toml")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return path


@contextlib.contextmanager
def environment(env: Dict[str, str]):
    """``env`` set (and every other scenario variable unset) for the
    block, the process-wide sinks re-read from it; restored after."""
    from .obs import events, metrics, trace

    saved = {k: os.environ.get(k) for k in set(_VARS) | set(env)}
    for k in _VARS:
        os.environ.pop(k, None)
    os.environ.update(env)
    for reset in (events.reset_events, metrics.reset_metrics,
                  trace.reset_tracer):
        reset()
    try:
        yield
    finally:
        for reset in (events.reset_events, metrics.reset_metrics,
                      trace.reset_tracer):
            reset()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run(cfg: str, env: Dict[str, str], dims=None):
    """``driver.main([cfg])`` under ``env`` (on a ``dims`` mesh when
    given: :func:`mesh_main`); the exception it raised, or None."""
    from . import driver

    with environment(env):
        try:
            if dims is None:
                driver.main([cfg])
            else:
                mesh_main(cfg, dims)
        except Exception as e:  # noqa: BLE001 — the scenario judges it
            return e
    return None


def mesh_main(cfg: str, dims):
    """``driver.main([cfg])`` on a ``dims`` mesh placed over the usable
    devices of the settings' backend, several blocks to a device where
    there are fewer (one card holds a whole mesh)."""
    from . import driver
    from .config.settings import get_settings, resolve_device
    from .reshard.restore import placement
    from .resilience import sdc
    from .resilience.supervisor import supervise, supervision_enabled
    from .simulation import Simulation

    settings = get_settings([cfg])
    devices = placement(sdc.usable_devices(resolve_device(settings).type),
                        dims[0] * dims[1] * dims[2])

    def factory(s, *, n_devices, seed):
        return Simulation(s, seed=seed, mesh_dims=dims, devices=devices)

    if supervision_enabled(settings):
        return supervise(settings, sim_factory=factory)
    return driver.run_once(settings, sim_factory=factory)


#: Scenario 5's signalled process: :func:`mesh_main` on ``argv[2]``'s
#: mesh, exiting as the CLI does (75 after a shutdown request).
MESH_CHILD = (
    "import sys; from grayscott_jl_tpu_torch import chaos; "
    "sys.exit(chaos.mesh_cli(sys.argv[1], sys.argv[2]))"
)


def mesh_cli(cfg: str, dims: str) -> int:
    import traceback

    from .resilience.faults import EXIT_PREEMPTED, GracefulShutdown

    try:
        mesh_main(cfg, tuple(int(x) for x in dims.split(",")))
    except GracefulShutdown as e:
        print(f"chaos: {e}; exiting {EXIT_PREEMPTED}", file=sys.stderr)
        return EXIT_PREEMPTED
    except Exception:  # noqa: BLE001 — the exit code is the product
        traceback.print_exc()
        return 1
    return 0


def journal(d: str) -> List[dict]:
    path = os.path.join(d, "gs.bp.faults.jsonl")
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def values_equal(a: str, b: str) -> List[str]:
    """The steps and variables whose assembled arrays differ between two
    stores (or that one store lacks), and differing attributes: a store
    that changed mesh mid-life frames its blocks differently but must
    serve the same values."""
    import numpy as np

    from .io import open_reader

    try:
        ra, rb = open_reader(a), open_reader(b)
    except (FileNotFoundError, OSError, RuntimeError) as e:
        return [f"{a} or {b} is unreadable ({e})"]
    with ra, rb:
        # The ADIOS2 reader hands list attributes back as arrays.
        attrs = [{k: v.tolist() if isinstance(v, np.ndarray) else v
                  for k, v in r.attributes().items()} for r in (ra, rb)]
        bad = [] if attrs[0] == attrs[1] else ["attributes"]
        if ra.num_steps() != rb.num_steps():
            return bad + [f"{ra.num_steps()} != {rb.num_steps()} steps"]
        names = sorted(ra.available_variables())
        if names != sorted(rb.available_variables()):
            return bad + ["variables"]
        for i in range(ra.num_steps()):
            for name in names:
                x, y = (np.asarray(r.get(name, step=i)) for r in (ra, rb))
                if x.dtype != y.dtype or x.tobytes() != y.tobytes():
                    bad.append(f"{name} at step index {i}")
    return bad


def trees_equal(a: str, b: str) -> List[str]:
    """The files that differ (or exist on one side only) between two
    store trees."""
    bad: List[str] = []

    def walk(cmp: filecmp.dircmp, rel: str) -> None:
        bad.extend(os.path.join(rel, n) for n in
                   cmp.left_only + cmp.right_only + cmp.funny_files)
        for name in cmp.common_files:
            if not filecmp.cmp(os.path.join(cmp.left, name),
                               os.path.join(cmp.right, name), shallow=False):
                bad.append(os.path.join(rel, name))
        for name, sub in cmp.subdirs.items():
            walk(sub, os.path.join(rel, name))

    if not (os.path.isdir(a) and os.path.isdir(b)):
        return [f"{a} or {b} is missing"]
    walk(filecmp.dircmp(a, b), "")
    return bad


# ------------------------------------------------------------- serving


def post(base: str, path: str, payload) -> dict:
    """POST ``payload`` as JSON to the service at ``base``; the reply."""
    import urllib.request

    req = urllib.request.Request(base + path,
                                 data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def get(base: str, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(base + path, timeout=60) as r:
        return json.loads(r.read())


def wait_terminal(base: str, jobs: List[str], timeout: float = 600
                  ) -> List[dict]:
    """The jobs' records once every one is terminal (or the last read
    at the deadline)."""
    deadline = time.monotonic() + timeout
    records: List[dict] = []
    while time.monotonic() < deadline:
        records = [get(base, f"/v1/jobs/{j}") for j in jobs]
        if all(r["state"] in ("complete", "failed", "cancelled")
               for r in records):
            break
        time.sleep(0.2)
    return records


def member_trees(store: str) -> Dict[str, str]:
    """A job's member stores by kind, from its output store's path."""
    return {"gs": store, "vtk": store[:-len(".bp")] + ".vtk",
            "ckpt": os.path.join(os.path.dirname(store),
                                 "ckpt" + os.path.basename(store)[2:])}


#: Fleet timing of scenarios 9 and 10 (seconds): a lease outlives six
#: missed heartbeats.
FLEET_ENV = {"GS_SERVE_LEASE_TTL_S": "3.0", "GS_SERVE_HEARTBEAT_S": "0.5",
             "GS_SERVE_PACK_MAX": "2", "GS_SERVE_PACK_WINDOW_S": "0.1",
             "GS_SERVE_SUPERVISE": "0"}

#: The stalls that keep a fleet batch running while a scenario acts on
#: it (module docstring).
FLEET_STALLS = {"GS_FAULTS": "step=10:kind=hang;step=30:kind=hang",
                "GS_HANG_BOUND_S": "2"}


class Fleet:
    """Serve processes sharing one fleet directory (scenarios 9, 10)."""

    def __init__(self, workdir: str, backend: str):
        from .serve.cluster import FleetKV

        self.workdir = workdir
        self.backend = backend
        self.fleet_dir = os.path.join(workdir, "fleet")
        self.events = os.path.join(workdir, "events.jsonl")
        self.kv = FleetKV(self.fleet_dir)
        self.procs: List[subprocess.Popen] = []

    def start(self, rank: int, role: str, extra=None) -> None:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = {k: v for k, v in os.environ.items()
               if k not in _VARS and not k.startswith("GS_SERVE_")}
        env.update(FLEET_ENV)
        env.update(extra or {})
        env.update({
            "GS_SERVE_FLEET_DIR": self.fleet_dir,
            "GS_SERVE_FLEET_RANK": str(rank),
            "GS_SERVE_PORT": "0",
            "GS_SERVE_WORKERS": "1" if role == "worker" else "0",
            "GS_SERVE_STATE_DIR": os.path.join(self.workdir,
                                               f"state{rank}"),
            "GS_EVENTS": self.events,
        })
        env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
        cmd = [sys.executable, "-m", "grayscott_jl_tpu_torch.serve",
               "--backend", self.backend, "--role", role]
        log = open(os.path.join(self.workdir, f"member{rank}.log"), "w")
        with log:
            self.procs.append(subprocess.Popen(
                cmd, env=env, cwd=self.workdir, stdout=log,
                stderr=subprocess.STDOUT))

    def frontdoors(self, n: int, timeout: float = 120) -> List[tuple]:
        """``(base URL, pid)`` of the ``n`` front doors, once announced."""
        found: Dict[str, tuple] = {}
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and len(found) < n:
            for mid in self.kv.keys("members"):
                doc = self.kv.get(f"members/{mid}")
                if doc and doc.get("role") == "frontdoor" and doc.get(
                        "port"):
                    found[mid] = (f"http://{doc['host']}:{doc['port']}",
                                  doc["pid"])
            time.sleep(0.1)
        if len(found) < n:
            raise RuntimeError(f"{n} front doors never announced: {found}"
                               f"; logs in {self.workdir}")
        return sorted(found.values())

    def leases(self, n: int, timeout: float = 180) -> Dict[str, int]:
        """``{batch: worker pid}`` once ``n`` batches are leased."""
        held: Dict[str, int] = {}
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and len(held) < n:
            for bid in self.kv.keys("leases"):
                lease = self.kv.get(f"leases/{bid}")
                mdoc = lease and self.kv.get(f"members/{lease['worker']}")
                if mdoc:
                    held[bid] = mdoc["pid"]
            time.sleep(0.05)
        if len(held) < n:
            raise RuntimeError(f"{n} leases never taken: {held}")
        return held

    def steer(self, batch: str, req: dict, wait: bool = True,
              timeout: float = 120) -> None:
        """Post ``req`` through the relay (the document
        ``ClusterScheduler.request_reshape`` writes); with ``wait``,
        until the leasing worker consumed it."""
        self.kv.put(f"reshape/{batch}", {"batch": batch, "req": req,
                                         "by": "chaos", "t": time.time()})
        if not wait:
            return
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.kv.get(f"reshape/{batch}") is None:
                return
            time.sleep(0.02)
        raise RuntimeError(f"{req} for {batch} was never consumed")

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in self.procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


class Chaos:
    def __init__(self, backend: str, L: int, steps: int, seed: int,
                 workdir: str):
        self.backend = backend
        self.L = L
        self.steps = steps
        self.rng = random.Random(seed)
        self.workdir = workdir
        self.bases: Dict[tuple, str] = {}

    def config(self, name: str, **extra) -> str:
        return write_config(os.path.join(self.workdir, name),
                            backend=self.backend, L=self.L, steps=self.steps,
                            **extra)

    def base(self, env: Optional[Dict[str, str]] = None, dims=None,
             **extra) -> str:
        """The uninterrupted run under ``env`` and ``extra`` settings, on
        a ``dims`` mesh when given (run once)."""
        key = (tuple(sorted((env or {}).items())),
               tuple(sorted(extra.items())), dims)
        if key not in self.bases:
            name = f"base{len(self.bases)}"
            err = run(self.config(name, **extra), dict(env or {}), dims)
            if err is not None:
                raise RuntimeError(f"uninterrupted run failed: {err!r}")
            self.bases[key] = os.path.join(self.workdir, name)
        return self.bases[key]

    def member_stores(self, n: int) -> tuple:
        """The member-indexed stores of an ``n``-member ensemble."""
        from .ensemble.io import member_tag

        return tuple(f"{name}.{member_tag(i, n)}.{ext}" for i in range(n)
                     for name, ext in (("gs", "bp"), ("gs", "vtk"),
                                       ("ckpt", "bp")))

    def random_step(self) -> int:
        """A step strictly inside the run, off the boundaries."""
        return self.rng.randrange(21, self.steps - 5)

    def check_stores(self, base: str, d: str,
                     stores=("gs.bp", "gs.vtk", "ckpt.bp")) -> List[str]:
        return [f"{s}/{f}" for s in stores
                for f in trees_equal(os.path.join(base, s),
                                     os.path.join(d, s))]

    # ---------------------------------------------------------- scenarios

    def scenario_1(self) -> dict:
        step = self.random_step()
        base = self.base()
        d = os.path.join(self.workdir, "s1")
        cfg = self.config("s1")
        err = run(cfg, {**SUPERVISED, "GS_FAULTS": f"step={step}:kind=preempt",
                        "GS_EVENTS": os.path.join(d, "events.jsonl"),
                        "GS_METRICS": os.path.join(d, "metrics.jsonl"),
                        "GS_TRACE": os.path.join(d, "trace.json")})
        from .obs.events import parse_events

        kinds = [(e["kind"], e.get("attrs", {}).get("fault"))
                 for e in parse_events(os.path.join(d, "events.jsonl"))]
        problems = self.check_stores(base, d)
        if ("injected", "preempt") not in kinds:
            problems.append("the event stream has no injected preempt")
        if ("recovery", "preemption") not in kinds:
            problems.append("the event stream has no preemption recovery")
        return self.verdict(1, err, problems, d, step=step)

    def scenario_2(self) -> dict:
        step = self.random_step()
        base = self.base()
        d = os.path.join(self.workdir, "s2")
        err = run(self.config("s2"), {
            **SUPERVISED, "GS_FAULTS": f"step={step}:kind=hang",
            "GS_WATCHDOG_STEP_ROUND_S": "1"})
        problems = self.check_stores(base, d)
        hangs = [e for e in journal(d) if e["event"] == "hang"]
        if not hangs or not hangs[0].get("threads"):
            problems.append("no hang record with a stack dump")
        if not any(e["event"] == "recovery" and e["kind"] == "hang"
                   for e in journal(d)):
            problems.append("no hang recovery")
        return self.verdict(2, err, problems, d, step=step)

    def scenario_3(self) -> dict:
        base = self.base()
        d = os.path.join(self.workdir, "s3")
        cfg = self.config("s3")
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = {k: v for k, v in os.environ.items() if k not in _VARS}
        env.update(SUPERVISED)
        env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
        cmd = [sys.executable, "-m", "grayscott_jl_tpu_torch", cfg]
        # The signal lands mid-run: the plan's hang stalls the step-20
        # boundary (no watchdog armed: the stall ends on the signal, and
        # the trajectory is unchanged).
        env.update({"GS_FAULTS": "step=20:kind=hang", "GS_WATCHDOG": "off",
                    "GS_HANG_BOUND_S": "30"})
        problems = []
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        # The stall's journal record: the step-20 checkpoint's boundary
        # is reached, and its writes follow the signal.
        t0 = time.monotonic()
        while (time.monotonic() - t0 < 600 and proc.poll() is None
               and not any(e["event"] == "injected" for e in journal(d))):
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        if proc.returncode != 75:
            problems.append(f"the signalled run exited {proc.returncode}, "
                            f"not 75: {out[-2000:]}")
        marker = [e for e in journal(d) if e["event"] == "graceful_shutdown"]
        if not marker:
            problems.append("no graceful_shutdown marker in the journal")
        err = run(cfg, dict(SUPERVISED))
        if not any(e["event"] == "recovery"
                   and e.get("after") == "graceful_shutdown"
                   for e in journal(d)):
            problems.append("the relaunch did not resume from the marker")
        problems += self.check_stores(base, d, ("gs.bp", "gs.vtk"))
        return self.verdict(3, err, problems, d,
                            stopped_at=marker[0]["step"] if marker else None)

    def scenario_4(self) -> dict:
        step = self.random_step()
        base = self.base(presets=PRESETS)
        d = os.path.join(self.workdir, "s4")
        err = run(self.config("s4", presets=PRESETS),
                  {**SUPERVISED, "GS_FAULTS": f"step={step}:kind=preempt"})
        problems = self.check_stores(base, d,
                                     self.member_stores(len(PRESETS)))
        if not any(e["event"] == "recovery" for e in journal(d)):
            problems.append("the supervisor recorded no recovery")
        return self.verdict(4, err, problems, d, step=step)

    def _ensemble_grow(self) -> List[str]:
        """Scenario 5's ensemble half: the problems found."""
        step = self.random_step()
        base = self.base(presets=PRESETS)
        d = os.path.join(self.workdir, "s5e")
        err = run(self.config("s5e", presets=PRESETS),
                  {"GS_FAULTS": f"step={step}:kind=preempt"})
        problems = [] if err is not None else [
            "the preempted ensemble run did not stop"]
        err = run(self.config("s5e", presets=GROWN, restart=True,
                              restart_input=os.path.join(d, "ckpt.bp")), {})
        if err is not None:
            problems.append(f"the grown resume failed: {err!r}")
        problems += self.check_stores(base, d,
                                      self.member_stores(len(PRESETS)))
        from .ensemble.io import member_tag

        grown = f"gs.{member_tag(len(PRESETS), len(GROWN))}.bp"
        if not os.path.isdir(os.path.join(d, grown)):
            problems.append(f"the grown member wrote no {grown}")
        return problems

    def scenario_5(self) -> dict:
        base = self.base(dims=(2, 2, 2))
        d = os.path.join(self.workdir, "s5")
        cfg = self.config("s5")
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = {k: v for k, v in os.environ.items() if k not in _VARS}
        env.update(SUPERVISED, GS_FAULTS="step=20:kind=hang",
                   GS_WATCHDOG="off", GS_HANG_BOUND_S="30")
        env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
        problems = []
        proc = subprocess.Popen(
            [sys.executable, "-c", MESH_CHILD, cfg, "2,2,2"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        t0 = time.monotonic()
        while (time.monotonic() - t0 < 600 and proc.poll() is None
               and not any(e["event"] == "injected" for e in journal(d))):
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        if proc.returncode != 75:
            problems.append(f"the signalled (2,2,2) run exited "
                            f"{proc.returncode}, not 75: {out[-2000:]}")
        events_path = os.path.join(d, "events.jsonl")
        err = run(cfg, {**SUPERVISED, "GS_EVENTS": events_path},
                  dims=(1, 2, 2))
        if not any(e["event"] == "recovery"
                   and e.get("after") == "graceful_shutdown"
                   for e in journal(d)):
            problems.append("the relaunch did not resume from the marker")
        from .obs.events import parse_events

        moves = [e["attrs"] for e in (parse_events(events_path)
                                      if os.path.exists(events_path) else [])
                 if e["kind"] == "reshard" and "new_mesh" in e["attrs"]]
        if [(m["old_mesh"], m["new_mesh"]) for m in moves] != [
                ([2, 2, 2], [1, 2, 2])]:
            problems.append(f"reshard events {moves}")
        for store in ("gs.bp", "ckpt.bp"):
            problems += [f"{store}: {p}" for p in values_equal(
                os.path.join(base, store), os.path.join(d, store))]
        problems += [f"gs.vtk/{f}" for f in trees_equal(
            os.path.join(base, "gs.vtk"), os.path.join(d, "gs.vtk"))]
        problems += [f"ensemble: {p}" for p in self._ensemble_grow()]
        return self.verdict(5, err, problems, d,
                            path=moves[0].get("path") if moves else None)

    def scenario_7(self) -> dict:
        env = {"GS_CKPT_REPLICAS": "2", "GS_CKPT_VERIFY": "full",
               "GS_ASYNC_IO_DEPTH": "0"}
        base = self.base(env)
        d = os.path.join(self.workdir, "s7")
        err = run(self.config("s7"), {
            **SUPERVISED, **env,
            "GS_FAULTS": "step=21:kind=ckpt_corrupt;step=31:kind=preempt"})
        problems = self.check_stores(base, d, ("gs.bp", "gs.vtk"))
        problems += [f"ckpt.bp.r1/{f}" for f in trees_equal(
            os.path.join(base, "ckpt.bp"), os.path.join(d, "ckpt.bp.r1"))]
        if not any(e["event"] == "replica_failover" for e in journal(d)):
            problems.append("no replica_failover record")
        return self.verdict(7, err, problems, d)

    def scenario_8(self) -> dict:
        env = {"GS_SNAPSHOT_BITS": "8"}
        base = self.base(env)
        d = os.path.join(self.workdir, "s8")
        err = run(self.config("s8"), {
            **SUPERVISED, **env,
            "GS_FAULTS": f"step={self.random_step()}:kind=preempt"})
        return self.verdict(8, err, self.check_stores(base, d), d)

    def scenario_11(self) -> dict:
        env = {"GS_SDC_CHECK": "spot"}
        base = self.base(env)
        d = os.path.join(self.workdir, "s11")
        err = run(self.config("s11"), {
            **SUPERVISED, **env, "GS_FAULTS": "step=25:kind=sdc"})
        problems = self.check_stores(base, d)
        mism = [e for e in journal(d) if e["event"] == "sdc_mismatch"]
        if len(mism) != 1 or mism[0].get("device") is None:
            problems.append(f"sdc_mismatch records {mism}")
        d2 = os.path.join(self.workdir, "s11q")
        err2 = run(self.config("s11q"), {
            **SUPERVISED, **env,
            "GS_FAULTS": "step=25:kind=sdc;step=45:kind=sdc"})
        events = journal(d2)
        quarantined = [e["device"] for e in events
                       if e["event"] == "device_quarantined"]
        gave_up = [e for e in events if e["event"] == "gave_up"]
        if len(quarantined) != 1:
            problems.append(f"quarantined {quarantined}")
        if not (gave_up and "every device quarantined"
                in gave_up[-1].get("reason", "")):
            problems.append(f"gave_up records {gave_up}")
        if err2 is None:
            problems.append("the run with a quarantined device completed")
        return self.verdict(11, err, problems, d,
                            device=mism[0]["device"] if mism else None,
                            block=mism[0].get("block") if mism else None,
                            quarantined=quarantined)

    def serve_spec(self, i: int, seed: int) -> dict:
        """Job ``i`` of a serving scenario: Gray-Scott at the scenario's
        L and steps, plotgap 10, a checkpoint every 20 (the solo
        scenarios' cadence), noise 0.1."""
        return {"tenant": "chaos", "model": "grayscott", "L": self.L,
                "steps": self.steps, "plotgap": 10, "checkpoint_freq": 20,
                "dt": 1.0, "noise": 0.1, "seed": seed + i,
                "params": {"F": 0.03 + 0.005 * i, "k": 0.062, "Du": 0.2,
                           "Dv": 0.1}}

    def serve(self, name: str, specs: List[dict], **cfg) -> List[dict]:
        """The specs through an in-process service (4 slots, one worker,
        unsupervised, on the scenario's backend); the jobs' records."""
        from .serve.scheduler import ServeConfig
        from .serve.server import ServeService

        kw = dict(port=0, workers=1, pack_max=4, pack_window_s=0.2,
                  state_dir=os.path.join(self.workdir, name),
                  supervise=False, backend=self.backend)
        kw.update(cfg)
        svc = ServeService(ServeConfig(**kw)).start()
        try:
            base = f"http://127.0.0.1:{svc.port}"
            jobs = [post(base, "/v1/jobs", s)["job"] for s in specs]
            return wait_terminal(base, jobs)
        finally:
            svc.close()

    def compare_members(self, got: List[dict], ref: List[dict],
                        by_value: bool = False) -> List[str]:
        """Every job's member stores against the reference run's: files
        byte for byte, or with ``by_value`` the ``.bp`` stores by value
        (the ``.vtk`` series byte for byte either way)."""
        problems = []
        for a, b in zip(got, ref):
            ta, tb = member_trees(a["store"]), member_trees(b["store"])
            for kind in ("gs", "vtk", "ckpt"):
                if by_value and kind != "vtk":
                    bad = values_equal(tb[kind], ta[kind])
                else:
                    bad = trees_equal(tb[kind], ta[kind])
                problems += [f"{a['job']} {kind}: {x}" for x in bad]
        return problems

    def check_stream(self, path: str, kinds) -> List[str]:
        """``obs/report --check`` on the (rank-merged) stream, and the
        event kinds it must hold."""
        from .obs import report
        from .obs.events import parse_events_multi

        problems = []
        with contextlib.redirect_stdout(sys.stderr):
            if report.main(["--check", "--events", path]) != 0:
                problems.append(f"obs/report --check rejected {path}")
        seen = {e["kind"] for e in parse_events_multi(path)}
        problems += [f"no {k} on the stream" for k in kinds
                     if k not in seen]
        return problems

    def scenario_6(self) -> dict:
        d = os.path.join(self.workdir, "s6")
        os.makedirs(d, exist_ok=True)
        step = self.random_step()
        specs = [self.serve_spec(i, 11) for i in range(3)]
        events = os.path.join(d, "events.jsonl")
        err = None
        problems: List[str] = []
        with environment({"GS_EVENTS": events}):
            try:
                killed = self.serve("s6/killed", specs,
                                    chaos=f"step={step}:kind=preempt")
                ref = self.serve("s6/ref", specs)
            except Exception as e:  # noqa: BLE001 — the verdict says it
                err = e
        if err is None:
            states = [r["state"] for r in killed + ref]
            if states != ["complete"] * 6:
                problems.append(f"job states {states}")
            if [r["attempts"] for r in killed] != [2] * 3:
                problems.append(f"attempts {[r['attempts'] for r in killed]}")
            if len({r["batch"] for r in killed}) != 1:
                problems.append("the three jobs did not share one batch")
            problems += self.compare_members(killed, ref)
            idle = os.path.join(os.path.dirname(killed[0]["store"]),
                                "gs.m03.bp")
            if os.path.exists(idle):
                problems.append("the idle slot wrote a store")
            problems += self.check_stream(
                events, ("job_submitted", "job_packed", "job_requeued",
                         "job_complete", "injected"))
        return self.verdict(6, err, problems, d, step=step)

    def scenario_9(self) -> dict:
        d = os.path.join(self.workdir, "s9")
        os.makedirs(d, exist_ok=True)
        fleet = Fleet(d, self.backend)
        err = None
        problems: List[str] = []
        extra = {"GS_CKPT_REPLICAS": "2", **FLEET_STALLS}
        victim = None
        try:
            for rank, role in ((0, "frontdoor"), (1, "frontdoor"),
                               (2, "worker"), (3, "worker")):
                fleet.start(rank, role, extra)
            (base_a, _), (base_b, pid_b) = fleet.frontdoors(2)
            jobs = [post(base_a if i % 2 == 0 else base_b, "/v1/jobs",
                         self.serve_spec(i, 200))["job"] for i in range(4)]
            victim = next(iter(fleet.leases(1).values()))
            os.kill(victim, signal.SIGKILL)
            os.kill(pid_b, signal.SIGKILL)
            jobs += [post(base_a, "/v1/jobs", self.serve_spec(i, 200))["job"]
                     for i in (4, 5)]
            records = wait_terminal(base_a, jobs)
            states = [r["state"] for r in records]
            if states != ["complete"] * 6:
                problems.append(f"fleet job states {states}")
            else:
                target = records[0]
                snapshot = os.path.join(d, "snapshot.bp")
                shutil.copytree(target["store"], snapshot)
                body = post(base_a, "/v1/jobs", self.serve_spec(0, 200))
                if (body.get("cache"), body.get("state"), body.get(
                        "store")) != ("hit", "complete", target["store"]):
                    problems.append(f"the repeated spec answered {body}")
                problems += [f"cached store: {x}" for x in
                             trees_equal(snapshot, target["store"])]
        except Exception as e:  # noqa: BLE001 — the verdict says it
            err = e
        finally:
            fleet.stop()
        if err is None:
            problems += self.check_stream(
                fleet.events, ("worker_join", "worker_lost",
                               "job_failover", "cache_hit"))
        return self.verdict(9, err, problems, d, killed_worker=victim)

    def scenario_10(self) -> dict:
        d = os.path.join(self.workdir, "s10")
        os.makedirs(d, exist_ok=True)
        fleet = Fleet(d, self.backend)
        err = None
        problems: List[str] = []
        specs = [self.serve_spec(i, 300) for i in range(4)]
        records: List[dict] = []
        try:
            for rank, role in ((0, "frontdoor"), (1, "worker"),
                               (2, "worker")):
                fleet.start(rank, role, FLEET_STALLS)
            (base, _), = fleet.frontdoors(1)
            jobs = [post(base, "/v1/jobs", s)["job"] for s in specs]
            (batch_a, _), (batch_b, pid_b) = sorted(fleet.leases(2).items())
            # B's request lands and its worker dies on the spot; the
            # reaper drops the orphaned request with the lease.
            fleet.steer(batch_b, {"mesh_dims": [2, 2, 2]}, wait=False)
            time.sleep(0.1)
            os.kill(pid_b, signal.SIGKILL)
            # A moves live twice, each consumed while it runs.
            fleet.steer(batch_a, {"mesh_dims": [2, 2, 2]})
            fleet.steer(batch_a, {"mesh_dims": [1, 2, 2]})
            records = wait_terminal(base, jobs)
            states = [r["state"] for r in records]
            if states != ["complete"] * 4:
                problems.append(f"fleet job states {states}")
        except Exception as e:  # noqa: BLE001 — the verdict says it
            err = e
        finally:
            fleet.stop()
        if err is None and not problems:
            with environment({}):
                ref = self.serve("s10/ref", specs, pack_max=2)
            problems += self.compare_members(records, ref, by_value=True)
            problems += self.check_stream(
                fleet.events, ("reshard", "worker_lost", "job_failover"))
            from .obs.events import parse_events_multi

            moves = [e["attrs"] for e in parse_events_multi(fleet.events)
                     if e["kind"] == "reshard" and "new_mesh" in e["attrs"]
                     and e["attrs"].get("batch") == batch_a]
            if [m["new_mesh"] for m in moves] != [[2, 2, 2], [1, 2, 2]]:
                problems.append(f"batch {batch_a} moves {moves}")
        return self.verdict(10, err, problems, d)

    def verdict(self, n: int, err, problems: List[str], d: str,
                **extra) -> dict:
        if err is not None:
            problems = [f"the supervised run raised {err!r}"] + problems
        events = journal(d)
        return {"scenario": n, "ok": not problems, "problems": problems,
                "recoveries": [e.get("kind") for e in events
                               if e["event"] == "recovery"],
                **extra}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--backend", default="CUDA", choices=("CPU", "CUDA"),
                   help="CUDA (the default) runs on the card; CPU runs "
                        "the plain path on the host")
    p.add_argument("--L", type=int, default=32)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--scenarios", default=",".join(map(str, SCENARIOS)))
    p.add_argument("--workdir", default=None,
                   help="where the runs write (default: a temporary "
                        "directory, removed at the end)")
    args = p.parse_args(argv)
    wanted = [int(x) for x in args.scenarios.split(",") if x.strip()]
    unknown = sorted(set(wanted) - set(SCENARIOS))
    if unknown:
        print(f"chaos: no scenario {unknown} (there are "
              f"{list(SCENARIOS)})", file=sys.stderr)
        return 2
    if args.steps < 40:
        print("chaos: --steps must be at least 40", file=sys.stderr)
        return 2
    seed = args.seed if args.seed is not None else random.randrange(1 << 16)
    workdir = args.workdir or tempfile.mkdtemp(prefix="gs_chaos_")
    chaos = Chaos(args.backend, args.L, args.steps, seed, workdir)
    ok = True
    try:
        for n in wanted:
            t0 = time.perf_counter()
            result = getattr(chaos, f"scenario_{n}")()
            result.update(seed=seed, seconds=round(time.perf_counter() - t0,
                                                   3))
            ok &= result["ok"]
            print(json.dumps(result), flush=True)
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
