"""Start a run of N processes on this host (counterpart of
``scripts/run_local_multiproc.sh``)::

    python -m grayscott_jl_tpu_torch.launch N config.toml [devices_per_proc]

Each process runs the CLI (``gray-scott-torch config.toml``) with the
launch variables set — ``GS_TPU_COORDINATOR`` on a free local port,
``GS_TPU_NUM_PROCESSES``, ``GS_TPU_PROCESS_ID``, and ``LOCAL_RANK`` /
``LOCAL_WORLD_SIZE`` — so that together they are one simulation
(``parallel/distributed.py``). ``devices_per_proc`` is each process's
number of blocks (``driver.main(args, n_devices=...)``): on the CPU that
many CPU blocks, on the card that many blocks spread over the process's
cards, a card repeating where it has fewer; without it a process holds
one block per card it owns (one on the CPU).

The launcher waits for the processes. When one fails, it kills the rest
and exits with the failed process's code (76 after a hang watchdog's
hard exit); a process that stopped on a shutdown request (exit 75) lets
the others reach the same boundary. Under ``GS_SUPERVISE=1`` a
relaunch after 75 or 76 resumes from each process's journal marker.
SIGTERM and SIGINT are passed on to every process. The processes die
with the launcher.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

from .resilience.faults import EXIT_PREEMPTED

#: What each process runs: the CLI with its share of the blocks, dying
#: with the launcher.
CHILD = (
    "import sys; from grayscott_jl_tpu_torch import launch; "
    "launch.die_with_parent(); "
    "from grayscott_jl_tpu_torch import julia_main; "
    "n = sys.argv[2]; "
    "sys.exit(julia_main(sys.argv[1:2], n_devices=int(n) if n else None))"
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    """A TCP port free on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def process_env(rank: int, nprocs: int, port: int,
                base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment of process ``rank`` of ``nprocs``."""
    env = dict(os.environ if base is None else base)
    env.pop("GS_TPU_DISTRIBUTED", None)
    env.update({
        "GS_TPU_COORDINATOR": f"127.0.0.1:{port}",
        "GS_TPU_NUM_PROCESSES": str(nprocs),
        "GS_TPU_PROCESS_ID": str(rank),
        "LOCAL_RANK": str(rank),
        "LOCAL_WORLD_SIZE": str(nprocs),
        "PYTHONPATH": _REPO + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else ""),
    })
    return env


def die_with_parent() -> None:
    """Have the kernel send this process SIGKILL when its parent dies
    (Linux ``prctl(PR_SET_PDEATHSIG)``; elsewhere nothing)."""
    if not sys.platform.startswith("linux"):
        return
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def launch(nprocs: int, config: str, devices_per_proc: Optional[int] = None,
           *, env: Optional[Dict[str, str]] = None,
           cwd: Optional[str] = None, timeout: Optional[float] = None,
           stdout=None, stderr=None) -> List[int]:
    """Run ``nprocs`` processes of the CLI on ``config`` and wait for
    them; returns their exit codes. A process that fails (other than by
    exiting 75) gets the rest killed; ``timeout`` seconds after the
    start every process still running is killed (exit code -9)."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", CHILD, config,
             "" if devices_per_proc is None else str(int(devices_per_proc))],
            cwd=cwd, env=process_env(r, nprocs, port, env),
            stdout=stdout, stderr=stderr)
        for r in range(nprocs)
    ]

    def kill_all():
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()

    def forward(signum, _frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    handlers = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            handlers[sig] = signal.signal(sig, forward)
    except ValueError:
        handlers = {}  # not the main thread: no signals to pass on
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes:
                break
            failed = [rc for rc in codes
                      if rc not in (None, 0, EXIT_PREEMPTED)]
            if failed or (deadline is not None
                          and time.monotonic() > deadline):
                kill_all()
                break
            time.sleep(0.05)
    finally:
        kill_all()
        for sig, h in handlers.items():
            signal.signal(sig, h)
    return [p.returncode for p in procs]


def exit_code(codes: List[int]) -> int:
    """The launcher's exit code: a failed process's, else 1 when a
    process was killed, else 75 when one stopped on a shutdown request,
    else 0."""
    for rc in codes:
        if rc > 0 and rc != EXIT_PREEMPTED:
            return rc
    if any(rc < 0 for rc in codes):
        return 1
    return EXIT_PREEMPTED if EXIT_PREEMPTED in codes else 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (2, 3):
        print("usage: python -m grayscott_jl_tpu_torch.launch N config.toml "
              "[devices_per_proc]", file=sys.stderr)
        return 2
    nprocs = int(argv[0])
    dpp = int(argv[2]) if len(argv) == 3 else None
    return exit_code(launch(nprocs, argv[1], dpp))


if __name__ == "__main__":
    sys.exit(main())
