"""What two processes of one run must agree on (grayscott_jl_tpu_torch/
parallel/distributed.py's collectives, resilience/health.py's reduced
report, the driver's shutdown agreement, resilience/rendezvous.py), on
the CPU over gloo:

* the F1 blow-up (L=16, dt=400): the health report is reduced over both
  processes, so both raise ``HealthError`` at step 10 and no step is
  written (one process alone would abort while the other waited in the
  next exchange);
* a SIGTERM to one process stops both at the same boundary, each with a
  checkpoint and exit 75;
* the restart rendezvous of the reference's
  ``test_two_process_kv_restart_consensus``, two rounds over the process
  group's store, and over the file transport;
* the reductions themselves: NaN wins, min of mins, max of maxes."""

import json
import signal
import subprocess
import sys
import threading

import pytest

from grayscott_jl_tpu_torch import launch
from grayscott_jl_tpu_torch.io.bplite import BpReader
from test_torch_multiprocess import (TIMEOUT, clean_env, spawn_pair,
                                     write_config)

CLI = ["-c", launch.CHILD]


def test_blow_up_stops_both_processes_at_the_same_step(tmp_path):
    cfg = write_config(tmp_path, dt=400.0, checkpoint=False)
    outs = spawn_pair(tmp_path, CLI + [cfg, "4"])
    for rc, out, err in outs:
        assert rc == 1, out + err
        assert "HealthError: field health check failed at step 10" in err
    with BpReader(str(tmp_path / "out.bp")) as r:
        assert r.num_steps() == 0


def test_sigterm_to_one_process_stops_both_at_one_boundary(tmp_path):
    cfg = write_config(tmp_path, steps=100000, plotgap=10,
                       checkpoint_freq=1000000)
    port = launch.free_port()
    procs = [subprocess.Popen(
        [sys.executable, *CLI, cfg, "4"], cwd=str(tmp_path),
        env=launch.process_env(r, 2, port, clean_env()),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    # The pair dies at the timeout even if process 0 never prints.
    watchdog = threading.Timer(TIMEOUT, lambda: [p.kill() for p in procs])
    watchdog.start()
    outs = []
    try:
        for line in procs[0].stdout:
            if "writing output step" in line:
                procs[1].send_signal(signal.SIGTERM)
                break
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out)
    finally:
        watchdog.cancel()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [75, 75], outs
    # Both writers checkpointed the same boundary: the merged store
    # shows it, as the last output step.
    with BpReader(str(tmp_path / "ckpt.bp")) as r:
        assert r.num_steps() == 1
        at = int(r.get("step", step=0))
    with BpReader(str(tmp_path / "out.bp")) as r:
        assert int(r.get("step", step=r.num_steps() - 1)) == at
    assert at % 10 == 0 and at < 100000


_WORKER = """\
import json, sys
import numpy as np
from grayscott_jl_tpu_torch.config.settings import Settings
from grayscott_jl_tpu_torch.parallel import distributed
from grayscott_jl_tpu_torch.resilience import rendezvous

g = distributed.ensure_started("cpu")
pid = distributed.process_index()
rdv = rendezvous.from_env(Settings(output="out.bp"))
# rank 0's latest durable checkpoint is 40, rank 1's is 20; rank 1 also
# claims a higher attempt: both must adopt (max attempt, min step),
# across two rounds.
r1 = rdv.agree(attempt=pid, ckpt_step=40 if pid == 0 else 20)
r2 = rdv.agree(attempt=r1[0] + 1, ckpt_step=None if pid == 0 else 60)
probe = ([1.0, 0.1, 0.9, 0.2, 0.8] if pid == 0
         else [0.0, -0.1, float("nan"), 0.3, 0.7])
red = distributed.reduce_probe(np.array(probe))
print("RESULT " + json.dumps({
    "pid": pid, "transport": type(rdv).__name__, "r1": r1, "r2": r2,
    "probe": [None if x != x else x for x in red.tolist()],
    "range": distributed.global_range(pid - 1.0, 2.0 + pid),
    "any": [distributed.any_process(pid == 1), distributed.any_process(False)],
    "layout": distributed.block_layout(4),
    "local": [g.local_rank, g.local_world],
}))
"""


@pytest.mark.parametrize("transport,extra,drop", [
    ("KVRendezvous", {}, ()),
    ("FileRendezvous", {"GS_RENDEZVOUS_DIR": "rdv"},
     ("LOCAL_RANK", "LOCAL_WORLD_SIZE"))])
def test_two_process_restart_consensus_and_reductions(tmp_path, transport,
                                                      extra, drop):
    """Without ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` the processes find
    their rank on the host from each other's host names."""
    outs = spawn_pair(tmp_path, ["-c", _WORKER], extra=extra, drop=drop)
    results = {}
    for rc, out, err in outs:
        assert rc == 0, out + err
        for line in out.splitlines():
            if line.startswith("RESULT "):
                r = json.loads(line[len("RESULT "):])
                results[r["pid"]] = r
    assert set(results) == {0, 1}
    for pid, r in results.items():
        assert r["transport"] == transport
        # round 1: max attempt (1), min checkpoint (20), on both
        assert r["r1"] == [1, 20]
        # round 2: rank 0 has no durable checkpoint: restart from scratch
        assert r["r2"] == [2, None]
        # finite by MIN, mins by MIN, maxes by MAX, NaN wins
        assert r["probe"] == [0.0, -0.1, None, 0.2, 0.8]
        assert r["range"] == [-1.0, 3.0]
        assert r["any"] == [True, False]
        assert r["layout"] == [8, 4 * pid]
        assert r["local"] == [pid, 2]
    if transport == "FileRendezvous":
        assert len(list((tmp_path / "rdv").iterdir())) == 4
