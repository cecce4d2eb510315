"""The run report (grayscott_jl_tpu_torch/obs/report.py, the port's copy
of ``scripts/gs_report.py``) on a CPU run's artifacts at L=16 with every
sink armed (stats, trace, events, metrics, numerics, build and launch
analytics).

* ``--check`` passes on them, and so does the reference's
  ``python scripts/gs_report.py --check`` on the same artifacts, run as
  a subprocess.
* A render exits 0 and prints the reference script's section headers.
* The event schema is the reference's, and a bad artifact fails
  ``--check`` with exit 1 in both."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from grayscott_jl_tpu_torch import driver
from grayscott_jl_tpu_torch.obs import events, metrics, report, trace
from test_torch_multiprocess import LAUNCH_VARS
from test_torch_xstats import write_config

REPO = Path(__file__).resolve().parents[1]
PHYSICS = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A CPU run with every sink armed: the report's arguments."""
    d = tmp_path_factory.mktemp("report")
    cfg = write_config(d, plotgap=2, checkpoint_freq=4, **PHYSICS)
    env = {"GS_TPU_STATS": d / "stats.json", "GS_TRACE": d / "trace.json",
           "GS_EVENTS": d / "events.jsonl", "GS_METRICS": d / "m.jsonl",
           "GS_METRICS_INTERVAL_S": "0.001", "GS_NUMERICS": "boundary",
           "GS_XSTATS": "1"}
    mp = pytest.MonkeyPatch()
    for var in LAUNCH_VARS + ("GS_FUSE",):
        mp.delenv(var, raising=False)
    for k, v in env.items():
        mp.setenv(k, str(v))
    events.reset_events()
    metrics.reset_metrics()
    trace.reset_tracer()
    try:
        driver.main([cfg])
    finally:
        events.reset_events()
        metrics.reset_metrics()
        trace.reset_tracer()
        mp.undo()
    return ["--stats", str(d / "stats.json"), "--trace",
            str(d / "trace.json"), "--events", str(d / "events.jsonl"),
            "--metrics", str(d / "m.jsonl")]


def reference(args):
    return subprocess.run(
        [sys.executable, str(REPO / "scripts" / "gs_report.py"), *args],
        capture_output=True, text=True, timeout=120,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"})


def port(args):
    return subprocess.run(
        [sys.executable, "-m", "grayscott_jl_tpu_torch.obs.report", *args],
        capture_output=True, text=True, timeout=120, cwd=REPO)


def test_port_check_passes(artifacts, capsys):
    assert report.main(["--check", *artifacts]) == 0
    assert "artifacts validate" in capsys.readouterr().out


def test_reference_check_passes_on_the_ports_artifacts(artifacts):
    proc = reference(["--check", *artifacts])
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_render_headers_equal_the_references(artifacts):
    """The same sections, in the same order; the executables section
    holds the store engine's build record and the exchange census."""
    mine, theirs = port(artifacts), reference(artifacts)
    assert mine.returncode == theirs.returncode == 0, (mine.stderr,
                                                       theirs.stderr)

    def headers(text):
        return [line.split("(")[0].strip() for line in text.splitlines()
                if line.startswith("== ")]

    assert headers(mine.stdout) == headers(theirs.stdout)
    assert "== executables (1 compiles" in mine.stdout
    assert "libbplite" in mine.stdout and "exchange census" in mine.stdout
    for name in ("== run ==", "== phases ==", "== timeline =="):
        assert name in mine.stdout


def test_event_schema_is_the_references():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "gs_report_ref", REPO / "scripts" / "gs_report.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert report.EVENT_KIND_SCHEMA == ref.EVENT_KIND_SCHEMA


def test_a_bad_artifact_fails_check_in_both(artifacts, tmp_path):
    bad = tmp_path / "events.jsonl"
    bad.write_text(json.dumps({"ts": 1.0, "kind": "no_such_kind",
                               "attrs": {}}) + "\n")
    assert report.main(["--check", "--events", str(bad)]) == 1
    assert reference(["--check", "--events", str(bad)]).returncode == 1
    missing = ["--check", "--stats", str(tmp_path / "absent.json")]
    assert report.main(missing) == 1
    assert reference(missing).returncode == 1


def test_no_artifact_is_a_usage_error():
    assert port([]).returncode == reference([]).returncode == 2
