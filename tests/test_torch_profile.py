"""Profiler captures on CPU torch at L=16 (grayscott_jl_tpu_torch/obs/
trace.py ``ProfileWindow``, ``GS_PROFILE`` / ``GS_PROFILE_DIR``;
utils/profiler.py ``trace``, ``GS_TPU_PROFILE``), held against the
reference's ``grayscott_jl_tpu/obs/trace.py::ProfileWindow``.

* ``ProfileWindow.from_env`` equals the reference's on every value: the
  same window, or the same error type with the same message.
* ``GS_PROFILE=2:6`` over a 10-step run with plotgap 2 writes one Chrome
  trace, whose rounds are those from steps 2 and 4 (steps 2-6) only;
  the stores are bitwise the run without it. A window past the run's
  end closes when the run does.
* ``GS_TPU_PROFILE`` captures the run's step loop into its
  directory; the stores are bitwise the same.
* A profiler that fails warns and the run goes on."""

import json
import re

import pytest

from grayscott_jl_tpu.obs.trace import ProfileWindow as RefWindow
from grayscott_jl_tpu_torch import driver
from grayscott_jl_tpu_torch.obs import trace
from grayscott_jl_tpu_torch.obs.trace import ProfileWindow
from test_torch_xstats import store_files, write_config

PHYSICS = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("GS_PROFILE", "GS_PROFILE_DIR", "GS_TPU_PROFILE",
                "GS_XSTATS", "GS_TPU_STATS", "GS_FUSE"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("out_dir", [None, "/tmp/gs_prof"])
@pytest.mark.parametrize("spec", [
    None, "", "2:6", " 2:6 ", "0:1", "50:150", "5", "a:b", "1:2:3", "6:2",
    "3:3", "-1:3", "2:x",
])
def test_from_env_matches_the_reference(spec, out_dir, monkeypatch):
    if spec is not None:
        monkeypatch.setenv("GS_PROFILE", spec)
    if out_dir is not None:
        monkeypatch.setenv("GS_PROFILE_DIR", out_dir)
    try:
        ref = RefWindow.from_env()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ProfileWindow.from_env()
        assert str(got.value) == str(e)
        return
    port = ProfileWindow.from_env()
    if ref is None:
        assert port is None
        return
    assert (port.start, port.stop, port.out_dir, port.active) == (
        ref.start, ref.stop, ref.out_dir, ref.active)


def _rounds(path):
    """The first step of each ``gs_round`` range in a Chrome trace."""
    with open(path) as f:
        doc = json.load(f)
    return sorted(int(re.search(r"step=(\d+)", e["name"]).group(1))
                  for e in doc["traceEvents"]
                  if e.get("ph") == "X"
                  and e.get("name", "").startswith("gs_round"))


def _run(monkeypatch, d, env):
    cfg = write_config(d, plotgap=2, checkpoint_freq=4, **PHYSICS)
    with monkeypatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, str(v))
        return driver.main([cfg])


def test_window_covers_its_steps_only(tmp_path, monkeypatch):
    """Boundaries every 2 steps: the window opens at step 2 and closes
    at step 6, so the rounds from steps 2 and 4 are in it and no other;
    one trace, named after the window."""
    _run(monkeypatch, tmp_path / "off", {})
    prof = tmp_path / "prof"
    _run(monkeypatch, tmp_path / "on", {"GS_PROFILE": "2:6",
                                        "GS_PROFILE_DIR": prof})
    files = sorted(p.name for p in prof.iterdir())
    assert files == ["profile_2_6.json"]
    assert _rounds(prof / "profile_2_6.json") == [2, 4]
    assert store_files(tmp_path / "on") == store_files(tmp_path / "off")


def test_window_past_the_end_closes_with_the_run(tmp_path, monkeypatch):
    prof = tmp_path / "prof"
    _run(monkeypatch, tmp_path / "on", {"GS_PROFILE": "6:50",
                                        "GS_PROFILE_DIR": prof})
    assert _rounds(prof / "profile_6_50.json") == [6, 8]


def test_tpu_profile_captures_the_run(tmp_path, monkeypatch):
    _run(monkeypatch, tmp_path / "off", {})
    out = tmp_path / "tpu_profile"
    _run(monkeypatch, tmp_path / "on", {"GS_TPU_PROFILE": out})
    with open(out / "gs_tpu_profile.json") as f:
        doc = json.load(f)
    assert doc["traceEvents"]
    assert store_files(tmp_path / "on") == store_files(tmp_path / "off")


def test_a_failing_profiler_warns_and_the_run_goes_on(tmp_path, monkeypatch,
                                                      capsys):
    _run(monkeypatch, tmp_path / "off", {})

    def refuse(path, cuda):
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(trace, "profiler_capture", refuse)
    _run(monkeypatch, tmp_path / "on", {"GS_PROFILE": "2:6",
                                        "GS_PROFILE_DIR": tmp_path / "p"})
    err = capsys.readouterr().err
    assert "torch.profiler start failed (profiler busy)" in err
    assert not (tmp_path / "p").exists()
    assert store_files(tmp_path / "on") == store_files(tmp_path / "off")


def test_window_state_machine_matches_the_reference(monkeypatch):
    """Boundaries 0, 2, ... 10 for a 3:7 window: open from the first
    boundary at or past 3 to the first at or past 7, as the reference's
    window is (both captures stubbed out)."""
    import jax

    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)

    class Capture:
        def stop(self):
            return "path"

    monkeypatch.setattr(trace, "profiler_capture",
                        lambda path, cuda: Capture())
    port, ref = ProfileWindow(3, 7, "unused"), RefWindow(3, 7, "unused")
    states = []
    for step in range(0, 11, 2):
        port.on_boundary(step)
        ref.on_boundary(step)
        states.append((port.active, ref.active))
    assert [p for p, _ in states] == [r for _, r in states] == [
        False, False, True, True, False, False]
    assert port.path == "path"
