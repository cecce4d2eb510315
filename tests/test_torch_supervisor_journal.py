"""The fault journal of a supervised run against the reference's for the
same plan (grayscott_jl_tpu_torch/resilience/supervisor.py beside
grayscott_jl_tpu/resilience/supervisor.py), on the CPU, one block each:
the same ``event``/``kind`` records in the same order, with the same
recovery actions, for every fault kind of tests/test_torch_supervisor.py.
Two differences are allowed: a kernel failure is fatal in the port, so
where the reference journals its ``recovery`` (``degraded_pallas_to_xla``)
and goes on, the port journals ``gave_up`` and stops; and a run of
several processes journals no ``mesh_agreement`` record (the reference's
mesh agreement is Queue 1 item 18; none of these runs has several
processes)."""

import json

import pytest

from grayscott_jl_tpu import driver as ref_driver
from grayscott_jl_tpu_torch import driver
from grayscott_jl_tpu_torch.resilience.faults import InjectedKernelError
from test_torch_supervisor import (CASES, SUPERVISED, _VARS, _reset_sinks,
                                   write_config)


def _journal(d):
    return [json.loads(x) for x in
            (d / "gs.bp.faults.jsonl").read_text().splitlines()]


def _shape(events):
    """``(event, kind, action)`` of each record."""
    return [(e["event"], e.get("kind"), e.get("action") or "")
            for e in events]


@pytest.mark.parametrize("case", list(CASES))
def test_journal_matches_the_reference(monkeypatch, tmp_path, case):
    faults, env, cfg = CASES[case]
    for var in _VARS:
        monkeypatch.delenv(var, raising=False)
    for k, v in {**SUPERVISED, **env, "GS_FAULTS": faults}.items():
        monkeypatch.setenv(k, v)
    _reset_sinks()
    if case == "kernel":
        with pytest.raises(InjectedKernelError):
            driver.main([write_config(tmp_path / "port", **cfg)])
    else:
        driver.main([write_config(tmp_path / "port", **cfg)])
    _reset_sinks()
    ref_driver.main([write_config(tmp_path / "ref", **cfg)], n_devices=1)
    port, ref = _journal(tmp_path / "port"), _journal(tmp_path / "ref")
    want = _shape(ref)
    if case == "kernel":
        # The reference's recovery is the port's gave_up, and the last.
        assert want[-1] == ("recovery", "kernel",
                            "degraded_pallas_to_xla;"
                            "resumed_from_checkpoint_step_20")
        want[-1] = ("gave_up", "kernel", "")
    assert _shape(port) == want
    assert not any(e["event"] == "mesh_agreement" for e in port)
    # The injected records carry the same steps.
    assert [(e["kind"], e["step"], e["planned_step"]) for e in port
            if e["event"] == "injected"] == [
        (e["kind"], e["step"], e["planned_step"]) for e in ref
        if e["event"] == "injected"]
