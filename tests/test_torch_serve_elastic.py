"""The port's elastic policy (``grayscott_jl_tpu_torch/serve/elastic.py``)
against the reference's, on the CPU.

* ``resolve_elastic_config`` equals the reference's on every
  ``GS_SERVE_ELASTIC*`` variable; a bad value raises the same
  ``ValueError``.
* ``ElasticController.tick`` makes the reference's decisions — the
  action, the batch it targets, the request posted — over the same
  synthetic sequences of queue depth, utilization, running batches and
  refusals, the cooldown clock included.
* On the service, the requests reach a running batch through the
  scheduler's consume-once relay.
"""

import pytest

from grayscott_jl_tpu.obs.events import NULL_EVENTS as REF_NULL
from grayscott_jl_tpu.serve import elastic as ref_elastic

from grayscott_jl_tpu_torch.obs.events import NULL_EVENTS
from grayscott_jl_tpu_torch.serve import elastic
from grayscott_jl_tpu_torch.serve.scheduler import Scheduler, ServeConfig

ELASTIC_VARS = ("GS_SERVE_ELASTIC", "GS_SERVE_ELASTIC_HIGH",
                "GS_SERVE_ELASTIC_LOW", "GS_SERVE_ELASTIC_SUSTAIN",
                "GS_SERVE_ELASTIC_COOLDOWN_S", "GS_SERVE_ELASTIC_TICK_S")


@pytest.fixture
def env(monkeypatch):
    for var in ELASTIC_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("values", [
    {},
    {"GS_SERVE_ELASTIC": "1"},
    {"GS_SERVE_ELASTIC": "on", "GS_SERVE_ELASTIC_HIGH": "8",
     "GS_SERVE_ELASTIC_LOW": "3", "GS_SERVE_ELASTIC_SUSTAIN": "4",
     "GS_SERVE_ELASTIC_COOLDOWN_S": "0", "GS_SERVE_ELASTIC_TICK_S": "0.1"},
])
def test_elastic_config_equals_the_reference(env, values):
    for k, v in values.items():
        env.setenv(k, v)
    assert elastic.resolve_elastic_config().describe() == (
        ref_elastic.resolve_elastic_config().describe())


@pytest.mark.parametrize("values", [
    {"GS_SERVE_ELASTIC_HIGH": "0"},
    {"GS_SERVE_ELASTIC_LOW": "9"},
    {"GS_SERVE_ELASTIC_LOW": "-1"},
    {"GS_SERVE_ELASTIC_HIGH": "2", "GS_SERVE_ELASTIC_LOW": "2"},
    {"GS_SERVE_ELASTIC_SUSTAIN": "0"},
    {"GS_SERVE_ELASTIC_COOLDOWN_S": "-1"},
    {"GS_SERVE_ELASTIC_TICK_S": "0"},
    {"GS_SERVE_ELASTIC_HIGH": "many"},
])
def test_bad_elastic_config_raises_the_reference_error(env, values):
    for k, v in values.items():
        env.setenv(k, v)
    with pytest.raises(ValueError) as ref:
        ref_elastic.resolve_elastic_config()
    with pytest.raises(ValueError) as got:
        elastic.resolve_elastic_config()
    assert str(got.value) == str(ref.value)


class FakeBatch:
    def __init__(self, bid, created_t):
        self.id = bid
        self.created_t = created_t


class FakeScheduler:
    def __init__(self):
        self.depth = 0
        self.running = []
        self.accept = True
        self.requests = []

    def queue_depth(self):
        return self.depth

    def running_batches(self):
        return list(self.running)

    def request_reshape(self, batch_id, req):
        if not self.accept:
            return False
        self.requests.append((batch_id, dict(req)))
        return True


class FakeFleet:
    util = 0.0

    def utilization(self):
        return self.util


#: Per tick: (queue depth, utilization, running batch ids, requests
#: accepted, seconds the clock advances).
SEQUENCES = {
    "pressure": [(3, 1.0, ("b1", "b2"), True, 0.1)] * 4,
    "relief": [(0, 0.5, ("b2", "b1"), True, 0.1)] * 4,
    "broken streak": [(3, 1.0, ("b1",), True, 0.1),
                      (1, 1.0, ("b1",), True, 0.1),
                      (3, 1.0, ("b1",), True, 0.1),
                      (3, 1.0, ("b1",), True, 0.1)],
    "cooldown": ([(3, 1.0, ("b1",), True, 0.1)] * 3
                 + [(0, 0.0, ("b1",), True, 2.0)] * 4
                 + [(0, 0.0, ("b1",), True, 5.0)] * 3),
    "nothing running": [(5, 1.0, (), True, 0.1)] * 4,
    "refused": ([(5, 1.0, ("b1",), False, 0.1)] * 3
                + [(5, 1.0, ("b1",), True, 0.1)] * 2),
    "no fleet": [(4, None, ("b3", "b1"), True, 0.1)] * 3,
    "mixed": [(d, u, ("b1", "b2"), True, 1.5) for d, u in
              [(2, 1.0), (2, 1.0), (0, 0.2), (0, 0.2), (0, 0.2), (4, 1.0),
               (4, 1.0), (4, 1.0), (1, 0.5), (0, 0.9), (0, 0.9)]],
}


def decisions(mod, null, seq, monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(mod.time, "monotonic", lambda: clock[0])
    sched = FakeScheduler()
    fleet = FakeFleet()
    no_fleet = any(u is None for _, u, _, _, _ in seq)
    ctl = mod.ElasticController(
        sched, None if no_fleet else fleet,
        mod.ElasticConfig(enabled=True, high=2, low=0, sustain=2,
                          cooldown_s=3.0, tick_s=0.01),
        events=null)
    out = []
    for depth, util, running, accept, dt in seq:
        sched.depth = depth
        fleet.util = util
        sched.running = [FakeBatch(b, 10.0 + int(b[1:])) for b in running]
        sched.accept = accept
        out.append((ctl.tick(), list(sched.requests), ctl.actions))
        clock[0] += dt
    return out


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_tick_decisions_equal_the_reference(monkeypatch, name):
    got = decisions(elastic, NULL_EVENTS, SEQUENCES[name], monkeypatch)
    ref = decisions(ref_elastic, REF_NULL, SEQUENCES[name], monkeypatch)
    assert got == ref


def test_start_is_a_noop_when_disabled():
    ctl = elastic.ElasticController(
        FakeScheduler(), cfg=elastic.ElasticConfig(enabled=False),
        events=NULL_EVENTS)
    assert ctl.start()._thread is None
    ctl.close()


def test_requests_reach_a_running_batch_through_the_scheduler(tmp_path):
    sched = Scheduler(ServeConfig(state_dir=str(tmp_path), pack_window_s=0.0,
                                  supervise=False, cache=False,
                                  backend="CPU"), events=NULL_EVENTS)
    sched.submit({"tenant": "a", "L": 16, "steps": 8})
    for _ in range(3):
        sched.submit({"tenant": "a", "L": 32, "steps": 8})
    batch = sched.next_batch(timeout=0.0)
    batch.jobs[0].state = "running"
    fleet = FakeFleet()
    fleet.util = 1.0
    ctl = elastic.ElasticController(
        sched, fleet, elastic.ElasticConfig(enabled=True, high=2, sustain=1,
                                            cooldown_s=0.0),
        events=NULL_EVENTS)
    assert ctl.tick() == "shrink"
    assert sched.take_reshape(batch.id) == {"scale": "shrink"}
    assert sched.take_reshape(batch.id) is None
