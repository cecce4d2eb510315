"""The port's serving protocol, configuration, scheduler and worker fleet
(``grayscott_jl_tpu_torch/serve/``) against the reference's
(``grayscott_jl_tpu/serve/``, which imports nothing of JAX), on the CPU.

* ``parse_job``, ``pack_key``, ``resolved_params`` and ``_pow2_slots``
  equal the reference's on a table of payloads; an invalid payload
  raises the same error type with the same message.
* ``batch_settings(backend="CPU")`` equals the reference's field for
  field; ``"CUDA"`` differs in ``backend`` and ``kernel_language`` only.
* ``resolve_serve_config`` equals the reference's on every variable, and
  a bad value raises the same ``ValueError``.
* Admission, priorities, packing, cancel, requeue, completion and drain
  behave as the reference's scheduler on the same calls.
* The worker fleet's warm engine and its key (the backend included), and
  the kernel layer's thread safety (one build, per-thread replays,
  exact counts).
"""

import dataclasses
import threading
import types

import pytest

from grayscott_jl_tpu.obs.events import NULL_EVENTS as REF_NULL
from grayscott_jl_tpu.serve import protocol as ref_protocol
from grayscott_jl_tpu.serve import scheduler as ref_scheduler

from grayscott_jl_tpu_torch.obs.events import NULL_EVENTS
from grayscott_jl_tpu_torch.ops import _build, cuda_stencil
from grayscott_jl_tpu_torch.serve import protocol, scheduler, worker

SPEC = {
    "tenant": "alice", "model": "grayscott", "L": 16, "steps": 24,
    "plotgap": 8, "checkpoint_freq": 8,
    "params": {"F": 0.03, "k": 0.062, "Du": 0.2, "Dv": 0.1},
    "dt": 1.0, "noise": 0.1, "seed": 11,
}

PKGS = {"ref": (ref_protocol, ref_scheduler, REF_NULL),
        "port": (protocol, scheduler, NULL_EVENTS)}


def spec(**kw):
    payload = {**SPEC, **kw}
    params = payload.pop("params_override", None)
    if params is not None:
        payload["params"] = params
    return payload


VALID = [
    spec(),
    spec(priority="high"),
    spec(priority=3, tenant="bob"),
    spec(params_override={"F": 0.055, "k": 0.06}),
    spec(params_override={}),
    spec(noise=0.0, seed=0, precision="Float64", halo_depth=2),
    spec(model="heat", params_override={}),
    spec(model="brusselator", params_override={"A": 1.0, "B": 3.0}),
    {"tenant": "t"},
    spec(L=4, steps=1, plotgap=0, checkpoint_freq=0, dt=1e-3),
    spec(precision="BFloat16", noise=1),
]

INVALID = [
    spec(tenant=""),
    spec(tenant="x" * 65),
    spec(model="nope"),
    spec(model=3),
    spec(params_override={"Fx": 1.0}),
    spec(params_override={"F": "hot"}),
    spec(params_override=[1]),
    spec(L=1 << 20),
    spec(L=3),
    spec(L=16.0),
    spec(steps=0),
    spec(steps=True),
    spec(dt=0.0),
    spec(dt="1"),
    spec(wormhole=1),
    spec(precision="Float128"),
    spec(priority="urgent"),
    spec(priority=17),
    spec(priority=False),
    spec(seed=-1),
    spec(halo_depth=17),
    [1, 2],
    None,
]


@pytest.mark.parametrize("payload", VALID)
def test_parse_job_pack_key_and_params_equal_the_reference(payload):
    ref = ref_protocol.parse_job(payload)
    job = protocol.parse_job(payload)
    assert job.describe() == ref.describe()
    assert protocol.pack_key(job) == ref_protocol.pack_key(ref)
    assert protocol.resolved_params(job) == ref_protocol.resolved_params(ref)


@pytest.mark.parametrize("payload", INVALID)
def test_invalid_payloads_raise_the_reference_error(payload):
    with pytest.raises(Exception) as ref:
        ref_protocol.parse_job(payload)
    with pytest.raises(Exception) as got:
        protocol.parse_job(payload)
    assert type(got.value).__name__ == type(ref.value).__name__
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("payload, caps", [
    (spec(L=65), {"max_l": 64}),
    (spec(steps=1001), {"max_steps": 1000}),
    (spec(plotgap=1001), {"max_steps": 1000}),
])
def test_size_caps_equal_the_reference(payload, caps):
    with pytest.raises(Exception) as ref:
        ref_protocol.parse_job(payload, **caps)
    with pytest.raises(Exception) as got:
        protocol.parse_job(payload, **caps)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("n, cap", [(1, 8), (2, 8), (3, 8), (5, 8), (8, 8),
                                    (3, 2), (9, 8), (4, 1)])
def test_pow2_slots_equal_the_reference(n, cap):
    assert scheduler._pow2_slots(n, cap) == ref_scheduler._pow2_slots(n, cap)


def _batch(mod, tmp_path, **kw):
    jobs = [mod.parse_job(spec(seed=11)),
            mod.parse_job(spec(seed=12, params_override={
                "F": 0.04, "k": 0.06, "Du": 0.2, "Dv": 0.1})),
            mod.parse_job(spec(seed=13))]
    return mod.batch_settings(
        jobs, n_slots=4, output=str(tmp_path / "gs.bp"),
        checkpoint_output=str(tmp_path / "ckpt.bp"), names=["a", "b", "c"],
        supervise=True, **kw)


def _fields(settings):
    d = dataclasses.asdict(dataclasses.replace(settings, ensemble=None))
    ens = settings.ensemble
    members = [(m.values, m.seed, m.name, m.active) for m in ens.members]
    return d, ens.describe(), members


def test_batch_settings_on_the_cpu_equal_the_reference(tmp_path):
    got = _batch(protocol, tmp_path, backend="CPU")
    ref = _batch(ref_protocol, tmp_path)
    assert _fields(got) == _fields(ref)
    assert (got.backend, got.kernel_language) == ("CPU", "Plain")
    assert got.ensemble.active == (True, True, True, False)


def test_batch_settings_on_the_card_run_the_kernel(tmp_path):
    """The one deliberate difference: a service on the card runs its
    batches through the kernel, not the reference's CPU/Plain pin."""
    card = _batch(protocol, tmp_path)
    host = _batch(protocol, tmp_path, backend="CPU")
    assert (card.backend, card.kernel_language) == ("CUDA", "CUDA")
    a, b = _fields(card), _fields(host)
    diff = {k for k in a[0] if a[0][k] != b[0][k]}
    assert diff == {"backend", "kernel_language"}
    assert a[1:] == b[1:]
    with pytest.raises(Exception, match="serve backend"):
        _batch(protocol, tmp_path, backend="TPU")


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_batch_settings_refuses_mixed_keys(tmp_path, pkg):
    mod = PKGS[pkg][0]
    a, b = mod.parse_job(spec()), mod.parse_job(spec(L=32))
    with pytest.raises(Exception, match="pack key"):
        mod.batch_settings([a, b], n_slots=2, output=str(tmp_path / "g.bp"),
                           checkpoint_output=str(tmp_path / "c.bp"))


# --------------------------------------------------------------- config

SERVE_VARS = {
    "GS_SERVE_HOST": "0.0.0.0", "GS_SERVE_PORT": "0",
    "GS_SERVE_WORKERS": "3", "GS_SERVE_QUEUE_DEPTH": "9",
    "GS_SERVE_TENANT_QUOTA": "4", "GS_SERVE_PACK_MAX": "2",
    "GS_SERVE_PACK_WINDOW_S": "0.5", "GS_SERVE_SLO_S": "12.5",
    "GS_SERVE_MAX_L": "64", "GS_SERVE_MAX_STEPS": "77",
    "GS_SERVE_STATE_DIR": "/tmp/st", "GS_SERVE_SUPERVISE": "0",
    "GS_SERVE_MAX_REQUEUES": "5", "GS_SERVE_CHAOS": "step=3:kind=preempt",
    "GS_SERVE_SSE_QUEUE": "7", "GS_SERVE_CACHE": "0",
    "GS_CACHE_DIR": "/tmp/cache", "GS_CACHE_VERIFY": "0",
    "GS_SERVE_FLEET_DIR": "/tmp/fleet", "GS_SERVE_REPLICA": "r1",
    "GS_SERVE_FLEET_RANK": "2", "GS_SERVE_LEASE_TTL_S": "4",
    "GS_SERVE_HEARTBEAT_S": "1",
}


def _without_backend(cfg):
    d = cfg.describe()
    assert d.pop("backend") == "CUDA"
    return d


@pytest.fixture
def no_serve_env(monkeypatch):
    for var in SERVE_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_serve_config_defaults_equal_the_reference(no_serve_env):
    assert _without_backend(scheduler.resolve_serve_config()) == (
        ref_scheduler.resolve_serve_config().describe())


@pytest.mark.parametrize("var", sorted(SERVE_VARS))
def test_serve_config_variables_equal_the_reference(no_serve_env, var):
    no_serve_env.setenv(var, SERVE_VARS[var])
    ref = ref_scheduler.resolve_serve_config().describe()
    assert _without_backend(scheduler.resolve_serve_config()) == ref


@pytest.mark.parametrize("env", [
    {"GS_SERVE_WORKERS": "0"},
    {"GS_SERVE_WORKERS": "-1", "GS_SERVE_FLEET_DIR": "/tmp/f"},
    {"GS_SERVE_PACK_MAX": "0"},
    {"GS_SERVE_QUEUE_DEPTH": "0"},
    {"GS_SERVE_TENANT_QUOTA": "0"},
    {"GS_SERVE_PACK_WINDOW_S": "-1"},
    {"GS_SERVE_SSE_QUEUE": "0"},
    {"GS_SERVE_FLEET_RANK": "-1"},
    {"GS_SERVE_LEASE_TTL_S": "0"},
    {"GS_SERVE_HEARTBEAT_S": "10"},
    {"GS_SERVE_HEARTBEAT_S": "0"},
    {"GS_SERVE_PORT": "http"},
])
def test_bad_serve_config_raises_the_reference_error(no_serve_env, env):
    for k, v in env.items():
        no_serve_env.setenv(k, v)
    with pytest.raises(ValueError) as ref:
        ref_scheduler.resolve_serve_config()
    with pytest.raises(ValueError) as got:
        scheduler.resolve_serve_config()
    assert str(got.value) == str(ref.value)


# ------------------------------------------------------------ scheduler


def make_scheduler(pkg, tmp_path, **kw):
    _, sched_mod, null = PKGS[pkg]
    defaults = dict(state_dir=str(tmp_path / pkg), pack_window_s=0.0,
                    supervise=False, cache=False)
    defaults.update(kw)
    cfg = sched_mod.ServeConfig(**defaults)
    if pkg == "port":
        cfg.backend = "CPU"
    return sched_mod.Scheduler(cfg, events=null), sched_mod


def admissions(pkg, tmp_path, cfg, payloads, drain_at=None):
    """The outcome of each submit: the state, or the refusal's type and
    reason."""
    sched, mod = make_scheduler(pkg, tmp_path, **cfg)
    out = []
    for i, p in enumerate(payloads):
        if i == drain_at:
            sched.drain()
        try:
            job = sched.submit(p)
            out.append(("ok", job.state, job.cache))
        except mod.AdmissionError as e:
            out.append(("429", e.reason, e.job.state, e.job.error))
        except Exception as e:  # noqa: BLE001 — compared below
            out.append(("400", type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("cfg, payloads, drain_at", [
    ({"queue_depth": 2}, [spec()] * 3, None),
    ({"tenant_quota": 2, "queue_depth": 100},
     [spec(), spec(), spec(), spec(tenant="bob")], None),
    ({"max_l": 32}, [spec(L=64), spec(L=32), spec(model="nope")], None),
    ({}, [spec(), spec()], 1),
])
def test_admission_equals_the_reference(tmp_path, cfg, payloads, drain_at):
    assert admissions("port", tmp_path, cfg, payloads, drain_at) == (
        admissions("ref", tmp_path, cfg, payloads, drain_at))


def pack_story(pkg, tmp_path):
    """Priorities, packing, cancel, requeue and completion, by submit
    index."""
    sched, _ = make_scheduler(pkg, tmp_path, pack_max=4)
    jobs = [sched.submit(spec(priority="low")),
            sched.submit(spec(priority="high")),
            sched.submit(spec(priority="high", seed=12)),
            sched.submit(spec(priority="high", L=32)),
            sched.submit(spec(seed=40))]
    index = {j.id: i for i, j in enumerate(jobs)}
    story = [("cancel", sched.cancel(jobs[4].id),
              sched.jobs[jobs[4].id].state)]
    b1 = sched.next_batch(timeout=0.0)
    story.append(("batch", [index[j.id] for j in b1.jobs], b1.n_slots,
                  [j.store.rsplit("/", 1)[-1] for j in b1.jobs],
                  sched.cancel(jobs[0].id)))
    b1.settings.faults = "step=5:kind=preempt"
    sched.requeue(b1, fault="preemption")
    story.append(("requeue", b1.attempt, b1.settings.faults,
                  [j.attempts for j in b1.jobs]))
    again = sched.next_batch(timeout=0.0)
    story.append(("resume first", again is b1))
    b2 = sched.next_batch(timeout=0.0)
    story.append(("batch", [index[j.id] for j in b2.jobs], b2.n_slots))
    sched.complete(b1, ok=True, wall_s=1.0)
    sched.complete(b2, ok=False, error="boom")
    st = [sched.status(j.id) for j in jobs]
    story.append(("status", [(s["state"], s["error"], s["attempts"],
                              "request_to_first_step_s" in s) for s in st]))
    story.append(("idle", sched.idle(), sched.status("nope"),
                  sched.describe()["jobs"]))
    return story


def test_priorities_packing_and_requeue_equal_the_reference(tmp_path):
    assert pack_story("port", tmp_path) == pack_story("ref", tmp_path)


def test_reshape_requests_consume_once(tmp_path):
    sched, _ = make_scheduler("port", tmp_path)
    sched.submit(spec())
    batch = sched.next_batch(timeout=0.0)
    assert sched.request_reshape(batch.id, {"scale": "grow"}) is False
    batch.jobs[0].state = "running"
    assert sched.running_batches() == [batch]
    assert sched.request_reshape(batch.id, {"scale": "grow"})
    assert sched.request_reshape(batch.id, {"mesh_dims": [1, 2, 2]})
    assert sched.take_reshape(batch.id) == {"mesh_dims": [1, 2, 2]}
    assert sched.take_reshape(batch.id) is None


def test_chaos_plan_is_consumed_by_the_first_batch(tmp_path):
    sched, _ = make_scheduler("port", tmp_path, pack_max=1,
                              chaos="step=3:kind=preempt", supervise=True)
    sched.submit(spec())
    sched.submit(spec(seed=12))
    first, second = sched.next_batch(0.0), sched.next_batch(0.0)
    assert (first.settings.faults, first.supervise) == (
        "step=3:kind=preempt", False)
    assert (second.settings.faults, second.supervise) == ("", True)
    assert first.settings.backend == "CPU"


# --------------------------------------------------------------- worker


def _settings(tmp_path, backend="CPU", **kw):
    jobs = [protocol.parse_job(spec(seed=s, **kw)) for s in (11, 12)]
    return protocol.batch_settings(
        jobs, n_slots=2, output=str(tmp_path / "gs.bp"),
        checkpoint_output=str(tmp_path / "ckpt.bp"), backend=backend)


def test_warm_key_carries_the_backend(tmp_path):
    """``repack`` does not check the backend, so the key must: a warm
    engine on the card never takes a CPU batch."""
    cpu = _settings(tmp_path)
    card = dataclasses.replace(cpu, backend="CUDA")
    assert worker.warm_key(cpu) != worker.warm_key(card)
    assert worker.warm_key(cpu)[:-1] == worker.warm_key(card)[:-1]
    assert worker.warm_key(_settings(tmp_path, backend="CUDA"))[-1] == "CUDA"
    assert worker.warm_key(cpu) != worker.warm_key(
        _settings(tmp_path, L=32))


def test_warm_engine_is_rebound_and_never_falls_back(tmp_path):
    cfg = scheduler.ServeConfig(state_dir=str(tmp_path), backend="CPU")
    fleet = worker.WorkerFleet(types.SimpleNamespace(), cfg)
    batch = types.SimpleNamespace(warm=False)
    factory = fleet._factory(0, batch)
    first = factory(_settings(tmp_path / "a"), seed=0)
    again = factory(_settings(tmp_path / "b"), seed=0)
    assert again is first and batch.warm and fleet.warm_hits == 1
    assert again.settings.output == str(tmp_path / "b" / "gs.bp")
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            factory(_settings(tmp_path / "c", backend="CUDA"), seed=0)
    assert fleet.warm_hits == 1


# ------------------------------------------------- kernel layer threads


def test_replays_count_per_thread():
    """One worker's SDC replay never counts another worker's launches as
    replays."""
    cuda_stencil.reset_launches()
    inside, go = threading.Event(), threading.Event()

    def replay():
        with cuda_stencil.replaying():
            inside.set()
            go.wait(5)
            cuda_stencil.count_launch("chain", "tma")

    t = threading.Thread(target=replay)
    t.start()
    inside.wait(5)
    cuda_stencil.count_launch("chain", "tma", members=4)
    go.set()
    t.join(10)
    assert not t.is_alive()
    assert (cuda_stencil.LAUNCHES, cuda_stencil.REPLAY_LAUNCHES) == (1, 1)
    assert cuda_stencil.MODE_MEMBERS["chain"] == 4
    cuda_stencil.reset_launches()


def test_launch_counts_are_exact_across_threads():
    """More threads than cores and a short switch interval: a lost
    update of a count would show."""
    import sys

    cuda_stencil.reset_launches()

    def launch():
        for _ in range(1000):
            cuda_stencil.count_launch("chain", "tma", entry="f32",
                                      model="grayscott", members=2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert cuda_stencil.LAUNCHES == 16000
    assert cuda_stencil.MODEL_LAUNCHES["grayscott"] == 16000
    assert sum(cuda_stencil.ENTRY_LAUNCHES.values()) == 16000
    cuda_stencil.reset_launches()


def test_first_use_builds_a_library_once_across_threads(monkeypatch):
    """Threads reaching a kernel's first use at once run one build."""
    calls = []
    active = []

    def fake_build_all(specs=None, envelope=False):
        active.append(1)
        assert len(active) == 1, "two builds ran at once"
        calls.append(list(specs))
        threading.Event().wait(0.05)
        active.pop()
        return {"fake": {"path": "/nonexistent/fake.so"}}

    monkeypatch.setattr(_build, "build_all", fake_build_all)
    monkeypatch.setattr(_build, "target_name", lambda spec, env=False:
                        "fake")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    spec_obj = object()
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        _build.load(spec_obj))) for _ in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
    finally:
        _build._LIBS.pop((spec_obj, False), None)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(got) == 6 and len(set(map(id, got))) == 1
