"""Fault plans and the supervisor's pure functions
(grayscott_jl_tpu_torch/resilience/faults.py, supervisor.py) against
the reference's: ``FaultPlan.parse`` takes and refuses the same specs
with the same messages, the same ``take`` calls fire the same faults,
``restart_backoff`` sleeps the same schedule, ``classify_failure`` maps
every exception class of the taxonomy to the same class (the port's
kernel errors where the reference has Mosaic's), and the knobs resolve
and refuse as the reference's."""

import errno
import signal

import pytest

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.io.async_writer import AsyncIOError as RefAsyncIOError
from grayscott_jl_tpu.resilience import faults as ref_faults
from grayscott_jl_tpu.resilience import health as ref_health
from grayscott_jl_tpu.resilience import integrity as ref_integrity
from grayscott_jl_tpu.resilience import sdc as ref_sdc
from grayscott_jl_tpu.resilience import supervisor as ref_sup
from grayscott_jl_tpu.resilience import watchdog as ref_wd
from grayscott_jl_tpu_torch import Settings
from grayscott_jl_tpu_torch.io.async_writer import AsyncIOError, with_io_fault
from grayscott_jl_tpu_torch.ops._build import KernelBuildError
from grayscott_jl_tpu_torch.ops.cuda_stencil import KernelLaunchError
from grayscott_jl_tpu_torch.resilience import faults, health, integrity, sdc
from grayscott_jl_tpu_torch.resilience import supervisor as sup
from grayscott_jl_tpu_torch.resilience import watchdog

GOOD_SPECS = [
    "",
    "step=120:kind=io_error",
    "step=120:kind=io_error;step=300:kind=nan;step=500:kind=preempt",
    " step = 5 : kind = hang ; ;step=0:kind=kernel; ",
    "step=9:kind=bitflip;step=9:kind=ckpt_corrupt;step=3:kind=drift",
    "step=40:kind=sdc;step=20:kind=sdc",
    "kind=nan:step=7",
]

BAD_SPECS = [
    "step=1",
    "kind=nan",
    "step=1:kind=nan:member=2",
    "step=x:kind=nan",
    "step=-1:kind=nan",
    "step=1:kind=meteor",
    "step=1;kind=nan",
    "step1:kind=nan",
    "step=1:kind=nan;step=2:kind=oom",
]


def test_fault_kinds_and_exit_codes_are_the_references():
    assert faults.FAULT_KINDS == ref_faults.FAULT_KINDS
    assert len(faults.FAULT_KINDS) == 9
    assert (faults.EXIT_PREEMPTED, faults.EXIT_HANG) == (
        ref_faults.EXIT_PREEMPTED, ref_faults.EXIT_HANG) == (75, 76)
    assert sup.RESUME_MARKERS == ref_sup.RESUME_MARKERS


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_takes_the_references_specs(spec):
    assert (faults.FaultPlan.parse(spec).describe()
            == ref_faults.FaultPlan.parse(spec).describe())
    assert len(faults.FaultPlan.parse(spec)) == len(
        ref_faults.FaultPlan.parse(spec))


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_refuses_with_the_references_message(spec):
    with pytest.raises(ValueError) as a:
        faults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as b:
        ref_faults.FaultPlan.parse(spec)
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("env,key", [
    (None, ""), (None, "step=3:kind=nan"), ("step=4:kind=hang", "step=3:kind=nan"),
    ("", "step=3:kind=nan"),
])
def test_from_env_reads_the_variable_then_the_key(monkeypatch, env, key):
    if env is None:
        monkeypatch.delenv("GS_FAULTS", raising=False)
    else:
        monkeypatch.setenv("GS_FAULTS", env)
    assert (faults.FaultPlan.from_env(Settings(faults=key)).describe()
            == ref_faults.FaultPlan.from_env(RefSettings(faults=key))
            .describe())


def test_take_sequences_fire_as_the_references():
    spec = ("step=20:kind=nan;step=25:kind=io_error;step=40:kind=nan;"
            "step=45:kind=preempt;step=45:kind=sdc;step=0:kind=kernel")
    port, ref = faults.FaultPlan.parse(spec), ref_faults.FaultPlan.parse(spec)
    calls = [("nan", 10), ("kernel", 10), ("nan", 30), ("io_error", 30),
             ("nan", 30), ("preempt", 40), ("nan", 50), ("preempt", 50),
             ("sdc", 60), ("sdc", 60), ("hang", 60), ("io_error", 70)]
    for kind, step in calls:
        a, b = port.take(kind, step), ref.take(kind, step)
        assert (a.describe() if a else None) == (b.describe() if b else None)
        assert ([f.describe() for f in port.pending()]
                == [f.describe() for f in ref.pending()])
    assert port.describe() == ref.describe()
    assert not port.pending() and port.pending("nan") == []


@pytest.mark.parametrize("attempt", [0, 1, 2, 5, 9])
@pytest.mark.parametrize("kind", ["transient-io", "preemption", "hang",
                                  "health", "kernel", "sdc"])
@pytest.mark.parametrize("base", [None, "0", "0.01", "2"])
def test_restart_backoff_is_the_references(monkeypatch, attempt, kind, base):
    if base is None:
        monkeypatch.delenv("GS_RESTART_BACKOFF_S", raising=False)
    else:
        monkeypatch.setenv("GS_RESTART_BACKOFF_S", base)
    assert sup.restart_backoff(attempt, kind) == ref_sup.restart_backoff(
        attempt, kind)


@pytest.mark.parametrize("value", ["-1", "soon"])
def test_bad_backoff_raises_as_the_reference(monkeypatch, value):
    monkeypatch.setenv("GS_RESTART_BACKOFF_S", value)
    with pytest.raises(ValueError) as a:
        sup.restart_backoff(0, "hang")
    with pytest.raises(ValueError) as b:
        ref_sup.restart_backoff(0, "hang")
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("env,key", [(None, 3), (None, 0), ("7", 3),
                                     ("-1", 3), ("x", 3), (None, -2)])
def test_resolve_max_restarts_is_the_references(monkeypatch, env, key):
    if env is None:
        monkeypatch.delenv("GS_MAX_RESTARTS", raising=False)
    else:
        monkeypatch.setenv("GS_MAX_RESTARTS", env)
    try:
        want = ref_sup.resolve_max_restarts(RefSettings(max_restarts=key))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            sup.resolve_max_restarts(Settings(max_restarts=key))
        assert str(got.value) == str(e)
        return
    assert sup.resolve_max_restarts(Settings(max_restarts=key)) == want


@pytest.mark.parametrize("env,key", [(None, False), (None, True), ("1", False),
                                     ("off", True), ("maybe", False)])
def test_supervision_enabled_is_the_references(monkeypatch, env, key):
    if env is None:
        monkeypatch.delenv("GS_SUPERVISE", raising=False)
    else:
        monkeypatch.setenv("GS_SUPERVISE", env)
    try:
        want = ref_sup.supervision_enabled(RefSettings(supervise=key))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            sup.supervision_enabled(Settings(supervise=key))
        assert str(got.value) == str(e)
        return
    assert sup.supervision_enabled(Settings(supervise=key)) == want


def _report(mod):
    return mod.HealthReport(False, float("nan"), 1.0, 0.0, 1.0)


#: (port exception, the reference's counterpart): every class of the
#: taxonomy and a few fatal ones.
TAXONOMY = [
    (lambda: sdc.SDCError("x", step=8, verified_step=4, device="cuda:0"),
     lambda: ref_sdc.SDCError("x", step=8, verified_step=4,
                              device="cpu:0")),
    (lambda: faults.PreemptionError("p"),
     lambda: ref_faults.PreemptionError("p")),
    (lambda: faults.GracefulShutdown(signal.SIGTERM, 10, 10),
     lambda: ref_faults.GracefulShutdown(signal.SIGTERM, 10, 10)),
    (lambda: watchdog.HangError("io", 3, 1.0),
     lambda: ref_wd.HangError("io", 3, 1.0)),
    (lambda: health.HealthError(3, _report(health), "rollback"),
     lambda: ref_health.HealthError(3, _report(ref_health), "rollback")),
    (lambda: health.HealthError(3, _report(health), "abort"),
     lambda: ref_health.HealthError(3, _report(ref_health), "abort")),
    (lambda: health.DriftError(3, {"tripped": {"u.max": 0.9},
                                   "limit": 0.5}, "rollback"),
     lambda: ref_health.DriftError(3, {"tripped": {"u.max": 0.9},
                                       "limit": 0.5}, "rollback")),
    (lambda: health.DriftError(3, {"tripped": {}, "limit": 0.5}, "abort"),
     lambda: ref_health.DriftError(3, {"tripped": {}, "limit": 0.5},
                                   "abort")),
    (lambda: faults.InjectedKernelError(25),
     lambda: ref_faults.InjectedKernelError(25)),
    (lambda: KernelBuildError("CUDA kernel build failed"),
     lambda: ref_faults.InjectedKernelError(0)),
    (lambda: KernelLaunchError("stencil_chain launch failed", code=1),
     lambda: ref_faults.InjectedKernelError(0)),
    (lambda: integrity.CorruptionError("crc", step=3, var="u"),
     lambda: ref_integrity.CorruptionError("crc", step=3, var="u")),
    (lambda: AsyncIOError(30, integrity.CorruptionError("c", step=30)),
     lambda: RefAsyncIOError(30, ref_integrity.CorruptionError("c",
                                                               step=30))),
    (lambda: AsyncIOError(30, faults.InjectedIOError("disk")),
     lambda: RefAsyncIOError(30, ref_faults.InjectedIOError("disk"))),
    (lambda: AsyncIOError(30, ValueError("bad")),
     lambda: RefAsyncIOError(30, ValueError("bad"))),
    (lambda: OSError(errno.EIO, "disk"), lambda: OSError(errno.EIO, "disk")),
    (lambda: ValueError("config"), lambda: ValueError("config")),
    (lambda: KeyboardInterrupt(), lambda: KeyboardInterrupt()),
    (lambda: RuntimeError("CUDA error: out of memory"),
     lambda: RuntimeError("XLA out of memory")),
]


@pytest.mark.parametrize("port,ref", TAXONOMY)
def test_classify_failure_is_the_references(port, ref):
    assert sup.classify_failure(port()) == ref_sup.classify_failure(ref())


def test_kernel_errors_name_the_cuda_kernel_and_stickiness():
    assert "CUDA kernel" in str(faults.InjectedKernelError(25))
    assert "Mosaic" not in str(faults.InjectedKernelError(25))
    assert faults.InjectedKernelError(25).step == 25
    assert KernelLaunchError("x", code=700).sticky
    assert not KernelLaunchError("x", code=1).sticky
    assert not KernelLaunchError("x").sticky
    assert sup.context_lost(KernelLaunchError("x", code=719))
    assert sup.context_lost(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    assert not sup.context_lost(faults.InjectedKernelError(3))
    assert not sup.context_lost(RuntimeError("CUDA error: out of memory"))


@pytest.mark.parametrize("make,sticky", [
    (lambda: KernelBuildError("nvcc not found (looked in $CUDA_HOME/bin, "
                              "PATH and /usr/local/cuda/bin)"), False),
    (lambda: KernelLaunchError("stencil_chain launch failed: CUDA error "
                               "1: invalid argument", code=1), False),
    (lambda: KernelLaunchError("the 'grayscott' kernel's (tile, fields, "
                               "params) != the ledger's"), False),
    (lambda: faults.InjectedKernelError(25), False),
    (lambda: KernelLaunchError("stencil_chain launch failed: CUDA error "
                               "700: an illegal memory access", code=700),
     True),
], ids=["build", "launch", "layout", "injected", "sticky"])
def test_kernel_failures_stay_fatal_under_supervision(monkeypatch, make,
                                                      sticky):
    """A kernel that does not build or launch stops a supervised run at
    its first attempt, with ``gave_up`` journaled, the error re-raised
    and the settings' kernel language untouched: the port never goes on
    without its kernels (the reference degrades Pallas to XLA here)."""
    from grayscott_jl_tpu_torch import Settings
    from grayscott_jl_tpu_torch import driver as driver_mod

    for var in ("GS_FAULTS", "GS_FAULT_JOURNAL", "GS_SUPERVISE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("GS_RESTART_BACKOFF_S", "0")
    monkeypatch.setenv("GS_MAX_RESTARTS", "3")
    exc = make()
    calls = []

    def fake_run_once(settings, **kw):
        calls.append(settings.kernel_language)
        raise exc

    monkeypatch.setattr(driver_mod, "run_once", fake_run_once)
    events = []
    monkeypatch.setattr(sup.FaultJournal, "record",
                        lambda self, **e: events.append(e) or e)
    settings = Settings(L=8, backend="CPU", precision="Float32")
    lang = settings.kernel_language
    with pytest.raises(type(exc)) as got:
        sup.supervise(settings)
    assert got.value is exc and calls == [lang]
    assert settings.kernel_language == lang and not settings.restart
    assert [(e["event"], e["kind"]) for e in events] == [
        ("gave_up", "kernel")]
    assert type(exc).__name__ in events[0]["error"]
    assert ("device context lost" if sticky else "kernel failure") in (
        events[0]["reason"])


def test_io_fault_raises_inside_the_target_once():
    plan = faults.FaultPlan.parse("step=25:kind=io_error")

    class J:
        events = []

        def record(self, **e):
            self.events.append(e)

    j = J()
    written = []
    target = with_io_fault(plan, j, lambda step, blocks: written.append(step))
    target(20, None)
    with pytest.raises(faults.InjectedIOError, match="step 30 .planned "
                                                     "step 25"):
        target(30, None)
    target(30, None)
    assert written == [20, 30] and not plan.pending()
    assert j.events == [{"event": "injected", "kind": "io_error", "step": 30,
                         "planned_step": 25}]
    assert sup.classify_failure(AsyncIOError(30, faults.InjectedIOError(
        "x"))) == "transient-io"


def test_latest_durable_checkpoint_caps_at_the_verified_step(tmp_path):
    """The resume step is the latest entry any replica holds, at most
    ``max_step``; none without checkpoints."""
    from grayscott_jl_tpu_torch import driver

    out = tmp_path / "gs.bp"
    s = Settings(L=8, backend="CPU", precision="Float32", steps=30,
                 plotgap=10, checkpoint=True, checkpoint_freq=10,
                 output=str(out), checkpoint_output=str(tmp_path / "c.bp"))
    driver.run_once(s)
    assert sup.latest_durable_checkpoint(s) == 30
    assert sup.latest_durable_checkpoint(s, max_step=25) == 20
    assert sup.latest_durable_checkpoint(
        Settings(checkpoint=False)) is None
