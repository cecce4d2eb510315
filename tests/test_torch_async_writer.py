"""The output pipeline (grayscott_jl_tpu_torch/io/async_writer.py)
against the reference's (grayscott_jl_tpu/io/async_writer.py): the
thirteen cases of the reference's own unit tests, each run on both
modules (``impl``), so the port keeps its step ordering, backpressure,
error surfacing on the driver thread, draining close, synchronous
fallback and overlap accounting; then what the port adds, ``reserve``
(the guard of the snapshots' host-buffer ring)."""

import threading
import time

import pytest

from grayscott_jl_tpu.io import async_writer as ref_async_writer
from grayscott_jl_tpu_torch.io import async_writer


@pytest.fixture(params=["port", "reference"])
def impl(request):
    return async_writer if request.param == "port" else ref_async_writer


class FakeSnapshot:
    """Stands in for ``simulation.FieldSnapshot``: ``blocks()`` may
    sleep (a D2H transfer still in flight) before resolving."""

    def __init__(self, payload, delay=0.0):
        self.payload = payload
        self.delay = delay
        self.resolved_on = None

    def blocks(self):
        if self.delay:
            time.sleep(self.delay)
        self.resolved_on = threading.current_thread()
        return self.payload


def make_sink(record):
    def sink(step, blocks):
        record.append((step, blocks, threading.current_thread()))

    return sink


# ----------------------------------------------------------- depth knob


def test_depth_from_env(impl, monkeypatch):
    monkeypatch.setenv("GS_ASYNC_IO_DEPTH", "5")
    assert impl.resolve_depth() == 5
    monkeypatch.setenv("GS_ASYNC_IO_DEPTH", "0")
    assert impl.resolve_depth() == 0
    monkeypatch.delenv("GS_ASYNC_IO_DEPTH")
    assert impl.resolve_depth() == 2  # documented default: double buffering


def test_bad_depth_rejected(impl, monkeypatch):
    monkeypatch.setenv("GS_ASYNC_IO_DEPTH", "two")
    with pytest.raises(ValueError, match="GS_ASYNC_IO_DEPTH"):
        impl.resolve_depth()
    with pytest.raises(ValueError, match="non-negative"):
        impl.AsyncStepWriter(depth=-1)


# ------------------------------------------------------------- ordering


def test_steps_written_in_submission_order_despite_slow_early_d2h(impl):
    """Step ordering is by submission, not by D2H completion: an early
    snapshot whose transfer lands LATE must still be written first."""
    record = []
    w = impl.AsyncStepWriter(depth=4)
    w.submit(10, FakeSnapshot("a", delay=0.15), [("output", make_sink(record))])
    w.submit(20, FakeSnapshot("b"), [("output", make_sink(record))])
    w.submit(30, FakeSnapshot("c"), [("output", make_sink(record))])
    w.close()
    assert [(s, p) for s, p, _ in record] == [(10, "a"), (20, "b"), (30, "c")]
    assert w.steps_written == 3


def test_writes_happen_off_the_driver_thread(impl):
    record = []
    snap = FakeSnapshot("x")
    w = impl.AsyncStepWriter(depth=2)
    w.submit(1, snap, [("output", make_sink(record))])
    w.close()
    (step, _, wrote_on), = record
    assert step == 1
    assert wrote_on is not threading.main_thread()
    assert snap.resolved_on is wrote_on  # D2H resolution also off-driver


# --------------------------------------------------------- backpressure


def test_backpressure_blocks_submit_at_depth(impl):
    """With depth=1 and the worker wedged, the (worker-held + queued)
    budget is 2 items; the third submit must block until the worker
    frees a slot."""
    release = threading.Event()
    record = []

    def slow_sink(step, blocks):
        release.wait(timeout=10)
        record.append(step)

    w = impl.AsyncStepWriter(depth=1)
    w.submit(1, FakeSnapshot("a"), [("output", slow_sink)])
    w.submit(2, FakeSnapshot("b"), [("output", slow_sink)])  # fills queue

    done = threading.Event()

    def third():
        w.submit(3, FakeSnapshot("c"), [("output", slow_sink)])
        done.set()

    t = threading.Thread(target=third, daemon=True)
    t.start()
    assert not done.wait(timeout=0.3), "submit #3 should be backpressured"
    release.set()
    assert done.wait(timeout=10)
    w.close()
    t.join(timeout=10)
    assert record == [1, 2, 3]
    assert w.overlap_stats()["queue_depth_hwm"] >= 1


# ----------------------------------------------------- error propagation


def test_writer_error_surfaces_on_next_submit_with_failing_step(impl):
    def bad(step, blocks):
        raise OSError("disk gone")

    w = impl.AsyncStepWriter(depth=2)
    w.submit(10, FakeSnapshot("a"), [("output", bad)])
    with pytest.raises(impl.AsyncIOError, match="step 10") as ei:
        # the worker needs a moment to hit the failure; submit retries
        # until the error is visible
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            w.submit(20, FakeSnapshot("b"), [("output", bad)])
            time.sleep(0.01)
    assert isinstance(ei.value.original, OSError)
    assert ei.value.step == 10
    # surfaced once: close() must not raise again (it would mask the
    # driver's in-flight exception in a finally block)
    w.close()
    # ...but the pipeline stays dead-loud for further submissions
    with pytest.raises(RuntimeError, match="already failed"):
        w.submit(30, FakeSnapshot("c"), [("output", bad)])


def test_writer_error_surfaces_at_close_and_discards_later_steps(impl):
    record = []

    def bad_then_good(step, blocks):
        if step == 1:
            raise ValueError("boom")
        record.append(step)

    w = impl.AsyncStepWriter(depth=4)
    w.submit(1, FakeSnapshot("a"), [("output", bad_then_good)])
    w.submit(2, FakeSnapshot("b"), [("output", bad_then_good)])
    with pytest.raises(impl.AsyncIOError, match="step 1"):
        w.close()
    # step 2 was discarded, not written after a hole
    assert record == []


def test_snapshot_resolution_error_also_propagates(impl):
    class BadSnapshot:
        def blocks(self):
            raise RuntimeError("transfer failed")

    w = impl.AsyncStepWriter(depth=2)
    w.submit(5, BadSnapshot(), [("output", make_sink([]))])
    with pytest.raises(impl.AsyncIOError, match="step 5"):
        w.close()


# ------------------------------------------------------ drain-on-close


def test_close_drains_every_accepted_step(impl):
    record = []

    def slow_sink(step, blocks):
        time.sleep(0.02)
        record.append(step)

    w = impl.AsyncStepWriter(depth=3)
    steps = list(range(8))
    for s in steps:
        w.submit(s, FakeSnapshot(s), [("output", slow_sink)])
    w.close()  # must block until all 8 are durable
    assert record == steps
    st = w.overlap_stats()
    assert st["steps_accepted"] == st["steps_written"] == 8
    w.close()  # idempotent


def test_context_manager_on_abort_drains_without_masking(impl):
    """An unrelated driver exception must propagate even if the writer
    also failed (the writer error is swallowed by __exit__)."""

    def bad(step, blocks):
        raise OSError("writer died")

    with pytest.raises(KeyError, match="driver bug"):
        with impl.AsyncStepWriter(depth=2) as w:
            w.submit(1, FakeSnapshot("a"), [("output", bad)])
            raise KeyError("driver bug")


# -------------------------------------------------- synchronous fallback


def test_depth_zero_writes_inline_on_driver_thread(impl):
    record = []
    w = impl.AsyncStepWriter(depth=0)
    assert w.synchronous
    snap = FakeSnapshot("x")
    w.submit(1, snap, [("output", make_sink(record))])
    (step, payload, wrote_on), = record
    assert (step, payload) == (1, "x")
    assert wrote_on is threading.current_thread()
    assert snap.resolved_on is threading.current_thread()
    w.close()
    st = w.overlap_stats()
    # synchronous: everything is exposed by construction
    assert st["hidden_s"].get("output", 0.0) == 0.0
    assert st["steps_written"] == 1


def test_depth_zero_error_propagates_at_submit_directly(impl):
    def bad(step, blocks):
        raise OSError("disk gone")

    w = impl.AsyncStepWriter(depth=0)
    with pytest.raises(OSError, match="disk gone"):
        w.submit(1, FakeSnapshot("a"), [("output", bad)])


# ---------------------------------------------------- overlap accounting


def test_overlap_stats_split_hidden_vs_exposed(impl):
    """Writes that drain while the driver is busy elsewhere count as
    hidden; busy == hidden + exposed per phase."""
    w = impl.AsyncStepWriter(depth=4)
    for s in range(3):
        w.submit(s, FakeSnapshot(s),
                 [("output", lambda *_: time.sleep(0.03))])
    time.sleep(0.3)  # driver "computes" while the worker drains
    w.close()
    st = w.overlap_stats()
    busy = st["busy_s"]["output"]
    assert busy > 0
    # busy/hidden/exposed are each independently rounded to 6 decimals
    # in overlap_stats, so the identity holds only to the rounding
    # quantum (1e-9 here flaked whenever the thirds rounded apart).
    assert st["hidden_s"]["output"] == pytest.approx(
        busy - st["exposed_s"]["output"], abs=2e-6
    )
    # the writes fully drained behind the sleep: nearly all hidden
    assert st["hidden_s"]["output"] > 0


# ------------------------------------------------ the port's additions


def test_error_message_and_stats_keys_match_the_reference():
    err = async_writer.AsyncIOError(7, OSError("disk gone"))
    ref = ref_async_writer.AsyncIOError(7, OSError("disk gone"))
    assert str(err) == str(ref) and err.transient and ref.transient
    assert not async_writer.AsyncIOError(7, ValueError("x")).transient
    stats = []
    for mod in (async_writer, ref_async_writer):
        w = mod.AsyncStepWriter(depth=2)
        w.submit(1, FakeSnapshot("a"), [("output", make_sink([]))])
        w.close()
        stats.append(w.overlap_stats())
    assert stats[0].keys() == stats[1].keys()
    assert (stats[0]["steps_written"], stats[0]["depth"]) == (
        stats[1]["steps_written"], stats[1]["depth"]) == (1, 2)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_reserve_keeps_at_most_depth_plus_one_steps_unwritten(depth):
    """reserve() returns only once at most ``depth`` accepted steps are
    unwritten, so the next snapshot is at most the ``depth + 1``-th in
    flight: a ring of ``depth + 1`` host buffers is never overwritten
    while a write reads it."""
    release = threading.Event()
    in_flight = []
    w = async_writer.AsyncStepWriter(depth=depth)

    def sink(step, blocks):
        release.wait(timeout=10)

    for s in range(depth + 1):
        w.reserve()
        w.submit(s, FakeSnapshot(s), [("output", sink)])
    done = threading.Event()

    def reserve():
        w.reserve()
        in_flight.append(w.overlap_stats()["steps_accepted"]
                         - w.steps_written)
        done.set()

    t = threading.Thread(target=reserve, daemon=True)
    t.start()
    assert not done.wait(timeout=0.3), "reserve should wait for a write"
    release.set()
    assert done.wait(timeout=10)
    t.join(timeout=10)
    w.close()
    assert in_flight[0] <= depth
    assert w.overlap_stats()["submit_wait_s"] > 0


def test_reserve_returns_at_depth_zero_and_after_an_error():
    w = async_writer.AsyncStepWriter(depth=0)
    w.reserve()  # synchronous: nothing is ever unwritten
    w.close()

    release = threading.Event()

    def bad(step, blocks):
        release.wait(timeout=10)
        raise OSError("disk gone")

    w = async_writer.AsyncStepWriter(depth=1)
    w.submit(1, FakeSnapshot("a"), [("output", bad)])
    w.submit(2, FakeSnapshot("b"), [("output", bad)])
    timer = threading.Timer(0.1, release.set)
    timer.start()
    w.reserve()  # two unwritten at depth 1: returns once step 1 failed
    timer.join()
    with pytest.raises(async_writer.AsyncIOError, match="step 1"):
        w.close()
