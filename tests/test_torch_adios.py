"""The port's ADIOS2 engine and its rollback sidecar (io/adios.py,
io/sidecar.py, the store selection of io/__init__.py) on the CPU, held
against the reference's (grayscott_jl_tpu/io) through the strict adios2
API fake of tests/support/adios2_fake.

The reference's contract and engine tests have counterparts here; every
case of the store selection gives the same engine, step count, reader
or refusal in both packages; a store either package writes through the
adapter reads back in the other; and the slice — the CLI's output store
through the adapter, a restart onto it, a rollback restart into its
sidecar (by ``restart_step`` and by the supervisor's ``rollback`` plan),
pdfcalc and gdsplot over the merged store — is held to a live reference
run within ``atol 1e-6`` and, within the port, bitwise to BP-lite and to
the uninterrupted run. The two tests of the genuine wheel skip where it
is not importable (here, and on the card's machine)."""

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

from grayscott_jl_tpu import io as ref_io
from grayscott_jl_tpu.io import adios as ref_adios
from grayscott_jl_tpu.io import sidecar as ref_sidecar  # noqa: F401
from grayscott_jl_tpu_torch import io as port_io
from grayscott_jl_tpu_torch.io import adios, sidecar
from grayscott_jl_tpu_torch.io.bplite import BpReader, BpWriter, StepStatus


ATOL = 1e-6


@pytest.fixture
def wheel():
    """The reference's ``requires_adios2`` gate, decided when the test
    runs: the genuine bindings, else a skip (here and on the card's
    machine, where none is installed)."""
    adios.available.cache_clear()
    if not adios.available():
        pytest.skip("needs the adios2 python bindings")


@pytest.fixture
def fake(fake_adios2):
    """The fake installed as ``adios2`` (the reference's fixture, which
    resets the reference's cache) with the port's cache reset too."""
    adios.available.cache_clear()
    yield fake_adios2
    adios.available.cache_clear()


def _write_store(io_mod, path, *, steps=3, L=8, append=False):
    """The reference contract tests' store: three attributes, a step
    scalar and two fields, U put as two half blocks."""
    w = io_mod.open_writer(path, append=append)
    w.define_attribute("F", 0.02)
    w.define_attribute("name", "gray-scott")
    w.define_attribute("Fides_Origin", [0.0, 0.0, 0.0])
    w.define_variable("step", np.int32)
    w.define_variable("U", np.float32, (L, L, L))
    w.define_variable("V", np.float32, (L, L, L))
    base = 100 if append else 0
    for s in range(steps):
        w.begin_step()
        w.put("step", np.int32(base + s * 10))
        full = np.full((L, L, L), float(base + s), np.float32)
        w.put("U", full[:L // 2], start=(0, 0, 0), count=(L // 2, L, L))
        w.put("U", full[L // 2:], start=(L // 2, 0, 0),
              count=(L // 2, L, L))
        w.put("V", 0.5 * full)
        w.end_step()
    w.close()


def _steps(r):
    return [int(r.get("step", step=i)) for i in range(r.num_steps())]


# ----------------------------------------- the reference's contract tests


def test_engine_selection_prefers_adios2(fake, tmp_path):
    assert adios.available()
    path = str(tmp_path / "out.bp")
    w = port_io.open_writer(path)
    assert isinstance(w, adios.Adios2Writer) and w.engine == "adios2"
    w.define_variable("step", np.int32)
    w.begin_step()
    w.put("step", np.int32(1))
    w.end_step()
    w.close()
    r = port_io.open_reader(path)
    assert isinstance(r, adios.Adios2Reader)
    r.close()


def test_roundtrip_attributes_variables_and_random_access(fake, tmp_path):
    path = str(tmp_path / "out.bp")
    _write_store(port_io, path)
    with port_io.open_reader(path) as r:
        attrs = r.attributes()
        assert attrs["F"] == 0.02 and attrs["name"] == "gray-scott"
        assert list(attrs["Fides_Origin"]) == [0.0, 0.0, 0.0]
        info = r.available_variables()
        # adios2 spells float32 "float", which numpy reads as float64.
        assert info["U"].dtype == np.float32
        assert info["U"].shape == (8, 8, 8)
        assert r.num_steps() == 3
        u = r.get("U", step=2)
        assert u.dtype == np.float32
        np.testing.assert_array_equal(u, np.full((8, 8, 8), 2.0, np.float32))
        assert int(r.get("step", step=1)) == 10
        box = r.get("U", step=1, start=(2, 0, 4), count=(3, 8, 2))
        np.testing.assert_array_equal(box,
                                      np.full((3, 8, 2), 1.0, np.float32))


def test_streaming_loop(fake, tmp_path):
    path = str(tmp_path / "out.bp")
    _write_store(port_io, path, steps=2, L=4)
    r = port_io.open_reader(path)
    seen = []
    while r.begin_step(timeout=2.0) == StepStatus.OK:
        seen.append(int(r.get("step")))
        r.end_step()
    assert seen == [0, 10]
    assert r.begin_step(timeout=0.5) == StepStatus.END_OF_STREAM
    r.close()


def test_restart_append_continues_real_bp_store(fake, tmp_path):
    path = str(tmp_path / "out.bp")
    _write_store(port_io, path, steps=2, L=4)
    assert port_io._real_bp_evidence(path)
    _write_store(port_io, path, steps=2, L=4, append=True)
    with port_io.open_reader(path) as r:
        assert _steps(r) == [0, 10, 100, 110]


def test_rollback_append_routes_to_sidecar(fake, tmp_path):
    path = str(tmp_path / "out.bp")
    _write_store(port_io, path, steps=3, L=4)
    w = port_io.open_writer(path, append=True, keep_steps=1)
    assert not isinstance(w, adios.Adios2Writer)
    assert w.engine in ("native", "python")
    assert sidecar.read_keep_base(path) == 1
    w.define_variable("step", np.int32)
    w.define_variable("U", np.float32, (4, 4, 4))
    for s in (10, 20):
        w.begin_step()
        w.put("step", np.int32(s + 1000))
        w.put("U", np.full((4, 4, 4), float(s), np.float32))
        w.end_step()
    w.close()

    r = port_io.open_reader(path)
    assert isinstance(r, sidecar.MergedReader)
    assert _steps(r) == [0, 1010, 1020]
    np.testing.assert_array_equal(r.get("U", step=0),
                                  np.zeros((4, 4, 4), np.float32))
    box = r.get("U", step=2, start=(1, 0, 0), count=(2, 4, 4))
    np.testing.assert_array_equal(box, np.full((2, 4, 4), 20.0, np.float32))
    seen = []
    while r.begin_step(timeout=2.0) == StepStatus.OK:
        seen.append(int(r.get("step")))
        r.end_step()
    assert seen == [0, 1010, 1020]
    r.close()
    assert port_io.count_steps_upto(path, 1010) == 2


def test_second_rollback_within_sidecar(fake, tmp_path):
    path = str(tmp_path / "out.bp")
    _write_store(port_io, path, steps=3, L=4)

    def extend(keep, tags):
        w = port_io.open_writer(path, append=True, keep_steps=keep)
        w.define_variable("step", np.int32)
        for t in tags:
            w.begin_step()
            w.put("step", np.int32(t))
            w.end_step()
        w.close()

    extend(2, [30, 40])
    extend(3, [50])
    with port_io.open_reader(path) as r:
        assert _steps(r) == [0, 10, 30, 50]
    extend(1, [60])
    assert sidecar.read_keep_base(path) == 1
    with port_io.open_reader(path) as r:
        assert _steps(r) == [0, 60]


def test_append_to_missing_store_discards_orphaned_sidecar(fake, tmp_path):
    path = str(tmp_path / "out.bp")
    _write_store(port_io, path, steps=3, L=4)
    port_io.open_writer(path, append=True, keep_steps=1).close()
    shutil.rmtree(path)
    assert sidecar.read_keep_base(path) == 1

    w = port_io.open_writer(path, append=True)
    assert isinstance(w, adios.Adios2Writer)
    assert sidecar.read_keep_base(path) is None
    w.define_variable("step", np.int32)
    w.begin_step()
    w.put("step", np.int32(5))
    w.end_step()
    w.close()
    assert port_io._real_bp_evidence(path)
    r = port_io.open_reader(path)
    assert not isinstance(r, sidecar.MergedReader)
    assert r.num_steps() == 1
    r.close()


def test_live_reader_survives_sidecar_metadata_window(fake, tmp_path):
    path = str(tmp_path / "out.bp")
    _write_store(port_io, path, steps=2, L=4)
    sidecar.write_keep_base(path, 1)  # the marker, no sidecar metadata yet

    r = port_io.open_reader(path, live=True)
    assert r.begin_step(timeout=2.0) == StepStatus.OK
    assert int(r.get("step")) == 0
    r.end_step()
    assert r.begin_step(timeout=0.1) == StepStatus.NOT_READY

    w = BpWriter(sidecar.sidecar_path(path))
    w.define_variable("step", np.int32)
    w.begin_step()
    w.put("step", np.int32(77))
    w.end_step()
    w.close()

    assert r.begin_step(timeout=5.0) == StepStatus.OK
    assert int(r.get("step")) == 77
    r.end_step()
    assert r.begin_step(timeout=1.0) == StepStatus.END_OF_STREAM
    r.close()


def test_fresh_write_removes_stale_sidecar(fake, tmp_path):
    path = str(tmp_path / "out.bp")
    _write_store(port_io, path, steps=3, L=4)
    w = port_io.open_writer(path, append=True, keep_steps=1)
    w.define_variable("step", np.int32)
    w.begin_step()
    w.put("step", np.int32(99))
    w.end_step()
    w.close()
    assert sidecar.read_keep_base(path) == 1

    _write_store(port_io, path, steps=2, L=4)
    assert sidecar.read_keep_base(path) is None
    r = port_io.open_reader(path)
    assert not isinstance(r, sidecar.MergedReader)
    assert r.num_steps() == 2
    r.close()


def test_live_reader_dispatches_to_adios2(fake, tmp_path):
    path = str(tmp_path / "later.bp")
    r = port_io.open_reader(path, live=True)
    assert r.begin_step(timeout=0.05) == StepStatus.NOT_READY
    _write_store(port_io, path, steps=1, L=4)
    assert r.begin_step(timeout=5.0) == StepStatus.OK
    assert isinstance(r._inner, adios.Adios2Reader)
    assert int(r.get("step")) == 0
    r.end_step()
    r.close()


def test_pdfcalc_workflow_over_adios2_stores(fake, tmp_path):
    """pdfcalc streams a real store and writes its output through the
    adapter; two workers' output store stays on BP-lite."""
    from grayscott_jl_tpu_torch.analysis.pdfcalc import read_data_write_pdf

    inp = str(tmp_path / "sim.bp")
    _write_store(port_io, inp, steps=3, L=8)
    out = str(tmp_path / "pdf.bp")
    assert read_data_write_pdf(inp, out, nbins=10, max_not_ready=2,
                               device="cpu") == 3
    assert port_io._real_bp_evidence(out)
    with port_io.open_reader(out) as r:
        assert r.num_steps() == 3
        assert r.get("U/bins", step=0).shape == (10,)
        pdf = r.get("U/pdf", step=1)
        assert pdf.shape == (8, 10)
        assert np.isfinite(pdf).all() and (pdf >= 0).all() and pdf.sum() > 0
    two = str(tmp_path / "two.bp")
    for rank in range(2):
        read_data_write_pdf(inp, two, nbins=10, max_not_ready=2, rank=rank,
                            size=2, device="cpu")
    assert os.path.isfile(os.path.join(two, "md.json"))
    assert not port_io._real_bp_evidence(two)
    with port_io.open_reader(two) as r:
        assert r.get("U/pdf", step=0).shape == (8, 10)


def test_simulation_output_through_adios2_engine(fake, tmp_path):
    from grayscott_jl_tpu_torch.config.settings import Settings
    from grayscott_jl_tpu_torch.io.stream import SimStream
    from grayscott_jl_tpu_torch.simulation import Simulation

    path = str(tmp_path / "sim.bp")
    s = Settings(L=16, Du=0.2, Dv=0.1, F=0.02, k=0.048, dt=1.0, noise=0.0,
                 precision="Float32", backend="CPU", output=path, steps=4,
                 plotgap=2)
    sim = Simulation(s)
    stream = SimStream(s, sim.domain, sim.dtype)
    assert isinstance(stream.writer, adios.Adios2Writer)
    assert stream.engine == "adios2"
    for _ in range(2):
        sim.iterate(2)
        stream.write_step(sim.step, sim.snapshot())
    stream.close()
    with port_io.open_reader(path) as r:
        assert r.num_steps() == 2
        u = r.get("U", step=1)
        assert u.shape == (16, 16, 16) and u.dtype == np.float32
        assert np.isfinite(u).all()
        np.testing.assert_array_equal(u, sim.get_fields()[0])
        assert int(r.get("step", step=0)) == 2
        assert r.attributes()["Fides_Data_Model"] == "uniform"


@pytest.mark.parametrize("corrupt", [
    "[1, 2, 3]", '{"keep_base": null}', '{"base": "out.bp"}',
    '{"keep_base": "soon"}', "{nope"])
def test_corrupt_sidecar_marker_degrades_to_no_sidecar(tmp_path, corrupt):
    path = str(tmp_path / "out.bp")
    os.makedirs(sidecar.sidecar_path(path))
    with open(os.path.join(sidecar.sidecar_path(path), "sidecar.json"), "w",
              encoding="utf-8") as f:
        f.write(corrupt)
    assert sidecar.read_keep_base(path) is None


# ----------------------------- the reference's tests without the wheel


def _make_fake_bp4_store(d):
    """The files every BP4/BP5 engine makes at open (``md.idx`` and an
    extensionless ``md.0`` are the evidence)."""
    d.mkdir()
    (d / "data.0").write_bytes(b"\x00" * 16)
    (d / "md.0").write_bytes(b"\x00" * 16)
    (d / "md.idx").write_bytes(b"\x00" * 16)


def test_open_writer_falls_back_without_adios2(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_TPU_ADIOS2", "0")
    monkeypatch.setenv("GS_TPU_NATIVE_IO", "0")
    w = port_io.open_writer(str(tmp_path / "out.bp"))
    assert isinstance(w, BpWriter)
    w.define_variable("x", np.float32, (4,))
    w.begin_step()
    w.put("x", np.arange(4, dtype=np.float32))
    w.end_step()
    w.close()
    r = port_io.open_reader(str(tmp_path / "out.bp"))
    assert isinstance(r, BpReader)
    np.testing.assert_array_equal(r.get("x", step=0),
                                  np.arange(4, dtype=np.float32))
    r.close()


def test_open_reader_rejects_real_bp_store_without_adios2(tmp_path):
    d = tmp_path / "real.bp"
    _make_fake_bp4_store(d)
    if adios.available():
        pytest.skip("adios2 present: the store would be dispatched to it")
    with pytest.raises(RuntimeError, match="adios2"):
        port_io.open_reader(str(d))


def test_append_to_real_bp_store_is_refused(tmp_path):
    d = tmp_path / "real.bp"
    _make_fake_bp4_store(d)
    with pytest.raises(RuntimeError, match="BP-lite"):
        port_io.open_writer(str(d), append=True)


def test_append_to_unrelated_directory_is_refused(tmp_path):
    d = tmp_path / "gs.vtk"
    d.mkdir()
    (d / "step_0000010.vti").write_bytes(b"<VTKFile/>")
    with pytest.raises(RuntimeError, match="BP-lite"):
        port_io.open_writer(str(d), append=True)


def test_append_during_peer_startup_is_not_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_TPU_NATIVE_IO", "0")
    d = tmp_path / "out.bp"
    d.mkdir()
    (d / "data.0").write_bytes(b"")
    w = port_io.open_writer(str(d), writer_id=1, nwriters=2, append=True)
    assert isinstance(w, BpWriter)
    w.close()


# --------------------------------------- the wheel-gated reference tests


def test_adios2_writer_reader_roundtrip(wheel, tmp_path):
    path = str(tmp_path / "real.bp")
    w = adios.Adios2Writer(path)
    w.define_attribute("F", 0.02)
    w.define_attribute("note", "hello")
    w.define_variable("step", np.int32)
    w.define_variable("U", np.float32, (4, 4))
    for s in range(2):
        w.begin_step()
        w.put("step", np.int32(s))
        block = np.full((2, 4), s, np.float32)
        w.put("U", block, start=(0, 0), count=(2, 4))
        w.put("U", block + 10, start=(2, 0), count=(2, 4))
        w.end_step()
    w.close()
    r = adios.Adios2Reader(path)
    assert r.num_steps() == 2
    assert r.attributes()["note"] == "hello"
    u1 = r.get("U", step=1)
    np.testing.assert_array_equal(u1[:2], np.full((2, 4), 1, np.float32))
    np.testing.assert_array_equal(u1[2:], np.full((2, 4), 11, np.float32))
    r.close()
    r = adios.Adios2Reader(path)
    assert r.begin_step(timeout=5.0) == StepStatus.OK
    r.set_selection("U", (1, 0), (2, 4))
    assert r.get("U").shape == (2, 4)
    r.end_step()
    r.close()


def test_sim_stream_emits_real_bp(wheel, tmp_path, monkeypatch):
    from grayscott_jl_tpu_torch.driver import main
    from grayscott_jl_tpu_torch.io.stream import fides_vtk_schemas

    monkeypatch.chdir(tmp_path)
    cfg = _config(tmp_path, L=8, steps=10, plotgap=5, checkpoint=False,
                  output="out.bp")
    sim = main([cfg])
    assert not os.path.isfile(tmp_path / "out.bp" / "md.json")
    r = adios.Adios2Reader(str(tmp_path / "out.bp"))
    assert r.num_steps() == 2
    atts = r.attributes()
    assert float(atts["F"]) == pytest.approx(0.02)
    assert atts["vtk.xml"] == fides_vtk_schemas(8)["vtk.xml"]
    np.testing.assert_array_equal(r.get("U", step=1), sim.get_fields()[0])
    r.close()


# --------------------------------------------------- F14: foreign append


@pytest.mark.parametrize("bindings", [False, True], ids=["bare", "fake"])
def test_restart_append_refuses_an_unrelated_directory(tmp_path, request,
                                                      bindings):
    """A restart-append (``keep_steps=0``, the restart's count of a store
    that has no steps) into a directory holding only ``notes.txt`` is
    refused with the reference's words and leaves the directory as it
    was, with the bindings importable or not."""
    if bindings:
        request.getfixturevalue("fake")
    d = tmp_path / "results"
    d.mkdir()
    (d / "notes.txt").write_text("my notes\n")
    with pytest.raises(RuntimeError, match="unrelated directory"):
        port_io.open_writer(str(d), append=True, keep_steps=0)
    assert sorted(os.listdir(d)) == ["notes.txt"]


# ------------------------------------------------------ selection table


def _build(kind, path, port_src):
    """Make store state ``kind`` at ``path`` (through the port's engines
    with the fake installed)."""
    if kind == "absent":
        return
    if kind in ("empty", "foreign", "startup"):
        os.makedirs(path)
        name = {"foreign": "notes.txt", "startup": "data.0"}.get(kind)
        if name:
            with open(os.path.join(path, name), "w") as f:
                f.write("x" if kind == "foreign" else "")
        return
    if kind == "bplite":
        w = BpWriter(path)
        w.define_variable("step", np.int32)
        for s in (0, 10, 20):
            w.begin_step()
            w.put("step", np.int32(s))
            w.end_step()
        w.close()
        return
    _write_store(port_src, path, L=4)
    if kind in ("sidecar", "orphan"):
        w = port_src.open_writer(path, append=True, keep_steps=1)
        w.define_variable("step", np.int32)
        w.begin_step()
        w.put("step", np.int32(15))
        w.end_step()
        w.close()
    if kind == "orphan":
        shutil.rmtree(path)


#: id -> (store state, open_writer keywords, GS_TPU_ADIOS2, bindings)
SELECTION = {
    "fresh": ("absent", {}, None, True),
    "fresh_over_bplite": ("bplite", {}, None, True),
    "fresh_over_sidecar": ("sidecar", {}, None, True),
    "fresh_two_writers": ("absent", {"nwriters": 2}, None, True),
    "fresh_env_off": ("absent", {}, "0", True),
    "fresh_checkpoint": ("absent", {"prefer_adios2": False}, None, True),
    "fresh_bare": ("absent", {}, None, False),
    "append_absent": ("absent", {"append": True}, None, True),
    "append_empty": ("empty", {"append": True, "keep_steps": 0}, None,
                     True),
    "append_startup": ("startup", {"append": True, "writer_id": 1,
                                   "nwriters": 2}, None, True),
    "append_bplite": ("bplite", {"append": True, "keep_steps": 2}, None,
                      True),
    "append_real": ("real", {"append": True}, None, True),
    "append_real_keep_all": ("real", {"append": True, "keep_steps": 3},
                             None, True),
    "rollback_real": ("real", {"append": True, "keep_steps": 1}, None,
                      True),
    "append_sidecar": ("sidecar", {"append": True}, None, True),
    "rollback_sidecar_deeper": ("sidecar", {"append": True, "keep_steps": 0},
                                None, True),
    "rollback_sidecar_inside": ("sidecar", {"append": True, "keep_steps": 2},
                                None, True),
    "append_orphan": ("orphan", {"append": True}, None, True),
    "append_foreign": ("foreign", {"append": True}, None, True),
    "append_foreign_bare": ("foreign", {"append": True, "keep_steps": 0},
                            None, False),
    "append_real_checkpoint": ("real", {"append": True,
                                        "prefer_adios2": False}, None, True),
    "append_real_two_writers": ("real", {"append": True, "nwriters": 2},
                                None, True),
    "append_real_env_off": ("real", {"append": True}, "0", True),
    "append_real_bare": ("real", {"append": True}, None, False),
    "append_empty_bare": ("empty", {"append": True}, None, False),
    "append_startup_bare": ("startup", {"append": True, "writer_id": 1,
                                        "nwriters": 2}, None, False),
}


def _engine(w, path):
    if type(w).__name__ == "Adios2Writer":
        return "adios2"
    return "sidecar" if w.path.endswith(".sidecar") else "bplite"


def _outcome(io_mod, path, kw):
    """What the package's calls make of ``path``: the writer's engine or
    its refusal, then the files, the marker, the step count and the
    reader's kind or refusal."""
    try:
        w = io_mod.open_writer(path, **kw)
        got = [_engine(w, path)]
        w.close()
    except RuntimeError as e:
        got = ["refused", str(e).replace(path, "<path>")]
    files = sorted(os.listdir(path)) if os.path.isdir(path) else None
    got += [files, io_mod.sidecar.read_keep_base(path),
            io_mod.count_steps_upto(path, 10)]
    try:
        r = io_mod.open_reader(path)
        got += [type(r).__name__, r.num_steps()]
        r.close()
    except (RuntimeError, FileNotFoundError) as e:
        got += ["refused", type(e).__name__]
    return got


@pytest.mark.parametrize("case", list(SELECTION))
def test_selection_matches_reference(fake, tmp_path, monkeypatch, case):
    """Each case in both packages: the same engine or the same refusal
    message, the same files left, marker, step count and reader."""
    state, kw, env, bindings = SELECTION[case]
    if env is not None:
        monkeypatch.setenv("GS_TPU_ADIOS2", env)
    monkeypatch.setenv("GS_TPU_NATIVE_IO", "0")
    paths = {}
    for name in ("ref", "port"):
        paths[name] = str(tmp_path / name / "out.bp")
        os.makedirs(os.path.dirname(paths[name]))
        with monkeypatch.context() as m:
            m.delenv("GS_TPU_ADIOS2", raising=False)
            _build(state, paths[name], port_io)
    with monkeypatch.context() as m:
        if not bindings:
            m.setattr(ref_adios, "available", lambda: False)
            m.setattr(adios, "available", lambda: False)
        ref = _outcome(ref_io, paths["ref"], kw)
        port = _outcome(port_io, paths["port"], kw)
    assert port == ref


# ---------------------------------------------- stores across packages


def _store(io_mod, path):
    """Attributes (lists for arrays), variables and every step's arrays
    of a store, read through ``io_mod.open_reader``."""
    with io_mod.open_reader(path) as r:
        attrs = {k: v.tolist() if isinstance(v, np.ndarray) else v
                 for k, v in r.attributes().items()}
        info = {k: (np.dtype(v.dtype).name, tuple(v.shape))
                for k, v in r.available_variables().items()}
        steps = [{n: np.asarray(r.get(n, step=i)) for n in info}
                 for i in range(r.num_steps())]
    return attrs, info, steps


def _assert_same(a, b, atol=0.0):
    (attrs_a, info_a, steps_a), (attrs_b, info_b, steps_b) = a, b
    assert attrs_a == attrs_b
    assert info_a == info_b
    assert len(steps_a) == len(steps_b) > 0
    for x, y in zip(steps_a, steps_b):
        for name in x:
            assert x[name].dtype == y[name].dtype, name
            if atol:
                np.testing.assert_allclose(x[name], y[name], rtol=0,
                                           atol=atol)
            else:
                assert np.array_equal(x[name], y[name]), name


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_adapter_store_reads_in_the_other_package(fake, tmp_path, writer):
    """A store one package writes through its adapter (two appends, so
    both Write and Append modes) reads the same in both packages."""
    src = {"ref": ref_io, "port": port_io}[writer]
    path = str(tmp_path / "out.bp")
    _write_store(src, path)
    _write_store(src, path, steps=2, append=True)
    assert src._real_bp_evidence(path)
    port, ref = _store(port_io, path), _store(ref_io, path)
    _assert_same(port, ref)
    assert [int(s["step"]) for s in port[2]] == [0, 10, 20, 100, 110]


# ------------------------------------------------------------ the slice


def _config(d, **kw):
    base = dict(L=16, Du=0.2, Dv=0.1, F=0.02, k=0.048, dt=1.0, plotgap=5,
                steps=20, noise=0.1, checkpoint=True, checkpoint_freq=10,
                output=str(d / "gs.bp"), checkpoint_output=str(d / "ckpt.bp"),
                precision="Float32", backend="CPU")
    base.update(kw)
    lines = []
    for key, value in base.items():
        if isinstance(value, bool):
            lines.append(f"{key} = {'true' if value else 'false'}")
        elif isinstance(value, str):
            lines.append(f'{key} = "{value}"')
        else:
            lines.append(f"{key} = {value}")
    os.makedirs(d, exist_ok=True)
    (d / "config.toml").write_text("\n".join(lines) + "\n")
    return str(d / "config.toml")


_RUN_VARS = ("GS_SUPERVISE", "GS_MAX_RESTARTS", "GS_RESTART_BACKOFF_S",
             "GS_FAULTS", "GS_FAULT_JOURNAL", "GS_HEALTH_POLICY",
             "GS_CKPT_VERIFY", "GS_CKPT_REPLICAS", "GS_TPU_STATS",
             "GS_TPU_ADIOS2", "GS_EVENTS", "GS_METRICS", "GS_TRACE",
             "GS_SEED", "GS_FUSE", "GS_TPU_MESH_DIMS")


def _port_run(monkeypatch, cfg, **env):
    from grayscott_jl_tpu_torch import julia_main
    from grayscott_jl_tpu_torch.obs import events, metrics, trace

    with monkeypatch.context() as m:
        for var in _RUN_VARS:
            m.delenv(var, raising=False)
        m.setenv("GS_AUTOTUNE_CACHE", os.path.join(
            os.path.dirname(cfg), "tune"))
        for k, v in env.items():
            m.setenv(k, v)
        for reset in (events.reset_events, metrics.reset_metrics,
                      trace.reset_tracer):
            reset()
        rc = julia_main([cfg])
    assert rc == 0


def test_slice_through_the_adios2_engine(fake, tmp_path, monkeypatch):
    """The CLI on the adapter (L=16, 20 steps, noise 0.1, plotgap 5,
    checkpoints at 10 and 20) against a live reference run within
    1e-6; within the port bitwise against BP-lite (``GS_TPU_ADIOS2=0``),
    and a rollback restart from step 10 and a supervised ``rollback``
    plan, both into the sidecar, bitwise against the uninterrupted run;
    pdfcalc, gdsplot, the field endpoint and the integrity audit over the
    merged store."""
    from grayscott_jl_tpu.driver import main as ref_main
    from grayscott_jl_tpu_torch.analysis import gdsplot, pdfcalc
    from grayscott_jl_tpu_torch.resilience import integrity
    from grayscott_jl_tpu_torch.serve import server

    for var in _RUN_VARS:
        monkeypatch.delenv(var, raising=False)
    ref_dir = tmp_path / "ref"
    ref_main([_config(ref_dir)], n_devices=1)

    a, b, c, s = (tmp_path / n for n in "abcs")
    stats = tmp_path / "stats.json"
    # GS_CKPT_VERIFY=full hands the output stream device checksums that
    # a real store has no ledger for.
    _port_run(monkeypatch, _config(a), GS_TPU_STATS=str(stats),
              GS_CKPT_VERIFY="full")
    assert json.loads(stats.read_text())["config"]["io_engine"] == "adios2"
    _port_run(monkeypatch, _config(c), GS_TPU_ADIOS2="0")
    for d in (a, c):
        assert os.path.isfile(d / "ckpt.bp" / "md.json")
    assert port_io._real_bp_evidence(str(a / "gs.bp"))
    assert os.path.isfile(c / "gs.bp" / "md.json")

    # The live reference run, read by either package.
    ref_store = _store(ref_io, str(ref_dir / "gs.bp"))
    _assert_same(_store(port_io, str(ref_dir / "gs.bp")), ref_store)
    full = _store(port_io, str(a / "gs.bp"))
    _assert_same(_store(ref_io, str(a / "gs.bp")), full)
    assert [int(x["step"]) for x in full[2]] == [5, 10, 15, 20]
    _assert_same(full, ref_store, atol=ATOL)
    _assert_same(_store(port_io, str(c / "gs.bp")), full)

    # A rollback restart from step 10 onto a copy of run A.
    shutil.copytree(a, b)
    _port_run(monkeypatch, _config(b, restart=True,
                                   restart_input=str(b / "ckpt.bp"),
                                   restart_step=10))
    # A supervised rollback: a NaN at step 16 trips the health probe at
    # boundary 20, and the plan resumes from the step-10 checkpoint.
    _port_run(monkeypatch, _config(s), GS_SUPERVISE="1",
              GS_MAX_RESTARTS="3", GS_RESTART_BACKOFF_S="0",
              GS_HEALTH_POLICY="rollback", GS_FAULTS="step=16:kind=nan")
    for d in (b, s):
        store = str(d / "gs.bp")
        assert sidecar.read_keep_base(store) == 2
        assert isinstance(port_io.open_reader(store), sidecar.MergedReader)
        _assert_same(_store(port_io, store), full)
        _assert_same(_store(ref_io, store), full)
        _assert_same(_store(port_io, str(d / "ckpt.bp")),
                     _store(port_io, str(a / "ckpt.bp")))

    # pdfcalc over the merged store equals pdfcalc over BP-lite.
    for d in (b, c):
        monkeypatch.chdir(d)  # the same "input" attribute
        assert pdfcalc.read_data_write_pdf("gs.bp", "pdf.bp", 50,
                                           max_not_ready=2,
                                           device="cpu") == 4
    _assert_same(_store(port_io, str(b / "pdf.bp")),
                 _store(port_io, str(c / "pdf.bp")))
    for step in (0, 2, -1):
        assert np.array_equal(gdsplot.load_slice(str(b / "gs.bp"), "V", step),
                              gdsplot.load_slice(str(c / "gs.bp"), "V", step))
    job = SimpleNamespace(id="j", store=str(b / "gs.bp"),
                          spec=SimpleNamespace(L=16))
    plane = server._field_slice(job, field="u", z=3)
    assert plane["sim_step"] == 20
    assert plane["data"] == [[round(float(v), 6) for v in row]
                             for row in full[2][3]["U"][:, :, 3]]

    # The scrubber skips the ADIOS2 base and checks the sidecar's ledger;
    # verify_store refuses the store, whose base it cannot verify.
    report = integrity.scrub_store(str(b / "gs.bp"), quarantine=False)
    assert report["unverified_base"] == str(b / "gs.bp")
    assert report["steps_audited"] == 2 and not report["corrupt"]
    assert integrity.scrub_store(str(a / "gs.bp"))["steps_audited"] == 0
    for d in (a, b):
        with pytest.raises(integrity.CorruptionError, match="no CRCs"):
            integrity.verify_store(str(d / "gs.bp"))
    integrity.corrupt_store_byte(sidecar.sidecar_path(str(b / "gs.bp")))
    report = integrity.scrub_store(str(b / "gs.bp"), quarantine=False)
    assert report["corrupt"]


def test_bf16_output_stays_on_bplite(fake, tmp_path, monkeypatch):
    """ADIOS2 has no bfloat16 type: a bf16 run's output store is BP-lite
    with the bindings importable, and the adapter refuses bf16."""
    stats = tmp_path / "stats.json"
    _port_run(monkeypatch, _config(tmp_path, precision="BFloat16", L=8,
                                   steps=4, plotgap=2, checkpoint=False),
              GS_TPU_STATS=str(stats))
    assert os.path.isfile(tmp_path / "gs.bp" / "md.json")
    engine = json.loads(stats.read_text())["config"]["io_engine"]
    assert engine in ("native", "python")
    w = adios.Adios2Writer(str(tmp_path / "x.bp"))
    with pytest.raises(TypeError, match="bfloat16"):
        w.define_variable("U", "bfloat16", (2, 2, 2))
    w.close()


def test_adapter_put_refuses_tensors(fake, tmp_path):
    """``put`` takes host arrays: a tensor never reaches the engine."""
    import torch

    w = adios.Adios2Writer(str(tmp_path / "x.bp"))
    w.define_variable("U", torch.float32, (2, 2, 2))
    w.define_variable("lo", np.float32)
    w.begin_step()
    with pytest.raises(TypeError, match="host arrays"):
        w.put("U", torch.zeros((2, 2, 2)))
    with pytest.raises(TypeError, match="host arrays"):
        w.put("lo", torch.tensor(0.5))
    w.put("U", np.zeros((2, 2, 2), np.float32))
    w.put("lo", np.float32(0.5))
    w.end_step()
    w.close()


def test_ensemble_member_stores_through_the_adapter(fake, tmp_path,
                                                    monkeypatch):
    """Each ensemble member's output store is a single-writer store: with
    the bindings importable it is a real store, bitwise equal to the
    same run's BP-lite member store; member checkpoints stay BP-lite."""
    from grayscott_jl_tpu_torch.ensemble.io import member_path

    stores = {}
    for engine, env in (("adios2", {}), ("bplite", {"GS_TPU_ADIOS2": "0"})):
        d = tmp_path / engine
        cfg = _config(d, L=8, steps=4, plotgap=2, checkpoint_freq=2)
        with open(cfg, "a", encoding="utf-8") as f:
            f.write('\n[ensemble]\npresets = ["spots", "stripes"]\n')
        _port_run(monkeypatch, cfg, **env)
        stores[engine] = [member_path(str(d / "gs.bp"), k, 2)
                          for k in range(2)]
        for k in range(2):
            ckpt = member_path(str(d / "ckpt.bp"), k, 2)
            assert os.path.isfile(os.path.join(ckpt, "md.json"))
    for a, b in zip(stores["adios2"], stores["bplite"]):
        assert port_io._real_bp_evidence(a) and not port_io._real_bp_evidence(b)
        _assert_same(_store(port_io, a), _store(port_io, b))


def test_result_cache_refuses_an_adios2_member_store(fake, tmp_path,
                                                     monkeypatch):
    """A served member store through the adapter is a real store whose
    base records no CRCs: the port's result cache, as the reference's,
    neither publishes it nor serves an entry that names it, while the
    same run's BP-lite member store is published and served."""
    from grayscott_jl_tpu.obs.events import NULL_EVENTS as REF_NULL
    from grayscott_jl_tpu.serve import cache as ref_cache
    from grayscott_jl_tpu_torch.ensemble.io import member_path
    from grayscott_jl_tpu_torch.obs.events import NULL_EVENTS
    from grayscott_jl_tpu_torch.serve import cache

    stores = {}
    for engine, env in (("adios2", {}), ("bplite", {"GS_TPU_ADIOS2": "0"})):
        d = tmp_path / engine
        cfg = _config(d, L=8, steps=4, plotgap=2, checkpoint_freq=2)
        with open(cfg, "a", encoding="utf-8") as f:
            f.write('\n[ensemble]\npresets = ["spots", "stripes"]\n')
        _port_run(monkeypatch, cfg, **env)
        stores[engine] = member_path(str(d / "gs.bp"), 1, 2)
    assert port_io._real_bp_evidence(stores["adios2"])
    port = cache.ResultCache(str(tmp_path / "cache"), events=NULL_EVENTS)
    ref = ref_cache.ResultCache(str(tmp_path / "ref_cache"),
                                events=REF_NULL)
    for c in (port, ref):
        assert c.publish(None, stores["adios2"], digest="a" * 64) is None
        assert c.lookup("a" * 64) is None
        entry = c.publish(None, stores["bplite"], digest="b" * 64)
        assert entry["store"] == stores["bplite"]
        assert c.lookup("b" * 64)["store"] == stores["bplite"]
        # An entry naming the real store (hand-written) is dropped.
        os.makedirs(os.path.dirname(c.entry_path("a" * 64)), exist_ok=True)
        with open(c.entry_path("a" * 64), "w", encoding="utf-8") as f:
            json.dump({**entry, "digest": "a" * 64,
                       "store": stores["adios2"]}, f)
        assert c.lookup("a" * 64) is None
        assert not os.path.exists(c.entry_path("a" * 64))


def test_replicate_store_mirrors_the_rollback_sidecar(fake, tmp_path):
    """A mirror of a real store after a rollback carries the sidecar, so
    it reads as the merged steps, not as the rolled-back tail."""
    from grayscott_jl_tpu_torch.resilience import integrity

    path = str(tmp_path / "out.bp")
    _write_store(port_io, path, steps=3, L=4)
    w = port_io.open_writer(path, append=True, keep_steps=1)
    w.define_variable("step", np.int32)
    w.begin_step()
    w.put("step", np.int32(1010))
    w.end_step()
    w.close()
    assert integrity.replicate_store(path, 3) == [path + ".r1", path + ".r2"]
    assert integrity.replicate_store(path, 3) == []
    for mirror in (path + ".r1", path + ".r2"):
        assert sidecar.read_keep_base(mirror) == 1
        with port_io.open_reader(mirror) as r:
            assert isinstance(r, sidecar.MergedReader)
            assert _steps(r) == [0, 1010]
