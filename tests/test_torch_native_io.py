"""The native C++ BP-lite engine (grayscott_jl_tpu_torch/io/native.py,
built with g++ from io/csrc/bplite.cpp) against the port's Python engine
and the reference's reader: the same payload and integrity sidecar byte
for byte, the same metadata, the reference's ``BpReader`` opens its
stores; append and rollback, misuse, and the engine chain with its
``GS_TPU_NATIVE_IO=0`` override."""

import json
from pathlib import Path

import numpy as np
import pytest

from grayscott_jl_tpu.io.bplite import BpReader as RefBpReader
from grayscott_jl_tpu_torch.io import bplite, native, open_writer
from grayscott_jl_tpu_torch.io.bplite import BpReader, BpWriter

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _built():
    assert native.available(), native.BUILD_ERROR


def _write(writer, nsteps=3, L=4, seed=0):
    rng = np.random.default_rng(seed)
    writer.define_attribute("F", 0.02)
    writer.define_attribute("name", 'gray "scott"\nnative')  # escaping
    writer.define_attribute("Fides_Origin", [0.0, 0.0, 0.0])
    writer.define_variable("step", np.int32)
    writer.define_variable("U", np.float32, (L, L, L))
    writer.define_variable("W", np.float64, (L, L, L))
    writer.define_variable("B", "bfloat16", (L, L, L))
    for s in range(nsteps):
        writer.begin_step()
        writer.put("step", np.int32(s * 10))
        writer.put("U", rng.random((L, L, L), dtype=np.float32))
        writer.put("W", rng.random((L, L, L)))
        writer.record_device_checksums(s * 10, {"u": s, "v": 2 * s})
        writer.put("B", rng.random((L, L, L), dtype=np.float32))
        writer.end_step()
    writer.close()


def _files(path):
    return {p.name: p.read_bytes() for p in sorted(Path(path).iterdir())}


def test_native_store_equals_the_python_engines(tmp_path):
    """Payload and integrity sidecar byte for byte; the metadata equal
    as JSON (the C++ engine writes its keys in name order, the Python
    engine in definition order)."""
    a, b = tmp_path / "a.bp", tmp_path / "b.bp"
    _write(native.NativeBpWriter(str(a)))
    _write(BpWriter(str(b)))
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb) == ["data.0", "integrity.json",
                                        "md.json"]
    assert fa["data.0"] == fb["data.0"]
    assert fa["integrity.json"] == fb["integrity.json"]
    ma, mb = json.loads(fa["md.json"]), json.loads(fb["md.json"])
    assert ma == mb and ma["complete"] is True
    assert json.dumps(ma, sort_keys=True) == json.dumps(mb, sort_keys=True)


def test_native_store_opens_in_the_reference_reader(tmp_path):
    path = str(tmp_path / "n.bp")
    _write(native.NativeBpWriter(path))
    ref, ours = RefBpReader(path), BpReader(path)
    assert ref.num_steps() == ours.num_steps() == 3
    assert ref.attributes() == ours.attributes()
    assert ref.attributes()["name"] == 'gray "scott"\nnative'
    for s in range(3):
        assert int(ref.get("step", step=s)) == s * 10
        for name in ("U", "W"):
            np.testing.assert_array_equal(ref.get(name, step=s),
                                          ours.get(name, step=s))
        np.testing.assert_array_equal(
            np.asarray(ref.get("B", step=s), np.float32),
            ours.get("B", step=s))
    side = json.loads((tmp_path / "n.bp" / "integrity.json").read_text())
    assert side["device"] == [{"u": s, "v": 2 * s} for s in range(3)]


def test_native_append_and_rollback_match_the_python_engine(tmp_path):
    """A resumed store (append, keeping the first two steps) is the
    Python engine's byte for byte, payload and sidecar."""
    for engine, name in ((native.NativeBpWriter, "a.bp"),
                         (BpWriter, "b.bp")):
        path = str(tmp_path / name)
        _write(engine(path), nsteps=3)
        w = engine(path, append=True, keep_steps=2)
        w.begin_step()
        w.put("step", np.int32(99))
        w.put("U", np.full((4, 4, 4), 7, np.float32))
        w.put("W", np.zeros((4, 4, 4)))
        w.put("B", np.ones((4, 4, 4), np.float32))
        w.end_step()
        w.close()
    fa, fb = _files(tmp_path / "a.bp"), _files(tmp_path / "b.bp")
    assert fa["data.0"] == fb["data.0"]
    assert fa["integrity.json"] == fb["integrity.json"]
    assert json.loads(fa["md.json"]) == json.loads(fb["md.json"])
    with BpReader(str(tmp_path / "a.bp")) as r:
        assert [int(r.get("step", step=i)) for i in range(3)] == [0, 10, 99]
        np.testing.assert_array_equal(r.get("U", step=2),
                                      np.full((4, 4, 4), 7, np.float32))


def test_native_pipeline_many_steps_drain(tmp_path):
    """Steps staged faster than the disk takes them all land, in order;
    ``drain`` makes them durable before ``close``."""
    path = str(tmp_path / "n.bp")
    w = native.NativeBpWriter(path)
    w.define_variable("x", np.float64, (64, 64))
    rng = np.random.default_rng(0)
    frames = [rng.random((64, 64)) for _ in range(20)]
    for f in frames:
        w.begin_step()
        w.put("x", f)
        w.end_step()
    w.drain()
    with BpReader(path) as r:
        assert r.num_steps() == 20
    w.close()
    with BpReader(path) as r:
        for i, f in enumerate(frames):
            np.testing.assert_array_equal(r.get("x", step=i), f)


def test_native_misuse_raises(tmp_path):
    w = native.NativeBpWriter(str(tmp_path / "n.bp"))
    w.define_variable("x", np.float32, (2,))
    with pytest.raises(RuntimeError, match="outside"):
        w.put("x", np.zeros(2, np.float32))
    w.begin_step()
    with pytest.raises(RuntimeError, match="inside"):
        w.begin_step()
    with pytest.raises(KeyError):
        w.put("y", np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="shape"):
        w.put("x", np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="inside an open step"):
        w.close()
    w.end_step()
    with pytest.raises(RuntimeError, match="outside"):
        w.end_step()
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.begin_step()


def test_engine_chain_and_env_override(tmp_path, monkeypatch):
    monkeypatch.delenv("GS_TPU_NATIVE_IO", raising=False)
    w = open_writer(str(tmp_path / "a.bp"))
    assert isinstance(w, native.NativeBpWriter) and w.engine == "native"
    w.close()
    monkeypatch.setenv("GS_TPU_NATIVE_IO", "0")
    w = open_writer(str(tmp_path / "b.bp"))
    assert isinstance(w, BpWriter) and w.engine == "python"
    w.close()
    monkeypatch.setenv("GS_TPU_NATIVE_IO", "yes")  # only "0" turns it off
    w = open_writer(str(tmp_path / "c.bp"))
    assert w.engine == "native"
    w.close()


def test_native_fresh_store_clears_quarantine_and_sidecar(tmp_path):
    from grayscott_jl_tpu_torch.resilience import integrity

    path = str(tmp_path / "s.bp")
    _write(native.NativeBpWriter(path))
    integrity.corrupt_store_byte(path)
    assert integrity.scrub_store(path)["corrupt"] == [2]
    assert bplite.read_quarantine(path) == {2}
    _write(native.NativeBpWriter(path), nsteps=1)
    assert bplite.read_quarantine(path) == frozenset()
    assert len(bplite.read_integrity_crcs(path)) == 4


def test_the_source_is_the_references_byte_for_byte():
    ours = (REPO / "grayscott_jl_tpu_torch" / "io" / "csrc"
            / "bplite.cpp").read_bytes()
    assert ours == (REPO / "csrc" / "bplite.cpp").read_bytes()


def test_the_library_is_built_beside_the_port_and_ignored():
    """The port loads its own build (never the reference's
    ``csrc/libbplite.so``), in a directory git ignores."""
    path = Path(native.library_path())
    assert path.is_file()
    assert path.parent == REPO / "grayscott_jl_tpu_torch" / "io" / "csrc" / "build"
    ignores = (REPO / ".gitignore").read_text().splitlines()
    assert "grayscott_jl_tpu_torch/io/csrc/build/" in ignores
