"""The port's analysis workflow (grayscott_jl_tpu_torch/analysis/) on the
CPU, against the reference's (grayscott_jl_tpu/analysis/).

``compute_pdf`` is held to the reference's numpy histogram bit for bit
(pdf and bins) on seeded float32 and float64 blocks, the degenerate
windows, a block holding a NaN and a block where dividing by the bin
width and multiplying by its float32 reciprocal put cells in different
bins; ``read_data_write_pdf`` over a store the port's CLI wrote, by
both packages, gives equal stores; the port's CLI streams live into
the port's pdfcalc; ``gdsplot`` and ``decomp`` give the reference's
slices and text. The histograms run on the card unless the CPU is
asked for, so every call here passes ``device="cpu"`` or
``--backend CPU``, and the default raises where there is no card."""

import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest

from grayscott_jl_tpu.analysis import decomp as ref_decomp
from grayscott_jl_tpu.analysis import gdsplot as ref_gdsplot
from grayscott_jl_tpu.analysis import pdfcalc as ref_pdfcalc
from grayscott_jl_tpu.io.bplite import BpReader as RefReader
from grayscott_jl_tpu_torch.analysis import decomp, gdsplot, pdfcalc
from grayscott_jl_tpu_torch.io.bplite import BpReader, BpWriter

REPO = Path(__file__).resolve().parents[1]

CONFIG = """\
L = 32
Du = 0.2
Dv = 0.1
F = 0.02
k = 0.048
dt = 1.0
plotgap = 10
steps = 40
noise = 0.1
output = "gs.bp"
precision = "Float32"
backend = "CPU"
"""


def assert_same(ref, port):
    """``(pdf, bins)`` pairs equal bit for bit, dtypes included."""
    for a, b in zip(ref, port):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True)


def ref_pdf(data, nbins):
    with warnings.catch_warnings():
        # numpy warns when it casts a NaN quotient to int64.
        warnings.simplefilter("ignore", RuntimeWarning)
        return ref_pdfcalc.compute_pdf(data, nbins)


# ------------------------------------------------------------ compute_pdf

@pytest.mark.parametrize("nbins", [16, 64, 1000])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compute_pdf_bitwise(dtype, nbins):
    data = np.random.default_rng(nbins).uniform(
        0.1, 0.8, (8, 16, 16)).astype(dtype)
    pdf, bins = pdfcalc.compute_pdf(data, nbins, device="cpu")
    assert_same(ref_pdf(data, nbins), (pdf, bins))
    assert pdf.dtype == dtype and int(pdf.sum()) == data.size


@pytest.mark.parametrize("case", ["constant", "one_bin", "tiny_range"])
def test_compute_pdf_degenerate_window(case):
    data = np.full((3, 4, 4), 7.0, np.float32)
    nbins = 1 if case == "one_bin" else 10
    if case == "one_bin":
        data = np.random.default_rng(3).random((3, 4, 4))
    elif case == "tiny_range":
        data = np.zeros((3, 4, 4))
        data[0, 0, 0] = 1e-21  # max - min below the 1e-20 epsilon
    pdf, bins = pdfcalc.compute_pdf(data, nbins, device="cpu")
    assert_same(ref_pdf(data, nbins), (pdf, bins))
    assert (pdf == 16).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compute_pdf_nan_block(dtype):
    """A ``health_policy = "warn"`` store can hold NaN cells: the
    block's min and max are NaN, and every cell lands in bin 0, as the
    reference's int64 cast and clip send it."""
    data = np.random.default_rng(5).uniform(0.1, 0.8, (4, 8, 8)).astype(dtype)
    data[2, 3, 4] = np.nan
    pdf, bins = pdfcalc.compute_pdf(data, 32, device="cpu")
    assert_same(ref_pdf(data, 32), (pdf, bins))
    assert (pdf[:, 0] == 64).all() and (pdf[:, 1:] == 0).all()


def test_compute_pdf_where_reciprocal_product_differs():
    """On a 64^3 block of values in [0.1, 0.8] at 1,000 bins, multiplying
    by the float32 reciprocal of the bin width (what CUDA does when it
    divides by a host scalar) moves cells to other bins: the port
    divides, and equals the reference."""
    data = np.random.default_rng(0).uniform(
        0.1, 0.8, (64, 64, 64)).astype(np.float32)
    nbins = 1000
    lo, hi = float(data.min()), float(data.max())
    width = (hi - lo) / nbins
    shifted = data - lo
    divided = np.floor(shifted / width)
    product = np.floor(shifted * (np.float32(1) / np.float32(width)))
    assert (divided != product).sum() > 0
    assert_same(ref_pdf(data, nbins),
                pdfcalc.compute_pdf(data, nbins, device="cpu"))


def test_compute_pdf_takes_a_tensor():
    import torch

    data = np.random.default_rng(9).random((4, 8, 8)).astype(np.float32)
    assert_same(pdfcalc.compute_pdf(data, 16, device="cpu"),
                pdfcalc.compute_pdf(torch.from_numpy(data), 16,
                                    device="cpu"))


# ----------------------------------------------------- the host contract

def test_split_slowest_dim_matches_reference():
    for n in range(1, 13):
        for size in range(1, 6):
            for rank in range(size):
                assert (pdfcalc.split_slowest_dim(n, size, rank)
                        == ref_pdfcalc.split_slowest_dim(n, size, rank))


@pytest.mark.parametrize("argv", [
    ["in.bp", "out.bp"],
    ["a", "b", "50"],
    ["a", "b", "50", "YES"],
    ["a", "b", "7", "no"],
    ["a", "b", "12", "true"],
])
def test_parse_arguments_matches_reference(argv):
    ref = vars(ref_pdfcalc.parse_arguments(argv))
    port = vars(pdfcalc.parse_arguments(argv))
    assert port.pop("backend") == "CUDA"
    assert port == ref
    assert pdfcalc.parse_arguments(argv + ["--backend", "CPU"]).backend == "CPU"


def test_the_card_is_asked_for_by_default(tmp_path, monkeypatch):
    """Without ``--backend CPU`` (``device="cpu"``) pdfcalc computes on
    the card, and raises where there is none — before it opens a store."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.zeros((2, 2, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA card"):
        pdfcalc.compute_pdf(data, 4)
    with pytest.raises(RuntimeError, match="CUDA card"):
        pdfcalc.compute_pdf(data, 4, device="cuda")
    out = tmp_path / "pdf.bp"
    with pytest.raises(RuntimeError, match="--backend CPU"):
        pdfcalc.main([str(tmp_path / "in.bp"), str(out)])
    assert not out.exists()


@pytest.mark.parametrize("n_cards,size,want", [
    (4, 4, [0, 1, 2, 3]), (2, 4, [0, 0, 1, 1]), (1, 3, [0, 0, 0]),
    (8, 2, [0, 4]),
])
def test_each_worker_gets_the_card_launch_gives_its_process(
        monkeypatch, n_cards, size, want):
    """A worker's card is placed as ``launch.py`` places a process
    (``parallel/distributed.placement``)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    got = [pdfcalc.pdf_device(rank=r, size=size) for r in range(size)]
    assert got == [torch.device("cuda", i) for i in want]
    assert pdfcalc.pdf_device("cpu", rank=1, size=size) == torch.device("cpu")


# ------------------------------------------------- the streaming workflow

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """The port's CLI (``backend = "CPU"``, L=32, 40 steps, plotgap 10)
    in a subprocess, streamed live by the port's pdfcalc at 64 bins with
    the input variables written through: the reference's functional
    streaming test with the port on both sides."""
    d = tmp_path_factory.mktemp("live")
    (d / "config.toml").write_text(CONFIG)
    env = _env()
    env["GS_AUTOTUNE_CACHE"] = str(d / "tune")
    sim = subprocess.Popen(
        [sys.executable, "-m", "grayscott_jl_tpu_torch", "config.toml"],
        cwd=d, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    try:
        out = d / "gs.bp"
        deadline = time.time() + 300
        while not out.exists() and time.time() < deadline:
            assert sim.poll() is None or sim.returncode == 0
            time.sleep(0.1)
        assert out.exists(), "simulation never produced output"
        steps = pdfcalc.read_data_write_pdf(
            str(out), str(d / "pdf.bp"), nbins=64, write_inputvars=True,
            timeout=0.2, max_not_ready=150, device="cpu",
        )
        rc = sim.wait(timeout=300)
    finally:
        sim.kill()
        _, err = sim.communicate()
    assert rc == 0, err
    return {"dir": d, "steps": steps}


def test_pdfcalc_streams_live_port_simulation(live):
    assert live["steps"] == 4  # outputs at 10, 20, 30, 40
    r = BpReader(str(live["dir"] / "pdf.bp"))
    assert r.num_steps() == 4
    for i in range(4):
        assert int(r.get("step", step=i)) == 10 * (i + 1)
        for var in ("U", "V"):
            pdf = r.get(f"{var}/pdf", step=i)
            assert pdf.shape == (32, 64)
            assert (pdf.sum(axis=1) == 32 * 32).all()
    r.close()


def _store(path):
    """Every variable of every step of a store, and its attributes."""
    r = RefReader(str(path))
    steps = [{name: r.get(name, step=i) for name in r.available_variables()}
             for i in range(r.num_steps())]
    attrs = r.attributes()
    r.close()
    return attrs, steps


def _assert_same_store(a, b):
    (attrs_a, steps_a), (attrs_b, steps_b) = _store(a), _store(b)
    assert attrs_a == attrs_b
    assert len(steps_a) == len(steps_b) > 0
    for x, y in zip(steps_a, steps_b):
        assert x.keys() == y.keys()
        for name in x:
            assert x[name].dtype == y[name].dtype
            assert np.array_equal(x[name], y[name]), name


def test_read_data_write_pdf_equals_reference(live, tmp_path):
    """Both packages' pdfcalc over the store the port's CLI wrote: every
    variable of every step equal (1,000 bins, input passed through);
    the live run's store (64 bins) too."""
    store = str(live["dir"] / "gs.bp")
    for nbins, inputs in ((1000, True), (64, False)):
        ref_out = tmp_path / f"ref_{nbins}.bp"
        port_out = tmp_path / f"port_{nbins}.bp"
        assert ref_pdfcalc.read_data_write_pdf(
            store, str(ref_out), nbins, inputs) == 4
        assert pdfcalc.read_data_write_pdf(
            store, str(port_out), nbins, inputs, device="cpu") == 4
        _assert_same_store(ref_out, port_out)
    ref_live = tmp_path / "ref_live.bp"
    ref_pdfcalc.read_data_write_pdf(store, str(ref_live), 64, True)
    attrs_ref, steps_ref = _store(ref_live)
    attrs_live, steps_live = _store(live["dir"] / "pdf.bp")
    for x, y in zip(steps_ref, steps_live):
        for name in x:
            assert np.array_equal(x[name], y[name]), name


def _ref_two_workers(store, out, nbins):
    for rank in range(2):
        ref_pdfcalc.read_data_write_pdf(store, str(out), nbins, rank=rank,
                                        size=2)


def test_two_workers_write_one_store_equal_to_reference(live, tmp_path):
    """Two workers into one store: each counts its x-share between its
    own block's min and max (the reference's split), so the store
    equals the reference's two workers', and every slice counts all its
    cells."""
    store = str(live["dir"] / "gs.bp")
    two = tmp_path / "two.bp"
    for rank in range(2):
        pdfcalc.read_data_write_pdf(store, str(two), 100, rank=rank,
                                    size=2, device="cpu")
    _ref_two_workers(store, tmp_path / "ref.bp", 100)
    _assert_same_store(tmp_path / "ref.bp", two)
    for x in _store(two)[1]:
        assert (x["U/pdf"].sum(axis=1) == 32 * 32).all()


def test_parallel_cli_workers_on_the_cpu(live, tmp_path):
    """Two worker processes of the CLI (``GS_TPU_PROCESS_ID`` /
    ``GS_TPU_NUM_PROCESSES``, ``--backend CPU``) merge into one store
    equal to the reference's two workers'."""
    store = str(live["dir"] / "gs.bp")
    procs = []
    for rank in range(2):
        env = _env()
        env["GS_TPU_PROCESS_ID"] = str(rank)
        env["GS_TPU_NUM_PROCESSES"] = "2"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "grayscott_jl_tpu_torch.analysis.pdfcalc",
             store, str(tmp_path / "pdf.bp"), "48", "--backend", "CPU"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        ))
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, out + err
    _ref_two_workers(store, tmp_path / "ref.bp", 48)
    _assert_same_store(tmp_path / "ref.bp", tmp_path / "pdf.bp")


# ------------------------------------------------------ gdsplot, decomp

@pytest.mark.parametrize("var,step,axis,index", [
    ("U", -1, "x", None), ("V", 0, "y", 3), ("U", 2, "z", 31),
])
def test_load_slice_equals_reference(live, var, step, axis, index):
    store = str(live["dir"] / "gs.bp")
    port = gdsplot.load_slice(store, var, step, axis, index)
    ref = ref_gdsplot.load_slice(store, var, step, axis, index)
    assert port.dtype == ref.dtype and np.array_equal(port, ref)


def test_gdsplot_writes_both_pngs(live, tmp_path, capsys):
    slice_png = tmp_path / "slice.png"
    pdf_png = tmp_path / "pdf.png"
    assert gdsplot.main([str(live["dir"] / "gs.bp"), "--var", "V",
                         "--output", str(slice_png)]) == 0
    assert gdsplot.main([str(live["dir"] / "pdf.bp"), "--pdf",
                         "--output", str(pdf_png)]) == 0
    assert slice_png.stat().st_size > 0 and pdf_png.stat().st_size > 0
    out = capsys.readouterr().out
    assert str(slice_png) in out and str(pdf_png) in out


def test_gdsplot_empty_store_raises(tmp_path):
    path = str(tmp_path / "empty.bp")
    BpWriter(path).close()
    with pytest.raises(ValueError, match="no steps"):
        gdsplot.load_slice(path)
    with pytest.raises(ValueError, match="no steps"):
        ref_gdsplot.load_slice(path)


@pytest.mark.parametrize("L", [8, 100, 256])
def test_decomp_describe_equals_reference(L):
    for n in range(1, 17):
        assert decomp.describe(n, L) == ref_decomp.describe(n, L)


def test_decomp_cli(capsys):
    assert decomp.main(["8", "--L", "64"]) == 0
    port = capsys.readouterr().out
    assert ref_decomp.main(["8", "--L", "64"]) == 0
    assert port == capsys.readouterr().out
