"""The envelope probes (grayscott_jl_tpu_torch/ops/envelope.py and
grayscott_jl_tpu_torch/probes/envelope_probe.py) against the reference
probe, benchmarks/envelope_probe.py, run on the CPU in interpret mode.

The reference probe's kernels are closures inside its ``main()``; one
module-scoped run at L=16, bx=4, fuse=2 (``--cpu --steps 2 --rounds
1``) captures the jitted ``xla_stream``, ``dma_walk`` and ``full`` by
recording what ``jax.jit`` wraps from the probe's own module, and the
tests call them again on seeded inputs. Tolerances:

* ``dma_walk`` vs the copy walk and ``xla_stream`` vs ``torch_stream``:
  bitwise (a copy; one rounded multiply). ``dma_walk`` is the identity
  on its interior slabs only: it clamps the first and last slab's input
  window into the grid and copies that window's centre planes, so those
  two slabs are the input shifted by the halo. The port's copy walk is
  the identity everywhere; the test holds both facts;
* ``full`` vs the port's ``full`` case: atol 1e-6. Both compute the
  same expressions in the same order; XLA:CPU contracts multiply-adds
  inside the interpreted kernel and torch does not (ROADMAP ground
  rules: 1.8e-7 over ten steps from the seeded cube). Measured here,
  from uniform random fields: 3.6e-7 (seed 2) and at most 4.8e-7 over
  seeds 0-3, for one pass of depth 2.

The compute walk's TPU output is a probe artefact (its y/z pins use
u's boundary value for v too, its noise is keyed at the last slab's x
offset), so the port's compute walk is held to the port's own chain:
its defined tile equals ``cuda_stencil.plain_chain``'s tile (0,0,0)
bitwise, at shapes smaller than, equal to and larger than one tile
plus halo. The kernels themselves are held against these plain
versions on the card (tests/test_torch_card.py, chip_smoke.py)."""

import contextlib
import importlib.util
import io
import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grayscott_jl_tpu_torch.models import get_model, grayscott
from grayscott_jl_tpu_torch.ops import _build, cuda_stencil, envelope, kernelgen
from grayscott_jl_tpu_torch.probes import envelope_probe

REPO = Path(__file__).resolve().parents[1]
PROBE = REPO / "benchmarks" / "envelope_probe.py"
SPEC = kernelgen.get_spec(grayscott.MODEL)
TILE = cuda_stencil.TILE
L, BX, FUSE = 16, 4, 2
FULL_ATOL = 1e-6


@pytest.fixture(scope="module")
def reference():
    """The reference probe's jitted cases from one ``--cpu`` run:
    ``{name: [jitted, ...]}`` and the run's stdout."""
    name = "_reference_envelope_probe"
    spec = importlib.util.spec_from_file_location(name, PROBE)
    module = importlib.util.module_from_spec(spec)
    captured = {}
    real_jit = jax.jit

    def recording_jit(fn=None, *args, **kwargs):
        jitted = real_jit(fn, *args, **kwargs)
        if getattr(fn, "__module__", None) == name:
            captured.setdefault(fn.__name__, []).append(jitted)
        return jitted

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "path", list(sys.path))
        mp.setattr(sys, "argv", [
            str(PROBE), "--cpu", "--l", str(L), "--bx", str(BX), "--fuse",
            str(FUSE), "--steps", "2", "--rounds", "1"])
        # The probe sets GS_BX itself; the context removes it after.
        mp.setenv("GS_BX", str(BX))
        mp.delenv("GS_PROBE_COMPUTE_VARIANTS", raising=False)
        mp.setattr(jax, "jit", recording_jit)
        spec.loader.exec_module(module)
        with contextlib.redirect_stdout(out):
            assert module.main() == 0
    return captured, out.getvalue()


def _seeded(shape=(L, L, L), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.0, 1.0, shape).astype(np.float32) for _ in range(2)]


def _params(noise, device="cpu"):
    return envelope_probe.make_params(noise, device)


def test_reference_run_captured_its_cases(reference):
    captured, stdout = reference
    assert {"xla_stream", "dma_walk", "compute_walk", "full"} <= set(captured)
    cases = [json.loads(line)["case"] for line in stdout.splitlines()]
    assert cases == ["xla_stream", "dma_walk", "compute_walk", "full"]
    import os

    assert "GS_BX" not in os.environ


@pytest.mark.parametrize("path", ["plain", "entry"])
def test_copy_walk_equals_reference_dma_walk(reference, path):
    captured, _ = reference
    u, v = _seeded()
    want = captured["dma_walk"][0](jnp.asarray(u), jnp.asarray(v))
    fields = (torch.from_numpy(u), torch.from_numpy(v))
    launches = cuda_stencil.LAUNCHES
    if path == "plain":
        got = envelope.plain_copy_walk(fields, fuse=FUSE)
    else:
        got = envelope.copy_walk(fields, fuse=FUSE)
    assert cuda_stencil.LAUNCHES == launches
    inner = slice(BX, L - BX)
    for g, w, x in zip(got, want, (u, v)):
        w = np.asarray(w)
        assert np.array_equal(g.numpy(), x)
        assert np.array_equal(g.numpy()[inner], w[inner])
        # The reference clamps its edge windows into the grid and copies
        # their centre planes, so its first and last slabs are the input
        # shifted by the halo: a probe artefact the port does not copy.
        assert np.array_equal(w[:BX], x[FUSE:FUSE + BX])
        assert np.array_equal(w[-BX:], x[L - BX - FUSE:L - FUSE])


def test_torch_stream_equals_reference_xla_stream(reference):
    captured, _ = reference
    u, v = _seeded(seed=1)
    want = captured["xla_stream"][0](jnp.asarray(u), jnp.asarray(v))
    cases = dict(envelope_probe.build_cases(L, FUSE, 0.1, 1, "cpu"))
    got = cases["torch_stream"](torch.from_numpy(u), torch.from_numpy(v))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_full_matches_reference_full(reference):
    captured, _ = reference
    u, v = _seeded(seed=2)
    want = captured["full"][0](jnp.asarray(u), jnp.asarray(v))
    cases = dict(envelope_probe.build_cases(L, FUSE, 0.1, 1, "cpu"))
    got = cases["full"](torch.from_numpy(u), torch.from_numpy(v))
    err = max(float(np.abs(g.numpy() - np.asarray(w)).max())
              for g, w in zip(got, want))
    assert err <= FULL_ATOL, err
    assert not np.array_equal(got[0].numpy(), u)


def _shapes(fuse):
    """Smaller than, equal to and larger than one tile plus halo."""
    return [(6, 5, 20), tuple(t + fuse for t in TILE), (20, 24, 70)]


@pytest.mark.parametrize("fuse", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("noise", [0.0, 0.1])
@pytest.mark.parametrize("size", ["smaller", "equal", "larger"])
def test_plain_compute_walk_is_the_chains_origin_tile(fuse, noise, size):
    shape = _shapes(fuse)[["smaller", "equal", "larger"].index(size)]
    fields = tuple(torch.from_numpy(x) for x in _seeded(shape, seed=fuse))
    params = _params(noise)
    want = cuda_stencil.plain_chain(fields, params, (1, 2, 7), spec=SPEC,
                                    use_noise=noise != 0, fuse=fuse)
    got = envelope.plain_compute_walk(fields, params, (1, 2, 7), spec=SPEC,
                                      fuse=fuse, use_noise=noise != 0)
    cut = envelope.defined_tile(shape)
    assert got[0].shape == tuple(min(n, t) for n, t in zip(shape, TILE))
    for g, w in zip(got, want):
        assert torch.equal(g, w[cut])


def _walk(variant, fuse, noise=0.1, shape=(20, 24, 70), seed=3):
    fields = tuple(torch.from_numpy(x) for x in _seeded(shape, seed=seed))
    return fields, envelope.plain_compute_walk(
        fields, _params(noise), (1, 2, 7), spec=SPEC, fuse=fuse,
        use_noise=noise != 0, variant=variant)


@pytest.mark.parametrize("variant", envelope.VARIANTS)
def test_plain_variants_are_deterministic(variant):
    _, a = _walk(variant, 3)
    _, b = _walk(variant, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.isfinite(x).all() for x in a)


@pytest.mark.parametrize("fuse", [1, 2, 3])
def test_nonoise_is_the_noiseless_chain(fuse):
    fields, got = _walk("nonoise", fuse)
    want = cuda_stencil.plain_chain(fields, _params(0.1), (1, 2, 7),
                                    spec=SPEC, use_noise=False, fuse=fuse)
    cut = envelope.defined_tile(fields[0].shape)
    assert all(torch.equal(g, w[cut]) for g, w in zip(got, want))
    _, chain = _walk("chain", fuse)
    assert not torch.equal(got[0], chain[0])


@pytest.mark.parametrize("fuse", [1, 2, 3])
def test_noselect_drops_only_the_mid_stage_pins(fuse):
    _, got = _walk("noselect", fuse, shape=(6, 5, 20))
    _, chain = _walk("chain", fuse, shape=(6, 5, 20))
    same = all(torch.equal(g, c) for g, c in zip(got, chain))
    assert same == (fuse == 1)


@pytest.mark.parametrize("fuse", [1, 2])
def test_noyz_reads_no_y_or_z_neighbour(fuse):
    fields, got = _walk("noyz", fuse)
    _, noselect = _walk("noselect", fuse)
    assert not torch.equal(got[0], noselect[0])
    # Fields constant along y and z give every cell the x-only stencil
    # with either variant (noselect's y/z neighbours are the centre
    # there, away from the window's y/z edges).
    if fuse == 1:
        x = torch.linspace(0.0, 1.0, 20, dtype=torch.float32)
        flat = tuple(
            (x[:, None, None] * s).expand(20, 24, 70).contiguous()
            for s in (1.0, 0.5))
        a = envelope.plain_compute_walk(flat, _params(0.0), (1, 2, 7),
                                        spec=SPEC, fuse=1, use_noise=False,
                                        variant="noyz")
        b = envelope.plain_compute_walk(flat, _params(0.0), (1, 2, 7),
                                        spec=SPEC, fuse=1, use_noise=False,
                                        variant="noselect")
        inner = (slice(None), slice(1, None), slice(1, None))
        assert all(torch.equal(p[inner], q[inner]) for p, q in zip(a, b))


@pytest.mark.parametrize("fuse", [1, 2, 3])
def test_fma_is_the_chain_reassociated(fuse):
    _, got = _walk("fma", fuse)
    _, chain = _walk("chain", fuse)
    for g, c in zip(got, chain):
        assert torch.allclose(g, c, rtol=0, atol=1e-5)
    assert not all(torch.equal(g, c) for g, c in zip(got, chain))


@pytest.mark.parametrize("fuse", [1, 2, 3])
def test_minimal_is_one_multiply_per_stage(fuse):
    fields, got = _walk("minimal", fuse)
    p = _params(0.1)
    one = torch.ones(())
    coef = (one - p.dt * (p.Du + p.F), one - p.dt * (p.Dv + p.F + p.k))
    cut = envelope.defined_tile(fields[0].shape)
    for g, f, a in zip(got, fields, coef):
        want = f[cut]
        for _ in range(fuse):
            want = want * a
        assert torch.equal(g, want)


@pytest.mark.parametrize("fuse", [1, 2, 3])
def test_nomid_accumulates_each_stage_from_the_input(fuse):
    fields, got = _walk("nomid", fuse, noise=0.0)
    _, step = _walk("chain", 1, noise=0.0)
    cut = envelope.defined_tile(fields[0].shape)
    for g, f, s in zip(got, fields, step):
        want = f[cut].clone()
        for _ in range(fuse):
            want = want + s
        assert torch.equal(g, want)


@pytest.mark.parametrize("shape", [(20, 24, 40), (16, 16, 32), (5, 9, 33)])
@pytest.mark.parametrize("fuse", [1, 3, 5])
def test_copy_walk_on_the_cpu_is_the_identity(shape, fuse):
    fields = tuple(torch.from_numpy(x) for x in _seeded(shape, seed=4))
    launches = dict(cuda_stencil.MODE_LAUNCHES)
    got = envelope.copy_walk(fields, fuse=fuse)
    assert dict(cuda_stencil.MODE_LAUNCHES) == launches
    for g, f in zip(got, fields):
        assert torch.equal(g, f) and g.data_ptr() != f.data_ptr()


@pytest.mark.parametrize("variant", envelope.VARIANTS)
def test_compute_walk_on_the_cpu_defines_only_the_origin_tile(variant):
    shape = (20, 24, 40)
    fields = tuple(torch.from_numpy(x) for x in _seeded(shape, seed=5))
    got = envelope.compute_walk(fields, _params(0.1), (1, 2, 7), spec=SPEC,
                                fuse=2, use_noise=True, variant=variant)
    want = envelope.plain_compute_walk(fields, _params(0.1), (1, 2, 7),
                                       spec=SPEC, fuse=2, use_noise=True,
                                       variant=variant)
    cut = envelope.defined_tile(shape)
    for g, w in zip(got, want):
        assert g.shape == shape and torch.equal(g[cut], w)
        rest = torch.ones(shape, dtype=torch.bool)
        rest[cut] = False
        assert torch.isnan(g[rest]).all()


def test_wrappers_refuse_what_the_kernel_does_not_take():
    f32 = tuple(torch.zeros((8, 8, 8)) for _ in range(2))
    with pytest.raises(TypeError, match="float32"):
        envelope.copy_walk(tuple(x.double() for x in f32), fuse=1)
    with pytest.raises(ValueError, match=r"\[1, 5\]"):
        envelope.copy_walk(f32, fuse=6)
    with pytest.raises(ValueError, match="two fields"):
        envelope.copy_walk(f32[:1], fuse=1)
    with pytest.raises(ValueError, match="contiguous"):
        envelope.copy_walk(tuple(x.transpose(0, 2) for x in
                                 (torch.zeros((8, 8, 9)),) * 2), fuse=1)
    with pytest.raises(ValueError, match="variant"):
        envelope.compute_walk(f32, _params(0.1), (1, 2, 0), spec=SPEC,
                              fuse=1, use_noise=True, variant="nope")
    heat = kernelgen.get_spec(get_model("heat"))
    with pytest.raises(ValueError, match="Gray-Scott"):
        envelope.plain_compute_walk(f32, _params(0.1), (1, 2, 0), spec=heat,
                                    fuse=1, use_noise=True)


def test_case_names_follow_the_reference_probe():
    names = [envelope.case_name(v) for v in envelope.VARIANTS]
    assert names == ["compute_walk", "compute_nonoise", "compute_noselect",
                     "compute_noyz", "compute_fma", "compute_minimal",
                     "compute_nomid"]
    assert [envelope.case_variant(n) for n in names] == list(envelope.VARIANTS)
    with pytest.raises(ValueError):
        envelope.case_variant("full_walk")


def test_work_counts_bytes_and_operations():
    shape, fuse = (256, 256, 256), 1
    every = 2 * 2 * 256**3 * 4
    assert envelope.work("torch_copy", shape, fuse) == (every, every, 0)
    unique, issued, flops = envelope.work("copy_walk", shape, fuse)
    n_tiles = (256 // 8) * (256 // 8) * (256 // 32)
    assert unique == every and flops == 0
    assert issued == 2 * (10 * 10 * 34 * n_tiles + 256**3) * 4
    _, _, full = envelope.work("full", shape, 3)
    assert full == 3 * SPEC.flops_per_cell_step() * 256**3
    unique, _, flops = envelope.work("compute_walk", shape, 1)
    assert unique == 2 * (9 * 9 * 33 + 8 * 8 * 32) * 4
    assert flops == n_tiles * 8 * 8 * 32 * SPEC.flops_per_cell_step()
    _, _, quiet = envelope.work("compute_walk", shape, 1, use_noise=False)
    assert quiet == flops - 3 * 256**3
    _, _, minimal = envelope.work("compute_minimal", shape, 2)
    assert minimal == n_tiles * (10 * 10 * 34 + 8 * 8 * 32) * 2


def test_probe_cli_on_the_cpu_prints_one_line_per_case(monkeypatch, capsys,
                                                       tmp_path):
    monkeypatch.setenv("GS_PROBE_COMPUTE_VARIANTS", "1")
    out = tmp_path / "probe.jsonl"
    assert envelope_probe.main(["--cpu", "--l", "16", "--fuse", "2",
                                "--steps", "2", "--rounds", "2",
                                "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    rows = [json.loads(line) for line in lines]
    assert [r["case"] for r in rows] == [
        "torch_stream", "torch_copy", "copy_walk", "compute_walk", "full",
        "compute_nonoise", "compute_noselect", "compute_noyz", "compute_fma",
        "compute_minimal", "compute_nomid"]
    keys = {"case", "L", "fuse", "noise", "n_passes", "rounds_us_per_pass",
            "best_us_per_pass", "median_us_per_pass", "traffic_mb_per_pass",
            "effective_gbps", "unique_mb_per_pass", "bound_us_per_pass",
            "bound_by", "timer", "device"}
    for r in rows:
        assert keys <= set(r)
        assert (r["L"], r["fuse"], r["n_passes"]) == (16, 2, 1)
        assert len(r["rounds_us_per_pass"]) == 2
        assert r["best_us_per_pass"] == min(r["rounds_us_per_pass"])
        assert r["device"] == "cpu" and r["timer"] == "host_clock"
        assert math.isfinite(r["bound_us_per_pass"])
    assert [json.loads(x) for x in out.read_text().splitlines()] == rows


def test_probe_cli_refuses_bx_and_deep_chains(capsys):
    with pytest.raises(SystemExit) as exc:
        envelope_probe.main(["--cpu", "--l", "16", "--bx", "4"])
    assert exc.value.code == 2
    assert "--bx has no counterpart" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        envelope_probe.main(["--cpu", "--l", "16", "--fuse", "6"])


def test_probe_asks_for_the_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        envelope_probe.run(16, 1, 1, 1, 0.1, cpu=False)


def test_envelope_library_is_gray_scotts_second_build():
    src = _build.emitted_source(SPEC, envelope=True)
    assert src.startswith(_build.PROBE_DEFINE + "\n")
    assert src[len(_build.PROBE_DEFINE) + 1:] == _build.emitted_source(SPEC)
    path = _build.library_path(SPEC, envelope=True)
    assert Path(path).name.startswith("grayscott_envelope.")
    assert path != _build.library_path(SPEC)
    heat = kernelgen.get_spec(get_model("heat"))
    with pytest.raises(ValueError, match="envelope probes"):
        _build.emitted_source(heat, envelope=True)
    template = (Path(_build.CSRC) / _build.TEMPLATE).read_text()
    for entry in ("gs_envelope_copy_walk_f32", "gs_envelope_compute_walk_f32"):
        assert template.count(entry) == 1
    assert "#ifndef GS_ENVELOPE_PROBES" in template
