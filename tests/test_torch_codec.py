"""The lossy snapshot codec and bf16 stores of the port
(grayscott_jl_tpu_torch/io/codec.py, io/bplite.py, the driver's
boundary) against the reference on the CPU.

Tolerances: ``device_quantize``'s range bitwise and its payload within
one level (|dq| <= 1: both round half to even, but XLA:CPU may form the
scaled value with other float32 roundings); decoded values within
``error_bound`` of the exact field; a decode of the same payload equal
to the reference's. Stores cross between the packages exactly: a bf16
variable is named ``"bfloat16"`` and holds the bf16 bit patterns."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grayscott_jl_tpu import driver as ref_driver
from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.io import codec as ref_codec
from grayscott_jl_tpu.io.bplite import BpReader as RefReader
from grayscott_jl_tpu_torch import Settings, Simulation, driver
from grayscott_jl_tpu_torch.io import codec
from grayscott_jl_tpu_torch.io.bplite import BpReader, bf16_round
from grayscott_jl_tpu_torch.io.checkpoint import load_checkpoint
from grayscott_jl_tpu_torch.io.stream import put_fields
from grayscott_jl_tpu_torch.models import SettingsError

GS = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0)


@pytest.mark.parametrize("raw", [
    "8", " 12 ", "u:8,v:12", "v=4", "u:8,", "", "w:8", "1", "17", "x",
    "u:x",
])
def test_parse_bits_spec_matches_reference(raw):
    def run(fn):
        try:
            return fn(raw, ("u", "v"))
        except ValueError as e:
            return type(e)

    assert run(codec.parse_bits_spec) == run(ref_codec.parse_bits_spec)


@pytest.mark.parametrize("key,ckpt_key,env,env_ckpt,posture", [
    ("8", False, None, None, ""), ("u:8", True, None, None, ""),
    ("", False, "v:10", None, ""), ("8", False, "u:6", "1", ""),
    ("8", True, None, "0", ""), ("", True, None, None, ""),
    ("8", False, None, None, "equality"), ("", False, None, None,
                                            "equality"),
])
def test_resolve_snapshot_codec_matches_reference(key, ckpt_key, env,
                                                  env_ckpt, posture,
                                                  monkeypatch):
    """Env wins over the keys; ``equality`` refuses any codec."""
    for var, value in (("GS_SNAPSHOT_BITS", env),
                       ("GS_SNAPSHOT_BITS_CKPT", env_ckpt)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    kw = dict(snapshot_bits=key, snapshot_bits_ckpt=ckpt_key,
              compute_precision=posture, precision="Float32")

    def run(mod, settings):
        try:
            c = mod.resolve_snapshot_codec(settings, ("u", "v"))
            return c.posture(), c.describe()
        except ValueError as e:
            return type(e).__name__

    want = run(ref_codec, RefSettings(**kw))
    got = run(codec, Settings(**kw))
    assert got == want
    if posture == "equality" and key:
        assert got == "SettingsError"
        with pytest.raises(SettingsError, match="equality"):
            Simulation(Settings(L=8, backend="CPU", **kw))


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_error_bound_matches_reference(dtype):
    ref_dtype = jnp.dtype(dtype)
    for lo, hi, bits in ((-0.1, 1.3, 8), (0.0, 0.5, 12), (2.0, 2.0, 4)):
        assert codec.error_bound(lo, hi, bits, dtype) == pytest.approx(
            ref_codec.error_bound(lo, hi, bits, ref_dtype), rel=1e-12)
    assert codec.error_bound(0.0, 1.0, 8, torch.bfloat16) == (
        codec.error_bound(0.0, 1.0, 8, "bfloat16"))


def _field(seed, shape=(16, 16, 16)):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.1, 1.3, shape).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [4, 8, 12, 16])
def test_device_quantize_matches_reference(dtype, bits):
    """Range bitwise, payload within one level, and the decode of the
    port's payload within the bound of the exact field."""
    f = _field(bits)
    if dtype == torch.bfloat16:
        f = bf16_round(f)
    t = torch.from_numpy(f).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    q_ref, lo_ref, hi_ref = ref_codec.device_quantize(
        jnp.asarray(f).astype(jdt), bits)
    (q,), lo, hi = codec.device_quantize([t], bits)
    assert np.float32(lo) == np.asarray(lo_ref)
    assert np.float32(hi) == np.asarray(hi_ref)
    q = q.numpy().view(np.uint16) if bits > 8 else q.numpy()
    assert q.dtype == np.asarray(q_ref).dtype
    dq = np.abs(q.astype(np.int64) - np.asarray(q_ref).astype(np.int64))
    assert dq.max() <= 1, int(dq.max())
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    dec = codec.dequantize(q, lo, hi, bits, name)
    assert dec.dtype == np.float32
    assert np.abs(dec - f).max() <= codec.error_bound(lo, hi, bits, name)
    want = ref_codec.dequantize(q, lo, hi, bits, np.dtype(jdt))
    assert np.array_equal(dec, np.asarray(want).astype(np.float32))


def test_constant_field_decodes_exactly():
    (q,), lo, hi = codec.device_quantize([torch.full((4, 4, 4), 0.25)], 8)
    assert lo == hi == 0.25 and int(q.max()) == 0
    assert (codec.dequantize(q.numpy(), lo, hi, 8, "float32") == 0.25).all()


@pytest.mark.parametrize("dims", [(2, 2, 2), (3, 1, 1)])
def test_sharded_codec_range_is_global(dims):
    """On a mesh the range is the min/max over every block, so each
    block's payload equals the single block's payload over its box; a
    per-block range would give other payloads."""
    s = Settings(L=18, noise=0.1, backend="CPU", precision="BFloat16", **GS)
    single = Simulation(s, seed=1)
    mesh = Simulation(s, seed=1, mesh_dims=dims,
                      devices=["cpu"] * (dims[0] * dims[1] * dims[2]))
    single.iterate(4)
    mesh.iterate(4)
    spec = {0: 8, 1: 12}
    one = single.snapshot(encode=spec, exact=False)
    many = mesh.snapshot(encode=spec, exact=False)
    assert list(one) == [] and list(many) == []
    (_, _, *whole), = one.encoded
    local = []
    for offs, sizes, *entries in many.encoded:
        box = tuple(slice(o, o + n) for o, n in zip(offs, sizes))
        for w, e in zip(whole, entries):
            assert (e.lo, e.hi, e.bits) == (w.lo, w.hi, w.bits)
            assert np.array_equal(e.q, w.q[box])
            assert e.dtype == "bfloat16"
        local.append(float(mesh.blocks[len(local)][0].float().amin()))
    assert min(local) == whole[0].lo and len(set(local)) > 1


def _config(path, **kw):
    base = dict(L=16, steps=8, plotgap=4, noise=0.1, backend="CPU",
                kernel_language="Pallas", precision="Float32",
                output=str(path / "gs.bp"), **GS)
    base.update(kw)
    lines = []
    for key, value in base.items():
        if isinstance(value, bool):
            lines.append(f"{key} = {'true' if value else 'false'}")
        elif isinstance(value, str):
            lines.append(f'{key} = "{value}"')
        else:
            lines.append(f"{key} = {value}")
    path.mkdir(parents=True, exist_ok=True)
    cfg = path / "cfg.toml"
    cfg.write_text("\n".join(lines) + "\n")
    return str(cfg)


@pytest.mark.parametrize("posture", [
    dict(precision="BFloat16"),
    dict(compute_precision="bf16_f32acc"),
    dict(precision="BFloat16", snapshot_bits="u:8,v:12"),
    dict(snapshot_bits="6"),
])
def test_port_stores_open_in_the_reference_reader(posture, tmp_path):
    """A bf16 store (dtype name ``"bfloat16"``) and a coded store the
    port wrote read the same in both readers."""
    driver.main([_config(tmp_path, **posture)])
    store = str(tmp_path / "gs.bp")
    coded = "snapshot_bits" in posture
    with BpReader(store) as mine, RefReader(store) as ref:
        assert mine.attributes() == ref.attributes()
        for name in ("U", "V"):
            info = ref.available_variables()[name]
            if coded:
                attr = json.loads(ref.attributes()["snapshot_codec"])
                assert info.dtype.name in ("uint8", "uint16")
                assert name in attr
            elif posture.get("precision") == "BFloat16" or "compute_precision" in posture:
                assert info.dtype.name == "bfloat16"
            for i in range(ref.num_steps()):
                a = mine.get(name, step=i)
                b = np.asarray(ref.get(name, step=i)).astype(np.float32)
                assert a.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("precision", ["Float32", "BFloat16"])
def test_port_reads_reference_coded_store(precision, tmp_path):
    """A store the reference wrote with ``snapshot_bits = "u:8,v:12"``
    decodes in the port's reader to the reference reader's values,
    within ``error_bound`` of the reference's exact run."""
    ref_driver.main([_config(tmp_path / "coded", precision=precision,
                             snapshot_bits="u:8,v:12")], n_devices=1)
    ref_driver.main([_config(tmp_path / "exact", precision=precision)],
                    n_devices=1)
    coded = str(tmp_path / "coded" / "gs.bp")
    with BpReader(coded) as mine, RefReader(coded) as ref, \
            RefReader(str(tmp_path / "exact" / "gs.bp")) as exact:
        attr = json.loads(mine.attributes()["snapshot_codec"])
        assert mine.num_steps() == 2
        for i in range(2):
            for name, bits in (("U", 8), ("V", 12)):
                got = mine.get(name, step=i)
                want = np.asarray(ref.get(name, step=i)).astype(np.float32)
                assert np.array_equal(got, want)
                lo = float(mine.get(f"{name}__qlo", step=i))
                hi = float(mine.get(f"{name}__qhi", step=i))
                x = np.asarray(exact.get(name, step=i)).astype(np.float32)
                bound = codec.error_bound(lo, hi, bits, attr[name]["dtype"])
                assert np.abs(got - x).max() <= bound


def test_boundary_captures_exact_copies_only_when_needed(tmp_path,
                                                         monkeypatch):
    """Coded output and an exact checkpoint: the checkpoint restarts
    bitwise; with ``snapshot_bits_ckpt`` the checkpoint is coded too and
    a restart from it starts within the bound."""
    calls = []
    real = Simulation.snapshot_async

    def spy(self, encode=None, exact=True, **kw):
        calls.append((bool(encode), exact))
        return real(self, encode=encode, exact=exact, **kw)

    # The driver's boundaries go through snapshot_async (the output
    # pipeline's capture).
    monkeypatch.setattr(Simulation, "snapshot_async", spy)
    kw = dict(precision="BFloat16", snapshot_bits="8", checkpoint=True,
              checkpoint_freq=8, checkpoint_output=str(tmp_path / "ck.bp"))
    driver.main([_config(tmp_path / "a", **kw)])
    assert calls == [(True, False), (True, True)]
    u, v, step = load_checkpoint(str(tmp_path / "ck.bp"), Settings(
        precision="BFloat16", L=16))
    sim = Simulation(Settings(L=16, noise=0.1, backend="CPU",
                              precision="BFloat16", **GS))
    sim.iterate(8)
    assert step == 8
    assert all(np.array_equal(a, b) for a, b in zip((u, v),
                                                    sim.get_fields()))
    calls.clear()
    kw.update(checkpoint_output=str(tmp_path / "lossy.bp"),
              snapshot_bits_ckpt=True)
    driver.main([_config(tmp_path / "b", **kw)])
    assert calls == [(True, False), (True, False)]
    with BpReader(str(tmp_path / "lossy.bp")) as r:
        assert r.inquire_variable("u").dtype == np.uint8
        lo, hi = float(r.get("u__qlo", step=0)), float(r.get("u__qhi",
                                                               step=0))
    lu, lv, _ = load_checkpoint(str(tmp_path / "lossy.bp"), Settings(
        precision="BFloat16", L=16))
    assert np.abs(lu - u).max() <= codec.error_bound(lo, hi, 8, "bfloat16")
    restart = dict(kw, restart=True, restart_input=str(tmp_path / "lossy.bp"),
                   steps=12, output=str(tmp_path / "re.bp"),
                   checkpoint=False)
    sim = driver.main([_config(tmp_path / "c", **restart)])
    assert sim.step == 12
    assert all(np.isfinite(f).all() for f in sim.get_fields())


def test_coded_store_refuses_exact_blocks():
    class Writer:
        def put(self, *a, **k):
            raise AssertionError("nothing is written")

    with pytest.raises(ValueError, match="codec form"):
        put_fields(Writer(), ("U",), [((0, 0, 0), (2, 2, 2),
                                       np.zeros((2, 2, 2)))], coded=True)
