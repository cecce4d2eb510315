"""The kernel generator (grayscott_jl_tpu_torch/ops/kernelgen.py) on the
CPU, beside the reference's generator (grayscott_jl_tpu/ops/kernelgen.py).

* The gate: every built-in model passes; each of the reference's four
  refusals has its counterpart, with the same reason class and wording.
* The emitter's operation order: the traced program, replayed by a small
  torch interpreter one op per SSA entry, equals ``model.reaction``
  bitwise for every model in float32 and float64 (the generated CUDA
  kernel performs the program's operations in the program's order).
* The path: brusselator, fhn and heat through the port's kernel language
  on the CPU (the kernel's plain versions) against the reference's
  generated Pallas kernel in interpret mode (as
  ``tests/unit/test_kernelgen.py`` runs it), L=16, 10 steps, noise 0.1,
  dt 0.05, seed 7, the same start fields. Tolerance atol 1e-5, the
  reference's own; the measured max |diff| over both fields was 7.2e-7
  (brusselator), 1.2e-7 (fhn) and 1.2e-7 (heat), the XLA:CPU
  FMA-contraction drift of ``tests/test_torch_cuda_stencil.py``.

The generated kernel itself is held against its plain version on the
card by tests/test_torch_card.py and chip_smoke.py.
"""

import math
import operator
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grayscott_jl_tpu.config.settings import Settings as RefSettings
from grayscott_jl_tpu.models import base as ref_base
from grayscott_jl_tpu.ops import kernelgen as ref_kernelgen
from grayscott_jl_tpu.simulation import Simulation as RefSimulation
from grayscott_jl_tpu_torch import Settings, Simulation
from grayscott_jl_tpu_torch import driver
from grayscott_jl_tpu_torch.carry import blocks_from_reference
from grayscott_jl_tpu_torch.models import SettingsError, base, get_model
from grayscott_jl_tpu_torch.ops import _build, cuda_stencil, kernelgen

MODELS = ("grayscott", "brusselator", "fhn", "heat")

#: Each model's physics from examples/settings-<model>.toml.
PHYSICS = {
    "brusselator": {"A": 1.0, "B": 3.0, "Du": 0.2, "Dv": 0.02},
    "fhn": {"a": 0.7, "b": 0.8, "eps": 0.08, "I": 0.5, "Dv": 0.2,
            "Dw": 0.0},
    "heat": {"D": 0.2},
}


# ------------------------------------------------------------ fixtures

def _heat_init(L, dtype, *, offsets=(0, 0, 0), sizes=None, device=None):
    return base.seeded_box_init(
        L, dtype, backgrounds=(0.0,), seed_values=(1.0,), half_width=4,
        offsets=offsets, sizes=sizes, device=device,
    )


def _port_model(name, reaction, params=("D", "relax"), register=False):
    model = base.Model(
        name=name, field_names=("t",), boundaries=(0.0,),
        param_decls=dict.fromkeys(params, 0.1), reaction=reaction,
        init=_heat_init,
    )
    return base.register(model) if register else model


def _ref_model(name, reaction, params=("D", "relax")):
    return ref_base.Model(
        name=name, field_names=("t",), boundaries=(0.0,),
        param_decls=dict.fromkeys(params, 0.1), reaction=reaction,
        init=lambda L, dtype, **kw: None,
    )


def meanfield(fields, laps, noise, params):
    """A cross-cell reduction: the generator must refuse it."""
    (t,) = fields
    (lap,) = laps
    mean = torch.sum(t) / t.numel()
    return (params.D * lap + (mean - t) * params.relax + noise,)


def ref_meanfield(fields, laps, noise, params):
    (t,) = fields
    (lap,) = laps
    mean = jnp.sum(t) / t.size
    return (params.D * lap + (mean - t) * params.relax + noise,)


def two_for_one(fields, laps, noise, params):
    (t,) = fields
    (lap,) = laps
    return (params.D * lap, t)


def wrong_shape(fields, laps, noise, params):
    (t,) = fields
    return (torch.stack([t, t]),)


def ref_wrong_shape(fields, laps, noise, params):
    (t,) = fields
    return (jnp.stack([t, t]),)


def fails(fields, laps, noise, params):
    return (1 / 0,)


#: (port reaction, reference reaction) for each refusal class.
REFUSALS = {
    "non_elementwise": (meanfield, ref_meanfield),
    "arity": (two_for_one, two_for_one),
    "shape": (wrong_shape, ref_wrong_shape),
    "trace": (fails, fails),
}


@pytest.fixture
def refused():
    """The mean-field fixture, registered so that a Settings file can
    name it."""
    model = _port_model("meanfield_fixture", meanfield, register=True)
    try:
        yield model
    finally:
        base._REGISTRY.pop("meanfield_fixture", None)


def every_op(fields, laps, noise, params):
    """One of each whitelisted op the four models do not use."""
    (t,) = fields
    (lap,) = laps
    half = t.new_tensor(0.5)
    a = (t / 3.0 + 2.0 / (t + 1.0)) * half - torch.sqrt(t) ** 3
    b = torch.maximum(-a, abs(lap)) + torch.minimum(t ** 2, t / params.D)
    c = torch.square(b) - t.reciprocal() + (t ** 0.5).clone()
    d = torch.exp(-t) + torch.tanh(lap) * torch.sigmoid(t) - torch.log1p(t)
    return (params.D * lap + c * params.relax + d * 1e-3 + noise,)


# ------------------------------------------------------------------ gate

@pytest.mark.parametrize("name", MODELS)
def test_every_builtin_model_passes_the_gate(name):
    model = get_model(name)
    assert kernelgen.generation_gate_reason(model) is None
    spec = kernelgen.get_spec(model)
    assert spec.version == kernelgen.GENERATOR_VERSION
    assert spec.n_fields == model.n_fields
    assert spec.boundaries == model.boundaries
    for dtype in ("float32", "float64"):
        program = spec.programs[dtype]
        assert program.exact, "the built-in models use + - * only"
        assert len(program.outputs) == model.n_fields
        assert {op for op, _ in program.ops} <= {"add", "sub", "mul"}
    fields = model.params_cls._fields
    src = spec.cuda_source
    assert f"constexpr int kNF = {model.n_fields};" in src
    assert f"constexpr int kNP = {len(fields)};" in src
    assert f"constexpr int kDt = {fields.index('dt')};" in src
    assert f"constexpr int kNoise = {fields.index('noise')};" in src
    assert src.count("void gs_reaction(") == 2


@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_refusals_match_the_reference(kind):
    """Each refusal carries the reference's reason: the same text, but
    for the op names of a non-elementwise refusal (torch's ``sum`` where
    JAX names ``reduce_sum``)."""
    port_fn, ref_fn = REFUSALS[kind]
    reason = kernelgen.generation_gate_reason(
        _port_model(f"{kind}_fixture", port_fn))
    want = ref_kernelgen.generation_gate_reason(
        _ref_model(f"{kind}_fixture", ref_fn))
    assert reason is not None and want is not None
    if kind == "non_elementwise":
        head = "reaction uses non-elementwise primitive(s) ["
        tail = ("]; the slab pipeline only sees a local window, so "
                "cross-cell ops cannot be inlined")
        for r in (reason, want):
            assert r.startswith(head) and r.endswith(tail), r
        assert "'sum'" in reason and "reduce_sum" in want
    else:
        assert reason == want
    with pytest.raises(kernelgen.KernelGenError) as err:
        kernelgen.build_spec(_port_model(f"{kind}_fixture", port_fn))
    assert reason in str(err.value)
    assert "cannot generate a CUDA kernel" in str(err.value)


@pytest.mark.parametrize("expr,op", [
    ("t.sum()", "sum"), ("t[0] + t", "getitem"), ("t.flip(0)", "flip"),
    ("torch.roll(t, 1, 0)", "roll"), ("t * t.numel()", "numel"),
    ("t.mean() + t", "mean"), ("torch.addcmul(t, t, t)", "addcmul"),
    ("t.add_(1.0)", "add_"), ("t + float(t.max())", "max"),
    ("torch.add(t, t, alpha=2.0)", "add(alpha=2.0)"),
])
def test_gate_names_the_op_it_refuses(expr, op):
    """Ops that couple cells, bake the window's shape, fuse two roundings
    or mutate an input are outside the whitelist."""
    def reaction(fields, laps, noise, params):
        (t,) = fields
        return (eval(expr, {"torch": torch, "t": t}) + noise,)

    reason = kernelgen.generation_gate_reason(_port_model("op_fixture",
                                                          reaction))
    assert reason is not None and f"'{op}'" in reason, reason


def test_spec_is_memoized_per_model():
    heat = get_model("heat")
    assert kernelgen.get_spec(heat) is kernelgen.get_spec(heat)
    other = _port_model("heat_copy", heat.reaction, params=("D",))
    assert kernelgen.get_spec(other) is not kernelgen.get_spec(heat)


def test_generation_gate_touches_no_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in MODELS:
        assert kernelgen.generation_gate_reason(get_model(name)) is None


# ---------------------------------------------------------------- replay

#: The SSA interpreter: one torch operation per program op, made the way
#: the reaction made it (a Python operator on the same operand kinds).
REPLAY = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "div": operator.truediv, "rdiv": lambda a, b: b / a,
    "pow": operator.pow, "neg": operator.neg, "abs": abs,
    "square": torch.square, "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
    "reciprocal": torch.reciprocal, "exp": torch.exp,
    "expm1": torch.expm1, "log": torch.log, "log1p": torch.log1p,
    "sigmoid": torch.sigmoid, "tanh": torch.tanh, "sin": torch.sin,
    "cos": torch.cos, "maximum": torch.maximum,
    "minimum": torch.minimum, "copy": lambda a: a,
}


def replay(program, fields, laps, noise, params):
    dtype = getattr(torch, program.dtype)
    env = []

    def value(ref):
        kind = ref[0]
        if kind == "field":
            return fields[ref[1]]
        if kind == "lap":
            return laps[ref[1]]
        if kind == "noise":
            return noise
        if kind == "param":
            return params[ref[1]]
        if kind == "scalar":
            return ref[1]
        if kind == "const":
            return torch.tensor(ref[1], dtype=dtype)
        return env[ref[1]]

    for name, args in program.ops:
        env.append(REPLAY[name](*(value(a) for a in args)))
    return tuple(value(r) for r in program.outputs)


def _inputs(model, dtype, seed, shape=(6, 7, 9)):
    rng = np.random.default_rng(seed)
    tdtype = getattr(torch, dtype)

    def draw(size=shape):
        return torch.from_numpy(rng.uniform(0.05, 1.5, size).astype(dtype))

    n = model.n_fields
    fields = tuple(draw() for _ in range(n))
    laps = tuple(draw() - 0.75 for _ in range(n))
    noise = draw() - 0.75
    params = model.params_cls(*(
        torch.tensor(rng.uniform(0.05, 1.0), dtype=tdtype)
        for _ in model.params_cls._fields
    ))
    return fields, laps, noise, params


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", MODELS)
def test_program_replay_equals_reaction_bitwise(name, dtype):
    model = get_model(name)
    program = kernelgen.get_spec(model).programs[dtype]
    for seed in range(3):
        fields, laps, noise, params = _inputs(model, dtype, seed)
        for nz in (noise, 0.0):  # the plain path passes 0.0 without noise
            want = model.reaction(fields, laps, nz, params)
            got = replay(program, fields, laps, nz, params)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                assert torch.equal(g, w), (name, dtype, seed)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_every_whitelisted_op_replays_bitwise(dtype):
    model = _port_model("every_op_fixture", every_op)
    spec = kernelgen.build_spec(model)
    program = spec.programs[dtype]
    assert not program.exact  # exp, tanh, sigmoid, log1p: math library
    fields, laps, noise, params = _inputs(model, dtype, 11)
    want = every_op(fields, laps, noise, params)
    got = replay(program, fields, laps, noise, params)
    assert torch.equal(got[0], want[0])
    ops = [op for op, _ in program.ops]
    for op in ("div", "rdiv", "pow", "maximum", "minimum", "neg", "abs",
               "square", "reciprocal", "sqrt", "copy", "exp", "tanh",
               "sigmoid", "log1p"):
        assert op in ops, op


# --------------------------------------------------------------- emitter

@pytest.mark.parametrize("value", [1.0, 0.1, 1 / 3, -2.5e-7, 0.0, 1e38,
                                   math.inf, -math.inf])
def test_literals_are_exact(value):
    f32 = kernelgen.literal(value, "float32")
    f64 = kernelgen.literal(value, "float64")
    if math.isfinite(value):
        assert f32.endswith("f")
        assert float.fromhex(f32[:-1]) == float(np.float32(value))
        assert float.fromhex(f64) == value
    else:
        assert f32.startswith("__int_as_float(0x")
        assert f64.startswith("__longlong_as_double(0x")
    nan = kernelgen.literal(math.nan, "float32")
    assert nan.startswith("__int_as_float(0x7FC")


def test_emitter_lowers_ops_as_torch_cuda_does():
    """A quotient by a Python scalar multiplies by the reciprocal rounded
    once, ``x ** 2``/``x ** 3`` are products and ``x ** 0.5`` the
    correctly rounded square root, ``c / x`` is ``(1 / x) * c``; every
    operation is one of the template's rounded helpers."""
    def reaction(fields, laps, noise, params):
        (t,) = fields
        return (t / 3.0 + 2.0 / t + t ** 2 + t ** 3 + t ** 0.5 + noise,)

    spec = kernelgen.build_spec(_port_model("lowering_fixture", reaction))
    assert spec.programs["float32"].exact
    src = spec.cuda_source
    third = float(np.float32(1.0) / np.float32(3.0))
    assert f"mul(f[0], {third.hex()}f)" in src
    assert f"mul(f[0], {(1 / 3.0).hex()})" in src
    one, two = (kernelgen.literal(v, "float32") for v in (1.0, 2.0))
    assert f"mul(div({one}, f[0]), {two})" in src
    assert "mul(f[0], f[0])" in src
    assert "mul(mul(f[0], f[0]), f[0])" in src
    assert "sqrt_rn(f[0])" in src
    assert "expf" not in src and "powf" not in src


@pytest.mark.parametrize("name", MODELS)
def test_flops_count_the_program(name):
    spec = kernelgen.get_spec(get_model(name))
    n_ops = len(spec.programs["float32"].ops)
    assert spec.flops_per_cell_step() == 9 * spec.n_fields + 3 + n_ops
    assert spec.flops_per_cell_step() == spec.flops_per_cell_step("float64")


def test_emitted_sources_fill_the_template():
    """One library per model, named by a hash of the emitted text; the
    template carries no model's reaction."""
    with open(os.path.join(_build.CSRC, _build.TEMPLATE)) as f:
        template = f.read()
    assert template.count(_build.MARKER) == 1
    assert "grayscott_reaction" not in template
    assert "kNF" in template and "constexpr int kNF" not in template
    paths = set()
    for name in MODELS:
        spec = kernelgen.get_spec(get_model(name))
        src = _build.emitted_source(spec)
        assert _build.MARKER not in src and spec.cuda_source.strip() in src
        path = _build.library_path(spec)
        assert path == _build.library_path(spec)
        assert os.path.basename(path).startswith(f"{name}.")
        assert os.path.dirname(path) == _build.BUILD_DIR
        paths.add(path)
    assert len(paths) == len(MODELS)
    assert {s.name for s in _build.all_specs()} >= set(MODELS)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No fallback: a build with no compiler raises."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all([kernelgen.get_spec(get_model("heat"))])
    written = [p for p in os.listdir(tmp_path) if p.endswith(".cu")]
    assert len(written) == 1 and written[0].startswith("heat.")


# ------------------------------------------------------------------ path

def _port(model, dims=None):
    """The port on the kernel language, on the CPU: one block, or a
    ``dims`` mesh of blocks."""
    settings = Settings(L=16, noise=0.1, dt=0.05, precision="Float32",
                        backend="CPU", kernel_language="CUDA", model=model,
                        model_params=dict(PHYSICS[model]))
    if dims is None:
        return Simulation(settings, seed=7)
    return Simulation(settings, seed=7, mesh_dims=dims,
                      devices=["cpu"] * (dims[0] * dims[1] * dims[2]))


def _pair(model):
    """The reference's generated Pallas kernel (interpret mode) and the
    port, from the same start fields."""
    ref = RefSimulation(
        RefSettings(L=16, noise=0.1, dt=0.05, precision="Float32",
                    backend="CPU", kernel_language="Pallas", model=model,
                    model_params=dict(PHYSICS[model])),
        n_devices=1, seed=7,
    )
    port = _port(model)
    port.blocks = blocks_from_reference(
        [np.asarray(f) for f in ref.get_fields()], port)
    return ref, port


@pytest.mark.parametrize("model", ["brusselator", "fhn", "heat"])
def test_generated_path_matches_reference_pallas(model):
    ref, port = _pair(model)
    assert ref.kernel_language == "pallas"
    assert port.kernel_language == "cuda"
    assert port.spec is kernelgen.get_spec(get_model(model))
    launches = cuda_stencil.LAUNCHES
    ref.iterate(10)
    port.iterate(10)
    assert cuda_stencil.LAUNCHES == launches  # CPU: the plain versions
    for name, a, b in zip(port.model.field_names, ref.get_fields(),
                          port.get_fields()):
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-5,
                                   err_msg=f"{model}.{name}")


def test_brusselator_mesh_equals_single_block_bitwise():
    single = _port("brusselator")
    mesh = _port("brusselator", dims=(2, 2, 2))
    assert mesh.sharded and mesh.domain.dims == (2, 2, 2)
    single.iterate(10)
    mesh.iterate(10)
    for a, b in zip(single.get_fields(), mesh.get_fields()):
        assert np.array_equal(a, b)


def test_cuda_refuses_a_model_the_generator_refuses(refused):
    with pytest.raises(SettingsError, match="non-elementwise") as err:
        Simulation(Settings(L=8, backend="CPU", model=refused.name,
                            kernel_language="CUDA"))
    assert "'Plain'" in str(err.value) and "'sum'" in str(err.value)
    with pytest.raises(SettingsError, match="cannot be generated"):
        Simulation(Settings(L=8, backend="CPU", model=refused.name,
                            kernel_language="Pallas"))


def test_auto_records_the_gate_and_runs_plain(refused, tmp_path, capsys,
                                              monkeypatch):
    settings = Settings(L=8, steps=4, plotgap=2, noise=0.1, backend="CPU",
                        model=refused.name, kernel_language="Auto",
                        precision="Float32",
                        output=str(tmp_path / "out.bp"))
    stats = tmp_path / "stats.json"
    monkeypatch.setenv("GS_TPU_STATS", str(stats))
    sim = driver.run_once(settings)
    gate = sim.kernel_selection["kernel_gate"]
    assert sim.kernel_language == "plain" and sim.spec is refused
    assert gate == {"model": refused.name, "generated": False,
                    "reason": kernelgen.generation_gate_reason(refused)}
    assert "plain torch path" in sim.kernel_selection["reason"]
    assert "no CUDA kernel can be generated" in capsys.readouterr().err
    assert sim.step == 4
    assert all(np.isfinite(f).all() for f in sim.get_fields())
    import json

    config = json.loads(stats.read_text())["config"]
    assert config["kernel_language"] == "plain"
    assert config["kernel_selection"]["kernel_gate"]["generated"] is False


@pytest.mark.parametrize("lang,selection", [("Auto", True), ("CUDA", False)])
def test_builtin_models_select_the_generated_kernel(lang, selection,
                                                    monkeypatch):
    if lang == "Auto":
        # Auto picks the kernel on the card (off it, the plain path, as
        # the reference picks XLA off the TPU): a monkeypatched card,
        # the blocks on the host's device.
        from grayscott_jl_tpu_torch import simulation

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(simulation, "select_devices",
                            lambda kind, n, devices: [torch.device("cpu")])
    sim = Simulation(Settings(L=8, backend="CUDA" if lang == "Auto"
                              else "CPU", model="heat",
                              kernel_language=lang))
    assert sim.kernel_language == "cuda"
    if selection:
        assert sim.kernel_selection["kernel_gate"] == {
            "model": "heat", "generated": True, "reason": None}
    else:
        assert sim.kernel_selection is None


def test_model_launches_reset():
    cuda_stencil.MODEL_LAUNCHES["heat"] = 3
    cuda_stencil.reset_launches()
    assert cuda_stencil.MODEL_LAUNCHES == {}
    assert cuda_stencil.LAUNCHES == 0


@pytest.mark.parametrize("model", ["heat", "fhn"])
@pytest.mark.parametrize("dims", [(2, 2, 2), (4, 1, 1)])
def test_other_models_shard_bitwise_on_kernel_language(model, dims,
                                                       monkeypatch):
    """The sharded kernel-language branches (6n faces at depth 1, the
    x-chain and xy-chain at depth 2) with one field and with two
    non-Gray-Scott fields, bitwise equal to the single block."""
    for fuse in ("1", "2"):
        monkeypatch.setenv("GS_FUSE", fuse)
        single = _port(model)
        mesh = _port(model, dims=dims)
        single.iterate(6)
        mesh.iterate(6)
        for a, b in zip(single.get_fields(), mesh.get_fields()):
            assert np.array_equal(a, b), (model, dims, fuse)
