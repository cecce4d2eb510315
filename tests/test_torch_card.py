"""The generated CUDA kernels on the card (tests marked ``cuda``; each
skips where ``torch.cuda.is_available()`` is false).

Imports neither JAX nor the reference package, so it runs on a machine
with only torch and nvcc:

    GS_TPU_TESTS=1 python -m pytest -m cuda tests/test_torch_card.py

(``GS_TPU_TESTS=1`` keeps tests/conftest.py from pinning JAX.) Each
model's kernel must equal its plain torch version bitwise: both perform
the same IEEE operations in the same order (``--fmad=false``); only the
math-library ops are held at a stated tolerance."""

from pathlib import Path

import pytest
import torch

from grayscott_jl_tpu_torch.config.settings import Settings
from grayscott_jl_tpu_torch.models import get_model, grayscott
from grayscott_jl_tpu_torch.ops import cuda_stencil, kernelgen

SPEC = kernelgen.get_spec(grayscott.MODEL)
KW = dict(F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: pytest -m cuda on the H100)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_kernel_equals_plain_on_card(dtype, noise):
    """chip_smoke.py phase 3 at L=32: every depth up to the ledger's
    cap, bitwise equal to the plain version and to k launches of
    depth 1."""
    _card()
    L, steps = 32, 20
    params = grayscott.MODEL.make_params(
        Settings(noise=noise, **KW), dtype, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    f0 = tuple(torch.rand((L, L, L), generator=gen, device="cuda",
                          dtype=dtype) for _ in range(2))
    plain = cuda_stencil.plain_chain(f0, params, (0, 2, 0), spec=SPEC,
                                     use_noise=noise != 0, fuse=steps)
    cap = cuda_stencil.max_feasible_fuse(f0[0].element_size())
    for fuse in range(1, cap + 1):
        launches = cuda_stencil.LAUNCHES
        f, done = f0, 0
        while done < steps:
            k = min(fuse, steps - done)
            f = cuda_stencil.fused_step(f, params, (0, 2, done), spec=SPEC,
                                        use_noise=noise != 0, fuse=k)
            done += k
        torch.cuda.synchronize()
        assert cuda_stencil.LAUNCHES - launches == -(-steps // fuse)
        for a, b in zip(f, plain):
            assert torch.equal(a, b), (fuse, (a - b).abs().max().item())


def _sum_reaction(fields, laps, noise, params):
    (t,) = fields
    return (params.D * laps[0] + (t.sum() - t) * 1e-3 + noise,)


@pytest.mark.cuda
def test_kernel_refuses_models_it_does_not_carry():
    """A model the generator refuses has no kernel: no spec, CUDA raises
    at construction, and Auto runs the plain path on the card (no
    launch), recording the gate."""
    _card()
    from grayscott_jl_tpu_torch import Simulation
    from grayscott_jl_tpu_torch.models import SettingsError, base

    heat = get_model("heat")
    model = base.register(base.Model(
        name="sum_card_fixture", field_names=("t",), boundaries=(0.0,),
        param_decls={"D": 0.1}, reaction=_sum_reaction, init=heat.init))
    try:
        with pytest.raises(kernelgen.KernelGenError, match="'sum'"):
            kernelgen.get_spec(model)
        s = Settings(L=16, noise=0.1, precision="Float32", backend="CUDA",
                     model=model.name, kernel_language="CUDA")
        with pytest.raises(SettingsError, match="non-elementwise"):
            Simulation(s)
        s.kernel_language = "Auto"
        sim = Simulation(s)
        assert sim.kernel_language == "plain"
        assert sim.kernel_selection["kernel_gate"]["generated"] is False
        launches = cuda_stencil.LAUNCHES
        sim.iterate(3)
        torch.cuda.synchronize()
        assert cuda_stencil.LAUNCHES == launches
        assert sim.blocks[0][0].is_cuda
        assert all(torch.isfinite(f).all() for f in sim.blocks[0])
    finally:
        base._REGISTRY.pop("sum_card_fixture", None)


#: Each model's physics (examples/settings-<model>.toml; Gray-Scott's
#: from the kernel tests above).
PHYSICS = {
    "grayscott": KW,
    "brusselator": dict(model_params={"A": 1.0, "B": 3.0, "Du": 0.2,
                                      "Dv": 0.02}, dt=0.05),
    "fhn": dict(model_params={"a": 0.7, "b": 0.8, "eps": 0.08, "I": 0.5,
                              "Dv": 0.2, "Dw": 0.0}, dt=0.05),
    "heat": dict(model_params={"D": 0.2}, dt=0.05),
}


def _model_case(name, dtype, noise):
    model = get_model(name)
    settings = Settings(noise=noise, model=name, **PHYSICS[name])
    return (kernelgen.get_spec(model),
            model.make_params(settings, dtype, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["grayscott", "brusselator", "fhn", "heat"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_generated_kernel_equals_plain_in_every_mode(name, dtype, noise):
    """Each model's generated kernel in every mode — the chain at every
    depth up to the model's ledger cap, the 6n-face step, the x-chain
    and the xy-chain operand — bitwise equal to its plain version, and
    every launch counted for the model."""
    _card()
    spec, params = _model_case(name, dtype, noise)
    use = noise != 0
    n = spec.n_fields
    gen = torch.Generator(device="cuda").manual_seed(17)

    def rand(shape):
        return torch.rand(shape, generator=gen, device="cuda", dtype=dtype)

    cuda_stencil.reset_launches()
    L, steps = 20, 12
    f0 = tuple(rand((L, L, L)) for _ in range(n))
    plain = cuda_stencil.plain_chain(f0, params, (0, 2, 0), spec=spec,
                                     use_noise=use, fuse=steps)
    cap = cuda_stencil.max_feasible_fuse(f0[0].element_size(), n)
    expected = 0
    for fuse in range(1, cap + 1):
        f, done = f0, 0
        while done < steps:
            k = min(fuse, steps - done)
            f = cuda_stencil.fused_step(f, params, (0, 2, done), spec=spec,
                                        use_noise=use, fuse=k)
            done += k
            expected += 1
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(f, plain)), (name, fuse)
    shape = (12, 10, 36)
    f = tuple(rand(shape) for _ in range(n))
    nx, ny, nz = shape
    faces = tuple(rand(x) for x in [(1, ny, nz)] * (2 * n)
                  + [(nx, 1, nz)] * (2 * n) + [(nx, ny, 1)] * (2 * n))
    a = cuda_stencil.fused_step(f, params, (0, 1, 4), faces, spec=spec,
                                use_noise=use, offsets=(12, 10, 0), row=48)
    b = cuda_stencil.plain_step(f, params, (0, 1, 4), faces, spec=spec,
                                use_noise=use, offsets=(12, 10, 0), row=48)
    expected += 1
    assert all(torch.equal(x, y) for x, y in zip(a, b)), (name, "faces6")
    for k in range(2, cap + 1):
        for y_halo, offs in ((0, (12, 0, 0)), (k, (12, -k, 0))):
            faces = tuple(rand((k, ny, nz)) for _ in range(2 * n))
            a = cuda_stencil.fused_step(
                f, params, (0, 1, 4), faces, spec=spec, use_noise=use,
                fuse=k, offsets=offs, row=30, y_halo=y_halo)
            b = cuda_stencil.plain_xchain(
                f, params, (0, 1, 4), faces, spec=spec, use_noise=use,
                fuse=k, offsets=offs, row=30)
            expected += 1
            assert all(torch.equal(x, y) for x, y in zip(a, b)), (name, k)
    assert cuda_stencil.MODEL_LAUNCHES == {name: expected}


def _exact_ops(fields, laps, noise, params):
    """The whitelisted ops that lower to correctly rounded arithmetic
    (square roots and quotients of ``u = t * t + 1 >= 1``, so no value
    turns NaN)."""
    (t,) = fields
    (lap,) = laps
    u = t * t + 1.0
    a = (t / 3.0 + 2.0 / u) * t.new_tensor(0.5) - torch.sqrt(u) ** 3
    b = torch.maximum(-a, abs(lap)) + torch.minimum(t ** 2, u / params.D)
    c = torch.square(b) - u.reciprocal() + (u ** 0.5).clone()
    return (params.D * lap + c * 1e-2 + noise,)


def _libm_ops(fields, laps, noise, params):
    """The whitelisted ops lowered through CUDA's math library (on
    ``u = t * t + 1 >= 1``)."""
    (t,) = fields
    (lap,) = laps
    u = t * t + 1.0
    d = (torch.exp(-u) + torch.tanh(lap) * torch.sigmoid(t)
         - torch.log1p(u) + torch.expm1(t * 0.1) - torch.log(u)
         + torch.sin(t) * torch.cos(lap) + torch.rsqrt(u) + u ** 1.5)
    return (params.D * lap + d * 1e-2 + noise,)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("reaction,atol", [
    (_exact_ops, None), (_libm_ops, {torch.float32: 1e-6,
                                     torch.float64: 1e-14}),
])
def test_generated_ops_on_card(reaction, atol, dtype):
    """Every op the emitter lowers, on the card against the plain torch
    version of the same reaction: the exactly rounded ops bitwise; the
    math-library ops (CUDA's libm need not equal torch's kernels bit for
    bit) within atol 1e-6 (float32) / 1e-14 (float64) after 4 steps of
    fields in (0, 1), a few ulps of the derivative scaled by dt = 0.05."""
    _card()
    from grayscott_jl_tpu_torch.models import base

    heat = get_model("heat")
    model = base.Model(name=f"{reaction.__name__}_fixture",
                       field_names=("t",), boundaries=(0.5,),
                       param_decls={"D": 0.2}, reaction=reaction,
                       init=heat.init)
    spec = kernelgen.get_spec(model)
    assert spec.programs[str(dtype).split(".")[1]].exact == (atol is None)
    params = model.make_params(Settings(noise=0.1, dt=0.05), dtype, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    f0 = (torch.rand((24, 24, 24), generator=gen, device="cuda",
                     dtype=dtype) + 0.01,)
    got = f0
    for s in range(4):
        got = cuda_stencil.fused_step(got, params, (0, 5, s), spec=spec)
    want = cuda_stencil.plain_chain(f0, params, (0, 5, 0), spec=spec,
                                    fuse=4)
    torch.cuda.synchronize()
    assert torch.isfinite(want[0]).all()
    if atol is None:
        assert torch.equal(got[0], want[0]), (
            (got[0] - want[0]).abs().max().item())
    else:
        err = (got[0] - want[0]).abs().max().item()
        assert err <= atol[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["brusselator", "fhn", "heat"])
@pytest.mark.parametrize("dims,fuse,mode", [
    ((2, 2, 2), "1", "faces6"), ((8, 1, 1), "2", "xchain"),
    ((2, 2, 2), "2", "xychain"),
])
def test_other_models_sharded_on_one_card(name, dims, fuse, mode,
                                          monkeypatch):
    """The sharded path with one field and with two non-Gray-Scott
    fields: every round through the model's generated kernel's face
    mode, bitwise equal to the single block (the fused round:
    ``comm_overlap = "off"``; the split one is
    test_split_round_on_one_card_equals_fused)."""
    _card()
    monkeypatch.setenv("GS_FUSE", fuse)
    from grayscott_jl_tpu_torch import Simulation

    s = Settings(L=32, noise=0.1, precision="Float32", backend="CUDA",
                 model=name, comm_overlap="off", **PHYSICS[name])
    single = Simulation(s, n_devices=1, seed=2)
    n = dims[0] * dims[1] * dims[2]
    mesh = Simulation(s, seed=2, mesh_dims=dims, devices=["cuda:0"] * n)
    cuda_stencil.reset_launches()
    mesh.iterate(12)
    assert cuda_stencil.MODE_LAUNCHES[mode] == n * (12 // int(fuse))
    assert cuda_stencil.MODEL_LAUNCHES == {name: cuda_stencil.LAUNCHES}
    single.iterate(12)
    for a, b in zip(single.get_fields(), mesh.get_fields()):
        assert (a == b).all()


def _faces(shape, dtype, gen, mode, k=0):
    nx, ny, nz = shape
    if mode == "faces6":
        shapes = [(1, ny, nz)] * 4 + [(nx, 1, nz)] * 4 + [(nx, ny, 1)] * 4
    else:
        shapes = [(k, ny, nz)] * 4
    return tuple(torch.rand(s, generator=gen, device="cuda", dtype=dtype)
                 for s in shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_face_modes_equal_plain_on_card(dtype, noise):
    """chip_smoke.py phase 3's face modes at small shapes: the 6n-face
    step, the x-chain and the xy-chain operand (rows from global y = -k)
    against their plain versions, bitwise over the whole output."""
    _card()
    params = grayscott.MODEL.make_params(
        Settings(noise=noise, **KW), dtype, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    use = noise != 0
    shape = (12, 10, 36)
    f = tuple(torch.rand(shape, generator=gen, device="cuda", dtype=dtype)
              for _ in range(2))
    faces = _faces(shape, dtype, gen, "faces6")
    a = cuda_stencil.fused_step(f, params, (0, 1, 4), faces, spec=SPEC,
                                use_noise=use, offsets=(12, 10, 0), row=48)
    b = cuda_stencil.plain_step(f, params, (0, 1, 4), faces, spec=SPEC,
                                use_noise=use, offsets=(12, 10, 0), row=48)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    cap = cuda_stencil.max_feasible_fuse(f[0].element_size())
    for k in range(2, cap + 1):
        for y_halo, offs in ((0, (12, 0, 0)), (k, (12, -k, 0))):
            faces = _faces(shape, dtype, gen, "xchain", k)
            a = cuda_stencil.fused_step(
                f, params, (0, 1, 4), faces, spec=SPEC, use_noise=use,
                fuse=k, offsets=offs, row=30, y_halo=y_halo)
            b = cuda_stencil.plain_xchain(
                f, params, (0, 1, 4), faces, spec=SPEC, use_noise=use,
                fuse=k, offsets=offs, row=30)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), (k, offs)
        with pytest.raises(ValueError, match="ledger"):
            cuda_stencil.fused_step(
                f, params, (0, 1, 4), _faces(shape, dtype, gen, "xchain",
                                             cap + 1),
                spec=SPEC, use_noise=use, fuse=cap + 1, row=30)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,fuse,mode", [
    ((2, 2, 2), "1", "faces6"), ((4, 1, 1), "2", "xchain"),
    ((2, 2, 2), "2", "xychain"), ((2, 2, 1), "3", "xychain"),
])
def test_sharded_run_on_one_card_equals_single_block(dims, fuse, mode,
                                                     monkeypatch):
    """A mesh's blocks all on cuda:0: bitwise equal to the single-block
    run, and every round went through the kernel's face mode (the fused
    round: ``comm_overlap = "off"``)."""
    _card()
    monkeypatch.setenv("GS_FUSE", fuse)
    s = Settings(L=24, noise=0.1, precision="Float32", backend="CUDA",
                 comm_overlap="off", **KW)
    from grayscott_jl_tpu_torch import Simulation

    single = Simulation(s, n_devices=1, seed=2)
    n = dims[0] * dims[1] * dims[2]
    mesh = Simulation(s, seed=2, mesh_dims=dims, devices=["cuda:0"] * n)
    cuda_stencil.reset_launches()
    mesh.iterate(12)
    rounds = 12 // int(fuse)
    assert cuda_stencil.MODE_LAUNCHES[mode] == n * rounds
    single.iterate(12)
    for a, b in zip(single.get_fields(), mesh.get_fields()):
        assert (a == b).all()


#: (mesh, GS_FUSE, GS_HALO_DEPTH, launches per block and round of the
#: split round by mode, of which bands).
SPLIT_CASES = [
    ((4, 1, 1), "2", "1", {"xchain": 3}, 2),
    ((2, 2, 1), "2", "1", {"xychain": 1, "xchain": 4}, 4),
    ((2, 2, 2), "2", "1", {"xychain": 1, "xchain": 4}, 4),
    ((2, 2, 2), "1", "2", {"xychain": 1, "xchain": 4}, 4),
    ((1, 2, 2), "3", "1", {"xychain": 1, "xchain": 2}, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dims,fuse,halo_depth,per_round,bands", SPLIT_CASES)
@pytest.mark.parametrize("dtype", ["Float32", "BFloat16"])
def test_split_round_on_one_card_equals_fused(dims, fuse, halo_depth,
                                              per_round, bands, dtype,
                                              monkeypatch):
    """The split-phase round on the card — the exchange on a side stream,
    the interior on frozen faces, the bands recomputed by the x-chain
    kernel — bitwise equal to the fused round and to the single block
    over several rounds, with exact launch counts (``halo_depth`` 2 over
    depth 1 is a depth-2 round)."""
    _card()
    monkeypatch.setenv("GS_FUSE", fuse)
    monkeypatch.setenv("GS_HALO_DEPTH", halo_depth)
    from grayscott_jl_tpu_torch import Simulation

    depth = int(fuse) * int(halo_depth)
    steps = 4 * depth
    n = dims[0] * dims[1] * dims[2]

    def sim(overlap, mesh=True):
        s = Settings(L=24, noise=0.1, precision=dtype, backend="CUDA",
                     comm_overlap=overlap, **KW)
        if not mesh:
            return Simulation(s, n_devices=1, seed=2)
        return Simulation(s, seed=2, mesh_dims=dims, devices=["cuda:0"] * n)

    on, off, single = sim("on"), sim("off"), sim("off", mesh=False)
    cuda_stencil.reset_launches()
    on.iterate(steps)
    assert on.overlap_applied
    assert {m: c for m, c in cuda_stencil.MODE_LAUNCHES.items() if c} == {
        m: n * 4 * c for m, c in per_round.items()}
    assert cuda_stencil.BAND_LAUNCHES == n * 4 * bands
    off.iterate(steps)
    single.iterate(steps)
    assert not off.overlap_applied
    for a, b, c in zip(on.get_fields(), off.get_fields(),
                       single.get_fields()):
        assert (a == b).all() and (a == c).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dims,fuse", [
    (None, "1"), ((4, 1, 1), "2"), ((2, 2, 1), "2"), ((2, 1, 2), "3"),
])
def test_sharded_run_across_cards_equals_single_block(dims, fuse,
                                                      monkeypatch):
    """Blocks on different cards: the exchange copies between devices
    (``Tensor.to``), each block's kernel runs on its own card with its
    own params. ``dims=None`` is the default mesh over every card. At
    depth 2 and 3 the rounds are split-phase (the default "auto"): the
    exchange runs on each card's side stream, the copies between cards
    ordered by events. Needs two or more cards; bitwise equal to the
    single-block run."""
    _card()
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more CUDA cards")
    monkeypatch.setenv("GS_FUSE", fuse)
    from grayscott_jl_tpu_torch import Simulation

    s = Settings(L=64, noise=0.1, precision="Float32", backend="CUDA",
                 **KW)
    single = Simulation(s, n_devices=1, seed=2)
    if dims is None:
        mesh = Simulation(s, seed=2)
        devices = [f"cuda:{i}" for i in range(cards)]
    else:
        n = dims[0] * dims[1] * dims[2]
        devices = [f"cuda:{r % cards}" for r in range(n)]
        mesh = Simulation(s, seed=2, mesh_dims=dims, devices=devices)
    assert mesh.sharded
    mesh.iterate(12)
    single.iterate(12)
    assert mesh.overlap_applied == (fuse != "1")
    placed = [str(f.device) for fields in mesh.blocks for f in fields]
    assert placed == [d for d in devices for _ in range(2)]
    for a, b in zip(single.get_fields(), mesh.get_fields()):
        assert (a == b).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["spot", "shadow"])
def test_sdc_screen_on_cards_attributes_device_and_block(mode):
    """The SDC screen on a (2,2,2) mesh over every card (a card holds
    several blocks when there are fewer than eight): the replay — in
    place, or for ``shadow`` on the block-to-device list rotated by one
    card, which degrades to in place on one card — equals the live run's
    checksums, makes the live round's launches again and counts them in
    ``replay_launches`` only, and a flipped cell on the
    last card is attributed to that card and its highest-ranked block."""
    _card()
    from grayscott_jl_tpu_torch import Simulation
    from grayscott_jl_tpu_torch.resilience.sdc import SDCError, Screener

    cards = torch.cuda.device_count()
    devices = [f"cuda:{r * cards // 8}" for r in range(8)]
    s = Settings(L=64, noise=0.1, precision="Float32", backend="CUDA", **KW)
    sim = Simulation(s, seed=2, mesh_dims=(2, 2, 2), devices=devices)
    sc = Screener(sim, mode=mode)
    assert sc.shadow_degraded == (mode == "shadow" and cards == 1)
    sc.rearm(0)
    for step in (4, 8):
        n0 = cuda_stencil.LAUNCHES
        sim.iterate(4)
        live = cuda_stencil.LAUNCHES - n0
        r0 = sc.replay_launches
        assert sc.check(step) and cuda_stencil.LAUNCHES == n0 + live
        # The replay ran the live round's launches again, counted apart.
        assert sc.replay_launches - r0 == live > 0
        sc.rearm(step)
    target = devices[-1]
    assert sim.poison_sdc(device=target) == target
    sim.iterate(4)
    with pytest.raises(SDCError) as e:
        sc.check(12)
    assert (e.value.device, e.value.block, e.value.verified_step) == (
        target, 7, 8)


# ------------------------------------------------------------- bfloat16

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["grayscott", "brusselator", "fhn", "heat"])
@pytest.mark.parametrize("pdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_bf16_kernel_equals_oracle_in_every_mode(name, pdtype, noise):
    """bf16 fields (bf16 params: ``BFloat16``; float32 params:
    ``bf16_f32acc``) in every mode, the chain at every depth up to the
    ledger's cap (8 for two fields, 12 for one), bitwise equal to the
    oracle form of the plain version, every launch on the bf16 entry."""
    _card()
    spec, params = _model_case(name, pdtype, noise)
    use = noise != 0
    n = spec.n_fields
    gen = torch.Generator(device="cuda").manual_seed(23)

    def rand(shape):
        return torch.rand(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    cuda_stencil.reset_launches()
    L, steps = 20, 12
    f0 = tuple(rand((L, L, L)) for _ in range(n))
    want = cuda_stencil.plain_chain(f0, params, (0, 2, 0), spec=spec,
                                    use_noise=use, fuse=steps, oracle=True)
    cap = cuda_stencil.chain_cap(torch.bfloat16, n)
    assert cap == (8 if n == 2 else 12)
    deep = cuda_stencil.fused_step(f0, params, (0, 2, 0), spec=spec,
                                   use_noise=use, fuse=steps)
    assert all(torch.equal(a, b) for a, b in zip(deep, want))
    for fuse in range(1, cap + 1):
        got = f0
        for done in range(0, steps, fuse):
            got = cuda_stencil.fused_step(
                got, params, (0, 2, done), spec=spec, use_noise=use,
                fuse=min(fuse, steps - done))
        torch.cuda.synchronize()
        assert all(a.dtype == torch.bfloat16 and torch.equal(a, b)
                   for a, b in zip(got, want)), (name, fuse)
    shape = (12, 10, 36)
    nx, ny, nz = shape
    f = tuple(rand(shape) for _ in range(n))
    faces = tuple(rand(x) for x in [(1, ny, nz)] * (2 * n)
                  + [(nx, 1, nz)] * (2 * n) + [(nx, ny, 1)] * (2 * n))
    a = cuda_stencil.fused_step(f, params, (0, 1, 4), faces, spec=spec,
                                use_noise=use, offsets=(12, 10, 0), row=48)
    b = cuda_stencil.plain_step(f, params, (0, 1, 4), faces, spec=spec,
                                use_noise=use, offsets=(12, 10, 0), row=48,
                                oracle=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b)), (name, "faces6")
    for k in range(2, cap + 1):
        for y_halo, offs in ((0, (12, 0, 0)), (k, (12, -k, 0))):
            faces = tuple(rand((k, ny, nz)) for _ in range(2 * n))
            a = cuda_stencil.fused_step(
                f, params, (0, 1, 4), faces, spec=spec, use_noise=use,
                fuse=k, offsets=offs, row=30, y_halo=y_halo)
            b = cuda_stencil.plain_xchain(
                f, params, (0, 1, 4), faces, spec=spec, use_noise=use,
                fuse=k, offsets=offs, row=30, oracle=True)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), (name, k)
    assert cuda_stencil.DTYPE_LAUNCHES["bf16"] == cuda_stencil.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_mid_bf16_chain_equals_oracle(noise, monkeypatch):
    """``GS_MID_BF16=1``: the float32 chain with bf16 mid windows at
    depth 2..5 and the xy-chain operand, bitwise equal to the oracle;
    the exact chain is restored once the variable is unset."""
    _card()
    params = grayscott.MODEL.make_params(Settings(noise=noise, **KW),
                                         torch.float32, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(29)
    f0 = tuple(torch.rand((24, 24, 24), generator=gen, device="cuda")
               for _ in range(2))
    monkeypatch.setenv("GS_MID_BF16", "1")
    cap = cuda_stencil.chain_cap(torch.float32)
    assert cap == 5
    cuda_stencil.reset_launches()
    for fuse in range(2, cap + 1):
        got = cuda_stencil.fused_step(f0, params, (0, 2, 3), spec=SPEC,
                                      use_noise=noise != 0, fuse=fuse)
        want = cuda_stencil.plain_chain(f0, params, (0, 2, 3), spec=SPEC,
                                        use_noise=noise != 0, fuse=fuse,
                                        oracle=True, mid_bf16=True)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), fuse
    shape = (12, 14, 36)
    f = tuple(torch.rand(shape, generator=gen, device="cuda")
              for _ in range(2))
    faces = _faces(shape, torch.float32, gen, "xchain", 2)
    a = cuda_stencil.fused_step(f, params, (0, 1, 4), faces, spec=SPEC,
                                use_noise=noise != 0, fuse=2,
                                offsets=(12, -2, 0), row=30, y_halo=2)
    b = cuda_stencil.plain_xchain(f, params, (0, 1, 4), faces, spec=SPEC,
                                  use_noise=noise != 0, fuse=2,
                                  offsets=(12, -2, 0), row=30, oracle=True,
                                  mid_bf16=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert cuda_stencil.DTYPE_LAUNCHES["f32_mid_bf16"] == cap
    monkeypatch.delenv("GS_MID_BF16")
    exact = cuda_stencil.fused_step(f0, params, (0, 2, 3), spec=SPEC,
                                    use_noise=noise != 0, fuse=3)
    plain = cuda_stencil.plain_chain(f0, params, (0, 2, 3), spec=SPEC,
                                     use_noise=noise != 0, fuse=3)
    assert all(torch.equal(x, y) for x, y in zip(exact, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("posture", ["BFloat16", "bf16_f32acc"])
@pytest.mark.parametrize("dims,fuse,mode", [
    ((2, 2, 2), "1", "faces6"), ((4, 1, 1), "2", "xchain"),
    ((2, 2, 2), "2", "xychain"), ((2, 2, 1), "3", "xychain"),
])
def test_bf16_sharded_on_one_card_equals_single_block(posture, dims, fuse,
                                                      mode, monkeypatch):
    """A bf16 mesh's blocks all on cuda:0, every round on the bf16 entry
    point (the z bands in the kernel's posture), bitwise equal to the
    single block (the fused round: ``comm_overlap = "off"``)."""
    _card()
    monkeypatch.setenv("GS_FUSE", fuse)
    from grayscott_jl_tpu_torch import Simulation

    prec = (dict(precision="BFloat16") if posture == "BFloat16" else
            dict(precision="Float32", compute_precision="bf16_f32acc"))
    s = Settings(L=24, noise=0.1, backend="CUDA", comm_overlap="off",
                 **prec, **KW)
    single = Simulation(s, n_devices=1, seed=2)
    n = dims[0] * dims[1] * dims[2]
    mesh = Simulation(s, seed=2, mesh_dims=dims, devices=["cuda:0"] * n)
    cuda_stencil.reset_launches()
    mesh.iterate(12)
    assert cuda_stencil.MODE_LAUNCHES[mode] == n * (12 // int(fuse))
    assert cuda_stencil.DTYPE_LAUNCHES["bf16"] == cuda_stencil.LAUNCHES
    single.iterate(12)
    for a, b in zip(single.get_fields(), mesh.get_fields()):
        assert (a == b).all()


@pytest.mark.cuda
def test_kernel_refuses_other_dtypes_on_card():
    _card()
    params = grayscott.MODEL.make_params(Settings(**KW), torch.float32,
                                         "cuda")
    f = tuple(torch.rand((8, 8, 8), device="cuda", dtype=torch.float16)
              for _ in range(2))
    with pytest.raises(TypeError, match="bfloat16"):
        cuda_stencil.fused_step(f, params, (0, 0, 0), spec=SPEC)


# ------------------------------------------------------- envelope probes

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64, 64), (20, 24, 40), (9, 8, 33)])
def test_copy_walk_is_the_identity_on_card(shape):
    """The copy walk (``dma_walk``'s counterpart) at every depth the
    ledger admits: its output equals its input bitwise, one launch per
    call."""
    _card()
    from grayscott_jl_tpu_torch.ops import envelope

    gen = torch.Generator(device="cuda").manual_seed(11)
    f = tuple(torch.rand(shape, generator=gen, device="cuda")
              for _ in range(2))
    for fuse in range(1, cuda_stencil.max_feasible_fuse(4) + 1):
        cuda_stencil.reset_launches()
        got = envelope.copy_walk(f, fuse=fuse)
        torch.cuda.synchronize()
        assert cuda_stencil.MODE_LAUNCHES["copy_walk"] == 1
        for a, b in zip(got, f):
            assert torch.equal(a, b), (fuse, (a - b).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(40, 40, 64), (6, 5, 20)])
def test_compute_walk_equals_plain_on_card(shape, noise):
    """Every compute-walk variant at depth 1..5: its defined tile equals
    its plain version bitwise, and the default chain's equals the
    production chain's tile (0,0,0)."""
    _card()
    from grayscott_jl_tpu_torch.ops import envelope
    from grayscott_jl_tpu_torch.probes import envelope_probe

    gen = torch.Generator(device="cuda").manual_seed(12)
    f = tuple(torch.rand(shape, generator=gen, device="cuda")
              for _ in range(2))
    params = envelope_probe.make_params(noise, "cuda")
    cut = envelope.defined_tile(shape)
    for fuse in range(1, cuda_stencil.max_feasible_fuse(4) + 1):
        chain = cuda_stencil.fused_step(f, params, (1, 2, 9), spec=SPEC,
                                        use_noise=noise != 0, fuse=fuse)
        for variant in envelope.VARIANTS:
            got = envelope.compute_walk(
                f, params, (1, 2, 9), spec=SPEC, fuse=fuse,
                use_noise=noise != 0, variant=variant)
            want = envelope.plain_compute_walk(
                f, params, (1, 2, 9), spec=SPEC, fuse=fuse,
                use_noise=noise != 0, variant=variant)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a[cut], b), (variant, fuse)
            if variant == "chain":
                for a, b in zip(got, chain):
                    assert torch.equal(a[cut], b[cut]), fuse


@pytest.mark.cuda
def test_envelope_probe_counts_one_launch_per_pass():
    """The probe's entry point on the card: each probe case launches its
    kernel once per pass, in the warm-up and in every round."""
    _card()
    from grayscott_jl_tpu_torch.ops import envelope
    from grayscott_jl_tpu_torch.probes import envelope_probe

    steps, rounds = 4, 2
    cuda_stencil.reset_launches()
    rows = envelope_probe.run(32, 1, steps, rounds, 0.1, variants=True)
    per_case = steps * (1 + rounds)
    assert cuda_stencil.MODE_LAUNCHES["copy_walk"] == per_case
    assert cuda_stencil.MODE_LAUNCHES["chain"] == per_case  # full
    assert cuda_stencil.VARIANT_LAUNCHES == dict.fromkeys(
        envelope.VARIANTS, per_case)
    assert cuda_stencil.MODE_LAUNCHES["compute_walk"] == (
        per_case * len(envelope.VARIANTS))
    assert [r["case"] for r in rows][:5] == [
        "torch_stream", "torch_copy", "copy_walk", "compute_walk", "full"]
    assert all(r["timer"] == "cuda_events" and r["best_us_per_pass"] > 0
               for r in rows)


def _operands(mode, shape, dtype, fuse, gen):
    nx, ny, nz = shape
    f = tuple(torch.rand(shape, generator=gen, device="cuda").to(dtype)
              for _ in range(2))
    faces = None
    if mode == "faces6":
        faces = tuple(torch.rand(s, generator=gen, device="cuda").to(dtype)
                      for s in [(1, ny, nz)] * 4 + [(nx, 1, nz)] * 4
                      + [(nx, ny, 1)] * 4)
    elif mode == "xchain":
        faces = tuple(torch.rand((fuse, ny, nz), generator=gen,
                                 device="cuda").to(dtype) for _ in range(4))
    return f, faces


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("mode,shape,fuse", [
    ("chain", (40, 48, 64), 1), ("chain", (40, 48, 64), 2),
    ("chain", (20, 24, 41), 1), ("chain", (20, 24, 41), 2),
    ("faces6", (32, 24, 64), 1), ("faces6", (20, 24, 41), 1),
    ("xchain", (12, 24, 64), 2), ("xchain", (10, 24, 41), 2),
])
def test_every_mode_equals_plain_on_every_load_path(mode, shape, fuse,
                                                    dtype):
    """The window load: TMA and cp.async, on the operands TMA takes and on
    one it refuses (nz = 41: a row is not a multiple of 16 B), each
    bitwise equal to the plain version (bf16: its oracle) and counted
    under its path."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    f, faces = _operands(mode, shape, dtype, fuse, gen)
    params = grayscott.MODEL.make_params(
        Settings(noise=0.1, **KW),
        torch.float32 if dtype == torch.bfloat16 else dtype, "cuda")
    offs, row = (16, 0, 0), 128
    oracle = dtype == torch.bfloat16
    if mode == "chain":
        want = cuda_stencil.plain_chain(f, params, (0, 2, 7), spec=SPEC,
                                        fuse=fuse, offsets=offs, row=row,
                                        oracle=oracle)
    elif mode == "faces6":
        want = cuda_stencil.plain_step(f, params, (0, 2, 7), faces,
                                       spec=SPEC, offsets=offs, row=row,
                                       oracle=oracle)
    else:
        want = cuda_stencil.plain_xchain(f, params, (0, 2, 7), faces,
                                         spec=SPEC, fuse=fuse,
                                         use_noise=True, offsets=offs,
                                         row=row, oracle=oracle)
    itemsize = f[0].element_size()
    rule = cuda_stencil.load_path(shape, itemsize, (f[0].data_ptr(),))
    runs = ["cp_async"] + (["tma"] if rule == "tma" else [])
    assert (rule == "tma") == (shape[2] * itemsize % 16 == 0)
    for load in runs:
        cuda_stencil.reset_launches()
        with cuda_stencil.override(load):
            got = cuda_stencil.fused_step(f, params, (0, 2, 7), faces,
                                          spec=SPEC, fuse=fuse, offsets=offs,
                                          row=row)
        torch.cuda.synchronize()
        assert cuda_stencil.LOAD_PATH_LAUNCHES[load] == 1
        for a, b in zip(got, want):
            assert torch.equal(a, b), (load,
                                       (a.double() - b.double()).abs().max())


#: The march's shapes: regular; ragged (the column tile divides neither
#: ny nor nz); nx below one least span; nx not a multiple of the span
#: (50 planes in segments of 17, 17 and 16).
MARCH_SHAPES = [(64, 48, 128), (40, 36, 72), (7, 32, 64), (50, 32, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["grayscott", "brusselator", "fhn", "heat"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_march_equals_plain_on_card(name, dtype, noise):
    """The fuse-1 chain on the TMA path marches, in every posture and
    model, on regular and ragged shapes, and equals the plain version
    (bf16: its oracle) bitwise; each launch counts as a ``chain`` launch
    on the TMA path under the ``march`` schedule."""
    _card()
    pdtype = torch.float32 if dtype == torch.bfloat16 else dtype
    spec, params = _model_case(name, pdtype, noise)
    gen = torch.Generator(device="cuda").manual_seed(31)
    for shape in MARCH_SHAPES:
        f = tuple(torch.rand(shape, generator=gen, device="cuda").to(dtype)
                  for _ in range(spec.n_fields))
        kw = dict(spec=spec, use_noise=noise != 0, offsets=(16, 4, 8),
                  row=128)
        want = cuda_stencil.plain_chain(f, params, (5, 2, 7),
                                        oracle=dtype == torch.bfloat16, **kw)
        cuda_stencil.reset_launches()
        got = cuda_stencil.fused_step(f, params, (5, 2, 7), **kw)
        torch.cuda.synchronize()
        assert cuda_stencil.SCHEDULE_LAUNCHES == {"window": 0, "march": 1}
        assert cuda_stencil.MODE_LAUNCHES["chain"] == 1
        assert cuda_stencil.LOAD_PATH_LAUNCHES["tma"] == 1
        for a, b in zip(got, want):
            assert torch.equal(a, b), (shape, (a.double() - b.double())
                                       .abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_batched_march_equals_its_solo_launches_on_card(dtype):
    """A batched N=3 march (4-D maps one member deep) equals its three
    solo launches and the plain version bitwise, on a ragged shape."""
    _card()
    shape, n = (40, 36, 72), 3
    rows = [dict(Du=0.2, Dv=0.1, F=f, k=k, dt=1.0, noise=0.1)
            for f, k in ((0.03, 0.062), (0.055, 0.062), (0.026, 0.051))]
    keys = [(0, 3), (0, 4), (0, 2**31 + 5)]
    gen = torch.Generator(device="cuda").manual_seed(37)
    f = tuple(torch.rand((n,) + shape, generator=gen, device="cuda")
              .to(dtype) for _ in range(2))
    params = cuda_stencil.member_params(
        rows, SPEC.model.params_cls, cuda_stencil.compute_dtype_of(dtype),
        "cuda")
    seeds = cuda_stencil.member_seeds(keys, 9)
    kw = dict(spec=SPEC, use_noise=True, offsets=(0, 0, 0), row=64)
    cuda_stencil.reset_launches()
    got = cuda_stencil.fused_step(f, params, seeds, **kw)
    assert cuda_stencil.SCHEDULE_LAUNCHES == {"window": 0, "march": 1}
    assert cuda_stencil.MODE_MEMBERS["chain"] == n
    want = cuda_stencil.plain_chain(f, params, seeds,
                                    oracle=dtype == torch.bfloat16, **kw)
    for m in range(n):
        solo = cuda_stencil.fused_step(
            tuple(x[m].contiguous() for x in f),
            cuda_stencil.params_row(params, m),
            (keys[m][0], keys[m][1], 9), **kw)
        assert all(torch.equal(g[m], x) for g, x in zip(got, solo)), m
    torch.cuda.synchronize()
    assert cuda_stencil.SCHEDULE_LAUNCHES == {"window": 0, "march": 1 + n}
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,fuse", [((20, 24, 41), 1),
                                        ((40, 48, 64), 2)])
def test_window_schedule_keeps_the_other_launches_on_card(shape, fuse):
    """A cp.async-path operand (41 float32 cells a row) and a depth-2
    chain run the window kernel, counted under ``window``, bitwise equal
    to the plain version; ``gs_kernel_attributes`` reports the march's
    instance for the depth-1 chain and the window's at depth 2."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(41)
    f = tuple(torch.rand(shape, generator=gen, device="cuda")
              for _ in range(2))
    params = grayscott.MODEL.make_params(Settings(noise=0.1, **KW),
                                         torch.float32, "cuda")
    cuda_stencil.reset_launches()
    got = cuda_stencil.fused_step(f, params, (0, 2, 3), spec=SPEC, fuse=fuse,
                                  row=64)
    torch.cuda.synchronize()
    assert cuda_stencil.SCHEDULE_LAUNCHES == {"window": 1, "march": 0}
    want = cuda_stencil.plain_chain(f, params, (0, 2, 3), spec=SPEC,
                                    fuse=fuse, row=64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    march = cuda_stencil.kernel_attributes(SPEC, "chain", "f32", 1)
    assert march["threads_per_block"] == cuda_stencil.MARCH_THREADS
    assert march["dynamic_shared_bytes"] == cuda_stencil.ring_smem_bytes(4)
    window = cuda_stencil.kernel_attributes(SPEC, "chain", "f32", 2)
    assert window["threads_per_block"] == 256


@pytest.mark.cuda
def test_copy_walk_on_each_load_path_on_card():
    from grayscott_jl_tpu_torch.ops import envelope

    _card()
    f = tuple(torch.rand((48, 40, 96), device="cuda") for _ in range(2))
    for load in ("tma", "cp_async"):
        with cuda_stencil.override(load):
            got = envelope.copy_walk(f, fuse=1)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, f))


@pytest.mark.cuda
def test_f1_config_aborts_on_card_before_any_write(tmp_path):
    """ROADMAP F1 on the card: the blow-up raises HealthError at step 10
    and the store holds no step."""
    from grayscott_jl_tpu_torch import driver
    from grayscott_jl_tpu_torch.io.bplite import BpReader
    from grayscott_jl_tpu_torch.resilience.health import HealthError

    _card()
    settings = Settings(L=16, F=0.02, k=0.048, dt=400.0, Du=0.2, Dv=0.1,
                        steps=20, plotgap=10, precision="Float32",
                        backend="CUDA", output=str(tmp_path / "gs.bp"),
                        health_policy="abort")
    cuda_stencil.reset_launches()
    with pytest.raises(HealthError) as e:
        driver.run_once(settings)
    assert e.value.step == 10 and not e.value.report.finite
    assert cuda_stencil.LAUNCHES == 10
    with BpReader(str(tmp_path / "gs.bp")) as r:
        assert r.num_steps() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_snapshot_async_on_card(dtype):
    """The snapshot's copies run on a copy stream into the ring's pinned
    buffers: the host blocks equal the fields, the device checksum
    equals the host's over the landed bytes, the bitflip hook is caught,
    and the ring's buffers are pinned and reused."""
    _card()
    from grayscott_jl_tpu_torch.resilience.integrity import (
        CorruptionError, device_field_checksum)
    from grayscott_jl_tpu_torch.simulation import HostRing, Simulation

    precision = {torch.float32: "Float32", torch.float64: "Float64",
                 torch.bfloat16: "BFloat16"}[dtype]
    sim = Simulation(Settings(L=64, noise=0.1, precision=precision,
                              backend="CUDA", **KW))
    sim.iterate(3)
    ring = HostRing(2)
    want = [(f.float() if dtype == torch.bfloat16 else f).cpu().numpy()
            for f in sim.blocks[0]]
    sums = [int(c) for c in device_field_checksum(*sim.blocks[0])]
    snaps = [sim.snapshot_async(health=True, checksum=True, ring=ring)
             for _ in range(2)]
    sim.iterate(1)  # the next chunk drops the snapshots' sources
    for snap in snaps:
        assert snap.health_report().finite
        assert list(snap.checksum_report().values()) == sums
        (offs, sizes, *host), = snap.blocks()
        for h, w in zip(host, want):
            assert (h == w).all()
    assert all(b.is_pinned() for b in ring._bufs.values())
    assert len(ring._bufs) == 4
    bad = sim.snapshot_async(checksum=True, bitflip=True, ring=ring)
    with pytest.raises(CorruptionError):
        bad.blocks()


# ------------------------------------------------------ across processes

#: Runs of several processes on the card: (processes, cards they see,
#: mesh, GS_FUSE, the backend the placement rule picks). Two processes
#: on one card share it (gloo, faces staged through pinned host
#: memory); with a card each they talk over NCCL.
ACROSS_PROCESSES = [
    (2, 1, (2, 2, 2), "1", "gloo"),
    (2, 1, (4, 2, 1), "2", "gloo"),
    (2, 2, (2, 2, 2), "1", "nccl"),
    (2, 2, (4, 2, 1), "2", "nccl"),
    (4, 4, (2, 2, 2), "1", "nccl"),
    (4, 4, (4, 2, 1), "2", "nccl"),
]


def _card_config(path, **kw):
    base = dict(L=64, steps=20, plotgap=10, noise=0.1, precision="Float32",
                backend="CUDA", kernel_language="Pallas",
                output=str(path.parent / "gs.bp"), **KW)
    base.update(kw)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(
        f'{k} = "{v}"' if isinstance(v, str) else f"{k} = {v}"
        for k, v in base.items()) + "\n")
    return str(path)


@pytest.mark.cuda
@pytest.mark.parametrize("procs,cards,dims,fuse,backend", ACROSS_PROCESSES)
def test_run_across_processes_equals_one_process(procs, cards, dims, fuse,
                                                 backend, tmp_path,
                                                 monkeypatch):
    """``launch.py`` with ``procs`` processes seeing ``cards`` cards
    (``CUDA_VISIBLE_DEVICES``), each holding its share of the mesh's
    blocks: the multi-writer store is bitwise equal to the one-process
    run of the same mesh (every block on ``cuda:0``), each process
    records the backend the placement rule picked, and at depth 2 the
    rounds are split with the exchange's transfers ordered behind each
    card's side stream."""
    import json
    import os

    import numpy as np

    from grayscott_jl_tpu_torch import Simulation, driver, launch
    from grayscott_jl_tpu_torch.config.settings import get_settings
    from grayscott_jl_tpu_torch.io.bplite import BpReader

    _card()
    have = torch.cuda.device_count()
    if have < cards:
        pytest.skip(f"needs {cards} CUDA cards; this machine has {have}")
    n = dims[0] * dims[1] * dims[2]
    env = {"GS_FUSE": fuse, "GS_TPU_MESH_DIMS": ",".join(map(str, dims))}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    one_cfg = _card_config(tmp_path / "one" / "cfg.toml")
    one = driver.run_once(
        get_settings([one_cfg]),
        sim_factory=lambda s, *, n_devices, seed: Simulation(
            s, seed=seed, mesh_dims=dims, devices=["cuda:0"] * n))
    assert one.overlap_applied == (fuse != "1")
    cfg = _card_config(tmp_path / "pair" / "cfg.toml")
    stats = str(tmp_path / "pair" / "stats.json")
    child_env = {k: v for k, v in os.environ.items()
                 if k not in ("GS_TPU_COORDINATOR", "GS_TPU_DISTRIBUTED")}
    child_env.update(env, GS_TPU_STATS=stats,
                     CUDA_VISIBLE_DEVICES=",".join(map(str, range(cards))))
    log = tmp_path / "pair" / "launch.log"
    with open(log, "w") as f:
        codes = launch.launch(procs, cfg, n // procs, env=child_env,
                              cwd=str(tmp_path / "pair"), timeout=240,
                              stdout=f, stderr=f)
    assert codes == [0] * procs, log.read_text()[-4000:]
    for rank in range(procs):
        with open(f"{stats}.rank{rank}") as f:
            c = json.load(f)["config"]
        assert (c["process_index"], c["process_count"]) == (rank, procs)
        assert c["backend"] == backend
        assert c["cards"] == ([rank] if backend == "nccl" else
                              [rank * cards // procs])
        assert c["overlap_applied"] == (fuse != "1")
        assert c["p2p"]["calls"] > 0
    with BpReader(str(tmp_path / "one" / "gs.bp")) as a, BpReader(
            str(tmp_path / "pair" / "gs.bp")) as b:
        assert a.num_steps() == b.num_steps() == 2
        for i in range(2):
            for name in ("U", "V"):
                np.testing.assert_array_equal(a.get(name, step=i),
                                              b.get(name, step=i))


# ------------------------------------------------------ live resharding

@pytest.mark.cuda
def test_live_moves_across_cards(tmp_path, monkeypatch):
    """Four cards. ``reshape_live`` of a (2,2,2) mesh on cards 0-1 onto
    (1,2,2) over cards 0-3 takes the ``put`` tier (another device set),
    and continues bitwise equal to the single block. Then the driver's
    quarantine poll: card 3 of a (2,2,2) run over four cards is
    quarantined after round one, and the run moves between rounds onto
    the largest mesh the three usable cards hold, (3,1,1) at L=64
    (padded storage), its store bitwise equal to the single block's."""
    _card()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    import numpy as np

    from grayscott_jl_tpu_torch import Simulation, driver
    from grayscott_jl_tpu_torch.io.bplite import BpReader
    from grayscott_jl_tpu_torch.reshard import restore

    for var in ("GS_DEVICE_BLOCKLIST", "GS_TPU_MESH_DIMS", "GS_RESHARD",
                "GS_RESHARD_DEVICE"):
        monkeypatch.delenv(var, raising=False)
    s = Settings(L=64, noise=0.1, precision="Float32", backend="CUDA", **KW)
    single = Simulation(s, n_devices=1, seed=2)
    single.iterate(8)
    sim = Simulation(s, seed=2, mesh_dims=(2, 2, 2),
                     devices=[f"cuda:{r // 4}" for r in range(8)])
    sim.iterate(4)
    target, plan = restore.reshape_live(
        sim, mesh_dims=(1, 2, 2), devices=[f"cuda:{i}" for i in range(4)])
    assert plan.changed and target.reshard["path"] == "put"
    assert [str(f.device) for f in target.blocks[3]] == ["cuda:3"] * 2
    target.iterate(4)
    for a, b in zip(single.get_fields(), target.get_fields()):
        assert (a == b).all()

    def cfg(d):
        d.mkdir(parents=True)
        return Settings(L=64, steps=8, plotgap=4, noise=0.1,
                        precision="Float32", backend="CUDA",
                        output=str(d / "gs.bp"), **KW)

    calls = [0]

    def poll():
        calls[0] += 1
        if calls[0] == 2:
            monkeypatch.setenv("GS_DEVICE_BLOCKLIST", "cuda:3")
        return None

    moved = driver.run_once(
        cfg(tmp_path / "q"), reshape_poll=poll,
        sim_factory=lambda st, *, n_devices, seed: Simulation(
            st, seed=seed, mesh_dims=(2, 2, 2),
            devices=[f"cuda:{r // 2}" for r in range(8)]))
    assert tuple(moved.domain.dims) == (3, 1, 1)
    assert moved.reshard["path"] == "put"
    assert sorted({str(d) for d in moved.mesh.devices}) == [
        "cuda:0", "cuda:1", "cuda:2"]
    monkeypatch.delenv("GS_DEVICE_BLOCKLIST")
    driver.run_once(cfg(tmp_path / "one"), n_devices=1)
    with BpReader(str(tmp_path / "one" / "gs.bp")) as a, BpReader(
            str(tmp_path / "q" / "gs.bp")) as b:
        assert a.num_steps() == b.num_steps() == 2
        for i in range(2):
            for name in ("U", "V"):
                np.testing.assert_array_equal(a.get(name, step=i),
                                              b.get(name, step=i))


LIVE_MOVE = r"""
import json, sys
from grayscott_jl_tpu_torch import driver
from grayscott_jl_tpu_torch.config.settings import get_settings
calls = [0]
def poll():
    calls[0] += 1
    return {"mesh_dims": [1, 2, 2]} if calls[0] == 2 else None
sim = driver.run_once(get_settings([sys.argv[1]]), n_devices=int(sys.argv[2]),
                      reshape_poll=poll)
print(json.dumps({"dims": list(sim.domain.dims), "reshard": sim.reshard,
                  "devices": sorted({str(d) for d in sim.mesh.devices})}))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("procs,cards,backend", [(2, 1, "gloo"),
                                                 (4, 4, "nccl")])
def test_live_move_across_processes(procs, cards, backend, tmp_path,
                                    monkeypatch):
    """``procs`` processes seeing ``cards`` cards (gloo on one shared
    card, NCCL with a card each) move a (2,2,2) run to (1,2,2) after
    round one through ``reshape_poll``: every process takes the
    collective tier (its blocks stay on its card), the overlaps that
    change process cross in one ``batch_isend_irecv`` round, and the
    multi-writer store is bitwise equal to one process's unmoved run."""
    import json
    import os
    import subprocess
    import sys

    import numpy as np

    from grayscott_jl_tpu_torch import Simulation, driver, launch
    from grayscott_jl_tpu_torch.config.settings import get_settings
    from grayscott_jl_tpu_torch.io.bplite import BpReader

    _card()
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA cards")
    monkeypatch.delenv("GS_TPU_MESH_DIMS", raising=False)
    one_cfg = _card_config(tmp_path / "one" / "cfg.toml")
    driver.run_once(get_settings([one_cfg]),
                    sim_factory=lambda s, *, n_devices, seed: Simulation(
                        s, seed=seed, mesh_dims=(2, 2, 2),
                        devices=["cuda:0"] * 8))
    cfg = _card_config(tmp_path / "many" / "cfg.toml")
    env = {k: v for k, v in os.environ.items()
           if k not in ("GS_TPU_COORDINATOR", "GS_TPU_DISTRIBUTED",
                        "GS_TPU_MESH_DIMS")}
    env["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, range(cards)))
    port = launch.free_port()
    children = [subprocess.Popen(
        [sys.executable, "-c", LIVE_MOVE, cfg, str(8 // procs)],
        cwd=str(tmp_path / "many"), env=launch.process_env(r, procs, port,
                                                          env),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(procs)]
    try:
        outs = [c.communicate(timeout=300) for c in children]
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
    for rank, (c, (out, err)) in enumerate(zip(children, outs)):
        assert c.returncode == 0, err[-4000:]
        got = json.loads(out.strip().splitlines()[-1])
        assert got["dims"] == [1, 2, 2]
        assert got["reshard"]["path"] == "collective"
        assert got["reshard"]["new"]["process_count"] == procs
        assert got["devices"] == [f"cuda:{rank * cards // procs}"]
    with BpReader(str(tmp_path / "one" / "gs.bp")) as a, BpReader(
            str(tmp_path / "many" / "gs.bp")) as b:
        assert a.num_steps() == b.num_steps() == 2
        for i in range(2):
            for name in ("U", "V"):
                np.testing.assert_array_equal(a.get(name, step=i),
                                              b.get(name, step=i))


# ------------------------------------------------------ Auto's decision

@pytest.mark.cuda
def test_auto_sweep_and_quick_across_cards(tmp_path, monkeypatch):
    """Four cards in one process (the ``peer`` placement): Auto's
    unpinned sweep adopts the fabric model's mesh and depth, measured no
    slower than the default mesh at depth 1, and
    ``GS_AUTOTUNE=quick`` times the kernel's candidates there (never the
    plain path); both runs' fields equal the single block's."""
    _card()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    import dataclasses

    from grayscott_jl_tpu_torch import Simulation

    for var in ("GS_TPU_MESH_DIMS", "GS_FUSE", "GS_HALO_DEPTH",
                "GS_COMM_OVERLAP", "GS_AUTOTUNE_TOPN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("GS_AUTOTUNE_CACHE", str(tmp_path / "tune"))
    s = Settings(L=128, noise=0.1, precision="Float32", backend="CUDA",
                 kernel_language="Auto", **KW)
    single = Simulation(dataclasses.replace(s, kernel_language="CUDA"),
                        n_devices=1, seed=2)
    single.iterate(12)
    cards = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setenv("GS_AUTOTUNE", "off")
    swept = Simulation(s, seed=2)
    sel = swept.kernel_selection
    row = sel["rows"][sel["pick"]]
    assert sel["placement"] == "peer" and sel["blocks"] == 4
    assert swept.domain.dims == tuple(int(x) for x in row["mesh"].split(","))
    assert swept.fuse == row["fuse"] and swept.kernel_language == "cuda"
    assert sorted(set(swept.mesh.devices), key=str) == cards
    swept.iterate(12)
    for a, b in zip(single.get_fields(), swept.get_fields()):
        assert (a == b).all()
    # The adopted schedule against what an unpinned run took before Auto
    # adopted meshes (the default mesh at depth 1), each timed in turn.
    from grayscott_jl_tpu_torch.utils.benchmark import time_sim_rounds

    default = Simulation(dataclasses.replace(s, kernel_language="CUDA"),
                         seed=2)
    assert default.fuse == 1
    ms = {"adopted": [], "default": []}
    for _ in range(2):
        for name, sim in (("adopted", swept), ("default", default)):
            ms[name].append(time_sim_rounds(sim, 20, 3)["median"] * 1e3)
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    print(f"four cards, L=128: adopted {swept.domain.dims} depth "
          f"{swept.fuse} {mean['adopted']:.4f} ms/step {ms['adopted']}; "
          f"default {default.domain.dims} depth 1 {mean['default']:.4f} "
          f"ms/step {ms['default']}")
    assert mean["adopted"] <= mean["default"], ms
    del default
    monkeypatch.setenv("GS_AUTOTUNE", "quick")
    launches = cuda_stencil.LAUNCHES
    tuned = Simulation(s, seed=2)
    prov = tuned.kernel_selection["autotune"]
    assert prov["source"] == "measured" and prov["candidates_timed"] >= 2
    assert cuda_stencil.LAUNCHES > launches  # the candidates ran kernels
    assert tuned.kernel_language == prov["winner"]["kernel"] == "cuda"
    assert tuned.fuse == prov["winner"]["fuse"]
    tuned.iterate(12)
    for a, b in zip(single.get_fields(), tuned.get_fields()):
        assert (a == b).all()


# ---------------------------------------------------------------- ensembles

#: The batched launch's cases: (mode, member shape, depth, keywords).
ENSEMBLE_CASES = [
    ("chain", (40, 40, 40), 1, {}),
    ("chain", (40, 40, 40), 2, {}),
    ("faces6", (24, 20, 40), 1, {}),
    ("xchain", (12, 24, 40), 2, {"offsets": (12, 0, 0)}),
    ("xychain", (16, 20, 40), 2, {"offsets": (16, -2, 0), "y_halo": 2}),
    ("band", (2, 24, 40), 2, {"offsets": (14, 0, 8), "band": True}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,shape,fuse,kw,dtype", [
    pytest.param(*case, dtype, id=f"{case[0]}_{case[2]}-{dtype}")
    for case in ENSEMBLE_CASES
    for dtype in ("float32", "float64", "bfloat16", "mid_bf16")
    # bf16 mid windows exist from depth 2.
    if dtype != "mid_bf16" or case[2] >= 2])
def test_ensemble_batched_launch_equals_plain_and_solo(mode, shape, fuse,
                                                        kw, dtype,
                                                        monkeypatch):
    """One launch with the members on the grid's y axis (N=3, every
    member its own params and key pair) against the plain version with
    the same leading axis (bf16: the oracle) and three solo launches,
    bitwise, on each load path the operand takes."""
    _card()
    if dtype == "mid_bf16":
        monkeypatch.setenv("GS_MID_BF16", "1")
    tdtype = torch.bfloat16 if dtype == "bfloat16" else (
        torch.float64 if dtype == "float64" else torch.float32)
    oracle = dtype in ("bfloat16", "mid_bf16")
    n = 3
    nx, ny, nz = shape
    rows = [dict(Du=0.2, Dv=0.1, F=f, k=k, dt=1.0, noise=0.1)
            for f, k in ((0.03, 0.062), (0.055, 0.062), (0.026, 0.051))]
    keys = [(0, 3), (0, 4), (0, 2**31 + 5)]
    gen = torch.Generator(device="cuda").manual_seed(17)
    f = tuple((torch.rand((n,) + shape, generator=gen, device="cuda") * 0.5
               + 0.25).to(tdtype) for _ in range(2))
    if mode == "faces6":
        fshapes = [(1, ny, nz)] * 4 + [(nx, 1, nz)] * 4 + [(nx, ny, 1)] * 4
    elif mode == "chain":
        fshapes = []
    else:
        fshapes = [(fuse, ny, nz)] * 4
    faces = tuple(torch.rand((n,) + s, generator=gen, device="cuda")
                  .to(tdtype) for s in fshapes) or None
    params = cuda_stencil.member_params(
        rows, SPEC.model.params_cls, cuda_stencil.compute_dtype_of(tdtype),
        "cuda")
    seeds = cuda_stencil.member_seeds(keys, 9)
    args = dict(spec=SPEC, use_noise=True, fuse=fuse,
                offsets=kw.get("offsets", (0, 0, 0)), row=64,
                y_halo=kw.get("y_halo", 0), band=kw.get("band", False))
    pkw = dict(spec=SPEC, use_noise=True, offsets=args["offsets"], row=64,
               oracle=oracle)
    if mode == "chain":
        want = cuda_stencil.plain_chain(f, params, seeds, fuse=fuse,
                                        mid_bf16=dtype == "mid_bf16", **pkw)
    elif mode == "faces6":
        want = cuda_stencil.plain_step(f, params, seeds, faces, **pkw)
    else:
        want = cuda_stencil.plain_xchain(f, params, seeds, faces, fuse=fuse,
                                         mid_bf16=dtype == "mid_bf16", **pkw)
    itemsize = torch.empty((), dtype=tdtype).element_size()
    paths = ["tma", "cp_async"] if cuda_stencil.load_path(
        shape, itemsize, (0,)) == "tma" else ["cp_async"]
    for load in paths:
        with cuda_stencil.override(load=load):
            launches = cuda_stencil.LAUNCHES
            got = cuda_stencil.fused_step(f, params, seeds, faces, **args)
            assert cuda_stencil.LAUNCHES - launches == 1
            assert cuda_stencil.MODE_MEMBERS[
                "xchain" if mode == "band" else mode] >= n
            solo = [cuda_stencil.fused_step(
                tuple(x[m].contiguous() for x in f),
                cuda_stencil.params_row(params, m),
                (keys[m][0], keys[m][1], 9),
                None if faces is None
                else tuple(x[m].contiguous() for x in faces), **args)
                for m in range(n)]
        for a, b in zip(got, want):
            assert torch.equal(a, b), (load, (a.double() - b.double())
                                       .abs().max().item())
        for m, s in enumerate(solo):
            assert all(torch.equal(g[m], x) for g, x in zip(got, s)), (
                load, m)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,fuse", [((1, 1, 1), "1"), ((1, 1, 1), "2"),
                                       ((2, 2, 2), "1"), ((8, 1, 1), "2"),
                                       ((2, 2, 1), "2")])
def test_ensemble_members_equal_solo_runs_on_one_card(dims, fuse,
                                                      monkeypatch):
    """An ensemble on one card (a mesh's blocks all on ``cuda:0``): one
    launch per block and round, every member bitwise equal to its solo
    run on the same mesh and depth."""
    _card()
    from grayscott_jl_tpu_torch import Simulation
    from grayscott_jl_tpu_torch.ensemble import spec as ens_spec
    from grayscott_jl_tpu_torch.ensemble.engine import EnsembleSimulation
    from grayscott_jl_tpu_torch.ensemble.io import member_settings

    monkeypatch.setenv("GS_FUSE", fuse)
    n = dims[0] * dims[1] * dims[2]
    s = Settings(L=32, noise=0.1, precision="Float32", backend="CUDA",
                 kernel_language="CUDA", **KW)
    s.ensemble = ens_spec.from_toml(
        {"presets": ["spots", "stripes", "chaos"]}, s)
    ens = EnsembleSimulation(s, seed=2, mesh_dims=dims,
                             devices=["cuda:0"] * n)
    launches = cuda_stencil.LAUNCHES
    ens.iterate(6)
    batched = cuda_stencil.LAUNCHES - launches
    fields = ens.get_fields()
    for k in range(3):
        solo = Simulation(member_settings(s, k), seed=2 + k, mesh_dims=dims,
                          devices=["cuda:0"] * n)
        launches = cuda_stencil.LAUNCHES
        solo.iterate(6)
        assert cuda_stencil.LAUNCHES - launches == batched
        for a, b in zip(fields, solo.get_fields()):
            assert (a[k] == b).all()


@pytest.mark.cuda
def test_ensemble_member_shards_across_cards(monkeypatch, tmp_path):
    """``member_shards = 2`` over a (2,1,1) spatial mesh on four cards:
    each group's blocks on its own cards, every member bitwise equal to
    its solo run on (2,1,1); then the same run as four NCCL processes, a
    card each, each group spanning two of them."""
    _card()
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 cards, this machine has "
                    f"{torch.cuda.device_count()}")
    from grayscott_jl_tpu_torch import Simulation
    from grayscott_jl_tpu_torch.ensemble import spec as ens_spec
    from grayscott_jl_tpu_torch.ensemble.engine import EnsembleSimulation
    from grayscott_jl_tpu_torch.ensemble.io import member_settings

    monkeypatch.setenv("GS_FUSE", "2")
    s = Settings(L=32, noise=0.1, precision="Float32", backend="CUDA",
                 kernel_language="CUDA", **KW)
    s.ensemble = ens_spec.from_toml(
        {"presets": ["spots", "stripes", "waves", "chaos"],
         "member_shards": 2}, s)
    ens = EnsembleSimulation(s, seed=1, n_devices=4, mesh_dims=(2, 1, 1))
    assert ens.domain.dims == (2, 1, 1) and ens.member_shards == 2
    assert [str(d) for d in ens.mesh.devices] == [f"cuda:{i}"
                                                  for i in range(4)]
    ens.iterate(6)
    fields = ens.get_fields()
    for k in range(4):
        g = k // 2
        solo = Simulation(member_settings(s, k), seed=1 + k,
                          mesh_dims=(2, 1, 1),
                          devices=[f"cuda:{2 * g}", f"cuda:{2 * g + 1}"])
        solo.iterate(6)
        for a, b in zip(fields, solo.get_fields()):
            assert (a[k] == b).all()
    # The same groups as four NCCL processes, a card each: each group's
    # two blocks on two processes, its halo exchange between them; every
    # member's store bitwise equal to the one-process run's.
    import os

    from grayscott_jl_tpu_torch import driver, launch
    from grayscott_jl_tpu_torch.config.settings import get_settings

    monkeypatch.setenv("GS_TPU_MESH_DIMS", "2,1,1")
    base = tmp_path
    one_cfg = _ens_card_config(base / "one", L=32, steps=6, plotgap=6)
    driver.run_once(get_settings([one_cfg]), sim_factory=(
        lambda st, *, n_devices, seed: EnsembleSimulation(
            st, seed=seed, devices=[f"cuda:{i}" for i in range(4)])))
    cfg = _ens_card_config(base / "four", L=32, steps=6, plotgap=6)
    env = {k: v for k, v in os.environ.items()
           if k not in ("GS_TPU_COORDINATOR", "GS_TPU_DISTRIBUTED")}
    log = base / "four" / "launch.log"
    with open(log, "w") as f:
        codes = launch.launch(4, cfg, 1, env=env, cwd=str(base / "four"),
                              timeout=240, stdout=f, stderr=f)
    assert codes == [0] * 4, log.read_text()[-4000:]
    _assert_member_stores_equal(base / "one", base / "four", 4)


# -------------------------------- build and launch analytics, profiling


def _ens_card_config(d, presets=("spots", "stripes", "waves", "chaos"),
                     member_shards=2, **kw):
    """A card config with an ``[ensemble]`` table, the stores in ``d``."""
    d.mkdir(parents=True, exist_ok=True)
    cfg = _card_config(d / "cfg.toml", **kw)
    with open(cfg, "a") as f:
        f.write("[ensemble]\npresets = [" + ", ".join(
            f'"{p}"' for p in presets) + f"]\nmember_shards = "
            f"{member_shards}\n")
    return cfg


def _assert_member_stores_equal(a, b, n):
    """Every member's output store in ``a`` and ``b``: the same steps,
    bitwise the same arrays."""
    import numpy as np

    from grayscott_jl_tpu_torch.ensemble.io import member_path
    from grayscott_jl_tpu_torch.io.bplite import BpReader

    for k in range(n):
        with BpReader(member_path(str(a / "gs.bp"), k, n)) as x, BpReader(
                member_path(str(b / "gs.bp"), k, n)) as y:
            assert x.num_steps() == y.num_steps() > 0
            for i in range(x.num_steps()):
                for name in ("U", "V"):
                    np.testing.assert_array_equal(x.get(name, step=i),
                                                  y.get(name, step=i))


@pytest.mark.cuda
def test_launch_record_attributes_on_the_card(tmp_path, monkeypatch):
    """``GS_XSTATS=1`` on the card: the kernel library's record, and one
    launch record for the ``kBlock`` f32 entry with the card's registers,
    shared bytes (the launch's request at depth 1 on the TMA path: the
    march's ring of plane slots and its barriers) and blocks per SM, and
    the row's cost."""
    _card()
    import json

    from grayscott_jl_tpu_torch import driver
    from grayscott_jl_tpu_torch.obs import xstats

    for var in ("GS_FUSE", "GS_TPU_MESH_DIMS", "GS_COMPILE_CACHE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("GS_XSTATS", "1")
    stats = tmp_path / "stats.json"
    monkeypatch.setenv("GS_TPU_STATS", str(stats))
    sim = driver.main([_card_config(tmp_path / "cfg.toml", steps=8,
                                    plotgap=4)])
    section = json.loads(stats.read_text())["executables"]
    libs = {r["name"]: r for r in section["records"]
            if r.get("record") == "library"}
    assert set(libs) == {"grayscott", "libbplite"}
    (rec,) = [r for r in section["records"] if r.get("record") == "launch"]
    assert (rec["name"], rec["launches"], rec["shape"]) == (
        "kBlock[f32]", 8, [64, 64, 64])
    mem, occ = rec["memory"], rec["occupancy"]
    assert mem["dynamic_shared_bytes"] == cuda_stencil.ring_smem_bytes(4)
    assert 0 < mem["registers"] <= 255 and mem["local_bytes"] >= 0
    assert occ["blocks_per_sm"] >= 1
    assert occ["threads_per_block"] == cuda_stencil.MARCH_THREADS
    flops = SPEC.flops_per_cell_step()
    assert rec["cost"] == xstats.launch_cost("chain", (64,) * 3, 1, flops)
    assert sim.xstats_enabled


@pytest.mark.cuda
def test_profile_window_launch_count_on_the_card(tmp_path, monkeypatch):
    """``GS_PROFILE=4:12`` over 16 steps with boundaries every 4: the
    window's Chrome trace holds exactly the 8 launches of the template's
    kernel from steps 4 to 12 and none outside."""
    _card()
    import json

    from grayscott_jl_tpu_torch import driver

    for var in ("GS_FUSE", "GS_TPU_MESH_DIMS"):
        monkeypatch.delenv(var, raising=False)
    prof = tmp_path / "prof"
    monkeypatch.setenv("GS_PROFILE", "4:12")
    monkeypatch.setenv("GS_PROFILE_DIR", str(prof))
    cuda_stencil.reset_launches()
    driver.main([_card_config(tmp_path / "cfg.toml", steps=16, plotgap=4)])
    assert cuda_stencil.LAUNCHES == 16
    doc = json.loads((prof / "profile_4_12.json").read_text())
    kernels = [e for e in doc["traceEvents"] if e.get("cat") == "kernel"
               and "stencil_chain_kernel" in e.get("name", "")]
    assert len(kernels) == 8


@pytest.mark.cuda
@pytest.mark.parametrize("ensemble,every", [(False, 1), (True, 1), (False, 5)],
                         ids=["solo", "member1", "solo-every5"])
def test_launch_ranges_hold_their_kernel_launches(tmp_path, monkeypatch,
                                                  ensemble, every):
    """Under a capture of the card: every ``gs_launch_call`` lies in a
    ``gs_launch`` and holds the ``cudaLaunchKernel`` of its stencil
    kernel, one ``gs_launch`` a launch recorded (a batch of one member
    re-enters ``fused_step`` inside its range) on one launch in
    ``LAUNCH_RANGE_EVERY``, and every launch is timed:
    ``TIMED_LAUNCHES`` equals ``LAUNCHES``."""
    _card()
    from grayscott_jl_tpu_torch import driver
    from grayscott_jl_tpu_torch.config.settings import get_settings
    from torch.profiler import ProfilerActivity, profile

    for var in ("GS_FUSE", "GS_TPU_MESH_DIMS", "GS_TRACE", "GS_PROFILE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(cuda_stencil, "LAUNCH_RANGE_EVERY", every)
    cfg = (_ens_card_config(tmp_path, presets=("spots",), member_shards=1,
                            steps=16, plotgap=4) if ensemble else
           _card_config(tmp_path / "cfg.toml", steps=16, plotgap=4))
    settings = get_settings([cfg])
    driver.run_once(settings, n_devices=1, seed=3)  # builds and warms
    torch.cuda.synchronize()
    cuda_stencil.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        driver.run_once(settings, n_devices=1, seed=3)
    cuda = torch.autograd.DeviceType.CUDA
    host, kernels = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            kernels += "stencil_chain_kernel" in e.name()
        else:
            host.append((e.name(), e.start_ns(),
                         e.start_ns() + e.duration_ns()))

    def inside(a, b):
        return b[1] <= a[1] and a[2] <= b[2]

    launches = [h for h in host if h[0] == "gs_launch"]
    calls = [h for h in host if h[0] == "gs_launch_call"]
    runtime = [h for h in host if h[0].startswith("cudaLaunchKernel")]
    assert cuda_stencil.LAUNCHES == 16 and kernels == 16
    assert cuda_stencil.TIMED_LAUNCHES == cuda_stencil.LAUNCHES
    assert len(launches) == len(calls) == -(-16 // every)
    for c in calls:
        assert sum(inside(c, h) for h in launches) == 1
        assert sum(inside(r, c) for r in runtime) == 1
    t = cuda_stencil.timings()
    assert t["call_ns"] > 0 and t["dispatch_ns"] > 0 and t["sync_ns"] > 0
    assert t["ops_ns"] > 0


@pytest.mark.cuda
def test_member_groups_across_two_processes_on_one_card(tmp_path,
                                                        monkeypatch):
    """``member_shards = 2`` as two processes sharing ``cuda:0`` over
    gloo, one group each: every member's store bitwise equal to the
    one-process run's, each process 20 batched ``kBlock`` launches of 2
    members."""
    _card()
    import json
    import os

    from grayscott_jl_tpu_torch import driver, launch
    from grayscott_jl_tpu_torch.config.settings import get_settings
    from grayscott_jl_tpu_torch.ensemble.engine import EnsembleSimulation

    for var in ("GS_FUSE", "GS_TPU_MESH_DIMS"):
        monkeypatch.delenv(var, raising=False)
    one_cfg = _ens_card_config(tmp_path / "one")
    driver.run_once(get_settings([one_cfg]), sim_factory=(
        lambda s, *, n_devices, seed: EnsembleSimulation(
            s, seed=seed, devices=["cuda:0"] * 2)))
    cfg = _ens_card_config(tmp_path / "pair")
    stats = tmp_path / "pair" / "stats.json"
    env = {k: v for k, v in os.environ.items()
           if k not in ("GS_TPU_COORDINATOR", "GS_TPU_DISTRIBUTED")}
    env.update(GS_TPU_STATS=str(stats), GS_XSTATS="1",
               CUDA_VISIBLE_DEVICES="0")
    log = tmp_path / "pair" / "launch.log"
    with open(log, "w") as f:
        codes = launch.launch(2, cfg, 1, env=env, cwd=str(tmp_path / "pair"),
                              timeout=240, stdout=f, stderr=f)
    assert codes == [0, 0], log.read_text()[-4000:]
    _assert_member_stores_equal(tmp_path / "one", tmp_path / "pair", 4)
    for rank in range(2):
        summary = json.loads(Path(f"{stats}.rank{rank}").read_text())
        assert summary["config"]["launches"]["modes"] == {"chain": 20}
        (rec,) = [r for r in summary["executables"]["records"]
                  if r.get("record") == "launch"]
        assert (rec["name"], rec["launches"], rec["members"]) == (
            "kBlock[f32]x2", 20, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", [9, 10])
def test_fleet_chaos_scenarios_on_the_card(tmp_path, capsys, scenario):
    """Chaos scenarios 9 and 10 with every serve process on ``cuda:0``
    (``--backend CUDA``, the default): too long for the smoke."""
    _card()
    import json

    from grayscott_jl_tpu_torch import chaos

    rc = chaos.main(["--L", "64", "--steps", "60", "--scenarios",
                     str(scenario), "--seed", "3", "--workdir",
                     str(tmp_path / "w")])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert rc == 0, lines
    assert [(r["scenario"], r["ok"]) for r in lines] == [(scenario, True)]


@pytest.mark.cuda
def test_two_worker_threads_share_the_card(tmp_path, monkeypatch):
    """``GS_SERVE_WORKERS=2`` in one process: two batches of different
    pack keys run at once on ``cuda:0``, each member bitwise equal to its
    solo run on the card, the launch counts exact, and no kernel library
    built twice."""
    _card()
    from grayscott_jl_tpu_torch import chaos, driver
    from grayscott_jl_tpu_torch.obs import events as obs_events
    from grayscott_jl_tpu_torch.obs.events import parse_events
    from grayscott_jl_tpu_torch.ops import _build
    from grayscott_jl_tpu_torch.serve.scheduler import ServeConfig
    from grayscott_jl_tpu_torch.serve.server import ServeService

    events = tmp_path / "events.jsonl"
    monkeypatch.setenv("GS_EVENTS", str(events))
    obs_events.reset_events()
    specs = [{"tenant": "t", "L": L, "steps": 200, "plotgap": 100,
              "checkpoint_freq": 100, "dt": 1.0, "noise": 0.1,
              "seed": 7 + i, "params": {"F": 0.02 + 0.01 * i, "k": 0.048,
                                        "Du": 0.2, "Dv": 0.1}}
             for i, L in enumerate((128, 128, 160, 160))]
    cuda_stencil.reset_launches()
    svc = ServeService(ServeConfig(
        port=0, workers=2, pack_max=2, pack_window_s=0.2,
        state_dir=str(tmp_path / "st"), supervise=False, cache=False,
        backend="CUDA")).start()
    try:
        base = f"http://127.0.0.1:{svc.port}"
        jobs = [chaos.post(base, "/v1/jobs", s)["job"] for s in specs]
        records = chaos.wait_terminal(base, jobs, timeout=600)
    finally:
        svc.close()
        obs_events.reset_events()
    assert [r["state"] for r in records] == ["complete"] * 4
    assert len({r["batch"] for r in records}) == 2
    assert cuda_stencil.LAUNCHES == 400
    assert cuda_stencil.MODE_MEMBERS["chain"] == 2
    assert all(n == 1 for n in _build.BUILDS.values()), _build.BUILDS
    spans = {}
    for e in parse_events(str(events)):
        batch = e["attrs"].get("batch")
        if e["kind"] in ("run_start", "run_complete") and batch:
            spans.setdefault(batch, []).append(e["ts"])
    (a0, a1), (b0, b1) = sorted(spans.values())
    assert b0 < a1 and a0 < b1, f"the batches did not overlap: {spans}"
    for i, spec in enumerate(specs):
        d = tmp_path / f"solo{i}"
        d.mkdir()
        cfg = d / "c.toml"
        cfg.write_text("\n".join([
            f"L = {spec['L']}", "steps = 200", "plotgap = 100", "dt = 1.0",
            "noise = 0.1", "checkpoint = true", "checkpoint_freq = 100",
            *(f"{k} = {v}" for k, v in spec["params"].items()),
            f'output = "{d}/gs.bp"', f'checkpoint_output = "{d}/ckpt.bp"',
            'precision = "Float32"', 'backend = "CUDA"',
            'kernel_language = "CUDA"']) + "\n")
        driver.main([str(cfg)], seed=spec["seed"])
        trees = chaos.member_trees(records[i]["store"])
        for kind, name in (("gs", "gs.bp"), ("vtk", "gs.vtk"),
                           ("ckpt", "ckpt.bp")):
            assert chaos.trees_equal(str(d / name), trees[kind]) == [], (
                i, kind)


@pytest.mark.cuda
def test_pdfcalc_histograms_on_the_card_equal_the_cpu():
    """``analysis/pdfcalc.compute_pdf`` on the card (its default) equals
    its CPU path bit for bit on seeded float32 and float64 blocks, a
    block holding a NaN, and the 64^3 block where a division by the bin
    width as a host scalar would move cells."""
    _card()
    import numpy as np

    from grayscott_jl_tpu_torch.analysis import pdfcalc

    rng = np.random.default_rng(0)
    blocks = [rng.uniform(0.1, 0.8, (64, 64, 64)).astype(np.float32),
              rng.random((8, 16, 16)), rng.random((8, 16, 16))
              .astype(np.float32)]
    blocks[2][1, 2, 3] = np.nan
    for block in blocks:
        for nbins in (16, 1000):
            card = pdfcalc.compute_pdf(block, nbins)
            host = pdfcalc.compute_pdf(block, nbins, device="cpu")
            for a, b in zip(card, host):
                assert a.dtype == b.dtype
                assert np.array_equal(a, b, equal_nan=True)


@pytest.mark.cuda
def test_adios2_engine_output_equals_bplite_on_card(tmp_path, monkeypatch):
    """The main path at L=64 on the card with its output store through
    the ADIOS2 engine (the strict API fake of ``tests/support`` as the
    ``adios2`` module; the card's machine has no wheel) equals the same
    run on BP-lite (``GS_TPU_ADIOS2=0``) bitwise, step for step, with
    the checkpoint store on BP-lite in both."""
    import os
    import sys

    import numpy as np

    from grayscott_jl_tpu_torch import driver
    from grayscott_jl_tpu_torch.io import adios, open_reader

    _card()
    fake = str(Path(__file__).resolve().parent / "support" / "adios2_fake")
    prior = sys.modules.pop("adios2", None)
    sys.path.insert(0, fake)
    adios.available.cache_clear()
    try:
        assert adios.available()

        def run(name, engine):
            d = tmp_path / name
            d.mkdir()
            monkeypatch.setenv("GS_TPU_ADIOS2",
                               "1" if engine == "adios2" else "0")
            s = Settings(L=64, steps=40, plotgap=10, noise=0.1,
                         precision="Float32", backend="CUDA",
                         kernel_language="CUDA", checkpoint=True,
                         checkpoint_freq=20, output=str(d / "gs.bp"),
                         checkpoint_output=str(d / "ckpt.bp"), **KW)
            cuda_stencil.reset_launches()
            driver.run_once(s)
            assert cuda_stencil.LAUNCHES == 40
            assert os.path.isfile(d / "ckpt.bp" / "md.json")
            assert os.path.isfile(d / "gs.bp" / "md.json") == (
                engine != "adios2")
            with open_reader(str(d / "gs.bp")) as r:
                return [{n: np.asarray(r.get(n, step=i))
                         for n in ("step", "U", "V")}
                        for i in range(r.num_steps())]

        a, c = run("a", "adios2"), run("c", "bplite")
        assert len(a) == len(c) == 4
        for x, y in zip(a, c):
            for n in x:
                assert x[n].dtype == y[n].dtype and np.array_equal(
                    x[n], y[n]), n
    finally:
        sys.path.remove(fake)
        sys.modules.pop("adios2", None)
        if prior is not None:
            sys.modules["adios2"] = prior
        adios.available.cache_clear()
