"""The CUDA kernel on the card (tests marked ``cuda``; each skips where
``torch.cuda.is_available()`` is false).

Imports neither JAX nor the reference package, so it runs on a machine
with only torch and nvcc:

    GS_TPU_TESTS=1 python -m pytest -m cuda tests/test_torch_card.py

(``GS_TPU_TESTS=1`` keeps tests/conftest.py from pinning JAX.) The
kernel must equal its plain torch version bitwise: both perform the
same IEEE operations in the same order (``--fmad=false``)."""

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


@pytest.mark.cuda
def test_kernel_refuses_models_it_does_not_carry():
    _card()
    heat = get_model("heat")
    params = heat.make_params(Settings(), torch.float32, "cuda")
    f = (torch.zeros((8, 8, 8), device="cuda"),)
    with pytest.raises(kernelgen.KernelGenError, match="Queue 2 item 4"):
        cuda_stencil.fused_step(f, params, (0, 0, 0),
                                spec=kernelgen.get_spec(heat))


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
    run, and every round went through the kernel's face mode."""
    _card()
    monkeypatch.setenv("GS_FUSE", fuse)
    s = Settings(L=24, noise=0.1, precision="Float32", backend="CUDA",
                 **KW)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dims,fuse", [
    (None, "1"), ((4, 1, 1), "2"), ((2, 2, 1), "2"), ((2, 1, 2), "3"),
])
def test_sharded_run_across_cards_equals_single_block(dims, fuse,
                                                      monkeypatch):
    """Blocks on different cards: the exchange copies between devices
    (``Tensor.to``), each block's kernel runs on its own card with its
    own params. ``dims=None`` is the default mesh over every card. Needs
    two or more cards; bitwise equal to the single-block run."""
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
    placed = [str(f.device) for fields in mesh.blocks for f in fields]
    assert placed == [d for d in devices for _ in range(2)]
    for a, b in zip(single.get_fields(), mesh.get_fields()):
        assert (a == b).all()
