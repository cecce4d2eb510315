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
