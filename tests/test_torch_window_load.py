"""The stencil kernel's window load (``ops/cuda_stencil.py``): the rule
that picks TMA or ``cp.async``, the padded window geometry, and the
torch-ops emulation of the load (padded stride, the TMA box from a
16 B boundary with zero fill, the ghost pass over the lead slab and the
six outside boxes; or cp.async) held to the window's definition — each
cell of the operand, and outside it the mode's value, as the per-cell
walk it replaced gave them — for every tile of small operands, every
mode and dtype."""

import math

import pytest
import torch

from grayscott_jl_tpu_torch.ops import cuda_stencil

TILE = cuda_stencil.TILE
DTYPES = (torch.float32, torch.float64, torch.bfloat16)


def reference_window(fields, faces, mode, fuse, origin, bounds):
    """The window by definition: each field placed in an extended grid
    whose cells outside the operand hold the boundary value, or in the
    face modes the face of the one axis a ghost lies across (6n faces)
    or the k-deep x slabs (x-chain); the (WX, WY, WZ) box at
    ``origin`` cut from it."""
    nx, ny, nz = fields[0].shape
    wx, wy, wz = (t + 2 * fuse for t in TILE)
    pad = max(wx, wy, wz) + max(TILE)
    n_f = len(fields)
    out = []
    for f, (field, bv) in enumerate(zip(fields, bounds)):
        ext = torch.full((nx + 2 * pad, ny + 2 * pad, nz + 2 * pad), bv,
                         dtype=field.dtype)
        X, Y, Z = (slice(pad, pad + n) for n in (nx, ny, nz))
        ext[X, Y, Z] = field
        if mode == "faces6":
            ext[pad - 1, Y, Z] = faces[2 * f][0]
            ext[pad + nx, Y, Z] = faces[2 * f + 1][0]
            ext[X, pad - 1, Z] = faces[2 * n_f + 2 * f][:, 0]
            ext[X, pad + ny, Z] = faces[2 * n_f + 2 * f + 1][:, 0]
            ext[X, Y, pad - 1] = faces[4 * n_f + 2 * f][:, :, 0]
            ext[X, Y, pad + nz] = faces[4 * n_f + 2 * f + 1][:, :, 0]
        elif mode in ("xchain", "xychain"):
            ext[pad - fuse:pad, Y, Z] = faces[2 * f]
            ext[pad + nx:pad + nx + fuse, Y, Z] = faces[2 * f + 1]
        o = [pad + v for v in origin]
        out.append(ext[o[0]:o[0] + wx, o[1]:o[1] + wy, o[2]:o[2] + wz])
    return out


def tile_origins(shape, fuse):
    """The window origin of every tile of an operand of ``shape``."""
    counts = [math.ceil(n / t) for n, t in zip(shape, TILE)]
    for i in range(counts[0]):
        for j in range(counts[1]):
            for k in range(counts[2]):
                yield (i * TILE[0] - fuse, j * TILE[1] - fuse,
                       k * TILE[2] - fuse)


def random_operand(shape, dtype, mode, fuse, n_f=2, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def rand(s):
        return torch.rand(s, generator=gen, dtype=torch.float64).to(dtype)

    nx, ny, nz = shape
    fields = tuple(rand(shape) for _ in range(n_f))
    faces = None
    if mode == "faces6":
        faces = tuple(rand(s) for s in [(1, ny, nz)] * (2 * n_f)
                      + [(nx, 1, nz)] * (2 * n_f) + [(nx, ny, 1)] * (2 * n_f))
    elif mode in ("xchain", "xychain"):
        faces = tuple(rand((fuse, ny, nz)) for _ in range(2 * n_f))
    return fields, faces


CASES = [
    ("chain", (16, 16, 16), 1),
    ("chain", (20, 12, 30), 2),
    ("chain", (9, 17, 31), 3),
    ("faces6", (12, 10, 30), 1),
    ("faces6", (8, 16, 32), 1),
    ("xchain", (6, 10, 27), 2),
    ("xchain", (16, 9, 32), 3),
    ("xychain", (8, 14, 20), 2),
]


@pytest.mark.parametrize("load", cuda_stencil.LOAD_PATHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("mode,shape,fuse", CASES)
def test_emulated_load_equals_the_window_in_every_tile(mode, shape, fuse,
                                                       dtype, load):
    """Every cell below z = WZ defined (the emulation starts them NaN)
    and equal to the window's definition, on both load paths."""
    bounds = (1.0, 0.0)
    fields, faces = random_operand(shape, dtype, mode, fuse)
    wx, wy, wz, wzp, _, _ = cuda_stencil.window_geometry(
        fields[0].element_size(), fuse)
    for origin in tile_origins(shape, fuse):
        got = cuda_stencil.emulate_window(fields, faces, mode=mode,
                                          fuse=fuse, origin=origin,
                                          boundaries=bounds, load=load)
        want = reference_window(fields, faces, mode, fuse, origin, bounds)
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == (wx, wy, wzp)
            assert torch.equal(g[:, :, :wz], w), (mode, shape, origin)


@pytest.mark.parametrize("fuse", [1, 2, 3, 4, 5])
def test_tma_box_starts_on_a_16_byte_boundary(fuse):
    """TMA refuses a box whose z origin is not 16 B aligned: every tile's
    box starts ``lead`` cells above its window's z origin, on one."""
    for itemsize in (2, 4, 8):
        lead = cuda_stencil.window_geometry(itemsize, fuse)[4]
        for z0 in range(0, 256, TILE[2]):
            assert ((z0 - fuse + lead) * itemsize) % 16 == 0
            assert 0 <= lead < 16 // itemsize


def test_emulated_load_of_the_compute_walk_window():
    """The compute walk loads tile (0,0,0)'s window in every block."""
    fields, _ = random_operand((12, 12, 20), torch.float32, "chain", 2)
    got = cuda_stencil.emulate_window(fields, mode="chain", fuse=2,
                                      origin=(-2, -2, -2),
                                      boundaries=(1.0, 0.0))
    want = reference_window(fields, None, "chain", 2, (-2, -2, -2),
                            (1.0, 0.0))
    assert all(torch.equal(g[:, :, :36], w) for g, w in zip(got, want))


def test_emulated_load_zero_fills_before_the_ghost_pass():
    """An interior tile's window holds the operand's cells, the rows'
    padding past WZ included; past the operand, the ghost pass writes the
    cells below WZ and the copy's zeros stay in the padding."""
    shape = (24, 24, 96)
    fields, _ = random_operand(shape, torch.float32, "chain", 1)
    win = cuda_stencil.emulate_window(fields, mode="chain", fuse=1,
                                      origin=(7, 7, 31),
                                      boundaries=(1.0, 0.0))
    wzp = cuda_stencil.window_geometry(4, 1)[3]
    assert torch.equal(win[0], fields[0][7:17, 7:17, 31:31 + wzp])
    edge = cuda_stencil.emulate_window(fields, mode="chain", fuse=1,
                                       origin=(7, 7, 63),
                                       boundaries=(1.0, 0.0))
    # z 63..98 of a 96-cell row: cells 96..98 are outside; 96 and 97
    # are below WZ = 34 cells from the origin (ghost pass: the boundary
    # value), 98 is padding past WZ (zero from the copy).
    assert edge[0][0, 0, 33].item() == 1.0
    assert edge[0][0, 0, 35].item() == 0.0


@pytest.mark.parametrize("itemsize,fuse,want", [
    (4, 1, (10, 10, 34, 36, 1, 32 + 3616)),
    (4, 5, (18, 18, 42, 44, 1, 32 + 14272)),
    (2, 1, (10, 10, 34, 40, 1, 64 + 4032)),
    (2, 8, (24, 24, 48, 48, 0, 64 + 27648)),
    (8, 1, (10, 10, 34, 34, 1, 16 + 3408)),
    (8, 2, (12, 12, 36, 36, 0, 16 + 5184)),
])
def test_window_geometry_pads_rows_to_16_bytes(itemsize, fuse, want):
    wx, wy, wz, wzp, lead, wvol = cuda_stencil.window_geometry(itemsize,
                                                               fuse)
    assert (wx, wy, wz, wzp, lead, wvol) == want
    assert wzp * itemsize % 16 == 0 and wzp - wz < 16 // itemsize
    vq = 128 // itemsize
    assert wvol * itemsize % 128 == 0 and wvol >= vq + wx * wy * wzp


def test_the_ledger_caps_hold_with_padded_windows():
    """The caps stated in max_feasible_fuse's docstring hold: two fields
    8/5/2 (bf16/f32/f64), one field 12/8/5, f32 with bf16 mids 5."""
    caps = [cuda_stencil.max_feasible_fuse(i) for i in (2, 4, 8)]
    assert caps == [8, 5, 2]
    caps = [cuda_stencil.max_feasible_fuse(i, n_fields=1) for i in (2, 4, 8)]
    assert caps == [12, 8, 5]
    assert cuda_stencil.max_feasible_fuse(4, mid_itemsize=2) == 5
    assert cuda_stencil.smem_bytes(4, 5) == 228_872


@pytest.mark.parametrize("shape,itemsize,ptrs,want", [
    ((256, 256, 256), 4, (0, 256), "tma"),
    ((250, 250, 250), 4, (0, 256), "cp_async"),   # 1,000 B rows
    ((84, 250, 250), 4, (0, 256), "cp_async"),
    ((128, 128, 128), 2, (0, 256), "tma"),
    ((100, 100, 100), 2, (0, 256), "cp_async"),   # 200 B rows
    ((100, 100, 100), 4, (0, 256), "tma"),        # 400 B rows
    ((20, 24, 41), 8, (0, 256), "cp_async"),      # 328 B rows
    ((20, 24, 42), 8, (0, 256), "tma"),
    ((64, 64, 64), 4, (0, 260), "cp_async"),      # base not 16 B aligned
    ((64, 64, 64), 4, (8, 256), "cp_async"),
])
def test_load_path_rule(shape, itemsize, ptrs, want):
    assert cuda_stencil.load_path(shape, itemsize, ptrs) == want


def test_load_path_override():
    with cuda_stencil.override(load="cp_async"):
        assert cuda_stencil.load_path((64,) * 3, 4, (0,)) == "cp_async"
    with cuda_stencil.override(load="tma"):
        assert cuda_stencil.load_path((64,) * 3, 4, (0,)) == "tma"
        with pytest.raises(ValueError, match="TMA refuses"):
            cuda_stencil.load_path((250,) * 3, 4, (0,))
    assert cuda_stencil.load_path((250,) * 3, 4, (0,)) == "cp_async"
    with pytest.raises(ValueError):
        with cuda_stencil.override(load="ldg"):
            pass


def test_reset_launches_zeroes_the_load_path_counts():
    cuda_stencil.count_launch("chain", "tma")
    cuda_stencil.count_launch("faces6", "cp_async")
    assert all(cuda_stencil.LOAD_PATH_LAUNCHES[p] >= 1
               for p in cuda_stencil.LOAD_PATHS)
    cuda_stencil.reset_launches()
    assert cuda_stencil.LOAD_PATH_LAUNCHES == {"tma": 0, "cp_async": 0}
    assert cuda_stencil.LAUNCHES == 0


def test_cpu_tensors_take_the_plain_path_and_count_no_load():
    """On the CPU the wrapper runs the plain version: no launch, no load
    path counted."""
    from grayscott_jl_tpu_torch.config.settings import Settings
    from grayscott_jl_tpu_torch.models import get_model
    from grayscott_jl_tpu_torch.ops import kernelgen

    spec = kernelgen.get_spec(get_model("grayscott"))
    params = spec.model.make_params(Settings(noise=0.1), torch.float32, "cpu")
    fields, _ = random_operand((8, 8, 8), torch.float32, "chain", 1)
    cuda_stencil.reset_launches()
    cuda_stencil.fused_step(fields, params, (0, 1, 2), spec=spec, row=8)
    assert cuda_stencil.LOAD_PATH_LAUNCHES == {"tma": 0, "cp_async": 0}
