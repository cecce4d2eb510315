"""The fuse-1 march's ledger (``ops/cuda_stencil.py``): the rule that
picks the march or the window kernel for a launch, the ring's plane box
(its z start on a 16 B boundary, TMA's limits, its shared bytes), the
span a block walks, and the schedule counts. The kernel itself is held
to the plain version on the card (``tests/test_torch_card.py``)."""

import pytest
import torch

from grayscott_jl_tpu_torch.ops import cuda_stencil

#: An H100's SMs, and the march blocks resident on one (the card reports
#: one block of 544 threads at ~80 registers).
SMS = 132
RESIDENT = 1


@pytest.mark.parametrize("mode,fuse,shape,itemsize,ptrs,want", [
    ("chain", 1, (256, 256, 256), 4, (0, 256, 512, 768), "march"),
    ("chain", 1, (40, 36, 72), 4, (0, 256), "march"),
    ("chain", 1, (20, 24, 42), 8, (0, 256), "march"),
    ("chain", 1, (128, 128, 128), 2, (0, 256), "march"),
    ("chain", 1, (7, 32, 64), 2, (0, 256), "march"),
    ("chain", 2, (256, 256, 256), 4, (0, 256), "window"),
    ("chain", 5, (256, 256, 256), 4, (0, 256), "window"),
    ("faces6", 1, (128, 128, 128), 4, (0, 256), "window"),
    ("xchain", 2, (32, 256, 256), 4, (0, 256), "window"),
    ("xychain", 2, (128, 132, 128), 4, (0, 256), "window"),
    ("chain", 1, (250, 250, 250), 4, (0, 256), "window"),   # 1,000 B rows
    ("chain", 1, (100, 100, 100), 2, (0, 256), "window"),   # 200 B rows
    ("chain", 1, (20, 24, 41), 8, (0, 256), "window"),      # 328 B rows
    ("chain", 1, (64, 64, 64), 4, (0, 256, 512, 776), "window"),  # an output
    ("chain", 1, (64, 64, 64), 4, (4, 256, 512, 768), "window"),  # an input
])
def test_schedule_rule(mode, fuse, shape, itemsize, ptrs, want):
    """The march engages for ``chain`` at depth 1 whose inputs and
    outputs pass the TMA rules, and nowhere else."""
    assert cuda_stencil.schedule_of(mode, fuse, shape, itemsize,
                                    ptrs) == want


def test_schedule_follows_a_forced_load_path():
    """A launch forced onto ``cp.async`` runs the window kernel; forced
    onto TMA, a depth-1 chain marches."""
    with cuda_stencil.override(load="cp_async"):
        assert cuda_stencil.schedule_of("chain", 1, (64,) * 3, 4,
                                        (0, 256)) == "window"
    with cuda_stencil.override(load="tma"):
        assert cuda_stencil.schedule_of("chain", 1, (64,) * 3, 4,
                                        (0, 256)) == "march"
        assert cuda_stencil.schedule_of("chain", 2, (64,) * 3, 4,
                                        (0, 256)) == "window"


@pytest.mark.parametrize("itemsize,want", [
    (4, (4, 64, 72, 34, 9792, 9856)),
    (8, (2, 32, 36, 34, 9792, 9856)),
    (2, (8, 128, 144, 34, 9792, 9856)),
])
def test_ring_geometry(itemsize, want):
    """A slot holds the column's rows and a one-row y halo, each row the
    column's 256 B of z and 16 B a side, rounded up to 128 B."""
    assert cuda_stencil.ring_geometry(itemsize) == want


@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_ring_box_starts_on_a_16_byte_boundary(itemsize):
    """TMA refuses a box whose z origin is not 16 B aligned: every
    column's box starts V cells (16 B) below the column, on one, and
    covers the z halo cell on both sides; no cell is left to a lead
    pass. The box keeps TMA's limits (at most 256 cells an axis, a row a
    multiple of 16 B) and the slots TMA's 128 B destination alignment."""
    v, tz, bz, ry, box, slot = cuda_stencil.ring_geometry(itemsize)
    assert v * itemsize == 16 and tz * itemsize == cuda_stencil.MARCH_Z_BYTES
    for z0 in range(0, 1024, tz):
        start = z0 - v
        assert (start * itemsize) % 16 == 0
        assert start <= z0 - 1 and start + bz >= z0 + tz + 1
    assert bz <= 256 and ry <= 256 and (bz * itemsize) % 16 == 0
    assert box == ry * bz * itemsize and slot % 128 == 0 and slot >= box
    assert cuda_stencil.RING_HEAD % 128 == 0
    assert cuda_stencil.RING_HEAD >= 2 * cuda_stencil.RING_SLOTS * 8
    # Sixteen threads of 16 B cover a row; two rows a consumer warp.
    assert 16 * v == tz
    warps = cuda_stencil.MARCH_THREADS // 32 - 1
    assert 2 * warps == cuda_stencil.MARCH_ROWS


@pytest.mark.parametrize("n_fields", [1, 2])
def test_ring_ledger_fits_two_blocks_per_sm(n_fields):
    """The ring's bytes, beside the window's: under one block's limit,
    two blocks to an SM's 228 KB; the window's caps do not change."""
    for itemsize in (2, 4, 8):
        ring = cuda_stencil.ring_smem_bytes(itemsize, n_fields)
        assert ring == (cuda_stencil.RING_HEAD + cuda_stencil.RING_SLOTS
                        * n_fields * cuda_stencil.ring_geometry(itemsize)[5])
        assert 2 * (ring + 1024) <= 233_472
        assert ring <= cuda_stencil.SMEM_LIMIT
    assert cuda_stencil.ring_smem_bytes(4) == 78_976
    assert [cuda_stencil.max_feasible_fuse(i) for i in (2, 4, 8)] == [8, 5, 2]


@pytest.mark.parametrize("shape,itemsize,members,want", [
    ((256, 256, 256), 4, 1, (32, 16, 16)),
    ((512, 512, 512), 4, 1, (128, 103, 5)),
    ((256, 256, 256), 4, 5, (32, 64, 4)),
    ((40, 36, 72), 4, 1, (4, 20, 2)),
    ((7, 32, 64), 4, 1, (1, 7, 1)),
    ((50, 32, 64), 4, 1, (1, 17, 3)),
    ((256, 256, 256), 2, 1, (16, 16, 16)),
    ((256, 256, 256), 8, 1, (64, 29, 9)),
])
def test_march_grid(shape, itemsize, members, want):
    assert cuda_stencil.march_grid(shape, itemsize, members) == want


@pytest.mark.parametrize("nx", [1, 7, 15, 16, 17, 31, 32, 50, 100, 255,
                                256, 257, 512, 1024])
@pytest.mark.parametrize("tiles", [1, 2, 32, 160, 528, 10_000])
def test_march_span_covers_the_planes(nx, tiles):
    """The segments cover nx exactly, none empty, and a span is at least
    the least span wherever nx allows one."""
    span = cuda_stencil.march_span(nx, tiles)
    segs = -(-nx // span)
    assert 1 <= span <= nx and (segs - 1) * span < nx <= segs * span
    if nx >= cuda_stencil.MARCH_MIN_SPAN:
        assert span >= cuda_stencil.MARCH_MIN_SPAN
    else:
        assert span == nx


@pytest.mark.parametrize("shape,members", [((256,) * 3, 1),
                                           ((512,) * 3, 1),
                                           ((256,) * 3, 5)])
def test_march_grid_holds_two_waves(shape, members):
    """At the cells' shapes the grid holds at least two waves of
    resident blocks on 132 SMs."""
    cols, _, segs = cuda_stencil.march_grid(shape, 4, members)
    assert cols * segs * members >= 2 * RESIDENT * SMS


def test_reset_launches_zeroes_the_schedule_counts():
    cuda_stencil.count_launch("chain", "tma", schedule="march")
    cuda_stencil.count_launch("faces6", "tma")
    assert cuda_stencil.SCHEDULE_LAUNCHES["march"] >= 1
    assert cuda_stencil.SCHEDULE_LAUNCHES["window"] >= 1
    cuda_stencil.reset_launches()
    assert cuda_stencil.SCHEDULE_LAUNCHES == {"window": 0, "march": 0}


def test_replayed_launches_count_no_schedule():
    """The SDC screen's replays count in ``REPLAY_LAUNCHES`` alone."""
    cuda_stencil.reset_launches()
    with cuda_stencil.replaying():
        cuda_stencil.count_launch("chain", "tma", schedule="march")
    assert cuda_stencil.SCHEDULE_LAUNCHES == {"window": 0, "march": 0}
    assert cuda_stencil.REPLAY_LAUNCHES == 1
    cuda_stencil.reset_launches()


def test_cpu_tensors_count_no_schedule():
    """On the CPU the wrapper runs the plain version: no schedule."""
    from grayscott_jl_tpu_torch.config.settings import Settings
    from grayscott_jl_tpu_torch.models import get_model
    from grayscott_jl_tpu_torch.ops import kernelgen

    spec = kernelgen.get_spec(get_model("grayscott"))
    params = spec.model.make_params(Settings(noise=0.1), torch.float32, "cpu")
    fields = tuple(torch.rand((8, 8, 8)) for _ in range(2))
    cuda_stencil.reset_launches()
    cuda_stencil.fused_step(fields, params, (0, 1, 2), spec=spec, row=8)
    assert cuda_stencil.SCHEDULE_LAUNCHES == {"window": 0, "march": 0}


def test_march_layout_is_the_ledgers():
    """The ``gs_layout`` tail the library is checked against."""
    assert cuda_stencil.MARCH_LAYOUT == (32, 256, 4, 544, 16, 528)
