"""The benchmark's frozen arithmetic and its reference, on the CPU.

Bytes per launch against hand counts; each frozen copy against the
program's own (so that a drift of either side shows); the reference
against the program's plain path, bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gsbench import reference as ref
from gsbench import yardstick

GS_ROW = dict(Du=0.2, Dv=0.1, F=0.02, k=0.048, dt=1.0, noise=0.1)


@pytest.mark.parametrize("L", [256, 512, 1024])
def test_chain_bytes_are_16_per_cell_step_in_float32(L):
    cost = yardstick.launch_cost("chain", (L, L, L), 1, 34)
    assert cost["bytes"] == 16 * L**3
    assert cost["flops"] == 34 * L**3
    assert cost["bound_by"] == "bytes"
    assert cost["bound_ms"] == pytest.approx(16 * L**3 / 3.35e12 * 1e3)


def test_members_multiply_the_bytes():
    one = yardstick.launch_cost("chain", (256,) * 3, 1, 34)
    five = yardstick.launch_cost("chain", (256,) * 3, 1, 34, members=5)
    assert five["bytes"] == 5 * one["bytes"] == 5 * 16 * 256**3


def test_faces6_bytes_by_hand():
    nx, ny, nz = 512, 512, 1024
    faces = 2 * (ny * nz + nx * nz + nx * ny)
    cost = yardstick.launch_cost("faces6", (nx, ny, nz), 1, 34)
    assert cost["bytes"] == 2 * (2 * nx * ny * nz + faces) * 4
    assert cost["flops"] == 34 * nx * ny * nz


def test_window_least_time_sums_launches():
    shape = (512, 512, 1024)
    per = yardstick.launch_cost("faces6", shape, 1, 34)["bound_ms"]
    got = yardstick.window_least_ms({"faces6": 10}, steps=10, blocks=1,
                                    shape=shape, members=1, flops=34,
                                    itemsize=4, n_fields=2)
    assert got == pytest.approx(10 * per)
    chain = yardstick.window_least_ms({"chain": 5}, steps=10, blocks=1,
                                      shape=(64,) * 3, members=1, flops=34,
                                      itemsize=4, n_fields=2)
    want = 5 * yardstick.launch_cost("chain", (64,) * 3, 2, 34)["bound_ms"]
    assert chain == pytest.approx(want)
    assert yardstick.window_least_ms({"band": 3}, steps=1, blocks=1,
                                     shape=(8,) * 3, members=1, flops=34,
                                     itemsize=4, n_fields=2) is None


@pytest.mark.parametrize(
    "mode,shape,fuse,members",
    [("chain", (256, 256, 256), 1, 1), ("chain", (512, 512, 512), 3, 5),
     ("faces6", (128, 128, 128), 1, 1), ("faces6", (512, 512, 1024), 1, 3),
     ("xchain", (32, 256, 256), 2, 1), ("xychain", (128, 132, 128), 2, 2)])
def test_byte_arithmetic_agrees_with_the_program(mode, shape, fuse, members):
    from grayscott_jl_tpu_torch.obs import xstats

    assert (yardstick.launch_cost(mode, shape, fuse, 34, members=members)
            == xstats.launch_cost(mode, shape, fuse, 34, members=members))


def test_peaks_agree_with_the_program():
    from grayscott_jl_tpu_torch.obs import xstats

    assert yardstick.HBM_BYTES_PER_S == xstats.HBM_BYTES_PER_S
    assert yardstick.F32_FLOPS_PER_S == xstats.F32_FLOPS_PER_S


def test_flop_count_agrees_with_the_programs_generator():
    from grayscott_jl_tpu_torch.models import get_model
    from grayscott_jl_tpu_torch.ops import kernelgen

    spec = kernelgen.get_spec(get_model("grayscott"))
    assert (yardstick.FLOPS_PER_CELL_STEP["grayscott"]
            == spec.flops_per_cell_step("float32"))


@pytest.mark.parametrize("seed,step,x0", [(0, 0, 0), (12345, 7, 5),
                                          (2**31 + 99, 123456, 9),
                                          (2**32 - 1, 2**31, 0)])
def test_noise_stream_agrees_with_the_program(seed, step, x0):
    from grayscott_jl_tpu_torch.ops.noise import uniform_pm1_block

    L = 16
    mine = ref.unit_noise((0, seed), step, x0, L, L, "cpu")
    theirs = uniform_pm1_block((0, seed), step, (x0, 0, 0), (L - x0, L, L),
                               L, torch.float32)
    assert torch.equal(mine, theirs)


def test_ensemble_members_are_pearsons_presets():
    from grayscott_jl_tpu_torch.ensemble.spec import PRESETS

    from gsbench import harness

    cell = harness.load_cell("gs-ens5-f32.l256")
    names = ["spots", "stripes", "waves", "mitosis", "chaos"]
    for row, name in zip(cell.member_rows(), names, strict=True):
        for key, value in PRESETS[name].items():
            assert row[key] == value, (name, key)


def _program(L, steps, seed, members=None, n_devices=None):
    import grayscott_jl_tpu_torch as gs
    from grayscott_jl_tpu_torch.config.settings import parse_settings_toml

    from gsbench import harness

    s = dict(GS_ROW, L=L, steps=steps, plotgap=0, backend="CPU",
             kernel_language="Plain", precision="Float32")
    if members:
        s["ensemble"] = {"member": members}
    settings = parse_settings_toml(harness.settings_toml(s))
    cls = gs.Simulation
    if members:
        from grayscott_jl_tpu_torch.ensemble.engine import EnsembleSimulation
        cls = EnsembleSimulation
    sim = cls(settings, seed=seed, n_devices=n_devices)
    sim.iterate(steps)
    return [torch.from_numpy(np.ascontiguousarray(f)) for f in
            sim.get_fields()]


@pytest.mark.parametrize("steps,n_devices", [(1, None), (6, None), (4, 8)])
def test_reference_equals_the_programs_plain_path(steps, n_devices):
    L, seed = 16, 2**31 + 5
    u, v = _program(L, steps, seed, n_devices=n_devices)
    want = ref.advance(ref.initial_state(L), [GS_ROW], [(0, seed)], 0, steps)
    assert ref.max_abs_gap((u[None], v[None]), want) == 0.0


def test_reference_ensemble_equals_the_programs_plain_path():
    L, seed, steps = 16, 77, 4
    members = [{"F": 0.030, "k": 0.062}, {"F": 0.055, "k": 0.062},
               {"F": 0.018, "k": 0.051}]
    u, v = _program(L, steps, seed, members=members)
    rows = [dict(GS_ROW, **m) for m in members]
    keys = [(0, seed + m) for m in range(len(members))]
    want = ref.advance(ref.initial_state(L, len(members)), rows, keys, 0,
                       steps)
    assert ref.max_abs_gap((u, v), want) == 0.0


def test_reference_slabs_do_not_change_the_step():
    L = 12
    state = ref.initial_state(L, 2)
    params = ref.Params([GS_ROW, dict(GS_ROW, F=0.03)], torch.float32, "cpu")
    keys = [(0, 1), (0, 2)]
    whole = ref.step(*state, params, keys, 3, slab=L)
    for slab in (1, 5):
        part = ref.step(*state, params, keys, 3, slab=slab)
        assert ref.max_abs_gap(whole, part) == 0.0


def test_max_abs_gap_takes_nan_as_infinite():
    a = (torch.zeros(1, 4, 4, 4), torch.zeros(1, 4, 4, 4))
    b = (torch.zeros(1, 4, 4, 4), torch.full((1, 4, 4, 4), float("nan")))
    assert ref.max_abs_gap(a, b) == float("inf")


@pytest.mark.parametrize("hi", [0xFFFF, 0xFFFFFFFF])
def test_hash_uses_32_bit_products(hi):
    xs = torch.tensor([0, 1, 2**31, hi, 0x12345678], dtype=torch.int64)
    for x, h in zip(xs.tolist(), ref.hash32(xs).tolist()):
        y = x ^ (x >> 16)
        y = (y * 0x7FEB352D) & 0xFFFFFFFF
        y ^= y >> 15
        y = (y * 0x846CA68B) & 0xFFFFFFFF
        y ^= y >> 16
        assert h == y
