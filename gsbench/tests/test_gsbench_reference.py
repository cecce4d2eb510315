"""The reference steps a box of the grid: its cells equal the whole
grid's, cropped, bit for bit, wherever the box lies."""

from __future__ import annotations

import pytest
import torch

from gsbench import harness, reference

L = 16
#: name -> (origin, shape): boxes inside the grid, on a face of it, on an
#: edge and on a corner, each 3 steps from vanishing or more.
BOXES = {
    "interior": ((4, 5, 3), (9, 8, 10)),
    "face": ((0, 4, 5), (9, 8, 8)),
    "edge": ((0, 0, 6), (8, 9, 10)),
    "corner": ((0, 0, 0), (9, 7, 8)),
}


def _members(n: int):
    """``n`` members' rows (the ensemble configuration's first ``n``) and
    keys, each member with its own seed."""
    rows = harness.load_cell("gs-ens5-f32.l256").member_rows()[:n]
    return rows, [(0, 2**31 + 101 + m) for m in range(n)]


def _equal(a, b) -> bool:
    return all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("members", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("box", list(BOXES))
def test_box_step_is_the_whole_grid_cropped(box, dtype, members):
    rows, keys = _members(members)
    origin, shape = BOXES[box]
    # A state some steps on, so that every cell differs from its
    # neighbours.
    state = reference.advance(reference.initial_state(L, members), rows,
                              keys, 0, 6)
    whole = reference.advance(state, rows, keys, 6, 3, dtype=dtype)
    part = reference.advance(reference.crop(state, (0, 0, 0), origin, shape),
                             rows, keys, 6, 3, dtype=dtype, origin=origin,
                             L=L)
    at, n = reference.box_after(origin, shape, L, 3)
    assert tuple(part[0].shape[1:]) == n
    assert _equal(part, reference.crop(whole, (0, 0, 0), at, n))


@pytest.mark.parametrize("box", list(BOXES))
def test_box_initial_state_is_the_whole_grids(box):
    origin, shape = BOXES[box]
    whole = reference.initial_state(L, 2)
    part = reference.initial_state(L, 2, origin=origin, shape=shape)
    assert _equal(part, reference.crop(whole, (0, 0, 0), origin, shape))


def test_box_after_keeps_the_grids_edges():
    assert reference.box_after((0, 0, 0), (L, L, L), L, 5) == (
        (0, 0, 0), (L, L, L))
    assert reference.box_after((2, 0, 4), (8, 8, 12), L, 2) == (
        (4, 0, 6), (4, 6, 10))
    with pytest.raises(ValueError):
        reference.box_after((4, 4, 4), (4, 4, 4), L, 2)
