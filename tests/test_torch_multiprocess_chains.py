"""The kernel path's exchange schedules across the process boundary on
the CPU (grayscott_jl_tpu_torch/parallel/mesh.py's point-to-point
ppermute under halo.py and temporal.py): two processes on gloo, four
blocks each, against the one-process run of the same mesh, bitwise.

The cases are the reference's chain cases: the 6n-face round at
``GS_FUSE=1`` on (2,2,2), the x-chain at ``GS_FUSE=2`` on (8,1,1), the
xy-chain at ``GS_FUSE=3`` on (4,2,1) and, with z sharded, at
``GS_FUSE=2`` on (2,2,2) (its corner-propagated frame), each with
``comm_overlap`` "auto" (the split rounds: the exchange started, the
interior on frozen faces, the bands recomputed from what arrived) and
"off" (the fused round). L=32 gives the x-chain and the slab form of
the xy-chain blocks deep enough to split (2k planes); L=16 as in
tests/test_torch_multiprocess.py otherwise."""

import json

import pytest

from test_torch_multiprocess import (assert_stores_bitwise, run_pair,
                                     run_single, write_config)

CASES = [
    # dims, GS_FUSE, comm_overlap, L, split expected
    ("2,2,2", "1", "auto", 16, False),
    ("2,2,2", "2", "auto", 16, True),
    ("8,1,1", "2", "auto", 32, True),
    ("8,1,1", "2", "off", 32, False),
    ("4,2,1", "3", "auto", 32, True),
    ("4,2,1", "3", "off", 32, False),
]


@pytest.mark.parametrize("dims,fuse,overlap,L,split", CASES)
def test_chain_across_processes_equals_one_process(tmp_path, monkeypatch,
                                                   dims, fuse, overlap, L,
                                                   split):
    env = {"GS_TPU_MESH_DIMS": dims, "GS_FUSE": fuse,
           "GS_COMM_OVERLAP": overlap}
    kw = dict(L=L, kernel_language="Pallas", checkpoint=False)
    pair = tmp_path / "pair"
    run_pair(pair, write_config(pair, **kw),
             extra=dict(env, GS_TPU_STATS=str(pair / "stats.json")))
    one = tmp_path / "one"
    sim = run_single(monkeypatch, one, write_config(one, **kw), extra=env)
    assert sim.domain.dims == tuple(int(d) for d in dims.split(","))
    assert sim.overlap_applied == split
    assert_stores_bitwise(str(one / "out.bp"), str(pair / "out.bp"),
                          ("U", "V"))
    for rank in range(2):
        stats = json.loads((pair / f"stats.json.rank{rank}").read_text())
        cfg = stats["config"]
        assert cfg["overlap_applied"] == split
        assert cfg["fuse"] == int(fuse) and cfg["kernel_language"] == "cuda"
        assert cfg["p2p"]["calls"] > 0 and cfg["p2p"]["bytes"] > 0
