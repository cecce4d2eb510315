"""One process of a CPU cell of several processes, started in place of
``python -m gsbench.run`` with a patch named by ``GSBENCH_TEST_PATCH``
applied first (``support.patch_children``):

- ``fault:face``, ``fault:edge``, ``fault:corner``: process 1 adds 0.05
  to one ``u`` cell of its block after each call of the simulation's
  ``iterate``, on a face, an edge or a corner of the block where it
  meets another process's block;
- ``wrong-neighbour``: every process fills one margin of process 0's
  grown block from a process that does not hold those cells, at the
  same place in its own block;
- ``entries``: each ``iterate`` call counts one kernel launch per round
  of the simulation's chain depth, under the entry point the card's
  kernel path would take in this environment (``f32_mid_bf16`` under
  ``GS_MID_BF16=1``, else ``f32``): the plain path counts none.
"""

import os
import runpy
import sys

# This file's directory is no package root of the run's tree.
sys.path.pop(0)
PATCH = os.environ.get("GSBENCH_TEST_PATCH", "")


def fault(where: str) -> None:
    from grayscott_jl_tpu_torch.simulation import Simulation

    orig = Simulation.iterate

    def iterate(self, nsteps=1):
        orig(self, nsteps)
        u = self.blocks[0][0]
        (ox, oy, _), (nx, ny, nz) = self.offsets[0], u.shape[-3:]
        x = 0 if ox else nx - 1
        y = 0 if oy else ny - 1
        cell = {"face": (x, ny // 2, nz // 2), "edge": (x, y, nz // 2),
                "corner": (x, y, 0)}[where]
        u[(Ellipsis,) + cell] += 0.05

    Simulation.iterate = iterate


def wrong_neighbour() -> None:
    from gsbench import harness

    orig = harness.margin_plan

    def margin_plan(boxes, margin, L):
        plan = orig(boxes, margin, L)
        for j, (src, si, dst, di, sbox, dbox) in enumerate(plan):
            if dst == 0 and src != 0:
                other = next(r for r, _, _, _ in boxes if r not in (0, src))
                plan[j] = (other, 0, dst, di, sbox, dbox)
                break
        return plan

    harness.margin_plan = margin_plan


def entries() -> None:
    import torch

    from grayscott_jl_tpu_torch.ops import cuda_stencil as cs
    from grayscott_jl_tpu_torch.simulation import Simulation

    orig = Simulation.iterate

    def iterate(self, nsteps=1):
        orig(self, nsteps)
        entry = ("f32_mid_bf16" if cs.mid_bf16_requested(torch.float32)
                 else "f32")
        for _ in range(nsteps // int(self.fuse)):
            cs.count_launch("chain", "tma", entry=entry, model="grayscott",
                            members=1, fuse=int(self.fuse),
                            shape=tuple(self.domain.local_shape))

    Simulation.iterate = iterate


if PATCH.startswith("fault:"):
    if os.environ.get("GS_TPU_PROCESS_ID") == "1":
        fault(PATCH.split(":", 1)[1])
elif PATCH == "wrong-neighbour":
    wrong_neighbour()
elif PATCH == "entries":
    entries()
elif PATCH:
    raise SystemExit(f"unknown GSBENCH_TEST_PATCH {PATCH!r}")
runpy.run_module("gsbench.run", run_name="__main__", alter_sys=True)
