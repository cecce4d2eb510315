"""Time the stencil kernel of two or more package trees in one run, in
turns.

    python -m grayscott_jl_tpu_torch.probes.kernel_ab [--out F.jsonl]
        TREE [TREE ...]

A change to ``ops/csrc/stencil_chain.cu`` is judged against its parent
on the same card in the same run: the card's clock and power state move
between runs. Each TREE is a directory holding a copy of the package
``grayscott_jl_tpu_torch`` (for example ``git archive`` of the parent
commit, unpacked into a git-ignored directory). The trees run one
process each, in the order given and then reversed (a b ... b a). Each
process builds Gray-Scott's kernel and envelope probes from its own
tree and times, on inputs made from fixed seeds with noise 0.1:

  chain_<dtype>   the chain at L=256, depth 1 (float32 and bfloat16;
                  PERF.md's rows 1a and 1f.1);
  chain_n5_float32  the same, five members in one batched launch (1a);
  chain_<model>   Brusselator, FHN and heat at L=256, depth 1, float32
                  (1g.1-1g.3);
  chain2_<dtype>  the chain at L=256, depth 2 (1b);
  faces6_<dtype>  the 6n-face step at (128,128,128) (1c, 1f.2);
  xchain_<dtype>  the x-chain at (32,256,256), depth 2 (1d, 1f.3);
  xychain_float32 the x-chain on the xy-chain's (128,132,128) operand,
                  depth 2 (1e);
  copy_walk, compute_walk  the envelope probes at L=256, depth 1 (rows
                  2 and 3; they take apart the window kernel);

each as the profiler's device time per launch (the mean of 50) and the
CUDA-event ms per call (the mean of 200), after warm-up. Prints the
``nvidia-smi`` name and power limit, one JSON line per process
(``tree``, ``registers``: ptxas's register lines, ``attributes``: the
card's attributes of the instance each of the float32 and bf16 depth-1
chain, the depth-2 chain, the 6n-face step and the x-chain launches
(``cuda_stencil.kernel_attributes``), ``schedules``: the tree's
``SCHEDULE_LAUNCHES`` after the cases, where it has them, ``cases``:
``{case: {"device_ms", "ms"}}``) and a last line ``{"summary": {tree:
{case: {"device_ms", "ms"}}}}``, each the mean over that tree's two
runs; ``--out`` appends the same lines. Needs a card: exits 2 without
one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: The package a tree must hold.
PACKAGE = "grayscott_jl_tpu_torch"

#: The other generated models, timed at depth 1 with these physics.
OTHER_MODELS = {
    "brusselator": dict(model_params={"A": 1.0, "B": 3.0, "Du": 0.2,
                                      "Dv": 0.02}, dt=0.05),
    "fhn": dict(model_params={"a": 0.7, "b": 0.8, "eps": 0.08, "I": 0.5,
                              "Dv": 0.2, "Dw": 0.0}, dt=0.05),
    "heat": dict(model_params={"D": 0.2}, dt=0.05),
}

#: Device-time launches and event-timed calls per case.
PROFILE_REPS = 50
EVENT_REPS = 200


def _device_ms(torch, fn):
    """Mean device time per stencil-kernel launch of ``fn`` under the
    profiler, after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_REPS):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "stencil_chain_kernel" in e.name]
    return sum(times) / len(times) if times else None


def _event_ms(torch, fn):
    """Mean CUDA-event ms per call of ``fn``, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(EVENT_REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / EVENT_REPS


def child(tree: str) -> dict:
    """Build and time the kernel of the package in ``tree`` (this
    process imports it from there)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    pkg = __import__(PACKAGE)
    where = os.path.dirname(os.path.abspath(pkg.__file__))
    if os.path.dirname(where) != os.path.abspath(tree):
        raise RuntimeError(f"imported {where}, not the tree {tree}")
    from grayscott_jl_tpu_torch.models import get_model
    from grayscott_jl_tpu_torch.ops import (_build, cuda_stencil, envelope,
                                            kernelgen)

    spec = kernelgen.get_spec(get_model("grayscott"))
    others = {name: kernelgen.get_spec(get_model(name))
              for name in OTHER_MODELS}
    built = _build.build_all([spec, *others.values()], envelope=True)
    registers = [line.strip() for info in built.values()
                 for line in info["log"].splitlines() if "registers" in line]
    cases = {}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        params = spec.model.make_params(
            pkg.Settings(noise=0.1, F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0),
            dtype, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(9)

        def rand(shape):
            return torch.rand(shape, generator=gen, device="cuda").to(dtype)

        chain = (rand((256,) * 3), rand((256,) * 3))
        block = (rand((128,) * 3), rand((128,) * 3))
        faces = tuple(rand(s) for s in [(1, 128, 128)] * 4
                      + [(128, 1, 128)] * 4 + [(128, 128, 1)] * 4)
        slab = (rand((32, 256, 256)), rand((32, 256, 256)))
        slabs = tuple(rand((2, 256, 256)) for _ in range(4))
        ext = (rand((128, 132, 128)), rand((128, 132, 128)))
        ext_slabs = tuple(rand((2, 132, 128)) for _ in range(4))
        runs = {
            f"chain_{dname}": lambda: cuda_stencil.fused_step(
                chain, params, (0, 3, 0), spec=spec, row=256),
            f"chain2_{dname}": lambda: cuda_stencil.fused_step(
                chain, params, (0, 3, 0), spec=spec, fuse=2, row=256),
            f"faces6_{dname}": lambda: cuda_stencil.fused_step(
                block, params, (0, 3, 0), faces, spec=spec,
                offsets=(128, 128, 128), row=256),
            f"xchain_{dname}": lambda: cuda_stencil.fused_step(
                slab, params, (0, 3, 0), slabs, spec=spec, fuse=2,
                offsets=(32, 0, 0), row=256),
        }
        if dname == "float32":
            members = tuple(rand((5, 256, 256, 256)) for _ in range(2))
            rows = [dict(Du=0.2, Dv=0.1, F=0.02 + 0.005 * m, k=0.048,
                         dt=1.0, noise=0.1) for m in range(5)]
            mparams = cuda_stencil.member_params(
                rows, spec.model.params_cls, dtype, "cuda")
            seeds = cuda_stencil.member_seeds(
                [(0, 3 + m) for m in range(5)], 0)
            runs["chain_n5_float32"] = lambda: cuda_stencil.fused_step(
                members, mparams, seeds, spec=spec, row=256)
            runs["xychain_float32"] = lambda: cuda_stencil.fused_step(
                ext, params, (0, 3, 0), ext_slabs, spec=spec, fuse=2,
                offsets=(128, -2, 0), row=256, y_halo=2)
            for name, other in others.items():
                oparams = other.model.make_params(
                    pkg.Settings(noise=0.1, model=name,
                                 **OTHER_MODELS[name]), dtype, "cuda")
                ofields = tuple(rand((256,) * 3)
                                for _ in range(other.n_fields))
                runs[f"chain_{name}"] = (
                    lambda o=other, p=oparams, f=ofields:
                    cuda_stencil.fused_step(f, p, (0, 3, 0), spec=o,
                                            row=256))
        for case, fn in runs.items():
            cases[case] = {"device_ms": _device_ms(torch, fn),
                           "ms": _event_ms(torch, fn)}
    gen = torch.Generator(device="cuda").manual_seed(10)
    fields = tuple(torch.rand((256,) * 3, generator=gen, device="cuda")
                   for _ in range(2))
    walk_params = spec.model.make_params(
        pkg.Settings(noise=0.1, F=0.02, k=0.048, Du=0.2, Dv=0.1, dt=1.0),
        torch.float32, "cuda")

    def walk():
        return envelope.copy_walk(fields, fuse=1)

    def compute():
        return envelope.compute_walk(fields, walk_params, (0, 3, 0),
                                     spec=spec, fuse=1, use_noise=True)

    for case, fn in (("copy_walk", walk), ("compute_walk", compute)):
        cases[case] = {"device_ms": _device_ms(torch, fn),
                       "ms": _event_ms(torch, fn)}
    attributes = {
        f"{mode}_{entry}_k{fuse}": cuda_stencil.kernel_attributes(
            spec, mode, entry, fuse)
        for mode, entry, fuse in (("chain", "f32", 1), ("chain", "bf16", 1),
                                  ("chain", "f32", 2), ("faces6", "f32", 1),
                                  ("xchain", "f32", 2))}
    schedules = getattr(cuda_stencil, "SCHEDULE_LAUNCHES", None)
    return {"tree": tree, "registers": registers, "attributes": attributes,
            "schedules": None if schedules is None else dict(schedules),
            "cases": cases}


def summarize(rows):
    """Per tree, per case, the mean of each time over the tree's runs."""
    out = {}
    for row in rows:
        for case, t in row["cases"].items():
            acc = out.setdefault(row["tree"], {}).setdefault(case, {})
            for key, v in t.items():
                acc.setdefault(key, []).append(v)
    return {tree: {case: {k: (None if None in v else sum(v) / len(v))
                          for k, v in t.items()}
                   for case, t in cases.items()}
            for tree, cases in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m grayscott_jl_tpu_torch.probes.kernel_ab",
        description="Time the stencil kernel of package trees in turns.")
    ap.add_argument("trees", nargs="+",
                    help=f"directories that each hold {PACKAGE}/")
    ap.add_argument("--out", default=None,
                    help="append the JSON lines to this file")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.trees[0])), flush=True)
        return 0
    for tree in args.trees:
        if not os.path.isfile(os.path.join(tree, PACKAGE, "__init__.py")):
            ap.error(f"{tree} holds no {PACKAGE}/ package")
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    lines = [smi]
    rows = []
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for tree in args.trees + args.trees[::-1]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree],
            capture_output=True, text=True, env=env, check=False)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        lines.append(json.dumps(rows[-1]))
    lines.append(json.dumps({"summary": summarize(rows)}))
    for line in lines:
        print(line, flush=True)
    if args.out:
        with open(args.out, "a", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
