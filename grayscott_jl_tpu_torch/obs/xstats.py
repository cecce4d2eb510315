"""Build and launch analytics (counterpart of
``grayscott_jl_tpu/obs/xstats.py``).

The reference captures, per compiled step runner, XLA's side of the
story: cost and memory analyses, the HLO collective census, compile
seconds and the persistent cache's hit or miss. This package compiles no
XLA executables; what it builds and launches instead are

* **libraries**: the generated kernel library of the run's model
  (``ops/_build.build_all``, nvcc) and the native store engine
  (``io/native.py``, g++). One record per library the run builds or
  loads, at construction: ``compile_s`` (the compiler's seconds, 0 for
  a library already built), ``cache`` (``"miss"`` when this run built
  it, ``"hit"`` when it was found in the build directory, ``"unknown"``
  when that cannot be told) and, for a kernel library, ptxas's register
  and shared-memory lines (``-Xptxas=-v``);
* **kernel entries**: one record per (mode, entry point, members,
  depth, operand shape) the run launched, at the end of the run:
  ``memory`` (registers, local spill bytes, static and dynamic shared
  bytes, the instance's max threads per block, all from
  ``cudaFuncGetAttributes`` through the template's
  ``gs_kernel_attributes``, the dynamic bytes the ones the launch
  requests), ``occupancy`` (blocks per SM from
  ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and ``cost``: the
  bytes one launch must move and the float operations it does, with the
  least time they allow on the card (:func:`launch_cost`, the one
  reckoning the smoke's bounds come from too);
* **the exchange census** (:func:`collective_counts`): the ppermutes of
  one exchange round by mesh axis, and the point-to-point sends to other
  processes, for the schedule the run took.

Records land where the reference's do: ``sim.executables`` (the driver
writes the ``RunStats`` ``executables`` section from it with
:func:`summarize`), one ``executable`` event each, and the ``compiles``,
``compile_cache_hits`` / ``compile_cache_misses`` counters and the
``compile_s_last`` gauge (:func:`publish`). A kernel-entry record is an
executable of the reference's kind (one launched program) that compiled
nothing: its ``compile_s`` is 0 and it has no ``cache``.

Knob: ``GS_XSTATS`` / ``xstats`` (:func:`resolve_xstats`, default off),
armed implicitly whenever the compile cache (``compile_cache`` /
``GS_COMPILE_CACHE``) resolves to a directory, as in the reference.
Armed or not, the kernels, the launches and the stores are the same;
off costs one ``if`` per construction. Every query is best-effort: a
failed one leaves its key out of the record, never fails the run.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from ..config.settings import resolve_xstats

__all__ = [
    "F32_FLOPS_PER_S",
    "HBM_BYTES_PER_S",
    "bound_ms",
    "bound_of",
    "cache_listing",
    "capture",
    "capture_libraries",
    "capture_launches",
    "collective_counts",
    "face_mode_work",
    "launch_cost",
    "library_builds",
    "publish",
    "resolve_xstats",
    "summarize",
]

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and
#: non-tensor-core float32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

#: The template's kernel modes by the names the records use.
KERNELS = {"chain": "kBlock", "faces6": "kFaces6", "xchain": "kXChain",
           "xychain": "kXChain"}

#: Bytes a cell of each entry point's fields takes.
ITEMSIZE = {"f32": 4, "f64": 8, "bf16": 2, "f32_mid_bf16": 4}


def bound_ms(L, fuse, flops, itemsize=4, n_fields=2):
    """Least time (ms) of one launch advancing ``fuse`` steps on L^3:
    each field read once and written once, against ``flops`` float
    operations per cell and step (the generated program's count); and
    which of the two bounds it."""
    cells = L**3
    return bound_of(2 * n_fields * itemsize * cells, fuse * flops * cells)


def bound_of(bytes_moved, flops):
    """Least time (ms) for ``bytes_moved`` bytes and ``flops`` float32
    operations on the card, and which of the two bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def face_mode_work(mode, shape, fuse, flops, itemsize=4, n_fields=2):
    """Bytes one launch must move (each input read once, each output
    written once) and the float operations it does, for a face mode on
    a ``shape`` operand: the 6n faces are 1-thick planes; the x-chain's
    stage s computes (nx + 2 (fuse-1-s)) x-planes of the operand."""
    nx, ny, nz = shape
    vol = nx * ny * nz
    if mode == "faces6":
        face_cells = 2 * (ny * nz + nx * nz + nx * ny)
        moved = n_fields * (2 * vol + face_cells) * itemsize
        cells = vol
    else:
        moved = n_fields * ((nx + 2 * fuse) + nx) * ny * nz * itemsize
        cells = sum((nx + 2 * (fuse - 1 - s)) * ny * nz
                    for s in range(fuse))
    return moved, cells * flops


def launch_cost(mode, shape, fuse, flops, itemsize=4, n_fields=2,
                members=1) -> dict:
    """One launch's ``bytes`` and ``flops`` (``members`` members of a
    ``shape`` operand in ``mode`` at depth ``fuse``) and the least time
    they allow, ``bound_ms``, with ``bound_by``."""
    if mode == "chain":
        cells = shape[0] * shape[1] * shape[2]
        moved, ops = 2 * n_fields * itemsize * cells, fuse * flops * cells
    else:
        moved, ops = face_mode_work(mode, shape, fuse, flops, itemsize,
                                    n_fields)
    moved, ops = moved * members, ops * members
    ms, by = bound_of(moved, ops)
    return {"bytes": int(moved), "flops": int(ops), "bound_ms": ms,
            "bound_by": by}


def cache_listing(path: Optional[str]) -> Optional[frozenset]:
    """Entries of a build directory, or None when there is none or it
    is unreadable."""
    if not path:
        return None
    try:
        return frozenset(os.listdir(path))
    except OSError:
        return None


def capture(*, name: str, compile_s: float,
            cache_dir: Optional[str] = None,
            cache_before: Optional[frozenset] = None,
            extra: Optional[dict] = None) -> dict:
    """One build's record, as the reference's ``capture``: a build that
    added an entry to ``cache_dir`` was a miss, one that left it as it
    was a hit; ``"unknown"`` when either listing is missing."""
    rec = {"name": name, "compile_s": round(float(compile_s), 6)}
    if extra:
        rec.update(extra)
    if cache_dir is not None:
        after = cache_listing(cache_dir)
        if cache_before is None or after is None:
            rec["cache"] = "unknown"
        else:
            rec["cache"] = "miss" if after - cache_before else "hit"
    return rec


def publish(rec: dict, *, metrics=None, events=None) -> None:
    """Mirror one record into the metrics registry and the event stream
    (each a no-op when its sink is off), under the reference's names."""
    if events is not None:
        events.emit("executable", phase="compile", **rec)
    if metrics is None:
        return
    metrics.counter("compiles").inc()
    metrics.gauge("compile_s_last").set(rec.get("compile_s"))
    cache = rec.get("cache")
    if cache == "hit":
        metrics.counter("compile_cache_hits").inc()
    elif cache == "miss":
        metrics.counter("compile_cache_misses").inc()


def summarize(records) -> dict:
    """The header of the ``RunStats`` ``executables`` section."""
    records = list(records)
    cache = [r.get("cache") for r in records]
    return {
        "compiles": len(records),
        "compile_s_total": round(
            sum(r.get("compile_s", 0.0) for r in records), 6),
        "compile_cache_hits": cache.count("hit"),
        "compile_cache_misses": cache.count("miss"),
    }


def _ptxas_lines(log: str) -> List[str]:
    """ptxas's register, spill and shared-memory lines of an nvcc log."""
    return [line.strip() for line in (log or "").splitlines()
            if "registers" in line or "spill" in line
            or "smem" in line or "Compiling" in line]


def library_builds(sim) -> List[tuple]:
    """The libraries ``sim``'s run builds or loads, as ``(name, build,
    cache_dir, extra)``: ``build()`` builds the library if it is not
    there and returns ``{"seconds", "log"}``. The kernel library of the
    run's model on the kernel path on the card, and the native store
    engine unless ``GS_TPU_NATIVE_IO=0``. The seam through which the
    tests inject a build."""
    from ..config.env import env_str

    out = []
    if sim.kernel_language == "cuda" and sim.device.type == "cuda":
        from ..ops import _build, kernelgen

        spec = kernelgen.get_spec(sim.model)

        def build_kernels():
            info = _build.build_all([spec])[_build.target_name(spec)]
            return {"seconds": info["seconds"], "log": info["log"]}

        out.append((_build.target_name(spec), build_kernels,
                    _build.build_dir(), {"record": "library",
                                         "compiler": "nvcc"}))
    if env_str("GS_TPU_NATIVE_IO", "1") != "0":
        from ..io import native

        def build_native():
            t0 = time.perf_counter()
            existed = os.path.isfile(native.library_path())
            native.build()
            return {"seconds": 0.0 if existed
                    else time.perf_counter() - t0, "log": ""}

        out.append(("libbplite", build_native,
                    os.path.dirname(native.library_path()),
                    {"record": "library", "compiler": "g++"}))
    return out


def capture_libraries(sim) -> None:
    """Build (or find) each library of ``sim``'s run, append its record
    to ``sim.executables`` and publish it. A failed build is recorded
    with its error and ``cache`` ``"unknown"``; the run goes on to meet
    the failure where it would have without analytics."""
    from .events import get_events
    from .metrics import get_metrics

    for name, build, cache_dir, extra in library_builds(sim):
        # A directory this build makes starts empty.
        before = (cache_listing(cache_dir) if os.path.isdir(cache_dir)
                  else frozenset())
        error = None
        try:
            info = build()
        except Exception as e:  # noqa: BLE001 — analytics never fail a run
            info, error = {"seconds": 0.0, "log": ""}, f"{type(e).__name__}: {e}"
        rec = capture(name=name, compile_s=info["seconds"],
                      cache_dir=cache_dir, cache_before=before,
                      extra={**extra, "model": sim.model.name})
        lines = _ptxas_lines(info.get("log", ""))
        if lines:
            rec["ptxas"] = lines
        if error is not None:
            rec["cache"] = "unknown"
            rec["error"] = error
        sim.executables.append(rec)
        publish(rec, metrics=get_metrics(), events=get_events())


def launch_record(spec, key: tuple, launches: int, device=None) -> dict:
    """The record of one kernel entry (a key of
    ``cuda_stencil.ENTRY_LAUNCHES``) launched ``launches`` times: its
    attributes on the card and its cost per launch."""
    from ..ops import cuda_stencil

    model, mode, entry, members, fuse, shape, band = key
    name = f"{KERNELS[mode]}[{entry}]" + (f"x{members}" if members > 1
                                          else "")
    rec = {"name": name, "compile_s": 0.0, "record": "launch",
           "model": model, "mode": mode, "entry": entry,
           "members": members, "fuse": fuse, "shape": list(shape),
           "band": band, "launches": launches}
    try:
        attrs = cuda_stencil.kernel_attributes(spec, mode, entry, fuse,
                                               device=device)
        rec["memory"] = {k: attrs[k] for k in (
            "registers", "local_bytes", "static_shared_bytes",
            "dynamic_shared_bytes", "max_threads_per_block")}
        rec["occupancy"] = {"blocks_per_sm": attrs["blocks_per_sm"],
                            "threads_per_block": attrs["threads_per_block"]}
    except Exception as e:  # noqa: BLE001 — analytics never fail a run
        rec["error"] = f"{type(e).__name__}: {e}"
    rec["cost"] = launch_cost(mode, shape, fuse, spec.flops_per_cell_step(),
                              ITEMSIZE[entry], spec.n_fields, members)
    return rec


def capture_launches(sim, before: Dict[tuple, int]) -> None:
    """One record per kernel entry launched since ``before`` (a copy of
    ``cuda_stencil.ENTRY_LAUNCHES``) for ``sim``'s model, appended to
    ``sim.executables`` and published."""
    from ..ops import cuda_stencil, kernelgen
    from .events import get_events
    from .metrics import get_metrics

    spec = kernelgen.get_spec(sim.model)
    for key, n in sorted(cuda_stencil.ENTRY_LAUNCHES.items(),
                         key=lambda kv: repr(kv[0])):
        n -= before.get(key, 0)
        if n <= 0 or key[0] != sim.model.name:
            continue
        rec = launch_record(spec, key, n, device=sim.device)
        sim.executables.append(rec)
        publish(rec, metrics=get_metrics(), events=get_events())


def collective_counts(sim) -> dict:
    """The exchange census of ``sim``'s schedule: ppermute calls per
    exchange round, by mesh axis (``"x"``, ``"y"``, ``"z"``) and in all
    (``"ppermute"``), and the point-to-point sends to other processes
    per round (``"p2p_sends"``); ``rounds`` is the rounds they were
    counted over. The reference's census counts the collective-permute
    ops of its compiled round instead: one op per call here."""
    calls = sim.mesh.census()
    rounds = max(int(sim.exchange_rounds), 1)
    out = {axis: calls[i] / rounds
           for i, axis in enumerate("xyz") if calls[i]}
    out["ppermute"] = sum(calls[:3]) / rounds
    if calls[3]:
        out["p2p_sends"] = calls[3] / rounds
    out["rounds"] = int(sim.exchange_rounds)
    return {k: (int(v) if isinstance(v, float) and v.is_integer() else v)
            for k, v in out.items()}

