"""Reading a ``torch.profiler`` capture of the measured window.

The window is marked by a ``record_function`` range (:data:`WINDOW`);
everything is read between its start and end: the device's busy time
(the union of every device event), the stencil kernel's events (by
name), the device operations that took most time, and the longest idle
gaps, each named by the innermost host event that spans it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

#: The ``record_function`` range around the measured window.
WINDOW = "gsbench.window"
#: Part of the name of the program's stencil kernel.
KERNEL = "stencil_chain_kernel"
#: Entries kept in each list of the breakdown.
TOP = 10


def _union(intervals) -> List[List[int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _events(prof) -> Tuple[list, list]:
    """``(device, host)`` events as ``(name, start_ns, end_ns)``. A host
    range (``record_function``) is mirrored on the device's timeline as
    an annotation of the same name: that is no device work, and is left
    out of the device's events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        (dev if e.device_type() == cuda else host).append(span)
    ranges = {n for n, _, _ in host}
    return [d for d in dev if d[0] not in ranges], host


def short_name(name: str) -> str:
    """A kernel's name without its argument list."""
    cut = name.find(">(")
    return name[:cut + 1] if cut > 0 and name.endswith(")") else name


def summarize(prof) -> Optional[dict]:
    """The window's device numbers, or None when the capture holds no
    window range or no device event inside it."""
    dev, host = _events(prof)
    marks = [(a, b) for n, a, b in host if n == WINDOW]
    if not marks:
        return None
    w0, w1 = marks[0]
    dev = [(n, max(a, w0), min(b, w1)) for n, a, b in dev if b > w0 and a < w1]
    if not dev:
        return None
    busy = _union([(a, b) for _, a, b in dev])
    ops: Dict[str, int] = {}
    for n, a, b in dev:
        n = short_name(n)
        ops[n] = ops.get(n, 0) + (b - a)
    kernels = [(a, b) for n, a, b in dev if KERNEL in n]
    gaps = []
    prev = w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    inner = [(n, a, b) for n, a, b in host if n != WINDOW]
    named = []
    for a, b in gaps[:TOP]:
        mid = (a + b) // 2
        spans = [(bb - aa, n) for n, aa, bb in inner if aa <= mid <= bb]
        named.append([min(spans)[1] if spans else "host outside any op",
                      (b - a) / 1e9])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "kernel_events": len(kernels),
        "kernel_s": sum(b - a for a, b in kernels) / 1e9,
        "device_ops": [[n, t / 1e9] for n, t in
                       sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": named,
    }
