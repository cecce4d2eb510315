"""Build and load the package's CUDA kernels.

The stencil kernel is generated per model: ``ops/kernelgen.py`` emits
the model's reaction and counts, and :func:`emitted_source` writes them
into the template ``ops/csrc/stencil_chain.cu`` where its marker line
stands. Each emitted source is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. The emitted ``.cu`` and its
library go into ``ops/csrc/build/`` (listed in ``.gitignore``), side by
side, named by the model and a hash of the template, the emitted text
and the flags, at first use; a later call in any process reuses them.
:func:`build_all` starts one ``nvcc`` per spec at once.

Nothing here runs at import time, and nothing falls back: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")

#: The kernel template and the line the generated part replaces.
TEMPLATE = "stencil_chain.cu"
MARKER = "// @generated-reaction@"

#: ``--fmad=false`` keeps every product and sum separately rounded, the
#: condition for bitwise agreement with the plain torch versions.
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

#: Loaded libraries by spec (specs are memoized per model object).
_LIBS: Dict[object, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``; raises when there is none."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels are compiled at first use"
    )


def emitted_source(spec) -> str:
    """The full CUDA source of ``spec``'s kernel: the template with the
    generated part in place of its marker line."""
    with open(os.path.join(CSRC, TEMPLATE), encoding="utf-8") as f:
        template = f.read()
    if template.count(MARKER) != 1:
        raise RuntimeError(
            f"{TEMPLATE} must hold the marker line {MARKER!r} once")
    return template.replace(MARKER, spec.cuda_source.rstrip("\n"))


def library_path(spec) -> str:
    """Where the library of ``spec``'s kernel is (or will be) built; the
    emitted source sits beside it with the suffix ``.cu``."""
    digest = hashlib.sha256(emitted_source(spec).encode())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{spec.name}.{digest.hexdigest()[:16]}.so")


def all_specs():
    """The spec of every registered model the generator accepts."""
    from ..models import available_models, get_model
    from . import kernelgen

    models = [get_model(name) for name in available_models()]
    return [kernelgen.get_spec(m) for m in models
            if kernelgen.generation_gate_reason(m) is None]


def build_all(specs: Optional[Iterable] = None) -> Dict[str, dict]:
    """Compile the kernels of ``specs`` (every registered model the
    generator accepts, by default) that are not built yet, one ``nvcc``
    process per spec, all started together.

    Returns ``{model name: {"path", "source", "seconds", "log"}}``;
    ``log`` is nvcc's output (register and shared-memory use from
    ``-Xptxas=-v``), empty for a library that was already built. Raises
    on any failure, after every started process has ended."""
    specs = list(all_specs() if specs is None else specs)
    os.makedirs(BUILD_DIR, exist_ok=True)
    result: Dict[str, dict] = {}
    running = []
    nvcc = None
    for spec in specs:
        path = library_path(spec)
        source = path[:-len(".so")] + ".cu"
        if os.path.isfile(path):
            result[spec.name] = {"path": path, "source": source,
                                 "seconds": 0.0, "log": ""}
            continue
        with open(source, "w", encoding="utf-8") as f:
            f.write(emitted_source(spec))
        nvcc = nvcc or find_nvcc()
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((spec.name, path, source, tmp, proc,
                        time.perf_counter()))
    failures = []
    for name, path, source, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(
                f"{name}: nvcc exited {proc.returncode} on {source}\n{log}")
            continue
        os.replace(tmp, path)
        result[name] = {"path": path, "source": source, "seconds": seconds,
                        "log": log}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return result


def load(spec) -> ctypes.CDLL:
    """The loaded library of ``spec``'s kernel, built first if needed."""
    lib = _LIBS.get(spec)
    if lib is None:
        lib = _LIBS[spec] = ctypes.CDLL(build_all([spec])[spec.name]["path"])
    return lib
