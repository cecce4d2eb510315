"""Build and load the package's CUDA kernels.

The stencil kernel is generated per model: ``ops/kernelgen.py`` emits
the model's reaction and counts, and :func:`emitted_source` writes them
into the template ``ops/csrc/stencil_chain.cu`` where its marker line
stands. Each emitted source is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. The emitted ``.cu`` and its
library go into ``ops/csrc/build/`` (listed in ``.gitignore``), side by
side, named by the model and a hash of the template, the emitted text
and the flags, at first use; a later call in any process reuses them. A
run's compile cache (``compile_cache`` / ``GS_COMPILE_CACHE``,
``config/settings.resolve_compile_cache``) takes the place of that
directory: ``Simulation`` points :data:`CACHE_DIR` at it
(:func:`use_cache_dir`). :func:`build_all` starts one ``nvcc`` per spec
at once.

Gray-Scott has a second library, built from the same emitted source
with ``GS_ENVELOPE_PROBES`` defined (:data:`PROBE_DEFINE`): it holds the
envelope probes' entry points (``ops/envelope.py``) in place of the
production ones, so the probes replay the production kernel's code
while the production library stays as it was; ``build_all(...,
envelope=True)`` compiles it beside the others.

Nothing here runs at import time, and nothing falls back: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")

#: The compile cache directory builds go into instead of
#: :data:`BUILD_DIR`, or None.
CACHE_DIR: Optional[str] = None

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

#: The first line of the envelope probes' source, and the model whose
#: kernel they take apart (as ``benchmarks/envelope_probe.py`` does).
PROBE_DEFINE = "#define GS_ENVELOPE_PROBES 1"
PROBE_MODEL = "grayscott"

#: Loaded libraries by (spec, envelope) (specs are memoized per model
#: object).
_LIBS: Dict[object, ctypes.CDLL] = {}

#: Serializes builds and loads in this process: threads that reach a
#: library's first use at once (the serve worker fleet on one card)
#: never run nvcc into one directory twice. Reentrant, for
#: :func:`load` over :func:`build_all`.
LOCK = threading.RLock()

#: Libraries this process compiled (nvcc runs that succeeded), by name.
BUILDS: Dict[str, int] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` could not build a kernel library (or is not there). The
    supervisor takes it as a ``kernel`` failure, which stops the run."""


def use_cache_dir(path: Optional[str]) -> None:
    """Build into and load from ``path`` (None: :data:`BUILD_DIR`) from
    now on, in this process. A library already loaded stays loaded."""
    global CACHE_DIR
    CACHE_DIR = path


def build_dir() -> str:
    """Where libraries are built and looked for."""
    return CACHE_DIR or BUILD_DIR


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
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels are compiled at first use"
    )


def _check_envelope(spec, envelope):
    """Only Gray-Scott has the envelope probes."""
    if envelope and spec.name != PROBE_MODEL:
        raise ValueError(
            f"the envelope probes take apart {PROBE_MODEL!r}'s kernel; "
            f"{spec.name!r} has none")


def emitted_source(spec, envelope: bool = False) -> str:
    """The full CUDA source of ``spec``'s kernel: the template with the
    generated part in place of its marker line; with ``envelope``, the
    same source under :data:`PROBE_DEFINE` (Gray-Scott only)."""
    _check_envelope(spec, envelope)
    with open(os.path.join(CSRC, TEMPLATE), encoding="utf-8") as f:
        template = f.read()
    if template.count(MARKER) != 1:
        raise RuntimeError(
            f"{TEMPLATE} must hold the marker line {MARKER!r} once")
    source = template.replace(MARKER, spec.cuda_source.rstrip("\n"))
    return f"{PROBE_DEFINE}\n{source}" if envelope else source


def target_name(spec, envelope: bool = False) -> str:
    """The library's name: the model's, ``_envelope`` for the probes."""
    return f"{spec.name}_envelope" if envelope else spec.name


def library_path(spec, envelope: bool = False) -> str:
    """Where the library of ``spec``'s kernel (or its envelope probes)
    is (or will be) built; the emitted source sits beside it with the
    suffix ``.cu``."""
    digest = hashlib.sha256(emitted_source(spec, envelope).encode())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(
        build_dir(),
        f"{target_name(spec, envelope)}.{digest.hexdigest()[:16]}.so")


def all_specs():
    """The spec of every registered model the generator accepts (looked
    up through the declaration protocol's registry, ``models.base``)."""
    from ..models.base import available_models, get_model
    from . import kernelgen

    models = [get_model(name) for name in available_models()]
    return [kernelgen.get_spec(m) for m in models
            if kernelgen.generation_gate_reason(m) is None]


def build_all(specs: Optional[Iterable] = None,
              envelope: bool = False) -> Dict[str, dict]:
    """Compile the kernels of ``specs`` (every registered model the
    generator accepts, by default) that are not built yet, and with
    ``envelope`` Gray-Scott's envelope probes too, one ``nvcc`` process
    per library, all started together.

    Returns ``{library name: {"path", "source", "seconds", "log"}}``
    (:func:`target_name`); ``log`` is nvcc's output (register and
    shared-memory use from ``-Xptxas=-v``), empty for a library that was
    already built. Raises on any failure, after every started process
    has ended. Threads of one process build one at a time
    (:data:`LOCK`); each compile counts in :data:`BUILDS`."""
    with LOCK:
        return _build_all(specs, envelope)


def _build_all(specs, envelope):
    targets = [(spec, False)
               for spec in (all_specs() if specs is None else specs)]
    if envelope:
        from ..models.base import get_model
        from . import kernelgen

        targets.append((kernelgen.get_spec(get_model(PROBE_MODEL)), True))
    os.makedirs(build_dir(), exist_ok=True)
    result: Dict[str, dict] = {}
    running = []
    nvcc = None
    for spec, probes in targets:
        name = target_name(spec, probes)
        path = library_path(spec, probes)
        source = path[:-len(".so")] + ".cu"
        if os.path.isfile(path):
            result[name] = {"path": path, "source": source,
                            "seconds": 0.0, "log": ""}
            continue
        # The source and the library are written under this process's
        # own names and renamed into place: processes that build at
        # once never read or truncate each other's files.
        mine = f"{path[:-len('.so')]}.{os.getpid()}.cu"
        with open(mine, "w", encoding="utf-8") as f:
            f.write(emitted_source(spec, probes))
        nvcc = nvcc or find_nvcc()
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, mine],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((name, path, source, mine, tmp, proc,
                        time.perf_counter()))
    failures = []
    for name, path, source, mine, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(
                f"{name}: nvcc exited {proc.returncode} on {mine}\n{log}")
            continue
        os.replace(mine, source)
        os.replace(tmp, path)
        BUILDS[name] = BUILDS.get(name, 0) + 1
        result[name] = {"path": path, "source": source, "seconds": seconds,
                        "log": log}
    if failures:
        raise KernelBuildError(
            "CUDA kernel build failed:\n" + "\n".join(failures))
    return result


def load(spec, envelope: bool = False) -> ctypes.CDLL:
    """The loaded library of ``spec``'s kernel (with ``envelope``, of
    its envelope probes), built first if needed."""
    lib = _LIBS.get((spec, envelope))
    if lib is not None:
        return lib
    with LOCK:
        lib = _LIBS.get((spec, envelope))
        if lib is None:
            if envelope:
                _check_envelope(spec, envelope)
                built = build_all([], envelope=True)
            else:
                built = build_all([spec])
            path = built[target_name(spec, envelope)]["path"]
            lib = _LIBS[spec, envelope] = ctypes.CDLL(path)
    return lib
