"""The native C++ BP-lite writer engine (counterpart of
``grayscott_jl_tpu/io/native.py``), bound with ctypes.

The same on-disk format as the Python engine (``io/bplite.py``), with a
pipeline of its own: ``end_step`` returns once the step's blocks are
staged in C++, and the library's I/O thread writes, fsyncs and
publishes the metadata while Python goes on; ``drain()``/``close()``
wait until everything queued is durable. The CRC ledger of each block
is kept on the Python side from the offset the staging returns, so the
integrity sidecar is the Python engine's byte for byte.

The source, ``io/csrc/bplite.cpp``, is a byte-identical copy of the
reference's ``csrc/bplite.cpp``. It is host code: :func:`load_library`
compiles it with ``g++`` at first use into ``io/csrc/build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, and a
later call in any process reuses it. When there is no ``g++`` or the
build fails, :func:`available` is False, :data:`BUILD_ERROR` says why,
and ``open_writer`` takes the Python engine, as the reference does when
its library is not built. A run's compile cache (``compile_cache`` /
``GS_COMPILE_CACHE``) takes the place of the build directory
(:func:`use_cache_dir`, set by ``Simulation``).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
from typing import Any, Optional, Sequence

import numpy as np

from . import bplite as _py

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCE = os.path.join(CSRC, "bplite.cpp")
BUILD_DIR = os.path.join(CSRC, "build")

#: The reference's ``csrc/Makefile`` flags.
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
             "-pthread")

#: The compile cache directory the library is built into instead of
#: :data:`BUILD_DIR`, or None.
CACHE_DIR: Optional[str] = None

#: The C ABI version the binding expects (``bpw_abi_version``).
ABI_VERSION = 2

_lib = None

#: Why the library is not available (None once it loaded).
BUILD_ERROR: Optional[str] = None


def use_cache_dir(path: Optional[str]) -> None:
    """Build into and load from ``path`` (None: :data:`BUILD_DIR`) from
    now on, in this process. A library already loaded stays loaded."""
    global CACHE_DIR
    CACHE_DIR = path


def library_path() -> str:
    """Where the library is (or will be) built."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(CACHE_DIR or BUILD_DIR,
                        f"libbplite.{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if it is not built yet; returns its path.
    Raises when there is no ``g++`` or it fails."""
    path = library_path()
    if os.path.isfile(path):
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native BP-lite engine is "
                           "compiled at first use")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} exited {proc.returncode} on {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def load_library():
    """The loaded library, built first if needed, or None when it
    cannot be built or loaded (or reports another ABI)."""
    global _lib, BUILD_ERROR
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(build())
        lib.bpw_abi_version.restype = ctypes.c_int
        if lib.bpw_abi_version() != ABI_VERSION:
            raise RuntimeError(
                f"libbplite reports ABI {lib.bpw_abi_version()}, the "
                f"binding expects {ABI_VERSION}")
    except (OSError, RuntimeError, AttributeError) as e:
        BUILD_ERROR = f"{type(e).__name__}: {e}"
        return None
    lib.bpw_open.restype = ctypes.c_void_p
    lib.bpw_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.bpw_define_attribute_json.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.bpw_define_variable.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
    ]
    lib.bpw_set_prior_steps_json.argtypes = [ctypes.c_void_p,
                                             ctypes.c_char_p]
    lib.bpw_publish.argtypes = [ctypes.c_void_p]
    lib.bpw_begin_step.argtypes = [ctypes.c_void_p]
    lib.bpw_begin_step.restype = ctypes.c_int
    lib.bpw_put.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
    ]
    lib.bpw_put.restype = ctypes.c_int64
    lib.bpw_end_step.argtypes = [ctypes.c_void_p]
    lib.bpw_end_step.restype = ctypes.c_int
    lib.bpw_drain.argtypes = [ctypes.c_void_p]
    lib.bpw_drain.restype = ctypes.c_int
    lib.bpw_close.argtypes = [ctypes.c_void_p]
    lib.bpw_close.restype = ctypes.c_int
    _lib = lib
    BUILD_ERROR = None
    return lib


def available() -> bool:
    return load_library() is not None


def _i64(seq: Sequence[int]):
    return (ctypes.c_int64 * len(seq))(*[int(s) for s in seq])


class NativeBpWriter:
    """The interface of :class:`~.bplite.BpWriter`, on the C++ engine."""

    engine = "native"

    def __init__(
        self,
        path: str,
        *,
        writer_id: int = 0,
        nwriters: int = 1,
        append: bool = False,
        keep_steps: Optional[int] = None,
    ):
        lib = load_library()
        if lib is None:
            raise RuntimeError(
                f"the native BP-lite engine is not available ({BUILD_ERROR}); "
                "use the Python engine")
        self._lib = lib
        self.path = path
        self.writer_id = writer_id
        self.nwriters = nwriters
        if not 0 <= writer_id < nwriters:
            raise ValueError(f"writer_id {writer_id} not in [0, {nwriters})")
        md_name = "md.json" if writer_id == 0 else f"md.{writer_id}.json"
        #: name -> (dtype name, shape), for checks and conversions.
        self._vars = {}
        self._integrity = _py.IntegrityMeta(path, writer_id)
        self._n_steps = 0
        prior = None
        if append and os.path.exists(os.path.join(path, md_name)):
            with open(os.path.join(path, md_name), "r", encoding="utf-8") as f:
                prior = json.load(f)
            for name, v in prior.get("variables", {}).items():
                self._vars[name] = (v["dtype"], tuple(v["shape"]))
            # Cut the payload to the end of the kept steps before the
            # native open, which takes the file size as its append
            # offset: rolled-back entries and torn tails leave the
            # bytes, as in the Python engine.
            data_name = f"data.{writer_id}"
            kept = prior.get("steps", [])
            if keep_steps is not None:
                kept = kept[:keep_steps]
            cut = _py.data_end_offset(
                {"variables": prior.get("variables", {}), "steps": kept},
                data_name,
            )
            data_path = os.path.join(path, data_name)
            if (cut is not None and os.path.exists(data_path)
                    and cut < os.path.getsize(data_path)):
                os.truncate(data_path, cut)
            self._integrity.load()
            self._integrity.prune(data_name, cut, len(kept))
            self._n_steps = len(kept)
        self._h = lib.bpw_open(path.encode(), writer_id, nwriters,
                               1 if append else 0)
        if not self._h:
            raise IOError(f"Cannot open BP-lite store at {path}")
        if prior is None:
            # A fresh store: drop a previous run's integrity and
            # quarantine markers at this path, as the Python engine does.
            self._integrity.remove()
            if writer_id == 0:
                try:
                    os.remove(os.path.join(path, "quarantine.json"))
                except OSError:
                    pass
        else:
            # Forward all prior state before the one publish: a reader
            # must never see steps without their variables.
            prior_steps = prior.get("steps", [])
            if keep_steps is not None:
                prior_steps = prior_steps[:keep_steps]
            steps_json = ", ".join(json.dumps(s) for s in prior_steps)
            lib.bpw_set_prior_steps_json(self._h, steps_json.encode())
            for name, (dtype, shape) in self._vars.items():
                lib.bpw_define_variable(self._h, name.encode(),
                                        dtype.encode(), _i64(shape),
                                        len(shape))
            for name, val in prior.get("attributes", {}).items():
                lib.bpw_define_attribute_json(self._h, name.encode(),
                                              json.dumps(val).encode())
            lib.bpw_publish(self._h)
        self._in_step = False

    def _handle(self):
        if not self._h:
            raise RuntimeError("writer is closed")
        return self._h

    def define_attribute(self, name: str, value: Any) -> None:
        self._handle()
        # The Python engine's typing rules give the attribute's JSON.
        probe = _py.BpWriter.__new__(_py.BpWriter)
        probe._md = {"attributes": {}}
        _py.BpWriter.define_attribute(probe, name, value)
        encoded = json.dumps(probe._md["attributes"][name])
        self._lib.bpw_define_attribute_json(self._h, name.encode(),
                                            encoded.encode())

    def define_variable(self, name: str, dtype,
                        shape: Sequence[int] = ()) -> None:
        """As :meth:`~.bplite.BpWriter.define_variable` (``"bfloat16"``
        for bf16)."""
        self._handle()
        dtype_name = _py.dtype_name(dtype)
        self._vars[name] = (dtype_name, tuple(int(s) for s in shape))
        self._lib.bpw_define_variable(self._h, name.encode(),
                                      dtype_name.encode(), _i64(shape),
                                      len(shape))

    def begin_step(self) -> None:
        if self._lib.bpw_begin_step(self._handle()) != 0:
            raise RuntimeError("begin_step called inside an open step")
        self._in_step = True

    def put(
        self,
        name: str,
        value,
        *,
        start: Optional[Sequence[int]] = None,
        count: Optional[Sequence[int]] = None,
    ) -> None:
        """As :meth:`~.bplite.BpWriter.put`: the block is staged in C++
        from the array's memory (one copy) and its CRC taken from a byte
        view of it."""
        if not self._in_step:
            raise RuntimeError("put called outside begin_step/end_step")
        if name not in self._vars:
            raise KeyError(f"Variable {name!r} not defined")
        dtype_name, shape = self._vars[name]
        if dtype_name == _py.BF16:
            arr = _py.bf16_bits(value)
        else:
            arr = np.asarray(value, dtype=dtype_name)
        arr = arr.reshape(()) if not shape else np.ascontiguousarray(arr)
        if start is None:
            start = [0] * len(shape)
        if count is None:
            count = list(shape)
        if list(arr.shape) != [int(c) for c in count]:
            raise ValueError(
                f"{name!r}: data shape {arr.shape} != count {tuple(count)}"
            )
        rc = self._lib.bpw_put(
            self._handle(), name.encode(),
            arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes,
            _i64(start), _i64(count), len(count),
        )
        if rc < 0:
            raise RuntimeError(f"native put failed for {name!r}")
        # rc is the payload offset the staged block will land at.
        self._integrity.record_block(f"data.{self.writer_id}", int(rc),
                                     _py.byte_view(arr))

    def record_device_checksums(self, step: int, checksums) -> None:
        """As :meth:`~.bplite.BpWriter.record_device_checksums`."""
        self._integrity.record_device(checksums)

    def end_step(self) -> None:
        if self._lib.bpw_end_step(self._handle()) != 0:
            raise RuntimeError("end_step called outside a step")
        self._in_step = False
        self._n_steps += 1
        self._integrity.note_step(self._n_steps)
        self._integrity.flush()

    def drain(self) -> None:
        """Wait until every queued step is durable."""
        if self._lib.bpw_drain(self._handle()) != 0:
            raise IOError(
                f"native BP-lite writer failed writing {self.path} "
                "(disk full or I/O error); failed steps were not published"
            )

    def close(self) -> None:
        if self._in_step:
            raise RuntimeError("close called inside an open step")
        if self._h:
            h, self._h = self._h, None
            if self._lib.bpw_close(h) != 0:
                raise IOError(
                    f"native BP-lite writer failed writing {self.path} "
                    "(disk full or I/O error); failed steps were not "
                    "published"
                )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
