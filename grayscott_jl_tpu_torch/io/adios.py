"""The real-ADIOS2 engine (counterpart of ``grayscott_jl_tpu/io/adios.py``):
genuine ``.bp`` output when the ``adios2`` bindings are importable.

GrayScott.jl writes its output through the ADIOS2 C++ library, and
ParaView's ADIOS/Fides readers and any adios2 tool open that store.
BP-lite (``io/bplite.py``) keeps the store's contract — variables,
attributes, step streaming, ``(shape, start, count)`` blocks — in a
format of its own. This adapter writes the same variables, provenance
attributes and Fides/VTK schemas into a real BP4 store, so those tools
open the port's output as they open the reference's:
:func:`grayscott_jl_tpu_torch.io.open_writer` routes to
:class:`Adios2Writer` when ``import adios2`` succeeds, and
``GS_TPU_ADIOS2=0`` turns it off.

Targets the adios2 >= 2.9 Python API (``adios2.Adios`` / ``declare_io``
/ snake_case engine methods). Single-writer stores only, restart-append
included (BP4 ``Append`` mode). Multi-writer stores (a run of several
processes) and rollback-append (step truncation, which BP4 cannot
express) stay on BP-lite: ``open_writer`` routes the first to the
BP-lite engines and the second to a BP-lite sidecar (``io/sidecar.py``).

The writer takes host arrays only (numpy arrays and scalars): the output
pipeline hands it blocks of pinned host buffers that it reuses, so every
``put`` is ``Sync`` — the engine has copied the block when ``put``
returns. The store has no bfloat16 type; bf16 output stays on BP-lite
(``io/stream.py``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence

import numpy as np

from .bplite import BF16, StepStatus, VarInfo, dtype_name


@functools.cache
def available() -> bool:
    """True when the adios2 Python bindings are importable and carry the
    2.9+ API this adapter targets."""
    try:
        import adios2
    except ImportError:
        return False
    return hasattr(adios2, "Adios")


def _mode(name: str):
    from adios2 import bindings

    return getattr(bindings.Mode, name)


#: adios2's C type names whose numpy spelling differs. ``np.dtype("float")``
#: is float64, but adios2's ``"float"`` is C float: mapping through numpy
#: directly would double every float32 variable's element size.
_ADIOS_TYPE_TO_NP = {
    "float": "float32",
    "double": "float64",
    "long double": "longdouble",
    "char": "int8",
    "unsigned char": "uint8",
}


def _np_dtype(adios_type: str) -> np.dtype:
    return np.dtype(
        _ADIOS_TYPE_TO_NP.get(adios_type, adios_type.replace("_t", "")))


def _host_array(value, dtype: np.dtype) -> np.ndarray:
    """``value`` as a contiguous host array of ``dtype``; a tensor (on
    the card or not) is refused, so that no device buffer or lazily
    copied view reaches the engine."""
    if not isinstance(value, (np.ndarray, np.generic, int, float, bool)):
        raise TypeError(
            f"Adios2Writer.put takes host arrays, got {type(value).__name__}")
    return np.ascontiguousarray(np.asarray(value, dtype=dtype))


class Adios2Writer:
    """A ``BpWriter``-interface writer of a real ADIOS2 BP store:
    ``define_attribute`` / ``define_variable`` / ``begin_step`` / ``put``
    / ``end_step`` / ``close``, so ``SimStream`` and the output pipeline
    run on it unchanged."""

    #: The engine's name in ``RunStats.config["io_engine"]``.
    engine = "adios2"

    def __init__(self, path: str, *, writer_id: int = 0, nwriters: int = 1,
                 append: bool = False, io_name: str = "SimulationOutput"):
        if nwriters != 1 or writer_id != 0:
            raise ValueError(
                "Adios2Writer is single-writer; multi-writer stores use "
                "the BP-lite engines (open_writer gates this)")
        import adios2

        self.path = path
        self._adios = adios2.Adios()
        self._io = self._adios.declare_io(io_name)
        # GrayScott.jl never sets an engine and so gets ADIOS2's default
        # of its era, BP4; pin it for the same output.
        self._io.set_engine("BP4")
        # Append continues an existing store's step sequence (a restart).
        self._engine = self._io.open(
            path, _mode("Append") if append else _mode("Write"))
        self._vars: Dict[str, Any] = {}
        self._meta: Dict[str, dict] = {}

    def define_attribute(self, name: str, value: Any) -> None:
        if isinstance(value, (list, tuple)) and value and isinstance(
                value[0], str):
            self._io.define_attribute(name, list(value))
        elif isinstance(value, (list, tuple, np.ndarray)):
            self._io.define_attribute(name, np.asarray(value,
                                                       dtype=np.float64))
        elif isinstance(value, str):
            self._io.define_attribute(name, value)
        elif isinstance(value, (bool, int, np.integer)):
            self._io.define_attribute(name, np.int64(value))
        else:
            self._io.define_attribute(name, np.float64(value))

    def define_variable(self, name: str, dtype,
                        shape: Sequence[int] = ()) -> None:
        """Define ``name``; ``dtype`` is a numpy or torch dtype or a
        dtype name. The adios2 variable is made at the first ``put``
        (the 2.9 API takes its type from the array it is given)."""
        dname = dtype_name(dtype)
        if dname == BF16:
            raise TypeError(
                f"variable {name!r}: ADIOS2 has no bfloat16 type; bf16 "
                "stores use the BP-lite engines")
        self._meta[name] = {"dtype": np.dtype(dname),
                            "shape": [int(s) for s in shape]}

    def begin_step(self) -> None:
        self._engine.begin_step()

    def put(self, name: str, value, *, start: Optional[Sequence[int]] = None,
            count: Optional[Sequence[int]] = None) -> None:
        meta = self._meta.get(name)
        if meta is None:
            raise KeyError(f"Variable {name!r} not defined")
        shape = meta["shape"]
        arr = _host_array(value, meta["dtype"])
        start = [0] * len(shape) if start is None else [int(s) for s in start]
        count = list(shape) if count is None else [int(c) for c in count]
        var = self._vars.get(name)
        if var is None:
            var = self._vars[name] = self._io.define_variable(
                name, arr, shape, start, count)
        elif shape:
            var.set_selection((start, count))
        # Sync: the engine copies before put returns, so the caller may
        # reuse its buffer at once.
        self._engine.put(var, arr, _mode("Sync"))

    def end_step(self) -> None:
        self._engine.end_step()

    def close(self) -> None:
        self._engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Adios2Reader:
    """A ``BpReader``-interface reader of a real ADIOS2 BP store: step
    streaming (``begin_step(timeout)`` -> OK | NOT_READY | END_OF_STREAM,
    pdfcalc's live loop) and random access (``get(name, step=i)``, through
    a second engine opened at first use)."""

    def __init__(self, path: str, *, io_name: str = "SimulationInput"):
        import adios2

        self.path = path
        self._adios = adios2.Adios()
        self._io = self._adios.declare_io(io_name)
        self._stream = None
        self._ra_io = None
        self._ra = None
        self._selections: Dict[str, tuple] = {}

    # -- step streaming ----------------------------------------------------

    def _ensure_stream(self):
        if self._stream is None:
            self._stream = self._io.open(self.path, _mode("Read"))
        return self._stream

    def begin_step(self, timeout: float = 10.0) -> StepStatus:
        from adios2 import bindings

        status = self._ensure_stream().begin_step(bindings.StepMode.Read,
                                                  float(timeout))
        if status == bindings.StepStatus.OK:
            return StepStatus.OK
        if status == bindings.StepStatus.NotReady:
            return StepStatus.NOT_READY
        return StepStatus.END_OF_STREAM

    def current_step(self) -> int:
        return int(self._ensure_stream().current_step())

    def end_step(self) -> None:
        self._ensure_stream().end_step()
        self._selections = {}

    # -- inquiry -----------------------------------------------------------

    def _ensure_ra(self):
        if self._ra is None:
            self._ra_io = self._adios.declare_io("RandomAccessInput")
            self._ra = self._ra_io.open(self.path, _mode("ReadRandomAccess"))
        return self._ra

    def _inquiry_io(self):
        """The IO that can answer inquiries now: the stream's while one
        is open, else the random-access one."""
        if self._stream is not None:
            return self._io
        self._ensure_ra()
        return self._ra_io

    def attributes(self) -> Dict[str, Any]:
        io = self._inquiry_io()
        out = {}
        for name in io.available_attributes():
            att = io.inquire_attribute(name)
            data = att.data_string() if att.type() == "string" else att.data()
            if isinstance(data, (list, np.ndarray)) and len(data) == 1:
                data = data[0]
            out[name] = data
        return out

    def available_variables(self) -> Dict[str, VarInfo]:
        io = self._inquiry_io()
        out = {}
        for name in io.available_variables():
            var = io.inquire_variable(name)
            out[name] = VarInfo(name, _np_dtype(var.type()).name,
                                tuple(var.shape()))
        return out

    def inquire_variable(self, name: str) -> Optional[VarInfo]:
        return self.available_variables().get(name)

    def num_steps(self) -> int:
        self._ensure_ra()
        for name in self._ra_io.available_variables():
            return int(self._ra_io.inquire_variable(name).steps())
        return 0

    def set_selection(self, name: str, start: Sequence[int],
                      count: Sequence[int]) -> None:
        self._selections[name] = ([int(s) for s in start],
                                  [int(c) for c in count])

    # -- data --------------------------------------------------------------

    def get(self, name: str, *, step: Optional[int] = None,
            start: Optional[Sequence[int]] = None,
            count: Optional[Sequence[int]] = None) -> np.ndarray:
        if step is None:
            io, engine = self._io, self._ensure_stream()
        else:
            engine = self._ensure_ra()
            io = self._ra_io
        var = io.inquire_variable(name)
        if var is None:
            raise KeyError(f"Variable {name!r} has no data at this step")
        if step is not None:
            var.set_step_selection([int(step), 1])
        shape = tuple(var.shape())
        if start is None and name in self._selections:
            start, count = self._selections[name]
        if shape and start is not None:
            var.set_selection(([int(s) for s in start],
                               [int(c) for c in count]))
            shape = tuple(int(c) for c in count)
        out = np.empty(shape, dtype=_np_dtype(var.type()))
        engine.get(var, out, _mode("Sync"))
        return out if shape else out[()]

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None
        if self._ra is not None:
            self._ra.close()
            self._ra = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
