"""Simulation output stream (counterpart of ``grayscott_jl_tpu/io/stream.py``).

The reference's ``ADIOSStream``: provenance attributes (the model's
parameters, ``dt``, ``noise``, ``model``, ``fields``), the Fides and VTK
ImageData schema attributes, and per-step ``step`` plus one variable per
field (upper-cased: ``U``/``V`` for Gray-Scott) with their
``(shape, start, count)`` boxes — attribute for attribute what the
reference writes, so its readers and tools open these stores. bfloat16
fields are stored under the dtype name ``"bfloat16"``. Fields the lossy
snapshot codec codes (``codec``, ``io/codec.py``) are stored at their
uint payload dtype beside per-step ``<NAME>__qlo``/``__qhi`` range
scalars, and the ``snapshot_codec`` attribute names them. With
``mesh_type = "image"`` (the default) each output step is also written
as a ``.vti`` file of the assembled blocks, coded fields decoded first,
in the series ``<output>.vtk/`` (``io/vtk.py``), as the reference does;
a store with several writers (one per process) writes each writer's
blocks as ``.vti`` pieces with a ``.pvti`` index per step instead.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..config.settings import Settings, resolve_model
from ..parallel.domain import CartDomain
from . import open_writer
from .bplite import BF16, dtype_name
from .codec import (CODEC_ATTR, EncodedField, codec_attr_value,
                    payload_dtype, qhi_var, qlo_var)


def define_fields(writer, names, dtype, L: int,
                  codec: Optional[Dict[str, int]]) -> None:
    """Define the field variables ``names`` at ``dtype`` (a torch or
    numpy dtype; bf16 as ``"bfloat16"``), a coded one at its payload
    dtype with its range scalars."""
    for name in names:
        bits = (codec or {}).get(name.lower())
        if bits is None:
            writer.define_variable(name, dtype, (L, L, L))
        else:
            writer.define_variable(name, payload_dtype(bits), (L, L, L))
            writer.define_variable(qlo_var(name), np.float32)
            writer.define_variable(qhi_var(name), np.float32)


def put_fields(writer, names, blocks, coded: bool) -> None:
    """Put one step's field blocks: ``blocks`` is a snapshot
    (``[(offsets, sizes, *field_blocks)]``); a ``coded`` store takes its
    codec form (``encoded``), writing each coded field's range once."""
    if coded:
        if getattr(blocks, "encoded", None) is None:
            raise ValueError(
                "a coded store takes a snapshot's codec form: snapshot "
                "the boundary with encode= (Simulation.snapshot)")
        blocks = blocks.encoded
    ranges_done = set()
    for offsets, sizes, *fblocks in blocks:
        for name, fb in zip(names, fblocks):
            if isinstance(fb, EncodedField):
                writer.put(name, fb.q, start=offsets, count=sizes)
                if name not in ranges_done:
                    writer.put(qlo_var(name), np.float32(fb.lo))
                    writer.put(qhi_var(name), np.float32(fb.hi))
                    ranges_done.add(name)
            else:
                writer.put(name, fb, start=offsets, count=sizes)


def fides_vtk_schemas(L: int, var_names: Sequence[str] = ("U", "V")) -> dict:
    """The Fides + VTK schema attributes over the store variables."""
    var_names = list(var_names)
    extent = (("0 " + str(L) + " ") * 3).rstrip()
    arrays = "\n".join(
        f"                <DataArray Name=\"{n}\" />" for n in var_names
    )
    vtk_schema = (
        "\n        <?xml version=\"1.0\"?>\n"
        "        <VTKFile type=\"ImageData\" version=\"0.1\" "
        "byte_order=\"LittleEndian\">\n"
        f"          <ImageData WholeExtent=\"{extent}\" Origin=\"0 0 0\" "
        "Spacing=\"1 1 1\">\n"
        f"            <Piece Extent=\"{extent}\">\n"
        f"              <CellData Scalars=\"{var_names[0]}\">\n"
        f"{arrays}\n"
        "                <DataArray Name=\"TIME\">\n"
        "                  step\n"
        "                </DataArray>\n"
        "              </CellData>\n"
        "            </Piece>\n"
        "          </ImageData>\n"
        "        </VTKFile>"
    )
    return {
        "Fides_Data_Model": "uniform",
        "Fides_Origin": [0.0, 0.0, 0.0],
        "Fides_Spacing": [0.1, 0.1, 0.1],
        "Fides_Dimension_Variable": var_names[0],
        "Fides_Variable_List": var_names,
        "Fides_Variable_Associations": ["points"] * len(var_names),
        "vtk.xml": vtk_schema,
    }


class SimStream:
    """Step-output stream for a simulation (``IO.init`` analog)."""

    def __init__(
        self,
        settings: Settings,
        domain: CartDomain,
        dtype,
        *,
        writer_id: int = 0,
        nwriters: int = 1,
        resume_step: Optional[int] = None,
        codec: Optional[Dict[str, int]] = None,
    ):
        self.settings = settings
        self.domain = domain
        self.codec = dict(codec or {})
        L = settings.L
        model = resolve_model(settings)
        self.model = model
        self.var_names = tuple(n.upper() for n in model.field_names)
        # A resumed run appends, dropping entries past the resume step.
        keep = None
        if settings.restart and resume_step is not None:
            from . import count_steps_upto

            keep = count_steps_upto(settings.output, resume_step)
        # ADIOS2 has no bfloat16 type: bf16 output stays on BP-lite.
        self.writer = open_writer(
            settings.output, writer_id=writer_id, nwriters=nwriters,
            append=settings.restart, keep_steps=keep,
            prefer_adios2=dtype_name(dtype) != BF16,
        )
        if writer_id == 0:
            for name, value in model.resolve_param_values(settings).items():
                self.writer.define_attribute(name, value)
            self.writer.define_attribute("dt", settings.dt)
            self.writer.define_attribute("noise", settings.noise)
            self.writer.define_attribute("model", model.name)
            self.writer.define_attribute("fields", list(self.var_names))
            if self.codec:
                self.writer.define_attribute(
                    CODEC_ATTR,
                    codec_attr_value(self.codec, self.var_names, dtype))
            for name, value in fides_vtk_schemas(L, self.var_names).items():
                self.writer.define_attribute(name, value)
        self.writer.define_variable("step", np.int32)
        define_fields(self.writer, self.var_names, dtype, L, self.codec)
        self._vtk = None
        self._pvti = None
        if settings.mesh_type.lower() == "image":
            from .vtk import PvtiSeriesWriter, VtiSeriesWriter

            if nwriters == 1:
                self._vtk = VtiSeriesWriter(
                    settings.output, L, append=settings.restart,
                    max_step=resume_step, names=self.var_names,
                )
            else:
                # Each writer its own pieces: no gather across processes.
                self._pvti = PvtiSeriesWriter(
                    settings.output, L, domain.block_boxes(),
                    writer_id=writer_id, append=settings.restart,
                    max_step=resume_step, names=self.var_names,
                )

    def write_step(self, step: int, blocks, checksums=None) -> None:
        """Write one output step; ``blocks`` is a snapshot
        (``[(offsets, sizes, *field_blocks)]`` in model declaration
        order, with the codec form on ``encoded`` for a coded store).
        ``checksums`` (``{field: int}``, the boundary's device checksums)
        go into the store's integrity sidecar (a real ADIOS2 store has
        none and skips them). With the output pipeline
        this runs on its writer thread, the ``.vti`` file's assembly
        and transposition included."""
        w = self.writer
        w.begin_step()
        w.put("step", np.int32(step))
        if checksums is not None and hasattr(w, "record_device_checksums"):
            w.record_device_checksums(step, checksums)
        put_fields(w, self.var_names, blocks, bool(self.codec))
        w.end_step()
        if self._vtk is not None:
            self._vtk.write(step, *self._assembled(blocks))
        if self._pvti is not None:
            self._pvti.write(step, self._decoded(blocks))

    def _decoded(self, blocks):
        """The step's blocks with coded fields decoded to the values the
        store serves."""
        if self.codec:
            blocks = blocks.encoded
        return [(offsets, sizes) + tuple(
                    fb.decode() if isinstance(fb, EncodedField) else fb
                    for fb in fblocks)
                for offsets, sizes, *fblocks in blocks]

    def _assembled(self, blocks):
        """The step's global ``L^3`` arrays for the ``.vti`` file: the
        blocks placed at their offsets, coded fields decoded."""
        L = self.settings.L
        blocks = self._decoded(blocks)
        if len(blocks) == 1 and tuple(blocks[0][1]) == (L, L, L):
            return blocks[0][2:]
        arrays = tuple(np.empty((L, L, L), blocks[0][2].dtype)
                       for _ in self.var_names)
        for offsets, sizes, *fblocks in blocks:
            box = tuple(slice(o, o + s) for o, s in zip(offsets, sizes))
            for full, fb in zip(arrays, fblocks):
                full[box] = fb
        return arrays

    @property
    def engine(self) -> str:
        """The engine writing the store: ``adios2``, or ``native`` or
        ``python`` for BP-lite (a rollback sidecar's writer included)."""
        return self.writer.engine

    def close(self) -> None:
        try:
            self.writer.close()
        finally:
            for series in (self._vtk, self._pvti):
                if series is not None:
                    series.close()
