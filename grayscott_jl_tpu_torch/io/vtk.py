"""VTK ImageData (``.vti``) output for ParaView (counterpart of
``grayscott_jl_tpu/io/vtk.py``).

Besides the BP-lite store, a run with ``mesh_type = "image"`` (the
default) writes a ``.vti`` file per output step plus a ``.pvd`` series
index in ``<output>.vtk/``, as the reference does, so ParaView opens the
run with no ADIOS2 reader. The format is the reference's byte for byte.

Axis convention: fields are C-order ``[x, y, z]``; VTK's flat order is
x-fastest, so blocks are transposed before writing. A store with
several writers (a run of several processes) writes the parallel form
instead (:class:`PvtiSeriesWriter`): one ``.vti`` piece per block, a
``.pvti`` index of all the blocks per step, and the ``series.pvd``.
"""

from __future__ import annotations

import os
import struct
import xml.sax.saxutils as saxutils

import numpy as np

_VTK_TYPES = {
    "float32": "Float32",
    "float64": "Float64",
    "int32": "Int32",
    "int64": "Int64",
}


def _extent_str(extent) -> str:
    return " ".join(f"{lo} {hi}" for lo, hi in extent)


def write_vti(
    path: str,
    L: int,
    step: int,
    *arrays: np.ndarray,
    names=None,
    extent=None,
) -> None:
    """One .vti file with the model's fields as CellData (appended raw
    encoding); ``names`` defaults to the Gray-Scott ``("U", "V")`` for
    two arrays.

    ``extent`` is the block's cell-space box in *global* coordinates as
    ``((x0, x1), (y0, y1), (z0, z1))``; default is the whole ``[0, L]^3``
    grid. Dtypes VTK has no type name for are widened to float32.
    """
    if names is None:
        names = _default_names(len(arrays))
    if arrays[0].dtype.name not in _VTK_TYPES:
        arrays = tuple(a.astype(np.float32) for a in arrays)
    vtk_type = _VTK_TYPES[arrays[0].dtype.name]
    if extent is None:
        extent = ((0, L),) * 3
    ext = _extent_str(extent)
    payloads = []
    offsets = []
    off = 0
    for arr in arrays:
        raw = np.ascontiguousarray(arr.transpose(2, 1, 0)).tobytes()
        payloads.append(struct.pack("<Q", len(raw)) + raw)
        offsets.append(off)
        off += len(payloads[-1])

    data_arrays = "\n".join(
        f'        <DataArray type="{vtk_type}" Name="{n}" '
        f'format="appended" offset="{o}"/>'
        for n, o in zip(names, offsets)
    )
    header = (
        '<?xml version="1.0"?>\n'
        '<VTKFile type="ImageData" version="1.0" byte_order="LittleEndian" '
        'header_type="UInt64">\n'
        f'  <ImageData WholeExtent="{ext}" Origin="0 0 0" '
        'Spacing="1 1 1">\n'
        f'    <Piece Extent="{ext}">\n'
        f'      <CellData Scalars="{names[0]}">\n'
        f'{data_arrays}\n'
        '      </CellData>\n'
        '    </Piece>\n'
        '  </ImageData>\n'
        '  <AppendedData encoding="raw">_'
    )
    footer = "</AppendedData>\n</VTKFile>\n"
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header.encode())
        for p in payloads:
            f.write(p)
        f.write(footer.encode())
    os.replace(tmp, path)


_NP_TYPES = {v: k for k, v in _VTK_TYPES.items()}


def _default_names(n: int):
    """Gray-Scott's historical (U, V) for two arrays, F0..Fn otherwise."""
    return ("U", "V") if n == 2 else tuple(f"F{i}" for i in range(n))


def read_vti(path: str):
    """Read back a :func:`write_vti` file -> ``(extent, {"U": a, "V": a})``.

    Parses exactly the subset this module writes (appended raw encoding,
    UInt64 headers), to read visualization output back without a VTK
    dependency.
    """
    import re

    with open(path, "rb") as f:
        blob = f.read()
    marker = blob.index(b'<AppendedData encoding="raw">_') + len(
        b'<AppendedData encoding="raw">_'
    )
    header = blob[:marker].decode()
    m = re.search(r'<Piece Extent="([^"]+)"', header)
    nums = [int(x) for x in m.group(1).split()]
    extent = tuple((nums[i], nums[i + 1]) for i in (0, 2, 4))
    shape = tuple(hi - lo for lo, hi in extent)
    out = {}
    for am in re.finditer(
        r'<DataArray type="(\w+)" Name="(\w+)" format="appended" '
        r'offset="(\d+)"/>', header
    ):
        vtk_type, name, off = am.group(1), am.group(2), int(am.group(3))
        dtype = np.dtype(_NP_TYPES[vtk_type])
        (nbytes,) = struct.unpack_from("<Q", blob, marker + off)
        arr = np.frombuffer(
            blob, dtype=dtype, count=nbytes // dtype.itemsize,
            offset=marker + off + 8,
        )
        # stored x-fastest (VTK flat order); back to C-order [x, y, z]
        out[name] = arr.reshape(shape[::-1]).transpose(2, 1, 0)
    return extent, out


def _scan_series(directory: str, suffix: str, max_step) -> list:
    """(step, name) entries of existing ``step_<n><suffix>`` files,
    skipping anything that is not a plain series frame, and — on a
    restart — anything past ``max_step``."""
    entries = []
    for name in sorted(os.listdir(directory)):
        stem = name[5:-len(suffix)]
        if not (name.startswith("step_") and name.endswith(suffix)
                and stem.isdigit()):
            continue
        if max_step is not None and int(stem) > max_step:
            continue
        entries.append((int(stem), name))
    return entries


class VtiSeriesWriter:
    """Time series of .vti files with a .pvd collection index."""

    def __init__(
        self, output_name: str, L: int, *, append: bool = False,
        max_step=None, names=("U", "V"),
    ):
        base = output_name[:-3] if output_name.endswith(".bp") else output_name
        self.dir = base + ".vtk"
        self.L = L
        self.names = tuple(names)
        os.makedirs(self.dir, exist_ok=True)
        # restart: keep pre-restart frames in the series index
        self._entries = _scan_series(self.dir, ".vti", max_step) if append else []
        self._pvd_path = os.path.join(self.dir, "series.pvd")

    def write(self, step: int, *arrays: np.ndarray) -> None:
        name = f"step_{step:07d}.vti"
        write_vti(os.path.join(self.dir, name), self.L, step, *arrays,
                  names=self.names)
        self._entries.append((step, name))
        self._flush_pvd()

    def _flush_pvd(self) -> None:
        _write_pvd(self._pvd_path, self._entries)

    def close(self) -> None:
        self._flush_pvd()


class PvtiSeriesWriter:
    """The parallel series: a ``.vti`` piece per block, a ``.pvti``
    index per step and the ``.pvd`` collection (the reference's
    ``PvtiSeriesWriter``, its file names and format). Every writer
    writes the pieces of its own blocks; writer 0 also writes the
    step's ``.pvti`` over every block of ``boxes`` (the global layout,
    known without communication) and the ``.pvd``.

    As in the reference, writer 0 may publish a step's index before a
    peer's pieces are on disk: the BP store, whose reader shows a step
    only once every writer committed it, is the record; the ``.pvti``
    is for visualization."""

    def __init__(self, output_name: str, L: int, boxes, *,
                 writer_id: int = 0, append: bool = False, max_step=None,
                 names=("U", "V")):
        base = output_name[:-3] if output_name.endswith(".bp") else output_name
        self.dir = base + ".vtk"
        self.L = L
        self.boxes = [(tuple(o), tuple(c)) for o, c in boxes]
        self.names = tuple(names)
        self.writer_id = writer_id
        os.makedirs(self.dir, exist_ok=True)
        self._entries = (_scan_series(self.dir, ".pvti", max_step)
                         if append and writer_id == 0 else [])
        self._pvd_path = os.path.join(self.dir, "series.pvd")

    @staticmethod
    def piece_name(step: int, offsets) -> str:
        return f"step_{step:07d}_b{'_'.join(str(o) for o in offsets)}.vti"

    def write(self, step: int, blocks) -> None:
        """Write this writer's ``(offsets, sizes, *fields)`` blocks as
        pieces; writer 0 then publishes the step's ``.pvti``."""
        vtk_type = None
        for offsets, sizes, *fblocks in blocks:
            extent = tuple((o, o + s) for o, s in zip(offsets, sizes))
            write_vti(os.path.join(self.dir, self.piece_name(step, offsets)),
                      self.L, step, *fblocks, names=self.names,
                      extent=extent)
            vtk_type = _VTK_TYPES.get(fblocks[0].dtype.name, "Float32")
        if self.writer_id == 0:
            self._write_pvti(step, vtk_type or "Float32")

    def _write_pvti(self, step: int, vtk_type: str) -> None:
        whole = _extent_str(((0, self.L),) * 3)
        lines = [
            '<?xml version="1.0"?>',
            '<VTKFile type="PImageData" version="0.1" '
            'byte_order="LittleEndian">',
            f'  <PImageData WholeExtent="{whole}" GhostLevel="0" '
            'Origin="0 0 0" Spacing="1 1 1">',
            f'    <PCellData Scalars="{self.names[0]}">',
            *(f'      <PDataArray type="{vtk_type}" Name="{n}"/>'
              for n in self.names),
            "    </PCellData>",
        ]
        for offsets, sizes in self.boxes:
            ext = _extent_str(tuple((o, o + s)
                                    for o, s in zip(offsets, sizes)))
            name = self.piece_name(step, offsets)
            lines.append(f'    <Piece Extent="{ext}" '
                         f'Source="{saxutils.escape(name)}"/>')
        lines += ["  </PImageData>", "</VTKFile>", ""]
        name = f"step_{step:07d}.pvti"
        tmp = os.path.join(self.dir, name + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            f.write("\n".join(lines))
        os.replace(tmp, os.path.join(self.dir, name))
        self._entries.append((step, name))
        _write_pvd(self._pvd_path, self._entries)

    def close(self) -> None:
        if self.writer_id == 0:
            _write_pvd(self._pvd_path, self._entries)


def _write_pvd(pvd_path: str, entries) -> None:
    """Atomic ``.pvd`` collection index over (step, file) entries."""
    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="Collection" version="0.1" '
        'byte_order="LittleEndian">',
        "  <Collection>",
    ]
    for step, name in entries:
        lines.append(
            f'    <DataSet timestep="{step}" part="0" '
            f'file="{saxutils.escape(name)}"/>'
        )
    lines += ["  </Collection>", "</VTKFile>", ""]
    tmp = pvd_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))
    os.replace(tmp, pvd_path)
