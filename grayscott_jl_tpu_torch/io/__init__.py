"""I/O: BP-lite streaming stores and checkpoints (counterpart of
``grayscott_jl_tpu/io``, its BP-lite engines).

:func:`open_writer` opens the BP-lite engine chain of the reference's
``_bplite_writer``: the native C++ engine (``io/native.py``, compiled
with ``g++`` at first use) when it builds, else the pure-Python engine
(``io/bplite.py``); ``GS_TPU_NATIVE_IO=0`` forces Python. Both write
the same format, and their stores open in either package's reader.
:func:`open_reader` opens a store. The reference's ADIOS2 engine (and
its rollback sidecar) needs the ``adios2`` wheel and is not carried
over (ROADMAP, "Not queued").
"""

from __future__ import annotations

import os

from ..config.env import env_str


def count_steps_upto(path: str, sim_step: int):
    """Number of leading step entries whose ``step`` scalar is
    <= ``sim_step`` (None when the store does not exist) — how many a
    run resuming at ``sim_step`` keeps."""
    from .bplite import BpReader, _md_path

    if not os.path.isfile(_md_path(path)):
        return None
    with BpReader(path) as r:
        k = 0
        for i in range(r.num_steps()):
            if int(r.get("step", step=i)) > sim_step:
                break
            k = i + 1
    return k


def _bplite_writer(path, *, writer_id, nwriters, append, keep_steps):
    """The BP-lite engine chain: native C++ if it builds, else Python;
    ``GS_TPU_NATIVE_IO=0`` (only ``"0"``, as in the reference) forces
    Python."""
    if env_str("GS_TPU_NATIVE_IO", "1") != "0":
        from . import native

        if native.available():
            return native.NativeBpWriter(
                path, writer_id=writer_id, nwriters=nwriters, append=append,
                keep_steps=keep_steps,
            )
    from .bplite import BpWriter

    return BpWriter(path, writer_id=writer_id, nwriters=nwriters,
                    append=append, keep_steps=keep_steps)


def open_writer(path: str, *, writer_id: int = 0, nwriters: int = 1,
                append: bool = False, keep_steps=None):
    """A BP-lite step writer at ``path`` on the engine chain (``append``
    resumes a store, keeping its first ``keep_steps`` entries); its
    ``engine`` attribute names the engine."""
    return _bplite_writer(path, writer_id=writer_id, nwriters=nwriters,
                          append=append, keep_steps=keep_steps)


def open_reader(path: str, *, live: bool = False):
    """A BP-lite reader; ``live=True`` waits for a store that does not
    exist yet."""
    from .bplite import BpReader

    return BpReader(path, wait_for_writer=live)
