"""I/O: BP-lite streaming stores and checkpoints (counterpart of
``grayscott_jl_tpu/io``, BP-lite engine only).

:func:`open_writer` / :func:`open_reader` open the pure-Python BP-lite
engine (``io/bplite.py``); its stores open in the reference's reader
and the other way round. The reference's ADIOS2 and native C++ engines
are not carried over.
"""

from __future__ import annotations

import os


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


def open_writer(path: str, *, writer_id: int = 0, nwriters: int = 1,
                append: bool = False, keep_steps=None):
    """A BP-lite step writer at ``path`` (``append`` resumes a store,
    keeping its first ``keep_steps`` entries)."""
    from .bplite import BpWriter

    return BpWriter(path, writer_id=writer_id, nwriters=nwriters,
                    append=append, keep_steps=keep_steps)


def open_reader(path: str, *, live: bool = False):
    """A BP-lite reader; ``live=True`` waits for a store that does not
    exist yet."""
    from .bplite import BpReader

    return BpReader(path, wait_for_writer=live)
