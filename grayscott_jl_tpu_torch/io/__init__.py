"""I/O: streaming stores and checkpoints (counterpart of
``grayscott_jl_tpu/io``).

Three writer engines behind :func:`open_writer`, in the reference's
order of preference:

* real ADIOS2 (``io/adios.py``): a genuine ``.bp`` store, chosen when
  the ``adios2`` bindings are importable, for single-writer stores,
  restart-append (BP4 Append) included. A rollback-append, a step
  truncation that BP4 cannot express, sends the steps after the rollback
  to a BP-lite sidecar that the readers merge back (``io/sidecar.py``).
  Checkpoints stay on BP-lite (``prefer_adios2=False``);
* native BP-lite (``io/native.py``, C++ compiled with ``g++`` at first
  use): the default without the bindings, and for every store of a run
  of several processes;
* pure-Python BP-lite (``io/bplite.py``): the format's definition,
  always there.

``GS_TPU_ADIOS2=0`` and ``GS_TPU_NATIVE_IO=0`` (only ``"0"``, as in the
reference) turn the first two off. :func:`open_reader` picks the reader
from what the store holds: a real BP store (``md.idx``, ``md.<n>``) needs
the bindings, anything else is BP-lite. The stores of either engine open
in either package's readers.
"""

from __future__ import annotations

import os

from ..config.env import env_str


def _real_bp_evidence(path: str) -> bool:
    """Is ``path`` a real ADIOS2 BP store?

    Positive evidence only: a BP-lite multi-writer store in the middle of
    start-up may hold bare ``data.<w>`` payloads and no metadata yet
    (writer 0 commits ``md.json`` last), and a peer's ``open_writer`` or a
    live reader inspects it just then. ADIOS2's BP4/BP5 engines make
    ``md.idx`` and extensionless ``md.<n>`` at open; a BP3 store is one
    regular file (BP-lite stores are directories); BP-lite metadata is
    always ``md[.<w>].json``.
    """
    if os.path.isfile(path):
        return True
    try:
        names = os.listdir(path)
    except (FileNotFoundError, NotADirectoryError):
        return False
    return any(n in ("md.idx", "mmd.0")
               or (n.startswith("md.") and n[3:].isdigit()) for n in names)


def _foreign_dir(path: str) -> bool:
    """Is ``path`` a non-empty directory with no BP-lite entries?

    Keeps a restart-append from writing into an unrelated directory (a
    typo'd or stale config path). BP-lite entries are ``md[.<w>].json``
    metadata (``.tmp`` too), ``data.<w>`` payloads and the integrity and
    quarantine files; an empty directory is taken as ours (a peer has just
    made it).
    """
    try:
        names = os.listdir(path)
    except (FileNotFoundError, NotADirectoryError):
        return False

    def ours(n: str) -> bool:
        if n.startswith(("md.", "integrity")) and n.endswith(
                (".json", ".json.tmp")):
            return True
        if n in ("quarantine.json", "quarantine.json.tmp"):
            return True
        return n.startswith("data.") and n[5:].isdigit()

    return bool(names) and not any(ours(n) for n in names)


def count_steps_upto(path: str, sim_step: int):
    """Number of leading step entries whose ``step`` scalar is
    <= ``sim_step`` (None when the store does not exist) — how many a
    run resuming at ``sim_step`` keeps (its ``keep_steps``).

    A real BP store is counted through the bindings (None without them:
    ``open_writer``'s append gate then refuses it), its rollback sidecar
    included."""
    from .bplite import BpReader, _md_path

    def count_leading(r) -> int:
        k = 0
        for i in range(r.num_steps()):
            if int(r.get("step", step=i)) > sim_step:
                break
            k = i + 1
        return k

    if _real_bp_evidence(path):
        from . import adios, sidecar

        if not adios.available():
            return None
        r = adios.Adios2Reader(path)
        keep_base = sidecar.read_keep_base(path)
        if keep_base is not None:
            r = sidecar.MergedReader(r, sidecar.sidecar_reader(path),
                                     keep_base)
        with r:
            return count_leading(r)
    # The rank-0 metadata file, not the directory: in a restart of several
    # processes onto a fresh store a peer may have made the directory,
    # while md.json comes only from this process (writer 0), later.
    if not os.path.isfile(_md_path(path)):
        return None
    with BpReader(path) as r:
        return count_leading(r)


def _bplite_writer(path, *, writer_id, nwriters, append, keep_steps):
    """The BP-lite engine chain: native C++ if it builds, else Python;
    ``GS_TPU_NATIVE_IO=0`` forces Python."""
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


def _drop_bplite_files(path: str) -> None:
    """Delete a BP-lite store's files at ``path`` before a fresh ADIOS2
    write there, so that :func:`open_reader` does not find the stale
    ``md.json`` and serve the old run."""
    if not os.path.isdir(path):
        return
    for name in os.listdir(path):
        if name in ("md.json", "quarantine.json") or (
                name.startswith(("md.", "data.", "integrity"))
                and not name.endswith(".bp")):
            os.remove(os.path.join(path, name))


def _adios2_writer(path, *, writer_id, nwriters, append, keep_steps):
    """The ADIOS2 engine's writer for ``path``, or the BP-lite sidecar's
    for a rollback onto a real store; None where the store is neither
    real BP nor absent (BP-lite stays BP-lite)."""
    from . import adios, sidecar

    if not append:
        _drop_bplite_files(path)
        return adios.Adios2Writer(path, writer_id=writer_id,
                                  nwriters=nwriters)
    has_bp = _real_bp_evidence(path)
    if not (has_bp or not os.path.exists(path)):
        return None
    keep_base = sidecar.read_keep_base(path)
    if keep_base is not None and not has_bp:
        # An orphaned sidecar whose base store is gone: steps routed
        # there would go where no reader looks, and a new base store
        # would graft the stale tail back on.
        sidecar.remove_sidecar(path)
        keep_base = None
    if keep_base is not None:
        # A sidecar exists: every later append goes there (base steps
        # after sidecar steps would break the merged order). A deeper
        # rollback lowers keep_base; a shallower one truncates inside
        # the sidecar.
        if keep_steps is None:
            inner_keep = None
        elif keep_steps <= keep_base:
            sidecar.write_keep_base(path, keep_steps)
            inner_keep = 0
        else:
            inner_keep = keep_steps - keep_base
        return _bplite_writer(sidecar.sidecar_path(path),
                              writer_id=writer_id, nwriters=nwriters,
                              append=True, keep_steps=inner_keep)
    if keep_steps is not None and has_bp:
        with adios.Adios2Reader(path) as r:
            total = r.num_steps()
        if keep_steps < total:
            # A rollback onto a real store: its first keep_steps steps
            # stay live (the marker records them) and every later step
            # goes to a fresh BP-lite sidecar.
            sidecar.write_keep_base(path, keep_steps)
            return _bplite_writer(sidecar.sidecar_path(path),
                                  writer_id=writer_id, nwriters=nwriters,
                                  append=False, keep_steps=None)
    return adios.Adios2Writer(path, writer_id=writer_id, nwriters=nwriters,
                              append=True)


def _append_refusal(path: str, prefer_adios2: bool, nwriters: int):
    """Why an append at ``path`` that the ADIOS2 engine did not take
    cannot go to BP-lite, or None when it can."""
    if _foreign_dir(path):
        return "an unrelated directory (typo'd or stale config path?)"
    if not _real_bp_evidence(path):
        return None
    from . import adios

    if not adios.available():
        return ("a real ADIOS2 BP store and the adios2 bindings are not "
                "importable to append to it")
    if not prefer_adios2:
        return ("a real ADIOS2 BP store, but this store type "
                "(checkpoints) stays on the BP-lite engines by design "
                "(rollback-append and selection-restore are BP-lite "
                "semantics)")
    if nwriters != 1:
        return ("a real ADIOS2 BP store and the adios2 engine is "
                "single-writer (this is a multi-process run); "
                "multi-writer append is a BP-lite feature")
    # The only case left: the engine takes every real store it is let at.
    return ("a real ADIOS2 BP store but GS_TPU_ADIOS2=0 disables the "
            "adios2 engine; unset it to append to this store")


def open_writer(path: str, *, writer_id: int = 0, nwriters: int = 1,
                append: bool = False, keep_steps=None,
                prefer_adios2: bool = True):
    """A step writer at ``path`` on the first engine that takes it.

    The ADIOS2 engine takes single-writer stores (``nwriters == 1``)
    when the bindings are importable, ``prefer_adios2`` holds and
    ``GS_TPU_ADIOS2`` is not ``0``: a fresh write (dropping a BP-lite
    store's files there), or an append onto a real store or a path that
    does not exist. A rollback onto a real store (``keep_steps`` below
    its step count) goes to its BP-lite sidecar. Every other store goes
    to the BP-lite engines, which write the multi-writer layout and
    truncate on rollback (``append`` keeping the first ``keep_steps``
    entries). An append into a directory that no engine may write — an
    unrelated directory, or a real store the ADIOS2 engine cannot take
    here — raises ``RuntimeError``. The writer's ``engine`` names its
    engine.
    """
    from . import sidecar

    if not append:
        # A stale sidecar at this path would graft the old run's tail
        # onto the new store when it is read.
        sidecar.remove_sidecar(path)
    if (prefer_adios2 and nwriters == 1
            and env_str("GS_TPU_ADIOS2", "1") != "0"):
        from . import adios

        if adios.available():
            w = _adios2_writer(path, writer_id=writer_id, nwriters=nwriters,
                               append=append, keep_steps=keep_steps)
            if w is not None:
                return w
    if append:
        why = _append_refusal(path, prefer_adios2, nwriters)
        if why is not None:
            raise RuntimeError(
                f"cannot append to {path}: it is {why}. Point the restart "
                "at a fresh output path, or keep output stores on BP-lite "
                "(GS_TPU_ADIOS2=0 from the first run) where multi-writer "
                "and rollback-append are implemented")
    return _bplite_writer(path, writer_id=writer_id, nwriters=nwriters,
                          append=append, keep_steps=keep_steps)


def _merged_or_base(path: str, *, live: bool):
    """The ADIOS2 reader of the real store at ``path``, merged with its
    rollback sidecar when it has one. A live reader retries the
    sidecar's attach: its first metadata flush may not have landed."""
    from . import adios, sidecar

    base = adios.Adios2Reader(path)
    keep_base = sidecar.read_keep_base(path)
    if keep_base is None:
        return base
    return sidecar.MergedReader(
        base, sidecar.sidecar_reader(path, live=live), keep_base,
        reattach=((lambda: sidecar.sidecar_reader(path, live=True))
                  if live else None))


def open_reader(path: str, *, live: bool = False):
    """A reader of the store at ``path``, on the engine its files name.

    A real ADIOS2 store needs the bindings (a ``RuntimeError`` says so
    without them); anything else is BP-lite. ``live=True`` is the
    streaming form (pdfcalc attaching to a run still in its first step):
    the store may not exist yet, and ``begin_step`` polls (NOT_READY
    until its timeout) until the writer makes it, then reads it on the
    engine it turns out to be. Without ``live`` a missing store raises.
    """
    from .bplite import BpReader

    if _real_bp_evidence(path):
        from . import adios

        if adios.available():
            return _merged_or_base(path, live=live)
        raise RuntimeError(
            f"{path} is not a BP-lite store and the adios2 bindings are "
            "not importable to read it as a real BP store")
    if not live:
        return BpReader(path)
    from . import adios

    if not adios.available():
        # Every writer engine of this process family writes BP-lite.
        return BpReader(path, wait_for_writer=True)
    return _LiveDispatchReader(path)


class _LiveDispatchReader:
    """A live reader of a store that does not exist yet while the adios2
    bindings are importable: the writer may be the ADIOS2 engine
    (``md.idx``, no ``md.json``) or a BP-lite one, and a reader of either
    would wait forever on the other. ``begin_step`` polls until the
    store's format shows, then opens the matching reader and hands every
    call to it."""

    def __init__(self, path: str):
        self.path = path
        self._inner = None

    def _try_attach(self):
        from .bplite import BpReader, _md_path

        if _real_bp_evidence(self.path):
            self._inner = _merged_or_base(self.path, live=True)
        elif os.path.isfile(_md_path(self.path)):
            self._inner = BpReader(self.path, wait_for_writer=True)
        return self._inner

    def begin_step(self, timeout: float = 10.0):
        import time

        from .bplite import StepStatus

        deadline = time.monotonic() + timeout
        while self._inner is None:
            if self._try_attach() is not None:
                break
            if time.monotonic() >= deadline:
                return StepStatus.NOT_READY
            time.sleep(0.05)
        return self._inner.begin_step(
            timeout=max(0.0, deadline - time.monotonic()))

    def close(self):
        # A reader that gave up before the store appeared closes too.
        if self._inner is not None:
            self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __getattr__(self, name):
        # begin_step comes first in the streaming protocol.
        if self._inner is None:
            raise RuntimeError(
                f"store {self.path} has not appeared yet; call begin_step "
                "until it returns OK before other reads")
        return getattr(self._inner, name)
