"""The rollback sidecar of a real ADIOS2 BP store (counterpart of
``grayscott_jl_tpu/io/sidecar.py``).

BP4 appends steps but never truncates them, so a rollback restart —
resuming from a checkpoint earlier than the store's last step and
dropping the abandoned trajectory's tail — cannot be written into a real
BP store. The steps after the rollback go to a **BP-lite sidecar** beside
the store instead:

* ``<store>.sidecar/`` is a BP-lite store of every step written after
  the rollback, with a ``sidecar.json`` marker recording ``keep_base``,
  how many leading steps of the base store stay live;
* ``open_writer`` makes or extends the sidecar when a rollback-append
  targets a real BP store, and sends every later append there (base
  steps after sidecar steps would break the order);
* ``open_reader`` returns a :class:`MergedReader` that serves
  ``base[0:keep_base] + sidecar[*]`` as one step sequence, so pdfcalc,
  gdsplot and the restart's step count see one consistent store.

The base store stays a valid BP store for any ADIOS2/Fides tool, which
also shows the rolled-back tail; readers of this package see the merged
sequence. The sidecar is a BP-lite store with its own integrity ledger
(``integrity[.<w>].json``), so its reads are CRC-checked; the ADIOS2 base
records no CRCs and reads unchecked.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

from .bplite import BpReader, StepStatus, _md_path

_MARKER = "sidecar.json"


def sidecar_path(path: str) -> str:
    return path.rstrip("/") + ".sidecar"


def read_keep_base(path: str) -> Optional[int]:
    """``keep_base`` from the sidecar marker of store ``path``; None when
    there is no marker or it is damaged (JSON of the wrong shape
    included), which reads as no sidecar."""
    try:
        with open(os.path.join(sidecar_path(path), _MARKER),
                  encoding="utf-8") as f:
            return int(json.load(f)["keep_base"])
    except (FileNotFoundError, NotADirectoryError, KeyError, ValueError,
            TypeError):
        return None


def write_keep_base(path: str, keep_base: int) -> None:
    """Write the sidecar marker of store ``path`` atomically."""
    side = sidecar_path(path)
    os.makedirs(side, exist_ok=True)
    tmp = os.path.join(side, _MARKER + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"keep_base": int(keep_base),
                   "base": os.path.basename(path.rstrip("/"))}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(side, _MARKER))


def remove_sidecar(path: str) -> None:
    """Delete the sidecar of store ``path`` (a fresh write there): a stale
    marker would graft the old run's tail onto the new store. Errors are
    ignored: the processes of a multi-writer run all open the same path
    and may delete under one another."""
    side = sidecar_path(path)
    if os.path.isdir(side):
        shutil.rmtree(side, ignore_errors=True)


def sidecar_reader(path: str, *, live: bool = False):
    """A BP-lite reader of the sidecar of store ``path``, or None while
    the sidecar has no committed metadata (a marker written just before
    the writer's first flush)."""
    side = sidecar_path(path)
    if not os.path.isfile(_md_path(side)):
        return None
    return BpReader(side, wait_for_writer=live)


class MergedReader:
    """``base[0:keep_base] + side[*]`` behind the reader API of
    ``BpReader`` and ``Adios2Reader`` (streaming ``begin_step`` /
    ``end_step`` and random-access ``get(step=...)``), each step index
    served by the store that holds it.

    ``side`` may be None (a marker with no committed sidecar metadata
    yet): the merged store is then the capped base, and the cap hides the
    rolled-back tail. ``reattach`` (live readers) is retried at each
    ``begin_step`` while ``side`` is None, which returns NOT_READY, not
    END_OF_STREAM, meanwhile.
    """

    def __init__(self, base, side, keep_base: int, *, reattach=None):
        self.base = base
        self.side = side
        self.keep_base = int(keep_base)
        self._reattach = reattach
        self._consumed = 0
        self._in_step = False

    # -- streaming ---------------------------------------------------------

    def begin_step(self, timeout: float = 10.0) -> StepStatus:
        if self._in_step:
            raise RuntimeError("begin_step with a step already open")
        if self._consumed < self.keep_base:
            self._in_step = True
            return StepStatus.OK
        if self.side is None and self._reattach is not None:
            self.side = self._reattach()
        if self.side is None:
            return (StepStatus.NOT_READY if self._reattach is not None
                    else StepStatus.END_OF_STREAM)
        status = self.side.begin_step(timeout=timeout)
        if status == StepStatus.OK:
            self._in_step = True
        return status

    def current_step(self) -> int:
        return self._consumed

    def end_step(self) -> None:
        if not self._in_step:
            raise RuntimeError("end_step without an open step")
        if self._consumed >= self.keep_base:
            self.side.end_step()
        self._in_step = False
        self._consumed += 1

    # -- inquiry -----------------------------------------------------------

    def attributes(self):
        out = dict(self.base.attributes())
        if self.side is not None:
            out.update(self.side.attributes())
        return out

    def available_variables(self):
        out = dict(self.base.available_variables())
        if self.side is not None:
            out.update(self.side.available_variables())
        return out

    def inquire_variable(self, name: str):
        return self.available_variables().get(name)

    def num_steps(self) -> int:
        return self.keep_base + (0 if self.side is None
                                 else self.side.num_steps())

    def set_selection(self, name, start, count) -> None:
        self.base.set_selection(name, start, count)
        if self.side is not None:
            self.side.set_selection(name, start, count)

    # -- data --------------------------------------------------------------

    def get(self, name: str, *, step: Optional[int] = None, start=None,
            count=None):
        if step is None:
            if not self._in_step:
                raise RuntimeError(
                    "get outside begin_step/end_step (or pass step=...)")
            if self._consumed < self.keep_base:
                return self.base.get(name, step=self._consumed, start=start,
                                     count=count)
            # The sidecar's reader has its own step open.
            return self.side.get(name, start=start, count=count)
        if not 0 <= step < self.num_steps():
            raise IndexError(f"step {step} out of range")
        if step < self.keep_base:
            return self.base.get(name, step=step, start=start, count=count)
        return self.side.get(name, step=step - self.keep_base, start=start,
                             count=count)

    def close(self) -> None:
        self.base.close()
        if self.side is not None:
            self.side.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
