"""Compute-path silent-data-corruption (SDC) screening, attribution and
device quarantine (counterpart of ``grayscott_jl_tpu/resilience/sdc.py``).

The integrity layer (``resilience/integrity.py``) guards bytes at rest;
a device that computes a wrong answer in silence gets its trajectory
checksummed and stored as truth. Every kernel of the port is
deterministic (no float atomics, every mode bitwise), so redundant
compute is a cheap screen: replay the rounds since the last boundary
and compare one exact checksum.

Modes (``GS_SDC_CHECK``, cadence ``GS_SDC_EVERY``):

* ``off``    — no screening (default).
* ``spot``   — every Nth write boundary, replay the steps since the
  previous boundary from a retained anchor with the same launches as the
  live run (``Simulation.replay_fields``) and compare the wrapped-uint32
  field checksums (``integrity.device_field_checksum``): an equality,
  not a tolerance.
* ``shadow`` — as spot, with the replay's blocks on a rotated
  block-to-device list of the same mesh (rotated until every block is on
  another device), so that a fault of one card cannot confirm itself. On
  one device there is nothing to rotate: the replay stays in place and
  ``shadow_degraded`` is recorded, as in the reference.

A mismatch is attributed by pulling the diverging blocks to the host and
bisecting over disjoint device subsets (:func:`bisect_failing`), then
taking the device with the most diverging words, and on it the block
rank with the most (a device may hold several blocks here: one card, or
the CPU). It raises :class:`SDCError` naming both; the supervisor
restarts from the last *verified* checkpoint, and a second attribution
to the same device quarantines it (:func:`quarantine_device`:
``GS_DEVICE_BLOCKLIST`` in this process, which
``parallel/mesh.select_devices`` and :func:`usable_devices` honour, and,
in a serving fleet, a ``quarantine/<device>`` document in
``GS_SERVE_FLEET_DIR`` that every member reads).

Knobs: ``GS_SDC_CHECK``, ``GS_SDC_EVERY``, ``GS_DEVICE_BLOCKLIST``
(comma-separated ``str(torch.device)`` names, e.g. ``cuda:1``) and
``GS_FAULT_DEVICE`` (the device the ``sdc`` chaos fault poisons; default
the highest-indexed device holding a block). Screening is armed only in
a run of one process, as in the reference.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config.env import env_int, env_raw, env_str
from ..ops import cuda_stencil

__all__ = [
    "SDCError",
    "Screener",
    "bisect_failing",
    "device_name",
    "feasible_dims",
    "quarantine_device",
    "resolve_blocklist",
    "resolve_fault_device",
    "resolve_sdc",
    "usable_devices",
]

_MODES = ("off", "spot", "shadow")

#: Fleet-namespace key prefix of the quarantine documents
#: (``serve/cluster.FleetKV``).
QUARANTINE_PREFIX = "quarantine/"


class SDCError(RuntimeError):
    """A replay disagreed with the live trajectory: some device computed
    a wrong answer in silence. ``device`` and ``block`` are the
    attribution (None when it could not be localized), ``member`` the
    diverging ensemble member (None for a solo run), ``step`` the
    boundary that failed and ``verified_step`` the last boundary the
    screen proved."""

    def __init__(self, detail: str, *, step: Optional[int] = None,
                 verified_step: Optional[int] = None,
                 device: Optional[str] = None, member: Optional[int] = None,
                 block: Optional[int] = None, mode: str = "spot") -> None:
        parts = [detail]
        if step is not None:
            parts.append(f"step={step}")
        if device is not None:
            parts.append(f"device={device}")
        if block is not None:
            parts.append(f"block={block}")
        if member is not None:
            parts.append(f"member={member}")
        parts.append(f"verified_step={verified_step}")
        super().__init__("; ".join(parts))
        self.detail = detail
        self.step = step
        self.verified_step = verified_step
        self.device = device
        self.block = block
        self.member = member
        self.mode = mode


def resolve_sdc(settings=None) -> dict:
    """``{"mode", "every"}`` from ``GS_SDC_CHECK``/``GS_SDC_EVERY`` (the
    environment wins) over the ``sdc_check``/``sdc_every`` keys; a bad
    value raises."""
    mode = env_str("GS_SDC_CHECK", "").strip().lower()
    if not mode:
        mode = str(getattr(settings, "sdc_check", "") or "").strip().lower()
    mode = mode or "off"
    if mode not in _MODES:
        raise ValueError(
            f"GS_SDC_CHECK={mode!r} is not one of {'/'.join(_MODES)}")
    if env_raw("GS_SDC_EVERY") is not None:
        every = env_int("GS_SDC_EVERY")
    else:
        every = int(getattr(settings, "sdc_every", 0) or 0) or 1
    if every < 1:
        raise ValueError(f"GS_SDC_EVERY={every} must be >= 1")
    return {"mode": mode, "every": every}


def resolve_fault_device(settings=None) -> Optional[str]:
    """The device the ``sdc`` fault poisons (``GS_FAULT_DEVICE``, e.g.
    ``cuda:0``), or None for the default."""
    name = env_str("GS_FAULT_DEVICE", "").strip()
    return name or None


def device_name(dev) -> str:
    """A device's name in attribution and quarantine:
    ``str(torch.device)`` with the index filled in (``cuda:1``,
    ``cpu``)."""
    import torch

    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def resolve_blocklist() -> frozenset:
    """The quarantined devices: ``GS_DEVICE_BLOCKLIST`` (comma-separated)
    joined with the ``quarantine/*`` documents of the serving fleet's
    namespace when one is armed (``GS_SERVE_FLEET_DIR``): one worker's
    attribution quarantines the device fleet-wide."""
    names = {tok.strip()
             for tok in env_str("GS_DEVICE_BLOCKLIST", "").split(",")
             if tok.strip()}
    fleet = env_str("GS_SERVE_FLEET_DIR", "")
    if fleet:
        try:
            from ..serve.cluster import FleetKV

            kv = FleetKV(fleet)
            for key in kv.keys("quarantine"):
                doc = kv.get(QUARANTINE_PREFIX + key)
                if isinstance(doc, dict) and doc.get("device"):
                    names.add(str(doc["device"]))
        except OSError:
            pass  # an unreadable namespace: the variable still applies
    return frozenset(names)


def quarantine_device(name: str, *, journal=None, step: Optional[int] = None,
                      reason: str = "") -> None:
    """Quarantine ``name``: add it to this process's
    ``GS_DEVICE_BLOCKLIST`` (an attempt in this process and a launched
    child both see it), publish the fleet's ``quarantine/<device>``
    document when serving (the first verdict wins; key ``cuda_0`` for
    ``cuda:0``), and journal ``device_quarantined``."""
    current = [tok.strip()
               for tok in env_str("GS_DEVICE_BLOCKLIST", "").split(",")
               if tok.strip()]
    if name not in current:
        current.append(name)
        os.environ["GS_DEVICE_BLOCKLIST"] = ",".join(current)
    fleet = env_str("GS_SERVE_FLEET_DIR", "")
    if fleet:
        try:
            from ..serve.cluster import FleetKV

            kv = FleetKV(fleet)
            key = QUARANTINE_PREFIX + name.replace(":", "_")
            if kv.get(key) is None:
                kv.put(key, {"device": name, "reason": reason, "step": step,
                             "t": round(time.time(), 3)})
        except OSError:
            pass  # the variable above is the fallback
    if journal is not None:
        journal.record(event="device_quarantined", kind="sdc", device=name,
                       step=step, reason=reason)


def usable_devices(kind: Optional[str] = None) -> list:
    """The devices of ``kind`` (``"cuda"`` or ``"cpu"``; by default the
    card when there is one) minus the quarantined ones."""
    import torch

    if kind is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    if kind == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(kind)]
    blocked = resolve_blocklist()
    return [d for d in devices if device_name(d) not in blocked]


def feasible_dims(max_blocks: int, L: int
                  ) -> Optional[Tuple[int, int, int]]:
    """The mesh dims of the largest ``n <= max_blocks`` that decomposes
    an ``L`` cube with true cells in every block, or None."""
    from ..parallel.domain import CartDomain

    for n in range(max_blocks, 0, -1):
        try:
            return CartDomain.create(n, L).dims
        except ValueError:
            continue
    return None


def bisect_failing(items: Sequence, healthy: Callable[[Tuple], bool]
                   ) -> List:
    """Every item the monotone predicate implicates, probing
    ``healthy(subset)`` on recursively halved disjoint subsets."""
    items = tuple(items)
    if not items:
        return []
    if healthy(items):
        return []
    if len(items) == 1:
        return [items[0]]
    mid = len(items) // 2
    return (bisect_failing(items[:mid], healthy)
            + bisect_failing(items[mid:], healthy))


def _bits(a: np.ndarray) -> np.ndarray:
    """The array's words as unsigned integers (equal NaNs compare
    equal)."""
    a = np.ascontiguousarray(a)
    return a.view(np.dtype(f"uint{a.dtype.itemsize * 8}"))


def _host_words(t) -> np.ndarray:
    """A block's field as host words (bfloat16 as its uint16 bits)."""
    import torch

    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.numpy())


class Screener:
    """The boundary screen, driven by the driver at each write boundary:

    1. :meth:`check` — on every ``every``-th boundary, replay the steps
       since the anchor (``Simulation.replay_fields``; ``shadow`` on the
       rotated device list) and compare the field checksums of every
       block. Equal: journal ``sdc_check`` and advance
       ``verified_step``. Unequal: attribute and raise :class:`SDCError`
       before any store sees the boundary.
    2. :meth:`rearm` — retain the live fields as the next anchor, after
       the boundary's ``nan``/``drift`` poisons, so that an injected
       fault the health and drift gates own is inside the anchor.

    The screen only reads the live blocks, so a screened run's stores
    are byte-identical to ``GS_SDC_CHECK=off``'s. The replay's kernel
    launches count in ``replay_launches`` (``describe()``, and so
    ``RunStats.config["sdc"]``), not in the run's launch counts
    (``ops/cuda_stencil.replaying``)."""

    def __init__(self, sim, *, mode: str = "spot", every: int = 1,
                 journal=None, log: Optional[Callable[[str], None]] = None):
        if mode not in _MODES or mode == "off":
            raise ValueError(f"Screener mode {mode!r}")
        self.mode = mode
        self.every = max(1, int(every))
        self.journal = journal
        self.log = log
        self.checks = 0
        self.mismatches = 0
        self.verified_step: Optional[int] = None
        #: Kernel launches of this screen's replays.
        self.replay_launches = 0
        #: Set when shadow mode replays in place: the mesh has one
        #: device, so there is nothing to rotate.
        self.shadow_degraded = False
        self._boundaries = 0
        self.rebind(sim)

    def rebind(self, sim) -> None:
        """Screen ``sim`` from now on (the driver swapped it in after a
        live move): the anchor and the shadow rotation belong to the
        old mesh, so the anchor is dropped until the next
        :meth:`rearm`."""
        self.sim = sim
        self._anchor: Optional[Tuple[int, list]] = None
        self._shadow: Optional[list] = None
        if self.mode == "shadow":
            # The smallest rotation of the block-to-device list that
            # moves every block to another device (a device may hold
            # several consecutive blocks); none on one device.
            devs = list(sim.mesh.devices)
            names = [device_name(d) for d in devs]
            n = len(devs)
            shift = next((k for k in range(1, n) if all(
                names[(i + k) % n] != names[i] for i in range(n))), None)
            self.shadow_degraded = shift is None
            if shift is not None:
                self._shadow = devs[shift:] + devs[:shift]

    def rearm(self, step: int) -> None:
        """Retain the live fields as the anchor of the next check."""
        self._anchor = (int(step), self.sim.retain_fields())

    def describe(self) -> dict:
        return {
            "mode": self.mode,
            "every": self.every,
            "checks": self.checks,
            "mismatches": self.mismatches,
            "verified_step": self.verified_step,
            "shadow_degraded": self.shadow_degraded,
            "replay_launches": self.replay_launches,
        }

    def check(self, step: int) -> bool:
        """Screen this boundary: True when a replay ran (the cadence was
        due and an anchor existed), False when skipped; raises
        :class:`SDCError` on a mismatch."""
        step = int(step)
        self._boundaries += 1
        if self._anchor is None:
            return False
        if self._boundaries % self.every:
            return False
        a_step, a_blocks = self._anchor
        nsteps = step - a_step
        if nsteps <= 0:
            return False
        n0 = cuda_stencil.REPLAY_LAUNCHES
        replay = self.sim.replay_fields(a_blocks, a_step, nsteps,
                                        devices=self._shadow)
        self.replay_launches += cuda_stencil.REPLAY_LAUNCHES - n0
        live_ck = self.sim.block_checksums(self.sim.blocks)
        rep_ck = self.sim.block_checksums(replay)
        self.checks += 1
        if live_ck == rep_ck:
            self.verified_step = step
            if self.journal is not None:
                self.journal.record(event="sdc_check", step=step,
                                    mode=self.mode, replayed_steps=nsteps,
                                    status="ok")
            return True
        self.mismatches += 1
        device, block, diverged = self._attribute(replay)
        # An ensemble's checksums are one row per member: the rows that
        # differ name the diverging member, with no more device work.
        diverging = getattr(self.sim, "diverging_members", None)
        members = diverging(live_ck, rep_ck) if diverging else []
        member = members[0] if members else None
        detail = (f"SDC screen ({self.mode}) mismatch: replay of {nsteps} "
                  f"step(s) from verified anchor at step {a_step} disagrees "
                  f"with the live trajectory ({diverged} diverging word(s) "
                  "localized)")
        if self.journal is not None:
            self.journal.record(event="sdc_mismatch", kind="sdc", step=step,
                                mode=self.mode, device=device, block=block,
                                member=member, replayed_steps=nsteps,
                                verified_step=self.verified_step)
        if self.log is not None:
            self.log(f"SDC mismatch at step {step} attributed to "
                     f"device={device} block={block}"
                     + (f" member={member}" if member is not None else ""))
        raise SDCError(detail, step=step, verified_step=self.verified_step,
                       device=device, block=block, member=member,
                       mode=self.mode)

    def _attribute(self, replay) -> Tuple[Optional[str], Optional[int], int]:
        """``(device, block rank, diverging words)``: bisect over the
        disjoint device subsets, then the failing device with the most
        diverging words, and its block with the most."""
        sim = self.sim
        first = sim.mesh.first_rank
        by_dev: Dict[str, list] = {}
        for r, dev in enumerate(sim.mesh.devices):
            by_dev.setdefault(device_name(dev), []).append(r)
        pulled: Dict[int, int] = {}

        def diff_words(r: int) -> int:
            if r not in pulled:
                pulled[r] = int(sum(
                    (_host_words(a) != _host_words(b)).sum()
                    for a, b in zip(sim.blocks[r], replay[r])))
            return pulled[r]

        def healthy(subset) -> bool:
            return all(diff_words(r) == 0 for dev in subset
                       for r in by_dev[dev])

        failing = bisect_failing(tuple(sorted(by_dev)), healthy)
        if not failing:
            return None, None, 0
        counts = {dev: sum(diff_words(r) for r in by_dev[dev])
                  for dev in failing}
        device = sorted(failing, key=lambda d: (-counts[d], d))[0]
        block = sorted(by_dev[device], key=lambda r: (-diff_words(r), r))[0]
        return device, first + block, sum(counts.values())
