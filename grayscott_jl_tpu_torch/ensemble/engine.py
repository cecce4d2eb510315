"""Batched ensemble engine: N parameter sets of one model, every member
of a block advanced by ONE kernel launch per round (counterpart of
``grayscott_jl_tpu/ensemble/engine.py``).

The reference stacks a leading **member** axis onto the fields, params
and PRNG keys and ``vmap``-s the unchanged per-member step body over
it; with the Pallas kernel the batched ``pl.pallas_call`` gains a member
dimension in its grid. Here :class:`EnsembleSimulation` stacks the same
axis — fields ``(N, nx, ny, nz)`` per block, params with ``(N, 1, 1,
1)`` leaves (``ops/cuda_stencil.member_params``), key words as N-tuples
— and runs the solo step loop unchanged: ``Simulation._block_run`` and
``_sharded_run`` hand the member-stacked blocks to
``cuda_stencil.fused_step``, whose kernel takes the members on its
grid's y axis (one launch per block and round, whatever N is), and the
halo exchange and the temporal chains carry the axis along
(``parallel/``, which has no code that knows of members). Off the card
the plain versions broadcast over the same axis.

``member_shards = m`` splits the selected devices' block slots into
``m`` groups; group ``g`` holds members ``[g N/m, (g + 1) N/m)`` on the
spatial mesh of the remaining slots, and the groups advance one after
the other (members never exchange anything). Blocks are kept
group-major in :attr:`Simulation.blocks`.

Equality contract (the tests assert it bitwise): member ``k`` of an
N-member run equals a solo :class:`~..simulation.Simulation` with member
``k``'s params and seed ``base_seed + k`` on the same spatial mesh and
depth, so the member stores (``ensemble/io.py``) are byte-identical to
solo stores and restart, resume and the chaos byte-identity checks reuse
the solo machinery. A ``noise = 0`` member inside a noisy ensemble adds
an exact-zero noise term (the noise is traced in for the launch when any
member draws), as in the reference.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config.env import env_int
from ..config.settings import Settings
from ..obs import numerics as obs_numerics
from ..ops import cuda_stencil
from ..parallel import distributed
from ..parallel.domain import CartDomain
from ..parallel.mesh import DeviceMesh
from ..resilience.health import EnsembleHealthReport, member_probe, report_of
from ..simulation import (FieldSnapshot, Simulation, _host, _host_dtype,
                          _numerics_of, base_key)
from . import spec as ensemble_spec

#: Name of the member axis (the reference's mesh axis in front of the
#: spatial ``('x', 'y', 'z')`` axes).
MEMBER_AXIS = "m"


class EnsembleFieldSnapshot(FieldSnapshot):
    """A member-stacked snapshot: each part's offsets and sizes carry the
    member range in front of the spatial box, and the probes resolve
    per member."""

    #: Per-slot activity mask (None: every slot is a real member), and
    #: each block's member range ``(first, count)``, stamped by
    #: :meth:`EnsembleSimulation.snapshot_async`.
    member_active = None
    member_ranges: List[Tuple[int, int]] = []
    #: The run's member count (a process of a run of several may hold
    #: some members' blocks only).
    member_count = None

    def _member_rows(self, off: int, width: int,
                     identity=None) -> List[list]:
        """Per member, the probe rows ``[off, off + width)`` of every
        block this process holds of it; a member it holds no block of
        gets the one row ``identity``, when given (the merge's neutral
        row, so that every process makes the same collectives)."""
        n = self.member_count or max(m0 + nm for m0, nm in self.member_ranges)
        rows: List[list] = [[] for _ in range(n)]
        for (m0, nm), mat in zip(self.member_ranges, self._scalars()):
            mat = np.asarray(mat).reshape(nm, -1)
            for j in range(nm):
                rows[m0 + j].append(mat[j, off:off + width])
        if identity is not None:
            rows = [r or [np.asarray(identity, dtype=np.float64)]
                    for r in rows]
        return rows

    def health_report(self):
        """Per-member :class:`~..resilience.health.EnsembleHealthReport`
        (or None): one diverging member is named by its index; idle
        slots are masked out."""
        if not self._health:
            return None
        if self._report is None:
            width = 1 + 2 * len(self.field_names)
            # finite, then each field's (min, max): neutral for the merge.
            identity = [1.0] + [np.inf, -np.inf] * len(self.field_names)
            self._report = EnsembleHealthReport(
                [report_of(rows, self.field_names, reduce=self._reduce_probe)
                 for rows in self._member_rows(0, width, identity)],
                active=self.member_active)
        return self._report

    def numerics_report(self):
        """Per-member numerics statistics aggregated over the active
        members (:meth:`~..obs.numerics.NumericsReport.aggregate_members`;
        ``members`` keeps each member's rows)."""
        if not self._numerics:
            return None
        if self._numerics_report is None:
            n = len(self.field_names)
            off = (1 + 2 * n if self._health else 0) + (
                n if self._checksum else 0)
            width = len(obs_numerics.PARTIALS) * n
            members = [_numerics_of(rows, self.field_names,
                                    self._gather).fields
                       for rows in self._member_rows(
                           off, width, obs_numerics.identity_partials(n))]
            self._numerics_report = (
                obs_numerics.NumericsReport.aggregate_members(
                    members, active=self.member_active))
        return self._numerics_report

    def checksum_report(self):
        """Per-member device checksums ``[{field: int}, ...]``: the
        ensemble writers route member ``k``'s to member ``k``'s
        stores."""
        if not self._checksum:
            return None
        n = len(self.field_names)
        off = 1 + 2 * n if self._health else 0
        out = []
        for rows in self._member_rows(off, n):
            totals = [0] * n
            for row in rows:
                for i in range(n):
                    totals[i] = (totals[i] + int(row[i])) % (1 << 32)
            out.append(dict(zip(self.field_names, totals)))
        return out

    def _verify(self, hosts) -> None:
        """Each member's landed bytes against its device checksum, so
        that corruption in flight is named by member."""
        from ..resilience.integrity import CorruptionError, host_field_checksum

        want = self.checksum_report()
        got = [[0] * len(self.field_names) for _ in want]
        for offs, _, *arrs in hosts:
            for fi, arr in enumerate(arrs):
                for j in range(arr.shape[0]):
                    got[offs[0] + j][fi] = (got[offs[0] + j][fi]
                                            + host_field_checksum(arr[j])
                                            ) % (1 << 32)
        for i, row in enumerate(want):
            for fi, name in enumerate(self.field_names):
                if row[name] != got[i][fi]:
                    raise CorruptionError(
                        f"device-side field checksum mismatch: device "
                        f"{row[name]:#010x}, host {got[i][fi]:#010x} — "
                        "snapshot bytes were silently corrupted in flight",
                        step=self.step, var=name, member=i)


def member_blocks(blocks, member: int) -> list:
    """One member's solo-format ``(offsets, sizes, *fields)`` blocks from
    member-stacked snapshot blocks (each covering a member range
    ``[offsets[0], offsets[0] + sizes[0])``): exactly what a solo run's
    snapshot yields, which keeps member stores byte-identical to solo
    stores."""
    out = []
    for offsets, sizes, *fblocks in blocks:
        off_m, n_m = offsets[0], sizes[0]
        if off_m <= member < off_m + n_m:
            i = member - off_m
            out.append((tuple(offsets[1:]), tuple(sizes[1:]))
                       + tuple(fb[i] for fb in fblocks))
    return out


class MemberGroupMesh(DeviceMesh):
    """The block slots of a ``member_shards = m`` run: ``m`` groups of
    the spatial mesh's blocks, group-major, as the reference's ``(m, dx,
    dy, dz)`` mesh lists them. ``devices`` lists the slots this process
    holds, from global slot ``first_slot`` on; in a run of several
    processes the slots are shared out in order, so a process holds
    whole groups (:attr:`held` lists them) or a share of one group's
    blocks, whose exchange then crosses processes
    (``parallel/distributed.p2p``), as a solo mesh's does. :meth:`group`
    is each held group's :class:`~..parallel.mesh.DeviceMesh`."""

    def __init__(self, dims, devices, groups: int, *, first_slot: int = 0,
                 processes: int = 1):
        self.dims = tuple(int(d) for d in dims)
        self.devices = [torch.device(d) for d in devices]
        self._side_streams = {}
        n = len(self.devices)
        nb = self.dims[0] * self.dims[1] * self.dims[2]
        if n * processes != nb * groups:
            raise ValueError(
                f"{groups} member groups of a {self.dims} mesh take "
                f"{nb * groups} block slots; got {n}"
                + (f" in each of {processes} processes"
                   if processes > 1 else ""))
        if n % nb and nb % n:
            raise ValueError(
                f"a process's {n} block slots neither hold whole member "
                f"groups of {nb} blocks nor share one group evenly")
        self.first_process = 0
        if n >= nb:
            # Whole groups: each held group's mesh is in this process.
            g0 = first_slot // nb
            self.held = list(range(g0, g0 + n // nb))
            self.first_rank = 0
            self._share = nb
            self.groups = {g: DeviceMesh(self.dims,
                                         self.devices[i * nb:(i + 1) * nb],
                                         first_process=first_slot // n)
                           for i, g in enumerate(self.held)}
        else:
            # A share of one group, whose processes exchange its halos.
            g = first_slot // nb
            self.held = [g]
            self.first_rank = first_slot % nb
            self._share = n
            self.groups = {g: DeviceMesh(
                self.dims, self.devices, first_rank=self.first_rank,
                processes=nb // n, first_process=g * nb // n)}

    @property
    def spatial_share(self) -> int:
        return self._share

    def group(self, g: int) -> DeviceMesh:
        return self.groups[g]

    def census(self):
        return [sum(c) for c in zip(*(m.census()
                                      for m in self.groups.values()))]

    def ppermute(self, tensors, axis, shift):
        raise ValueError("members exchange nothing: a halo exchange runs "
                         "on one member group's mesh")


class EnsembleSimulation(Simulation):
    """N independent parameter sets of one model, advancing in one
    kernel launch per block and round."""

    snapshot_cls = EnsembleFieldSnapshot
    is_ensemble = True

    def __init__(self, settings: Settings, *,
                 n_devices: Optional[int] = None, seed: int = 0,
                 mesh_dims: Optional[Tuple[int, int, int]] = None,
                 devices=None):
        ens = getattr(settings, "ensemble", None)
        if ens is None:
            raise ValueError("EnsembleSimulation requires settings.ensemble "
                             "(an [ensemble] TOML table)")
        self.ens: ensemble_spec.EnsembleSettings = ens
        self.n_members = ens.n
        self.member_shards = int(ens.member_shards)
        self.member_seeds = ensemble_spec.resolve_seeds(ens, seed)
        #: Per-slot activity mask (None: all real): idle slots advance in
        #: the same launches but write no stores and count in no health
        #: verdict or aggregate throughput.
        self.member_active = None if all(ens.active) else tuple(ens.active)
        self._group_index = None
        super().__init__(settings, n_devices=n_devices, seed=seed,
                         mesh_dims=mesh_dims, devices=devices)
        self._build_groups()

    @property
    def active_member_count(self) -> int:
        """Real (non-idle) members: what aggregate throughput counts."""
        return self.ens.active_n

    # ------------------------------------------------- construction hooks

    def _make_domain(self, n_global: int, dims=None) -> CartDomain:
        m = self.member_shards
        if n_global % m:
            raise ValueError(f"member_shards = {m} does not divide the "
                             f"{n_global} selected block slots")
        # The member groups take their slots in front; the spatial
        # decomposition (the halo exchange, the kernel's modes, Auto's
        # mesh) sees the rest, with solo semantics underneath.
        return CartDomain.create(n_global // m, self.settings.L, dims=dims)

    def _build_mesh(self, devices, first: int = 0) -> DeviceMesh:
        if self.member_shards == 1:
            return super()._build_mesh(devices, first)
        return MemberGroupMesh(self.domain.dims, devices, self.member_shards,
                               first_slot=first, processes=self.processes)

    @property
    def _held(self) -> List[int]:
        """The member groups this process holds (all in one process)."""
        if self.member_shards == 1:
            return [0]
        return self.mesh.held

    def _group_members(self, g: Optional[int]) -> range:
        """The members of group ``g`` (None: every member)."""
        if g is None:
            return range(self.n_members)
        per = self.n_members // self.member_shards
        return range(g * per, (g + 1) * per)

    def _make_params(self, device):
        """Member-stacked params of the run's model at the compute dtype
        (``cuda_stencil.member_params``), of the current group."""
        rows = [self.ens.members[i].params()
                for i in self._group_members(self._group_index)]
        return cuda_stencil.member_params(rows, self.model.params_cls,
                                          self.compute_dtype, device)

    def _resolve_use_noise(self) -> bool:
        # One launch for all members: the noise is traced in if any
        # member draws (a noise = 0 member then adds an exact zero).
        return any(m.value("noise") != 0.0 for m in self.ens.members)

    def _make_base_key(self, seed: int):
        """The members' key words as N-tuples ``(k0s, k1s)`` (each member
        ``base_key(seed_k)``, so member k draws a solo run's stream)."""
        keys = [base_key(self.member_seeds[i])
                for i in self._group_members(self._group_index)]
        return (tuple(k[0] for k in keys), tuple(k[1] for k in keys))

    def _init_fields(self) -> List[tuple]:
        """Member-stacked initial blocks: the model's init of each block
        once, broadcast to the members (its seed pattern depends on L
        only), group-major."""
        L = self.settings.L
        per = self.n_members // self.member_shards
        nb = len(self.offsets)
        out = []
        for i, _ in enumerate(self._held):
            for offs, dev in zip(self.offsets,
                                 self.mesh.devices[i * nb:(i + 1) * nb]):
                if self.sharded:
                    blk = self.model.init(L, self.dtype, offsets=offs,
                                          sizes=self.domain.local_shape,
                                          device=dev)
                else:
                    blk = self.model.init(L, self.dtype, device=dev)
                out.append(tuple(f.unsqueeze(0).expand((per,) + f.shape)
                                 .contiguous() for f in blk))
        return out

    def _tune_extras(self) -> dict:
        return {"ensemble": self.n_members,
                "member_shards": self.member_shards,
                "sim_cls": type(self)}

    def _apply_tune_extras(self, decision) -> None:
        """Adopt a measured ``member_shards`` split before the blocks are
        built."""
        m = getattr(decision, "member_shards", None)
        if m is None or int(m) == self.member_shards:
            return
        m = int(m)
        total = self.domain.n_blocks * self.member_shards
        n = len(self.mesh.devices)
        if self.n_members % m or total % m or (n % (total // m)
                                               and (total // m) % n):
            return  # infeasible for this run's slots and members
        devices = self.mesh.devices
        first = distributed.process_index() * n
        self.member_shards = m
        self.domain = CartDomain.create(total // m, self.settings.L)
        self.mesh = self._build_mesh(devices, first)
        self.sharded = self.domain.n_blocks > 1
        decision.provenance["adopted_member_shards"] = m

    def _build_groups(self) -> None:
        """Each member group's params (on every device of the run, so
        that a replay on rotated devices finds them) and key words."""
        self._groups = []
        if self.member_shards == 1:
            return
        devices = list(dict.fromkeys(self.mesh.devices))
        for g in range(self.member_shards):
            self._group_index = g
            self._groups.append(({d: self._make_params(d) for d in devices},
                                 self._make_base_key(0)))
        self._group_index = None

    @contextlib.contextmanager
    def _group(self, g: int):
        """Run as member group ``g`` alone: its mesh, params and keys."""
        saved = (self.mesh, self._params, self.params, self.base_key,
                 self.device)
        params, keys = self._groups[g]
        mesh = self.mesh.group(g)
        self.mesh, self._params, self.base_key = mesh, params, keys
        self.device = mesh.devices[0]
        self.params = params[self.device]
        try:
            yield
        finally:
            (self.mesh, self._params, self.params, self.base_key,
             self.device) = saved

    def _run_blocks(self, blocks, nsteps: int) -> List[tuple]:
        if self.member_shards == 1:
            return super()._run_blocks(blocks, nsteps)
        nb = len(self.offsets)
        out = []
        rounds = None
        # This process's groups only: another process's exchange rounds
        # involve it only where a group spans both.
        for i, g in enumerate(self._held):
            with self._group(g):
                out += super()._run_blocks(blocks[i * nb:(i + 1) * nb],
                                           nsteps)
            if rounds is None:
                rounds = self.exchange_rounds
        # The groups make the same rounds: count one group's.
        self.exchange_rounds = rounds
        return out

    # --------------------------------------------------- snapshot hooks

    def _probe_fn(self, fields) -> torch.Tensor:
        return member_probe(*fields)

    def _partials_fn(self, fields) -> torch.Tensor:
        return obs_numerics.member_partials(*fields)

    def _checksum_fn(self, fields) -> torch.Tensor:
        from ..resilience.integrity import member_field_checksum

        return member_field_checksum(*fields).to(torch.float64)

    def _member_site(self, member: int) -> Tuple[int, int]:
        """``(group, index in the group)`` of ``member``."""
        per = self.n_members // self.member_shards
        return member // per, member % per

    def _group_of_block(self, r: int) -> int:
        """The member group of this process's block ``r``."""
        return self._held[r // len(self.offsets)]

    def _first_block(self, g: int) -> Optional[int]:
        """This process's first block of member group ``g``, or None when
        another process holds the group."""
        held = self._held
        return held.index(g) * len(self.offsets) if g in held else None

    def _bitflip_site(self):
        """The member-addressable ``bitflip``: member ``GS_FAULT_MEMBER``
        (default 0) of the first block of its group, so that detection
        names it while the other members verify clean."""
        g, j = self._member_site(env_int("GS_FAULT_MEMBER", 0)
                                 % self.n_members)
        # A member another process holds: this process flips its first
        # block's member j.
        return self._first_block(g) or 0, (j, 0, 0, 0)

    def _snapshot_boxes(self) -> List[Tuple[tuple, tuple]]:
        """Each block's part: the member range in front of its spatial
        box."""
        per = self.n_members // self.member_shards
        boxes = self.local_boxes()
        return [((g * per,) + tuple(offs), (per,) + tuple(true))
                for g in self._held for offs, true in boxes]

    def local_boxes(self) -> List[Tuple[tuple, tuple]]:
        first = self.mesh.first_rank
        return self.block_boxes()[first:first + len(self.offsets)]

    def snapshot_async(self, **kw):
        """The member-stacked snapshot, with the activity mask stamped on
        for the per-member resolution downstream."""
        snap = super().snapshot_async(**kw)
        snap.member_active = self.member_active
        snap.member_count = self.n_members
        snap.member_ranges = [(offs[0], true[0])
                              for offs, true in self._snapshot_boxes()]
        return snap

    def numerics_stats(self):
        """One numerics probe of the live fields, per member, aggregated
        over the active members."""
        per = self.n_members // self.member_shards
        rows: List[list] = [[] for _ in range(self.n_members)]
        for r, fields in enumerate(self.blocks):
            mat = obs_numerics.member_partials(*fields).cpu().numpy()
            for j in range(per):
                rows[self._group_of_block(r) * per + j].append(mat[j])
        gather = distributed.all_gather_f64 if self.processes > 1 else None
        names = self.model.field_names
        members = [_numerics_of(r or [obs_numerics.identity_partials(
            len(names))], names, gather).fields for r in rows]
        return obs_numerics.NumericsReport.aggregate_members(
            members, active=self.member_active)

    def block_checksums(self, blocks=None) -> List[tuple]:
        """Per block, each member's row of field checksums."""
        from ..resilience.integrity import member_field_checksum

        blocks = self.blocks if blocks is None else blocks
        return [tuple(tuple(int(x) for x in row)
                      for row in member_field_checksum(*fields).cpu())
                for fields in blocks]

    def diverging_members(self, live, replay) -> List[int]:
        """The members whose checksum rows differ between two
        :meth:`block_checksums` lists (the SDC screen's attribution)."""
        per = self.n_members // self.member_shards
        out = set()
        for r, (a, b) in enumerate(zip(live, replay)):
            for j, (x, y) in enumerate(zip(a, b)):
                if x != y:
                    out.add(self._group_of_block(r) * per + j)
        return sorted(out)

    def metrics_labels(self) -> dict:
        """Solo labels plus the member count: a batched step does N
        members of work per sample."""
        return {**super().metrics_labels(), "members": str(self.n_members)}

    # ------------------------------------------------------------ fields

    @property
    def fields(self) -> Tuple[torch.Tensor, ...]:
        if self.member_shards > 1:
            raise ValueError("a member_shards > 1 run holds its members in "
                             "groups of blocks: use .blocks or get_fields()")
        return super().fields

    @fields.setter
    def fields(self, value) -> None:
        Simulation.fields.fset(self, value)

    def get_fields(self) -> Tuple[np.ndarray, ...]:
        """Host ``(N, L, L, L)`` copies of the model's fields, the storage
        pad stripped."""
        if self.processes > 1:
            return super().get_fields()
        L = self.settings.L
        per = self.n_members // self.member_shards
        nb = len(self.offsets)
        storage = (self.domain.storage_shape if self.sharded else (L,) * 3)
        out = [np.empty((self.n_members,) + tuple(storage),
                        dtype=_host_dtype(self.dtype))
               for _ in range(self.model.n_fields)]
        for r, fields in enumerate(self.blocks):
            g, offs = r // nb, self.offsets[r % nb]
            for o, f in zip(out, fields):
                o[(slice(g * per, (g + 1) * per),) + tuple(
                    slice(s, s + n) for s, n in zip(offs, f.shape[1:]))] = (
                    _host(f))
        return tuple(o[:, :L, :L, :L] for o in out)

    def member_fields(self, member: int):
        """Host fields of one member: a solo run's ``get_fields``."""
        return tuple(f[member] for f in self.get_fields())

    def poison_nan(self, field="u", member: Optional[int] = None) -> None:
        """The ``nan`` fault on ONE member (default ``GS_FAULT_MEMBER``,
        else member 0): its global cell (0, 0, 0) becomes NaN, for the
        per-member health attribution; the other members are
        untouched."""
        if member is None:
            member = env_int("GS_FAULT_MEMBER", 0)
        g, j = self._member_site(int(member) % self.n_members)
        i = self._field_index(field)
        first = self._first_block(g)
        if first is None:
            return  # the process that holds the member poisons it
        for r, offs in enumerate(self.offsets):
            if any(offs):
                continue
            fields = list(self.blocks[first + r])
            poisoned = fields[i].clone()
            poisoned[j, 0, 0, 0] = float("nan")
            fields[i] = poisoned
            self.blocks[first + r] = tuple(fields)

    def _sdc_site(self, device=None) -> Tuple[str, int]:
        """With ``GS_FAULT_MEMBER`` set, the highest-ranked block of that
        member's group (on ``device`` when it holds one), so that the
        injection record names the device that holds the poisoned
        cell."""
        from ..resilience.sdc import device_name

        member = env_int("GS_FAULT_MEMBER", -1)
        if member < 0:
            return super()._sdc_site(device)
        g, _ = self._member_site(member % self.n_members)
        nb = len(self.offsets)
        ranks = range(g * nb, (g + 1) * nb)
        names = [device_name(self.mesh.devices[r]) for r in ranks]
        mine = [r for r, n in zip(ranks, names) if n == device]
        r = max(mine or ranks)
        return device_name(self.mesh.devices[r]), r

    def _sdc_index(self, r: int, arr) -> tuple:
        """The centre of the block, in member ``GS_FAULT_MEMBER`` when
        set (else the block's middle member)."""
        member = env_int("GS_FAULT_MEMBER", -1)
        idx = tuple(n // 2 for n in arr.shape)
        if member >= 0:
            idx = (self._member_site(member % self.n_members)[1],) + idx[1:]
        return idx

    # ------------------------------------------------------------ repack

    def repack(self, settings: Settings, *, seed: int = 0) -> None:
        """Rebind this (already built) ensemble to a new member set: the
        members' params, keys and seeds are launch arguments, so a set
        with the same shape signature — member count, ``member_shards``,
        model, L, precision, schedule and noise tracing — reuses every
        built kernel and tensor map. Anything else raises."""
        ens = getattr(settings, "ensemble", None)
        if ens is None:
            raise ValueError("repack needs settings.ensemble")
        if ens.n != self.n_members or int(ens.member_shards) != (
                self.member_shards):
            raise ValueError(
                f"repack shape mismatch: built for {self.n_members} members "
                f"x {self.member_shards} shards, got {ens.n} x "
                f"{ens.member_shards}")
        if ens.model != self.ens.model:
            raise ValueError(f"repack model mismatch: built for "
                             f"{self.ens.model!r}, got {ens.model!r}")
        if settings.L != self.settings.L:
            raise ValueError(f"repack L mismatch: built for "
                             f"L={self.settings.L}, got L={settings.L}")
        for key in ("precision", "compute_precision", "kernel_language",
                    "comm_overlap", "halo_depth"):
            if getattr(settings, key) != getattr(self.settings, key):
                raise ValueError(
                    f"repack {key} mismatch: built for "
                    f"{getattr(self.settings, key)!r}, got "
                    f"{getattr(settings, key)!r}")
        old = self.ens
        self.ens = ens
        if self._resolve_use_noise() != self.use_noise:
            self.ens = old
            raise ValueError(
                "repack noise-tracing mismatch: the built launches "
                f"{'draw' if self.use_noise else 'draw no'} noise")
        self.settings = settings
        self.member_seeds = ensemble_spec.resolve_seeds(ens, seed)
        self.member_active = None if all(ens.active) else tuple(ens.active)
        self._params = {d: self._make_params(d)
                        for d in dict.fromkeys(self.mesh.devices)}
        self.params = self._params[self.device]
        self.base_key = self._make_base_key(seed)
        self._build_groups()
        self.blocks = self._init_fields()
        self.step = 0
        # A previous set's restore plan must not reach this one's stats.
        self.reshard = None

    # ----------------------------------------------------------- restore

    def member_init_fields(self):
        """Host initial fields of ONE member (the model's init depends on
        L only): what a grown member starts from at the resume step, the
        state a solo run begun there would hold."""
        return tuple(_host(f)
                     for f in self.model.init(self.settings.L, self.dtype))

    def restore_members(self, members: List, step: int) -> None:
        """Restore from per-member host field tuples (each field the true
        ``L^3`` domain, declaration order), scattered into the
        member-stacked blocks."""
        if len(members) != self.n_members:
            raise ValueError(f"restore_members got {len(members)} member "
                             f"states for {self.n_members} members")
        L = self.settings.L
        nf = self.model.n_fields
        for i, fields in enumerate(members):
            if len(fields) != nf:
                raise ValueError(
                    f"member {i} checkpoint has {len(fields)} fields; model "
                    f"{self.model.name!r} declares {nf}")
            for name, f in zip(self.model.field_names, fields):
                if np.shape(f) != (L, L, L):
                    raise ValueError(
                        f"member {i} checkpoint shape {name}="
                        f"{np.shape(f)} does not match L={L}")
        storage = self.domain.storage_shape if self.sharded else (L,) * 3
        stacked = []
        for j, bv in enumerate(self.model.boundaries):
            a = np.stack([np.asarray(m[j]) for m in members])
            stacked.append(np.pad(a, [(0, 0)] + [
                (0, g - L) for g in storage], constant_values=bv))
        per = self.n_members // self.member_shards
        block = self.domain.local_shape if self.sharded else (L,) * 3
        nb = len(self.offsets)
        blocks = []
        for r, dev in enumerate(self.mesh.devices):
            g, offs = self._group_of_block(r), self.offsets[r % nb]
            sl = (slice(g * per, (g + 1) * per),) + tuple(
                slice(o, o + b) for o, b in zip(offs, block))
            blocks.append(tuple(torch.tensor(a[sl], dtype=self.dtype,
                                             device=dev) for a in stacked))
        self.blocks = blocks
        self.step = int(step)

    def restore_fields(self, fields, step: int) -> None:
        raise ValueError("an ensemble restores per member: restore_members")
