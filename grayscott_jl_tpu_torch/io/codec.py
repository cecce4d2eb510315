"""Lossy snapshot codec (counterpart of ``grayscott_jl_tpu/io/codec.py``).

Each configured output field is quantized on the device to ``bits``
uniform levels before the boundary's device-to-host copy, so the bytes
that cross to the host and land in the store are a ``uint8``/``uint16``
payload. Per field and step::

    lo = min(f),  hi = max(f)                         (float32)
    q  = round((f - lo) * (2^bits - 1) / (hi - lo))   as uintN
    f' = lo + q * (hi - lo) / (2^bits - 1)            (decode)

The decode error of any cell is at most half a quantization level plus
the float32 arithmetic and one ulp of the storage dtype
(:func:`error_bound`). On a mesh ``lo``/``hi`` are the global min/max
over every block (the reference reduces the sharded array), so the
payload does not depend on the decomposition.

Store schema (the reference's): a coded variable is defined at its uint
payload dtype, two per-step float32 scalars ``<NAME>__qlo`` /
``<NAME>__qhi`` carry the range, and the store attribute
``snapshot_codec`` (JSON ``{name: {"bits": b, "dtype": d}}``) names the
coded variables and their original dtypes (``"bfloat16"`` for bf16
fields). ``io/bplite.BpReader.get`` decodes transparently.

Scope: plotgap output by default; ``snapshot_bits_ckpt`` /
``GS_SNAPSHOT_BITS_CKPT`` opts checkpoints in (a restart from them is
value-close, not bitwise). ``compute_precision = "equality"`` refuses
any codec.

Everything but :func:`device_quantize` is numpy and the standard
library; :func:`device_quantize` runs torch ops on the field's device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from .bplite import BF16, bf16_round, dtype_name

#: Store attribute naming the coded variables.
CODEC_ATTR = "snapshot_codec"

#: Valid quantization widths.
MIN_BITS, MAX_BITS = 2, 16


def qlo_var(name: str) -> str:
    """Per-step range-minimum scalar variable of coded ``name``."""
    return f"{name}__qlo"


def qhi_var(name: str) -> str:
    """Per-step range-maximum scalar variable of coded ``name``."""
    return f"{name}__qhi"


def payload_dtype(bits: int):
    """The uint payload dtype of a bit width."""
    return np.uint8 if bits <= 8 else np.uint16


def _eps(dtype) -> float:
    """Machine epsilon of a storage dtype (a numpy dtype, a torch dtype
    or its name); bfloat16's is 2**-7, as ``torch.finfo`` gives it."""
    name = dtype_name(dtype)
    if name == BF16:
        import torch

        return float(torch.finfo(torch.bfloat16).eps)
    try:
        return float(np.finfo(np.dtype(name)).eps)
    except (TypeError, ValueError):
        return 0.0  # non-float payloads


def error_bound(lo: float, hi: float, bits: int, dtype=None) -> float:
    """The max-abs decode error: half a quantization level, plus the
    float32 arithmetic of encoder and decoder at the range's magnitude,
    plus one ulp of the storage dtype (the decode's final rounding)."""
    mag = max(abs(lo), abs(hi), 1e-30)
    half_level = (hi - lo) / (2 ** bits - 1) / 2.0
    bound = half_level + float(np.finfo(np.float32).eps) * mag * 4
    if dtype is None:
        return bound
    return bound + _eps(dtype) * mag


def parse_bits_spec(raw: str, field_names: Sequence[str]) -> Dict[str, int]:
    """``"8"`` (every field) or ``"u:8,v:12"`` (per field; ``=`` also
    accepted) -> ``{field_name: bits}``. Unknown fields and widths
    outside [2, 16] raise naming the model's fields."""
    raw = (raw or "").strip()
    if not raw:
        return {}
    names = [n.lower() for n in field_names]

    def _bits(tok: str) -> int:
        try:
            b = int(tok)
        except ValueError as e:
            raise ValueError(
                f"snapshot_bits entry {tok!r} is not an integer"
            ) from e
        if not MIN_BITS <= b <= MAX_BITS:
            raise ValueError(
                f"snapshot_bits must be in [{MIN_BITS}, {MAX_BITS}], "
                f"got {b}"
            )
        return b

    if ":" not in raw and "=" not in raw:
        b = _bits(raw)
        return {n: b for n in names}
    out: Dict[str, int] = {}
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        sep = ":" if ":" in entry else "="
        fname, _, tok = entry.partition(sep)
        fname = fname.strip().lower()
        if fname not in names:
            raise ValueError(
                f"snapshot_bits names unknown field {fname!r} "
                f"(model fields: {', '.join(names)})"
            )
        out[fname] = _bits(tok.strip())
    return out


class CodecConfig:
    """A run's codec posture: ``output`` / ``ckpt`` map field names to
    bit widths (empty = exact)."""

    def __init__(self, output: Dict[str, int], ckpt: Dict[str, int]):
        self.output = dict(output)
        self.ckpt = dict(ckpt)

    @property
    def enabled(self) -> bool:
        return bool(self.output or self.ckpt)

    def describe(self) -> Optional[dict]:
        """The ``RunStats`` record; None when fully exact."""
        if not self.enabled:
            return None
        return {
            "output": dict(self.output),
            "checkpoint": dict(self.ckpt) if self.ckpt else None,
        }

    def posture(self) -> str:
        """``"off"`` or the sorted ``u:8,v:8[+ckpt]`` spelling."""
        if not self.output and not self.ckpt:
            return "off"
        spec = ",".join(f"{n}:{b}" for n, b in sorted(self.output.items()))
        return spec + ("+ckpt" if self.ckpt else "")


def resolve_snapshot_codec(settings, field_names) -> CodecConfig:
    """``GS_SNAPSHOT_BITS`` > ``snapshot_bits`` (and
    ``GS_SNAPSHOT_BITS_CKPT`` > ``snapshot_bits_ckpt``) ->
    :class:`CodecConfig`. ``compute_precision = "equality"`` refuses any
    codec with a :class:`~..models.base.SettingsError`."""
    raw = os.environ.get("GS_SNAPSHOT_BITS")
    if raw is None:
        raw = getattr(settings, "snapshot_bits", "") or ""
    output = parse_bits_spec(raw, field_names)
    raw_ck = os.environ.get("GS_SNAPSHOT_BITS_CKPT")
    if raw_ck is None:
        ckpt_on = bool(getattr(settings, "snapshot_bits_ckpt", False))
    else:
        ckpt_on = raw_ck.strip().lower() in ("1", "true", "yes", "on")
    ckpt = dict(output) if ckpt_on and output else {}
    if output:
        from ..config.settings import resolve_compute_precision
        from ..models.base import SettingsError

        if resolve_compute_precision(settings) == "equality":
            raise SettingsError(
                "compute_precision = 'equality' refuses the lossy "
                f"snapshot codec (snapshot_bits={raw!r}): equality "
                "asserts byte-identical trajectories AND stores — "
                "drop one of the two settings"
            )
    return CodecConfig(output, ckpt)


def codec_attr_value(codec: Dict[str, int], var_names, dtype) -> str:
    """The ``snapshot_codec`` attribute of a store whose variables are
    ``var_names`` (upper-cased) over fields stored at ``dtype`` (a
    numpy or torch dtype; bf16 is named ``"bfloat16"``). ``codec`` is
    keyed by lower-cased field name."""
    doc = {}
    for vn in var_names:
        bits = codec.get(vn.lower())
        if bits is not None:
            doc[vn] = {"bits": int(bits), "dtype": dtype_name(dtype)}
    return json.dumps(doc, sort_keys=True)


def decode_attr(attrs: dict) -> Dict[str, dict]:
    """A store's ``snapshot_codec`` attribute as ``{var_name: {"bits",
    "dtype"}}``; a missing or torn attribute reads as no codec."""
    raw = attrs.get(CODEC_ATTR)
    if not raw:
        return {}
    try:
        doc = json.loads(raw)
        return {
            str(k): {"bits": int(v["bits"]), "dtype": str(v["dtype"])}
            for k, v in doc.items()
        }
    except (ValueError, TypeError, KeyError):
        return {}


def device_quantize(blocks, bits: int, reduce_range=None):
    """The encoder over one field held as ``blocks`` (a list of tensors
    of one or more blocks, on any devices): ``(qs, lo, hi)`` with ``qs``
    the per-block payload tensors on their blocks' devices — ``uint8``,
    or ``int16`` holding the ``uint16`` bit pattern (torch has no
    general ``uint16``; view the host copy as ``uint16``) — and ``lo``,
    ``hi`` the global float32 min and max as Python floats. A constant
    field encodes to zeros and decodes to ``lo`` exactly. ``torch.round``
    rounds half to even, as ``jnp.round`` does. ``reduce_range(lo, hi)``
    widens the blocks' range to the other processes' (a run of several
    processes holds only its share of the blocks here)."""
    import torch

    blocks = list(blocks)
    lo_t = torch.stack([b.float().amin().cpu() for b in blocks]).amin()
    hi_t = torch.stack([b.float().amax().cpu() for b in blocks]).amax()
    if reduce_range is not None:
        lo, hi = reduce_range(float(lo_t), float(hi_t))
        lo_t = torch.tensor(lo, dtype=torch.float32)
        hi_t = torch.tensor(hi, dtype=torch.float32)
    levels = torch.tensor(float(2 ** bits - 1), dtype=torch.float32)
    span = hi_t - lo_t
    scale = levels / torch.where(span > 0, span,
                                 torch.tensor(1.0, dtype=torch.float32))
    qs = []
    for b in blocks:
        lo_d, scale_d = lo_t.to(b.device), scale.to(b.device)
        q = torch.clamp(torch.round((b.float() - lo_d) * scale_d), 0,
                        float(2 ** bits - 1))
        if bits <= 8:
            qs.append(q.to(torch.uint8))
        else:
            qi = q.to(torch.int32)
            qs.append(torch.where(qi >= 32768, qi - 65536, qi)
                      .to(torch.int16))
    return qs, float(lo_t), float(hi_t)


def dequantize(q, lo: float, hi: float, bits: int, dtype) -> np.ndarray:
    """Host-side decode of a uint payload at the original ``dtype``: the
    reference's arithmetic in float32, then rounded to ``dtype``. A
    ``bfloat16`` field decodes to a float32 array holding the bf16
    values (numpy has no bfloat16)."""
    level = (np.float32(hi) - np.float32(lo)) / np.float32(2 ** bits - 1)
    out = np.float32(lo) + np.asarray(q).astype(np.float32) * level
    if dtype_name(dtype) == BF16:
        return bf16_round(out)
    return out.astype(np.dtype(dtype_name(dtype)))


class EncodedField:
    """One field's quantized block on its way to a store: the uint
    payload, the step's (lo, hi) range, the bit width and the original
    dtype's name."""

    __slots__ = ("q", "lo", "hi", "bits", "dtype")

    def __init__(self, q: np.ndarray, lo: float, hi: float, bits: int,
                 dtype):
        self.q = q
        self.lo = float(lo)
        self.hi = float(hi)
        self.bits = int(bits)
        self.dtype = dtype_name(dtype)

    def decode(self) -> np.ndarray:
        """The values the store serves for this block (:func:`dequantize`)."""
        return dequantize(self.q, self.lo, self.hi, self.bits, self.dtype)


class BoundaryBlocks(list):
    """A boundary's snapshot: the exact blocks in the list body (empty
    when no target needed them) and the codec form on ``encoded`` (coded
    fields as :class:`EncodedField`, the others as arrays), or None when
    no codec ran; and the boundary's health report on ``health`` when
    the snapshot probed it (``Simulation.snapshot(health=True)``)."""

    encoded = None
    health = None
