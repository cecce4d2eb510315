"""Typed ``GS_*`` env-knob accessors — the one sanctioned way to read
a knob outside a dedicated ``resolve_*`` helper.

Every environment knob the framework reads goes through either a
named resolver (``config/settings.py``'s ``resolve_*`` family, the
obs singletons' own resolution) or these accessors.  That keeps the
knob registry statically enumerable — the ``env-knobs`` gslint pass
(docs/ANALYSIS.md) collects reads from exactly these two shapes and
cross-checks them against the docs knob tables — and it keeps
parsing/precedence in one place instead of ad-hoc ``int(os.environ
.get(...))`` scattered through execution code.

Stdlib-only and JAX-free to import, like the rest of ``config/``.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = [
    "env_flag",
    "env_float",
    "env_int",
    "env_raw",
    "env_str",
]

#: Values :func:`env_flag` reads as true (mirrors the resilience
#: knobs' historical parsing).
_TRUTHY = ("1", "true", "yes", "on")


def env_raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """The raw knob value, or ``default`` when unset (``None`` by
    default, so "unset" stays distinguishable from "empty")."""
    return os.environ.get(name, default)


def env_str(name: str, default: str = "") -> str:
    """The knob as a string, ``default`` when unset."""
    return os.environ.get(name, default)


def env_int(name: str, default: Optional[int] = None) -> int:
    """The knob as an int.  Unset: ``default``, or ``KeyError`` when
    no default is given (required knobs, e.g. the distributed launch
    coordinates)."""
    raw = os.environ.get(name)
    if raw is None:
        if default is None:
            raise KeyError(name)
        return default
    return int(raw)


def env_float(name: str, default: Optional[float] = None) -> float:
    """The knob as a float; same unset semantics as :func:`env_int`."""
    raw = os.environ.get(name)
    if raw is None:
        if default is None:
            raise KeyError(name)
        return default
    return float(raw)


def env_flag(name: str, default: bool = False) -> bool:
    """The knob as a boolean (``1/true/yes/on``, case-insensitive)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in _TRUTHY
