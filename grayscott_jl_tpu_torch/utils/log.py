"""Minimal structured logging for the driver (counterpart of
``grayscott_jl_tpu/utils/log.py``).

``info`` prints only when the run is ``verbose``; ``warn`` always
prints. ``GS_LOG_FORMAT=json`` switches every line to one JSON object
(``{"ts", "t_rel_s", "level", "proc", "msg"}``); the default ``text``
keeps the ``[gray-scott +N.NNNs]`` prefix. This package runs one
process, so ``proc`` is always 0.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional

from ..config.env import env_str

LOG_FORMATS = ("text", "json")


class Logger:
    def __init__(self, verbose: bool = False, stream=None,
                 fmt: Optional[str] = None):
        self.verbose = verbose
        self.stream = stream or sys.stdout
        if fmt is None:
            fmt = env_str("GS_LOG_FORMAT", "text")
        fmt = (fmt or "text").strip().lower()
        if fmt not in LOG_FORMATS:
            raise ValueError(
                f"GS_LOG_FORMAT must be one of "
                f"{'|'.join(LOG_FORMATS)}, got {fmt!r}"
            )
        self.fmt = fmt
        self._t0 = time.perf_counter()

    def _emit(self, level: str, msg: str) -> None:
        dt = time.perf_counter() - self._t0
        if self.fmt == "json":
            print(
                json.dumps({
                    "ts": round(time.time(), 3),
                    "t_rel_s": round(dt, 3),
                    "level": level,
                    "proc": 0,
                    "msg": msg,
                }),
                file=self.stream, flush=True,
            )
        else:
            tag = "" if level == "info" else f" {level.upper()}:"
            print(f"[gray-scott +{dt:9.3f}s]{tag} {msg}",
                  file=self.stream, flush=True)

    def info(self, msg: str) -> None:
        if self.verbose:
            self._emit("info", msg)

    def warn(self, msg: str) -> None:
        self._emit("warn", msg)
