"""Minimal structured logging for the driver (counterpart of
``grayscott_jl_tpu/utils/log.py``).

``info`` prints only when the run is ``verbose``, and in a run of
several processes only on process 0, as the reference's rank-0 output
does; ``warn`` always prints, on every process. ``GS_LOG_FORMAT=json``
switches every line to one JSON object (``{"ts", "t_rel_s", "level",
"proc", "msg"}``, ``proc`` the process index); the default ``text``
keeps the ``[gray-scott +N.NNNs]`` prefix.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional

from ..config.env import env_str
from ..parallel import distributed

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
                    "proc": distributed.process_index(),
                    "msg": msg,
                }),
                file=self.stream, flush=True,
            )
        else:
            tag = "" if level == "info" else f" {level.upper()}:"
            print(f"[gray-scott +{dt:9.3f}s]{tag} {msg}",
                  file=self.stream, flush=True)

    def info(self, msg: str) -> None:
        if self.verbose and distributed.process_index() == 0:
            self._emit("info", msg)

    def warn(self, msg: str) -> None:
        self._emit("warn", msg)
