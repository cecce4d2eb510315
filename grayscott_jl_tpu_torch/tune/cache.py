"""Persistent tuning cache: one JSON file per tuning key (counterpart of
``grayscott_jl_tpu/tune/cache.py``).

Layout: ``<cache_dir>/v<SCHEMA_VERSION>/<digest>.json``, the digest a
sha1 of the canonical key JSON. The key carries every knob that changes
what a measurement means — device kind, platform, mesh, L, dtype,
noise, torch and CUDA versions, model, the placement, the postures and
the generator version — so a config drift is a miss, never a wrong hit;
a schema bump orphans every older entry. The key names torch and CUDA
where the reference names jax, and the schema is this package's own, so
the two packages never read each other's entries.

A corrupt, truncated or wrong-shape file is a miss with a one-line
warning: tuning state never stops a run. Writes are atomic (a temp file
in the same directory, then ``os.replace``).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Optional

from ..config.env import env_str

#: Bump when the record layout or the meaning of a measurement changes;
#: older entries live under their own ``v<N>/`` and are never read. v2:
#: ensembles are measured (a batched launch per block and round), and a
#: winner may carry an adopted ``member_shards`` split.
SCHEMA_VERSION = 2


def cache_dir() -> str:
    """Cache root: ``GS_AUTOTUNE_CACHE``, else
    ``~/.cache/grayscott_tune_torch``."""
    raw = env_str("GS_AUTOTUNE_CACHE", "").strip()
    if raw:
        return os.path.expanduser(raw)
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "grayscott_tune_torch")


def cache_key(
    *,
    device_kind: str,
    platform: str,
    dims,
    L: int,
    dtype: str,
    noise: float,
    torch_version: str,
    cuda_version: Optional[str],
    ensemble: int = 1,
    model: str = "grayscott",
    n_fields: int = 2,
    halo_depth: int = 0,
    member_shards: int = 1,
    procs: int = 1,
    placement: str = "shared",
    cards: int = 1,
    compute_precision: str = "f32",
    snapshot_codec: str = "off",
    kernel_generator: int = 0,
) -> dict:
    """The canonical tuning key; every field joins the digest. As the
    reference's, with ``torch_version`` and ``cuda_version``
    (``torch.version.cuda``) for its ``jax_version``, and beside the
    process count the blocks' ``placement``
    (``parallel/icimodel.placement_of``) and the ``cards`` they span."""
    return {
        "schema": SCHEMA_VERSION,
        "device_kind": str(device_kind or ""),
        "platform": str(platform),
        "dims": [int(d) for d in dims],
        "L": int(L),
        "dtype": str(dtype),
        "noise": float(noise),
        "torch_version": str(torch_version),
        "cuda_version": None if cuda_version is None else str(cuda_version),
        "ensemble": int(ensemble),
        "model": str(model),
        "n_fields": int(n_fields),
        "halo_depth": int(halo_depth),
        "member_shards": int(member_shards),
        "procs": int(procs),
        "placement": str(placement),
        "cards": int(cards),
        "compute_precision": str(compute_precision),
        "snapshot_codec": str(snapshot_codec),
        "kernel_generator": int(kernel_generator),
    }


def key_digest(key: dict) -> str:
    blob = json.dumps(key, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()


def entry_path(key: dict, root: Optional[str] = None) -> str:
    root = cache_dir() if root is None else root
    return os.path.join(
        root, f"v{key.get('schema', SCHEMA_VERSION)}",
        key_digest(key) + ".json",
    )


def _warn(msg: str) -> None:
    print(f"gray-scott-torch: warning: {msg}", file=sys.stderr)


def load(key: dict, root: Optional[str] = None) -> Optional[dict]:
    """The cached record for ``key``, or None on a miss. A readable but
    invalid file (truncated JSON, wrong shape, another key, another
    schema) is a warned miss."""
    path = entry_path(key, root)
    try:
        with open(path, encoding="utf-8") as f:
            rec = json.load(f)
    except (FileNotFoundError, NotADirectoryError):
        return None
    except (OSError, json.JSONDecodeError) as e:
        _warn(f"tuning cache entry {path} unreadable ({e}); "
              "falling back to the analytic pick")
        return None
    if not isinstance(rec, dict) or rec.get("schema") != key["schema"] \
            or rec.get("key") != key or "winner" not in rec:
        _warn(f"tuning cache entry {path} is stale or malformed; "
              "falling back to the analytic pick")
        return None
    return rec


def store(key: dict, record: dict, root: Optional[str] = None) -> str:
    """Atomically write ``record`` for ``key``, stamped with the schema
    and the full key; returns the entry path. A crash between the write
    and the replace leaves a ``*.tmp.<pid>`` file no reader opens."""
    path = entry_path(key, root)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rec = dict(record)
    rec["schema"] = key["schema"]
    rec["key"] = dict(key)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    return path
