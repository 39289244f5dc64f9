"""Content-keyed on-disk cache for expensive host-side solver setup.

Copy of ``pde_solver_tpu.utils.diskcache`` (numpy only).  The port caches
the constant-interior operator's host analysis through it
(``ops.cs_kernels.CSFlatStencilOperator.try_build``): the scan over the
per-node weight planes takes seconds at 2M DOF, and its artifacts are
small.  They persist across processes, keyed by the same content hashes
the in-memory caches use.

Entries are plain ``.npz`` files (no pickling — arrays only, plus one JSON
metadata string) written atomically (tmp + rename).  The directory is
bounded by total bytes with oldest-mtime eviction.

Env knobs:
  PDE_TPU_DISK_CACHE=0     disable entirely
  PDE_TPU_CACHE_DIR        directory (default ``build/cache`` in the
                           checkout, beside the built kernels: the port
                           writes nothing outside its checkout unless told)
  PDE_TPU_CACHE_MAX_GB     size bound (default 8)
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Dict, Optional

import numpy as np


def enabled() -> bool:
    return os.environ.get("PDE_TPU_DISK_CACHE", "1") not in ("0", "off",
                                                             "false")


def cache_dir() -> str:
    d = os.environ.get("PDE_TPU_CACHE_DIR")
    if not d:
        d = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "build", "cache")
    return d


def _digest(kind: str, key) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(kind.encode())
    h.update(repr(key).encode())
    return h.hexdigest()


def _path(kind: str, key) -> str:
    return os.path.join(cache_dir(), f"{kind}-{_digest(kind, key)}.npz")


def load(kind: str, key) -> Optional[Dict[str, np.ndarray]]:
    """Return the stored array dict (plus parsed ``meta``), or None."""
    if not enabled():
        return None
    path = _path(kind, key)
    try:
        if not os.path.exists(path):
            return None
        with np.load(path, allow_pickle=False) as z:
            out = {name: z[name] for name in z.files}
        out.pop("_key", None)
        meta_arr = out.pop("_meta", None)
        out["meta"] = (json.loads(str(meta_arr))
                       if meta_arr is not None else {})
        os.utime(path)  # LRU freshness for eviction
        return out
    except Exception:  # corrupt/partial entry → treat as miss
        try:
            os.remove(path)
        except OSError:
            pass
        return None


def store(kind: str, key, arrays: Dict[str, np.ndarray],
          meta: Optional[dict] = None) -> None:
    if not enabled():
        return
    d = cache_dir()
    try:
        os.makedirs(d, exist_ok=True)
        # suffix must be .npz — np.savez appends it otherwise and the
        # os.replace below would move an empty placeholder into place
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
        os.close(fd)
        payload = dict(arrays)
        payload["_key"] = np.frombuffer(
            _digest(kind, key).encode(), dtype=np.uint8)
        payload["_meta"] = np.asarray(json.dumps(meta or {}))
        np.savez(tmp, **payload)
        os.replace(tmp, _path(kind, key))
        _evict(d)
    except Exception:
        try:
            os.remove(tmp)
        except Exception:
            pass


def _evict(d: str) -> None:
    max_bytes = float(os.environ.get("PDE_TPU_CACHE_MAX_GB", 8)) * 2**30
    entries = []
    total = 0
    for name in os.listdir(d):
        if not name.endswith(".npz"):
            continue
        p = os.path.join(d, name)
        try:
            st = os.stat(p)
        except OSError:
            continue
        entries.append((st.st_mtime, st.st_size, p))
        total += st.st_size
    entries.sort()
    for _, size, p in entries:
        if total <= max_bytes:
            break
        try:
            os.remove(p)
            total -= size
        except OSError:
            pass
