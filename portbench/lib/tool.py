"""One request to a tool of the port, as the MCP server's ``tools/call``
makes it, and its answer on disk."""

from __future__ import annotations

import os
import pickle
import time
import traceback
from typing import Dict

import numpy as np


def call(tool: str, kwargs: Dict, overrides: Dict, req: Dict,
         units: int) -> Dict:
    """``api.<tool>(**kwargs)`` under ``config_overrides(**overrides)``.
    The record: ``ok`` (returned and converged), ``wall_s``, the tool's
    ``stats``, the answer's ``file`` and ``bytes``, ``units`` of work (time
    steps, solves) and the ``request``; a call that raised is recorded with
    its traceback, and the loop runs on."""
    from pde_solver_tpu_torch import api
    from pde_solver_tpu_torch.config import config_overrides

    t = time.perf_counter()
    try:
        with config_overrides(**overrides):
            res = getattr(api, tool)(**kwargs)
    except Exception as exc:  # a failed request counts, the loop runs on
        return {"ok": False, "wall_s": time.perf_counter() - t,
                "request": req, "units": 0,
                "error": "".join(traceback.format_exception(exc))}
    wall = time.perf_counter() - t
    stats = res.meta["solver_stats"]
    return {"ok": bool(stats.get("converged")), "wall_s": wall,
            "stats": stats, "request": req, "file": res.data_file,
            "units": units, "bytes": os.path.getsize(res.data_file)}


def values(rec: Dict):
    """The answer's (values [frames, N], times [frames]), float64."""
    with open(rec["file"], "rb") as f:
        field = pickle.load(f)
    return (np.asarray(field.values, np.float64),
            np.asarray(field.times, np.float64))


def finite(rec: Dict) -> bool:
    return "file" in rec and bool(np.isfinite(values(rec)[0]).all())


def discard(rec: Dict) -> None:
    path = rec.get("file")
    if path and os.path.exists(path):
        os.remove(path)
