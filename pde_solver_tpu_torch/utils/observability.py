"""Logging and phase timers (counterpart of
``pde_solver_tpu.utils.observability``: ``get_logger`` and ``phase_timer``).

The logger writes to stderr (level via PDE_TPU_LOG_LEVEL) so stdout stays
clean for JSON-line consumers."""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from typing import Dict, Iterator, Optional

_LOGGER: Optional[logging.Logger] = None


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("pde_solver_tpu_torch")
        if not logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s %(message)s"))
            logger.addHandler(handler)
        logger.setLevel(os.environ.get("PDE_TPU_LOG_LEVEL", "WARNING").upper())
        logger.propagate = False
        _LOGGER = logger
    return _LOGGER


@contextlib.contextmanager
def phase_timer(stats: Dict[str, float], name: str) -> Iterator[None]:
    """Accumulate wall time of a phase into ``stats[name + '_seconds']``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        key = f"{name}_seconds"
        stats[key] = stats.get(key, 0.0) + (time.perf_counter() - t0)
