"""Solve statistics (counterpart of ``pde_solver_tpu.ops.cg.SolveStats``).

CG divergence is reported in the stats, not raised."""

from __future__ import annotations

from typing import Any, NamedTuple, Optional


class SolveStats(NamedTuple):
    iterations: Any                 # int
    relative_residual: Any          # float
    converged: Any                  # bool — relative_residual ≤ target
    target: Optional[float] = None  # the residual target the verdict used
