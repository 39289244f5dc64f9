"""Solver configuration: device, precision policy, tolerances.

Counterpart of ``pde_solver_tpu.config`` for the fields the ported slices
read (static elasticity, transient heat), plus ``device``.  Configures *how* systems are
solved, never *what* is solved (numeric defaults live in the ``api`` tool
signatures).

Precision policy ("auto"):
* CPU: float64 (the JAX package's CPU default; this port does not carry the
  f64 branch yet, see ROADMAP.md).
* CUDA: the mixed scheme — float32 MG-PCG inner solves and a double-float32
  F-cycle for f64-grade residuals.
"""

from __future__ import annotations

import contextvars
import os
from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class SolverConfig:
    device: str = "cuda"          # torch device every tensor of a solve
                                  # lives on; CPU tests pass "cpu"
    precision: str = "auto"       # "auto" | "f32" | "f64" | "mixed"
    tol: float = 1e-11            # outer (f64) relative residual target
    inner_tol: float = 1e-4       # f32 inner CG target per refinement round
    maxiter: Optional[int] = None # None → 20·sqrt(N) + 2000 heuristic
    refine_rounds: int = 7        # f64 refinement rounds in mixed mode
    transient_inner_tol: float = 1e-6  # implicit steps are mass-dominated
    accuracy_target: float = 1e-6 # the per-solve accuracy contract:
                                  # SolveStats.converged reports
                                  # relres ≤ max(requested tol, this)
    host_direct_threshold: int = 4000  # ≤ this many DOF → host sparse LU
    use_multigrid: bool = True    # MG-PCG when a level builder is available
    mg_threshold: int = 20000     # min DOF count before MG pays off
    transient_mg_threshold: Optional[int] = None  # min DOF for MG-PCG step
                                  # solves in transient scans; None → 250k
    snapshot_budget_bytes: int = 2 << 30  # device bytes allowed for the
                                  # kept [Nt][N] trajectory; beyond it the
                                  # scan keeps every k-th frame (the final
                                  # state always)
    snapshot_max_frames: int = 0  # >0 → hard cap on kept frames (opt-in)
    transient_checkpoint_every: int = 0  # >0 → checkpointed transients
                                  # (not ported: raises NotImplementedError)
    shard_devices: int = 0        # >1 → domain decomposition (not ported)
    shard_grid: str = ""          # "a,b" 2-D decomposition (not ported)
    theta: float = 1.0            # transient θ-scheme: 1 = backward Euler,
                                  # 0.5 = Crank–Nicolson (opt-in via
                                  # PDE_TPU_TIME_SCHEME=crank_nicolson)

    def resolved_shard_devices(self) -> int:
        if self.shard_devices > 1 or self.shard_grid.strip():
            raise NotImplementedError(
                "sharded solves are not ported yet (ROADMAP queue 1, item 11: "
                "step I)")
        return 0

    def resolve_precision(self) -> str:
        p = self.precision
        if p == "auto":
            return "f64" if self.device == "cpu" else "mixed"
        return p

    def resolved_transient_mg_threshold(self) -> int:
        t = self.transient_mg_threshold
        return 250_000 if t is None else max(t, self.mg_threshold)

    def resolved_maxiter(self, num_dofs: int) -> int:
        if self.maxiter is not None:
            return self.maxiter
        return int(20 * (num_dofs ** 0.5)) + 2000


_GLOBAL = SolverConfig(
    precision=os.environ.get("PDE_TPU_PRECISION", "auto"),
    tol=float(os.environ.get("PDE_TPU_TOL", 1e-11)),
    transient_checkpoint_every=int(
        os.environ.get("PDE_TPU_CHECKPOINT_EVERY", 0)),
    theta={"backward_euler": 1.0, "crank_nicolson": 0.5}.get(
        os.environ.get("PDE_TPU_TIME_SCHEME", "backward_euler"), 1.0),
)

# Scoped per-solve overrides: contextvars isolate concurrent asyncio tasks.
_OVERRIDE: "contextvars.ContextVar[Optional[SolverConfig]]" = \
    contextvars.ContextVar("pde_torch_config_override", default=None)


def get_config() -> SolverConfig:
    ov = _OVERRIDE.get()
    return ov if ov is not None else _GLOBAL


class config_overrides:
    """Context manager scoping SolverConfig fields to the current (asyncio)
    context: ``with config_overrides(device="cpu"): ...``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self._token = None

    def __enter__(self):
        self._token = _OVERRIDE.set(replace(get_config(), **self._kwargs))
        return get_config()

    def __exit__(self, *exc):
        _OVERRIDE.reset(self._token)
        return False
