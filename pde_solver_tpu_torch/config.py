"""Solver configuration: device, precision policy, tolerances.

Counterpart of ``pde_solver_tpu.config`` for the fields the port reads,
plus ``device``.  Configures *how* systems are solved, never *what* is
solved (numeric defaults live in the ``api`` tool signatures).

Precision policy ("auto"):
* CPU: float64 (the JAX package's CPU default): float64 CG or MG-PCG on
  plain torch tensors, float64 transient and Newmark scans.
* CUDA: the mixed scheme — float32 MG-PCG inner solves and a double-float32
  F-cycle for f64-grade residuals; transient scans run in float32.
"f64" and "f32" may be asked for on either device.

Sharding (``shard_devices``, ``shard_grid``; ``PDE_TPU_SHARD_DEVICES``,
``PDE_TPU_SHARD_GRID``) decomposes the grid over the devices of
``parallel.shard.available_devices()``, clipped to their count as the JAX
package clips to ``len(jax.devices())``.
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
    transient_refine_rounds: int = 1  # inert, kept for parity with the
                                  # JAX package's config: run_transient
                                  # maps "mixed" to f32, so no scan reads it
    accuracy_target: float = 1e-6 # the per-solve accuracy contract:
                                  # SolveStats.converged reports
                                  # relres ≤ max(requested tol, this)
    host_direct_threshold: int = 4000  # ≤ this many DOF → host sparse LU
    use_multigrid: bool = True    # MG-PCG when a level builder is available
    mg_threshold: int = 20000     # min DOF count before MG pays off
    transient_mg_threshold: Optional[int] = None  # min DOF for MG-PCG step
                                  # solves in transient scans; None → 250k
    mg_maxiter: int = 300         # MG-PCG iteration cap of a float64 static
                                  # solve (solve_mg) and of a sharded one
    mg_inner_tol: float = 1e-4    # sharded "mixed" MG-PCG inner solves'
                                  # target per refinement round
    snapshot_dtype: str = "f32"   # dtype of kept frames below float64
                                  # scans ("f32", or the state's dtype)
    snapshot_budget_bytes: int = 2 << 30  # device bytes allowed for the
                                  # kept [Nt][N] trajectory; beyond it the
                                  # scan keeps every k-th frame (the final
                                  # state always)
    snapshot_max_frames: int = 0  # >0 → hard cap on kept frames (opt-in)
    transient_checkpoint_every: int = 0  # >0 → persist the scan carry and
                                  # the kept frames every N steps (atomic
                                  # npz); a re-run of the same problem
                                  # resumes from the last checkpoint
    checkpoint_dir: str = "data/checkpoints"
    shard_devices: int = 0        # >1 → domain-decompose grid axis 0 over
                                  # that many devices (parallel.shard); 0 off
    shard_grid: str = ""          # "a,b" (or "axb") → decompose grid axes 0
                                  # and 1 over an a×b device mesh; implies
                                  # a·b shards when shard_devices is unset
    theta: float = 1.0            # transient θ-scheme: 1 = backward Euler,
                                  # 0.5 = Crank–Nicolson (opt-in via
                                  # PDE_TPU_TIME_SCHEME=crank_nicolson)

    def _n_available(self) -> int:
        from pde_solver_tpu_torch.parallel.shard import available_devices

        return len(available_devices(self.device))

    def resolved_shard_devices(self) -> int:
        """Shards of a sharded solve, 0 when off: ``shard_grid`` alone
        implies a·b; the request is clipped to the available devices, as
        the JAX package clips it (logged)."""
        n = self.shard_devices
        grid = self.resolved_shard_grid()
        if grid is not None and n <= 1:
            n = grid[0] * grid[1]
        if n <= 1:
            return 0
        avail = self._n_available()
        if n > avail:
            from pde_solver_tpu_torch.utils.observability import get_logger

            get_logger().warning(
                "shard_devices=%d clipped to the %d available device(s) of "
                "%r", n, avail, self.device)
        return min(n, avail)

    def resolved_shard_grid(self) -> Optional[tuple]:
        """(a, b) for a requested 2-D decomposition, or None (the 1-D
        split): a malformed grid, b < 2 or a·b above the available devices
        fall back to None."""
        s = self.shard_grid.strip().replace("x", ",")
        if not s:
            return None
        try:
            a, b = (int(t) for t in s.split(","))
        except ValueError:
            return None
        if a < 1 or b < 2 or a * b > self._n_available():
            return None
        return (a, b)

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
    # PDE_TPU_DEVICE=cpu is the only way to send a subprocess (the MCP
    # server) to the CPU; unset, every entry point runs on the card
    device=os.environ.get("PDE_TPU_DEVICE", "cuda"),
    precision=os.environ.get("PDE_TPU_PRECISION", "auto"),
    tol=float(os.environ.get("PDE_TPU_TOL", 1e-11)),
    shard_devices=int(os.environ.get("PDE_TPU_SHARD_DEVICES", 0)),
    shard_grid=os.environ.get("PDE_TPU_SHARD_GRID", ""),
    transient_checkpoint_every=int(
        os.environ.get("PDE_TPU_CHECKPOINT_EVERY", 0)),
    checkpoint_dir=os.environ.get("PDE_TPU_CHECKPOINT_DIR",
                                  "data/checkpoints"),
    theta={"backward_euler": 1.0, "crank_nicolson": 0.5}.get(
        os.environ.get("PDE_TPU_TIME_SCHEME", "backward_euler"), 1.0),
)

# Scoped per-solve overrides: contextvars isolate concurrent asyncio tasks.
_OVERRIDE: "contextvars.ContextVar[Optional[SolverConfig]]" = \
    contextvars.ContextVar("pde_torch_config_override", default=None)


def get_config() -> SolverConfig:
    ov = _OVERRIDE.get()
    return ov if ov is not None else _GLOBAL


def set_config(**kwargs) -> SolverConfig:
    """Replace fields of the process-wide configuration (scoped overrides
    still win inside their context)."""
    global _GLOBAL
    _GLOBAL = replace(_GLOBAL, **kwargs)
    return _GLOBAL


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
