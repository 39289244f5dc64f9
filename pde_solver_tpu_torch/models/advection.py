"""Advection-diffusion solver family (extension beyond the reference).

Counterpart of ``pde_solver_tpu.models.advection``, on
``ops.timestepping.run_transient`` of this package.  The reference's schema
lists ``pde_type="advection"`` (pde_schema.py:15 comment) and its parser
will happily emit it, but its dispatcher has no route — every advection
query errors out.  Here: u_t + v·∇u = κΔu + f on Cartesian boxes, constant velocity v,
Dirichlet boundaries, via IMEX stepping — diffusion implicit (the SPD
CG/MG scan machinery unchanged), Galerkin convection explicit
(``assembly.assemble_convection_stencil``).  The default scheme is CNAB2
(Crank-Nicolson diffusion + Adams-Bashforth-2 convection, O(Δt²) overall);
``scheme="ab1"`` keeps the first-order fold of C into the explicit-side
operator.  Stability guards: the solver
records the advective CFL number v·Δt/h and the cell Péclet v·h/(2κ) in its
info dict and logs a warning when either exceeds its stable/oscillation-free
range (explicit centered convection needs CFL ≲ 1; Galerkin diffusion needs
Pe_h ≲ 1 to stay monotone).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from pde_solver_tpu_torch.config import SolverConfig, get_config
from pde_solver_tpu_torch.mesh import StructuredMesh, flatten_values
from pde_solver_tpu_torch.ops import assembly
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.ops.timestepping import run_transient, scan_stats
from pde_solver_tpu_torch.utils.observability import (get_logger, request,
                                                      span)


@dataclass
class AdvectionProblem:
    mesh: StructuredMesh
    velocity: Sequence[float]                 # constant v, len == mesh.dim
    diffusivity: float = 1.0
    bc_pairs: Sequence[Tuple[np.ndarray, float]] = ()
    bc_builder: Optional[object] = None       # mesh -> [(mask, value), ...]
    source_type: str = "none"
    source_value: float = 0.0
    # initial condition: constant, or a gaussian pulse (the canonical
    # transport test/demo)
    T_initial: float = 0.0
    initial_type: str = "constant"            # constant | gaussian
    pulse_center: Optional[Sequence[float]] = None
    pulse_width: float = 0.1
    pulse_amplitude: float = 1.0
    dt: float = 0.01
    num_steps: int = 50
    theta: Optional[float] = None
    # convection scheme: "cnab2" (Crank-Nicolson/Adams-Bashforth-2, the
    # standard 2nd-order IMEX pair — theta defaults to 1/2 with it) or
    # "ab1" (the original O(Δt) fold of C into the explicit operator)
    scheme: str = "cnab2"


def _initial_field(p: AdvectionProblem) -> np.ndarray:
    mesh = p.mesh
    if p.initial_type == "gaussian":
        c = np.asarray(p.pulse_center if p.pulse_center is not None else
                       [mesh.origin[a] + 0.5 * mesh.extent[a]
                        for a in range(mesh.dim)], dtype=np.float64)
        x = mesh.node_coords
        r2 = sum((x[..., a] - c[a]) ** 2 for a in range(mesh.dim))
        return float(p.T_initial) + float(p.pulse_amplitude) * np.exp(
            -r2 / (2.0 * float(p.pulse_width) ** 2))
    return np.full(mesh.node_shape, float(p.T_initial), dtype=np.float64)


def solve_advection_problem(p: AdvectionProblem,
                            config: Optional[SolverConfig] = None
                            ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Returns (times [Nt], values [Nt, N] flat float64, info dict)."""
    cfg = config or get_config()
    mesh = p.mesh
    v = np.asarray(p.velocity, dtype=np.float64).reshape(mesh.dim)

    phases: Dict[str, float] = {}
    with request(phases):
        with span("assembly"):
            K = assembly.assemble_scalar_stencil(mesh, "stiffness")
            if p.diffusivity != 1.0:
                K = {o: p.diffusivity * W for o, W in K.items()}
            M = assembly.assemble_scalar_stencil(mesh, "mass")
            C = assembly.assemble_convection_stencil(mesh, v)

            if p.source_type == "constant" and p.source_value != 0.0:
                b = p.source_value * assembly.assemble_load(mesh)
            else:
                b = np.zeros(mesh.node_shape, dtype=np.float64)

            pairs = list(p.bc_pairs) if p.bc_pairs else (
                list(p.bc_builder(mesh)) if p.bc_builder else
                [(mesh.boundary_mask(), 0.0)])
            bc = DirichletBC.from_masks(pairs, mesh.node_shape)
            u0 = np.asarray(bc.apply_values(_initial_field(p)),
                            dtype=np.float64)

        # stability diagnostics (explicit centered convection)
        h_min = min(mesh.spacing)
        speed = float(np.linalg.norm(v))
        cfl = speed * p.dt / h_min if h_min > 0 else 0.0
        peclet = speed * h_min / (2.0 * p.diffusivity) if p.diffusivity > 0 \
            else np.inf
        if cfl > 1.0:
            get_logger().warning(
                "advective CFL %.2f > 1 (|v|=%.3g, dt=%.3g, h=%.3g) — the "
                "explicit convection term may be unstable; reduce dt", cfl,
                speed, p.dt, h_min)
        if peclet > 2.0:
            get_logger().warning(
                "cell Péclet %.2f > 2 — centered Galerkin convection may "
                "oscillate; refine the mesh or raise diffusivity", peclet)

        scheme = {"imex1": "ab1"}.get(p.scheme, p.scheme)
        if scheme not in ("ab1", "cnab2"):
            raise ValueError(f"unknown advection scheme {p.scheme!r}")
        # CNAB2 pairs AB2 convection with Crank-Nicolson diffusion for O(Δt²)
        # overall; an explicit theta always wins.
        theta = p.theta if p.theta is not None else (
            0.5 if scheme == "cnab2" else cfg.theta)
        with span("solve"):
            res = run_transient(K, M, mesh, bc, b, u0, dt=p.dt,
                                num_steps=p.num_steps, theta=theta,
                                config=cfg, C_np=C, convection_scheme=scheme)
    values = np.stack([flatten_values(u, mesh.dim) for u in res.values])
    step_target = max(cfg.transient_inner_tol, cfg.accuracy_target)
    info = {
        **phases,
        "steady": False,
        "cg_iterations": int(res.total_cg_iterations),
        "relative_residual": float(res.max_relative_residual),
        "converged": bool(res.max_relative_residual <= step_target),
        "convergence_target": step_target,
        "cfl": cfl, "cell_peclet": peclet, "scheme": scheme,
        "num_dofs": mesh.num_nodes,
        **scan_stats(res),
    }
    return res.times, values, info
