"""Scalar wave-equation family ∂²u/∂t² = c²∇²u + f.

Counterpart of ``pde_solver_tpu.models.wave``.  The weak form is
M ü + (c²K) u = b with the heat family's mass and stiffness stencils,
integrated by the implicit Newmark-β loop that also carries elastodynamics
(:func:`pde_solver_tpu_torch.ops.timestepping.run_newmark`, vdim=1):
unconditionally stable, energy-conserving at β=¼/γ=½, MG-PCG step solves
above the transient threshold.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from pde_solver_tpu_torch.config import SolverConfig, get_config
from pde_solver_tpu_torch.mesh import StructuredMesh, flatten_values
from pde_solver_tpu_torch.models.heat import HeatProblem, _initial_field
from pde_solver_tpu_torch.ops import assembly
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.ops.timestepping import run_newmark
from pde_solver_tpu_torch.utils.observability import get_logger, phase_timer


@dataclass
class WaveProblem:
    mesh: StructuredMesh
    wave_speed: float = 1.0
    boundary_value: float = 0.0          # uniform Dirichlet on ∂Ω
    source_value: float = 0.0            # constant volumetric forcing f
    # initial displacement — same vocabulary as the heat ICs
    # (constant | zero | cosine | sine, amplitude A, wavenumber k:
    # u0 = A·Π_i trig(k x_i), consistent-mass projected)
    initial_type: str = "sine"
    initial_value: float = 0.0           # the "constant" IC level
    initial_amplitude: float = 1.0
    initial_wavenumber: Optional[float] = None   # None → fundamental π/L_min
    # stepping (implicit Newmark-β)
    dt: float = 0.01
    num_steps: int = 50
    beta: float = 0.25
    gamma: float = 0.5


def _fundamental_wavenumber(mesh: StructuredMesh) -> float:
    """π / (shortest axis extent): the sine IC's fundamental standing mode
    (u0 vanishes on the x=0/x=L faces of that axis)."""
    extents = [float(mesh.axis_nodes(a)[-1] - mesh.axis_nodes(a)[0])
               for a in range(mesh.dim)]
    return float(np.pi / min(extents))


def solve_wave_problem(p: WaveProblem,
                       config: Optional[SolverConfig] = None
                       ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Returns (times [Nt+1], values [Nt+1, N] flat float64, stats dict)."""
    cfg = config or get_config()
    mesh = p.mesh
    c2 = float(p.wave_speed) ** 2
    phases: Dict[str, float] = {}

    with phase_timer(phases, "assembly"):
        K = assembly.assemble_scalar_stencil(mesh, "stiffness")
        if c2 != 1.0:
            K = {o: c2 * W for o, W in K.items()}
        M = assembly.assemble_scalar_stencil(mesh, "mass")
        if p.source_value != 0.0:
            b = p.source_value * assembly.assemble_load(mesh)
        else:
            b = np.zeros(mesh.node_shape, dtype=np.float64)
        bc = DirichletBC.from_masks([(mesh.boundary_mask(),
                                      float(p.boundary_value))],
                                    mesh.node_shape)
        k = (p.initial_wavenumber if p.initial_wavenumber is not None
             else _fundamental_wavenumber(mesh))
        ic_spec = HeatProblem(mesh=mesh, T_initial=p.initial_value,
                              initial_type=p.initial_type,
                              initial_amplitude=p.initial_amplitude,
                              initial_wavenumber=k)
        u0 = np.asarray(bc.apply_values(_initial_field(ic_spec)),
                        dtype=np.float64)
        v0 = np.zeros_like(u0)

    def coarse_level(mesh_c):
        K_c = assembly.assemble_scalar_stencil(mesh_c, "stiffness")
        if c2 != 1.0:
            K_c = {o: c2 * W for o, W in K_c.items()}
        M_c = assembly.assemble_scalar_stencil(mesh_c, "mass")
        bc_c = DirichletBC.from_masks([(mesh_c.boundary_mask(),
                                        float(p.boundary_value))],
                                      mesh_c.node_shape)
        return K_c, M_c, bc_c

    with phase_timer(phases, "solve"):
        res = run_newmark(K, M, mesh, bc, b, u0, v0, p.dt, p.num_steps,
                          beta=p.beta, gamma=p.gamma, vdim=1, config=cfg,
                          mg_level_builder=coarse_level)

    values = np.stack([flatten_values(v, mesh.dim) for v in res.values])
    inner_tol = cfg.tol if cfg.resolve_precision() == "f64" \
        else cfg.transient_inner_tol
    step_target = max(inner_tol, cfg.accuracy_target)
    info = {
        "num_dofs": mesh.num_nodes,
        "cg_iterations": int(res.total_cg_iterations),
        "relative_residual": float(res.max_relative_residual),
        "converged": bool(res.max_relative_residual <= step_target),
        "convergence_target": step_target,
        "num_steps": int(p.num_steps),
        "integrator": "newmark_beta",
        "beta": float(p.beta), "gamma": float(p.gamma),
        **phases,
    }
    get_logger().info(
        "wave solve: %d DOF × %d Newmark steps assembly=%.3fs solve=%.3fs "
        "iters=%d", mesh.num_nodes, p.num_steps,
        phases.get("assembly_seconds", 0.0),
        phases.get("solve_seconds", 0.0), info["cg_iterations"])
    return res.times, values, info
