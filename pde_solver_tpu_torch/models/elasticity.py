"""Linear elasticity (1D bar, 2D plane stress/strain, 3D), static and
dynamic.

Counterpart of ``pde_solver_tpu.models.elasticity``: the 1D axial bar (end
load, thermal expansion, fixed-fixed), and the clamped-x=0 2D/3D problem
under body forces, surface tractions and thermal prestress as a matrix-free
block-stencil solve, then per-element von Mises from constant P1 gradients
(host numpy, float64) and an L2 projection onto P1 — the discrete operation
FEniCS' ``project`` performs.  :func:`solve_elasticity_dynamic` integrates
ρ ü − ∇·σ(u) = f by implicit Newmark-β, and :func:`assemble_vector_mass` is
the consistent mass it and the modal tools share.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from pde_solver_tpu_torch.config import SolverConfig, get_config
from pde_solver_tpu_torch.mesh import (StructuredMesh, flatten_values,
                                       interval_mesh)
from pde_solver_tpu_torch.ops import assembly, surface
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.ops.elements import subelem_geometry
from pde_solver_tpu_torch.ops.linsolve import solve_stencil_system
from pde_solver_tpu_torch.ops.projection import project_cellwise
from pde_solver_tpu_torch.utils.observability import get_logger, phase_timer


def lame_parameters(E: float, nu: float, mode: str) -> Tuple[float, float]:
    """(λ, μ) for "plane_stress" / "plane_strain" / "3d"."""
    mu = E / (2.0 * (1.0 + nu))
    if mode == "plane_stress":
        lam = E * nu / (1.0 - nu ** 2)
    else:  # plane_strain and 3d share the same λ
        lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return lam, mu


def thermal_stress_coefficient(E: float, nu: float, alpha: float,
                               mode: str) -> float:
    """β such that the thermal prestress is σ_th = −β ΔT I.

    3D / plane strain: β = E α / (1 − 2ν) = (3λ+2μ) α (plane strain keeps
    the 3D relation because ε_zz = 0 leaves tr₃ε = tr₂ε); plane stress
    reduces to β = E α / (1 − ν) = (2λ_ps + 2μ) α after eliminating σ_zz.
    """
    if mode == "plane_stress":
        return E * alpha / (1.0 - nu)
    return E * alpha / (1.0 - 2.0 * nu)  # plane_strain and 3d


def _element_gradients(mesh: StructuredMesh, u_grid: np.ndarray) -> np.ndarray:
    """Per-sub-element displacement gradient, shape [n_sub, *cells, d, d].

    grad_u[i, j] = Σ_a u[node_a, i] * g_a[j]; constant per simplex for P1.
    """
    d = mesh.dim
    n_sub = len(mesh.subelems)
    out = np.zeros((n_sub,) + mesh.cell_shape + (d, d))
    for t, sub in enumerate(mesh.subelems):
        g = subelem_geometry(mesh, t, 0).grads  # [d+1, d]
        for a, delta in enumerate(sub):
            region = tuple(slice(dd, dd + n) for dd, n in zip(delta, mesh.cell_shape))
            out[t] += np.einsum("...i,j->...ij", u_grid[region], g[a])
    return out


def _vm_from_gradients(G, xp, d: int, lam: float, mu: float, iso=None):
    """von Mises (stress, strain) from per-element gradients (``xp`` is
    numpy; the signature follows the JAX package).  ``iso``: optional
    per-element isotropic prestress subtracted from the stress diagonal."""
    eps = 0.5 * (G + xp.swapaxes(G, -1, -2))
    tr = xp.trace(eps, axis1=-2, axis2=-1)
    eye = xp.eye(d, dtype=G.dtype)
    sig = lam * tr[..., None, None] * eye + 2.0 * mu * eps
    if iso is not None:
        sig = sig - xp.asarray(iso, G.dtype)[..., None, None] * eye
    eps_dev = eps - (tr / 3.0)[..., None, None] * eye
    sig_tr = xp.trace(sig, axis1=-2, axis2=-1)
    sig_dev = sig - (sig_tr / 3.0)[..., None, None] * eye
    vm_stress = xp.sqrt(1.5 * xp.sum(sig_dev * sig_dev, axis=(-2, -1)))
    vm_strain = xp.sqrt((2.0 / 3.0) * xp.sum(eps_dev * eps_dev,
                                             axis=(-2, -1)))
    return vm_stress, vm_strain


def von_mises_fields(mesh: StructuredMesh, u_grid: np.ndarray, lam: float,
                     mu: float, iso: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sub-element von Mises (stress, strain) using the J2 deviator with
    a 1/3·tr convention on the d×d tensors (host numpy, float64)."""
    G = _element_gradients(mesh, u_grid)               # [n_sub, *cells, d, d]
    return _vm_from_gradients(G, np, mesh.dim, lam, mu, iso=iso)


def solve_bar_1d(L: float, nx: int, E: float, area: float, body_force: float,
                 quantity: str = "stress", end_load: float = 0.0,
                 alpha: float = 0.0, delta_T: float = 0.0,
                 clamp_both: bool = False,
                 config: Optional[SolverConfig] = None
                 ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """1D axial bar: −(EA u′)′ = f, u(0)=0, free at x=L.

    Returns (x coords [N], field values [N], stats).  ``quantity`` selects
    the P1-projected axial strain ε=u′ or stress σ=Eε, or the displacement
    u itself.  ``end_load``: axial point force P [N] at the free end, giving
    σ = P/A and u = P x/(EA) exactly.  ``alpha``/``delta_T``: uniform
    thermal expansion — load ∫ EAαΔT v′ dx, stress σ = E(ε − αΔT); with
    ``clamp_both`` (fixed-fixed) the stress is −EαΔT exactly.
    """
    if clamp_both and end_load:
        # the x=L node is Dirichlet-constrained: a point load added there
        # would be silently discarded by the masking
        raise ValueError("end_load cannot be applied with clamp_both=True: "
                         "the x=L end is displacement-constrained, so the "
                         "point load would be silently ignored")
    cfg = config or get_config()
    mesh = interval_mesh(nx, 0.0, L)
    t0 = time.perf_counter()
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    K = {o: (E * area) * W for o, W in K.items()}
    b = body_force * assembly.assemble_load(mesh, quad_degree=1)
    if end_load:
        b = b.copy()
        b[-1] += float(end_load)
    if alpha and delta_T:
        b = b + assembly.assemble_thermal_load(
            mesh, E * area * alpha, float(delta_T))[..., 0]
    clamp_masks = [(mesh.face_mask(0, 0), 0.0)]
    if clamp_both:
        clamp_masks.append((mesh.face_mask(0, 1), 0.0))
    bc = DirichletBC.from_masks(clamp_masks, mesh.node_shape)
    u, stats = solve_stencil_system(K, mesh, bc, b, config=cfg)

    # ε per element (piecewise constant), projected to P1 like FEniCS project
    h = mesh.spacing[0]
    eps_cells = ((u[1:] - u[:-1]) / h)[None]  # [1, nx]
    if quantity == "displacement":
        field = np.asarray(u, dtype=np.float64)
    elif quantity == "strain":
        field = project_cellwise(mesh, eps_cells, config=cfg)
    else:
        field_cells = E * (eps_cells - float(alpha) * float(delta_T))
        field = project_cellwise(mesh, field_cells, config=cfg)
    info = {
        "num_dofs": mesh.num_nodes,
        "cg_iterations": int(stats.iterations),
        "relative_residual": float(stats.relative_residual),
        "converged": bool(stats.converged),
        "solve_seconds": time.perf_counter() - t0,
    }
    return mesh.axis_nodes(0), field, info


def solve_elasticity_nd(mesh: StructuredMesh, E: float, nu: float,
                        body_force: np.ndarray, mode: str,
                        quantity: str = "stress",
                        traction_faces: Sequence = (),
                        thermal=None,
                        clamp_both: bool = False,
                        config: Optional[SolverConfig] = None
                        ) -> Tuple[np.ndarray, Dict]:
    """2D/3D static elasticity with the x=0 face clamped; returns the flat
    von Mises scalar field [N] plus stats.  ``mode``: plane_stress /
    plane_strain / 3d.

    ``traction_faces``: (axis, side, t_vec) surface tractions [N/m² per
    component], entering the load as the consistent P1 boundary term
    ∫_Γ t·v ds.  ``thermal``: optional (alpha, dT) thermoelastic coupling —
    ``dT`` a nodal temperature-rise grid [*node_shape] or a uniform scalar;
    adds the load ∫ β ΔT div(v) dx and evaluates stresses from
    σ = C:ε − β ΔT I (β per ``mode``, :func:`thermal_stress_coefficient`).
    ``clamp_both`` additionally clamps the x=L face."""
    cfg = config or get_config()
    d = mesh.dim
    lam, mu = lame_parameters(E, nu, mode)
    phases: Dict[str, float] = {}
    iso_cells = None
    with phase_timer(phases, "assembly"):
        K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
        b = assembly.assemble_vector_load(mesh,
                                          np.asarray(body_force, dtype=np.float64))
        for axis, side, tvec in traction_faces:
            bsurf = surface.assemble_face_load(mesh, int(axis), int(side))
            b = b + bsurf[..., None] * np.asarray(tvec, dtype=np.float64)
        if thermal is not None:
            alpha, dT = thermal
            beta = thermal_stress_coefficient(E, nu, float(alpha), mode)
            b = b + assembly.assemble_thermal_load(mesh, beta, dT)
            if np.isscalar(dT) or np.asarray(dT).ndim == 0:
                iso_cells = beta * float(dT)
            else:
                # the thermal load's own per-sub-element mean, so the
                # load-side and stress-side ΔT̄ agree
                iso_cells = beta * assembly.subelem_vertex_mean(
                    mesh, np.asarray(dT))
        clamp_masks = [(mesh.face_mask(0, 0), 0.0)]
        if clamp_both:
            clamp_masks.append((mesh.face_mask(0, 1), 0.0))
        bc = DirichletBC.from_masks(clamp_masks, mesh.node_shape, vdim=d)

    def level_builder(mesh_c):
        # re-assemble on the coarse mesh — exact Galerkin operator for
        # nested P1 spaces with homogeneous coefficients
        K_c = assembly.assemble_elasticity_stencil(mesh_c, lam, mu)
        masks_c = [(mesh_c.face_mask(0, 0), 0.0)]
        if clamp_both:
            masks_c.append((mesh_c.face_mask(0, 1), 0.0))
        bc_c = DirichletBC.from_masks(masks_c, mesh_c.node_shape, vdim=d)
        return K_c, bc_c

    with phase_timer(phases, "solve"):
        u_grid, stats = solve_stencil_system(K, mesh, bc, b, vdim=d, config=cfg,
                                             mg_level_builder=level_builder)
    with phase_timer(phases, "postprocess"):
        if quantity == "displacement":
            field = np.linalg.norm(np.asarray(u_grid, dtype=np.float64),
                                   axis=-1)
        else:
            vm_stress, vm_strain = von_mises_fields(mesh, u_grid, lam, mu,
                                                    iso=iso_cells)
            vm = vm_strain if quantity == "strain" else vm_stress
            field = project_cellwise(mesh, vm, config=cfg)
    info = {
        "num_dofs": mesh.num_nodes * d,
        "cg_iterations": int(stats.iterations),
        "relative_residual": float(stats.relative_residual),
        "converged": bool(stats.converged),
        "convergence_target": stats.target,
        **phases,
    }
    get_logger().info(
        "elasticity solve: %d DOF assembly=%.3fs solve=%.3fs iters=%d "
        "relres=%.2e", info["num_dofs"], phases.get("assembly_seconds", 0.0),
        phases.get("solve_seconds", 0.0), info["cg_iterations"],
        info["relative_residual"])
    return flatten_values(field, d), info


def assemble_vector_mass(mesh: StructuredMesh, rho: float) -> Dict:
    """Consistent vector mass stencil: ρ ∫ φ_n φ_m dx ⊗ I_d."""
    d = mesh.dim
    m = assembly.assemble_scalar_stencil(mesh, "mass")
    eye = np.eye(d)
    return {o: rho * W[..., None, None] * eye for o, W in m.items()}


def solve_elasticity_dynamic(mesh: StructuredMesh, E: float, nu: float,
                             rho: float, body_force: np.ndarray, mode: str,
                             dt: float, num_steps: int,
                             u0: Optional[np.ndarray] = None,
                             v0: Optional[np.ndarray] = None,
                             beta: float = 0.25, gamma: float = 0.5,
                             config: Optional[SolverConfig] = None):
    """Implicit elastodynamics ρ ü − ∇·σ(u) = f with the x=0 face clamped.

    Newmark-β time integration (β=¼, γ=½ default: unconditionally stable,
    energy-conserving).  Returns a
    :class:`~pde_solver_tpu_torch.ops.timestepping.NewmarkResult` plus
    stats."""
    from pde_solver_tpu_torch.ops.timestepping import run_newmark

    cfg = config or get_config()
    d = mesh.dim
    lam, mu = lame_parameters(E, nu, mode)
    phases: Dict[str, float] = {}
    with phase_timer(phases, "assembly"):
        K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
        M = assemble_vector_mass(mesh, rho)
        f = assembly.assemble_vector_load(mesh,
                                          np.asarray(body_force, np.float64))
        bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                    mesh.node_shape, vdim=d)
    shape = mesh.node_shape + (d,)
    u0 = np.zeros(shape) if u0 is None else np.asarray(u0, np.float64)
    v0 = np.zeros(shape) if v0 is None else np.asarray(v0, np.float64)

    def coarse_level(mesh_c):
        K_c = assembly.assemble_elasticity_stencil(mesh_c, lam, mu)
        M_c = assemble_vector_mass(mesh_c, rho)
        bc_c = DirichletBC.from_masks([(mesh_c.face_mask(0, 0), 0.0)],
                                      mesh_c.node_shape, vdim=d)
        return K_c, M_c, bc_c

    with phase_timer(phases, "solve"):
        res = run_newmark(K, M, mesh, bc, f, u0, v0, dt, num_steps,
                          beta=beta, gamma=gamma, vdim=d, config=cfg,
                          mg_level_builder=coarse_level)
    inner_tol = cfg.tol if cfg.resolve_precision() == "f64" \
        else cfg.transient_inner_tol
    step_target = max(inner_tol, cfg.accuracy_target)
    info = {
        "num_dofs": mesh.num_nodes * d,
        "cg_iterations": res.total_cg_iterations,
        "relative_residual": res.max_relative_residual,
        "converged": bool(res.max_relative_residual <= step_target),
        "convergence_target": step_target,
        "num_steps": num_steps,
        **phases,
    }
    get_logger().info(
        "elastodynamics: %d DOF × %d Newmark steps solve=%.3fs iters=%d",
        info["num_dofs"], num_steps, phases.get("solve_seconds", 0.0),
        res.total_cg_iterations)
    return res, info
