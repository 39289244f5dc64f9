"""Static linear elasticity (2D plane stress/strain, 3D).

Counterpart of ``pde_solver_tpu.models.elasticity`` for the static solve:
the clamped-x=0 body-force problem as a matrix-free block-stencil solve,
then per-element von Mises from constant P1 gradients (host numpy, float64)
and an L2 projection onto P1 — the discrete operation FEniCS' ``project``
performs.  Surface tractions and thermal coupling are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from pde_solver_tpu_torch.config import SolverConfig, get_config
from pde_solver_tpu_torch.mesh import StructuredMesh, flatten_values
from pde_solver_tpu_torch.ops import assembly
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
    plane_strain / 3d.  ``clamp_both`` additionally clamps the x=L face."""
    if len(traction_faces):
        raise NotImplementedError("surface tractions are not ported yet "
                                  "(ROADMAP queue 1, item 7)")
    if thermal is not None:
        raise NotImplementedError("thermal coupling is not ported yet "
                                  "(ROADMAP queue 1, item 7)")
    cfg = config or get_config()
    d = mesh.dim
    lam, mu = lame_parameters(E, nu, mode)
    phases: Dict[str, float] = {}
    with phase_timer(phases, "assembly"):
        K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
        b = assembly.assemble_vector_load(mesh,
                                          np.asarray(body_force, dtype=np.float64))
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
            vm_stress, vm_strain = von_mises_fields(mesh, u_grid, lam, mu)
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
