"""L2 projection onto P1 — consistent-mass solve.

Counterpart of ``pde_solver_tpu.ops.projection`` (``project_cellwise``):
solve M p = b with b_i = ∫ expr φ_i dx and the consistent (not lumped) mass
matrix, as FEniCS ``project`` does for the stress / von Mises fields.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pde_solver_tpu_torch.config import SolverConfig
from pde_solver_tpu_torch.mesh import StructuredMesh
from pde_solver_tpu_torch.ops import assembly
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.ops.linsolve import solve_stencil_system


def _no_bc(mesh: StructuredMesh) -> DirichletBC:
    shape = mesh.node_shape
    return DirichletBC(free_mask=np.ones(shape, np.float64),
                       values=np.zeros(shape, np.float64))


def project_cellwise(mesh: StructuredMesh, cell_values: np.ndarray,
                     config: Optional[SolverConfig] = None) -> np.ndarray:
    """Project a piecewise-constant (per sub-element) field onto P1.

    ``cell_values``: [n_sub, *cell_shape].  b_i = Σ_T v_T ∫_T φ_i = v_T·|T|/(d+1)
    — exact, matching FEniCS' projection of DG0-like expressions.
    """
    from pde_solver_tpu_torch.ops.elements import subelem_geometry

    b = np.zeros(mesh.node_shape, dtype=np.float64)
    for t, sub in enumerate(mesh.subelems):
        geom = subelem_geometry(mesh, t, 1)
        share = geom.volume / (mesh.dim + 1)
        for a in range(len(sub)):
            region = tuple(slice(d, d + n) for d, n in zip(sub[a], mesh.cell_shape))
            b[region] += share * cell_values[t]
    M = assembly.assemble_scalar_stencil(mesh, "mass", quad_degree=2)
    x, _ = solve_stencil_system(M, mesh, _no_bc(mesh), b, config=config)
    return x
