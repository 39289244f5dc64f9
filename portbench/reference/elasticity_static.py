"""Reference of the 3D static elasticity tool on a box clamped at x = 0.

P1 on the Kuhn split of the box, isotropic material, a constant body force
f: K u = f ⊗ ∫φ on the free nodes, u = 0 on x = 0.  The system is linear in
f, so one solve per axis (a unit body force along it) gives every load
case: u(f) = Σᵢ fᵢ Uᵢ.  Then per tetrahedron the von Mises stress of
σ = λ tr(ε) I + 2μ ε, and its L2 projection onto P1 (the consistent mass
solve FEniCS' ``project`` makes), flat in the tools' node order.

Solves are multigrid-PCG (:mod:`p1`) to a true relative residual of
``tol``; the projection is Jacobi-PCG on the mass matrix.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .p1 import (TETS, Grid, MaskedOperator, Multigrid, StencilOperator,
                cell_region, elasticity_matrices, face_mask, lame,
                mass_matrices, pcg, tet_geometry, to_flat)


def nodal_volume(grid: Grid, dtype, device) -> torch.Tensor:
    """∫ φ_n over the box: each tetrahedron gives a quarter of its volume
    to each of its vertices."""
    w = torch.zeros(grid.nodes, dtype=torch.float64, device=device)
    for (vol, _), verts in zip(tet_geometry(grid.spacing), TETS):
        for va in verts:
            w[cell_region(va, grid.cells)] += vol / 4.0
    return w.to(dtype)


class Cantilever:
    """The clamped box of ``config``; :meth:`von_mises` answers a body
    force."""

    def __init__(self, config: Dict, device, dtype=torch.float64,
                 tol: float = 1e-13, maxiter: int = 500):
        mesh = config["mesh"]
        self.grid = grid = Grid(tuple(mesh["cells"]), tuple(mesh["extent"]))
        args = config["tool_args"]
        self.lam, self.mu = lame(float(args["E"]), float(args["nu"]))
        self.dtype, self.device = dtype, device
        self.tol, self.maxiter = tol, maxiter
        self.relres = []
        self.iterations = []

        def constrained(g):
            return face_mask(g, ["x0"], device)

        mg = Multigrid(grid, lambda g: StencilOperator(
            g, elasticity_matrices(g.spacing, self.lam, self.mu), dtype,
            device), constrained, dtype, device)
        A = mg.fine
        vol = nodal_volume(grid, dtype, device)
        self.basis = []
        for axis in range(3):
            b = torch.zeros((3,) + grid.nodes, dtype=dtype, device=device)
            b[axis] = vol
            b = A.free * b
            u, it, rel = pcg(A, mg, b, torch.zeros_like(b), tol, maxiter)
            self.basis.append(u)
            self.iterations.append(it)
            self.relres.append(rel)
        del mg, A
        mass = StencilOperator(grid, mass_matrices(grid.spacing), dtype,
                               device)
        self.mass = MaskedOperator(mass, torch.zeros(grid.nodes,
                                                     dtype=torch.bool,
                                                     device=device))
        self.mass_dinv = 1.0 / self.mass.diagonal()

    def displacement(self, body_force: Sequence[float]) -> torch.Tensor:
        return sum(float(f) * U for f, U in zip(body_force, self.basis))

    def von_mises_cells(self, u: torch.Tensor) -> list:
        """Per tetrahedron type, the von Mises stress over the cells."""
        lam, mu = self.lam, self.mu
        cells = self.grid.cells
        out = []
        for (vol, grads), verts in zip(tet_geometry(self.grid.spacing),
                                       TETS):
            G = 0
            for a, va in enumerate(verts):
                g = torch.as_tensor(grads[a], dtype=u.dtype,
                                    device=u.device)
                # du_i/dx_j
                G = G + u[(slice(None),) + cell_region(va, cells)][
                    :, None] * g[None, :, None, None, None]
            eps = 0.5 * (G + G.transpose(0, 1))
            tr = eps[0, 0] + eps[1, 1] + eps[2, 2]
            s = 2.0 * mu * eps
            sxx, syy, szz = (s[i, i] + lam * tr for i in range(3))
            sxy, syz, sxz = s[0, 1], s[1, 2], s[0, 2]
            vm = torch.sqrt(0.5 * ((sxx - syy) ** 2 + (syy - szz) ** 2
                                   + (szz - sxx) ** 2)
                            + 3.0 * (sxy ** 2 + syz ** 2 + sxz ** 2))
            out.append((vol, vm))
        return out

    def project(self, per_tet: list) -> torch.Tensor:
        """L2 projection of a per-tetrahedron constant onto P1."""
        b = torch.zeros((1,) + self.grid.nodes, dtype=self.dtype,
                        device=self.device)
        for (vol, vm), verts in zip(per_tet, TETS):
            for va in verts:
                b[(0,) + cell_region(va, self.grid.cells)] += vol / 4.0 * vm
        p, it, rel = pcg(self.mass, lambda r: self.mass_dinv * r, b,
                         torch.zeros_like(b), self.tol, self.maxiter)
        return p[0]

    def von_mises(self, body_force: Sequence[float]) -> np.ndarray:
        """The tool's field for this load: flat, float64."""
        u = self.displacement(body_force)
        return to_flat(self.project(self.von_mises_cells(u)))
