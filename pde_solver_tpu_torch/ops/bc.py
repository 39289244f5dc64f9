"""Dirichlet boundary conditions as host numpy masks.

Counterpart of ``pde_solver_tpu.ops.bc`` (``from_masks``,
``apply_values`` and the mask builders).  Masks stay host numpy arrays: they feed the host-side
system preparation, which bakes symmetric elimination into the weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from pde_solver_tpu_torch.mesh import StructuredMesh


@dataclass(frozen=True)
class DirichletBC:
    """free_mask: 1.0 on free DOFs, 0.0 on constrained; values: g on
    constrained DOFs (anything on free DOFs — it is masked)."""

    free_mask: np.ndarray  # [*node_shape] or [*node_shape, v]
    values: np.ndarray     # same shape

    @staticmethod
    def from_masks(pairs: Sequence[Tuple[np.ndarray, float]], node_shape,
                   vdim: int = 1, dtype=np.float64) -> "DirichletBC":
        """Build from (bool mask, value) pairs.  Later pairs win on overlap
        (matching DOLFIN's last-applied-BC-wins semantics for bc lists)."""
        shape = tuple(node_shape) + ((vdim,) if vdim > 1 else ())
        constrained = np.zeros(shape, dtype=bool)
        values = np.zeros(shape, dtype=np.float64)
        for mask, val in pairs:
            m = np.asarray(mask, dtype=bool)
            if vdim > 1 and m.shape == tuple(node_shape):
                m = np.repeat(m[..., None], vdim, axis=-1)
            constrained |= m
            values = np.where(m, float(val), values)
        np_dtype = np.dtype(dtype) if dtype is not None else np.float64
        return DirichletBC(
            free_mask=np.asarray(~constrained, dtype=np_dtype),
            values=np.asarray(values, dtype=np_dtype),
        )

    def apply_values(self, x: np.ndarray) -> np.ndarray:
        """Force boundary values onto a field (initial conditions)."""
        return self.free_mask * x + (1.0 - self.free_mask) * self.values


def all_boundary(mesh: StructuredMesh) -> np.ndarray:
    return mesh.boundary_mask()


def boundary_except_faces(mesh: StructuredMesh, axis: int) -> np.ndarray:
    """Boundary nodes excluding the two faces normal to ``axis`` (the
    'other faces' / 'side' predicate of solve_heat_3D)."""
    m = mesh.boundary_mask().copy()
    m &= ~mesh.face_mask(axis, 0)
    m &= ~mesh.face_mask(axis, 1)
    return m


def radius_shell(mesh: StructuredMesh, axes: Sequence[int], radius: float,
                 exclude_axis_faces: Optional[int] = None,
                 rtol: float = 1e-9) -> np.ndarray:
    """Boundary nodes at distance ``radius`` from the axis spanned by the
    remaining coordinate (the cylinder side wall on the box-embedding
    mesh)."""
    coords = mesh.node_coords
    r = np.sqrt(sum(coords[..., a] ** 2 for a in axes))
    m = mesh.boundary_mask() & (np.abs(r - radius)
                                <= rtol * max(abs(radius), 1.0) + 1e-12)
    if exclude_axis_faces is not None:
        m &= ~mesh.face_mask(exclude_axis_faces, 0)
        m &= ~mesh.face_mask(exclude_axis_faces, 1)
    return m
