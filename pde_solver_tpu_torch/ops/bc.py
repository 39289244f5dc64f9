"""Dirichlet boundary conditions as host numpy masks.

Counterpart of ``pde_solver_tpu.ops.bc`` (``from_masks`` and
``all_boundary``).  Masks stay host numpy arrays: they feed the host-side
system preparation, which bakes symmetric elimination into the weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

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


def all_boundary(mesh: StructuredMesh) -> np.ndarray:
    return mesh.boundary_mask()
