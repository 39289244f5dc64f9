"""Structured simplicial meshes with closed-form connectivity.

Structured-grid replacement for DOLFIN's ``IntervalMesh`` / ``RectangleMesh`` /
``BoxMesh`` (used by every reference solver, e.g.
``fenics_mcp_server.py:229,:369,:533``).  Instead of storing
cell/vertex tables, the mesh is a tensor grid: node coordinates are closed
form, and element connectivity is expressed as *local vertex offsets* of
simplices inside each grid cell.  All assembly and operator application then
become shifted-slice arithmetic on dense arrays — the layout XLA tiles well.

The simplicial decomposition matches DOLFIN exactly so that P1 discretizations
produce identical linear systems (required for the ≤1e-6 L2 parity target):

* 1D: one interval per cell.
* 2D: the "right"-diagonal split of each rectangle cell into two triangles
  sharing the lower-left → upper-right diagonal (DOLFIN RectangleMesh default).
* 3D: the Kuhn/Freudenthal split of each hex cell into six tetrahedra sharing
  the main diagonal (DOLFIN BoxMesh).

Nodes are stored in lexicographic order with x fastest:
``flat_index = ix + (nx+1) * (iy + (ny+1) * iz)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

# Local vertex offsets (in cell-index space, entries in {0,1}) for the
# simplices tiling one grid cell, per dimension.
_INTERVAL_SUBELEMS = (((0,), (1,)),)

# "Right" diagonal: both triangles contain the v0=(0,0) → v3=(1,1) diagonal.
_TRIANGLE_SUBELEMS = (
    ((0, 0), (1, 0), (1, 1)),
    ((0, 0), (1, 1), (0, 1)),
)

# Freudenthal/Kuhn 6-tet split: one tet per monotone lattice path 0→(1,1,1).
# Every tet contains the main diagonal; the split is translation-invariant,
# which is what makes interior operator stencils constant.
_TET_SUBELEMS = (
    ((0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)),  # x, y, z
    ((0, 0, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)),  # x, z, y
    ((0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1)),  # y, x, z
    ((0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)),  # y, z, x
    ((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)),  # z, x, y
    ((0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1)),  # z, y, x
)

_SUBELEMS = {1: _INTERVAL_SUBELEMS, 2: _TRIANGLE_SUBELEMS, 3: _TET_SUBELEMS}


@dataclass(frozen=True)
class StructuredMesh:
    """A structured grid of ``n_cells`` cells per axis over ``[origin, origin+extent]``.

    The mesh lives in *parameter space*: curvilinear solvers build a
    rectangular mesh in (r, θ, ...) coordinates and express the geometry
    through coordinate-weight functions in the weak form (the same device the
    reference uses for every curvilinear solver,
    fenics_mcp_server.py:769-1464) plus an embedding map for output coords.
    """

    n_cells: Tuple[int, ...]
    origin: Tuple[float, ...]
    extent: Tuple[float, ...]

    # ------------------------------------------------------------------
    @property
    def dim(self) -> int:
        return len(self.n_cells)

    @property
    def node_shape(self) -> Tuple[int, ...]:
        return tuple(n + 1 for n in self.n_cells)

    @property
    def cell_shape(self) -> Tuple[int, ...]:
        return tuple(self.n_cells)

    @property
    def num_nodes(self) -> int:
        return int(np.prod(self.node_shape))

    @property
    def spacing(self) -> Tuple[float, ...]:
        return tuple(e / n for e, n in zip(self.extent, self.n_cells))

    @property
    def subelems(self) -> Tuple[Tuple[Tuple[int, ...], ...], ...]:
        """Simplices tiling one cell, as tuples of local vertex offsets."""
        return _SUBELEMS[self.dim]

    # ------------------------------------------------------------------
    def axis_nodes(self, axis: int) -> np.ndarray:
        """Node coordinates along one axis (float64, closed form)."""
        n = self.n_cells[axis]
        return self.origin[axis] + self.spacing[axis] * np.arange(n + 1)

    @cached_property
    def node_coords(self) -> np.ndarray:
        """All node coordinates, shape ``[*node_shape, dim]`` (param space)."""
        axes = [self.axis_nodes(a) for a in range(self.dim)]
        grids = np.meshgrid(*axes, indexing="ij")
        return np.stack(grids, axis=-1)

    def flat_node_coords(self) -> np.ndarray:
        """Node coordinates flattened to ``[N, dim]`` in lexicographic order.

        x varies fastest (matching ``flatten_values``).
        """
        c = self.node_coords  # [*shape, dim] with axis 0 = x
        # Move x to the last grid axis so that C-order flattening is x-fastest.
        c = np.moveaxis(c, range(self.dim), range(self.dim)[::-1])
        return c.reshape(-1, self.dim)

    def subelem_vertices(self, t: int) -> np.ndarray:
        """Physical (param-space) vertex coords of sub-simplex ``t`` of the
        cell anchored at the origin — shape ``[dim+1, dim]``.  Identical for
        every cell (uniform spacing)."""
        offs = np.array(self.subelems[t], dtype=np.float64)
        return offs * np.array(self.spacing)

    # ------------------------------------------------------------------
    def boundary_mask(self) -> np.ndarray:
        """Boolean mask over ``node_shape``: True on the mesh boundary."""
        mask = np.zeros(self.node_shape, dtype=bool)
        for a in range(self.dim):
            idx_lo = [slice(None)] * self.dim
            idx_lo[a] = 0
            idx_hi = [slice(None)] * self.dim
            idx_hi[a] = -1
            mask[tuple(idx_lo)] = True
            mask[tuple(idx_hi)] = True
        return mask

    def face_mask(self, axis: int, side: int) -> np.ndarray:
        """Mask of nodes on one face: ``side`` is 0 (low) or 1 (high)."""
        mask = np.zeros(self.node_shape, dtype=bool)
        idx = [slice(None)] * self.dim
        idx[axis] = 0 if side == 0 else -1
        mask[tuple(idx)] = True
        return mask


def interval_mesh(n: int, a: float, b: float) -> StructuredMesh:
    return StructuredMesh((n,), (a,), (b - a,))


def rectangle_mesh(nx: int, ny: int, p0: Sequence[float], p1: Sequence[float]) -> StructuredMesh:
    return StructuredMesh(
        (nx, ny), (float(p0[0]), float(p0[1])),
        (float(p1[0] - p0[0]), float(p1[1] - p0[1])),
    )


def box_mesh(nx: int, ny: int, nz: int, p0: Sequence[float], p1: Sequence[float]) -> StructuredMesh:
    return StructuredMesh(
        (nx, ny, nz),
        (float(p0[0]), float(p0[1]), float(p0[2])),
        (float(p1[0] - p0[0]), float(p1[1] - p0[1]), float(p1[2] - p0[2])),
    )


def flatten_values(grid_values: np.ndarray, dim: int) -> np.ndarray:
    """Flatten node-grid values to lexicographic order with x fastest.

    ``grid_values`` has grid axes ordered (x, y, z, ...extras); output is
    ``[N, ...extras]`` matching :meth:`StructuredMesh.flat_node_coords`.
    """
    v = np.asarray(grid_values)
    v = np.moveaxis(v, range(dim), range(dim)[::-1])
    return v.reshape((-1,) + v.shape[dim:])
