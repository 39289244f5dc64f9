"""Scattered→grid field resampling for plotting.

The reference re-runs ``scipy.interpolate.griddata`` per animation frame
(fenics_mcp_server.py:3803-3807, :3980-3984, :2986) — rebuilding the Delaunay
triangulation Nt times.  Here the spatial structure is computed once and
reused for every frame:

* structured fast path: if the points form a tensor-product grid (every field
  this framework produces), interpolation reduces to fractional-index lookup
  via ``scipy.ndimage.map_coordinates`` — no triangulation at all;
* scattered path: one ``Delaunay`` + per-frame ``LinearNDInterpolator`` reuse,
  with a single ``cKDTree`` for nearest-neighbor fill.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import ndimage
from scipy.interpolate import LinearNDInterpolator, NearestNDInterpolator
from scipy.spatial import Delaunay, cKDTree


def detect_structured_grid(points: np.ndarray, tol: float = 1e-9
                           ) -> Optional[Tuple[Tuple[np.ndarray, ...], np.ndarray]]:
    """If ``points`` [N, d] form a full tensor-product grid, return
    (axes, index) where ``values[index]`` reshapes a flat field to the grid.
    Returns None otherwise."""
    N, d = points.shape
    axes = [np.unique(points[:, a]) for a in range(d)]
    if int(np.prod([len(a) for a in axes])) != N:
        return None
    idx_per_axis = []
    for a in range(d):
        j = np.searchsorted(axes[a], points[:, a])
        scale = max(1.0, float(np.abs(axes[a]).max()))
        if not np.allclose(axes[a][j], points[:, a], rtol=0, atol=tol * scale):
            return None
        idx_per_axis.append(j)
    # map each point to its grid slot; verify bijection
    flat = np.zeros(N, dtype=np.int64)
    strides = np.cumprod([1] + [len(a) for a in axes[:-1]])
    for a in range(d):
        flat += idx_per_axis[a] * strides[a]
    if len(np.unique(flat)) != N:
        return None
    order = np.argsort(flat)
    return tuple(axes), order


class FieldResampler:
    """Resample [Nt, N] scattered fields onto arbitrary query points."""

    def __init__(self, points: np.ndarray):
        self.points = np.asarray(points, dtype=np.float64)
        self.d = self.points.shape[1]
        self._structured = detect_structured_grid(self.points)
        self._tri = None
        self._kdtree = None
        if self._structured is None:
            try:
                self._tri = Delaunay(self.points)
            except Exception:
                # degenerate point sets (collinear/coplanar) have no
                # triangulation — fall back to nearest-neighbor lookup
                # instead of crashing the plot with a QhullError
                self._tri = None
            self._kdtree = cKDTree(self.points)

    def __call__(self, values: np.ndarray, query: np.ndarray) -> np.ndarray:
        """values [Nt, N] (or [N]), query [M, d] → [Nt, M] (or [M])."""
        single = values.ndim == 1
        vals = np.atleast_2d(np.asarray(values, dtype=np.float64))
        out = np.empty((vals.shape[0], len(query)))
        if self._structured is not None:
            axes, order = self._structured
            grid_shape = tuple(len(a) for a in axes)
            # fractional indices of query points along each axis (clamped →
            # nearest-neighbor extrapolation outside the hull, like the
            # reference's nearest fill)
            frac = []
            for a in range(self.d):
                ax = axes[a]
                q = np.clip(query[:, a], ax[0], ax[-1])
                j = np.clip(np.searchsorted(ax, q) - 1, 0, len(ax) - 2)
                denom = np.where(ax[j + 1] > ax[j], ax[j + 1] - ax[j], 1.0)
                frac.append(j + (q - ax[j]) / denom)
            coords = np.stack(frac)  # note: grid axes ordered (a0 fastest)
            for i in range(vals.shape[0]):
                # flat order is a0-fastest → reshape Fortran-style
                g = vals[i][order].reshape(grid_shape, order="F")
                out[i] = ndimage.map_coordinates(g, coords, order=1, mode="nearest")
        else:
            _, nn_idx = self._kdtree.query(query)
            for i in range(vals.shape[0]):
                if self._tri is None:  # degenerate: nearest-neighbor only
                    out[i] = vals[i][nn_idx]
                    continue
                interp = LinearNDInterpolator(self._tri, vals[i])
                vi = interp(query)
                nan = np.isnan(vi)
                if nan.any():
                    vi[nan] = vals[i][nn_idx[nan]]
                out[i] = vi
        return out[0] if single else out
