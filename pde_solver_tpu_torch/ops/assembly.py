"""Stencil assembly: vectorized slice-add FEM assembly on structured meshes.

Replaces DOLFIN's sparse-matrix assembly (``assemble``/``solve(a==L,...)``
inside every reference solver, e.g. fenics_mcp_server.py:304-311) with
*stencil-form* operators: for each node-offset ``o`` reachable through an
element edge, a dense array ``W_o`` over the node grid holds the matrix
entries ``A[n, n+o]``.  Assembly walks the (sub-element type, local dof pair)
combinations — a handful of statically-unrolled shifted-slice adds over the
cell grid — instead of gather/scatter on explicit connectivity.  Everything is
exact P1 FEM; there is no matrix format conversion and no Python per-cell
loop (the reference's composite-material path loops over cells in Python,
fenics_mcp_server.py:563-567).

Weighted forms (cylindrical r, spherical r², r² sinθ — the coordinate-weight
device the reference uses at fenics_mcp_server.py:859, :996, :1122, :1254,
:1393) enter through ``weight_fn`` evaluated at quadrature points; per-element
material coefficients (composite cores) enter through ``cell_coeff``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np

from pde_solver_tpu_torch.mesh import StructuredMesh
from pde_solver_tpu_torch.ops.elements import (
    SubElemGeometry,
    elasticity_element_matrix,
    subelem_geometry,
)

Offset = Tuple[int, ...]
Stencil = Dict[Offset, np.ndarray]
WeightFn = Callable[[np.ndarray], np.ndarray]  # [*, d] coords -> [*] values


# ----------------------------------------------------------------------
# Helpers
# ----------------------------------------------------------------------

def _node_region(mesh: StructuredMesh, delta: Tuple[int, ...]):
    """Slice of the node grid addressed by ``cell_index + delta``."""
    return tuple(slice(d, d + n) for d, n in zip(delta, mesh.cell_shape))


def subelem_vertex_mean(mesh: StructuredMesh, grid: np.ndarray) -> np.ndarray:
    """Per-sub-element vertex mean of a nodal field, ``[n_sub, *cells]``.

    For P1 fields this equals the exact element average (the mean of a
    linear function over a simplex is its vertex mean).  Shared by the
    thermal RHS (:func:`assemble_thermal_load`) and the stress-side
    per-element ΔT̄ in ``models.elasticity`` — the two MUST agree or
    σ = C:ε − β ΔT̄ I silently loses consistency between the load and the
    postprocessing (ADVICE r4)."""
    grid = np.asarray(grid, dtype=np.float64)
    out = np.zeros((len(mesh.subelems),) + mesh.cell_shape)
    for t, sub in enumerate(mesh.subelems):
        for delta in sub:
            out[t] += grid[_node_region(mesh, delta)]
        out[t] /= float(len(sub))
    return out


def _cell_origins(mesh: StructuredMesh) -> Tuple[np.ndarray, ...]:
    """Per-axis cell low-corner coordinates (1D arrays, broadcastable)."""
    outs = []
    for a in range(mesh.dim):
        c = mesh.origin[a] + mesh.spacing[a] * np.arange(mesh.n_cells[a])
        shape = [1] * mesh.dim
        shape[a] = -1
        outs.append(c.reshape(shape))
    return tuple(outs)


def _qpt_weight_per_cell(mesh: StructuredMesh, geom: SubElemGeometry,
                         weight_fn: Optional[WeightFn]) -> Union[np.ndarray, float]:
    """Evaluate ``weight_fn`` at every quadrature point of every cell.

    Returns ``[nq, *cell_shape]`` (or scalar 1.0 when no weight).  Uses
    broadcast arithmetic: absolute coords = cell origin + cell-local point.
    """
    if weight_fn is None:
        return 1.0
    origins = _cell_origins(mesh)
    nq = geom.qpts.shape[0]
    vals = np.empty((nq,) + mesh.cell_shape, dtype=np.float64)
    for q in range(nq):
        coords = [origins[a] + geom.qpts[q, a] for a in range(mesh.dim)]
        # Build [*cell_shape, d] lazily via stacked broadcast
        full = np.stack(np.broadcast_arrays(*coords), axis=-1)
        vals[q] = weight_fn(full)
    return vals


def _coeff_for_subelem(cell_coeff: Optional[np.ndarray], t: int,
                       mesh: StructuredMesh) -> Union[np.ndarray, float]:
    """Per-cell coefficient for sub-element type ``t`` (1.0 if absent).

    ``cell_coeff`` may be ``[*cell_shape]`` (same for all sub-elements) or
    ``[n_sub, *cell_shape]`` (per sub-simplex, e.g. composite-core marking).
    """
    if cell_coeff is None:
        return 1.0
    arr = np.asarray(cell_coeff, dtype=np.float64)
    if arr.shape == mesh.cell_shape:
        return arr
    if arr.shape == (len(mesh.subelems),) + mesh.cell_shape:
        return arr[t]
    raise ValueError(f"cell_coeff shape {arr.shape} does not match cells {mesh.cell_shape}")


def _zeros_stencil(mesh: StructuredMesh, extra: Tuple[int, ...] = ()) -> Stencil:
    return {}


def _accum(stencil: Stencil, mesh: StructuredMesh, offset: Offset,
           delta_a: Tuple[int, ...], contrib: Union[np.ndarray, float],
           extra_shape: Tuple[int, ...] = ()):
    """stencil[offset][cells + delta_a] += contrib (broadcast over cells)."""
    if offset not in stencil:
        stencil[offset] = np.zeros(mesh.node_shape + extra_shape, dtype=np.float64)
    region = _node_region(mesh, delta_a)
    stencil[offset][region] += contrib


# ----------------------------------------------------------------------
# Scalar operators (heat / poisson / mass)
# ----------------------------------------------------------------------

def assemble_scalar_stencil(
    mesh: StructuredMesh,
    term: str,
    weight_fn: Optional[WeightFn] = None,
    cell_coeff: Optional[np.ndarray] = None,
    quad_degree: Optional[int] = None,
) -> Stencil:
    """Assemble a scalar bilinear form into stencil arrays.

    term="stiffness": A[n,m] = ∫ c(K) w(x) ∇φ_n · ∇φ_m dx
    term="mass":      A[n,m] = ∫ c(K) w(x) φ_n φ_m dx

    where ``w`` is the (optional) coordinate weight evaluated by quadrature
    and ``c`` the (optional) per-element coefficient.
    """
    if term not in ("stiffness", "mass"):
        raise ValueError(term)
    if quad_degree is None:
        # Exact for polynomial weights up to degree 2 (covers 1, r, r²);
        # transcendental weights (sinθ) get a high-order rule.
        quad_degree = 2 if term == "stiffness" else 4
    stencil: Stencil = {}
    subelems = mesh.subelems
    for t, sub in enumerate(subelems):
        geom = subelem_geometry(mesh, t, quad_degree)
        wq = _qpt_weight_per_cell(mesh, geom, weight_fn)  # [nq, *cells] or 1.0
        coeff = _coeff_for_subelem(cell_coeff, t, mesh)   # [*cells] or 1.0
        n_loc = len(sub)
        if term == "stiffness":
            # grads constant ⇒ M[a,b] = (g_a·g_b) * Σ_q qwts_q * w_q
            gdot = geom.grads @ geom.grads.T  # [n_loc, n_loc]
            if isinstance(wq, float):
                wsum: Union[np.ndarray, float] = geom.volume * wq
            else:
                wsum = np.tensordot(geom.qwts, wq, axes=(0, 0))  # [*cells]
            for a in range(n_loc):
                for b in range(n_loc):
                    contrib = gdot[a, b] * wsum * coeff
                    off = tuple(sb - sa for sa, sb in zip(sub[a], sub[b]))
                    _accum(stencil, mesh, off, sub[a], contrib)
        else:  # mass
            for a in range(n_loc):
                for b in range(n_loc):
                    base = geom.qwts * geom.qphi[:, a] * geom.qphi[:, b]  # [nq]
                    if isinstance(wq, float):
                        contrib: Union[np.ndarray, float] = float(base.sum()) * wq
                    else:
                        contrib = np.tensordot(base, wq, axes=(0, 0))  # [*cells]
                    off = tuple(sb - sa for sa, sb in zip(sub[a], sub[b]))
                    _accum(stencil, mesh, off, sub[a], contrib * coeff)
    return stencil


def assemble_load(
    mesh: StructuredMesh,
    source_fn: Optional[WeightFn] = None,
    weight_fn: Optional[WeightFn] = None,
    cell_coeff: Optional[np.ndarray] = None,
    quad_degree: int = 4,
) -> np.ndarray:
    """Assemble the load vector b[n] = ∫ c(K) w(x) f(x) φ_n dx over the grid.

    ``source_fn`` defaults to 1 so a constant source is
    ``source_value * assemble_load(mesh, weight_fn=w)``.
    """
    b = np.zeros(mesh.node_shape, dtype=np.float64)
    for t, sub in enumerate(mesh.subelems):
        geom = subelem_geometry(mesh, t, quad_degree)
        wq = _qpt_weight_per_cell(mesh, geom, weight_fn)
        fq = _qpt_weight_per_cell(mesh, geom, source_fn)
        coeff = _coeff_for_subelem(cell_coeff, t, mesh)
        total = wq * fq if not (isinstance(wq, float) and isinstance(fq, float)) else wq * fq
        for a in range(len(sub)):
            base = geom.qwts * geom.qphi[:, a]  # [nq]
            if isinstance(total, float):
                contrib: Union[np.ndarray, float] = float(base.sum()) * total
            else:
                contrib = np.tensordot(base, total, axes=(0, 0))
            region = _node_region(mesh, sub[a])
            b[region] += contrib * coeff
    return b


def assemble_convection_stencil(
    mesh: StructuredMesh,
    velocity: np.ndarray,
    weight_fn: Optional[WeightFn] = None,
) -> Stencil:
    """Assemble the (non-symmetric) convection form C[n,m] = ∫ w (v·∇φ_m) φ_n dx.

    Constant velocity ``v``; P1 gradients are constant per sub-element, so
    the local matrix is (v·g_b) ∫ w φ_a dx.  Applied EXPLICITLY in IMEX
    advection-diffusion stepping (the implicit side stays SPD), so the
    stencil machinery never needs a non-symmetric solve.  Exactly
    reproduces the Galerkin convection term (no upwinding — stabilization
    comes from physical diffusion; callers guard the cell-Péclet/CFL).
    """
    v = np.asarray(velocity, dtype=np.float64).reshape(mesh.dim)
    stencil: Stencil = {}
    for t, sub in enumerate(mesh.subelems):
        geom = subelem_geometry(mesh, t, 2 if weight_fn is None else 4)
        wq = _qpt_weight_per_cell(mesh, geom, weight_fn)
        vg = geom.grads @ v  # [n_loc] — v·∇φ_b, constant per element
        for a in range(len(sub)):
            base = geom.qwts * geom.qphi[:, a]  # [nq] → ∫ w φ_a
            if isinstance(wq, float):
                phi_a: Union[np.ndarray, float] = float(base.sum()) * wq
            else:
                phi_a = np.tensordot(base, wq, axes=(0, 0))
            for b in range(len(sub)):
                off = tuple(sb - sa for sa, sb in zip(sub[a], sub[b]))
                _accum(stencil, mesh, off, sub[a], phi_a * vg[b])
    return stencil


# ----------------------------------------------------------------------
# Vector operators (linear elasticity)
# ----------------------------------------------------------------------

def assemble_elasticity_stencil(mesh: StructuredMesh, lam: float, mu: float) -> Stencil:
    """Assemble ∫ σ(u):ε(v) dx into a block stencil.

    Returns {offset: [*node_shape, d, d]} arrays.  The material is
    homogeneous (as in the reference elasticity solvers), so entries are
    constant except for boundary truncation, which the slice-adds encode
    automatically.
    """
    d = mesh.dim
    stencil: Stencil = {}
    for t, sub in enumerate(mesh.subelems):
        geom = subelem_geometry(mesh, t, 0)
        K = elasticity_element_matrix(geom, lam, mu)  # [n_loc, d, n_loc, d]
        for a in range(len(sub)):
            for b in range(len(sub)):
                off = tuple(sb - sa for sa, sb in zip(sub[a], sub[b]))
                _accum(stencil, mesh, off, sub[a], K[a, :, b, :], extra_shape=(d, d))
    return stencil


def assemble_vector_load(mesh: StructuredMesh, body_force: np.ndarray) -> np.ndarray:
    """b[n, i] = ∫ f_i φ_n dx for a constant body-force vector."""
    b_scalar = assemble_load(mesh, quad_degree=1)  # ∫ φ_n dx
    return b_scalar[..., None] * np.asarray(body_force, dtype=np.float64)


def assemble_thermal_load(mesh: StructuredMesh, beta: float,
                          dT_grid: Union[np.ndarray, float]) -> np.ndarray:
    """Thermal-expansion load b[n, i] = ∫ β ΔT(x) ∂φ_n/∂x_i dx.

    Weak form of the thermal prestress: σ_th = −β ΔT I contributes
    +∫ β ΔT div(v) dx to the RHS, and div(φ_n e_i) = ∂φ_n/∂x_i.  ``β`` is
    the full thermal-stress coefficient (see
    ``thermal_stress_coefficient`` in the JAX package);
    ``dT_grid`` is the nodal temperature rise T − T_ref ([*node_shape]) or
    a uniform scalar.  Exact for P1 ΔT: gradients are constant per simplex
    and the mean of a linear function over a simplex is the vertex mean,
    so ∫_K ΔT ∂φ_a/∂x_i = |K| · mean(ΔT_vertices) · g_a[i].

    Capability beyond the reference (its elasticity loads are body forces
    only, fenics_mcp_server.py:1670-1674, :1820-1824)."""
    d = mesh.dim
    b = np.zeros(mesh.node_shape + (d,), dtype=np.float64)
    uniform = np.isscalar(dT_grid) or np.asarray(dT_grid).ndim == 0
    dT = None if uniform else np.asarray(dT_grid, dtype=np.float64)
    if dT is not None and dT.shape != mesh.node_shape:
        raise ValueError(f"dT_grid shape {dT.shape} != nodes {mesh.node_shape}")
    dT_means = None if uniform else subelem_vertex_mean(mesh, dT)
    for t, sub in enumerate(mesh.subelems):
        geom = subelem_geometry(mesh, t, 0)
        if uniform:
            dT_bar: Union[np.ndarray, float] = float(dT_grid)
        else:
            dT_bar = dT_means[t]
        scale = float(beta) * geom.volume
        for a, delta in enumerate(sub):
            contrib = scale * np.multiply.outer(dT_bar, geom.grads[a]) \
                if not uniform else scale * dT_bar * geom.grads[a]
            b[_node_region(mesh, delta)] += contrib
    return b


# ----------------------------------------------------------------------
# Dense reference (tests / small problems)
# ----------------------------------------------------------------------

def stencil_to_dense(mesh: StructuredMesh, stencil: Stencil, vdim: int = 1) -> np.ndarray:
    """Materialize a stencil into a dense [N*vdim, N*vdim] matrix (tests only)."""
    shape = mesh.node_shape
    N = int(np.prod(shape))
    A = np.zeros((N * vdim, N * vdim))
    # Lexicographic numbering with x fastest (matches flat_node_coords).
    idx = np.arange(N).reshape(tuple(reversed(shape))).transpose(tuple(reversed(range(len(shape)))))
    for off, W in stencil.items():
        src = tuple(
            slice(max(0, -o), s - max(0, o)) for o, s in zip(off, shape)
        )
        dst = tuple(
            slice(max(0, o), s - max(0, -o)) for o, s in zip(off, shape)
        )
        rows = idx[src].ravel()
        cols = idx[dst].ravel()
        if vdim == 1:
            A[rows, cols] += W[src].reshape(-1)
        else:
            Wb = W[src].reshape(-1, vdim, vdim)
            for i in range(vdim):
                for j in range(vdim):
                    A[rows * vdim + i, cols * vdim + j] += Wb[:, i, j]
    return A
