"""Boundary (surface) integrals on structured meshes: Robin/Neumann terms
and surface tractions.

Copied from ``pde_solver_tpu.ops.surface`` (numpy only); tests hold the two
bit-equal.  Extends the framework beyond the reference's Dirichlet-only heat
solvers (fenics_mcp_server.py:204-762 support only ``DirichletBC``):
convective (Robin) and prescribed-flux (Neumann) conditions enter the weak
form as boundary integrals

    ... + ∫_Γ h u v ds = ... + ∫_Γ (h T_inf + q_in) v ds

where ``-κ ∂u/∂n = h (u - T_inf) - q_in`` on Γ (``q_in`` = prescribed INWARD
heat flux).  The Robin term adds a positive-semidefinite surface mass to the
stiffness stencil, so the operator stays SPD for CG/MG; a face with neither
Dirichlet nor Robin/flux data is the natural (insulated, zero-flux) boundary.

Mechanics: a box face of the Freudenthal-split mesh is itself a
structured simplicial mesh — the tet faces lying in a boundary plane form
exactly the 2D "right"-diagonal triangle split on the remaining axes (and a
2D mesh's boundary edges form a 1D interval mesh).  Surface terms therefore
assemble with the SAME vectorized stencil assembly (:mod:`assembly`) on the
(d-1)-dimensional face mesh and scatter into the zero-normal-offset planes of
the volume stencil.  No new quadrature code, no per-facet loops.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from pde_solver_tpu_torch.mesh import StructuredMesh
from pde_solver_tpu_torch.ops import assembly

Offset = Tuple[int, ...]
Stencil = Dict[Offset, np.ndarray]


def face_mesh(mesh: StructuredMesh, axis: int) -> Optional[StructuredMesh]:
    """The (d-1)-dimensional structured mesh of a face normal to ``axis``.

    Remaining axes keep their original order (matching the boundary
    triangulation induced by the volume simplex split).  Returns ``None``
    for 1D meshes (the face is a single point)."""
    keep = [a for a in range(mesh.dim) if a != axis]
    if not keep:
        return None
    return StructuredMesh(
        tuple(mesh.n_cells[a] for a in keep),
        tuple(mesh.origin[a] for a in keep),
        tuple(mesh.extent[a] for a in keep),
    )


def _face_coord(mesh: StructuredMesh, axis: int, side: int) -> float:
    return mesh.origin[axis] + (mesh.extent[axis] if side else 0.0)


def _face_weight_fn(mesh: StructuredMesh, axis: int, side: int, weight_fn):
    """Restrict a full-dimension coordinate weight to the face plane."""
    if weight_fn is None:
        return None
    fixed = _face_coord(mesh, axis, side)

    def wf(coords_face: np.ndarray) -> np.ndarray:
        parts = []
        k = 0
        for a in range(mesh.dim):
            if a == axis:
                parts.append(np.full(coords_face.shape[:-1], fixed))
            else:
                parts.append(coords_face[..., k])
                k += 1
        return weight_fn(np.stack(parts, axis=-1))

    return wf


def _plane_index(mesh: StructuredMesh, axis: int, side: int):
    idx = [slice(None)] * mesh.dim
    idx[axis] = -1 if side else 0
    return tuple(idx)


def assemble_face_mass(mesh: StructuredMesh, axis: int, side: int,
                       coeff: float = 1.0, weight_fn=None,
                       quad_degree: Optional[int] = None) -> Stencil:
    """``A[n,m] += coeff ∫_face w φ_n φ_m ds`` as a volume-shaped stencil.

    Every offset has zero component along ``axis``; arrays are nonzero only
    on the face plane, so adding into a volume stencil (``add_stencil``)
    keeps symmetry and SPD-ness (the term is a PSD surface mass)."""
    if mesh.dim == 1:
        w = 1.0
        if weight_fn is not None:
            x = np.array([[_face_coord(mesh, 0, side)]])
            w = float(weight_fn(x)[0])
        W = np.zeros(mesh.node_shape, dtype=np.float64)
        W[-1 if side else 0] = coeff * w
        return {(0,): W}
    fm = face_mesh(mesh, axis)
    wf = _face_weight_fn(mesh, axis, side, weight_fn)
    sub = assembly.assemble_scalar_stencil(fm, "mass", weight_fn=wf,
                                           quad_degree=quad_degree)
    plane = _plane_index(mesh, axis, side)
    out: Stencil = {}
    for off, Wf in sub.items():
        full_off = list(off)
        full_off.insert(axis, 0)
        W = np.zeros(mesh.node_shape, dtype=np.float64)
        W[plane] = coeff * Wf
        out[tuple(full_off)] = W
    return out


def assemble_face_load(mesh: StructuredMesh, axis: int, side: int,
                       coeff: float = 1.0, weight_fn=None,
                       quad_degree: int = 4) -> np.ndarray:
    """``b[n] += coeff ∫_face w φ_n ds`` over the volume node grid."""
    b = np.zeros(mesh.node_shape, dtype=np.float64)
    if mesh.dim == 1:
        w = 1.0
        if weight_fn is not None:
            x = np.array([[_face_coord(mesh, 0, side)]])
            w = float(weight_fn(x)[0])
        b[-1 if side else 0] = coeff * w
        return b
    fm = face_mesh(mesh, axis)
    wf = _face_weight_fn(mesh, axis, side, weight_fn)
    bf = assembly.assemble_load(fm, weight_fn=wf, quad_degree=quad_degree)
    b[_plane_index(mesh, axis, side)] = coeff * bf
    return b


def add_stencil(target: Stencil, extra: Stencil) -> Stencil:
    """Return ``target + extra`` (new dict; arrays copied only when summed)."""
    out = dict(target)
    for off, W in extra.items():
        out[off] = (out[off] + W) if off in out else W
    return out
