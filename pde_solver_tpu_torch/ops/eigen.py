"""Smallest generalized eigenpairs K φ = λ M φ — modal analysis.

Counterpart of ``pde_solver_tpu.ops.eigen``: natural frequencies and mode
shapes via Rayleigh–Ritz-accelerated block inverse (subspace) iteration.
Each iteration solves k SPD systems K x = M y with the same solver stack
as every static solve (masked, scaled stencil CG or the double-float32
F-cycle on the multigrid hierarchy kept in ``linsolve._MG_CACHE``),
M-orthonormalizes the block, and rotates it with the k×k Ritz problem — the
standard robust scheme for a handful of low modes, degenerate pairs
included.  All block arithmetic is host numpy (k ≤ ~20 vectors); the heavy
lifting is the device solves.

Dirichlet constraints restrict the problem to the free subspace: vectors
are masked, and the constrained operator (identity rows) is never allowed
to inject spurious λ=1 modes because iterate components on constrained
DOFs are explicitly zeroed.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from pde_solver_tpu_torch.config import SolverConfig, get_config
from pde_solver_tpu_torch.mesh import StructuredMesh
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.ops.linsolve import (np_stencil_apply,
                                               solve_stencil_system)
from pde_solver_tpu_torch.utils.observability import get_logger


def _flat(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float64).reshape(-1)


def smallest_modes(
    K: Dict, M: Dict, mesh: StructuredMesh, bc: DirichletBC,
    num_modes: int = 4, vdim: int = 1,
    tol: float = 1e-8, max_iters: int = 60,
    config: Optional[SolverConfig] = None,
    mg_level_builder=None,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Returns (lams [k] ascending, modes [k, *node_shape(, v)], info).

    Modes are M-orthonormal (φᵢᵀ M φⱼ = δᵢⱼ) and zero on constrained DOFs.
    ``tol``: relative eigen-residual ‖Kφ − λMφ‖ / ‖λMφ‖ per mode.
    """
    cfg = config or get_config()
    d = mesh.dim
    k = int(num_modes)
    shape = mesh.node_shape + ((vdim,) if vdim > 1 else ())
    free = np.asarray(bc.free_mask, np.float64).reshape(shape)
    # the eigenproblem lives in the HOMOGENEOUS free subspace — any
    # nonzero Dirichlet data on the incoming bc would inject a lift
    bc = DirichletBC(bc.free_mask, np.zeros_like(np.asarray(bc.values)))

    def K_apply(x):
        return free * np_stencil_apply(K, free * x, d, vdim)

    def M_apply(x):
        return free * np_stencil_apply(M, free * x, d, vdim)

    # oversampled block accelerates the tail modes and absorbs degeneracy
    m_block = min(int(np.count_nonzero(free)), k + max(2, k // 2))
    rng = np.random.default_rng(seed)
    X = [free * rng.standard_normal(shape) for _ in range(m_block)]

    def m_orthonormalize(vecs):
        out = []
        for v in vecs:
            w = v.copy()
            for u, Mu in out:
                w = w - (_flat(Mu) @ _flat(w)) * u
            Mw = M_apply(w)
            nrm = np.sqrt(max(_flat(Mw) @ _flat(w), 0.0))
            if nrm < 1e-14:
                continue  # defective direction — drop it
            out.append((w / nrm, Mw / nrm))
        return out

    lams = np.zeros(m_block)
    total_cg = 0
    converged = False
    it = 0
    for it in range(1, max_iters + 1):
        # inverse iteration: Y = K⁻¹ M X (device SPD solves, cached MG)
        Y = []
        for x in X:
            rhs = M_apply(x)
            y, stats = solve_stencil_system(
                K, mesh, bc, rhs, vdim=vdim, config=cfg,
                mg_level_builder=mg_level_builder)
            total_cg += int(stats.iterations)
            Y.append(free * np.asarray(y, np.float64).reshape(shape))
        basis = m_orthonormalize(Y)
        if len(basis) < k:
            raise RuntimeError("modal subspace collapsed — operator may be "
                               "singular on the free subspace")
        # Rayleigh-Ritz on the M-orthonormal basis: Kr = VᵀKV (Mr = I)
        V = [v for v, _ in basis]
        KV = [K_apply(v) for v in V]
        n_b = len(V)
        Kr = np.empty((n_b, n_b))
        for i in range(n_b):
            for j in range(i, n_b):
                Kr[i, j] = Kr[j, i] = _flat(V[i]) @ _flat(KV[j])
        w, Q = np.linalg.eigh(Kr)
        X = [sum(Q[i, j] * V[i] for i in range(n_b)) for j in range(n_b)]
        lams = w
        # eigen-residuals of the leading k Ritz pairs
        res = []
        for j in range(k):
            lmx = lams[j] * M_apply(X[j])
            r = K_apply(X[j]) - lmx
            res.append(np.linalg.norm(_flat(r))
                       / max(np.linalg.norm(_flat(lmx)), 1e-300))
        if max(res) < tol:
            converged = True
            break
    get_logger().info(
        "modal analysis: %d modes in %d subspace iterations (%d CG total), "
        "max residual %.2e", k, it, total_cg, max(res))
    modes = np.stack(X[:k])
    info = {"iterations": it, "cg_iterations": total_cg,
            "max_residual": float(max(res)), "converged": bool(converged)}
    return np.asarray(lams[:k]), modes, info
