"""Geometric multigrid and the double-float32 F-cycle, eager torch.

Counterpart of ``pde_solver_tpu.ops.multigrid`` for what the static
elasticity flagship runs: simplicial transfers, the level hierarchy with an
exact dense coarsest inverse, a Chebyshev-smoothed V-cycle, flexible MG-PCG
(:func:`mg_pcg`), and the per-round double-float32 F-cycle
(:func:`solve_fcycle_df2`).

Every level applies through :class:`FlatStencilOperator` (the CUDA kernel
on the card, its plain torch version on the CPU) while its DOF count is at
least ``KERNEL_MIN_DOF``: float32 weights for true residuals and a bfloat16
copy for the smoother.  Smoothing and the PCG state live in the flat
``[v, N]`` layout; grid layout only at the transfer boundary.

Scaling-aware transfers: with x = S x̂ per level (S = diag(s), or S = C^{-T}
for block-Cholesky scaling), Galerkin-consistent transfers are
P̂ = S_f^{-1} P S_c and R̂ = P̂ᵀ.  Per-node 3×3 blocks multiply as broadcast
+ sum, never as batched GEMMs (no TF32 route).

Control flow is host Python: each CG iteration reads one scalar for its
convergence test (one device sync per iteration).
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pde_solver_tpu_torch.mesh import StructuredMesh
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.ops.linsolve import (ScaledSystem, _dot, _pad1,
                                               _stencil_apply, prepare_system)
from pde_solver_tpu_torch.ops.stencil_kernels import (FlatStencilOperator,
                                                      kernel_wins)
from pde_solver_tpu_torch.utils.observability import get_logger

Offset = Tuple[int, ...]


# ----------------------------------------------------------------------
# Transfers (simplicial, structured, factor 2 per axis)
# ----------------------------------------------------------------------

def _bisection_edges(grid_dim: int):
    """Freudenthal/right-diagonal triangulation edge directions: the axes
    plus the consistent-orientation diagonals only."""
    return [p for p in itertools.product((0, 1), repeat=grid_dim) if any(p)]


def _edge_stencil_apply(x: torch.Tensor, grid_dim: int) -> torch.Tensor:
    """y = x + ½ Σ_e (x shifted ±e), e over the bisection edges, zero-padded:
    the common factor of both transfer operators."""
    shape = x.shape[:grid_dim]
    xp = _pad1(x, grid_dim)
    y = x
    for e in _bisection_edges(grid_dim):
        sl_p = tuple(slice(1 + o, 1 + o + s) for o, s in zip(e, shape))
        sl_m = tuple(slice(1 - o, 1 - o + s) for o, s in zip(e, shape))
        y = y + 0.5 * (xp[sl_p + (Ellipsis,)] + xp[sl_m + (Ellipsis,)])
    return y


def _upsample2(v: torch.Tensor, grid_dim: int) -> torch.Tensor:
    """Coarse values at the even fine sites, zeros at the odd ones."""
    shape = v.shape[:grid_dim]
    out = v.new_zeros(tuple(2 * s - 1 for s in shape) + tuple(v.shape[grid_dim:]))
    out[tuple(slice(None, None, 2) for _ in range(grid_dim))] = v
    return out


def _downsample2(r: torch.Tensor, grid_dim: int) -> torch.Tensor:
    """Keep the even sites."""
    return r[tuple(slice(None, None, 2) for _ in range(grid_dim))]


def prolong(v: torch.Tensor, grid_dim: int) -> torch.Tensor:
    """Simplicial P1 interpolation on the Freudenthal split: the fine node at
    2c+p gets ½(v[c] + v[c+p]) — the coarse P1 space is exactly nested in
    the fine one, so the re-assembled coarse operator is Galerkin PᵀAP."""
    return _edge_stencil_apply(_upsample2(v, grid_dim), grid_dim)


def restrict(r: torch.Tensor, grid_dim: int) -> torch.Tensor:
    """Adjoint of :func:`prolong`: downsample₂(S ⊛ r)."""
    return _downsample2(_edge_stencil_apply(r, grid_dim), grid_dim)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-node M[..., i, j] v[..., j] as broadcast multiply + sum."""
    return (M * v[..., None, :]).sum(-1)


def _matvec_t(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-node M[..., j, i] v[..., j] (the transpose)."""
    return (M * v[..., :, None]).sum(-2)


# ----------------------------------------------------------------------
# Hierarchy
# ----------------------------------------------------------------------

class MGLevel(NamedTuple):
    offsets: Tuple[Offset, ...]
    weights: object                      # FlatStencilOperator (f32) or a
                                         # tuple of per-offset tensors — the
                                         # true operator (outer residuals)
    free: torch.Tensor                   # f32 mask over DOFs (grid layout)
    omega: float                         # 4/(3 λmax)
    s: Optional[torch.Tensor]            # scalar 1/sqrt(diag); None for block
    C: Optional[torch.Tensor]            # block Cholesky factor [.., v, v]
    Cinv: Optional[torch.Tensor]
    Ainv: Optional[torch.Tensor] = None  # dense inverse (coarsest level only)
    host_weights: Optional[list] = None  # f64 numpy copies (df ladder)
    host_Ainv: Optional[np.ndarray] = None
    host_scale: Optional[tuple] = None   # (s,) or (C, Cinv) f64 numpy
    # Preconditioner-grade operator for smoothing (bf16 weights).  The
    # V-cycle stays a fixed symmetric operator built from w_lo at every
    # level; only mg_pcg's true residual needs the f32 weights.
    w_lo: Optional[object] = None

    @property
    def w_smooth(self):
        return self.w_lo if self.w_lo is not None else self.weights


class MGHierarchy(NamedTuple):
    levels: Tuple[MGLevel, ...]          # finest first
    grid_dim: int
    vdim: int
    pre_smooth: int
    post_smooth: int
    coarse_iters: int  # fallback only — used when no dense inverse fits


def dense_from_stencil(offsets, weights, node_shape, vdim: int) -> np.ndarray:
    """Densify a stencil into [N·v, N·v] with C-order DOF numbering."""
    N = int(np.prod(node_shape))
    strides = []
    acc = 1
    for s in reversed(node_shape):
        strides.append(acc)
        acc *= s
    strides = list(reversed(strides))
    n = N * vdim
    A = np.zeros((n, n))
    rows = np.arange(N)
    for off, W in zip(offsets, weights):
        delta = int(sum(o * st for o, st in zip(off, strides)))
        cols = rows + delta
        valid = (cols >= 0) & (cols < N)
        Wf = (np.asarray(W, np.float64).reshape(N, vdim, vdim) if vdim > 1
              else np.asarray(W, np.float64).reshape(N, 1, 1))
        r, c = rows[valid], cols[valid]
        for a in range(vdim):
            for b in range(vdim):
                A[r * vdim + a, c * vdim + b] += Wf[valid, a, b]
    return A


def can_coarsen(mesh: StructuredMesh, min_cells: int = 2) -> bool:
    return all(c % 2 == 0 and c // 2 >= min_cells for c in mesh.n_cells)


def coarsen_mesh(mesh: StructuredMesh) -> StructuredMesh:
    return StructuredMesh(tuple(c // 2 for c in mesh.n_cells),
                          mesh.origin, mesh.extent)


def _power_iteration(offsets, weights, x, grid_dim, vdim, iters) -> float:
    """λmax estimate of the scaled operator (setup only)."""
    lam = torch.tensor(2.0, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        y = _stencil_apply(offsets, weights, x, grid_dim, vdim)
        lam = torch.sqrt(_dot(y, y))
        x = y / torch.clamp(lam, min=1e-30)
    return float(lam)


class _ShapeOnlyMesh:
    """Minimal mesh stand-in for :func:`_to_level` (node_shape + dim)."""

    def __init__(self, node_shape):
        self.node_shape = tuple(int(s) for s in node_shape)
        self.dim = len(self.node_shape)


def _to_level(sysm: ScaledSystem, mesh, vdim: int, device,
              omega: Optional[float] = None) -> MGLevel:
    """One MG level's device operators from a scaled system: the
    kernel-backed f32 operator plus its bf16 smoother copy (cast on the
    device), or plain per-offset tensors below ``KERNEL_MIN_DOF``."""
    host_w = [np.asarray(W, dtype=np.float64) for W in sysm.weights]
    free = torch.as_tensor(sysm.free, dtype=torch.float32, device=device)
    n_dof = int(np.prod(mesh.node_shape)) * vdim
    w_lo = None
    if kernel_wins(n_dof):
        w = FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                vdim=vdim, device=device)
        w_lo = w.as_weight_dtype(torch.bfloat16)
    else:
        w = tuple(torch.as_tensor(W, dtype=torch.float32, device=device)
                  for W in sysm.weights)

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    if sysm.scale_kind == "scalar":
        return MGLevel(sysm.offsets, w, free, omega, dev(sysm.s), None, None,
                       host_weights=host_w, host_scale=(np.asarray(sysm.s),),
                       w_lo=w_lo)
    C_np = np.swapaxes(sysm.Ct, -1, -2)
    Cinv_np = np.swapaxes(sysm.CinvT, -1, -2)
    return MGLevel(sysm.offsets, w, free, omega, None, dev(C_np),
                   dev(Cinv_np), host_weights=host_w,
                   host_scale=(C_np, Cinv_np), w_lo=w_lo)


def _with_coarsest_inverse(levels, host_Ainv: np.ndarray, device):
    levels[-1] = levels[-1]._replace(
        Ainv=torch.as_tensor(host_Ainv, dtype=torch.float32, device=device),
        host_Ainv=host_Ainv)
    return levels


def build_hierarchy(
    mesh: StructuredMesh,
    fine_system: ScaledSystem,
    level_builder: Callable[[StructuredMesh], Tuple[Dict, DirichletBC]],
    vdim: int = 1,
    max_levels: int = 10,
    pre_smooth: int = 2,
    post_smooth: int = 2,
    coarse_iters: int = 60,
    device="cuda",
) -> Optional[MGHierarchy]:
    """Build the level stack (float32 device operators).
    ``level_builder(mesh_c)`` re-assembles the operator + BCs on a coarse
    mesh.  Returns None when the fine mesh cannot coarsen."""
    if not can_coarsen(mesh):
        return None
    levels = [_to_level(fine_system, mesh, vdim, device)]
    meshes = [mesh]
    cur = mesh
    cur_sys = fine_system
    while len(levels) < max_levels and can_coarsen(cur):
        cur = coarsen_mesh(cur)
        stencil_c, bc_c = level_builder(cur)
        shape_c = cur.node_shape + ((vdim,) if vdim > 1 else ())
        cur_sys = prepare_system(stencil_c, cur, bc_c, np.zeros(shape_c), vdim)
        levels.append(_to_level(cur_sys, cur, vdim, device))
        meshes.append(cur)
    # λmax per level: Chebyshev smoothing diverges on any eigenvalue above
    # its assumed λmax, so it is estimated, with a 1.05 margin for the power
    # iteration's underestimate.  Seed-0 numpy start vector per level, the
    # same one the JAX package draws.
    for i, (lv, m) in enumerate(zip(levels, meshes)):
        rng = np.random.default_rng(0)
        full_shape = m.node_shape + ((vdim,) if vdim > 1 else ())
        x = torch.as_tensor(rng.standard_normal(full_shape),
                            dtype=torch.float32, device=device)
        lam = 1.05 * max(_power_iteration(lv.offsets, lv.weights, x,
                                          mesh.dim, vdim, 10), 1e-6)
        levels[i] = lv._replace(omega=float(4.0 / (3.0 * lam)))
    # Exact dense inverse at the coarsest level: an iterative coarse solve
    # leaves the preconditioner non-SPD (PCG breakdown at scale).
    n_coarse = int(np.prod(cur.node_shape)) * vdim
    if n_coarse <= 20000:
        A_dense = dense_from_stencil(cur_sys.offsets, cur_sys.weights,
                                     cur.node_shape, vdim)
        levels = _with_coarsest_inverse(levels, np.linalg.inv(A_dense), device)
    return MGHierarchy(tuple(levels), mesh.dim, vdim, pre_smooth,
                       post_smooth, coarse_iters)


# ----------------------------------------------------------------------
# V-cycle + preconditioned CG
# ----------------------------------------------------------------------

def _scales(lv: MGLevel) -> tuple:
    return (lv.s,) if lv.s is not None else (lv.C, lv.Cinv)


def _restrict_hat(fine: MGLevel, coarse: MGLevel, r_hat: torch.Tensor,
                  grid_dim: int, vdim: int) -> torch.Tensor:
    """R̂ = P̂ᵀ = S_c Pᵀ S_f^{-1} (scalar) / C_c^{-1} Pᵀ C_f (block)."""
    return _jit_restrict_hat64(_scales(fine), _scales(coarse), coarse.free,
                               r_hat, grid_dim)


def _prolong_hat(fine: MGLevel, coarse: MGLevel, e_hat_c: torch.Tensor,
                 grid_dim: int, vdim: int) -> torch.Tensor:
    """ê_f = S_f^{-1} P S_c ê_c."""
    return _jit_prolong_hat64(_scales(fine), _scales(coarse), fine.free,
                              e_hat_c, grid_dim)


def v_cycle(h: MGHierarchy, r_hat: torch.Tensor, level: int = 0,
            flat_io: bool = False) -> torch.Tensor:
    """One symmetric V-cycle approximating Â⁻¹ r̂ at ``level``.

    At kernel-backed levels all smoothing runs in the flat ``[v, N]``
    layout and only the restrict/prolong boundary converts to grid layout.
    ``flat_io=True`` (callers holding flat state, e.g. ``mg_pcg``) skips
    the entry/exit conversions too."""
    lv = h.levels[level]
    d, vdim = h.grid_dim, h.vdim

    def A(x):
        return _stencil_apply(lv.offsets, lv.w_smooth, x, d, vdim)

    if level == len(h.levels) - 1:
        if lv.Ainv is not None:
            # exact dense solve in full f32 (TF32 is off package-wide):
            # keeps the V-cycle a fixed SPD operator
            return (lv.Ainv @ r_hat.reshape(-1)).reshape(r_hat.shape)
        # fallback: fixed-iteration CG (only when the dense inverse is too big)
        x = torch.zeros_like(r_hat)
        r = r_hat
        p = r
        rz = _dot(r, r)
        for _ in range(h.coarse_iters):
            Ap = A(p)
            pAp = _dot(p, Ap)
            alpha = rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp)
            x = x + alpha * p
            r = r - alpha * Ap
            rz_new = _dot(r, r)
            beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
            p = r + beta * p
            rz = rz_new
        return x

    # Chebyshev smoother of degree ``pre_smooth`` on [λmax/4, λmax]
    # (lv.omega stores 4/(3 λmax)).  A fixed polynomial in Â, hence
    # symmetric — the V-cycle stays a valid SPD preconditioner.
    lmax = 4.0 / (3.0 * lv.omega)
    lmin = lmax / 4.0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def make_cheb(A_fn):
        def cheb(x, rhs, degree):
            res = rhs - A_fn(x)
            dvec = res / theta
            x = x + dvec
            rho_old = 1.0 / sigma
            for _ in range(degree - 1):
                rho = 1.0 / (2.0 * sigma - rho_old)
                dvec = (rho * rho_old * dvec
                        + (2.0 * rho / delta) * (rhs - A_fn(x)))
                x = x + dvec
                rho_old = rho
            return x
        return cheb

    lvc = h.levels[level + 1]
    if isinstance(lv.w_smooth, FlatStencilOperator):
        op = lv.w_smooth
        cheb = make_cheb(op.apply_flat)
        rf = r_hat if flat_io else op.to_flat(r_hat)
        xf = cheb(torch.zeros_like(rf), rf, h.pre_smooth)
        rho_f = rf - op.apply_flat(xf)
        rc = _restrict_hat(lv, lvc, op.from_flat(rho_f), d, vdim)
        ec = v_cycle(h, rc, level + 1)
        xf = xf + op.to_flat(_prolong_hat(lv, lvc, ec, d, vdim))
        xf = cheb(xf, rf, h.post_smooth)
        return xf if flat_io else op.from_flat(xf)

    cheb = make_cheb(A)
    x = cheb(torch.zeros_like(r_hat), r_hat, h.pre_smooth)
    rho_res = r_hat - A(x)
    rc = _restrict_hat(lv, lvc, rho_res, d, vdim)
    ec = v_cycle(h, rc, level + 1)
    x = x + _prolong_hat(lv, lvc, ec, d, vdim)
    return cheb(x, r_hat, h.post_smooth)


def mg_pcg(h: MGHierarchy, b: torch.Tensor, x0: torch.Tensor, tol, maxiter):
    """Flexible PCG on the finest scaled system, one V-cycle per application.

    Flexible (Polak-Ribière β = z·(r−r_prev)/rz_prev), robust to a V-cycle
    that is not an exactly fixed linear operator.  Convergence is checked on
    the recurrence residual ‖r‖, resynced to b − A x every 16 iterations.
    With a kernel-backed finest level the whole CG state lives in the flat
    layout.  Returns (x, iterations, relres)."""
    lv = h.levels[0]
    d, vdim = h.grid_dim, h.vdim

    if isinstance(lv.weights, FlatStencilOperator):
        op = lv.weights
        free = op.to_flat(lv.free)
        b = op.to_flat(b)
        x0 = op.to_flat(x0)
        A = op.apply_flat

        def M(r):
            z = v_cycle(h, r * free, flat_io=True)
            return z * free + (1.0 - free) * r
    else:
        op = None
        free = lv.free

        def A(x):
            return _stencil_apply(lv.offsets, lv.weights, x, d, vdim)

        def M(r):
            z = v_cycle(h, r * free)
            return z * free + (1.0 - free) * r

    x = x0
    r = b - A(x)
    z = M(r)
    p = z
    rz = _dot(r, z)
    bnorm2 = float(_dot(b, b))
    bnorm2 = 1.0 if bnorm2 == 0 else bnorm2
    tol2 = (tol * tol) * bnorm2
    k = 0
    rr = float(_dot(r, r))
    while rr > tol2 and k < maxiter:
        Ap = A(p)
        pAp = _dot(p, Ap)
        alpha = rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp)
        x = x + alpha * p
        r_new = r - alpha * Ap
        if k % 16 == 15:
            # true-residual resync: the recurrence drifts from b − A x in
            # f32 once conjugacy degrades
            r_new = b - A(x)
        z_new = M(r_new)
        # Polak-Ribière: β = z·(r_new − r)/rz — robust to inexact M
        rz_new = _dot(r_new, z_new)
        beta = (rz_new - _dot(z_new, r)) / torch.where(
            rz == 0, torch.ones_like(rz), rz)
        beta = torch.clamp(beta, min=0.0)  # restart guard
        p = z_new + beta * p
        r, rz = r_new, rz_new
        k += 1
        rr = float(_dot(r, r))
    relres = float(np.sqrt(rr / bnorm2))
    if op is not None:
        x = op.from_flat(x)
    return x, k, relres


# ----------------------------------------------------------------------
# Double-float32 F-cycle
# ----------------------------------------------------------------------
#
#   descend:  r_{m+1} = R̂_m r_m
#   coarsest: e_L = A_L^{-1} r_L                      (dense, exact)
#   ascend:   e_m = P̂ e_{m+1};  ρ = r_m − Â_m e_m (double-f32 exact);
#             e_m += s · MG-PCG_f32(levels m.., ρ/s)  (fixed iteration count)
#
# The f64-grade bookkeeping (operators, rhs, solution, defects) is carried
# in double-float32 pairs (ops.df32).  One F-cycle is one outer round; the
# host loop reads one scalar per round for the convergence check.

def _jit_restrict_hat64(fine_scale, coarse_scale, coarse_free, r, grid_dim):
    """Scaled restriction, level l → l+1 (``*_scale`` is (s,) for scalar
    systems or (C, Cinv) for block systems).  Eager in this port; the name
    follows the JAX package."""
    if len(fine_scale) == 1:
        rc = restrict(r / fine_scale[0], grid_dim)
        return coarse_free * (coarse_scale[0] * rc)
    rc = restrict(_matvec(fine_scale[0], r), grid_dim)
    return coarse_free * _matvec(coarse_scale[1], rc)


def _jit_prolong_hat64(fine_scale, coarse_scale, fine_free, e, grid_dim):
    """Scaled prolongation, level l+1 → l (see :func:`_jit_restrict_hat64`)."""
    if len(fine_scale) == 1:
        ef = prolong(coarse_scale[0] * e, grid_dim)
        return fine_free * (ef / fine_scale[0])
    ef = prolong(_matvec_t(coarse_scale[1], e), grid_dim)   # Cinv^T e
    return fine_free * _matvec_t(fine_scale[0], ef)         # C^T


class DFLadder(NamedTuple):
    """Per-level double-f32 stencil pairs + f32 transfer scales (device)."""

    Whi: Tuple[Tuple[torch.Tensor, ...], ...]   # per level
    Wlo: Tuple[Tuple[torch.Tensor, ...], ...]
    bhi0: torch.Tensor
    blo0: torch.Tensor
    scale32: Tuple[tuple, ...]                  # per level, f32
    free32: Tuple[torch.Tensor, ...]


def build_df_ladder(h: MGHierarchy, sysm, b_hat: np.ndarray) -> DFLadder:
    from pde_solver_tpu_torch.ops import df32

    device = h.levels[0].free.device
    Whis, Wlos, scales, frees = [], [], [], []
    for lv in h.levels:
        Whi, Wlo = df32.pack_df_weights(lv.host_weights, device)
        Whis.append(Whi)
        Wlos.append(Wlo)
        scales.append(tuple(torch.as_tensor(S, dtype=torch.float32,
                                            device=device)
                            for S in lv.host_scale))
        frees.append(lv.free)
    return ladder_with_b(DFLadder(Whi=tuple(Whis), Wlo=tuple(Wlos),
                                  bhi0=None, blo0=None,
                                  scale32=tuple(scales), free32=tuple(frees)),
                         b_hat)


def ladder_with_b(ladder: DFLadder, b_hat: np.ndarray) -> DFLadder:
    """Re-target a ladder at a new RHS — the weight parts are operator-only,
    so only the two b pair-arrays are uploaded."""
    from pde_solver_tpu_torch.ops import df32

    device = ladder.free32[0].device
    bhi_np, blo_np = df32.df_from_f64(np.asarray(b_hat, dtype=np.float64))
    return ladder._replace(bhi0=torch.from_numpy(bhi_np).to(device),
                           blo0=torch.from_numpy(blo_np).to(device))


def _jit_round_df(h: MGHierarchy, ladder: DFLadder, Ainv32: torch.Tensor,
                  x_hi, x_lo, inner_iters):
    """One complete F-cycle round: df32 defect → descend → dense f32
    coarsest solve → df-refreshed ascends → pair update.  Returns
    (x_hi, x_lo, ‖r‖², iters).

    The JAX package fences ``mg_pcg`` with ``optimization_barrier``s against
    an XLA-on-TPU miscompile; eager torch compiles nothing, so they have no
    counterpart (the caller keeps the finite-relres stop)."""
    from pde_solver_tpu_torch.ops.df32 import df_scale_add, df_stencil_residual

    grid_dim, vdim = h.grid_dim, h.vdim
    levels = h.levels
    L = len(levels) - 1
    Whi, Wlo, scale32, free32 = (ladder.Whi, ladder.Wlo, ladder.scale32,
                                 ladder.free32)

    r32, rnorm2 = df_stencil_residual(levels[0].offsets, Whi[0], Wlo[0],
                                      ladder.bhi0, ladder.blo0, x_hi, x_lo,
                                      grid_dim, vdim)
    rs = [r32]
    for m in range(L):
        rs.append(_jit_restrict_hat64(scale32[m], scale32[m + 1],
                                      free32[m + 1], rs[m], grid_dim))
    e = (Ainv32 @ rs[L].reshape(-1)).reshape(rs[L].shape)
    iters = 0
    for m in range(L - 1, -1, -1):
        e = _jit_prolong_hat64(scale32[m], scale32[m + 1], free32[m], e,
                               grid_dim)
        sub = h._replace(levels=tuple(levels[m:]))
        zero = torch.zeros_like(rs[m])
        for _ in range(1 if m == 0 else 2):
            rho, _ = df_stencil_residual(levels[m].offsets, Whi[m], Wlo[m],
                                         rs[m], zero, e, zero, grid_dim, vdim)
            scale = torch.clamp(torch.sqrt(_dot(rho, rho)), min=1e-30)
            d32, k, _ = mg_pcg(sub, rho / scale, torch.zeros_like(rho), 1e-5,
                               inner_iters)
            e = e + scale * d32
            iters += k
    one = torch.ones((), dtype=torch.float32, device=e.device)
    x_hi, x_lo = df_scale_add(x_hi, x_lo, one, e)
    return x_hi, x_lo, rnorm2, iters


def solve_fcycle_df2(h: MGHierarchy, ladder: DFLadder, tol: float,
                     inner_iters: int = 10, max_rounds: int = 12):
    """Double-float32 F-cycle rounds until relres ≤ tol, a non-finite
    residual, two consecutive sub-2× rounds (the df32 floor) or
    ``max_rounds``.  Returns (x_hi, x_lo, iters, relres); convert with
    ``df32.df_to_f64``."""
    from pde_solver_tpu_torch.ops.df32 import jit_df_residual

    d, vdim = h.grid_dim, h.vdim
    device = ladder.bhi0.device
    Ainv32 = torch.as_tensor(h.levels[-1].host_Ainv, dtype=torch.float32,
                             device=device)
    bnorm = float(torch.sqrt(_dot(ladder.bhi0, ladder.bhi0)))
    if bnorm == 0.0:
        z = torch.zeros_like(ladder.bhi0)
        return z, z, 0, 0.0
    x_hi = torch.zeros_like(ladder.bhi0)
    x_lo = torch.zeros_like(ladder.bhi0)
    total = 0
    relres = 1.0
    prev = np.inf
    stalled = 0
    offsets0 = h.levels[0].offsets

    def residual_norm():
        _, rnorm2 = jit_df_residual(offsets0, ladder.Whi[0], ladder.Wlo[0],
                                    ladder.bhi0, ladder.blo0, x_hi, x_lo,
                                    d, vdim)
        return float(np.sqrt(float(rnorm2))) / bnorm

    for rnd in range(max_rounds):
        if rnd > 0:
            # convergence pre-check (one df residual) before spending a round
            relres = residual_norm()
            if relres <= tol or not np.isfinite(relres):
                break
            if relres > 0.5 * prev:
                stalled += 1
                if stalled >= 2:
                    break
            else:
                stalled = 0
            prev = relres
        x_hi, x_lo, _, k = _jit_round_df(h, ladder, Ainv32, x_hi, x_lo,
                                         inner_iters)
        total += int(k)
        get_logger().info("df2 round %d: relres before %.3e, %d inner "
                          "iterations", rnd, relres, k)
    else:
        rnd = max_rounds
    if rnd == max_rounds or relres > tol:
        # final residual reflects the last executed round
        relres = residual_norm()
    return x_hi, x_lo, total, relres
