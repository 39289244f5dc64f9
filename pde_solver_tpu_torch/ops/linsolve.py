"""Linear-solve facade: stencil system + BC → solution, per precision policy.

Counterpart of ``pde_solver_tpu.ops.linsolve`` for the static elasticity
slice.  One entry point (:func:`solve_stencil_system`) for the models and
the projection.

System preparation (host, numpy float64, once per solve) is copied from the
JAX package unchanged, so both packages solve bit-identical scaled systems:

* Dirichlet masking is baked into the weights (constrained rows/columns
  zeroed, 1 on the diagonal), keeping the device operator a pure SpMV;
* symmetric Jacobi scaling is baked in too: scalar D^{-1/2} A D^{-1/2}, or
  block-Cholesky C^{-1} A C^{-T} for elasticity — identity (block-)diagonal;
* the RHS lift b̃ = free ⊙ (b − A g) + g happens on host in float64.

Ported solve branches: host sparse LU for tiny systems, and the "mixed"
scheme — with a multigrid level builder the double-float32 F-cycle
(``ops.multigrid.solve_fcycle_df2``), without one float32 CG inner solves
plus a float64 host refinement loop.  The f64 and f32 branches and sharding
raise ``NotImplementedError`` (ROADMAP queue 1).  The multigrid hierarchy
and the F-cycle's weight ladder of the last ``_MG_CACHE_MAX`` operators
stay in memory (``_MG_CACHE``), so repeated solves on one operator — a
modal analysis makes dozens — build them once.
"""

from __future__ import annotations

import hashlib
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pde_solver_tpu_torch.config import SolverConfig, get_config
from pde_solver_tpu_torch.mesh import StructuredMesh
from pde_solver_tpu_torch.ops import cs_kernels, stencil_kernels
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.ops.cg import SolveStats
from pde_solver_tpu_torch.ops.cs_kernels import (CSFlatStencilOperator,
                                                 cs_enabled, cs_wins)
from pde_solver_tpu_torch.ops.stencil_kernels import (FlatStencilOperator,
                                                      kernel_wins)

Offset = Tuple[int, ...]


# ----------------------------------------------------------------------
# Host-side system preparation (numpy, float64) — copied from the JAX
# package; tests hold the two bit-equal
# ----------------------------------------------------------------------

def _np_shift(arr: np.ndarray, off: Offset, grid_dim: int) -> np.ndarray:
    """arr evaluated at n+off with zero padding (host helper)."""
    pad = [(1, 1)] * grid_dim + [(0, 0)] * (arr.ndim - grid_dim)
    ap = np.pad(arr, pad)
    sl = tuple(slice(1 + o, 1 + o + s) for o, s in zip(off, arr.shape[:grid_dim]))
    return ap[sl + (Ellipsis,)]


def np_stencil_apply(stencil: Dict[Offset, np.ndarray], x: np.ndarray,
                     grid_dim: int, vdim: int = 1) -> np.ndarray:
    y = np.zeros_like(x)
    for off, W in stencil.items():
        xs = _np_shift(x, off, grid_dim)
        if vdim == 1:
            y += W * xs
        else:
            y += np.einsum("...ij,...j->...i", W, xs)
    return y


class ScaledSystem(NamedTuple):
    """Masked + diagonally-scaled stencil system (host arrays, float64)."""

    offsets: Tuple[Offset, ...]
    weights: list                  # scaled Ŵ_o, aligned with offsets
    b_hat: np.ndarray              # scaled, lifted RHS
    gvals: np.ndarray              # Dirichlet values (0 on free DOFs)
    free: np.ndarray               # 1.0 on free DOFs, 0.0 on constrained
    scale_kind: str                # "scalar" | "block"
    s: Optional[np.ndarray]        # scalar: 1/sqrt(diag)
    Ct: Optional[np.ndarray]       # block: C^T  (x̂ = C^T x)
    CinvT: Optional[np.ndarray]    # block: C^{-T} (x = C^{-T} x̂)
    ckey: Optional[tuple] = None   # content key (systems ≥ _PREP_CACHE_MIN_DOF)

    def from_hat_x(self, x_hat: np.ndarray) -> np.ndarray:
        if self.scale_kind == "scalar":
            return self.s * x_hat
        return np.einsum("...ij,...j->...i", self.CinvT, x_hat)

    def to_hat_x(self, x: np.ndarray) -> np.ndarray:
        if self.scale_kind == "scalar":
            return x / self.s
        return np.einsum("...ij,...j->...i", self.Ct, x)


# In-memory operator-part cache for prepare_system: the masked+scaled
# weights and scale factors depend on (stencil, free-mask pattern) only, not
# on the RHS or the BC values, and cost tens of seconds of 1-core numpy at
# 2M-DOF elasticity.  Content-keyed; only systems above _PREP_CACHE_MIN_DOF.
_PREP_CACHE: Dict = {}
_PREP_CACHE_MAX = 2
_PREP_CACHE_MIN_DOF = 100_000


def _prep_cache_key(stencil: Dict, free: np.ndarray, node_shape, vdim: int):
    h = hashlib.blake2b(digest_size=16)
    for off in sorted(stencil.keys()):
        h.update(np.ascontiguousarray(np.asarray(stencil[off], np.float64)))
    h.update(np.ascontiguousarray(free))
    # contiguous C/Cinv are cached (not transposed views): einsum rounding
    # depends on memory layout, so every path hands the SAME layout to the
    # b̂ computation for bitwise-reproducible results
    return (tuple(node_shape), vdim, tuple(sorted(stencil.keys())),
            h.hexdigest(), "v2")


def _prep_core_put(key, core):
    """Cache (scaled, s, C, Cinv), marked read-only: the cache hands the same
    objects to every ScaledSystem that hits it."""
    scaled, s, C, Cinv = core
    for a in list(scaled) + [s, C, Cinv]:
        if a is not None:
            a.setflags(write=False)
    _PREP_CACHE[key] = core
    while len(_PREP_CACHE) > _PREP_CACHE_MAX:
        _PREP_CACHE.pop(next(iter(_PREP_CACHE)))


def prepare_system(stencil: Dict[Offset, np.ndarray], mesh: StructuredMesh,
                   bc: DirichletBC, rhs: np.ndarray, vdim: int = 1
                   ) -> ScaledSystem:
    """Bake masking + (block-)diagonal scaling into the weights."""
    d = mesh.dim
    free = np.asarray(bc.free_mask, dtype=np.float64)
    gvals = np.asarray(bc.values, dtype=np.float64) * (1.0 - free)

    # RHS lift with the *unmasked* operator (skipped when all Dirichlet
    # values are zero — A·0 = 0)
    if np.any(gvals):
        Ag = np_stencil_apply(stencil, gvals, d, vdim)
        b_t = free * (np.asarray(rhs, dtype=np.float64) - Ag) + gvals
    else:
        b_t = free * np.asarray(rhs, dtype=np.float64)

    zero = tuple(0 for _ in range(d))
    offsets = tuple(sorted(stencil.keys()))

    n = int(np.prod(mesh.node_shape)) * vdim
    key = None
    if n >= _PREP_CACHE_MIN_DOF:
        key = _prep_cache_key(stencil, free, mesh.node_shape, vdim)
        core = _PREP_CACHE.pop(key, None)
        if core is not None:
            _PREP_CACHE[key] = core  # LRU refresh
            scaled, s, C, Cinv = core
            if vdim == 1:
                return ScaledSystem(offsets, scaled, s * b_t, gvals, free,
                                    "scalar", s, None, None, ckey=key)
            b_hat = np.einsum("...ab,...b->...a", Cinv, b_t)
            return ScaledSystem(offsets, scaled, b_hat, gvals, free,
                                "block", None, np.swapaxes(C, -1, -2),
                                np.swapaxes(Cinv, -1, -2), ckey=key)

    if vdim == 1:
        diag = stencil[zero] * free + (1.0 - free)
        diag = np.where(diag <= 0, 1.0, diag)
        s = 1.0 / np.sqrt(diag)
        scaled = []
        for off in offsets:
            W = np.array(stencil[off], dtype=np.float64)
            free_o = _np_shift(free, off, d)
            s_o = _np_shift(s, off, d)
            W = W * (free * free_o) * (s * s_o)
            if off == zero:
                W = W + (1.0 - free)
            scaled.append(W)
        if key is not None:
            _prep_core_put(key, (scaled, s, None, None))
        return ScaledSystem(offsets, scaled, s * b_t, gvals, free, "scalar", s,
                            None, None, ckey=key)

    # vdim > 1: block-Cholesky scaling (block-Jacobi preconditioning baked in)
    eye = np.eye(vdim)
    masked = {}
    for off in offsets:
        W = np.array(stencil[off], dtype=np.float64)
        free_o = _np_shift(free, off, d)
        W = W * (free[..., :, None] * free_o[..., None, :])
        if off == zero:
            W = W + (1.0 - free)[..., :, None] * eye
        masked[off] = W
    D = masked[zero]                       # [..., v, v] SPD blocks
    C = np.linalg.cholesky(D)
    Cinv = np.linalg.inv(C)
    scaled = []
    for off in offsets:
        Cinv_o = _np_shift(Cinv, off, d)
        # Ŵ_o[n] = C^{-1}[n] W_o[n] C^{-T}[n+o]
        W = np.einsum("...ab,...bc,...dc->...ad", Cinv, masked[off], Cinv_o)
        scaled.append(W)
    b_hat = np.einsum("...ab,...b->...a", Cinv, b_t)
    Ct = np.swapaxes(C, -1, -2)
    CinvT = np.swapaxes(Cinv, -1, -2)
    if key is not None:
        _prep_core_put(key, (scaled, None, C, Cinv))
    return ScaledSystem(offsets, scaled, b_hat, gvals, free, "block", None,
                        Ct, CinvT, ckey=key)


# ----------------------------------------------------------------------
# Device operators (eager torch)
# ----------------------------------------------------------------------

def _pad1(x: torch.Tensor, grid_dim: int) -> torch.Tensor:
    """Zero-pad the grid axes of x by one node on each side."""
    shape = x.shape[:grid_dim]
    xp = x.new_zeros(tuple(s + 2 for s in shape) + tuple(x.shape[grid_dim:]))
    xp[tuple(slice(1, 1 + s) for s in shape)] = x
    return xp


def _is_flat_op(w) -> bool:
    """A kernel-backed operator (dense or constant-interior) that works in
    the flat ``[v, N]`` layout."""
    return isinstance(w, (FlatStencilOperator, CSFlatStencilOperator))


def _stencil_apply(offsets: Tuple[Offset, ...], weights, x: torch.Tensor,
                   grid_dim: int, vdim: int) -> torch.Tensor:
    """Grid-layout apply: the kernel-backed operator when given one, else
    plain shifted slices over per-offset weight tensors.  Per-node v×v
    blocks multiply as broadcast + sum (no batched GEMM, no TF32 path)."""
    if _is_flat_op(weights):
        return weights.apply(x)
    xp = _pad1(x, grid_dim)
    shape = x.shape[:grid_dim]
    y = None
    for off, W in zip(offsets, weights):
        sl = tuple(slice(1 + o, 1 + o + s) for o, s in zip(off, shape))
        xs = xp[sl + (Ellipsis,)]
        term = W * xs if vdim == 1 else (W * xs[..., None, :]).sum(-1)
        y = term if y is None else y + term
    return y


def _dot(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), c.reshape(-1))


def _cg_unit_diag(offsets, weights, b, x0, tol, maxiter, grid_dim, vdim):
    """CG on the scaled (identity-diagonal) system — no preconditioner.

    With a flat operator (dense or constant-interior) the whole iteration
    runs in the kernel's flat layout: one conversion per solve instead of
    two per iteration.  The convergence test reads ‖r‖² on the host each
    iteration (one device sync per iteration)."""
    flat = _is_flat_op(weights)
    if flat:
        b = weights.to_flat(b)
        x0 = weights.to_flat(x0)
        A = weights.apply_flat
    else:
        def A(x):
            return _stencil_apply(offsets, weights, x, grid_dim, vdim)

    x = x0
    r = b - A(x)
    p = r
    rz = _dot(r, r)
    bnorm2 = float(_dot(b, b))
    bnorm2 = 1.0 if bnorm2 == 0 else bnorm2
    tol2 = (tol * tol) * bnorm2
    k = 0
    while float(rz) > tol2 and k < maxiter:
        Ap = A(p)
        pAp = _dot(p, Ap)
        alpha = rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        rz_new = _dot(r, r)
        beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
        p = r + beta * p
        rz = rz_new
        k += 1
    relres = float(torch.sqrt(rz / bnorm2))
    if flat:
        x = weights.from_flat(x)
    return x, k, relres


def _static_flat_op(sysm: ScaledSystem, mesh: StructuredMesh, vdim: int,
                    device):
    """Kernel-backed flat operator for the f32 CG paths (static, and the
    transient step without multigrid), or None when plain shifted slices
    are the right call (below ``KERNEL_MIN_DOF``).  With ``PDE_TPU_CS`` on
    it is the constant-interior operator where the stencil allows one and
    the system has at least ``CS_MIN_DOF`` unknowns.
    _cg_unit_diag then iterates in the flat layout."""
    n = int(np.prod(mesh.node_shape)) * vdim
    if not kernel_wins(n):
        return None
    if cs_enabled() and cs_wins(n):
        op = CSFlatStencilOperator.try_build(
            sysm.offsets, sysm.weights, mesh.node_shape, vdim=vdim,
            device=device, cache_key=sysm.ckey)
        if op is not None:
            return op
    return FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                               vdim=vdim, device=device)


def _host_direct_solve(sysm: ScaledSystem, node_shape, vdim: int):
    """Sparse-LU the scaled hat system on host (float64, exact).

    C-order DOF numbering matching ``grid.reshape(-1)``; flat-index column
    arithmetic is valid because assembled weights are exactly zero wherever
    a flat shift would wrap across a grid row."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    N = int(np.prod(node_shape))
    strides = []
    acc = 1
    for s in reversed(node_shape):
        strides.append(acc)
        acc *= s
    strides = list(reversed(strides))
    base = np.arange(N)
    rows_l, cols_l, vals_l = [], [], []
    for off, W in zip(sysm.offsets, sysm.weights):
        delta = int(sum(o * st for o, st in zip(off, strides)))
        cols = base + delta
        valid = (cols >= 0) & (cols < N)
        Wf = (np.asarray(W, np.float64).reshape(N, vdim, vdim) if vdim > 1
              else np.asarray(W, np.float64).reshape(N, 1, 1))
        r, c = base[valid], cols[valid]
        for a in range(vdim):
            for b_ in range(vdim):
                rows_l.append(r * vdim + a)
                cols_l.append(c * vdim + b_)
                vals_l.append(Wf[valid, a, b_])
    n = N * vdim
    A = sp.csr_matrix((np.concatenate(vals_l),
                       (np.concatenate(rows_l), np.concatenate(cols_l))),
                      shape=(n, n))
    b = np.asarray(sysm.b_hat, np.float64).reshape(-1)
    x = spla.spsolve(A, b)
    bn = np.linalg.norm(b)
    relres = np.linalg.norm(b - A @ x) / (bn if bn > 0 else 1.0)
    return x.reshape(sysm.b_hat.shape), float(relres)


# ----------------------------------------------------------------------
# MG operator cache: hierarchy + df-ladder weight parts keyed by content
# (node shape, offsets, scaled-weight and free-mask bytes), routing and
# device.  Repeated solves of the same discrete system — the solves of a
# modal analysis, follow-up calls that change only BC values or the load —
# skip the hierarchy build and the weight uploads.  BC *values* are not
# part of the operator (masking bakes in the free pattern only; values
# enter through b̂), so value-only follow-ups hit the cache.
# ----------------------------------------------------------------------

_MG_CACHE: Dict = {}
_MG_CACHE_MAX = 2


def _mg_cache_key(mesh: StructuredMesh, vdim: int, prec: str,
                  sysm: ScaledSystem, device: torch.device):
    h = hashlib.blake2b(digest_size=16)
    for W in sysm.weights:
        h.update(np.ascontiguousarray(W))
    h.update(np.ascontiguousarray(sysm.free))
    # the routing bakes into the built hierarchy's operators, and its
    # tensors live on one device: an entry of another routing or device
    # would silently keep the old kernels or hand over foreign tensors.
    # The routing is PDE_TPU_CS and the two size gates (the reference's
    # bf16-smoother switch has no counterpart here: dense levels always
    # smooth with bf16 weights).
    routing = (cs_kernels.cs_mode(), cs_kernels.CS_MIN_DOF,
               stencil_kernels.KERNEL_MIN_DOF)
    return (mesh.node_shape, vdim, prec, sysm.offsets, routing, str(device),
            h.hexdigest())


def _mg_cache_get(key):
    entry = _MG_CACHE.pop(key, None)
    if entry is not None:
        _MG_CACHE[key] = entry  # LRU refresh
    return entry


def _mg_cache_put(key, hierarchy, ladder):
    """Cache (hierarchy, ladder or None); the host arrays of the levels are
    marked read-only, since every solve that hits the entry shares them."""
    for lv in hierarchy.levels:
        for a in (list(lv.host_weights or []) + [lv.host_Ainv]
                  + list(lv.host_scale or [])):
            if a is not None:
                a.setflags(write=False)
    _MG_CACHE[key] = (hierarchy, ladder)
    while len(_MG_CACHE) > _MG_CACHE_MAX:
        _MG_CACHE.pop(next(iter(_MG_CACHE)))


# ----------------------------------------------------------------------
# Public facade
# ----------------------------------------------------------------------

def solve_stencil_system(
    stencil_np: Dict,
    mesh: StructuredMesh,
    bc: DirichletBC,
    rhs_np: np.ndarray,
    vdim: int = 1,
    config: Optional[SolverConfig] = None,
    x0: Optional[np.ndarray] = None,
    mg_level_builder=None,
) -> Tuple[np.ndarray, SolveStats]:
    """Solve A x = b with Dirichlet symmetric elimination.

    ``stencil_np``: numpy stencil from ``ops.assembly``; ``rhs_np``: the raw
    (unconstrained) load vector.  ``mg_level_builder(mesh_c) → (stencil, bc)``
    enables geometric-multigrid preconditioning (ops.multigrid) for large
    systems.  Returns (x float64 numpy grid, stats).
    """
    cfg = config or get_config()
    prec = cfg.resolve_precision()
    d = mesh.dim
    n = int(np.prod(mesh.node_shape)) * vdim
    maxiter = cfg.resolved_maxiter(n)
    cfg.resolved_shard_devices()  # raises when sharding is requested

    sysm = prepare_system(stencil_np, mesh, bc, rhs_np, vdim)
    offsets = sysm.offsets
    x0_hat = (np.zeros_like(sysm.b_hat) if x0 is None
              else sysm.to_hat_x(np.asarray(x0, dtype=np.float64)))

    # Tiny systems: host sparse LU, no device round-trips.
    if 0 < n <= cfg.host_direct_threshold:
        xh, relres = _host_direct_solve(sysm, mesh.node_shape, vdim)
        x = sysm.from_hat_x(xh)
        return x, SolveStats(iterations=np.int32(1),
                             relative_residual=np.float64(relres),
                             converged=np.bool_(relres <= 1e-9),
                             target=1e-9)

    if prec != "mixed":
        raise NotImplementedError(
            f"precision {prec!r} is not ported yet; only 'mixed' is "
            "(ROADMAP queue 1, item 2)")

    device = torch.device(cfg.device)
    if (mg_level_builder is not None and cfg.use_multigrid
            and n >= cfg.mg_threshold):
        import time as _time

        from pde_solver_tpu_torch.ops import df32
        from pde_solver_tpu_torch.ops import multigrid as mg
        from pde_solver_tpu_torch.utils.observability import get_logger

        t_h = _time.perf_counter()
        hier_key = _mg_cache_key(mesh, vdim, prec, sysm, device)
        cached = _mg_cache_get(hier_key)
        if cached is not None:
            hierarchy, ladder_core = cached
            get_logger().info("hierarchy cache hit (%.3fs key, %d DOF)",
                              _time.perf_counter() - t_h, n)
        else:
            ladder_core = None
            hierarchy = mg.build_hierarchy(mesh, sysm, mg_level_builder,
                                           vdim=vdim, device=device)
        if hierarchy is not None:
            # Double-float32 F-cycle: Galerkin ladder with an exact f64
            # coarsest anchor and error-free-transformation defects at the
            # finest level — beats the κ_eff·ε32 floor that stalls a plain
            # f32 refinement loop on ill-conditioned problems.
            t_l = _time.perf_counter()
            if ladder_core is not None:
                ladder = mg.ladder_with_b(ladder_core, sysm.b_hat)
            else:
                ladder = mg.build_df_ladder(hierarchy, sysm, sysm.b_hat)
                _mg_cache_put(hier_key, hierarchy, ladder)
            t_s = _time.perf_counter()
            x_hi, x_lo, iters, relres = mg.solve_fcycle_df2(
                hierarchy, ladder, max(cfg.tol, 1e-9),
                max_rounds=max(cfg.refine_rounds, 8))
            get_logger().info(
                "hierarchy build: %.3fs, df ladder build: %.3fs, "
                "df2 rounds: %.3fs (%d DOF)", t_l - t_h, t_s - t_l,
                _time.perf_counter() - t_s, n)
            x_hat = df32.df_to_f64(x_hi.cpu().numpy(), x_lo.cpu().numpy())
            x = sysm.from_hat_x(x_hat)
            target = max(cfg.tol, cfg.accuracy_target)
            stats = SolveStats(
                iterations=np.int32(iters),
                relative_residual=np.float64(relres),
                converged=bool(relres <= target),
                target=target,
            )
            return x, stats

    # mixed, no hierarchy: f32 CG inner solves on the device + float64
    # refinement residuals in host numpy against the host scaled weights
    w32 = _static_flat_op(sysm, mesh, vdim, device) or tuple(
        torch.as_tensor(W, dtype=torch.float32, device=device)
        for W in sysm.weights)

    def inner_solve(r32):
        b = torch.as_tensor(r32, dtype=torch.float32, device=device)
        return _cg_unit_diag(offsets, w32, b, torch.zeros_like(b),
                             cfg.inner_tol, maxiter, d, vdim)

    scaled_np = {o: W for o, W in zip(offsets, sysm.weights)}
    x_hat = np.asarray(x0_hat, dtype=np.float64)
    bnorm = float(np.linalg.norm(sysm.b_hat.reshape(-1)))
    tol_used = cfg.tol
    iters = 0
    relres = 1.0
    if bnorm == 0.0:
        x_hat = np.zeros_like(sysm.b_hat)
        relres = 0.0
    else:
        for _ in range(cfg.refine_rounds):
            r = sysm.b_hat - np_stencil_apply(scaled_np, x_hat, d, vdim)
            relres = float(np.linalg.norm(r.reshape(-1))) / bnorm
            if relres <= cfg.tol or not np.isfinite(relres):
                break
            scale = float(np.max(np.abs(r)))
            d32, k, _ = inner_solve(np.asarray(r / scale, dtype=np.float32))
            x_hat = x_hat + scale * d32.cpu().numpy().astype(np.float64)
            iters += int(k)
        else:
            r = sysm.b_hat - np_stencil_apply(scaled_np, x_hat, d, vdim)
            relres = float(np.linalg.norm(r.reshape(-1))) / bnorm

    x = sysm.from_hat_x(x_hat)
    # "converged" = the residual met the larger of the requested tolerance
    # and the framework accuracy contract
    target = max(tol_used, cfg.accuracy_target)
    stats = SolveStats(
        iterations=np.int32(iters),
        relative_residual=np.float64(relres),
        converged=bool(np.float64(relres) <= target),
        target=target,
    )
    return x, stats
