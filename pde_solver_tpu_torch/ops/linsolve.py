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

Solve branches, by ``SolverConfig.resolve_precision()``, above host sparse
LU for tiny systems:

* "f64" — MG-PCG on a float64 hierarchy (``ops.multigrid.solve_mg``) when
  a level builder is given and the system is large enough, else CG on
  float64 weight tensors, both at ``cfg.tol``.  Plain shifted-slice applies
  on float64 tensors: the JAX package runs no kernel at float64 either.
  The reported relative residual is the true one, recomputed after the
  solve (the JAX package reports CG's recurrence residual).
* "f32" — CG on the kernel-backed flat operator (``_static_flat_op``), or
  on float32 tensors below ``KERNEL_MIN_DOF``, at max(inner_tol,
  ``F32_TOL_FLOOR``).
* "mixed" — with a multigrid level builder the double-float32 F-cycle
  (``ops.multigrid.solve_fcycle_df2``), without one float32 CG inner solves
  plus a float64 host refinement loop.

``SolverConfig.shard_devices`` / ``shard_grid`` decompose the solve over a
mesh of shard devices (``parallel``), where the JAX package does: with a
hierarchy, sharded MG-PCG (``parallel.shard_mg``, the hierarchy built with
plain weights); without one, sharded CG (``parallel.shard.
ShardedScaledCG``, 1-D or a×b); in "mixed", as the inner solves of the
host float64 refinement loop.  A sharding request skips host sparse LU.
The multigrid hierarchy (and, for "mixed", the F-cycle's weight ladder) of the
last two operators stay in memory (``_MG_CACHE``, a ``utils.kept.Kept``), so
repeated solves on one operator — a modal analysis makes dozens — build
them once.  Across processes, the scaled system's operator part (kind
"prep") and the "mixed" branch's float32 hierarchy (kind "mgh",
``multigrid.build_hierarchy_cached``) persist on disk
(``utils.diskcache``), as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pde_solver_tpu_torch.config import SolverConfig, get_config
from pde_solver_tpu_torch.mesh import StructuredMesh
from pde_solver_tpu_torch.ops import (assembly, cs_kernels, device_loop,
                                      stencil_kernels)
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.ops.cg import SolveStats
from pde_solver_tpu_torch.ops.cs_kernels import (CSFlatStencilOperator,
                                                 cs_enabled, cs_wins)
from pde_solver_tpu_torch.ops.stencil_kernels import (FlatStencilOperator,
                                                      kernel_wins)
from pde_solver_tpu_torch.utils import kept
from pde_solver_tpu_torch.utils import observability as obs
from pde_solver_tpu_torch.utils.observability import get_logger

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


# Operator-part cache for prepare_system: the masked+scaled weights and
# scale factors depend on (stencil, free-mask pattern) only, not on the RHS
# or the BC values, and cost tens of seconds of 1-core numpy at 2M-DOF
# elasticity.  Content-keyed; only systems above _PREP_CACHE_MIN_DOF (below
# it prepare is fast, and per-level coarse systems would churn the LRU).
# Memory first, then disk (``utils.diskcache``, kind "prep"), so a fresh
# process — each new MCP server — skips the host prep.  The key and the
# array names are the JAX package's: an entry either package writes, the
# other reads.
_PREP_CACHE = kept.Kept(2)
_PREP_CACHE_MIN_DOF = 100_000

# The prep key's hash state after a class-grid stencil's full arrays
# (``assembly.ClassStencil``), keyed by what they were expanded from: the
# cell shape, extra shape, offsets and the class grids' digest.  A stencil
# assembled again, as every request of a chat of follow-ups does, is keyed
# from its class grids and the free mask alone; the key's bytes are the
# full hash's.
_STENCIL_STATES = kept.Kept(8)


def _stencil_state(stencil: Dict):
    """A fresh blake2b-128 state after the stencil's arrays in sorted
    offset order: from :data:`_STENCIL_STATES` when the stencil is a
    class-grid expansion still intact (``stencil_digest_reuses``), else
    hashed from its arrays."""
    source = (stencil.source() if isinstance(stencil, assembly.ClassStencil)
              else None)
    skey = h = None
    if source is not None:
        n_cells, extra_shape, offsets, grids = source
        skey = (n_cells, extra_shape, offsets, kept.digest(grids))
        h = _STENCIL_STATES.get(skey)
        if h is not None:
            obs.count("stencil_digest_reuses")
    if h is None:
        h = kept.feed(None, [np.asarray(stencil[off], np.float64)
                             for off in sorted(stencil.keys())])
    if skey is not None:
        _STENCIL_STATES.put(skey, h)
        h = h.copy()
    return h


def _prep_cache_key(stencil: Dict, free: np.ndarray, node_shape, vdim: int):
    with obs.span("setup.hash"):
        digest = kept.feed(_stencil_state(stencil), [free]).hexdigest()
    # "v2": contiguous C/Cinv are cached (not transposed views) — einsum
    # rounding depends on memory layout, so every path hands the SAME
    # layout to the b̂ computation for bitwise-reproducible results
    return (tuple(node_shape), vdim, tuple(sorted(stencil.keys())),
            digest, "v2")


def _entry_bytes(kind: str, key) -> int:
    """Bytes of a disk-cache entry on disk (0 when there is none)."""
    from pde_solver_tpu_torch.utils import diskcache

    try:
        return os.path.getsize(diskcache._path(kind, key))
    except OSError:
        return 0


def _freeze(core):
    """Mark the arrays of (scaled, s, C, Cinv) read-only: the cache hands
    the same objects to every ScaledSystem that hits it."""
    scaled, s, C, Cinv = core
    for a in list(scaled) + [s, C, Cinv]:
        if a is not None:
            a.setflags(write=False)
    return core


def _prep_core_get(key, n_off: int, vdim: int):
    """Memory first, then disk.  Returns (scaled, s, C, Cinv) — C/Cinv
    contiguous, exactly as the fresh compute produces them — or None."""
    core = _PREP_CACHE.get(key)
    if core is not None:
        obs.count("prep_memory_hits")
        return core
    from pde_solver_tpu_torch.utils import diskcache

    with obs.span("setup.prep.load") as sp:
        ent = diskcache.load("prep", key)
        if ent is None:
            return None
        try:
            scaled = [ent[f"w{i}"] for i in range(n_off)]
            if vdim == 1:
                core = (scaled, ent["s"], None, None)
            else:
                core = (scaled, None, ent["C"], ent["Cinv"])
        except KeyError:
            return None
        _PREP_CACHE.put(key, _freeze(core))
    obs.count("prep_disk_hits")
    get_logger().info("prep disk-cache hit (%.3fs load, %d bytes, %d DOF)",
                      sp.seconds, _entry_bytes("prep", key),
                      int(np.prod(key[0])) * vdim)
    return core


def _prep_core_put(key, core):
    """Cache (scaled, s, C, Cinv) in memory, frozen, and on disk."""
    _PREP_CACHE.put(key, _freeze(core))
    from pde_solver_tpu_torch.utils import diskcache

    if not diskcache.enabled():
        return
    with obs.span("setup.prep.store") as sp:
        scaled, s, C, Cinv = core
        arrays = {f"w{i}": np.asarray(W) for i, W in enumerate(scaled)}
        for name, a in (("s", s), ("C", C), ("Cinv", Cinv)):
            if a is not None:
                arrays[name] = np.asarray(a)
        diskcache.store("prep", key, arrays)
    get_logger().info("prep disk-cache store (%.3fs, %d bytes, %d DOF)",
                      sp.seconds, _entry_bytes("prep", key),
                      int(np.prod(key[0])) * key[1])


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
        core = _prep_core_get(key, len(offsets), vdim)
        if core is not None:
            scaled, s, C, Cinv = core
            if vdim == 1:
                return ScaledSystem(offsets, scaled, s * b_t, gvals, free,
                                    "scalar", s, None, None, ckey=key)
            b_hat = np.einsum("...ab,...b->...a", Cinv, b_t)
            return ScaledSystem(offsets, scaled, b_hat, gvals, free,
                                "block", None, np.swapaxes(C, -1, -2),
                                np.swapaxes(Cinv, -1, -2), ckey=key)

    obs.count("prep_builds")
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


# Masked blocks of :func:`_cg_unit_diag`: a static float32 CG takes
# hundreds to thousands of iterations (the flagship at "f32": 4,995), so
# 32 a block keeps its reads few at an average 16 masked iterations; a
# warm-started step solve of a scan takes a handful (``STEP_BLOCK``).
CG_BLOCK = 32
STEP_BLOCK = device_loop.STEP_BLOCK
# The tightest relative residual a float32 solve is asked for: the static
# "f32" solve and every float32 θ-step of ``ops.timestepping``.
F32_TOL_FLOOR = 1e-7


def _where1(t: torch.Tensor) -> torch.Tensor:
    """t with its zeros replaced by ones: a guarded divisor."""
    return torch.where(t == 0, torch.ones_like(t), t)


def _loop_parts(offsets, weights, grid_dim: int, vdim: int):
    """(to_flat, from_flat, A) of a solve loop on ``weights``: a flat
    operator's ``[v, N]`` layout, else the grid layout unchanged."""
    if _is_flat_op(weights):
        return weights.to_flat, weights.from_flat, weights.apply_flat

    def A(x):
        return _stencil_apply(offsets, weights, x, grid_dim, vdim)

    def same(t):
        return t
    return same, same, A


def _cg_program(offsets, weights, grid_dim: int, vdim: int):
    """The masked CG of :func:`_cg_unit_diag` as (prologue, step, status,
    from_flat) for ``ops.device_loop``.  State: (x, r, p, ‖r‖², k,
    active, tol², ‖b‖², maxiter), in the flat layout of a flat operator;
    ``step`` keeps an iteration only while ``active``."""
    to_flat, from_flat, A = _loop_parts(offsets, weights, grid_dim, vdim)

    def prologue(b, x0, tol, maxiter):
        b, x = to_flat(b), to_flat(x0)
        r = b - A(x)
        rz = _dot(r, r)
        bnorm2 = _where1(_dot(b, b))
        tol2 = (tol * tol) * bnorm2.to(torch.float64)
        k = torch.zeros((), dtype=torch.int64, device=b.device)
        active = (rz.to(torch.float64) > tol2) & (k < maxiter)
        return (x, r, r, rz, k, active, tol2, bnorm2, maxiter)

    def step(state, g: int):
        x, r, p, rz, k, active, tol2, bnorm2, maxiter = state
        Ap = A(p)
        alpha = rz / _where1(_dot(p, Ap))
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        rz_n = _dot(r_n, r_n)
        p_n = r_n + (rz_n / _where1(rz)) * p
        x, r = torch.where(active, x_n, x), torch.where(active, r_n, r)
        p, rz = torch.where(active, p_n, p), torch.where(active, rz_n, rz)
        k = k + active.to(k.dtype)
        active = (rz.to(torch.float64) > tol2) & (k < maxiter)
        return (x, r, p, rz, k, active, tol2, bnorm2, maxiter)

    def status(state):
        rz, k, active, bnorm2 = state[3], state[4], state[5], state[7]
        return device_loop.status_of(active, k, torch.sqrt(rz / bnorm2))

    return prologue, step, status, from_flat


def _cg_unit_diag(offsets, weights, b, x0, tol, maxiter, grid_dim, vdim,
                  block: int = CG_BLOCK, graphs=None):
    """CG on the scaled (identity-diagonal) system — no preconditioner.

    With a flat operator (dense or constant-interior) the whole iteration
    runs in the kernel's flat layout: one conversion per solve instead of
    two per iteration.  The iterations run as masked blocks of ``block``
    (``ops.device_loop``), captured on the card, the host reading once a
    block; the convergence test compares ‖r‖² with tol²·‖b‖² in float64
    on the device.  The graphs live in ``graphs`` (a ``GraphStore`` whose
    owner outlives the weights), else in a flat operator's own store, else
    for this call only."""
    if graphs is None:
        graphs = (device_loop.store_of(weights) if _is_flat_op(weights)
                  else device_loop.GraphStore())
    return device_loop.solve(graphs, ("cg", block, tuple(b.shape), b.dtype),
                             _cg_program(offsets, weights, grid_dim, vdim),
                             b, x0, tol, maxiter, block)


# Flat-operator cache of the static (non-MG) f32 CG paths — the "f32"
# branch, and the "mixed" branch without a hierarchy, which the projection's
# mass solve takes: keyed on the system's content key, so follow-up solves
# of one operator skip the host pack and the weight upload.  Only systems
# with a content key (``ScaledSystem.ckey``) cache.
_FLAT_OP_CACHE = kept.Kept(2, device_loop.release)


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
    mode = cs_kernels.cs_mode()
    use_cs = cs_enabled(mode) and cs_wins(n)
    key = (sysm.ckey, tuple(mesh.node_shape), vdim, mode, use_cs,
           str(torch.device(device)))
    op = _FLAT_OP_CACHE.get(key) if sysm.ckey is not None else None
    if op is None and use_cs:
        op = CSFlatStencilOperator.try_build(
            sysm.offsets, sysm.weights, mesh.node_shape, vdim=vdim,
            device=device, cache_key=sysm.ckey)
    if op is None:
        op = FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                 vdim=vdim, device=device)
    if sysm.ckey is not None:
        _FLAT_OP_CACHE.put(key, op)
    return op


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
# (node shape, offsets, and the system's content key, which names its
# scaled weights and free mask, or below the key gate their bytes),
# routing and device.  Repeated solves of the same discrete system — the
# solves of a modal analysis, follow-up calls that change only BC values
# or the load — skip the hierarchy build and the weight uploads.  BC
# *values* are not part of the operator (masking bakes in the free
# pattern only; values enter through b̂), so value-only follow-ups hit the
# cache.  An evicted hierarchy's captured solve loops go with it.
# ----------------------------------------------------------------------

_MG_CACHE = kept.Kept(2, lambda entry: device_loop.release(entry[0]))


def _routing() -> tuple:
    """What routes a built operator's applies: ``PDE_TPU_CS`` and the three
    size gates.  It bakes into a built hierarchy's operators, so it joins
    every key of a cache of them."""
    from pde_solver_tpu_torch.ops.multigrid import BF16_MIN_DOF

    return (cs_kernels.cs_mode(), cs_kernels.CS_MIN_DOF,
            stencil_kernels.KERNEL_MIN_DOF, BF16_MIN_DOF)


def _mg_cache_key(mesh: StructuredMesh, vdim: int, prec: str,
                  sysm: ScaledSystem, device: torch.device, arrays=None):
    # the scaled weights and free mask are a pure function of the prep
    # key's content, so a system that has one is named by it, else by the
    # hash of ``arrays`` (by default those weights and mask; a scan's key
    # adds the scales)
    if arrays is None:
        arrays = list(sysm.weights) + [sysm.free]
    content = sysm.ckey if sysm.ckey is not None else kept.digest(arrays)
    # the routing bakes into the built hierarchy's operators, and its
    # tensors live on one device: an entry of another routing or device
    # would silently keep the old kernels or hand over foreign tensors
    return (mesh.node_shape, vdim, prec, sysm.offsets, _routing(),
            str(device), content)


def _mg_cache_put(key, hierarchy, ladder):
    """Cache (hierarchy, ladder or None); the host arrays of the levels are
    marked read-only, since every solve that hits the entry shares them."""
    for lv in hierarchy.levels:
        for a in (list(lv.host_weights or []) + [lv.host_Ainv]
                  + list(lv.host_scale or [])):
            if a is not None:
                a.setflags(write=False)
    _MG_CACHE.put(key, (hierarchy, ladder))


# ----------------------------------------------------------------------
# Public facade
# ----------------------------------------------------------------------

def _stats_result(sysm: ScaledSystem, xh: torch.Tensor, k, relres,
                  tol_used: float, cfg: SolverConfig):
    """(x float64 numpy grid, stats) of a device solve of the scaled
    system; "converged" = relres met max(tol_used, accuracy_target)."""
    with obs.span("solve.fetch"):
        x = sysm.from_hat_x(xh.cpu().numpy().astype(np.float64))
    target = max(tol_used, cfg.accuracy_target)
    return x, SolveStats(iterations=np.int32(k),
                         relative_residual=np.float64(relres),
                         converged=bool(np.float64(relres) <= target),
                         target=target)


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
    nshard = cfg.resolved_shard_devices()

    with obs.span("setup.prep") as sp:
        sysm = prepare_system(stencil_np, mesh, bc, rhs_np, vdim)
    get_logger().info("prepare_system: %.3fs (%d DOF)", sp.seconds, n)
    offsets = sysm.offsets
    x0_hat = (np.zeros_like(sysm.b_hat) if x0 is None
              else sysm.to_hat_x(np.asarray(x0, dtype=np.float64)))

    # Tiny systems: host sparse LU, no device round-trips (a sharding
    # request still wins, as in the JAX package)
    if 0 < n <= cfg.host_direct_threshold and nshard <= 1:
        xh, relres = _host_direct_solve(sysm, mesh.node_shape, vdim)
        x = sysm.from_hat_x(xh)
        return x, SolveStats(iterations=np.int32(1),
                             relative_residual=np.float64(relres),
                             converged=np.bool_(relres <= 1e-9),
                             target=1e-9)

    from pde_solver_tpu_torch.ops import multigrid as mg   # imports this

    device = torch.device(cfg.device)
    hierarchy = ladder_core = hier_key = None
    # the unsharded "f32" branch never reads a hierarchy (the reference
    # builds one there and leaves it unused): none is built for it
    if (mg_level_builder is not None and cfg.use_multigrid
            and n >= cfg.mg_threshold and (prec != "f32" or nshard > 1)):
        with obs.span("setup.hierarchy") as sp:
            hier_key = _mg_cache_key(mesh, vdim, prec, sysm, device) + (
                nshard > 1,)
            cached = _MG_CACHE.get(hier_key)
            if cached is not None:
                hierarchy, ladder_core = cached
                obs.count("hierarchy_hits")
                get_logger().info("hierarchy cache hit (%.3fs key, %d DOF)",
                                  sp.seconds, n)
            else:
                # the disk layer serves float32 hierarchies only; the
                # kernels' flat layout does not decompose along a grid
                # axis, so a sharded hierarchy keeps plain weights
                hierarchy = mg.build_hierarchy_cached(
                    mesh, sysm, mg_level_builder, vdim=vdim, device=device,
                    dtype=torch.float64 if prec == "f64" else torch.float32,
                    cache_key=sysm.ckey, use_kernel=nshard <= 1)
                if hierarchy is not None and (prec == "f64" or nshard > 1):
                    _mg_cache_put(hier_key, hierarchy, None)
                get_logger().info("hierarchy build: %.3fs (%d DOF)",
                                  sp.seconds, n)

    # Domain decomposition over a mesh of shard devices: with a hierarchy,
    # sharded MG-PCG; without one, sharded CG (1-D, or a×b when asked for
    # and the problem has a second grid axis)
    sharded = sharded_mg = None
    if nshard > 1 and hierarchy is not None:
        from pde_solver_tpu_torch.parallel.shard import device_mesh
        from pde_solver_tpu_torch.parallel.shard_mg import shard_hierarchy

        sharded_mg = shard_hierarchy(
            hierarchy, device_mesh(nshard, device=device), key=hier_key)
        get_logger().info("sharded MG-PCG: V-cycle + domain decomposition "
                          "over %d devices", nshard)
    elif nshard > 1:
        from pde_solver_tpu_torch.parallel.shard import (ShardedScaledCG,
                                                         device_mesh)

        grid2d = cfg.resolved_shard_grid() if d >= 2 else None
        mesh_dev = (device_mesh(shape=grid2d, device=device)
                    if grid2d is not None
                    else device_mesh(nshard, device=device))
        sharded = ShardedScaledCG(
            sysm, d, vdim, mesh_dev,
            dtype=torch.float64 if prec == "f64" else torch.float32)
        get_logger().info("sharded CG: domain decomposition over a %s mesh",
                          "x".join(str(a) for a in mesh_dev.shape))

    if prec == "f64":
        # The reported residual is the true ‖b̂ − Â x̂‖/‖b̂‖ (one more
        # apply), not CG's recurrence, which near the float64 floor reads
        # far below it.  The JAX package reports the recurrence (ROADMAP
        # queue 3).
        if sharded_mg is not None:
            from pde_solver_tpu_torch.parallel.shard_mg import \
                solve_mg_sharded

            xh, k, _ = solve_mg_sharded(sharded_mg, sysm.b_hat, x0_hat,
                                        cfg.tol, cfg.mg_maxiter)
            relres = sharded_mg.relres(xh, sysm.b_hat)
        elif sharded is not None:
            xh, k, _ = sharded.solve(x0=x0_hat, tol=cfg.tol, maxiter=maxiter)
            relres = sharded.relres(xh)
        else:
            b64 = torch.as_tensor(sysm.b_hat, dtype=torch.float64,
                                  device=device)
            if hierarchy is not None:
                w64 = hierarchy.levels[0].weights
                xh, k, _ = mg.solve_mg(hierarchy, sysm.b_hat, x0_hat,
                                       cfg.tol, cfg.mg_maxiter)
            else:
                w64 = tuple(torch.tensor(W, dtype=torch.float64,
                                         device=device)
                            for W in sysm.weights)   # a copy: W may be cached
                xh, k, _ = _cg_unit_diag(
                    offsets, w64, b64, torch.as_tensor(x0_hat, device=device),
                    cfg.tol, maxiter, d, vdim)
            r = b64 - _stencil_apply(offsets, w64, xh, d, vdim)
            bnorm = float(torch.sqrt(_dot(b64, b64)))
            relres = (float(torch.sqrt(_dot(r, r)))
                      / (bnorm if bnorm > 0 else 1.0))
        return _stats_result(sysm, xh, k, relres, cfg.tol, cfg)
    if prec == "f32":
        tol_used = max(cfg.inner_tol, F32_TOL_FLOOR)
        b32 = sysm.b_hat.astype(np.float32)
        x32 = x0_hat.astype(np.float32)
        if sharded_mg is not None:
            from pde_solver_tpu_torch.parallel.shard_mg import \
                solve_mg_sharded

            xh, k, relres = solve_mg_sharded(sharded_mg, b32, x32, tol_used,
                                             cfg.mg_maxiter)
        elif sharded is not None:
            xh, k, relres = sharded.solve(x0=x32, tol=tol_used,
                                          maxiter=maxiter)
        else:
            w32 = _static_flat_op(sysm, mesh, vdim, device) or tuple(
                torch.as_tensor(W, dtype=torch.float32, device=device)
                for W in sysm.weights)

            def f32(a):
                return torch.as_tensor(a, dtype=torch.float32, device=device)

            xh, k, relres = _cg_unit_diag(offsets, w32, f32(b32), f32(x32),
                                          tol_used, maxiter, d, vdim)
        return _stats_result(sysm, xh, k, relres, tol_used, cfg)
    if prec != "mixed":
        raise ValueError(f"unknown precision {prec!r}")

    if hierarchy is not None and sharded_mg is None:
        from pde_solver_tpu_torch.ops import df32

        # Double-float32 F-cycle: Galerkin ladder with an exact f64
        # coarsest anchor and error-free-transformation defects at the
        # finest level — beats the κ_eff·ε32 floor that stalls a plain
        # f32 refinement loop on ill-conditioned problems.
        with obs.span("setup.ladder") as sp_l:
            if ladder_core is not None:
                ladder = mg.ladder_with_b(ladder_core, sysm.b_hat)
            else:
                ladder = mg.build_df_ladder(hierarchy, sysm, sysm.b_hat)
                _mg_cache_put(hier_key, hierarchy, ladder)
        with obs.span("solve.df2") as sp_s:
            x_hi, x_lo, iters, relres = mg.solve_fcycle_df2(
                hierarchy, ladder, max(cfg.tol, 1e-9),
                max_rounds=max(cfg.refine_rounds, 8))
        get_logger().info("df ladder build: %.3fs, df2 rounds: %.3fs "
                          "(%d DOF)", sp_l.seconds, sp_s.seconds, n)
        with obs.span("solve.fetch"):
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

    # mixed, no unsharded hierarchy: f32 inner solves on the device (sharded
    # MG-PCG, sharded CG, or CG) + float64 refinement residuals in host
    # numpy against the host scaled weights
    if sharded_mg is not None:
        from pde_solver_tpu_torch.parallel.shard_mg import solve_mg_sharded

        def inner_solve(r32):
            return solve_mg_sharded(sharded_mg, r32, None, cfg.mg_inner_tol,
                                    cfg.mg_maxiter)
    elif sharded is not None:
        def inner_solve(r32):
            return sharded.solve(b_hat=r32, tol=cfg.inner_tol,
                                 maxiter=maxiter)
    else:
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
        for rnd in range(cfg.refine_rounds):
            r = sysm.b_hat - np_stencil_apply(scaled_np, x_hat, d, vdim)
            relres = float(np.linalg.norm(r.reshape(-1))) / bnorm
            if relres <= cfg.tol or not np.isfinite(relres):
                break
            scale = float(np.max(np.abs(r)))
            d32, k, _ = inner_solve(np.asarray(r / scale, dtype=np.float32))
            x_hat = x_hat + scale * d32.cpu().numpy().astype(np.float64)
            iters += int(k)
            get_logger().info("refinement round %d: relres before %.3e, %d "
                              "inner iterations (%d DOF)", rnd, relres, k, n)
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
