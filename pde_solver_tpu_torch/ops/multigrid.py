"""Geometric multigrid and the double-float32 F-cycle, eager torch.

Counterpart of ``pde_solver_tpu.ops.multigrid`` for what the static
elasticity flagship runs: simplicial transfers, the level hierarchy with an
exact dense coarsest inverse, a Chebyshev-smoothed V-cycle, flexible MG-PCG
(:func:`mg_pcg`), the per-round double-float32 F-cycle
(:func:`solve_fcycle_df2`), and the float32 hierarchy's disk-cache layer
(:func:`build_hierarchy_cached`, dense entries only).

A float32 level applies through :class:`FlatStencilOperator` (the CUDA
kernel on the card, its plain torch version on the CPU) while its DOF count
is at least ``KERNEL_MIN_DOF``: float32 weights for true residuals and,
from ``BF16_MIN_DOF`` unknowns up, a bfloat16 copy for the smoother.  With
``PDE_TPU_CS`` on, a level whose stencil is constant-interior applies
through :class:`CSFlatStencilOperator` instead, as the reference routes
it.  Smoothing and the PCG state live in the flat ``[v, N]`` layout; grid
layout only at the transfer boundary.  A float64 level
(``dtype=torch.float64``: the f64 static solve :func:`solve_mg` and the
f64 scans) holds plain per-offset float64 tensors and applies through
shifted slices, as the JAX package's float64 levels do: no kernel is built
for it.

Scaling-aware transfers: with x = S x̂ per level (S = diag(s), or S = C^{-T}
for block-Cholesky scaling), Galerkin-consistent transfers are
P̂ = S_f^{-1} P S_c and R̂ = P̂ᵀ.  Per-node 3×3 blocks multiply as broadcast
+ sum, never as batched GEMMs (no TF32 route).

The solve loops run on the device (``ops.device_loop``): :func:`mg_pcg`
is a loop of masked iterations, captured on the card as CUDA graphs of
``block`` iterations, the host reading one status per block; a
double-float32 round (:func:`_jit_round_df`, its inner solves
:func:`_mg_pcg_inline` of a fixed count) and its residual pre-check are
one graph each, read once a round.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pde_solver_tpu_torch.mesh import StructuredMesh
from pde_solver_tpu_torch.ops import device_loop
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.ops.cs_kernels import (CSFlatStencilOperator,
                                                 cs_enabled, cs_mode,
                                                 cs_wins)
from pde_solver_tpu_torch.ops.linsolve import (ScaledSystem, _dot,
                                               _entry_bytes, _is_flat_op,
                                               _loop_parts, _pad1,
                                               _stencil_apply, _where1,
                                               prepare_system)
from pde_solver_tpu_torch.ops.stencil_kernels import (FlatStencilOperator,
                                                      kernel_wins)
from pde_solver_tpu_torch.utils import observability as obs
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
    weights: object                      # FlatStencilOperator (f32),
                                         # CSFlatStencilOperator or a tuple
                                         # of per-offset tensors — the true
                                         # operator (outer residuals)
    free: torch.Tensor                   # mask over DOFs (grid layout), in
                                         # the level's dtype
    omega: float                         # 4/(3 λmax)
    s: Optional[torch.Tensor]            # scalar 1/sqrt(diag); None for block
    C: Optional[torch.Tensor]            # block Cholesky factor [.., v, v]
    Cinv: Optional[torch.Tensor]
    Ainv: Optional[torch.Tensor] = None  # dense inverse (coarsest level only)
    host_weights: Optional[list] = None  # f64 numpy copies (df ladder)
    host_Ainv: Optional[np.ndarray] = None
    host_scale: Optional[tuple] = None   # (s,) or (C, Cinv) f64 numpy
    # Preconditioner-grade operator for smoothing (bf16 weights; None on
    # float64 levels and below BF16_MIN_DOF).  The V-cycle stays
    # a fixed symmetric operator built from w_lo at every level; only
    # mg_pcg's true residual needs the f32 weights.
    w_lo: Optional[object] = None
    # (hi, lo) float32 numpy pairs of host_weights, set by the disk-cache
    # layer (a rebuild, or a fresh build it stored) so build_df_ladder skips
    # its own split: the pair is what the ladder uploads.
    host_pairs: Optional[tuple] = None

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
    # the captured solve loops over these levels (``ops.device_loop``);
    # copies made with ``_replace`` share it, so its keys name the levels
    # a program runs on.  None: each solve captures for itself
    graphs: Optional[device_loop.GraphStore] = None


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


# The reference makes its bf16 smoother copy only on the levels its flat
# kernel takes (``pallas_wins``: ``PALLAS_MIN_DOF`` = 65,536 unknowns); a
# smaller level smooths with its float32 weights.  Below this gate a bf16
# copy made the float32 MG-PCG with resync stall on the 16×8×8 cantilever.
BF16_MIN_DOF = 65_536


def _to_level(sysm: ScaledSystem, mesh, vdim: int, device,
              dtype=torch.float32, omega: Optional[float] = None,
              pairs: Optional[tuple] = None,
              use_kernel: bool = True) -> MGLevel:
    """One MG level's device operators from a scaled system.  A float32
    level of at least ``KERNEL_MIN_DOF`` unknowns gets the kernel-backed
    operator, plus its bf16 smoother copy (cast on the device) from
    ``BF16_MIN_DOF`` unknowns up, as the reference's; any other
    level (float64, below the gate, or ``use_kernel=False``) plain
    per-offset tensors in ``dtype`` — the reference's gate ``use_pallas
    and dtype == float32``.  A sharded hierarchy is built with
    ``use_kernel=False`` (``parallel.shard_mg`` cuts the grid tensors).

    ``PDE_TPU_CS`` as the reference reads it: "1" applies a
    constant-interior level through the CS operator for both residuals and
    smoothing (it streams no weights, so a bf16 copy buys nothing);
    "hybrid" keeps the dense bf16 operator for smoothing.  A level that is
    not CS-representable, or has fewer than ``CS_MIN_DOF`` unknowns, stays
    dense.

    ``pairs``: the level's (hi, lo) float32 split (a disk-cache rebuild);
    the device weights are built from ``hi``, which is the float32 rounding
    of the float64 weights, so they are the fresh build's bit for bit."""
    host_w = [np.asarray(W, dtype=np.float64) for W in sysm.weights]
    w_src = pairs[0] if pairs is not None else sysm.weights
    # torch.tensor copies: the cached host arrays are read-only, and a CPU
    # tensor of their own dtype would alias them
    free = torch.tensor(sysm.free, dtype=dtype, device=device)
    n_dof = int(np.prod(mesh.node_shape)) * vdim
    w_lo = None
    if use_kernel and dtype == torch.float32 and kernel_wins(n_dof):
        mode = cs_mode()
        cs = None
        if cs_enabled(mode) and cs_wins(n_dof):
            cs = CSFlatStencilOperator.try_build(
                sysm.offsets, w_src, mesh.node_shape, vdim=vdim,
                device=device, cache_key=sysm.ckey)
        if cs is not None and mode == "hybrid":
            w = cs
            w_lo = FlatStencilOperator(sysm.offsets, w_src,
                                       mesh.node_shape, vdim=vdim,
                                       device=device,
                                       weight_dtype=torch.bfloat16)
        elif cs is not None:
            w = w_lo = cs
        else:
            w = FlatStencilOperator(sysm.offsets, w_src,
                                    mesh.node_shape, vdim=vdim, device=device)
            if n_dof >= BF16_MIN_DOF:
                w_lo = w.as_weight_dtype(torch.bfloat16)
    else:
        w = tuple(torch.tensor(W, dtype=dtype, device=device)
                  for W in w_src)

    def dev(a):
        return torch.tensor(a, dtype=dtype, device=device)

    if sysm.scale_kind == "scalar":
        return MGLevel(sysm.offsets, w, free, omega, dev(sysm.s), None, None,
                       host_weights=host_w, host_scale=(np.asarray(sysm.s),),
                       w_lo=w_lo, host_pairs=pairs)
    C_np = np.swapaxes(sysm.Ct, -1, -2)
    Cinv_np = np.swapaxes(sysm.CinvT, -1, -2)
    return MGLevel(sysm.offsets, w, free, omega, None, dev(C_np),
                   dev(Cinv_np), host_weights=host_w,
                   host_scale=(C_np, Cinv_np), w_lo=w_lo, host_pairs=pairs)


def _with_coarsest_inverse(levels, host_Ainv: np.ndarray, device,
                           dtype=torch.float32):
    levels[-1] = levels[-1]._replace(
        Ainv=torch.tensor(host_Ainv, dtype=dtype, device=device),
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
    dtype=torch.float32,
    use_kernel: bool = True,
) -> Optional[MGHierarchy]:
    """Build the level stack, every level's tensors in ``dtype`` (float32:
    kernel-backed operators unless ``use_kernel=False``; float64: plain
    tensors).
    ``level_builder(mesh_c)`` re-assembles the operator + BCs on a coarse
    mesh.  Returns None when the fine mesh cannot coarsen."""
    if not can_coarsen(mesh):
        return None
    levels = [_to_level(fine_system, mesh, vdim, device, dtype,
                        use_kernel=use_kernel)]
    meshes = [mesh]
    cur = mesh
    cur_sys = fine_system
    while len(levels) < max_levels and can_coarsen(cur):
        cur = coarsen_mesh(cur)
        stencil_c, bc_c = level_builder(cur)
        shape_c = cur.node_shape + ((vdim,) if vdim > 1 else ())
        cur_sys = prepare_system(stencil_c, cur, bc_c, np.zeros(shape_c), vdim)
        levels.append(_to_level(cur_sys, cur, vdim, device, dtype,
                                use_kernel=use_kernel))
        meshes.append(cur)
    # λmax per level: Chebyshev smoothing diverges on any eigenvalue above
    # its assumed λmax, so it is estimated, with a 1.05 margin for the power
    # iteration's underestimate.  Seed-0 numpy start vector per level, the
    # same one the JAX package draws.
    for i, (lv, m) in enumerate(zip(levels, meshes)):
        rng = np.random.default_rng(0)
        full_shape = m.node_shape + ((vdim,) if vdim > 1 else ())
        x = torch.as_tensor(rng.standard_normal(full_shape), dtype=dtype,
                            device=device)
        lam = 1.05 * max(_power_iteration(lv.offsets, lv.weights, x,
                                          mesh.dim, vdim, 10), 1e-6)
        levels[i] = lv._replace(omega=float(4.0 / (3.0 * lam)))
    # Exact dense inverse at the coarsest level: an iterative coarse solve
    # leaves the preconditioner non-SPD (PCG breakdown at scale).
    n_coarse = int(np.prod(cur.node_shape)) * vdim
    if n_coarse <= 20000:
        A_dense = dense_from_stencil(cur_sys.offsets, cur_sys.weights,
                                     cur.node_shape, vdim)
        levels = _with_coarsest_inverse(levels, np.linalg.inv(A_dense),
                                        device, dtype)
    return MGHierarchy(tuple(levels), mesh.dim, vdim, pre_smooth,
                       post_smooth, coarse_iters, device_loop.GraphStore())


# ----------------------------------------------------------------------
# Disk-backed hierarchy build (fresh-process set-up skip)
# ----------------------------------------------------------------------
#
# A float32 hierarchy is a pure function of the fine scaled system, so it
# persists across processes (``utils.diskcache``, kind "mgh") keyed by the
# fine system's content key (``ScaledSystem.ckey``).  The entry holds per
# level the double-float32 weight pair (hi is the float32 device weights;
# hi + lo carries the float64 operator to 2⁻⁴⁸ — what the df ladder
# uploads), the transfer scales, the free mask and ω, and the dense
# coarsest inverse.  A rebuild does no assembly, prepare or power
# iteration: each level goes through :func:`_to_level` with its stored ω
# and pair, so the routing (kernel size gate, bf16 smoother copy, device)
# is applied at load, not baked into the entry.  Dense entries only: the
# JAX package's constant-interior level form (``meta["cs"]``) is a miss.

def _hierarchy_to_arrays(h: MGHierarchy):
    """Serialize a hierarchy (host side) → (arrays, meta, per-level (hi, lo)
    pairs), the JAX package's dense entry format."""
    from pde_solver_tpu_torch.ops import df32

    arrays = {}
    omegas, shapes, all_pairs = [], [], []
    scale_kind = "scalar" if h.levels[0].s is not None else "block"
    for i, lv in enumerate(h.levels):
        if lv.host_pairs is not None:
            his, los = lv.host_pairs
        else:
            his, los = [], []
            for W in lv.host_weights:
                hi, lo = df32.df_from_f64(W)
                his.append(hi)
                los.append(lo)
        all_pairs.append((list(his), list(los)))
        arrays[f"hi{i}"] = np.stack(his)
        arrays[f"lo{i}"] = np.stack(los)
        arrays[f"off{i}"] = np.asarray(lv.offsets, dtype=np.int64)
        arrays[f"free{i}"] = lv.free.cpu().numpy().astype(np.float32)
        if scale_kind == "scalar":
            arrays[f"s{i}"] = np.asarray(lv.host_scale[0])
        else:
            arrays[f"C{i}"] = np.asarray(lv.host_scale[0])
            arrays[f"Cinv{i}"] = np.asarray(lv.host_scale[1])
        omegas.append(float(lv.omega))
        shapes.append([int(n) for n in lv.free.shape[:h.grid_dim]])
    if h.levels[-1].host_Ainv is not None:
        arrays["Ainv"] = np.asarray(h.levels[-1].host_Ainv)
    meta = {"n_levels": len(h.levels), "grid_dim": h.grid_dim,
            "vdim": h.vdim, "pre": h.pre_smooth, "post": h.post_smooth,
            "coarse_iters": h.coarse_iters, "scale_kind": scale_kind,
            "omegas": omegas, "node_shapes": shapes,
            "cs": [False] * len(h.levels)}
    return arrays, meta, all_pairs


def _level_from_disk_dense(ent, i: int, meta, device,
                          use_kernel: bool = True) -> MGLevel:
    """Rebuild one dense-stored level from its (hi, lo) float32 pair."""
    hi, lo = ent[f"hi{i}"], ent[f"lo{i}"]
    n_off = hi.shape[0]
    offsets = tuple(tuple(int(x) for x in row) for row in ent[f"off{i}"])
    host_w = [hi[k].astype(np.float64) + lo[k] for k in range(n_off)]
    free = ent[f"free{i}"].astype(np.float64)
    node_shape = tuple(int(s) for s in meta["node_shapes"][i])
    if meta["scale_kind"] == "scalar":
        sysm = ScaledSystem(offsets, host_w, None, None, free, "scalar",
                            ent[f"s{i}"], None, None)
    else:
        C, Cinv = ent[f"C{i}"], ent[f"Cinv{i}"]
        sysm = ScaledSystem(offsets, host_w, None, None, free, "block",
                            None, np.swapaxes(C, -1, -2),
                            np.swapaxes(Cinv, -1, -2))
    pairs = ([hi[k] for k in range(n_off)], [lo[k] for k in range(n_off)])
    return _to_level(sysm, _ShapeOnlyMesh(node_shape), int(meta["vdim"]),
                     device, omega=float(meta["omegas"][i]), pairs=pairs,
                     use_kernel=use_kernel)


def _hierarchy_from_arrays_disk(ent, device,
                                use_kernel: bool = True) -> MGHierarchy:
    """Rebuild a hierarchy from a dense disk entry, level by level."""
    meta = ent["meta"]
    n_levels = int(meta["n_levels"])
    levels = [_level_from_disk_dense(ent, i, meta, device, use_kernel)
              for i in range(n_levels)]
    if "Ainv" in ent:
        levels = _with_coarsest_inverse(levels, ent["Ainv"], device)
    return MGHierarchy(tuple(levels), int(meta["grid_dim"]),
                       int(meta["vdim"]), int(meta["pre"]),
                       int(meta["post"]), int(meta["coarse_iters"]),
                       device_loop.GraphStore())


def load_hierarchy_from_disk(cache_key, vdim: int, device="cuda",
                             use_kernel: bool = True
                             ) -> Optional[MGHierarchy]:
    """Rebuild a float32 hierarchy purely from its disk entry (uploads
    only).  None on a miss, a constant-interior entry or an unusable
    one.  The entry is layout-agnostic: ``use_kernel`` only picks the
    rebuilt levels' operators."""
    from pde_solver_tpu_torch.utils import diskcache

    ent = diskcache.load("mgh", (cache_key, vdim))
    if ent is None:
        return None
    if any(ent["meta"].get("cs") or ()):
        get_logger().info("hierarchy disk entry holds constant-interior "
                          "levels (not ported): a miss")
        return None
    try:
        return _hierarchy_from_arrays_disk(ent, device, use_kernel)
    except Exception as e:  # corrupt entry → the caller builds afresh
        get_logger().warning("hierarchy disk entry unusable (%s)", e)
        return None


def build_hierarchy_cached(mesh: StructuredMesh, fine_system: ScaledSystem,
                           level_builder, vdim: int = 1, device="cuda",
                           dtype=torch.float32, cache_key=None,
                           use_kernel: bool = True,
                           **kw) -> Optional[MGHierarchy]:
    """:func:`build_hierarchy` behind the disk-cache layer: float32
    hierarchies only, ``cache_key`` the fine system's content key.  While
    ``PDE_TPU_CS`` is on the layer is skipped both ways (a hit would bypass
    the constant-interior route)."""
    from pde_solver_tpu_torch.utils import diskcache

    cacheable = (cache_key is not None and dtype == torch.float32
                 and diskcache.enabled() and not cs_enabled())
    n_dof = int(np.prod(mesh.node_shape)) * vdim
    if cacheable:
        with obs.span("setup.hierarchy.load") as sp:
            h = load_hierarchy_from_disk(cache_key, vdim, device, use_kernel)
        if h is not None:
            obs.count("hierarchy_disk_hits")
            get_logger().info("hierarchy disk-cache hit (%.3fs rebuild, %d "
                              "bytes, %d DOF)", sp.seconds,
                              _entry_bytes("mgh", (cache_key, vdim)), n_dof)
            return h
    obs.count("hierarchy_builds")
    h = build_hierarchy(mesh, fine_system, level_builder, vdim=vdim,
                        device=device, dtype=dtype, use_kernel=use_kernel,
                        **kw)
    if h is not None and cacheable:
        with obs.span("setup.hierarchy.store") as sp:
            arrays, meta, all_pairs = _hierarchy_to_arrays(h)
            # the freshly split pairs ride along, so this process's ladder
            # skips its own split
            h = h._replace(levels=tuple(
                lv._replace(host_pairs=p)
                for lv, p in zip(h.levels, all_pairs)))
            diskcache.store("mgh", (cache_key, vdim), arrays, meta)
        get_logger().info("hierarchy disk-cache store (%.3fs, %d bytes, %d "
                          "DOF)", sp.seconds,
                          _entry_bytes("mgh", (cache_key, vdim)), n_dof)
    return h


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
    if _is_flat_op(lv.w_smooth):
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


# Masked blocks of :func:`mg_pcg`.  A static solve resyncs every 16
# iterations, so its block is 16 and the resync falls on position 15 of
# every block; a warm-started transient or Newmark step (resync_every=0)
# takes a handful of iterations (heat 3D 128³: 6.1), so 8 keeps a step to
# one block and one read.
PCG_BLOCK = 16
STEP_BLOCK = device_loop.STEP_BLOCK


def _pcg_program(h: MGHierarchy, resync_every: int):
    """The masked flexible PCG of :func:`mg_pcg` on the finest level of
    ``h``, as (prologue, step, status, from_flat) for ``ops.device_loop``.

    State: (x, r, p, rz, ‖r‖², k, active, b, free, tol², ‖b‖², maxiter),
    in the flat ``[v, N]`` layout when the finest level is kernel-backed.
    ``step(state, g)`` is one iteration, kept only while ``active``; ``g``
    is its global index (the resync falls on g % resync_every ==
    resync_every − 1, which is k while the loop is active).  The
    convergence test compares ‖r‖² with tol²·‖b‖² in float64, as a host
    loop comparing ``float(rr) > tol2`` does."""
    lv = h.levels[0]
    to_flat, from_flat, A = _loop_parts(lv.offsets, lv.weights, h.grid_dim,
                                        h.vdim)
    flat_io = _is_flat_op(lv.weights)

    def M(r, free):
        z = v_cycle(h, r * free, flat_io=flat_io)
        return z * free + (1.0 - free) * r

    def prologue(b, x0, tol, maxiter):
        free = to_flat(lv.free)
        b, x = to_flat(b), to_flat(x0)
        r = b - A(x)
        z = M(r, free)
        rz = _dot(r, z)
        bnorm2 = _where1(_dot(b, b).to(torch.float64))
        tol2 = (tol * tol) * bnorm2
        rr = _dot(r, r)
        k = torch.zeros((), dtype=torch.int64, device=b.device)
        active = (rr.to(torch.float64) > tol2) & (k < maxiter)
        return (x, r, z, rz, rr, k, active, b, free, tol2, bnorm2, maxiter)

    def step(state, g: int):
        x, r, p, rz, rr, k, active, b, free, tol2, bnorm2, maxiter = state
        Ap = A(p)
        alpha = rz / _where1(_dot(p, Ap))
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        if resync_every > 0 and g % resync_every == resync_every - 1:
            # true-residual resync: the recurrence drifts from b − A x in
            # f32 once conjugacy degrades
            r_n = b - A(x_n)
        z_n = M(r_n, free)
        # Polak-Ribière: β = z·(r_new − r)/rz — robust to inexact M
        rz_n = _dot(r_n, z_n)
        beta = torch.clamp((rz_n - _dot(z_n, r)) / _where1(rz), min=0.0)
        p_n = z_n + beta * p
        x, r = torch.where(active, x_n, x), torch.where(active, r_n, r)
        p, rz = torch.where(active, p_n, p), torch.where(active, rz_n, rz)
        k = k + active.to(k.dtype)
        rr = _dot(r, r)
        active = (rr.to(torch.float64) > tol2) & (k < maxiter)
        return (x, r, p, rz, rr, k, active, b, free, tol2, bnorm2, maxiter)

    def status(state):
        rr, k, active, bnorm2 = state[4], state[5], state[6], state[10]
        return device_loop.status_of(
            active, k, torch.sqrt(rr.to(torch.float64) / bnorm2))

    return prologue, step, status, from_flat


def mg_pcg(h: MGHierarchy, b: torch.Tensor, x0: torch.Tensor, tol, maxiter,
           resync_every: int = 16, block: Optional[int] = None):
    """Flexible PCG on the finest scaled system, one V-cycle per application.

    Flexible (Polak-Ribière β = z·(r−r_prev)/rz_prev), robust to a V-cycle
    that is not an exactly fixed linear operator.  Convergence is checked on
    the recurrence residual ‖r‖, resynced to b − A x every ``resync_every``
    iterations (0: never — warm-started transient steps take a handful of
    iterations and do not drift, so the extra apply would be wasted).
    With a kernel-backed finest level the whole CG state lives in the flat
    layout.  The iterations run as masked blocks of ``block`` (default
    ``PCG_BLOCK``, or ``STEP_BLOCK`` without resync), captured on the card
    in ``h.graphs``; the host reads once a block.  Returns (x, iterations,
    relres)."""
    block = block or (PCG_BLOCK if resync_every > 0 else STEP_BLOCK)
    store = h.graphs if h.graphs is not None else device_loop.GraphStore()
    key = ("mg_pcg", len(h.levels), h.levels[-1].Ainv is not None, block,
           resync_every, tuple(b.shape), b.dtype)
    return device_loop.solve(store, key, _pcg_program(h, resync_every), b,
                             x0, tol, maxiter, block, resync_every)


def _mg_pcg_inline(h: MGHierarchy, b: torch.Tensor, x0: torch.Tensor,
                   tol: float, iters: int, resync_every: int = 16):
    """:func:`mg_pcg` as ``iters`` masked iterations with no read (the
    counterpart of a ``while_loop`` with ``maxiter`` = ``iters`` inside a
    jitted program): returns (x, iterations, relres) as device tensors."""
    prologue, step, status, from_flat = _pcg_program(h, resync_every)
    state = prologue(b, x0, tol, iters)
    for g in range(iters):
        state = step(state, g)
    return from_flat(state[0]), state[5], status(state)[2]


def solve_mg(h: MGHierarchy, b_hat: np.ndarray, x0_hat: Optional[np.ndarray],
             tol: float, maxiter: int):
    """Host entry of the float64 static solve: MG-PCG on the hierarchy's
    device, in its dtype.  Returns (x̂ tensor, iterations, relres).

    The levels go in without their dense coarsest inverse, as the JAX
    package's ``_jit_mg_pcg`` takes them, so each V-cycle ends in the
    ``coarse_iters`` CG fallback: a V-cycle that is not a fixed SPD
    operator, which the flexible PCG tolerates.  Both packages break the
    exact-coarse rule of :func:`build_hierarchy` here alike (ROADMAP
    queue 3)."""
    h = h._replace(levels=tuple(lv._replace(Ainv=None) for lv in h.levels))
    free = h.levels[0].free
    b = torch.as_tensor(np.asarray(b_hat), dtype=free.dtype,
                        device=free.device)
    x0 = (torch.zeros_like(b) if x0_hat is None
          else torch.as_tensor(np.asarray(x0_hat), dtype=free.dtype,
                               device=free.device))
    return mg_pcg(h, b, x0, tol, maxiter)


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
        if lv.host_pairs is not None:
            # disk-cache layer: the (hi, lo) split is already on hand
            Whi = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                        for a in lv.host_pairs[0])
            Wlo = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                        for a in lv.host_pairs[1])
        else:
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
                  x_hi, x_lo, bhi, blo, inner_iters: int):
    """One complete F-cycle round: df32 defect → descend → dense f32
    coarsest solve → df-refreshed ascends → pair update, with the right
    side (bhi, blo).  Returns (x_hi, x_lo, ‖r‖², iters), all on the device:
    every inner solve is :func:`_mg_pcg_inline` (``inner_iters`` masked
    iterations), so the round reads nothing and is captured whole.

    The JAX package fences ``mg_pcg`` with ``optimization_barrier``s against
    an XLA-on-TPU miscompile.  The port has no counterpart: eager torch and
    a captured graph run the same kernels in the same order and fuse
    nothing, so there is nothing to fence (the caller keeps the
    finite-relres stop)."""
    from pde_solver_tpu_torch.ops.df32 import df_scale_add, df_stencil_residual

    grid_dim, vdim = h.grid_dim, h.vdim
    levels = h.levels
    L = len(levels) - 1
    Whi, Wlo, scale32, free32 = (ladder.Whi, ladder.Wlo, ladder.scale32,
                                 ladder.free32)

    r32, rnorm2 = df_stencil_residual(levels[0].offsets, Whi[0], Wlo[0],
                                      bhi, blo, x_hi, x_lo, grid_dim, vdim)
    rs = [r32]
    for m in range(L):
        rs.append(_jit_restrict_hat64(scale32[m], scale32[m + 1],
                                      free32[m + 1], rs[m], grid_dim))
    e = (Ainv32 @ rs[L].reshape(-1)).reshape(rs[L].shape)
    iters = torch.zeros((), dtype=torch.int64, device=e.device)
    for m in range(L - 1, -1, -1):
        e = _jit_prolong_hat64(scale32[m], scale32[m + 1], free32[m], e,
                               grid_dim)
        sub = h._replace(levels=tuple(levels[m:]))
        zero = torch.zeros_like(rs[m])
        for _ in range(1 if m == 0 else 2):
            rho, _ = df_stencil_residual(levels[m].offsets, Whi[m], Wlo[m],
                                         rs[m], zero, e, zero, grid_dim, vdim)
            scale = torch.clamp(torch.sqrt(_dot(rho, rho)), min=1e-30)
            d32, k, _ = _mg_pcg_inline(sub, rho / scale,
                                       torch.zeros_like(rho), 1e-5,
                                       inner_iters)
            e = e + scale * d32
            iters = iters + k
    one = torch.ones((), dtype=torch.float32, device=e.device)
    x_hi, x_lo = df_scale_add(x_hi, x_lo, one, e)
    return x_hi, x_lo, rnorm2, iters


class _DF2Programs:
    """The two programs of :func:`solve_fcycle_df2` over one set of static
    buffers (x_hi, x_lo, bhi, blo, the iterations so far, the check
    [‖r‖², iterations]): ``round`` (:func:`_jit_round_df`, adding its
    iterations) and ``residual`` (the pre-check's defect, writing the
    check).  ``whi`` is the ladder's weight tuple the programs read."""

    def __init__(self, h: MGHierarchy, ladder: DFLadder, inner_iters: int,
                 capture: bool, store: device_loop.GraphStore):
        from pde_solver_tpu_torch.ops.df32 import jit_df_residual

        Ainv32 = h.levels[-1].Ainv   # float32 on the device since the build
        d, vdim = h.grid_dim, h.vdim
        self.whi = ladder.Whi
        z = torch.zeros_like(ladder.bhi0)
        self.buffers = (z, z.clone(), z.clone(), z.clone(),
                        torch.zeros((), dtype=torch.int64, device=z.device),
                        torch.zeros(2, dtype=torch.float64, device=z.device))

        def round_fn(n):
            def fn(g0, x_hi, x_lo, bhi, blo, total, check):
                x_hi, x_lo, _, k = _jit_round_df(h, ladder, Ainv32, x_hi,
                                                 x_lo, bhi, blo, n)
                return x_hi, x_lo, None, None, total + k, None
            return fn

        def residual(g0, x_hi, x_lo, bhi, blo, total, check):
            _, rnorm2 = jit_df_residual(h.levels[0].offsets, ladder.Whi[0],
                                        ladder.Wlo[0], bhi, blo, x_hi, x_lo,
                                        d, vdim)
            return (None,) * 5 + (torch.stack(
                [rnorm2.to(torch.float64), total.to(torch.float64)]),)

        if capture:
            # warm-up: a round of one inner iteration runs every kernel
            # the captured round does
            device_loop._side_stream(lambda: (round_fn(1)(0, *self.buffers),
                                              residual(0, *self.buffers)))
        self.round = device_loop.Program(round_fn(inner_iters), self.buffers,
                                         capture, store)
        self.residual = device_loop.Program(residual, self.buffers, capture,
                                            store)

    def start(self, ladder: DFLadder) -> None:
        x_hi, x_lo, bhi, blo, total, _ = self.buffers
        for t in (x_hi, x_lo, total):
            t.zero_()
        bhi.copy_(ladder.bhi0)
        blo.copy_(ladder.blo0)

    def check(self):
        """Run the residual; (‖r‖², iterations so far): one read."""
        with obs.device_clock("solve.df2", self.buffers[5].device):
            self.residual.run()
        device_loop.count_read("df2")
        rnorm2, total = self.buffers[5].tolist()
        return rnorm2, int(total)


def solve_fcycle_df2(h: MGHierarchy, ladder: DFLadder, tol: float,
                     inner_iters: int = 10, max_rounds: int = 12):
    """Double-float32 F-cycle rounds until relres ≤ tol, a non-finite
    residual, two consecutive sub-2× rounds (the df32 floor) or
    ``max_rounds``.  Returns (x_hi, x_lo, iters, relres); convert with
    ``df32.df_to_f64``.

    Each round and each pre-check is a program of ``h.graphs`` (captured on
    the card): the host reads ‖b‖ once, then one check a round (the
    residual and the iterations so far).  Each round and each check's
    residual is timed on the device (``observability.device_clock``: the
    request's ``df2_device_seconds``), the host's reads and turnarounds
    between them left out."""
    device_loop.count_read("df2")
    bnorm = float(torch.sqrt(_dot(ladder.bhi0, ladder.bhi0)))
    if bnorm == 0.0:
        z = torch.zeros_like(ladder.bhi0)
        return z, z, 0, 0.0
    store = h.graphs if h.graphs is not None else device_loop.GraphStore()
    capture = device_loop.captures(ladder.bhi0.device)
    key = ("df2", inner_iters, tuple(ladder.bhi0.shape), capture)
    progs = store.get(key)
    if progs is None or progs.whi is not ladder.Whi:
        progs = _DF2Programs(h, ladder, inner_iters, capture, store)
        store.put(key, progs)
    progs.start(ladder)
    total = 0
    relres = 1.0
    prev = np.inf
    stalled = 0

    def check(rnd):
        """The residual after round ``rnd``: (relres, iterations so far),
        with the round's INFO line."""
        rnorm2, iters = progs.check()
        get_logger().info("df2 round %d: relres before %.3e, %d inner "
                          "iterations", rnd, relres, iters - total)
        return float(np.sqrt(rnorm2)) / bnorm, iters

    for rnd in range(max_rounds):
        if rnd > 0:
            # convergence pre-check (one df residual) before spending a round
            relres, total = check(rnd - 1)
            if relres <= tol or not np.isfinite(relres):
                break
            if relres > 0.5 * prev:
                stalled += 1
                if stalled >= 2:
                    break
            else:
                stalled = 0
            prev = relres
        with obs.device_clock("solve.df2", ladder.bhi0.device):
            progs.round.run()
        obs.count("df2_rounds")
    else:
        # final residual reflects the last executed round (a stop at a
        # pre-check has it already)
        relres, total = check(max_rounds - 1)
    x_hi, x_lo = (t.clone() for t in progs.buffers[:2])
    return x_hi, x_lo, total, relres
