"""Sharded geometric multigrid: MG-PCG over a mesh of shard devices.

Counterpart of ``pde_solver_tpu.parallel.shard_mg``, with the same design:

* the finest level (most of a V-cycle's work and nearly all its weight
  bytes) is cut along grid axis 0: Chebyshev smoothing and residuals run
  per shard with one-node halo exchanges (``parallel.shard``), CG dots are
  sharded dots;
* the coarse tail of the V-cycle runs on whole arrays from one gather of
  the fine residual per cycle, once per distinct device of the mesh (the
  JAX package computes it on every device, replicated): n virtual shards
  on one card compute it once, with the numbers of one copy per shard;
* node grids have odd extents (2^k·m + 1), so the fine level is padded
  along axis 0 to a multiple of the shard count with identity rows (unit
  diagonal, zero couplings, free = 0, zero right side).  The free mask
  keeps the padding exactly zero through smoothing, CG and the transfers,
  so the sharded iteration is the unsharded one up to the order of its
  dot sums.

The flexible PCG is a device program (``parallel.shard._solve``: masked
blocks of ``multigrid.PCG_BLOCK`` iterations, one host read a block,
``HOST_READS["shard_mg"]``), captured as CUDA graphs when every shard lies
on one card, kept with the solver.

The hierarchy must hold plain per-offset tensors
(``build_hierarchy*(use_kernel=False)``): the kernels' flat layout does not
decompose along a grid axis.  The flexible PCG here takes the hierarchy as
built, dense coarsest inverse included, as the JAX package's sharded solver
does (its unsharded float64 ``solve_mg`` drops that inverse).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pde_solver_tpu_torch.ops import device_loop
from pde_solver_tpu_torch.ops import multigrid as mg
from pde_solver_tpu_torch.parallel.shard import (ShardMesh, Sharded,
                                                 _nonzero, _solve,
                                                 _true_relres, _where,
                                                 gather, local_stencil_apply,
                                                 pdot, shard)
from pde_solver_tpu_torch.utils.kept import Kept


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad axis 0 of a tensor by ``rows``."""
    if rows == 0:
        return t
    return torch.cat([t, t.new_zeros((rows,) + tuple(t.shape[1:]))])


def _cheb_constants(omega: float):
    lmax = 4.0 / (3.0 * omega)
    lmin = lmax / 4.0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    return theta, delta, theta / delta


def _local_cheb(apply_A, x, rhs, degree: int, omega: float):
    """Chebyshev smoother (the polynomial of ``ops.multigrid.v_cycle``) with
    a shard-local operator."""
    theta, delta, sigma = _cheb_constants(omega)
    res = rhs - apply_A(x)
    dvec = res / theta
    x = x + dvec
    rho_old = 1.0 / sigma
    for _ in range(degree - 1):
        rho = 1.0 / (2.0 * sigma - rho_old)
        dvec = (dvec * (rho * rho_old)
                + (rhs - apply_A(x)) * (2.0 * rho / delta))
        x = x + dvec
        rho_old = rho
    return x


def _level_on(lv: mg.MGLevel, device) -> mg.MGLevel:
    """A level's device tensors on ``device`` (the host arrays stay)."""
    def move(t):
        return None if t is None else t.to(device)

    return lv._replace(weights=tuple(move(W) for W in lv.weights),
                       free=move(lv.free), s=move(lv.s), C=move(lv.C),
                       Cinv=move(lv.Cinv), Ainv=move(lv.Ainv))


class ShardedMGSolver:
    """MG-PCG on a prepared scaled system, decomposed over a 1-D shard
    mesh.  Build once per (hierarchy, mesh); :meth:`solve` many times.

    ``h`` must hold plain per-offset weights (``use_kernel=False``)."""

    def __init__(self, h: mg.MGHierarchy, mesh_dev: ShardMesh):
        lv0 = h.levels[0]
        if not isinstance(lv0.weights, tuple):
            raise ValueError(
                "ShardedMGSolver needs plain per-offset weights: build the "
                "hierarchy with use_kernel=False")
        if len(mesh_dev.shape) != 1:
            raise ValueError("sharded MG cuts grid axis 0 only (a 1-D mesh)")
        self.h = h
        self.mesh_dev = mesh_dev
        self.d, self.vdim = h.grid_dim, h.vdim
        self.nx = lv0.free.shape[0]
        self.n_pad = (-self.nx) % mesh_dev.size
        self.rows = (self.nx + self.n_pad) // mesh_dev.size
        self.dtype = dtype = lv0.free.dtype
        zero_off = tuple(0 for _ in range(self.d))
        eye = (1.0 if self.vdim == 1
               else torch.eye(self.vdim, dtype=dtype, device=lv0.free.device))

        # the fine level, padded along axis 0 with identity rows (free = 0)
        w_pad = []
        for off, W in zip(lv0.offsets, lv0.weights):
            Wp = _pad_rows(W, self.n_pad)
            if off == zero_off and self.n_pad:
                Wp[self.nx:] = eye
            w_pad.append(shard(Wp, mesh_dev, dtype))
        self.w_pad = tuple(w_pad)
        self.free = shard(_pad_rows(lv0.free, self.n_pad), mesh_dev, dtype)
        self.not_free = 1.0 - self.free
        # the coarse tail (levels 1..) and the whole fine level's transfer
        # scales, once per distinct device of the mesh
        fine_full = mg.MGLevel(lv0.offsets, (), lv0.free, lv0.omega, lv0.s,
                               lv0.C, lv0.Cinv)
        tail = mg.MGHierarchy(h.levels[1:], self.d, self.vdim, h.pre_smooth,
                              h.post_smooth, h.coarse_iters)
        self._tails = {}
        for dev in mesh_dev.distinct_devices():
            if dev == lv0.free.device:
                self._tails[dev] = (fine_full, tail)
            else:
                self._tails[dev] = (_level_on(fine_full, dev), tail._replace(
                    levels=tuple(_level_on(lv, dev) for lv in tail.levels)))

    def apply(self, x: Sharded) -> Sharded:
        return local_stencil_apply(self.h.levels[0].offsets, self.w_pad, x,
                                   self.vdim)

    def _coarse_correct(self, rho: Sharded) -> Sharded:
        """Gather the fine residual, run the coarse tail (restrict, V-cycle
        on levels 1.., prolong) once per distinct device, and hand each
        shard its rows."""
        out = [None] * self.mesh_dev.size
        for dev, (fine, tail) in self._tails.items():
            rho_full = torch.cat([p.to(dev, non_blocking=True)
                                  for p in rho.parts], 0)[:self.nx]
            lv1 = tail.levels[0]
            rc = mg._restrict_hat(fine, lv1, rho_full, self.d, self.vdim)
            ec = mg.v_cycle(tail, rc)
            ef = _pad_rows(mg._prolong_hat(fine, lv1, ec, self.d, self.vdim),
                           self.n_pad)
            for k, dk in enumerate(self.mesh_dev.devices):
                if dk == dev:
                    out[k] = ef[k * self.rows:(k + 1) * self.rows]
        return Sharded(out, self.mesh_dev)

    def _precondition(self, r: Sharded) -> Sharded:
        """One V-cycle: sharded Chebyshev smoothing around the coarse
        tail; the constrained and padded rows pass r through."""
        h = self.h
        omega0 = h.levels[0].omega
        rf = r * self.free
        x = _local_cheb(self.apply, rf.zeros_like(), rf, h.pre_smooth, omega0)
        rho = rf - self.apply(x)
        x = x + self.free * self._coarse_correct(rho)
        x = _local_cheb(self.apply, x, rf, h.post_smooth, omega0)
        return x * self.free + self.not_free * r

    def _grid_put(self, arr) -> Sharded:
        if not isinstance(arr, torch.Tensor):
            arr = torch.as_tensor(np.asarray(arr), dtype=self.dtype)
        return shard(_pad_rows(arr, self.n_pad), self.mesh_dev, self.dtype)

    def _program(self):
        """The flexible (Polak-Ribière) PCG, one V-cycle an iteration, as
        a masked loop program over Sharded values (state: x, r, p, then
        ⟨r, z⟩, ‖r‖², k, active, tol², ‖b‖², maxiter)."""
        A, M = self.apply, self._precondition

        def prologue(b, x0, tol, maxiter):
            r = b - A(x0)
            z = M(r)
            rz = pdot(r, z)
            bnorm2 = _nonzero(pdot(b, b).to(torch.float64))
            tol2 = (tol * tol) * bnorm2
            rr = pdot(r, r)
            k = torch.zeros((), dtype=torch.int64, device=rz.device)
            active = (rr.to(torch.float64) > tol2) & (k < maxiter)
            return (x0, r, z, rz, rr, k, active, tol2, bnorm2, maxiter)

        def step(state, g: int):
            x, r, p, rz, rr, k, active, tol2, bnorm2, maxiter = state
            Ap = A(p)
            alpha = rz / _nonzero(pdot(p, Ap))
            x_n = x + p * alpha
            r_n = r - Ap * alpha
            z = M(r_n)
            # Polak-Ribière β (flexible PCG), clamped at 0 (restart guard)
            rz_n = pdot(r_n, z)
            beta = torch.clamp((rz_n - pdot(z, r)) / _nonzero(rz), min=0.0)
            p_n = z + p * beta
            x, r = _where(active, x_n, x), _where(active, r_n, r)
            p, rz = _where(active, p_n, p), torch.where(active, rz_n, rz)
            k = k + active.to(k.dtype)
            rr = pdot(r, r)
            active = (rr.to(torch.float64) > tol2) & (k < maxiter)
            return (x, r, p, rz, rr, k, active, tol2, bnorm2, maxiter)

        def status(state):
            rr, k, active, bnorm2 = state[4], state[5], state[6], state[8]
            return device_loop.status_of(
                active, k, torch.sqrt(rr.to(torch.float64) / bnorm2))

        return prologue, step, status, lambda x: x

    def solve(self, b_hat, x0_hat=None, tol: float = 1e-8,
              maxiter: int = 300):
        """Flexible (Polak-Ribière) PCG, one V-cycle an iteration, as a
        device program kept with the solver.  Returns (x̂ on the first
        shard's device, iterations, relres of the recurrence)."""
        b = self._grid_put(b_hat)
        x0 = b.zeros_like() if x0_hat is None else self._grid_put(x0_hat)
        x, k, relres = _solve(device_loop.store_of(self), "shard_mg",
                              self._program(), b, x0, tol, maxiter,
                              mg.PCG_BLOCK)
        return gather(x)[:self.nx], k, relres

    def relres(self, x_hat, b_hat) -> float:
        """The true relative residual of x̂."""
        return _true_relres(self.apply, self._grid_put(b_hat),
                            self._grid_put(x_hat))


# ----------------------------------------------------------------------
# linsolve-facing helpers
# ----------------------------------------------------------------------

_SOLVER_CACHE = Kept(4, lambda entry: device_loop.release(entry[1]))


def shard_hierarchy(h: mg.MGHierarchy, mesh_dev: ShardMesh,
                    key=None) -> ShardedMGSolver:
    """Build (or reuse) a ShardedMGSolver for this hierarchy and mesh.

    ``key``: the hierarchy's content key (linsolve passes its
    ``hier_key``); the cache key adds the mesh's device list and shard
    count, since virtual shards share a device index.  Without a key the
    entry keys on ``id(h)`` and pins the hierarchy object, and reuse needs
    ``cached_h is h``: a collected hierarchy's id can never alias a new one
    to a stale solver."""
    mesh_key = (tuple(str(dev) for dev in mesh_dev.devices), mesh_dev.size)
    cache_key = (key if key is not None else id(h), mesh_key)
    entry = _SOLVER_CACHE.get(cache_key)
    if entry is not None:
        cached_h, solver = entry
        if key is not None or cached_h is h:
            return solver
    solver = ShardedMGSolver(h, mesh_dev)
    _SOLVER_CACHE.put(cache_key, (h, solver))
    return solver


def solve_mg_sharded(solver: ShardedMGSolver, b_hat,
                     x0_hat: Optional[np.ndarray], tol: float,
                     maxiter: int):
    """The solver is bound to its mesh at construction; there is no
    per-call mesh override."""
    return solver.solve(b_hat, x0_hat, tol=tol, maxiter=maxiter)
