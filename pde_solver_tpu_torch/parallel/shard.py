"""Domain decomposition over a mesh of shard devices: halo exchange and
sharded dots, in one process.

Counterpart of ``pde_solver_tpu.parallel.shard``.  The JAX package runs a
sharded solve as one ``shard_map`` over a ``jax.sharding.Mesh``, with
``lax.ppermute`` halos and ``lax.psum`` dots.  Here one process drives the
shards eagerly:

* a :class:`ShardMesh` lists one torch device per shard: a 1-D mesh (axis
  ``shard_x``, grid axis 0 cut into slabs) or an a×b mesh (``shard_x`` ×
  ``shard_y``, grid axes 0 and 1 cut into blocks);
* a :class:`Sharded` value holds one block per shard, row-major over the
  mesh, each on its shard's device, and does elementwise arithmetic block
  by block;
* a stencil apply extends each block by one node layer from its lattice
  neighbours (:func:`halo_exchange_axis`: a slice between shards of one
  device, ``.to(device, non_blocking=True)`` between two; edge shards get
  zeros; nothing passes through the host);
* a dot (:func:`pdot`) sums the per-shard dots in shard order on the first
  shard's device (a 0-d tensor, no host read).

The loops are device programs, as the JAX package's run inside
``jax.jit(shard_map(...))``: a solve is a masked loop run in blocks with one
host read a block (``ops.device_loop.run_masked``; :func:`sharded_pcg`,
``ShardedScaledCG.solve``, ``parallel.shard_mg.ShardedMGSolver.solve``) and
a scan one step program a step with one read a chunk of steps
(``device_loop.run_scan``; :class:`ShardedThetaScan`,
:class:`ShardedNewmarkScan`).  Where every shard lies on one CUDA device
(``PDE_TPU_VIRTUAL_DEVICES``) they are captured CUDA graphs; shards on
several cards cannot share one graph, so there the same blocks and steps
run eagerly (:func:`captures`, chosen by the mesh's devices and logged
once at INFO).

Extents that do not divide by the mesh are padded with identity rows (unit
diagonal, zero couplings, zero right side), which stay exactly zero
through CG.

:func:`available_devices` lists the CUDA cards, or the CPU.
``PDE_TPU_VIRTUAL_DEVICES=n`` repeats the configured device n times, the
counterpart of XLA's ``--xla_force_host_platform_device_count``: n shards
on one card check the decomposition, the halos and the reductions there,
and say nothing of multi-GPU speed.

No kernel runs here: sharded applies are plain shifted slices, as the JAX
package's are plain XLA (its packed Pallas layout does not decompose along
a grid axis).  Per-node v×v blocks multiply as broadcast + sum, in the
order of ``ops.linsolve._stencil_apply``, so a sharded apply equals the
unsharded plain one node for node; only the dots sum in another order.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pde_solver_tpu_torch.mesh import StructuredMesh
from pde_solver_tpu_torch.ops import assembly, device_loop
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.ops.linsolve import CG_BLOCK, STEP_BLOCK
from pde_solver_tpu_torch.ops.timestepping import (_make_scale_ops, _row,
                                                   free_rows_step)
from pde_solver_tpu_torch.utils.observability import get_logger

AXIS = "shard_x"   # mesh axis of the grid-axis-0 decomposition
AXIS1 = "shard_y"  # second mesh axis (grid axis 1) of 2-D decompositions

_VIRTUAL_WARNED = set()
_SEVERAL_CARDS_LOGGED = set()


def available_devices(device=None) -> list:
    """The devices shards may be placed on: every CUDA card for a CUDA
    device, the CPU for the CPU.  ``PDE_TPU_VIRTUAL_DEVICES=n`` (read here,
    at call time) gives n copies of the configured device instead."""
    from pde_solver_tpu_torch.config import get_config

    dev = torch.device(get_config().device if device is None else device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0 if dev.index is None else dev.index)
    n_virtual = os.environ.get("PDE_TPU_VIRTUAL_DEVICES", "").strip()
    if n_virtual:
        n = int(n_virtual)
        if (n, str(dev)) not in _VIRTUAL_WARNED:
            _VIRTUAL_WARNED.add((n, str(dev)))
            get_logger().warning(
                "PDE_TPU_VIRTUAL_DEVICES=%d: %d virtual shard devices on %s "
                "(a check of the decomposition, not multi-device speed)",
                n, n, dev)
        return [dev] * n
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


class ShardMesh(NamedTuple):
    """One device per shard, row-major over ``shape``: (n,) for the 1-D
    slab split, (a, b) for the 2-D block split."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (AXIS, AXIS1)[:len(self.shape)]

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct_devices(self) -> list:
        out = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out


def device_mesh(n_devices: Optional[int] = None,
                shape: Optional[Tuple[int, int]] = None,
                device=None) -> ShardMesh:
    """1-D mesh of the first ``n_devices`` available devices (all of them
    by default), or with ``shape=(a, b)`` an a×b mesh of the first a·b."""
    devs = available_devices(device)
    if shape is not None:
        a, b = int(shape[0]), int(shape[1])
        if a * b > len(devs):
            raise ValueError(f"a {a}x{b} mesh needs {a * b} devices, "
                             f"{len(devs)} available")
        return ShardMesh(tuple(devs[:a * b]), (a, b))
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"{n} shards need {n} devices, {len(devs)} "
                         f"available")
    return ShardMesh(tuple(devs[:n]), (n,))


class Sharded:
    """One block per shard of ``mesh`` (row-major), each on its shard's
    device.  Arithmetic with another Sharded value works block by block;
    with a Python number or a 0-d tensor (moved to each block's device),
    on every block."""

    __slots__ = ("parts", "mesh")

    def __init__(self, parts, mesh: ShardMesh):
        self.parts = list(parts)
        self.mesh = mesh

    def map(self, fn) -> "Sharded":
        return Sharded([fn(p) for p in self.parts], self.mesh)

    def _bin(self, other, fn) -> "Sharded":
        if isinstance(other, Sharded):
            return Sharded([fn(a, b) for a, b in zip(self.parts,
                                                     other.parts)],
                           self.mesh)
        if isinstance(other, torch.Tensor):
            return Sharded([fn(a, other.to(a.device, non_blocking=True))
                            for a in self.parts], self.mesh)
        return Sharded([fn(a, other) for a in self.parts], self.mesh)

    def __add__(self, other):
        return self._bin(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._bin(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._bin(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._bin(other, lambda a, b: a * b)

    def __truediv__(self, other):
        return self._bin(other, lambda a, b: a / b)

    def zeros_like(self) -> "Sharded":
        return self.map(torch.zeros_like)


def shard(arr, mesh: ShardMesh, dtype) -> Sharded:
    """Cut a grid array (numpy or tensor) into the mesh's blocks along grid
    axis 0 (and 1 on an a×b mesh); its extents must divide by the mesh's.
    A numpy array is copied to each device; a tensor block already on its
    device in ``dtype`` stays a view."""
    if any(arr.shape[ax] % n for ax, n in enumerate(mesh.shape)):
        raise ValueError(f"grid extents {tuple(arr.shape[:len(mesh.shape)])}"
                         f" do not divide by the mesh {mesh.shape}")
    if isinstance(arr, torch.Tensor):
        rows = arr.chunk(mesh.shape[0], 0)
        blocks = ([c for r in rows for c in r.chunk(mesh.shape[1], 1)]
                  if len(mesh.shape) == 2 else list(rows))
        return Sharded([blk.to(device=dev, dtype=dtype)
                        for blk, dev in zip(blocks, mesh.devices)], mesh)
    a = np.asarray(arr)
    rows = np.split(a, mesh.shape[0], axis=0)
    blocks = ([c for r in rows for c in np.split(r, mesh.shape[1], axis=1)]
              if len(mesh.shape) == 2 else rows)
    return Sharded([torch.tensor(np.ascontiguousarray(blk), dtype=dtype,
                                 device=dev)
                    for blk, dev in zip(blocks, mesh.devices)], mesh)


def gather(x: Sharded, device=None) -> torch.Tensor:
    """The whole grid array on ``device`` (the first shard's by default)."""
    dev = x.parts[0].device if device is None else torch.device(device)
    parts = [p.to(dev, non_blocking=True) for p in x.parts]
    if len(x.mesh.shape) == 1:
        return torch.cat(parts, 0)
    b = x.mesh.shape[1]
    return torch.cat([torch.cat(parts[i:i + b], 1)
                      for i in range(0, len(parts), b)], 0)


# ----------------------------------------------------------------------
# Halo exchange + local stencil application
# ----------------------------------------------------------------------

def halo_exchange_axis(x: Sharded, grid_axis: int,
                       mesh_axis: int = 0) -> Sharded:
    """Extend every block by one node layer from each lattice neighbour
    along ``mesh_axis`` (cut along ``grid_axis``).  Edge shards receive
    zeros: the assembled weights are already truncated there."""
    shape = x.mesh.shape
    n = shape[mesh_axis]
    stride = int(np.prod(shape[mesh_axis + 1:], dtype=np.int64))
    out = []
    for k, blk in enumerate(x.parts):
        i = (k // stride) % n

        def layer(src, at):
            nb = x.parts[src]
            return nb.narrow(grid_axis, nb.shape[grid_axis] - 1 if at < 0
                             else at, 1).to(blk.device, non_blocking=True)

        zero_shape = list(blk.shape)
        zero_shape[grid_axis] = 1
        lo = layer(k - stride, -1) if i > 0 else blk.new_zeros(zero_shape)
        hi = (layer(k + stride, 0) if i < n - 1
              else blk.new_zeros(zero_shape))
        out.append(torch.cat([lo, blk, hi], dim=grid_axis))
    return Sharded(out, x.mesh)


def halo_exchange(x: Sharded) -> Sharded:
    """Axis-0 halo exchange (the 1-D decomposition's form)."""
    return halo_exchange_axis(x, 0, 0)


def _pad_axes(x: torch.Tensor, axes) -> torch.Tensor:
    """Zero-pad ``axes`` of x by one node on each side."""
    axes = tuple(axes)
    if not axes:
        return x
    shape = list(x.shape)
    for ax in axes:
        shape[ax] += 2
    xp = x.new_zeros(shape)
    xp[tuple(slice(1, 1 + x.shape[ax]) if ax in axes else slice(None)
             for ax in range(x.ndim))] = x
    return xp


def local_stencil_apply(offsets, weights, x: Sharded,
                        vdim: int = 1) -> Sharded:
    """y = A x on every shard: halo along grid axis 0 (and axis 1 on an
    a×b mesh), zero padding on the remaining grid axes.  ``weights``: one
    :class:`Sharded` per offset.  The diagonal couplings of the simplicial
    P1 stencil arrive transitively: the axis-1 exchange runs on the
    axis-0-extended blocks, so each halo row is itself exchanged."""
    d = len(offsets[0])
    n_halo = len(x.mesh.shape)
    ext = halo_exchange_axis(x, 0, 0)
    if n_halo == 2:
        ext = halo_exchange_axis(ext, 1, 1)
    out = []
    for k, xe in enumerate(ext.parts):
        xp = _pad_axes(xe, range(n_halo, d))
        local_shape = x.parts[k].shape[:d]
        y = None
        # every grid axis is extended by exactly one layer (halo or zero
        # pad), so the shifted-slice window is uniform
        for off, W in zip(offsets, weights):
            sl = tuple(slice(1 + o, 1 + o + s)
                       for o, s in zip(off, local_shape))
            xs = xp[sl + (Ellipsis,)]
            Wk = W.parts[k]
            term = Wk * xs if vdim == 1 else (Wk * xs[..., None, :]).sum(-1)
            y = term if y is None else y + term
        out.append(y)
    return Sharded(out, x.mesh)


def pdot(a: Sharded, b: Sharded) -> torch.Tensor:
    """Globally reduced inner product: the per-shard dots summed in shard
    order on the first shard's device (a 0-d tensor, no host read)."""
    total = None
    for p, q in zip(a.parts, b.parts):
        t = torch.dot(p.reshape(-1), q.reshape(-1))
        total = t if total is None else total + t.to(total.device,
                                                     non_blocking=True)
    return total


def _nonzero(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t == 0, torch.ones_like(t), t)


def _where(active: torch.Tensor, a: Sharded, b: Sharded) -> Sharded:
    """Block by block, ``a`` where ``active`` holds, else ``b``."""
    return Sharded([torch.where(active.to(p.device, non_blocking=True), p, q)
                    for p, q in zip(a.parts, b.parts)], a.mesh)


# ----------------------------------------------------------------------
# The sharded loops as device programs
# ----------------------------------------------------------------------
#
# A sharded solve is a masked iteration (``ops.device_loop``) whose state
# is (x, r, p, then 0-d tensors on the first shard's device): each
# iteration is kept only while ``active`` holds, and only active ones
# count, so a finished state passes further iterations unchanged.  The
# masked loop runs on flat tuples of tensors (a Sharded value gives its
# parts); a scan's step program inlines the same program on Sharded values.

def captures(mesh: ShardMesh) -> bool:
    """Whether the loops on ``mesh`` run as captured CUDA graphs: every
    shard on one CUDA device (``device_loop.captures`` there).  A graph
    runs on one device, so shards on several cards run the same blocks
    eagerly, logged once a mesh at INFO."""
    devs = mesh.distinct_devices()
    if len(devs) == 1:
        return device_loop.captures(devs[0])
    key = tuple(str(d) for d in devs)
    if key not in _SEVERAL_CARDS_LOGGED and any(d.type == "cuda"
                                                for d in devs):
        _SEVERAL_CARDS_LOGGED.add(key)
        get_logger().info("sharded loops on %d cards (%s) run uncaptured: "
                          "a CUDA graph runs on one device", len(devs),
                          ", ".join(key))
    return False


def _flatten(state) -> tuple:
    """A program state as a flat tuple of tensors (Sharded values give
    their parts)."""
    out = []
    for t in state:
        out.extend(t.parts if isinstance(t, Sharded) else (t,))
    return tuple(out)


def _unflatten(flat, mesh: ShardMesh) -> tuple:
    """The inverse of :func:`_flatten` for a state (x, r, p, tensors...)."""
    n = mesh.size
    return tuple(Sharded(flat[i * n:(i + 1) * n], mesh)
                 for i in range(3)) + tuple(flat[3 * n:])


def _solve(store: device_loop.GraphStore, kind: str, program, b: Sharded,
           x0: Sharded, tol: float, maxiter: int, block: int):
    """Run the sharded masked loop ``program`` (prologue, step, status,
    from_flat over Sharded values) on (b, x0, tol, maxiter) in blocks of
    ``block`` through ``device_loop.run_masked``, one read a block
    (counted under ``kind``).  Returns (x, iterations, relres)."""
    prologue, step, status, _ = program
    mesh, n = b.mesh, b.mesh.size

    def flat_prologue(*bufs):
        return _flatten(prologue(Sharded(bufs[:n], mesh),
                                 Sharded(bufs[n:2 * n], mesh),
                                 bufs[2 * n], bufs[2 * n + 1]))

    def flat_step(state, g):
        return _flatten(step(_unflatten(state, mesh), g))

    def flat_status(state):
        return status(_unflatten(state, mesh))

    key = (kind, block, n, tuple(b.parts[0].shape), b.parts[0].dtype)
    state, st = device_loop.run_masked(
        store, key, flat_prologue, flat_step, flat_status,
        device_loop.loop_inputs(*b.parts, *x0.parts, tol, maxiter), block,
        captures(mesh))
    return Sharded([t.clone() for t in state[:n]], mesh), int(st[1]), st[2]


def _pcg_program(apply_A, inv_diag: Optional[Sharded] = None):
    """Jacobi-PCG over the shards (``inv_diag`` None: the unit diagonal of
    a scaled system) as a masked loop program.  The convergence test
    compares ‖r‖² with tol²·‖b‖² in float64 on the device, as the host
    loop comparing ``float(rr) > tol2`` did."""
    def precond(r):
        return r if inv_diag is None else r * inv_diag

    def rr_of(r, rz):
        return rz if inv_diag is None else pdot(r, r)

    def prologue(b, x0, tol, maxiter):
        r = b - apply_A(x0)
        z = precond(r)
        rz = pdot(r, z)
        bnorm2 = _nonzero(pdot(b, b).to(torch.float64))
        tol2 = (tol * tol) * bnorm2
        rr = rr_of(r, rz)
        k = torch.zeros((), dtype=torch.int64, device=rz.device)
        active = (rr.to(torch.float64) > tol2) & (k < maxiter)
        return (x0, r, z, rz, rr, k, active, tol2, bnorm2, maxiter)

    def step(state, g: int):
        x, r, p, rz, rr, k, active, tol2, bnorm2, maxiter = state
        Ap = apply_A(p)
        alpha = rz / _nonzero(pdot(p, Ap))
        x_n = x + p * alpha
        r_n = r - Ap * alpha
        z_n = precond(r_n)
        rz_n = pdot(r_n, z_n)
        p_n = z_n + p * (rz_n / _nonzero(rz))
        x, r = _where(active, x_n, x), _where(active, r_n, r)
        p, rz = _where(active, p_n, p), torch.where(active, rz_n, rz)
        k = k + active.to(k.dtype)
        rr = rr_of(r, rz)
        active = (rr.to(torch.float64) > tol2) & (k < maxiter)
        return (x, r, p, rz, rr, k, active, tol2, bnorm2, maxiter)

    def status(state):
        rr, k, active, bnorm2 = state[4], state[5], state[6], state[8]
        return device_loop.status_of(
            active, k, torch.sqrt(rr.to(torch.float64) / bnorm2))

    return prologue, step, status, lambda x: x


def sharded_pcg(apply_A, b: Sharded, inv_diag=None, tol=1e-8, maxiter=500,
                x0: Optional[Sharded] = None,
                store: Optional[device_loop.GraphStore] = None,
                block: int = CG_BLOCK):
    """Jacobi-PCG over the shards (``inv_diag`` None: the unit diagonal of
    a scaled system) as a device program: masked blocks of ``block``
    iterations with one host read a block (``HOST_READS["shard_cg"]``),
    kept in ``store`` (whose owner holds what ``apply_A`` and ``inv_diag``
    read; None: this call only).  Returns (x, iterations, relres of the
    recurrence)."""
    x0 = b.zeros_like() if x0 is None else x0
    return _solve(store if store is not None else device_loop.GraphStore(),
                  "shard_cg", _pcg_program(apply_A, inv_diag), b, x0, tol,
                  maxiter, block)


# ----------------------------------------------------------------------
# Sharded backward-Euler heat step
# ----------------------------------------------------------------------

def _same(v):
    return v


def build_sharded_heat_step(mesh_geo: StructuredMesh, mesh_dev: ShardMesh,
                            diffusivity: float, dt: float,
                            bc: DirichletBC, dtype=torch.float32,
                            tol: float = 1e-7, maxiter: int = 500):
    """One implicit heat step sharded over ``mesh_dev`` (1-D; the node
    count along x must divide by the shards).

    Returns (step_fn, inputs): ``step_fn(u, *inputs)`` performs
    u ← (M + dt K)⁻¹ (M u + dt b) with halo-exchange applies and sharded
    Jacobi-PCG (:func:`sharded_pcg`: a device program kept, with the
    Jacobi diagonal, per operands passed) on the free rows
    (:func:`~pde_solver_tpu_torch.ops.timestepping.free_rows_step`), and
    returns (u on the first shard's device, iterations, the relres over
    the free rows).  Assembly happens once on the host; the weights are
    sharded along grid axis 0 like the state."""
    K = assembly.assemble_scalar_stencil(mesh_geo, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh_geo, "mass")
    offsets = tuple(sorted(set(K) | set(M)))
    A_w = tuple(shard(np.asarray(M.get(o, 0.0) + dt * diffusivity
                                 * K.get(o, 0.0)), mesh_dev, dtype)
                for o in offsets)
    M_w = tuple(shard(np.asarray(M.get(o, np.zeros(mesh_geo.node_shape))),
                      mesh_dev, dtype) for o in offsets)
    free_np = np.asarray(bc.free_mask, np.float64)
    free = shard(free_np, mesh_dev, dtype)
    gvals = shard(np.asarray(bc.values, np.float64) * (1.0 - free_np),
                  mesh_dev, dtype)
    zero = offsets.index(tuple(0 for _ in range(mesh_geo.dim)))
    # per operands (A_w, free): the PCG's program store, its operator and
    # Jacobi diagonal, which a captured program reads where they lie
    solvers = {}

    def solver(A_w, free):
        key = (id(A_w), id(free))
        if key not in solvers:
            not_free = 1.0 - free

            def apply_c(x):
                xf = x * free
                return (local_stencil_apply(offsets, A_w, xf) * free
                        + (x - xf))

            diag = A_w[zero] * free + not_free
            solvers[key] = (device_loop.GraphStore(), apply_c,
                            diag.map(lambda t: 1.0 / _nonzero(t)),
                            (A_w, free))
        return solvers[key][:3]

    def step(u, A_w, M_w, free, gvals):
        u = shard(u, mesh_dev, dtype)
        store, apply_c, inv_diag = solver(A_w, free)
        rhs = local_stencil_apply(offsets, M_w, u)
        Ag = local_stencil_apply(offsets, A_w, gvals)
        x, iters, relres = free_rows_step(
            (_same,) * 3, free, rhs - Ag, gvals, u,
            lambda b, x0: sharded_pcg(apply_c, b, inv_diag, tol=tol,
                                      maxiter=maxiter, x0=x0, store=store))
        return gather(x), iters, relres

    return step, (A_w, M_w, free, gvals)


# ----------------------------------------------------------------------
# The sharded static solve: CG on a prepared scaled system (any vdim)
# ----------------------------------------------------------------------
#
# ``ops.linsolve.solve_stencil_system`` routes here when
# ``SolverConfig.shard_devices > 1`` and no hierarchy is built: the scaled
# stencil system (masking and (block-)diagonal scaling baked in, identity
# diagonal) is cut along grid axis 0 (and 1), weights like the state.
# Extents that do not divide are padded with identity rows (zero
# couplings, zero right side: the padding stays exactly zero through CG).

def _pad0(arr: np.ndarray, rows: int) -> np.ndarray:
    if rows == 0:
        return np.asarray(arr)
    pad = [(0, rows)] + [(0, 0)] * (np.ndim(arr) - 1)
    return np.pad(np.asarray(arr), pad)


def _pad_grid(arr, pads: Tuple[int, ...]):
    """Zero-pad the leading grid axes of a numpy array or a tensor by
    ``pads`` trailing rows each."""
    if isinstance(arr, torch.Tensor):
        if not any(pads):
            return arr
        out = arr.new_zeros([s + p for s, p in zip(arr.shape, pads)]
                            + list(arr.shape[len(pads):]))
        out[tuple(slice(0, s) for s in arr.shape[:len(pads)])] = arr
        return out
    if not any(pads):
        return np.asarray(arr)
    pad = [(0, p) for p in pads] + [(0, 0)] * (np.ndim(arr) - len(pads))
    return np.pad(np.asarray(arr), pad)


def _true_relres(apply_A, b: Sharded, x: Sharded) -> float:
    """‖b − A x‖ / ‖b‖ over the shards (one more apply)."""
    r = b - apply_A(x)
    bnorm2 = float(pdot(b, b))
    return math.sqrt(float(pdot(r, r)) / (bnorm2 if bnorm2 > 0 else 1.0))


class ShardedScaledCG:
    """CG on a prepared :class:`~pde_solver_tpu_torch.ops.linsolve.
    ScaledSystem`, decomposed over ``mesh_dev``: grid axis 0 over a 1-D
    mesh, or grid axes 0 and 1 over an a×b mesh (``device_mesh(shape=
    (a, b))``).  Build once per (system, mesh); :meth:`solve` many
    times (its device program is kept with the object)."""

    def __init__(self, sysm, grid_dim: int, vdim: int, mesh_dev: ShardMesh,
                 dtype=torch.float32):
        self.grid_dim = grid_dim
        self.vdim = vdim
        self.mesh_dev = mesh_dev
        self.offsets = sysm.offsets
        self.dtype = dtype
        n_axes = len(mesh_dev.shape)
        if n_axes >= 2 and grid_dim < 2:
            raise ValueError("2-D decomposition needs grid_dim >= 2")
        # pad every decomposed grid axis to a multiple of its mesh extent
        # with identity rows
        self.ns = tuple(int(s) for s in np.shape(sysm.free)[:n_axes])
        self.pads = tuple((-n) % m for n, m in zip(self.ns, mesh_dev.shape))
        zero_off = tuple(0 for _ in range(grid_dim))
        eye = 1.0 if vdim == 1 else np.eye(vdim)
        weights = []
        for off, W in zip(sysm.offsets, sysm.weights):
            Wp = _pad_grid(W, self.pads)
            if off == zero_off:
                for ax, (n, p) in enumerate(zip(self.ns, self.pads)):
                    if p:
                        Wp[(slice(None),) * ax + (slice(n, None),)] = eye
            weights.append(shard(Wp, mesh_dev, dtype))
        self.weights = tuple(weights)
        self.b_hat = self._grid_put(sysm.b_hat)

    def _grid_put(self, arr) -> Sharded:
        return shard(_pad_grid(arr, self.pads), self.mesh_dev, self.dtype)

    def apply(self, x: Sharded) -> Sharded:
        return local_stencil_apply(self.offsets, self.weights, x, self.vdim)

    def solve(self, b_hat=None, x0=None, tol: float = 1e-8,
              maxiter: int = 2000):
        """(x̂ on the first shard's device, iterations, relres of the
        recurrence)."""
        b = self.b_hat if b_hat is None else self._grid_put(b_hat)
        x0 = b.zeros_like() if x0 is None else self._grid_put(x0)
        x, iters, relres = sharded_pcg(self.apply, b, None, tol=tol,
                                       maxiter=maxiter, x0=x0,
                                       store=device_loop.store_of(self))
        unpad = tuple(slice(0, n) for n in self.ns)
        return gather(x)[unpad], iters, relres

    def relres(self, x_hat, b_hat=None) -> float:
        """The true relative residual of x̂ (default right side b̂)."""
        b = self.b_hat if b_hat is None else self._grid_put(b_hat)
        return _true_relres(self.apply, b, self._grid_put(x_hat))


def build_sharded_elasticity_solve(mesh_geo: StructuredMesh,
                                   mesh_dev: ShardMesh, lam: float,
                                   mu: float, body_force, bc: DirichletBC,
                                   dtype=torch.float32):
    """Static 3D elasticity as a domain-decomposed scaled CG (the
    block-Cholesky-scaled system of ``ops.linsolve``).  Returns
    (sharded_cg, sysm): solve with ``sharded_cg.solve()``, map back with
    ``sysm.from_hat_x``."""
    from pde_solver_tpu_torch.ops.linsolve import prepare_system

    K = assembly.assemble_elasticity_stencil(mesh_geo, lam, mu)
    b = assembly.assemble_vector_load(mesh_geo, np.asarray(body_force))
    sysm = prepare_system(K, mesh_geo, bc, b, mesh_geo.dim)
    return ShardedScaledCG(sysm, mesh_geo.dim, mesh_geo.dim, mesh_dev,
                           dtype=dtype), sysm


# ----------------------------------------------------------------------
# Sharded time stepping: the θ-scheme and Newmark-β scans
# ----------------------------------------------------------------------
#
# The step loops of ``ops.timestepping`` with every grid array cut along
# axis 0 over a 1-D mesh (identity-row padding), halo-exchange applies and
# sharded CG step solves.  MG step solves are not composed here, as in
# the JAX package: warm-started CG takes a handful of iterations a step.
# Each scan runs through ``device_loop.run_scan`` as the unsharded scans
# do: one step program a step (its step solve the sharded PCG inlined at
# a budget), one read a chunk of steps (``HOST_READS["shard_scan"]``),
# the carry the shards' parts.  A scan object is built once per
# (system, mesh) and kept across calls by ``ops.timestepping``'s scan
# cache: its per-call values (``values``) are buffers a call copies into.

def _pad_id_rows(arr: np.ndarray, rows: int, identity: bool, vdim: int):
    out = _pad0(np.asarray(arr), rows)
    if rows and identity:
        out[-rows:] = 1.0 if vdim == 1 else np.eye(vdim, dtype=out.dtype)
    return out


def padder(nx: int, vdim: int, mesh_dev: ShardMesh, dtype):
    """``pad(a, identity=False)``: a grid array with ``nx`` planes along
    axis 0, padded to a multiple of the shard count (identity rows with
    ``identity``, else zeros) and sharded over ``mesh_dev``."""
    if len(mesh_dev.shape) != 1:
        raise ValueError("the sharded scans cut grid axis 0 only "
                         "(a 1-D mesh)")
    n_pad = (-nx) % mesh_dev.size

    def pad(a, identity: bool = False) -> Sharded:
        return shard(_pad_id_rows(a, n_pad, identity, vdim), mesh_dev,
                     dtype)
    return pad


class _ScanOperands:
    """What the sharded scans share: the mesh, the padding of axis 0, the
    scaled implicit operator and the scale changes, on the shards."""

    def __init__(self, sysm, nx: int, grid_dim: int, vdim: int,
                 mesh_dev: ShardMesh, dtype):
        self.pad = padder(nx, vdim, mesh_dev, dtype)
        self.grid_dim, self.vdim = grid_dim, vdim
        self.mesh_dev = mesh_dev
        self.offsets = sysm.offsets
        self.dtype = dtype
        self.nx = nx
        self.n_pad = (-nx) % mesh_dev.size
        zero_off = tuple(0 for _ in range(grid_dim))
        self.A_w = tuple(self.pad(W, identity=(off == zero_off))
                         for off, W in zip(sysm.offsets, sysm.weights))
        if sysm.scale_kind == "scalar":
            s = _pad0(np.asarray(sysm.s), self.n_pad)
            if self.n_pad:
                s[-self.n_pad:] = 1.0
            parts = [(p, None, None) for p in shard(s, mesh_dev, dtype).parts]
        else:
            Ct = self.pad(sysm.Ct, identity=True)
            CinvT = self.pad(sysm.CinvT, identity=True)
            parts = [(None, c, ci) for c, ci in zip(Ct.parts, CinvT.parts)]
        ops = [_make_scale_ops(*p) for p in parts]
        # (to_hat_b, to_hat_x, from_hat_x), each block with its own scales
        self.scale_ops = tuple(
            (lambda x, i=i: Sharded([op[i](p) for op, p in zip(ops,
                                                               x.parts)],
                                    x.mesh))
            for i in range(3))

    def apply(self, weights, x: Sharded) -> Sharded:
        return local_stencil_apply(self.offsets, weights, x, self.vdim)

    def A(self, x: Sharded) -> Sharded:
        return self.apply(self.A_w, x)

    def frames(self, num_steps: int, x: Sharded) -> list:
        """Per-shard storage of ``num_steps`` kept states."""
        return [p.new_empty((num_steps,) + tuple(p.shape)) for p in x.parts]

    def fetch(self, frames) -> torch.Tensor:
        """The kept states on the host, padding stripped."""
        return torch.cat([f.cpu() for f in frames], 1)[:, :self.nx]


class _ShardedScan:
    """The part both sharded scans share: their operands, the step
    programs' store and the run through ``device_loop.run_scan``."""

    def __init__(self, sysm, grid_dim: int, vdim: int, mesh_dev: ShardMesh,
                 dtype, inner_tol: float, maxiter: int, nx: int):
        self.ops = _ScanOperands(sysm, nx, grid_dim, vdim, mesh_dev, dtype)
        self.inner_tol = inner_tol
        self.maxiter = maxiter
        self.graphs = device_loop.GraphStore()

    def _scan(self, kind: str, step, carry: tuple, num_steps: int,
              kept: tuple):
        """``num_steps`` steps from ``carry`` (Sharded values), keeping
        the carry entries at the indices ``kept`` after every step;
        returns (the final carry's parts, a frame list per kept entry, the
        tally)."""
        ops, n = self.ops, self.ops.mesh_dev.size
        frames = [ops.frames(num_steps, carry[i]) for i in kept]

        def per_step(b, x0):
            return sharded_pcg(ops.A, b, None, self.inner_tol, self.maxiter,
                               x0, store=self.graphs, block=STEP_BLOCK)

        def flat_step(c, step_n, solve):
            parts = [Sharded(c[i * n:(i + 1) * n], ops.mesh_dev)
                     for i in range(len(c) // n)]
            new, k, relres = step(parts, step_n, solve)
            return _flatten(new), k, relres

        def keep(j, c):
            for fs, i in zip(frames, kept):
                for f, p in zip(fs, c[i * n:(i + 1) * n]):
                    f[j].copy_(p)

        c, tally = device_loop.run_scan(
            self.graphs, ("shard_scan", kind), flat_step,
            _pcg_program(ops.A), per_step, _flatten(carry), self.inner_tol,
            self.maxiter, 0, num_steps, keep, True,
            capture=captures(ops.mesh_dev))
        return c, frames, tally


class ShardedThetaScan(_ShardedScan):
    """Sharded θ-scheme stepping on a prepared ScaledSystem.

    Build once per (system, mesh) with this call's padded values (the
    explicit operator ``B_w``, ``free``, the lift ``g`` / ``Ag``, the
    source ``b_src``; ``C_w`` (CNAB2, pre-scaled by Δt) adds the previous
    state to the carry; ``tmod`` = (b1, g1, Ag1, table [steps, 2] on the
    first shard's device) drives sinusoidally, as the port's unsharded
    scan does); :meth:`run` returns (snapshots, the scan's
    ``device_loop.ScanTally``)."""

    values = ("B_w", "free", "g", "Ag", "b_src", "C_w", "tmod")

    def __init__(self, sysm, grid_dim: int, vdim: int, mesh_dev: ShardMesh,
                 dtype=torch.float32, inner_tol: float = 1e-6,
                 maxiter: int = 500, *, B_w, free, g, Ag, b_src, C_w=None,
                 tmod=None):
        super().__init__(sysm, grid_dim, vdim, mesh_dev, dtype, inner_tol,
                         maxiter, np.shape(sysm.free)[0])
        self.B_w, self.free, self.g, self.Ag = B_w, free, g, Ag
        self.b_src, self.C_w, self.tmod = b_src, C_w, tmod

    def run(self, u0_np, num_steps: int):
        ops = self.ops
        cnab2 = self.C_w is not None

        def step(c, n, solve):
            u_prev, u = c[0], c[-1]
            rhs = ops.apply(self.B_w, u) + self.b_src
            Ag_t, g_t = self.Ag, self.g
            if self.tmod is not None:
                b1, g1, Ag1, table = self.tmod
                w = _row(table, n)
                if b1 is not None:
                    rhs = rhs + b1 * w[0]
                if g1 is not None:
                    Ag_t, g_t = self.Ag + Ag1 * w[1], self.g + g1 * w[1]
            if cnab2:
                rhs = rhs - (ops.apply(self.C_w, u) * 1.5
                             - ops.apply(self.C_w, u_prev) * 0.5)
            u_new, k, relres = free_rows_step(ops.scale_ops, self.free,
                                              rhs - Ag_t, g_t, u, solve)
            return ((u, u_new) if cnab2 else (u_new,)), k, relres

        u = ops.pad(u0_np)
        _, frames, tally = self._scan("theta", step,
                                      (u, u) if cnab2 else (u,), num_steps,
                                      (1 if cnab2 else 0,))
        return ops.fetch(frames[0]), tally


class ShardedNewmarkScan(_ShardedScan):
    """Sharded Newmark-β stepping on a prepared ScaledSystem of
    A_eff = M + βΔt²K, the vector counterpart of :class:`ShardedThetaScan`
    (values: the unscaled ``K_w``, ``free``, ``f_ext``, padded).
    :meth:`run` returns (us, vs, the tally)."""

    values = ("K_w", "free", "f_ext")

    def __init__(self, sysm, grid_dim: int, vdim: int, mesh_dev: ShardMesh,
                 dt: float, beta: float, gamma: float, dtype=torch.float32,
                 inner_tol: float = 1e-6, maxiter: int = 500, *, K_w, free,
                 f_ext):
        super().__init__(sysm, grid_dim, vdim, mesh_dev, dtype, inner_tol,
                         maxiter, np.shape(sysm.free)[0])
        self.dt, self.beta, self.gamma = float(dt), float(beta), float(gamma)
        self.K_w, self.free, self.f_ext = K_w, free, f_ext

    def run(self, u0_np, v0_np, a0_np, num_steps: int):
        ops = self.ops
        to_hat_b, to_hat_x, from_hat_x = ops.scale_ops
        dt, gamma = self.dt, self.gamma
        c1 = dt * dt * (0.5 - self.beta)
        c2 = self.beta * dt * dt

        def step(c, n, solve):
            u, v, a = c
            u_pred = u + v * dt + a * c1
            bt = self.free * (self.f_ext - ops.apply(self.K_w, u_pred))
            xh, k, relres = solve(to_hat_b(bt), to_hat_x(a))
            a_new = self.free * from_hat_x(xh)
            return ((u_pred + a_new * c2,
                     v + (a * (1.0 - gamma) + a_new * gamma) * dt, a_new),
                    k, relres)

        u, v, a = ops.pad(u0_np), ops.pad(v0_np), ops.pad(a0_np)
        _, (us, vs), tally = self._scan("newmark", step, (u, v, a),
                                        num_steps, (0, 1))
        return ops.fetch(us), ops.fetch(vs), tally
