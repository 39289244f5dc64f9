"""Implicit θ-scheme and Newmark-β time stepping, eager torch.

Counterpart of ``pde_solver_tpu.ops.timestepping`` (``run_transient`` with
its plain and snapshot-thinned scans, and ``run_newmark``) on one device:

    (M + θ Δt K) u^{n+1} = (M − (1−θ) Δt K) u^n + Δt b

θ=1 is backward Euler, θ=1/2 Crank-Nicolson.  The implicit operator gets
Dirichlet masking and symmetric Jacobi scaling baked into its weights on
the host (``ops.linsolve.prepare_system``); each step solves the scaled
unit-diagonal system from a warm start — by MG-PCG when the system has at
least ``resolved_transient_mg_threshold()`` DOF and a level builder, else
by plain CG on the flat operator (dense, or constant-interior with
``PDE_TPU_CS``).  The reference's ``lax.scan`` becomes a step program
(``ops.device_loop.StepLoop``): the step's body, its step solve as a fixed
budget of masked iterations and the carry update, captured once on the
card and replayed once a step with no read.  A trajectory's first step is
solved on its own (a device loop with a read a block) and sets the budget,
the rung of ``device_loop.STEP_BUDGETS`` one block above its count, unless
the scan's programs learned it in an earlier call; the host reads the
iterations, the worst relres and an overflow count once every
``SCAN_CHUNK`` steps after it, and sets the budget for the next chunk at
the rung above the worst step read (``device_loop.step_budget``); a chunk
after one whose worst step passed the cap runs step by step.  A chunk in
which a step outran the budget runs again step by step from the carry it
started with and is counted as a rerun.  The operands, the hierarchy and
the step programs (one a budget, in the operands' ``graphs`` store) are
kept across calls in ``_SCAN_CACHE``, keyed by the operator's content, as
``jax.jit`` keeps the JAX package's compiled scans: a follow-up with the
same operator copies its values into the kept buffers and replays the
kept programs, capturing only a budget wider than any kept.  The kept
frames are copied on the device after their step and come back to the
host once, whole.

Like the reference, "mixed" precision runs the scan in float32 (implicit
stepping is contractive and every step is solved to
``transient_inner_tol``, no tighter than ``F32_TOL_FLOOR``, from a warm
start); "f64" runs a float64 state on float64 weight tensors (plain
shifted slices, as the JAX package's float64 scans) and solves every step
to ``cfg.tol``, with float64 kept frames.  Unlike the reference, a step
stops on the relative residual of its free rows (:func:`free_rows_step`):
its right side carries the Dirichlet values on the constrained rows,
which with faces at tens of degrees fill its norm, and a step stopped
on that norm does next to no work.  The reference's step body also has
a "mixed" mode (float32 corrections with ``transient_refine_rounds``
float64 refinement rounds) that its ``run_transient`` never selects; the
port leaves it out, so that knob is inert here as it is there.
Sinusoidal driving
(``time_mod``) and explicit IMEX convection (``C_np``, folded into the
explicit operator for "ab1" or extrapolated by Adams-Bashforth-2 for
"cnab2") are operands of the same step.  ``transient_checkpoint_every > 0``
chunks either scan with atomic checkpoints in ``checkpoint_dir`` (content
keyed as in the reference; a resume is bitwise the uninterrupted run).
``SolverConfig.shard_devices > 1`` runs either scan sharded
(``parallel.shard.ShardedThetaScan`` / ``ShardedNewmarkScan``: grid axis 0
cut over a mesh of shard devices, CG step solves, every step kept, step
programs as here and kept alike; no checkpoints there, as in the JAX
package).  The reference thins large
trajectory pulls to bfloat16 frames for its slow host link; the port
pulls everything at the kept frames' precision (ROADMAP queue 3).

:func:`run_newmark` integrates M ü + K u = f (elastodynamics, the scalar
wave equation) in acceleration form:

    ũ       = uₙ + Δt vₙ + Δt² (½ − β) aₙ             (predictor)
    A_eff a = free ⊙ (f − K ũ),  A_eff = M + β Δt² K  (scaled step solve)
    uₙ₊₁   = ũ + β Δt² aₙ₊₁
    vₙ₊₁   = vₙ + Δt ((1 − γ) aₙ + γ aₙ₊₁)

β = ¼, γ = ½ (average acceleration) is unconditionally stable and conserves
the discrete energy ½ vᵀMv + ½ uᵀKu for f = 0 in exact arithmetic.
Dirichlet nodes keep u = g with v = a = 0: A_eff's masked rows are identity
with a zero right side there.
"""

from __future__ import annotations

import hashlib
import math
import os
import tempfile
import zipfile
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from pde_solver_tpu_torch.config import SolverConfig, get_config
from pde_solver_tpu_torch.mesh import StructuredMesh
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.ops import device_loop
from pde_solver_tpu_torch.ops.linsolve import (F32_TOL_FLOOR, STEP_BLOCK,
                                               _cg_program, _cg_unit_diag,
                                               _mg_cache_key, _static_flat_op,
                                               _stencil_apply,
                                               np_stencil_apply,
                                               prepare_system)
from pde_solver_tpu_torch.ops.stencil_kernels import (FlatStencilOperator,
                                                      kernel_wins)
from pde_solver_tpu_torch.utils import observability as obs
from pde_solver_tpu_torch.utils.kept import Kept
from pde_solver_tpu_torch.utils.observability import get_logger


class TransientResult(NamedTuple):
    values: np.ndarray        # [frames, *node_shape(, v)] float64 — u0 first
    times: np.ndarray         # [frames]
    total_cg_iterations: int
    max_relative_residual: float
    # the call's spans (observability): "scan.setup", the host system
    # prep, MG hierarchy and staging; "scan", the stepping loop
    # (throughput = num_steps / scan_seconds); "solve.fetch", the
    # trajectory device → host
    setup_seconds: float = 0.0
    scan_seconds: float = 0.0
    fetch_seconds: float = 0.0
    scan_reruns: int = 0        # chunks run again step by step (a step
                                # outran the step program's budget)
    scan_stepwise_chunks: int = 0   # chunks run step by step with no
                                    # budget (the first step; after a
                                    # step past the budget's cap)
    scan_past_iterations: int = 0   # masked iterations the step programs
                                    # ran past their step's convergence
    scan_programs_built: int = 0    # step programs made (captured on the
                                    # card) by this call
    scan_capture_seconds: float = 0.0   # warming up and capturing them
    scan_kept: bool = False     # the operands, hierarchy and step programs
                                # came from the scan cache (_SCAN_CACHE)


def _tallied(tally: device_loop.ScanTally, kept: bool) -> Dict:
    """A result's fields from its scans' tally."""
    return dict(total_cg_iterations=tally.iterations,
                max_relative_residual=tally.relres,
                scan_reruns=tally.reruns,
                scan_stepwise_chunks=tally.stepwise,
                scan_past_iterations=tally.past,
                scan_programs_built=tally.built,
                scan_capture_seconds=tally.capture_seconds,
                scan_kept=kept)


# What a tool reports of its scan besides its request's spans (a
# TransientResult's or a NewmarkResult's fields): the step programs'
# tallies.  The seconds of its set-up, stepping, fetch and captures are
# those of the spans "scan.setup", "scan", "solve.fetch" and "capture".
SCAN_STATS = ("scan_programs_built", "scan_kept", "scan_reruns",
              "scan_stepwise_chunks", "scan_past_iterations")


def scan_stats(res) -> Dict:
    """The :data:`SCAN_STATS` of a scan's result, for a tool's stats."""
    return {k: getattr(res, k) for k in SCAN_STATS}


def _combine(K: Dict, M: Dict, alpha: float, beta: float) -> Dict:
    """beta*M + alpha*K as a numpy stencil."""
    out = {}
    for o, W in M.items():
        out[o] = beta * np.asarray(W, dtype=np.float64)
    for o, W in K.items():
        out[o] = out.get(o, 0.0) + alpha * np.asarray(W, dtype=np.float64)
    return out


def _make_scale_ops(s, Ct, CinvT):
    """Scaled-system coordinate changes, scalar (s) or block (Ct/CinvT).

    Scalar Jacobi: Â = S A S with S = diag(s) ⇒ b̂ = S b, x̂ = x/s, x = S x̂.
    Block Cholesky: Â = C⁻¹ A C⁻ᵀ ⇒ b̂ = C⁻¹ b, x̂ = Cᵀ x, x = C⁻ᵀ x̂.
    Per-node blocks multiply as broadcast + sum (no batched GEMM)."""
    if s is not None:
        return (lambda v: s * v), (lambda v: v / s), (lambda v: s * v)

    def to_hat_b(v):
        return (CinvT * v[..., :, None]).sum(-2)

    def to_hat_x(v):
        return (Ct * v[..., None, :]).sum(-1)

    def from_hat_x(v):
        return (CinvT * v[..., None, :]).sum(-1)

    return to_hat_b, to_hat_x, from_hat_x


def _snapshot_every(cfg: SolverConfig, num_steps: int, snap_bytes: int) -> int:
    """Keep every k-th frame: under ``snapshot_max_frames``, or when the
    whole trajectory would exceed ``snapshot_budget_bytes`` (the
    reference's rule)."""
    if cfg.snapshot_max_frames > 0:
        return max(1, -(-int(num_steps) // cfg.snapshot_max_frames))
    if num_steps * snap_bytes > cfg.snapshot_budget_bytes:
        return -(-(num_steps * snap_bytes) // cfg.snapshot_budget_bytes)
    return 1


# ----------------------------------------------------------------------
# Scan operands kept across calls
# ----------------------------------------------------------------------
#
# The counterpart of ``jax.jit``'s cache on the JAX package's
# ``_transient_scan`` / ``_newmark_scan``: a later call with the same
# operator replays the step programs the first one captured.  A captured
# graph replays the values baked into its launches (each level's ω and the
# Chebyshev constants drawn from it, the CS kernel's term lists, every
# launch's shape and offsets) as well as the addresses it read, so an
# entry keys on the operator's content, not on its structure alone: the
# scaled, masked weights, free mask and scales (or the prepared system's
# content key), the offsets, node shape, vdim, precision, routing and
# device, and the scan's own constants.  The hierarchy is a deterministic
# function of that key, so a hit keeps it with the step operands (static
# device buffers) and the :class:`~device_loop.ScanPrograms` in the
# operands' ``graphs`` store, and copies each call's values (Dirichlet
# values and their lift, sources, the explicit operators, the driving and
# its table) into the kept buffers, as ``device_loop.solve`` copies b and
# x0.  θ scans and Newmark scans key apart, each an LRU of two entries;
# an entry that leaves releases its graphs and its hierarchy's.

def _release(entry) -> None:
    """Free the graphs of a scan cache entry and of its hierarchy."""
    device_loop.release(entry)
    device_loop.release(getattr(entry, "h", None))


_SCAN_CACHE = {"theta": Kept(2, _release), "newmark": Kept(2, _release)}


def _scan_key(kind: str, mesh: StructuredMesh, vdim: int, prec: str, sysm,
              device, consts: tuple) -> tuple:
    """The cache key of a scan of the prepared implicit system ``sysm``:
    its content (``sysm.ckey`` when the system has one, else a hash of
    the scaled weights, free mask and scales), its shape and routing,
    and ``consts``, what else the step programs bake in."""
    arrays = [a for a in list(sysm.weights) + [sysm.free, sysm.s, sysm.Ct,
                                               sysm.CinvT] if a is not None]
    return ((kind,) + _mg_cache_key(mesh, vdim, prec, sysm, device, arrays)
            + tuple(consts))


def _copy_into(dst, src) -> None:
    """Copy a call's values into kept buffers of the same structure
    (tensors, tuples of them, None, or values with ``parts``)."""
    if src is None:
        return
    if isinstance(src, tuple):
        for d, t in zip(dst, src):
            _copy_into(d, t)
    elif hasattr(src, "parts"):
        _copy_into(tuple(dst.parts), tuple(src.parts))
    else:
        dst.copy_(src)


def _kept(kind: str, key, values: Dict, build):
    """The cached entry of ``key`` with this call's ``values`` copied into
    its buffers, or ``build(values)`` stored under ``key``.  Returns
    (entry, whether it was kept)."""
    entry = _SCAN_CACHE[kind].get(key)
    if entry is None:
        entry = build(values)
        _SCAN_CACHE[kind].put(key, entry)
        return entry, False
    for name, v in values.items():
        _copy_into(getattr(entry, name), v)
    return entry, True


class _StepOperands(NamedTuple):
    """Everything one implicit θ-step reads, on the device in the state's
    dtype (``A32`` float32, ``A64`` float64; either may be None when the
    step mode does not read it)."""

    offsets: tuple
    A32: object                # flat operator or f32 tensors (f32)
    A64: Optional[tuple]       # f64 tensors (f64)
    B_w: tuple                 # unmasked explicit-side operator
    free: torch.Tensor
    g: torch.Tensor            # Dirichlet values
    Ag: torch.Tensor           # their lift A·g
    b_src: torch.Tensor        # Δt·b
    scale_ops: tuple           # (to_hat_b, to_hat_x, from_hat_x)
    C_w: Optional[tuple]       # Δt·C for CNAB2, else None
    tmod: Optional[tuple]      # (b1, g1, Ag1, table [steps, 2])
    inner_tol: float
    maxiter: int
    grid_dim: int
    vdim: int
    h: object = None           # MG hierarchy of the implicit operator
    graphs: object = None      # the scan's step programs, and the CG
                               # step solve's captured loops


def _sinusoid_table(omega: float, phase: float, dt: float, theta: float,
                    num_steps: int) -> np.ndarray:
    """Per step n the driving's weights [θ s(t_{n+1}) + (1−θ) s(t_n),
    s(t_{n+1})], s(t) = sin(ωt + φ), in float64 on the host (the reference
    evaluates them in the state's dtype)."""
    steps = range(int(num_steps))
    s_n = np.array([math.sin(omega * (k * dt) + phase) for k in steps])
    s_np1 = np.array([math.sin(omega * (k * dt + dt) + phase)
                      for k in steps])
    return np.stack([theta * s_np1 + (1.0 - theta) * s_n, s_np1], axis=1)


def _row(table: torch.Tensor, n) -> torch.Tensor:
    """Row ``n`` of a per-step table: ``n`` a host integer, or the step
    program's device step counter (read on the device, no sync)."""
    if torch.is_tensor(n):
        return table.index_select(0, n.reshape(1))[0]
    return table[n]


def _step_solvers(ops, A):
    """(per-step solve, masked loop) of a scan's step solve: MG-PCG on
    ``ops.h``, else CG on ``A``.  The per-step solve runs its device loop
    in blocks of ``STEP_BLOCK`` with a read a block; the masked loop is
    what a step program inlines."""
    if ops.h is not None:
        from pde_solver_tpu_torch.ops import multigrid as mg

        def per_step(b, x0):
            # resync_every=0: warm-started step solves take a handful of
            # iterations and do not drift (the reference's choice)
            return mg.mg_pcg(ops.h, b, x0, ops.inner_tol, ops.maxiter,
                             resync_every=0)
        return per_step, mg._pcg_program(ops.h, 0)

    def per_step(b, x0):
        return _cg_unit_diag(ops.offsets, A, b, x0, ops.inner_tol,
                             ops.maxiter, ops.grid_dim, ops.vdim,
                             block=STEP_BLOCK, graphs=ops.graphs)
    return per_step, _cg_program(ops.offsets, A, ops.grid_dim, ops.vdim)


def _transient_step_body(ops: _StepOperands, mode: str, u, u_prev, n,
                         solve):
    """One implicit θ-step n → n+1 on the scaled system; returns
    (u_new, iterations, relres).  ``mode``: "f64" (CG on ``A64``) or "f32"
    (CG on ``A32``); with a hierarchy either mode solves by MG-PCG, through
    ``solve(b̂, x̂0)`` (one of :func:`_step_solvers`).  ``n`` is a host
    integer or the step program's device counter."""
    d, vdim, offsets = ops.grid_dim, ops.vdim, ops.offsets
    rhs = _stencil_apply(offsets, ops.B_w, u, d, vdim) + ops.b_src
    Ag_t, g_t = ops.Ag, ops.g
    if ops.tmod is not None:
        # b(t) enters the θ-scheme as Δt·[θ s(t_{n+1}) + (1−θ) s(t_n)]·b1;
        # Dirichlet data g(t) is enforced at the new time level, its lift
        # A·g(t) scaling with the same sinusoid (the weights: row n of the
        # table, :func:`_sinusoid_table`)
        b1, g1, Ag1, table = ops.tmod
        w = _row(table, n)
        if b1 is not None:
            rhs = rhs + w[0] * b1
        if g1 is not None:
            Ag_t, g_t = ops.Ag + w[1] * Ag1, ops.g + w[1] * g1
    if ops.C_w is not None:
        # CNAB2: Adams-Bashforth-2 extrapolation of the convection term
        # (C_w is pre-scaled by Δt); u_prev = u0 makes the first step AB1
        rhs = rhs - (1.5 * _stencil_apply(offsets, ops.C_w, u, d, vdim)
                     - 0.5 * _stencil_apply(offsets, ops.C_w, u_prev, d,
                                            vdim))
    return free_rows_step(ops.scale_ops, ops.free, rhs - Ag_t, g_t, u, solve)


def free_rows_step(scale_ops, free, rhs, g, u, solve):
    """A θ-step's solve on its free rows: returns (u_new, iterations,
    relres).  ``rhs`` is the step's right side less the lift A·g, ``g`` the
    Dirichlet values at the new time level (0 on free rows).  The scaled
    operator's constrained rows are identity rows decoupled from the free
    ones, so the solve takes b̂ and x̂0 zero there, where MG-PCG and CG
    leave them zero, and g is added back after: the Dirichlet rows hold g
    exactly, and the relative residual the step stops on is over the free
    rows, not over a norm that g fills."""
    to_hat_b, to_hat_x, from_hat_x = scale_ops
    xh, k, relres = solve(to_hat_b(free * rhs), to_hat_x(free * u))
    return from_hat_x(xh) + g, k, relres


def _transient_scan(ops: _StepOperands, mode: str, u, u_prev, step0: int,
                    num_steps: int, snap_every: int, snap_dtype,
                    start: bool = True):
    """``num_steps`` steps from global step ``step0`` through the step
    program (``device_loop.run_scan``; ``start``: they begin this call's
    trajectory), keeping the state after every ``snap_every``-th one.
    Returns (frames [num_steps // snap_every, ...] in ``snap_dtype``, u,
    u_prev, its ``device_loop.ScanTally``).  The
    carry is u, and (u_prev, u) for CNAB2, whose ``u_prev`` None seeds the
    history with u; the u_prev returned is None without CNAB2."""
    cnab2 = ops.C_w is not None
    carry = (u if u_prev is None else u_prev, u) if cnab2 else (u,)
    snaps = torch.empty((num_steps // snap_every,) + tuple(u.shape),
                        dtype=snap_dtype, device=u.device)

    def step(c, n, solve):
        u_new, k, relres = _transient_step_body(ops, mode, c[-1], c[0], n,
                                                solve)
        return ((c[-1], u_new) if cnab2 else (u_new,)), k, relres

    def keep(j, c):
        if (j + 1) % snap_every == 0:
            snaps[(j + 1) // snap_every - 1].copy_(c[-1])

    per_step, program = _step_solvers(
        ops, ops.A64 if mode == "f64" else ops.A32)
    c, tally = device_loop.run_scan(
        ops.graphs, ("scan", mode), step, program, per_step, carry,
        ops.inner_tol, ops.maxiter, step0, num_steps, keep, start)
    return snaps, c[-1], (c[0] if cnab2 else None), tally


def _frames(snaps: torch.Tensor) -> np.ndarray:
    return snaps.cpu().numpy().astype(np.float64)


def run_transient(
    K_np: Dict,
    M_np: Dict,
    mesh: StructuredMesh,
    bc: DirichletBC,
    b_source_np: np.ndarray,
    u0_np: np.ndarray,
    dt: float,
    num_steps: int,
    theta: float = 1.0,
    vdim: int = 1,
    config: Optional[SolverConfig] = None,
    mg_level_builder=None,
    C_np: Optional[Dict] = None,
    time_mod: Optional[Dict] = None,
    convection_scheme: str = "ab1",
) -> TransientResult:
    """``mg_level_builder(mesh_c) -> (K_c, M_c, bc_c)`` (optional) enables
    MG-PCG step solves: the implicit operator M + θΔtK is re-assembled per
    coarse level and each step runs a V-cycle-preconditioned CG.

    ``C_np`` (optional): a non-symmetric convection stencil applied
    explicitly (IMEX), so the implicit solve stays SPD.  Its offsets must
    be a subset of K∪M's (true for same-mesh P1 assembly).
    ``convection_scheme`` picks the explicit treatment:

    * ``"ab1"``: (M + θΔtK) u⁺ = (M − (1−θ)ΔtK − ΔtC) u + Δt b — C folds
      into the explicit-side operator, O(Δt) splitting.
    * ``"cnab2"``: (M + θΔtK) u⁺ = (M − (1−θ)ΔtK) u − Δt(3/2 C u − 1/2 C u⁻)
      + Δt b — O(Δt²) overall with θ=1/2.  The loop carries the previous
      state; the first step self-starts as AB1 (u⁻ = u⁰).

    ``time_mod`` (optional): sinusoidal driving.  Dict keys: ``omega``
    [rad/s], ``phase`` (default 0), ``source_amp`` (assembled load-vector
    amplitude b1: b(t) = b0 + sin(ωt+φ)·b1) and/or ``bc_amp_values``
    (node-shaped Dirichlet amplitude: g(t) = g0 + sin(ωt+φ)·g_amp on
    constrained DOFs).  The sinusoid is evaluated on the host in float64
    for every step (a table the step program reads at its step counter;
    the reference evaluates it in the float32 state type; the two differ
    by ~1e-7 relative).

    Precision: "f64" steps a float64 state with float64 weights to
    ``cfg.tol``; "f32" and "mixed" step a float32 state to
    ``transient_inner_tol`` (no tighter than ``F32_TOL_FLOOR``); either
    over the free rows.  ``transient_checkpoint_every > 0`` runs the
    checkpointed scan (:func:`_run_transient_checkpointed`)."""
    if convection_scheme not in ("ab1", "cnab2"):
        raise ValueError(f"unknown convection_scheme {convection_scheme!r}")
    cfg = config or get_config()
    prec = cfg.resolve_precision()
    if prec == "mixed":
        prec = "f32"   # the reference's rule: no f64 inside the scan
    if prec not in ("f32", "f64"):
        raise ValueError(f"unknown precision {prec!r}")
    with obs.span("scan.setup") as setup:   # what both paths share
        device = torch.device(cfg.device)
        state_dtype = torch.float64 if prec == "f64" else torch.float32
        d = mesh.dim
        n = int(np.prod(mesh.node_shape)) * vdim
        maxiter = cfg.resolved_maxiter(n)
        num_steps = int(num_steps)
        # the tolerance asked for names a checkpoint as the reference's
        # does; a float32 step stops no tighter than F32_TOL_FLOOR
        asked_tol = cfg.tol if prec == "f64" else cfg.transient_inner_tol
        inner_tol = (asked_tol if prec == "f64"
                     else max(asked_tol, F32_TOL_FLOOR))

        cnab2 = bool(C_np) and convection_scheme == "cnab2"
        A_np = _combine(K_np, M_np, alpha=theta * dt, beta=1.0)
        B_np = _combine(K_np, M_np, alpha=-(1.0 - theta) * dt, beta=1.0)
        if C_np and not cnab2:
            B_np = _combine(C_np, B_np, alpha=-dt, beta=1.0)
        # scaled, masked implicit operator (zero rhs: only the weights are
        # needed, the per-step lift uses the precomputed A g)
        sysm = prepare_system(A_np, mesh, bc, np.zeros(u0_np.shape), vdim)
        offsets, scaled, gvals = sysm.offsets, sysm.weights, sysm.gvals
        Ag_np = np_stencil_apply(A_np, gvals, d, vdim)
        free_np = np.asarray(bc.free_mask, dtype=np.float64)
        B_list = [np.asarray(B_np.get(o, np.zeros_like(scaled[i])), np.float64)
                  for i, o in enumerate(offsets)]
        C_list = None
        if cnab2:
            C_list = [dt * np.asarray(C_np.get(o, np.zeros_like(B_list[i])),
                                      np.float64)
                      for i, o in enumerate(offsets)]

        # sinusoidal-driving operands: b1 pre-scaled by dt, g1 restricted to
        # constrained DOFs with its matching lift A·g1
        b1_np = g1_np = Ag1_np = None
        if time_mod:
            if time_mod.get("source_amp") is not None:
                b1_np = dt * np.asarray(time_mod["source_amp"], np.float64)
            if time_mod.get("bc_amp_values") is not None:
                g1_np = (1.0 - free_np) * np.asarray(time_mod["bc_amp_values"],
                                                     np.float64)
                Ag1_np = np_stencil_apply(A_np, g1_np, d, vdim)
        nshard = cfg.resolved_shard_devices()
    if nshard > 1:
        # the whole scan decomposed over the shards (identity-row padding,
        # halo-exchange applies, sharded CG step solves); every step kept
        from pde_solver_tpu_torch.parallel.shard import (ShardedThetaScan,
                                                         device_mesh, padder)

        get_logger().info("sharded transient scan: %d devices, %d steps",
                          nshard, num_steps)
        if cfg.transient_checkpoint_every > 0:
            get_logger().warning(
                "transient_checkpoint_every=%d is not supported on the "
                "sharded scan path (shard_devices=%d) — running without "
                "mid-solve checkpoints", cfg.transient_checkpoint_every,
                nshard)
        with obs.span("scan.setup") as more:   # the sharded scan's
            mesh_dev = device_mesh(nshard, device=device)
            pad = padder(np.shape(free_np)[0], vdim, mesh_dev, state_dtype)
            values = dict(
                B_w=tuple(pad(W) for W in B_list), free=pad(free_np),
                g=pad(gvals), Ag=pad(Ag_np),
                b_src=pad(dt * np.asarray(b_source_np, np.float64)),
                C_w=None if C_list is None else tuple(pad(W) for W in C_list),
                tmod=None if not time_mod else tuple(
                    None if a is None else pad(a)
                    for a in (b1_np, g1_np, Ag1_np)) + (
                    torch.tensor(_sinusoid_table(
                        float(time_mod["omega"]),
                        float(time_mod.get("phase", 0.0)), float(dt),
                        float(theta), num_steps), dtype=state_dtype,
                        device=mesh_dev.devices[0]),))
            key = _scan_key("theta", mesh, vdim, prec, sysm, device, (
                state_dtype, float(dt), float(theta), float(inner_tol),
                int(maxiter), cnab2,
                None if not time_mod else (b1_np is not None,
                                           g1_np is not None, num_steps),
                "shard", tuple(str(x) for x in mesh_dev.devices)))
            scan, kept = _kept("theta", key, values,
                               lambda v: ShardedThetaScan(
                                   sysm, d, vdim, mesh_dev, dtype=state_dtype,
                                   inner_tol=inner_tol, maxiter=maxiter,
                                   **v))
            del values
        with obs.span("scan") as stepping:
            snaps, tally = scan.run(u0_np, num_steps)
        with obs.span("solve.fetch") as fetch:
            values = np.concatenate([np.asarray(u0_np, np.float64)[None],
                                     snaps.numpy().astype(np.float64)],
                                    axis=0)
        return TransientResult(
            values=values, times=dt * np.arange(num_steps + 1,
                                                dtype=np.float64),
            setup_seconds=setup.seconds + more.seconds,
            scan_seconds=stepping.seconds, fetch_seconds=fetch.seconds,
            **_tallied(tally, kept))

    use_mg = (mg_level_builder is not None and cfg.use_multigrid
              and n >= cfg.resolved_transient_mg_threshold())

    def dev(a):   # a copy: cached host arrays are read-only
        return torch.tensor(np.asarray(a), dtype=state_dtype, device=device)

    def build(values):
        h = None
        if use_mg:
            from pde_solver_tpu_torch.ops import multigrid as mg

            def A_builder(mesh_c):
                K_c, M_c, bc_c = mg_level_builder(mesh_c)
                return _combine(K_c, M_c, alpha=theta * dt, beta=1.0), bc_c

            h = mg.build_hierarchy(mesh, sysm, A_builder, vdim=vdim,
                                   device=device, dtype=state_dtype)
        # The reference builds the step operator on the MG branch too and
        # never reads it there; the port builds it only for the plain-CG
        # step
        A32 = A64 = None
        if h is None and prec == "f32":
            A32 = _static_flat_op(sysm, mesh, vdim, device) or tuple(
                dev(W) for W in scaled)
        elif h is None:
            A64 = tuple(dev(W) for W in scaled)
        if sysm.scale_kind == "scalar":
            scale_ops = _make_scale_ops(dev(sysm.s), None, None)
        else:
            scale_ops = _make_scale_ops(None, dev(sysm.Ct), dev(sysm.CinvT))
        return _StepOperands(
            offsets, A32, A64, scale_ops=scale_ops, inner_tol=inner_tol,
            maxiter=maxiter, grid_dim=d, vdim=vdim, h=h,
            graphs=device_loop.GraphStore(), **values)

    with obs.span("scan.setup") as more:   # the scan's own
        snap32 = cfg.snapshot_dtype == "f32" and prec != "f64"
        snap_dtype = torch.float32 if snap32 else state_dtype
        snap_every = _snapshot_every(
            cfg, num_steps, n * (4 if snap_dtype == torch.float32 else 8))
        # this call's values: copied into a kept entry's buffers on a hit
        values = dict(
            B_w=tuple(dev(W) for W in B_list), free=dev(free_np),
            g=dev(gvals), Ag=dev(Ag_np),
            b_src=dev(dt * np.asarray(b_source_np, np.float64)),
            C_w=None if C_list is None else tuple(dev(W) for W in C_list),
            tmod=None if not time_mod else tuple(
                None if a is None else dev(a)
                for a in (b1_np, g1_np, Ag1_np)) + (
                dev(_sinusoid_table(float(time_mod["omega"]),
                                    float(time_mod.get("phase", 0.0)),
                                    float(dt), float(theta), num_steps)),))
        # the driving's table is [num_steps, 2]: a driven scan keys on its
        # length, and on which of its parts are present
        key = _scan_key("theta", mesh, vdim, prec, sysm, device, (
            state_dtype, snap_dtype, float(dt), float(theta), float(inner_tol),
            int(maxiter), use_mg, cnab2,
            None if not time_mod else (b1_np is not None, g1_np is not None,
                                       num_steps)))

        ops, kept = _kept("theta", key, values, build)
        del values
        h = ops.h
        u = dev(u0_np)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    setup_s = setup.seconds + more.seconds

    if cfg.transient_checkpoint_every > 0:
        # The content key covers everything that determines the trajectory
        # (operators, lift, BC data, state, source, numerics), hashed from
        # the same float64 host arrays as the reference's, so both packages
        # name a case's file alike (the 0 stands for the reference's
        # refinement rounds, 0 at every precision its scan runs).  num_steps
        # is left out so a longer target continues a shorter or killed run.
        hsh = hashlib.blake2b(digest_size=12)
        hsh.update(repr((mesh.node_shape, vdim, float(dt), float(theta),
                         prec, float(asked_tol), 0, bool(snap32),
                         int(maxiter))).encode())
        for arr in ((u0_np, b_source_np, gvals, Ag_np, free_np)
                    + tuple(scaled) + tuple(B_list)):
            hsh.update(np.ascontiguousarray(np.asarray(arr, np.float64)))
        if time_mod:
            hsh.update(repr((float(time_mod["omega"]),
                             float(time_mod.get("phase", 0.0)))).encode())
            for key_m in ("source_amp", "bc_amp_values"):
                if time_mod.get(key_m) is not None:
                    hsh.update(np.ascontiguousarray(
                        np.asarray(time_mod[key_m], np.float64)))
        if cnab2:
            # AB1's C folds into B_list (hashed above); the CNAB2 history
            # scheme and its separate C operand must key distinctly
            hsh.update(b"cnab2")
            for arr in C_list:
                hsh.update(np.ascontiguousarray(arr))
        return _run_transient_checkpointed(
            ops, prec, u, num_steps, cfg, dt, u0_np, setup_s,
            hsh.hexdigest(), snap_every, snap_dtype, cnab2, kept)

    # the frames kept: every snap_every-th step, and the final state always
    with obs.span("scan") as stepping:
        main = (num_steps // snap_every) * snap_every
        snaps, u, u_prev, tally = _transient_scan(
            ops, prec, u, None, 0, main, snap_every, snap_dtype)
        times = [dt * snap_every * (j + 1) for j in range(main // snap_every)]
        last = None
        if main < num_steps:
            last, u, _, t2 = _transient_scan(
                ops, prec, u, u_prev, main, num_steps - main,
                num_steps - main, snap_dtype, start=main == 0)
            tally = tally.plus(t2)
            times.append(dt * num_steps)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    scan_s = stepping.seconds

    with obs.span("solve.fetch") as fetch:
        values = np.concatenate([np.asarray(u0_np, np.float64)[None],
                                 _frames(snaps)]
                                + ([] if last is None else [_frames(last)]),
                                axis=0)
    fetch_s = fetch.seconds
    get_logger().info("transient: %d steps, %d CG iterations, max relres "
                      "%.3e, setup %.3fs, scan %.3fs, fetch %.3fs (%d DOF, "
                      "%s, %s step solves; step programs: %s, %d built, %d "
                      "reruns, %d chunks step by step, %d masked iterations "
                      "past convergence, capture %.3fs)",
                      num_steps, tally.iterations, tally.relres, setup_s,
                      scan_s, fetch_s, n, prec,
                      "MG-PCG" if h is not None else "CG",
                      "kept" if kept else "new", tally.built, tally.reruns,
                      tally.stepwise, tally.past, tally.capture_seconds)
    return TransientResult(values=values,
                           times=np.asarray([0.0] + times, np.float64),
                           setup_seconds=setup_s, scan_seconds=scan_s,
                           fetch_seconds=fetch_s, **_tallied(tally, kept))


# ----------------------------------------------------------------------
# Checkpoint/resume for long scans
# ----------------------------------------------------------------------

_CKPT_TEST_ABORT = 0  # tests: raise after N chunk checkpoints (0 = off)
# what reading a truncated or foreign npz can raise: such a file is
# recomputed over, as the reference does
_UNREADABLE = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


def _save_checkpoint(cfg: SolverConfig, path: str, **arrays) -> None:
    """Atomic npz write: a temporary file in the checkpoint directory,
    renamed over ``path``."""
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=cfg.checkpoint_dir, suffix=".tmp.npz")
    os.close(fd)
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _host(t: torch.Tensor) -> np.ndarray:
    """A carry tensor on the host at its full precision."""
    return t.detach().cpu().numpy()


def _run_transient_checkpointed(ops: _StepOperands, prec: str, u0,
                                num_steps: int, cfg: SolverConfig, dt: float,
                                u0_np, setup_s: float, key: str,
                                snap_every: int, snap_dtype,
                                cnab2: bool, kept: bool) -> TransientResult:
    """Host-chunked scan with atomic carry + trajectory checkpoints.

    Every ``transient_checkpoint_every`` steps (rounded up to whole
    snapshot intervals, so every chunk boundary is a kept frame) the carry,
    at its full precision, and the kept frames persist to
    ``checkpoint_dir``.  A re-run of the same problem (content-keyed, not
    on num_steps) resumes from the last completed chunk; a checkpoint
    ahead of a shorter request is recomputed from step 0; on completion
    the file is removed.  Chunking does not change the per-step
    arithmetic: the trajectory is bitwise the uncheckpointed one.  Each
    stored frame carries its global step index, so a resume with another
    thinning cadence stays consistent."""
    dtype = u0.dtype
    every = max(int(cfg.transient_checkpoint_every), snap_every)
    every = -(-every // snap_every) * snap_every
    path = os.path.join(cfg.checkpoint_dir, f"transient-{key}.npz")

    def fresh():
        return ([np.asarray(u0_np, np.float64)[None]], [], 0, 0, 0.0, u0,
                None)

    frames, snap_steps, start, iters, res, u, u_prev = fresh()
    with obs.span("scan.checkpoint"):   # a resume reads it
        if os.path.exists(path):
            try:
                with np.load(path) as z:
                    snaps_prev = z["snaps"]
                    steps_prev = [int(t) for t in z["snap_steps"]]
                    start, iters, res = (int(z["step"]), int(z["iters"]),
                                         float(z["res"]))
                    u = torch.as_tensor(z["carry"], dtype=dtype,
                                        device=u0.device)
                    if "u_prev" in z.files:
                        u_prev = torch.as_tensor(z["u_prev"], dtype=dtype,
                                                 device=u0.device)
                if start > num_steps:
                    # the checkpoint is ahead of this (shorter) request: its
                    # carry cannot give u(num_steps)
                    get_logger().warning(
                        "transient checkpoint at step %d exceeds requested "
                        "num_steps=%d — recomputing from step 0", start,
                        num_steps)
                    frames, snap_steps, start, iters, res, u, u_prev = fresh()
                else:
                    frames.append(snaps_prev.astype(np.float64))
                    snap_steps.extend(steps_prev)
                    get_logger().info("transient resume: step %d/%d from %s",
                                      start, num_steps, path)
            except _UNREADABLE as e:
                get_logger().warning("unreadable checkpoint %s (%s) — "
                                     "recomputing from step 0", path, e)
                frames, snap_steps, start, iters, res, u, u_prev = fresh()
    tally = device_loop.ScanTally(iters, res)
    chunks_done = 0
    scan_s = fetch_s = 0.0
    main = start + ((num_steps - start) // snap_every) * snap_every
    while start < main:
        n = min(every, main - start)
        with obs.span("scan") as stepping:
            snaps, u, u_prev_f, t = _transient_scan(
                ops, prec, u, u_prev, start, n, snap_every, snap_dtype,
                start=chunks_done == 0)
        scan_s += stepping.seconds
        if cnab2:
            u_prev = u_prev_f
        tally = tally.plus(t)
        with obs.span("solve.fetch") as fetch:
            frames.append(_frames(snaps))
        fetch_s += fetch.seconds
        snap_steps.extend(start + snap_every * (j + 1)
                          for j in range(n // snap_every))
        start += n
        # the AB2 history rides along on CNAB2 runs, so resumes stay bitwise
        with obs.span("scan.checkpoint"):
            extra = {} if u_prev is None else {"u_prev": _host(u_prev)}
            _save_checkpoint(
                cfg, path, snaps=np.concatenate(frames[1:], axis=0).astype(
                    np.float32 if snap_dtype == torch.float32
                    else np.float64),
                snap_steps=np.asarray(snap_steps, np.int64), carry=_host(u),
                step=start, iters=tally.iterations, res=tally.relres,
                **extra)
        chunks_done += 1
        if _CKPT_TEST_ABORT and chunks_done >= _CKPT_TEST_ABORT \
                and start < num_steps:
            raise RuntimeError("checkpoint test abort")
    if start < num_steps:
        # the last sub-interval (num_steps not a multiple of snap_every):
        # step to the end and keep only the final state
        rem = num_steps - start
        with obs.span("scan") as stepping:
            last, u, _, t = _transient_scan(ops, prec, u, u_prev, start,
                                            rem, rem, snap_dtype,
                                            start=chunks_done == 0)
        scan_s += stepping.seconds
        tally = tally.plus(t)
        with obs.span("solve.fetch") as fetch:
            frames.append(_frames(last))
        fetch_s += fetch.seconds
        snap_steps.append(num_steps)
    try:
        os.remove(path)   # run complete
    except OSError:
        pass
    return TransientResult(
        values=np.concatenate(frames, axis=0),
        times=dt * np.asarray([0] + snap_steps, dtype=np.float64),
        setup_seconds=setup_s, scan_seconds=scan_s, fetch_seconds=fetch_s,
        **_tallied(tally, kept))


# ----------------------------------------------------------------------
# Newmark-β second-order dynamics:  M ü + K u = f
# ----------------------------------------------------------------------

class NewmarkResult(NamedTuple):
    values: np.ndarray       # [num_steps+1, *node_shape(, v)] displacements
    velocities: np.ndarray   # [num_steps+1, *node_shape(, v)]
    times: np.ndarray
    total_cg_iterations: int
    max_relative_residual: float
    setup_seconds: float = 0.0  # host system prep + a0 + MG hierarchy
    scan_seconds: float = 0.0   # the stepping loop
    fetch_seconds: float = 0.0  # both trajectories device → host
                                # (the three as TransientResult's)
    scan_reruns: int = 0        # these six as TransientResult's
    scan_stepwise_chunks: int = 0
    scan_past_iterations: int = 0
    scan_programs_built: int = 0
    scan_capture_seconds: float = 0.0
    scan_kept: bool = False


class _NewmarkOperands(NamedTuple):
    """What one Newmark step reads, on the device in the state's dtype."""

    offsets: tuple
    A_w: object                # A_eff: flat operator or per-offset tensors
    K_w: tuple                 # unscaled K (K ũ through shifted slices)
    free: torch.Tensor
    f_ext: torch.Tensor
    scale_ops: tuple
    dt: float
    beta: float
    gamma: float
    inner_tol: float
    maxiter: int
    grid_dim: int
    vdim: int
    h: object = None           # MG hierarchy of A_eff
    graphs: object = None      # the scan's step programs, and the CG
                               # step solve's captured loops


def _newmark_scan(ops: _NewmarkOperands, u, v, a, num_steps: int,
                  snap_dtype, start: bool = True):
    """``num_steps`` Newmark steps from the carry (u, v, a) through the
    step program (``device_loop.run_scan``; ``start``: they begin this
    call's trajectory).  Returns (displacements,
    velocities) [num_steps, ...] in ``snap_dtype``, the final carry at full
    precision and its ``device_loop.ScanTally``."""
    d, vdim, offsets = ops.grid_dim, ops.vdim, ops.offsets
    to_hat_b, to_hat_x, from_hat_x = ops.scale_ops
    dt, gamma = ops.dt, ops.gamma
    c1 = dt * dt * (0.5 - ops.beta)
    c2 = ops.beta * dt * dt
    us = torch.empty((num_steps,) + tuple(u.shape), dtype=snap_dtype,
                     device=u.device)
    vs = torch.empty_like(us)

    def step(c, n, solve):
        u, v, a = c
        u_pred = u + dt * v + c1 * a
        bt = ops.free * (ops.f_ext - _stencil_apply(offsets, ops.K_w, u_pred,
                                                    d, vdim))
        xh, k, relres = solve(to_hat_b(bt), to_hat_x(a))
        a_new = ops.free * from_hat_x(xh)
        return ((u_pred + c2 * a_new,
                 v + dt * ((1.0 - gamma) * a + gamma * a_new), a_new),
                k, relres)

    def keep(j, c):
        us[j].copy_(c[0])
        vs[j].copy_(c[1])

    per_step, program = _step_solvers(ops, ops.A_w)
    carry, tally = device_loop.run_scan(
        ops.graphs, ("scan", "newmark"), step, program, per_step, (u, v, a),
        ops.inner_tol, ops.maxiter, 0, num_steps, keep, start)
    return us, vs, carry, tally


def run_newmark(
    K_np: Dict,
    M_np: Dict,
    mesh: StructuredMesh,
    bc: DirichletBC,
    f_np: np.ndarray,
    u0_np: np.ndarray,
    v0_np: np.ndarray,
    dt: float,
    num_steps: int,
    beta: float = 0.25,
    gamma: float = 0.5,
    vdim: int = 1,
    config: Optional[SolverConfig] = None,
    mg_level_builder=None,
) -> NewmarkResult:
    """Implicit Newmark-β time integration of M ü + K u = f.

    ``K_np``/``M_np`` are (block) stencils; ``f_np`` a constant external
    load; ``u0_np`` must satisfy the Dirichlet values (they stay pinned).
    ``mg_level_builder(mesh_c) -> (K_c, M_c, bc_c)`` (optional) enables
    MG-PCG step solves on A_eff = M + βΔt²K above
    ``transient_mg_threshold`` DOF; without a hierarchy every step is a
    plain CG on A_eff: the dense flat operator at float32, float64 tensors
    at "f64".  K ũ applies the unscaled K through plain shifted slices, as
    the explicit operators of ``run_transient`` do.  "f64" steps a float64
    state to ``cfg.tol`` (the initial acceleration too); "f32" and "mixed"
    a float32 state to ``transient_inner_tol``.  Every step's displacement
    and velocity come back (no frame thinning), float64 on the host.
    ``transient_checkpoint_every > 0`` runs the checkpointed scan
    (:func:`_run_newmark_checkpointed`)."""
    cfg = config or get_config()
    prec = cfg.resolve_precision()
    if prec == "mixed":
        prec = "f32"   # the reference's rule: no f64 inside the scan
    if prec not in ("f32", "f64"):
        raise ValueError(f"unknown precision {prec!r}")
    with obs.span("scan.setup") as setup:   # what both paths share
        device = torch.device(cfg.device)
        state_dtype = torch.float64 if prec == "f64" else torch.float32
        d = mesh.dim
        n = int(np.prod(mesh.node_shape)) * vdim
        maxiter = cfg.resolved_maxiter(n)
        num_steps = int(num_steps)
        inner_tol = cfg.tol if prec == "f64" else cfg.transient_inner_tol

        A_np = _combine(K_np, M_np, alpha=beta * dt * dt, beta=1.0)
        # acceleration BC values are zero: a zero-valued mask of u's pattern
        bc0 = DirichletBC(np.asarray(bc.free_mask, np.float64),
                          np.zeros_like(np.asarray(bc.values, np.float64)))
        sysm = prepare_system(A_np, mesh, bc0, np.zeros(u0_np.shape), vdim)
        offsets = sysm.offsets
        wshape = mesh.node_shape + ((vdim, vdim) if vdim > 1 else ())
        K_list = [np.asarray(K_np.get(o, np.zeros(wshape)), np.float64)
                  for o in offsets]

        def dev(a):   # a copy: cached host arrays are read-only
            return torch.tensor(np.asarray(a), dtype=state_dtype,
                                device=device)

        def step_operator(system):
            """The dense flat operator at float32 (never the constant-interior
            one: the reference does not try it on this branch), else
            per-offset tensors in the state's dtype (float64, or float32 below
            ``KERNEL_MIN_DOF``)."""
            if prec == "f32" and kernel_wins(n):
                return FlatStencilOperator(offsets, system.weights,
                                           mesh.node_shape, vdim=vdim,
                                           device=device)
            return tuple(dev(W) for W in system.weights)

        free_np = np.asarray(bc.free_mask, dtype=np.float64)
        # consistent initial acceleration: M a0 = free ⊙ (f − K u0)
        sys_m = prepare_system(M_np, mesh, bc0, free_np * (
            np.asarray(f_np, np.float64)
            - np_stencil_apply(K_np, np.asarray(u0_np, np.float64), d, vdim)),
            vdim)
        xh0, _, _ = _cg_unit_diag(offsets, step_operator(sys_m),
                                  dev(sys_m.b_hat),
                                  torch.zeros(u0_np.shape, dtype=state_dtype,
                                              device=device),
                                  inner_tol, maxiter, d, vdim)
        a = dev(free_np * sys_m.from_hat_x(
            xh0.cpu().numpy().astype(np.float64)))
        del sys_m
        nshard = cfg.resolved_shard_devices()
    if nshard > 1:
        # the whole Newmark scan decomposed over the shards, as
        # run_transient's sharded scan
        from pde_solver_tpu_torch.parallel.shard import (ShardedNewmarkScan,
                                                         device_mesh, padder)

        if cfg.transient_checkpoint_every > 0:
            get_logger().warning(
                "transient_checkpoint_every=%d is not supported on the "
                "sharded Newmark path — running without mid-solve "
                "checkpoints", cfg.transient_checkpoint_every)
        get_logger().info("sharded Newmark scan: %d devices, %d steps",
                          nshard, num_steps)
        with obs.span("scan.setup") as more:   # the sharded scan's
            mesh_dev = device_mesh(nshard, device=device)
            pad = padder(np.shape(free_np)[0], vdim, mesh_dev, state_dtype)
            values = dict(K_w=tuple(pad(W) for W in K_list), free=pad(free_np),
                          f_ext=pad(np.asarray(f_np, np.float64)))
            key = _scan_key("newmark", mesh, vdim, prec, sysm, device, (
                state_dtype, float(dt), float(beta), float(gamma),
                float(inner_tol), int(maxiter), "shard",
                tuple(str(x) for x in mesh_dev.devices)))
            scan, kept = _kept("newmark", key, values,
                               lambda v: ShardedNewmarkScan(
                                   sysm, d, vdim, mesh_dev, dt, beta, gamma,
                                   dtype=state_dtype, inner_tol=inner_tol,
                                   maxiter=maxiter, **v))
            del values
        with obs.span("scan") as stepping:
            us, vs, tally = scan.run(np.asarray(u0_np, np.float64),
                                     np.asarray(v0_np, np.float64),
                                     a.cpu().numpy().astype(np.float64),
                                     num_steps)
        with obs.span("solve.fetch") as fetch:
            values = np.concatenate([np.asarray(u0_np, np.float64)[None],
                                     us.numpy().astype(np.float64)], axis=0)
            vels = np.concatenate([np.asarray(v0_np, np.float64)[None],
                                   vs.numpy().astype(np.float64)], axis=0)
        return NewmarkResult(
            values=values, velocities=vels,
            times=dt * np.arange(num_steps + 1, dtype=np.float64),
            setup_seconds=setup.seconds + more.seconds,
            scan_seconds=stepping.seconds, fetch_seconds=fetch.seconds,
            **_tallied(tally, kept))

    use_mg = (mg_level_builder is not None and cfg.use_multigrid
              and n >= cfg.resolved_transient_mg_threshold())

    def build(values):
        h = None
        if use_mg:
            from pde_solver_tpu_torch.ops import multigrid as mg

            def A_builder(mesh_c):
                K_c, M_c, bc_c = mg_level_builder(mesh_c)
                return (_combine(K_c, M_c, alpha=beta * dt * dt, beta=1.0),
                        bc_c)

            h = mg.build_hierarchy(mesh, sysm, A_builder, vdim=vdim,
                                   device=device, dtype=state_dtype)
        if sysm.scale_kind == "scalar":
            scale_ops = _make_scale_ops(dev(sysm.s), None, None)
        else:
            scale_ops = _make_scale_ops(None, dev(sysm.Ct), dev(sysm.CinvT))
        return _NewmarkOperands(
            offsets, step_operator(sysm) if h is None else None,
            scale_ops=scale_ops, dt=float(dt), beta=float(beta),
            gamma=float(gamma), inner_tol=inner_tol, maxiter=maxiter,
            grid_dim=d, vdim=vdim, h=h, graphs=device_loop.GraphStore(),
            **values)

    with obs.span("scan.setup") as more:   # the scan's own
        snap32 = cfg.snapshot_dtype == "f32" and prec != "f64"
        snap_dtype = torch.float32 if snap32 else state_dtype
        # this call's values: copied into a kept entry's buffers on a hit
        values = dict(K_w=tuple(dev(W) for W in K_list), free=dev(free_np),
                      f_ext=dev(f_np))
        key = _scan_key("newmark", mesh, vdim, prec, sysm, device, (
            state_dtype, snap_dtype, float(dt), float(beta), float(gamma),
            float(inner_tol), int(maxiter), use_mg))
        ops, kept = _kept("newmark", key, values, build)
        del values
        h = ops.h
        u, v = dev(u0_np), dev(v0_np)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    setup_s = setup.seconds + more.seconds

    if cfg.transient_checkpoint_every > 0:
        # the content key covers everything that determines the trajectory
        # (operators, BC data, state, forcing, numerics) but not num_steps,
        # hashed as the reference hashes it
        hsh = hashlib.blake2b(digest_size=12)
        hsh.update(repr((mesh.node_shape, vdim, float(dt), float(beta),
                         float(gamma), prec, float(inner_tol), int(maxiter),
                         bool(snap32))).encode())
        for arr in ((u0_np, v0_np, f_np, free_np,
                     np.asarray(bc.values, np.float64))
                    + tuple(sysm.weights) + tuple(K_list)):
            hsh.update(np.ascontiguousarray(np.asarray(arr, np.float64)))
        return _run_newmark_checkpointed(ops, (u, v, a), num_steps, cfg,
                                         u0_np, v0_np, setup_s,
                                         hsh.hexdigest(), snap_dtype, kept)

    with obs.span("scan") as stepping:
        us, vs, _, tally = _newmark_scan(ops, u, v, a, num_steps,
                                         snap_dtype)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    scan_s = stepping.seconds

    with obs.span("solve.fetch") as fetch:
        values = np.concatenate([np.asarray(u0_np, np.float64)[None],
                                 _frames(us)], axis=0)
        vels = np.concatenate([np.asarray(v0_np, np.float64)[None],
                               _frames(vs)], axis=0)
    fetch_s = fetch.seconds
    get_logger().info("newmark: %d steps, %d CG iterations, max relres "
                      "%.3e, setup %.3fs, scan %.3fs, fetch %.3fs (%d DOF, "
                      "%s, %s step solves; step programs: %s, %d built, %d "
                      "reruns, %d chunks step by step, %d masked iterations "
                      "past convergence, capture %.3fs)",
                      num_steps, tally.iterations, tally.relres, setup_s,
                      scan_s, fetch_s, n, prec,
                      "MG-PCG" if h is not None else "CG",
                      "kept" if kept else "new", tally.built, tally.reruns,
                      tally.stepwise, tally.past, tally.capture_seconds)
    return NewmarkResult(values=values, velocities=vels,
                         times=dt * np.arange(num_steps + 1,
                                              dtype=np.float64),
                         setup_seconds=setup_s, scan_seconds=scan_s,
                         fetch_seconds=fetch_s, **_tallied(tally, kept))


def _run_newmark_checkpointed(ops: _NewmarkOperands, carry0, num_steps: int,
                              cfg: SolverConfig, u0_np, v0_np,
                              setup_s: float, key: str,
                              snap_dtype, kept: bool) -> NewmarkResult:
    """Host-chunked Newmark scan with atomic (u, v, a) checkpoints, as
    :func:`_run_transient_checkpointed`: every
    ``transient_checkpoint_every`` steps the full-precision carry and the
    displacement and velocity frames persist to ``checkpoint_dir``; a
    re-run of the same content-keyed problem resumes from the last
    completed chunk; the file is removed on completion.  The acceleration
    is carried explicitly, so chunking is bitwise the uninterrupted
    scan."""
    every = max(1, int(cfg.transient_checkpoint_every))
    path = os.path.join(cfg.checkpoint_dir, f"newmark-{key}.npz")
    dtype, device = carry0[0].dtype, carry0[0].device

    def fresh():
        return ([np.asarray(u0_np, np.float64)[None]],
                [np.asarray(v0_np, np.float64)[None]], 0, 0, 0.0, carry0)

    u_frames, v_frames, start, iters, res, carry = fresh()
    with obs.span("scan.checkpoint"):   # a resume reads it
        if os.path.exists(path):
            try:
                with np.load(path) as z:
                    if int(z["step"]) > num_steps:
                        get_logger().warning(
                            "newmark checkpoint at step %d exceeds requested "
                            "num_steps=%d — recomputing from step 0",
                            int(z["step"]), num_steps)
                    else:
                        u_frames.append(z["us"].astype(np.float64))
                        v_frames.append(z["vs"].astype(np.float64))
                        start, iters, res = (int(z["step"]), int(z["iters"]),
                                             float(z["res"]))
                        carry = tuple(torch.as_tensor(z[k], dtype=dtype,
                                                      device=device)
                                      for k in ("u", "v", "a"))
                        get_logger().info("newmark resume: step %d/%d from %s",
                                          start, num_steps, path)
            except _UNREADABLE as e:
                get_logger().warning("unreadable checkpoint %s (%s) — "
                                     "recomputing from step 0", path, e)
                u_frames, v_frames, start, iters, res, carry = fresh()
    tally = device_loop.ScanTally(iters, res)
    chunks_done = 0
    scan_s = fetch_s = 0.0
    snap_np = np.float32 if snap_dtype == torch.float32 else np.float64
    while start < num_steps:
        n = min(every, num_steps - start)
        with obs.span("scan") as stepping:
            us, vs, carry, t = _newmark_scan(ops, *carry, n, snap_dtype,
                                             start=chunks_done == 0)
        scan_s += stepping.seconds
        tally = tally.plus(t)
        with obs.span("solve.fetch") as fetch:
            u_frames.append(_frames(us))
            v_frames.append(_frames(vs))
        fetch_s += fetch.seconds
        start += n
        with obs.span("scan.checkpoint"):
            _save_checkpoint(
                cfg, path,
                us=np.concatenate(u_frames[1:], axis=0).astype(snap_np),
                vs=np.concatenate(v_frames[1:], axis=0).astype(snap_np),
                u=_host(carry[0]), v=_host(carry[1]), a=_host(carry[2]),
                step=start, iters=tally.iterations, res=tally.relres)
        chunks_done += 1
        if _CKPT_TEST_ABORT and chunks_done >= _CKPT_TEST_ABORT \
                and start < num_steps:
            raise RuntimeError("checkpoint test abort")
    try:
        os.remove(path)   # run complete
    except OSError:
        pass
    return NewmarkResult(
        values=np.concatenate(u_frames, axis=0),
        velocities=np.concatenate(v_frames, axis=0),
        times=ops.dt * np.arange(num_steps + 1, dtype=np.float64),
        setup_seconds=setup_s, scan_seconds=scan_s, fetch_seconds=fetch_s,
        **_tallied(tally, kept))
