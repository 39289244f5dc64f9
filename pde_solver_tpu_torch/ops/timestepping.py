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
``PDE_TPU_CS``).  The reference's ``lax.scan`` becomes a Python loop; the
kept frames stack on the device and come back to the host once, whole and
at float32.

Like the reference, "mixed" precision runs the scan in float32 (implicit
stepping is contractive and every step is solved to
``transient_inner_tol`` from a warm start).  Sinusoidal driving
(``time_mod``) and explicit IMEX convection (``C_np``, folded into the
explicit operator for "ab1" or extrapolated by Adams-Bashforth-2 for
"cnab2") are operands of the same step.  Not ported, each raising
``NotImplementedError``: float64 scans, checkpointing and sharding.  The
reference thins large trajectory pulls to bfloat16 frames for its slow host
link; the port pulls everything at float32 (ROADMAP queue 3).

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

import math
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from pde_solver_tpu_torch.config import SolverConfig, get_config
from pde_solver_tpu_torch.mesh import StructuredMesh
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.ops.linsolve import (_cg_unit_diag, _static_flat_op,
                                               _stencil_apply,
                                               np_stencil_apply,
                                               prepare_system)
from pde_solver_tpu_torch.ops.stencil_kernels import (FlatStencilOperator,
                                                      kernel_wins)
from pde_solver_tpu_torch.utils.observability import get_logger


class TransientResult(NamedTuple):
    values: np.ndarray        # [frames, *node_shape(, v)] float64 — u0 first
    times: np.ndarray         # [frames]
    total_cg_iterations: int
    max_relative_residual: float
    setup_seconds: float = 0.0  # host system prep + MG hierarchy + staging
    scan_seconds: float = 0.0   # the stepping loop (throughput =
                                # num_steps / scan_seconds)
    fetch_seconds: float = 0.0  # trajectory device → host


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
    per step (the reference evaluates it in the float32 state type; the
    two differ by ~1e-7 relative)."""
    if convection_scheme not in ("ab1", "cnab2"):
        raise ValueError(f"unknown convection_scheme {convection_scheme!r}")
    cfg = config or get_config()
    cfg.resolved_shard_devices()  # raises when sharding is requested
    if cfg.transient_checkpoint_every > 0:
        raise NotImplementedError("checkpointed transients are not ported "
                                  "yet (ROADMAP queue 1, item 8)")
    prec = cfg.resolve_precision()
    if prec == "mixed":
        prec = "f32"   # the reference's rule: no f64 inside the scan
    if prec != "f32":
        raise NotImplementedError(f"precision {prec!r} transient scans are not "
                                  "ported yet; only 'f32' and 'mixed' are "
                                  "(ROADMAP queue 1, item 2)")
    t_setup = time.perf_counter()
    device = torch.device(cfg.device)
    d = mesh.dim
    n = int(np.prod(mesh.node_shape)) * vdim
    maxiter = cfg.resolved_maxiter(n)
    num_steps = int(num_steps)

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
    omega = phase = 0.0
    if time_mod:
        omega = float(time_mod["omega"])
        phase = float(time_mod.get("phase", 0.0))
        if time_mod.get("source_amp") is not None:
            b1_np = dt * np.asarray(time_mod["source_amp"], np.float64)
        if time_mod.get("bc_amp_values") is not None:
            g1_np = (1.0 - free_np) * np.asarray(time_mod["bc_amp_values"],
                                                 np.float64)
            Ag1_np = np_stencil_apply(A_np, g1_np, d, vdim)

    h = None
    if (mg_level_builder is not None and cfg.use_multigrid
            and n >= cfg.resolved_transient_mg_threshold()):
        from pde_solver_tpu_torch.ops import multigrid as mg

        def A_builder(mesh_c):
            K_c, M_c, bc_c = mg_level_builder(mesh_c)
            return _combine(K_c, M_c, alpha=theta * dt, beta=1.0), bc_c

        h = mg.build_hierarchy(mesh, sysm, A_builder, vdim=vdim,
                               device=device)
    A32 = None
    if h is None:
        # The reference builds this operator on the MG branch too and never
        # reads it there; the port builds it only for the plain-CG step.
        A32 = _static_flat_op(sysm, mesh, vdim, device) or tuple(
            torch.as_tensor(W, dtype=torch.float32, device=device)
            for W in scaled)

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    B_w = tuple(dev(W) for W in B_list)
    free, g, Ag = dev(free_np), dev(gvals), dev(Ag_np)
    b_src = dev(dt * np.asarray(b_source_np, np.float64))
    C_w = None if C_list is None else tuple(dev(W) for W in C_list)
    b1, g1, Ag1 = (None if a is None else dev(a)
                   for a in (b1_np, g1_np, Ag1_np))
    if sysm.scale_kind == "scalar":
        scale_ops = _make_scale_ops(dev(sysm.s), None, None)
    else:
        scale_ops = _make_scale_ops(None, dev(sysm.Ct), dev(sysm.CinvT))
    to_hat_b, to_hat_x, from_hat_x = scale_ops
    inner_tol = cfg.transient_inner_tol

    def step(u, u_prev, n):
        """Step n → n+1 (n a host integer: the sinusoid costs no sync)."""
        rhs = _stencil_apply(offsets, B_w, u, d, vdim) + b_src
        Ag_t, g_t = Ag, g
        if time_mod:
            # b(t) enters the θ-scheme as Δt·[θ s(t_{n+1}) + (1−θ) s(t_n)]·b1;
            # Dirichlet data g(t) is enforced at the new time level, its
            # lift A·g(t) scaling with the same sinusoid
            s_n = math.sin(omega * (n * dt) + phase)
            s_np1 = math.sin(omega * (n * dt + dt) + phase)
            if b1 is not None:
                rhs = rhs + (theta * s_np1 + (1.0 - theta) * s_n) * b1
            if g1 is not None:
                Ag_t, g_t = Ag + s_np1 * Ag1, g + s_np1 * g1
        if C_w is not None:
            # CNAB2: Adams-Bashforth-2 extrapolation of the convection term
            # (C_w is pre-scaled by Δt)
            rhs = rhs - (1.5 * _stencil_apply(offsets, C_w, u, d, vdim)
                         - 0.5 * _stencil_apply(offsets, C_w, u_prev, d,
                                                vdim))
        b_hat = to_hat_b(free * (rhs - Ag_t) + g_t)
        x0_hat = to_hat_x(u)
        if h is not None:
            # resync_every=0: warm-started step solves take a handful of
            # iterations and do not drift (the reference's choice)
            xh, k, relres = mg.mg_pcg(h, b_hat, x0_hat, inner_tol, maxiter,
                                      resync_every=0)
        else:
            xh, k, relres = _cg_unit_diag(offsets, A32, b_hat, x0_hat,
                                          inner_tol, maxiter, d, vdim)
        return from_hat_x(xh), k, relres

    # the frames kept: every snap_every-th step, and the final state always
    snap_every = _snapshot_every(cfg, num_steps, n * 4)
    main = (num_steps // snap_every) * snap_every
    kept = list(range(snap_every, main + 1, snap_every))
    if snap_every > 1:
        times = [0.0] + [dt * snap_every * (j + 1)
                         for j in range(main // snap_every)]
        if main < num_steps:
            kept.append(num_steps)
            times.append(dt * num_steps)
        times = np.asarray(times, np.float64)
    else:
        times = dt * np.arange(num_steps + 1, dtype=np.float64)
    u = dev(u0_np)
    snaps = torch.empty((len(kept),) + tuple(u.shape), dtype=torch.float32,
                        device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_setup

    t_scan = time.perf_counter()
    iters, res = 0, 0.0
    frame = 0
    u_prev = u
    for j in range(1, num_steps + 1):
        u_new, k, relres = step(u, u_prev, j - 1)
        u_prev, u = u, u_new
        iters += int(k)
        res = max(res, float(relres))
        if frame < len(kept) and kept[frame] == j:
            snaps[frame] = u
            frame += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    scan_s = time.perf_counter() - t_scan

    t_fetch = time.perf_counter()
    traj = snaps.cpu().numpy().astype(np.float64)
    values = np.concatenate([np.asarray(u0_np, np.float64)[None], traj],
                            axis=0)
    fetch_s = time.perf_counter() - t_fetch
    get_logger().info("transient: %d steps, %d CG iterations, max relres "
                      "%.3e, setup %.3fs, scan %.3fs, fetch %.3fs (%d DOF, "
                      "%s step solves)", num_steps, iters, res, setup_s,
                      scan_s, fetch_s, n, "MG-PCG" if h is not None else "CG")
    return TransientResult(values=values, times=times,
                           total_cg_iterations=iters,
                           max_relative_residual=res,
                           setup_seconds=setup_s, scan_seconds=scan_s,
                           fetch_seconds=fetch_s)


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
    plain CG on the dense flat operator of A_eff.  K ũ applies the unscaled
    K through plain shifted slices, as the explicit operators of
    ``run_transient`` do.  Every step's displacement and velocity come
    back (no frame thinning), float64 on the host from the float32 device
    trajectory."""
    cfg = config or get_config()
    cfg.resolved_shard_devices()  # raises when sharding is requested
    if cfg.transient_checkpoint_every > 0:
        raise NotImplementedError("checkpointed Newmark scans are not ported "
                                  "yet (ROADMAP step H)")
    prec = cfg.resolve_precision()
    if prec == "mixed":
        prec = "f32"   # the reference's rule: no f64 inside the scan
    if prec != "f32":
        raise NotImplementedError(f"precision {prec!r} Newmark scans are not "
                                  "ported yet; only 'f32' and 'mixed' are "
                                  "(ROADMAP step H)")
    t_setup = time.perf_counter()
    device = torch.device(cfg.device)
    d = mesh.dim
    n = int(np.prod(mesh.node_shape)) * vdim
    maxiter = cfg.resolved_maxiter(n)
    num_steps = int(num_steps)
    inner_tol = cfg.transient_inner_tol

    A_np = _combine(K_np, M_np, alpha=beta * dt * dt, beta=1.0)
    # acceleration BC values are zero: a zero-valued mask of u's pattern
    bc0 = DirichletBC(np.asarray(bc.free_mask, np.float64),
                      np.zeros_like(np.asarray(bc.values, np.float64)))
    sysm = prepare_system(A_np, mesh, bc0, np.zeros(u0_np.shape), vdim)
    offsets = sysm.offsets
    wshape = mesh.node_shape + ((vdim, vdim) if vdim > 1 else ())
    K_list = [np.asarray(K_np.get(o, np.zeros(wshape)), np.float64)
              for o in offsets]

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    def flat_or_plain(system):
        """The dense flat operator (never the constant-interior one: the
        reference does not try it on this branch), or per-offset tensors
        below ``KERNEL_MIN_DOF``."""
        if kernel_wins(n):
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
    xh0, _, _ = _cg_unit_diag(offsets, flat_or_plain(sys_m),
                              dev(sys_m.b_hat),
                              torch.zeros(u0_np.shape, dtype=torch.float32,
                                          device=device),
                              inner_tol, maxiter, d, vdim)
    a = dev(free_np * sys_m.from_hat_x(xh0.cpu().numpy().astype(np.float64)))
    del sys_m

    h = None
    if (mg_level_builder is not None and cfg.use_multigrid
            and n >= cfg.resolved_transient_mg_threshold()):
        from pde_solver_tpu_torch.ops import multigrid as mg

        def A_builder(mesh_c):
            K_c, M_c, bc_c = mg_level_builder(mesh_c)
            return _combine(K_c, M_c, alpha=beta * dt * dt, beta=1.0), bc_c

        h = mg.build_hierarchy(mesh, sysm, A_builder, vdim=vdim,
                               device=device)
    A32 = flat_or_plain(sysm) if h is None else None

    K_w = tuple(dev(W) for W in K_list)
    free, f_ext = dev(free_np), dev(f_np)
    if sysm.scale_kind == "scalar":
        scale_ops = _make_scale_ops(dev(sysm.s), None, None)
    else:
        scale_ops = _make_scale_ops(None, dev(sysm.Ct), dev(sysm.CinvT))
    to_hat_b, to_hat_x, from_hat_x = scale_ops
    c1 = dt * dt * (0.5 - beta)
    c2 = beta * dt * dt

    u, v = dev(u0_np), dev(v0_np)
    us = torch.empty((num_steps,) + tuple(u.shape), dtype=torch.float32,
                     device=device)
    vs = torch.empty_like(us)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_setup

    t_scan = time.perf_counter()
    iters, res = 0, 0.0
    for j in range(num_steps):
        u_pred = u + dt * v + c1 * a
        bt = free * (f_ext - _stencil_apply(offsets, K_w, u_pred, d, vdim))
        if h is not None:
            xh, k, relres = mg.mg_pcg(h, to_hat_b(bt), to_hat_x(a),
                                      inner_tol, maxiter, resync_every=0)
        else:
            xh, k, relres = _cg_unit_diag(offsets, A32, to_hat_b(bt),
                                          to_hat_x(a), inner_tol, maxiter,
                                          d, vdim)
        a_new = free * from_hat_x(xh)
        u = u_pred + c2 * a_new
        v = v + dt * ((1.0 - gamma) * a + gamma * a_new)
        a = a_new
        us[j], vs[j] = u, v
        iters += int(k)
        res = max(res, float(relres))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    scan_s = time.perf_counter() - t_scan

    t_fetch = time.perf_counter()
    values = np.concatenate([np.asarray(u0_np, np.float64)[None],
                             us.cpu().numpy().astype(np.float64)], axis=0)
    vels = np.concatenate([np.asarray(v0_np, np.float64)[None],
                           vs.cpu().numpy().astype(np.float64)], axis=0)
    fetch_s = time.perf_counter() - t_fetch
    get_logger().info("newmark: %d steps, %d CG iterations, max relres "
                      "%.3e, setup %.3fs, scan %.3fs, fetch %.3fs (%d DOF, "
                      "%s step solves)", num_steps, iters, res, setup_s,
                      scan_s, fetch_s, n, "MG-PCG" if h is not None else "CG")
    return NewmarkResult(values=values, velocities=vels,
                         times=dt * np.arange(num_steps + 1,
                                              dtype=np.float64),
                         total_cg_iterations=iters,
                         max_relative_residual=res, setup_seconds=setup_s,
                         scan_seconds=scan_s, fetch_seconds=fetch_s)
