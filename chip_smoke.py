#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pde_solver_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Asserts a CUDA card and prints its name and power limit (nvidia-smi).
2. Builds both kernel sources from ``pde_solver_tpu_torch/csrc`` with nvcc
   for sm_90a, in parallel, and prints the build seconds and every
   kernel's ptxas report.
3. Dense SpMV (``flat_stencil_spmv``): holds each 3D variant (vdim=3 f32,
   vdim=3 bf16, vdim=1 f32, vdim=1 bf16) against its plain PyTorch version
   at the flagship fine level (161×65×65 nodes) and a small level
   (21×9×9), relative max error ≤ 1e-5, and times both (CUDA events).
4. Constant-interior pair (``cs_stencil``: cs_main, cs_window) on the
   real assembled fine-level operators of the main paths: the heat slice's
   scaled backward-Euler operator M + Δt·K at 129³ nodes (vdim=1), and the
   flagship's scaled elasticity operator (vdim=3) and P1 mass operator of
   its stress projection (vdim=1), both at 161×65×65 nodes.  Each must be
   CS-representable; each kernel must match its plain version, and the
   pair the dense kernel, within 2e-6·max|y|; the dense kernel in f32 and
   bf16 must match its own plain version there within 1e-5 (relative).
   Times the pair, each kernel, the plain versions and the dense kernel.
5. Small checks on the card against host solves: a 16×8×8 cantilever
   against sparse LU (von Mises within 1e-6 of its max), and a 40×6×6
   heat transient (5 steps, MG-PCG, constant-interior operator) against a
   float64 backward Euler with scipy (within 1e-6·max|T|).
6. The main paths through the public API, each with the launch counts set
   to 0 just before and read just after:
   - the flagship, 3D static elasticity of a 1 m × 0.2 m × 0.2 m
     cantilever under gravity on 160×64×64 cells (2,040,675 DOF), with
     ``PDE_TPU_CS`` 0 (dense kernels) and 1 (constant-interior kernels);
   - the heat slice, ``solve_heat_3D(nx=ny=nz=128)`` (20 backward-Euler
     steps on 2,146,689 DOF), with ``PDE_TPU_CS`` 0 and 1.
   Checks convergence, finite fields of the expected shape, that the two
   routes agree, and that each run launched its kernels.  Every dense
   operator a run launched and every constant-interior operator it built
   (each MG level and weight dtype, each step operator, the projection)
   is then held against its plain version at its own shape.  Both heat
   trajectories are held against a float64 backward Euler of the same
   system, solved on the card with sparse Jacobi-PCG to 1e-12.
7. The 1D/2D, curvilinear and ``_loaded`` tools through the public API,
   each a main path of its own (counts 0 before, read after):
   - BASELINE config 1, ``solve_heat_1D`` (256 nodes, 400 backward-Euler
     steps): last frame against the steady line 20(1 − x/2), trajectory
     against a host float64 backward Euler;
   - config 2, ``solve_elasticity_1D_static`` (256 nodes): host sparse LU,
     never on the card (checked: no launch); interior stress against
     σ = b(L − x)/A;
   - config 3, ``solve_heat_2D`` (128², 50 Crank-Nicolson steps) against a
     host float64 Crank-Nicolson;
   - config 4, ``solve_elasticity_2D_static`` (256², plane stress) against
     host sparse LU, and the full-width plate at 1024² (2,101,250 DOF),
     whose relative residual is recomputed on the host in float64;
   - the ``_loaded`` tools: 2D at 256² and 3D at 16×8×8 against host
     sparse LU, the 1D bar against σ = P/A;
   - the curvilinear heat tools: steady 1D cylindrical and spherical
     against their closed forms and a host float64 solve; 2D cylindrical,
     2D spherical and 3D spherical at their default sizes, steady and
     transient, without and with a source, against host float64 solves.
   Each of these runs, too, has every dense operator it launched held
   against plain (relative max error ≤ 1e-5).  Before them, K1 at vdim=2
   (f32, bf16) is held against its plain version on the scaled
   plane-stress operators at 257² and 1025² nodes on four inputs
   (relative max error ≤ 1e-5, where two planted faults must read > 10×
   that) and timed.

Fails loudly at the first failed check (non-zero exit, no result line).
Prints, before the last line, the card line and a JSON line with each
kernel's launches on the main paths, error and times; the last line is
``{"ok": true, "device": {...}}``.  Needs no network; writes only under
``build/``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

FLAGSHIP = dict(Lx=1.0, Ly=0.2, Lz=0.2, nx=160, ny=64, nz=64, E=210e9,
                nu=0.3, body_fz=-9.81 * 7800)
SMALL = dict(FLAGSHIP, nx=16, ny=8, nz=8)
HEAT = dict(nx=128, ny=128, nz=128)          # every other argument default
HEAT_DOF = 129 ** 3
HEAT_STEPS = 20
SMALL_HEAT = dict(Lx=1.0, Ly=0.2, Lz=0.2, nx=40, ny=6, nz=6, num_steps=5)
SMALL_HEAT_CELLS = (40, 6, 6)
FLAGSHIP_CELLS = (160, 64, 64)
FLAGSHIP_EXTENT = (1.0, 0.2, 0.2)
FLAT_SOURCE = "pde_solver_tpu_torch/csrc/flat_stencil_spmv.cu"
CS_SOURCE = "pde_solver_tpu_torch/csrc/cs_stencil.cu"
REPLACES = {"flat": "pde_solver_tpu/ops/pallas_kernels.py:123",
            "cs_main": "pde_solver_tpu/ops/pallas_kernels.py:704",
            "cs_window": "pde_solver_tpu/ops/pallas_kernels.py:764"}
VARIANTS = (("v3_f32", 3, "float32"), ("v3_bf16", 3, "bfloat16"),
            ("v1_f32", 1, "float32"), ("v1_bf16", 1, "bfloat16"))
SHAPES = ((161, 65, 65), (21, 9, 9))   # flagship fine level, a small level
REL_TOL = 1e-5
# K1 at vdim=2 on the plane-stress fine levels of BASELINE config 4 and of
# the full-width plate
V2_VARIANTS = (("v2_f32", "float32"), ("v2_bf16", "bfloat16"))
V2_CELLS = ((256, 256), (1024, 1024))
V2_INPUTS = 4
# BASELINE configs 1-4 (BASELINE.md; bench.py bench_heat1d, bench_bar1d,
# bench_heat2d_cn, bench_elast2d) through the port's API
HEAT1D = dict(length=2.0, nx=255, T_left=20.0, T_right=0.0, T_initial=0.0,
              dt=0.05, num_steps=400)
BAR = dict(L=2.0, nx=255, E=70e9, area=0.01, body_force=500.0)
HEAT2D = dict(nx=128, ny=128, T_boundary=0.0, T_initial=20.0, dt=0.001,
              num_steps=50)                  # run at θ = 0.5
PLATE = dict(nx=256, ny=256, body_fy=-7.65e4)           # plane stress
PLATE_FULL = dict(nx=1024, ny=1024, body_fy=-7.65e4)    # 2,101,250 DOF
LOADED_3D = dict(Lx=1.0, Ly=0.2, Lz=0.2, nx=16, ny=8, nz=8,
                 loads={"right": {"type": "force", "vector": [0.0, 0.0, -1e4]},
                        "top": {"type": "pressure", "value": 1e5}})
LOADED_1D = dict(L=2.0, nx=255, E=70e9, area=0.01, end_load=1e4)
ELAST_LU_TOL = 1e-6
# float32 transients against float64 (max|ΔT|/max|T|) at the tools' default
# transient_inner_tol = 1e-6; CPU readings of the port's plain path: config
# 1 1.9e-4 (2.2e-4 from the steady line, relL2), config 3 3.3e-5, the
# curvilinear tools with a source up to 5.1e-4.  Config 1 and 3 sit on the
# float32 floor (the same at transient_inner_tol = 1e-8), the curvilinear
# ones on the step tolerance (2D spherical 3.3e-6 at 1e-8).  PERF.md has the
# card's readings.
HEAT1D_TOL = 1e-3
HEAT2D_CN_TOL = 2e-4
CURV_TRANSIENT_TOL = 2e-3
# steady 1D cylindrical/spherical against a·ln r + b and a/r + b: the P1
# discretisation error at nr = 50 (2.1e-4 and 1.07e-3 of 100 °C)
CLOSED_FORM_TOL = 1.5e-3
CS_TOL = 2e-6
# the heat slice (max|ΔT|/max|T|): its two routes against each other, and
# each against the float64 trajectory, where float32 weights and state,
# amplified by the step operator's conditioning, leave ~9e-5; PERF.md has
# the readings and what a wrong route gives
HEAT_ROUTE_TOL = 1e-5
HEAT_F64_TOL = 3e-4


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def turns(kernel, plain, reps_k: int, reps_p: int):
    """ms of kernel and plain, timed plain, kernel, kernel, plain."""
    p1 = time_ms(plain, reps_p)
    k1 = time_ms(kernel, reps_k)
    k2 = time_ms(kernel, reps_k)
    p2 = time_ms(plain, reps_p)
    return (k1 + k2) / 2, (p1 + p2) / 2


def kernel_phase(sk, offsets):
    """Dense kernel against plain on the card; returns per-variant results."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = {}
    for name, vdim, wdt in VARIANTS:
        res = {"max_abs_err": 0.0}
        for shape in SHAPES:
            N = shape[0] * shape[1] * shape[2]
            W = torch.randn((len(offsets) * vdim * vdim, N), generator=gen,
                            device="cuda")
            op = sk.FlatStencilOperator.from_packed(W, offsets, shape, vdim)
            op = op.as_weight_dtype(getattr(torch, wdt))
            x = torch.randn((vdim, N), generator=gen, device="cuda")
            y = op.apply_flat(x)
            torch.cuda.synchronize()
            y_plain = sk.spmv_plain(op.W, x, op.deltas, vdim)
            torch.cuda.synchronize()
            err = float((y - y_plain).abs().max())
            rel = err / max(float(y_plain.abs().max()), 1e-30)
            check(rel <= REL_TOL, f"{name} at {shape}: kernel vs plain "
                  f"relative max error {rel:.3e} > {REL_TOL}")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            ms, plain_ms = turns(
                lambda: op.apply_flat(x),
                lambda: sk.spmv_plain(op.W, x, op.deltas, vdim), 50, 10)
            w_bytes = op.W.numel() * op.W.element_size()
            print(f"kernel {name} nodes={shape} N={N}: rel_err={rel:.3e} "
                  f"abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"W={w_bytes / 1e6:.1f} MB -> {w_bytes / ms / 1e6:.1f} GB/s",
                  flush=True)
            if shape == SHAPES[0]:
                res.update(ms=ms, plain_ms=plain_ms)
            del W, op, x, y, y_plain
        results[name] = res
    return results


def heat_operator(cells, dt=0.01):
    """Scaled backward-Euler heat operator M + Δt·K on a unit box,
    all-boundary Dirichlet (the heat slice's fine-level operator)."""
    import numpy as np

    from pde_solver_tpu_torch.mesh import box_mesh
    from pde_solver_tpu_torch.ops import assembly
    from pde_solver_tpu_torch.ops.bc import DirichletBC
    from pde_solver_tpu_torch.ops.linsolve import prepare_system
    from pde_solver_tpu_torch.ops.timestepping import _combine

    mesh = box_mesh(*cells, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    bc = DirichletBC.from_masks([(mesh.boundary_mask(), 0.0)],
                                mesh.node_shape)
    return mesh, prepare_system(_combine(K, M, dt, 1.0), mesh, bc,
                                np.zeros(mesh.node_shape), 1)


def elasticity_operator():
    """The flagship's scaled fine-level elasticity operator (vdim=3):
    160×64×64 cells, clamped at x = 0."""
    import numpy as np

    from pde_solver_tpu_torch.mesh import box_mesh
    from pde_solver_tpu_torch.models.elasticity import lame_parameters
    from pde_solver_tpu_torch.ops import assembly
    from pde_solver_tpu_torch.ops.bc import DirichletBC
    from pde_solver_tpu_torch.ops.linsolve import prepare_system

    mesh = box_mesh(*FLAGSHIP_CELLS, (0.0, 0.0, 0.0), FLAGSHIP_EXTENT)
    lam, mu = lame_parameters(FLAGSHIP["E"], FLAGSHIP["nu"], "3d")
    K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=3)
    return mesh, prepare_system(K, mesh, bc,
                                np.zeros(mesh.node_shape + (3,)), 3)


def mass_operator():
    """The scaled P1 mass operator of the flagship's stress projection
    (vdim=1, no boundary condition)."""
    import numpy as np

    from pde_solver_tpu_torch.mesh import box_mesh
    from pde_solver_tpu_torch.ops import assembly
    from pde_solver_tpu_torch.ops.linsolve import prepare_system
    from pde_solver_tpu_torch.ops.projection import _no_bc

    mesh = box_mesh(*FLAGSHIP_CELLS, (0.0, 0.0, 0.0), FLAGSHIP_EXTENT)
    M = assembly.assemble_scalar_stencil(mesh, "mass", quad_degree=2)
    return mesh, prepare_system(M, mesh, _no_bc(mesh),
                                np.zeros(mesh.node_shape), 1)


def rel_err(y, y_ref) -> float:
    return float((y - y_ref).abs().max()) / max(float(y_ref.abs().max()),
                                                1e-30)


def cs_against_plain(ck, op, x, label: str):
    """K3 and K3+K4 against their plain versions on ``x``; returns the
    kernel outputs and the absolute errors."""
    import torch

    y_main = op.launch_main(x)
    y_pair = op.launch_window(x, y_main.clone())
    torch.cuda.synchronize()
    y_main_plain = ck.cs_main_plain(op, x)
    y_pair_plain = ck.cs_window_plain(op, x, y_main)
    err_main = float((y_main - y_main_plain).abs().max())
    err_win = float((y_pair - y_pair_plain).abs().max())
    check(err_main <= CS_TOL * float(y_main_plain.abs().max()),
          f"{label}: cs_main vs plain {err_main:.3e}")
    check(err_win <= CS_TOL * float(y_pair_plain.abs().max()),
          f"{label}: cs pair vs plain {err_win:.3e} "
          f"(max|y| {float(y_pair_plain.abs().max()):.3e})")
    return y_main, y_pair, err_main, err_win


def cs_phase(ck, sk):
    """Both CS kernels against their plain versions and against the dense
    kernel (itself held against its plain version), on the main paths'
    fine-level operators; returns per-variant results.  The first operator
    of each vdim gives the variant's times."""
    import torch

    from pde_solver_tpu_torch.ops import linsolve

    results = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for label, vdim, build in (
            ("heat 129^3", 1, lambda: heat_operator((128, 128, 128))),
            ("flagship elasticity 161x65x65", 3, elasticity_operator),
            ("flagship P1 mass 161x65x65", 1, mass_operator)):
        t0 = time.perf_counter()
        mesh, sysm = build()
        t1 = time.perf_counter()
        op = ck.CSFlatStencilOperator.try_build(
            sysm.offsets, sysm.weights, mesh.node_shape, vdim=vdim,
            device="cuda")
        t2 = time.perf_counter()
        check(op is not None, f"{label}: CS build refused")
        dense = sk.FlatStencilOperator(sysm.offsets, sysm.weights,
                                       mesh.node_shape, vdim=vdim,
                                       device="cuda")
        dense_bf16 = dense.as_weight_dtype(torch.bfloat16)
        x = torch.randn((vdim, op.N), generator=gen, device="cuda")
        y_main, y_pair, err_main, err_win = cs_against_plain(ck, op, x, label)
        y_dense = dense.apply_flat(x)
        y_bf16 = dense_bf16.apply_flat(x)
        torch.cuda.synchronize()
        err_dense = float((y_pair - y_dense).abs().max())
        dscale = float(y_dense.abs().max())
        check(err_dense <= CS_TOL * dscale, f"{label}: cs pair vs dense "
              f"kernel {err_dense:.3e} (max|y| {dscale:.3e})")
        dense_errs = {}
        for name, dop, y in (("f32", dense, y_dense),
                             ("bf16", dense_bf16, y_bf16)):
            y_plain = sk.spmv_plain(dop.W, x, dop.deltas, vdim)
            rel = rel_err(y, y_plain)
            check(rel <= REL_TOL, f"{label}: dense {name} kernel vs plain "
                  f"relative max error {rel:.3e} > {REL_TOL}")
            dense_errs[name] = (float((y - y_plain).abs().max()), rel)
            del y_plain
        print(f"cs {label}: N={op.N} n_win={op.n_win} "
              f"({op.n_win * ck.WINDOW / op.N:.4f} of the nodes) "
              f"sets={len(op.sets)} eff_sweeps={op.eff_sweeps:.4f} "
              f"operator {t1 - t0:.3f} s, host analysis {t2 - t1:.3f} s; "
              f"abs_err cs_main={err_main:.3e} pair={err_win:.3e} "
              f"pair-vs-dense={err_dense:.3e} (rel {err_dense / dscale:.3e})"
              f"; cs_main alone (no window pass) vs dense: rel "
              f"{rel_err(y_main, y_dense):.3e}; dense kernel vs plain: f32 "
              f"{dense_errs['f32'][1]:.3e}, bf16 {dense_errs['bf16'][1]:.3e}"
              f" (rel)", flush=True)
        reps_p = 5 if vdim == 1 else 3
        y_scratch = y_main.clone()
        main_ms, main_plain_ms = turns(lambda: op.launch_main(x),
                                       lambda: ck.cs_main_plain(op, x),
                                       50, reps_p)
        win_ms, win_plain_ms = turns(
            lambda: op.launch_window(x, y_scratch),
            lambda: ck.cs_window_plain(op, x, y_main), 50, reps_p)
        pair_ms, pair_plain_ms = turns(lambda: op.apply_flat(x),
                                       lambda: ck.cs_apply_plain(op, x),
                                       50, reps_p)
        dense_ms, _ = turns(lambda: dense.apply_flat(x),
                            lambda: dense.apply_flat(x), 50, 1)
        bf16_ms, _ = turns(lambda: dense_bf16.apply_flat(x),
                           lambda: dense_bf16.apply_flat(x), 50, 1)
        print(f"cs {label} ms: pair={pair_ms:.4f} cs_main={main_ms:.4f} "
              f"cs_window={win_ms:.4f} | plain pair={pair_plain_ms:.4f} "
              f"cs_main={main_plain_ms:.4f} cs_window={win_plain_ms:.4f} | "
              f"dense K1 f32={dense_ms:.4f} bf16={bf16_ms:.4f}", flush=True)
        for key, err, ms, plain_ms in (
                (f"cs_main_v{vdim}", err_main, main_ms, main_plain_ms),
                (f"cs_window_v{vdim}", err_win, win_ms, win_plain_ms),
                (f"v{vdim}_f32", dense_errs["f32"][0], None, None),
                (f"v{vdim}_bf16", dense_errs["bf16"][0], None, None)):
            res = results.setdefault(key, {"max_abs_err": 0.0})
            res["max_abs_err"] = max(res["max_abs_err"], err)
            if ms is not None and "ms" not in res:
                res.update(ms=ms, plain_ms=plain_ms)
        del op, dense, dense_bf16, x, y_main, y_pair, y_dense, y_bf16
        del y_scratch, mesh, sysm
        torch.cuda.empty_cache()
    # the main paths start cold, as a user's first solve does
    linsolve._PREP_CACHE.clear()
    return results


def check_built(ck, built, label: str) -> None:
    """Every CS operator a main-path run built (each MG level, the
    projection), held against its plain version at its own shape."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    worst = 0.0
    for shape, op in built:
        if op is None:
            continue
        x = torch.randn((op.vdim, op.N), generator=gen, device="cuda")
        _, y_pair, _, err_win = cs_against_plain(
            ck, op, x, f"{label} CS operator at {shape} (v{op.vdim})")
        worst = max(worst, err_win / float(y_pair.abs().max()))
    print(f"{label}: {sum(op is not None for _, op in built)} CS operators "
          f"held against plain, worst relative error {worst:.3e}",
          flush=True)


def field(result):
    import numpy as np

    from pde_solver_tpu_torch.fields import load_field

    f = load_field(result.data_file)
    return (np.asarray(f.values, dtype=np.float64),
            np.asarray(f.times, dtype=np.float64))


def heat_matrices(mesh, pairs, dt=None, theta=1.0, weight_fn=None,
                  quad_degree=4):
    """A heat problem's float64 matrices as scipy CSR, assembled as
    ``models.heat.solve_heat_problem`` assembles them (κ = 1): the implicit
    operator A = M + θΔt·K masked (Dirichlet rows and columns zeroed, 1 on
    their diagonal), the explicit B = M − (1−θ)Δt·K, the free mask, the
    Dirichlet values g and the lift A·g with A unmasked.  ``dt=None`` gives
    the steady system: A = K, no B."""
    import numpy as np
    import scipy.sparse as sp

    from pde_solver_tpu_torch.ops import assembly
    from pde_solver_tpu_torch.ops.bc import DirichletBC

    weighted = weight_fn is not None
    K = assembly.assemble_scalar_stencil(
        mesh, "stiffness", weight_fn=weight_fn,
        quad_degree=quad_degree if weighted else 2)
    M = assembly.assemble_scalar_stencil(
        mesh, "mass", weight_fn=weight_fn,
        quad_degree=max(quad_degree, 2) if weighted else 2)
    shape = mesh.node_shape
    N = int(np.prod(shape))
    strides = np.cumprod((1,) + tuple(shape[::-1]))[:-1][::-1]
    node = np.arange(N)

    def csr(stencil):
        rows, cols, vals = [], [], []
        for off, W in stencil.items():
            c = node + int(np.dot(off, strides))
            ok = (c >= 0) & (c < N)
            rows.append(node[ok])
            cols.append(c[ok])
            vals.append(np.asarray(W, np.float64).reshape(-1)[ok])
        return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                     np.concatenate(cols))),
                             shape=(N, N))

    Kc = csr(K)
    if dt is None:
        A, B = Kc, None
    else:
        Mc = csr(M)
        A = Mc + (theta * dt) * Kc
        B = (Mc - ((1.0 - theta) * dt) * Kc).tocsr()
    bc = DirichletBC.from_masks(pairs, shape)
    free = np.asarray(bc.free_mask, np.float64).reshape(-1)
    g = (np.asarray(bc.values, np.float64) * (1.0 - bc.free_mask)).reshape(-1)
    P = sp.diags(free)
    A_masked = (P @ A @ P + sp.diags(1.0 - free)).tocsr()
    return A_masked, B, free, g, A @ g


def heat_load(mesh, source, weight_fn=None, quad_degree=4):
    """Flat float64 load of a constant source, as the heat tools assemble
    it."""
    from pde_solver_tpu_torch.ops import assembly

    return source * assembly.assemble_load(
        mesh, weight_fn=weight_fn, quad_degree=quad_degree).reshape(-1)


def heat_steady_f64(mesh, pairs, source=0.0, weight_fn=None, quad_degree=4):
    """Float64 steady heat solve on the host (sparse LU); flat [N]."""
    import scipy.sparse.linalg as spla

    from pde_solver_tpu_torch.mesh import flatten_values

    A, _, free, g, Ag = heat_matrices(mesh, pairs, None,
                                      weight_fn=weight_fn,
                                      quad_degree=quad_degree)
    b = heat_load(mesh, source, weight_fn, quad_degree)
    u = spla.spsolve(A.tocsc(), free * (b - Ag) + g)
    return flatten_values(u.reshape(mesh.node_shape), mesh.dim)


def theta_scheme_f64(mesh, pairs, dt, num_steps, theta=1.0, T_initial=20.0,
                     source=0.0, weight_fn=None, quad_degree=4, device=None):
    """Float64 θ-scheme of a heat transient: per step, solve the masked
    M + θΔt·K with the right side free ⊙ (B uⁿ + Δt·b − A g) + g.  On the
    host (no ``device``) by scipy sparse LU; on ``device`` by Jacobi-PCG on
    torch sparse CSR, warm-started, to a true relative residual ≤ 1e-12.
    Returns the flat trajectory [num_steps + 1, N]."""
    import numpy as np
    import scipy.sparse.linalg as spla

    from pde_solver_tpu_torch.mesh import flatten_values

    A, B, free, g, Ag = heat_matrices(mesh, pairs, dt, theta, weight_fn,
                                      quad_degree)
    b = dt * heat_load(mesh, source, weight_fn, quad_degree)
    lift = b - Ag
    u = T_initial * free + g
    frames = [u]
    if device is None:
        lu = spla.splu(A.tocsc())
        for _ in range(num_steps):
            u = lu.solve(free * (B @ u + lift) + g)
            frames.append(u)
    else:
        import torch

        def dev_csr(S):
            return torch.sparse_csr_tensor(
                torch.from_numpy(S.indptr.astype(np.int64)),
                torch.from_numpy(S.indices.astype(np.int64)),
                torch.from_numpy(S.data), size=S.shape,
                dtype=torch.float64).to(device)

        Ad, Bd = dev_csr(A), dev_csr(B)
        dinv = torch.from_numpy(1.0 / A.diagonal()).to(device)
        fr, gd, ld = (torch.from_numpy(a).to(device) for a in (free, g, lift))

        def mv(S, v):
            return (S @ v[:, None])[:, 0]

        x = torch.from_numpy(u).to(device)
        iters = 0
        for _ in range(num_steps):
            b = fr * (mv(Bd, x) + ld) + gd
            bn = float(torch.linalg.vector_norm(b))
            r = b - mv(Ad, x)
            z = dinv * r
            p, rz = z, torch.dot(r, z)
            for it in range(1, 20001):
                Ap = mv(Ad, p)
                alpha = rz / torch.dot(p, Ap)
                x = x + alpha * p
                r = r - alpha * Ap
                if it % 25 == 0 and float(torch.linalg.vector_norm(
                        b - mv(Ad, x))) <= 1e-12 * bn:
                    break
                z = dinv * r
                rz_new = torch.dot(r, z)
                p, rz = z + (rz_new / rz) * p, rz_new
            relres = float(torch.linalg.vector_norm(b - mv(Ad, x))) / bn
            check(relres <= 1e-12, f"float64 reference step: relres "
                  f"{relres:.3e} after {it} iterations")
            iters += it
            frames.append(x.cpu().numpy())
        print(f"float64 reference {mesh.n_cells} cells: {iters} PCG "
              f"iterations over {num_steps} steps", flush=True)
        del Ad, Bd
    return np.stack([flatten_values(f.reshape(mesh.node_shape), mesh.dim)
                     for f in frames])


def spy_cs_builds(ck):
    """Record (node_shape, operator or None) of every CS build; returns
    the list."""
    built = []
    orig = ck.CSFlatStencilOperator.try_build.__func__

    def spy(cls, offsets, weights_np, node_shape, *a, **kw):
        op = orig(cls, offsets, weights_np, node_shape, *a, **kw)
        built.append((tuple(int(s) for s in node_shape), op))
        return op

    ck.CSFlatStencilOperator.try_build = classmethod(spy)
    return built


def spy_flat_launches(sk):
    """Record every FlatStencilOperator that launches its kernel, once
    each; returns the dict (id -> operator) it fills."""
    launched = {}
    orig = sk.FlatStencilOperator._launch

    def spy(self, x):
        launched.setdefault(id(self), self)
        return orig(self, x)

    sk.FlatStencilOperator._launch = spy
    return launched


def check_launched(sk, launched, label: str, results) -> None:
    """Every dense operator a main-path run launched (each MG level and
    weight dtype, each step operator, the projection), held against its
    plain version at its own shape on a random input, relative max error
    ≤ REL_TOL; the worst absolute errors go into ``results``.  Empties
    ``launched``."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    seen = {}
    for op in launched.values():
        x = torch.randn((op.vdim, op.N), generator=gen, device="cuda")
        y = op.apply_flat(x)
        y_plain = sk.spmv_plain(op.W, x, op.deltas, op.vdim)
        rel = rel_err(y, y_plain)
        check(rel <= REL_TOL, f"{label}: {op.variant} at {op.node_shape} "
              f"({op.n_off} offsets) vs plain relative max error {rel:.3e}")
        res = results.setdefault(op.variant, {"max_abs_err": 0.0})
        res["max_abs_err"] = max(res["max_abs_err"],
                                 float((y - y_plain).abs().max()))
        worst, shapes = seen.get(op.variant, (0.0, []))
        seen[op.variant] = (max(worst, rel), shapes + [op.node_shape])
        del x, y, y_plain
    launched.clear()
    torch.cuda.empty_cache()
    print(f"{label}: launched dense operators held against plain: "
          + ("; ".join(f"{v} worst rel {w:.3e} at {sorted(set(sh))}"
                       for v, (w, sh) in sorted(seen.items())) or "none"),
          flush=True)


def plane_operator(cells, E=210e9, nu=0.3):
    """The scaled plane-stress elasticity operator (vdim=2, 7 offsets) of a
    unit plate on ``cells``, clamped at x = 0: the fine level of BASELINE
    config 4 and of the full-width plate."""
    import numpy as np

    from pde_solver_tpu_torch.mesh import rectangle_mesh
    from pde_solver_tpu_torch.models.elasticity import lame_parameters
    from pde_solver_tpu_torch.ops import assembly
    from pde_solver_tpu_torch.ops.bc import DirichletBC
    from pde_solver_tpu_torch.ops.linsolve import prepare_system

    mesh = rectangle_mesh(*cells, (0.0, 0.0), (1.0, 1.0))
    lam, mu = lame_parameters(E, nu, "plane_stress")
    K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=2)
    return mesh, prepare_system(K, mesh, bc,
                                np.zeros(mesh.node_shape + (2,)), 2)


def plane_kernel_phase(sk):
    """K1 at vdim=2 (f32 and bf16 weights) against its plain version on the
    scaled plane-stress operators of 257² and 1025² nodes, on V2_INPUTS
    random inputs, relative max error ≤ REL_TOL; the times are those at
    1025².  Also prints, and requires to lie above 10·REL_TOL, what two
    planted faults read: the plain version with one offset's weights
    dropped, and with the weights in the other precision (f32 <-> bf16)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    results = {name: {"max_abs_err": 0.0} for name, _ in V2_VARIANTS}
    for cells in V2_CELLS:
        mesh, sysm = plane_operator(cells)
        check(len(sysm.offsets) == 7, f"plane stencil has "
              f"{len(sysm.offsets)} offsets, expected 7")
        op32 = sk.FlatStencilOperator(sysm.offsets, sysm.weights,
                                      mesh.node_shape, vdim=2, device="cuda")
        xs = [torch.randn((2, op32.N), generator=gen, device="cuda")
              for _ in range(V2_INPUTS)]
        x = xs[0]
        for name, wdt in V2_VARIANTS:
            op = op32.as_weight_dtype(getattr(torch, wdt))
            y = op.apply_flat(x)
            torch.cuda.synchronize()
            check(op.launches == 1 and op.variant == name,
                  f"{name}: {op.launches} launches of {op.variant}")
            y_plain = sk.spmv_plain(op.W, x, op.deltas, 2)
            err = float((y - y_plain).abs().max())
            rels = [rel_err(y, y_plain)] + [
                rel_err(op.apply_flat(xi), sk.spmv_plain(op.W, xi, op.deltas, 2))
                for xi in xs[1:]]
            rel = max(rels)
            W_drop = op.W.clone()
            W_drop[:4] = 0.0                   # offset 0's v² weight planes
            W_other = op32.W.to(torch.bfloat16) if wdt == "float32" \
                else op32.W
            faults = (rel_err(y, sk.spmv_plain(W_drop, x, op.deltas, 2)),
                      rel_err(y, sk.spmv_plain(W_other, x, op.deltas, 2)))
            print(f"kernel {name} plane-stress nodes={mesh.node_shape}: rel "
                  f"err on {V2_INPUTS} inputs "
                  f"{' '.join(f'{r:.3e}' for r in rels)}; planted faults: "
                  f"offset 0 dropped {faults[0]:.3e}, weights in the other "
                  f"precision {faults[1]:.3e}", flush=True)
            check(rel <= REL_TOL, f"{name} at {mesh.node_shape}: kernel vs "
                  f"plain relative max error {rel:.3e} > {REL_TOL}")
            check(min(faults) > 10 * REL_TOL, f"{name}: a planted fault "
                  f"reads {min(faults):.3e}, within 10x the bound {REL_TOL}")
            del W_drop, W_other
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               err)
            ms, plain_ms = turns(lambda: op.apply_flat(x),
                                 lambda: sk.spmv_plain(op.W, x, op.deltas, 2),
                                 50, 10)
            w_bytes = op.W.numel() * op.W.element_size()
            print(f"kernel {name} plane-stress nodes={mesh.node_shape} "
                  f"N={op.N}: rel_err={rel:.3e} abs_err={err:.3e} "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f} W={w_bytes / 1e6:.1f}"
                  f" MB -> {w_bytes / ms / 1e6:.1f} GB/s", flush=True)
            results[name].update(ms=ms, plain_ms=plain_ms)
            del op, y, y_plain
        del op32, x, xs, mesh, sysm
        torch.cuda.empty_cache()
    return results


def spy_solves(elast):
    """Record (stencil, mesh, bc, rhs, vdim, x) of every solve the
    elasticity model makes; returns the list and the function that
    removes the spy."""
    calls = []
    orig = elast.solve_stencil_system

    def spy(K, mesh, bc, b, vdim=1, **kw):
        x, stats = orig(K, mesh, bc, b, vdim=vdim, **kw)
        calls.append((K, mesh, bc, b, vdim, x))
        return x, stats

    elast.solve_stencil_system = spy
    return calls, lambda: setattr(elast, "solve_stencil_system", orig)


def host_relres(call) -> float:
    """‖b̂ − Â x̂‖/‖b̂‖ of a recorded solve, recomputed on the host in
    float64 on the scaled system the solver iterates on."""
    import numpy as np

    from pde_solver_tpu_torch.ops.linsolve import (np_stencil_apply,
                                                   prepare_system)

    K, mesh, bc, b, vdim, x = call
    sysm = prepare_system(K, mesh, bc, b, vdim)
    r = sysm.b_hat - np_stencil_apply(dict(zip(sysm.offsets, sysm.weights)),
                                      sysm.to_hat_x(x), mesh.dim, vdim)
    return float(np.linalg.norm(r.reshape(-1))
                 / np.linalg.norm(sysm.b_hat.reshape(-1)))


def against_host_lu(api, drive, label, tool, kw, data_dir, wanted):
    """Run an elasticity tool on the card, then the same call by host
    sparse LU (float64, exact); returns max|Δ|/max of the two fields and
    the card run's stats."""
    import numpy as np

    from pde_solver_tpu_torch.config import config_overrides

    res, st, launches = drive(label, lambda: getattr(api, tool)(
        **kw, data_dir=data_dir))
    with config_overrides(device="cpu", host_direct_threshold=10 ** 9):
        r_lu = getattr(api, tool)(**kw, data_dir=data_dir)
    v, v_lu = field(res)[0], field(r_lu)[0]
    gap = float(np.abs(v - v_lu).max() / np.abs(v_lu).max())
    print(f"{label}: vs host sparse LU max|Δ|/max={gap:.3e}", flush=True)
    check(bool(st["converged"]), f"{label} did not converge: {st}")
    check(bool(np.all(np.isfinite(v))), f"{label}: non-finite values")
    check(gap <= ELAST_LU_TOL, f"{label} off host sparse LU by {gap:.3e}")
    for name in wanted:
        check(launches.get(name, 0) > 0, f"{label} launched no {name}")
    return gap, st


def baseline_phase(api, drive, data_dir, plate_full=PLATE_FULL):
    """BASELINE configs 1-4 and the full-width plate through the API, each
    held against its analytic or float64 host reference."""
    import numpy as np

    from pde_solver_tpu_torch.config import config_overrides
    from pde_solver_tpu_torch.mesh import interval_mesh, rectangle_mesh
    from pde_solver_tpu_torch.models import elasticity as elast

    # config 1: 2 m rod, 256 nodes, 20 -> 0 °C, 400 backward-Euler steps
    res, st, launches = drive("BASELINE 1 heat 1D", lambda: api.solve_heat_1D(
        **HEAT1D, data_dir=data_dir))
    T, times = field(res)
    x = np.linspace(0.0, 2.0, 256)
    line = 20.0 * (1.0 - x / 2.0)
    err_line = float(np.linalg.norm(T[-1] - line) / np.linalg.norm(line))
    mesh = interval_mesh(255, 0.0, 2.0)
    T_ref = theta_scheme_f64(mesh, [(mesh.face_mask(0, 0), 20.0),
                                    (mesh.face_mask(0, 1), 0.0)],
                             0.05, 400, T_initial=0.0)
    gap = float(np.abs(T - T_ref).max() / np.abs(T_ref).max())
    print(f"BASELINE 1 heat 1D: steps/s={400 / st['scan_seconds']:.3f} "
          f"CG iterations/step={st['cg_iterations'] / 400:.2f} steady-limit "
          f"relL2={err_line:.3e} vs host f64 backward Euler max|ΔT|/max|T|="
          f"{gap:.3e}", flush=True)
    check(T.shape == (401, 256) and times.shape == (401,),
          f"heat 1D field {T.shape}")
    check(bool(st["converged"]), f"heat 1D did not converge: {st}")
    check(err_line <= HEAT1D_TOL, f"heat 1D steady limit {err_line:.3e}")
    check(gap <= HEAT1D_TOL, f"heat 1D off float64 by {gap:.3e}")
    check(launches.get("v1_f32", 0) > 0, "heat 1D launched no v1_f32")

    # config 2: 2 m aluminium bar, host sparse LU (never touches the card)
    res, st, launches = drive("BASELINE 2 bar 1D (host sparse LU, no card)",
                              lambda: api.solve_elasticity_1D_static(
                                  **BAR, data_dir=data_dir))
    sig = field(res)[0][0]
    x = np.linspace(0.0, 2.0, 256)
    exact = 500.0 * (2.0 - x) / 0.01
    err = float(np.abs(sig[10:-10] - exact[10:-10]).max() / exact.max())
    print(f"BASELINE 2 bar 1D: solve_seconds={st['solve_seconds']:.6f} "
          f"interior stress error {err:.3e} (host sparse LU, no card: "
          f"launches={launches})", flush=True)
    check(bool(st["converged"]) and err <= 1e-6,
          f"bar 1D interior stress error {err:.3e}")
    check(not launches, f"bar 1D launched kernels: {launches}")

    # config 3: 1 m² plate, 128², 50 Crank-Nicolson steps
    with config_overrides(theta=0.5):
        res, st, launches = drive("BASELINE 3 heat 2D CN",
                                  lambda: api.solve_heat_2D(
                                      **HEAT2D, data_dir=data_dir))
    T, _ = field(res)
    mesh = rectangle_mesh(128, 128, (0.0, 0.0), (1.0, 1.0))
    T_ref = theta_scheme_f64(mesh, [(mesh.boundary_mask(), 0.0)], 0.001, 50,
                             theta=0.5, T_initial=20.0)
    gap = float(np.abs(T - T_ref).max() / np.abs(T_ref).max())
    print(f"BASELINE 3 heat 2D CN: steps/s={50 / st['scan_seconds']:.3f} "
          f"CG iterations/step={st['cg_iterations'] / 50:.2f} vs host f64 "
          f"Crank-Nicolson max|ΔT|/max|T|={gap:.3e}", flush=True)
    check(T.shape == (51, 129 * 129), f"heat 2D field {T.shape}")
    check(bool(st["converged"]), f"heat 2D did not converge: {st}")
    check(gap <= HEAT2D_CN_TOL, f"heat 2D off float64 by {gap:.3e}")
    check(launches.get("v1_f32", 0) > 0, "heat 2D launched no v1_f32")

    # config 4 and the full-width plate, the second held by its relres
    calls, unspy = spy_solves(elast)
    try:
        against_host_lu(api, drive, "BASELINE 4 plane stress 256^2",
                        "solve_elasticity_2D_static", PLATE, data_dir,
                        ("v2_f32", "v2_bf16", "v1_f32"))
        rr4 = host_relres(calls[0])
        del calls[:]
        res, st, launches = drive(
            f"plane stress {plate_full['nx']}^2", lambda:
            api.solve_elasticity_2D_static(**plate_full, data_dir=data_dir))
        t0 = time.perf_counter()
        rr = host_relres(calls[0])
        n = (plate_full["nx"] + 1) * (plate_full["ny"] + 1)
    finally:
        unspy()
    vm = field(res)[0]
    print(f"plane stress {plate_full['nx']}^2: relres recomputed on the host "
          f"in f64 {rr:.3e} ({time.perf_counter() - t0:.3f} s; BASELINE 4: "
          f"{rr4:.3e}); max_von_mises={np.abs(vm).max():.6e} Pa", flush=True)
    check(st["num_dofs"] == 2 * n, f"plate dof count {st['num_dofs']}")
    check(bool(st["converged"]) and rr <= 1e-6 and rr4 <= 1e-6,
          f"plate relres {rr:.3e}, BASELINE 4 {rr4:.3e}: {st}")
    check(vm.shape == (1, n) and bool(np.all(np.isfinite(vm))),
          f"plate field {vm.shape}")
    for name in ("v2_f32", "v2_bf16", "v1_f32"):
        check(launches.get(name, 0) > 0, f"the plate launched no {name}")


def loaded_phase(api, drive, data_dir):
    """The three _loaded tools: 2D and 3D against host sparse LU, the bar
    against σ = P/A."""
    import numpy as np

    against_host_lu(api, drive, "loaded 2D 256^2",
                    "solve_elasticity_2D_loaded",
                    dict(PLATE, loads={"right": {"type": "traction",
                                                 "vector": [0.0, -1e6]}}),
                    data_dir, ("v2_f32", "v2_bf16"))
    against_host_lu(api, drive, "loaded 3D 16x8x8",
                    "solve_elasticity_3D_loaded", LOADED_3D, data_dir,
                    ("v3_f32",))
    res, st, launches = drive("loaded 1D (host sparse LU, no card)",
                              lambda: api.solve_elasticity_1D_loaded(
                                  **LOADED_1D, data_dir=data_dir))
    sig = field(res)[0]
    want = LOADED_1D["end_load"] / LOADED_1D["area"]
    err = float(np.abs(sig - want).max() / want)
    print(f"loaded 1D: max|σ - P/A|/(P/A)={err:.3e}", flush=True)
    check(bool(st["converged"]) and err <= 1e-9, f"loaded 1D error {err:.3e}")


def curvilinear_phase(api, drive, data_dir):
    """The five curvilinear heat tools on the card: the steady 1D ones
    against their closed forms, the 2D and 3D ones at their sizes by
    default, steady and transient, against a float64 host solve of the same
    system, once at their defaults (T_boundary = T_initial, so the answer is
    the constant 20) and once with a constant source."""
    import numpy as np

    from pde_solver_tpu_torch.config import config_overrides
    from pde_solver_tpu_torch.mesh import (box_mesh, interval_mesh,
                                           rectangle_mesh)
    from pde_solver_tpu_torch.models import heat

    # host_direct_threshold=0: the steady solves run on the card too
    with config_overrides(host_direct_threshold=0):
        mesh = interval_mesh(50, 0.1, 1.0)
        r = mesh.axis_nodes(0)
        pairs = [(mesh.face_mask(0, 0), 100.0), (mesh.face_mask(0, 1), 20.0)]
        for tool, exact, wfn, deg in (
                ("solve_heat_1D_cylindrical",
                 20.0 + (20.0 - 100.0) / np.log(10.0) * np.log(r),
                 heat.weight_r, 3),
                ("solve_heat_1D_spherical",
                 20.0 - 80.0 / 9.0 + (80.0 / 9.0) / r, heat.weight_r2, 4)):
            res, st, launches = drive(f"{tool} steady", lambda: getattr(
                api, tool)(steady=True, data_dir=data_dir))
            T = field(res)[0][0]
            err = float(np.abs(T - exact).max() / 100.0)
            gap = float(np.abs(T - heat_steady_f64(mesh, pairs, 0.0, wfn, deg))
                        .max() / 100.0)
            print(f"{tool} steady: vs closed form {err:.3e} (P1 "
                  f"discretisation), vs host f64 {gap:.3e}", flush=True)
            check(bool(st["converged"]) and gap <= 1e-6,
                  f"{tool} off the float64 solve by {gap:.3e}")
            check(err <= CLOSED_FORM_TOL,
                  f"{tool} off its closed form by {err:.3e}")
            check(launches.get("v1_f32", 0) > 0, f"{tool}: no v1_f32")
        cases = (
            ("solve_heat_2D_cylindrical",
             rectangle_mesh(30, 30, (0.1, 0.0), (1.0, 2.0)), heat.weight_r, 3),
            ("solve_heat_2D_spherical",
             rectangle_mesh(30, 30, (0.1, 0.0), (1.0, np.pi)),
             heat.weight_r2_sin_theta, 6),
            ("solve_heat_3D_spherical",
             box_mesh(20, 20, 20, (0.1, 0.0, 0.0), (1.0, np.pi, 2 * np.pi)),
             heat.weight_r2_sin_theta, 6))
        for tool, mesh, wfn, deg in cases:
            pairs = [(mesh.boundary_mask(), 20.0)]
            for source in (0.0, 100.0):
                kw = dict(source_type="constant", source_value=source) \
                    if source else {}
                res, st, launches = drive(
                    f"{tool} steady source={source}", lambda: getattr(
                        api, tool)(steady=True, **kw, data_dir=data_dir))
                T = field(res)[0][0]
                T_ref = heat_steady_f64(mesh, pairs, source, wfn, deg)
                gap_s = float(np.abs(T - T_ref).max() / np.abs(T_ref).max())
                res, st_t, launches_t = drive(
                    f"{tool} transient source={source}", lambda: getattr(
                        api, tool)(**kw, data_dir=data_dir))
                Tt = field(res)[0]
                Tt_ref = theta_scheme_f64(mesh, pairs, 0.01, 50,
                                          T_initial=20.0, source=source,
                                          weight_fn=wfn, quad_degree=deg)
                gap_t = float(np.abs(Tt - Tt_ref).max()
                              / np.abs(Tt_ref).max())
                print(f"{tool} source={source}: steady vs host f64 "
                      f"{gap_s:.3e}, transient (50 steps) vs host f64 "
                      f"{gap_t:.3e}", flush=True)
                check(bool(st["converged"]) and gap_s <= 1e-6,
                      f"{tool} steady off float64 by {gap_s:.3e}")
                check(bool(st_t["converged"]) and gap_t <= CURV_TRANSIENT_TOL,
                      f"{tool} transient off float64 by {gap_t:.3e}")
                check(Tt.shape == (51, mesh.num_nodes), f"{tool} {Tt.shape}")
                for lc in (launches, launches_t):
                    check(lc.get("v1_f32", 0) > 0, f"{tool}: no v1_f32")


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np

    # the solver logs its hierarchy / ladder / df2-round / transient
    # seconds to stderr
    os.environ.setdefault("PDE_TPU_LOG_LEVEL", "INFO")
    root = os.path.dirname(os.path.abspath(__file__))
    os.environ.setdefault("PDE_TPU_CACHE_DIR",
                          os.path.join(root, "build", "chip_smoke_cache"))
    from pde_solver_tpu_torch import api
    from pde_solver_tpu_torch.config import config_overrides
    from pde_solver_tpu_torch.mesh import box_mesh
    from pde_solver_tpu_torch.ops import assembly, cuda_build
    from pde_solver_tpu_torch.ops import cs_kernels as ck
    from pde_solver_tpu_torch.ops import stencil_kernels as sk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind}", flush=True)
    print(card_line, flush=True)
    data_dir = os.path.join(root, "build", "chip_smoke")

    # -- build: one nvcc per source, all at once ----------------------------
    t0 = time.perf_counter()
    cuda_build.build("flat_stencil_spmv", "cs_stencil")
    sk.build_library()
    ck.build_library()
    print(f"phase build: {time.perf_counter() - t0:.3f} s", flush=True)
    for name, info in cuda_build.BUILD_INFO.items():
        print(f"  {name}: {info['seconds']:.3f} s ({info['path']})")
        for line in str(info.get("log", "")).splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "error")):
                print(f"  ptxas: {line.strip()}", flush=True)

    # -- dense kernel against plain ----------------------------------------
    t0 = time.perf_counter()
    tiny = box_mesh(2, 2, 2, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    offsets = tuple(sorted(assembly.assemble_elasticity_stencil(tiny, 1.0, 1.0)))
    check(len(offsets) == 15, f"expected 15 stencil offsets, got {len(offsets)}")
    kernels = kernel_phase(sk, offsets)
    torch.cuda.empty_cache()
    print(f"phase kernels: {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    kernels.update(plane_kernel_phase(sk))
    print(f"phase plane-kernels: {time.perf_counter() - t0:.3f} s", flush=True)

    # -- constant-interior pair against plain and dense ----------------------
    t0 = time.perf_counter()
    for key, res in cs_phase(ck, sk).items():
        if key in kernels:     # the dense variants keep their times
            kernels[key]["max_abs_err"] = max(kernels[key]["max_abs_err"],
                                              res["max_abs_err"])
        else:
            kernels[key] = res
    print(f"phase cs-kernels: {time.perf_counter() - t0:.3f} s", flush=True)

    # -- small cantilever against the host sparse-LU solve -----------------
    t0 = time.perf_counter()
    with config_overrides(device="cuda", precision="mixed",
                          host_direct_threshold=0, mg_threshold=100):
        r_dev = api.solve_elasticity_3D_static(**SMALL, data_dir=data_dir)
    with config_overrides(device="cpu", host_direct_threshold=10 ** 9):
        r_lu = api.solve_elasticity_3D_static(**SMALL, data_dir=data_dir)
    vm_dev, vm_lu = field(r_dev)[0], field(r_lu)[0]
    gap = float(np.abs(vm_dev - vm_lu).max() / np.abs(vm_lu).max())
    st = r_dev.meta["solver_stats"]
    print(f"phase small-check: {time.perf_counter() - t0:.3f} s; 16x8x8 "
          f"cantilever on the card vs host sparse LU: max|Δvm|/max|vm|="
          f"{gap:.3e}, iterations={st['cg_iterations']}, "
          f"relres={st['relative_residual']:.3e}", flush=True)
    check(st["converged"], f"small cantilever did not converge: {st}")
    check(gap <= 1e-6, f"small cantilever von Mises off by {gap:.3e}")

    # -- small heat transient (MG + CS) against host float64 backward Euler --
    t0 = time.perf_counter()
    built = spy_cs_builds(ck)
    os.environ["PDE_TPU_CS"] = "1"
    sk.reset_launch_counts()
    with config_overrides(device="cuda", precision="mixed",
                          transient_mg_threshold=100, mg_threshold=100,
                          transient_inner_tol=1e-8):
        r_heat = api.solve_heat_3D(**SMALL_HEAT, data_dir=data_dir)
    os.environ["PDE_TPU_CS"] = "0"
    T_dev = field(r_heat)[0]
    small_mesh = box_mesh(*SMALL_HEAT_CELLS, (0.0, 0.0, 0.0), (1.0, 0.2, 0.2))
    T_host = theta_scheme_f64(small_mesh, [(small_mesh.boundary_mask(), 0.0)],
                              0.01, SMALL_HEAT["num_steps"])
    gap = float(np.abs(T_dev - T_host).max() / np.abs(T_host).max())
    st = r_heat.meta["solver_stats"]
    small_launches = dict(sk.KERNEL_LAUNCHES)
    print(f"phase small-heat: {time.perf_counter() - t0:.3f} s; 40x6x6 heat, "
          f"5 steps, MG-PCG + CS on the card vs host f64 backward Euler: "
          f"max|ΔT|/max|T|={gap:.3e}, iterations={st['cg_iterations']}, "
          f"relres={st['relative_residual']:.3e}, CS builds="
          f"{[(s, op is not None) for s, op in built]}, "
          f"launches={small_launches}", flush=True)
    check(st["converged"], f"small heat did not converge: {st}")
    check(gap <= 1e-6, f"small heat off the host solve by {gap:.3e}")
    check((41, 7, 7) in {s for s, op in built if op is not None},
          "small heat: no CS operator at the fine level")
    check(small_launches.get("cs_main_v1", 0) > 0
          and small_launches.get("cs_window_v1", 0) > 0,
          "small heat launched no CS kernels")

    # -- main paths through the API ------------------------------------------
    main_launches = {}
    launched = spy_flat_launches(sk)

    def main_path(label, cs, fn):
        """One main-path run: counts 0 just before, read just after; then
        every dense operator it launched is held against plain."""
        os.environ["PDE_TPU_CS"] = cs
        del built[:]
        launched.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sk.reset_launch_counts()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(sk.KERNEL_LAUNCHES)
        os.environ["PDE_TPU_CS"] = "0"
        for k, v in launches.items():
            main_launches[k] = main_launches.get(k, 0) + v
        st = res.meta["solver_stats"]
        print(f"phase {label}: {wall:.3f} s wall; "
              + " ".join(f"{k}={v:.3f}" for k, v in st.items()
                         if k.endswith("_seconds")), flush=True)
        print(f"{label}: dof={st['num_dofs']} iterations={st['cg_iterations']}"
              f" relres={st['relative_residual']:.3e} "
              f"converged={st['converged']} peak_device_mem="
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"cs_builds={[(s, op is not None) for s, op in built]} "
              f"launches={launches}", flush=True)
        check_launched(sk, launched, label, kernels)
        cs_built = list(built)
        del built[:]
        return res, st, launches, cs_built

    vm_runs = {}
    for cs in ("0", "1"):
        with config_overrides(device="cuda"):
            res, st, launches, cs_built = main_path(
                f"flagship PDE_TPU_CS={cs}", cs,
                lambda: api.solve_elasticity_3D_static(**FLAGSHIP,
                                                       data_dir=data_dir))
        vm = field(res)[0]
        vm_runs[cs] = vm
        print(f"flagship PDE_TPU_CS={cs}: max_von_mises="
              f"{np.abs(vm).max():.6e} Pa", flush=True)
        check(st["num_dofs"] == 2_040_675, f"dof count {st['num_dofs']}")
        check(bool(st["converged"]), f"flagship did not converge: {st}")
        check(st["relative_residual"] <= 1e-6,
              f"flagship relres {st['relative_residual']:.3e} > 1e-6")
        check(vm.shape == (1, 161 * 65 * 65), f"field shape {vm.shape}")
        check(bool(np.all(np.isfinite(vm))), "non-finite von Mises values")
        wanted = (("cs_main_v3", "cs_window_v3") if cs == "1"
                  else ("v3_f32", "v3_bf16", "v1_f32"))
        for name in wanted:
            check(launches.get(name, 0) > 0,
                  f"the flagship (PDE_TPU_CS={cs}) launched no {name} kernel")
        if cs == "1":
            check((161, 65, 65) in {s for s, op in cs_built if op is not None},
                  "flagship: no CS operator at the fine level")
            check_built(ck, cs_built, "flagship")
        del cs_built
    gap = float(np.abs(vm_runs["1"] - vm_runs["0"]).max()
                / np.abs(vm_runs["0"]).max())
    print(f"flagship CS vs dense: max|Δvm|/max|vm|={gap:.3e}", flush=True)
    check(gap <= 1e-5, f"flagship CS and dense routes differ by {gap:.3e}")
    del vm_runs

    T_runs = {}
    for cs in ("0", "1"):
        with config_overrides(device="cuda"):
            res, st, launches, cs_built = main_path(
                f"heat PDE_TPU_CS={cs}", cs,
                lambda: api.solve_heat_3D(**HEAT, data_dir=data_dir))
        T, times = field(res)
        os.remove(res.data_file)
        T_runs[cs] = T
        target = st["convergence_target"]
        print(f"heat PDE_TPU_CS={cs}: steps/s="
              f"{HEAT_STEPS / st['scan_seconds']:.3f} CG iterations/step="
              f"{st['cg_iterations'] / HEAT_STEPS:.2f} max|T|_final="
              f"{np.abs(T[-1]).max():.6e} CS levels="
              f"{[s for s, op in cs_built if op is not None]}", flush=True)
        check(st["num_dofs"] == HEAT_DOF, f"heat dof count {st['num_dofs']}")
        check(bool(st["converged"]) and st["relative_residual"] <= target,
              f"heat (PDE_TPU_CS={cs}) did not converge: {st}")
        check(T.shape == (HEAT_STEPS + 1, HEAT_DOF), f"heat field {T.shape}")
        check(bool(np.all(np.isfinite(T))), "non-finite temperatures")
        check(times.shape == (HEAT_STEPS + 1,), f"heat times {times.shape}")
        wanted = (("cs_main_v1", "cs_window_v1") if cs == "1"
                  else ("v1_f32", "v1_bf16"))
        for name in wanted:
            check(launches.get(name, 0) > 0,
                  f"the heat slice (PDE_TPU_CS={cs}) launched no {name}")
        if cs == "1":
            check((129, 129, 129) in {s for s, op in cs_built if op is not None},
                  "heat: no CS operator at the 129^3 fine level")
            check_built(ck, cs_built, "heat")
        else:
            check(not any(k.startswith("cs_") for k in launches),
                  "the dense heat run launched CS kernels")
        del cs_built
    t0 = time.perf_counter()
    heat_mesh = box_mesh(128, 128, 128, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    T_ref = theta_scheme_f64(heat_mesh, [(heat_mesh.boundary_mask(), 0.0)],
                             0.01, HEAT_STEPS, device="cuda")
    torch.cuda.empty_cache()
    gaps = {cs: float(np.abs(T - T_ref).max() / np.abs(T_ref).max())
            for cs, T in T_runs.items()}
    gap = float(np.abs(T_runs["1"] - T_runs["0"]).max()
                / np.abs(T_runs["0"]).max())
    print(f"heat: float64 reference {time.perf_counter() - t0:.3f} s; "
          f"max|ΔT|/max|T|: CS vs dense={gap:.3e}, dense vs f64="
          f"{gaps['0']:.3e}, CS vs f64={gaps['1']:.3e}", flush=True)
    check(gap <= HEAT_ROUTE_TOL,
          f"heat CS and dense routes differ by {gap:.3e}")
    for cs, g in gaps.items():
        check(g <= HEAT_F64_TOL, f"heat (PDE_TPU_CS={cs}) off the float64 "
              f"trajectory by {g:.3e}")

    # -- the 1D/2D, curvilinear and _loaded tools ----------------------------
    def drive(label, fn):
        res, st, launches, _ = main_path(label, "0", fn)
        return res, st, launches

    with config_overrides(device="cuda"):
        for name, phase in (("baselines", baseline_phase),
                            ("loaded", loaded_phase),
                            ("curvilinear", curvilinear_phase)):
            t0 = time.perf_counter()
            phase(api, drive, data_dir)
            print(f"phase {name}: {time.perf_counter() - t0:.3f} s",
                  flush=True)

    print(f"total: {time.perf_counter() - t_start:.3f} s", flush=True)
    print(card_line)
    entries = [(f"flat_stencil_spmv[{name}]", name, FLAT_SOURCE,
                REPLACES["flat"])
               for name in ("v3_f32", "v3_bf16", "v2_f32", "v2_bf16",
                            "v1_f32", "v1_bf16")]
    for v in (1, 3):
        for part in ("cs_main", "cs_window"):
            entries.append((f"{part}[v{v}]", f"{part}_v{v}", CS_SOURCE,
                            REPLACES[part]))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": repl,
         "launches": main_launches.get(key, 0),
         "max_abs_err": kernels[key]["max_abs_err"],
         "ms": kernels[key]["ms"], "plain_ms": kernels[key]["plain_ms"]}
        for name, key, source, repl in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
