#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pde_solver_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Asserts a CUDA card and prints its name and power limit (nvidia-smi).
2. Builds both kernel sources from ``pde_solver_tpu_torch/csrc`` with nvcc
   for sm_90a, in parallel, and prints the build seconds and every
   kernel's ptxas report.
3. Dense SpMV (``flat_stencil_spmv``): holds each variant (vdim=3 f32,
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
   routes agree, and that each run launched its kernels.  Every
   constant-interior operator a run built (each MG level, the projection)
   is then held against its plain version at its own shape.  Both heat
   trajectories are held against a float64 backward Euler of the same
   system, solved on the card with sparse Jacobi-PCG to 1e-12.

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


def heat_matrices(cells, extent, dt):
    """The heat transient's float64 matrices as scipy CSR: the masked
    M + Δt·K (identity rows on the boundary, which holds T = 0) and M."""
    import numpy as np
    import scipy.sparse as sp

    from pde_solver_tpu_torch.mesh import box_mesh
    from pde_solver_tpu_torch.ops import assembly

    mesh = box_mesh(*cells, (0.0, 0.0, 0.0), extent)
    shape = mesh.node_shape
    N = int(np.prod(shape))
    strides = np.cumprod((1,) + tuple(shape[::-1]))[:-1][::-1]
    node = np.arange(N)
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    free = (~mesh.boundary_mask()).reshape(-1).astype(np.float64)
    rows, cols, a_vals, m_vals = [], [], [], []
    for off in K:
        c = node + int(np.dot(off, strides))
        ok = (c >= 0) & (c < N)
        rows.append(node[ok])
        cols.append(c[ok])
        a_vals.append((np.asarray(M[off]) + dt * np.asarray(K[off]))
                      .reshape(-1)[ok])
        m_vals.append(np.asarray(M[off]).reshape(-1)[ok])
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    a_vals = np.concatenate(a_vals) * free[rows] * free[cols]
    A = sp.csr_matrix((a_vals, (rows, cols)), shape=(N, N)) \
        + sp.diags(1.0 - free)
    Mm = sp.csr_matrix((np.concatenate(m_vals), (rows, cols)), shape=(N, N))
    return mesh, A.tocsr(), Mm, free


def backward_euler_f64(cells, extent, dt, num_steps, T_initial=20.0,
                       device=None):
    """Float64 backward Euler of the heat transient: per step, solve the
    masked M + Δt·K with the right side free ⊙ (M uⁿ).  On the host (no
    ``device``) by scipy sparse LU; on ``device`` by Jacobi-PCG on torch
    sparse CSR, warm-started, to a true relative residual ≤ 1e-12.
    Returns the flat trajectory [num_steps + 1, N]."""
    import numpy as np
    import scipy.sparse.linalg as spla

    from pde_solver_tpu_torch.mesh import flatten_values

    mesh, A, Mm, free = heat_matrices(cells, extent, dt)
    u = T_initial * free
    frames = [u]
    if device is None:
        lu = spla.splu(A.tocsc())
        for _ in range(num_steps):
            u = lu.solve(free * (Mm @ u))
            frames.append(u)
    else:
        import torch

        def dev_csr(S):
            return torch.sparse_csr_tensor(
                torch.from_numpy(S.indptr.astype(np.int64)),
                torch.from_numpy(S.indices.astype(np.int64)),
                torch.from_numpy(S.data), size=S.shape,
                dtype=torch.float64).to(device)

        Ad, Md = dev_csr(A), dev_csr(Mm)
        dinv = torch.from_numpy(1.0 / A.diagonal()).to(device)
        fr = torch.from_numpy(free).to(device)

        def mv(S, v):
            return (S @ v[:, None])[:, 0]

        x = torch.from_numpy(u).to(device)
        iters = 0
        for _ in range(num_steps):
            b = fr * mv(Md, x)
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
        print(f"float64 reference {tuple(cells)} cells: {iters} PCG "
              f"iterations over {num_steps} steps", flush=True)
        del Ad, Md
    return np.stack([flatten_values(f.reshape(mesh.node_shape), 3)
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
    T_host = backward_euler_f64(SMALL_HEAT_CELLS, (1.0, 0.2, 0.2), 0.01,
                                SMALL_HEAT["num_steps"])
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

    def main_path(label, cs, fn):
        """One main-path run: counts 0 just before, read just after."""
        os.environ["PDE_TPU_CS"] = cs
        del built[:]
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
    T_ref = backward_euler_f64((128, 128, 128), (1.0, 1.0, 1.0), 0.01,
                               HEAT_STEPS, device="cuda")
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

    print(f"total: {time.perf_counter() - t_start:.3f} s", flush=True)
    print(card_line)
    entries = [(f"flat_stencil_spmv[{name}]", name, FLAT_SOURCE,
                REPLACES["flat"]) for name, _, _ in VARIANTS]
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
