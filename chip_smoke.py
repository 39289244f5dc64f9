#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pde_solver_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Asserts a CUDA card and prints its name and power limit (nvidia-smi).
2. Builds the three kernel sources from ``pde_solver_tpu_torch/csrc`` with
   nvcc for sm_90a, in parallel, and prints the build seconds and every
   kernel's ptxas report.
3. Dense SpMV (``flat_stencil_spmv``): holds each 3D variant (vdim=3 f32,
   vdim=3 bf16, vdim=1 f32, vdim=1 bf16) against its plain PyTorch version
   on random weights at its main-path fine level (vdim 3: the flagship's
   161×65×65 nodes; vdim 1: the heat slice's 129³, then the flagship's
   projection at 161×65×65), a small level (21×9×9), two ragged tails on
   the one-node-a-thread path (N mod 8 = 3, 7) and three on the wide path
   of ≥ 2^18 nodes (N mod 8 = 3, 5, 7), relative max error ≤ 1e-5; with
   one node zeroed in W (on the wide path one of the last partial vector
   group) the kernel must read > 1e-4 off plain.  Times the first two
   shapes: kernel (CUDA events, and its device time from torch.profiler),
   plain, and for f32 weights the CSR yardstick (one cuSPARSE product
   ``A @ x`` of the same operator, int32 indices, held against plain
   first); prints the bound (bytes of W, x, y once over 3.35 TB/s, or
   float32 operations over 67 TFLOP/s) and the share.
4. Constant-interior operator (``cs_stencil``: one fused kernel for K3
   and K4) on the real assembled fine-level operators of the main paths:
   the heat slice's scaled backward-Euler operator M + Δt·K at 129³ nodes
   (vdim=1), and the flagship's scaled elasticity operator (vdim=3) and P1
   mass operator of its stress projection (vdim=1), both at 161×65×65
   nodes; then ragged tails (N not a multiple of 4, of the 128-node block
   or of the 1024-node window; small grids and grids of ≥ 2^18 nodes),
   each with the grid's last, partial window listed.  Each must be CS-representable;
   the kernel must equal ``cs_apply_plain`` and, without its slot map,
   ``cs_main_plain`` (bit for bit, up to the sign of zero), and match the
   dense kernel within 2e-6·max|y|; the dense kernel in f32 and bf16 must
   match its own plain version there within 1e-5 (relative).  Three
   planted faults in the kernel's tables (one residual weight, one class
   scalar, one interior scalar) must each read > 1e-4.  Times the kernel
   (with and without windows), the plain version, the dense kernel and the
   library yardstick (the whole operator as one CSR matrix, ``A @ x``, held
   against plain first), and prints the bound (x, y, the class term table,
   the slot map and the window nodes' residual weights) and the share.
   Those bytes fit the 50 MB L2, so the kernel and the dense kernel are
   also timed with 128 MB written between launches (profiler device ms of
   the kernel alone), where the share is one of HBM.
5. Small checks on the card against host solves: a 16×8×8 cantilever
   against sparse LU (von Mises within 1e-6 of its max), and a 40×6×6
   heat transient (5 steps, MG-PCG, constant-interior operator, the CS
   route's size gate ``cs_kernels.CS_MIN_DOF`` lowered for this check)
   against a float64 backward Euler with scipy (within 1e-6·max|T|).
6. The main paths through the public API, each with the launch counts set
   to 0 just before and read just after:
   - the flagship, 3D static elasticity of a 1 m × 0.2 m × 0.2 m
     cantilever under gravity on 160×64×64 cells (2,040,675 DOF), with
     ``PDE_TPU_CS`` 0 (dense kernels), 1 (constant-interior kernels) and
     "hybrid" (constant-interior residuals, dense bf16 smoothing);
   - the heat slice, ``solve_heat_3D(nx=ny=nz=128)`` (20 backward-Euler
     steps on 2,146,689 DOF), with ``PDE_TPU_CS`` 0 and 1.
   Checks convergence, finite fields of the expected shape, that the
   routes agree, that each run launched its kernels, and that the CS
   routes built their operator on the two levels of at least 65,536 DOF
   and no other.  Every dense
   operator a run launched and every constant-interior operator it built
   (each MG level and weight dtype, each step operator, the projection)
   is then held against its plain version at its own shape (each CS
   operator also against the dense kernel of the same weights, and timed
   beside that dense kernel in f32 and bf16: profiler device ms over 20
   launches, with its bound and its launches in the run).  From the
   per-level device times and launches, each run's SpMV device time is
   estimated (Σ launches × device ms).  Both heat
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
   plane-stress operators at 257², 1025², 67×41, 71×41 (narrow path),
   521×515, 513×517 and 515×517 nodes (wide path, N mod 8 = 3, 5, 7) on
   four inputs (relative max error ≤ 1e-5, where three planted faults must
   read > 1e-4), and timed at 257² and 1025² as in 3.
8. The ``_mixed``, nonlinear and advection tools, each run a main path of
   its own:
   - full width, ``solve_heat_3D_mixed(nx=ny=nz=128)``: 20 steps with a
     sinusoidally driven Dirichlet face, a Robin face and a flux face,
     MG-PCG per step (counted), ``PDE_TPU_CS`` 0 and 1 (a refusal of the CS
     build is printed and the run then must have stayed on the dense
     kernel); both trajectories against a float64 θ-scheme written from
     the weak form (face mass, surface load, g(t) at the new time level),
     solved on the card; ``solve_heat_2D_mixed`` at 256² against the same
     stepping on the host;
   - full width, ``solve_advection_3D(nx=ny=nz=128)``: 20 CNAB2 steps, flat
     CG on K1 at 15 offsets, ``PDE_TPU_CS`` 0 and 1, against a float64
     CNAB2 stepping on the card; one ``scheme="ab1"`` run at 64³ the same
     way; ``solve_advection_2D`` at 256² against the host stepping;
   - closed forms within the bounds of the JAX package's own tests: the 1D
     Dirichlet–Robin and Dirichlet–flux lines and the sphere's A + B/r
     (by host sparse LU as a default call takes them, and on the card with
     ``host_direct_threshold=0``), the thermal wave (1,024 Crank–Nicolson
     steps), the Kirchhoff profile of κ(T) = κ0(1 + βT), the advected
     Gaussian; ``solve_heat_2D_nonlinear`` at 256² (66,049 DOF, f32 CG on
     K1 with float64 refinement) against a float64 Picard iteration with
     sparse LU on the host.
   Every dense operator a main-path run launched has its offset count
   recorded (all must be built ones: 3, 7, 15), and each shape and
   variant is timed once (profiler device ms, share of its bound).
9. The floor probes (``floor_probes``: wonly, shifts, residentw, csz), each
   against its plain version (relative max error ≤ 1e-5; wonly and
   residentw also with bf16 weights) on the flagship's scaled fine-level
   elasticity operator (161×65×65, vdim 3) and the heat slice's (129³,
   vdim 1), on two ragged tails (N mod 4 = 3, 1), and with one planted
   fault each that must read > 1e-4.  Times each probe as in 3 (events,
   profiler device ms, bound, share; where its bytes fit the L2 also with
   128 MB written between launches); prints for wonly the GB/s it reaches
   beside K1's device time at the same shape, for shifts and csz the fused
   CS kernel's device time beside them.  The library yardstick of wonly is
   ``W.sum(0)``; the other three have no single PyTorch call.  Then their
   main path, counts 0 before and read after: the entry point
   ``floor_probes.kernel_floor`` on the flagship's operator.
10. The Newmark and modal tools, each run a main path of its own:
   - full width, ``solve_wave_3D(nx=ny=nz=128, dt=0.01, num_steps=20)``
     (2,146,689 DOF, the default sine mode): MG-PCG per step (counted),
     ``PDE_TPU_CS`` 0 and 1 (CS levels exactly 129³ and 65³), against the
     standing mode Π sin(πxᵢ) cos(√3πt) within a bound derived from the
     scheme's period error and the mesh's, against a float64 Newmark of
     the same M, K on the card (sparse CSR, Jacobi-PCG to 1e-12),
     displacements and velocities, and the routes against each other;
   - full width, ``solve_elasticity_3D_dynamic`` on the flagship's mesh
     (160×64×64 cells, 2,040,675 DOF, 10 steps of 1e-4 s): the cantilever
     released under gravity.  A spy on ``run_newmark`` keeps its operands
     and result: converged, the clamped face never moves, max|u| under 2.2×
     the static tip deflection q L⁴/(8EI), and the energy balance ½vᵀMv +
     ½uᵀKu − fᵀu = 0 at the last frame, evaluated on the host in float64,
     within 0.1 of fᵀu (the float32 right side f − K ũ leaves 5.8e-2 at
     this mesh width); the same tool at 40×16×16 cells against a float64
     Newmark of the same M, K on the card (bound 1e-2: float32 leaves
     1.4e-3 – 2.9e-3);
   - ``solve_wave_1D`` and ``solve_wave_2D`` at their default sizes against
     their standing modes;
   - ``solve_elasticity_3D_modal(nx=48, ny=12, nz=12, num_modes=2)``
     (24,843 DOF: MG + the double-float32 F-cycle on K1 v3, one hierarchy
     build and then cache hits, both counted) and
     ``solve_elasticity_2D_modal(nx=96, ny=24, num_modes=2)`` (4,850 DOF,
     flat CG on K1 v2), each against ``scipy.sparse.linalg.eigsh`` of the
     same pencil on the free DOFs (host float64), frequencies within 1e-6.

Fails loudly at the first failed check (non-zero exit, no result line).
Prints, before the last line, the card line and a JSON line with, for each
kernel: its launches on the main paths (in all and by run), its worst
error against plain, and at its main-path shape ``ms`` (events),
``device_ms`` (profiler), ``plain_ms``, ``bound_ms`` and ``bound_by``,
``share`` = bound_ms / ms, ``library_ms`` (or null and ``library_note``
saying why: bf16 weights), ``shape`` and ``l2_resident`` (the streamed
bytes under the 50 MB L2, where the share is not one of HBM); for the CS
kernels also ``cold_device_ms`` and ``cold_share``, with the L2 emptied
between launches (null for the dense ones), and for the probes that read
weights ``bf16`` (the times with bfloat16 weights, by shape).  The last line is ``{"ok":
true, "device": {...}}``.  Needs no network; writes only under
``build/``.
"""

from __future__ import annotations

import copy
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
            "cs_apply": "pde_solver_tpu/ops/pallas_kernels.py:704, "
                        "pde_solver_tpu/ops/pallas_kernels.py:764"}
VARIANTS = (("v3_f32", 3, "float32"), ("v3_bf16", 3, "bfloat16"),
            ("v1_f32", 1, "float32"), ("v1_bf16", 1, "bfloat16"))
# Per vdim, the main-path fine level first (its times go into the result
# line): vdim 3 the flagship's, vdim 1 the heat slice's (the flagship's
# projection at 161×65×65 next); then a small level, two ragged tails on
# the one-node-a-thread path and three on the wide path.  N mod 8 is 1 at
# every main-path fine level; 5, 3, 7 on the narrow path; 3, 5, 7 on the
# wide one.
WIDE_RAGGED = ((71, 65, 61), (73, 65, 61), (65, 65, 63))
SHAPES = {3: ((161, 65, 65), (21, 9, 9), (19, 9, 9), (23, 9, 9))
          + WIDE_RAGGED,
          1: ((129, 129, 129), (161, 65, 65), (21, 9, 9), (19, 9, 9),
              (23, 9, 9)) + WIDE_RAGGED}
# kWideMinNodes of flat_stencil_spmv.cu: from this many nodes on a thread
# takes 4 (f32) or 8 (bf16) nodes, below it one
WIDE_MIN_NODES = 1 << 18
REL_TOL = 1e-5
# a planted fault (the kernel fed a changed W, held against plain on the
# original) must read above this
FAULT_MIN = 1e-4
# K1 at vdim=2 on the plane-stress fine levels of BASELINE config 4 and of
# the full-width plate (the times are those at 1025²), then two ragged tails
# on the narrow path (67×41 and 71×41 nodes: N mod 8 = 3 and 7) and three
# on the wide one (521×515, 513×517, 515×517: 3, 5 and 7)
V2_VARIANTS = (("v2_f32", "float32"), ("v2_bf16", "bfloat16"))
V2_CELLS = ((256, 256), (1024, 1024), (66, 40), (70, 40), (520, 514),
            (512, 516), (514, 516))
V2_TIMED = ((256, 256), (1024, 1024))
V2_INPUTS = 4
# the bound of a kernel's time: the published peaks of one H100 SXM
# (HBM3 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
L2_BYTES = 50e6
# written between timed launches to empty the L2 of a kernel's data
FLUSH_BYTES = 128 << 20
BF16_NO_LIBRARY = ("no single PyTorch call takes bf16 weights with float32 "
                   "x and float32 sums")
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
# the fused CS kernel's ragged tails, (vdim, cells): N mod 4 = 3 on two
# small grids, then 3, 1 and 3 at ≥ 2^18 nodes; no N is a multiple of the
# 128-node block, and every grid ends in a partial window that is listed.
# v1 the heat operator on a unit box, v3 the flagship's material clamped
# at x = 0.
CS_RAGGED = ((1, (40, 12, 14)), (3, (44, 10, 12)), (1, (64, 64, 66)),
             (3, (80, 56, 56)), (3, (82, 56, 56)))
# the heat slice (max|ΔT|/max|T|): its two routes against each other, and
# each against the float64 trajectory, where float32 weights and state,
# amplified by the step operator's conditioning, leave ~9e-5; PERF.md has
# the readings and what a wrong route gives
HEAT_ROUTE_TOL = 1e-5
HEAT_F64_TOL = 3e-4
# the _mixed slice at full width: solve_heat_3D_mixed on 128³ cells, all
# three face kinds and the driving at once (every face not named insulated)
MIXED_3D = dict(nx=128, ny=128, nz=128, num_steps=20, dt=0.01,
                boundary_conditions={
                    "left": {"type": "dirichlet", "value": 100.0,
                             "amplitude": 20.0, "period": 0.1},
                    "right": {"type": "robin", "h": 5.0, "T_ambient": 20.0},
                    "top": {"type": "neumann", "flux": 50.0}})
# the advection slice at full width: solve_advection_3D on 128³ cells, CNAB2
# (CFL 0.64, cell Péclet 0.39), and one "ab1" run at 64³
ADVECTION_3D = dict(nx=128, ny=128, nz=128, dt=0.005, num_steps=20)
ADVECTION_AB1 = dict(nx=64, ny=64, nz=64, dt=0.005, num_steps=20,
                     scheme="ab1")
MIXED_2D = dict(nx=256, ny=256)               # 50 steps of Δt = 0.01
ADVECTION_2D = dict(nx=256, ny=256)           # 200 CNAB2 steps of Δt = 0.002
NONLINEAR_2D = dict(nx=256, ny=256, T_left=100.0, beta=0.01)
# float32 scans against float64 at Δt/h² = 655 (2D _mixed, backward Euler;
# BASELINE 1 reads 1.9e-4 at 813).  Advection's step operator is M + ½ΔtκK,
# close to the mass matrix, so float32 costs little; each step is solved to
# 1e-6 of ‖b̂‖ and the errors are carried along, not damped, so n steps may
# add up to n·1e-6 (H100: 4.0e-6 after 20 steps at 129³, 1.6e-5 after 200
# at 257²)
MIXED_2D_TOL = 1e-3
# A step of the _mixed tools stops at ‖r‖ ≤ transient_inner_tol·‖b̂‖, and b̂
# holds the Dirichlet values themselves on the constrained rows (unit
# diagonal): at 129³ with a face at 100 °C those rows carry ‖b̂‖ (14,190
# against 20 for all free rows), so the default 1e-6 is an effective 7e-4
# on the free rows, in both packages.  The default-tolerance runs are held
# to MIXED_DEFAULT_TOL (H100: 2.6e-3 from float64 at 129³, routes 2.2e-3
# apart); the runs at MIXED_TIGHT_TOL to the heat slice's bounds.
MIXED_DEFAULT_TOL = 1e-2
MIXED_TIGHT_TOL = 1e-9
# the two routes at MIXED_TIGHT_TOL: both float32 trajectories lie 2.2e-4
# from float64 at 129³ (temperatures to 120 °C, a Robin face), 1.4e-5 from
# each other (H100), where the heat slice's stay within HEAT_ROUTE_TOL
MIXED_ROUTE_TOL = 5e-5
ADVECTION_F64_TOL = 1e-4
# the floor probes: ragged tails (N mod 4 = 3 and 1) beside the two
# main-path shapes, and why three of them have no library yardstick
FLOOR_SOURCE = "pde_solver_tpu_torch/csrc/floor_probes.cu"
FLOOR_RAGGED = ((71, 65, 61), (73, 65, 61))
PROBE_REPLACES = {"wonly": "benchmarks/kernel_floor.py:63",
                  "shifts": "benchmarks/kernel_floor.py:98",
                  "residentw": "benchmarks/kernel_floor.py:148",
                  "csz": "benchmarks/kernel_floor.py:202"}
PROBE_NO_LIBRARY = ("no single PyTorch call computes a shifted stencil sum "
                    "with constant or tiled weights")
FLOOR_REPS = 20
# the Newmark slice at full width: the wave equation on 128³ cells (the
# default sine mode, Π sin(πxᵢ) cos(√3πt)), and the flagship's cantilever
# released under gravity; the latter also at 40×16×16 against the host
WAVE_3D = dict(nx=128, ny=128, nz=128, dt=0.01, num_steps=20)
DYNAMIC_3D = dict(Lx=1.0, Ly=0.2, Lz=0.2, nx=160, ny=64, nz=64,
                  body_fz=-7.65e4, dt=1e-4, num_steps=10)
DYNAMIC_SMALL = dict(DYNAMIC_3D, nx=40, ny=16, nz=16)
# float32 Newmark scans against float64 (max|Δ|/max, displacements and
# velocities).  The wave's step operator M + βΔt²K is close to the mass
# matrix (H100 at 129³: 1.1e-6 and 4.0e-5).  The cantilever's right side
# f − K ũ is a difference of terms |K||ũ| / |f| ∝ h⁻² times larger, which
# a float32 scan cannot resolve: at 40×16×16 cells and E = 210 GPa it sits
# 1.4e-3 (u) and 2.9e-3 (v) from float64 after 10 steps, at any step
# tolerance (H100; 1.0e-5 and 1.7e-5 at 8×4×4 on the CPU).  An open fault
# of the float32 scan (ROADMAP queue 3), stated here, not hidden
NEWMARK_F64_TOL = 1e-4
DYNAMIC_F64_TOL = 1e-2
# ½vᵀMv + ½uᵀKu − fᵀu of the released cantilever, as a share of fᵀu.  The
# float32 right side f − K ũ loses |K||ũ| / |f| ∝ h⁻² digits: the balance
# closes to 1.2e-4 at 16×8×8 cells (CPU), 5.8e-2 at 160×64×64 (H100);
# PERF.md and ROADMAP queue 3 carry it as an open fault of the float32 scan
ENERGY_TOL = 0.1
# the modal slice: 24,843 DOF (MG + df2) and 4,850 DOF (flat CG); two modes
# each, since every solve is launch-bound
MODAL_3D = dict(nx=48, ny=12, nz=12, num_modes=2)
MODAL_2D = dict(nx=96, ny=24, num_modes=2)
MODAL_TOL = 1e-6


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


def turns(kernel, plain, reps_k: int, reps_p: int, library=None,
          reps_l: int = 20):
    """ms of kernel, plain and library (None without one), timed plain,
    library, kernel, kernel, library, plain."""
    p1 = time_ms(plain, reps_p)
    l1 = library and time_ms(library, reps_l)
    k1 = time_ms(kernel, reps_k)
    k2 = time_ms(kernel, reps_k)
    l2 = library and time_ms(library, reps_l)
    p2 = time_ms(plain, reps_p)
    return (k1 + k2) / 2, (p1 + p2) / 2, library and (l1 + l2) / 2


def device_ms(fn, kernel: str, reps: int = 50, tries: int = 8) -> float:
    """Mean device time per launch of the kernels whose name holds
    ``kernel``, from torch.profiler over ``reps`` calls of fn, averaged
    over the launches the trace holds.  A trace started cold missed the
    first launches (8–19 of 20 held on the H100), so the calls run first
    as the profiler's warm-up step and are not kept.  Traces there drop
    launches, now and then all of them, several in a row: a trace that
    holds none is taken again after a pause, with more calls each time,
    up to ``tries`` times, and the run fails if none holds them.  Below
    the wrapper's host cost per call (about 0.015 ms) the event time of
    ``time_ms`` measures the host, this the kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(1, tries + 1):
        n = reps * min(attempt, 4)
        kept = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: kept.extend(p.key_averages())
                     ) as prof:
            for _ in range(2):          # the warm-up step, then the kept one
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [ev for ev in kept if kernel in ev.key]
        count = sum(ev.count for ev in events)
        total = sum(getattr(ev, "device_time_total", 0.0) for ev in events)
        if count and total > 0:
            if count != n or attempt > 1:
                print(f"  device_ms {kernel}: trace {attempt} holds {count} "
                      f"of {n} launches", flush=True)
            return total / 1e3 / count
        time.sleep(0.5)
    check(False, f"{tries} profiler traces of {reps}–{4 * reps} calls hold "
          f"no {kernel} launch")


def bound(n_bytes: float, flops: float):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the HBM rate and the operations over the float32
    rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flat_cost(op):
    """Bytes and float32 operations of one dense apply: W's n_off·v² planes
    of N weights, x and y once each; one multiply-add per weight."""
    nw = op.n_off * op.vdim * op.vdim
    w_bytes = nw * op.N * op.W.element_size()
    return w_bytes + 2 * op.vdim * op.N * 4, 2.0 * nw * op.N, w_bytes


def cs_cost(op, windows: bool = True):
    """Bytes and float32 operations of one fused CS apply on this
    operator's data: x read and y written once and the class term table;
    with windows also the slot map and the residual weights of the window
    nodes below N.  A multiply and an add per nonzero scalar of every set
    a node is in, and per residual weight of a window node."""
    import numpy as np

    from pde_solver_tpu_torch.ops.cs_kernels import WINDOW

    nw = op.n_off * op.vdim * op.vdim
    sizes = [op.N] + [int(m.sum()) for m in op.masks()[:len(op.descs)]]
    flops = sum(2.0 * n * np.count_nonzero(sv)
                for n, sv in zip(sizes, op.sets))
    nbytes = 2 * op.vdim * op.N * 4 + op.cls_terms.numel() * 4
    if windows:
        win_nodes = int(np.minimum(op.N - op.windows * WINDOW, WINDOW).sum())
        nbytes += op.slots.numel() * 4 + nw * win_nodes * 4
        flops += 2.0 * nw * win_nodes
    return nbytes, flops


def csr_of(W, deltas, vdim: int, N: int):
    """Float32 weight planes ``W`` [n_off·v·v, ≥ N] as one CSR matrix
    [v·N, v·N] on the card, int32 indices: rows a·N + n, columns b·N + n +
    δ; exact zeros and reads outside x dropped, the columns of a row
    ascending (offsets taken in δ order).  The library yardstick only: the
    port never calls it."""
    import torch

    v, n_off, dev = vdim, len(deltas), W.device
    order = sorted(range(n_off), key=lambda o: deltas[o])
    d = torch.tensor([deltas[o] for o in order], device=dev)
    vals = W[:, :N].reshape(n_off, v, v, N)[order].permute(1, 3, 2, 0)
    m = torch.arange(N, device=dev)[:, None] + d[None, :]           # [n, o]
    cols = (torch.arange(v, device=dev)[:, None, None] * N
            + m[None]).permute(1, 0, 2)                            # [n, b, o]
    keep = (vals != 0) & ((m >= 0) & (m < N))[None, :, None, :]  # [a, n, b, o]
    crow = torch.zeros(v * N + 1, dtype=torch.int64, device=dev)
    crow[1:] = keep.reshape(v * N, -1).sum(1).cumsum(0)
    col = cols.unsqueeze(0).expand(v, N, v, n_off)[keep]
    A = torch.sparse_csr_tensor(crow.int(), col.int(), vals[keep],
                                size=(v * N, v * N))
    del vals, cols, keep, col
    return A


def planted_tail(sk, op, x, y_plain) -> float:
    """The kernel on W with one node zeroed in every plane, held against
    plain on the original W: the relative max error, which must be large.
    On the wide path (≥ WIDE_MIN_NODES nodes) the node lies in the last
    partial vector group (4 nodes a thread at f32, 8 at bf16); on the
    narrow one among the last 8 nodes."""
    K = 16 // op.W.element_size() if op.N >= WIDE_MIN_NODES else 8
    lo = op.N - op.N % K if op.N % K else op.N - K
    n = lo + int(y_plain[:, lo:].abs().amax(0).argmax())
    bad = copy.copy(op)
    bad.W = op.W.clone()
    bad.W[:, n] = 0
    return rel_err(bad.apply_flat(x), y_plain)


def time_flat(sk, name, op, x, y_plain, label):
    """Times op (kernel), its plain version and, for f32 weights, the CSR
    yardstick (held against plain first) in turns; prints one line and
    returns the fields of the result line."""
    import torch

    nbytes, flops, w_bytes = flat_cost(op)
    bound_ms, bound_by = bound(nbytes, flops)
    A, library, note = None, None, BF16_NO_LIBRARY
    if op.W.dtype == torch.float32:
        A, note = csr_of(op.W, op.deltas, op.vdim, op.N), None
        xf = x.reshape(-1)
        lib_rel = rel_err((A @ xf).view_as(y_plain), y_plain)
        check(lib_rel <= REL_TOL, f"{name} at {label}: CSR yardstick vs "
              f"plain relative max error {lib_rel:.3e}")
        library = lambda: A @ xf        # noqa: E731
    ms, plain_ms, library_ms = turns(
        lambda: op.apply_flat(x),
        lambda: sk.spmv_plain(op.W, x, op.deltas, op.vdim), 50, 10,
        library=library)
    dev_ms = device_ms(lambda: op.apply_flat(x), "flat_stencil_spmv_kernel")
    l2 = w_bytes < L2_BYTES
    print(f"kernel {name} {label} N={op.N} n_off={op.n_off}: ms={ms:.4f} "
          f"device_ms={dev_ms:.4f} plain_ms={plain_ms:.4f} library_ms="
          f"{'none' if library_ms is None else f'{library_ms:.4f}'} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) share={bound_ms / ms:.3f}"
          f"{' (W fits L2: not a share of HBM)' if l2 else ''} "
          f"W={w_bytes / 1e6:.1f} MB -> {w_bytes / ms / 1e6:.1f} GB/s",
          flush=True)
    del A
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                library_ms=library_ms,
                library_note=note, bound_ms=bound_ms, bound_by=bound_by,
                share=bound_ms / ms, shape=label, l2_resident=l2)


def kernel_phase(sk, offsets):
    """Dense kernel against plain on the card, and a planted tail fault, at
    every shape of SHAPES; times at the first two (kernel, plain, CSR
    yardstick) and returns per-variant results (the main shape's times)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = {}
    for name, vdim, wdt in VARIANTS:
        res = {"max_abs_err": 0.0}
        for i, shape in enumerate(SHAPES[vdim]):
            N = shape[0] * shape[1] * shape[2]
            W = torch.zeros((len(offsets) * vdim * vdim, sk.padded_length(N)),
                            device="cuda")
            W[:, :N] = torch.randn((W.shape[0], N), generator=gen,
                                   device="cuda")
            op = sk.FlatStencilOperator.from_packed(W, offsets, shape, vdim)
            op = op.as_weight_dtype(getattr(torch, wdt))
            del W
            x = torch.randn((vdim, N), generator=gen, device="cuda")
            y = op.apply_flat(x)
            torch.cuda.synchronize()
            y_plain = sk.spmv_plain(op.W, x, op.deltas, vdim)
            torch.cuda.synchronize()
            err = float((y - y_plain).abs().max())
            rel = err / max(float(y_plain.abs().max()), 1e-30)
            fault = planted_tail(sk, op, x, y_plain)
            path = "wide" if N >= WIDE_MIN_NODES else "narrow"
            print(f"kernel {name} nodes={shape} N={N} (N mod 8 = {N % 8}, "
                  f"{path} path): rel_err={rel:.3e} abs_err={err:.3e}; planted tail fault "
                  f"{fault:.3e}", flush=True)
            check(rel <= REL_TOL, f"{name} at {shape}: kernel vs plain "
                  f"relative max error {rel:.3e} > {REL_TOL}")
            check(fault > FAULT_MIN, f"{name} at {shape}: a zeroed tail node "
                  f"reads {fault:.3e}, not above {FAULT_MIN}")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            if i < 2:
                timed = time_flat(sk, name, op, x, y_plain, f"nodes={shape}")
                if i == 0:
                    res.update(timed)
            del op, x, y, y_plain
            torch.cuda.empty_cache()
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


def elasticity_operator(cells=FLAGSHIP_CELLS):
    """The flagship's scaled fine-level elasticity operator (vdim=3):
    160×64×64 cells by default, clamped at x = 0."""
    import numpy as np

    from pde_solver_tpu_torch.mesh import box_mesh
    from pde_solver_tpu_torch.models.elasticity import lame_parameters
    from pde_solver_tpu_torch.ops import assembly
    from pde_solver_tpu_torch.ops.bc import DirichletBC
    from pde_solver_tpu_torch.ops.linsolve import prepare_system

    mesh = box_mesh(*cells, (0.0, 0.0, 0.0), FLAGSHIP_EXTENT)
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
    """The fused kernel through ``apply_flat`` against ``cs_apply_plain``,
    and without its slot map against ``cs_main_plain``: equal up to the
    sign of zero, one launch each.  Returns the kernel's output and the
    windowless one."""
    import torch

    n0 = op.launches
    counted = sk_launches(f"cs_apply_v{op.vdim}")
    y = op.apply_flat(x)
    y_sets = op.launch(x, windows=False)
    torch.cuda.synchronize()
    check(op.launches == n0 + 2 and sk_launches(f"cs_apply_v{op.vdim}")
          == counted + 2, f"{label}: {op.launches - n0} launches for two "
          f"applies")
    err = float((y - ck.cs_apply_plain(op, x)).abs().max())
    err_sets = float((y_sets - ck.cs_main_plain(op, x)).abs().max())
    check(err == 0.0 and err_sets == 0.0,
          f"{label}: fused kernel vs cs_apply_plain {err:.3e}, windowless "
          f"vs cs_main_plain {err_sets:.3e} (bit-equal expected)")
    return y, y_sets


def sk_launches(name: str) -> int:
    from pde_solver_tpu_torch.ops import stencil_kernels as sk

    return sk.KERNEL_LAUNCHES.get(name, 0)


def planted_cs_faults(ck, op, x, y_plain):
    """The kernel with one residual weight, one class scalar and one
    interior scalar of its tables changed, each held against plain on the
    unchanged operator: {fault: relative max error}, which must be large.
    The residual weight is the centre offset's (a = b = 0) at the window
    node where |x[0]| is largest; the class scalar the same term of the
    first class set; the interior scalar that term of set 0, times 1.01."""
    import torch

    v = op.vdim
    scale = float(abs(op.terms[0]).max())
    centre = op.deltas.index(0) * v * v            # term (o, b = 0, a = 0)
    nodes = (op.win_idx.long()[:, None] * ck.WINDOW
             + torch.arange(ck.WINDOW, device=x.device)[None, :]).reshape(-1)
    t = int(torch.where(nodes < op.N, x[0, nodes.clamp(max=op.N - 1)].abs(),
                        torch.zeros((), device=x.device)).argmax())
    faults = {}
    bad = copy.copy(op)
    bad.Wwin = op.Wwin.clone()
    bad.Wwin[centre, t] += scale
    faults["residual weight"] = bad
    if len(op.descs):
        bad = copy.copy(op)
        bad.cls_terms = op.cls_terms.clone()
        bad.cls_terms[0, centre] += scale
        faults["class scalar"] = bad
    bad = copy.copy(op)
    bad.terms = op.terms.copy()
    bad.terms[0, centre] *= 1.01
    bad._params = None
    faults["interior scalar"] = bad
    return {what: rel_err(bad.launch(x), y_plain)
            for what, bad in faults.items()}


def cs_operator_phase(ck, sk, label, vdim, mesh, sysm, gen, timed,
                      ragged=False):
    """One CS operator: the fused kernel against plain (bit-equal), against
    the dense kernel of the same weights (itself held against its plain
    version in f32 and bf16), and with planted faults; with ``timed`` also
    the times.  A ``ragged`` grid must have N mod 4 ≠ 0 and end in a
    partial window that is listed.  Returns (max_abs_err, the result-line
    fields or None)."""
    import torch

    op = ck.CSFlatStencilOperator.try_build(
        sysm.offsets, sysm.weights, mesh.node_shape, vdim=vdim,
        device="cuda")
    check(op is not None, f"{label}: CS build refused")
    if ragged:
        check(op.N % 4 and op.N % ck.WINDOW
              and op.windows[-1] == (op.N - 1) // ck.WINDOW,
              f"{label}: N={op.N} is not a ragged tail with its last, "
              f"partial window listed")
    dense = sk.FlatStencilOperator(sysm.offsets, sysm.weights,
                                   mesh.node_shape, vdim=vdim, device="cuda")
    dense_bf16 = dense.as_weight_dtype(torch.bfloat16)
    x = torch.randn((vdim, op.N), generator=gen, device="cuda")
    y, y_sets = cs_against_plain(ck, op, x, label)
    y_dense = dense.apply_flat(x)
    y_bf16 = dense_bf16.apply_flat(x)
    torch.cuda.synchronize()
    err_dense = float((y - y_dense).abs().max())
    dscale = float(y_dense.abs().max())
    check(err_dense <= CS_TOL * dscale, f"{label}: fused CS kernel vs dense "
          f"kernel {err_dense:.3e} (max|y| {dscale:.3e})")
    dense_rel = {}
    for name, dop, yd in (("f32", dense, y_dense), ("bf16", dense_bf16, y_bf16)):
        rel = rel_err(yd, sk.spmv_plain(dop.W, x, dop.deltas, vdim))
        check(rel <= REL_TOL, f"{label}: dense {name} kernel vs plain "
              f"relative max error {rel:.3e} > {REL_TOL}")
        dense_rel[name] = rel
    faults = planted_cs_faults(ck, op, x, y)
    last = (op.N - 1) // ck.WINDOW
    print(f"cs {label}: N={op.N} (N mod 4 = {op.N % 4}, mod 128 = "
          f"{op.N % 128}, mod 1024 = {op.N % ck.WINDOW}) "
          f"n_win={op.n_win} ({op.n_win * ck.WINDOW / op.N:.4f} of the "
          f"nodes; last, partial window listed: "
          f"{bool(op.N % ck.WINDOW) and last in set(op.windows.tolist())}) "
          f"sets={len(op.sets)} eff_sweeps={op.eff_sweeps:.4f}; fused and "
          f"windowless kernels bit-equal to plain; vs dense kernel rel "
          f"{err_dense / dscale:.3e} (windowless vs dense "
          f"{rel_err(y_sets, y_dense):.3e}); dense kernel vs plain f32 "
          f"{dense_rel['f32']:.3e} bf16 {dense_rel['bf16']:.3e}; planted "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items()),
          flush=True)
    check(min(faults.values()) > FAULT_MIN, f"{label}: a planted fault "
          f"reads {min(faults.values()):.3e}, not above {FAULT_MIN}")
    fields = None
    if timed:
        # the library yardstick: the whole operator as one CSR matrix (the
        # dense f32 weights), held against plain before it is timed
        A = csr_of(dense.W, dense.deltas, vdim, op.N)
        xf = x.reshape(-1)
        lib_rel = rel_err((A @ xf).view_as(y), y)
        check(lib_rel <= REL_TOL, f"{label}: whole-operator CSR vs plain "
              f"relative max error {lib_rel:.3e}")
        reps_p = 5 if vdim == 1 else 3
        ms, plain_ms, lib_ms = turns(lambda: op.apply_flat(x),
                                     lambda: ck.cs_apply_plain(op, x), 50,
                                     reps_p, library=lambda: A @ xf)
        del A
        sets_ms, _, _ = turns(lambda: op.launch(x, windows=False),
                              lambda: None, 50, 1)
        dense_ms, bf16_ms, _ = turns(lambda: dense.apply_flat(x),
                                     lambda: dense_bf16.apply_flat(x), 50, 50)
        dev = device_ms(lambda: op.apply_flat(x), "cs_apply_kernel")
        dev_sets = device_ms(lambda: op.launch(x, windows=False),
                             "cs_apply_kernel")
        dev_dense = device_ms(lambda: dense.apply_flat(x),
                              "flat_stencil_spmv_kernel")
        # x, y and R fit the L2, so launches back to back read them there:
        # the HBM bound holds only with the L2 emptied between launches
        flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
        cold = device_ms(lambda: (flush.zero_(), op.apply_flat(x)),
                         "cs_apply_kernel")
        cold_dense = device_ms(lambda: (flush.zero_(), dense.apply_flat(x)),
                               "flat_stencil_spmv_kernel")
        del flush
        nbytes, flops = cs_cost(op)
        bound_ms, bound_by = bound(nbytes, flops)
        bound_sets = bound(*cs_cost(op, windows=False))[0]
        l2 = nbytes < L2_BYTES
        print(f"cs {label} ms: fused={ms:.4f} (device {dev:.4f}) windowless="
              f"{sets_ms:.4f} (device {dev_sets:.4f}) | plain={plain_ms:.4f} "
              f"| dense K1 f32={dense_ms:.4f} (device {dev_dense:.4f}) bf16="
              f"{bf16_ms:.4f} | bound_ms={bound_ms:.4f} ({bound_by}; "
              f"windowless {bound_sets:.4f}; {nbytes / 1e6:.1f} MB) share="
              f"{bound_ms / ms:.3f}"
              f"{' (fits L2: not a share of HBM)' if l2 else ''} | L2 "
              f"emptied between launches: device {cold:.4f}, share of HBM "
              f"{bound_ms / cold:.3f}; dense K1 f32 device {cold_dense:.4f} "
              f"| library (whole-operator CSR A @ x) {lib_ms:.4f} (rel "
              f"{lib_rel:.3e})", flush=True)
        fields = dict(ms=ms, device_ms=dev, plain_ms=plain_ms,
                      library_ms=lib_ms, library_note=None,
                      bound_ms=bound_ms, bound_by=bound_by,
                      share=bound_ms / ms, shape=label, l2_resident=l2,
                      cold_device_ms=cold, cold_share=bound_ms / cold)
    err = float((y - ck.cs_apply_plain(op, x)).abs().max())
    del op, dense, dense_bf16, x, y, y_sets, y_dense, y_bf16
    torch.cuda.empty_cache()
    return err, fields


def cs_phase(ck, sk):
    """The fused CS kernel on the main paths' fine-level operators (the
    first of each vdim gives the variant's times) and on CS_RAGGED;
    returns per-variant results."""
    import torch

    from pde_solver_tpu_torch.ops import linsolve

    results = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    cases = [("heat 129^3", 1, lambda: heat_operator((128, 128, 128))),
             ("flagship elasticity 161x65x65", 3, elasticity_operator),
             ("flagship P1 mass 161x65x65", 1, mass_operator)]
    for vdim, cells in CS_RAGGED:
        make = (lambda c=cells: heat_operator(c)) if vdim == 1 else \
            (lambda c=cells: elasticity_operator(c))
        cases.append((f"ragged {'x'.join(str(c + 1) for c in cells)} v{vdim}",
                      vdim, make))
    for label, vdim, build in cases:
        mesh, sysm = build()
        res = results.setdefault(f"cs_apply_v{vdim}", {"max_abs_err": 0.0})
        err, fields = cs_operator_phase(ck, sk, label, vdim, mesh, sysm, gen,
                                        timed="ms" not in res,
                                        ragged=label.startswith("ragged"))
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if fields is not None:
            res.update(fields)
        del mesh, sysm
    # the main paths start cold, as a user's first solve does
    linsolve._PREP_CACHE.clear()
    return results


def check_built(ck, sk, built, label: str, cs_level_ms) -> None:
    """Every CS operator a main-path run built (each MG level, the
    projection): against its plain versions (bit-equal) and against the
    dense kernel of the same weights (≤ CS_TOL of max|y|) at its own shape,
    and timed beside that dense kernel in f32 and bf16: profiler device ms
    over 20 launches, its bound and the run's launches of it, into
    ``cs_level_ms[(label, shape, vdim)]``."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    worst = 0.0
    for shape, op, offsets, weights in built:
        if op is None:
            continue
        key = (label, shape, op.vdim)
        launches = op.launches + cs_level_ms.get(key, {}).get("launches", 0)
        what = f"{label} CS operator at {shape} (v{op.vdim})"
        x = torch.randn((op.vdim, op.N), generator=gen, device="cuda")
        y, _ = cs_against_plain(ck, op, x, what)
        dense = sk.FlatStencilOperator(offsets, weights, shape, vdim=op.vdim,
                                       device="cuda")
        dense_bf16 = dense.as_weight_dtype(torch.bfloat16)
        rel = rel_err(y, dense.apply_flat(x))
        check(rel <= CS_TOL, f"{what}: vs dense kernel relative max error "
              f"{rel:.3e}")
        worst = max(worst, rel)
        nbytes, flops = cs_cost(op)
        cs_level_ms[key] = dict(
            ms=device_ms(lambda: op.apply_flat(x), "cs_apply_kernel", reps=20),
            bound=bound(nbytes, flops)[0], l2=nbytes < L2_BYTES,
            launches=launches,
            f32=device_ms(lambda: dense.apply_flat(x),
                          "flat_stencil_spmv_kernel", reps=20),
            bf16=device_ms(lambda: dense_bf16.apply_flat(x),
                           "flat_stencil_spmv_kernel", reps=20))
        del x, y, dense, dense_bf16
    torch.cuda.empty_cache()
    print(f"{label}: {sum(op is not None for _, op, _, _ in built)} CS "
          f"operators bit-equal to plain, worst relative error vs the dense "
          f"kernel {worst:.3e}; device ms of the CS kernel (share of bound; "
          f"L2: the bytes fit the L2, not a share of HBM) | the dense kernel "
          f"on the same weights, f32 / bf16 | the run's CS launches: "
          + "; ".join(
              f"{shape} v{v} {t['ms']:.4f} ({t['bound'] / t['ms']:.3f}"
              f"{' L2' if t['l2'] else ''}) | {t['f32']:.4f} / "
              f"{t['bf16']:.4f} | {t['launches']}"
              for (lb, shape, v), t in cs_level_ms.items() if lb == label),
          flush=True)


def field(result):
    import numpy as np

    from pde_solver_tpu_torch.fields import load_field

    f = load_field(result.data_file)
    return (np.asarray(f.values, dtype=np.float64),
            np.asarray(f.times, dtype=np.float64))


def stencil_csr(stencil, shape):
    """A scalar numpy stencil {offset: weights} on a grid of ``shape`` as a
    float64 scipy CSR matrix, nodes in C order."""
    import numpy as np
    import scipy.sparse as sp

    N = int(np.prod(shape))
    strides = np.cumprod((1,) + tuple(shape[::-1]))[:-1][::-1]
    node = np.arange(N)
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


def heat_matrices(mesh, pairs, dt=None, theta=1.0, weight_fn=None,
                  quad_degree=4, kappa=1.0, robin=(), velocity=None):
    """A heat problem's float64 matrices as scipy CSR, from the weak form:
    stiffness K = ∫ κ w ∇u·∇v plus the Robin face mass Σ_Γ ∫_Γ h w u v ds,
    mass M = ∫ w u v.  Returns the implicit operator A = M + θΔt·K masked
    (Dirichlet rows and columns zeroed, 1 on their diagonal), the explicit
    B = M − (1−θ)Δt·K, the free mask, the Dirichlet values g, the lift A·g
    with A unmasked, that unmasked A, and, with a ``velocity``, the
    convection matrix C = ∫ (v·∇u) w (else None).  ``dt=None`` gives the
    steady system: A = K, no B.  ``robin``: (axis, side, h, T_inf) per
    face."""
    import numpy as np
    import scipy.sparse as sp

    from pde_solver_tpu_torch.ops import assembly, surface
    from pde_solver_tpu_torch.ops.bc import DirichletBC

    weighted = weight_fn is not None
    K = assembly.assemble_scalar_stencil(
        mesh, "stiffness", weight_fn=weight_fn,
        quad_degree=quad_degree if weighted else 2)
    M = assembly.assemble_scalar_stencil(
        mesh, "mass", weight_fn=weight_fn,
        quad_degree=max(quad_degree, 2) if weighted else 2)
    shape = mesh.node_shape

    def csr(stencil):
        return stencil_csr(stencil, shape)

    Kc = kappa * csr(K)
    for axis, side, h, _ in robin:
        Kc = Kc + csr(surface.assemble_face_mass(mesh, axis, side, coeff=h,
                                                 weight_fn=weight_fn))
    Kc = Kc.tocsr()
    if dt is None:
        A, B = Kc, None
    else:
        Mc = csr(M)
        A = (Mc + (theta * dt) * Kc).tocsr()
        B = (Mc - ((1.0 - theta) * dt) * Kc).tocsr()
    bc = DirichletBC.from_masks(pairs, shape)
    free = np.asarray(bc.free_mask, np.float64).reshape(-1)
    g = (np.asarray(bc.values, np.float64) * (1.0 - bc.free_mask)).reshape(-1)
    P = sp.diags(free)
    A_masked = (P @ A @ P + sp.diags(1.0 - free)).tocsr()
    C = None if velocity is None else csr(
        assembly.assemble_convection_stencil(
            mesh, np.asarray(velocity, np.float64)))
    return A_masked, B, free, g, A @ g, A, C


def heat_load(mesh, source, weight_fn=None, quad_degree=4, robin=(), flux=()):
    """Flat float64 load: a constant source ∫ w f v, the Robin faces'
    ∫_Γ h T_inf w v ds and the flux faces' ∫_Γ q_in w v ds."""
    from pde_solver_tpu_torch.ops import assembly, surface

    b = source * assembly.assemble_load(mesh, weight_fn=weight_fn,
                                        quad_degree=quad_degree)
    for axis, side, coeff in ([(a, s, h * t_inf) for a, s, h, t_inf in robin]
                              + list(flux)):
        if coeff:
            b = b + surface.assemble_face_load(
                mesh, axis, side, coeff=coeff, weight_fn=weight_fn,
                quad_degree=quad_degree)
    return b.reshape(-1)


def heat_steady_f64(mesh, pairs, source=0.0, weight_fn=None, quad_degree=4):
    """Float64 steady heat solve on the host (sparse LU); flat [N]."""
    import scipy.sparse.linalg as spla

    from pde_solver_tpu_torch.mesh import flatten_values

    A, _, free, g, Ag, _, _ = heat_matrices(mesh, pairs, None,
                                            weight_fn=weight_fn,
                                            quad_degree=quad_degree)
    b = heat_load(mesh, source, weight_fn, quad_degree)
    u = spla.spsolve(A.tocsc(), free * (b - Ag) + g)
    return flatten_values(u.reshape(mesh.node_shape), mesh.dim)


def theta_scheme_f64(mesh, pairs, dt, num_steps, theta=1.0, T_initial=20.0,
                     source=0.0, weight_fn=None, quad_degree=4, device=None,
                     kappa=1.0, robin=(), flux=(), amp_pairs=(), omega=0.0,
                     phase=0.0, velocity=None, scheme="cnab2", u0=None):
    """Float64 θ-scheme of a heat or advection-diffusion transient, written
    from the weak form: per step, solve the masked M + θΔt·K with the right
    side free ⊙ (B uⁿ + Δt·b − c − A g(t_{n+1})) + g(t_{n+1}).  Dirichlet
    data g(t) = g + sin(ωt + φ)·g₁ on the faces of ``amp_pairs`` (mask,
    amplitude); c the explicit convection Δt·C uⁿ ("ab1") or its
    Adams-Bashforth-2 extrapolation Δt·(3/2 C uⁿ − 1/2 C uⁿ⁻¹) with u⁻¹ = u⁰
    ("cnab2").  ``u0`` (node-shaped) replaces the constant initial field.
    On the host (no ``device``) by scipy sparse LU; on ``device`` by
    Jacobi-PCG on torch sparse CSR, warm-started, to a true relative
    residual ≤ 1e-12.  Returns the flat trajectory [num_steps + 1, N]."""
    import math

    import numpy as np
    import scipy.sparse.linalg as spla

    from pde_solver_tpu_torch.mesh import flatten_values

    A, B, free, g, Ag, A_full, C = heat_matrices(
        mesh, pairs, dt, theta, weight_fn, quad_degree, kappa, robin,
        velocity)
    b = dt * heat_load(mesh, source, weight_fn, quad_degree, robin, flux)
    g1 = np.zeros_like(g)
    for mask, amp in amp_pairs:
        g1 = np.where(np.asarray(mask).reshape(-1), amp, g1)
    g1 = g1 * (1.0 - free)
    Ag1 = A_full @ g1
    driven = bool(len(amp_pairs)) and omega != 0.0
    ab2 = scheme == "cnab2"
    start = (np.full(g.shape, float(T_initial)) if u0 is None
             else np.asarray(u0, np.float64).reshape(-1))
    u = start * free + g
    frames = [u]

    def sin_at(step):
        return math.sin(omega * (step * dt) + phase) if driven else 0.0

    if device is None:
        lu = spla.splu(A.tocsc())
        u_prev = u
        for n in range(num_steps):
            s1 = sin_at(n + 1)
            rhs = B @ u + b - (Ag + s1 * Ag1)
            if C is not None:
                Cu = C @ u
                rhs = rhs - dt * ((1.5 * Cu - 0.5 * (C @ u_prev)) if ab2
                                  else Cu)
            u_prev, u = u, lu.solve(free * rhs + g + s1 * g1)
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
        Cd = None if C is None else dev_csr(C.tocsr())
        dinv = torch.from_numpy(1.0 / A.diagonal()).to(device)
        fr, gd, bd, Agd, g1d, Ag1d = (torch.from_numpy(a).to(device)
                                      for a in (free, g, b, Ag, g1, Ag1))

        def mv(S, v):
            return (S @ v[:, None])[:, 0]

        x = torch.from_numpy(u).to(device)
        x_prev = x
        iters = 0
        for n in range(num_steps):
            s1 = sin_at(n + 1)
            rhs = mv(Bd, x) + bd - (Agd + s1 * Ag1d)
            if Cd is not None:
                Cx = mv(Cd, x)
                rhs = rhs - dt * ((1.5 * Cx - 0.5 * mv(Cd, x_prev)) if ab2
                                  else Cx)
            rhs = fr * rhs + gd + s1 * g1d
            x_prev = x
            bn = float(torch.linalg.vector_norm(rhs))
            r = rhs - mv(Ad, x)
            z = dinv * r
            p, rz = z, torch.dot(r, z)
            for it in range(1, 20001):
                Ap = mv(Ad, p)
                alpha = rz / torch.dot(p, Ap)
                x = x + alpha * p
                r = r - alpha * Ap
                if it % 25 == 0 and float(torch.linalg.vector_norm(
                        rhs - mv(Ad, x))) <= 1e-12 * bn:
                    break
                z = dinv * r
                rz_new = torch.dot(r, z)
                p, rz = z + (rz_new / rz) * p, rz_new
            relres = float(torch.linalg.vector_norm(rhs - mv(Ad, x))) / bn
            check(relres <= 1e-12, f"float64 reference step: relres "
                  f"{relres:.3e} after {it} iterations")
            iters += it
            frames.append(x.cpu().numpy())
        print(f"float64 reference {mesh.n_cells} cells: {iters} PCG "
              f"iterations over {num_steps} steps", flush=True)
        del Ad, Bd, Cd
    return np.stack([flatten_values(f.reshape(mesh.node_shape), mesh.dim)
                     for f in frames])


def spy_cs_builds(ck):
    """Record (node_shape, operator or None, offsets, weights) of every CS
    build; returns the list."""
    built = []
    orig = ck.CSFlatStencilOperator.try_build.__func__

    def spy(cls, offsets, weights_np, node_shape, *a, **kw):
        op = orig(cls, offsets, weights_np, node_shape, *a, **kw)
        built.append((tuple(int(s) for s in node_shape), op, offsets,
                      weights_np if op is not None else None))
        return op

    ck.CSFlatStencilOperator.try_build = classmethod(spy)
    return built


def spy_flat_launches(sk):
    """Record every FlatStencilOperator that launches its kernel, once
    each, with the launches it had made before (an operator of a cached
    hierarchy outlives the run that built it); returns the dict
    (id -> (operator, launches before)) it fills."""
    launched = {}
    orig = sk.FlatStencilOperator._launch

    def spy(self, x):
        launched.setdefault(id(self), (self, self.launches))
        return orig(self, x)

    sk.FlatStencilOperator._launch = spy
    return launched


def check_launched(sk, launched, label: str, results, record,
                   level_ms) -> None:
    """Every dense operator a main-path run launched (each MG level and
    weight dtype, each step operator, the projection), held against its
    plain version at its own shape on a random input, relative max error
    ≤ REL_TOL; the worst absolute errors go into ``results``, and the
    operators' launches, summed, into ``record[(label, variant, node shape,
    n_off)]``.  Each (variant, node shape, n_off) not yet in ``level_ms``
    is timed there (profiler device ms over 20 launches, and its bound).
    Empties ``launched``."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    seen = {}
    for op, before in launched.values():
        key = (label, op.variant, op.node_shape, op.n_off)
        record[key] = record.get(key, 0) + op.launches - before
        x = torch.randn((op.vdim, op.N), generator=gen, device="cuda")
        y = op.apply_flat(x)
        y_plain = sk.spmv_plain(op.W, x, op.deltas, op.vdim)
        rel = rel_err(y, y_plain)
        check(rel <= REL_TOL, f"{label}: {op.variant} at {op.node_shape} "
              f"({op.n_off} offsets) vs plain relative max error {rel:.3e}")
        res = results.setdefault(op.variant, {"max_abs_err": 0.0})
        res["max_abs_err"] = max(res["max_abs_err"],
                                 float((y - y_plain).abs().max()))
        worst, shapes, noffs = seen.get(op.variant, (0.0, [], set()))
        seen[op.variant] = (max(worst, rel), shapes + [op.node_shape],
                            noffs | {op.n_off})
        level = (op.variant, op.node_shape, op.n_off)
        if level not in level_ms:
            nbytes, flops, w_bytes = flat_cost(op)
            level_ms[level] = (
                device_ms(lambda: op.apply_flat(x), "flat_stencil_spmv_kernel",
                          reps=20),
                bound(nbytes, flops)[0], w_bytes < L2_BYTES)
        del x, y, y_plain
    launched.clear()
    torch.cuda.empty_cache()
    print(f"{label}: launched dense operators held against plain: "
          + ("; ".join(f"{v} worst rel {w:.3e} at {sorted(set(sh))} "
                       f"n_off {sorted(no)}"
                       for v, (w, sh, no) in sorted(seen.items()))
             or "none"), flush=True)


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
    scaled plane-stress operators of V2_CELLS, on V2_INPUTS random inputs,
    relative max error ≤ REL_TOL; timed at V2_TIMED, the times being those
    at 1025².  Also prints, and requires to lie above FAULT_MIN, what three
    planted faults read: the plain version with one offset's weights
    dropped, and with the weights in the other precision (f32 <-> bf16),
    and the kernel with one node near the end zeroed (``planted_tail``)."""
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
                      rel_err(y, sk.spmv_plain(W_other, x, op.deltas, 2)),
                      planted_tail(sk, op, x, y_plain))
            print(f"kernel {name} plane-stress nodes={mesh.node_shape} "
                  f"(N mod 8 = {op.N % 8}, "
                  f"{'wide' if op.N >= WIDE_MIN_NODES else 'narrow'} path): "
                  f"rel err on {V2_INPUTS} inputs "
                  f"{' '.join(f'{r:.3e}' for r in rels)} (abs {err:.3e}); "
                  f"planted faults: offset 0 dropped {faults[0]:.3e}, "
                  f"weights in the other precision {faults[1]:.3e}, a tail "
                  f"node zeroed {faults[2]:.3e}", flush=True)
            check(rel <= REL_TOL, f"{name} at {mesh.node_shape}: kernel vs "
                  f"plain relative max error {rel:.3e} > {REL_TOL}")
            check(min(faults) > FAULT_MIN, f"{name}: a planted fault "
                  f"reads {min(faults):.3e}, not above {FAULT_MIN}")
            del W_drop, W_other
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               err)
            if cells in V2_TIMED:
                results[name].update(time_flat(
                    sk, name, op, x, y_plain,
                    f"plane-stress nodes={mesh.node_shape}"))
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


def face_terms(mesh, spec, dim):
    """A ``boundary_conditions`` dict as the reference stepping takes it:
    Dirichlet (mask, value) pairs, Robin (axis, side, h, T_inf) and flux
    (axis, side, q) faces, driven (mask, amplitude) pairs and their (ω, φ).
    Written for the specs this script uses: faces named left/right (x),
    front/back or bottom/top (the second axis in 2D, y and z in 3D)."""
    import math

    names = {"left": (0, 0), "right": (0, 1)}
    names.update({"bottom": (1, 0), "top": (1, 1)} if dim == 2 else
                 {"front": (1, 0), "back": (1, 1), "bottom": (2, 0),
                  "top": (2, 1)})
    pairs, robin, flux, amp, omega, phase = [], [], [], [], 0.0, 0.0
    for face, sp in spec.items():
        axis, side = names[face]
        if not isinstance(sp, dict):
            sp = {"type": "dirichlet", "value": sp}
        if sp["type"] == "dirichlet":
            pairs.append((mesh.face_mask(axis, side), float(sp["value"])))
            if sp.get("amplitude"):
                amp.append((mesh.face_mask(axis, side), sp["amplitude"]))
                omega = 2.0 * math.pi / sp["period"]
                phase = sp.get("phase", 0.0)
        elif sp["type"] == "robin":
            robin.append((axis, side, sp["h"], sp["T_ambient"]))
        elif sp["type"] == "neumann":
            flux.append((axis, side, sp["flux"]))
    return dict(pairs=pairs, robin=robin, flux=flux, amp_pairs=amp,
                omega=omega, phase=phase)


def scan_line(label, st, steps, launches, extra=""):
    print(f"{label}: setup/scan/fetch={st['setup_seconds']:.3f}/"
          f"{st['scan_seconds']:.3f}/{st['fetch_seconds']:.3f} s steps/s="
          f"{steps / st['scan_seconds']:.3f} iterations/step="
          f"{st['cg_iterations'] / steps:.2f} relres="
          f"{st['relative_residual']:.3e} launches={launches}{extra}",
          flush=True)


def count_calls(module, name):
    """Count the calls of ``module.name``; returns the one-element list it
    counts in."""
    n = [0]
    orig = getattr(module, name)

    def counted(*a, **kw):
        n[0] += 1
        return orig(*a, **kw)

    setattr(module, name, counted)
    return n


def mixed_phase(api, run, hold_cs, data_dir, full=MIXED_3D, flat=MIXED_2D):
    """The ``_mixed`` tools on the card.  Full width: ``solve_heat_3D_mixed``
    with a driven Dirichlet face, a Robin face and a flux face, MG-PCG per
    step, with ``PDE_TPU_CS`` 0 and 1, at the default step tolerance and at
    ``MIXED_TIGHT_TOL``, each held against a float64 θ-scheme of the same
    weak form on the card; then ``solve_heat_2D_mixed`` (flat CG) against
    the float64 stepping on the host.  ``run(label, cs, fn)`` is one
    main-path run, ``hold_cs(built, label)`` holds the CS operators it
    built against plain."""
    import numpy as np
    import torch

    from pde_solver_tpu_torch.config import config_overrides
    from pde_solver_tpu_torch.mesh import box_mesh, rectangle_mesh
    from pde_solver_tpu_torch.ops import multigrid as mg

    steps, dt = full["num_steps"], full["dt"]
    n = (full["nx"] + 1) * (full["ny"] + 1) * (full["nz"] + 1)
    mg_calls = count_calls(mg, "mg_pcg")
    tols = (("", {}), (f" tol={MIXED_TIGHT_TOL:.0e}",
                       dict(transient_inner_tol=MIXED_TIGHT_TOL)))
    T_runs = {}
    for tag, cfg in tols:
        for cs in ("0", "1"):
            mg_calls[0] = 0
            label = f"mixed 3D{tag} PDE_TPU_CS={cs}"
            with config_overrides(**cfg):
                res, st, launches, cs_built = run(
                    label, cs, lambda: api.solve_heat_3D_mixed(
                        **full, data_dir=data_dir))
            T, times = field(res)
            os.remove(res.data_file)
            T_runs[tag, cs] = T
            refused = [s for s, op, *_ in cs_built if op is None]
            scan_line(label, st, steps, launches,
                      f" MG-PCG step solves={mg_calls[0]} CS levels="
                      f"{[s for s, op, *_ in cs_built if op is not None]} "
                      f"CS refused at={refused}")
            check(st["num_dofs"] == n, f"{label}: dof count {st['num_dofs']}")
            check(mg_calls[0] == steps, f"{label}: {mg_calls[0]} MG-PCG "
                  f"step solves in {steps} steps")
            check(bool(st["converged"]) and st["relative_residual"]
                  <= st["convergence_target"],
                  f"{label} did not converge: {st}")
            check(T.shape == (steps + 1, n) and times.shape == (steps + 1,)
                  and bool(np.all(np.isfinite(T))),
                  f"{label}: field {T.shape}")
            if cs == "0":
                for name in ("v1_f32", "v1_bf16"):
                    check(launches.get(name, 0) > 0,
                          f"{label} launched no {name}")
                check(not any(k.startswith("cs_") for k in launches),
                      f"{label} launched CS kernels")
            else:
                built = [op for _, op, *_ in cs_built if op is not None]
                check(bool(cs_built), f"{label}: the CS route was never "
                      f"tried")
                if built:
                    check(launches.get("cs_apply_v1", 0) > 0,
                          f"{label} built CS operators and launched none")
                    fine = built[0]
                    print(f"{label}: fine-level CS operator n_win="
                          f"{fine.n_win} ({fine.n_win * 1024 / fine.N:.4f} "
                          f"of the nodes) sets={len(fine.sets)}", flush=True)
                    hold_cs(cs_built, label)
                else:
                    print(f"{label}: try_build refused every level "
                          f"{refused}; the run stayed on the dense kernel",
                          flush=True)
                    check(launches.get("v1_f32", 0) > 0,
                          f"{label}: refused and launched no dense kernel")
            del cs_built
    t0 = time.perf_counter()
    mesh = box_mesh(full["nx"], full["ny"], full["nz"], (0.0, 0.0, 0.0),
                    (1.0, 1.0, 1.0))
    T_ref = theta_scheme_f64(mesh, dt=dt, num_steps=steps, T_initial=20.0,
                             device="cuda", **face_terms(
                                 mesh, full["boundary_conditions"], 3))
    torch.cuda.empty_cache()
    scale = np.abs(T_ref).max()
    left = mesh.flat_node_coords()[:, 0] == 0.0
    g_t = (100.0 + 20.0 * np.sin(2.0 * np.pi / 0.1 * dt
                                 * np.arange(1, steps + 1)))[:, None]
    print(f"mixed 3D: float64 reference {time.perf_counter() - t0:.3f} s",
          flush=True)
    for (tag, _), bound_f64, bound_route in zip(
            tols, (MIXED_DEFAULT_TOL, HEAT_F64_TOL),
            (MIXED_DEFAULT_TOL, MIXED_ROUTE_TOL)):
        T0, T1 = T_runs[tag, "0"], T_runs[tag, "1"]
        gaps = [float(np.abs(T - T_ref).max() / scale) for T in (T0, T1)]
        gap = float(np.abs(T1 - T0).max() / scale)
        drive_err = float(np.abs(T0[1:, left] - g_t).max())
        print(f"mixed 3D{tag}: max|ΔT|/max|T|: CS vs dense={gap:.3e} (bound "
              f"{bound_route}), dense vs f64={gaps[0]:.3e}, CS vs f64="
              f"{gaps[1]:.3e} (bound {bound_f64}); driven face off "
              f"100 + 20 sin(ωt) by {drive_err:.3e}", flush=True)
        check(gap <= bound_route, f"mixed 3D{tag} routes differ by "
              f"{gap:.3e}")
        check(drive_err <= 1e-4, f"mixed 3D{tag} driven face off by "
              f"{drive_err:.3e}")
        check(max(gaps) <= bound_f64, f"mixed 3D{tag} off the float64 "
              f"trajectory by {max(gaps):.3e}")
    del T_runs, T_ref

    # 2D at 256²: flat CG through K1 v1 at 7 offsets, against the host
    spec = dict(full["boundary_conditions"])
    mesh = rectangle_mesh(flat["nx"], flat["ny"], (0.0, 0.0), (1.0, 1.0))
    T_ref = theta_scheme_f64(mesh, dt=0.01, num_steps=50, T_initial=20.0,
                             **face_terms(mesh, spec, 2))
    for (tag, cfg), bound_ in zip(tols, (MIXED_DEFAULT_TOL, MIXED_2D_TOL)):
        label = f"mixed 2D{tag}"
        with config_overrides(**cfg):
            res, st, launches, _ = run(label, "0", lambda:
                                       api.solve_heat_2D_mixed(
                                           **flat, boundary_conditions=spec,
                                           data_dir=data_dir))
        T, _ = field(res)
        gap = float(np.abs(T - T_ref).max() / np.abs(T_ref).max())
        scan_line(label, st, 50, launches,
                  f" vs host f64 backward Euler max|ΔT|/max|T|={gap:.3e} "
                  f"(bound {bound_})")
        check(bool(st["converged"]) and T.shape == T_ref.shape,
              f"{label} did not converge: {st}")
        check(gap <= bound_, f"{label} off float64 by {gap:.3e}")
        check(launches.get("v1_f32", 0) > 0, f"{label} launched no v1_f32")


def gaussian_pulse(mesh, width, amplitude=1.0):
    """The advection tools' default initial field: a Gaussian pulse at the
    middle of the domain, zero on the boundary."""
    import numpy as np

    x = mesh.node_coords
    r2 = sum((x[..., a] - (mesh.origin[a] + 0.5 * mesh.extent[a])) ** 2
             for a in range(mesh.dim))
    return np.where(mesh.boundary_mask(), 0.0,
                    amplitude * np.exp(-r2 / (2.0 * width ** 2)))


def advection_phase(api, run, hold_cs, data_dir, full=ADVECTION_3D,
                    ab1=ADVECTION_AB1, flat=ADVECTION_2D):
    """The advection tools on the card.  Full width: ``solve_advection_3D``
    (CNAB2, flat CG on K1 v1 at 15 offsets) with ``PDE_TPU_CS`` 0 and 1,
    held against a float64 CNAB2 stepping on the card; one "ab1" run at a
    smaller size the same way; ``solve_advection_2D`` against the float64
    stepping on the host."""
    import numpy as np
    import torch

    from pde_solver_tpu_torch.mesh import box_mesh, rectangle_mesh

    def reference(kw, scheme, device):
        mesh = box_mesh(kw["nx"], kw["ny"], kw["nz"], (0.0, 0.0, 0.0),
                        (1.0, 1.0, 1.0))
        return theta_scheme_f64(
            mesh, [(mesh.boundary_mask(), 0.0)], kw["dt"], kw["num_steps"],
            theta=0.5 if scheme == "cnab2" else 1.0,
            kappa=kw.get("diffusivity", 0.01), velocity=[1.0, 0.0, 0.0],
            scheme=scheme,
            u0=gaussian_pulse(mesh, 0.15), device=device)

    steps = full["num_steps"]
    n = (full["nx"] + 1) * (full["ny"] + 1) * (full["nz"] + 1)
    c_runs = {}
    for cs in ("0", "1"):
        label = f"advection 3D PDE_TPU_CS={cs}"
        res, st, launches, cs_built = run(
            label, cs, lambda: api.solve_advection_3D(**full,
                                                      data_dir=data_dir))
        c, times = field(res)
        os.remove(res.data_file)
        c_runs[cs] = c
        scan_line(label, st, steps, launches,
                  f" cfl={st['cfl']:.3f} cell_peclet={st['cell_peclet']:.3f} "
                  f"scheme={st['scheme']}")
        check(st["num_dofs"] == n and st["scheme"] == "cnab2",
              f"{label}: {st}")
        check(st["cfl"] < 1.0 and st["cell_peclet"] < 2.0, f"{label}: {st}")
        check(bool(st["converged"]) and st["relative_residual"]
              <= st["convergence_target"], f"{label} did not converge: {st}")
        check(c.shape == (steps + 1, n) and times.shape == (steps + 1,)
              and bool(np.all(np.isfinite(c))), f"{label}: field {c.shape}")
        if cs == "0":
            check(launches.get("v1_f32", 0) > 0, f"{label}: no v1_f32")
            check(not any(k.startswith("cs_") for k in launches),
                  f"{label} launched CS kernels")
        else:
            built = [op for _, op, *_ in cs_built if op is not None]
            check(bool(cs_built), f"{label}: the CS route was never tried")
            if built:
                check(launches.get("cs_apply_v1", 0) > 0,
                      f"{label} built a CS operator and launched none")
                hold_cs(cs_built, label)
            else:
                print(f"{label}: try_build refused "
                      f"{[s for s, *_ in cs_built]}; the run stayed on the "
                      f"dense kernel", flush=True)
                check(launches.get("v1_f32", 0) > 0, f"{label}: no v1_f32")
        del cs_built
    t0 = time.perf_counter()
    c_ref = reference(full, "cnab2", "cuda")
    torch.cuda.empty_cache()
    scale = np.abs(c_ref).max()
    gaps = {cs: float(np.abs(c - c_ref).max() / scale)
            for cs, c in c_runs.items()}
    gap = float(np.abs(c_runs["1"] - c_runs["0"]).max() / scale)
    print(f"advection 3D: float64 CNAB2 reference "
          f"{time.perf_counter() - t0:.3f} s; max|Δc|/max|c|: CS vs dense="
          f"{gap:.3e}, dense vs f64={gaps['0']:.3e}, CS vs f64="
          f"{gaps['1']:.3e} (bound {ADVECTION_F64_TOL})", flush=True)
    check(gap <= HEAT_ROUTE_TOL, f"advection 3D routes differ by {gap:.3e}")
    for cs, g in gaps.items():
        check(g <= ADVECTION_F64_TOL, f"advection 3D (PDE_TPU_CS={cs}) off "
              f"the float64 trajectory by {g:.3e}")
    del c_runs, c_ref

    res, st, launches, _ = run("advection 3D ab1", "0", lambda:
                               api.solve_advection_3D(**ab1,
                                                      data_dir=data_dir))
    c = field(res)[0]
    c_ref = reference(ab1, "ab1", "cuda")
    torch.cuda.empty_cache()
    gap = float(np.abs(c - c_ref).max() / np.abs(c_ref).max())
    scan_line("advection 3D ab1", st, ab1["num_steps"], launches,
              f" scheme={st['scheme']} vs f64 AB1 max|Δc|/max|c|={gap:.3e} "
              f"(bound {ADVECTION_F64_TOL})")
    check(bool(st["converged"]) and st["scheme"] == "ab1"
          and gap <= ADVECTION_F64_TOL, f"advection ab1 off by {gap:.3e}")
    check(launches.get("v1_f32", 0) > 0, "advection ab1 launched no v1_f32")

    res, st, launches, _ = run("advection 2D", "0", lambda:
                               api.solve_advection_2D(**flat,
                                                      data_dir=data_dir))
    c = field(res)[0]
    mesh = rectangle_mesh(flat["nx"], flat["ny"], (0.0, 0.0), (1.0, 1.0))
    c_ref = theta_scheme_f64(mesh, [(mesh.boundary_mask(), 0.0)], 0.002, 200,
                             theta=0.5, kappa=flat.get("diffusivity", 0.01),
                             velocity=[1.0, 0.0],
                             u0=gaussian_pulse(mesh, 0.1))
    gap = float(np.abs(c - c_ref).max() / np.abs(c_ref).max())
    scan_line("advection 2D", st, 200, launches,
              f" cfl={st['cfl']:.3f} cell_peclet={st['cell_peclet']:.3f} vs "
              f"host f64 CNAB2 max|Δc|/max|c|={gap:.3e} (bound "
              f"{ADVECTION_F64_TOL})")
    check(bool(st["converged"]) and c.shape == c_ref.shape
          and gap <= ADVECTION_F64_TOL, f"advection 2D off by {gap:.3e}")
    check(launches.get("v1_f32", 0) > 0, "advection 2D launched no v1_f32")


def picard_f64(mesh, pairs, kappa0, beta, T_initial=50.0, tol=1e-8):
    """Float64 Picard iteration of −∇·(κ0(1+βT)∇T) = 0 on the host, κ at the
    mean of each cell's corner nodes, every linear solve by sparse LU;
    returns the flat field and the iterations."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from pde_solver_tpu_torch.mesh import flatten_values
    from pde_solver_tpu_torch.ops import assembly
    from pde_solver_tpu_torch.ops.bc import DirichletBC

    shape = mesh.node_shape
    bc = DirichletBC.from_masks(pairs, shape)
    free = np.asarray(bc.free_mask, np.float64).reshape(-1)
    g = (np.asarray(bc.values, np.float64) * (1.0 - bc.free_mask)).reshape(-1)
    P = sp.diags(free)
    T = np.where(free > 0, T_initial, g)
    for it in range(1, 41):
        Tn = T.reshape(shape)
        corners = [Tn[tuple(slice(c, Tn.shape[a] - 1 + c)
                            for a, c in enumerate(corner))]
                   for corner in np.ndindex(*([2] * mesh.dim))]
        kcells = kappa0 * (1.0 + beta * sum(corners) / len(corners))
        A = stencil_csr(assembly.assemble_scalar_stencil(
            mesh, "stiffness", cell_coeff=kcells), shape)
        T_new = spla.spsolve((P @ A @ P + sp.diags(1.0 - free)).tocsc(),
                             g - free * (A @ g))
        rel = np.linalg.norm(T_new - T) / np.linalg.norm(T_new)
        T = T_new
        if rel < tol:
            break
    return flatten_values(T.reshape(shape), mesh.dim), it


def analytic_phase(api, drive, data_dir, nonlinear=NONLINEAR_2D):
    """Closed forms through the new tools, at the sizes and within the
    bounds of the JAX package's own tests of these families: steady 1D
    Dirichlet–Robin and Dirichlet–flux lines and the sphere's A + B/r (host
    sparse LU as a user's call takes it, then on the card with
    ``host_direct_threshold=0``), the thermal wave, the Kirchhoff profile,
    the advected Gaussian; and the nonlinear 2D tool on the card against a
    float64 Picard iteration on the host."""
    import numpy as np

    from pde_solver_tpu_torch.config import config_overrides
    from pde_solver_tpu_torch.fields import load_field
    from pde_solver_tpu_torch.mesh import rectangle_mesh

    def both_paths(label, tool, kw, exact, rtol):
        """Relative error against ``exact(x)``: by host LU within ``rtol``,
        on the card within max(rtol, 1e-6)."""
        out = []
        for where, cfg, bound_ in (("host LU", {}, rtol),
                                   ("card", dict(host_direct_threshold=0),
                                    max(rtol, 1e-6))):
            with config_overrides(**cfg):
                res, st, launches = drive(f"{label} ({where})", lambda:
                                          getattr(api, tool)(
                                              **kw, data_dir=data_dir))
            f = load_field(res.data_file)
            u = np.asarray(f.values)[0]
            want = exact(np.linalg.norm(np.asarray(f.coords), axis=1))
            err = float(np.abs(u - want).max() / np.abs(want).max())
            out.append(f"{where} {err:.3e} (bound {bound_:.0e})")
            check(bool(st["converged"]) and err <= bound_,
                  f"{label} ({where}) off its closed form by {err:.3e}")
            check(bool(launches.get("v1_f32", 0)) == (where == "card"),
                  f"{label} ({where}): launches {launches}")
        print(f"{label}: max rel. error vs closed form: " + ", ".join(out),
              flush=True)

    kappa, L, T0, h, t_inf = 2.5, 3.0, 100.0, 7.0, 25.0
    c = h * (t_inf - T0) / (1.0 + h * L / kappa)
    both_paths("1D Dirichlet-Robin", "solve_heat_1D_mixed", dict(
        length=L, nx=32, diffusivity=kappa, steady=True, boundary_conditions={
            "left": T0, "right": {"type": "robin", "h": h,
                                  "T_ambient": t_inf}}),
        lambda x: T0 + c * x / kappa, 1e-8)
    both_paths("1D Dirichlet-flux", "solve_heat_1D_mixed", dict(
        length=2.0, nx=16, diffusivity=4.0, steady=True, boundary_conditions={
            "left": 0.0, "right": {"type": "neumann", "flux": 50.0}}),
        lambda x: 50.0 * x / 4.0, 1e-8)
    kappa, r1, r2, T0, h, t_inf = 2.0, 0.5, 1.5, 300.0, 8.0, 20.0
    A, B = np.linalg.solve(np.array([[1.0, 1.0 / r1],
                                     [h, h / r2 - kappa / r2 ** 2]]),
                           np.array([T0, h * t_inf]))
    both_paths("sphere Dirichlet-Robin", "solve_heat_radial_mixed", dict(
        kind="sphere", r_inner=r1, r_outer=r2, nr=400, diffusivity=kappa,
        steady=True, boundary_conditions={
            "inner": T0, "outer": {"type": "robin", "h": h,
                                   "T_ambient": t_inf}}),
        lambda r: A + B / r, 2e-5)

    # the thermal wave: T(0, t) = 10 sin(2πt) on a 4 m slab, 4 periods of
    # 256 Crank-Nicolson steps
    k = np.sqrt(np.pi)
    with config_overrides(theta=0.5):
        res, st, launches = drive("thermal wave 1D", lambda:
                                  api.solve_heat_1D_mixed(
                                      length=4.0, nx=512, T_initial=0.0,
                                      dt=1.0 / 256, num_steps=1024,
                                      data_dir=data_dir, boundary_conditions={
                                          "left": {"type": "dirichlet",
                                                   "value": 0.0,
                                                   "amplitude": 10.0,
                                                   "period": 1.0},
                                          "right": 0.0}))
    T, times = field(res)
    x = np.linspace(0.0, 4.0, 513)
    exact = 10.0 * np.exp(-k * x) * np.sin(2.0 * np.pi * times[-1] - k * x)
    zone = x < 2.5 / k
    err = float(np.abs(T[-1][zone] - exact[zone]).max())
    j = int(np.argmin(np.abs(k * x - 1.0)))
    amp = 0.5 * (T[-257:, j].max() - T[-257:, j].min())
    scan_line("thermal wave 1D", st, 1024, launches,
              f" max|T - A e^(-kx) sin(ωt - kx)|={err:.3e} (bound 0.5); "
              f"amplitude at kx = 1: {amp:.4f} (10/e = {10 / np.e:.4f}, "
              f"within 8 %)")
    check(bool(st["converged"]) and err < 0.5
          and abs(amp - 10.0 / np.e) <= 0.8 / np.e,
          f"thermal wave off: {err:.3e}, amplitude {amp:.4f}")
    check(launches.get("v1_f32", 0) > 0, "thermal wave launched no v1_f32")

    # Kirchhoff: κ0 (T + βT²/2) is harmonic
    res, st, launches = drive("Kirchhoff 1D (host sparse LU, no card)",
                              lambda: api.solve_heat_1D_nonlinear(
                                  length=1.0, nx=256, kappa0=2.0, beta=0.01,
                                  T_left=100.0, T_right=0.0,
                                  data_dir=data_dir))
    T = field(res)[0][0]
    x = np.linspace(0.0, 1.0, 257)
    th0 = 2.0 * (100.0 + 0.01 * 100.0 ** 2 / 2)
    exact = (-1.0 + np.sqrt(1.0 + 0.01 * th0 * (1.0 - x))) / 0.01
    err = float(np.abs(T - exact).max() / 100.0)
    print(f"Kirchhoff 1D: {st['picard_iterations']} Picard iterations, "
          f"max|ΔT|/100={err:.3e} (bound 2e-4)", flush=True)
    check(bool(st["converged"]) and err < 2e-4, f"Kirchhoff off {err:.3e}")

    res, st, launches = drive("nonlinear 2D", lambda:
                              api.solve_heat_2D_nonlinear(**nonlinear,
                                                          data_dir=data_dir))
    T = field(res)[0][0]
    mesh = rectangle_mesh(nonlinear["nx"], nonlinear["ny"], (0.0, 0.0),
                          (1.0, 1.0))
    T_ref, its = picard_f64(mesh, [(mesh.boundary_mask(), 0.0),
                                   (mesh.face_mask(0, 0), 100.0)],
                            1.0, nonlinear["beta"])
    gap = float(np.abs(T - T_ref).max() / np.abs(T_ref).max())
    print(f"nonlinear 2D: dof={st['num_dofs']} Picard iterations="
          f"{st['picard_iterations']} (host f64: {its}) CG iterations="
          f"{st['cg_iterations']} vs host f64 Picard with sparse LU "
          f"max|ΔT|/max|T|={gap:.3e} (bound 1e-6) launches={launches}",
          flush=True)
    check(bool(st["converged"]) and abs(st["picard_iterations"] - its) <= 1
          and gap <= 1e-6, f"nonlinear 2D off by {gap:.3e}: {st}")
    check(launches.get("v1_f32", 0) > 0, "nonlinear 2D launched no v1_f32")

    # the advected, diffusing Gaussian on (0, 3): first order in Δt ("ab1")
    kappa, s0, x0, T_end = 0.005, 0.08, 0.7, 0.6
    x = np.linspace(0.0, 3.0, 513)
    s2 = s0 ** 2 + 2 * kappa * T_end
    exact = (s0 / np.sqrt(s2)) * np.exp(-(x - x0 - T_end) ** 2 / (2 * s2))
    errs = []
    for nsteps in (600, 1200):
        with config_overrides(theta=0.5):
            res, st, launches = drive(
                f"gaussian transport 1D {nsteps} steps", lambda:
                api.solve_advection_1D(
                    length=3.0, nx=512, velocity=1.0, diffusivity=kappa,
                    pulse_center=x0, pulse_width=s0, dt=T_end / nsteps,
                    num_steps=nsteps, scheme="ab1", data_dir=data_dir))
        u = field(res)[0][-1]
        errs.append(float(np.linalg.norm(u - exact) / np.linalg.norm(exact)))
        check(bool(st["converged"]) and st["cfl"] < 1.0
              and abs(x[np.argmax(u)] - (x0 + T_end)) < 0.02,
              f"gaussian transport: {st}")
        check(launches.get("v1_f32", 0) > 0, "gaussian: no v1_f32")
    print(f"gaussian transport 1D: relL2 error {errs[0]:.3e} at 600 steps "
          f"(bound 0.03), {errs[1]:.3e} at 1200 (below 0.65 of the first)",
          flush=True)
    check(errs[0] < 0.03 and errs[1] < 0.65 * errs[0],
          f"gaussian transport errors {errs}")


def probe_bytes_flops(name, op, tile=None):
    """Bytes a probe must move (each input read once, each output written
    once) and its float32 operations, for ``op``'s shape and weight type."""
    nw = op.n_off * op.vdim * op.vdim
    xy = 2 * op.vdim * op.N * 4
    if name == "wonly":
        return nw * op.N_pad * op.W.element_size() + op.N_pad * 4, \
            float(nw * op.N_pad)
    if name == "shifts":
        return xy, 2.0 * nw * op.N
    if name == "residentw":
        return xy + tile.numel() * tile.element_size(), 2.0 * nw * op.N
    # csz: two mask planes, three constant sets and the two joins
    return xy + 2 * op.N_pad * 4, (6.0 * nw + 4.0 * op.vdim) * op.N


def time_probe(label, name, kernel, plain, cost, reps_p=3, library=None,
               beside=""):
    """Times one probe: events in turns (plain, library, kernel, kernel,
    library, plain), profiler device ms, and where its bytes fit the L2 the
    device ms with 128 MB written between launches.  Prints one line and
    returns the fields of the result line."""
    import torch

    nbytes, flops = cost
    bound_ms, bound_by = bound(nbytes, flops)
    ms, plain_ms, library_ms = turns(kernel, plain, 50, reps_p,
                                     library=library)
    dev = device_ms(kernel, f"{name}_kernel")
    l2 = nbytes < L2_BYTES
    cold = None
    if l2:
        flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
        cold = device_ms(lambda: (flush.zero_(), kernel()), f"{name}_kernel")
        del flush
    print(f"probe {name} {label}: ms={ms:.4f} device_ms={dev:.4f} plain_ms="
          f"{plain_ms:.4f} library_ms="
          f"{'none' if library_ms is None else f'{library_ms:.4f}'} "
          f"bound_ms={bound_ms:.4f} ({bound_by}; {nbytes / 1e6:.1f} MB) "
          f"share={bound_ms / ms:.3f}"
          + (f" (fits L2: not a share of HBM) | L2 emptied between "
             f"launches: device {cold:.4f}, share of HBM "
             f"{bound_ms / cold:.3f}" if l2 else
             f" -> {nbytes / ms / 1e6:.1f} GB/s by events, "
             f"{nbytes / dev / 1e6:.1f} GB/s by device time")
          + beside, flush=True)
    return dict(ms=ms, device_ms=dev, plain_ms=plain_ms,
                library_ms=library_ms,
                library_note=None if library else PROBE_NO_LIBRARY,
                bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms,
                shape=label, l2_resident=l2, cold_device_ms=cold,
                cold_share=None if cold is None else bound_ms / cold)


def probe_checks(fp, sk, op, x, label, results):
    """The four probes on ``op``'s weights (f32 and bf16 where a probe reads
    weights) against their plain versions, relative max error ≤ REL_TOL,
    and one planted fault each that must read > FAULT_MIN.  Returns what
    the timings need: (op16, tiles, constants, masks)."""
    import torch

    v, deltas = op.vdim, op.deltas
    op16 = op.as_weight_dtype(torch.bfloat16)
    wc, dz0, dz1 = fp.probe_constants(op.n_off * v * v)
    masks = fp.face_masks(op.N_pad, op.node_shape[-1], x.device)
    tiles = {}
    rels = {}

    def hold(name, y, y_plain):
        if x.is_cuda:
            torch.cuda.synchronize()
        rel = rel_err(y, y_plain)
        check(rel <= REL_TOL, f"probe {name} at {label}: kernel vs plain "
              f"relative max error {rel:.3e} > {REL_TOL}")
        res = results.setdefault(name.split()[0], {"max_abs_err": 0.0})
        res["max_abs_err"] = max(res["max_abs_err"],
                                 float((y - y_plain).abs().max()))
        rels[name] = rel
        return y_plain

    plains = {}
    for wt, o in (("f32", op), ("bf16", op16)):
        plains[f"wonly {wt}"] = hold(f"wonly {wt}", fp.wonly(o.W),
                                     fp.wonly_plain(o.W))
        tiles[wt] = fp.weight_tile(o.W)
        plains[f"residentw {wt}"] = hold(
            f"residentw {wt}", fp.residentw(tiles[wt], x, deltas, v),
            fp.residentw_plain(tiles[wt], x, deltas, v))
    plains["shifts"] = hold("shifts", fp.shifts(x, deltas, v, wc),
                            fp.shifts_plain(x, deltas, v, wc))
    plains["csz"] = hold("csz", fp.csz(masks, x, deltas, v, wc, dz0, dz1),
                         fp.csz_plain(masks, x, deltas, v, wc, dz0, dz1))
    # one planted fault a probe, each in the last, partial group of nodes
    n = op.N - 2
    W_bad = op.W.clone()
    W_bad[op.W.shape[0] // 2, n] += 10.0 * float(plains["wonly f32"].abs().max())
    tile_bad = tiles["f32"].clone()
    tile_bad[:, n % tile_bad.shape[1]] = 0
    wc_bad = wc.copy()
    wc_bad[deltas.index(0) * v * v] *= 1.1
    m_bad = masks.clone()
    m_bad[1] = 0
    faults = {
        "wonly": rel_err(fp.wonly(W_bad), plains["wonly f32"]),
        "residentw": rel_err(fp.residentw(tile_bad, x, deltas, v),
                             plains["residentw f32"]),
        "shifts": rel_err(fp.shifts(x, deltas, v, wc_bad), plains["shifts"]),
        "csz": rel_err(fp.csz(m_bad, x, deltas, v, wc, dz0, dz1),
                       plains["csz"])}
    del W_bad, tile_bad, m_bad
    print(f"probes {label} N={op.N} (N mod 4 = {op.N % 4}) v{v}: rel err "
          + ", ".join(f"{k} {r:.3e}" for k, r in rels.items())
          + "; planted faults: "
          + ", ".join(f"{k} {r:.3e}" for k, r in faults.items()), flush=True)
    check(min(faults.values()) > FAULT_MIN, f"probes at {label}: a planted "
          f"fault reads {min(faults.values()):.3e}, not above {FAULT_MIN}")
    return op16, tiles, (wc, dz0, dz1), masks


def floor_phase(fp, sk, ck, cases=None, ragged=FLOOR_RAGGED, device="cuda",
                timed=True):
    """The four floor probes against their plain versions on the card: at
    the flagship's fine-level elasticity operator (161×65×65, vdim 3) and
    the heat slice's (129³, vdim 1), and on random weights at two ragged
    tails; then their times beside their bounds, P1 beside K1 and P2 / P4
    beside the fused CS kernel at the same shape.  The first case gives the
    result line's numbers.  Returns per-probe results."""
    import torch

    if cases is None:
        cases = (("flagship elasticity 161x65x65", 3, elasticity_operator),
                 ("heat 129^3", 1,
                  lambda: heat_operator((128, 128, 128))))
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    results = {}
    for label, vdim, build in cases:
        mesh, sysm = build()
        op = sk.FlatStencilOperator(sysm.offsets, sysm.weights,
                                    mesh.node_shape, vdim=vdim, device=device)
        x = torch.randn((vdim, op.N), generator=gen, device=device)
        op16, tiles, (wc, dz0, dz1), masks = probe_checks(fp, sk, op, x,
                                                          label, results)
        if timed:
            d = op.deltas
            k1 = {wt: device_ms(lambda o=o: o.apply_flat(x),
                                "flat_stencil_spmv_kernel")
                  for wt, o in (("f32", op), ("bf16", op16))}
            cs = ck.CSFlatStencilOperator.try_build(
                sysm.offsets, sysm.weights, mesh.node_shape, vdim=vdim,
                device=device)
            check(cs is not None, f"{label}: CS build refused")
            cs_ms = device_ms(lambda: cs.apply_flat(x), "cs_apply_kernel")
            del cs
            fields = {}
            for wt, o in (("f32", op), ("bf16", op16)):
                W = o.W
                fields[f"wonly {wt}"] = time_probe(
                    f"{label} {wt}", "wonly", lambda: fp.wonly(W),
                    lambda: fp.wonly_plain(W),
                    probe_bytes_flops("wonly", o),
                    library=lambda: W.sum(0, dtype=torch.float32),
                    beside=f" | K1 {wt} at this shape: device "
                           f"{k1[wt]:.4f} ms")
                t = tiles[wt]
                fields[f"residentw {wt}"] = time_probe(
                    f"{label} {wt}", "residentw",
                    lambda: fp.residentw(t, x, d, vdim),
                    lambda: fp.residentw_plain(t, x, d, vdim),
                    probe_bytes_flops("residentw", o, t),
                    beside=f" | K1 {wt}: device {k1[wt]:.4f} ms")
            lib_rel = rel_err(op.W.sum(0, dtype=torch.float32),
                              fp.wonly_plain(op.W))
            check(lib_rel <= REL_TOL, f"{label}: W.sum(0) vs wonly_plain "
                  f"{lib_rel:.3e}")
            beside = f" | fused CS kernel at this shape: device {cs_ms:.4f} ms"
            fields["shifts"] = time_probe(
                label, "shifts", lambda: fp.shifts(x, d, vdim, wc),
                lambda: fp.shifts_plain(x, d, vdim, wc),
                probe_bytes_flops("shifts", op), beside=beside)
            fields["csz"] = time_probe(
                label, "csz",
                lambda: fp.csz(masks, x, d, vdim, wc, dz0, dz1),
                lambda: fp.csz_plain(masks, x, d, vdim, wc, dz0, dz1),
                probe_bytes_flops("csz", op), beside=beside)
            for name, f in fields.items():
                res = results[name.split()[0]]
                if name.endswith("bf16"):
                    res.setdefault("bf16", {})[label] = {
                        k: f[k] for k in ("ms", "device_ms", "bound_ms",
                                          "share", "library_ms",
                                          "cold_device_ms")}
                elif "ms" not in res:
                    res.update(f)
        del op, op16, tiles, masks, x, mesh, sysm
        if device == "cuda":
            torch.cuda.empty_cache()
    # ragged tails on random weights (N mod 4 = 3 and 1), vdim 3 and 1
    tiny = sorted_p1_offsets()
    for vdim, shape in zip((3, 1), ragged):
        N = shape[0] * shape[1] * shape[2]
        W = torch.zeros((len(tiny) * vdim * vdim, sk.padded_length(N)),
                        device=device)
        W[:, :N] = torch.randn((W.shape[0], N), generator=gen, device=device)
        op = sk.FlatStencilOperator.from_packed(W, tiny, shape, vdim)
        x = torch.randn((vdim, N), generator=gen, device=device)
        probe_checks(fp, sk, op, x, f"ragged {shape}", results)
        del W, op, x
    if device == "cuda":
        torch.cuda.empty_cache()
    return results


def sorted_p1_offsets():
    """The 15 offsets of the sorted P1 stencil of a 3D mesh."""
    from pde_solver_tpu_torch.mesh import box_mesh
    from pde_solver_tpu_torch.ops import assembly

    tiny = box_mesh(2, 2, 2, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    return tuple(sorted(assembly.assemble_elasticity_stencil(tiny, 1.0, 1.0)))


def block_stencil_csr(stencil, shape, vdim):
    """A numpy (block) stencil {offset: weights [*shape(, v, v)]} as a
    float64 scipy CSR matrix, DOFs in C order (node·v + component)."""
    import numpy as np
    import scipy.sparse as sp

    if vdim == 1:
        return stencil_csr(stencil, shape)
    N = int(np.prod(shape))
    strides = np.cumprod((1,) + tuple(shape[::-1]))[:-1][::-1]
    node = np.arange(N)
    rows, cols, vals = [], [], []
    for off, W in stencil.items():
        c = node + int(np.dot(off, strides))
        ok = (c >= 0) & (c < N)
        Wf = np.asarray(W, np.float64).reshape(N, vdim, vdim)
        for a in range(vdim):
            for b in range(vdim):
                rows.append(node[ok] * vdim + a)
                cols.append(c[ok] * vdim + b)
                vals.append(Wf[ok, a, b])
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                 np.concatenate(cols))),
                         shape=(N * vdim, N * vdim))


def newmark_f64(K, M, free, f, u0, v0, dt, num_steps, beta=0.25, gamma=0.5,
                device=None):
    """Float64 Newmark-β of M ü + K u = f written from the scheme: the
    constrained DOFs keep u0 with v = a = 0; M a0 = f − K u0 and every step
    (M + βΔt²K) a⁺ = f − K ũ on the free DOFs.  ``K``, ``M`` scipy CSR,
    the vectors flat.  On the host (no ``device``) by one sparse LU of each
    matrix; on ``device`` by Jacobi-PCG on torch sparse CSR, warm-started,
    to a true relative residual ≤ 1e-12.  Returns (us, vs), each
    [num_steps + 1, n]."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    idx = np.flatnonzero(free)
    Kff = K[idx][:, idx].tocsr()
    Mff = M[idx][:, idx].tocsr()
    A = (Mff + (beta * dt * dt) * Kff).tocsr()
    # the pinned values' pull on the free rows
    ff = f[idx] - (K[idx] @ (u0 * (1.0 - free)))
    u, v = u0[idx].copy(), v0[idx].copy()
    c1, c2 = dt * dt * (0.5 - beta), beta * dt * dt

    if device is None:
        lu_m, lu_a = spla.splu(Mff.tocsc()), spla.splu(A.tocsc())
        solve_m, solve_a = (lambda b, x0: lu_m.solve(b)), \
            (lambda b, x0: lu_a.solve(b))
        Kmv = lambda x: Kff @ x                    # noqa: E731
        to_host = lambda x: x                      # noqa: E731
    else:
        import torch

        def dev_csr(S):
            return torch.sparse_csr_tensor(
                torch.from_numpy(S.indptr.astype(np.int64)),
                torch.from_numpy(S.indices.astype(np.int64)),
                torch.from_numpy(S.data), size=S.shape,
                dtype=torch.float64).to(device)

        def pcg(S, dinv):
            def solve(b, x):
                bn = float(torch.linalg.vector_norm(b))
                if bn == 0.0:
                    return torch.zeros_like(b)
                r = b - (S @ x[:, None])[:, 0]
                z = dinv * r
                p, rz = z, torch.dot(r, z)
                for it in range(1, 20001):
                    Ap = (S @ p[:, None])[:, 0]
                    alpha = rz / torch.dot(p, Ap)
                    x = x + alpha * p
                    r = r - alpha * Ap
                    if it % 10 == 0 and float(torch.linalg.vector_norm(
                            b - (S @ x[:, None])[:, 0])) <= 1e-12 * bn:
                        break
                    z = dinv * r
                    rz_new = torch.dot(r, z)
                    p, rz = z + (rz_new / rz) * p, rz_new
                relres = float(torch.linalg.vector_norm(
                    b - (S @ x[:, None])[:, 0])) / bn
                check(relres <= 1e-12, f"float64 Newmark reference: relres "
                      f"{relres:.3e} after {it} iterations")
                iters[0] += it
                return x
            return solve

        iters = [0]
        Kd = dev_csr(Kff)
        solve_m = pcg(dev_csr(Mff),
                      torch.from_numpy(1.0 / Mff.diagonal()).to(device))
        solve_a = pcg(dev_csr(A),
                      torch.from_numpy(1.0 / A.diagonal()).to(device))
        Kmv = lambda x: (Kd @ x[:, None])[:, 0]    # noqa: E731
        to_host = lambda x: x.cpu().numpy()        # noqa: E731
        ff, u, v = (torch.from_numpy(a).to(device) for a in (ff, u, v))

    a = solve_m(ff - Kmv(u), 0.0 * u)
    us, vs = [to_host(u)], [to_host(v)]
    for _ in range(num_steps):
        u_pred = u + dt * v + c1 * a
        a_new = solve_a(ff - Kmv(u_pred), a)
        u = u_pred + c2 * a_new
        v = v + dt * ((1.0 - gamma) * a + gamma * a_new)
        a = a_new
        us.append(to_host(u))
        vs.append(to_host(v))
    if device is not None:
        print(f"float64 Newmark reference, {len(idx)} free DOF: {iters[0]} "
              f"PCG iterations over {num_steps} steps", flush=True)

    def full(frames, pinned):
        out = np.tile(pinned * (1.0 - free), (len(frames), 1))
        out[:, idx] = np.stack(frames)
        return out

    return full(us, u0), full(vs, np.zeros_like(u0))


def spy_newmark():
    """Keep the arguments and the result of every ``run_newmark`` call (the
    tools return the displacement magnitude or flat values only); returns
    the list of (args, kwargs, NewmarkResult)."""
    from pde_solver_tpu_torch.models import wave
    from pde_solver_tpu_torch.ops import timestepping

    calls = []
    orig = timestepping.run_newmark

    def spy(*a, **kw):
        res = orig(*a, **kw)
        calls.append((a, kw, res))
        return res

    timestepping.run_newmark = spy     # elasticity imports it at call time
    wave.run_newmark = spy
    return calls


def energy_share(K_np, M_np, f_np, res, parts=False):
    """|½vᵀMv + ½uᵀKu − fᵀu| / |fᵀu| at the last frame of a Newmark run
    started at rest from u = 0 (where the balance is 0), on the host in
    float64; with ``parts`` also the balance and fᵀu."""
    import numpy as np

    from pde_solver_tpu_torch.ops.linsolve import np_stencil_apply

    u, v = res.values[-1], res.velocities[-1]
    d, vdim = u.ndim - 1, u.shape[-1]
    work = float(np.sum(f_np * u))
    energy = 0.5 * float(np.sum(v * np_stencil_apply(M_np, v, d, vdim))) \
        + 0.5 * float(np.sum(u * np_stencil_apply(K_np, u, d, vdim))) - work
    share = abs(energy) / abs(work)
    return (share, energy, work) if parts else share


def newmark_line(label, res, steps, launches, extra=""):
    print(f"{label}: setup/scan/fetch={res.setup_seconds:.3f}/"
          f"{res.scan_seconds:.3f}/{res.fetch_seconds:.3f} s steps/s="
          f"{steps / res.scan_seconds:.3f} iterations/step="
          f"{res.total_cg_iterations / steps:.2f} relres="
          f"{res.max_relative_residual:.3e} launches={launches}{extra}",
          flush=True)


def standing_mode_tol(dim, k, h, omega, T, dt):
    """Bound on max|u − Π sin(k xᵢ) cos(ωt)| of a Newmark run from the
    projected sine, 1.5 × the sum of what is known to differ: the
    consistent-mass projection raises the nodal amplitude by (kh)²/12 an
    axis; the average-acceleration scheme stretches the period by (ωΔt)²/12
    a radian and the P1 mesh shortens it by (kh)²/24, over ωT radians."""
    kh2 = (k * h) ** 2
    return 1.5 * (dim * kh2 / 12.0
                  + omega * T * ((omega * dt) ** 2 / 12.0 + kh2 / 24.0))


def wave_matrices(mesh, c=1.0):
    """(K, M, free) of the wave tools' weak form as float64 scipy CSR:
    c²·stiffness, mass, all-boundary Dirichlet."""
    import numpy as np

    from pde_solver_tpu_torch.ops import assembly

    K = stencil_csr(assembly.assemble_scalar_stencil(mesh, "stiffness"),
                    mesh.node_shape) * (c * c)
    M = stencil_csr(assembly.assemble_scalar_stencil(mesh, "mass"),
                    mesh.node_shape)
    free = (~np.asarray(mesh.boundary_mask(), bool)).astype(np.float64)
    return K.tocsr(), M, free.reshape(-1)


def newmark_phase(api, run, hold_cs, data_dir, wave=WAVE_3D,
                  beam=DYNAMIC_3D, small=DYNAMIC_SMALL, device="cuda"):
    """The Newmark tools on the card.  Full width: ``solve_wave_3D`` (MG-PCG
    per step, ``PDE_TPU_CS`` 0 and 1) against the standing mode and a
    float64 Newmark of the same M, K on the card; ``solve_elasticity_3D_
    dynamic`` on the flagship's mesh (a cantilever released under gravity)
    with its energy balance, and at a small size against a float64 Newmark
    (on ``device``, or by sparse LU on the host without one);
    ``solve_wave_1D`` / ``solve_wave_2D`` at
    their default sizes against their standing modes."""
    import numpy as np

    from pde_solver_tpu_torch.config import config_overrides
    from pde_solver_tpu_torch.mesh import (box_mesh, flatten_values,
                                           interval_mesh, rectangle_mesh)
    from pde_solver_tpu_torch.ops import multigrid as mg

    calls = spy_newmark()
    mg_calls = count_calls(mg, "mg_pcg")

    # -- wave 3D at full width ------------------------------------------------
    steps, dt = wave["num_steps"], wave["dt"]
    cells = (wave["nx"], wave["ny"], wave["nz"])
    n = int(np.prod([c + 1 for c in cells]))
    u_runs = {}
    for cs in ("0", "1"):
        label = f"wave 3D PDE_TPU_CS={cs}"
        mg_calls[0] = 0
        del calls[:]
        res, st, launches, cs_built = run(label, cs, lambda: api.solve_wave_3D(
            **wave, data_dir=data_dir))
        u, times = field(res)
        os.remove(res.data_file)
        nres = calls[-1][2]
        # node order of the grid (C order), as the float64 reference's
        u_runs[cs] = (nres.values.reshape(steps + 1, -1),
                      nres.velocities.reshape(steps + 1, -1))
        check(np.array_equal(u[-1], flatten_values(nres.values[-1], 3)),
              f"{label}: the artifact's last frame is not the scan's")
        levels = sorted(s for s, op, *_ in cs_built if op is not None)
        newmark_line(label, calls[-1][2], steps, launches,
                     f" MG-PCG step solves={mg_calls[0]} CS levels={levels}")
        check(st["num_dofs"] == n and st["integrator"] == "newmark_beta",
              f"{label}: {st}")
        check(mg_calls[0] == steps, f"{label}: {mg_calls[0]} MG-PCG step "
              f"solves in {steps} steps")
        check(bool(st["converged"]) and st["relative_residual"]
              <= st["convergence_target"], f"{label} did not converge: {st}")
        check(u.shape == (steps + 1, n) and times.shape == (steps + 1,)
              and bool(np.all(np.isfinite(u))), f"{label}: field {u.shape}")
        if cs == "0":
            for name in ("v1_f32", "v1_bf16"):
                check(launches.get(name, 0) > 0, f"{label} launched no {name}")
            check(not any(k.startswith("cs_") for k in launches),
                  f"{label} launched CS kernels")
        else:
            want = sorted(tuple(c // f + 1 for c in cells) for f in (1, 2)
                          if np.prod([c // f + 1 for c in cells]) >= 65536)
            # the fine level twice: the step operator's, and the mass
            # operator's of the initial field's consistent-mass projection
            check(sorted(set(levels)) == want, f"{label}: CS levels "
                  f"{levels}, expected {want} (those of ≥ 65,536 DOF)")
            check(bool(levels) == bool(launches.get("cs_apply_v1", 0)),
                  f"{label}: CS levels {levels}, launches {launches}")
            hold_cs(cs_built, label)
        del cs_built
    mesh = box_mesh(*cells, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    omega = np.sqrt(3.0) * np.pi
    mode = np.prod(np.sin(np.pi * mesh.node_coords), axis=-1).reshape(-1)
    exact = mode[None, :] * np.cos(omega * times)[:, None]
    analytic_tol = standing_mode_tol(3, np.pi, 1.0 / min(cells), omega,
                                     times[-1], dt)
    t0 = time.perf_counter()
    K, M, free = wave_matrices(mesh)
    u_ref, v_ref = newmark_f64(K, M, free, np.zeros(n), u_runs["0"][0][0],
                               np.zeros(n), dt, steps, device=device)
    del K, M
    ref_s = time.perf_counter() - t0
    vscale = np.abs(v_ref).max()
    for cs, (u, v) in u_runs.items():
        err = float(np.abs(u - exact).max())
        gap_u = float(np.abs(u - u_ref).max() / np.abs(u_ref).max())
        gap_v = float(np.abs(v - v_ref).max() / vscale)
        print(f"wave 3D PDE_TPU_CS={cs}: max|u - Π sin(πxᵢ) cos(√3πt)|="
              f"{err:.3e} (bound {analytic_tol:.3e}); vs float64 Newmark "
              f"max|Δu|/max|u|={gap_u:.3e} max|Δv|/max|v|={gap_v:.3e} "
              f"(bound {NEWMARK_F64_TOL})", flush=True)
        check(err <= analytic_tol, f"wave 3D (PDE_TPU_CS={cs}) off the "
              f"standing mode by {err:.3e}")
        check(max(gap_u, gap_v) <= NEWMARK_F64_TOL, f"wave 3D (PDE_TPU_CS="
              f"{cs}) off the float64 Newmark by {gap_u:.3e} / {gap_v:.3e}")
    gap = float(np.abs(u_runs["1"][0] - u_runs["0"][0]).max())
    print(f"wave 3D: float64 reference {ref_s:.3f} s; CS vs dense "
          f"max|Δu|={gap:.3e} (bound {HEAT_ROUTE_TOL})", flush=True)
    check(gap <= HEAT_ROUTE_TOL, f"wave 3D routes differ by {gap:.3e}")
    del u_runs, u_ref, v_ref, exact

    # -- the cantilever released under gravity, full width --------------------
    steps = beam["num_steps"]
    bcells = (beam["nx"], beam["ny"], beam["nz"])
    nodes = tuple(c + 1 for c in bcells)
    label = "dynamic 3D " + "x".join(str(c) for c in bcells)
    mg_calls[0] = 0
    del calls[:]
    res, st, launches, _ = run(label, "0", lambda:
                               api.solve_elasticity_3D_dynamic(
                                   **beam, data_dir=data_dir))
    mag, times = field(res)
    os.remove(res.data_file)
    (K_np, M_np, _, _, f_np, *_), _, nres = calls[-1]
    newmark_line(label, nres, steps, launches,
                 f" MG-PCG step solves={mg_calls[0]}")
    check(st["num_dofs"] == 3 * int(np.prod(nodes)), f"{label}: {st}")
    check(mg_calls[0] == steps and bool(st["converged"]),
          f"{label}: {mg_calls[0]} MG-PCG step solves, {st}")
    check(mag.shape == (steps + 1, int(np.prod(nodes)))
          and bool(np.all(np.isfinite(mag))), f"{label}: field {mag.shape}")
    for name in ("v3_f32", "v3_bf16"):
        check(launches.get(name, 0) > 0, f"{label} launched no {name}")
    clamp = float(max(np.abs(nres.values[:, 0]).max(),
                      np.abs(nres.velocities[:, 0]).max()))
    # Euler–Bernoulli tip deflection of the static beam, q L⁴ / (8 E I)
    q = abs(beam["body_fz"]) * beam["Ly"] * beam["Lz"]
    inertia = beam["Ly"] * beam["Lz"] ** 3 / 12.0
    static = q * beam["Lx"] ** 4 / (8.0 * FLAGSHIP["E"] * inertia)
    t0 = time.perf_counter()
    share, energy, work = energy_share(K_np, M_np, f_np, nres, parts=True)
    print(f"{label}: clamped face max|u|,|v|={clamp:.3e}; max|u|="
          f"{mag.max():.6e} m at t={times[-1]:.1e} s (static tip deflection "
          f"q L^4/(8EI) = {static:.6e} m, bound 2.2x); energy balance "
          f"½vᵀMv + ½uᵀKu − fᵀu = {energy:.6e} J against fᵀu = {work:.6e} J "
          f"(share {share:.3e}, bound {ENERGY_TOL}; host f64, "
          f"{time.perf_counter() - t0:.3f} s)", flush=True)
    check(clamp == 0.0, f"{label}: the clamped face moved by {clamp:.3e}")
    check(0.0 < mag.max() <= 2.2 * static, f"{label}: max|u| {mag.max():.3e} "
          f"against 2× the static deflection {static:.3e}")
    check(share <= ENERGY_TOL, f"{label}: energy balance off by "
          f"{share:.3e} of fᵀu")
    del K_np, M_np, nres, mag
    del calls[:]

    # -- the same tool at a small size against a float64 Newmark ---------------
    scells = (small["nx"], small["ny"], small["nz"])
    label = "dynamic 3D " + "x".join(str(c) for c in scells)
    with config_overrides(transient_mg_threshold=100, mg_threshold=100):
        res, st, launches, _ = run(label, "0", lambda:
                                   api.solve_elasticity_3D_dynamic(
                                       **small, data_dir=data_dir))
    (K_np, M_np, smesh, bc, f_np, u0, v0, *_), _, nres = calls[-1]
    t0 = time.perf_counter()
    shape = smesh.node_shape
    u_ref, v_ref = newmark_f64(
        block_stencil_csr(K_np, shape, 3), block_stencil_csr(M_np, shape, 3),
        np.asarray(bc.free_mask, np.float64).reshape(-1), f_np.reshape(-1),
        u0.reshape(-1), v0.reshape(-1), small["dt"], small["num_steps"],
        device=device)
    nd = u_ref.shape[1]
    gap_u = float(np.abs(nres.values.reshape(-1, nd) - u_ref).max()
                  / np.abs(u_ref).max())
    gap_v = float(np.abs(nres.velocities.reshape(-1, nd) - v_ref).max()
                  / np.abs(v_ref).max())
    share = energy_share(K_np, M_np, f_np, nres)
    newmark_line(label, nres, small["num_steps"], launches,
                 f" energy balance off by {share:.3e} of fᵀu;"
                 f" vs float64 Newmark "
                 f"({time.perf_counter() - t0:.3f} s) max|Δu|/max|u|="
                 f"{gap_u:.3e} max|Δv|/max|v|={gap_v:.3e} (bound "
                 f"{DYNAMIC_F64_TOL})")
    check(bool(st["converged"]) and max(gap_u, gap_v) <= DYNAMIC_F64_TOL,
          f"{label} off the float64 Newmark by {gap_u:.3e} / {gap_v:.3e}")
    check(launches.get("v3_f32", 0) > 0 and launches.get("v3_bf16", 0) > 0,
          f"{label}: launches {launches}")
    del calls[:], K_np, M_np, u_ref, v_ref

    # -- wave 1D and 2D at their default sizes against their standing modes ---
    for tool, kw, make, omega_of in (
            ("solve_wave_1D", {}, lambda: interval_mesh(50, 0.0, 2.0),
             lambda k: k),
            ("solve_wave_2D", {}, lambda: rectangle_mesh(30, 30, (0.0, 0.0),
                                                         (1.0, 1.0)),
             lambda k: np.sqrt(2.0) * k)):
        res, st, launches, _ = run(tool, "0", lambda: getattr(api, tool)(
            **kw, data_dir=data_dir))
        u, times = field(res)
        m = make()
        k = np.pi / min(m.extent)
        omega = omega_of(k)
        mode = flatten_values(np.prod(np.sin(k * m.node_coords), axis=-1),
                              m.dim)
        err = float(np.abs(u - mode[None, :] * np.cos(omega * times)[:, None])
                    .max())
        tol = standing_mode_tol(m.dim, k, max(m.spacing), omega, times[-1],
                                0.01)
        newmark_line(tool, calls[-1][2], len(times) - 1, launches,
                     f" max|u - mode·cos(ωt)|={err:.3e} (bound {tol:.3e})")
        check(bool(st["converged"]) and err <= tol,
              f"{tool} off its standing mode by {err:.3e}")
        check(launches.get("v1_f32", 0) > 0, f"{tool} launched no v1_f32")
        del calls[:]


def modal_phase(api, drive, data_dir, box=MODAL_3D, plate=MODAL_2D):
    """The modal tools on the card against ``scipy.sparse.linalg.eigsh`` of
    the same pencil on the free DOFs (shift-invert at 0, host float64):
    3D above ``mg_threshold`` (MG + the double-float32 F-cycle, one
    hierarchy build and then cache hits, both counted), 2D under it (flat
    CG with float64 refinement)."""
    import numpy as np
    import scipy.sparse.linalg as spla

    from pde_solver_tpu_torch.mesh import box_mesh, rectangle_mesh
    from pde_solver_tpu_torch.models import elasticity as elast
    from pde_solver_tpu_torch.ops import assembly, eigen, linsolve
    from pde_solver_tpu_torch.ops import multigrid as mg

    solves = count_calls(eigen, "solve_stencil_system")
    builds = count_calls(mg, "build_hierarchy")
    for tool, kw, mesh, mode, vdim, wanted in (
            ("solve_elasticity_3D_modal", box,
             box_mesh(box["nx"], box["ny"], box["nz"], (0.0, 0.0, 0.0),
                      (1.0, 0.2, 0.2)), "3d", 3, ("v3_f32", "v3_bf16")),
            ("solve_elasticity_2D_modal", plate,
             rectangle_mesh(plate["nx"], plate["ny"], (0.0, 0.0), (1.0, 0.2)),
             "plane_stress", 2, ("v2_f32",))):
        solves[0] = builds[0] = 0
        linsolve._MG_CACHE.clear()
        res, st, launches = drive(tool, lambda: getattr(api, tool)(
            **kw, data_dir=data_dir))
        freqs = np.asarray(res.meta["frequencies_hz"])
        shapes, _ = field(res)
        t0 = time.perf_counter()
        lam, mu = elast.lame_parameters(210e9, 0.3, mode)
        K = block_stencil_csr(assembly.assemble_elasticity_stencil(
            mesh, lam, mu), mesh.node_shape, vdim)
        M = block_stencil_csr(elast.assemble_vector_mass(mesh, 7800.0),
                              mesh.node_shape, vdim)
        free = np.ones(mesh.node_shape + (vdim,), bool)
        free[0] = False                                  # clamped at x = 0
        idx = np.flatnonzero(free.reshape(-1))
        w = spla.eigsh(K[idx][:, idx].tocsc(), k=kw["num_modes"],
                       M=M[idx][:, idx].tocsc(), sigma=0.0, which="LM",
                       return_eigenvectors=False)
        want = np.sqrt(np.sort(w)) / (2.0 * np.pi)
        gap = float(np.abs(freqs - want).max() / want.max())
        n_dof = vdim * mesh.num_nodes
        print(f"{tool}: dof={n_dof} frequencies_hz="
              f"{[round(float(f), 6) for f in freqs]} vs eigsh (host f64, "
              f"{time.perf_counter() - t0:.3f} s) max rel. gap {gap:.3e} "
              f"(bound {MODAL_TOL}); subspace iterations={st['iterations']} "
              f"solves={solves[0]} hierarchy builds={builds[0]} cache hits="
              f"{solves[0] - builds[0] if builds[0] else 0} inner "
              f"iterations={st['cg_iterations']} max eigen-residual="
              f"{st['max_residual']:.3e} launches={launches}", flush=True)
        check(bool(st["converged"]) and gap <= MODAL_TOL,
              f"{tool} off eigsh by {gap:.3e}: {st}")
        check(shapes.shape == (kw["num_modes"], mesh.num_nodes)
              and bool(np.all(np.isfinite(shapes)))
              and np.allclose(shapes.max(axis=1), 1.0),
              f"{tool}: mode shapes {shapes.shape}")
        check(builds[0] == (1 if vdim == 3 else 0) and solves[0] >= 2
              * (kw["num_modes"] + 2), f"{tool}: {builds[0]} hierarchy "
              f"builds in {solves[0]} solves")
        for name in wanted:
            check(launches.get(name, 0) > 0, f"{tool} launched no {name}")
    linsolve._MG_CACHE.clear()


class MainPaths:
    """The main-path runs' bookkeeping: the launch counts set to 0 just
    before a run and read just after, in all (``main_launches``) and by run
    (``path_launches``); every dense operator a run launched held against
    plain and timed once per shape (``by_operator``, ``level_ms``); every
    constant-interior operator a run built handed back to the caller."""

    def __init__(self, sk, ck, kernels, built):
        self.sk, self.ck, self.kernels, self.built = sk, ck, kernels, built
        self.launched = spy_flat_launches(sk)
        self.main_launches = {}
        self.path_launches = {}
        self.by_operator = {}
        self.level_ms = {}
        self.cs_level_ms = {}

    def counted(self, label, cs, fn):
        """fn() with ``PDE_TPU_CS`` = cs: (result, launches, wall s)."""
        import torch

        os.environ["PDE_TPU_CS"] = cs
        del self.built[:]
        self.launched.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.sk.reset_launch_counts()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(self.sk.KERNEL_LAUNCHES)
        os.environ["PDE_TPU_CS"] = "0"
        for k, v in launches.items():
            self.main_launches[k] = self.main_launches.get(k, 0) + v
        self.path_launches[label] = launches
        return res, launches, wall

    def run(self, label, cs, fn):
        """One main-path run of an API tool: (result, solver stats,
        launches, the CS builds it made)."""
        import torch

        res, launches, wall = self.counted(label, cs, fn)
        st = res.meta["solver_stats"]
        print(f"phase {label}: {wall:.3f} s wall; "
              + " ".join(f"{k}={v:.3f}" for k, v in st.items()
                         if k.endswith("_seconds")), flush=True)
        relres = st.get("relative_residual", st.get("max_residual"))
        print(f"{label}: dof={st.get('num_dofs')} iterations="
              f"{st['cg_iterations']} relres={relres:.3e} "
              f"converged={st['converged']} peak_device_mem="
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"cs_builds={[(s, op is not None) for s, op, *_ in self.built]} "
              f"launches={launches}", flush=True)
        check_launched(self.sk, self.launched, label, self.kernels,
                       self.by_operator, self.level_ms)
        cs_built = list(self.built)
        del self.built[:]
        return res, st, launches, cs_built

    def drive(self, label, fn):
        res, st, launches, _ = self.run(label, "0", fn)
        return res, st, launches

    def hold_cs(self, cs_built, label):
        check_built(self.ck, self.sk, cs_built, label, self.cs_level_ms)


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
    from pde_solver_tpu_torch.ops import floor_probes as fp
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
    cuda_build.build("flat_stencil_spmv", "cs_stencil", "floor_probes")
    sk.build_library()
    ck.build_library()
    fp.build_library()
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

    # -- the fused constant-interior kernel against plain and dense ----------
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
    # 2,009 nodes lie under the CS route's size gate: lowered for this check
    cs_min_dof, ck.CS_MIN_DOF = ck.CS_MIN_DOF, 0
    with config_overrides(device="cuda", precision="mixed",
                          transient_mg_threshold=100, mg_threshold=100,
                          transient_inner_tol=1e-8):
        r_heat = api.solve_heat_3D(**SMALL_HEAT, data_dir=data_dir)
    ck.CS_MIN_DOF = cs_min_dof
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
          f"{[(s, op is not None) for s, op, *_ in built]}, "
          f"launches={small_launches}", flush=True)
    check(st["converged"], f"small heat did not converge: {st}")
    check(gap <= 1e-6, f"small heat off the host solve by {gap:.3e}")
    check((41, 7, 7) in {s for s, op, *_ in built if op is not None},
          "small heat: no CS operator at the fine level")
    check(small_launches.get("cs_apply_v1", 0) > 0,
          "small heat launched no CS kernel")

    # -- main paths through the API ------------------------------------------
    paths = MainPaths(sk, ck, kernels, built)
    main_path, drive, hold_cs = paths.run, paths.drive, paths.hold_cs
    by_operator, level_ms = paths.by_operator, paths.level_ms
    cs_level_ms = paths.cs_level_ms

    vm_runs = {}
    for cs in ("0", "1", "hybrid"):
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
        wanted = {"0": ("v3_f32", "v3_bf16", "v1_f32"),
                  "1": ("cs_apply_v3",),
                  "hybrid": ("cs_apply_v3", "v3_bf16")}[cs]
        for name in wanted:
            check(launches.get(name, 0) > 0,
                  f"the flagship (PDE_TPU_CS={cs}) launched no {name} kernel")
        if cs != "0":
            # the CS route's size gate: the two levels of ≥ 65,536 DOF
            cs_levels = sorted(s for s, op, *_ in cs_built if op is not None
                               and op.vdim == 3)
            check(cs_levels == [(81, 33, 33), (161, 65, 65)],
                  f"flagship (PDE_TPU_CS={cs}): CS levels {cs_levels}")
            check_built(ck, sk, cs_built, f"flagship PDE_TPU_CS={cs}",
                        cs_level_ms)
        del cs_built
    for cs in ("1", "hybrid"):
        gap = float(np.abs(vm_runs[cs] - vm_runs["0"]).max()
                    / np.abs(vm_runs["0"]).max())
        print(f"flagship PDE_TPU_CS={cs} vs dense: max|Δvm|/max|vm|="
              f"{gap:.3e}", flush=True)
        check(gap <= 1e-5, f"flagship PDE_TPU_CS={cs} and dense routes "
              f"differ by {gap:.3e}")
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
              f"{[s for s, op, *_ in cs_built if op is not None]}", flush=True)
        check(st["num_dofs"] == HEAT_DOF, f"heat dof count {st['num_dofs']}")
        check(bool(st["converged"]) and st["relative_residual"] <= target,
              f"heat (PDE_TPU_CS={cs}) did not converge: {st}")
        check(T.shape == (HEAT_STEPS + 1, HEAT_DOF), f"heat field {T.shape}")
        check(bool(np.all(np.isfinite(T))), "non-finite temperatures")
        check(times.shape == (HEAT_STEPS + 1,), f"heat times {times.shape}")
        wanted = (("cs_apply_v1",) if cs == "1"
                  else ("v1_f32", "v1_bf16"))
        for name in wanted:
            check(launches.get(name, 0) > 0,
                  f"the heat slice (PDE_TPU_CS={cs}) launched no {name}")
        if cs == "1":
            cs_levels = sorted(s for s, op, *_ in cs_built if op is not None)
            check(cs_levels == [(65, 65, 65), (129, 129, 129)],
                  f"heat: CS levels {cs_levels}, expected the two of "
                  f"≥ 65,536 DOF")
            check_built(ck, sk, cs_built, f"heat PDE_TPU_CS={cs}",
                        cs_level_ms)
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
    with config_overrides(device="cuda"):
        for name, phase in (("baselines", baseline_phase),
                            ("loaded", loaded_phase),
                            ("curvilinear", curvilinear_phase)):
            t0 = time.perf_counter()
            phase(api, drive, data_dir)
            print(f"phase {name}: {time.perf_counter() - t0:.3f} s",
                  flush=True)

        # -- the _mixed, nonlinear and advection tools -----------------------
        for name, phase in (("mixed", mixed_phase),
                            ("advection", advection_phase)):
            t0 = time.perf_counter()
            phase(api, main_path, hold_cs, data_dir)
            print(f"phase {name}: {time.perf_counter() - t0:.3f} s",
                  flush=True)
        t0 = time.perf_counter()
        analytic_phase(api, drive, data_dir)
        print(f"phase analytic: {time.perf_counter() - t0:.3f} s", flush=True)

        # -- the floor probes: against plain, timed, then their main path ----
        t0 = time.perf_counter()
        for name, res in floor_phase(fp, sk, ck).items():
            kernels[f"floor_{name}"] = res
        floor, launches, wall = paths.counted(
            "floor", "0", lambda: fp.kernel_floor(FLAGSHIP_CELLS,
                                                  reps=FLOOR_REPS))
        print(f"phase floor: {time.perf_counter() - t0:.3f} s; the entry "
              f"point kernel_floor{FLAGSHIP_CELLS} {wall:.3f} s wall, "
              f"{floor['clock']} ms a call: "
              + " ".join(f"{k}={v:.4f}" for k, v in floor["ms"].items())
              + f"; launches={launches}", flush=True)
        for name in PROBE_REPLACES:
            check(launches.get(f"floor_{name}", 0) >= FLOOR_REPS,
                  f"the floor path launched floor_{name} "
                  f"{launches.get(f'floor_{name}', 0)} times")
        check(floor["clock"] == "cuda events" and all(
            np.isfinite(v) and v > 0 for v in floor["ms"].values()),
            f"floor: {floor}")

        # -- the Newmark and modal tools ---------------------------------------
        t0 = time.perf_counter()
        newmark_phase(api, main_path, hold_cs, data_dir)
        print(f"phase newmark: {time.perf_counter() - t0:.3f} s", flush=True)
        t0 = time.perf_counter()
        modal_phase(api, drive, data_dir)
        print(f"phase modal: {time.perf_counter() - t0:.3f} s", flush=True)

    noffs = {key[3] for key in by_operator}
    print(f"dense operators launched on the main paths: offset counts "
          f"{sorted(noffs)} (built: {sk.KERNEL_NOFFS})", flush=True)
    fine = {(161, 65, 65), (129, 129, 129), (1025, 1025)}
    print("launches at the main paths' fine levels: " + "; ".join(
        f"{run} {variant} {shape}: {n}"
        for (run, variant, shape, _), n in by_operator.items()
        if shape in fine), flush=True)
    check(noffs <= set(sk.KERNEL_NOFFS), f"launched offset counts "
          f"{sorted(noffs)}")
    for variant in sorted({key[0] for key in level_ms}):
        levels = sorted(((shape, n_off, t) for (v, shape, n_off), t
                         in level_ms.items() if v == variant),
                        key=lambda s: -int(np.prod(s[0])))
        print(f"{variant} device ms (share of bound; L2: W fits the L2, "
              "not a share of HBM) at every launched shape: " + "; ".join(
                  f"{shape} n_off={n_off} {ms:.4f} ({bnd / ms:.3f}"
                  f"{' L2' if l2 else ''})"
                  for shape, n_off, (ms, bnd, l2) in levels), flush=True)
    for run in ("flagship", "heat", "mixed 3D", f"mixed 3D tol="
                f"{MIXED_TIGHT_TOL:.0e}", "advection 3D", "wave 3D"):
        parts = []
        for cs in ("0", "1") + (("hybrid",) if run == "flagship" else ()):
            label = f"{run} PDE_TPU_CS={cs}"
            dense = [(n, level_ms[(v, sh, no)][0])
                     for (lb, v, sh, no), n in by_operator.items()
                     if lb == label]
            cs_ops = [(t["launches"], t["ms"])
                      for (lb, _, _), t in cs_level_ms.items() if lb == label]
            parts.append(
                f"PDE_TPU_CS={cs} {sum(n * ms for n, ms in dense + cs_ops):.2f}"
                f" ms (dense {sum(n for n, _ in dense)} launches "
                f"{sum(n * ms for n, ms in dense):.2f} ms, CS "
                f"{sum(n for n, _ in cs_ops)} launches "
                f"{sum(n * ms for n, ms in cs_ops):.2f} ms)")
        print(f"{run}: SpMV device time of the run, estimated as Σ launches "
              f"× per-level device ms: " + "; ".join(parts), flush=True)
    print(f"total: {time.perf_counter() - t_start:.3f} s", flush=True)
    print(card_line)
    entries = [(f"flat_stencil_spmv[{name}]", name, FLAT_SOURCE,
                REPLACES["flat"])
               for name in ("v3_f32", "v3_bf16", "v2_f32", "v2_bf16",
                            "v1_f32", "v1_bf16")]
    entries += [(f"cs_apply[v{v}]", f"cs_apply_v{v}", CS_SOURCE,
                 REPLACES["cs_apply"]) for v in (1, 3)]
    entries += [(f"floor_probes[{name}]", f"floor_{name}", FLOOR_SOURCE, repl)
                for name, repl in PROBE_REPLACES.items()]
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "share", "library_ms", "library_note", "shape",
            "l2_resident", "cold_device_ms", "cold_share", "bf16")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": repl,
         "launches": paths.main_launches.get(key, 0),
         "launches_by_path": {label: n[key] for label, n in
                              paths.path_launches.items() if n.get(key)},
         **{k: kernels[key].get(k) for k in keys}}
        for name, key, source, repl in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
