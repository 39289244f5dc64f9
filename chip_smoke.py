#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pde_solver_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Asserts a CUDA card and prints its name and power limit (nvidia-smi).
   Starts cold, as a user's first call does: the run's own disk-cache
   directory (``build/chip_smoke_cache``, ``PDE_TPU_CACHE_DIR``) is
   emptied, its free bytes printed, and ``PDE_TPU_CACHE_MAX_GB`` set high
   enough that no entry of the run is evicted.  The operators the kernel
   checks of 3–4 build for themselves bypass the disk cache.
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
   to 0 just before and read just after (a launch recorded into a CUDA
   graph counts at each replay; every main-path line also prints the solve
   loops' host reads):
   - the flagship, 3D static elasticity of a 1 m × 0.2 m × 0.2 m
     cantilever under gravity on 160×64×64 cells (2,040,675 DOF), with
     ``PDE_TPU_CS`` 0 (dense kernels), 1 (constant-interior kernels) and
     "hybrid" (constant-interior residuals, dense bf16 smoothing);
   - the heat slice, ``solve_heat_3D(nx=ny=nz=128)`` (20 backward-Euler
     steps on 2,146,689 DOF), with ``PDE_TPU_CS`` 0 and 1.
   Checks convergence, finite fields of the expected shape, that the
   routes agree, that each run launched its kernels, and that the CS
   routes built their operator on the two levels of at least 65,536 DOF
   and no other.  The dense flagship is the cold call: it must store the
   ``prep`` and ``mgh`` disk-cache entries of its system (printed: the
   set-up seconds, prepare_system, hierarchy and ladder, and each
   entry's store seconds and bytes); its von Mises must have run on the
   card in float32 and lie within 1e-5·max of the host float64 path on the
   same u (both times printed).  Every dense
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
   - ``solve_heat_3D_mixed(nx=ny=nz=96)`` (cut from 128³): 20 steps with a
     sinusoidally driven Dirichlet face, a Robin face and a flux face,
     MG-PCG per step (counted), ``PDE_TPU_CS`` 0 and 1 (a refusal of the CS
     build is printed and the run then must have stayed on the dense
     kernel); both trajectories against a float64 θ-scheme written from
     the weak form (face mass, surface load, g(t) at the new time level),
     solved on the card; ``solve_heat_2D_mixed`` at 256² against the same
     stepping on the host;
   - ``solve_advection_3D(nx=ny=nz=96)`` (cut from 128³): 20 CNAB2 steps, flat
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
   residentw also with bf16 weights, residentw with tiles of 64, 4,096
   and N_pad nodes) on the flagship's scaled fine-level elasticity
   operator (161×65×65, vdim 3) and the heat slice's (129³, vdim 1), on
   two ragged tails (N mod 4 = 3, 1), and with one planted fault each that
   must read > 1e-4; csz with zero face sets must equal shifts bit for
   bit.  Prints the ptxas lines of shifts, residentw and csz.  Times each
   probe as in 3 (events, profiler device ms, bound, share; where its
   bytes fit the L2 also with 128 MB written between launches); prints for
   wonly the GB/s it reaches beside K1's device time at the same shape,
   for shifts and csz the fused CS kernel's device time beside them.  The
   library yardstick of wonly is ``W.sum(0)``, that of shifts one
   ``conv1d`` (``shifts_library``, held against plain first); residentw
   and csz have no single PyTorch call.  Then their
   main path, counts 0 before and read after: the entry point
   ``floor_probes.kernel_floor`` on the flagship's operator.
10. The Newmark and modal tools, each run a main path of its own:
   - ``solve_wave_3D(nx=ny=nz=96, dt=0.01, num_steps=20)`` (912,673 DOF,
     the default sine mode; cut from 128³): MG-PCG per step (counted),
     ``PDE_TPU_CS`` 0 and 1 (CS levels exactly 97³ and 49³), against the
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
11. The precision scheme (``precision_phase``), each run a main path of
   its own (counts 0 before, read after):
   - the flagship under ``precision="f64"``: MG-PCG (``solve_mg``) on a
     float64 hierarchy, plain torch applies, no kernel launch at all;
     prints the hierarchy and ``solve_mg`` seconds, the time an iteration,
     the peak device memory, and the aten operations (each one kernel
     launch or more) of one V-cycle and of its 60-iteration coarse CG;
     holds the reported relres (the true residual, where the JAX package
     reports CG's recurrence) against a host float64 recomputation from
     the same x̂ within 1e-6 relative, ``converged`` exactly relres ≤
     target, and, when converged, von Mises evaluated on the host in
     float64 from its displacements within 1e-6·max of the same from the
     "mixed" dense flagship's of 6 (the fields themselves carry float32
     von Mises at either precision: ≥ 1M unknowns on the card); the cold
     build bypasses the disk cache;
   - the flagship under ``precision="f32"``: flat CG on K1 v3 f32 at
     max(inner_tol, 1e-7), ``converged`` reported as it comes;
   - ``solve_heat_3D`` at 128³ (20 steps) under "f64": MG-PCG on a float64
     hierarchy to ``tol`` each step, within 3e-4·max|T| of the float32 run
     of 6, no kernel launch; and the 40×6×6 transient of 5 within
     1e-8·max|T| of its host float64 backward Euler;
   - ``solve_elasticity_3D_dynamic`` on the flagship's mesh under "f64":
     the energy share beside the float32 one of 10 (finite, and below it);
   - checkpointed scans at the card's default precision: a 40×6×6 heat
     transient and the 40×16×16 cantilever, checkpointed every 2 steps,
     aborted after one chunk (``_CKPT_TEST_ABORT``) and resumed, bit for
     bit the uncheckpointed run;
   - the 16×8×8 cantilever of 5 with the bf16 copy's size gate lowered to
     0 DOF and at its value (every level under it): at its value no bf16
     launch, more f32 ones, the same field within 1e-6.
12. The solve loops as CUDA graphs (``graphs_phase``, ``ops.device_loop``),
   each captured path against the same path run uncaptured
   (``device_loop._uncaptured``, which no entry point of the package
   enters), at full width: the flagship's double-float32 rounds ("mixed":
   the flagship through the API, its hierarchy and ladder then solved
   directly uncaptured, captured anew and replayed), its "f64"
   ``solve_mg`` on the hierarchy the precision phase built (the same
   three ways), the modal 3D tool (the captured run is 10's) and the
   flagship's projection (flat CG on K1 v1, the same three ways).  Each:
   the same iterations, fields within 1e-6 relative (the gap printed), at
   most one host read a block (one a df2 round, plus ‖b‖), launches with
   the replays counted, seconds both ways, peak device memory above the
   run's start with graphs and without, what the graph pools hold.  Then
   the scans (``scans_leg``: each step one captured step program, one
   read a chunk of ``SCAN_CHUNK`` steps after the first step, which is
   solved on its own and sets the budget): the heat slice at 128³ with
   ``PDE_TPU_CS`` 0 (K1) and 1 (CS), ``solve_heat_3D_mixed`` and
   ``solve_advection_3D`` (CNAB2) at 96³, ``solve_wave_3D`` at 96³ (driven
   by a source from rest: no host projection), ``solve_elasticity_3D_
   dynamic`` at 60×24×24 for 24 steps (MG-PCG steps, a bf16 smoother on
   its finest level) and the heat slice at "f64" at 32³ (MG-PCG steps,
   the thresholds lowered): each the tool through the API (the step
   programs),
   then its scan's call again through the per-step path (``device_loop.
   _per_step``) and the step programs uncaptured: the same iterations, a
   field gap of 0 both ways, the reads one a chunk plus reruns, and per
   way the reruns, the masked iterations past convergence, the capture
   and scan seconds, the device-busy share of the scan under
   torch.profiler (the step programs, and the per-step path for the K1
   heat) and the launches; the K1 heat program's run also
   against 6's.  Last, a device synchronise planted in a captured CG body,
   and one in a step's body, must each make the solve raise (no fallback
   to the uncaptured loop or the per-step path).
13. The sharding layer (``shard_phase``), over 8 virtual copies of the card
   (``PDE_TPU_VIRTUAL_DEVICES=8``, set for this phase only; printed: the
   physical card count, the card's name and power limit, and on every line
   "virtual shards on one card: not multi-GPU speed"):
   - the eight legs of ``MULTICHIP_r05.json`` (the JAX package's dry run,
     ``__graft_entry__.dryrun_multichip``) at their sizes under "f64": the
     heat step (400 nodes), elasticity CG (1,350 DOF), sharded MG-PCG
     (1,275), the transient scan (1,078 × 5), Newmark (672 × 4), the scalar
     wave (648 × 4), CNAB2 advection with sinusoidal driving (720 × 5) and
     the 4×2 mesh (1,200), each within 1e-9 relative of the same solve
     unsharded, its iterations printed beside the record's;
   - the flagship on 4 shards (161 planes padded to 164) through the API,
     a main path each: under "f64" within 1e-9·max|u| of the unsharded
     "f64" flagship of 11 (iterations printed beside its, at most one
     more), and at the card's default ("mixed": host float64 refinement
     around sharded float32 MG inner solves, with ``refine_rounds=12``:
     the reference's default 7 stop at relres ~6e-5 on the flagship, each
     round's relres printed) converged, its von Mises
     within 1e-6·max of the dense flagship of 6; each run's reported relres
     against a host float64 recomputation from the solver's x̂, no K1 or CS
     launch, and printed: wall, set-up and solve seconds, iterations and ms
     an iteration, peak device memory, halo bytes an apply, the aten
     operations of one sharded V-cycle.  The NCCL leg of
     ``parallel.distributed`` needs two cards: printed as not run.
14. The service layer (``service_phase``), the entry points a user reaches:
   - the port's MCP server, ``python -m pde_solver_tpu_torch.mcp.server``,
     started with no ``PDE_TPU_DEVICE`` (the card), ``PDE_TPU_CS=0`` and
     INFO logging to ``build/service/server.log``, spoken to in raw
     JSON-RPC lines (``JsonRpcPipe``: every stdout line must be the reply
     to the request just sent, and nothing may follow the last):
     initialize, tools/list (the 31 names of the port's ``LocalToolSet``),
     the flagship (2,040,675 DOF), which must converge in the iterations of
     the in-process dense run of 6 and lie within 1e-6·max of its field,
     answered from the disk cache 6 stored: its INFO lines must show a
     ``prep`` and a hierarchy disk hit and no store (printed: the gap, the
     served and in-process wall seconds, the served set-up seconds beside
     the cold ones of 6, the server's INFO lines and the kernel launches
     of its tool call, added to the main paths' launches), then the plot
     of the served field (its
     seconds and bytes; the HTML holds ``Plotly.newPlot`` and the figure
     JSON), then an unknown tool (``isError``);
   - the nine chat examples of ``pde_solver_tpu_torch/app.py`` in process,
     each through ``MultiAgentOrchestrator(llm=None, memory_file=None)``
     on the port's ``LocalToolSet``, each a main path of its own: each
     must return a data file and a plot with no error (printed: the tool
     it routed to, DOF, seconds, iterations, launches).

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
``build/``; the server process it starts ends before it does.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import shutil
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
# the _mixed slice: solve_heat_3D_mixed on 96³ cells (cut from 128³ to make
# room for the shard phase), all three face kinds and the driving at once
# (every face not named insulated)
MIXED_3D = dict(nx=96, ny=96, nz=96, num_steps=20, dt=0.01,
                boundary_conditions={
                    "left": {"type": "dirichlet", "value": 100.0,
                             "amplitude": 20.0, "period": 0.1},
                    "right": {"type": "robin", "h": 5.0, "T_ambient": 20.0},
                    "top": {"type": "neumann", "flux": 50.0}})
# the advection slice: solve_advection_3D on 96³ cells (cut from 128³ to make
# room for the shard phase), CNAB2 (CFL 0.48, cell Péclet 0.52), and one
# "ab1" run at 64³
ADVECTION_3D = dict(nx=96, ny=96, nz=96, dt=0.005, num_steps=20)
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
                    "with tiled weights or masked face sets")
FLOOR_REPS = 20
# the Newmark slice: the wave equation on 96³ cells (the default sine
# mode, Π sin(πxᵢ) cos(√3πt); cut from 128³, whose host projection of the
# sine field took 41–50 s a run, to make room for the precision phase),
# and the flagship's cantilever
# released under gravity; the latter also at 40×16×16 against the host
WAVE_3D = dict(nx=96, ny=96, nz=96, dt=0.01, num_steps=20)
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
# the service phase: the port's MCP server as a subprocess, the flagship
# served and plotted, then the nine chat examples in process
SERVER_CMD = ("-m", "pde_solver_tpu_torch.mcp.server")
SERVED_TOL = 1e-6        # served against in-process von Mises, ·max|vm|
SERVE_TIMEOUT = 600.0    # seconds for one reply of the server
# the disk cache (``utils.diskcache``): this run's own directory, emptied at
# the start (a user's first call is cold), with a size bound that keeps
# every entry the run writes, so the service phase finds the flagship's
CACHE_DIR = os.path.join("build", "chip_smoke_cache")
CACHE_MAX_GB = 64
FLAGSHIP_DOF = 2_040_675
VM_DEVICE_TOL = 1e-5     # device von Mises against host float64, ·max|vm|
# the solver's INFO lines: set-up seconds, and the disk cache's events
SETUP_LINES = (
    ("prepare_system", r"prepare_system: ([0-9.]+)s \((\d+) DOF\)"),
    ("hierarchy", r"hierarchy build: ([0-9.]+)s \((\d+) DOF\)"),
    ("ladder", r"df ladder build: ([0-9.]+)s, df2 rounds: [0-9.]+s "
               r"\((\d+) DOF\)"))
DISK_LINE = (r"(prep|hierarchy) disk-cache (hit|store) \(([0-9.]+)s"
             r"[a-z ]*, (\d+) bytes, (\d+) DOF\)")


def peak_gib() -> float:
    """Peak device memory since the last reset, GiB (NaN without a card)."""
    import torch

    return (torch.cuda.max_memory_allocated() / 2 ** 30
            if torch.cuda.is_available() else float("nan"))


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


@contextlib.contextmanager
def disk_cache_off():
    """``PDE_TPU_DISK_CACHE=0`` within: operators a check builds for
    itself, and runs that time a cold build, neither load nor store a
    disk-cache entry."""
    prev = os.environ.get("PDE_TPU_DISK_CACHE")
    os.environ["PDE_TPU_DISK_CACHE"] = "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("PDE_TPU_DISK_CACHE", None)
        else:
            os.environ["PDE_TPU_DISK_CACHE"] = prev


def clear_scans():
    """Empty the scan caches (θ and Newmark), releasing their graphs: the
    next scan is cold."""
    from pde_solver_tpu_torch.ops import timestepping

    for cache in timestepping._SCAN_CACHE.values():
        cache.clear()


@contextlib.contextmanager
def solver_log():
    """The port logger's messages (INFO and up) while within."""
    import logging

    from pde_solver_tpu_torch.utils.observability import get_logger

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger, keep = get_logger(), Keep()
    logger.addHandler(keep)
    try:
        yield lines
    finally:
        logger.removeHandler(keep)


def setup_seconds(lines, dof: int) -> dict:
    """A solve's set-up seconds from its INFO lines: prepare_system, the
    hierarchy (built or rebuilt from disk) and the df ladder, of the
    system of ``dof`` unknowns, and their sum."""
    out = {}
    for name, pattern in SETUP_LINES:
        for line in lines:
            m = re.search(pattern, line)
            if m and int(m.group(2)) == dof:
                out[name] = float(m.group(1))
                break
    out["total"] = sum(out.values())
    return out


def disk_events(lines, dof: int) -> dict:
    """{(kind, "hit" or "store"): (seconds, bytes)} of the disk-cache lines
    of the system of ``dof`` unknowns."""
    out = {}
    for line in lines:
        m = re.search(DISK_LINE, line)
        if m and int(m.group(5)) == dof:
            out[m.group(1), m.group(2)] = (float(m.group(3)),
                                           int(m.group(4)))
    return out


def cache_listing(path) -> dict:
    """{kind: (entries, bytes)} of a disk-cache directory."""
    out = {}
    for name in sorted(os.listdir(path)) if os.path.isdir(path) else ():
        if name.endswith(".npz") and "-" in name:
            kind = name.split("-", 1)[0]
            n, b = out.get(kind, (0, 0))
            out[kind] = (n + 1, b + os.path.getsize(os.path.join(path, name)))
    return out


def spy_von_mises():
    """Record every call of ``elasticity.von_mises_fields``: its mesh, u,
    λ, μ, prestress, device, output and seconds; returns the list and the
    function that removes the spy."""
    import numpy as np

    from pde_solver_tpu_torch.models import elasticity as elast

    calls = []
    orig = elast.von_mises_fields

    def spy(mesh, u_grid, lam, mu, iso=None, device=None):
        t = time.perf_counter()
        out = orig(mesh, u_grid, lam, mu, iso=iso, device=device)
        calls.append(dict(mesh=mesh, u=np.asarray(u_grid), lam=lam, mu=mu,
                          iso=iso, device=device, out=out,
                          seconds=time.perf_counter() - t))
        return out

    elast.von_mises_fields = spy
    return calls, lambda: setattr(elast, "von_mises_fields", orig)


def host_von_mises(rec):
    """The host float64 von Mises (stress, strain) of a recorded call's u."""
    import numpy as np

    from pde_solver_tpu_torch.models import elasticity as elast

    G = elast._element_gradients(rec["mesh"], rec["u"])
    return elast._vm_from_gradients(G, np, rec["mesh"].dim, rec["lam"],
                                    rec["mu"], iso=rec["iso"])


def device_von_mises_phase(rec, card_line, device="cuda"):
    """The flagship's von Mises as the run computed it (on the card, float32)
    against the host float64 path on the same u, within VM_DEVICE_TOL of
    max|vm|; a second device evaluation must equal the run's bit for bit.
    Returns the numbers PERF.md keeps.  A CPU rehearsal passes a call
    recorded on the CPU's float32 device path and ``device="cpu"``."""
    import numpy as np
    import torch

    from pde_solver_tpu_torch.models import elasticity as elast

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    run_out = rec["out"]
    check(all(a.dtype == np.float32 for a in run_out),
          f"the flagship's von Mises did not run on the card: "
          f"{[a.dtype for a in run_out]}")
    sync()
    t = time.perf_counter()
    again = elast._von_mises_device(rec["mesh"], rec["u"], rec["lam"],
                                    rec["mu"], iso=rec["iso"], device=device)
    sync()
    device_s = time.perf_counter() - t
    t = time.perf_counter()
    host = host_von_mises(rec)
    host_s = time.perf_counter() - t
    gaps = [float(np.abs(d - h).max() / np.abs(h).max())
            for d, h in zip(run_out, host)]
    same = all(np.array_equal(a, b) for a, b in zip(again, run_out))
    print(f"device von Mises ({card_line}): the flagship's u "
          f"{rec['u'].shape}, on the card (float32) {rec['seconds']:.3f} s in "
          f"the run, {device_s:.3f} s again (bit-equal: {same}); host "
          f"float64 {host_s:.3f} s; max|Δ|/max|vm| stress {gaps[0]:.3e}, "
          f"strain {gaps[1]:.3e} (bound {VM_DEVICE_TOL})", flush=True)
    check(same, "the device von Mises is not reproducible")
    check(max(gaps) <= VM_DEVICE_TOL, f"device von Mises off the host "
          f"float64 one by {max(gaps):.3e}")
    return dict(run_s=rec["seconds"], device_s=device_s, host_s=host_s,
                gap_stress=gaps[0], gap_strain=gaps[1])


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
    with disk_cache_off():
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
    with disk_cache_off():
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
    with disk_cache_off():
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
    (id -> (operator, launches before)) it fills.  The spy sits on
    ``count_launch``, which a launch, its recording into a CUDA graph and
    each replay of that graph call, so an operator that only replays in
    a run is recorded too."""
    launched = {}
    orig = sk.count_launch

    def spy(variant, op=None, n=1):
        if isinstance(op, sk.FlatStencilOperator):
            launched.setdefault(id(op), (op, op.launches))
        return orig(variant, op, n)

    sk.count_launch = spy
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
    with disk_cache_off():
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
    with disk_cache_off():
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


def count_mg_steps():
    """Count the scan steps whose step solve is MG-PCG (the step program's
    masked loop, or a rerun's ``mg_pcg``: ``device_loop.run_scan`` with
    ``multigrid._pcg_program``'s loop); returns the one-element list it
    counts in."""
    from pde_solver_tpu_torch.ops import device_loop

    n = [0]
    orig = device_loop.run_scan

    def counted(store, key, step, program, per_step, carry, tol, maxiter,
                step0, num_steps, *a, **kw):
        if program[0].__module__.endswith(".multigrid"):
            n[0] += num_steps
        return orig(store, key, step, program, per_step, carry, tol,
                    maxiter, step0, num_steps, *a, **kw)

    device_loop.run_scan = counted
    return n


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

    steps, dt = full["num_steps"], full["dt"]
    n = (full["nx"] + 1) * (full["ny"] + 1) * (full["nz"] + 1)
    mg_calls = count_mg_steps()
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


def shifts_library(x, deltas, vdim: int, wc):
    """The function of the shifts probe as one PyTorch call: a conv1d of x
    [v, N] with the kernel K[a, b, P + δ_o] = wc[(o·v + a)·v + b] and zero
    padding P = max|δ| (mostly zero taps).  TF32 is off, as the package
    sets it."""
    import numpy as np
    import torch

    P = max(abs(int(d)) for d in deltas)
    K = torch.zeros((vdim, vdim, 2 * P + 1), dtype=torch.float32)
    w = torch.as_tensor(np.asarray(wc, np.float32))
    for o, d in enumerate(deltas):
        K[:, :, P + int(d)] = w[o * vdim * vdim:(o + 1) * vdim * vdim] \
            .reshape(vdim, vdim)
    K = K.to(x.device)
    return lambda: torch.nn.functional.conv1d(x[None], K, padding=P)[0]


def time_probe(label, name, kernel, plain, cost, reps_p=3, library=None,
               reps_l=20, beside=""):
    """Times one probe: events in turns (plain, library, kernel, kernel,
    library, plain), profiler device ms, and where its bytes fit the L2 the
    device ms with 128 MB written between launches.  Prints one line and
    returns the fields of the result line."""
    import torch

    nbytes, flops = cost
    bound_ms, bound_by = bound(nbytes, flops)
    ms, plain_ms, library_ms = turns(kernel, plain, 50, reps_p,
                                     library=library, reps_l=reps_l)
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
    import numpy as np
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
        # tiles that wrap many times, the reference's, and all of W
        for B in (64, fp.TILE_NODES, op.N_pad):
            tile = fp.weight_tile(o.W, B)
            y_plain = hold(f"residentw {wt} B={B}",
                           fp.residentw(tile, x, deltas, v),
                           fp.residentw_plain(tile, x, deltas, v))
            if B == fp.TILE_NODES:
                tiles[wt], plains[f"residentw {wt}"] = tile, y_plain
    plains["shifts"] = hold("shifts", fp.shifts(x, deltas, v, wc),
                            fp.shifts_plain(x, deltas, v, wc))
    plains["csz"] = hold("csz", fp.csz(masks, x, deltas, v, wc, dz0, dz1),
                         fp.csz_plain(masks, x, deltas, v, wc, dz0, dz1))
    # without face sets csz is shifts, bit for bit
    no_face = np.zeros_like(wc)
    check(torch.equal(fp.csz(masks, x, deltas, v, wc, no_face, no_face),
                      fp.shifts(x, deltas, v, wc)),
          f"probes at {label}: csz without face sets is not shifts")
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
    print(f"probes {label} N={op.N} (N mod 4 = {op.N % 4}) v{v}: csz "
          f"without face sets = shifts bit for bit; rel err "
          + ", ".join(f"{k} {r:.3e}" for k, r in rels.items())
          + "; planted faults: "
          + ", ".join(f"{k} {r:.3e}" for k, r in faults.items()), flush=True)
    check(min(faults.values()) > FAULT_MIN, f"probes at {label}: a planted "
          f"fault reads {min(faults.values()):.3e}, not above {FAULT_MIN}")
    return op16, tiles, (wc, dz0, dz1), masks


def ptxas_lines(log: str, kernels):
    """ptxas's report lines (registers, shared memory, spills) of the
    kernels whose mangled names hold one of ``kernels``."""
    out, current = [], None
    for line in log.splitlines():
        if "entry function" in line or "Function properties" in line:
            current = next((k for k in kernels if k in line), None)
        if current and any(w in line for w in ("entry function", "registers",
                                               "spill", "smem")):
            out.append(line.strip())
    return out


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
    if device == "cuda":
        from pde_solver_tpu_torch.ops import cuda_build

        for line in ptxas_lines(str(cuda_build.BUILD_INFO["floor_probes"]
                                    .get("log", "")),
                                ("shifts_kernel", "residentw_kernel",
                                 "csz_kernel")):
            print(f"  floor ptxas: {line}", flush=True)
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
            conv = shifts_library(x, d, vdim, wc)
            lib_rel = rel_err(conv(), fp.shifts_plain(x, d, vdim, wc))
            check(lib_rel <= REL_TOL, f"{label}: conv1d vs shifts_plain "
                  f"{lib_rel:.3e}")
            fields["shifts"] = time_probe(
                label, "shifts", lambda: fp.shifts(x, d, vdim, wc),
                lambda: fp.shifts_plain(x, d, vdim, wc),
                probe_bytes_flops("shifts", op), library=conv, reps_l=3,
                beside=beside + f" | conv1d vs plain {lib_rel:.2e}")
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

    spy.__wrapped__ = orig
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
    their default sizes against their standing modes.  Returns the
    full-width cantilever's energy share."""
    import numpy as np

    from pde_solver_tpu_torch.config import config_overrides
    from pde_solver_tpu_torch.mesh import (box_mesh, flatten_values,
                                           interval_mesh, rectangle_mesh)

    calls = spy_newmark()
    mg_calls = count_mg_steps()

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
    beam_share = share
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
    # its 35,547 DOF lie under the bf16 smoother copy's size gate
    # (``multigrid.BF16_MIN_DOF``): every level smooths in float32
    from pde_solver_tpu_torch.ops.multigrid import BF16_MIN_DOF

    bf16 = launches.get("v3_bf16", 0) > 0
    check(launches.get("v3_f32", 0) > 0
          and bf16 == (3 * int(np.prod(shape)) >= BF16_MIN_DOF),
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
    return beam_share


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
    # 24,843 DOF lie under the bf16 smoother copy's size gate
    # (``multigrid.BF16_MIN_DOF``): no v3_bf16 launch
    for tool, kw, mesh, mode, vdim, wanted in (
            ("solve_elasticity_3D_modal", box,
             box_mesh(box["nx"], box["ny"], box["nz"], (0.0, 0.0, 0.0),
                      (1.0, 0.2, 0.2)), "3d", 3, ("v3_f32",)),
            ("solve_elasticity_2D_modal", plate,
             rectangle_mesh(plate["nx"], plate["ny"], (0.0, 0.0), (1.0, 0.2)),
             "plane_stress", 2, ("v2_f32",))):
        solves[0] = builds[0] = 0
        linsolve._MG_CACHE.clear()
        with disk_cache_off():     # one hierarchy build, counted
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


# the precision phase.  The f64 flagship's reported relres (the true
# residual, evaluated on the card) against a host float64 recomputation
# from the same x̂.  Small meshes end their solve at ~2e-11 of ‖b̂‖, where
# the residual is mostly rounding noise and two float64 evaluations of it
# differ in the second or third digit, so a CPU rehearsal passes
# FLOOR_RELRES_TOL; both bounds tell the true residual from CG's
# recurrence, which ends below ``tol`` = 1e-11
PRECISION_RELRES_TOL = 1e-6
FLOOR_RELRES_TOL = 5e-2
SMALL_HEAT_F64_TOL = 1e-8     # the 40×6×6 float64 scan, ·max|T|
# the float64 Newmark energy share against the float32 one: a float64 scan
# closes the balance to rounding (~1e-12), a float32 one to ~1e-4 or worse,
# so a scan that ran float32 somewhere cannot pass
DYNAMIC_F64_SHARE = 1e-6
CKPT_EVERY = 2
# aten operations that only make views: they launch no kernel
VIEW_OPS = frozenset((
    "view", "_unsafe_view", "slice", "select", "expand", "t", "transpose",
    "reshape", "unsqueeze", "squeeze", "permute", "as_strided", "alias",
    "detach", "_reshape_alias", "lift_fresh"))


def spy_stats(linsolve):
    """Record (scaled system, x̂ on the host, reported relres) of every
    device solve of ``solve_stencil_system``'s f64 and f32 branches;
    returns the list and the function that removes the spy."""
    calls = []
    orig = linsolve._stats_result

    def spy(sysm, xh, k, relres, tol_used, cfg):
        calls.append((sysm, xh.detach().cpu().numpy(), relres))
        return orig(sysm, xh, k, relres, tol_used, cfg)

    linsolve._stats_result = spy
    return calls, lambda: setattr(linsolve, "_stats_result", orig)


def timed_calls(module, name, device):
    """Wall seconds of every call of ``module.name`` (the device
    synchronised around it); returns the list and the undo function."""
    import torch

    secs = []
    orig = getattr(module, name)

    def timed(*a, **kw):
        if device == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(*a, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        return out

    setattr(module, name, timed)
    return secs, lambda: setattr(module, name, orig)


def aten_ops(fn) -> int:
    """The aten operations fn dispatches, views left out: each launches one
    kernel or more on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in VIEW_OPS:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def host_relres_of(sysm, xh) -> float:
    """‖b̂ − Â x̂‖/‖b̂‖ on the host in float64, from the solver's own x̂."""
    import numpy as np

    from pde_solver_tpu_torch.ops.linsolve import np_stencil_apply

    vdim = xh.shape[-1] if sysm.scale_kind == "block" else 1
    r = sysm.b_hat - np_stencil_apply(dict(zip(sysm.offsets, sysm.weights)),
                                      xh, sysm.free.ndim - (vdim > 1), vdim)
    return float(np.linalg.norm(r.reshape(-1))
                 / np.linalg.norm(sysm.b_hat.reshape(-1)))


def precision_phase(api, counted, data_dir, vm_mixed, vm_call, T_f32,
                    T_small_ref, share_f32, flagship=FLAGSHIP, heat=HEAT,
                    small_heat=SMALL_HEAT, beam=DYNAMIC_3D,
                    ckpt_beam=DYNAMIC_SMALL, small=SMALL, device="cuda",
                    relres_tol=PRECISION_RELRES_TOL, refs=None):
    """The precision scheme through the API, each run counted by
    ``counted(label, fn) → (result, launches, wall s)``: the flagship at
    float64 and float32, the heat slice and the 40×6×6 transient at
    float64, the released cantilever at float64, checkpointed scans
    aborted and resumed, and the bf16 smoother copy's size gate.
    ``vm_mixed``, ``T_f32``: the "mixed" flagship's von Mises field and
    the float32 heat trajectory of the main paths; ``vm_call``: the
    "mixed" flagship's ``von_mises_fields`` call (``spy_von_mises``),
    whose u the float64 flagship is held against; ``T_small_ref``: the
    host float64 backward Euler of ``small_heat``; ``share_f32``: the
    float32 energy share of ``beam``.  A CPU rehearsal passes small sizes,
    ``device="cpu"`` (launches are then not counted) and
    ``relres_tol=FLOOR_RELRES_TOL``.  Returns the numbers PERF.md keeps;
    ``refs`` (a dict), when given, receives the float64 flagship's u and
    iterations (``u_f64``, ``iters_f64``) for the shard phase."""
    import numpy as np
    import torch

    from pde_solver_tpu_torch.config import config_overrides, get_config
    from pde_solver_tpu_torch.ops import linsolve, timestepping
    from pde_solver_tpu_torch.ops import multigrid as mg

    cuda = device == "cuda"
    out = {}

    def gap(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    def peak_gib():
        return (torch.cuda.max_memory_allocated() / 2 ** 30 if cuda
                else float("nan"))

    # -- 1. the flagship at float64: solve_mg on a float64 hierarchy ----------
    cells = (flagship["nx"], flagship["ny"], flagship["nz"])
    nodes = int(np.prod([c + 1 for c in cells]))
    solves, unspy = spy_stats(linsolve)
    builds, unbuild = timed_calls(mg, "build_hierarchy", device)
    mg_secs, unsolve = timed_calls(mg, "solve_mg", device)
    vm_calls, unspy_vm = spy_von_mises()
    linsolve._MG_CACHE.clear()
    try:
        # a cold build, timed: the disk cache neither loads nor stores
        with config_overrides(precision="f64"), disk_cache_off():
            res, launches, wall = counted("flagship f64", lambda:
                                          api.solve_elasticity_3D_static(
                                              **flagship, data_dir=data_dir))
    finally:
        unspy(), unbuild(), unsolve(), unspy_vm()
    peak = peak_gib()
    st = res.meta["solver_stats"]
    vm = field(res)[0]
    # the elasticity solve (the von Mises projection's mass solve follows)
    (sysm, xh, relres), = [c for c in solves if c[0].scale_kind == "block"]
    del solves
    t0 = time.perf_counter()
    host = host_relres_of(sysm, xh)
    host_s = time.perf_counter() - t0
    (h, _), = [e for key, e in linsolve._MG_CACHE.items() if key[2] == "f64"]
    h0 = h._replace(levels=tuple(lv._replace(Ainv=None) for lv in h.levels))
    n_levels = len(h0.levels)
    r0 = torch.as_tensor(sysm.b_hat, device=h0.levels[0].free.device)
    rc = torch.ones_like(h0.levels[-1].free)
    ops_v = aten_ops(lambda: mg.v_cycle(h0, r0))
    ops_c = aten_ops(lambda: mg.v_cycle(h0, rc, level=n_levels - 1))
    if refs is not None:
        # the graphs phase solves this system again, uncaptured and captured
        refs.update(h_f64=h, b_f64=sysm.b_hat, solve_mg_s=mg_secs[0])
    del h, h0, r0, rc, sysm, xh
    linsolve._MG_CACHE.clear()
    iters = int(st["cg_iterations"])
    per_iter = mg_secs[0] / max(iters, 1)
    vm_gap = gap(vm, vm_mixed)
    # the float64 claim is held where no float32 step intervenes: on the
    # displacements, and on von Mises evaluated from them on the host in
    # float64 (a solve of ≥ 1M unknowns on the card evaluates the field's
    # von Mises in float32, at either precision, as the JAX package does)
    (vm_f64,) = vm_calls
    if refs is not None:
        refs.update(u_f64=vm_f64["u"], iters_f64=iters)
    u_gap = gap(vm_f64["u"], vm_call["u"])
    t0 = time.perf_counter()
    host_gap = gap(host_von_mises(vm_f64)[0], host_von_mises(vm_call)[0])
    host_vm_s = time.perf_counter() - t0
    del vm_calls
    print(f"precision flagship f64: dof={st['num_dofs']} {n_levels} "
          f"levels, hierarchy {builds[0]:.3f} s, "
          f"solve_mg {mg_secs[0]:.3f} s ({iters} iterations, "
          f"{1e3 * per_iter:.3f} ms an iteration, {iters + 1} V-cycles), "
          f"wall {wall:.3f} s; relres={st['relative_residual']:.6e} (true "
          f"residual on the device) host f64 recomputation={host:.6e} "
          f"({host_s:.3f} s) |Δ|/host={abs(relres - host) / host:.3e} "
          f"(bound {relres_tol}); target="
          f"{st['convergence_target']:.1e} converged={st['converged']}; "
          f"peak device memory {peak:.2f} GiB; aten ops a V-cycle {ops_v}, "
          f"of which the 60-iteration coarse CG {ops_c}; kernel launches "
          f"{launches}; max|vm|={np.abs(vm).max():.6e} Pa, vs the mixed "
          f"dense flagship: max|Δu|/max|u|={u_gap:.3e}, host float64 von "
          f"Mises of both u max|Δvm|/max|vm|={host_gap:.3e} ({host_vm_s:.3f}"
          f" s, bound 1e-6), the fields as served (von Mises "
          f"{vm_f64['out'][0].dtype}) {vm_gap:.3e}", flush=True)
    check(st["num_dofs"] == 3 * nodes, f"flagship f64: {st}")
    check(not any(launches.values()), f"flagship f64 launched kernels: "
          f"{launches}")
    check(vm.shape == (1, nodes) and bool(np.all(np.isfinite(vm))),
          f"flagship f64: field {vm.shape}")
    check(relres == st["relative_residual"] and abs(relres - host)
          <= relres_tol * host, f"flagship f64: relres {relres:.6e}"
          f" against the host's {host:.6e}")
    check(bool(st["converged"]) == bool(st["relative_residual"]
                                        <= st["convergence_target"]),
          f"flagship f64: converged={st['converged']} with {st}")
    if st["converged"]:
        check(host_gap <= 1e-6, f"flagship f64 off the mixed flagship by "
              f"{host_gap:.3e} (host float64 von Mises)")
    out["flagship_f64"] = dict(
        iterations=iters, relres=st["relative_residual"], host_relres=host,
        converged=bool(st["converged"]), hierarchy_s=builds[0],
        solve_s=mg_secs[0], ms_per_iteration=1e3 * per_iter, wall_s=wall,
        peak_gib=peak, aten_ops_vcycle=ops_v, aten_ops_coarse=ops_c,
        vm_gap=vm_gap, u_gap=u_gap, host_vm_gap=host_gap)
    del vm
    if cuda:
        torch.cuda.empty_cache()

    # -- 2. the flagship at float32: flat CG on K1 v3 f32 ---------------------
    with config_overrides(precision="f32"):
        cfg = get_config()
        res, launches, wall = counted("flagship f32", lambda:
                                      api.solve_elasticity_3D_static(
                                          **flagship, data_dir=data_dir))
    st = res.meta["solver_stats"]
    vm = field(res)[0]
    vm_gap = gap(vm, vm_mixed)
    tol32 = max(cfg.inner_tol, 1e-7)
    print(f"precision flagship f32: iterations={st['cg_iterations']} (cap "
          f"{cfg.resolved_maxiter(3 * nodes)}) relres="
          f"{st['relative_residual']:.3e} (tolerance {tol32:.0e}) target="
          f"{st['convergence_target']:.1e} converged={st['converged']} wall "
          f"{wall:.3f} s peak device memory {peak_gib():.2f} GiB launches "
          f"{launches}; vs the mixed dense flagship max|Δvm|/max|vm|="
          f"{vm_gap:.3e}", flush=True)
    check(vm.shape == (1, nodes) and bool(np.all(np.isfinite(vm))),
          f"flagship f32: field {vm.shape}")
    check(st["convergence_target"] == max(tol32, cfg.accuracy_target),
          f"flagship f32: target {st['convergence_target']}")
    if cuda:   # K1 v3 f32 for the solve, v1 f32 for the projection's
        check(launches.get("v3_f32", 0) > 0 and not any(
            v for k, v in launches.items() if k not in ("v3_f32", "v1_f32")),
            f"flagship f32 launches {launches}")
    out["flagship_f32"] = dict(
        iterations=int(st["cg_iterations"]), relres=st["relative_residual"],
        converged=bool(st["converged"]), wall_s=wall,
        launches=launches.get("v3_f32", 0), vm_gap=vm_gap)
    del vm

    # -- 3. heat at float64: the 128³ slice and the 40×6×6 transient ----------
    steps = heat.get("num_steps", HEAT_STEPS)
    with config_overrides(precision="f64"):
        res, launches, wall = counted("heat f64", lambda: api.solve_heat_3D(
            **heat, data_dir=data_dir))
    st = res.meta["solver_stats"]
    T = field(res)[0]
    os.remove(res.data_file)
    heat_gap = gap(T, T_f32)
    print(f"precision heat f64: dof={st['num_dofs']} scan "
          f"{st['scan_seconds']:.3f} s setup {st['setup_seconds']:.3f} s "
          f"({steps / st['scan_seconds']:.3f} steps/s) iterations/step="
          f"{st['cg_iterations'] / steps:.2f} relres="
          f"{st['relative_residual']:.3e} converged={st['converged']} wall "
          f"{wall:.3f} s peak device memory {peak_gib():.2f} GiB launches "
          f"{launches}; vs the float32 run max|ΔT|/max|T|={heat_gap:.3e} "
          f"(bound {HEAT_F64_TOL})", flush=True)
    check(not any(launches.values()), f"heat f64 launched kernels: "
          f"{launches}")
    check(bool(st["converged"]) and T.shape == T_f32.shape
          and bool(np.all(np.isfinite(T))), f"heat f64: {st} {T.shape}")
    check(heat_gap <= HEAT_F64_TOL, f"heat f64 off the float32 run by "
          f"{heat_gap:.3e}")
    out["heat_f64"] = dict(scan_s=st["scan_seconds"],
                           iterations=int(st["cg_iterations"]))
    del T
    with config_overrides(precision="f64", transient_mg_threshold=100,
                          mg_threshold=100):
        res, launches, wall = counted("small heat f64", lambda:
                                      api.solve_heat_3D(**small_heat,
                                                        data_dir=data_dir))
    st = res.meta["solver_stats"]
    small_gap = gap(field(res)[0], T_small_ref)
    print(f"precision small heat f64: 40x6x6 MG-PCG iterations="
          f"{st['cg_iterations']} relres={st['relative_residual']:.3e} vs "
          f"host f64 backward Euler max|ΔT|/max|T|={small_gap:.3e} (bound "
          f"{SMALL_HEAT_F64_TOL}) launches {launches}", flush=True)
    check(not any(launches.values()) and bool(st["converged"]),
          f"small heat f64: {st} {launches}")
    check(small_gap <= SMALL_HEAT_F64_TOL, f"small heat f64 off the host "
          f"solve by {small_gap:.3e}")
    out["heat_f64"].update(gap_f32=heat_gap, small_gap=small_gap)

    # -- 4. the released cantilever at float64: its energy balance ------------
    calls = spy_newmark()
    with config_overrides(precision="f64"):
        res, launches, wall = counted("dynamic f64", lambda:
                                      api.solve_elasticity_3D_dynamic(
                                          **beam, data_dir=data_dir))
    os.remove(res.data_file)
    st = res.meta["solver_stats"]
    (K_np, M_np, _, _, f_np, *_), _, nres = calls[-1]
    del calls[:]
    share, energy, work = energy_share(K_np, M_np, f_np, nres, parts=True)
    bsteps = beam["num_steps"]
    newmark_line("precision dynamic f64", nres, bsteps, launches,
                 f" wall {wall:.3f} s; energy balance ½vᵀMv + ½uᵀKu − fᵀu = "
                 f"{energy:.6e} J against fᵀu = {work:.6e} J: share "
                 f"{share:.3e} (float32: {share_f32:.3e})")
    check(not any(launches.values()), f"dynamic f64 launched kernels: "
          f"{launches}")
    check(bool(st["converged"]) and bool(np.all(np.isfinite(nres.values)))
          and np.isfinite(share) and share <= DYNAMIC_F64_SHARE * share_f32,
          f"dynamic f64: share {share:.3e} against float32 {share_f32:.3e}, "
          f"{st}")
    out["dynamic_f64"] = dict(share=share, share_f32=share_f32,
                              scan_s=nres.scan_seconds,
                              iterations=nres.total_cg_iterations)
    del K_np, M_np, nres

    # -- 5. checkpointed scans at the card's default precision ----------------
    ckpt_dir = os.path.join(data_dir, "checkpoints")
    for label, tool, kw, frames in (
            ("heat", "solve_heat_3D", small_heat,
             lambda r: (field(r)[0],)),
            ("dynamic", "solve_elasticity_3D_dynamic", ckpt_beam,
             lambda r: (calls[-1][2].values, calls[-1][2].velocities))):
        def call():
            return getattr(api, tool)(**kw, data_dir=data_dir)

        res, launches, wall = counted(f"ckpt {label} plain", call)
        plain = frames(res)
        timestepping._CKPT_TEST_ABORT = 1
        try:
            with config_overrides(transient_checkpoint_every=CKPT_EVERY,
                                  checkpoint_dir=ckpt_dir):
                call()
        except RuntimeError as e:
            check(str(e) == "checkpoint test abort", f"ckpt {label}: {e}")
        else:
            check(False, f"ckpt {label}: the run did not abort")
        finally:
            timestepping._CKPT_TEST_ABORT = 0
        kept = os.listdir(ckpt_dir)
        check(len(kept) == 1, f"ckpt {label}: checkpoint files {kept}")
        with np.load(os.path.join(ckpt_dir, kept[0])) as z:
            at = int(z["step"])
        with config_overrides(transient_checkpoint_every=CKPT_EVERY,
                              checkpoint_dir=ckpt_dir):
            res, launches_r, wall_r = counted(f"ckpt {label} resumed", call)
        same = all(np.array_equal(a, b) for a, b in zip(frames(res), plain))
        print(f"precision checkpointed {label} {tool}"
              f"({', '.join(f'{k}={v}' for k, v in kw.items())}): aborted "
              f"at step {at} ({kept[0]}), resumed in {wall_r:.3f} s (plain "
              f"{wall:.3f} s); bit-equal to the uncheckpointed run: {same}; "
              f"launches plain {launches} resumed {launches_r}", flush=True)
        check(at == CKPT_EVERY and same and not os.listdir(ckpt_dir),
              f"ckpt {label}: resumed at {at}, bit-equal {same}")
        if cuda:
            want = "v1_f32" if label == "heat" else "v3_f32"
            check(launches_r.get(want, 0) > 0, f"ckpt {label} launched no "
                  f"{want}")
        del calls[:]
    out["checkpoint"] = True

    # -- 6. the bf16 smoother copy's size gate -------------------------------
    # the 16×8×8 levels lie under the gate (``multigrid.BF16_MIN_DOF``):
    # lowered to 0 DOF, every level smooths with a bf16 copy; at its value,
    # none does, and each smooths with its float32 operator
    from pde_solver_tpu_torch.ops import multigrid as mg_mod

    gate = mg_mod.BF16_MIN_DOF
    runs = {}
    try:
        for name, min_dof in (("bf16", 0), ("f32", gate)):
            mg_mod.BF16_MIN_DOF = min_dof
            linsolve._MG_CACHE.clear()
            with config_overrides(precision="mixed", host_direct_threshold=0,
                                  mg_threshold=100), disk_cache_off():
                res, launches, wall = counted(
                    f"smoother {name}", lambda:
                    api.solve_elasticity_3D_static(**small,
                                                   data_dir=data_dir))
            (h, _), = linsolve._MG_CACHE.values()
            smooth = sorted({str(lv.w_smooth.W.dtype) for lv in h.levels
                             if hasattr(lv.w_smooth, "W")})
            runs[name] = (field(res)[0], launches, res.meta["solver_stats"],
                          smooth)
            del h
    finally:
        mg_mod.BF16_MIN_DOF = gate
        linsolve._MG_CACHE.clear()
    sw_gap = gap(runs["f32"][0], runs["bf16"][0])
    print("precision smoother gate (16x8x8 cantilever, mixed, bf16 gate "
          f"at 0 DOF and at {gate}): " + "; ".join(
        f"{k}: smoother weights {smooth} iterations="
        f"{st_['cg_iterations']} launches {ln}"
        for k, (_, ln, st_, smooth) in runs.items())
        + f"; max|Δvm|/max|vm|={sw_gap:.3e}", flush=True)
    check(runs["f32"][3] == ["torch.float32"]
          and runs["bf16"][3] == ["torch.bfloat16"],
          f"smoother weights: {runs['f32'][3]} / {runs['bf16'][3]}")
    check(all(r[2]["converged"] for r in runs.values()) and sw_gap <= 1e-6,
          f"smoother gate: fields {sw_gap:.3e} apart")
    if cuda:
        l0, l1 = runs["f32"][1], runs["bf16"][1]
        check(not any(v for k, v in l0.items() if k.endswith("_bf16"))
              and l1.get("v3_bf16", 0) > 0
              and l0.get("v3_f32", 0) > l1.get("v3_f32", 0),
              f"smoother gate launches: f32 → {l0}, bf16 → {l1}")
    out["smoother_gap"] = sw_gap
    return out


# the shard phase.  The legs of the JAX package's multi-device dry run
# (``__graft_entry__.dryrun_multichip``, recorded in MULTICHIP_r05.json over
# 8 virtual CPU devices) at their sizes, each against the same solve
# unsharded; then the flagship on 4 shards.  Shards are virtual copies of
# the one card (PDE_TPU_VIRTUAL_DEVICES): the run checks the decomposition,
# the halos and the reductions there, never multi-GPU speed
SHARD_RECORD = "MULTICHIP_r05.json"
SHARD_VIRTUAL = 8
SHARD_FLAGSHIP = 4
SHARD_LEG_TOL = 1e-9       # sharded against unsharded, float64, ·max
SHARD_F64_TOL = 1e-9       # the f64 flagship against unsharded, ·max|u|
SHARD_VM_TOL = 1e-6        # the "mixed" flagship's von Mises against the dense
SHARD_LABEL = "virtual shards on one card: not multi-GPU speed"
# the "mixed" flagship's refinement rounds.  Its host float64 refinement
# around float32 inner solves gains a factor ~0.2 a round on the flagship
# (the float32 operator's rounding times its conditioning), so the
# reference's default of 7 rounds stops at relres ~6e-5, not converged;
# 12 reach ~2e-8.  The run prints every round's relres, the 7th included
SHARD_MIXED_ROUNDS = 12
REFINE_LINE = (r"refinement round (\d+): relres before ([0-9.e+-]+), (\d+) "
               r"inner iterations \((\d+) DOF\)")
SHARD_LEG_DOF = (400, 1350, 1275, 1078, 672, 648, 720, 1200)
# the host reads of the sharded loops (one a block or chunk)
SHARD_READS = ("shard_cg", "shard_mg", "shard_scan")


def record_iterations(root):
    """The CG / MG iterations of each leg of the JAX package's dry-run
    record, in leg order (None where the record is missing)."""
    path = os.path.join(root, SHARD_RECORD)
    if not os.path.exists(path):
        return [None] * len(SHARD_LEG_DOF)
    with open(path) as f:
        tail = json.load(f)["tail"]
    return [int(m.group(1)) for m in re.finditer(r"iters=(\d+)", tail)]


@contextlib.contextmanager
def virtual_devices(n):
    """``PDE_TPU_VIRTUAL_DEVICES=n`` within, the previous value after."""
    prev = os.environ.get("PDE_TPU_VIRTUAL_DEVICES")
    os.environ["PDE_TPU_VIRTUAL_DEVICES"] = str(n)
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("PDE_TPU_VIRTUAL_DEVICES", None)
        else:
            os.environ["PDE_TPU_VIRTUAL_DEVICES"] = prev


@contextlib.contextmanager
def loop_seconds(device):
    """The wall seconds of the solve loops and scans run within
    (``device_loop.run_masked`` / ``run_scan`` calls, the device
    synchronised around the outermost): yields the list they add to."""
    import torch

    from pde_solver_tpu_torch.ops import device_loop

    secs, depth = [], [0]
    origs = {name: getattr(device_loop, name)
             for name in ("run_masked", "run_scan")}

    def timed(fn):
        def run(*a, **kw):
            depth[0] += 1
            try:
                if depth[0] > 1:
                    return fn(*a, **kw)
                if device == "cuda":
                    torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **kw)
                if device == "cuda":
                    torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
                return out
            finally:
                depth[0] -= 1
        return run

    for name, fn in origs.items():
        setattr(device_loop, name, timed(fn))
    try:
        yield secs
    finally:
        for name, fn in origs.items():
            setattr(device_loop, name, fn)


SHARD_WAYS = ("program", "uncaptured")


def shard_legs(n=SHARD_VIRTUAL):
    """The eight legs at float64 on the configured device, each sharded
    over ``n`` shards (the 2-D leg over an n/2 × 2 mesh) as its device
    programs ship (captured on a card), again under
    ``device_loop._uncaptured()``, and unsharded.  Returns [(label, DOF,
    steps, sharded iterations, unsharded iterations, max|Δ|/max|unsharded|,
    seconds, {way: (iterations, host reads, loop seconds)}, max|Δ| of the
    program against uncaptured / max)]."""
    import numpy as np
    import torch

    from pde_solver_tpu_torch.config import config_overrides, get_config
    from pde_solver_tpu_torch.mesh import box_mesh
    from pde_solver_tpu_torch.models import elasticity as elast
    from pde_solver_tpu_torch.models import heat
    from pde_solver_tpu_torch.models.wave import (WaveProblem,
                                                  solve_wave_problem)
    from pde_solver_tpu_torch.ops import (assembly, device_loop, linsolve,
                                          timestepping)
    from pde_solver_tpu_torch.ops.bc import DirichletBC, all_boundary
    from pde_solver_tpu_torch.parallel import shard as psh

    lam, mu = elast.lame_parameters(210e9, 0.3, "3d")
    g = np.array([0.0, 0.0, -9.81 * 7800.0])
    device = get_config().device
    beam = (1.0, 0.2, 0.2)

    def clamped(m):
        return DirichletBC.from_masks([(m.face_mask(0, 0), 0.0)],
                                      m.node_shape, vdim=3)

    # each leg(sharded) → (DOF, steps, field, iterations)
    def heat_step(sharded):
        m = box_mesh(2 * n - 1, 4, 4, (0, 0, 0), (1.0, 1.0, 1.0))
        bc = DirichletBC.from_masks([(all_boundary(m), 0.0)], m.node_shape)
        u0 = bc.apply_values(np.full(m.node_shape, 20.0))
        step, inputs = psh.build_sharded_heat_step(
            m, psh.device_mesh(n if sharded else 1), 1.0, 0.01, bc,
            dtype=torch.float64, tol=1e-6, maxiter=200)
        u1, iters, _ = step(u0, *inputs)
        return m.num_nodes, 1, u1.cpu().numpy(), iters

    def elasticity_cg(sharded):
        m = box_mesh(2 * n + 1, 4, 4, (0, 0, 0), beam)
        cg, sysm = psh.build_sharded_elasticity_solve(
            m, psh.device_mesh(n), lam, mu, g, clamped(m),
            dtype=torch.float64)
        if sharded:
            x, k, _ = cg.solve(tol=1e-6, maxiter=2000)
        else:
            b = torch.tensor(sysm.b_hat, device=device)
            w = tuple(torch.tensor(W, device=device) for W in sysm.weights)
            x, k, _ = linsolve._cg_unit_diag(sysm.offsets, w, b,
                                             torch.zeros_like(b), 1e-6, 2000,
                                             3, 3)
        return 3 * m.num_nodes, 1, sysm.from_hat_x(x.cpu().numpy()), k

    def sharded_mg(sharded):
        m = box_mesh(16, 4, 4, (0, 0, 0), beam)

        def builder(mc):
            return (assembly.assemble_elasticity_stencil(mc, lam, mu),
                    clamped(mc))

        with config_overrides(shard_devices=n if sharded else 0,
                              mg_threshold=100, host_direct_threshold=0):
            x, st = linsolve.solve_stencil_system(
                assembly.assemble_elasticity_stencil(m, lam, mu), m,
                clamped(m), assembly.assemble_vector_load(m, g), vdim=3,
                mg_level_builder=builder)
        return 3 * m.num_nodes, 1, x, int(st.iterations)

    def transient(sharded):
        p = heat.HeatProblem(
            mesh=box_mesh(21, 6, 6, (0, 0, 0), (1.0, 1.0, 1.0)),
            diffusivity=1.0, bc_builder=lambda m: [(all_boundary(m), 0.0)],
            T_initial=20.0, dt=0.01, num_steps=5)
        with config_overrides(shard_devices=n if sharded else 0,
                              host_direct_threshold=0):
            _, values, info = heat.solve_heat_problem(p)
        return p.mesh.num_nodes, 5, values, info["cg_iterations"]

    def newmark(sharded):
        m = box_mesh(13, 3, 3, (0, 0, 0), beam)
        args = (assembly.assemble_elasticity_stencil(m, lam, mu),
                elast.assemble_vector_mass(m, 7800.0), m, clamped(m),
                assembly.assemble_vector_load(m, g),
                np.zeros(m.node_shape + (3,)), np.zeros(m.node_shape + (3,)))
        with config_overrides(shard_devices=n if sharded else 0):
            r = timestepping.run_newmark(*args, dt=1e-5, num_steps=4,
                                         vdim=3)
        return (3 * m.num_nodes, 4, np.concatenate([r.values, r.velocities]),
                r.total_cg_iterations)

    def wave(sharded):
        pw = WaveProblem(mesh=box_mesh(2 * n + 1, 5, 5, (0, 0, 0),
                                       (1.0, 1.0, 1.0)),
                         wave_speed=2.0, initial_type="sine",
                         initial_wavenumber=np.pi, dt=0.005, num_steps=4)
        with config_overrides(shard_devices=n if sharded else 0):
            _, values, info = solve_wave_problem(pw)
        return pw.mesh.num_nodes, 4, values, info["cg_iterations"]

    def cnab2(sharded):
        m = box_mesh(2 * n + 3, 5, 5, (0, 0, 0), (1.0, 1.0, 1.0))
        K = {o: 0.05 * W for o, W in assembly.assemble_scalar_stencil(
            m, "stiffness").items()}
        bc = DirichletBC.from_masks([(all_boundary(m), 0.0)], m.node_shape)
        b = assembly.assemble_load(m)
        xc = m.node_coords
        u0 = bc.apply_values(np.exp(-((xc[..., 0] - 0.5) ** 2
                                      + (xc[..., 1] - 0.5) ** 2
                                      + (xc[..., 2] - 0.5) ** 2) / 0.05))
        kw = dict(dt=0.004, num_steps=5, theta=0.5,
                  C_np=assembly.assemble_convection_stencil(
                      m, [0.8, -0.3, 0.2]),
                  convection_scheme="cnab2",
                  time_mod={"omega": 5.0, "phase": 0.2,
                            "source_amp": 0.5 * b})
        with config_overrides(shard_devices=n if sharded else 0):
            r = timestepping.run_transient(
                K, assembly.assemble_scalar_stencil(m, "mass"), m, bc, b,
                u0, **kw)
        return m.num_nodes, 5, r.values, r.total_cg_iterations

    def mesh_2d(sharded):
        a = n // 2
        m = box_mesh(2 * a + 1, 7, 4, (0, 0, 0), (1.0, 0.5, 0.5))
        kw = dict(shard_grid=f"{a},2") if sharded else dict(shard_devices=0)
        with config_overrides(host_direct_threshold=0, **kw):
            x, st = linsolve.solve_stencil_system(
                assembly.assemble_elasticity_stencil(m, lam, mu), m,
                clamped(m), assembly.assemble_vector_load(m, g), vdim=3)
        return 3 * m.num_nodes, 1, x, int(st.iterations)

    legs = []
    with config_overrides(precision="f64"):
        for label, fn in (("heat step", heat_step),
                          ("elasticity CG", elasticity_cg),
                          ("sharded MG-PCG", sharded_mg),
                          ("transient", transient), ("Newmark", newmark),
                          ("scalar wave", wave),
                          ("CNAB2 advection + tmod", cnab2),
                          (f"{n // 2}x2 mesh elasticity", mesh_2d)):
            t = time.perf_counter()
            ways, fields = {}, {}
            for way in SHARD_WAYS:
                clear_scans()
                device_loop.HOST_READS.clear()
                with loop_seconds(device) as secs, (
                        device_loop._uncaptured() if way == "uncaptured"
                        else contextlib.nullcontext()):
                    dof, steps, sh, k_sh = fn(True)
                fields[way] = np.asarray(sh)
                ways[way] = (int(k_sh), dict(device_loop.HOST_READS),
                             sum(secs))
            dof, steps, plain, k_plain = fn(False)
            sh, plain = fields["program"], np.asarray(plain)
            check(sh.shape == plain.shape and bool(np.all(np.isfinite(sh))),
                  f"shard leg {label}: {sh.shape} against {plain.shape}")
            gap = float(np.abs(sh - plain).max() / np.abs(plain).max())
            way_gap = float(np.abs(sh - fields["uncaptured"]).max()
                            / np.abs(plain).max())
            legs.append((label, dof, steps, ways["program"][0], int(k_plain),
                         gap, time.perf_counter() - t, ways, way_gap))
    clear_scans()
    return legs


def spy_from_hat():
    """Record (scaled system, x̂) of every block system's
    ``ScaledSystem.from_hat_x`` call; returns the list and the undo."""
    from pde_solver_tpu_torch.ops.linsolve import ScaledSystem

    calls = []
    orig = ScaledSystem.from_hat_x

    def spy(self, x_hat):
        if self.scale_kind == "block":
            calls.append((self, x_hat))
        return orig(self, x_hat)

    ScaledSystem.from_hat_x = spy
    return calls, lambda: setattr(ScaledSystem, "from_hat_x", orig)


def halo_bytes(solver) -> int:
    """Bytes one sharded apply moves between neighbouring shards: two node
    layers (all components: the free mask has the state's shape) across
    each inner interface of the 1-D mesh."""
    blk = solver.free.parts[0]
    return 2 * (solver.mesh_dev.size - 1) * blk[0].numel() \
        * blk.element_size()


def shard_phase(api, counted, data_dir, u_f64, iters_f64, vm_dense,
                card_line, root, flagship=FLAGSHIP, legs_n=SHARD_VIRTUAL,
                shards=SHARD_FLAGSHIP, device="cuda",
                relres_tol=PRECISION_RELRES_TOL):
    """The sharding layer on the card, over ``legs_n`` virtual copies of it
    (``PDE_TPU_VIRTUAL_DEVICES``, set for this phase only): the eight legs
    of the JAX package's dry-run record against the same solves unsharded
    (``shard_legs``), then the flagship on ``shards`` shards through the
    API, (a) under "f64" against the unsharded float64 flagship of the
    precision phase (``u_f64``, ``iters_f64``), (b) at the card's default
    ("mixed": the host float64 refinement around sharded float32 MG
    inner solves) against the dense flagship's von Mises ``vm_dense``.
    ``counted(label, fn) → (result, launches, wall s)``.  A CPU rehearsal
    passes small sizes and ``device="cpu"``.  Returns the numbers PERF.md
    keeps."""
    import numpy as np
    import torch

    from pde_solver_tpu_torch.config import config_overrides
    from pde_solver_tpu_torch.ops import device_loop, linsolve
    from pde_solver_tpu_torch.ops import multigrid as mg
    from pde_solver_tpu_torch.parallel import shard_mg

    cuda = device == "cuda"
    out = {"label": SHARD_LABEL}
    n_cards = torch.cuda.device_count() if cuda else 0
    print(f"shard phase ({card_line}): {n_cards} physical card(s), "
          f"PDE_TPU_VIRTUAL_DEVICES={legs_n} for this phase; {SHARD_LABEL}",
          flush=True)
    with virtual_devices(legs_n):
        # -- 1. the eight legs of the dry-run record --------------------------
        record = record_iterations(root)
        legs, launches, wall = counted("shard legs", lambda: shard_legs(
            legs_n))
        for (label, dof, steps, k_sh, k_plain, gap, secs, ways, way_gap), \
                k_rec, want in zip(legs, record, SHARD_LEG_DOF):
            print(f"shard leg {label}: {dof} DOF x {steps} step(s), "
                  f"{legs_n} shards (f64): iterations {k_sh}, unsharded "
                  f"{k_plain}, JAX record {k_rec}; max|Δ|/max|unsharded|="
                  f"{gap:.3e} (bound {SHARD_LEG_TOL}); {secs:.3f} s "
                  f"({SHARD_LABEL}); " + "; ".join(
                      f"{way}: iterations {k}, host reads {r}, loops "
                      f"{1e3 * t:.3f} ms ({1e3 * t / max(k, 1):.3f} ms an "
                      f"iteration)" for way, (k, r, t) in ways.items())
                  + f"; program against uncaptured {way_gap:.3e}",
                  flush=True)
            check(dof == want, f"shard leg {label}: {dof} DOF, the record "
                  f"has {want}")
            check(gap <= SHARD_LEG_TOL, f"shard leg {label}: sharded off "
                  f"unsharded by {gap:.3e}")
            (k_p, r_p, _), (k_u, r_u, _) = (ways[w] for w in SHARD_WAYS)
            check(way_gap == 0.0 and k_p == k_u and r_p == r_u,
                  f"shard leg {label}: program against uncaptured: "
                  f"iterations {k_p} / {k_u}, reads {r_p} / {r_u}, gap "
                  f"{way_gap:.3e}")
            # the static legs read once a block of their loop
            block = {"heat step": linsolve.CG_BLOCK,
                     "elasticity CG": linsolve.CG_BLOCK,
                     "sharded MG-PCG": mg.PCG_BLOCK}.get(
                label, linsolve.CG_BLOCK if "mesh" in label else None)
            check(any(r_p.get(kind) for kind in SHARD_READS) and (
                block is None or sum(r_p.values())
                == max(1, -(-k_p // block))), f"shard leg {label}: host "
                f"reads {r_p} for {k_p} iterations")
        check(len(legs) == len(SHARD_LEG_DOF), f"shard legs: {len(legs)}")
        check(not any(launches.values()), f"shard legs launched kernels: "
              f"{launches}")
        out["legs"] = {label: dict(dof=dof, iterations=k_sh,
                                   unsharded=k_plain, record=k_rec, gap=gap,
                                   seconds=secs, ways=ways, way_gap=way_gap)
                       for (label, dof, _, k_sh, k_plain, gap, secs, ways,
                            way_gap), k_rec in zip(legs, record)}
        out["legs_s"] = wall

        # -- 2. the flagship on ``shards`` shards -----------------------------
        cells = (flagship["nx"], flagship["ny"], flagship["nz"])
        dof = 3 * int(np.prod([c + 1 for c in cells]))
        for prec in ("f64", "mixed"):
            label = f"flagship sharded {prec}"
            vm_calls, unspy_vm = spy_von_mises()
            hats, unspy_hat = spy_from_hat()
            secs, unsolve = timed_calls(shard_mg, "solve_mg_sharded", device)
            inner, timed_solve = [], shard_mg.solve_mg_sharded

            def recorded(*a, **kw):
                inner.append((a, kw))
                return timed_solve(*a, **kw)

            shard_mg.solve_mg_sharded = recorded
            linsolve._MG_CACHE.clear()
            shard_mg._SOLVER_CACHE.clear()
            # "mixed" is the card's default precision
            rounds = dict(refine_rounds=SHARD_MIXED_ROUNDS) \
                if prec == "mixed" else {}
            try:
                with config_overrides(shard_devices=shards, precision=prec,
                                      **rounds), solver_log() as log:
                    res, launches, wall = counted(
                        label, lambda: api.solve_elasticity_3D_static(
                            **flagship, data_dir=data_dir))
            finally:
                shard_mg.solve_mg_sharded = timed_solve
                unspy_vm(), unspy_hat(), unsolve()
            peak = (torch.cuda.max_memory_allocated() / 2 ** 30 if cuda
                    else float("nan"))
            st = res.meta["solver_stats"]
            vm = field(res)[0]
            (solver_h, solver), = shard_mg._SOLVER_CACHE.values()
            ops_v = aten_ops(lambda: solver._precondition(solver.free))
            halo = halo_bytes(solver)
            rows = [p.shape[0] for p in solver.free.parts]
            # its first (or only) inner solve again, as the device program
            # ships and uncaptured, on the same operands
            (_, b0, x00, tol0, maxiter0), kw0 = inner[0]
            check(not kw0, f"{label}: solve_mg_sharded keywords {kw0}")
            ways = {}
            for way in SHARD_WAYS:
                device_loop.HOST_READS.clear()
                with loop_seconds(device) as ls, (
                        device_loop._uncaptured() if way == "uncaptured"
                        else contextlib.nullcontext()):
                    xw, kw_, _ = solver.solve(b0, x00, tol=tol0,
                                              maxiter=maxiter0)
                ways[way] = (xw.cpu().numpy(), int(kw_),
                             dict(device_loop.HOST_READS), sum(ls))
            (x_p, k_p, r_p, t_p), (x_u, k_u, r_u, t_u) = (
                ways[w] for w in SHARD_WAYS)
            inner_gap = float(np.abs(x_p - x_u).max() / np.abs(x_u).max())
            inner_line = (f"; its first inner solve again ({len(inner)} "
                          f"call(s)): program {k_p} iterations, host reads "
                          f"{r_p}, {1e3 * t_p / max(k_p, 1):.3f} ms an "
                          f"iteration; uncaptured {k_u} iterations, host "
                          f"reads {r_u}, {1e3 * t_u / max(k_u, 1):.3f} ms an"
                          f" iteration; field gap {inner_gap:.3e}")
            check(k_p == k_u and inner_gap == 0.0 and r_p == r_u == {
                "shard_mg": max(1, -(-k_p // mg.PCG_BLOCK))},
                f"{label}: the inner solve's program against uncaptured: "
                f"iterations {k_p} / {k_u}, reads {r_p} / {r_u}, gap "
                f"{inner_gap:.3e}")
            del solver_h, solver, inner, ways, x_p, x_u
            shard_mg._SOLVER_CACHE.clear()
            linsolve._MG_CACHE.clear()
            (sysm, xh), = hats
            host = host_relres_of(sysm, np.asarray(xh, np.float64))
            del hats
            setup = setup_seconds(log, dof)
            iters = int(st["cg_iterations"])
            solve_s = sum(secs)
            (vm_rec,) = vm_calls
            u = vm_rec["u"]
            del vm_calls
            line = (f"{label} ({card_line}; {SHARD_LABEL}): {shards} shards "
                    f"of {rows} planes ({cells[0] + 1} padded to "
                    f"{sum(rows)}), dof={st['num_dofs']}; wall {wall:.3f} s, "
                    f"set-up {setup['total']:.3f} s ("
                    + " ".join(f"{k}={v:.3f}" for k, v in setup.items()
                               if k != "total")
                    + f"), solve_mg_sharded {solve_s:.3f} s in {len(secs)} "
                    f"call(s); iterations {iters} "
                    f"({1e3 * solve_s / max(iters, 1):.3f} ms an iteration);"
                    f" relres={st['relative_residual']:.6e}"
                    f" host f64 recomputation={host:.6e} converged="
                    f"{st['converged']}; peak device memory {peak:.2f} GiB; "
                    f"halo bytes an apply {halo}; aten ops of one sharded "
                    f"V-cycle {ops_v}; kernel launches {launches}"
                    + inner_line)
            check(st["num_dofs"] == dof and vm.shape == (1, dof // 3)
                  and bool(np.all(np.isfinite(vm))), f"{label}: {st}")
            check(bool(st["converged"]), f"{label} did not converge: {st}")
            check(abs(st["relative_residual"] - host) <= relres_tol * host,
                  f"{label}: relres {st['relative_residual']:.6e} against "
                  f"the host's {host:.6e}")
            check(not any(v for k, v in launches.items()
                          if k.startswith(("v1_", "v2_", "v3_", "cs_"))),
                  f"{label} launched K1 or CS kernels: {launches}")
            numbers = dict(wall_s=wall, setup_s=setup["total"],
                           solve_s=solve_s, iterations=iters,
                           inner_program=(k_p, r_p, t_p),
                           inner_uncaptured=(k_u, r_u, t_u),
                           inner_gap=inner_gap,
                           ms_per_iteration=1e3 * solve_s / max(iters, 1),
                           relres=st["relative_residual"], host_relres=host,
                           peak_gib=peak, halo_bytes=halo,
                           aten_ops_vcycle=ops_v)
            if prec == "f64":
                u_gap = float(np.abs(u - u_f64).max() / np.abs(u_f64).max())
                relation = ("equal" if iters == iters_f64 else
                            "within one" if abs(iters - iters_f64) == 1 else
                            f"{iters_f64 - iters} fewer" if iters < iters_f64
                            else f"{iters - iters_f64} more")
                print(line + f"; against the unsharded f64 flagship: "
                      f"max|Δu|/max|u|={u_gap:.3e} (bound {SHARD_F64_TOL}),"
                      f" iterations {iters} against {iters_f64}: {relation}"
                      f" (the sharded solver keeps the dense coarsest "
                      f"inverse, as the JAX package's does; solve_mg drops "
                      f"it)", flush=True)
                check(u_gap <= SHARD_F64_TOL, f"{label} off the unsharded "
                      f"f64 flagship by {u_gap:.3e}")
                check(k_p == iters, f"{label}: its solve took {iters} "
                      f"iterations, the same solve again {k_p}")
                check(iters <= iters_f64 + 1, f"{label}: {iters} iterations"
                      f" against {iters_f64} unsharded")
                numbers.update(u_gap=u_gap, iters_unsharded=iters_f64)
            else:
                vm_gap = float(np.abs(vm - vm_dense).max()
                               / np.abs(vm_dense).max())
                before = [float(m.group(2)) for m in
                          (re.search(REFINE_LINE, x) for x in log)
                          if m and int(m.group(4)) == dof]
                after7 = (before[7] if len(before) > 7
                          else st["relative_residual"])
                print(line + f"; against the dense flagship's von Mises: "
                      f"max|Δvm|/max|vm|={vm_gap:.3e} (bound {SHARD_VM_TOL})"
                      f"; refine_rounds={SHARD_MIXED_ROUNDS}, relres before "
                      f"each round {['%.3e' % r for r in before]} (after the"
                      f" default 7 rounds: {after7:.3e})", flush=True)
                numbers.update(relres_by_round=before)
                check(vm_gap <= SHARD_VM_TOL, f"{label} off the dense "
                      f"flagship by {vm_gap:.3e}")
                numbers.update(vm_gap=vm_gap)
            out[label] = numbers
            del vm, u
            if cuda:
                torch.cuda.empty_cache()
    print(f"shard phase: the NCCL leg of parallel.distributed was not run: "
          f"it needs two cards or more, this machine has {n_cards} (its gloo "
          f"leg runs on the CPU in tests/test_torch_distributed.py)",
          flush=True)
    return out


# the graphs phase: each captured solve loop against the same loop run
# uncaptured (``device_loop._uncaptured``), max|Δ|/max of the fields.  Both
# runs launch the same kernels in the same order on the same stream
GRAPH_TOL = 1e-6
# the graphs phase's modal pair: subspace iterations of each run (the
# modal phase's converges in 7; 8 solves of its 28)
MODAL_GRAPH_ITERS = 2


def grab_df2(run, device="cuda"):
    """``run()`` with ``multigrid.solve_fcycle_df2`` spied (the device
    synchronised around it): returns (run's result, its one df2 solve's
    (hierarchy, ladder, tol, keywords, result, seconds))."""
    import torch

    from pde_solver_tpu_torch.ops import multigrid as mg

    grabbed = []
    solve_df2 = mg.solve_fcycle_df2

    def spy(h, ladder, tol, **kw):
        if device == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        res = solve_df2(h, ladder, tol, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        grabbed.append((h, ladder, tol, kw, res, time.perf_counter() - t))
        return res

    mg.solve_fcycle_df2 = spy
    try:
        res = run()
    finally:
        mg.solve_fcycle_df2 = solve_df2
    (df2,) = grabbed
    return res, df2


def graphs_phase(api, counted, data_dir, card_line, refs, peaks,
                 flagship=FLAGSHIP, modal=MODAL_3D, scans=None,
                 device="cuda", profiled=True):
    """The solve loops as captured CUDA graphs (``ops.device_loop``) against
    the same loops uncaptured, at full width: the flagship's double-float32
    rounds ("mixed"), its float64 ``solve_mg`` (the hierarchy and right
    side the precision phase left in ``refs``), the modal 3D tool at
    ``modal`` (the modal phase's size) with its subspace iteration cut to
    :data:`MODAL_GRAPH_ITERS`, captured and uncaptured, and the flagship's
    projection (flat CG).  Each pair: the
    same iterations, fields within
    ``GRAPH_TOL``, host reads at most one a block (one a round for df2),
    launches with the replays counted, seconds both ways, peak device
    memory with graphs and without (and what the graph pools hold).  Then
    the scans of ``scans`` (default :func:`scan_cases`) by
    :func:`scans_leg`, the heat slice's K1 run held against phase 6's
    (``refs["heat"]``).  Last, a planted capture fault must raise.
    Returns the numbers by path."""
    import contextlib as ctx
    import gc

    import numpy as np
    import torch

    from pde_solver_tpu_torch.config import get_config
    from pde_solver_tpu_torch.mesh import box_mesh
    from pde_solver_tpu_torch.ops import device_loop, linsolve, projection
    from pde_solver_tpu_torch.ops import multigrid as mg
    from pde_solver_tpu_torch.ops import stencil_kernels as sk

    cuda = device == "cuda"
    cfg = get_config()
    out = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def gib(b):
        return b / 2 ** 30

    def allocated():
        return torch.cuda.memory_allocated() if cuda else 0

    def peak():
        return gib(torch.cuda.max_memory_allocated()) if cuda else float("nan")

    def gap(a, b):
        a, b = (np.asarray(t.detach().cpu() if torch.is_tensor(t) else t,
                           np.float64) for t in (a, b))
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))

    def mode(captured):
        return ctx.nullcontext() if captured else device_loop._uncaptured()

    def direct(fn, captured):
        """fn() once: (result, seconds, launches, host reads, peak GiB of
        device memory above what was allocated when it began)."""
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        start = allocated()
        sk.reset_launch_counts()
        device_loop.HOST_READS.clear()
        with mode(captured):
            t = time.perf_counter()
            res = fn()
            sync()
            sec = time.perf_counter() - t
        return (res, sec, dict(sk.KERNEL_LAUNCHES),
                dict(device_loop.HOST_READS), peak() - gib(start))

    def tidy():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def pool_gib(store):
        """What the graph pools of ``store`` hold: the allocated bytes its
        clearing frees."""
        sync()
        before = allocated()
        store.clear()
        sync()
        return gib(before - allocated())

    def report(label, runs, iters, field_gap, extra=""):
        print(f"graphs {label} ({card_line}): iterations "
              + " / ".join(str(i) for i in iters) + f"; field gap captured "
              f"vs uncaptured {field_gap:.3e} (bound {GRAPH_TOL}); "
              + "; ".join(f"{name} {sec:.3f} s, host reads {reads}, "
                          f"launches {launches}, peak {pk:.3f} GiB"
                          for name, (sec, launches, reads, pk)
                          in runs.items()) + extra, flush=True)
        check(len(set(iters)) == 1, f"graphs {label}: iterations {iters}")
        check(field_gap <= GRAPH_TOL, f"graphs {label}: captured and "
              f"uncaptured fields differ by {field_gap:.3e}")
        out[label] = dict(iterations=iters[0], gap=field_gap, extra=extra,
                          runs={k: dict(zip(("s", "launches", "reads",
                                             "peak_gib"), v))
                                for k, v in runs.items()})

    # -- the flagship's double-float32 rounds ("mixed"): phase 6's dense
    # run's operands (``refs["df2"]``, :func:`grab_df2`) ---------------------
    tidy()
    ref = refs.pop("df2")
    (h, ladder, tol, kw, (hi, lo, it, _), api_s) = ref["df2"]
    launches, wall = ref["launches"], ref["wall"]
    api_reads, api_peak = ref["reads"], ref["peak"]
    del ref
    solve_df2 = mg.solve_fcycle_df2
    pools = pool_gib(h.graphs)

    def df2():
        return solve_df2(h, ladder, tol, **kw)

    runs, xs, iters = {}, {}, [it]
    for name, captured in (("uncaptured", False), ("captured", True),
                           ("replayed", True)):
        (r_hi, r_lo, r_it, _), sec, n, reads, pk = direct(df2, captured)
        runs[name] = (sec, n, reads, pk)
        xs[name] = r_hi.double() + r_lo.double()
        iters.append(r_it)
        check(reads.get("df2", 0) <= 2 + kw.get("max_rounds", 12),
              f"graphs flagship df2 ({name}): host reads {reads}")
    field_gap = max(gap(xs["captured"], xs["uncaptured"]),
                    gap(hi.double() + lo.double(), xs["uncaptured"]))
    report("flagship mixed df2", runs, iters, field_gap,
           f"; phase 6's run through the API (captured, first capture "
           f"included): df2 "
           f"{api_s:.3f} s, wall {wall:.3f} s, host reads {api_reads}, "
           f"launches {launches}, peak {api_peak:.2f} GiB; graph pools of "
           f"the hierarchy {pools:.3f} GiB")
    check(runs["uncaptured"][2] == runs["replayed"][2],
          f"graphs flagship df2: host reads differ: {runs}")
    del h, ladder, hi, lo, xs

    tidy()
    # -- the flagship at "f64": solve_mg ------------------------------------
    h64, b64 = refs.pop("h_f64"), refs.pop("b_f64")
    pools = pool_gib(h64.graphs)
    runs, xs, iters = {}, {}, []
    for name, captured in (("uncaptured", False), ("captured", True),
                           ("replayed", True)):
        (x, k, _), sec, n, reads, pk = direct(
            lambda: mg.solve_mg(h64, b64, None, cfg.tol, cfg.mg_maxiter),
            captured)
        runs[name] = (sec, n, reads, pk)
        xs[name] = x
        iters.append(k)
        check(reads.get("mg_pcg", 0) == max(1, -(-k // mg.PCG_BLOCK)),
              f"graphs f64 ({name}): {reads} host reads for {k} iterations")
    report("flagship f64 solve_mg", runs, iters,
           gap(xs["captured"], xs["uncaptured"]),
           f"; ms an iteration " + " / ".join(
               f"{name} {1e3 * v[0] / max(iters[0], 1):.3f}"
               for name, v in runs.items())
           + f"; the precision phase's captured solve_mg "
           f"{refs.get('solve_mg_s', float('nan')):.3f} s; graph pools "
           f"{pools:.3f} GiB")
    pool_gib(h64.graphs)
    del h64, b64, xs

    tidy()
    # -- the modal 3D tool at the modal phase's size, its subspace
    # iteration cut to MODAL_GRAPH_ITERS both ways (uncaptured, the whole
    # run takes a minute) ---------------------------------------------------
    smallest = api.smallest_modes

    def cut(*a, **kw):
        return smallest(*a, **kw, max_iters=MODAL_GRAPH_ITERS)

    runs, got = {}, {}
    api.smallest_modes = cut
    try:
        for name, captured in (("captured", True), ("uncaptured", False)):
            label = f"graphs modal 3D {name}"
            linsolve._MG_CACHE.clear()
            with disk_cache_off(), mode(captured):
                res, launches, wall = counted(
                    label, lambda: api.solve_elasticity_3D_modal(
                        **modal, data_dir=data_dir))
            got[name] = (res.meta["solver_stats"], field(res)[0],
                         np.asarray(res.meta["frequencies_hz"]))
            runs[name] = (wall, launches, dict(device_loop.HOST_READS),
                          peaks.get(label, float("nan")))
            del res
    finally:
        api.smallest_modes = smallest
        linsolve._MG_CACHE.clear()
    (st, shapes, freqs), (st0, shapes0, freqs0) = got.values()
    report("modal 3D", runs, [st["cg_iterations"], st0["cg_iterations"]],
           max(gap(freqs, freqs0), gap(shapes, shapes0)),
           f" (wall seconds; subspace iterations {st['iterations']} / "
           f"{st0['iterations']}, cut to {MODAL_GRAPH_ITERS})")
    check(st["iterations"] == st0["iterations"] == MODAL_GRAPH_ITERS,
          f"graphs modal 3D: subspace iterations {st['iterations']} / "
          f"{st0['iterations']}")
    del got

    tidy()
    # -- the flagship's projection: flat CG on K1 v1 ------------------------
    cells = (flagship["nx"], flagship["ny"], flagship["nz"])
    mesh = box_mesh(*cells, (0.0, 0.0, 0.0), (flagship["Lx"], flagship["Ly"],
                                              flagship["Lz"]))
    values = np.random.default_rng(14).standard_normal(
        (len(mesh.subelems),) + tuple(mesh.cell_shape))
    cg_calls = []
    cg = linsolve._cg_unit_diag

    def timed_cg(*a, **kw):
        sync()
        t = time.perf_counter()
        res = cg(*a, **kw)
        sync()
        cg_calls.append((res[1], time.perf_counter() - t))
        return res

    linsolve._cg_unit_diag = timed_cg
    runs, xs, iters = {}, {}, []
    try:
        for name, captured in (("uncaptured", False), ("captured", True),
                               ("replayed", True)):
            del cg_calls[:]
            xs[name], sec, n, reads, pk = direct(
                lambda: projection.project_cellwise(mesh, values), captured)
            k = sum(c[0] for c in cg_calls)
            runs[name] = (sum(c[1] for c in cg_calls), n, reads, pk)
            iters.append(k)
            check(reads.get("cg", 0) <= sum(-(-c[0] // linsolve.CG_BLOCK) + 1
                                            for c in cg_calls),
                  f"graphs projection ({name}): host reads {reads}")
    finally:
        linsolve._cg_unit_diag = cg
    report("projection flat CG", runs, iters,
           gap(xs["captured"], xs["uncaptured"]),
           f" (seconds of the CG solves, {len(cg_calls)} a projection)")
    del xs

    tidy()
    # -- the scans: one step program a step, one read a chunk ---------------
    out["scans"] = scans_leg(api, counted, data_dir, card_line,
                             refs.pop("heat"), scans or scan_cases(),
                             device=device, profiled=profiled)

    tidy()
    # -- no fallback: a planted capture fault raises -------------------------
    raised = None
    op = sk.FlatStencilOperator(((-1,), (0,), (1,)),
                                [np.full(4096, w) for w in (-1.0, 2.5, -1.0)],
                                (4096,), device=device)
    orig = sk.FlatStencilOperator.apply_flat

    def syncing(self, x):
        if self is op and cuda:
            torch.cuda.synchronize()
        return orig(self, x)

    sk.FlatStencilOperator.apply_flat = syncing
    b = torch.ones((4096,), device=device)
    try:
        linsolve._cg_unit_diag(((-1,), (0,), (1,)), op, b,
                               torch.zeros_like(b), 1e-6, 100, 1, 1)
    except RuntimeError as e:
        raised = str(e).splitlines()[0]
    finally:
        sk.FlatStencilOperator.apply_flat = orig
    sync()
    print(f"graphs planted capture fault (a device synchronise inside the "
          f"captured CG body): raised {raised!r}", flush=True)
    check(raised is not None or not cuda, "graphs: a capture with a "
          "synchronise inside did not raise")
    check(sk._CAPTURED is None, "graphs: the launch recording was left on")
    out["planted_fault_raised"] = raised
    return out


SCAN_WAVE = dict(WAVE_3D, initial_type="zero", source_value=1.0)
# 114,375 DOF: its finest level (≥ ``multigrid.BF16_MIN_DOF``) smooths
# with the bf16 copy inside the step program
SCAN_DYNAMIC = dict(DYNAMIC_3D, nx=60, ny=24, nz=24, num_steps=24)
SCAN_HEAT_F64 = dict(nx=32, ny=32, nz=32)
# the step programs of these scans are profiled, and the per-step path
# (the busy share they are compared with) of the last: each trace costs a
# repeat of the scan
SCAN_PROFILED = ("heat 3D K1", "heat 3D CS", "dynamic 3D")
SCAN_PROFILE_PER_STEP = ("heat 3D K1",)
SCAN_WAYS = ("program", "per step", "uncaptured")
# the scans called again with the same operator (``scans_leg``'s follow-ups:
# the scan cache keeps their step programs across calls)
REPEAT_LABELS = ("heat 3D K1", "heat 3D CS", "dynamic 3D")
# the MG thresholds lowered: the step solves take MG-PCG under the default
# ``transient_mg_threshold``
SCAN_MG = {"transient_mg_threshold": 100, "mg_threshold": 100}


def scan_cases(heat=HEAT, mixed=MIXED_3D, advection=ADVECTION_3D,
               wave=SCAN_WAVE, dynamic=SCAN_DYNAMIC,
               heat_f64=SCAN_HEAT_F64):
    """The scans of :func:`scans_leg`: (label, ``PDE_TPU_CS``, tool name,
    keyword arguments, config overrides, the kernel variants its step
    programs must launch on the card, steps).  The wave is driven by a
    source from rest (the sine mode's host projection takes ~48 s at 96³);
    the released cantilever runs 24 steps at 60×24×24 with MG-PCG step
    solves, as the flagship's mesh takes them (that mesh sets up in ~25 s
    a run), its first step far longer than the rest; the "f64" heat runs
    at 32³ with MG-PCG step solves (at 128³ its uncaptured scan runs ~1.2M
    aten operations; the precision phase runs it at 128³ through the
    API), whose steps take more than one block."""
    heat_steps = heat.get("num_steps", HEAT_STEPS)
    return [("heat 3D K1", "0", "solve_heat_3D", heat, {},
             ("v1_f32", "v1_bf16"), heat_steps),
            ("heat 3D CS", "1", "solve_heat_3D", heat, {},
             ("cs_apply_v1", "v1_f32"), heat_steps),
            ("mixed 3D", "0", "solve_heat_3D_mixed", mixed, {},
             ("v1_f32", "v1_bf16"), mixed["num_steps"]),
            ("advection 3D", "0", "solve_advection_3D", advection, {},
             ("v1_f32",), advection["num_steps"]),
            ("wave 3D", "0", "solve_wave_3D", wave, {},
             ("v1_f32", "v1_bf16"), wave["num_steps"]),
            ("dynamic 3D", "0", "solve_elasticity_3D_dynamic", dynamic,
             SCAN_MG, ("v3_f32", "v3_bf16"), dynamic["num_steps"]),
            ("heat 3D f64", "0", "solve_heat_3D", heat_f64,
             dict(SCAN_MG, precision="f64"), (),
             heat_f64.get("num_steps", HEAT_STEPS))]


def follow_ups(fn, a, k):
    """A recorded ``run_transient`` / ``run_newmark`` call's follow-ups:
    three with the same operator (heat: a new face temperature, a new
    initial field, both; the released cantilever, whose clamp holds 0 and
    which starts from rest: a new load, a new load and initial velocity, a
    new initial displacement) and one with Δt doubled (another operator).
    Returns [(name, call)], the Δt one last."""
    import inspect

    import numpy as np

    from pde_solver_tpu_torch.ops.bc import DirichletBC

    args = inspect.signature(fn).bind(*a, **k).arguments
    free = np.asarray(args["bc"].free_mask, np.float64)

    def call(**new):
        return lambda: fn(**dict(args, **new))

    def face(value):
        return DirichletBC(free, (1.0 - free) * value)

    if fn.__name__ == "run_transient":
        u0 = np.asarray(args["u0_np"], np.float64)
        ups = [("faces at 10", call(bc=face(10.0))),
               ("initial field x0.5", call(u0_np=0.5 * u0)),
               ("faces at 30, initial field +5",
                call(bc=face(30.0), u0_np=u0 + 5.0))]
    else:
        f, v0 = (np.asarray(args[n], np.float64) for n in ("f_np", "v0_np"))
        ups = [("load x0.5", call(f_np=0.5 * f)),
               ("load x1.5, initial velocity",
                call(f_np=1.5 * f, v0_np=v0 + 1e-3 * free)),
               ("initial displacement", call(u0_np=1e-6 * free))]
    return ups + [("dt x2", call(dt=2.0 * args["dt"]))]


def scan_way(way):
    """The context a scan runs in: its step programs (captured on the
    card), the per-step path, or its step programs uncaptured."""
    from pde_solver_tpu_torch.ops import device_loop

    if way == "per step":
        return device_loop._per_step()
    if way == "uncaptured":
        return device_loop._uncaptured()
    return contextlib.nullcontext()


def scan_busy(run, way, scan_s):
    """A scan's device-busy share: the device time of the kernels that ran
    while its scans (``_transient_scan`` / ``_newmark_scan``) ran, each
    traced alone by torch.profiler (device activity only, so a trace of
    ~10⁵ launches stays cheap to read), over the unprofiled scan seconds
    ``scan_s``.  Copies of ≥ 1 ms (a frame fetch) are left out, as
    ``profile_heat.kernel_table`` leaves them; "not measured" when the
    traces hold no device kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pde_solver_tpu_torch.ops import timestepping

    traces = []
    origs = {name: getattr(timestepping, name)
             for name in ("_transient_scan", "_newmark_scan")}

    def traced(fn):
        def scan(*a, **kw):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                res = fn(*a, **kw)
                torch.cuda.synchronize()
            traces.append(prof)
            return res
        return scan

    for name, fn in origs.items():
        setattr(timestepping, name, traced(fn))
    try:
        with scan_way(way):
            run()
    finally:
        for name, fn in origs.items():
            setattr(timestepping, name, fn)
    kernel_ms, n = 0.0, 0
    for prof in traces:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            ms = e.duration_ns() / 1e6
            if "Memcpy" in e.name() and ms >= 1.0:
                continue
            kernel_ms, n = kernel_ms + ms, n + 1
    if not n:
        return "not measured (no device kernel in the trace)"
    return (f"{kernel_ms / 1e3 / scan_s:.3f} ({kernel_ms:.1f} ms of device "
            f"kernels in {n} launches)")


def record_scans():
    """Keep the call of every ``run_transient`` / ``run_newmark`` (the
    tools' modules import them by name); returns (the list of (function,
    args, kwargs, result), a function that undoes the spies).  The function
    kept is the package's own, under any earlier spy."""
    import inspect

    from pde_solver_tpu_torch.models import advection, heat, wave
    from pde_solver_tpu_torch.ops import timestepping

    calls, undo = [], []
    for module in (timestepping, heat, advection, wave):
        for name in ("run_transient", "run_newmark"):
            fn = getattr(module, name, None)
            if fn is None:
                continue

            def spy(*a, _fn=fn, **kw):
                res = _fn(*a, **kw)
                calls.append((inspect.unwrap(_fn), a, kw, res))
                return res

            setattr(module, name, spy)
            undo.append((module, name, fn))

    def unspy():
        for module, name, fn in undo:
            setattr(module, name, fn)
    return calls, unspy


def repeat_scans(counted, label, cs, fn, a, k, ways, steps, card_line,
                 cuda):
    """The follow-ups of a scans-leg case (:func:`follow_ups` of its
    recorded call ``fn(*a, **k)``, ``PDE_TPU_CS`` = cs), after its three
    ways (the program way its first call, from an empty scan cache): each
    follow-up kept, then the same follow-up cold (the cache emptied
    first).  Returns {follow-up: numbers}."""
    import numpy as np

    from pde_solver_tpu_torch.ops import device_loop, timestepping

    def with_cs(run):
        prev = os.environ.get("PDE_TPU_CS", "0")
        os.environ["PDE_TPU_CS"] = cs
        try:
            return run()
        finally:
            os.environ["PDE_TPU_CS"] = prev

    def fields_of(res):
        return [res.values] + ([res.velocities]
                               if hasattr(res, "velocities") else [])

    first, per = ways["program"], ways["per step"]
    check(first["built"] >= 1, f"scans {label}: the first call built no "
          f"step program: {first}")
    out = {}
    *ups, (dt_name, dt_call) = follow_ups(fn, a, k)
    for name, call in ups:
        kept, launches, wall = counted(f"scans {label} follow-up {name}",
                                       lambda: with_cs(call))
        reads = dict(device_loop.HOST_READS)
        clear_scans()
        cold, _, cold_wall = counted(f"scans {label} follow-up {name} cold",
                                     lambda: with_cs(call))
        gap = max(float(np.abs(f - f0).max() / max(np.abs(f0).max(),
                                                     1e-300))
                  for f, f0 in zip(fields_of(kept), fields_of(cold)))
        row = dict(iterations=kept.total_cg_iterations,
                   cold_iterations=cold.total_cg_iterations, gap=gap,
                   kept=kept.scan_kept, built=kept.scan_programs_built,
                   capture_s=kept.scan_capture_seconds,
                   stepwise=kept.scan_stepwise_chunks, reads=reads,
                   scan_s=kept.scan_seconds, setup_s=kept.setup_seconds,
                   wall=wall, cold_scan_s=cold.scan_seconds,
                   cold_capture_s=cold.scan_capture_seconds,
                   cold_setup_s=cold.setup_seconds, cold_wall=cold_wall,
                   launches=launches)
        out[name] = row
        print(f"scans {label} follow-up {name} ({card_line}): kept "
              f"{row['kept']}, step programs built {row['built']}, capture "
              f"{row['capture_s']:.3f} s, chunks step by step "
              f"{row['stepwise']}, host reads {reads}; iterations "
              f"{row['iterations']} (cold {row['cold_iterations']}); frames "
              f"against the cold call {gap:.3e}; scan {row['scan_s']:.3f} s"
              f" (first call {first['scan_s']:.3f}, cold "
              f"{row['cold_scan_s']:.3f} with capture "
              f"{row['cold_capture_s']:.3f}, per step {per['scan_s']:.3f});"
              f" set-up {row['setup_s']:.3f} s (cold "
              f"{row['cold_setup_s']:.3f}); wall {wall:.3f} s (cold "
              f"{cold_wall:.3f}); launches {launches}", flush=True)
        check(row["kept"] and row["built"] == 0 and row["capture_s"] == 0.0
              and row["stepwise"] == 0, f"scans {label} follow-up {name}: "
              f"not kept: {row}")
        check(reads.get("scan", 0) == len(device_loop.scan_chunks(steps)),
              f"scans {label} follow-up {name}: host reads {reads}")
        check(row["iterations"] == row["cold_iterations"] and gap == 0.0,
              f"scans {label} follow-up {name}: against its cold call: "
              f"iterations {row['iterations']} / {row['cold_iterations']}, "
              f"gap {gap:.3e}")
        del kept, cold
    res, launches, wall = counted(f"scans {label} follow-up {dt_name}",
                                  lambda: with_cs(dt_call))
    print(f"scans {label} follow-up {dt_name} ({card_line}): kept "
          f"{res.scan_kept}, step programs built {res.scan_programs_built}, "
          f"capture {res.scan_capture_seconds:.3f} s, scan "
          f"{res.scan_seconds:.3f} s, iterations {res.total_cg_iterations}, "
          f"launches {launches}", flush=True)
    check(not res.scan_kept and res.scan_programs_built >= 1
          and (res.scan_capture_seconds > 0.0 or not cuda),
          f"scans {label} follow-up {dt_name}: did not build its programs")
    kept_s = [out[name]["scan_s"] for name, _ in ups]
    cold_s = [out[name]["cold_scan_s"] for name, _ in ups]
    print(f"scans {label} follow-ups ({card_line}): scan s kept "
          f"{['%.3f' % t for t in kept_s]} (mean {np.mean(kept_s):.3f}), "
          f"cold {['%.3f' % t for t in cold_s]} (mean {np.mean(cold_s):.3f}),"
          f" first call {first['scan_s']:.3f} (capture "
          f"{first['capture_s']:.3f}), per step {per['scan_s']:.3f}",
          flush=True)
    out[dt_name] = dict(kept=res.scan_kept, built=res.scan_programs_built,
                        capture_s=res.scan_capture_seconds,
                        scan_s=res.scan_seconds)
    return out


def scans_leg(api, counted, data_dir, card_line, heat_ref, cases,
              device="cuda", profiled=True, repeats=REPEAT_LABELS):
    """Each scan of ``cases`` (:func:`scan_cases`) three ways
    (:data:`SCAN_WAYS`): its step programs (the tool through the API, its
    ``run_transient`` / ``run_newmark`` call kept), then that call again
    through the per-step path and through its step programs uncaptured.
    Checks: the same iterations, a field gap of 0 between the ways, the
    reads one a chunk run by a step program (``device_loop.scan_chunks``;
    the chunks run step by step and the reruns counted apart), the kernel variants each scan's step programs
    must launch, and the K1 heat program's run against ``heat_ref``
    (phase 6's).  Prints per way the iterations, host reads, reruns, masked
    iterations past convergence, warm-up and capture seconds, scan
    seconds, the device-busy share (with ``profiled``: the same call again
    under the profiler, the step programs of :data:`SCAN_PROFILED` from an
    empty scan cache as the first call ran, and the per-step path of
    :data:`SCAN_PROFILE_PER_STEP`) and launches.  Each case's first call
    starts from an empty scan cache.  The cases of ``repeats`` are then
    called again (:func:`follow_ups`) with the same operator: each
    follow-up must keep its step programs (no program built, no capture,
    no step solved on its own) and equal a cold call of itself after the
    cache is emptied (iterations, frames bit for bit); its scan seconds are
    printed beside the first call's, the cold call's and the per-step
    path's; the Δt follow-up must miss and build its programs anew.  Then
    a device synchronise planted in a step's body must make the scan
    raise.  Returns the rows by label."""
    import gc

    import numpy as np
    import torch

    from pde_solver_tpu_torch.config import config_overrides
    from pde_solver_tpu_torch.ops import device_loop, timestepping
    from pde_solver_tpu_torch.ops import stencil_kernels as sk

    cuda = device == "cuda"
    rows = {}

    def gap(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))

    def fields_of(res):
        return [res.values] + ([res.velocities]
                               if hasattr(res, "velocities") else [])

    def with_cs(cs, fn):
        prev = os.environ.get("PDE_TPU_CS", "0")
        os.environ["PDE_TPU_CS"] = cs
        try:
            return fn()
        finally:
            os.environ["PDE_TPU_CS"] = prev

    for label, cs, tool, kw, cfg, wanted, steps in cases:
        ways, results = {}, {}
        # the first call from an empty scan cache; the per-step path keeps
        # its operands, the uncaptured programs (another capture mode) are
        # new on the card and the program way's on the CPU
        clear_scans()
        for way in SCAN_WAYS:
            if way == "program":
                calls, unspy = record_scans()
                try:
                    def call():
                        with config_overrides(**cfg):
                            return getattr(api, tool)(**kw,
                                                      data_dir=data_dir)
                    res, launches, wall = counted(
                        f"scans {label} ({way})", lambda: with_cs(cs, call))
                finally:
                    unspy()
                api_field = field(res)[0]
                os.remove(res.data_file)
                (fn, a, k, res), = calls

                def again(fn=fn, a=a, k=k):
                    return with_cs(cs, lambda: fn(*a, **k))
            else:
                with scan_way(way):
                    res, launches, wall = counted(f"scans {label} ({way})",
                                                  again)
            results[way] = res
            ways[way] = dict(
                iterations=res.total_cg_iterations,
                reads=dict(device_loop.HOST_READS), reruns=res.scan_reruns,
                stepwise=res.scan_stepwise_chunks,
                built=res.scan_programs_built,
                past=res.scan_past_iterations,
                capture_s=res.scan_capture_seconds, scan_s=res.scan_seconds,
                wall=wall, launches=launches)
            if profiled and ((way == "program" and label in SCAN_PROFILED)
                             or (way == "per step"
                                 and label in SCAN_PROFILE_PER_STEP)):
                if way == "program":
                    # the trace repeats the first call, from an empty cache
                    clear_scans()
                ways[way]["busy"] = scan_busy(again, way, res.scan_seconds)
        gaps = {way: max(gap(f0, f) for f0, f in
                         zip(fields_of(results["program"]),
                             fields_of(results[way])))
                for way in SCAN_WAYS[1:]}
        prog = ways["program"]
        extra = ""
        if label == "heat 3D K1" and heat_ref is not None:
            gaps["phase 6"] = gap(api_field, heat_ref["T"])
            extra = (f"; phase 6's run: iterations "
                     f"{heat_ref['stats']['cg_iterations']}, scan "
                     f"{heat_ref['stats']['scan_seconds']:.3f} s, reads "
                     f"{heat_ref['reads']}")
            check(heat_ref["stats"]["cg_iterations"] == prog["iterations"],
                  f"scans {label}: iterations {prog['iterations']} against "
                  f"phase 6's {heat_ref['stats']['cg_iterations']}")
        print(f"scans {label} ({card_line}): {steps} steps; field gap "
              + ", ".join(f"vs {k} {v:.3e}" for k, v in gaps.items())
              + "; " + "; ".join(
                  f"{way}: iterations {w['iterations']}, host reads "
                  f"{w['reads']}, reruns {w['reruns']}, chunks step by step "
                  f"{w['stepwise']}, masked iterations "
                  f"past convergence {w['past']}, capture "
                  f"{w['capture_s']:.3f} s, scan {w['scan_s']:.3f} s, wall "
                  f"{w['wall']:.3f} s, busy {w.get('busy', 'not profiled')}"
                  f", launches {w['launches']}"
                  for way, w in ways.items()) + extra, flush=True)
        iters = {w["iterations"] for w in ways.values()}
        check(len(iters) == 1, f"scans {label}: iterations {iters}")
        check(all(g == 0.0 for g in gaps.values()),
              f"scans {label}: field gaps {gaps}")
        for way in ("program", "uncaptured"):
            r = ways[way]["reads"]
            chunks = device_loop.scan_chunks(
                steps, first=way == "program" or cuda)
            check(r.get("scan", 0) == len(chunks) - ways[way]["stepwise"]
                  and r.get("scan_redo", 0) == ways[way]["reruns"],
                  f"scans {label} ({way}): host reads {r} for {steps} "
                  f"steps")
        missing = [v for v in wanted if not prog["launches"].get(v)]
        check(not cuda or not missing, f"scans {label}: the step programs "
              f"launched no {missing}: {prog['launches']}")
        check("scan" not in ways["per step"]["reads"],
              f"scans {label}: the per-step path read as a scan")
        rows[label] = dict(steps=steps, gaps=gaps, ways=ways)
        if label in repeats:
            rows[label]["repeats"] = repeat_scans(
                counted, label, cs, fn, a, k, ways, steps, card_line, cuda)
        del results, api_field
        clear_scans()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    # -- no fallback: a synchronise planted in a step's body raises ---------
    raised = None
    orig = timestepping._transient_step_body

    def syncing(*a, **kw):
        if cuda:
            torch.cuda.synchronize()
        return orig(*a, **kw)

    timestepping._transient_step_body = syncing
    clear_scans()
    try:
        with config_overrides(transient_mg_threshold=100, mg_threshold=100):
            api.solve_heat_3D(**SMALL_HEAT, data_dir=data_dir)
    except RuntimeError as e:
        raised = str(e).splitlines()[0]
    finally:
        timestepping._transient_step_body = orig
    if cuda:
        torch.cuda.synchronize()
    print(f"scans planted capture fault (a device synchronise inside a "
          f"step's body): raised {raised!r}", flush=True)
    check(raised is not None or not cuda, "scans: a step program captured "
          "with a synchronise inside did not raise")
    check(sk._CAPTURED is None, "scans: the launch recording was left on")
    rows["planted_fault_raised"] = raised
    return rows


class JsonRpcPipe:
    """Raw JSON-RPC 2.0 lines to and from a server subprocess.  Every line
    the server writes to stdout must be the JSON-RPC reply to the request
    just sent: a stray print (the port's, a build's, a warning's) fails the
    run, where a client that skips lines that are not JSON would let it
    pass."""

    def __init__(self, cmd, env, cwd, stderr):
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=stderr,
                                     env=env, cwd=cwd)
        self.buf = b""
        self.next_id = 0

    def _line(self, timeout: float) -> bytes:
        import select

        fd = self.proc.stdout.fileno()
        deadline = time.monotonic() + timeout
        while b"\n" not in self.buf:
            left = deadline - time.monotonic()
            check(left > 0, f"the server sent no reply in {timeout:.0f} s")
            ready, _, _ = select.select([fd], [], [], left)
            if ready:
                chunk = os.read(fd, 1 << 20)
                check(chunk != b"", f"the server closed its stdout (exit "
                      f"code {self.proc.poll()})")
                self.buf += chunk
        line, self.buf = self.buf.split(b"\n", 1)
        return line

    def _send(self, msg) -> None:
        self.proc.stdin.write((json.dumps(msg) + "\n").encode())
        self.proc.stdin.flush()

    def request(self, method, params=None, timeout=SERVE_TIMEOUT):
        self.next_id += 1
        msg = {"jsonrpc": "2.0", "id": self.next_id, "method": method}
        if params is not None:
            msg["params"] = params
        self._send(msg)
        raw = self._line(timeout)
        try:
            reply = json.loads(raw)
        except json.JSONDecodeError:
            reply = None
        check(isinstance(reply, dict) and reply.get("jsonrpc") == "2.0"
              and reply.get("id") == self.next_id and "result" in reply,
              f"server stdout line after {method} is not its JSON-RPC "
              f"reply: {raw[:300]!r}")
        return reply["result"]

    def notify(self, method) -> None:
        self._send({"jsonrpc": "2.0", "method": method})

    def call_tool(self, name, arguments, timeout=SERVE_TIMEOUT):
        """tools/call: (decoded payload, wall s); fails on ``isError``."""
        t = time.perf_counter()
        result = self.request("tools/call", {"name": name,
                                             "arguments": arguments}, timeout)
        wall = time.perf_counter() - t
        text = "".join(c.get("text", "") for c in result.get("content", []))
        check(result.get("isError") is False,
              f"tools/call {name} failed: {text[-3000:]}")
        return json.loads(text), wall

    def close(self, timeout: float = 60.0) -> None:
        """End of input: the server must exit 0 and write nothing more."""
        self.proc.stdin.close()
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            check(False, f"the server did not exit in {timeout:.0f} s")
        rest = self.buf + self.proc.stdout.read()
        self.proc.stdout.close()
        check(rest.strip() == b"", f"the server wrote {rest[:300]!r} after "
              "its last reply")
        check(self.proc.returncode == 0,
              f"the server exited with code {self.proc.returncode}")

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def call_launches(lines, tool: str):
    """Seconds and kernel launches of the server's last call of ``tool``,
    from its ``tools/call`` INFO line."""
    import re

    found = [m for m in (re.search(rf"tools/call {tool}: ([0-9.]+) s, "
                                   r"kernel launches (\{.*\})$", line)
                         for line in lines) if m]
    check(bool(found), f"no tools/call line of {tool} in the server log")
    return float(found[-1].group(1)), json.loads(found[-1].group(2))


def read_figure(html_path):
    """The figure JSON of a plot tool's HTML."""
    import re

    with open(html_path, encoding="utf-8") as f:
        html = f.read()
    check("Plotly.newPlot" in html, f"{html_path}: no Plotly.newPlot")
    m = re.search(r"var fig = (\{.*?\});\nvar config", html, re.S)
    check(m is not None, f"{html_path}: no figure JSON")
    return json.loads(m.group(1)), len(html.encode())


TRANSIENT_LINE = (r"transient: (\d+) steps, (\d+) CG iterations, .*setup "
                  r"([0-9.]+)s, scan ([0-9.]+)s, .*step programs: "
                  r"(kept|new), (\d+) built, .*capture ([0-9.]+)s\)")


def service_phase(counted, flagship, vm_ref, ref_iterations, ref_wall,
                  work_dir, wanted=("v3_f32", "v3_bf16", "v1_f32"),
                  device="cuda", server_env=None, examples=None,
                  disk_hits=("prep", "hierarchy"), cold_setup=None,
                  card_line="", heat=HEAT):
    """The system's entry points on the card.  The port's MCP server, started
    as ``python -m pde_solver_tpu_torch.mcp.server`` with no
    ``PDE_TPU_DEVICE`` (the card is its default) and INFO logging to
    ``<work_dir>/server.log``, spoken to in raw JSON-RPC lines: initialize,
    tools/list (the 31 names of the port's ``LocalToolSet``), the flagship
    (``flagship``, the dense route, ``PDE_TPU_CS=0``) held against the
    in-process field ``vm_ref`` of the same solve and its iterations, the
    plot of the served field, ``solve_heat_3D`` (``heat``) twice with
    another face temperature the second time (a user's follow-up: the
    second call must keep the first one's step programs; its wall, scan
    and capture seconds beside the first's, from the reply and the
    server's INFO ``transient:`` lines), a call of an unknown tool
    (``isError``); its stdout must hold the replies and nothing else.  The served flagship is
    a fresh process's first call, answered from the disk cache the
    in-process run stored: its INFO lines must show a disk hit of each
    kind in ``disk_hits``; its set-up seconds are printed beside
    ``cold_setup``, the in-process run's.  Then the nine chat
    examples of ``pde_solver_tpu_torch/app.py`` in process, each through a
    ``MultiAgentOrchestrator(llm=None, memory_file=None)`` on the port's
    ``LocalToolSet``, each a main path of its own (``counted(label, fn)`` →
    (result, launches, wall s)).  Returns the server's launches (the
    flagship's and the two heat calls').
    A CPU rehearsal passes ``server_env`` (``PDE_TPU_DEVICE=cpu``), a small
    ``flagship`` with its own reference, ``wanted=()`` and ``device="cpu"``
    (the examples then run under ``config_overrides(device="cpu")``)."""
    import asyncio
    import contextlib

    import numpy as np

    from pde_solver_tpu_torch import app, config
    from pde_solver_tpu_torch.agents.dispatcher_agent import LocalToolSet
    from pde_solver_tpu_torch.agents.orchestrator import \
        MultiAgentOrchestrator
    from pde_solver_tpu_torch.fields import load_field

    os.makedirs(work_dir, exist_ok=True)
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PDE_TPU_DEVICE", "OPENAI_API_KEY")}
    env.update(PDE_TPU_LOG_LEVEL="INFO", PDE_TPU_CS="0", **(server_env or {}))
    names = asyncio.run(LocalToolSet().tool_names())
    log_path = os.path.join(work_dir, "server.log")
    t0 = time.perf_counter()
    with open(log_path, "wb") as log:
        pipe = JsonRpcPipe([sys.executable, *SERVER_CMD], env, root, log)
        try:
            init = pipe.request("initialize", {
                "protocolVersion": "2024-11-05", "capabilities": {},
                "clientInfo": {"name": "chip_smoke", "version": "0"}})
            start_s = time.perf_counter() - t0
            pipe.notify("notifications/initialized")
            tools = [t["name"] for t in pipe.request("tools/list")["tools"]]
            print(f"service: server {init['serverInfo']} up in {start_s:.3f} "
                  f"s; tools/list {len(tools)} tools", flush=True)
            check(len(tools) == 31 and sorted(tools) == sorted(names),
                  f"tools/list {tools} is not the LocalToolSet's {names}")

            payload, wall = pipe.call_tool(
                "solve_elasticity_3D_static",
                dict(flagship, data_dir=os.path.join(work_dir, "data")))
            with open(log_path, encoding="utf-8", errors="replace") as f:
                lines = f.read().splitlines()
            server_s, launches = call_launches(lines,
                                               "solve_elasticity_3D_static")
            for line in lines:
                if any(w in line for w in ("hierarchy", "df2 round", "prep",
                                           "elasticity solve", "tools/call")):
                    print(f"  server: {line}", flush=True)
            st = payload["meta"]["solver_stats"]
            events = disk_events(lines, st["num_dofs"])
            warm = dict(setup_seconds(lines, st["num_dofs"]),
                        postprocess=st["postprocess_seconds"])
            print(f"service flagship set-up ({card_line}), served from the "
                  f"disk cache: " + " ".join(f"{k}={v:.3f}"
                                             for k, v in warm.items())
                  + " s; " + "; ".join(f"{kind} {ev} {sec:.3f} s {b} bytes"
                                       for (kind, ev), (sec, b)
                                       in sorted(events.items()))
                  + "; cold in process: " + " ".join(
                      f"{k}={v:.3f}" for k, v in (cold_setup or {}).items()
                      if not isinstance(v, tuple)), flush=True)
            for kind in disk_hits:
                check((kind, "hit") in events, f"the served flagship's "
                      f"{kind} was not a disk-cache hit: {events}")
            check(not any(ev == "store" for _, ev in events),
                  f"the served flagship stored entries: {events}")
            vm = load_field(payload["data_file"]).values_array()
            gap = float(np.abs(vm - vm_ref).max() / np.abs(vm_ref).max())
            print(f"service flagship: served {wall:.3f} s wall ({server_s:.3f}"
                  f" s in the server's tool call) vs {ref_wall:.3f} s in "
                  f"process; iterations {st['cg_iterations']} ({ref_iterations}"
                  f" in process); relres {st['relative_residual']:.3e}; max|Δvm|"
                  f"/max|vm| against the in-process field {gap:.3e}; "
                  f"launches {launches}", flush=True)
            check(st["converged"] is True, f"served flagship: {st}")
            check(type(st["cg_iterations"]) is int
                  and st["cg_iterations"] == ref_iterations,
                  f"served flagship took {st['cg_iterations']} iterations, "
                  f"{ref_iterations} in process")
            check(vm.shape == vm_ref.shape and bool(np.all(np.isfinite(vm))),
                  f"served field {vm.shape}")
            check(gap <= SERVED_TOL, f"served flagship off the in-process "
                  f"field by {gap:.3e}")
            for name in wanted:
                check(launches.get(name, 0) > 0,
                      f"the served flagship launched no {name}")

            plot, plot_s = pipe.call_tool(
                "plot_time_series_field_from_file",
                {"data_file": payload["data_file"],
                 "output_dir": os.path.join(work_dir, "plots")})
            fig, size = read_figure(plot["html_path"])
            print(f"service plot: {plot_s:.3f} s, {size} bytes, "
                  f"{fig['data'][0]['type']} of {len(fig['data'][0]['x'])} "
                  f"points ({plot['html_path']})", flush=True)
            check(fig["data"][0]["type"] == "volume"
                  and len(fig["frames"]) == 1, "served plot: not the "
                  "flagship's volume")

            # a follow-up in the same server: the scan cache keeps the
            # first call's operands, hierarchy and step programs
            calls = []
            for t_b in (0.0, 25.0):
                heat_out, heat_wall = pipe.call_tool(
                    "solve_heat_3D", dict(heat, T_boundary=t_b,
                                          data_dir=os.path.join(work_dir,
                                                                "data")))
                with open(log_path, encoding="utf-8",
                          errors="replace") as f:
                    lines = f.read().splitlines()
                heat_s, heat_launches = call_launches(lines, "solve_heat_3D")
                scans = [m for m in (re.search(TRANSIENT_LINE, x)
                                     for x in lines) if m]
                check(len(scans) == len(calls) + 1, f"served heat: "
                      f"{len(scans)} transient lines after {len(calls) + 1}"
                      f" call(s)")
                m = scans[-1]
                hst = heat_out["meta"]["solver_stats"]
                calls.append(dict(
                    T_boundary=t_b, wall=heat_wall, server_s=heat_s,
                    iterations=int(m.group(2)), setup_s=float(m.group(3)),
                    scan_s=float(m.group(4)), kept=m.group(5) == "kept",
                    built=int(m.group(6)), capture_s=float(m.group(7)),
                    converged=hst["converged"], launches=heat_launches))
                check(hst["converged"] is True
                      and abs(hst["scan_seconds"] - float(m.group(4)))
                      <= 1e-3, f"served heat: {hst} against {m.group(0)}")
                for kk, v in heat_launches.items():
                    launches[kk] = launches.get(kk, 0) + v
            first_h, second_h = calls
            print(f"service heat 3D follow-up ({card_line}): "
                  + "; ".join(
                      f"{name} (faces at {c['T_boundary']:g}): wall "
                      f"{c['wall']:.3f} s ({c['server_s']:.3f} s in the "
                      f"server's tool call), set-up {c['setup_s']:.3f} s, "
                      f"scan {c['scan_s']:.3f} s, capture "
                      f"{c['capture_s']:.3f} s, step programs "
                      f"{'kept' if c['kept'] else 'new'} ({c['built']} "
                      f"built), iterations {c['iterations']}, launches "
                      f"{c['launches']}"
                      for name, c in (("first call", first_h),
                                      ("second call", second_h))),
                  flush=True)
            check(not first_h["kept"] and first_h["built"] >= 1,
                  f"served heat: the first call kept programs: {first_h}")
            check(second_h["kept"] and second_h["built"] == 0
                  and second_h["capture_s"] == 0.0, f"served heat: the "
                  f"follow-up did not keep its programs: {second_h}")
            bad = pipe.request("tools/call", {"name": "does_not_exist",
                                              "arguments": {}})
            check(bad.get("isError") is True, f"unknown tool: {bad}")
            pipe.close()
        finally:
            pipe.kill()
    print(f"service server: {time.perf_counter() - t0:.3f} s from start to "
          f"exit; every stdout line a JSON-RPC reply", flush=True)

    class Recorded(LocalToolSet):
        """The port's LocalToolSet, recording the tools called."""

        def __init__(self):
            super().__init__()
            self.called = []

        async def call(self, name, args):
            self.called.append(name)
            return await super().call(name, args)

    os.environ.pop("OPENAI_API_KEY", None)
    check(config.get_config().device == device,
          f"the examples run on {config.get_config().device}, not {device}")
    with contextlib.chdir(work_dir):
        for i, q in enumerate(examples or app.EXAMPLES):
            toolset = Recorded()
            orch = MultiAgentOrchestrator(llm=None, memory_file=None,
                                          toolset=toolset)
            res, ex_launches, wall = counted(
                f"example {i + 1}", lambda: asyncio.run(orch.solve(q)))
            check("error" not in res and res.get("data_file")
                  and res.get("html_path"), f"example {i + 1} ({q}): "
                  f"{res.get('error') or res}")
            check(os.path.exists(res["data_file"])
                  and os.path.exists(res["html_path"]),
                  f"example {i + 1}: no artifacts")
            values = load_field(res["data_file"]).values_array()
            st = res["dispatch_result"]["solver_result"]["meta"]["solver_stats"]
            print(f"example {i + 1}: {toolset.called[0]} dof="
                  f"{st.get('num_dofs')} nodes={values.shape[-1]} "
                  f"frames={values.shape[0]} {wall:.3f} s iterations="
                  f"{st.get('cg_iterations')} launches={ex_launches} "
                  f"plot={os.path.basename(res['html_path'])}", flush=True)
            check(bool(np.all(np.isfinite(values))),
                  f"example {i + 1}: non-finite values")
            check(toolset.called[-1] == "plot_time_series_field_from_file",
                  f"example {i + 1}: tools {toolset.called}")
    return launches


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
        self.walls = {}
        self.reads = {}
        self.peaks = {}

    def counted(self, label, cs, fn):
        """fn() with ``PDE_TPU_CS`` = cs: (result, launches, wall s); the
        solve loops' host reads of the run are left in
        ``device_loop.HOST_READS``."""
        import torch

        from pde_solver_tpu_torch.ops import device_loop

        os.environ["PDE_TPU_CS"] = cs
        del self.built[:]
        self.launched.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.sk.reset_launch_counts()
        device_loop.HOST_READS.clear()
        start = torch.cuda.memory_allocated()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(self.sk.KERNEL_LAUNCHES)
        os.environ["PDE_TPU_CS"] = "0"
        for k, v in launches.items():
            self.main_launches[k] = self.main_launches.get(k, 0) + v
        self.path_launches[label] = launches
        self.walls[label] = wall
        self.reads[label] = dict(device_loop.HOST_READS)
        # the run's own peak: above what was allocated when it began
        self.peaks[label] = peak_gib() - start / 2 ** 30
        return res, launches, wall

    def reads_of(self, label):
        return self.reads.get(label, {})

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
              f"launches={launches} host_reads={self.reads_of(label)}",
              flush=True)
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
    # start cold, as a user's first call does: the run's own cache
    # directory, emptied, and a bound that evicts none of its entries
    cache_dir = os.path.join(root, CACHE_DIR)
    shutil.rmtree(cache_dir, ignore_errors=True)
    os.makedirs(cache_dir)
    os.environ["PDE_TPU_CACHE_DIR"] = cache_dir
    os.environ["PDE_TPU_CACHE_MAX_GB"] = str(CACHE_MAX_GB)
    os.environ.pop("PDE_TPU_DISK_CACHE", None)
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
    print(f"disk cache: {cache_dir} emptied, "
          f"{shutil.disk_usage(cache_dir).free} bytes free there, "
          f"PDE_TPU_CACHE_MAX_GB={CACHE_MAX_GB}", flush=True)
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
    refs = {}     # the captured runs the graphs phase holds uncaptured ones to
    vm_calls, unspy_vm = spy_von_mises()
    for cs in ("0", "1", "hybrid"):
        del vm_calls[:]
        df2 = []

        def solve_flagship():
            res, grabbed = grab_df2(lambda: api.solve_elasticity_3D_static(
                **FLAGSHIP, data_dir=data_dir))
            if cs == "0":
                df2.append(grabbed)
            return res

        with config_overrides(device="cuda"), solver_log() as log:
            res, st, launches, cs_built = main_path(
                f"flagship PDE_TPU_CS={cs}", cs, solve_flagship)
        label = f"flagship PDE_TPU_CS={cs}"
        if df2:
            refs["df2"] = dict(df2=df2[0], launches=launches,
                               wall=paths.walls[label],
                               reads=paths.reads_of(label),
                               peak=paths.peaks[label])
        del df2
        vm = field(res)[0]
        vm_runs[cs] = vm
        if cs == "0":
            # the cold call: it stores the prep and hierarchy entries
            cold = dict(setup_seconds(log, FLAGSHIP_DOF),
                        postprocess=st["postprocess_seconds"])
            events = disk_events(log, FLAGSHIP_DOF)
            print(f"flagship disk cache, cold ({card_line}): set-up "
                  + " ".join(f"{k}={v:.3f}" for k, v in cold.items())
                  + " s; " + "; ".join(f"{kind} {ev} {sec:.3f} s {b} bytes"
                                       for (kind, ev), (sec, b)
                                       in sorted(events.items()))
                  + f"; directory {cache_listing(cache_dir)}", flush=True)
            check(set(events) == {("prep", "store"), ("hierarchy", "store")},
                  f"the cold flagship's disk-cache events: {events}")
            cold.update({f"{kind}_{ev}": v
                         for (kind, ev), v in events.items()})
            served_ref = (vm, st["cg_iterations"],
                          paths.walls[f"flagship PDE_TPU_CS={cs}"], cold)
            (vm_call,) = vm_calls
            device_vm = device_von_mises_phase(vm_call, card_line)
        print(f"flagship PDE_TPU_CS={cs}: max_von_mises="
              f"{np.abs(vm).max():.6e} Pa", flush=True)
        check(st["num_dofs"] == FLAGSHIP_DOF, f"dof count {st['num_dofs']}")
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
    unspy_vm()
    del vm_calls
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
        if cs == "0":
            # the graphs phase holds this run against the same uncaptured
            refs["heat"] = dict(T=T, stats=st, launches=launches,
                                reads=dict(paths.reads_of(
                                    f"heat PDE_TPU_CS={cs}")),
                                peak=paths.peaks[f"heat PDE_TPU_CS={cs}"])
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
        share_f32 = newmark_phase(api, main_path, hold_cs, data_dir)
        print(f"phase newmark: {time.perf_counter() - t0:.3f} s", flush=True)
        t0 = time.perf_counter()
        modal_phase(api, drive, data_dir)
        print(f"phase modal: {time.perf_counter() - t0:.3f} s", flush=True)

        # -- the precision scheme: float64, float32, checkpoints, smoother --
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        precision = precision_phase(
            api, lambda label, fn: paths.counted(label, "0", fn), data_dir,
            served_ref[0], vm_call, T_runs["0"], T_host, share_f32,
            refs=refs)
        del T_runs, T_host, vm_call
        print(f"phase precision: {time.perf_counter() - t0:.3f} s; "
              + json.dumps(precision), flush=True)

        # -- the solve loops captured against uncaptured ------------------
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        graphs = graphs_phase(
            api, lambda label, fn: paths.counted(label, "0", fn), data_dir,
            card_line, refs, paths.peaks)
        print(f"phase graphs: {time.perf_counter() - t0:.3f} s; "
              + json.dumps(graphs, default=str), flush=True)

        # -- the sharding layer: the dry-run legs, the flagship on 4 shards -
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        sharded = shard_phase(
            api, lambda label, fn: paths.counted(label, "0", fn), data_dir,
            refs["u_f64"], refs["iters_f64"], served_ref[0], card_line, root)
        del refs
        print(f"phase shard: {time.perf_counter() - t0:.3f} s; "
              + json.dumps(sharded), flush=True)

    # -- the service layer: MCP server, plot, chat examples ------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    served = service_phase(
        lambda label, fn: paths.counted(label, "0", fn), FLAGSHIP,
        *served_ref[:3], os.path.join(root, "build", "service"),
        cold_setup=served_ref[3], card_line=card_line)
    del served_ref
    paths.path_launches["service (server process)"] = served
    for k, v in served.items():
        paths.main_launches[k] = paths.main_launches.get(k, 0) + v
    print(f"phase service: {time.perf_counter() - t0:.3f} s", flush=True)

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
    print(f"disk cache at the end: {cache_listing(cache_dir)}; device von "
          f"Mises {json.dumps(device_vm)}", flush=True)
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
