#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pde_solver_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Asserts a CUDA card and prints its name and power limit (nvidia-smi).
2. Builds the flat-stencil SpMV kernel from ``pde_solver_tpu_torch/csrc``
   with nvcc for sm_90a and prints the build seconds and ptxas report.
3. Holds the kernel against its plain PyTorch version on the card at the
   flagship fine level (161×65×65 nodes) and a small level (21×9×9), for
   vdim=3 f32, vdim=3 bf16 and vdim=1 f32 weights (relative max error
   ≤ 1e-5), and times both (CUDA events, ms per apply).
4. Checks the solve path on a small cantilever against the host sparse-LU
   solve (von Mises within 1e-6 of its max).
5. Drives the flagship through the public API — 3D static elasticity of a
   1 m × 0.2 m × 0.2 m cantilever under gravity on 160×64×64 cells
   (2,040,675 DOF) — and checks convergence (relres ≤ 1e-6), a finite
   field of the expected shape, and that all three kernel variants were
   launched by that run.

Fails loudly at the first failed check (non-zero exit, no result line).
Prints, before the last line, the card line and a JSON line with each
kernel variant's launches, error and times; the last line is
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
KERNEL_SOURCE = "pde_solver_tpu_torch/csrc/flat_stencil_spmv.cu"
REPLACES = "pde_solver_tpu/ops/pallas_kernels.py:123"
VARIANTS = (("v3_f32", 3, "float32"), ("v3_bf16", 3, "bfloat16"),
            ("v1_f32", 1, "float32"))
SHAPES = ((161, 65, 65), (21, 9, 9))   # flagship fine level, a small level
REL_TOL = 1e-5


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


def kernel_phase(sk, offsets):
    """Kernel against plain on the card; returns per-variant results."""
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
            # plain, kernel, kernel, plain — both orders on one card
            p1 = time_ms(lambda: sk.spmv_plain(op.W, x, op.deltas, vdim), 10)
            k1 = time_ms(lambda: op.apply_flat(x), 50)
            k2 = time_ms(lambda: op.apply_flat(x), 50)
            p2 = time_ms(lambda: sk.spmv_plain(op.W, x, op.deltas, vdim), 10)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            w_bytes = op.W.numel() * op.W.element_size()
            print(f"kernel {name} nodes={shape} N={N}: rel_err={rel:.3e} "
                  f"abs_err={err:.3e} ms={ms:.4f} ({k1:.4f}, {k2:.4f}) "
                  f"plain_ms={plain_ms:.4f} ({p1:.4f}, {p2:.4f}) "
                  f"W={w_bytes / 1e6:.1f} MB -> {w_bytes / ms / 1e6:.1f} GB/s",
                  flush=True)
            if shape == SHAPES[0]:
                res.update(ms=ms, plain_ms=plain_ms)
            del W, op, x, y, y_plain
        results[name] = res
    return results


def field_values(result):
    import numpy as np

    from pde_solver_tpu_torch.fields import load_field

    return np.asarray(load_field(result.data_file).values, dtype=np.float64)


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np

    # the solver logs its hierarchy / ladder / df2-round seconds to stderr
    os.environ.setdefault("PDE_TPU_LOG_LEVEL", "INFO")
    from pde_solver_tpu_torch import api
    from pde_solver_tpu_torch.config import config_overrides
    from pde_solver_tpu_torch.mesh import box_mesh
    from pde_solver_tpu_torch.ops import assembly
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

    root = os.path.dirname(os.path.abspath(__file__))
    data_dir = os.path.join(root, "build", "chip_smoke")

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    sk.build_library()
    print(f"phase build: {time.perf_counter() - t0:.3f} s "
          f"({sk.BUILD_INFO['path']})", flush=True)
    for line in str(sk.BUILD_INFO.get("log", "")).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    # -- kernel against plain ---------------------------------------------
    t0 = time.perf_counter()
    tiny = box_mesh(2, 2, 2, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    offsets = tuple(sorted(assembly.assemble_elasticity_stencil(tiny, 1.0, 1.0)))
    check(len(offsets) == 15, f"expected 15 stencil offsets, got {len(offsets)}")
    kernels = kernel_phase(sk, offsets)
    torch.cuda.empty_cache()
    print(f"phase kernels: {time.perf_counter() - t0:.3f} s", flush=True)

    # -- small cantilever against the host sparse-LU solve -----------------
    t0 = time.perf_counter()
    with config_overrides(device="cuda", precision="mixed",
                          host_direct_threshold=0, mg_threshold=100):
        r_dev = api.solve_elasticity_3D_static(**SMALL, data_dir=data_dir)
    with config_overrides(device="cpu", host_direct_threshold=10 ** 9):
        r_lu = api.solve_elasticity_3D_static(**SMALL, data_dir=data_dir)
    vm_dev, vm_lu = field_values(r_dev), field_values(r_lu)
    gap = float(np.abs(vm_dev - vm_lu).max() / np.abs(vm_lu).max())
    st = r_dev.meta["solver_stats"]
    print(f"phase small-check: {time.perf_counter() - t0:.3f} s; 16x8x8 "
          f"cantilever on the card vs host sparse LU: max|Δvm|/max|vm|="
          f"{gap:.3e}, iterations={st['cg_iterations']}, "
          f"relres={st['relative_residual']:.3e}", flush=True)
    check(st["converged"], f"small cantilever did not converge: {st}")
    check(gap <= 1e-6, f"small cantilever von Mises off by {gap:.3e}")

    # -- the flagship through the API --------------------------------------
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    with config_overrides(device="cuda"):
        res = api.solve_elasticity_3D_static(**FLAGSHIP, data_dir=data_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sk.KERNEL_LAUNCHES)
    st = res.meta["solver_stats"]
    vm = field_values(res)
    n_nodes = 161 * 65 * 65
    print(f"phase flagship: {wall:.3f} s wall; "
          + " ".join(f"{k}={v:.3f}" for k, v in st.items()
                     if k.endswith("_seconds")), flush=True)
    print(f"flagship: dof={st['num_dofs']} iterations={st['cg_iterations']} "
          f"relres={st['relative_residual']:.3e} converged={st['converged']} "
          f"max_von_mises={np.abs(vm).max():.6e} Pa "
          f"peak_device_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"launches={launches}", flush=True)
    check(st["num_dofs"] == 2_040_675, f"dof count {st['num_dofs']}")
    check(bool(st["converged"]), f"flagship did not converge: {st}")
    check(st["relative_residual"] <= 1e-6,
          f"flagship relres {st['relative_residual']:.3e} > 1e-6")
    check(vm.shape == (1, n_nodes), f"field shape {vm.shape}")
    check(bool(np.all(np.isfinite(vm))), "non-finite von Mises values")
    for name, _, _ in VARIANTS:
        check(launches.get(name, 0) > 0,
              f"the flagship launched no {name} kernel")

    print(f"total: {time.perf_counter() - t_start:.3f} s", flush=True)
    print(card_line)
    print(json.dumps({"kernels": [
        {"name": f"flat_stencil_spmv[{name}]", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": REPLACES,
         "launches": launches.get(name, 0),
         "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"]}
        for name, _, _ in VARIANTS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
