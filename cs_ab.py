#!/usr/bin/env python3
"""A/B timing of the fused constant-interior ("CS") stencil kernel on one GPU.

    python3 cs_ab.py [--ref PATH]

On the main paths' fine-level CS operators (the heat slice's scaled
backward-Euler operator at 129³ nodes, v = 1; the flagship's scaled
elasticity operator at 161×65×65, v = 3) it times, by profiler device ms
over 50 launches each:

- the kernel of ``pde_solver_tpu_torch/csrc/cs_stencil.cu``, with its
  window residuals and without (the scalar sets alone), each first held
  against its plain version (bit-equal up to the sign of zero);
- with ``--ref PATH``, another ``cs_stencil.cu`` of the same C interface
  (an earlier version), to compare within one run;
- the kernel in variants that each take one part away or change one
  choice (``VARIANTS``: the node mapping alone, the near-boundary threads
  alone, ``fmaf``, no x loads, every row group reading the same x row, ≥ 16
  blocks an SM, no y stores); they compute other functions and are only
  timed.  A variant is a text patch of the source: one whose text the
  source no longer holds is reported and skipped;
- a device-to-device copy of x into y, the floor of any kernel that reads
  x and writes y once.

Launches run back to back, so x and y (21 / 26 MB with the residual
weights) stay in the 50 MB L2.  Prints one line per kernel and operator:
device ms, the bound (bytes of x and y once over 3.35 TB/s, a bound only
with L2 cold) and their ratio.  Needs a CUDA card and nvcc; builds under
``build/cs_ab``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

import chip_smoke as cs

# (label, [(text in the source, its replacement)])
VARIANTS = (
    ("node mapping alone",
     [("    near_node<VDIM, NOFF>(p, x, y, cls, slots, R);", "    (void)cls;")]),
    ("near-boundary threads alone",
     [("    node_thread<VDIM, NOFF>(p, x, y, slots, R);", "    (void)0;")]),
    ("fmaf", [("acc[a] = __fadd_rn(acc[a], __fmul_rn(w, xv[b][s]));",
               "acc[a] = fmaf(w, xv[b][s], acc[a]);"),
              ("acc[a] = __fadd_rn(\n            acc[a], __fmul_rn(weight("
               "(o * VDIM + b) * VDIM + a), xs[o][b]));",
               "acc[a] = fmaf(weight((o * VDIM + b) * VDIM + a), xs[o][b], "
               "acc[a]);")]),
    ("no x loads", [("    span<kSize, 1, INTERIOR>(x, nullptr, 0, p.N, b, "
                     "n + p.base[G], xv[b]);",
                     "    for (int q = 0; q < kSize; ++q) xv[b][q] = "
                     "__int_as_float(0x3f800000 + n + q + b);")]),
    ("one x row", [("p.N, b, n + p.base[G], xv[b]);",
                    "p.N, b, n + G, xv[b]);")]),
    (">= 16 blocks an SM", [("__launch_bounds__(kThreads, 6)",
                             "__launch_bounds__(kThreads, 16)")]),
    ("no y stores", [("  if ((INTERIOR || n < p.N) && i1 >= 2 && i1 < p.n1 - 2 "
                      "&& i2 >= 2 &&\n      i2 < p.n2 - 2) {",
                      "  if (acc[0] == 1.2345e30f) {")]),
)


def build_variants(path: str, variants, out_dir: str, prefix: str):
    """Every variant of a source, one nvcc each, all started together;
    returns [(label, so path, nvcc process)]."""
    from pde_solver_tpu_torch.ops import cuda_build

    src = open(path).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for i, (label, patches) in enumerate(variants):
        missing = [old for old, _ in patches if old not in src]
        if missing:
            print(f"  {prefix} {label}: skipped, {missing[0]!r} is not in "
                  f"{path}", flush=True)
            continue
        text = src
        for old, new in patches:
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{prefix}_{i}.cu")
        so = os.path.join(out_dir, f"{prefix}_{i}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs.append((label, so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
             f"-I{cuda_build.CSRC}", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def finish(procs, prefix: str):
    """Waits for build_variants' nvcc processes; returns [(label, CDLL)]."""
    libs = []
    for label, so, proc in procs:
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc {prefix} {label}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {prefix} {label} ptxas: {line.strip()}", flush=True)
        libs.append((label, ctypes.CDLL(so)))
    return libs


def fused_with(ck, lib, op, windows=True):
    """A launch of op through a variant library of the fused source."""
    import torch

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cs_stencil_params_size.restype = i
    lib.cs_stencil_prepare.argtypes = [p, i, ll, p, i, i, i, p, p, i, p, i]
    lib.cs_stencil_prepare.restype = i
    lib.cs_stencil_apply.argtypes = [p, p, p, p, p, p, p]
    lib.cs_stencil_apply.restype = i
    saved, ck._LIB, op._params = ck._LIB, lib, None
    try:
        op.kernel_params()
    finally:
        ck._LIB = saved
    params, op._params = op._params, None

    def run(x):
        y = torch.empty_like(x)
        rc = lib.cs_stencil_apply(
            params, x.data_ptr(), y.data_ptr(), op.cls_terms.data_ptr(),
            op.slots.data_ptr() if windows else None, op.Wwin.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"variant launch: CUDA error {rc}")
        return y
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref", help="another cs_stencil.cu of the same C "
                    "interface, timed beside this one")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("cs_ab: no CUDA card", file=sys.stderr)
        return 2
    from pde_solver_tpu_torch.ops import cs_kernels as ck
    from pde_solver_tpu_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out_dir = os.path.join(root, "build", "cs_ab")
    procs_f = build_variants(str(cuda_build.CSRC / "cs_stencil.cu"),
                             VARIANTS, out_dir, "fused")
    procs_r = build_variants(args.ref, (("reference", []),), out_dir, "ref") \
        if args.ref else []
    ck.build_library()
    for line in str(cuda_build.BUILD_INFO["cs_stencil"]["log"]).splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print(f"  fused ptxas: {line.strip()}", flush=True)
    variants = finish(procs_r, "ref") + finish(procs_f, "fused")
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for label, vdim, make in (
            ("heat 129^3", 1, lambda: cs.heat_operator((128, 128, 128))),
            ("flagship elasticity 161x65x65", 3, cs.elasticity_operator)):
        mesh, sysm = make()
        op = ck.CSFlatStencilOperator.try_build(
            sysm.offsets, sysm.weights, mesh.node_shape, vdim=vdim,
            device="cuda")
        cs.check(op is not None, f"{label}: CS build refused")
        x = torch.randn((vdim, op.N), generator=gen, device="cuda")
        y_main_plain = ck.cs_main_plain(op, x)
        y_plain = ck.cs_apply_plain(op, x)
        io_bytes = 2 * vdim * op.N * 4
        bnd = cs.bound(io_bytes, 0.0)[0]

        def line(name, ms):
            print(f"{label} {name}: device_ms={ms:.4f} bound_ms={bnd:.4f} "
                  f"(x, y once over HBM; L2 warm, so not a bound) "
                  f"ratio={bnd / ms:.3f}", flush=True)

        y_sets, y = op.launch(x, windows=False), op.launch(x)
        print(f"{label} vs plain: max|Δ| sets alone "
              f"{float((y_sets - y_main_plain).abs().max()):.3e}, with "
              f"windows {float((y - y_plain).abs().max()):.3e}", flush=True)
        cs.check(torch.equal(y_sets, y_main_plain), f"{label}: sets vs plain")
        cs.check(torch.equal(y, y_plain), f"{label}: kernel vs plain")
        line("fused, sets alone", cs.device_ms(
            lambda: op.launch(x, windows=False), "cs_apply_kernel"))
        line("fused", cs.device_ms(lambda: op.launch(x), "cs_apply_kernel"))
        for name, lib in variants:
            run = fused_with(ck, lib, op)
            line(f"fused, {name}", cs.device_ms(lambda: run(x),
                                               "cs_apply_kernel"))
        y_copy = torch.empty_like(x)
        line("copy x to y", cs.device_ms(lambda: y_copy.copy_(x),
                                         "Memcpy DtoD"))
        del op, x, y, y_sets, y_plain, y_main_plain, mesh, sysm
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
