#!/usr/bin/env python3
"""A/B timing of the floor probes P2 (shifts), P3 (residentw) and P4 (csz)
on one GPU.

    git show <commit>:pde_solver_tpu_torch/csrc/floor_probes.cu > build/floor_probes_ref.cu
    python3 floor_ab.py [--ref build/floor_probes_ref.cu [--ref-probes shifts]]
                        [--probes shifts ...]

On the flagship's scaled fine-level elasticity operator (161×65×65, v = 3)
and the heat slice's (129³, v = 1) it times, by profiler device ms over 50
launches each, with the L2 warm (launches back to back) and emptied (128 MB
written between launches):

- the probes of ``pde_solver_tpu_torch/csrc/floor_probes.cu``, each first
  held against its plain version (relative max error ≤ 1e-5);
- with ``--ref PATH``, another ``floor_probes.cu``, held against plain the
  same way, for the probes (``--ref-probes``, all three by default) that
  it gives the C interface of the probes before launch plans (no plan
  arguments: the kernels of the commit that added them; a later source
  kept it for shifts alone until shifts took a plan too);
- variants of either source (``NEW_VARIANTS``, ``REF_VARIANTS``) that each
  take one part away or change one choice; they may compute other
  functions and are only timed.  A variant is a text patch of the source
  (``stencil_span.cuh`` inlined first): one whose text the source no
  longer holds is reported and skipped, one whose text an earlier variant
  has shares its build.  Variants of the plan-taking source that change
  its launch geometry set the matching constants of
  ``ops/floor_probes.py`` while they run.  The shifts variants take apart
  its staged runs (v2, v3); at v1 shifts reads x through L1 and they run
  its unchanged span path.

``--probes`` times only the named probes (and the variants of those).

Prints the card, each build's ptxas lines (registers, spills, shared
memory) and SASS instruction count per kernel (``cuobjdump -sass``), and
one line per probe, operator and source: device ms warm and emptied, the
bound (chip_smoke.probe_bytes_flops over the card's peaks) and the share,
and for shifts the grid of its plan.  Needs a CUDA card and nvcc; builds
under ``build/floor_ab``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

import chip_smoke as cs

# parts of shifts taken away: the staging of windows (thread 0 still
# arrives on each window's mbarrier, announcing no bytes, so the runs find
# every window "full"), the waits for them, the loads from shared memory
# (values made in registers), the FMAs (one XOR a loaded value), the whole
# sum
_NO_COPIES = (
    ("""      bulk_copy(dst + 4 * t[b].j_lo, src + 4 * t[b].j_lo,
                16u * (t[b].j_hi - t[b].j_lo), bar);""", "      (void)dst;"),
    ("  if (threadIdx.x == 0) expect_bytes(bar, bytes);",
     "  if (threadIdx.x == 0) expect_bytes(bar, 0u);"),
    ("      expect_bytes(bar, 16u * VDIM * chunks);",
     "      expect_bytes(bar, 0u);"),
    ("        bulk_copy(buf + b * row_floats, x + b * N + pos0, 16u * chunks, "
     "bar);", "        (void)pos0;"))
_NO_STAGING = _NO_COPIES + (
    ("    const int edge = t[b].j_lo + chunks - t[b].j_hi;",
     "    const int edge = 0;"),)
_NO_WAIT = (
    ("      wait_barrier(bar0 + 8 * slot, (wraps + (i >= p.stages)) & 1u);",
     ""),)
_NO_LOADS = (
    ("        xv[b][s][k] = buf[at[b] + threadIdx.x + k * kShiftsThreads + s];",
     "        xv[b][s][k] = __int_as_float(0x3f800000 + threadIdx.x + k + s"
     " + b + at[b]);"),)
_NO_FMAS = (
    ("""        const float w = terms.wc[((kFirst + s) * VDIM + a) * VDIM + b];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          acc[a][k] = fmaf(w, xv[b][s][k], acc[a][k]);
        }""", """        if (a != 0) continue;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          acc[0][k] = __int_as_float(__float_as_int(acc[0][k]) ^
                                     __float_as_int(xv[b][s][k]));
        }"""),)
_NO_SUM = (("  (shifts_group<VDIM, NOFF, K, G>(buf, at[G], terms, acc), ...);",
            "  (void)at;"),)


def _nodes_variant(k):
    """shifts with ``k`` nodes a thread in a staged run."""
    return (f"shifts {k} nodes a thread (staged runs of {128 * k})",
            ("shifts",),
            [("constexpr int kShiftsNodes = 4;",
              f"constexpr int kShiftsNodes = {k};")],
            {"SHIFTS_NODES": k})


# (label, probes it is timed on, [(text in the source, its replacement)],
#  {constant of ops/floor_probes.py: value while it runs})
NEW_VARIANTS = (
    ("bf16 weights kept as packed pairs", ("residentw",),
     [("""  float w[NW];
  __device__ __forceinline__ void load(const WT* __restrict__ Wt, int B,
                                       int s) {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      w[i] = to_f32(__ldg(Wt + static_cast<size_t>(i) * B + s));
    }
  }
  __device__ __forceinline__ float operator()(int i) const { return w[i]; }""",
       """  static constexpr bool kPacked = sizeof(WT) == 2;
  unsigned w[kPacked ? (NW + 1) / 2 : NW];
  __device__ __forceinline__ void load(const WT* __restrict__ Wt, int B,
                                       int s) {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const WT* p = Wt + static_cast<size_t>(i) * B + s;
      if constexpr (kPacked) {
        const unsigned h = __ldg(reinterpret_cast<const unsigned short*>(p));
        w[i >> 1] = (i & 1) ? (w[i >> 1] | (h << 16)) : h;
      } else {
        w[i] = __float_as_uint(to_f32(__ldg(p)));
      }
    }
  }
  __device__ __forceinline__ float operator()(int i) const {
    if constexpr (kPacked) {
      return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u)
                                     : (w[i >> 1] << 16));
    } else {
      return __uint_as_float(w[i]);
    }
  }""")], {}),
    ("residentw no x loads", ("residentw",),
     [("  group_spans<VDIM, 1, NOFF, G, INTERIOR>(x, t, N, base, xv);",
       "  for (int b = 0; b < VDIM; ++b)\n"
       "    for (int q = 0; q < kSize; ++q)\n"
       "      xv[b][q] = __int_as_float(0x3f800000 + t.n0 + q + b + base);")],
     {}),
    ("residentw two repeats in flight", ("residentw",),
     [("  for (int j = j0; j < j1; ++j) {\n    const int n = s + j * p.B;",
       "#pragma unroll 2\n  for (int j = j0; j < j1; ++j) {\n"
       "    const int n = s + j * p.B;")], {}),
    ("residentw 3 blocks an SM", ("residentw",),
     [("__global__ void __launch_bounds__(kThreads)\nresidentw_kernel(",
       "__global__ void __launch_bounds__(kThreads, 3)\nresidentw_kernel(")],
     {}),
    ("csz no x loads", ("csz",),
     [("        xv[b][s][k] = buf[at[b] + threadIdx.x + k * kCszThreads + s];",
       "        xv[b][s][k] = __int_as_float(0x3f800000 + threadIdx.x + k + s"
       " + b + at[b]);")], {}),
    ("csz no x copies", ("csz",), list(_NO_COPIES), {}),
    ("shifts no x copies", ("shifts",), list(_NO_COPIES), {}),
    ("shifts no x loads", ("shifts",), list(_NO_LOADS), {}),
    ("shifts no FMAs (one XOR a loaded value)", ("shifts",), list(_NO_FMAS),
     {}),
    ("shifts empty (no copies, waits, loads, FMAs or stores)", ("shifts",),
     [*_NO_STAGING, *_NO_WAIT, *_NO_SUM,
      ("        for (int a = 0; a < VDIM; ++a) y[a * N + B0 + i] = acc[a][k];",
       "        (void)acc;")], {}),
    ("shifts stores of y alone (no copies, loads, FMAs)", ("shifts",),
     [*_NO_STAGING, *_NO_WAIT, *_NO_SUM], {}),
    ("shifts smem loads and FMAs alone (no copies, no waits)", ("shifts",),
     [*_NO_STAGING, *_NO_WAIT], {}),
    ("shifts copies, waits and stores (no loads, no FMAs)", ("shifts",),
     [*_NO_LOADS, *_NO_FMAS], {}),
    ("shifts no window in flight (ring of the planes read)", ("shifts",), [],
     {"SHIFTS_AHEAD": 0}),
    ("shifts two windows in flight", ("shifts",), [], {"SHIFTS_AHEAD": 2}),
    ("shifts (b) one run a block, no window in flight", ("shifts",), [],
     {"SHIFTS_AHEAD": 0,
      "shifts_ranges": lambda planes, columns, sms, per_sm: planes}),
    *(("shifts %d blocks an SM" % n, ("shifts",), [],
       {"SHIFTS_BLOCKS_PER_SM": n}) for n in (2, 3, 6)),
    *(_nodes_variant(k) for k in (2, 5, 8)),
    ("csz 8 nodes a thread at v3", ("csz",),
     [("csz_nodes(int vdim) {\n  return vdim == 1 ? 8 : 4;",
       "csz_nodes(int vdim) {\n  return 8;")],
     {"csz_nodes": lambda vdim: 8}),
    ("csz 2 nodes a thread at v3", ("csz",),
     [("csz_nodes(int vdim) {\n  return vdim == 1 ? 8 : 4;",
       "csz_nodes(int vdim) {\n  return vdim == 1 ? 8 : 2;")],
     {"csz_nodes": lambda vdim: 8 if vdim == 1 else 2}),
    ("csz 4 nodes a thread at v1", ("csz",),
     [("csz_nodes(int vdim) {\n  return vdim == 1 ? 8 : 4;",
       "csz_nodes(int vdim) {\n  return 4;")],
     {"csz_nodes": lambda vdim: 4}),
)

# the decomposition of the earlier csz kernel (4 consecutive nodes a
# thread, x spans through L1, an interior and an edge body)
REF_VARIANTS = (
    ("no x loads", ("csz",),
     [("""  float xv[VDIM][kNodes + kSize - 1];
  group_spans<VDIM, NOFF, G, INTERIOR>(x, t, N, base, xv);
#pragma unroll
  for (int s = 0; s < kSize; ++s) {
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
#pragma unroll
      for (int a = 0; a < VDIM; ++a) {
        const int i = ((kFirst + s) * VDIM + a) * VDIM + b;""",
       """  float xv[VDIM][kNodes + kSize - 1];
  for (int b = 0; b < VDIM; ++b)
    for (int q = 0; q < kNodes + kSize - 1; ++q)
      xv[b][q] = __int_as_float(0x3f800000 + t.n0 + q + b + base);
#pragma unroll
  for (int s = 0; s < kSize; ++s) {
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
#pragma unroll
      for (int a = 0; a < VDIM; ++a) {
        const int i = ((kFirst + s) * VDIM + a) * VDIM + b;""")], {}),
    ("face sets off", ("csz",),
     [("          az0[a][k] = fmaf(d0, xs, az0[a][k]);\n"
       "          az1[a][k] = fmaf(d1, xs, az1[a][k]);",
       "          (void)d0;\n          (void)d1;")], {}),
    ("interior body alone (edge blocks skipped)", ("csz",),
     [("""  if (t.interior) {
    csz_groups<VDIM, NOFF, true>(kGroups, terms, x, t, N, geo, acc, az0, az1);
  } else {
    csz_groups<VDIM, NOFF, false>(kGroups, terms, x, t, N, geo, acc, az0, az1);
  }""", """  if (!t.interior) return;
  csz_groups<VDIM, NOFF, true>(kGroups, terms, x, t, N, geo, acc, az0, az1);""")],
     {}),
    ("8 nodes a thread", ("csz",),
     [("constexpr int kNodes = 4;", "constexpr int kNodes = 8;")], {}),
    ("no selects (aligned spans)", ("csz",),
     [("    v = r == 1 ? c[p + 1] : v;\n    v = r == 2 ? c[p + 2] : v;\n"
       "    v = r == 3 ? c[p + 3] : v;\n", "")], {}),
)

KERNELS = {"shifts": "shifts_kernel", "residentw": "residentw_kernel",
           "csz": "csz_kernel"}


def inline_header(src: str) -> str:
    from pde_solver_tpu_torch.ops import cuda_build

    header = (cuda_build.CSRC / "stencil_span.cuh").read_text()
    return src.replace('#include "stencil_span.cuh"',
                       header.replace("#pragma once", ""))


def build_variants(path: str, variants, out_dir: str, prefix: str):
    """Every variant of a source, one nvcc each, all started together (a
    variant whose text an earlier one has shares its build, process None);
    returns [(label, probes, overrides, so path, nvcc process)]."""
    from pde_solver_tpu_torch.ops import cuda_build

    src = inline_header(open(path).read())
    os.makedirs(out_dir, exist_ok=True)
    procs, built = [], {}
    for i, (label, probes, patches, overrides) in enumerate(variants):
        missing = [old for old, _ in patches if old not in src]
        if missing:
            print(f"  {prefix} {label}: skipped, {missing[0][:60]!r} is not "
                  f"in {path}", flush=True)
            continue
        text = src
        for old, new in patches:
            text = text.replace(old, new)
        if text in built:
            procs.append((label, probes, overrides, built[text], None))
            continue
        cu = os.path.join(out_dir, f"{prefix}_{i}.cu")
        so = os.path.join(out_dir, f"{prefix}_{i}.so")
        with open(cu, "w") as f:
            f.write(text)
        built[text] = so
        procs.append((label, probes, overrides, so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def sass_counts(so: str):
    """{mangled kernel name: SASS instructions} of a probe library."""
    from pde_solver_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                         timeout=120).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[name] += 1
    return counts


def finish(procs, prefix: str):
    """Waits for build_variants' nvcc processes, prints their ptxas and
    SASS counts of the probe kernels; returns [(label, probes, overrides,
    CDLL)]."""
    libs = []
    for label, probes, overrides, so, proc in procs:
        if proc is None:
            libs.append((label, probes, overrides, ctypes.CDLL(so)))
            continue
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc {prefix} {label}:\n{log}")
        names = tuple(KERNELS[p] for p in probes)
        for line in cs.ptxas_lines(log, names):
            print(f"  {prefix} {label} ptxas: {line}", flush=True)
        for name, n in sass_counts(so).items():
            if any(k in name for k in names):
                print(f"  {prefix} {label} sass: {name} {n} instructions",
                      flush=True)
        libs.append((label, probes, overrides, ctypes.CDLL(so)))
    return libs


class RefCalls:
    """The probes through a library with the earlier C interface."""

    def __init__(self, lib):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.floor_shifts.argtypes = [i, p, p, ll, p, i, p, p]
        lib.floor_residentw.argtypes = [p, i, ll, i, p, p, ll, p, i, p]
        lib.floor_csz.argtypes = [p, ll, i, p, p, ll, p, i, p, p, p, p]
        self.lib = lib

    def __call__(self, probe, x, deltas, vdim, tile=None, masks=None,
                 terms=None):
        import numpy as np
        import torch

        y = torch.empty_like(x)
        d = np.ascontiguousarray(deltas, np.int32)
        t = [np.ascontiguousarray(c, np.float32) for c in terms]
        s = torch.cuda.current_stream().cuda_stream
        N = x.shape[1]
        if probe == "shifts":
            rc = self.lib.floor_shifts(vdim, x.data_ptr(), y.data_ptr(), N,
                                       d.ctypes.data, len(d), t[0].ctypes.data,
                                       s)
        elif probe == "residentw":
            rc = self.lib.floor_residentw(
                tile.data_ptr(), int(tile.dtype == torch.bfloat16),
                tile.shape[1], vdim, x.data_ptr(), y.data_ptr(), N,
                d.ctypes.data, len(d), s)
        else:
            rc = self.lib.floor_csz(
                masks.data_ptr(), masks.shape[1], vdim, x.data_ptr(),
                y.data_ptr(), N, d.ctypes.data, len(d), t[0].ctypes.data,
                t[1].ctypes.data, t[2].ctypes.data, s)
        cs.check(rc == 0, f"{probe}: CUDA error {rc}")
        return y


def _clear_plans(fp):
    for f in (fp.shifts_plan, fp._shifts_blocks_per_sm, fp.residentw_plan,
              fp.csz_plan, fp._resident_blocks):
        f.cache_clear()


class NewCalls:
    """The probes through ops/floor_probes.py's wrappers, bound to one
    build of the plan-taking source, with the module constants a variant
    changes set while it runs."""

    def __init__(self, fp, lib, overrides):
        self.fp, self.overrides = fp, overrides
        self.bound = fp.bind_library(lib)

    def __enter__(self):
        fp = self.fp
        self.saved = {k: getattr(fp, k) for k in self.overrides}
        self.saved_lib = fp._LIB
        for k, v in self.overrides.items():
            setattr(fp, k, v)
        fp._LIB = self.bound
        _clear_plans(fp)
        return self

    def __exit__(self, *exc):
        fp = self.fp
        for k, v in self.saved.items():
            setattr(fp, k, v)
        fp._LIB = self.saved_lib
        _clear_plans(fp)

    def __call__(self, probe, x, deltas, vdim, tile=None, masks=None,
                 terms=None):
        fp = self.fp
        if probe == "shifts":
            return fp.shifts(x, deltas, vdim, terms[0])
        if probe == "residentw":
            return fp.residentw(tile, x, deltas, vdim)
        return fp.csz(masks, x, deltas, vdim, *terms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref", help="a floor_probes.cu with the earlier C "
                    "interface, timed beside this one")
    ap.add_argument("--ref-probes", nargs="+", default=list(KERNELS),
                    choices=list(KERNELS), help="the probes whose earlier "
                    "(plan-less) C interface the --ref source has")
    ap.add_argument("--probes", nargs="+", default=list(KERNELS),
                    choices=list(KERNELS), help="the probes to time")
    args = ap.parse_args()
    ref_probes = tuple(p for p in args.ref_probes if p in args.probes)

    def wanted(variants, probes):
        return tuple((label, tuple(p for p in on if p in probes), patches,
                      over) for label, on, patches, over in variants
                     if any(p in probes for p in on))

    import torch

    if not torch.cuda.is_available():
        print("floor_ab: no CUDA card", file=sys.stderr)
        return 2
    from pde_solver_tpu_torch.ops import cuda_build
    from pde_solver_tpu_torch.ops import floor_probes as fp
    from pde_solver_tpu_torch.ops import stencil_kernels as sk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "floor_ab")
    t0 = time.perf_counter()
    src = str(cuda_build.CSRC / "floor_probes.cu")
    procs_n = build_variants(src, wanted((("new", tuple(KERNELS), [], {}),)
                                         + NEW_VARIANTS, args.probes),
                             out_dir, "new")
    procs_r = build_variants(args.ref, wanted(
        (("ref", tuple(KERNELS), [], {}),) + REF_VARIANTS, ref_probes),
        out_dir, "ref") if args.ref and ref_probes else []
    libs = [("new", label, probes, NewCalls(fp, lib, over))
            for label, probes, over, lib in finish(procs_n, "new")]
    libs += [("ref", label, probes, RefCalls(lib))
             for label, probes, _, lib in finish(procs_r, "ref")]
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    flush = torch.empty(cs.FLUSH_BYTES // 4, device="cuda")
    for label, vdim, make in (
            ("flagship elasticity 161x65x65", 3, cs.elasticity_operator),
            ("heat 129^3", 1, lambda: cs.heat_operator((128, 128, 128)))):
        mesh, sysm = make()
        op = sk.FlatStencilOperator(sysm.offsets, sysm.weights,
                                    mesh.node_shape, vdim=vdim, device="cuda")
        x = torch.randn((vdim, op.N), generator=gen, device="cuda")
        d = op.deltas
        terms = fp.probe_constants(op.n_off * vdim * vdim)
        masks = fp.face_masks(op.N_pad, mesh.node_shape[-1], "cuda")
        ops = {"f32": op, "bf16": op.as_weight_dtype(torch.bfloat16)}
        tiles = {wt: fp.weight_tile(o.W) for wt, o in ops.items()}
        plains = {"shifts": fp.shifts_plain(x, d, vdim, terms[0]),
                  "csz": fp.csz_plain(masks, x, d, vdim, *terms)}
        for wt, t in tiles.items():
            plains[f"residentw {wt}"] = fp.residentw_plain(t, x, d, vdim)
        cases = [("shifts", "shifts", None, ops["f32"]),
                 ("residentw f32", "residentw", tiles["f32"], ops["f32"]),
                 ("residentw bf16", "residentw", tiles["bf16"], ops["bf16"]),
                 ("csz", "csz", None, ops["f32"])]
        for kind, name, probes, calls in libs:
            checked = name in ("new", "ref")
            for case, probe, tile, o in cases:
                if probe not in probes:
                    continue
                nbytes, flops = cs.probe_bytes_flops(probe, o, tile)
                bnd, by = cs.bound(nbytes, flops)

                def run(probe=probe, tile=tile):
                    return calls(probe, x, d, vdim, tile=tile, masks=masks,
                                 terms=terms)
                with (calls if kind == "new" else _Null()):
                    if checked:
                        y = run()
                        torch.cuda.synchronize()
                        rel = cs.rel_err(y, plains[case])
                        cs.check(rel <= cs.REL_TOL, f"{kind} {case} at "
                                 f"{label}: {rel:.3e} from plain")
                    kernel = KERNELS[probe]
                    warm = cs.device_ms(run, kernel)
                    cold = cs.device_ms(lambda: (flush.zero_(), run()),
                                        kernel)
                    grid = shifts_grid_line(fp, op.N, d, vdim) \
                        if kind == "new" and probe == "shifts" else ""
                print(f"{label} {case} [{kind}: {name}]: device_ms warm "
                      f"{warm:.4f} emptied {cold:.4f} bound_ms {bnd:.4f} "
                      f"({by}) share {bnd / warm:.3f} / {bnd / cold:.3f}"
                      + (f" (vs plain {rel:.2e})" if checked else "")
                      + grid, flush=True)
        del op, ops, tiles, x, plains, masks, mesh, sysm
        torch.cuda.empty_cache()
    return 0


def shifts_grid_line(fp, N, deltas, vdim) -> str:
    """The grid shifts launched by: its plan's blocks, stride, planes a
    block, ring and shared bytes, and the blocks an SM holds at that many
    bytes."""
    import torch

    if vdim not in fp.SHIFTS_STAGED_VDIMS:
        return " | span path through L1, no plan"
    deltas = tuple(int(v) for v in deltas)
    per_sm = fp._shifts_blocks_per_sm(vdim, len(deltas),
                                      fp.shifts_smem_bytes(deltas, vdim))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fp.shifts_plan(N, deltas, vdim, sms, per_sm)
    _, a0, a1 = plan.block_planes(0)
    _, b0, b1 = plan.block_planes(plan.blocks - 1)
    return (f" | plan: {plan.blocks} blocks ({per_sm} an SM fit) of "
            f"{a1 - a0}–{b1 - b0} runs of {plan.run} nodes, {plan.columns} "
            f"columns a stride of {plan.stride}, {plan.planes} planes, "
            f"{plan.stages} windows of {plan.row_floats} floats, "
            f"{plan.smem_bytes} B")


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


if __name__ == "__main__":
    sys.exit(main())
