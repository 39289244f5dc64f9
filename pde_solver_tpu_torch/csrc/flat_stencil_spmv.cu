// Flat-layout stencil SpMV for Hopper (sm_90a).
//
//   y[a·N + n] = Σ_o Σ_b W[((o·v + a)·v + b)·N_pad + n] · x[b·N + n + δ_o]
//
// for every node n < N and output component a < v, with x read as zero
// where n + δ_o falls outside [0, N).  Weights are float32 or bfloat16;
// every product and the accumulation are float32.
//
// Replaces pde_solver_tpu/ops/pallas_kernels.py::_resident_kernel and
// ::_windowed_kernel (shared body _spmv_body).  On the TPU those two differ
// only in where x lives (all of x in VMEM, or a DMA'd window per block).
// Here x is read through L1/L2: the largest x on the main path (the 2.04M-DOF
// flagship fine level, 8 MB) fits the 50 MB L2 many times over, so one
// kernel covers both.
//
// Layout: weights are plane-major [n_off·v·v, N_pad], N_pad = N rounded up
// to 128 with zero weights in the tail (the reference's [n_off·v·v, n_rows,
// 128] packing), so every plane starts 16-byte aligned.  Vectors are
// component-major [v, N] (the order of FlatStencilOperator.to_flat).
// Shifts are flat-index deltas; assembled weights are exactly zero wherever
// a shift wraps across a grid row, so flat addressing is exact, and the
// bounds handling below keeps every used read inside x.
//
// Built for the v listed in FLAT_STENCIL_VDIMS (scalar problems, 2-D and
// 3-D elasticity) and the offset counts in FLAT_STENCIL_NOFFS (the sorted P1
// stencils of 1-D, 2-D and 3-D meshes), with f32 and bf16 weights; any other
// v or count is refused (cudaErrorInvalidValue).  ops/stencil_kernels.py
// reads both lines as KERNEL_VDIMS and KERNEL_NOFFS, so FlatStencilOperator
// refuses anything else on a CUDA device at construction, and a new v or
// count is added here and nowhere else.
//
// What bounds it: W bytes.  Each node streams n_off·v² weights once —
// 15·9·4 = 540 B/node at f32 and 270 B/node at bf16 for 3-D elasticity,
// 15·4 = 60 B/node for scalar 3-D problems — against 8·v B/node of x and y.
// What the design does about it:
// * Offsets are a template parameter, so the (o, b, a) loop unrolls fully
//   and a thread issues its weight loads ahead of the FMAs that use them:
//   enough bytes in flight per thread even at v = 1.
// * Each thread owns K consecutive nodes, K = 4 at f32 and 8 at bf16, so
//   every weight plane is one 16-byte load per thread, streamed with an
//   evict-first hint (__ldcs) so that L1 and L2 keep x.  Grids under
//   kWideMinNodes (the multigrid's coarse levels) take K = 1 instead: too
//   few wide threads to fill 132 SMs, and each one's chain of loads would
//   set the time.
// * Row groups.  The sorted P1 stencil's offsets come in runs that differ
//   only by ±1 in the last grid axis: P pairs, the (−1, 0, +1) triple, P
//   pairs, P = (n_off − 3)/4 — the TPU body's row groups.  Each (group, b)
//   reads one span of K + size − 1 x values and every member reuses it.
// * A block whose whole x span lies inside [0, N) reads each span as
//   aligned 16-byte chunks (or plain loads at K = 1) and takes no bounds
//   test; only the edge blocks at either end of x test each value.  Index
//   arithmetic inside a plane and inside x is 32-bit.
// A shared-memory x window buys nothing here: per-node weights give W no
// reuse, and x stays in L1/L2 between neighbouring spans.
//
// Accumulation runs in the reference's (o, b, a) order with explicit fmaf,
// so results differ from the unfused plain version by float32 rounding
// only, and equal those of the one-node-per-thread form bit for bit.
//
// C interface for ctypes: flat_stencil_spmv(...) launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "stencil_span.cuh"

#define FLAT_STENCIL_VDIMS 1, 2, 3
#define FLAT_STENCIL_NOFFS 3, 7, 15

namespace {

constexpr int kThreads = 128;
// Below this many nodes a thread takes one node, not 4 (f32) or 8 (bf16):
// the wide grid would leave most SMs idle and each thread's chain of loads
// would set the time (measured on the multigrid's coarse levels).
constexpr int kWideMinNodes = 1 << 18;
constexpr int kPlaneAlign = 128;   // N_pad is a multiple of this
constexpr int kMaxGroups = 8;
constexpr long long kMaxIndex = 1LL << 30;   // v·N_pad and |δ| stay below

struct Geometry {
  int base[kMaxGroups];   // δ of each group's first member
  int dmin, dmax;         // over all offsets
};

// K weights of one plane, starting at p, as float32: one 16-byte load
// (p 16-byte aligned) for the wide path, one scalar load for K = 1.
template <int K>
__device__ __forceinline__ void load_w(const float* p, float (&w)[K]) {
  if constexpr (K == 1) {
    w[0] = __ldcs(p);
  } else {
    static_assert(K == 4, "f32 weights: 1 or 4 nodes a thread");
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
}

template <int K>
__device__ __forceinline__ void load_w(const __nv_bfloat16* p,
                                       float (&w)[K]) {
  // bf16 → f32 is exact: the bf16 bits are the high half of the f32
  if constexpr (K == 1) {
    const unsigned short u =
        __ldcs(reinterpret_cast<const unsigned short*>(p));
    w[0] = __uint_as_float(static_cast<unsigned>(u) << 16);
  } else {
    static_assert(K == 8, "bf16 weights: 1 or 8 nodes a thread");
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[2 * i] = __uint_as_float(u[i] << 16);
      w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

// Row group G: its x spans for every b, its members' weights, and their
// FMAs in (o, b, a) order.  On the wide path at v = 3 a group carries 18 or
// 27 weight planes and all of them are loaded first (more bytes in flight:
// measured faster at v = 3 bf16); elsewhere each load is issued beside its
// FMAs (measured faster at v = 1 and 2, and at K = 1, where fewer registers
// let more blocks share an SM).
template <int VDIM, typename WT, int NOFF, int G, int K, bool INTERIOR>
__device__ __forceinline__ void group_pass(const WT* __restrict__ Wn,
                                           int N_pad,
                                           const float* __restrict__ x,
                                           const float4* __restrict__ xa,
                                           int sh, int N, int n0, int base,
                                           float (&acc)[VDIM][K]) {
  constexpr int kSize = group_size(NOFF, G);
  constexpr int kFirst = group_first(NOFF, G);
  constexpr int kSpan = K + kSize - 1;
  constexpr bool kLoadsFirst = VDIM == 3 && K > 1;
  float w[kLoadsFirst ? kSize : 1][VDIM][VDIM][K];
  const auto plane = [&](int s, int a, int b) {
    return Wn + static_cast<size_t>(((kFirst + s) * VDIM + a) * VDIM + b) *
                    N_pad;
  };
  if constexpr (kLoadsFirst) {
#pragma unroll
    for (int s = 0; s < kSize; ++s) {
#pragma unroll
      for (int b = 0; b < VDIM; ++b) {
#pragma unroll
        for (int a = 0; a < VDIM; ++a) load_w<K>(plane(s, a, b), w[s][b][a]);
      }
    }
  }
  float xv[VDIM][kSpan];
#pragma unroll
  for (int b = 0; b < VDIM; ++b) {
    span<kSpan, K, INTERIOR>(x, xa, sh, N, b, n0 + base, xv[b]);
  }
#pragma unroll
  for (int s = 0; s < kSize; ++s) {
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
#pragma unroll
      for (int a = 0; a < VDIM; ++a) {
        float(&ws)[K] = w[kLoadsFirst ? s : 0][b][a];
        if constexpr (!kLoadsFirst) load_w<K>(plane(s, a, b), ws);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          acc[a][k] = fmaf(ws[k], xv[b][s + k], acc[a][k]);
        }
      }
    }
  }
}

// Every row group in order.  INTERIOR is a template argument so that each
// path is one branch-free sequence: the scheduler can then issue the
// weight loads of later groups ahead of earlier FMAs.
template <int VDIM, typename WT, int NOFF, int K, bool INTERIOR, int... G>
__device__ __forceinline__ void all_groups(std::integer_sequence<int, G...>,
                                           const WT* __restrict__ Wn,
                                           int N_pad,
                                           const float* __restrict__ x,
                                           const float4* __restrict__ xa,
                                           int sh, int N, int n0,
                                           const Geometry& geo,
                                           float (&acc)[VDIM][K]) {
  (group_pass<VDIM, WT, NOFF, G, K, INTERIOR>(Wn, N_pad, x, xa, sh, N, n0,
                                              geo.base[G], acc),
   ...);
}

// K consecutive nodes a thread: 16 / sizeof(WT) on the wide path, 1 on
// grids too small to fill the card that way.  There, latency sets the time
// and at least 6 blocks share an SM (≤ 85 registers a thread: measured
// faster at every coarse level); the wide path's registers are left to the
// compiler (a cap measured slower at v = 2 and 3).
template <int VDIM, typename WT, int NOFF, int K>
__global__ void __launch_bounds__(kThreads, K == 1 ? 6 : 1)
flat_stencil_spmv_kernel(const WT* __restrict__ W,
                         const float* __restrict__ x,
                         float* __restrict__ y, int N, int N_pad,
                         Geometry geo) {
  constexpr int kBlockNodes = kThreads * K;
  const int B0 = blockIdx.x * kBlockNodes;
  const int n0 = B0 + threadIdx.x * K;
  if (n0 >= N) return;
  // Every span of the block, widened to whole chunks, lies inside [0, N):
  // the end margin covers the chunk round-up (≤ 8 values).
  const bool interior =
      B0 + geo.dmin >= 0 &&
      static_cast<long long>(B0) + kBlockNodes + max(geo.dmax, 0) + 8 <= N;
  const int sh = static_cast<int>((reinterpret_cast<uintptr_t>(x) & 15) >> 2);
  const float4* xa = reinterpret_cast<const float4*>(x - sh);
  float acc[VDIM][K];
#pragma unroll
  for (int a = 0; a < VDIM; ++a) {
#pragma unroll
    for (int k = 0; k < K; ++k) acc[a][k] = 0.0f;
  }
  constexpr auto kGroups = std::make_integer_sequence<int, group_count(NOFF)>{};
  if (interior) {
    all_groups<VDIM, WT, NOFF, K, true>(kGroups, W + n0, N_pad, x, xa, sh, N,
                                        n0, geo, acc);
  } else {
    all_groups<VDIM, WT, NOFF, K, false>(kGroups, W + n0, N_pad, x, xa, sh, N,
                                         n0, geo, acc);
  }
#pragma unroll
  for (int a = 0; a < VDIM; ++a) {
    float* ya = y + a * N + n0;
    bool stored = false;
    if constexpr (K % 4 == 0) {
      if (interior && (reinterpret_cast<uintptr_t>(ya) & 15) == 0) {
#pragma unroll
        for (int k = 0; k < K; k += 4) {
          *reinterpret_cast<float4*>(ya + k) = make_float4(
              acc[a][k], acc[a][k + 1], acc[a][k + 2], acc[a][k + 3]);
        }
        stored = true;
      }
    }
    if (!stored) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (n0 + k < N) ya[k] = acc[a][k];
      }
    }
  }
}

template <int VDIM, typename WT, int NOFF, int K>
void launch_k(const void* W, const void* x, void* y, int N, int N_pad,
              const Geometry& geo, cudaStream_t stream) {
  const int blocks = (N + kThreads * K - 1) / (kThreads * K);
  flat_stencil_spmv_kernel<VDIM, WT, NOFF, K><<<blocks, kThreads, 0, stream>>>(
      static_cast<const WT*>(W), static_cast<const float*>(x),
      static_cast<float*>(y), N, N_pad, geo);
}

template <int VDIM, typename WT, int NOFF>
void launch(const void* W, const void* x, void* y, int N, int N_pad,
            const Geometry& geo, cudaStream_t stream) {
  if (N >= kWideMinNodes) {
    launch_k<VDIM, WT, NOFF, 16 / static_cast<int>(sizeof(WT))>(
        W, x, y, N, N_pad, geo, stream);
  } else {
    launch_k<VDIM, WT, NOFF, 1>(W, x, y, N, N_pad, geo, stream);
  }
}

// Launches the (VDIM, NOFF) instantiation if it is the one asked for.
template <int VDIM, int NOFF>
bool launch_if(int vdim, int n_off, int w_is_bf16, const void* W,
               const void* x, void* y, int N, int N_pad, const Geometry& geo,
               cudaStream_t stream) {
  if (vdim != VDIM || n_off != NOFF) return false;
  static_assert((NOFF - 3) % 4 == 0 && group_count(NOFF) <= kMaxGroups,
                "offset counts are those of sorted P1 stencils");
  if (w_is_bf16) {
    launch<VDIM, __nv_bfloat16, NOFF>(W, x, y, N, N_pad, geo, stream);
  } else {
    launch<VDIM, float, NOFF>(W, x, y, N, N_pad, geo, stream);
  }
  return true;
}

template <int VDIM, int... NOFFS>
bool dispatch_noff(int vdim, int n_off, int w_is_bf16, const void* W,
                   const void* x, void* y, int N, int N_pad,
                   const Geometry& geo, cudaStream_t stream) {
  return (launch_if<VDIM, NOFFS>(vdim, n_off, w_is_bf16, W, x, y, N, N_pad,
                                 geo, stream) ||
          ...);
}

template <int... VDIMS>
bool dispatch(int vdim, int n_off, int w_is_bf16, const void* W,
              const void* x, void* y, int N, int N_pad, const Geometry& geo,
              cudaStream_t stream) {
  return (dispatch_noff<VDIMS, FLAT_STENCIL_NOFFS>(
              vdim, n_off, w_is_bf16, W, x, y, N, N_pad, geo, stream) ||
          ...);
}

// The row groups of the sorted P1 stencil, checked against the deltas.
bool make_geometry(const int* deltas, int n_off, Geometry* geo) {
  if (n_off < 3 || (n_off - 3) % 4 != 0 || group_count(n_off) > kMaxGroups) {
    return false;
  }
  *geo = {};
  geo->dmin = deltas[0];
  geo->dmax = deltas[0];
  for (int o = 0; o < n_off; ++o) {
    if (deltas[o] > kMaxIndex || deltas[o] < -kMaxIndex) return false;
    geo->dmin = deltas[o] < geo->dmin ? deltas[o] : geo->dmin;
    geo->dmax = deltas[o] > geo->dmax ? deltas[o] : geo->dmax;
  }
  for (int g = 0; g < group_count(n_off); ++g) {
    const int first = group_first(n_off, g);
    for (int s = 1; s < group_size(n_off, g); ++s) {
      if (deltas[first + s] != deltas[first] + s) return false;
    }
    geo->base[g] = deltas[first];
  }
  return true;
}

}  // namespace

extern "C" int flat_stencil_spmv(const void* W, int w_is_bf16, int vdim,
                                 const void* x, void* y, long long N,
                                 long long N_pad, const int* deltas,
                                 int n_off, void* stream) {
  Geometry geo;
  if (N <= 0 || N_pad < N || N_pad % kPlaneAlign != 0 || vdim < 1 ||
      vdim * N_pad > kMaxIndex ||
      (reinterpret_cast<uintptr_t>(W) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 3) != 0 ||
      !make_geometry(deltas, n_off, &geo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dispatch<FLAT_STENCIL_VDIMS>(vdim, n_off, w_is_bf16, W, x, y,
                                    static_cast<int>(N),
                                    static_cast<int>(N_pad), geo, s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
