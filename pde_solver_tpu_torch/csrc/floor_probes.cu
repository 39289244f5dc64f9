// Floor probes of the flat-layout stencil SpMV for Hopper (sm_90a): four
// kernels that each do one part of the dense kernel's work and leave the
// rest out, so that their times say where the dense kernel's time goes.
//
//   wonly      y[n] = Σ_k W[k·N_pad + n]                      (no x at all)
//   shifts     y[a·N + n] = Σ_o Σ_b wc[(o·v + a)·v + b] · x[b·N + n + δ_o]
//                                                   (no weight stream at all)
//   residentw  the dense kernel's sum with node n reading the weights of
//              node n mod B of one tile [n_off·v², B]: per-node weights that
//              stay in cache.  Wrong as an operator by design.
//   csz        y[a·N + n] = Σ_o Σ_b (wc + m0[n]·dz0 + m1[n]·dz1)[k] ·
//              x[b·N + n + δ_o], k = (o·v + a)·v + b, with the two face
//              masks m0, m1 streamed as float32 planes [2, N_pad]
//
// x is read as zero where n + δ_o falls outside [0, N); every product and
// sum is float32; W and the tile are float32 or bfloat16.
//
// Replaces benchmarks/kernel_floor.py::_wonly_kernel, ::_shifts_kernel,
// ::_residentw_kernel and ::_csz_kernel.  Those share the TPU kernel's
// [rows, 128] tiling, lane rolls and halo rows; none of that is carried
// over.  Here a thread owns 4 consecutive nodes (wonly: 16 bytes of every
// plane, so 4 nodes at f32 and 8 at bf16) and reads x through L1/L2 by the
// row groups of the sorted P1 stencil (stencil_span.cuh), as the dense
// kernel does, so that a probe differs from the dense kernel only in what
// it leaves out.
//
// What bounds them: wonly the bytes of W (one 16-byte streaming load per
// plane and thread, eight planes in flight); the other three move only x,
// y and (csz) two mask planes, a few MB that fit the L2, so they are bound
// by instruction rate and latency: their constants sit in the kernel's
// parameters and every (o, b, a) loop is unrolled, so a constant is an
// operand of its FMA and costs no load.
//
// Accumulation runs in the reference's (o, b, a) order with explicit fmaf;
// csz keeps the reference's three sums (interior, z = 0 face, z = top face)
// and joins them at the end.  Results differ from the plain versions by
// float32 rounding only.
//
// C interface for ctypes: each function launches on the given stream, does
// not synchronise, allocates nothing, and returns cudaGetLastError() (0 on
// success) or cudaErrorInvalidValue for arguments it is not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "stencil_span.cuh"

#define FLOOR_PROBE_VDIMS 1, 2, 3
#define FLOOR_PROBE_NOFFS 3, 7, 15

namespace {

constexpr int kThreads = 128;
constexpr int kNodes = 4;          // consecutive nodes a thread (stencils)
constexpr int kPlaneAlign = 128;   // N_pad is a multiple of this
constexpr int kMaxGroups = 8;
constexpr int kMaxTerms = 15 * 3 * 3;
constexpr long long kMaxIndex = 1LL << 30;   // v·N_pad and |δ| stay below

struct Geometry {
  int base[kMaxGroups];   // δ of each row group's first member
  int dmin, dmax;         // over all offsets
};

struct Terms {
  float wc[kMaxTerms];
};

struct FaceTerms {
  float wc[kMaxTerms];
  float dz0[kMaxTerms];
  float dz1[kMaxTerms];
};

// ---------------------------------------------------------------- wonly --

// K weights of one plane as float32, streamed (evict-first): one 16-byte
// load, p 16-byte aligned.
__device__ __forceinline__ void load_stream(const float* p, float (&w)[4]) {
  const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

__device__ __forceinline__ void load_stream(const __nv_bfloat16* p,
                                            float (&w)[8]) {
  // bf16 → f32 is exact: the bf16 bits are the high half of the f32
  const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(u[i] << 16);
    w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

template <typename WT>
__global__ void __launch_bounds__(kThreads)
wonly_kernel(const WT* __restrict__ W, float* __restrict__ y, int nw,
             int N_pad) {
  constexpr int K = 16 / static_cast<int>(sizeof(WT));
  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * K;
  if (n0 >= N_pad) return;   // N_pad is a multiple of 128, so of K
  float acc[K];
#pragma unroll
  for (int i = 0; i < K; ++i) acc[i] = 0.0f;
  const WT* p = W + n0;
#pragma unroll 8
  for (int k = 0; k < nw; ++k) {
    float w[K];
    load_stream(p + static_cast<size_t>(k) * N_pad, w);
#pragma unroll
    for (int i = 0; i < K; ++i) acc[i] += w[i];
  }
#pragma unroll
  for (int i = 0; i < K; i += 4) {
    *reinterpret_cast<float4*>(y + n0 + i) =
        make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  }
}

// ------------------------------------------------- the stencil probes --

// What a thread of a stencil probe works on: its first node, whether every
// x span of its block lies inside [0, N) (then read as aligned chunks with
// no bounds test), and x's 16-byte aligned base.
struct Tile {
  int n0;
  bool interior;
  int sh;
  const float4* xa;
};

__device__ __forceinline__ Tile thread_tile(const float* x, int N,
                                            const Geometry& geo) {
  constexpr int kBlockNodes = kThreads * kNodes;
  const int B0 = blockIdx.x * kBlockNodes;
  Tile t;
  t.n0 = B0 + threadIdx.x * kNodes;
  // the end margin covers the chunk round-up (≤ 8 values)
  t.interior =
      B0 + geo.dmin >= 0 &&
      static_cast<long long>(B0) + kBlockNodes + max(geo.dmax, 0) + 8 <= N;
  t.sh = static_cast<int>((reinterpret_cast<uintptr_t>(x) & 15) >> 2);
  t.xa = reinterpret_cast<const float4*>(x - t.sh);
  return t;
}

// The x spans of row group G, one per component b.
template <int VDIM, int NOFF, int G, bool INTERIOR>
__device__ __forceinline__ void group_spans(
    const float* __restrict__ x, const Tile& t, int N, int base,
    float (&xv)[VDIM][kNodes + group_size(NOFF, G) - 1]) {
#pragma unroll
  for (int b = 0; b < VDIM; ++b) {
    span<kNodes + group_size(NOFF, G) - 1, kNodes, INTERIOR>(
        x, t.xa, t.sh, N, b, t.n0 + base, xv[b]);
  }
}

template <int VDIM>
__device__ __forceinline__ void zero(float (&acc)[VDIM][kNodes]) {
#pragma unroll
  for (int a = 0; a < VDIM; ++a) {
#pragma unroll
    for (int k = 0; k < kNodes; ++k) acc[a][k] = 0.0f;
  }
}

template <int VDIM>
__device__ __forceinline__ void store_nodes(float* __restrict__ y, int N,
                                            const Tile& t,
                                            float (&acc)[VDIM][kNodes]) {
#pragma unroll
  for (int a = 0; a < VDIM; ++a) {
    float* ya = y + a * N + t.n0;
    if (t.interior && (reinterpret_cast<uintptr_t>(ya) & 15) == 0) {
      *reinterpret_cast<float4*>(ya) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    } else {
#pragma unroll
      for (int k = 0; k < kNodes; ++k) {
        if (t.n0 + k < N) ya[k] = acc[a][k];
      }
    }
  }
}

// shifts: constant weights, FMAs in (o, b, a) order.
template <int VDIM, int NOFF, int G, bool INTERIOR>
__device__ __forceinline__ void shifts_group(const Terms& terms,
                                             const float* __restrict__ x,
                                             const Tile& t, int N, int base,
                                             float (&acc)[VDIM][kNodes]) {
  constexpr int kSize = group_size(NOFF, G);
  constexpr int kFirst = group_first(NOFF, G);
  float xv[VDIM][kNodes + kSize - 1];
  group_spans<VDIM, NOFF, G, INTERIOR>(x, t, N, base, xv);
#pragma unroll
  for (int s = 0; s < kSize; ++s) {
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
#pragma unroll
      for (int a = 0; a < VDIM; ++a) {
        const float w = terms.wc[((kFirst + s) * VDIM + a) * VDIM + b];
#pragma unroll
        for (int k = 0; k < kNodes; ++k) {
          acc[a][k] = fmaf(w, xv[b][s + k], acc[a][k]);
        }
      }
    }
  }
}

template <int VDIM, int NOFF, bool INTERIOR, int... G>
__device__ __forceinline__ void shifts_groups(
    std::integer_sequence<int, G...>, const Terms& terms,
    const float* __restrict__ x, const Tile& t, int N, const Geometry& geo,
    float (&acc)[VDIM][kNodes]) {
  (shifts_group<VDIM, NOFF, G, INTERIOR>(terms, x, t, N, geo.base[G], acc),
   ...);
}

template <int VDIM, int NOFF>
__global__ void __launch_bounds__(kThreads)
shifts_kernel(const float* __restrict__ x, float* __restrict__ y, int N,
              const __grid_constant__ Geometry geo,
              const __grid_constant__ Terms terms) {
  const Tile t = thread_tile(x, N, geo);
  if (t.n0 >= N) return;
  float acc[VDIM][kNodes];
  zero<VDIM>(acc);
  constexpr auto kGroups = std::make_integer_sequence<int, group_count(NOFF)>{};
  if (t.interior) {
    shifts_groups<VDIM, NOFF, true>(kGroups, terms, x, t, N, geo, acc);
  } else {
    shifts_groups<VDIM, NOFF, false>(kGroups, terms, x, t, N, geo, acc);
  }
  store_nodes<VDIM>(y, N, t, acc);
}

// residentw: 4 weights of one plane of the tile, kept in cache.
__device__ __forceinline__ void load_tile(const float* p,
                                          float (&w)[kNodes]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

__device__ __forceinline__ void load_tile(const __nv_bfloat16* p,
                                          float (&w)[kNodes]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  w[0] = __uint_as_float(v.x << 16);
  w[1] = __uint_as_float(v.x & 0xffff0000u);
  w[2] = __uint_as_float(v.y << 16);
  w[3] = __uint_as_float(v.y & 0xffff0000u);
}

template <int VDIM, typename WT, int NOFF, int G, bool INTERIOR>
__device__ __forceinline__ void residentw_group(const WT* __restrict__ Wn,
                                                int B,
                                                const float* __restrict__ x,
                                                const Tile& t, int N, int base,
                                                float (&acc)[VDIM][kNodes]) {
  constexpr int kSize = group_size(NOFF, G);
  constexpr int kFirst = group_first(NOFF, G);
  float xv[VDIM][kNodes + kSize - 1];
  group_spans<VDIM, NOFF, G, INTERIOR>(x, t, N, base, xv);
#pragma unroll
  for (int s = 0; s < kSize; ++s) {
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
#pragma unroll
      for (int a = 0; a < VDIM; ++a) {
        float w[kNodes];
        load_tile(Wn + static_cast<size_t>(((kFirst + s) * VDIM + a) * VDIM +
                                           b) * B, w);
#pragma unroll
        for (int k = 0; k < kNodes; ++k) {
          acc[a][k] = fmaf(w[k], xv[b][s + k], acc[a][k]);
        }
      }
    }
  }
}

template <int VDIM, typename WT, int NOFF, bool INTERIOR, int... G>
__device__ __forceinline__ void residentw_groups(
    std::integer_sequence<int, G...>, const WT* __restrict__ Wn, int B,
    const float* __restrict__ x, const Tile& t, int N, const Geometry& geo,
    float (&acc)[VDIM][kNodes]) {
  (residentw_group<VDIM, WT, NOFF, G, INTERIOR>(Wn, B, x, t, N, geo.base[G],
                                                acc),
   ...);
}

// B is a multiple of 4 and so is n0, so the 4 nodes of a thread read 4
// consecutive, 16-byte (f32) or 8-byte (bf16) aligned weights of the tile
// and never wrap inside a group; past N the weights are read (the tile
// holds B of them whatever N is) and the results dropped.
template <int VDIM, typename WT, int NOFF>
__global__ void __launch_bounds__(kThreads)
residentw_kernel(const WT* __restrict__ Wt, int B,
                 const float* __restrict__ x, float* __restrict__ y, int N,
                 const __grid_constant__ Geometry geo) {
  const Tile t = thread_tile(x, N, geo);
  if (t.n0 >= N) return;
  float acc[VDIM][kNodes];
  zero<VDIM>(acc);
  const WT* Wn = Wt + t.n0 % B;
  constexpr auto kGroups = std::make_integer_sequence<int, group_count(NOFF)>{};
  if (t.interior) {
    residentw_groups<VDIM, WT, NOFF, true>(kGroups, Wn, B, x, t, N, geo, acc);
  } else {
    residentw_groups<VDIM, WT, NOFF, false>(kGroups, Wn, B, x, t, N, geo, acc);
  }
  store_nodes<VDIM>(y, N, t, acc);
}

// csz: three constant-weight sums, joined by the streamed masks.
template <int VDIM, int NOFF, int G, bool INTERIOR>
__device__ __forceinline__ void csz_group(const FaceTerms& terms,
                                          const float* __restrict__ x,
                                          const Tile& t, int N, int base,
                                          float (&acc)[VDIM][kNodes],
                                          float (&az0)[VDIM][kNodes],
                                          float (&az1)[VDIM][kNodes]) {
  constexpr int kSize = group_size(NOFF, G);
  constexpr int kFirst = group_first(NOFF, G);
  float xv[VDIM][kNodes + kSize - 1];
  group_spans<VDIM, NOFF, G, INTERIOR>(x, t, N, base, xv);
#pragma unroll
  for (int s = 0; s < kSize; ++s) {
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
#pragma unroll
      for (int a = 0; a < VDIM; ++a) {
        const int i = ((kFirst + s) * VDIM + a) * VDIM + b;
        const float w = terms.wc[i];
        const float d0 = terms.dz0[i];
        const float d1 = terms.dz1[i];
#pragma unroll
        for (int k = 0; k < kNodes; ++k) {
          const float xs = xv[b][s + k];
          acc[a][k] = fmaf(w, xs, acc[a][k]);
          az0[a][k] = fmaf(d0, xs, az0[a][k]);
          az1[a][k] = fmaf(d1, xs, az1[a][k]);
        }
      }
    }
  }
}

template <int VDIM, int NOFF, bool INTERIOR, int... G>
__device__ __forceinline__ void csz_groups(
    std::integer_sequence<int, G...>, const FaceTerms& terms,
    const float* __restrict__ x, const Tile& t, int N, const Geometry& geo,
    float (&acc)[VDIM][kNodes], float (&az0)[VDIM][kNodes],
    float (&az1)[VDIM][kNodes]) {
  (csz_group<VDIM, NOFF, G, INTERIOR>(terms, x, t, N, geo.base[G], acc, az0,
                                      az1),
   ...);
}

template <int VDIM, int NOFF>
__global__ void __launch_bounds__(kThreads)
csz_kernel(const float* __restrict__ m, int N_pad,
           const float* __restrict__ x, float* __restrict__ y, int N,
           const __grid_constant__ Geometry geo,
           const __grid_constant__ FaceTerms terms) {
  const Tile t = thread_tile(x, N, geo);
  if (t.n0 >= N) return;
  float acc[VDIM][kNodes], az0[VDIM][kNodes], az1[VDIM][kNodes];
  zero<VDIM>(acc);
  zero<VDIM>(az0);
  zero<VDIM>(az1);
  constexpr auto kGroups = std::make_integer_sequence<int, group_count(NOFF)>{};
  if (t.interior) {
    csz_groups<VDIM, NOFF, true>(kGroups, terms, x, t, N, geo, acc, az0, az1);
  } else {
    csz_groups<VDIM, NOFF, false>(kGroups, terms, x, t, N, geo, acc, az0, az1);
  }
  // n0 + 3 < N_pad: N_pad is N rounded up to a multiple of 128
  const float4 q0 = __ldcs(reinterpret_cast<const float4*>(m + t.n0));
  const float4 q1 = __ldcs(reinterpret_cast<const float4*>(m + N_pad + t.n0));
  const float m0[kNodes] = {q0.x, q0.y, q0.z, q0.w};
  const float m1[kNodes] = {q1.x, q1.y, q1.z, q1.w};
#pragma unroll
  for (int a = 0; a < VDIM; ++a) {
#pragma unroll
    for (int k = 0; k < kNodes; ++k) {
      acc[a][k] = fmaf(m1[k], az1[a][k], fmaf(m0[k], az0[a][k], acc[a][k]));
    }
  }
  store_nodes<VDIM>(y, N, t, acc);
}

// --------------------------------------------------------------- host --

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

// What every stencil probe is given.
struct Call {
  int vdim, n_off;
  const float* x;
  float* y;
  int N;
  Geometry geo;
  cudaStream_t stream;
  int blocks() const {
    return (N + kThreads * kNodes - 1) / (kThreads * kNodes);
  }
};

bool make_call(int vdim, const void* x, void* y, long long N,
               const int* deltas, int n_off, void* stream, Call* c) {
  if (N <= 0 || vdim < 1 || vdim * N > kMaxIndex ||
      n_off * vdim * vdim > kMaxTerms ||
      (reinterpret_cast<uintptr_t>(x) & 3) != 0 ||
      !make_geometry(deltas, n_off, &c->geo)) {
    return false;
  }
  c->vdim = vdim;
  c->n_off = n_off;
  c->x = static_cast<const float*>(x);
  c->y = static_cast<float*>(y);
  c->N = static_cast<int>(N);
  c->stream = static_cast<cudaStream_t>(stream);
  return true;
}

template <int VDIM, int NOFF>
bool shifts_if(const Call& c, const Terms& terms) {
  if (c.vdim != VDIM || c.n_off != NOFF) return false;
  shifts_kernel<VDIM, NOFF><<<c.blocks(), kThreads, 0, c.stream>>>(
      c.x, c.y, c.N, c.geo, terms);
  return true;
}

template <int VDIM, int... NOFFS>
bool shifts_noff(const Call& c, const Terms& terms) {
  return (shifts_if<VDIM, NOFFS>(c, terms) || ...);
}

template <int... VDIMS>
bool shifts_dispatch(const Call& c, const Terms& terms) {
  return (shifts_noff<VDIMS, FLOOR_PROBE_NOFFS>(c, terms) || ...);
}

template <int VDIM, int NOFF>
bool residentw_if(const Call& c, const void* Wt, int w_is_bf16, int B) {
  if (c.vdim != VDIM || c.n_off != NOFF) return false;
  if (w_is_bf16) {
    residentw_kernel<VDIM, __nv_bfloat16, NOFF>
        <<<c.blocks(), kThreads, 0, c.stream>>>(
            static_cast<const __nv_bfloat16*>(Wt), B, c.x, c.y, c.N, c.geo);
  } else {
    residentw_kernel<VDIM, float, NOFF><<<c.blocks(), kThreads, 0, c.stream>>>(
        static_cast<const float*>(Wt), B, c.x, c.y, c.N, c.geo);
  }
  return true;
}

template <int VDIM, int... NOFFS>
bool residentw_noff(const Call& c, const void* Wt, int w_is_bf16, int B) {
  return (residentw_if<VDIM, NOFFS>(c, Wt, w_is_bf16, B) || ...);
}

template <int... VDIMS>
bool residentw_dispatch(const Call& c, const void* Wt, int w_is_bf16, int B) {
  return (residentw_noff<VDIMS, FLOOR_PROBE_NOFFS>(c, Wt, w_is_bf16, B) ||
          ...);
}

template <int VDIM, int NOFF>
bool csz_if(const Call& c, const float* m, int N_pad, const FaceTerms& terms) {
  if (c.vdim != VDIM || c.n_off != NOFF) return false;
  csz_kernel<VDIM, NOFF><<<c.blocks(), kThreads, 0, c.stream>>>(
      m, N_pad, c.x, c.y, c.N, c.geo, terms);
  return true;
}

template <int VDIM, int... NOFFS>
bool csz_noff(const Call& c, const float* m, int N_pad,
              const FaceTerms& terms) {
  return (csz_if<VDIM, NOFFS>(c, m, N_pad, terms) || ...);
}

template <int... VDIMS>
bool csz_dispatch(const Call& c, const float* m, int N_pad,
                  const FaceTerms& terms) {
  return (csz_noff<VDIMS, FLOOR_PROBE_NOFFS>(c, m, N_pad, terms) || ...);
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

extern "C" int floor_wonly(const void* W, int w_is_bf16, int nw,
                           long long N_pad, void* y, void* stream) {
  if (nw < 1 || N_pad <= 0 || N_pad % kPlaneAlign != 0 || N_pad > kMaxIndex ||
      (reinterpret_cast<uintptr_t>(W) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(y) & 15) != 0) {
    return kInvalid;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(N_pad);
  if (w_is_bf16) {
    const int blocks = (n / 8 + kThreads - 1) / kThreads;
    wonly_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(W), static_cast<float*>(y), nw, n);
  } else {
    const int blocks = (n / 4 + kThreads - 1) / kThreads;
    wonly_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(W), static_cast<float*>(y), nw, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int floor_shifts(int vdim, const void* x, void* y, long long N,
                            const int* deltas, int n_off, const float* wc,
                            void* stream) {
  Call c;
  if (!make_call(vdim, x, y, N, deltas, n_off, stream, &c)) return kInvalid;
  Terms terms = {};
  for (int i = 0; i < n_off * vdim * vdim; ++i) terms.wc[i] = wc[i];
  if (!shifts_dispatch<FLOOR_PROBE_VDIMS>(c, terms)) return kInvalid;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int floor_residentw(const void* Wt, int w_is_bf16, long long B,
                               int vdim, const void* x, void* y, long long N,
                               const int* deltas, int n_off, void* stream) {
  Call c;
  if (!make_call(vdim, x, y, N, deltas, n_off, stream, &c) || B < kNodes ||
      B % kNodes != 0 || B > kMaxIndex ||
      (reinterpret_cast<uintptr_t>(Wt) & 15) != 0) {
    return kInvalid;
  }
  if (!residentw_dispatch<FLOOR_PROBE_VDIMS>(c, Wt, w_is_bf16,
                                             static_cast<int>(B))) {
    return kInvalid;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int floor_csz(const void* m, long long N_pad, int vdim,
                         const void* x, void* y, long long N,
                         const int* deltas, int n_off, const float* wc,
                         const float* dz0, const float* dz1, void* stream) {
  Call c;
  if (!make_call(vdim, x, y, N, deltas, n_off, stream, &c) || N_pad < N ||
      N_pad % kPlaneAlign != 0 || N_pad > kMaxIndex ||
      (reinterpret_cast<uintptr_t>(m) & 15) != 0) {
    return kInvalid;
  }
  FaceTerms terms = {};
  for (int i = 0; i < n_off * vdim * vdim; ++i) {
    terms.wc[i] = wc[i];
    terms.dz0[i] = dz0[i];
    terms.dz1[i] = dz1[i];
  }
  if (!csz_dispatch<FLOOR_PROBE_VDIMS>(c, static_cast<const float*>(m),
                                       static_cast<int>(N_pad), terms)) {
    return kInvalid;
  }
  return static_cast<int>(cudaGetLastError());
}
