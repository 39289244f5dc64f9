// Floor probes of the flat-layout stencil SpMV for Hopper (sm_90a): four
// kernels that each do one part of the dense kernel's work and leave the
// rest out, so that their times say where the dense kernel's time goes.
//
//   wonly      y[n] = Σ_k W[k·N_pad + n]                      (no x at all)
//   shifts     y[a·N + n] = Σ_o Σ_b wc[(o·v + a)·v + b] · x[b·N + n + δ_o]
//                                                   (no weight stream at all)
//   residentw  the dense kernel's sum with node n reading the weights of
//              node n mod B of one tile [n_off·v², B]: per-node weights that
//              stay on chip.  Wrong as an operator by design.
//   csz        y[a·N + n] = Σ_o Σ_b (wc + m0[n]·dz0 + m1[n]·dz1)[k] ·
//              x[b·N + n + δ_o], k = (o·v + a)·v + b, with the two face
//              masks m0, m1 streamed as float32 planes [2, N_pad]
//
// x is read as zero where n + δ_o falls outside [0, N); every product and
// sum is float32; W and the tile are float32 or bfloat16.  Accumulation
// runs in the reference's (o, b, a) order with explicit fmaf; csz keeps the
// reference's three sums (interior, z = 0 face, z = top face) and joins
// them at the end, so that with zero face sets it equals shifts bit for
// bit.  Results differ from the plain versions by float32 rounding only.
//
// wonly and shifts replace benchmarks/kernel_floor.py::_wonly_kernel and
// ::_shifts_kernel.  Those share the TPU kernel's [rows, 128] tiling, lane
// rolls and halo rows; none of that is carried over.  A thread owns 4
// consecutive nodes (wonly: 16 bytes of every plane, so 4 nodes at f32 and
// 8 at bf16) and reads x through L1/L2 by the row groups of the sorted P1
// stencil (stencil_span.cuh), as the dense kernel does.  wonly is bound by
// the bytes of W (one 16-byte streaming load per plane and thread, eight
// planes in flight); shifts moves only x and y, a few MB that fit the L2,
// so it is bound by instruction rate and latency: its constants sit in the
// kernel's parameters and every (o, b, a) loop is unrolled, so a constant
// is an operand of its FMA and costs no load.
//
// residentw and csz, and what bounds them, are described at their kernels.
//
// C interface for ctypes: each function launches on the given stream, does
// not synchronise, allocates nothing, and returns cudaGetLastError() (0 on
// success) or cudaErrorInvalidValue for arguments, or a launch plan, it is
// not built for.  residentw and csz take the plan that ops/floor_probes.py
// computes on the host and check it against their own arithmetic.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "stencil_span.cuh"

#define FLOOR_PROBE_VDIMS 1, 2, 3
#define FLOOR_PROBE_NOFFS 3, 7, 15

namespace {

constexpr int kThreads = 128;
constexpr int kNodes = 4;          // consecutive nodes a thread (shifts)
constexpr int kPlaneAlign = 128;   // N_pad is a multiple of this
constexpr int kMaxGroups = 8;
constexpr int kMaxTerms = 15 * 3 * 3;
constexpr long long kMaxIndex = 1LL << 30;   // v·N_pad and |δ| stay below
constexpr int kMaxSmem = 232448;             // dynamic shared memory a block

// csz: a block stages the x of a run of consecutive nodes; thread t takes
// nodes t, t + kCszThreads, ... of the run (csz_nodes(v) of them)
constexpr int kCszThreads = 128;

// the lengths of the two plan arrays (ops/floor_probes.py builds them)
constexpr int kResidentPlanLen = 5;
constexpr int kCszPlanLen = 7 + 5 * kMaxGroups;

struct Geometry {
  int base[kMaxGroups];   // δ of each row group's first member
  int dmin, dmax;         // over all offsets
};

struct Terms {
  float wc[kMaxTerms];
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

// ------------------------------------------- x spans read through L1/L2 --

// What a thread of shifts or residentw works on: its first node, whether
// every x span of its nodes' range lies inside [0, N) (then read with no
// bounds test, as aligned chunks where a thread has several nodes), and
// x's 16-byte aligned base.
struct Tile {
  int n0;
  bool interior;
  int sh;
  const float4* xa;
};

// The thread's first node n0 and the range [first, last) of nodes whose
// spans decide `interior` (a block's for shifts, the thread's own for
// residentw); the end margin covers the chunk round-up (≤ 8 values).
__device__ __forceinline__ Tile make_tile(const float* x, int N,
                                          const Geometry& geo, int n0,
                                          int first, int last) {
  Tile t;
  t.n0 = n0;
  t.interior = first + geo.dmin >= 0 &&
               static_cast<long long>(last) + max(geo.dmax, 0) + 8 <= N;
  t.sh = static_cast<int>((reinterpret_cast<uintptr_t>(x) & 15) >> 2);
  t.xa = reinterpret_cast<const float4*>(x - t.sh);
  return t;
}

// The x spans of row group G for K consecutive nodes, one per component b.
template <int VDIM, int K, int NOFF, int G, bool INTERIOR>
__device__ __forceinline__ void group_spans(
    const float* __restrict__ x, const Tile& t, int N, int base,
    float (&xv)[VDIM][K + group_size(NOFF, G) - 1]) {
#pragma unroll
  for (int b = 0; b < VDIM; ++b) {
    span<K + group_size(NOFF, G) - 1, K, INTERIOR>(x, t.xa, t.sh, N, b,
                                                   t.n0 + base, xv[b]);
  }
}

template <int VDIM, int K>
__device__ __forceinline__ void zero(float (&acc)[VDIM][K]) {
#pragma unroll
  for (int a = 0; a < VDIM; ++a) {
#pragma unroll
    for (int k = 0; k < K; ++k) acc[a][k] = 0.0f;
  }
}

template <int VDIM, int K>
__device__ __forceinline__ void store_nodes(float* __restrict__ y, int N,
                                            const Tile& t,
                                            float (&acc)[VDIM][K]) {
#pragma unroll
  for (int a = 0; a < VDIM; ++a) {
    float* ya = y + a * N + t.n0;
    if constexpr (K == 4) {
      if (t.interior && (reinterpret_cast<uintptr_t>(ya) & 15) == 0) {
        *reinterpret_cast<float4*>(ya) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
        continue;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (t.n0 + k < N) ya[k] = acc[a][k];
    }
  }
}

// --------------------------------------------------------------- shifts --

// constant weights, FMAs in (o, b, a) order.
template <int VDIM, int NOFF, int G, bool INTERIOR>
__device__ __forceinline__ void shifts_group(const Terms& terms,
                                             const float* __restrict__ x,
                                             const Tile& t, int N, int base,
                                             float (&acc)[VDIM][kNodes]) {
  constexpr int kSize = group_size(NOFF, G);
  constexpr int kFirst = group_first(NOFF, G);
  float xv[VDIM][kNodes + kSize - 1];
  group_spans<VDIM, kNodes, NOFF, G, INTERIOR>(x, t, N, base, xv);
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
  constexpr int kBlockNodes = kThreads * kNodes;
  const int B0 = blockIdx.x * kBlockNodes;
  const Tile t = make_tile(x, N, geo, B0 + threadIdx.x * kNodes, B0,
                           B0 + kBlockNodes);
  if (t.n0 >= N) return;
  float acc[VDIM][kNodes];
  zero<VDIM, kNodes>(acc);
  constexpr auto kGroups = std::make_integer_sequence<int, group_count(NOFF)>{};
  if (t.interior) {
    shifts_groups<VDIM, NOFF, true>(kGroups, terms, x, t, N, geo, acc);
  } else {
    shifts_groups<VDIM, NOFF, false>(kGroups, terms, x, t, N, geo, acc);
  }
  store_nodes<VDIM, kNodes>(y, N, t, acc);
}

// ------------------------------------------------------------ residentw --
//
// Replaces benchmarks/kernel_floor.py::_residentw_kernel (:148), which
// keeps a [n_off·v², B] tile in VMEM and reads it for every block of
// nodes.  Here a thread owns one slot s of the tile and walks the nodes
// n = s + jB of one range of repeats j: it loads the slot's n_off·v²
// weights once (coalesced: consecutive threads, consecutive slots), widens
// bf16 to float32 once, keeps them in registers (135 at v3) and uses them
// for every node it visits.  A slot's weights are read from memory once
// per repeat range instead of once per node: 2.2 MB × ranges a launch at
// the flagship's 135 × 4,096 tile instead of the 367 MB of cache reads a
// per-node weight load makes, which no on-chip store but the registers
// carries in time (shared memory at ~30 TB/s would take 0.012 ms for it).
// The host plan takes as many repeat ranges as the card holds blocks at
// once, so the grid runs in one wave and reloads the weights as few times
// as fill the card.
//
// With the weights on chip the probe moves what shifts moves: it is bound
// by its x reads through L1 (45 scalar loads a node at v3, each a warp's
// 32 consecutive values across two cache lines) at the occupancy its
// registers leave (214 at v3: 2 blocks of 128 an SM).  Measured and not
// taken (floor_ab.py): four consecutive slots a thread at v1 (span reuse,
// 60 registers of weights), slower than one; bf16 kept as packed pairs
// (68 registers), no faster than widened at the load; x staged in shared
// memory as csz does, which for a block's 128 consecutive nodes would copy
// about 5× x's bytes (halos of up to 131 values on three planes).

__device__ __forceinline__ float to_f32(float w) { return w; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 w) {
  return __bfloat162float(w);   // exact
}

// The weights of a thread's tile slot as float32, held in registers for
// every repeat.
template <typename WT, int NW>
struct SlotWeights {
  float w[NW];
  __device__ __forceinline__ void load(const WT* __restrict__ Wt, int B,
                                       int s) {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      w[i] = to_f32(__ldg(Wt + static_cast<size_t>(i) * B + s));
    }
  }
  __device__ __forceinline__ float operator()(int i) const { return w[i]; }
};

struct ResidentPlan {
  int B;           // tile slots
  int repeats;     // ⌈N / B⌉
  int per_range;   // repeats a block row (blockIdx.y) walks
};

template <int VDIM, int NOFF, int G, bool INTERIOR, typename SW>
__device__ __forceinline__ void residentw_group(const SW& w,
                                                const float* __restrict__ x,
                                                const Tile& t, int N, int base,
                                                float (&acc)[VDIM][1]) {
  constexpr int kSize = group_size(NOFF, G);
  constexpr int kFirst = group_first(NOFF, G);
  float xv[VDIM][kSize];
  group_spans<VDIM, 1, NOFF, G, INTERIOR>(x, t, N, base, xv);
#pragma unroll
  for (int s = 0; s < kSize; ++s) {
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
#pragma unroll
      for (int a = 0; a < VDIM; ++a) {
        acc[a][0] = fmaf(w(((kFirst + s) * VDIM + a) * VDIM + b), xv[b][s],
                         acc[a][0]);
      }
    }
  }
}

template <int VDIM, int NOFF, bool INTERIOR, typename SW, int... G>
__device__ __forceinline__ void residentw_groups(
    std::integer_sequence<int, G...>, const SW& w,
    const float* __restrict__ x, const Tile& t, int N, const Geometry& geo,
    float (&acc)[VDIM][1]) {
  (residentw_group<VDIM, NOFF, G, INTERIOR>(w, x, t, N, geo.base[G], acc),
   ...);
}

template <int VDIM, typename WT, int NOFF>
__global__ void __launch_bounds__(kThreads)
residentw_kernel(const WT* __restrict__ Wt, const float* __restrict__ x,
                 float* __restrict__ y, int N,
                 const __grid_constant__ Geometry geo, const ResidentPlan p) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= p.B) return;
  SlotWeights<WT, NOFF * VDIM * VDIM> w;
  w.load(Wt, p.B, s);
  constexpr auto kGroups = std::make_integer_sequence<int, group_count(NOFF)>{};
  const int j0 = static_cast<int>(blockIdx.y) * p.per_range;
  const int j1 = min(j0 + p.per_range, p.repeats);
  for (int j = j0; j < j1; ++j) {
    const int n = s + j * p.B;
    if (n >= N) break;
    const Tile t = make_tile(x, N, geo, n, n, n + 1);
    float acc[VDIM][1];
    zero<VDIM, 1>(acc);
    if (t.interior) {
      residentw_groups<VDIM, NOFF, true>(kGroups, w, x, t, N, geo, acc);
    } else {
      residentw_groups<VDIM, NOFF, false>(kGroups, w, x, t, N, geo, acc);
    }
    store_nodes<VDIM, 1>(y, N, t, acc);
  }
}

// ------------------------------------------------------------------ csz --
//
// Replaces benchmarks/kernel_floor.py::_csz_kernel (:202): three constant
// sums over the shifted x, joined by two streamed face masks.  Its bound
// is operations, 6·n_off·v² + 4v flops a node (0.0083 ms at the flagship's
// v3 level): x, y and the masks are 19 MB, inside the L2.  Read the way
// shifts reads x (4 consecutive nodes a thread, x spans through L1 with
// selects, an interior body and an edge body: 4,096 SASS instructions at
// v3), it spent 30 % of its time on the second body's instruction fetch
// and a quarter on the x spans' loads (floor_ab.py).  Here:
//
// - A block takes one run of csz_nodes(v)·kCszThreads consecutive nodes.
//   One thread copies, per component b, the segments of x the run reads
//   into shared memory with the Tensor Memory Accelerator (cp.async.bulk,
//   one mbarrier a segment): the row groups' windows [B0 + base_g, B0 +
//   run + base_g + size_g − 1), merged where they overlap (three segments
//   at 15 offsets on a 3D grid), each start rounded down to 16 bytes.
//   Only the 16-byte chunks inside [0, N) go by TMA; the block's threads
//   read the chunks across either end value by value and write zero
//   outside [0, N).  So the FMAs need no bounds test (one code path), and
//   away from the ends staging costs the threads no instructions.
// - The FMAs of a row group wait only for its own segment: the first
//   segment's groups run while the later segments are in flight.  The
//   thread's face masks are loaded while the copies fly.
// - Thread t takes nodes t, t + kCszThreads, ...: a warp reads 32
//   consecutive words of a segment, no bank conflicts, and each constant
//   (a kernel parameter, the operand of its FMAs) serves csz_nodes(v)
//   FMAs of one straight-line body.
// - No loop runs around the FMAs.  A persistent grid walking the runs in
//   a loop made the compiler hoist the 405 constants of v3 into registers
//   and spill them (2.2 KB of stack, 0.557 ms); with a two-stage TMA ring
//   and the constants in shared memory it took 0.0255 ms (floor_ab.py).
//
// What bounds it: FMA issue (405 a node at v3, three quarters of its
// instructions) and the partial last wave of blocks; see PERF.md.
//
// The plan (segments, their lengths and offsets, each group's place in its
// segment, the run count) comes from the host.

// nodes a csz thread takes: more where a node's work is small
__host__ __device__ constexpr int csz_nodes(int vdim) {
  return vdim == 1 ? 8 : 4;
}

// {wc, dz0, dz1, 0} of (o, b, a), in the order of the FMAs
struct FaceTerms {
  float4 t[kMaxTerms];
};

struct CszPlan {
  int n_seg;
  int row_floats;                // staged floats a component
  int seg_lo[kMaxGroups];        // first δ a segment holds
  int seg_chunk0[kMaxGroups];    // its first 16-byte chunk in the row
  int seg_chunks[kMaxGroups];
  int group_seg[kMaxGroups];
  int group_off[kMaxGroups];     // base_g − seg_lo of the group's segment
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One TMA copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// into shared memory, counted on the mbarrier at `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void wait_barrier(unsigned bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar) : "memory");
  }
}

// Where segment s of component b starts in x's row b for the run from B0
// (pos0, rounded down to 16 bytes), and its chunks [j_lo, j_hi) that lie
// inside [0, N).
struct SegmentSpan {
  int pos0, j_lo, j_hi;
};

__device__ __forceinline__ SegmentSpan segment_span(const CszPlan& p, int s,
                                                    int b, int sh, int N,
                                                    int B0) {
  SegmentSpan t;
  t.pos0 = ((sh + b * N + B0 + p.seg_lo[s]) & ~3) - sh - b * N;
  const int chunks = p.seg_chunks[s];
  t.j_lo = min(chunks, max(0, (3 - t.pos0) >> 2));
  t.j_hi = max(t.j_lo, min(chunks, (N - t.pos0) >> 2));
  return t;
}

// Stages the run from B0: x's segments [VDIM][row_floats], zero outside
// [0, N).  Per segment s thread 0 arrives on the mbarrier bar0 + 8s
// expecting the bytes of its chunks inside [0, N) and starts their TMA
// copies; every thread fills its share of the rest.  The caller syncs the
// block, then waits on a segment's mbarrier before it reads the segment.
template <int VDIM>
__device__ __forceinline__ void stage_run(float* buf, unsigned bar0,
                                          const CszPlan& p,
                                          const float* __restrict__ x, int sh,
                                          int N, int B0) {
  for (int s = 0; s < p.n_seg; ++s) {
    SegmentSpan t[VDIM];
    unsigned bytes = 0;
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
      t[b] = segment_span(p, s, b, sh, N, B0);
      bytes += 16u * (t[b].j_hi - t[b].j_lo);
    }
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar0 + 8 * s), "r"(bytes) : "memory");
    }
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
      float* dst = buf + b * p.row_floats + 4 * p.seg_chunk0[s];
      const float* src = x + b * N + t[b].pos0;
      if (threadIdx.x == 0 && t[b].j_hi > t[b].j_lo) {
        bulk_copy(dst + 4 * t[b].j_lo, src + 4 * t[b].j_lo,
                  16u * (t[b].j_hi - t[b].j_lo), bar0 + 8 * s);
      }
      const int edge = t[b].j_lo + p.seg_chunks[s] - t[b].j_hi;
      for (int e = threadIdx.x; e < edge; e += kCszThreads) {
        const int j = e < t[b].j_lo ? e : t[b].j_hi + e - t[b].j_lo;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int pos = t[b].pos0 + 4 * j + q;
          dst[4 * j + q] = pos >= 0 && pos < N ? __ldg(src + 4 * j + q) : 0.0f;
        }
      }
    }
  }
}

template <int VDIM, int NOFF, int K, int G>
__device__ __forceinline__ void csz_group(const float* buf, unsigned bar,
                                          const int (&at)[VDIM],
                                          const FaceTerms& terms,
                                          float (&acc)[VDIM][K],
                                          float (&az0)[VDIM][K],
                                          float (&az1)[VDIM][K]) {
  constexpr int kSize = group_size(NOFF, G);
  constexpr int kFirst = group_first(NOFF, G);
  wait_barrier(bar);
  float xv[VDIM][kSize][K];
#pragma unroll
  for (int b = 0; b < VDIM; ++b) {
#pragma unroll
    for (int s = 0; s < kSize; ++s) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        xv[b][s][k] = buf[at[b] + threadIdx.x + k * kCszThreads + s];
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kSize; ++s) {
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
#pragma unroll
      for (int a = 0; a < VDIM; ++a) {
        const float4 c = terms.t[((kFirst + s) * VDIM + b) * VDIM + a];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float xs = xv[b][s][k];
          acc[a][k] = fmaf(c.x, xs, acc[a][k]);
          az0[a][k] = fmaf(c.y, xs, az0[a][k]);
          az1[a][k] = fmaf(c.z, xs, az1[a][k]);
        }
      }
    }
  }
}

template <int VDIM, int NOFF, int K, int... G>
__device__ __forceinline__ void csz_groups(
    std::integer_sequence<int, G...>, const float* buf, unsigned bar0,
    const CszPlan& p, int sh, int N, int B0, const FaceTerms& terms,
    float (&acc)[VDIM][K], float (&az0)[VDIM][K], float (&az1)[VDIM][K]) {
  // where x[b, B0 + base_g] lies in shared memory
  int at[sizeof...(G)][VDIM];
#pragma unroll
  for (int g = 0; g < static_cast<int>(sizeof...(G)); ++g) {
    const int s = p.group_seg[g];
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
      at[g][b] = b * p.row_floats + 4 * p.seg_chunk0[s] +
                 ((sh + b * N + B0 + p.seg_lo[s]) & 3) + p.group_off[g];
    }
  }
  (csz_group<VDIM, NOFF, K, G>(buf, bar0 + 8 * p.group_seg[G], at[G], terms,
                               acc, az0, az1),
   ...);
}

template <int VDIM, int NOFF>
__global__ void __launch_bounds__(kCszThreads)
csz_kernel(const float* __restrict__ m, int N_pad,
           const float* __restrict__ x, float* __restrict__ y, int N,
           const __grid_constant__ CszPlan p,
           const __grid_constant__ FaceTerms terms) {
  constexpr int K = csz_nodes(VDIM);
  extern __shared__ float4 smem4[];
  __shared__ alignas(8) unsigned long long full[kMaxGroups];
  float* const buf = reinterpret_cast<float*>(smem4);
  const unsigned bar0 = smem_addr(full);   // a segment's: bar0 + 8·s
  const int sh = static_cast<int>((reinterpret_cast<uintptr_t>(x) & 15) >> 2);
  const int B0 = blockIdx.x * K * kCszThreads;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.n_seg; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(bar0 + 8 * s) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  stage_run<VDIM>(buf, bar0, p, x, sh, N, B0);
  float m0[K], m1[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = B0 + threadIdx.x + k * kCszThreads;   // < N_pad or past N
    m0[k] = n < N ? __ldcs(m + n) : 0.0f;
    m1[k] = n < N ? __ldcs(m + N_pad + n) : 0.0f;
  }
  float acc[VDIM][K], az0[VDIM][K], az1[VDIM][K];
  zero<VDIM, K>(acc);
  zero<VDIM, K>(az0);
  zero<VDIM, K>(az1);
  __syncthreads();   // the threads' edge chunks, and the mbarriers' init
  csz_groups<VDIM, NOFF, K>(
      std::make_integer_sequence<int, group_count(NOFF)>{}, buf, bar0, p, sh,
      N, B0, terms, acc, az0, az1);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = B0 + threadIdx.x + k * kCszThreads;
    if (n < N) {
#pragma unroll
      for (int a = 0; a < VDIM; ++a) {
        y[a * N + n] = fmaf(m1[k], az1[a][k], fmaf(m0[k], az0[a][k], acc[a][k]));
      }
    }
  }
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

// residentw's plan: {threads, slot blocks, repeats, repeat ranges,
// repeats a range}; the grid is (slot blocks, ranges).
bool check_resident_plan(const int* plan, long long B, int N,
                         ResidentPlan* rp, dim3* grid) {
  const int T = plan[0], slot_blocks = plan[1], repeats = plan[2];
  const int ranges = plan[3], per_range = plan[4];
  if (T != kThreads || slot_blocks != (B + kThreads - 1) / kThreads ||
      repeats != (N + B - 1) / B || ranges < 1 || ranges > 65535 ||
      per_range < 1 || per_range > repeats ||
      static_cast<long long>(ranges) * per_range < repeats ||
      static_cast<long long>(ranges - 1) * per_range >= repeats) {
    return false;
  }
  *rp = {static_cast<int>(B), repeats, per_range};
  *grid = dim3(slot_blocks, ranges);
  return true;
}

template <int VDIM, typename WT, int NOFF>
void residentw_launch(const Call& c, const void* Wt, const ResidentPlan& rp,
                      dim3 grid) {
  residentw_kernel<VDIM, WT, NOFF><<<grid, kThreads, 0, c.stream>>>(
      static_cast<const WT*>(Wt), c.x, c.y, c.N, c.geo, rp);
}

template <int VDIM, int NOFF>
bool residentw_if(const Call& c, const void* Wt, int w_is_bf16,
                  const ResidentPlan& rp, dim3 grid) {
  if (c.vdim != VDIM || c.n_off != NOFF) return false;
  if (w_is_bf16) {
    residentw_launch<VDIM, __nv_bfloat16, NOFF>(c, Wt, rp, grid);
  } else {
    residentw_launch<VDIM, float, NOFF>(c, Wt, rp, grid);
  }
  return true;
}

template <int VDIM, int... NOFFS>
bool residentw_noff(const Call& c, const void* Wt, int w_is_bf16,
                    const ResidentPlan& rp, dim3 grid) {
  return (residentw_if<VDIM, NOFFS>(c, Wt, w_is_bf16, rp, grid) || ...);
}

template <int... VDIMS>
bool residentw_dispatch(const Call& c, const void* Wt, int w_is_bf16,
                        const ResidentPlan& rp, dim3 grid) {
  return (residentw_noff<VDIMS, FLOOR_PROBE_NOFFS>(c, Wt, w_is_bf16, rp,
                                                   grid) || ...);
}

// csz's plan: {threads, nodes a thread, run, runs, segments, row_floats,
// shared bytes}, then per segment (kMaxGroups slots each) its first δ,
// first chunk and chunk count, then per row group its segment and its
// offset in that segment.  Checked so that every read of every node of a
// run lands inside its group's segment whatever the 16-byte shift of the
// segment's start (0..3 values).
bool check_csz_plan(const int* plan, int vdim, int N, const Geometry& geo,
                    int n_off, CszPlan* cp, int* runs, int* smem) {
  const int* seg = plan + 7;
  const int* grp = plan + 7 + 3 * kMaxGroups;
  const int n_groups = group_count(n_off);
  const int run = kCszThreads * csz_nodes(vdim);
  *cp = {};
  *runs = plan[3];
  cp->n_seg = plan[4];
  cp->row_floats = plan[5];
  *smem = plan[6];
  if (plan[0] != kCszThreads || plan[1] != csz_nodes(vdim) || plan[2] != run ||
      *runs != (N + run - 1) / run || cp->n_seg < 1 ||
      cp->n_seg > n_groups) {
    return false;
  }
  int chunk = 0;
  for (int s = 0; s < cp->n_seg; ++s) {
    cp->seg_lo[s] = seg[s];
    cp->seg_chunk0[s] = seg[kMaxGroups + s];
    cp->seg_chunks[s] = seg[2 * kMaxGroups + s];
    if (cp->seg_chunk0[s] != chunk || cp->seg_chunks[s] < 1) return false;
    chunk += cp->seg_chunks[s];
  }
  if (cp->row_floats != 4 * chunk ||
      static_cast<long long>(*smem) != 4LL * vdim * cp->row_floats ||
      *smem > kMaxSmem) {
    return false;
  }
  for (int g = 0; g < n_groups; ++g) {
    const int s = grp[g];
    const int off = grp[kMaxGroups + g];
    if (s < 0 || s >= cp->n_seg || off != geo.base[g] - cp->seg_lo[s] ||
        off < 0 || 3 + off + run + group_size(n_off, g) - 1 >
                       4 * cp->seg_chunks[s]) {
      return false;
    }
    cp->group_seg[g] = s;
    cp->group_off[g] = off;
  }
  return true;
}

template <int VDIM, int NOFF>
bool csz_if(const Call& c, const float* m, int N_pad, const CszPlan& cp,
            int runs, int smem, const FaceTerms& terms, bool* ok) {
  if (c.vdim != VDIM || c.n_off != NOFF) return false;
  *ok = cudaFuncSetAttribute(csz_kernel<VDIM, NOFF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) == cudaSuccess;
  if (*ok) {
    csz_kernel<VDIM, NOFF><<<runs, kCszThreads, smem, c.stream>>>(
        m, N_pad, c.x, c.y, c.N, cp, terms);
  }
  return true;
}

template <int VDIM, int... NOFFS>
bool csz_noff(const Call& c, const float* m, int N_pad, const CszPlan& cp,
              int runs, int smem, const FaceTerms& terms, bool* ok) {
  return (csz_if<VDIM, NOFFS>(c, m, N_pad, cp, runs, smem, terms, ok) ||
          ...);
}

template <int... VDIMS>
bool csz_dispatch(const Call& c, const float* m, int N_pad, const CszPlan& cp,
                  int runs, int smem, const FaceTerms& terms, bool* ok) {
  return (csz_noff<VDIMS, FLOOR_PROBE_NOFFS>(c, m, N_pad, cp, runs, smem,
                                             terms, ok) || ...);
}

// Blocks of residentw an SM holds at once, for the host's plan.
template <int VDIM, int NOFF>
bool occupancy_if(int vdim, int n_off, int w_is_bf16, int* blocks) {
  if (vdim != VDIM || n_off != NOFF) return false;
  const cudaError_t e =
      w_is_bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      blocks, residentw_kernel<VDIM, __nv_bfloat16, NOFF>,
                      kThreads, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      blocks, residentw_kernel<VDIM, float, NOFF>, kThreads,
                      0);
  if (e != cudaSuccess) *blocks = 0;
  return true;
}

template <int VDIM, int... NOFFS>
bool occupancy_noff(int vdim, int n_off, int w_is_bf16, int* blocks) {
  return (occupancy_if<VDIM, NOFFS>(vdim, n_off, w_is_bf16, blocks) || ...);
}

template <int... VDIMS>
bool occupancy_dispatch(int vdim, int n_off, int w_is_bf16, int* blocks) {
  return (occupancy_noff<VDIMS, FLOOR_PROBE_NOFFS>(vdim, n_off, w_is_bf16,
                                                   blocks) || ...);
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

// The blocks of residentw (of its weight type) an SM holds at once.
extern "C" int floor_residentw_blocks_per_sm(int vdim, int n_off,
                                             int w_is_bf16, int* blocks) {
  *blocks = 0;
  if (!occupancy_dispatch<FLOOR_PROBE_VDIMS>(vdim, n_off, w_is_bf16,
                                             blocks)) {
    return kInvalid;
  }
  return *blocks > 0 ? 0 : kInvalid;
}

extern "C" int floor_residentw(const void* Wt, int w_is_bf16, long long B,
                               int vdim, const void* x, void* y, long long N,
                               const int* deltas, int n_off, const int* plan,
                               int plan_len, void* stream) {
  Call c;
  ResidentPlan rp;
  dim3 grid;
  if (!make_call(vdim, x, y, N, deltas, n_off, stream, &c) || B < 4 ||
      B % 4 != 0 || B > kMaxIndex ||
      (reinterpret_cast<uintptr_t>(Wt) & 15) != 0 ||
      plan_len != kResidentPlanLen ||
      !check_resident_plan(plan, B, c.N, &rp, &grid) ||
      !residentw_dispatch<FLOOR_PROBE_VDIMS>(c, Wt, w_is_bf16, rp, grid)) {
    return kInvalid;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int floor_csz(const void* m, long long N_pad, int vdim,
                         const void* x, void* y, long long N,
                         const int* deltas, int n_off, const float* wc,
                         const float* dz0, const float* dz1, const int* plan,
                         int plan_len, void* stream) {
  Call c;
  CszPlan cp;
  int runs, smem;
  if (!make_call(vdim, x, y, N, deltas, n_off, stream, &c) || N_pad < N ||
      N_pad % kPlaneAlign != 0 || N_pad > kMaxIndex ||
      (reinterpret_cast<uintptr_t>(m) & 15) != 0 || plan_len != kCszPlanLen ||
      !check_csz_plan(plan, vdim, c.N, c.geo, n_off, &cp, &runs, &smem)) {
    return kInvalid;
  }
  // the constants of (o, b, a) in the order of the FMAs
  FaceTerms terms = {};
  for (int o = 0; o < n_off; ++o) {
    for (int b = 0; b < vdim; ++b) {
      for (int a = 0; a < vdim; ++a) {
        const int k = (o * vdim + a) * vdim + b;
        terms.t[(o * vdim + b) * vdim + a] =
            make_float4(wc[k], dz0[k], dz1[k], 0.0f);
      }
    }
  }
  bool ok = false;
  if (!csz_dispatch<FLOOR_PROBE_VDIMS>(c, static_cast<const float*>(m),
                                       static_cast<int>(N_pad), cp, runs,
                                       smem, terms, &ok) || !ok) {
    return kInvalid;
  }
  return static_cast<int>(cudaGetLastError());
}
