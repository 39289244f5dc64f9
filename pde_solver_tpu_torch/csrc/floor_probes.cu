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
// wonly replaces benchmarks/kernel_floor.py::_wonly_kernel, which shares
// the TPU kernel's [rows, 128] tiling; none of that is carried over.  A
// thread owns 16 bytes of every plane (4 nodes at f32, 8 at bf16), one
// 16-byte streaming load per plane and thread, eight planes in flight: it
// is bound by the bytes of W.
//
// shifts, residentw and csz, and what bounds them, are described at their
// kernels.  residentw reads x through L1/L2 by the row groups of the sorted
// P1 stencil (stencil_span.cuh), as the dense kernel does; shifts and csz
// stage the x a run of nodes reads in shared memory by TMA.

// C interface for ctypes: each function launches on the given stream, does
// not synchronise, allocates nothing, and returns cudaGetLastError() (0 on
// success) or cudaErrorInvalidValue for arguments, or a launch plan, it is
// not built for.  shifts, residentw and csz take the plan that
// ops/floor_probes.py computes on the host and check it against their own
// arithmetic.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "stencil_span.cuh"

#define FLOOR_PROBE_VDIMS 1, 2, 3
#define FLOOR_PROBE_NOFFS 3, 7, 15
// shifts stages x at these vdims; at v1 it reads x spans through L1
#define SHIFTS_STAGED_VDIMS 2, 3

namespace {

constexpr int kThreads = 128;
constexpr int kPlaneAlign = 128;   // N_pad is a multiple of this
constexpr int kMaxGroups = 8;
constexpr int kMaxTerms = 15 * 3 * 3;
constexpr long long kMaxIndex = 1LL << 30;   // v·N_pad and |δ| stay below
constexpr int kMaxSmem = 232448;             // dynamic shared memory a block

// csz and shifts: a block stages the x of a run of consecutive nodes;
// thread t takes nodes t, t + threads, ... of the run
constexpr int kCszThreads = 128;
constexpr int kShiftsThreads = 128;
constexpr int kMaxStages = 6;      // windows in a shifts block's ring

// the lengths of the plan arrays (ops/floor_probes.py builds them)
constexpr int kResidentPlanLen = 5;
constexpr int kCszPlanLen = 7 + 5 * kMaxGroups;
constexpr int kShiftsPlanLen = 14 + 2 * kMaxGroups;

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

// What a thread of residentw, or of shifts at v1, works on: its first
// node, whether every x span of its nodes' range lies inside [0, N) (then
// read with no bounds test, as aligned chunks where a thread has several
// nodes), and x's 16-byte aligned base.
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

// ------------------------------------------------------------- staged x --
//
// shifts and csz stage the x a run of consecutive nodes reads in shared
// memory, as spans of x (stage_span): one thread copies a span of every
// component with the Tensor Memory Accelerator (cp.async.bulk, one
// mbarrier a span), its start rounded down to 16 bytes.  Only the 16-byte
// chunks inside [0, N) go by TMA; the block's threads read the chunks
// across either end value by value and write zero outside [0, N).  So the
// FMAs need no bounds test (one code path), and away from the ends staging
// costs the threads no instructions.  Thread t of T takes nodes t, t + T,
// ... of the run: a warp reads 32 consecutive words of a span, with no
// bank conflicts and no selects.
//
// csz stages, a run, the row groups' windows [B0 + base_g, B0 + run +
// base_g + size_g − 1) merged where they overlap (three segments at 15
// offsets on a 3D grid): the segments (their first δ, lengths and places
// in the staged row, each row group's place in its segment) come from the
// host's plan.  shifts stages one window a plane (see there).

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

// Waits until the phase of parity `parity` of the mbarrier at `bar` has
// completed.
__device__ __forceinline__ void wait_barrier(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Thread 0 initialises `count` mbarriers from bar0 (8 bytes apart) for one
// arrival each and makes them visible to the async proxy.  The block syncs
// before another thread waits on one.
__device__ __forceinline__ void init_barriers(unsigned bar0, int count) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < count; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(bar0 + 8 * i) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
}

// Where a span of x from node `start` of row b begins (pos0, rounded down
// to 16 bytes), and its chunks [j_lo, j_hi) of the `chunks` it has that lie
// inside [0, N).
struct ChunkSpan {
  int pos0, j_lo, j_hi;
};

__device__ __forceinline__ ChunkSpan chunk_span(int b, int sh, int N,
                                                int start, int chunks) {
  ChunkSpan t;
  t.pos0 = ((sh + b * N + start) & ~3) - sh - b * N;
  t.j_lo = min(chunks, max(0, (3 - t.pos0) >> 2));
  t.j_hi = max(t.j_lo, min(chunks, (N - t.pos0) >> 2));
  return t;
}

// One arrival on the mbarrier at `bar`, announcing `bytes` of TMA copies
// to come.
__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Stages `chunks` 16-byte chunks of every row b of x from node `start`
// (rounded down to 16 bytes) at buf + b·row_floats, zero outside [0, N),
// by a block of THREADS threads: thread 0 arrives on the mbarrier `bar`
// announcing the bytes of the chunks inside [0, N) and starts their TMA
// copies; every thread fills its share of the rest.  Returns whether any
// chunk was filled so (the same answer in every thread): the block syncs
// before it reads those, and waits on the mbarrier before it reads the
// span.
template <int VDIM, int THREADS>
__device__ __forceinline__ bool stage_span(float* buf, int row_floats,
                                           unsigned bar,
                                           const float* __restrict__ x,
                                           int sh, int N, int start,
                                           int chunks) {
  if (start >= 3 && start + 4 * chunks <= N) {   // every chunk inside
    if (threadIdx.x == 0) {
      expect_bytes(bar, 16u * VDIM * chunks);
#pragma unroll
      for (int b = 0; b < VDIM; ++b) {
        const int pos0 = ((sh + b * N + start) & ~3) - sh - b * N;
        bulk_copy(buf + b * row_floats, x + b * N + pos0, 16u * chunks, bar);
      }
    }
    return false;
  }
  ChunkSpan t[VDIM];
  unsigned bytes = 0;
#pragma unroll
  for (int b = 0; b < VDIM; ++b) {
    t[b] = chunk_span(b, sh, N, start, chunks);
    bytes += 16u * (t[b].j_hi - t[b].j_lo);
  }
  if (threadIdx.x == 0) expect_bytes(bar, bytes);
  bool filled = false;
#pragma unroll
  for (int b = 0; b < VDIM; ++b) {
    float* dst = buf + b * row_floats;
    const float* src = x + b * N + t[b].pos0;
    if (threadIdx.x == 0 && t[b].j_hi > t[b].j_lo) {
      bulk_copy(dst + 4 * t[b].j_lo, src + 4 * t[b].j_lo,
                16u * (t[b].j_hi - t[b].j_lo), bar);
    }
    const int edge = t[b].j_lo + chunks - t[b].j_hi;
    filled |= edge > 0;
    for (int e = threadIdx.x; e < edge; e += THREADS) {
      const int j = e < t[b].j_lo ? e : t[b].j_hi + e - t[b].j_lo;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int pos = t[b].pos0 + 4 * j + q;
        dst[4 * j + q] = pos >= 0 && pos < N ? __ldg(src + 4 * j + q) : 0.0f;
      }
    }
  }
  return filled;
}

// Stages the run from B0: x's segments [VDIM][row_floats], segment s on
// the mbarrier bar0 + 8s (stage_span).  The caller syncs the block, then
// waits on a segment's mbarrier before it reads the segment.
template <int VDIM>
__device__ __forceinline__ void stage_run(float* buf, unsigned bar0,
                                          const CszPlan& p,
                                          const float* __restrict__ x, int sh,
                                          int N, int B0) {
  for (int s = 0; s < p.n_seg; ++s) {
    stage_span<VDIM, kCszThreads>(buf + 4 * p.seg_chunk0[s], p.row_floats,
                                  bar0 + 8 * s, x, sh, N, B0 + p.seg_lo[s],
                                  p.seg_chunks[s]);
  }
}

// ------------------------------------------------------------------ csz --
//
// Replaces benchmarks/kernel_floor.py::_csz_kernel (:202): three constant
// sums over the shifted x, joined by two streamed face masks.  Its bound
// is operations, 6·n_off·v² + 4v flops a node (0.0083 ms at the flagship's
// v3 level): x, y and the masks are 19 MB, inside the L2.  Read the way
// the earlier shifts read x (4 consecutive nodes a thread, x spans through
// L1 with selects, an interior body and an edge body: 4,096 SASS
// instructions at v3), it spent 30 % of its time on the second body's
// instruction fetch and a quarter on the x spans' loads (floor_ab.py).
// Here:
//
// - A block takes one run of csz_nodes(v)·kCszThreads consecutive nodes
//   and stages its x (see "staged x").
// - The FMAs of a row group wait only for its own segment: the first
//   segment's groups run while the later segments are in flight.  The
//   thread's face masks are loaded while the copies fly.
// - Each constant (a kernel parameter, the operand of its FMAs) serves
//   csz_nodes(v) FMAs of one straight-line body.
// - No loop runs around the FMAs.  A persistent grid walking the runs in
//   a loop made the compiler hoist the 405 constants of v3 into registers
//   and spill them (2.2 KB of stack, 0.557 ms); with a two-stage TMA ring
//   and the constants in shared memory it took 0.0255 ms (floor_ab.py).
//
// What bounds it: FMA issue (405 a node at v3, three quarters of its
// instructions) and the partial last wave of blocks; see PERF.md.

// nodes a csz thread takes: more where a node's work is small
__host__ __device__ constexpr int csz_nodes(int vdim) {
  return vdim == 1 ? 8 : 4;
}

// {wc, dz0, dz1, 0} of (o, b, a), in the order of the FMAs
struct FaceTerms {
  float4 t[kMaxTerms];
};

template <int VDIM, int NOFF, int K, int G>
__device__ __forceinline__ void csz_group(const float* buf, unsigned bar,
                                          const int (&at)[VDIM],
                                          const FaceTerms& terms,
                                          float (&acc)[VDIM][K],
                                          float (&az0)[VDIM][K],
                                          float (&az1)[VDIM][K]) {
  constexpr int kSize = group_size(NOFF, G);
  constexpr int kFirst = group_first(NOFF, G);
  wait_barrier(bar, 0);
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
  init_barriers(bar0, p.n_seg);
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

// --------------------------------------------------------------- shifts --
//
// Replaces benchmarks/kernel_floor.py::_shifts_kernel (:98), the shifted
// sum with constant weights: no weight stream, so it moves only x and y
// (16 MB at the flagship's v3 level, inside the L2) and does 135 FMAs a
// node at v3.  Its floors on this card: the launch with the y stores
// (about 0.004 ms), the x staged from L2, the shared memory reads (45
// words a node at v3, one per (o, b)) and FMA issue (0.0027 ms); what
// sets the time is how far they overlap (floor_ab.py; PERF.md).  Staged
// as csz stages x, three segments a run (3.6× x's bytes), the copies
// alone took as long as the whole kernel, so at v2 and v3 a block walks a
// column of runs a plane apart and stages each plane's x once for the
// three runs that read it:
//
// - The 15 offsets of the sorted P1 stencil on a 3D grid lie in three
//   planes (group_plane): the run from B0 reads x in B0 + m·S + [wlo,
//   whi) for m = −1, 0, 1, with S about the plane stride and [wlo, whi)
//   the run widened by the in-plane offsets (run + 133 nodes at the
//   flagship); on a 2D grid the rows play the planes, on a 1D grid m is 0
//   alone.  The host's plan finds S and the window from the row groups
//   (S is the run where the planes are shorter than a run).
// - Block b takes column c = b mod columns, the runs from B0 = c·run +
//   j·S (each up to the next multiple of S) of one range of planes j.  A
//   ring of `stages` windows holds the planes j − 1, j, j + 1 and the next
//   one in flight; after the run of plane j the window of plane j − 1 is
//   refilled with the plane `stages` later.  One TMA copy a plane and
//   component, one mbarrier a slot whose phase flips each time the ring
//   wraps: x crosses from L2 (L + 2) / L times for a range of L planes
//   instead of three.
// - The grid is one wave of about four blocks an SM (the host's plan,
//   from the occupancy query), the planes cut into ranges longest first,
//   so that where the card gives block b to SM b mod SMs no SM takes more
//   than ⌈runs / SMs⌉ runs.
// - Thread t takes the nodes t, t + kShiftsThreads, ... of a run: a warp
//   reads 32 consecutive words of a window, no bank conflicts, no
//   selects, one code path (zero fill at the ends, as csz).  The waits
//   come before the FMAs of a run, so the loads of one row group can be
//   scheduled beside the FMAs of another.
// - The constants stay kernel parameters, the operands of their FMAs; the
//   sum runs in (o, b, a) order with fmaf, so that csz with zero face sets
//   equals it bit for bit.
//
// At v1 shifts keeps the span path through L1 (shifts_kernel_spans).

constexpr int kShiftsNodes = 4;   // nodes a shifts thread takes in a run

// The planes of the row groups of the sorted P1 stencil: on a 3D grid (15
// offsets) groups 0 and 1 lie in the plane below, 2–4 in the node's, 5
// and 6 above; on a 2D grid (7) the rows below, at and above the node; on
// a 1D grid (3) one group.  A run of plane j reads the planes j −
// plane_spread ... j + plane_spread.
__host__ __device__ constexpr int below_groups(int n_off) {
  return n_off == 15 ? 2 : n_off == 7 ? 1 : 0;
}
__host__ __device__ constexpr int group_plane(int n_off, int g) {
  return g < below_groups(n_off) ? -1
         : g >= group_count(n_off) - below_groups(n_off) ? 1 : 0;
}
__host__ __device__ constexpr int plane_spread(int n_off) {
  return below_groups(n_off) > 0 ? 1 : 0;
}

struct ShiftsPlan {
  int stride;                      // S: from one plane's run to the next
  int columns;                     // runs a plane: ⌈S / run⌉
  int planes;                      // ⌈N / S⌉
  int ranges;                      // plane ranges a column is cut into
  int stages;                      // windows in a block's ring
  int win_lo;                      // a window's first δ from its run's B0
  int row_floats;                  // staged floats a window and component
  int group_off[kMaxGroups];       // base_g − group_plane(g)·S − win_lo
};

template <int VDIM, int NOFF, int K, int G>
__device__ __forceinline__ void shifts_group(const float* buf,
                                             const int (&at)[VDIM],
                                             const Terms& terms,
                                             float (&acc)[VDIM][K]) {
  constexpr int kSize = group_size(NOFF, G);
  constexpr int kFirst = group_first(NOFF, G);
  float xv[VDIM][kSize][K];
#pragma unroll
  for (int b = 0; b < VDIM; ++b) {
#pragma unroll
    for (int s = 0; s < kSize; ++s) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        xv[b][s][k] = buf[at[b] + threadIdx.x + k * kShiftsThreads + s];
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kSize; ++s) {
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
#pragma unroll
      for (int a = 0; a < VDIM; ++a) {
        const float w = terms.wc[((kFirst + s) * VDIM + a) * VDIM + b];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          acc[a][k] = fmaf(w, xv[b][s][k], acc[a][k]);
        }
      }
    }
  }
}

// The sum of a run: row group g reads the window of plane j +
// group_plane(g), which starts at `place[d][b]` of the ring (d = its plane
// + plane_spread), from group_off[g] on.
template <int VDIM, int NOFF, int K, int D, int... G>
__device__ __forceinline__ void shifts_groups(
    std::integer_sequence<int, G...>, const float* buf,
    const int (&place)[D][VDIM], const ShiftsPlan& p, const Terms& terms,
    float (&acc)[VDIM][K]) {
  int at[sizeof...(G)][VDIM];
#pragma unroll
  for (int g = 0; g < static_cast<int>(sizeof...(G)); ++g) {
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
      at[g][b] = place[group_plane(NOFF, g) + plane_spread(NOFF)][b] +
                 p.group_off[g];
    }
  }
  (shifts_group<VDIM, NOFF, K, G>(buf, at[G], terms, acc), ...);
}

// Block b takes column b mod columns and the range r = b div columns of
// its planes: the planes are cut into `ranges` ranges, the first planes
// mod ranges of them one plane longer, so that where the card gives block
// b to SM b mod SMs the longer ranges spread over the SMs.  The block
// walks its range through a ring of `stages` windows: the planes j − 1 ...
// j + 1 its runs read, staged plane after plane, each window once.
template <int VDIM, int NOFF>
__device__ __forceinline__ void shifts_staged(const float* __restrict__ x,
                                              float* __restrict__ y, int N,
                                              const ShiftsPlan& p,
                                              const Terms& terms) {
  constexpr int K = kShiftsNodes;
  constexpr int kRun = K * kShiftsThreads;
  constexpr int kSpread = plane_spread(NOFF);
  constexpr int kRead = 2 * kSpread + 1;   // windows a run reads
  extern __shared__ float4 smem4[];
  __shared__ alignas(8) unsigned long long full[kMaxStages];   // a slot's
  float* const buf = reinterpret_cast<float*>(smem4);
  const unsigned bar0 = smem_addr(full);
  const int sh = static_cast<int>((reinterpret_cast<uintptr_t>(x) & 15) >> 2);
  const int chunks = p.row_floats / 4;
  const int window = VDIM * p.row_floats;
  const int c0 = (blockIdx.x % p.columns) * kRun;
  const int width = min(kRun, p.stride - c0);   // the column's nodes a run
  const int r = blockIdx.x / p.columns;
  const int per = p.planes / p.ranges;
  const int longer = p.planes % p.ranges;   // ranges of per + 1 planes
  const int j0 = r * per + min(r, longer);
  const int j1 = j0 + per + (r < longer);
  // the planes staged, q0 ... q_end − 1, plane q in slot (q − q0) mod
  // stages; a window starts at node c0 + q·S + win_lo
  const int q0 = j0 - kSpread;
  const int q_end = j1 + kSpread;
  const int first = c0 + p.win_lo;
  init_barriers(bar0, p.stages);
  for (int i = 0; i < p.stages && q0 + i < q_end; ++i) {
    stage_span<VDIM, kShiftsThreads>(buf + i * window, p.row_floats,
                                     bar0 + 8 * i, x, sh, N,
                                     first + (q0 + i) * p.stride, chunks);
  }
  __syncthreads();   // the threads' edge chunks, and the mbarriers' init
  int lo = 0;          // the slot of plane j − kSpread: (j − j0) mod stages
  unsigned wraps = 0;  // (j − j0) div stages
  for (int j = j0; j < j1; ++j) {
    // wait for the windows of the planes j − kSpread ... j + kSpread, and
    // where x[b, c0 + (j + d − kSpread)·S + win_lo] lies in the ring
    int place[kRead][VDIM];
#pragma unroll
    for (int d = 0; d < kRead; ++d) {
      const int i = lo + d;
      const int slot = i < p.stages ? i : i - p.stages;
      wait_barrier(bar0 + 8 * slot, (wraps + (i >= p.stages)) & 1u);
      const int start = first + (j - kSpread + d) * p.stride;
#pragma unroll
      for (int b = 0; b < VDIM; ++b) {
        place[d][b] = slot * window + b * p.row_floats +
                      ((sh + b * N + start) & 3);
      }
    }
    float acc[VDIM][K];
    zero<VDIM, K>(acc);
    shifts_groups<VDIM, NOFF, K>(
        std::make_integer_sequence<int, group_count(NOFF)>{}, buf, place, p,
        terms, acc);
    const int B0 = c0 + j * p.stride;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * kShiftsThreads;
      if (i < width && B0 + i < N) {
#pragma unroll
        for (int a = 0; a < VDIM; ++a) y[a * N + B0 + i] = acc[a][k];
      }
    }
    // the window of plane j − kSpread is read no more: refill its slot
    // with the plane `stages` later
    const int q = j - kSpread + p.stages;
    if (q < q_end) {
      __syncthreads();   // every thread is done with that window
      if (stage_span<VDIM, kShiftsThreads>(buf + lo * window, p.row_floats,
                                           bar0 + 8 * lo, x, sh, N,
                                           first + q * p.stride, chunks)) {
        __syncthreads();   // the edge chunks, before the window is read
      }
    }
    if (++lo == p.stages) {
      lo = 0;
      ++wraps;
    }
  }
}

// At v1 the staged runs lose to x read through L1 (floor_ab.py: a node's
// 15 FMAs do not cover the staging's waits and syncs), so v1 keeps the
// span path: a thread owns kSpanNodes consecutive nodes and reads each
// row group's x span as aligned 16-byte chunks shifted into place by
// selects (stencil_span.cuh), one block a run of kShiftsThreads·kSpanNodes
// nodes, an interior body and an edge body.  It takes no plan.
constexpr int kSpanNodes = 4;

template <int VDIM, int NOFF, int G, bool INTERIOR>
__device__ __forceinline__ void span_group(const Terms& terms,
                                           const float* __restrict__ x,
                                           const Tile& t, int N, int base,
                                           float (&acc)[VDIM][kSpanNodes]) {
  constexpr int kSize = group_size(NOFF, G);
  constexpr int kFirst = group_first(NOFF, G);
  float xv[VDIM][kSpanNodes + kSize - 1];
  group_spans<VDIM, kSpanNodes, NOFF, G, INTERIOR>(x, t, N, base, xv);
#pragma unroll
  for (int s = 0; s < kSize; ++s) {
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
#pragma unroll
      for (int a = 0; a < VDIM; ++a) {
        const float w = terms.wc[((kFirst + s) * VDIM + a) * VDIM + b];
#pragma unroll
        for (int k = 0; k < kSpanNodes; ++k) {
          acc[a][k] = fmaf(w, xv[b][s + k], acc[a][k]);
        }
      }
    }
  }
}

template <int VDIM, int NOFF, bool INTERIOR, int... G>
__device__ __forceinline__ void span_groups(
    std::integer_sequence<int, G...>, const Terms& terms,
    const float* __restrict__ x, const Tile& t, int N, const Geometry& geo,
    float (&acc)[VDIM][kSpanNodes]) {
  (span_group<VDIM, NOFF, G, INTERIOR>(terms, x, t, N, geo.base[G], acc),
   ...);
}

template <int NOFF>
__global__ void __launch_bounds__(kShiftsThreads)
shifts_kernel_spans(const float* __restrict__ x, float* __restrict__ y,
                    int N, const __grid_constant__ Geometry geo,
                    const __grid_constant__ Terms terms) {
  constexpr int kBlockNodes = kShiftsThreads * kSpanNodes;
  const int B0 = blockIdx.x * kBlockNodes;
  const Tile t = make_tile(x, N, geo, B0 + threadIdx.x * kSpanNodes, B0,
                           B0 + kBlockNodes);
  if (t.n0 >= N) return;
  float acc[1][kSpanNodes];
  zero<1, kSpanNodes>(acc);
  constexpr auto kGroups = std::make_integer_sequence<int, group_count(NOFF)>{};
  if (t.interior) {
    span_groups<1, NOFF, true>(kGroups, terms, x, t, N, geo, acc);
  } else {
    span_groups<1, NOFF, false>(kGroups, terms, x, t, N, geo, acc);
  }
  store_nodes<1, kSpanNodes>(y, N, t, acc);
}

template <int VDIM, int NOFF>
__global__ void __launch_bounds__(kShiftsThreads)
shifts_kernel(const float* __restrict__ x, float* __restrict__ y, int N,
              const __grid_constant__ ShiftsPlan p,
              const __grid_constant__ Terms terms) {
  shifts_staged<VDIM, NOFF>(x, y, N, p, terms);
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

// shifts' plan: {threads, nodes a thread, run, stride, columns, planes,
// ranges, blocks, lowest and highest plane a run reads, stages, win_lo,
// row_floats, shared bytes}, then per row group (kMaxGroups slots each)
// its plane and its offset in the window.  Checked so that the blocks'
// runs cover [0, N) once, every window a run reads is in the ring while it
// runs, and every read of every node of a run lands inside its group's
// window whatever the 16-byte shift of the window's start (0..3 values).
bool check_shifts_plan(const int* plan, int vdim, int N, const Geometry& geo,
                       int n_off, ShiftsPlan* sp, int* blocks, int* smem) {
  const int run = kShiftsThreads * kShiftsNodes;
  const int spread = plane_spread(n_off);
  *sp = {};
  sp->stride = plan[3];
  sp->columns = plan[4];
  sp->planes = plan[5];
  sp->ranges = plan[6];
  *blocks = plan[7];
  sp->stages = plan[10];
  sp->win_lo = plan[11];
  sp->row_floats = plan[12];
  *smem = plan[13];
  if (plan[0] != kShiftsThreads || plan[1] != kShiftsNodes ||
      plan[2] != run || sp->stride < run || sp->stride > kMaxIndex ||
      sp->columns != (sp->stride + run - 1) / run ||
      sp->planes != (N + sp->stride - 1) / sp->stride || sp->ranges < 1 ||
      sp->ranges > sp->planes ||
      *blocks != static_cast<long long>(sp->columns) * sp->ranges ||
      plan[8] != -spread || plan[9] != spread ||
      sp->stages < 2 * spread + 1 || sp->stages > kMaxStages ||
      sp->win_lo < -kMaxIndex || sp->win_lo > kMaxIndex ||
      sp->row_floats < 4 || sp->row_floats % 4 != 0 ||
      static_cast<long long>(*smem) !=
          4LL * sp->stages * vdim * sp->row_floats ||
      *smem > kMaxSmem) {
    return false;
  }
  for (int g = 0; g < group_count(n_off); ++g) {
    const int m = plan[14 + g];
    const int off = plan[14 + kMaxGroups + g];
    if (m != group_plane(n_off, g) ||
        off != static_cast<long long>(geo.base[g]) -
                   static_cast<long long>(m) * sp->stride - sp->win_lo ||
        off < 0 ||
        3LL + off + run + group_size(n_off, g) - 1 > sp->row_floats) {
      return false;
    }
    sp->group_off[g] = off;
  }
  return true;
}

// Shared memory up to `smem` bytes a block for shifts, and as much of the
// SM's on-chip store for shared memory as it has (the plan's grid counts
// on the blocks it holds at once).
template <int VDIM, int NOFF>
bool shifts_attributes(int smem) {
  return cudaFuncSetAttribute(shifts_kernel<VDIM, NOFF>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem) == cudaSuccess &&
         cudaFuncSetAttribute(shifts_kernel<VDIM, NOFF>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared) == cudaSuccess;
}

template <int VDIM, int NOFF>
bool shifts_if(const Call& c, const ShiftsPlan& sp, int blocks, int smem,
               const Terms& terms, bool* ok) {
  if (c.vdim != VDIM || c.n_off != NOFF) return false;
  *ok = shifts_attributes<VDIM, NOFF>(smem);
  if (*ok) {
    shifts_kernel<VDIM, NOFF><<<blocks, kShiftsThreads, smem, c.stream>>>(
        c.x, c.y, c.N, sp, terms);
  }
  return true;
}

template <int NOFF>
bool shifts_span_if(const Call& c, const Terms& terms) {
  if (c.vdim != 1 || c.n_off != NOFF) return false;
  constexpr int kRun = kShiftsThreads * kSpanNodes;
  const int blocks = (c.N + kRun - 1) / kRun;
  shifts_kernel_spans<NOFF><<<blocks, kShiftsThreads, 0, c.stream>>>(
      c.x, c.y, c.N, c.geo, terms);
  return true;
}

template <int... NOFFS>
bool shifts_span_dispatch(const Call& c, const Terms& terms) {
  return (shifts_span_if<NOFFS>(c, terms) || ...);
}

template <int VDIM, int... NOFFS>
bool shifts_noff(const Call& c, const ShiftsPlan& sp, int blocks, int smem,
                 const Terms& terms, bool* ok) {
  return (shifts_if<VDIM, NOFFS>(c, sp, blocks, smem, terms, ok) || ...);
}

template <int... VDIMS>
bool shifts_dispatch(const Call& c, const ShiftsPlan& sp, int blocks,
                     int smem, const Terms& terms, bool* ok) {
  return (shifts_noff<VDIMS, FLOOR_PROBE_NOFFS>(c, sp, blocks, smem, terms,
                                                ok) || ...);
}

// Blocks of shifts an SM holds at once with `smem` bytes of staged runs.
template <int VDIM, int NOFF>
bool shifts_occupancy_if(int vdim, int n_off, int smem, int* blocks) {
  if (vdim != VDIM || n_off != NOFF) return false;
  if (!shifts_attributes<VDIM, NOFF>(smem) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, shifts_kernel<VDIM, NOFF>, kShiftsThreads, smem) !=
          cudaSuccess) {
    *blocks = 0;
  }
  return true;
}

template <int VDIM, int... NOFFS>
bool shifts_occupancy_noff(int vdim, int n_off, int smem, int* blocks) {
  return (shifts_occupancy_if<VDIM, NOFFS>(vdim, n_off, smem, blocks) ||
          ...);
}

template <int... VDIMS>
bool shifts_occupancy_dispatch(int vdim, int n_off, int smem, int* blocks) {
  return (shifts_occupancy_noff<VDIMS, FLOOR_PROBE_NOFFS>(vdim, n_off, smem,
                                                          blocks) || ...);
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

// The blocks of shifts an SM holds at once with `smem` bytes of staged
// runs a block.
extern "C" int floor_shifts_blocks_per_sm(int vdim, int n_off, int smem,
                                          int* blocks) {
  *blocks = 0;
  if (smem < 0 || smem > kMaxSmem ||
      !shifts_occupancy_dispatch<SHIFTS_STAGED_VDIMS>(vdim, n_off, smem,
                                                      blocks)) {
    return kInvalid;
  }
  return *blocks > 0 ? 0 : kInvalid;
}

// At v1 shifts takes no plan (plan_len 0), at v2 and v3 the staged
// kernel's.
extern "C" int floor_shifts(int vdim, const void* x, void* y, long long N,
                            const int* deltas, int n_off, const float* wc,
                            const int* plan, int plan_len, void* stream) {
  Call c;
  if (!make_call(vdim, x, y, N, deltas, n_off, stream, &c)) return kInvalid;
  Terms terms = {};
  for (int i = 0; i < n_off * vdim * vdim; ++i) terms.wc[i] = wc[i];
  if (vdim == 1) {
    if (plan_len != 0 || !shifts_span_dispatch<FLOOR_PROBE_NOFFS>(c, terms)) {
      return kInvalid;
    }
    return static_cast<int>(cudaGetLastError());
  }
  ShiftsPlan sp;
  int blocks, smem;
  bool ok = false;
  if (plan_len != kShiftsPlanLen ||
      !check_shifts_plan(plan, vdim, c.N, c.geo, n_off, &sp, &blocks,
                         &smem) ||
      !shifts_dispatch<SHIFTS_STAGED_VDIMS>(c, sp, blocks, smem, terms,
                                            &ok) ||
      !ok) {
    return kInvalid;
  }
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
