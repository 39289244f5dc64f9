// Constant-interior ("CS") stencil operator for Hopper (sm_90a): the whole
// apply in one kernel launch.
//
//   y[a·N + n] = Σ_s [n ∈ class_s] Σ_o Σ_b S[s][(o·v + a)·v + b] · x[b·N + n + δ_o]
//              + [window of n listed] Σ_o Σ_b R[((o·v + a)·v + b)·L + t] · x[b·N + n + δ_o]
//
// Set 0 is the interior model, and its class is every node.  Each further
// set is a scalar correction for one boundary class of the two minor grid
// axes: a layer (coordinate c on one axis) or an edge line (a pair of
// layers), always within two nodes of a minor-axis boundary.  The residual
// weights R are exact for every node of the listed 1024-node windows: t =
// slot·1024 + (n mod 1024) for the node n of the window in slot `slot`, and
// L = n_win·1024.  x reads as zero where n + δ_o falls outside [0, N).
//
// Replaces pde_solver_tpu/ops/pallas_kernels.py::_cs_main_kernel (K3) and
// ::_cs_window_kernel (K4), the two passes of CSFlatStencilOperator.  The
// TPU splits them for its grid and VMEM; here one launch computes both,
// node by node, and writes y once.  A window is the TPU kernel's 8-row ×
// 128-lane octet, 1024 consecutive flat nodes, so the reference's window
// list and residual weights carry over unchanged.
//
// What bounds it: the bytes are x read and y written once, 8·v bytes a
// node, plus the residual weights of the window nodes (3 % of the grid);
// no weight is streamed for the rest.  At the main paths' fine levels all
// of it (21 MB at 129³ v = 1, 26 MB at 161×65×65 v = 3) fits the 50 MB
// L2, so launches back to back read it from L2, and the HBM bound is a
// bound only with L2 flushed between launches (chip_smoke.py times
// both).  Either way the time is several times that of the bytes: the
// A/B variants of cs_ab.py (H100, PERF.md)
// find no single cost that sets it.  Without the x loads, with every row
// group reading one x row (all L1 hits), without y stores or with more
// blocks an SM the kernel is at most a fifth faster; at v = 3 the
// near-boundary threads add about a quarter to the node mapping, and the
// 270 separately rounded operations a node about a sixth (fmaf).  On the
// coarse multigrid levels, where nearly every node has a boundary code,
// the near-boundary threads' serial class work sets a floor 2–3× the
// dense kernel's launch floor.
//
// What the design does about it:
// * One launch.  A host-built slot map, int32 [ceil(N/1024)], holds each
//   window's slot in R or −1.  A node whose window is listed adds its
//   residual terms to its own sums in registers: no second pass over y,
//   no read-modify-write, and one launch's host cost, not two.
// * The interior scalars live in the constant bank.  Set 0 is a term list
//   in (o, b, a) order inside the kernel's parameter struct, so every
//   product takes a warp-uniform constant operand: no shared-memory load
//   and no zero test per term.  Set 0 has 15 of 15 nonzero scalars at v = 1
//   and 133 of 135 at v = 3 on the main paths, so a zero scalar is
//   multiplied like any other: for finite x its product is ±0 and leaves
//   the sum's value unchanged.
// * Classes by a lookup, not a loop.  A minor-axis coordinate maps to a code
//   in {0, 1, 2 (inner), 3 (n−2), 4 (n−1)}, and a host-built 5 × 5 table maps
//   the pair of codes to the bitmask of the class sets the node is in.  The
//   blocks of the node mapping write only inner nodes, whose mask is empty,
//   and do no class work at all; every node with a boundary code (6 % of
//   129³, 12 % of 161×65×65) is written by a block of its own at the start
//   of the grid (so its latency-bound class work overlaps the node
//   mapping), one node a thread, which loads its x values once and walks
//   the set bits of its mask only.  Those near-boundary threads are
//   enumerated slice by slice (the four boundary rows of the first minor
//   axis whole, then the four end nodes of every other row), so a warp
//   there mostly shares one mask.  Coordinates come from a multiply with a
//   host-computed magic number, never a runtime division.
// * x read by row groups (stencil_span.cuh, shared with the dense kernel),
//   one node a thread at ≥ 6 blocks an SM; `interior` a template argument,
//   so tiles clear of both ends of x are branch-free and untested.  The
//   dense kernel's 4 consecutive nodes a thread with 16-byte x chunks
//   measured slower here, most at v = 3, where 248 registers a thread
//   leave 2 blocks an SM, and 2 or 4 nodes a thread kThreads apart no
//   faster at v = 3.  A tile's nodes lie in one window, so the window test
//   is tile-uniform; residual weights are evict-first loads.
//
// Sums run in the plain version's order: set-major, (o, b, a) within a
// set, then the residual terms per output component over (o, b), starting
// from the sets' sum.  Every multiply and add is an explicit __fmul_rn /
// __fadd_rn (nothing contracts into an FMA), so for finite x the result
// equals the plain torch version (ops/cs_kernels.py::cs_apply_plain) up
// to the sign of zero.  With no slot map the kernel computes the sets
// alone (cs_main_plain's function).
//
// C interface for ctypes: cs_stencil_prepare fills an opaque parameter
// block (cs_stencil_params_size bytes) once per operator, checking what it
// is given; cs_stencil_apply launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() (0 on
// success).  Both return cudaErrorInvalidValue for what they do not take.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <utility>

#include "stencil_span.cuh"

#define CS_STENCIL_VDIMS 1, 3
#define CS_STENCIL_NOFFS 7, 15

namespace {

constexpr int kThreads = 128;
constexpr int kMaxOffsets = 15;   // the 3-D P1 stencil; the 2-D one has 7
constexpr int kMaxVdim = 3;
constexpr int kMaxGroups = 8;
constexpr int kMaxClassSets = 24;   // 8 layers + 16 edge lines
constexpr int kCodes = 5;
constexpr int kWindow = 1024;       // flat nodes per window (one TPU octet)
constexpr long long kMaxIndex = 1LL << 30;   // v·N and |δ| stay below

// floor(n / d) = umulhi(n, m) >> s for 0 ≤ n < 2^31 (d ≥ 2; the host
// computes m = ceil(2^p / d), p = 31 + ceil(log2 d), s = p − 32)
struct FastDiv {
  unsigned m;
  int s;
};

__device__ __forceinline__ int fdiv(int n, FastDiv d) {
  return static_cast<int>(__umulhi(static_cast<unsigned>(n), d.m) >> d.s);
}

struct Params {
  float terms[kMaxOffsets * kMaxVdim * kMaxVdim];   // set 0, (o, b, a) order
  unsigned masks[kCodes * kCodes];   // code pair → bit s − 1 per class set s
  int base[kMaxGroups];              // δ of each row group's first member
  int deltas[kMaxOffsets];
  int vdim, n_off;
  int dmin, dmax;
  int N, n1, n2;                     // nodes; the two minor extents
  int near_per_slice;                // 4·n2 + 4·(n1 − 4)
  int n_near;                        // nodes with a boundary code
  int near_blocks;                   // blocks of the near-boundary nodes
  int L;                             // residual row stride, n_win·1024
  int n_cls;                         // class sets
  FastDiv div_n2, div_n1, div_slice;
};

__device__ __forceinline__ int code(int i, int n) {
  return i < 2 ? i : (i >= n - 2 ? i - n + kCodes : 2);
}

// Row group G of the node mapping: its x values for every b, then for
// each member, b and a the product with set 0's scalar (constant bank), or
// with the residual plane (RESIDUAL), added into acc.
template <int VDIM, int NOFF, int G, bool INTERIOR, bool RESIDUAL>
__device__ __forceinline__ void group_pass(const Params& p,
                                           const float* __restrict__ Rn,
                                           const float* __restrict__ x, int n,
                                           float (&acc)[VDIM]) {
  constexpr int kSize = group_size(NOFF, G);
  constexpr int kFirst = group_first(NOFF, G);
  float xv[VDIM][kSize];
#pragma unroll
  for (int b = 0; b < VDIM; ++b) {
    span<kSize, 1, INTERIOR>(x, nullptr, 0, p.N, b, n + p.base[G], xv[b]);
  }
#pragma unroll
  for (int s = 0; s < kSize; ++s) {
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
#pragma unroll
      for (int a = 0; a < VDIM; ++a) {
        const int o = kFirst + s;
        float w;
        if constexpr (RESIDUAL) {
          // evict-first: the residual weights are read once
          w = __ldcs(Rn + static_cast<size_t>((o * VDIM + a) * VDIM + b) * p.L);
        } else {
          w = p.terms[(o * VDIM + b) * VDIM + a];
        }
        acc[a] = __fadd_rn(acc[a], __fmul_rn(w, xv[b][s]));
      }
    }
  }
}

template <int VDIM, int NOFF, bool INTERIOR, bool RESIDUAL, int... G>
__device__ __forceinline__ void all_groups(std::integer_sequence<int, G...>,
                                           const Params& p,
                                           const float* __restrict__ Rn,
                                           const float* __restrict__ x, int n,
                                           float (&acc)[VDIM]) {
  (group_pass<VDIM, NOFF, G, INTERIOR, RESIDUAL>(p, Rn, x, n, acc), ...);
}

// The node mapping: one node a thread, so every load of a warp is
// coalesced.  Set 0, then the window's residual terms; writes only the
// inner nodes (the near-boundary threads write the rest).  INTERIOR: every
// x index of the tile lies inside [0, N).
template <int VDIM, int NOFF, bool INTERIOR>
__device__ __forceinline__ void node_tile(const Params& p, int B0,
                                          const float* __restrict__ x,
                                          float* __restrict__ y,
                                          const int* __restrict__ slots,
                                          const float* __restrict__ R) {
  constexpr auto kGroups = std::make_integer_sequence<int, group_count(NOFF)>{};
  const int n = B0 + threadIdx.x;
  float acc[VDIM];
#pragma unroll
  for (int a = 0; a < VDIM; ++a) acc[a] = 0.0f;
  if (INTERIOR || n < p.N) {
    all_groups<VDIM, NOFF, INTERIOR, false>(kGroups, p, nullptr, x, n, acc);
  }
  // a tile's nodes lie in one window (kWindow is a multiple of the tile)
  const int slot = slots != nullptr ? __ldg(slots + B0 / kWindow) : -1;
  if (slot >= 0 && (INTERIOR || n < p.N)) {
    const float* Rn = R + slot * kWindow + (n & (kWindow - 1));
    all_groups<VDIM, NOFF, INTERIOR, true>(kGroups, p, Rn, x, n, acc);
  }
  const int q = fdiv(n, p.div_n2);
  const int i2 = n - q * p.n2;
  const int i1 = q - fdiv(q, p.div_n1) * p.n1;
  if ((INTERIOR || n < p.N) && i1 >= 2 && i1 < p.n1 - 2 && i2 >= 2 &&
      i2 < p.n2 - 2) {
#pragma unroll
    for (int a = 0; a < VDIM; ++a) y[a * p.N + n] = acc[a];
  }
}

template <int VDIM, int NOFF>
__device__ __forceinline__ void node_thread(const Params& p,
                                            const float* __restrict__ x,
                                            float* __restrict__ y,
                                            const int* __restrict__ slots,
                                            const float* __restrict__ R) {
  const int B0 = (blockIdx.x - p.near_blocks) * kThreads;
  if (B0 + p.dmin >= 0 &&
      static_cast<long long>(B0) + kThreads + p.dmax <= p.N) {
    node_tile<VDIM, NOFF, true>(p, B0, x, y, slots, R);
  } else {
    node_tile<VDIM, NOFF, false>(p, B0, x, y, slots, R);
  }
}

// One near-boundary node's terms of one set in (o, b, a) order on its x
// values xs; weight(t) gives term t's scalar.
template <int VDIM, int NOFF, typename Weight>
__device__ __forceinline__ void node_set(const float (&xs)[NOFF][VDIM],
                                         Weight weight, float (&acc)[VDIM]) {
#pragma unroll
  for (int o = 0; o < NOFF; ++o) {
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
#pragma unroll
      for (int a = 0; a < VDIM; ++a) {
        acc[a] = __fadd_rn(
            acc[a], __fmul_rn(weight((o * VDIM + b) * VDIM + a), xs[o][b]));
      }
    }
  }
}

// The near-boundary mapping: one node with a boundary code a thread.  Set
// 0, the class sets of its mask, then its window's residual terms.
template <int VDIM, int NOFF>
__device__ __forceinline__ void near_node(const Params& p,
                                          const float* __restrict__ x,
                                          float* __restrict__ y,
                                          const float* __restrict__ cls,
                                          const int* __restrict__ slots,
                                          const float* __restrict__ R) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= p.n_near) return;
  // slice i0 holds the four boundary rows of the first minor axis whole
  // (4·n2 nodes), then the two first and two last nodes of each other row
  const int i0 = fdiv(t, p.div_slice);
  const int r = t - i0 * p.near_per_slice;
  int i1, i2;
  if (r < 4 * p.n2) {
    const int j = fdiv(r, p.div_n2);
    i2 = r - j * p.n2;
    i1 = j < 2 ? j : p.n1 - 4 + j;
  } else {
    const int r2 = r - 4 * p.n2;
    const int e = r2 & 3;
    i1 = 2 + (r2 >> 2);
    i2 = e < 2 ? e : p.n2 - 4 + e;
  }
  const int n = (i0 * p.n1 + i1) * p.n2 + i2;
  // its x values once, zero outside [0, N), for every set
  float xs[NOFF][VDIM];
#pragma unroll
  for (int o = 0; o < NOFF; ++o) {
    const int m = n + p.deltas[o];
    const bool inside = m >= 0 && m < p.N;
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
      xs[o][b] = inside ? __ldg(x + b * p.N + m) : 0.0f;
    }
  }
  float yv[VDIM];
#pragma unroll
  for (int a = 0; a < VDIM; ++a) yv[a] = 0.0f;
  node_set<VDIM, NOFF>(xs, [&](int i) { return p.terms[i]; }, yv);
  unsigned mask = p.masks[code(i1, p.n1) * kCodes + code(i2, p.n2)];
  constexpr int kTerms = NOFF * VDIM * VDIM;
  while (mask != 0) {
    const int s = __ffs(mask) - 1;
    mask &= mask - 1;
    const float* w = cls + s * kTerms;
    float acc[VDIM];
#pragma unroll
    for (int a = 0; a < VDIM; ++a) acc[a] = 0.0f;
    node_set<VDIM, NOFF>(xs, [&](int i) { return __ldg(w + i); }, acc);
#pragma unroll
    for (int a = 0; a < VDIM; ++a) yv[a] = __fadd_rn(yv[a], acc[a]);
  }
  const int slot = slots != nullptr ? __ldg(slots + n / kWindow) : -1;
  if (slot >= 0) {
    const float* Rn = R + slot * kWindow + (n & (kWindow - 1));
    // term (o·v + b)·v + a reads residual plane (o·v + a)·v + b
    node_set<VDIM, NOFF>(
        xs,
        [&](int i) {
          const int a = i % VDIM, b = (i / VDIM) % VDIM, o = i / (VDIM * VDIM);
          return __ldg(Rn + static_cast<size_t>((o * VDIM + a) * VDIM + b) *
                                p.L);
        },
        yv);
  }
#pragma unroll
  for (int a = 0; a < VDIM; ++a) y[a * p.N + n] = yv[a];
}

// Blocks [0, near_blocks) take the near-boundary nodes, the rest the node
// mapping: the near threads' latency-bound class work starts first and
// overlaps the streaming blocks.  ≥ 6 blocks an SM, as the dense kernel's
// narrow path.
template <int VDIM, int NOFF>
__global__ void __launch_bounds__(kThreads, 6)
cs_apply_kernel(const __grid_constant__ Params p,
                const float* __restrict__ x, float* __restrict__ y,
                const float* __restrict__ cls, const int* __restrict__ slots,
                const float* __restrict__ R) {
  if (static_cast<int>(blockIdx.x) < p.near_blocks) {
    near_node<VDIM, NOFF>(p, x, y, cls, slots, R);
  } else {
    node_thread<VDIM, NOFF>(p, x, y, slots, R);
  }
}

template <int VDIM, int NOFF>
void launch(const Params& p, const float* x, float* y, const float* cls,
            const int* slots, const float* R, cudaStream_t stream) {
  const int blocks = p.near_blocks + (p.N + kThreads - 1) / kThreads;
  cs_apply_kernel<VDIM, NOFF><<<blocks, kThreads, 0, stream>>>(p, x, y, cls,
                                                               slots, R);
}

template <int VDIM, int... NOFFS>
bool dispatch_noff(const Params& p, const float* x, float* y,
                   const float* cls, const int* slots, const float* R,
                   cudaStream_t stream) {
  return ((p.vdim == VDIM && p.n_off == NOFFS
               ? (launch<VDIM, NOFFS>(p, x, y, cls, slots, R, stream), true)
               : false) ||
          ...);
}

template <int... VDIMS>
bool dispatch(const Params& p, const float* x, float* y, const float* cls,
              const int* slots, const float* R, cudaStream_t stream) {
  return (dispatch_noff<VDIMS, CS_STENCIL_NOFFS>(p, x, y, cls, slots, R,
                                                 stream) ||
          ...);
}

bool built(int vdim, int n_off) {
  const int vdims[] = {CS_STENCIL_VDIMS};
  const int noffs[] = {CS_STENCIL_NOFFS};
  bool v_ok = false, o_ok = false;
  for (int v : vdims) v_ok = v_ok || v == vdim;
  for (int o : noffs) o_ok = o_ok || o == n_off;
  return v_ok && o_ok;
}

}  // namespace

extern "C" int cs_stencil_params_size(void) {
  return static_cast<int>(sizeof(Params));
}

// terms: set 0's n_off·v² scalars in (o, b, a) order; masks: the 5 × 5
// code-pair table; divs: (m, s) for n2, n1 and the near nodes a slice.
extern "C" int cs_stencil_prepare(void* params, int vdim, long long N,
                                  const int* deltas, int n_off, int n1,
                                  int n2, const float* terms,
                                  const unsigned* masks, int n_cls,
                                  const unsigned* divs, int n_win) {
  const long long slice = static_cast<long long>(n1) * n2;
  if (!built(vdim, n_off) || N <= 0 || vdim * N > kMaxIndex || n1 < 5 ||
      n2 < 5 || N % slice != 0 || n_cls < 0 || n_cls > kMaxClassSets ||
      n_win < 0 || static_cast<long long>(n_win) * kWindow > N + kWindow) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  memset(&p, 0, sizeof(p));
  p.vdim = vdim;
  p.n_off = n_off;
  p.N = static_cast<int>(N);
  p.n1 = n1;
  p.n2 = n2;
  p.dmin = deltas[0];
  p.dmax = deltas[0];
  for (int o = 0; o < n_off; ++o) {
    if (deltas[o] > kMaxIndex || deltas[o] < -kMaxIndex) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.deltas[o] = deltas[o];
    p.dmin = deltas[o] < p.dmin ? deltas[o] : p.dmin;
    p.dmax = deltas[o] > p.dmax ? deltas[o] : p.dmax;
  }
  // the row groups of the sorted P1 stencil
  for (int g = 0; g < group_count(n_off); ++g) {
    const int first = group_first(n_off, g);
    for (int s = 1; s < group_size(n_off, g); ++s) {
      if (deltas[first + s] != deltas[first] + s) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    p.base[g] = deltas[first];
  }
  for (int i = 0; i < n_off * vdim * vdim; ++i) p.terms[i] = terms[i];
  const unsigned all = n_cls == 32 ? ~0u : (1u << n_cls) - 1;
  for (int i = 0; i < kCodes * kCodes; ++i) {
    if ((masks[i] & ~all) != 0 || (i == 2 * kCodes + 2 && masks[i] != 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.masks[i] = masks[i];
  }
  FastDiv* d[3] = {&p.div_n2, &p.div_n1, &p.div_slice};
  for (int i = 0; i < 3; ++i) {
    if (divs[2 * i + 1] > 31) return static_cast<int>(cudaErrorInvalidValue);
    d[i]->m = divs[2 * i];
    d[i]->s = static_cast<int>(divs[2 * i + 1]);
  }
  p.near_per_slice = 4 * n2 + 4 * (n1 - 4);
  p.n_near = static_cast<int>(N / slice) * p.near_per_slice;
  p.near_blocks = (p.n_near + kThreads - 1) / kThreads;
  p.L = n_win * kWindow;
  p.n_cls = n_cls;
  memcpy(params, &p, sizeof(p));
  return 0;
}

// slots == nullptr: the sets alone, no residual terms.
extern "C" int cs_stencil_apply(const void* params, const void* x, void* y,
                                const void* cls, const void* slots,
                                const void* R, void* stream) {
  Params p;
  memcpy(&p, params, sizeof(p));
  if ((reinterpret_cast<uintptr_t>(x) & 3) != 0 ||
      (slots != nullptr && p.L > 0 &&
       (reinterpret_cast<uintptr_t>(R) & 3) != 0) ||
      (p.n_cls > 0 && cls == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!dispatch<CS_STENCIL_VDIMS>(
          p, static_cast<const float*>(x), static_cast<float*>(y),
          static_cast<const float*>(cls), static_cast<const int*>(slots),
          static_cast<const float*>(R), static_cast<cudaStream_t>(stream))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
