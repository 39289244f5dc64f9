// Row groups of the sorted P1 stencil and the x spans they read: shared by
// flat_stencil_spmv.cu (the dense SpMV) and cs_stencil.cu (the
// constant-interior operator), which read x the same way.
//
// The sorted P1 stencil's offsets come in runs that differ only by ±1 in
// the last grid axis: P pairs, the (−1, 0, +1) triple, P pairs, n_off =
// 4P + 3.  A thread that owns K consecutive nodes reads, for each (group, b),
// one span of K + size − 1 values of x, and every member of the group
// reuses it.

#pragma once

#include <cuda_runtime.h>

// Row groups of a sorted P1 stencil of n_off = 4P + 3 offsets: groups
// 0..P-1 are pairs, group P the triple, groups P+1..2P pairs.
__host__ __device__ constexpr int group_count(int n_off) {
  return (n_off - 3) / 2 + 1;
}
__host__ __device__ constexpr int group_size(int n_off, int g) {
  return g == (n_off - 3) / 4 ? 3 : 2;
}
__host__ __device__ constexpr int group_first(int n_off, int g) {
  return 2 * g + (g > (n_off - 3) / 4 ? 1 : 0);
}

// SPAN values of x starting at flat index s of the aligned base xa (s ≥ 0),
// read as whole 16-byte chunks and shifted into place by s mod 4 (uniform
// across the grid, so the selects never diverge).
template <int SPAN>
__device__ __forceinline__ void span_chunks(const float4* xa, int s,
                                            float (&xv)[SPAN]) {
  constexpr int kChunks = (SPAN + 6) / 4;   // covers r + SPAN for r ≤ 3
  const int c0 = s >> 2;
  const int r = s & 3;
  float c[4 * kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const float4 v = __ldg(xa + c0 + i);
    c[4 * i] = v.x;
    c[4 * i + 1] = v.y;
    c[4 * i + 2] = v.z;
    c[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int p = 0; p < SPAN; ++p) {
    float v = c[p];
    v = r == 1 ? c[p + 1] : v;
    v = r == 2 ? c[p + 2] : v;
    v = r == 3 ? c[p + 3] : v;
    xv[p] = v;
  }
}

// SPAN values of x[b] from node m0 on: in an interior block untested (as
// aligned chunks on the wide path), in an edge block each value tested
// against [0, N).
template <int SPAN, int K, bool INTERIOR>
__device__ __forceinline__ void span(const float* __restrict__ x,
                                     const float4* __restrict__ xa, int sh,
                                     int N, int b, int m0,
                                     float (&xv)[SPAN]) {
  const float* xb = x + b * N;
  if constexpr (INTERIOR && K > 1) {
    span_chunks<SPAN>(xa, sh + b * N + m0, xv);
  } else {
#pragma unroll
    for (int p = 0; p < SPAN; ++p) {
      const int m = m0 + p;
      xv[p] = (INTERIOR || (m >= 0 && m < N)) ? __ldg(xb + m) : 0.0f;
    }
  }
}
