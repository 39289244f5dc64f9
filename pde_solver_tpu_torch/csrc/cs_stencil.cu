// Constant-interior ("CS") stencil SpMV for Hopper (sm_90a): two kernels.
//
//   cs_main:    y[a·N + n]  = Σ_s [n ∈ class_s] Σ_o Σ_b S[s][(o·v + a)·v + b] · x[b·N + n + δ_o]
//   cs_window:  y[a·N + n] += Σ_o Σ_b R[((o·v + a)·v + b)·L + t] · x[b·N + n + δ_o]
//
// Set 0 is the interior model, and its class is every node.  Each further
// set is a scalar correction for one boundary class of the two minor grid
// axes: a layer (coordinate c on one axis) or an edge line (a pair of
// layers).  cs_window then adds exact residual weights R for every node of
// the listed 1024-node windows, in place on cs_main's output: t = w·1024 +
// (n mod 1024) for the node n of window w, and L = n_win·1024.  x reads as
// zero where n + δ_o falls outside [0, N).
//
// Replaces pde_solver_tpu/ops/pallas_kernels.py::_cs_main_kernel (K3) and
// ::_cs_window_kernel (K4), the two passes of CSFlatStencilOperator.  The
// windows are the TPU kernel's 8-row × 128-lane octets, which are 1024
// consecutive flat nodes, so the reference's window list and residual
// weights carry over unchanged.
//
// What bounds it: x reads and the window residual bytes, not weights.  The
// dense kernel (flat_stencil_spmv.cu) streams n_off·v² weights per node,
// 60 B/node for scalar heat and 540 B/node for 3-D elasticity.  Here the
// interior reads no weights: each node reads its n_off·v neighbours of x
// (through L1/L2; x of a 2.1M-node grid is 8.6 MB, the L2 holds 50 MB) and
// writes v values of y.  Only window nodes, a few per cent of the grid,
// stream residual weights.
//
// What the design does about it, against the TPU kernel:
// * No mask planes.  The TPU kernel streams one f32 0/1 plane per class
//   plus a validity plane, which at v = 1 can cost more bytes than the
//   dense weights.  Here a node tests its own coordinates against the
//   class list (two integers per class: the required coordinate on each
//   minor axis, or -1).  Every class is a layer within two nodes of a
//   minor-axis boundary (the wrapper checks), so interior nodes skip the
//   list.  There is no padded tail, so no validity plane.
// * Scalars from a table, not compile-time constants.  The n_sets × n_off·v²
//   table (at most 25 × 135 floats) is copied into shared memory per block
//   and read as warp-uniform broadcasts; zero scalars are skipped by a
//   warp-uniform branch, as the TPU kernel skips them at trace time.
// * x is read once per node and offset into registers and reused by every
//   set the node belongs to.
// * One thread per node for cs_main, one thread per window node for
//   cs_window.  Windows never overlap, so the in-place update has no race.
//
// Sums run in the reference's order: set-major, then (o, b, a) within a
// set; cs_window per output component a over (o, b).  Every multiply and
// add is an explicit __fmul_rn / __fadd_rn (nothing contracts into an FMA),
// so the result equals the plain torch version (ops/cs_kernels.py) up to
// the sign of zero.
//
// C interface for ctypes: each function launches on the given stream, does
// not synchronise, allocates nothing, and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for arguments it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOffsets = 15;   // the 3-D P1 stencil; the 2-D one has 7
constexpr int kMaxSets = 25;      // interior + 8 layers + 16 edge lines
constexpr int kThreads = 256;
constexpr int kWindow = 1024;     // flat nodes per window (one TPU octet)
constexpr long long kMaxNodes = 1LL << 30;

struct Geometry {
  int deltas[kMaxOffsets];
  int n_off;
  int n1, n2;   // extents of the two minor axes (the last two)
};

template <int VDIM>
__global__ void __launch_bounds__(kThreads)
cs_main_kernel(const float* __restrict__ x, float* __restrict__ y, int N,
               Geometry g, const float* __restrict__ scalars, int n_sets,
               const int* __restrict__ classes) {
  extern __shared__ float s_scal[];
  const int nw = g.n_off * VDIM * VDIM;
  for (int i = threadIdx.x; i < n_sets * nw; i += blockDim.x) {
    s_scal[i] = scalars[i];
  }
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;

  float xs[kMaxOffsets * VDIM];
#pragma unroll
  for (int o = 0; o < kMaxOffsets; ++o) {
    const int m = n + g.deltas[o];
    const bool inside = o < g.n_off && m >= 0 && m < N;
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
      xs[o * VDIM + b] =
          inside ? __ldg(x + static_cast<int64_t>(b) * N + m) : 0.0f;
    }
  }

  const int i2 = n % g.n2;
  const int i1 = (n / g.n2) % g.n1;
  const bool near = i1 < 2 || i1 >= g.n1 - 2 || i2 < 2 || i2 >= g.n2 - 2;
  const int n_test = near ? n_sets : 1;

  float yo[VDIM];
#pragma unroll
  for (int a = 0; a < VDIM; ++a) yo[a] = 0.0f;
  for (int s = 0; s < n_test; ++s) {
    if (s > 0) {
      const int c1 = __ldg(classes + 2 * (s - 1));
      const int c2 = __ldg(classes + 2 * (s - 1) + 1);
      if ((c1 >= 0 && i1 != c1) || (c2 >= 0 && i2 != c2)) continue;
    }
    const float* w = s_scal + s * nw;
    float acc[VDIM];
#pragma unroll
    for (int a = 0; a < VDIM; ++a) acc[a] = 0.0f;
#pragma unroll
    for (int o = 0; o < kMaxOffsets; ++o) {
      if (o < g.n_off) {
#pragma unroll
        for (int b = 0; b < VDIM; ++b) {
#pragma unroll
          for (int a = 0; a < VDIM; ++a) {
            const float wv = w[(o * VDIM + a) * VDIM + b];
            if (wv != 0.0f) {
              acc[a] = __fadd_rn(acc[a], __fmul_rn(wv, xs[o * VDIM + b]));
            }
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < VDIM; ++a) yo[a] = __fadd_rn(yo[a], acc[a]);
  }
#pragma unroll
  for (int a = 0; a < VDIM; ++a) y[static_cast<int64_t>(a) * N + n] = yo[a];
}

template <int VDIM>
__global__ void __launch_bounds__(kThreads)
cs_window_kernel(const float* __restrict__ x, float* __restrict__ y, int N,
                 Geometry g, const float* __restrict__ R,
                 const int* __restrict__ windows, int n_win) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t L = static_cast<int64_t>(n_win) * kWindow;
  if (t >= L) return;
  const int64_t n64 = static_cast<int64_t>(__ldg(windows + t / kWindow)) * kWindow
                      + t % kWindow;
  if (n64 >= N) return;
  const int n = static_cast<int>(n64);
  float acc[VDIM];
#pragma unroll
  for (int a = 0; a < VDIM; ++a) acc[a] = y[static_cast<int64_t>(a) * N + n];
  for (int o = 0; o < g.n_off; ++o) {
    const int m = n + g.deltas[o];
    const bool inside = m >= 0 && m < N;
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
      const float xb = inside ? __ldg(x + static_cast<int64_t>(b) * N + m) : 0.0f;
#pragma unroll
      for (int a = 0; a < VDIM; ++a) {
        const float r = __ldg(R + ((o * VDIM + a) * VDIM + b) * L + t);
        acc[a] = __fadd_rn(acc[a], __fmul_rn(r, xb));
      }
    }
  }
#pragma unroll
  for (int a = 0; a < VDIM; ++a) y[static_cast<int64_t>(a) * N + n] = acc[a];
}

bool make_geometry(long long N, const int* deltas, int n_off, int n1, int n2,
                   Geometry* g) {
  if (n_off < 1 || n_off > kMaxOffsets || N <= 0 || N > kMaxNodes ||
      n1 < 1 || n2 < 1) {
    return false;
  }
  *g = {};
  for (int i = 0; i < n_off; ++i) {
    if (deltas[i] > kMaxNodes || deltas[i] < -kMaxNodes) return false;
    g->deltas[i] = deltas[i];
  }
  g->n_off = n_off;
  g->n1 = n1;
  g->n2 = n2;
  return true;
}

unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int cs_stencil_main(int vdim, const void* x, void* y, long long N,
                               const int* deltas, int n_off, int n1, int n2,
                               const void* scalars, int n_sets,
                               const void* classes, void* stream) {
  Geometry g;
  if (!make_geometry(N, deltas, n_off, n1, n2, &g) || n_sets < 1 ||
      n_sets > kMaxSets || (vdim != 1 && vdim != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * n_sets * n_off * vdim * vdim;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  const float* sc = static_cast<const float*>(scalars);
  const int* cl = static_cast<const int*>(classes);
  const int n = static_cast<int>(N);
  if (vdim == 1) {
    cs_main_kernel<1><<<blocks_for(N), kThreads, smem, s>>>(xf, yf, n, g, sc,
                                                            n_sets, cl);
  } else {
    cs_main_kernel<3><<<blocks_for(N), kThreads, smem, s>>>(xf, yf, n, g, sc,
                                                            n_sets, cl);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cs_stencil_window(int vdim, const void* x, void* y,
                                 long long N, const int* deltas, int n_off,
                                 const void* R, const void* windows,
                                 int n_win, void* stream) {
  Geometry g;
  if (!make_geometry(N, deltas, n_off, 1, 1, &g) || n_win < 1 ||
      static_cast<long long>(n_win) * kWindow > kMaxNodes + kWindow ||
      (vdim != 1 && vdim != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  const float* rf = static_cast<const float*>(R);
  const int* wf = static_cast<const int*>(windows);
  const int n = static_cast<int>(N);
  const long long threads = static_cast<long long>(n_win) * kWindow;
  if (vdim == 1) {
    cs_window_kernel<1><<<blocks_for(threads), kThreads, 0, s>>>(
        xf, yf, n, g, rf, wf, n_win);
  } else {
    cs_window_kernel<3><<<blocks_for(threads), kThreads, 0, s>>>(
        xf, yf, n, g, rf, wf, n_win);
  }
  return static_cast<int>(cudaGetLastError());
}
