// Flat-layout stencil SpMV for Hopper (sm_90a).
//
//   y[a·N + n] = Σ_o Σ_b W[((o·v + a)·v + b)·N + n] · x[b·N + n + δ_o]
//
// for every node n < N and output component a < v, with x read as zero
// where n + δ_o falls outside [0, N).  Weights are float32 or bfloat16;
// every product and the accumulation are float32.
//
// Replaces pde_solver_tpu/ops/pallas_kernels.py::_resident_kernel and
// ::_windowed_kernel (shared body _spmv_body).  On the TPU those two differ
// only in where x lives (all of x in VMEM, or a DMA'd window per block).
// Here x is read through L2: the largest x on the main path (the 2.04M-DOF
// flagship fine level, 8 MB) fits the 50 MB L2 many times over, so one
// kernel covers both.
//
// Layout: weights are plane-major [n_off·v·v, N] and vectors [v, N]
// (component-major, the order of FlatStencilOperator.to_flat).  The TPU's
// [rows, 128] tiling has no meaning here.  Shifts are flat-index deltas;
// assembled weights are exactly zero wherever a shift wraps across a grid
// row, so flat addressing is exact, and the bounds check below keeps every
// read inside x.
//
// Built for the v listed in FLAT_STENCIL_VDIMS (scalar problems, 2-D and
// 3-D elasticity) with f32 and bf16 weights; any other v is refused
// (cudaErrorInvalidValue).  ops/stencil_kernels.py reads that line as
// KERNEL_VDIMS, so FlatStencilOperator refuses any other v on a CUDA device
// at construction, and a new v is added there and nowhere else.
//
// What bounds it: W bytes.  Each node streams n_off·v² weights once —
// 15·9·4 = 540 B/node at f32 and 270 B/node at bf16 for 3-D elasticity,
// about 367 MB per vdim=3 f32 apply at the flagship, and 7·4·4 = 112 B/node
// at f32 for 2-D elasticity — against 8·v B/node of x and y.  The design
// streams W exactly once with coalesced loads (one thread per node:
// neighbouring threads read neighbouring W addresses in every plane), keeps
// the v accumulators in registers, and leaves the x re-reads (n_off per
// node) to L1/L2.
//
// Accumulation runs in the reference's (o, b, a) order; nvcc contracts
// each multiply-add into an FMA, so results differ from the unfused plain
// version by float32 rounding only.
//
// C interface for ctypes: flat_stencil_spmv(...) launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FLAT_STENCIL_VDIMS 1, 2, 3

namespace {

constexpr int kMaxOffsets = 32;
constexpr int kThreads = 256;

struct Deltas {
  int d[kMaxOffsets];
};

__device__ __forceinline__ float load_weight(const float* p) {
  return __ldg(p);
}

__device__ __forceinline__ float load_weight(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

template <int VDIM, typename WT>
__global__ void __launch_bounds__(kThreads)
flat_stencil_spmv_kernel(const WT* __restrict__ W,
                         const float* __restrict__ x,
                         float* __restrict__ y, int64_t N, Deltas deltas,
                         int n_off) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float acc[VDIM];
#pragma unroll
  for (int a = 0; a < VDIM; ++a) acc[a] = 0.0f;
  for (int o = 0; o < n_off; ++o) {
    const int64_t m = n + deltas.d[o];
    const bool inside = (m >= 0) && (m < N);
    const WT* w_o = W + static_cast<int64_t>(o) * VDIM * VDIM * N + n;
#pragma unroll
    for (int b = 0; b < VDIM; ++b) {
      const float xb = inside ? __ldg(x + b * N + m) : 0.0f;
#pragma unroll
      for (int a = 0; a < VDIM; ++a) {
        const float w = load_weight(w_o + static_cast<int64_t>(a * VDIM + b) * N);
        acc[a] = fmaf(w, xb, acc[a]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < VDIM; ++a) y[a * N + n] = acc[a];
}

template <int VDIM, typename WT>
void launch(const void* W, const void* x, void* y, int64_t N,
            const Deltas& deltas, int n_off, cudaStream_t stream) {
  const int64_t blocks = (N + kThreads - 1) / kThreads;
  flat_stencil_spmv_kernel<VDIM, WT><<<static_cast<unsigned>(blocks),
                                       kThreads, 0, stream>>>(
      static_cast<const WT*>(W), static_cast<const float*>(x),
      static_cast<float*>(y), N, deltas, n_off);
}

// Launches the VDIM instantiation if vdim == VDIM; false otherwise.
template <int VDIM>
bool launch_if(int vdim, int w_is_bf16, const void* W, const void* x,
               void* y, int64_t N, const Deltas& deltas, int n_off,
               cudaStream_t stream) {
  if (vdim != VDIM) return false;
  if (w_is_bf16) {
    launch<VDIM, __nv_bfloat16>(W, x, y, N, deltas, n_off, stream);
  } else {
    launch<VDIM, float>(W, x, y, N, deltas, n_off, stream);
  }
  return true;
}

template <int... VDIMS>
bool dispatch(int vdim, int w_is_bf16, const void* W, const void* x, void* y,
              int64_t N, const Deltas& deltas, int n_off,
              cudaStream_t stream) {
  return (launch_if<VDIMS>(vdim, w_is_bf16, W, x, y, N, deltas, n_off,
                           stream) || ...);
}

}  // namespace

extern "C" int flat_stencil_spmv(const void* W, int w_is_bf16, int vdim,
                                 const void* x, void* y, long long N,
                                 const int* deltas, int n_off,
                                 void* stream) {
  if (n_off < 1 || n_off > kMaxOffsets || N <= 0 ||
      N > (static_cast<long long>(kThreads) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Deltas d = {};
  for (int i = 0; i < n_off; ++i) d.d[i] = deltas[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dispatch<FLAT_STENCIL_VDIMS>(vdim, w_is_bf16, W, x, y, N, d, n_off,
                                    s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
