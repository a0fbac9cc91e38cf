// Deterministic CSR SpMM, out[r] = dense[r] + sum over row r's edges e, in
// row_ptr order, of vals[e] * x[cols[e]] (`dense` optional).
//
// Two roles, one kernel:
// * kernel B of the port, the sparse remainder of the block-dense and
//   hybrid SpMMs. Replaces sgc_tpu/ops/spmm.py::spmm_segment (an XLA
//   gather + sorted segment-sum in the reference, not a Pallas kernel). It
//   is written by hand because determinism is part of that op's contract,
//   and PyTorch's CUDA index_add_ / scatter_add_ sum with atomics, in an
//   order that changes from run to run.
// * kernel C of the port, the tiled SpMM over the cell-chunk layout.
//   Replaces sgc_tpu/ops/spmm_pallas.py::_spmm_flat_kernel (flat chunk
//   schedule) and ::_spmm_kernel (stripe walk), which sum every row's
//   edge slots in layout order. The host re-sorts the layout's edges once
//   per plan into (row, layout position) order, padding left out
//   (ops/spmm_tiled.py::row_csr), so the same sums in the same order are
//   this CSR product. The TPU kernels gathered and scattered each chunk
//   with two one-hot matmuls on the MXU; here nothing is one-hot.
//
// Design. One warp per output row, the row's features in registers: each
// lane keeps NV accumulators of VEC floats (float2 when F is even and the
// rows 8-byte aligned: 320 features per pass, two passes at F = 602), so
// an edge's (col, val) is read once per pass, by one lane, and broadcast
// to the warp by two shuffles. Each x row is gathered in coalesced loads
// through L1/L2 (ld.global.nc); nothing is staged in shared memory, so
// there is no barrier, and at under 64 registers several 8-warp CTAs
// share an SM. Consecutive rows run together, so the warps in flight
// gather from the x rows of the same few stripes. The epilogue writes
// dense[r] + acc (the reference's `dense + rest` order) or acc alone, so
// `out` is written once. Padding edges beyond nnz are never read: row_ptr
// bounds them.
//
// Bound on the H100: bytes. Each edge gathers one x row (F * 4 bytes)
// for 2 * F flops; the byte bound counts each x row once, the kernel
// reads it once per edge, from L2 when it is reused.
//
// Deterministic: a fixed per-row edge order, no atomics; every run gives
// identical bits (the reference's convention, sgc_tpu/ops/spmm.py:18-24).
// Precision: FP32 products and sums on the CUDA cores.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;    // rows per CTA, one warp each
constexpr int NV = 5;       // vector accumulators per lane
constexpr unsigned kFull = 0xffffffffu;

template <int VEC> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };

__device__ __forceinline__ void fma_into(float* acc, float v, float x) {
  acc[0] = fmaf(v, x, acc[0]);
}
__device__ __forceinline__ void fma_into(float* acc, float v, float2 x) {
  acc[0] = fmaf(v, x.x, acc[0]);
  acc[1] = fmaf(v, x.y, acc[1]);
}
__device__ __forceinline__ void store(float* p, const float* acc,
                                      const float* d, float*) {
  *p = d ? *d + acc[0] : acc[0];
}
__device__ __forceinline__ void store(float* p, const float* acc,
                                      const float* d, float2*) {
  float2 v = make_float2(acc[0], acc[1]);
  if (d) {
    const float2 dv = *reinterpret_cast<const float2*>(d);
    v.x = dv.x + v.x;
    v.y = dv.y + v.y;
  }
  *reinterpret_cast<float2*>(p) = v;
}

// a CTA takes WARPS consecutive rows, one per warp. VEC = 2 needs F even
// and 8-byte aligned x, dense and out (checked by the host).
template <int VEC>
__global__ void __launch_bounds__(WARPS * 32)
csr_spmm_kernel(const int32_t* __restrict__ row_ptr,   // [n_rows + 1]
                const int32_t* __restrict__ cols,      // [>= nnz]
                const float* __restrict__ vals,        // [>= nnz]
                const float* __restrict__ x,           // [n_cols, F]
                const float* __restrict__ dense,       // [n_rows, F] or null
                float* __restrict__ out,               // [n_rows, F]
                int n_rows, int F) {
  using V = typename Vec<VEC>::T;
  constexpr int PASS = 32 * VEC * NV;   // features per pass
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n_rows) return;   // warp-uniform
  const int e_begin = row_ptr[r];
  const int e_end = row_ptr[r + 1];
  for (int f0 = 0; f0 < F; f0 += PASS) {
    // lane's features in pass slot i: f0 + (lane + 32 i) * VEC + [0, VEC)
    float acc[NV][VEC];
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[i][v] = 0.f;
    for (int eb = e_begin; eb < e_end; eb += 32) {
      const int e = eb + lane;
      const int my_col = e < e_end ? cols[e] : 0;
      const float my_val = e < e_end ? vals[e] : 0.f;
      const int n = min(32, e_end - eb);
#pragma unroll 1
      for (int j = 0; j < n; ++j) {
        const int c = __shfl_sync(kFull, my_col, j);
        const float v = __shfl_sync(kFull, my_val, j);
        const float* xr = x + static_cast<size_t>(c) * F + f0;
        V xv[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int f = (lane + 32 * i) * VEC;
          if (f0 + f < F) xv[i] = __ldg(reinterpret_cast<const V*>(xr + f));
        }
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int f = (lane + 32 * i) * VEC;
          if (f0 + f < F) fma_into(acc[i], v, xv[i]);
        }
      }
    }
    const size_t o = static_cast<size_t>(r) * F + f0;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int f = (lane + 32 * i) * VEC;
      if (f0 + f < F) {
        store(out + o + f, acc[i], dense ? dense + o + f : nullptr,
              static_cast<V*>(nullptr));
      }
    }
  }
}

}  // namespace

extern "C" {

// out = dense + A @ x for the CSR matrix A (row_ptr, cols, vals); `dense`
// may be null. Pointers are device pointers; `stream` is a cudaStream_t.
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue
// for shapes the kernel does not take).
int csr_spmm(const void* row_ptr, const void* cols, const void* vals,
             const void* x, const void* dense, void* out, int n_rows, int F,
             void* stream) {
  if (n_rows <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n_rows + WARPS - 1) / WARPS;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % sizeof(float2) == 0;
  };
  const bool vec2 = F % 2 == 0 && aligned(x) && aligned(out) &&
                    (dense == nullptr || aligned(dense));
  if (vec2) {
    csr_spmm_kernel<2><<<blocks, WARPS * 32, 0, s>>>(
        static_cast<const int32_t*>(row_ptr),
        static_cast<const int32_t*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(x), static_cast<const float*>(dense),
        static_cast<float*>(out), n_rows, F);
  } else {
    csr_spmm_kernel<1><<<blocks, WARPS * 32, 0, s>>>(
        static_cast<const int32_t*>(row_ptr),
        static_cast<const int32_t*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(x), static_cast<const float*>(dense),
        static_cast<float*>(out), n_rows, F);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
