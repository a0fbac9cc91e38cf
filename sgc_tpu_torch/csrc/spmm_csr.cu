// Sparse remainder of the block-dense SpMM: a deterministic CSR SpMM,
// out[r] = dense[r] + sum over row r's edges e of vals[e] * x[cols[e]].
//
// Replaces sgc_tpu/ops/spmm.py::spmm_segment (an XLA gather + sorted
// segment-sum in the reference, not a Pallas kernel). It is written by
// hand because determinism is part of that op's contract, and PyTorch's
// CUDA index_add_ / scatter_add_ sum with atomics, in an order that
// changes from run to run.
//
// Design. One warp per output row; lanes stride over the features, NV
// registers each, in passes of 32 * NV features. The warp loads 32 edges'
// (col, val) at a time, one per lane, and broadcasts them with shuffles;
// the edges are summed in their sorted order from row_ptr, in registers.
// The epilogue writes dense[r] + acc (the reference's `dense + rest`
// order) or acc alone when there is no dense term, so `out` is written
// once. Padding edges beyond nnz are never read: row_ptr bounds them.
//
// Bound on the H100: bytes. Each edge gathers one x row (F * 4 bytes)
// for 2 * F flops.
//
// Deterministic: a fixed per-row edge order, no atomics.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;    // rows per CTA
constexpr int NV = 8;       // features per lane per pass
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
csr_spmm_kernel(const int32_t* __restrict__ row_ptr,   // [n_rows + 1]
                const int32_t* __restrict__ cols,      // [>= nnz]
                const float* __restrict__ vals,        // [>= nnz]
                const float* __restrict__ x,           // [n_cols, F]
                const float* __restrict__ dense,       // [n_rows, F] or null
                float* __restrict__ out,               // [n_rows, F]
                int n_rows, int F) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n_rows) return;   // warp-uniform
  const int e_begin = row_ptr[r];
  const int e_end = row_ptr[r + 1];
  for (int f0 = 0; f0 < F; f0 += 32 * NV) {
    float acc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = 0.f;
    for (int eb = e_begin; eb < e_end; eb += 32) {
      const int e = eb + lane;
      const int my_col = e < e_end ? cols[e] : 0;
      const float my_val = e < e_end ? vals[e] : 0.f;
      const int n = min(32, e_end - eb);
      for (int j = 0; j < n; ++j) {
        const int c = __shfl_sync(kFull, my_col, j);
        const float v = __shfl_sync(kFull, my_val, j);
        const float* x_row = x + static_cast<size_t>(c) * F + f0 + lane;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          if (f0 + lane + 32 * i < F) acc[i] = fmaf(v, x_row[32 * i], acc[i]);
        }
      }
    }
    const size_t o = static_cast<size_t>(r) * F + f0 + lane;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (f0 + lane + 32 * i < F) {
        out[o + 32 * i] = dense ? dense[o + 32 * i] + acc[i] : acc[i];
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
  const int blocks = (n_rows + WARPS - 1) / WARPS;
  csr_spmm_kernel<<<blocks, WARPS * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(cols),
      static_cast<const float*>(vals), static_cast<const float*>(x),
      static_cast<const float*>(dense), static_cast<float*>(out), n_rows, F);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
