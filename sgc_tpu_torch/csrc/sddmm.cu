// SDDMM (kernel D of the port): the edge values of a @ b^T at a graph's
// sparsity pattern,
//   out[e] = sum_f a[rows[e], f] * b[cols[e], f]   for e < nnz,
//   out[e] = 0                                       for nnz <= e < e_pad.
// Padding is decided by position, not by value, so a genuine edge whose
// weight is 0 keeps its computed value.
//
// Replaces sgc_tpu/ops/spmm_pallas.py::_sddmm_kernel (sddmm_pallas, which
// gathered a and b rows with one-hot MXU matmuls and so needed both to fit
// VMEM) and stands for the reference's XLA gather-and-sum
// sgc_tpu/ops/spmm.py::sddmm. Here the rows are gathered directly from
// global memory, so a and b have no size limit and may have different row
// counts.
//
// Design. One warp per edge: the lanes stride over the features (one
// coalesced read of each row per 32 features), each lane sums its
// features in order, and an xor-shuffle butterfly adds the 32 lane sums.
// Each butterfly step adds the same two values in every lane of a pair,
// so the order is fixed and repeated runs give identical bits.
//
// Precision: FP32 products and sums on the CUDA cores, like the
// reference's precision="f32".
//
// Bound on the H100: bytes. Each edge gathers two rows (8 * F bytes) for
// 2 * F flops. The design reads each gathered row once, coalesced, and
// writes each output once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;   // edges per CTA
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
sddmm_kernel(const int32_t* __restrict__ rows,   // [>= nnz]
             const int32_t* __restrict__ cols,   // [>= nnz]
             const float* __restrict__ a,        // [n_a, F]
             const float* __restrict__ b,        // [n_b, F]
             float* __restrict__ out,            // [e_pad]
             int64_t nnz, int64_t e_pad, int F) {
  const int lane = threadIdx.x & 31;
  const int64_t e =
      static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (e >= e_pad) return;   // warp-uniform
  if (e >= nnz) {
    if (lane == 0) out[e] = 0.f;
    return;
  }
  const float* a_row = a + static_cast<size_t>(rows[e]) * F;
  const float* b_row = b + static_cast<size_t>(cols[e]) * F;
  float acc = 0.f;
#pragma unroll 4
  for (int f = lane; f < F; f += 32) acc = fmaf(a_row[f], b_row[f], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(kFull, acc, off);
  }
  if (lane == 0) out[e] = acc;
}

}  // namespace

extern "C" {

// out[e_pad] = SDDMM over the first nnz edges (rows, cols), zero beyond.
// Pointers are device pointers; `stream` is a cudaStream_t. Returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for
// shapes the kernel does not take).
int sddmm(const void* rows, const void* cols, const void* a, const void* b,
          void* out, int64_t nnz, int64_t e_pad, int F, void* stream) {
  if (e_pad <= 0 || nnz < 0 || nnz > e_pad || F <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (e_pad + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  sddmm_kernel<<<static_cast<unsigned>(blocks), WARPS * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), nnz, e_pad, F);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
