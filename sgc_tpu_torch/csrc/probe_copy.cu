// Kernel E: the compile-and-launch probes, y = 2 x and a block copy whose
// source block each CTA reads from an index array in device memory.
//
// Replaces scripts/exp_pallas_probe.py::kernel (o = 2 x, one (8, 128)
// block, pallas_call :22) and the kernel of scripts/exp_pallas_probe2.py
// (:25, pallas_call :34): out block i = 2 x block sel[i], the block index
// read by the BlockSpec index map from a scalar-prefetch array. On Hopper
// a CTA reads its own index from device memory: CTA i loads sel[i] and
// copies block sel[i] of x, doubled, into block i of out. The two probes
// asked whether a hand kernel compiles and runs at all on the TPU's
// backend; here the build (nvcc, a few seconds) and the first launch are
// what the probe scripts report.
//
// Bound on the H100: bytes, x read once and out written once (4 bytes an
// element each way; 8 KB and 64 KB at the probes' shapes, so a launch
// takes the launch overhead, not the bound). Design: grid-stride loops
// of one element a thread, no shared memory; the doubling is exact in
// f32, so the result equals the plain version bit for bit. An index out
// of range stops the kernel with a trap, as PyTorch's device-side
// assert does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

__global__ void scale2_kernel(const float* __restrict__ x,
                              float* __restrict__ y, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    y[i] = x[i] * 2.0f;
  }
}

// CTA i: out block i = 2 * x block sel[i], each block block_elems long
__global__ void select_blocks_kernel(const float* __restrict__ x,
                                     const int32_t* __restrict__ sel,
                                     float* __restrict__ out,
                                     int n_x_blocks, int64_t block_elems) {
  const int s = sel[blockIdx.x];
  if (s < 0 || s >= n_x_blocks) asm volatile("trap;");
  const float* src = x + static_cast<int64_t>(s) * block_elems;
  float* dst = out + static_cast<int64_t>(blockIdx.x) * block_elems;
  for (int64_t e = threadIdx.x; e < block_elems; e += blockDim.x) {
    dst[e] = src[e] * 2.0f;
  }
}

}  // namespace

extern "C" {

// y[n] = 2 x[n] (f32 device pointers; `stream` a cudaStream_t). Returns
// cudaGetLastError() after the launch.
int probe_scale2(const void* x, void* y, int64_t n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  scale2_kernel<<<static_cast<unsigned>(blocks < 132 * 16 ? blocks
                                                          : 132 * 16),
                  THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

// out[n_out_blocks * block_elems] = 2 x block sel[i], for i below
// n_out_blocks (sel: int32 [n_out_blocks] on the device; x holds
// n_x_blocks blocks). One CTA an output block.
int probe_select_blocks(const void* x, const void* sel, void* out,
                        int n_out_blocks, int n_x_blocks,
                        int64_t block_elems, void* stream) {
  if (n_out_blocks <= 0 || n_x_blocks <= 0 || block_elems <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  select_blocks_kernel<<<n_out_blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(sel),
      static_cast<float*>(out), n_x_blocks, block_elems);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
