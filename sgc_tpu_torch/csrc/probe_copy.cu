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
// element each way; 8 KB and 64 KB at the probes' shapes). No launch
// comes near that bound: a call costs what one launch costs, on the card
// (a few microseconds from launch to the end of the grid) and on the
// host (the wrapper, the ctypes call and cudaLaunchKernel). So the design
// keeps both small:
//  * scale2: 16-byte float4 loads and stores when x and y both start on
//    16 bytes, single floats for the n % 4 tail and for unaligned
//    operands; a grid of as many 256-thread CTAs as the vectors need, one
//    CTA at the probe's 1,024 elements.
//  * select_blocks: thread 0 reads sel[i] once and hands it to the CTA
//    through shared memory; the block is copied as float4 when its length
//    is a multiple of 4 and both operands start on 16 bytes.
//  * probe_launch_floor launches an empty kernel: the floor that E's time
//    is read against (not a kernel of the probes; nothing counts it).
// The doubling is exact in f32, so the result equals the plain version bit
// for bit. An index out of range stops the kernel with a trap, as
// PyTorch's device-side assert does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CTAS = 132 * 8;   // one wave of 256-thread CTAs

__device__ __forceinline__ float4 twice(float4 v) {
  return make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
}

// y[n] = 2 x[n]: float4 over the first n / 4 * 4 elements when `vec`,
// then single floats
__global__ void scale2_kernel(const float* __restrict__ x,
                              float* __restrict__ y, int64_t n, int vec) {
  const int64_t tid = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* y4 = reinterpret_cast<float4*>(y);
    for (int64_t i = tid; i < n4; i += stride) y4[i] = twice(x4[i]);
    done = n4 << 2;
  }
  for (int64_t i = done + tid; i < n; i += stride) y[i] = x[i] * 2.0f;
}

// CTA i: out block i = 2 * x block sel[i], each block block_elems long
__global__ void select_blocks_kernel(const float* __restrict__ x,
                                     const int32_t* __restrict__ sel,
                                     float* __restrict__ out,
                                     int n_x_blocks, int64_t block_elems,
                                     int vec) {
  __shared__ int s_block;
  if (threadIdx.x == 0) {
    const int s = sel[blockIdx.x];
    if (s < 0 || s >= n_x_blocks) asm volatile("trap;");
    s_block = s;
  }
  __syncthreads();
  const float* src = x + static_cast<int64_t>(s_block) * block_elems;
  float* dst = out + static_cast<int64_t>(blockIdx.x) * block_elems;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int64_t e = threadIdx.x; e < block_elems >> 2; e += blockDim.x) {
      d4[e] = twice(s4[e]);
    }
  } else {
    for (int64_t e = threadIdx.x; e < block_elems; e += blockDim.x) {
      dst[e] = src[e] * 2.0f;
    }
  }
}

// the launch floor: a kernel that does nothing
__global__ void empty_kernel() {}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// y[n] = 2 x[n] (f32 device pointers; `stream` a cudaStream_t). Returns
// cudaGetLastError() after the launch.
int probe_scale2(const void* x, void* y, int64_t n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = aligned16(x) && aligned16(y);
  const int64_t work = vec ? (n + 3) >> 2 : n;
  const int64_t blocks = (work + THREADS - 1) / THREADS;
  scale2_kernel<<<static_cast<unsigned>(blocks < MAX_CTAS ? blocks
                                                          : MAX_CTAS),
                  THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n, vec);
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
  const int vec = block_elems % 4 == 0 && aligned16(x) && aligned16(out);
  select_blocks_kernel<<<n_out_blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(sel),
      static_cast<float*>(out), n_x_blocks, block_elems, vec);
  return static_cast<int>(cudaGetLastError());
}

// `reps` launches of an empty one-thread kernel on `stream`, back to back
// (0: none, only the call). Returns cudaGetLastError() after the last.
int probe_launch_floor(int reps, void* stream) {
  for (int i = 0; i < reps; ++i) {
    empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  }
  return reps > 0 ? static_cast<int>(cudaGetLastError()) : 0;
}

}  // extern "C"
