// Kernel F: a row gather, out[i, :] = x[idx[i], :] (f32), with two entries.
//
// Replaces the two TPU gather probes:
//  * scripts/exp_take_probe.py::make.kernel (:52, pallas_call :67), a
//    vectorized in-kernel gather in three JAX spellings (jnp.take, x[idx]
//    and take_along_axis): one function, out = x[idx], which the `load`
//    entry computes;
//  * scripts/exp_dma_gather_probe.py::kernel (:38, pallas_call :61), one
//    asynchronous DMA a row with an offset read at run time
//    (make_async_copy(x_hbm.at[pl.ds(col, 1)], ...)), which the `async`
//    entry computes with cp.async copies into shared memory.
//
// Bound on the H100: bytes. The function writes n_out * F * 4 bytes and
// must read each distinct row of x once plus the index; at the take
// probe's shape (65,536 rows out of a 2,048 x 768 table) the table is
// 6.3 MB and stays in the 50 MB L2, so the bound is the output's 201 MB
// over 3.35 TB/s. What the design does about it:
//  * `load`: one warp a row at a time (grid-stride over rows); each lane
//    moves 16-byte vectors (float4) when F is a multiple of 4, else single
//    floats; every lane reads the row's index (one broadcast load). Reads
//    of x go through the read-only path, so repeated rows hit L2.
//  * `async`: each CTA walks its rows (i = blockIdx.x + t * gridDim.x)
//    through a ring of N row slots in shared memory, N a launch argument
//    (1, 2, 4, 8 or 16): the copies of rows t+1 .. t+N-1 are in flight
//    (cp.async, 16-byte pieces when F is a multiple of 4, else 4-byte)
//    while row t is stored to out. Each thread stores exactly the pieces
//    it copied, so it waits only for its own copies (cp.async.wait_group)
//    and the CTA needs no barrier. The TPU probe waits on each copy
//    before it starts the next; the function is the same.
// Both entries copy bits, so they equal the plain version exactly. An
// index out of range stops the kernel with a trap, as PyTorch's
// device-side assert does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int LOAD_THREADS = 256;
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a CTA may use

__device__ __forceinline__ int64_t checked_row(const int32_t* idx,
                                               int64_t i, int n_x_rows) {
  const int r = idx[i];
  if (r < 0 || r >= n_x_rows) asm volatile("trap;");
  return r;
}

template <int VEC>
__global__ void gather_load_kernel(const float* __restrict__ x,
                                   const int32_t* __restrict__ idx,
                                   float* __restrict__ out, int64_t n_out,
                                   int F, int n_x_rows) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int n_vec = F / VEC;
  for (int64_t i = warp; i < n_out; i += n_warps) {
    const int64_t r = checked_row(idx, i, n_x_rows);
    if (VEC == 4) {
      const float4* src = reinterpret_cast<const float4*>(x + r * F);
      float4* dst = reinterpret_cast<float4*>(out + i * F);
      for (int v = lane; v < n_vec; v += 32) dst[v] = __ldg(src + v);
    } else {
      const float* src = x + r * F;
      float* dst = out + i * F;
      for (int v = lane; v < n_vec; v += 32) dst[v] = __ldg(src + v);
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int PIECE>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if (PIECE == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// N rows in flight per CTA; PIECE bytes a copy (16 or 4)
template <int N, int PIECE>
__global__ void gather_async_kernel(const float* __restrict__ x,
                                    const int32_t* __restrict__ idx,
                                    float* __restrict__ out, int64_t n_out,
                                    int F, int n_x_rows) {
  extern __shared__ __align__(16) float ring[];   // [N][F]
  constexpr int PER = PIECE / 4;                  // floats a piece
  const int pieces = F / PER;
  const int64_t first = blockIdx.x;
  const int64_t stride = gridDim.x;
  const int64_t n_mine = first < n_out ? (n_out - 1 - first) / stride + 1
                                       : 0;
  auto issue = [&](int64_t t) {
    const int64_t r = checked_row(idx, first + t * stride, n_x_rows);
    const float* src = x + r * F;
    float* slot = ring + static_cast<int64_t>(t % N) * F;
    for (int p = threadIdx.x; p < pieces; p += blockDim.x) {
      cp_async<PIECE>(slot + p * PER, src + p * PER);
    }
  };
#pragma unroll
  for (int t = 0; t < N - 1; ++t) {
    if (t < n_mine) issue(t);
    cp_commit();
  }
  for (int64_t t = 0; t < n_mine; ++t) {
    // the slot of row t + N - 1 held row t - 1, which this thread has
    // already stored (its own pieces, in program order)
    if (t + N - 1 < n_mine) issue(t + N - 1);
    cp_commit();
    cp_wait<N - 1>();   // row t's pieces of this thread have landed
    const float* slot = ring + static_cast<int64_t>(t % N) * F;
    float* dst = out + (first + t * stride) * F;
    for (int p = threadIdx.x; p < pieces; p += blockDim.x) {
      if (PIECE == 16) {
        reinterpret_cast<float4*>(dst)[p] =
            reinterpret_cast<const float4*>(slot)[p];
      } else {
        dst[p] = slot[p];
      }
    }
  }
  cp_wait<0>();
}

int grid_for(int64_t work, int per_sm) {
  const int64_t cap = 132LL * per_sm;
  return static_cast<int>(work < cap ? work : cap);
}

template <int N, int PIECE>
int launch_async(const float* x, const int32_t* idx, float* out,
                 int64_t n_out, int F, int n_x_rows, cudaStream_t stream) {
  const int smem = N * F * 4;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      gather_async_kernel<N, PIECE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pieces = F / (PIECE / 4);
  int threads = ((pieces + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  gather_async_kernel<N, PIECE>
      <<<grid_for(n_out, 16), threads, smem, stream>>>(x, idx, out, n_out,
                                                        F, n_x_rows);
  return static_cast<int>(cudaGetLastError());
}

template <int PIECE>
int dispatch_async(const float* x, const int32_t* idx, float* out,
                   int64_t n_out, int F, int n_x_rows, int in_flight,
                   cudaStream_t s) {
  switch (in_flight) {
    case 1:
      return launch_async<1, PIECE>(x, idx, out, n_out, F, n_x_rows, s);
    case 2:
      return launch_async<2, PIECE>(x, idx, out, n_out, F, n_x_rows, s);
    case 4:
      return launch_async<4, PIECE>(x, idx, out, n_out, F, n_x_rows, s);
    case 8:
      return launch_async<8, PIECE>(x, idx, out, n_out, F, n_x_rows, s);
    case 16:
      return launch_async<16, PIECE>(x, idx, out, n_out, F, n_x_rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// out[n_out, F] = x[idx] (x: f32 [n_x_rows, F], idx: int32 [n_out], all
// device pointers; `stream` a cudaStream_t), warps copying rows. Returns
// cudaGetLastError() after the launch.
int row_gather_load(const void* x, const void* idx, void* out, int64_t n_out,
                    int F, int n_x_rows, void* stream) {
  if (n_out <= 0 || F <= 0 || n_x_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* of = static_cast<float*>(out);
  const int grid = grid_for((n_out + 7) / 8, 16);   // 8 warps a CTA
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F % 4 == 0 && aligned16(x) && aligned16(out)) {
    gather_load_kernel<4><<<grid, LOAD_THREADS, 0, s>>>(xf, ix, of, n_out, F,
                                                        n_x_rows);
  } else {
    gather_load_kernel<1><<<grid, LOAD_THREADS, 0, s>>>(xf, ix, of, n_out, F,
                                                        n_x_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same function through shared memory, `in_flight` rows (1, 2, 4, 8
// or 16) in flight per CTA.
int row_gather_async(const void* x, const void* idx, void* out,
                     int64_t n_out, int F, int n_x_rows, int in_flight,
                     void* stream) {
  if (n_out <= 0 || F <= 0 || n_x_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F % 4 == 0 && aligned16(x) && aligned16(out)) {
    return dispatch_async<16>(xf, ix, of, n_out, F, n_x_rows, in_flight, s);
  }
  return dispatch_async<4>(xf, ix, of, n_out, F, n_x_rows, in_flight, s);
}

}  // extern "C"
