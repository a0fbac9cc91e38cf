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
// sgc_tpu/ops/spmm.py::sddmm. Rows are read straight from global memory,
// so a and b have no size limit and may have different row counts.
//
// Precision (`bf16` flag): 0 reads f32 a and b; 1 is the reference's
// precision="bf16": b is a bf16 copy that the wrapper makes (rows padded
// with zeros to a multiple of 4 elements, so every row starts 8-byte
// aligned), and a's f32 rows are rounded to bf16 in registers (nearest
// even, as the copy does). Products and sums are f32 either way.
//
// Design: the graph's own edge list, no host index. One warp per segment
// of SEG consecutive edges (the segments cut long rows, so no warp holds
// its CTA while a hub row runs long). The graph keeps its edges in row
// order, so a segment is a few runs of one row each: the warp loads the
// run's row of a once into registers (float2 per slot where F is even and
// the rows 8-byte aligned, 640 features a pass; rounded there at bf16),
// then gathers each edge's b row in coalesced vector loads, EIF = 4 edges
// in flight, their lane sums reduced together by one transposing
// butterfly (6 shuffles for 4 edges). A run ends where the row changes,
// found per 32 edges by one ballot, so any edge order gives the right sums
// (an unsorted list only reloads a more often).
//
// Bound on the H100: bytes. Each edge needs 2 * F flops against two
// operand rows; counting each row of a and b once, the function moves
// (n_a + n_b) * F * s bytes, while the kernel gathers one b row per edge,
// ~F * s bytes an edge. In the LPA order those rows come mostly from L2.
// A shared-memory design that staged each dense (row block, stripe)
// cell's rows of a and b once per cell was built and measured slower than
// this gather at every cell density of the clustered Reddit operator
// (PERF.md, kernel D's findings), and was removed.
//
// No tensor cores: the graph's cells are under 1% full, so a dense
// a_cell @ b_stripe^T product would do ~100x the needed flops, and the
// function is bound by bytes, not flops. No atomics: every edge's value is
// summed in a fixed order (features in order within a lane, a fixed
// butterfly across lanes, passes in order) and written by one lane, so two
// launches give identical bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int SEG = 64;        // edges per warp
constexpr int WARPS = 4;       // warps per CTA
constexpr int EIF = 4;         // edges in flight per warp

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
// x rounded to bf16 (nearest even) and widened back
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// VEC elements of T at p (aligned to their size), widened to f32
template <typename T, int VEC> struct Load;
template <> struct Load<float, 1> {
  __device__ static void run(const float* p, float* o) { o[0] = __ldg(p); }
};
template <> struct Load<float, 2> {
  __device__ static void run(const float* p, float* o) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = v.x;
    o[1] = v.y;
  }
};
template <> struct Load<uint16_t, 4> {
  __device__ static void run(const uint16_t* p, float* o) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    o[0] = bf16_lo(v.x);
    o[1] = bf16_hi(v.x);
    o[2] = bf16_lo(v.y);
    o[3] = bf16_hi(v.y);
  }
};

// N values in each lane of a warp -> every lane holds the warp sum of
// value lane / (32 / N): transposing rounds over the top lane bits, then
// a butterfly over the rest.
template <int N>
__device__ __forceinline__ float warp_transpose_reduce(float (&v)[N],
                                                       int lane) {
#pragma unroll
  for (int half = N / 2, off = 16; half >= 1; half /= 2, off /= 2) {
    const bool hi = lane & off;
#pragma unroll
    for (int t = 0; t < half; ++t) {
      const float keep = hi ? v[half + t] : v[t];
      const float send = hi ? v[t] : v[half + t];
      v[t] = keep + __shfl_xor_sync(kFull, send, off);
    }
  }
#pragma unroll
  for (int off = 16 / N; off >= 1; off /= 2) {
    v[0] += __shfl_xor_sync(kFull, v[0], off);
  }
  return v[0];
}

// one warp per segment of SEG edges; VEC elements of b (type TB) per
// slot, NV slots per lane, so 32 * VEC * NV features per pass (each pass
// after the first adds to out[e], written by the same lane). a is f32,
// read in chunks of AV floats and, when b is bf16, rounded to bf16.
template <typename TB, int VEC, int NV, int AV>
__global__ void __launch_bounds__(WARPS * 32, 2)
sddmm_kernel(const int32_t* __restrict__ rows,
             const int32_t* __restrict__ cols,
             const float* __restrict__ a, const TB* __restrict__ b,
             float* __restrict__ out, int64_t nnz, int F, int ld) {
  constexpr int PASS = 32 * VEC * NV;
  const int lane = threadIdx.x & 31;
  const int64_t p0 =
      (static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5)) * SEG;
  if (p0 >= nnz) return;   // warp-uniform
  const int64_t p1 = p0 + SEG < nnz ? p0 + SEG : nnz;
  for (int f0 = 0; f0 < F; f0 += PASS) {
    float av[NV][VEC];
    int cur = -1;   // the row of a held in av
    for (int64_t pb = p0; pb < p1; pb += 32) {
      const int cnt = p1 - pb < 32 ? static_cast<int>(p1 - pb) : 32;
      const int my_row = lane < cnt ? rows[pb + lane] : -1;
      const int my_col = lane < cnt ? cols[pb + lane] : 0;
      for (int k = 0; k < cnt;) {   // one run of equal rows at a time
        const int r = __shfl_sync(kFull, my_row, k);
        const unsigned ends =
            __ballot_sync(kFull, lane > k && lane < cnt && my_row != r);
        const int k_end = ends ? __ffs(ends) - 1 : cnt;
        if (r != cur) {   // warp-uniform
          const float* ar = a + static_cast<size_t>(r) * F;
#pragma unroll
          for (int i = 0; i < NV; ++i)
#pragma unroll
            for (int c = 0; c < VEC; c += AV) {
              const int f = f0 + (lane + 32 * i) * VEC + c;
              if (f < F) {
                Load<float, AV>::run(ar + f, av[i] + c);
              } else {
#pragma unroll
                for (int v = 0; v < AV; ++v) av[i][c + v] = 0.f;
              }
            }
          if constexpr (sizeof(TB) == 2) {
#pragma unroll
            for (int i = 0; i < NV; ++i)
#pragma unroll
              for (int v = 0; v < VEC; ++v) av[i][v] = bf16_round(av[i][v]);
          }
          cur = r;
        }
        for (; k < k_end; k += EIF) {
          float s[EIF];
#pragma unroll
          for (int u = 0; u < EIF; ++u) {
            const int c = __shfl_sync(kFull, my_col, (k + u) & 31);
            s[u] = 0.f;
            if (k + u < k_end) {   // warp-uniform
              const TB* br = b + static_cast<size_t>(c) * ld;
              float bv[NV][VEC];
#pragma unroll
              for (int i = 0; i < NV; ++i) {
                const int f = f0 + (lane + 32 * i) * VEC;
                if (f < F) {
                  Load<TB, VEC>::run(br + f, bv[i]);
                } else {
#pragma unroll
                  for (int v = 0; v < VEC; ++v) bv[i][v] = 0.f;
                }
              }
              float acc = 0.f;
#pragma unroll
              for (int i = 0; i < NV; ++i)
#pragma unroll
                for (int v = 0; v < VEC; ++v) acc = fmaf(av[i][v], bv[i][v],
                                                         acc);
              s[u] = acc;
            }
          }
          const float v = warp_transpose_reduce<EIF>(s, lane);
          const int u = lane / (32 / EIF);
          if (lane % (32 / EIF) == 0 && k + u < k_end) {
            const int64_t e = pb + k + u;
            out[e] = f0 == 0 ? v : out[e] + v;
          }
        }
        k = k_end;
      }
    }
  }
}

bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

template <typename TB, int VEC, int NV, int AV>
int launch(const void* rows, const void* cols, const void* a, const void* b,
           void* out, int64_t nnz, int F, int ld, cudaStream_t s) {
  const int64_t per_cta = static_cast<int64_t>(WARPS) * SEG;
  const int64_t blocks = (nnz + per_cta - 1) / per_cta;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  sddmm_kernel<TB, VEC, NV, AV>
      <<<static_cast<unsigned>(blocks), WARPS * 32, 0, s>>>(
          static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
          static_cast<const float*>(a), static_cast<const TB*>(b),
          static_cast<float*>(out), nnz, F, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[e_pad] = SDDMM of a and b over the graph's first nnz edges (rows,
// cols: int32, in any order, fastest in row order), zero beyond. `a` is
// f32 [n_a, F]; `b` has row stride `ld` in its elements. `bf16` selects
// the bf16 mode: b is bf16 (ld % 4 == 0, rows zero-padded past F, 8-byte
// aligned). Pointers are device pointers; `stream` is a cudaStream_t.
// Clears the padding slots, then launches the kernel when nnz > 0;
// returns the first CUDA error (cudaErrorInvalidValue for shapes the
// kernel does not take).
int sddmm(const void* rows, const void* cols, const void* a, const void* b,
          void* out, int64_t nnz, int64_t e_pad, int F, int ld, int bf16,
          void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (nnz < 0 || nnz > e_pad || F <= 0 || ld < F) return bad;
  if (bf16 && (ld % 4 != 0 || !aligned(b, 8))) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e_pad > nnz) {
    const cudaError_t e = cudaMemsetAsync(
        static_cast<float*>(out) + nnz, 0, (e_pad - nnz) * sizeof(float), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (nnz == 0) return 0;
  // a's rows in float2 chunks where its rows are 8-byte aligned
  const bool a2 = F % 2 == 0 && aligned(a, 8);
  if (bf16 && a2) {
    return launch<uint16_t, 4, 5, 2>(rows, cols, a, b, out, nnz, F, ld, s);
  }
  if (bf16) {
    return launch<uint16_t, 4, 5, 1>(rows, cols, a, b, out, nnz, F, ld, s);
  }
  if (a2 && ld % 2 == 0 && aligned(b, 8)) {
    return launch<float, 2, 10, 2>(rows, cols, a, b, out, nnz, F, ld, s);
  }
  return launch<float, 1, 10, 1>(rows, cols, a, b, out, nnz, F, ld, s);
}

}  // extern "C"
