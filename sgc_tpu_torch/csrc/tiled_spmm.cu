// Tiled SpMM over the cell-chunk layout of ops/spmm_tiled.py::tile_graph
// (kernel C of the port): for every row block rb and feature f,
//   out[r, f] = sum over rb's chunks, in layout order, of
//               vals[e] * x[cols[e], f]   for the slots e with rows[e] == r.
// Only each chunk's first chunk_nnz[k] slots are edges; the rest of a
// cell's last chunk is padding (val 0), which adds nothing and is skipped.
//
// Replaces sgc_tpu/ops/spmm_pallas.py::_spmm_flat_kernel (flat chunk
// schedule, reached through spmm_pallas_flat and the one-hot hybrid hop)
// and ::_spmm_kernel (stripe walk, reached through spmm_pallas_tiled).
// Both compute the same function over the same layout; the host builds
// one per-row-block chunk index (rb_chunk_ptr, chunk_st) from either
// schedule, and every row block is written, so a row block with no chunk
// is zero (the first kernel zeroed its accumulator, the flat one was
// masked afterwards).
//
// Design. The TPU kernels gathered and scattered with one-hot matmuls on
// the MXU; here the gather is direct (GE-SpMM). One CTA owns a
// (row tile, 32-feature tile) of one row block, one lane per feature:
//   * the stripe x[st*W : st*W + W, f-tile] is staged in shared memory
//     once per cell (masked past n_cols and F; stripes wider than
//     W_STAGED_MAX are read straight from global memory instead);
//   * every warp owns a fixed range of the tile's rows and keeps their
//     sums in its own rows of a shared-memory accumulator. A chunk's
//     edges are (row, col)-sorted, so the warp finds its slots by a
//     warp-wide search (32 probes per step) and walks them in layout
//     order: 32 slots are loaded coalesced and broadcast lane to lane,
//     each run of equal rows is summed in a register and added to the
//     row once. No other warp touches those rows, so there are no float
//     atomics and no partial sums to combine: each (row, feature) sum is
//     taken by one thread in a fixed order, and every run gives identical
//     bits (the reference's determinism convention,
//     sgc_tpu/ops/spmm.py:18-24). The only barriers are those around a
//     stripe change;
//   * row blocks taller than RT_MAX rows are split across CTAs.
// Rows beyond n_rows are not written; the caller pads nothing.
//
// Precision: FP32 products and sums on the CUDA cores; x stays f32, so
// the result agrees with the plain version to f32 rounding (the
// reference's precision="f32": exact selection, f32 accumulation).
//
// Bound on the H100: bytes. Per slot and feature tile the kernel does 2
// flops per feature against 12 bytes of edge data plus the stripe rows
// it stages, far under the ~20 flops per byte where FP32 would bound it.
// The design keeps the bytes to the edge slots once per feature tile and
// each stripe once per (cell, feature tile): the stripe is reused by
// every edge of the cell from shared memory, and the output is written
// once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int FT = 32;               // features per CTA, one per lane
constexpr int WARPS = 32;
constexpr int THREADS = WARPS * 32;
constexpr int RT_MAX = 512;          // rows per CTA
constexpr int W_STAGED_MAX = 1024;   // widest stripe staged in shared memory
constexpr unsigned FULL = 0xffffffffu;

// First index in [lo, hi) whose a[] is >= key (hi if none), a sorted on
// [lo, hi); every lane of the warp returns it. Each step probes 32
// evenly spaced entries at once and keeps the gap that holds the answer.
__device__ __forceinline__ int warp_lower_bound(const int32_t* a, int lo,
                                                int hi, int key, int lane) {
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + (lane + 1) * step - 1;
    const int n = __popc(__ballot_sync(FULL, p < hi && a[p] < key));
    const int new_hi = min(hi, lo + (n + 1) * step - 1);
    lo += n * step;
    hi = new_hi;
  }
  const int p = lo + lane;
  return lo + __popc(__ballot_sync(FULL, p < hi && a[p] < key));
}

size_t smem_bytes(int RT, int W, bool staged) {
  return sizeof(float) *
         (static_cast<size_t>(RT) * FT +
          (staged ? static_cast<size_t>(W) * FT : 0));
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
tiled_spmm_kernel(const int32_t* __restrict__ rows,      // [slots]
                  const int32_t* __restrict__ cols,      // [slots]
                  const float* __restrict__ vals,        // [slots]
                  const int32_t* __restrict__ rb_chunk_ptr,  // [n_rb + 1]
                  const int32_t* __restrict__ chunk_st,  // [n_chunks]
                  const int32_t* __restrict__ chunk_nnz, // [n_chunks]
                  const float* __restrict__ x,           // [n_cols, F]
                  float* __restrict__ out,               // [n_rows, F]
                  int n_rows, int n_cols, int F, int R, int W, int C,
                  int RT) {
  extern __shared__ __align__(16) float smem[];
  float* acc = smem;                     // [RT][FT]
  float* xs = smem + RT * FT;            // [W][FT] if STAGED

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_rt = (R + RT - 1) / RT;
  const int rb = blockIdx.x / n_rt;
  const int rt0 = (blockIdx.x % n_rt) * RT;     // first local row of the CTA
  const int rt_rows = min(RT, R - rt0);
  const int f = blockIdx.y * FT + lane;
  const bool f_ok = f < F;
  const int row_base = rb * R;

  // this warp's rows, local to the CTA: [w_lo, w_hi)
  const int per_warp = (rt_rows + WARPS - 1) / WARPS;
  const int w_lo = min(rt_rows, warp * per_warp);
  const int w_hi = min(rt_rows, w_lo + per_warp);
  const int key_lo = row_base + rt0 + w_lo;
  const int key_hi = row_base + rt0 + w_hi;
  for (int i = w_lo; i < w_hi; ++i) acc[i * FT + lane] = 0.f;

  const int k_end = rb_chunk_ptr[rb + 1];
  int staged_st = -1;
  for (int k = rb_chunk_ptr[rb]; k < k_end; ++k) {
    const int st = chunk_st[k];
    const int col0 = st * W;
    if (STAGED && st != staged_st) {   // the same for the whole CTA
      __syncthreads();                 // every warp is done with the old one
#pragma unroll 4
      for (int i = warp; i < W; i += WARPS) {
        const int c = col0 + i;
        xs[i * FT + lane] =
            (f_ok && c < n_cols) ? x[static_cast<size_t>(c) * F + f] : 0.f;
      }
      staged_st = st;
      __syncthreads();
    }
    if (w_lo == w_hi) continue;
    const int64_t base = static_cast<int64_t>(k) * C;
    const int32_t* kr = rows + base;
    const int nnz = chunk_nnz[k];
    const int a = warp_lower_bound(kr, 0, nnz, key_lo, lane);
    const int b = warp_lower_bound(kr, a, nnz, key_hi, lane);

    int cur = -1;                      // local row of the open run
    float run = 0.f;
    for (int e0 = a; e0 < b; e0 += 32) {
      const int n = min(32, b - e0);
      int my_r = 0, my_c = 0;
      float my_v = 0.f;
      if (lane < n) {
        my_r = kr[e0 + lane] - row_base - rt0;
        my_c = cols[base + e0 + lane] - col0;
        my_v = vals[base + e0 + lane];
      }
      for (int j = 0; j < n; ++j) {
        const int r = __shfl_sync(FULL, my_r, j);
        const int c = __shfl_sync(FULL, my_c, j);
        const float v = __shfl_sync(FULL, my_v, j);
        float xv;
        if (STAGED) {
          xv = xs[c * FT + lane];
        } else {
          xv = f_ok ? __ldg(x + static_cast<size_t>(col0 + c) * F + f) : 0.f;
        }
        if (r != cur) {
          if (cur >= 0) acc[cur * FT + lane] += run;
          cur = r;
          run = 0.f;
        }
        run = fmaf(v, xv, run);
      }
    }
    if (cur >= 0) acc[cur * FT + lane] += run;
  }

  if (!f_ok) return;
  for (int i = w_lo; i < w_hi; ++i) {
    const int64_t g = static_cast<int64_t>(row_base) + rt0 + i;
    if (g < n_rows) out[g * F + f] = acc[i * FT + lane];
  }
}

template <bool STAGED>
int launch(const void* rows, const void* cols, const void* vals,
           const void* rb_chunk_ptr, const void* chunk_st,
           const void* chunk_nnz, const void* x, void* out, int n_rb,
           int n_rows, int n_cols, int F, int R, int W, int C,
           cudaStream_t stream) {
  const int RT = R < RT_MAX ? R : RT_MAX;
  const size_t smem = smem_bytes(RT, W, STAGED);
  cudaError_t err = cudaFuncSetAttribute(
      tiled_spmm_kernel<STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_rb * ((R + RT - 1) / RT), (F + FT - 1) / FT);
  tiled_spmm_kernel<STAGED><<<grid, THREADS, smem, stream>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<const float*>(vals),
      static_cast<const int32_t*>(rb_chunk_ptr),
      static_cast<const int32_t*>(chunk_st),
      static_cast<const int32_t*>(chunk_nnz), static_cast<const float*>(x),
      static_cast<float*>(out), n_rows, n_cols, F, R, W, C, RT);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[n_rows, F] = the tiled SpMM over n_rb row blocks of R rows. Slot
// arrays have rb_chunk_ptr[n_rb] * C entries; rb's chunks are
// [rb_chunk_ptr[rb], rb_chunk_ptr[rb + 1]), chunk k lies in stripe
// chunk_st[k] of width W and its first chunk_nnz[k] slots are edges,
// sorted by (row, col). Pointers are device pointers; `stream` is a
// cudaStream_t. Returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for shapes the kernel does not take).
int tiled_spmm(const void* rows, const void* cols, const void* vals,
               const void* rb_chunk_ptr, const void* chunk_st,
               const void* chunk_nnz, const void* x, void* out, int n_rb,
               int n_rows, int n_cols, int F, int R, int W, int C,
               void* stream) {
  if (n_rb <= 0 || F <= 0 || R <= 0 || W <= 0 || C <= 0 ||
      static_cast<int64_t>(n_rb) * R < n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return W <= W_STAGED_MAX
             ? launch<true>(rows, cols, vals, rb_chunk_ptr, chunk_st,
                            chunk_nnz, x, out, n_rb, n_rows, n_cols, F, R, W,
                            C, s)
             : launch<false>(rows, cols, vals, rb_chunk_ptr, chunk_st,
                             chunk_nnz, x, out, n_rb, n_rows, n_cols, F, R,
                             W, C, s);
}

}  // extern "C"
