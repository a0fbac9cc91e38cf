// Kernel G: per-edge gather-accumulate in edge order,
// out[r, :] += v * x[c, :] for each edge (r, c, v), out starting at zero.
//
// Replaces scripts/exp_gather_probe.py::kernel (:64, pallas_call :91): a
// scalar loop over a chunk of edges read from SMEM, each edge's row of
// the (W, F) x stripe scaled and added into the (R, F) out block, both
// resident in VMEM, over K chunks. Its modes isolate the per-edge ops,
// and each is a function of its own:
//   rmw        out[r] += v x[c]
//   store      out[r]  = v x[c]         (the last edge of a row wins)
//   fixed_out  out[0] += v x[c]
//   fixed_in   out[r] += v x[0]
//   noop       out[0] += v x[0]
// Every row's updates are applied in edge order with __fmul_rn and
// __fadd_rn (no contraction to FMA), so the result is the sequential
// loop's bit for bit; there are no float atomics, and two launches give
// the same bits.
//
// Design. The TPU held the out block and the stripe in VMEM (6.3 MB each
// at the probe's 2,048 x 768); a Hopper CTA has 227 KB of shared memory.
// So a CTA owns a tile of out: 32 features (one a lane) of rows_per_cta
// rows, kept in shared memory (32 KB at 256 rows), and walks every edge
// in order. The block stages the edges, 1,024 at a time, into a
// two-deep shared-memory ring with cp.async. Rows of the tile are split
// among the 8 warps (tile row r to warp r mod 8), so a row's updates are
// made by one warp, in order: each warp takes 32 edges at a time, finds
// the ones it owns with a ballot, loads the x values of up to 8 of them
// at once (independent loads in flight) and then applies them in edge
// order to the tile. The tile is written to out once at the end (rows of
// the tile that no edge touched are written as zeros).
//
// Bound on the H100: bytes, counted as ops/roofline.py counts kernel B
// on the same edges: each edge's (row, col, val), each x row the edges
// use and out once each (13.4 MB at the probe's defaults: 4 us). Every
// CTA reads all edges (from L2 after the first), so the kernel is far
// from that bound; modes fixed_out and noop put every edge on one row,
// which one warp of one CTA a feature tile applies serially, as the TPU
// loop does. An index out of range stops the kernel with a trap, as
// PyTorch's device-side assert does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int FB = 32;        // features a CTA (one a lane)
constexpr int CH = 1024;      // edges a staged chunk
constexpr int MAXB = 8;       // x loads in flight a warp
constexpr unsigned FULL = 0xffffffffu;

// mode bits
constexpr int FIXED_ROW = 1;  // every edge updates row 0
constexpr int FIXED_COL = 2;  // every edge reads x row 0
constexpr int STORE = 4;      // assign instead of add

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__global__ void __launch_bounds__(THREADS)
edge_accumulate_kernel(const int32_t* __restrict__ rows,
                       const int32_t* __restrict__ cols,
                       const float* __restrict__ vals,
                       const float* __restrict__ x, float* __restrict__ out,
                       int64_t n_edges, int R, int W, int F,
                       int rows_per_cta, int mode) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                                   // [rows_per_cta][FB]
  int32_t* ring = reinterpret_cast<int32_t*>(smem + rows_per_cta * FB);
  // ring slot s: rows [CH], cols [CH], vals [CH] (as bits)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int f = blockIdx.x * FB + lane;
  const int row0 = blockIdx.y * rows_per_cta;
  const int n_tile_rows = min(rows_per_cta, R - row0);
  const bool fixed_row = mode & FIXED_ROW;
  const bool fixed_col = mode & FIXED_COL;
  const bool store = mode & STORE;

  for (int i = tid; i < rows_per_cta * FB; i += THREADS) tile[i] = 0.f;

  const int64_t n_chunks = (n_edges + CH - 1) / CH;
  auto stage = [&](int64_t k) {
    int32_t* slot = ring + (k & 1) * 3 * CH;
    const int64_t base = k * CH;
    for (int i = tid; i < CH; i += THREADS) {
      const int64_t e = base + i;
      if (e < n_edges) {
        cp_async4(slot + i, rows + e);
        cp_async4(slot + CH + i, cols + e);
        cp_async4(slot + 2 * CH + i, vals + e);
      }
    }
  };
  stage(0);
  cp_commit();
  for (int64_t k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) stage(k + 1);
    cp_commit();
    cp_wait1();        // chunk k has landed (this thread's part) ...
    __syncthreads();   // ... and every thread's; the tile zeroing too
    const int32_t* slot = ring + (k & 1) * 3 * CH;
    const int64_t base = k * CH;
    const int n_here = static_cast<int>(
        n_edges - base < CH ? n_edges - base : CH);
    for (int g = 0; g < n_here; g += 32) {
      const int e = g + lane;
      int r = 0, c = 0;
      float v = 0.f;
      bool owned = false;
      if (e < n_here) {
        r = fixed_row ? 0 : slot[e];
        c = fixed_col ? 0 : slot[CH + e];
        v = __int_as_float(slot[2 * CH + e]);
        if (r < 0 || r >= R || c < 0 || c >= W) asm volatile("trap;");
        const int lr = r - row0;
        owned = lr >= 0 && lr < n_tile_rows && (lr % WARPS) == warp;
      }
      unsigned mask = __ballot_sync(FULL, owned);
      while (mask) {
        int src[MAXB];
        int nb = 0;
#pragma unroll
        for (int b = 0; b < MAXB; ++b) {
          src[b] = -1;
          if (mask) {
            src[b] = __ffs(mask) - 1;
            mask &= mask - 1;
            nb = b + 1;
          }
        }
        int rr[MAXB];
        float vv[MAXB], xv[MAXB];
#pragma unroll
        for (int b = 0; b < MAXB; ++b) {
          if (b < nb) {   // warp-uniform
            const int cc = __shfl_sync(FULL, c, src[b]);
            rr[b] = __shfl_sync(FULL, r, src[b]) - row0;
            vv[b] = __shfl_sync(FULL, v, src[b]);
            xv[b] = f < F ? __ldg(x + static_cast<int64_t>(cc) * F + f)
                          : 0.f;
          }
        }
#pragma unroll
        for (int b = 0; b < MAXB; ++b) {
          if (b < nb) {
            float* t = tile + rr[b] * FB + lane;
            const float p = __fmul_rn(vv[b], xv[b]);
            *t = store ? p : __fadd_rn(*t, p);
          }
        }
      }
    }
    __syncthreads();   // the slot is free for chunk k + 2
  }
  asm volatile("cp.async.wait_all;\n" ::);
  if (f < F) {
    for (int lr = warp; lr < n_tile_rows; lr += WARPS) {
      out[static_cast<int64_t>(row0 + lr) * F + f] = tile[lr * FB + lane];
    }
  }
}

}  // namespace

extern "C" {

// out[R, F] (f32, written whole) = the edges' updates in edge order; rows,
// cols int32 [n_edges], vals f32 [n_edges], x f32 [W, F], all device
// pointers; `mode` the bits FIXED_ROW = 1, FIXED_COL = 2, STORE = 4;
// `rows_per_cta` the rows of out a CTA keeps in shared memory (at most
// 1,024). Returns cudaGetLastError() after the launch.
int edge_accumulate(const void* rows, const void* cols, const void* vals,
                    const void* x, void* out, int64_t n_edges, int R, int W,
                    int F, int rows_per_cta, int mode, void* stream) {
  if (R <= 0 || W <= 0 || F <= 0 || n_edges < 0 || rows_per_cta <= 0 ||
      rows_per_cta > 1024 || (mode & ~7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = (rows_per_cta * FB + 3 * 2 * CH) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      edge_accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + FB - 1) / FB, (R + rows_per_cta - 1) / rows_per_cta);
  edge_accumulate_kernel<<<grid, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<const float*>(vals), static_cast<const float*>(x),
      static_cast<float*>(out), n_edges, R, W, F, rows_per_cta, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
