// Dense-cell term of the block-dense SpMM: a block-sparse (BSR) product
// with bf16 R x W cells, out[rb] = sum over the row block's cells of
// cell @ x[stripe], computed in FP32 on the CUDA cores.
//
// Replaces sgc_tpu/ops/spmm_blockdense.py::_blockdense_super_kernel
// (super_rows=8, the main path) and ::_blockdense_kernel (super_rows=None):
// both compute the same function, with cells in (rb//S, st, rb) and
// (rb, st) order. The host builds one per-row-block index (rb_ptr,
// cell_of) from either order; within a row block the cells run in
// ascending stripe order, as in both reference layouts.
//
// Design. The TPU kernel kept an S*R x Ft f32 panel (10.5 MB) resident in
// VMEM; an SM has at most 227 KB of shared memory, so here each CTA owns a
// BM x BN output tile of one row block, walks that row block's cells in
// index order and each cell's W-deep k range in BK steps, staging a bf16
// cell sub-tile (widened to f32) and an f32 x sub-tile in shared memory
// and accumulating an 8 x 8 register tile per thread. `out` is written
// once; a row block with no cells writes zeros (the reference masks those
// rows instead). Ragged edges are masked here, not padded by the caller:
// rows >= n_rows are not written, x rows >= n_cols and features >= F read
// as zero.
//
// Precision: FP32 FMA on the CUDA cores, no TF32, so the result matches
// the plain PyTorch version to f32 rounding (only the order of the sum
// differs). Moving to bf16 tensor-core MMA (what the TPU's MXU did) is
// later work.
//
// Bound on the H100: operations. 2*R*W*F flops per cell against the FP32
// peak; the cells' bytes (R*W*2 per cell) are ~300x fewer than the flops.
//
// Deterministic: fixed cell order, fixed k order, no atomics.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;     // output rows per CTA (a slice of a row block)
constexpr int BN = 128;     // output features per CTA
constexpr int BK = 16;      // k depth staged per step
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
blockdense_cells_kernel(const uint16_t* __restrict__ cells,   // bf16 [C, R, W]
                        const float* __restrict__ x,          // [n_cols, F]
                        float* __restrict__ out,              // [n_rows, F]
                        const int32_t* __restrict__ rb_ptr,   // [n_rb + 1]
                        const int32_t* __restrict__ cell_of,  // slots by rb
                        const int32_t* __restrict__ st_ids,   // per slot
                        int n_rows, int n_cols, int F, int R, int W) {
  __shared__ __align__(16) float As[BK][BM];   // cell sub-tile, k-major
  __shared__ __align__(16) float Bs[BK][BN];   // x sub-tile

  const int tid = threadIdx.x;
  const int tiles_per_rb = R / BM;
  const int rb = blockIdx.x / tiles_per_rb;
  const int row0 = (blockIdx.x % tiles_per_rb) * BM;   // within the row block
  const int f0 = blockIdx.y * BN;

  // thread (ty, tx) owns rows {ty*4 + i, 64 + ty*4 + i} and features
  // {tx*4 + j, 64 + tx*4 + j}: float4 shared-memory reads, no conflicts
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // cell loader: one 16-byte load of 8 bf16 per thread per k step
  const int a_m = tid >> 1;
  const int a_k = (tid & 1) * 8;
  // x loader: one feature column per thread, BK / 2 rows
  const int b_n = tid & (BN - 1);
  const int b_k = tid / BN;
  const bool b_col_ok = f0 + b_n < F;

  const int c_begin = rb_ptr[rb];
  const int c_end = rb_ptr[rb + 1];
  for (int c = c_begin; c < c_end; ++c) {
    const int slot = cell_of[c];
    const uint16_t* a_row =
        cells + static_cast<size_t>(slot) * R * W +
        static_cast<size_t>(row0 + a_m) * W + a_k;
    const int x_row0 = st_ids[slot] * W;
    for (int k0 = 0; k0 < W; k0 += BK) {
      // 8 bf16 in 4 words, element 2i in the low half of word i
      const uint4 packed = *reinterpret_cast<const uint4*>(a_row + k0);
      const uint32_t words[4] = {packed.x, packed.y, packed.z, packed.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        As[a_k + 2 * i][a_m] = __uint_as_float(words[i] << 16);
        As[a_k + 2 * i + 1][a_m] = __uint_as_float(words[i] & 0xffff0000u);
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int kk = b_k + 2 * i;
        const int xr = x_row0 + k0 + kk;
        Bs[kk][b_n] = (b_col_ok && xr < n_cols)
                          ? x[static_cast<size_t>(xr) * F + f0 + b_n]
                          : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
        const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    const int64_t grow = static_cast<int64_t>(rb) * R + r;
    if (grow >= n_rows) continue;
    float* out_row = out + grow * F;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = f0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (f < F) out_row[f] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// out[n_rows, F] = dense-cell term. Pointers are device pointers; `stream`
// is a cudaStream_t. Returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for shapes the kernel does not take).
int blockdense_cells(const void* cells, const void* x, void* out,
                     const void* rb_ptr, const void* cell_of,
                     const void* st_ids, int n_rb, int n_rows, int n_cols,
                     int F, int R, int W, void* stream) {
  if (R % BM != 0 || W % BK != 0 || n_rb <= 0 || F <= 0 ||
      static_cast<int64_t>(n_rb) * R < n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_rb * (R / BM), (F + BN - 1) / BN);
  blockdense_cells_kernel<<<grid, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(cells), static_cast<const float*>(x),
      static_cast<float*>(out), static_cast<const int32_t*>(rb_ptr),
      static_cast<const int32_t*>(cell_of),
      static_cast<const int32_t*>(st_ids), n_rows, n_cols, F, R, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
