// Kernel H: the dense-cell term on int8 cells with a scale per cell,
// out[rb] = sum over the row block's cells of bf16(f32(cell) * scale) @
// xs[stripe], summed in f32, x given as a bf16 stripe table.
//
// Replaces scripts/exp_dense_term.py::kernel_i8 (:129, pallas_call
// :153), the experiment that halves kernel A's cell bytes: cells
// quantized per cell (scale = max(max|cell|, 1e-30) / 127, rint, clip
// +-127, :109-121), dequantized to bf16 in the kernel and multiplied on
// the MXU with an f32 sum. The TPU kernel zeroes its output block when
// the row-block id changes from one grid step to the next, which is only
// right for cells in (rb, st) order; the split it is run on is in
// super-row order, so its output there is wrong. This kernel computes
// the intended function in any cell order: the host builds one index per
// row block (rb_ptr, cell_of) from the cells' rb ids, as for kernel A.
//
// Design: kernel A's (csrc/blockdense.cu) at one x term. Each CTA owns a
// 128 x 128 output tile of one row block and walks that row block's cells
// in index order, 32 deep a stage, through a 4-deep cp.async ring; the
// stage's int8 cell tile (4 KB, 16 bytes a thread) and bf16 x tile come
// in by cp.async. Each thread then dequantizes the 16 cell bytes it
// copied, bf16(__fmul_rn(f32(q), scale)) with round to nearest even as
// the reference does, into a bf16 tile in shared memory, and 8 warps run
// mma.sync.m16n8k16 bf16 -> f32 on it with ldmatrix fragments. Each
// stage's products are summed on the tensor cores from zero and added to
// the accumulator by an f32 add that rounds to nearest (kernel A's "f32"
// scheme), so the long sum over a row block's cells is not left to the
// tensor cores' truncating accumulation. The card's int8 tensor-core
// path (s8 x s8) is not this function: x is not quantized.
//
// Bound on the H100: bytes. The function reads each int8 cell once (1
// byte an entry, half of kernel A's), the scales, the bf16 x table, the
// index, and writes out once; its operations, 2 F per nonzero entry of
// the int8 cells, are far below the bf16 tensor-core peak at the main
// split's 0.75% fill. The kernel does the dense form's work, 2 R W F an
// cell, as kernel A does.
//
// `out` [n_rb * R, F_pad] is written once; a row block with no cell gets
// zeros. Deterministic: fixed cell, k and add order, no atomics. A stripe
// id out of range stops the kernel with a trap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;       // output rows per CTA
constexpr int BN = 128;       // output features per CTA
constexpr int BK = 32;        // k depth per stage
constexpr int THREADS = 256;  // 8 warps: 2 along rows x 4 along features
constexpr int STAGES = 4;
constexpr int A8_LD = BK + 16;   // bytes per int8 cell-tile row (16-aligned)
constexpr int A_LD = BK + 8;     // bf16 per dequantized cell-tile row
constexpr int B_LD = BN + 8;     // bf16 per x-tile row
constexpr int A8_TILE = BM * A8_LD;                 // bytes
constexpr int B_TILE = BK * B_LD;                   // bf16
constexpr int STAGE_BYTES = A8_TILE + B_TILE * 2;
constexpr int A_TILE_BYTES = BM * A_LD * 2;
constexpr size_t SMEM = static_cast<size_t>(STAGES) * STAGE_BYTES +
                        A_TILE_BYTES;
static_assert(BM * BK == THREADS * 16, "one 16-byte piece a thread");
static_assert(STAGE_BYTES % 16 == 0, "stages stay 16-byte aligned");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row-major) @ b (16 x 8, col-major), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two int8 values -> bf16(f32(q) * scale) each, round to nearest even
__device__ __forceinline__ uint32_t dequant2(int q0, int q1, float scale) {
  const __nv_bfloat162 h =
      __floats2bfloat162_rn(__fmul_rn(static_cast<float>(q0), scale),
                            __fmul_rn(static_cast<float>(q1), scale));
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ int sbyte(uint32_t w, int i) {
  return static_cast<int>(static_cast<int8_t>((w >> (8 * i)) & 0xffu));
}

__global__ void __launch_bounds__(THREADS, 2)
blockdense_int8_kernel(const int8_t* __restrict__ cells,   // [C, R, W]
                       const float* __restrict__ scales,   // [C]
                       const uint16_t* __restrict__ xs,    // bf16 [n_x_rows, F_pad]
                       float* __restrict__ out,            // [n_rb * R, F_pad]
                       const int32_t* __restrict__ rb_ptr, // [n_rb + 1]
                       const int32_t* __restrict__ cell_of,
                       const int32_t* __restrict__ st_ids, // per slot
                       int F_pad, int R, int W, int n_st, int n_ft) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* a_tile = reinterpret_cast<uint16_t*>(smem + STAGES * STAGE_BYTES);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;   // rows wm * 64 of the tile
  const int wn = warp & 3;    // features wn * 32 of the tile
  const int tile = blockIdx.x / n_ft;
  const int f0 = (blockIdx.x % n_ft) * BN;
  const int tiles_per_rb = R / BM;
  const int rb = tile / tiles_per_rb;
  const int row0 = (tile % tiles_per_rb) * BM;   // within the row block

  const int k_steps = W / BK;
  const int c_begin = rb_ptr[rb];
  const int n_steps = (rb_ptr[rb + 1] - c_begin) * k_steps;
  // this thread's 16 cell bytes of every stage: row a_r, bytes a_c ..
  const int a_r = tid >> 1;
  const int a_c = (tid & 1) * 16;

  auto load = [&](int step, int buf) {
    const int slot = cell_of[c_begin + step / k_steps];
    const int k0 = (step % k_steps) * BK;
    uint8_t* a8 = smem + buf * STAGE_BYTES;
    uint16_t* bs = reinterpret_cast<uint16_t*>(a8 + A8_TILE);
    cp_async16(smem_addr(a8 + a_r * A8_LD + a_c),
               cells + static_cast<size_t>(slot) * R * W +
                   static_cast<size_t>(row0 + a_r) * W + k0 + a_c);
    const int st = st_ids[slot];
    if (st < 0 || st >= n_st) asm volatile("trap;");
    const uint16_t* b_src =
        xs + static_cast<size_t>(st * W + k0) * F_pad + f0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // 32 rows x 16 chunks of 8 bf16
      const int idx = tid + i * THREADS;
      const int r = idx >> 4, ch = (idx & 15) * 8;
      cp_async16(smem_addr(bs + r * B_LD + ch),
                 b_src + static_cast<size_t>(r) * F_pad + ch);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load(s, s);
    cp_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_wait_pending();   // this step's stage has landed (this thread's part)
    __syncthreads();     // ... every thread's; the previous MMAs are done
    const int next = step + STAGES - 1;
    if (next < n_steps) load(next, next % STAGES);
    cp_commit();

    const uint8_t* a8 = smem + (step % STAGES) * STAGE_BYTES;
    const uint16_t* bs = reinterpret_cast<const uint16_t*>(a8 + A8_TILE);
    {   // dequantize the 16 bytes this thread copied
      const float scale = scales[cell_of[c_begin + step / k_steps]];
      const uint4 q = *reinterpret_cast<const uint4*>(a8 + a_r * A8_LD + a_c);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
      uint32_t h[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[2 * i] = dequant2(sbyte(w[i], 0), sbyte(w[i], 1), scale);
        h[2 * i + 1] = dequant2(sbyte(w[i], 2), sbyte(w[i], 3), scale);
      }
      uint4* dst = reinterpret_cast<uint4*>(a_tile + a_r * A_LD + a_c);
      dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
      dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
    }
    __syncthreads();     // the bf16 cell tile is whole

    uint32_t a[2][4][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + (lane & 15);
        ldmatrix_x4(smem_addr(a_tile + r * A_LD + ks * 16 + (lane >> 4) * 8),
                    a[ks][mt]);
      }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t b[2][2][2];   // [slice][feature tile][reg]
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int k = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int n = wn * 32 + p * 16 + (lane >> 4) * 8;
        uint32_t r4[4];
        ldmatrix_x4_trans(smem_addr(bs + k * B_LD + n), r4);
        b[ks][0][0] = r4[0];
        b[ks][0][1] = r4[1];
        b[ks][1][0] = r4[2];
        b[ks][1][1] = r4[3];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) mma_bf16(part, a[ks][mt], b[ks][j]);
          float* c = acc[mt][2 * p + j];
#pragma unroll
          for (int i = 0; i < 4; ++i) c[i] = __fadd_rn(c[i], part[i]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t grow = static_cast<int64_t>(rb) * R + row0 + wm * 64 +
                           mt * 16 + (lane >> 2) + h * 8;
      float* out_row = out + grow * F_pad;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int f = f0 + wn * 32 + nt * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(out_row + f) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
}

}  // namespace

extern "C" {

// out [n_rb * R, F_pad] f32 = the int8 dense-cell term: cells int8 [C, R,
// W], scales f32 [C], xs bf16 [n_st * W, F_pad], the row-block index
// rb_ptr int32 [n_rb + 1] / cell_of int32 (slots by row block, in order),
// st_ids int32 [C]; device pointers, `stream` a cudaStream_t. Returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for
// shapes the kernel does not take).
int blockdense_int8_cells(const void* cells, const void* scales,
                          const void* xs, void* out, const void* rb_ptr,
                          const void* cell_of, const void* st_ids, int n_rb,
                          int n_st, int F_pad, int R, int W, void* stream) {
  if (R % BM != 0 || W % BK != 0 || F_pad % BN != 0 || F_pad <= 0 ||
      n_rb <= 0 || n_st <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      blockdense_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_ft = F_pad / BN;
  const int64_t n_ctas = static_cast<int64_t>(n_rb) * (R / BM) * n_ft;
  if (n_ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  blockdense_int8_kernel<<<static_cast<unsigned>(n_ctas), THREADS, SMEM,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(cells), static_cast<const float*>(scales),
      static_cast<const uint16_t*>(xs), static_cast<float*>(out),
      static_cast<const int32_t*>(rb_ptr),
      static_cast<const int32_t*>(cell_of),
      static_cast<const int32_t*>(st_ids), F_pad, R, W, n_st, n_ft);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
