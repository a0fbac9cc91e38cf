// Dense-cell term of the block-dense SpMM: a block-sparse (BSR) product
// with bf16 R x W cells, out[rb] = sum over the row block's cells of
// cell @ x[stripe], on the bf16 tensor cores with f32 accumulation.
//
// Replaces sgc_tpu/ops/spmm_blockdense.py::_blockdense_super_kernel
// (super_rows=8, the main path), ::_blockdense_kernel (super_rows=None)
// and ::_blockdense_group_kernel (group_cells): all three compute the same
// function, with cells in (rb//S, st, rb), (rb, st) and grouped order. The
// host builds one per-row-block index (rb_ptr, cell_of) from any of them;
// within a row block the cells run in ascending stripe order, as in the
// reference layouts (zero hole cells of the grouped layout add zero).
//
// Operands. The cells are the bf16 A operand as stored. x enters as
// `terms` bf16 planes [terms][n_st * W][F_pad], zero-padded, that a first
// small kernel (x_terms_kernel, one pass over x) writes once per call
// into a scratch the wrapper allocates:
// precision "bf16" is one plane, bf16(x); precision "f32" is hi = bf16(x)
// and lo = bf16(x - hi), each a pass of products into the same f32
// accumulator. bf16 x bf16 products are exact in f32, so x's residual
// after two terms, <= 2^-16 |x|, is one loss. The other is the tensor
// cores' own f32 accumulation, which truncates: with every product summed
// in the MMA accumulator the main split came out 1.5e-5 of max off the
// plain f32 product even at three terms (sgc_tpu_torch/tools/kernel_ab.py,
// H100). So at "f32" each stage's products (32 deep, both terms) are
// summed on the tensor cores from zero and added to the accumulator by an
// f32 add on the CUDA cores, which rounds to nearest. At "bf16" the
// products accumulate in the MMA accumulator directly (5.6e-6 of max off
// the plain version on bf16(x), same run).
//
// Design. The TPU kernel kept an S*R x Ft f32 panel (10.5 MB) in VMEM; an
// SM has at most 227 KB of shared memory, so each CTA here owns a 128 x
// 128 output tile of one row block and walks that row block's cells in
// index order and each cell's W-deep k range in 32-deep steps. The walk
// is one flat sequence of (cell, k-step) stages fed through a 4-deep ring
// of shared-memory buffers by cp.async (each thread copies 16-byte rows
// of the cell tile and of every x plane's tile), so the loads of the next
// three stages are in flight while 8 warps run mma.sync.m16n8k16 bf16 ->
// f32 on the current one: each warp owns a 64 x 32 sub-tile, loads its A
// fragments with ldmatrix once per stage and reuses them for every x
// plane (ldmatrix.trans for B). Rows are padded in shared memory (80 and
// 272 bytes) so ldmatrix reads are free of bank conflicts. At most 128
// registers a thread and 111 KB of ring at two terms let two CTAs share
// an SM. The feature tiles of one row tile are adjacent in the grid, so
// the CTAs that read the same cells run together and share them through
// L2.
//
// Why mma.sync and not wgmma: wgmma needs shared-memory descriptors and
// swizzled layouts that can only be checked on the card, and this
// kernel's k loop is a gather of cells and stripes, not one dense matrix
// that a TMA tensor map describes; mma.sync with cp.async is the simpler
// kernel that is right first, and leaves wgmma + TMA to a later PR.
//
// `out` is written once; a row block with no cells writes zeros (the
// reference masks those rows instead). Ragged edges are masked here:
// rows >= n_rows and features >= F are not written; x's padding rows and
// features are zero in the scratch.
//
// Bound on the H100: the dense form does 2*R*W*F flops per cell and term
// on the tensor cores, but the function needs only 2*F flops per nonzero
// of a cell, and the main path's cells are under 1% full; so the bound
// is the bytes, each cell read once (2*R*W bytes) with x and out. The
// kernel's time goes to the dense form's work.
//
// Deterministic: fixed cell order, fixed k order, fixed term order, no
// atomics, so two launches give identical bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;      // output rows per CTA (a slice of a row block)
constexpr int BN = 128;      // output features per CTA
constexpr int BK = 32;       // k depth per stage
constexpr int THREADS = 256; // 8 warps: 2 along rows x 4 along features
constexpr int STAGES = 4;    // depth of the cp.async ring
constexpr int A_LD = BK + 8; // bf16 per cell-tile row in shared memory
constexpr int B_LD = BN + 8; // bf16 per x-tile row in shared memory
constexpr int A_TILE = BM * A_LD;
constexpr int B_TILE = BK * B_LD;
static_assert(BK == 32, "the MMA loop takes a stage as two 16-deep slices");

template <int T>
__host__ __device__ constexpr int stage_elems() {
  return A_TILE + T * B_TILE;
}

template <int T>
constexpr size_t smem_bytes() {
  return sizeof(uint16_t) * static_cast<size_t>(STAGES) * stage_elems<T>();
}

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

// The operand stage: x [n_cols, F] f32 -> T bf16 planes [n_x_rows, F_pad]
// (zero past n_cols and F), hi = bf16(x), lo = bf16(x - hi), ... with
// round to nearest even; the f32 subtraction is exact. Two elements per
// thread and step; F_pad is even. The plain twin is
// ops/spmm_blockdense.py::bf16_terms.
template <int T>
__global__ void x_terms_kernel(const float* __restrict__ x,
                               __nv_bfloat162* __restrict__ xs, int n_cols,
                               int F, int F_pad, int64_t plane) {
  const int64_t pairs = plane / 2;
  const int half = F_pad / 2;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < pairs; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / half;
    const int f = static_cast<int>(i - r * half) * 2;
    float v0 = 0.f, v1 = 0.f;
    if (r < n_cols) {
      const float* xr = x + r * F;
      if (f < F) v0 = xr[f];
      if (f + 1 < F) v1 = xr[f + 1];
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
      xs[t * pairs + i] = h;
      v0 -= __low2float(h);
      v1 -= __high2float(h);
    }
  }
}

// at most 128 registers, so two CTAs (16 warps) share an SM
template <int T>
__global__ void __launch_bounds__(THREADS, 2)
blockdense_cells_kernel(const uint16_t* __restrict__ cells,  // bf16 [C, R, W]
                        const uint16_t* __restrict__ xs,     // bf16 [T, n_st*W, F_pad]
                        float* __restrict__ out,             // [n_rows, F]
                        const int32_t* __restrict__ rb_ptr,  // [n_rb + 1]
                        const int32_t* __restrict__ cell_of, // slots by rb
                        const int32_t* __restrict__ st_ids,  // per slot
                        int n_rows, int F, int F_pad, int R, int W,
                        int64_t plane, int n_ft) {
  extern __shared__ __align__(16) uint16_t smem[];

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

  // stage `step` (cell c_begin + step / k_steps, k0) into ring slot `buf`
  auto load = [&](int step, int buf) {
    const int slot = cell_of[c_begin + step / k_steps];
    const int k0 = (step % k_steps) * BK;
    uint16_t* as = smem + buf * stage_elems<T>();
    uint16_t* bs = as + A_TILE;
    const uint16_t* a_src = cells + static_cast<size_t>(slot) * R * W +
                            static_cast<size_t>(row0) * W + k0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // 128 rows x 4 chunks of 8 bf16
      const int idx = tid + i * THREADS;
      const int r = idx >> 2, ch = (idx & 3) * 8;
      cp_async16(smem_addr(as + r * A_LD + ch),
                 a_src + static_cast<size_t>(r) * W + ch);
    }
    const uint16_t* b_src =
        xs + static_cast<size_t>(st_ids[slot] * W + k0) * F_pad + f0;
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {   // 32 rows x 16 chunks of 8 bf16
        const int idx = tid + i * THREADS;
        const int r = idx >> 4, ch = (idx & 15) * 8;
        cp_async16(smem_addr(bs + t * B_TILE + r * B_LD + ch),
                   b_src + t * plane + static_cast<size_t>(r) * F_pad + ch);
      }
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
    __syncthreads();     // ... every thread's, and the previous stage is free
    const int next = step + STAGES - 1;
    if (next < n_steps) load(next, next % STAGES);
    cp_commit();

    const uint16_t* as = smem + (step % STAGES) * stage_elems<T>();
    const uint16_t* bs = as + A_TILE;
    // A fragments of both 16-deep slices of the stage, then the B
    // fragments of two 8-wide feature tiles at a time
    uint32_t a[2][4][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + (lane & 15);
        ldmatrix_x4(smem_addr(as + r * A_LD + ks * 16 + (lane >> 4) * 8),
                    a[ks][mt]);
      }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t b[2][T][2][2];   // [slice][term][feature tile][reg]
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const int k = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int n = wn * 32 + p * 16 + (lane >> 4) * 8;
          uint32_t r4[4];
          ldmatrix_x4_trans(smem_addr(bs + t * B_TILE + k * B_LD + n), r4);
          b[ks][t][0][0] = r4[0];
          b[ks][t][0][1] = r4[1];
          b[ks][t][1][0] = r4[2];
          b[ks][t][1][1] = r4[3];
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          float* c = acc[mt][2 * p + j];
          if (T == 1) {
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) mma_bf16(c, a[ks][mt], b[ks][0][j]);
          } else {
            // the stage's products of every term, smallest term first,
            // summed on the tensor cores from zero, then added to the
            // accumulator by an f32 add that rounds to nearest
            float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int ks = 0; ks < 2; ++ks)
#pragma unroll
              for (int t = T - 1; t >= 0; --t)
                mma_bf16(part, a[ks][mt], b[ks][t][j]);
#pragma unroll
            for (int i = 0; i < 4; ++i) c[i] += part[i];
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

  // accumulator (mt, nt): rows lane/4 and lane/4 + 8 of the 16 x 8 tile,
  // features 2 * (lane % 4) and the next
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t grow = static_cast<int64_t>(rb) * R + row0 + wm * 64 +
                           mt * 16 + (lane >> 2) + h * 8;
      if (grow >= n_rows) continue;
      float* out_row = out + grow * F;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int f = f0 + wn * 32 + nt * 8 + (lane & 3) * 2;
        if (f < F) out_row[f] = acc[mt][nt][2 * h];
        if (f + 1 < F) out_row[f + 1] = acc[mt][nt][2 * h + 1];
      }
    }
  }
}

template <int T>
int launch(const void* cells, const void* x, void* xs, void* out,
           const void* rb_ptr, const void* cell_of, const void* st_ids,
           int n_rb, int n_rows, int n_cols, int n_x_rows, int F, int F_pad,
           int R, int W, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      blockdense_cells_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_ft = F_pad / BN;
  const int64_t n_ctas = static_cast<int64_t>(n_rb) * (R / BM) * n_ft;
  if (n_ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t plane = static_cast<int64_t>(n_x_rows) * F_pad;
  const int64_t conv_blocks = (plane / 2 + 255) / 256;
  x_terms_kernel<T><<<static_cast<unsigned>(
                          conv_blocks < 132 * 32 ? conv_blocks : 132 * 32),
                      256, 0, stream>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat162*>(xs), n_cols,
      F, F_pad, plane);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  blockdense_cells_kernel<T><<<static_cast<unsigned>(n_ctas), THREADS, smem,
                               stream>>>(
      static_cast<const uint16_t*>(cells), static_cast<const uint16_t*>(xs),
      static_cast<float*>(out), static_cast<const int32_t*>(rb_ptr),
      static_cast<const int32_t*>(cell_of),
      static_cast<const int32_t*>(st_ids), n_rows, F, F_pad, R, W, plane,
      n_ft);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[n_rows, F] = dense-cell term of x [n_cols, F] (f32). Writes `terms`
// (1: "bf16", 2: "f32") bf16 planes of x into the scratch `xs` ([terms,
// n_x_rows, F_pad], n_x_rows = n_st * W), then runs the MMA kernel on
// them: two launches. Pointers are
// device pointers; `stream` is a cudaStream_t. Returns cudaGetLastError()
// after the launches (or cudaErrorInvalidValue for shapes the kernels do
// not take).
int blockdense_cells(const void* cells, const void* x, void* xs, void* out,
                     const void* rb_ptr, const void* cell_of,
                     const void* st_ids, int n_rb, int n_rows, int n_cols,
                     int n_x_rows, int F, int F_pad, int R, int W, int terms,
                     void* stream) {
  if (R % BM != 0 || W % BK != 0 || n_x_rows % W != 0 || n_x_rows < n_cols ||
      F_pad % BN != 0 || F <= 0 || F > F_pad || n_rb <= 0 ||
      static_cast<int64_t>(n_rb) * R < n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (terms) {
    case 1:
      return launch<1>(cells, x, xs, out, rb_ptr, cell_of, st_ids, n_rb,
                       n_rows, n_cols, n_x_rows, F, F_pad, R, W, s);
    case 2:
      return launch<2>(cells, x, xs, out, rb_ptr, cell_of, st_ids, n_rb,
                       n_rows, n_cols, n_x_rows, F, F_pad, R, W, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
