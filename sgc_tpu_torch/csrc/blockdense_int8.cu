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
// Design (Hopper: TMA, mbarriers, wgmma with A from registers).
// - Work: a CTA tile is 128 rows x 256 features of one row block (a
//   128-wide last tile where F_pad is not a multiple of 256, its other
//   half left unstored). Persistent CTAs, one an SM, walk the tiles in
//   (row block, feature tile, row tile) order, so the CTAs running at
//   once hold neighbouring row blocks and share their x stripes in L2;
//   a tile walks its row block's cells in index order, 64 deep a stage.
//   At 768 wide each cell byte is read and dequantized 3 times (once a
//   feature tile).
// - Loads: TMA (cp.async.bulk.tensor) fills a STAGES-deep ring: the
//   stage's int8 cell tile (128 x 64 bytes, 64-byte swizzle) and its bf16
//   x tile (64 x 256, four boxes of 64 features with 128-byte swizzle,
//   the layout wgmma reads), completing on the stage's full mbarrier;
//   the warps free a stage on its empty mbarrier. Thread 0 issues the
//   loads: whenever its warp frees a stage it requests the stages up to
//   STAGES - 1 past it, each once its slot is free. There is no producer
//   warp: a ninth warp puts three warps in one quarter of the
//   multiprocessor, whose 16K registers then cap every thread at 168,
//   and the consumers need more; with a producer warpgroup that gave its
//   registers away with setmaxnreg, ptxas still built the consumers at
//   168 registers and they spilled (PERF.md §6). The tensor maps are
//   encoded per call through cudaGetDriverEntryPoint, so the library
//   needs no -lcuda.
// - Dequantization in registers: each thread reads the int8 bytes of its
//   wgmma A fragment from the stage's cell tile, makes f32(q) exactly (a
//   byte permute into 2^23 + q + 128 and a subtract), multiplies by the
//   cell's scale (__fmul_rn) and rounds to bf16 with cvt.rn.bf16x2.f32,
//   as the reference does, into one of two fragment sets while the other
//   stage's wgmmas run (wgmma.wait_group 1). No bf16 cell tile is
//   written to shared memory and no __syncthreads is on the stage path.
// - Products: two warpgroups, 64 rows each, issue wgmma.mma_async
//   m64n256k16 (A from registers, B the x tile by shared-memory
//   descriptor, N-major) into 128 f32 accumulators a thread: one cell's
//   512-deep product, started from zero (scale-d 0) at its first k step.
// - The f32 sum over the row block's cells mirrors the plain version,
//   which adds one f32 cell product at a time: after each cell the
//   accumulators are added with __fadd_rn into a running sum (0 + the
//   first cell, then in cell order), half of it in registers and half in
//   shared memory (64 KB, each thread's values its own, float4 at a
//   time); the last cell's add goes straight to `out`. Summed on the
//   tensor cores over a whole row block instead, the error against the
//   plain version was 4.4e-5 of max|plain| on random dense cells in the
//   main split's index, against 6.8e-7 with the running sum (PERF.md
//   §6).
//
// Bound on the H100: bytes. The function reads each int8 cell once (1
// byte an entry, half of kernel A's), the scales, the bf16 x table, the
// index, and writes out once; its operations, 2 F per nonzero entry of
// the int8 cells, are far below the bf16 tensor-core peak at the main
// split's 0.75% fill. The kernel does the dense form's work, 2 R W F an
// cell, as kernel A does: at 768 wide that is the 2.08 ms floor of the
// dense form (ops/roofline.py::kernel_h_bound).
//
// `out` [n_rb * R, F_pad] is written once; a row block with no cell gets
// zeros. Deterministic: fixed cell, k and add order, no atomics. A stripe
// id out of range stops the kernel with a trap, as does a barrier wait
// that never completes (a watchdog of ~4e9 cycles).

#include <cuda.h>   // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;            // rows a CTA tile (two warpgroups of 64)
constexpr int BN = 256;            // features a CTA tile
constexpr int BK = 64;             // k depth a stage (four k steps)
constexpr int BOX_N = 64;          // features a TMA box of x (128 bytes)
constexpr int STAGES = 4;
constexpr int THREADS = 256;       // two warpgroups; thread 0 also loads
constexpr int WARPS = THREADS / 32;
constexpr int B_BOX_BYTES = BK * BOX_N * 2;          // 8 KB
constexpr int B_BYTES = BK * BN * 2;                 // 32 KB, 1024-aligned
constexpr int A_BYTES = BM * BK;                     // 8 KB int8
constexpr int STAGE_BYTES = B_BYTES + A_BYTES;       // 40 KB
constexpr int RUN_REGS = 64;       // running-sum values a thread in registers
constexpr int RUN_SMEM = 128 - RUN_REGS;             // and in shared memory
constexpr int RUN_BYTES = THREADS * RUN_SMEM * 4;    // 64 KB
constexpr int SMEM =
    1024 + STAGES * STAGE_BYTES + RUN_BYTES + STAGES * (8 + 8 + 4);
constexpr long long WATCHDOG = 4000000000LL;         // cycles
static_assert(STAGE_BYTES % 1024 == 0, "stages stay 1024-byte aligned");
static_assert(RUN_REGS % 4 == 0 && RUN_SMEM % 4 == 0, "float4 groups");
static_assert(SMEM <= 232448, "one CTA's shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > WATCHDOG) {
      asm volatile("trap;");
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the wgmma descriptor of an x tile slice: N-major (features contiguous),
// 128-byte swizzle; LBO the stride between 64-feature boxes, SBO between
// groups of 8 k rows
__device__ __forceinline__ uint64_t x_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(B_BOX_BYTES >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d (64 x 256 f32, the wgmma accumulator layout) = a (64 x 16 bf16, A
// fragment in registers) @ the x slice at desc_b (16 x 256 bf16), plus d
// where `add` is nonzero
__device__ __forceinline__ void wgmma_256(float* d, const uint32_t* a,
                                          uint64_t desc_b, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(add));
}

// q0 = byte sel & 3 of w, q1 the next byte (signed int8 each) ->
// bf16x2(bf16(f32(q0) * scale) low, bf16(f32(q1) * scale) high), round to
// nearest even. f32(q) is exact: the biased byte q + 128 placed in the
// mantissa of 2^23, minus 2^23 + 128.
__device__ __forceinline__ uint32_t dequant_pair(uint32_t w, uint32_t sel,
                                                 float scale) {
  const uint32_t u = w ^ 0x80808080u;
  const float q0 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, sel)),
                             8388736.f);
  const float q1 = __fsub_rn(
      __uint_as_float(__byte_perm(u, 0x4B000000u, sel + 1)), 8388736.f);
  const __nv_bfloat162 h =
      __floats2bfloat162_rn(__fmul_rn(q0, scale), __fmul_rn(q1, scale));
  return *reinterpret_cast<const uint32_t*>(&h);
}

__global__ void __launch_bounds__(THREADS, 1)
blockdense_int8_kernel(const __grid_constant__ CUtensorMap cell_map,
                       const __grid_constant__ CUtensorMap x_map,
                       const float* __restrict__ scales,   // [C]
                       float* __restrict__ out,            // [n_rb * R, F_pad]
                       const int32_t* __restrict__ rb_ptr, // [n_rb + 1]
                       const int32_t* __restrict__ cell_of,
                       const int32_t* __restrict__ st_ids, // per slot
                       int n_rb, int n_st, int F_pad, int R, int W) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  float4* const run = reinterpret_cast<float4*>(gbase + STAGES * STAGE_BYTES);
  const uint32_t full = base + STAGES * STAGE_BYTES + RUN_BYTES;   // x 8 B
  const uint32_t empty = full + STAGES * 8;
  float* const stage_scale = reinterpret_cast<float*>(
      gbase + STAGES * STAGE_BYTES + RUN_BYTES + STAGES * 16);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_ft = (F_pad + BN - 1) / BN;
  const int rt_per_rb = R / BM;
  const int items = n_rb * rt_per_rb * n_ft;
  const int k_stages = W / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ---------------------------------------------------------- loads
  // thread 0's cursor over the stages this CTA multiplies, in order:
  // (item, cell, k stage); p_it counts the stages requested
  int p_it = 0, p_item = blockIdx.x, p_ci = 0, p_end = 0, p_ks = 0;
  if (threadIdx.x == 0 && p_item < items) {
    const int rb = p_item / (rt_per_rb * n_ft);
    p_ci = rb_ptr[rb];
    p_end = rb_ptr[rb + 1];
  }
  // request stages before `upto` (or the CTA's last), each once its
  // slot is free
  auto request = [&](int upto) {
    while (p_it < upto && p_item < items) {
      if (p_ci == p_end) {   // the item is done (or has no cell): next
        p_item += gridDim.x;
        if (p_item < items) {
          const int rb = p_item / (rt_per_rb * n_ft);
          p_ci = rb_ptr[rb];
          p_end = rb_ptr[rb + 1];
        }
        continue;
      }
      const int s = p_it % STAGES;
      mbar_wait(empty + 8 * s, ((p_it / STAGES) & 1) ^ 1);
      const int rt = p_item % rt_per_rb;
      const int ft = (p_item / rt_per_rb) % n_ft;
      const int slot = cell_of[p_ci];
      const int st = st_ids[slot];
      if (st < 0 || st >= n_st) asm volatile("trap;");
      stage_scale[s] = scales[slot];
      const int boxes = min(BN, F_pad - ft * BN) / BOX_N;
      mbar_expect_tx(full + 8 * s, A_BYTES + boxes * B_BOX_BYTES);
      const uint32_t b_tile = base + s * STAGE_BYTES;
      tma_load(b_tile + B_BYTES, &cell_map, p_ks * BK, slot * R + rt * BM,
               full + 8 * s);
      for (int b = 0; b < boxes; ++b) {
        tma_load(b_tile + b * B_BOX_BYTES, &x_map, ft * BN + b * BOX_N,
                 st * W + p_ks * BK, full + 8 * s);
      }
      ++p_it;
      if (++p_ks == k_stages) {
        p_ks = 0;
        ++p_ci;
      }
    }
  };
  if (threadIdx.x == 0) request(STAGES);
  __syncwarp();

  // ---------------------------------------------------------- products
  const int wg = warp >> 2;          // rows 64 wg of the tile
  const int g = lane >> 2, t = lane & 3;
  const int row0 = wg * 64 + (warp & 3) * 16 + g;   // and row0 + 8
  // the cell tile's 64-byte swizzle: row r's 16-byte chunk j lies at
  // r * 64 + 16 * (j ^ ((r >> 1) & 3)); rows row0 and row0 + 8 share it
  const int swz = (row0 >> 1) & 3;
  // A fragment of k step j: bytes 2t, 2t+1 (and 2t+8, 2t+9) of chunk j,
  // in word t >> 1 (and 2 + t >> 1), at byte 2 (t & 1) of the word
  const uint32_t word_off = 4 * (t >> 1);
  const uint32_t sel = 0x7440u + 2 * (t & 1);
  float acc[128];
  float run_r[RUN_REGS];
  float4* const my_run = run + threadIdx.x;   // [RUN_SMEM / 4][THREADS]
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int rt = item % rt_per_rb;
    const int ft = (item / rt_per_rb) % n_ft;
    const int rb = item / (rt_per_rb * n_ft);
    const int n_cells = rb_ptr[rb + 1] - rb_ptr[rb];
    if (n_cells == 0) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    }
    for (int ci = 0; ci < n_cells; ++ci) {
      // stage `it`'s A fragments (dequantized) and its four wgmmas,
      // committed as one group; `first` starts the cell's product
      auto stage = [&](uint32_t (&a)[4][4], bool first) {
        const int s = it % STAGES;
        mbar_wait(full + 8 * s, (it / STAGES) & 1);
        const float scale = stage_scale[s];
        const uint8_t* a_tile = gbase + s * STAGE_BYTES + B_BYTES;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint8_t* c0 = a_tile + row0 * BK + 16 * (j ^ swz) + word_off;
          const uint8_t* c1 = c0 + 8 * BK;
          a[j][0] = dequant_pair(*reinterpret_cast<const uint32_t*>(c0), sel,
                                 scale);
          a[j][1] = dequant_pair(*reinterpret_cast<const uint32_t*>(c1), sel,
                                 scale);
          a[j][2] = dequant_pair(*reinterpret_cast<const uint32_t*>(c0 + 8),
                                 sel, scale);
          a[j][3] = dequant_pair(*reinterpret_cast<const uint32_t*>(c1 + 8),
                                 sel, scale);
        }
        const uint32_t b_tile = base + s * STAGE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wgmma_256(acc, a[j], x_desc(b_tile + j * 2048),
                    first && j == 0 ? 0 : 1);
        }
        wgmma_commit();
        ++it;
      };
      // stage `done` is finished once at most one group is in flight: its
      // fragments may be rewritten and its buffers go back; thread 0
      // then requests the stages up to STAGES - 1 past it
      auto release = [&](uint32_t (&a)[4][4], int done) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) keep(a[j][i]);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * (done % STAGES));
        if (threadIdx.x == 0) request(done + STAGES);
        __syncwarp();   // warp 0 whole again before aligned wgmma ops
      };
      uint32_t a0[4][4], a1[4][4];
      for (int ks = 0; ks < k_stages; ks += 2) {   // k_stages is even
        stage(a0, ks == 0);
        if (ks > 0) {
          wgmma_wait<1>();
          release(a1, it - 2);
        }
        stage(a1, false);
        wgmma_wait<1>();
        release(a0, it - 2);
      }
      wgmma_wait<0>();
      release(a1, it - 1);
#pragma unroll
      for (int i = 0; i < 128; ++i) keep(acc[i]);
      // the cell's product into the running sum, in cell order; the
      // last cell's sum stays in acc for `out`
      const bool last = ci == n_cells - 1;
#pragma unroll
      for (int i = 0; i < RUN_REGS; ++i) {
        const float r = __fadd_rn(ci == 0 ? 0.f : run_r[i], acc[i]);
        if (last) {
          acc[i] = r;
        } else {
          run_r[i] = r;
        }
      }
#pragma unroll
      for (int q = 0; q < RUN_SMEM / 4; ++q) {
        float4 r = ci == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                           : my_run[q * THREADS];
        float* const a4 = acc + RUN_REGS + 4 * q;
        r.x = __fadd_rn(r.x, a4[0]);
        r.y = __fadd_rn(r.y, a4[1]);
        r.z = __fadd_rn(r.z, a4[2]);
        r.w = __fadd_rn(r.w, a4[3]);
        if (last) {
          a4[0] = r.x;
          a4[1] = r.y;
          a4[2] = r.z;
          a4[3] = r.w;
        } else {
          my_run[q * THREADS] = r;
        }
      }
    }
    // accumulator layout: acc[4j + h] is row g (+8 for h >= 2), feature
    // 8j + 2t + (h & 1) of the warp's 16 x 256 slab
    const int64_t grow = static_cast<int64_t>(rb) * R + rt * BM + row0;
    float* o0 = out + grow * F_pad + ft * BN + 2 * t;
    float* o1 = o0 + 8 * static_cast<int64_t>(F_pad);
    const int f_left = F_pad - ft * BN;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (8 * j < f_left) {
        *reinterpret_cast<float2*>(o0 + 8 * j) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(o1 + 8 * j) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once (no link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// a 2-D row-major map: `cols` x `rows` elements of `elem` bytes, boxes of
// box_cols x box_rows
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem,
               const void* ptr, uint64_t cols, uint64_t rows,
               uint32_t box_cols, uint32_t box_rows,
               CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// set once a process: the kernel's shared memory above 48 KB, and the
// device's SM count
int prepare(int* n_sms) {
  static int sms = 0;
  if (sms == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        blockdense_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *n_sms = sms;
  return 0;
}

}  // namespace

extern "C" {

// out [n_rb * R, F_pad] f32 = the int8 dense-cell term: cells int8
// [n_slots, R, W], scales f32 [n_slots], xs bf16 [n_st * W, F_pad], the
// row-block index rb_ptr int32 [n_rb + 1] / cell_of int32 (slots by row
// block, in order), st_ids int32 [n_slots]; device pointers, `stream` a
// cudaStream_t. Takes R a multiple of 128, W of 128, F_pad of 128 and
// 16-byte aligned cells and xs. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for shapes it does not take).
int blockdense_int8_cells(const void* cells, const void* scales,
                          const void* xs, void* out, const void* rb_ptr,
                          const void* cell_of, const void* st_ids,
                          int n_slots, int n_rb, int n_st, int F_pad, int R,
                          int W, void* stream) {
  if (R <= 0 || R % BM != 0 || W <= 0 || W % (2 * BK) != 0 || F_pad <= 0 ||
      F_pad % 128 != 0 || n_rb <= 0 || n_st <= 0 || n_slots < 0 ||
      reinterpret_cast<uintptr_t>(cells) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xs) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t items =
      static_cast<int64_t>(n_rb) * (R / BM) * ((F_pad + BN - 1) / BN);
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (n_slots == 0) {   // no cell: every row block is zero
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(n_rb) * R * F_pad * sizeof(float), s));
  }
  int n_sms = 0;
  const int rc = prepare(&n_sms);
  if (rc != 0) return rc;
  CUtensorMap cell_map, x_map;
  if (!encode_2d(&cell_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, cells, W,
                 static_cast<uint64_t>(n_slots) * R, BK, BM,
                 CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode_2d(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, xs, F_pad,
                 static_cast<uint64_t>(n_st) * W, BOX_N, BK,
                 CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = static_cast<int>(items < n_sms ? items : n_sms);
  blockdense_int8_kernel<<<grid, THREADS, SMEM, s>>>(
      cell_map, x_map, static_cast<const float*>(scales),
      static_cast<float*>(out), static_cast<const int32_t*>(rb_ptr),
      static_cast<const int32_t*>(cell_of),
      static_cast<const int32_t*>(st_ids), n_rb, n_st, F_pad, R, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
