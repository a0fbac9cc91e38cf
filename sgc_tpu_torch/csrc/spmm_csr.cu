// Deterministic CSR SpMM, out[r] = dense[r] + sum over row r's edges e, in
// row_ptr order, of vals[e] * x[cols[e]] (`dense` optional).
//
// Two roles, one kernel:
// * kernel B of the port, the sparse remainder of the block-dense and
//   hybrid SpMMs, every hop of the CLIs' plain path, every SpMM of GCN,
//   GAT and deep GCN (forward, and backward over the cached transpose)
//   and every segment sum of GAT (F = 1). Replaces
//   sgc_tpu/ops/spmm.py::spmm_segment (an XLA gather + sorted segment-sum
//   in the reference, not a Pallas kernel). It is written by hand because
//   determinism is part of that op's contract, and PyTorch's CUDA
//   index_add_ / scatter_add_ sum with atomics, in an order that changes
//   from run to run.
// * kernel C of the port, the tiled SpMM over the cell-chunk layout.
//   Replaces sgc_tpu/ops/spmm_pallas.py::_spmm_flat_kernel (flat chunk
//   schedule) and ::_spmm_kernel (stripe walk), which sum every row's
//   edge slots in layout order. The host re-sorts the layout's edges once
//   per plan into (row, layout position) order, padding left out
//   (ops/spmm_tiled.py::row_csr), so the same sums in the same order are
//   this CSR product.
//
// What bounds it on the H100. Each edge gathers one x row, F values, for
// 2 F flops, so it is bound by bytes: the byte bound counts each x row
// once, the kernel reads it once per edge, from L2 where rows are reused
// (kernel C's dense cells, the LPA order) and from HBM where they are not
// (the remainder, shuffled ids). A row's sum is a chain, so a row of
// degree d costs about d / U gather round trips; the hub rows of a
// skewed graph (degree 1,300 at Reddit shape, 27x the mean) set the
// kernel's tail at narrow widths. What kept the first kernel (a warp per
// row, one gather in flight, 320 features a pass) from the bound was
// latency: one round trip per edge, idle lanes at narrow widths (4 of 32
// at F = 8, 1 at F = 1), and two passes over every edge list at F = 602.
//
// Design.
// * Lanes per row from F alone (ops/spmm.py::csr_plan, checked here
//   against what this file compiles): `lanes` is the least power of two
//   covering F / VEC vectors, at most 32, so a warp holds 32 / lanes
//   rows; VEC (1, 2 or 4) is the widest load that F and the operands'
//   alignment allow; a lane holds NV vectors (at most PASS_VALUES
//   values), so one pass covers 640 features at lanes = 32.
// * U gathers in flight per lane: a lane loads a batch's columns and
//   values, issues its U gathers, then adds them in edge order; U =
//   IN_FLIGHT_BYTES / the x bytes a lane gathers per edge, in [U_MIN,
//   U_MAX]: 16 at F = 1, 10 at F = 8, 2 at F = 602 (4 for bf16 x).
// * The edge stream staged in shared memory: each warp's span of edges
//   (its rows are consecutive, so the span is contiguous) is copied in
//   chunks of STAGE_EDGES by cp.async, coalesced, into two buffers, the
//   next chunk landing while this one is walked. Hub rows make a span
//   unbounded; chunks bound it. Rows with one warp each take smaller
//   chunks (STAGE_EDGES_WIDE).
// * F = 1 (GAT's segment sums): the warp also gathers each chunk's x
//   values into shared memory by cp.async, all lanes at once, so a row's
//   chain reads shared memory only and a hub's 1,300 edges cost a few
//   chunk round trips instead of 1,300 / U.
// * The CTAs' order: `cta_order` (optional) lists which rows each CTA
//   in launch order takes. From a graph's second launch on, the host
//   puts first the CTAs that hold a hub row (ops/spmm.py::heavy_first,
//   cta_order): the GPU starts CTAs in index order,
//   so a hub's chain begun in the last wave set the launch's end, by as
//   much as a hub row's walk, wherever the graph's ids placed it.
// * The rows' order: `row_map` (optional) lets the kernel walk a copy of
//   the CSR whose rows are permuted (row_ptr, cols, vals reordered by
//   row, column ids and x untouched): walked row r is the product's row
//   row_map[r], read from dense and written to out there. The host gives
//   it the walk a prepared operator carries (ops/spmm.py::row_walk)
//   where x outgrows the L2: LPA's community order, decided and built
//   once when the operator's caller prepares it
//   (ops/autograd.py::prepare_operator, graph/reorder.py::walk_order;
//   a deep stack such as GCNII's) on a square graph whose ids scatter
//   its communities (the shuffled Reddit shape at F = 64: x 60 MB
//   against 50 MB), so that the CTAs in flight gather from a few
//   communities' rows instead of the whole table (F = 64, GCNII's
//   operator, H100 80GB HBM3: 0.584 -> 0.402 ms, relabelling x as well
//   0.388). Tables within the L2, graphs already in a local order and
//   graphs nobody prepared keep index order.
// * Registers are bounded per instance (min_ctas): for 3 CTAs an SM
//   where a lane gathers at most NARROW_BYTES an edge, 2 where it
//   issues MANY_LOADS loads an edge, else unbounded.
// Measured on an H100 80GB HBM3 at 700 W with tools/kernel_ab.py: each
// staging choice, chunk size, batch bound and CTA bound above won there;
// reading the edges through L1 instead was up to 2x slower at F <= 64.
// A lesson of that work: when a batch's gathers sat behind conditional
// loads or predicated adds, ptxas gathered every edge into one register
// and added it before the next gather, one round trip per edge. So no
// load here is conditional and whole batches add with no predicate
// (walk()).
//
// Deterministic, and the same bits as the first kernel: for every
// feature, a row's result is one fmaf chain over its edges in row_ptr
// order from 0, then dense + acc. That order depends on the row's edges,
// F and the precision alone: not on n_rows, nnz, the row's position, the
// other rows, the CTAs' or the rows' order (a walked row keeps its edges
// in their order) or the plan (which lane holds a feature, how edges are
// batched or staged change nothing in the chain). No atomics; no row is
// split. Precision: FP32 products and sums on the CUDA cores. Kernel C
// also has the reference's precision="bf16" (x_bf16 = 1): x is a bf16
// copy, and each slot adds bf16(val * x[col]) to the f32 sum, the
// product rounded to bf16 (nearest even) as the reference's one-hot
// scatter matmul takes it (spmm_pallas.py:415-421). Kernel B always
// runs FP32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;               // warps per CTA
constexpr int PASS_VALUES = 20;        // x values a lane holds per pass
constexpr int IN_FLIGHT_BYTES = 160;   // x bytes a lane gathers per batch
constexpr int U_MIN = 2;               // edges per batch, at least
constexpr int U_MAX = 16;              // and at most
constexpr int STAGE_EDGES = 256;       // staged edges per warp (0: off)
constexpr int STAGE_EDGES_WIDE = 128;  // the same where a lane holds a
                                       // whole pass (PASS_VALUES values)
constexpr int NARROW_BYTES = 40;       // a lane gathering at most this
constexpr int NARROW_MIN_CTAS = 3;     // many x bytes an edge: registers
                                       // for 3 CTAs an SM
constexpr int MANY_LOADS = 20;         // at this many loads an edge: 2
constexpr int WIDE_MIN_CTAS = 1;       // otherwise

// edges per batch when a lane gathers `bytes` of x per edge
__host__ __device__ constexpr int unroll_for(int bytes) {
  return IN_FLIGHT_BYTES / bytes < U_MIN   ? U_MIN
         : IN_FLIGHT_BYTES / bytes > U_MAX ? U_MAX
                                           : IN_FLIGHT_BYTES / bytes;
}

// CTAs per SM the registers must allow, for `bytes` of x a lane gathers
// per edge in `loads` loads. Chosen per instance by measurement
// (tools/kernel_ab.py): ptxas otherwise gave bf16 x at F = 602 149
// registers (3.99 ms against 3.09 for kernel C) and f32 x with 20 loads
// an edge (x 4 bytes off at F = 602) 164 (2.29 against 1.89 ms), while
// f32 x at F = 602, aligned, is fastest unbounded (H100 80GB HBM3, 700 W).
__host__ __device__ constexpr int min_ctas(int bytes, int loads) {
  return bytes <= NARROW_BYTES ? NARROW_MIN_CTAS
         : loads >= MANY_LOADS ? 2
                               : WIDE_MIN_CTAS;
}

struct __align__(8) bf16x4 {
  __nv_bfloat162 lo, hi;
};

// x's element and vector types: f32, or bf16 in mode BX
template <int VEC, bool BX> struct Vec;
template <> struct Vec<1, false> { using E = float; using T = float; };
template <> struct Vec<2, false> { using E = float; using T = float2; };
template <> struct Vec<4, false> { using E = float; using T = float4; };
template <> struct Vec<1, true> {
  using E = __nv_bfloat16;
  using T = __nv_bfloat16;
};
template <> struct Vec<2, true> {
  using E = __nv_bfloat16;
  using T = __nv_bfloat162;
};
template <> struct Vec<4, true> { using E = __nv_bfloat16; using T = bf16x4; };

template <class T> __device__ __forceinline__ T load(const T* p) {
  return __ldg(p);
}
template <> __device__ __forceinline__ bf16x4 load(const bf16x4* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  bf16x4 v;
  v.lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  v.hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return v;
}

// acc (+)= v * x where `take`, in the kernel's order: one fmaf a value
__device__ __forceinline__ void fma_into(float* acc, float v, float x,
                                         bool take) {
  const float a = fmaf(v, x, acc[0]);
  acc[0] = take ? a : acc[0];
}
__device__ __forceinline__ void fma_into(float* acc, float v, float2 x,
                                         bool take) {
  fma_into(acc, v, x.x, take);
  fma_into(acc + 1, v, x.y, take);
}
__device__ __forceinline__ void fma_into(float* acc, float v, float4 x,
                                         bool take) {
  fma_into(acc, v, x.x, take);
  fma_into(acc + 1, v, x.y, take);
  fma_into(acc + 2, v, x.z, take);
  fma_into(acc + 3, v, x.w, take);
}
// bf16(v * x) in f32: the slot's product rounded to bf16, then added
__device__ __forceinline__ void fma_into(float* acc, float v,
                                         __nv_bfloat16 x, bool take) {
  const float a = acc[0] + __bfloat162float(
      __float2bfloat16_rn(__fmul_rn(v, __bfloat162float(x))));
  acc[0] = take ? a : acc[0];
}
__device__ __forceinline__ void fma_into(float* acc, float v,
                                         __nv_bfloat162 x, bool take) {
  const float2 xf = __bfloat1622float2(x);
  const float2 p = __bfloat1622float2(__float22bfloat162_rn(
      make_float2(__fmul_rn(v, xf.x), __fmul_rn(v, xf.y))));
  const float a0 = acc[0] + p.x, a1 = acc[1] + p.y;
  acc[0] = take ? a0 : acc[0];
  acc[1] = take ? a1 : acc[1];
}
__device__ __forceinline__ void fma_into(float* acc, float v, bf16x4 x,
                                         bool take) {
  fma_into(acc, v, x.lo, take);
  fma_into(acc + 2, v, x.hi, take);
}

// 4 bytes global -> shared, asynchronously; zero-filled unless `valid`
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// out = dense + acc (the reference's `dense + rest` order), or acc
__device__ __forceinline__ void store(float* p, const float* acc,
                                      const float* d, float*) {
  *p = d ? *d + acc[0] : acc[0];
}
__device__ __forceinline__ void store(float* p, const float* acc,
                                      const float* d, float2*) {
  float2 v = make_float2(acc[0], acc[1]);
  if (d) {
    const float2 dv = *reinterpret_cast<const float2*>(d);
    v.x = dv.x + v.x;
    v.y = dv.y + v.y;
  }
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store(float* p, const float* acc,
                                      const float* d, float4*) {
  float4 v = make_float4(acc[0], acc[1], acc[2], acc[3]);
  if (d) {
    const float4 dv = *reinterpret_cast<const float4*>(d);
    v.x = dv.x + v.x;
    v.y = dv.y + v.y;
    v.z = dv.z + v.z;
    v.w = dv.w + v.w;
  }
  *reinterpret_cast<float4*>(p) = v;
}

// Adds edges [lo, hi) of one row to acc in order, U at a time; the
// features a lane holds in slot i are f0 + (sub + lanes i) VEC + [0, VEC).
// `edge(e, col, val)` reads edge e from global memory or from the stage.
// Each batch's U gathers are issued before any of them is added. No load
// is conditional and no add of a whole batch is predicated: either let
// the compiler chain a batch's gathers through one register, one round
// trip per edge. Whole batches come first; the tail batch, if any,
// repeats its last edge and skips the repeats, and a slot past F reads
// the row's last vector (it is never stored).
template <int VEC, bool BX, int NV, class Edge>
__device__ __forceinline__ void walk(float (&acc)[NV][VEC], Edge edge,
                                     int lo, int hi,
                                     const typename Vec<VEC, BX>::E* x,
                                     int F, int f0, int sub, int lanes) {
  using V = typename Vec<VEC, BX>::T;
  constexpr int U = unroll_for(NV * static_cast<int>(sizeof(V)));
  int fo[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    fo[i] = min(f0 + (sub + lanes * i) * VEC, F - VEC);
  }
  float v[U];
  V xv[U][NV];
  auto gather = [&](int eb, int last) {   // edges eb .. eb + last
#pragma unroll
    for (int j = 0; j < U; ++j) {
      int c;
      edge(eb + min(j, last), c, v[j]);
      const auto* xr = x + static_cast<size_t>(c) * F;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        xv[j][i] = load(reinterpret_cast<const V*>(xr + fo[i]));
      }
    }
  };
  auto add = [&](int n) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
#pragma unroll
      for (int i = 0; i < NV; ++i) fma_into(acc[i], v[j], xv[j][i], j < n);
    }
  };
  int eb = lo;
  for (; eb + U <= hi; eb += U) {
    gather(eb, U - 1);
    add(U);   // j < U: no predicate
  }
  if (eb < hi) {
    gather(eb, hi - eb - 1);
    add(hi - eb);
  }
}

// A CTA takes WARPS * 32 / lanes consecutive rows, `lanes` lanes each.
// VEC > 1 needs F % VEC == 0 and x, dense and out aligned to their
// vectors (checked by the host). XS: F = 1 (GAT's segment sums), where
// the staged path also stages each chunk's x values (its own instance, so
// the generic path's registers do not set its occupancy). MAP: the rows
// are walked through row_map, in an instance of its own, so a launch in
// index order runs the code it ran before the row order existed (with the
// map tested at run time, F = 41 ran 4-5% slower a launch in index order
// on an H100).
template <int VEC, bool BX, int NV, bool XS, bool MAP>
__global__ void __launch_bounds__(
    WARPS * 32,
    min_ctas(NV * static_cast<int>(sizeof(typename Vec<VEC, BX>::T)), NV))
csr_spmm_kernel(const int32_t* __restrict__ row_ptr,   // [n_rows + 1]
                const int32_t* __restrict__ cols,      // [>= nnz]
                const float* __restrict__ vals,        // [>= nnz]
                const typename Vec<VEC, BX>::E* __restrict__ x,  // [n_cols, F]
                const float* __restrict__ dense,       // [n_rows, F] or null
                float* __restrict__ out,               // [n_rows, F]
                const int32_t* __restrict__ cta_order,  // [grid] or null
                const int32_t* __restrict__ row_map,    // [n_rows] or null
                int n_rows, int F, int lg_lanes) {
  using S = typename Vec<VEC, false>::T;   // out's vector type
  const int lanes = 1 << lg_lanes;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const int cta = cta_order ? __ldg(cta_order + blockIdx.x)
                            : static_cast<int>(blockIdx.x);
  const int warp_row0 = (cta * WARPS + (threadIdx.x >> 5))
                        << (5 - lg_lanes);
  const int r = warp_row0 + (lane >> lg_lanes);   // the walked row
  const int pass = lanes * NV * VEC;
  // the row of dense and out that walked row r stands for (a live r only)
  auto out_row = [&]() {
    if constexpr (MAP) {
      return __ldg(row_map + r);
    } else {
      return r;
    }
  };
  auto finish = [&](float (&acc)[NV][VEC], int f0, int orow) {
    const size_t o = static_cast<size_t>(orow) * F + f0;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int f = (sub + lanes * i) * VEC;
      if (f0 + f < F) {
        store(out + o + f, acc[i], dense ? dense + o + f : nullptr,
              static_cast<S*>(nullptr));
      }
    }
  };
  if constexpr (STAGE_EDGES == 0) {
    if (r >= n_rows) return;   // no warp-wide operation follows
    const int e_begin = __ldg(row_ptr + r);
    const int e_end = __ldg(row_ptr + r + 1);
    auto edge = [&](int e, int& c, float& v) {
      c = __ldg(cols + e);
      v = __ldg(vals + e);
    };
    const int orow = out_row();
    for (int f0 = 0; f0 < F; f0 += pass) {
      float acc[NV][VEC] = {};
      walk<VEC, BX, NV>(acc, edge, e_begin, e_end, x, F, f0, sub, lanes);
      finish(acc, f0, orow);
    }
  } else {
    // The warp's span of edges, [row_ptr[warp_row0], row_ptr[last + 1]),
    // staged in chunks of SE edges by cp.async into two buffers: the next
    // chunk loads while this one is walked. Every lane stays for the
    // warp's syncs.
    constexpr int SE = NV * VEC < PASS_VALUES ? STAGE_EDGES
                       : STAGE_EDGES_WIDE;
    static_assert(SE % 32 == 0, "STAGE_EDGES is a multiple of 32");
    __shared__ int s_col[WARPS][2][SE];
    __shared__ float s_val[WARPS][2][SE];
    __shared__ float s_x[XS ? WARPS : 1][XS ? SE : 1];
    if (warp_row0 >= n_rows) return;   // warp-uniform
    const int w = threadIdx.x >> 5;
    const int s0 = __ldg(row_ptr + warp_row0);
    const int s1 = __ldg(row_ptr + min(warp_row0 + (32 >> lg_lanes), n_rows));
    const bool live = r < n_rows;
    const int e_begin = live ? __ldg(row_ptr + r) : s0;
    const int e_end = live ? __ldg(row_ptr + r + 1) : s0;
    const int orow = live ? out_row() : 0;
    auto stage = [&](int c0, int b) {
#pragma unroll
      for (int k0 = 0; k0 < SE; k0 += 32) {
        const int k = k0 + lane;
        const bool in = c0 + k < s1;
        const int e = in ? c0 + k : s0;   // a valid address either way
        cp_async4(&s_col[w][b][k], cols + e, in);
        cp_async4(&s_val[w][b][k], vals + e, in);
      }
      cp_async_commit();
    };
    for (int f0 = 0; f0 < F; f0 += pass) {
      float acc[NV][VEC] = {};
      if (s0 < s1) stage(s0, 0);
      int b = 0;
      for (int c0 = s0; c0 < s1; c0 += SE, b ^= 1) {
        const int lo = max(e_begin, c0), hi = min(e_end, c0 + SE);
        if constexpr (XS) {
          // the whole warp gathers the chunk's x values (past the span
          // the staged column is 0, a valid row), then each row's chain
          // reads shared memory only
          cp_async_wait_all();   // this chunk's edges have landed
          __syncwarp();
#pragma unroll
          for (int k0 = 0; k0 < SE; k0 += 32) {
            const int k = k0 + lane;
            cp_async4(&s_x[w][k], x + s_col[w][b][k], true);
          }
          cp_async_commit();
        }
        if (c0 + SE < s1) {
          stage(c0 + SE, b ^ 1);
        } else {
          cp_async_commit();   // an empty group keeps the count
        }
        cp_async_wait_one();   // all but the next chunk's group landed
        __syncwarp();
        if constexpr (XS) {
#pragma unroll 8
          for (int e = lo; e < hi; ++e) {
            acc[0][0] = fmaf(s_val[w][b][e - c0], s_x[w][e - c0], acc[0][0]);
          }
        } else {
          auto edge = [&](int e, int& c, float& v) {
            c = s_col[w][b][e - c0];
            v = s_val[w][b][e - c0];
          };
          walk<VEC, BX, NV>(acc, edge, lo, hi, x, F, f0, sub, lanes);
        }
        __syncwarp();   // buffer b is staged again two chunks on
      }
      if (live) finish(acc, f0, orow);
    }
  }
}

struct Args {
  const void *row_ptr, *cols, *vals, *x, *dense;
  void* out;
  const void *cta_order, *row_map;
  int n_rows, F, lg_lanes, rows_per_cta;
  cudaStream_t stream;
};

template <int VEC, bool BX, int NV, bool XS, bool MAP>
void launch_kernel(const Args& a) {
  const int blocks = (a.n_rows + a.rows_per_cta - 1) / a.rows_per_cta;
  csr_spmm_kernel<VEC, BX, NV, XS, MAP><<<blocks, WARPS * 32, 0, a.stream>>>(
      static_cast<const int32_t*>(a.row_ptr),
      static_cast<const int32_t*>(a.cols), static_cast<const float*>(a.vals),
      static_cast<const typename Vec<VEC, BX>::E*>(a.x),
      static_cast<const float*>(a.dense), static_cast<float*>(a.out),
      static_cast<const int32_t*>(a.cta_order),
      static_cast<const int32_t*>(a.row_map), a.n_rows, a.F, a.lg_lanes);
}

// a row map is taken with f32 x only (kernel B's; kernel C's bf16 x keeps
// its rows' order)
template <int VEC, bool BX, int NV, bool XS>
bool launch_map(const Args& a) {
  if (a.row_map == nullptr) {
    launch_kernel<VEC, BX, NV, XS, false>(a);
    return true;
  }
  if constexpr (BX) {
    return false;
  } else {
    launch_kernel<VEC, BX, NV, XS, true>(a);
    return true;
  }
}

template <int VEC, bool BX, int NV>
bool launch_nv(int nv, const Args& a) {
  if constexpr (NV * VEC <= PASS_VALUES) {
    if (nv != NV) return false;
    if constexpr (VEC == 1 && NV == 1 && !BX && STAGE_EDGES > 0) {
      if (a.F == 1) return launch_map<1, false, 1, true>(a);
    }
    return launch_map<VEC, BX, NV, false>(a);
  }
  return false;
}

// the vector slots per lane this file compiles (ops/spmm.py::CSR_NV)
template <int VEC, bool BX>
bool launch_vec(int nv, const Args& a) {
  return launch_nv<VEC, BX, 1>(nv, a) || launch_nv<VEC, BX, 2>(nv, a) ||
         launch_nv<VEC, BX, 3>(nv, a) || launch_nv<VEC, BX, 5>(nv, a) ||
         launch_nv<VEC, BX, 10>(nv, a) || launch_nv<VEC, BX, 20>(nv, a);
}

template <bool BX>
bool launch(int vec, int nv, const Args& a) {
  switch (vec) {
    case 1: return launch_vec<1, BX>(nv, a);
    case 2: return launch_vec<2, BX>(nv, a);
    case 4: return launch_vec<4, BX>(nv, a);
    default: return false;
  }
}

}  // namespace

extern "C" {

// out = dense + A @ x for the CSR matrix A (row_ptr, cols, vals); `dense`
// may be null. `x_bf16` = 1 takes x as bf16 and rounds each slot's product
// to bf16 (kernel C's precision="bf16"). (vec, lanes, nv, unroll, passes,
// rows_per_cta) is the plan of ops/spmm.py::csr_plan, checked against
// what this file compiles. Pointers are device pointers; `stream` is a
// cudaStream_t; `cta_order` (null: index order) is a permutation of the
// ceil(n_rows / rows_per_cta) CTAs, int32, the k-th launched CTA taking
// the rows of CTA cta_order[k]; `row_map` (null: identity; f32 x only)
// is a permutation of the n_rows rows, int32: the CSR's row r is the
// matrix's row row_map[r], read from dense and written to out there (the
// CSR is then the matrix with its rows walked in row_map's order, columns
// unchanged). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for shapes or plans the kernel does not take.
int csr_spmm(const void* row_ptr, const void* cols, const void* vals,
             const void* x, const void* dense, void* out, int n_rows, int F,
             int x_bf16, int vec, int lanes, int nv, int unroll, int passes,
             int rows_per_cta, void* stream, const void* cta_order,
             const void* row_map) {
  auto aligned = [](const void* p, int n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const int x_bytes = x_bf16 ? 2 : 4;
  const bool ok =
      n_rows > 0 && F > 0 && (vec == 1 || vec == 2 || vec == 4) &&
      F % vec == 0 && aligned(x, vec * x_bytes) && aligned(out, vec * 4) &&
      (dense == nullptr || aligned(dense, vec * 4)) && lanes >= 1 &&
      lanes <= 32 && (lanes & (lanes - 1)) == 0 &&
      rows_per_cta == WARPS * 32 / lanes && nv >= 1 &&
      nv * vec <= PASS_VALUES && unroll == unroll_for(nv * vec * x_bytes) &&
      passes == (F / vec + lanes * nv - 1) / (lanes * nv);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{row_ptr, cols, vals, x, dense, out, cta_order, row_map,
               n_rows, F,
               __builtin_ctz(static_cast<unsigned>(lanes)), rows_per_cta,
               static_cast<cudaStream_t>(stream)};
  const bool launched = x_bf16 ? launch<true>(vec, nv, a)
                               : launch<false>(vec, nv, a);
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
