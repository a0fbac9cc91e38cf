// GAT's attention coefficients on a CSR graph: the edge scores with their
// leaky ReLU, the softmax over each row's edges, and both backwards.
//
//   edge_scores           logits[e] = leaky(pre[e]), mask[e] = pre[e] > 0,
//                         pre[e]    = dst[r] + src[cols[e]]
//   edge_softmax          alpha[e]  = exp(l[e] - max_r) / max(sum_r, 1e-30)
//   edge_softmax_grad     d[e]      = alpha[e] (g[e] - s_r),
//                         s_r       = sum over row r of alpha g
//   edge_scores_grad_dst  d_dst[r]  = sum over row r of gl
//   edge_scores_grad_src  d_src[c]  = sum over column c of gl (over the
//                         transpose's rows, through its edge permutation)
//
// for every row r and its live edges e (row_ptr order), where gl[e] = d[e]
// if mask[e], else d[e] * slope (PyTorch's rule: slope at exactly 0), and
// the sums are over a row's edges. Padding slots [nnz, e_pad): the logits
// and the mask take the formula on the padding's own rows and cols, alpha
// and d are 0.
//
// Replaces the segment ops of sgc_tpu/models/gat.py:59-77 (XLA's
// segment_max and segment_sum over sorted rows, the gathers seg_max[rows]
// and denom[rows]) and the rank-1 gathers of its logits (:96-99). No
// single PyTorch call computes any of them: the port composed them from
// index_select gathers, an amax scatter_reduce, elementwise passes and
// kernel B's F = 1 row and column sums, five to seven launches each.
//
// What bounds it on the H100: bytes, and the random 4-byte accesses
// among them. Each edge costs a few flops against 5-13 bytes of streamed
// arrays, and the per-row values are node-sized (0.9 MB at the Reddit
// shape); but every gather of a node value at an edge's column (src in
// the scores) is a 32-byte sector read from L2 for 4 useful bytes, and
// the column sums need each edge's term in the transpose's order. The
// composition it replaces read and wrote every per-row value back out to
// the edges (seg_max[rows], denom[rows], s[rows]), gathered g[perm] from
// DRAM at random and passed over the edges once a PyTorch op.
//
// Design.
// * A warp takes 32 consecutive rows, one lane a row's chain. Its rows'
//   edges are one contiguous span; the per-row values of the warp (its
//   33 row pointers, max, denominator or sum, dst) sit in shared memory,
//   so no per-row value is gathered back out to the edges.
// * Work per edge that is not a chain (expf, the division, the leaky
//   rule, the gather of src, the stores) runs edge-parallel: lane k takes
//   the span's edges k, k + 32, ..., coalesced, finding each edge's row
//   by a cursor over the warp's row pointers that only moves forward.
//   Only the sums and the max run a lane a row, over shared memory, their
//   terms loaded ahead of the chain's links.
// * The softmax's passes (max; exp and sum; normalise) and its backward's
//   (sum; product) re-read the span staged by cp.async in shared memory,
//   not device memory, wherever it fits CAP: 98% of the warps at the
//   Reddit shape (mean span 1,600 edges) at CAP = 2,048. Longer spans (a
//   hub row of ~1,300 edges with its 31 neighbours) are staged again for
//   each pass.
// * The scores' backward gathers nothing. The leaky ReLU's derivative
//   needs only whether the pre-activation is over 0, which the forward
//   keeps as a byte an edge. The row pass streams d and that mask, sums
//   each row, and stores each edge's term at its place in the transpose
//   (the inverse of the transpose's permutation, cached with it) under an
//   L2 evict_last policy, its CTAs walking the row blocks in index order
//   one an SM, so that the stores in flight fill a narrow band of each
//   column's list; the column pass streams those terms in order. A
//   column pass that gathered d at random (47 MB, mostly from DRAM) took
//   0.51 ms a launch on an H100 80GB HBM3 at 700 W, against 0.26 + 0.03
//   for the row pass with its scattered stores and this column pass.
// * An extra CTA writes the padding slots.
// * No float atomics; no row is split.
//
// Deterministic, and the bits of the composition it replaces: every sum is
// one chain from 0 in row_ptr order of the rounded terms (kernel B's
// F = 1 order: fmaf(v, 1, acc) is acc + v rounded once), the products,
// differences, quotients and the leaky rule are single IEEE operations
// (__fmul_rn, __fsub_rn, __fdiv_rn, so that nothing contracts into an
// fma), and expf is the library's, as torch.exp's. A max does not depend
// on the order. The transposed chain runs in the transpose's edge order,
// as kernel B's column sums did over the gathered g[perm].

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int SCORE_WARPS = 8;     // warps per CTA of edge_scores
constexpr int STAGE_WARPS = 4;     // of edge_softmax
constexpr int PAIR_WARPS = 2;      // of edge_softmax_grad (two buffers)
constexpr int CHAIN_WARPS = 8;     // of the scores' row and column sums
constexpr int CAP = 2048;          // staged edges per warp and pass
constexpr int CHAIN_CAP = 1024;    // edges per warp and chunk of the sums
constexpr int U = 8;               // loads in flight per lane
constexpr int CHAIN_U = 8;         // shared loads ahead of a chain's adds
// CTAs an SM of the scores' row pass, which walk the row blocks in index
// order: the fewer rows in flight, the narrower the band of each column's
// list in the transpose's order that their stores fill (H100 80GB HBM3,
// a launch at the Reddit shape: 1 CTA an SM 0.259 ms, 2 0.281, 3 0.292,
// 4 0.310, every block resident 0.305)
constexpr int FRONT_CTAS_PER_SM = 1;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// src[lo, lo + n) into buf[0, n), the warp's lanes in turn (coalesced);
// the copies are awaited by landed()
template <class T>
__device__ __forceinline__ void stage(T* buf, const T* src, int lo, int n,
                                      int lane) {
  for (int k = lane; k < n; k += 32) cp_async4(buf + k, src + lo + k);
}

__device__ __forceinline__ void landed() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncwarp();
}

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : __fmul_rn(x, slope);
}

// an L2 policy that keeps the lines it writes over streamed ones
__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ void store_kept(float* p, float v,
                                           uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;\n" ::"l"(p),
               "f"(v), "l"(policy)
               : "memory");
}

struct Add {
  __device__ __forceinline__ float operator()(float a, float v) const {
    return __fadd_rn(a, v);
  }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float v) const {
    return fmaxf(a, v);
  }
};

// acc = op(acc, term(k)) for k = a .. z - 1 in order: one lane's chain
// over a staged chunk, CHAIN_U terms loaded ahead of their links
template <class Term, class Op>
__device__ __forceinline__ float chain(int a, int z, float acc, Term term,
                                       Op op) {
  int k = a;
  for (; k + CHAIN_U <= z; k += CHAIN_U) {
    float v[CHAIN_U];
#pragma unroll
    for (int j = 0; j < CHAIN_U; ++j) v[j] = term(k + j);
#pragma unroll
    for (int j = 0; j < CHAIN_U; ++j) acc = op(acc, v[j]);
  }
  for (; k < z; ++k) acc = op(acc, term(k));
  return acc;
}

// The warp's rows r0 .. r0 + 31 (those past n_rows are empty): their 33
// pointers into rp, and this lane's edges [lo, hi).
struct WarpRows {
  int lane, r0, lo, hi, s0, s1;
  const int* rp;

  __device__ __forceinline__ WarpRows(const int32_t* __restrict__ row_ptr,
                                      int n_rows, int warp, int* s_rp)
      : lane(threadIdx.x & 31), r0(warp * 32), rp(s_rp) {
    s_rp[lane] = __ldg(row_ptr + min(r0 + lane, n_rows));
    if (lane == 0) s_rp[32] = __ldg(row_ptr + min(r0 + 32, n_rows));
    __syncwarp();
    lo = rp[lane];
    hi = rp[lane + 1];
    s0 = rp[0];
    s1 = rp[32];
  }

  // the warp row (0-31) of edge e, from cursor r (edges visited in
  // increasing order)
  __device__ __forceinline__ int row_of(int e, int r) const {
    while (rp[r + 1] <= e) ++r;
    return r;
  }

  // the lane's edges within the chunk [c0, c0 + n), as chunk offsets
  __device__ __forceinline__ int first(int c0) const {
    return max(lo, c0) - c0;
  }
  __device__ __forceinline__ int last(int c0, int n) const {
    return min(hi, c0 + n) - c0;
  }

  __device__ __forceinline__ bool live(int n_rows) const {
    return r0 + lane < n_rows;
  }
};

// CTAs of `warps` warps that cover n_rows rows, 32 a warp
__host__ __device__ __forceinline__ int ctas(int n_rows, int warps) {
  const int rows = warps * 32;
  return (n_rows + rows - 1) / rows;
}

// the global warp index of this lane in CTAs of `warps` warps
__device__ __forceinline__ int warp_index(int warps) {
  return static_cast<int>(blockIdx.x) * warps + (threadIdx.x >> 5);
}

// The rows' CTAs, then one more: its threads write the padding slots
__device__ __forceinline__ bool padding_cta() {
  return blockIdx.x == gridDim.x - 1;
}

__global__ void __launch_bounds__(SCORE_WARPS * 32)
edge_scores_kernel(const int32_t* __restrict__ row_ptr,
                   const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ cols,
                   const float* __restrict__ dst,
                   const float* __restrict__ src, float* __restrict__ out,
                   uint8_t* __restrict__ mask, int n_rows, int nnz,
                   int e_pad, float slope) {
  __shared__ int s_rp[SCORE_WARPS][33];
  __shared__ float s_dst[SCORE_WARPS][32];
  if (padding_cta()) {   // the formula on the padding's rows and columns
    for (int e = nnz + threadIdx.x; e < e_pad; e += blockDim.x) {
      const float pre = __fadd_rn(__ldg(dst + __ldg(rows + e)),
                                  __ldg(src + __ldg(cols + e)));
      out[e] = leaky(pre, slope);
      mask[e] = pre > 0.f;
    }
    return;
  }
  const int warp = warp_index(SCORE_WARPS), w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp * 32 >= n_rows) return;   // warp-uniform
  const WarpRows wr(row_ptr, n_rows, warp, s_rp[w]);
  s_dst[w][lane] = wr.live(n_rows) ? __ldg(dst + wr.r0 + lane) : 0.f;
  __syncwarp();
  int r = 0;
  for (int b = wr.s0; b < wr.s1; b += 32 * U) {
    int c[U];
    float v[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      c[j] = __ldcs(cols + min(b + 32 * j + lane, wr.s1 - 1));
    }
#pragma unroll
    for (int j = 0; j < U; ++j) v[j] = __ldg(src + c[j]);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int e = b + 32 * j + lane;
      if (e < wr.s1) {
        r = wr.row_of(e, r);
        const float pre = __fadd_rn(s_dst[w][r], v[j]);
        out[e] = leaky(pre, slope);
        mask[e] = pre > 0.f;
      }
    }
  }
}

__global__ void __launch_bounds__(STAGE_WARPS * 32)
edge_softmax_kernel(const int32_t* __restrict__ row_ptr,
                    const float* __restrict__ logits,
                    float* __restrict__ alpha, int n_rows, int nnz,
                    int e_pad) {
  __shared__ int s_rp[STAGE_WARPS][33];
  __shared__ float s_max[STAGE_WARPS][32];
  __shared__ float s_den[STAGE_WARPS][32];
  __shared__ float s_buf[STAGE_WARPS][CAP];
  if (padding_cta()) {
    for (int e = nnz + threadIdx.x; e < e_pad; e += blockDim.x) {
      alpha[e] = 0.f;
    }
    return;
  }
  const int warp = warp_index(STAGE_WARPS), w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp * 32 >= n_rows) return;
  const WarpRows wr(row_ptr, n_rows, warp, s_rp[w]);
  float* buf = s_buf[w];
  const int s0 = wr.s0, s1 = wr.s1;
  const bool whole = s1 - s0 <= CAP;   // staged once for every pass
  auto load = [&](int c0) {
    const int n = min(CAP, s1 - c0);
    stage(buf, logits, c0, n, lane);
    landed();
    return n;
  };
  auto at = [&](int k) { return buf[k]; };
  if (whole && s0 < s1) load(s0);
  // 1. each row's max
  float m = -INFINITY;
  for (int c0 = s0; c0 < s1; c0 += CAP) {
    const int n = whole ? s1 - s0 : load(c0);
    m = chain(wr.first(c0), wr.last(c0, n), m, at, Max());
    __syncwarp();
  }
  s_max[w][lane] = m;
  __syncwarp();
  // 2. ex = exp(l - max) in place, edge-parallel; each row's chain of them
  float acc = 0.f;
  int r = 0;
  for (int c0 = s0; c0 < s1; c0 += CAP) {
    const int n = whole ? s1 - s0 : load(c0);
    for (int k = lane; k < n; k += 32) {
      r = wr.row_of(c0 + k, r);
      buf[k] = expf(__fsub_rn(buf[k], s_max[w][r]));
    }
    __syncwarp();
    acc = chain(wr.first(c0), wr.last(c0, n), acc, at, Add());
    __syncwarp();
  }
  s_den[w][lane] = acc < 1e-30f ? 1e-30f : acc;   // a NaN stays NaN
  __syncwarp();
  // 3. alpha = ex / denominator
  r = 0;
  for (int c0 = s0; c0 < s1; c0 += CAP) {
    const int n = whole ? s1 - s0 : load(c0);
    for (int k = lane; k < n; k += 32) {
      r = wr.row_of(c0 + k, r);
      const float ex = whole ? buf[k]
                             : expf(__fsub_rn(buf[k], s_max[w][r]));
      alpha[c0 + k] = __fdiv_rn(ex, s_den[w][r]);
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(PAIR_WARPS * 32)
edge_softmax_grad_kernel(const int32_t* __restrict__ row_ptr,
                         const float* __restrict__ alpha,
                         const float* __restrict__ g, float* __restrict__ d,
                         int n_rows, int nnz, int e_pad) {
  __shared__ int s_rp[PAIR_WARPS][33];
  __shared__ float s_sum[PAIR_WARPS][32];
  __shared__ float s_a[PAIR_WARPS][CAP];
  __shared__ float s_g[PAIR_WARPS][CAP];
  if (padding_cta()) {
    for (int e = nnz + threadIdx.x; e < e_pad; e += blockDim.x) d[e] = 0.f;
    return;
  }
  const int warp = warp_index(PAIR_WARPS), w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp * 32 >= n_rows) return;
  const WarpRows wr(row_ptr, n_rows, warp, s_rp[w]);
  float *a = s_a[w], *gb = s_g[w];
  const int s0 = wr.s0, s1 = wr.s1;
  const bool whole = s1 - s0 <= CAP;
  auto load = [&](int c0) {
    const int n = min(CAP, s1 - c0);
    stage(a, alpha, c0, n, lane);
    stage(gb, g, c0, n, lane);
    landed();
    return n;
  };
  auto product = [&](int k) { return __fmul_rn(a[k], gb[k]); };
  if (whole && s0 < s1) load(s0);
  // 1. s = each row's chain of the rounded products alpha g
  float acc = 0.f;
  for (int c0 = s0; c0 < s1; c0 += CAP) {
    const int n = whole ? s1 - s0 : load(c0);
    acc = chain(wr.first(c0), wr.last(c0, n), acc, product, Add());
    __syncwarp();
  }
  s_sum[w][lane] = acc;
  __syncwarp();
  // 2. d = alpha (g - s), edge-parallel
  int r = 0;
  for (int c0 = s0; c0 < s1; c0 += CAP) {
    const int n = whole ? s1 - s0 : load(c0);
    for (int k = lane; k < n; k += 32) {
      r = wr.row_of(c0 + k, r);
      d[c0 + k] = __fmul_rn(a[k], __fsub_rn(gb[k], s_sum[w][r]));
    }
    __syncwarp();
  }
}

// d_dst over the graph's rows: gl from d and the forward's mask of
// pre-activations over 0, edge-parallel into shared memory (both
// streamed), then each row's chain over it. With gl_t, each edge's gl is
// also written to its place in the transpose, gl_t[inv_perm[e]], for the
// column sums: one scattered store an edge in place of a gathered load
// there (a store does not hold the warp).
__global__ void __launch_bounds__(CHAIN_WARPS * 32)
edge_scores_grad_dst_kernel(const int32_t* __restrict__ row_ptr,
                            const float* __restrict__ d,
                            const uint8_t* __restrict__ mask,
                            const int32_t* __restrict__ inv_perm,
                            float* __restrict__ out,
                            float* __restrict__ gl_t, int n_rows,
                            float slope) {
  __shared__ int s_rp[CHAIN_WARPS][33];
  __shared__ float s_gl[CHAIN_WARPS][CHAIN_CAP];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_blocks = ctas(n_rows, CHAIN_WARPS);
  float* gl = s_gl[w];
  auto at = [&](int k) { return gl[k]; };
  const uint64_t keep = policy_evict_last();
  // the front: CTA blocks of rows in index order, gridDim.x at a time
  for (int blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const int warp = blk * CHAIN_WARPS + w;
    if (warp * 32 >= n_rows) break;   // the last block's idle warps
    const WarpRows wr(row_ptr, n_rows, warp, s_rp[w]);
    float acc = 0.f;
    for (int c0 = wr.s0; c0 < wr.s1; c0 += CHAIN_CAP) {
      const int n = min(CHAIN_CAP, wr.s1 - c0);
      for (int k0 = 0; k0 < n; k0 += 32 * U) {
        float dv[U];
        uint8_t up[U];
        int t[U];
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const int e = c0 + min(k0 + 32 * j + lane, n - 1);
          dv[j] = __ldcs(d + e);
          up[j] = __ldcs(mask + e);
          t[j] = gl_t ? __ldcs(inv_perm + e) : 0;
        }
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const int k = k0 + 32 * j + lane;
          if (k < n) {
            const float v = up[j] ? dv[j] : __fmul_rn(dv[j], slope);
            gl[k] = v;
            if (gl_t) store_kept(gl_t + t[j], v, keep);
          }
        }
      }
      __syncwarp();
      acc = chain(wr.first(c0), wr.last(c0, n), acc, at, Add());
      __syncwarp();
    }
    if (wr.live(n_rows)) out[wr.r0 + lane] = acc;
  }
}

// d_src over the transpose's rows (the graph's columns): each row's chain
// over gl_t, the row pass's gl in the transpose's edge order, staged in
// chunks
__global__ void __launch_bounds__(CHAIN_WARPS * 32)
edge_scores_grad_src_kernel(const int32_t* __restrict__ t_row_ptr,
                            const float* __restrict__ gl_t,
                            float* __restrict__ out, int n_cols) {
  __shared__ int s_rp[CHAIN_WARPS][33];
  __shared__ float s_gl[CHAIN_WARPS][CHAIN_CAP];
  const int warp = warp_index(CHAIN_WARPS), w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp * 32 >= n_cols) return;
  const WarpRows wr(t_row_ptr, n_cols, warp, s_rp[w]);
  float* gl = s_gl[w];
  auto at = [&](int k) { return gl[k]; };
  float acc = 0.f;
  for (int c0 = wr.s0; c0 < wr.s1; c0 += CHAIN_CAP) {
    const int n = min(CHAIN_CAP, wr.s1 - c0);
    stage(gl, gl_t, c0, n, lane);
    landed();
    acc = chain(wr.first(c0), wr.last(c0, n), acc, at, Add());
    __syncwarp();
  }
  if (wr.live(n_cols)) out[wr.r0 + lane] = acc;
}


// the rows' CTAs and the padding's
int ctas_padded(int n_rows, int warps) { return ctas(n_rows, warps) + 1; }

int done() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// Every entry: pointers are device pointers (int32 indices, f32 values),
// `stream` a cudaStream_t; row_ptr has n_rows + 1 entries over the live
// edges [0, nnz); the edge arrays have e_pad slots. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernels do not take.

// logits[e] = leaky(pre[e]), pre[e] = dst[r] + src[cols[e]], and
// mask[e] = pre[e] > 0 (one byte, 0 or 1), for every slot, the padding's
// on its own rows and cols
int edge_scores(const void* row_ptr, const void* rows, const void* cols,
                const void* dst, const void* src, void* logits, void* mask,
                int n_rows, int nnz, int e_pad, float slope, void* stream) {
  if (n_rows <= 0 || nnz < 0 || e_pad < nnz) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  edge_scores_kernel<<<ctas_padded(n_rows, SCORE_WARPS), SCORE_WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(cols), static_cast<const float*>(dst),
      static_cast<const float*>(src), static_cast<float*>(logits),
      static_cast<uint8_t*>(mask), n_rows, nnz, e_pad, slope);
  return done();
}

// alpha: the softmax of the logits over each row's edges, 0 on padding
int edge_softmax(const void* row_ptr, const void* logits, void* alpha,
                 int n_rows, int nnz, int e_pad, void* stream) {
  if (n_rows <= 0 || nnz < 0 || e_pad < nnz) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  edge_softmax_kernel<<<ctas_padded(n_rows, STAGE_WARPS), STAGE_WARPS * 32,
                        0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const float*>(logits),
      static_cast<float*>(alpha), n_rows, nnz, e_pad);
  return done();
}

// d = alpha (g - s_r), s_r the row's sum of alpha g; 0 on padding
int edge_softmax_grad(const void* row_ptr, const void* alpha, const void* g,
                      void* d, int n_rows, int nnz, int e_pad,
                      void* stream) {
  if (n_rows <= 0 || nnz < 0 || e_pad < nnz) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  edge_softmax_grad_kernel<<<ctas_padded(n_rows, PAIR_WARPS),
                             PAIR_WARPS * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const float*>(alpha),
      static_cast<const float*>(g), static_cast<float*>(d), n_rows, nnz,
      e_pad);
  return done();
}

// d_dst[r] = the row's sum of gl[e] = mask[e] ? d[e] : d[e] * slope (out:
// n_rows values); with gl_t (nnz values; null: none), gl_t[inv_perm[e]]
// = gl[e], inv_perm the inverse of the transpose's edge permutation
int edge_scores_grad_dst(const void* row_ptr, const void* d,
                         const void* mask, const void* inv_perm, void* out,
                         void* gl_t, int n_rows, float slope, void* stream) {
  if (n_rows <= 0 || (gl_t != nullptr && inv_perm == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    return static_cast<int>(cudaGetLastError());
  }
  const int grid = std::min(ctas(n_rows, CHAIN_WARPS), FRONT_CTAS_PER_SM * sms);
  edge_scores_grad_dst_kernel<<<grid, CHAIN_WARPS * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const float*>(d),
      static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(inv_perm), static_cast<float*>(out),
      static_cast<float*>(gl_t), n_rows, slope);
  return done();
}

// d_src[c] = the sum of gl_t over the transpose's row c (t_row_ptr: n_cols
// + 1 entries), in its edge order (out: n_cols values)
int edge_scores_grad_src(const void* t_row_ptr, const void* gl_t, void* out,
                         int n_cols, void* stream) {
  if (n_cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  edge_scores_grad_src_kernel<<<ctas(n_cols, CHAIN_WARPS), CHAIN_WARPS * 32,
                                0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(t_row_ptr),
      static_cast<const float*>(gl_t), static_cast<float*>(out), n_cols);
  return done();
}

}  // extern "C"
