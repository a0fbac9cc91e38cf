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
// What bounds it on the H100. Each edge needs 2 F flops against two
// operand rows; counting each row of a and b once, the function moves
// (n_a + n_b) F s bytes plus the edge index and the output, while the
// kernel gathers one b row an edge (from L2 where b fits it: GAT's
// per-head b is 7.5 MB at F = 8 and 38 MB at F = 41). So it is bound by
// bytes, and at narrow widths by how many gathers are in flight and by
// the instructions spent on each edge. The first kernel (one warp a
// segment of 64 edges, 640 features a pass, 4 edges in flight and a
// 6-shuffle transposing sum for every 4) left 28 of 32 lanes idle at
// F = 8 and ran slower there (2.024 ms a call) than at F = 41 (1.828).
//
// Design: a launch plan from F (ops/spmm.py::sddmm_plan, checked here
// against what this file compiles), in the manner of kernel B's; every
// choice below won on an H100 80GB HBM3 at 700 W (tools/kernel_ab.py,
// PERF.md's kernel D findings), at the Reddit-shape graph's 11.6M edges.
// * Lanes per edge: `lanes` is the least power of two covering F / VEC
//   vectors when a lane holds 32 bytes of b a pass, but enough that one
//   load of the group reads a whole 32-byte sector of the row where it
//   has one; at most 32. A warp holds 32 / lanes lane groups, each on its
//   own edge. VEC (1, 2 or 4 f32; 4 bf16, one 8-byte load, in bf16 mode)
//   is the widest load that F and the operands' alignment allow; a lane
//   holds NV vectors a pass (at most PASS_VALUES values), so a pass
//   covers up to 640 features at 32 lanes. GAT's heads: F = 8 gives 16
//   groups of 2 lanes (0.121 ms a call against the first kernel's
//   2.025; one lane an edge, half a sector a load, 0.139), F = 41 four
//   groups of 8 lanes (0.571 against 1.829; 16 lanes 0.712, 4 lanes
//   0.760).
// * Narrow groups (a warp of several groups): U edges in flight per
//   group, U = IN_FLIGHT_BYTES / the b bytes a lane gathers an edge, in
//   [U_MIN, U_MAX]; each batch's gathers of b and loads of a are issued
//   before any is summed, and the next batch's edge index is loaded
//   while they fly. The batch's edges are interleaved over the groups
//   (group g takes edges pb + u * groups + g), so the index loads are
//   coalesced, and the groups of one load of a read consecutive edges,
//   which in row order mostly share a row: a's rows are read once an edge
//   through L1, mostly as one broadcast. Each group sums its lanes by
//   log2(lanes) xor shuffles; lane 0 of each group stores. A warp takes
//   SEG_EDGES edges or a little more (whole batches).
// * Wide rows (32 lanes, the warp one group, HOLD): reading a's row once
//   an edge doubled the L2 traffic there (F = 602 in LPA order: 7.25 ms
//   against the first kernel's 3.76), so the warp holds its row of a in
//   registers and reads it again only where the row changes. It has
//   HOLD_UNROLL edges in flight, reads their index in one load and
//   shuffles it, sums them by one transposing butterfly (U - 1 + log2(32
//   / U) shuffles, not 5 an edge) and stores them with one instruction;
//   it takes HOLD_SEG_EDGES edges, which keeps the edges in flight on the
//   card close together in LPA order (256 lost 3-12% there). Each path is
//   an instance of its own, so neither's registers bound the other's
//   occupancy. At F = 602, where the first kernel had this path's shape
//   (a warp on 64 edges, a's row per run, 4 edges in flight), it is within
//   1% of it in LPA order (f32; 4% faster at bf16) and 1% faster in
//   shuffled order.
// * A load past F is not made: its values are zero (predicated loads; b's
//   bf16 copy is zero-padded past F), so it adds 0 * 0. Clamped loads
//   with a select on each sum cost 10% at F = 602 in bf16.
// * No load of a batch waits on another; an edge past the warp's span
//   repeats its last edge and is not stored. Long rows stay cut: a warp
//   takes consecutive edges whatever their rows, so no warp waits on a
//   hub row.
//
// No tensor cores: the graph's cells are under 1% full, so a dense
// a_cell @ b_stripe^T product would do ~100x the needed flops. No atomics:
// every edge's value is summed in a fixed order (within a lane: its slots
// and their features in order, one fmaf chain; across the group: a fixed
// butterfly; across passes: in order, by the same lane) and written by
// one lane, so two launches give identical bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int WARPS = 4;               // warps per CTA
constexpr int PASS_VALUES = 20;        // b values a lane holds per pass
constexpr int IN_FLIGHT_BYTES = 64;    // b bytes a lane gathers per batch
constexpr int U_MIN = 2;               // edges per batch and lane group,
constexpr int U_MAX = 8;               // at least and at most
constexpr int SEG_EDGES = 256;         // edges per warp, at least
constexpr int HOLD_UNROLL = 4;         // a warp that is one lane group:
constexpr int HOLD_SEG_EDGES = 64;     // its edges a batch and a warp

// edges per batch and lane group when a lane gathers `bytes` of b an edge
// (`hold`: the warp is one lane group)
__host__ __device__ constexpr int unroll_for(int bytes, bool hold) {
  return hold                              ? HOLD_UNROLL
         : IN_FLIGHT_BYTES / bytes < U_MIN ? U_MIN
         : IN_FLIGHT_BYTES / bytes > U_MAX ? U_MAX
                                           : IN_FLIGHT_BYTES / bytes;
}

// edges per warp for batches of `batch` edges: whole batches, at least
// SEG_EDGES (HOLD_SEG_EDGES where the warp is one lane group)
__host__ __device__ constexpr int seg_for(int batch, bool hold) {
  return ((hold ? HOLD_SEG_EDGES : SEG_EDGES) + batch - 1) / batch * batch;
}

// the vector a lane loads: VEC f32 values, or 4 bf16 values as raw bits
template <typename T, int VEC> struct Vec;
template <> struct Vec<float, 1> { using T = float; };
template <> struct Vec<float, 2> { using T = float2; };
template <> struct Vec<float, 4> { using T = float4; };
template <> struct Vec<uint16_t, 4> { using T = uint2; };

__device__ __forceinline__ void widen(float v, float* o) { o[0] = v; }
__device__ __forceinline__ void widen(float2 v, float* o) {
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void widen(float4 v, float* o) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void widen(uint2 v, float* o) {   // 4 bf16
  o[0] = __uint_as_float(v.x << 16);
  o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16);
  o[3] = __uint_as_float(v.y & 0xffff0000u);
}

// x rounded to bf16 (nearest even) and widened back
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// N values in each lane of a warp -> every lane holds the warp sum of
// value lane / (32 / N): transposing rounds over the top lane bits, then
// a butterfly over the rest
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

// A warp takes edges [p0, p0 + seg); its 32 / lanes groups of `lanes`
// lanes each take one edge at a time, U edges a batch. b (element type
// TB) is read VEC elements a load, NV loads a lane and pass, so a pass
// covers lanes * NV * VEC features; a is f32, read AV values a load
// (VEC / AV loads a slot) and, when b is bf16, rounded to bf16.
// HOLD (32 lanes an edge, the warp one group: wide rows): the warp keeps
// its row of a in registers and reads it again only where the row
// changes, reads a batch's edge index in one load and sums the batch by
// one transposing butterfly; otherwise a's row is read once an edge
// through L1, where the groups of one load mostly read the same row.
// Each is an instance of its own, so neither path's registers bound the
// other's occupancy.
template <typename TB, int VEC, int NV, int AV, bool HOLD>
__global__ void __launch_bounds__(WARPS * 32)
sddmm_kernel(const int32_t* __restrict__ rows,
             const int32_t* __restrict__ cols,
             const float* __restrict__ a, const TB* __restrict__ b,
             float* __restrict__ out, int64_t nnz, int F, int ld,
             int lg_lanes, int seg) {
  using BV = typename Vec<TB, VEC>::T;
  using AVT = typename Vec<float, AV>::T;
  constexpr int U = unroll_for(NV * static_cast<int>(sizeof(BV)), HOLD);
  constexpr int CH = VEC / AV;   // a's loads per slot
  const int lane = threadIdx.x & 31;
  const int lanes = HOLD ? 32 : 1 << lg_lanes;
  const int sub = HOLD ? lane : lane & (lanes - 1);
  const int groups = HOLD ? 1 : 32 >> lg_lanes;
  const int g = HOLD ? 0 : lane >> lg_lanes;
  const int64_t p0 =
      (static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5)) * seg;
  if (p0 >= nnz) return;   // warp-uniform
  const int64_t p1 = p0 + seg < nnz ? p0 + seg : nnz;
  const int64_t batch = static_cast<int64_t>(groups) * U;
  for (int f0 = 0; f0 < F; f0 += lanes * NV * VEC) {
    // this lane's slots: features f0 + (sub + lanes * i) * VEC, in b's
    // vector i and a's CH loads of it; a load past F is not made and its
    // values are zero (b's padded bf16 rows hold zeros past F), so it adds
    // 0 * 0 to the sum
    int fs[NV];
    bool take[NV][CH];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      fs[i] = f0 + (sub + lanes * i) * VEC;
#pragma unroll
      for (int k = 0; k < CH; ++k) take[i][k] = fs[i] + k * AV < F;
    }
    // a's values of row r in this lane's slots
    auto load_a = [&](int r, AVT (&v)[NV][CH]) {
      const float* ar = a + static_cast<size_t>(r) * F;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          const AVT* p = reinterpret_cast<const AVT*>(ar + fs[i] + k * AV);
          v[i][k] = take[i][k] ? __ldg(p) : AVT{};
        }
    };
    // ... widened to f32 (rounded to bf16 where b is bf16)
    auto widen_a = [&](const AVT (&v)[NV][CH], float (&x)[NV][VEC]) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          widen(v[i][k], x[i] + k * AV);
          if constexpr (sizeof(TB) == 2) {
#pragma unroll
            for (int t = 0; t < AV; ++t) {
              x[i][k * AV + t] = bf16_round(x[i][k * AV + t]);
            }
          }
        }
    };
    // b's vectors of row c in this lane's slots
    auto load_b_row = [&](int c, BV (&y)[NV]) {
      const TB* br = b + static_cast<size_t>(c) * ld;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const BV* p = reinterpret_cast<const BV*>(br + fs[i]);
        y[i] = take[i][0] ? __ldg(p) : BV{};
      }
    };
    // this lane's part of <a row, b row>: its slots and their features in
    // order, one fmaf chain
    auto dot = [&](const float (&x)[NV][VEC], const BV (&y)[NV]) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float yf[VEC];
        widen(y[i], yf);
#pragma unroll
        for (int v = 0; v < VEC; ++v) s = fmaf(x[i][v], yf[v], s);
      }
      return s;
    };
    if constexpr (HOLD) {
      static_assert(U == 2 || U == 4 || U == 8, "U divides the warp");
      // lane u < U holds edge pb + u's index (past the segment its last
      // edge, a valid address whose value is not stored)
      auto index = [&](int64_t pb, int& r, int& c) {
        int64_t e = pb + (lane < U ? lane : 0);
        e = e < p1 ? e : p1 - 1;
        r = __ldg(rows + e);
        c = __ldg(cols + e);
      };
      int my_r, my_c;
      index(p0, my_r, my_c);
      int cur = -1;           // the row of a held in ah
      float ah[NV][VEC];
      for (int64_t pb = p0; pb < p1; pb += U) {
        BV bv[U][NV];
        int rb[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          load_b_row(__shfl_sync(kFull, my_c, u), bv[u]);
          rb[u] = __shfl_sync(kFull, my_r, u);
        }
        index(pb + U, my_r, my_c);   // the next batch's, in flight
        float s[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (rb[u] != cur) {   // warp-uniform: a new run of rows
            AVT v[NV][CH];
            load_a(rb[u], v);
            widen_a(v, ah);
            cur = rb[u];
          }
          s[u] = dot(ah, bv[u]);
        }
        const float v = warp_transpose_reduce<U>(s, lane);
        const int64_t e = pb + lane / (32 / U);
        if (lane % (32 / U) == 0 && e < p1) {
          out[e] = f0 == 0 ? v : out[e] + v;
        }
      }
    } else {
      // edge u of the batch at pb for this lane's group (past the segment
      // its last edge, a valid address whose value is not stored)
      auto index = [&](int64_t pb, int (&r)[U], int (&c)[U]) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          int64_t e = pb + u * groups + g;
          e = e < p1 ? e : p1 - 1;
          r[u] = __ldg(rows + e);
          c[u] = __ldg(cols + e);
        }
      };
      int r[U], c[U];
      index(p0, r, c);
      for (int64_t pb = p0; pb < p1; pb += batch) {
        BV bv[U][NV];
        AVT av[U][NV][CH];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          load_b_row(c[u], bv[u]);
          load_a(r[u], av[u]);
        }
        index(pb + batch, r, c);   // the next batch's, in flight
        float s[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float x[NV][VEC];
          widen_a(av[u], x);
          s[u] = dot(x, bv[u]);
        }
        for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            s[u] += __shfl_xor_sync(kFull, s[u], off);
          }
        }
        if (sub == 0) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int64_t e = pb + u * groups + g;
            if (e < p1) out[e] = f0 == 0 ? s[u] : out[e] + s[u];
          }
        }
      }
    }
  }
}

bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

struct Args {
  const void *rows, *cols, *a, *b;
  void* out;
  int64_t nnz;
  int F, ld, lg_lanes, seg, edges_per_cta;
  cudaStream_t stream;
};

template <typename TB, int VEC, int NV, int AV, bool HOLD>
void launch_kernel(const Args& x) {
  const int64_t blocks = (x.nnz + x.edges_per_cta - 1) / x.edges_per_cta;
  sddmm_kernel<TB, VEC, NV, AV, HOLD>
      <<<static_cast<unsigned>(blocks), WARPS * 32, 0, x.stream>>>(
          static_cast<const int32_t*>(x.rows),
          static_cast<const int32_t*>(x.cols), static_cast<const float*>(x.a),
          static_cast<const TB*>(x.b), static_cast<float*>(x.out), x.nnz, x.F,
          x.ld, x.lg_lanes, x.seg);
}

template <typename TB, int VEC, int AV, int NV>
bool launch_nv(int nv, const Args& x) {
  if constexpr (NV * VEC <= PASS_VALUES) {
    if (nv != NV) return false;
    if (x.lg_lanes == 5) {
      launch_kernel<TB, VEC, NV, AV, true>(x);
    } else {
      launch_kernel<TB, VEC, NV, AV, false>(x);
    }
    return true;
  }
  return false;
}

// the vectors per lane this file compiles (ops/spmm.py::SDDMM_NV)
template <typename TB, int VEC, int AV>
bool launch(int nv, const Args& x) {
  return launch_nv<TB, VEC, AV, 1>(nv, x) ||
         launch_nv<TB, VEC, AV, 2>(nv, x) ||
         launch_nv<TB, VEC, AV, 3>(nv, x) ||
         launch_nv<TB, VEC, AV, 4>(nv, x) ||
         launch_nv<TB, VEC, AV, 5>(nv, x) ||
         launch_nv<TB, VEC, AV, 6>(nv, x) ||
         launch_nv<TB, VEC, AV, 10>(nv, x) ||
         launch_nv<TB, VEC, AV, 20>(nv, x);
}

}  // namespace

extern "C" {

// out[e_pad] = SDDMM of a and b over the graph's first nnz edges (rows,
// cols: int32, in any order, fastest in row order), zero beyond. `a` is
// f32 [n_a, F]; `b` has row stride `ld` in its elements. `bf16` selects
// the bf16 mode: b is bf16 (ld % 4 == 0, rows zero-padded past F, 8-byte
// aligned). (vec, a_vec, lanes, nv, unroll, passes, seg, edges_per_cta)
// is the plan of ops/spmm.py::sddmm_plan, checked against what this file
// compiles. Pointers are device pointers; `stream` is a cudaStream_t.
// Clears the padding slots, then launches the kernel when nnz > 0;
// returns the first CUDA error (cudaErrorInvalidValue for shapes or plans
// the kernel does not take).
int sddmm(const void* rows, const void* cols, const void* a, const void* b,
          void* out, int64_t nnz, int64_t e_pad, int F, int ld, int bf16,
          int vec, int a_vec, int lanes, int nv, int unroll, int passes,
          int seg, int edges_per_cta, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (nnz < 0 || nnz > e_pad || F <= 0 || ld < F) return bad;
  const bool a_ok = (a_vec == 1 || a_vec == 2 || a_vec == 4) &&
                    F % a_vec == 0 && aligned(a, 4 * a_vec);
  const bool b_ok = bf16 ? vec == 4 && ld % 4 == 0 && aligned(b, 8)
                         : vec == a_vec && ld % vec == 0 &&
                               aligned(b, 4 * vec);
  const int elem = bf16 ? 2 : 4;
  const int n_vec = (F + vec - 1) / vec;
  const bool plan_ok =
      lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0 && nv >= 1 &&
      nv * vec <= PASS_VALUES &&
      unroll == unroll_for(nv * vec * elem, lanes == 32) &&
      passes == (n_vec + lanes * nv - 1) / (lanes * nv) &&
      seg == seg_for(32 / lanes * unroll, lanes == 32) &&
      edges_per_cta == WARPS * seg;
  if (!a_ok || !b_ok || !plan_ok) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e_pad > nnz) {
    const cudaError_t e = cudaMemsetAsync(
        static_cast<float*>(out) + nnz, 0, (e_pad - nnz) * sizeof(float), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (nnz == 0) return 0;
  if ((nnz + edges_per_cta - 1) / edges_per_cta > 0x7fffffff) return bad;
  const Args x{rows, cols, a, b, out, nnz, F, ld,
               __builtin_ctz(static_cast<unsigned>(lanes)), seg,
               edges_per_cta, s};
  bool launched = false;
  if (bf16) {
    switch (a_vec) {
      case 1: launched = launch<uint16_t, 4, 1>(nv, x); break;
      case 2: launched = launch<uint16_t, 4, 2>(nv, x); break;
      case 4: launched = launch<uint16_t, 4, 4>(nv, x); break;
    }
  } else {
    switch (vec) {
      case 1: launched = launch<float, 1, 1>(nv, x); break;
      case 2: launched = launch<float, 2, 2>(nv, x); break;
      case 4: launched = launch<float, 4, 4>(nv, x); break;
    }
  }
  if (!launched) return bad;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
