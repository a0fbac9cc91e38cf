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
// Design: bucket the edges by row, then one in-order chain per (row,
// feature).
//
// 1. Bucket pass, four launches. The edges are cut into chunks of CH;
//    one warp a chunk walks its edges 32 at a time, in order, counting
//    rows in shared memory (the lanes of one row take their order from
//    the lane index), so each edge gets its rank among the chunk's edges of
//    its row, and the chunk's row counts land in a [chunk, row] table
//    (bucket_count_chunks). A thread a row turns its column of the table
//    into each chunk's offset inside the row (bucket_columns); one CTA
//    scans the rows' totals into row_ptr and lists the rows with more
//    than HEAVY edges, in row order (bucket_scan). Then every edge goes
//    to row_ptr[r] + its chunk's offset + its rank: a stable
//    permutation, with the edges' columns and values written in that
//    order (bucket_scatter). No atomics, so every launch gives the same
//    permutation.
// 2. Accumulate pass. accumulate_light: a CTA owns a slice of SF
//    features over a range of rows and stages that slice of x in shared
//    memory (the TPU kernel kept its stripe in VMEM); its warps then take
//    rows on their own, SF lanes a row, a lane a feature, each lane's sum
//    one in-order chain in a register. Rows with
//    more than HEAVY edges (a hub row: every edge in fixed_out and noop)
//    take accumulate_heavy: a warp a (row, 32 features), one warp a CTA,
//    whose lanes copy x values with cp.async (16 bytes a lane where F
//    allows) into a ring DEPTH batches of 32 edges deep, so that only the
//    dependent add is serial. `out` is written once; a row with no edge
//    gets zeros; in store mode each row takes its last edge.
//
// Bounds on the H100: bytes, counted as ops/roofline.py counts kernel B
// on the same edges (each edge's (row, col, val), each x row the edges
// use and out once each: 13.1 MB at the probe's defaults, 4 us). A hub
// row keeps its order, so each of its features is one dependent chain of
// E adds: the chain bound, E x the FADD latency over the clock
// (ops/roofline.py::chain_bound_ms; edge_chain_cycles below measures the
// latency on the card). An index out of range stops the kernel with a
// trap, as PyTorch's device-side assert does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// mode bits
constexpr int FIXED_ROW = 1;  // every edge updates row 0
constexpr int FIXED_COL = 2;  // every edge reads x row 0
constexpr int STORE = 4;      // assign instead of add

// bucket pass
constexpr int CH = 512;              // edges a chunk (ops/edge_accumulate.py)
constexpr int HIST_SMEM_ROWS = 12288;  // rows a chunk counts in shared memory
constexpr int SCAN_THREADS = 1024;
constexpr int COLUMN_THREADS = 256;
constexpr int SCATTER_THREADS = 256;
// accumulate pass
constexpr int HEAVY = 512;           // edges above which a row is heavy
constexpr int SF = 8;                // features a light slice (lanes a row)
constexpr int ROW_LOADS = 8;         // a row's edges read at once: SF each
constexpr int LIGHT_THREADS = 256;
constexpr int X_SMEM_MAX = 160 * 1024;   // x slice bytes staged at most
constexpr int DEPTH = 10;             // batches of 32 edges in flight, heavy
constexpr int RING_FLOATS = DEPTH * (32 * 32 + 32);
constexpr int HEAVY_CTAS_PER_SM = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// V floats (4 bytes or 16, both aligned) from global to shared memory
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- bucket

// One warp a chunk: its edges' effective rows counted in edge order, 32
// at a time (each lane finds the lanes of its row by 32 shuffles; the
// groups go in order), so each edge gets its rank among the chunk's
// edges of its row;
// the counts end in row c of the [chunk, R] table. The counts sit in
// shared memory when R allows (the launch gives R ints), else in global
// memory (the table's row itself).
template <bool IN_SMEM>
__global__ void __launch_bounds__(32)
bucket_count_chunks(const int32_t* __restrict__ rows, int64_t n_edges, int R,
                    int mode, int32_t* __restrict__ local_rank,
                    int32_t* __restrict__ offs) {
  extern __shared__ int hist_smem[];
  const int lane = threadIdx.x;
  const int c = blockIdx.x;
  const int64_t base = static_cast<int64_t>(c) * CH;
  const int n = static_cast<int>(n_edges - base < CH ? n_edges - base : CH);
  int32_t* counts = offs + static_cast<int64_t>(c) * R;
  int* hist = IN_SMEM ? hist_smem : counts;
  // the lane's rows of every group, loaded at once (-1 past the chunk)
  int rv[CH / 32];
#pragma unroll
  for (int g = 0; g < CH / 32; ++g) {
    const int i = g * 32 + lane;
    rv[g] = i < n ? ((mode & FIXED_ROW) ? 0 : rows[base + i]) : -1;
  }
#pragma unroll 8
  for (int r = lane; r < R; r += 32) hist[r] = 0;
  __syncwarp();
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int g = 0; g < CH / 32; ++g) {
    const int i = g * 32 + lane;
    const int r = rv[g];
    if (i < n && (r < 0 || r >= R)) asm volatile("trap;");
    unsigned peers = 0;   // the lanes of this group with row r
#pragma unroll
    for (int j = 0; j < 32; ++j)
      peers |= static_cast<unsigned>(__shfl_sync(FULL, r, j) == r) << j;
    const int leader = __ffs(peers) - 1;
    int start = 0;
    if (lane == leader && r >= 0) start = hist[r];
    start = __shfl_sync(FULL, start, leader);
    if (r >= 0) {
      local_rank[base + i] = start + __popc(peers & below);
      if (lane == leader) hist[r] = start + __popc(peers);
    }
    __syncwarp();
  }
  if (IN_SMEM) {
#pragma unroll 8
    for (int r = lane; r < R; r += 32) counts[r] = hist[r];
  }
}

// A thread a row: column r of the [chunk, R] table (the row's count in
// each chunk) becomes the edges of row r in chunks before each;
// row_ptr[r] the row's total (bucket_scan makes it its start).
__global__ void __launch_bounds__(COLUMN_THREADS)
bucket_columns(int32_t* __restrict__ offs, int n_chunks, int R,
               int32_t* __restrict__ row_ptr) {
  const int r = blockIdx.x * COLUMN_THREADS + threadIdx.x;
  if (r >= R) return;
  int total = 0;
  for (int c0 = 0; c0 < n_chunks; c0 += 16) {
    int t[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      t[u] = c0 + u < n_chunks ? offs[static_cast<int64_t>(c0 + u) * R + r]
                               : 0;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (c0 + u < n_chunks) {
        offs[static_cast<int64_t>(c0 + u) * R + r] = total;
        total += t[u];
      }
    }
  }
  row_ptr[r] = total;
}

// One CTA: row_ptr (the rows' totals) becomes their exclusive scan, with
// row_ptr[R] the edge count; heavy the rows with more than HEAVY edges
// (none in store mode), in row order, their count in *n_heavy.
__global__ void __launch_bounds__(SCAN_THREADS)
bucket_scan(int R, int store, int32_t* __restrict__ row_ptr,
            int32_t* __restrict__ heavy, int32_t* __restrict__ n_heavy) {
  __shared__ int warp_tot[2][SCAN_THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int carry = 0, hcarry = 0;
  for (int base = 0; base < R; base += SCAN_THREADS) {
    const int r = base + tid;
    const int total = r < R ? row_ptr[r] : 0;
    const int hv = (r < R && !store && total > HEAVY) ? 1 : 0;
    int inc = total, hinc = hv;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(FULL, inc, d);
      const int ho = __shfl_up_sync(FULL, hinc, d);
      if (lane >= d) {
        inc += o;
        hinc += ho;
      }
    }
    if (lane == 31) {
      warp_tot[0][warp] = inc;
      warp_tot[1][warp] = hinc;
    }
    __syncthreads();
    if (warp == 0) {
      int w = warp_tot[0][lane], hw = warp_tot[1][lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(FULL, w, d);
        const int ho = __shfl_up_sync(FULL, hw, d);
        if (lane >= d) {
          w += o;
          hw += ho;
        }
      }
      warp_tot[0][lane] = w;
      warp_tot[1][lane] = hw;
    }
    __syncthreads();
    const int wp = warp > 0 ? warp_tot[0][warp - 1] : 0;
    const int hwp = warp > 0 ? warp_tot[1][warp - 1] : 0;
    if (r < R) {
      row_ptr[r] = carry + wp + inc - total;
      if (hv) heavy[hcarry + hwp + hinc - 1] = r;
    }
    carry += warp_tot[0][SCAN_THREADS / 32 - 1];
    hcarry += warp_tot[1][SCAN_THREADS / 32 - 1];
    __syncthreads();   // warp_tot is rewritten next round
  }
  if (tid == 0) {
    row_ptr[R] = carry;
    *n_heavy = hcarry;
  }
}

// Each edge to its bucketed place: row_ptr[r] + its chunk's offset in the
// row + its rank in the chunk; its effective column and value with it.
__global__ void __launch_bounds__(SCATTER_THREADS)
bucket_scatter(const int32_t* __restrict__ rows,
               const int32_t* __restrict__ cols,
               const float* __restrict__ vals, int64_t n_edges, int R, int W,
               int mode, const int32_t* __restrict__ local_rank,
               const int32_t* __restrict__ offs,
               const int32_t* __restrict__ row_ptr,
               int32_t* __restrict__ perm, int32_t* __restrict__ scol,
               float* __restrict__ sval) {
  const int64_t e =
      static_cast<int64_t>(blockIdx.x) * SCATTER_THREADS + threadIdx.x;
  if (e >= n_edges) return;
  const int r = (mode & FIXED_ROW) ? 0 : rows[e];
  const int c = (mode & FIXED_COL) ? 0 : cols[e];
  if (c < 0 || c >= W) asm volatile("trap;");
  const int dest = row_ptr[r] + offs[(e / CH) * R + r] + local_rank[e];
  perm[dest] = static_cast<int32_t>(e);
  scol[dest] = c;
  sval[dest] = vals[e];
}

// ------------------------------------------------------------ accumulate

// A CTA a slice of SF features over a range of rows. The slice of x
// (W x SF floats) is staged in shared memory when it fits (else read from
// global memory); then each warp, on its own, takes 32 / SF rows a
// round, SF lanes a row, a lane a feature: a row's edges' (col, val) are
// read ROW_LOADS x SF at a time, a lane each, during the round before
// (its row_ptr two rounds before), and passed along the row's lanes by
// shuffles, so each lane's sum is one in-order chain in a register. Rows
// with more than HEAVY edges are left to accumulate_heavy (outside store
// mode).
template <bool STORE_MODE>
__global__ void __launch_bounds__(LIGHT_THREADS)
accumulate_light(const int32_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ scol,
                 const float* __restrict__ sval, const float* __restrict__ x,
                 float* __restrict__ out, int R, int W, int F,
                 int rows_per_cta) {
  constexpr int ROWS_A_WARP = 32 / SF;
  extern __shared__ __align__(16) float x_slice[];   // [W][SF]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int f0 = blockIdx.x * SF;
  const int fl = lane % SF;
  const int grp = lane / SF;
  const bool live = f0 + fl < F;
  const bool x_staged = static_cast<int64_t>(W) * SF * 4 <= X_SMEM_MAX;
  if (x_staged) {   // every copy of the thread in flight at once
    for (int i = tid; i < W * SF; i += LIGHT_THREADS) {
      const int f = f0 + i % SF;
      if (f < F) {
        cp_async<1>(x_slice + i, x + static_cast<int64_t>(i / SF) * F + f);
      } else {
        x_slice[i] = 0.f;
      }
    }
    cp_commit();
    cp_wait<0>();
    __syncthreads();
  }
  const float* xb = x_staged ? x_slice + fl : x + (live ? f0 + fl : 0);
  const int64_t xs = x_staged ? SF : F;
  const int r_begin = blockIdx.y * rows_per_cta;
  const int r_end = min(R, r_begin + rows_per_cta);
  const int warps = LIGHT_THREADS / 32;
  const int step = warps * ROWS_A_WARP;
  // software pipeline over the warp's rounds of rows: round i's first
  // ROW_LOADS x SF edges' (col, val) were read during round i - 1, and
  // row_ptr two rounds ahead
  auto span = [&](int rw, int& beg, int& len) {
    const int r = rw + grp;
    beg = 0;
    len = 0;
    if (r < r_end) {
      beg = row_ptr[r];
      len = row_ptr[r + 1] - beg;
      if (!STORE_MODE && len > HEAVY) len = -1;   // accumulate_heavy's
    }
  };
  auto read = [&](int beg, int len, int (&c)[ROW_LOADS],
                  float (&v)[ROW_LOADS]) {
#pragma unroll
    for (int q = 0; q < ROW_LOADS; ++q) {
      const int k = q * SF + fl;
      c[q] = k < len ? scol[beg + k] : 0;
      v[q] = k < len ? sval[beg + k] : 0.f;
    }
  };
  int rw = r_begin + (tid / 32) * ROWS_A_WARP;
  int beg, len, beg1, len1;
  span(rw, beg, len);
  span(rw + step, beg1, len1);
  int c[ROW_LOADS];
  float v[ROW_LOADS];
  if (!STORE_MODE) read(beg, len, c, v);
  for (; rw < r_end; rw += step) {
    int beg2, len2;
    span(rw + 2 * step, beg2, len2);
    int cn[ROW_LOADS];
    float vn[ROW_LOADS];
    if (!STORE_MODE) read(beg1, len1, cn, vn);
    const int r = rw + grp;
    float acc = 0.f;
    if (STORE_MODE) {
      if (len > 0 && live)
        acc = __fmul_rn(sval[beg + len - 1], xb[scol[beg + len - 1] * xs]);
    } else {
      int most = len;
#pragma unroll
      for (int d = SF; d < 32; d <<= 1)
        most = max(most, __shfl_xor_sync(FULL, most, d));
      // ROW_LOADS x SF edges a round, lane fl holding edges fl, fl + SF,
      // ...; passed along the row's lanes by shuffles
      for (int k0 = 0; k0 < most; k0 += ROW_LOADS * SF) {
        if (k0 > 0) {   // a row longer than one round: read in place
#pragma unroll
          for (int q = 0; q < ROW_LOADS; ++q) {
            const int k = k0 + q * SF + fl;
            c[q] = k < len ? scol[beg + k] : 0;
            v[q] = k < len ? sval[beg + k] : 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < ROW_LOADS; ++q) {
          if (k0 + q * SF < most) {   // warp-uniform
            float xv[SF], vv[SF];
#pragma unroll
            for (int u = 0; u < SF; ++u) {
              const int cu = __shfl_sync(FULL, c[q], grp * SF + u);
              vv[u] = __shfl_sync(FULL, v[q], grp * SF + u);
              xv[u] = xb[cu * xs];
            }
#pragma unroll
            for (int u = 0; u < SF; ++u) {
              if (k0 + q * SF + u < len)
                acc = __fadd_rn(acc, __fmul_rn(vv[u], xv[u]));
            }
          }
        }
      }
    }
    if (r < r_end && len >= 0 && live)
      out[static_cast<int64_t>(r) * F + f0 + fl] = acc;
    beg = beg1;
    len = len1;
    beg1 = beg2;
    len1 = len2;
    if (!STORE_MODE) {
#pragma unroll
      for (int q = 0; q < ROW_LOADS; ++q) {
        c[q] = cn[q];
        v[q] = vn[q];
      }
    }
  }
}

// One warp a CTA, persistent over the (heavy row, 32 features) items. The
// lanes copy batch b's x values (each edge's 32 features, V floats a
// lane, so one copy instruction takes V edges) into ring slot b % DEPTH
// with cp.async, DEPTH - 1 batches ahead of the adds, and the batch's
// values with them; lane l then adds feature l of each edge in order,
// after __syncwarp. Each lane reads the columns of the edges it copies
// (and its own edge's value) 4 batches ahead of their copies, into a
// register ring, so no copy waits on a load or a shuffle.
template <int V>
__global__ void __launch_bounds__(32)
accumulate_heavy(const int32_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ heavy,
                 const int32_t* __restrict__ n_heavy,
                 const int32_t* __restrict__ scol,
                 const float* __restrict__ sval, const float* __restrict__ x,
                 float* __restrict__ out, int F, int n_slices) {
  constexpr int COPIES = 32 / V;   // copy instructions a batch
  extern __shared__ __align__(16) float ring[];   // [DEPTH][32 x 32 + 32]
  const int lane = threadIdx.x;
  const int n_items = *n_heavy * n_slices;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int r = heavy[item / n_slices];
    const int f0 = (item % n_slices) * 32;
    const bool live = f0 + lane < F;
    // the lane's copies: piece lane % COPIES of edge i V + lane / COPIES
    const int fc = f0 + (lane % COPIES) * V;
    const bool copies = fc < F;
    const float* xf = x + (copies ? fc : 0);
    const int beg = row_ptr[r], len = row_ptr[r + 1] - beg;
    const int nb = (len + 31) / 32;
    auto load_index = [&](int b, int (&c)[COPIES], float& v) {
#pragma unroll
      for (int i = 0; i < COPIES; ++i) {
        const int k = b * 32 + i * V + lane / COPIES;
        c[i] = k < len ? scol[beg + k] : -1;
      }
      const int k = b * 32 + lane;
      v = k < len ? sval[beg + k] : 0.f;
    };
    auto issue = [&](int b, const int (&c)[COPIES], float v) {
      float* slot = ring + (b % DEPTH) * (32 * 32 + 32);
      slot[32 * 32 + lane] = v;
#pragma unroll
      for (int i = 0; i < COPIES; ++i) {
        if (copies && c[i] >= 0) {
          cp_async<V>(slot + (i * V + lane / COPIES) * 32 + (fc - f0),
                      xf + static_cast<int64_t>(c[i]) * F);
        }
      }
    };
    int cr[4][COPIES];
    float vr[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) load_index(s, cr[s], vr[s]);
#pragma unroll
    for (int t = 0; t < DEPTH - 1; ++t) {
      if (t < nb) issue(t, cr[t % 4], vr[t % 4]);
      cp_commit();
      load_index(t + 4, cr[t % 4], vr[t % 4]);
    }
    float acc = 0.f;
    for (int b0 = 0; b0 < nb; b0 += 4) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int b = b0 + s;
        if (b < nb) {
          // batch t's indices sit in register slot t % 4, read 4 batches
          // before; the slot then takes batch t + 4's
          const int t = b + DEPTH - 1;
          constexpr int slot_of_t = (DEPTH - 1) % 4;
          if (t < nb) issue(t, cr[(s + slot_of_t) % 4], vr[(s + slot_of_t) % 4]);
          cp_commit();
          load_index(t + 4, cr[(s + slot_of_t) % 4], vr[(s + slot_of_t) % 4]);
          cp_wait<DEPTH - 1>();
          __syncwarp();
          const float* slot = ring + (b % DEPTH) * (32 * 32 + 32);
          const float4* v4 = reinterpret_cast<const float4*>(slot + 32 * 32);
          const float* xs = slot + lane;
          const int n = min(32, len - b * 32);
          if (n == 32) {
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const float4 vq = v4[q];
              acc = __fadd_rn(acc, __fmul_rn(vq.x, xs[(4 * q) * 32]));
              acc = __fadd_rn(acc, __fmul_rn(vq.y, xs[(4 * q + 1) * 32]));
              acc = __fadd_rn(acc, __fmul_rn(vq.z, xs[(4 * q + 2) * 32]));
              acc = __fadd_rn(acc, __fmul_rn(vq.w, xs[(4 * q + 3) * 32]));
            }
          } else {
            for (int j = 0; j < n; ++j)
              acc = __fadd_rn(acc, __fmul_rn(slot[32 * 32 + j], xs[j * 32]));
          }
          __syncwarp();   // the slot is refilled DEPTH - 1 batches on
        }
      }
    }
    if (live) out[static_cast<int64_t>(r) * F + f0 + lane] = acc;
  }
}

// One thread: n dependent f32 adds timed with the SM clock (the chain
// bound's latency a link).
__global__ void fadd_chain(float step, int n, long long* __restrict__ cycles,
                           float* __restrict__ sink) {
  float a = step;
  const long long t0 = clock64();
  for (int i = 0; i < n; i += 64) {
#pragma unroll
    for (int u = 0; u < 64; ++u)
      asm volatile("add.rn.f32 %0, %0, %1;\n" : "+f"(a) : "f"(step));
  }
  const long long t1 = clock64();
  *cycles = t1 - t0;
  *sink = a;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0) {
      n = 132;
    }
  }
  return n;
}

bool bad_sizes(int64_t n_edges, int R, int W, int mode, int chunk) {
  return R <= 0 || W <= 0 || n_edges < 0 || n_edges >= (1LL << 31) ||
         (mode & ~7) != 0 || chunk != CH;
}

int launch_buckets(const void* rows, const void* cols, const void* vals,
                   int64_t n_edges, int R, int W, int mode, void* local_rank,
                   void* offs, void* row_ptr, void* heavy, void* n_heavy,
                   void* perm, void* scol, void* sval, cudaStream_t s) {
  const int n_chunks = static_cast<int>((n_edges + CH - 1) / CH);
  auto* table = static_cast<int32_t*>(offs);
  if (n_chunks > 0) {
    if (R <= HIST_SMEM_ROWS) {
      bucket_count_chunks<true><<<n_chunks, 32, R * sizeof(int), s>>>(
          static_cast<const int32_t*>(rows), n_edges, R, mode,
          static_cast<int32_t*>(local_rank), table);
    } else {
      bucket_count_chunks<false><<<n_chunks, 32, 0, s>>>(
          static_cast<const int32_t*>(rows), n_edges, R, mode,
          static_cast<int32_t*>(local_rank), table);
    }
  }
  bucket_columns<<<(R + COLUMN_THREADS - 1) / COLUMN_THREADS, COLUMN_THREADS,
                   0, s>>>(table, n_chunks, R,
                           static_cast<int32_t*>(row_ptr));
  bucket_scan<<<1, SCAN_THREADS, 0, s>>>(
      R, (mode & STORE) ? 1 : 0, static_cast<int32_t*>(row_ptr),
      static_cast<int32_t*>(heavy), static_cast<int32_t*>(n_heavy));
  if (n_edges > 0) {
    bucket_scatter<<<static_cast<unsigned>(
                         (n_edges + SCATTER_THREADS - 1) / SCATTER_THREADS),
                     SCATTER_THREADS, 0, s>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
        static_cast<const float*>(vals), n_edges, R, W, mode,
        static_cast<const int32_t*>(local_rank), table,
        static_cast<const int32_t*>(row_ptr), static_cast<int32_t*>(perm),
        static_cast<int32_t*>(scol), static_cast<float*>(sval));
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_accumulate(const void* row_ptr, const void* heavy,
                      const void* n_heavy, const void* scol, const void* sval,
                      const void* x, void* out, int64_t n_edges, int R, int W,
                      int F, int mode, cudaStream_t s) {
  static bool attributes_set = false;
  if (!attributes_set) {   // shared memory above 48 KB, set once a process
    const int bytes = X_SMEM_MAX;
    cudaError_t err = cudaFuncSetAttribute(
        accumulate_light<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(accumulate_light<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    attributes_set = true;
  }
  const int light_slices = (F + SF - 1) / SF;
  const int n_slices = (F + 31) / 32;   // the heavy rows' 32-feature items
  const int64_t x_bytes = static_cast<int64_t>(W) * SF * 4;
  const size_t smem = x_bytes <= X_SMEM_MAX ? x_bytes : 0;
  // CTAs a slice over rows: one wave of resident CTAs
  int resident = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &resident, accumulate_light<false>, LIGHT_THREADS, smem) !=
          cudaSuccess || resident <= 0) {
    resident = 1;
  }
  int parts = resident * sm_count() / light_slices;
  parts = max(1, min(parts, (R + 31) / 32));
  const int rows_per_cta = (R + parts - 1) / parts;
  parts = (R + rows_per_cta - 1) / rows_per_cta;
  const dim3 grid(light_slices, parts);
  const auto* rp = static_cast<const int32_t*>(row_ptr);
  const auto* sc = static_cast<const int32_t*>(scol);
  const auto* sv = static_cast<const float*>(sval);
  const auto* xx = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  if (mode & STORE) {
    accumulate_light<true><<<grid, LIGHT_THREADS, smem, s>>>(
        rp, sc, sv, xx, o, R, W, F, rows_per_cta);
    return static_cast<int>(cudaGetLastError());
  }
  accumulate_light<false><<<grid, LIGHT_THREADS, smem, s>>>(
      rp, sc, sv, xx, o, R, W, F, rows_per_cta);
  // at most n_edges / (HEAVY + 1) rows are heavy
  const int64_t heavy_items = n_edges / (HEAVY + 1) * n_slices;
  if (heavy_items > 0) {
    const int64_t cap = static_cast<int64_t>(HEAVY_CTAS_PER_SM) * sm_count();
    const int hgrid = static_cast<int>(heavy_items < cap ? heavy_items : cap);
    const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    if (vec) {
      accumulate_heavy<4><<<hgrid, 32, RING_FLOATS * sizeof(float), s>>>(
          rp, static_cast<const int32_t*>(heavy),
          static_cast<const int32_t*>(n_heavy), sc, sv, xx, o, F, n_slices);
    } else {
      accumulate_heavy<1><<<hgrid, 32, RING_FLOATS * sizeof(float), s>>>(
          rp, static_cast<const int32_t*>(heavy),
          static_cast<const int32_t*>(n_heavy), sc, sv, xx, o, F, n_slices);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The bucket pass alone: rows, cols int32 [n_edges], vals f32 [n_edges]
// (device pointers); `mode` the bits FIXED_ROW = 1, FIXED_COL = 2,
// STORE = 4; `chunk` must be CH. Writes the scratch the wrapper
// allocated: local_rank int32 [n_edges], offs int32 [ceil(n_edges / CH),
// R], row_ptr int32 [R + 1], heavy int32 [R], n_heavy int32 [1], perm, scol int32
// [n_edges], sval f32 [n_edges]. Four launches; returns
// cudaGetLastError() after them (cudaErrorInvalidValue for sizes it does
// not take).
int edge_buckets(const void* rows, const void* cols, const void* vals,
                 int64_t n_edges, int R, int W, int mode, int chunk,
                 void* local_rank, void* offs, void* row_ptr, void* heavy,
                 void* n_heavy, void* perm, void* scol, void* sval,
                 void* stream) {
  if (bad_sizes(n_edges, R, W, mode, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_buckets(rows, cols, vals, n_edges, R, W, mode, local_rank,
                        offs, row_ptr, heavy, n_heavy, perm, scol, sval,
                        static_cast<cudaStream_t>(stream));
}

// The accumulate pass alone on a bucket pass's output: out [R, F] f32
// (written whole), x f32 [W, F]. One or two launches.
int edge_accumulate_bucketed(const void* row_ptr, const void* heavy,
                             const void* n_heavy, const void* scol,
                             const void* sval, const void* x, void* out,
                             int64_t n_edges, int R, int W, int F, int mode,
                             void* stream) {
  if (R <= 0 || W <= 0 || F <= 0 || n_edges < 0 || (mode & ~7) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_accumulate(row_ptr, heavy, n_heavy, scol, sval, x, out,
                           n_edges, R, W, F, mode,
                           static_cast<cudaStream_t>(stream));
}

// Both passes: out [R, F] f32 = the edges' updates in edge order, with
// the scratch of edge_buckets.
int edge_accumulate(const void* rows, const void* cols, const void* vals,
                    const void* x, void* out, int64_t n_edges, int R, int W,
                    int F, int mode, int chunk, void* local_rank, void* offs,
                    void* row_ptr, void* heavy, void* n_heavy, void* perm,
                    void* scol, void* sval, void* stream) {
  if (bad_sizes(n_edges, R, W, mode, chunk) || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int rc = launch_buckets(rows, cols, vals, n_edges, R, W, mode,
                                local_rank, offs, row_ptr, heavy, n_heavy,
                                perm, scol, sval, s);
  if (rc != 0) return rc;
  return launch_accumulate(row_ptr, heavy, n_heavy, scol, sval, x, out,
                           n_edges, R, W, F, mode, s);
}

// Cycles of n dependent f32 adds on one thread (n a multiple of 64), into
// cycles int64 [1] (device); sink f32 [1] takes the sum.
int edge_chain_cycles(void* cycles, void* sink, int n, void* stream) {
  if (n <= 0 || n % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  fadd_chain<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      1.0f, n, static_cast<long long*>(cycles), static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
