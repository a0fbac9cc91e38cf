// Kernel F: a row gather, out[i, :] = x[idx[i], :] (f32), with two entries.
//
// Replaces the two TPU gather probes:
//  * scripts/exp_take_probe.py::make.kernel (:52, pallas_call :67), a
//    vectorized in-kernel gather in three JAX spellings (jnp.take, x[idx]
//    and take_along_axis): one function, out = x[idx], which the `load`
//    entry computes;
//  * scripts/exp_dma_gather_probe.py::kernel (:38, pallas_call :61), one
//    asynchronous DMA a row with an offset read at run time
//    (make_async_copy(x_hbm.at[pl.ds(col, 1)], ...)), which the `async`
//    entry computes with Hopper's bulk-copy engine (TMA): one instruction
//    copies a whole row.
//
// Bound on the H100: bytes. The function writes n_out * F * 4 bytes and
// must read each distinct row of x once plus the index; at the take
// probe's shape (65,536 rows out of a 2,048 x 768 table) the table is
// 6.3 MB and fits the 50 MB L2, so the bound is the output's 201 MB over
// 3.35 TB/s. Each launch takes its plan (grid, threads, rows a round,
// shared memory) from ops/row_gather.py::gather_plan and refuses one that
// does not match what it compiles. What the design does about the bound:
//  * `load` (row_gather_load): a persistent grid of one wave (the SMs
//    times LOAD_MIN_CTAS, which __launch_bounds__ guarantees). Each warp
//    takes U rows a round (U = 32 * LOAD_K / the row's vectors, 1 to 32):
//    lane j < U holds row j's index, read in one coalesced load a round
//    and handed out by __shfl_sync, and every lane issues all of its (up
//    to LOAD_K) 16-byte loads of the round's rows before any store; the
//    next round's indices are read behind those loads, so no row waits on
//    its index. The table is read under an L2 evict_last policy
//    (createpolicy + ld.global.nc.L2::cache_hint) and the output written
//    with streaming stores (st.global.cs), so the 201 MB written do not
//    push the table out of L2. F % 4 != 0 or a misaligned operand takes
//    the same kernel with 4-byte elements.
//  * `async` (row_gather_async), F % 4 == 0 and both operands on 16
//    bytes: a CTA of one warp owns a contiguous run of rows and a ring of
//    N row slots in shared memory (N = in_flight: 1, 2, 4, 8 or 16), one
//    mbarrier a slot. Lane 0 issues, for each row, one
//    cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes of
//    F * 4 bytes into the row's slot, waits on the slot's mbarrier phase,
//    and writes the row out with one cp.async.bulk.global.shared::cta.
//    bulk_group; the warp's other lanes read the rows' indices, 32 a load,
//    one batch ahead. A slot is refilled only after cp.async.bulk.
//    wait_group.read shows that its store has read it (the store of the
//    row before, so that one store stays in flight behind the loads; at
//    N = 1 the ring's only slot waits for its own store). No thread moves
//    a byte of a row: at N = 16 and F = 768 a CTA holds 48 KB, so 4 CTAs
//    and 64 rows are in flight on an SM, and at N = 1 up to 32 CTAs.
//    Ordering between the two bulk copies: the load's bytes are written
//    by the async proxy and their arrival is observed by lane 0's
//    mbarrier wait (generic proxy); the store that reads them is again an
//    async-proxy operation. A fence.proxy.async.shared::cta between the
//    wait and the store orders the generic-proxy observation before the
//    async-proxy read, as the memory model asks when one proxy's access
//    follows what another observed; it costs one instruction a row and
//    tools/kernel_ab.py times the kernel without it (`no_proxy_fence`).
//    Refilling a slot needs no fence: wait_group.read returns once the
//    store's reads of shared memory are done, and the next load into the
//    slot is issued after it by the same thread, in the same proxy.
//    F % 4 != 0 or a misaligned operand keeps the cp.async path: each
//    thread copies 4-byte pieces of N rows into the ring
//    (cp.async.ca.shared.global) and stores exactly the pieces it copied,
//    so it waits only on its own copies (cp.async.wait_group) and the CTA
//    needs no barrier.
// Every path copies bits, so they equal the plain version exactly. An
// index out of range stops the kernel with a trap, as PyTorch's
// device-side assert does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int LOAD_THREADS = 256;   // 8 warps
constexpr int LOAD_MIN_CTAS = 4;    // CTAs an SM: at most 64 registers
constexpr int LOAD_K = 8;           // vectors a lane holds in flight
constexpr int BULK_THREADS = 32;    // one warp; lane 0 issues the copies
constexpr int CP_MAX_THREADS = 256;
constexpr int MAX_SMEM = 232448;    // bytes of shared memory a CTA may use
constexpr unsigned FULL = 0xffffffffu;
constexpr long long WATCHDOG = 2000000000LL;   // ~1 s of clock64 ticks

__device__ __forceinline__ int64_t checked_row(const int32_t* idx,
                                               int64_t i, int n_x_rows) {
  const int r = idx[i];
  if (r < 0 || r >= n_x_rows) asm volatile("trap;");
  return r;
}

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ float4 load_kept(const float4* p, uint64_t pol) {
  float4 v;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ float load_kept(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;\n"
      : "=f"(v)
      : "l"(p), "l"(pol));
  return v;
}

// row j of the round (j < U) is lane j's index; lanes past the round's
// rows hold 0
__device__ __forceinline__ int round_index(const int32_t* idx, int64_t round,
                                           int U, int64_t n_out, int lane,
                                           int n_x_rows) {
  const int64_t i = round * U + lane;
  if (lane < U && i < n_out) return static_cast<int>(
      checked_row(idx, i, n_x_rows));
  return 0;
}

// T: float4 (w = F / 4 vectors a row) or float (w = F)
template <typename T>
__global__ void __launch_bounds__(LOAD_THREADS, LOAD_MIN_CTAS)
gather_load_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                   T* __restrict__ out, int64_t n_out, int w, int n_x_rows,
                   int U) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t n_rounds = (n_out + U - 1) / U;
  const uint64_t pol = policy_evict_last();
  int mine = warp < n_rounds
                 ? round_index(idx, warp, U, n_out, lane, n_x_rows)
                 : 0;
  for (int64_t r = warp; r < n_rounds; r += n_warps) {
    const int64_t row0 = r * U;
    const int rows = static_cast<int>(n_out - row0 < U ? n_out - row0 : U);
    const int total = rows * w;   // vectors of the round
    int next = 0;
    for (int base = 0; base < total; base += 32 * LOAD_K) {
      T v[LOAD_K];
#pragma unroll
      for (int k = 0; k < LOAD_K; ++k) {
        const int p = base + k * 32 + lane;
        const int u = p < total ? p / w : 0;
        const int src = __shfl_sync(FULL, mine, u);
        if (p < total) {
          v[k] = load_kept(x + static_cast<int64_t>(src) * w + (p - u * w),
                           pol);
        }
      }
      if (base == 0 && r + n_warps < n_rounds) {
        next = round_index(idx, r + n_warps, U, n_out, lane, n_x_rows);
      }
#pragma unroll
      for (int k = 0; k < LOAD_K; ++k) {
        const int p = base + k * 32 + lane;
        if (p < total) {
          const int u = p / w;
          __stcs(out + (row0 + u) * w + (p - u * w), v[k]);
        }
      }
    }
    mine = next;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
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

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;\n" ::"l"(dst),
      "r"(src), "r"(bytes), "l"(pol)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the indices of a CTA's rows, 32 a batch: lane j of batch b holds the
// index of the CTA's row b * 32 + j
struct RowIndices {
  const int32_t* idx;
  int64_t row0, n_mine;
  int n_x_rows, lane;
  int cur, nxt;
  int64_t cur_batch;

  __device__ int read(int64_t batch) const {
    const int64_t t = batch * 32 + lane;
    return t < n_mine ? static_cast<int>(checked_row(idx, row0 + t,
                                                     n_x_rows))
                      : 0;
  }
  __device__ void start() {
    cur_batch = 0;
    cur = read(0);
    nxt = read(1);
  }
  // the index of row t; every lane calls it, with t one past the last
  __device__ int of(int64_t t) {
    if ((t >> 5) != cur_batch) {
      cur = nxt;
      ++cur_batch;
      nxt = read(cur_batch + 1);
    }
    return __shfl_sync(FULL, cur, static_cast<int>(t & 31));
  }
};

// N rows in flight a CTA, by bulk copies; CTA b owns rows
// [b * per, (b + 1) * per), per = ceil(n_out / grid)
template <int N>
__global__ void __launch_bounds__(BULK_THREADS)
gather_bulk_kernel(const float* __restrict__ x,
                   const int32_t* __restrict__ idx, float* __restrict__ out,
                   int64_t n_out, int F, int n_x_rows) {
  extern __shared__ __align__(128) unsigned char smem[];   // [N][F], bars
  constexpr int LAG = N > 1 ? 1 : 0;   // stores left in flight at a refill
  const int lane = threadIdx.x;
  const uint32_t bytes = static_cast<uint32_t>(F) * 4;
  const uint32_t slots = smem_addr(smem);
  const uint32_t bars = slots + N * bytes;
  const int64_t per = (n_out + gridDim.x - 1) / gridDim.x;
  const int64_t row0 = blockIdx.x * per;
  const int64_t n_mine = row0 >= n_out ? 0
                         : (n_out - row0 < per ? n_out - row0 : per);
  if (n_mine == 0) return;
  uint64_t keep = 0, stream = 0;
  if (lane == 0) {
    for (int s = 0; s < N; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    keep = policy_evict_last();
    stream = policy_evict_first();
  }
  __syncwarp();
  RowIndices ri{idx, row0, n_mine, n_x_rows, lane, 0, 0, 0};
  ri.start();
  auto issue = [&](int64_t t, int r) {
    const int s = static_cast<int>(t % N);
    mbar_expect_tx(bars + 8 * s, bytes);
    bulk_load(slots + s * bytes, x + static_cast<int64_t>(r) * F, bytes,
              bars + 8 * s, keep);
  };
  const int64_t first = n_mine < N ? n_mine : N;
  for (int64_t t = 0; t < first; ++t) {
    const int r = ri.of(t);
    if (lane == 0) issue(t, r);
  }
  for (int64_t t = 0; t < n_mine; ++t) {
    if (lane == 0) {
      const int s = static_cast<int>(t % N);
      mbar_wait(bars + 8 * s, static_cast<uint32_t>((t / N) & 1));
      proxy_fence();
      bulk_store(out + (row0 + t) * F, slots + s * bytes, bytes, stream);
    }
    // refill the slot of row t - LAG with row t - LAG + N once its store
    // has read it
    const int64_t t_next = t - LAG + N;
    if (t >= LAG && t_next < n_mine) {
      const int r = ri.of(t_next);
      if (lane == 0) {
        bulk_wait_read<LAG>();
        issue(t_next, r);
      }
    }
  }
  if (lane == 0) bulk_wait_all();
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// N rows in flight per CTA by 4-byte cp.async copies; CTA b walks rows
// b, b + grid, b + 2 grid, ...
template <int N>
__global__ void gather_cp_kernel(const float* __restrict__ x,
                                 const int32_t* __restrict__ idx,
                                 float* __restrict__ out, int64_t n_out,
                                 int F, int n_x_rows) {
  extern __shared__ __align__(16) float ring[];   // [N][F]
  const int64_t first = blockIdx.x;
  const int64_t stride = gridDim.x;
  const int64_t n_mine = first < n_out ? (n_out - 1 - first) / stride + 1
                                       : 0;
  auto issue = [&](int64_t t) {
    const int64_t r = checked_row(idx, first + t * stride, n_x_rows);
    const float* src = x + r * F;
    float* slot = ring + static_cast<int64_t>(t % N) * F;
    for (int p = threadIdx.x; p < F; p += blockDim.x) {
      cp_async4(slot + p, src + p);
    }
  };
#pragma unroll
  for (int t = 0; t < N - 1; ++t) {
    if (t < n_mine) issue(t);
    cp_commit();
  }
  for (int64_t t = 0; t < n_mine; ++t) {
    // the slot of row t + N - 1 held row t - 1, which this thread has
    // already stored (its own pieces, in program order)
    if (t + N - 1 < n_mine) issue(t + N - 1);
    cp_commit();
    cp_wait<N - 1>();   // row t's pieces of this thread have landed
    const float* slot = ring + static_cast<int64_t>(t % N) * F;
    float* dst = out + (first + t * stride) * F;
    for (int p = threadIdx.x; p < F; p += blockDim.x) dst[p] = slot[p];
  }
  cp_wait<0>();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

constexpr int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

// raise the kernel's dynamic shared memory limit to MAX_SMEM once; the
// bulk kernel also asks for all of the SM's L1 as shared memory
template <typename K>
int allow_smem(K kernel, bool carve_out, bool* done) {
  if (*done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess && carve_out) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *done = true;
  return 0;
}

template <int N>
int launch_bulk(const float* x, const int32_t* idx, float* out,
                int64_t n_out, int F, int n_x_rows, int grid, int smem,
                cudaStream_t s) {
  static bool ready = false;
  const int rc = allow_smem(gather_bulk_kernel<N>, true, &ready);
  if (rc) return rc;
  gather_bulk_kernel<N><<<grid, BULK_THREADS, smem, s>>>(x, idx, out, n_out,
                                                         F, n_x_rows);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_cp(const float* x, const int32_t* idx, float* out, int64_t n_out,
              int F, int n_x_rows, int grid, int threads, int smem,
              cudaStream_t s) {
  static bool ready = false;
  const int rc = allow_smem(gather_cp_kernel<N>, false, &ready);
  if (rc) return rc;
  gather_cp_kernel<N><<<grid, threads, smem, s>>>(x, idx, out, n_out, F,
                                                  n_x_rows);
  return static_cast<int>(cudaGetLastError());
}

#define SGC_BY_DEPTH(launch, ...)                                         \
  switch (in_flight) {                                                    \
    case 1: return launch<1>(__VA_ARGS__);                                \
    case 2: return launch<2>(__VA_ARGS__);                                \
    case 4: return launch<4>(__VA_ARGS__);                                \
    case 8: return launch<8>(__VA_ARGS__);                                \
    case 16: return launch<16>(__VA_ARGS__);                              \
    default: return invalid();                                            \
  }

}  // namespace

extern "C" {

// out[n_out, F] = x[idx] (x: f32 [n_x_rows, F], idx: int32 [n_out], all
// device pointers; `stream` a cudaStream_t) by warps, under the plan of
// ops/row_gather.py::gather_plan: `vec` floats an element (4: F % 4 == 0
// and x, out on 16 bytes; else 1), `grid` CTAs of `threads`
// (LOAD_THREADS), `rows_per_round` rows a warp's round (1 to 32). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a plan
// this build does not take.
int row_gather_load(const void* x, const void* idx, void* out, int64_t n_out,
                    int F, int n_x_rows, int vec, int grid, int threads,
                    int rows_per_round, void* stream) {
  if (n_out <= 0 || F <= 0 || n_x_rows <= 0 || grid <= 0 ||
      threads != LOAD_THREADS || rows_per_round < 1 || rows_per_round > 32) {
    return invalid();
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int32_t*>(idx);
  if (vec == 4) {
    if (F % 4 || !aligned16(x) || !aligned16(out)) return invalid();
    gather_load_kernel<float4><<<grid, LOAD_THREADS, 0, s>>>(
        static_cast<const float4*>(x), ix, static_cast<float4*>(out), n_out,
        F / 4, n_x_rows, rows_per_round);
  } else if (vec == 1) {
    gather_load_kernel<float><<<grid, LOAD_THREADS, 0, s>>>(
        static_cast<const float*>(x), ix, static_cast<float*>(out), n_out, F,
        n_x_rows, rows_per_round);
  } else {
    return invalid();
  }
  return static_cast<int>(cudaGetLastError());
}

// The same function with `in_flight` rows (1, 2, 4, 8 or 16) in flight a
// CTA: by bulk copies (`bulk` 1: F % 4 == 0, x and out on 16 bytes;
// BULK_THREADS threads, `smem_bytes` = in_flight * (F * 4 + 8)) or by
// 4-byte cp.async copies (`bulk` 0; `threads` a multiple of 32 up to
// CP_MAX_THREADS, `smem_bytes` = in_flight * F * 4), `grid` CTAs.
int row_gather_async(const void* x, const void* idx, void* out,
                     int64_t n_out, int F, int n_x_rows, int in_flight,
                     int bulk, int grid, int threads, int smem_bytes,
                     void* stream) {
  if (n_out <= 0 || F <= 0 || n_x_rows <= 0 || grid <= 0 ||
      smem_bytes > MAX_SMEM) {
    return invalid();
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bulk) {
    if (F % 4 || !aligned16(x) || !aligned16(out) ||
        threads != BULK_THREADS ||
        smem_bytes != in_flight * (F * 4 + 8)) {
      return invalid();
    }
    SGC_BY_DEPTH(launch_bulk, xf, ix, of, n_out, F, n_x_rows, grid,
                 smem_bytes, s)
  }
  if (threads < 32 || threads > CP_MAX_THREADS || threads % 32 ||
      smem_bytes != in_flight * F * 4) {
    return invalid();
  }
  SGC_BY_DEPTH(launch_cp, xf, ix, of, n_out, F, n_x_rows, grid, threads,
               smem_bytes, s)
}

}  // extern "C"
