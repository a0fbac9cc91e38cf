// Host-side graph preprocessing: sort, CSR build, symmetrize, partition.
//
// The reference delegates all host graph algebra to scipy (SURVEY.md §2.4);
// at 10M+ edges the python sort/partition path is the bottleneck of data
// loading (numpy lexsort is single-threaded comparison sort). This tool
// provides the hot host-side primitives as a C ABI shared library consumed
// via ctypes (sgc_tpu_torch/native/__init__.py, which builds it with
// g++ -O3 -shared -fPIC at first use). This file is the port's own copy of
// sgc_tpu/native/graphprep.cpp, kept byte-for-byte in its algorithms so
// host arrays match the reference bit for bit.
//
// All functions use int64 node ids at the ABI to avoid overflow at
// billion-edge scale; callers downcast to int32 for device buffers.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- sorting

// Parallel LSD radix sort of edges by (row, col) key. rows/cols/vals are
// reordered in place via a permutation; returns 0 on success.
// Radix: 16-bit digits over the (row<<32 | col)-style composite key,
// processed col-first then row (stable passes). Each pass is parallel:
// per-thread histograms over contiguous input ranges, an exclusive
// (bucket-major, then thread) prefix sum, and a parallel stable scatter —
// bucket order across threads preserves the pass's stability invariant.
int sort_edges_by_row_col(int64_t* rows, int64_t* cols, float* vals,
                          int64_t n_edges, int64_t n_rows, int64_t n_cols) {
  if (n_edges <= 0) return 0;

  constexpr int kBits = 16;
  constexpr int kBuckets = 1 << kBits;

  int n_threads = (int)std::max(1u, std::thread::hardware_concurrency());
  // below ~1M edges thread setup + 512KB/thread histograms dominate
  if (n_edges < (1 << 20)) n_threads = 1;
  const int64_t chunk = (n_edges + n_threads - 1) / n_threads;

  std::vector<int64_t> perm(n_edges), tmp_perm(n_edges);
  for (int64_t i = 0; i < n_edges; ++i) perm[i] = i;

  std::vector<int64_t> counts((size_t)n_threads * kBuckets);

  auto radix_pass = [&](const int64_t* key, int shift) {
    std::fill(counts.begin(), counts.end(), 0);

    auto histogram = [&](int t) {
      int64_t lo = t * chunk, hi = std::min(n_edges, lo + chunk);
      int64_t* local = counts.data() + (size_t)t * kBuckets;
      for (int64_t i = lo; i < hi; ++i)
        ++local[((uint64_t)key[perm[i]] >> shift) & (kBuckets - 1)];
    };
    {
      std::vector<std::thread> ts;
      for (int t = 1; t < n_threads; ++t) ts.emplace_back(histogram, t);
      histogram(0);
      for (auto& th : ts) th.join();
    }

    // exclusive prefix over (bucket, thread): thread t's chunk of bucket b
    // starts after all smaller buckets and after threads < t in bucket b
    int64_t sum = 0;
    for (int b = 0; b < kBuckets; ++b) {
      for (int t = 0; t < n_threads; ++t) {
        int64_t& c = counts[(size_t)t * kBuckets + b];
        int64_t v = c;
        c = sum;
        sum += v;
      }
    }

    auto scatter = [&](int t) {
      int64_t lo = t * chunk, hi = std::min(n_edges, lo + chunk);
      int64_t* local = counts.data() + (size_t)t * kBuckets;
      for (int64_t i = lo; i < hi; ++i) {
        int64_t p = perm[i];
        int b = ((uint64_t)key[p] >> shift) & (kBuckets - 1);
        tmp_perm[local[b]++] = p;
      }
    };
    {
      std::vector<std::thread> ts;
      for (int t = 1; t < n_threads; ++t) ts.emplace_back(scatter, t);
      scatter(0);
      for (auto& th : ts) th.join();
    }
    perm.swap(tmp_perm);
  };

  int col_bits = 1;
  while ((1LL << col_bits) < n_cols) ++col_bits;
  int row_bits = 1;
  while ((1LL << row_bits) < n_rows) ++row_bits;

  for (int shift = 0; shift < col_bits; shift += 16) radix_pass(cols, shift);
  for (int shift = 0; shift < row_bits; shift += 16) radix_pass(rows, shift);

  // apply permutation out-of-place (parallel over output ranges)
  std::vector<int64_t> r(n_edges), c(n_edges);
  std::vector<float> v(n_edges);
  auto apply = [&](int t) {
    int64_t lo = t * chunk, hi = std::min(n_edges, lo + chunk);
    for (int64_t i = lo; i < hi; ++i) {
      int64_t p = perm[i];
      r[i] = rows[p];
      c[i] = cols[p];
      v[i] = vals[p];
    }
  };
  {
    std::vector<std::thread> ts;
    for (int t = 1; t < n_threads; ++t) ts.emplace_back(apply, t);
    apply(0);
    for (auto& th : ts) th.join();
  }
  std::memcpy(rows, r.data(), n_edges * sizeof(int64_t));
  std::memcpy(cols, c.data(), n_edges * sizeof(int64_t));
  std::memcpy(vals, v.data(), n_edges * sizeof(float));
  return 0;
}

// ------------------------------------------------------------------- CSR

// row_ptr must have n_rows+1 entries; edges must be row-sorted.
int build_row_ptr(const int64_t* rows, int64_t n_edges, int64_t n_rows,
                  int64_t* row_ptr) {
  std::memset(row_ptr, 0, (n_rows + 1) * sizeof(int64_t));
  for (int64_t i = 0; i < n_edges; ++i) ++row_ptr[rows[i] + 1];
  for (int64_t r = 0; r < n_rows; ++r) row_ptr[r + 1] += row_ptr[r];
  return 0;
}

// Sum duplicate (row, col) entries of a row-col-sorted edge list in place.
// Returns the deduplicated edge count.
int64_t coalesce_sorted(int64_t* rows, int64_t* cols, float* vals,
                        int64_t n_edges) {
  if (n_edges == 0) return 0;
  int64_t w = 0;
  for (int64_t i = 1; i < n_edges; ++i) {
    if (rows[i] == rows[w] && cols[i] == cols[w]) {
      vals[w] += vals[i];
    } else {
      ++w;
      rows[w] = rows[i];
      cols[w] = cols[i];
      vals[w] = vals[i];
    }
  }
  return w + 1;
}

// -------------------------------------------------------------- degrees

int weighted_degrees(const int64_t* rows, const float* vals, int64_t n_edges,
                     int64_t n_rows, double* out_deg) {
  std::memset(out_deg, 0, n_rows * sizeof(double));
  for (int64_t i = 0; i < n_edges; ++i) out_deg[rows[i]] += vals[i];
  return 0;
}

// Scale edge values by d[row]^-1/2 * d[col]^-1/2 (aug-normalization core).
int scale_sym_norm(const int64_t* rows, const int64_t* cols, float* vals,
                   int64_t n_edges, const double* d_inv_sqrt) {
  int n_threads = std::max(1u, std::thread::hardware_concurrency());
  std::vector<std::thread> ts;
  int64_t chunk = (n_edges + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n_edges, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i)
        vals[i] = (float)(vals[i] * d_inv_sqrt[rows[i]] * d_inv_sqrt[cols[i]]);
    });
  }
  for (auto& th : ts) th.join();
  return 0;
}

// ----------------------------------------------------------- communities

// Asynchronous label propagation (Raghavan et al. 2007) over a CSR graph:
// sweep nodes in ascending id; each adopts the most frequent label among
// its neighbors, ties -> smallest label. Fully deterministic (fixed sweep
// order, no RNG) and sequential BY DESIGN: async updates converge in a
// handful of sweeps where parallel-synchronous LPA can oscillate, and a
// parallel-async variant would be timing-nondeterministic. labels must
// arrive initialized (callers use identity). Stops when fewer than
// min_moved_frac * n_nodes labels change in a sweep; returns the number
// of sweeps executed.
//
// Consumed by sgc_tpu_torch/graph/reorder.py::lpa_order.
int lpa_labels(const int64_t* row_ptr, const int64_t* cols, int64_t n_nodes,
               int max_iter, double min_moved_frac, int64_t* labels) {
  if (n_nodes <= 0) return 0;
  // timestamped scratch: count[l] is valid only when stamp[l] == cur,
  // so clearing between nodes is O(1) instead of O(n)
  std::vector<int64_t> count((size_t)n_nodes, 0);
  std::vector<int64_t> stamp((size_t)n_nodes, -1);
  int64_t cur = -1;
  const int64_t quota = (int64_t)(min_moved_frac * (double)n_nodes);
  int sweep = 0;
  while (sweep < max_iter) {
    int64_t moved = 0;
    for (int64_t u = 0; u < n_nodes; ++u) {
      ++cur;
      int64_t best = labels[u];
      int64_t best_count = 0;
      for (int64_t e = row_ptr[u]; e < row_ptr[u + 1]; ++e) {
        const int64_t l = labels[cols[e]];
        if (stamp[l] != cur) {
          stamp[l] = cur;
          count[l] = 0;
        }
        const int64_t c = ++count[l];
        if (c > best_count || (c == best_count && l < best)) {
          best_count = c;
          best = l;
        }
      }
      if (best != labels[u]) {
        labels[u] = best;
        ++moved;
      }
    }
    ++sweep;
    if (moved <= quota) break;
  }
  return sweep;
}

// ------------------------------------------------------------- cell tiling

// Counting-sort edges into the padded per-cell chunk layout consumed by
// the one-hot SpMM formulation (sgc_tpu/ops/spmm_pallas.py tile_graph). Edges arrive in
// (row, col)-sorted order (the SparseGraph invariant); the stable bucket
// walk therefore produces the (cell, row, col) order of the numpy
// lexsort twin — bitwise-identical layout, O(E + cells) instead of
// O(E log E). Padding slots get the cell's base (row, col) with val 0
// (in-range no-ops, same convention as the twin).
//
// cell_start is in CHUNK units; counts is the per-cell true edge count.
// Outputs must be pre-zeroed sized total_chunks * chunk.
int tile_fill(const int64_t* rows, const int64_t* cols, const float* vals,
              int64_t n_edges, const int64_t* cell,
              const int64_t* cell_start, const int64_t* counts,
              int64_t n_cells, int64_t chunk, int64_t n_st,
              int64_t row_block, int64_t stripe,
              int32_t* r_out, int32_t* c_out, float* v_out) {
  if (n_cells <= 0) return 0;
  std::vector<int64_t> fill((size_t)n_cells, 0);
  for (int64_t i = 0; i < n_edges; ++i) {
    const int64_t c = cell[i];
    const int64_t dst = cell_start[c] * chunk + fill[c]++;
    r_out[dst] = (int32_t)rows[i];
    c_out[dst] = (int32_t)cols[i];
    v_out[dst] = vals[i];
  }
  for (int64_t c = 0; c < n_cells; ++c) {
    const int64_t n_pad_slots =
        ((counts[c] + chunk - 1) / chunk) * chunk;  // cell's padded size
    const int32_t pr = (int32_t)((c / n_st) * row_block);
    const int32_t pc = (int32_t)((c % n_st) * stripe);
    const int64_t base = cell_start[c] * chunk;
    for (int64_t s = counts[c]; s < n_pad_slots; ++s) {
      r_out[base + s] = pr;
      c_out[base + s] = pc;
      // v_out already zero
    }
  }
  return 0;
}

// f32 -> bf16 with round-to-nearest-even (matches ml_dtypes .astype);
// NaN payload preserved via the quiet bit.
static inline uint16_t f32_to_bf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return (uint16_t)((u >> 16) | 0x0040);
  return (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

// Fused dense-cell scatter for split_block_dense (ops/spmm_blockdense.py):
// for each (row,col)-sorted edge, map its (row_block, stripe) cell through
// ``compact`` (cell id -> dense slot, -1 = sparse remainder), mark
// ``mask``, and write bf16(value) at the cell-local position in ``cells``
// (pre-zeroed, padded). Duplicate (row,col) runs — adjacent because the
// edges are sorted — are summed in f32 left-to-right before the single
// bf16 round, matching the numpy reduceat fix-up bitwise. Parallel over
// edge ranges; each thread advances its start past a run that began in
// the previous chunk so every duplicate run is owned by exactly one
// thread (deterministic output, no write races).
int cell_scatter_bf16(const int64_t* rows, const int64_t* cols,
                      const float* vals, int64_t n_edges,
                      const int64_t* compact, int64_t n_st,
                      int64_t row_block, int64_t stripe,
                      uint16_t* cells, uint8_t* mask) {
  if (n_edges <= 0) return 0;
  int n_threads = (int)std::max(1u, std::thread::hardware_concurrency());
  if (n_edges < (1 << 20)) n_threads = 1;
  const int64_t chunk = (n_edges + n_threads - 1) / n_threads;
  const int64_t cell_sz = row_block * stripe;
  auto work = [&](int t) {
    int64_t s = (int64_t)t * chunk;
    int64_t e = std::min(n_edges, s + chunk);
    // skip a duplicate run continuing from the previous chunk
    while (s > 0 && s < e && rows[s] == rows[s - 1] && cols[s] == cols[s - 1])
      ++s;
    int64_t i = s;
    while (i < e) {
      int64_t j = i + 1;
      // a run may extend past e into the next chunk; consume it fully
      while (j < n_edges && rows[j] == rows[i] && cols[j] == cols[i]) ++j;
      const int64_t c = (rows[i] / row_block) * n_st + cols[i] / stripe;
      const int64_t k = compact[c];
      if (k >= 0) {
        // seed with the first element (not 0.0f): a single -0.0f edge
        // must keep its sign bit, exactly like the numpy twin's astype
        // (0.0f + -0.0f would round to +0.0 and diverge bitwise)
        float sum = vals[i];
        for (int64_t m = i + 1; m < j; ++m) sum += vals[m];
        cells[k * cell_sz + (rows[i] % row_block) * stripe +
              (cols[i] % stripe)] = f32_to_bf16(sum);
        for (int64_t m = i; m < j; ++m) mask[m] = 1;
      } else {
        for (int64_t m = i; m < j; ++m) mask[m] = 0;
      }
      i = j;
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> ts;
    for (int t = 1; t < n_threads; ++t) ts.emplace_back(work, t);
    work(0);
    for (auto& th : ts) th.join();
  }
  return 0;
}

// ----------------------------------------------------------- partitioning

// Assign row-sorted edges to contiguous row blocks; writes per-part edge
// counts (n_parts entries). rows_per_part fixed by the caller.
int partition_count(const int64_t* rows, int64_t n_edges, int64_t n_parts,
                    int64_t rows_per_part, int64_t* counts) {
  std::memset(counts, 0, n_parts * sizeof(int64_t));
  for (int64_t i = 0; i < n_edges; ++i) {
    int64_t p = rows[i] / rows_per_part;
    if (p >= n_parts) p = n_parts - 1;
    ++counts[p];
  }
  return 0;
}

// Scatter edges into the padded [n_parts, e_max] layout used by
// PartitionedGraph: local rows, global cols, vals; padding pre-filled by
// the caller. Edges must be row-sorted.
int partition_fill(const int64_t* rows, const int64_t* cols,
                   const float* vals, int64_t n_edges, int64_t n_parts,
                   int64_t rows_per_part, int64_t e_max, int32_t* p_rows,
                   int32_t* p_cols, float* p_vals) {
  std::vector<int64_t> cursor(n_parts, 0);
  for (int64_t i = 0; i < n_edges; ++i) {
    int64_t p = rows[i] / rows_per_part;
    if (p >= n_parts) p = n_parts - 1;
    int64_t k = cursor[p]++;
    p_rows[p * e_max + k] = (int32_t)(rows[i] - p * rows_per_part);
    p_cols[p * e_max + k] = (int32_t)cols[i];
    p_vals[p * e_max + k] = vals[i];
  }
  return 0;
}

// Row index of a tiled layout for kernel C (ops/spmm_tiled.py::row_index):
// the edge slots (the first chunk_nnz[k] slots of each chunk k) in (row,
// layout position) order, by a stable counting sort on the row. Writes
// row_ptr[n_rows + 1] and perm[sum(chunk_nnz)]; row ids must lie in
// [0, n_rows).
int slot_row_index(const int32_t* rows, const int32_t* chunk_nnz,
                   int64_t n_chunks, int64_t chunk, int64_t n_rows,
                   int32_t* row_ptr, int32_t* perm) {
  std::vector<int64_t> next((size_t)n_rows + 1, 0);
  for (int64_t k = 0; k < n_chunks; ++k)
    for (int64_t s = k * chunk; s < k * chunk + chunk_nnz[k]; ++s)
      ++next[(size_t)rows[s] + 1];
  for (int64_t r = 0; r < n_rows; ++r) next[r + 1] += next[r];
  for (int64_t r = 0; r <= n_rows; ++r) row_ptr[r] = (int32_t)next[r];
  for (int64_t k = 0; k < n_chunks; ++k)
    for (int64_t s = k * chunk; s < k * chunk + chunk_nnz[k]; ++s)
      perm[next[rows[s]]++] = (int32_t)s;
  return 0;
}

}  // extern "C"
