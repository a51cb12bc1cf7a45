// Native data plane for cumf_als_tpu.
//
// The reference keeps its host-side runtime in C++ (binary loaders,
// reference host_utilities.cpp:19-97; pinned-memory staging, main.cpp:50-69).
// The TPU framework's host runtime work is different — the expensive parts
// are the CSR<->CSC transpose at hugewiki-scale nnz (int64-safe counting
// sort; the reference worries about the same overflow, hugewiki.cu:2299)
// and materializing padded bucket chunks (the layout consumed by the MXU
// Gram kernels). Both are implemented here, cache-friendly and bound via
// ctypes (no pybind11 in this image).
//
// Build: make -C cumf_als_tpu/native   (produces libdataplane.so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// CSR -> CSR-of-transpose (i.e. CSC arrays of the original matrix).
// indptr_in: (m+1) int64, indices_in: (nnz) int32, data_in: (nnz) float.
// Outputs: indptr_out (n+1) int64, indices_out (nnz) int32 (row ids),
// data_out (nnz) float, with column-major (row-id-sorted) order inside
// each output row, matching scipy's .T.tocsr().sort_indices().
int csr_transpose(int64_t m, int64_t n, int64_t nnz,
                  const int64_t* indptr_in, const int32_t* indices_in,
                  const float* data_in, int64_t* indptr_out,
                  int32_t* indices_out, float* data_out) {
  std::vector<int64_t> count(n + 1, 0);
  for (int64_t k = 0; k < nnz; ++k) {
    int32_t c = indices_in[k];
    if (c < 0 || c >= n) return -1;
    ++count[c + 1];
  }
  indptr_out[0] = 0;
  for (int64_t c = 0; c < n; ++c) indptr_out[c + 1] = indptr_out[c] + count[c + 1];
  std::vector<int64_t> cursor(indptr_out, indptr_out + n);
  // walk rows in order: within each output row, source rows appear sorted
  for (int64_t r = 0; r < m; ++r) {
    for (int64_t k = indptr_in[r]; k < indptr_in[r + 1]; ++k) {
      int32_t c = indices_in[k];
      int64_t dst = cursor[c]++;
      indices_out[dst] = static_cast<int32_t>(r);
      data_out[dst] = data_in[k];
    }
  }
  return 0;
}

// COO -> CSR with per-row column-sorted order (two-pass counting sort by
// row, then an in-row sort by column via a second counting pass is not
// needed if we sort keys; we do a stable two-key counting sort:
// first by col, then by row).
int coo_to_csr(int64_t m, int64_t n, int64_t nnz, const int32_t* row,
               const int32_t* col, const float* data, int64_t* indptr_out,
               int32_t* indices_out, float* data_out) {
  // pass 1: stable counting sort by column into scratch
  std::vector<int64_t> ccount(n + 1, 0);
  for (int64_t k = 0; k < nnz; ++k) {
    if (col[k] < 0 || col[k] >= n || row[k] < 0 || row[k] >= m) return -1;
    ++ccount[col[k] + 1];
  }
  for (int64_t c = 0; c < n; ++c) ccount[c + 1] += ccount[c];
  std::vector<int32_t> srow(nnz), scol(nnz);
  std::vector<float> sdat(nnz);
  {
    std::vector<int64_t> cur(ccount.begin(), ccount.end() - 1);
    for (int64_t k = 0; k < nnz; ++k) {
      int64_t dst = cur[col[k]]++;
      srow[dst] = row[k];
      scol[dst] = col[k];
      sdat[dst] = data[k];
    }
  }
  // pass 2: stable counting sort by row -> final (row-major, col-sorted)
  std::vector<int64_t> rcount(m + 1, 0);
  for (int64_t k = 0; k < nnz; ++k) ++rcount[srow[k] + 1];
  indptr_out[0] = 0;
  for (int64_t r = 0; r < m; ++r) indptr_out[r + 1] = indptr_out[r] + rcount[r + 1];
  std::vector<int64_t> cur(indptr_out, indptr_out + m);
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t dst = cur[srow[k]]++;
    indices_out[dst] = scol[k];
    data_out[dst] = sdat[k];
  }
  return 0;
}

// Materialize one padded bucket chunk (the layout of ops/tiling.py):
// for each listed row, copy its column ids / values into a (R, width)
// padded matrix; cols padded with pad_col, vals with 0.
int materialize_chunk(const int64_t* indptr, const int32_t* indices,
                      const float* data, const int32_t* rows, int64_t r,
                      int64_t width, int32_t pad_col, int32_t pad_row,
                      int64_t num_rows, int32_t* rows_out,
                      int32_t* nnz_out, int32_t* cols_out,
                      float* vals_out) {
  for (int64_t i = 0; i < r; ++i) {
    int32_t* crow = cols_out + i * width;
    float* vrow = vals_out + i * width;
    int32_t rid = rows[i];
    if (rid < 0 || rid >= num_rows) {  // dummy tail row
      rows_out[i] = pad_row;
      nnz_out[i] = 0;
      for (int64_t p = 0; p < width; ++p) crow[p] = pad_col;
      std::memset(vrow, 0, width * sizeof(float));
      continue;
    }
    int64_t lo = indptr[rid], hi = indptr[rid + 1];
    int64_t k = hi - lo;
    if (k > width) return -1;
    rows_out[i] = rid;
    nnz_out[i] = static_cast<int32_t>(k);
    std::memcpy(crow, indices + lo, k * sizeof(int32_t));
    std::memcpy(vrow, data + lo, k * sizeof(float));
    for (int64_t p = k; p < width; ++p) crow[p] = pad_col;
    std::memset(vrow + k, 0, (width - k) * sizeof(float));
  }
  return 0;
}

// Materialize one padded *panel* chunk (ops/tiling.PanelChunk layout):
// subrows are (offset, length) runs of the flat nonzero arrays; columns
// are rebased to panel-local ids (col - base). Rows beyond k are dummy
// tails. This is the hot inner loop of build_panel_plan — one linear
// pass instead of numpy fancy-indexing temporaries.
int materialize_subrows(const int32_t* indices, const float* data,
                        const int64_t* sub_off, const int32_t* sub_len,
                        const int32_t* sub_rows, int64_t k, int64_t r_pad,
                        int64_t width, int32_t base, int32_t pad_col,
                        int32_t pad_row, int32_t* rows_out,
                        int32_t* nnz_out, int32_t* cols_out,
                        float* vals_out) {
  for (int64_t i = 0; i < r_pad; ++i) {
    int32_t* crow = cols_out + i * width;
    float* vrow = vals_out + i * width;
    if (i >= k) {  // dummy tail row
      rows_out[i] = pad_row;
      nnz_out[i] = 0;
      for (int64_t p = 0; p < width; ++p) crow[p] = pad_col;
      std::memset(vrow, 0, width * sizeof(float));
      continue;
    }
    int64_t off = sub_off[i];
    int64_t len = sub_len[i];
    if (len > width) return -1;
    rows_out[i] = sub_rows[i];
    nnz_out[i] = static_cast<int32_t>(len);
    for (int64_t p = 0; p < len; ++p) crow[p] = indices[off + p] - base;
    std::memcpy(vrow, data + off, len * sizeof(float));
    for (int64_t p = len; p < width; ++p) crow[p] = pad_col;
    std::memset(vrow + len, 0, (width - len) * sizeof(float));
  }
  return 0;
}

// Expand indptr to per-nonzero row ids (R_train_coo.row contract,
// reference main.cpp:103).
int expand_indptr(int64_t m, const int64_t* indptr, int32_t* rows_out) {
  for (int64_t r = 0; r < m; ++r) {
    for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k)
      rows_out[k] = static_cast<int32_t>(r);
  }
  return 0;
}

// Squared-sum of a float array in double precision (for sum r^2).
double sum_squares(const float* x, int64_t n) {
  double acc = 0.0;
  for (int64_t k = 0; k < n; ++k) acc += static_cast<double>(x[k]) * x[k];
  return acc;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Synthetic workload generator (hugewiki scale).
//
// The Python generator (data/synthetic.py) tops out around 1e8 nonzeros
// on this single-core host (searchsorted sampling + np.unique sorts of
// int64 key arrays); the full hugewiki workload is 3.1e9 nonzeros
// (reference hugewiki/hugewiki.cu:33-36). This native path makes that
// size practical: Walker alias sampling (O(1)/draw), LSD radix sort on
// the flat keys, in-place dedup, and a single fused pass that computes
// planted-model ratings, splits train/test by key hash, and emits the
// train CSR + test COO directly (keys are sorted, so the CSR needs no
// extra sort and the u-factor reads are sequential).
// ---------------------------------------------------------------------------

static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

namespace {

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  uint64_t next() { return s = splitmix64(s); }
  double uniform() { return (next() >> 11) * 0x1.0p-53; }
};

// Walker alias table over arbitrary positive weights.
struct Alias {
  std::vector<double> prob;
  std::vector<int64_t> alias;
  void build(const double* w, int64_t n) {
    prob.resize(n);
    alias.resize(n);
    double total = 0.0;
    for (int64_t i = 0; i < n; ++i) total += w[i];
    std::vector<double> p(n);
    std::vector<int64_t> small, large;
    small.reserve(n);
    large.reserve(n);
    for (int64_t i = 0; i < n; ++i) {
      p[i] = w[i] * n / total;
      (p[i] < 1.0 ? small : large).push_back(i);
    }
    while (!small.empty() && !large.empty()) {
      int64_t s = small.back(); small.pop_back();
      int64_t l = large.back(); large.pop_back();
      prob[s] = p[s];
      alias[s] = l;
      p[l] = (p[l] + p[s]) - 1.0;
      (p[l] < 1.0 ? small : large).push_back(l);
    }
    for (int64_t i : small) { prob[i] = 1.0; alias[i] = i; }
    for (int64_t i : large) { prob[i] = 1.0; alias[i] = i; }
  }
  int64_t draw(Rng& rng) const {
    int64_t n = static_cast<int64_t>(prob.size());
    // rejection-free: uniform slot + biased coin
    int64_t i = static_cast<int64_t>(rng.next() % static_cast<uint64_t>(n));
    return rng.uniform() < prob[i] ? i : alias[i];
  }
};

// LSD radix sort of int64 keys (all non-negative), using only as many
// byte passes as the maximum key needs. buf is caller scratch (size n).
void radix_sort_keys(int64_t* keys, int64_t* buf, int64_t n,
                     int64_t max_key) {
  int passes = 0;
  uint64_t mk = static_cast<uint64_t>(max_key);
  while (mk) { ++passes; mk >>= 8; }
  if (passes == 0) return;
  int64_t* src = keys;
  int64_t* dst = buf;
  for (int p = 0; p < passes; ++p) {
    int64_t count[257] = {0};
    int shift = 8 * p;
    for (int64_t i = 0; i < n; ++i)
      ++count[((static_cast<uint64_t>(src[i]) >> shift) & 0xff) + 1];
    for (int b = 0; b < 256; ++b) count[b + 1] += count[b];
    for (int64_t i = 0; i < n; ++i)
      dst[count[(static_cast<uint64_t>(src[i]) >> shift) & 0xff]++] = src[i];
    std::swap(src, dst);
  }
  if (src != keys) std::memcpy(keys, src, n * sizeof(int64_t));
}

}  // namespace

extern "C" {

// Sample up to `total` UNIQUE flat keys r*n+c (row ~ alias(row_w),
// col ~ alias(col_w)) into keys_out (capacity cap >= total), sorted
// ascending. Retries a few oversampling rounds for heavy-duplication
// regimes. Returns the achieved unique count.
int64_t synth_sample_keys(int64_t m, int64_t n, int64_t total,
                          const double* row_w, const double* col_w,
                          uint64_t seed, int64_t cap, int64_t* keys_out) {
  if (total > cap) return -1;
  Alias rows, cols;
  rows.build(row_w, m);
  cols.build(col_w, n);
  Rng rng(seed * 2654435761ull + 1);
  std::vector<int64_t> scratch(static_cast<size_t>(cap));
  int64_t k = 0;  // current unique prefix (sorted)
  for (int round = 0; round < 8 && k < total; ++round) {
    int64_t want = (round == 0) ? (total + total / 8 + 16)
                                : (total - k) * 2 + 16;
    if (want > cap - k) want = cap - k;
    if (want <= 0) break;
    for (int64_t i = 0; i < want; ++i) {
      int64_t r = rows.draw(rng);
      int64_t c = cols.draw(rng);
      keys_out[k + i] = r * n + c;
    }
    radix_sort_keys(keys_out, scratch.data(), k + want, m * n - 1);
    // in-place unique over the sorted whole
    int64_t w = 0;
    for (int64_t i = 0; i < k + want; ++i)
      if (w == 0 || keys_out[i] != keys_out[w - 1]) keys_out[w++] = keys_out[i];
    k = w;
  }
  // Return the full unique count (may exceed `total` after the
  // oversampling round); the caller thins to the target with the
  // keep-hash threshold — truncating the sorted array would bias
  // toward low keys.
  return k;
}

// Count the train/test split of `keys` under hash thinning: a key is
// kept when h1 < keep_t, and a kept key is a TEST entry when
// h2 < test_t. Writes [n_train, n_test] to out_counts.
int synth_counts(const int64_t* keys, int64_t k, uint64_t seed,
                 uint64_t keep_t, uint64_t test_t, int64_t* out_counts) {
  int64_t tr = 0, te = 0;
  for (int64_t i = 0; i < k; ++i) {
    uint64_t key = static_cast<uint64_t>(keys[i]);
    if (splitmix64(key ^ seed) >= keep_t) continue;
    if (splitmix64(key ^ (seed + 0x5851f42d4c957f2dull)) < test_t) ++te;
    else ++tr;
  }
  out_counts[0] = tr;
  out_counts[1] = te;
  return 0;
}

// One fused pass over the sorted keys: planted-model rating
// val = round2(clip(mid + half*(u_row . v_col + noise*gauss)/2, lo, hi)),
// split by the same hashes as synth_counts, emit train CSR (indptr,
// cols, vals — keys sorted => rows ascending, cols sorted within rows,
// u reads sequential) and test COO. Arrays sized per synth_counts.
int synth_emit(const int64_t* keys, int64_t k, int64_t m, int64_t n,
               const float* u, const float* v, int64_t rank, float noise,
               float lo, float hi, uint64_t seed, uint64_t keep_t,
               uint64_t test_t, int64_t* train_indptr, int32_t* train_cols,
               float* train_vals, int32_t* test_row, int32_t* test_col,
               float* test_vals) {
  Rng rng(seed ^ 0xa0761d6478bd642full);
  const float mid = (hi + lo) * 0.5f, half = (hi - lo) * 0.5f;
  int64_t tr = 0, te = 0;
  for (int64_t r = 0; r <= m; ++r) train_indptr[r] = 0;
  double spare = 0.0;
  bool has_spare = false;
  for (int64_t i = 0; i < k; ++i) {
    uint64_t key = static_cast<uint64_t>(keys[i]);
    if (splitmix64(key ^ seed) >= keep_t) continue;
    int64_t row = keys[i] / n, col = keys[i] - row * n;
    const float* ur = u + row * rank;
    const float* vc = v + col * rank;
    float dot = 0.f;
    for (int64_t j = 0; j < rank; ++j) dot += ur[j] * vc[j];
    // Box-Muller gaussian noise
    double g;
    if (has_spare) { g = spare; has_spare = false; }
    else {
      double u1 = rng.uniform(), u2 = rng.uniform();
      if (u1 < 1e-300) u1 = 1e-300;
      double rr = std::sqrt(-2.0 * std::log(u1));
      g = rr * std::cos(6.283185307179586 * u2);
      spare = rr * std::sin(6.283185307179586 * u2);
      has_spare = true;
    }
    float raw = dot + noise * static_cast<float>(g);
    float val = mid + half * raw * 0.5f;
    if (val < lo) val = lo;
    if (val > hi) val = hi;
    val = std::round(val * 2.0f) * 0.5f;
    if (splitmix64(key ^ (seed + 0x5851f42d4c957f2dull)) < test_t) {
      test_row[te] = static_cast<int32_t>(row);
      test_col[te] = static_cast<int32_t>(col);
      test_vals[te] = val;
      ++te;
    } else {
      train_cols[tr] = static_cast<int32_t>(col);
      train_vals[tr] = val;
      ++train_indptr[row + 1];
      ++tr;
    }
  }
  for (int64_t r = 0; r < m; ++r) train_indptr[r + 1] += train_indptr[r];
  return 0;
}

}  // extern "C"
