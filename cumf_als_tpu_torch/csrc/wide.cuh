// Device code of the 256-lane kernels: gather_gram_cg.cu and
// gather_gram_cg_aug.cu (K6, the aug unpack of unpack_aug_tiles) at
// f = 256, gather_gram_cg_wide.cu, fused_gram_cg_cat.cu, the two passes
// of the row cut, wide_span_gram.cu and wide_span_solve.cu (each with an
// aug mode for K6).
//
// One thread block owns one system of FL = 8 * T live lanes out of the
// 256 lanes of a factor row (T = 20, 24, 28 or 32: FL = 160, 192, 224,
// 256). A 256 x 256 f32 A (256 KB) fits neither the registers of the
// 256 threads of common.cuh (an NB = 16 tile is 256 accumulators a
// thread) nor a block's shared memory, so only the upper triangle of A
// is kept, cut into 8 x 8 tiles: tile (ti, tj), ti <= tj, lives in the
// 64 registers of one thread, T (T + 1) / 2 threads in all (528 at
// T = 32, rounded up to whole warps). The Gram sum therefore does about
// half the FMAs of the full square. A diagonal tile holds its full
// 8 x 8 block (both halves come out bit-identical, the products being
// commutative and summed in one order).
//
// A matvec uses every off-diagonal tile twice, as itself for rows
// 8 ti.. and transposed for rows 8 tj..: each thread writes its partial
// 8-vectors into a T x T x 8 table in shared memory (which reuses the
// space of the Gram's staging tile), and FL threads then sum one row of
// that table each, in a fixed order, so a result repeats bit for bit.
// The CG loop is common.cuh's cg_loop, the transcription of
// pallas_solve.py:_cg_loop; the two-block loop _cg_loop_wide is the same
// arithmetic on the leading FL x FL block, with the sums in another
// order.
//
// The row cut (wide_span_gram.cu or wide_span_gram_mma.cu, then
// wide_span_solve.cu). One block a row leaves SMs idle in a chunk with
// fewer rows than the card has SMs (a block holds 64 accumulators in
// each of its 224-544 threads, so few blocks share an SM). So the
// wrappers (ops/cuda_solve.py, `row_spans`) may cut each row's slots into
// spans of L slots, L a whole number of the pass-1 body's tiles. Pass 1
// writes each span's sums into a record in scratch memory (SpanRecord
// below): span_gram runs the tile loop of gather_row over one span in a
// block of its own (a float32 table); wide_span_gram_mma.cu runs the
// span's Gram on the tensor cores (a bf16 table, which takes the two
// passes on every chunk, one span a row where the chunk fills the card).
// A span at or past the row's nnz writes nothing. Pass 2 (span_solve)
// adds a row's live records in span order 0, 1, ... and runs
// solve_and_store. No atomics: a result repeats bit for bit.
#pragma once

#include "common.cuh"

namespace cumf {
namespace wide {

constexpr int kB = 8;         // tile edge
constexpr int kStride = 256;  // lanes of a table, x0 and x row (f_pad)

template <int T>
struct Shape {
  static constexpr int FL = kB * T;
  static constexpr int TILES = T * (T + 1) / 2;
  static constexpr int THREADS = (TILES + 31) / 32 * 32;
};

// Shared-memory workspace of one block (38 KB at T = 32).
template <int T>
struct alignas(16) Smem {
  static constexpr int FL = Shape<T>::FL;
  union {  // first member: 16-byte aligned for the float4 reads of g
    float g[kTile * FL];     // staged rows of the current tile, f32
    float part[T * T * kB];  // per-tile partial matvec results
  };
  float v[kTile];
  int32_t c[kTile];
  float b[FL];
  float x[FL];
  float r[FL];
  float p[FL];
  float ap[FL];
  float red[2];
};

// The tile of this thread; threads past the last tile hold none.
struct Tile {
  int ti, tj;
  bool on;
};

template <int T>
__device__ __forceinline__ Tile tile_of() {
  Tile t;
  int rem = threadIdx.x;
  t.on = rem < Shape<T>::TILES;
  if (!t.on) rem = 0;
  int ti = 0;
  while (rem >= T - ti) {  // row ti of the triangle holds T - ti tiles
    rem -= T - ti;
    ++ti;
  }
  t.ti = ti;
  t.tj = ti + rem;
  return t;
}

// Stage slots [lo, lo + nt) of one row from a kStride-lane table: ids
// and values first, then lanes < FL of the rows they name, widened to
// f32. Lanes >= FL are never read. With AUG (FL = 256) lane 255 of slot
// t gets the slot's value, rounded to the table's dtype first, as
// common.cuh's load_tile does at 128 lanes.
template <int T, typename TT, typename VT, bool AUG = false>
__device__ __forceinline__ void load_tile_table(Smem<T>& s, const TT* table,
                                                const int32_t* cols,
                                                const VT* vals, int lo,
                                                int nt) {
  constexpr int FL = Shape<T>::FL;
  const int tid = threadIdx.x;
  if (tid < nt) {
    s.c[tid] = cols[lo + tid];
    s.v[tid] = to_f32(vals[lo + tid]);
  }
  __syncthreads();
  for (int i = tid; i < nt * FL; i += Shape<T>::THREADS) {
    const int t = i / FL;
    const int j = i - t * FL;
    if (AUG && j == FL - 1)
      s.g[i] = to_f32(from_f32<TT>(s.v[t]));
    else
      s.g[i] = to_f32(table[(int64_t)s.c[t] * kStride + j]);
  }
  __syncthreads();
}

// Stage slots [lo, lo + nt) of one row from an already gathered,
// lane-packed G: g1 holds lanes 0..127 and g2 lanes 128..128 + f2 - 1 of
// each slot; the lanes above are zero. All 256 lanes are staged.
template <typename GT, typename VT>
__device__ __forceinline__ void load_tile_cat(Smem<32>& s, const GT* g1,
                                              const GT* g2, int f2,
                                              const VT* vals, int lo,
                                              int nt) {
  const int tid = threadIdx.x;
  if (tid < nt) s.v[tid] = to_f32(vals[lo + tid]);
  for (int i = tid; i < nt * kStride; i += Shape<32>::THREADS) {
    const int t = i / kStride;
    const int j = i - t * kStride;
    float val = 0.f;
    if (j < 128)
      val = to_f32(g1[(int64_t)(lo + t) * 128 + j]);
    else if (j < 128 + f2)
      val = to_f32(g2[(int64_t)(lo + t) * f2 + (j - 128)]);
    s.g[i] = val;
  }
  __syncthreads();
}

// This thread's tile of A += sum_t g_t g_t^T over the staged tile, and
// b += sum_t v_t g_t (threads tid < FL), r2 += sum_t v_t^2 (thread FL).
template <int T>
__device__ __forceinline__ void accumulate_tile(const Smem<T>& s, int nt,
                                                const Tile& tl,
                                                float (&a)[kB][kB],
                                                float& b_acc,
                                                float& r2_acc) {
  constexpr int FL = Shape<T>::FL;
  const int tid = threadIdx.x;
  if (tl.on) {
    const float* gi_p = s.g + tl.ti * kB;
    const float* gj_p = s.g + tl.tj * kB;
    for (int t = 0; t < nt; ++t) {
      const float4 i0 = *reinterpret_cast<const float4*>(gi_p + t * FL);
      const float4 i1 = *reinterpret_cast<const float4*>(gi_p + t * FL + 4);
      const float4 j0 = *reinterpret_cast<const float4*>(gj_p + t * FL);
      const float4 j1 = *reinterpret_cast<const float4*>(gj_p + t * FL + 4);
      const float gi[kB] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
      const float gj[kB] = {j0.x, j0.y, j0.z, j0.w, j1.x, j1.y, j1.z, j1.w};
#pragma unroll
      for (int k = 0; k < kB; ++k)
#pragma unroll
        for (int l = 0; l < kB; ++l) a[k][l] = fmaf(gi[k], gj[l], a[k][l]);
    }
  }
  if (tid < FL) {
    for (int t = 0; t < nt; ++t) b_acc = fmaf(s.v[t], s.g[t * FL + tid], b_acc);
  } else if (tid == FL) {
    for (int t = 0; t < nt; ++t) r2_acc = fmaf(s.v[t], s.v[t], r2_acc);
  }
}

// out = A v from the triangle of register tiles (see the head of this
// file). Ends in a barrier.
template <int T>
struct TriMatvec {
  const float (&a)[kB][kB];
  const Tile& tl;
  float* part;
  __device__ __forceinline__ void operator()(const float* v,
                                             float* out) const {
    constexpr int FL = Shape<T>::FL;
    const int tid = threadIdx.x;
    if (tl.on) {
      float vj[kB];
#pragma unroll
      for (int l = 0; l < kB; ++l) vj[l] = v[tl.tj * kB + l];
      float* dst = part + (tl.ti * T + tl.tj) * kB;
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        float sum = 0.f;
#pragma unroll
        for (int l = 0; l < kB; ++l) sum = fmaf(a[k][l], vj[l], sum);
        dst[k] = sum;
      }
      if (tl.ti != tl.tj) {
        float vi[kB];
#pragma unroll
        for (int k = 0; k < kB; ++k) vi[k] = v[tl.ti * kB + k];
        float* dtr = part + (tl.tj * T + tl.ti) * kB;
#pragma unroll
        for (int l = 0; l < kB; ++l) {
          float sum = 0.f;
#pragma unroll
          for (int k = 0; k < kB; ++k) sum = fmaf(a[k][l], vi[k], sum);
          dtr[l] = sum;
        }
      }
    }
    __syncthreads();
    if (tid < FL) {
      const float* src = part + (tid >> 3) * T * kB + (tid & 7);
      float sum = 0.f;
      for (int j = 0; j < T; ++j) sum += src[j * kB];
      out[tid] = sum;
    }
    __syncthreads();
  }
};

// Everything after the Gram sum of one row: A += diag I, CG from x0,
// x *= [nnz > 0], x written over all kStride lanes (exact zeros at
// lanes >= FL), and the train-error identity over the live lanes.
template <int T>
__device__ __forceinline__ void solve_and_store(
    Smem<T>& s, const Tile& tl, float (&a)[kB][kB], float b_acc,
    float r2_acc, float nnzf, float lam, const float* x0_row, float* x_row,
    float* se_row, int cg_iters, float cg_tol) {
  constexpr int FL = Shape<T>::FL;
  const int tid = threadIdx.x;
  const float diag = nnzf * lam + (nnzf == 0.f ? 1.f : 0.f);
  if (tl.on && tl.ti == tl.tj) {
#pragma unroll
    for (int k = 0; k < kB; ++k) a[k][k] += diag;
  }
  if (tid < FL) {
    s.b[tid] = b_acc;
    s.x[tid] = x0_row[tid];
  } else if (tid == FL) {
    s.red[1] = r2_acc;
  }
  __syncthreads();
  const float r2 = s.red[1];

  const TriMatvec<T> mv{a, tl, s.part};
  cg_loop<FL>(s.b, s.x, s.r, s.p, s.ap, s.red, mv, cg_iters, cg_tol);

  const float live = nnzf > 0.f ? 1.f : 0.f;
  if (tid < FL) s.x[tid] *= live;
  __syncthreads();
  for (int i = tid; i < kStride; i += Shape<T>::THREADS)
    x_row[i] = i < FL ? s.x[i] : 0.f;

  // train-error identity (cumf_als_tpu/ops/rmse.py, fused_sq_err)
  mv(s.x, s.ap);
  const float cross = dot_n<FL>(s.red, s.x, s.b);
  const float xax = dot_n<FL>(s.red, s.x, s.ap);
  const float xx = dot_n<FL>(s.red, s.x, s.x);
  if (tid == 0) {
    const float se = r2 - 2.f * cross + (xax - diag * xx);
    se_row[0] = se < 0.f ? 0.f : se;  // max(se, 0); NaN stays NaN
  }
}

// This thread's tile of the Gram over slots [lo, hi) of one row,
// gathered from a kStride-lane table, with b and r2 beside it. With AUG
// the values ride lane FL - 1 (load_tile_table), so the tiles hold A'
// and b and r2 beside them are not the row's (unpack_aug_tiles).
template <int T, typename TT, typename VT, bool AUG = false>
__device__ __forceinline__ void gram_slots(Smem<T>& s, const TT* table,
                                           const int32_t* cols,
                                           const VT* vals, int lo, int hi,
                                           const Tile& tl,
                                           float (&a)[kB][kB],
                                           float& b_acc, float& r2_acc) {
  zero_acc<kB>(a);
  b_acc = 0.f;
  r2_acc = 0.f;
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int nt = min(kTile, hi - t0);
    load_tile_table<T, TT, VT, AUG>(s, table, cols, vals, t0, nt);
    accumulate_tile<T>(s, nt, tl, a, b_acc, r2_acc);
    __syncthreads();
  }
}

// The aug unpack on the triangle of tiles (K6 at f = 256, T = 32): A'
// holds the values' lane FL - 1 in its last row and column, which the
// tiles (ti, T - 1) keep as their entries (k, kB - 1). b = that column
// (rows < FL - 1, lane FL - 1 of b zero), r2 = the corner (entry
// (kB - 1, kB - 1) of tile (T - 1, T - 1)); then row and column FL - 1 of
// A are zeroed, so the solve sees A, b and r2 as the split kernels form
// them (pallas_solve.py `_kernel_aug`). b and r2 pass through shared
// memory to the threads that solve_and_store takes them from; one
// barrier.
template <int T>
__device__ __forceinline__ void unpack_aug_tiles(Smem<T>& s, const Tile& tl,
                                                 float (&a)[kB][kB],
                                                 float& b_acc,
                                                 float& r2_acc) {
  constexpr int FL = Shape<T>::FL;
  const int tid = threadIdx.x;
  if (tl.on && tl.tj == T - 1) {
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      s.b[kB * tl.ti + k] = a[k][kB - 1];
      a[k][kB - 1] = 0.f;
    }
    if (tl.ti == T - 1) {
      s.red[1] = s.b[FL - 1];  // the corner, written just above
      s.b[FL - 1] = 0.f;
#pragma unroll
      for (int l = 0; l < kB; ++l) a[kB - 1][l] = 0.f;
    }
  }
  __syncthreads();
  // solve_and_store writes these back to the same places from the same
  // threads, so no second barrier is needed
  if (tid < FL)
    b_acc = s.b[tid];
  else if (tid == FL)
    r2_acc = s.red[1];
}

// One row, gathered from a kStride-lane table: Gram over slots [0, n),
// then solve_and_store. The body of gather_gram_cg at f = 256 (T = 32),
// with AUG of gather_gram_cg(aug=True) at f = 256, and of
// gather_gram_cg_wide.
template <int T, typename TT, typename VT, bool AUG = false>
__device__ __forceinline__ void gather_row(
    Smem<T>& s, const TT* table, const int32_t* cols, const VT* vals, int n,
    float nnzf, float lam, const float* x0_row, float* x_row, float* se_row,
    int cg_iters, float cg_tol) {
  const Tile tl = tile_of<T>();
  float a[kB][kB];
  float b_acc, r2_acc;
  gram_slots<T, TT, VT, AUG>(s, table, cols, vals, 0, n, tl, a, b_acc,
                             r2_acc);
  if constexpr (AUG) unpack_aug_tiles<T>(s, tl, a, b_acc, r2_acc);
  solve_and_store<T>(s, tl, a, b_acc, r2_acc, nnzf, lam, x0_row, x_row,
                     se_row, cg_iters, cg_tol);
}

// Index of tile (ti, tj), ti <= tj, in the row-major order of the upper
// triangle of T tiles a side (the order of tile_of).
template <int T>
__host__ __device__ __forceinline__ int tile_index(int ti, int tj) {
  return ti * T - ti * (ti - 1) / 2 + (tj - ti);
}

// The scratch record of one span, in floats: tile i's 64 entries at
// [i * 64 + k * 8 + l] (entry (k, l) of the tile: row 8 ti + k, column
// 8 tj + l), then b (FL floats) at B, then r2 at R2; the size is rounded
// up to 64 floats, so every record and every tile starts on a 256-byte
// boundary. Tile-major, so that one warp of the tensor-core pass 1
// stores a whole tile (256 contiguous bytes) at once: its lane t holds
// entries 2 t and 2 t + 1 of the tile in the wgmma fragment.
template <int T>
struct SpanRecord {
  static constexpr int B = kB * kB * Shape<T>::TILES;
  static constexpr int R2 = B + Shape<T>::FL;
  static constexpr int SIZE = (R2 + 1 + 63) / 64 * 64;  // 34,112 at T = 32
};

// Pass 1 of the row cut on the FMA body: the Gram over slots [lo, hi) of
// one row into its record (thread tid writes tile tid, 64 contiguous
// floats). With AUG (K6, FL = 256) the tiles hold the span's A', the
// values in lane FL - 1; pass 2 reads b and r2 from them, not from the
// record's own b and r2.
template <int T, typename TT, typename VT, bool AUG = false>
__device__ __forceinline__ void span_gram(Smem<T>& s, const TT* table,
                                          const int32_t* cols,
                                          const VT* vals, int lo, int hi,
                                          float* rec) {
  using Rec = SpanRecord<T>;
  constexpr int FL = Shape<T>::FL;
  const int tid = threadIdx.x;
  const Tile tl = tile_of<T>();
  float a[kB][kB];
  float b_acc, r2_acc;
  gram_slots<T, TT, VT, AUG>(s, table, cols, vals, lo, hi, tl, a, b_acc,
                             r2_acc);
  if (tl.on) {
    float4* dst = reinterpret_cast<float4*>(rec + tid * kB * kB);
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      dst[2 * k] = make_float4(a[k][0], a[k][1], a[k][2], a[k][3]);
      dst[2 * k + 1] = make_float4(a[k][4], a[k][5], a[k][6], a[k][7]);
    }
  }
  if (tid < FL)
    rec[Rec::B + tid] = b_acc;
  else if (tid == FL)
    rec[Rec::R2] = r2_acc;
}

// Pass 2 of the row cut: the sums of a row's `live` records (spans 0 ..
// live - 1, in that order), then solve_and_store. A row without slots
// has no live record and solves A = 0, b = 0, r2 = 0 as gather_row does.
// With AUG (K6, FL = 256) the records hold A' alone: b and r2 come from
// its summed last column (unpack_aug_tiles).
template <int T, bool AUG = false>
__device__ __forceinline__ void span_solve(
    Smem<T>& s, const float* recs, int live, float nnzf, float lam,
    const float* x0_row, float* x_row, float* se_row, int cg_iters,
    float cg_tol) {
  using Rec = SpanRecord<T>;
  constexpr int FL = Shape<T>::FL;
  const int tid = threadIdx.x;
  const Tile tl = tile_of<T>();
  float a[kB][kB];
  zero_acc<kB>(a);
  float b_acc = 0.f, r2_acc = 0.f;
  for (int sp = 0; sp < live; ++sp) {
    const float* rec = recs + (int64_t)sp * Rec::SIZE;
    if (tl.on) {
      const float4* src = reinterpret_cast<const float4*>(rec + tid * kB * kB);
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        const float4 u = src[2 * k], w = src[2 * k + 1];
        a[k][0] += u.x; a[k][1] += u.y; a[k][2] += u.z; a[k][3] += u.w;
        a[k][4] += w.x; a[k][5] += w.y; a[k][6] += w.z; a[k][7] += w.w;
      }
    }
    if (AUG)
      continue;
    if (tid < FL)
      b_acc += rec[Rec::B + tid];
    else if (tid == FL)
      r2_acc += rec[Rec::R2];
  }
  if constexpr (AUG) unpack_aug_tiles<T>(s, tl, a, b_acc, r2_acc);
  solve_and_store<T>(s, tl, a, b_acc, r2_acc, nnzf, lam, x0_row, x_row,
                     se_row, cg_iters, cg_tol);
}

}  // namespace wide
}  // namespace cumf
