// Shared device code of the ALS kernels at f <= 128: the split-buffer
// forms gather_gram_cg.cu and gather_gram_out.cu and the augmented-lane
// forms gather_gram_cg_aug.cu and gather_gram_aug_out.cu (their FMA
// bodies: K1 and K6 on a float32 table, each of the four at f < 128).
// K2 and K5a dispatch through CUMF_DISPATCH_NB as K1 and K6 do, but
// their f = 128 takes a tensor-core body on either table before it: no
// route of the port runs them below 128 (f_pad >= 128), and the small-f
// card tests of tests/test_torch_cuda.py hold their FMA body there. The
// CG loop and the dot product here also serve the 256-lane kernels of
// wide.cuh (the solves K3, K4 and K5b have their own, in bulk_cg.cuh).
//
// One thread block owns one f x f system, f = 16 * NB with NB in 1..8
// (f a multiple of 16, at most 128). The 256 threads form a 16 x 16
// grid: thread (ty, tx) keeps A[ty + 16k][tx*NB + l] for k, l < NB in
// registers, so A never touches shared memory. The Gram sum, the
// regularizer add, the CG matvecs and the train-error quadratic form all
// read those registers.
//
// The CG loop reproduces cumf_als_tpu/ops/pallas_solve.py:_cg_loop for a
// single system: warm start, at most cg_iters steps, x and r updated
// with this step's alpha BEFORE the tolerance test, alpha = 0 when
// p.Ap == 0, beta guarded by rsold <= 0. A block holds one system, so the
// per-system freeze of the Pallas loop is a `break` here: the frozen
// iterations of the Pallas loop change nothing, so results are the same.
//
// The augmented-lane layout (pallas_solve.py:_kernel_aug): the true
// factor width is at most f - 1, so lane f - 1 of every table row is
// zero and carries the slot's rating value instead. One Gram A' over all
// f lanes then holds A (rows and columns < f - 1), b (row and column
// f - 1) and sum v^2 (the corner), and no separate b or r2 sums run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cumf {

constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kTile = 32;      // rating slots gathered per shared tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

// Shared-memory workspace of one block.
template <int NB>
struct Smem {
  static constexpr int F = 16 * NB;
  float g[kTile * F];  // gathered table rows of the current tile, f32
  float v[kTile];      // rating values of the current tile, f32
  int32_t c[kTile];    // gather ids of the current tile
  float b[F];
  float x[F];
  float r[F];
  float p[F];
  float ap[F];
  float red[2];
};

template <int NB>
__device__ __forceinline__ void zero_acc(float (&a)[NB][NB]) {
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int l = 0; l < NB; ++l) a[k][l] = 0.f;
}

// Stage slots [lo, lo + nt) of one row: ids and values first, then the
// table rows they name, widened to f32. With AUG, lane F - 1 of slot t
// gets the slot's value in place of the table's (zero) entry, rounded to
// the table's storage dtype first (as `(vals * mask).astype(g.dtype)`
// does): a bf16 table stores 3.3 as bf16(3.3), and b and sum v^2 of the
// augmented form come from that stored value.
template <int NB, bool AUG, typename TT, typename VT>
__device__ __forceinline__ void load_tile(Smem<NB>& s, const TT* table,
                                          const int32_t* cols,
                                          const VT* vals, int lo, int nt) {
  constexpr int F = 16 * NB;
  const int tid = threadIdx.x;
  if (tid < nt) {
    s.c[tid] = cols[lo + tid];
    s.v[tid] = to_f32(vals[lo + tid]);
  }
  __syncthreads();
  for (int i = tid; i < nt * F; i += kThreads) {
    const int t = i / F;
    const int j = i - t * F;
    if (AUG && j == F - 1)
      s.g[i] = to_f32(from_f32<TT>(s.v[t]));
    else
      s.g[i] = to_f32(table[(int64_t)s.c[t] * F + j]);
  }
  __syncthreads();
}

// A += sum_t g_t g_t^T over the staged tile (register tile of this
// thread) and, unless AUG (where the Gram itself carries them),
// b += sum_t v_t g_t (threads tid < F), r2 += sum_t v_t^2 (thread F);
// b and r2 sum the tile apart first, so that a long row's f32 sums
// round per tile, not per slot.
template <int NB, bool AUG>
__device__ __forceinline__ void accumulate_tile(const Smem<NB>& s, int nt,
                                                float (&a)[NB][NB],
                                                float& b_acc,
                                                float& r2_acc) {
  constexpr int F = 16 * NB;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  for (int t = 0; t < nt; ++t) {
    const float* g = s.g + t * F;
    float gi[NB], gj[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) gi[k] = g[ty + 16 * k];
#pragma unroll
    for (int l = 0; l < NB; ++l) gj[l] = g[tx * NB + l];
#pragma unroll
    for (int k = 0; k < NB; ++k)
#pragma unroll
      for (int l = 0; l < NB; ++l) a[k][l] = fmaf(gi[k], gj[l], a[k][l]);
  }
  if constexpr (AUG) return;
  float sum = 0.f;
  if (tid < F) {
    for (int t = 0; t < nt; ++t) sum = fmaf(s.v[t], s.g[t * F + tid], sum);
    b_acc += sum;
  } else if (tid == F) {
    for (int t = 0; t < nt; ++t) sum = fmaf(s.v[t], s.v[t], sum);
    r2_acc += sum;
  }
}

// Tiles whose b and r2 gram_row sums apart before adding them to the
// row's: three levels of f32 sums (a tile, a group, the row), so that
// the rounding of b over P = 2^18 slots stays near 1e-6 of b, where one
// running sum reaches 3e-5.
constexpr int kTilesPerGroup = 64;

// Gather + Gram over slots [0, n) of one row. With AUG, b_acc and r2_acc
// stay untouched.
template <int NB, bool AUG, typename TT, typename VT>
__device__ __forceinline__ void gram_row(Smem<NB>& s, const TT* table,
                                         const int32_t* cols, const VT* vals,
                                         int n, float (&a)[NB][NB],
                                         float& b_acc, float& r2_acc) {
  float b_group = 0.f, r2_group = 0.f;
  int tiles = 0;
  for (int lo = 0; lo < n; lo += kTile) {
    const int nt = min(kTile, n - lo);
    load_tile<NB, AUG>(s, table, cols, vals, lo, nt);
    accumulate_tile<NB, AUG>(s, nt, a, b_group, r2_group);
    __syncthreads();
    if (++tiles == kTilesPerGroup) {
      b_acc += b_group;
      r2_acc += r2_group;
      b_group = r2_group = 0.f;
      tiles = 0;
    }
  }
  b_acc += b_group;
  r2_acc += r2_group;
}

// Unpack an augmented A' held in registers: row F - 1 goes to s.b (lanes
// < F - 1; s.b[F - 1] = 0, not sum v^2), the corner (sum v^2) to
// s.red[1], and only then row and column F - 1 are zeroed in the
// registers. Row F - 1 lives in the 16 threads with ty == 15 (k ==
// NB - 1), the corner in the one with tx == 15 (l == NB - 1). The caller
// synchronizes before reading s.b or s.red[1].
template <int NB>
__device__ __forceinline__ void unpack_aug(Smem<NB>& s, float (&a)[NB][NB]) {
  constexpr int F = 16 * NB;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  if (ty == 15) {
#pragma unroll
    for (int l = 0; l < NB; ++l) {
      const int col = tx * NB + l;
      if (col < F - 1) {
        s.b[col] = a[NB - 1][l];
      } else {
        s.b[col] = 0.f;
        s.red[1] = a[NB - 1][l];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int l = 0; l < NB; ++l)
      if (ty + 16 * k == F - 1 || tx * NB + l == F - 1) a[k][l] = 0.f;
}

template <int NB>
__device__ __forceinline__ void add_diag(float (&a)[NB][NB], float d) {
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int l = 0; l < NB; ++l)
      if (ty + 16 * k == tx * NB + l) a[k][l] += d;
}

// out = A v. Row sums of the register tile, then a butterfly over the 16
// threads that share a row (tx is the low 4 bits of the lane id).
template <int NB>
__device__ __forceinline__ void matvec(const float (&a)[NB][NB],
                                       const float* v, float* out) {
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  float vj[NB];
#pragma unroll
  for (int l = 0; l < NB; ++l) vj[l] = v[tx * NB + l];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    float sum = 0.f;
#pragma unroll
    for (int l = 0; l < NB; ++l) sum = fmaf(a[k][l], vj[l], sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    if (tx == 0) out[ty + 16 * k] = sum;
  }
  __syncthreads();
}

// u . v over F entries, computed by warp 0 and returned to every thread
// of the block; red is one float of shared scratch.
template <int F>
__device__ __forceinline__ float dot_n(float* red, const float* u,
                                       const float* v) {
  if (threadIdx.x < 32) {
    float sum = 0.f;
    for (int i = threadIdx.x; i < F; i += 32) sum = fmaf(u[i], v[i], sum);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (threadIdx.x == 0) red[0] = sum;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

template <int NB>
__device__ __forceinline__ float dot(Smem<NB>& s, const float* u,
                                     const float* v) {
  return dot_n<16 * NB>(s.red, u, v);
}

// CG on one F x F system from the warm start in x, right-hand side b;
// r, p, ap are F floats of shared scratch each, red one float. mv(v, out)
// writes out = A v for the whole block and ends in a barrier. Leaves the
// solution in x.
template <int F, typename MatVec>
__device__ __forceinline__ void cg_loop(const float* b, float* x, float* r,
                                        float* p, float* ap, float* red,
                                        const MatVec& mv, int cg_iters,
                                        float cg_tol) {
  const int tid = threadIdx.x;
  mv(x, ap);
  if (tid < F) {
    const float ri = b[tid] - ap[tid];
    r[tid] = ri;
    p[tid] = ri;
  }
  __syncthreads();
  float rsold = dot_n<F>(red, r, r);
  for (int it = 0; it < cg_iters; ++it) {
    mv(p, ap);
    const float pap = dot_n<F>(red, p, ap);
    // the Pallas guard, literally: a zero p.Ap gives alpha 0, a NaN one
    // gives NaN (so a NaN system stays NaN)
    const float nonzero = fabsf(pap) > 0.f ? 1.f : 0.f;
    const float alpha = nonzero * rsold / (pap + (1.f - nonzero));
    if (tid < F) {
      x[tid] = x[tid] + alpha * p[tid];
      r[tid] = r[tid] - alpha * ap[tid];
    }
    __syncthreads();
    const float rsnew = dot_n<F>(red, r, r);
    if (!(rsnew >= cg_tol)) break;  // per-system exit, after the update
    const float beta = rsnew / (rsold + (rsold <= 0.f ? 1.f : 0.f));
    if (tid < F) p[tid] = r[tid] + beta * p[tid];
    __syncthreads();
    rsold = rsnew;
  }
}

// The register-resident A of this file as cg_loop's matvec.
template <int NB>
struct RegMatvec {
  const float (&a)[NB][NB];
  __device__ __forceinline__ void operator()(const float* v,
                                             float* out) const {
    matvec<NB>(a, v, out);
  }
};

// CG on the register-resident A from the warm start in s.x, right-hand
// side s.b. Leaves the solution in s.x.
template <int NB>
__device__ __forceinline__ void cg(Smem<NB>& s, const float (&a)[NB][NB],
                                   int cg_iters, float cg_tol) {
  const RegMatvec<NB> mv{a};
  cg_loop<16 * NB>(s.b, s.x, s.r, s.p, s.ap, s.red, mv, cg_iters, cg_tol);
}

}  // namespace cumf

// Instantiate LAUNCH(NB) for the block's f = 16 * NB, or fail on any
// other f.
#define CUMF_DISPATCH_NB(f, LAUNCH)         \
  switch (f) {                              \
    case 16: LAUNCH(1); break;              \
    case 32: LAUNCH(2); break;              \
    case 48: LAUNCH(3); break;              \
    case 64: LAUNCH(4); break;              \
    case 80: LAUNCH(5); break;              \
    case 96: LAUNCH(6); break;              \
    case 112: LAUNCH(7); break;             \
    case 128: LAUNCH(8); break;             \
    default: return (int)cudaErrorInvalidValue; \
  }
