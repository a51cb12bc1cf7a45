// The batched CG of one solve launch on Hopper: persistent blocks that
// walk the systems, each system's A (and its b and x0) brought into a
// ring of two shared-memory stages by bulk-async copies, and a CG step
// with two block-wide barriers. The body of solve_cg_reg.cu (K3); K4
// and K5b keep common.cuh's one-block-a-system CG.
//
// The ring. One thread starts a stage's copies (cp.async.bulk, one 1-D
// copy each for A, b and x0, all contiguous and 16-byte aligned) and
// they complete on the stage's mbarrier, so system i + 1's A is in
// flight while system i's CG runs. A block's system i lives in stage
// i % 2; its copies start once the block's first barrier of system
// i - 2 has passed, which every thread reaches only after it has copied
// its tile of that stage into registers.
//
// The layout. As common.cuh: thread (ty, tx) of the 16 x 16 grid keeps
// A[ty + 16k][tx NB + l] (k, l < NB) in registers, with the diagonal
// added as it copies the tile out of the stage. A matvec sums each
// thread's NB columns for its NB rows and reduces the 16 threads of a
// row group by a transposing butterfly (8 shuffles, not 4 NB): at the
// end thread tx holds the whole sum of row ty + 16 (tx >> 1), and so
// does its neighbour tx ^ 1. Each thread keeps the CG's vectors twice:
// x, r and p of that one row ("row view"), and r and p of its NB
// columns tx NB + l ("column view", what the next matvec needs). Both
// views take the same fmaf of the same numbers, so they stay equal bit
// for bit; only A p passes through shared memory, from row to column
// view, beside the partial sums of p.Ap.
//
// A CG step: the matvec; A p and the warps' partials of p.Ap to shared
// memory; barrier; alpha, the x and r updates in both views; the warps'
// partials of r.r; barrier; the exit test, beta and the p update in both
// views. The order of the updates and the guards is cg_loop's of
// common.cuh (pallas_solve.py:_cg_loop): warm start, x and r updated
// before the rsnew < cg_tol test, alpha 0 when p.Ap == 0 (NaN stays
// NaN), beta guarded by rsold <= 0. Every thread sums the eight warp
// partials in one fixed order, so the exit is the same for the whole
// block and a result repeats bit for bit.
#pragma once

#include "common.cuh"

namespace cumf {
namespace bulk {

constexpr int kStages = 2;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of copies on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A
// copy that never lands (a fault of this code, not of the data) ends the
// kernel with an error after some 2^24 tries instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// A 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Order this thread's earlier reads of shared memory before the copies
// it starts next into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One stage of the ring: A (F x F, stored dtype), then b and x0 (F f32).
template <int NB, typename AT>
struct Stage {
  static constexpr int F = 16 * NB;
  static constexpr int A_BYTES = F * F * (int)sizeof(AT);
  static constexpr int BYTES = A_BYTES + 2 * F * 4;
};

// Shared memory beside the ring.
template <int NB>
struct Scratch {
  static constexpr int F = 16 * NB;
  uint64_t full[kStages];  // the stages' barriers
  float ax[2][F];          // A x0 of the last two systems, row to column
  float ap[F];             // A p of this step, row to column
  alignas(16) float rs0[2][kWarps];  // warp partials of r.r at the start
  alignas(16) float pap[kWarps];     // of p.Ap
  alignas(16) float rs[kWarps];      // of r.r after the update
};

// This thread's tile of the staged A, f32, with d added on the diagonal.
template <int NB, typename AT>
__device__ __forceinline__ void stage_tile(const AT* sa, float d,
                                           float (&a)[NB][NB]) {
  constexpr int F = 16 * NB;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const AT* src = sa + (ty + 16 * k) * F + tx * NB;
    if constexpr (sizeof(AT) == 2 && NB == 8) {
      // eight bf16 in one 16-byte load: the lower lane in the low half
      const uint4 w = *reinterpret_cast<const uint4*>(src);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[k][2 * j] = __uint_as_float(ws[j] << 16);
        a[k][2 * j + 1] = __uint_as_float(ws[j] & 0xffff0000u);
      }
    } else if constexpr (sizeof(AT) == 4 && NB % 4 == 0) {
#pragma unroll
      for (int q = 0; q < NB / 4; ++q) {
        const float4 w = *reinterpret_cast<const float4*>(src + 4 * q);
        a[k][4 * q] = w.x;
        a[k][4 * q + 1] = w.y;
        a[k][4 * q + 2] = w.z;
        a[k][4 * q + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int l = 0; l < NB; ++l) a[k][l] = to_f32(src[l]);
    }
  }
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int l = 0; l < NB; ++l)
      if (ty + 16 * k == tx * NB + l) a[k][l] += d;
}

// (A v) of row ty + 16 (tx >> 1) (0 where that row is past F), from v in
// column view. Row sums of the tile, then the transposing butterfly over
// the 16 threads of the row group: at each level a thread keeps half of
// its partial rows and sends the other half to its partner.
template <int NB>
__device__ __forceinline__ float matvec_row(const float (&a)[NB][NB],
                                            const float (&v)[NB]) {
  const int tx = threadIdx.x & 15;
  float s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = 0.f;
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int l = 0; l < NB; ++l) s[k] = fmaf(a[k][l], v[l], s[k]);
  const bool h8 = tx & 8, h4 = tx & 4, h2 = tx & 2;
  float w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float send = h8 ? s[j] : s[j + 4];
    w[j] = (h8 ? s[j + 4] : s[j]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  float u[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float send = h4 ? w[j] : w[j + 2];
    u[j] = (h4 ? w[j + 2] : w[j]) + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  const float send = h2 ? u[0] : u[1];
  float t = (h2 ? u[1] : u[0]) + __shfl_xor_sync(0xffffffffu, send, 2);
  return t + __shfl_xor_sync(0xffffffffu, t, 1);
}

// The sum over the warp of v from its even lanes (the odd ones hold the
// same rows); lane 0 ends with it.
__device__ __forceinline__ float warp_rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The eight warp partials, added in one fixed order.
__device__ __forceinline__ float block_total(const float* part) {
  const float4 lo = *reinterpret_cast<const float4*>(part);
  const float4 hi = *reinterpret_cast<const float4*>(part + 4);
  return ((((((lo.x + lo.y) + lo.z) + lo.w) + hi.x) + hi.y) + hi.z) + hi.w;
}

// Solve systems blockIdx.x, blockIdx.x + gridDim.x, ... < r:
//   x_i = CG(f32(A_i) + diag_i I, b_i, x0_i)
// `stages` is the ring in dynamic shared memory (kStages Stage::BYTES,
// 16-byte aligned).
template <int NB, typename AT>
__device__ __forceinline__ void solve_systems(
    unsigned char* stages, Scratch<NB>& s, const AT* __restrict__ a_in,
    const float* __restrict__ diag, const float* __restrict__ b,
    const float* __restrict__ x0, float* __restrict__ x_out, int r,
    int cg_iters, float cg_tol) {
  using St = Stage<NB, AT>;
  constexpr int F = 16 * NB;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int warp = tid >> 5;
  const int row = ty + 16 * (tx >> 1);  // this thread's row (row view)
  const bool has_row = (tx >> 1) < NB;
  const bool owner = has_row && !(tx & 1);  // writes and counts the row
  const int col = tx * NB;                  // first of its NB columns

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&s.full[st], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // start the copies of the block's i-th system, `sys`, into stage i % 2
  auto start = [&](int i, int64_t sys) {
    unsigned char* st = stages + (i % kStages) * St::BYTES;
    uint64_t* bar = &s.full[i % kStages];
    mbar_expect_tx(bar, St::BYTES);
    bulk_copy(st, a_in + sys * F * F, St::A_BYTES, bar);
    bulk_copy(st + St::A_BYTES, b + sys * F, F * 4, bar);
    bulk_copy(st + St::A_BYTES + F * 4, x0 + sys * F, F * 4, bar);
  };
  const int first = blockIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i)
      if (first + i * gridDim.x < r)
        start(i, first + (int64_t)i * gridDim.x);
  }
  float d_next = first < r ? __ldg(diag + first) : 0.f;

  int i = 0;
  for (int sys = first; sys < r; sys += gridDim.x, ++i) {
    const int st = i % kStages;
    const float d = d_next;
    mbar_wait(&s.full[st], (i / kStages) & 1);
    const unsigned char* stage = stages + st * St::BYTES;
    const float* sb = reinterpret_cast<const float*>(stage + St::A_BYTES);
    const float* sx0 = sb + F;

    float a[NB][NB];
    stage_tile<NB, AT>(reinterpret_cast<const AT*>(stage), d, a);
    float x_col[NB], b_col[NB];
#pragma unroll
    for (int l = 0; l < NB; ++l) {
      x_col[l] = sx0[col + l];
      b_col[l] = sb[col + l];
    }
    float xr = has_row ? sx0[row] : 0.f;
    const float br = has_row ? sb[row] : 0.f;

    // r = b - A x0; A x0 passes from row to column view
    const float axr = matvec_row<NB>(a, x_col);
    float rr = br - axr;
    if (owner) s.ax[i & 1][row] = axr;
    const float rs0 = warp_rows_sum(owner ? rr * rr : 0.f);
    if ((tid & 31) == 0) s.rs0[i & 1][warp] = rs0;
    __syncthreads();  // the stage is consumed by every thread

    const int next = sys + kStages * gridDim.x;
    if (tid == 0 && next < r) {
      fence_proxy_async();
      start(i + kStages, next);
    }
    if (sys + gridDim.x < r) d_next = __ldg(diag + sys + gridDim.x);

    float rsold = block_total(s.rs0[i & 1]);
    float r_col[NB], p_col[NB];
#pragma unroll
    for (int l = 0; l < NB; ++l) {
      r_col[l] = b_col[l] - s.ax[i & 1][col + l];
      p_col[l] = r_col[l];
    }
    float pr = rr;

    for (int it = 0; it < cg_iters; ++it) {
      const float apr = matvec_row<NB>(a, p_col);
      if (owner) s.ap[row] = apr;
      const float pap_w = warp_rows_sum(owner ? pr * apr : 0.f);
      if ((tid & 31) == 0) s.pap[warp] = pap_w;
      __syncthreads();
      const float pap = block_total(s.pap);
      // the Pallas guard, literally: a zero p.Ap gives alpha 0, a NaN one
      // gives NaN (so a NaN system stays NaN)
      const float nonzero = fabsf(pap) > 0.f ? 1.f : 0.f;
      const float alpha = nonzero * rsold / (pap + (1.f - nonzero));
      xr = fmaf(alpha, pr, xr);
      rr = fmaf(-alpha, apr, rr);
#pragma unroll
      for (int l = 0; l < NB; ++l)
        r_col[l] = fmaf(-alpha, s.ap[col + l], r_col[l]);
      const float rs_w = warp_rows_sum(owner ? rr * rr : 0.f);
      if ((tid & 31) == 0) s.rs[warp] = rs_w;
      __syncthreads();
      const float rsnew = block_total(s.rs);
      if (!(rsnew >= cg_tol)) break;  // per-system exit, after the update
      const float beta = rsnew / (rsold + (rsold <= 0.f ? 1.f : 0.f));
      pr = fmaf(beta, pr, rr);
#pragma unroll
      for (int l = 0; l < NB; ++l) p_col[l] = fmaf(beta, p_col[l], r_col[l]);
      rsold = rsnew;
    }
    if (owner) x_out[(int64_t)sys * F + row] = xr;
  }
}

}  // namespace bulk
}  // namespace cumf
