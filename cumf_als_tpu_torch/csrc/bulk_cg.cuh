// The batched CG of the three solve kernels on Hopper, at every width
// they take: solve_cg_reg.cu (K3: A + diag I), solve_cg.cu (K4: A as
// given) and solve_cg_aug.cu (K5b: b unpacked from row f - 1 of A', row
// and column f - 1 masked, + diag I). The three differ only in the
// compile-time Mode below; each source is an entry point on `run` and
// `blocks_per_sm` of this file.
//
// f <= 128: persistent blocks that walk the systems, each system's A
// (and its b and x0) brought into a ring of two shared-memory stages by
// bulk-async copies, and a CG step with two block-wide barriers.
//
// The ring. One thread starts a stage's copies (cp.async.bulk, one 1-D
// copy each for A, b and x0, all contiguous and 16-byte aligned; K5b has
// no b to copy) and they complete on the stage's mbarrier, so system
// i + 1's A is in flight while system i's CG runs. A block's system i
// lives in stage i % 2; its copies start once the block's first barrier
// of system i - 2 has passed, which every thread reaches only after it
// has copied its tile of that stage into registers.
//
// The layout. Thread (ty, tx) of the 16 x 16 grid keeps A[ty + 16k]
// [tx NB + l] (k, l < NB) in registers, with the diagonal added as it
// copies the tile out of the stage (K5b first zeroes row and column
// f - 1 there, then adds the diagonal on the whole diagonal). A matvec
// sums each thread's NB columns for its NB rows and reduces the 16
// threads of a row group by a transposing butterfly (8 shuffles, not
// 4 NB): at the end thread tx holds the whole sum of row ty + 16 (tx >>
// 1), and so does its neighbour tx ^ 1. Each thread keeps the CG's
// vectors twice: x, r and p of that one row ("row view"), and r and p
// of its NB columns tx NB + l ("column view", what the next matvec
// needs). Both views take the same fmaf of the same numbers, so they
// stay equal bit for bit; only A p passes through shared memory, from
// row to column view, beside the partial sums of p.Ap. K5b reads b in
// both views from row f - 1 of the staged A' (lane f - 1 as 0) before
// the stage is released, so b is unpacked before the mask, as
// pallas_solve.py:_cg_solve_aug_kernel does.
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
//
// f = 256. The register tile (NB = 16: 256 floats a thread) does not
// fit, and neither does an f32 A (256 KB) in one block's shared memory
// (227 KB at most). Of the two layouts that would keep A on chip, a
// two-block cluster exchanging halves of p through distributed shared
// memory, or A read from device memory on each matvec, this file takes
// the second: it is the simple one, and what it re-reads stays in the
// L2. Persistent blocks walk the systems, one system a block; the grid
// holds as many systems in flight as fit three quarters of the L2 (one
// block an SM with an f32 A on an H100, 132 x 256 KB = 33 MB of its
// 50 MB; two with a bf16 A), so only the first matvec of a system
// (r = b - A x0) reads A from HBM and the cg_iters after it from the
// L2. A matvec gives each warp 32 rows: lane l reads columns 8 l ..
// 8 l + 7 of a row (32 or 16 contiguous bytes, a warp a whole row),
// adds the diagonal where it falls (K5b: zeroes row and column f - 1
// first), multiplies by its 8 entries of v and the warp adds its lanes
// by a butterfly in one fixed order. The CG is common.cuh's cg_loop,
// the same contract as above.
#pragma once

#include "common.cuh"

namespace cumf {
namespace bulk {

constexpr int kStages = 2;
constexpr int kWarps = kThreads / 32;

// What a solve kernel computes:
//   kReg   (K3)  x = CG(f32(A) + diag I, b, x0)
//   kPlain (K4)  x = CG(f32(A), b, x0)
//   kAug   (K5b) b = row f-1 of f32(A') with lane f-1 zeroed,
//                x = CG(f32(A') with row and column f-1 zeroed + diag I,
//                       b, x0)
enum class Mode { kReg, kPlain, kAug };

template <Mode M>
constexpr bool kHasDiag = M != Mode::kPlain;
template <Mode M>
constexpr bool kHasB = M != Mode::kAug;

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

// One stage of the ring: A (F x F, stored dtype), then b (F f32, not
// with K5b, whose b is row F - 1 of A') and x0 (F f32).
template <int NB, typename AT, Mode M>
struct Stage {
  static constexpr int F = 16 * NB;
  static constexpr int A_BYTES = F * F * (int)sizeof(AT);
  static constexpr int X0 = A_BYTES + (kHasB<M> ? F * 4 : 0);
  static constexpr int BYTES = X0 + F * 4;
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

// This thread's tile of the staged A, f32; K5b zeroes row and column
// F - 1; then d is added on the diagonal (not with K4).
template <int NB, typename AT, Mode M>
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
  if constexpr (M == Mode::kAug) {
#pragma unroll
    for (int k = 0; k < NB; ++k)
#pragma unroll
      for (int l = 0; l < NB; ++l)
        if (ty + 16 * k == F - 1 || tx * NB + l == F - 1) a[k][l] = 0.f;
  }
  if constexpr (kHasDiag<M>) {
#pragma unroll
    for (int k = 0; k < NB; ++k)
#pragma unroll
      for (int l = 0; l < NB; ++l)
        if (ty + 16 * k == tx * NB + l) a[k][l] += d;
  }
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

// Solve systems blockIdx.x, blockIdx.x + gridDim.x, ... < r as Mode M
// says (f <= 128). `stages` is the ring in dynamic shared memory
// (kStages Stage::BYTES, 16-byte aligned); diag is unused with K4, b
// with K5b.
template <int NB, typename AT, Mode M>
__device__ __forceinline__ void solve_systems(
    unsigned char* stages, Scratch<NB>& s, const AT* __restrict__ a_in,
    const float* __restrict__ diag, const float* __restrict__ b,
    const float* __restrict__ x0, float* __restrict__ x_out, int r,
    int cg_iters, float cg_tol) {
  using St = Stage<NB, AT, M>;
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
    if constexpr (kHasB<M>)
      bulk_copy(st + St::A_BYTES, b + sys * F, F * 4, bar);
    bulk_copy(st + St::X0, x0 + sys * F, F * 4, bar);
  };
  const int first = blockIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i)
      if (first + i * gridDim.x < r)
        start(i, first + (int64_t)i * gridDim.x);
  }
  float d_next = 0.f;
  if constexpr (kHasDiag<M>) d_next = first < r ? __ldg(diag + first) : 0.f;

  int i = 0;
  for (int sys = first; sys < r; sys += gridDim.x, ++i) {
    const int st = i % kStages;
    const float d = d_next;
    mbar_wait(&s.full[st], (i / kStages) & 1);
    const unsigned char* stage = stages + st * St::BYTES;
    const AT* sa = reinterpret_cast<const AT*>(stage);
    const float* sx0 = reinterpret_cast<const float*>(stage + St::X0);
    // b of lane j: staged, or K5b's row F - 1 of A' with lane F - 1 as 0
    auto b_at = [&](int j) -> float {
      if constexpr (kHasB<M>)
        return reinterpret_cast<const float*>(stage + St::A_BYTES)[j];
      else
        return j < F - 1 ? to_f32(sa[(F - 1) * F + j]) : 0.f;
    };

    float a[NB][NB];
    stage_tile<NB, AT, M>(sa, d, a);
    float x_col[NB], b_col[NB];
#pragma unroll
    for (int l = 0; l < NB; ++l) {
      x_col[l] = sx0[col + l];
      b_col[l] = b_at(col + l);
    }
    float xr = has_row ? sx0[row] : 0.f;
    const float br = has_row ? b_at(row) : 0.f;

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
    if constexpr (kHasDiag<M>)
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

// ---------------------------------------------------------- f = 256 --
constexpr int kWideF = 256;

// Shared memory of the f = 256 body: cg_loop's vectors (16-byte aligned
// for the matvec's float4 reads of v).
struct alignas(16) WideScratch {
  float b[kWideF];
  float x[kWideF];
  float r[kWideF];
  float p[kWideF];
  float ap[kWideF];
  float red[2];
};

// out = (A v) of one system at f = 256, A read from device memory, as
// Mode M shapes it (K5b: row and column 255 zeroed; K3, K5b: + d on the
// diagonal). Warp w takes rows 32 w .. 32 w + 31, four at a time; lane l
// reads columns 8 l .. 8 l + 7. Ends in a barrier (cg_loop's contract).
template <typename AT, Mode M>
struct WideMatvec {
  const AT* a;
  float d;
  __device__ __forceinline__ void operator()(const float* v,
                                             float* out) const {
    constexpr int F = kWideF;
    constexpr int kRows = 4;  // rows whose loads are in flight at once
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int c0 = 8 * lane;
    float vv[8];
    {
      const float4 lo = *reinterpret_cast<const float4*>(v + c0);
      const float4 hi = *reinterpret_cast<const float4*>(v + c0 + 4);
      vv[0] = lo.x; vv[1] = lo.y; vv[2] = lo.z; vv[3] = lo.w;
      vv[4] = hi.x; vv[5] = hi.y; vv[6] = hi.z; vv[7] = hi.w;
    }
#pragma unroll 1
    for (int r0 = 32 * warp; r0 < 32 * warp + 32; r0 += kRows) {
      float e[kRows][8];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const AT* src = a + (int64_t)(r0 + q) * F + c0;
        if constexpr (sizeof(AT) == 2) {
          // eight bf16 in one 16-byte load: the lower lane in the low half
          const uint4 w = __ldg(reinterpret_cast<const uint4*>(src));
          const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            e[q][2 * j] = __uint_as_float(ws[j] << 16);
            e[q][2 * j + 1] = __uint_as_float(ws[j] & 0xffff0000u);
          }
        } else {
          const float4 lo = __ldg(reinterpret_cast<const float4*>(src));
          const float4 hi = __ldg(reinterpret_cast<const float4*>(src) + 1);
          e[q][0] = lo.x; e[q][1] = lo.y; e[q][2] = lo.z; e[q][3] = lo.w;
          e[q][4] = hi.x; e[q][5] = hi.y; e[q][6] = hi.z; e[q][7] = hi.w;
        }
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int row = r0 + q;
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float aij = e[q][k];
          if constexpr (M == Mode::kAug)
            if (row == F - 1 || c0 + k == F - 1) aij = 0.f;
          if constexpr (kHasDiag<M>)
            if (c0 + k == row) aij += d;
          sum = fmaf(aij, vv[k], sum);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) out[row] = sum;
      }
    }
    __syncthreads();
  }
};

// Solve systems blockIdx.x, blockIdx.x + gridDim.x, ... < r at f = 256
// as Mode M says, A read from device memory on each matvec.
template <typename AT, Mode M>
__device__ __forceinline__ void solve_systems_wide(
    WideScratch& s, const AT* __restrict__ a_in,
    const float* __restrict__ diag, const float* __restrict__ b,
    const float* __restrict__ x0, float* __restrict__ x_out, int r,
    int cg_iters, float cg_tol) {
  constexpr int F = kWideF;
  const int tid = threadIdx.x;  // kThreads = F: one lane a thread
  for (int sys = blockIdx.x; sys < r; sys += gridDim.x) {
    const AT* a = a_in + (int64_t)sys * F * F;
    float d = 0.f;
    if constexpr (kHasDiag<M>) d = __ldg(diag + sys);
    if constexpr (kHasB<M>)
      s.b[tid] = b[(int64_t)sys * F + tid];
    else
      s.b[tid] = tid < F - 1 ? to_f32(a[(F - 1) * F + tid]) : 0.f;
    s.x[tid] = x0[(int64_t)sys * F + tid];
    __syncthreads();
    const WideMatvec<AT, M> mv{a, d};
    cg_loop<F>(s.b, s.x, s.r, s.p, s.ap, s.red, mv, cg_iters, cg_tol);
    x_out[(int64_t)sys * F + tid] = s.x[tid];
    __syncthreads();  // s.b and s.x take the next system
  }
}

// The kernels and their host side have internal linkage: each of the
// three sources that include this file is built into a library of its
// own (see gram_mma.cuh).
namespace {

template <int NB, typename AT, Mode M>
constexpr int kRingBytes = kStages * Stage<NB, AT, M>::BYTES;

template <int NB, typename AT, Mode M>
__global__ void __launch_bounds__(kThreads, 2)
    solve_kernel(const AT* __restrict__ a_in, const float* __restrict__ diag,
                 const float* __restrict__ b, const float* __restrict__ x0,
                 float* __restrict__ x_out, int r, int cg_iters,
                 float cg_tol) {
  extern __shared__ __align__(128) unsigned char stages[];
  __shared__ Scratch<NB> s;
  solve_systems<NB, AT, M>(stages, s, a_in, diag, b, x0, x_out, r,
                           cg_iters, cg_tol);
}

template <typename AT, Mode M>
__global__ void __launch_bounds__(kThreads)
    solve_wide_kernel(const AT* __restrict__ a_in,
                      const float* __restrict__ diag,
                      const float* __restrict__ b,
                      const float* __restrict__ x0,
                      float* __restrict__ x_out, int r, int cg_iters,
                      float cg_tol) {
  __shared__ WideScratch s;
  solve_systems_wide<AT, M>(s, a_in, diag, b, x0, x_out, r, cg_iters,
                            cg_tol);
}

// the ring is dynamic shared memory above 48 KB: allowed once per
// instantiation, before the first launch or occupancy query
template <int NB, typename AT, Mode M>
cudaError_t allow_ring() {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      solve_kernel<NB, AT, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRingBytes<NB, AT, M>);
  return allowed;
}

template <int NB, typename AT, Mode M>
int launch(const void* a, const void* diag, const void* b, const void* x0,
           void* x_out, int r, int cg_iters, float cg_tol, int grid,
           cudaStream_t stream) {
  const cudaError_t allowed = allow_ring<NB, AT, M>();
  if (allowed != cudaSuccess) return (int)allowed;
  solve_kernel<NB, AT, M><<<grid, kThreads, kRingBytes<NB, AT, M>,
                            stream>>>(
      (const AT*)a, (const float*)diag, (const float*)b, (const float*)x0,
      (float*)x_out, r, cg_iters, cg_tol);
  return (int)cudaGetLastError();
}

template <typename AT, Mode M>
int launch_wide(const void* a, const void* diag, const void* b,
                const void* x0, void* x_out, int r, int cg_iters,
                float cg_tol, int grid, cudaStream_t stream) {
  solve_wide_kernel<AT, M><<<grid, kThreads, 0, stream>>>(
      (const AT*)a, (const float*)diag, (const float*)b, (const float*)x0,
      (float*)x_out, r, cg_iters, cg_tol);
  return (int)cudaGetLastError();
}

// how many blocks of this instantiation one SM of the current device
// holds at once, from its registers and its shared memory (ring and
// Scratch) as the compiler laid them out
template <int NB, typename AT, Mode M>
int ring_blocks_per_sm(int* out) {
  const cudaError_t allowed = allow_ring<NB, AT, M>();
  if (allowed != cudaSuccess) return (int)allowed;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, solve_kernel<NB, AT, M>, kThreads, kRingBytes<NB, AT, M>);
}

// f = 256: the blocks an SM the kernel's registers and shared memory
// allow, but no more than keep the systems in flight (one A of f^2
// entries a block) within three quarters of the L2
template <typename AT, Mode M>
int wide_blocks_per_sm(int* out) {
  int occ = 0, device = 0, l2 = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, solve_wide_kernel<AT, M>, kThreads, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const long long a_bytes = (long long)kWideF * kWideF * sizeof(AT);
  const long long fit = 3LL * l2 / 4 / ((long long)(sms > 0 ? sms : 1) *
                                        a_bytes);
  *out = occ < fit ? occ : (fit > 1 ? (int)fit : 1);
  return 0;
}

template <typename AT, Mode M>
int dispatch(int f, const void* a, const void* diag, const void* b,
             const void* x0, void* x_out, int r, int cg_iters, float cg_tol,
             int grid, cudaStream_t stream) {
  if (f == kWideF)
    return launch_wide<AT, M>(a, diag, b, x0, x_out, r, cg_iters, cg_tol,
                              grid, stream);
#define CUMF_LAUNCH(NB)                                                      \
  return launch<NB, AT, M>(a, diag, b, x0, x_out, r, cg_iters, cg_tol, grid, \
                           stream)
  CUMF_DISPATCH_NB(f, CUMF_LAUNCH)
#undef CUMF_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename AT, Mode M>
int dispatch_occupancy(int f, int* out) {
  if (f == kWideF) return wide_blocks_per_sm<AT, M>(out);
#define CUMF_QUERY(NB) return ring_blocks_per_sm<NB, AT, M>(out)
  CUMF_DISPATCH_NB(f, CUMF_QUERY)
#undef CUMF_QUERY
  return (int)cudaErrorInvalidValue;
}

// The host side of a solve kernel: r systems of f (a multiple of 16 up
// to 128, or 256) in `grid` persistent blocks, 1 <= grid <= r
// (`cuda_solve.cg_grid`, from the SM count and blocks_per_sm). a, b, x0
// contiguous, on 16-byte boundaries. Returns the CUDA error.
template <Mode M>
int run(const void* a, int a_bf16, const void* diag, const void* b,
        const void* x0, void* x_out, int r, int f, int cg_iters,
        float cg_tol, int grid, cudaStream_t stream) {
  if (grid < 1 || grid > r) return (int)cudaErrorInvalidValue;
  if (a_bf16)
    return dispatch<__nv_bfloat16, M>(f, a, diag, b, x0, x_out, r, cg_iters,
                                      cg_tol, grid, stream);
  return dispatch<float, M>(f, a, diag, b, x0, x_out, r, cg_iters, cg_tol,
                            grid, stream);
}

// The occupancy query beside each kernel: writes to *out (an int) the
// blocks of this kernel at this f and A dtype that one SM of the current
// device takes (at f = 256 also bounded by the L2, see above), so the
// host sizes the persistent grid without a copy of the kernel's layout.
template <Mode M>
int blocks_per_sm(int f, int a_bf16, void* out) {
  if (a_bf16) return dispatch_occupancy<__nv_bfloat16, M>(f, (int*)out);
  return dispatch_occupancy<float, M>(f, (int*)out);
}

}  // namespace

}  // namespace bulk
}  // namespace cumf
