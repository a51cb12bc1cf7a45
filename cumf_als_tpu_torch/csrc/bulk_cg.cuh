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
// f = 256: one system a cluster of two blocks, A held in registers.
// Neither an f32 A (256 KB) nor its register tile (256 floats a thread)
// fits one block, so block c of the cluster (its rank) owns rows
// 128 c .. 128 c + 127: thread (ty, tx) keeps A[128 c + ty + 16 k]
// [64 j + 4 tx + i] (k < 8; j, i < 4), the f <= 128 layout with eight
// rows and sixteen columns a thread (the columns in four groups of four,
// 64 apart, so that a quarter warp's 16-byte reads of a staged row fall
// in distinct banks): 128 f32 registers, one block an SM; a bf16 A stays
// bf16 in 64 registers (two columns a word, widened as the matvec reads
// them), two blocks an SM. Persistent clusters walk the systems
// cluster_id, + n_clusters, ...; each block brings its half of A (one
// contiguous 128 x 256 block), b and x0 into its stage by bulk-async
// copies on the stage's mbarrier, and starts the next system's copies
// as soon as every thread has its tile in registers, so they stream in
// while this system's CG runs: A is read from device memory once a
// system. K5b's b is row 255 of A', which block 1 holds; block 0 copies
// that row too. The diagonal (K3, K5b) is added in row view, d p_i to
// row i's sum, so a bf16 tile is never rounded with it.
//
// A CG step: each block computes A p for its 128 rows (the transposing
// butterfly of the f <= 128 body); the row's owner stores the sum into
// its own block's shared memory and, by st.async, into its peer's, each
// remote store completing 4 bytes of the peer's exchange mbarrier (one
// phase: this block's eight warps arrive, one of them expecting the
// peer's 512 bytes). Every thread waits on its own block's barrier
// (acquire at cluster scope, the trap after 2^24 tries). Now both blocks
// hold all 256 entries of A p and run cg_loop's vector updates on all
// 256 lanes: r in shared memory (thread tid updates lane tid, then a
// block barrier), p in column view; the same fmaf on the same numbers,
// p.Ap and r.r summed by each half warp over its sixteen threads'
// columns in one fixed order, so alpha, beta and the exit test are
// equal bit for bit in both blocks (and in every thread) by
// construction: a divergent exit would leave the peer waiting on an
// exchange that never comes. A p is
// double buffered: the peer stores into buffer e & 1 at exchange e only
// after its own barrier of exchange e - 1 completed, which needed this
// block's stores of e - 1, made after its reads of exchange e - 2. One
// exchange a step, one for A x0; a cluster barrier at the start (the
// peer's barriers are initialized) and at the end (no block leaves while
// its peer may still store into its shared memory). The order of the
// updates and the guards is cg_loop's, as above.
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

// The transposing butterfly over the 16 threads of a row group: s[k]
// is this thread's partial sum of row ty + 16 k; at each level a thread
// keeps half of its partial rows and sends the other half to its
// partner. Returns the whole sum of row ty + 16 (tx >> 1).
__device__ __forceinline__ float row_butterfly(const float (&s)[8]) {
  const int tx = threadIdx.x & 15;
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

// (A v) of row ty + 16 (tx >> 1) (0 where that row is past F), from v in
// column view: row sums of the tile, then row_butterfly.
template <int NB>
__device__ __forceinline__ float matvec_row(const float (&a)[NB][NB],
                                            const float (&v)[NB]) {
  float s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = 0.f;
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int l = 0; l < NB; ++l) s[k] = fmaf(a[k][l], v[l], s[k]);
  return row_butterfly(s);
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
constexpr int kHalf = kWideF / 2;  // the rows a block of the cluster owns
constexpr int kCols = 16;          // the columns a thread holds

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v));
  return v;
}
__device__ __forceinline__ uint32_t cluster_index() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(v));
  return v;
}
__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(v));
  return v;
}

// Every thread of both blocks; the shared memory each wrote before is
// seen by the other's threads after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address in the peer block `rank` of this block's shared address.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Store v at `addr` of the peer's shared memory; the store completes 4
// bytes of the transaction count of the peer's barrier `bar`.
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "f"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// mbar_wait, acquiring at cluster scope (the peer's stores into this
// block's shared memory); the same trap.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// The stage of a block: its half of A (128 rows x 256, stored dtype),
// then b (256 f32; K5b: row 255 of A', which only block 1's half holds,
// copied by block 0) and x0 (256 f32).
template <typename AT, Mode M>
struct WideStage {
  static constexpr int A_BYTES = kHalf * kWideF * (int)sizeof(AT);
  static constexpr int B = A_BYTES;
  static constexpr int X0 =
      B + kWideF * (kHasB<M> ? 4 : (int)sizeof(AT));
  static constexpr int BYTES = X0 + kWideF * 4;
};

// Shared memory beside the stage.
struct WideScratch {
  uint64_t full;                     // the stage's barrier
  uint64_t xbar[2];                  // the exchange barriers, a buffer each
  alignas(16) float ap[2][kWideF];   // A v of both blocks' rows
  alignas(16) float r[kWideF];       // the residual, all 256 lanes
};

// A thread's tile of A as stored: f32 entries (16 words a row), or bf16
// pairs (8 words a row: columns q and q + 1 in the low and high half of
// word q / 2), so a bf16 A takes half the registers and two blocks fit
// an SM.
template <typename AT>
struct WideTile {
  static constexpr int W = kCols * (int)sizeof(AT) / 4;
  uint32_t w[8][W];
  __device__ __forceinline__ float at(int k, int q) const {
    if constexpr (sizeof(AT) == 4)
      return __uint_as_float(w[k][q]);
    else
      return __uint_as_float(q & 1 ? w[k][q >> 1] & 0xffff0000u
                                   : w[k][q >> 1] << 16);
  }
};

// This thread's tile of the staged half of A; K5b zeroes column F - 1
// (its row F - 1 is zeroed in row view, see the matvec below).
template <typename AT, Mode M>
__device__ __forceinline__ void wide_tile(const AT* sa, WideTile<AT>& t) {
  constexpr int F = kWideF;
  constexpr int W = WideTile<AT>::W;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const AT* src = sa + (ty + 16 * k) * F + 64 * j + 4 * tx;
      if constexpr (sizeof(AT) == 2) {
        const uint2 v = *reinterpret_cast<const uint2*>(src);
        t.w[k][2 * j] = v.x;
        t.w[k][2 * j + 1] = v.y;
      } else {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        t.w[k][4 * j] = v.x;
        t.w[k][4 * j + 1] = v.y;
        t.w[k][4 * j + 2] = v.z;
        t.w[k][4 * j + 3] = v.w;
      }
    }
  }
  if constexpr (M == Mode::kAug) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      // column F - 1 is entry q = 15 of thread tx = 15: the last word,
      // or the high half of it
      if (tx == 15) t.w[k][W - 1] &= sizeof(AT) == 4 ? 0u : 0x0000ffffu;
  }
}

// (A v) of row ty + 16 (tx >> 1) of this block's half, from v in column
// view: the row sums of the stored tile, each entry widened as it is
// read, then row_butterfly.
template <typename AT>
__device__ __forceinline__ float wide_matvec(const WideTile<AT>& t,
                                             const float (&v)[kCols]) {
  float s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s[k] = 0.f;
#pragma unroll
    for (int q = 0; q < kCols; ++q) s[k] = fmaf(t.at(k, q), v[q], s[k]);
  }
  return row_butterfly(s);
}

// Group j of this thread's columns of a 256-vector in shared memory:
// entries q = 4 j .. 4 j + 3 of its column view are columns
// 64 j + 4 tx .. 64 j + 4 tx + 3.
__device__ __forceinline__ float4 col_group(const float* v, int j) {
  return *reinterpret_cast<const float4*>(v + 64 * j +
                                          4 * (threadIdx.x & 15));
}

// This thread's sixteen entries of a 256-vector in shared memory, in
// column view.
__device__ __forceinline__ void load_cols(const float* v,
                                          float (&out)[kCols]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 w = col_group(v, j);
    out[4 * j] = w.x;
    out[4 * j + 1] = w.y;
    out[4 * j + 2] = w.z;
    out[4 * j + 3] = w.w;
  }
}

// The sum over the 256 columns of u v, u in column view, v in shared
// memory: each thread's sixteen as four sums of four, then its half
// warp's sixteen threads by a butterfly. Every thread of both blocks
// holds the same u and v, so every thread gets the same bits.
__device__ __forceinline__ float col_dot(const float (&u)[kCols],
                                         const float* v) {
  float t4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 w = col_group(v, j);
    t4[0] = fmaf(u[4 * j], w.x, t4[0]);
    t4[1] = fmaf(u[4 * j + 1], w.y, t4[1]);
    t4[2] = fmaf(u[4 * j + 2], w.z, t4[2]);
    t4[3] = fmaf(u[4 * j + 3], w.w, t4[3]);
  }
  float t = (t4[0] + t4[1]) + (t4[2] + t4[3]);
  t += __shfl_xor_sync(0xffffffffu, t, 8);
  t += __shfl_xor_sync(0xffffffffu, t, 4);
  t += __shfl_xor_sync(0xffffffffu, t, 2);
  return t + __shfl_xor_sync(0xffffffffu, t, 1);
}

// The same sum with v = u, in registers.
__device__ __forceinline__ float col_norm2(const float (&u)[kCols]) {
  float t4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < kCols; ++q) t4[q & 3] = fmaf(u[q], u[q], t4[q & 3]);
  float t = (t4[0] + t4[1]) + (t4[2] + t4[3]);
  t += __shfl_xor_sync(0xffffffffu, t, 8);
  t += __shfl_xor_sync(0xffffffffu, t, 4);
  t += __shfl_xor_sync(0xffffffffu, t, 2);
  return t + __shfl_xor_sync(0xffffffffu, t, 1);
}

// Solve systems cluster_id, cluster_id + n_clusters, ... < r at f = 256
// as Mode M says, this block holding rows 128 c .. 128 c + 127 of each.
// `stage`: WideStage::BYTES of dynamic shared memory, 16-byte aligned;
// diag is unused with K4, b with K5b.
template <typename AT, Mode M>
__device__ __forceinline__ void solve_systems_cluster(
    unsigned char* stage, WideScratch& s, const AT* __restrict__ a_in,
    const float* __restrict__ diag, const float* __restrict__ b,
    const float* __restrict__ x0, float* __restrict__ x_out, int r,
    int cg_iters, float cg_tol) {
  using St = WideStage<AT, M>;
  constexpr int F = kWideF;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int c = (int)cluster_rank();
  const int first = (int)cluster_index();
  const int step = (int)cluster_count();
  const int grow = kHalf * c + ty + 16 * (tx >> 1);  // row view, global
  const bool owner = !(tx & 1);  // writes the row's A v and its x

  if (tid == 0) {
    mbar_init(&s.full, 1);
    // this block's warps, and the peer's 128 stores as 512 bytes
    for (int e = 0; e < 2; ++e) mbar_init(&s.xbar[e], kWarps);
    mbar_init_fence();
  }
  cluster_sync();  // both blocks' barriers are ready for the peer's stores
  const uint32_t peer_ap = peer_addr(smem_u32(&s.ap[0][0]), c ^ 1);
  const uint32_t peer_xbar = peer_addr(smem_u32(&s.xbar[0]), c ^ 1);

  // start the copies of system `sys` into the stage
  auto start = [&](int64_t sys) {
    const AT* a = a_in + sys * F * F;
    const bool brow = !kHasB<M> && c == 0;
    mbar_expect_tx(&s.full,
                   St::A_BYTES + F * 4 +
                       (kHasB<M> ? F * 4 : (brow ? F * (int)sizeof(AT) : 0)));
    bulk_copy(stage, a + kHalf * c * F, St::A_BYTES, &s.full);
    if constexpr (kHasB<M>)
      bulk_copy(stage + St::B, b + sys * F, F * 4, &s.full);
    else if (brow)
      bulk_copy(stage + St::B, a + (F - 1) * F, F * (int)sizeof(AT),
                &s.full);
    bulk_copy(stage + St::X0, x0 + sys * F, F * 4, &s.full);
  };
  if (tid == 0 && first < r) start(first);

  // Exchange e: this thread's row of A v into buffer e & 1 of both
  // blocks; returns the buffer once all 256 entries are in: the peer's
  // 128 stores complete 512 bytes of this block's barrier, whose phase
  // also waits for this block's eight warps.
  uint32_t e = 0;
  auto exchange = [&](float v) -> const float* {
    const int buf = e & 1;
    if (owner) {
      s.ap[buf][grow] = v;
      st_async(peer_ap + 4 * (buf * F + grow), v, peer_xbar + 8 * buf);
    }
    __syncwarp();
    if (tid == 0)
      mbar_expect_tx(&s.xbar[buf], kHalf * 4);
    else if ((tid & 31) == 0)
      mbar_arrive(&s.xbar[buf]);
    mbar_wait_cluster(&s.xbar[buf], (e >> 1) & 1);
    ++e;
    return s.ap[buf];
  };

  int i = 0;
  for (int sys = first; sys < r; sys += step, ++i) {
    float d = 0.f;
    if constexpr (kHasDiag<M>) d = __ldg(diag + sys);
    mbar_wait(&s.full, i & 1);
    const AT* sa = reinterpret_cast<const AT*>(stage);
    const float* sx0 = reinterpret_cast<const float*>(stage + St::X0);
    WideTile<AT> t;
    wide_tile<AT, M>(sa, t);
    // (A + d I) v of this thread's row, the diagonal added in row view
    // (vr: v's entry there); K5b's masked row F - 1 sums to 0, set here
    // rather than in the tile, where the mask costs a bf16 tile
    // registers it does not have
    auto matvec = [&](const float(&v)[kCols], float vr) -> float {
      float sum = wide_matvec<AT>(t, v);
      if constexpr (M == Mode::kAug)
        if (grow == F - 1) sum = 0.f;
      if constexpr (kHasDiag<M>)
        return fmaf(d, vr, sum);
      else
        return sum;
    };
    // x0 in both views; b of lane tid: staged, or K5b's row F - 1 of A'
    // with lane F - 1 as 0
    float x_col[kCols];
    load_cols(sx0, x_col);
    float xr = sx0[grow];
    float bt;
    if constexpr (kHasB<M>) {
      bt = reinterpret_cast<const float*>(stage + St::B)[tid];
    } else {
      const AT* sb = c == 1 ? sa + (kHalf - 1) * F
                            : reinterpret_cast<const AT*>(stage + St::B);
      bt = tid < F - 1 ? to_f32(sb[tid]) : 0.f;
    }

    // r = b - A x0; after the exchange every thread of the block is done
    // with the stage. Thread tid keeps lane tid of r in s.r (each block
    // all 256 lanes); p lives in column view (p_col) and row view (pr).
    const float* ax = exchange(matvec(x_col, xr));
    if (tid == 0 && sys + step < r) {
      fence_proxy_async();
      start(sys + step);
    }
    s.r[tid] = bt - ax[tid];
    __syncthreads();
    float p_col[kCols];
    load_cols(s.r, p_col);
    float pr = s.r[grow];
    float rsold = col_norm2(p_col);

    for (int it = 0; it < cg_iters; ++it) {
      const float apr = matvec(p_col, pr);
      const float* ap = exchange(apr);
      const float pap = col_dot(p_col, ap);
      // the Pallas guard, literally: a zero p.Ap gives alpha 0, a NaN one
      // gives NaN (so a NaN system stays NaN)
      const float nonzero = fabsf(pap) > 0.f ? 1.f : 0.f;
      const float alpha = nonzero * rsold / (pap + (1.f - nonzero));
      xr = fmaf(alpha, pr, xr);
      s.r[tid] = fmaf(-alpha, ap[tid], s.r[tid]);
      __syncthreads();
      float r_col[kCols];
      load_cols(s.r, r_col);
      const float rsnew = col_norm2(r_col);
      if (!(rsnew >= cg_tol)) break;  // per-system exit, after the update
      const float beta = rsnew / (rsold + (rsold <= 0.f ? 1.f : 0.f));
      pr = fmaf(beta, pr, s.r[grow]);
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        p_col[q] = fmaf(beta, p_col[q], r_col[q]);
      rsold = rsnew;
    }
    if (owner) x_out[(int64_t)sys * F + grow] = xr;
  }
  cluster_sync();  // the peer no longer writes into this block's memory
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
constexpr int kWideStageBytes = WideStage<AT, M>::BYTES;

// f = 256, launched in clusters of two blocks (launch_cluster). An f32
// tile is 128 registers a thread: one block an SM, up to 255 registers;
// a bf16 tile is 64: two blocks an SM, up to 128.
template <typename AT, Mode M>
__global__ void __launch_bounds__(kThreads, sizeof(AT) == 2 ? 2 : 1)
    solve_cluster_kernel(const AT* __restrict__ a_in,
                         const float* __restrict__ diag,
                         const float* __restrict__ b,
                         const float* __restrict__ x0,
                         float* __restrict__ x_out, int r, int cg_iters,
                         float cg_tol) {
  extern __shared__ __align__(128) unsigned char stages[];
  __shared__ WideScratch s;
  solve_systems_cluster<AT, M>(stages, s, a_in, diag, b, x0, x_out, r,
                               cg_iters, cg_tol);
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
cudaError_t allow_cluster_stage() {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      solve_cluster_kernel<AT, M>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kWideStageBytes<AT, M>);
  return allowed;
}

// The launch of `grid` blocks (even) in clusters of two, on `stream`;
// `attr` holds the cluster dimension.
template <typename AT, Mode M>
cudaLaunchConfig_t cluster_config(int grid, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 2;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kWideStageBytes<AT, M>;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename AT, Mode M>
int launch_cluster(const void* a, const void* diag, const void* b,
                   const void* x0, void* x_out, int r, int cg_iters,
                   float cg_tol, int grid, cudaStream_t stream) {
  const cudaError_t allowed = allow_cluster_stage<AT, M>();
  if (allowed != cudaSuccess) return (int)allowed;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<AT, M>(grid, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, solve_cluster_kernel<AT, M>, (const AT*)a, (const float*)diag,
      (const float*)b, (const float*)x0, (float*)x_out, r, cg_iters, cg_tol);
  if (err != cudaSuccess) return (int)err;
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

// f = 256: how many clusters of two blocks the whole current device
// holds at once (not a count an SM: the GPCs decide how SMs pair)
template <typename AT, Mode M>
int clusters_on_device(int* out) {
  const cudaError_t allowed = allow_cluster_stage<AT, M>();
  if (allowed != cudaSuccess) return (int)allowed;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<AT, M>(2, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      out, solve_cluster_kernel<AT, M>, &cfg);
}

template <typename AT, Mode M>
int dispatch(int f, const void* a, const void* diag, const void* b,
             const void* x0, void* x_out, int r, int cg_iters, float cg_tol,
             int grid, cudaStream_t stream) {
  if (f == kWideF)
    return launch_cluster<AT, M>(a, diag, b, x0, x_out, r, cg_iters, cg_tol,
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
  if (f == kWideF) return clusters_on_device<AT, M>(out);
#define CUMF_QUERY(NB) return ring_blocks_per_sm<NB, AT, M>(out)
  CUMF_DISPATCH_NB(f, CUMF_QUERY)
#undef CUMF_QUERY
  return (int)cudaErrorInvalidValue;
}

// The host side of a solve kernel: r systems of f (a multiple of 16 up
// to 128, or 256) in `grid` persistent blocks (`cuda_solve.cg_grid`,
// from blocks_per_sm): 1 <= grid <= r, or at f = 256 an even
// 2 <= grid <= 2 r (a cluster of two a system). a, b, x0 contiguous, on
// 16-byte boundaries. Returns the CUDA error.
template <Mode M>
int run(const void* a, int a_bf16, const void* diag, const void* b,
        const void* x0, void* x_out, int r, int f, int cg_iters,
        float cg_tol, int grid, cudaStream_t stream) {
  const int per = f == kWideF ? 2 : 1;
  if (grid < per || grid % per || grid > per * r)
    return (int)cudaErrorInvalidValue;
  if (a_bf16)
    return dispatch<__nv_bfloat16, M>(f, a, diag, b, x0, x_out, r, cg_iters,
                                      cg_tol, grid, stream);
  return dispatch<float, M>(f, a, diag, b, x0, x_out, r, cg_iters, cg_tol,
                            grid, stream);
}

// The occupancy query beside each kernel: writes to *out (an int) the
// blocks of this kernel at this f and A dtype that one SM of the current
// device takes, or at f = 256 the clusters of two blocks that the whole
// device takes, so the host sizes the persistent grid without a copy of
// the kernel's layout.
template <Mode M>
int blocks_per_sm(int f, int a_bf16, void* out) {
  if (a_bf16) return dispatch_occupancy<__nv_bfloat16, M>(f, (int*)out);
  return dispatch_occupancy<float, M>(f, (int*)out);
}

}  // namespace

}  // namespace bulk
}  // namespace cumf
