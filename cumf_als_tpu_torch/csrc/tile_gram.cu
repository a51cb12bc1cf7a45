// The Gram at factor widths F > 256, f = 128 T lanes (T >= 3), in
// 128 x 128 tiles of A: K2 and K5a there, and pass 1 of K1 and K6 there
// (their pass 2 is global_cg.cu).
//
// Replaces, at f >= 384, the Gram of the TPU kernels `_gram_kernel`
// (K2) and `_gram_kernel_aug` (K5a) of cumf_als_tpu/ops/pallas_solve.py,
// and the Gram half of `_kernel` (K1) and `_kernel_aug` (K6), reached
// through `gather_gram_out`, `gather_gram_aug_out` and `gather_gram_cg`.
// Per row r, over its first n = min(nnz[r], P) slots (all P slots when
// the caller passes no nnz: the panel Grams):
//   A = sum_p g g^T, summed in f32 and written whole (both triangles) in
//       A's dtype (bf16 through round-to-nearest-even, as astype does)
//   b = sum_p v g and r2 = sum_p v^2 in f32, where the caller asks
// With aug the slot's value, rounded to the table's dtype, replaces lane
// f - 1 of its gathered row (the table's own lane f - 1 is zero), so A
// is A' and holds b (row and column f - 1) and sum v^2 (the corner).
//
// Bound on an H100, at the Netflix X panel chunk R = 2304, P = 576,
// f = 384, bf16 table and A: A's 680 MB written, 0.22 ms at 3.35 TB/s
// (f32 A: 0.42 ms); the triangle's products take about as long on the
// bf16 tensor cores. The gathered table rows come from the L2.
//
// A tile (ti, tj) of a row's A is G[:, 128 ti:]^T G[:, 128 tj:] over the
// row's slots: the product of two 128-lane slabs of the gathered rows.
// What held the first design back (one block a tile, the
// `tile_gram_mma` kernel below, which T >= 5 keeps): each of a row's
// T (T + 1) / 2 blocks gathered both of its slabs, so a slot's table row
// crossed from the L2 to an SM T times (9 slabs where 3 do at f = 384);
// one block an SM with nothing to hide its fill and its epilogue, a
// scalar loop of 2-byte stores: 2.6 ms at the shape above, against
// torch.bmm's 0.67 on a gathered G (PERF.md).
//
// The cluster body (`tile_gram_cluster`: a bf16 table, T = 3 or 4). One
// thread-block cluster takes a row of A at a time, persistent, walking
// rows cluster_id, + n_clusters, ... as one stream of 64-slot tiles. Its
// blocks (ops/cuda_solve.py's `cluster_plan`) each own the tile (a, b)
// of two slabs a != b and, for one block of each slab a, the diagonal
// tile (a, a) too; that block gathers slab a of every tile of slots and
// no other block of the row loads it: each slot's table row crosses
// from the L2 to an SM once a row of A. T = 3 is three blocks of two
// tiles, (c, c) and (c, c + 1 mod 3); T = 4 adds two blocks of one tile,
// (0, 2) and (1, 3): six. T = 5 would take ten blocks, past the 8 a
// cluster may portably hold, so the wrapper sends T >= 5 to the
// one-block-a-tile kernel, by f alone.
//  - The gather: cp.async of 16 bytes a thread into gram_mma.cuh's
//    swizzled layout (ids and values 16 bytes at a time where aligned),
//    landing on the stage's `gathered` barrier (cp.async.mbarrier.arrive),
//    four tiles ahead in a ring of six 32 KB stages.
//  - The hand-over: once its slab of a tile has landed (the value over
//    lane 127 of slab T - 1 with aug), the gathering block sends it by
//    two bulk copies of 8 KB (cp.async.bulk.shared::cluster.shared::cta,
//    one from each warpgroup) into the stage of every block of the
//    cluster that reads it, completing on that block's `full` barrier,
//    a tile before it is needed; every wgmma reads only its own block's
//    shared memory. A reader, once its wgmma of a tile is done, arrives
//    on the `empty` barrier of the block it came from, and a gatherer
//    starts a gather into a stage only when every reader has let the
//    stage's last tile go.
//  - The tensor cores: a gathering block's two tiles share slab a, so
//    they are one m64n256k16 wgmma a k-step and warpgroup, B being slabs
//    a and b side by side in the stage; 128 f32 sums a thread.
//  - b over slab a (its gatherer) from the pieces each thread copied, 8
//    lanes by 4 slots, added over the slots in a fixed order; r2 by the
//    gatherer of slab 0.
//  - The epilogue, while the next row's first tiles land: each tile's
//    sums go to shared memory in A's dtype (stmatrix, and stmatrix.trans
//    for the mirror, for a bf16 A) under the TMA's 128-byte swizzle, so
//    that neither the fragment's rows nor its columns meet in a bank,
//    through the stages of the row's last two tiles (their let-go
//    deferred until after it), and out by TMA stores of the tile and its
//    mirror, asynchronous to the next row's tiles.
// What bounds it now (PERF.md, the readings of
// scripts/torch_tile_gram_readings.py): the tensor cores are busy about
// a fifth of the time; the rest is the issue of each tile's gather,
// hand-over and wgmma in the same threads, and the blocks of a row
// waiting on one another's hand-overs and let-gos.
//
// Long rows: the fragment's f32 sums run over at most kSpanTiles tiles
// of slots and are then added, in order, to the row's sums (the first
// span's set them), so a long row (the Netflix X phase has rows of over
// 10^5 slots) is not one running sum of thousands of tensor-core steps:
// the error of those steps grows with their number (PERF.md, the cut of
// K1 at f = 128). The one-block-a-tile kernel keeps those sums in shared
// memory; the cluster body, which has no room for them there, in an f32
// scratch (two tiles a block, in the fragment's order, read back by the
// thread that wrote them) that the wrapper passes when P exceeds
// kSpanTiles tiles.
//
// The one-block-a-tile kernel (a bf16 table at T >= 5): one block owns
// one row and one tile (ti, tj), ti <= tj: T (T + 1) / 2 blocks a row,
// those of one row next to each other in the grid; it gathers both slabs
// through the tile loop of gram_mma.cuh (two tiles a stage, a ring of
// four stages, two in flight), wgmma m64n128k16 with the slab ti tile as
// A^T and the slab tj tile as B, sums flushed every kSpanTiles tiles
// into the tile staged in shared memory; the blocks of ti = 0 write b
// over slab tj, block (0, 0) r2.
// A float32 table: an FMA tile (bf16 tensor cores would round it): one
// block a tile, 32 slots of both slabs staged in f32, each of 256
// threads summing an 8 x 8 block of the tile over every slot; b and r2 a
// tile and the row apart.

#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>

#include "common.cuh"
#include "gram_mma.cuh"

namespace {

using cumf::to_f32;
namespace mma = cumf::mma;

constexpr int kLanes = 128;               // lanes of a slab and of a tile of A
constexpr int kStride = kLanes + 1;       // floats of a staged row of the tile
constexpr int kStages = 4;                // stages of the ring (two tiles each)
constexpr int kAhead = kStages - 2;       // stages of loads in flight
constexpr int kSpanTiles = 32;            // tiles a fragment sums at most
constexpr int kFmaSlots = 32;             // slots of a tile of the FMA body

// Tile (ti, tj) of pair index `pair`, row-major over the upper triangle
// of t x t tiles.
__device__ __forceinline__ void pair_of(int pair, int t, int& ti, int& tj) {
  ti = 0;
  while (pair >= t - ti) {
    pair -= t - ti;
    ++ti;
  }
  tj = ti + pair;
}

// Write the staged tile (kLanes x kStride floats) to A (f x f, row-major)
// at (ti, tj) and, off the diagonal, its transpose at (tj, ti): each row
// of 128 entries by consecutive threads.
template <typename OT>
__device__ __forceinline__ void write_tile(const float* stage, OT* a, int f,
                                           int ti, int tj) {
  for (int i = threadIdx.x; i < kLanes * kLanes; i += cumf::kThreads) {
    const int r = i >> 7, c = i & (kLanes - 1);
    a[(int64_t)(kLanes * ti + r) * f + kLanes * tj + c] =
        cumf::from_f32<OT>(stage[r * kStride + c]);
  }
  if (ti == tj) return;
  for (int i = threadIdx.x; i < kLanes * kLanes; i += cumf::kThreads) {
    const int r = i >> 7, c = i & (kLanes - 1);
    a[(int64_t)(kLanes * tj + r) * f + kLanes * ti + c] =
        cumf::from_f32<OT>(stage[c * kStride + r]);
  }
}

// ------------------------------------------------ bf16 table: wgmma --
struct MmaSmem {
  unsigned char tiles[kStages][2][mma::kTileBytes];  // [stage][slab i, j]
  float acc[kLanes * kStride];  // the tile's sums, f32
  float v[kStages][mma::kSlots];
  float b[3][kLanes];
  float r2[16];
};
constexpr int kMmaSmemBytes = (int)sizeof(MmaSmem) + 1024;

__device__ __forceinline__ MmaSmem& mma_smem(unsigned char* raw) {
  const uintptr_t p = (reinterpret_cast<uintptr_t>(raw) + 1023) &
                      ~static_cast<uintptr_t>(1023);
  return *reinterpret_cast<MmaSmem*>(p);
}

// This thread's part of the fragment (the layout of gram_mma.cuh's head)
// into the staged tile: set by a row's first span, added by the others.
__device__ __forceinline__ void flush(const float (&acc)[64], float* stage,
                                      bool first) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float* d0 = stage + row * kStride + 8 * i + col;
    float* d1 = d0 + 8 * kStride;
    if (first) {
      d0[0] = acc[4 * i];
      d0[1] = acc[4 * i + 1];
      d1[0] = acc[4 * i + 2];
      d1[1] = acc[4 * i + 3];
    } else {
      d0[0] += acc[4 * i];
      d0[1] += acc[4 * i + 1];
      d1[0] += acc[4 * i + 2];
      d1[1] += acc[4 * i + 3];
    }
  }
}

template <bool AUG, typename VT, typename OT>
__global__ void __launch_bounds__(mma::kThreads, 1)
    tile_gram_mma(const __nv_bfloat16* __restrict__ table,
                  const int32_t* __restrict__ cols,
                  const VT* __restrict__ vals,
                  const int32_t* __restrict__ nnz, OT* __restrict__ a_out,
                  float* __restrict__ b_out, float* __restrict__ r2_out,
                  int p, int f) {
  extern __shared__ unsigned char smem_raw[];
  MmaSmem& s = mma_smem(smem_raw);
  const int t = f / kLanes;
  const int pairs = t * (t + 1) / 2;
  const int row = blockIdx.x / pairs;
  int ti, tj;
  pair_of(blockIdx.x - row * pairs, t, ti, tj);
  const bool same = ti == tj;
  const bool with_b = b_out != nullptr && ti == 0;
  const bool with_r2 = r2_out != nullptr && ti == 0 && tj == 0;
  const bool aug_j = AUG && tj == t - 1;  // slab tj holds lane f - 1
  const int n = nnz ? min(__ldg(nnz + row), p) : p;
  const int n_tiles = (n + mma::kSlots - 1) / mma::kSlots;
  const int32_t* row_cols = cols + (int64_t)row * p;
  const VT* row_vals = vals + (int64_t)row * p;

  const int tid = threadIdx.x;
  const int piece = tid & 15;                       // 16 bytes of a slab row
  const int slot0 = (tid >> 4) * mma::kSlotsPerThread;
  const int wg = tid >> 7;
  const bool owner = piece == 15;  // owns its slots' values
  const __nv_bfloat16* src_i = table + kLanes * ti + piece * 8;
  const __nv_bfloat16* src_j = table + kLanes * tj + piece * 8;
  const uint32_t tiles_s = mma::smem_u32(&s.tiles[0][0][0]);

  // the copies of tile q of the row into stage q % kStages (an empty
  // group past the row's tiles) and the owner's values of its slots
  auto start_copies = [&](int q, float (&v)[mma::kSlotsPerThread]) {
#pragma unroll
    for (int i = 0; i < mma::kSlotsPerThread; ++i) v[i] = 0.f;
    if (q < n_tiles) {
      const int lo = q * mma::kSlots;
      const uint32_t base = tiles_s + (q % kStages) * 2 * mma::kTileBytes;
#pragma unroll
      for (int i = 0; i < mma::kSlotsPerThread; ++i) {
        const int slot = slot0 + i;
        const bool live = lo + slot < n;
        const int64_t off =
            live ? (int64_t)__ldg(row_cols + lo + slot) * f : 0;
        const uint32_t dst = base + mma::tile_offset(slot, piece * 8);
        mma::cp_async16(dst, src_i + off, live ? 16 : 0);
        if (!same)
          mma::cp_async16(dst + mma::kTileBytes, src_j + off, live ? 16 : 0);
        if (owner && live) v[i] = to_f32(row_vals[lo + slot]);
      }
    }
    mma::cp_async_commit();
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float b_row[2] = {0.f, 0.f};
  float r2_row = 0.f;
  float v_queue[kAhead][mma::kSlotsPerThread];
#pragma unroll
  for (int a = 0; a < kAhead; ++a) start_copies(a, v_queue[a]);

  for (int span = 0; span < n_tiles; span += kSpanTiles) {
    const int span_end = min(span + kSpanTiles, n_tiles);
    float b_sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [parity][lane]
    float r2_span = 0.f;
    // the tiles of one span; inside this loop nothing but wgmma touches
    // acc (gram_mma.cuh: ptxas would wait for every wgmma otherwise)
    for (int q = span; q < span_end; ++q) {
      const int buf = q % kStages;
      unsigned char* tile_i = s.tiles[buf][0];
      unsigned char* tile_j = same ? tile_i : s.tiles[buf][1];
      mma::cp_async_wait<kAhead - 1>();  // this thread's copies of tile q
      if (owner) {
        float sq = 0.f;
#pragma unroll
        for (int i = 0; i < mma::kSlotsPerThread; ++i) {
          const float v = v_queue[0][i];
          s.v[buf][slot0 + i] = v;
          sq = fmaf(v, v, sq);
          if (aug_j)
            *reinterpret_cast<__nv_bfloat16*>(
                tile_j + mma::tile_offset(slot0 + i, kLanes - 1)) =
                __float2bfloat16(v);
        }
        r2_span += sq;
      }
      mma::fence_proxy_async();
      // Tile q is whole; every thread has left the wgmma wait of tile
      // q - 1, so the wgmma of tile q - 2 is done and its stage is free.
      __syncthreads();
      float v_new[mma::kSlotsPerThread];
      start_copies(q + kAhead, v_new);

      const int k_steps = (min(mma::kSlots, n - q * mma::kSlots) + 15) / 16;
      const uint32_t base_i = mma::smem_u32(tile_i);
      const uint32_t base_j = mma::smem_u32(tile_j);
      mma::wgmma_fence();
      for (int k = 0; k < k_steps; ++k)
        mma::wgmma_m64n128k16(
            acc,
            mma::descriptor(base_i + wg * mma::kHalfBytes +
                            k * mma::kKStepBytes),
            mma::descriptor(base_j + k * mma::kKStepBytes),
            q > span || k > 0);
      mma::wgmma_commit();
      if (with_b) {
        // b over slab tj: this thread's two lanes over its quarter of the
        // tile's slots (gram_mma.cuh's gram_stream)
        const int lanes = 2 * (tid & (kLanes / 2 - 1));
        const int first_atom = (tid >> 6) * (mma::kSlots / 32);
        const int last_atom = min(first_atom + mma::kSlots / 32, 2 * k_steps);
        for (int atom = first_atom; atom < last_atom; ++atom) {
          const float4 va =
              *reinterpret_cast<const float4*>(&s.v[buf][8 * atom]);
          const float4 vb =
              *reinterpret_cast<const float4*>(&s.v[buf][8 * atom + 4]);
          const float v8[8] = {va.x, va.y, va.z, va.w,
                               vb.x, vb.y, vb.z, vb.w};
          const unsigned char* g = tile_j + atom * (8 * mma::kLine);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint32_t pair = *reinterpret_cast<const uint32_t*>(
                g + mma::tile_offset(j, lanes));
            b_sum[j & 1][0] =
                fmaf(v8[j], __uint_as_float(pair << 16), b_sum[j & 1][0]);
            b_sum[j & 1][1] = fmaf(
                v8[j], __uint_as_float(pair & 0xffff0000u), b_sum[j & 1][1]);
          }
        }
      }
      mma::wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < mma::kSlotsPerThread; ++i) {
#pragma unroll
        for (int a = 0; a + 1 < kAhead; ++a) v_queue[a][i] = v_queue[a + 1][i];
        v_queue[kAhead - 1][i] = v_new[i];
      }
    }
    mma::wgmma_wait<0>();
    mma::use_acc(acc);
    flush(acc, s.acc, span == 0);
    b_row[0] += b_sum[0][0] + b_sum[1][0];
    b_row[1] += b_sum[0][1] + b_sum[1][1];
    r2_row += r2_span;
  }
  mma::cp_async_wait<0>();
  if (n_tiles == 0) flush(acc, s.acc, true);  // acc holds zeros

  if (with_b) {
    // the four quarters of the slots, added in a fixed order
    const int lanes = 2 * (tid & (kLanes / 2 - 1));
    const int quarter = tid >> 6;
    if (quarter > 0)
      *reinterpret_cast<float2*>(&s.b[quarter - 1][lanes]) =
          make_float2(b_row[0], b_row[1]);
    __syncthreads();
    if (quarter == 0) {
      float2 sum = make_float2(b_row[0], b_row[1]);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        sum.x += s.b[k][lanes];
        sum.y += s.b[k][lanes + 1];
      }
      *reinterpret_cast<float2*>(b_out + (int64_t)row * f + kLanes * tj +
                                 lanes) = sum;
    }
  }
  if (with_r2) {
    if (owner) s.r2[tid >> 4] = r2_row;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
      for (int k = 0; k < 16; ++k) sum += s.r2[k];
      r2_out[row] = sum;
    }
  }
  __syncthreads();
  write_tile<OT>(s.acc, a_out + (int64_t)row * f * f, f, ti, tj);
}

// --------------------------------------------- float32 table: FMA --
struct FmaSmem {
  union {
    struct {
      float gi[kFmaSlots][kLanes];
      float gj[kFmaSlots][kLanes];
    } g;
    float acc[kLanes * kStride];
  } u;
  float v[kFmaSlots];
  int32_t c[kFmaSlots];
};
constexpr int kFmaSmemBytes = (int)sizeof(FmaSmem);

template <bool AUG, typename VT, typename OT>
__global__ void __launch_bounds__(cumf::kThreads)
    tile_gram_fma(const float* __restrict__ table,
                  const int32_t* __restrict__ cols,
                  const VT* __restrict__ vals,
                  const int32_t* __restrict__ nnz, OT* __restrict__ a_out,
                  float* __restrict__ b_out, float* __restrict__ r2_out,
                  int p, int f) {
  extern __shared__ __align__(16) unsigned char fma_raw[];
  FmaSmem& s = *reinterpret_cast<FmaSmem*>(fma_raw);
  const int t = f / kLanes;
  const int pairs = t * (t + 1) / 2;
  const int row = blockIdx.x / pairs;
  int ti, tj;
  pair_of(blockIdx.x - row * pairs, t, ti, tj);
  const bool with_b = b_out != nullptr && ti == 0;
  const bool with_r2 = r2_out != nullptr && ti == 0 && tj == 0;
  const bool aug_i = AUG && ti == t - 1;
  const bool aug_j = AUG && tj == t - 1;
  const int n = nnz ? min(__ldg(nnz + row), p) : p;
  const int32_t* row_cols = cols + (int64_t)row * p;
  const VT* row_vals = vals + (int64_t)row * p;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  // thread (ty, tx) sums A_tile[ty + 16 k][8 tx + l], k, l < 8
  float a[8][8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int l = 0; l < 8; ++l) a[k][l] = 0.f;
  float b_row = 0.f, r2_row = 0.f;  // threads tid < 128 and tid == 128
  for (int lo = 0; lo < n; lo += kFmaSlots) {
    const int nt = min(kFmaSlots, n - lo);
    if (tid < nt) {
      s.c[tid] = row_cols[lo + tid];
      s.v[tid] = to_f32(row_vals[lo + tid]);
    }
    __syncthreads();
    // both slabs of the tile's slots, a float4 a thread at a time
    for (int i = tid; i < nt * (kLanes / 4); i += cumf::kThreads) {
      const int slot = i >> 5, q = (i & 31) * 4;
      const float* src = table + (int64_t)s.c[slot] * f + q;
      float4 gi = *reinterpret_cast<const float4*>(src + kLanes * ti);
      float4 gj = *reinterpret_cast<const float4*>(src + kLanes * tj);
      if (q == kLanes - 4) {
        if (aug_i) gi.w = s.v[slot];
        if (aug_j) gj.w = s.v[slot];
      }
      *reinterpret_cast<float4*>(&s.u.g.gi[slot][q]) = gi;
      *reinterpret_cast<float4*>(&s.u.g.gj[slot][q]) = gj;
    }
    __syncthreads();
    for (int slot = 0; slot < nt; ++slot) {
      float gi[8], gj[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) gi[k] = s.u.g.gi[slot][ty + 16 * k];
      const float4 g0 =
          *reinterpret_cast<const float4*>(&s.u.g.gj[slot][8 * tx]);
      const float4 g1 =
          *reinterpret_cast<const float4*>(&s.u.g.gj[slot][8 * tx + 4]);
      gj[0] = g0.x; gj[1] = g0.y; gj[2] = g0.z; gj[3] = g0.w;
      gj[4] = g1.x; gj[5] = g1.y; gj[6] = g1.z; gj[7] = g1.w;
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int l = 0; l < 8; ++l) a[k][l] = fmaf(gi[k], gj[l], a[k][l]);
    }
    // b and r2: this tile's sums apart, then the row's
    if (with_b && tid < kLanes) {
      float sum = 0.f;
      for (int slot = 0; slot < nt; ++slot)
        sum = fmaf(s.v[slot], s.u.g.gj[slot][tid], sum);
      b_row += sum;
    } else if (with_r2 && tid == kLanes) {
      float sum = 0.f;
      for (int slot = 0; slot < nt; ++slot)
        sum = fmaf(s.v[slot], s.v[slot], sum);
      r2_row += sum;
    }
    __syncthreads();
  }
  if (with_b && tid < kLanes)
    b_out[(int64_t)row * f + kLanes * tj + tid] = b_row;
  if (with_r2 && tid == kLanes) r2_out[row] = r2_row;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int l = 0; l < 8; ++l)
      s.u.acc[(ty + 16 * k) * kStride + 8 * tx + l] = a[k][l];
  __syncthreads();
  write_tile<OT>(s.u.acc, a_out + (int64_t)row * f * f, f, ti, tj);
}

// ------------------------------- bf16 table, T = 3 or 4: clusters --
constexpr int kMaxBlocks = 8;   // blocks of a cluster (the portable most)
constexpr int kRing = 6;        // stages of a block's ring
constexpr int kLead = 4;        // tiles the gather runs ahead
constexpr int kSwizzle = 128;   // bytes of a row of a TMA box (128B swizzle)
constexpr int kFragFloat4 = 64 / 4 * mma::kThreads;  // a tile's fragment

// The cluster's blocks, by rank (ops/cuda_solve.py's cluster_plan): block
// d owns the tile (a[d], b[d]) of A and, where diag[d], also (a[d], a[d])
// and the gather of slab a[d].
struct Plan {
  int blocks;
  signed char a[kMaxBlocks];
  signed char b[kMaxBlocks];
  signed char diag[kMaxBlocks];
};

struct ClusterSmem {
  // [stage][slab a, b]; the stages of a row's last two tiles also stage
  // its A on the way out
  unsigned char slabs[kRing][2][mma::kTileBytes];
  float v[kRing][mma::kSlots];  // the gathered tiles' values
  // (a gatherer, with b) a tile's b by groups of 4 slots, two tiles apart
  float b_part[2][mma::kSlots / mma::kSlotsPerThread][kLanes];
  float r2[16];
  uint64_t gathered[kRing];  // (a gatherer) its slab of the stage landed
  uint64_t full[kRing];      // the stage's slabs from other blocks landed
  uint64_t empty[kRing];     // (a gatherer) its readers let the stage go
  // (a gatherer) the blocks that read slab a, and where it goes in each
  int reader[kMaxBlocks], reader_at[kMaxBlocks], readers;
};
constexpr int kClusterSmemBytes = (int)sizeof(ClusterSmem) + 1024;

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
// Every thread of every block of the cluster; the shared memory each
// wrote before is seen by all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address in block `rank` of the cluster of this block's shared
// address `addr`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   mma::smem_u32(bar)),
               "r"(count)
               : "memory");
}
// One arrival that also expects `bytes` of copies on the barrier.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          mma::smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// One arrival on the barrier at cluster address `addr`. It orders no
// memory: what it reports (a wgmma's reads done) is complete already.
__device__ __forceinline__ void bar_arrive(uint32_t addr) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed. The
// bytes that complete a barrier are TMA loads and bulk copies, seen by
// the threads that wait on it as a TMA load's tile is. A wait that never
// completes (a fault of this code, not of the data) ends the kernel with
// an error after some 2^24 tries instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = mma::smem_u32(bar);
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
// Half a slab (64 slots x 64 lanes, 8 KB) from this block's shared
// address `src` to cluster address `dst`, completing on the barrier at
// cluster address `bar`.
__device__ __forceinline__ void send_half(uint32_t dst, uint32_t src,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"((uint32_t)mma::kHalfBytes), "r"(bar)
      : "memory");
}
// The TMA: this block's shared memory at `src` into box (x, y) of `map`.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int x, int y,
                                          uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], "
      "[%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(x), "r"(y), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's TMA stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// this thread's TMA stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// 4 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// One arrival on `bar` once this thread's cp.async copies so far have
// landed (the barrier counts it among its expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   mma::smem_u32(bar))
               : "memory");
}
// Four 8 x 8 matrices of bf16 pairs from the warp's fragments into shared
// memory, row i of matrix m at the address lane 8 m + i gives; with
// TRANS, each matrix transposed.
template <bool TRANS>
__device__ __forceinline__ void stmatrix4(uint32_t addr, uint32_t m0,
                                          uint32_t m1, uint32_t m2,
                                          uint32_t m3) {
  if constexpr (TRANS)
    asm volatile(
        "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
        "%4};\n" ::"r"(addr),
        "r"(m0), "r"(m1), "r"(m2), "r"(m3)
        : "memory");
  else
    asm volatile(
        "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
            "r"(addr),
        "r"(m0), "r"(m1), "r"(m2), "r"(m3)
        : "memory");
}
__device__ __forceinline__ uint32_t bf16_pair(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Byte offset of entry (r, c) in a box of 128-byte rows under the
// TMA's 128-byte swizzle (16-byte column j of row r at j ^ (r % 8)),
// entries of `size` bytes.
__device__ __forceinline__ int box_at(int r, int c, int size) {
  const int byte = c * size;
  return r * kSwizzle + ((((byte >> 4) ^ r) & 7) << 4) + (byte & 15);
}

template <typename OT>
__device__ __forceinline__ void put2(unsigned char* p, float x, float y);
template <>
__device__ __forceinline__ void put2<float>(unsigned char* p, float x,
                                            float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void put2<__nv_bfloat16>(unsigned char* p, float x,
                                                    float y) {
  // round to nearest even, as astype does
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// This thread's part of a tile's fragment (the layout of gram_mma.cuh's
// head; the tile's 64 sums from OFF on in acc) into its scratch, a row of several spans' sums before its last
// span: set by the row's first span, added to by the others. The scratch
// holds the fragment in its own order, float4 i of thread t at i * 256 +
// t, so that a warp's stores are whole 512-byte lines.
template <int OFF, int N>
__device__ __forceinline__ void flush_span(const float (&acc)[N],
                                           float4* scratch, bool first) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float4* d = scratch + i * mma::kThreads + tid;
    float4 x = make_float4(acc[OFF + 4 * i], acc[OFF + 4 * i + 1],
                           acc[OFF + 4 * i + 2], acc[OFF + 4 * i + 3]);
    if (!first) {
      const float4 y = *d;
      x = make_float4(y.x + x.x, y.y + x.y, y.z + x.z, y.w + x.w);
    }
    *d = x;
    // one load in flight at a time: the sums already hold most registers
    asm volatile("" ::: "memory");
  }
}

// The rows [r0, r0 + CH) of a tile of a row's A (CH: 128 rows of bf16,
// 64 of f32, 32 KB), from the fragments of the threads that hold them
// (the tile's 64 sums from OFF on in acc)
// (the row's sums: the fragment, added to the earlier spans' in
// `scratch` where that is not null), into shared memory in A's dtype as
// the TMA stores take them, under the 128-byte swizzle, so that neither
// the fragment's rows nor its columns meet in a bank: the rows at
// `rows_st` as 128 / W boxes of CH rows x 128 bytes (W entries), the
// mirror (a diagonal tile has none) at `mirror_st` as CH / W boxes of
// 128 rows (the tile's columns) x W entries.
template <typename OT, int OFF, int N>
__device__ __forceinline__ void stage_rows(const float (&acc)[N],
                                           const float4* scratch,
                                           bool mirrored, int r0,
                                           unsigned char* rows_st,
                                           unsigned char* mirror_st) {
  constexpr int kSize = (int)sizeof(OT);
  constexpr int W = kSwizzle / kSize;
  constexpr int CH = 2 * mma::kTileBytes / (kLanes * kSize);
  constexpr int kMirrorBox = kLanes * kSwizzle;  // bytes of a mirror box
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  if constexpr (kSize == 2) {
    // bf16: the warp's 16 rows, two 8-column blocks a step, by stmatrix
    // (its fragment is the wgmma fragment's); lane 8 m + j names row j
    // of matrix m: rows 8 (m % 2) .. of column block i + m / 2, and, for
    // the mirror, row j of that block's transpose
    const int wrow = row - (lane >> 2) - r0;  // the warp's first row here
    if (wrow < 0 || wrow >= CH) return;
    const int m = lane >> 3, j = lane & 7;
    const int rr = wrow + 8 * (m & 1);
    const uint32_t rows_s = mma::smem_u32(rows_st);
    const uint32_t mirror_s = mma::smem_u32(mirror_st) +
                              (rr / W) * kMirrorBox;
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      float x[8];
#pragma unroll
      for (int k = 0; k < 8; k += 4) {
        float4 v = make_float4(acc[OFF + 4 * i + k], acc[OFF + 4 * i + k + 1],
                               acc[OFF + 4 * i + k + 2],
                               acc[OFF + 4 * i + k + 3]);
        if (scratch) {
          const float4 y = scratch[(i + k / 4) * mma::kThreads + tid];
          v = make_float4(y.x + v.x, y.y + v.y, y.z + v.z, y.w + v.w);
        }
        x[k] = v.x;
        x[k + 1] = v.y;
        x[k + 2] = v.z;
        x[k + 3] = v.w;
      }
      const uint32_t p0 = bf16_pair(x[0], x[1]), p1 = bf16_pair(x[2], x[3]);
      const uint32_t p2 = bf16_pair(x[4], x[5]), p3 = bf16_pair(x[6], x[7]);
      const int c = 8 * (i + (m >> 1));
      stmatrix4<false>(rows_s + (c / W) * CH * kSwizzle +
                           box_at(rr + j, c % W, kSize),
                       p0, p1, p2, p3);
      if (mirrored)
        stmatrix4<true>(mirror_s + box_at(c + j, rr % W, kSize), p0, p1, p2,
                        p3);
    }
    return;
  }
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float4 x = make_float4(acc[OFF + 4 * i], acc[OFF + 4 * i + 1],
                           acc[OFF + 4 * i + 2], acc[OFF + 4 * i + 3]);
    if (scratch) {
      const float4 y = scratch[i * mma::kThreads + tid];
      x = make_float4(y.x + x.x, y.y + x.y, y.z + x.z, y.w + x.w);
    }
    const int c = 8 * i + col;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h - r0;
      if (r < 0 || r >= CH) continue;
      const float e0 = h ? x.z : x.x, e1 = h ? x.w : x.y;
      put2<OT>(rows_st + (c / W) * CH * kSwizzle + box_at(r, c % W, kSize),
               e0, e1);
      if (!mirrored) continue;
      unsigned char* mb = mirror_st + (r / W) * kMirrorBox;
      *reinterpret_cast<OT*>(mb + box_at(c, r % W, kSize)) =
          cumf::from_f32<OT>(e0);
      *reinterpret_cast<OT*>(mb + box_at(c + 1, r % W, kSize)) =
          cumf::from_f32<OT>(e1);
    }
    asm volatile("" ::: "memory");  // as in flush_span
  }
}

// Zeros into tile (ti, tj) of a row's A and, off the diagonal, its
// mirror (a row without slots), 16 bytes a thread at a time.
template <typename OT>
__device__ __forceinline__ void zero_tile(OT* a_row, int f, int ti, int tj) {
  constexpr int E = 16 / (int)sizeof(OT);  // entries a store
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < kLanes * kLanes / E; i += mma::kThreads) {
    const int r = i / (kLanes / E), c = (i % (kLanes / E)) * E;
    *reinterpret_cast<uint4*>(a_row + (int64_t)(kLanes * ti + r) * f +
                              kLanes * tj + c) = z;
    if (ti != tj)
      *reinterpret_cast<uint4*>(a_row + (int64_t)(kLanes * tj + r) * f +
                                kLanes * ti + c) = z;
  }
}

// The rows of this cluster, as block `me` of `plan`: GATHER for the
// blocks that gather their slab a and own (a, a) and (a, b), else the
// blocks that own (a, b) alone and gather nothing.
template <bool AUG, typename OT, bool GATHER>
__device__ __forceinline__ void cluster_rows(
    ClusterSmem& s, const Plan& plan, int me,
    const __nv_bfloat16* __restrict__ table, const CUtensorMap& rows_map,
    const CUtensorMap& cols_map, OT* __restrict__ a_out,
    const int32_t* __restrict__ cols, const float* __restrict__ vals,
    const int32_t* __restrict__ nnz, float* __restrict__ b_out,
    float* __restrict__ r2_out, float* __restrict__ scratch, int p, int rows,
    int f) {
  constexpr int NT = GATHER ? 2 : 1;  // tiles of A this block owns
  // entries of a 128-byte row of a TMA box, and the rows of A a staged
  // chunk holds (32 KB of them)
  constexpr int W = kSwizzle / (int)sizeof(OT);
  constexpr int CH = 2 * mma::kTileBytes / (kLanes * (int)sizeof(OT));
  const int t = f / kLanes;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  // this block's fields of the plan, the gatherers of slabs a and b and
  // the blocks that read slab a, all by constant indices (a dynamic one
  // would copy the plan into local memory)
  int slab_a = 0, slab_b = 0;
#pragma unroll
  for (int d = 0; d < kMaxBlocks; ++d)
    if (d == me) {
      slab_a = plan.a[d];
      slab_b = plan.b[d];
    }
  int src_a = 0, src_b = 0, readers = 0;
#pragma unroll
  for (int d = 0; d < kMaxBlocks; ++d) {
    if (d >= plan.blocks) break;
    if (plan.diag[d] && plan.a[d] == slab_a) src_a = d;
    if (plan.diag[d] && plan.a[d] == slab_b) src_b = d;
    if (d != me && (plan.a[d] == slab_a || plan.b[d] == slab_a)) ++readers;
  }
  // the gather, as gram_mma.cuh's: 16 threads copy a slot's 256-byte
  // table row, 16 bytes each, each thread 4 slots of a tile; the thread
  // with the last piece owns the slots' values
  const int piece = tid & 15;
  const int slot0 = (tid >> 4) * mma::kSlotsPerThread;
  const bool owner = piece == 15;
  // (with aug, A' holds b and r2)
  const bool with_b = !AUG && GATHER && b_out != nullptr;
  const bool with_r2 = !AUG && GATHER && r2_out != nullptr && slab_a == 0;
  const bool aug_lane = AUG && GATHER && slab_a == t - 1;
  const int first_row = (int)cluster_index();
  const int row_step = (int)cluster_count();
  const uint32_t slabs_s = mma::smem_u32(&s.slabs[0][0][0]);

  if (tid == 0) {
    s.readers = 0;
#pragma unroll
    for (int d = 0; d < kMaxBlocks; ++d) {
      if (d >= plan.blocks) break;
      const int at = plan.a[d] == slab_a ? 0 : plan.b[d] == slab_a ? 1 : -1;
      if (d == me || at < 0) continue;
      s.reader[s.readers] = d;
      s.reader_at[s.readers++] = at;
    }
    for (int i = 0; i < kRing; ++i) {
      bar_init(&s.full[i], 1);
      if (GATHER) {
        // every thread's copies
        bar_init(&s.gathered[i], mma::kThreads);
        // both warpgroups of each reader arrive
        bar_init(&s.empty[i], 2 * readers);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers are ready for its peers
  const uint32_t empty_a = peer_addr(mma::smem_u32(&s.empty[0]), src_a);
  const uint32_t empty_b = peer_addr(mma::smem_u32(&s.empty[0]), src_b);
  // (one thread of each warpgroup) tile j is done here: let its stage go
  // in the blocks it came from
  auto let_go = [&](int j) {
    const uint32_t off = 8 * (j % kRing);
    bar_arrive(empty_b + off);
    if (!GATHER) bar_arrive(empty_a + off);
  };

  auto row_len = [&](int row) {
    return nnz ? min(__ldg(nnz + row), p) : p;
  };
  // the tiles of this cluster's stream
  int total = 0;
  for (int row = first_row; row < rows; row += row_step)
    total += (row_len(row) + mma::kSlots - 1) / mma::kSlots;


  // The gather (GATHER only), as gram_mma.cuh's gram_stream walks its
  // rows: a place in the stream is a tile of row `row`, which holds slots
  // [first, first + n) of cols and vals (n: the row's slots left); past
  // the stream row >= rows and n = 0.
  struct Cursor {
    int row, n, first;
  };
  auto enter_row = [&](Cursor& c) {
    for (;; c.row += row_step) {
      c.first = c.row * p;
      c.n = c.row < rows ? row_len(c.row) : 0;
      if (c.n > 0 || c.row >= rows) return;
    }
  };
  auto step = [&](Cursor& c) {
    c.first += mma::kSlots;
    c.n -= mma::kSlots;
    if (c.n <= 0) {
      c.row += row_step;
      enter_row(c);
    }
  };
  // whether cols and vals start on 16-byte boundaries (a row batch's
  // slice need not)
  const bool cols16 = (reinterpret_cast<uintptr_t>(cols) & 15) == 0;
  const bool vals16 = (reinterpret_cast<uintptr_t>(vals) & 15) == 0;
  // the ids of a tile's slots, -1 past them (one 16-byte load where the
  // four are live and 16-byte aligned)
  auto load_ids = [&](const Cursor& c, int (&id)[mma::kSlotsPerThread]) {
    if (cols16 && slot0 + 3 < c.n && ((c.first + slot0) & 3) == 0) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(cols + c.first +
                                                          slot0));
      id[0] = v.x;
      id[1] = v.y;
      id[2] = v.z;
      id[3] = v.w;
      return;
    }
#pragma unroll
    for (int i = 0; i < mma::kSlotsPerThread; ++i)
      id[i] = slot0 + i < c.n ? __ldg(cols + c.first + slot0 + i) : -1;
  };
  const __nv_bfloat16* src_row = table + kLanes * slab_a + piece * 8;
  // the copies of tile j into its stage, landing on its `gathered`
  // barrier (nothing past the stream): slots past the row's zeros
  auto start_copies = [&](int j, const Cursor& c,
                          const int (&id)[mma::kSlotsPerThread]) {
    if (c.row >= rows) return;
    const int buf = j % kRing;
    const uint32_t base = slabs_s + buf * 2 * mma::kTileBytes;
#pragma unroll
    for (int i = 0; i < mma::kSlotsPerThread; ++i) {
      const bool live = id[i] >= 0;
      mma::cp_async16(base + mma::tile_offset(slot0 + i, piece * 8),
                      src_row + (int64_t)(live ? id[i] : 0) * f,
                      live ? 16 : 0);
    }
    if (owner) {
      // the four values, in one copy where they are live and aligned
      const uint32_t dst = mma::smem_u32(&s.v[buf][slot0]);
      if (vals16 && slot0 + 3 < c.n && ((c.first + slot0) & 3) == 0) {
        mma::cp_async16(dst, vals + c.first + slot0, 16);
      } else {
#pragma unroll
        for (int i = 0; i < mma::kSlotsPerThread; ++i) {
          const bool live = slot0 + i < c.n;
          cp_async4(dst + 4 * i, vals + (live ? c.first + slot0 + i : 0),
                    live ? 4 : 0);
        }
      }
    }
    cp_async_arrive(&s.gathered[buf]);
  };
  // with aug, the owners' values over lane 127 of slab T - 1 (landed)
  auto value_lane = [&](int buf) {
    if constexpr (AUG && GATHER) {
      if (!(aug_lane && owner)) return;
#pragma unroll
      for (int i = 0; i < mma::kSlotsPerThread; ++i)
        *reinterpret_cast<__nv_bfloat16*>(
            &s.slabs[buf][0][mma::tile_offset(slot0 + i, kLanes - 1)]) =
            __float2bfloat16(s.v[buf][slot0 + i]);
    }
  };
  // (thread 0 of each warpgroup, once the block's copies and value lane
  // are in) tile j's slab a, whole in this block's stage, to every other
  // block that reads it: half wg of it a warpgroup
  auto hand_over = [&](int j) {
    const int buf = j % kRing;
    const uint32_t src =
        slabs_s + buf * 2 * mma::kTileBytes + wg * mma::kHalfBytes;
    const uint32_t full = mma::smem_u32(&s.full[buf]);
#pragma unroll 1
    for (int k = 0; k < s.readers; ++k)
      send_half(peer_addr(src + s.reader_at[k] * mma::kTileBytes,
                          s.reader[k]),
                src, peer_addr(full, s.reader[k]));
  };

  Cursor ahead;  // the tile whose gather starts next
  int id[mma::kSlotsPerThread];
  if constexpr (GATHER) {
    ahead.row = first_row;
    enter_row(ahead);
#pragma unroll 1
    for (int j = 0; j < kLead; ++j) {
      load_ids(ahead, id);
      start_copies(j, ahead, id);
      step(ahead);
    }
    load_ids(ahead, id);
    if (total > 0) {
      bar_wait(&s.gathered[0], 0);
      value_lane(0);
    }
    mma::fence_proxy_async();
    __syncthreads();
    if ((tid & 127) == 0 && total > 0) hand_over(0);
  }

  // Nothing but wgmma touches acc inside the loop over a span's tiles: a
  // span's first wgmma overwrites it (gram_mma.cuh: ptxas would wait for
  // every wgmma otherwise).
  // (a gatherer's two tiles are one m64n256 fragment: (a, a) in sums
  // 0 .. 63, (a, b) in 64 .. 127)
  float acc[NT * 64];
#pragma unroll
  for (int i = 0; i < NT * 64; ++i) acc[i] = 0.f;
  float4* my_scratch =
      reinterpret_cast<float4*>(scratch) + (size_t)blockIdx.x * 2 * kFragFloat4;

  int q = 0;  // the stream tile the tensor cores take next
  for (int row = first_row; row < rows; row += row_step) {
    const int n = row_len(row);
    const int n_tiles = (n + mma::kSlots - 1) / mma::kSlots;
    const bool multi = n_tiles > kSpanTiles;
    // b of lane tid < 128 over the row, over a span; r2 of each owner's
    // slots (threads tid < 128 add a tile's b groups once a barrier has
    // passed since they were written: `pending`, the tile's parity, or -1)
    float b_row = 0.f, r2_row = 0.f;
    int pending = -1;
    auto add_b = [&](float& b_span) {
      if (tid < kLanes && pending >= 0) {
        float sum = 0.f;
#pragma unroll
        for (int g = 0; g < mma::kSlots / mma::kSlotsPerThread; ++g)
          sum += s.b_part[pending][g][tid];
        b_span += sum;
      }
      pending = -1;
    };
    for (int span = 0; span < n_tiles; span += kSpanTiles) {
      const int span_end = min(span + kSpanTiles, n_tiles);
      float b_span = 0.f, r2_span = 0.f;
      // the tiles of one span; inside this loop nothing but wgmma
      // touches acc
      for (int tile = span; tile < span_end; ++tile, ++q) {
        const int buf = q % kRing;
        if constexpr (GATHER) {
          // this block's slab of tile q + 1 has landed: hand it over
          if (q + 1 < total) {
            bar_wait(&s.gathered[(q + 1) % kRing], ((q + 1) / kRing) & 1);
            value_lane((q + 1) % kRing);
          }
          mma::fence_proxy_async();
          // every thread has left the wgmma wait of tile q - 1, so the
          // wgmma of tile q - 2 is done in this block
          __syncthreads();
          if ((tid & 127) == 0 && q + 1 < total) hand_over(q + 1);
          if (with_b) add_b(b_span);
        }
        if constexpr (GATHER) {
          // the gather of tile j = q + kLead into the stage of tile
          // j - kRing, once every reader has let that one go
          const int j = q + kLead;
          if (j < total && j >= kRing)
            bar_wait(&s.empty[j % kRing], ((j - kRing) / kRing) & 1);
          start_copies(j, ahead, id);
          step(ahead);
          load_ids(ahead, id);
        }
        // the slabs of tile q from the other blocks
        if (tid == 0)
          bar_expect(&s.full[buf], (GATHER ? 1 : 2) * mma::kTileBytes);
        bar_wait(&s.full[buf], (q / kRing) & 1);

        const int k_steps =
            (min(mma::kSlots, n - tile * mma::kSlots) + 15) / 16;
        const uint32_t base = slabs_s + buf * 2 * mma::kTileBytes;
        mma::wgmma_fence();
        for (int k = 0; k < k_steps; ++k) {
          const uint64_t da = mma::descriptor(base + wg * mma::kHalfBytes +
                                              k * mma::kKStepBytes);
          const uint64_t db = mma::descriptor(base + mma::kTileBytes +
                                              k * mma::kKStepBytes);
          const int add = tile > span || k > 0;
          if constexpr (GATHER)  // B: slabs a and b, 256 lanes
            mma::wgmma_m64n256k16(
                acc, da, mma::descriptor(base + k * mma::kKStepBytes), add);
          else
            mma::wgmma_m64n128k16(acc, da, db, add);
        }
        mma::wgmma_commit();
        if constexpr (GATHER) {
          if (with_r2 && owner) {
            // the owners' four slots each, as gram_mma.cuh's
            float sq = 0.f;
#pragma unroll
            for (int i = 0; i < mma::kSlotsPerThread; ++i)
              sq = fmaf(s.v[buf][slot0 + i], s.v[buf][slot0 + i], sq);
            r2_span += sq;
          }
          if (with_b) {
            // b over slab a: this thread's 8 lanes (the piece it
            // gathered) over its 4 slots, in slot order, as the b group
            // of those slots (slots past the row are zeros)
            const float4 v4 =
                *reinterpret_cast<const float4*>(&s.v[buf][slot0]);
            const float v[4] = {v4.x, v4.y, v4.z, v4.w};
            float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int i = 0; i < mma::kSlotsPerThread; ++i) {
              const uint4 g = *reinterpret_cast<const uint4*>(
                  &s.slabs[buf][0][mma::tile_offset(slot0 + i, piece * 8)]);
              const uint32_t w[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                // two bf16, the lower lane in the low half
                part[2 * k] = fmaf(v[i], __uint_as_float(w[k] << 16),
                                   part[2 * k]);
                part[2 * k + 1] = fmaf(
                    v[i], __uint_as_float(w[k] & 0xffff0000u), part[2 * k + 1]);
              }
            }
            float* dst = &s.b_part[q & 1][tid >> 4][piece * 8];
            *reinterpret_cast<float4*>(dst) =
                make_float4(part[0], part[1], part[2], part[3]);
            *reinterpret_cast<float4*>(dst + 4) =
                make_float4(part[4], part[5], part[6], part[7]);
            pending = q & 1;
          }
        }
        mma::wgmma_wait<1>();
        // tile q - 1 is done in this warpgroup: let its stage go in the
        // blocks it came from
        // (at a row's last tile the epilogue stages A in the stage of
        // tile q - 1 too: it goes after the epilogue)
        if ((tid & 127) == 0 && q > 0 && tile + 1 < n_tiles)
          let_go(q - 1);
      }
      mma::wgmma_wait<0>();
      mma::use_acc(acc);
      if (multi && span_end < n_tiles) {
        flush_span<0>(acc, my_scratch, span == 0);
        if constexpr (NT == 2)
          flush_span<64>(acc, my_scratch + kFragFloat4, span == 0);
      }
      if (with_b) {
        __syncthreads();  // the span's last b groups are in
        add_b(b_span);
      }
      b_row += b_span;
      r2_row += r2_span;
    }

    // The row's epilogue, while the next row's first tiles land: A out
    // by TMA stores through the stages of its last two tiles, the rows of
    // a chunk of CH rows in one and their mirror in the other (free until
    // this block lets them go: the stage of tile q - 2 after the
    // epilogue, that of q - 1 at its next tile; before the first tile the
    // last stage, which holds no gather yet); a row without slots is
    // zeros, stored as they are.
    if (n_tiles == 0) {
#pragma unroll
      for (int k = 0; k < NT; ++k)
        zero_tile<OT>(a_out + (int64_t)row * f * f, f, slab_a,
                      GATHER && k == 0 ? slab_a : slab_b);
    } else {
      unsigned char* rows_st = s.slabs[(q + kRing - 1) % kRing][0];
      unsigned char* mirror_st = s.slabs[(q + kRing - 2) % kRing][0];
      const uint32_t rows_s = mma::smem_u32(rows_st);
      const uint32_t mirror_s = mma::smem_u32(mirror_st);
      const int y0 = row * f;  // A's rows of this row of A
      // tile k of this block's, its sums from 64 k on in acc
      auto out_tile = [&](auto tile_k) {
        constexpr int k = decltype(tile_k)::value;
        const int ti = slab_a, tj = GATHER && k == 0 ? slab_a : slab_b;
#pragma unroll 1
        for (int r0 = 0; r0 < kLanes; r0 += CH) {
          if (tid == 0) bulk_wait_read();  // the last chunk has left
          __syncthreads();
          stage_rows<OT, 64 * k>(
              acc, multi ? my_scratch + k * kFragFloat4 : nullptr, ti != tj,
              r0, rows_st, mirror_st);
          mma::fence_proxy_async();
          __syncthreads();
          if (tid == 0) {
#pragma unroll
            for (int box = 0; box < kLanes / W; ++box)
              tma_store(&rows_map, kLanes * tj + W * box,
                        y0 + kLanes * ti + r0,
                        rows_s + box * CH * kSwizzle);
            if (ti != tj)
#pragma unroll
              for (int box = 0; box < CH / W; ++box)
                tma_store(&cols_map, kLanes * ti + r0 + W * box,
                          y0 + kLanes * tj, mirror_s + box * kLanes * kSwizzle);
            bulk_commit();
          }
        }
      };
      out_tile(std::integral_constant<int, 0>{});
      if constexpr (NT == 2) out_tile(std::integral_constant<int, 1>{});
      if (tid == 0) bulk_wait_read();  // the stages are free again
      __syncthreads();
      if ((tid & 127) == 0 && q >= 2) let_go(q - 2);
    }
    if (with_b && tid < kLanes)
      b_out[(int64_t)row * f + kLanes * slab_a + tid] = b_row;
    if (with_r2) {
      if (owner) s.r2[tid >> 4] = r2_row;
      __syncthreads();
      if (tid == 0) {
        float sum = 0.f;
        for (int k = 0; k < 16; ++k) sum += s.r2[k];
        r2_out[row] = sum;
      }
    }
    __syncthreads();  // every thread is past the row's shared memory
  }
  if (tid == 0) bulk_wait();  // A is written
  // no block leaves while a peer may still copy into its shared memory
  // or arrive on its barriers
  cluster_sync();
}

template <bool AUG, typename OT>
__global__ void __launch_bounds__(mma::kThreads, 1)
    tile_gram_cluster(const Plan plan, const __nv_bfloat16* __restrict__ table,
                      const __grid_constant__ CUtensorMap rows_map,
                      const __grid_constant__ CUtensorMap cols_map,
                      OT* __restrict__ a_out,
                      const int32_t* __restrict__ cols,
                      const float* __restrict__ vals,
                      const int32_t* __restrict__ nnz,
                      float* __restrict__ b_out, float* __restrict__ r2_out,
                      float* __restrict__ scratch, int p, int rows,
                      int f) {
  extern __shared__ unsigned char cluster_raw[];
  ClusterSmem& s = *reinterpret_cast<ClusterSmem*>(
      (reinterpret_cast<uintptr_t>(cluster_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  const int me = (int)cluster_rank();
  bool diag = false;
#pragma unroll
  for (int d = 0; d < kMaxBlocks; ++d)
    if (d == me) diag = plan.diag[d];
  if (diag)
    cluster_rows<AUG, OT, true>(s, plan, me, table, rows_map, cols_map, a_out,
                                cols, vals, nnz, b_out, r2_out, scratch, p,
                                rows, f);
  else
    cluster_rows<AUG, OT, false>(s, plan, me, table, rows_map, cols_map,
                                 a_out, cols, vals, nnz, b_out, r2_out,
                                 scratch, p, rows, f);
}

// cuTensorMapEncodeTiled of the driver the runtime runs on, found once
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A map of a row-major (rows, cols) matrix at `base`, rows of `pitch`
// bytes, in boxes of (box_rows, box_cols) under the 128-byte swizzle
// (box_cols entries: 128 bytes).
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                uint64_t rows, uint64_t cols, uint64_t pitch,
                uint32_t box_rows, uint32_t box_cols) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the whole card's clusters of `blocks` blocks of this instantiation at
// once (the GPCs decide how SMs group), asked once a size
template <bool AUG, typename OT>
cudaError_t clusters_on_card(cudaLaunchConfig_t cfg, int blocks, int* out) {
  static int most[kMaxBlocks + 1] = {};
  if (most[blocks] == 0) {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &n, tile_gram_cluster<AUG, OT>, &cfg);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    most[blocks] = n;
  }
  *out = most[blocks];
  return cudaSuccess;
}

template <bool AUG, typename OT>
int run_cluster(const Plan& plan, const void* table, const void* cols,
                const void* vals, const void* nnz, void* a_out, void* b_out,
                void* r2_out, void* scratch, int scratch_blocks, int r, int p,
                int f, cudaStream_t stream) {
  auto kernel = tile_gram_cluster<AUG, OT>;
  // the ring is dynamic shared memory above 48 KB: allowed once per
  // instantiation
  static const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kClusterSmemBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  // the TMA's views of A (r f rows of f): boxes of CH rows x 128 bytes
  // (W entries) and, for the mirror, 128 rows x 128 bytes
  constexpr int W = kSwizzle / (int)sizeof(OT);
  constexpr int CH = 2 * mma::kTileBytes / (kLanes * (int)sizeof(OT));
  const CUtensorMapDataType out_type =
      sizeof(OT) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap rows_map, cols_map;
  if (!tensor_map(&rows_map, out_type, a_out, (uint64_t)r * f, f,
                  sizeof(OT) * (uint64_t)f, CH, W) ||
      !tensor_map(&cols_map, out_type, a_out, (uint64_t)r * f, f,
                  sizeof(OT) * (uint64_t)f, kLanes, W))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = plan.blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.blocks, 1, 1);
  cfg.blockDim = dim3(mma::kThreads, 1, 1);
  cfg.dynamicSmemBytes = kClusterSmemBytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t asked =
      clusters_on_card<AUG, OT>(cfg, plan.blocks, &clusters);
  if (asked != cudaSuccess) return (int)asked;
  // persistent clusters, each walking its share of the rows; the scratch
  // holds the sums of every block in flight
  clusters = min(r, clusters);
  if (scratch) clusters = min(clusters, scratch_blocks / plan.blocks);
  if (clusters < 1) return (int)cudaErrorInvalidValue;
  cfg.gridDim = dim3(clusters * plan.blocks, 1, 1);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, plan, (const __nv_bfloat16*)table, rows_map, cols_map,
      (OT*)a_out, (const int32_t*)cols, (const float*)vals, (const int32_t*)nnz,
      (float*)b_out, (float*)r2_out, (float*)scratch, p, r, f);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the one-block-a-tile kernel (a bf16 table) or the FMA tile (f32)
template <bool AUG, typename VT, typename OT>
int run_tiles(int table_bf16, const void* table, const void* cols,
              const void* vals, const void* nnz, void* a_out, void* b_out,
              void* r2_out, int r, int p, int f, cudaStream_t stream) {
  const int t = f / kLanes;
  const int64_t blocks = (int64_t)r * (t * (t + 1) / 2);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (table_bf16) {
    auto kernel = tile_gram_mma<AUG, VT, OT>;
    // the ring is dynamic shared memory above 48 KB: allowed once per
    // instantiation
    static const cudaError_t allowed = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmemBytes);
    if (allowed != cudaSuccess) return (int)allowed;
    kernel<<<(int)blocks, mma::kThreads, kMmaSmemBytes, stream>>>(
        (const __nv_bfloat16*)table, (const int32_t*)cols, (const VT*)vals,
        (const int32_t*)nnz, (OT*)a_out, (float*)b_out, (float*)r2_out, p,
        f);
  } else {
    auto kernel = tile_gram_fma<AUG, VT, OT>;
    // the staged tile takes ~65 KB
    static const cudaError_t allowed = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFmaSmemBytes);
    if (allowed != cudaSuccess) return (int)allowed;
    kernel<<<(int)blocks, cumf::kThreads, kFmaSmemBytes, stream>>>(
        (const float*)table, (const int32_t*)cols, (const VT*)vals,
        (const int32_t*)nnz, (OT*)a_out, (float*)b_out, (float*)r2_out, p,
        f);
  }
  return (int)cudaGetLastError();
}

template <bool AUG>
int run_tiles_vals(int table_bf16, int vals_bf16, int out_bf16,
                   const void* table, const void* cols, const void* vals,
                   const void* nnz, void* a_out, void* b_out, void* r2_out,
                   int r, int p, int f, cudaStream_t stream) {
#define CUMF_TILE_RUN(VT, OT)                                             \
  return run_tiles<AUG, VT, OT>(table_bf16, table, cols, vals, nnz, a_out, \
                                b_out, r2_out, r, p, f, stream)
  if (vals_bf16) {
    if (out_bf16) CUMF_TILE_RUN(__nv_bfloat16, __nv_bfloat16);
    CUMF_TILE_RUN(__nv_bfloat16, float);
  }
  if (out_bf16) CUMF_TILE_RUN(float, __nv_bfloat16);
  CUMF_TILE_RUN(float, float);
#undef CUMF_TILE_RUN
}

// The plan of `blocks` blocks (a, b, diag each, by rank) at t slabs, if
// the cluster body can run it: 2..kMaxBlocks blocks, a != b slabs, each
// slab gathered by exactly one block (its diag block) and read by one
// other at least.
bool read_plan(const int* flat, int blocks, int t, Plan* plan) {
  if (blocks < 2 || blocks > kMaxBlocks || t > kMaxBlocks) return false;
  plan->blocks = blocks;
  int gatherers[kMaxBlocks] = {}, readers[kMaxBlocks] = {};
  for (int d = 0; d < blocks; ++d) {
    const int a = flat[3 * d], b = flat[3 * d + 1], diag = flat[3 * d + 2];
    if (a < 0 || a >= t || b < 0 || b >= t || a == b || (diag & ~1))
      return false;
    plan->a[d] = (signed char)a;
    plan->b[d] = (signed char)b;
    plan->diag[d] = (signed char)diag;
  }
  for (int d = 0; d < blocks; ++d) {
    if (plan->diag[d]) ++gatherers[plan->a[d]];
    for (int e = 0; e < blocks; ++e)
      if (e != d && plan->diag[e] &&
          (plan->a[d] == plan->a[e] || plan->b[d] == plan->a[e]))
        ++readers[plan->a[e]];
  }
  for (int c = 0; c < t; ++c)
    if (gatherers[c] != 1 || readers[c] < 1) return false;
  return true;
}

}  // namespace

// r rows of p slots at f = 128 T lanes, T >= 3. table (n+1, f) bf16 (on
// a 16-byte boundary) or f32; cols, vals (r, p); nnz (r,) int32
// or null (every slot); a_out (r, f, f) f32 or bf16; b_out (r, f) f32 or
// null; r2_out (r,) f32 or null; aug: the values over lane f - 1 (b_out
// and r2_out then null). plan: null, or with a bf16 table and f32 vals
// the cluster body's blocks (3 ints each: a, b, diag; `plan_blocks` of
// them), and then, where p passes kSpanTiles tiles of slots, `scratch`:
// f32 room for two 128 x 128 tiles of each of `scratch_blocks` blocks.
// Returns the CUDA error.
extern "C" int cumf_tile_gram(const void* table, int table_bf16,
                              const void* cols,
                              const void* vals, int vals_bf16,
                              const void* nnz, void* a_out, int out_bf16,
                              void* b_out, void* r2_out, int r, int p, int f,
                              int aug, const int* plan, int plan_blocks,
                              void* scratch, int scratch_blocks,
                              void* stream) {
  if (f < 3 * kLanes || f % kLanes || r < 1 || p < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!plan) {
    if (aug)
      return run_tiles_vals<true>(table_bf16, vals_bf16, out_bf16, table,
                                  cols, vals, nnz, a_out, b_out, r2_out, r, p,
                                  f, st);
    return run_tiles_vals<false>(table_bf16, vals_bf16, out_bf16, table, cols,
                                 vals, nnz, a_out, b_out, r2_out, r, p, f,
                                 st);
  }
  Plan read;
  if (!table_bf16 || vals_bf16 ||
      (int64_t)r * f >= 0x7fffffff ||
      !read_plan(plan, plan_blocks, f / kLanes, &read))
    return (int)cudaErrorInvalidValue;
  if (p > kSpanTiles * mma::kSlots && (!scratch || scratch_blocks < 1))
    return (int)cudaErrorInvalidValue;
#define CUMF_CLUSTER_RUN(AUG, OT)                                          \
  return run_cluster<AUG, OT>(read, table, cols, vals, nnz, a_out, b_out,   \
                              r2_out, scratch, scratch_blocks, r, p, f, st)
  if (aug) {
    if (out_bf16) CUMF_CLUSTER_RUN(true, __nv_bfloat16);
    CUMF_CLUSTER_RUN(true, float);
  }
  if (out_bf16) CUMF_CLUSTER_RUN(false, __nv_bfloat16);
  CUMF_CLUSTER_RUN(false, float);
#undef CUMF_CLUSTER_RUN
}
