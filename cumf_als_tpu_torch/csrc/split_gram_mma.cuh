// The split-bf16 tensor-core Gram body of the panel kernels K2
// (gather_gram_out.cu) and K5a (gather_gram_aug_out.cu) on a float32
// table at f = 128: A = G^T G over the gathered (P, 128) f32 slab of one
// row, kept to f32 accuracy on the bf16 tensor cores.
//
// Why a split. bf16 tensor cores would round a float32 table's entries
// to 8 significant bits, and TF32 (10 bits, and on Hopper K-major
// operands only, where a gathered G is lane-contiguous, MN-major) misses
// the f32 tolerance too. Each f32 entry x is cut into three bf16 pieces,
// hi = RN(x), mid = RN(x - hi), lo = RN(x - hi - mid): both subtractions
// are exact in f32, and the 24 bits of x's significand fit the three
// 8-bit pieces, so x = hi + mid + lo. Of the nine products of
// (hi + mid + lo)^T (hi + mid + lo) six are kept, hi.hi, hi.mid, mid.hi,
// hi.lo, lo.hi and mid.mid; the three dropped, mid.lo, lo.mid and lo.lo,
// come to at most 2^-23 |x_i| |x_j| a slot. Every kept product is exact
// in f32 (two 8-bit significands), and the tensor cores sum them in f32:
// the arithmetic the JAX package names "highest" precision (its config,
// gram_precision "~fp32, 6-pass").
//
// Bound on an H100, at the X panel chunk R = 2304, P = 576: six products
// of 43.5 GFLOP (the square A) on the bf16 tensor cores take 0.26 ms;
// gathering each slot's 512-byte f32 row from the L2 (680 MB for that
// chunk, the table stays in the L2) takes ~0.45 ms at the 1.5 TB/s the
// bf16 body reaches: the gather, not the arithmetic, sets the pace. The
// function's bound on the card is ~0.12 ms: its triangle of A as six
// bf16 products at the tensor cores' 989 TFLOP/s, b on the CUDA cores
// (chip_smoke.py's panel_gram_ops); this body computes the whole square.
//
// The design, gram_mma.cuh's stream of tiles with an f32 stage in front:
//  - the gather: cp.async, 16 bytes a thread, into a ring of kStages f32
//    stages of 64 slots (32 KB each, [slot][lane], unswizzled); warp w
//    copies slots 8 w .. 8 w + 7, lane l the 16 bytes of lanes 4 l ..
//    4 l + 3 of each (one 512-byte row a warp instruction); slots past
//    the row's end are zero-filled; kAhead tiles of loads in flight
//    (the cursor, ids, values and copies are gram_mma.cuh's Feed, as in
//    gram_stream);
//  - the value: the thread that copied lanes 124..127 of a slot owns the
//    slot's value; once its copies have landed it stores the value into
//    the tile's value line (WITH_B) and, with AUG, over lane 127 of the
//    slot in the stage, as f32 (a float32 table keeps the value as is);
//  - the split, in shared memory only: each thread splits the very
//    floats it copied (its own cp.async have landed, so no barrier is
//    needed for them) and writes the three pieces into three bf16 tiles
//    in gram_mma.cuh's swizzled MN-major layout (`tile_offset`, SBO 1024,
//    LBO 8192), one 8-byte store a piece; two sets of piece tiles, so
//    that the split of tile q runs while the wgmma of tile q - 1 does;
//  - fence.proxy.async, the block's barrier, wgmma.fence, then six
//    m64n128k16 wgmma a 16-slot k-step into the one f32 fragment of each
//    warpgroup (both operands MN-major tiles, tnspA = tnspB = 1, as in
//    gram_mma.cuh); inside the loop over a row's tiles nothing but wgmma
//    touches the sums (ptxas note C7517, gram_mma.cuh);
//  - b (K2): summed on the CUDA cores from the f32 stage, not from the
//    pieces, while the wgmma runs: two lanes a thread over a quarter of
//    the tile's slots, as gram_mma.cuh sums it from its bf16 tile;
//  - A goes out in its dtype (bf16 by round-to-nearest-even) through
//    gram_mma.cuh's store_fragment, and b as there.
// Shared memory: 96 KB of piece tiles and 96 KB of stages, ~195 KB a
// block: one block of 256 threads an SM (the bf16 body fits two), each
// walking its share of the chunk's rows as one stream of tiles. A chunk
// of fewer rows than SMs takes the wrappers' cut (gram_spans in
// ops/cuda_solve.py): this body over the (R S, P / S) view, then
// gram_span_sum.cu, as the bf16 body's cut.
#pragma once

#include "gram_mma.cuh"

namespace cumf {
namespace split {

constexpr int kF = mma::kF;            // 128 lanes
constexpr int kSlots = mma::kSlots;    // 64 slots a tile
constexpr int kThreads = mma::kThreads;
constexpr int kStages = 3;             // f32 stages of the ring
constexpr int kAhead = kStages - 1;    // tiles of loads in flight
constexpr int kPieces = 3;             // hi, mid, lo
constexpr int kSetBytes = kPieces * mma::kTileBytes;
// 32 threads a slot (16 bytes each of its 512-byte row), 8 slots a warp
constexpr int kSlotsPerThread = kSlots * (kF * 4 / 16) / kThreads;
static_assert(kSlotsPerThread == 8, "32 threads a slot, 8 slots a thread");

// Shared memory of one block, placed at a 1024-byte boundary (the
// swizzle is a function of the address): the piece tiles first, each
// set at a multiple of 48 KB, each tile of it at a multiple of 16 KB.
struct Smem {
  unsigned char pieces[2][kSetBytes];  // [set][hi, mid, lo tile]
  float stage[kStages][kSlots][kF];    // the gathered rows, f32
  float v[kStages][kSlots];            // WITH_B: the slots' values
  float b[3][kF];                      // WITH_B: b of the upper quarters
};
constexpr int kSmemBytes = (int)sizeof(Smem) + 1024;

__device__ __forceinline__ Smem& aligned_smem(unsigned char* raw) {
  const uintptr_t p = (reinterpret_cast<uintptr_t>(raw) + 1023) &
                      ~static_cast<uintptr_t>(1023);
  return *reinterpret_cast<Smem*>(p);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  // round to nearest even; a in the low half (the lower lane)
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The three pieces of two neighbouring lanes, one 32-bit pair each.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = bf16x2_bits(a, b);
  const float ra = a - __uint_as_float(hi << 16);          // exact
  const float rb = b - __uint_as_float(hi & 0xffff0000u);  // exact
  mid = bf16x2_bits(ra, rb);
  lo = bf16x2_bits(ra - __uint_as_float(mid << 16),        // exact
                   rb - __uint_as_float(mid & 0xffff0000u));
}

// Gather + split + Gram over every row that falls to this block, each
// of p slots (rows blockIdx.x, blockIdx.x + gridDim.x, ... as ONE stream
// of ceil(p / 64) tiles a row). acc: this thread's part of the fragment
// (gram_mma.cuh's head) = G^T G; with AUG the slot's value replaces lane
// 127 of its gathered row; with WITH_B, b0 and b1 = sum v g over this
// thread's quarter of the slots (thread t: lanes 2 (t % 64) and
// 2 (t % 64) + 1, slots 16 (t / 64) .. + 15 of every tile). After a
// row's last wgmma the whole block calls done(row, acc, b0, b1), which
// may use barriers but must not write acc. With p = 0 no wgmma runs and
// acc stays zero.
template <bool AUG, bool WITH_B, typename VT, typename RowDone>
__device__ __forceinline__ void split_stream(Smem& s, const float* table,
                                             const int32_t* cols,
                                             const VT* vals, int p, int rows,
                                             const RowDone& done) {
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const uint32_t stage_s = mma::smem_u32(&s.stage[0][0][0]);
  const uint32_t pieces_s = mma::smem_u32(&s.pieces[0][0]);
  // 32 threads a slot, each 16 bytes (4 lanes) of its f32 row
  mma::Feed<float, kSlotsPerThread, 32, kAhead, VT, mma::AllSlots> feed(
      table, cols, vals, p, rows, mma::AllSlots{p});
  const int slot0 = feed.slot0;
  const int lane0 = feed.piece * 4;  // the first lane this thread copies
  auto dst = [&](int q, int slot) {
    return stage_s + (q % kStages) * (kSlots * kF * 4) + slot * (kF * 4) +
           lane0 * 4;
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float b_sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // WITH_B: [sum][lane]
  feed.prime(dst);

  int q = 0;  // the stream tile the tensor cores take next
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    // the tiles of one row; inside this loop nothing but wgmma touches acc
    for (int lo = 0; lo < p; lo += kSlots, ++q) {
      const int st = q % kStages;
      float(*stage)[kF] = s.stage[st];
      mma::cp_async_wait<kAhead - 1>();  // this thread's copies landed
      if (feed.owner) {
#pragma unroll
        for (int i = 0; i < kSlotsPerThread; ++i) {
          if constexpr (WITH_B) s.v[st][slot0 + i] = feed.v[0][i];
          if constexpr (AUG) stage[slot0 + i][kF - 1] = feed.v[0][i];
        }
      }
      // Every thread has left the wgmma wait of tile q - 1, so the wgmma
      // of tile q - 2 is done (its piece set is free) and b of tile q - 1
      // has read its stage (the stage the next copies fill).
      __syncthreads();
      feed.next(q + kAhead, dst);  // the cursor is at tile q + kAhead

      // the split of this thread's own floats into the set q % 2
      unsigned char* set = s.pieces[q & 1];
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i) {
        const int slot = slot0 + i;
        const float4 x =
            *reinterpret_cast<const float4*>(&stage[slot][lane0]);
        uint2 hi, mid, low;
        split2(x.x, x.y, hi.x, mid.x, low.x);
        split2(x.z, x.w, hi.y, mid.y, low.y);
        unsigned char* at = set + mma::tile_offset(slot, lane0);
        *reinterpret_cast<uint2*>(at) = hi;
        *reinterpret_cast<uint2*>(at + mma::kTileBytes) = mid;
        *reinterpret_cast<uint2*>(at + 2 * mma::kTileBytes) = low;
      }
      mma::fence_proxy_async();
      __syncthreads();  // the pieces of tile q are whole

      const int k_steps = (min(kSlots, p - lo) + 15) / 16;
      const uint32_t hi_s = pieces_s + (q & 1) * kSetBytes;
      const uint32_t mid_s = hi_s + mma::kTileBytes;
      const uint32_t lo_s = mid_s + mma::kTileBytes;
      const uint32_t rows_of = wg * mma::kHalfBytes;  // this warpgroup's M
      mma::wgmma_fence();
      for (int k = 0; k < k_steps; ++k) {
        const uint32_t ks = k * mma::kKStepBytes;
        const uint64_t a_hi = mma::descriptor(hi_s + rows_of + ks);
        const uint64_t a_mid = mma::descriptor(mid_s + rows_of + ks);
        const uint64_t a_lo = mma::descriptor(lo_s + rows_of + ks);
        const uint64_t b_hi = mma::descriptor(hi_s + ks);
        const uint64_t b_mid = mma::descriptor(mid_s + ks);
        const uint64_t b_lo = mma::descriptor(lo_s + ks);
        mma::wgmma_m64n128k16(acc, a_hi, b_hi, lo > 0 || k > 0);
        mma::wgmma_m64n128k16(acc, a_hi, b_mid, 1);
        mma::wgmma_m64n128k16(acc, a_mid, b_hi, 1);
        mma::wgmma_m64n128k16(acc, a_hi, b_lo, 1);
        mma::wgmma_m64n128k16(acc, a_lo, b_hi, 1);
        mma::wgmma_m64n128k16(acc, a_mid, b_mid, 1);
      }
      mma::wgmma_commit();
      if constexpr (WITH_B) {
        // this thread's two lanes over its quarter of the tile's slots,
        // one 8-byte load a slot from the f32 stage
        const int lanes = 2 * (tid & (kF / 2 - 1));
        const int first = (tid >> 6) * (kSlots / 4);
        const int last = min(first + kSlots / 4, 16 * k_steps);
        for (int t = first; t < last; ++t) {
          const float2 g = *reinterpret_cast<const float2*>(&stage[t][lanes]);
          const float v = s.v[st][t];
          b_sum[t & 1][0] = fmaf(v, g.x, b_sum[t & 1][0]);
          b_sum[t & 1][1] = fmaf(v, g.y, b_sum[t & 1][1]);
        }
      }
      mma::wgmma_wait<1>();
      feed.shift();
    }
    mma::wgmma_wait<0>();
    mma::use_acc(acc);
    done(row, acc, b_sum[0][0] + b_sum[1][0], b_sum[0][1] + b_sum[1][1]);
    b_sum[0][0] = b_sum[0][1] = b_sum[1][0] = b_sum[1][1] = 0.f;
  }
}

// The kernels and their host side have internal linkage (gram_mma.cuh).
namespace {

// K2 (AUG false: A and b) or K5a (AUG true: A' alone) on a float32
// table, over the rows of split_stream.
template <bool AUG, typename VT, typename OT>
__global__ void __launch_bounds__(kThreads, 1)
    split_mma_kernel(const float* __restrict__ table,
                     const int32_t* __restrict__ cols,
                     const VT* __restrict__ vals, OT* __restrict__ a_out,
                     float* __restrict__ b_out, int p, int rows) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = aligned_smem(smem_raw);
  split_stream<AUG, !AUG>(
      s, table, cols, vals, p, rows,
      [&](int row, const float (&acc)[64], float b0, float b1) {
        mma::store_fragment<OT>(acc, a_out + (int64_t)row * kF * kF);
        if constexpr (!AUG)
          mma::store_b(s.b, b0, b1, b_out + (int64_t)row * kF);
      });
}

template <bool AUG, typename VT, typename OT>
int launch(const void* table, const void* cols, const void* vals, void* a_out,
           void* b_out, int r, int p, cudaStream_t stream) {
  // the ring is dynamic shared memory above 48 KB: allowed once per
  // instantiation
  static const cudaError_t allowed = cudaFuncSetAttribute(
      split_mma_kernel<AUG, VT, OT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  // one block an SM, each walking its share of rows
  static const int resident = mma::sm_count();
  split_mma_kernel<AUG, VT, OT>
      <<<r < resident ? r : resident, kThreads, kSmemBytes, stream>>>(
          (const float*)table, (const int32_t*)cols, (const VT*)vals,
          (OT*)a_out, (float*)b_out, p, r);
  return (int)cudaGetLastError();
}

// The host side of both kernels: r rows of p slots of a float32 table at
// f = 128. Returns the CUDA error.
template <bool AUG>
int run(const void* table, const void* cols, const void* vals, int vals_bf16,
        void* a_out, int out_bf16, void* b_out, int r, int p,
        cudaStream_t stream) {
#define CUMF_SPLIT_LAUNCH(VT, OT) \
  return launch<AUG, VT, OT>(table, cols, vals, a_out, b_out, r, p, stream)
  if (vals_bf16) {
    if (out_bf16) CUMF_SPLIT_LAUNCH(__nv_bfloat16, __nv_bfloat16);
    CUMF_SPLIT_LAUNCH(__nv_bfloat16, float);
  }
  if (out_bf16) CUMF_SPLIT_LAUNCH(float, __nv_bfloat16);
  CUMF_SPLIT_LAUNCH(float, float);
#undef CUMF_SPLIT_LAUNCH
}

}  // namespace

}  // namespace split
}  // namespace cumf
