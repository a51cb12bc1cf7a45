// The 256-lane Gram on the tensor cores, for a bf16 table. Two bodies:
//
//   - pass 1 of the row cut (wide_span_gram_mma.cu, sources kSpans,
//     kSpansAug and kPacked): the Gram of one span of one row's slots,
//     written to scratch in the record of wide.cuh (SpanRecord<T>); with
//     wide_span_solve.cu it is how K1 at f = 256 (FL = 256), K6 at
//     f = 256 (kSpansAug) and K7 (FL = 128 + f2) run on such a table, and
//     K8 on a bf16 G: three 128 x 128 blocks of A, one thread block each
//     (wide_gram_mma_kernel);
//   - the panel Grams at f = 256 (gather_gram_out.cu, K2, and
//     gather_gram_aug_out.cu, K5a): the raw Gram of all P slots of a row,
//     written whole, the (R, 256, 256) A in A's dtype and, for K2, b
//     (R, 256) in f32: one thread block a row of A (panel_stream_kernel).
//     A chunk of fewer rows than SMs is cut across blocks by the wrappers
//     where that pays (gram_spans in ops/cuda_solve.py: the hot segments,
//     R = 16, P = 2^18, and most few-row X panel chunks): this entry point
//     runs over the (R S, P / S) view of the chunk, each span of a row a
//     row of it, writing f32 partials, and gram_span_sum.cu adds each
//     row's S partials in span order; the gather, spread over every SM,
//     then the partials' bytes (257 KB a span) bound it. A chunk the cut
//     leaves whole with three blocks a row fitting the card (3 R at most
//     the SM count: chunks of a few short rows) keeps the three-block
//     kernel (sources kPanel and kPanelAug), which spreads each row over
//     three SMs, ~25% faster than the panel body there. `run_panel`
//     chooses. A float32 table takes the split-bf16 body of
//     wide_split_mma.cuh (the panel body's strips and epilogue on three
//     bf16 pieces of each entry).
//
// Pass 1's sources. kSpans (K1, K7): slot t of a row names table row
// cols[t], whose 256 lanes are one contiguous row of the table; span s
// of row r covers slots [lo, hi) = [s L, min((s + 1) L, nnz[r], P)) (the
// plans put a row's live slots first); over its FL live lanes it forms
// A = sum g g^T, b = sum v g and r2 = sum v^2. A span at or past the
// row's slots writes nothing (pass 2 reads only live spans). Lanes >= FL
// of the table are never read: their 16-byte pieces are zero-filled
// (cp.async with a source size of 0). kSpansAug (K6, FL = 256): kSpans
// with each slot's value, rounded to bf16 as the table stores it, stored
// over lane 255 of its gathered row (the table's own lane 255 is zero:
// the true factor width is at most 255), so the record's tiles hold A'
// (A, b in column 255, sum v^2 in the corner) and no b or r2 is written
// beside them. kPacked (K8): the row's slots are already gathered into
// two slabs, g1 (R, P, 128) and g2 (R, P, f2), so slot t's lanes 0..127
// are g1's row r * P + t and lanes 128..128 + f2 - 1 g2's; lanes above
// are zero (their pieces are zero-filled, as dead lanes are). No ids are
// read, and a span of a packed row covers every slot up to P, not up to
// nnz: K8 sums G over all P slots (`_kernel_cat`); FL = 256 there.
// kPanel and kPanelAug (FL = 256, few-row panel chunks): the gather of
// kSpans over all P slots of the row in one span (pad slots name the
// panel's zero row and add nothing); with kPanelAug the value over lane
// 255 as kSpansAug, so A' holds A, b and sum v^2. Their output: the same
// two entries a lane go to rows 128 bi + 64 g + 16 w + lane / 4 + 8 h,
// columns 128 bj + 8 i + 2 (lane % 4) + {0, 1} of the row's A, and the
// (0, 1) block also writes its transpose, entry by entry.
//
// Pass 1's design. A 256 x 256 f32 A fits no one block's registers, so A is
// cut into 128 x 128 blocks and one thread block computes one of the
// three distinct blocks of its upper half for one (row, span): grid (R,
// S, 3), blockIdx.z = 0 for (0, 0) over lanes 0..127, 1 for (0, 1) over
// lanes 0..127 x 128..255, 2 for (1, 1) over lanes 128..255. Each block
// is gram_mma.cuh's Gram: two warpgroups, each holding one m64n128 f32
// fragment (64 accumulators a thread), fed by a cp.async ring of 64-slot
// swizzled bf16 tiles. The diagonal blocks take one 128-lane tile as both
// operands, as gram_mma.cuh does; the off-diagonal block takes the two
// 128-lane halves of the same slots as A and B, both MN-major, so a stage
// of the ring holds two tiles and that block gathers the row's bytes a
// second time (the trade for fitting the fragment). Blocks (0, 0) and
// (1, 1) sum their halves of b on the CUDA cores while their wgmma runs
// (K1's, K7's and the few-row K2's b; not K6's or K5a's, whose b is in
// A'), and (0, 0) sums r2 (K1's and K7's).
//
// The record (span sources). Lane t of warp w of warpgroup g holds
// entries 2 t and 2 t + 1 of the 8 x 8 tiles (16 bi + 8 g + 2 w + h,
// 16 bj + i), h = 0, 1, i = 0..15, in acc[4 i + 2 h], acc[4 i + 2 h + 1]
// (the m64n128 fragment, gram_mma.cuh), so with the record tile-major
// each warp stores a whole tile, 256 contiguous bytes, with one 8-byte
// store a lane. A tile of the upper triangle (ti <= tj) inside the live
// lanes (tj < T) is written once, the diagonal tiles whole; the blocks'
// tiles below the diagonal and beyond FL are dropped.
//
// Pass 1's bound on an H100: the Gram work on the bf16 tensor cores (the
// upper triangle, nnz FL (FL + 8) FLOPs) against the bytes of the table
// rows the slots name and of the record (105-136 KB at FL = 224 or 256),
// written once. What bounds this design: the gather (a tile's latency
// from L2, two tiles of copies in flight a block, two blocks an SM, and
// the off-diagonal block's second copy of the row) and the record's
// bytes; the tensor cores do a quarter more than the triangle (three
// 128 x 128 blocks; at FL < 256 the (1, 1) and (0, 1) blocks also
// multiply the zero-filled lanes).
//
// The panel body. One thread block of two warpgroups (256 threads; its
// ~200 KB of shared memory make it one block an SM) takes one row of A
// at a time, the block's rows as one stream of 64-slot tiles. A tile
// holds all 256 lanes of 64 slots, 32 KB kept bf16 as gathered: four
// 64-lane chunks of gram_mma.cuh's swizzled [slot][64 lanes] layout, one
// after the other, the chunk stride being the descriptor's LBO, so one
// descriptor spans one to four chunks. Each slot's 512-byte table row
// crosses from the L2 once a row of A. The upper triangle of A is cut
// into strips of 64 rows, and each warpgroup holds two strips as wgmma
// fragments (MN-major operands, both from the one tile):
//   warpgroup 0: rows 0..63 x lanes 0..255 (m64n256: 128 sums a thread)
//                and rows 192..255 x lanes 192..255 (m64n64: 32);
//   warpgroup 1: rows 64..127 x lanes 64..255 (m64n192: 96) and rows
//                128..191 x lanes 128..255 (m64n128: 64),
// the 10 upper 64 x 64 blocks of A's 16 (the three-block body multiplies
// 12), five each. Why it fits in registers: 160 sums a thread, and one
// block of 256 threads an SM may take 255 registers a thread. (Three
// warpgroups of at most 128 sums each were tried first: 384 threads
// leave 168 registers a thread, and ptxas spilled 400-700 bytes.) The
// warpgroup index reaches each thread through a shuffle, so the compiler
// sees each role's branch, and the wgmma in it, as uniform across the
// warp. The two warpgroups share the rest evenly: warpgroup g copies the
// slots g + 2 j of each tile (cp.async, one warp instruction moving one
// slot's whole row, kPanelAhead = 3 tiles in flight in a ring of 5),
// sums b = sum v g over the 8-slot atoms g + 2 j on the CUDA cores while
// the wgmma runs (two lanes a thread), and stores eight 64 x 64 blocks
// of A; the ids and the values come by 4-byte cp.async into shared
// memory a few tiles ahead, so no thread waits on a load of its own.
// K5a's A' carries the value in lane 255: b and sum v^2 are summed from
// the values rounded to bf16, as the table would store them (each
// product bf16 x bf16 is exact in f32, as on the tensor cores; the
// thread of lane 255, where the table is zero, sums v^2 there), and the
// store writes them over row and column 255, where the wgmma multiplied
// the table's own lane 255 (zero); a splice into the tile would cost a
// second barrier a tile.
//
// The panel epilogue goes through shared memory. Each warpgroup stages
// one 64 x 64 block of its fragment at a time in a padded buffer of its
// own (row stride 72 floats for the block, 68 for its transpose, so the
// fragment's stores meet no bank twice), then 16 neighbouring threads
// write each row of the block, 256 contiguous bytes in f32 or 128 in
// bf16 (rounded to nearest even, as astype does), and off the diagonal
// the same for the transposed block: A comes out whole and exactly
// symmetric, both triangles from one sum. The next row's copies are in
// flight meanwhile, and the writes drain while the next row's tiles are
// multiplied. With p = 0 a row has no tile and comes out zero.
//
// The panel body's bound on an H100: the square, 2 P 256^2 FLOPs a row
// on the bf16 tensor cores (989 TFLOP/s), against the bytes of the table
// rows the slots name, the ids and values, and A written once (256 KB a
// row in f32, 128 KB in bf16): at the X panel chunk R = 2304, P = 576
// the write of A bounds it (0.19 ms with an f32 A, 0.10 with bf16); the
// tensor cores take ~0.11 ms for the 10 blocks there.
#pragma once

#include "gram_mma.cuh"
#include "wide.cuh"

namespace cumf {
namespace wide_mma {

namespace mma = cumf::mma;

// Where a block's slots come from and where its sums go (see above).
enum class Src { kSpans, kSpansAug, kPacked, kPanel, kPanelAug };

constexpr int kStages = 3;            // stages of the ring
constexpr int kAhead = kStages - 1;   // stages of loads in flight
constexpr int kRowLanes = cumf::wide::kStride;  // lanes of a table row

// Internal linkage: every source that includes this file is built into a
// library of its own (see gram_mma.cuh).
namespace {

// Shared memory of one block, placed at a 1024-byte boundary (the swizzle
// is a function of the address): a stage holds the tile of the A operand
// (X) and, for the off-diagonal block, the tile of the B operand (Y).
struct Smem {
  unsigned char tiles[kStages][2][mma::kTileBytes];
  float v[kStages][mma::kSlots];  // the slots' values, f32
  float b[3][mma::kF];            // b of the slots' upper quarters
  float r2[16];                   // r2 of each value owner's slots
};
constexpr int kSmemBytes = (int)sizeof(Smem) + 1024;  // two blocks an SM

__device__ __forceinline__ Smem& aligned_smem(unsigned char* raw) {
  const uintptr_t p = (reinterpret_cast<uintptr_t>(raw) + 1023) &
                      ~static_cast<uintptr_t>(1023);
  return *reinterpret_cast<Smem*>(p);
}

template <typename OT>
__device__ __forceinline__ void store2(OT* dst, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      float a, float b) {
  // round to nearest even, as astype does
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// table: the gather table, or g1 with kPacked; g2 and f2: the second slab
// with kPacked (unused otherwise); nnz: read with kSpans alone; part: the
// records (span sources); a_out, b_out: the panel Gram's A and b (b_out
// unused with kPanelAug).
template <int T, typename VT, Src S, typename OT>
__global__ void __launch_bounds__(mma::kThreads, 2)
    wide_gram_mma_kernel(const __nv_bfloat16* __restrict__ table,
                         const __nv_bfloat16* __restrict__ g2,
                         const int32_t* __restrict__ cols,
                         const VT* __restrict__ vals,
                         const int32_t* __restrict__ nnz,
                         float* __restrict__ part, OT* __restrict__ a_out,
                         float* __restrict__ b_out, int p, int span_len,
                         int f2) {
  constexpr bool PACKED = S == Src::kPacked;
  constexpr bool AUG = S == Src::kPanelAug || S == Src::kSpansAug;
  constexpr bool PANEL = S == Src::kPanel || S == Src::kPanelAug;
  // K1's r2 = sum v^2 beside the record (K6's is the corner of A')
  constexpr bool WITH_R2 = !PANEL && !AUG;
  constexpr int FL = cumf::wide::Shape<T>::FL;
  static_assert(!(PANEL || AUG) || FL == 256,
                "a panel Gram and an aug span take all 256 lanes");
  using Rec = cumf::wide::SpanRecord<T>;
  const int64_t row = blockIdx.x;
  const int blk = blockIdx.z;  // 0: (0, 0), 1: (0, 1), 2: (1, 1)
  const int n = PACKED || PANEL ? p : min(__ldg(nnz + row), p);
  const int lo = (int)blockIdx.y * span_len;
  if (lo >= n) return;  // a dead span: the same answer for every thread
  const int len = min(span_len, n - lo);
  const int tiles = (len + mma::kSlots - 1) / mma::kSlots;

  extern __shared__ unsigned char smem_raw[];
  Smem& s = aligned_smem(smem_raw);
  const int tid = threadIdx.x;
  const int piece = tid & 15;  // which 16 bytes of a 128-lane half-row
  const int slot0 = (tid >> 4) * mma::kSlotsPerThread;  // this thread's
  const int wg = tid >> 7;
  const bool owner = piece == 15;  // owns the values of its slots
  const bool off_diag = blk == 1;
  const bool with_b = !off_diag && !AUG;
  // the lanes of the X tile, and whether this thread's piece of the X and
  // the Y tile is live (FL is a multiple of 32: a piece is live or dead)
  const int x_lane = blk == 2 ? mma::kF : 0;
  const bool y_live =
      PACKED ? piece * 8 < f2 : mma::kF + piece * 8 < FL;
  const bool x_live = PACKED ? blk != 2 || y_live : x_lane + piece * 8 < FL;
  const int32_t* row_cols = PACKED ? nullptr : cols + row * p + lo;
  const VT* row_vals = vals + row * p + lo;
  const uint32_t tiles_s = mma::smem_u32(&s.tiles[0][0][0]);

  // ids of tile q's slots (kPacked: the slots' places in the span), -1
  // beyond the span
  auto load_ids = [&](int q, int (&id)[mma::kSlotsPerThread]) {
#pragma unroll
    for (int i = 0; i < mma::kSlotsPerThread; ++i) {
      const int t = q * mma::kSlots + slot0 + i;
      if constexpr (PACKED)
        id[i] = q < tiles && t < len ? t : -1;
      else
        id[i] = q < tiles && t < len ? __ldg(row_cols + t) : -1;
    }
  };
  auto load_vals = [&](int q, float (&v)[mma::kSlotsPerThread]) {
#pragma unroll
    for (int i = 0; i < mma::kSlotsPerThread; ++i) {
      const int t = q * mma::kSlots + slot0 + i;
      v[i] = owner && q < tiles && t < len ? cumf::to_f32(row_vals[t]) : 0.f;
    }
  };
  // Start the copies of tile q, whose ids are `id`: one group a tile, also
  // when it is empty.
  auto start_copies = [&](int q, const int (&id)[mma::kSlotsPerThread]) {
    if (q < tiles) {
      const uint32_t base = tiles_s + (q % kStages) * 2 * mma::kTileBytes;
#pragma unroll
      for (int i = 0; i < mma::kSlotsPerThread; ++i) {
        const bool live = id[i] >= 0;
        const uint32_t dst = base + mma::tile_offset(slot0 + i, piece * 8);
        if constexpr (PACKED) {
          // slot (row, lo + id) of the two slabs; a dead piece of g2
          // points at the slot's first, and reads nothing
          const int64_t slot = row * p + lo + (live ? id[i] : 0);
          const __nv_bfloat16* lo_half = table + slot * mma::kF + piece * 8;
          const __nv_bfloat16* hi_half =
              g2 + slot * f2 + (y_live ? piece * 8 : 0);
          mma::cp_async16(dst, blk == 2 ? hi_half : lo_half,
                          live && x_live ? 16 : 0);
          if (off_diag)
            mma::cp_async16(dst + mma::kTileBytes, hi_half,
                            live && y_live ? 16 : 0);
        } else {
          const __nv_bfloat16* src =
              table + (int64_t)(live ? id[i] : 0) * kRowLanes + piece * 8;
          mma::cp_async16(dst, src + x_lane, live && x_live ? 16 : 0);
          if (off_diag)
            mma::cp_async16(dst + mma::kTileBytes, src + mma::kF,
                            live && y_live ? 16 : 0);
        }
      }
    }
    mma::cp_async_commit();
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float b_sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [sum][lane]
  if (WITH_R2 && owner) s.r2[tid >> 4] = 0.f;
  int id[mma::kSlotsPerThread];
  float v_queue[kAhead][mma::kSlotsPerThread];  // values of tiles in flight
#pragma unroll
  for (int a = 0; a < kAhead; ++a) {
    load_ids(a, id);
    start_copies(a, id);
    load_vals(a, v_queue[a]);
  }
  load_ids(kAhead, id);

  // Each turn ends in wgmma.wait_group 0: the tile's buffer is free for
  // the copies started after the next turn's barrier. Nothing but wgmma
  // touches acc inside the loop.
  for (int q = 0; q < tiles; ++q) {
    const int buf = q % kStages;
    unsigned char* x_tile = s.tiles[buf][0];
    mma::cp_async_wait<kAhead - 1>();  // this thread's copies of tile q
    if (owner) {
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < mma::kSlotsPerThread; ++i) {
        s.v[buf][slot0 + i] = v_queue[0][i];
        sq = fmaf(v_queue[0][i], v_queue[0][i], sq);
        // the value over lane 255, in the tile that holds lanes 128..255
        if (AUG && blk != 0)
          *reinterpret_cast<__nv_bfloat16*>(
              s.tiles[buf][blk == 2 ? 0 : 1] +
              mma::tile_offset(slot0 + i, mma::kF - 1)) =
              __float2bfloat16(v_queue[0][i]);
      }
      if constexpr (WITH_R2) s.r2[tid >> 4] += sq;
    }
    mma::fence_proxy_async();
    __syncthreads();  // tile q is whole; tile q - 1's buffer is free
    float v_new[mma::kSlotsPerThread];
    start_copies(q + kAhead, id);
    load_vals(q + kAhead, v_new);
    load_ids(q + kAhead + 1, id);

    const int k_steps = (min(mma::kSlots, len - q * mma::kSlots) + 15) / 16;
    const uint32_t x_base = tiles_s + buf * 2 * mma::kTileBytes;
    const uint32_t y_base = off_diag ? x_base + mma::kTileBytes : x_base;
    mma::wgmma_fence();
    for (int k = 0; k < k_steps; ++k)
      mma::wgmma_m64n128k16(
          acc,
          mma::descriptor(x_base + wg * mma::kHalfBytes +
                          k * mma::kKStepBytes),
          mma::descriptor(y_base + k * mma::kKStepBytes), q > 0 || k > 0);
    mma::wgmma_commit();
    if (with_b) {
      // this thread's two lanes over its quarter of the tile's slots: 8
      // slots (one swizzle atom) a step, one 4-byte load a slot
      const int lanes = 2 * (tid & (mma::kF / 2 - 1));
      const int first_atom = (tid >> 6) * (mma::kSlots / 32);
      const int last_atom = min(first_atom + mma::kSlots / 32, 2 * k_steps);
      for (int atom = first_atom; atom < last_atom; ++atom) {
        const float4 va =
            *reinterpret_cast<const float4*>(&s.v[buf][8 * atom]);
        const float4 vb =
            *reinterpret_cast<const float4*>(&s.v[buf][8 * atom + 4]);
        const float v8[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
        const unsigned char* g = x_tile + atom * (8 * mma::kLine);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // two bf16, the lower lane in the low half: widen by shifting
          const uint32_t pair = *reinterpret_cast<const uint32_t*>(
              g + mma::tile_offset(j, lanes));
          b_sum[j & 1][0] =
              fmaf(v8[j], __uint_as_float(pair << 16), b_sum[j & 1][0]);
          b_sum[j & 1][1] = fmaf(v8[j], __uint_as_float(pair & 0xffff0000u),
                                 b_sum[j & 1][1]);
        }
      }
    }
    mma::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < mma::kSlotsPerThread; ++i) {
#pragma unroll
      for (int a = 0; a + 1 < kAhead; ++a) v_queue[a][i] = v_queue[a + 1][i];
      v_queue[kAhead - 1][i] = v_new[i];
    }
  }
  mma::use_acc(acc);

  const int lane = tid & 31;
  const int bi = blk == 2 ? 1 : 0;
  const int bj = blk == 0 ? 0 : 1;
  float* rec = nullptr;
  float* b_dst = nullptr;
  if constexpr (PANEL) {
    // A: the block, and the transpose of the off-diagonal one
    constexpr int F = 2 * mma::kF;
    OT* a_row = a_out + row * F * F;
    const int r0 = mma::kF * bi + 64 * wg + 16 * ((tid >> 5) & 3) +
                   (lane >> 2);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r0 + 8 * h;
        const int cc = mma::kF * bj + 8 * i + 2 * (lane & 3);
        const float e0 = acc[4 * i + 2 * h], e1 = acc[4 * i + 2 * h + 1];
        store2<OT>(a_row + rr * F + cc, e0, e1);
        if (off_diag) {
          a_row[cc * F + rr] = cumf::from_f32<OT>(e0);
          a_row[(cc + 1) * F + rr] = cumf::from_f32<OT>(e1);
        }
      }
    }
    if (with_b) b_dst = b_out + row * F + x_lane;
  } else {
    // A: the tiles of the upper triangle inside the live lanes; the
    // condition is the same for the whole warp
    rec = part + (row * gridDim.y + blockIdx.y) * Rec::SIZE;
    const int ti0 = 16 * bi + 8 * wg + 2 * ((tid >> 5) & 3);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ti = ti0 + h;
        const int tj = 16 * bj + i;
        if (ti <= tj && tj < T)
          *reinterpret_cast<float2*>(
              rec + cumf::wide::tile_index<T>(ti, tj) * 64 + 2 * lane) =
              make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
    if (with_b) b_dst = rec + Rec::B + x_lane;
  }
  if (with_b) {
    // b over the X tile's lanes: the four quarters of the slots, added in
    // a fixed order
    const int lanes = 2 * (tid & (mma::kF / 2 - 1));
    const int quarter = tid >> 6;
    const float b0 = b_sum[0][0] + b_sum[1][0];
    const float b1 = b_sum[0][1] + b_sum[1][1];
    if (quarter > 0)
      *reinterpret_cast<float2*>(&s.b[quarter - 1][lanes]) =
          make_float2(b0, b1);
    __syncthreads();
    if (quarter == 0 && x_lane + lanes < FL) {
      float2 sum = make_float2(b0, b1);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        sum.x += s.b[k][lanes];
        sum.y += s.b[k][lanes + 1];
      }
      *reinterpret_cast<float2*>(b_dst + lanes) = sum;
    }
  }
  if (WITH_R2 && blk == 0 && tid == 0) {
    // r2: the 16 owners' parts in a fixed order (their last writes came
    // before the last tile's barrier)
    float r2 = s.r2[0];
#pragma unroll
    for (int j = 1; j < 16; ++j) r2 += s.r2[j];
    rec[Rec::R2] = r2;
  }
}

// One launch, grid (r, spans, 3): part for the span sources, a_out and
// b_out for the panel ones (spans 1, span_len p).
template <int T, typename VT, Src S, typename OT>
int launch(const void* table, const void* g2, const void* cols,
           const void* vals, const void* nnz, void* part, void* a_out,
           void* b_out, int r, int p, int spans, int span_len, int f2,
           cudaStream_t stream) {
  // the ring is dynamic shared memory above 48 KB: allowed once per
  // instantiation
  static const cudaError_t allowed = cudaFuncSetAttribute(
      wide_gram_mma_kernel<T, VT, S, OT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  wide_gram_mma_kernel<T, VT, S, OT>
      <<<dim3(r, spans, 3), mma::kThreads, kSmemBytes, stream>>>(
          (const __nv_bfloat16*)table, (const __nv_bfloat16*)g2,
          (const int32_t*)cols, (const VT*)vals, (const int32_t*)nnz,
          (float*)part, (OT*)a_out, (float*)b_out, p, span_len, f2);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------
// The panel body (K2, K5a at f = 256 on a bf16 table): one block a row
// of A, the design at the head of this file.

using mma::wgmma_m64n256k16;

// acc = A^T B (+ acc if `add`) over 16 slots: m64n192k16, bf16 in, f32
// out, both operands MN-major (as mma::wgmma_m64n128k16).
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96],
                                             uint64_t desc_a,
                                             uint64_t desc_b, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(add));
}

// acc = A^T B (+ acc if `add`) over 16 slots: m64n64k16, bf16 in, f32
// out, both operands MN-major (as mma::wgmma_m64n128k16).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                            uint64_t desc_a,
                                            uint64_t desc_b, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(add));
}

namespace {

constexpr int kPanelThreads = 256;          // two warpgroups
constexpr int kPanelStages = 5;             // tiles of the ring
constexpr int kPanelAhead = kPanelStages - 2;  // tiles of copies in flight
constexpr int kChunkBytes = mma::kHalfBytes;   // 64 slots x 64 lanes
constexpr int kPanelTileBytes = 4 * kChunkBytes;  // 64 slots x 256 lanes
constexpr int kStageStride = 72;   // floats a row of the direct staging
constexpr int kTransStride = 68;   // floats a row of the transposed one
constexpr int kIdRing = 8;  // tiles of ids in shared memory (> 2 kPanelAhead)

// Shared memory of one panel block, placed at a 1024-byte boundary.
struct PanelSmem {
  unsigned char tiles[kPanelStages][kPanelTileBytes];
  // a 64 x 64 block of A a warpgroup, on its way out
  alignas(16) float stage[2][64 * kStageStride];
  // the 4-byte word that holds each slot's value, as copied
  alignas(16) uint32_t vw[kPanelStages][mma::kSlots];
  int32_t ids[kIdRing][mma::kSlots];  // each slot's table row
  alignas(16) float bpart[2][kRowLanes];  // each warpgroup's part of b
  alignas(16) float b[kRowLanes];  // K5a: the row's b, the corner at 255
};
constexpr int kPanelSmemBytes = (int)sizeof(PanelSmem) + 1024;
static_assert(kPanelSmemBytes <= 232448, "the panel block's shared memory");

__device__ __forceinline__ PanelSmem& panel_smem(unsigned char* raw) {
  const uintptr_t p = (reinterpret_cast<uintptr_t>(raw) + 1023) &
                      ~static_cast<uintptr_t>(1023);
  return *reinterpret_cast<PanelSmem*>(p);
}

// 4 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// A slot's value from the 4-byte word that holds it: the word itself for
// float values; for bf16 ones the half that `odd` names.
template <typename VT>
__device__ __forceinline__ float word_value(uint32_t w, int odd);
template <>
__device__ __forceinline__ float word_value<float>(uint32_t w, int) {
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ float word_value<__nv_bfloat16>(uint32_t w,
                                                           int odd) {
  return __uint_as_float(odd ? (w & 0xffff0000u) : (w << 16));
}

// The 128 threads of warpgroup `wg` meet (named barrier 1 + wg; 0 is
// __syncthreads).
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// The wgmma of one tile for warpgroup ROLE over its two strips (acc0,
// acc1), k_steps 16-slot steps from the tile at shared address `base`;
// `add` false on a row's first tile.
template <int ROLE, int N0, int N1>
__device__ __forceinline__ void panel_mma(float (&acc0)[N0],
                                          float (&acc1)[N1], uint32_t base,
                                          int k_steps, bool add) {
  // the strips' first chunks: rows 0..63 x lanes 0..255 and 192..255 x
  // 192..255, or rows 64..127 x lanes 64..255 and 128..191 x 128..255; a
  // k-step moves a descriptor's start (in 16-byte units) by 128
  const uint64_t d0 = mma::descriptor(base + (ROLE == 0 ? 0 : 1) *
                                                 kChunkBytes);
  const uint64_t d1 = mma::descriptor(base + (ROLE == 0 ? 3 : 2) *
                                                 kChunkBytes);
  constexpr uint64_t kStep = mma::kKStepBytes >> 4;
  mma::wgmma_fence();
  for (int k = 0; k < k_steps; ++k) {
    const int on = add || k > 0;
    const uint64_t e0 = d0 + k * kStep, e1 = d1 + k * kStep;
    if constexpr (ROLE == 0) {
      wgmma_m64n256k16(acc0, e0, e0, on);
      wgmma_m64n64k16(acc1, e1, e1, on);
    } else {
      wgmma_m64n192k16(acc0, e0, e0, on);
      mma::wgmma_m64n128k16(acc1, e1, e1, on);
    }
  }
  mma::wgmma_commit();
}

// Four entries of the row's A from the staging buffer to device memory
// (16 or 8 bytes); with AUG, row and column 255 of A' take b and the
// corner from s.b instead (the wgmma multiplied the table's own lane 255,
// which is zero).
template <bool AUG, typename OT>
__device__ __forceinline__ void store_out(OT* a_row, const float* src,
                                          const float* b, int gr, int gc) {
  float4 e = *reinterpret_cast<const float4*>(src);
  if (AUG) {
    if (gr == kRowLanes - 1) {
      e = *reinterpret_cast<const float4*>(b + gc);
    } else if (gc + 3 == kRowLanes - 1) {
      e.w = b[gr];
    }
  }
  mma::store4<OT>(a_row + gr * kRowLanes + gc, e.x, e.y, e.z, e.w);
}

// The epilogue of one strip of 64 rows of A (lanes 64 m0 ..) over the
// n / 64 column blocks from lane 64 c0, held by this warpgroup as the
// m64n(n) fragment `acc`: each 64 x 64 block goes through the staging
// buffer `st` once as itself and, off the diagonal, once transposed, and
// leaves in rows of 16 neighbouring threads (256 or 128 contiguous bytes
// a row). The two stagings are laid out so that the fragment's stores
// meet no bank twice. With MIRROR a diagonal block's lower triangle is
// written from its upper one (wide_split_mma.cuh: there the wgmma sums
// A_ij and A_ji in different orders).
template <bool AUG, typename OT, bool MIRROR = false, int NA>
__device__ __forceinline__ void store_strip(const float (&acc)[NA],
                                            float* st, OT* a_row,
                                            const float* b, int m0, int c0,
                                            int wg) {
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int r = 16 * (t >> 5) + (lane >> 2);  // fragment row, and r + 8
  const int cq = 2 * (lane & 3);              // fragment column pair
  const int orow = t >> 4;                    // write-out row, + 8 k
  const int ocol = 4 * (t & 15);              // write-out columns
#pragma unroll
  for (int j = 0; j < NA / 32; ++j) {
    const int gr0 = 64 * m0, gc0 = 64 * (c0 + j);
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      const int i = 8 * j + ii;
      const int c = 8 * ii + cq;
      *reinterpret_cast<float2*>(st + r * kStageStride + c) =
          make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(st + (r + 8) * kStageStride + c) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
    wg_barrier(wg);
#pragma unroll 1
    for (int k = 0; k < 8; ++k) {
      const int rr = 8 * k + orow;
      if (MIRROR && c0 + j == m0) {
        float e[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int c = ocol + h;
          e[h] = c >= rr ? st[rr * kStageStride + c]
                         : st[c * kStageStride + rr];
        }
        mma::store4<OT>(a_row + (gr0 + rr) * kRowLanes + gc0 + ocol, e[0],
                        e[1], e[2], e[3]);
      } else {
        store_out<AUG, OT>(a_row, st + rr * kStageStride + ocol, b,
                           gr0 + rr, gc0 + ocol);
      }
    }
    wg_barrier(wg);
    if (c0 + j == m0) continue;   // a diagonal block: no transpose
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      const int i = 8 * j + ii;
      const int c = 8 * ii + cq;
      st[c * kTransStride + r] = acc[4 * i];
      st[(c + 1) * kTransStride + r] = acc[4 * i + 1];
      st[c * kTransStride + r + 8] = acc[4 * i + 2];
      st[(c + 1) * kTransStride + r + 8] = acc[4 * i + 3];
    }
    wg_barrier(wg);
#pragma unroll 1
    for (int k = 0; k < 8; ++k) {
      const int cc = 8 * k + orow;
      store_out<AUG, OT>(a_row, st + cc * kTransStride + ocol, b, gc0 + cc,
                         gr0 + ocol);
    }
    wg_barrier(wg);
  }
}

// The rows of one panel block's stream, for warpgroup ROLE (the body of
// panel_stream_kernel, one instantiation a role so that each holds only
// its own sums). Every row has ceil(p / 64) tiles; the block takes rows
// blockIdx.x, blockIdx.x + gridDim.x, ... as one stream of tiles, with
// kPanelAhead tiles of copies in flight across rows.
template <int ROLE, bool AUG, typename VT, typename OT>
__device__ __forceinline__ void panel_role(PanelSmem& s,
                                           const __nv_bfloat16* table,
                                           const int32_t* cols,
                                           const VT* vals, OT* a_out,
                                           float* b_out, int p, int rows) {
  constexpr int N0 = ROLE == 0 ? 128 : 96;   // m64n256 | m64n192
  constexpr int N1 = ROLE == 0 ? 32 : 64;    // m64n64 | m64n128
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int w = t >> 5;                      // warp in the warpgroup
  const int ntr = (p + mma::kSlots - 1) / mma::kSlots;  // tiles a row
  const int my_rows =
      rows > (int)blockIdx.x ? (rows - 1 - (int)blockIdx.x) / gridDim.x + 1
                             : 0;
  const int total = my_rows * ntr;           // tiles of this block
  const uint32_t tiles_s = mma::smem_u32(&s.tiles[0][0]);

  // The gather: warpgroup g copies the slots g + 2 j of each tile, warp w
  // the slots g + 2 (w + 4 i), lane l the 16 bytes l of each, so one warp
  // instruction moves one slot's whole 512-byte table row. The ids and
  // the values come by cp.async too (threads t < 64 of warpgroup 1, one
  // slot each), so no register waits on them: the group of tile x
  // carries its rows, its values and the ids of tile x + kPanelAhead,
  // which have landed when x's rows are issued.
  // Two places in the stream of tiles, each moved one tile at a time:
  // the tile whose copies start next, and the tile whose ids are fetched
  // next (kPanelAhead further on).
  struct Place {
    int q, k_row, ti;  // the stream tile, its row of this block, its tile
  };
  Place cp{0, 0, 0}, ip{0, 0, 0};
  auto first_of = [&](const Place& c, int64_t& first, int& len) {
    first = ((int64_t)blockIdx.x + (int64_t)c.k_row * gridDim.x) * p +
            c.ti * mma::kSlots;
    len = min(mma::kSlots, p - c.ti * mma::kSlots);
  };
  auto advance = [&](Place& c) {
    if (c.q++ < total && ++c.ti == ntr) {
      c.ti = 0;
      ++c.k_row;
    }
  };
  auto fetch_ids = [&]() {
    if (ROLE == 1 && t < mma::kSlots && ip.q < total) {
      int64_t first;
      int len;
      first_of(ip, first, len);
      cp_async4(mma::smem_u32(&s.ids[ip.q % kIdRing][t]),
                cols + first + (t < len ? t : 0), t < len ? 4 : 0);
    }
    advance(ip);
  };
  // the copies of the next tile: its rows, and from warpgroup 1 its
  // values and the ids of a tile further on; one group a tile, also when
  // it is empty
  auto start_copies = [&]() {
    if (cp.q < total) {
      int64_t first;
      int len;
      first_of(cp, first, len);
      const uint32_t base =
          tiles_s + (cp.q % kPanelStages) * kPanelTileBytes;
      const int32_t* ids = s.ids[cp.q % kIdRing];
#pragma unroll 1
      for (int i = 0; i < 8; ++i) {
        const int slot = ROLE + 2 * (w + 4 * i);
        const bool got = slot < len;
        const int32_t id = got ? ids[slot] : 0;
        mma::cp_async16(base + mma::tile_offset(slot, 8 * lane),
                        table + (int64_t)id * kRowLanes + 8 * lane,
                        got ? 16 : 0);
      }
      if (ROLE == 1 && t < mma::kSlots) {
        // the aligned word that holds the value (a bf16 value shares it)
        const uintptr_t at = reinterpret_cast<uintptr_t>(
            vals + first + (t < len ? t : 0));
        cp_async4(mma::smem_u32(&s.vw[cp.q % kPanelStages][t]),
                  reinterpret_cast<const void*>(at & ~uintptr_t(3)),
                  t < len ? 4 : 0);
      }
    }
    advance(cp);
    fetch_ids();
    mma::cp_async_commit();
  };
  // b: lanes 2 t, 2 t + 1 over the 8-slot atoms ROLE, ROLE + 2, ... of
  // each tile; slot j of an atom at tile + b_at + atom 1024 + j 128 +
  // ((b_piece ^ j) << 4) (gram_mma.cuh's tile_offset)
  const int b_at = (t >> 5) * kChunkBytes + 4 * (t & 3);
  const int b_piece = (t >> 2) & 7;
  // K5a: lane 255 of the table is zero, so its thread sums v^2 there
  const bool r2_lane = AUG && t == 127;

  float acc0[N0], acc1[N1];
#pragma unroll
  for (int i = 0; i < N0; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N1; ++i) acc1[i] = 0.f;
  float b_acc[2] = {0.f, 0.f};  // this warpgroup's part of b
  // the ids of the first tiles, then their copies
  for (int a = 0; a < kPanelAhead; ++a) fetch_ids();
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  for (int a = 0; a < kPanelAhead; ++a) start_copies();

  int q = 0;  // the stream tile the tensor cores take next
  for (int k_row = 0; k_row < my_rows; ++k_row) {
    const int64_t row = blockIdx.x + (int64_t)k_row * gridDim.x;
    // the tiles of one row; inside this loop nothing but wgmma touches
    // the sums
    for (int ti = 0; ti < ntr; ++ti, ++q) {
      const int buf = q % kPanelStages;
      const int len = min(mma::kSlots, p - ti * mma::kSlots);
      mma::cp_async_wait<kPanelAhead - 1>();  // this thread's copies
      mma::fence_proxy_async();
      // Tile q is whole; every thread has left the wgmma wait of tile
      // q - 1, so the wgmma of tile q - 2 is done and its buffer is free.
      __syncthreads();
      start_copies();  // tile q + kPanelAhead
      const int k_steps = (len + 15) / 16;
      const uint32_t base = tiles_s + buf * kPanelTileBytes;
      panel_mma<ROLE, N0, N1>(acc0, acc1, base, k_steps, ti > 0);
      {
        // this warpgroup's atoms of b, two partial sums; K5a's values as
        // the table would store them in lane 255
        const int odd = (int)((reinterpret_cast<uintptr_t>(
                                   vals + row * p + ti * mma::kSlots) >>
                               1) & 1);
        const unsigned char* tile = s.tiles[buf] + b_at;
        float bt[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        for (int atom = ROLE; atom < 2 * k_steps; atom += 2) {
          const uint4 wa = *reinterpret_cast<const uint4*>(
              &s.vw[buf][8 * atom]);
          const uint4 wb = *reinterpret_cast<const uint4*>(
              &s.vw[buf][8 * atom + 4]);
          const uint32_t w8[8] = {wa.x, wa.y, wa.z, wa.w,
                                  wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float v = word_value<VT>(w8[j], odd ^ (j & 1));
            if (AUG) v = __bfloat162float(__float2bfloat16(v));
            const uint32_t pair = *reinterpret_cast<const uint32_t*>(
                tile + atom * (8 * mma::kLine) + j * mma::kLine +
                ((b_piece ^ j) << 4));
            const float g1 =
                r2_lane ? v : __uint_as_float(pair & 0xffff0000u);
            bt[j & 1][0] = fmaf(v, __uint_as_float(pair << 16),
                                bt[j & 1][0]);
            bt[j & 1][1] = fmaf(v, g1, bt[j & 1][1]);
          }
        }
        b_acc[0] += bt[0][0] + bt[1][0];
        b_acc[1] += bt[0][1] + bt[1][1];
      }
      mma::wgmma_wait<1>();
    }
    mma::wgmma_wait<0>();
    mma::use_acc(acc0);
    mma::use_acc(acc1);

    // the row's b: the two warpgroups' parts in a fixed order; K2
    // writes it, K5a keeps it (lane 255: sum v^2, the corner) for the
    // store of row and column 255
    *reinterpret_cast<float2*>(&s.bpart[ROLE][2 * t]) =
        make_float2(b_acc[0], b_acc[1]);
    b_acc[0] = b_acc[1] = 0.f;
    __syncthreads();
    if (ROLE == 0) {
      float2 sum = *reinterpret_cast<const float2*>(&s.bpart[0][2 * t]);
      const float2 part =
          *reinterpret_cast<const float2*>(&s.bpart[1][2 * t]);
      sum.x += part.x;
      sum.y += part.y;
      if (AUG)
        *reinterpret_cast<float2*>(&s.b[2 * t]) = sum;
      else
        *reinterpret_cast<float2*>(b_out + row * kRowLanes + 2 * t) = sum;
    }
    if (AUG) __syncthreads();  // s.b whole before the stores
    OT* a_row = a_out + row * kRowLanes * kRowLanes;
    float* st = s.stage[ROLE];
    if constexpr (ROLE == 0) {
      store_strip<AUG, OT>(acc0, st, a_row, s.b, 0, 0, 0);
      store_strip<AUG, OT>(acc1, st, a_row, s.b, 3, 3, 0);
    } else {
      store_strip<AUG, OT>(acc0, st, a_row, s.b, 1, 1, 1);
      store_strip<AUG, OT>(acc1, st, a_row, s.b, 2, 2, 1);
    }
  }
}

// K2 (AUG false: A and b) or K5a (AUG true: A' alone) at f = 256 on a
// bf16 table: persistent blocks of two warpgroups, one row of A at a time
// (the design at the head of this file). The warpgroup index comes
// through a shuffle so that the compiler sees each role's branch, and its
// wgmma, as uniform across the warp.
template <bool AUG, typename VT, typename OT>
__global__ void __launch_bounds__(kPanelThreads, 1)
    panel_stream_kernel(const __nv_bfloat16* __restrict__ table,
                        const int32_t* __restrict__ cols,
                        const VT* __restrict__ vals, OT* __restrict__ a_out,
                        float* __restrict__ b_out, int p, int rows) {
  extern __shared__ unsigned char smem_raw[];
  PanelSmem& s = panel_smem(smem_raw);
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  if (wg == 0)
    panel_role<0, AUG>(s, table, cols, vals, a_out, b_out, p, rows);
  else
    panel_role<1, AUG>(s, table, cols, vals, a_out, b_out, p, rows);
}

template <bool AUG, typename VT, typename OT>
int launch_panel(const void* table, const void* cols, const void* vals,
                 void* a_out, void* b_out, int r, int p,
                 cudaStream_t stream) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      panel_stream_kernel<AUG, VT, OT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kPanelSmemBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  // one block an SM (its shared memory), each walking its share of rows
  static const int resident = mma::sm_count();
  panel_stream_kernel<AUG, VT, OT>
      <<<r < resident ? r : resident, kPanelThreads, kPanelSmemBytes,
         stream>>>((const __nv_bfloat16*)table, (const int32_t*)cols,
                   (const VT*)vals, (OT*)a_out, (float*)b_out, p, r);
  return (int)cudaGetLastError();
}

// The panel Gram of r rows of p slots at f = 256 on a bf16 table: K2
// (AUG false: A and b) or K5a (AUG true: A' alone); a float32 table takes
// the split body of wide_split_mma.cuh. Returns the CUDA error.
template <bool AUG>
int run_panel(const void* table, const void* cols, const void* vals,
              int vals_bf16, void* a_out, int out_bf16, void* b_out, int r,
              int p, cudaStream_t stream) {
  constexpr Src S = AUG ? Src::kPanelAug : Src::kPanel;
  // a chunk of few rows (three blocks a row fit the card): the three-block
  // body, which spreads each row over three SMs; else one block a row
  static const int sms = mma::sm_count();
  const bool few = 3 * r <= sms;
#define CUMF_PANEL_LAUNCH(VT, OT)                                            \
  if (few)                                                                   \
    return launch<32, VT, S, OT>(table, nullptr, cols, vals, nullptr,        \
                                 nullptr, a_out, b_out, r, p, 1, p, 0,       \
                                 stream);                                    \
  return launch_panel<AUG, VT, OT>(table, cols, vals, a_out, b_out, r, p,    \
                                   stream)
  if (vals_bf16) {
    if (out_bf16) { CUMF_PANEL_LAUNCH(__nv_bfloat16, __nv_bfloat16); }
    CUMF_PANEL_LAUNCH(__nv_bfloat16, float);
  }
  if (out_bf16) { CUMF_PANEL_LAUNCH(float, __nv_bfloat16); }
  CUMF_PANEL_LAUNCH(float, float);
#undef CUMF_PANEL_LAUNCH
}

}  // namespace

}  // namespace wide_mma
}  // namespace cumf
