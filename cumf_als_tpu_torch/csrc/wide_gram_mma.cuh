// The 256-lane Gram on the tensor cores, for a bf16 table: three
// 128 x 128 blocks of A, one thread block each, every block gram_mma.cuh's
// wgmma over a cp.async ring. Two kinds of caller:
//
//   - pass 1 of the row cut (wide_span_gram_mma.cu, sources kSpans and
//     kPacked): the Gram of one span of one row's slots, written to
//     scratch in the record of wide.cuh (SpanRecord<T>); with
//     wide_span_solve.cu it is how K1 at f = 256 (FL = 256) and K7
//     (FL = 128 + f2) run on such a table, and K8 on a bf16 G;
//   - the panel Grams at f = 256 (gather_gram_out.cu, K2, source kPanel,
//     and gather_gram_aug_out.cu, K5a, source kPanelAug): the raw Gram
//     of all P slots of a row, written whole, the (R, 256, 256) A in A's
//     dtype and, for K2, b (R, 256) in f32 (`run_panel`, which takes a
//     float32 table to wide.cuh's FMA body, panel_gram).
//
// Sources. kSpans (K1, K7): slot t of a row names table row cols[t],
// whose 256 lanes are one contiguous row of the table; span s of row r
// covers slots [lo, hi) = [s L, min((s + 1) L, nnz[r], P)) (the plans put
// a row's live slots first); over its FL live lanes it forms A =
// sum g g^T, b = sum v g and r2 = sum v^2. A span at or past the row's
// slots writes nothing (pass 2 reads only live spans). Lanes >= FL of the
// table are never read: their 16-byte pieces are zero-filled (cp.async
// with a source size of 0). kPacked (K8): the row's slots are already
// gathered into two slabs, g1 (R, P, 128) and g2 (R, P, f2), so slot t's
// lanes 0..127 are g1's row r * P + t and lanes 128..128 + f2 - 1 g2's;
// lanes above are zero (their pieces are zero-filled, as dead lanes
// are). No ids are read, and a span of a packed row covers every slot up
// to P, not up to nnz: K8 sums G over all P slots (`_kernel_cat`); FL =
// 256 there. kPanel and kPanelAug (FL = 256): the gather of kSpans over
// all P slots of the row in one span (pad slots name the panel's zero
// row and add nothing); with kPanelAug the slot's value, rounded to bf16
// as the table stores it, is stored over lane 255 of its gathered row
// (the table's own lane 255 is zero: the true factor width is at most
// 255), so A' holds A, b (row and column 255) and sum v^2 (the corner),
// as common.cuh's aug layout at 128 lanes.
//
// The design. A 256 x 256 f32 A fits no one block's registers, so A is
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
// (K2's WITH_B; not K5a, whose b is in A'), and (0, 0) sums r2 (K1's
// WITH_R2; the span sources only).
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
// The panel output. The same two entries a lane go to rows 128 bi +
// 64 g + 16 w + lane / 4 + 8 h, columns 128 bj + 8 i + 2 (lane % 4) +
// {0, 1} of the row's A, as one 8-byte (f32) or 4-byte (bf16, rounded to
// nearest even as astype does) store; the (0, 1) block also writes its
// transpose, entry by entry, so A comes out whole and exactly symmetric
// off the diagonal blocks.
//
// Bound on an H100: the Gram work on the bf16 tensor cores (the upper
// triangle, nnz FL (FL + 8) FLOPs, for a record; the full square,
// 2 P 256^2 a row, for a panel Gram), against the bytes of the table rows
// the slots name and of the output, written once: the record (105-136 KB
// at FL = 224 or 256), or the panel Gram's A (256 KB a row in f32, 128 KB
// in bf16), which bounds K2 at f = 256 with an f32 A. What bounds this
// design: the gather (a tile's latency from L2, two tiles of copies in
// flight a block, two blocks an SM, and the off-diagonal block's second
// copy of the row) and the output's bytes; the tensor cores do a quarter
// more than the triangle (three 128 x 128 blocks; at FL < 256 the (1, 1)
// and (0, 1) blocks also multiply the zero-filled lanes).
#pragma once

#include "gram_mma.cuh"
#include "wide.cuh"

namespace cumf {
namespace wide_mma {

namespace mma = cumf::mma;

// Where a block's slots come from and where its sums go (see above).
enum class Src { kSpans, kPacked, kPanel, kPanelAug };

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
  constexpr bool AUG = S == Src::kPanelAug;
  constexpr bool PANEL = S == Src::kPanel || AUG;
  constexpr int FL = cumf::wide::Shape<T>::FL;
  static_assert(!PANEL || FL == 256, "a panel Gram takes all 256 lanes");
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
  if (!PANEL && owner) s.r2[tid >> 4] = 0.f;
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
      if constexpr (!PANEL) s.r2[tid >> 4] += sq;
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
  if (!PANEL && blk == 0 && tid == 0) {
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

// The panel Gram at f = 256 on a float32 table (bf16 tensor cores would
// round it): wide.cuh's FMA body, one block a row.
template <bool AUG, typename VT, typename OT>
__global__ void __launch_bounds__(cumf::wide::Shape<32>::THREADS)
    panel_gram_fma_kernel(const float* __restrict__ table,
                          const int32_t* __restrict__ cols,
                          const VT* __restrict__ vals,
                          OT* __restrict__ a_out, float* __restrict__ b_out,
                          int p) {
  constexpr int F = cumf::wide::kStride;
  __shared__ cumf::wide::Smem<32> s;
  const int64_t row = blockIdx.x;
  cumf::wide::panel_gram<AUG>(s, table, cols + row * p, vals + row * p, p,
                              a_out + row * F * F,
                              AUG ? nullptr : b_out + row * F);
}

// The panel Gram of r rows of p slots at f = 256: K2 (AUG false: A and
// b) or K5a (AUG true: A' alone), on the tensor cores for a bf16 table,
// on the FMA body for a float32 one. Returns the CUDA error.
template <bool AUG>
int run_panel(const void* table, int table_bf16, const void* cols,
              const void* vals, int vals_bf16, void* a_out, int out_bf16,
              void* b_out, int r, int p, cudaStream_t stream) {
  constexpr Src S = AUG ? Src::kPanelAug : Src::kPanel;
#define CUMF_PANEL_LAUNCH(VT, OT)                                            \
  if (table_bf16)                                                            \
    return launch<32, VT, S, OT>(table, nullptr, cols, vals, nullptr,        \
                                 nullptr, a_out, b_out, r, p, 1, p, 0,       \
                                 stream);                                    \
  panel_gram_fma_kernel<AUG, VT, OT>                                         \
      <<<r, cumf::wide::Shape<32>::THREADS, 0, stream>>>(                    \
          (const float*)table, (const int32_t*)cols, (const VT*)vals,        \
          (OT*)a_out, (float*)b_out, p);                                     \
  return (int)cudaGetLastError()
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
