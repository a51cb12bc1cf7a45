// Pass 1 of the row cut of the 256-lane body on the tensor cores: the
// Gram of one span of one row's slots, written to scratch in the record
// of wide.cuh (SpanRecord<T>), for a bf16 table. With wide_span_solve.cu
// it is how K1 at f = 256 (FL = 256) and K7 (FL = 128 + f2) run on such a
// table, on every chunk, in the spans of ops/cuda_solve.py `span_plan`:
// one span a row where the chunk has as many rows as the card has SMs
// and its rows fit 32 tiles, more below that (a span's f32 sums stay in
// one fragment, whose error grows with the number of 16-slot steps).
//
// Replaces, with pass 2, the TPU kernel `_kernel_wide` (and `_kernel` at
// 256 lanes) of cumf_als_tpu/ops/pallas_solve.py, reached through
// `gather_gram_cg_wide` and `gather_gram_cg`, and `_kernel_cat`, reached
// through `fused_gram_cg_cat` (K8, see fused_gram_cg_cat.cu).
//
// Two sources (template PACKED). The gather (K1, K7): slot t of a row
// names table row cols[t], whose 256 lanes are one contiguous row of the
// table. The packed G of K8: the row's slots are already gathered into
// two slabs, g1 (R, P, 128) and g2 (R, P, f2), so slot t's lanes 0..127
// are g1's row r * P + t and lanes 128..128 + f2 - 1 g2's; lanes above
// are zero (their pieces are zero-filled, as dead lanes are). No ids are
// read, and a span of a packed row covers every slot up to P, not up to
// nnz: K8 sums G over all P slots (`_kernel_cat`); FL = 256 there.
//
// The work. Span s of row r covers slots [lo, hi) = [s L, min((s + 1) L,
// nnz[r], P)) of the row (the plans put a row's live slots first); over
// its FL live lanes it forms A = sum g g^T, b = sum v g and r2 = sum v^2.
// A span at or past the row's slots writes nothing (pass 2 reads only
// live spans). Lanes >= FL of the table are never read: their 16-byte
// pieces are zero-filled (cp.async with a source size of 0).
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
// (K2's WITH_B), and (0, 0) sums r2 (K1's WITH_R2).
//
// The record. Lane t of warp w of warpgroup g holds entries 2 t and 2 t
// + 1 of the 8 x 8 tiles (16 bi + 8 g + 2 w + h, 16 bj + i), h = 0, 1,
// i = 0..15, in acc[4 i + 2 h], acc[4 i + 2 h + 1] (the m64n128 fragment,
// gram_mma.cuh), so with the record tile-major each warp stores a whole
// tile, 256 contiguous bytes, with one 8-byte store a lane. A tile of the
// upper triangle (ti <= tj) inside the live lanes (tj < T) is written
// once, the diagonal tiles whole; the blocks' tiles below the diagonal
// and beyond FL are dropped.
//
// Bound on an H100: the Gram work, the upper triangle nnz FL (FL + 8)
// FLOPs of the span on the bf16 tensor cores, against the bytes of the
// table rows the span names and of its record (105-136 KB at FL = 224 or
// 256), written once. What bounds this design: the gather (a tile's
// latency from L2, two tiles of copies in flight a block, two blocks an
// SM, and the off-diagonal block's second copy of the row) and the
// record's bytes on short spans; the tensor cores do a quarter more than
// the triangle (three 128 x 128 blocks; at FL < 256 the (1, 1) and
// (0, 1) blocks also multiply the zero-filled lanes).

#include "gram_mma.cuh"
#include "wide.cuh"

namespace {

namespace mma = cumf::mma;

constexpr int kStages = 3;            // stages of the ring
constexpr int kAhead = kStages - 1;   // stages of loads in flight
constexpr int kRowLanes = cumf::wide::kStride;  // lanes of a table row

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

// table: the gather table, or g1 when PACKED; g2 and f2: the second slab
// when PACKED (unused otherwise), cols and nnz: unused when PACKED.
template <int T, typename VT, bool PACKED>
__global__ void __launch_bounds__(mma::kThreads, 2)
    wide_span_gram_mma_kernel(const __nv_bfloat16* __restrict__ table,
                              const __nv_bfloat16* __restrict__ g2,
                              const int32_t* __restrict__ cols,
                              const VT* __restrict__ vals,
                              const int32_t* __restrict__ nnz,
                              float* __restrict__ part, int p,
                              int span_len, int f2) {
  constexpr int FL = cumf::wide::Shape<T>::FL;
  using Rec = cumf::wide::SpanRecord<T>;
  const int64_t row = blockIdx.x;
  const int blk = blockIdx.z;  // 0: (0, 0), 1: (0, 1), 2: (1, 1)
  const int n = PACKED ? p : min(__ldg(nnz + row), p);
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
  const bool with_b = !off_diag;
  // the lanes of the X tile, and whether this thread's piece of the X and
  // the Y tile is live (FL is a multiple of 32: a piece is live or dead)
  const int x_lane = blk == 2 ? mma::kF : 0;
  const bool y_live =
      PACKED ? piece * 8 < f2 : mma::kF + piece * 8 < FL;
  const bool x_live = PACKED ? blk != 2 || y_live : x_lane + piece * 8 < FL;
  const int32_t* row_cols = PACKED ? nullptr : cols + row * p + lo;
  const VT* row_vals = vals + row * p + lo;
  const uint32_t tiles_s = mma::smem_u32(&s.tiles[0][0][0]);

  // ids of tile q's slots (PACKED: the slots' places in the span), -1
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
  if (owner) s.r2[tid >> 4] = 0.f;
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
      }
      s.r2[tid >> 4] += sq;
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

  float* rec = part + (row * gridDim.y + blockIdx.y) * Rec::SIZE;
  // A: the tiles of the upper triangle inside the live lanes; the
  // condition is the same for the whole warp
  const int lane = tid & 31;
  const int bi = blk == 2 ? 1 : 0;
  const int bj = blk == 0 ? 0 : 1;
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
      *reinterpret_cast<float2*>(rec + Rec::B + x_lane + lanes) = sum;
    }
  }
  if (blk == 0 && tid == 0) {
    // r2: the 16 owners' parts in a fixed order (their last writes came
    // before the last tile's barrier)
    float r2 = s.r2[0];
#pragma unroll
    for (int j = 1; j < 16; ++j) r2 += s.r2[j];
    rec[Rec::R2] = r2;
  }
}

template <int T, typename VT, bool PACKED>
int launch(const void* table, const void* g2, const void* cols,
           const void* vals, const void* nnz, void* part, int r, int p,
           int spans, int span_len, int f2, cudaStream_t stream) {
  // the ring is dynamic shared memory above 48 KB: allowed once per
  // instantiation
  static const cudaError_t allowed = cudaFuncSetAttribute(
      wide_span_gram_mma_kernel<T, VT, PACKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  wide_span_gram_mma_kernel<T, VT, PACKED>
      <<<dim3(r, spans, 3), mma::kThreads, kSmemBytes, stream>>>(
          (const __nv_bfloat16*)table, (const __nv_bfloat16*)g2,
          (const int32_t*)cols, (const VT*)vals, (const int32_t*)nnz,
          (float*)part, p, span_len, f2);
  return (int)cudaGetLastError();
}

template <typename VT>
int dispatch(int fl, const void* table, const void* g2, const void* cols,
             const void* vals, const void* nnz, void* part, int r, int p,
             int spans, int span_len, int f2, cudaStream_t stream) {
  if (g2 != nullptr) {  // the packed G of K8: 256 lanes, f2 in 32..128
    if (fl != 256 || f2 < 32 || f2 > 128 || f2 % 32)
      return (int)cudaErrorInvalidValue;
    return launch<32, VT, true>(table, g2, cols, vals, nnz, part, r, p,
                                spans, span_len, f2, stream);
  }
  switch (fl) {  // T = FL / 8
    case 160:
      return launch<20, VT, false>(table, g2, cols, vals, nnz, part, r, p,
                                   spans, span_len, f2, stream);
    case 192:
      return launch<24, VT, false>(table, g2, cols, vals, nnz, part, r, p,
                                   spans, span_len, f2, stream);
    case 224:
      return launch<28, VT, false>(table, g2, cols, vals, nnz, part, r, p,
                                   spans, span_len, f2, stream);
    case 256:
      return launch<32, VT, false>(table, g2, cols, vals, nnz, part, r, p,
                                   spans, span_len, f2, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The gather (g2 null): table (n + 1, 256) bf16, rows on 16-byte
// boundaries, cols and nnz as K1 takes them. The packed G of K8 (g2 not
// null): table is g1 (R, P, 128), g2 (R, P, f2) bf16, both on 16-byte
// boundaries, f2 a multiple of 32, fl 256; cols and nnz are not read.
// span_len a multiple of 64 (mma::kSlots).
extern "C" int cumf_wide_span_gram_mma(const void* table, const void* g2,
                                       const void* cols, const void* vals,
                                       int vals_bf16, const void* nnz,
                                       void* part, int r, int p, int fl,
                                       int f2, int spans, int span_len,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (vals_bf16)
    return dispatch<__nv_bfloat16>(fl, table, g2, cols, vals, nnz, part, r,
                                   p, spans, span_len, f2, st);
  return dispatch<float>(fl, table, g2, cols, vals, nnz, part, r, p, spans,
                         span_len, f2, st);
}
