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
// The work. One block owns one row and one tile (ti, tj), ti <= tj, of
// its A: T (T + 1) / 2 blocks a row (6 at f = 384, 10 at 512), those of
// one row next to each other in the grid, so they run together and
// share the row's ids, values and table rows in the L2. The block walks
// the row's slots in tiles of slots, gathers the two 128-lane slabs
// G[:, 128 ti:] and G[:, 128 tj:] of the same slots (one on the diagonal)
// and sums their product; it writes its tile of A and, off the
// diagonal, the transposed tile at (tj, ti). The blocks of ti = 0 also
// write b over slab tj, and block (0, 0) r2.
//
// Bound on an H100, at the Netflix X panel chunk R = 2304, P = 576,
// f = 384, bf16 table and A: the whole square's products, 2 R P f^2 =
// 392 GFLOP, 0.40 ms on the bf16 tensor cores, against 0.20 ms for A's
// 680 MB (1.36 GB as f32, 0.41 ms): operations and bytes are close.
// What the bound does not show: every block gathers its two slabs again,
// so each slot's table row crosses from the L2 to an SM T times over.
// What this design does about it: the tensor cores where the table is
// bf16, the gather asynchronous and ahead of them; nothing yet about the
// repeated gather.
//
// A bf16 table: the tile loop of gram_mma.cuh (cp.async gather of 64
// slots into swizzled MN-major tiles, wgmma m64n128k16 with the slab ti
// tile as A^T and the slab tj tile as B, two warpgroups of 64 rows of
// the tile each), with two tiles a stage, a ring of four stages and two
// of them in flight. The fragment's f32 sums run over at most
// kSpanTiles tiles of slots and are then added, in order, to the tile's
// sums in shared memory, so a long row (the Netflix X phase has rows of
// over 10^5 slots) is not one running sum of thousands of tensor-core
// steps: the error of those steps grows with their number (PERF.md, the
// cut of K1 at f = 128). b and r2 are summed on the CUDA cores from the same
// tiles as in gram_mma.cuh, a tile, a span and the row apart. One block
// an SM (~200 KB of shared memory).
// A float32 table: an FMA tile (bf16 tensor cores would round it):
// 32 slots of both slabs staged in f32, each of 256 threads summing an
// 8 x 8 block of the tile over every slot; b and r2 a tile and the row
// apart.
// Both bodies stage the finished tile in shared memory and write it, and
// its transpose, in whole rows.

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

template <bool AUG, typename VT, typename OT>
int run(int table_bf16, const void* table, const void* cols,
        const void* vals, const void* nnz, void* a_out, void* b_out,
        void* r2_out, int blocks, int p, int f, cudaStream_t stream) {
  if (table_bf16) {
    auto kernel = tile_gram_mma<AUG, VT, OT>;
    // the ring is dynamic shared memory above 48 KB: allowed once per
    // instantiation
    static const cudaError_t allowed = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmemBytes);
    if (allowed != cudaSuccess) return (int)allowed;
    kernel<<<blocks, mma::kThreads, kMmaSmemBytes, stream>>>(
        (const __nv_bfloat16*)table, (const int32_t*)cols, (const VT*)vals,
        (const int32_t*)nnz, (OT*)a_out, (float*)b_out, (float*)r2_out, p,
        f);
  } else {
    auto kernel = tile_gram_fma<AUG, VT, OT>;
    // the staged tile takes ~65 KB
    static const cudaError_t allowed = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFmaSmemBytes);
    if (allowed != cudaSuccess) return (int)allowed;
    kernel<<<blocks, cumf::kThreads, kFmaSmemBytes, stream>>>(
        (const float*)table, (const int32_t*)cols, (const VT*)vals,
        (const int32_t*)nnz, (OT*)a_out, (float*)b_out, (float*)r2_out, p,
        f);
  }
  return (int)cudaGetLastError();
}

template <bool AUG>
int run_vals(int table_bf16, int vals_bf16, int out_bf16, const void* table,
             const void* cols, const void* vals, const void* nnz,
             void* a_out, void* b_out, void* r2_out, int blocks, int p,
             int f, cudaStream_t stream) {
#define CUMF_TILE_RUN(VT, OT)                                              \
  return run<AUG, VT, OT>(table_bf16, table, cols, vals, nnz, a_out, b_out, \
                          r2_out, blocks, p, f, stream)
  if (vals_bf16) {
    if (out_bf16) CUMF_TILE_RUN(__nv_bfloat16, __nv_bfloat16);
    CUMF_TILE_RUN(__nv_bfloat16, float);
  }
  if (out_bf16) CUMF_TILE_RUN(float, __nv_bfloat16);
  CUMF_TILE_RUN(float, float);
#undef CUMF_TILE_RUN
}

}  // namespace

// r rows of p slots at f = 128 T lanes, T >= 3. table (n+1, f) bf16
// (on a 16-byte boundary) or f32; cols, vals (r, p); nnz (r,) int32 or
// null (every slot); a_out (r, f, f) f32 or bf16; b_out (r, f) f32 or
// null; r2_out (r,) f32 or null; aug: the values over lane f - 1 (b_out
// and r2_out then null). Returns the CUDA error.
extern "C" int cumf_tile_gram(const void* table, int table_bf16,
                              const void* cols, const void* vals,
                              int vals_bf16, const void* nnz, void* a_out,
                              int out_bf16, void* b_out, void* r2_out, int r,
                              int p, int f, int aug, void* stream) {
  if (f < 3 * kLanes || f % kLanes || r < 1 || p < 0)
    return (int)cudaErrorInvalidValue;
  const int t = f / kLanes;
  const int64_t blocks = (int64_t)r * (t * (t + 1) / 2);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (aug)
    return run_vals<true>(table_bf16, vals_bf16, out_bf16, table, cols, vals,
                          nnz, a_out, b_out, r2_out, (int)blocks, p, f, st);
  return run_vals<false>(table_bf16, vals_bf16, out_bf16, table, cols, vals,
                         nnz, a_out, b_out, r2_out, (int)blocks, p, f, st);
}
