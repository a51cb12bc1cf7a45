// The split-bf16 tensor-core Gram of the panel kernels K2
// (gather_gram_out.cu) and K5a (gather_gram_aug_out.cu) on a float32
// table at f = 256 (factor widths 128 < F <= 256): A = G^T G over the
// gathered (P, 256) f32 slab of one row, kept to f32 accuracy on the
// bf16 tensor cores, written whole and exactly symmetric.
//
// The arithmetic is split_gram_mma.cuh's: each gathered f32 entry x is
// cut into hi = RN(x), mid = RN(x - hi), lo = RN(x - hi - mid) (split2;
// both subtractions exact, x = hi + mid + lo), and six of the nine
// products of the pieces, hi.hi, hi.mid, mid.hi, hi.lo, lo.hi and
// mid.mid, are summed in the f32 wgmma fragments a 16-slot k-step; the
// three dropped come to at most 2^-23 |x_i| |x_j| a slot. It is the
// arithmetic the JAX package names "highest" precision (gram_precision
// "~fp32, 6-pass").
//
// The Gram is wide_gram_mma.cuh's panel body (panel_stream_kernel): one
// persistent block of two warpgroups an SM walks its rows as one stream
// of tiles, and the ten upper 64 x 64 blocks of A are held as wgmma
// fragments, 160 sums a thread:
//   warpgroup 0: rows 0..63 x lanes 0..255 (m64n256) and rows 192..255 x
//                lanes 192..255 (m64n64);
//   warpgroup 1: rows 64..127 x lanes 64..255 (m64n192) and rows
//                128..191 x lanes 128..255 (m64n128).
// A product of two pieces is one wgmma a strip, A from the one piece and
// B from the other at the strip's 64-lane chunk, both MN-major; twelve
// wgmma a warpgroup a k-step. Inside the loop over a row's tiles nothing
// but wgmma touches the sums (ptxas note C7517, gram_mma.cuh).
//
// Shared memory is what shapes the design. At 256 lanes a 64-slot tile
// is 64 KB as the f32 stage and 96 KB as three bf16 piece tiles, and the
// card allows 227 KB a block. So a tile here is 32 slots (two k-steps):
//  - a ring of kStages f32 stages of 32 KB ([slot][256 lanes],
//    unswizzled), up to kAhead tiles of copies in flight (96 KB, more
//    than the 64 KB the f = 128 split body keeps in flight: the table of
//    a panel, 65,537 x 1 KB, is larger than the L2, and part of each
//    gather comes from device memory);
//  - two sets of piece tiles of 48 KB (hi, mid, lo, each 32 slots x 256
//    lanes bf16 as four 64-lane chunks of gram_mma.cuh's swizzled
//    [slot][64 lanes] layout, one after the other, the chunk stride the
//    descriptors' LBO), so that the split of tile q + 1 runs while the
//    wgmma of tile q do;
//  - the epilogue's staging (36 KB) on the piece set of the row's last
//    tile, free once every wgmma of the row is done (the other set holds
//    the next row's first tile);
//  - the ids and the values of each tile by 4-byte cp.async, as the
//    panel body fetches them, so no register waits on them;
// ~226 KB in all (static_assert below).
//
// A tile's turn (the pieces of tile q are whole): each thread waits for
// its own copies of tile q + 1 and for its warpgroup's wgmma of tile
// q - 1; the block's barrier (every wgmma of tile q - 1 is done, so its
// piece set is free; b of tile q - 1 has read its stage, which the next
// copies fill); the copies of tile q + kAhead; then the wgmma of tile q
// in four quarters (a k-step's hi.hi, hi.mid, mid.hi, then its hi.lo,
// lo.hi, mid.mid), after each a quarter of the split of tile q + 1, so
// that no thread waits long to issue a wgmma while the tensor cores
// still hold the earlier ones: each thread splits the very floats it
// copied (16 bytes of one half of a slot's 1 KB row, two of its 8 slots
// a quarter) into the piece set (q + 1) % 2, one 8-byte store a piece
// (K5a: the thread of lanes 252..255 first puts the slot's f32 value in
// lane 255, the table's own lane 255 being zero, so A' carries b and
// sum v^2 to split accuracy, as the JAX f32 aug kernel puts the f32
// value in lane f - 1); K2's b of tile q on the CUDA cores from the f32
// stage while the wgmma run (thread t sums lane t over the tile's slots
// in two partial sums, added to the row's sum a tile at a time with its
// rounding error kept, TwoSum); fence.proxy.async, the barrier. The
// products and their order are those of issuing a tile's wgmma at once,
// so A comes out bit for bit the same.
//
// A row's end: wgmma.wait_group 0, K2 writes b (each thread its lane),
// the block's barrier, then each warpgroup writes its strips through
// the staging as the panel body does (store_strip: each 64 x 64 block
// once as itself and, off the diagonal, once transposed, in rows of 256
// or 128 contiguous bytes), both triangles from one sum: the wgmma of a
// diagonal block sums A_ij as hi_i mid_j then mid_i hi_j and A_ji the
// other way round, so its lower triangle is written from its upper one
// (MIRROR), and A comes out exactly symmetric. With p = 0 a
// row has no tile and comes out zero; slots past the row's end are
// zero-filled, pad slots name the panel's zero row, so a row of pad
// slots only comes out exactly 0.
//
// Bound on an H100, at chip_smoke.py's synthetic X panel chunk R = 2304,
// P = 576 (~0.65 M live slots): the function's triangle as six bf16
// products at 989 TFLOP/s, plus b at the float32 peak, ~0.27 ms
// (chip_smoke.py's panel_gram_ops). This body multiplies ten 64 x 64
// blocks of sixteen over every slot, pad slots too, six times: 652
// GFLOP, at least 0.66 ms on the tensor cores; the gather moves 1.36 GB
// of 1 KB rows, in parallel with the products; A goes out at 256 KB a
// row in f32, through the staging, after the row's last wgmma.
// Registers are the risk: 160 sums a thread, and the split's
// temporaries in the same threads (its loop is kept rolled).
#pragma once

#include "split_gram_mma.cuh"
#include "wide_gram_mma.cuh"

namespace cumf {
namespace wide_split {

namespace mma = cumf::mma;
namespace wm = cumf::wide_mma;

constexpr int kF = 256;                        // lanes of a table row
constexpr int kSlots = 32;                     // slots of a tile
constexpr int kThreads = 256;                  // two warpgroups
constexpr int kStages = 4;                     // f32 stages of the ring
constexpr int kAhead = kStages - 1;            // tiles of copies in flight
constexpr int kIdRing = 8;                     // tiles of ids (> kAhead)
constexpr int kLine = 128;                     // a slot in one 64-lane chunk
constexpr int kChunkBytes = kSlots * kLine;    // [32 slots][64 lanes] bf16
constexpr int kPieceBytes = 4 * kChunkBytes;   // one piece of a tile
constexpr int kSetBytes = 3 * kPieceBytes;     // hi, mid, lo
constexpr int kKStepBytes = 16 * kLine;        // 16 slots of a chunk
// 64 threads a slot (16 bytes each of its 1 KB row), 8 slots a thread
constexpr int kSlotsPerThread = kSlots * (kF * 4 / 16) / kThreads;
static_assert(kSlotsPerThread == 8, "64 threads a slot, 8 slots a thread");

// Shared memory of one block, placed at a 1024-byte boundary (the
// swizzle is a function of the address): the piece sets first, each
// piece at a multiple of 16 KB.
struct Smem {
  unsigned char pieces[2][kSetBytes];  // [set][hi, mid, lo]; the staging
  float stage[kStages][kSlots][kF];    // the gathered rows, f32
  alignas(16) uint32_t vw[kStages][kSlots];  // the word of each value
  int32_t ids[kIdRing][kSlots];        // each slot's table row
};
constexpr int kSmemBytes = (int)sizeof(Smem) + 1024;
static_assert(kSmemBytes <= 232448, "the split panel block's shared memory");
static_assert(2 * 64 * wm::kStageStride * 4 <= kSetBytes,
              "the epilogue's staging fits a piece set");

__device__ __forceinline__ Smem& aligned_smem(unsigned char* raw) {
  const uintptr_t p = (reinterpret_cast<uintptr_t>(raw) + 1023) &
                      ~static_cast<uintptr_t>(1023);
  return *reinterpret_cast<Smem*>(p);
}

// Byte offset of (slot, lane) inside a piece tile: chunk lane / 64,
// line `slot`, gram_mma.cuh's 128-byte swizzle.
__device__ __forceinline__ int piece_offset(int slot, int lane) {
  return (lane >> 6) * kChunkBytes + slot * kLine +
         ((((lane >> 3) & 7) ^ (slot & 7)) << 4) + ((lane & 7) << 1);
}

// Matrix descriptor of an MN-major operand under the 128-byte swizzle
// that starts at shared address `addr` (mma::descriptor with the
// 32-slot chunk's stride as LBO).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);  // start address
  d |= (uint64_t)(kChunkBytes >> 4) << 16;         // LBO: the next 64 lanes
  d |= (uint64_t)(8 * kLine >> 4) << 32;           // SBO: the next 8 slots
  d |= (uint64_t)1 << 62;                          // 128-byte swizzle
  return d;
}

// One product of pieces (A from piece `i`, B from piece `j`) over one
// k-step, for both strips of warpgroup ROLE; e0, e1: the descriptors of
// the strips' chunks in the hi piece at this k-step.
template <int ROLE, int N0, int N1>
__device__ __forceinline__ void product(float (&acc0)[N0], float (&acc1)[N1],
                                        uint64_t e0, uint64_t e1, int i,
                                        int j, int on) {
  constexpr uint64_t kPiece = kPieceBytes >> 4;
  if constexpr (ROLE == 0) {
    mma::wgmma_m64n256k16(acc0, e0 + i * kPiece, e0 + j * kPiece, on);
    wm::wgmma_m64n64k16(acc1, e1 + i * kPiece, e1 + j * kPiece, on);
  } else {
    wm::wgmma_m64n192k16(acc0, e0 + i * kPiece, e0 + j * kPiece, on);
    mma::wgmma_m64n128k16(acc1, e1 + i * kPiece, e1 + j * kPiece, on);
  }
}

// A quarter of the wgmma of one tile for warpgroup ROLE: k-step k of
// the piece set at shared address `set`, products hi.hi, hi.mid, mid.hi
// (half 0) or hi.lo, lo.hi, mid.mid (half 1); `add` false on a row's
// first tile.
template <int ROLE, int N0, int N1>
__device__ __forceinline__ void mma_quarter(float (&acc0)[N0],
                                            float (&acc1)[N1], uint32_t set,
                                            int k, int half, bool add) {
  constexpr uint64_t kStep = kKStepBytes >> 4;
  const uint64_t e0 =
      descriptor(set + (ROLE == 0 ? 0 : 1) * kChunkBytes) + k * kStep;
  const uint64_t e1 =
      descriptor(set + (ROLE == 0 ? 3 : 2) * kChunkBytes) + k * kStep;
  if (half == 0) {
    product<ROLE>(acc0, acc1, e0, e1, 0, 0, add || k > 0);  // hi.hi
    product<ROLE>(acc0, acc1, e0, e1, 0, 1, 1);             // hi.mid
    product<ROLE>(acc0, acc1, e0, e1, 1, 0, 1);             // mid.hi
  } else {
    product<ROLE>(acc0, acc1, e0, e1, 0, 2, 1);             // hi.lo
    product<ROLE>(acc0, acc1, e0, e1, 2, 0, 1);             // lo.hi
    product<ROLE>(acc0, acc1, e0, e1, 1, 1, 1);             // mid.mid
  }
}

// The rows of one block's stream, for warpgroup ROLE. The wgmma of tile
// q are issued in quarters between quarters of the split of tile q + 1.
template <int ROLE, bool AUG, typename VT, typename OT>
__device__ __forceinline__ void split_role(Smem& s, const float* table,
                                           const int32_t* cols,
                                           const VT* vals, OT* a_out,
                                           float* b_out, int p, int rows) {
  constexpr int N0 = ROLE == 0 ? 128 : 96;   // m64n256 | m64n192
  constexpr int N1 = ROLE == 0 ? 32 : 64;    // m64n64 | m64n128
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int warp = 4 * ROLE + (t >> 5);      // warp of the block
  // The gather: warp w copies half w % 2 of slots w / 2 + 4 i of each
  // tile, lane l the 16 bytes of lanes 128 (w % 2) + 4 l .. + 3, so one
  // warp instruction moves half a slot's 1 KB row; the thread splits
  // those floats. The ids and the values come by cp.async (threads
  // t < 32 of warpgroup 1, one slot each): the group of tile x carries
  // its rows, its values and the ids of tile x + kAhead.
  const int lane0 = 128 * (warp & 1) + 4 * lane;
  const int slot0 = warp >> 1;               // this thread's slots: + 4 i
  const bool aug_lane = AUG && lane0 == kF - 4;  // holds lane 255
  const int ntr = (p + kSlots - 1) / kSlots;  // tiles a row
  const int my_rows =
      rows > (int)blockIdx.x ? (rows - 1 - (int)blockIdx.x) / gridDim.x + 1
                             : 0;
  const int total = my_rows * ntr;           // tiles of this block
  const uint32_t stage_s = mma::smem_u32(&s.stage[0][0][0]);
  const uint32_t pieces_s = mma::smem_u32(&s.pieces[0][0]);

  // Two places in the stream of tiles, each moved one tile at a time:
  // the tile whose copies start next, and the tile whose ids are fetched
  // next (kAhead further on).
  struct Place {
    int q, k_row, ti;  // the stream tile, its row of this block, its tile
  };
  Place cp{0, 0, 0}, ip{0, 0, 0};
  auto first_of = [&](const Place& c, int64_t& first, int& len) {
    first = ((int64_t)blockIdx.x + (int64_t)c.k_row * gridDim.x) * p +
            c.ti * kSlots;
    len = min(kSlots, p - c.ti * kSlots);
  };
  auto advance = [&](Place& c) {
    if (c.q++ < total && ++c.ti == ntr) {
      c.ti = 0;
      ++c.k_row;
    }
  };
  auto fetch_ids = [&]() {
    if (ROLE == 1 && t < kSlots && ip.q < total) {
      int64_t first;
      int len;
      first_of(ip, first, len);
      wm::cp_async4(mma::smem_u32(&s.ids[ip.q % kIdRing][t]),
                    cols + first + (t < len ? t : 0), t < len ? 4 : 0);
    }
    advance(ip);
  };
  // the copies of the next tile: its rows and from warpgroup 1 its
  // values and the ids of a tile further on; one group a tile, also when
  // it is empty; slots past the row's end are zero-filled
  auto start_copies = [&]() {
    if (cp.q < total) {
      int64_t first;
      int len;
      first_of(cp, first, len);
      const int st = cp.q % kStages;
      const uint32_t base = stage_s + st * (kSlots * kF * 4) + lane0 * 4;
      const int32_t* ids = s.ids[cp.q % kIdRing];
#pragma unroll 1
      for (int i = 0; i < kSlotsPerThread; ++i) {
        const int slot = slot0 + 4 * i;
        const bool got = slot < len;
        const int32_t id = got ? ids[slot] : 0;
        mma::cp_async16(base + slot * (kF * 4),
                        table + (int64_t)id * kF + lane0, got ? 16 : 0);
      }
      if (ROLE == 1 && t < kSlots) {
        // the aligned word that holds the value (a bf16 value shares it)
        const uintptr_t at = reinterpret_cast<uintptr_t>(
            vals + first + (t < len ? t : 0));
        wm::cp_async4(mma::smem_u32(&s.vw[st][t]),
                      reinterpret_cast<const void*>(at & ~uintptr_t(3)),
                      t < len ? 4 : 0);
      }
    }
    advance(cp);
    fetch_ids();
    mma::cp_async_commit();
  };
  // the parity of a bf16 value's half of its word, for tile (row, ti)
  auto odd_of = [&](int64_t row, int ti) {
    return (int)((reinterpret_cast<uintptr_t>(vals + row * p + ti * kSlots)
                  >> 1) & 1);
  };
  // the split of this thread's slots i0 .. i1 - 1 of the tile in stage
  // st into the piece set q % 2
  auto split_slots = [&](int st, int qq, int odd, int i0, int i1) {
    unsigned char* set = s.pieces[qq & 1];
#pragma unroll 1
    for (int i = i0; i < i1; ++i) {
      const int slot = slot0 + 4 * i;
      float4 x = *reinterpret_cast<const float4*>(&s.stage[st][slot][lane0]);
      if constexpr (AUG) {
        const float v = wm::word_value<VT>(s.vw[st][slot], odd ^ (slot & 1));
        if (aug_lane) x.w = v;
      }
      uint2 hi, mid, lo;
      cumf::split::split2(x.x, x.y, hi.x, mid.x, lo.x);
      cumf::split::split2(x.z, x.w, hi.y, mid.y, lo.y);
      unsigned char* at = set + piece_offset(slot, lane0);
      *reinterpret_cast<uint2*>(at) = hi;
      *reinterpret_cast<uint2*>(at + kPieceBytes) = mid;
      *reinterpret_cast<uint2*>(at + 2 * kPieceBytes) = lo;
    }
  };

  float acc0[N0], acc1[N1];
#pragma unroll
  for (int i = 0; i < N0; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N1; ++i) acc1[i] = 0.f;
  // K2: lane threadIdx.x of the row's b, a sum of the tiles' sums kept
  // with its rounding error (TwoSum), so a long row's b stays within a
  // few ulps
  float b_acc = 0.f, b_err = 0.f;
  // the ids of the first tiles, then their copies
  for (int a = 0; a < kAhead; ++a) fetch_ids();
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  for (int a = 0; a < kAhead; ++a) start_copies();
  if (total > 0) {
    // the pieces of tile 0
    mma::cp_async_wait<kAhead - 1>();
    __syncthreads();
    split_slots(0, 0, odd_of(blockIdx.x, 0), 0, kSlotsPerThread);
    mma::fence_proxy_async();
    __syncthreads();
  }

  int q = 0;  // the stream tile the tensor cores take next
  for (int k_row = 0; k_row < my_rows; ++k_row) {
    const int64_t row = blockIdx.x + (int64_t)k_row * gridDim.x;
    for (int ti = 0; ti < ntr; ++ti, ++q) {
      const int st = q % kStages;
      const int len = min(kSlots, p - ti * kSlots);
      const int k_steps = (len + 15) / 16;
      const bool next = q + 1 < total;
      const int64_t row_n = ti + 1 < ntr ? row : row + gridDim.x;
      const int ti_n = ti + 1 < ntr ? ti + 1 : 0;
      const int st_n = (q + 1) % kStages;
      // this thread's copies of tile q + 1 landed; the wgmma of tile
      // q - 1 done (this warpgroup's)
      mma::cp_async_wait<kAhead - 2>();
      mma::wgmma_wait<0>();
      // every warpgroup's wgmma of tile q - 1 is done, so its piece set
      // is free; b of tile q - 1 has read its stage, which the next
      // copies fill; the values of tile q + 1 are visible
      __syncthreads();
      start_copies();  // tile q + kAhead
      const int odd_n = next ? odd_of(row_n, ti_n) : 0;
      const uint32_t set = pieces_s + (q & 1) * kSetBytes;
      mma::wgmma_fence();
      mma_quarter<ROLE>(acc0, acc1, set, 0, 0, ti > 0);
      if (next) split_slots(st_n, q + 1, odd_n, 0, 2);
      mma_quarter<ROLE>(acc0, acc1, set, 0, 1, ti > 0);
      if (next) split_slots(st_n, q + 1, odd_n, 2, 4);
      if (k_steps > 1) mma_quarter<ROLE>(acc0, acc1, set, 1, 0, true);
      if (next) split_slots(st_n, q + 1, odd_n, 4, 6);
      if (k_steps > 1) mma_quarter<ROLE>(acc0, acc1, set, 1, 1, true);
      if (next) split_slots(st_n, q + 1, odd_n, 6, 8);
      mma::wgmma_commit();
      if constexpr (!AUG) {
        // lane threadIdx.x over the tile's slots, two partial sums; the
        // slots past the row's end are zero in the stage and the values
        const int odd = odd_of(row, ti);
        float bt0 = 0.f, bt1 = 0.f;
        const float* g = &s.stage[st][0][0] + threadIdx.x;
        for (int j = 0; j < 16 * k_steps; j += 2) {
          const uint2 w = *reinterpret_cast<const uint2*>(&s.vw[st][j]);
          bt0 = fmaf(wm::word_value<VT>(w.x, odd), g[j * kF], bt0);
          bt1 = fmaf(wm::word_value<VT>(w.y, odd ^ 1), g[(j + 1) * kF],
                     bt1);
        }
        const float tile = bt0 + bt1;
        const float sum = b_acc + tile;
        const float part = sum - b_acc;
        b_err += (b_acc - (sum - part)) + (tile - part);
        b_acc = sum;
      }
      mma::fence_proxy_async();
      __syncthreads();  // the pieces of tile q + 1 are whole
    }
    mma::wgmma_wait<0>();
    mma::use_acc(acc0);
    mma::use_acc(acc1);
    if constexpr (!AUG) {
      b_out[row * kF + threadIdx.x] = b_acc + b_err;
      b_acc = b_err = 0.f;
    }
    // every wgmma of the row is done: the set of its last tile is free
    // (the other holds the next tile's pieces) and holds the staging
    // until the next tile's first barrier
    __syncthreads();
    OT* a_row = a_out + row * kF * kF;
    float* stg = reinterpret_cast<float*>(s.pieces[(q - 1) & 1]) +
                 ROLE * 64 * wm::kStageStride;
    if constexpr (ROLE == 0) {
      wm::store_strip<false, OT, true>(acc0, stg, a_row, nullptr, 0, 0, 0);
      wm::store_strip<false, OT, true>(acc1, stg, a_row, nullptr, 3, 3, 0);
    } else {
      wm::store_strip<false, OT, true>(acc0, stg, a_row, nullptr, 1, 1, 1);
      wm::store_strip<false, OT, true>(acc1, stg, a_row, nullptr, 2, 2, 1);
    }
  }
}

// The kernels and their host side have internal linkage (gram_mma.cuh).
namespace {

// K2 (AUG false: A and b) or K5a (AUG true: A' alone) at f = 256 on a
// float32 table: persistent blocks of two warpgroups, one row of A at a
// time. The warpgroup index comes through a shuffle so that the compiler
// sees each role's branch, and its wgmma, as uniform across the warp.
template <bool AUG, typename VT, typename OT>
__global__ void __launch_bounds__(kThreads, 1)
    panel_split_mma_kernel(const float* __restrict__ table,
                           const int32_t* __restrict__ cols,
                           const VT* __restrict__ vals,
                           OT* __restrict__ a_out, float* __restrict__ b_out,
                           int p, int rows) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = aligned_smem(smem_raw);
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  if (wg == 0)
    split_role<0, AUG>(s, table, cols, vals, a_out, b_out, p, rows);
  else
    split_role<1, AUG>(s, table, cols, vals, a_out, b_out, p, rows);
}

template <bool AUG, typename VT, typename OT>
int launch(const void* table, const void* cols, const void* vals, void* a_out,
           void* b_out, int r, int p, cudaStream_t stream) {
  // the ring is dynamic shared memory above 48 KB: allowed once per
  // instantiation
  static const cudaError_t allowed = cudaFuncSetAttribute(
      panel_split_mma_kernel<AUG, VT, OT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  // one block an SM, each walking its share of rows
  static const int resident = mma::sm_count();
  panel_split_mma_kernel<AUG, VT, OT>
      <<<r < resident ? r : resident, kThreads, kSmemBytes, stream>>>(
          (const float*)table, (const int32_t*)cols, (const VT*)vals,
          (OT*)a_out, (float*)b_out, p, r);
  return (int)cudaGetLastError();
}

// The host side of both kernels: r rows of p slots of a float32 table at
// f = 256. Returns the CUDA error.
template <bool AUG>
int run(const void* table, const void* cols, const void* vals, int vals_bf16,
        void* a_out, int out_bf16, void* b_out, int r, int p,
        cudaStream_t stream) {
#define CUMF_WIDE_SPLIT_LAUNCH(VT, OT) \
  return launch<AUG, VT, OT>(table, cols, vals, a_out, b_out, r, p, stream)
  if (vals_bf16) {
    if (out_bf16) CUMF_WIDE_SPLIT_LAUNCH(__nv_bfloat16, __nv_bfloat16);
    CUMF_WIDE_SPLIT_LAUNCH(__nv_bfloat16, float);
  }
  if (out_bf16) CUMF_WIDE_SPLIT_LAUNCH(float, __nv_bfloat16);
  CUMF_WIDE_SPLIT_LAUNCH(float, float);
#undef CUMF_WIDE_SPLIT_LAUNCH
}

}  // namespace

}  // namespace wide_split
}  // namespace cumf
