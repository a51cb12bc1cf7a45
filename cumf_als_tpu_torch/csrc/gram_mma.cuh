// The tensor-core Gram body: A = G^T G over the gathered (P, 128) bf16
// slab of one row, as a 128 x 128 x P product on Hopper's warpgroup MMA,
// fed by an asynchronous gather. The panel kernels gather_gram_out.cu
// (K2) and gather_gram_aug_out.cu (K5a) write the row's sums out
// (gram_mma_kernel below); the fused kernels gather_gram_cg.cu (K1) and
// gather_gram_cg_aug.cu (K6) solve on them where they lie
// (frag_cg.cuh).
//
// It takes a bf16 table at f = 128 only (the width of the main path).
// On a float32 table bf16 tensor cores would round the entries and TF32
// would miss the f32 tolerance: there K2 and K5a take the split-bf16
// body of split_gram_mma.cuh (this file's tile layout, descriptors and
// wgmma on three bf16 pieces of each entry), and K1 and K6 keep
// common.cuh's FMA gram_row, as a bf16 table at f < 128 does. The
// wrappers of ops/cuda_solve.py choose by dtype and f alone; nothing
// falls back from one body to another.
//
// A block of 256 threads (two warpgroups) takes one row at a time, two
// blocks an SM, each block walking its share of the chunk's rows as one
// stream of tiles: the gather of the next row is in flight while the last
// tiles of this one are multiplied and its sums are written (or solved).
// A row holds the slots its caller names (all P of them in K2 and K5a,
// the first min(nnz, P) in K1 and K6), and a row without slots has no
// tiles. One block walks all the slots of its row, so a chunk with fewer
// rows than the blocks that fit the card (two an SM) would leave SMs
// idle. K2 and K5a cut such a chunk across blocks instead (the wrappers'
// rule, gram_spans in ops/cuda_solve.py): each row's P slots in S spans
// of whole tiles, this kernel run unchanged over the (R S, P / S) view of
// cols and vals, so that span s of row r is row r S + s of the view and
// writes its f32 partial (A, and K2's b) to scratch, then pass 2
// (gram_span_sum.cu) adds each row's S partials in span order into A in
// A's dtype. What bounds the cut: the gather, as uncut, now spread over
// the card, then the partials' bytes, 64.5 KB a span written and read
// once more. K1 and K6 cut such a chunk the same way at f = 128
// (frag_cg.cuh: pass 1 this stream over the view, each span stopping at
// the row's nnz, `SpanLen`, and writing its f32 record; pass 2 adds a
// row's records in span order and solves, frag_span_solve.cu).
//
// The tile. 64 slots of the row make one 16 KB tile in shared memory,
// kept bf16 as gathered. It is stored [slot][lane] as two halves of
// [64 slots][64 lanes], each slot a 128-byte line, under the 128-byte
// swizzle: the 16-byte piece j (0..15) of slot t lies in half j / 8 at
// line t, piece position (j % 8) ^ (t % 8). This is the canonical
// MN-major layout of a wgmma operand (CuTe: Layout_MN_SW128_Atom, in
// units of 16 bytes ((8, n), (8, k)) : ((1, LBO), (8, SBO))): 8 slots of
// one half are one 1024-byte swizzle atom, SBO = 1024 bytes steps to the
// next 8 slots, LBO = 8192 bytes to the other half. Both operands of
// D = G^T G are this one tile: for A = G^T the M dimension is the lane,
// for B = G the N dimension is, and the lane is contiguous for both, so
// both are MN-major (tnspA = tnspB = 1, which bf16 allows). A k-step of
// 16 slots advances the start address by 16 lines = 2048 bytes.
//
// The gather. cp.async, 16 bytes a thread: 16 neighbouring threads copy
// the 256-byte table row of one slot, each thread 4 slots of a tile, the
// destination computed under the swizzle. A ring of kStages tiles holds
// kAhead tiles of loads in flight, one tile under the tensor cores and
// one draining (wgmma.wait_group 1). The ids of the next tile to copy
// and the values of the tiles in flight wait in registers. Slots beyond
// the row's last in its last tile are zero-filled (cp.async with a source
// size of 0); pad slots among the row's slots name the table's zero row
// and need nothing. Inside the loop over a row's tiles nothing but wgmma
// touches the sums (a row's first wgmma overwrites them instead of a
// zeroing store): plain code on those registers there makes ptxas wait
// for every wgmma at each turn (its note C7517).
//
// What rides along. The thread that copied the last piece of a slot owns
// the slot's value: after its own copies have landed it stores the value
// as f32 into the tile's value line (WITH_B: b = sum v g is summed from
// the bf16 tile on the CUDA cores, two lanes a thread, a quarter of the
// slots each, while the tile's wgmma runs; WITH_R2, the fused kernel
// K1, also has the owner add v^2 to its part of r2 = sum v^2 in shared
// memory), and with AUG it stores the value, rounded to bf16 as the
// table stores it, over lane 127 of the slot.
// Then fence.proxy.async (cp.async and plain stores write through the
// generic proxy, wgmma reads through the async proxy), the block's
// barrier, and wgmma.fence before the first wgmma.
//
// The accumulator: warpgroup w holds rows 64 w .. 64 w + 63 of A, all 128
// columns, as the m64n128 fragment: thread t of the warpgroup (warp
// t / 32, lane t % 32) keeps acc[4 i + {0, 1}] = A[16 warp + lane / 4]
// [8 i + 2 (lane % 4) + {0, 1}] and acc[4 i + {2, 3}] the same columns of
// the row 8 below. The CG of K1 and K6 (frag_cg.cuh) reads A there.
#pragma once

#include "common.cuh"

namespace cumf {
namespace mma {

constexpr int kF = 128;      // lanes of a tile (the only width taken)
constexpr int kSlots = 64;   // slots of a tile
constexpr int kStages = 4;   // tiles of the ring
constexpr int kAhead = kStages - 2;  // tiles of loads in flight
constexpr int kThreads = 256;        // two warpgroups
constexpr int kLine = 128;           // bytes of one slot in one half
constexpr int kHalfBytes = kSlots * kLine;  // [64 slots][64 lanes] bf16
constexpr int kTileBytes = 2 * kHalfBytes;
constexpr int kKStepBytes = 16 * kLine;     // 16 slots of a half
constexpr int kSlotsPerThread = kSlots * (kF / 8) / kThreads;  // 4
static_assert(kSlotsPerThread == 4, "16 threads a slot, 4 slots a thread");

// Shared memory of one block, placed at a 1024-byte boundary (the swizzle
// is a function of the address).
struct Smem {
  unsigned char tiles[kStages][kTileBytes];
  float v[kStages][kSlots];  // the slots' values, f32
  float b[3][kF];            // WITH_B: b of the slots' upper quarters
  float r2[16];              // WITH_R2: r2 of each value owner's slots
};
constexpr int kSmemBytes = (int)sizeof(Smem) + 1024;

__device__ __forceinline__ Smem& aligned_smem(unsigned char* raw) {
  const uintptr_t p = (reinterpret_cast<uintptr_t>(raw) + 1023) &
                      ~static_cast<uintptr_t>(1023);
  return *reinterpret_cast<Smem*>(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (slot, lane) inside a tile.
__device__ __forceinline__ int tile_offset(int slot, int lane) {
  const int piece = lane >> 3;
  return (piece >> 3) * kHalfBytes + slot * kLine +
         (((piece & 7) ^ (slot & 7)) << 4) + ((lane & 7) << 1);
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins a use of the sums after a wait. Input operands only: an output
// operand would define the sums anew, the new values would meet the ones
// still in flight at the loop's join, and ptxas would then wait for every
// wgmma at each turn of the loop (its note C7517).
template <int N>
__device__ __forceinline__ void use_acc(const float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" ::"f"(acc[i]) : "memory");
}

// Matrix descriptor of an MN-major operand under the 128-byte swizzle
// that starts at shared address `addr` (a multiple of 2048 bytes past a
// tile half, so the swizzle phase is that of the tile).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);  // start address
  d |= (uint64_t)(kHalfBytes >> 4) << 16;          // LBO: the other half
  d |= (uint64_t)(8 * kLine >> 4) << 32;           // SBO: the next 8 slots
  d |= (uint64_t)1 << 62;                          // 128-byte swizzle
  return d;
}

// acc = A^T B (+ acc if `add`) over 16 slots: m64n128k16, bf16 in, f32
// out, both operands MN-major (the last two immediates).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(add));
}

// The same over 256 columns of B (four 64-lane halves, LBO apart):
// m64n256k16.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
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
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n"
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
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(add));
}

// The slots of a row that the stream walks: every slot of the panel
// kernels' rows, the first min(nnz, p) of the fused kernels' (the plans
// put every pad slot at the tail of its row).
struct AllSlots {
  int p;
  __device__ __forceinline__ int operator()(int) const { return p; }
};
struct LiveSlots {
  const int32_t* nnz;
  int p;
  __device__ __forceinline__ int operator()(int row) const {
    return min(__ldg(nnz + row), p);
  }
};
// The live slots of a span in the cut of K1 and K6: the chunk's (R, P)
// cols and vals read as (R S, L), L = P / S, so that row v = r S + s of
// that view holds slots [s L, (s + 1) L) of row r, of which the first
// clamp(min(nnz[r], P) - s L, 0, L) are live. A span past its row's nnz
// has none, and so no tiles.
struct SpanLen {
  const int32_t* nnz;
  int spans, len;
  __device__ __forceinline__ int operator()(int v) const {
    const int r = v / spans;
    const int n = min(__ldg(nnz + r), spans * len) - (v - r * spans) * len;
    return max(0, min(n, len));
  }
};

// The gather's side of a stream of tiles, shared by gram_stream below and
// split_stream (split_gram_mma.cuh): a cursor at the next tile to copy,
// its slots' ids, the values of the tiles in flight, and the cp.async of
// a tile. The block takes rows blockIdx.x, blockIdx.x + gridDim.x, ... as
// ONE stream of tiles (a row of n slots gives ceil(n / 64) of them, a row
// of none gives none). Each slot's table row is kF entries of T, copied
// 16 bytes a thread by TPS threads: thread t copies piece t % TPS of
// slots NS (t / TPS) .. + NS - 1 of every tile, and the thread of the
// last piece owns those slots' values. AHEAD tiles of loads are in
// flight; v[0] holds the values of the oldest. A copy's destination is
// dst(q, slot), the shared address of this thread's piece of `slot` in
// stream tile q. The wrappers keep rows * p below 2^31.
template <typename T, int NS, int TPS, int AHEAD, typename VT,
          typename RowLen>
struct Feed {
  static_assert(TPS == 16 || TPS == 32, "16 or 32 threads a slot");
  static constexpr int kTpsShift = TPS == 16 ? 4 : 5;
  const T* table;
  const int32_t* cols;
  const VT* vals;
  int p, rows;
  RowLen row_len;
  int piece, slot0;  // which 16 bytes of a table row; this thread's slots
  bool owner;        // owns the values of its slots
  // the cursor: a tile of row `row`, which holds slots [first, first + n)
  // of cols and vals (n: the row's slots left); past the stream
  // row >= rows and n = 0
  int row, n, first;
  int id[NS];          // ids of the cursor's tile, -1 beyond its slots
  float v[AHEAD][NS];  // values of the tiles in flight
  float v_new[NS];     // values of the tile whose copies started last

  __device__ __forceinline__ Feed(const T* table_, const int32_t* cols_,
                                  const VT* vals_, int p_, int rows_,
                                  const RowLen& row_len_)
      : table(table_), cols(cols_), vals(vals_), p(p_), rows(rows_),
        row_len(row_len_),
        // signed, as the slot indices they feed (cols + first + slot0)
        piece((int)threadIdx.x & (TPS - 1)),
        slot0(((int)threadIdx.x >> kTpsShift) * NS),
        owner(piece == TPS - 1),
        row(blockIdx.x) {
    enter_row();
  }
  // enter row `row`, or the first row after it that has slots
  __device__ __forceinline__ void enter_row() {
    for (;; row += gridDim.x) {
      first = row * p;
      n = row < rows ? row_len(row) : 0;
      if (n > 0 || row >= rows) return;
    }
  }
  __device__ __forceinline__ void step() {
    first += kSlots;
    n -= kSlots;
    if (n <= 0) {
      row += gridDim.x;
      enter_row();
    }
  }
  __device__ __forceinline__ void load_ids() {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      id[i] = slot0 + i < n ? __ldg(cols + first + slot0 + i) : -1;
  }
  __device__ __forceinline__ void load_vals(float (&out)[NS]) const {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      out[i] = owner && slot0 + i < n ? to_f32(vals[first + slot0 + i])
                                      : 0.f;
  }
  // Start the copies of the cursor's tile as stream tile q.
  template <typename Dst>
  __device__ __forceinline__ void copy(int q, const Dst& dst) const {
    if (row < rows) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const bool live = id[i] >= 0;
        const T* src = table + (int64_t)(live ? id[i] : 0) * kF +
                       piece * (16 / (int)sizeof(T));
        cp_async16(dst(q, slot0 + i), src, live ? 16 : 0);
      }
    }
    cp_async_commit();  // one group a tile, also when it is empty
  }
  // Stream tiles 0 .. AHEAD - 1 in flight, and the ids of the next.
  template <typename Dst>
  __device__ __forceinline__ void prime(const Dst& dst) {
#pragma unroll
    for (int a = 0; a < AHEAD; ++a) {
      load_ids();
      copy(a, dst);
      load_vals(v[a]);
      step();
    }
    load_ids();
  }
  // Once the stage of stream tile q is free: the cursor's tile, stream
  // tile q, in flight, its values in v_new, and the ids of the next.
  template <typename Dst>
  __device__ __forceinline__ void next(int q, const Dst& dst) {
    copy(q, dst);
    load_vals(v_new);
    step();
    load_ids();
  }
  // The tile the tensor cores took is done with its values: the queue
  // moves up, the values of the tile that started last at its end.
  __device__ __forceinline__ void shift() {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
#pragma unroll
      for (int a = 0; a + 1 < AHEAD; ++a) v[a][i] = v[a + 1][i];
      v[AHEAD - 1][i] = v_new[i];
    }
  }
};

// Gather + Gram over the rows that fall to this block, row r over its
// first row_len(r) slots of p, as one stream of tiles (Feed), so that the
// gather of the next row is in flight while this one's last tiles are
// multiplied and its sums are written.
// Per row: acc (this thread's part of the fragment described at the head
// of this file) = G^T G; with AUG the slot's value replaces lane 127 of
// its gathered row; with WITH_B, b0 and b1 = sum v g over this thread's
// quarter of the slots (thread t: lanes 2 (t % 64) and 2 (t % 64) + 1,
// slots 16 (t / 64) .. + 15 of every tile); with WITH_R2, s.r2[t / 16]
// = sum v^2 over the slots that thread t owns (the 16 threads
// t % 16 == 15), in shared memory, where it costs no register in the
// tile loop. After a row's last wgmma the whole block calls done(row, n,
// acc, b0, b1), which may use barriers but must not write acc, and must
// have read s.r2 before its last barrier; then the sums start again. A
// row of n = 0 slots ran no wgmma: acc still holds the last row's sums,
// and done() must read them as zeros.
template <bool AUG, bool WITH_B, bool WITH_R2, typename VT, typename RowLen,
          typename RowDone>
__device__ __forceinline__ void gram_stream(Smem& s,
                                            const __nv_bfloat16* table,
                                            const int32_t* cols,
                                            const VT* vals, int p, int rows,
                                            const RowLen& row_len,
                                            const RowDone& done) {
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const uint32_t tiles_s = smem_u32(&s.tiles[0][0]);
  Feed<__nv_bfloat16, kSlotsPerThread, 16, kAhead, VT, RowLen> feed(
      table, cols, vals, p, rows, row_len);
  const int slot0 = feed.slot0;
  const int lane0 = feed.piece * 8;  // the first lane this thread copies
  auto dst = [&](int q, int slot) {
    return tiles_s + (q % kStages) * kTileBytes + tile_offset(slot, lane0);
  };

  // Nothing but wgmma touches acc inside the loop over a row's tiles: a
  // row's first wgmma overwrites it (a row's first tile always holds
  // slots), so one tile's sums stay in flight across the next tile's
  // barrier.
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float b_sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // WITH_B: [sum][lane]
  if (WITH_R2 && feed.owner) s.r2[tid >> 4] = 0.f;
  feed.prime(dst);

  int q = 0;  // the stream tile the tensor cores take next
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int n = row_len(row);
    // the tiles of one row; inside this loop nothing but wgmma touches acc
    for (int lo = 0; lo < n; lo += kSlots, ++q) {
      const int buf = q % kStages;
      unsigned char* tile = s.tiles[buf];
      cp_async_wait<kAhead - 1>();  // this thread's copies of tile q landed
      if (feed.owner) {
        float sq = 0.f;  // WITH_R2: this tile's part
#pragma unroll
        for (int i = 0; i < kSlotsPerThread; ++i) {
          if constexpr (WITH_B) s.v[buf][slot0 + i] = feed.v[0][i];
          if constexpr (WITH_R2) sq = fmaf(feed.v[0][i], feed.v[0][i], sq);
          if constexpr (AUG)
            *reinterpret_cast<__nv_bfloat16*>(
                tile + tile_offset(slot0 + i, kF - 1)) =
                __float2bfloat16(feed.v[0][i]);
        }
        if constexpr (WITH_R2) s.r2[tid >> 4] += sq;
      }
      fence_proxy_async();
      // Tile q is whole; every thread has left the wgmma wait of iteration
      // q - 1, so the wgmma of tile q - 2 is done and its buffer is free.
      __syncthreads();
      feed.next(q + kAhead, dst);  // the cursor is at tile q + kAhead

      const int k_steps = (min(kSlots, n - lo) + 15) / 16;
      const uint32_t base = tiles_s + buf * kTileBytes;
      wgmma_fence();
      for (int k = 0; k < k_steps; ++k)
        wgmma_m64n128k16(acc,
                         descriptor(base + wg * kHalfBytes + k * kKStepBytes),
                         descriptor(base + k * kKStepBytes),
                         lo > 0 || k > 0);
      wgmma_commit();
      if constexpr (WITH_B) {
        // this thread's two lanes over its quarter of the tile's slots: 8
        // slots (one swizzle atom) a step, one 4-byte load a slot
        const int lanes = 2 * (tid & (kF / 2 - 1));
        const int first_atom = (tid >> 6) * (kSlots / 32);
        const int last_atom = min(first_atom + kSlots / 32, 2 * k_steps);
        for (int atom = first_atom; atom < last_atom; ++atom) {
          const float4 va =
              *reinterpret_cast<const float4*>(&s.v[buf][8 * atom]);
          const float4 vb =
              *reinterpret_cast<const float4*>(&s.v[buf][8 * atom + 4]);
          const float v8[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
          const unsigned char* g = tile + atom * (8 * kLine);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            // two bf16, the lower lane in the low half: widen by shifting
            const uint32_t pair =
                *reinterpret_cast<const uint32_t*>(g + tile_offset(j, lanes));
            b_sum[j & 1][0] =
                fmaf(v8[j], __uint_as_float(pair << 16), b_sum[j & 1][0]);
            b_sum[j & 1][1] = fmaf(v8[j], __uint_as_float(pair & 0xffff0000u),
                                   b_sum[j & 1][1]);
          }
        }
      }
      wgmma_wait<1>();
      feed.shift();
    }
    wgmma_wait<0>();
    use_acc(acc);
    done(row, n, acc, b_sum[0][0] + b_sum[1][0], b_sum[0][1] + b_sum[1][1]);
    b_sum[0][0] = b_sum[0][1] = b_sum[1][0] = b_sum[1][1] = 0.f;
    if (WITH_R2 && feed.owner) s.r2[tid >> 4] = 0.f;
  }
}

template <typename OT>
__device__ __forceinline__ void store4(OT* dst, float a, float b, float c,
                                       float d);
template <>
__device__ __forceinline__ void store4<float>(float* dst, float a, float b,
                                              float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      float a, float b,
                                                      float c, float d) {
  // round to nearest even, as astype does
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 bits;
  bits.x = *reinterpret_cast<uint32_t*>(&lo);
  bits.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = bits;
}

// Write this thread's part of the fragment to the row's 128 x 128 A in
// device memory. The two lanes of a pair trade half their entries first
// (the even lane keeps the upper row, the odd lane the row 8 below), so
// that each thread stores 4 neighbouring columns at once.
template <typename OT>
__device__ __forceinline__ void store_fragment(const float (&acc)[64],
                                               OT* out) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool odd = lane & 1;
  const int row = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2) +
                  (odd ? 8 : 0);
  const int col0 = (lane & 2) * 2;
  OT* dst = out + row * kF + col0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float give0 = odd ? acc[4 * i] : acc[4 * i + 2];
    const float give1 = odd ? acc[4 * i + 1] : acc[4 * i + 3];
    const float got0 = __shfl_xor_sync(0xffffffffu, give0, 1);
    const float got1 = __shfl_xor_sync(0xffffffffu, give1, 1);
    if (odd)
      store4<OT>(dst + 8 * i, got0, got1, acc[4 * i + 2], acc[4 * i + 3]);
    else
      store4<OT>(dst + 8 * i, acc[4 * i], acc[4 * i + 1], got0, got1);
  }
}

// Write b of one row (its 128 lanes at `out`) from each thread's sums
// over its quarter of the slots (b0, b1: lanes 2 (t % 64) and
// 2 (t % 64) + 1), the four quarters added in a fixed order through `sb`.
// The whole block calls it; it holds a barrier.
__device__ __forceinline__ void store_b(float (&sb)[3][kF], float b0,
                                        float b1, float* out) {
  const int tid = threadIdx.x;
  const int lanes = 2 * (tid & (kF / 2 - 1));
  const int quarter = tid >> 6;
  if (quarter > 0)
    *reinterpret_cast<float2*>(&sb[quarter - 1][lanes]) = make_float2(b0, b1);
  __syncthreads();
  if (quarter == 0) {
    float2 sum = make_float2(b0, b1);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sum.x += sb[k][lanes];
      sum.y += sb[k][lanes + 1];
    }
    *reinterpret_cast<float2*>(out + lanes) = sum;
  }
}

// The kernels and their host side have internal linkage: every source
// that includes this file is built into a library of its own, and two
// libraries loaded into one process must not share a kernel's host stub
// or the once-per-instantiation statics below.
namespace {

// K2 (AUG false: A and b) or K5a (AUG true: A' alone) on the tensor
// cores, over the rows of gram_stream. The stores of a row drain while
// the block multiplies the next one.
template <bool AUG, typename VT, typename OT>
__global__ void __launch_bounds__(kThreads, 2)
    gram_mma_kernel(const __nv_bfloat16* __restrict__ table,
                    const int32_t* __restrict__ cols,
                    const VT* __restrict__ vals, OT* __restrict__ a_out,
                    float* __restrict__ b_out, int p, int rows) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = aligned_smem(smem_raw);
  gram_stream<AUG, !AUG, false>(
      s, table, cols, vals, p, rows, AllSlots{p},
      [&](int row, int, const float (&acc)[64], float b0, float b1) {
        store_fragment<OT>(acc, a_out + (int64_t)row * kF * kF);
        if constexpr (!AUG) store_b(s.b, b0, b1, b_out + (int64_t)row * kF);
      });
}

// SMs of the current device, the one the wrapper launches on
inline int sm_count() {
  int device = 0, n = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return n > 0 ? n : 1;
}

template <bool AUG, typename VT, typename OT>
int launch(const void* table, const void* cols, const void* vals, void* a_out,
           void* b_out, int r, int p, cudaStream_t stream) {
  // the ring of tiles is dynamic shared memory above 48 KB: allowed once
  // per instantiation
  static const cudaError_t allowed = cudaFuncSetAttribute(
      gram_mma_kernel<AUG, VT, OT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  // two blocks an SM (the launch bound), each walking its share of rows
  static const int resident = 2 * sm_count();
  gram_mma_kernel<AUG, VT, OT>
      <<<r < resident ? r : resident, kThreads, kSmemBytes, stream>>>(
          (const __nv_bfloat16*)table, (const int32_t*)cols, (const VT*)vals,
          (OT*)a_out, (float*)b_out, p, r);
  return (int)cudaGetLastError();
}

// The host side of both kernels: r rows of p slots. Returns the CUDA
// error.
template <bool AUG>
int run(const void* table, const void* cols, const void* vals, int vals_bf16,
        void* a_out, int out_bf16, void* b_out, int r, int p,
        cudaStream_t stream) {
#define CUMF_MMA_LAUNCH(VT, OT) \
  return launch<AUG, VT, OT>(table, cols, vals, a_out, b_out, r, p, stream)
  if (vals_bf16) {
    if (out_bf16) CUMF_MMA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
    CUMF_MMA_LAUNCH(__nv_bfloat16, float);
  }
  if (out_bf16) CUMF_MMA_LAUNCH(float, __nv_bfloat16);
  CUMF_MMA_LAUNCH(float, float);
#undef CUMF_MMA_LAUNCH
}

}  // namespace

}  // namespace mma
}  // namespace cumf
