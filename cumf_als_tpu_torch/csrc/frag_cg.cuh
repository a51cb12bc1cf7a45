// The tensor-core body of the fused kernels gather_gram_cg.cu (K1) and
// gather_gram_cg_aug.cu (K6) at f = 128 with a bf16 table: gram_mma.cuh's
// gather and Gram over the first min(nnz, P) slots of each row, then the
// regularized CG and the row's train error on the wgmma fragment where it
// lies. The 128 x 128 f32 A stays in registers; it never goes through
// shared or device memory.
//
// The fragment (gram_mma.cuh): thread t of the block (warp w = t / 32,
// lane l = t % 32, quad position k = l % 4) holds rows lo = 16 w + l / 4
// and hi = lo + 8 of A, columns 8 i + 2 k + {0, 1} for i < 16: the four
// threads of a quad hold two whole rows between them.
//
// The CG keeps each vector (x, r, p, b and A p) by rows, one entry a
// thread: thread k of a quad keeps row lo (k = 0, 2) or hi (k = 1, 3) in
// registers, the threads k = 2, 3 as copies that add zeros to the dots
// (a second entry a thread would not fit beside the fragment and the
// stream's state in the 128 registers of two blocks an SM). A matvec
// reads the vector it multiplies from shared memory (32 FMAs a row
// against its 32 columns), adds over the quad (__shfl_xor 1 and 2) and
// adds diag * v itself: the regularizer never enters acc. With AUG, row
// and column 127 read as zero there (only the diagonal is left in row
// 127), and b and r2 come out of row 127 first. A dot adds over the warp
// by butterfly (__shfl_xor 1 .. 16), then the 8 warp sums through shared
// memory in a fixed order, so every thread holds the same bits and the
// block leaves the loop as one. b and r2 stay in shared memory and are
// read where they are needed.
//
// Block barriers per row: 2 to set up (b, r2 and x0 in; p out and r.r),
// 3 a CG step (p.Ap; r.r; p out), 2 for the tail (x out; x.b and
// x^T A x): 22 for CG-6 that runs to its end, against about 60 in
// common.cuh's cg_loop.
//
// Semantics: those of common.cuh's cg_loop, the transcription of
// cumf_als_tpu/ops/pallas_solve.py:_cg_loop: the warm start x0, x and r
// updated with this step's alpha before the test rsnew < cg_tol,
// alpha = 0 when p.Ap == 0 (a NaN stays NaN), beta guarded by
// rsold <= 0; the block holds one row at a time, so the per-system freeze
// is a `break` that every thread takes together. Then x *= [nnz > 0] and
// se = max(r2 - 2 x.b + x^T A_raw x, 0), A_raw the Gram without its
// diagonal (x^T (A - diag I) x of the Pallas kernel), a NaN staying NaN.
// A row without slots (nnz 0, the dummy tail rows of a chunk) ran no
// wgmma: its acc still holds the last row's sums and is read as zeros.
//
// Overlap: done() runs while the gather of the next row's first kAhead
// tiles is in flight, and the other block on the SM keeps the tensor
// cores busy.
//
// The cut of a chunk of few rows. One block walks all the slots of its
// row, so a chunk of fewer rows than the blocks that fit the card (two
// an SM) leaves SMs idle: on one row of 187,933 ratings the uncut kernel
// takes ~4.6 ms on one SM while 131 wait. The wrapper (ops/cuda_solve.py,
// `theta_spans`: the rule of K2's cut, no span under 8 tiles) cuts such
// a chunk into S spans of whole 64-slot tiles a row and runs two passes:
//   pass 1 (span_gram_kernel, launched through K1's or K6's own entry
//     point): gram_stream over the (R S, P / S) view of cols and vals,
//     span s of row r its row r S + s, each span over its live slots
//     (`SpanLen`: none past the row's nnz, so no tiles and no record);
//     a span with slots writes its f32 record, A (and K1's b and r2,
//     summed as the uncut kernel sums them; K6's A' holds b and r2 in
//     row 127) to scratch;
//   pass 2 (span_solve_kernel, frag_span_solve.cu): one block a row adds
//     the row's live records in span order straight into the wgmma
//     fragment's layout and runs frag_cg_row on it, the same CG, the same
//     barriers and the same train error as the uncut kernel. A span past
//     the row's nnz was never written and is never read.
// No atomics and a fixed order: a result repeats bit for bit. The cut
// also shortens the f32 sums of the fragment (a span's wgmma adds one
// 16-slot step at a time), and so the error of A, b and r2 on a long
// row.
#pragma once

#include "gram_mma.cuh"

namespace cumf {
namespace mma {

// Shared memory of the CG, placed after the Gram's Smem.
struct CgSmem {
  float bq[4][kF];  // K1: b of the four slot quarters; K6: b in bq[0]
  float x[kF];      // x0, later the solution, for a matvec
  float p[kF];      // the search direction, for a matvec
  float red[4][8];  // warp sums: p.Ap, r.r, x.b, x^T A_raw x
  float r2[1];      // K6: r2 (K1's parts are in Smem::r2)
};
constexpr int kCgSmemBytes = kSmemBytes + (int)sizeof(CgSmem);

// (A_raw v) at this thread's rows lo and hi, added over the quad (the
// four threads get the same bits). With AUG column 127 reads as zero.
template <bool AUG>
__device__ __forceinline__ float2 frag_matvec(const float (&acc)[64],
                                              const float* v, int k) {
  const float* vk = v + 2 * k;
  float lo = 0.f, hi = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 w = *reinterpret_cast<const float2*>(vk + 8 * i);
    float a_lo = acc[4 * i + 1], a_hi = acc[4 * i + 3];
    if (AUG && i == 15 && k == 3) a_lo = a_hi = 0.f;  // column 127
    lo = fmaf(acc[4 * i], w.x, lo);
    lo = fmaf(a_lo, w.y, lo);
    hi = fmaf(acc[4 * i + 2], w.x, hi);
    hi = fmaf(a_hi, w.y, hi);
  }
  lo += __shfl_xor_sync(0xffffffffu, lo, 1);
  lo += __shfl_xor_sync(0xffffffffu, lo, 2);
  hi += __shfl_xor_sync(0xffffffffu, hi, 1);
  hi += __shfl_xor_sync(0xffffffffu, hi, 2);
  return make_float2(lo, hi);
}

// The sum over the warp of one value a thread; every lane gets the same
// bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// The 8 warp sums, added in a fixed order.
__device__ __forceinline__ float sum8(const float* red) {
  const float4 a = *reinterpret_cast<const float4*>(red);
  const float4 b = *reinterpret_cast<const float4*>(red + 4);
  return ((((((a.x + a.y) + a.z) + a.w) + b.x) + b.y) + b.z) + b.w;
}

// The sum over the block of one value a thread, through red (8 floats
// that no thread may write again before every thread has read them):
// one barrier.
__device__ __forceinline__ float block_sum(float* red, float v) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return sum8(red);
}

// done() of the fused kernels: CG and train error of one row from its
// Gram in acc (n slots; n = 0: no Gram), b0 and b1 of gram_stream and
// r2s, its 16 parts of r2 (K1; K6 takes r2 out of acc into c.r2 and
// passes that), x0 in, x and se out.
template <bool AUG>
__device__ __forceinline__ void frag_cg_row(
    CgSmem& c, int row, int n, const float (&acc)[64], float b0, float b1,
    const float* r2s, const int32_t* nnz, const float* x0, float* x_out,
    float* se_out, float lam, int cg_iters, float cg_tol) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k = lane & 3;
  const bool keeper = k < 2;  // k = 2, 3 keep copies
  const int own = 16 * warp + (lane >> 2) + 8 * (k & 1);  // the kept row
  // acc holds the kept row's sums (with AUG row 127 keeps its diagonal)
  const bool own_live = n > 0 && !(AUG && own == kF - 1);
  const float nnzf = (float)nnz[row];
  const float diag = nnzf * lam + (nnzf == 0.f ? 1.f : 0.f);

  // b, r2 and x0 in
  if constexpr (AUG) {
    // row 127 (warp 7, lanes 28-31, their row hi): b in its columns
    // < 127, r2 in the corner; taken out before the matvec masks them
    if (warp == 7 && lane >= 28) {
      const bool live = n > 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 8 * i + 2 * k;
        const bool corner = i == 15 && k == 3;
        c.bq[0][col] = live ? acc[4 * i + 2] : 0.f;
        c.bq[0][col + 1] = live && !corner ? acc[4 * i + 3] : 0.f;
        if (corner) c.r2[0] = live ? acc[4 * i + 3] : 0.f;
      }
    }
  } else {
    *reinterpret_cast<float2*>(&c.bq[tid >> 6][2 * (tid & (kF / 2 - 1))]) =
        make_float2(b0, b1);
  }
  if (tid < kF) c.x[tid] = x0[(int64_t)row * kF + tid];
  __syncthreads();

  // b at row i: K1 adds the four quarters of the slots in a fixed order
  auto b_at = [&](int i) {
    if constexpr (AUG)
      return c.bq[0][i];
    else
      return ((c.bq[0][i] + c.bq[1][i]) + c.bq[2][i]) + c.bq[3][i];
  };
  // (A_raw v) at the kept row
  auto raw = [&](const float* v) {
    const float2 y = frag_matvec<AUG>(acc, v, k);
    return own_live ? ((k & 1) ? y.y : y.x) : 0.f;
  };

  float x = c.x[own];
  float r = b_at(own) - fmaf(diag, x, raw(c.x));
  float p = r;
  if (keeper) c.p[own] = p;
  float rsold = block_sum(c.red[1], keeper ? r * r : 0.f);
  for (int it = 0; it < cg_iters; ++it) {
    const float ap = fmaf(diag, p, raw(c.p));
    const float pap = block_sum(c.red[0], keeper ? p * ap : 0.f);
    // the Pallas guard, literally: a zero p.Ap gives alpha 0, a NaN one
    // gives NaN (so a NaN system stays NaN)
    const float nonzero = fabsf(pap) > 0.f ? 1.f : 0.f;
    const float alpha = nonzero * rsold / (pap + (1.f - nonzero));
    x = x + alpha * p;
    r = r - alpha * ap;
    const float rsnew = block_sum(c.red[1], keeper ? r * r : 0.f);
    if (!(rsnew >= cg_tol)) break;  // per-system exit, after the update
    const float beta = rsnew / (rsold + (rsold <= 0.f ? 1.f : 0.f));
    p = r + beta * p;
    if (keeper) c.p[own] = p;
    __syncthreads();
    rsold = rsnew;
  }

  // x *= [nnz > 0] (a NaN stays NaN), out; then the train-error identity
  // (cumf_als_tpu/ops/rmse.py, fused_sq_err) on A_raw
  x *= nnzf > 0.f ? 1.f : 0.f;
  if (keeper) {
    c.x[own] = x;
    x_out[(int64_t)row * kF + own] = x;
  }
  __syncthreads();
  const float ax = raw(c.x);  // every lane: raw() shuffles over the warp
  const float cross = warp_sum(keeper ? x * b_at(own) : 0.f);
  const float xax = warp_sum(keeper ? x * ax : 0.f);
  float r2 = 0.f;
  if (tid == 0) {  // before the barrier: the next row may write r2s
    r2 = r2s[0];
    if constexpr (!AUG) {
#pragma unroll
      for (int j = 1; j < 16; ++j) r2 += r2s[j];
    }
  }
  if (lane == 0) {
    c.red[2][warp] = cross;
    c.red[3][warp] = xax;
  }
  __syncthreads();
  if (tid == 0) {
    const float se = r2 - 2.f * sum8(c.red[2]) + sum8(c.red[3]);
    se_out[row] = se < 0.f ? 0.f : se;  // max(se, 0); NaN stays NaN
  }
}

// See gram_mma.cuh on the anonymous namespace.
namespace {

// K1 (AUG false) or K6 (AUG true) on the tensor cores, over the rows of
// gram_stream, each stopping at its nnz.
template <bool AUG, typename VT>
__global__ void __launch_bounds__(kThreads, 2)
    gram_cg_mma_kernel(const __nv_bfloat16* __restrict__ table,
                       const int32_t* __restrict__ cols,
                       const VT* __restrict__ vals,
                       const int32_t* __restrict__ nnz,
                       const float* __restrict__ x0,
                       float* __restrict__ x_out,
                       float* __restrict__ se_out, int p, int rows,
                       float lam, int cg_iters, float cg_tol) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = aligned_smem(smem_raw);
  CgSmem& c = *reinterpret_cast<CgSmem*>(&s + 1);
  gram_stream<AUG, !AUG, !AUG>(
      s, table, cols, vals, p, rows, LiveSlots{nnz, p},
      [&](int row, int n, const float (&acc)[64], float b0, float b1) {
        frag_cg_row<AUG>(c, row, n, acc, b0, b1, AUG ? c.r2 : s.r2, nnz, x0,
                         x_out, se_out, lam, cg_iters, cg_tol);
      });
}

template <bool AUG, typename VT>
int launch_cg(const void* table, const void* cols, const void* vals,
              const void* nnz, const void* x0, void* x_out, void* se_out,
              int r, int p, float lam, int cg_iters, float cg_tol,
              cudaStream_t stream) {
  // the ring of tiles is dynamic shared memory above 48 KB: allowed once
  // per instantiation
  static const cudaError_t allowed = cudaFuncSetAttribute(
      gram_cg_mma_kernel<AUG, VT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kCgSmemBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  // two blocks an SM (the launch bound), each walking its share of rows
  static const int resident = 2 * sm_count();
  gram_cg_mma_kernel<AUG, VT>
      <<<r < resident ? r : resident, kThreads, kCgSmemBytes, stream>>>(
          (const __nv_bfloat16*)table, (const int32_t*)cols, (const VT*)vals,
          (const int32_t*)nnz, (const float*)x0, (float*)x_out,
          (float*)se_out, p, r, lam, cg_iters, cg_tol);
  return (int)cudaGetLastError();
}

// Floats of one span's record in the cut: A (kF x kF, row-major), then
// K1's b (kF) and r2 (1), padded to a multiple of 4 floats (each record
// starts on a 16-byte boundary). K6's record holds A' alone; its tail is
// never written.
constexpr int kRecordFloats = kF * kF + kF + 4;

// Pass 1 of the cut: the record of every span of the (R S, P / S) view
// that holds slots (`views` = R S rows of `len` slots).
template <bool AUG, typename VT>
__global__ void __launch_bounds__(kThreads, 2)
    span_gram_kernel(const __nv_bfloat16* __restrict__ table,
                     const int32_t* __restrict__ cols,
                     const VT* __restrict__ vals,
                     const int32_t* __restrict__ nnz,
                     float* __restrict__ part, int views, int spans,
                     int len) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = aligned_smem(smem_raw);
  gram_stream<AUG, !AUG, !AUG>(
      s, table, cols, vals, len, views, SpanLen{nnz, spans, len},
      [&](int v, int n, const float (&acc)[64], float b0, float b1) {
        if (n == 0) return;  // no wgmma ran: acc holds another span's sums
        float* rec = part + (int64_t)v * kRecordFloats;
        store_fragment<float>(acc, rec);
        if constexpr (!AUG) {
          // b: the four quarters of the slots, r2: its 16 parts, each
          // added in the order frag_cg_row adds them
          const int tid = threadIdx.x;
          const int lanes = 2 * (tid & (kF / 2 - 1));
          const int quarter = tid >> 6;
          float r2 = 0.f;
          if (tid == 0) {  // before the barrier: the stream then zeroes r2
            r2 = s.r2[0];
#pragma unroll
            for (int j = 1; j < 16; ++j) r2 += s.r2[j];
          }
          if (quarter > 0)
            *reinterpret_cast<float2*>(&s.b[quarter - 1][lanes]) =
                make_float2(b0, b1);
          __syncthreads();
          if (quarter == 0) {
            float2 sum = make_float2(b0, b1);
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              sum.x += s.b[q][lanes];
              sum.y += s.b[q][lanes + 1];
            }
            *reinterpret_cast<float2*>(rec + kF * kF + lanes) = sum;
          }
          if (tid == 0) rec[kF * kF + kF] = r2;
        }
      });
}

// Pass 2 of the cut: row blockIdx.x's live records (spans s with
// s len < min(nnz, p)) added in span order into this thread's part of
// the fragment, then frag_cg_row. K1 hands it b as quarter 0's part and
// r2 as part 0 (the other parts zero, so frag_cg_row's sums give them
// unchanged); K6 takes b and r2 out of row 127 of the summed A'.
template <bool AUG>
__global__ void __launch_bounds__(kThreads)
    span_solve_kernel(const float* __restrict__ part,
                      const int32_t* __restrict__ nnz,
                      const float* __restrict__ x0,
                      float* __restrict__ x_out,
                      float* __restrict__ se_out, int p, int spans, int len,
                      float lam, int cg_iters, float cg_tol) {
  __shared__ CgSmem c;
  __shared__ float r2s[16];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int k = lane & 3;
  const int lo = 16 * (tid >> 5) + (lane >> 2);  // this thread's rows lo,
  const int row = blockIdx.x;                    // lo + 8 of A
  const int n = min(__ldg(nnz + row), p);
  const int live = n > 0 ? (n + len - 1) / len : 0;
  const float* rec = part + (int64_t)row * spans * kRecordFloats;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float b0 = 0.f, b1 = 0.f, r2 = 0.f;
  for (int sp = 0; sp < live; ++sp, rec += kRecordFloats) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 a_lo =
          *reinterpret_cast<const float2*>(rec + lo * kF + 8 * i + 2 * k);
      const float2 a_hi = *reinterpret_cast<const float2*>(
          rec + (lo + 8) * kF + 8 * i + 2 * k);
      acc[4 * i] += a_lo.x;
      acc[4 * i + 1] += a_lo.y;
      acc[4 * i + 2] += a_hi.x;
      acc[4 * i + 3] += a_hi.y;
    }
    if (!AUG && tid < kF / 2) {
      const float2 b = *reinterpret_cast<const float2*>(rec + kF * kF +
                                                        2 * tid);
      b0 += b.x;
      b1 += b.y;
    }
    if (!AUG && tid == 0) r2 += rec[kF * kF + kF];
  }
  if (tid < 16) r2s[tid] = tid == 0 ? r2 : 0.f;
  // frag_cg_row's first barrier comes before its first read of r2s
  frag_cg_row<AUG>(c, row, n, acc, b0, b1, AUG ? c.r2 : r2s, nnz, x0,
                   x_out, se_out, lam, cg_iters, cg_tol);
}

// The host side of pass 1: r rows of p slots cut into `spans` spans of
// p / spans slots, a record each in part (r spans, kRecordFloats).
template <bool AUG, typename VT>
int launch_span_gram(const void* table, const void* cols, const void* vals,
                     const void* nnz, void* part, int r, int p, int spans,
                     cudaStream_t stream) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      span_gram_kernel<AUG, VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  static const int resident = 2 * sm_count();
  const int views = r * spans;
  span_gram_kernel<AUG, VT>
      <<<views < resident ? views : resident, kThreads, kSmemBytes,
         stream>>>((const __nv_bfloat16*)table, (const int32_t*)cols,
                   (const VT*)vals, (const int32_t*)nnz, (float*)part,
                   views, spans, p / spans);
  return (int)cudaGetLastError();
}

template <bool AUG>
int run_span_gram(const void* table, const void* cols, const void* vals,
                  int vals_bf16, const void* nnz, void* part, int r, int p,
                  int spans, cudaStream_t stream) {
  if (spans < 1 || p % spans) return (int)cudaErrorInvalidValue;
  if (vals_bf16)
    return launch_span_gram<AUG, __nv_bfloat16>(table, cols, vals, nnz, part,
                                                r, p, spans, stream);
  return launch_span_gram<AUG, float>(table, cols, vals, nnz, part, r, p,
                                      spans, stream);
}

// The host side of pass 2: one block a row.
template <bool AUG>
int run_span_solve(const void* part, const void* nnz, const void* x0,
                   void* x_out, void* se_out, int r, int p, int spans,
                   float lam, int cg_iters, float cg_tol,
                   cudaStream_t stream) {
  if (spans < 1 || p % spans) return (int)cudaErrorInvalidValue;
  span_solve_kernel<AUG><<<r, kThreads, 0, stream>>>(
      (const float*)part, (const int32_t*)nnz, (const float*)x0,
      (float*)x_out, (float*)se_out, p, spans, p / spans, lam, cg_iters,
      cg_tol);
  return (int)cudaGetLastError();
}

// The host side of K1 and K6 on this body: r rows of p slots. Returns the
// CUDA error.
template <bool AUG>
int run_cg(const void* table, const void* cols, const void* vals,
           int vals_bf16, const void* nnz, const void* x0, void* x_out,
           void* se_out, int r, int p, float lam, int cg_iters, float cg_tol,
           cudaStream_t stream) {
  if (vals_bf16)
    return launch_cg<AUG, __nv_bfloat16>(table, cols, vals, nnz, x0, x_out,
                                         se_out, r, p, lam, cg_iters, cg_tol,
                                         stream);
  return launch_cg<AUG, float>(table, cols, vals, nnz, x0, x_out, se_out, r,
                               p, lam, cg_iters, cg_tol, stream);
}

}  // namespace

}  // namespace mma
}  // namespace cumf
