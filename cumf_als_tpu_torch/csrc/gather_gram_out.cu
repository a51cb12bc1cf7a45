// K2: gather + raw partial Gram, written out (no regularizer, no solve).
//
// Replaces the TPU kernel `_gram_kernel` of
// cumf_als_tpu/ops/pallas_solve.py, reached through `gather_gram_out`.
// The row gather runs inside the kernel, so the wrapper keeps the
// contract of `gather_gram_out`: (table panel, cols, vals) in, raw
// (A, b) partials out. Per row r, over all P slots:
//   A = sum_p g g^T, accumulated in f32 and written in A's dtype
//       (bf16 through round-to-nearest-even, as astype does)
//   b = sum_p v g, in f32
// Pad slots name the zero row appended to the panel and carry value 0,
// so they add nothing. The caller scatter-adds the partials into the
// phase accumulators (models/als.py).
//
// Bound on an H100, at the X panel chunk R = 2304, P = 576, f = 128 with
// a bf16 A: 2 R P f^2 = 43.5 GFLOP, i.e. 0.044 ms on the bf16 tensor
// cores (989 TFLOP/s): operations bound it. What the device-memory bound
// does not show: the panel (65,537 x 128 bf16, 16.8 MB) stays in the L2,
// but every slot still moves its 256-byte table row from the L2 to an
// SM, 340 MB for that chunk, and that gather, not the arithmetic, is
// what a tensor-core Gram then waits for.
// What this design does about it. A bf16 table at f = 128 (the main
// path) takes the body of gram_mma.cuh: the row's slots are gathered
// with cp.async into a ring of swizzled bf16 tiles, several tiles in
// flight, and A = G^T G runs on the tensor cores (wgmma m64n128k16, both
// operands the same MN-major tile, two warpgroups of 64 rows of A each);
// b is summed from the same tile on the CUDA cores while the wgmma runs.
// Two blocks share an SM and each walks its rows as one stream of tiles,
// so the next row's gather and this row's write-out overlap the Gram.
// A float32 table at f = 128 takes the split-bf16 body of
// split_gram_mma.cuh: each f32 entry cut into three bf16 pieces, six of
// their products on the same wgmma, so A keeps f32 accuracy; gathering
// 512-byte f32 rows (680 MB for the chunk above) sets its pace, one
// block an SM. Every table at f < 128 keeps the f32 FMA body of
// common.cuh (gram_row).
// At f = 256 (factor widths 128 < F <= 256) a bf16 table takes the
// panel body of wide_gram_mma.cuh: one block of two warpgroups a row
// of A, each slot's table row gathered once, the upper triangle's ten
// 64 x 64 blocks on the tensor cores, b on the CUDA cores, and the whole
// symmetric A written through shared memory in coalesced rows; a float32
// table the split-bf16 body of wide_split_mma.cuh (the same strips and
// epilogue, six products of each entry's three bf16 pieces, 32-slot
// tiles in a smaller ring of f32 stages). There an f32 A of 256 KB a row
// takes its share: the out-of-core theta chunk R = 6656 writes 1.74 GB,
// ~0.52 ms at 3.35 TB/s. The entry point chooses by dtype and f alone.
// A chunk of few rows on a bf16 or a float32 table (fewer rows than the
// blocks of its body that fit the card: the hot segments, R = 16,
// P = 2^18, and the few-row X panel chunks) is cut across blocks by the
// wrapper (gram_spans in ops/cuda_solve.py): this entry point runs on the
// (R S, P / S) view of cols and vals with an f32 A, each span of S a row
// of it, and pass 2 (gram_span_sum.cu) adds each row's S partials (A and
// b) in span order. There the gather still bounds the work, now spread
// over every SM, and the partials add R S (f^2 + f) floats written and
// read once more.

#include "common.cuh"
#include "gram_mma.cuh"
#include "split_gram_mma.cuh"
#include "wide_gram_mma.cuh"
#include "wide_split_mma.cuh"

namespace {

template <int NB, typename TT, typename VT, typename OT>
__global__ void __launch_bounds__(cumf::kThreads)
    gather_gram_out_kernel(const TT* __restrict__ table,
                           const int32_t* __restrict__ cols,
                           const VT* __restrict__ vals,
                           OT* __restrict__ a_out, float* __restrict__ b_out,
                           int p) {
  constexpr int F = 16 * NB;
  __shared__ cumf::Smem<NB> s;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  float a[NB][NB];
  cumf::zero_acc<NB>(a);
  float b_acc = 0.f, r2_acc = 0.f;
  cumf::gram_row<NB, false>(s, table, cols + (int64_t)row * p,
                     vals + (int64_t)row * p, p, a, b_acc, r2_acc);

  OT* out = a_out + (int64_t)row * F * F;
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int l = 0; l < NB; ++l)
      out[(ty + 16 * k) * F + tx * NB + l] = cumf::from_f32<OT>(a[k][l]);
  if (tid < F) b_out[(int64_t)row * F + tid] = b_acc;
}

template <int NB, typename TT, typename VT, typename OT>
void launch(const void* table, const void* cols, const void* vals,
            void* a_out, void* b_out, int r, int p, cudaStream_t stream) {
  gather_gram_out_kernel<NB, TT, VT, OT><<<r, cumf::kThreads, 0, stream>>>(
      (const TT*)table, (const int32_t*)cols, (const VT*)vals, (OT*)a_out,
      (float*)b_out, p);
}

template <typename TT, typename VT, typename OT>
int dispatch(int f, const void* table, const void* cols, const void* vals,
             void* a_out, void* b_out, int r, int p, cudaStream_t stream) {
#define CUMF_LAUNCH(NB) \
  launch<NB, TT, VT, OT>(table, cols, vals, a_out, b_out, r, p, stream)
  CUMF_DISPATCH_NB(f, CUMF_LAUNCH)
#undef CUMF_LAUNCH
  return (int)cudaGetLastError();
}

template <typename TT, typename VT>
int dispatch_out(int out_bf16, int f, const void* table, const void* cols,
                 const void* vals, void* a_out, void* b_out, int r, int p,
                 cudaStream_t stream) {
  if (out_bf16)
    return dispatch<TT, VT, __nv_bfloat16>(f, table, cols, vals, a_out,
                                           b_out, r, p, stream);
  return dispatch<TT, VT, float>(f, table, cols, vals, a_out, b_out, r, p,
                                 stream);
}

}  // namespace

extern "C" int cumf_gather_gram_out(const void* table, int table_bf16,
                                    const void* cols, const void* vals,
                                    int vals_bf16, void* a_out, int out_bf16,
                                    void* b_out, int r, int p, int f,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // the tensor-core bodies where they take the table, else the FMA body
  if (table_bf16 && f == cumf::mma::kF)
    return cumf::mma::run<false>(table, cols, vals, vals_bf16, a_out,
                                 out_bf16, b_out, r, p, st);
  if (f == cumf::mma::kF)
    return cumf::split::run<false>(table, cols, vals, vals_bf16, a_out,
                                   out_bf16, b_out, r, p, st);
  if (table_bf16 && f == cumf::wide::kStride)
    return cumf::wide_mma::run_panel<false>(table, cols, vals, vals_bf16,
                                            a_out, out_bf16, b_out, r, p, st);
  if (f == cumf::wide::kStride)
    return cumf::wide_split::run<false>(table, cols, vals, vals_bf16, a_out,
                                        out_bf16, b_out, r, p, st);
  if (table_bf16 && vals_bf16)
    return dispatch_out<__nv_bfloat16, __nv_bfloat16>(
        out_bf16, f, table, cols, vals, a_out, b_out, r, p, st);
  if (table_bf16)
    return dispatch_out<__nv_bfloat16, float>(out_bf16, f, table, cols, vals,
                                              a_out, b_out, r, p, st);
  if (vals_bf16)
    return dispatch_out<float, __nv_bfloat16>(out_bf16, f, table, cols, vals,
                                              a_out, b_out, r, p, st);
  return dispatch_out<float, float>(out_bf16, f, table, cols, vals, a_out,
                                    b_out, r, p, st);
}
