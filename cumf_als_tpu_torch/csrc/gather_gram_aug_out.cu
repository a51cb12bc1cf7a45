// K5a: gather + raw partial augmented Gram A', written out.
//
// Replaces the TPU kernel `_gram_kernel_aug` of
// cumf_als_tpu/ops/pallas_solve.py, reached through
// `gather_gram_aug_out`. The row gather runs inside the kernel, so the
// wrapper keeps that function's contract: (table panel, cols, vals) in,
// one raw partial A' out. Per row r, over all P slots:
//   g = table[cols], lane f - 1 of each gathered row = the slot's value
//       rounded to the table's dtype (the table's own lane f - 1 must be
//       zero: the true factor width is at most f - 1)
//   A' = sum_p g g^T, accumulated in f32 and written in A''s dtype
//        (bf16 through round-to-nearest-even, as astype does)
// A' holds A (rows and columns < f - 1), b (row and column f - 1) and
// sum v^2 (the corner); there is no separate b output. Pad slots name
// the zero row appended to the panel and carry value 0, so they add
// nothing. The caller scatter-adds A' into the phase's one accumulator
// (models/als.py).
//
// Bound on an H100, at the X panel chunk R = 2304, P = 576, f = 128:
// 2 R P f^2 = 43.5 GFLOP, i.e. 0.044 ms on the bf16 tensor cores
// (989 TFLOP/s), and 151 MB of f32 A' written, i.e. 0.045 ms at
// 3.35 TB/s: bytes and operations tie (with a bf16 A' the operations
// bound). What the device-memory bound does not show: the panel stays in
// the L2, but every slot still moves its 256-byte table row from the L2
// to an SM, 340 MB for that chunk, and a tensor-core Gram waits for that
// gather and for the write of A'.
// What this design does about it. A bf16 table at f = 128 (the main
// path) takes the body of gram_mma.cuh: the row's slots are gathered
// with cp.async into a ring of swizzled bf16 tiles, several tiles in
// flight, the slot's value (rounded to bf16, as the table stores it) is
// stored over lane 127 of its gathered row once the row has landed, and
// A' = G^T G runs on the tensor cores (wgmma m64n128k16, both operands
// the same MN-major tile, two warpgroups of 64 rows of A' each). With a
// bf16 G every product, v g and v v included, is exact in f32. Two
// blocks share an SM and each walks its rows as one stream of tiles, so
// the next row's gather and this row's write-out overlap the Gram.
// A float32 table at f = 128 takes K2's split-bf16 body
// (split_gram_mma.cuh), the slot's f32 value over lane 127 of its
// gathered f32 row before the split; every table at f < 128 keeps the
// f32 FMA body of common.cuh (gram_row). At f = 256 (factor widths
// 128 < F < 256) a bf16 table takes K2's panel body of
// wide_gram_mma.cuh: the Gram of the table's lanes on the tensor cores,
// b and sum v^2 from the values rounded to bf16 on the CUDA cores (every
// product exact in f32, as on the tensor cores), written over row and
// column 255 of A' as the value lane would hold them, and the whole
// symmetric A' written; a float32 table K2's split-bf16 body of
// wide_split_mma.cuh, the slot's f32 value in lane 255 of its gathered
// row before the split. The entry point chooses by dtype and f alone. A
// chunk of few rows takes K2's cut (gather_gram_out.cu): this entry
// point over the (R S, P / S) view with an f32 A', then
// gram_span_sum.cu.

#include "common.cuh"
#include "gram_mma.cuh"
#include "split_gram_mma.cuh"
#include "wide_gram_mma.cuh"
#include "wide_split_mma.cuh"

namespace {

template <int NB, typename TT, typename VT, typename OT>
__global__ void __launch_bounds__(cumf::kThreads)
    gather_gram_aug_out_kernel(const TT* __restrict__ table,
                               const int32_t* __restrict__ cols,
                               const VT* __restrict__ vals,
                               OT* __restrict__ a_out, int p) {
  constexpr int F = 16 * NB;
  __shared__ cumf::Smem<NB> s;
  const int row = blockIdx.x;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  float a[NB][NB];
  cumf::zero_acc<NB>(a);
  float b_unused = 0.f, r2_unused = 0.f;
  cumf::gram_row<NB, true>(s, table, cols + (int64_t)row * p,
                           vals + (int64_t)row * p, p, a, b_unused,
                           r2_unused);

  OT* out = a_out + (int64_t)row * F * F;
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int l = 0; l < NB; ++l)
      out[(ty + 16 * k) * F + tx * NB + l] = cumf::from_f32<OT>(a[k][l]);
}

template <int NB, typename TT, typename VT, typename OT>
void launch(const void* table, const void* cols, const void* vals,
            void* a_out, int r, int p, cudaStream_t stream) {
  gather_gram_aug_out_kernel<NB, TT, VT, OT>
      <<<r, cumf::kThreads, 0, stream>>>((const TT*)table,
                                         (const int32_t*)cols,
                                         (const VT*)vals, (OT*)a_out, p);
}

template <typename TT, typename VT, typename OT>
int dispatch(int f, const void* table, const void* cols, const void* vals,
             void* a_out, int r, int p, cudaStream_t stream) {
#define CUMF_LAUNCH(NB) \
  launch<NB, TT, VT, OT>(table, cols, vals, a_out, r, p, stream)
  CUMF_DISPATCH_NB(f, CUMF_LAUNCH)
#undef CUMF_LAUNCH
  return (int)cudaGetLastError();
}

template <typename TT, typename VT>
int dispatch_out(int out_bf16, int f, const void* table, const void* cols,
                 const void* vals, void* a_out, int r, int p,
                 cudaStream_t stream) {
  if (out_bf16)
    return dispatch<TT, VT, __nv_bfloat16>(f, table, cols, vals, a_out, r, p,
                                           stream);
  return dispatch<TT, VT, float>(f, table, cols, vals, a_out, r, p, stream);
}

}  // namespace

extern "C" int cumf_gather_gram_aug_out(const void* table, int table_bf16,
                                        const void* cols, const void* vals,
                                        int vals_bf16, void* a_out,
                                        int out_bf16, int r, int p, int f,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // the tensor-core bodies where they take the table, else the FMA body
  if (table_bf16 && f == cumf::mma::kF)
    return cumf::mma::run<true>(table, cols, vals, vals_bf16, a_out,
                                out_bf16, nullptr, r, p, st);
  if (f == cumf::mma::kF)
    return cumf::split::run<true>(table, cols, vals, vals_bf16, a_out,
                                  out_bf16, nullptr, r, p, st);
  if (table_bf16 && f == cumf::wide::kStride)
    return cumf::wide_mma::run_panel<true>(table, cols, vals, vals_bf16,
                                           a_out, out_bf16, nullptr, r, p, st);
  if (f == cumf::wide::kStride)
    return cumf::wide_split::run<true>(table, cols, vals, vals_bf16, a_out,
                                       out_bf16, nullptr, r, p, st);
  if (table_bf16 && vals_bf16)
    return dispatch_out<__nv_bfloat16, __nv_bfloat16>(
        out_bf16, f, table, cols, vals, a_out, r, p, st);
  if (table_bf16)
    return dispatch_out<__nv_bfloat16, float>(out_bf16, f, table, cols, vals,
                                              a_out, r, p, st);
  if (vals_bf16)
    return dispatch_out<float, __nv_bfloat16>(out_bf16, f, table, cols, vals,
                                              a_out, r, p, st);
  return dispatch_out<float, float>(out_bf16, f, table, cols, vals, a_out, r,
                                    p, st);
}
