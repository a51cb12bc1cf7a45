// K2: gather + raw partial Gram, written out (no regularizer, no solve).
//
// Replaces the TPU kernel `_gram_kernel` of
// cumf_als_tpu/ops/pallas_solve.py, reached through `gather_gram_out`.
// The row gather runs inside the kernel, so the wrapper keeps the
// contract of `gather_gram_out`: (table panel, cols, vals) in, raw
// (A, b) partials out. Per row r (one thread block each), over all P
// slots:
//   A = sum_p g g^T, accumulated in f32 and written in A's dtype
//       (bf16 through round-to-nearest-even, as astype does)
//   b = sum_p v g, in f32
// Pad slots name the zero row appended to the panel and carry value 0,
// so they add nothing. The caller scatter-adds the partials into the
// phase accumulators (models/als.py).
//
// Bound on an H100: the Gram work is 2 * sum(nnz) * f^2 FLOPs, ~3.3
// TFLOP per Netflix X phase at f = 128, i.e. ~3.3 ms on the bf16 tensor
// cores (989 TFLOP/s); the panel read is small (a 65,537 x 128 bf16
// panel, 16.8 MB, stays in L2) and the partials written are R f^2
// elements per chunk.
// What this design does about it: nothing yet. The Gram is f32 FMAs on
// the CUDA cores from a shared-memory tile (no wgmma, no TMA, no
// pipelining); those come in a later change.

#include "common.cuh"

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
