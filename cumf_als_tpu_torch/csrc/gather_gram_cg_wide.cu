// K7: fused gather + two-block Gram + regularized CG + per-row train
// error for factor widths 128 < F <= 256.
//
// Replaces the TPU kernel `_kernel_wide` (with `_cg_loop_wide`) of
// cumf_als_tpu/ops/pallas_solve.py, reached through
// `gather_gram_cg_wide` -> `fused_gram_cg_wide`. The Pallas design cuts
// the 256 factor lanes into a 128-lane block and a packed block of
// f2 = wide_f2(F) in {32, 64, 96, 128} lanes, forms A11, A12, A22 and
// runs CG on [[A11, A12], [A12^T, A22]]: the (128 + f2)-lane system,
// with the dead lanes above shed from every pass. The lane split itself
// serves the TPU's gathers; here the row gather runs inside the kernel
// (as in gather_gram_cg.cu), which reads lanes < 128 + f2 of the one
// 256-lane table and keeps the contract of the JAX wrapper.
//
// Per row r of a chunk (one thread block each), FL = 128 + f2:
//   A = sum_p g g^T (f32), b = sum_p v g, r2 = sum_p v^2,
//       g = table[cols][:FL]
//   A += (nnz*lam + [nnz == 0]) I
//   x[:FL] = CG(A, b, x0[:FL]) * [nnz > 0],  x[FL:] = 0 exactly
//   se = max(r2 - 2 x.b + x^T (A - diag I) x, 0)
// The slot loop stops at nnz[r] (pad slots at the tail of each row).
//
// Bound on an H100: the Gram work, the upper triangle sum(nnz) FL
// (FL + 8) FLOPs (~5 TFLOP per Netflix phase at F = 200), which this
// kernel runs as f32 FMAs on the CUDA cores (67 TFLOP/s): the triangle of
// 8 x 8 register tiles of wide.cuh computes only the upper half of A.
// It serves a float32 table, which the bf16 tensor cores would round:
// a bf16 table never reaches it, because the wrapper runs such a chunk
// as the two passes of the row cut with pass 1 on the tensor cores
// (wide_span_gram_mma.cu, wide_span_solve.cu). One block takes one row,
// so on a chunk with fewer rows than the card has SMs the wrapper takes
// the row cut on this body instead (wide_span_gram.cu,
// wide_span_solve.cu: a row's slots cut across blocks).

#include "wide.cuh"

namespace {

template <int T, typename TT, typename VT>
__global__ void __launch_bounds__(cumf::wide::Shape<T>::THREADS)
    gather_gram_cg_wide_kernel(const TT* __restrict__ table,
                               const int32_t* __restrict__ cols,
                               const VT* __restrict__ vals,
                               const int32_t* __restrict__ nnz,
                               const float* __restrict__ x0,
                               float* __restrict__ x_out,
                               float* __restrict__ se_out, int p, float lam,
                               int cg_iters, float cg_tol) {
  __shared__ cumf::wide::Smem<T> s;
  const int64_t row = blockIdx.x;
  cumf::wide::gather_row<T>(
      s, table, cols + row * p, vals + row * p, min(nnz[row], p),
      (float)nnz[row], lam, x0 + row * cumf::wide::kStride,
      x_out + row * cumf::wide::kStride, se_out + row, cg_iters, cg_tol);
}

template <typename TT, typename VT>
int dispatch(int f2, const void* table, const void* cols, const void* vals,
             const void* nnz, const void* x0, void* x_out, void* se_out,
             int r, int p, float lam, int cg_iters, float cg_tol,
             cudaStream_t stream) {
#define CUMF_LAUNCH(T)                                                      \
  gather_gram_cg_wide_kernel<T, TT, VT>                                     \
      <<<r, cumf::wide::Shape<T>::THREADS, 0, stream>>>(                    \
          (const TT*)table, (const int32_t*)cols, (const VT*)vals,          \
          (const int32_t*)nnz, (const float*)x0, (float*)x_out,             \
          (float*)se_out, p, lam, cg_iters, cg_tol)
  switch (f2) {  // T = (128 + f2) / 8
    case 32: CUMF_LAUNCH(20); break;
    case 64: CUMF_LAUNCH(24); break;
    case 96: CUMF_LAUNCH(28); break;
    case 128: CUMF_LAUNCH(32); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef CUMF_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cumf_gather_gram_cg_wide(const void* table, int table_bf16,
                                        const void* cols, const void* vals,
                                        int vals_bf16, const void* nnz,
                                        const void* x0, void* x_out,
                                        void* se_out, int r, int p, int f2,
                                        float lam, int cg_iters,
                                        float cg_tol, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (table_bf16 && vals_bf16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(
        f2, table, cols, vals, nnz, x0, x_out, se_out, r, p, lam, cg_iters,
        cg_tol, st);
  if (table_bf16)
    return dispatch<__nv_bfloat16, float>(f2, table, cols, vals, nnz, x0,
                                          x_out, se_out, r, p, lam,
                                          cg_iters, cg_tol, st);
  if (vals_bf16)
    return dispatch<float, __nv_bfloat16>(f2, table, cols, vals, nnz, x0,
                                          x_out, se_out, r, p, lam,
                                          cg_iters, cg_tol, st);
  return dispatch<float, float>(f2, table, cols, vals, nnz, x0, x_out,
                                se_out, r, p, lam, cg_iters, cg_tol, st);
}
