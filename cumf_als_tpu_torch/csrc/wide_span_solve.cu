// Pass 2 of the row cut of the 256-lane body (wide.cuh): one block a
// row adds the records that wide_span_gram.cu wrote for the row's live
// spans, in span order, then runs the tail of gather_row unchanged:
//   A += (nnz*lam + [nnz == 0]) I
//   x[:FL] = CG(A, b, x0[:FL]) * [nnz > 0],  x[FL:] = 0 exactly
//   se = max(r2 - 2 x.b + x^T (A - diag I) x, 0)
// Span s of row r is live iff s * span_len < min(nnz[r], P); a row
// without slots has none and solves to x = 0, se = 0. With all_slots
// (K8, whose pass 1 sums every slot of a packed G up to P) every span is
// live, and nnz sets only the regularizer and the [nnz > 0] mask. With
// aug (K6 at f = 256, FL = 256) the records hold A' alone: the summed
// upper triangle gives b (its column 255) and r2 (its corner), row and
// column 255 are zeroed (wide.cuh, unpack_aug_tiles), and the solve is
// the same; lane 255 of x comes back exactly 0.
//
// Replaces, with pass 1, the TPU kernel `_kernel_wide` (and `_kernel` and
// `_kernel_aug` at 256 lanes, and `_kernel_cat`) of
// cumf_als_tpu/ops/pallas_solve.py (see wide_span_gram.cu and
// wide_span_gram_mma.cu).
// Bound on an H100: the bytes of the records it reads (136 KB a live span
// at FL = 256) and of x0, x and se. What this design does about it:
// every thread reads its own tile's 64 entries, 256 contiguous bytes of
// the record (16 float4 loads), and keeps them in registers for the CG.

#include "wide.cuh"

namespace {

template <int T, bool AUG>
__global__ void __launch_bounds__(cumf::wide::Shape<T>::THREADS)
    wide_span_solve_kernel(const float* __restrict__ part,
                           const int32_t* __restrict__ nnz,
                           const float* __restrict__ x0,
                           float* __restrict__ x_out,
                           float* __restrict__ se_out, int p, int spans,
                           int span_len, int all_slots, float lam,
                           int cg_iters, float cg_tol) {
  __shared__ cumf::wide::Smem<T> s;
  const int64_t row = blockIdx.x;
  const int n = all_slots ? p : min(nnz[row], p);
  const int live = min(spans, (n + span_len - 1) / span_len);
  cumf::wide::span_solve<T, AUG>(
      s, part + row * spans * cumf::wide::SpanRecord<T>::SIZE, live,
      (float)nnz[row], lam, x0 + row * cumf::wide::kStride,
      x_out + row * cumf::wide::kStride, se_out + row, cg_iters, cg_tol);
}

}  // namespace

extern "C" int cumf_wide_span_solve(const void* part, const void* nnz,
                                    const void* x0, void* x_out,
                                    void* se_out, int r, int p, int fl,
                                    int spans, int span_len, int all_slots,
                                    int aug, float lam, int cg_iters,
                                    float cg_tol, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define CUMF_LAUNCH(T, AUG)                                               \
  wide_span_solve_kernel<T, AUG>                                          \
      <<<r, cumf::wide::Shape<T>::THREADS, 0, st>>>(                      \
          (const float*)part, (const int32_t*)nnz, (const float*)x0,      \
          (float*)x_out, (float*)se_out, p, spans, span_len, all_slots,   \
          lam, cg_iters, cg_tol)
  if (aug) {  // K6: all 256 lanes, A' in the records
    if (fl != 256 || all_slots) return (int)cudaErrorInvalidValue;
    CUMF_LAUNCH(32, true);
    return (int)cudaGetLastError();
  }
  switch (fl) {  // T = FL / 8
    case 160: CUMF_LAUNCH(20, false); break;
    case 192: CUMF_LAUNCH(24, false); break;
    case 224: CUMF_LAUNCH(28, false); break;
    case 256: CUMF_LAUNCH(32, false); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef CUMF_LAUNCH
  return (int)cudaGetLastError();
}
