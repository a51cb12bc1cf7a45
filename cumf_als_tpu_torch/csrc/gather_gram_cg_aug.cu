// K6: fused gather + Gram + regularized CG + per-row train error, in the
// augmented-lane layout.
//
// Replaces the TPU kernel `_kernel_aug` (with `_cg_loop`) of
// cumf_als_tpu/ops/pallas_solve.py, reached through
// `gather_gram_cg(aug=True)` -> `fused_gram_cg_aug`. It is
// gather_gram_cg.cu with one Gram in place of three sums: the slot's
// value rides lane f - 1 of the gathered row (the table's own lane f - 1
// must be zero: the true factor width is at most f - 1), rounded to the
// table's dtype first.
//
// Per row r of a chunk (one thread block each):
//   A' = sum_p g g^T (f32), g = table[cols] with lane f - 1 = value
//   b = row f - 1 of A' (lane f - 1 zeroed), r2 = the corner of A'
//   A = A' with row and column f - 1 zeroed, + (nnz*lam + [nnz == 0]) I
//   x = CG(A, b, x0), then x *= [nnz > 0]
//   se = max(r2 - 2 x.b + x^T (A - diag I) x, 0)
// Lane f - 1 of x stays exactly 0 when lane f - 1 of x0 is 0. The slot
// loop stops at nnz[r]: pad slots sit at each row's tail (ops/tiling.py)
// and gather the zero row with value 0.
//
// Bound on an H100: as gather_gram_cg.cu, the Gram work 2 * sum(nnz) *
// f^2 FLOPs, ~3.3 TFLOP per Netflix theta phase at f = 128, i.e. ~3.3 ms
// on the bf16 tensor cores (989 TFLOP/s); the bytes are small.
// What this design does about it: nothing yet. The Gram is f32 FMAs on
// the CUDA cores from a shared-memory tile (no wgmma, no TMA, no
// pipelining). The augmented form saves the separate b and r2 passes
// over each tile; the value enters lane f - 1 while the tile is staged.

#include "common.cuh"

namespace {

template <int NB, typename TT, typename VT>
__global__ void __launch_bounds__(cumf::kThreads)
    gather_gram_cg_aug_kernel(const TT* __restrict__ table,
                              const int32_t* __restrict__ cols,
                              const VT* __restrict__ vals,
                              const int32_t* __restrict__ nnz,
                              const float* __restrict__ x0,
                              float* __restrict__ x_out,
                              float* __restrict__ se_out, int p, float lam,
                              int cg_iters, float cg_tol) {
  constexpr int F = 16 * NB;
  __shared__ cumf::Smem<NB> s;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = min(nnz[row], p);

  float a[NB][NB];
  cumf::zero_acc<NB>(a);
  float b_unused = 0.f, r2_unused = 0.f;
  cumf::gram_row<NB, true>(s, table, cols + (int64_t)row * p,
                           vals + (int64_t)row * p, n, a, b_unused,
                           r2_unused);

  cumf::unpack_aug<NB>(s, a);  // b and r2 out first, then the mask
  const float nnzf = (float)nnz[row];
  const float diag = nnzf * lam + (nnzf == 0.f ? 1.f : 0.f);
  cumf::add_diag<NB>(a, diag);
  if (tid < F) s.x[tid] = x0[(int64_t)row * F + tid];
  __syncthreads();
  const float r2 = s.red[1];

  cumf::cg<NB>(s, a, cg_iters, cg_tol);

  const float live = nnzf > 0.f ? 1.f : 0.f;
  if (tid < F) s.x[tid] *= live;
  __syncthreads();
  if (tid < F) x_out[(int64_t)row * F + tid] = s.x[tid];

  // train-error identity (cumf_als_tpu/ops/rmse.py, fused_sq_err); the
  // value lane of x is zero, so the masked A and b give the split
  // kernel's terms
  cumf::matvec<NB>(a, s.x, s.ap);
  const float cross = cumf::dot<NB>(s, s.x, s.b);
  const float xax = cumf::dot<NB>(s, s.x, s.ap);
  const float xx = cumf::dot<NB>(s, s.x, s.x);
  if (tid == 0) {
    const float se = r2 - 2.f * cross + (xax - diag * xx);
    se_out[row] = se < 0.f ? 0.f : se;  // max(se, 0); NaN stays NaN
  }
}

template <int NB, typename TT, typename VT>
void launch(const void* table, const void* cols, const void* vals,
            const void* nnz, const void* x0, void* x_out, void* se_out,
            int r, int p, float lam, int cg_iters, float cg_tol,
            cudaStream_t stream) {
  gather_gram_cg_aug_kernel<NB, TT, VT><<<r, cumf::kThreads, 0, stream>>>(
      (const TT*)table, (const int32_t*)cols, (const VT*)vals,
      (const int32_t*)nnz, (const float*)x0, (float*)x_out, (float*)se_out,
      p, lam, cg_iters, cg_tol);
}

template <typename TT, typename VT>
int dispatch(int f, const void* table, const void* cols, const void* vals,
             const void* nnz, const void* x0, void* x_out, void* se_out,
             int r, int p, float lam, int cg_iters, float cg_tol,
             cudaStream_t stream) {
#define CUMF_LAUNCH(NB)                                                   \
  launch<NB, TT, VT>(table, cols, vals, nnz, x0, x_out, se_out, r, p, lam, \
                     cg_iters, cg_tol, stream)
  CUMF_DISPATCH_NB(f, CUMF_LAUNCH)
#undef CUMF_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cumf_gather_gram_cg_aug(const void* table, int table_bf16,
                                       const void* cols, const void* vals,
                                       int vals_bf16, const void* nnz,
                                       const void* x0, void* x_out,
                                       void* se_out, int r, int p, int f,
                                       float lam, int cg_iters, float cg_tol,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (table_bf16 && vals_bf16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(
        f, table, cols, vals, nnz, x0, x_out, se_out, r, p, lam, cg_iters,
        cg_tol, st);
  if (table_bf16)
    return dispatch<__nv_bfloat16, float>(f, table, cols, vals, nnz, x0,
                                          x_out, se_out, r, p, lam, cg_iters,
                                          cg_tol, st);
  if (vals_bf16)
    return dispatch<float, __nv_bfloat16>(f, table, cols, vals, nnz, x0,
                                          x_out, se_out, r, p, lam, cg_iters,
                                          cg_tol, st);
  return dispatch<float, float>(f, table, cols, vals, nnz, x0, x_out, se_out,
                                r, p, lam, cg_iters, cg_tol, st);
}
