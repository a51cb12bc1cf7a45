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
// Per row r of a chunk (one thread block at a time):
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
// What this design does about it. A bf16 table at f = 128 (the main
// path) takes the body of frag_cg.cuh, as K1 does: the value, rounded to
// bf16, rides lane 127 of the cp.async-gathered tile (as in K5a), one
// wgmma Gram gives A, b and r2, and the CG reads A from the wgmma
// fragment in registers, b and r2 taken out of row 127 before the
// matvec masks row and column 127. A chunk of fewer rows than two an SM
// is cut across blocks as K1's is (frag_cg.cuh): given `part`, this
// entry point runs pass 1 (each span's A', the value over lane 127, into
// an f32 record), and frag_span_solve.cu with aug takes b and r2 out of
// row 127 of each row's summed records and solves. A float32 table and
// a bf16 table at f < 128 keep the f32 FMA body of common.cuh, one block
// a row, where the value enters lane f - 1 while the tile is staged. The
// entry point chooses by dtype and f alone.
//
// f = 256 (factor widths 128 < F < 256, padded to 256 lanes, lane 255
// free) runs as K1 does at that width, in the aug layout. A bf16 table
// takes the two passes of the row cut on every chunk: pass 1 on the
// tensor cores (wide_span_gram_mma.cu, source kSpansAug: the value over
// lane 255 of each gathered slot, the record's tiles holding A'), pass 2
// (wide_span_solve.cu with aug: b from column 255 of the summed records,
// r2 from the corner, row and column 255 zeroed, then the solve). A
// float32 table takes the same cut on a chunk with fewer rows than the
// card has SMs (pass 1 on wide.cuh's FMA body with the value in lane
// 255), and otherwise the uncut kernel below: gather_row of wide.cuh
// with the AUG switch (the same splice and unpack, one block a row), so
// a float32 chunk runs K6's own kernel wherever K1 runs its own. The
// wrapper (ops/cuda_solve.py, gather_gram_cg) makes that choice; this
// entry point sees only the uncut float32 chunks at f = 256.

#include "common.cuh"
#include "frag_cg.cuh"
#include "wide.cuh"

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

// The uncut kernel at f = 256: gather_row of wide.cuh in the aug layout.
template <typename TT, typename VT>
__global__ void __launch_bounds__(cumf::wide::Shape<32>::THREADS)
    gather_gram_cg_aug_256_kernel(const TT* __restrict__ table,
                                  const int32_t* __restrict__ cols,
                                  const VT* __restrict__ vals,
                                  const int32_t* __restrict__ nnz,
                                  const float* __restrict__ x0,
                                  float* __restrict__ x_out,
                                  float* __restrict__ se_out, int p,
                                  float lam, int cg_iters, float cg_tol) {
  __shared__ cumf::wide::Smem<32> s;
  const int64_t row = blockIdx.x;
  cumf::wide::gather_row<32, TT, VT, true>(
      s, table, cols + row * p, vals + row * p, min(nnz[row], p),
      (float)nnz[row], lam, x0 + row * cumf::wide::kStride,
      x_out + row * cumf::wide::kStride, se_out + row, cg_iters, cg_tol);
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
  if (f == cumf::wide::kStride) {
    gather_gram_cg_aug_256_kernel<TT, VT>
        <<<r, cumf::wide::Shape<32>::THREADS, 0, stream>>>(
            (const TT*)table, (const int32_t*)cols, (const VT*)vals,
            (const int32_t*)nnz, (const float*)x0, (float*)x_out,
            (float*)se_out, p, lam, cg_iters, cg_tol);
    return (int)cudaGetLastError();
  }
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
                                       void* part, int spans, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // pass 1 of the cut of a chunk of few rows (frag_cg.cuh): `spans`
  // spans a row, each span's record of A' into part; x_out and se_out
  // are pass 2's
  if (part) {
    if (!table_bf16 || f != cumf::mma::kF)
      return (int)cudaErrorInvalidValue;
    return cumf::mma::run_span_gram<true>(table, cols, vals, vals_bf16, nnz,
                                          part, r, p, spans, st);
  }
  // the tensor-core body where it takes the table, else the FMA body
  if (table_bf16 && f == cumf::mma::kF)
    return cumf::mma::run_cg<true>(table, cols, vals, vals_bf16, nnz, x0,
                                   x_out, se_out, r, p, lam, cg_iters,
                                   cg_tol, st);
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
