// K1: fused gather + Gram + regularized CG + per-row train error.
//
// Replaces the TPU kernel `_kernel` (with `_cg_loop`) of
// cumf_als_tpu/ops/pallas_solve.py, reached through `gather_gram_cg` ->
// `fused_gram_cg`. Unlike the Pallas design, the row gather runs inside
// the kernel (Mosaic had no vectorized row gather), so the wrapper keeps
// the contract of `gather_gram_cg`: the gathered G never exists in
// device memory.
//
// Per row r of a chunk (one thread block at a time):
//   A = sum_p g g^T (f32), b = sum_p v g, r2 = sum_p v^2, g = table[cols]
//   A += (nnz*lam + [nnz == 0]) I
//   x = CG(A, b, x0), then x *= [nnz > 0]
//   se = max(r2 - 2 x.b + x^T (A - diag I) x, 0)
// The slot loop stops at nnz[r]: the plans put every pad slot at the
// tail of its row (ops/tiling.py, _materialize_chunk), and pad slots
// gather the zero row with value 0, so they add nothing.
//
// Bound on an H100: the Gram work, 2 * sum(nnz) * f^2 FLOPs, is ~3.3
// TFLOP per Netflix theta phase at f = 128, i.e. ~3.3 ms on the bf16
// tensor cores (989 TFLOP/s). The bytes are small: the gathered table
// (17,771 x 128 bf16 = 4.5 MB on that phase) stays in L2.
// What this design does about it. A bf16 table at f = 128 (the main
// path) takes the body of frag_cg.cuh: gram_mma.cuh's cp.async gather
// and wgmma Gram over the row's first min(nnz, P) slots, b and sum v^2
// summed beside it, and the CG and the train error read A from the wgmma
// fragment in registers (3 block barriers a CG step). Two blocks share
// an SM, each walking its rows as one stream of tiles, so the next row's
// gather and the other block's Gram overlap this row's CG.
// A chunk with fewer rows than those blocks (two an SM) would leave SMs
// idle: the wrapper cuts it across blocks (`theta_spans` in
// ops/cuda_solve.py, the rule of K2's cut: S spans of whole 64-slot tiles
// a row, none under 8, P a whole number of tiles). This entry point,
// given `part`, then runs pass 1 of that cut (frag_cg.cuh: the Gram, b
// and r2 of each span into an f32 record), and frag_span_solve.cu adds
// each row's records in span order and solves on the fragment. There the gather, spread over
// the card, bounds the work: the widest direct theta chunk of sharded
// out-of-core training (R = 8, P = 196,608, one real row of 187,933
// ratings) needs 6.2 GFLOP (6 us on the tensor cores) and ~17 us of
// table rows from device memory, where the uncut kernel took ~4.6 ms on
// one SM.
// A float32 table and a bf16 table at f < 128 keep the f32 FMA body of
// common.cuh, one block a row: bf16 tensor cores would round a float32
// table. f = 256 (one factor width above 128, padded to 256 lanes) takes
// the triangle-of-tiles body of wide.cuh with all 256 lanes live: a
// 256 x 256 A does not fit the register layout of common.cuh. The
// wrapper sends that width here only with a float32 table on a chunk of
// as many rows as the card has SMs; a bf16 table at f = 256 runs the two
// passes of the row cut with pass 1 on the tensor cores
// (wide_span_gram_mma.cu, wide_span_solve.cu), and a float32 one on a
// chunk of fewer rows the cut on the FMA body (wide_span_gram.cu). The
// entry point chooses by dtype and f alone.

#include "frag_cg.cuh"
#include "wide.cuh"

namespace {

template <int NB, typename TT, typename VT>
__global__ void __launch_bounds__(cumf::kThreads)
    gather_gram_cg_kernel(const TT* __restrict__ table,
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
  float b_acc = 0.f, r2_acc = 0.f;
  cumf::gram_row<NB, false>(s, table, cols + (int64_t)row * p,
                     vals + (int64_t)row * p, n, a, b_acc, r2_acc);

  const float nnzf = (float)nnz[row];
  const float diag = nnzf * lam + (nnzf == 0.f ? 1.f : 0.f);
  cumf::add_diag<NB>(a, diag);
  if (tid < F) {
    s.b[tid] = b_acc;
    s.x[tid] = x0[(int64_t)row * F + tid];
  } else if (tid == F) {
    s.red[1] = r2_acc;
  }
  __syncthreads();
  const float r2 = s.red[1];

  cumf::cg<NB>(s, a, cg_iters, cg_tol);

  const float live = nnzf > 0.f ? 1.f : 0.f;
  if (tid < F) s.x[tid] *= live;
  __syncthreads();
  if (tid < F) x_out[(int64_t)row * F + tid] = s.x[tid];

  // train-error identity (cumf_als_tpu/ops/rmse.py, fused_sq_err)
  cumf::matvec<NB>(a, s.x, s.ap);
  const float cross = cumf::dot<NB>(s, s.x, s.b);
  const float xax = cumf::dot<NB>(s, s.x, s.ap);
  const float xx = cumf::dot<NB>(s, s.x, s.x);
  if (tid == 0) {
    const float se = r2 - 2.f * cross + (xax - diag * xx);
    se_out[row] = se < 0.f ? 0.f : se;  // max(se, 0); NaN stays NaN
  }
}

template <typename TT, typename VT>
__global__ void __launch_bounds__(cumf::wide::Shape<32>::THREADS)
    gather_gram_cg_256_kernel(const TT* __restrict__ table,
                              const int32_t* __restrict__ cols,
                              const VT* __restrict__ vals,
                              const int32_t* __restrict__ nnz,
                              const float* __restrict__ x0,
                              float* __restrict__ x_out,
                              float* __restrict__ se_out, int p, float lam,
                              int cg_iters, float cg_tol) {
  __shared__ cumf::wide::Smem<32> s;
  const int64_t row = blockIdx.x;
  cumf::wide::gather_row<32>(
      s, table, cols + row * p, vals + row * p, min(nnz[row], p),
      (float)nnz[row], lam, x0 + row * cumf::wide::kStride,
      x_out + row * cumf::wide::kStride, se_out + row, cg_iters, cg_tol);
}

template <int NB, typename TT, typename VT>
void launch(const void* table, const void* cols, const void* vals,
            const void* nnz, const void* x0, void* x_out, void* se_out,
            int r, int p, float lam, int cg_iters, float cg_tol,
            cudaStream_t stream) {
  gather_gram_cg_kernel<NB, TT, VT><<<r, cumf::kThreads, 0, stream>>>(
      (const TT*)table, (const int32_t*)cols, (const VT*)vals,
      (const int32_t*)nnz, (const float*)x0, (float*)x_out, (float*)se_out,
      p, lam, cg_iters, cg_tol);
}

template <typename TT, typename VT>
int dispatch(int f, const void* table, const void* cols, const void* vals,
             const void* nnz, const void* x0, void* x_out, void* se_out,
             int r, int p, float lam, int cg_iters, float cg_tol,
             cudaStream_t stream) {
  if (f == 256) {
    gather_gram_cg_256_kernel<TT, VT>
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

extern "C" int cumf_gather_gram_cg(const void* table, int table_bf16,
                                   const void* cols, const void* vals,
                                   int vals_bf16, const void* nnz,
                                   const void* x0, void* x_out, void* se_out,
                                   int r, int p, int f, float lam,
                                   int cg_iters, float cg_tol, void* part,
                                   int spans, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // pass 1 of the cut of a chunk of few rows (frag_cg.cuh): `spans`
  // spans a row, each span's record into part; x_out and se_out
  // are pass 2's
  if (part) {
    if (!table_bf16 || f != cumf::mma::kF)
      return (int)cudaErrorInvalidValue;
    return cumf::mma::run_span_gram<false>(table, cols, vals, vals_bf16,
                                           nnz, part, r, p, spans, st);
  }
  // the tensor-core body where it takes the table, else the FMA bodies
  if (table_bf16 && f == cumf::mma::kF)
    return cumf::mma::run_cg<false>(table, cols, vals, vals_bf16, nnz, x0,
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
