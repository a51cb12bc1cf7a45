// Pass 2 of the cut of K1 and K6 on a chunk of few rows at f = 128 with a
// bf16 table (frag_cg.cuh): each row's f32 span records, written by pass
// 1 (the K1 or K6 entry point given a record buffer), added in span
// order, then the regularized CG from x0 and the row's train error on the
// wgmma fragment's layout, as the uncut kernels run them:
//   A = sum_s A_s, b = sum_s b_s, r2 = sum_s r2_s over the live spans
//     (s L < min(nnz, P), L = P / S; K6: A' summed, then b and r2 out of
//     row 127 and row and column 127 masked)
//   A += (nnz*lam + [nnz == 0]) I
//   x = CG(A, b, x0), then x *= [nnz > 0]
//   se = max(r2 - 2 x.b + x^T (A - diag I) x, 0)
// A fixed order and no atomics: a result repeats bit for bit. A span
// past its row's nnz was not written by pass 1 and is not read.
//
// Replaces, with pass 1, the TPU kernels `_kernel` (K1) and `_kernel_aug`
// (K6) of cumf_als_tpu/ops/pallas_solve.py on such chunks (see
// gather_gram_cg.cu and gather_gram_cg_aug.cu).
// Bound on an H100: the bytes, the live records of 66 KB read once (the
// widest direct theta chunk of sharded out-of-core training, one real
// row in 32 spans: 2.1 MB, under 1 us at 3.35 TB/s; they were written
// just before and sit in the 50 MB L2), then the CG of each row. What
// this design does about it: one block a row, each thread reading its
// part of the fragment (two rows, 32 columns) from every record, so the
// CG and its barriers are frag_cg_row's, unchanged. R is below the
// blocks that fit the card, so the rows run side by side; one row's
// records pass through one SM.

#include "frag_cg.cuh"

// part (r spans, kRecordFloats) f32, nnz (r,) int32, x0 (r, 128) f32;
// x_out (r, 128) and se_out (r, 1) f32; pass 1 cut each row's p slots
// into `spans` spans of p / spans. Returns the CUDA error.
extern "C" int cumf_frag_span_solve(const void* part, const void* nnz,
                                    const void* x0, void* x_out,
                                    void* se_out, int r, int p, int spans,
                                    int aug, float lam, int cg_iters,
                                    float cg_tol, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (aug)
    return cumf::mma::run_span_solve<true>(part, nnz, x0, x_out, se_out, r,
                                           p, spans, lam, cg_iters, cg_tol,
                                           st);
  return cumf::mma::run_span_solve<false>(part, nnz, x0, x_out, se_out, r, p,
                                          spans, lam, cg_iters, cg_tol, st);
}
