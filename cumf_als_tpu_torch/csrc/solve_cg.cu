// K4: batched CG on systems that are already regularized.
//
// Replaces the TPU kernel `_cg_solve_kernel` (with `_cg_loop`) of
// cumf_als_tpu/ops/pallas_solve.py, reached through
// `solve_cg_pallas(diag=None)`. Per system r:
//   x = CG(f32(A_r), b_r, x0_r)
// A is used as given: no diagonal is added. A system of zeros has
// p.Ap = 0 and returns x0 (the alpha guard of the CG loop).
//
// Bound on an H100: reading A. One solve slice of the Netflix X phase is
// 16,384 systems of 128 x 128 f32, 1.07 GB, i.e. ~0.32 ms at 3.35 TB/s
// (1.28 ms at f = 256); the CG work (at most cg_iters + 1 matvecs of
// 2 f^2 FLOPs each) is small.
// What this design does about it: K3's (bulk_cg.cuh, Mode::kPlain):
// persistent blocks with A, b and x0 in a ring of bulk-async stages, A in
// registers, two barriers a CG step at f <= 128; at f = 256 a cluster
// of two blocks a system, half of A in each one's registers.

#include "bulk_cg.cuh"

// a, b, x0: contiguous, on 16-byte boundaries; diag is not read; grid:
// the persistent blocks, 1 <= grid <= r
// (at f = 256 an even 2 <= grid <= 2 r: clusters of two blocks).
extern "C" int cumf_solve_cg(const void* a, int a_bf16, const void* diag,
                             const void* b, const void* x0, void* x_out,
                             int r, int f, int cg_iters, float cg_tol,
                             int grid, void* stream) {
  return cumf::bulk::run<cumf::bulk::Mode::kPlain>(
      a, a_bf16, diag, b, x0, x_out, r, f, cg_iters, cg_tol, grid,
      (cudaStream_t)stream);
}

// writes to *out (an int) the blocks of K4 at this f and A dtype that
// one SM of the current device takes; at f = 256 the clusters of two
// blocks that the whole device takes
extern "C" int cumf_solve_cg_blocks_per_sm(int f, int a_bf16, void* out) {
  return cumf::bulk::blocks_per_sm<cumf::bulk::Mode::kPlain>(f, a_bf16,
                                                              out);
}
