// K3: batched CG on a raw Gram plus a per-system diagonal.
//
// Replaces the TPU kernel `_cg_solve_reg_kernel` (with `_cg_loop`) of
// cumf_als_tpu/ops/pallas_solve.py, reached through
// `solve_cg_pallas(diag=...)`. Per system r:
//   x = CG(f32(A_r) + diag_r I, b_r, x0_r)
// A is read in its stored dtype (bf16 or f32) and widened on chip, where
// the diagonal is added, so a bf16 accumulator is never widened in
// device memory. A system of zeros with diag 0 has p.Ap = 0 and returns
// x0; a NaN system stays NaN.
//
// Bound on an H100: reading A. The Netflix X phase solves two slices of
// 16,384 systems of 128 x 128 bf16, 537 MB a slice, i.e. ~0.16 ms at
// 3.35 TB/s (0.32 ms with an f32 A; 1.28 ms at f = 256); the CG work (at
// most cg_iters + 1 matvecs of 2 f^2 FLOPs each) is small, but each step
// is a chain of reductions across the block.
// What this design does about it (bulk_cg.cuh, Mode::kReg): at f <= 128
// persistent blocks, as many as fit the SMs (`cuda_solve.cg_grid`, from
// the occupancy query below: two an SM at f = 128 with a bf16 A, one
// with an f32 A, whose two 64 KB stages fill the SM, more at smaller f),
// each walking the systems blockIdx.x, + gridDim.x, ...; a ring of two
// shared-memory stages filled by bulk-async copies, so the next
// system's A is in flight while this one's CG runs; A held in registers
// for the matvecs; two block-wide barriers a CG step. At f = 256 one
// system a cluster of two blocks, each holding half of A in registers
// (from one stage, or a ring of two with a bf16 A), A p exchanged
// through distributed shared memory once a step (see bulk_cg.cuh), so A
// is read from device memory once there too.

#include "bulk_cg.cuh"

// a, b, x0: contiguous, on 16-byte boundaries; grid: the persistent
// blocks, 1 <= grid <= r
// (at f = 256 an even 2 <= grid <= 2 r: clusters of two blocks).
extern "C" int cumf_solve_cg_reg(const void* a, int a_bf16, const void* diag,
                                 const void* b, const void* x0, void* x_out,
                                 int r, int f, int cg_iters, float cg_tol,
                                 int grid, void* stream) {
  return cumf::bulk::run<cumf::bulk::Mode::kReg>(
      a, a_bf16, diag, b, x0, x_out, r, f, cg_iters, cg_tol, grid,
      (cudaStream_t)stream);
}

// writes to *out (an int) the blocks of K3 at this f and A dtype that
// one SM of the current device takes; at f = 256 the clusters of two
// blocks that the whole device takes
extern "C" int cumf_solve_cg_reg_blocks_per_sm(int f, int a_bf16,
                                               void* out) {
  return cumf::bulk::blocks_per_sm<cumf::bulk::Mode::kReg>(f, a_bf16, out);
}
