// K5b: batched CG on an augmented accumulator A' plus a per-system
// diagonal.
//
// Replaces the TPU kernel `_cg_solve_aug_kernel` (with `_cg_loop`) of
// cumf_als_tpu/ops/pallas_solve.py, reached through
// `solve_cg_pallas(aug=True)`. A' carries b in row f - 1 and sum v^2 in
// the corner (see common.cuh). Per system r:
//   b = row f - 1 of f32(A'_r), lane f - 1 zeroed
//   A = A'_r with row and column f - 1 zeroed, + diag_r I on the whole
//       diagonal (so entry (f - 1, f - 1) is diag_r)
//   x = CG(A, b, x0_r)
// The unpack runs on chip (b read from the staged row before the mask),
// so no A-sized unpack pass touches device memory. With lane f - 1 of x0
// zero (the padding contract: the true factor width is at most f - 1)
// lane f - 1 of x stays exactly 0.
//
// Bound on an H100: reading A'. One solve slice of the Netflix X phase
// is 16,384 systems of 128 x 128 f32, 1.07 GB, i.e. ~0.33 ms at
// 3.35 TB/s (1.28 ms at f = 256); the CG work is small.
// What this design does about it: K3's (bulk_cg.cuh, Mode::kAug):
// persistent blocks with A' and x0 in a ring of bulk-async stages, A in
// registers, two barriers a CG step at f <= 128; at f = 256 a cluster
// of two blocks a system, half of A' in each one's registers (block 0
// also copies row f - 1, which only block 1's half holds, for b).

#include "bulk_cg.cuh"

// a, x0: contiguous, on 16-byte boundaries; b is not read; grid: the
// persistent blocks, 1 <= grid <= r
// (at f = 256 an even 2 <= grid <= 2 r: clusters of two blocks).
extern "C" int cumf_solve_cg_aug(const void* a, int a_bf16, const void* diag,
                                 const void* b, const void* x0, void* x_out,
                                 int r, int f, int cg_iters, float cg_tol,
                                 int grid, void* stream) {
  return cumf::bulk::run<cumf::bulk::Mode::kAug>(
      a, a_bf16, diag, b, x0, x_out, r, f, cg_iters, cg_tol, grid,
      (cudaStream_t)stream);
}

// writes to *out (an int) the blocks of K5b at this f and A dtype that
// one SM of the current device takes; at f = 256 the clusters of two
// blocks that the whole device takes
extern "C" int cumf_solve_cg_aug_blocks_per_sm(int f, int a_bf16,
                                               void* out) {
  return cumf::bulk::blocks_per_sm<cumf::bulk::Mode::kAug>(f, a_bf16, out);
}
