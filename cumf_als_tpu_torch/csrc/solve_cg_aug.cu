// K5b: batched CG on an augmented accumulator A' plus a per-system
// diagonal.
//
// Replaces the TPU kernel `_cg_solve_aug_kernel` (with `_cg_loop`) of
// cumf_als_tpu/ops/pallas_solve.py, reached through
// `solve_cg_pallas(aug=True)`. A' carries b in row f - 1 and sum v^2 in
// the corner (see common.cuh). Per system r (one thread block each):
//   b = row f - 1 of f32(A'_r), lane f - 1 zeroed
//   A = A'_r with row and column f - 1 zeroed, + diag_r I on the whole
//       diagonal (so entry (f - 1, f - 1) is diag_r)
//   x = CG(A, b, x0_r)
// The unpack runs on the block's registers, so no A-sized unpack pass
// touches device memory. With lane f - 1 of x0 zero (the padding
// contract: the true factor width is at most f - 1) lane f - 1 of x
// stays exactly 0.
//
// Bound on an H100: reading A'. One solve slice of the Netflix X phase
// is 16,384 systems of 128 x 128 f32, 1.07 GB, i.e. ~0.32 ms at
// 3.35 TB/s; the CG work is small.
// What this design does about it: nothing yet (as solve_cg_reg.cu: plain
// coalesced loads, then a CG with many block-wide barriers).

#include "common.cuh"

namespace {

template <int NB, typename AT>
__global__ void __launch_bounds__(cumf::kThreads)
    solve_cg_aug_kernel(const AT* __restrict__ a_in,
                        const float* __restrict__ diag,
                        const float* __restrict__ x0,
                        float* __restrict__ x_out, int cg_iters,
                        float cg_tol) {
  constexpr int F = 16 * NB;
  __shared__ cumf::Smem<NB> s;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;

  float a[NB][NB];
  cumf::load_system<NB>(a_in + (int64_t)row * F * F, a);
  cumf::unpack_aug<NB>(s, a);  // row f - 1 out first, then the mask
  cumf::add_diag<NB>(a, diag[row]);
  if (tid < F) s.x[tid] = x0[(int64_t)row * F + tid];
  __syncthreads();

  cumf::cg<NB>(s, a, cg_iters, cg_tol);

  if (tid < F) x_out[(int64_t)row * F + tid] = s.x[tid];
}

template <int NB, typename AT>
void launch(const void* a, const void* diag, const void* x0, void* x_out,
            int r, int cg_iters, float cg_tol, cudaStream_t stream) {
  solve_cg_aug_kernel<NB, AT><<<r, cumf::kThreads, 0, stream>>>(
      (const AT*)a, (const float*)diag, (const float*)x0, (float*)x_out,
      cg_iters, cg_tol);
}

template <typename AT>
int dispatch(int f, const void* a, const void* diag, const void* x0,
             void* x_out, int r, int cg_iters, float cg_tol,
             cudaStream_t stream) {
#define CUMF_LAUNCH(NB) \
  launch<NB, AT>(a, diag, x0, x_out, r, cg_iters, cg_tol, stream)
  CUMF_DISPATCH_NB(f, CUMF_LAUNCH)
#undef CUMF_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cumf_solve_cg_aug(const void* a, int a_bf16, const void* diag,
                                 const void* x0, void* x_out, int r, int f,
                                 int cg_iters, float cg_tol, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (a_bf16)
    return dispatch<__nv_bfloat16>(f, a, diag, x0, x_out, r, cg_iters,
                                   cg_tol, st);
  return dispatch<float>(f, a, diag, x0, x_out, r, cg_iters, cg_tol, st);
}
