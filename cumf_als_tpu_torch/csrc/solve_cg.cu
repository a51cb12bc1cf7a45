// K4: batched CG on systems that are already regularized.
//
// Replaces the TPU kernel `_cg_solve_kernel` (with `_cg_loop`) of
// cumf_als_tpu/ops/pallas_solve.py, reached through
// `solve_cg_pallas(diag=None)`. Per system r (one thread block each):
//   x = CG(f32(A_r), b_r, x0_r)
// A is used as given: no diagonal is added. It is read once (bf16 or
// f32) into the block's registers. A system of zeros has p.Ap = 0 and
// returns x0 (the alpha guard of the CG loop).
//
// Bound on an H100: reading A. One solve slice of the Netflix X phase is
// 16,384 systems of 128 x 128 f32, 1.07 GB, i.e. ~0.32 ms at 3.35 TB/s;
// the CG work (at most cg_iters + 1 matvecs of 2 f^2 FLOPs each) is
// small.
// What this design does about it: nothing yet. Each block loads its A
// with plain coalesced loads and then runs the CG with many block-wide
// barriers, so little load is in flight per SM; overlapping loads with
// the CG of other systems comes in a later change.

#include "common.cuh"

namespace {

template <int NB, typename AT>
__global__ void __launch_bounds__(cumf::kThreads)
    solve_cg_kernel(const AT* __restrict__ a_in, const float* __restrict__ b,
                    const float* __restrict__ x0, float* __restrict__ x_out,
                    int cg_iters, float cg_tol) {
  constexpr int F = 16 * NB;
  __shared__ cumf::Smem<NB> s;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;

  float a[NB][NB];
  cumf::load_system<NB>(a_in + (int64_t)row * F * F, a);
  if (tid < F) {
    s.b[tid] = b[(int64_t)row * F + tid];
    s.x[tid] = x0[(int64_t)row * F + tid];
  }
  __syncthreads();

  cumf::cg<NB>(s, a, cg_iters, cg_tol);

  if (tid < F) x_out[(int64_t)row * F + tid] = s.x[tid];
}

template <int NB, typename AT>
void launch(const void* a, const void* b, const void* x0, void* x_out, int r,
            int cg_iters, float cg_tol, cudaStream_t stream) {
  solve_cg_kernel<NB, AT><<<r, cumf::kThreads, 0, stream>>>(
      (const AT*)a, (const float*)b, (const float*)x0, (float*)x_out,
      cg_iters, cg_tol);
}

template <typename AT>
int dispatch(int f, const void* a, const void* b, const void* x0,
             void* x_out, int r, int cg_iters, float cg_tol,
             cudaStream_t stream) {
#define CUMF_LAUNCH(NB) \
  launch<NB, AT>(a, b, x0, x_out, r, cg_iters, cg_tol, stream)
  CUMF_DISPATCH_NB(f, CUMF_LAUNCH)
#undef CUMF_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cumf_solve_cg(const void* a, int a_bf16, const void* b,
                             const void* x0, void* x_out, int r, int f,
                             int cg_iters, float cg_tol, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (a_bf16)
    return dispatch<__nv_bfloat16>(f, a, b, x0, x_out, r, cg_iters, cg_tol,
                                   st);
  return dispatch<float>(f, a, b, x0, x_out, r, cg_iters, cg_tol, st);
}
