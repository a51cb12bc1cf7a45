// K3: batched CG on a raw Gram plus a per-system diagonal.
//
// Replaces the TPU kernel `_cg_solve_reg_kernel` (with `_cg_loop`) of
// cumf_als_tpu/ops/pallas_solve.py, reached through
// `solve_cg_pallas(diag=...)`. Per system r (one thread block each):
//   x = CG(f32(A_r) + diag_r I, b_r, x0_r)
// A is read once (bf16 or f32) into the block's registers; the diagonal
// is added there, so a bf16 accumulator is never widened in device
// memory. A system of zeros with diag 0 has p.Ap = 0 and returns x0.
//
// Bound on an H100: reading A. The Netflix X phase solves 32,768
// systems of 128 x 128 bf16, 1.07 GB, i.e. ~0.32 ms at 3.35 TB/s; the CG
// work (at most cg_iters + 1 matvecs of 2 f^2 FLOPs each) is small.
// What this design does about it: nothing yet. Each block loads its A
// with plain coalesced loads and then runs the CG with many block-wide
// barriers, so little load is in flight per SM; overlapping loads with
// the CG of other systems comes in a later change.

#include "common.cuh"

namespace {

template <int NB, typename AT>
__global__ void __launch_bounds__(cumf::kThreads)
    solve_cg_reg_kernel(const AT* __restrict__ a_in,
                        const float* __restrict__ diag,
                        const float* __restrict__ b,
                        const float* __restrict__ x0,
                        float* __restrict__ x_out, int cg_iters,
                        float cg_tol) {
  constexpr int F = 16 * NB;
  __shared__ cumf::Smem<NB> s;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  float a[NB][NB];
  const AT* src = a_in + (int64_t)row * F * F;
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int l = 0; l < NB; ++l)
      a[k][l] = cumf::to_f32(src[(ty + 16 * k) * F + tx * NB + l]);
  cumf::add_diag<NB>(a, diag[row]);
  if (tid < F) {
    s.b[tid] = b[(int64_t)row * F + tid];
    s.x[tid] = x0[(int64_t)row * F + tid];
  }
  __syncthreads();

  cumf::cg<NB>(s, a, cg_iters, cg_tol);

  if (tid < F) x_out[(int64_t)row * F + tid] = s.x[tid];
}

template <int NB, typename AT>
void launch(const void* a, const void* diag, const void* b, const void* x0,
            void* x_out, int r, int cg_iters, float cg_tol,
            cudaStream_t stream) {
  solve_cg_reg_kernel<NB, AT><<<r, cumf::kThreads, 0, stream>>>(
      (const AT*)a, (const float*)diag, (const float*)b, (const float*)x0,
      (float*)x_out, cg_iters, cg_tol);
}

template <typename AT>
int dispatch(int f, const void* a, const void* diag, const void* b,
             const void* x0, void* x_out, int r, int cg_iters, float cg_tol,
             cudaStream_t stream) {
#define CUMF_LAUNCH(NB) \
  launch<NB, AT>(a, diag, b, x0, x_out, r, cg_iters, cg_tol, stream)
  CUMF_DISPATCH_NB(f, CUMF_LAUNCH)
#undef CUMF_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cumf_solve_cg_reg(const void* a, int a_bf16, const void* diag,
                                 const void* b, const void* x0, void* x_out,
                                 int r, int f, int cg_iters, float cg_tol,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (a_bf16)
    return dispatch<__nv_bfloat16>(f, a, diag, b, x0, x_out, r, cg_iters,
                                   cg_tol, st);
  return dispatch<float>(f, a, diag, b, x0, x_out, r, cg_iters, cg_tol, st);
}
