// K3: batched CG on a raw Gram plus a per-system diagonal.
//
// Replaces the TPU kernel `_cg_solve_reg_kernel` (with `_cg_loop`) of
// cumf_als_tpu/ops/pallas_solve.py, reached through
// `solve_cg_pallas(diag=...)`. Per system r:
//   x = CG(f32(A_r) + diag_r I, b_r, x0_r)
// A is read once in its stored dtype (bf16 or f32) and widened in
// registers, where the diagonal is added, so a bf16 accumulator is never
// widened in device memory. A system of zeros with diag 0 has p.Ap = 0
// and returns x0; a NaN system stays NaN.
//
// Bound on an H100: reading A. The Netflix X phase solves two slices of
// 16,384 systems of 128 x 128 bf16, 537 MB a slice, i.e. ~0.16 ms at
// 3.35 TB/s (0.32 ms with an f32 A); the CG work (at most cg_iters + 1
// matvecs of 2 f^2 FLOPs each) is small, but each step is a chain of
// reductions across the block.
// What this design does about it (bulk_cg.cuh): persistent blocks, as
// many as fit the SMs (`cuda_solve.cg_reg_grid`, from the occupancy
// query below: two an SM at f = 128 with a bf16 A, one with an f32 A,
// whose two 64 KB stages fill the SM, more at smaller f), each
// walking the systems blockIdx.x, + gridDim.x, ...; a ring of two
// shared-memory stages filled by bulk-async copies, so the next system's
// A is in flight while this one's CG runs; A held in registers for the
// matvecs; two block-wide barriers a CG step (the earlier body had
// seven).

#include "bulk_cg.cuh"

namespace {

namespace bulk = cumf::bulk;

template <int NB, typename AT>
constexpr int kRingBytes = bulk::kStages * bulk::Stage<NB, AT>::BYTES;

template <int NB, typename AT>
__global__ void __launch_bounds__(cumf::kThreads, 2)
    solve_cg_reg_kernel(const AT* __restrict__ a_in,
                        const float* __restrict__ diag,
                        const float* __restrict__ b,
                        const float* __restrict__ x0,
                        float* __restrict__ x_out, int r, int cg_iters,
                        float cg_tol) {
  extern __shared__ __align__(128) unsigned char stages[];
  __shared__ bulk::Scratch<NB> s;
  bulk::solve_systems<NB, AT>(stages, s, a_in, diag, b, x0, x_out, r,
                              cg_iters, cg_tol);
}

// the ring is dynamic shared memory above 48 KB: allowed once per
// instantiation, before the first launch or occupancy query
template <int NB, typename AT>
cudaError_t allow_ring() {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      solve_cg_reg_kernel<NB, AT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes<NB, AT>);
  return allowed;
}

template <int NB, typename AT>
int launch(const void* a, const void* diag, const void* b, const void* x0,
           void* x_out, int r, int cg_iters, float cg_tol, int grid,
           cudaStream_t stream) {
  const cudaError_t allowed = allow_ring<NB, AT>();
  if (allowed != cudaSuccess) return (int)allowed;
  solve_cg_reg_kernel<NB, AT><<<grid, cumf::kThreads, kRingBytes<NB, AT>,
                                stream>>>(
      (const AT*)a, (const float*)diag, (const float*)b, (const float*)x0,
      (float*)x_out, r, cg_iters, cg_tol);
  return (int)cudaGetLastError();
}

// how many blocks of this instantiation one SM of the current device
// holds at once, from its registers and its shared memory (ring and
// Scratch) as the compiler laid them out
template <int NB, typename AT>
int blocks_per_sm(int* out) {
  const cudaError_t allowed = allow_ring<NB, AT>();
  if (allowed != cudaSuccess) return (int)allowed;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, solve_cg_reg_kernel<NB, AT>, cumf::kThreads, kRingBytes<NB, AT>);
}

template <typename AT>
int dispatch(int f, const void* a, const void* diag, const void* b,
             const void* x0, void* x_out, int r, int cg_iters, float cg_tol,
             int grid, cudaStream_t stream) {
#define CUMF_LAUNCH(NB)                                                   \
  return launch<NB, AT>(a, diag, b, x0, x_out, r, cg_iters, cg_tol, grid, \
                        stream)
  CUMF_DISPATCH_NB(f, CUMF_LAUNCH)
#undef CUMF_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename AT>
int dispatch_occupancy(int f, int* out) {
#define CUMF_QUERY(NB) return blocks_per_sm<NB, AT>(out)
  CUMF_DISPATCH_NB(f, CUMF_QUERY)
#undef CUMF_QUERY
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a, b, x0: contiguous, on 16-byte boundaries; grid: the persistent
// blocks, 1 <= grid <= r (`cuda_solve.cg_reg_grid`, from the SM count and
// cumf_solve_cg_reg_blocks_per_sm).
extern "C" int cumf_solve_cg_reg(const void* a, int a_bf16, const void* diag,
                                 const void* b, const void* x0, void* x_out,
                                 int r, int f, int cg_iters, float cg_tol,
                                 int grid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (grid < 1 || grid > r) return (int)cudaErrorInvalidValue;
  if (a_bf16)
    return dispatch<__nv_bfloat16>(f, a, diag, b, x0, x_out, r, cg_iters,
                                   cg_tol, grid, st);
  return dispatch<float>(f, a, diag, b, x0, x_out, r, cg_iters, cg_tol,
                         grid, st);
}

// The occupancy query beside the kernel: writes to *out (an int) the
// blocks of K3 at this f and A dtype that fit one SM of the current
// device, so the host sizes the persistent grid without a copy of the
// kernel's layout.
extern "C" int cumf_solve_cg_reg_blocks_per_sm(int f, int a_bf16,
                                               void* out) {
  if (a_bf16) return dispatch_occupancy<__nv_bfloat16>(f, (int*)out);
  return dispatch_occupancy<float>(f, (int*)out);
}
