// K8: fused Gram + regularized CG + per-row train error over an already
// gathered, lane-packed G.
//
// Replaces the TPU kernel `_kernel_cat` of
// cumf_als_tpu/ops/pallas_solve.py, reached through `fused_gram_cg_cat`:
// G arrives as two slabs, g1 (R, P, 128) and the packed remainder
// g2 (R, P, f2), joined to 256 lanes (lanes >= 128 + f2 zero). Unlike
// the other fused kernels this one gathers nothing: the JAX package has
// no gather wrapper for it, so it keeps the contract of
// `fused_gram_cg_cat` and reads G from device memory.
//
// Per row r, over all P slots (not only nnz):
//   g = [g1, g2, 0]  (256 lanes)
//   A = sum_p g g^T (f32), b = sum_p v g, r2 = sum_p v^2
//   A += (nnz*lam + [nnz == 0]) I
//   x = CG(A, b, x0) * [nnz > 0]   (all 256 lanes: the dead lanes carry
//       the diagonal only, so they relax from x0 towards 0 under CG)
//   se = max(r2 - 2 x.b + x^T (A - diag I) x, 0)
//
// Bound on an H100: bytes. G is read once, R * P * (128 + f2) elements
// (1.9 GB for 16,384 rows of 256 slots in bf16 at f2 = 96: 0.56 ms at
// 3.35 TB/s), against 2 * R * P * 256^2 FLOPs.
// What the design does about it. A bf16 G whose f2 is a multiple of 32
// (what `wide_f2` gives) runs as K1 at 256 lanes does on a bf16 table:
// the two passes of the row cut, pass 1 on the tensor cores
// (wide_span_gram_mma.cu, reading the slabs where K1 gathers the table,
// every slot up to P) into records of all 256 lanes, pass 2
// (wide_span_solve.cu, every span live) adding them in span order and
// solving; ops/cuda_solve.py `fused_gram_cg_cat` takes that route, and
// on a G gathered from a bf16 table (zero past nnz) its result equals
// K1's bit for bit. This file is the rest: a float32 G (which bf16
// tensor cores would round) or another f2, one block a row, G streamed
// through the 32-slot staging tile of wide.cuh once, the Gram on the
// triangle of register tiles (f32 FMAs), which the FMA rate bounds.

#include "wide.cuh"

namespace {

using cumf::wide::kStride;

template <typename GT, typename VT>
__global__ void __launch_bounds__(cumf::wide::Shape<32>::THREADS)
    fused_gram_cg_cat_kernel(const GT* __restrict__ g1,
                             const GT* __restrict__ g2,
                             const VT* __restrict__ vals,
                             const int32_t* __restrict__ nnz,
                             const float* __restrict__ x0,
                             float* __restrict__ x_out,
                             float* __restrict__ se_out, int p, int f2,
                             float lam, int cg_iters, float cg_tol) {
  __shared__ cumf::wide::Smem<32> s;
  const int64_t row = blockIdx.x;
  const GT* g1_row = g1 + row * p * 128;
  const GT* g2_row = g2 + row * p * f2;
  const VT* vals_row = vals + row * p;

  const cumf::wide::Tile tl = cumf::wide::tile_of<32>();
  float a[cumf::wide::kB][cumf::wide::kB];
  cumf::zero_acc<cumf::wide::kB>(a);
  float b_acc = 0.f, r2_acc = 0.f;
  for (int lo = 0; lo < p; lo += cumf::kTile) {
    const int nt = min(cumf::kTile, p - lo);
    cumf::wide::load_tile_cat(s, g1_row, g2_row, f2, vals_row, lo, nt);
    cumf::wide::accumulate_tile<32>(s, nt, tl, a, b_acc, r2_acc);
    __syncthreads();
  }
  cumf::wide::solve_and_store<32>(s, tl, a, b_acc, r2_acc, (float)nnz[row],
                                  lam, x0 + row * kStride,
                                  x_out + row * kStride, se_out + row,
                                  cg_iters, cg_tol);
}

template <typename GT, typename VT>
int launch(const void* g1, const void* g2, const void* vals,
           const void* nnz, const void* x0, void* x_out, void* se_out, int r,
           int p, int f2, float lam, int cg_iters, float cg_tol,
           cudaStream_t stream) {
  fused_gram_cg_cat_kernel<GT, VT>
      <<<r, cumf::wide::Shape<32>::THREADS, 0, stream>>>(
          (const GT*)g1, (const GT*)g2, (const VT*)vals,
          (const int32_t*)nnz, (const float*)x0, (float*)x_out,
          (float*)se_out, p, f2, lam, cg_iters, cg_tol);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cumf_fused_gram_cg_cat(const void* g1, const void* g2,
                                      int g_bf16, const void* vals,
                                      int vals_bf16, const void* nnz,
                                      const void* x0, void* x_out,
                                      void* se_out, int r, int p, int f2,
                                      float lam, int cg_iters, float cg_tol,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (f2 < 1 || f2 > 128) return (int)cudaErrorInvalidValue;
  if (g_bf16 && vals_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(g1, g2, vals, nnz, x0, x_out,
                                                se_out, r, p, f2, lam,
                                                cg_iters, cg_tol, st);
  if (g_bf16)
    return launch<__nv_bfloat16, float>(g1, g2, vals, nnz, x0, x_out, se_out,
                                        r, p, f2, lam, cg_iters, cg_tol, st);
  if (vals_bf16)
    return launch<float, __nv_bfloat16>(g1, g2, vals, nnz, x0, x_out, se_out,
                                        r, p, f2, lam, cg_iters, cg_tol, st);
  return launch<float, float>(g1, g2, vals, nnz, x0, x_out, se_out, r, p, f2,
                              lam, cg_iters, cg_tol, st);
}
