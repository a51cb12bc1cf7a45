// The batched CG at factor widths F > 256, f = 128 T lanes (T >= 3),
// with each system's A read from device memory at every matvec: K3, K4
// and K5b there, and pass 2 of K1 and K6 there (pass 1 is
// tile_gram.cu).
//
// Replaces, at f >= 384, the TPU kernels `_cg_solve_reg_kernel` (K3),
// `_cg_solve_kernel` (K4) and `_cg_solve_aug_kernel` (K5b) of
// cumf_als_tpu/ops/pallas_solve.py, reached through `solve_cg_pallas`,
// and the solve and train error of `_kernel` (K1) and `_kernel_aug`
// (K6), reached through `gather_gram_cg`. Per system r, with A read in
// its stored dtype (f32 or bf16) and summed in f32:
//   kReg   (K3)  x = CG(A + diag I, b, x0)
//   kPlain (K4)  x = CG(A, b, x0)
//   kAug   (K5b) b = row f - 1 of A' (lane f - 1 as 0),
//                x = CG(A' with row and column f - 1 read as 0 + diag I,
//                       b, x0)
//   kFused (K1, K6 with aug: b and r2 from row f - 1 and the corner of
//          A' as K5b takes b) diag = nnz lam + [nnz = 0],
//          x = CG(A + diag I, b, x0) [nnz > 0],
//          se = max(r2 - 2 x.b + x^T A x, 0)
// The CG is pallas_solve.py:_cg_loop's (cg_loop of common.cuh): warm
// start, at most cg_iters steps, x and r updated before the rsnew <
// cg_tol test (a per-system exit), alpha 0 when p.Ap == 0 (NaN stays
// NaN), beta guarded by rsold <= 0. Every dot product is summed in one
// fixed order (a lane's entries, a warp's butterfly, the eight warps in
// order), so a result repeats bit for bit.
//
// Bound on an H100: reading A once. At f = 384 a system's f32 A takes
// 576 KB, more than one SM's shared memory, and the f = 256 design (half
// of A in the registers of each block of a two-block cluster,
// bulk_cg.cuh) does not widen to it. So the design is the simple one:
// one block of 256 threads a system, A's rows read from device memory at
// each of the cg_iters + 1 matvecs (one more for the train error), four
// rows a warp at a time in 16-byte loads, the vectors in shared memory.
// The L2 (50 MB) serves what it still holds of A between matvecs; with
// many systems in flight it holds little, so A crosses from device
// memory up to cg_iters + 2 times: the kernel is bound by those bytes,
// cg_iters + 2 times the bound.

#include "common.cuh"

namespace {

using cumf::to_f32;

constexpr int kWarps = cumf::kThreads / 32;
constexpr int kRowsPerWarp = 4;  // rows of A a warp reads at once

enum class Mode { kReg, kPlain, kAug, kFused };

// 16 bytes of a row of A, widened to f32: 4 floats or 8 bf16.
template <typename AT>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float (&o)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    o[0] = q.x;
    o[1] = q.y;
    o[2] = q.z;
    o[3] = q.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&o)[8]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // two bf16, the lower lane in the low half: widen by shifting
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// out = A v + d v over f lanes; with AUG row and column f - 1 of A read
// as 0. Warp w takes rows 4 w .. 4 w + 3, then 32 rows on; lane l
// reads entries l N .. l N + N - 1 of each, then 32 N on. Ends in a
// block barrier.
template <bool AUG, typename AT>
__device__ __forceinline__ void matvec(const AT* a, int f, const float* v,
                                       float* out, float d) {
  constexpr int N = Vec<AT>::kN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i0 = warp * kRowsPerWarp; i0 < f; i0 += kWarps * kRowsPerWarp) {
    float sum[kRowsPerWarp];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) sum[k] = 0.f;
    for (int c = lane * N; c < f; c += 32 * N) {
      float vv[N];
#pragma unroll
      for (int j = 0; j < N; j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(v + c + j);
        vv[j] = q.x;
        vv[j + 1] = q.y;
        vv[j + 2] = q.z;
        vv[j + 3] = q.w;
      }
      if (AUG && c + N == f) vv[N - 1] = 0.f;  // column f - 1
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        float ak[N];
        Vec<AT>::load(a + (int64_t)(i0 + k) * f + c, ak);
#pragma unroll
        for (int j = 0; j < N; ++j) sum[k] = fmaf(ak[j], vv[j], sum[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], o);
    if (lane < kRowsPerWarp) {
      const int i = i0 + lane;
      float s = sum[0];
#pragma unroll
      for (int k = 1; k < kRowsPerWarp; ++k)
        if (lane == k) s = sum[k];
      if (AUG && i == f - 1) s = 0.f;  // row f - 1
      out[i] = s + d * v[i];
    }
  }
  __syncthreads();
}

// The block's sum of each thread's `part`, the same in every thread.
__device__ __forceinline__ float block_sum(float part, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
  __syncthreads();
  float sum = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) sum += red[w];
  __syncthreads();
  return sum;
}

template <Mode M, bool AUG, typename AT>
__global__ void __launch_bounds__(cumf::kThreads)
    global_cg_kernel(const AT* __restrict__ a,
                     const float* __restrict__ diag,
                     const float* __restrict__ b,
                     const float* __restrict__ r2,
                     const int32_t* __restrict__ nnz,
                     const float* __restrict__ x0, float* __restrict__ x_out,
                     float* __restrict__ se_out, int f, float lam,
                     int cg_iters, float cg_tol) {
  // x, r, p, ap, b (f each), then the warps' partial sums
  extern __shared__ __align__(16) float vecs[];
  float* x = vecs;
  float* r = x + f;
  float* p = r + f;
  float* ap = p + f;
  float* bv = ap + f;
  float* red = bv + f;
  const int sys = blockIdx.x;
  const int tid = threadIdx.x;
  const AT* A = a + (int64_t)sys * f * f;
  const int64_t row0 = (int64_t)sys * f;

  float d = 0.f;
  int n_live = 1;
  if constexpr (M == Mode::kReg || M == Mode::kAug) d = diag[sys];
  if constexpr (M == Mode::kFused) {
    n_live = nnz[sys];
    d = (float)n_live * lam + (n_live == 0 ? 1.f : 0.f);
  }
  for (int i = tid; i < f; i += cumf::kThreads) {
    x[i] = x0[row0 + i];
    if constexpr (AUG)
      bv[i] = i < f - 1 ? to_f32(A[(int64_t)(f - 1) * f + i]) : 0.f;
    else
      bv[i] = b[row0 + i];
  }
  __syncthreads();

  matvec<AUG>(A, f, x, ap, d);
  float part = 0.f;
  for (int i = tid; i < f; i += cumf::kThreads) {
    const float ri = bv[i] - ap[i];
    r[i] = ri;
    p[i] = ri;
    part = fmaf(ri, ri, part);
  }
  float rsold = block_sum(part, red);
  for (int it = 0; it < cg_iters; ++it) {
    matvec<AUG>(A, f, p, ap, d);
    part = 0.f;
    for (int i = tid; i < f; i += cumf::kThreads)
      part = fmaf(p[i], ap[i], part);
    const float pap = block_sum(part, red);
    // the Pallas guard, literally: a zero p.Ap gives alpha 0, a NaN one
    // gives NaN (so a NaN system stays NaN)
    const float nonzero = fabsf(pap) > 0.f ? 1.f : 0.f;
    const float alpha = nonzero * rsold / (pap + (1.f - nonzero));
    part = 0.f;
    for (int i = tid; i < f; i += cumf::kThreads) {
      x[i] = x[i] + alpha * p[i];
      const float ri = r[i] - alpha * ap[i];
      r[i] = ri;
      part = fmaf(ri, ri, part);
    }
    const float rsnew = block_sum(part, red);
    if (!(rsnew >= cg_tol)) break;  // per-system exit, after the update
    const float beta = rsnew / (rsold + (rsold <= 0.f ? 1.f : 0.f));
    for (int i = tid; i < f; i += cumf::kThreads) p[i] = r[i] + beta * p[i];
    __syncthreads();
    rsold = rsnew;
  }

  if constexpr (M == Mode::kFused) {
    const float live = n_live > 0 ? 1.f : 0.f;
    for (int i = tid; i < f; i += cumf::kThreads) x[i] = x[i] * live;
    __syncthreads();
    // the train error on the raw Gram: x^T A x without the diagonal
    matvec<AUG>(A, f, x, ap, 0.f);
    float cross = 0.f, quad = 0.f;
    for (int i = tid; i < f; i += cumf::kThreads) {
      cross = fmaf(x[i], bv[i], cross);
      quad = fmaf(x[i], ap[i], quad);
    }
    cross = block_sum(cross, red);
    quad = block_sum(quad, red);
    if (tid == 0) {
      float sq;
      if constexpr (AUG)
        sq = to_f32(A[(int64_t)(f - 1) * f + f - 1]);
      else
        sq = r2[sys];
      se_out[sys] = fmaxf(sq - 2.f * cross + quad, 0.f);
    }
  }
  for (int i = tid; i < f; i += cumf::kThreads) x_out[row0 + i] = x[i];
}

template <Mode M, bool AUG, typename AT>
int launch(const void* a, const void* diag, const void* b, const void* r2,
           const void* nnz, const void* x0, void* x_out, void* se_out, int r,
           int f, float lam, int cg_iters, float cg_tol,
           cudaStream_t stream) {
  auto kernel = global_cg_kernel<M, AUG, AT>;
  const int smem = (5 * f + kWarps) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t allowed = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (allowed != cudaSuccess) return (int)allowed;
  }
  kernel<<<r, cumf::kThreads, smem, stream>>>(
      (const AT*)a, (const float*)diag, (const float*)b, (const float*)r2,
      (const int32_t*)nnz, (const float*)x0, (float*)x_out, (float*)se_out,
      f, lam, cg_iters, cg_tol);
  return (int)cudaGetLastError();
}

template <typename AT>
int run(int mode, int aug, const void* a, const void* diag, const void* b,
        const void* r2, const void* nnz, const void* x0, void* x_out,
        void* se_out, int r, int f, float lam, int cg_iters, float cg_tol,
        cudaStream_t stream) {
#define CUMF_CG(M, AUG)                                                    \
  return launch<Mode::M, AUG, AT>(a, diag, b, r2, nnz, x0, x_out, se_out, r, \
                                  f, lam, cg_iters, cg_tol, stream)
  switch (mode) {
    case 0: CUMF_CG(kReg, false);
    case 1: CUMF_CG(kPlain, false);
    case 2: CUMF_CG(kAug, true);
    case 3:
      if (aug) CUMF_CG(kFused, true);
      CUMF_CG(kFused, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CUMF_CG
}

}  // namespace

// r systems at f = 128 T lanes, T >= 3. a (r, f, f) f32 or bf16 on a
// 16-byte boundary; mode 0 (K3: diag, b), 1 (K4: b), 2 (K5b: diag, b
// from A'), 3 (K1, K6 with aug: b and r2 (r,), or both from A', nnz,
// lam; writes se_out (r,)); x0 and x_out (r, f) f32. Unused pointers may
// be null. Returns the CUDA error.
extern "C" int cumf_global_cg(const void* a, int a_bf16, const void* diag,
                              const void* b, const void* r2, const void* nnz,
                              const void* x0, void* x_out, void* se_out,
                              int r, int f, int mode, int aug, float lam,
                              int cg_iters, float cg_tol, void* stream) {
  if (f < 384 || f % 128 || r < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (a_bf16)
    return run<__nv_bfloat16>(mode, aug, a, diag, b, r2, nnz, x0, x_out,
                              se_out, r, f, lam, cg_iters, cg_tol, st);
  return run<float>(mode, aug, a, diag, b, r2, nnz, x0, x_out, se_out, r, f,
                    lam, cg_iters, cg_tol, st);
}
