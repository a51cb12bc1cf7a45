// Pass 2 of the panel Grams' cut (K2 and K5a on a chunk of few rows):
// the f32 partials of a row's S spans, summed in span order, written as
// the row's A in A's dtype (bf16 through round-to-nearest-even, as
// astype does) and, for K2, its b in f32.
//
// Pass 1 is the panel kernel itself (gather_gram_out.cu or
// gather_gram_aug_out.cu, body gram_mma.cuh at f = 128 or
// wide_gram_mma.cuh's panel body at f = 256) run on the chunk's (R, P)
// slots read as (R S, P / S): span s of row r is row r S + s of that
// view, so its f32 partial A (and b) lands at record r S + s of the
// scratch. Here, for row r:
//   A[r] = sum_{s = 0 .. S-1} A_part[r S + s]  (added in that order)
//   b[r] = sum_{s = 0 .. S-1} b_part[r S + s]  (K2; K5a's b is in A')
// A fixed order and no atomics: a result repeats bit for bit. A row of
// pad slots only has all-zero partials and comes out exactly 0.
//
// Replaces, with pass 1, the TPU kernels `_gram_kernel` (K2) and
// `_gram_kernel_aug` (K5a) of cumf_als_tpu/ops/pallas_solve.py on such
// chunks (see gather_gram_out.cu and gather_gram_aug_out.cu).
// Bound on an H100: the bytes, R S (f^2 + f) floats of partials read
// once and R (f^2 + f) entries written (the hot-segment chunk R = 16,
// S = 8 at f = 256: 34 MB read, 4.2 MB written as f32, ~11 us at
// 3.35 TB/s; the partials were written just before and mostly sit in
// the 50 MB L2). What this design does about it: one thread a float4 of
// the row's output, the S loads of a thread strided by a record, so a
// warp reads 512 contiguous bytes of each partial.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void add4(float4& s, const float4 t) {
  s.x += t.x;
  s.y += t.y;
  s.z += t.z;
  s.w += t.w;
}

template <typename OT>
__device__ __forceinline__ void put4(OT* dst, float4 v);
template <>
__device__ __forceinline__ void put4<float>(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
template <>
__device__ __forceinline__ void put4<__nv_bfloat16>(__nv_bfloat16* dst,
                                                    float4 v) {
  // round to nearest even, as astype does
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 bits;
  bits.x = *reinterpret_cast<uint32_t*>(&lo);
  bits.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = bits;
}

// Grid (ceil((a4 + b4) / kThreads), rows): thread i of row r sums float4
// i of the row's A (i < a4 = f^2 / 4) or of its b (i - a4 < b4 = f / 4,
// 0 for K5a) over the row's `spans` partials.
template <typename OT>
__global__ void __launch_bounds__(kThreads)
    gram_span_sum_kernel(const float4* __restrict__ a_part,
                         const float4* __restrict__ b_part,
                         OT* __restrict__ a_out, float4* __restrict__ b_out,
                         int spans, int a4, int b4) {
  const int64_t row = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < a4) {
    const float4* src = a_part + row * spans * a4 + i;
    float4 sum = src[0];
#pragma unroll 4
    for (int s = 1; s < spans; ++s) add4(sum, src[(int64_t)s * a4]);
    put4<OT>(a_out + (row * a4 + i) * 4, sum);
  } else if (i - a4 < b4) {
    const int j = i - a4;
    const float4* src = b_part + row * spans * b4 + j;
    float4 sum = src[0];
#pragma unroll 4
    for (int s = 1; s < spans; ++s) add4(sum, src[(int64_t)s * b4]);
    b_out[row * b4 + j] = sum;
  }
}

}  // namespace

// r rows of `spans` partials each at width f (a multiple of 4): a_part
// (r spans, f, f) f32, b_part (r spans, f) f32 or null (K5a); a_out
// (r, f, f) in bf16 (out_bf16) or f32, b_out (r, f) f32 or null with
// b_part. Returns the CUDA error.
extern "C" int cumf_gram_span_sum(const void* a_part, const void* b_part,
                                  void* a_out, int out_bf16, void* b_out,
                                  int r, int spans, int f, void* stream) {
  if (f % 4 || spans < 1 || (b_part == nullptr) != (b_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const int a4 = f * f / 4;
  const int b4 = b_part ? f / 4 : 0;
  const dim3 grid((a4 + b4 + kThreads - 1) / kThreads, r);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    gram_span_sum_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const float4*)a_part, (const float4*)b_part, (__nv_bfloat16*)a_out,
        (float4*)b_out, spans, a4, b4);
  else
    gram_span_sum_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float4*)a_part, (const float4*)b_part, (float*)a_out,
        (float4*)b_out, spans, a4, b4);
  return (int)cudaGetLastError();
}
