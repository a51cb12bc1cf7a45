// Pass 1 of the row cut of the 256-lane body (wide.cuh) on the FMA body:
// the Gram of one span of one row's slots, written to scratch. With
// wide_span_solve.cu it serves the kernels of that body on a chunk with
// fewer rows than the card has SMs and a float32 table: K1 at f = 256
// (FL = 256), K7 (FL = 128 + f2) and, with aug, K6 at f = 256 (the value
// of each slot in lane 255, so the record's tiles hold A'). A bf16
// table takes the tensor-core pass 1 of wide_span_gram_mma.cu instead,
// on every chunk.
//
// Replaces, with pass 2, the TPU kernel `_kernel_wide` (and `_kernel` and
// `_kernel_aug` at 256 lanes) of cumf_als_tpu/ops/pallas_solve.py, reached
// through `gather_gram_cg_wide` and `gather_gram_cg`: there a row's Gram is one
// grid step; here the wrapper cuts a row's slots into `spans` spans of
// `span_len` slots (ops/cuda_solve.py, row_spans), one block each, grid
// (R, spans). Block (r, s) sums slots [s * span_len, min((s + 1) *
// span_len, nnz[r], P)) with the tile loop of gather_row and writes the
// record of wide.cuh's SpanRecord<T> at part[(r * spans + s) * SIZE]; a
// span at or past the row's slots writes nothing (pass 2 reads only
// live spans). The plans put a row's live slots first.
//
// Bound on an H100: the Gram work, the upper triangle nnz FL (FL + 8)
// FLOPs of the span, on f32 FMAs (67 TFLOP/s: a float32 table, which
// the bf16 tensor cores would round); the record (136 KB at FL = 256) is
// written once and read once. What this design does about it: it fills
// the SMs that one block a row leaves idle; the arithmetic is the uncut
// body's.

#include "wide.cuh"

namespace {

template <int T, typename TT, typename VT, bool AUG>
__global__ void __launch_bounds__(cumf::wide::Shape<T>::THREADS)
    wide_span_gram_kernel(const TT* __restrict__ table,
                          const int32_t* __restrict__ cols,
                          const VT* __restrict__ vals,
                          const int32_t* __restrict__ nnz,
                          float* __restrict__ part, int p, int span_len) {
  __shared__ cumf::wide::Smem<T> s;
  const int64_t row = blockIdx.x;
  const int64_t span = blockIdx.y;
  const int n = min(nnz[row], p);
  const int lo = (int)span * span_len;
  if (lo >= n) return;  // a dead span: the same answer for every thread
  cumf::wide::span_gram<T, TT, VT, AUG>(
      s, table, cols + row * p, vals + row * p, lo, min(lo + span_len, n),
      part + (row * gridDim.y + span) * cumf::wide::SpanRecord<T>::SIZE);
}

template <typename TT, typename VT>
int dispatch(int fl, const void* table, const void* cols, const void* vals,
             const void* nnz, void* part, int r, int p, int spans,
             int span_len, int aug, cudaStream_t stream) {
  const dim3 grid(r, spans);
#define CUMF_LAUNCH(T, AUG)                                               \
  wide_span_gram_kernel<T, TT, VT, AUG>                                   \
      <<<grid, cumf::wide::Shape<T>::THREADS, 0, stream>>>(               \
          (const TT*)table, (const int32_t*)cols, (const VT*)vals,        \
          (const int32_t*)nnz, (float*)part, p, span_len)
  if (aug) {  // K6: all 256 lanes, the value in lane 255
    if (fl != 256) return (int)cudaErrorInvalidValue;
    CUMF_LAUNCH(32, true);
    return (int)cudaGetLastError();
  }
  switch (fl) {  // T = FL / 8
    case 160: CUMF_LAUNCH(20, false); break;
    case 192: CUMF_LAUNCH(24, false); break;
    case 224: CUMF_LAUNCH(28, false); break;
    case 256: CUMF_LAUNCH(32, false); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef CUMF_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cumf_wide_span_gram(const void* table, int table_bf16,
                                   const void* cols, const void* vals,
                                   int vals_bf16, const void* nnz,
                                   void* part, int r, int p, int fl,
                                   int spans, int span_len, int aug,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (table_bf16 && vals_bf16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(
        fl, table, cols, vals, nnz, part, r, p, spans, span_len, aug, st);
  if (table_bf16)
    return dispatch<__nv_bfloat16, float>(fl, table, cols, vals, nnz, part,
                                          r, p, spans, span_len, aug, st);
  if (vals_bf16)
    return dispatch<float, __nv_bfloat16>(fl, table, cols, vals, nnz, part,
                                          r, p, spans, span_len, aug, st);
  return dispatch<float, float>(fl, table, cols, vals, nnz, part, r, p,
                                spans, span_len, aug, st);
}
