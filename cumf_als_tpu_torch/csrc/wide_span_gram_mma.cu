// Pass 1 of the row cut of the 256-lane body on the tensor cores: the
// Gram of one span of one row's slots, written to scratch in the record
// of wide.cuh (SpanRecord<T>), for a bf16 table. With wide_span_solve.cu
// it is how K1 at f = 256 (FL = 256), K7 (FL = 128 + f2) and K6 at
// f = 256 (source kSpansAug: the value of each slot over lane 255, the
// record's tiles holding A') run on such a table, on every chunk, in the
// spans of ops/cuda_solve.py `span_plan`:
// one span a row where the chunk has as many rows as the card has SMs
// and its rows fit 32 tiles, more below that (a span's f32 sums stay in
// one fragment, whose error grows with the number of 16-slot steps).
//
// Replaces, with pass 2, the TPU kernel `_kernel_wide` (and `_kernel` and
// `_kernel_aug` at 256 lanes) of cumf_als_tpu/ops/pallas_solve.py,
// reached through `gather_gram_cg_wide` and `gather_gram_cg`, and
// `_kernel_cat`, reached through `fused_gram_cg_cat` (K8, see
// fused_gram_cg_cat.cu).
//
// The kernel, its sources (the gather, or K8's packed G), its design and
// its bound: wide_gram_mma.cuh, which the panel Grams at f = 256 (K2,
// K5a) share.

#include "wide_gram_mma.cuh"

namespace {

namespace wm = cumf::wide_mma;

template <int T, typename VT, wm::Src S>
int launch(const void* table, const void* g2, const void* cols,
           const void* vals, const void* nnz, void* part, int r, int p,
           int spans, int span_len, int f2, cudaStream_t stream) {
  return wm::launch<T, VT, S, float>(table, g2, cols, vals, nnz, part,
                                     nullptr, nullptr, r, p, spans, span_len,
                                     f2, stream);
}

template <typename VT>
int dispatch(int fl, const void* table, const void* g2, const void* cols,
             const void* vals, const void* nnz, void* part, int r, int p,
             int spans, int span_len, int f2, int aug, cudaStream_t stream) {
  if (aug) {  // K6: the gather over all 256 lanes, the value in lane 255
    if (fl != 256 || g2 != nullptr) return (int)cudaErrorInvalidValue;
    return launch<32, VT, wm::Src::kSpansAug>(table, g2, cols, vals, nnz,
                                              part, r, p, spans, span_len,
                                              f2, stream);
  }
  if (g2 != nullptr) {  // the packed G of K8: 256 lanes, f2 in 32..128
    if (fl != 256 || f2 < 32 || f2 > 128 || f2 % 32)
      return (int)cudaErrorInvalidValue;
    return launch<32, VT, wm::Src::kPacked>(table, g2, cols, vals, nnz, part,
                                            r, p, spans, span_len, f2,
                                            stream);
  }
#define CUMF_SPANS(T)                                                     \
  return launch<T, VT, wm::Src::kSpans>(table, g2, cols, vals, nnz, part, \
                                        r, p, spans, span_len, f2, stream)
  switch (fl) {  // T = FL / 8
    case 160: CUMF_SPANS(20);
    case 192: CUMF_SPANS(24);
    case 224: CUMF_SPANS(28);
    case 256: CUMF_SPANS(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CUMF_SPANS
}

}  // namespace

// The gather (g2 null): table (n + 1, 256) bf16, rows on 16-byte
// boundaries, cols and nnz as K1 takes them. The packed G of K8 (g2 not
// null): table is g1 (R, P, 128), g2 (R, P, f2) bf16, both on 16-byte
// boundaries, f2 a multiple of 32, fl 256; cols and nnz are not read.
// span_len a multiple of 64 (mma::kSlots). aug (the gather only, fl 256):
// K6's records, A' with the values in lane 255.
extern "C" int cumf_wide_span_gram_mma(const void* table, const void* g2,
                                       const void* cols, const void* vals,
                                       int vals_bf16, const void* nnz,
                                       void* part, int r, int p, int fl,
                                       int f2, int spans, int span_len,
                                       int aug, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (vals_bf16)
    return dispatch<__nv_bfloat16>(fl, table, g2, cols, vals, nnz, part, r,
                                   p, spans, span_len, f2, aug, st);
  return dispatch<float>(fl, table, g2, cols, vals, nnz, part, r, p, spans,
                         span_len, f2, aug, st);
}
