// Whole greedy decode step: every decoder layer, the tied int8
// projection and the exact first-max argmax; and one decoder layer of it
// alone.
//
// Replaces three kernels of slimt_tpu/ops/decoder_step_pallas.py:
//   whole_decode_step (bodies _whole_kernel and _layer_math_bte), the step
//     of the fused_step latency provider;
//   decoder_layer_step_bte (body _kernel_bte, the whole step's
//     _layer_math_bte with kqi = vqi = 1): one layer over a joined
//     [B, T, E] float32, bfloat16 or float16 cache, q and p rounded to the
//     cache's type;
//   decoder_layer_step (body _kernel): one layer over a split [B, H, T, D]
//     cache of any of those types, q and p not rounded, score =
//     (sum_d K q) * scale + mask.
// Per batch row, for each layer l:
//
//   f  = sigmoid(q8(x) Wf inv + bf);  c' = f c + (1 - f) q8(x) W inv
//   h  = LN(x + relu(c'))
//   q  = q8(h) Wq inv + bq
//   p  = softmax_T((sum_d K q) * (1 / sqrt(D)) * kqi + mask)   per head
//   a  = LN(h + q8(sum_t (p vqi) V) Wo inv + bo)
//   x  = LN(a + q8(relu(q8(a) W1 inv + b1)) W2 inv + b2)
//
// then logits = q8(x) W_out inv_out + b_out over the S projection columns
// and choice = the first index of their maximum. attn0 is the head-0 p of
// the last layer. The whole step's K and V are the joined [B, T, E] int16
// per-row cache, or a joined float32, bfloat16 or float16 cache: then q and
// p are rounded to the cache's type and there are no kqi and vqi (the TPU
// kernel's float branch, decoder_step_pallas.py:445-465, multiplies by
// ones). The cache layout is the layers kernel's template argument
// (slimt_device.cuh); the per-layer entry runs that kernel with one layer
// and writes its output row y to the caller's buffer.
//
// Design. The TPU kernel walks a sequential (row tile, vocab tile) grid
// and carries the running (max, index) across vocab tiles; CUDA blocks
// run in no order, so one step is three launches from one C entry:
//   1. layers: one block per tile of 1 or 4 rows runs every layer with
//      the activations in shared memory (the FFN hidden row included);
//      K and V stream through the attention loop from device memory, one
//      instantiation of the kernel per cache type;
//   2. and 3. the exact argmax of logits_argmax.cu (launch_argmax): a
//      projection block per (vocab tile of 256 columns, 16 rows) writes
//      its tile's first maximum per row, and a pick walks the tiles in
//      ascending order with a strict >.
// The layers' device functions (slimt_device.cuh) are those of the SSRU
// and FFN blocks and the decode attention. The projection stage is
// bit-equal to its plain version given the same input rows. W_out may be
// any strided [E, S] view: the full vocabulary is the transposed [V, E]
// embedding, read 16 bytes at a time down its contiguous E axis.
//
// Bounds on the H100. At B = 1 a step reads about 2 MB of decoder
// weights (E = 256, F = 1536, two layers) and the 8.2 MB full-vocab
// projection, all of which fit in the 50 MB L2; the attention reads
// 2 * T * E bytes of cache per layer and row per byte of the cache's type
// (2 for int16, bf16 and fp16, 4 for f32). The projection spreads over 125
// blocks; the layers run on one SM per row tile, so at small B their time
// is one SM's L2 read rate and its __dp4a rate, and one persistent
// multi-block launch is the later design.
//
// T is bounded by shared memory alone: a row holds its heads' scores over
// T (layers_smem_bytes). The entries take 1 row a block where the rows
// asked for do not fit in what a block may opt into (at E = 256,
// F = 1536, 8 heads and 4 rows: T > 1448), and refuse T past the 1-row
// bound (T > 6896 there); slimt_whole_step_rows tells the caller which.

#include <cmath>
#include <cstdint>

#include "slimt_device.cuh"
#include "slimt_kernels.cuh"

namespace slimt {
namespace {

constexpr int kMaxLayers = 8;
constexpr int kLayerPtrs = 21;
constexpr int kLayerScales = 12;

// Cache kinds of the C entries: K and V of every layer are the joined int16
// per-row cache, a joined float cache, or a split [b, heads, t, d] float
// cache.
enum CacheKind {
  kInt16 = 0,
  kJoinedF32 = 1,
  kJoinedBf16 = 2,
  kJoinedF16 = 3,
  kSplitF32 = 4,
  kSplitBf16 = 5,
  kSplitF16 = 6,
};

// Per-layer pointers, in order: wf, bf, w, ln_rnn scale, ln_rnn bias,
// wq, bq, wo, bo, ln_att scale, ln_att bias, w1, b1, w2, b2,
// ln_ffn scale, ln_ffn bias, k, v, kqi, vqi (kqi and vqi null for a float
// cache). Scales: aq and inv of wf, w, wq, wo, w1, w2.
struct StepParams {
  const void* layer[kMaxLayers][kLayerPtrs];
  float scale[kMaxLayers][kLayerScales];
  const float* mask;  // [b, t] additive
  int layers, b, t, e, f, heads, rows;
  float att_scale;
};

size_t layers_smem_bytes(int rows, int e, int f, int heads, int t) {
  const size_t floats = static_cast<size_t>(rows) *
                        (4 * static_cast<size_t>(e) + f +
                         static_cast<size_t>(heads) * t);
  return sizeof(float) * floats + static_cast<size_t>(rows) * (e > f ? e : f);
}

// Rows a block takes: `rows`, or 1 where that many rows do not fit in the
// shared memory a block of the current device may opt into; 0 where one
// row does not fit.
int step_rows(int rows, int e, int f, int heads, int t) {
  int device = 0;
  int limit = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  const size_t cap = static_cast<size_t>(limit);
  if (layers_smem_bytes(rows, e, f, heads, t) <= cap) return rows;
  return layers_smem_bytes(1, e, f, heads, t) <= cap ? 1 : 0;
}

// Fill p from an entry's arguments: `layers` * 21 pointers and `layers` *
// 12 scales. Returns false on a shape the kernel does not take.
bool make_params(StepParams* p, const void* const* ptrs, const float* scales,
                 const void* mask, int layers, int b, int t, int e, int f,
                 int heads, int rows) {
  if (layers < 1 || layers > kMaxLayers || rows < 1 || rows > kMaxRows ||
      b < 1 || t < 1 || e % 256 || f % 16 || heads < 1 || e % heads ||
      (e / heads) % 8 || e / heads > 256)
    return false;
  rows = step_rows(rows, e, f, heads, t);
  if (rows == 0) return false;
  *p = {};
  for (int l = 0; l < layers; ++l) {
    for (int i = 0; i < kLayerPtrs; ++i) p->layer[l][i] = ptrs[l * kLayerPtrs + i];
    for (int i = 0; i < kLayerScales; ++i)
      p->scale[l][i] = scales[l * kLayerScales + i];
  }
  p->mask = static_cast<const float*>(mask);
  p->layers = layers;
  p->b = b;
  p->t = t;
  p->e = e;
  p->f = f;
  p->heads = heads;
  p->rows = rows;
  p->att_scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(e / heads)));
  return true;
}

// Every decoder layer for one tile of p.rows rows; C is the caches' layout
// (slimt_device.cuh). x: [b, e]; c_in, c_out: [layers, b, e]; attn0:
// [b, t], the last layer's head 0; h_out: [b, e], the last layer's output.
template <typename C>
__global__ void __launch_bounds__(kThreads)
layers_kernel(const __grid_constant__ StepParams p, const float* __restrict__ x,
              const float* __restrict__ c_in, float* __restrict__ c_out,
              float* __restrict__ attn0, float* __restrict__ h_out) {
  using Elem = typename C::Elem;
  extern __shared__ __align__(16) unsigned char smem[];
  const int e = p.e;
  const int f = p.f;
  const int cap = p.rows;
  const int row0 = blockIdx.x * cap;
  const int rows = min(cap, p.b - row0);
  const int ldq = e > f ? e : f;
  float* buf_a = reinterpret_cast<float*>(smem);
  float* buf_b = buf_a + cap * e;
  float* buf_c = buf_b + cap * e;
  float* buf_d = buf_c + cap * e;
  float* hidden = buf_d + cap * e;
  float* sc = hidden + cap * f;
  int8_t* xq = reinterpret_cast<int8_t*>(sc + cap * p.heads * p.t);
  const long long layer_stride = static_cast<long long>(p.b) * e;
  const long long tile0 = static_cast<long long>(row0) * e;

  for (int i = threadIdx.x; i < rows * e; i += kThreads) buf_a[i] = x[tile0 + i];
  __syncthreads();
  for (int l = 0; l < p.layers; ++l) {
    const void* const* w = p.layer[l];
    const float* s = p.scale[l];
    auto i8 = [&](int i) { return static_cast<const int8_t*>(w[i]); };
    auto f32 = [&](int i) { return static_cast<const float*>(w[i]); };

    // SSRU: buf_a = x; buf_c = f (pre-activation); buf_d = W x.
    quantize_rows(buf_a, e, e, s[0], xq, ldq, rows);
    matvec(xq, ldq, rows, i8(0), e, e, s[1], f32(1), false, buf_c, e);
    quantize_rows(buf_a, e, e, s[2], xq, ldq, rows);
    matvec(xq, ldq, rows, i8(2), e, e, s[3], nullptr, false, buf_d, e);
    const float* c_prev = c_in + l * layer_stride + tile0;
    float* c_next = c_out + l * layer_stride + tile0;
    for (int i = threadIdx.x; i < rows * e; i += kThreads) {
      const float gate = 1.0f / (1.0f + expf(-buf_c[i]));
      const float c_t = __fadd_rn(__fmul_rn(gate, c_prev[i]),
                                  __fmul_rn(1.0f - gate, buf_d[i]));
      c_next[i] = c_t;
      buf_d[i] = fmaxf(c_t, 0.0f);
    }
    __syncthreads();
    add_layer_norm(buf_a, buf_d, f32(3), f32(4), buf_b, rows, e);  // h

    // Cross-attention: buf_c = q, buf_d = attention output.
    quantize_rows(buf_b, e, e, s[4], xq, ldq, rows);
    matvec(xq, ldq, rows, i8(5), e, e, s[5], f32(6), false, buf_c, e);
    const C cache = {static_cast<const Elem*>(w[17]), static_cast<const Elem*>(w[18]),
                     f32(19), f32(20), p.t, e, e / p.heads};
    attention(buf_c, cache, p.mask, row0, rows, p.heads, p.att_scale, sc, buf_d,
              l == p.layers - 1 ? attn0 : nullptr);
    quantize_rows(buf_d, e, e, s[6], xq, ldq, rows);
    matvec(xq, ldq, rows, i8(7), e, e, s[7], f32(8), false, buf_c, e);
    add_layer_norm(buf_b, buf_c, f32(9), f32(10), buf_a, rows, e);  // a

    // FFN: buf_a = LN(a + W2 relu(W1 a)).
    quantize_rows(buf_a, e, e, s[8], xq, ldq, rows);
    matvec(xq, ldq, rows, i8(11), e, f, s[9], f32(12), true, hidden, f);
    quantize_rows(hidden, f, f, s[10], xq, ldq, rows);
    matvec(xq, ldq, rows, i8(13), f, e, s[11], f32(14), false, buf_c, e);
    add_layer_norm(buf_c, buf_a, f32(15), f32(16), buf_a, rows, e);
  }
  for (int i = threadIdx.x; i < rows * e; i += kThreads) h_out[tile0 + i] = buf_a[i];
}

template <typename C>
int launch_layers(const StepParams& p, const float* x, const float* c_in,
                  float* c_out, float* attn0, float* h_out, cudaStream_t stream) {
  const size_t smem = layers_smem_bytes(p.rows, p.e, p.f, p.heads, p.t);
  static size_t smem_cap = 48 * 1024;  // one per instantiation, as the attribute
  const cudaError_t err = ensure_smem(layers_kernel<C>, smem, &smem_cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  layers_kernel<C><<<(p.b + p.rows - 1) / p.rows, kThreads, smem, stream>>>(
      p, x, c_in, c_out, attn0, h_out);
  return static_cast<int>(cudaGetLastError());
}

// The layers kernel over the caches of kind `cache`; cudaErrorInvalidValue
// for a kind it does not take.
int launch_cache(int cache, const StepParams& p, const float* x, const float* c_in,
                 float* c_out, float* attn0, float* h_out, cudaStream_t stream) {
  switch (cache) {
    case kInt16:
      return launch_layers<JoinedInt16>(p, x, c_in, c_out, attn0, h_out, stream);
    case kJoinedF32:
      return launch_layers<JoinedFloat<float>>(p, x, c_in, c_out, attn0, h_out, stream);
    case kJoinedBf16:
      return launch_layers<JoinedFloat<__nv_bfloat16>>(p, x, c_in, c_out, attn0, h_out,
                                                       stream);
    case kJoinedF16:
      return launch_layers<JoinedFloat<__half>>(p, x, c_in, c_out, attn0, h_out, stream);
    case kSplitF32:
      return launch_layers<SplitFloat<float>>(p, x, c_in, c_out, attn0, h_out, stream);
    case kSplitBf16:
      return launch_layers<SplitFloat<__nv_bfloat16>>(p, x, c_in, c_out, attn0, h_out,
                                                      stream);
    case kSplitF16:
      return launch_layers<SplitFloat<__half>>(p, x, c_in, c_out, attn0, h_out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace slimt

extern "C" int slimt_whole_step_rows(int rows, int e, int f, int heads, int t) {
  return slimt::step_rows(rows, e, f, heads, t);
}

// rows: the rows a block should take (see slimt_whole_step_rows); cache:
//         kInt16, kJoinedF32, kJoinedBf16 or kJoinedF16 (CacheKind).
// ptrs:   layers * 21 per-layer pointers (order of StepParams), then
//         W_out, b_out and the [b, t] mask (device pointers);
// scales: aq and inv of wf, w, wq, wo, w1, w2 per layer, then aq_out and
//         inv_out (host floats);
// x [b, e], c_in and c_out [layers, b, e], attn0 [b, t] f32, choice [b]
// s32; scratch: b * e + 2 * b * ceil(s / 256) floats of device memory.
extern "C" int slimt_whole_decode_step(
    const void* ptrs_, const void* scales_, int layers, int b, int t, int e,
    int f, int heads, int s, long long sk, long long sn, int rows, int cache,
    const void* x_, const void* c_in_, void* c_out_, void* attn0_, void* choice,
    void* scratch, void* stream_) {
  using namespace slimt;
  const void* const* ptrs = static_cast<const void* const*>(ptrs_);
  const float* scales = static_cast<const float*>(scales_);
  const void* const* tail = ptrs + static_cast<long long>(layers) * kLayerPtrs;
  StepParams p;
  if (cache > kJoinedF16 || layers < 1 || layers > kMaxLayers ||
      !make_params(&p, ptrs, scales, tail[2], layers, b, t, e, f, heads, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  float* h = static_cast<float*>(scratch);
  const int rc = launch_cache(cache, p, static_cast<const float*>(x_),
                              static_cast<const float*>(c_in_), static_cast<float*>(c_out_),
                              static_cast<float*>(attn0_), h, stream);
  if (rc) return rc;
  const float* out_scales = scales + layers * kLayerScales;
  return launch_argmax(h, static_cast<const int8_t*>(tail[0]),
                       static_cast<const float*>(tail[1]),
                       static_cast<int*>(choice),
                       h + static_cast<long long>(b) * e, b, e, s, sk, sn,
                       out_scales[0], out_scales[1], kArgmaxExact, stream);
}

// One layer (decoder_layer_step_bte, decoder_layer_step). ptrs: 21 layer
// pointers (order of StepParams; kqi and vqi null), then the [b, t] mask;
// scales: aq and inv of wf, w, wq, wo, w1, w2; cache: kJoinedF32,
// kJoinedBf16, kJoinedF16 ([b, t, e] K and V) or kSplitF32, kSplitBf16,
// kSplitF16 ([b, heads, t, d]); rows: as for the whole step. x, c_in,
// c_out, y [b, e] and attn0 [b, t] f32, contiguous, 16-byte aligned device
// pointers.
//
// Bounds on the H100. A call reads the layer's weights once (about 1 MB at
// E = 256, F = 1536) and K and V once: 2 * B * T * E elements of the cache's
// type (4 MB in f32 at B = 64, T = 64). One SM runs each tile of 1 or 4
// rows, so at small B the time is one SM's read and __dp4a rate, as for the
// whole step.
extern "C" int slimt_decoder_layer_step(
    const void* ptrs_, const void* scales_, int b, int t, int e, int f,
    int heads, int rows, int cache, const void* x_, const void* c_in_,
    void* c_out_, void* attn0_, void* y_, void* stream_) {
  using namespace slimt;
  const void* const* ptrs = static_cast<const void* const*>(ptrs_);
  StepParams p;
  if (cache == kInt16 ||
      !make_params(&p, ptrs, static_cast<const float*>(scales_), ptrs[kLayerPtrs],
                   1, b, t, e, f, heads, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_cache(cache, p, static_cast<const float*>(x_),
                      static_cast<const float*>(c_in_), static_cast<float*>(c_out_),
                      static_cast<float*>(attn0_), static_cast<float*>(y_),
                      static_cast<cudaStream_t>(stream_));
}
