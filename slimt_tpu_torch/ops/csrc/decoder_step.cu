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
//   1. layers: a tile of 1 or 4 rows runs every layer on a thread-block
//      cluster of cs blocks (cs in 1, 2, 4, 8, 16; slimt_device.cuh, "A
//      row tile spread over a thread-block cluster"), one instantiation
//      per cache type, cs and the rows runtime values;
//   2. and 3. the exact argmax of logits_argmax.cu (launch_argmax): a
//      projection block per (vocab tile of 128 columns, 16-64 rows; at
//      large B several tiles a block) runs int8 tensor-core tiles and
//      writes its best 64-bit key per row (the logit's order-preserving
//      bits above the reversed column), and a pick takes each row's
//      largest key, a warp per row: the first maximum, whatever the order
//      of the tiles.
// The projection stage is bit-equal to its plain version given the same
// input rows. W_out may be any strided [E, S] view: the full vocabulary is
// the transposed [V, E] embedding (a shortlist its gathered rows), whose
// columns are E contiguous bytes, the tensor cores' "col" operand.
//
// The layers on a cluster. Until this design a row tile ran on one block,
// so at B = 1 one SM of 132 walked the whole chain: about 20 phases a
// layer, each product a loop of strided L2 loads by at most 256 threads
// (~127 us a step on the H100, about 16 GB/s of weights, against a bound
// of ~3 us for the whole step). Now block i of the cluster computes 1/cs
// of every product: columns [i E/cs, (i+1) E/cs) of the SSRU's Wf and W,
// of Wq and of Wo (each then pushed into every block's copy of the row
// through distributed shared memory), the heads i, i + cs, ... of the
// attention (half the blocks idle there at cs = 16 and 8 heads; head 0's
// block writes attn0), and the FFN's hidden units [i F/cs, (i+1) F/cs)
// with their share of FFN2 as int32 partials summed by every block
// (cluster_ffn). Five cluster.sync() a layer close the phases; LayerNorm
// and the SSRU gate run in every block on whole rows. Every int32 sum is
// exact and every float sum keeps its order, so the output does not
// depend on cs. Where they fit in shared memory, a block's six weight
// slices a layer stream through a ring of 2-3 buffers by cp.async, laid
// out so that the lanes splitting a column group's k read neighbouring 16
// bytes (strided reads, with their L1 wavefronts or bank conflicts, were
// what bounded a product). The wrapper asks for the largest cs that
// splits the widths (16 at tiny and base widths) and halves it until the
// card holds one cluster a row tile at once (slimt_step_clusters): one
// block a tile once the 4-row tiles fill the card (B > 264 on the H100).
//
// Bounds on the H100. At B = 1 a step reads about 2 MB of decoder
// weights (E = 256, F = 1536, two layers) and the 8.2 MB full-vocab
// projection, all of which fit in the 50 MB L2; the attention reads
// 2 * T * E bytes of cache per layer and row per byte of the cache's type
// (2 for int16, bf16 and fp16, 4 for f32). A block of a 16-block cluster
// reads 1/16 of the weights, so the step's time is the latency of its
// ~25 phases a layer (barriers, shuffles, DSMEM exchanges), not bytes.
//
// T is bounded by shared memory alone: a row holds the scores of its
// block's heads over T (layers_smem_bytes). The entries take 1 row a
// block where the rows asked for do not fit in what a block may opt into
// (at E = 256, F = 1536, 8 heads, cs = 1 and 4 rows: T > 1560), and refuse
// T past the 1-row bound (T > 7008 there); slimt_whole_step_rows tells the
// caller which.

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
  int layers, b, t, e, f, heads, rows, cs, slots;
  float att_scale;
};

// Shared memory of a block of the layers kernel: the weight ring's `slots`
// buffers of e x f/cs bytes (the largest slice), rows x (4 rows of e, the
// gate of the block's e/cs columns, its heads' scores over t or the FFN's
// int32 partials) floats, the cross-warp sums of the products (cs > 1),
// and two rows of quantized inputs.
size_t layers_smem_bytes(int rows, int cs, int e, int f, int heads, int t, int slots = 0) {
  const size_t nh = static_cast<size_t>((heads + cs - 1) / cs);
  const size_t scores = nh * static_cast<size_t>(t);
  const size_t floats =
      static_cast<size_t>(rows) * (4 * static_cast<size_t>(e) + e / cs +
                                   (scores > static_cast<size_t>(e) ? scores : e));
  const size_t ints = cs > 1 ? kReduceInts : 0;
  const size_t ldq = static_cast<size_t>(f / cs > e ? f / cs : e);
  return static_cast<size_t>(slots) * e * (f / cs) + sizeof(float) * (floats + ints) +
         2 * static_cast<size_t>(rows) * ldq;
}

// The weight ring's buffers beside `rows` rows a tile (ring_slots).
int layers_slots(int rows, int cs, int e, int f, int heads, int t) {
  return ring_slots(static_cast<size_t>(e) * (f / cs),
                    layers_smem_bytes(rows, cs, e, f, heads, t), smem_optin());
}

// Rows a block takes: `rows`, or 1 where that many rows do not fit in the
// shared memory a block of the current device may opt into; 0 where one
// row does not fit.
int step_rows(int rows, int cs, int e, int f, int heads, int t) {
  const size_t cap = smem_optin();
  if (layers_smem_bytes(rows, cs, e, f, heads, t) <= cap) return rows;
  return layers_smem_bytes(1, cs, e, f, heads, t) <= cap ? 1 : 0;
}

// Fill p from an entry's arguments: `layers` * 21 pointers and `layers` *
// 12 scales. Returns false on a shape the kernel does not take.
bool make_params(StepParams* p, const void* const* ptrs, const float* scales,
                 const void* mask, int layers, int b, int t, int e, int f,
                 int heads, int rows, int cs) {
  if (layers < 1 || layers > kMaxLayers || rows < 1 || rows > kMaxRows ||
      b < 1 || t < 1 || e % 256 || f % 16 || heads < 1 || e % heads ||
      (e / heads) % 8 || e / heads > 256 || !cluster_layout_ok(cs, e, f))
    return false;
  rows = step_rows(rows, cs, e, f, heads, t);
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
  p->cs = cs;
  p->slots = layers_slots(rows, cs, e, f, heads, t);
  p->att_scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(e / heads)));
  return true;
}

// Every decoder layer for one tile of p.rows rows on a cluster of p.cs
// blocks; C is the caches' layout (slimt_device.cuh). x: [b, e]; c_in,
// c_out: [layers, b, e]; attn0: [b, t], the last layer's head 0; h_out:
// [b, e], the last layer's output. Each phase reads rows that the last
// cluster.sync() completed and pushes its columns into a row buffer that
// no block reads in that phase: xa and xb alternate. The first push waits
// at a cluster barrier that every block arrived at on starting. Each LayerNorm also
// quantizes its output for the products that read it, and the products'
// weight slices stream through a ring in shared memory (WeightStream).
template <typename C>
__global__ void __launch_bounds__(kThreads)
layers_kernel(const __grid_constant__ StepParams p, const float* __restrict__ x,
              const float* __restrict__ c_in, float* __restrict__ c_out,
              float* __restrict__ attn0, float* __restrict__ h_out) {
  using Elem = typename C::Elem;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = p.cs;
  const int rank = static_cast<int>(cluster.block_rank());
  const int e = p.e;
  const int f = p.f;
  const int es = e / cs;  // this block's columns of the E x E products
  const int fs = f / cs;  // and hidden units
  const int n0 = rank * es;
  const int k0 = rank * fs;
  const int d = e / p.heads;
  const int cap = p.rows;
  const int row0 = blockIdx.x / cs * cap;
  const int rows = min(cap, p.b - row0);
  const int ldq = e > fs ? e : fs;
  const int scores = (p.heads + cs - 1) / cs * p.t;
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  float* buf_a = reinterpret_cast<float*>(ring + p.slots * e * fs);  // x, then a
  float* buf_b = buf_a + cap * e;                 // h
  float* xa = buf_b + cap * e;
  float* xb = xa + cap * e;
  float* gate = xb + cap * e;                     // f of columns n0..
  float* sc = gate + cap * es;                    // scores; FFN partials
  int* red = reinterpret_cast<int*>(sc + cap * (scores > e ? scores : e));
  int8_t* xq = reinterpret_cast<int8_t*>(red + (cs > 1 ? kReduceInts : 0));
  int8_t* xq2 = xq + cap * ldq;
  const long long layer_stride = static_cast<long long>(p.b) * e;
  const long long tile0 = static_cast<long long>(row0) * e;
  auto i8 = [&](int l, int i) { return static_cast<const int8_t*>(p.layer[l][i]); };
  auto f32 = [&](int l, int i) { return static_cast<const float*>(p.layer[l][i]); };
  auto cache = [&](int l) {
    return C{static_cast<const Elem*>(p.layer[l][17]), static_cast<const Elem*>(p.layer[l][18]),
             f32(l, 19), f32(l, 20), p.t, e, d};
  };
  auto ffn = [&](int l) {
    return FfnWeights{f32(l, 12) + k0, f32(l, 14), f32(l, 15), f32(l, 16),
                      p.scale[l][9], p.scale[l][10], p.scale[l][11]};
  };
  // The six slices of a layer in the order the products take them: Wf, W,
  // Wq and Wo (columns n0..), W1 (columns k0..) and W2 (rows k0..).
  auto slice_of = [&](int i) -> Slice {
    const int l = i / 6;
    switch (i % 6) {
      case 0: return {i8(l, 0) + n0, e, es, e};
      case 1: return {i8(l, 2) + n0, e, es, e};
      case 2: return {i8(l, 5) + n0, e, es, e};
      case 3: return {i8(l, 7) + n0, e, es, e};
      case 4: return {i8(l, 11) + k0, e, fs, f};
      default: return {i8(l, 13) + static_cast<long long>(k0) * e, fs, e, e};
    }
  };
  const auto weights = weight_stream(slice_of, 6 * p.layers, ring, p.slots, e * fs);

  cluster_arrive();  // the first push_cols waits for every block to start
  weights.start();
  for (int i = threadIdx.x; i < rows * e; i += kThreads) buf_a[i] = x[tile0 + i];
  __syncthreads();
  quantize_rows(buf_a, e, e, p.scale[0][0], xq, ldq, rows, p.scale[0][2], xq2);
  for (int l = 0; l < p.layers; ++l) {
    const float* s = p.scale[l];

    // SSRU on columns n0..n0+es: xa = relu(c'), pushed.
    slice_product(xq, ldq, rows, weights.take(6 * l), e, es, red, [&](int r, int n, int acc) {
      gate[r * es + n] = affine_value(acc, s[1], f32(l, 1) + n0, n, false);
    });
    const float* c_prev = c_in + l * layer_stride + tile0;
    float* c_next = c_out + l * layer_stride + tile0;
    slice_product(xq2, ldq, rows, weights.take(6 * l + 1), e, es, red,
                  [&](int r, int n, int acc) {
      const float wx = affine_value(acc, s[3], nullptr, n, false);
      const float g = 1.0f / (1.0f + expf(-gate[r * es + n]));
      const int at = r * e + n0 + n;
      const float c_t = __fadd_rn(__fmul_rn(g, c_prev[at]), __fmul_rn(1.0f - g, wx));
      c_next[at] = c_t;
      xa[at] = fmaxf(c_t, 0.0f);
    });
    if (l == 0) cluster_wait();
    push_cols(xa, e, rows, n0, es);
    cluster.sync();
    add_layer_norm(buf_a, xa, f32(l, 3), f32(l, 4), buf_b, rows, e, ldq, s[4], xq);  // h

    // q on columns n0..: xb, pushed.
    slice_product(xq, ldq, rows, weights.take(6 * l + 2), e, es, red,
                  [&](int r, int n, int acc) {
      xb[r * e + n0 + n] = affine_value(acc, s[5], f32(l, 6) + n0, n, false);
    });
    push_cols(xb, e, rows, n0, es);
    cluster.sync();

    // Cross-attention of heads rank, rank + cs, ...: xa, pushed.
    attention(xb, cache(l), p.mask, row0, rows, p.heads, p.att_scale, sc, xa,
              l == p.layers - 1 ? attn0 : nullptr, rank, cs);
    for (int h = rank; h < p.heads; h += cs) push_cols(xa, e, rows, h * d, d);
    cluster.sync();

    // Wo on columns n0..: xb, pushed; then a = LN(h + xb).
    quantize_rows(xa, e, e, s[6], xq, ldq, rows);
    slice_product(xq, ldq, rows, weights.take(6 * l + 3), e, es, red,
                  [&](int r, int n, int acc) {
      xb[r * e + n0 + n] = affine_value(acc, s[7], f32(l, 8) + n0, n, false);
    });
    push_cols(xb, e, rows, n0, es);
    cluster.sync();
    add_layer_norm(buf_b, xb, f32(l, 9), f32(l, 10), buf_a, rows, e, ldq, s[8], xq);  // a

    // FFN: buf_a = LN(a + W2 relu(W1 a)), its partials in sc; quantized for
    // the next layer's SSRU.
    const bool next = l + 1 < p.layers;
    cluster_ffn(ffn(l), [&](int m) { return weights.take(6 * l + 4 + m); }, buf_a, xb,
                buf_a, reinterpret_cast<int*>(sc), red, xq, xq2, ldq, rows, e, f,
                next ? p.scale[l + 1][0] : 0.0f, next ? xq : nullptr,
                next ? p.scale[l + 1][2] : 0.0f, next ? xq2 : nullptr);
  }
  for (int i = threadIdx.x; i < rows * es; i += kThreads) {
    const int at = i / es * e + n0 + i % es;
    h_out[tile0 + at] = buf_a[at];
  }
  cluster.sync();  // the other blocks read this block's partials until here
}

using LayersKernel = void (*)(StepParams, const float*, const float*, float*, float*,
                              float*);

// The layers kernel over the caches of kind `cache` (null for a kind it
// does not take) and its launch attributes.
LayersKernel layers_for(int cache, KernelAttrs** attrs) {
  static KernelAttrs kinds[kSplitF16 + 1];
  if (cache < kInt16 || cache > kSplitF16) return nullptr;
  *attrs = &kinds[cache];
  switch (cache) {
    case kInt16: return layers_kernel<JoinedInt16>;
    case kJoinedF32: return layers_kernel<JoinedFloat<float>>;
    case kJoinedBf16: return layers_kernel<JoinedFloat<__nv_bfloat16>>;
    case kJoinedF16: return layers_kernel<JoinedFloat<__half>>;
    case kSplitF32: return layers_kernel<SplitFloat<float>>;
    case kSplitBf16: return layers_kernel<SplitFloat<__nv_bfloat16>>;
    default: return layers_kernel<SplitFloat<__half>>;
  }
}

// The layers kernel over the caches of kind `cache`; cudaErrorInvalidValue
// for a kind it does not take.
int launch_cache(int cache, const StepParams& p, const float* x, const float* c_in,
                 float* c_out, float* attn0, float* h_out, cudaStream_t stream) {
  KernelAttrs* attrs = nullptr;
  const LayersKernel kernel = layers_for(cache, &attrs);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = layers_smem_bytes(p.rows, p.cs, p.e, p.f, p.heads, p.t, p.slots);
  const int blocks = (p.b + p.rows - 1) / p.rows * p.cs;
  return launch_cluster(kernel, blocks, p.cs, smem, attrs, stream, p, x, c_in, c_out,
                        attn0, h_out);
}

}  // namespace
}  // namespace slimt

extern "C" int slimt_whole_step_rows(int rows, int cs, int e, int f, int heads, int t) {
  return slimt::step_rows(rows, cs, e, f, heads, t);
}

// Clusters of cs blocks of `rows` rows the layers kernel over caches of
// kind `cache` (CacheKind) can hold on the current device at once; 0 where
// it cannot run one (the shape or cluster size refused, or no GPC fits it).
extern "C" int slimt_step_clusters(int rows, int cs, int e, int f, int heads, int t,
                                   int cache) {
  using namespace slimt;
  KernelAttrs* attrs = nullptr;
  const LayersKernel kernel = layers_for(cache, &attrs);
  if (kernel == nullptr || rows < 1 || rows > kMaxRows || !cluster_layout_ok(cs, e, f))
    return 0;
  const int slots = layers_slots(rows, cs, e, f, heads, t);
  return cluster_capacity(kernel, cs, layers_smem_bytes(rows, cs, e, f, heads, t, slots),
                          attrs);
}

// rows: the rows a block should take (see slimt_whole_step_rows); cs: the
//         blocks of a row tile's cluster (slimt_step_clusters); cache:
//         kInt16, kJoinedF32, kJoinedBf16 or kJoinedF16 (CacheKind).
// ptrs:   layers * 21 per-layer pointers (order of StepParams), then
//         W_out, b_out and the [b, t] mask (device pointers);
// scales: aq and inv of wf, w, wq, wo, w1, w2 per layer, then aq_out and
//         inv_out (host floats);
// x [b, e], c_in and c_out [layers, b, e], attn0 [b, t] f32, choice [b]
// s32; scratch: b * e + slimt_argmax_scratch(b, s) floats of device
// memory.
extern "C" int slimt_whole_decode_step(
    const void* ptrs_, const void* scales_, int layers, int b, int t, int e,
    int f, int heads, int s, long long sk, long long sn, int rows, int cs, int cache,
    const void* x_, const void* c_in_, void* c_out_, void* attn0_, void* choice,
    void* scratch, void* stream_) {
  using namespace slimt;
  const void* const* ptrs = static_cast<const void* const*>(ptrs_);
  const float* scales = static_cast<const float*>(scales_);
  const void* const* tail = ptrs + static_cast<long long>(layers) * kLayerPtrs;
  StepParams p;
  if (cache > kJoinedF16 || layers < 1 || layers > kMaxLayers ||
      !make_params(&p, ptrs, scales, tail[2], layers, b, t, e, f, heads, rows, cs))
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
// kSplitF16 ([b, heads, t, d]); rows, cs: as for the whole step. x, c_in,
// c_out, y [b, e] and attn0 [b, t] f32, contiguous, 16-byte aligned device
// pointers.
//
// Bounds on the H100. A call reads the layer's weights once (about 1 MB at
// E = 256, F = 1536) and K and V once: 2 * B * T * E elements of the cache's
// type (4 MB in f32 at B = 64, T = 64). A cluster of cs blocks runs each
// tile of 1 or 4 rows, as for the whole step.
extern "C" int slimt_decoder_layer_step(
    const void* ptrs_, const void* scales_, int b, int t, int e, int f,
    int heads, int rows, int cs, int cache, const void* x_, const void* c_in_,
    void* c_out_, void* attn0_, void* y_, void* stream_) {
  using namespace slimt;
  const void* const* ptrs = static_cast<const void* const*>(ptrs_);
  StepParams p;
  if (cache == kInt16 ||
      !make_params(&p, ptrs, static_cast<const float*>(scales_), ptrs[kLayerPtrs],
                   1, b, t, e, f, heads, rows, cs))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_cache(cache, p, static_cast<const float*>(x_),
                      static_cast<const float*>(c_in_), static_cast<float*>(c_out_),
                      static_cast<float*>(attn0_), static_cast<float*>(y_),
                      static_cast<cudaStream_t>(stream_));
}
