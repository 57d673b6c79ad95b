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
// Widths. E is any multiple of 8 (heads of a head dim that is a multiple
// of 8, up to 256) and F anything: the products and the cluster split run
// over E and F rounded up to 16 (ep, fp). Where either is no multiple of
// 16, the rows are staged at a pitch of ep with zeros past E, the weights
// are read in place by masked products (slimt_device.cuh: zeros past the
// true K and N, no ring), every vector is read below its true width, and
// the LayerNorms run over the true E; the projection stage takes any E up
// to 2048. That is a separate instantiation of the layers kernel
// (decoder_layers.cuh, kPadded), compiled in decoder_step_padded.cu beside
// this source; at multiples of 16 the kernel runs as before.
//
// T is bounded by shared memory alone: a row holds the scores of its
// block's heads over T (layers_smem_bytes). The entries take 1 row a
// block where the rows asked for do not fit in what a block may opt into
// (at E = 256, F = 1536, 8 heads, cs = 1 and 4 rows: T > 1560), and refuse
// T past the 1-row bound (T > 7008 there); slimt_whole_step_rows tells the
// caller which.
#include "decoder_layers.cuh"
#include "slimt_kernels.cuh"

namespace slimt {
namespace {

// Fill p from an entry's arguments: `layers` * 21 pointers and `layers` *
// 12 scales. Returns false on a shape the kernel does not take.
bool make_params(StepParams* p, const void* const* ptrs, const float* scales,
                 const void* mask, int layers, int b, int t, int e, int f,
                 int heads, int rows, int cs) {
  if (layers < 1 || layers > kMaxLayers || rows < 1 || rows > kMaxRows ||
      b < 1 || t < 1 || e < 8 || f < 1 || heads < 1 || e % heads ||
      (e / heads) % 8 || e / heads > 256 || !cluster_layout_ok(cs, pad16(e), pad16(f)))
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
  p->ep = pad16(e);
  p->fp = pad16(f);
  return true;
}

// The layers kernel over the caches of kind `cache` at the widths of p.
int launch_cache(int cache, const StepParams& p, const float* x, const float* c_in,
                 float* c_out, float* attn0, float* h_out, cudaStream_t stream) {
  if (p.e != p.ep || p.f != p.fp)
    return launch_padded_layers(cache, p, x, c_in, c_out, attn0, h_out, stream);
  return launch_layers<false>(cache, p, x, c_in, c_out, attn0, h_out, stream);
}

}  // namespace
}  // namespace slimt

extern "C" int slimt_whole_step_rows(int rows, int cs, int e, int f, int heads, int t) {
  return slimt::step_rows(rows, cs, e, f, heads, t);
}

// Clusters of cs blocks of `rows` rows the layers kernel over caches of
// kind `cache` (CacheKind) can hold on the current device at once; 0 where
// it cannot run one (the shape or cluster size refused, or no GPC fits it);
// minus the shared memory a block would need where that is more than a
// block may hold.
extern "C" int slimt_step_clusters(int rows, int cs, int e, int f, int heads, int t,
                                   int cache) {
  using namespace slimt;
  if (cache < kInt16 || cache > kSplitF16 || rows < 1 || rows > kMaxRows || e < 1 ||
      f < 1 || !cluster_layout_ok(cs, pad16(e), pad16(f)))
    return 0;
  const int slots = layers_slots(rows, cs, e, f, heads, t);
  const size_t smem = layers_smem_bytes(rows, cs, pad16(e), pad16(f), heads, t, slots);
  if (smem > smem_optin()) return -static_cast<int>(smem);
  return e % 16 || f % 16 ? padded_layers_capacity(cache, cs, smem)
                          : layers_capacity<false>(cache, cs, smem);
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
