// The whole decode step's layers kernel (decoder_step.cu holds its design
// note and C entries), shared by two sources that nvcc compiles in
// parallel: decoder_step.cu instantiates it for widths that are
// multiples of 16 (kPadded = false: no masks), decoder_step_padded.cu for
// any other width (kPadded: rows at a pitch of E rounded up to 16, masked
// products, every vector read below its true width).
#pragma once

#include <cmath>
#include <cstdint>

#include "slimt_device.cuh"

namespace slimt {

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
  int ep, fp;  // e and f rounded up to 16: the products' widths
};

namespace {

// Shared memory of a block of the layers kernel: the weight ring's `slots`
// buffers of e x f/cs bytes (the largest slice), rows x (4 rows of e, the
// gate of the block's e/cs columns, its heads' scores over t or the FFN's
// int32 partials) floats, the cross-warp sums of the products (reduce_ints),
// and two rows of quantized inputs. e and f: the padded widths.
size_t layers_smem_bytes(int rows, int cs, int e, int f, int heads, int t, int slots = 0) {
  const size_t nh = static_cast<size_t>((heads + cs - 1) / cs);
  const size_t scores = nh * static_cast<size_t>(t);
  const size_t floats =
      static_cast<size_t>(rows) * (4 * static_cast<size_t>(e) + e / cs +
                                   (scores > static_cast<size_t>(e) ? scores : e));
  const size_t ints = reduce_ints(cs, e, f);
  const size_t ldq = static_cast<size_t>(f / cs > e ? f / cs : e);
  return static_cast<size_t>(slots) * e * (f / cs) + sizeof(float) * (floats + ints) +
         2 * static_cast<size_t>(rows) * ldq;
}

// The weight ring's buffers beside `rows` rows a tile (ring_slots); none
// where a true width is no multiple of 16 (masked weights are read in
// place). e and f: the true widths.
int layers_slots(int rows, int cs, int e, int f, int heads, int t) {
  if (e % 16 || f % 16) return 0;
  return ring_slots(static_cast<size_t>(e) * (f / cs),
                    layers_smem_bytes(rows, cs, e, f, heads, t), smem_optin());
}

// Rows a block takes: `rows`, or 1 where that many rows do not fit in the
// shared memory a block of the current device may opt into; 0 where one
// row does not fit. e and f: the true widths.
int step_rows(int rows, int cs, int e, int f, int heads, int t) {
  const size_t cap = smem_optin();
  e = pad16(e);
  f = pad16(f);
  if (layers_smem_bytes(rows, cs, e, f, heads, t) <= cap) return rows;
  return layers_smem_bytes(1, cs, e, f, heads, t) <= cap ? 1 : 0;
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
template <typename C, bool kPadded>
__global__ void __launch_bounds__(kThreads)
layers_kernel(const __grid_constant__ StepParams p, const float* __restrict__ x,
              const float* __restrict__ c_in, float* __restrict__ c_out,
              float* __restrict__ attn0, float* __restrict__ h_out) {
  using Elem = typename C::Elem;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = p.cs;
  const int rank = static_cast<int>(cluster.block_rank());
  const int e = p.e;    // the true widths
  const int f = p.f;
  const int ep = p.ep;  // the products' widths, ep the rows' pitch (e, f unless kPadded)
  const int es = ep / cs;    // this block's columns of the E x E products
  const int fs = p.fp / cs;  // and hidden units
  const int n0 = rank * es;
  const int k0 = rank * fs;
  const int d = e / p.heads;
  const int cap = p.rows;
  const int row0 = blockIdx.x / cs * cap;
  const int rows = min(cap, p.b - row0);
  const int ldq = ep > fs ? ep : fs;
  const int scores = (p.heads + cs - 1) / cs * p.t;
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  float* buf_a = reinterpret_cast<float*>(ring + p.slots * ep * fs);  // x, then a
  float* buf_b = buf_a + cap * ep;                // h
  float* xa = buf_b + cap * ep;
  float* xb = xa + cap * ep;
  float* gate = xb + cap * ep;                    // f of columns n0..
  float* sc = gate + cap * es;                    // scores; FFN partials
  int* red = reinterpret_cast<int*>(sc + cap * (scores > ep ? scores : ep));
  int8_t* xq = reinterpret_cast<int8_t*>(red + reduce_ints(cs, ep, p.fp));
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
                      p.scale[l][9], p.scale[l][10], p.scale[l][11], e, f - k0};
  };
  // The six slices of a layer in the order the products take them: Wf, W,
  // Wq and Wo (columns n0..), W1 (columns k0..) and W2 (rows k0..).
  auto slice_of = [&](int i) -> Slice {
    const int l = i / 6;
    switch (i % 6) {
      case 0: return {i8(l, 0) + n0, ep, es, e, e, e - n0};
      case 1: return {i8(l, 2) + n0, ep, es, e, e, e - n0};
      case 2: return {i8(l, 5) + n0, ep, es, e, e, e - n0};
      case 3: return {i8(l, 7) + n0, ep, es, e, e, e - n0};
      case 4: return {i8(l, 11) + k0, ep, fs, f, e, f - k0};
      default: return {i8(l, 13) + static_cast<long long>(k0) * e, fs, ep, e, f - k0, e};
    }
  };
  const auto weights = weight_stream(slice_of, 6 * p.layers, ring, p.slots, ep * fs);
  // An E x E product's value at column n0 + n (0 past E).
  auto column = [&](int n, int acc, float inv, const float* bias) {
    return !kPadded || n0 + n < e ? affine_value(acc, inv, bias + n0, n, false) : 0.0f;
  };

  cluster_arrive();  // the first push_cols waits for every block to start
  weights.start();
  if constexpr (!kPadded) {
    for (int i = threadIdx.x; i < rows * e; i += kThreads) buf_a[i] = x[tile0 + i];
  } else {
    for (int i = threadIdx.x; i < rows * ep; i += kThreads) {
      const int c = i % ep;
      buf_a[i] = c < e ? x[tile0 + i / ep * e + c] : 0.0f;
    }
  }
  __syncthreads();
  quantize_rows(buf_a, ep, e, p.scale[0][0], xq, ldq, rows, p.scale[0][2], xq2);
  for (int l = 0; l < p.layers; ++l) {
    const float* s = p.scale[l];

    // SSRU on columns n0..n0+es: xa = relu(c'), pushed.
    slice_product<kPadded>(xq, ldq, rows, weights.take(6 * l), ep, es, red, [&](int r, int n, int acc) {
      gate[r * es + n] = column(n, acc, s[1], f32(l, 1));
    });
    const float* c_prev = c_in + l * layer_stride + tile0;
    float* c_next = c_out + l * layer_stride + tile0;
    slice_product<kPadded>(xq2, ldq, rows, weights.take(6 * l + 1), ep, es, red,
                  [&](int r, int n, int acc) {
      const int c = n0 + n;
      float relu = 0.0f;  // past E
      if (!kPadded || c < e) {
        const float wx = affine_value(acc, s[3], nullptr, n, false);
        const float g = 1.0f / (1.0f + expf(-gate[r * es + n]));
        const float c_t = __fadd_rn(__fmul_rn(g, c_prev[r * e + c]), __fmul_rn(1.0f - g, wx));
        c_next[r * e + c] = c_t;
        relu = fmaxf(c_t, 0.0f);
      }
      xa[r * ep + c] = relu;
    });
    if (l == 0) cluster_wait();
    push_cols(xa, ep, rows, n0, es);
    cluster.sync();
    add_layer_norm(buf_a, xa, f32(l, 3), f32(l, 4), buf_b, rows, e, ldq, s[4], xq, 0.0f,
                   nullptr, ep);  // h

    // q on columns n0..: xb, pushed.
    slice_product<kPadded>(xq, ldq, rows, weights.take(6 * l + 2), ep, es, red,
                  [&](int r, int n, int acc) {
      xb[r * ep + n0 + n] = column(n, acc, s[5], f32(l, 6));
    });
    push_cols(xb, ep, rows, n0, es);
    cluster.sync();

    // Cross-attention of heads rank, rank + cs, ...: xa, pushed.
    attention(xb, cache(l), p.mask, row0, rows, p.heads, p.att_scale, sc, xa,
              l == p.layers - 1 ? attn0 : nullptr, rank, cs, ep);
    for (int h = rank; h < p.heads; h += cs) push_cols(xa, ep, rows, h * d, d);
    cluster.sync();

    // Wo on columns n0..: xb, pushed; then a = LN(h + xb).
    quantize_rows(xa, ep, e, s[6], xq, ldq, rows);
    slice_product<kPadded>(xq, ldq, rows, weights.take(6 * l + 3), ep, es, red,
                  [&](int r, int n, int acc) {
      xb[r * ep + n0 + n] = column(n, acc, s[7], f32(l, 8));
    });
    push_cols(xb, ep, rows, n0, es);
    cluster.sync();
    add_layer_norm(buf_b, xb, f32(l, 9), f32(l, 10), buf_a, rows, e, ldq, s[8], xq, 0.0f,
                   nullptr, ep);  // a

    // FFN: buf_a = LN(a + W2 relu(W1 a)), its partials in sc; quantized for
    // the next layer's SSRU.
    const bool next = l + 1 < p.layers;
    cluster_ffn<kPadded>(ffn(l), [&](int m) { return weights.take(6 * l + 4 + m); }, buf_a, xb,
                buf_a, reinterpret_cast<int*>(sc), red, xq, xq2, ldq, rows, ep, p.fp,
                next ? p.scale[l + 1][0] : 0.0f, next ? xq : nullptr,
                next ? p.scale[l + 1][2] : 0.0f, next ? xq2 : nullptr);
  }
  for (int i = threadIdx.x; i < rows * es; i += kThreads) {
    const int c = n0 + i % es;
    if (!kPadded || c < e) h_out[tile0 + i / es * e + c] = buf_a[i / es * ep + c];
  }
  cluster.sync();  // the other blocks read this block's partials until here
}

using LayersKernel = void (*)(StepParams, const float*, const float*, float*, float*,
                              float*);

// The layers kernel over the caches of kind `cache` (null for a kind it
// does not take) and its launch attributes.
template <bool kPadded>
LayersKernel layers_for(int cache, KernelAttrs** attrs) {
  static KernelAttrs kinds[kSplitF16 + 1];
  if (cache < kInt16 || cache > kSplitF16) return nullptr;
  *attrs = &kinds[cache];
  switch (cache) {
    case kInt16: return layers_kernel<JoinedInt16, kPadded>;
    case kJoinedF32: return layers_kernel<JoinedFloat<float>, kPadded>;
    case kJoinedBf16: return layers_kernel<JoinedFloat<__nv_bfloat16>, kPadded>;
    case kJoinedF16: return layers_kernel<JoinedFloat<__half>, kPadded>;
    case kSplitF32: return layers_kernel<SplitFloat<float>, kPadded>;
    case kSplitBf16: return layers_kernel<SplitFloat<__nv_bfloat16>, kPadded>;
    default: return layers_kernel<SplitFloat<__half>, kPadded>;
  }
}

// The layers kernel over the caches of kind `cache`; cudaErrorInvalidValue
// for a kind it does not take.
template <bool kPadded>
int launch_layers(int cache, const StepParams& p, const float* x, const float* c_in,
                  float* c_out, float* attn0, float* h_out, cudaStream_t stream) {
  KernelAttrs* attrs = nullptr;
  const LayersKernel kernel = layers_for<kPadded>(cache, &attrs);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = layers_smem_bytes(p.rows, p.cs, p.ep, p.fp, p.heads, p.t, p.slots);
  const int blocks = (p.b + p.rows - 1) / p.rows * p.cs;
  return launch_cluster(kernel, blocks, p.cs, smem, attrs, stream, p, x, c_in, c_out,
                        attn0, h_out);
}

// Clusters of cs blocks with `smem` bytes each the layers kernel over
// caches of kind `cache` holds on the current device at once (0: none).
template <bool kPadded>
int layers_capacity(int cache, int cs, size_t smem) {
  KernelAttrs* attrs = nullptr;
  const LayersKernel kernel = layers_for<kPadded>(cache, &attrs);
  return kernel == nullptr ? 0 : cluster_capacity(kernel, cs, smem, attrs);
}

}  // namespace

// decoder_step_padded.cu: launch_layers and layers_capacity for padded
// widths.
int launch_padded_layers(int cache, const StepParams& p, const float* x, const float* c_in,
                         float* c_out, float* attn0, float* h_out, cudaStream_t stream);
int padded_layers_capacity(int cache, int cs, size_t smem);

}  // namespace slimt
