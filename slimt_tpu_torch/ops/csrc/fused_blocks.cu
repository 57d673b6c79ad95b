// The decoder's SSRU block and FFN block, each one launch over rows.
//
// Replaces slimt_tpu/ops/fused_blocks.py:_ssru_kernel (entry ssru_block)
// and _ffn_kernel (entry ffn_block), the blocks of the `fused` provider.
// Per row x of the flattened [M, E] activations:
//
//   ssru: f = sigmoid(q8(x) Wf inv_f + bf);  c' = f c + (1 - f) q8(x) W inv_w
//         h = LN(x + relu(c'))                     -> (h, c')
//   ffn:  u = relu(q8(x) W1 inv1 + b1)              [F]
//         y = LN((q8(u) W2 inv2 + b2) + x)
//
// LN(v) = (v - mean) / sqrt(var + 1e-6) * scale + bias.
//
// Design. The TPU kernel tiles 128 rows and holds the whole weights in
// VMEM. Here both blocks run a tile of 1 row (M <= 64, to spread a decode
// batch over the SMs) or 4 rows (larger M, to read the weights once per 4
// rows) on a thread-block cluster of cs blocks (slimt_device.cuh, "A row
// tile spread over a thread-block cluster"), with the device functions of
// slimt_device.cuh: __dp4a products (slice_product) and a warp per row for
// LayerNorm.
//
// The SSRU block: block i quantizes x once by both scales, computes the
// columns [i E/cs, (i+1) E/cs) of Wf and of W, applies the gate and the
// cell there and writes those columns of c'; relu(c') meets in every
// block through distributed shared memory after one cluster.sync(), and
// every block runs the LayerNorm on whole rows and writes its E/cs columns
// of h. Its weights are read in place and its vectors copied in at the
// start.
//
// The FFN block: block i computes the hidden units [i F/cs, (i+1) F/cs)
// from its columns of W1 and their share of FFN2 from the same rows of W2
// (cluster_ffn), and the int32 partials meet through distributed shared
// memory after one cluster.sync(); every block then sums them, runs the
// epilogue and the LayerNorm on whole rows and writes its E/cs output
// columns. Where they fit, its two weight slices are copied into shared
// memory by cp.async (WeightStream: W2's copied while W1's product runs).
// It replaces one block a tile, where at B = 1 one SM walked
// both products alone (34 us a call on the H100, 768 KB of weights at ~23
// GB/s).
//
// The wrappers pick cs as the layers kernel's does (the largest that
// splits the widths, halved until the card holds every tile's cluster at
// once; at M = 512 fewer, larger-tiled clusters whose blocks share an SM);
// the output does not depend on cs (exact int32 sums, float sums in one
// order).
//
// Widths. E and F may be anything. The products and the cluster split run
// over the widths rounded up to 16 (ep, fp; the wrappers' cluster_layout
// splits those); where E or F is no multiple of 16 the rows are staged in
// shared memory at a pitch of ep with zeros past E, the weights are read
// in place byte by byte with zeros past the true K and N (masked Slabs: no
// 16-byte rows to copy), every vector is read only below its true width,
// and the LayerNorm runs over the true E. At multiples of 16 (ep = e, fp =
// f) the kernels carry no masks: the padded ones are separate
// instantiations (kPadded). The widest rows a tile may take are what a
// block's shared memory holds; the cluster queries return minus the
// bytes asked for past that, and the wrappers raise.
//
// Bounds on the H100. The blocks read their weights from L2 or device
// memory: 2 E^2 bytes for the SSRU (128 KB at E = 256), 2 E F for the FFN
// (768 KB at E = 256, F = 1536), once per row tile. At decode batch the
// weights stay in the 50 MB L2, and a block of a 16-block cluster reads
// 1/16 of them: the time is a few L2 round trips and the cluster
// barriers; at M = 512 each issues 512 / 4 = 128 tiles, about one wave on
// 132 SMs.

#include <cmath>
#include <cstdint>

#include "slimt_device.cuh"

namespace slimt {
namespace {

struct BlockArgs {
  const float* x;      // [m, e]
  const float* c;      // ssru: [m, e] previous cell
  const int8_t* w0;    // ssru: Wf [e, e]; ffn: W1 [e, f]
  const float* b0;     // ssru: bf; ffn: b1
  const int8_t* w1;    // ssru: W [e, e]; ffn: W2 [f, e]
  const float* b1;     // ffn: b2 (ssru: unused)
  const float* ln_scale;
  const float* ln_bias;
  float* out;          // [m, e]: h or the FFN output
  float* c_out;        // ssru: [m, e] new cell
  int m, e, f, rows, cs, slots;
  float aq0, inv0, aq1, inv1;
  int ep, fp;          // e and f rounded up to 16: the products' widths
};

// The SSRU block's shared memory, as floats x and relu(c') [rows, e], the
// gate and the previous cell of the block's e/cs columns [rows, e/cs], bf
// of those columns and the LayerNorm's scale and bias [e]; the cross-warp
// sums (reduce_ints) and the two quantized copies of x [rows, e].
// e: the padded width.
size_t ssru_smem_bytes(int rows, int cs, int e) {
  const size_t es = static_cast<size_t>(e / cs);
  return sizeof(float) * (2 * static_cast<size_t>(rows) * (e + es) + es + 2 * static_cast<size_t>(e)) +
         sizeof(int) * reduce_ints(cs, e, e) +
         2 * static_cast<size_t>(rows) * e;
}

// n floats (a multiple of 4, both ends 16-byte aligned) from device memory
// into shared memory by cp.async.
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n / 4; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i, true);
}

// A tile of a.rows rows on a cluster of a.cs blocks: block i computes
// columns [i e/cs, (i+1) e/cs) of both products from one quantization of
// x by both scales, applies the gate and the cell there, writes those
// columns of c' and pushes relu(c') into every block's copy of the rows;
// after one cluster.sync() every block runs the LayerNorm on whole rows
// and writes its columns of h. Every vector the block reads (x, its
// columns of c and bf, the LayerNorm's) is copied in by one cp.async
// group at the start; the weights are read in place (a shared-memory ring
// of the two slices read slower at every B on the H100: the block reads
// each weight once). The first push waits at a cluster barrier that every
// block arrived at on starting; no block reads another's shared memory
// after the cluster.sync() that follows it, so none waits at the end.
template <bool kPadded>
__global__ void __launch_bounds__(kThreads) ssru_kernel(const __grid_constant__ BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int e = a.e;    // the rows' true width
  const int ep = a.ep;  // their pitch in shared memory (e unless kPadded)
  const int cs = a.cs;
  const int es = ep / cs;
  const int n0 = static_cast<int>(cluster.block_rank()) * es;
  const int cap = a.rows;
  const int row0 = blockIdx.x / cs * cap;
  const int rows = min(cap, a.m - row0);
  float* xs = reinterpret_cast<float*>(smem);
  float* hs = xs + cap * ep;  // relu(c'), then h
  float* gate = hs + cap * ep;
  float* c_prev = gate + cap * es;
  float* bf = c_prev + cap * es;
  float* ln = bf + es;  // scale, then bias
  int* red = reinterpret_cast<int*>(ln + 2 * ep);
  int8_t* xq = reinterpret_cast<int8_t*>(red + reduce_ints(cs, ep, ep));
  int8_t* xq2 = xq + cap * ep;
  const long long tile0 = static_cast<long long>(row0) * e;

  cluster_arrive();  // push_cols waits for every block to start
  if constexpr (!kPadded) {
    copy_floats(xs, a.x + tile0, rows * e);
    for (int i = threadIdx.x; i < rows * es / 4; i += kThreads)
      cp_async16(c_prev + 4 * i, a.c + tile0 + 4 * i / es * e + n0 + 4 * i % es, true);
    copy_floats(bf, a.b0 + n0, es);
    copy_floats(ln, a.ln_scale, e);
    copy_floats(ln + e, a.ln_bias, e);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    // Zeros past E; every read below the true width.
    for (int i = threadIdx.x; i < rows * ep; i += kThreads) {
      const int c = i % ep;
      xs[i] = c < e ? a.x[tile0 + i / ep * e + c] : 0.0f;
    }
    for (int i = threadIdx.x; i < rows * es; i += kThreads) {
      const int c = n0 + i % es;
      c_prev[i] = c < e ? a.c[tile0 + i / es * e + c] : 0.0f;
    }
    for (int i = threadIdx.x; i < es; i += kThreads) bf[i] = n0 + i < e ? a.b0[n0 + i] : 0.0f;
    for (int i = threadIdx.x; i < e; i += kThreads) {
      ln[i] = a.ln_scale[i];
      ln[ep + i] = a.ln_bias[i];
    }
  }
  __syncthreads();
  quantize_rows(xs, ep, e, a.aq0, xq, ep, rows, a.aq1, xq2);
  // Wf's and W's columns n0.., in place.
  const Slab wf = {a.w0 + n0, 4 * e, e, 16, e, e - n0};
  const Slab w = {a.w1 + n0, 4 * e, e, 16, e, e - n0};
  slice_product<kPadded>(xq, ep, rows, wf, ep, es, red, [&](int r, int n, int acc) {
    gate[r * es + n] = affine_value(acc, a.inv0, bf, n, false);
  });
  slice_product<kPadded>(xq2, ep, rows, w, ep, es, red, [&](int r, int n, int acc) {
    const float wx = affine_value(acc, a.inv1, nullptr, n, false);
    const float f = 1.0f / (1.0f + expf(-gate[r * es + n]));
    const float c_t = __fadd_rn(__fmul_rn(f, c_prev[r * es + n]), __fmul_rn(1.0f - f, wx));
    const int c = n0 + n;
    if (!kPadded || c < e) a.c_out[tile0 + r * e + c] = c_t;
    hs[r * ep + c] = fmaxf(c_t, 0.0f);  // 0 past E
  });
  cluster_wait();
  push_cols(hs, ep, rows, n0, es);
  cluster.sync();
  add_layer_norm(xs, hs, ln, ln + ep, hs, rows, e, 0, 0.0f, nullptr, 0.0f, nullptr, ep);
  for (int i = threadIdx.x; i < rows * es; i += kThreads) {
    const int c = n0 + i % es;
    if (!kPadded || c < e) a.out[tile0 + i / es * e + c] = hs[i / es * ep + c];
  }
}

// The FFN block's shared memory: the weight ring's `slots` buffers of e x
// f/cs bytes, x and y [rows, e], the [rows, e] int32 partials, the
// cross-warp sums (reduce_ints) and two rows of quantized inputs (e and f: the
// padded widths).
size_t ffn_smem_bytes(int rows, int cs, int e, int f, int slots = 0) {
  const size_t ldq = static_cast<size_t>(f / cs > e ? f / cs : e);
  return static_cast<size_t>(slots) * e * (f / cs) +
         sizeof(float) * 3 * static_cast<size_t>(rows) * e +
         sizeof(int) * reduce_ints(cs, e, f) + 2 * static_cast<size_t>(rows) * ldq;
}

// The ring's buffers: 2 (W1's and W2's slices, W2's copied while W1's
// product runs) where they fit in what a block may opt into, else 0.
int ffn_slots(int rows, int cs, int e, int f) {
  return ffn_smem_bytes(rows, cs, e, f, 2) <= smem_optin() ? 2 : 0;
}

template <bool kPadded>
__global__ void __launch_bounds__(kThreads) ffn_kernel(const __grid_constant__ BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int e = a.e;  // the true widths
  const int f = a.f;
  const int ep = a.ep;  // the products' widths, the rows' pitch (e, f unless kPadded)
  const int cs = a.cs;
  const int es = ep / cs;
  const int fs = a.fp / cs;
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = rank * es;
  const int k0 = rank * fs;
  const int cap = a.rows;
  const int row0 = blockIdx.x / cs * cap;
  const int rows = min(cap, a.m - row0);
  const int ldq = ep > fs ? ep : fs;
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  float* xs = reinterpret_cast<float*>(ring + a.slots * ep * fs);
  float* ys = xs + cap * ep;
  int* part = reinterpret_cast<int*>(ys + cap * ep);
  int* red = part + cap * ep;
  int8_t* xq = reinterpret_cast<int8_t*>(red + reduce_ints(cs, ep, a.fp));
  const long long tile0 = static_cast<long long>(row0) * e;
  const FfnWeights w = {a.b0 + k0, a.b1, a.ln_scale, a.ln_bias, a.inv0, a.aq1, a.inv1,
                        e, f - k0};
  // W1's columns k0.. and W2's rows k0..
  auto slice_of = [&](int i) -> Slice {
    if (i == 0) return {a.w0 + k0, ep, fs, f, e, f - k0};
    return {a.w1 + static_cast<long long>(k0) * e, fs, ep, e, f - k0, e};
  };
  const auto weights = weight_stream(slice_of, 2, ring, a.slots, ep * fs);

  weights.start();
  if constexpr (!kPadded) {
    for (int i = threadIdx.x; i < rows * e; i += kThreads) xs[i] = a.x[tile0 + i];
  } else {
    for (int i = threadIdx.x; i < rows * ep; i += kThreads) {
      const int c = i % ep;
      xs[i] = c < e ? a.x[tile0 + i / ep * e + c] : 0.0f;
    }
  }
  __syncthreads();
  quantize_rows(xs, ep, e, a.aq0, xq, ldq, rows);
  cluster_ffn<kPadded>(w, [&](int m) { return weights.take(m); }, xs, ys, ys, part, red, xq,
                       xq + cap * ldq, ldq, rows, ep, a.fp);
  for (int i = threadIdx.x; i < rows * es; i += kThreads) {
    const int c = n0 + i % es;
    if (!kPadded || c < e) a.out[tile0 + i / es * e + c] = ys[i / es * ep + c];
  }
  cluster.sync();  // the other blocks read this block's partials until here
}

KernelAttrs ssru_attrs[2];  // [kPadded]
KernelAttrs ffn_attrs[2];

bool shapes_ok(int m, int e, int f, int rows) {
  return m >= 1 && e >= 1 && f >= 1 && rows >= 1 && rows <= kMaxRows;
}

// Clusters of cs blocks with `smem` bytes each that the device holds at
// once, or minus `smem` where that is more than a block may opt into.
template <typename Kernel>
int clusters_or_need(Kernel kernel, int cs, size_t smem, KernelAttrs* attrs) {
  if (smem > smem_optin()) return -static_cast<int>(smem);
  return cluster_capacity(kernel, cs, smem, attrs);
}

}  // namespace
}  // namespace slimt

// Clusters of cs blocks of `rows` rows the SSRU block can hold on the
// current device at once; 0 where it cannot run one; minus the shared
// memory a block would need where that is more than a block may hold.
extern "C" int slimt_ssru_clusters(int rows, int cs, int e) {
  using namespace slimt;
  if (!shapes_ok(1, e, e, rows) || !cluster_layout_ok(cs, pad16(e), pad16(e))) return 0;
  const size_t smem = ssru_smem_bytes(rows, cs, pad16(e));
  return e % 16 ? clusters_or_need(ssru_kernel<true>, cs, smem, &ssru_attrs[1])
                : clusters_or_need(ssru_kernel<false>, cs, smem, &ssru_attrs[0]);
}

// x, c, h, c_out [m, e] f32; wf, w [e, e] int8; bf, ln_scale, ln_bias
// [e] f32; all 16-byte aligned device pointers. rows: rows per tile; cs:
// the blocks of a tile's cluster (slimt_ssru_clusters), which splits e
// rounded up to 16.
extern "C" int slimt_ssru_block(const void* x, const void* c, const void* wf,
                                const void* bf, const void* w,
                                const void* ln_scale, const void* ln_bias,
                                void* h, void* c_out, int m, int e, int rows, int cs,
                                float aq_f, float inv_f, float aq_w,
                                float inv_w, void* stream) {
  using namespace slimt;
  const int ep = pad16(e);
  if (!shapes_ok(m, e, e, rows) || !cluster_layout_ok(cs, ep, ep))
    return static_cast<int>(cudaErrorInvalidValue);
  const BlockArgs a = {
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<const int8_t*>(wf), static_cast<const float*>(bf),
      static_cast<const int8_t*>(w), nullptr,
      static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
      static_cast<float*>(h), static_cast<float*>(c_out),
      m, e, e, rows, cs, 0, aq_f, inv_f, aq_w, inv_w, ep, ep};
  const int blocks = (m + rows - 1) / rows * cs;
  const size_t smem = ssru_smem_bytes(rows, cs, ep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ep != e ? launch_cluster(ssru_kernel<true>, blocks, cs, smem, &ssru_attrs[1], s, a)
                 : launch_cluster(ssru_kernel<false>, blocks, cs, smem, &ssru_attrs[0], s, a);
}

// Clusters of cs blocks of `rows` rows the FFN block can hold on the
// current device at once; 0 where it cannot run one; minus the shared
// memory a block would need where that is more than a block may hold.
extern "C" int slimt_ffn_clusters(int rows, int cs, int e, int f) {
  using namespace slimt;
  const int ep = pad16(e);
  const int fp = pad16(f);
  if (!shapes_ok(1, e, f, rows) || !cluster_layout_ok(cs, ep, fp)) return 0;
  const bool padded = e % 16 || f % 16;
  const size_t smem = ffn_smem_bytes(rows, cs, ep, fp, padded ? 0 : ffn_slots(rows, cs, ep, fp));
  return padded ? clusters_or_need(ffn_kernel<true>, cs, smem, &ffn_attrs[1])
                : clusters_or_need(ffn_kernel<false>, cs, smem, &ffn_attrs[0]);
}

// x, out [m, e] f32; w1 [e, f], w2 [f, e] int8; b1 [f], b2, ln_scale,
// ln_bias [e] f32; all 16-byte aligned device pointers. rows: rows per
// tile; cs: the blocks of a tile's cluster (slimt_ffn_clusters), which
// splits e and f rounded up to 16.
extern "C" int slimt_ffn_block(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2,
                               const void* ln_scale, const void* ln_bias,
                               void* out, int m, int e, int f, int rows, int cs,
                               float aq1, float inv1, float aq2, float inv2,
                               void* stream) {
  using namespace slimt;
  const int ep = pad16(e);
  const int fp = pad16(f);
  if (!shapes_ok(m, e, f, rows) || !cluster_layout_ok(cs, ep, fp))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool padded = e % 16 || f % 16;
  const int slots = padded ? 0 : ffn_slots(rows, cs, ep, fp);
  const BlockArgs a = {
      static_cast<const float*>(x), nullptr,
      static_cast<const int8_t*>(w1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
      static_cast<float*>(out), nullptr,
      m, e, f, rows, cs, slots, aq1, inv1, aq2, inv2, ep, fp};
  const int blocks = (m + rows - 1) / rows * cs;
  const size_t smem = ffn_smem_bytes(rows, cs, ep, fp, slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return padded ? launch_cluster(ffn_kernel<true>, blocks, cs, smem, &ffn_attrs[1], s, a)
                : launch_cluster(ffn_kernel<false>, blocks, cs, smem, &ffn_attrs[0], s, a);
}
