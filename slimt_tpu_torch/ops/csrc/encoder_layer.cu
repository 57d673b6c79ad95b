// One post-LN encoder layer as a short sequence of hand-written kernels.
//
// Replaces slimt_tpu/ops/encoder_layer_pallas.py:_layer_kernel (with
// _sdpa_rows), the declared TPU encoder:
//
//   q, k, v = affine(x, Wq), affine(x, Wk), affine(x, Wv)
//   att     = softmax((q_h . k_h) * scale + mask) . v_h   per head h
//   x1      = LN(x + affine(att, Wo))
//   out     = LN(x1 + affine(relu(affine(x1, W1)), W2))
//
// Design. The six int8 products run through the affine kernel
// (qmm_affine.cu: int8 tensor cores, x quantized on its way into shared
// memory), each with its own activation scale. The attention kernel
// (slimt_device.cuh, shared with the split encoder's fused SDPA and
// blockwise attention in attention.cu) runs one block per (batch row,
// head): each thread holds a query row in registers and streams that
// head's K and V through shared memory in tiles, with an online softmax,
// so the scores never reach device memory, which is what the TPU kernel
// keeps out of HBM. The residual add and LayerNorm are one kernel, one
// warp per row, with a two-pass mean and variance and 1 / sqrtf like the
// reference formula.
//
// Bounds on the H100: every launch is bound by device memory. The affines
// write their f32 outputs (the [B*T, F] FFN activation is written and
// read once), the attention and LayerNorm kernels move the [B*T, E]
// activations, which round-trip between the nine launches; the int8 and
// f32 arithmetic is far below its peak. Fusing the layer into fewer
// launches is later work.
//
// Numerics: exact-class against the XLA encoder. Scores, softmax and LN
// use the same float32 formulas; only the summation order differs.
// Fully masked (padding) rows stay finite: the mask is -99999999, not
// -inf, and expf (not __expf) is used.

#include <cmath>

#include "slimt_device.cuh"
#include "slimt_kernels.cuh"

namespace slimt {
namespace {

constexpr int kLnWarps = 8;

// out[r] = LN(a[r] + b[r]) * gamma + beta, one warp per row of e.
__global__ void __launch_bounds__(kLnWarps * 32)
add_layer_norm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, float* __restrict__ out,
                      int rows, int e) {
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long off = static_cast<long long>(row) * e;
  const float* pa = a + off;
  const float* pb = b + off;
  float sum = 0.0f;
  for (int i = lane; i < e; i += 32) sum += __fadd_rn(pa[i], pb[i]);
  const float mean = warp_sum(sum) / static_cast<float>(e);
  float sq = 0.0f;
  for (int i = lane; i < e; i += 32) {
    const float c = __fadd_rn(pa[i], pb[i]) - mean;
    sq = fmaf(c, c, sq);
  }
  const float var = warp_sum(sq) / static_cast<float>(e);
  const float inv = 1.0f / sqrtf(var + kLnEps);
  for (int i = lane; i < e; i += 32) {
    const float c = __fadd_rn(pa[i], pb[i]) - mean;
    out[off + i] =
        __fadd_rn(__fmul_rn(__fmul_rn(c, inv), gamma[i]), beta[i]);
  }
}

int launch_add_layer_norm(const float* a, const float* b, const float* gamma,
                          const float* beta, float* out, int rows, int e,
                          cudaStream_t stream) {
  const int blocks = (rows + kLnWarps - 1) / kLnWarps;
  add_layer_norm_kernel<<<blocks, kLnWarps * 32, 0, stream>>>(
      a, b, gamma, beta, out, rows, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace slimt

// weights: wq, bq, wk, bk, wv, bv, wo, bo, att_ln_scale, att_ln_bias,
//          w1, b1, w2, b2, ffn_ln_scale, ffn_ln_bias (device pointers);
// scales:  aq and inv of q, k, v, o, w1, w2 (host floats);
// scratch: 6 * b * t * e + b * t * f floats of device memory.
extern "C" int slimt_encoder_layer(const void* x_, const void* mask_,
                                   void* out_, void* scratch_,
                                   const void* weights_, const void* scales_,
                                   int b, int t, int e, int f, int heads,
                                   float att_scale, void* stream_) {
  using slimt::kAffine;
  using slimt::kAffineRelu;
  const float* x = static_cast<const float*>(x_);
  const float* mask = static_cast<const float*>(mask_);
  float* out = static_cast<float*>(out_);
  const void* const* w = static_cast<const void* const*>(weights_);
  const float* s = static_cast<const float*>(scales_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int m = b * t;
  const long long me = static_cast<long long>(m) * e;
  float* q = static_cast<float*>(scratch_);
  float* k = q + me;
  float* v = k + me;
  float* att = v + me;
  float* tmp = att + me;
  float* x1 = tmp + me;
  float* hidden = x1 + me;
  auto i8 = [&](int i) { return static_cast<const int8_t*>(w[i]); };
  auto f32 = [&](int i) { return static_cast<const float*>(w[i]); };

  int rc;
  if ((rc = slimt::launch_affine(x, i8(0), f32(1), q, m, e, e, e, 1, s[0],
                                 s[1], kAffine, stream)))
    return rc;
  if ((rc = slimt::launch_affine(x, i8(2), f32(3), k, m, e, e, e, 1, s[2],
                                 s[3], kAffine, stream)))
    return rc;
  if ((rc = slimt::launch_affine(x, i8(4), f32(5), v, m, e, e, e, 1, s[4],
                                 s[5], kAffine, stream)))
    return rc;
  if ((rc = slimt::launch_sdpa(q, k, v, mask, att, b, t, e, heads, att_scale,
                               stream)))
    return rc;
  if ((rc = slimt::launch_affine(att, i8(6), f32(7), tmp, m, e, e, e, 1, s[6],
                                 s[7], kAffine, stream)))
    return rc;
  if ((rc = slimt::launch_add_layer_norm(x, tmp, f32(8), f32(9), x1, m, e,
                                         stream)))
    return rc;
  if ((rc = slimt::launch_affine(x1, i8(10), f32(11), hidden, m, e, f, f, 1,
                                 s[8], s[9], kAffineRelu, stream)))
    return rc;
  if ((rc = slimt::launch_affine(hidden, i8(12), f32(13), tmp, m, f, e, e, 1,
                                 s[10], s[11], kAffine, stream)))
    return rc;
  return slimt::launch_add_layer_norm(x1, tmp, f32(14), f32(15), out, m, e,
                                      stream);
}
