// Decode-step cross-attention (T_q = 1) over the joined int16 cache.
//
// Replaces slimt_tpu/ops/decode_attn_pallas.py:_kernel (entry
// decode_attention_int16). Per row b and head h of E / heads columns:
//
//   s[t] = ((K[b, t] . q[b])_h * scale) * kqi[b, t] + mask[b, t]
//   p    = softmax_t(s)
//   out[b, c] = sum_t (p[t] * vqi[b, t]) * V[b, t, c]        -> [B, E]
//
// with scale = 1 / sqrt(E / heads). The score order is the XLA int16
// branch's (transformer.py:_decode_attention_joined: (s * scale) * kqi)
// and the whole-step kernel's; the TPU kernel forms scale * kqi first,
// one rounding apart.
//
// Design. The TPU kernel runs a block of rows that divides the batch and
// reduces per head with two selector matmuls on the MXU. Here a block
// takes one row, so every row of any B is written, and runs the
// `attention` device function of slimt_device.cuh without the head-0
// weights: a warp per source position reads that K row 16 bytes a lane
// and reduces per head by shuffles; a warp per head takes the softmax;
// a thread per column sums V down the positions, neighbouring threads
// on neighbouring bytes. A fully masked (padding) row has every score
// near -1e8 and still a finite softmax.
//
// Bounds on the H100. The kernel reads the cache once: 2 * T * E * 2
// bytes per row (64 KB at T = 64, E = 256); at B = 512 that is 32 MB,
// about 10 us at the card's 3.35 TB/s, plus one SM's latency per row at
// small B.

#include <cmath>
#include <cstdint>

#include "slimt_device.cuh"

namespace slimt {
namespace {

__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const int16_t* __restrict__ k,
                        const int16_t* __restrict__ v,
                        const float* __restrict__ kqi,
                        const float* __restrict__ vqi,
                        const float* __restrict__ mask, float* __restrict__ out,
                        int t, int e, int heads, float scale) {
  extern __shared__ __align__(16) float buf[];
  float* qs = buf;
  float* os = qs + e;
  float* sc = os + e;
  const int row = blockIdx.x;
  const long long base = static_cast<long long>(row) * e;
  for (int i = threadIdx.x; i < e; i += kThreads) qs[i] = q[base + i];
  __syncthreads();
  const JoinedInt16 cache = {k, v, kqi, vqi, t, e, e / heads};
  attention(qs, cache, mask, row, 1, heads, scale, sc, os, nullptr);
  for (int i = threadIdx.x; i < e; i += kThreads) out[base + i] = os[i];
}

}  // namespace
}  // namespace slimt

// q, out [b, e] f32; k, v [b, t, e] int16; kqi, vqi, mask [b, t] f32; all
// contiguous, 16-byte aligned device pointers. e % 256 == 0; the head dim
// e / heads is 8 * 2^i, at most 256.
extern "C" int slimt_decode_attention(const void* q, const void* k,
                                      const void* v, const void* kqi,
                                      const void* vqi, const void* mask,
                                      void* out, int b, int t, int e,
                                      int heads, float scale, void* stream) {
  using namespace slimt;
  const int d = heads > 0 ? e / heads : 0;
  const int lanes = d / 8;
  if (b < 1 || t < 1 || e < 256 || e % 256 || heads < 1 || e % heads ||
      d % 8 || lanes > 32 || (lanes & (lanes - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(e) + static_cast<size_t>(heads) * t);
  static size_t smem_cap = 48 * 1024;
  const cudaError_t err = ensure_smem(decode_attention_kernel, smem, &smem_cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attention_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int16_t*>(k),
      static_cast<const int16_t*>(v), static_cast<const float*>(kqi),
      static_cast<const float*>(vqi), static_cast<const float*>(mask),
      static_cast<float*>(out), t, e, heads, scale);
  return static_cast<int>(cudaGetLastError());
}
