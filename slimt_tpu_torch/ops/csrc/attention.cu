// The split encoder's two attention kernels.
//
// 1. Fused SDPA on joined operands. Replaces
//    slimt_tpu/ops/attention.py:fused_sdpa_joined (bodies
//    _fused_sdpa_kernel_stack and _fused_sdpa_kernel):
//
//      out[b, :, h] = softmax((q_h . k_h) * scale + mask[b]) v_h
//
//    per head h of D = E / heads columns, on [B, T, E] q, k, v straight
//    from the Q/K/V affines (no split into heads). It launches the
//    whole-encoder-layer kernel's SDPA (slimt_device.cuh: sdpa_kernel):
//    one block per (head, batch row), that head's K and V in shared
//    memory (73 KB at T = 256, D = 32; 139 KB at D = 64), one warp per
//    query row, so the [T, T] scores never reach device memory. The TPU
//    kernel's lane masking and stacked heads lay the heads out for its
//    128-wide matrix unit; here a block reads its head's columns
//    directly. Any B is taken.
//
//    Bound on the H100: device memory. q, k, v are read once and out
//    written once (16 * B * T * E bytes, 134 MB at B = 512, T = 64,
//    E = 256: 40 us at 3.35 TB/s), against 4 * B * T * T * E flops
//    (2.1 GFLOP: 32 us at the 67 TFLOP/s f32 rate). The kernel reads K
//    and V from shared memory with a scalar load per multiply-add, so
//    it runs below both; register tiling is later work.
//
// 2. Blockwise attention on split heads. Replaces
//    slimt_tpu/ops/attention.py:blockwise_attention (body
//    _attention_kernel): for q, k, v [B, H, T, D] and the additive mask
//    of row b (shared by its H heads),
//
//      out[b, h] = softmax((q k^T) * scale + mask[b]) v     -> [B, H, T, D]
//
//    The TPU kernel keeps a head's whole K and V in VMEM and takes one
//    softmax over T. Here that does not fit: at T = 2048, D = 32, K and
//    V are 512 KB against 227 KB of shared memory. So a block takes one
//    (b * h, tile of kQueryRows query rows), a thread one query row with
//    q and its output accumulator in registers, and K/V stream through
//    shared memory in tiles of kKeyTile keys with an online softmax: a
//    running max and sum per row, the accumulator rescaled when the max
//    rises. Scores are (q . k) * scale + mask in that order (no FMA
//    contraction of the scale and the mask), as in the TPU kernel.
//    Every row of a ragged last query tile is written; keys past T are
//    zero-filled and excluded. Padding rows are masked at -99999999,
//    not -inf, so their softmax stays finite, as in the plain version.
//
//    Bound on the H100: operations. 4 * B * H * T * T * D flops
//    (17.2 GFLOP at T = 1024, B * H = 128, D = 32: 256 us at 67 TFLOP/s)
//    against 16 * B * H * T * D bytes (67 MB: 20 us). The threads of a
//    block read the same K/V element at once (a shared-memory broadcast,
//    16 bytes per load), two multiply-adds per score and key, one expf
//    per score; the tensor cores (TF32 or split-f32 products) are later
//    work.

#include <cmath>

#include "slimt_device.cuh"

namespace slimt {
namespace {

constexpr int kQueryRows = 64;  // threads per block, one query row each
constexpr int kKeyTile = 32;    // keys per shared-memory tile

// grid (bh, ceil(t / kQueryRows)). q, k, v, out: [bh, t, D] contiguous;
// mask: [bh / heads, t].
template <int D>
__global__ void __launch_bounds__(kQueryRows)
blockwise_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 float* __restrict__ out, int t, int heads, float scale) {
  __shared__ __align__(16) float k_s[kKeyTile * D];
  __shared__ __align__(16) float v_s[kKeyTile * D];
  __shared__ float m_s[kKeyTile];
  const int bh = blockIdx.x;
  const int row = blockIdx.y * kQueryRows + threadIdx.x;
  const bool active = row < t;
  const long long head = static_cast<long long>(bh) * t * D;
  const float* mask_row = mask + static_cast<long long>(bh / heads) * t;

  float qr[D];
  float acc[D];
  if (active) {
    const float4* src = reinterpret_cast<const float4*>(q + head + static_cast<long long>(row) * D);
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      const float4 x = src[c];
      qr[4 * c] = x.x;
      qr[4 * c + 1] = x.y;
      qr[4 * c + 2] = x.z;
      qr[4 * c + 3] = x.w;
    }
  }
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.0f;
  float run_max = -INFINITY;
  float run_sum = 0.0f;

  for (int j0 = 0; j0 < t; j0 += kKeyTile) {
    const int keys = min(kKeyTile, t - j0);
    const float4* k_src = reinterpret_cast<const float4*>(k + head + static_cast<long long>(j0) * D);
    const float4* v_src = reinterpret_cast<const float4*>(v + head + static_cast<long long>(j0) * D);
    float4* k_dst = reinterpret_cast<float4*>(k_s);
    float4* v_dst = reinterpret_cast<float4*>(v_s);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = threadIdx.x; i < kKeyTile * D / 4; i += kQueryRows) {
      const bool in = i < keys * D / 4;
      k_dst[i] = in ? k_src[i] : zero;
      v_dst[i] = in ? v_src[i] : zero;
    }
    for (int j = threadIdx.x; j < kKeyTile; j += kQueryRows)
      m_s[j] = j < keys ? mask_row[j0 + j] : 0.0f;
    __syncthreads();

    if (active) {
      float s[kKeyTile];
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeyTile; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(k_s + j * D);
        float dot = 0.0f;
#pragma unroll
        for (int c = 0; c < D / 4; ++c) {
          const float4 x = kr[c];
          dot = fmaf(qr[4 * c], x.x, dot);
          dot = fmaf(qr[4 * c + 1], x.y, dot);
          dot = fmaf(qr[4 * c + 2], x.z, dot);
          dot = fmaf(qr[4 * c + 3], x.w, dot);
        }
        s[j] = j < keys ? __fadd_rn(__fmul_rn(dot, scale), m_s[j]) : -INFINITY;
        tile_max = fmaxf(tile_max, s[j]);
      }
      // tile_max is finite: a tile holds at least one key.
      const float new_max = fmaxf(run_max, tile_max);
      const float alpha = expf(run_max - new_max);  // 0 on the first tile
      run_sum *= alpha;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
      for (int j = 0; j < kKeyTile; ++j) {
        const float p = expf(s[j] - new_max);  // 0 past t
        run_sum += p;
        const float4* vr = reinterpret_cast<const float4*>(v_s + j * D);
#pragma unroll
        for (int c = 0; c < D / 4; ++c) {
          const float4 x = vr[c];
          acc[4 * c] = fmaf(p, x.x, acc[4 * c]);
          acc[4 * c + 1] = fmaf(p, x.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(p, x.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(p, x.w, acc[4 * c + 3]);
        }
      }
      run_max = new_max;
    }
    __syncthreads();
  }

  if (active) {
    float4* dst = reinterpret_cast<float4*>(out + head + static_cast<long long>(row) * D);
#pragma unroll
    for (int c = 0; c < D / 4; ++c)
      dst[c] = make_float4(acc[4 * c] / run_sum, acc[4 * c + 1] / run_sum,
                           acc[4 * c + 2] / run_sum, acc[4 * c + 3] / run_sum);
  }
}

template <int D>
int launch_blockwise(const float* q, const float* k, const float* v,
                     const float* mask, float* out, int bh, int heads, int t,
                     float scale, cudaStream_t stream) {
  const dim3 grid(bh, (t + kQueryRows - 1) / kQueryRows);
  blockwise_kernel<D><<<grid, kQueryRows, 0, stream>>>(q, k, v, mask, out, t,
                                                       heads, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace slimt

// q, k, v, out [b * t, e] f32; mask [b, t] f32 additive; contiguous
// device pointers. sdpa_smem_bytes(t, e / heads) must fit the block.
extern "C" int slimt_fused_sdpa(const void* q, const void* k, const void* v,
                                const void* mask, void* out, int b, int t,
                                int e, int heads, float scale, void* stream) {
  using namespace slimt;
  if (b < 1 || t < 1 || heads < 1 || e % heads)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_sdpa(static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v),
                     static_cast<const float*>(mask), static_cast<float*>(out),
                     b, t, e, heads, scale, static_cast<cudaStream_t>(stream));
}

// q, k, v, out [bh, t, d] f32 with bh = b * heads; mask [b, t] f32
// additive; contiguous, 16-byte aligned device pointers; d in {8, 16,
// 32, 64}.
extern "C" int slimt_blockwise_attention(const void* q, const void* k,
                                         const void* v, const void* mask,
                                         void* out, int bh, int heads, int t,
                                         int d, float scale, void* stream) {
  using namespace slimt;
  if (bh < 1 || heads < 1 || bh % heads || t < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* mf = static_cast<const float*>(mask);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch_blockwise<8>(qf, kf, vf, mf, of, bh, heads, t, scale, s);
    case 16: return launch_blockwise<16>(qf, kf, vf, mf, of, bh, heads, t, scale, s);
    case 32: return launch_blockwise<32>(qf, kf, vf, mf, of, bh, heads, t, scale, s);
    case 64: return launch_blockwise<64>(qf, kf, vf, mf, of, bh, heads, t, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
