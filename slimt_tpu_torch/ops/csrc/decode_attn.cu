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
// reduces per head with two selector matmuls on the MXU. Here heads are
// independent, so a block takes one (row, head) and the grid B x heads
// blocks fills the card at small B (B=64 at 8 heads: 512 blocks). The
// block's 128 threads read a position's head slice as d / 8 lanes of
// 16 bytes (8 int16 columns a lane), 128 / (d / 8) positions at once:
//   1. the V slices of the lane group's first kPrefetch positions are
//      requested with the K slices of the first scores, so V arrives
//      while the scores and the softmax run;
//   2. scores: each lane group issues the K loads of four positions
//      before their sums, reduces its 8-column sums over the head's
//      lanes by shuffles, and writes ((s * scale) * kqi + mask) to
//      shared memory;
//   3. softmax over t, block-wide (max, then expf and the sum), the
//      weights p * vqi in place;
//   4. V mix: a lane group sums its positions' w * V for its 8 columns
//      (the prefetched ones first, then four loads in flight), and the
//      partial sums of the lane groups meet in shared memory in a fixed
//      order (two steps, no long chain), so a result does not depend on
//      scheduling.
// Where B x heads reaches kWarpKernelItems (B=200 at 8 heads) at T <= 128,
// the same steps run a warp a (row, head), four a block, with no
// block-wide barrier: the lane groups' sums meet by shuffles in a fixed
// tree order.
// A fully masked (padding) row has every score near -1e8 and still a
// finite softmax.
//
// The self-attention decoder's variant (decode_self_attention_kernel and
// its warp twin; entry slimt_decode_self_attention) runs the same steps
// over the first n = *valid positions of a [b, cap, e] cache whose rows
// are cap positions apart, with no mask: n is read from device memory at
// each launch, so a captured CUDA graph replays it at each step, and the
// kernel reads the n positions a step needs, not the whole capacity. The
// grid and the shared memory follow the capacity, fixed at launch.
//
// Bounds on the H100. The kernel reads the cache once: 2 * T * E * 2
// bytes per row (64 KB at T = 64, E = 256); at B = 64 that is 4.2 MB,
// 1.3 us at the card's 3.35 TB/s. The f32 arithmetic is 4 T E operations
// a row, far below the CUDA cores' rate.

#include <cmath>
#include <cstdint>

#include "slimt_device.cuh"

namespace slimt {
namespace {

constexpr int kAttnThreads = 128;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kPrefetch = 4;  // V slices a lane group requests with the scores
constexpr int kInFlight = 4;  // loads a lane group issues before their sums

__device__ __forceinline__ int4 load16(const int16_t* src, bool in) {
  return in ? __ldg(reinterpret_cast<const int4*>(src)) : make_int4(0, 0, 0, 0);
}

__device__ __forceinline__ void unpack8(const int4& packed, float* out) {
  const int words[4] = {packed.x, packed.y, packed.z, packed.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = static_cast<float>(static_cast<int16_t>(words[i] & 0xffff));
    out[2 * i + 1] = static_cast<float>(static_cast<int16_t>(words[i] >> 16));
  }
}

// One (row, head)'s threads, tid < threads of them, in lane groups of
// d / 8 lanes, each lane 8 int16 columns of a position: steps 1-4 of the
// file's note, shared by the block and the warp kernel.
struct Item {
  int lanes, groups, grp, lane, t, e;  // t: the positions read
  long long row_t;  // row * the positions a row holds
  const int16_t* kp;
  const int16_t* vp;
  float qv[8];
  int4 vpre[kPrefetch];

  // The lane's q columns and the V slices of its group's first positions.
  __device__ Item(int tid, int threads, int row, int head, const float* q, const int16_t* k,
                  const int16_t* v, int t_, int stride, int e_, int d)
      : lanes(d / 8), groups(threads / (d / 8)), grp(tid / (d / 8)), lane(tid % (d / 8)), t(t_),
        e(e_), row_t(static_cast<long long>(row) * stride) {
    const int c0 = head * d + 8 * lane;
    kp = k + row_t * e + c0;
    vp = v + row_t * e + c0;
    const float4* src = reinterpret_cast<const float4*>(q + static_cast<long long>(row) * e + c0);
    const float4 lo = __ldg(src);
    const float4 hi = __ldg(src + 1);
    qv[0] = lo.x; qv[1] = lo.y; qv[2] = lo.z; qv[3] = lo.w;
    qv[4] = hi.x; qv[5] = hi.y; qv[6] = hi.z; qv[7] = hi.w;
#pragma unroll
    for (int r = 0; r < kPrefetch; ++r) {
      const int j = grp + groups * r;
      vpre[r] = load16(vp + static_cast<long long>(j) * e, j < t);
    }
  }

  // sc[j] = ((K[j] . q)_head * scale) * kqi[j] + mask[j] (no mask term
  // unless kMasked), kInFlight positions a lane group a pass; the loop is
  // uniform in a warp, as the shuffles need.
  template <bool kMasked>
  __device__ void scores(float* sc, const float* __restrict__ kqi, const float* __restrict__ mask,
                         float scale) const {
    for (int base = 0; base < t; base += kInFlight * groups) {
      int4 kv[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int j = base + u * groups + grp;
        kv[u] = load16(kp + static_cast<long long>(j) * e, j < t);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int j = base + u * groups + grp;
        float kf[8];
        unpack8(kv[u], kf);
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s = __fadd_rn(s, __fmul_rn(kf[i], qv[i]));
        for (int offset = lanes / 2; offset > 0; offset /= 2)
          s += __shfl_xor_sync(0xffffffffu, s, offset);
        if (j < t && lane == 0) {
          const float scaled = __fmul_rn(__fmul_rn(s, scale), kqi[row_t + j]);
          sc[j] = kMasked ? __fadd_rn(scaled, mask[row_t + j]) : scaled;
        }
      }
    }
  }

  // acc = sum of w[j] * V[j] over the group's positions grp, grp +
  // groups, ... in order (the prefetched ones first, then kInFlight
  // loads in flight).
  __device__ void mix(const float* w, float (&acc)[8]) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
    auto add = [&](const int4& packed, float wj) {
      float vf[8];
      unpack8(packed, vf);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(vf[i], wj));
    };
#pragma unroll
    for (int r = 0; r < kPrefetch; ++r) {
      const int j = grp + groups * r;
      if (j < t) add(vpre[r], w[j]);
    }
    for (int j0 = grp + groups * kPrefetch; j0 < t; j0 += kInFlight * groups) {
      int4 vv[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int j = j0 + u * groups;
        vv[u] = load16(vp + static_cast<long long>(j) * e, j < t);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int j = j0 + u * groups;
        if (j < t) add(vv[u], w[j]);
      }
    }
  }
};

// The softmax of sc over t in place, then the weights p * vqi; tid <
// threads share the positions, reduce(v, is_max) meets their values.
template <typename Reduce>
__device__ __forceinline__ void softmax_weights(float* sc, int t, const float* __restrict__ vqi,
                                                long long row_t, int tid, int threads,
                                                Reduce reduce) {
  float m = -INFINITY;
  for (int j = tid; j < t; j += threads) m = fmaxf(m, sc[j]);
  m = reduce(m, true);
  float sum = 0.0f;
  for (int j = tid; j < t; j += threads) {
    const float p = expf(sc[j] - m);
    sc[j] = p;
    sum += p;
  }
  sum = reduce(sum, false);
  for (int j = tid; j < t; j += threads) sc[j] = __fmul_rn(sc[j] / sum, vqi[row_t + j]);
}

// grid (b, heads); d = e / heads, d / 8 a power of two <= 32. A row holds
// `stride` positions, of which the first n are read (n == stride but in
// the self-attention variant), masked by `mask` where kMasked.
template <bool kMasked>
__device__ __forceinline__ void attention_block(
    const float* __restrict__ q, const int16_t* __restrict__ k, const int16_t* __restrict__ v,
    const float* __restrict__ kqi, const float* __restrict__ vqi, const float* __restrict__ mask,
    float* __restrict__ out, int n, int stride, int e, int d, float scale) {
  extern __shared__ __align__(16) float buf[];
  __shared__ float red[kAttnWarps];
  const int t = n;
  float* part = buf;                  // [groups][d] partial sums of the V mix
  float* sc = buf + kAttnThreads * 8;  // [t] scores, then weights; then the slices
  const Item item(threadIdx.x, kAttnThreads, blockIdx.x, blockIdx.y, q, k, v, t, stride, e, d);
  item.scores<kMasked>(sc, kqi, mask, scale);
  __syncthreads();
  softmax_weights(sc, t, vqi, item.row_t, threadIdx.x, kAttnThreads, [&](float x, bool is_max) {
    x = is_max ? warp_max(x) : warp_sum(x);
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
    __syncthreads();
    float r = red[0];
    for (int w = 1; w < kAttnWarps; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
    __syncthreads();  // red is free again
    return r;
  });
  __syncthreads();
  float acc[8];
  item.mix(sc, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) part[item.grp * d + 8 * item.lane + i] = acc[i];
  __syncthreads();
  // The groups' sums meet in a fixed order in two steps: slice s of the
  // threads sums groups s, s + slices, ... of its column, then a thread a
  // column sums the slices.
  const int slices = max(1, kAttnThreads / d);
  float* sliced = sc + t;  // [slices][d], at most kAttnThreads * 2 floats
  for (int u = threadIdx.x; u < slices * d; u += kAttnThreads) {
    float total = 0.0f;
    for (int g = u / d; g < item.groups; g += slices) total = __fadd_rn(total, part[g * d + u % d]);
    sliced[u] = total;
  }
  __syncthreads();
  float* dst = out + static_cast<long long>(blockIdx.x) * e + blockIdx.y * d;
  for (int c = threadIdx.x; c < d; c += kAttnThreads) {
    float total = 0.0f;
    for (int s = 0; s < slices; ++s) total = __fadd_rn(total, sliced[s * d + c]);
    dst[c] = total;
  }
}

__global__ void __launch_bounds__(kAttnThreads)
decode_attention_kernel(const float* __restrict__ q, const int16_t* __restrict__ k,
                        const int16_t* __restrict__ v, const float* __restrict__ kqi,
                        const float* __restrict__ vqi, const float* __restrict__ mask,
                        float* __restrict__ out, int t, int e, int d, float scale) {
  attention_block<true>(q, k, v, kqi, vqi, mask, out, t, t, e, d, scale);
}

// The positions read, *valid clamped to [0, cap].
__device__ __forceinline__ int valid_positions(const int* __restrict__ valid, int cap) {
  return min(max(__ldg(valid), 0), cap);
}

__global__ void __launch_bounds__(kAttnThreads)
decode_self_attention_kernel(const float* __restrict__ q, const int16_t* __restrict__ k,
                             const int16_t* __restrict__ v, const float* __restrict__ kqi,
                             const float* __restrict__ vqi, const int* __restrict__ valid,
                             float* __restrict__ out, int cap, int e, int d, float scale) {
  attention_block<false>(q, k, v, kqi, vqi, nullptr, out, valid_positions(valid, cap), cap, e,
                         d, scale);
}

// The same attention with a warp a (row, head), kItemWarps of them a
// block, where the items alone fill the card (large B): no block-wide
// barrier, the softmax and the lane groups' sums by shuffles in a fixed
// tree order.
constexpr int kItemWarps = 4;
// The warp kernel runs from 1600 items at T <= 128. On an H100 80GB HBM3
// at 700 W, E=256, 8 heads (chip_smoke.py --layouts, each kernel forced,
// graph replay), device ms block /
// warp: T=64 B=64 0.0049 / 0.0066, B=130 0.0068 / 0.0073, B=200 0.0099 /
// 0.0079, B=512 0.0243 / 0.0120; T=1024 B=8 0.019 / 0.070, B=256 0.128 /
// 0.146 (T between 64 and 1024 not measured).
constexpr int kWarpKernelItems = 1600;
constexpr int kWarpKernelT = 128;

template <bool kMasked>
__device__ __forceinline__ void attention_warp(
    const float* __restrict__ q, const int16_t* __restrict__ k, const int16_t* __restrict__ v,
    const float* __restrict__ kqi, const float* __restrict__ vqi, const float* __restrict__ mask,
    float* __restrict__ out, int items, int n, int stride, int e, int d, int heads, float scale) {
  extern __shared__ __align__(16) float scores[];  // [kItemWarps][stride]
  const int t = n;
  const int lane = threadIdx.x % 32;
  const int index = blockIdx.x * kItemWarps + static_cast<int>(threadIdx.x) / 32;
  if (index >= items) return;  // a whole warp
  float* sc = scores + threadIdx.x / 32 * stride;
  const Item item(lane, 32, index / heads, index % heads, q, k, v, t, stride, e, d);
  item.scores<kMasked>(sc, kqi, mask, scale);
  __syncwarp();
  softmax_weights(sc, t, vqi, item.row_t, lane, 32,
                  [](float x, bool is_max) { return is_max ? warp_max(x) : warp_sum(x); });
  __syncwarp();
  float acc[8];
  item.mix(sc, acc);
  // The lane groups' sums, a butterfly over the group bits of the lane.
  for (int offset = item.lanes; offset < 32; offset *= 2) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __shfl_xor_sync(0xffffffffu, acc[i], offset));
  }
  if (item.grp == 0) {
    float4* dst = reinterpret_cast<float4*>(out + static_cast<long long>(index / heads) * e +
                                            index % heads * d + 8 * item.lane);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

__global__ void __launch_bounds__(kItemWarps * 32)
decode_attention_warp_kernel(const float* __restrict__ q, const int16_t* __restrict__ k,
                             const int16_t* __restrict__ v, const float* __restrict__ kqi,
                             const float* __restrict__ vqi, const float* __restrict__ mask,
                             float* __restrict__ out, int items, int t, int e, int d, int heads,
                             float scale) {
  attention_warp<true>(q, k, v, kqi, vqi, mask, out, items, t, t, e, d, heads, scale);
}

__global__ void __launch_bounds__(kItemWarps * 32)
decode_self_attention_warp_kernel(const float* __restrict__ q, const int16_t* __restrict__ k,
                                  const int16_t* __restrict__ v, const float* __restrict__ kqi,
                                  const float* __restrict__ vqi, const int* __restrict__ valid,
                                  float* __restrict__ out, int items, int cap, int e, int d,
                                  int heads, float scale) {
  attention_warp<false>(q, k, v, kqi, vqi, nullptr, out, items, valid_positions(valid, cap),
                        cap, e, d, heads, scale);
}

}  // namespace
}  // namespace slimt

// q, out [b, e] f32; k, v [b, t, e] int16; kqi, vqi, mask [b, t] f32; all
// contiguous, 16-byte aligned device pointers. e % 128 == 0 (a tensor-
// parallel rank's heads: E / model columns); the head dim e / heads is
// 8 * 2^i, at most 256. kernel: 0 the choice below, 1 the
// block kernel, 2 the warp kernel.
extern "C" int slimt_decode_attention(const void* q, const void* k,
                                      const void* v, const void* kqi,
                                      const void* vqi, const void* mask,
                                      void* out, int b, int t, int e,
                                      int heads, float scale, int kernel, void* stream) {
  using namespace slimt;
  const int d = heads > 0 ? e / heads : 0;
  const int lanes = d / 8;
  if (b < 1 || t < 1 || e < 128 || e % 128 || heads < 1 || e % heads ||
      d % 8 || lanes > 32 || (lanes & (lanes - 1)) || kernel < 0 || kernel > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const int16_t* ks = static_cast<const int16_t*>(k);
  const int16_t* vs = static_cast<const int16_t*>(v);
  const float* kqf = static_cast<const float*>(kqi);
  const float* vqf = static_cast<const float*>(vqi);
  const float* mf = static_cast<const float*>(mask);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long items = static_cast<long long>(b) * heads;
  if (kernel == 2 || (kernel == 0 && items >= kWarpKernelItems && t <= kWarpKernelT)) {
    const size_t smem = sizeof(float) * kItemWarps * static_cast<size_t>(t);
    static size_t warp_cap = 48 * 1024;
    const cudaError_t err = ensure_smem(decode_attention_warp_kernel, smem, &warp_cap);
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_attention_warp_kernel<<<(items + kItemWarps - 1) / kItemWarps, kItemWarps * 32, smem,
                                   st>>>(qf, ks, vs, kqf, vqf, mf, of, static_cast<int>(items), t,
                                         e, d, heads, scale);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * (kAttnThreads * 10 + static_cast<size_t>(t));
  static size_t smem_cap = 48 * 1024;
  const cudaError_t err = ensure_smem(decode_attention_kernel, smem, &smem_cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attention_kernel<<<dim3(b, heads), kAttnThreads, smem, st>>>(
      qf, ks, vs, kqf, vqf, mf, of, t, e, d, scale);
  return static_cast<int>(cudaGetLastError());
}

// The self-attention decoder's cache: q, out [b, e] f32; k, v [b, cap, e]
// int16; kqi, vqi [b, cap] f32; valid one int32, the positions 0..*valid-1
// read (clamped to cap); all contiguous device pointers, 16-byte aligned
// but valid. The shapes' rules and the choice of kernel are the entry
// above's, with the capacity cap in place of t.
extern "C" int slimt_decode_self_attention(const void* q, const void* k, const void* v,
                                           const void* kqi, const void* vqi, const void* valid,
                                           void* out, int b, int cap, int e, int heads,
                                           float scale, void* stream) {
  using namespace slimt;
  const int d = heads > 0 ? e / heads : 0;
  const int lanes = d / 8;
  if (b < 1 || cap < 1 || e < 128 || e % 128 || heads < 1 || e % heads || d % 8 || lanes > 32 ||
      (lanes & (lanes - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const int16_t* ks = static_cast<const int16_t*>(k);
  const int16_t* vs = static_cast<const int16_t*>(v);
  const float* kqf = static_cast<const float*>(kqi);
  const float* vqf = static_cast<const float*>(vqi);
  const int* n = static_cast<const int*>(valid);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long items = static_cast<long long>(b) * heads;
  if (items >= kWarpKernelItems && cap <= kWarpKernelT) {
    const size_t smem = sizeof(float) * kItemWarps * static_cast<size_t>(cap);
    static size_t warp_cap = 48 * 1024;
    const cudaError_t err = ensure_smem(decode_self_attention_warp_kernel, smem, &warp_cap);
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_self_attention_warp_kernel<<<(items + kItemWarps - 1) / kItemWarps, kItemWarps * 32,
                                        smem, st>>>(qf, ks, vs, kqf, vqf, n, of,
                                                    static_cast<int>(items), cap, e, d, heads,
                                                    scale);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * (kAttnThreads * 10 + static_cast<size_t>(cap));
  static size_t smem_cap = 48 * 1024;
  const cudaError_t err = ensure_smem(decode_self_attention_kernel, smem, &smem_cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_self_attention_kernel<<<dim3(b, heads), kAttnThreads, smem, st>>>(
      qf, ks, vs, kqf, vqf, n, of, cap, e, d, scale);
  return static_cast<int>(cudaGetLastError());
}
