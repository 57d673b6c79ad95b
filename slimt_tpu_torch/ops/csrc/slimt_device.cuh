// Device functions shared by the kernels: the whole decode step and the
// per-layer step (decoder_step.cu), the SSRU and FFN blocks
// (fused_blocks.cu), the projection argmax (logits_argmax.cu), the decode
// attention over the int16, float and split caches (decode_attn.cu and the
// steps), and the encoder's attention kernel: the SDPA of the whole-layer
// kernel (encoder_layer.cu) and the split encoder's fused SDPA and
// blockwise attention (attention.cu).
//
// Every block but the attention kernel's runs kThreads threads. The int8
// products of the decoder blocks are __dp4a over int32 accumulators
// (exact), those of the projection argmax int8 tensor-core tiles
// (slimt_mma.cuh, exact too); the epilogues round the multiply and the add
// separately (__fmul_rn, __fadd_rn), and q8 is rintf (half to even)
// clipped to +-127, as in qmm_affine.cu. The layers kernel, the SSRU block
// and the FFN block spread a row tile over a thread-block cluster
// (cluster_ffn, push_cols, launch_cluster) and stream their weight slices
// through shared memory (WeightStream). Each TU gets its own copy (an
// anonymous namespace), so no relocatable device code is needed.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cmath>
#include <cstdint>
#include <type_traits>
#include <utility>

#include "slimt_mma.cuh"

namespace slimt {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 4;  // rows a slice_product carries
constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

__device__ __forceinline__ int8_t quant8(float v, float aq) {
  float r = rintf(__fmul_rn(v, aq));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// Bytes (k0..k3) of column j of four consecutive W rows a0..a3, each row
// holding columns 4m..4m+3: out[j] packs column 4m+j for __dp4a.
__device__ __forceinline__ void transpose4(unsigned a0, unsigned a1,
                                           unsigned a2, unsigned a3,
                                           int* out) {
  const unsigned t0 = __byte_perm(a0, a1, 0x5140);
  const unsigned t1 = __byte_perm(a2, a3, 0x5140);
  const unsigned t2 = __byte_perm(a0, a1, 0x7362);
  const unsigned t3 = __byte_perm(a2, a3, 0x7362);
  out[0] = static_cast<int>(__byte_perm(t0, t1, 0x5410));
  out[1] = static_cast<int>(__byte_perm(t0, t1, 0x7632));
  out[2] = static_cast<int>(__byte_perm(t2, t3, 0x5410));
  out[3] = static_cast<int>(__byte_perm(t2, t3, 0x7632));
}

// xq[r * ldq + k] = q8(x[r * ldx + k]) for r < rows, k < k_dim (and,
// where xq2 is given, xq2 the same by aq2).
__device__ void quantize_rows(const float* x, int ldx, int k_dim, float aq,
                              int8_t* xq, int ldq, int rows, float aq2 = 0.0f,
                              int8_t* xq2 = nullptr) {
  for (int i = threadIdx.x; i < rows * k_dim; i += kThreads) {
    const int r = i / k_dim;
    const int k = i % k_dim;
    const float v = x[r * ldx + k];
    xq[r * ldq + k] = quant8(v, aq);
    if (xq2 != nullptr) xq2[r * ldq + k] = quant8(v, aq2);
  }
  __syncthreads();
}

// acc * inv (+ bias[n]) (relu), the epilogue of every int8 product here:
// the multiply and the add rounded separately, as in qmm_affine.cu.
__device__ __forceinline__ float affine_value(int acc, float inv,
                                              const float* __restrict__ bias,
                                              int n, bool relu) {
  float v = __fmul_rn(__int2float_rn(acc), inv);
  if (bias != nullptr) v = __fadd_rn(v, bias[n]);
  if (relu) v = fmaxf(v, 0.0f);
  return v;
}

// Shared-memory ints slice_product needs where a column group spans more
// than one warp (n_cols <= 64 beside k_dim >= 256).
constexpr int kReduceInts = kWarps * kMaxRows * 16;

// The lanes slice_product gives each 16-column group of a k_dim x n_cols
// product to split k between: doubled while the groups still fill the
// block and each lane keeps two quads of k.
__host__ __device__ constexpr int product_lanes(int k_dim, int n_cols) {
  int ks = 1;
  while (ks < kThreads && 2 * ks * (n_cols / 16) <= kThreads && 2 * ks <= k_dim / 4) ks *= 2;
  return ks;
}

// n rounded up to a multiple of 16: the width the decoder kernels'
// products and cluster split run over (zeros, or masks, past n).
__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// The ints of `red` a kernel of E x E, E x F and F x E products on
// clusters of cs blocks needs: kReduceInts on a cluster (its slices are
// narrow) or where a whole product's column group spans warps (a narrow E
// beside a wide F: E = 64, F = 256 at cs = 1), else none.
__host__ __device__ constexpr int reduce_ints(int cs, int e, int f) {
  return cs > 1 || product_lanes(e, e) > 32 || product_lanes(e, f) > 32 ||
                 product_lanes(f, e) > 32
             ? kReduceInts
             : 0;
}

// Where a product reads its int8 weights: the 16 bytes of rows 4 kq + i,
// columns 16 g.. at w + kq * quad + i * row + g * group. A row-major [K, N]
// matrix with row stride ld is (w, 4 ld, ld, 16); a slice staged in shared
// memory by WeightStream is laid out [i][g][kq], so that the lanes of a
// column group, which split k, read neighbouring 16-byte chunks. A
// masked product (slice_product<true>) reads a row-major matrix in place
// whose rows need not be 16-byte aligned and whose true K or N ends inside
// the product's 16-column groups (a width that is no multiple of 16): byte
// by byte, rows >= k_valid and columns >= n_valid (both counted from w) as
// zeros, so that the product over the widths rounded up equals the one
// over the true widths whatever the quantized input holds past them.
struct Slab {
  const int8_t* w;
  int quad, row, group;
  int k_valid = 0, n_valid = 0;  // masked products only
};

__device__ __forceinline__ Slab row_major(const int8_t* w, int ld) {
  return {w, 4 * ld, ld, 16};
}

// The 16 bytes at p as an int4, bytes j >= n (or all, where the row is
// past the matrix) zero.
__device__ __forceinline__ int4 masked16(const int8_t* p, bool row_ok, int n) {
  unsigned word[4] = {0u, 0u, 0u, 0u};
  if (row_ok) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < n) word[j / 4] |= static_cast<unsigned>(static_cast<uint8_t>(p[j])) << (8 * (j % 4));
    }
  }
  return make_int4(static_cast<int>(word[0]), static_cast<int>(word[1]),
                   static_cast<int>(word[2]), static_cast<int>(word[3]));
}

// a[j] for a j known only at run time, without indexing the registers.
__device__ __forceinline__ int pick(const int (&a)[16], int j) {
  int v = a[0];
#pragma unroll
  for (int i = 1; i < 16; ++i) v = j == i ? a[i] : v;
  return v;
}

// epi(r, n, acc) once for each r < rows <= kMaxRows and n < n_cols, acc =
// sum_{k < k_dim} xq[r * ldq + k] * W[k, n], an exact int32 sum; W is read
// through `w` (Slab: int8 in global or shared memory, 16-byte aligned; or,
// kMasked, a row-major matrix in place read byte by byte),
// n_cols % 16 == 0, k_dim % 4 == 0, ldq % 4 == 0. A group of ks lanes owns 16
// columns and splits k between them, ks growing as the groups get fewer (up
// to the whole block); the lanes of one warp meet by shuffles, the warps of
// one group in `red` (kReduceInts ints of shared memory, null where no group
// spans warps: reduce_ints); each lane then runs epi for the 16 / ks columns it holds. Ends with
// __syncthreads().
template <bool kMasked = false, typename Epi>
__device__ void slice_product(const int8_t* xq, int ldq, int rows, const Slab& w,
                              int k_dim, int n_cols, int* red, Epi epi) {
  const int groups = n_cols / 16;
  const int quads = k_dim / 4;
  const int ks = product_lanes(k_dim, n_cols);
  const int lane_k = threadIdx.x % ks;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int per_pass = kThreads / ks;
  const int passes = (groups + per_pass - 1) / per_pass;
  for (int pass = 0; pass < passes; ++pass) {
    const int g = pass * per_pass + static_cast<int>(threadIdx.x) / ks;
    const bool active = g < groups;
    int acc[kMaxRows][16];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[r][j] = 0;
    }
    if (active) {
      const int8_t* col = w.w + g * w.group;
#pragma unroll 2
      for (int kq = lane_k; kq < quads; kq += ks) {
        const int8_t* src = col + static_cast<long long>(kq) * w.quad;
        int4 a0, a1, a2, a3;
        if constexpr (!kMasked) {
          a0 = *reinterpret_cast<const int4*>(src);
          a1 = *reinterpret_cast<const int4*>(src + w.row);
          a2 = *reinterpret_cast<const int4*>(src + 2 * w.row);
          a3 = *reinterpret_cast<const int4*>(src + 3 * w.row);
        } else {
          const int k = 4 * kq;
          const int n = w.n_valid - 16 * g;
          a0 = masked16(src, k < w.k_valid, n);
          a1 = masked16(src + w.row, k + 1 < w.k_valid, n);
          a2 = masked16(src + 2 * w.row, k + 2 < w.k_valid, n);
          a3 = masked16(src + 3 * w.row, k + 3 < w.k_valid, n);
        }
        int cols[16];
        transpose4(a0.x, a1.x, a2.x, a3.x, cols);
        transpose4(a0.y, a1.y, a2.y, a3.y, cols + 4);
        transpose4(a0.z, a1.z, a2.z, a3.z, cols + 8);
        transpose4(a0.w, a1.w, a2.w, a3.w, cols + 12);
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < rows) {
            const int xw = reinterpret_cast<const int*>(xq + r * ldq)[kq];
#pragma unroll
            for (int j = 0; j < 16; ++j) acc[r][j] = __dp4a(xw, cols[j], acc[r][j]);
          }
        }
      }
    }
    for (int offset = (ks < 32 ? ks : 32) / 2; offset > 0; offset /= 2) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], offset);
        }
      }
    }
    if (ks <= 32) {
      // Every lane holds the 16 sums; lane_k takes columns lane_k + q ks.
      if (active) {
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < rows) {
            for (int j = lane_k; j < 16; j += ks) epi(r, 16 * g + j, pick(acc[r], j));
          }
        }
      }
    } else {
      // A group of ks / 32 whole warps: lane j of each holds column j's sum.
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows && lane < 16) red[(warp * kMaxRows + r) * 16 + lane] = pick(acc[r], lane);
      }
      __syncthreads();
      if (active && lane_k < 16) {
        for (int r = 0; r < rows; ++r) {
          int sum = 0;
          for (int i = 0; i < ks / 32; ++i) sum += red[((warp + i) * kMaxRows + r) * 16 + lane];
          epi(r, 16 * g + lane, sum);
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
}

// out[r] = LN(a[r] + b[r]) * gamma + beta for r < rows, one warp per row
// of e, the rows of a, b and out ld floats apart (0: e); with b null,
// LN(a[r]), a holding sums formed beforehand. out may alias a or b. Where
// q0 (q1) is given, q0[r * ldq + i] = q8(out[r, i]) by aq0 (aq1) too: the
// next products' quantized input.
__device__ void add_layer_norm(const float* a, const float* b,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta, float* out,
                               int rows, int e, int ldq = 0, float aq0 = 0.0f,
                               int8_t* q0 = nullptr, float aq1 = 0.0f,
                               int8_t* q1 = nullptr, int ld = 0) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pitch = ld > 0 ? ld : e;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    const float* pa = a + r * pitch;
    const float* pb = b != nullptr ? b + r * pitch : nullptr;
    float* po = out + r * pitch;
    auto z = [&](int i) { return pb != nullptr ? __fadd_rn(pa[i], pb[i]) : pa[i]; };
    float sum = 0.0f;
    for (int i = lane; i < e; i += 32) sum += z(i);
    const float mean = warp_sum(sum) / static_cast<float>(e);
    float sq = 0.0f;
    for (int i = lane; i < e; i += 32) {
      const float c = z(i) - mean;
      sq = fmaf(c, c, sq);
    }
    const float var = warp_sum(sq) / static_cast<float>(e);
    const float inv = 1.0f / sqrtf(var + kLnEps);
    for (int i = lane; i < e; i += 32) {
      const float c = z(i) - mean;
      const float v = __fadd_rn(__fmul_rn(__fmul_rn(c, inv), gamma[i]), beta[i]);
      po[i] = v;
      if (q0 != nullptr) q0[r * ldq + i] = quant8(v, aq0);
      if (q1 != nullptr) q1[r * ldq + i] = quant8(v, aq1);
    }
  }
  __syncthreads();
}

// A row tile spread over a thread-block cluster (the decoder step's
// layers kernel, the SSRU block and the FFN block). The cs blocks of a
// cluster hold the same rows; each computes 1/cs of every product (a
// slice of W's columns, or of its rows with int32 partial sums), and the
// rows meet again in every block through distributed shared memory, each
// phase closed by cluster.sync(). LayerNorm and the element-wise steps run
// in every block on whole rows, so a row is the same in every block and
// the same as with cs = 1: int32 sums are exact in any order, and every
// float sum keeps its order. A cluster of one block is the one-block
// layout.

// The two halves of cluster.sync(). A block may touch another block's
// shared memory only once every block of the cluster has started, which
// cluster_wait() after every block's cluster_arrive() guarantees: a kernel
// whose first exchange is not behind a cluster.sync() arrives at its start
// and waits just before that exchange, keeping its prologue (the first
// weight copies) overlapped.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Columns [c0, c0 + n) of the rows [rows, ld] of `buf` in this block's
// shared memory, copied to the same place in every other block of the
// cluster (the caller's cluster.sync() then makes them visible). Every
// block of the cluster must have started (cluster_wait).
__device__ void push_cols(float* buf, int ld, int rows, int c0, int n) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int me = static_cast<int>(cluster.block_rank());
  const int per = rows * n;
  for (int i = threadIdx.x; i < per * (cs - 1); i += kThreads) {
    const int other = i / per;
    const int at = (i % per) / n * ld + c0 + i % n;
    cluster.map_shared_rank(buf, other < me ? other : other + 1)[at] = buf[at];
  }
}

// The weight slices of the cluster kernels' products, streamed into shared
// memory. A block's slice of a [K, N] matrix is rows x width bytes, row r
// at src + r * ld (width and ld multiples of 16, src 16-byte aligned); for
// a masked product (a width that is no multiple of 16), read in place with
// k_valid rows and n_valid columns of the matrix.
struct Slice {
  const int8_t* src;
  int rows, width, ld;
  int k_valid = 0, n_valid = 0;  // masked products only
};

// The FFN block's vectors and scales (its weights come from `take`), and
// the true widths where the products run over widths rounded up to 16:
// e_valid columns of the rows, b1_valid of this block's hidden units.
struct FfnWeights {
  const float* b1;  // this block's f/cs hidden units
  const float* b2;  // [e]
  const float* ln_scale;
  const float* ln_bias;
  float inv1, aq2, inv2;
  int e_valid, b1_valid;
};

// out = LN(x + q8(relu(q8(x) W1 inv1 + b1)) W2 inv2 + b2) for the rows of
// one tile, over the cluster, with xq = q8(x) given: the block of rank i
// computes the hidden units [i f/cs, (i+1) f/cs) whole (its columns of W1,
// take(0); quantized in the epilogue into xq2), then their share of FFN2
// (the same rows of W2, take(1)) as int32 partials in `part`; after one
// cluster.sync() every block sums the cs partials of every column and runs
// the epilogue and the LayerNorm on whole rows (and, where q0 or q1 is given, quantizes the
// output by aq0 or aq1 for the next products). Shared memory of each
// block: x, y, out [rows, e] (out may alias x or y), part [rows, e] ints,
// red (slice_product), xq and xq2 [rows, ldq] bytes, ldq >= max(e, f/cs).
// e and f are the products' widths (multiples of 16 cs); kMasked, the true
// widths (w.e_valid, and f through w.b1_valid) may be less: the rows hold
// zeros past them, the hidden units past f quantize to 0, the products are
// masked, and the LayerNorm runs over the true E at a pitch of e.
// The other blocks read `part` until the cluster's next sync: write it
// again only after that.
template <bool kMasked = false, typename Take>
__device__ void cluster_ffn(const FfnWeights& w, Take take, const float* x, float* y,
                            float* out, int* part, int* red, const int8_t* xq,
                            int8_t* xq2, int ldq, int rows, int e, int f,
                            float aq0 = 0.0f, int8_t* q0 = nullptr, float aq1 = 0.0f,
                            int8_t* q1 = nullptr) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int fs = f / cs;
  slice_product<kMasked>(xq, ldq, rows, take(0), e, fs, red, [&](int r, int n, int acc) {
    xq2[r * ldq + n] = !kMasked || n < w.b1_valid
                           ? quant8(affine_value(acc, w.inv1, w.b1, n, true), w.aq2)
                           : 0;
  });
  slice_product<kMasked>(xq2, ldq, rows, take(1), fs, e, red,
                         [&](int r, int n, int acc) { part[r * e + n] = acc; });
  cluster.sync();
  for (int i = threadIdx.x; i < rows * e; i += kThreads) {
    const int c = i % e;
    float v = 0.0f;
    if (!kMasked || c < w.e_valid) {
      int acc = 0;
      for (int src = 0; src < cs; ++src) acc += cluster.map_shared_rank(part, src)[i];
      v = affine_value(acc, w.inv2, w.b2, c, false);
    }
    y[i] = v;
  }
  __syncthreads();
  add_layer_norm(y, x, w.ln_scale, w.ln_bias, out, rows, w.e_valid, ldq, aq0, q0, aq1, q1, e);
}

// Cluster sizes the kernels take: a power of two up to 16 (above 8 only
// with the non-portable attribute, which launch_cluster sets).
__host__ __device__ constexpr bool cluster_size_ok(int cs) {
  return cs == 1 || cs == 2 || cs == 4 || cs == 8 || cs == 16;
}

// Widths a cluster of cs blocks splits: each block a multiple of 16
// columns of E and of F.
__host__ __device__ constexpr bool cluster_layout_ok(int cs, int e, int f) {
  return cluster_size_ok(cs) && e % (16 * cs) == 0 && f % (16 * cs) == 0;
}

// Shared memory a block of the current device may opt into (0 where the
// query fails).
size_t smem_optin() {
  int device = 0;
  int limit = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return static_cast<size_t>(limit);
}

// A kernel's launch attributes, set once: the dynamic shared-memory cap
// (48 KB without the attribute) and the non-portable cluster sizes.
struct KernelAttrs {
  size_t smem_cap = 48 * 1024;
  bool clusters = false;
};

cudaError_t prepare_cluster_kernel(const void* kernel, size_t smem, KernelAttrs* attrs) {
  if (!attrs->clusters) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    attrs->clusters = true;
  }
  if (smem <= attrs->smem_cap) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) attrs->smem_cap = smem;
  return err;
}

cudaLaunchConfig_t cluster_config(int blocks, int cs, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of cs blocks with `smem` bytes each that the device can hold at
// once (0: such a cluster cannot be scheduled, or the query failed).
template <typename... Params>
int cluster_capacity(void (*kernel)(Params...), int cs, size_t smem, KernelAttrs* attrs) {
  if (!cluster_size_ok(cs) ||
      prepare_cluster_kernel(reinterpret_cast<const void*>(kernel), smem, attrs) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cs, cs, smem, nullptr, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return clusters;
}

// `blocks` blocks (a multiple of cs) in clusters of cs. Returns the launch's
// error (cleared), cudaSuccess on a launch.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int blocks, int cs, size_t smem,
                   KernelAttrs* attrs, cudaStream_t stream, Args&&... args) {
  if (!cluster_size_ok(cs) || blocks % cs) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare_cluster_kernel(reinterpret_cast<const void*>(kernel), smem, attrs);
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(blocks, cs, smem, stream, &attr);
    err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  }
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// The decode attention's K/V cache (attention below), in one of three
// layouts:
//   kJoinedScaled  [b, t, e] int16 with per-row (b, t) inverse scales kqi
//                  and vqi: score = ((K . q)_head * scale) * kqi + mask,
//                  p * vqi weighs V;
//   kJoinedFloat   [b, t, e] float, bf16 or fp16 (kqi and vqi unused): q
//                  and p are rounded to the cache's type first, as the TPU
//                  kernel's float branch does (_layer_math_bte);
//   kSplitFloat    [b, heads, t, d] float, bf16 or fp16 (decoder_layer_step's
//                  layout): nothing is rounded, score = (K . q)_head * scale
//                  + mask.
enum CacheLayout { kJoinedScaled, kJoinedFloat, kSplitFloat };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int16_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// x rounded to nearest even in T and back (f32: unchanged).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else if constexpr (std::is_same<T, __half>::value) {
    return __half2float(__float2half_rn(x));
  } else {
    return x;
  }
}

// Eight consecutive elements at `src` (aligned to their size times 8) as
// floats: one 16-byte load, two for float.
__device__ __forceinline__ void load8(const int16_t* src, float* out) {
  const int4 packed = __ldg(reinterpret_cast<const int4*>(src));
  const int words[4] = {packed.x, packed.y, packed.z, packed.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = static_cast<float>(static_cast<int16_t>(words[i] & 0xffff));
    out[2 * i + 1] = static_cast<float>(static_cast<int16_t>(words[i] >> 16));
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* out) {
  const int4 packed = __ldg(reinterpret_cast<const int4*>(src));
  const unsigned words[4] = {static_cast<unsigned>(packed.x), static_cast<unsigned>(packed.y),
                             static_cast<unsigned>(packed.z), static_cast<unsigned>(packed.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const __half* src, float* out) {
  const int4 packed = __ldg(reinterpret_cast<const int4*>(src));
  const __half2* pairs = reinterpret_cast<const __half2*>(&packed);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(pairs[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* src, float* out) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(src));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(src + 4));
  out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
  out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
}

template <typename T, CacheLayout L>
struct Cache {
  using Elem = T;
  const T* k;
  const T* v;
  const float* kqi;  // [b, t]; kJoinedScaled only
  const float* vqi;
  int t, e, d;

  // Offset of element (batch row b, position j, column c); the same
  // column of position j + 1 is step() elements on.
  __device__ long long at(int b, int j, int c) const {
    if constexpr (L == kSplitFloat) {
      const int h = c / d;
      return ((static_cast<long long>(b) * (e / d) + h) * t + j) * d + (c - h * d);
    } else {
      return (static_cast<long long>(b) * t + j) * e + c;
    }
  }
  __device__ int step() const { return L == kSplitFloat ? d : e; }
  __device__ float query(float q) const {
    if constexpr (L == kJoinedFloat) return round_to<T>(q);
    return q;
  }
  // The score before the mask; pos = b * t + j.
  __device__ float score(float s, float scale, long long pos) const {
    s = __fmul_rn(s, scale);
    if constexpr (L == kJoinedScaled) s = __fmul_rn(s, kqi[pos]);
    return s;
  }
  // The weight of V at pos for probability p.
  __device__ float weight(float p, long long pos) const {
    if constexpr (L == kJoinedScaled) return __fmul_rn(p, vqi[pos]);
    if constexpr (L == kJoinedFloat) return round_to<T>(p);
    return p;
  }
};

using JoinedInt16 = Cache<int16_t, kJoinedScaled>;
template <typename T>
using JoinedFloat = Cache<T, kJoinedFloat>;
template <typename T>
using SplitFloat = Cache<T, kSplitFloat>;

// Cross-attention of rows row0..row0+rows-1 at T_q = 1 over `cache` (see
// CacheLayout), for the heads h0, h0 + hstep, ... < heads (all by
// default): per head, s = the cache's score of (K . q) + mask, softmax
// over t, out = sum_t weight(p) V. q, out: [rows, e] in shared memory
// (only those heads' columns of out are written); sc: [rows, the heads
// taken, t]. attn0, if not null, receives the head-0 probabilities [b, t]
// (unrounded) where head 0 is taken. The head dim d = e / heads is a
// multiple of 8 up to 256. The rows of q and out are ld floats apart (0:
// e). Every sum runs in one order whatever the heads taken, so a head's
// output does not depend on which block computes it.
template <typename C>
__device__ void attention(const float* q, const C& cache,
                          const float* __restrict__ mask, int row0, int rows,
                          int heads, float scale, float* sc, float* out,
                          float* __restrict__ attn0, int h0 = 0, int hstep = 1,
                          int ld = 0) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = cache.t;
  const int e = ld > 0 ? ld : cache.e;
  const int d = cache.d;
  const int nh = h0 < heads ? (heads - h0 + hstep - 1) / hstep : 0;
  const int lanes_per_head = d / 8;  // a lane holds 8 elements of a head
  int group = 1;  // lanes a (row, position, head) takes: a power of two
  while (group < lanes_per_head) group *= 2;
  const int per_warp = 32 / group;
  // Scores: lanes_per_head lanes per (row, position, head), 8 elements a
  // lane, in a group of `group` lanes (the rest idle where d / 8 is no power
  // of two); a warp's lanes read neighbouring heads of one K row.
  const int items = rows * t * nh;
  for (int first = warp * per_warp; first < items; first += kWarps * per_warp) {
    const int item = first + lane / group;
    const int part = lane % group;
    const bool valid = item < items && part < lanes_per_head;
    const int hl = item % nh;
    const int rj = item / nh;
    const int r = rj / t;
    const int j = rj % t;
    const int base = (h0 + hl * hstep) * d + 8 * part;
    const long long pos = static_cast<long long>(row0 + r) * t + j;
    float s = 0.0f;
    if (valid) {
      float kv[8];
      load8(cache.k + cache.at(row0 + r, j, base), kv);
      const float* q_row = q + r * e;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        s = __fadd_rn(s, __fmul_rn(kv[i], cache.query(q_row[base + i])));
    }
    for (int offset = group / 2; offset > 0; offset /= 2)
      s += __shfl_xor_sync(0xffffffffu, s, offset);
    if (item < items && part == 0)
      sc[(r * nh + hl) * t + j] = __fadd_rn(cache.score(s, scale, pos), mask[pos]);
  }
  __syncthreads();
  // Softmax over t: a warp per (row, head); then the weights in place.
  for (int item = warp; item < rows * nh; item += kWarps) {
    float* s = sc + item * t;
    const int r = item / nh;
    const long long row_t = static_cast<long long>(row0 + r) * t;
    float m = -INFINITY;
    for (int j = lane; j < t; j += 32) m = fmaxf(m, s[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < t; j += 32) {
      const float p = expf(s[j] - m);
      s[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    const bool head0 = attn0 != nullptr && h0 + (item % nh) * hstep == 0;
    for (int j = lane; j < t; j += 32) {
      const float p = s[j] / sum;
      if (head0) attn0[row_t + j] = p;
      s[j] = cache.weight(p, row_t + j);
    }
  }
  __syncthreads();
  // out[r, c] = sum_t w[r, head(c), t] * V[row, t, c], a thread per (r, c).
  // (Issuing 32 positions' loads before their sums measured slower on the
  // H100: #10 at B=512 0.242 against 0.166 ms.)
  const int step = cache.step();
  for (int item = threadIdx.x; item < rows * nh * d; item += kThreads) {
    const int r = item / (nh * d);
    const int hl = item % (nh * d) / d;
    const int c = (h0 + hl * hstep) * d + item % d;
    const auto* v_col = cache.v + cache.at(row0 + r, 0, c);
    const float* p = sc + (r * nh + hl) * t;
    float acc = 0.0f;
    for (int j = 0; j < t; ++j) {
      const float vv = to_float(v_col[static_cast<long long>(j) * step]);
      acc = __fadd_rn(acc, __fmul_rn(vv, p[j]));
    }
    out[r * e + c] = acc;
  }
  __syncthreads();
}

// Raise a kernel's dynamic shared-memory cap to `bytes` once it exceeds
// the current one (48 KB without the attribute). `cap` is the kernel's
// own static.
template <typename Kernel>
cudaError_t ensure_smem(Kernel kernel, size_t bytes, size_t* cap) {
  if (bytes <= *cap) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *cap = bytes;
  return err;
}

// Attention of one head over a whole key sequence, in float32 on the CUDA
// cores, for the encoder's fused SDPA (joined [B*T, E] operands, #8, and
// inside the whole-layer kernel, #2) and blockwise attention (split [B, H,
// T, D] operands, #9):
//
//   out[b, h, i] = softmax_j((q_i . k_j) * scale + mask[b, j]) v      (rows i < t)
//
// Design. A block takes one (batch row, head) and kRows * R query rows; a
// thread owns R of them, each q row and its output accumulator in
// registers (read and written with 16-byte accesses). K, V and the mask
// stream through shared memory in tiles of kTile keys, double-buffered
// with cp.async (16 bytes a copy, zero-filled past t), so the next tile's
// loads overlap this tile's arithmetic. Every thread reads the same K or V
// row at once: a float4 broadcast from shared memory feeds 4 * R
// multiply-adds, where a load per multiply-add bounded the kernel this
// replaces. The softmax is online: a running max and sum per row, the
// accumulator rescaled when the max rises, so the [t, t] scores never leave
// registers. Scores are (q . k) * scale + mask in that order (no FMA
// contraction of the scale and the mask) and expf, as in the plain
// version; a padding row (every key at -99999999) stays finite, and keys
// past t are excluded.
//
// Occupancy on the H100 at D = 32 (32 threads a block, R = 2, 16-key
// tiles, 8.3 KB of shared memory): 235 registers a thread (ptxas), so 8
// blocks, 8 warps, an SM; each warp has 8 multiply-adds per broadcast
// to issue. At B = 512, T = 64 the grid is 4096 blocks, 3.9 waves of 132
// SMs x 8. At D = 64 (64 threads, R = 1): 217 registers, 4 blocks, 8
// warps.

// Float offsets of the operands: row i of head h of batch row b starts at
// b * batch + h * head + i * row.
struct HeadLayout {
  long long batch, head, row;
};

// The query rows of an attention launch: rows q0 .. q0 + tq - 1 of q (laid
// out by `lay`), written at the same rows of out. Sequence parallelism
// gives a rank T / seq query rows against all T keys; the encoder's own
// calls take every row (q0 = 0, tq = t, q laid out as K and V).
struct QueryRows {
  HeadLayout lay;
  int q0, tq;
};

// The weight slices (Slice) slice_of(0), slice_of(1), ... of a kernel's
// products, in the order the products take them, through a ring of
// `slots` (2 or 3) buffers of `slot` bytes in shared memory: cp.async
// copies (16 bytes, L2 to shared memory) run slots - 1 slices ahead of the
// product that reads one, so a product reads its weights from shared
// memory instead of waiting on a strided L2 load per weight quad. With
// slots = 0 the products read the slices in place. take(i) has a
// __syncthreads(): every thread calls it.
template <typename SliceOf>
struct WeightStream {
  SliceOf slice_of;
  int total;
  int8_t* base;
  int slots, slot;

  // Chunk (row k, group g) of a slice of `groups` groups and `quads`
  // quads of rows lands at [k % 4][g][k / 4] (Slab).
  __device__ void issue(int i) const {
    if (i < total) {
      const Slice s = slice_of(i);
      int8_t* dst = base + (i % slots) * slot;
      const int groups = s.width / 16;
      const int quads = s.rows / 4;
      for (int c = threadIdx.x; c < s.rows * groups; c += kThreads) {
        const int k = c / groups;
        const int g = c % groups;
        cp_async16(dst + 16 * ((k % 4 * groups + g) * quads + k / 4),
                   s.src + static_cast<long long>(k) * s.ld + 16 * g, true);
      }
    }
    cp_async_commit();  // one group a slice, empty past the end
  }

  __device__ void start() const {
    for (int i = 0; i < slots - 1; ++i) issue(i);
  }

  __device__ Slab take(int i) const {
    const Slice s = slice_of(i);
    if (slots == 0) return {s.src, 4 * s.ld, s.ld, 16, s.k_valid, s.n_valid};
    issue(i + slots - 1);  // into the buffer of slice i - 1, whose product is done
    if (slots == 3) {
      cp_async_wait<2>();
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();
    const int quads = s.rows / 4;
    return {base + (i % slots) * slot, 16, s.width * quads, 16 * quads};
  }
};

template <typename SliceOf>
__device__ WeightStream<SliceOf> weight_stream(SliceOf slice_of, int total, int8_t* base,
                                              int slots, int slot) {
  return {slice_of, total, base, slots, slot};
}

// Buffers of `slot` bytes a ring may take beside `rest` bytes of other
// shared memory within `cap`: 3, 2, or 0 (no ring).
__host__ __device__ constexpr int ring_slots(size_t slot, size_t rest, size_t cap) {
  return rest + 3 * slot <= cap ? 3 : rest + 2 * slot <= cap ? 2 : 0;
}

// Keys j0 .. j0 + kTile - 1 of one head into shared memory (zeros past t),
// as one cp.async group.
template <int D, int kRows, int kTile>
__device__ __forceinline__ void attention_stage(const float* k, const float* v,
                                                const float* mask_row, long long base,
                                                long long row, int t, int j0, float* k_s,
                                                float* v_s, float* m_s) {
  for (int i = threadIdx.x; i < kTile * D / 4; i += kRows) {
    const int key = i / (D / 4);
    const bool in = j0 + key < t;
    const long long off = base + (in ? j0 + key : 0) * row + 4 * (i % (D / 4));
    cp_async16(k_s + 4 * i, k + off, in);
    cp_async16(v_s + 4 * i, v + off, in);
  }
  for (int j = threadIdx.x; j < kTile; j += kRows)
    m_s[j] = j0 + j < t ? mask_row[j0 + j] : 0.0f;
  cp_async_commit();
}

// grid (batch * heads, ceil(qr.tq / (kRows * R))); mask [batch, t] over
// the t keys; q, k, v, out 16-byte aligned with every row start a multiple
// of 4 floats. A query row's arithmetic does not depend on qr: every row
// walks the same key tiles in the same order.
template <int D, int R, int kRows, int kTile>
__global__ void __launch_bounds__(kRows)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 float* __restrict__ out, int t, int heads, HeadLayout lay,
                 QueryRows qr_rows, float scale) {
  static_assert(D % 4 == 0, "rows are read as float4");
  __shared__ __align__(16) float k_s[2][kTile * D];
  __shared__ __align__(16) float v_s[2][kTile * D];
  __shared__ float m_s[2][kTile];
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const long long base = b * lay.batch + h * lay.head;
  const float* mask_row = mask + static_cast<long long>(b) * t;

  int rows[R];
  float qr[R][D];
  float acc[R][D];
  float run_max[R];
  float run_sum[R];
  const int row_end = qr_rows.q0 + qr_rows.tq;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    rows[r] = qr_rows.q0 + blockIdx.y * (kRows * R) + r * kRows + threadIdx.x;
    const float4* src = reinterpret_cast<const float4*>(
        q + b * qr_rows.lay.batch + h * qr_rows.lay.head + rows[r] * qr_rows.lay.row);
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      const float4 x = rows[r] < row_end ? __ldg(src + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      qr[r][4 * c] = x.x;
      qr[r][4 * c + 1] = x.y;
      qr[r][4 * c + 2] = x.z;
      qr[r][4 * c + 3] = x.w;
    }
#pragma unroll
    for (int c = 0; c < D; ++c) acc[r][c] = 0.0f;
    run_max[r] = -INFINITY;
    run_sum[r] = 0.0f;
  }

  attention_stage<D, kRows, kTile>(k, v, mask_row, base, lay.row, t, 0, k_s[0], v_s[0], m_s[0]);
  for (int j0 = 0, tile = 0; j0 < t; j0 += kTile, ++tile) {
    const int buf = tile & 1;
    if (j0 + kTile < t) {
      attention_stage<D, kRows, kTile>(k, v, mask_row, base, lay.row, t, j0 + kTile,
                                       k_s[buf ^ 1], v_s[buf ^ 1], m_s[buf ^ 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int keys = min(kTile, t - j0);
    const float4* kt = reinterpret_cast<const float4*>(k_s[buf]);
    const float4* vt = reinterpret_cast<const float4*>(v_s[buf]);
    float s[R][kTile];
    float tile_max[R];
#pragma unroll
    for (int r = 0; r < R; ++r) tile_max[r] = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dot[r] = 0.0f;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 x = kt[j * (D / 4) + c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          dot[r] = fmaf(qr[r][4 * c], x.x, dot[r]);
          dot[r] = fmaf(qr[r][4 * c + 1], x.y, dot[r]);
          dot[r] = fmaf(qr[r][4 * c + 2], x.z, dot[r]);
          dot[r] = fmaf(qr[r][4 * c + 3], x.w, dot[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r][j] = j < keys ? __fadd_rn(__fmul_rn(dot[r], scale), m_s[buf][j]) : -INFINITY;
        tile_max[r] = fmaxf(tile_max[r], s[r][j]);
      }
    }
    // tile_max is finite: a tile holds at least one key.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float new_max = fmaxf(run_max[r], tile_max[r]);
      const float alpha = expf(run_max[r] - new_max);  // 0 on the first tile
      run_sum[r] *= alpha;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[r][c] *= alpha;
      run_max[r] = new_max;
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float p[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        p[r] = expf(s[r][j] - run_max[r]);  // 0 past t
        run_sum[r] += p[r];
      }
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 x = vt[j * (D / 4) + c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r][4 * c] = fmaf(p[r], x.x, acc[r][4 * c]);
          acc[r][4 * c + 1] = fmaf(p[r], x.y, acc[r][4 * c + 1]);
          acc[r][4 * c + 2] = fmaf(p[r], x.z, acc[r][4 * c + 2]);
          acc[r][4 * c + 3] = fmaf(p[r], x.w, acc[r][4 * c + 3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (rows[r] >= row_end) continue;
    float4* dst = reinterpret_cast<float4*>(
        out + b * qr_rows.lay.batch + h * qr_rows.lay.head + rows[r] * qr_rows.lay.row);
#pragma unroll
    for (int c = 0; c < D / 4; ++c)
      dst[c] = make_float4(acc[r][4 * c] / run_sum[r], acc[r][4 * c + 1] / run_sum[r],
                           acc[r][4 * c + 2] / run_sum[r], acc[r][4 * c + 3] / run_sum[r]);
  }
}

template <int D, int R, int kRows, int kTile>
int launch_attention_config(const float* q, const float* k, const float* v,
                            const float* mask, float* out, int batch, int heads,
                            int t, HeadLayout lay, QueryRows rows, float scale,
                            cudaStream_t stream) {
  const dim3 grid(batch * heads, (rows.tq + kRows * R - 1) / (kRows * R));
  attention_kernel<D, R, kRows, kTile><<<grid, kRows, 0, stream>>>(
      q, k, v, mask, out, t, heads, lay, rows, scale);
  return static_cast<int>(cudaGetLastError());
}

// attention_kernel for head dim d in {8, 16, 32, 64}. Up to D = 32, 32
// threads a block with two query rows each and 16-key tiles; at D = 64,
// where two rows would spill, 64 threads with one row each (the fastest
// of the configurations timed on the H100 at T 16-256 and at T = 1024).
// This and launch_sdpa are templates so that only the sources that launch
// attention compile its kernels.
// `rows` picks the query rows (every row of a q laid out as K and V where
// the caller passes none).
template <int = 0>
int launch_attention(const float* q, const float* k, const float* v,
                     const float* mask, float* out, int batch, int heads, int t,
                     int d, HeadLayout lay, float scale, cudaStream_t stream,
                     QueryRows rows = {{0, 0, 0}, 0, -1}) {
  if (rows.tq < 0) rows = {lay, 0, t};
  if (rows.tq < 1 || rows.q0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 8: return launch_attention_config<8, 2, 32, 16>(q, k, v, mask, out, batch, heads, t, lay, rows, scale, stream);
    case 16: return launch_attention_config<16, 2, 32, 16>(q, k, v, mask, out, batch, heads, t, lay, rows, scale, stream);
    case 32: return launch_attention_config<32, 2, 32, 16>(q, k, v, mask, out, batch, heads, t, lay, rows, scale, stream);
    case 64: return launch_attention_config<64, 1, 64, 16>(q, k, v, mask, out, batch, heads, t, lay, rows, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Multi-head SDPA on joined [batch * t, e] operands, per head h of d = e /
// heads columns: out_h = softmax((q_h . k_h) * scale + mask) v_h. The
// whole-encoder-layer kernel (encoder_layer.cu) and the split encoder's
// fused SDPA (attention.cu) launch it.
template <int = 0>
int launch_sdpa(const float* q, const float* k, const float* v,
                const float* mask, float* out, int batch, int t, int e,
                int heads, float scale, cudaStream_t stream) {
  const int d = e / heads;
  const HeadLayout joined{static_cast<long long>(t) * e, d, e};
  return launch_attention(q, k, v, mask, out, batch, heads, t, d, joined, scale,
                          stream);
}

}  // namespace
}  // namespace slimt
