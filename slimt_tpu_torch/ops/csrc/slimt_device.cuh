// Device functions shared by the kernels: the whole decode step
// (decoder_step.cu), the SSRU and FFN blocks (fused_blocks.cu), the int16
// decode attention (decode_attn.cu), and the encoder SDPA of the
// whole-layer kernel (encoder_layer.cu) and of the split encoder
// (attention.cu).
//
// Every block runs kThreads threads. The int8 products are __dp4a over
// int32 accumulators (exact); the epilogues round the multiply and the
// add separately (__fmul_rn, __fadd_rn), and q8 is rintf (half to even)
// clipped to +-127, as in qmm_affine.cu. Each TU gets its own copy (an
// anonymous namespace), so no relocatable device code is needed.
#pragma once

#include <cmath>
#include <cstdint>

namespace slimt {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 4;  // rows a matvec carries
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

// xq[r * ldq + k] = q8(x[r * ldx + k]) for r < rows, k < k_dim.
__device__ void quantize_rows(const float* x, int ldx, int k_dim, float aq,
                              int8_t* xq, int ldq, int rows) {
  for (int i = threadIdx.x; i < rows * k_dim; i += kThreads) {
    const int r = i / k_dim;
    const int k = i % k_dim;
    xq[r * ldq + k] = quant8(x[r * ldx + k], aq);
  }
  __syncthreads();
}

// out[r * ldo + n] = acc * inv (+ bias[n]) (relu), acc = sum_k xq[r, k] *
// w[k, n], for r < rows <= kMaxRows. w is row-major [k_dim, n_cols] int8,
// 16-byte aligned, n_cols % 16 == 0, k_dim % 4 == 0; ldq % 4 == 0. A
// thread owns 16 columns and a slice of k (ks lanes per column group,
// reduced by shuffles).
__device__ void matvec(const int8_t* xq, int ldq, int rows,
                       const int8_t* __restrict__ w, int k_dim, int n_cols,
                       float inv, const float* __restrict__ bias, bool relu,
                       float* out, int ldo) {
  const int groups = n_cols / 16;
  int ks = 16;
  while (ks > 1 && groups * ks > kThreads) ks /= 2;
  const int lane_k = threadIdx.x % ks;
  const int per_pass = kThreads / ks;
  const int passes = (groups + per_pass - 1) / per_pass;
  const int quads = k_dim / 4;
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
      const int8_t* col = w + 16 * g;
#pragma unroll 2
      for (int kq = lane_k; kq < quads; kq += ks) {
        const int8_t* src = col + static_cast<long long>(4 * kq) * n_cols;
        const int4 a0 = __ldg(reinterpret_cast<const int4*>(src));
        const int4 a1 = __ldg(reinterpret_cast<const int4*>(src + n_cols));
        const int4 a2 = __ldg(reinterpret_cast<const int4*>(src + 2 * n_cols));
        const int4 a3 = __ldg(reinterpret_cast<const int4*>(src + 3 * n_cols));
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
    for (int offset = ks / 2; offset > 0; offset /= 2) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], offset);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (j % ks != lane_k) continue;
            const int n = 16 * g + j;
            float v = __fmul_rn(__int2float_rn(acc[r][j]), inv);
            if (bias != nullptr) v = __fadd_rn(v, bias[n]);
            if (relu) v = fmaxf(v, 0.0f);
            out[r * ldo + n] = v;
          }
        }
      }
    }
  }
  __syncthreads();
}

// out[r] = LN(a[r] + b[r]) * gamma + beta for r < rows, one warp per row
// of e; out may alias a or b.
__device__ void add_layer_norm(const float* a, const float* b,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta, float* out,
                               int rows, int e) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const float* pa = a + r * e;
    const float* pb = b + r * e;
    float* po = out + r * e;
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
      po[i] = __fadd_rn(__fmul_rn(__fmul_rn(c, inv), gamma[i]), beta[i]);
    }
  }
  __syncthreads();
}

// Cross-attention of rows row0..row0+rows-1 at T_q = 1 over the joined
// int16 cache [b, t, e]: score = ((K . q)_head * scale) * kqi + mask,
// softmax over t, out = sum_t (p * vqi) V. q, out: [rows, e] in shared
// memory; sc: [rows, heads, t]. attn0, if not null, receives the head-0
// probabilities [b, t]. e % 256 == 0; the head dim d = e / heads is a
// multiple of 8 with d / 8 a power of two <= 32.
__device__ void attention(const float* q, const int16_t* __restrict__ k,
                          const int16_t* __restrict__ v,
                          const float* __restrict__ kqi,
                          const float* __restrict__ vqi,
                          const float* __restrict__ mask, int row0, int rows,
                          int t, int e, int heads, float scale, float* sc,
                          float* out, float* __restrict__ attn0) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d = e / heads;
  const int lanes_per_head = d / 8;  // a lane holds 8 elements of a head
  // Scores: a warp per (row, position) reads that K row, 16 bytes a lane.
  for (int item = warp; item < rows * t; item += kWarps) {
    const int r = item / t;
    const int j = item % t;
    const long long pos = static_cast<long long>(row0 + r) * t + j;
    const int16_t* k_row = k + pos * e;
    const float* q_row = q + r * e;
    for (int c0 = 0; c0 < e; c0 += 256) {
      const int base = c0 + 8 * lane;
      const int4 packed = __ldg(reinterpret_cast<const int4*>(k_row + base));
      const int words[4] = {packed.x, packed.y, packed.z, packed.w};
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lo = static_cast<float>(static_cast<int16_t>(words[i] & 0xffff));
        const float hi = static_cast<float>(static_cast<int16_t>(words[i] >> 16));
        s = __fadd_rn(s, __fmul_rn(lo, q_row[base + 2 * i]));
        s = __fadd_rn(s, __fmul_rn(hi, q_row[base + 2 * i + 1]));
      }
      for (int offset = lanes_per_head / 2; offset > 0; offset /= 2)
        s += __shfl_xor_sync(0xffffffffu, s, offset);
      if (lane % lanes_per_head == 0) {
        float score = __fmul_rn(__fmul_rn(s, scale), kqi[pos]);
        score = __fadd_rn(score, mask[pos]);
        sc[(r * heads + base / d) * t + j] = score;
      }
    }
  }
  __syncthreads();
  // Softmax over t: a warp per (row, head); then p * vqi in place.
  for (int item = warp; item < rows * heads; item += kWarps) {
    float* s = sc + item * t;
    const int r = item / heads;
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
    const bool head0 = attn0 != nullptr && item % heads == 0;
    for (int j = lane; j < t; j += 32) {
      const float p = s[j] / sum;
      if (head0) attn0[row_t + j] = p;
      s[j] = __fmul_rn(p, vqi[row_t + j]);
    }
  }
  __syncthreads();
  // out[r, c] = sum_t p[r, head(c), t] * V[row, t, c].
  for (int item = threadIdx.x; item < rows * e; item += kThreads) {
    const int r = item / e;
    const int c = item % e;
    const int16_t* v_col = v + static_cast<long long>(row0 + r) * t * e + c;
    const float* p = sc + (r * heads + c / d) * t;
    float acc = 0.0f;
    for (int j = 0; j < t; ++j) {
      const float vv = static_cast<float>(v_col[static_cast<long long>(j) * e]);
      acc = __fadd_rn(acc, __fmul_rn(vv, p[j]));
    }
    out[item] = acc;
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

// Multi-head SDPA on joined [batch * t, e] operands, per head h of
// d = e / heads columns: out_h = softmax((q_h . k_h) * scale + mask) v_h.
// The whole-encoder-layer kernel (encoder_layer.cu) and the split
// encoder's fused SDPA (attention.cu) launch it.
constexpr int kSdpaWarps = 4;

// Shared memory: K and V [t, d + 1] (padded against bank conflicts), the
// row's mask [t], and per warp a query [d] and probabilities [t].
size_t sdpa_smem_bytes(int t, int d) {
  return sizeof(float) *
         (2 * static_cast<size_t>(t) * (d + 1) + t + kSdpaWarps * (d + t));
}

// grid (heads, batch); q, k, v, out are row-major [batch * t, e].
__global__ void __launch_bounds__(kSdpaWarps * 32)
sdpa_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ mask,
            float* __restrict__ out, int t, int e, int d, float scale) {
  extern __shared__ float sdpa_buf[];  // named apart from the other kernels' buffers
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int ld = d + 1;
  float* k_s = sdpa_buf;
  float* v_s = k_s + t * ld;
  float* m_s = v_s + t * ld;
  float* q_s = m_s + t + warp * d;
  float* p_s = m_s + t + kSdpaWarps * d + warp * t;
  const long long base = static_cast<long long>(b) * t * e + h * d;

  for (int i = threadIdx.x; i < t * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i % d;
    k_s[r * ld + c] = k[base + static_cast<long long>(r) * e + c];
    v_s[r * ld + c] = v[base + static_cast<long long>(r) * e + c];
  }
  for (int j = threadIdx.x; j < t; j += blockDim.x) m_s[j] = mask[b * t + j];
  __syncthreads();

  for (int qi = warp; qi < t; qi += kSdpaWarps) {
    const float* q_row = q + base + static_cast<long long>(qi) * e;
    for (int c = lane; c < d; c += 32) q_s[c] = q_row[c];
    __syncwarp();
    float row_max = -INFINITY;
    for (int j = lane; j < t; j += 32) {
      float dot = 0.0f;
      for (int c = 0; c < d; ++c) dot = fmaf(q_s[c], k_s[j * ld + c], dot);
      const float s = __fadd_rn(__fmul_rn(dot, scale), m_s[j]);
      p_s[j] = s;
      row_max = fmaxf(row_max, s);
    }
    row_max = warp_max(row_max);
    float row_sum = 0.0f;
    for (int j = lane; j < t; j += 32) {
      const float p = expf(p_s[j] - row_max);
      p_s[j] = p;
      row_sum += p;
    }
    row_sum = warp_sum(row_sum);
    for (int j = lane; j < t; j += 32) p_s[j] = p_s[j] / row_sum;
    __syncwarp();
    float* o_row = out + base + static_cast<long long>(qi) * e;
    for (int c = lane; c < d; c += 32) {
      float o = 0.0f;
      for (int j = 0; j < t; ++j) o = fmaf(p_s[j], v_s[j * ld + c], o);
      o_row[c] = o;
    }
    __syncwarp();
  }
}

int launch_sdpa(const float* q, const float* k, const float* v,
                const float* mask, float* out, int batch, int t, int e,
                int heads, float scale, cudaStream_t stream) {
  const int d = e / heads;
  const size_t smem = sdpa_smem_bytes(t, d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sdpa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sdpa_kernel<<<dim3(heads, batch), kSdpaWarps * 32, smem, stream>>>(
      q, k, v, mask, out, t, e, d, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace slimt
