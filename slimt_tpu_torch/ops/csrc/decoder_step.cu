// Whole greedy decode step: every decoder layer, the tied int8
// projection and the exact first-max argmax.
//
// Replaces slimt_tpu/ops/decoder_step_pallas.py:whole_decode_step (bodies
// _whole_kernel and _layer_math_bte), the step of the fused_step latency
// provider. Per batch row, for each layer l:
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
// the last layer. K and V are the joined [B, T, E] int16 per-row cache.
//
// Design. The TPU kernel walks a sequential (row tile, vocab tile) grid
// and carries the running (max, index) across vocab tiles; CUDA blocks
// run in no order, so one step is three launches from one C entry:
//   1. layers: one block per tile of 1 or 4 rows runs every layer with
//      the activations in shared memory (the FFN hidden row included);
//      K and V stream through the attention loop from device memory;
//   2. project: a block per (vocab tile of 256 columns, 16 rows) writes
//      its tile's first maximum per row;
//   3. pick: per row, the tiles in ascending order with a strict >.
// The int8 products are __dp4a over int32 accumulators (exact); the
// epilogues round the multiply and the add separately (__fmul_rn,
// __fadd_rn), and q8 is rintf (half to even) clipped to +-127, as in
// qmm_affine.cu, so the projection stage is bit-equal to its plain
// version given the same input rows. W_out may be any strided [E, S]
// view: the full vocabulary is the transposed [V, E] embedding, read
// 16 bytes at a time down its contiguous E axis.
//
// Bounds on the H100. At B = 1 a step reads about 2 MB of decoder
// weights (E = 256, F = 1536, two layers) and the 8.2 MB full-vocab
// projection, all of which fit in the 50 MB L2; the attention reads
// 2 * T * E * 2 bytes of cache per layer and row. The projection spreads
// over 125 blocks; the layers run on one SM per row tile, so at small B
// their time is one SM's L2 read rate and its __dp4a rate, and one
// persistent multi-block launch is the later design.

#include <cmath>
#include <cstdint>

#include "slimt_kernels.cuh"

namespace slimt {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 4;        // rows of a layers block
constexpr int kMaxLayers = 8;
constexpr int kLayerPtrs = 21;
constexpr int kLayerScales = 12;
constexpr int kProjCols = 256;     // vocab columns of a projection block
constexpr int kProjRows = 16;      // rows of a projection block
constexpr int kMaxEmb = 512;
constexpr float kLnEps = 1e-6f;

// Per-layer pointers, in order: wf, bf, w, ln_rnn scale, ln_rnn bias,
// wq, bq, wo, bo, ln_att scale, ln_att bias, w1, b1, w2, b2,
// ln_ffn scale, ln_ffn bias, k, v, kqi, vqi. Scales: aq and inv of wf,
// w, wq, wo, w1, w2.
struct StepParams {
  const void* layer[kMaxLayers][kLayerPtrs];
  float scale[kMaxLayers][kLayerScales];
  const float* mask;  // [b, t] additive
  int layers, b, t, e, f, heads, rows;
  float att_scale;
};

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
// w[k, n], for r < rows. w is row-major [k_dim, n_cols] int8, 16-byte
// aligned, n_cols % 16 == 0, k_dim % 4 == 0. A thread owns 16 columns and
// a slice of k (ks lanes per column group, reduced by shuffles).
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
// int16 cache. q, out: [rows, e] in shared memory; sc: [rows, heads, t].
// attn0, if not null, receives the head-0 probabilities [b, t].
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

size_t layers_smem_bytes(int rows, int e, int f, int heads, int t) {
  const size_t floats = static_cast<size_t>(rows) *
                        (4 * static_cast<size_t>(e) + f +
                         static_cast<size_t>(heads) * t);
  return sizeof(float) * floats + static_cast<size_t>(rows) * (e > f ? e : f);
}

// Every decoder layer for one tile of p.rows rows. x: [b, e]; c_in,
// c_out: [layers, b, e]; attn0: [b, t]; h_out: [b, e], the last layer's
// output, which the projection reads.
__global__ void __launch_bounds__(kThreads)
layers_kernel(const __grid_constant__ StepParams p, const float* __restrict__ x,
              const float* __restrict__ c_in, float* __restrict__ c_out,
              float* __restrict__ attn0, float* __restrict__ h_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int e = p.e;
  const int f = p.f;
  const int cap = p.rows;
  const int row0 = blockIdx.x * cap;
  const int rows = min(cap, p.b - row0);
  const int ldq = e > f ? e : f;
  float* buf_a = reinterpret_cast<float*>(smem);
  float* buf_b = buf_a + cap * e;
  float* buf_c = buf_b + cap * e;
  float* buf_d = buf_c + cap * e;
  float* hidden = buf_d + cap * e;
  float* sc = hidden + cap * f;
  int8_t* xq = reinterpret_cast<int8_t*>(sc + cap * p.heads * p.t);
  const long long layer_stride = static_cast<long long>(p.b) * e;
  const long long tile0 = static_cast<long long>(row0) * e;

  for (int i = threadIdx.x; i < rows * e; i += kThreads) buf_a[i] = x[tile0 + i];
  __syncthreads();
  for (int l = 0; l < p.layers; ++l) {
    const void* const* w = p.layer[l];
    const float* s = p.scale[l];
    auto i8 = [&](int i) { return static_cast<const int8_t*>(w[i]); };
    auto f32 = [&](int i) { return static_cast<const float*>(w[i]); };

    // SSRU: buf_a = x; buf_c = f (pre-activation); buf_d = W x.
    quantize_rows(buf_a, e, e, s[0], xq, ldq, rows);
    matvec(xq, ldq, rows, i8(0), e, e, s[1], f32(1), false, buf_c, e);
    quantize_rows(buf_a, e, e, s[2], xq, ldq, rows);
    matvec(xq, ldq, rows, i8(2), e, e, s[3], nullptr, false, buf_d, e);
    const float* c_prev = c_in + l * layer_stride + tile0;
    float* c_next = c_out + l * layer_stride + tile0;
    for (int i = threadIdx.x; i < rows * e; i += kThreads) {
      const float gate = 1.0f / (1.0f + expf(-buf_c[i]));
      const float c_t = __fadd_rn(__fmul_rn(gate, c_prev[i]),
                                  __fmul_rn(1.0f - gate, buf_d[i]));
      c_next[i] = c_t;
      buf_d[i] = fmaxf(c_t, 0.0f);
    }
    __syncthreads();
    add_layer_norm(buf_a, buf_d, f32(3), f32(4), buf_b, rows, e);  // h

    // Cross-attention: buf_c = q, buf_d = attention output.
    quantize_rows(buf_b, e, e, s[4], xq, ldq, rows);
    matvec(xq, ldq, rows, i8(5), e, e, s[5], f32(6), false, buf_c, e);
    attention(buf_c, static_cast<const int16_t*>(w[17]),
              static_cast<const int16_t*>(w[18]), f32(19), f32(20), p.mask,
              row0, rows, p.t, e, p.heads, p.att_scale, sc, buf_d,
              l == p.layers - 1 ? attn0 : nullptr);
    quantize_rows(buf_d, e, e, s[6], xq, ldq, rows);
    matvec(xq, ldq, rows, i8(7), e, e, s[7], f32(8), false, buf_c, e);
    add_layer_norm(buf_b, buf_c, f32(9), f32(10), buf_a, rows, e);  // a

    // FFN: buf_a = LN(a + W2 relu(W1 a)).
    quantize_rows(buf_a, e, e, s[8], xq, ldq, rows);
    matvec(xq, ldq, rows, i8(11), e, f, s[9], f32(12), true, hidden, f);
    quantize_rows(hidden, f, f, s[10], xq, ldq, rows);
    matvec(xq, ldq, rows, i8(13), f, e, s[11], f32(14), false, buf_c, e);
    add_layer_norm(buf_c, buf_a, f32(15), f32(16), buf_a, rows, e);
  }
  for (int i = threadIdx.x; i < rows * e; i += kThreads) h_out[tile0 + i] = buf_a[i];
}

// Tile blockIdx.x of kProjCols columns for rows blockIdx.y * kProjRows..:
// logits = q8(y) W inv + b, and per row the first maximum of the tile
// into part_val / part_idx [b, tiles]. Columns >= s are -inf.
__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ y, const int8_t* __restrict__ w,
               const float* __restrict__ bias, int b, int e, int s,
               long long sk, long long sn, int vector_loads, float aq,
               float inv, int tiles, float* __restrict__ part_val,
               int* __restrict__ part_idx) {
  __shared__ __align__(16) int8_t xq[kProjRows * kMaxEmb];
  __shared__ float warp_val[kWarps];
  __shared__ int warp_idx[kWarps];
  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * kProjRows;
  const int rows = min(kProjRows, b - row0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < rows * e; i += kThreads)
    xq[i] = quant8(y[static_cast<long long>(row0) * e + i], aq);
  __syncthreads();

  const int n = tile * kProjCols + threadIdx.x;
  int acc[kProjRows];
#pragma unroll
  for (int r = 0; r < kProjRows; ++r) acc[r] = 0;
  if (n < s) {
    const int8_t* col = w + static_cast<long long>(n) * sn;
    if (vector_loads) {  // sk == 1: the column is 16-byte aligned bytes
      for (int k0 = 0; k0 < e; k0 += 16) {
        const int4 wv = __ldg(reinterpret_cast<const int4*>(col + k0));
#pragma unroll
        for (int r = 0; r < kProjRows; ++r) {
          if (r < rows) {
            const int4 xv = *reinterpret_cast<const int4*>(xq + r * e + k0);
            acc[r] = __dp4a(xv.x, wv.x, acc[r]);
            acc[r] = __dp4a(xv.y, wv.y, acc[r]);
            acc[r] = __dp4a(xv.z, wv.z, acc[r]);
            acc[r] = __dp4a(xv.w, wv.w, acc[r]);
          }
        }
      }
    } else {
      for (int k0 = 0; k0 < e; k0 += 4) {
        unsigned packed = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned byte = static_cast<uint8_t>(col[(k0 + j) * sk]);
          packed |= byte << (8 * j);
        }
#pragma unroll
        for (int r = 0; r < kProjRows; ++r) {
          if (r < rows) {
            const int xw = reinterpret_cast<const int*>(xq + r * e)[k0 / 4];
            acc[r] = __dp4a(xw, static_cast<int>(packed), acc[r]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kProjRows; ++r) {
    if (r >= rows) break;
    float v = -INFINITY;
    int idx = n;
    if (n < s) v = __fadd_rn(__fmul_rn(__int2float_rn(acc[r]), inv), bias[n]);
    // First maximum: larger value, or equal value and smaller column.
    for (int offset = 16; offset > 0; offset /= 2) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, offset);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, offset);
      if (ov > v || (ov == v && oi < idx)) {
        v = ov;
        idx = oi;
      }
    }
    if (lane == 0) {
      warp_val[warp] = v;
      warp_idx[warp] = idx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float best = warp_val[0];
      int best_idx = warp_idx[0];
      for (int i = 1; i < kWarps; ++i) {
        if (warp_val[i] > best ||
            (warp_val[i] == best && warp_idx[i] < best_idx)) {
          best = warp_val[i];
          best_idx = warp_idx[i];
        }
      }
      const long long out = static_cast<long long>(row0 + r) * tiles + tile;
      part_val[out] = best;
      part_idx[out] = best_idx;
    }
    __syncthreads();
  }
}

// choice[row] = the index of the first tile maximum that no later tile
// beats strictly: jnp.argmax's first-maximum rule across tiles.
__global__ void pick_kernel(const float* __restrict__ part_val,
                            const int* __restrict__ part_idx, int b,
                            int tiles, int* __restrict__ choice) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= b) return;
  const long long base = static_cast<long long>(row) * tiles;
  float best = part_val[base];
  int idx = part_idx[base];
  for (int j = 1; j < tiles; ++j) {
    if (part_val[base + j] > best) {
      best = part_val[base + j];
      idx = part_idx[base + j];
    }
  }
  choice[row] = idx;
}

int launch_argmax(const float* y, const int8_t* w, const float* bias,
                  int* choice, float* part, int b, int e, int s, long long sk,
                  long long sn, float aq, float inv, cudaStream_t stream) {
  if (b <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (e % 16 || e > kMaxEmb) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (s + kProjCols - 1) / kProjCols;
  const int vector_loads = sk == 1 && sn % 16 == 0 &&
                           reinterpret_cast<uintptr_t>(w) % 16 == 0;
  float* part_val = part;
  int* part_idx = reinterpret_cast<int*>(part + static_cast<long long>(b) * tiles);
  const dim3 grid(tiles, (b + kProjRows - 1) / kProjRows);
  project_kernel<<<grid, kThreads, 0, stream>>>(y, w, bias, b, e, s, sk, sn,
                                                vector_loads, aq, inv, tiles,
                                                part_val, part_idx);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  pick_kernel<<<(b + 127) / 128, 128, 0, stream>>>(part_val, part_idx, b,
                                                   tiles, choice);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace slimt

// ptrs:   layers * 21 per-layer pointers (order of StepParams), then
//         W_out, b_out and the [b, t] mask (device pointers);
// scales: aq and inv of wf, w, wq, wo, w1, w2 per layer, then aq_out and
//         inv_out (host floats);
// x [b, e], c_in and c_out [layers, b, e], attn0 [b, t] f32, choice [b]
// s32; scratch: b * e + 2 * b * ceil(s / 256) floats of device memory.
extern "C" int slimt_whole_decode_step(
    const void* ptrs_, const void* scales_, int layers, int b, int t, int e,
    int f, int heads, int s, long long sk, long long sn, int rows,
    const void* x, const void* c_in, void* c_out, void* attn0, void* choice,
    void* scratch, void* stream_) {
  using namespace slimt;
  if (layers < 1 || layers > kMaxLayers || rows < 1 || rows > kMaxRows ||
      b < 1 || t < 1 || e % 256 || f % 16 || heads < 1 || e % heads ||
      (e / heads) % 8 || e / heads > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const* ptrs = static_cast<const void* const*>(ptrs_);
  const float* scales = static_cast<const float*>(scales_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  StepParams p = {};
  for (int l = 0; l < layers; ++l) {
    for (int i = 0; i < kLayerPtrs; ++i) p.layer[l][i] = ptrs[l * kLayerPtrs + i];
    for (int i = 0; i < kLayerScales; ++i)
      p.scale[l][i] = scales[l * kLayerScales + i];
  }
  const void* const* tail = ptrs + layers * kLayerPtrs;
  p.mask = static_cast<const float*>(tail[2]);
  p.layers = layers;
  p.b = b;
  p.t = t;
  p.e = e;
  p.f = f;
  p.heads = heads;
  p.rows = rows;
  p.att_scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(e / heads)));

  const size_t smem = layers_smem_bytes(rows, e, f, heads, t);
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        layers_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  float* h = static_cast<float*>(scratch);
  layers_kernel<<<(b + rows - 1) / rows, kThreads, smem, stream>>>(
      p, static_cast<const float*>(x), static_cast<const float*>(c_in),
      static_cast<float*>(c_out), static_cast<float*>(attn0), h);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  const float* out_scales = scales + layers * kLayerScales;
  return launch_argmax(h, static_cast<const int8_t*>(tail[0]),
                       static_cast<const float*>(tail[1]),
                       static_cast<int*>(choice),
                       h + static_cast<long long>(b) * e, b, e, s, sk, sn,
                       out_scales[0], out_scales[1], stream);
}

// The projection stage alone: choice[b] = first argmax over n < s of
// q8(y[b]) W[:, n] inv + bias[n]. scratch: 2 * b * ceil(s / 256) floats.
extern "C" int slimt_argmax_affine(const void* y, const void* w,
                                   const void* bias, void* choice,
                                   void* scratch, int b, int e, int s,
                                   long long sk, long long sn, float aq,
                                   float inv, void* stream) {
  return slimt::launch_argmax(
      static_cast<const float*>(y), static_cast<const int8_t*>(w),
      static_cast<const float*>(bias), static_cast<int*>(choice),
      static_cast<float*>(scratch), b, e, s, sk, sn, aq, inv,
      static_cast<cudaStream_t>(stream));
}
