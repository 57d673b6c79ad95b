// int8 affine: quantize -> s8 x s8 -> s32 GEMM -> dequantize + bias.
//
// Replaces slimt_tpu/ops/qmm_pallas.py:_affine_kernel (the function of
// every int8 product of the declared xla_int8 provider):
//
//   acc[m, n] = sum_k clip(rint(x[m, k] * aq), +-127) * w[k, n]   (s32)
//   y[m, n]   = acc[m, n] * inv + b[n],  inv = 1 / (aq * bq)
//
// with an optional relu (FFN1) and a raw s32 mode without epilogue (the
// packed_int argmax compares accumulators).
//
// Design. A block owns a 64 x 64 output tile and walks K in chunks of
// 64. It quantizes its x rows while loading them, so int8 activations
// never reach device memory, packs four k values per 32-bit word in
// shared memory, and accumulates with __dp4a (s8 x s8 -> s32, exact).
// W comes with explicit strides: the tied output projection reads the
// [V, E] embedding as its transpose without a copy. Ragged M, N and K
// edges are masked with zeros.
//
// Bounds on the H100: at the encoder's shapes (M = B*T rows, K, N <=
// 2048) the kernel is bound by __dp4a issue on the CUDA cores, far below
// the int8 tensor-core rate; at decode shapes (M = B) it is bound by
// reading W. An mma/wgmma tiling is later work.
//
// Numerics match the XLA path bit for bit: the quantize multiply and the
// epilogue multiply and add are rounded separately (__fmul_rn,
// __fadd_rn: no FMA contraction), rintf rounds half to even like
// jnp.rint, and integer accumulation is exact.

#include "slimt_kernels.cuh"

namespace slimt {
namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;          // int8 k values per chunk
constexpr int kKP = kBK / 4;     // packed 32-bit words per chunk row
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ unsigned quant8(float v, float aq) {
  float r = rintf(__fmul_rn(v, aq));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<unsigned>(static_cast<int>(r)) & 0xffu;
}

__global__ void __launch_bounds__(kThreads)
affine_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ y_f32,
              int* __restrict__ y_s32, int m, int k, int n, long long sk,
              long long sn, float aq, float inv, int mode) {
  __shared__ int a_s[kBM][kKP + 1];
  __shared__ int b_s[kBN][kKP + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  // Neighbouring threads walk W's contiguous axis while loading.
  const bool n_contiguous = sn == 1;
  int acc[4][4] = {};

  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int i = tid; i < kBM * kKP; i += kThreads) {
      const int r = i / kKP;
      const int p = i % kKP;
      const int gr = row0 + r;
      const int gk = k0 + 4 * p;
      unsigned packed = 0;
      if (gr < m) {
        const float* src = x + static_cast<long long>(gr) * k;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (gk + j < k) packed |= quant8(src[gk + j], aq) << (8 * j);
        }
      }
      a_s[r][p] = static_cast<int>(packed);
    }
    for (int i = tid; i < kBN * kKP; i += kThreads) {
      const int c = n_contiguous ? i % kBN : i / kKP;
      const int p = n_contiguous ? i / kBN : i % kKP;
      const int gn = col0 + c;
      const int gk = k0 + 4 * p;
      unsigned packed = 0;
      if (gn < n) {
        const int8_t* src = w + static_cast<long long>(gn) * sn;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (gk + j < k) {
            const unsigned byte =
                static_cast<uint8_t>(src[static_cast<long long>(gk + j) * sk]);
            packed |= byte << (8 * j);
          }
        }
      }
      b_s[c][p] = static_cast<int>(packed);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kKP; ++p) {
      int a[4];
      int b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[ty + 16 * i][p];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[tx + 16 * j][p];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= n) continue;
      const long long out = static_cast<long long>(r) * n + c;
      if (mode == kAccumulator) {
        y_s32[out] = acc[i][j];
        continue;
      }
      float v = __fmul_rn(__int2float_rn(acc[i][j]), inv);
      if (bias != nullptr) v = __fadd_rn(v, bias[c]);
      if (mode == kAffineRelu) v = fmaxf(v, 0.0f);
      y_f32[out] = v;
    }
  }
}

}  // namespace

int launch_affine(const float* x, const int8_t* w, const float* bias, void* y,
                  int m, int k, int n, long long w_stride_k,
                  long long w_stride_n, float aq, float inv, int mode,
                  cudaStream_t stream) {
  if (m > 0 && n > 0) {
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    float* y_f32 = mode == kAccumulator ? nullptr : static_cast<float*>(y);
    int* y_s32 = mode == kAccumulator ? static_cast<int*>(y) : nullptr;
    affine_kernel<<<grid, kThreads, 0, stream>>>(x, w, bias, y_f32, y_s32, m,
                                                 k, n, w_stride_k, w_stride_n,
                                                 aq, inv, mode);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slimt

extern "C" int slimt_affine(const void* x, const void* w, const void* bias,
                            void* y, int m, int k, int n, long long w_stride_k,
                            long long w_stride_n, float aq, float inv,
                            int mode, void* stream) {
  return slimt::launch_affine(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(bias), y, m, k, n, w_stride_k, w_stride_n, aq,
      inv, mode, static_cast<cudaStream_t>(stream));
}

extern "C" const char* slimt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
