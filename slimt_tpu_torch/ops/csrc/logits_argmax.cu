// The int8 tied projection with its greedy argmax, without writing the
// logits to device memory.
//
// Replaces slimt_tpu/ops/logits_argmax.py:_kernel (entries _argmax_2d,
// argmax_affine). Per row of y and column n < s of W:
//
//   logit = q8(y) W[:, n] inv + bias[n]
//   exact:        choice = the first index of the maximum logit;
//   packed_fp16 / packed_bf16: the logit rounds half to even to 16 bits;
//                 key = ((sortable(bits) - 0x8000) << 16) | (0xFFFF - n)
//                 choice = 0xFFFF - (max key & 0xFFFF)
//
// the packed key exactly as transformer.packed_argmax_16 builds it
// (s <= 65536 there). The TPU kernel walks a sequential vocab-tile grid
// and carries the running best in VMEM; CUDA blocks run in no order, so
// a block per (vocab tile of 256 columns, 16 rows) writes its tile's
// best, and a pick kernel per row reduces the tiles: in ascending order
// with a strict > for exact (jnp.argmax's first maximum), and as one s32
// max for the packed keys (free of order, the reversed column breaks
// ties). Columns >= s never win.
//
// Bounds on the H100. At B <= 16 one step reads W once: E * S bytes
// (8.2 MB for the 32k vocabulary at E = 256, L2-resident across steps),
// spread over ceil(S / 256) blocks; each thread owns one column, reads it
// 16 bytes at a time down the embedding's contiguous E axis and issues
// E / 4 __dp4a per row. Larger B re-reads W once per 16 rows.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "slimt_device.cuh"
#include "slimt_kernels.cuh"

namespace slimt {
namespace {

constexpr int kProjCols = 256;  // vocab columns of a projection block
constexpr int kProjRows = 16;   // rows of a projection block
constexpr int kMaxEmb = 512;

// The packed key of one logit (see the header comment).
__device__ __forceinline__ int packed_key(float v, int n, int mode) {
  const unsigned bits =
      mode == kArgmaxFp16
          ? static_cast<unsigned>(__half_as_ushort(__float2half_rn(v)))
          : static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
  const unsigned sortable = bits >= 0x8000u ? 0xFFFFu - bits : bits | 0x8000u;
  return static_cast<int>(((sortable - 0x8000u) << 16) |
                          (0xFFFFu - static_cast<unsigned>(n)));
}

// Tile blockIdx.x of kProjCols columns for rows blockIdx.y * kProjRows..:
// exact writes per row the tile's first maximum into part_val / part_idx
// [b, tiles]; the packed modes write the tile's largest key to part_idx.
__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ y, const int8_t* __restrict__ w,
               const float* __restrict__ bias, int b, int e, int s,
               long long sk, long long sn, int vector_loads, float aq,
               float inv, int mode, int tiles, float* __restrict__ part_val,
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
    const long long out = static_cast<long long>(row0 + r) * tiles + tile;
    float v = -INFINITY;
    if (n < s) v = __fadd_rn(__fmul_rn(__int2float_rn(acc[r]), inv), bias[n]);
    if (mode != kArgmaxExact) {
      int key = n < s ? packed_key(v, n, mode) : INT_MIN;
      key = __reduce_max_sync(0xffffffffu, key);
      if (lane == 0) warp_idx[warp] = key;
      __syncthreads();
      if (threadIdx.x == 0) {
        int best = warp_idx[0];
        for (int i = 1; i < kWarps; ++i) best = max(best, warp_idx[i]);
        part_idx[out] = best;
      }
      __syncthreads();
      continue;
    }
    int idx = n;
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
      part_val[out] = best;
      part_idx[out] = best_idx;
    }
    __syncthreads();
  }
}

// choice[row] from the tiles' bests: exact takes the first tile maximum
// that no later tile beats strictly (jnp.argmax's first-maximum rule
// across tiles); the packed modes take the largest key.
__global__ void pick_kernel(const float* __restrict__ part_val,
                            const int* __restrict__ part_idx, int b,
                            int tiles, int mode, int* __restrict__ choice) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= b) return;
  const long long base = static_cast<long long>(row) * tiles;
  if (mode != kArgmaxExact) {
    int best = part_idx[base];
    for (int j = 1; j < tiles; ++j) best = max(best, part_idx[base + j]);
    choice[row] = 0xFFFF - (best & 0xFFFF);
    return;
  }
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

}  // namespace

int launch_argmax(const float* y, const int8_t* w, const float* bias,
                  int* choice, float* part, int b, int e, int s, long long sk,
                  long long sn, float aq, float inv, int mode,
                  cudaStream_t stream) {
  if (b <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (e <= 0 || e % 16 || e > kMaxEmb) return static_cast<int>(cudaErrorInvalidValue);
  if (mode != kArgmaxExact && mode != kArgmaxFp16 && mode != kArgmaxBf16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode != kArgmaxExact && s > 65536) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (s + kProjCols - 1) / kProjCols;
  const int vector_loads = sk == 1 && sn % 16 == 0 &&
                           reinterpret_cast<uintptr_t>(w) % 16 == 0;
  float* part_val = part;
  int* part_idx = reinterpret_cast<int*>(part + static_cast<long long>(b) * tiles);
  const dim3 grid(tiles, (b + kProjRows - 1) / kProjRows);
  project_kernel<<<grid, kThreads, 0, stream>>>(y, w, bias, b, e, s, sk, sn,
                                                vector_loads, aq, inv, mode,
                                                tiles, part_val, part_idx);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  pick_kernel<<<(b + 127) / 128, 128, 0, stream>>>(part_val, part_idx, b,
                                                   tiles, mode, choice);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slimt

// choice[b] = the argmax over n < s of q8(y[b]) W[:, n] inv + bias[n]
// by `mode` (ArgmaxMode). W is any strided [e, s] int8 view. scratch:
// 2 * b * ceil(s / 256) floats of device memory.
extern "C" int slimt_argmax_affine(const void* y, const void* w,
                                   const void* bias, void* choice,
                                   void* scratch, int b, int e, int s,
                                   long long sk, long long sn, float aq,
                                   float inv, int mode, void* stream) {
  return slimt::launch_argmax(
      static_cast<const float*>(y), static_cast<const int8_t*>(w),
      static_cast<const float*>(bias), static_cast<int*>(choice),
      static_cast<float*>(scratch), b, e, s, sk, sn, aq, inv, mode,
      static_cast<cudaStream_t>(stream));
}
