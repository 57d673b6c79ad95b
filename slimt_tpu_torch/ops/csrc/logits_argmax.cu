// The int8 tied projection with its greedy argmax, without writing the
// logits to device memory.
//
// Replaces slimt_tpu/ops/logits_argmax.py:_kernel (entries _argmax_2d,
// argmax_affine); its packed_int mode replaces no TPU kernel, where the
// JAX package runs XLA ops over #1's accumulator
// (slimt_tpu/models/transformer.py packed_int_argmax). Per row of y and
// column n < s of W:
//
//   logit = q8(y) W[:, n] inv + bias[n]
//   exact:        choice = the first index of the maximum logit;
//   packed_fp16 / packed_bf16: the logit rounds half to even to 16 bits;
//                 key = ((sortable(bits) - 0x8000) << 16) | (0xFFFF - n)
//                 choice = 0xFFFF - (max key & 0xFFFF)
//   packed_int:   no float: with acc = q8(y) W[:, n] (int32) and b_i32[n]
//                 the bias in accumulator units,
//                 key = (((acc + b_i32[n]) >> shift) << width_bits)
//                       | (mask - n),  mask = 2^width_bits - 1
//                 choice = mask - (max key & mask)
//
// the packed keys exactly as logits_argmax.packed_argmax_16 and
// packed_int_argmax build them (s <= 65536 for the 16-bit ones; int32
// arithmetic wraps alike on both sides).
//
// Design. The TPU kernel walks a sequential vocab-tile grid and carries
// the running best in VMEM; CUDA blocks run in no order. So every
// candidate is a 64-bit key whose largest value is the answer, and the
// tiles' keys combine by max, in any order:
//   exact:  (order-preserving bits of the logit, -0.0 taken as +0.0) << 32
//           | (0xFFFFFFFF - n): the larger logit wins, on equal logits the
//           smaller column (jnp.argmax's first maximum);
//   packed_fp16 / packed_bf16: the int32 key with its sign bit flipped
//           (the same order, unsigned);
//   packed_int: the int32 key with its sign bit flipped << 32 | (0xFFFFFFFF
//           - n), so its column reads back as the exact key's
//           (logits_argmax.packed_int_key models it).
// Columns >= s give no key. Two launches from each C entry:
//   1. projection: where W is the transpose of contiguous [s, e] rows (the
//      embedding or its shortlisted rows, every serving path) a block takes
//      16, 32 or 64 rows and tiles of 128 columns. Its 8 warps run int8
//      tensor-core tiles (mma.sync m16n8k32, "col" B is exactly the
//      embedding's row layout): each lane loads its columns' 16-byte pieces
//      straight from L2 into registers, 4 slices of 64 k in flight, while
//      the block quantizes its rows of y once into shared memory (zero past
//      B; the loads 8 at a time). The epilogue rounds as the plain version
//      (__fmul_rn, __fadd_rn) and keeps each row's best key in registers
//      over the block's tiles: a block a tile where the grid is one wave
//      (B <= 64: every tile at once, W read once a step), else about two
//      blocks an SM, each walking several tiles, so that the rows are
//      staged once for them (B = 512: 33 blocks a row tile of 64). The keys
//      then meet over the quad by shuffles and over the warps in shared
//      memory (one barrier), and the block writes one key per row. The
//      packed_int epilogue takes the int32 sums straight from the mma
//      fragments: the #1 launch and the [B, S] int32 accumulator that the
//      plain chain reads five times never exist. Any
//      other W layout, and any E that is not a multiple of 64 up to 512
//      (the crosscheck cells' 32, say), takes a block of 256 columns (a
//      thread each, bytes gathered down the column, __dp4a) and 16 rows,
//      the rows quantized into shared memory at a pitch of E rounded up to
//      4 bytes, zero past E, with the same keys. E may be anything up to
//      kMaxEmb, as the TPU kernel takes the whole of K as one block;
//   2. pick: a warp per row takes the max of its blocks' keys.
// The key variant (slimt_argmax_keys) keys global columns col0 + n of a
// vocab shard and also writes each row's winning key, so that tensor-
// parallel shards meet by one max over their keys.
//
// Bounds on the H100. At B <= 64 one step reads W once: E * S bytes (8.2
// MB for the 32k vocabulary at E = 256, L2-resident across steps), and
// each of the ceil(S / 128) blocks reads its rows of y (4 B E bytes);
// larger B re-reads W once per 64 rows. The int8 operations, 2 B E S (1
// GOP at B = 64), are ~0.5 us at the tensor cores' peak. At B = 1 the
// projection kernel takes ~5 us of device time and the pick ~1.4 us
// (NVIDIA H100 80GB HBM3, 700 W): W's 8.2 MB through L2 and the launch.
// packed_int reads b_i32 (4 S bytes) in place of the f32 bias and writes
// the same keys; the chain it replaces moves 4 B S bytes ten times (#1's
// write, four passes that each read and write them, the max's read):
// ~330 MB a step at B = 256, S = 32000.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cmath>
#include <cstdint>

#include "slimt_device.cuh"
#include "slimt_kernels.cuh"

namespace slimt {
namespace {

using Key = unsigned long long;

constexpr int kGatherRows = 16;  // rows of a block of the strided path
constexpr int kMaxMmaEmb = 512;  // E of the tensor-core path (its rows in shared memory)
constexpr int kMaxEmb = 2048;    // E of the strided path: 16 rows of 2 KB in shared memory
constexpr int kNt = 2;  // n8 tiles of a warp's columns
constexpr int kTileCols = 8 * kNt * kWarps;  // 128 columns a projection tile

struct ArgmaxArgs {
  const float* y;  // [b, e]
  const int8_t* w;
  const unsigned* bias;  // [s] words: f32, or int32 in accumulator units (packed_int)
  Key* part;  // [b, groups]: each block's best key per row
  int b, e, s;
  long long sk, sn;
  float aq, inv;
  int mode, groups, y_vec;
  int col0;  // the global column of W's column 0 (a vocab shard's first)
  int width_bits, shift;  // packed_int's packing (logits_argmax.packed_int_params)
};

// The key of column n's logit v (see the header comment).
__device__ __forceinline__ Key argmax_key(float v, int n, int mode) {
  if (mode == kArgmaxExact) {
    const unsigned bits = __float_as_uint(v == 0.0f ? 0.0f : v);
    const unsigned u = bits & 0x80000000u ? ~bits : bits | 0x80000000u;
    return static_cast<Key>(u) << 32 | (0xFFFFFFFFu - static_cast<unsigned>(n));
  }
  const unsigned bits =
      mode == kArgmaxFp16
          ? static_cast<unsigned>(__half_as_ushort(__float2half_rn(v)))
          : static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
  const unsigned sortable = bits >= 0x8000u ? 0xFFFFu - bits : bits | 0x8000u;
  return static_cast<Key>(sortable << 16 | (0xFFFFu - static_cast<unsigned>(n)));
}

__device__ __forceinline__ Key key_max(Key a, Key b) { return a > b ? a : b; }

// The column a row's best key names.
__device__ __forceinline__ int key_column(Key key, int mode) {
  if (mode == kArgmaxExact || mode == kArgmaxPackedInt)
    return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key));
  return static_cast<int>(0xFFFFu - static_cast<unsigned>(key & 0xFFFFu));
}

// The key of column n < s from its int32 sum and its bias word (see the
// header comment). packed_int's int32 arithmetic runs on unsigned words,
// so that it wraps as the plain version's does.
__device__ __forceinline__ Key column_key(int acc, const ArgmaxArgs& a, unsigned bias, int n) {
  if (a.mode == kArgmaxPackedInt) {
    const int v = static_cast<int>(static_cast<unsigned>(acc) + bias) >> a.shift;
    const unsigned mask = (1u << a.width_bits) - 1u;
    const unsigned col = static_cast<unsigned>(n);
    const unsigned key = static_cast<unsigned>(v) << a.width_bits | (mask - col);
    return static_cast<Key>(key ^ 0x80000000u) << 32 | (0xFFFFFFFFu - col);
  }
  const float logit = __fadd_rn(__fmul_rn(__int2float_rn(acc), a.inv), __uint_as_float(bias));
  return argmax_key(logit, a.col0 + n, a.mode);
}

// The best keys of a block's rows, best[warp * rows_cap + r] for each warp,
// reduced over the warps into part[row0 + r, blockIdx.x] (rows < rows).
// Starts with the barrier that makes `best` visible.
__device__ __forceinline__ void write_tile(const ArgmaxArgs& a, const Key* best, int rows_cap,
                                           int row0, int rows) {
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < rows) {
    Key key = best[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) key = key_max(key, best[w * rows_cap + threadIdx.x]);
    a.part[static_cast<long long>(row0 + threadIdx.x) * a.groups + blockIdx.x] = key;
  }
}

// Rows row0 .. row0 + 16 MT - 1 of y quantized into xq (`pitch` bytes a
// row, zero past B): a thread's loads are issued together, 8 at a time,
// so their latencies overlap.
template <int MT>
__device__ __forceinline__ void stage_rows(const ArgmaxArgs& a, int row0, int rows,
                                           int8_t* xq, int pitch) {
  constexpr int kBatch = 8;
  const int quads = a.e / 4;
  const int units = 16 * MT * quads;
  for (int first = threadIdx.x; first < units; first += kBatch * kThreads) {
    float4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = first + j * kThreads;
      const int r = i / quads;
      v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < units && r < rows) {
        const float* src = a.y + static_cast<long long>(row0 + r) * a.e + 4 * (i % quads);
        v[j] = a.y_vec ? __ldg(reinterpret_cast<const float4*>(src))
                       : make_float4(src[0], src[1], src[2], src[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = first + j * kThreads;
      if (i < units) {
        const unsigned word =
            static_cast<uint8_t>(quant8(v[j].x, a.aq)) |
            static_cast<unsigned>(static_cast<uint8_t>(quant8(v[j].y, a.aq))) << 8 |
            static_cast<unsigned>(static_cast<uint8_t>(quant8(v[j].z, a.aq))) << 16 |
            static_cast<unsigned>(static_cast<uint8_t>(quant8(v[j].w, a.aq))) << 24;
        *reinterpret_cast<unsigned*>(xq + i / quads * pitch + 4 * (i % quads)) = word;
      }
    }
  }
}

// The projection on int8 tensor cores for W = the transpose of contiguous
// rows (sk == 1, sn % 16 == 0, 16-byte aligned; e % 64 == 0): block
// (blockIdx.x, blockIdx.y) takes rows [16 MT blockIdx.y, ...) and the
// column tiles blockIdx.x, blockIdx.x + gridDim.x, ... of kTileCols
// columns (one tile where the row tiles are few, so that every tile runs
// at once; several where the grid would be many waves, so that the rows
// are staged once for them). In a tile, warp w takes the 8 kNt columns
// from 8 kNt (kWarps tile + w), lane (g, i) = (lane / 4, lane % 4) loading
// column 8 nt + g's bytes 16 i .. 16 i + 15 of each 64-k slice
// (mma_s8_slice); its keys carry over the tiles in registers. xq's pitch
// e + 64 puts rows g and g + 1 in opposite halves of the banks, so the A
// fragments load without conflicts.
template <int MT>
__global__ void __launch_bounds__(kThreads) mma_project_kernel(const __grid_constant__ ArgmaxArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRows = 16 * MT;
  constexpr int kSlices = 4;  // 64-k slices of W a batch of loads holds (all of E = 256)
  const int pitch = a.e + 64;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  Key* best = reinterpret_cast<Key*>(smem + kRows * pitch);  // [kWarps][kRows]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, a.b - row0);
  const int tiles = (a.s + kTileCols - 1) / kTileCols;

  int4 wv[kSlices][kNt];
  unsigned bias[kNt][2];  // the bias words of the lane's columns col0 + 8 nt + 2 q + j
  // W's slices k0 .. k0 + 64 kSlices of the lane's columns from col0.
  auto load = [&](int col0, int k0) {
#pragma unroll
    for (int s = 0; s < kSlices; ++s) {
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int n = col0 + 8 * nt + g;
        const int k = k0 + 64 * s + 16 * q;
        wv[s][nt] = n < a.s && k < a.e
                        ? __ldg(reinterpret_cast<const int4*>(a.w + n * a.sn + k))
                        : make_int4(0, 0, 0, 0);
      }
    }
  };
  auto load_bias = [&](int col0) {
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = col0 + 8 * nt + 2 * q + j;
        bias[nt][j] = n < a.s ? __ldg(a.bias + n) : 0u;
      }
    }
  };
  int tile = blockIdx.x;
  load((tile * kWarps + warp) * kNt * 8, 0);  // in flight while the rows are quantized
  load_bias((tile * kWarps + warp) * kNt * 8);
  stage_rows<MT>(a, row0, rows, xq, pitch);
  __syncthreads();

  // key[mt][h]: the best key of row 16 mt + 8 h + g over the lane's columns.
  Key key[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) key[mt][0] = key[mt][1] = 0;
  while (true) {
    const int col0 = (tile * kWarps + warp) * kNt * 8;
    int acc[MT][kNt][4] = {};
    for (int k0 = 0; k0 < a.e; k0 += 64 * kSlices) {
      if (k0 > 0) load(col0, k0);
#pragma unroll
      for (int s = 0; s < kSlices; ++s) {
        const int off = k0 + 64 * s + 16 * q;
        if (k0 + 64 * s < a.e) {
          int4 lo[MT];
          int4 hi[MT];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            lo[mt] = *reinterpret_cast<const int4*>(xq + (16 * mt + g) * pitch + off);
            hi[mt] = *reinterpret_cast<const int4*>(xq + (16 * mt + g + 8) * pitch + off);
          }
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_s8_slice(acc[mt][nt], lo[mt], hi[mt], wv[s][nt]);
          }
        }
      }
    }
    // acc[mt][nt][2 h + j]: row 16 mt + 8 h + g, column col0 + 8 nt + 2 q + j.
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = col0 + 8 * nt + 2 * q + j;
        if (n < a.s) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              key[mt][h] = key_max(key[mt][h], column_key(acc[mt][nt][2 * h + j], a,
                                                          bias[nt][j], n));
          }
        }
      }
    }
    tile += gridDim.x;
    if (tile >= tiles) break;
    load((tile * kWarps + warp) * kNt * 8, 0);
    load_bias((tile * kWarps + warp) * kNt * 8);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Key k = key[mt][h];
      k = key_max(k, __shfl_xor_sync(0xffffffffu, k, 1));
      k = key_max(k, __shfl_xor_sync(0xffffffffu, k, 2));
      if (q == 0) best[warp * kRows + 16 * mt + 8 * h + g] = k;
    }
  }
  write_tile(a, best, kRows, row0, rows);
}

// Any other W layout or E: block blockIdx.x takes kThreads columns, a
// thread each, and kGatherRows rows; W's bytes are gathered down the
// column. xq (dynamic shared memory) holds the rows at `pitch` = E
// rounded up to 4 bytes, zero past E and past the batch.
__global__ void __launch_bounds__(kThreads) gather_project_kernel(const __grid_constant__ ArgmaxArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Key best[kWarps * kGatherRows];
  const int e = a.e;
  const int pitch = (e + 3) & ~3;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  const int row0 = blockIdx.y * kGatherRows;
  const int rows = min(kGatherRows, a.b - row0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < kGatherRows * pitch; i += kThreads) {
    const int r = i / pitch;
    const int k = i % pitch;
    xq[i] = r < rows && k < e ? quant8(a.y[static_cast<long long>(row0 + r) * e + k], a.aq)
                              : static_cast<int8_t>(0);
  }
  __syncthreads();

  const int n = blockIdx.x * kThreads + threadIdx.x;
  int acc[kGatherRows];
#pragma unroll
  for (int r = 0; r < kGatherRows; ++r) acc[r] = 0;
  if (n < a.s) {
    const int8_t* col = a.w + static_cast<long long>(n) * a.sn;
    for (int k0 = 0; k0 < e; k0 += 4) {
      unsigned packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned byte =
            k0 + j < e ? static_cast<uint8_t>(col[(k0 + j) * a.sk]) : 0u;
        packed |= byte << (8 * j);
      }
#pragma unroll
      for (int r = 0; r < kGatherRows; ++r) {
        if (r < rows) {
          const int xw = reinterpret_cast<const int*>(xq + r * pitch)[k0 / 4];
          acc[r] = __dp4a(xw, static_cast<int>(packed), acc[r]);
        }
      }
    }
  }
  const unsigned bias = n < a.s ? a.bias[n] : 0u;
#pragma unroll
  for (int r = 0; r < kGatherRows; ++r) {
    Key key = n < a.s ? column_key(acc[r], a, bias, n) : 0;
#pragma unroll
    for (int offset = 16; offset > 0; offset /= 2)
      key = key_max(key, __shfl_xor_sync(0xffffffffu, key, offset));
    if (lane == 0) best[warp * kGatherRows + r] = key;
  }
  write_tile(a, best, kGatherRows, row0, rows);
}

// choice[row] = the column of the largest of the row's tile keys, a warp
// per row; a lane's loads are issued together, 8 at a time. Where `keys_out`
// is given, keys_out[row] = that key with its top bit flipped: as a signed 64-bit
// integer it orders as the unsigned key, so vocab shards' keys meet by a
// signed max.
__global__ void __launch_bounds__(kThreads) pick_kernel(const Key* __restrict__ part, int b,
                                                        int groups, int mode,
                                                        int* __restrict__ choice,
                                                        long long* __restrict__ keys_out) {
  constexpr int kBatch = 8;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= b) return;  // the whole warp
  const Key* keys = part + static_cast<long long>(row) * groups;
  Key key = 0;
  for (int j0 = lane; j0 < groups; j0 += 32 * kBatch) {
    Key batch[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) batch[u] = j0 + 32 * u < groups ? keys[j0 + 32 * u] : 0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) key = key_max(key, batch[u]);
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2)
    key = key_max(key, __shfl_xor_sync(0xffffffffu, key, offset));
  if (lane == 0) {
    choice[row] = key_column(key, mode);
    if (keys_out != nullptr) keys_out[row] = static_cast<long long>(key ^ (1ull << 63));
  }
}

// Blocks a launch may keep in flight across the device's SMs before a
// second wave: two an SM (0 where the query fails).
int wave_blocks() {
  int device = 0;
  int sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  return 2 * sms;
}

// The tensor-core projection in row tiles of 16 MT rows and column tiles
// of kTileCols columns: a block a column tile where that is one wave,
// else about two blocks an SM, each walking several column tiles; sets
// a->groups, the blocks along the columns.
template <int MT>
int launch_mma(ArgmaxArgs* a, cudaStream_t stream) {
  constexpr int kRows = 16 * MT;
  const int tiles = (a->s + kTileCols - 1) / kTileCols;
  const int row_tiles = (a->b + kRows - 1) / kRows;
  const int wave = wave_blocks();
  a->groups = tiles;
  if (wave > 0 && tiles * row_tiles > wave)
    a->groups = max(1, min(tiles, (wave + row_tiles - 1) / row_tiles));
  const size_t smem = static_cast<size_t>(kRows) * (a->e + 64) + sizeof(Key) * kWarps * kRows;
  const dim3 grid(a->groups, row_tiles);
  mma_project_kernel<MT><<<grid, kThreads, smem, stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

size_t argmax_scratch_bytes(int b, int s) {
  return sizeof(Key) * static_cast<size_t>(b) * ((s + kTileCols - 1) / kTileCols);
}

int launch_argmax(const float* y, const int8_t* w, const void* bias, int* choice,
                  void* part, int b, int e, int s, long long sk, long long sn, float aq,
                  float inv, int mode, cudaStream_t stream, int col0,
                  long long* keys, int width_bits, int shift) {
  if (b <= 0 || s <= 0 || col0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (e <= 0 || e > kMaxEmb) return static_cast<int>(cudaErrorInvalidValue);
  if (mode != kArgmaxExact && mode != kArgmaxFp16 && mode != kArgmaxBf16 &&
      mode != kArgmaxPackedInt)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((mode == kArgmaxFp16 || mode == kArgmaxBf16) && static_cast<long long>(col0) + s > 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  // packed_int: whole projections only (no key variant), every column
  // below 2^width_bits, the shifts within an int32.
  if (mode == kArgmaxPackedInt &&
      (col0 != 0 || keys != nullptr || width_bits < 1 || width_bits > 30 || shift < 0 ||
       shift > 31 || s > (1 << width_bits)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(part) % sizeof(Key)) return static_cast<int>(cudaErrorInvalidValue);
  ArgmaxArgs a = {y, w, static_cast<const unsigned*>(bias), static_cast<Key*>(part), b, e, s,
                  sk, sn, aq, inv, mode, 0, reinterpret_cast<uintptr_t>(y) % 16 == 0, col0,
                  width_bits, shift};
  const bool columns = sk == 1 && sn % 16 == 0 && e % 64 == 0 && e <= kMaxMmaEmb &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  int rc;
  if (columns) {
    if (b <= 16) {
      rc = launch_mma<1>(&a, stream);
    } else if (b <= 32) {
      rc = launch_mma<2>(&a, stream);
    } else {
      rc = launch_mma<4>(&a, stream);
    }
  } else {
    a.groups = (s + kThreads - 1) / kThreads;
    const dim3 grid(a.groups, (b + kGatherRows - 1) / kGatherRows);
    const size_t smem = static_cast<size_t>(kGatherRows) * ((e + 3) & ~3);
    gather_project_kernel<<<grid, kThreads, smem, stream>>>(a);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc) return rc;
  pick_kernel<<<(b + kWarps - 1) / kWarps, kThreads, 0, stream>>>(a.part, b, a.groups, mode,
                                                                   choice, keys);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slimt

// Floats of device scratch slimt_argmax_affine (and the whole step's
// projection stage) needs for b rows over s columns.
extern "C" int slimt_argmax_scratch(int b, int s) {
  return static_cast<int>(slimt::argmax_scratch_bytes(b, s) / sizeof(float));
}

// choice[b] = the argmax over n < s of q8(y[b]) W[:, n] inv + bias[n]
// by `mode` (ArgmaxMode). W is any strided [e, s] int8 view. scratch:
// slimt_argmax_scratch(b, s) floats of device memory, 8-byte aligned.
extern "C" int slimt_argmax_affine(const void* y, const void* w,
                                   const void* bias, void* choice,
                                   void* scratch, int b, int e, int s,
                                   long long sk, long long sn, float aq,
                                   float inv, int mode, void* stream) {
  return slimt::launch_argmax(
      static_cast<const float*>(y), static_cast<const int8_t*>(w),
      static_cast<const float*>(bias), static_cast<int*>(choice), scratch, b, e, s, sk,
      sn, aq, inv, mode, static_cast<cudaStream_t>(stream));
}

// The packed_int method: choice[b] = packed_int_argmax of q8(y[b]) W's
// int32 sums and b_i32 (int32 [s], the bias in accumulator units), with
// the packing (width_bits, shift) of logits_argmax.packed_int_params.
// W and scratch as for slimt_argmax_affine.
extern "C" int slimt_argmax_packed_int(const void* y, const void* w, const void* b_i32,
                                       void* choice, void* scratch, int b, int e, int s,
                                       long long sk, long long sn, float aq, int width_bits,
                                       int shift, void* stream) {
  return slimt::launch_argmax(
      static_cast<const float*>(y), static_cast<const int8_t*>(w), b_i32,
      static_cast<int*>(choice), scratch, b, e, s, sk, sn, aq, 1.0f, slimt::kArgmaxPackedInt,
      static_cast<cudaStream_t>(stream), 0, nullptr, width_bits, shift);
}

// The key variant (a vocab shard's argmax): W holds global columns col0 ..
// col0 + s - 1; choice[b] is the global column and keys[b] (int64) the
// winning key with its top bit flipped, which the shards reduce by a signed
// max. Packed methods need col0 + s <= 65536.
extern "C" int slimt_argmax_keys(const void* y, const void* w, const void* bias,
                                 void* choice, void* keys, void* scratch, int b, int e,
                                 int s, long long sk, long long sn, int col0, float aq,
                                 float inv, int mode, void* stream) {
  return slimt::launch_argmax(
      static_cast<const float*>(y), static_cast<const int8_t*>(w),
      static_cast<const float*>(bias), static_cast<int*>(choice), scratch, b, e, s, sk,
      sn, aq, inv, mode, static_cast<cudaStream_t>(stream), col0,
      static_cast<long long*>(keys));
}
