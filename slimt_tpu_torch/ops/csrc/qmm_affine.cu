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
// Design. Every product runs on the int8 tensor cores,
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32, whose int32 sums are exact.
// x is quantized on its way into shared memory (int8 activations never
// reach device memory), four k values a 32-bit word. The MMA reads W as
// "col", K-contiguous: the tied projection's [V, E] embedding passed as
// its transpose already is; the [K, N] weights are transposed while
// staging into shared memory (four rows of 16 columns, byte permutes), so
// they keep their one [K, N] copy, which the other kernels read. A thread
// feeds the MMA from 16 contiguous bytes of a row: the k order inside a
// 64-wide slice is permuted alike in A and B, which leaves the integer sum
// unchanged.
//
// Tilings, chosen in launch_affine from (M, N, K):
//   aligned, M > 64 or N > 4096   (x rows 16-byte aligned, W row-major
//       with N % 16 == 0 or K-contiguous with K % 16 == 0: every layer
//       of the port): 16-byte cp.async loads, zero-filled past M, N, K,
//       into a ring of raw chunks of 64 k, so the next chunk's loads fly
//       while the block quantizes and transposes this one, shared memory
//       to shared memory, and runs its MMAs. 128 x 256 tiles (16 warps,
//       3 chunks in the ring, one 168 KB block an SM) where they make a
//       wave of the 132 SMs: the encoder (M = B*T) and the projection at
//       large B; otherwise 64 x 128 tiles (8 warps, 3 chunks, two blocks
//       an SM), e.g. the decode FFN at B = 512 (M = B);
//   M <= 64 and N <= 4096 (the decode steps' affines at B <= 64), and
//       any shape the cp.async path does not take: 32-column tiles of 64
//       rows whose 8 warps split K in 64-wide slices; their int32 partial
//       sums meet in shared memory (integer addition: the same bits in any
//       order) and the epilogue runs once, after the full sum. A [256,
//       1536] FFN1 at M = B is 48 blocks. Its loads are 16 bytes wide
//       where W's layout allows, issued together, bytes gathered at the
//       edges and for other strides.
//
// Bounds on the H100: at the encoder's shapes device memory bounds the
// kernel (FFN1 writes its f32 output, 201 MB at B = 512, T = 64; FFN2
// reads its f32 input), far below the int8 tensor-core rate; x is read
// as f32 once per 256-column tile. At decode shapes reading W bounds it,
// which a launch cannot approach (a [256, 256] W is 64 KB: 20 ns).
//
// Numerics match the XLA path bit for bit: the quantize multiply and the
// epilogue multiply and add are rounded separately (__fmul_rn,
// __fadd_rn: no FMA contraction), rintf rounds half to even like
// jnp.rint, and integer accumulation is exact.

#include <cstdint>

#include "slimt_kernels.cuh"
#include "slimt_mma.cuh"

namespace slimt {
namespace {

constexpr int kThreads = 256;  // 8 warps in every kernel of this file

// W layouts that staging reads with 16-byte loads.
enum WLayout : int {
  kWGather = 0,    // any strides: byte loads
  kWRowMajor = 1,  // w_stride_n == 1, w_stride_k % 16 == 0
  kWColMajor = 2   // w_stride_k == 1, w_stride_n % 16 == 0
};

struct Operands {
  const float* x;
  const int8_t* w;
  const float* bias;
  float* y_f32;
  int* y_s32;
  int m, k, n;
  long long sk, sn;
  float aq, inv;
  int mode;
  int w_layout;
  bool x_vec;  // K % 4 == 0 and x 16-byte aligned
};

__device__ __forceinline__ unsigned quant8(float v, float aq) {
  float r = rintf(__fmul_rn(v, aq));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<unsigned>(static_cast<int>(r)) & 0xffu;
}

// Bytes (k0..k3) of column j of four consecutive W rows a0..a3, each row
// holding columns 4m..4m+3: out[j] packs column 4m+j.
__device__ __forceinline__ void transpose4(unsigned a0, unsigned a1,
                                           unsigned a2, unsigned a3,
                                           unsigned* out) {
  const unsigned t0 = __byte_perm(a0, a1, 0x5140);
  const unsigned t1 = __byte_perm(a2, a3, 0x5140);
  const unsigned t2 = __byte_perm(a0, a1, 0x7362);
  const unsigned t3 = __byte_perm(a2, a3, 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

// W[gk .. gk+3, gn] packed, byte i = k gk + i; zero outside W.
__device__ __forceinline__ unsigned gather_word(const Operands& p, int gk, int gn) {
  unsigned word = 0;
  if (gn < p.n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (gk + i < p.k) {
        const unsigned byte = static_cast<uint8_t>(
            p.w[static_cast<long long>(gk + i) * p.sk + gn * p.sn]);
        word |= byte << (8 * i);
      }
    }
  }
  return word;
}

// One K chunk (KC values wide, `kc` of them real: a multiple of 64) of
// the split-K kernel's x rows or W columns, staged in two steps: load()
// issues a thread's global loads together into registers, so their
// latencies overlap, and store() quantizes or transposes them into shared
// memory.

// x rows row0 .. row0 + ROWS - 1: unit u = 4 k values of a row, the units
// first + threadIdx.x + i * kThreads for i < PER.
template <int KC, int ROWS, int PER>
struct AChunk {
  static constexpr int kQuads = KC / 4;
  static constexpr int kUnits = ROWS * kQuads;
  float4 v[PER];

  __device__ __forceinline__ void load(const Operands& p, int row0, int k0, int kc,
                                       int first) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = first + threadIdx.x + i * kThreads;
      const int gr = row0 + u / kQuads;
      const int gk = k0 + 4 * (u % kQuads);
      v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (u >= kUnits || gk >= k0 + kc || gr >= p.m || gk >= p.k) continue;
      const float* src = p.x + static_cast<long long>(gr) * p.k + gk;
      if (p.x_vec) {
        v[i] = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        v[i].x = src[0];
        if (gk + 1 < p.k) v[i].y = src[1];
        if (gk + 2 < p.k) v[i].z = src[2];
        if (gk + 3 < p.k) v[i].w = src[3];
      }
    }
  }

  // a_s[r * pitch + j] = q8(x[row0 + r, k0 + j]); zero outside x.
  __device__ __forceinline__ void store(const Operands& p, int kc, int first,
                                        int8_t* a_s, int pitch) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = first + threadIdx.x + i * kThreads;
      const int quad = u % kQuads;
      if (u >= kUnits || 4 * quad >= kc) continue;
      const unsigned word = quant8(v[i].x, p.aq) | quant8(v[i].y, p.aq) << 8 |
                            quant8(v[i].z, p.aq) << 16 | quant8(v[i].w, p.aq) << 24;
      *reinterpret_cast<unsigned*>(a_s + (u / kQuads) * pitch + 4 * quad) = word;
    }
  }
};

// W columns col0 .. col0 + COLS - 1, 16 bytes a load. K-contiguous W: a
// unit is 16 k values of one column (one int4). Otherwise a unit is 4 rows
// of 16 columns (four int4), transposed when stored; it is gathered byte by
// byte where W is not row-major and aligned, or at W's edge.
template <int KC, int COLS>
struct BChunk {
  static constexpr int kRowUnits = (KC / 4) * (COLS / 16);
  static constexpr int kRowPer = (kRowUnits + kThreads - 1) / kThreads;
  static constexpr int kColUnits = COLS * (KC / 16);
  static_assert(kColUnits <= 4 * kRowPer * kThreads, "the same registers hold both");
  int4 raw[4 * kRowPer];

  __device__ __forceinline__ void load(const Operands& p, int col0, int k0, int kc) {
    if (p.w_layout == kWColMajor) {
#pragma unroll
      for (int i = 0; i < 4 * kRowPer; ++i) {
        const int u = threadIdx.x + i * kThreads;
        const int gn = col0 + u / (KC / 16);
        const int gk = k0 + 16 * (u % (KC / 16));
        raw[i] = make_int4(0, 0, 0, 0);
        if (u >= kColUnits || gk >= k0 + kc) continue;
        if (gn < p.n && gk + 15 < p.k) {
          raw[i] = __ldg(reinterpret_cast<const int4*>(p.w + gn * p.sn + gk));
        } else {
          raw[i] = make_int4(gather_word(p, gk, gn), gather_word(p, gk + 4, gn),
                             gather_word(p, gk + 8, gn), gather_word(p, gk + 12, gn));
        }
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < kRowPer; ++i) {
      const int u = threadIdx.x + i * kThreads;
      const int gk = k0 + 4 * (u % (KC / 4));
      const int gn = col0 + 16 * (u / (KC / 4));
      int4* r = raw + 4 * i;
      if (u >= kRowUnits || gk >= k0 + kc) continue;
      if (p.w_layout == kWRowMajor && gk + 3 < p.k && gn + 15 < p.n) {
        const int8_t* src = p.w + static_cast<long long>(gk) * p.sk + gn;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[j] = __ldg(reinterpret_cast<const int4*>(src + j * p.sk));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          unsigned words[4] = {0, 0, 0, 0};
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            if (gk + j < p.k && gn + c < p.n) {
              const unsigned byte = static_cast<uint8_t>(
                  p.w[static_cast<long long>(gk + j) * p.sk + (gn + c) * p.sn]);
              words[c / 4] |= byte << (8 * (c % 4));
            }
          }
          r[j] = make_int4(words[0], words[1], words[2], words[3]);
        }
      }
    }
  }

  // b_s[c * pitch + j] = W[k0 + j, col0 + c]; zero outside W.
  __device__ __forceinline__ void store(const Operands& p, int kc, int8_t* b_s,
                                        int pitch) const {
    if (p.w_layout == kWColMajor) {
#pragma unroll
      for (int i = 0; i < 4 * kRowPer; ++i) {
        const int u = threadIdx.x + i * kThreads;
        const int seg = u % (KC / 16);
        if (u >= kColUnits || 16 * seg >= kc) continue;
        *reinterpret_cast<int4*>(b_s + (u / (KC / 16)) * pitch + 16 * seg) = raw[i];
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < kRowPer; ++i) {
      const int u = threadIdx.x + i * kThreads;
      const int quad = u % (KC / 4);
      if (u >= kRowUnits || 4 * quad >= kc) continue;
      const int4* r = raw + 4 * i;
      unsigned words[16];
      transpose4(r[0].x, r[1].x, r[2].x, r[3].x, words);
      transpose4(r[0].y, r[1].y, r[2].y, r[3].y, words + 4);
      transpose4(r[0].z, r[1].z, r[2].z, r[3].z, words + 8);
      transpose4(r[0].w, r[1].w, r[2].w, r[3].w, words + 12);
      int8_t* dst = b_s + 16 * (u / (KC / 4)) * pitch + 4 * quad;
#pragma unroll
      for (int c = 0; c < 16; ++c) *reinterpret_cast<unsigned*>(dst + c * pitch) = words[c];
    }
  }
};

// y = acc * inv (+ b) (relu), b the bias of the output's column.
__device__ __forceinline__ float epilogue(const Operands& p, int acc, float b) {
  float v = __fmul_rn(__int2float_rn(acc), p.inv);
  if (p.bias != nullptr) v = __fadd_rn(v, b);
  if (p.mode == kAffineRelu) v = fmaxf(v, 0.0f);
  return v;
}

// y[r, c] and y[r, c + 1] from the accumulators a0, a1 (c even) and the
// two columns' biases b0, b1.
__device__ __forceinline__ void store_pair(const Operands& p, int r, int c, int a0,
                                           int a1, float b0, float b1) {
  if (r >= p.m || c >= p.n) return;
  const long long out = static_cast<long long>(r) * p.n + c;
  const bool pair = c + 1 < p.n && p.n % 2 == 0;
  if (p.mode == kAccumulator) {
    if (pair) {
      *reinterpret_cast<int2*>(p.y_s32 + out) = make_int2(a0, a1);
    } else {
      p.y_s32[out] = a0;
      if (c + 1 < p.n) p.y_s32[out + 1] = a1;
    }
    return;
  }
  const float v0 = epilogue(p, a0, b0);
  if (pair) {
    *reinterpret_cast<float2*>(p.y_f32 + out) = make_float2(v0, epilogue(p, a1, b1));
  } else {
    p.y_f32[out] = v0;
    if (c + 1 < p.n) p.y_f32[out + 1] = epilogue(p, a1, b1);
  }
}

__device__ __forceinline__ float bias_at(const Operands& p, int c) {
  return p.bias != nullptr && c < p.n ? __ldg(p.bias + c) : 0.0f;
}

// The aligned large-M case (x rows 16-byte aligned with K % 4 == 0; W
// row-major with N % 16 == 0 or K-contiguous with K % 16 == 0): every
// global read is a 16-byte cp.async, zero-filled past M, N and K, into a
// ring of STAGES raw chunks (x as f32, W as stored), so STAGES - 1 chunks
// are in flight while the block converts one (x quantized, row-major W
// transposed, both shared memory to shared memory) and runs its MMAs,
// without registers held for the loads.
template <int BM, int BN, int STAGES>
constexpr size_t async_smem_bytes() {
  return static_cast<size_t>(STAGES) * (BM * 64 * sizeof(float) + BN * 64) + (BM + BN) * 64;
}

template <int WM, int WN, int MT, int NT, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(WM * WN * 32, MIN_BLOCKS) affine_async_kernel(Operands p) {
  constexpr int kT = WM * WN * 32;  // threads
  constexpr int kBM = WM * MT * 16;
  constexpr int kBN = WN * NT * 8;
  constexpr int kBK = 64;
  extern __shared__ __align__(16) int8_t async_buf[];
  float* xs = reinterpret_cast<float*>(async_buf);              // [STAGES][kBM][kBK]
  int8_t* ws = async_buf + STAGES * kBM * kBK * sizeof(float);  // [STAGES][kBK * kBN]
  int8_t* a_s = ws + STAGES * kBK * kBN;                        // [kBM][kBK]
  int8_t* b_s = a_s + kBM * kBK;                                // [kBN][kBK]
  const bool col_major = p.w_layout == kWColMajor;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int chunks = (p.k + kBK - 1) / kBK;

  auto issue = [&](int c) {
    const int k0 = c * kBK;
    float* xd = xs + (c % STAGES) * kBM * kBK;
    for (int u = threadIdx.x; u < kBM * kBK / 4; u += kT) {
      const int r = u / (kBK / 4);
      const int gk = k0 + 4 * (u % (kBK / 4));
      const bool in = row0 + r < p.m && gk < p.k;
      cp_async16(xd + 4 * u, in ? p.x + static_cast<long long>(row0 + r) * p.k + gk : p.x, in);
    }
    int8_t* wd = ws + (c % STAGES) * kBK * kBN;
    for (int u = threadIdx.x; u < kBK * kBN / 16; u += kT) {
      if (col_major) {  // [kBN][kBK]: 4 pieces a column
        const int c_ = u / (kBK / 16);
        const int gk = k0 + 16 * (u % (kBK / 16));
        const bool in = col0 + c_ < p.n && gk < p.k;
        cp_async16(wd + 16 * u, in ? p.w + (col0 + c_) * p.sn + gk : p.w, in);
      } else {  // [kBK][kBN]: kBN / 16 pieces a row
        const int r = u / (kBN / 16);
        const int gn = col0 + 16 * (u % (kBN / 16));
        const bool in = k0 + r < p.k && gn < p.n;
        cp_async16(wd + 16 * u, in ? p.w + static_cast<long long>(k0 + r) * p.sk + gn : p.w, in);
      }
    }
  };

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks) issue(c);
    cp_async_commit();
  }
  int acc[MT][NT][4] = {};
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (c + STAGES - 1 < chunks) issue(c + STAGES - 1);
    cp_async_commit();
    const float* xc = xs + (c % STAGES) * kBM * kBK;
    for (int u = threadIdx.x; u < kBM * kBK / 4; u += kT) {
      const float4 v = reinterpret_cast<const float4*>(xc)[u];
      reinterpret_cast<unsigned*>(a_s)[u] = quant8(v.x, p.aq) | quant8(v.y, p.aq) << 8 |
                                            quant8(v.z, p.aq) << 16 | quant8(v.w, p.aq) << 24;
    }
    const int8_t* wc = ws + (c % STAGES) * kBK * kBN;
    if (!col_major) {
      // 4 rows x 16 columns a unit, neighbouring threads on neighbouring
      // column groups (conflict-free reads).
      for (int u = threadIdx.x; u < (kBK / 4) * (kBN / 16); u += kT) {
        const int g = u % (kBN / 16);
        const int quad = u / (kBN / 16);
        const int8_t* src = wc + 4 * quad * kBN + 16 * g;
        unsigned words[16];
        const int4 r0 = *reinterpret_cast<const int4*>(src);
        const int4 r1 = *reinterpret_cast<const int4*>(src + kBN);
        const int4 r2 = *reinterpret_cast<const int4*>(src + 2 * kBN);
        const int4 r3 = *reinterpret_cast<const int4*>(src + 3 * kBN);
        transpose4(r0.x, r1.x, r2.x, r3.x, words);
        transpose4(r0.y, r1.y, r2.y, r3.y, words + 4);
        transpose4(r0.z, r1.z, r2.z, r3.z, words + 8);
        transpose4(r0.w, r1.w, r2.w, r3.w, words + 12);
        // Column 16 g + j, k 4 quad: its 16-byte piece XOR-swizzled by
        // g % 4 against bank conflicts (mma_slice's `swizzle`).
        const int at = 16 * ((quad / 4) ^ (g % 4)) + 4 * (quad % 4);
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<unsigned*>(b_s + (16 * g + j) * kBK + at) = words[j];
      }
    }
    __syncthreads();
    mma_slice<MT, NT>(a_s + wm * MT * 16 * kBK, (col_major ? wc : b_s) + wn * NT * 8 * kBK,
                      kBK, 0, acc, col_major ? -1 : wn * NT * 8);
  }
  cp_async_wait<0>();
  const int lane = threadIdx.x % 32;
  const int r0 = row0 + wm * MT * 16 + lane / 4;
  const int c0 = col0 + wn * NT * 8 + 2 * (lane % 4);
  // The thread's 2 NT biases, loaded before any store.
  float bias[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    bias[nt][0] = bias_at(p, c0 + 8 * nt);
    bias[nt][1] = bias_at(p, c0 + 8 * nt + 1);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      store_pair(p, r0 + 16 * mt, c0 + 8 * nt, acc[mt][nt][0], acc[mt][nt][1],
                 bias[nt][0], bias[nt][1]);
      store_pair(p, r0 + 16 * mt + 8, c0 + 8 * nt, acc[mt][nt][2], acc[mt][nt][3],
                 bias[nt][0], bias[nt][1]);
    }
  }
}

// Decode shapes and the unaligned rest: grid (ceil(n / 32), ceil(m / (16
// MT))); the block's 8 warps take one 64-wide K slice each of every
// 512-wide chunk.
constexpr int kSplitBN = 32;
constexpr int kSplitKC = 512;
constexpr int kSplitPitch = kSplitKC + 64;  // conflict-free 16-byte reads

template <int MT>
constexpr size_t split_smem_bytes() {
  return static_cast<size_t>(MT * 16 + kSplitBN) * kSplitPitch +
         sizeof(int) * MT * 16 * kSplitBN;
}

template <int MT>
__global__ void __launch_bounds__(kThreads) affine_split_k_kernel(Operands p) {
  extern __shared__ __align__(16) int8_t split_buf[];
  int8_t* a_s = split_buf;
  int8_t* b_s = a_s + MT * 16 * kSplitPitch;
  int* sum_s = reinterpret_cast<int*>(b_s + kSplitBN * kSplitPitch);
  const int warp = threadIdx.x / 32;
  const int col0 = blockIdx.x * kSplitBN;
  const int row0 = blockIdx.y * MT * 16;
  for (int i = threadIdx.x; i < MT * 16 * kSplitBN; i += kThreads) sum_s[i] = 0;
  int acc[MT][kSplitBN / 8][4] = {};
  for (int k0 = 0; k0 < p.k; k0 += kSplitKC) {
    const int kc = min(kSplitKC, (p.k - k0 + 63) / 64 * 64);
    BChunk<kSplitKC, kSplitBN> b;
    b.load(p, col0, k0, kc);
    // x in batches of 8 loads a thread, all in flight at once.
    using A = AChunk<kSplitKC, MT * 16, 8>;
    for (int first = 0; first < A::kUnits; first += 8 * kThreads) {
      A a;
      a.load(p, row0, k0, kc, first);
      a.store(p, kc, first, a_s, kSplitPitch);
    }
    b.store(p, kc, b_s, kSplitPitch);
    __syncthreads();
    if (64 * warp < kc) mma_slice<MT, kSplitBN / 8>(a_s, b_s, kSplitPitch, 64 * warp, acc);
    __syncthreads();
  }
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kSplitBN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * mt + g + 8 * (i / 2);
        atomicAdd(&sum_s[r * kSplitBN + 8 * nt + c + i % 2], acc[mt][nt][i]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < min(p.m - row0, MT * 16) * kSplitBN; i += kThreads) {
    const int r = row0 + i / kSplitBN;
    const int gc = col0 + i % kSplitBN;
    if (gc >= p.n) continue;
    const long long out = static_cast<long long>(r) * p.n + gc;
    if (p.mode == kAccumulator) {
      p.y_s32[out] = sum_s[i];
    } else {
      p.y_f32[out] = epilogue(p, sum_s[i], bias_at(p, gc));
    }
  }
}

template <int WM, int WN, int MT, int NT, int STAGES, int MIN_BLOCKS>
int launch_async(const Operands& p, cudaStream_t stream) {
  constexpr int kBM = WM * MT * 16;
  constexpr int kBN = WN * NT * 8;
  constexpr size_t smem = async_smem_bytes<kBM, kBN, STAGES>();
  auto kernel = affine_async_kernel<WM, WN, MT, NT, STAGES, MIN_BLOCKS>;
  static bool raised = false;  // the 48 KB default cap, raised once
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const dim3 grid((p.n + kBN - 1) / kBN, (p.m + kBM - 1) / kBM);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_split_k(const Operands& p, cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<MT>();
  static bool raised = false;  // the 48 KB default cap, raised once
  if (smem > 48 * 1024 && !raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        affine_split_k_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const dim3 grid((p.n + kSplitBN - 1) / kSplitBN, (p.m + MT * 16 - 1) / (MT * 16));
  affine_split_k_kernel<MT><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kSms = 132;  // H100 SXM

}  // namespace

int launch_affine(const float* x, const int8_t* w, const float* bias, void* y,
                  int m, int k, int n, long long w_stride_k,
                  long long w_stride_n, float aq, float inv, int mode,
                  cudaStream_t stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const bool w_aligned = reinterpret_cast<uintptr_t>(w) % 16 == 0;
  int layout = kWGather;
  if (w_aligned && w_stride_n == 1 && w_stride_k % 16 == 0) {
    layout = kWRowMajor;
  } else if (w_aligned && w_stride_k == 1 && w_stride_n % 16 == 0) {
    layout = kWColMajor;
  }
  const Operands p{
      x, w, bias,
      mode == kAccumulator ? nullptr : static_cast<float*>(y),
      mode == kAccumulator ? static_cast<int*>(y) : nullptr,
      m, k, n, w_stride_k, w_stride_n, aq, inv, mode, layout,
      k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0};
  const bool aligned = p.x_vec && ((layout == kWRowMajor && n % 16 == 0) ||
                                   (layout == kWColMajor && k % 16 == 0));
  if ((m <= 64 && n <= 4096) || !aligned) {
    if (m <= 16) return launch_split_k<1>(p, stream);
    if (m <= 32) return launch_split_k<2>(p, stream);
    return launch_split_k<4>(p, stream);
  }
  const long long wide_tiles =
      static_cast<long long>((m + 127) / 128) * ((n + 255) / 256);
  if (wide_tiles >= kSms) return launch_async<2, 8, 4, 4, 3, 1>(p, stream);  // 128 x 256
  return launch_async<2, 4, 2, 4, 3, 2>(p, stream);  // 64 x 128
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
