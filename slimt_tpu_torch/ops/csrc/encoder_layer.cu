// One post-LN encoder layer in three launches.
//
// Replaces slimt_tpu/ops/encoder_layer_pallas.py:_layer_kernel (with
// _sdpa_rows), the declared TPU encoder:
//
//   q, k, v = affine(x, Wq), affine(x, Wk), affine(x, Wv)
//   att     = softmax((q_h . k_h) * scale + mask) . v_h   per head h
//   x1      = LN(x + affine(att, Wo))
//   out     = LN(x1 + affine(relu(affine(x1, W1)), W2))
//
// Design. The TPU kernel keeps every intermediate of a block of rows in
// VMEM; its only activation traffic is x in and out. Here:
//   1. qkv_kernel, a row tile a block: the tile of x is staged once
//      (cp.async), quantized three times (aq_q, aq_k, aq_v) into int8
//      tiles in shared memory, and the three products run on the int8
//      tensor cores; q, k and v leave as f32.
//   2. launch_sdpa (slimt_device.cuh, #8's kernel, shared with the split
//      encoder's fused SDPA): the scores never reach device memory.
//   3. post_attention_kernel, a row tile of whole rows a block (or a
//      thread-block cluster): q8(att) Wo, + x and the LayerNorm (x1 stays
//      in shared memory as f32 and as q8 by aq_1), then a loop over the
//      FFN's hidden units in chunks of kFc: the FFN1 chunk, relu and q8 by
//      aq_2 into an int8 chunk in shared memory (two buffers, swizzled),
//      and that chunk's share of FFN2, issued after the next chunk's FFN1
//      so that an epilogue computes while the tensor cores work, added to
//      int32 accumulators in registers; then + x1 and the LayerNorm,
//      written out. The [B*T, F] hidden never reaches device memory.
//      Where the row tiles are too few for the card, a cluster of cs
//      blocks takes a tile: every block runs the O product and the
//      first LayerNorm (a twelfth of the tile's products at tiny widths),
//      block i the hidden units [i F/cs, (i+1) F/cs); the FFN2 int32
//      partials meet through distributed shared memory after one
//      cluster.sync(), each block summing them for BM/cs of the rows.
// Every product reads its int8 weights K-major (a transposed copy of each
// matrix, made where the params are placed on the card), in chunks of 128
// columns x 128 k: each warp (8 in the QKV kernel, 16 in the
// post-attention kernel, whose accumulators take fewer registers) loads
// the tensor-core B fragments of its 16 or 8 columns straight from L2
// into registers, one chunk ahead of the chunk it multiplies (mma.sync
// m16n8k32, exact int32 sums), so no weight passes through
// shared memory and no barrier separates chunks; the activations' int8
// tiles sit in shared memory, read with 16-byte loads. A tile is 64 rows
// at E <= 256, 32 at E <= 512, 16 at E <= 1024 (its f32 rows take 64 KB),
// fewer where the tiles would not cover the card (the QKV kernel) - the
// wrapper's plan (encoder_layer.py). Every epilogue loads its biases
// before its first store.
//
// Bounds on the H100. The layer reads x and writes out, and between its
// kernels q, k, v and att go out and back (5 x 4 B x B*T*E moved twice but
// for x and out): 0.37 GB at B=512, T=64, E=256, 0.11 ms; its int8
// products take 0.035 ms at the tensor cores' peak and the SDPA's f32
// arithmetic 0.03 ms at the CUDA cores', so device memory bounds it. In
// practice each tile re-reads every weight from L2 (832 KB a 64-row tile
// at E=256, F=1536; 2.25 MB a 32-row tile at E=512, F=2048), and one
// block an SM (its shared memory) leaves the phases between the products
// (LayerNorms, epilogues, barriers) exposed: PERF.md has the readings.
//
// Numerics: bit-equal to the nine-launch layer (the int8 affine, the SDPA
// kernel and a warp-per-row add+LN kernel): every int8 sum is exact in
// any order, every epilogue rounds as the affine's does (__fmul_rn, then
// __fadd_rn with the bias), relu(h) is quantized by aq_2 as FFN2's input
// was, and both LayerNorms are add_layer_norm's order over z = y + x
// (z formed with __fadd_rn, as the add+LN kernel formed it). Fully masked
// (padding) rows stay finite: the mask is -99999999, not -inf, and expf
// (not __expf) is used.

#include <cmath>
#include <cstdint>

#include "slimt_device.cuh"

namespace slimt {
namespace {

constexpr int kKc = 128;                  // k of a weight chunk
constexpr int kNc = 128;                  // columns of a weight chunk, split by the warps
constexpr int kPad = 64;                  // an int8 row tile's pitch is K + kPad
constexpr int kFc = 128;                  // hidden units of an FFN chunk (a swizzled tile)
constexpr int kRowPad = 8;                // f32 tile rows lie e + kRowPad floats apart
constexpr int kTileFloats = 64 * 256;     // f32 elements of a row tile, at most
constexpr int kPostThreads = 512;         // the post-attention kernel's 16 warps, 8 columns each

// Rows a tile takes at width e: 16 * MT, MT in {1, 2, 4}, with its f32
// rows within kTileFloats.
__host__ __device__ constexpr bool tile_ok(int rows, int e) {
  return (rows == 16 || rows == 32 || rows == 64) && e % kNc == 0 && rows * e <= kTileFloats;
}

// A chunk of a K-major int8 matrix (row n holds column n of W, k
// contiguous): rows [0, ncols) and k [0, krows) at wt with row stride ld
// (16-byte aligned rows, zeros from krows to the next multiple of 16);
// zeros past them.
struct ChunkSrc {
  const int8_t* wt;
  long long ld;
  int krows, ncols;
};

// A thread's B fragments of a chunk (mma_chunk's layout): the warps split
// the chunk's 128 columns, 8 NT each; b[s][nt] holds column 8 NT warp + 8
// nt + lane / 4 at k 64 s + 16 (lane % 4) .. + 15.
template <int NT>
struct Frags {
  int4 b[2][NT];
};

// The fragments of chunk c, 16 bytes a load straight from L2 (no shared
// memory, no barrier).
template <int NT>
__device__ __forceinline__ Frags<NT> load_frags(const ChunkSrc& c) {
  const int lane = threadIdx.x % 32;
  const int n0 = 8 * NT * (threadIdx.x / 32) + lane / 4;
  Frags<NT> f;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + 8 * nt;
      const int k = 64 * s + 16 * (lane % 4);
      f.b[s][nt] = n < c.ncols && k < c.krows
          ? __ldg(reinterpret_cast<const int4*>(c.wt + n * c.ld + k))
          : make_int4(0, 0, 0, 0);
    }
  }
  return f;
}

// The chunks sched(0), sched(1), ... < total in order: take(i) returns
// chunk i's fragments, requested one chunk earlier, and requests chunk
// i + 1's, so a chunk's loads fly while the one before it is multiplied.
template <int NT, typename Sched>
struct Stream {
  Sched sched;
  int total;
  Frags<NT> next;

  __device__ Frags<NT> fetch(int i) const {
    if (i < total) return load_frags<NT>(sched(i));
    return Frags<NT>{};
  }

  __device__ Frags<NT> take(int i) {
    const Frags<NT> cur = next;
    next = fetch(i + 1);
    return cur;
  }
};

template <int NT, typename Sched>
__device__ Stream<NT, Sched> make_stream(Sched sched, int total) {
  Stream<NT, Sched> stream{sched, total, Frags<NT>{}};
  stream.next = stream.fetch(0);
  return stream;
}

// The 16-byte piece of row r at which piece p of a swizzled tile (128
// bytes a row) lies: rows g and g + 1 of an even g use the two halves of
// the banks for the same pieces (mma_chunk's reads), and the eight rows of
// a fragment's stores put one piece on eight different bank groups.
__device__ __forceinline__ int swizzled(int r, int p) {
  return p ^ ((r & 1) << 2 | (r >> 1 & 3));
}

// acc[mt][nt] += A[16 mt + (0..15), 0..127] . chunk[0..127, 8 NT warp +
// 8 nt + (0..7)]: a_s the tile's int8 rows at the chunk's k, f the chunk's
// fragments. The tile is row-major with pitch pa (pa % 128 == 64:
// conflict-free 16-byte reads), or with kSwz 128 bytes a row, swizzled.
// C fragment: acc[mt][nt][0..1] at row 16 mt + lane / 4, columns 8 NT warp
// + 8 nt + 2 (lane % 4) + (0, 1); acc[mt][nt][2..3] eight rows lower.
template <int MT, int NT, bool kSwz = false>
__device__ __forceinline__ void mma_chunk(const int8_t* a_s, int pa, const Frags<NT>& f,
                                          int (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int off = kSwz ? 16 * swizzled(g, 4 * s + lane % 4) : 64 * s + 16 * (lane % 4);
    const int pitch = kSwz ? 128 : pa;
    int4 lo[MT];
    int4 hi[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      lo[mt] = *reinterpret_cast<const int4*>(a_s + (16 * mt + g) * pitch + off);
      hi[mt] = *reinterpret_cast<const int4*>(a_s + (16 * mt + g + 8) * pitch + off);
    }
    // mma_s8_slice's two steps, the first of every tile before the second:
    // no step waits on the one just issued.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int4& b = f.b[s][nt];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_s8(acc[mt][nt], lo[mt].x, hi[mt].x, lo[mt].y, hi[mt].y, b.x, b.y);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int4& b = f.b[s][nt];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_s8(acc[mt][nt], lo[mt].z, hi[mt].z, lo[mt].w, hi[mt].w, b.z, b.w);
    }
  }
}

// fn(r, c, (acc[c], acc[c + 1])) for each pair of a thread's accumulators
// of a chunk of 128 columns starting at c0 (the mma_chunk layout, c even).
template <int MT, int NT, typename Fn>
__device__ __forceinline__ void each_fragment(const int (&acc)[MT][NT][4], int c0, Fn fn) {
  const int cb = c0 + 8 * NT * (threadIdx.x / 32) + 2 * (threadIdx.x % 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        fn(16 * mt + threadIdx.x % 32 / 4 + 8 * h, cb + 8 * nt,
           make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]));
    }
  }
}

// fn(r, c, (v[c], v[c + 1])) for the same pairs, v = acc * inv + bias[c]
// (relu), rounded as the affine's epilogue (affine_value), bias 0 at or
// past `limit`. The thread's biases are loaded together before any of fn's
// stores, which the compiler may not move loads across.
template <int MT, int NT, typename Fn>
__device__ __forceinline__ void each_output(const int (&acc)[MT][NT][4], int c0,
                                            const float* __restrict__ bias, int limit, float inv,
                                            bool relu, Fn fn) {
  const int cb = c0 + 8 * NT * (threadIdx.x / 32) + 2 * (threadIdx.x % 4);
  float b[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      b[nt][j] = cb + 8 * nt + j < limit ? __ldg(bias + cb + 8 * nt + j) : 0.0f;
  }
  auto value = [&](int a, float bias_j) {
    const float v = __fadd_rn(__fmul_rn(__int2float_rn(a), inv), bias_j);
    return relu ? fmaxf(v, 0.0f) : v;
  };
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        fn(16 * mt + threadIdx.x % 32 / 4 + 8 * h, cb + 8 * nt,
           make_float2(value(acc[mt][nt][2 * h], b[nt][0]), value(acc[mt][nt][2 * h + 1], b[nt][1])));
    }
  }
}

template <int MT, int NT, int N>
__device__ __forceinline__ void zero(int (&acc)[N][MT][NT][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][mt][nt][i] = 0;
      }
    }
  }
}

__device__ __forceinline__ unsigned quant_word(const float4& v, float aq) {
  return static_cast<uint8_t>(quant8(v.x, aq)) | static_cast<uint8_t>(quant8(v.y, aq)) << 8 |
         static_cast<uint8_t>(quant8(v.z, aq)) << 16 |
         static_cast<unsigned>(static_cast<uint8_t>(quant8(v.w, aq))) << 24;
}

// Rows row0 .. row0 + rows - 1 of the [m, e] f32 matrix src into the
// tile dst [bm] rows ld floats apart, by cp.async, zeros below the last
// row (no commit).
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src, int row0, int rows,
                                           int bm, int e) {
  for (int u = threadIdx.x; u < bm * e / 4; u += blockDim.x) {
    const int r = u / (e / 4);
    const int c = 4 * (u % (e / 4));
    const bool in = r < rows;
    cp_async16(dst + r * ld + c, in ? src + static_cast<long long>(row0 + r) * e + c : src, in);
  }
}

struct QkvArgs {
  const float* x;
  const int8_t* w[3];
  const float* bias[3];
  float* y[3];
  float aq[3], inv[3];
  int m, e;
};

// a[i] for i in {0, 1, 2} known only at run time, without indexing the
// kernel's parameters.
template <typename T>
__device__ __forceinline__ T pick3(const T (&a)[3], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : a[2];
}

template <int MT>
__host__ __device__ constexpr int chunks_across() {  // column chunks of E a thread accumulates
  return kTileFloats / (16 * MT) / kNc;
}

__host__ __device__ constexpr size_t qkv_smem(int rows, int e) {
  return static_cast<size_t>(rows) * e * 4 + 3 * static_cast<size_t>(rows) * (e + kPad);
}

// q, k, v = q8(x) W + b for a tile of 16 MT rows (see the file's note).
template <int MT>
__global__ void __launch_bounds__(kThreads, 1) qkv_kernel(QkvArgs p) {
  constexpr int kBm = 16 * MT;
  constexpr int kNch = chunks_across<MT>();
  extern __shared__ __align__(16) int8_t smem[];
  const int e = p.e;
  const int pa = e + kPad;
  const int nch = e / kNc;
  const int kcs = e / kKc;
  float* xs = reinterpret_cast<float*>(smem);
  int8_t* xq = smem + kBm * e * 4;  // [3][kBm][pa]
  const int row0 = blockIdx.x * kBm;
  const int rows = min(kBm, p.m - row0);
  // Chunk i: weight i / (kcs nch), its k chunk i / nch % kcs, column chunk i % nch.
  auto sched = [&](int i) {
    return ChunkSrc{pick3(p.w, i / (kcs * nch)) + static_cast<long long>(i % nch) * kNc * e +
                        i / nch % kcs * kKc,
                    e, kKc, kNc};
  };
  auto stream = make_stream<2>(sched, 3 * kcs * nch);  // Wq's first chunk flies with x
  stage_rows(xs, e, p.x, row0, rows, kBm, e);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int u = threadIdx.x; u < kBm * e / 4; u += kThreads) {
    const float4 v = reinterpret_cast<const float4*>(xs)[u];
    const int at = u / (e / 4) * pa + 4 * (u % (e / 4));
#pragma unroll
    for (int w = 0; w < 3; ++w)
      *reinterpret_cast<unsigned*>(xq + w * kBm * pa + at) = quant_word(v, p.aq[w]);
  }
  __syncthreads();
  int acc[kNch][MT][2][4];
  int i = 0;
  for (int w = 0; w < 3; ++w) {
    zero(acc);
    for (int kc = 0; kc < kcs; ++kc) {
#pragma unroll
      for (int ch = 0; ch < kNch; ++ch) {
        if (ch < nch) mma_chunk<MT, 2>(xq + w * kBm * pa + kc * kKc, pa, stream.take(i++), acc[ch]);
      }
    }
    const float* bias = pick3(p.bias, w);
    const float inv = pick3(p.inv, w);
    float* y = pick3(p.y, w) + static_cast<long long>(row0) * e;
#pragma unroll
    for (int ch = 0; ch < kNch; ++ch) {
      if (ch < nch) {
        each_output(acc[ch], ch * kNc, bias, e, inv, false, [&](int r, int c, float2 v) {
          if (r < rows) *reinterpret_cast<float2*>(y + r * e + c) = v;
        });
      }
    }
  }
}

struct PostArgs {
  const float* x;
  const float* att;
  float* out;
  const int8_t *wo, *w1, *w2;  // K-major: [e][e], [f][e], [e][f]
  const float *bo, *b1, *b2, *ln1_scale, *ln1_bias, *ln2_scale, *ln2_bias;
  float aq_o, inv_o, aq_1, inv_1, aq_2, inv_2;
  int m, e, f;
};

// Bytes a row takes of the region that holds q8(att) [rows][e + kPad],
// then the two hidden chunks [2][rows][kFc] (the larger at E = 128).
__host__ __device__ constexpr int att_pitch(int e) {
  return e + kPad > 2 * kFc ? e + kPad : 2 * kFc;
}

// x1 [rows][e + kRowPad] f32, q8(x1) [rows][e + kPad], the q8(att) and
// hidden region [rows][att_pitch(e)], and on a cluster the FFN2 partials
// [rows][e + kRowPad] int32.
__host__ __device__ constexpr size_t post_smem(int rows, int e, int cs) {
  const size_t tile = static_cast<size_t>(rows) * (e + kRowPad) * 4;
  return tile + static_cast<size_t>(rows) * (e + kPad + att_pitch(e)) + (cs > 1 ? tile : 0);
}

// out = LN(x1 + q8(relu(q8(x1) W1 + b1)) W2 + b2), x1 = LN(x + q8(att) Wo +
// bo), for a tile of 16 MT rows on a cluster of cs blocks (see the file's
// note).
template <int MT>
__global__ void __launch_bounds__(kPostThreads, 1) post_attention_kernel(PostArgs p) {
  constexpr int kBm = 16 * MT;
  constexpr int kNch = chunks_across<MT>();
  extern __shared__ __align__(16) int8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int e = p.e;
  const int pa = e + kPad;
  const int xp = e + kRowPad;  // f32 rows of x1: fragments' float2 accesses meet no bank twice
  const int nch = e / kNc;
  const int kcs = e / kKc;
  const int row0 = blockIdx.x / cs * kBm;
  const int rows = min(kBm, p.m - row0);
  const int fs = p.f / cs;
  const int f_lo = rank * fs;
  const int f_hi = f_lo + fs;
  const int nf = (fs + kFc - 1) / kFc;
  float* x1 = reinterpret_cast<float*>(smem);  // x, then z1, x1, z2, out
  int8_t* xq = smem + kBm * xp * 4;            // q8(x1) by aq_1 [kBm][pa]
  int8_t* aq = xq + kBm * pa;                  // q8(att) [kBm][pa], then hidden chunks
  const int ldf = (p.f + 15) / 16 * 16;        // W2's K-major rows: F, zero-padded to 16
  const int per_f = kcs + nch;                 // chunks of one hidden chunk
  // Chunk i: Wo's (k i / nch, columns i % nch) for i < kcs nch, then the
  // FFN's in the order the loop below takes them: W1 of hidden chunk 0,
  // then for fc = 1 .. nf - 1 W1 of chunk fc and W2 of chunk fc - 1, then
  // W2 of the last chunk (kcs chunks of W1 and nch of W2 a hidden chunk).
  auto w1_chunk = [&](int fc, int kc) {
    const int f0 = f_lo + fc * kFc;
    return ChunkSrc{p.w1 + static_cast<long long>(f0) * e + kc * kKc, e, kKc, min(kFc, f_hi - f0)};
  };
  auto w2_chunk = [&](int fc, int ch) {
    const int f0 = f_lo + fc * kFc;
    return ChunkSrc{p.w2 + static_cast<long long>(ch) * kNc * ldf + f0, ldf, min(kFc, f_hi - f0),
                    kNc};
  };
  auto sched = [&](int i) {
    if (i < kcs * nch)
      return ChunkSrc{p.wo + static_cast<long long>(i % nch) * kNc * e + i / nch * kKc, e, kKc,
                      kNc};
    const int j = i - kcs * nch;
    if (j < kcs) return w1_chunk(0, j);
    const int blk = (j - kcs) / per_f;
    const int s = (j - kcs) % per_f;
    if (blk == nf - 1) return w2_chunk(nf - 1, s);
    return s < kcs ? w1_chunk(blk + 1, s) : w2_chunk(blk, s - kcs);
  };
  auto stream = make_stream<1>(sched, kcs * nch + nf * per_f);  // Wo's first chunk flies with x
  stage_rows(x1, xp, p.x, row0, rows, kBm, e);
  cp_async_commit();
  {
    // q8(att) by aq_o: a thread's loads all issued before its first store.
    constexpr int kLoads = kTileFloats / 4 / kPostThreads;
    float4 v[kLoads];
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int u = threadIdx.x + it * kPostThreads;
      const int r = u / (e / 4);
      v[it] = u < kBm * e / 4 && r < rows
          ? __ldg(reinterpret_cast<const float4*>(p.att + static_cast<long long>(row0) * e + 4 * u))
          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int u = threadIdx.x + it * kPostThreads;
      if (u < kBm * e / 4)
        *reinterpret_cast<unsigned*>(aq + u / (e / 4) * pa + 4 * (u % (e / 4))) =
            quant_word(v[it], p.aq_o);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  int acc[kNch][MT][1][4];
  zero(acc);
  int i = 0;
  for (int kc = 0; kc < kcs; ++kc) {
#pragma unroll
    for (int ch = 0; ch < kNch; ++ch) {
      if (ch < nch) mma_chunk<MT, 1>(aq + kc * kKc, pa, stream.take(i++), acc[ch]);
    }
  }
  // z = y + x1 in place, z1 from O's accumulators and z2 from FFN2's.
  auto add_into_x1 = [&](int r, int c, float2 v) {
    float2* at = reinterpret_cast<float2*>(x1 + r * xp + c);
    const float2 old = *at;
    *at = make_float2(__fadd_rn(v.x, old.x), __fadd_rn(v.y, old.y));
  };
#pragma unroll
  for (int ch = 0; ch < kNch; ++ch) {
    if (ch < nch) each_output(acc[ch], ch * kNc, p.bo, e, p.inv_o, false, add_into_x1);
  }
  __syncthreads();
  add_layer_norm(x1, nullptr, p.ln1_scale, p.ln1_bias, x1, rows, e, pa, p.aq_1, xq, 0.0f, nullptr,
                 xp);
  // The FFN: FFN2 runs one hidden chunk behind FFN1, over two hidden
  // buffers, so that a chunk's epilogue computes while the tensor cores
  // take the previous chunk's FFN2.
  zero(acc);
  auto ffn2 = [&](int fc) {
#pragma unroll
    for (int ch = 0; ch < kNch; ++ch) {
      if (ch < nch) mma_chunk<MT, 1, true>(aq + fc % 2 * kBm * kFc, kFc, stream.take(i++), acc[ch]);
    }
  };
  for (int fc = 0; fc < nf; ++fc) {
    int acc1[1][MT][1][4];
    zero(acc1);
    for (int kc = 0; kc < kcs; ++kc) mma_chunk<MT, 1>(xq + kc * kKc, pa, stream.take(i++), acc1[0]);
    if (fc > 0) ffn2(fc - 1);
    // The hidden chunk q8(relu(acc1 inv_1 + b1)) by aq_2, a swizzled tile,
    // zero past f_hi (those columns of W1 and rows of W2 are zeros as
    // well), into the buffer that chunk fc - 2's FFN2 finished with.
    const int f0 = f_lo + fc * kFc;
    const int fw = min(kFc, f_hi - f0);
    int8_t* h = aq + fc % 2 * kBm * kFc;
    __syncthreads();
    each_output(acc1[0], 0, p.b1 + f0, fw, p.inv_1, true, [&](int r, int c, float2 v) {
      const unsigned pair = c < fw ? static_cast<uint8_t>(quant8(v.x, p.aq_2)) |
                                         static_cast<uint8_t>(quant8(v.y, p.aq_2)) << 8
                                   : 0u;
      *reinterpret_cast<uint16_t*>(h + r * kFc + 16 * swizzled(r % 8, c / 16) + c % 16) =
          static_cast<uint16_t>(pair);
    });
    __syncthreads();
  }
  ffn2(nf - 1);
  // z2 = (h W2 inv_2 + b2) + x1 in place, LN(z2) in place, then written out.
  int r0 = 0;
  int share = rows;
  if (cs == 1) {
#pragma unroll
    for (int ch = 0; ch < kNch; ++ch) {
      if (ch < nch) each_output(acc[ch], ch * kNc, p.b2, e, p.inv_2, false, add_into_x1);
    }
    __syncthreads();
  } else {
    // A cluster: the int32 partials meet in every block's `part`, block
    // `rank` sums them for its kBm / cs rows.
    int* part = reinterpret_cast<int*>(aq + kBm * att_pitch(e));
#pragma unroll
    for (int ch = 0; ch < kNch; ++ch) {
      if (ch < nch) {
        each_fragment(acc[ch], ch * kNc,
                      [&](int r, int c, int2 a) { *reinterpret_cast<int2*>(part + r * xp + c) = a; });
      }
    }
    cluster.sync();
    r0 = rank * (kBm / cs);
    share = max(0, min(kBm / cs, rows - r0));
    for (int u = threadIdx.x; u < kBm / cs * e; u += kPostThreads) {
      const int at = (r0 + u / e) * xp + u % e;
      int sum = 0;
      for (int src = 0; src < cs; ++src) sum += cluster.map_shared_rank(part, src)[at];
      x1[at] = __fadd_rn(__fadd_rn(__fmul_rn(__int2float_rn(sum), p.inv_2), __ldg(p.b2 + u % e)),
                         x1[at]);
    }
    __syncthreads();
  }
  add_layer_norm(x1 + r0 * xp, nullptr, p.ln2_scale, p.ln2_bias, x1 + r0 * xp, share, e, 0, 0.0f,
                 nullptr, 0.0f, nullptr, xp);
  float* out = p.out + static_cast<long long>(row0 + r0) * e;
  for (int u = threadIdx.x; u < share * e / 4; u += kPostThreads) {
    const int r = u / (e / 4);
    const int c = 4 * (u % (e / 4));
    *reinterpret_cast<float4*>(out + r * e + c) =
        *reinterpret_cast<const float4*>(x1 + (r0 + r) * xp + c);
  }
  if (cs > 1) cluster.sync();  // no block leaves while another reads its partials
}

template <int MT>
KernelAttrs& post_attrs() {
  static KernelAttrs attrs;
  return attrs;
}

template <int MT>
int launch_qkv_mt(const QkvArgs& p, cudaStream_t stream) {
  const size_t smem = qkv_smem(16 * MT, p.e);
  static size_t cap = 48 * 1024;  // this instantiation's dynamic shared-memory cap
  const cudaError_t err = ensure_smem(qkv_kernel<MT>, smem, &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  qkv_kernel<MT><<<(p.m + 16 * MT - 1) / (16 * MT), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The post-attention kernel's cluster launch, kPostThreads a block (the
// shared launch_cluster and cluster_capacity take kThreads).
cudaLaunchConfig_t post_config(int blocks, int cs, size_t smem, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = cluster_config(blocks, cs, smem, stream, attr);
  cfg.blockDim = dim3(kPostThreads);
  return cfg;
}

template <int MT>
int launch_post_mt(const PostArgs& p, int cs, cudaStream_t stream) {
  const int tiles = (p.m + 16 * MT - 1) / (16 * MT);
  const size_t smem = post_smem(16 * MT, p.e, cs);
  if (!cluster_size_ok(cs)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare_cluster_kernel(reinterpret_cast<const void*>(post_attention_kernel<MT>),
                                           smem, &post_attrs<MT>());
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = post_config(tiles * cs, cs, smem, stream, &attr);
    err = cudaLaunchKernelEx(&cfg, post_attention_kernel<MT>, p);
  }
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

template <int MT>
int post_clusters_mt(int cs, int e) {
  const size_t smem = post_smem(16 * MT, e, cs);
  if (!cluster_size_ok(cs) ||
      prepare_cluster_kernel(reinterpret_cast<const void*>(post_attention_kernel<MT>), smem,
                             &post_attrs<MT>()) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = post_config(cs, cs, smem, nullptr, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, post_attention_kernel<MT>, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return clusters;
}

}  // namespace
}  // namespace slimt

// Clusters of cs blocks of the post-attention kernel, rows a tile at width
// e, that the card holds at once (0: none, or a shape it does not take).
extern "C" int slimt_encoder_clusters(int rows, int cs, int e) {
  using namespace slimt;
  if (!tile_ok(rows, e)) return 0;
  switch (rows) {
    case 16: return post_clusters_mt<1>(cs, e);
    case 32: return post_clusters_mt<2>(cs, e);
    default: return post_clusters_mt<4>(cs, e);
  }
}

// weights: wq, bq, wk, bk, wv, bv, wo, bo, att_ln_scale, att_ln_bias,
//          w1, b1, w2, b2, ffn_ln_scale, ffn_ln_bias (device pointers,
//          16-byte aligned), each int8 matrix K-major: W[k, n] at n * K +
//          k (wq, wk, wv, wo [e][e], w1 [f][e], w2 [e][f rounded up to a
//          multiple of 16, zeros past f]);
// scales:  aq and inv of q, k, v, o, w1, w2 (host floats);
// q, k, v, att: [b * t, e] f32 scratch (16-byte aligned); x, out [b, t, e]
// f32, mask [b, t] additive. e % 128 == 0, f % (16 * cs) == 0 where cs > 1; qkv_rows and
// post_rows: rows a tile of the QKV and the post-attention kernels (16, 32
// or 64, with rows * e <= 16384); cs: blocks a post-attention tile's
// cluster takes (1, 2, 4, 8 or 16).
extern "C" int slimt_encoder_layer(const void* x_, const void* mask_, void* out_, void* q_,
                                   void* k_, void* v_, void* att_, const void* weights_,
                                   const void* scales_, int b, int t, int e, int f, int heads,
                                   float att_scale, int qkv_rows, int post_rows, int cs,
                                   void* stream_) {
  using namespace slimt;
  if (b < 1 || t < 1 || !tile_ok(qkv_rows, e) || !tile_ok(post_rows, e) ||
      !cluster_size_ok(cs) || f < 1 || (cs > 1 && f % (16 * cs)) || heads < 1 || e % heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* x = static_cast<const float*>(x_);
  float* q = static_cast<float*>(q_);
  float* k = static_cast<float*>(k_);
  float* v = static_cast<float*>(v_);
  float* att = static_cast<float*>(att_);
  const void* const* w = static_cast<const void* const*>(weights_);
  const float* s = static_cast<const float*>(scales_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  auto i8 = [&](int i) { return static_cast<const int8_t*>(w[i]); };
  auto f32 = [&](int i) { return static_cast<const float*>(w[i]); };
  const int m = b * t;
  const QkvArgs qkv{x, {i8(0), i8(2), i8(4)}, {f32(1), f32(3), f32(5)}, {q, k, v},
                    {s[0], s[2], s[4]}, {s[1], s[3], s[5]}, m, e};
  int rc = qkv_rows == 16 ? launch_qkv_mt<1>(qkv, stream)
           : qkv_rows == 32 ? launch_qkv_mt<2>(qkv, stream)
                            : launch_qkv_mt<4>(qkv, stream);
  if (rc) return rc;
  if ((rc = launch_sdpa(q, k, v, static_cast<const float*>(mask_), att, b, t, e, heads, att_scale,
                        stream)))
    return rc;
  const PostArgs post{x, att, static_cast<float*>(out_), i8(6), i8(10), i8(12), f32(7), f32(11),
                      f32(13), f32(8), f32(9), f32(14), f32(15),
                      s[6], s[7], s[8], s[9], s[10], s[11], m, e, f};
  switch (post_rows) {
    case 16: return launch_post_mt<1>(post, cs, stream);
    case 32: return launch_post_mt<2>(post, cs, stream);
    default: return launch_post_mt<4>(post, cs, stream);
  }
}
