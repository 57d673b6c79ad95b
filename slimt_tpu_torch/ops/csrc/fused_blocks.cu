// The decoder's SSRU block and FFN block, each one launch over rows.
//
// Replaces slimt_tpu/ops/fused_blocks.py:_ssru_kernel (entry ssru_block)
// and _ffn_kernel (entry ffn_block), the blocks of the `fused` provider.
// Per row x of the flattened [M, E] activations:
//
//   ssru: f = sigmoid(q8(x) Wf inv_f + bf);  c' = f c + (1 - f) q8(x) W inv_w
//         h = LN(x + relu(c'))                     -> (h, c')
//   ffn:  u = relu(q8(x) W1 inv1 + b1)              [F]
//         y = LN((q8(u) W2 inv2 + b2) + x)
//
// LN(v) = (v - mean) / sqrt(var + 1e-6) * scale + bias.
//
// Design. The TPU kernel tiles 128 rows and holds the whole weights in
// VMEM. Here a block takes a tile of 1 row (M <= 64, to spread a decode
// batch over the SMs) or 4 rows (larger M, to read the weights once per
// 4 rows), keeps the rows, the gate, Wx and the FFN hidden row in shared
// memory, and runs the device functions of slimt_device.cuh: __dp4a
// matvecs over transposed W words, a warp per row for LayerNorm.
//
// Bounds on the H100. Each block reads the block's whole weights from L2
// or device memory: 2 E^2 bytes for the SSRU (128 KB at E = 256), 2 E F
// for the FFN (768 KB at E = 256, F = 1536). At decode batch the weights
// stay in the 50 MB L2, and the time is one SM's L2 read rate and
// __dp4a rate per row tile; at M = 512 the FFN issues 512 / 4 = 128
// blocks, about one wave on 132 SMs.

#include <cmath>
#include <cstdint>

#include "slimt_device.cuh"

namespace slimt {
namespace {

struct BlockArgs {
  const float* x;      // [m, e]
  const float* c;      // ssru: [m, e] previous cell
  const int8_t* w0;    // ssru: Wf [e, e]; ffn: W1 [e, f]
  const float* b0;     // ssru: bf; ffn: b1
  const int8_t* w1;    // ssru: W [e, e]; ffn: W2 [f, e]
  const float* b1;     // ffn: b2 (ssru: unused)
  const float* ln_scale;
  const float* ln_bias;
  float* out;          // [m, e]: h or the FFN output
  float* c_out;        // ssru: [m, e] new cell
  int m, e, f, rows;
  float aq0, inv0, aq1, inv1;
};

__global__ void __launch_bounds__(kThreads) ssru_kernel(const __grid_constant__ BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int e = a.e;
  const int cap = a.rows;
  const int row0 = blockIdx.x * cap;
  const int rows = min(cap, a.m - row0);
  float* xs = reinterpret_cast<float*>(smem);
  float* gate = xs + cap * e;
  float* wx = gate + cap * e;
  int8_t* xq = reinterpret_cast<int8_t*>(wx + cap * e);
  const long long tile0 = static_cast<long long>(row0) * e;

  for (int i = threadIdx.x; i < rows * e; i += kThreads) xs[i] = a.x[tile0 + i];
  __syncthreads();
  quantize_rows(xs, e, e, a.aq0, xq, e, rows);
  matvec(xq, e, rows, a.w0, e, e, a.inv0, a.b0, false, gate, e);
  quantize_rows(xs, e, e, a.aq1, xq, e, rows);
  matvec(xq, e, rows, a.w1, e, e, a.inv1, nullptr, false, wx, e);
  for (int i = threadIdx.x; i < rows * e; i += kThreads) {
    const float f = 1.0f / (1.0f + expf(-gate[i]));
    const float c_t = __fadd_rn(__fmul_rn(f, a.c[tile0 + i]),
                                __fmul_rn(1.0f - f, wx[i]));
    a.c_out[tile0 + i] = c_t;
    wx[i] = fmaxf(c_t, 0.0f);
  }
  __syncthreads();
  add_layer_norm(xs, wx, a.ln_scale, a.ln_bias, a.out + tile0, rows, e);
}

__global__ void __launch_bounds__(kThreads) ffn_kernel(const __grid_constant__ BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int e = a.e;
  const int f = a.f;
  const int cap = a.rows;
  const int row0 = blockIdx.x * cap;
  const int rows = min(cap, a.m - row0);
  const int ldq = e > f ? e : f;
  float* xs = reinterpret_cast<float*>(smem);
  float* ys = xs + cap * e;
  float* hidden = ys + cap * e;
  int8_t* xq = reinterpret_cast<int8_t*>(hidden + cap * f);
  const long long tile0 = static_cast<long long>(row0) * e;

  for (int i = threadIdx.x; i < rows * e; i += kThreads) xs[i] = a.x[tile0 + i];
  __syncthreads();
  quantize_rows(xs, e, e, a.aq0, xq, ldq, rows);
  matvec(xq, ldq, rows, a.w0, e, f, a.inv0, a.b0, true, hidden, f);
  quantize_rows(hidden, f, f, a.aq1, xq, ldq, rows);
  matvec(xq, ldq, rows, a.w1, f, e, a.inv1, a.b1, false, ys, e);
  add_layer_norm(ys, xs, a.ln_scale, a.ln_bias, a.out + tile0, rows, e);
}

bool shapes_ok(int m, int e, int f, int rows) {
  return m >= 1 && e >= 16 && e % 16 == 0 && f >= 16 && f % 16 == 0 &&
         rows >= 1 && rows <= kMaxRows;
}

}  // namespace
}  // namespace slimt

// x, c, h, c_out [m, e] f32; wf, w [e, e] int8; bf, ln_scale, ln_bias
// [e] f32; all 16-byte aligned device pointers. rows: rows per block.
extern "C" int slimt_ssru_block(const void* x, const void* c, const void* wf,
                                const void* bf, const void* w,
                                const void* ln_scale, const void* ln_bias,
                                void* h, void* c_out, int m, int e, int rows,
                                float aq_f, float inv_f, float aq_w,
                                float inv_w, void* stream) {
  using namespace slimt;
  if (!shapes_ok(m, e, e, rows)) return static_cast<int>(cudaErrorInvalidValue);
  const BlockArgs a = {
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<const int8_t*>(wf), static_cast<const float*>(bf),
      static_cast<const int8_t*>(w), nullptr,
      static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
      static_cast<float*>(h), static_cast<float*>(c_out),
      m, e, e, rows, aq_f, inv_f, aq_w, inv_w};
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(rows) * e +
                      static_cast<size_t>(rows) * e;
  static size_t smem_cap = 48 * 1024;
  const cudaError_t err = ensure_smem(ssru_kernel, smem, &smem_cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssru_kernel<<<(m + rows - 1) / rows, kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// x, out [m, e] f32; w1 [e, f], w2 [f, e] int8; b1 [f], b2, ln_scale,
// ln_bias [e] f32; all 16-byte aligned device pointers.
extern "C" int slimt_ffn_block(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2,
                               const void* ln_scale, const void* ln_bias,
                               void* out, int m, int e, int f, int rows,
                               float aq1, float inv1, float aq2, float inv2,
                               void* stream) {
  using namespace slimt;
  if (!shapes_ok(m, e, f, rows)) return static_cast<int>(cudaErrorInvalidValue);
  const BlockArgs a = {
      static_cast<const float*>(x), nullptr,
      static_cast<const int8_t*>(w1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
      static_cast<float*>(out), nullptr,
      m, e, f, rows, aq1, inv1, aq2, inv2};
  const size_t smem =
      sizeof(float) * static_cast<size_t>(rows) * (2 * static_cast<size_t>(e) + f) +
      static_cast<size_t>(rows) * (e > f ? e : f);
  static size_t smem_cap = 48 * 1024;
  const cudaError_t err = ensure_smem(ffn_kernel, smem, &smem_cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_kernel<<<(m + rows - 1) / rows, kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
