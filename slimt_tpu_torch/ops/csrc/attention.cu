// The split encoder's two attention kernels, both launches of the one
// attention kernel of slimt_device.cuh (attention_kernel: a thread per
// query row with q and its accumulator in registers, K/V tiles streamed
// through shared memory by cp.async and read as float4 broadcasts, an
// online softmax).
//
// 1. Fused SDPA on joined operands. Replaces
//    slimt_tpu/ops/attention.py:fused_sdpa_joined (bodies
//    _fused_sdpa_kernel_stack and _fused_sdpa_kernel):
//
//      out[b, :, h] = softmax((q_h . k_h) * scale + mask[b]) v_h
//
//    per head h of D = E / heads columns, on [B, T, E] q, k, v straight
//    from the Q/K/V affines (no split into heads): the kernel reads a
//    head's columns in place (row stride E). The TPU kernel's lane
//    masking and stacked heads lay the heads out for its 128-wide matrix
//    unit; here a block takes one (batch row, head). Any B, T <= 256 (the
//    whole-layer gate), D in {8, 16, 32, 64}.
//
//    Bound on the H100: device memory. q, k, v are read once and out
//    written once (16 * B * T * E bytes, 134 MB at B = 512, T = 64,
//    E = 256: 40 us at 3.35 TB/s), against 4 * B * T * T * E flops
//    (2.1 GFLOP: 32 us at the 67 TFLOP/s f32 rate). The kernel this
//    replaces loaded K or V from shared memory once per multiply-add
//    (one warp per query row, one lane per key), so shared-memory
//    wavefronts bounded it at about 8x the bound; now a float4 broadcast
//    feeds four multiply-adds per thread, and the loads of the next key
//    tile overlap the arithmetic of this one.
//
//    A second entry (slimt_fused_sdpa_rows, below) takes a slice of the
//    query rows against all T keys: sequence parallelism's T / seq rows
//    a rank, each the row the full launch gives.
//
// 2. Blockwise attention on split heads. Replaces
//    slimt_tpu/ops/attention.py:blockwise_attention (body
//    _attention_kernel): for q, k, v [B, H, T, D] and the additive mask
//    of row b (shared by its H heads),
//
//      out[b, h] = softmax((q k^T) * scale + mask[b]) v     -> [B, H, T, D]
//
//    The TPU kernel keeps a head's whole K and V in VMEM and takes one
//    softmax over T. Here that does not fit: at T = 2048, D = 32, K and
//    V are 512 KB against 227 KB of shared memory. The online softmax
//    over key tiles needs only two tiles of K and V at any T.
//
//    Bound on the H100: operations. 4 * B * H * T * T * D flops
//    (17.2 GFLOP at T = 1024, B * H = 128, D = 32: 256 us at 67 TFLOP/s)
//    against 16 * B * H * T * D bytes (67 MB: 20 us). Two multiply-adds
//    per score and key column and one expf per score run on the CUDA
//    cores; the tensor cores (TF32 or split-f32 products) would break the
//    port's "equal up to f32 accumulation order" bar.

#include "slimt_device.cuh"

// q, k, v, out [b * t, e] f32; mask [b, t] f32 additive; contiguous,
// 16-byte aligned device pointers; e / heads in {8, 16, 32, 64}.
extern "C" int slimt_fused_sdpa(const void* q, const void* k, const void* v,
                                const void* mask, void* out, int b, int t,
                                int e, int heads, float scale, void* stream) {
  using namespace slimt;
  if (b < 1 || t < 1 || heads < 1 || e % heads)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_sdpa(static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v),
                     static_cast<const float*>(mask), static_cast<float*>(out),
                     b, t, e, heads, scale, static_cast<cudaStream_t>(stream));
}

// q, k, v, out [bh, t, d] f32 with bh = b * heads; mask [b, t] f32
// additive; contiguous, 16-byte aligned device pointers; d in {8, 16,
// 32, 64}.
extern "C" int slimt_blockwise_attention(const void* q, const void* k,
                                         const void* v, const void* mask,
                                         void* out, int bh, int heads, int t,
                                         int d, float scale, void* stream) {
  using namespace slimt;
  if (bh < 1 || heads < 1 || bh % heads || t < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long head = static_cast<long long>(t) * d;
  const HeadLayout split{heads * head, head, d};
  return launch_attention(static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v), static_cast<const float*>(mask),
                          static_cast<float*>(out), bh / heads, heads, t, d, split,
                          scale, static_cast<cudaStream_t>(stream));
}

// The query-slice launches of the same kernel (sequence parallelism: a
// rank's T / seq query rows against every key). q and out hold q_rows rows
// a batch row (q_rows * e floats a batch row for the joined form, q_rows * d
// a head for the split form); the kernel takes rows q0 .. q0 + tq - 1 and
// writes those rows of out. k, v and the mask hold t keys. A row's result
// is the row the full launch gives: the key tiles run in the same order.
extern "C" int slimt_fused_sdpa_rows(const void* q, const void* k, const void* v,
                                     const void* mask, void* out, int b, int q_rows,
                                     int q0, int tq, int t, int e, int heads,
                                     float scale, void* stream) {
  using namespace slimt;
  if (b < 1 || t < 1 || heads < 1 || e % heads || tq < 1 || q0 < 0 || q0 + tq > q_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = e / heads;
  const HeadLayout keys{static_cast<long long>(t) * e, d, e};
  const QueryRows rows{{static_cast<long long>(q_rows) * e, d, e}, q0, tq};
  return launch_attention(static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v), static_cast<const float*>(mask),
                          static_cast<float*>(out), b, heads, t, d, keys, scale,
                          static_cast<cudaStream_t>(stream), rows);
}

extern "C" int slimt_blockwise_attention_rows(const void* q, const void* k,
                                              const void* v, const void* mask,
                                              void* out, int bh, int heads, int q_rows,
                                              int q0, int tq, int t, int d, float scale,
                                              void* stream) {
  using namespace slimt;
  if (bh < 1 || heads < 1 || bh % heads || t < 1 || tq < 1 || q0 < 0 || q0 + tq > q_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long head = static_cast<long long>(t) * d;
  const long long q_head = static_cast<long long>(q_rows) * d;
  const HeadLayout keys{heads * head, head, d};
  const QueryRows rows{{heads * q_head, q_head, d}, q0, tq};
  return launch_attention(static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v), static_cast<const float*>(mask),
                          static_cast<float*>(out), bh / heads, heads, t, d, keys, scale,
                          static_cast<cudaStream_t>(stream), rows);
}
