// Host-side launchers shared between the kernel sources, each defined in
// one source and called from others.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace slimt {

// Output modes of the int8 affine.
enum AffineMode : int {
  kAffine = 0,      // y = acc * inv + b            (f32)
  kAffineRelu = 1,  // y = max(acc * inv + b, 0)    (f32)
  kAccumulator = 2  // y = acc                      (s32, no epilogue)
};

// acc[m, n] = sum_k q(x[m, k]) * w[k * w_stride_k + n * w_stride_n],
// q(v) = clip(rint(v * aq), -127, 127). x is row-major [m, k] f32;
// bias may be null. Returns cudaGetLastError() after the launch.
int launch_affine(const float* x, const int8_t* w, const float* bias, void* y,
                  int m, int k, int n, long long w_stride_k,
                  long long w_stride_n, float aq, float inv, int mode,
                  cudaStream_t stream);

// Argmax methods of the tied projection (logits_argmax.cu).
enum ArgmaxMode : int {
  kArgmaxExact = 0,  // first index of the maximum f32 logit
  kArgmaxFp16 = 1,   // packed key of the float16-rounded logit
  kArgmaxBf16 = 2,   // packed key of the bfloat16-rounded logit
  kArgmaxPackedInt = 3  // packed key of the int32 sum plus an int32 bias
};

// Bytes of scratch launch_argmax needs for b rows over s columns.
size_t argmax_scratch_bytes(int b, int s);

// choice[r] = argmax over n < s of q8(y[r]) W[:, n] inv + bias[n] by
// `mode`, W[k, n] = w[k * sk + n * sn] int8 [e, s]; the 16-bit packed
// modes need s <= 65536. bias is f32 [s], or under kArgmaxPackedInt int32
// [s] in accumulator units, with the packing (width_bits, shift) and
// s <= 2^width_bits (inv unused). part: argmax_scratch_bytes(b, s) bytes
// of scratch, 8-byte aligned. Returns cudaGetLastError() after the
// launches. col0 names W's columns col0 .. col0 + s - 1 (a vocab shard;
// the 16-bit packed modes then need col0 + s <= 65536, packed_int col0 =
// 0 and no keys); where `keys` is given, keys[r] is the winning key with
// its top bit flipped (int64 order = key order).
int launch_argmax(const float* y, const int8_t* w, const void* bias,
                  int* choice, void* part, int b, int e, int s, long long sk,
                  long long sn, float aq, float inv, int mode,
                  cudaStream_t stream, int col0 = 0, long long* keys = nullptr,
                  int width_bits = 0, int shift = 0);

}  // namespace slimt
