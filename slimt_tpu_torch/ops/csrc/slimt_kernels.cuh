// Host-side launchers shared between the kernel sources.
#pragma once

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

}  // namespace slimt
