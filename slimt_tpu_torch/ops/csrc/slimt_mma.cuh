// The int8 tensor-core product and the asynchronous copies shared by the
// int8 affine (qmm_affine.cu) and, through slimt_device.cuh, the other
// kernels: the projection argmax (logits_argmax.cu) and the weight and
// attention streams. Each TU gets its own copy (an anonymous namespace).
#pragma once

#include <cstdint>

namespace slimt {
namespace {

// 16 bytes from device memory into shared memory, L2 only (zeros where
// copy is false).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool copy) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(copy ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += A . B for one m16n8k32 tile: a0..a3 the A fragment, b0, b1 the B
// fragment ("row" A, "col" B, int8 in, exact int32 sums).
__device__ __forceinline__ void mma_s8(int* c, unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += A[rows g, g + 8, 64 k] . B[64 k, column g] as two m16n8k32 steps,
// lane (g, i) = (lane / 4, lane % 4) holding bytes 16 i .. 16 i + 15 of
// the slice in lo (row g), hi (row g + 8) and b (column g): words 0-1 go to
// the first step and 2-3 to the second, in A and B alike. The k order
// inside the slice is permuted alike in A and B, which leaves the integer
// sum unchanged.
__device__ __forceinline__ void mma_s8_slice(int* c, const int4& lo, const int4& hi,
                                             const int4& b) {
  mma_s8(c, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
  mma_s8(c, lo.z, hi.z, lo.w, hi.w, b.z, b.w);
}

// acc[mt][nt] += A[16 mt .., s0 .. s0+63] . B[8 nt .., s0 .. s0+63] for
// one warp: a_s holds its first row, b_s its first column, both with k
// contiguous at `pitch` bytes (mma_s8_slice's fragments). With swizzle >=
// 0 (the column of b_s[0] in its block), B's 16-byte piece i of column c
// sits at piece i ^ ((c / 16) % 4) (pitch 64).
template <int MT, int NT>
__device__ __forceinline__ void mma_slice(const int8_t* a_s, const int8_t* b_s,
                                          int pitch, int s0, int (&acc)[MT][NT][4],
                                          int swizzle = -1) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int off = s0 + 16 * (lane % 4);
  int4 lo[MT];
  int4 hi[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    lo[mt] = *reinterpret_cast<const int4*>(a_s + (16 * mt + g) * pitch + off);
    hi[mt] = *reinterpret_cast<const int4*>(a_s + (16 * mt + g + 8) * pitch + off);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int b_off = swizzle < 0 ? off
        : s0 + 16 * ((lane % 4) ^ (((swizzle + 8 * nt + g) / 16) % 4));
    const int4 b = *reinterpret_cast<const int4*>(b_s + (8 * nt + g) * pitch + b_off);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_s8_slice(acc[mt][nt], lo[mt], hi[mt], b);
  }
}

}  // namespace
}  // namespace slimt
