// Tensor-core helpers shared by the 3xTF32 kernels (K1 upsample.cu, K2 and
// K5 film_resblock.cuh): cp.async staging, the hi + lo split of an f32
// operand and one mma.sync m16n8k8 TF32 product.
//
// 3xTF32 splits each operand a = hi + lo (hi = a rounded to TF32, lo = a -
// hi) and sums lo*hi + hi*lo, then hi*hi, in f32 (CUTLASS's order): three
// TF32 products per f32 product, with an error near f32's (the dropped
// lo*lo is 2^-22 relative). The tensor cores' f32 sums truncate, so a
// kernel keeps a partial sum over a few k8 steps only and adds it to its
// accumulator on the FMA pipe, rounded to nearest.
//
// Fragment layout of m16n8k8 (g = lane / 4, t4 = lane % 4): A (row-major
// 16 x 8) a0 = A[g][t4], a1 = A[g+8][t4], a2 = A[g][t4+4], a3 =
// A[g+8][t4+4]; B (8 x 8) b0 = B[t4][g], b1 = B[t4+4][g]; C (16 x 8) c0,
// c1 = C[g][2t4, 2t4+1], c2, c3 = C[g+8][2t4, 2t4+1].
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a = hi + lo. hi is a rounded to TF32 (nearest, ties away, as
// cvt.rna.tf32.f32 does) with two integer ops: the cvt instructions made
// K1 slower on an H100. lo = a - hi is exact and goes to the
// tensor cores as it is: they read its top 19 bits, which truncates lo to
// TF32 (an error below 2^-21 of a).
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(a, __uint_as_float(hi)));
}

// c = a . b + (kZero ? 0 : c)
template <bool kZero>
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  const float z = 0.f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(kZero ? z : c[0]), "f"(kZero ? z : c[1]), "f"(kZero ? z : c[2]),
        "f"(kZero ? z : c[3]));
}

}  // namespace tf32x3
