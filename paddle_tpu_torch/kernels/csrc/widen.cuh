// Narrow storage (int8, fp8 e4m3) widened without conversion
// instructions: to bf16 pairs with integer ops and one exact bf16x2
// subtract or multiply (the weight widening of quant_matmul.cu's
// tensor-core bodies), and to f32 (the K/V dequant of decode_attention.cu's
// quantized decode step). Both storage types fit bf16 exactly, so the
// results are bit-equal to torch's .to(torch.bfloat16) and .float().
#pragma once

#include <cuda_fp8.h>
#include <stdint.h>

// a - b and a * b on bf16 pairs (exact where used)
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Two narrow values (bytes 0-1 of w with sel = widen_sel<S>(0), bytes
// 2-3 with widen_sel<S>(1)) as a bf16 pair, the lower byte in the low
// half:
//   int8: the byte's low 7 bits under bf16 128's exponent give 128 + q &
//     127; minus 128 (256 where q < 0) leaves q. |q| <= 128: exact.
//   e4m3: sign, exponent and mantissa shifted into bf16's fields give the
//     value times 2^-120 (exponent bias 127 against 7); one multiply by
//     2^120 is exact, subnormals included.
template <typename S>
__device__ __forceinline__ uint32_t widen_sel(int half);
template <>
__device__ __forceinline__ uint32_t widen_sel<int8_t>(int half) {
  return 0x4140u + 0x0202u * half;  // bytes into halfwords' low bytes
}
template <>
__device__ __forceinline__ uint32_t widen_sel<__nv_fp8_e4m3>(int half) {
  return 0x1404u + 0x2020u * half;  // bytes into halfwords' high bytes
}
template <typename S>
__device__ __forceinline__ uint32_t widen2(uint32_t w, uint32_t sel);
template <>
__device__ __forceinline__ uint32_t widen2<int8_t>(uint32_t w, uint32_t sel) {
  const uint32_t r = __byte_perm(w, 0u, sel);
  return bf16x2_sub((r & 0x007f007fu) | 0x43004300u,
                    (r & 0x00800080u) | 0x43004300u);
}
template <>
__device__ __forceinline__ uint32_t widen2<__nv_fp8_e4m3>(uint32_t w,
                                                          uint32_t sel) {
  const uint32_t r = __byte_perm(w, 0u, sel);
  return bf16x2_mul(((r >> 4) & 0x07f007f0u) | (r & 0x80008000u),
                    0x7b807b80u);  // 2^120
}

// the low and high bf16 of a pair as f32 (exact)
__device__ __forceinline__ float bf16_lo(uint32_t p) {
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}

// lo and hi rounded to bf16 (nearest, ties to even) in one instruction,
// lo in the low half
__device__ __forceinline__ uint32_t round2_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The four narrow values of w (its bytes, lowest first) as f32, exactly.
//   int8: each byte with its sign bit flipped (q + 128) goes under the
//     exponent of 2^23 by one byte permute, which gives the float
//     2^23 + q + 128; one subtraction of 2^23 + 128 leaves q (exact: every
//     operand is an integer below 2^24).
//   e4m3: widen2's bf16 pairs, each half shifted into an f32.
template <typename S>
__device__ __forceinline__ void narrow4_f32(uint32_t w, float* f);
template <>
__device__ __forceinline__ void narrow4_f32<int8_t>(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7650u + i)) -
           8388736.f;  // 2^23 + 128
}
template <>
__device__ __forceinline__ void narrow4_f32<__nv_fp8_e4m3>(uint32_t w,
                                                          float* f) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t p = widen2<__nv_fp8_e4m3>(w, widen_sel<__nv_fp8_e4m3>(h));
    f[2 * h] = bf16_lo(p);
    f[2 * h + 1] = bf16_hi(p);
  }
}
