// Division by a storage type's absmax bound (127 for int8, 448 for fp8
// e4m3), correctly rounded, without a division instruction: the dequant of
// decode_attention.cu's quantized bodies (flash_decode_mma's tiles and
// flash_decode_qrows' decode step), where IEEE division's subroutine (a
// check and a branch per value) bounded the narrow K/V.
#pragma once

#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

// x / bound correctly rounded without a division, in two operations:
// zh = 1 / bound rounded down to f32, zl = RN(1 / bound - zh) > 0, then
// RN(x * zh + RN(x * zl)) in one fma (the division by a constant known in
// advance of Brisebarre, Muller and Raina). For bound 127 and 448 this
// equals RN(x / bound) for x = 0 (its sign kept: both terms carry it) and
// for every |x| in [2^-90, 2^100], where x * zl stays normal: checked
// exhaustively, emulated over all float32 x in [1, 2) (scaling by powers
// of two is exact; tests/torch_port/test_torch_decode_attention.py) and on
// the card against __fdiv_rn over every such x (test_torch_kernels_cuda.py).
template <typename S>
__device__ __forceinline__ float div_bound(float x) {
  constexpr bool kInt8 = std::is_same<S, int8_t>::value;
  constexpr float zh = kInt8 ? 0x1.020408p-7f : 0x1.249248p-9f;
  constexpr float zl = kInt8 ? 0x1.020408p-35f : 0x1.24924ap-33f;
  return fmaf(x, zh, __fmul_rn(x, zl));
}

// A scale s for which every f32(q) * s of the storage lies in div_bound's
// range: zero, or (|q| from 2^-9, fp8's least subnormal, to 448) s in
// [2^-80, 2^90]. A zero scale is a row no key of which is read.
__device__ __forceinline__ bool exact_scale(float s) {
  return s == 0.f || (s >= 0x1p-80f && s <= 0x1p90f);
}
