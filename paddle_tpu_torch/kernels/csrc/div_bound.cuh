// Division by a storage type's absmax bound (127 for int8, 448 for fp8
// e4m3), correctly rounded, without a division instruction: the dequant of
// decode_attention.cu's tensor-core body, where IEEE division's
// subroutine (a check and a branch per value) bounded the narrow tiles.
#pragma once

#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

// x / bound correctly rounded without a division: q0 = x * RN(1 / bound),
// then one fma correction from the exact residual (Markstein). For bound
// 127 and 448 this equals RN(x / bound) for x = 0 (its sign kept) and for
// every |x| in [2^-90, 2^100], where the intermediates stay normal:
// checked exhaustively, emulated over all float32 x in [1, 2) (scaling by
// powers of two is exact; tests/torch_port/test_torch_decode_attention.py)
// and on the card against __fdiv_rn over every such x
// (test_torch_kernels_cuda.py).
template <typename S>
__device__ __forceinline__ float div_bound(float x) {
  constexpr float y = std::is_same<S, int8_t>::value ? 127.f : 448.f;
  constexpr float r = 1.f / y;
  const float q0 = __fmul_rn(x, r);
  return copysignf(fmaf(fmaf(-q0, y, x), r, q0), x);
}

// A scale s for which every f32(q) * s of the storage lies in div_bound's
// range: zero, or (|q| from 2^-9, fp8's least subnormal, to 448) s in
// [2^-80, 2^90]. A zero scale is a row no key of which is read.
__device__ __forceinline__ bool exact_scale(float s) {
  return s == 0.f || (s >= 0x1p-80f && s <= 0x1p90f);
}
