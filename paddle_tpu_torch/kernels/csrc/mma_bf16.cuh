// bf16 tensor-core helpers shared by the attention kernels
// (flash_attention.cu K1-K3, decode_attention.cu flash_decode_mma) and
// quant_matmul.cu:
// mma.sync m16n8k16 with fp32 accumulate, the bf16 pair packing, and the
// fragment loads from shared memory (plain 32-bit loads and ldmatrix).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
// two fp32 values rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return pack2(__float2bfloat16(lo), __float2bfloat16(hi));
}

// c[16x8] += a[16x16] . b[16x8]
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment layouts (PTX ISA, mma.m16n8k16), with g = lane / 4, t = lane % 4:
//   A 16x16: regs at (g, 2t), (g+8, 2t), (g, 2t+8), (g+8, 2t+8), two columns each
//   B 16x8:  regs at (2t, g), (2t+8, g), two rows (k) each
//   C 16x8:  c0, c1 at (g, 2t), (g, 2t+1); c2, c3 at (g+8, 2t), (g+8, 2t+1)

// A fragment of the 16x16 block at (r0, c0) of row-major M
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* M, int ld,
                                       int r0, int c0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bf16* p = M + (r0 + g) * ld + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment with B[k][n] = M[n0 + n][k0 + k]: a product against M^T
__device__ __forceinline__ void frag_bt(uint32_t* b, const bf16* M, int ld,
                                        int n0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bf16* p = M + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragment with B[k][n] = M[k0 + k][n0 + n]: a product against M.
// ldmatrix.trans: lanes 0-15 name the 16 rows k0..k0+15 (8 columns,
// 16 bytes each); each lane receives (M[2t][g], M[2t+1][g]) of the two
// 8x8 halves, the B layout
__device__ __forceinline__ void frag_b(uint32_t* b, const bf16* M, int ld,
                                       int k0, int n0) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(
      M + (k0 + (threadIdx.x & 15)) * ld + n0));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr));
}

// A fragment of k-step kk of a 16-row fp32 accumulator array (8 columns
// per entry), rounded to bf16: the C layout of two n-tiles is the A layout
__device__ __forceinline__ void acc_as_a(uint32_t* a, float (*c)[4], int kk) {
  a[0] = pack2f(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack2f(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack2f(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack2f(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// max and sum over the four lanes (t = 0..3) that share rows g and g + 8
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
