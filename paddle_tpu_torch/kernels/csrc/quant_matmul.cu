// Weight-only quantized matmul for Hopper (sm_90a):
//   out[m, n] = T( (sum_k x[m, k] * f32(w[n, k])) * scale[n] )
// with x [M, K] in T (bf16 or fp32), w [N, K] int8 or fp8 e4m3, scale [N]
// f32, out [M, N] in T.
//
// Replaces the TPU kernel of paddle_tpu/pallas_kernels/quant_matmul.py:
//   quant_matmul (pallas_call :193, body _qmm_kernel :126): the weight
//   block is widened to x's dtype in the prologue, one f32-accumulated
//   product per k step, the per-channel scale applied to the f32
//   accumulator at the last k step, the result cast to x's dtype.
// Widening int8 (|q| <= 127) or e4m3 to bf16 is exact, and so is bf16 to
// f32, so both bodies widen straight to f32; the kernel and its plain
// version (kernels/quant_matmul.py quant_matmul_ref) differ only in the
// order of the sums.
//
// What bounds it, and what the design does about it:
//   - small M (decode: one row per slot, M <= 16): weight bytes. Every
//     weight byte is used M times, far below the ~295 operations per
//     byte where the card stops being bound by memory. qmm_gemv_tc (bf16)
//     streams the narrow rows once with 16-byte loads, four 64-column
//     steps in flight per lane, and runs the products on the tensor cores
//     with the weight rows as the A operand and x as the 8-column B
//     operand, so the arithmetic costs nothing beside the loads; eight
//     warps split K and meet in shared memory. fp32 x takes qmm_gemv,
//     plain FMA against x staged in shared memory.
//   - large M (a 256-token prefill chunk): operations. qmm_tc runs bf16
//     tensor-core products (mma.sync m16n8k16, f32 accumulate) on 64 x 64
//     output tiles, 64 k at a time through a three-stage cp.async ring in
//     shared memory; the weight crosses device memory and sits in shared
//     memory narrow, and is widened to bf16 only as fragments are built.
//     fp32 x takes qmm_simt, a plain-FMA tiled product in real fp32.
//   - wgmma, TMA and a deeper pipeline are later work.
// K must be a multiple of 16 (the wrapper checks); M and N are free.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// a narrow weight value widened (exact for int8 and e4m3)
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// 16 narrow weight values (one 16-byte vector) as floats
template <typename S>
__device__ __forceinline__ void widen16(const uint4& u, float* out) {
  const S* v = reinterpret_cast<const S*>(&u);
#pragma unroll
  for (int e = 0; e < 16; ++e) out[e] = to_f(v[e]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ===========================================================================
// small M, fp32: weight-streaming GEMV in plain FMA (real fp32)
// ===========================================================================

constexpr int GV_WARPS = 8;
constexpr int GV_ROWS = 4;    // output channels per warp
constexpr int GV_KC = 512;    // columns per chunk: 32 lanes x 16
constexpr int GV_F4 = GV_KC / 4;

// float4 slot of column group f in a staged x row: lane l reads groups
// 4l .. 4l+3, so the xor spreads a quarter-warp's 16-byte reads over
// all eight bank groups
__device__ __forceinline__ int swz(int f) { return f ^ ((f >> 3) & 7); }

template <typename S, int MR>
__global__ void __launch_bounds__(GV_WARPS * 32)
    qmm_gemv(const float* __restrict__ x, const S* __restrict__ w,
             const float* __restrict__ scale, float* __restrict__ out, int M,
             int N, int K) {
  __shared__ float4 sx[MR][GV_F4];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = (blockIdx.x * GV_WARPS + warp) * GV_ROWS;

  float acc[MR][GV_ROWS];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int r = 0; r < GV_ROWS; ++r) acc[m][r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GV_KC) {
    const int kc = min(GV_KC, K - k0);  // a multiple of 16
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < MR * GV_F4; i += GV_WARPS * 32) {
      const int m = i / GV_F4;
      const int f = i % GV_F4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M && f * 4 < kc)
        val = *reinterpret_cast<const float4*>(x + (long long)m * K + k0 + f * 4);
      sx[m][swz(f)] = val;
    }
    __syncthreads();

    const int c = lane * 16;
    if (c >= kc) continue;
    float wf[GV_ROWS][16];
#pragma unroll
    for (int r = 0; r < GV_ROWS; ++r) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < N)
        u = *reinterpret_cast<const uint4*>(w + (long long)(n0 + r) * K + k0 + c);
      widen16<S>(u, wf[r]);
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m < M) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 xv = sx[m][swz(lane * 4 + q)];
#pragma unroll
          for (int r = 0; r < GV_ROWS; ++r) {
            float a = acc[m][r];
            a = fmaf(xv.x, wf[r][4 * q], a);
            a = fmaf(xv.y, wf[r][4 * q + 1], a);
            a = fmaf(xv.z, wf[r][4 * q + 2], a);
            a = fmaf(xv.w, wf[r][4 * q + 3], a);
            acc[m][r] = a;
          }
        }
      }
    }
  }

  // reduce over the lanes; lane (m * GV_ROWS + r) % 32 stores the output
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int r = 0; r < GV_ROWS; ++r) {
      const float s = warp_sum(acc[m][r]);
      const int n = n0 + r;
      if (m < M && n < N && lane == (m * GV_ROWS + r) % 32)
        out[(long long)m * N + n] = s * scale[n];
    }
  }
}

// ===========================================================================
// large M, bf16: tensor cores (mma.sync m16n8k16, f32 accumulate)
// ===========================================================================

constexpr int TM = 64;   // rows of x per block
constexpr int TN = 64;   // output channels per block

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

// 4 warps in 2 x 2, each a 32 x 32 corner of the 64 x 64 output tile;
// tiles of 64 k stream through a STAGES-deep cp.async ring: x as bf16,
// the weight as its narrow bytes, widened only when a fragment is built.
// As in qmm_gemv_tc, a fragment's k order is permuted the same way for
// both operands: lane t of a k16 step takes real columns 4t .. 4t+3, so
// an A fragment pair is one 8-byte shared load and a B fragment pair is
// one 4-byte load of narrow weights.
constexpr int TK = 64;                // k per stage
constexpr int STAGES = 3;
constexpr int ALD = TK + 16;          // x row: 160 bytes, conflict-free
constexpr int WLD = TK + 16;          // weight row: 80 bytes, conflict-free

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

// two narrow weight values (bytes i, i + 1 of word u) as a bf16 pair
template <typename S>
__device__ __forceinline__ uint32_t pair_bf16w(uint32_t u, int i) {
  const S* v = reinterpret_cast<const S*>(&u);
  const __nv_bfloat162 h = __floats2bfloat162_rn(to_f(v[i]), to_f(v[i + 1]));
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename S>
__global__ void __launch_bounds__(128)
    qmm_tc(const bf16* __restrict__ x, const S* __restrict__ w,
           const float* __restrict__ scale, bf16* __restrict__ out, int M,
           int N, int K) {
  __shared__ __align__(16) bf16 sA[STAGES][TM * ALD];
  __shared__ __align__(16) uint8_t sW[STAGES][TN * WLD];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(w);

  // a stage: x tile 64 rows x 128 bytes (4 chunks of 16 bytes a thread),
  // weight tile 64 rows x 64 bytes (2 chunks a thread); out-of-range
  // chunks are zero-filled (K % 16 == 0: a chunk is whole or outside)
  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * 128;
      const int r = idx >> 3, c = (idx & 7) * 8;
      const bool ok = m0 + r < M && k0 + c < K;
      cp_async16(sA[stage] + r * ALD + c,
                 ok ? x + (long long)(m0 + r) * K + k0 + c : x, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * 128;
      const int r = idx >> 2, c = (idx & 3) * 16;
      const bool ok = n0 + r < N && k0 + c < K;
      cp_async16(sW[stage] + r * WLD + c,
                 ok ? wb + (long long)(n0 + r) * K + k0 + c : wb, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + TK - 1) / TK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s * TK);
    else asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();  // tile kt landed; every warp is done with kt - 1
    const int next = kt + STAGES - 1;
    if (next < nk) load(next % STAGES, next * TK);
    else asm volatile("cp.async.commit_group;\n" ::);
    const bf16* A = sA[kt % STAGES];
    const uint8_t* W = sW[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint2 lo = *reinterpret_cast<const uint2*>(
            A + (wm + 16 * i + g) * ALD + kk + 4 * t);
        const uint2 hi = *reinterpret_cast<const uint2*>(
            A + (wm + 16 * i + g + 8) * ALD + kk + 4 * t);
        a[i][0] = lo.x;
        a[i][1] = hi.x;
        a[i][2] = lo.y;
        a[i][3] = hi.y;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t u = *reinterpret_cast<const uint32_t*>(
            W + (wn + 8 * j + g) * WLD + kk + 4 * t);
        b[j][0] = pair_bf16w<S>(u, 0);
        b[j][1] = pair_bf16w<S>(u, 2);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816(acc[i][j], a[i], b[j]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // C layout: c0, c1 at (g, 2t), (g, 2t+1); c2, c3 at (g+8, 2t), (g+8, 2t+1)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + j * 8 + 2 * t;
    const float s0 = n < N ? scale[n] : 0.f;
    const float s1 = n + 1 < N ? scale[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + 8 * h;
        if (m >= M) continue;
        bf16* dst = out + (long long)m * N + n;
        if (n < N) dst[0] = __float2bfloat16(acc[i][j][2 * h] * s0);
        if (n + 1 < N) dst[1] = __float2bfloat16(acc[i][j][2 * h + 1] * s1);
      }
    }
  }
}

// ===========================================================================
// small M, bf16: the weight-streaming GEMV on the tensor cores
// ===========================================================================
//
// out^T[N, M] = W[N, K] . x^T[K, M]: weight rows are the 16 rows of an
// mma.m16n8k16 A operand, the (up to 8) rows of x its 8 B columns, so the
// products cost nothing and the kernel is left with moving the weight.
// A dot product may sum its k terms in any order, so each lane loads 16
// CONTIGUOUS bytes of its two weight rows (g and g + 8 of the tile) and 16
// contiguous bf16 of x row g at column k + 16t, and the four mma k-steps of
// a 64-column step take their fragments from those registers: virtual k
// (2t, 2t+1, 2t+8, 2t+9) of step j is real k + 16t + 4j + (0, 1, 2, 3), the
// same permutation for W and x. No shared memory is needed for x: it is a
// few tens of KB, read through L1. The eight warps of a block share 32 rows
// and split K eight ways (enough warps in flight to cover memory latency at
// N = 4096); their partial sums meet in shared memory, in a fixed order,
// where one multiply by scale[n] ends each output.

constexpr int TG_WARPS = 8;     // warps per block, one K slice each
constexpr int TG_TILES = 2;     // 16-row weight tiles per block
constexpr int TG_ROWS = 16 * TG_TILES;
constexpr int TG_UNROLL = 4;    // 64-column steps whose loads are in flight

// MT n8 tiles of x rows: M <= 8 * MT
template <typename S, int MT>
__global__ void __launch_bounds__(TG_WARPS * 32)
    qmm_gemv_tc(const bf16* __restrict__ x, const S* __restrict__ w,
                const float* __restrict__ scale, bf16* __restrict__ out,
                int M, int N, int K) {
  __shared__ float red[TG_WARPS][TG_TILES][MT][16][8];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * TG_ROWS;
  const int steps = (K + 63) / 64;
  const int per = (steps + TG_WARPS - 1) / TG_WARPS;
  const int s_begin = warp * per;
  const int s_end = min(steps, s_begin + per);

  float acc[TG_TILES][MT][4];
#pragma unroll
  for (int i = 0; i < TG_TILES; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int s0 = s_begin; s0 < s_end; s0 += TG_UNROLL) {
    uint4 wa[TG_UNROLL][TG_TILES][2];
    uint4 xb[TG_UNROLL][MT][2];
#pragma unroll
    for (int u = 0; u < TG_UNROLL; ++u) {
      const int k = (s0 + u) * 64 + 16 * t;
      const bool kin = s0 + u < s_end && k < K;  // K % 16 == 0: whole chunks
#pragma unroll
      for (int i = 0; i < TG_TILES; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + 16 * i + g + 8 * h;
          wa[u][i][h] = make_uint4(0u, 0u, 0u, 0u);
          if (kin && n < N)
            wa[u][i][h] = *reinterpret_cast<const uint4*>(w + (long long)n * K + k);
        }
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int m = g + 8 * j;
        xb[u][j][0] = xb[u][j][1] = make_uint4(0u, 0u, 0u, 0u);
        if (kin && m < M) {
          const uint4* p = reinterpret_cast<const uint4*>(x + (long long)m * K + k);
          xb[u][j][0] = p[0];
          xb[u][j][1] = p[1];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < TG_UNROLL; ++u) {
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        uint32_t b[MT][2];
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const uint32_t* xw = reinterpret_cast<const uint32_t*>(xb[u][j]);
          b[j][0] = xw[2 * st];
          b[j][1] = xw[2 * st + 1];
        }
#pragma unroll
        for (int i = 0; i < TG_TILES; ++i) {
          const uint32_t lo = reinterpret_cast<const uint32_t*>(&wa[u][i][0])[st];
          const uint32_t hi = reinterpret_cast<const uint32_t*>(&wa[u][i][1])[st];
          uint32_t a[4];
          a[0] = pair_bf16w<S>(lo, 0);
          a[1] = pair_bf16w<S>(hi, 0);
          a[2] = pair_bf16w<S>(lo, 2);
          a[3] = pair_bf16w<S>(hi, 2);
#pragma unroll
          for (int j = 0; j < MT; ++j) mma16816(acc[i][j], a, b[j]);
        }
      }
    }
  }

  // C layout: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g + 8;
  // rows are weight rows n, columns rows m of x
#pragma unroll
  for (int i = 0; i < TG_TILES; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      red[warp][i][j][g][2 * t] = acc[i][j][0];
      red[warp][i][j][g][2 * t + 1] = acc[i][j][1];
      red[warp][i][j][g + 8][2 * t] = acc[i][j][2];
      red[warp][i][j][g + 8][2 * t + 1] = acc[i][j][3];
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TG_TILES * MT * 128;
       idx += TG_WARPS * 32) {
    const int c = idx & 7;
    const int r = (idx >> 3) & 15;
    const int j = (idx >> 7) % MT;
    const int i = (idx >> 7) / MT;
    const int n = n0 + 16 * i + r;
    const int m = c + 8 * j;
    if (n >= N || m >= M) continue;
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < TG_WARPS; ++wp) sum += red[wp][i][j][r][c];
    out[(long long)m * N + n] = __float2bfloat16(sum * scale[n]);
  }
}

// ===========================================================================
// large M, fp32: plain-FMA tiles (real fp32, for card-against-CPU parity)
// ===========================================================================

constexpr int FM = 64;
constexpr int FN = 64;
constexpr int FK = 16;
constexpr int FLD = FM + 4;  // padded shared row, 16-byte aligned

// 256 threads, each a 4 x 4 block of the 64 x 64 output tile
template <typename S>
__global__ void __launch_bounds__(256)
    qmm_simt(const float* __restrict__ x, const S* __restrict__ w,
             const float* __restrict__ scale, float* __restrict__ out, int M,
             int N, int K) {
  __shared__ __align__(16) float sA[FK * FLD];  // [k][m]
  __shared__ __align__(16) float sB[FK * FLD];  // [k][n]
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * FM;
  const int n0 = blockIdx.x * FN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FK) {  // K % 16 == 0: whole tiles
    {
      const int r = tid >> 2, c = (tid & 3) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M) v = *reinterpret_cast<const float4*>(x + (long long)(m0 + r) * K + k0 + c);
      sA[(c + 0) * FLD + r] = v.x;
      sA[(c + 1) * FLD + r] = v.y;
      sA[(c + 2) * FLD + r] = v.z;
      sA[(c + 3) * FLD + r] = v.w;
    }
    if (tid < FN) {
      float f[16];
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + tid < N)
        u = *reinterpret_cast<const uint4*>(w + (long long)(n0 + tid) * K + k0);
      widen16<S>(u, f);
#pragma unroll
      for (int e = 0; e < 16; ++e) sB[e * FLD + tid] = f[e];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(sA + k * FLD + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(sB + k * FLD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(long long)m * N + n] = acc[i][j] * scale[n];
    }
  }
}

// ===========================================================================
// launch
// ===========================================================================

constexpr int SMALL_M = 16;

template <typename S, int MR>
cudaError_t launch_gemv(const void* x, const void* w, const float* scale,
                        void* out, int M, int N, int K, cudaStream_t st) {
  const int blocks = (N + GV_WARPS * GV_ROWS - 1) / (GV_WARPS * GV_ROWS);
  qmm_gemv<S, MR><<<blocks, GV_WARPS * 32, 0, st>>>(
      static_cast<const float*>(x), static_cast<const S*>(w), scale,
      static_cast<float*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename S, int MT>
cudaError_t launch_gemv_tc(const void* x, const void* w, const float* scale,
                           void* out, int M, int N, int K, cudaStream_t st) {
  qmm_gemv_tc<S, MT><<<(N + TG_ROWS - 1) / TG_ROWS, TG_WARPS * 32, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const S*>(w), scale,
      static_cast<bf16*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_t(const void* x, const void* w, const float* scale,
                     void* out, int M, int N, int K, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    if (M <= 8) return launch_gemv_tc<S, 1>(x, w, scale, out, M, N, K, st);
    if (M <= SMALL_M)
      return launch_gemv_tc<S, 2>(x, w, scale, out, M, N, K, st);
  } else {
    if (M <= 1) return launch_gemv<S, 1>(x, w, scale, out, M, N, K, st);
    if (M <= 2) return launch_gemv<S, 2>(x, w, scale, out, M, N, K, st);
    if (M <= 4) return launch_gemv<S, 4>(x, w, scale, out, M, N, K, st);
    if (M <= 8) return launch_gemv<S, 8>(x, w, scale, out, M, N, K, st);
    if (M <= SMALL_M)
      return launch_gemv<S, SMALL_M>(x, w, scale, out, M, N, K, st);
  }
  if constexpr (sizeof(T) == 2) {
    const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    qmm_tc<S><<<grid, 128, 0, st>>>(static_cast<const bf16*>(x),
                                    static_cast<const S*>(w), scale,
                                    static_cast<bf16*>(out), M, N, K);
  } else {
    const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    qmm_simt<S><<<grid, 256, 0, st>>>(static_cast<const float*>(x),
                                      static_cast<const S*>(w), scale,
                                      static_cast<float*>(out), M, N, K);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes: x [M, K] (bf16 if is_bf16 else fp32), w [N, K]
// (fp8 e4m3 if is_fp8 else int8), scale [N] f32, out [M, N] in x's dtype,
// all contiguous and 16-byte aligned, K % 16 == 0. Returns the
// cudaError_t of the launch (0 = accepted).
extern "C" int paddle_quant_matmul(const void* x, const void* w,
                                   const void* scale, void* out, int is_bf16,
                                   int is_fp8, int M, int N, int K,
                                   void* stream) {
  if (K % 16 != 0 || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  cudaError_t e;
  if (is_bf16)
    e = is_fp8 ? launch_t<bf16, __nv_fp8_e4m3>(x, w, s, out, M, N, K, st)
               : launch_t<bf16, int8_t>(x, w, s, out, M, N, K, st);
  else
    e = is_fp8 ? launch_t<float, __nv_fp8_e4m3>(x, w, s, out, M, N, K, st)
               : launch_t<float, int8_t>(x, w, s, out, M, N, K, st);
  return static_cast<int>(e);
}
