// Fused NHWC stride-1 convolution for Hopper (sm_90a), with one of two
// epilogues and an optional prologue:
//   K10 (eval):   out = T(relu?(conv(x, w) * scale[k] + shift[k]))
//   K11 (train):  out = T(conv(pre?(x), w)) plus, per row tile, the
//                 per-channel sum and sum of squares of the f32 accumulator
//   pre (K11):    x -> T(relu?(f32(x) * ps[c] + pb[c])), the previous
//                 BatchNorm's normalize(+ReLU) applied as x is loaded
// x [N*H*W, C] and out [N*H*W, K] in T (bf16 or fp32), w [taps, K, C] in T
// (OIHW relaid as tap-major, output-channel rows), scale/shift/ps/pb f32.
// Kernels 3x3 (pad 1) and 1x1 (pad 0).
//
// Replaces the TPU kernels of paddle_tpu/pallas_kernels/fused_conv.py:
//   _pallas_epilogue (pallas_call :199, body _epilogue_kernel :158) -> K10
//   _pallas_stats    (pallas_call :255, body _stats_kernel :168,
//                     prologue _conv_acc :108-126)               -> K11
// Both share the TPU's main loop (_conv_acc :95-155): the conv is a sum of
// tap matmuls over the flat rows, tap (di, dj) reading row
// m + (di - pad) * W + (dj - pad), zero where the tap crosses an image
// edge. The TPU tiles whole images so that no tap leaves its block; here a
// row tile reads its halo straight from device memory, with the edge mask
// from (row % HW) / W and row % W, so an image of any size works (a 1x1
// image under a 3x3 kernel, where the TPU block has no rows left to slice,
// included).
//
// Masking after the prologue: padding is zero in the NORMALIZED
// activation, so a masked tap loads zero and skips the prologue (normalize
// of a zero would give pb, not 0). The normalized value is rounded to T
// before the product, as the TPU prologue casts back to x's dtype.
//
// Statistics come from the f32 accumulator before it is rounded to T.
// Each block writes its tile's partial sums to [tiles, K] buffers, in a
// fixed order (thread rows, then a warp shuffle tree, then the two warp
// rows); the wrapper sums the tiles. No atomics: the result is the same
// from run to run.
//
// What bounds it, and what the design does about it: ResNet-50's convs at
// batch 256 do 50-460 operations per byte of x + w + y, above the card's
// ~295 at the large-channel 1x1 and 3x3 layers and below it at the 64- and
// 128-channel 1x1 ones, so both bounds matter. conv_mma (bf16, C % 8 == 0)
// runs the tap products on the tensor cores (mma.sync m16n8k16, f32
// accumulate) over 128 x 64 output tiles, 32 channels of one tap a step,
// with the next step's x and w loaded into registers (16-byte loads)
// while the tensor cores work on the current one from shared memory, two
// shared buffers. Blocks of one row tile run side by side over the output
// channels, so x crosses device memory about once. conv_simt (fp32, and
// bf16 with C % 8 != 0) is a plain-FMA tiled product in real fp32, for
// the parity runs and odd channel counts. wgmma, TMA and a deeper
// pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// the prologue of one value: relu?(x * s + b), rounded to T
template <typename T>
__device__ __forceinline__ float prologue(float v, float s, float b,
                                          bool relu_in) {
  float y = v * s + b;
  if (relu_in) y = fmaxf(y, 0.f);
  return to_f(from_f<T>(y));
}

struct Conv {
  int M, H, W, HW, C, K, ks, pad;
};

// ===========================================================================
// bf16, C % 8 == 0: tensor cores
// ===========================================================================

constexpr int TM = 128;  // output rows per block
constexpr int TN = 64;   // output channels per block
constexpr int TK = 32;   // input channels per step (one tap)
constexpr int LD = 48;   // shared row stride in bf16: conflict-free reads

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragments are read with k permuted alike for A and B (the sum over k
// within a 16-step is order-free): thread (g = lane / 4, t = lane % 4)
// takes k 4t .. 4t + 3 of its rows as one 8-byte read; a[0]/a[2] hold row
// g's first and second pair, a[1]/a[3] row g + 8's; b[0]/b[1] output
// channel g's. Rows of LD = 48 bf16 (24 words) put the 4 rows a half-warp
// reads on disjoint banks.
template <bool STATS, bool PRE>
__global__ void __launch_bounds__(128)
    conv_mma(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const float* __restrict__ ep_scale,
             const float* __restrict__ ep_shift,
             const float* __restrict__ ps, const float* __restrict__ pb,
             bf16* __restrict__ out, float* __restrict__ part1,
             float* __restrict__ part2, Conv p, bool relu, bool relu_in) {
  __shared__ __align__(16) bf16 sA[2][TM * LD];
  __shared__ __align__(16) bf16 sB[2][TN * LD];
  __shared__ float red[2][2][TN];  // [s1/s2][warp row][channel]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TM;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;

  // this thread's load slots: chunk cc (8 channels) of rows r + 32 i
  const int cc = (tid & 3) * 8;
  const int r0 = tid >> 2;
  int mrow[4], irow[4], jrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + r0 + 32 * i;
    mrow[i] = m;
    const int q = m % p.HW;
    irow[i] = m < p.M ? q / p.W : -1000000;  // out of range: never valid
    jrow[i] = q % p.W;
  }

  const int CT = (p.C + TK - 1) / TK;
  const int nk = p.ks * p.ks * CT;

  uint4 ra[4], rb[2];
  unsigned amask = 0;
  float4 pss[2], pbs[2];

  auto load = [&](int kt) {
    const int tap = kt / CT;
    const int c = (kt - tap * CT) * TK + cc;
    const int dy = tap / p.ks - p.pad, dx = tap % p.ks - p.pad;
    const bool cin = c < p.C;
    amask = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = cin && (unsigned)(irow[i] + dy) < (unsigned)p.H &&
                      (unsigned)(jrow[i] + dx) < (unsigned)p.W;
      ra[i] = make_uint4(0u, 0u, 0u, 0u);
      if (ok) {
        const long long src = (long long)mrow[i] + dy * p.W + dx;
        ra[i] = __ldg(reinterpret_cast<const uint4*>(x + src * p.C + c));
        amask |= 1u << i;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + r0 + 32 * j;
      rb[j] = make_uint4(0u, 0u, 0u, 0u);
      if (cin && n < p.K)
        rb[j] = __ldg(reinterpret_cast<const uint4*>(
            w + ((long long)tap * p.K + n) * p.C + c));
    }
    if (PRE && cin) {
      pss[0] = __ldg(reinterpret_cast<const float4*>(ps + c));
      pss[1] = __ldg(reinterpret_cast<const float4*>(ps + c + 4));
      pbs[0] = __ldg(reinterpret_cast<const float4*>(pb + c));
      pbs[1] = __ldg(reinterpret_cast<const float4*>(pb + c + 4));
    }
  };

  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint4 v = ra[i];
      if (PRE && (amask >> i & 1u)) {
        bf16* e = reinterpret_cast<bf16*>(&v);
        const float s[8] = {pss[0].x, pss[0].y, pss[0].z, pss[0].w,
                            pss[1].x, pss[1].y, pss[1].z, pss[1].w};
        const float b[8] = {pbs[0].x, pbs[0].y, pbs[0].z, pbs[0].w,
                            pbs[1].x, pbs[1].y, pbs[1].z, pbs[1].w};
#pragma unroll
        for (int q = 0; q < 8; ++q)
          e[q] = __float2bfloat16(
              prologue<bf16>(__bfloat162float(e[q]), s[q], b[q], relu_in));
      }
      *reinterpret_cast<uint4*>(sA[buf] + (r0 + 32 * i) * LD + cc) = v;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<uint4*>(sB[buf] + (r0 + 32 * j) * LD + cc) = rb[j];
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load(kt + 1);  // in flight while the tensor cores run
    const bf16* A = sA[cur];
    const bf16* B = sB[cur];
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint2 lo = *reinterpret_cast<const uint2*>(
            A + (wm + 16 * i + g) * LD + kk + 4 * t);
        const uint2 hi = *reinterpret_cast<const uint2*>(
            A + (wm + 16 * i + g + 8) * LD + kk + 4 * t);
        a[i][0] = lo.x;
        a[i][1] = hi.x;
        a[i][2] = lo.y;
        a[i][3] = hi.y;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint2 u = *reinterpret_cast<const uint2*>(
            B + (wn + 8 * j + g) * LD + kk + 4 * t);
        b[j][0] = u.x;
        b[j][1] = u.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816(acc[i][j], a[i], b[j]);
    }
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

  // C layout: acc[i][j][0..1] at row g, channels 2t, 2t+1 of tile (i, j);
  // acc[i][j][2..3] at row g + 8. Rows past M hold exact zeros (their x
  // was never loaded), so the sums need no row mask.
  const bool pair = (p.K & 1) == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + 8 * j + 2 * t;
    float sc0 = 1.f, sc1 = 1.f, sh0 = 0.f, sh1 = 0.f;
    if (!STATS) {
      if (n < p.K) sc0 = ep_scale[n], sh0 = ep_shift[n];
      if (n + 1 < p.K) sc1 = ep_scale[n + 1], sh1 = ep_shift[n + 1];
    }
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (STATS) {
          s1[0] += v0;
          s1[1] += v1;
          s2[0] += v0 * v0;
          s2[1] += v1 * v1;
        } else {
          v0 = v0 * sc0 + sh0;
          v1 = v1 * sc1 + sh1;
          if (relu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
        }
        const int m = m0 + wm + 16 * i + g + 8 * h;
        if (m >= p.M) continue;
        bf16* dst = out + (long long)m * p.K + n;
        if (pair && n + 1 < p.K) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (n < p.K) dst[0] = __float2bfloat16(v0);
          if (n + 1 < p.K) dst[1] = __float2bfloat16(v1);
        }
      }
    }
    if (STATS) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], o);
          s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], o);
        }
        if (g == 0) {
          red[0][warp >> 1][wn + 8 * j + 2 * t + e] = s1[e];
          red[1][warp >> 1][wn + 8 * j + 2 * t + e] = s2[e];
        }
      }
    }
  }
  if (STATS) {
    __syncthreads();
    if (tid < TN && n0 + tid < p.K) {
      const long long o = (long long)blockIdx.y * p.K + n0 + tid;
      part1[o] = red[0][0][tid] + red[0][1][tid];
      part2[o] = red[1][0][tid] + red[1][1][tid];
    }
  }
}

// ===========================================================================
// fp32 (and bf16 with C % 8 != 0): plain FMA in real fp32
// ===========================================================================

constexpr int SM = 64, SN = 64, SK = 16;  // 256 threads, 4 x 4 outputs each

template <typename T, bool STATS, bool PRE>
__global__ void __launch_bounds__(256)
    conv_simt(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ ep_scale,
              const float* __restrict__ ep_shift,
              const float* __restrict__ ps, const float* __restrict__ pb,
              T* __restrict__ out, float* __restrict__ part1,
              float* __restrict__ part2, Conv p, bool relu, bool relu_in) {
  __shared__ float sA[SK][SM];
  __shared__ float sB[SK][SN];
  __shared__ float red[2][16][SN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * SN;
  const int m0 = blockIdx.y * SM;
  const int CT = (p.C + SK - 1) / SK;
  const int nk = p.ks * p.ks * CT;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int tap = kt / CT;
    const int c0 = (kt - tap * CT) * SK;
    const int dy = tap / p.ks - p.pad, dx = tap % p.ks - p.pad;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + 256 * q;
      const int r = e >> 4, k = e & 15;
      const int m = m0 + r, c = c0 + k;
      float v = 0.f;
      if (m < p.M && c < p.C) {
        const int rem = m % p.HW;
        const int i = rem / p.W + dy, j = rem % p.W + dx;
        if ((unsigned)i < (unsigned)p.H && (unsigned)j < (unsigned)p.W) {
          v = to_f(x[((long long)m + dy * p.W + dx) * p.C + c]);
          if (PRE) v = prologue<T>(v, ps[c], pb[c], relu_in);
        }
      }
      sA[k][r] = v;
      const int n = n0 + r;
      sB[k][r] = (n < p.K && c < p.C)
                     ? to_f(w[((long long)tap * p.K + n) * p.C + c])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * i;
      float v = acc[i][j];
      if (STATS) {
        s1 += v;  // rows past M hold exact zeros
        s2 += v * v;
      } else if (n < p.K) {
        v = v * ep_scale[n] + ep_shift[n];
        if (relu) v = fmaxf(v, 0.f);
      }
      if (m < p.M && n < p.K) out[(long long)m * p.K + n] = from_f<T>(v);
    }
    if (STATS) {
      red[0][ty][tx + 16 * j] = s1;
      red[1][ty][tx + 16 * j] = s2;
    }
  }
  if (STATS) {
    __syncthreads();
    if (tid < SN && n0 + tid < p.K) {
      float s1 = 0.f, s2 = 0.f;
      for (int r = 0; r < 16; ++r) s1 += red[0][r][tid], s2 += red[1][r][tid];
      const long long o = (long long)blockIdx.y * p.K + n0 + tid;
      part1[o] = s1;
      part2[o] = s2;
    }
  }
}

bool use_mma(int is_bf16, int C) { return is_bf16 && C % 8 == 0; }

template <bool STATS, bool PRE>
cudaError_t launch(const void* x, const void* w, const float* sc,
                   const float* sh, const float* ps, const float* pb,
                   void* out, float* p1, float* p2, int is_bf16,
                   const Conv& p, bool relu, bool relu_in, int tiles,
                   cudaStream_t st) {
  if (use_mma(is_bf16, p.C)) {
    const int mt = (p.M + TM - 1) / TM;
    if (mt > 65535 || (STATS && tiles != mt)) return cudaErrorInvalidValue;
    const dim3 grid((p.K + TN - 1) / TN, mt);
    conv_mma<STATS, PRE><<<grid, 128, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), sc, sh, ps,
        pb, static_cast<bf16*>(out), p1, p2, p, relu, relu_in);
  } else {
    const int mt = (p.M + SM - 1) / SM;
    if (mt > 65535 || (STATS && tiles != mt)) return cudaErrorInvalidValue;
    const dim3 grid((p.K + SN - 1) / SN, mt);
    if (is_bf16)
      conv_simt<bf16, STATS, PRE><<<grid, 256, 0, st>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w), sc, sh,
          ps, pb, static_cast<bf16*>(out), p1, p2, p, relu, relu_in);
    else
      conv_simt<float, STATS, PRE><<<grid, 256, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(w), sc, sh,
          ps, pb, static_cast<float*>(out), p1, p2, p, relu, relu_in);
  }
  return cudaGetLastError();
}

}  // namespace

// Output rows per block (and so per statistics partial) of the body that
// takes these inputs; the wrapper sizes the [tiles, K] partials with it.
extern "C" int paddle_fused_conv_tile_rows(int is_bf16, int C) {
  return use_mma(is_bf16, C) ? TM : SM;
}

// stats 0: K10 (ep_scale, ep_shift, relu; no partials, no prologue).
// stats 1: K11 (part1, part2 of [tiles, K]; prologue ps, pb, relu_in when
// pre is 1). x, w and, for the prologue, ps and pb 16-byte aligned.
extern "C" int paddle_fused_conv(const void* x, const void* w,
                                 const void* ep_scale, const void* ep_shift,
                                 const void* ps, const void* pb, void* out,
                                 void* part1, void* part2, int is_bf16,
                                 int stats, int relu, int pre, int relu_in,
                                 int N, int H, int W, int C, int K, int ksize,
                                 int tiles, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || K < 1 ||
      (ksize != 1 && ksize != 3) || (pre && !stats))
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)N * H * W;
  if (m >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  Conv p{(int)m, H, W, H * W, C, K, ksize, (ksize - 1) / 2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(ep_scale);
  const float* sh = static_cast<const float*>(ep_shift);
  const float* s = static_cast<const float*>(ps);
  const float* b = static_cast<const float*>(pb);
  float* p1 = static_cast<float*>(part1);
  float* p2 = static_cast<float*>(part2);
  cudaError_t e;
  if (!stats)
    e = launch<false, false>(x, w, sc, sh, s, b, out, p1, p2, is_bf16, p,
                             relu != 0, false, tiles, st);
  else if (pre)
    e = launch<true, true>(x, w, sc, sh, s, b, out, p1, p2, is_bf16, p, false,
                           relu_in != 0, tiles, st);
  else
    e = launch<true, false>(x, w, sc, sh, s, b, out, p1, p2, is_bf16, p,
                            false, false, tiles, st);
  return static_cast<int>(e);
}
