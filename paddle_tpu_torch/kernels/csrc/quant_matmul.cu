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
// Widening int8 (|q| <= 128) or e4m3 to bf16 is exact, and so is bf16 to
// f32, so every body widens exactly; the kernel and its plain version
// (kernels/quant_matmul.py quant_matmul_ref) differ only in the order of
// the sums.
//
// What bounds it, and what the design does about it:
//   - small M (decode: one row per slot, M <= 16): weight bytes. Every
//     weight byte is used M times, far below the ~295 operations per
//     byte where the card stops being bound by memory, so the kernel is
//     as fast as it keeps the narrow weight streaming at the card's
//     3.35 TB/s: about 30 KB of loads in flight on every SM from the
//     first load to the last, every SM busy to the end, and few enough
//     instructions a byte that the issue rate stays below the byte rate.
//     qmm_gemv_stream (bf16) is one block of eight warps a SM; block b
//     owns a contiguous run of weight rows in 8-row groups (the SMs'
//     shares differ by at most 8 rows at every shape), in 16-row tiles
//     whose K the warps split. Each warp keeps two rounds of four
//     64-column steps of 16-byte weight and x loads in registers and
//     issues the next round before it widens and multiplies this one,
//     across tile boundaries too. The products run on the tensor cores
//     (the weight rows the A operand of mma.m16n8k16, x its 8-column B
//     operand) after widen2 (a byte permute, a mask and one bf16
//     subtract or multiply a pair: no conversion instruction), so the
//     arithmetic hides under the loads. A tile's warps meet in shared
//     memory in a fixed order: no atomics and no second launch.
//     fp32 x takes qmm_gemv, plain FMA against x staged in shared memory.
//   - large M (a 256-token prefill chunk): operations, 2 x 256 per weight
//     byte against the card's ~295 a byte in bf16. qmm_wg (bf16, M > 16)
//     is built for the tensor cores' full rate: wgmma m64nTNk16 (TN 64,
//     128 or 256 tokens from M), f32 accumulate, A the weight rows widened
//     in registers straight from their narrow bytes (a byte permute, one
//     mask and one bf16 subtract or multiply a pair: no conversion chain,
//     once per block), B x's TMA-loaded swizzled tile. A 256-token chunk
//     is one token tile, so each weight byte crosses device memory and L2
//     into one block. One persistent block per SM walks the work items of
//     quant_matmul.qmm_plan (128 weight rows x TN tokens x a K split); a
//     producer warp keeps the TMA ring of x and narrow weight tiles in
//     flight on mbarriers across items, so loads, widening and products
//     overlap. K is split only where the output tiles alone would leave
//     the SMs less than half busy (q/k/v/o and down_proj at M 256: four
//     splits); the f32 partials are summed in split order by qmm_reduce,
//     no atomics, so results are the same every run, and the scale is
//     applied after the sum. The epilogue stages the scaled bf16 tile
//     transposed (stmatrix) and writes it with TMA stores.
//     fp32 x takes qmm_simt, a plain-FMA tiled product in real fp32.
// K must be a multiple of 16 (the wrapper checks); M and N are free.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mma_bf16.cuh"  // bf16, mma16816, pack2f
#include "sm90.cuh"      // TMA, mbarriers, wgmma, tensor maps
#include "widen.cuh"     // widen2: narrow bytes to bf16 pairs

namespace {

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
// M > 16, bf16: persistent TMA ring, weight widened in registers, wgmma
// ===========================================================================
//
// out^T[N, M] = W[N, K] . x^T[K, M], as wgmma m64nTNk16 products: A (64
// weight rows of a consumer warpgroup) comes from registers, widened from
// the narrow bytes; B (TN tokens) is x's 128-byte-swizzled [TN, 64] tile
// read through a descriptor. One persistent block per SM walks the work
// items of quant_matmul.qmm_plan: (128 weight rows, TN tokens, one K
// split). Warp 0 of the producer warpgroup keeps TMA copies of the x tile
// and the [128, 64] narrow weight tile (64-byte swizzle) of each 64-k step
// in flight on mbarriers, across items. With one split the scaled bf16
// tile is staged transposed in shared memory (stmatrix) and leaves by TMA
// stores; with several, each item writes its f32 partial sums and
// qmm_reduce adds them in split order, scales and rounds.

constexpr int WG_ROWS = 128;           // weight rows per item
constexpr int WG_KSTEP = 64;           // k per ring slot
constexpr int WG_CONSUMERS = 256;      // two consumer warpgroups
constexpr int WG_THREADS = WG_CONSUMERS + 128;  // and the producer's
constexpr int WG_MAX_STAGES = 8;
constexpr int WG_MAX_SPLITS = 8;       // K splits of one output tile
constexpr int WG_SMEM_MAX = 232448;    // per block, sm_90
constexpr int W_TILE = WG_ROWS * WG_KSTEP;  // narrow weight bytes a slot

// Shared layout from a 1024-byte aligned base: the x ring (stages x TN
// rows of 128 bytes), the weight ring (stages x 8 KB), the epilogue's
// bf16 tile (two 64-column panels of TN rows), then the mbarriers
// full[stages] and empty[stages].
__host__ __device__ inline int wg_smem_bytes(int tn, int stages) {
  return 1024 + stages * (tn * 128 + W_TILE) + 2 * tn * 128 + 16 * stages;
}

struct WgArgs {
  const float* scale;
  bf16* out;
  float* part;  // [splits, M, N] f32 partial sums when splits > 1
  int M, N, K;
  int token_tiles, splits, per;  // per: 64-k steps of a split
  int stages, items, tma_store;
};

__device__ __forceinline__ void wg_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS) : "memory");
}

// four 8x8 bf16 tiles to shared memory, each transposed
__device__ __forceinline__ void stsm_x4_t(uint32_t addr, uint32_t r0,
                                          uint32_t r1, uint32_t r2,
                                          uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

template <typename S, int TN>
__global__ void __launch_bounds__(WG_THREADS, 1)
    qmm_wg(const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap wmap,
           const __grid_constant__ CUtensorMap omap, const WgArgs q) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  constexpr int X_TILE = TN * 128;
  const int ST = q.stages;
  const uint32_t sX = base, sW = base + ST * X_TILE;
  uint8_t* const gW = gbase + ST * X_TILE;
  const uint32_t sE = sW + ST * W_TILE;  // epilogue tile
  const uint32_t full = sE + 2 * X_TILE, empty = full + 8 * ST;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int steps = (q.K + WG_KSTEP - 1) / WG_KSTEP;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, WG_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // item -> (weight-row tile, token tile, split); splits of one tile and
  // the token tiles of one weight-row tile run side by side
  auto origin = [&](int item, int& n0, int& m0, int& k0, int& k1) {
    const int sp = item % q.splits, tile = item / q.splits;
    n0 = tile / q.token_tiles * WG_ROWS;
    m0 = tile % q.token_tiles * TN;
    k0 = sp * q.per;
    k1 = min(k0 + q.per, steps);
  };

  if (warp >= WG_CONSUMERS / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (warp != WG_CONSUMERS / 32 || lane != 0) return;
    // slot s and phase ph, counted across items; a slot is refilled once
    // the consumers have released its previous use
    int s = 0, ph = 0;
    bool reuse = false;
    for (int item = blockIdx.x; item < q.items; item += gridDim.x) {
      int n0, m0, k0, k1;
      origin(item, n0, m0, k0, k1);
      for (int ks = k0; ks < k1; ++ks) {
        if (reuse) mbar_wait(empty + 8 * s, ph ^ 1);
        mbar_expect_tx(full + 8 * s, X_TILE + W_TILE);
        tma_load_2d(sX + s * X_TILE, &xmap, ks * WG_KSTEP, m0, full + 8 * s);
        tma_load_2d(sW + s * W_TILE, &wmap, ks * WG_KSTEP, n0, full + 8 * s);
        if (++s == ST) s = 0, ph ^= 1, reuse = true;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");

  // consumers: warpgroup wg owns weight rows [64 wg, 64 wg + 64) of the
  // item; this thread's A rows are r0 and r0 + 8, its D columns (tokens)
  // 8j + 2t, +1
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + wl * 16 + g;
  // the word holding this lane's pair (k 2t, 2t + 1 of a k16 step, +8 for
  // the second register) in row r of a 64-byte-swizzled weight slot:
  // chunk kk of the row lies at chunk kk ^ ((r >> 1) & 3)
  const uint32_t wsel = widen_sel<S>(t & 1);
  const int wx = (g >> 1) & 3, wofs = 4 * (t >> 1);
  int slot = 0, ph = 0;

  // the A fragments of one slot: f[kk] = rows (r0, r0 + 8) x k (16 kk + 2t,
  // + 1, 16 kk + 2t + 8, + 9), the mma A layout
  auto widen_slot = [&](int sl, uint32_t(&f)[4][4]) {
    const uint8_t* w = gW + sl * W_TILE;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = r0 + 8 * rr;
          const uint32_t word = *reinterpret_cast<const uint32_t*>(
              w + r * 64 + ((kk ^ wx) << 4) + 8 * h + wofs);
          f[kk][rr + 2 * h] = widen2<S>(word, wsel);
        }
  };

  for (int item = blockIdx.x; item < q.items; item += gridDim.x) {
    int n0, m0, k0, k1;
    origin(item, n0, m0, k0, k1);
    const int nk = k1 - k0;
    float acc[TN / 8][4];
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    // one step: the products of slot `slot` from fragments cur, then the
    // next slot's fragments into nxt while the tensor cores run
    int it = 0;
    auto step = [&](uint32_t(&cur)[4][4], uint32_t(&nxt)[4][4]) {
      const uint32_t xt = sX + slot * X_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tn<TN>(acc, cur[kk], desc_sw128(xt + 32 * kk));
      wgmma_commit();
      int ns = slot + 1, nph = ph;
      if (ns == ST) ns = 0, nph ^= 1;
      if (it + 1 < nk) {
        mbar_wait(full + 8 * ns, nph);
        widen_slot(ns, nxt);
      }
      wgmma_wait0();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * slot);
      slot = ns, ph = nph, ++it;
    };

    uint32_t fa[4][4], fb[4][4];
    mbar_wait(full + 8 * slot, ph);
    widen_slot(slot, fa);
    while (it < nk) {
      step(fa, fb);
      if (it < nk) step(fb, fa);
    }
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[j][e])::"memory");

    // acc[j][0..1]: weight row r0, tokens 8j + 2t, +1; acc[j][2..3]: row
    // r0 + 8
    const int na = n0 + r0, nb = na + 8;
    if (q.splits > 1) {
      float* dst = q.part + (long long)(k0 / q.per) * q.M * q.N;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * j + 2 * t + e;
          if (m >= q.M) continue;
          if (na < q.N) dst[(long long)m * q.N + na] = acc[j][e];
          if (nb < q.N) dst[(long long)m * q.N + nb] = acc[j][2 + e];
        }
      continue;
    }
    const float sa = na < q.N ? __ldg(q.scale + na) : 0.f;
    const float sb = nb < q.N ? __ldg(q.scale + nb) : 0.f;
    // the previous item's stores have read the tile
    if (q.tma_store && tid == 0) tma_store_wait_read();
    wg_consumers_sync();
    // tile[m][n] (panel wg: n in [64 wg, 64 wg + 64), 128-byte swizzled
    // rows of TN tokens): each 8x8 fragment (rows n, columns m)
    // transposed; lane L names row L & 7 of fragment L >> 3
    const uint32_t panel = sE + wg * X_TILE;
    const int fi = lane & 7, fj = (lane >> 4) & 1, fh = (lane >> 3) & 1;
#pragma unroll
    for (int j = 0; j < TN / 8; j += 2) {
      const int m = 8 * (j + fj) + fi;
      stsm_x4_t(panel + swz128(m, 2 * wl + fh),
                pack2f(acc[j][0] * sa, acc[j][1] * sa),
                pack2f(acc[j][2] * sb, acc[j][3] * sb),
                pack2f(acc[j + 1][0] * sa, acc[j + 1][1] * sa),
                pack2f(acc[j + 1][2] * sb, acc[j + 1][3] * sb));
    }
    if (q.tma_store) {
      // the staged tile made visible to the copy engine, which writes it
      // (clipped at M and N) while the consumers go on to the next item
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_consumers_sync();
      if (tid == 0) {
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (n0 + 64 * p < q.N)
            tma_store_2d(&omap, n0 + 64 * p, m0, sE + p * X_TILE);
        tma_store_commit();
      }
      continue;
    }
    // N % 8 != 0: rows of the tile element by element
    wg_consumers_sync();
    const uint8_t* tile = gbase + (sE - base);
    for (int idx = tid; idx < TN * 16; idx += WG_CONSUMERS) {
      const int r = idx >> 4, ch = idx & 15;
      const int m = m0 + r, n = n0 + 8 * ch;
      if (m >= q.M || n >= q.N) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(
          tile + (ch >> 3) * X_TILE + swz128(r, ch & 7));
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      bf16* dst = q.out + (long long)m * q.N + n;
      for (int i = 0; i < 8 && n + i < q.N; ++i) dst[i] = e[i];
    }
  }
  if (q.tma_store && tid == 0) tma_store_wait_all();
}

// out[m, n] = bf16(sum over splits s, in order, of part[s, m, n] * scale[n]);
// a thread per 8 consecutive outputs of a row
__global__ void __launch_bounds__(256)
    qmm_reduce(const float* __restrict__ part, const float* __restrict__ scale,
               bf16* __restrict__ out, int M, int N, int splits) {
  const int cpr = (N + 7) / 8;
  const long long idx = blockIdx.x * 256ll + threadIdx.x;
  if (idx >= (long long)M * cpr) return;
  const int m = (int)(idx / cpr), n = (int)(idx % cpr) * 8;
  const bool vec = (N & 7) == 0;
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int sp = 0; sp < splits; ++sp) {
    const float* p = part + ((long long)sp * M + m) * N + n;
    if (vec) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
      s[0] += a.x, s[1] += a.y, s[2] += a.z, s[3] += a.w;
      s[4] += b.x, s[5] += b.y, s[6] += b.z, s[7] += b.w;
    } else {
      for (int i = 0; i < 8 && n + i < N; ++i) s[i] += p[i];
    }
  }
  bf16* dst = out + (long long)m * N + n;
  if (vec) {
    uint4 v;
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = pack2f(s[2 * i] * __ldg(scale + n + 2 * i),
                    s[2 * i + 1] * __ldg(scale + n + 2 * i + 1));
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    for (int i = 0; i < 8 && n + i < N; ++i)
      dst[i] = __float2bfloat16(s[i] * scale[n + i]);
  }
}

// ===========================================================================
// small M, bf16: the weight-streaming GEMV on the tensor cores
// ===========================================================================
//
// out^T[N, M] = W[N, K] . x^T[K, M]: 16 weight rows (a tile) are the rows
// of an mma.m16n8k16 A operand, the (up to 8) rows of x its 8 B columns,
// so the products cost nothing beside the loads. A dot product may sum
// its k terms in any order, so lane (g, t) loads 16 CONTIGUOUS bytes of
// its two weight rows (g and g + 8 of the tile) and 16 contiguous bf16 of
// x row g at column 64s + 16t of a 64-column step s, and the four mma
// k-steps of that step take their fragments from those registers: virtual
// k (2t, 2t+1, 2t+8, 2t+9) of k-step j is real 64s + 16t + 4j + (0, 1, 2,
// 3), the same permutation for W and x. A byte widens to bf16 by widen2
// (a byte permute, a mask and one bf16 subtract or multiply a pair).
//
// The work: one block of eight warps a SM (gridDim.x = min(SMs, N / 8)),
// block b owning weight rows [8 (b G / B), 8 ((b + 1) G / B)) of the
// G = ceil(N / 8) groups of 8 (the blocks' shares differ by at most 8 rows
// at every shape) in 16-row tiles, the last maybe half full. A tile's K is
// split in eight runs of `per` 64-column steps, one a warp. A warp walks
// its (tile, round) sequence, GS_U steps a round, with two rounds of
// weight and x loads in registers: the next round's loads are issued
// before this round is widened and multiplied, across tile boundaries
// too, so each SM keeps 32-64 KB of weight in flight from the first load
// to the last. After a tile the warps' sums meet in shared memory, in warp
// order, and one multiply by scale[n] ends each output: no atomics, the
// same bits every run. x (a few tens of KB) is read through L1.

constexpr int GS_WARPS = 8;  // warps a block, one run of a tile's K each

template <int MT>
struct GemvStream {
  static constexpr int U = MT == 1 ? 4 : 2;  // 64-column steps a round
};

// 16 weight bytes read once: not kept in L1 (x is), and L2 fetches the
// 256-byte span around them, which the warp's next steps read
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// MT n8 tiles of x rows (M <= 8 * MT); per: a warp's 64-column steps of
// a tile, rounds: its rounds of GS_U steps
template <typename S, int MT>
__global__ void __launch_bounds__(GS_WARPS * 32, 1)
    qmm_gemv_stream(const bf16* __restrict__ x, const S* __restrict__ w,
                    const float* __restrict__ scale, bf16* __restrict__ out,
                    int M, int N, int K, int per, int rounds) {
  constexpr int U = GemvStream<MT>::U;
  __shared__ float red[2][GS_WARPS][MT][16][8];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int groups = (N + 7) >> 3;
  const int q0 = (int)((long long)blockIdx.x * groups / gridDim.x);
  const int q1 = (int)((long long)(blockIdx.x + 1) * groups / gridDim.x);
  const int row0 = q0 * 8, row1 = min(q1 * 8, N);
  const int total = (q1 - q0 + 1) / 2 * rounds;  // (tile, round) pairs
  const int s_lo = warp * per;
  const int s_hi = min((K + 63) >> 6, s_lo + per);
  const uint32_t sel0 = widen_sel<S>(0), sel1 = widen_sel<S>(1);

  // round i: tile i / rounds, steps s_lo + U (i % rounds) on; nothing
  // loads past the warp's run, K, the block's rows or M
  auto load = [&](uint4(&wr)[U][2], uint4(&xr)[U][MT][2], int i) {
    const int n0 = row0 + 16 * (i / rounds);
    const int sb = s_lo + U * (i % rounds);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = (sb + u) * 64 + 16 * t;
      const bool kin = i < total && sb + u < s_hi && k < K;  // K % 16 == 0
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + g + 8 * h;
        wr[u][h] = make_uint4(0u, 0u, 0u, 0u);
        if (kin && n < row1) wr[u][h] = ld_stream(w + (long long)n * K + k);
      }
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int m = g + 8 * j;
        xr[u][j][0] = xr[u][j][1] = make_uint4(0u, 0u, 0u, 0u);
        if (kin && m < M) {
          const uint4* p =
              reinterpret_cast<const uint4*>(x + (long long)m * K + k);
          xr[u][j][0] = __ldg(p);
          xr[u][j][1] = __ldg(p + 1);
        }
      }
    }
  };

  float acc[MT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  auto compute = [&](const uint4(&wr)[U][2], const uint4(&xr)[U][MT][2]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t* lo = reinterpret_cast<const uint32_t*>(&wr[u][0]);
      const uint32_t* hi = reinterpret_cast<const uint32_t*>(&wr[u][1]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        a[0] = widen2<S>(lo[kk], sel0);
        a[1] = widen2<S>(hi[kk], sel0);
        a[2] = widen2<S>(lo[kk], sel1);
        a[3] = widen2<S>(hi[kk], sel1);
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const uint32_t* xw = reinterpret_cast<const uint32_t*>(xr[u][j]);
          mma16816(acc[j], a, xw + 2 * kk);
        }
      }
    }
  };

  // after a tile's last round: C layout c0, c1 at (row g, cols 2t, 2t+1),
  // c2, c3 at row g + 8; rows are weight rows, cols rows of x
  auto flush = [&](int i) {
    if (i % rounds != rounds - 1) return;
    const int tile = i / rounds;
    float(*rw)[16][8] = red[tile & 1][warp];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      rw[j][g][2 * t] = acc[j][0];
      rw[j][g][2 * t + 1] = acc[j][1];
      rw[j][g + 8][2 * t] = acc[j][2];
      rw[j][g + 8][2 * t + 1] = acc[j][3];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    __syncthreads();  // red[tile & 1] full; red[!(tile & 1)] read already
    for (int e = tid; e < MT * 128; e += GS_WARPS * 32) {
      const int r = e & 15, c = (e >> 4) & 7, j = e >> 7;
      const int n = row0 + 16 * tile + r, m = 8 * j + c;
      if (n >= row1 || m >= M) continue;
      float s = 0.f;
#pragma unroll
      for (int wp = 0; wp < GS_WARPS; ++wp) s += red[tile & 1][wp][j][r][c];
      out[(long long)m * N + n] = __float2bfloat16(s * __ldg(scale + n));
    }
  };

  uint4 wa[U][2], wb[U][2], xa[U][MT][2], xb[U][MT][2];
  load(wa, xa, 0);
  for (int i = 0; i < total; i += 2) {
    load(wb, xb, i + 1);
    compute(wa, xa);
    flush(i);
    if (i + 1 == total) break;
    load(wa, xa, i + 2);
    compute(wb, xb);
    flush(i + 1);
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

// The launch plan of quant_matmul.qmm_plan (body 1), checked against
// what qmm_wg can run
struct Plan {
  int body, tn, token_tiles, row_tiles, splits, per, stages, smem, items,
      grid;
};

// The GEMV's plan (quant_matmul.gemv_plan, body 0 in bf16) in Plan's
// fields: tn the steps a round, token_tiles x's n8 tiles (MT), row_tiles
// the 8-row groups, splits 1, per a warp's steps of a tile, stages its
// rounds, smem 0, items a block's groups at most, grid the blocks (one a
// SM); checked against what the body and the card run
template <typename S, int MT>
cudaError_t launch_gemv_stream(const void* x, const void* w,
                               const float* scale, void* out, int M, int N,
                               int K, const Plan& p, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  constexpr int U = GemvStream<MT>::U;
  const int groups = (N + 7) / 8;
  const int per = ((K + 63) / 64 + GS_WARPS - 1) / GS_WARPS;
  const int grid = groups < sms ? groups : sms;
  const bool ok = p.tn == U && p.token_tiles == MT && p.row_tiles == groups &&
                  p.splits == 1 && p.per == per &&
                  p.stages == (per + U - 1) / U && p.smem == 0 &&
                  p.grid == grid && p.items == (groups + grid - 1) / grid;
  if (!ok) return cudaErrorInvalidValue;
  qmm_gemv_stream<S, MT><<<grid, GS_WARPS * 32, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const S*>(w), scale,
      static_cast<bf16*>(out), M, N, K, p.per, p.stages);
  return cudaGetLastError();
}

// Raise qmm_wg<S, TN>'s dynamic shared-memory limit on device `dev`, once
// per device (the attribute is per device; setting it costs host time on
// each of the ~1800 launches of a prefill iteration)
template <typename S, int TN>
cudaError_t raise_smem_limit(int dev) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      qmm_wg<S, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WG_SMEM_MAX);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

template <typename S, int TN>
cudaError_t launch_wg(const void* x, const void* w, WgArgs& a, const Plan& p,
                      int dev, cudaStream_t st) {
  cudaError_t e = raise_smem_limit<S, TN>(dev);
  if (e != cudaSuccess) return e;
  CUtensorMap xm, wm, om;
  const cuuint64_t xd[2] = {(cuuint64_t)a.K, (cuuint64_t)a.M};
  const cuuint64_t xs[1] = {(cuuint64_t)a.K * 2};
  const cuuint32_t xb[2] = {WG_KSTEP, TN};
  const cuuint64_t wd[2] = {(cuuint64_t)a.K, (cuuint64_t)a.N};
  const cuuint64_t ws[1] = {(cuuint64_t)a.K};
  const cuuint32_t wb[2] = {WG_KSTEP, WG_ROWS};
  // out [M, N] in panels of 64 columns x TN rows, as the tile is staged
  const cuuint64_t od[2] = {(cuuint64_t)a.N, (cuuint64_t)a.M};
  const cuuint64_t os[1] = {(cuuint64_t)a.N * 2};
  const cuuint32_t ob[2] = {64, TN};
  if (!encode_tiled(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xd, xs, xb,
                    CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_tiled(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wd, ws, wb,
                    CU_TENSOR_MAP_SWIZZLE_64B) ||
      (a.tma_store &&
       !encode_tiled(&om, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.out, od, os,
                     ob, CU_TENSOR_MAP_SWIZZLE_128B)))
    return cudaErrorInvalidValue;
  if (!a.tma_store) om = xm;  // unused
  qmm_wg<S, TN><<<p.grid, WG_THREADS, p.smem, st>>>(xm, wm, om, a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  const long long n = (long long)a.M * ((a.N + 7) / 8);
  qmm_reduce<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      a.part, a.scale, a.out, a.M, a.N, a.splits);
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch_tc(const void* x, const void* w, const float* scale,
                      void* out, void* part, int M, int N, int K,
                      const Plan& p, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int tn = M <= 64 ? 64 : M <= 128 ? 128 : 256;
  const int steps = (K + WG_KSTEP - 1) / WG_KSTEP;
  const long long items =
      (long long)p.token_tiles * p.row_tiles * p.splits;
  const bool ok =
      p.tn == tn && p.token_tiles == (M + tn - 1) / tn &&
      p.row_tiles == (N + WG_ROWS - 1) / WG_ROWS && p.per >= 1 &&
      p.splits == (steps + p.per - 1) / p.per && (p.splits == 1 || part) &&
      p.splits <= WG_MAX_SPLITS && p.stages >= 2 &&
      p.stages <= WG_MAX_STAGES &&
      p.smem == wg_smem_bytes(tn, p.stages) && p.smem <= WG_SMEM_MAX &&
      items == p.items && items < (1ll << 31) &&
      p.grid == (items < sms ? items : sms);
  if (!ok) return cudaErrorInvalidValue;
  WgArgs a{scale,       static_cast<bf16*>(out), static_cast<float*>(part),
           M,           N,                       K,
           p.token_tiles, p.splits,              p.per,
           p.stages,    p.items,                 p.splits == 1 && N % 8 == 0};
  if (tn == 64) return launch_wg<S, 64>(x, w, a, p, dev, st);
  if (tn == 128) return launch_wg<S, 128>(x, w, a, p, dev, st);
  return launch_wg<S, 256>(x, w, a, p, dev, st);
}

template <typename T, typename S>
cudaError_t launch_t(const void* x, const void* w, const float* scale,
                     void* out, void* part, int M, int N, int K,
                     const Plan& p, cudaStream_t st) {
  // body 0: the GEMV (M <= 16); 1: qmm_wg (bf16); 2: qmm_simt (fp32)
  const int body = M <= SMALL_M ? 0 : sizeof(T) == 2 ? 1 : 2;
  if (p.body != body) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    if (M <= 8)
      return launch_gemv_stream<S, 1>(x, w, scale, out, M, N, K, p, st);
    if (M <= SMALL_M)
      return launch_gemv_stream<S, 2>(x, w, scale, out, M, N, K, p, st);
    return launch_tc<S>(x, w, scale, out, part, M, N, K, p, st);
  } else {
    if (M <= 1) return launch_gemv<S, 1>(x, w, scale, out, M, N, K, st);
    if (M <= 2) return launch_gemv<S, 2>(x, w, scale, out, M, N, K, st);
    if (M <= 4) return launch_gemv<S, 4>(x, w, scale, out, M, N, K, st);
    if (M <= 8) return launch_gemv<S, 8>(x, w, scale, out, M, N, K, st);
    if (M <= SMALL_M)
      return launch_gemv<S, SMALL_M>(x, w, scale, out, M, N, K, st);
    const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    qmm_simt<S><<<grid, 256, 0, st>>>(static_cast<const float*>(x),
                                      static_cast<const S*>(w), scale,
                                      static_cast<float*>(out), M, N, K);
    return cudaGetLastError();
  }
}

}  // namespace

// Plain C entry for ctypes: x [M, K] (bf16 if is_bf16 else fp32), w [N, K]
// (fp8 e4m3 if is_fp8 else int8), scale [N] f32, out [M, N] in x's dtype,
// all contiguous and 16-byte aligned, K % 16 == 0; part: f32 scratch of
// splits x M x N for a qmm_wg plan with splits > 1 (its contents are not
// read before this launch writes them), else unused. The plan
// (body, tn, token_tiles, row_tiles, splits, per, stages, smem, items,
// grid) is quant_matmul.qmm_plan's for the wgmma body and
// quant_matmul.gemv_plan's for the bf16 GEMV (only body is read for the
// fp32 bodies); one the body cannot run is refused with
// cudaErrorInvalidValue. Returns the cudaError_t of the launch (0 =
// accepted).
extern "C" int paddle_quant_matmul(const void* x, const void* w,
                                   const void* scale, void* out, void* part,
                                   int is_bf16, int is_fp8, int M, int N,
                                   int K, int body, int tn, int token_tiles,
                                   int row_tiles, int splits, int per,
                                   int stages, int smem, int items, int grid,
                                   void* stream) {
  if (K % 16 != 0 || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  const Plan p{body,   tn,    token_tiles, row_tiles, splits,
               per,    stages, smem,       items,     grid};
  cudaError_t e;
  if (is_bf16)
    e = is_fp8
            ? launch_t<bf16, __nv_fp8_e4m3>(x, w, s, out, part, M, N, K, p, st)
            : launch_t<bf16, int8_t>(x, w, s, out, part, M, N, K, p, st);
  else
    e = is_fp8
            ? launch_t<float, __nv_fp8_e4m3>(x, w, s, out, part, M, N, K, p,
                                             st)
            : launch_t<float, int8_t>(x, w, s, out, part, M, N, K, p, st);
  return static_cast<int>(e);
}
