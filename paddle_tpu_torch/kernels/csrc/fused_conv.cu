// Fused NHWC stride-1 convolution for Hopper (sm_90a), with one of two
// epilogues and an optional prologue:
//   K10 (eval):   out = T(relu?(conv(x, w) * scale[k] + shift[k]))
//   K11 (train):  out = T(conv(pre?(x), w)) plus, per row tile, the
//                 per-channel sum and sum of squares of the f32 accumulator
//   pre (K11):    x -> T(relu?(f32(x) * ps[c] + pb[c])), the previous
//                 BatchNorm's normalize(+ReLU) applied to x once it is
//                 staged in shared memory
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
// row tile stages its halo, with the edge mask from (row % HW) / W and
// row % W, so an image of any size works (a 1x1 image under a 3x3 kernel,
// where the TPU block has no rows left to slice, included).
//
// Masking after the prologue: padding is zero in the NORMALIZED
// activation, so a masked tap contributes an exact zero and rows the halo
// zero-fills (before row 0, past M) are never normalized (normalize of a
// zero would give pb, not 0). The normalized value is rounded to T before
// the product, as the TPU prologue casts back to x's dtype.
//
// Statistics come from the f32 accumulator before it is rounded to T.
// Each block writes its tile's partial sums to [tiles, K] buffers, in a
// fixed order (thread rows, then a warp shuffle tree, then the warps in
// order); the wrapper sums the tiles. No atomics: the result is the same
// from run to run.
//
// What bounds it: ResNet-50's convs at batch 256 do 50-460 operations per
// byte of x + w + y, above the card's ~295 at the large-channel 1x1 and
// 3x3 layers (the tensor cores) and below it at the 64- and 128-channel
// 1x1 ones (device memory), so both bounds matter. What conv_tc (bf16,
// C % 8 == 0) does about it, on the launch plan of fused_conv.conv_plan
// (tile width TN, slab or per-tap mode, ring depths, shared bytes),
// which the launch checks:
// - A halo slab staged once per 64-channel step: a tile of TM = 128
//   output rows stages rows [m0 - W - 1, m0 + 128 + W + 1) of x (3x3; the
//   tile's own rows for 1x1) with one TMA copy, rows outside [0, M)
//   zero-filled by the copy, 128-byte swizzled. Every tap reads its A
//   operand as a window of the slab shifted by dy * W + dx (ldmatrix takes
//   any row), so x crosses L2 once per column block, not once per tap.
//   Images wider than 63 (a slab of more than 256 rows, one TMA box) stage
//   one 128-row window per tap instead, through the same ring.
// - The prologue applied once per staged element: with PRE, three warps
//   of the producer warpgroup normalize each landed stage in place (each
//   thread on fixed channels, whose ps/pb it reads once a stage) before
//   the consumers are told it is ready, as far ahead as the ring allows.
// - An asynchronous ring and wgmma: one persistent block per SM walks the
//   output tiles; one producer warp keeps TMA copies of the x stages (2-4
//   deep) and of the weight tiles (one tap's [TN, 64] plane, 2-4 deep) in
//   flight on mbarriers, across tiles; two consumer warpgroups (224
//   registers a thread by setmaxnreg), 64 rows x TN each, run wgmma
//   m64nTNk16 (f32 accumulate) with A from registers (the ldmatrix-loaded,
//   edge-masked window; the next tap's is loaded while the tensor cores
//   run) and B from the swizzled weight tile through a descriptor. TN is
//   256 where K >= 256, 128 where K > 64, else 64.
// - A staged epilogue: the folded BN (+ReLU) or the statistics from the
//   f32 accumulator, the bf16 tile staged in shared memory and written by
//   TMA stores (clipped at M and K) while the consumers go on to the next
//   tile; as coalesced 16-byte rows where K % 8 != 0.
// conv_simt (fp32, and bf16 with C % 8 != 0) is a plain-FMA tiled product
// in real fp32, for the parity runs and odd channel counts.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from cudart
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"  // TMA, mbarriers, wgmma, tensor maps

namespace {

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
// bf16, C % 8 == 0: TMA ring, wgmma
// ===========================================================================

constexpr int TM = 128;        // output rows per tile: two warpgroups of 64
constexpr int KC = 64;         // channels per step: one 128-byte smem row
constexpr int CONSUMERS = 256; // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup:
constexpr int NORMALIZERS = 96;  // its last three warps run the prologue
constexpr int SMEM_MAX = 232448;          // per block, sm_90
constexpr int MAX_BOX = 256;              // TMA box rows

// Shared layout from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows of 128 bytes): the x ring (a_stages blocks of
// a_rows rows, each rounded up to 8 rows), the weight ring (w_stages
// tiles of TN rows), the epilogue's bf16 tile (64-channel swizzled
// panels of TM rows) and the statistics' [2][8 warps][TN] f32 partials,
// then the mbarriers (a_full, a_empty, w_full, w_empty, a_ready).
__host__ __device__ inline int a_bytes_of(int a_rows) {
  return (a_rows + 7) / 8 * 8 * 128;
}
__host__ __device__ inline int tile_off(int a_rows, int as, int ws, int tn) {
  return as * a_bytes_of(a_rows) + ws * tn * 128;
}
__host__ __device__ inline int bars_off(int a_rows, int as, int ws, int tn) {
  return tile_off(a_rows, as, ws, tn) + TM * tn * 2 + 2 * 8 * tn * 4;
}
__host__ __device__ inline int tc_smem_bytes(int a_rows, int as, int ws,
                                             int tn) {
  return 1024 + bars_off(a_rows, as, ws, tn) + 8 * (3 * as + 2 * ws);
}

struct TcArgs {
  const float* ep_scale;
  const float* ep_shift;
  const float* ps;
  const float* pb;
  bf16* out;
  float* part1;
  float* part2;
  Conv p;
  int relu, relu_in;
  int slab;      // 1: one slab per channel step; 0: one window per tap
  int a_rows;    // rows of one x stage (the TMA box)
  int a_stages;  // x ring depth
  int w_stages;  // weight ring depth
  int halo;      // W + 1 for 3x3, 0 for 1x1
  int tiles;     // row tiles
  int tma_store; // 1: the tile leaves through TMA stores (K % 8 == 0)
};

// the consumer warpgroups' own barrier (the producer warpgroup never
// joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// With PRE: normalize one landed x stage in place. Normalizer thread nt
// owns the 8 channels of logical chunk nt % 8 (their ps/pb read once) on
// rows nt / 8 + 12 i, four rows in flight; rows outside [0, M) and
// channels past C were zero-filled by the copy and stay zero (padding is
// zero in the normalized activation, and the weights past C are zero).
__device__ __forceinline__ void prologue_stage(uint8_t* buf, int a_rows,
                                               int r0, int c0, const Conv& p,
                                               const float* ps,
                                               const float* pb, bool relu_in,
                                               int nt) {
  const int q = nt & 7;
  const int c = c0 + 8 * q;
  if (c >= p.C) return;
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(ps + c));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(ps + c + 4));
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(pb + c));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(pb + c + 4));
  const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  constexpr int STEP = NORMALIZERS / 8;
  for (int r = nt >> 3; r < a_rows; r += 4 * STEP) {
    uint4 v[4];
    bool ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int rr = r + u * STEP;
      ok[u] = rr < a_rows && (unsigned)(r0 + rr) < (unsigned)p.M;
      if (ok[u]) v[u] = *reinterpret_cast<const uint4*>(buf + swz128(rr, q));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (!ok[u]) continue;
      // in pairs: relu?(x * s + b) in f32, rounded to bf16 two at a time
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v[u]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        float y0 = f.x * s[2 * i] + b[2 * i];
        float y1 = f.y * s[2 * i + 1] + b[2 * i + 1];
        if (relu_in) y0 = fmaxf(y0, 0.f), y1 = fmaxf(y1, 0.f);
        h[i] = __floats2bfloat162_rn(y0, y1);
      }
      *reinterpret_cast<uint4*>(buf + swz128(r + u * STEP, q)) = v[u];
    }
  }
}

// where x stage `a` (0-based within its item) of an item starts: its
// first row and channel
struct Origin {
  int r0, c0;
};
__device__ __forceinline__ Origin stage_origin(const TcArgs& q, int m0,
                                               int a) {
  const Conv& p = q.p;
  if (q.slab) return {m0 - q.halo, a * KC};
  const int taps = p.ks * p.ks, cs = a / taps, tap = a - cs * taps;
  return {m0 + (tap / p.ks - p.pad) * p.W + tap % p.ks - p.pad, cs * KC};
}

// One persistent block per SM walks the output tiles (item = row tile x
// column block, tile-major, so the blocks of one row tile run side by
// side and its x is read from device memory about once). The producer
// warpgroup's first warp keeps the rings full across items: lane 0 the
// weight tiles, lane 1 the x stages; with PRE its other three warps
// normalize each landed x stage once, as far ahead as the ring allows.
// The two consumer warpgroups run the products and the epilogue.
template <bool STATS, bool PRE, int TN>
__global__ void __launch_bounds__(THREADS, 1)
    conv_tc(const __grid_constant__ CUtensorMap xmap,
            const __grid_constant__ CUtensorMap wmap,
            const __grid_constant__ CUtensorMap omap, const TcArgs q) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const Conv& p = q.p;
  const int a_bytes = a_bytes_of(q.a_rows);
  const int AS = q.a_stages, WS = q.w_stages;
  constexpr int W_BYTES = TN * 128;
  const uint32_t sA = base;
  const uint32_t sW = base + AS * a_bytes;
  uint8_t* const tile_buf = gbase + tile_off(q.a_rows, AS, WS, TN);
  float* const red = reinterpret_cast<float*>(tile_buf + TM * TN * 2);
  const uint32_t bars = base + bars_off(q.a_rows, AS, WS, TN);
  // mbarriers: a_full [0, AS), a_empty [AS, 2AS), w_full, w_empty, a_ready
  const uint32_t a_full = bars, a_empty = bars + 8 * AS;
  const uint32_t w_full = bars + 16 * AS, w_empty = w_full + 8 * WS;
  const uint32_t a_ready = w_empty + 8 * WS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col_blocks = (p.K + TN - 1) / TN;
  const int items = q.tiles * col_blocks;
  const int taps = p.ks * p.ks;
  const int nk = (p.C + KC - 1) / KC * taps;  // (channel step, tap) steps
  const int na = q.slab ? nk / taps : nk;     // x stages an item

  if (tid == 0) {
    for (int i = 0; i < AS; ++i) {
      mbar_init(a_full + 8 * i, 1);
      mbar_init(a_empty + 8 * i, CONSUMERS / 32);
    }
    for (int i = 0; i < WS; ++i) {
      mbar_init(w_full + 8 * i, 1);
      mbar_init(w_empty + 8 * i, CONSUMERS / 32);
    }
    for (int i = 0; i < AS; ++i) mbar_init(a_ready + 8 * i, NORMALIZERS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (warp == CONSUMERS / 32) {
      if (lane > 1) return;
      // ring slot s and phase ph, counted across items; a slot is
      // refilled once the consumers have released its previous use
      const int depth = lane == 0 ? WS : AS;
      int s = 0, ph = 0;
      bool reuse = false;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int tile = item / col_blocks;
        const int n0 = (item - tile * col_blocks) * TN, m0 = tile * TM;
        const int loads = lane == 0 ? nk : na;
        for (int i = 0, c0 = 0, tap = 0; i < loads; ++i) {
          if (reuse)
            mbar_wait((lane == 0 ? w_empty : a_empty) + 8 * s, ph ^ 1);
          if (lane == 0) {
            mbar_expect_tx(w_full + 8 * s, W_BYTES);
            tma_load_3d(sW + s * W_BYTES, &wmap, c0, n0, tap, w_full + 8 * s);
            if (++tap == taps) tap = 0, c0 += KC;
          } else {
            const Origin o = stage_origin(q, m0, i);
            mbar_expect_tx(a_full + 8 * s, q.a_rows * 128);
            tma_load_2d(sA + s * a_bytes, &xmap, o.c0, o.r0, a_full + 8 * s);
          }
          if (++s == depth) s = 0, ph ^= 1, reuse = true;
        }
      }
    } else if (PRE) {
      const int nt = tid - CONSUMERS - 32;
      int k = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int m0 = item / col_blocks * TM;
        for (int a = 0; a < na; ++a, ++k) {
          const int s = k % AS;
          mbar_wait(a_full + 8 * s, (k / AS) & 1);
          const Origin o = stage_origin(q, m0, a);
          prologue_stage(gbase + s * a_bytes, q.a_rows, o.r0, o.c0, p, q.ps,
                         q.pb, q.relu_in != 0, nt);
          // written through the generic proxy: visible to the copy engine
          // before the stage is refilled
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (lane == 0) mbar_arrive(a_ready + 8 * s);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");

  // consumers: warpgroup wg owns tile rows [64 wg, 64 wg + 64); this
  // thread's accumulator rows are ra and ra + 8, its ldmatrix row lrow
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int ra = wg * 64 + wl * 16 + g;
  const int lrow = wg * 64 + wl * 16 + (lane & 15), lhi = lane >> 4;
  const int a_taps = q.slab ? taps : 1;
  // a stage is ready once landed, or with PRE once normalized
  const uint32_t a_wait = PRE ? a_ready : a_full;
  // ring slots and phases, counted across items: the weight tile of the
  // current step, the x stage it reads
  int ws = 0, wph = 0, as = 0, aph = 0;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item / col_blocks;
    const int n0 = (item - tile * col_blocks) * TN, m0 = tile * TM;
    int ii[2], jj[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + ra + 8 * h;
      const int r = m % p.HW;
      ii[h] = m < p.M ? r / p.W : -(1 << 30);  // past M: every tap masked
      jj[h] = r % p.W;
    }
    float acc[TN / 8][4];
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    // the A fragments of tap (dy, dx) from x stage (slot, phase): the tap's
    // window of the stage, edge-masked in registers
    auto prepare = [&](int dy, int dx, int slot, int phase, bool first,
                       uint32_t(&f)[4][4]) {
      if (first) mbar_wait(a_wait + 8 * slot, phase);
      const uint32_t abuf = sA + slot * a_bytes;
      const int sr = (q.slab ? q.halo + dy * p.W + dx : 0) + lrow;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(f[kk], abuf + swz128(sr, 2 * kk + lhi));
      const bool v0 = (unsigned)(ii[0] + dy) < (unsigned)p.H &&
                      (unsigned)(jj[0] + dx) < (unsigned)p.W;
      const bool v1 = (unsigned)(ii[1] + dy) < (unsigned)p.H &&
                      (unsigned)(jj[1] + dx) < (unsigned)p.W;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (!v0) f[kk][0] = f[kk][2] = 0u;
        if (!v1) f[kk][1] = f[kk][3] = 0u;
      }
    };

    // one step: the products of tap (dy, dx) from fragments cur, then the
    // next step's fragments into nxt while the tensor cores run
    int tap = 0, dy = -p.pad, dx = -p.pad;
    auto step = [&](int it, uint32_t(&cur)[4][4], uint32_t(&nxt)[4][4]) {
      const bool last = !q.slab || tap == taps - 1;
      mbar_wait(w_full + 8 * ws, wph);
      const uint32_t wt = sW + ws * W_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tn<TN>(acc, cur[kk], desc_sw128(wt + 32 * kk));
      wgmma_commit();
      int ntap = tap + 1, ndy = dy, ndx = dx + 1;
      if (ntap == taps) ntap = 0, ndy = ndx = -p.pad;
      else if (ndx > p.pad) ndx = -p.pad, ++ndy;
      int nas = as, naph = aph;
      if (last && ++nas == AS) nas = 0, naph ^= 1;
      if (it + 1 < nk)
        prepare(ndy, ndx, nas, naph, !q.slab || ntap == 0, nxt);
      wgmma_wait0();
      __syncwarp();
      if (lane == 0) mbar_arrive(w_empty + 8 * ws);
      if (++ws == WS) ws = 0, wph ^= 1;
      if (last && lane == 0) mbar_arrive(a_empty + 8 * as);
      as = nas, aph = naph;
      tap = ntap, dy = ndy, dx = ndx;
    };

    uint32_t fa[4][4], fb[4][4];
    prepare(dy, dx, as, aph, true, fa);
    for (int it = 0; it < nk; it += 2) {
      step(it, fa, fb);
      if (it + 1 < nk) step(it + 1, fb, fa);
    }
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[j][e])::"memory");

    // epilogue. acc[j][0..1] are row ra, channels 8j + 2t, +1; acc[j][2..3]
    // row ra + 8. Rows past M hold exact zeros (every tap masked), so the
    // sums need no row mask. The barrier keeps the previous item's stores
    // from reading a tile this one overwrites.
    if (q.tma_store && tid == 0) tma_store_wait_read();
    consumers_sync();
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int nl = 8 * j + 2 * t, n = n0 + nl;
      float v[4] = {acc[j][0], acc[j][1], acc[j][2], acc[j][3]};
      if (STATS) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s1 = v[e] + v[e + 2], s2 = v[e] * v[e] + v[e + 2] * v[e + 2];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, o);
            s2 += __shfl_xor_sync(0xffffffffu, s2, o);
          }
          if (g == 0) {
            red[warp * TN + nl + e] = s1;
            red[(8 + warp) * TN + nl + e] = s2;
          }
        }
      } else {
        float sc0 = 1.f, sc1 = 1.f, sh0 = 0.f, sh1 = 0.f;
        if (n < p.K) sc0 = __ldg(q.ep_scale + n), sh0 = __ldg(q.ep_shift + n);
        if (n + 1 < p.K)
          sc1 = __ldg(q.ep_scale + n + 1), sh1 = __ldg(q.ep_shift + n + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[2 * h] = v[2 * h] * sc0 + sh0;
          v[2 * h + 1] = v[2 * h + 1] * sc1 + sh1;
          if (q.relu)
            v[2 * h] = fmaxf(v[2 * h], 0.f),
            v[2 * h + 1] = fmaxf(v[2 * h + 1], 0.f);
        }
      }
      uint8_t* panel = tile_buf + (nl >> 6) * (TM * 128);
      const int ch = (nl & 63) >> 3;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(panel + swz128(ra + 8 * h, ch) + 4 * t) =
            pack2f(v[2 * h], v[2 * h + 1]);
    }
    // the staged tile made visible to the copy engine
    if (q.tma_store)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();
    if (q.tma_store && tid == 0) {
      // the copy engine writes the tile (clipped at M and K) while the
      // consumers go on to the next item
#pragma unroll
      for (int pn = 0; pn < TN / 64; ++pn)
        if (n0 + 64 * pn < p.K)
          tma_store_2d(&omap, n0 + 64 * pn, m0,
                       smem_u32(tile_buf + pn * (TM * 128)));
      tma_store_commit();
    }
    // without TMA stores: rows of the tile as 16-byte chunks, neighbouring
    // threads on neighbouring chunks of a row
    const bool vec = (p.K & 7) == 0;
    for (int idx = tid; idx < (q.tma_store ? 0 : TM * TN / 8);
         idx += CONSUMERS) {
      const int r = idx / (TN / 8), ch = idx % (TN / 8);
      const int m = m0 + r, n = n0 + 8 * ch;
      if (m >= p.M || n >= p.K) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(
          tile_buf + (ch >> 3) * (TM * 128) + swz128(r, ch & 7));
      bf16* dst = q.out + (long long)m * p.K + n;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const bf16* e = reinterpret_cast<const bf16*>(&v);
        for (int i = 0; i < 8 && n + i < p.K; ++i) dst[i] = e[i];
      }
    }
    if (STATS && tid < TN && n0 + tid < p.K) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        s1 += red[w * TN + tid];
        s2 += red[(8 + w) * TN + tid];
      }
      const long long o = (long long)tile * p.K + n0 + tid;
      q.part1[o] = s1;
      q.part2[o] = s2;
    }
  }
  if (q.tma_store && tid == 0) tma_store_wait_all();
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

// ===========================================================================
// the statistics from the [2, tiles, K] partials
// ===========================================================================

// Sums of [2, rows, K] partials over consecutive spans of `span` rows, in a
// fixed order (8 interleaved slices of a span, then the slices in order):
// out [2, spans, K]; over a single span (gridDim.y == 1), the mean and the
// biased variance max(E[x^2] - E[x]^2, 0) over count rows instead. No
// atomics: the same result every run.
__global__ void __launch_bounds__(256)
    stats_reduce(const float* __restrict__ part, int rows, int K, int span,
                 float* __restrict__ out, int count, float* __restrict__ mean,
                 float* __restrict__ var) {
  __shared__ float red[2][8][32];
  const int lane = threadIdx.x & 31, s = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int r0 = blockIdx.y * span, r1 = min(r0 + span, rows);
  float s1 = 0.f, s2 = 0.f;
  if (c < K)
    for (int r = r0 + s; r < r1; r += 8) {
      s1 += part[(long long)r * K + c];
      s2 += part[((long long)rows + r) * K + c];
    }
  red[0][s][lane] = s1;
  red[1][s][lane] = s2;
  __syncthreads();
  if (s != 0 || c >= K) return;
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) a += red[0][i][lane], b += red[1][i][lane];
  if (gridDim.y > 1) {
    out[(long long)blockIdx.y * K + c] = a;
    out[((long long)gridDim.y + blockIdx.y) * K + c] = b;
    return;
  }
  const float m = a / (float)count;
  mean[c] = m;
  var[c] = fmaxf(b / (float)count - m * m, 0.f);
}

// ===========================================================================
// the prologue's folded BatchNorm
// ===========================================================================

// ps = gamma * rsqrt(var + eps), pb = beta - mean * ps per channel, in f32
// with the plain version's roundings (no contraction), gamma and beta f32
// or bf16
template <typename A>
__global__ void __launch_bounds__(256)
    bn_fold(const float* __restrict__ mean, const float* __restrict__ var,
            const A* __restrict__ gamma, const A* __restrict__ beta, int C,
            float eps, float* __restrict__ ps, float* __restrict__ pb) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= C) return;
  const float s = __fmul_rn(to_f(gamma[c]), rsqrtf(__fadd_rn(var[c], eps)));
  ps[c] = s;
  pb[c] = __fsub_rn(to_f(beta[c]), __fmul_rn(mean[c], s));
}

// ===========================================================================
// the launch
// ===========================================================================

bool use_tc(int is_bf16, int C) { return is_bf16 && C % 8 == 0; }


// A bf16 tensor map with 128-byte swizzled boxes of 64 channels (zero fill
// outside the tensor): x as [M, C] rows, w as [taps, K, C]
bool tensor_map(CUtensorMap* m, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint32_t* box) {
  cuuint64_t strides[2], bytes = 2;
  for (int i = 1; i < rank; ++i) strides[i - 1] = bytes *= dims[i - 1];
  return encode_tiled(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, ptr, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The launch plan of fused_conv.conv_plan, checked against what this
// body can run
struct Plan {
  int body, tile_rows, tn, slab, a_rows, a_stages, w_stages, smem, tiles;
};

template <bool STATS, bool PRE, int TN>
cudaError_t launch_tc(const void* x, const void* w, TcArgs& a, const Plan& pl,
                      cudaStream_t st) {
  // set on every launch: the attribute is per device, and cheap to set
  cudaError_t e = cudaFuncSetAttribute(
      conv_tc<STATS, PRE, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX);
  if (e != cudaSuccess) return e;
  const Conv& p = a.p;
  CUtensorMap xm, wm, om;
  const cuuint64_t xd[2] = {(cuuint64_t)p.C, (cuuint64_t)p.M};
  const cuuint32_t xb[2] = {KC, (cuuint32_t)pl.a_rows};
  const cuuint64_t wd[3] = {(cuuint64_t)p.C, (cuuint64_t)p.K,
                            (cuuint64_t)(p.ks * p.ks)};
  const cuuint32_t wb[3] = {KC, TN, 1};
  // out [M, K] in panels of 64 channels x TM rows, as the tile is staged
  const cuuint64_t od[2] = {(cuuint64_t)p.K, (cuuint64_t)p.M};
  const cuuint32_t ob[2] = {64, TM};
  if (!tensor_map(&xm, x, 2, xd, xb) || !tensor_map(&wm, w, 3, wd, wb) ||
      (a.tma_store && !tensor_map(&om, a.out, 2, od, ob)))
    return cudaErrorInvalidValue;
  if (!a.tma_store) om = xm;  // unused
  // persistent: one block per SM, or one per item if there are fewer
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long items = (long long)pl.tiles * ((p.K + TN - 1) / TN);
  if (items >= (1ll << 31)) return cudaErrorInvalidValue;
  const int blocks = items < sms ? (int)items : sms;
  conv_tc<STATS, PRE, TN><<<blocks, THREADS, pl.smem, st>>>(xm, wm, om, a);
  return cudaGetLastError();
}

template <bool STATS, bool PRE>
cudaError_t launch(const void* x, const void* w, const float* sc,
                   const float* sh, const float* ps, const float* pb,
                   void* out, float* p1, float* p2, int is_bf16,
                   const Conv& p, bool relu, bool relu_in, const Plan& pl,
                   cudaStream_t st) {
  if (use_tc(is_bf16, p.C)) {
    const int halo = p.ks == 3 ? p.W + 1 : 0;
    const int slab_rows = TM + 2 * halo;
    const bool ok =
        pl.body == 1 && pl.tile_rows == TM &&
        (pl.tn == 64 || pl.tn == 128 || pl.tn == 256) &&
        pl.tiles == (p.M + TM - 1) / TM &&
        pl.a_stages >= 2 && pl.a_stages <= 4 && pl.w_stages >= 2 &&
        pl.w_stages <= 4 &&
        (pl.slab ? pl.a_rows == slab_rows && slab_rows <= MAX_BOX
                 : p.ks == 3 && pl.a_rows == TM) &&
        pl.smem == tc_smem_bytes(pl.a_rows, pl.a_stages, pl.w_stages, pl.tn) &&
        pl.smem <= SMEM_MAX;
    if (!ok) return cudaErrorInvalidValue;
    TcArgs a{sc,          sh,          ps,   pb,       static_cast<bf16*>(out),
             p1,          p2,          p,    relu,     relu_in,
             pl.slab,     pl.a_rows,   pl.a_stages,    pl.w_stages,
             halo,        pl.tiles,    p.K % 8 == 0};
    if (pl.tn == 64) return launch_tc<STATS, PRE, 64>(x, w, a, pl, st);
    if (pl.tn == 128) return launch_tc<STATS, PRE, 128>(x, w, a, pl, st);
    return launch_tc<STATS, PRE, 256>(x, w, a, pl, st);
  }
  const int mt = (p.M + SM - 1) / SM;
  if (pl.body != 0 || pl.tile_rows != SM || pl.tiles != mt || mt > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((p.K + SN - 1) / SN, mt);
  if (is_bf16)
    conv_simt<bf16, STATS, PRE><<<grid, 256, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), sc, sh, ps,
        pb, static_cast<bf16*>(out), p1, p2, p, relu, relu_in);
  else
    conv_simt<float, STATS, PRE><<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sc, sh,
        ps, pb, static_cast<float*>(out), p1, p2, p, relu, relu_in);
  return cudaGetLastError();
}

}  // namespace

// stats 0: K10 (ep_scale, ep_shift, relu; no partials, no prologue).
// stats 1: K11 (part1, part2 of [tiles, K]; prologue ps, pb, relu_in when
// pre is 1). x, w and, for the prologue, ps and pb 16-byte aligned. The
// plan (body, tile_rows, tn, slab, a_rows, a_stages, w_stages, smem,
// tiles) is
// fused_conv.conv_plan's; a plan this body cannot run is refused with
// cudaErrorInvalidValue.
extern "C" int paddle_fused_conv(const void* x, const void* w,
                                 const void* ep_scale, const void* ep_shift,
                                 const void* ps, const void* pb, void* out,
                                 void* part1, void* part2, int is_bf16,
                                 int stats, int relu, int pre, int relu_in,
                                 int N, int H, int W, int C, int K, int ksize,
                                 int body, int tile_rows, int tn, int slab,
                                 int a_rows, int a_stages, int w_stages,
                                 int smem, int tiles, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || K < 1 ||
      (ksize != 1 && ksize != 3) || (pre && !stats))
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)N * H * W;
  if (m >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  Conv p{(int)m, H, W, H * W, C, K, ksize, (ksize - 1) / 2};
  const Plan pl{body,     tile_rows, tn,   slab, a_rows,
                a_stages, w_stages,  smem, tiles};
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
                             relu != 0, false, pl, st);
  else if (pre)
    e = launch<true, true>(x, w, sc, sh, s, b, out, p1, p2, is_bf16, p, false,
                           relu_in != 0, pl, st);
  else
    e = launch<true, false>(x, w, sc, sh, s, b, out, p1, p2, is_bf16, p,
                            false, false, pl, st);
  return static_cast<int>(e);
}

// mean and var [K] (f32) of the K11 launch whose partials are part
// [2, tiles, K], over count rows: the tiles summed span at a time into
// scratch [2, scratch_rows, K], then those sums. scratch_rows must be
// ceil(tiles / span), or 0 (no scratch) where that is 1; anything else is
// refused with cudaErrorInvalidValue.
extern "C" int paddle_conv_stats_finish(const void* part, int tiles, int K,
                                        int count, int span, int scratch_rows,
                                        void* scratch, void* mean, void* var,
                                        void* stream) {
  if (tiles < 1 || K < 1 || count < 1 || span < 1)
    return (int)cudaErrorInvalidValue;
  const int spans = (tiles + span - 1) / span;
  if (scratch_rows != (spans > 1 ? spans : 0) || (spans > 1 && !scratch) ||
      spans > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(part);
  float* m = static_cast<float*>(mean);
  float* v = static_cast<float*>(var);
  const int cols = (K + 31) / 32;
  int rows = tiles;
  if (spans > 1) {
    float* sums = static_cast<float*>(scratch);
    stats_reduce<<<dim3(cols, spans), 256, 0, st>>>(src, tiles, K, span, sums,
                                                    count, m, v);
    src = sums;
    rows = spans;
  }
  stats_reduce<<<dim3(cols, 1), 256, 0, st>>>(src, rows, K, rows, nullptr,
                                              count, m, v);
  return static_cast<int>(cudaGetLastError());
}

// ps, pb [C] (f32) of the prologue from the previous BatchNorm's mean and
// var [C] (f32) and its gamma and beta [C] (bf16 if affine_bf16, else f32)
extern "C" int paddle_bn_fold(const void* mean, const void* var,
                              const void* gamma, const void* beta,
                              int affine_bf16, int C, float eps, void* ps,
                              void* pb, void* stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* v = static_cast<const float*>(var);
  float* s = static_cast<float*>(ps);
  float* b = static_cast<float*>(pb);
  if (affine_bf16)
    bn_fold<bf16><<<grid, 256, 0, st>>>(m, v, static_cast<const bf16*>(gamma),
                                        static_cast<const bf16*>(beta), C,
                                        eps, s, b);
  else
    bn_fold<float><<<grid, 256, 0, st>>>(
        m, v, static_cast<const float*>(gamma),
        static_cast<const float*>(beta), C, eps, s, b);
  return static_cast<int>(cudaGetLastError());
}
