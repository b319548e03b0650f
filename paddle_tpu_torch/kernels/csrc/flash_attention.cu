// Flash attention forward and backward for Hopper (sm_90a), bf16 and fp32.
//
// Replaces the three Pallas TPU kernels of
// paddle_tpu/pallas_kernels/flash_attention.py:
//   K1 flash_fwd_wg, flash_fwd_fp32 <- _flash_fwd (pallas_call :211,
//                                        body _fwd_kernel :96)
//   K2 flash_bwd_dkdv_* <- _flash_bwd dK/dV (pallas_call :388, body _bwd_dkdv_kernel :230)
//   K3 flash_bwd_dq_*   <- _flash_bwd dQ    (pallas_call :426, body _bwd_dq_kernel :290)
//
// What bounds them on this card: at the training shape (b 16, s 1024,
// 12 heads of 64, causal) the forward moves ~100 MB and does ~26 GFLOP,
// so by the data sheet it sits on the line between bytes and operations;
// the two backward passes do 2-3x the operations on the same bytes and
// are bound by operations (tensor-core rate in bf16).
//
// Design, against the TPU kernels' sequential grids and 1024x1024 VMEM
// blocks:
// - The bf16 forward (flash_fwd_wg) is built for Hopper's full tensor-core
//   rate. At head_dim 64 the softmax's exponentials cost as much issue
//   time as the products, and a block's loads must not wait on its
//   products: one persistent block per SM walks the (128-query tile,
//   batch x head) items, longest causal tiles first; a producer warp keeps
//   Q and a ring of K/V tiles in flight by TMA (4-D tensor maps over the
//   caller's strides, so a fused-qkv view is read in place); two consumer
//   warpgroups of 64 rows run S = Q K^T and O += P V as wgmma (V read
//   MN-major), take turns issuing them, and each runs the softmax of one
//   tile while the previous tile's P V is on the tensor cores, its own
//   and the other warpgroup's products (ex2 in base 2, masks only on tiles
//   crossing the diagonal, a segment or S, one reciprocal a row at the
//   end). head_dim 32 is computed as 64 zero-filled columns.
// - The bf16 backward passes (flash_bwd_dq_wg, flash_bwd_dkdv_wg) have the
//   forward's shape: one persistent block per SM walks (128-row tile,
//   batch x head) items (query tiles for dQ, longest causal tiles first;
//   key tiles for dK/dV, key tile 0 first), a producer warp keeps the
//   item's own two tiles and a ring of streamed 64-row tiles in flight
//   by TMA, and two consumer warpgroups of 64 rows run every product as
//   wgmma: S and dP against K-major K, V tiles and dQ += dS K against the
//   same K tile read MN-major; S^T and dP^T against K-major Q, dO tiles
//   and dV += P^T dO, dK += dS^T Q against the same tiles read MN-major.
//   The TPU's sequential grid axis becomes the ring; nothing is carried
//   between items and neither pass uses atomics, so results are
//   deterministic.
// - fp32 runs plain fp32 FMA from shared-memory tiles (32 rows), never
//   TF32, so its check against the plain version is exact to rounding
//   order. It is the card-against-CPU parity path, not a fast path.
// - Softmax statistics and the online rescale are fp32. The finite
//   NEG_INF = -1e30 of the TPU kernel masks scores (a fully masked tile
//   then contributes exp(0) that the next real tile's alpha = 0 wipes
//   out; -INFINITY would give NaN), and l is clamped to 1e-30.
// - p (forward, dV) and ds (dK, dQ) are rounded to the input dtype
//   before their second product, as the TPU kernel does.
// - Inputs are [b, s, h, d] read through (batch, row, head) strides with
//   a unit inner stride (tensor maps in bf16, so a fused-qkv view is read
//   in place); a ragged last tile is zero-filled on load and masked (key
//   >= s) so any length works. Causal walks skip the tiles beyond the
//   diagonal (and a warpgroup the tiles wholly beyond its rows).
//
// C interface (ctypes): each entry returns cudaGetLastError() after its
// launch; strides are int64 (batch, row, head) triples per input tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // bf16 typedef, packing, accumulator as A
#include "sm90.cuh"      // TMA, mbarriers, wgmma, tensor maps

#define NEG_INF (-1e30f)
#define NT 256
#define NWARPS (NT / 32)

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  const int* seg;
  void* out;
  float* lse;
  void* dq;
  void* dk;
  void* dv;
  long long sq[3], sk[3], sv[3], sdo[3];  // batch, row, head strides
  int B, S, H, causal;
  float scale;
};

__device__ __forceinline__ bool visible(const Args& a, int b, int qpos,
                                        int kpos) {
  if (kpos >= a.S) return false;
  if (a.causal && kpos > qpos) return false;
  if (a.seg && a.seg[b * a.S + min(qpos, a.S - 1)] != a.seg[b * a.S + kpos])
    return false;
  return true;
}

template <typename T>
__device__ __forceinline__ const T* slice(const void* base,
                                          const long long* st, int b, int h) {
  return reinterpret_cast<const T*>(base) + b * st[0] + h * st[2];
}

// rows [row0, row0 + R) of one (batch, head) slice into shared memory
// [R][ld]; rows past S are zeros
template <typename T, int D>
__device__ void load_tile(T* sm, int ld, const T* g, long long st, int row0,
                          int R, int S) {
  constexpr int PER = 16 / sizeof(T);
  constexpr int CPR = D / PER;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < R * CPR; i += NT) {
    int r = i / CPR, c = (i % CPR) * PER;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = __ldg(reinterpret_cast<const uint4*>(g + (row0 + r) * st + c));
    if (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(sm + r * ld + c) = val;
    } else {
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int j = 0; j < PER; ++j) sm[r * ld + c + j] = e[j];
    }
  }
}

// ===========================================================================
// bf16
// ===========================================================================

// a warp's 16 x D fp32 accumulator (rows g and g + 8 of each lane) into
// [b, s, h, d] bf16 at row0, rows < S only
template <int D>
__device__ void store_acc(void* base, const Args& a, int b, int h, int row0,
                          float (*acc)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  bf16* out = reinterpret_cast<bf16*>(base) + (long long)b * a.S * a.H * D +
              (long long)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= a.S) continue;
    uint32_t* dst =
        reinterpret_cast<uint32_t*>(out + (long long)row * a.H * D + 2 * t);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      dst[n * 4] = pack2f(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ===========================================================================
// K1, bf16: persistent TMA ring, wgmma
// ===========================================================================
//
// One persistent block per SM walks the (128-query tile, batch x head)
// items, the longest causal tiles first. Warp 0 of the producer
// warpgroup loads each item's Q tile once and keeps a ring of K and V
// tiles in flight on mbarriers (4-D tensor maps over [b, s, h, d] read
// through the caller's strides, 128-byte swizzled 64-column panels, rows
// past S zero-filled), across items. Two consumer warpgroups own 64 query
// rows each: S = Q K^T is wgmma m64nBNk16 with Q's fragments in registers
// (loaded once an item) and K read K-major through a descriptor; the
// online softmax runs on the accumulator fragments, masking only tiles
// that cross the diagonal, a segment boundary or S; P, rounded to bf16,
// is re-laid in registers as the A operand of O += P V, with V read
// MN-major through the descriptor's transpose bit.

constexpr int FW_ROWS = 128;        // query rows per item
constexpr int FW_CONSUMERS = 256;   // two consumer warpgroups of 64 rows
constexpr int FW_THREADS = FW_CONSUMERS + 128;  // and the producer's
constexpr int FW_SMEM_MAX = 232448;

// head_dim D computed as DP columns: 32 is zero-padded to one 64-column
// panel by the copies' fill past the tensor's last column
template <int D>
struct FwGeom {
  static constexpr int DP = D < 64 ? 64 : D;
  static constexpr int BN = DP <= 64 ? 128 : 64;  // keys per tile
  static constexpr int PANELS = DP / 64;          // 64-column panels
  static constexpr int Q_BYTES = FW_ROWS * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;    // one of K, V
  static constexpr int FIT =
      (FW_SMEM_MAX - 1024 - Q_BYTES - 16) / (2 * KV_BYTES + 16);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  // Q, the ring (K then V a stage), mbarriers full, empty, q_full, q_empty
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (2 * STAGES + 2);
};

// 2^x on the special-function unit (2 ulp; 0 for the masked NEG_INF)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The two consumer warpgroups take turns issuing their products (named
// barriers 2 and 3, one a warpgroup, 256 threads: one side syncs, the
// other arrives), so one's softmax runs under the other's products (the
// training shape's forward 0.112 -> 0.102 ms, one H100 80GB HBM3, 700 W).
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(2 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 - wg) : "memory");
}

template <int D>
__global__ void __launch_bounds__(FW_THREADS, 1)
    flash_fwd_wg(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const Args a) {
  typedef FwGeom<D> G;
  constexpr int BN = G::BN, ST = G::STAGES, KV = G::KV_BYTES;
  constexpr int NJ = BN / 8, ND = G::DP / 8, KD = G::DP / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sKV = base + G::Q_BYTES;
  const uint32_t full = sKV + ST * 2 * KV, empty = full + 8 * ST;
  const uint32_t q_full = empty + 8 * ST, q_empty = q_full + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_q = (a.S + FW_ROWS - 1) / FW_ROWS, n_k = (a.S + BN - 1) / BN;
  const int BH = a.B * a.H, items = n_q * BH;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, FW_CONSUMERS / 32);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, FW_CONSUMERS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // item -> (query tile, batch x head): every head's last tile first
  auto origin = [&](int item, int& q0, int& bh, int& last) {
    const int r = item / BH;
    bh = item - r * BH;
    q0 = (a.causal ? n_q - 1 - r : r) * FW_ROWS;
    last = a.causal ? min(n_k, (q0 + FW_ROWS - 1) / BN + 1) : n_k;
  };

  if (warp >= FW_CONSUMERS / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (warp != FW_CONSUMERS / 32 || lane != 0) return;
    int s = 0, ph = 0, n = 0;
    bool reuse = false;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      int q0, bh, last;
      origin(item, q0, bh, last);
      const int b = bh / a.H, h = bh - b * a.H;
      // Q once an item, after the consumers have read the previous one
      if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
      mbar_expect_tx(q_full, G::Q_BYTES);
#pragma unroll
      for (int p = 0; p < G::PANELS; ++p)
        tma_load_4d(sQ + p * FW_ROWS * 128, &qmap, 64 * p, h, q0, b, q_full);
      for (int kb = 0; kb < last; ++kb) {
        if (reuse) mbar_wait(empty + 8 * s, ph ^ 1);
        const uint32_t kt = sKV + s * 2 * KV;
        mbar_expect_tx(full + 8 * s, 2 * KV);
#pragma unroll
        for (int p = 0; p < G::PANELS; ++p) {
          tma_load_4d(kt + p * BN * 128, &kmap, 64 * p, h, kb * BN, b,
                      full + 8 * s);
          tma_load_4d(kt + KV + p * BN * 128, &vmap, 64 * p, h, kb * BN, b,
                      full + 8 * s);
        }
        if (++s == ST) s = 0, ph ^= 1, reuse = true;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the item;
  // this thread's accumulator rows are 16 wl + g and + 8 of them
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = wg * 64 + wl * 16 + (lane & 15), lhi = lane >> 4;
  // scores in base 2: exp(x * scale) = exp2(x * scale * log2(e))
  const float sl2 = a.scale * 1.4426950408889634f;
  // warpgroup 0 issues first; every item both take last + 1 turns
  if (wg == 1) turn_pass(1);
  int s = 0, ph = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    int q0, bh, last;
    origin(item, q0, bh, last);
    const int b = bh / a.H, h = bh - b * a.H;
    const int qw0 = q0 + wg * 64;
    const int qrow[2] = {qw0 + wl * 16 + g, qw0 + wl * 16 + g + 8};
    // causal: the key tiles that reach this warpgroup's rows
    const int last_wg = a.causal ? min(last, (qw0 + 63) / BN + 1) : last;
    const int* seg = a.seg ? a.seg + (long long)b * a.S : nullptr;
    int qseg[2] = {0, 0};
    if (seg)
      for (int r = 0; r < 2; ++r) qseg[r] = seg[min(qrow[r], a.S - 1)];
    uint32_t qf[KD][4];
    mbar_wait(q_full, n & 1);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldsm_x4(qf[kk], sQ + (kk >> 2) * FW_ROWS * 128 +
                          swz128(lrow, 2 * (kk & 3) + lhi));
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty);

    float o[ND][4];
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float sc[NJ][4];
    uint32_t pa[BN / 16][4];  // P of the tile in slot ps, for P . V
    int ps = 0;
    // O += P V of the tile in slot ps (committed, not waited for)
    auto issue_pv = [&]() {
      const uint32_t vt = sKV + ps * 2 * KV + KV;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t dv = desc_sw128_mn(vt + kk * 16 * 128, BN * 128);
        if constexpr (G::DP == 64) wgmma_n64<1>(o, pa[kk], dv);
        else wgmma_n128<1>(o, pa[kk], dv);
      }
      wgmma_commit();
    };
    auto release = [&](int slot) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * slot);
    };
    // S = Q K^T of the tile in slot sl (committed, not waited for)
    auto issue_s = [&](int sl) {
      const uint32_t kt = sKV + sl * 2 * KV;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const uint64_t dk =
            desc_sw128(kt + (kk >> 2) * BN * 128 + 32 * (kk & 3));
        // the first product overwrites sc
        if constexpr (BN == 128) wgmma_n128(sc, qf[kk], dk, kk > 0);
        else wgmma_n64(sc, qf[kk], dk, kk > 0);
      }
      wgmma_commit();
    };
    // the online softmax of S (tile at key k0) for rows g and g + 8: sc
    // becomes p, alpha the rescale of the running sums; masks only where
    // the tile crosses the diagonal, a segment boundary or S (masked
    // scores take the finite NEG_INF)
    float alpha[2];
    auto softmax = [&](int k0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= sl2;
      if ((a.causal && k0 + BN - 1 > qw0) || k0 + BN > a.S || seg) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + j * 8 + 2 * t + e;
            const bool kin = key < a.S;
            const int ks = seg && kin ? seg[key] : 0;
#pragma unroll
            for (int r = 0; r < 2; ++r)
              if (!kin || (a.causal && key > qrow[r]) ||
                  (seg && ks != qseg[r]))
                sc[j][2 * r + e] = NEG_INF;
          }
      }
      // four independent chains a row for the max and the sum
      float mx[2][4], sum[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) mx[r][c] = NEG_INF, sum[r][c] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1][(j & 1) * 2 + (e & 1)] =
              fmaxf(mx[e >> 1][(j & 1) * 2 + (e & 1)], sc[j][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(
            m[r], quad_max(fmaxf(fmaxf(mx[r][0], mx[r][1]),
                                 fmaxf(mx[r][2], mx[r][3]))));
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = ex2(sc[j][e] - m[e >> 1]);
          sum[e >> 1][(j & 1) * 2 + (e & 1)] += sc[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = l[r] * alpha[r] +
               quad_sum((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
    };
    // after P V: O rescaled, P of this tile packed as the next A operand
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) acc_as_a(pa[kk], sc, kk);
    };
    auto advance = [&]() {
      if (++s == ST) s = 0, ph ^= 1;
    };

    // the first tile: S alone
    mbar_wait(full + 8 * s, ph);
    turn_wait(wg);
    issue_s(s);
    turn_pass(wg);
    wgmma_wait0();
    softmax(0);
    rescale_and_pack();
    ps = s;
    advance();
    // every further tile that reaches these rows: its S, and under it
    // the previous tile's P V; the softmax of S while P V finishes
    int kb = 1;
    for (; kb < last_wg; ++kb) {
      mbar_wait(full + 8 * s, ph);
      turn_wait(wg);
      issue_s(s);
      issue_pv();
      turn_pass(wg);
      wgmma_wait1();
      softmax(kb * BN);
      wgmma_wait0();
      release(ps);
      rescale_and_pack();
      ps = s;
      advance();
    }
    for (; kb < last; ++kb) {  // beyond this warpgroup's rows
      mbar_wait(full + 8 * s, ph);
      release(s);
      turn_wait(wg);
      turn_pass(wg);
      advance();
    }
    // the last tile's P V
    turn_wait(wg);
    wgmma_fence();
    issue_pv();
    turn_pass(wg);
    wgmma_wait0();
    release(ps);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l_safe = fmaxf(l[r], 1e-30f);
      if (t == 0 && qrow[r] < a.S)
        a.lse[(long long)bh * a.S + qrow[r]] =
            m[r] * 0.6931471805599453f + logf(l_safe);
      // acc / l_safe as one reciprocal a row (within an f32 ulp of the
      // TPU's division, far below the bf16 rounding that follows)
      const float inv = 1.f / l_safe;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[j][2 * r] *= inv;
        o[j][2 * r + 1] *= inv;
      }
    }
    store_acc<D>(a.out, a, b, h, qw0 + wl * 16, o);  // the first D columns
  }
  if (wg == 0) turn_wait(0);  // warpgroup 1's last pass
}

// ===========================================================================
// K2 and K3, bf16: persistent TMA rings, wgmma
// ===========================================================================
//
// Both passes have K1's shape: one persistent block per SM walks items of
// 128 rows (queries for dQ, keys for dK/dV) x (batch, head); the producer
// warp loads an item's own two tiles once (into a second buffer while the
// consumers still read the first, at head_dim <= 64) and keeps a ring of
// streamed 64-row tiles in flight on mbarriers, across items (4-D tensor
// maps over the caller's strides, 128-byte swizzled 64-column panels,
// rows past S zero-filled); two consumer warpgroups own 64 of the item's rows each
// and run every product as wgmma. The score products read both operands
// from shared memory (wgmma_ss_n64: the item's own tile as A, a streamed
// tile as B, both K-major); the accumulating products take the rounded
// p or dS from registers as A and read the same streamed tile MN-major
// (the descriptor's transpose bit), so one staged tile serves both. The
// own tiles stay in shared memory for the whole item: held as register
// fragments across the tile loop instead (K1's way), they gave wrong
// gradients at head_dim 64 for a reason not found: a compiler fault, a
// missing fence and a fragment rewritten under an async wgmma look alike.
// Register plan of a consumer thread (32-bit registers):
//   dQ   S, dP 32 + 32; dS 16; dQ 32 (D <= 64) or 64 (D = 128)
//   dKdV S^T, dP^T 32 + 32; P^T, dS^T 16 + 16; dK, dV 32 + 32 (D <= 64)
//        or 64 + 64 (D = 128)
// Scores are scaled in base 2 (ex2, log2(e) folded into the scale and
// the LSE); masks apply only to tiles that cross the diagonal or S, and
// with segment ids to every tile. The accumulators leave through a
// swizzled staging tile and a TMA store clipped at S and at head_dim.

constexpr int BW_ROWS = 128;       // an item's own rows
constexpr int BW_TILE = 64;        // rows of a streamed tile
constexpr int BW_CONSUMERS = 256;  // two consumer warpgroups of 64 rows
constexpr int BW_THREADS = BW_CONSUMERS + 128;  // and the producer's
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BW_STAGES = 4;  // streamed tiles in flight, where they fit

template <int D>
struct BwGeom {
  static constexpr int DP = D < 64 ? 64 : D;  // 32 as one zero-filled panel
  static constexpr int PANELS = DP / 64;
  static constexpr int OWN_BYTES = BW_ROWS * DP * 2;   // one own tile
  static constexpr int TILE_BYTES = BW_TILE * DP * 2;  // one streamed tile
  static constexpr int OUT_BYTES = 64 * DP * 2;  // a warpgroup's staging
  // K3: Q and dO (twice, where the ring still keeps 3 stages: the next
  // item's pair loads during this one), the ring (K then V a stage), a
  // staging tile a warpgroup; mbarriers full, empty, own_full, own_empty
  static constexpr int DQ_FIT2 =
      (FW_SMEM_MAX - 1024 - 4 * OWN_BYTES - 2 * OUT_BYTES - 32) /
      (2 * TILE_BYTES + 16);
  static constexpr int DQ_OWN = DQ_FIT2 >= 3 ? 2 : 1;
  static constexpr int DQ_FIT =
      (FW_SMEM_MAX - 1024 - 2 * DQ_OWN * OWN_BYTES - 2 * OUT_BYTES -
       16 * DQ_OWN) /
      (2 * TILE_BYTES + 16);
  static constexpr int DQ_STAGES = DQ_FIT < BW_STAGES ? DQ_FIT : BW_STAGES;
  static constexpr int DQ_SMEM = 1024 + 2 * DQ_OWN * OWN_BYTES +
                                 DQ_STAGES * 2 * TILE_BYTES + 2 * OUT_BYTES +
                                 8 * (2 * DQ_STAGES + 2 * DQ_OWN);
  // K2: K and V (twice where that fits beside 3 stages), the ring (Q then
  // dO a stage), two staging tiles a warpgroup (dK, dV), the ring's
  // column statistics (lse * log2(e), delta, segment id of each query),
  // mbarriers
  static constexpr int STAT_BYTES = 3 * BW_TILE * 4;
  static constexpr int KV_FIT2 =
      (FW_SMEM_MAX - 1024 - 4 * OWN_BYTES - 4 * OUT_BYTES - 32) /
      (2 * TILE_BYTES + STAT_BYTES + 16);
  static constexpr int KV_OWN = KV_FIT2 >= 3 ? 2 : 1;
  static constexpr int KV_FIT =
      (FW_SMEM_MAX - 1024 - 2 * KV_OWN * OWN_BYTES - 4 * OUT_BYTES -
       16 * KV_OWN) /
      (2 * TILE_BYTES + STAT_BYTES + 16);
  static constexpr int KV_STAGES = KV_FIT < BW_STAGES ? KV_FIT : BW_STAGES;
  static constexpr int KV_SMEM =
      1024 + 2 * KV_OWN * OWN_BYTES +
      KV_STAGES * (2 * TILE_BYTES + STAT_BYTES) + 4 * OUT_BYTES +
      8 * (2 * KV_STAGES + 2 * KV_OWN);
};

// a warpgroup's own barrier (128 threads; named barriers 1 and 2)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// acc[64 x 64] = A . B^T over DP columns: A the warpgroup's 64 rows of an
// own tile, B a streamed tile of 64 rows, both read K-major from shared
// memory
template <int DP>
__device__ __forceinline__ void score_product(float (&acc)[BW_TILE / 8][4],
                                              uint32_t own, int wg,
                                              uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint64_t da = desc_sw128(own + (kk >> 2) * BW_ROWS * 128 +
                                   wg * 64 * 128 + 32 * (kk & 3));
    const uint64_t db =
        desc_sw128(tile + (kk >> 2) * BW_TILE * 128 + 32 * (kk & 3));
    wgmma_ss_n64(acc, da, db, kk > 0);
  }
}

// acc[64 x DP] += A . B: A the bf16 fragments a of K columns, B the
// streamed tile (K rows) read MN-major
template <int DP, int K>
__device__ __forceinline__ void accumulate_product(float (&acc)[DP / 8][4],
                                                   uint32_t (&a)[K / 16][4],
                                                   uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = desc_sw128_mn(tile + kk * 16 * 128, K * 128);
    if constexpr (DP == 64) wgmma_n64<1>(acc, a[kk], db);
    else wgmma_n128<1>(acc, a[kk], db);
  }
}

// a warpgroup's 64 x DP accumulator, rounded to bf16, into its staging
// tile (64-row swizzled panels) and out by a TMA store to rows [row0,
// row0 + 64) of (b, h), clipped at S and at head_dim. The issuing thread
// first waits until its previous store has read the tile.
template <int DP>
__device__ __forceinline__ void store_wg(float (&acc)[DP / 8][4],
                                         uint8_t* stage, const CUtensorMap* m,
                                         int b, int h, int row0, int wg,
                                         int wrow, int t, bool issuer) {
  if (issuer) tma_store_wait_read();
  wg_sync(wg);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    uint8_t* panel = stage + (j >> 3) * (64 * 128);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(panel + swz128(wrow + 8 * hh, j & 7) +
                                   4 * t) =
          pack2f(acc[j][2 * hh], acc[j][2 * hh + 1]);
  }
  fence_proxy_async();
  wg_sync(wg);
  if (issuer) {
#pragma unroll
    for (int p = 0; p < DP / 64; ++p)
      tma_store_4d(m, 64 * p, h, row0, b, smem_u32(stage + p * 64 * 128));
    tma_store_commit();
  }
}

// K3, bf16: items of 128 queries, every head's last tile first; the ring
// streams 64-key K and V tiles up to the diagonal. Per tile and
// warpgroup: S = Q K^T and dP = dO V^T (K, V read K-major); p =
// exp2(S scale log2(e) - lse log2(e)); dS = p (dP - delta) scale, rounded
// to bf16 in registers as the A operand of dQ += dS K (K read MN-major).
template <int D>
__global__ void __launch_bounds__(BW_THREADS, 1)
    flash_bwd_dq_wg(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const __grid_constant__ CUtensorMap dqmap, const Args a) {
  typedef BwGeom<D> G;
  constexpr int BN = BW_TILE, ST = G::DQ_STAGES, T = G::TILE_BYTES;
  constexpr int OB = G::DQ_OWN;
  constexpr int NJ = BN / 8, ND = G::DP / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // own buffer o: Q at base + 2 o OWN_BYTES, dO after it
  const uint32_t sKV = base + 2 * OB * G::OWN_BYTES;
  const uint32_t sOut = sKV + ST * 2 * T;
  const uint32_t full = sOut + 2 * G::OUT_BYTES, empty = full + 8 * ST;
  const uint32_t own_full = empty + 8 * ST, own_empty = own_full + 8 * OB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_q = (a.S + BW_ROWS - 1) / BW_ROWS, n_k = (a.S + BN - 1) / BN;
  const int BH = a.B * a.H, items = n_q * BH;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, BW_CONSUMERS / 32);
    }
    for (int o = 0; o < OB; ++o) {
      mbar_init(own_full + 8 * o, 1);
      mbar_init(own_empty + 8 * o, BW_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // item -> (query tile, batch x head): every head's last tile first
  auto origin = [&](int item, int& q0, int& bh, int& last) {
    const int r = item / BH;
    bh = item - r * BH;
    q0 = (a.causal ? n_q - 1 - r : r) * BW_ROWS;
    last = a.causal ? min(n_k, (q0 + BW_ROWS - 1) / BN + 1) : n_k;
  };

  if (warp >= BW_CONSUMERS / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != BW_CONSUMERS / 32 || lane != 0) return;
    int s = 0, ph = 0, n = 0;
    bool reuse = false;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      int q0, bh, last;
      origin(item, q0, bh, last);
      const int b = bh / a.H, h = bh - b * a.H;
      // Q and dO once an item, into the buffer the consumers have left
      const int o = n % OB;
      const uint32_t sQ = base + 2 * o * G::OWN_BYTES;
      const uint32_t sDO = sQ + G::OWN_BYTES, of = own_full + 8 * o;
      if (n >= OB) mbar_wait(own_empty + 8 * o, (n / OB - 1) & 1);
      mbar_expect_tx(of, 2 * G::OWN_BYTES);
#pragma unroll
      for (int p = 0; p < G::PANELS; ++p) {
        tma_load_4d(sQ + p * BW_ROWS * 128, &qmap, 64 * p, h, q0, b, of);
        tma_load_4d(sDO + p * BW_ROWS * 128, &domap, 64 * p, h, q0, b, of);
      }
      for (int kb = 0; kb < last; ++kb) {
        if (reuse) mbar_wait(empty + 8 * s, ph ^ 1);
        const uint32_t kt = sKV + s * 2 * T;
        mbar_expect_tx(full + 8 * s, 2 * T);
#pragma unroll
        for (int p = 0; p < G::PANELS; ++p) {
          tma_load_4d(kt + p * BN * 128, &kmap, 64 * p, h, kb * BN, b,
                      full + 8 * s);
          tma_load_4d(kt + T + p * BN * 128, &vmap, 64 * p, h, kb * BN, b,
                      full + 8 * s);
        }
        if (++s == ST) s = 0, ph ^= 1, reuse = true;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the item;
  // this thread's accumulator rows are 16 wl + g and + 8 of them
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const bool issuer = (tid & 127) == 0;
  const float sl2 = a.scale * LOG2E;
  uint8_t* stage = smem_raw + (sOut - raw) + wg * G::OUT_BYTES;
  int s = 0, ph = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    int q0, bh, last;
    origin(item, q0, bh, last);
    const int b = bh / a.H, h = bh - b * a.H;
    const int qw0 = q0 + wg * 64;
    const int qrow[2] = {qw0 + wl * 16 + g, qw0 + wl * 16 + g + 8};
    // causal: the key tiles that reach this warpgroup's rows
    const int last_wg = a.causal ? min(last, (qw0 + 63) / BN + 1) : last;
    const int* seg = a.seg ? a.seg + (long long)b * a.S : nullptr;
    float lse2[2], dlt[2];
    int qseg[2] = {0, 0};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = qrow[r] < a.S;
      const long long o = (long long)bh * a.S + qrow[r];
      lse2[r] = in ? a.lse_in[o] * LOG2E : 0.f;
      dlt[r] = in ? a.delta[o] : 0.f;
      if (seg) qseg[r] = seg[min(qrow[r], a.S - 1)];
    }
    const int o = n % OB;
    const uint32_t sQ = base + 2 * o * G::OWN_BYTES;
    const uint32_t sDO = sQ + G::OWN_BYTES;
    mbar_wait(own_full + 8 * o, (n / OB) & 1);
    float dq[ND][4];
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
    float sc[NJ][4], dp[NJ][4];
    uint32_t dsa[BN / 16][4];
    // S and dP of the tile in slot sl (committed, not waited for)
    auto scores = [&](int sl) {
      const uint32_t kt = sKV + sl * 2 * T;
      wgmma_fence();
      score_product<G::DP>(sc, sQ, wg, kt);
      score_product<G::DP>(dp, sDO, wg, kt + T);
      wgmma_commit();
    };
    // dS of the tile at key k0 into sc, fp32; masks only where the tile
    // crosses the diagonal or S, or under segments
    auto grads = [&](int k0) {
      const bool edge =
          (a.causal && k0 + BN - 1 > qw0) || k0 + BN > a.S || seg;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + j * 8 + 2 * t + e;
          const bool kin = key < a.S;
          const int ks = (edge && seg && kin) ? seg[key] : 0;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float p = ex2(fmaf(sc[j][2 * r + e], sl2, -lse2[r]));
            if (edge && (!kin || (a.causal && key > qrow[r]) ||
                         (seg && ks != qseg[r])))
              p = 0.f;
            sc[j][2 * r + e] = p * (dp[j][2 * r + e] - dlt[r]) * a.scale;
          }
        }
    };
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) acc_as_a(dsa[kk], sc, kk);
    };
    // dQ += dS K of the tile in slot sl (committed, not waited for)
    auto accumulate = [&](int sl) {
      accumulate_product<G::DP, BN>(dq, dsa, sKV + sl * 2 * T);
      wgmma_commit();
    };
    auto release = [&](int sl) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * sl);
    };
    auto advance = [&]() {
      if (++s == ST) s = 0, ph ^= 1;
    };
    // the first tile (every warpgroup has one): its scores alone
    mbar_wait(full + 8 * s, ph);
    scores(s);
    wgmma_wait0();
    grads(0);
    pack();
    int ps = s;  // the slot whose dS is packed
    advance();
    // every further tile: its scores, and behind them the previous
    // tile's dQ product, under which this tile's dS is computed
    int kb = 1;
    for (; kb < last_wg; ++kb) {
      mbar_wait(full + 8 * s, ph);
      scores(s);
      accumulate(ps);
      wgmma_wait1();
      grads(kb * BN);
      wgmma_wait0();
      release(ps);
      pack();
      ps = s;
      advance();
    }
    // the last tile's dQ product
    wgmma_fence();
    accumulate(ps);
    wgmma_wait0();
    release(ps);
    for (; kb < last; ++kb) {  // beyond this warpgroup's rows
      mbar_wait(full + 8 * s, ph);
      release(s);
      advance();
    }
    // the item's own tiles read for the last time
    __syncwarp();
    if (lane == 0) mbar_arrive(own_empty + 8 * o);
    store_wg<G::DP>(dq, stage, &dqmap, b, h, qw0, wg, wl * 16 + g, t, issuer);
  }
  if (issuer) tma_store_wait_all();
}

// K2, bf16: items of 128 keys, key tile 0 first (under causal masking it
// sees the most queries); the ring streams 64-query Q and dO tiles from
// the diagonal, each with its queries' lse * log2(e), delta and segment
// id, which the producer warp writes beside it. Per tile and warpgroup,
// the transposed products: S^T = K Q^T and dP^T = V dO^T (Q, dO read
// K-major); p^T and dS^T rounded to bf16 in registers as the A operands
// of dV += p^T dO and dK += dS^T Q (the same dO and Q tiles read
// MN-major). A query past S contributes nothing: its p is masked to 0
// (TMA zero-fills its Q and dO rows; its padded statistics are zeros).
template <int D>
__global__ void __launch_bounds__(BW_THREADS, 1)
    flash_bwd_dkdv_wg(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap,
                      const __grid_constant__ CUtensorMap dkmap,
                      const __grid_constant__ CUtensorMap dvmap,
                      const Args a) {
  typedef BwGeom<D> G;
  constexpr int BQ = BW_TILE, ST = G::KV_STAGES, T = G::TILE_BYTES;
  constexpr int OB = G::KV_OWN;
  constexpr int NJ = BQ / 8, ND = G::DP / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // own buffer o: K at base + 2 o OWN_BYTES, V after it
  const uint32_t sQD = base + 2 * OB * G::OWN_BYTES;
  const uint32_t sOut = sQD + ST * 2 * T;
  const uint32_t sStat = sOut + 4 * G::OUT_BYTES;
  const uint32_t full = sStat + ST * G::STAT_BYTES, empty = full + 8 * ST;
  const uint32_t own_full = empty + 8 * ST, own_empty = own_full + 8 * OB;
  float* stats = reinterpret_cast<float*>(smem_raw + (sStat - raw));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_k = (a.S + BW_ROWS - 1) / BW_ROWS, n_q = (a.S + BQ - 1) / BQ;
  const int BH = a.B * a.H, items = n_k * BH;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      // the copy's arrival and the producer warp's 32 (statistics)
      mbar_init(full + 8 * i, 33);
      mbar_init(empty + 8 * i, BW_CONSUMERS / 32);
    }
    for (int o = 0; o < OB; ++o) {
      mbar_init(own_full + 8 * o, 1);
      mbar_init(own_empty + 8 * o, BW_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // item -> (key tile, batch x head); causal: the first query tile that
  // reaches the item's keys
  auto origin = [&](int item, int& k0, int& bh, int& first) {
    const int r = item / BH;
    bh = item - r * BH;
    k0 = r * BW_ROWS;
    first = a.causal ? k0 / BQ : 0;
  };

  if (warp >= BW_CONSUMERS / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != BW_CONSUMERS / 32) return;
    int s = 0, ph = 0, n = 0;
    bool reuse = false;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      int k0, bh, first;
      origin(item, k0, bh, first);
      const int b = bh / a.H, h = bh - b * a.H;
      const float* lse = a.lse_in + (long long)bh * a.S;
      const float* delta = a.delta + (long long)bh * a.S;
      const int* seg = a.seg ? a.seg + (long long)b * a.S : nullptr;
      if (lane == 0) {
        // K and V once an item, into the buffer the consumers have left
        const int o = n % OB;
        const uint32_t sK = base + 2 * o * G::OWN_BYTES;
        const uint32_t sV = sK + G::OWN_BYTES, of = own_full + 8 * o;
        if (n >= OB) mbar_wait(own_empty + 8 * o, (n / OB - 1) & 1);
        mbar_expect_tx(of, 2 * G::OWN_BYTES);
#pragma unroll
        for (int p = 0; p < G::PANELS; ++p) {
          tma_load_4d(sK + p * BW_ROWS * 128, &kmap, 64 * p, h, k0, b, of);
          tma_load_4d(sV + p * BW_ROWS * 128, &vmap, 64 * p, h, k0, b, of);
        }
      }
      for (int qb = first; qb < n_q; ++qb) {
        if (reuse) mbar_wait(empty + 8 * s, ph ^ 1);
        const uint32_t qt = sQD + s * 2 * T;
        if (lane == 0) {
          mbar_expect_tx(full + 8 * s, 2 * T);
#pragma unroll
          for (int p = 0; p < G::PANELS; ++p) {
            tma_load_4d(qt + p * BQ * 128, &qmap, 64 * p, h, qb * BQ, b,
                        full + 8 * s);
            tma_load_4d(qt + T + p * BQ * 128, &domap, 64 * p, h, qb * BQ,
                        b, full + 8 * s);
          }
        }
        float* col = stats + s * (3 * BQ);
        for (int i = lane; i < BQ; i += 32) {
          const int q = qb * BQ + i;
          const bool in = q < a.S;
          col[i] = in ? lse[q] * LOG2E : 0.f;
          col[BQ + i] = in ? delta[q] : 0.f;
          col[2 * BQ + i] = __int_as_float(seg ? seg[min(q, a.S - 1)] : 0);
        }
        mbar_arrive(full + 8 * s);
        if (++s == ST) s = 0, ph ^= 1, reuse = true;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  // consumers: warpgroup wg owns keys [64 wg, 64 wg + 64) of the item;
  // this thread's accumulator rows are keys 16 wl + g and + 8 of them,
  // its columns the queries j * 8 + 2 t and + 1 of a tile
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const bool issuer = (tid & 127) == 0;
  const float sl2 = a.scale * LOG2E;
  uint8_t* stage_k = smem_raw + (sOut - raw) + wg * 2 * G::OUT_BYTES;
  uint8_t* stage_v = stage_k + G::OUT_BYTES;
  int s = 0, ph = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    int k0, bh, first;
    origin(item, k0, bh, first);
    const int b = bh / a.H, h = bh - b * a.H;
    const int kw0 = k0 + wg * 64;
    const int krow[2] = {kw0 + wl * 16 + g, kw0 + wl * 16 + g + 8};
    // causal: the first query tile that reaches this warpgroup's keys
    // (the last tile for keys wholly past S, whose rows the stores clip)
    const int first_wg = a.causal ? min(kw0 / BQ, n_q - 1) : first;
    const int* seg = a.seg ? a.seg + (long long)b * a.S : nullptr;
    int kseg[2] = {0, 0};
    if (seg)
      for (int r = 0; r < 2; ++r) kseg[r] = seg[min(krow[r], a.S - 1)];
    const int o = n % OB;
    const uint32_t sK = base + 2 * o * G::OWN_BYTES;
    const uint32_t sV = sK + G::OWN_BYTES;
    mbar_wait(own_full + 8 * o, (n / OB) & 1);
    float dk[ND][4], dv[ND][4];
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
    float st[NJ][4], dpt[NJ][4];
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
    // S^T and dP^T of the tile in slot sl (committed, not waited for)
    auto scores = [&](int sl) {
      const uint32_t qt = sQD + sl * 2 * T;
      wgmma_fence();
      score_product<G::DP>(st, sK, wg, qt);
      score_product<G::DP>(dpt, sV, wg, qt + T);
      wgmma_commit();
    };
    // p^T into st and dS^T into dpt, fp32, for the tile at query q0 in
    // slot sl; masks only where the tile crosses the diagonal or S, or
    // under segments
    auto grads = [&](int q0, int sl) {
      const float* col = stats + sl * (3 * BQ);
      const bool edge =
          (a.causal && q0 < kw0 + 63) || q0 + BQ > a.S || seg;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = j * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(col + c);
        const float2 dl = *reinterpret_cast<const float2*>(col + BQ + c);
        const float2 sg = *reinterpret_cast<const float2*>(col + 2 * BQ + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q0 + c + e;
          const float lq = e ? l2.y : l2.x, dlq = e ? dl.y : dl.x;
          const int qs = __float_as_int(e ? sg.y : sg.x);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float p = ex2(fmaf(st[j][2 * r + e], sl2, -lq));
            if (edge && (q >= a.S || (a.causal && krow[r] > q) ||
                         (seg && qs != kseg[r])))
              p = 0.f;
            dpt[j][2 * r + e] = p * (dpt[j][2 * r + e] - dlq) * a.scale;
            st[j][2 * r + e] = p;
          }
        }
      }
    };
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        acc_as_a(pa[kk], st, kk);
        acc_as_a(dsa[kk], dpt, kk);
      }
    };
    // dV += p^T dO and dK += dS^T Q of the tile in slot sl (committed,
    // not waited for)
    auto accumulate = [&](int sl) {
      const uint32_t qt = sQD + sl * 2 * T;
      accumulate_product<G::DP, BQ>(dv, pa, qt + T);
      accumulate_product<G::DP, BQ>(dk, dsa, qt);
      wgmma_commit();
    };
    auto release = [&](int sl) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * sl);
    };
    auto advance = [&]() {
      if (++s == ST) s = 0, ph ^= 1;
    };
    int qb = first;
    for (; qb < first_wg; ++qb) {  // before this warpgroup's keys
      mbar_wait(full + 8 * s, ph);
      release(s);
      advance();
    }
    // the first tile (every warpgroup has one): its scores alone
    mbar_wait(full + 8 * s, ph);
    scores(s);
    wgmma_wait0();
    grads(qb * BQ, s);
    pack();
    int ps = s;  // the slot whose p^T and dS^T are packed
    advance();
    // every further tile: its scores, and behind them the previous
    // tile's dV and dK products, under which this tile's p^T and dS^T
    // are computed (at head_dim 128 one after the other: the dK/dV
    // accumulators leave no registers for two tiles' fragments)
    for (++qb; qb < n_q; ++qb) {
      mbar_wait(full + 8 * s, ph);
      if constexpr (G::DP == 64) {
        scores(s);
        accumulate(ps);
        wgmma_wait1();
        grads(qb * BQ, s);
        wgmma_wait0();
      } else {
        wgmma_fence();
        accumulate(ps);
        wgmma_wait0();
        scores(s);
        wgmma_wait0();
        grads(qb * BQ, s);
      }
      release(ps);
      pack();
      ps = s;
      advance();
    }
    // the last tile's dV and dK products
    wgmma_fence();
    accumulate(ps);
    wgmma_wait0();
    release(ps);
    // the item's own tiles read for the last time
    __syncwarp();
    if (lane == 0) mbar_arrive(own_empty + 8 * o);
    // keys past S (a ragged last item) are clipped by the stores
    store_wg<G::DP>(dk, stage_k, &dkmap, b, h, kw0, wg, wl * 16 + g, t,
                    issuer);
    store_wg<G::DP>(dv, stage_v, &dvmap, b, h, kw0, wg, wl * 16 + g, t,
                    issuer);
  }
  if (issuer) tma_store_wait_all();
}

// ===========================================================================
// fp32: plain FMA from shared-memory tiles
// ===========================================================================

constexpr int SIMT_R = 32;  // rows per tile (queries and keys): one per lane

// [R][D + 1] tiles: an odd row length keeps columns conflict-free
template <int D> struct Lay {
  static constexpr int R = SIMT_R, LDT = D + 1, LDS = R + 1;
  static constexpr size_t T_TILE = (size_t)R * LDT * sizeof(float);
  static constexpr size_t S_TILE = (size_t)R * LDS * sizeof(float);
  static constexpr size_t VEC = (size_t)R * sizeof(float);
};

//   mm_abt:     C[M][N]  = A[M][K] . B[N][K]^T
//   mm_ab_acc:  C[M][N] += A[M][K] . B[K][N]
//   mm_atb_acc: C[M][N] += A[K][M]^T . B[K][N]
__device__ void mm_abt(float* C, int ldc, const float* A, int lda,
                       const float* B, int ldb, int M, int N, int K) {
  for (int i = threadIdx.x; i < M * N; i += NT) {
    int m = i / N, n = i % N;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = fmaf(A[m * lda + k], B[n * ldb + k], acc);
    C[m * ldc + n] = acc;
  }
}

__device__ void mm_ab_acc(float* C, int ldc, const float* A, int lda,
                          const float* B, int ldb, int M, int N, int K) {
  for (int i = threadIdx.x; i < M * N; i += NT) {
    int m = i / N, n = i % N;
    float acc = C[m * ldc + n];
    for (int k = 0; k < K; ++k) acc = fmaf(A[m * lda + k], B[k * ldb + n], acc);
    C[m * ldc + n] = acc;
  }
}

__device__ void mm_atb_acc(float* C, int ldc, const float* A, int lda,
                           const float* B, int ldb, int M, int N, int K) {
  for (int i = threadIdx.x; i < M * N; i += NT) {
    int m = i / N, n = i % N;
    float acc = C[m * ldc + n];
    for (int k = 0; k < K; ++k) acc = fmaf(A[k * lda + m], B[k * ldb + n], acc);
    C[m * ldc + n] = acc;
  }
}

// rows of an [R][ld] accumulator into [b, s, h, d], rows < S only
template <int D>
__device__ void store_rows(void* base, const Args& a, int b, int h,
                           const float* sm, int ld, int row0) {
  float* g = reinterpret_cast<float*>(base) + (long long)b * a.S * a.H * D +
             (long long)h * D;
  for (int i = threadIdx.x; i < SIMT_R * D; i += NT) {
    int r = i / D, c = i % D;
    if (row0 + r < a.S) g[(long long)(row0 + r) * a.H * D + c] = sm[r * ld + c];
  }
}

// K1, fp32. Block = (32 query rows, batch x head).
template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_fp32(Args a) {
  typedef Lay<D> L;
  constexpr int R = L::R;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + R * L::LDT;
  float* sV = sK + R * L::LDT;
  float* sO = sV + R * L::LDT;
  float* sS = sO + R * L::LDT;
  float* sM = sS + R * L::LDS;
  float* sL = sM + R;
  float* sAlpha = sL + R;

  const int n_tiles = (a.S + R - 1) / R;
  const int qi = a.causal ? n_tiles - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = qi * R;
  const float* gk = slice<float>(a.k, a.sk, b, h);
  const float* gv = slice<float>(a.v, a.sv, b, h);

  load_tile<float, D>(sQ, L::LDT, slice<float>(a.q, a.sq, b, h), a.sq[1], q0,
                      R, a.S);
  for (int i = threadIdx.x; i < R * L::LDT; i += NT) sO[i] = 0.0f;
  for (int i = threadIdx.x; i < R; i += NT) {
    sM[i] = NEG_INF;
    sL[i] = 0.0f;
  }
  const int last = a.causal ? min(n_tiles, (q0 + R - 1) / R + 1) : n_tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int kb = 0; kb < last; ++kb) {
    const int k0 = kb * R;
    __syncthreads();
    load_tile<float, D>(sK, L::LDT, gk, a.sk[1], k0, R, a.S);
    load_tile<float, D>(sV, L::LDT, gv, a.sv[1], k0, R, a.S);
    __syncthreads();
    mm_abt(sS, L::LDS, sQ, L::LDT, sK, L::LDT, R, R, D);
    __syncthreads();
    // online softmax: one warp per row, one lane per key; s -> p in place
    for (int r = warp; r < R; r += NWARPS) {
      float x = sS[r * L::LDS + lane] * a.scale;
      if (!visible(a, b, q0 + r, k0 + lane)) x = NEG_INF;
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sM[r], m_new = fmaxf(m_old, mx);
      const float p = expf(x - m_new);
      sS[r * L::LDS + lane] = p;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sAlpha[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * D; i += NT) {
      int r = i / D, c = i % D;
      sO[r * L::LDT + c] *= sAlpha[r];
    }
    __syncthreads();
    mm_ab_acc(sO, L::LDT, sS, L::LDS, sV, L::LDT, R, D, R);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R; i += NT)
    if (q0 + i < a.S)
      a.lse[(long long)bh * a.S + q0 + i] = sM[i] + logf(fmaxf(sL[i], 1e-30f));
  // acc / l_safe, divided as the TPU kernel does
  for (int i = threadIdx.x; i < R * D; i += NT) {
    int r = i / D, c = i % D;
    sO[r * L::LDT + c] /= fmaxf(sL[r], 1e-30f);
  }
  __syncthreads();
  store_rows<D>(a.out, a, b, h, sO, L::LDT, q0);
}

// one (query tile, key tile) pair of the fp32 backward, in place:
// p = exp(s * scale - lse) into sS (0 where masked or the query is past
// S), ds = p * (dp - delta) * scale into sDP
template <int D>
__device__ void probs_and_grads(const Args& a, int b, int q0, int k0,
                                float* sS, float* sDP, const float* sLse,
                                const float* sDelta) {
  typedef Lay<D> L;
  constexpr int R = L::R;
  for (int i = threadIdx.x; i < R * R; i += NT) {
    int r = i / R, c = i % R;
    float p = 0.0f;
    if (q0 + r < a.S) {
      float x = sS[r * L::LDS + c] * a.scale;
      if (!visible(a, b, q0 + r, k0 + c)) x = NEG_INF;
      p = expf(x - sLse[r]);
    }
    sDP[r * L::LDS + c] = p * (sDP[r * L::LDS + c] - sDelta[r]) * a.scale;
    sS[r * L::LDS + c] = p;
  }
}

__device__ void load_stats(float* sLse, float* sDelta, const Args& a, int bh,
                           int q0) {
  for (int i = threadIdx.x; i < SIMT_R; i += NT) {
    bool ok = q0 + i < a.S;
    sLse[i] = ok ? a.lse_in[(long long)bh * a.S + q0 + i] : 0.0f;
    sDelta[i] = ok ? a.delta[(long long)bh * a.S + q0 + i] : 0.0f;
  }
}

// K2, fp32. Block = (32 keys, batch x head); loop over query tiles from
// the first that reaches the diagonal.
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_fp32(Args a) {
  typedef Lay<D> L;
  constexpr int R = L::R;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + R * L::LDT;
  float* sQ = sV + R * L::LDT;
  float* sDO = sQ + R * L::LDT;
  float* sDK = sDO + R * L::LDT;
  float* sDV = sDK + R * L::LDT;
  float* sS = sDV + R * L::LDT;
  float* sDP = sS + R * L::LDS;
  float* sLse = sDP + R * L::LDS;
  float* sDelta = sLse + R;

  const int n_tiles = (a.S + R - 1) / R;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * R;
  const float* gq = slice<float>(a.q, a.sq, b, h);
  const float* gdo = slice<float>(a.dout, a.sdo, b, h);

  load_tile<float, D>(sK, L::LDT, slice<float>(a.k, a.sk, b, h), a.sk[1], k0,
                      R, a.S);
  load_tile<float, D>(sV, L::LDT, slice<float>(a.v, a.sv, b, h), a.sv[1], k0,
                      R, a.S);
  for (int i = threadIdx.x; i < R * L::LDT; i += NT) {
    sDK[i] = 0.0f;
    sDV[i] = 0.0f;
  }
  const int first = a.causal ? k0 / R : 0;
  for (int qb = first; qb < n_tiles; ++qb) {
    const int q0 = qb * R;
    __syncthreads();
    load_tile<float, D>(sQ, L::LDT, gq, a.sq[1], q0, R, a.S);
    load_tile<float, D>(sDO, L::LDT, gdo, a.sdo[1], q0, R, a.S);
    load_stats(sLse, sDelta, a, bh, q0);
    __syncthreads();
    mm_abt(sS, L::LDS, sQ, L::LDT, sK, L::LDT, R, R, D);
    mm_abt(sDP, L::LDS, sDO, L::LDT, sV, L::LDT, R, R, D);
    __syncthreads();
    probs_and_grads<D>(a, b, q0, k0, sS, sDP, sLse, sDelta);
    __syncthreads();
    mm_atb_acc(sDV, L::LDT, sS, L::LDS, sDO, L::LDT, R, D, R);
    mm_atb_acc(sDK, L::LDT, sDP, L::LDS, sQ, L::LDT, R, D, R);
  }
  __syncthreads();
  store_rows<D>(a.dk, a, b, h, sDK, L::LDT, k0);
  store_rows<D>(a.dv, a, b, h, sDV, L::LDT, k0);
}

// K3, fp32. Block = (32 query rows, batch x head); loop over key tiles up
// to the diagonal.
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_fp32(Args a) {
  typedef Lay<D> L;
  constexpr int R = L::R;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = sQ + R * L::LDT;
  float* sK = sDO + R * L::LDT;
  float* sV = sK + R * L::LDT;
  float* sDQ = sV + R * L::LDT;
  float* sS = sDQ + R * L::LDT;
  float* sDP = sS + R * L::LDS;
  float* sLse = sDP + R * L::LDS;
  float* sDelta = sLse + R;

  const int n_tiles = (a.S + R - 1) / R;
  const int qi = a.causal ? n_tiles - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = qi * R;
  const float* gk = slice<float>(a.k, a.sk, b, h);
  const float* gv = slice<float>(a.v, a.sv, b, h);

  load_tile<float, D>(sQ, L::LDT, slice<float>(a.q, a.sq, b, h), a.sq[1], q0,
                      R, a.S);
  load_tile<float, D>(sDO, L::LDT, slice<float>(a.dout, a.sdo, b, h),
                      a.sdo[1], q0, R, a.S);
  load_stats(sLse, sDelta, a, bh, q0);
  for (int i = threadIdx.x; i < R * L::LDT; i += NT) sDQ[i] = 0.0f;
  const int last = a.causal ? min(n_tiles, (q0 + R - 1) / R + 1) : n_tiles;
  for (int kb = 0; kb < last; ++kb) {
    const int k0 = kb * R;
    __syncthreads();
    load_tile<float, D>(sK, L::LDT, gk, a.sk[1], k0, R, a.S);
    load_tile<float, D>(sV, L::LDT, gv, a.sv[1], k0, R, a.S);
    __syncthreads();
    mm_abt(sS, L::LDS, sQ, L::LDT, sK, L::LDT, R, R, D);
    mm_abt(sDP, L::LDS, sDO, L::LDT, sV, L::LDT, R, R, D);
    __syncthreads();
    probs_and_grads<D>(a, b, q0, k0, sS, sDP, sLse, sDelta);
    __syncthreads();
    mm_ab_acc(sDQ, L::LDT, sDP, L::LDS, sK, L::LDT, R, D, R);
  }
  __syncthreads();
  store_rows<D>(a.dq, a, b, h, sDQ, L::LDT, q0);
}

// ===========================================================================
// host side
// ===========================================================================

enum Which { FWD, DKDV, DQ };

template <typename Kernel>
static int launch(Kernel kernel, size_t smem, int rows_per_block,
                  const Args& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.S + rows_per_block - 1) / rows_per_block, a.B * a.H);
  kernel<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// a 4-D tensor map of [b, s, h, d] (strides st: batch, row, head, in
// elements) with boxes of 64 columns x rows of one (batch, head)
static bool bshd_map(CUtensorMap* m, const void* p, const long long* st,
                     const Args& a, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)a.H,
                              (cuuint64_t)a.S, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return encode_tiled(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, p, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
static int launch_fwd_wg(const Args& a, cudaStream_t stream) {
  typedef FwGeom<D> G;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wg<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap qm, km, vm;
  if (!bshd_map(&qm, a.q, a.sq, a, D, FW_ROWS) ||
      !bshd_map(&km, a.k, a.sk, a, D, G::BN) ||
      !bshd_map(&vm, a.v, a.sv, a, D, G::BN))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long items =
      (long long)((a.S + FW_ROWS - 1) / FW_ROWS) * a.B * a.H;
  if (items >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int grid = items < sms ? (int)items : sms;
  flash_fwd_wg<D><<<grid, FW_THREADS, G::SMEM, stream>>>(qm, km, vm, a);
  return (int)cudaGetLastError();
}

// K2 (dk, dv) or K3 (dq): the outputs are the wrapper's contiguous
// [b, s, h, d] tensors
template <int D>
static int launch_bwd_wg(Which w, const Args& a, cudaStream_t stream) {
  typedef BwGeom<D> G;
  const bool dq = w == DQ;
  const int smem = dq ? G::DQ_SMEM : G::KV_SMEM;
  cudaError_t e =
      dq ? cudaFuncSetAttribute(flash_bwd_dq_wg<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem)
         : cudaFuncSetAttribute(flash_bwd_dkdv_wg<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  if (e != cudaSuccess) return (int)e;
  // K3 stages Q and dO an item and streams K, V; K2 the other way round
  const int qrows = dq ? BW_ROWS : BW_TILE, krows = dq ? BW_TILE : BW_ROWS;
  const long long so[3] = {(long long)a.S * a.H * D, (long long)a.H * D, D};
  CUtensorMap qm, km, vm, dom, o1, o2;
  if (!bshd_map(&qm, a.q, a.sq, a, D, qrows) ||
      !bshd_map(&km, a.k, a.sk, a, D, krows) ||
      !bshd_map(&vm, a.v, a.sv, a, D, krows) ||
      !bshd_map(&dom, a.dout, a.sdo, a, D, qrows) ||
      !bshd_map(&o1, dq ? a.dq : a.dk, so, a, D, 64) ||
      (!dq && !bshd_map(&o2, a.dv, so, a, D, 64)))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long items =
      (long long)((a.S + BW_ROWS - 1) / BW_ROWS) * a.B * a.H;
  if (items >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int grid = items < sms ? (int)items : sms;
  if (dq)
    flash_bwd_dq_wg<D><<<grid, BW_THREADS, smem, stream>>>(qm, km, vm, dom,
                                                           o1, a);
  else
    flash_bwd_dkdv_wg<D><<<grid, BW_THREADS, smem, stream>>>(qm, km, vm, dom,
                                                             o1, o2, a);
  return (int)cudaGetLastError();
}

template <int D>
static int run_bf16(Which w, const Args& a, cudaStream_t stream) {
  return w == FWD ? launch_fwd_wg<D>(a, stream)
                  : launch_bwd_wg<D>(w, a, stream);
}

template <int D>
static int run_fp32(Which w, const Args& a, cudaStream_t stream) {
  typedef Lay<D> L;
  switch (w) {
    case FWD:
      return launch(flash_fwd_fp32<D>, 4 * L::T_TILE + L::S_TILE + 3 * L::VEC,
                    SIMT_R, a, stream);
    case DKDV:
      return launch(flash_bwd_dkdv_fp32<D>,
                    6 * L::T_TILE + 2 * L::S_TILE + 2 * L::VEC, SIMT_R, a,
                    stream);
    default:
      return launch(flash_bwd_dq_fp32<D>,
                    5 * L::T_TILE + 2 * L::S_TILE + 2 * L::VEC, SIMT_R, a,
                    stream);
  }
}

static int dispatch(Which w, const Args& a, int is_bf16, int D,
                    cudaStream_t stream) {
  if (a.S <= 0 || a.B * a.H <= 0) return 0;
  if (is_bf16) {
    if (D == 32) return run_bf16<32>(w, a, stream);
    if (D == 64) return run_bf16<64>(w, a, stream);
    if (D == 128) return run_bf16<128>(w, a, stream);
  } else {
    if (D == 32) return run_fp32<32>(w, a, stream);
    if (D == 64) return run_fp32<64>(w, a, stream);
    if (D == 128) return run_fp32<128>(w, a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

static void set_strides(Args& a, const long long* st, int n) {
  long long* dst[4] = {a.sq, a.sk, a.sv, a.sdo};
  for (int t = 0; t < n; ++t)
    for (int j = 0; j < 3; ++j) dst[t][j] = st[3 * t + j];
}

extern "C" {

int paddle_flash_fwd(const void* q, const void* k, const void* v,
                     const int* seg, void* out, float* lse,
                     const long long* strides, int is_bf16, int B, int S,
                     int H, int D, int causal, float scale, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.seg = seg; a.out = out; a.lse = lse;
  set_strides(a, strides, 3);
  a.B = B; a.S = S; a.H = H; a.causal = causal; a.scale = scale;
  return dispatch(FWD, a, is_bf16, D, (cudaStream_t)stream);
}

int paddle_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, const int* seg, void* dk,
                          void* dv, const long long* strides, int is_bf16,
                          int B, int S, int H, int D, int causal, float scale,
                          void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse; a.delta = delta;
  a.seg = seg; a.dk = dk; a.dv = dv;
  set_strides(a, strides, 4);
  a.B = B; a.S = S; a.H = H; a.causal = causal; a.scale = scale;
  return dispatch(DKDV, a, is_bf16, D, (cudaStream_t)stream);
}

int paddle_flash_bwd_dq(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, const int* seg, void* dq,
                        const long long* strides, int is_bf16, int B, int S,
                        int H, int D, int causal, float scale, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse; a.delta = delta;
  a.seg = seg; a.dq = dq;
  set_strides(a, strides, 4);
  a.B = B; a.S = S; a.H = H; a.causal = causal; a.scale = scale;
  return dispatch(DQ, a, is_bf16, D, (cudaStream_t)stream);
}

}  // extern "C"
