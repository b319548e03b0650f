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
// - The backward passes: one CUDA block (8 warps) per (row tile, batch x
//   head). The TPU's sequential grid axis becomes a loop inside the
//   block; nothing is carried between blocks, and neither backward pass
//   needs atomics, so results are deterministic. bf16 runs on the tensor
//   cores with mma.sync m16n8k16 (fp32 accumulate), FlashAttention-2
//   style: each warp owns 16 rows; scores, probabilities and the
//   accumulators stay in registers (the accumulator layout of mma.sync is
//   the A-operand layout of the next product, so p and ds feed it without
//   a trip through shared memory); only the streamed tiles go through
//   shared memory. Row tiles are 128 (16 per warp); the dQ pass streams
//   64-key tiles, the dK/dV pass 32-query tiles. At head_dim <= 64
//   registers are capped so two blocks share an SM and one's loads
//   overlap the other's products (K3 0.76 -> 0.48 ms at the training
//   shape, measured on one H100 80GB HBM3 at 700 W).
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
//   a unit inner stride; a ragged last tile is zero-filled on load and
//   masked (key >= s) so any length works. Causal grids skip the tiles
//   beyond the diagonal (and a warp skips a tile wholly beyond its rows);
//   the forward and dQ grids start with the longest tiles.
// - The backward passes load their tiles with plain 16-byte vector loads
//   between __syncthreads; wgmma and TMA there are later work.
//
// C interface (ctypes): each entry returns cudaGetLastError() after its
// launch; strides are int64 (batch, row, head) triples per input tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // bf16 typedef, mma16816, fragment loads
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
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulate)
// ===========================================================================

constexpr int TC_ROWS = 16 * NWARPS;  // rows per block, 16 per warp
constexpr int TC_KEYS = 64;           // key tile of the dQ pass
constexpr int TC_QROWS = 32;          // query tile of the dK/dV pass
constexpr int TC_PAD = 8;             // 16 bytes per shared row
// blocks per SM the register budget is cut for: two at head_dim <= 64
// (at most 128 registers a thread), one at 128, whose dK/dV
// accumulators alone take 128
#define TC_BLOCKS(D) ((D) <= 64 ? 2 : 1)

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

// K3, bf16. Block = (128 query rows, batch x head); warp w owns 16 rows
// and streams 64-key tiles up to the diagonal.
template <int D>
__global__ void __launch_bounds__(NT, TC_BLOCKS(D)) flash_bwd_dq_bf16(Args a) {
  constexpr int BM = TC_ROWS, BN = TC_KEYS, LD = D + TC_PAD;
  constexpr int NJ = BN / 8, ND = D / 8, KD = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + BM * LD;
  bf16* sK = sDO + BM * LD;
  bf16* sV = sK + BN * LD;

  const int n_q = (a.S + BM - 1) / BM, n_k = (a.S + BN - 1) / BN;
  const int qi = a.causal ? n_q - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = qi * BM, r0 = (threadIdx.x >> 5) * 16;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const bf16* gk = slice<bf16>(a.k, a.sk, b, h);
  const bf16* gv = slice<bf16>(a.v, a.sv, b, h);

  load_tile<bf16, D>(sQ, LD, slice<bf16>(a.q, a.sq, b, h), a.sq[1], q0, BM,
                     a.S);
  load_tile<bf16, D>(sDO, LD, slice<bf16>(a.dout, a.sdo, b, h), a.sdo[1], q0,
                     BM, a.S);
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = qrow[r] < a.S;
    lse[r] = ok ? a.lse_in[(long long)bh * a.S + qrow[r]] : 0.0f;
    delta[r] = ok ? a.delta[(long long)bh * a.S + qrow[r]] : 0.0f;
  }
  float dq[ND][4] = {};
  const int last = a.causal ? min(n_k, (q0 + BM - 1) / BN + 1) : n_k;
  for (int kb = 0; kb < last; ++kb) {
    const int k0 = kb * BN;
    __syncthreads();
    load_tile<bf16, D>(sK, LD, gk, a.sk[1], k0, BN, a.S);
    load_tile<bf16, D>(sV, LD, gv, a.sv[1], k0, BN, a.S);
    __syncthreads();
    if (a.causal && k0 > q0 + r0 + 15) continue;
    float s[NJ][4] = {}, dp[NJ][4] = {};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], da[4];
      frag_a(qa, sQ, LD, r0, kk * 16);
      frag_a(da, sDO, LD, r0, kk * 16);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t kf[2], vf[2];
        frag_bt(kf, sK, LD, j * 8, kk * 16);
        mma16816(s[j], qa, kf);
        frag_bt(vf, sV, LD, j * 8, kk * 16);
        mma16816(dp[j], da, vf);
      }
    }
    // p = exp(s * scale - lse); ds = p * (dp - delta) * scale, into s
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = 0.0f;
        if (qrow[r] < a.S) {
          float x = s[j][e] * a.scale;
          if (!visible(a, b, qrow[r], k0 + j * 8 + 2 * t + (e & 1)))
            x = NEG_INF;
          p = expf(x - lse[r]);
        }
        s[j][e] = p * (dp[j][e] - delta[r]) * a.scale;
      }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t dsa[4];
      acc_as_a(dsa, s, kk);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t kf[2];
        frag_b(kf, sK, LD, kk * 16, n * 8);
        mma16816(dq[n], dsa, kf);
      }
    }
  }
  store_acc<D>(a.dq, a, b, h, q0 + r0, dq);
}

// K2, bf16. Block = (128 keys, batch x head); warp w owns keys
// 16w..16w+15 and streams 32-query tiles from the diagonal. It computes
// the transposed products s^T = K Q^T and dp^T = V dO^T, so that p^T and
// ds^T are the A operands of dV += p^T dO and dK += ds^T Q.
template <int D>
__global__ void __launch_bounds__(NT, TC_BLOCKS(D)) flash_bwd_dkdv_bf16(Args a) {
  constexpr int BN = TC_ROWS, BQ = TC_QROWS, LD = D + TC_PAD;
  constexpr int NJ = BQ / 8, ND = D / 8, KD = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BN * LD;
  bf16* sQ = sV + BN * LD;
  bf16* sDO = sQ + BQ * LD;
  float* sLse = reinterpret_cast<float*>(sDO + BQ * LD);
  float* sDelta = sLse + BQ;

  const int n_q = (a.S + BQ - 1) / BQ;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * BN, r0 = (threadIdx.x >> 5) * 16;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int krow[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  const bf16* gq = slice<bf16>(a.q, a.sq, b, h);
  const bf16* gdo = slice<bf16>(a.dout, a.sdo, b, h);

  load_tile<bf16, D>(sK, LD, slice<bf16>(a.k, a.sk, b, h), a.sk[1], k0, BN,
                     a.S);
  load_tile<bf16, D>(sV, LD, slice<bf16>(a.v, a.sv, b, h), a.sv[1], k0, BN,
                     a.S);
  float dk[ND][4] = {}, dv[ND][4] = {};
  // causal: query tiles strictly before the diagonal see no key here
  const int first = a.causal ? k0 / BQ : 0;
  for (int qb = first; qb < n_q; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();
    load_tile<bf16, D>(sQ, LD, gq, a.sq[1], q0, BQ, a.S);
    load_tile<bf16, D>(sDO, LD, gdo, a.sdo[1], q0, BQ, a.S);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const bool ok = q0 + i < a.S;
      sLse[i] = ok ? a.lse_in[(long long)bh * a.S + q0 + i] : 0.0f;
      sDelta[i] = ok ? a.delta[(long long)bh * a.S + q0 + i] : 0.0f;
    }
    __syncthreads();
    // every query of the tile precedes this warp's keys: nothing to add
    if (a.causal && k0 + r0 > q0 + BQ - 1) continue;
    float st[NJ][4] = {}, dpt[NJ][4] = {};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      frag_a(ka, sK, LD, r0, kk * 16);
      frag_a(va, sV, LD, r0, kk * 16);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t qf[2], df[2];
        frag_bt(qf, sQ, LD, j * 8, kk * 16);
        mma16816(st[j], ka, qf);
        frag_bt(df, sDO, LD, j * 8, kk * 16);
        mma16816(dpt[j], va, df);
      }
    }
    // p^T into st, ds^T into dpt; a query past S contributes nothing
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1), qpos = q0 + c;
        float p = 0.0f;
        if (qpos < a.S) {
          float x = st[j][e] * a.scale;
          if (!visible(a, b, qpos, krow[e >> 1])) x = NEG_INF;
          p = expf(x - sLse[c]);
        }
        dpt[j][e] = p * (dpt[j][e] - sDelta[c]) * a.scale;
        st[j][e] = p;
      }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], dsa[4];
      acc_as_a(pa, st, kk);
      acc_as_a(dsa, dpt, kk);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t df[2], qf[2];
        frag_b(df, sDO, LD, kk * 16, n * 8);
        mma16816(dv[n], pa, df);
        frag_b(qf, sQ, LD, kk * 16, n * 8);
        mma16816(dk[n], dsa, qf);
      }
    }
  }
  store_acc<D>(a.dk, a, b, h, k0 + r0, dk);
  store_acc<D>(a.dv, a, b, h, k0 + r0, dv);
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

template <int D>
static int run_bf16(Which w, const Args& a, cudaStream_t stream) {
  constexpr size_t row = (D + TC_PAD) * sizeof(bf16);
  switch (w) {
    case FWD:
      return launch_fwd_wg<D>(a, stream);
    case DKDV:
      return launch(flash_bwd_dkdv_bf16<D>,
                    (2 * TC_ROWS + 2 * TC_QROWS) * row +
                        2 * TC_QROWS * sizeof(float),
                    TC_ROWS, a, stream);
    default:
      return launch(flash_bwd_dq_bf16<D>, (2 * TC_ROWS + 2 * TC_KEYS) * row,
                    TC_ROWS, a, stream);
  }
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
