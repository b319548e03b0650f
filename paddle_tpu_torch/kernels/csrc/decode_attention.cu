// Flash-decode attention for Hopper (sm_90a): split-K, GQA-native,
// per-row length masking, over a contiguous KV cache or a paged pool.
//
// Replaces the TPU kernels of paddle_tpu/pallas_kernels/decode_attention.py:
//   _flash_decode        (contiguous cache, body _decode_kernel -> _cell_partial)
//   _paged_flash_decode  (block-table pool, same body, table-resolved K/V)
// in their causal form, unquantized (K4, K6) and quantized (K5, K7: the
// body _decode_kernel_quant, whose prologue dequantizes int8/fp8 K/V).
//
// What it computes (the contract of _cell_partial and the XLA combine):
//   query row r = i * group + g of kv head h is query token i of head
//   h * group + g, at absolute position qpos = (len - q_len) + r / group,
//   with len = min(pos + q_len, max_len). Key kpos is visible iff
//   kpos <= qpos. Scores q.k * scale in fp32, masked scores -1e30,
//   running max / sum / accumulator in fp32, output in q's dtype in the
//   layout [B, q_len, H, D]. A row with no visible key returns zeros
//   (l is clamped at 1e-30 in the merge).
//
// What bounds it. Decode (q_len 1) does 2 flops per K/V element it
// reads, far below the ~295 flops/byte an H100 needs to be compute-bound,
// so the floor is reading each valid K/V byte once. A verify bundle (q_len
// 5-29, 8 rows) is still bound by bytes. A 256-token prefill chunk over a
// 2048-token cache does ~8 GFLOP on ~34 MB: near the operations line.
//
// What the design does about that:
//   - every block owns (KV split, query-row tile, batch
//     row, kv head) and loops over its split's keys inside the block, so
//     nothing is carried between blocks (a TPU grid ran its kv-block
//     axis in order; Hopper runs blocks in no order);
//   - the loop stops at the tile's last visible key, min(len, q_hi + 1):
//     blocks past a row's own length, and keys past the causal edge of a
//     prefill tile, are never read;
//   - K/V rows are read once per (row tile, kv head) and serve the kv
//     head's whole query group, so the GQA expansion never touches
//     device memory;
//   - four block bodies, chosen by the wrapper from q_len, the group,
//     q's dtype and the storage (decode_attention.py bundle_body):
//       flash_decode_rows (fp32 bundles of at most 8 rows, the
//         card-against-CPU parity path): four warps stream keys with the
//         head dimension split across lanes (coalesced row reads, no
//         staging);
//       flash_decode_qrows (the bf16 decode step, q_len 1, over bf16,
//         int8 or fp8 K/V): 16-byte rows, the narrow dequant without
//         division or conversion instructions, the next keys' bytes in
//         flight (see its note);
//       flash_decode_mma (every bf16 bundle of q_len >= 2: prefill chunks,
//         verify bundles, draft-tree levels): bf16 mma.sync m16n8k16 with
//         fp32 accumulate, K/V tiles in shared memory through a cp.async
//         ring (see its note below);
//       flash_decode_partial (fp32 bundles of more than 8 rows): plain
//         fp32 FMA from shared memory, the card-against-CPU parity path;
//   - each split writes an (o, m, l) partial; a second small launch
//     merges them with the log-sum-exp of decode_attention.py:505-509.
// wgmma and TMA are later work.
//
// Tree-speculative bundles (K8, the mask branch of _cell_partial,
// decode_attention.py:299-316): with an ancestor mask [B, q_len, q_len]
// (bytes, nonzero = visible), bundle node j sits at cache position
// (len - q_len) + j and key kpos is visible to query token i iff
// kpos < len - q_len (every committed position is an ancestor of every
// node) or mask[b, i, kpos - (len - q_len)] is set; keys past len stay
// masked. Each block holds the mask rows of its query tokens as bits in
// shared memory (at most 64 tokens x 256 bits in flash_decode_partial and
// flash_decode_mma, 8 x 8 in flash_decode_rows and flash_decode_qrows)
// and every storage path goes through the one visibility test, so the
// mask covers K6 and K7 alike. The masked bodies are separate
// instantiations (MASKED) of the paged kernels: the causal
// launch carries no extra operand. A masked block scans its split up to
// len (a general mask may reveal any bundle key); keys it adds past the
// causal edge are masked, contribute p = 0 and leave m, l and the
// accumulator bit for bit unchanged, so a causal mask reproduces the
// unmasked output exactly.
//
// Quantized caches (K5, K7): K/V are stored as int8 or fp8 e4m3 (the
// storage type S, beside the compute type T of q) with one f32 absmax
// scale per (token, kv head), indexed like a K/V row without the D
// factor. Each value is dequantized in the TPU prologue's order: widened
// to f32, times its scale, DIVIDED by the bound (127 or 448), then
// rounded to T (astype(q.dtype) at decode_attention.py:398/:400; a no-op
// for fp32). The fp32 SIMT bodies do that where they load a value;
// flash_decode_qrows in registers, once per value for all its rows;
// flash_decode_mma once per tile in shared memory, before the MMA. Only
// the narrow bytes and the scales cross device memory, about half of a
// bf16 cache's bytes at head_dim 128.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "div_bound.cuh"  // exact x / 127, x / 448 without a division
#include "mma_bf16.cuh"   // bf16 typedef, mma16816, fragment loads
#include "widen.cuh"      // narrow bytes to bf16 pairs, bf16x2 rounding

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int KB = 32;  // keys per shared-memory chunk: one per lane
constexpr float kNegInf = -1e30f;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* out) {
    out[0] = __uint_as_float(u.x);
    out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
  }
  __device__ static void store(float* dst, float x) { *dst = x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* dst, float x) {
    *dst = __float2bfloat16(x);
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int BYTES>
struct Raw;
template <>
struct Raw<2> {
  using type = unsigned short;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<16> {
  using type = uint4;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// the absmax bound of a narrow storage type (quantization/intx.py)
template <typename S>
__device__ __forceinline__ float kv_bound();
template <>
__device__ __forceinline__ float kv_bound<int8_t>() {
  return 127.f;
}
template <>
__device__ __forceinline__ float kv_bound<__nv_fp8_e4m3>() {
  return 448.f;
}

// E consecutive values at p (aligned to their size) as floats, one load.
template <typename T, int E>
__device__ __forceinline__ void load_vals(const T* p, float* out) {
  using R = typename Raw<sizeof(T) * E>::type;
  const R raw = *reinterpret_cast<const R*>(p);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < E; ++e) out[e] = to_f(v[e]);
}

// E consecutive K or V values of one cached row as floats. S == T: the
// values as stored. S narrow (int8 / fp8, fp32 queries only; bf16 queries
// take flash_decode_qrows or flash_decode_mma): the dequant prologue of
// _decode_kernel_quant, f32(q) * s / bound, with s the row's absmax scale.
template <typename S, typename T, int E>
__device__ __forceinline__ void load_kv(const S* p, float s, float* out) {
  if constexpr (std::is_same<S, T>::value) {
    load_vals<T, E>(p, out);
  } else {
    static_assert(std::is_same<T, float>::value, "narrow K/V: fp32 q");
    float raw[E];
    load_vals<S, E>(p, raw);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = raw[e] * s / kv_bound<S>();
  }
}

// Row index (in units of D elements) of key kpos of kv head kvh.
// Contiguous: [B, max_len, KV, D]. Paged: [num_blocks, bs, KV, D], the
// logical block resolved through bt [B, nb] with its column clamped to
// nb - 1 as generation._paged_flat_indices clamps it.
template <bool PAGED>
__device__ __forceinline__ long long kv_row(int b, int kpos, int kvh, int KV,
                                            int max_len, const int* bt,
                                            int bs, int nb) {
  if constexpr (PAGED) {
    const int lb = min(kpos / bs, nb - 1);
    const long long phys = bt[(long long)b * nb + lb];
    return (phys * bs + kpos % bs) * KV + kvh;
  } else {
    return ((long long)b * max_len + kpos) * KV + kvh;
  }
}

// words of mask bits per query token: MAX_PAGED_Q_LEN (256) / 32
constexpr int kMaskWords = 8;

// Is key kpos visible to the query token at absolute position
// qbase + i? Causal: kpos <= qbase + i. MASKED: every key before the
// bundle (kpos < qbase), and bundle node kpos - qbase where the token's
// mask bits (mrow, one bit per bundle node) say so.
template <bool MASKED>
__device__ __forceinline__ bool visible(int kpos, int qbase, int i,
                                        const uint32_t* mrow) {
  if constexpr (MASKED) {
    const int j = kpos - qbase;
    return j < 0 || ((mrow[j >> 5] >> (j & 31)) & 1u);
  } else {
    return kpos <= qbase + i;
  }
}

// The mask rows of query tokens t0 .. t0 + nt - 1 of batch row b as bits:
// bits[t * words_stride + w] holds nodes 32w .. 32w + 31 of token t0 + t.
__device__ __forceinline__ void load_mask_bits(const uint8_t* mask, int b,
                                               int q_len, int t0, int nt,
                                               int words_stride,
                                               uint32_t* bits, int tid) {
  const int words = (q_len + 31) / 32;
  for (int idx = tid; idx < nt * words; idx += kThreads) {
    const int t = idx / words;
    const int w = idx % words;
    const uint8_t* src =
        mask + ((long long)b * q_len + t0 + t) * q_len + w * 32;
    const int n = min(32, q_len - w * 32);
    uint32_t x = 0;
    for (int j = 0; j < n; ++j) x |= (src[j] != 0 ? 1u : 0u) << j;
    bits[t * words_stride + w] = x;
  }
}

// Nothing visible in a split: the skip partial of its nr rows at part (acc
// 0, m -1e30, l 0) contributes exact zeros to the merge.
template <int D>
__device__ __forceinline__ void write_skip_partial(float* o_part,
                                                   float* m_part,
                                                   float* l_part,
                                                   long long part, int nr,
                                                   int tid) {
  for (int idx = tid; idx < nr * D; idx += kThreads)
    o_part[part * D + idx] = 0.f;
  for (int r = tid; r < nr; r += kThreads) {
    m_part[part + r] = kNegInf;
    l_part[part + r] = 0.f;
  }
}

// The kWarps warps' (m, l, acc) of nr rows, staged in shared memory (row r
// of warp w at sM[w * RS + r], sL[w * RS + r], sAcc[(w * RS + r) * D + c]),
// merged into the split's partial at part. The caller syncs first.
template <int D, int RS>
__device__ __forceinline__ void merge_warps(const float* sM, const float* sL,
                                            const float* sAcc, float* o_part,
                                            float* m_part, float* l_part,
                                            long long part, int nr, int tid) {
  for (int idx = tid; idx < nr * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    float mt = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, sM[w * RS + r]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sM[w * RS + r] - mt);
      lt += sL[w * RS + r] * f;
      at += sAcc[(w * RS + r) * D + c] * f;
    }
    o_part[(part + r) * D + c] = at;
    if (c == 0) {
      m_part[part + r] = mt;
      l_part[part + r] = lt;
    }
  }
}

constexpr int ROWS = 64;  // query rows per block of flash_decode_partial
constexpr int PS = KB + 1;  // padded row of the probability tile

template <int D>
constexpr size_t partial_smem_bytes() {
  return sizeof(float) *
         (ROWS * (D + 1) + 2 * KB * (D + 1) + ROWS * PS + 3 * ROWS);
}

// One (split, row tile, batch row * KV + kv head) block: the online-
// softmax partial of up to ROWS query rows over the split's visible keys,
// 32 keys at a time through shared memory. Both products are register-
// tiled: a thread scores 4 rows x 4 keys and accumulates 8 rows x D/16
// columns, so each shared-memory read feeds several FMAs.
template <typename T, typename S, int D, bool PAGED, bool MASKED>
__global__ void __launch_bounds__(kThreads)
    flash_decode_partial(const T* __restrict__ q, const S* __restrict__ k,
                         const S* __restrict__ v,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int* __restrict__ pos,
                         const int* __restrict__ bt,
                         const uint8_t* __restrict__ mask,
                         float* __restrict__ o_part,
                         float* __restrict__ m_part,
                         float* __restrict__ l_part, int q_len, int H, int KV,
                         int max_len, int bs, int nb, int split_keys,
                         float scale) {
  constexpr int VN = Vec<T>::N;
  constexpr int DV = D / VN;  // 16-byte vectors per row
  constexpr int KS = D + 1;   // padded smem row: conflict-free across lanes
  // scores: 4 rows x KT keys per thread; KG lanes share one row group
  constexpr int KT = ROWS * KB / (kThreads * 4);
  constexpr int KG = KB / KT;
  // accumulator: RA rows x CA columns per thread (columns strided by CG)
  constexpr int CG = 16;
  constexpr int RA = ROWS * CG / kThreads;
  constexpr int CA = D / CG;
  static_assert(KG <= 32 && 32 % KG == 0, "a row group lives in one warp");
  static_assert(RA * (kThreads / CG) == ROWS, "accumulator tiling");

  extern __shared__ float smem[];
  float* sQ = smem;              // [ROWS][KS]
  float* sK = sQ + ROWS * KS;    // [KB][KS]
  float* sV = sK + KB * KS;      // [KB][KS]
  float* sP = sV + KB * KS;      // [ROWS][PS] this chunk's probabilities
  float* sM = sP + ROWS * PS;    // [ROWS] running max
  float* sL = sM + ROWS;         // [ROWS] running sum
  float* sA = sL + ROWS;         // [ROWS] this chunk's rescale factor
  // MASKED: the mask bits of the tile's query tokens (at most ROWS)
  __shared__ uint32_t sMask[MASKED ? ROWS * kMaskWords : 1];

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int row0 = blockIdx.y * ROWS;
  const int bk = blockIdx.z;
  const int b = bk / KV;
  const int kvh = bk % KV;
  const int group = H / KV;
  const int gq = q_len * group;
  const int nr = min(ROWS, gq - row0);
  const int len = min(pos[b] + q_len, max_len);
  const int qbase = len - q_len;  // absolute position of bundle token 0
  const int q_hi = qbase + (row0 + nr - 1) / group;
  const int t0 = row0 / group;  // the tile's first query token
  const int k_begin = split * split_keys;
  // the tile's last visible key: its last token's causal edge, or (with
  // a mask, which may reveal any bundle node) the row's length
  const int k_end = MASKED ? min(k_begin + split_keys, len)
                           : min(min(k_begin + split_keys, len), q_hi + 1);
  const long long part = ((long long)bk * n_split + split) * gq + row0;

  if (k_begin >= k_end) {
    write_skip_partial<D>(o_part, m_part, l_part, part, nr, tid);
    return;
  }

  for (int idx = tid; idx < ROWS * DV; idx += kThreads) {
    const int r = idx / DV;
    const int c = (idx % DV) * VN;
    float f[VN];
    if (r < nr) {
      const int row = row0 + r;
      const int i = row / group;
      const int g = row % group;
      const T* src = q + (((long long)b * q_len + i) * H + kvh * group + g) * D + c;
      Vec<T>::unpack(*reinterpret_cast<const uint4*>(src), f);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) sQ[r * KS + c + e] = f[e];
  }
  for (int r = tid; r < ROWS; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }
  if constexpr (MASKED)  // read after the chunk loop's first barrier
    load_mask_bits(mask, b, q_len, t0, (row0 + nr - 1) / group - t0 + 1,
                   kMaskWords, sMask, tid);

  const int rg = tid / KG;  // score tile: rows rg*4 .. rg*4+3
  const int kg = tid % KG;  //             keys kg + KG*w
  const int ra = tid / CG;  // accumulator tile: rows ra*RA ..
  const int cg = tid % CG;  //                   columns cg + CG*e
  float acc[RA][CA];
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int e = 0; e < CA; ++e) acc[i][e] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += KB) {
    const int kbv = min(KB, k_end - kc);
    __syncthreads();  // previous chunk's readers are done with sK/sV/sP

    for (int idx = tid; idx < KB * DV; idx += kThreads) {
      const int j = idx / DV;
      const int c = (idx % DV) * VN;
      float fk[VN], fv[VN];
      if (j < kbv) {
        const long long row =
            kv_row<PAGED>(b, kc + j, kvh, KV, max_len, bt, bs, nb);
        const long long off = row * D + c;
        float sk = 1.f, sv = 1.f;
        if constexpr (!std::is_same<S, T>::value) {
          sk = ks[row];
          sv = vs[row];
        }
        load_kv<S, T, VN>(k + off, sk, fk);
        load_kv<S, T, VN>(v + off, sv, fv);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) fk[e] = fv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        sK[j * KS + c + e] = fk[e];
        sV[j * KS + c + e] = fv[e];
      }
    }
    __syncthreads();

    // scores of this thread's 4 x KT tile
    float s[4][KT];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < KT; ++w) s[u][w] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qx[4], kx[KT];
#pragma unroll
      for (int u = 0; u < 4; ++u) qx[u] = sQ[(rg * 4 + u) * KS + c];
#pragma unroll
      for (int w = 0; w < KT; ++w) kx[w] = sK[(kg + KG * w) * KS + c];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < KT; ++w) s[u][w] = fmaf(qx[u], kx[w], s[u][w]);
    }
    // online softmax per row, reduced over the KG lanes of the row group
    // (every lane takes part in the shuffles; rows past nr stay masked)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = rg * 4 + u;
      const int ti = (row0 + r) / group;  // the row's query token
      const uint32_t* mrow = sMask + (MASKED ? (ti - t0) * kMaskWords : 0);
      bool vis[KT];
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < KT; ++w) {
        const int j = kg + KG * w;
        vis[w] = r < nr && j < kbv &&
                 visible<MASKED>(kc + j, qbase, ti, mrow);
        s[u][w] = vis[w] ? s[u][w] * scale : kNegInf;
        mx = fmaxf(mx, s[u][w]);
      }
#pragma unroll
      for (int o = KG / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float ps = 0.f;
#pragma unroll
      for (int w = 0; w < KT; ++w) {
        const float p = vis[w] ? expf(s[u][w] - m_new) : 0.f;
        sP[r * PS + kg + KG * w] = p;
        ps += p;
      }
#pragma unroll
      for (int o = KG / 2; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      __syncwarp();
      if (kg == 0) {
        const float alpha = expf(m_old - m_new);
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + ps;
        sA[r] = alpha;
      }
    }
    __syncthreads();

    // rescale and accumulate this thread's RA x CA tile of P @ V
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const float a = sA[ra * RA + i];
#pragma unroll
      for (int e = 0; e < CA; ++e) acc[i][e] *= a;
    }
    for (int j = 0; j < kbv; ++j) {
      float px[RA], vx[CA];
#pragma unroll
      for (int i = 0; i < RA; ++i) px[i] = sP[(ra * RA + i) * PS + j];
#pragma unroll
      for (int e = 0; e < CA; ++e) vx[e] = sV[j * KS + cg + CG * e];
#pragma unroll
      for (int i = 0; i < RA; ++i)
#pragma unroll
        for (int e = 0; e < CA; ++e) acc[i][e] = fmaf(px[i], vx[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < RA; ++i) {
    const int r = ra * RA + i;
    if (r < nr) {
#pragma unroll
      for (int e = 0; e < CA; ++e)
        o_part[(part + r) * D + cg + CG * e] = acc[i][e];
    }
  }
  for (int r = tid; r < nr; r += kThreads) {
    m_part[part + r] = sM[r];
    l_part[part + r] = sL[r];
  }
}

// Decode variant for bundles of at most SR query rows per kv head (the
// decode step: q_len 1 times the group; bf16 queries over bf16 K/V, or
// fp32 queries over any storage). One block of four warps per
// (split, b * KV + kvh). Each warp streams its own share of the split's
// keys, U at a time; its lanes split the head dimension (D / 32 values
// each), so a K or V row is one coalesced read per warp and is never
// staged in shared memory, and every warp works even for one query row.
// The four warps' (m, l, acc) merge through shared memory into the same
// partial layout as flash_decode_partial.
template <typename T, typename S, int D, int SR, bool PAGED, bool MASKED>
__global__ void __launch_bounds__(kThreads)
    flash_decode_rows(const T* __restrict__ q, const S* __restrict__ k,
                      const S* __restrict__ v, const float* __restrict__ ks,
                      const float* __restrict__ vs,
                      const int* __restrict__ pos,
                      const int* __restrict__ bt,
                      const uint8_t* __restrict__ mask,
                      float* __restrict__ o_part,
                      float* __restrict__ m_part, float* __restrict__ l_part,
                      int q_len, int H, int KV, int max_len, int bs, int nb,
                      int split_keys, float scale) {
  constexpr int E = D / 32;             // values per lane
  constexpr int U = SR <= 2 ? 8 : 4;    // keys in flight per warp step
  __shared__ float sM[kWarps][SR];
  __shared__ float sL[kWarps][SR];
  __shared__ float sAcc[kWarps][SR][D];
  // MASKED: one word of mask bits per query token (q_len <= SR <= 8)
  __shared__ uint32_t sMask[MASKED ? SR : 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int bk = blockIdx.z;
  const int b = bk / KV;
  const int kvh = bk % KV;
  const int group = H / KV;
  const int gq = q_len * group;  // <= SR
  const int len = min(pos[b] + q_len, max_len);
  const int qbase = len - q_len;
  const int q_hi = qbase + (gq - 1) / group;
  const int k_begin = split * split_keys;
  const int k_end = MASKED ? min(k_begin + split_keys, len)
                           : min(min(k_begin + split_keys, len), q_hi + 1);
  const long long part = ((long long)bk * n_split + split) * gq;

  if (k_begin >= k_end) {
    write_skip_partial<D>(o_part, m_part, l_part, part, gq, tid);
    return;
  }

  if constexpr (MASKED) {
    load_mask_bits(mask, b, q_len, 0, q_len, 1, sMask, tid);
    __syncthreads();
  }

  float qv[SR][E], acc[SR][E], m[SR], l[SR];
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) qv[r][e] = acc[r][e] = 0.f;
    if (r < gq) {
      const int i = r / group;
      const int g = r % group;
      load_vals<T, E>(
          q + (((long long)b * q_len + i) * H + kvh * group + g) * D + lane * E,
          qv[r]);
    }
  }

  for (int kc = k_begin + warp * U; kc < k_end; kc += kWarps * U) {
    float kx[U][E], vx[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (kc + u < k_end) {
        const long long row =
            kv_row<PAGED>(b, kc + u, kvh, KV, max_len, bt, bs, nb);
        const long long off = row * D + lane * E;
        float sk = 1.f, sv = 1.f;
        if constexpr (!std::is_same<S, T>::value) {
          sk = ks[row];
          sv = vs[row];
        }
        load_kv<S, T, E>(k + off, sk, kx[u]);
        load_kv<S, T, E>(v + off, sv, vx[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kx[u][e] = vx[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < SR; ++r) {
      if (r < gq) {
        const int ti = r / group;  // the row's query token
        const uint32_t* mrow = sMask + (MASKED ? ti : 0);
        float sc[U];
        float mx = m[r];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qv[r][e], kx[u][e], dot);
          dot = warp_sum(dot);
          const bool vis = kc + u < k_end &&
                           visible<MASKED>(kc + u, qbase, ti, mrow);
          sc[u] = vis ? dot * scale : kNegInf;
          mx = fmaxf(mx, sc[u]);
        }
        const float alpha = expf(m[r] - mx);
        float ps = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bool vis = kc + u < k_end &&
                           visible<MASKED>(kc + u, qbase, ti, mrow);
          sc[u] = vis ? expf(sc[u] - mx) : 0.f;
          ps += sc[u];
        }
        l[r] = l[r] * alpha + ps;
        m[r] = mx;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float a = acc[r][e] * alpha;
#pragma unroll
          for (int u = 0; u < U; ++u) a = fmaf(sc[u], vx[u][e], a);
          acc[r][e] = a;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < SR; ++r) {
    if (r < gq) {
      if (lane == 0) {
        sM[warp][r] = m[r];
        sL[warp][r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sAcc[warp][r][lane * E + e] = acc[r][e];
    }
  }
  __syncthreads();
  merge_warps<D, SR>(&sM[0][0], &sL[0][0], &sAcc[0][0][0], o_part, m_part,
                     l_part, part, gq, tid);
}

// Log-sum-exp merge of the splits' partials for one (row, b * KV + kvh),
// written in q's dtype at [b, i, kvh * group + g, :].
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_decode_merge(const float* __restrict__ o_part,
                       const float* __restrict__ m_part,
                       const float* __restrict__ l_part, T* __restrict__ out,
                       int q_len, int H, int KV, int n_split) {
  const int group = H / KV;
  const int gq = q_len * group;
  const int row = blockIdx.x;
  const int bk = blockIdx.y;
  const int b = bk / KV;
  const int kvh = bk % KV;
  const int i = row / group;
  const int g = row % group;
  float m_tot = kNegInf;
  for (int s = 0; s < n_split; ++s)
    m_tot = fmaxf(m_tot, m_part[((long long)bk * n_split + s) * gq + row]);
  T* dst = out + (((long long)b * q_len + i) * H + kvh * group + g) * D;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const long long idx = ((long long)bk * n_split + s) * gq + row;
      const float w = expf(m_part[idx] - m_tot);
      l += l_part[idx] * w;
      a += o_part[idx * D + c] * w;
    }
    Vec<T>::store(dst + c, a / fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bf16 bundles on the tensor cores
// ---------------------------------------------------------------------------
//
// flash_decode_mma: every bf16 bundle of q_len >= 2 (prefill chunks,
// verify bundles, draft-tree levels; K4-K8 at those shapes). It replaces
// the body _cell_partial (decode_attention.py:274) of _flash_decode (:491)
// and _paged_flash_decode (:685), which runs both products on the TPU's
// matrix unit in the input dtype: q.k^T with an f32 result, then
// p.astype(v.dtype) . v (:319). So does this body: bf16 mma.sync m16n8k16
// with fp32 accumulate, p rounded to bf16 before P.V, and m, l and the
// rescale in fp32 (the FlashAttention-2 arrangement of flash_attention.cu:
// scores, probabilities and accumulators stay in registers).
//
// What bounds it: a 256-token prefill chunk over a long cache sits near
// the operations line; a verify bundle (5-29 rows) is bound by bytes.
// What the design does about that:
//   - each warp owns 16 query rows. A wide bundle (more than 16 rows: a
//     chunk, a [4,2,2] tree, a grouped bundle) gives each of the block's
//     four warps its own 16 rows and every warp walks the same key tiles,
//     so a K/V tile read from device memory serves 64 rows. A small
//     bundle (at most 16 rows) takes one 16-row tile and the four warps
//     split each key tile between them (16 keys each), then merge their
//     (m, l, acc) through shared memory: four warps still stream its keys;
//   - K/V arrive in 64-key tiles of bf16 rows in shared memory, gathered
//     row by row through the block table (kv_row) with 16-byte cp.async
//     copies into a two-stage ring: the next tile's loads are in flight
//     while this tile's products run;
//   - int8/fp8 storage: the ring holds the narrow bytes and their f32
//     scales; each tile is dequantized once into a bf16 tile before the
//     MMA, in the prologue's order (f32, times the scale, divided by the
//     bound, rounded to bf16), and that work is shared by every row. The
//     dequant, not the MMA, bounds the narrow bundles, and IEEE
//     division's per-value check and branch dominated it: the division
//     is div_bound's exact fma form, picked once a tile by a vote over
//     the tile's scales;
//   - keys past a split's end or a row's length arrive as zeros (cp.async
//     zero fill) and are masked; a warp skips a key tile that lies wholly
//     past its rows' causal edge unless MASKED. Keys that a MASKED block
//     scans beyond the causal edge are invisible: p = 0 and alpha =
//     exp(0) = 1 leave m, l and acc bit for bit unchanged, so a causal
//     mask gives the maskless output exactly.

constexpr int MMA_KEYS = 64;  // keys per K/V tile
constexpr int MMA_PAD = 8;    // bf16 row pad: 16 bytes, conflict-free fragments
// rows per block of a wide bundle: four warps of 16. An eight-warp tile
// (128 rows) halves a 256-row chunk's K/V re-reads but measured no faster
// there in bf16 and slower on a 29-row bundle, six of its warps idle; one
// tile size keeps one instantiation (PERF.md, the kernel table).
constexpr int MMA_ROWS = 16 * kWarps;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of flash_decode_mma: bf16 storage keeps a two-stage ring
// of bf16 K and V tiles; narrow storage a two-stage ring of the narrow
// tiles and their scales, and one bf16 K/V pair the dequant writes. A
// small bundle's final merge reuses the bf16 tiles.
template <typename S, int D>
struct MmaSmem {
  static constexpr bool kQuant = !std::is_same<S, bf16>::value;
  static constexpr int LD = D + MMA_PAD;     // bf16 tile row
  static constexpr int TILE = MMA_KEYS * LD;  // bf16 elements of one tile
  static constexpr size_t kBf16Bytes = (kQuant ? 2 : 4) * TILE * sizeof(bf16);
  static constexpr size_t kNarrowBytes =
      kQuant ? 2 * 2 * MMA_KEYS * D * sizeof(S) : 0;
  static constexpr size_t kScaleBytes =
      kQuant ? 2 * 2 * MMA_KEYS * sizeof(float) : 0;
  static constexpr size_t bytes = kBf16Bytes + kNarrowBytes + kScaleBytes;
  // the small bundle's merge: (acc, m, l) of four warps x 16 rows
  static_assert((size_t)kWarps * 16 * (D + 2) * sizeof(float) <= kBf16Bytes,
                "merge buffer fits the tiles");
};

// One (split, row tile, batch row * KV + kv head) block of four warps.
// With SMALL, one 16-row tile whose key tiles the warps split; else
// MMA_ROWS rows, 16 a warp. It writes the (o, m, l) partial of
// flash_decode_partial for flash_decode_merge.
template <typename S, int D, bool PAGED, bool MASKED, bool SMALL>
__global__ void __launch_bounds__(kThreads)
    flash_decode_mma(const bf16* __restrict__ q, const S* __restrict__ k,
                     const S* __restrict__ v, const float* __restrict__ ks,
                     const float* __restrict__ vs,
                     const int* __restrict__ pos, const int* __restrict__ bt,
                     const uint8_t* __restrict__ mask,
                     float* __restrict__ o_part, float* __restrict__ m_part,
                     float* __restrict__ l_part, int q_len, int H, int KV,
                     int max_len, int bs, int nb, int split_keys,
                     float scale) {
  using L = MmaSmem<S, D>;
  constexpr int NT = kThreads;
  constexpr int NW = kWarps;
  constexpr int LD = L::LD;
  constexpr int KD = D / 16;   // k-steps of q.k
  constexpr int ND = D / 8;    // n-tiles of the accumulator
  constexpr int KW = SMALL ? MMA_KEYS / NW : MMA_KEYS;  // a warp's keys a tile
  constexpr int NJ = KW / 8;   // n-tiles of the scores
  constexpr int ROWS = SMALL ? 16 : MMA_ROWS;
  static_assert(KW % 16 == 0 && NJ * 4 <= 32, "score tiling");

  extern __shared__ __align__(128) unsigned char mma_smem[];
  bf16* sKV = reinterpret_cast<bf16*>(mma_smem);
  S* sNarrow = reinterpret_cast<S*>(mma_smem + L::kBf16Bytes);
  float* sScale =
      reinterpret_cast<float*>(mma_smem + L::kBf16Bytes + L::kNarrowBytes);
  // MASKED: the mask bits of the tile's query tokens (at most ROWS)
  __shared__ uint32_t sMask[MASKED ? ROWS * kMaskWords : 1];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int row0 = blockIdx.y * ROWS;
  const int bk = blockIdx.z;
  const int b = bk / KV;
  const int kvh = bk % KV;
  const int group = H / KV;
  const int gq = q_len * group;
  const int nr = min(ROWS, gq - row0);
  const int len = min(pos[b] + q_len, max_len);
  const int qbase = len - q_len;  // absolute position of bundle token 0
  const int q_hi = qbase + (row0 + nr - 1) / group;
  const int t0 = row0 / group;  // the tile's first query token
  const int k_begin = split * split_keys;
  const int k_end = MASKED ? min(k_begin + split_keys, len)
                           : min(min(k_begin + split_keys, len), q_hi + 1);
  const long long part = ((long long)bk * n_split + split) * gq + row0;
  // row r (of the tile) as [b, i, kvh * group + g, :] of q
  auto row_off = [&](int r) {
    const int row = row0 + r;
    return (((long long)b * q_len + row / group) * H + kvh * group +
            row % group) * D;
  };

  if (k_begin >= k_end) {
    write_skip_partial<D>(o_part, m_part, l_part, part, nr, tid);
    return;
  }
  if constexpr (MASKED)  // read after the tile loop's first barrier
    load_mask_bits(mask, b, q_len, t0, (row0 + nr - 1) / group - t0 + 1,
                   kMaskWords, sMask, tid);

  // this warp's rows (relative to the tile) and its keys within a tile
  const int wr0 = SMALL ? 0 : warp * 16;
  const int wk0 = SMALL ? warp * KW : 0;
  const int w_rows = min(16, nr - wr0);  // <= 0: a warp past the bundle
  const int w_hi = qbase + (row0 + wr0 + max(w_rows, 1) - 1) / group;
  bool rok[2];
  int ti[2];
  const uint32_t* mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = wr0 + g + 8 * r;
    rok[r] = rr < nr;
    ti[r] = (row0 + rr) / group;
    mrow[r] = sMask + (MASKED && rok[r] ? (ti[r] - t0) * kMaskWords : 0);
  }

  // q as A fragments, straight from device memory (read once)
  uint32_t qa[KD][4];
  {
    const bf16* qr[2] = {q + (rok[0] ? row_off(wr0 + g) : 0),
                         q + (rok[1] ? row_off(wr0 + g + 8) : 0)};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = rok[0] ? __ldg(reinterpret_cast<const unsigned*>(qr[0] + c)) : 0u;
      qa[kk][1] = rok[1] ? __ldg(reinterpret_cast<const unsigned*>(qr[1] + c)) : 0u;
      qa[kk][2] = rok[0] ? __ldg(reinterpret_cast<const unsigned*>(qr[0] + c + 8)) : 0u;
      qa[kk][3] = rok[1] ? __ldg(reinterpret_cast<const unsigned*>(qr[1] + c + 8)) : 0u;
    }
  }

  // issue the cp.async copies of key tile `it` into ring stage `stage`
  auto load_tile = [&](int it, int stage) {
    constexpr int EPC = 16 / sizeof(S);  // elements per 16-byte copy
    constexpr int CPR = D / EPC;         // copies per row
    const int k0 = k_begin + it * MMA_KEYS;
    const int kv = min(MMA_KEYS, k_end - k0);
    S* dK;
    int ld;
    if constexpr (L::kQuant) {
      dK = sNarrow + stage * 2 * MMA_KEYS * D;
      ld = D;
    } else {
      dK = reinterpret_cast<S*>(sKV) + stage * 2 * L::TILE;
      ld = LD;
    }
    S* dV = dK + MMA_KEYS * ld;
    for (int idx = tid; idx < MMA_KEYS * CPR; idx += NT) {
      const int j = idx / CPR;
      const int c = (idx % CPR) * EPC;
      const bool ok = j < kv;
      const long long row =
          ok ? kv_row<PAGED>(b, k0 + j, kvh, KV, max_len, bt, bs, nb) : 0;
      cp_async16(dK + j * ld + c, k + row * D + c, ok);
      cp_async16(dV + j * ld + c, v + row * D + c, ok);
    }
    if constexpr (L::kQuant) {
      float* dS = sScale + stage * 2 * MMA_KEYS;
      for (int j = tid; j < MMA_KEYS; j += NT) {
        const bool ok = j < kv;
        const long long row =
            ok ? kv_row<PAGED>(b, k0 + j, kvh, KV, max_len, bt, bs, nb) : 0;
        cp_async4(dS + j, ks + row, ok);
        cp_async4(dS + MMA_KEYS + j, vs + row, ok);
      }
    }
    cp_async_commit();
  };

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int n_tiles = (k_end - k_begin + MMA_KEYS - 1) / MMA_KEYS;
  load_tile(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(it + 1, stage ^ 1);  // its stage was freed by the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tK;
    if constexpr (L::kQuant) {
      // dequantize this stage into the bf16 pair once for all rows:
      // f32(q) * s / bound, the prologue's order. One vote over the tile's
      // 128 scales (one a thread) picks the exact fma division, branch
      // free; a scale outside its range (never a real absmax) takes the
      // IEEE division value by value.
      const S* nK = sNarrow + stage * 2 * MMA_KEYS * D;
      const float* sc = sScale + stage * 2 * MMA_KEYS;
      static_assert(2 * MMA_KEYS == NT, "one scale a thread");
      if (__syncthreads_and(exact_scale(sc[tid]))) {
        for (int idx = tid; idx < 2 * MMA_KEYS * (D / 8); idx += NT) {
          const int j = idx / (D / 8);  // 0 .. 127: K rows, then V rows
          const int c = (idx % (D / 8)) * 8;
          float f[8];
          load_vals<S, 8>(nK + j * D + c, f);
          const float s = sc[j];
          uint4 w;
          w.x = pack2f(div_bound<S>(__fmul_rn(f[0], s)),
                       div_bound<S>(__fmul_rn(f[1], s)));
          w.y = pack2f(div_bound<S>(__fmul_rn(f[2], s)),
                       div_bound<S>(__fmul_rn(f[3], s)));
          w.z = pack2f(div_bound<S>(__fmul_rn(f[4], s)),
                       div_bound<S>(__fmul_rn(f[5], s)));
          w.w = pack2f(div_bound<S>(__fmul_rn(f[6], s)),
                       div_bound<S>(__fmul_rn(f[7], s)));
          *reinterpret_cast<uint4*>(sKV + j * LD + c) = w;
        }
      } else {
        for (int idx = tid; idx < 2 * MMA_KEYS * D; idx += NT) {
          const int j = idx / D;
          const int c = idx % D;
          sKV[j * LD + c] =
              __float2bfloat16(to_f(nK[j * D + c]) * sc[j] / kv_bound<S>());
        }
      }
      __syncthreads();
      tK = sKV;
    } else {
      tK = sKV + stage * 2 * L::TILE;
    }
    const bf16* tV = tK + L::TILE;
    const int kw = k_begin + it * MMA_KEYS + wk0;  // this warp's first key
    // nothing to add: no rows, keys wholly past the split, or (causal)
    // wholly past the warp's last row
    if (w_rows > 0 && kw < k_end && (MASKED || kw <= w_hi)) {
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t kf[2];
          frag_bt(kf, tK, LD, wk0 + j * 8, kk * 16);
          mma16816(s[j], qa[kk], kf);
        }
      // online softmax for rows g and g + 8
      uint32_t vis = 0;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int kpos = kw + j * 8 + 2 * t + (e & 1);
          const bool ok = rok[r] && kpos < k_end &&
                          visible<MASKED>(kpos, qbase, ti[r], mrow[r]);
          const float x = ok ? s[j][e] * scale : kNegInf;
          s[j][e] = x;
          vis |= (ok ? 1u : 0u) << (j * 4 + e);
          mx[r] = fmaxf(mx[r], x);
        }
      float m_new[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = expf(m[r] - m_new[r]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              (vis >> (j * 4 + e)) & 1u ? expf(s[j][e] - m_new[e >> 1]) : 0.f;
          s[j][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
        m[r] = m_new[r];
      }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
      // P . V with p rounded to bf16, as _cell_partial does
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        uint32_t pa[4];
        acc_as_a(pa, s, kk);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t vf[2];
          frag_b(vf, tV, LD, wk0 + kk * 16, n * 8);
          mma16816(o[n], pa, vf);
        }
      }
    }
    __syncthreads();  // this stage's readers are done
  }

  if constexpr (!SMALL) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = wr0 + g + 8 * r;
      if (!rok[r]) continue;
      float2* dst = reinterpret_cast<float2*>(o_part + (part + rr) * D + 2 * t);
#pragma unroll
      for (int n = 0; n < ND; ++n)
        dst[n * 4] = make_float2(o[n][2 * r], o[n][2 * r + 1]);
      if (t == 0) {
        m_part[part + rr] = m[r];
        l_part[part + rr] = l[r];
      }
    }
  } else {
    // merge the four warps' (m, l, acc) of the 16 rows (the ring is free:
    // the loop ended on a barrier)
    float* sAcc = reinterpret_cast<float*>(mma_smem);  // [NW][16][D]
    float* sM = sAcc + NW * 16 * D;                    // [NW][16]
    float* sL = sM + NW * 16;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = g + 8 * r;
      if (t == 0) {
        sM[warp * 16 + rr] = m[r];
        sL[warp * 16 + rr] = l[r];
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        sAcc[(warp * 16 + rr) * D + n * 8 + 2 * t] = o[n][2 * r];
        sAcc[(warp * 16 + rr) * D + n * 8 + 2 * t + 1] = o[n][2 * r + 1];
      }
    }
    __syncthreads();
    merge_warps<D, 16>(sM, sL, sAcc, o_part, m_part, l_part, part, nr, tid);
  }
}

// ---------------------------------------------------------------------------
// The bf16 decode step over int8/fp8 K/V
// ---------------------------------------------------------------------------
//
// flash_decode_qrows: bf16 queries over bf16 K/V, or over int8 or fp8
// e4m3 K/V with their per-(token, kv head) f32 scales, q_len 1 and at most
// SR <= 8 rows (the GQA group; a MASKED bundle of at most SR tokens
// alike): the decode step of K4/K6 and of K5/K7. It replaces the bodies
// _decode_kernel (decode_attention.py:336) and _decode_kernel_quant
// (:371) of _flash_decode (:491) and _paged_flash_decode (:685) at that
// shape: the quantized prologue widens each K/V value to f32, multiplies
// it by its row's scale, divides by the bound and rounds to q's dtype;
// _cell_partial then scores and accumulates in f32 (bf16 storage: the
// values as stored).
//
// What bounds it: bytes. Each K/V byte (and, narrow, 8 bytes of scales a
// key and kv head) is read once for 2 flops a row (1 a byte in bf16), far
// below the card's operations line; but the exact dequant takes
// instructions of its own (about nine a narrow value here), which puts
// the issue rate close to the byte bound too, and the SIMT rows body it
// replaces spent 15x its bound there (IEEE division and conversion
// instructions, 4-byte loads, nothing in flight while it computed); over
// bf16 K/V that body spent 3.6x (8-byte loads, a 5-shuffle reduction a
// key and row, nothing in flight). What the design does about that:
//   - no conversion or division unit in the dequant: narrow4_f32 widens
//     the bytes to f32 (int8: a byte permute under 2^23's exponent and one
//     subtraction; e4m3: widen2's bf16 pairs and a shift), __fmul_rn
//     applies the scale, div_bound divides exactly in a multiply and an
//     fma, cvt.rn.bf16x2 rounds two values at once and a shift widens
//     them back: the values equal unpack_absmax's to the bit. A warp votes
//     once a step over its keys' scales (exact_scale); a scale outside
//     div_bound's range takes the IEEE division value by value;
//   - 16-byte rows: a lane loads C values of a key (C 16; 8 at SR 4 and 4
//     at SR 8, so q and the accumulators stay in registers: 16, 8 or 4
//     bytes narrow, 32, 16 or 8 in bf16), a row is D / C lanes and a warp
//     load covers 32 C / D keys; a key's dot reduces over its own lanes
//     only (3 shuffles at D 128, C 16);
//   - each lane group keeps its own (m, l, acc) over its keys, U a step
//     (4 from 4 rows, where a key's dots and accumulation outweigh the
//     step's softmax); the groups of a warp merge by shuffles, the four
//     warps through shared memory, once at the end;
//   - loads in flight: the next step's K/V bytes and scales are loaded
//     into registers before this step's are dequantized, and (paged) the
//     physical blocks of the step after that, so neither the bytes nor the
//     block table wait on the arithmetic; the bytes bypass L1, which keeps
//     the table and the scales. Keys past the split's end load its last
//     key (masked), so no load sits under a branch. A key's page is
//     kpos / bs as one multiply-high by a reciprocal computed once.
template <typename S, int D, int SR>
struct QRows {
  static constexpr int C = SR <= 2 ? 16 : 32 / SR;  // values a lane loads
  static constexpr int W = C * (int)sizeof(S) / 4;  // as 32-bit words
  static constexpr int LPR = D / C;                 // lanes per key row
  static constexpr int G = 32 / LPR;                // keys per warp load
  static constexpr int U = SR >= 4 ? 4 : 2;         // keys per group a step
  static constexpr int KW = G * U;                  // keys per warp a step
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row lanes");
};

// N 32-bit words at p (aligned to their size), read once: through the
// non-coherent path without a place in L1, which keeps the block table and
// the scales there
template <int N>
__device__ __forceinline__ void ld_stream(const void* p, uint32_t* w) {
  if constexpr (N == 8) {
    ld_stream<4>(p, w);
    ld_stream<4>(static_cast<const uint4*>(p) + 1, w + 4);
  } else if constexpr (N == 4) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
        : "l"(p));
  } else if constexpr (N == 2) {
    asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
        : "=r"(w[0]), "=r"(w[1])
        : "l"(p));
  } else {
    static_assert(N == 1, "1, 2, 4 or 8 words");
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n" : "=r"(w[0]) : "l"(p));
  }
}

// The values of the W words in w as f32: bf16 storage, its 2 W values as
// stored (a shift or a mask each); narrow storage, its 4 W values
// dequantized with scale s in the prologue's order, f32(q) * s / bound
// rounded to bf16. EXACT: s passed exact_scale, so div_bound's division is
// the IEEE one; else the IEEE division itself.
template <typename S, int W, bool EXACT>
__device__ __forceinline__ void dequant_bf16(const uint32_t* w, float s,
                                             float* out) {
  if constexpr (std::is_same<S, bf16>::value) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      out[2 * i] = bf16_lo(w[i]);
      out[2 * i + 1] = bf16_hi(w[i]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    float f[4];
    narrow4_f32<S>(w[i], f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = __fmul_rn(f[e], s);
      f[e] = EXACT ? div_bound<S>(x) : __fdiv_rn(x, kv_bound<S>());
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t r = round2_bf16(f[2 * h], f[2 * h + 1]);
      out[4 * i + 2 * h] = bf16_lo(r);
      out[4 * i + 2 * h + 1] = bf16_hi(r);
    }
  }
}

// One (split, b * KV + kvh) block of four warps; the partial layout of
// flash_decode_rows.
template <typename S, int D, int SR, bool PAGED, bool MASKED>
__global__ void __launch_bounds__(kThreads)
    flash_decode_qrows(const bf16* __restrict__ q, const S* __restrict__ k,
                       const S* __restrict__ v, const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ pos,
                       const int* __restrict__ bt,
                       const uint8_t* __restrict__ mask,
                       float* __restrict__ o_part,
                       float* __restrict__ m_part, float* __restrict__ l_part,
                       int q_len, int H, int KV, int max_len, int bs, int nb,
                       int split_keys, float scale) {
  using P = QRows<S, D, SR>;
  constexpr bool kScaled = !std::is_same<S, bf16>::value;
  constexpr int C = P::C, W = P::W, LPR = P::LPR, G = P::G, U = P::U;
  constexpr int STEP = kWarps * P::KW;  // keys of the block a step
  __shared__ float sM[kWarps][SR];
  __shared__ float sL[kWarps][SR];
  __shared__ float sAcc[kWarps][SR][D];
  // MASKED: one word of mask bits per query token (q_len <= SR <= 8)
  __shared__ uint32_t sMask[MASKED ? SR : 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane / LPR;         // this lane's key within a warp load
  const int col = (lane % LPR) * C;   // and its first column
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int bk = blockIdx.z;
  const int b = bk / KV;
  const int kvh = bk % KV;
  const int group = H / KV;
  const int gq = q_len * group;  // <= SR
  const int len = min(pos[b] + q_len, max_len);
  const int qbase = len - q_len;
  const int q_hi = qbase + (gq - 1) / group;
  const int k_begin = split * split_keys;
  const int k_end = MASKED ? min(k_begin + split_keys, len)
                           : min(min(k_begin + split_keys, len), q_hi + 1);
  const long long part = ((long long)bk * n_split + split) * gq;

  if (k_begin >= k_end) {
    write_skip_partial<D>(o_part, m_part, l_part, part, gq, tid);
    return;
  }

  if constexpr (MASKED) {
    load_mask_bits(mask, b, q_len, 0, q_len, 1, sMask, tid);
    __syncthreads();
  }

  float qv[SR][C], acc[SR][C], m[SR], l[SR];
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < C; ++e) qv[r][e] = acc[r][e] = 0.f;
    if (r < gq) {
      const bf16* src = q + (((long long)b * q_len + r / group) * H +
                             kvh * group + r % group) * D + col;
      constexpr int QE = C < 8 ? C : 8;  // bf16 values per 16-byte load
#pragma unroll
      for (int e = 0; e < C; e += QE) load_vals<bf16, QE>(src + e, qv[r] + e);
    }
  }

  // key u of this lane in the warp's step at kc: kc + u * G + grp. Paged:
  // its page by a multiply-high (exact while kpos * bs < 2^32; the launch
  // checks max_len * bs), the physical block clamped as kv_row clamps it.
  const unsigned inv_bs = PAGED && bs > 1 ? 0xffffffffu / bs + 1u : 0u;
  auto page_of = [&](int kpos) {
    return bs > 1 ? (int)__umulhi((unsigned)kpos, inv_bs) : kpos;
  };
  // A key past the split's end reads the split's last key instead (it is
  // masked below and adds nothing), so every load is unconditional.
  auto phys_of = [&](int kpos) {
    const int kq = min(kpos, k_end - 1);
    return __ldg(bt + (long long)b * nb + min(page_of(kq), nb - 1));
  };
  // the bytes and scales of key kpos: its token row in the cache or pool,
  // then this lane's columns of kv head kvh
  const S* k_lane = k + kvh * D + col;
  const S* v_lane = v + kvh * D + col;
  auto fetch = [&](int kpos, int phys, uint32_t* kw, uint32_t* vw, float& sk,
                   float& sv) {
    const int kq = min(kpos, k_end - 1);
    const int tok = PAGED ? phys * bs + kq - page_of(kq) * bs
                          : b * max_len + kq;
    const long long at = (long long)tok * (KV * D);
    ld_stream<W>(k_lane + at, kw);
    ld_stream<W>(v_lane + at, vw);
    if constexpr (kScaled) {
      sk = __ldg(ks + (long long)tok * KV + kvh);
      sv = __ldg(vs + (long long)tok * KV + kvh);
    } else {
      sk = sv = 1.f;
    }
  };

  int kc = k_begin + warp * P::KW;  // this warp's first key of the step
  uint32_t kr[U][W], vr[U][W];      // the step's bytes, then the next's
  float skr[U], svr[U];
  int ph[U];                        // paged: the next step's blocks
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int kpos = kc + u * G + grp;
    fetch(kpos, PAGED ? phys_of(kpos) : 0, kr[u], vr[u], skr[u], svr[u]);
    ph[u] = PAGED ? phys_of(kpos + STEP) : 0;
  }

  for (; kc < k_end; kc += STEP) {
    uint32_t kn[U][W], vn[U][W];
    float skn[U], svn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kpos = kc + STEP + u * G + grp;
      fetch(kpos, ph[u], kn[u], vn[u], skn[u], svn[u]);
      if constexpr (PAGED) ph[u] = phys_of(kpos + STEP);
    }

    // this step: U keys per lane group, their visibility per row
    auto step = [&](auto exact) {
      constexpr bool EXACT = decltype(exact)::value;
      float sc[SR][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[C];
        dequant_bf16<S, W, EXACT>(kr[u], skr[u], kf);
#pragma unroll
        for (int r = 0; r < SR; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < C; ++e) dot = fmaf(qv[r][e], kf[e], dot);
          sc[r][u] = dot;
        }
      }
#pragma unroll
      for (int r = 0; r < SR; ++r)
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1)
            sc[r][u] += __shfl_xor_sync(0xffffffffu, sc[r][u], o);
#pragma unroll
      for (int r = 0; r < SR; ++r) {
        if (r < gq) {
          const int ti = r / group;  // the row's query token
          const uint32_t* mrow = sMask + (MASKED ? ti : 0);
          bool vis[U];
          float mx = m[r];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int kpos = kc + u * G + grp;
            vis[u] = kpos < k_end && visible<MASKED>(kpos, qbase, ti, mrow);
            sc[r][u] = vis[u] ? sc[r][u] * scale : kNegInf;
            mx = fmaxf(mx, sc[r][u]);
          }
          const float alpha = expf(m[r] - mx);
          float ps = 0.f;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            sc[r][u] = vis[u] ? expf(sc[r][u] - mx) : 0.f;
            ps += sc[r][u];
          }
          l[r] = l[r] * alpha + ps;
          m[r] = mx;
#pragma unroll
          for (int e = 0; e < C; ++e) acc[r][e] *= alpha;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[C];
        dequant_bf16<S, W, EXACT>(vr[u], svr[u], vf);
#pragma unroll
        for (int r = 0; r < SR; ++r)
          if (r < gq)
#pragma unroll
            for (int e = 0; e < C; ++e)
              acc[r][e] = fmaf(sc[r][u], vf[e], acc[r][e]);
      }
    };
    bool exact = true;
    if constexpr (kScaled) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        exact = exact && exact_scale(skr[u]) && exact_scale(svr[u]);
    }
    if (!kScaled || __all_sync(0xffffffffu, exact))
      step(std::true_type());
    else
      step(std::false_type());

#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < W; ++i) kr[u][i] = kn[u][i], vr[u][i] = vn[u][i];
      skr[u] = skn[u];
      svr[u] = svn[u];
    }
  }

  // the lane groups of the warp merge by shuffles (group 0 keeps the sum)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < SR; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mt = fmaxf(m[r], mo);
      const float fa = expf(m[r] - mt), fb = expf(mo - mt);
      l[r] = l[r] * fa + lo * fb;
      m[r] = mt;
#pragma unroll
      for (int e = 0; e < C; ++e)
        acc[r][e] = acc[r][e] * fa +
                    __shfl_xor_sync(0xffffffffu, acc[r][e], o) * fb;
    }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < SR; ++r) {
      if (r < gq) {
        if (lane == 0) {
          sM[warp][r] = m[r];
          sL[warp][r] = l[r];
        }
#pragma unroll
        for (int e = 0; e < C; ++e) sAcc[warp][r][col + e] = acc[r][e];
      }
    }
  }
  __syncthreads();
  merge_warps<D, SR>(&sM[0][0], &sL[0][0], &sAcc[0][0][0], o_part, m_part,
                     l_part, part, gq, tid);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* pos;
  const int* bt;
  const uint8_t* mask;
  float* o_part;
  float* m_part;
  float* l_part;
  void* out;
  int B, q_len, H, KV, max_len, bs, nb, n_split, split_keys;
  float scale;
};

template <typename T, typename S, int D, bool PAGED, bool MASKED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = partial_smem_bytes<D>();
  auto kern = flash_decode_partial<T, S, D, PAGED, MASKED>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int gq = a.q_len * (a.H / a.KV);
  const dim3 grid(a.n_split, (gq + ROWS - 1) / ROWS, a.B * a.KV);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const S*>(a.k),
      static_cast<const S*>(a.v), a.ks, a.vs, a.pos, a.bt, a.mask, a.o_part,
      a.m_part, a.l_part,
      a.q_len, a.H, a.KV, a.max_len, a.bs, a.nb, a.split_keys, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_decode_merge<T, D><<<dim3(gq, a.B * a.KV), kThreads, 0, stream>>>(
      a.o_part, a.m_part, a.l_part, static_cast<T*>(a.out), a.q_len, a.H,
      a.KV, a.n_split);
  return cudaGetLastError();
}

template <typename T, typename S, int D, int SR, bool PAGED, bool MASKED>
cudaError_t launch_rows(const Args& a, cudaStream_t stream) {
  const int gq = a.q_len * (a.H / a.KV);
  if (gq > SR) return cudaErrorInvalidValue;
  const dim3 grid(a.n_split, 1, a.B * a.KV);
  flash_decode_rows<T, S, D, SR, PAGED, MASKED>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(a.q), static_cast<const S*>(a.k),
          static_cast<const S*>(a.v), a.ks, a.vs, a.pos, a.bt, a.mask,
          a.o_part, a.m_part, a.l_part,
          a.q_len, a.H, a.KV, a.max_len, a.bs, a.nb, a.split_keys, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_decode_merge<T, D><<<dim3(gq, a.B * a.KV), kThreads, 0, stream>>>(
      a.o_part, a.m_part, a.l_part, static_cast<T*>(a.out), a.q_len, a.H,
      a.KV, a.n_split);
  return cudaGetLastError();
}

template <typename S, int D, int SR, bool PAGED, bool MASKED>
cudaError_t launch_qrows(const Args& a, cudaStream_t stream) {
  const int gq = a.q_len * (a.H / a.KV);
  if (gq > SR) return cudaErrorInvalidValue;
  // the page of a key by a multiply-high: exact while kpos * bs < 2^32
  if (PAGED && (long long)a.max_len * a.bs >= (1ll << 31))
    return cudaErrorInvalidValue;
  const dim3 grid(a.n_split, 1, a.B * a.KV);
  flash_decode_qrows<S, D, SR, PAGED, MASKED><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const S*>(a.k),
      static_cast<const S*>(a.v), a.ks, a.vs, a.pos, a.bt, a.mask, a.o_part,
      a.m_part, a.l_part, a.q_len, a.H, a.KV, a.max_len, a.bs, a.nb,
      a.split_keys, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_decode_merge<bf16, D><<<dim3(gq, a.B * a.KV), kThreads, 0, stream>>>(
      a.o_part, a.m_part, a.l_part, static_cast<bf16*>(a.out), a.q_len, a.H,
      a.KV, a.n_split);
  return cudaGetLastError();
}

template <typename S, int D, bool PAGED, bool MASKED, bool SMALL>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = MmaSmem<S, D>::bytes;
  constexpr int ROWS = SMALL ? 16 : MMA_ROWS;
  auto kern = flash_decode_mma<S, D, PAGED, MASKED, SMALL>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int gq = a.q_len * (a.H / a.KV);
  if (SMALL && gq > ROWS) return cudaErrorInvalidValue;
  const dim3 grid(a.n_split, (gq + ROWS - 1) / ROWS, a.B * a.KV);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const S*>(a.k),
      static_cast<const S*>(a.v), a.ks, a.vs, a.pos, a.bt, a.mask, a.o_part,
      a.m_part, a.l_part, a.q_len, a.H, a.KV, a.max_len, a.bs, a.nb,
      a.split_keys, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_decode_merge<bf16, D><<<dim3(gq, a.B * a.KV), kThreads, 0, stream>>>(
      a.o_part, a.m_part, a.l_part, static_cast<bf16*>(a.out), a.q_len, a.H,
      a.KV, a.n_split);
  return cudaGetLastError();
}

// the bodies of the C entry (decode_attention.py _BODY_CODES)
enum Body { kBodyRows = 0, kBodyTiled = 1, kBodyMma = 2, kBodyQRows = 3 };

// rows: the row tile. kBodyRows 1, 2, 4, 8 (one tile, SR rows; fp32
// queries only); kBodyQRows 1, 2, 4, 8 (bf16 queries over any storage);
// kBodyTiled 64 (fp32 only); kBodyMma 16 (one small tile) or MMA_ROWS
// (bf16 only)
template <typename T, typename S, int D, bool PAGED, bool MASKED>
cudaError_t by_rows(const Args& a, int body, int rows, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (body == kBodyQRows) {
      if (rows == 1) return launch_qrows<S, D, 1, PAGED, MASKED>(a, stream);
      if (rows == 2) return launch_qrows<S, D, 2, PAGED, MASKED>(a, stream);
      if (rows == 4) return launch_qrows<S, D, 4, PAGED, MASKED>(a, stream);
      if (rows == 8) return launch_qrows<S, D, 8, PAGED, MASKED>(a, stream);
    }
  } else {
    if (body == kBodyRows) {
      if (rows == 1) return launch_rows<T, S, D, 1, PAGED, MASKED>(a, stream);
      if (rows == 2) return launch_rows<T, S, D, 2, PAGED, MASKED>(a, stream);
      if (rows == 4) return launch_rows<T, S, D, 4, PAGED, MASKED>(a, stream);
      if (rows == 8) return launch_rows<T, S, D, 8, PAGED, MASKED>(a, stream);
    }
  }
  if constexpr (std::is_same<T, float>::value) {
    if (body == kBodyTiled && rows == ROWS)
      return launch<T, S, D, PAGED, MASKED>(a, stream);
  } else {
    if (body == kBodyMma) {
      if (rows == 16) return launch_mma<S, D, PAGED, MASKED, true>(a, stream);
      if (rows == MMA_ROWS)
        return launch_mma<S, D, PAGED, MASKED, false>(a, stream);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename S, bool PAGED, bool MASKED>
cudaError_t by_dim(const Args& a, int D, int body, int rows,
                   cudaStream_t stream) {
  if (D == 64) return by_rows<T, S, 64, PAGED, MASKED>(a, body, rows, stream);
  if (D == 128)
    return by_rows<T, S, 128, PAGED, MASKED>(a, body, rows, stream);
  return cudaErrorInvalidValue;
}

// kv_code: 0 = K/V stored in T, 1 = int8, 2 = fp8 e4m3 (with scales)
template <typename T, bool PAGED, bool MASKED>
cudaError_t by_storage(const Args& a, int kv_code, int D, int body, int rows,
                       cudaStream_t stream) {
  if (kv_code == 0)
    return by_dim<T, T, PAGED, MASKED>(a, D, body, rows, stream);
  if (a.ks == nullptr || a.vs == nullptr) return cudaErrorInvalidValue;
  if (kv_code == 1)
    return by_dim<T, int8_t, PAGED, MASKED>(a, D, body, rows, stream);
  if (kv_code == 2)
    return by_dim<T, __nv_fp8_e4m3, PAGED, MASKED>(a, D, body, rows, stream);
  return cudaErrorInvalidValue;
}

// the three layouts: contiguous, paged, paged with an ancestor mask (the
// contiguous cache takes no mask, as the TPU kernel's)
template <typename T>
cudaError_t by_layout(const Args& a, int kv_code, int D, int body, int rows,
                      cudaStream_t stream) {
  if (a.bt == nullptr) {
    if (a.mask != nullptr) return cudaErrorInvalidValue;
    return by_storage<T, false, false>(a, kv_code, D, body, rows, stream);
  }
  if (a.mask != nullptr) {
    if (a.q_len > kMaskWords * 32) return cudaErrorInvalidValue;
    return by_storage<T, true, true>(a, kv_code, D, body, rows, stream);
  }
  return by_storage<T, true, false>(a, kv_code, D, body, rows, stream);
}

}  // namespace

// Plain C entry for ctypes. bt == nullptr selects the contiguous cache
// [B, max_len, KV, D]; otherwise k/v are pools [num_blocks, bs, KV, D]
// addressed through bt [B, nb] and max_len must equal nb * bs. kv_code
// 0 keeps k/v in q's dtype (ks/vs unused); 1 (int8) and 2 (fp8 e4m3)
// read narrow k/v with their f32 scales ks/vs [.., KV] (the cache or
// pool shape without D).
// mask (paged only; nullptr = causal bundle) is the [B, q_len, q_len]
// ancestor mask as bytes, nonzero = visible, q_len <= 256.
// body (0 rows, 1 tiled, 2 mma, 3 qrows) and rows (its row tile) name
// the block body; a body that is not built for q's dtype and the storage
// is refused.
// o_part [B*KV, n_split, gq, D], m_part/l_part [B*KV, n_split, gq] are
// fp32 scratch owned by the caller. Returns the cudaError_t of the
// launches (0 = both were accepted).
extern "C" int paddle_flash_decode(const void* q, const void* k, const void* v,
                                   const void* ks, const void* vs,
                                   const void* pos, const void* bt,
                                   const void* mask, void* o_part,
                                   void* m_part, void* l_part, void* out,
                                   int is_bf16, int kv_code, int B, int q_len,
                                   int H, int KV, int D, int max_len, int bs,
                                   int nb, int n_split, int split_keys,
                                   int body, int rows, float scale,
                                   void* stream) {
  Args a{q,
         k,
         v,
         static_cast<const float*>(ks),
         static_cast<const float*>(vs),
         static_cast<const int*>(pos),
         static_cast<const int*>(bt),
         static_cast<const uint8_t*>(mask),
         static_cast<float*>(o_part),
         static_cast<float*>(m_part),
         static_cast<float*>(l_part),
         out,
         B,
         q_len,
         H,
         KV,
         max_len,
         bs,
         nb,
         n_split,
         split_keys,
         scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? by_layout<__nv_bfloat16>(a, kv_code, D, body, rows, st)
              : by_layout<float>(a, kv_code, D, body, rows, st);
  return static_cast<int>(e);
}
