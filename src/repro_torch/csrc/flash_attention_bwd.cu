// K7b — GQA causal flash attention, backward, for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package differentiates its Pallas
// forward `flash_attention_fwd` through `jax.custom_vjp`, whose backward is
// `jax.vjp` of the oracle `attention_ref`
// (src/repro/kernels/flash_attention/ops.py, `_bwd`).  It computes what
// that vjp computes, with float32 softmax and sums: for each batch b, kv
// head kh and group g (query head h = kh * G + g),
//
//   P[i,j]  = softmax_j(scale * q_i . k_j) over j <= i     (causal)
//   dV[j]   = sum_{g, i >= j} P[i,j] dO_i
//   dP[i,j] = dO_i . v_j,   D_i = dO_i . O_i,   dS[i,j] = P[i,j] (dP[i,j] - D_i)
//   dQ_i    = scale * sum_{j <= i} dS[i,j] k_j
//   dK[j]   = scale * sum_{g, i >= j} dS[i,j] q_i
//
// with q, O, dO (B,S,K,G,hd) and k, v (B,S,K,hd), all float32 or all
// bfloat16; dQ, dK, dV come out in the same type.  D_i = dO_i . O_i is the
// flash-attention form of sum_j P[i,j] dP[i,j] (equal for the exact O).
//
// Routes, by input:
//
// bfloat16, hd 64 / 128 (the training path): wgmma + TMA, with each row's
// log-sum-exp taken from K7's forward (no statistics sweep), two kernels:
//   k7b_dvec_kernel   D_i = dO_i . O_i, one half-warp a row, into a float32
//                     scratch;
//   k7b_wgmma_kernel  one warpgroup a block, two roles, both reading only
//                     inputs (so one launch holds both).  dK / dV blocks
//                     own 64 keys of one (kv head, batch) and walk the G
//                     heads and, for each, the 64-row query tiles at or
//                     after their keys: S^T = K Q^T and
//                     dP^T = V dO^T as wgmma with both operands in shared
//                     memory, P^T = exp(scale S^T - lse) and dS^T = P^T
//                     (dP^T - D) on the accumulator registers, then dV +=
//                     P^T dO and dK += dS^T Q as wgmma with P^T / dS^T as
//                     bf16 register fragments and the row-major dO / Q
//                     tiles read through the descriptor's transpose.  dQ
//                     blocks own 64 query rows of one (head, batch) and walk
//                     the key tiles up to the diagonal: S = Q K^T, dP = dO
//                     V^T, dS, dQ += dS K.  A block's own tiles load once;
//                     the streamed pair comes by TMA (128-byte swizzle) into
//                     a 2-stage ring, one pair ahead of the products.  Blocks
//                     are ordered longest first (the first key tiles, the
//                     last query tiles).  dQ stays in the block that owns
//                     its rows: no atomics.
// P and dS are rounded to bf16 once as they enter their products (as JAX's
// vjp of the oracle rounds them); S, dP and every sum are float32, and the
// outputs round to bf16 once.
//
// bfloat16, other hd <= 128: mma.sync m16n8k16 on the tensor cores, two
// kernels, launched in this order on the caller's stream:
//   k7b_dq_mma_kernel    one block of 4 warps per (64 query rows, head,
//                        batch), 16 rows a warp.  A first sweep over the key
//                        tiles computes each row's max and sum of its
//                        scaled scores online (as K7 does) and writes the
//                        log-sum-exp and D_i to a float32 scratch; a second
//                        sweep recomputes S = QK^T and dP = dO V^T, forms
//                        dS, and accumulates dQ += dS K;
//   k7b_dkdv_mma_kernel  one block of 4 warps per (64 keys, kv head,
//                        batch), 16 keys a warp, looping over the G heads
//                        and, for each, the 32-row query tiles at or after
//                        the block's first key: S^T = K Q^T, dP^T = V dO^T,
//                        then dV += P^T dO and dK += dS^T Q.
// S and dP multiply bf16 inputs exactly; P and dS enter their products as
// bf16 high + low parts (two MMAs, ~16 bits kept, as K7 splits P).  Tiles
// are staged in shared memory row-major and, for the B operands of dQ, dK
// and dV, transposed; rows are padded by 16 bytes, so a warp's fragment
// loads hit 32 banks.
//
// float32, or bfloat16 with hd > 128: float32 FMAs out of shared memory,
// three kernels:
//   k7b_stats_kernel  one block per (64 query rows, head, batch): each row's
//                     log-sum-exp of its scaled scores (an online max / sum
//                     over 32-key tiles) and D_i, into a float32 scratch;
//   k7b_dkdv_kernel   one block per (32 keys, kv head, batch): dK and dV of
//                     its keys, looping over the G heads and, for each, the
//                     32-row query tiles at or after the block's first key;
//   k7b_dq_kernel     one block per (32 query rows, head, batch): dQ of its
//                     rows, looping over the key tiles up to its last row.
// Tiles are staged as float32 (rows padded to hd + 1 words, so the 16
// lanes of a row group hit 16 banks).
//
// Every output element is written by one thread of one block, and every
// sum runs in a fixed order (no atomics), so two launches on the same
// inputs give the same bits.
//
// What bounds it on this card: the backward must do 10 * hd operations per
// causal (query, key) pair and head (S = QK^T, dP = dO V^T, dV, dQ, dK);
// at the llama3.2-3b training shape (B=8, S=256, K=8, G=3, hd=128, bf16)
// that is 8.1e9 operations against 67 MB of inputs and outputs: 8.2 us at
// the 989 TFLOP/s bf16 tensor-core peak and 20 us at 3.35 TB/s, so it is
// bound by bytes.  The wgmma design issues 1.4x the operations (the dQ
// blocks recompute S and dP) over whole 64 x 64 tiles, reads D's 4 bytes a
// row once more, and streams each K / V tile to every dQ block of its
// head and each Q / dO tile to every dK / dV block of its kv head from L2.
// The float32 FMA design is bound by shared memory (one 4-byte load per
// ~1.6 FMAs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;  // 16 row groups x 16 lanes
constexpr int SQ = 64;        // stats: query rows per block (4 per group)
constexpr int TQ = 32;        // dq / dkdv: query rows per tile
constexpr int TK = 32;        // dq / dkdv: keys per tile

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [r0, r0 + n) of one head of a (B, S, heads, hd) tensor into a
// float32 tile with row stride ld (zeros past S)
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          size_t base, size_t row, int r0,
                                          int n, int S, int hd, int ld) {
  for (int i = threadIdx.x; i < n * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    const int p = r0 + r;
    dst[r * ld + d] =
        p < S ? to_f32(src[base + static_cast<size_t>(p) * row + d]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// pass 1: log-sum-exp and D per query row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
k7b_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ lse, float* __restrict__ dvec, int S,
                 int K, int G, int hd, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;            // SQ x ld
  float* ks = qs + SQ * ld;    // TK x ld

  const int q0 = blockIdx.x * SQ;
  const int h = blockIdx.y, b = blockIdx.z, H = K * G;
  const int kh = h / G, g = h - kh * G;
  const int tid = threadIdx.x, rg = tid >> 4, ln = tid & 15;
  const size_t q_row = static_cast<size_t>(H) * hd;
  const size_t kv_row = static_cast<size_t>(K) * hd;
  const size_t q_off = static_cast<size_t>(b) * S * q_row +
                       (static_cast<size_t>(kh) * G + g) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_row +
                        static_cast<size_t>(kh) * hd;
  constexpr int RPT = SQ / 16;  // query rows per thread

  load_tile(qs, q, q_off, q_row, q0, SQ, S, hd, ld);
  float m[RPT], l[RPT];
#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.f;
  }
  const int q_last = min(q0 + SQ, S) - 1;
  for (int k0 = 0; k0 <= q_last; k0 += TK) {
    __syncthreads();  // the previous key tile is consumed
    load_tile(ks, k, kv_off, kv_row, k0, TK, S, hd, ld);
    __syncthreads();
    float s[RPT][2];
#pragma unroll
    for (int a = 0; a < RPT; ++a) s[a][0] = s[a][1] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float k0v = ks[ln * ld + d], k1v = ks[(ln + 16) * ld + d];
#pragma unroll
      for (int a = 0; a < RPT; ++a) {
        const float qv = qs[(rg * RPT + a) * ld + d];
        s[a][0] = fmaf(qv, k0v, s[a][0]);
        s[a][1] = fmaf(qv, k1v, s[a][1]);
      }
    }
#pragma unroll
    for (int a = 0; a < RPT; ++a) {
      const int i = q0 + rg * RPT + a;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = k0 + ln + 16 * c;
        s[a][c] = (j <= i && j < S) ? s[a][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        rs += s[a][c] > 0.5f * NEG_INF ? expf(s[a][c] - m_new) : 0.f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[a] = l[a] * expf(m[a] - m_new) + rs;
      m[a] = m_new;
    }
  }

  // D_i = dO_i . O_i: the row's 16 lanes split hd, then a fixed shuffle tree
#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    const int i = q0 + rg * RPT + a;
    float dsum = 0.f;
    if (i < S) {
      const size_t at = q_off + static_cast<size_t>(i) * q_row;
      for (int d = ln; d < hd; d += 16)
        dsum = fmaf(to_f32(dout[at + d]), to_f32(o[at + d]), dsum);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    if (ln == 0 && i < S) {
      const size_t r = (static_cast<size_t>(b) * H + h) * S + i;
      lse[r] = m[a] + logf(l[a]);
      dvec[r] = dsum;
    }
  }
}

// ---------------------------------------------------------------------------
// the scores of one (query tile, key tile) pair: P and dS for 2 x 2 entries
// of a thread, rows `rows[2]` of the query tile, cols `cols[2]` of the key
// tile (both local), s = q.k and dp = dO.v over hd
// ---------------------------------------------------------------------------

struct Pair {
  float p, ds;
};

__device__ __forceinline__ Pair p_ds(float s, float dp, int i, int j, int S,
                                     float scale, float lse_i, float d_i) {
  if (j > i || i >= S || j >= S) return {0.f, 0.f};
  const float p = expf(s * scale - lse_i);
  return {p, p * (dp - d_i)};
}

// ---------------------------------------------------------------------------
// pass 2: dK and dV per key tile
// ---------------------------------------------------------------------------

template <typename T, int HDMAX>
__global__ void __launch_bounds__(THREADS)
k7b_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dvec,
                T* __restrict__ dk, T* __restrict__ dv, int S, int K, int G,
                int hd, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* ks = smem;                // TK x ld
  float* vs = ks + TK * ld;        // TK x ld
  float* qs = vs + TK * ld;        // TQ x ld
  float* dos = qs + TQ * ld;       // TQ x ld
  float* ps = dos + TQ * ld;       // TK x (TQ + 1): P^T
  float* dss = ps + TK * (TQ + 1);   // TK x (TQ + 1): dS^T
  float* ls = dss + TK * (TQ + 1);   // TQ: lse
  float* dl = ls + TQ;               // TQ: D

  const int j0 = blockIdx.x * TK;
  const int kh = blockIdx.y, b = blockIdx.z, H = K * G;
  const int tid = threadIdx.x, kr = tid >> 4, ln = tid & 15;
  const size_t q_row = static_cast<size_t>(H) * hd;
  const size_t kv_row = static_cast<size_t>(K) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_row +
                        static_cast<size_t>(kh) * hd;
  constexpr int NC = HDMAX / 16;   // feature columns per thread

  load_tile(ks, k, kv_off, kv_row, j0, TK, S, hd, ld);
  load_tile(vs, v, kv_off, kv_row, j0, TK, S, hd, ld);
  float acc_k[2][NC], acc_v[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t q_off = static_cast<size_t>(b) * S * q_row +
                         static_cast<size_t>(h) * hd;
    const size_t stat = (static_cast<size_t>(b) * H + h) * S;
    for (int i0 = (j0 / TQ) * TQ; i0 < S; i0 += TQ) {
      __syncthreads();  // the previous query tile and P / dS are consumed
      load_tile(qs, q, q_off, q_row, i0, TQ, S, hd, ld);
      load_tile(dos, dout, q_off, q_row, i0, TQ, S, hd, ld);
      if (tid < TQ) {
        const int i = i0 + tid;
        ls[tid] = i < S ? lse[stat + i] : 0.f;
        dl[tid] = i < S ? dvec[stat + i] : 0.f;
      }
      __syncthreads();
      // keys 2kr, 2kr+1 x queries ln, ln+16 of the tiles
      float s[2][2], dp[2][2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c) s[a][c] = dp[a][c] = 0.f;
      for (int d = 0; d < hd; ++d) {
        const float q0v = qs[ln * ld + d], q1v = qs[(ln + 16) * ld + d];
        const float o0v = dos[ln * ld + d], o1v = dos[(ln + 16) * ld + d];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float kv = ks[(2 * kr + a) * ld + d];
          const float vv = vs[(2 * kr + a) * ld + d];
          s[a][0] = fmaf(q0v, kv, s[a][0]);
          s[a][1] = fmaf(q1v, kv, s[a][1]);
          dp[a][0] = fmaf(o0v, vv, dp[a][0]);
          dp[a][1] = fmaf(o1v, vv, dp[a][1]);
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int il = ln + 16 * c, jl = 2 * kr + a;
          const Pair r = p_ds(s[a][c], dp[a][c], i0 + il, j0 + jl, S, scale,
                              ls[il], dl[il]);
          ps[jl * (TQ + 1) + il] = r.p;
          dss[jl * (TQ + 1) + il] = r.ds;
        }
      __syncthreads();
      for (int il = 0; il < TQ; ++il) {
        const float p0 = ps[(2 * kr) * (TQ + 1) + il];
        const float p1 = ps[(2 * kr + 1) * (TQ + 1) + il];
        const float d0 = dss[(2 * kr) * (TQ + 1) + il];
        const float d1 = dss[(2 * kr + 1) * (TQ + 1) + il];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = ln + 16 * c;
          if (d < hd) {
            const float ov = dos[il * ld + d], qv = qs[il * ld + d];
            acc_v[0][c] = fmaf(p0, ov, acc_v[0][c]);
            acc_v[1][c] = fmaf(p1, ov, acc_v[1][c]);
            acc_k[0][c] = fmaf(d0, qv, acc_k[0][c]);
            acc_k[1][c] = fmaf(d1, qv, acc_k[1][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int j = j0 + 2 * kr + a;
    if (j >= S) continue;
    const size_t at = kv_off + static_cast<size_t>(j) * kv_row;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = ln + 16 * c;
      if (d < hd) {
        store(dk + at + d, scale * acc_k[a][c]);
        store(dv + at + d, acc_v[a][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pass 3: dQ per query tile
// ---------------------------------------------------------------------------

template <typename T, int HDMAX>
__global__ void __launch_bounds__(THREADS)
k7b_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dvec,
              T* __restrict__ dq, int S, int K, int G, int hd, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;                // TQ x ld
  float* dos = qs + TQ * ld;       // TQ x ld
  float* ks = dos + TQ * ld;       // TK x ld
  float* vs = ks + TK * ld;        // TK x ld
  float* dss = vs + TK * ld;       // TQ x (TK + 1): dS
  float* ls = dss + TQ * (TK + 1);   // TQ
  float* dl = ls + TQ;               // TQ

  const int i0 = blockIdx.x * TQ;
  const int h = blockIdx.y, b = blockIdx.z, H = K * G;
  const int kh = h / G;
  const int tid = threadIdx.x, qr = tid >> 4, ln = tid & 15;
  const size_t q_row = static_cast<size_t>(H) * hd;
  const size_t kv_row = static_cast<size_t>(K) * hd;
  const size_t q_off = static_cast<size_t>(b) * S * q_row +
                       static_cast<size_t>(h) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_row +
                        static_cast<size_t>(kh) * hd;
  const size_t stat = (static_cast<size_t>(b) * H + h) * S;
  constexpr int NC = HDMAX / 16;

  load_tile(qs, q, q_off, q_row, i0, TQ, S, hd, ld);
  load_tile(dos, dout, q_off, q_row, i0, TQ, S, hd, ld);
  if (tid < TQ) {
    const int i = i0 + tid;
    ls[tid] = i < S ? lse[stat + i] : 0.f;
    dl[tid] = i < S ? dvec[stat + i] : 0.f;
  }
  float acc[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;

  const int i_last = min(i0 + TQ, S) - 1;
  for (int j0 = 0; j0 <= i_last; j0 += TK) {
    __syncthreads();  // the previous key tile and dS are consumed
    load_tile(ks, k, kv_off, kv_row, j0, TK, S, hd, ld);
    load_tile(vs, v, kv_off, kv_row, j0, TK, S, hd, ld);
    __syncthreads();
    // queries 2qr, 2qr+1 x keys ln, ln+16 of the tiles
    float s[2][2], dp[2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) s[a][c] = dp[a][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float k0v = ks[ln * ld + d], k1v = ks[(ln + 16) * ld + d];
      const float v0v = vs[ln * ld + d], v1v = vs[(ln + 16) * ld + d];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float qv = qs[(2 * qr + a) * ld + d];
        const float ov = dos[(2 * qr + a) * ld + d];
        s[a][0] = fmaf(qv, k0v, s[a][0]);
        s[a][1] = fmaf(qv, k1v, s[a][1]);
        dp[a][0] = fmaf(ov, v0v, dp[a][0]);
        dp[a][1] = fmaf(ov, v1v, dp[a][1]);
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int il = 2 * qr + a, jl = ln + 16 * c;
        dss[il * (TK + 1) + jl] =
            p_ds(s[a][c], dp[a][c], i0 + il, j0 + jl, S, scale, ls[il],
                 dl[il]).ds;
      }
    __syncthreads();
    for (int jl = 0; jl < TK; ++jl) {
      const float d0 = dss[(2 * qr) * (TK + 1) + jl];
      const float d1 = dss[(2 * qr + 1) * (TK + 1) + jl];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = ln + 16 * c;
        if (d < hd) {
          const float kv = ks[jl * ld + d];
          acc[0][c] = fmaf(d0, kv, acc[0][c]);
          acc[1][c] = fmaf(d1, kv, acc[1][c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int i = i0 + 2 * qr + a;
    if (i >= S) continue;
    const size_t at = q_off + static_cast<size_t>(i) * q_row;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = ln + 16 * c;
      if (d < hd) store(dq + at + d, scale * acc[a][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16, hd <= 128 other than 64 / 128: mma.sync m16n8k16
// ---------------------------------------------------------------------------

using bf16mma::ld32;
using bf16mma::mma16816;
using bf16mma::pack;
using bf16mma::split;

constexpr int MTHREADS = 128;  // 4 warps x 16 rows
constexpr int MR = 64;         // dq: query rows a block; dkdv: keys a block
constexpr int MK = 64;         // dq: keys a staged tile
constexpr int MQ = 32;         // dkdv: queries a staged tile
constexpr int PAD = 8;         // bf16 elements of row padding (16 bytes)

__device__ __forceinline__ uint4 ld128(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// rows [r0, r0 + n) of one head into a row-major tile (row stride ld),
// 16-byte chunks, zeros past S
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src,
                                           size_t base, size_t row, int r0,
                                           int n, int S, int hd, int ld) {
  const int cpr = hd / 8;
  for (int i = threadIdx.x; i < n * cpr; i += MTHREADS) {
    const int r = i / cpr, c = i - r * cpr;
    const int p = r0 + r;
    const uint4 val = p < S ? ld128(src + base + static_cast<size_t>(p) * row +
                                    c * 8)
                            : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
  }
}

// the same rows transposed, (hd x n) with row stride ld: neighbouring
// threads take neighbouring rows, so their 2-byte stores share no bank
__device__ __forceinline__ void stage_cols(bf16* dst, const bf16* __restrict__ src,
                                           size_t base, size_t row, int r0,
                                           int n, int S, int hd, int ld) {
  const int cpr = hd / 8;
  for (int i = threadIdx.x; i < n * cpr; i += MTHREADS) {
    const int c = i / n, r = i - c * n;
    const int p = r0 + r;
    const uint4 val = p < S ? ld128(src + base + static_cast<size_t>(p) * row +
                                    c * 8)
                            : make_uint4(0u, 0u, 0u, 0u);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int x = 0; x < 8; ++x) dst[(c * 8 + x) * ld + r] = e[x];
  }
}

// acc[j] += A (16 rows from `a`, row stride lda) . B^T over hd, B's 8j+g-th
// row from `b` (row stride ldb): 16 x (8 NJ) scores of a warp
template <int NJ>
__device__ __forceinline__ void scores(float acc[][4], const bf16* a, int lda,
                                       const bf16* b, int ldb, int hd) {
  for (int kk = 0; kk < hd; kk += 16) {
    uint32_t f[4];
    f[0] = ld32(a + kk);
    f[1] = ld32(a + 8 * lda + kk);
    f[2] = ld32(a + kk + 8);
    f[3] = ld32(a + 8 * lda + kk + 8);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bf16* bj = b + 8 * j * ldb + kk;
      mma16816(acc[j], f, ld32(bj), ld32(bj + 8));
    }
  }
}

// out[n] += X (16 x 16 NK, C fragments in x, float32 as bf16 high + low
// parts) . Y, Y's (16 kk .. + 15) x (8n .. 8n + 7) block from the
// transposed tile yt (row stride ldt, already offset by g rows and 2t
// columns)
template <int NK, int NT>
__device__ __forceinline__ void product(float out[][4], const float x[][4],
                                        const bf16* yt, int ldt, int hd) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t hi[4], lo[4];
    split(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    split(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    split(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    split(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (8 * n < hd) {
        const bf16* yb = yt + 8 * n * ldt + 16 * kk;
        const uint32_t b0 = ld32(yb), b1 = ld32(yb + 8);
        mma16816(out[n], hi, b0, b1);
        mma16816(out[n], lo, b0, b1);
      }
    }
  }
}

// dQ per (64 query rows, head, batch), 4 warps x 16 rows.  Sweep 1 over
// the key tiles: each row's max and sum of its scaled scores (online, as
// K7), written out as the log-sum-exp with D_i = dO_i . O_i; sweep 2: S,
// dP, then dQ += dS K.
template <int HDMAX>
__global__ void __launch_bounds__(MTHREADS)
k7b_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const bf16* __restrict__ dout, float* __restrict__ lse,
                  float* __restrict__ dvec, bf16* __restrict__ dq, int S,
                  int K, int G, int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldr = hd + PAD;            // row-major tiles
  const int ldt = MK + PAD;            // K^T
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // MR x ldr
  bf16* dos = qs + MR * ldr;                      // MR x ldr
  bf16* ks = dos + MR * ldr;                      // MK x ldr
  bf16* vs = ks + MK * ldr;                       // MK x ldr
  bf16* kt = vs + MK * ldr;                       // hd x ldt
  float* rowf = reinterpret_cast<float*>(kt + hd * ldt);  // lse, D: 2 x MR

  const int q0 = blockIdx.x * MR;
  const int h = blockIdx.y, b = blockIdx.z, H = K * G, kh = h / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_row = static_cast<size_t>(H) * hd;
  const size_t kv_row = static_cast<size_t>(K) * hd;
  const size_t q_off = static_cast<size_t>(b) * S * q_row +
                       static_cast<size_t>(h) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_row +
                        static_cast<size_t>(kh) * hd;
  const size_t stat = (static_cast<size_t>(b) * H + h) * S;
  constexpr int NT = HDMAX / 8;

  stage_rows(qs, q, q_off, q_row, q0, MR, S, hd, ldr);
  stage_rows(dos, dout, q_off, q_row, q0, MR, S, hd, ldr);
  __syncthreads();
  {  // D: two threads a row, each half of hd in order, then their sum
    const int r = tid >> 1, half = tid & 1, n = hd / 2;
    const int i = q0 + r;
    float dsum = 0.f;
    if (i < S) {
      const bf16* orow = o + q_off + static_cast<size_t>(i) * q_row;
      for (int d = half * n; d < half * n + n; ++d)
        dsum = fmaf(__bfloat162float(dos[r * ldr + d]),
                    __bfloat162float(orow[d]), dsum);
    }
    const float other = __shfl_xor_sync(0xffffffffu, dsum, 1);
    if (half == 0) rowf[MR + r] = dsum + other;
  }

  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;  // the thread's two rows
  const int row0 = q0 + lr0, row1 = q0 + lr1;
  const bf16* qa = qs + lr0 * ldr + 2 * t;
  const bf16* da = dos + lr0 * ldr + 2 * t;
  const int q_last = min(q0 + MR, S) - 1;

  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  for (int k0 = 0; k0 <= q_last; k0 += MK) {
    __syncthreads();  // the previous key tile is consumed
    stage_rows(ks, k, kv_off, kv_row, k0, MK, S, hd, ldr);
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    scores<8>(s, qa, ldr, ks + g * ldr + 2 * t, ldr, hd);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * t + (e & 1);
        const int qp = e < 2 ? row0 : row1;
        s[j][e] = (kp <= qp && kp < S) ? s[j][e] * scale : NEG_INF;
        if (e < 2) mx0 = fmaxf(mx0, s[j][e]);
        else mx1 = fmaxf(mx1, s[j][e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      rs0 += expf(s[j][0] - mn0) + expf(s[j][1] - mn0);
      rs1 += expf(s[j][2] - mn1) + expf(s[j][3] - mn1);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    l0 = l0 * expf(m0 - mn0) + rs0;
    l1 = l1 * expf(m1 - mn1) + rs1;
    m0 = mn0;
    m1 = mn1;
  }
  if (t == 0) {
    rowf[lr0] = m0 + logf(l0);
    rowf[lr1] = m1 + logf(l1);
  }
  __syncthreads();
  if (tid < MR && q0 + tid < S) {
    lse[stat + q0 + tid] = rowf[tid];
    dvec[stat + q0 + tid] = rowf[MR + tid];
  }
  const float lse0 = rowf[lr0], lse1 = rowf[lr1];
  const float d0 = rowf[MR + lr0], d1 = rowf[MR + lr1];

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int k0 = 0; k0 <= q_last; k0 += MK) {
    __syncthreads();  // the previous tiles are consumed
    stage_rows(ks, k, kv_off, kv_row, k0, MK, S, hd, ldr);
    stage_rows(vs, v, kv_off, kv_row, k0, MK, S, hd, ldr);
    stage_cols(kt, k, kv_off, kv_row, k0, MK, S, hd, ldt);
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    scores<8>(s, qa, ldr, ks + g * ldr + 2 * t, ldr, hd);
    scores<8>(dp, da, ldr, vs + g * ldr + 2 * t, ldr, hd);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * t + (e & 1);
        const int qp = e < 2 ? row0 : row1;
        const float p = (kp <= qp && kp < S && qp < S)
                            ? expf(s[j][e] * scale - (e < 2 ? lse0 : lse1))
                            : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? d0 : d1));  // dS
      }
    product<4, NT>(acc, s, kt + g * ldt + 2 * t, ldt, hd);
  }

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (8 * n >= hd) continue;
    const int col = 8 * n + 2 * t;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(dq + q_off + static_cast<size_t>(row0) *
                                   q_row + col) =
          pack(scale * acc[n][0], scale * acc[n][1]);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(dq + q_off + static_cast<size_t>(row1) *
                                   q_row + col) =
          pack(scale * acc[n][2], scale * acc[n][3]);
  }
}

// dK and dV per (64 keys, kv head, batch), 4 warps x 16 keys, looping over
// the G heads and, for each, the 32-row query tiles at or after the first
// key: S^T = K Q^T, dP^T = V dO^T, P^T and dS^T from the row statistics,
// dV += P^T dO and dK += dS^T Q.
template <int HDMAX>
__global__ void __launch_bounds__(MTHREADS)
k7b_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int S, int K, int G, int hd,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldr = hd + PAD;            // row-major tiles
  const int ldt = MQ + PAD;            // Q^T, dO^T
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // MR x ldr
  bf16* vs = ks + MR * ldr;                       // MR x ldr
  bf16* qs = vs + MR * ldr;                       // MQ x ldr
  bf16* dos = qs + MQ * ldr;                      // MQ x ldr
  bf16* qt = dos + MQ * ldr;                      // hd x ldt
  bf16* dot = qt + hd * ldt;                      // hd x ldt
  float* rowf = reinterpret_cast<float*>(dot + hd * ldt);  // lse, D: 2 x MQ

  const int j0 = blockIdx.x * MR;
  const int kh = blockIdx.y, b = blockIdx.z, H = K * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_row = static_cast<size_t>(H) * hd;
  const size_t kv_row = static_cast<size_t>(K) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_row +
                        static_cast<size_t>(kh) * hd;
  constexpr int NT = HDMAX / 8;

  stage_rows(ks, k, kv_off, kv_row, j0, MR, S, hd, ldr);
  stage_rows(vs, v, kv_off, kv_row, j0, MR, S, hd, ldr);
  const int key0 = j0 + warp * 16 + g, key1 = key0 + 8;
  const bf16* ka = ks + (warp * 16 + g) * ldr + 2 * t;
  const bf16* va = vs + (warp * 16 + g) * ldr + 2 * t;

  float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const size_t q_off = static_cast<size_t>(b) * S * q_row +
                         static_cast<size_t>(h) * hd;
    const size_t stat = (static_cast<size_t>(b) * H + h) * S;
    for (int i0 = j0; i0 < S; i0 += MQ) {
      __syncthreads();  // the previous query tile is consumed
      stage_rows(qs, q, q_off, q_row, i0, MQ, S, hd, ldr);
      stage_rows(dos, dout, q_off, q_row, i0, MQ, S, hd, ldr);
      stage_cols(qt, q, q_off, q_row, i0, MQ, S, hd, ldt);
      stage_cols(dot, dout, q_off, q_row, i0, MQ, S, hd, ldt);
      if (tid < MQ) {
        const int i = i0 + tid;
        rowf[tid] = i < S ? lse[stat + i] : 0.f;
        rowf[MQ + tid] = i < S ? dvec[stat + i] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      scores<4>(s, ka, ldr, qs + g * ldr + 2 * t, ldr, hd);
      scores<4>(dp, va, ldr, dos + g * ldr + 2 * t, ldr, hd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * j + 2 * t + (e & 1), qp = i0 + ql;
          const int kp = e < 2 ? key0 : key1;
          const float p = (kp <= qp && qp < S && kp < S)
                              ? expf(s[j][e] * scale - rowf[ql])
                              : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - rowf[MQ + ql]);  // dS^T
        }
      product<2, NT>(acc_v, s, dot + g * ldt + 2 * t, ldt, hd);
      product<2, NT>(acc_k, dp, qt + g * ldt + 2 * t, ldt, hd);
    }
  }

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (8 * n >= hd) continue;
    const int col = 8 * n + 2 * t;
    if (key0 < S) {
      const size_t at = kv_off + static_cast<size_t>(key0) * kv_row + col;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack(scale * acc_k[n][0], scale * acc_k[n][1]);
      *reinterpret_cast<uint32_t*>(dv + at) = pack(acc_v[n][0], acc_v[n][1]);
    }
    if (key1 < S) {
      const size_t at = kv_off + static_cast<size_t>(key1) * kv_row + col;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack(scale * acc_k[n][2], scale * acc_k[n][3]);
      *reinterpret_cast<uint32_t*>(dv + at) = pack(acc_v[n][2], acc_v[n][3]);
    }
  }
}

template <int HDMAX>
int launch_mma(const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv, float* lse,
               float* dvec, int B, int S, int K, int G, int hd, float scale,
               cudaStream_t stream) {
  const int ldr = hd + PAD, H = K * G;
  const size_t smem_q = sizeof(bf16) * (4 * MR * ldr + hd * (MK + PAD)) +
                        sizeof(float) * 2 * MR;
  const size_t smem_kv = sizeof(bf16) * (2 * (MR + MQ) * ldr +
                                         2 * hd * (MQ + PAD)) +
                         sizeof(float) * 2 * MQ;
  auto dqk = k7b_dq_mma_kernel<HDMAX>;
  auto dkdv = k7b_dkdv_mma_kernel<HDMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_q));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  dqk<<<dim3((S + MR - 1) / MR, H, B), MTHREADS, smem_q, stream>>>(
      qt, kt, vt, static_cast<const bf16*>(o), dot, lse, dvec,
      static_cast<bf16*>(dq), S, K, G, hd, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dkdv<<<dim3((S + MR - 1) / MR, K, B), MTHREADS, smem_kv, stream>>>(
      qt, kt, vt, dot, lse, dvec, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, K, G, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16, hd 64 / 128: wgmma + TMA, the row statistics from the forward
// ---------------------------------------------------------------------------

constexpr int WR = 64;            // rows a block owns: wgmma's m64
constexpr int WTHREADS = 128;     // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct WCfg {
  static constexpr int NCH = HD / 64;          // 128-byte column chunks
  static constexpr int CHUNK = WR * 128;       // bytes of a 64-row chunk
  static constexpr int TILE = NCH * CHUNK;     // bytes of a 64-row tile
  // two own tiles, a 2-stage ring of two streamed tiles, the statistics
  // ring (2 x 2 x 64 floats), barriers, 1 KB to align to the swizzle line
  static constexpr int SMEM = 6 * TILE + 1024 + 256 + 1024;
};

// 2^x on the special-function unit (as K7's forward)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 64) hopper::wgmma_rs_n64(d, a, db, 1);
  else hopper::wgmma_rs_n128(d, a, db, 1);
}

// d (64 x 64) = A (64 rows of a tile at a_base) . B^T (64 rows at b_base)
// over HD: both K-major, 128-byte swizzled (issued and committed, not
// waited for)
template <int HD>
__device__ __forceinline__ void wgmma_rows(float (&d)[32], uint32_t a_base,
                                           uint32_t b_base) {
  using C = WCfg<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk >> 2) * C::CHUNK + (kk & 3) * 32;
    hopper::wgmma_ss_n64(d, hopper::desc_sw128(a_base + off, 16, 1024),
                         hopper::desc_sw128(b_base + off, 16, 1024), kk > 0);
  }
  hopper::wgmma_commit();
}

// acc (64 x HD) += X (64 x 64: the accumulator fragments x, rounded to
// bf16 once) . Y (64 rows of a tile at y_base, N-major: read row-major
// through the descriptor's transpose); issued, not committed.  The x
// fragments of n-tiles 2kk, 2kk+1 are the A operand of rows 16kk..16kk+15
// of Y; `f` receives them (it must live until the product is waited for).
template <int HD>
__device__ __forceinline__ void wgmma_frag(float (&acc)[HD / 2],
                                           const float (&x)[32],
                                           uint32_t (&f)[4][4],
                                           uint32_t y_base) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f[kk][r] = pack(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
  hopper::fence_regs(f[0]);
  hopper::fence_regs(f[1]);
  hopper::fence_regs(f[2]);
  hopper::fence_regs(f[3]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<HD>(acc, f[kk], hopper::desc_sw128(y_base + kk * 2048,
                                                 WCfg<HD>::CHUNK, 1024));
}

// a (64 x HD) accumulator, scaled, to bf16 rows [r0, r0 + 64) of one head
// (row stride `row` elements), rows past S dropped
template <int HD>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const float (&acc)[HD / 2],
                                           float mul, int r0, int S,
                                           size_t row) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = r0 + warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(out + row0 * row + 8 * n + 2 * t) =
          pack(mul * acc[4 * n], mul * acc[4 * n + 1]);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(out + row1 * row + 8 * n + 2 * t) =
          pack(mul * acc[4 * n + 2], mul * acc[4 * n + 3]);
  }
}

// D_i = dO_i . O_i in float32, one half-warp a row (16-byte loads, a fixed
// butterfly), into dvec[(b * H + h) * S + i]
__global__ void __launch_bounds__(256)
k7b_dvec_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                float* __restrict__ dvec, int rows, int S, int H, int hd) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 4;
  const int ln = threadIdx.x & 15;
  float sum = 0.f;
  if (r < rows) {
    const size_t base = static_cast<size_t>(r) * hd;
    for (int c = ln * 8; c < hd; c += 128) {
      const uint4 a = ld128(o + base + c), d = ld128(dout + base + c);
      const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 af = __bfloat1622float2(ap[e]);
        const float2 df = __bfloat1622float2(dp[e]);
        sum = fmaf(af.x, df.x, sum);
        sum = fmaf(af.y, df.y, sum);
      }
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (ln == 0 && r < rows) {
    const int b = r / (S * H), rem = r - b * S * H;
    const int i = rem / H, h = rem - i * H;
    dvec[(static_cast<size_t>(b) * H + h) * S + i] = sum;
  }
}

// One warpgroup a block, two roles.  Blocks [0, n_kv): dK and dV of 64 keys
// of one (kv head, batch), walking the G heads and, for each, the 64-row
// query tiles at or after the block's keys; blocks [n_kv, n_kv + n_q): dQ
// of 64 query rows of one (head, batch), walking the key tiles up to the
// diagonal.  Both orders put the longest blocks first.  The block's own two
// tiles (K, V or Q, dO) load once; the streamed pair (Q, dO or K, V) comes
// by TMA into a 2-stage ring, one tile pair ahead of the products.
// q / dout are tensor maps over (hd, H, S, B), k / v over (hd, K, S, B),
// 64-column boxes of 64 rows, 128-byte swizzled.  lse: the forward's
// (B, H, S) log-sum-exp; dvec: (B, H, S).
template <int HD>
__global__ void __launch_bounds__(WTHREADS, 2)
k7b_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse, const float* __restrict__ dvec,
                 bf16* __restrict__ dq, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int S, int K, int G, int B,
                 float scale) {
  using C = WCfg<HD>;
  extern __shared__ __align__(1024) unsigned char wsmem[];
  unsigned char* own =
      wsmem + ((1024 - (hopper::smem_addr(wsmem) & 1023)) & 1023);
  unsigned char* ring = own + 2 * C::TILE;          // stage s: 2 tiles
  float* stat = reinterpret_cast<float*>(ring + 4 * C::TILE);  // [2][2][64]
  uint64_t* bar_own = reinterpret_cast<uint64_t*>(stat + 256);
  uint64_t* full = bar_own + 1;                     // [2]

  const int H = K * G, nt = (S + WR - 1) / WR;
  const int n_kv = nt * K * B;
  const int x = blockIdx.x;
  const bool kv_role = x < n_kv;
  int b, head, tile, n_it, span = 1;
  if (kv_role) {             // key tile `tile`, kv head `head`
    tile = x / (K * B);
    const int r = x - tile * K * B;
    b = r / K;
    head = r - b * K;
    span = nt - tile;        // query tiles a head
    n_it = G * span;
  } else {                   // query tile `tile`, head `head`
    const int y = x - n_kv;
    const int rank = y / (H * B);
    const int r = y - rank * H * B;
    b = r / H;
    head = r - b * H;
    tile = nt - 1 - rank;
    n_it = tile + 1;
  }
  const int r0 = tile * WR;  // the block's first row (key or query)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * LOG2E;

  // the streamed pair of iteration u: (head, first row) of its tiles
  auto stream_at = [&](int u, int& hh, int& rr) {
    if (kv_role) {
      hh = head * G + u / span;
      rr = (tile + u % span) * WR;
    } else {
      hh = head / G;   // the kv head of the streamed K / V
      rr = u * WR;
    }
  };
  auto load_stream = [&](int u) {
    const int s = u & 1;
    int hh, rr;
    stream_at(u, hh, rr);
    unsigned char* a = ring + s * 2 * C::TILE;
    hopper::mbar_expect_tx(&full[s], 2 * C::TILE);
    for (int c = 0; c < C::NCH; ++c) {
      hopper::tma_load_4d(a + c * C::CHUNK, kv_role ? &tq : &tk, &full[s],
                          c * 64, hh, rr, b);
      hopper::tma_load_4d(a + C::TILE + c * C::CHUNK, kv_role ? &tdo : &tv,
                          &full[s], c * 64, hh, rr, b);
    }
  };
  // the statistics of iteration u's query rows (dK / dV role): log2-scaled
  // lse and D of the 64 rows, thread tid < 64 holding row tid
  auto stat_row = [&](int u, float& l2, float& d) {
    int hh, rr;
    stream_at(u, hh, rr);
    const int i = rr + tid;
    const size_t at = (static_cast<size_t>(b) * H + hh) * S + i;
    l2 = i < S ? lse[at] * LOG2E : 0.f;
    d = i < S ? dvec[at] : 0.f;
  };

  if (tid == 0) {
    hopper::mbar_init(bar_own, 1);
    hopper::mbar_init(&full[0], 1);
    hopper::mbar_init(&full[1], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bar_own, 2 * C::TILE);
    for (int c = 0; c < C::NCH; ++c) {
      if (kv_role) {
        hopper::tma_load_4d(own + c * C::CHUNK, &tk, bar_own, c * 64, head,
                            r0, b);
        hopper::tma_load_4d(own + C::TILE + c * C::CHUNK, &tv, bar_own,
                            c * 64, head, r0, b);
      } else {
        hopper::tma_load_4d(own + c * C::CHUNK, &tq, bar_own, c * 64, head,
                            r0, b);
        hopper::tma_load_4d(own + C::TILE + c * C::CHUNK, &tdo, bar_own,
                            c * 64, head, r0, b);
      }
    }
    load_stream(0);
    if (n_it > 1) load_stream(1);
  }

  const uint32_t own_a = hopper::smem_addr(own);
  const uint32_t own_b = own_a + C::TILE;
  float acc0[HD / 2], acc1[HD / 2];   // dK, dV (kv role); dQ (q role: acc0)
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc0[i] = acc1[i] = 0.f;
  float sc[32] = {}, dp[32] = {};
  uint32_t fa[4][4] = {}, fb[4][4] = {};

  // the q role's two rows' statistics, for every iteration
  const int row0 = r0 + warp * 16 + g, row1 = row0 + 8;
  float lq0 = 0.f, lq1 = 0.f, dq0 = 0.f, dq1 = 0.f;
  float nl = 0.f, nd = 0.f;           // kv role: iteration u + 2's row
  if (kv_role) {
    if (tid < WR) {
      stat_row(0, stat[tid], stat[128 + tid]);
      if (n_it > 1) stat_row(1, stat[64 + tid], stat[192 + tid]);
    }
    __syncthreads();
  } else {
    const size_t at = (static_cast<size_t>(b) * H + head) * S;
    if (row0 < S) {
      lq0 = lse[at + row0] * LOG2E;
      dq0 = dvec[at + row0];
    }
    if (row1 < S) {
      lq1 = lse[at + row1] * LOG2E;
      dq1 = dvec[at + row1];
    }
  }
  hopper::mbar_wait(bar_own, 0);

  for (int u = 0; u < n_it; ++u) {
    const int s = u & 1;
    if (kv_role && tid < WR && u + 2 < n_it) stat_row(u + 2, nl, nd);
    int hh, rr;
    stream_at(u, hh, rr);
    const uint32_t sa = hopper::smem_addr(ring + s * 2 * C::TILE);
    const uint32_t sb = sa + C::TILE;
    hopper::mbar_wait(&full[s], (u >> 1) & 1);
    hopper::wgmma_fence();
    // kv role: S^T = K Q^T, dP^T = V dO^T (rows keys, columns queries);
    // q role: S = Q K^T, dP = dO V^T (rows queries, columns keys)
    wgmma_rows<HD>(sc, own_a, sa);
    wgmma_rows<HD>(dp, own_b, sb);
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sc);
    // P (kv role: P^T) from the forward's log-sum-exp; masked on the
    // diagonal tile and past S
    const bool edge = rr == r0 || rr + WR > S || r0 + WR > S;
    const float* lcol = stat + s * 64;
    const float* dcol = stat + 128 + s * 64;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);   // column in the tile
        const int rl = warp * 16 + g + (e < 2 ? 0 : 8);
        int key, query;
        float l2;
        if (kv_role) {
          key = r0 + rl;
          query = rr + c;
          l2 = lcol[c];
        } else {
          key = rr + c;
          query = r0 + rl;
          l2 = e < 2 ? lq0 : lq1;
        }
        float p = ex2(fmaf(sc[4 * n + e], scale_log2, -l2));
        if (edge && (key > query || query >= S)) p = 0.f;
        sc[4 * n + e] = p;
      }
    if (kv_role) {   // dV += P^T dO, queued behind dP^T
      wgmma_frag<HD>(acc1, sc, fa, sb);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();   // dP^T (the older group) is done
    } else {
      hopper::wgmma_wait<0>();
    }
    hopper::fence_regs(dp);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = kv_role ? dcol[8 * n + 2 * t + (e & 1)]
                                : (e < 2 ? dq0 : dq1);
        dp[4 * n + e] = sc[4 * n + e] * (dp[4 * n + e] - d);   // dS
      }
    // kv role: dK += dS^T Q; q role: dQ += dS K
    wgmma_frag<HD>(acc0, dp, fb, sa);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc0);
    hopper::fence_regs(acc1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // the fragments lived until here
      hopper::fence_regs(fa[kk]);
      hopper::fence_regs(fb[kk]);
    }
    __syncthreads();           // stage s and its statistics are consumed
    if (u + 2 < n_it) {
      if (tid == 0) load_stream(u + 2);
      if (kv_role && tid < WR) {
        stat[s * 64 + tid] = nl;
        stat[128 + s * 64 + tid] = nd;
      }
    }
  }

  if (kv_role) {
    const size_t row = static_cast<size_t>(K) * HD;
    const size_t base = static_cast<size_t>(b) * S * row +
                        static_cast<size_t>(head) * HD;
    store_rows<HD>(dk + base, acc0, scale, r0, S, row);
    store_rows<HD>(dv + base, acc1, 1.f, r0, S, row);
  } else {
    const size_t row = static_cast<size_t>(H) * HD;
    store_rows<HD>(dq + static_cast<size_t>(b) * S * row +
                       static_cast<size_t>(head) * HD,
                   acc0, scale, r0, S, row);
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, void* dq, void* dk,
                 void* dv, float* dvec, int B, int S, int K, int G,
                 float scale, cudaStream_t stream) {
  using C = WCfg<HD>;
  const int H = K * G;
  const uint64_t row = HD * 2;
  CUtensorMap tq, tk, tv, tdo;
  const uint64_t q_dims[4] = {HD, static_cast<uint64_t>(H),
                              static_cast<uint64_t>(S),
                              static_cast<uint64_t>(B)};
  const uint64_t q_strides[3] = {row, H * row, S * H * row};
  const uint64_t kv_dims[4] = {HD, static_cast<uint64_t>(K),
                               static_cast<uint64_t>(S),
                               static_cast<uint64_t>(B)};
  const uint64_t kv_strides[3] = {row, K * row, S * K * row};
  const uint32_t box[4] = {64, 1, WR, 1};
  if (!hopper::bf16_map_4d(&tq, q, q_dims, q_strides, box) ||
      !hopper::bf16_map_4d(&tdo, dout, q_dims, q_strides, box) ||
      !hopper::bf16_map_4d(&tk, k, kv_dims, kv_strides, box) ||
      !hopper::bf16_map_4d(&tv, v, kv_dims, kv_strides, box))
    return static_cast<int>(cudaErrorNotSupported);
  auto kern = k7b_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = B * S * H;
  k7b_dvec_kernel<<<(rows + 15) / 16, 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), dvec,
      rows, S, H, HD);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int nt = (S + WR - 1) / WR;
  const int n_kv = nt * K * B, n_q = nt * H * B;
  kern<<<n_kv + n_q, WTHREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, lse, dvec, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, K, G, B, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

template <typename T, int HDMAX>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv, float* lse,
               float* dvec, int B, int S, int K, int G, int hd, float scale,
               cudaStream_t stream) {
  const int ld = hd + 1, H = K * G;
  const size_t smem_stats = sizeof(float) * (SQ + TK) * ld;
  const size_t smem_kv = sizeof(float) *
      (2 * (TK + TQ) * ld + 2 * TK * (TQ + 1) + 2 * TQ);
  const size_t smem_q = sizeof(float) *
      (2 * (TK + TQ) * ld + TQ * (TK + 1) + 2 * TQ);
  auto stats = k7b_stats_kernel<T>;
  auto dkdv = k7b_dkdv_kernel<T, HDMAX>;
  auto dqk = k7b_dq_kernel<T, HDMAX>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(stats,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem_stats))) ||
      (err = cudaFuncSetAttribute(dkdv,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem_kv))) ||
      (err = cudaFuncSetAttribute(dqk,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem_q))))
    return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* dot = static_cast<const T*>(dout);
  stats<<<dim3((S + SQ - 1) / SQ, H, B), THREADS, smem_stats, stream>>>(
      qt, kt, ot, dot, lse, dvec, S, K, G, hd, scale);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  dkdv<<<dim3((S + TK - 1) / TK, K, B), THREADS, smem_kv, stream>>>(
      qt, kt, vt, dot, lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv),
      S, K, G, hd, scale);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  dqk<<<dim3((S + TQ - 1) / TQ, H, B), THREADS, smem_q, stream>>>(
      qt, kt, vt, dot, lse, dvec, static_cast<T*>(dq), S, K, G, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, float* lse,
             float* dvec, int B, int S, int K, int G, int hd, float scale,
             cudaStream_t s) {
  if (hd <= 64)
    return launch_bwd<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, dvec, B, S, K,
                             G, hd, scale, s);
  if (hd <= 128)
    return launch_bwd<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, dvec, B, S,
                              K, G, hd, scale, s);
  return launch_bwd<T, 256>(q, k, v, o, dout, dq, dk, dv, lse, dvec, B, S, K,
                            G, hd, scale, s);
}

}  // namespace

// q, o, dout, dq: (B, S, K, G, hd); k, v, dk, dv: (B, S, K, hd); all
// contiguous, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1, every
// pointer 16-byte aligned).  hd a multiple of 16 in [16, 256].  lse: the
// forward's (B, K, G, S) float32 log-sum-exp of each row's scaled causal
// scores; read (and required) by the bfloat16 hd 64 / 128 route only.
// scratch: B * K * G * S floats (D) on that route, 2 * B * K * G * S (each
// row's log-sum-exp, then D) on the others; n_scratch: its length in
// floats, cudaErrorInvalidValue (and no launch) when shorter.  Every
// element of dq, dk and dv is written.  Returns cudaGetLastError() after the last launch.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse_in,
                                   void* dq, void* dk, void* dv,
                                   float* scratch, long long n_scratch,
                                   int is_bf16, int B, int S,
                                   int K, int G, int hd, float scale,
                                   void* stream) {
  if (B < 0 || S < 0 || K < 1 || G < 1 || hd < 16 || hd > 256 || hd % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wgmma = is_bf16 && (hd == 64 || hd == 128);
  if (wgmma && (lse_in == nullptr ||
                ((reinterpret_cast<uintptr_t>(q) |
                  reinterpret_cast<uintptr_t>(k) |
                  reinterpret_cast<uintptr_t>(v) |
                  reinterpret_cast<uintptr_t>(o) |
                  reinterpret_cast<uintptr_t>(dout) |
                  reinterpret_cast<uintptr_t>(dq) |
                  reinterpret_cast<uintptr_t>(dk) |
                  reinterpret_cast<uintptr_t>(dv)) & 15)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * K * G * S;
  if (n_scratch < (wgmma ? rows : 2 * rows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma) {
    if (hd == 64)
      return launch_wgmma<64>(q, k, v, o, dout, lse_in, dq, dk, dv, scratch,
                              B, S, K, G, scale, s);
    return launch_wgmma<128>(q, k, v, o, dout, lse_in, dq, dk, dv, scratch,
                             B, S, K, G, scale, s);
  }
  float* lse = scratch;
  float* dvec = scratch + static_cast<size_t>(B) * K * G * S;
  if (is_bf16 && hd <= 128) {
    if (hd <= 32)
      return launch_mma<32>(q, k, v, o, dout, dq, dk, dv, lse, dvec, B, S, K,
                            G, hd, scale, s);
    if (hd <= 64)
      return launch_mma<64>(q, k, v, o, dout, dq, dk, dv, lse, dvec, B, S, K,
                            G, hd, scale, s);
    return launch_mma<128>(q, k, v, o, dout, dq, dk, dv, lse, dvec, B, S, K,
                           G, hd, scale, s);
  }
  if (is_bf16)
    return dispatch<bf16>(q, k, v, o, dout, dq, dk, dv, lse, dvec, B, S, K, G,
                          hd, scale, s);
  return dispatch<float>(q, k, v, o, dout, dq, dk, dv, lse, dvec, B, S, K, G,
                         hd, scale, s);
}
