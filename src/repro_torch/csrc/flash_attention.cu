// K7 — GQA causal flash attention (forward) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_fwd`
// (src/repro/kernels/flash_attention/kernel.py, body `_flash_kernel`).
// It computes the same function: for each batch b, query head h = kv_head
// * G + group and query position i,
//
//   out[b,i,kv,g,:] = sum_{j <= i} softmax_j(scale * q[b,i,kv,g,:].k[b,j,kv,:])
//                     * v[b,j,kv,:]
//
// with q (B,S,K,G,hd) and k, v (B,S,K,hd), all float32 or all bfloat16.
// Scores, the running max, the running sum and the accumulator are float32
// (an online softmax); masked scores are the finite -1e30, the final divide
// guards with max(l, 1e-20), and the output is rounded to q's dtype once.
// Only the key tiles at or below the diagonal are visited, and only the
// diagonal tile is masked.
//
// What bounds it on this card: causal attention at the llama3.2-3b prefill
// (B=4, S=2048, K=8, G=3, hd=128, bf16) needs 4*B*H*hd*S(S+1)/2 = 1.03e11
// operations against ~134 MB of q, k, v and output, so it is bound by
// operations: 0.104 ms at the 989 TFLOP/s bf16 tensor-core peak.  P.V is
// done twice (P's bf16 high and low parts, below), so this design's floor
// is 1.5x that, 0.156 ms.  Kernels by input:
//
// bfloat16, hd 64 / 128 / 256 (the serving path): wgmma + TMA,
// warp-specialised.  A block owns 128 query rows of one (b, head): two
// consumer warpgroups of 64 rows (wgmma's m64) and one producer
// warpgroup, whose one thread (after `setmaxnreg` hands its registers to
// the consumers) loads q once and keeps 128-key tiles of K and V (64 for
// hd 256) in flight by TMA, 128-byte swizzled, in a 3-stage ring (2 for
// hd 256) with a full barrier per tile and operand and an empty barrier
// per stage.  S = q.K^T is wgmma m64n128k16 with both operands in shared
// memory; the softmax runs on the accumulator registers with exp2 on the
// special-function unit and scale * log2(e) folded into its argument; P is
// split into a bf16 high part and a bf16 low part (p - hi), the register
// A operands of two wgmmas against V, read row-major from shared memory
// through the descriptor's transpose (no hand transpose).  The split keeps
// ~16 bits of P, float32-grade as the plain version's float32 P.V.  The
// next tile's S is queued on the tensor cores behind this tile's P.V, and
// the two consumer warpgroups take turns to issue (named barriers), so one
// warpgroup's softmax overlaps the other's matrix products.  Query tiles
// are issued latest first (the longest rows of the triangle).  Tensor
// maps are encoded on the host (cuTensorMapEncodeTiled, looked up through
// the runtime) and passed as __grid_constant__.
//
// bfloat16, other hd (16, 32, 48, ..., 240): mma.sync m16n8k16.  One block
// of 4 warps per (64 query rows, head, batch); each warp owns 16 rows.  q,
// then 64 keys of K and of V (V transposed) at a time are staged in shared
// memory, rows padded by 16 bytes; P is split into bf16 high + low parts
// as above.
//
// float32: the same schedule on float32 FMAs out of shared memory (tensor
// cores would need TF32, which would change the numbers): one block of 256
// threads per (64 query rows, head, batch), K / V staged 32 rows at a time,
// each thread owning 4 rows and a 4x2 block of scores, the row max / sum
// 16-lane shuffle reductions, P through shared memory for the P.V product.
// Bound by shared-memory bandwidth (one 4-byte load per ~1.5 FMAs).
//
// Any hd that is a multiple of 16 up to 256 and any S run; the wrapper
// enforces what the JAX kernel accepts.
//
// Optional output: each row's float32 log-sum-exp of its scaled causal
// scores, lse[b, h, i] = max + log(sum), for the backward (K7b), which
// then needs no statistics sweep of its own.  Every kernel takes it as a
// pointer that may be null (the serving path passes none): a row's four
// (or sixteen) lanes already hold its max and sum, so writing it costs
// one store per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// float32: FMAs from shared memory
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // key / value rows per staged tile
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
constexpr int RPT = BQ / 16;  // query rows per thread
constexpr int CPT = BK / 16;  // score columns per thread

template <int HDMAX>
__global__ void __launch_bounds__(THREADS)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int S, int K, int G,
                           int hd, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;               // padded row stride of the tiles
  float* qs = smem;                    // BQ x ld
  float* ks = qs + BQ * ld;            // BK x ld
  float* vs = ks + BK * ld;            // BK x ld
  float* ps = vs + BK * ld;            // BQ x (BK + 1)

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / G, g = h - kh * G;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;             // row group: rows rg*RPT .. +RPT-1
  const int cl = tid & 15;             // column lane
  const size_t q_row = static_cast<size_t>(K) * G * hd;
  const size_t kv_row = static_cast<size_t>(K) * hd;
  const size_t q_off = static_cast<size_t>(b) * S * q_row +
                       (static_cast<size_t>(kh) * G + g) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_row +
                        static_cast<size_t>(kh) * hd;

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    const int qp = q0 + r;
    qs[r * ld + d] = qp < S ? q[q_off + static_cast<size_t>(qp) * q_row + d]
                            : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][HDMAX / 16];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < HDMAX / 16; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;  // last real query row
  for (int k0 = 0; k0 <= q_last; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < BK * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      const int kp = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kp < S) {
        const size_t at = kv_off + static_cast<size_t>(kp) * kv_row + d;
        kv = k[at];
        vv = v[at];
      }
      ks[r * ld + d] = kv;
      vs[r * ld + d] = vv;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(rg * RPT + i) * ld + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(cl + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = q0 + rg * RPT + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = k0 + cl + 16 * j;
        const float x = (kp <= qp && kp < S) ? s[i][j] * scale : NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < HDMAX / 16; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        ps[(rg * RPT + i) * (BK + 1) + cl + 16 * j] = s[i][j];
    }
    __syncwarp();  // a row group's P is read back by its own 16 lanes only

#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(rg * RPT + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < HDMAX / 16; ++j) {
        const int d = cl + 16 * j;
        if (d < hd) {
          const float vv = vs[c * ld + d];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + rg * RPT + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    if (lse != nullptr && cl == 0)
      lse[(static_cast<size_t>(b) * K * G + h) * S + qp] = m[i] + logf(l[i]);
    float* orow = o + q_off + static_cast<size_t>(qp) * q_row;
#pragma unroll
    for (int j = 0; j < HDMAX / 16; ++j) {
      const int d = cl + 16 * j;
      if (d < hd) orow[d] = acc[i][j] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MQ = 64;          // query rows per block: 4 warps x 16
constexpr int MK = 64;          // keys per staged tile
constexpr int MTHREADS = 128;
constexpr int PAD = 8;          // bf16 elements of row padding (16 bytes)

typedef __nv_bfloat16 bf16;
using bf16mma::ld32;
using bf16mma::mma16816;
using bf16mma::split;

template <int HDMAX>
__global__ void __launch_bounds__(MTHREADS)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int S, int K, int G,
                           int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldq = hd + PAD;            // q / K tile row stride
  const int ldv = MK + PAD;            // V^T tile row stride
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // MQ x ldq
  bf16* ks = qs + MQ * ldq;                       // MK x ldq
  bf16* vt = ks + MK * ldq;                       // hd x ldv (V transposed)

  const int q0 = blockIdx.x * MQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / G, grp = h - kh * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const size_t q_row = static_cast<size_t>(K) * G * hd;
  const size_t kv_row = static_cast<size_t>(K) * hd;
  const size_t q_off = static_cast<size_t>(b) * S * q_row +
                       (static_cast<size_t>(kh) * G + grp) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_row +
                        static_cast<size_t>(kh) * hd;
  const int cpr = hd / 8;              // 16-byte chunks per row

  for (int i = tid; i < MQ * cpr; i += MTHREADS) {
    const int r = i / cpr, c = i - r * cpr;
    const int qp = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (qp < S)
      val = *reinterpret_cast<const uint4*>(
          q + q_off + static_cast<size_t>(qp) * q_row + c * 8);
    *reinterpret_cast<uint4*>(qs + r * ldq + c * 8) = val;
  }

  constexpr int NT = HDMAX / 8;        // output n-tiles of 8 features
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const bf16* qa_base = qs + (warp * 16 + g) * ldq + 2 * t;

  const int q_last = min(q0 + MQ, S) - 1;
  for (int k0 = 0; k0 <= q_last; k0 += MK) {
    __syncthreads();  // the previous tile's K and V are consumed
    for (int i = tid; i < MK * cpr; i += MTHREADS) {
      const int r = i / cpr, c = i - r * cpr;  // coalesced along the row
      const int kp = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      if (kp < S)
        kv = *reinterpret_cast<const uint4*>(
            k + kv_off + static_cast<size_t>(kp) * kv_row + c * 8);
      *reinterpret_cast<uint4*>(ks + r * ldq + c * 8) = kv;
    }
    // V transposed: neighbouring threads take neighbouring keys, so their
    // 2-byte stores into a row of V^T share banks without conflicts
    for (int i = tid; i < MK * cpr; i += MTHREADS) {
      const int c = i / MK, r = i - c * MK;
      const int kp = k0 + r;
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (kp < S)
        vv = *reinterpret_cast<const uint4*>(
            v + kv_off + static_cast<size_t>(kp) * kv_row + c * 8);
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(c * 8 + e) * ldv + r] = ve[e];
    }
    __syncthreads();

    // S = q.K^T for the warp's 16 rows x 64 keys: 8 n-tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int kk = 0; kk < hd; kk += 16) {
      uint32_t a[4];
      a[0] = ld32(qa_base + kk);
      a[1] = ld32(qa_base + 8 * ldq + kk);
      a[2] = ld32(qa_base + kk + 8);
      a[3] = ld32(qa_base + 8 * ldq + kk + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* kb = ks + (8 * j + g) * ldq + kk + 2 * t;
        mma16816(s[j], a, ld32(kb), ld32(kb + 8));
      }
    }

    // online softmax on the fragments: e = 0, 1 -> row0; e = 2, 3 -> row1
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * t + (e & 1);
        const int qp = e < 2 ? row0 : row1;
        s[j][e] = (kp <= qp && kp < S) ? s[j][e] * scale : NEG_INF;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
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
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    l0 = l0 * c0 + rs0;
    l1 = l1 * c1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }

    // acc += P.V: the score fragments of n-tiles 2kk, 2kk+1 are the A
    // fragment of keys 16kk .. 16kk+15
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      split(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      split(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (8 * n < hd) {
          const bf16* vb = vt + (8 * n + g) * ldv + 16 * kk + 2 * t;
          const uint32_t b0 = ld32(vb), b1 = ld32(vb + 8);
          mma16816(acc[n], ah, b0, b1);
          mma16816(acc[n], al, b0, b1);
        }
      }
    }
  }

  const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
  if (lse != nullptr && t == 0) {
    float* lrow = lse + (static_cast<size_t>(b) * K * G + h) * S;
    if (row0 < S) lrow[row0] = m0 + logf(l0);
    if (row1 < S) lrow[row1] = m1 + logf(l1);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (8 * n >= hd) continue;
    const int d = 8 * n + 2 * t;
    if (row0 < S) {
      const __nv_bfloat162 w =
          __floats2bfloat162_rn(acc[n][0] / d0, acc[n][1] / d0);
      *reinterpret_cast<__nv_bfloat162*>(
          o + q_off + static_cast<size_t>(row0) * q_row + d) = w;
    }
    if (row1 < S) {
      const __nv_bfloat162 w =
          __floats2bfloat162_rn(acc[n][2] / d1, acc[n][3] / d1);
      *reinterpret_cast<__nv_bfloat162*>(
          o + q_off + static_cast<size_t>(row1) * q_row + d) = w;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16, hd 64 / 128 / 256: wgmma + TMA, one producer warpgroup
// ---------------------------------------------------------------------------

constexpr int WM = 128;          // query rows per block: 2 consumer warpgroups
constexpr int WTHREADS = 384;    // consumer warpgroups 0, 1; producer 2
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
struct WCfg {
  static constexpr int BN = HD == 256 ? 64 : 128;  // keys per K / V tile
  static constexpr int STAGES = HD == 256 ? 2 : 3;  // K / V ring depth
  static constexpr int NCH = HD / 64;              // 128-byte column chunks
  static constexpr int Q_CHUNK = WM * 128;         // bytes of one q chunk
  static constexpr int KV_CHUNK = BN * 128;
  static constexpr int Q_BYTES = NCH * Q_CHUNK;
  static constexpr int KV_BYTES = NCH * KV_CHUNK;  // one K or V tile
  // tiles, 1 KB of barriers, 1 KB to align the tiles to the swizzle line
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 2048;
};

// 2^x on the special-function unit (flushes subnormal results to zero:
// those probabilities are below 2^-126 of the row's largest)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// named barriers between the two consumer warpgroups (256 threads; id 0 is
// __syncthreads')
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_scores(float (&d)[N / 2], uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (N == 64) hopper::wgmma_ss_n64(d, da, db, scale_d);
  else hopper::wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) hopper::wgmma_rs_n64(d, a, db, 1);
  else if constexpr (N == 128) hopper::wgmma_rs_n128(d, a, db, 1);
  else hopper::wgmma_rs_n256(d, a, db, 1);
}

// q / o are 4-D tensor maps over (hd, H, S, B), k / v over (hd, K, S, B),
// all with 64-column boxes in the 128-byte swizzle layout.  Block
// (b * H + h, y) owns query rows q0 .. q0 + 127 of head h, q0 counted from
// the end (the longest rows of the causal triangle start first).  LSE: the
// variant that also writes each row's log-sum-exp (after the output, when
// the accumulator is dead), so the serving path's variant keeps its
// registers.
template <int HD, bool LSE>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             bf16* __restrict__ o, float* __restrict__ lse,
                             int S, int H, int G, float scale_log2) {
  using C = WCfg<HD>;
  constexpr int BN = C::BN, STAGES = C::STAGES, NCH = C::NCH;
  extern __shared__ __align__(1024) unsigned char wsmem[];
  unsigned char* sq =
      wsmem + ((1024 - (hopper::smem_addr(wsmem) & 1023)) & 1023);
  unsigned char* sk = sq + C::Q_BYTES;             // STAGES K tiles
  unsigned char* sv = sk + STAGES * C::KV_BYTES;   // STAGES V tiles
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sv + STAGES * C::KV_BYTES);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;

  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int kh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WM;
  const int n_kt = (min(q0 + WM, S) - 1) / BN + 1;  // tiles up to the diagonal
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty[s], 256);   // every consumer thread
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the K / V ring full by TMA --------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      hopper::mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int c = 0; c < NCH; ++c)
        hopper::tma_load_4d(sq + c * C::Q_CHUNK, &tq, bar_q, c * 64, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) hopper::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full_k[s], C::KV_BYTES);
        for (int c = 0; c < NCH; ++c)
          hopper::tma_load_4d(sk + s * C::KV_BYTES + c * C::KV_CHUNK, &tk,
                              &full_k[s], c * 64, kh, j * BN, b);
        hopper::mbar_expect_tx(&full_v[s], C::KV_BYTES);
        for (int c = 0; c < NCH; ++c)
          hopper::tma_load_4d(sv + s * C::KV_BYTES + c * C::KV_CHUNK, &tv,
                              &full_v[s], c * 64, kh, j * BN, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows r0 .. r0 + 63 --------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;   // accumulator row / column pair
    const int r0 = q0 + wg * 64;
    const int row0 = r0 + warp * 16 + g, row1 = row0 + 8;
    const uint32_t q_base = hopper::smem_addr(sq) + wg * 64 * 128;

    float acc[HD / 2], sc[BN / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

    // S = q.K^T of key tile j into sc: both operands K-major in shared
    // memory (issued, not waited for)
    auto issue_scores = [&](int j) {
      const int s = j % STAGES;
      hopper::mbar_wait(&full_k[s], (j / STAGES) & 1);
      const uint32_t k_base = hopper::smem_addr(sk + s * C::KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_scores<BN>(
            sc, hopper::desc_sw128(q_base + (kk >> 2) * C::Q_CHUNK + off, 16,
                                   1024),
            hopper::desc_sw128(k_base + (kk >> 2) * C::KV_CHUNK + off, 16,
                               1024),
            kk > 0);
      }
      hopper::wgmma_commit();
    };

    hopper::mbar_wait(bar_q, 0);
    hopper::wgmma_fence();
    issue_scores(0);
    if (wg == 1) named_arrive(1);   // warpgroup 0 issues first
    hopper::wgmma_wait<0>();
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % STAGES;
      // online softmax on the raw scores (scale > 0 keeps the max), the
      // scale folded into exp2's argument; only the diagonal tile is masked
      const int k0 = j * BN;
      if (k0 + BN - 1 > r0) {
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * n + 2 * t + (e & 1) > (e < 2 ? row0 : row1))
              sc[4 * n + e] = NEG_INF;
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float b0 = -mn0 * scale_log2, b1 = -mn1 * scale_log2;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        sc[4 * n] = ex2(fmaf(sc[4 * n], scale_log2, b0));
        sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], scale_log2, b0));
        sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], scale_log2, b1));
        sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], scale_log2, b1));
        rs0 += sc[4 * n] + sc[4 * n + 1];
        rs1 += sc[4 * n + 2] + sc[4 * n + 3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
      }
      const float c0 = ex2((m0 - mn0) * scale_log2);
      const float c1 = ex2((m1 - mn1) * scale_log2);
      l0 = l0 * c0 + rs0;
      l1 = l1 * c1 + rs1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[4 * n] *= c0;
        acc[4 * n + 1] *= c0;
        acc[4 * n + 2] *= c1;
        acc[4 * n + 3] *= c1;
      }
      // P as the A operand of P.V, a bf16 high and a bf16 low part; the
      // fragments of score n-tiles 2kk, 2kk+1 are keys 16kk .. 16kk+15
      uint32_t ph[BN / 16][4], pl[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r],
                     pl[kk][r]);

      // acc += P.V, V row-major in shared memory read through the
      // descriptor's transpose; then the next tile's scores queue behind it.
      // The two warpgroups take turns to issue (named barriers 1, 2), so
      // one's softmax overlaps the other's tensor-core work
      hopper::mbar_wait(&full_v[s], (j / STAGES) & 1);
      const uint32_t v_base = hopper::smem_addr(sv + s * C::KV_BYTES);
      named_sync(1 + wg);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db =
            hopper::desc_sw128(v_base + kk * 2048, C::KV_CHUNK, 1024);
        wgmma_pv<HD>(acc, ph[kk], db);
        wgmma_pv<HD>(acc, pl[kk], db);
      }
      hopper::wgmma_commit();
      if (j + 1 < n_kt) issue_scores(j + 1);
      if (wg == 0 || j + 1 < n_kt) named_arrive(2 - wg);
      if (j + 1 < n_kt) {
        hopper::wgmma_wait<1>();   // P.V of tile j is done
        hopper::mbar_arrive(&empty[s]);
        hopper::wgmma_wait<0>();
      } else {
        hopper::wgmma_wait<0>();
        hopper::mbar_arrive(&empty[s]);
      }
    }

    const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
    bf16* o0 = o + (static_cast<size_t>(b) * S + row0) * H * HD +
               static_cast<size_t>(h) * HD + 2 * t;
    bf16* o1 = o0 + static_cast<size_t>(8) * H * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if (row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n] / d0, acc[4 * n + 1] / d0);
      if (row1 < S)
        *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
    }
    if (LSE && t == 0) {
      // m is the raw scores' max: lse = scale m + log(l)
      const float scale = scale_log2 * LN2;
      float* lrow = lse + (static_cast<size_t>(b) * H + h) * S;
      if (row0 < S) lrow[row0] = fmaf(m0, scale, logf(l0));
      if (row1 < S) lrow[row1] = fmaf(m1, scale, logf(l1));
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int HDMAX>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int K, int G, int hd, float scale,
               cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((BQ + 2 * BK) * (hd + 1) + BQ * (BK + 1));
  auto kern = flash_attention_f32_kernel<HDMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, K * G, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, K, G,
      hd, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HDMAX>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int K, int G, int hd, float scale,
               cudaStream_t stream) {
  const size_t smem =
      sizeof(bf16) * ((MQ + MK) * (hd + PAD) + hd * (MK + PAD));
  auto kern = flash_attention_mma_kernel<HDMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + MQ - 1) / MQ, K * G, B);
  kern<<<grid, MTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, S, K, G, hd,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int S, int K, int G, float scale,
                 cudaStream_t stream) {
  using C = WCfg<HD>;
  const uint64_t H = static_cast<uint64_t>(K) * G, row = HD * 2;
  CUtensorMap tq, tk, tv;
  const uint64_t q_dims[4] = {HD, H, static_cast<uint64_t>(S),
                              static_cast<uint64_t>(B)};
  const uint64_t q_strides[3] = {row, H * row, S * H * row};
  const uint32_t q_box[4] = {64, 1, WM, 1};
  const uint64_t kv_dims[4] = {HD, static_cast<uint64_t>(K),
                               static_cast<uint64_t>(S),
                               static_cast<uint64_t>(B)};
  const uint64_t kv_strides[3] = {row, K * row, S * K * row};
  const uint32_t kv_box[4] = {64, 1, C::BN, 1};
  if (!hopper::bf16_map_4d(&tq, q, q_dims, q_strides, q_box) ||
      !hopper::bf16_map_4d(&tk, k, kv_dims, kv_strides, kv_box) ||
      !hopper::bf16_map_4d(&tv, v, kv_dims, kv_strides, kv_box))
    return static_cast<int>(cudaErrorNotSupported);
  auto kern = lse != nullptr ? flash_attention_wgmma_kernel<HD, true>
                             : flash_attention_wgmma_kernel<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * H), (S + WM - 1) / WM);
  kern<<<grid, WTHREADS, C::SMEM, stream>>>(tq, tk, tv, static_cast<bf16*>(o),
                                            lse, S, static_cast<int>(H), G,
                                            scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

#define FA_DISPATCH(LAUNCH)                                                  \
  if (hd <= 16) return LAUNCH<16>(q, k, v, o, lse, B, S, K, G, hd, scale, s); \
  if (hd <= 32) return LAUNCH<32>(q, k, v, o, lse, B, S, K, G, hd, scale, s); \
  if (hd <= 64) return LAUNCH<64>(q, k, v, o, lse, B, S, K, G, hd, scale, s); \
  if (hd <= 128)                                                             \
    return LAUNCH<128>(q, k, v, o, lse, B, S, K, G, hd, scale, s);           \
  return LAUNCH<256>(q, k, v, o, lse, B, S, K, G, hd, scale, s);

}  // namespace

// q, o: (B, S, K, G, hd); k, v: (B, S, K, hd); all contiguous, float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1, every pointer 16-byte aligned).
// lse: null, or (B, K, G, S) float32, each row's log-sum-exp of its scaled
// causal scores.  hd a multiple of 16 in [16, 256].  Every element of o
// (and of lse) is written.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, float* lse, int is_bf16, int B,
                               int S, int K, int G, int hd, float scale,
                               void* stream) {
  if (B < 0 || S < 0 || K < 1 || G < 1 || hd < 16 || hd > 256 || hd % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && ((reinterpret_cast<uintptr_t>(q) |
                   reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v) |
                   reinterpret_cast<uintptr_t>(o)) & 15))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (hd == 64)
      return launch_wgmma<64>(q, k, v, o, lse, B, S, K, G, scale, s);
    if (hd == 128)
      return launch_wgmma<128>(q, k, v, o, lse, B, S, K, G, scale, s);
    if (hd == 256)
      return launch_wgmma<256>(q, k, v, o, lse, B, S, K, G, scale, s);
    FA_DISPATCH(launch_mma)
  }
  FA_DISPATCH(launch_f32)
}
