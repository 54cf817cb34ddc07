// K8b — Mamba-2 SSD intra-chunk backward for NVIDIA Hopper (sm_90a), on
// 3xTF32 tensor cores.
//
// Replaces no Pallas kernel: the JAX package differentiates its Pallas
// forward `ssd_intra_chunk` through the `jax.custom_vjp` of `ssd_scan`,
// whose backward is `jax.vjp` of the oracle `ssd_ref`
// (src/repro/kernels/ssd_scan/ops.py, `_bwd`).  It differentiates K8's
// function (csrc/ssd_intra_chunk.cu): per batch b, chunk c and head h, with
// x, dy (Q,hp), cum, dt (Q,) of that head, dst (hp,ds) the gradient of its
// chunk state, and B, C (Q,ds) shared by all heads,
//
//   CB[q,s] = C[q,:] . B[s,:],  L[q,s] = exp(cum[q] - cum[s]) for s <= q
//   (masked before the exp: entries above the diagonal are 0 and carry no
//   gradient), w = CB L dt[s], E[s] = exp(cum[Q-1] - cum[s]), sd = E dt,
//   u[s,p] = B[s,:] . dst[p,:]
//
//   dw[q,s]  = dy[q,:] . x[s,:]                          (s <= q)
//   dx[s,:]  = sum_q w[q,s] dy[q,:] + sd[s] u[s,:]
//   g        = dw w,   dsd[s] = x[s,:] . u[s,:]
//   dcum[i]  = sum_s g[i,s] - sum_q g[q,i] - dsd[i] sd[i]
//              + [i = Q-1] sum_s dsd[s] sd[s]
//   ddt[s]   = sum_q dw[q,s] CB[q,s] L[q,s] + dsd[s] E[s]
//   dCB      = sum_h dw L dt[s],   dC = dCB B
//   dB       = dCB^T C + sum_h (sd x)^T dst
//
// all in float32.  The diagonal's terms of dcum (q = s, and s = Q-1 in the
// state's term) cancel in exact arithmetic; they are computed and summed,
// as the vjp computes them, not dropped.
//
// What bounds it on this card: at the mamba2-780m training shape (B=8,
// nc=1, Q=256, nh=48, hp=64, ds=128) the products need ~6.7e9 operations
// (dw and the w-term of dx over the causal triangle, u and the state term
// of dB over Q x ds x hp, per head; CB, dC and dB's CB term per chunk)
// against ~94 MB of inputs and outputs: 0.10 ms at 67 TFLOP/s on float32
// FMAs, 0.028 ms for the bytes.  Every product here runs as 3xTF32
// mma.sync m16n8k8 (csrc/tf32x3.cuh's MMA, the operands split by
// truncation, `split_trunc`: ~2^-19 relative per product, float32 sums):
// 3 x 6.7e9 operations at 495 TFLOP/s, ~0.041 ms.  Like K1 and K8, these
// mma.sync kernels reach a small share of that bound (chip_smoke prints
// it); wgmma is the way to the TF32 peak.
//
// Design: four kernels, launched in this order on the caller's stream.
// Operands are staged row-major by cp.async in the layouts the fragment
// loaders read without bank conflicts; no product runs on FMAs.  For the
// cross-head sums the heads are cut into NG = min(nh, 3) groups of
// ceil(nh / NG) (dCB) and NGS = min(nh, 6) groups (dB's state term).
//   ssd_bwd_dcb_tf32_kernel  one block of 8 warps per (64 x 64 tile (q, s)
//                       on or below the diagonal, head group, b * nc): CB
//                       of the tile, then the group's heads in order, their
//                       dy / x tiles in a 2-stage ring: dw = dy x^T, then on
//                       the fragments dCB += dw L dt and the tile's per-head
//                       partial sums of g over its columns (dcum's rows), of
//                       g over its rows (dcum's columns) and of dw CB L
//                       (ddt) into a scratch of (B*nc*nh, T, QP) floats
//                       each, T = QP / 64.  Writes the group's partial dCB
//                       tile to a (NG, B*nc, QP, QP) scratch and (group 0)
//                       CB to a (B*nc, QP, QP) one.
//   ssd_bwd_dx_tf32_kernel   one block of 8 warps per (h, c, b), dy and dst
//                       of the head staged once: sd into a (B*nc*nh, QP)
//                       scratch; warp w takes the 16-row strips w and NS-1-w
//                       of s (balanced over the triangle): u = B dst^T (the
//                       strip's 16 rows of B staged at once), dsd = x . u,
//                       then dx = sd u + w^T dy, w^T built on the fragments
//                       from the CB scratch's 16 x 16 chunks, which come
//                       through a 4-deep per-warp cp.async ring; then dcum
//                       and ddt from the partials of its head, summed over
//                       the tiles in order, and the dsd terms.
//   ssd_bwd_dbs_tf32_kernel  one block of 4 warps per (64 rows s, 64 state
//                       columns, head group of NGS, b * nc): the group's
//                       part of sum_h (sd x)^T dst, its heads in order in a
//                       2-stage ring, into a (NGS, B*nc, QP, ds) scratch.
//   ssd_bwd_dbc_tf32_kernel  one block of 4 warps per (64 rows, 64 state
//                       columns, dC or dB, b * nc): dCB tiles as the groups'
//                       partials (all staged at once) summed in group order,
//                       dC = dCB B over the tiles left of the rows, or dB =
//                       dCB^T C over the tiles below plus the state partials
//                       in group order.
// Every output element is written by one thread of one block and every
// sum runs in a fixed order (no atomics), so two launches on the same
// inputs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::FragB;

constexpr int TILE = 64;
constexpr int MAX_Q = 256;
constexpr int MAX_HP = 64;
constexpr int MAX_DS = 128;
constexpr int MAX_GROUPS = 3;     // head groups of dCB
constexpr int MAX_SGROUPS = 6;    // head groups of dB's state term
// staged row strides: LA = 4 (mod 32) for rows read as A row-major or B
// [n][k]; LB = 8 (mod 32) for rows read as B [k][n] or A k-major
constexpr int LA = TILE + 4;
constexpr int LB = TILE + 8;
constexpr int SLAB = TILE * LA;   // one 64 x 64 row-major stage (LA)

__device__ __host__ __forceinline__ int groups_of(int nh) {
  return nh < MAX_GROUPS ? nh : MAX_GROUPS;
}

__device__ __host__ __forceinline__ int sgroups_of(int nh) {
  return nh < MAX_SGROUPS ? nh : MAX_SGROUPS;
}

// The split of an operand for 3xTF32 by truncation: hi = x with its low
// 13 mantissa bits cleared (one AND), lo = x - hi (exact), passed with its
// own low bits, which the tensor core ignores (it reads the top 19 bits of
// a tf32 operand).  Two instructions a value against tf32x3::split's five
// (four of them integer, which issue at half the float rate): |lo| < 2^-10
// |x| and the dropped bits of lo < 2^-20 |x|, so a product keeps ~2^-19 of
// |a||b| against ~2^-21 for the rounded split, far inside K8b's 1e-4.
template <int N>
__device__ __forceinline__ void split_trunc(const float (&v)[N],
                                            uint32_t (&hi)[N],
                                            uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = __float_as_uint(v[i]) & 0xFFFFE000u;
    lo[i] = __float_as_uint(v[i] - __uint_as_float(hi[i]));
  }
}

// acc[j] (j < NJ: n-tiles of 8 columns) += A (16 rows, read by `load_a`)
// . B (the j-th 8 columns, read by `load_b`) over k-steps [0, ksteps) of
// 8, for the first `ntiles` n-tiles: the 3xTF32 passes of four n-tiles
// interleaved, small terms first (as tf32x3::mma3_x4)
template <int NJ, typename LoadA, typename LoadB>
__device__ __forceinline__ void mma_rows(float (&acc)[NJ][4], int ksteps,
                                         int ntiles, LoadA load_a,
                                         LoadB load_b) {
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    float av[4];
    load_a(ks, av);
    FragA a;
    split_trunc(av, a.hi, a.lo);
#pragma unroll
    for (int j0 = 0; j0 < NJ; j0 += 4) {
      if (j0 < ntiles) {
        FragB bf[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float bv[2];
          load_b(ks, j0 + jj, bv);
          split_trunc(bv, bf[jj].hi, bf[jj].lo);
        }
        tf32x3::mma3_x4(acc, j0, a, bf);
      }
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// a 64-float vector, element i = src[i] for i < n, else 0, by 4-byte
// cp.async (the block's first 64 threads)
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int n,
                                          int tid) {
  if (tid < TILE)
    tf32x3::cp_async4(dst + tid, tid < n ? src + tid : src, tid < n);
}

// the (ti, tj) of live tile l: tiles on or below the diagonal, row by row
__device__ __forceinline__ void live_tile(int l, int& ti, int& tj) {
  ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= l) ++ti;
  tj = l - ti * (ti + 1) / 2;
}

// ---------------------------------------------------------------------------
// 1. dCB partials, CB, and the per-tile partial sums of dcum / ddt
// ---------------------------------------------------------------------------

constexpr int DCB_THREADS = 256;   // 8 warps: 4 row strips x 2 halves
// a ring stage: dy rows q and x rows s (64 x LA each), cum q, cum s, dt s
constexpr int DCB_STAGE = 2 * SLAB + 3 * TILE;
constexpr int DCB_SMEM =   // + red_g, red_t [4][64], red_r [2][64]
    sizeof(float) * (2 * DCB_STAGE + 2 * 4 * TILE + 2 * TILE);

__global__ void __launch_bounds__(DCB_THREADS, 2)
ssd_bwd_dcb_tf32_kernel(const float* __restrict__ x,
                        const float* __restrict__ cum,
                        const float* __restrict__ dt,
                        const float* __restrict__ Bc,
                        const float* __restrict__ Cc,
                        const float* __restrict__ dy,
                        float* __restrict__ cbs, float* __restrict__ dcbp,
                        float* __restrict__ prow, float* __restrict__ pcol,
                        float* __restrict__ pddt, int Q, int nh, int hp,
                        int ds, int QP, int x16, int b16) {
  extern __shared__ __align__(16) float smem[];
  float* red_g = smem + 2 * DCB_STAGE;   // [row strip][64]
  float* red_t = red_g + 4 * TILE;       // [row strip][64]
  float* red_r = red_t + 4 * TILE;       // [column half][64]
  int ti, tj;
  live_tile(blockIdx.x, ti, tj);
  const int gi = blockIdx.y, bc = blockIdx.z, BC = gridDim.z;
  const int NG = groups_of(nh), hpg = (nh + NG - 1) / NG;
  const int h_beg = gi * hpg, h_end = min(nh, h_beg + hpg);
  const int T = QP / TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = ti * TILE, s0 = tj * TILE;
  const int qrows = Q - q0, srows = Q - s0;   // real rows of the tiles
  // the warp's 16 rows and 32 columns of the tile
  const int strip = warp & 3, r0 = 16 * strip, c0 = 32 * (warp >> 2);

  // ---- CB of the tile: C rows q . B rows s over the state, 64 at a time
  float cb[4][4];
  zero(cb);
  {
    const float* Cm = Cc + (static_cast<size_t>(bc) * Q + q0) * ds;
    const float* Bm = Bc + (static_cast<size_t>(bc) * Q + s0) * ds;
    for (int n0 = 0; n0 < ds; n0 += 2 * TILE) {
      for (int half = 0; half < 2; ++half) {
        const int nb = n0 + half * TILE;
        const int kn = min(TILE, ds - nb);
        if (kn <= 0) continue;   // no k-step reads this half
        float* st = smem + half * DCB_STAGE;
        tf32x3::stage_rows(st, LA, Cm + nb, ds, TILE, qrows, TILE, kn, b16,
                           tid, DCB_THREADS);
        tf32x3::stage_rows(st + SLAB, LA, Bm + nb, ds, TILE, srows, TILE, kn,
                           b16, tid, DCB_THREADS);
      }
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<0>();
      __syncthreads();
      const int ksteps = (min(2 * TILE, ds - n0) + 7) / 8;
      mma_rows(cb, ksteps, 4,
               [&](int ks, float (&v)[4]) {
                 const int k = 8 * ks;
                 tf32x3::load_a_rm(smem + (k >> 6) * DCB_STAGE + r0 * LA +
                                       (k & 63), LA, v);
               },
               [&](int ks, int j, float (&v)[2]) {
                 const int k = 8 * ks;
                 tf32x3::load_b_nk(smem + (k >> 6) * DCB_STAGE + SLAB +
                                       (c0 + 8 * j) * LA + (k & 63), LA, v);
               });
      __syncthreads();
    }
  }

  // ---- the group's heads, in order ----------------------------------------
  const size_t row = static_cast<size_t>(nh) * hp;   // x / dy row stride
  const int hp8 = (hp + 7) & ~7;
  auto stage_head = [&](int h, int s) {
    float* st = smem + s * DCB_STAGE;
    const size_t xo = static_cast<size_t>(bc) * Q * row + h * hp;
    tf32x3::stage_rows(st, LA, dy + xo + q0 * row, row, TILE, qrows, hp8, hp,
                       x16, tid, DCB_THREADS);
    tf32x3::stage_rows(st + SLAB, LA, x + xo + s0 * row, row, TILE, srows,
                       hp8, hp, x16, tid, DCB_THREADS);
    const size_t hq = (static_cast<size_t>(bc) * nh + h) * Q;
    stage_vec(st + 2 * SLAB, cum + hq + q0, qrows, tid);
    stage_vec(st + 2 * SLAB + TILE, cum + hq + s0, srows, tid);
    stage_vec(st + 2 * SLAB + 2 * TILE, dt + hq + s0, srows, tid);
  };
  const int n_h = max(0, h_end - h_beg);
  for (int i = 0; i < 2; ++i) {
    if (i < n_h) stage_head(h_beg + i, i);
    tf32x3::cp_async_commit();
  }
  float dcb[4][4];
  zero(dcb);
  for (int i = 0; i < n_h; ++i) {
    const int h = h_beg + i, s = i & 1;
    tf32x3::cp_async_wait<1>();
    __syncthreads();                      // head i's stage is in
    const float* st = smem + s * DCB_STAGE;
    const float* cum_q = st + 2 * SLAB;
    const float* cum_s = cum_q + TILE;
    const float* dt_s = cum_s + TILE;
    float dw[4][4];
    zero(dw);
    mma_rows(dw, hp8 / 8, 4,
             [&](int ks, float (&v)[4]) {
               tf32x3::load_a_rm(st + r0 * LA + 8 * ks, LA, v);
             },
             [&](int ks, int j, float (&v)[2]) {
               tf32x3::load_b_nk(st + SLAB + (c0 + 8 * j) * LA + 8 * ks, LA,
                                 v);
             });
    float rg[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float cg[2] = {0.f, 0.f}, ct[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1), c = c0 + 8 * j + 2 * t + (e & 1);
        const int q = q0 + r, sc = s0 + c;
        // mask, then exp: one exp per (q, s) entry on or below the diagonal
        const float ev = (sc <= q && q < Q)
                             ? dw[j][e] * expf(cum_q[r] - cum_s[c])
                             : 0.f;
        const float d = dt_s[c];
        dcb[j][e] = fmaf(ev, d, dcb[j][e]);
        const float tv = ev * cb[j][e];   // dw CB L
        const float gv = tv * d;          // dw w
        rg[e >> 1] += gv;
        cg[e & 1] += gv;
        ct[e & 1] += tv;
      }
      // the column's 16 rows of the warp: a fixed butterfly over g
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          cg[e] += __shfl_xor_sync(0xffffffffu, cg[e], o);
          ct[e] += __shfl_xor_sync(0xffffffffu, ct[e], o);
        }
      if (g == 0)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red_g[strip * TILE + c0 + 8 * j + 2 * t + e] = cg[e];
          red_t[strip * TILE + c0 + 8 * j + 2 * t + e] = ct[e];
        }
    }
    // the rows' sums over the warp's 32 columns
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = rg[e];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0) red_r[(warp >> 2) * TILE + r0 + g + 8 * e] = v;
    }
    __syncthreads();                      // red is complete; the stage is free
    const size_t part = (static_cast<size_t>(bc) * nh + h) * T * QP;
    if (tid < TILE) {   // dcum's columns and ddt: the row strips in order
      float gs = 0.f, ts = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        gs += red_g[w * TILE + tid];
        ts += red_t[w * TILE + tid];
      }
      const size_t o = part + static_cast<size_t>(ti) * QP + s0 + tid;
      pcol[o] = gs;
      pddt[o] = ts;
    } else if (tid < 2 * TILE) {   // dcum's rows: the two column halves
      const int r = tid - TILE;
      prow[part + static_cast<size_t>(tj) * QP + q0 + r] =
          red_r[r] + red_r[TILE + r];
    }
    if (i + 2 < n_h) stage_head(h + 2, s);
    tf32x3::cp_async_commit();
  }

  // ---- the group's dCB tile, and CB (group 0) -----------------------------
  const size_t tile = static_cast<size_t>(q0) * QP + s0;
  float* dcbm = dcbp + (static_cast<size_t>(gi) * BC + bc) * QP * QP + tile;
  float* cbm = cbs + static_cast<size_t>(bc) * QP * QP + tile;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const size_t at = static_cast<size_t>(r0 + g + 8 * e) * QP + c0 +
                        8 * j + 2 * t;
      *reinterpret_cast<float2*>(dcbm + at) =
          make_float2(dcb[j][2 * e], dcb[j][2 * e + 1]);
      if (gi == 0)
        *reinterpret_cast<float2*>(cbm + at) =
            make_float2(cb[j][2 * e], cb[j][2 * e + 1]);
    }
}

// ---------------------------------------------------------------------------
// 2. dx, sd, dcum, ddt per head
// ---------------------------------------------------------------------------

constexpr int DX_THREADS = 256;
constexpr int DX_WARPS = DX_THREADS / 32;
constexpr int DLD = MAX_HP + 8;       // staged dy rows, read as B [k][n]
constexpr int SLD = MAX_DS + 4;       // staged dst rows, read as B [n][k]
constexpr int WLD = 16 + 8;           // a w chunk: 16 q x 16 s (A k-major)
constexpr int WSTAGES = 4;            // w chunks in a warp's ring
// a warp's buffer: its strip's 16 rows of B (read as A row-major), then
// the ring of w chunks
constexpr int WBUF = 16 * SLD;
static_assert(WSTAGES * 16 * WLD <= WBUF, "the w ring must fit the buffer");
constexpr int DX_SMEM = sizeof(float) * (MAX_Q * DLD + MAX_HP * SLD +
                                         DX_WARPS * WBUF + 5 * MAX_Q);

__global__ void __launch_bounds__(DX_THREADS, 1)
ssd_bwd_dx_tf32_kernel(const float* __restrict__ x,
                       const float* __restrict__ cum,
                       const float* __restrict__ dt,
                       const float* __restrict__ Bc,
                       const float* __restrict__ dy,
                       const float* __restrict__ dstates,
                       const float* __restrict__ cbs,
                       const float* __restrict__ prow,
                       const float* __restrict__ pcol,
                       const float* __restrict__ pddt,
                       float* __restrict__ sds, float* __restrict__ dx,
                       float* __restrict__ dcum, float* __restrict__ ddt,
                       int nc, int Q, int nh, int hp, int ds, int QP,
                       int x16, int b16, int d16) {
  extern __shared__ __align__(16) float smem[];
  float* dys = smem;                              // [QR][DLD]
  float* dsts = dys + MAX_Q * DLD;                // [hp8][SLD]
  float* wbufs = dsts + MAX_HP * SLD;             // [warps][WBUF]
  float* cum_a = wbufs + DX_WARPS * WBUF;         // [MAX_Q] each
  float* dt_a = cum_a + MAX_Q;
  float* e_a = dt_a + MAX_Q;
  float* sd_a = e_a + MAX_Q;
  float* dsd_a = sd_a + MAX_Q;
  __shared__ float red[DX_THREADS];

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int bc = b * nc + c;
  const int T = QP / TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t row = static_cast<size_t>(nh) * hp;
  const size_t xo = static_cast<size_t>(bc) * Q * row + h * hp;
  const size_t hq = (static_cast<size_t>(bc) * nh + h) * Q;
  const int hp8 = (hp + 7) & ~7, ds8 = (ds + 7) & ~7;
  const int NS = (Q + 15) / 16, QR = 16 * NS;

  // the warp's strips (sa when sa <= sb, sb when sa < sb: each strip once)
  const int sa = warp, sb = NS - 1 - warp;
  float* wbuf = wbufs + warp * WBUF;
  const float* Bm = Bc + static_cast<size_t>(bc) * Q * ds;
  auto stage_b = [&](int strip) {   // the strip's 16 rows of B
    const int s0 = 16 * strip;
    tf32x3::stage_rows(wbuf, SLD, Bm + static_cast<size_t>(s0) * ds, ds, 16,
                       Q - s0, ds8, ds, b16, lane, 32);
  };

  // ---- dst of the head, the first strip's B rows, dy, the row vectors -----
  tf32x3::stage_rows(dsts, SLD,
                     dstates + (static_cast<size_t>(bc) * nh + h) * hp * ds,
                     ds, hp8, hp, ds8, ds, d16, tid, DX_THREADS);
  if (sa <= sb) stage_b(sa);
  tf32x3::cp_async_commit();
  tf32x3::stage_rows(dys, DLD, dy + xo, row, QR, Q, hp8, hp, x16, tid,
                     DX_THREADS);
  tf32x3::cp_async_commit();
  const float cum_last = cum[hq + Q - 1];
  for (int i = tid; i < QP; i += DX_THREADS) {
    const bool in = i < Q;
    const float cv = in ? cum[hq + i] : 0.f;
    const float dv = in ? dt[hq + i] : 0.f;
    const float ev = in ? expf(cum_last - cv) : 0.f;
    cum_a[i] = cv;
    dt_a[i] = dv;
    e_a[i] = ev;
    sd_a[i] = ev * dv;
    dsd_a[i] = 0.f;
    sds[(static_cast<size_t>(bc) * nh + h) * QP + i] = ev * dv;
  }
  tf32x3::cp_async_wait<1>();   // dst and the strip's B rows are in
  __syncthreads();

  // ---- the warp's strips: u, dsd, dx --------------------------------------
  // Every warp runs both passes' cp.async commits and the block barrier,
  // with or without a strip, so each thread's group count stays in step.
  const float* cbm = cbs + static_cast<size_t>(bc) * QP * QP;
  const int nt = hp8 / 8;
  for (int pass = 0; pass < 2; ++pass) {
    const int strip = pass == 0 ? sa : sb;
    const bool active = pass == 0 ? sa <= sb : sa < sb;
    const int s0 = 16 * strip;
    float acc[8][4];
    zero(acc);
    if (active) {
      if (pass == 1) {   // the second strip's B rows (the buffer is free)
        stage_b(strip);
        tf32x3::cp_async_commit();
        tf32x3::cp_async_wait<0>();
        __syncwarp();
      }
      // u = B dst^T of the strip's rows
      mma_rows(acc, ds8 / 8, nt,
               [&](int ks, float (&v)[4]) {
                 tf32x3::load_a_rm(wbuf + 8 * ks, SLD, v);
               },
               [&](int ks, int j, float (&v)[2]) {
                 tf32x3::load_b_nk(dsts + 8 * j * SLD + 8 * ks, SLD, v);
               });
      // dsd[s] = x[s,:] . u[s,:]; then the state's term of dx: sd u
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int s = s0 + g + 8 * hf;
        float v = 0.f;
        if (s < Q) {
          const float* xr = x + xo + static_cast<size_t>(s) * row;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int p = 8 * j + 2 * t + e;
              if (p < hp) v = fmaf(xr[p], acc[j][2 * hf + e], v);
            }
        }
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0 && s < Q) dsd_a[s] = v;
        const float sdv = sd_a[s];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][2 * hf] *= sdv;
          acc[j][2 * hf + 1] *= sdv;
        }
      }
    }
    __syncwarp();   // the buffer turns into the w ring

    // the w-term: sum_{q >= s} w[q,s] dy[q,:], w^T's 16 x 16 chunks (rows q
    // of CB, the strip's columns s) through the warp's ring
    const int nw = active ? (Q - s0 + 15) / 16 : 0;
    auto stage_w = [&](int kc) {
      const int qk = s0 + 16 * kc;
      tf32x3::stage_rows(wbuf + (kc % WSTAGES) * 16 * WLD, WLD,
                         cbm + static_cast<size_t>(qk) * QP + s0, QP, 16,
                         Q - qk, 16, 16, true, lane, 32);
    };
    for (int kc = 0; kc < WSTAGES - 1; ++kc) {
      if (kc < nw) stage_w(kc);
      tf32x3::cp_async_commit();
    }
    if (pass == 0) {   // dy (block-wide) is in
      tf32x3::cp_async_wait<WSTAGES - 1>();
      __syncthreads();
    }
    if (!active) continue;
    const float cs0 = cum_a[s0 + g], cs1 = cum_a[s0 + g + 8];
    const float ds0 = dt_a[s0 + g], ds1 = dt_a[s0 + g + 8];
    for (int kc = 0; kc < nw; ++kc) {
      tf32x3::cp_async_wait<WSTAGES - 2>();
      __syncwarp();
      const float* st = wbuf + (kc % WSTAGES) * 16 * WLD;
      const int qk = s0 + 16 * kc;
      mma_rows(acc, 2, nt,
               [&](int ks, float (&v)[4]) {
                 tf32x3::load_a_km(st + 8 * ks * WLD, WLD, v);
                 const int qa = qk + 8 * ks + t, qb = qa + 4;
                 const float ca = cum_a[qa], cb2 = cum_a[qb];
                 // w[q,s] = CB L dt[s], masked before the exp
                 v[0] = (s0 + g <= qa && qa < Q)
                            ? v[0] * expf(ca - cs0) * ds0 : 0.f;
                 v[1] = (s0 + g + 8 <= qa && qa < Q)
                            ? v[1] * expf(ca - cs1) * ds1 : 0.f;
                 v[2] = (s0 + g <= qb && qb < Q)
                            ? v[2] * expf(cb2 - cs0) * ds0 : 0.f;
                 v[3] = (s0 + g + 8 <= qb && qb < Q)
                            ? v[3] * expf(cb2 - cs1) * ds1 : 0.f;
               },
               [&](int ks, int j, float (&v)[2]) {
                 tf32x3::load_b_kn(dys + (qk + 8 * ks) * DLD + 8 * j, DLD, v);
               });
      __syncwarp();
      if (kc + WSTAGES - 1 < nw) stage_w(kc + WSTAGES - 1);
      tf32x3::cp_async_commit();
    }
    tf32x3::cp_async_wait<0>();
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = 8 * j + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int s = s0 + g + 8 * hf;
        if (s < Q)
          tf32x3::store_pair(dx + xo + static_cast<size_t>(s) * row + p,
                             acc[j][2 * hf], acc[j][2 * hf + 1], hp - p, hp);
      }
    }
  }
  __syncthreads();  // dsd of every row is in

  // ---- dcum and ddt of the head -------------------------------------------
  red[tid] = tid < Q ? dsd_a[tid] * sd_a[tid] : 0.f;
  __syncthreads();
  for (int o = DX_THREADS / 2; o > 0; o >>= 1) {
    if (tid < o) red[tid] += red[tid + o];
    __syncthreads();
  }
  const size_t part = ((static_cast<size_t>(bc) * nh + h) * T) * QP;
  for (int i = tid; i < Q; i += DX_THREADS) {
    const int ti = i / TILE;
    float rs = 0.f, cs = 0.f, ts = 0.f;
    for (int k = 0; k <= ti; ++k)
      rs += prow[part + static_cast<size_t>(k) * QP + i];
    for (int k = ti; k < T; ++k) {
      cs += pcol[part + static_cast<size_t>(k) * QP + i];
      ts += pddt[part + static_cast<size_t>(k) * QP + i];
    }
    float d = rs - cs - dsd_a[i] * sd_a[i];
    if (i == Q - 1) d += red[0];
    dcum[hq + i] = d;
    ddt[hq + i] = ts + dsd_a[i] * e_a[i];
  }
}

// ---------------------------------------------------------------------------
// 3. the state term of dB, per head group: sum_h (sd x)^T dst
// ---------------------------------------------------------------------------

constexpr int DBS_THREADS = 128;
// a ring stage: x rows s (64 x LA), dst rows p (64 x LB), sd of the rows
constexpr int DBS_STAGE = SLAB + TILE * LB + TILE;
constexpr int DBS_SMEM = sizeof(float) * 2 * DBS_STAGE;

__global__ void __launch_bounds__(DBS_THREADS, 3)
ssd_bwd_dbs_tf32_kernel(const float* __restrict__ x,
                        const float* __restrict__ dstates,
                        const float* __restrict__ sds,
                        float* __restrict__ dbp, int Q, int nh, int hp,
                        int ds, int QP, int BC, int x16, int d16) {
  extern __shared__ __align__(16) float smem[];
  const int ri = blockIdx.x, n0 = blockIdx.y * TILE;
  const int gi = blockIdx.z / BC, bc = blockIdx.z - gi * BC;
  const int NG = sgroups_of(nh), hpg = (nh + NG - 1) / NG;
  const int h_beg = gi * hpg, h_end = min(nh, h_beg + hpg);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s0 = ri * TILE, r0 = warp * 16;
  const int kn = min(TILE, ds - n0), kn8 = (kn + 7) & ~7;
  const int hp8 = (hp + 7) & ~7;
  const size_t row = static_cast<size_t>(nh) * hp;

  auto stage_head = [&](int h, int s) {
    float* st = smem + s * DBS_STAGE;
    tf32x3::stage_rows(st, LA,
                       x + (static_cast<size_t>(bc) * Q + s0) * row + h * hp,
                       row, TILE, Q - s0, hp8, hp, x16, tid, DBS_THREADS);
    tf32x3::stage_rows(
        st + SLAB, LB,
        dstates + (static_cast<size_t>(bc) * nh + h) * hp * ds + n0, ds,
        hp8, hp, kn8, kn, d16 && (kn & 3) == 0, tid, DBS_THREADS);
    // sd of the rows: the dx kernel's (launched before), 0 past Q
    stage_vec(st + SLAB + TILE * LB,
              sds + (static_cast<size_t>(bc) * nh + h) * QP + s0, TILE, tid);
  };
  const int n_h = max(0, h_end - h_beg);
  for (int i = 0; i < 2; ++i) {
    if (i < n_h) stage_head(h_beg + i, i);
    tf32x3::cp_async_commit();
  }
  float acc[8][4];
  zero(acc);
  const int nt = kn8 / 8;
  for (int i = 0; i < n_h; ++i) {
    const int s = i & 1;
    tf32x3::cp_async_wait<1>();
    __syncthreads();
    const float* st = smem + s * DBS_STAGE;
    const float* sd = st + SLAB + TILE * LB;
    const float sd0 = sd[r0 + g], sd1 = sd[r0 + g + 8];
    mma_rows(acc, hp8 / 8, nt,
             [&](int ks, float (&v)[4]) {
               tf32x3::load_a_rm(st + r0 * LA + 8 * ks, LA, v);
               v[0] *= sd0;
               v[1] *= sd1;
               v[2] *= sd0;
               v[3] *= sd1;
             },
             [&](int ks, int j, float (&v)[2]) {
               tf32x3::load_b_kn(st + SLAB + 8 * ks * LB + 8 * j, LB, v);
             });
    __syncthreads();   // the stage is free
    if (i + 2 < n_h) stage_head(h_beg + i + 2, s);
    tf32x3::cp_async_commit();
  }
  float* out = dbp + (static_cast<size_t>(gi) * BC + bc) * QP * ds + n0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = 8 * j + 2 * t;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int s = s0 + r0 + g + 8 * hf;
      tf32x3::store_pair(out + static_cast<size_t>(s) * ds + n,
                         acc[j][2 * hf], acc[j][2 * hf + 1], kn - n, ds);
    }
  }
}

// ---------------------------------------------------------------------------
// 4. dC and dB
// ---------------------------------------------------------------------------

constexpr int DBC_THREADS = 128;
// the groups' dCB partial tiles (LB rows) and the B or C rows of a tile
constexpr int DBC_SMEM = sizeof(float) * (MAX_GROUPS + 1) * TILE * LB;

// Blocks z < B*nc: dC of 64 rows q; the rest: dB of 64 rows s.  Each tile
// of dCB is the groups' partials summed in group order.
__global__ void __launch_bounds__(DBC_THREADS)
ssd_bwd_dbc_tf32_kernel(const float* __restrict__ Bc,
                        const float* __restrict__ Cc,
                        const float* __restrict__ dcbp,
                        const float* __restrict__ dbp,
                        float* __restrict__ dB, float* __restrict__ dC,
                        int Q, int nh, int ds, int QP, int BC, int b16) {
  extern __shared__ __align__(16) float smem[];
  float* rows_s = smem + MAX_GROUPS * TILE * LB;   // B or C rows
  const int ri = blockIdx.x, n0 = blockIdx.y * TILE;
  const bool db = blockIdx.z >= BC;
  const int bc = blockIdx.z - (db ? BC : 0);
  const int T = QP / TILE, NG = groups_of(nh), NGS = sgroups_of(nh);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16, row0 = ri * TILE;
  const int kn = min(TILE, ds - n0), kn8 = (kn + 7) & ~7, nt = kn8 / 8;
  const size_t gstride = static_cast<size_t>(BC) * QP * QP;
  const float* dcbm = dcbp + static_cast<size_t>(bc) * QP * QP;
  const float* src = (db ? Cc : Bc) + static_cast<size_t>(bc) * Q * ds + n0;
  const bool v16 = b16 && (kn & 3) == 0;
  // dC: A = dCB (rows q, row-major), LA rows; dB: A = dCB^T (k-major), LB
  const int ld = db ? LB : LA;
  float acc[8][4];
  zero(acc);

  // dC[q,:] = sum_{s <= q} dCB[q,s] B[s,:] over the tiles left of the rows;
  // dB[s,:] = sum_{q >= s} dCB[q,s] C[q,:] over the tiles below them
  const int k_beg = db ? ri : 0, k_end = db ? T - 1 : ri;
  for (int kt = k_beg; kt <= k_end; ++kt) {
    const int qi = db ? kt : ri, si = db ? ri : kt;
    const float* tile = dcbm + static_cast<size_t>(qi) * TILE * QP +
                        si * TILE;
    for (int gi = 0; gi < NG; ++gi)
      tf32x3::stage_rows(smem + gi * TILE * LB, ld, tile + gi * gstride, QP,
                         TILE, TILE, TILE, TILE, true, tid, DBC_THREADS);
    tf32x3::stage_rows(rows_s, LB, src + static_cast<size_t>(kt) * TILE * ds,
                       ds, TILE, Q - kt * TILE, kn8, kn, v16, tid,
                       DBC_THREADS);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<0>();
    __syncthreads();
    if (NG > 1) {   // the group partials, summed in group order
      for (int i = tid; i < TILE * TILE; i += DBC_THREADS) {
        const int at = (i / TILE) * ld + (i % TILE);
        float v = smem[at];
        for (int gi = 1; gi < NG; ++gi) v += smem[gi * TILE * LB + at];
        smem[at] = v;
      }
      __syncthreads();
    }
    if (db)
      mma_rows(acc, TILE / 8, nt,
               [&](int ks, float (&v)[4]) {
                 tf32x3::load_a_km(smem + 8 * ks * LB + r0, LB, v);
               },
               [&](int ks, int j, float (&v)[2]) {
                 tf32x3::load_b_kn(rows_s + 8 * ks * LB + 8 * j, LB, v);
               });
    else
      mma_rows(acc, TILE / 8, nt,
               [&](int ks, float (&v)[4]) {
                 tf32x3::load_a_rm(smem + r0 * LA + 8 * ks, LA, v);
               },
               [&](int ks, int j, float (&v)[2]) {
                 tf32x3::load_b_kn(rows_s + 8 * ks * LB + 8 * j, LB, v);
               });
    __syncthreads();
  }
  if (db) {   // ... + the state term's group partials, in group order
    const float* part = dbp + static_cast<size_t>(bc) * QP * ds + n0;
    const size_t pstride = static_cast<size_t>(BC) * QP * ds;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + r0 + g + 8 * (e >> 1);
        const int n = 8 * j + 2 * t + (e & 1);
        if (n < kn) {
          const float* pp = part + static_cast<size_t>(r) * ds + n;
          float w[MAX_SGROUPS];
#pragma unroll
          for (int gi = 0; gi < MAX_SGROUPS; ++gi)
            w[gi] = gi < NGS ? pp[gi * pstride] : 0.f;
#pragma unroll
          for (int gi = 0; gi < MAX_SGROUPS; ++gi)
            if (gi < NGS) acc[j][e] += w[gi];
        }
      }
  }
  float* o = (db ? dB : dC) + static_cast<size_t>(bc) * Q * ds + n0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = 8 * j + 2 * t;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + r0 + g + 8 * hf;
      if (r < Q)
        tf32x3::store_pair(o + static_cast<size_t>(r) * ds + n,
                           acc[j][2 * hf], acc[j][2 * hf + 1], kn - n, ds);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x, dy: (B, nc, Q, nh, hp); cum, dt: (B, nc, nh, Q); Bc, Cc: (B, nc, Q,
// ds); dstates: (B, nc, nh, hp, ds); scratch: (1 + NG) * B*nc*QP*QP +
// (3 * T + 1) * B*nc*nh*QP + NGS * B*nc*QP*ds floats, QP = 64 * ceil(Q /
// 64), T = QP / 64, NG = min(nh, 3), NGS = min(nh, 6); dx: x's shape;
// dcum, ddt: cum's; dB, dC: Bc's.  All float32, contiguous; Q <= 256, hp
// <= 64, ds <= 128.  n_scratch: the scratch's length in floats;
// cudaErrorInvalidValue, and no launch, when it is shorter than the above.
// Every element of the five outputs is written.  Returns cudaGetLastError()
// after the four launches.
extern "C" int ssd_intra_chunk_bwd(const float* x, const float* cum,
                                   const float* dt, const float* Bc,
                                   const float* Cc, const float* dy,
                                   const float* dstates, float* scratch,
                                   long long n_scratch, float* dx,
                                   float* dcum, float* ddt, float* dB,
                                   float* dC, int B, int nc, int Q,
                                   int nh, int hp, int ds, void* stream) {
  if (B < 0 || nc < 0 || Q < 1 || Q > MAX_Q || nh < 1 || hp < 1 ||
      hp > MAX_HP || ds < 1 || ds > MAX_DS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || nc == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int QP = (Q + TILE - 1) / TILE * TILE, T = QP / TILE;
  const int BC = B * nc, NG = groups_of(nh), NGS = sgroups_of(nh);
  const size_t sq = static_cast<size_t>(BC) * QP * QP;
  const size_t sp = static_cast<size_t>(BC) * nh * T * QP;
  const size_t need = (1 + NG) * sq + 3 * sp +
                      static_cast<size_t>(BC) * nh * QP +
                      static_cast<size_t>(NGS) * BC * QP * ds;
  if (n_scratch < 0 || static_cast<size_t>(n_scratch) < need)
    return static_cast<int>(cudaErrorInvalidValue);
  float* cbs = scratch;
  float* dcbp = cbs + sq;
  float* prow = dcbp + NG * sq;
  float* pcol = prow + sp;
  float* pddt = pcol + sp;
  float* sds = pddt + sp;
  float* dbp = sds + static_cast<size_t>(BC) * nh * QP;
  const int x16 = hp % 4 == 0 && aligned16(x) && aligned16(dy);
  const int b16 = ds % 4 == 0 && aligned16(Bc) && aligned16(Cc);
  const int d16 = ds % 4 == 0 && aligned16(dstates);
  static bool configured = false;  // once: host time per call
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_dcb_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DCB_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_dx_tf32_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 DX_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_dbs_tf32_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 DBS_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_dbc_tf32_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 DBC_SMEM);
    if (err == cudaSuccess)   // two ~74 KB blocks an SM (three for dbs)
      err = cudaFuncSetAttribute(
          ssd_bwd_dcb_tf32_kernel,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          ssd_bwd_dbs_tf32_kernel,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  ssd_bwd_dcb_tf32_kernel<<<dim3(T * (T + 1) / 2, NG, BC), DCB_THREADS,
                            DCB_SMEM, s>>>(x, cum, dt, Bc, Cc, dy, cbs, dcbp,
                                           prow, pcol, pddt, Q, nh, hp, ds,
                                           QP, x16, b16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dx_tf32_kernel<<<dim3(nh, nc, B), DX_THREADS, DX_SMEM, s>>>(
      x, cum, dt, Bc, dy, dstates, cbs, prow, pcol, pddt, sds, dx, dcum, ddt,
      nc, Q, nh, hp, ds, QP, x16, b16, d16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nds = (ds + TILE - 1) / TILE;
  ssd_bwd_dbs_tf32_kernel<<<dim3(T, nds, NGS * BC), DBS_THREADS, DBS_SMEM,
                            s>>>(x, dstates, sds, dbp, Q, nh, hp, ds, QP, BC,
                                 x16, d16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dbc_tf32_kernel<<<dim3(T, nds, 2 * BC), DBC_THREADS, DBC_SMEM,
                            s>>>(Bc, Cc, dcbp, dbp, dB, dC, Q, nh, ds, QP, BC,
                                 b16);
  return static_cast<int>(cudaGetLastError());
}
