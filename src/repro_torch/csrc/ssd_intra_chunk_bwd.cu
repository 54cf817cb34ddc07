// K8b — Mamba-2 SSD intra-chunk backward for NVIDIA Hopper (sm_90a), on
// float32 FMAs.
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
// FMAs, 0.028 ms for the bytes.  Bound by operations.
//
// Design: three kernels, launched in this order on the caller's stream, on
// one shared-memory micro-kernel (`mm_kmajor`: 256 threads, each a 4 x 4
// register tile of a 64 x 64 output tile, both operands staged k-major with
// rows padded to 68 floats, one float4 of each per k).  A stage's 16 loads
// a thread are all issued before the first store (`load_tile`), so a stage
// waits for one memory latency, not sixteen.
//   ssd_bwd_dcb_kernel  one block per 64 x 64 tile (q, s) on or below the
//                       diagonal, per (b, c): CB of the tile, then the heads
//                       in order h = 0 .. nh-1: dw of the tile, dCB += dw L
//                       dt (the cross-head sum in a fixed order, in
//                       registers: B and C are shared by the heads, and no
//                       float atomics are used), and the tile's per-head
//                       partial sums of g over its columns (dcum's rows), of
//                       g over its rows (dcum's columns) and of dw CB L (ddt)
//                       into a scratch of (B*nc*nh, T, QP) floats each, T =
//                       QP / 64.  Writes CB and dCB to a (B*nc, QP, QP)
//                       scratch each.
//   ssd_bwd_dx_kernel   one block per (h, c, b): sd of the head into a
//                       scratch of (B*nc*nh, QP) floats; per 64-row tile of
//                       s, u = B dst^T, dsd, then dx = sd u + w^T dy over
//                       the q-tiles at or after it (w rebuilt from the CB
//                       scratch); then dcum and ddt from the partials of its
//                       head, summed over the tiles in order, and the dsd
//                       terms.
//   ssd_bwd_dbc_kernel  one block per (64 rows, 64 state columns, b * nc):
//                       dC = dCB B over the tiles left of the rows, then
//                       dB = dCB^T C over the tiles below and sum_h (sd x)^T
//                       dst over the heads in order (sd from the dx
//                       kernel's scratch).
// Every output element is written by one thread of one block and every sum
// runs in a fixed order, so two launches on the same inputs give the same
// bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16 threads, a 4 x 4 tile each
constexpr int TILE = 64;
constexpr int LD = TILE + 4;   // staged rows: float4-aligned, 4-way at most
constexpr int STAGE = TILE * LD;
constexpr int MAX_Q = 256;
constexpr int MAX_HP = 64;
constexpr int MAX_DS = 128;

// acc[i][j] += sum_{k < K} a[k][r0 + i] * b[k][c0 + j], a and b k-major
__device__ __forceinline__ void mm_kmajor(float (&acc)[4][4],
                                          const float* __restrict__ a,
                                          const float* __restrict__ b, int K,
                                          int r0, int c0) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * LD + r0);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * LD + c0);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// A thread's share of a 64 x 64 stage: element e = tid + i * THREADS is
// row e / 64, column e % 64, i.e. row tid / 64 + 4 i, column tid % 64.
constexpr int PER_THREAD = TILE * TILE / THREADS;
constexpr int ROW_STEP = THREADS / TILE;

// v[i] = src[r * stride + k] at the thread's (r, k), 0 past rows / cols:
// every load is issued before the first one is used
__device__ __forceinline__ void load_tile(float (&v)[PER_THREAD],
                                          const float* src, size_t stride,
                                          int rows, int cols, int tid) {
  const int r0 = tid / TILE, k = tid % TILE;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int r = r0 + ROW_STEP * i;
    v[i] = (r < rows && k < cols) ? src[r * stride + k] : 0.f;
  }
}

// dst[k][r] = v at (r, k): a transposed stage (reads ran along k)
__device__ __forceinline__ void store_t(float* dst,
                                        const float (&v)[PER_THREAD],
                                        int tid) {
  const int r0 = tid / TILE, k = tid % TILE;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) dst[k * LD + r0 + ROW_STEP * i] = v[i];
}

// dst[r][k] = v at (r, k)
__device__ __forceinline__ void store_n(float* dst,
                                        const float (&v)[PER_THREAD],
                                        int tid) {
  const int r0 = tid / TILE, k = tid % TILE;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) dst[(r0 + ROW_STEP * i) * LD + k] = v[i];
}

// dst[k][r] = src[r * stride + k] for r < rows, k < cols; zeros elsewhere
// in the 64 x 64 stage (a transposed copy: reads run along k)
__device__ __forceinline__ void stage_t(float* dst, const float* src,
                                        size_t stride, int rows, int cols,
                                        int tid) {
  float v[PER_THREAD];
  load_tile(v, src, stride, rows, cols, tid);
  store_t(dst, v, tid);
}

// dst[r][k] = src[r * stride + k] for r < rows, k < cols; zeros elsewhere
__device__ __forceinline__ void stage_n(float* dst, const float* src,
                                        size_t stride, int rows, int cols,
                                        int tid) {
  float v[PER_THREAD];
  load_tile(v, src, stride, rows, cols, tid);
  store_n(dst, v, tid);
}

// sum over the 16 lanes of a row group (lanes tx = 0..15 of one half-warp),
// in a fixed butterfly order
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
ssd_bwd_dcb_kernel(const float* __restrict__ x, const float* __restrict__ cum,
                   const float* __restrict__ dt, const float* __restrict__ Bc,
                   const float* __restrict__ Cc, const float* __restrict__ dy,
                   float* __restrict__ cbs, float* __restrict__ dcbs,
                   float* __restrict__ prow, float* __restrict__ pcol,
                   float* __restrict__ pddt, int Q, int nh, int hp, int ds,
                   int QP) {
  __shared__ __align__(16) float sa[STAGE];
  __shared__ __align__(16) float sb[STAGE];
  __shared__ float cum_q[TILE], cum_s[TILE], dt_s[TILE];
  __shared__ float red_g[8][TILE], red_t[8][TILE];
  const int T = QP / TILE;
  const int ti = blockIdx.x / T, tj = blockIdx.x - ti * T;
  if (tj > ti) return;  // above the diagonal: w is 0 there
  const int bc = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = ty * 4, c0 = tx * 4;
  const int q0 = ti * TILE, s0 = tj * TILE;
  const int qrows = min(TILE, Q - q0), srows = min(TILE, Q - s0);

  // ---- CB of the tile, over 64-wide slices of the state ------------------
  float cb[4][4];
  zero(cb);
  const float* Cm = Cc + (static_cast<size_t>(bc) * Q + q0) * ds;
  const float* Bm = Bc + (static_cast<size_t>(bc) * Q + s0) * ds;
  for (int n0 = 0; n0 < ds; n0 += TILE) {
    const int kn = min(TILE, ds - n0);
    stage_t(sa, Cm + n0, ds, qrows, kn, tid);
    stage_t(sb, Bm + n0, ds, srows, kn, tid);
    __syncthreads();
    mm_kmajor(cb, sa, sb, kn, r0, c0);
    __syncthreads();
  }

  // ---- the heads, in order ------------------------------------------------
  float dcb[4][4];
  zero(dcb);
  const size_t row = static_cast<size_t>(nh) * hp;  // x / dy row stride
  for (int h = 0; h < nh; ++h) {
    const size_t xo = static_cast<size_t>(bc) * Q * row + h * hp;
    stage_t(sa, dy + xo + q0 * row, row, qrows, hp, tid);
    stage_t(sb, x + xo + s0 * row, row, srows, hp, tid);
    const size_t hq = (static_cast<size_t>(bc) * nh + h) * Q;
    if (tid < TILE) {
      cum_q[tid] = tid < qrows ? cum[hq + q0 + tid] : 0.f;
      cum_s[tid] = tid < srows ? cum[hq + s0 + tid] : 0.f;
      dt_s[tid] = tid < srows ? dt[hq + s0 + tid] : 0.f;
    }
    __syncthreads();
    float dw[4][4];
    zero(dw);
    mm_kmajor(dw, sa, sb, hp, r0, c0);
    float rg[4] = {0.f, 0.f, 0.f, 0.f}, cg[4] = {0.f, 0.f, 0.f, 0.f},
          ct[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + c0 + j;
        // mask, then exp: one exp per (q, s) entry on or below the diagonal
        const float e = (s <= q && q < Q)
                            ? dw[i][j] * expf(cum_q[r0 + i] - cum_s[c0 + j])
                            : 0.f;
        const float d = dt_s[c0 + j];
        dcb[i][j] = fmaf(e, d, dcb[i][j]);
        const float t = e * cb[i][j];   // dw CB L
        const float g = t * d;          // dw w
        rg[i] += g;
        cg[j] += g;
        ct[j] += t;
      }
    }
    // dcum's rows: the tile's columns summed, per (q, column tile)
    const size_t part = ((static_cast<size_t>(bc) * nh + h) * T) * QP;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = row_sum16(rg[i]);
      if (tx == 0) prow[part + static_cast<size_t>(tj) * QP + q0 + r0 + i] = v;
    }
    // dcum's columns and ddt: the tile's rows summed, per (s, row tile)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float g = cg[j] + __shfl_xor_sync(0xffffffffu, cg[j], 16);
      const float t = ct[j] + __shfl_xor_sync(0xffffffffu, ct[j], 16);
      if (lane < 16) {
        red_g[warp][c0 + j] = g;
        red_t[warp][c0 + j] = t;
      }
    }
    __syncthreads();
    if (tid < TILE) {
      float g = 0.f, t = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        g += red_g[w][tid];
        t += red_t[w][tid];
      }
      const size_t o = part + static_cast<size_t>(ti) * QP + s0 + tid;
      pcol[o] = g;
      pddt[o] = t;
    }
    __syncthreads();  // the stages and reductions are free again
  }

  // ---- CB and dCB of the tile --------------------------------------------
  const size_t tile = static_cast<size_t>(bc) * QP * QP +
                      static_cast<size_t>(q0 + r0) * QP + s0 + c0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<float4*>(cbs + tile + i * QP) =
        make_float4(cb[i][0], cb[i][1], cb[i][2], cb[i][3]);
    *reinterpret_cast<float4*>(dcbs + tile + i * QP) =
        make_float4(dcb[i][0], dcb[i][1], dcb[i][2], dcb[i][3]);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ cum,
                  const float* __restrict__ dt, const float* __restrict__ Bc,
                  const float* __restrict__ dy,
                  const float* __restrict__ dstates,
                  const float* __restrict__ cbs,
                  const float* __restrict__ prow,
                  const float* __restrict__ pcol,
                  const float* __restrict__ pddt, float* __restrict__ sds,
                  float* __restrict__ dx, float* __restrict__ dcum,
                  float* __restrict__ ddt, int nc, int Q, int nh, int hp,
                  int ds, int QP) {
  __shared__ __align__(16) float sa[STAGE];
  __shared__ __align__(16) float sb[STAGE];
  __shared__ float cum_a[MAX_Q], dt_a[MAX_Q], e_a[MAX_Q], sd_a[MAX_Q],
      dsd_a[MAX_Q], red[THREADS];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int bc = b * nc + c;
  const int T = QP / TILE;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = ty * 4, c0 = tx * 4;
  const size_t row = static_cast<size_t>(nh) * hp;
  const size_t xo = static_cast<size_t>(bc) * Q * row + h * hp;
  const size_t hq = (static_cast<size_t>(bc) * nh + h) * Q;
  const float cum_last = cum[hq + Q - 1];
  for (int i = tid; i < QP; i += THREADS) {
    const bool in = i < Q;
    const float cv = in ? cum[hq + i] : 0.f;
    const float dv = in ? dt[hq + i] : 0.f;
    const float ev = in ? expf(cum_last - cv) : 0.f;
    cum_a[i] = cv;
    dt_a[i] = dv;
    e_a[i] = ev;
    sd_a[i] = ev * dv;
    sds[(static_cast<size_t>(bc) * nh + h) * QP + i] = ev * dv;
  }
  __syncthreads();

  const float* Bm = Bc + static_cast<size_t>(bc) * Q * ds;
  const float* dsth = dstates + (static_cast<size_t>(bc) * nh + h) * hp * ds;
  const float* cbm = cbs + static_cast<size_t>(bc) * QP * QP;
  for (int si = 0; si < T; ++si) {
    const int s0 = si * TILE, srows = min(TILE, Q - s0);
    float acc[4][4];
    zero(acc);
    // u = B dst^T of the rows, over 64-wide slices of the state
    for (int n0 = 0; n0 < ds; n0 += TILE) {
      const int kn = min(TILE, ds - n0);
      stage_t(sa, Bm + static_cast<size_t>(s0) * ds + n0, ds, srows, kn, tid);
      stage_t(sb, dsth + n0, ds, hp, kn, tid);
      __syncthreads();
      mm_kmajor(acc, sa, sb, kn, r0, c0);
      __syncthreads();
    }
    // dsd[s] = x[s,:] . u[s,:], then the state's term of dx: sd u
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + r0 + i;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = c0 + j;
        if (s < Q && p < hp)
          v = fmaf(x[xo + static_cast<size_t>(s) * row + p], acc[i][j], v);
      }
      v = row_sum16(v);
      if (tx == 0) dsd_a[s] = v;
      const float sdv = sd_a[s];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= sdv;
    }
    // the w-term: sum_q w[q,s] dy[q,:] over the q-tiles at or below
    for (int qi = si; qi < T; ++qi) {
      const int q0 = qi * TILE, qrows = min(TILE, Q - q0);
      // w[q,s] of the tile, row q0 + k, column s0 + r (r = tid % 64)
      float v[PER_THREAD];
      const int r = tid % TILE, s = s0 + r;
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) {
        const int q = q0 + tid / TILE + ROW_STEP * i;
        v[i] = (s <= q && q < Q) ? cbm[static_cast<size_t>(q) * QP + s] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) {
        const int k = tid / TILE + ROW_STEP * i, q = q0 + k;
        sa[k * LD + r] = (s <= q && q < Q)
                             ? v[i] * expf(cum_a[q] - cum_a[s]) * dt_a[s]
                             : 0.f;
      }
      stage_n(sb, dy + xo + static_cast<size_t>(q0) * row, row, qrows, hp,
              tid);
      __syncthreads();
      mm_kmajor(acc, sa, sb, TILE, r0, c0);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + r0 + i;
      if (s < Q) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < hp)
            dx[xo + static_cast<size_t>(s) * row + c0 + j] = acc[i][j];
      }
    }
  }
  __syncthreads();  // dsd of every row is in

  // ---- dcum and ddt of the head ---------------------------------------------
  red[tid] = tid < Q ? dsd_a[tid] * sd_a[tid] : 0.f;
  __syncthreads();
  for (int o = THREADS / 2; o > 0; o >>= 1) {
    if (tid < o) red[tid] += red[tid + o];
    __syncthreads();
  }
  const size_t part = ((static_cast<size_t>(bc) * nh + h) * T) * QP;
  for (int i = tid; i < Q; i += THREADS) {
    const int t = i / TILE;
    float rs = 0.f, cs = 0.f, ts = 0.f;
    for (int k = 0; k <= t; ++k)
      rs += prow[part + static_cast<size_t>(k) * QP + i];
    for (int k = t; k < T; ++k) {
      cs += pcol[part + static_cast<size_t>(k) * QP + i];
      ts += pddt[part + static_cast<size_t>(k) * QP + i];
    }
    float d = rs - cs - dsd_a[i] * sd_a[i];
    if (i == Q - 1) d += red[0];
    dcum[hq + i] = d;
    ddt[hq + i] = ts + dsd_a[i] * e_a[i];
  }
}

__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_dbc_kernel(const float* __restrict__ x, const float* __restrict__ Bc,
                   const float* __restrict__ Cc,
                   const float* __restrict__ dstates,
                   const float* __restrict__ dcbs,
                   const float* __restrict__ sds, float* __restrict__ dB,
                   float* __restrict__ dC, int Q, int nh, int hp, int ds,
                   int QP) {
  __shared__ __align__(16) float sa[STAGE];
  __shared__ __align__(16) float sb[STAGE];
  const int ri = blockIdx.x, n0 = blockIdx.y * TILE, bc = blockIdx.z;
  const int T = QP / TILE;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = ty * 4, c0 = tx * 4;
  const int q0 = ri * TILE, rows = min(TILE, Q - q0);
  const int kn = min(TILE, ds - n0);
  const float* dcbm = dcbs + static_cast<size_t>(bc) * QP * QP;
  const float* Bm = Bc + static_cast<size_t>(bc) * Q * ds + n0;
  const float* Cm = Cc + static_cast<size_t>(bc) * Q * ds + n0;
  float acc[4][4];

  auto store = [&](float* out) {
    float* o = out + static_cast<size_t>(bc) * Q * ds + n0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + r0 + i;
      if (r < Q) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < kn) o[static_cast<size_t>(r) * ds + c0 + j] = acc[i][j];
      }
    }
  };

  // ---- dC[q,:] = sum_{s <= q} dCB[q,s] B[s,:], the tiles left of the rows --
  zero(acc);
  for (int sj = 0; sj <= ri; ++sj) {
    const int s0 = sj * TILE;
    stage_t(sa, dcbm + static_cast<size_t>(q0) * QP + s0, QP, TILE, TILE,
            tid);
    stage_n(sb, Bm + static_cast<size_t>(s0) * ds, ds, min(TILE, Q - s0), kn,
            tid);
    __syncthreads();
    mm_kmajor(acc, sa, sb, TILE, r0, c0);
    __syncthreads();
  }
  store(dC);

  // ---- dB[s,:] = sum_{q >= s} dCB[q,s] C[q,:], the tiles below the rows ----
  zero(acc);
  for (int qj = ri; qj < T; ++qj) {
    const int s0 = qj * TILE;   // here the rows of dCB are q
    stage_n(sa, dcbm + static_cast<size_t>(s0) * QP + q0, QP, TILE, TILE,
            tid);
    stage_n(sb, Cm + static_cast<size_t>(s0) * ds, ds, min(TILE, Q - s0), kn,
            tid);
    __syncthreads();
    mm_kmajor(acc, sa, sb, TILE, r0, c0);
    __syncthreads();
  }
  // ... + sum_h sum_p sd_h[s] x[s,h,p] dst[h,p,:], the heads in order; the
  // next head's tiles load while this head's product runs
  const size_t row = static_cast<size_t>(nh) * hp;
  float v[PER_THREAD], sdv[PER_THREAD], w[PER_THREAD];
  auto load_head = [&](int h) {
    load_tile(v, x + (static_cast<size_t>(bc) * Q + q0) * row + h * hp, row,
              rows, hp, tid);
    // sd of the rows: the dx kernel's (launched before), 0 past Q
    const float* sdh = sds + (static_cast<size_t>(bc) * nh + h) * QP + q0;
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
      sdv[i] = sdh[tid / TILE + ROW_STEP * i];
    load_tile(w, dstates + (static_cast<size_t>(bc) * nh + h) * hp * ds + n0,
              ds, hp, kn, tid);
  };
  load_head(0);
  for (int h = 0; h < nh; ++h) {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) v[i] *= sdv[i];
    store_t(sa, v, tid);
    store_n(sb, w, tid);
    __syncthreads();
    if (h + 1 < nh) load_head(h + 1);
    mm_kmajor(acc, sa, sb, hp, r0, c0);
    __syncthreads();
  }
  store(dB);
}

}  // namespace

// x, dy: (B, nc, Q, nh, hp); cum, dt: (B, nc, nh, Q); Bc, Cc: (B, nc, Q,
// ds); dstates: (B, nc, nh, hp, ds); scratch: 2 * B*nc*QP*QP + (3 * T + 1)
// * B*nc*nh*QP floats, QP = 64 * ceil(Q / 64), T = QP / 64; dx: x's shape;
// dcum, ddt: cum's; dB, dC: Bc's.  All float32, contiguous; Q <= 256, hp <=
// 64, ds <= 128.  Every element of the five outputs is written.  Returns
// cudaGetLastError() after the three launches.
extern "C" int ssd_intra_chunk_bwd(const float* x, const float* cum,
                                   const float* dt, const float* Bc,
                                   const float* Cc, const float* dy,
                                   const float* dstates, float* scratch,
                                   float* dx, float* dcum, float* ddt,
                                   float* dB, float* dC, int B, int nc, int Q,
                                   int nh, int hp, int ds, void* stream) {
  if (B < 0 || nc < 0 || Q < 1 || Q > MAX_Q || nh < 1 || hp < 1 ||
      hp > MAX_HP || ds < 1 || ds > MAX_DS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || nc == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int QP = (Q + TILE - 1) / TILE * TILE, T = QP / TILE;
  const size_t sq = static_cast<size_t>(B) * nc * QP * QP;
  const size_t sp = static_cast<size_t>(B) * nc * nh * T * QP;
  float* cbs = scratch;
  float* dcbs = cbs + sq;
  float* prow = dcbs + sq;
  float* pcol = prow + sp;
  float* pddt = pcol + sp;
  float* sds = pddt + sp;
  ssd_bwd_dcb_kernel<<<dim3(T * T, B * nc), THREADS, 0, s>>>(
      x, cum, dt, Bc, Cc, dy, cbs, dcbs, prow, pcol, pddt, Q, nh, hp, ds, QP);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dx_kernel<<<dim3(nh, nc, B), THREADS, 0, s>>>(
      x, cum, dt, Bc, dy, dstates, cbs, prow, pcol, pddt, sds, dx, dcum, ddt,
      nc, Q, nh, hp, ds, QP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dbc_kernel<<<dim3(T, (ds + TILE - 1) / TILE, B * nc), THREADS, 0,
                       s>>>(x, Bc, Cc, dstates, dcbs, sds, dB, dC, Q, nh, hp,
                            ds, QP);
  return static_cast<int>(cudaGetLastError());
}
