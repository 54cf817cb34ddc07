// K8 — Mamba-2 SSD intra-chunk outputs and chunk states for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_intra_chunk`
// (src/repro/kernels/ssd_scan/kernel.py, body `_ssd_kernel`).  Per batch b,
// chunk c and head h, with x (Q,hp), cum and dt (Q,) of that head and the
// chunk's B and C (Q,ds) shared by all heads, it computes in float32
//
//   CB[q,s]    = C[q,:] . B[s,:]
//   w[q,s]     = CB[q,s] * exp(cum[q] - cum[s]) * dt[s]      for s <= q, else 0
//   y[q,:]     = sum_s w[q,s] * x[s,:]                        (y_intra)
//   state[p,n] = sum_s B[s,n] * exp(cum[Q-1] - cum[s]) * dt[s] * x[s,p]
//
// The mask is applied before the exp (the upper triangle's positive
// differences would overflow), as in the TPU kernel.  The inter-chunk
// recurrence runs outside, in the wrapper.
//
// What bounds it on this card: at the mamba2-780m prefill (B=4, nc=8,
// Q=256, nh=48, hp=64, ds=128) it needs ~1.4e10 float32 operations (CB
// once per (b, c); the lower triangle of w.x; the states) against ~250 MB
// of x, y and states, so it is bound by operations: ~0.2 ms at 67 TFLOP/s
// against ~0.075 ms for the bytes.  This first version runs float32 FMAs
// from shared memory (TF32 tensor cores would change the numbers).
//
// Design: CB depends on (b, c) only, so a first kernel computes it once per
// chunk — 64x64 tiles on or below the diagonal, 4x4 outputs a thread, B and
// C staged 32 features at a time — into a scratch buffer the wrapper
// allocates (8 MB at the mamba shape, read back from L2 by 48 heads), where
// the TPU kernel recomputes it per head.  The second kernel takes one block
// of 256 threads per (head, chunk, batch) and walks the chunk's rows s in
// slabs of 32: it builds the (Q x 32) slab of w in shared memory from CB,
// cum and dt (a (Q,Q) float32 tile, 256 KB at Q=256, does not fit a
// block's 227 KB), stages the slab's x rows and its B rows scaled by
// exp(cum[Q-1] - cum[s]) * dt[s], and accumulates y (8 rows x 8 columns a
// thread) and the state (4 x 8 a thread) in registers.  A warp's 32 rows of
// y skip the slabs above the diagonal.  Each output is written once; no
// atomics, fixed summation order.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SLAB = 32;       // rows s per slab
constexpr int MAX_Q = 256;     // y: 32 row groups x 8 rows
constexpr int MAX_HP = 64;     // y: 8 column lanes x 8; state: 16 x 4 rows
constexpr int MAX_DS = 128;    // state: 16 column lanes x 8
constexpr int CB_TILE = 64;

// CB[(bc), q, s] for the 64x64 tiles on or below the diagonal.
__global__ void __launch_bounds__(THREADS)
ssd_cb_kernel(const float* __restrict__ Bc, const float* __restrict__ Cc,
              float* __restrict__ cb, int Q, int ds) {
  __shared__ float cs[CB_TILE][SLAB + 1];
  __shared__ float bs[CB_TILE][SLAB + 1];
  const int tiles = (Q + CB_TILE - 1) / CB_TILE;
  const int ti = blockIdx.x / tiles, tj = blockIdx.x - ti * tiles;
  if (tj > ti) return;  // above the diagonal: w is 0 there, CB never read
  const int bc = blockIdx.y;
  const float* C = Cc + static_cast<size_t>(bc) * Q * ds;
  const float* B = Bc + static_cast<size_t>(bc) * Q * ds;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cl = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int n0 = 0; n0 < ds; n0 += SLAB) {
    __syncthreads();
    for (int i = tid; i < CB_TILE * SLAB; i += THREADS) {
      const int r = i / SLAB, n = i - r * SLAB;
      const int qr = ti * CB_TILE + r, sr = tj * CB_TILE + r;
      const bool in_n = n0 + n < ds;
      cs[r][n] = (qr < Q && in_n) ? C[static_cast<size_t>(qr) * ds + n0 + n]
                                  : 0.f;
      bs[r][n] = (sr < Q && in_n) ? B[static_cast<size_t>(sr) * ds + n0 + n]
                                  : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int n = 0; n < SLAB; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = cs[rg * 4 + i][n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[cl + 16 * j][n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
    }
  }
  float* out = cb + static_cast<size_t>(bc) * Q * Q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = ti * CB_TILE + rg * 4 + i;
    if (q >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = tj * CB_TILE + cl + 16 * j;
      if (s < Q) out[static_cast<size_t>(q) * Q + s] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_intra_kernel(const float* __restrict__ x, const float* __restrict__ cum,
                 const float* __restrict__ dt, const float* __restrict__ Bc,
                 const float* __restrict__ cb, float* __restrict__ y,
                 float* __restrict__ states, int nc, int Q, int nh, int hp,
                 int ds) {
  extern __shared__ float smem[];
  float* ws = smem;                          // Q x (SLAB + 1)
  float* xs = ws + Q * (SLAB + 1);           // SLAB x (hp + 1)
  float* bs = xs + SLAB * (hp + 1);          // SLAB x (ds + 1)
  float* cum_s = bs + SLAB * (ds + 1);       // Q
  float* dt_s = cum_s + Q;                   // Q

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int bc = b * nc + c;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t head_q = (static_cast<size_t>(bc) * nh + h) * Q;
  for (int i = tid; i < Q; i += THREADS) {
    cum_s[i] = cum[head_q + i];
    dt_s[i] = dt[head_q + i];
  }
  const float* cbm = cb + static_cast<size_t>(bc) * Q * Q;
  const float* Bm = Bc + static_cast<size_t>(bc) * Q * ds;
  const size_t row = static_cast<size_t>(nh) * hp;      // x / y row stride
  const float* xm = x + static_cast<size_t>(bc) * Q * row + h * hp;

  // y: rows ty*8 + i, columns tx + 8*j; a warp owns rows 32*warp .. +31
  const int ty = tid >> 3, tx = tid & 7;
  // state: rows p = sy*4 + i, columns n = sx + 16*j
  const int sy = tid >> 4, sx = tid & 15;
  float yacc[8][8], sacc[4][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) yacc[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sacc[i][j] = 0.f;
  __syncthreads();
  const float cum_last = cum_s[Q - 1];

  for (int s0 = 0; s0 < Q; s0 += SLAB) {
    __syncthreads();  // the previous slab is consumed
    // w slab: warp -> rows, lane -> column s0 + lane; rows < s0 are all 0
    // and never read (a warp's 32 rows lie all below or all at/above s0)
    {
      const int s = s0 + lane;
      const bool in_s = s < Q;
      const float cs = in_s ? cum_s[s] : 0.f, ds_ = in_s ? dt_s[s] : 0.f;
      for (int q = s0 + warp; q < Q; q += THREADS / 32) {
        float w = 0.f;
        if (in_s && q >= s)
          w = cbm[static_cast<size_t>(q) * Q + s] * expf(cum_s[q] - cs) * ds_;
        ws[q * (SLAB + 1) + lane] = w;
      }
    }
    for (int i = tid; i < SLAB * hp; i += THREADS) {
      const int r = i / hp, p = i - r * hp;
      const int s = s0 + r;
      xs[r * (hp + 1) + p] = s < Q ? xm[static_cast<size_t>(s) * row + p] : 0.f;
    }
    for (int i = tid; i < SLAB * ds; i += THREADS) {
      const int r = i / ds, n = i - r * ds;
      const int s = s0 + r;
      bs[r * (ds + 1) + n] =
          s < Q ? Bm[static_cast<size_t>(s) * ds + n] *
                      (expf(cum_last - cum_s[s]) * dt_s[s])
                : 0.f;
    }
    __syncthreads();

    if (32 * warp + 31 >= s0 && 32 * warp < Q) {  // warp-uniform
#pragma unroll 2
      for (int r = 0; r < SLAB; ++r) {
        float xv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = tx + 8 * j;
          xv[j] = p < hp ? xs[r * (hp + 1) + p] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int q = ty * 8 + i;
          const float wv = q < Q ? ws[q * (SLAB + 1) + r] : 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) yacc[i][j] = fmaf(wv, xv[j], yacc[i][j]);
        }
      }
    }
#pragma unroll 2
    for (int r = 0; r < SLAB; ++r) {
      float pv[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = sy * 4 + i;
        pv[i] = p < hp ? xs[r * (hp + 1) + p] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = sx + 16 * j;
        bv[j] = n < ds ? bs[r * (ds + 1) + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sacc[i][j] = fmaf(pv[i], bv[j], sacc[i][j]);
    }
  }

  float* ym = y + static_cast<size_t>(bc) * Q * row + h * hp;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = ty * 8 + i;
    if (q >= Q) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = tx + 8 * j;
      if (p < hp) ym[static_cast<size_t>(q) * row + p] = yacc[i][j];
    }
  }
  float* st = states + (static_cast<size_t>(bc) * nh + h) * hp * ds;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = sy * 4 + i;
    if (p >= hp) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = sx + 16 * j;
      if (n < ds) st[static_cast<size_t>(p) * ds + n] = sacc[i][j];
    }
  }
}

}  // namespace

// x: (B, nc, Q, nh, hp); cum, dt: (B, nc, nh, Q); Bc, Cc: (B, nc, Q, ds);
// cb: scratch of B*nc*Q*Q floats; y: (B, nc, Q, nh, hp); states:
// (B, nc, nh, hp, ds).  All float32, contiguous; Q <= 256, hp <= 64,
// ds <= 128.  Every element of y and states is written.  Returns
// cudaGetLastError() after the two launches.
extern "C" int ssd_intra_chunk(const float* x, const float* cum,
                               const float* dt, const float* Bc,
                               const float* Cc, float* cb, float* y,
                               float* states, int B, int nc, int Q, int nh,
                               int hp, int ds, void* stream) {
  if (B < 0 || nc < 0 || Q < 1 || Q > MAX_Q || nh < 1 || hp < 1 ||
      hp > MAX_HP || ds < 1 || ds > MAX_DS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || nc == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (Q + CB_TILE - 1) / CB_TILE;
  ssd_cb_kernel<<<dim3(tiles * tiles, B * nc), THREADS, 0, s>>>(Bc, Cc, cb,
                                                                 Q, ds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * (Q * (SLAB + 1) + SLAB * (hp + 1) +
                                       SLAB * (ds + 1) + 2 * Q);
  err = cudaFuncSetAttribute(ssd_intra_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_intra_kernel<<<dim3(nh, nc, B), THREADS, smem, s>>>(
      x, cum, dt, Bc, cb, y, states, nc, Q, nh, hp, ds);
  return static_cast<int>(cudaGetLastError());
}
