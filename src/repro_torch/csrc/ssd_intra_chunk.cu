// K8 — Mamba-2 SSD intra-chunk outputs and chunk states for NVIDIA Hopper
// (sm_90a), on 3xTF32 tensor cores.
//
// Replaces the Pallas TPU kernel `ssd_intra_chunk`
// (src/repro/kernels/ssd_scan/kernel.py, body `_ssd_kernel`).  Per batch b,
// chunk c and head h, with x (Q,hp), cum and dt (Q,) of that head and the
// chunk's B and C (Q,ds) shared by all heads, it computes in float32
//
//   CB[q,s]    = C[q,:] . B[s,:]
//   w[q,s]     = CB[q,s] * exp(cum[q] - cum[s]) * dt[s]      for s <= q, else 0
//   y[q,:]     = sum_s w[q,s] * x[s,:]                        (y_intra)
//   state[p,n] = sum_s x[s,p] * exp(cum[Q-1] - cum[s]) * dt[s] * B[s,n]
//
// The mask is applied before the exp (the upper triangle's positive
// differences would overflow), one exp per (q, s) entry, as in the TPU
// kernel; exp(cum[q] - cum[s]) is not factored into row and column scales,
// which overflow or underflow inside a tile at strong decay.  The
// inter-chunk recurrence runs outside, in the wrapper.
//
// What bounds it on this card: at the mamba2-780m prefill (B=4, nc=8,
// Q=256, nh=48, hp=64, ds=128) the three products need ~1.34e10 operations
// against ~250 MB of x, y and states.  On float32 FMAs that is ~0.2 ms; run
// as 3xTF32 on the tensor cores (tf32x3.cuh) it is 3 x 1.34e10 operations at
// 495 TFLOP/s, ~0.081 ms, against ~0.075 ms for the bytes.
//
// Design.  CB depends on (b, c) only, so `ssd_cb_tf32_kernel` computes its
// 64 x 64 tiles on or below the diagonal once per chunk (C and B tiles in
// shared memory, 4 warps of 16 x 64 outputs) into a scratch buffer of
// (B*nc, QP, QP) floats, QP = Q rounded up to 64 (8 MB at the mamba shape,
// read back from L2 by the 48 heads).  Computing CB inside the per-head
// block instead would need its 160 KB lower triangle in shared memory beside
// x, which leaves no room for two blocks on an SM.
//
// `ssd_chunk_tf32_kernel`: one block of 8 warps per (head, chunk, batch),
// two blocks an SM (~111 KB of shared memory and <= 128 registers each).
//   - x of the head (Q x hp) is staged once, rows padded to 72 floats; it is
//     y's B operand ([s][p]) and the states' A operand (k-major) alike.
//   - y: the rows are cut into 16-row strips; strip r needs s < 16 (r + 1).
//     Warp w takes strips w and NS-1-w (NS strips), so every warp walks the
//     same number of columns, 16 (NS + 1): the triangle is balanced and no
//     warp waits at a barrier, since a warp stages its own CB rows (16 x 32
//     chunks) in a two-deep cp.async ring while it multiplies the previous
//     chunk.  A thread builds its four w entries of each A fragment in
//     registers from the staged CB, cum and dt, splits them and runs 3
//     mma.sync per 8-column n-tile of hp, the passes of four n-tiles
//     interleaved (tf32x3::mma3_x4); y stays in registers (16 x 64 a warp)
//     until its strip is done.
//   - states: 4 warps over hp x 2 over ds, each 16 x 64; the scaled x is the
//     A operand (x[s,p] * sd[s], sd from one exp per s), B streams in 32-row
//     slabs through a two-deep block-wide cp.async ring that reuses the
//     y phase's ring space.
// Each output is written once; no atomics; every sum runs in a fixed order,
// so two calls give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::FragB;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_Q = 256;
constexpr int MAX_HP = 64;     // 8 n-tiles of y; 4 m-strips of the states
constexpr int MAX_DS = 128;    // 2 x 8 n-tiles of the states
constexpr int TILE = 64;       // CB tiles
constexpr int XLD = MAX_HP + 8;             // staged x rows (= 8 mod 32)
constexpr int CBW = 32;                     // CB columns of a warp's chunk
constexpr int CBLD = CBW + 4;               // (= 4 mod 32)
constexpr int CB_STAGE = 16 * CBLD;         // floats of one warp stage
constexpr int BSLAB = 32;                   // B rows of a states slab
constexpr int BLD = MAX_DS + 8;             // (= 8 mod 32)
constexpr int B_STAGE = BSLAB * BLD;
constexpr int RING = WARPS * 2 * CB_STAGE;  // shared by both phases
static_assert(2 * B_STAGE <= RING, "the states ring must fit the y ring");
constexpr int CB_THREADS = 128;
constexpr int CLD = MAX_DS + 4;             // CB kernel's rows (= 4 mod 32)

// CB[(bc), q, s] for the 64 x 64 tiles on or below the diagonal, rows and
// columns past Q as zeros; QP = 64 * ceil(Q / 64)
__global__ void __launch_bounds__(CB_THREADS)
ssd_cb_tf32_kernel(const float* __restrict__ Bc, const float* __restrict__ Cc,
                   float* __restrict__ cb, int Q, int ds, int QP, int vec16) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                 // [64][CLD]: C rows q
  float* bs = cs + TILE * CLD;      // [64][CLD]: B rows s
  const int tiles = QP / TILE;
  const int ti = blockIdx.x / tiles, tj = blockIdx.x - ti * tiles;
  if (tj > ti) return;  // above the diagonal: w is 0 there, CB never read
  const int bc = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int dsp = (ds + 7) & ~7;    // k-steps of 8, zeros past ds
  const float* C = Cc + (static_cast<size_t>(bc) * Q + ti * TILE) * ds;
  const float* B = Bc + (static_cast<size_t>(bc) * Q + tj * TILE) * ds;
  tf32x3::stage_rows(cs, CLD, C, ds, TILE, Q - ti * TILE, dsp, ds, vec16,
                     tid, CB_THREADS);
  tf32x3::stage_rows(bs, CLD, B, ds, TILE, Q - tj * TILE, dsp, ds, vec16,
                     tid, CB_THREADS);
  tf32x3::cp_async_commit();
  tf32x3::cp_async_wait<0>();
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  for (int k0 = 0; k0 < dsp; k0 += 8) {
    float av[4];
    tf32x3::load_a_rm(cs + warp * 16 * CLD + k0, CLD, av);
    const FragA a = tf32x3::split_a(av);
#pragma unroll
    for (int j0 = 0; j0 < 8; j0 += 4) {
      FragB bf[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float bv[2];
        tf32x3::load_b_nk(bs + (j0 + jj) * 8 * CLD + k0, CLD, bv);
        bf[jj] = tf32x3::split_b(bv);
      }
      tf32x3::mma3_x4(acc, j0, a, bf);
    }
  }
  float* out = cb + static_cast<size_t>(bc) * QP * QP +
               static_cast<size_t>(ti * TILE + warp * 16 + g) * QP +
               tj * TILE + 2 * t;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + 8 * QP + 8 * j) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// a warp's CB chunk: rows [16 strip, +16) x columns [col0, col0 + 32) of
// the (QP x QP) tile matrix, all inside tiles the CB kernel wrote
__device__ __forceinline__ void stage_cb_chunk(float* dst, const float* cbm,
                                               int QP, int strip, int col0,
                                               int lane) {
#pragma unroll
  for (int i = lane; i < 16 * (CBW / 4); i += 32) {
    const int r = i / (CBW / 4), c = (i - r * (CBW / 4)) * 4;
    tf32x3::cp_async16(dst + r * CBLD + c,
                       cbm + static_cast<size_t>(strip * 16 + r) * QP +
                           col0 + c,
                       true);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_tf32_kernel(const float* __restrict__ x,
                      const float* __restrict__ cum,
                      const float* __restrict__ dt,
                      const float* __restrict__ Bc,
                      const float* __restrict__ cb, float* __restrict__ y,
                      float* __restrict__ states, int nc, int Q, int nh,
                      int hp, int ds, int QP, int x16, int b16) {
  extern __shared__ __align__(16) float smem[];
  const int QR = (Q + BSLAB - 1) / BSLAB * BSLAB;   // staged rows of x
  float* xs = smem;                                 // [QR][XLD]
  float* cum_s = xs + QR * XLD;                     // [QR]
  float* dt_s = cum_s + QR;                         // [QR]
  float* sd_s = dt_s + QR;                          // [QR]
  float* ring = sd_s + QR;                          // RING floats

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int bc = b * nc + c;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row = static_cast<size_t>(nh) * hp;  // x / y row stride
  const float* xm = x + static_cast<size_t>(bc) * Q * row + h * hp;
  const float* cbm = cb + static_cast<size_t>(bc) * QP * QP;

  // ---- x of the head, then each warp's first two CB chunks ---------------
  tf32x3::stage_rows(xs, XLD, xm, row, QR, Q, MAX_HP, hp, x16, tid, THREADS);
  tf32x3::cp_async_commit();

  // warp w: strips w and NS-1-w; chunk i of the warp's list is
  // (strip, 32 * k) with k counting that strip's chunks
  const int NS = (Q + 15) / 16;
  const int sa = warp, sb = NS - 1 - warp;
  const int na = sa <= sb ? (16 * (sa + 1) + CBW - 1) / CBW : 0;
  const int nb = sa < sb ? (16 * (sb + 1) + CBW - 1) / CBW : 0;
  const int nch = na + nb;
  float* wring = ring + warp * 2 * CB_STAGE;
  auto chunk_strip = [&](int i) { return i < na ? sa : sb; };
  auto chunk_col = [&](int i) { return CBW * (i < na ? i : i - na); };
  for (int i = 0; i < 2; ++i) {
    if (i < nch)
      stage_cb_chunk(wring + i * CB_STAGE, cbm, QP, chunk_strip(i),
                     chunk_col(i), lane);
    tf32x3::cp_async_commit();
  }

  const size_t head_q = (static_cast<size_t>(bc) * nh + h) * Q;
  const float cum_last = cum[head_q + Q - 1];
  for (int i = tid; i < QR; i += THREADS) {
    const bool in = i < Q;
    const float cv = in ? cum[head_q + i] : 0.f;
    const float dv = in ? dt[head_q + i] : 0.f;
    cum_s[i] = cv;
    dt_s[i] = dv;
    sd_s[i] = in ? expf(cum_last - cv) * dv : 0.f;
  }
  tf32x3::cp_async_wait<2>();   // x has landed (this thread's copies)
  __syncthreads();

  // ---- y_intra: the warp's strips, chunk by chunk --------------------------
  const int nt = (hp + 7) / 8;
  float* ym = y + static_cast<size_t>(bc) * Q * row + h * hp;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  for (int i = 0; i < nch; ++i) {
    tf32x3::cp_async_wait<1>();  // chunk i has landed
    __syncwarp();
    const int strip = chunk_strip(i), col0 = chunk_col(i);
    const float* st = wring + (i & 1) * CB_STAGE;
    const int q0 = strip * 16 + g, q1 = q0 + 8;
    const float cq0 = cum_s[q0], cq1 = cum_s[q1];
    const int s_end = 16 * (strip + 1);
#pragma unroll
    for (int ks = 0; ks < CBW / 8; ++ks) {
      const int s0 = col0 + 8 * ks;
      if (s0 < s_end) {  // warp-uniform: the columns right of the strip
        float v[4];
        tf32x3::load_a_rm(st + 8 * ks, CBLD, v);
        const int sA = s0 + t, sB = sA + 4;
        const float cA = cum_s[sA], cB = cum_s[sB];
        const float dA = dt_s[sA], dB = dt_s[sB];
        // mask, then exp: one exp per (q, s) entry
        v[0] = (sA <= q0 && q0 < Q) ? v[0] * expf(cq0 - cA) * dA : 0.f;
        v[1] = (sA <= q1 && q1 < Q) ? v[1] * expf(cq1 - cA) * dA : 0.f;
        v[2] = (sB <= q0 && q0 < Q) ? v[2] * expf(cq0 - cB) * dB : 0.f;
        v[3] = (sB <= q1 && q1 < Q) ? v[3] * expf(cq1 - cB) * dB : 0.f;
        const FragA a = tf32x3::split_a(v);
#pragma unroll
        for (int j0 = 0; j0 < 8; j0 += 4) {
          if (j0 < nt) {  // n-tiles past hp read zeros, are never stored
            FragB bf[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              float bv[2];
              tf32x3::load_b_kn(xs + s0 * XLD + 8 * (j0 + jj), XLD, bv);
              bf[jj] = tf32x3::split_b(bv);
            }
            tf32x3::mma3_x4(acc, j0, a, bf);
          }
        }
      }
    }
    __syncwarp();  // every lane is done with stage i & 1
    if (i + 2 < nch)
      stage_cb_chunk(wring + (i & 1) * CB_STAGE, cbm, QP, chunk_strip(i + 2),
                     chunk_col(i + 2), lane);
    tf32x3::cp_async_commit();
    if (i + 1 == nch || chunk_strip(i + 1) != strip) {  // the strip is done
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + 2 * t;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int q = hf ? q1 : q0;
          if (q < Q)
            tf32x3::store_pair(ym + static_cast<size_t>(q) * row + p,
                               acc[j][2 * hf], acc[j][2 * hf + 1], hp - p, hp);
          acc[j][2 * hf] = acc[j][2 * hf + 1] = 0.f;
        }
      }
    }
  }

  // ---- states: (hp x ds) = (x * sd)^T . B over 32-row slabs of B -----------
  __syncthreads();  // every warp is done with its CB ring
  const float* Bm = Bc + static_cast<size_t>(bc) * Q * ds;
  const int nslab = QR / BSLAB;
  const int dsp = (ds + 7) & ~7;
  auto stage_b = [&](int k) {
    tf32x3::stage_rows(ring + (k & 1) * B_STAGE, BLD,
                       Bm + static_cast<size_t>(k) * BSLAB * ds, ds, BSLAB,
                       Q - k * BSLAB, dsp, ds, b16, tid, THREADS);
  };
  for (int k = 0; k < 2; ++k) {
    if (k < nslab) stage_b(k);
    tf32x3::cp_async_commit();
  }
  const int p0 = (warp & 3) * 16, n0 = (warp >> 2) * 64;
  const bool active = p0 < hp && n0 < ds;
  const int nts = active ? min(8, (ds - n0 + 7) / 8) : 0;
  for (int k = 0; k < nslab; ++k) {
    tf32x3::cp_async_wait<1>();
    __syncthreads();  // slab k is in for every thread
    if (active) {
      const float* bsl = ring + (k & 1) * B_STAGE;
#pragma unroll
      for (int ks = 0; ks < BSLAB / 8; ++ks) {
        const int s0 = k * BSLAB + 8 * ks;
        float v[4];
        tf32x3::load_a_km(xs + s0 * XLD + p0, XLD, v);
        const float sA = sd_s[s0 + t], sB = sd_s[s0 + t + 4];
        v[0] *= sA;
        v[1] *= sA;
        v[2] *= sB;
        v[3] *= sB;
        const FragA a = tf32x3::split_a(v);
#pragma unroll
        for (int j0 = 0; j0 < 8; j0 += 4) {
          if (j0 < nts) {  // n-tiles past ds are never stored
            FragB bf[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              float bv[2];
              tf32x3::load_b_kn(bsl + 8 * ks * BLD + n0 + 8 * (j0 + jj), BLD,
                                bv);
              bf[jj] = tf32x3::split_b(bv);
            }
            tf32x3::mma3_x4(acc, j0, a, bf);
          }
        }
      }
    }
    __syncthreads();  // slab k is consumed
    if (k + 2 < nslab) stage_b(k + 2);
    tf32x3::cp_async_commit();
  }
  if (active) {
    float* st = states + (static_cast<size_t>(bc) * nh + h) * hp * ds;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = p0 + g + 8 * hf;
        if (p < hp)
          tf32x3::store_pair(st + static_cast<size_t>(p) * ds + n,
                             acc[j][2 * hf], acc[j][2 * hf + 1], ds - n, ds);
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x: (B, nc, Q, nh, hp); cum, dt: (B, nc, nh, Q); Bc, Cc: (B, nc, Q, ds);
// cb: scratch of B*nc*QP*QP floats, QP = 64 * ceil(Q / 64); y: (B, nc, Q,
// nh, hp); states: (B, nc, nh, hp, ds).  All float32, contiguous; Q <= 256,
// hp <= 64, ds <= 128.  Every element of y and states is written.  Returns
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
  const int QP = (Q + TILE - 1) / TILE * TILE, tiles = QP / TILE;
  const int b16 = ds % 4 == 0 && aligned16(Bc) && aligned16(Cc);
  const int x16 = hp % 4 == 0 && aligned16(x);
  const int cb_smem = static_cast<int>(sizeof(float) * 2 * TILE * CLD);
  const int QR = (Q + BSLAB - 1) / BSLAB * BSLAB;
  const int smem =
      static_cast<int>(sizeof(float) * (QR * XLD + 3 * QR + RING));
  static int configured = 0;  // set once per size: host time per call
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_cb_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        cb_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(ssd_chunk_tf32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the largest carveout, so two blocks of ~111 KB fit on an SM
    err = cudaFuncSetAttribute(ssd_chunk_tf32_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  ssd_cb_tf32_kernel<<<dim3(tiles * tiles, B * nc), CB_THREADS, cb_smem, s>>>(
      Bc, Cc, cb, Q, ds, QP, b16);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_tf32_kernel<<<dim3(nh, nc, B), THREADS, smem, s>>>(
      x, cum, dt, Bc, cb, y, states, nc, Q, nh, hp, ds, QP, x16, b16);
  return static_cast<int>(cudaGetLastError());
}
