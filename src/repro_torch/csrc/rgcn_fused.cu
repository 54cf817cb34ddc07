// K1 — fused RGCN layer aggregation for NVIDIA Hopper (sm_90a), with the
// basis contraction on 3xTF32 tensor cores.
//
// Replaces the Pallas TPU kernel `rgcn_fused_flat_fwd`
// (src/repro/kernels/rgcn_fused/kernel.py, body `_rgcn_fused_flat_kernel`).
// It computes the same function:
//
//   agg[v, :] = sum_{e : dst_e = v} sum_k coef[e,k] * wnorm[e] * (h[src_e] @ basis[k])
//
// with h gathered in its own dtype (float or bfloat16, widened to float)
// and everything after the gather accumulated in float32.
//
// What bounds it on this card: at the main-path shapes (P = 4096 nodes,
// Q = 8192 edges, nb = 2, D in {64, 128}, O in {128, 256}) the operations
// (~0.5 GFLOP, nearly all the contraction of the live rows with the basis)
// put the least time near 8 us on float32 FMAs; as 3xTF32 on the tensor
// cores (tf32x3.cuh) it is 3 x the operations at 495 TFLOP/s, ~3.3 us,
// against ~2 us for the ~6.5 MB of bytes.  In practice the gather's chains
// of dependent loads (rowptr -> perm -> src -> h), and the operand split's
// shared-memory loads and integer work beside the MMAs, set the time.
//
// Design (scatter-then-contract, no atomics): the TPU kernel multiplies
// one-hot matrices because the TPU has no fast scatter; here the wrapper
// hands the kernel a CSR view of the edges by destination (a stable sort of
// dst; edges with wnorm == 0, which add exactly zero for finite h, are
// keyed past the last row and never walked — left in, pack_graphs' padded
// tail would all land in row 0 and serialise one warp over thousands of
// edges).  A block of 16 warps owns a tile of 64 destination nodes and a
// slab of 128 output columns (grid: node tiles x column slabs; one block an
// SM, one wave at the main path):
//   - a tile with no live in-edge writes zeros and returns;
//   - the basis slab (nb*D x 128) starts loading by cp.async into shared
//     memory before the gather, in 32-row chunks: all of it when it fits
//     (nb*D <= 256), else a ring of as many chunks as fit;
//   phase 1: warp w walks the CSR run of nodes 4w .. 4w+3 (contiguous in
//            the CSR) in its stable order: lanes fetch 32 edges' (src,
//            coef * wnorm, node) at a time, then the warp gathers h rows
//            four edges ahead (lane l holds features 4l .. 4l+3 of each
//            128-feature block, one 16- or 8-byte load) and adds each in
//            edge order into the node's row of a shared (64 x nb*D) tile,
//            s[v, k*D + d] = sum_e (coef[e,k] * wnorm[e]) * h[src_e, d],
//            zeroed first (a row belongs to one warp, so the adds are
//            plain read-modify-writes, no atomics);
//   phase 2: (64 x nb*D) . (nb*D x 128) as 3xTF32 mma.sync: warps w and
//            w + 8 own the same 32 x 32 output tile and take the even and
//            the odd 32-row chunks of nb*D; the odd half's sums are added
//            to the even half's through shared memory at the end, so the
//            order is fixed.  A 32-node tile half with no live in-edge
//            skips its MMAs; its rows come out as exact zeros.
// The basis is read once per block from L2: 64 node tiles x 2 column slabs
// at the main path (8 MB, against 64 MB for the 16-node tiles this
// replaces); each column slab repeats its tile's gather (at O = 256, one
// extra gather of the ~3 MB of live h rows, from L2).  Every sum runs in a
// fixed order, so the result is deterministic: the same inputs give the
// same bits on every run on one card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::FragA;

constexpr int THREADS = 512;  // 16 warps
constexpr int WARPS = THREADS / 32;
constexpr int TV = 64;        // destination nodes per block
constexpr int OS = 128;       // output columns per block
constexpr int KC = 32;        // basis rows per stage
constexpr int BLD = OS + 8;   // staged basis rows (= 8 mod 32)
constexpr int SMEM_MAX = 232448;  // a block's shared memory on this card
constexpr int RED = 32 * 8 * 32;  // floats handed from K half 1 to half 0
constexpr int MAX_NB = 4;     // bases
constexpr int MAX_DV = 2;     // 128-feature blocks: D <= 256
constexpr int MAX_ND = 512;   // nb * D <= 512
constexpr int AHEAD = 4;      // h rows in flight per warp

// h[row][d .. d+3] (zeros past D) widened to float; vec: D % 4 == 0 and h
// aligned, so one 16-byte (float) or 8-byte (bfloat16) load
__device__ __forceinline__ float4 load4(const float* row, int d, int D,
                                        bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(row + d));
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = d + c < D ? __ldg(row + d + c) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int d,
                                        int D, bool vec) {
  if (vec) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + d));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                       __high2float(hi));
  }
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    v[c] = d + c < D ? __bfloat162float(row[d + c]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// s tile row stride: nb*D rounded up to 32, + 4 (= 4 mod 32)
__host__ __device__ __forceinline__ int s_ld(int ND) {
  return (ND + 31) / 32 * 32 + 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
rgcn_fused_tf32_kernel(const T* __restrict__ h, const int* __restrict__ src,
                       const int* __restrict__ perm,
                       const int* __restrict__ rowptr,
                       const float* __restrict__ coef,
                       const float* __restrict__ wnorm,
                       const float* __restrict__ basis,
                       float* __restrict__ out, int P, int D, int nb, int O,
                       int stages, int vec16, int h_vec) {
  extern __shared__ __align__(16) float smem[];
  const int ND = nb * D, ND8 = (ND + 7) & ~7, SLD = s_ld(ND);
  float* s_tile = smem;                              // [TV][SLD]
  float* ring = s_tile + TV * SLD;  // stages x [KC][BLD], then RED floats
  int* rp = reinterpret_cast<int*>(ring + max(stages * KC * BLD, RED));

  const int v0 = blockIdx.x * TV, o0 = blockIdx.y * OS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int vend = min(v0 + TV, P);

  if (rowptr[v0] == rowptr[vend]) {  // no live in-edge in the tile
    for (int i = tid; i < (vend - v0) * OS; i += THREADS) {
      const int r = i / OS, c = o0 + i - r * OS;
      if (c < O) out[static_cast<size_t>(v0 + r) * O + c] = 0.f;
    }
    return;
  }

  // the basis slab in 32-row chunks: all of it (nb*D <= 256 at O slabs of
  // 128) or a ring of `stages` chunks
  const int nkc = (ND8 + KC - 1) / KC;
  const bool ring_mode = stages < nkc;
  auto stage_basis = [&](int kc) {
    tf32x3::stage_rows(ring + (kc % stages) * KC * BLD, BLD,
                       basis + static_cast<size_t>(kc) * KC * O + o0, O, KC,
                       ND - kc * KC, OS, O - o0, vec16, tid, THREADS);
  };
  int issued = 0;  // chunks issued, one cp.async group each
  for (; issued < min(stages, nkc); ++issued) {
    stage_basis(issued);
    tf32x3::cp_async_commit();
  }
  for (int i = tid; i <= TV; i += THREADS) rp[i] = rowptr[min(v0 + i, P)];
  for (int i = tid; i < TV * ND8 / 4; i += THREADS) {  // phase 1 adds into s
    const int r = i / (ND8 / 4), c = 4 * (i - r * (ND8 / 4));
    *reinterpret_cast<float4*>(s_tile + r * SLD + c) = make_float4(0.f, 0.f,
                                                                   0.f, 0.f);
  }
  __syncthreads();

  // ---- phase 1: s rows of the warp's 4 nodes, edges in CSR order ----------
  {
    constexpr int NPW = TV / WARPS;
    const int vb = warp * NPW, t_end = rp[vb + NPW];
    const int dv = (D + 127) / 128;
    for (int t0 = rp[vb]; t0 < t_end; t0 += 32) {
      const int n = min(32, t_end - t0);
      // lane i: edge t0 + i's source, weights and node (the last v of the
      // warp's run with rp[v] <= t: rp is nondecreasing)
      int es = 0, en = 0;
      float ew[MAX_NB];
#pragma unroll
      for (int k = 0; k < MAX_NB; ++k) ew[k] = 0.f;
      if (lane < n) {
        const int t = t0 + lane;
        const int e = perm[t];
        es = src[e];
        const float wn = wnorm[e];
#pragma unroll
        for (int k = 0; k < MAX_NB; ++k)
          if (k < nb) ew[k] = coef[static_cast<size_t>(e) * nb + k] * wn;
        en = vb;
#pragma unroll
        for (int v = vb + 1; v < vb + NPW; ++v) en += rp[v] <= t;
      }
      for (int i = 0; i < n; i += AHEAD) {
        // AHEAD rows in flight, then added in edge order
        // (lanes whose features start at or past D load nothing: their
        // vector load would read the next row, or past the end of h)
        float4 hv[AHEAD][MAX_DV];
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) {
          const T* hrow = h + static_cast<size_t>(
                                  __shfl_sync(0xffffffffu, es, (i + u) & 31)) *
                                  D;
#pragma unroll
          for (int j = 0; j < MAX_DV; ++j)
            hv[u][j] = (i + u < n && j < dv && 128 * j + 4 * lane < D)
                           ? load4(hrow, 128 * j + 4 * lane, D, h_vec)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) {
          const int node = __shfl_sync(0xffffffffu, en, (i + u) & 31);
          float w[MAX_NB];
#pragma unroll
          for (int k = 0; k < MAX_NB; ++k)
            w[k] = __shfl_sync(0xffffffffu, ew[k], (i + u) & 31);
          if (i + u >= n) break;  // warp-uniform
          float* srow = s_tile + node * SLD;
#pragma unroll
          for (int k = 0; k < MAX_NB; ++k) {
            if (k >= nb) break;
#pragma unroll
            for (int j = 0; j < MAX_DV; ++j) {
              const int d = 128 * j + 4 * lane;
              if (j >= dv || d >= D) continue;
              float* p = srow + k * D + d;
              const float4 x = hv[u][j];
              if (h_vec) {  // D % 4 == 0: p is 16-byte aligned
                float4 a = *reinterpret_cast<float4*>(p);
                a.x = fmaf(x.x, w[k], a.x);
                a.y = fmaf(x.y, w[k], a.y);
                a.z = fmaf(x.z, w[k], a.z);
                a.w = fmaf(x.w, w[k], a.w);
                *reinterpret_cast<float4*>(p) = a;
              } else {
                const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  if (d + c < D) p[c] = fmaf(xs[c], w[k], p[c]);
              }
            }
          }
        }
      }
    }
  }

  // ---- phase 2: (TV x ND) . (ND x OS) on 3xTF32 ----------------------------
  // warp w: the 32 x 32 output tile (rows 32 (w & 1), columns 32 ((w >> 1)
  // & 3)) over the chunks of parity kh = w >> 3; the two halves are added
  // at the end, half 0 + half 1
  const int rt = warp & 1, ct = (warp >> 1) & 3, kh = warp >> 3;
  const bool live = rp[32 * rt + 32] > rp[32 * rt];  // a live 16-row strip
  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
  for (int kc = 0; kc < nkc; ++kc) {
    if (kc == 0 || ring_mode) {
      // chunk kc has landed: at most the chunks issued after it pending
      // (without the ring, all of them have by now)
      tf32x3::cp_async_wait_dyn(ring_mode ? issued - kc - 1 : 0);
      __syncthreads();  // s is complete; the chunks are visible
    }
    if (live && (kc & 1) == kh) {
      const float* bst = ring + (kc % stages) * KC * BLD;
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks) {
        const int j0 = kc * KC + 8 * ks;
        if (j0 < ND8) {  // block-uniform
          FragA a[2];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            float av[4];
            tf32x3::load_a_rm(s_tile + (32 * rt + 16 * m) * SLD + j0, SLD,
                              av);
            a[m] = tf32x3::split_a(av);
          }
          tf32x3::FragB bf[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            float bv[2];
            tf32x3::load_b_kn(bst + 8 * ks * BLD + 32 * ct + 8 * nt, BLD, bv);
            bf[nt] = tf32x3::split_b(bv);
          }
          tf32x3::mma3_x4(acc[0], 0, a[0], bf);
          tf32x3::mma3_x4(acc[1], 0, a[1], bf);
        }
      }
    }
    if (ring_mode && issued < nkc) {
      __syncthreads();  // every warp is done with chunk kc's slot
      stage_basis(issued++);
      tf32x3::cp_async_commit();
    }
  }
  // half 1 hands its sums to half 0 through the (now free) basis space
  float* red = ring;  // [32][8 * 32]: element i of thread (warp & 7, lane)
  const int rslot = (warp & 7) * 32 + lane;
  __syncthreads();
  if (kh == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) red[i * 256 + rslot] = (&acc[0][0][0])[i];
  }
  __syncthreads();
  if (kh == 1) return;
#pragma unroll
  for (int i = 0; i < 32; ++i) (&acc[0][0][0])[i] += red[i * 256 + rslot];
  // a dead half's sums are still 0: its rows are written as zeros
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int o = o0 + 32 * ct + 8 * nt + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int v = v0 + 32 * rt + 16 * m + g + 8 * hf;
        if (v < P)
          tf32x3::store_pair(out + static_cast<size_t>(v) * O + o,
                             acc[m][nt][2 * hf], acc[m][nt][2 * hf + 1],
                             O - o, O);
      }
    }
}

template <typename T>
int launch(const T* h, const int* src, const int* perm, const int* rowptr,
           const float* coef, const float* wnorm, const float* basis,
           float* out, int P, int D, int nb, int O, cudaStream_t s) {
  const int ND = nb * D, nkc = ((ND + 7) / 8 * 8 + KC - 1) / KC;
  const int fixed = static_cast<int>(sizeof(float) * TV * s_ld(ND) +
                                     sizeof(int) * (TV + 1));
  const int stage_bytes = static_cast<int>(sizeof(float) * KC * BLD);
  const int stages = min(nkc, (SMEM_MAX - fixed) / stage_bytes);
  const int smem = fixed + max(stages * stage_bytes,
                               static_cast<int>(sizeof(float)) * RED);
  auto kern = rgcn_fused_tf32_kernel<T>;
  static int configured = 0;  // set once per size: host time per call
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const int vec16 = O % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(basis) & 15) == 0;
  const int h_vec = D % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(h) & (4 * sizeof(T) - 1)) == 0;
  const dim3 grid((P + TV - 1) / TV, (O + OS - 1) / OS);
  kern<<<grid, THREADS, smem, s>>>(h, src, perm, rowptr, coef, wnorm, basis,
                                   out, P, D, nb, O, stages, vec16, h_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h: (P, D) float or bfloat16; src: (Q,) int32; perm: (Q,) int32, the
// stable order of edges by destination; rowptr: (P+1,) int32 CSR offsets
// into perm; coef: (Q, nb) f32; wnorm: (Q,) f32; basis: (nb*D, O) f32;
// out: (P, O) f32.  Returns cudaGetLastError() after the launch.
extern "C" int rgcn_fused_flat(const void* h, int h_is_bf16, const int* src,
                               const int* perm, const int* rowptr,
                               const float* coef, const float* wnorm,
                               const float* basis, float* out, int P, int D,
                               int nb, int O, void* stream) {
  if (P < 0 || D < 1 || nb < 1 || O < 1 || nb > MAX_NB || D > 128 * MAX_DV ||
      nb * D > MAX_ND)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_is_bf16)
    return launch(static_cast<const __nv_bfloat16*>(h), src, perm, rowptr,
                  coef, wnorm, basis, out, P, D, nb, O, s);
  return launch(static_cast<const float*>(h), src, perm, rowptr, coef, wnorm,
                basis, out, P, D, nb, O, s);
}
