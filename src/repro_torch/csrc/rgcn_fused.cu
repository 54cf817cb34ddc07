// K1 — fused RGCN layer aggregation for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rgcn_fused_flat_fwd`
// (src/repro/kernels/rgcn_fused/kernel.py, body `_rgcn_fused_flat_kernel`).
// It computes the same function:
//
//   agg[v, :] = sum_{e : dst_e = v} sum_k coef[e,k] * wnorm[e] * (h[src_e] @ basis[k])
//
// with h gathered in its own dtype (float or bfloat16, widened with
// __bfloat162float) and everything after the gather accumulated in float32.
//
// What bounds it on this card: at the main-path shapes (P = 4096 nodes,
// Q = 8192 edges, nb = 2, D in {64, 128}, O in {128, 256}) the operation
// count (~0.5 GFLOP, dominated by the per-node basis contraction) and the
// bytes it must move (~6.5 MB) put the least time near 8 us on float32 CUDA
// cores, so it is bound by operations; in practice the gather of h rows
// (random 256-512 B reads) and shared-memory traffic bound this simple
// version.
//
// Design (scatter-then-contract, no atomics): the TPU kernel multiplies
// one-hot matrices because the TPU has no fast scatter; here the wrapper
// hands the kernel a CSR view of the edges by destination (a stable sort of
// dst, so padded tail edges in any order are handled; edges with wnorm == 0,
// which add exactly zero for finite h, are keyed past the last row and never
// walked — left in, pack_graphs' padded tail would all land in row 0 and
// serialise one warp over thousands of edges), and
//   phase 1: one warp per destination node walks its edges in the stable
//            order, lanes over the feature axis, and accumulates
//            s[v, k*D + d] = sum_e (coef[e,k] * wnorm[e]) * h[src_e, d] in
//            registers; a block owns TILE_V nodes and parks s in shared
//            memory (transposed, [k*D + d][v]);
//   phase 2: each thread owns output columns o and contracts the tile
//            against basisflat (nb*D, O), read straight from L2 with
//            coalesced rows, accumulating TILE_V outputs in registers.
// Every sum runs in a fixed order, so the result is deterministic: the same
// inputs give the same bits on every run on one card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_V = 16;    // destination nodes per block
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_NB = 4;     // bases
constexpr int MAX_DPL = 8;    // feature values per lane: D <= 256
constexpr int MAX_ND = 512;   // nb * D <= 512: s tile is 32 KB

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rgcn_fused_flat_kernel(const T* __restrict__ h, const int* __restrict__ src,
                       const int* __restrict__ perm,
                       const int* __restrict__ rowptr,
                       const float* __restrict__ coef,
                       const float* __restrict__ wnorm,
                       const float* __restrict__ basis,
                       float* __restrict__ out, int P, int D, int nb, int O) {
  __shared__ __align__(16) float sT[MAX_ND * TILE_V];  // [k*D + d][v]
  const int v0 = blockIdx.x * TILE_V;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ND = nb * D;

  // phase 1: per-node weighted gather-sum over the node's incoming edges
  for (int vl = warp; vl < TILE_V; vl += THREADS / 32) {
    const int v = v0 + vl;
    float acc[MAX_NB][MAX_DPL];
#pragma unroll
    for (int k = 0; k < MAX_NB; ++k)
#pragma unroll
      for (int i = 0; i < MAX_DPL; ++i) acc[k][i] = 0.f;
    if (v < P) {
      const int t1 = rowptr[v + 1];
      for (int t = rowptr[v]; t < t1; ++t) {
        const int e = perm[t];
        const T* hrow = h + static_cast<size_t>(src[e]) * D;
        const float wn = wnorm[e];
        float w[MAX_NB];
#pragma unroll
        for (int k = 0; k < MAX_NB; ++k)
          w[k] = (k < nb) ? coef[static_cast<size_t>(e) * nb + k] * wn : 0.f;
#pragma unroll
        for (int i = 0; i < MAX_DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            const float hv = widen(hrow[d]);
#pragma unroll
            for (int k = 0; k < MAX_NB; ++k) acc[k][i] += hv * w[k];
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < MAX_NB; ++k)
#pragma unroll
      for (int i = 0; i < MAX_DPL; ++i) {
        const int d = lane + 32 * i;
        if (k < nb && d < D) sT[(k * D + d) * TILE_V + vl] = acc[k][i];
      }
  }
  __syncthreads();

  // phase 2: contract the node tile against basisflat (nb*D, O)
  for (int o = threadIdx.x; o < O; o += THREADS) {
    float a[TILE_V];
#pragma unroll
    for (int v = 0; v < TILE_V; ++v) a[v] = 0.f;
    for (int j = 0; j < ND; ++j) {
      const float b = basis[static_cast<size_t>(j) * O + o];
      const float4* s4 = reinterpret_cast<const float4*>(sT + j * TILE_V);
#pragma unroll
      for (int q = 0; q < TILE_V / 4; ++q) {
        const float4 s = s4[q];
        a[4 * q + 0] += s.x * b;
        a[4 * q + 1] += s.y * b;
        a[4 * q + 2] += s.z * b;
        a[4 * q + 3] += s.w * b;
      }
    }
#pragma unroll
    for (int v = 0; v < TILE_V; ++v)
      if (v0 + v < P) out[static_cast<size_t>(v0 + v) * O + o] = a[v];
  }
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
  if (P < 0 || D < 1 || nb < 1 || O < 1 || nb > MAX_NB || D > 32 * MAX_DPL ||
      nb * D > MAX_ND)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((P + TILE_V - 1) / TILE_V);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_is_bf16)
    rgcn_fused_flat_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(h), src, perm, rowptr, coef, wnorm,
        basis, out, P, D, nb, O);
  else
    rgcn_fused_flat_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(h), src, perm, rowptr, coef, wnorm, basis,
        out, P, D, nb, O);
  return static_cast<int>(cudaGetLastError());
}
