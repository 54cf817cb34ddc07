// K5 — flat RGCN message aggregation (pre-basis) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rgcn_spmm_flat_fwd`
// (src/repro/kernels/rgcn_spmm/kernel.py, body `_rgcn_flat_kernel`).
// It computes the same function, the pre-basis accumulator
//
//   s[v, k*D + d] = sum_{e : dst_e = v} w[e,k] * h[src_e, d]
//
// with h gathered in its own dtype (float or bfloat16, widened with
// __bfloat162float) and the products and sums in float32.  On the training
// path it is the recompute of s that K1's backward needs for the gradient
// of the basis (s^T g); it also serves the unfused reference path
// (`encode_packed(unfused_ref=True)`).
//
// What bounds it on this card: at the main-path shapes (P = 4096 nodes,
// Q = 8192 edges, nb = 2, D <= 128) it does 2*Q*nb*D ~ 4 MFLOP and must
// write P*nb*D*4 ~ 4 MB of output, so it is bound by bytes (~1.5 us at
// 3.35 TB/s); this simple version is bound by the latency of its gathers
// of h rows (random 256-512 B reads), one warp per destination node.
//
// Design (no atomics): the TPU kernel multiplies one-hot matrices because
// the TPU has no fast scatter; here the wrapper hands the kernel the same
// CSR view of the edges by destination as K1 (a stable sort of dst; edges
// whose weights are all zero, such as pack_graphs' padded tail, are keyed
// past the last row and never walked).  One warp per destination node walks
// its edges in that order, lanes over the feature axis, and accumulates
// every basis's row in registers; each node's row of s is written once,
// coalesced.  The sums run in a fixed order, so the result is
// deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 8 warps, one destination node each
constexpr int WARPS = THREADS / 32;
constexpr int MAX_NB = 4;     // bases
constexpr int MAX_DPL = 8;    // feature values per lane: D <= 256

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rgcn_spmm_flat_kernel(const T* __restrict__ h, const int* __restrict__ src,
                      const int* __restrict__ perm,
                      const int* __restrict__ rowptr,
                      const float* __restrict__ w, float* __restrict__ out,
                      int P, int D, int nb) {
  const int v = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (v >= P) return;
  float acc[MAX_NB][MAX_DPL];
#pragma unroll
  for (int k = 0; k < MAX_NB; ++k)
#pragma unroll
    for (int i = 0; i < MAX_DPL; ++i) acc[k][i] = 0.f;
  const int t1 = rowptr[v + 1];
  for (int t = rowptr[v]; t < t1; ++t) {
    const int e = perm[t];
    const T* hrow = h + static_cast<size_t>(src[e]) * D;
    float we[MAX_NB];
#pragma unroll
    for (int k = 0; k < MAX_NB; ++k)
      we[k] = (k < nb) ? w[static_cast<size_t>(e) * nb + k] : 0.f;
#pragma unroll
    for (int i = 0; i < MAX_DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        const float hv = widen(hrow[d]);
#pragma unroll
        for (int k = 0; k < MAX_NB; ++k) acc[k][i] += hv * we[k];
      }
    }
  }
  float* orow = out + static_cast<size_t>(v) * nb * D;
#pragma unroll
  for (int k = 0; k < MAX_NB; ++k)
#pragma unroll
    for (int i = 0; i < MAX_DPL; ++i) {
      const int d = lane + 32 * i;
      if (k < nb && d < D) orow[k * D + d] = acc[k][i];
    }
}

}  // namespace

// h: (P, D) float or bfloat16; src: (Q,) int32; perm: (Q,) int32, the
// stable order of edges by destination; rowptr: (P+1,) int32 CSR offsets
// into perm; w: (Q, nb) f32; out: (P, nb*D) f32, every element written.
// Returns cudaGetLastError() after the launch.
extern "C" int rgcn_spmm_flat(const void* h, int h_is_bf16, const int* src,
                              const int* perm, const int* rowptr,
                              const float* w, float* out, int P, int D,
                              int nb, void* stream) {
  if (P < 0 || D < 1 || nb < 1 || nb > MAX_NB || D > 32 * MAX_DPL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((P + WARPS - 1) / WARPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_is_bf16)
    rgcn_spmm_flat_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(h), src, perm, rowptr, w, out, P,
        D, nb);
  else
    rgcn_spmm_flat_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(h), src, perm, rowptr, w, out, P, D, nb);
  return static_cast<int>(cudaGetLastError());
}
