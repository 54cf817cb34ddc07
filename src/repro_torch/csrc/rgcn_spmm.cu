// K5 and K6 — RGCN message aggregation (pre-basis) for NVIDIA Hopper
// (sm_90a), flat and dense.
//
// K5 replaces the Pallas TPU kernel `rgcn_spmm_flat_fwd`
// (src/repro/kernels/rgcn_spmm/kernel.py, body `_rgcn_flat_kernel`); K6
// replaces `rgcn_spmm_fwd` (same file, body `_rgcn_kernel`), its dense
// batched form.  They compute the pre-basis accumulator
//
//   K5: s[v, k*D + d]    = sum_{e : dst_e = v} w[e,k] * h[src_e, d]
//   K6: s[b, v, k*D + d] = sum_{e : dst[b,e] = v} w[b,e,k] * h[b, src[b,e], d]
//
// with h gathered in its own dtype (float or bfloat16, widened with
// __bfloat162float) and the products and sums in float32.  K5 is the
// recompute of s that K1's backward needs for the gradient of the basis
// (s^T g) and the unfused reference path (`encode_packed(unfused_ref=
// True)`); K6 is every layer of the dense encoder (`core/rgcn.encode`,
// `ContrastiveTrainer.embed_dense`, the dense contrastive loss), whose
// batches pad every graph to the batch's largest (core/graphs.pad_batch).
//
// What bounds them on this card: K5 at the fit's bucket (P = 8192 nodes,
// Q = 16384 edge slots, 9502 live, nb = 2, D = 64 / 128) must move ~6.5 /
// 12.8 MB (s is 4 / 8 MB of it) against ~2.4 / 4.9 MFLOP, so it is bound
// by bytes (~2.0 / 3.8 us at 3.35 TB/s); K6 at phi-2's dense batch (B =
// 64, N = 426, E = 714, D = 128) must move ~43 MB (h 14 MB, s 28 MB), ~13
// us, against ~22 MFLOP of arithmetic.  Both are held back by the latency
// of their gathers: each output row depends on a chain of loads (perm,
// then the edge's source and weights, then the h row).
//
// Design (no atomics): the TPU kernels multiply one-hot matrices because
// the TPU has no fast scatter (DESIGN.md §3); here the wrapper hands the
// kernel a CSR view of the edges by destination (a stable sort of the
// destination key; edges whose weights are all zero are keyed past the last
// real row and never walked).  For K5 the key is dst, for K6 b*(N+1) + dst
// over the flattened (B*E) edges, with dead edges keyed to row N of their
// graph: pad_batch pads and truncates edges to src = dst = 0, which left in
// would all land in each graph's row 0.
//
// K5 walks a row with the gathers of csr_gather.cuh: a group of 16 lanes
// (D <= 64) or 32 lanes per destination row loads up to 16 / 32 edge
// slots in one step (perm, then src and w: two dependent hops for the
// whole run), broadcasts each edge with shuffles and gathers 4 h rows at
// once (D <= 128), one 16-byte load per lane (8 bytes for bfloat16 h); the
// row of s is written once with 16-byte stores.  Widths with D % 4 != 0
// and unaligned h take one scalar a lane instead.  K6 keeps one warp per
// destination node walking its edges one at a time, lanes over the
// feature axis (`aggregate_row`); each node's row of s is written once.
// Both sum every element over its edges in CSR order, so the result is
// deterministic, and K5 gives the same bits as `aggregate_row` would.
// K6's grid is (node groups of 8, graphs): blockIdx.y walks the graphs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "csr_gather.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps, one destination node each
constexpr int WARPS = THREADS / 32;
constexpr int MAX_NB = 4;     // bases
constexpr int MAX_DPL = 8;    // feature values per lane: D <= 256

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One warp's row of s: the edges perm[t0..t1) of one destination node,
// h the base of its graph's (or the flat batch's) node rows; orow its
// nb*D outputs, every element written.
template <typename T>
__device__ __forceinline__ void aggregate_row(
    const T* __restrict__ h, const int* __restrict__ src,
    const int* __restrict__ perm, int t0, int t1,
    const float* __restrict__ w, float* __restrict__ orow, int D, int nb,
    int lane) {
  float acc[MAX_NB][MAX_DPL];
#pragma unroll
  for (int k = 0; k < MAX_NB; ++k)
#pragma unroll
    for (int i = 0; i < MAX_DPL; ++i) acc[k][i] = 0.f;
  for (int t = t0; t < t1; ++t) {
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
#pragma unroll
  for (int k = 0; k < MAX_NB; ++k)
#pragma unroll
    for (int i = 0; i < MAX_DPL; ++i) {
      const int d = lane + 32 * i;
      if (k < nb && d < D) orow[k * D + d] = acc[k][i];
    }
}

// K5: one group of L::G lanes per destination row v (csr_gather.cuh):
// the row's edge slots loaded in one step, then the h rows gathered U at a
// time; acc[k] = fmaf(h, w[k], acc[k]) edge by edge in CSR order, as
// `aggregate_row` does, so K5 gives the same bits as a warp walking the
// edges one at a time.  The row of s is written once.
template <typename T, class L, int NB>
__global__ void __launch_bounds__(csrg::THREADS)
rgcn_spmm_flat_kernel(const T* __restrict__ h, const int* __restrict__ src,
                      const int* __restrict__ perm,
                      const int* __restrict__ rowptr,
                      const float* __restrict__ w, float* __restrict__ out,
                      int P, int D) {
  constexpr int G = L::G, VEC = L::VEC, CPL = L::CPL;
  constexpr int U = csrg::ahead(CPL * VEC);
  const int v = blockIdx.x * L::GROUPS + threadIdx.x / G;
  const bool row = v < P;  // a group past the last row walks nothing
  const int g = threadIdx.x % G;
  const unsigned mask = csrg::group_mask<G>();
  csrg::Vec<VEC> acc[NB][CPL], hv[U][CPL];
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[k][j] = csrg::zeros<VEC>();
  csrg::walk_run<G, U, NB>(
      perm, row ? __ldg(rowptr + v) : 0, row ? __ldg(rowptr + v + 1) : 0, g,
      mask,
      [&](int e) {
        csrg::Slot<NB> s;
        s.row = __ldg(src + e);
#pragma unroll
        for (int k = 0; k < NB; ++k)
          s.w[k] = __ldg(w + static_cast<size_t>(e) * NB + k);
        return s;
      },
      [&](int u, const csrg::Slot<NB>& s) {
        const T* hrow = h + static_cast<size_t>(s.row) * D;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int d = VEC * (g + G * j);
          if (d < D) hv[u][j] = csrg::load<VEC>(hrow + d);
        }
      },
      [&](int u, const csrg::Slot<NB>& s) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          if (VEC * (g + G * j) >= D) continue;
#pragma unroll
          for (int k = 0; k < NB; ++k)
#pragma unroll
            for (int x = 0; x < VEC; ++x)
              acc[k][j].v[x] = fmaf(hv[u][j].v[x], s.w[k], acc[k][j].v[x]);
        }
      });
  if (!row) return;
  float* orow = out + static_cast<size_t>(v) * NB * D;
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int d = VEC * (g + G * j);
      if (d < D) csrg::store<VEC>(orow + k * D + d, acc[k][j]);
    }
}

template <typename T>
int launch_flat(const T* h, const int* src, const int* perm,
                const int* rowptr, const float* w, float* out, int P, int D,
                int nb, cudaStream_t s) {
  const bool vec = D % 4 == 0 && csrg::aligned(h, 4 * sizeof(T)) &&
                   csrg::aligned(out, 16);
  return csrg::with_layout(D, vec, [&](auto layout) {
    using L = decltype(layout);
    return csrg::with_nb(nb, [&](auto nbc) {
      const dim3 grid((P + L::GROUPS - 1) / L::GROUPS);
      rgcn_spmm_flat_kernel<T, L, decltype(nbc)::value>
          <<<grid, csrg::THREADS, 0, s>>>(h, src, perm, rowptr, w, out, P, D);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// src holds node indices local to each graph; perm indexes the flattened
// (B*E) edges; rowptr has B*(N+1)+1 entries (row N of each graph holds its
// dead edges and is never walked).
template <typename T>
__global__ void __launch_bounds__(THREADS)
rgcn_spmm_dense_kernel(const T* __restrict__ h, const int* __restrict__ src,
                       const int* __restrict__ perm,
                       const int* __restrict__ rowptr,
                       const float* __restrict__ w, float* __restrict__ out,
                       int B, int N, int D, int nb) {
  const int v = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (v >= N) return;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const size_t r = static_cast<size_t>(b) * (N + 1) + v;
    aggregate_row(h + static_cast<size_t>(b) * N * D, src, perm, rowptr[r],
                  rowptr[r + 1], w,
                  out + (static_cast<size_t>(b) * N + v) * nb * D, D, nb,
                  threadIdx.x & 31);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_is_bf16)
    return launch_flat(static_cast<const __nv_bfloat16*>(h), src, perm,
                       rowptr, w, out, P, D, nb, s);
  return launch_flat(static_cast<const float*>(h), src, perm, rowptr, w, out,
                     P, D, nb, s);
}

// h: (B, N, D) float or bfloat16; src: (B*E,) int32, local node indices;
// perm: (B*E,) int32, the stable order of the flattened edges by the key
// b*(N+1) + dst (dead edges at row N of their graph); rowptr: (B*(N+1)+1,)
// int32 CSR offsets into perm; w: (B*E, nb) f32; out: (B, N, nb*D) f32,
// every element written.  Returns cudaGetLastError() after the launch.
extern "C" int rgcn_spmm_dense(const void* h, int h_is_bf16, const int* src,
                               const int* perm, const int* rowptr,
                               const float* w, float* out, int B, int N,
                               int D, int nb, void* stream) {
  if (B < 0 || N < 0 || D < 1 || nb < 1 || nb > MAX_NB || D > 32 * MAX_DPL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((N + WARPS - 1) / WARPS, B < 65535 ? B : 65535);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_is_bf16)
    rgcn_spmm_dense_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(h), src, perm, rowptr, w, out, B,
        N, D, nb);
  else
    rgcn_spmm_dense_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(h), src, perm, rowptr, w, out, B, N, D,
        nb);
  return static_cast<int>(cudaGetLastError());
}
