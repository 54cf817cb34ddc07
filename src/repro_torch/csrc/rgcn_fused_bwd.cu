// K1b — backward of the fused RGCN layer aggregation (K1) for NVIDIA
// Hopper (sm_90a).
//
// The JAX package has no backward Pallas kernel: the vjp of
// `rgcn_fused_agg_flat` (src/repro/kernels/rgcn_fused/ops.py, `_bwd`) is
// `jax.vjp` of the oracle `rgcn_fused_agg_flat_ref`, which XLA lowers to
// gathers and scatter-adds.  This kernel computes the two edge-level parts
// of that vjp.  With g = dL/dagg (P, O), the wrapper forms
// t = g @ basisflat^T (P, nb*D) with torch.matmul; then, with
// w_e = coef_e * wnorm_e,
//
//   dh[u, d]    = sum_{e : src_e = u} sum_k w[e,k] * t[dst_e, k*D + d]
//   dcoef[e, k] = wnorm_e * <h[src_e, :], t[dst_e, k*D : (k+1)*D]>
//
// (the basis gradient s^T g needs s, which K5 recomputes; wnorm gets no
// gradient: it depends only on the graph and the augmentation masks).
//
// What bounds it on this card: at the fit's bucket (P = 8192, Q = 16384
// edge slots, 9502 live, nb = 2, D = 64 / 128) it does ~4*Q*nb*D ~ 5 / 10
// MFLOP and must move h, t, the edge arrays, dh and dcoef once, ~8.8 /
// 17.3 MB, so it is bound by bytes (~2.6 / 5.2 us); what holds it back is
// the latency of its chains of dependent loads.
//
// Design: one launch, two roles chosen by blockIdx (no atomics, every sum
// in a fixed order, so the result is deterministic):
//
// * dh, by source row (blocks [0, row_blocks)).  The wrapper hands the
//   kernel a CSR view of the edges by SOURCE that holds every edge of
//   nonzero weight w = coef * wnorm (it keys zero-weight edges past the
//   last row: they add exactly zero to dh for finite t, and the callers
//   that pass unit norms — the unfused and dense layers, whose padded
//   edges all sit on node 0 — would otherwise pile thousands of them on one
//   row).  A group of 16 or 32 lanes per source row walks its run with the
//   gathers of csr_gather.cuh: the edge slots (perm, then dst, coef and
//   wnorm) in one step, then the t rows of 2 edges in flight (nb = 2,
//   D <= 128), 16 bytes a lane and basis.  Per edge m = sum_k w[e,k]
//   t[dst_e, k] (fmaf in k order), then acc += m, edge by edge in CSR
//   order, as a warp walking the edges one at a time would.  dh is written
//   once per row in h's dtype.
// * dcoef, by edge, in the edges' own order (blocks [row_blocks, ...)): a
//   group per 2 edges loads both rows (h[src_e] and t[dst_e]) with 16-byte
//   loads, reduces each basis's dot product once over the group, and
//   writes wnorm_e * dot — 0 where wnorm_e = 0, without loading the rows.
//   Every one of the Q entries is written, so the wrapper needs no zero
//   fill, and no edge waits behind another: an edge's dcoef costs one
//   chain of two dependent hops whatever its source's degree.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "csr_gather.cuh"

namespace {

constexpr int MAX_NB = 4;    // bases
constexpr int MAX_D = 256;   // features
constexpr int EPG = 2;       // edges a group in the dcoef role

template <typename T, class L, int NB>
__global__ void __launch_bounds__(csrg::THREADS)
rgcn_fused_bwd_kernel(const T* __restrict__ h, const float* __restrict__ t,
                      const int* __restrict__ src,
                      const int* __restrict__ dst,
                      const int* __restrict__ perm,
                      const int* __restrict__ rowptr,
                      const float* __restrict__ coef,
                      const float* __restrict__ wnorm, T* __restrict__ dh,
                      float* __restrict__ dcoef, int P, int Q, int D,
                      int row_blocks) {
  constexpr int G = L::G, VEC = L::VEC, CPL = L::CPL;
  const int g = threadIdx.x % G;
  const unsigned mask = csrg::group_mask<G>();
  const int ND = NB * D;

  if (static_cast<int>(blockIdx.x) < row_blocks) {
    // ---- dh[u]: the edges out of u, in CSR order -------------------------
    constexpr int U = csrg::ahead(NB * CPL * VEC);
    const int u = blockIdx.x * L::GROUPS + threadIdx.x / G;
    const bool row = u < P;  // a group past the last row walks nothing
    csrg::Vec<VEC> acc[CPL], tv[U][NB][CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[j] = csrg::zeros<VEC>();
    csrg::walk_run<G, U>(
        perm, row ? __ldg(rowptr + u) : 0, row ? __ldg(rowptr + u + 1) : 0,
        g, mask,
        [&](int e, int) {
          csrg::Slot<NB> s;
          s.row = __ldg(dst + e);
          const float wn = __ldg(wnorm + e);
#pragma unroll
          for (int k = 0; k < NB; ++k)
            s.w[k] = __ldg(coef + static_cast<size_t>(e) * NB + k) * wn;
          return s;
        },
        [&](int a, const csrg::Slot<NB>& s) {
          const float* trow = t + static_cast<size_t>(s.row) * ND;
#pragma unroll
          for (int k = 0; k < NB; ++k)
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
              const int d = VEC * (g + G * j);
              if (d < D) tv[a][k][j] = csrg::load<VEC>(trow + k * D + d);
            }
        },
        [&](int a, const csrg::Slot<NB>& s) {
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            if (VEC * (g + G * j) >= D) continue;
#pragma unroll
            for (int x = 0; x < VEC; ++x) {
              float m = 0.f;
#pragma unroll
              for (int k = 0; k < NB; ++k)
                m = fmaf(s.w[k], tv[a][k][j].v[x], m);
              acc[j].v[x] += m;
            }
          }
        });
    if (!row) return;
    T* orow = dh + static_cast<size_t>(u) * D;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int d = VEC * (g + G * j);
      if (d < D) csrg::store<VEC>(orow + d, acc[j]);
    }
    return;
  }

  // ---- dcoef[e, :] for the group's EPG edges -----------------------------
  const int e0 = ((blockIdx.x - row_blocks) * L::GROUPS + threadIdx.x / G) *
                 EPG;
  if (e0 >= Q) return;  // the same in every lane of the group
  float wn[EPG];
  int es[EPG], ed[EPG];
#pragma unroll
  for (int x = 0; x < EPG; ++x) {  // one hop: the edges' arrays
    const int e = e0 + x;
    const bool in = e < Q;
    wn[x] = in ? __ldg(wnorm + e) : 0.f;
    es[x] = in ? __ldg(src + e) : 0;
    ed[x] = in ? __ldg(dst + e) : 0;
  }
  csrg::Vec<VEC> hv[EPG][CPL], tv[EPG][NB][CPL];
#pragma unroll
  for (int x = 0; x < EPG; ++x) {  // the second: both rows of each edge
    if (wn[x] == 0.f) continue;
    const T* hrow = h + static_cast<size_t>(es[x]) * D;
    const float* trow = t + static_cast<size_t>(ed[x]) * ND;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int d = VEC * (g + G * j);
      if (d >= D) continue;
      hv[x][j] = csrg::load<VEC>(hrow + d);
#pragma unroll
      for (int k = 0; k < NB; ++k)
        tv[x][k][j] = csrg::load<VEC>(trow + k * D + d);
    }
  }
#pragma unroll
  for (int x = 0; x < EPG; ++x) {
    if (wn[x] == 0.f) {  // the same in every lane of the group
      if (g == 0 && e0 + x < Q)
#pragma unroll
        for (int k = 0; k < NB; ++k)
          dcoef[static_cast<size_t>(e0 + x) * NB + k] = 0.f;
      continue;
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (VEC * (g + G * j) >= D) continue;
#pragma unroll
        for (int y = 0; y < VEC; ++y)
          dot = fmaf(hv[x][j].v[y], tv[x][k][j].v[y], dot);
      }
      dot = csrg::group_sum<G>(dot, mask);
      if (g == 0) dcoef[static_cast<size_t>(e0 + x) * NB + k] = wn[x] * dot;
    }
  }
}

template <typename T>
int launch_bwd(const T* h, const float* t, const int* src, const int* dst,
               const int* perm, const int* rowptr, const float* coef,
               const float* wnorm, T* dh, float* dcoef, int P, int Q, int D,
               int nb, cudaStream_t s) {
  const bool vec = D % 4 == 0 && csrg::aligned(h, 4 * sizeof(T)) &&
                   csrg::aligned(dh, 4 * sizeof(T)) && csrg::aligned(t, 16);
  return csrg::with_layout(D, vec, [&](auto layout) {
    using L = decltype(layout);
    return csrg::with_nb(nb, [&](auto nbc) {
      const int row_blocks = (P + L::GROUPS - 1) / L::GROUPS;
      const int edge_blocks =
          (Q + L::GROUPS * EPG - 1) / (L::GROUPS * EPG);
      rgcn_fused_bwd_kernel<T, L, decltype(nbc)::value>
          <<<row_blocks + edge_blocks, csrg::THREADS, 0, s>>>(
              h, t, src, dst, perm, rowptr, coef, wnorm, dh, dcoef, P, Q, D,
              row_blocks);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

}  // namespace

// h: (P, D) float or bfloat16; t: (P, nb*D) f32 = g @ basisflat^T;
// src, dst: (Q,) int32; perm: (Q,) int32, the stable order by source of
// (at least) every edge of nonzero weight coef * wnorm; rowptr: (P+1,)
// int32 CSR offsets into perm; coef: (Q, nb) f32; wnorm: (Q,) f32; dh:
// (P, D) in h's dtype and dcoef: (Q, nb) f32, every element of both
// written.  Returns cudaGetLastError() after the launch.
extern "C" int rgcn_fused_bwd(const void* h, int h_is_bf16, const float* t,
                              const int* src, const int* dst,
                              const int* perm, const int* rowptr,
                              const float* coef, const float* wnorm,
                              void* dh, float* dcoef, int P, int Q, int D,
                              int nb, void* stream) {
  if (P < 0 || Q < 0 || D < 1 || nb < 1 || nb > MAX_NB || D > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_is_bf16)
    return launch_bwd(static_cast<const __nv_bfloat16*>(h), t, src, dst,
                      perm, rowptr, coef, wnorm,
                      static_cast<__nv_bfloat16*>(dh), dcoef, P, Q, D, nb, s);
  return launch_bwd(static_cast<const float*>(h), t, src, dst, perm, rowptr,
                    coef, wnorm, static_cast<float*>(dh), dcoef, P, Q, D, nb,
                    s);
}
