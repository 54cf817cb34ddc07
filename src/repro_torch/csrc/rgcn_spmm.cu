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
// with h gathered in its own dtype (float or bfloat16, widened exactly)
// and the products and sums in float32.  K5 is the recompute of s that
// K1's backward needs for the gradient of the basis (s^T g) and the
// unfused reference path (`encode_packed(unfused_ref=True)`); K6 is every
// layer of the dense encoder (`core/rgcn.encode`,
// `ContrastiveTrainer.embed_dense`, the dense contrastive loss), whose
// batches pad every graph to the batch's largest (core/graphs.pad_batch).
//
// What bounds them on this card: bytes.  K5 at the fit's bucket (P = 8192
// nodes, Q = 16384 edge slots, 9502 live, nb = 2, D = 64 / 128) must move
// ~5.8 / 11.4 MB (s is 4 / 8 MB of it) against ~2.4 / 4.9 MFLOP; K6 at
// phi-2's first dense batch (B = 64, N = 426, E = 714, 35276 live edges,
// D = 128) ~28 MB of s, the h rows the live edges read and the live edge
// slots, against ~18 MFLOP.  Both are held back by the latency of their
// gathers: each output row depends on a chain of loads (rowptr, perm,
// then the edge's source and weights, then the h row).
//
// Design (no atomics): the TPU kernels multiply one-hot matrices because
// the TPU has no fast scatter (DESIGN.md §3); here the wrapper hands the
// kernel a CSR view of the edges by destination (a stable sort of the
// destination key; edges whose weights are all zero are keyed past the last
// row and never walked).  For K5 the key is dst; for K6 b*N + dst over the
// flattened (B*E) edges, so the B*N rows of the batch are one CSR
// (pad_batch pads and truncates edges to src = dst = 0, which left in
// would all land in each graph's row 0).
//
// Both walk rows with the gathers of csr_gather.cuh: a group of 16 lanes
// (D <= 64) or 32 lanes loads up to 16 / 32 edge slots in one step (perm,
// then src and w: two dependent hops for the whole run), broadcasts each
// edge with shuffles and gathers 4 h rows at once (D <= 128), one 16-byte
// load per lane (8 bytes for bfloat16 h); each row of s is written once
// with 16-byte stores.  Widths with D % 4 != 0 and unaligned h take one
// scalar a lane instead.  K5's group owns one row.  K6's owns 4
// consecutive rows of the flattened batch (`DENSE_ROWS`): at a mean
// in-degree ~1.3, with many padded nodes that have no edge at all, one
// row a group paid the rowptr -> perm -> src -> h chain for about one
// edge; 4 rows share one run, so one step walks ~5 edges (1, 4, 8 and 16
// rows were timed on the card: 4 and 8 tie on phi-2's dense batch, 4 is
// ahead on cfd's, 1 and 16 are behind both).  The grid
// covers the B*N rows on blockIdx.x alone.  Every element sums its edges
// in CSR order through the same fmaf chain as a walk edge by edge, so the
// result is deterministic and its bits do not depend on the layout or on
// the rows a group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "csr_gather.cuh"

namespace {

constexpr int MAX_NB = 4;     // bases
constexpr int MAX_D = 256;    // features (with_layout's widest layout)

// K5: one group of L::G lanes per destination row v (csr_gather.cuh):
// the row's edge slots loaded in one step, then the h rows gathered U at a
// time; acc[k] = fmaf(h, w[k], acc[k]) edge by edge in CSR order, so K5
// gives the same bits as a warp walking the edges one at a time.  The row
// of s is written once.
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
  csrg::walk_run<G, U>(
      perm, row ? __ldg(rowptr + v) : 0, row ? __ldg(rowptr + v + 1) : 0, g,
      mask,
      [&](int e, int) {
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

// rows a group of lanes walks in K6 (R below)
constexpr int DENSE_ROWS = 4;

// K6: one group of L::G lanes per R consecutive rows o = b*N + v of the
// flattened (B*N) output rows.  Their runs are contiguous in perm
// (rowptr[o0] .. rowptr[o0 + R]), so the group walks them as one run:
// one chain of dependent loads for all their edges (R = 4 rows of mean
// in-degree ~1.3 take one step of G slots).  Every lane holds the R + 1
// offsets (broadcast loads, issued together) and names the row of its
// slot by counting them (`out`); `use` writes a row once its last edge is
// summed (rows without edges get their zeros there), the walk's end the
// rest.  Each element sums its edges in CSR order from 0 with the same
// fmaf chain as an edge-by-edge walk, so the bits do not depend on R.
template <typename T, class L, int NB>
__global__ void __launch_bounds__(csrg::THREADS)
rgcn_spmm_dense_kernel(const T* __restrict__ h, const int* __restrict__ src,
                       const int* __restrict__ perm,
                       const int* __restrict__ rowptr,
                       const float* __restrict__ w, float* __restrict__ out,
                       int rows, int N, int E, int D) {
  constexpr int G = L::G, VEC = L::VEC, CPL = L::CPL, R = DENSE_ROWS;
  constexpr int U = csrg::ahead(CPL * VEC);
  const long long o0 =
      (static_cast<long long>(blockIdx.x) * L::GROUPS + threadIdx.x / G) * R;
  const int g = threadIdx.x % G;
  const unsigned mask = csrg::group_mask<G>();
  int rp[R + 1];  // rowptr of the group's rows; past the last row: the end
#pragma unroll
  for (int j = 0; j <= R; ++j)
    rp[j] = __ldg(rowptr + (o0 + j < rows ? o0 + j : rows));
  csrg::Vec<VEC> acc[NB][CPL], hv[U][CPL];
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[k][j] = csrg::zeros<VEC>();
  int cur = 0;  // the group's row that acc sums
  // write rows cur .. j-1 (acc, then zeros) and move to row j
  auto finish = [&](int j) {
    for (; cur < j; ++cur) {
      if (o0 + cur < rows) {
        float* orow = out + static_cast<size_t>(o0 + cur) * NB * D;
#pragma unroll
        for (int k = 0; k < NB; ++k)
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const int d = VEC * (g + G * c);
            if (d < D) csrg::store<VEC>(orow + k * D + d, acc[k][c]);
          }
      }
#pragma unroll
      for (int k = 0; k < NB; ++k)
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[k][c] = csrg::zeros<VEC>();
    }
  };
  csrg::walk_run<G, U>(
      perm, rp[0], rp[R], g, mask,
      [&](int e, int t) {
        csrg::RowSlot<NB> s;
        s.row = (e / E) * N + __ldg(src + e);  // (b, src) of the flat batch
        s.out = 0;
#pragma unroll
        for (int j = 1; j < R; ++j) s.out += rp[j] <= t;
#pragma unroll
        for (int k = 0; k < NB; ++k)
          s.w[k] = __ldg(w + static_cast<size_t>(e) * NB + k);
        return s;
      },
      [&](int u, const csrg::RowSlot<NB>& s) {
        const T* hrow = h + static_cast<size_t>(s.row) * D;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int d = VEC * (g + G * j);
          if (d < D) hv[u][j] = csrg::load<VEC>(hrow + d);
        }
      },
      [&](int u, const csrg::RowSlot<NB>& s) {
        finish(s.out);
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
  finish(R);
}

template <typename T>
int launch_dense(const T* h, const int* src, const int* perm,
                 const int* rowptr, const float* w, float* out, int B, int N,
                 int E, int D, int nb, cudaStream_t s) {
  const bool vec = D % 4 == 0 && csrg::aligned(h, 4 * sizeof(T)) &&
                   csrg::aligned(out, 16);
  const int rows = B * N;
  const long long groups =
      (static_cast<long long>(rows) + DENSE_ROWS - 1) / DENSE_ROWS;
  return csrg::with_layout(D, vec, [&](auto layout) {
    using L = decltype(layout);
    return csrg::with_nb(nb, [&](auto nbc) {
      const dim3 grid(
          static_cast<unsigned>((groups + L::GROUPS - 1) / L::GROUPS));
      rgcn_spmm_dense_kernel<T, L, decltype(nbc)::value>
          <<<grid, csrg::THREADS, 0, s>>>(h, src, perm, rowptr, w, out, rows,
                                          N, E, D);
      return static_cast<int>(cudaGetLastError());
    });
  });
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
  if (P < 0 || D < 1 || nb < 1 || nb > MAX_NB || D > MAX_D)
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
// b*N + dst (dead edges keyed B*N, past the last row); rowptr: (B*N+1,)
// int32 CSR offsets into perm; w: (B*E, nb) f32; out: (B, N, nb*D) f32,
// every element written.  Returns cudaGetLastError() after the launch.
extern "C" int rgcn_spmm_dense(const void* h, int h_is_bf16, const int* src,
                               const int* perm, const int* rowptr,
                               const float* w, float* out, int B, int N,
                               int E, int D, int nb, void* stream) {
  if (B < 0 || N < 0 || E < 0 || D < 1 || nb < 1 || nb > MAX_NB ||
      D > MAX_D || static_cast<long long>(B) * N > 0x7fffffffLL ||
      static_cast<long long>(B) * E > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_is_bf16)
    return launch_dense(static_cast<const __nv_bfloat16*>(h), src, perm,
                        rowptr, w, out, B, N, E, D, nb, s);
  return launch_dense(static_cast<const float*>(h), src, perm, rowptr, w,
                      out, B, N, E, D, nb, s);
}
