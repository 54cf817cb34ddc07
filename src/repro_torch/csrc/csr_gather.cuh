// Row gathers along a CSR run for NVIDIA Hopper (sm_90a), shared by K5
// and K6 (rgcn_spmm.cu, `rgcn_spmm_flat`, `rgcn_spmm_dense`) and K1b
// (rgcn_fused_bwd.cu).
//
// A group of G lanes (16 or 32) owns one output row (K6: a few consecutive
// rows, whose runs are contiguous) and walks the run perm[r0..r1) of a
// CSR view of the edges.  Walked edge by edge, every
// edge costs a chain of three dependent loads (perm, then the edge's
// arrays, then the gathered row), and the slowest row of a launch pays
// that chain once per edge.  Here the chain is paid once per run of up to
// G edges (`walk_run`):
//
//   1. lane j loads slot r0 + j: perm, then the edge's own arrays
//      (`load_slot(e, r0 + j)`), all G slots in one step;
//   2. the group takes the edges in CSR order, U at a time: each edge's
//      data is broadcast from the lane that loaded it with one shuffle,
//      and the U edges' rows are loaded (`gather`) before any of them is
//      used (`use`), so U row loads are in flight together.
//
// Runs longer than G take further steps of G.  The edges are used in CSR
// order, so every output element sees the same float32 operations in the
// same order as a walk edge by edge.
//
// Feature layout (`Layout<G, VEC, CPL>`): lane g of a group holds the
// features VEC*c .. VEC*c + VEC-1 of the slots c = g + G*j, j < CPL.  With
// VEC = 4 a slot is one 16-byte (float) or 8-byte (bfloat16) load; that
// needs D % 4 == 0 and 16- / 8-byte aligned rows, else VEC = 1 (one
// scalar a slot).  `with_layout` picks the layout on the host: a group of
// 16 lanes up to D = 64, so that no lane idles, 32 lanes beyond.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace csrg {

constexpr int THREADS = 256;  // 8 warps a block

template <int G_, int VEC_, int CPL_>
struct Layout {
  static constexpr int G = G_;         // lanes a group
  static constexpr int VEC = VEC_;     // features a slot
  static constexpr int CPL = CPL_;     // slots a lane
  static constexpr int GROUPS = THREADS / G;  // groups a block
  static_assert(G == 16 || G == 32, "a group is a half-warp or a warp");
};

// rows in flight a step: as many as ~16 gathered floats a lane allow (a
// 32-float budget held ~120 registers a thread and ran slower at the fit's
// shapes: fewer warps in flight)
__host__ __device__ constexpr int ahead(int floats_per_edge) {
  return floats_per_edge >= 16 ? 1 : 16 / floats_per_edge;
}

// the lanes of the calling lane's group (a shuffle names only those)
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << G) - 1u) << (threadIdx.x & 31 & ~(G - 1));
  }
}

template <int VEC>
struct Vec {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> zeros() {
  Vec<VEC> r;
#pragma unroll
  for (int x = 0; x < VEC; ++x) r.v[x] = 0.f;
  return r;
}

// p[0 .. VEC) widened to float: one 16-byte (float) or 8-byte (bfloat16)
// load for VEC = 4 (p aligned to it), else scalars
template <int VEC>
__device__ __forceinline__ Vec<VEC> load(const float* __restrict__ p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = a.x;
    r.v[1] = a.y;
    r.v[2] = a.z;
    r.v[3] = a.w;
  } else {
#pragma unroll
    for (int x = 0; x < VEC; ++x) r.v[x] = __ldg(p + x);
  }
  return r;
}
template <int VEC>
__device__ __forceinline__ Vec<VEC> load(
    const __nv_bfloat16* __restrict__ p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {  // bfloat16 -> float is exact: the high half
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    r.v[0] = __uint_as_float(u.x << 16);
    r.v[1] = __uint_as_float(u.x & 0xffff0000u);
    r.v[2] = __uint_as_float(u.y << 16);
    r.v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int x = 0; x < VEC; ++x) r.v[x] = __bfloat162float(p[x]);
  }
  return r;
}

// a written to p[0 .. VEC) in p's type (bfloat16: round to nearest even)
template <int VEC>
__device__ __forceinline__ void store(float* p, const Vec<VEC>& a) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2],
                                                a.v[3]);
  } else {
#pragma unroll
    for (int x = 0; x < VEC; ++x) p[x] = a.v[x];
  }
}
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}
template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const Vec<VEC>& a) {
  if constexpr (VEC == 4) {
    uint2 u;
    u.x = bf16_bits(a.v[0]) | bf16_bits(a.v[1]) << 16;
    u.y = bf16_bits(a.v[2]) | bf16_bits(a.v[3]) << 16;
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int x = 0; x < VEC; ++x) p[x] = __float2bfloat16(a.v[x]);
  }
}

// what one edge slot carries: the row it gathers and its NB weights
template <int NB>
struct Slot {
  int row;
  float w[NB];
};

// ... and, for a group that owns several rows (K6), which of them the
// edge's slot falls in
template <int NB>
struct RowSlot {
  int row;
  int out;
  float w[NB];
};

template <int G, int NB>
__device__ __forceinline__ Slot<NB> bcast(const Slot<NB>& s, unsigned mask,
                                          int from) {
  Slot<NB> r;
  r.row = __shfl_sync(mask, s.row, from, G);
#pragma unroll
  for (int k = 0; k < NB; ++k) r.w[k] = __shfl_sync(mask, s.w[k], from, G);
  return r;
}
template <int G, int NB>
__device__ __forceinline__ RowSlot<NB> bcast(const RowSlot<NB>& s,
                                             unsigned mask, int from) {
  RowSlot<NB> r;
  r.row = __shfl_sync(mask, s.row, from, G);
  r.out = __shfl_sync(mask, s.out, from, G);
#pragma unroll
  for (int k = 0; k < NB; ++k) r.w[k] = __shfl_sync(mask, s.w[k], from, G);
  return r;
}

// The walk described at the top of this file, for lane g of its group:
// load_slot(e, t) -> a Slot or RowSlot reads edge e = perm[t]'s arrays;
// gather(u, slot) issues the loads of the u-th edge of a step (u < U);
// use(u, slot) consumes them.  Every lane of the warp must call it (a
// group with no row walks an empty run): with G = 16 the two groups of a
// warp take their steps together, as many as the longer run needs, so
// neither group's loads wait behind the other's in a diverged warp.
template <int G, int U, typename LoadSlot, typename Gather, typename Use>
__device__ __forceinline__ void walk_run(const int* __restrict__ perm,
                                         int r0, int r1, int g,
                                         unsigned mask, LoadSlot load_slot,
                                         Gather gather, Use use) {
  using S = decltype(load_slot(0, 0));
  const int len = r1 - r0;
  int span = len;  // the same in every lane of the warp
  if constexpr (G < 32)
    span = max(span, __shfl_xor_sync(0xffffffffu, span, 16));
  for (int c = 0; c < span; c += G) {
    const int n = max(0, min(G, len - c));  // this group's edges
    const int nw = min(G, span - c);        // the warp's
    S mine{};
    if (g < n) {
      const int t = r0 + c + g;
      mine = load_slot(__ldg(perm + t), t);
    }
    for (int i = 0; i < nw; i += U) {
      S s[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        s[u] = bcast<G>(mine, mask, (i + u) & (G - 1));
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i + u < n) gather(u, s[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i + u < n) use(u, s[u]);
    }
  }
}

// the sum of v over the G lanes of the group, in every lane (a butterfly:
// a fixed order, so the same inputs give the same bits)
template <int G>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off, G);
  return v;
}

inline bool aligned(const void* p, size_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// f(Layout<...>{}) for width D; vec: D % 4 == 0 and every gathered and
// written row aligned for VEC = 4 (D <= 256)
template <typename F>
int with_layout(int D, bool vec, F&& f) {
  if (!vec) return f(Layout<32, 1, 8>{});
  if (D <= 64) return f(Layout<16, 4, 1>{});
  if (D <= 128) return f(Layout<32, 4, 1>{});
  return f(Layout<32, 4, 2>{});
}

// f(std::integral_constant<int, nb>{}) for 1 <= nb <= 4
template <typename F>
int with_nb(int nb, F&& f) {
  switch (nb) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace csrg
