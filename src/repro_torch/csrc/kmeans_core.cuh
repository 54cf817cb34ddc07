// The K-Means assign core shared by K2 (kmeans_assign.cu) and K4
// (kmeans_assign_seq.cu): squared distances of a tile of points to a tile
// of TC = 64 centroid rows, as register tiles of float32 dot products.
//
// A block of NT threads owns TP points and TC = 64 columns (centroid
// rows).  Thread t keeps a PT x CT register tile: the points ty + TYN i
// (i < PT) and the columns tx + TXN m (m < CT), TYN = TP / PT point lanes
// and TXN = TC / CT column lanes, where a warp holds 8 consecutive ty and
// 4 consecutive tx (``Tile::ty`` / ``Tile::tx``): one shared-memory load
// instruction then reads 8 point rows or 4 column rows, without bank
// conflicts.  The feature axis streams in DC = 32-column chunks through a
// STAGES-deep cp.async ring: the point rows and the column rows of a chunk
// land together, rows padded to DCP = 36 floats so that 8 consecutive
// rows fall on distinct banks.  With 16-byte rows (d % 4 == 0 and aligned
// bases) every copy is one 16-byte cp.async; otherwise 4-byte copies.
// Features past d and rows marked -1 land as zeros.
//
// Numerics: every dot product (and, with NORMS, every squared norm) is one
// fmaf chain over the features in index order; zero padding adds
// fmaf(0, 0, s) = s.  So a point's distance to an identical centroid is
// exactly 0 and two identical centroids get bit-identical distances, and
// the argmin over them keeps the lowest index.  The distance is the
// expanded max(|x|^2 - 2 x.c + |c|^2, 0), as the reference computes it.
// No TF32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace kmcore {

constexpr int TC = 64;            // columns (centroid rows) of a block tile
constexpr int DC = 32;            // feature chunk of one ring stage
constexpr int DCP = DC + 4;       // staged row stride, floats (36 = 4 mod 32)

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// the expanded squared distance, clamped at 0 (the reference's formula)
__device__ __forceinline__ float sq_dist(float x2, float dot, float c2) {
  return fmaxf(x2 - 2.f * dot + c2, 0.f);
}

// (distance, index) b replaces a when it is smaller, or equal with a
// lower index: the argmin with ties to the lowest index
__device__ __forceinline__ bool closer(float bd, int bi, float ad, int ai) {
  return bd < ad || (bd == ad && bi < ai);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A block tile: TP points x TC columns on NT threads, PT x CT each.
template <int TP_, int PT_, int CT_, int NT_>
struct Tile {
  static constexpr int TP = TP_, PT = PT_, CT = CT_, NT = NT_;
  static constexpr int TYN = TP / PT;           // point lanes
  static constexpr int TXN = TC / CT;           // column lanes
  static constexpr int ROWS = TP + TC;          // staged rows per chunk
  static constexpr int STAGE = ROWS * DCP;      // floats per ring stage
  static_assert(TYN % 8 == 0 && TXN % 4 == 0 &&
                    NT == 32 * (TYN / 8) * (TXN / 4),
                "a warp is 8 point lanes x 4 column lanes");
  // a thread's point lane: lanes 0-7 of the warp's 8-lane groups
  static __device__ __forceinline__ int ty() {
    return ((threadIdx.x >> 5) % (TYN / 8)) * 8 + (threadIdx.x & 7);
  }
  // a thread's column lane: the warp's 8-lane groups
  static __device__ __forceinline__ int tx() {
    return ((threadIdx.x >> 5) / (TYN / 8)) * 4 + ((threadIdx.x >> 3) & 3);
  }
};

// one feature chunk c of the tile's rows into ring buffer buf: point rows
// rows[0..TP) of X, then column rows rows[TP..TP+TC) of Cm (-1: zeros)
template <class T, bool VEC4>
__device__ __forceinline__ void stage_chunk(const float* __restrict__ X,
                                            const float* __restrict__ Cm,
                                            int d, const int* rows,
                                            float* buf, int c) {
  constexpr int TP = T::TP, R = T::ROWS;
  if (VEC4) {
    for (int e = threadIdx.x; e < R * (DC / 4); e += T::NT) {
      const int row = e / (DC / 4), part = e % (DC / 4);
      const int col = c * DC + 4 * part;
      const int g = rows[row];
      const bool valid = g >= 0 && col < d;   // d % 4 == 0: whole parts
      const float* base = row < TP ? X : Cm;
      cp_async16(buf + row * DCP + 4 * part,
                 valid ? base + static_cast<size_t>(g) * d + col : X, valid);
    }
  } else {
    for (int e = threadIdx.x; e < R * DC; e += T::NT) {
      const int row = e / DC, cl = e % DC;
      const int col = c * DC + cl;
      const int g = rows[row];
      const bool valid = g >= 0 && col < d;
      const float* base = row < TP ? X : Cm;
      cp_async4(buf + row * DCP + cl,
                valid ? base + static_cast<size_t>(g) * d + col : X, valid);
    }
  }
}

// The dot products of the tile: acc[i][m] = x[rows[ty + TYN i]] .
// Cm[rows[TP + tx + TXN m]] over all d features.  With NORMS, thread
// t < TP + TC also returns the squared norm of staged row t in ``norm``
// (the same chain order as the dots).  ``rows`` (TP + TC ints) and the
// ring (STAGES stages of T::STAGE floats) live in shared memory; rows
// must be visible to every thread on entry.  Ends with a barrier, so the
// caller may reuse the ring at once.
template <class T, int STAGES, bool VEC4, bool NORMS>
__device__ __forceinline__ void tile_dots(
    const float* __restrict__ X, const float* __restrict__ Cm, int d,
    const int* rows, float* ring, float (&acc)[T::PT][T::CT], float& norm) {
  constexpr int TP = T::TP, PT = T::PT, CT = T::CT, STAGE = T::STAGE;
  static_assert(!NORMS || TP + TC <= T::NT, "a thread per staged row");
  const int tx = T::tx(), ty = T::ty();
  const int nch = (d + DC - 1) / DC;
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int m = 0; m < CT; ++m) acc[i][m] = 0.f;
  norm = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nch) stage_chunk<T, VEC4>(X, Cm, d, rows, ring + s * STAGE, s);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<STAGES - 2>();   // chunk c has landed (this thread's part)
    __syncthreads();               // ... every thread's; chunk c - 1 is free
    if (c + STAGES - 1 < nch)
      stage_chunk<T, VEC4>(X, Cm, d, rows,
                            ring + ((c + STAGES - 1) % STAGES) * STAGE,
                            c + STAGES - 1);
    cp_async_commit();
    const float* buf = ring + (c % STAGES) * STAGE;
    if (NORMS && threadIdx.x < TP + TC) {
      const float* r = buf + threadIdx.x * DCP;
#pragma unroll
      for (int q4 = 0; q4 < DC / 4; ++q4) {
        const float4 v = *reinterpret_cast<const float4*>(r + 4 * q4);
        norm = fmaf(v.x, v.x, norm);
        norm = fmaf(v.y, v.y, norm);
        norm = fmaf(v.z, v.z, norm);
        norm = fmaf(v.w, v.w, norm);
      }
    }
    const float* a_s = buf + ty * DCP;
    const float* b_s = buf + (TP + tx) * DCP;
#pragma unroll
    for (int q4 = 0; q4 < DC / 4; ++q4) {
      float4 b[CT];
#pragma unroll
      for (int m = 0; m < CT; ++m)
        b[m] = *reinterpret_cast<const float4*>(b_s + T::TXN * m * DCP +
                                                4 * q4);
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(
            a_s + T::TYN * i * DCP + 4 * q4);
#pragma unroll
        for (int m = 0; m < CT; ++m) {
          float s = acc[i][m];
          s = fmaf(a.x, b[m].x, s);
          s = fmaf(a.y, b[m].y, s);
          s = fmaf(a.z, b[m].z, s);
          acc[i][m] = fmaf(a.w, b[m].w, s);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace kmcore
