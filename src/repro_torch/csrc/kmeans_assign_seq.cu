// K4 — unmasked K-Means assignment for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `kmeans_assign_fwd`
// (src/repro/kernels/kmeans_assign/kernel.py, body `_kmeans_kernel`), the
// assignment step of the sequential K-Means reference.  For points x (n, d)
// and centroids cent (k, d), any k >= 1 and d >= 1, it computes
//
//   dist[p, c] = max(|x_p|^2 - 2 x_p . c + |c|^2, 0)
//   labels[p]  = argmin_c dist[p, c]   (ties to the lowest index)
//   min_sq[p]  = min_c dist[p, c]
//
// and the (n, k) distance tile never reaches device memory.
//
// Numerics: every dot product, and every norm, is one fmaf chain over the
// feature axis in index order (the shared core, kmeans_core.cuh), so two
// identical centroids (kmeans++ seeds duplicates when a program has few
// distinct kernels) get bit-identical distances; the expanded formula is
// kept (not (x - c)^2) because the reference decides near-ties in its
// rounding.  The argmin keeps the lowest index on ties: each thread scans
// its centroids in increasing order with a strict '<', the 16 threads
// sharing a point leave (distance, index) pairs in shared memory, which
// one thread per point reduces preferring the smaller index on equal
// distances, and column tiles are merged in increasing order with a
// strict '<'.
//
// What bounds it on this card: at the sequential path's shape (n = 2425,
// d = 256, k = 48) one launch does 2 n k d ~ 60 MFLOP (~0.9 us at the
// 67 TFLOP/s float32 peak) and reads ~2.5 MB (~0.75 us at 3.35 TB/s):
// operations, narrowly, and at that size the latency of getting the tiles
// on chip.  Shared-memory wavefronts bind the design below (a 1 x 4 tile
// reads five 16-byte values per 16 FMAs).
//
// Design: a block owns 16 points (152 blocks at n = 2425) and walks the
// centroids in tiles of 64 (one tile for k <= 64).  The shared core issues
// the point rows and the tile's centroid rows as cp.async copies into an
// 8-stage ring of 32-feature chunks, so at d = 256 every chunk of both is
// in flight at once (92 KB of shared memory, two blocks an SM); larger d
// streams through the same ring.  Each thread keeps 1 x 4 dot products
// (its point, columns tx + 16 m; a warp covers 8 points x 4 column
// lanes, so its loads are free of bank conflicts), and the threads
// with t < 80 also chain the squared norm of one staged row.  Rows past n
// or k stage as zeros.

#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

#include "kmeans_core.cuh"

namespace {

using kmcore::TC;

constexpr int TP = 16;            // points per block
constexpr int THREADS = 256;
constexpr int STAGES = 8;         // ring depth: all of d = 256 in flight
using T4 = kmcore::Tile<TP, 1, 4, THREADS>;   // 1 x 4 dot products a thread
constexpr int TXN = T4::TXN;
constexpr int SMEM =
    4 * (STAGES * T4::STAGE + (TP + TC) + TP + TC + 2 * TP * TXN);

template <bool VEC4>
__global__ void __launch_bounds__(THREADS, 2)
k4_assign_kernel(const float* __restrict__ x, const float* __restrict__ cent,
                 int* __restrict__ labels, float* __restrict__ min_sq, int n,
                 int d, int k) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  int* rows = reinterpret_cast<int*>(smem + STAGES * T4::STAGE);
  float* x2s = reinterpret_cast<float*>(rows + TP + TC);
  float* c2s = x2s + TP;
  float* red_d = c2s + TC;                       // TP x TXN partial minima
  int* red_i = reinterpret_cast<int*>(red_d + TP * TXN);
  const int tx = T4::tx(), ty = T4::ty();
  const int p0 = blockIdx.x * TP;
  float best = kmcore::inf();
  int arg = 0;
  for (int c0 = 0; c0 < k; c0 += TC) {
    for (int e = threadIdx.x; e < TP + TC; e += THREADS)
      rows[e] = e < TP ? (p0 + e < n ? p0 + e : -1)
                       : (c0 + e - TP < k ? c0 + e - TP : -1);
    __syncthreads();
    float acc[1][T4::CT], nrm;
    kmcore::tile_dots<T4, STAGES, VEC4, true>(x, cent, d, rows, ring, acc,
                                              nrm);
    if (threadIdx.x < TP) x2s[threadIdx.x] = nrm;
    else if (threadIdx.x < TP + TC) c2s[threadIdx.x - TP] = nrm;
    __syncthreads();
    const float x2 = x2s[ty];
    float cb = kmcore::inf();
    int ca = INT_MAX;
#pragma unroll
    for (int m = 0; m < T4::CT; ++m) {
      const int j = tx + TXN * m;
      if (c0 + j < k) {
        const float dist = kmcore::sq_dist(x2, acc[0][m], c2s[j]);
        if (dist < cb) { cb = dist; ca = c0 + j; }
      }
    }
    red_d[ty * TXN + tx] = cb;
    red_i[ty * TXN + tx] = ca;
    __syncthreads();
    // the 16 column lanes of a point: smallest distance, then smallest
    // index; then the tile against the earlier tiles' lower indices
    if (threadIdx.x < TP) {
      const float* rd = red_d + threadIdx.x * TXN;
      const int* ri = red_i + threadIdx.x * TXN;
      float bd = rd[0];
      int bi = ri[0];
#pragma unroll
      for (int q = 1; q < TXN; ++q)
        if (kmcore::closer(rd[q], ri[q], bd, bi)) { bd = rd[q]; bi = ri[q]; }
      if (bd < best) { best = bd; arg = bi; }
    }
    __syncthreads();              // rows, x2s, c2s, red: the next tile's
  }
  const int p = p0 + threadIdx.x;
  if (threadIdx.x < TP && p < n) {
    labels[p] = arg;
    min_sq[p] = best;
  }
}

bool g_configured = false;

int configure() {
  if (g_configured) return 0;
  cudaFuncSetAttribute(k4_assign_kernel<true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  cudaFuncSetAttribute(k4_assign_kernel<false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  g_configured = true;
  return 0;
}

}  // namespace

// x: (n, d) f32; cent: (k, d) f32; labels: (n,) int32; min_sq: (n,) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int kmeans_assign(const float* x, const float* cent, int* labels,
                             float* min_sq, int n, int d, int k, void* stream) {
  if (n < 0 || d < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int err = configure();
  if (err != 0) return err;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = d % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(cent) % 16 == 0;
  const int grid = (n + TP - 1) / TP;
  if (vec4)
    k4_assign_kernel<true><<<grid, THREADS, SMEM, s>>>(x, cent, labels, min_sq,
                                                       n, d, k);
  else
    k4_assign_kernel<false><<<grid, THREADS, SMEM, s>>>(x, cent, labels,
                                                        min_sq, n, d, k);
  return static_cast<int>(cudaGetLastError());
}
