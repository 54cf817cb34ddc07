// K4 — unmasked K-Means assignment for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `kmeans_assign_fwd`
// (src/repro/kernels/kmeans_assign/kernel.py, body `_kmeans_kernel`), the
// assignment step of the sequential K-Means reference.  For points x (n, d)
// and centroids cent (k, d) it computes
//
//   dist[p, c] = max(|x_p|^2 - 2 x_p . c + |c|^2, 0)
//   labels[p]  = argmin_c dist[p, c]   (ties to the lowest index)
//   min_sq[p]  = min_c dist[p, c]
//
// and the (n, k) distance tile never reaches device memory.
//
// What bounds it on this card: at the sequential path's shape (n = 2425,
// d = 256, k <= 48) one launch does 2 n k d ~ 60 MFLOP (~0.9 us of float32
// CUDA-core time) and reads ~2.5 MB (~0.75 us at 3.35 TB/s), so operations
// bind, narrowly; the Lloyd loop launches it iters + 1 times per candidate
// K, so launch latency dominates a fit.
//
// Design: a block owns TP = 32 points and walks the centroids in chunks of
// KC = 64 and the feature axis in chunks of DC = 32, staging both tiles in
// shared memory (padded rows, no bank conflicts).  Each of the 256 threads
// keeps a 2 x 4 register tile of dot products (2 points x 4 centroids), so
// any d and any k run in ~17 KB of shared memory.  Every dot product, and
// every norm, is one fmaf chain over the feature axis in index order, so
// two identical centroids (kmeans++ seeds duplicates when a program has few
// distinct kernels) get bit-identical distances; the expanded formula is
// kept (not (x - c)^2) because the reference decides near-ties in its
// rounding.  The argmin keeps the lowest index on ties: each thread scans
// its centroids in increasing order with a strict '<', and the 16 threads
// sharing a point reduce (distance, index) pairs preferring the smaller
// index on equal distances; chunks are merged in increasing order with a
// strict '<'.

#include <cuda_runtime.h>

namespace {

constexpr int TP = 32;        // points per block
constexpr int KC = 64;        // centroids per chunk
constexpr int DC = 32;        // feature chunk staged in shared memory
constexpr int THREADS = 256;  // 16 point pairs x 16 centroid lanes

__global__ void __launch_bounds__(THREADS)
kmeans_assign_seq_kernel(const float* __restrict__ x,
                         const float* __restrict__ cent,
                         int* __restrict__ labels, float* __restrict__ min_sq,
                         int n, int d, int k) {
  __shared__ float xs[TP][DC + 1];
  __shared__ float cs[KC][DC + 1];
  __shared__ float x2s[TP];
  __shared__ float c2s[KC];
  const int t = threadIdx.x;
  const int pr = t >> 4;        // this thread's points: 2 pr, 2 pr + 1
  const int cl = t & 15;        // this thread's centroids: cl + 16 m
  const int p0 = blockIdx.x * TP;

  float best[2] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000)};
  int arg[2] = {0, 0};

  for (int c0 = 0; c0 < k; c0 += KC) {
    float acc[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[a][m] = 0.f;
    float nrm = 0.f;            // |x|^2 (t < TP, first chunk) or |c|^2 (t < KC)
    for (int d0 = 0; d0 < d; d0 += DC) {
      for (int e = t; e < TP * DC; e += THREADS) {
        const int row = e / DC, col = e % DC;
        const int gp = p0 + row, gd = d0 + col;
        xs[row][col] = (gp < n && gd < d) ? x[static_cast<size_t>(gp) * d + gd] : 0.f;
      }
      for (int e = t; e < KC * DC; e += THREADS) {
        const int row = e / DC, col = e % DC;
        const int gc = c0 + row, gd = d0 + col;
        cs[row][col] = (gc < k && gd < d) ? cent[static_cast<size_t>(gc) * d + gd] : 0.f;
      }
      __syncthreads();
      // norms: one fmaf chain per row, in feature order (as the dots)
      if (t < KC) {
        for (int dd = 0; dd < DC; ++dd) nrm = fmaf(cs[t][dd], cs[t][dd], nrm);
      } else if (c0 == 0 && t - KC < TP) {
        const int row = t - KC;
        for (int dd = 0; dd < DC; ++dd) nrm = fmaf(xs[row][dd], xs[row][dd], nrm);
      }
#pragma unroll 8
      for (int dd = 0; dd < DC; ++dd) {
        const float a0 = xs[2 * pr][dd], a1 = xs[2 * pr + 1][dd];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float b = cs[cl + 16 * m][dd];
          acc[0][m] = fmaf(a0, b, acc[0][m]);
          acc[1][m] = fmaf(a1, b, acc[1][m]);
        }
      }
      __syncthreads();
    }
    if (t < KC) c2s[t] = nrm;
    else if (c0 == 0 && t - KC < TP) x2s[t - KC] = nrm;
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float x2 = x2s[2 * pr + a];
      float cb = __int_as_float(0x7f800000);
      int ca = 0x7fffffff;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int c = c0 + cl + 16 * m;
        if (c < k) {
          const float dist = fmaxf(x2 - 2.f * acc[a][m] + c2s[cl + 16 * m], 0.f);
          if (dist < cb) { cb = dist; ca = c; }
        }
      }
      // the 16 lanes of this point: smallest distance, then smallest index
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, cb, off);
        const int oa = __shfl_xor_sync(0xffffffffu, ca, off);
        if (ob < cb || (ob == cb && oa < ca)) { cb = ob; ca = oa; }
      }
      if (cb < best[a]) { best[a] = cb; arg[a] = ca; }
    }
    __syncthreads();            // c2s is rewritten by the next chunk
  }
  if (cl == 0) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int gp = p0 + 2 * pr + a;
      if (gp < n) {
        labels[gp] = arg[a];
        min_sq[gp] = best[a];
      }
    }
  }
}

}  // namespace

// x: (n, d) f32; cent: (k, d) f32; labels: (n,) int32; min_sq: (n,) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int kmeans_assign(const float* x, const float* cent, int* labels,
                             float* min_sq, int n, int d, int k, void* stream) {
  if (n < 0 || d < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kmeans_assign_seq_kernel<<<(n + TP - 1) / TP, THREADS, 0, s>>>(
      x, cent, labels, min_sq, n, d, k);
  return static_cast<int>(cudaGetLastError());
}
