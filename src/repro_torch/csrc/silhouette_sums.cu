// K3 — blocked silhouette sums for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `silhouette_sums_fwd`
// (src/repro/kernels/kmeans_assign/kernel.py, body `_sil_sums_kernel`).
// For points x (n, d) and a (point-masked) one-hot onehot (n, k) it computes
//
//   sums[i, c] = sum_j sqrt(max(|x_i|^2 - 2 x_i . x_j + |x_j|^2, 0)) * onehot[j, c]
//
// without ever materialising the (n, n) distance matrix.
//
// What bounds it on this card: operations.  At the main-path shape
// (n = 4096, d = 256, k = 48) the distances alone are 2 n^2 d ~ 8.6 GFLOP
// against ~4.9 MB of inputs and outputs, ~130 us of float32 CUDA-core time
// at the published peak; the dense contraction with the one-hot adds
// 2 n^2 k ~ 1.6 GFLOP.
//
// Design: a block owns TI rows i and streams tiles of TJ rows j.  Each
// (TI x TJ) distance tile is a small float32 GEMM over d chunks staged in
// shared memory (each thread 2 x 4 outputs), turned into distances in
// place, then contracted against the j-tile of the one-hot (also in shared
// memory); each thread keeps 8 of the block's (TI x k) sums in registers for
// the whole sweep over j.  Row norms come from a first small kernel that
// accumulates in the tile dot's own order, so self-distances are exactly 0.
// All sums run in a fixed order (deterministic).  Making it fast is later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int TI = 32;        // rows i per block
constexpr int TJ = 64;        // rows j per tile
constexpr int DC = 32;        // d chunk staged in shared memory
constexpr int THREADS = 256;
constexpr int MAX_K = 64;

// |x_i|^2 accumulated with the same sequential fmaf order as the tile dot
// below, so a point's distance to itself (or to an identical point) cancels
// to exactly 0 under the sqrt instead of leaving a float32 residual.
__global__ void sqnorm_kernel(const float* __restrict__ x,
                              float* __restrict__ sq, int n, int d) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const float* xr = x + static_cast<size_t>(row) * d;
  float s = 0.f;
  for (int j = 0; j < d; ++j) s = fmaf(xr[j], xr[j], s);
  sq[row] = s;
}

__global__ void __launch_bounds__(THREADS)
silhouette_sums_kernel(const float* __restrict__ x,
                       const float* __restrict__ onehot,
                       const float* __restrict__ sq, float* __restrict__ out,
                       int n, int d, int k) {
  __shared__ float xi[TI][DC + 1];
  __shared__ float xj[TJ][DC + 1];
  __shared__ float dt[TI][TJ + 1];
  __shared__ float oh[TJ][MAX_K];
  const int t = threadIdx.x;
  const int i0 = blockIdx.x * TI;
  // distance-tile ownership: rows 2r, 2r+1 and columns 4q .. 4q+3
  const int r = t >> 4, q = t & 15;
  // contraction ownership: row ci, clusters cc + 8m
  const int ci = t >> 3, cc = t & 7;
  float acc_out[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) acc_out[m] = 0.f;

  for (int j0 = 0; j0 < n; j0 += TJ) {
    float acc[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[a][m] = 0.f;
    for (int d0 = 0; d0 < d; d0 += DC) {
      for (int e = t; e < TI * DC; e += THREADS) {
        const int row = e / DC, col = e % DC;
        const int gi = i0 + row, gd = d0 + col;
        xi[row][col] = (gi < n && gd < d) ? x[static_cast<size_t>(gi) * d + gd] : 0.f;
      }
      for (int e = t; e < TJ * DC; e += THREADS) {
        const int row = e / DC, col = e % DC;
        const int gj = j0 + row, gd = d0 + col;
        xj[row][col] = (gj < n && gd < d) ? x[static_cast<size_t>(gj) * d + gd] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DC; ++dd) {
        const float a0 = xi[2 * r][dd], a1 = xi[2 * r + 1][dd];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float b = xj[4 * q + m][dd];
          acc[0][m] = fmaf(a0, b, acc[0][m]);
          acc[1][m] = fmaf(a1, b, acc[1][m]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int gi = i0 + 2 * r + a, gj = j0 + 4 * q + m;
        dt[2 * r + a][4 * q + m] =
            (gi < n && gj < n)
                ? sqrtf(fmaxf(sq[gi] - 2.f * acc[a][m] + sq[gj], 0.f))
                : 0.f;
      }
    for (int e = t; e < TJ * MAX_K; e += THREADS) {
      const int row = e / MAX_K, c = e % MAX_K;
      const int gj = j0 + row;
      oh[row][c] = (gj < n && c < k) ? onehot[static_cast<size_t>(gj) * k + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < TJ; ++jj) {
      const float dv = dt[ci][jj];
#pragma unroll
      for (int m = 0; m < 8; ++m) acc_out[m] += dv * oh[jj][cc + 8 * m];
    }
    __syncthreads();
  }
  const int gi = i0 + ci;
  if (gi < n) {
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int c = cc + 8 * m;
      if (c < k) out[static_cast<size_t>(gi) * k + c] = acc_out[m];
    }
  }
}

}  // namespace

// x: (n, d) f32; onehot: (n, k) f32; sq: (n,) f32 scratch (row norms);
// out: (n, k) f32.  Returns cudaGetLastError() after the two launches.
extern "C" int silhouette_sums(const float* x, const float* onehot, float* sq,
                               float* out, int n, int d, int k, void* stream) {
  if (n < 0 || d < 1 || k < 1 || k > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sqnorm_kernel<<<(n + 255) / 256, 256, 0, s>>>(x, sq, n, d);
  silhouette_sums_kernel<<<(n + TI - 1) / TI, THREADS, 0, s>>>(x, onehot, sq,
                                                               out, n, d, k);
  return static_cast<int>(cudaGetLastError());
}
