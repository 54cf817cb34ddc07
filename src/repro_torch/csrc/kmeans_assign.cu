// K2 — fused masked K-Means assignment + Lloyd statistics for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `kmeans_assign_fused_fwd`
// (src/repro/kernels/kmeans_assign/kernel.py, body `_kmeans_fused_kernel`).
// For points x (n, d), centroids cent (k, d), live-centroid mask cmask (k,)
// and real-point mask pmask (n,) it computes
//
//   dist[p, c] = max(|x_p|^2 - 2 x_p . c + |c|^2, 0), +inf where cmask[c] == 0
//   labels[p]  = argmin_c dist[p, c]   (ties to the lowest index)
//   mind[p]    = min_c dist[p, c] * pmask[p]
//   sums[c, :] = sum_{p : labels[p] = c} pmask[p] * x[p, :]
//   cnts[c]    = sum_{p : labels[p] = c} pmask[p]
//
// What bounds it on this card: at the main-path shape (n = 4096, d = 256,
// k = 48) one launch does ~0.1 GFLOP (~1.5 us on float32 CUDA cores) and
// moves ~4.3 MB (~1.3 us at 3.35 TB/s), so operations bind, narrowly; the
// sweep launches it (iters + 1) times per candidate K, so launch latency and
// host overhead, not the bound, dominate a request.
//
// Design: a block owns a tile of PTS points; one warp per point keeps the
// point's row in registers (lanes over d), takes |x|^2 and each x . c with a
// fixed butterfly reduction, and keeps the running argmin with a strict
// '<', so ties go to the lowest index as jnp.argmin does.  The TPU kernel
// carries sums and counts across its sequential grid; blocks here run in
// no order, so each block writes its own partial sums (in point order) and a
// second pass adds the partials in block order.  No float atomics: the sums
// are the same bits on every run, which keeps 50 Lloyd steps from turning
// summation-order noise into label flips.

#include <cuda_runtime.h>

namespace {

constexpr int PTS = 32;       // points per block
constexpr int THREADS = 256;  // 8 warps, 4 points each
constexpr int MAX_K = 64;
constexpr int MAX_DPL = 16;   // d <= 512

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ cent,
                     const float* __restrict__ cmask,
                     const float* __restrict__ pmask, int* __restrict__ labels,
                     float* __restrict__ mind, float* __restrict__ psums,
                     float* __restrict__ pcnts, int n, int d, int k) {
  __shared__ float c2s[MAX_K];
  __shared__ int lab_s[PTS];
  __shared__ float pm_s[PTS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p0 = blockIdx.x * PTS;

  for (int c = warp; c < k; c += THREADS / 32) {
    float part = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float v = cent[static_cast<size_t>(c) * d + j];
      part += v * v;
    }
    part = warp_sum(part);
    if (lane == 0) c2s[c] = part;
  }
  __syncthreads();

  for (int pl = warp; pl < PTS; pl += THREADS / 32) {
    const int p = p0 + pl;
    if (p >= n) {
      if (lane == 0) { lab_s[pl] = -1; pm_s[pl] = 0.f; }
      continue;
    }
    float xr[MAX_DPL];
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_DPL; ++i) {
      const int j = lane + 32 * i;
      xr[i] = (j < d) ? x[static_cast<size_t>(p) * d + j] : 0.f;
      part += xr[i] * xr[i];
    }
    const float x2 = warp_sum(part);
    float best = __int_as_float(0x7f800000);  // +inf
    int arg = 0;
    for (int c = 0; c < k; ++c) {
      const float* crow = cent + static_cast<size_t>(c) * d;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_DPL; ++i) {
        const int j = lane + 32 * i;
        if (j < d) dot += xr[i] * crow[j];
      }
      dot = warp_sum(dot);
      float dist = fmaxf(x2 - 2.f * dot + c2s[c], 0.f);
      if (!(cmask[c] > 0.f)) dist = __int_as_float(0x7f800000);
      if (dist < best) { best = dist; arg = c; }
    }
    if (lane == 0) {
      const float pm = pmask[p];
      labels[p] = arg;
      mind[p] = best * pm;
      lab_s[pl] = arg;
      pm_s[pl] = pm;
    }
  }
  __syncthreads();

  // this block's partial sums and counts, in point order
  float* bs = psums + static_cast<size_t>(blockIdx.x) * k * d;
  for (int j = threadIdx.x; j < d; j += THREADS) {
    for (int c = 0; c < k; ++c) {
      float acc = 0.f;
      for (int pl = 0; pl < PTS; ++pl)
        if (lab_s[pl] == c)
          acc += pm_s[pl] * x[static_cast<size_t>(p0 + pl) * d + j];
      bs[static_cast<size_t>(c) * d + j] = acc;
    }
  }
  for (int c = threadIdx.x; c < k; c += THREADS) {
    float acc = 0.f;
    for (int pl = 0; pl < PTS; ++pl)
      if (lab_s[pl] == c) acc += pm_s[pl];
    pcnts[static_cast<size_t>(blockIdx.x) * k + c] = acc;
  }
}

// fixed-order reduction of the per-block partials: element i of (k*d + k)
__global__ void kmeans_reduce_kernel(const float* __restrict__ psums,
                                     const float* __restrict__ pcnts,
                                     float* __restrict__ sums,
                                     float* __restrict__ cnts, int nblk,
                                     int kd, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kd) {
    float acc = 0.f;
    for (int b = 0; b < nblk; ++b) acc += psums[static_cast<size_t>(b) * kd + i];
    sums[i] = acc;
  } else if (i < kd + k) {
    const int c = i - kd;
    float acc = 0.f;
    for (int b = 0; b < nblk; ++b) acc += pcnts[static_cast<size_t>(b) * k + c];
    cnts[c] = acc;
  }
}

}  // namespace

// x: (n, d) f32; cent: (k, d) f32; cmask: (k,) f32; pmask: (n,) f32;
// labels: (n,) int32; mind: (n,) f32; psums: (ceil(n/32), k, d) f32 and
// pcnts: (ceil(n/32), k) f32 scratch; sums: (k, d) f32; cnts: (k,) f32.
// Returns cudaGetLastError() after the two launches.
extern "C" int kmeans_assign_fused(const float* x, const float* cent,
                                   const float* cmask, const float* pmask,
                                   int* labels, float* mind, float* psums,
                                   float* pcnts, float* sums, float* cnts,
                                   int n, int d, int k, void* stream) {
  if (n < 0 || d < 1 || k < 1 || k > MAX_K || d > 32 * MAX_DPL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = (n + PTS - 1) / PTS;
  if (nblk > 0)
    kmeans_assign_kernel<<<nblk, THREADS, 0, s>>>(x, cent, cmask, pmask, labels,
                                                  mind, psums, pcnts, n, d, k);
  const int total = k * d + k;
  kmeans_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(psums, pcnts, sums,
                                                           cnts, nblk, k * d, k);
  return static_cast<int>(cudaGetLastError());
}
