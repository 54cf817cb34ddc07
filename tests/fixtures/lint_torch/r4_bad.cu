// Known-bad R4: float atomics sum in a run-dependent order.
#include <cuda_runtime.h>

__global__ void scatter_sum(const float* __restrict__ v, const int* dst,
                            float* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) atomicAdd(&out[dst[i]], v[i]);
}

__device__ void bump(double* acc, int j) {
  atomicAdd(acc + j, 1.0);
}
