// Known-good R4: integer counters may use atomics; floats are summed in a
// fixed order.  A comment that says atomicAdd(&out[i], v) is no code.
#include <cuda_runtime.h>

__global__ void count_rows(const int* dst, int* __restrict__ counts, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) atomicAdd(&counts[dst[i]], 1);
}

__global__ void row_sum(const float* __restrict__ v, float* out, int w) {
  float acc = 0.f;
  for (int j = 0; j < w; ++j) acc += v[blockIdx.x * w + j];
  out[blockIdx.x] = acc;
}
