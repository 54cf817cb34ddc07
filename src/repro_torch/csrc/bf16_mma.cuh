// bf16 tensor-core helpers shared by K7 and K7b: mma.sync m16n8k16 (bf16
// in, float32 accumulate) and its fragment loads and packs, as the PTX ISA
// (8.x) defines them.  Fragments of a warp (lane = 4 g + t):
//   A 16x16 row-major: a[0] (row g, cols 2t, 2t+1), a[1] (row g+8, same),
//                      a[2] (row g, cols 2t+8, 2t+9), a[3] (row g+8, same);
//   B 16x8, "col":     b0 (rows 2t, 2t+1 of col g), b1 (rows 2t+8, 2t+9);
//   C 16x8:            c[0], c[1] (row g, cols 2t, 2t+1), c[2], c[3] (row
//                      g+8, same).
// The C fragments of two neighbouring 8-column tiles are, packed to bf16
// (or split into bf16 high and low parts), the A fragment of their 16
// columns.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16mma {

// two consecutive bf16 values (4-byte aligned) as one register
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (x0, x1) rounded to bf16, x0 in the low half
__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) as bf16 (x0 in the low half) and what that rounding lost, as
// bf16: hi + lo keeps ~16 bits of each value
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// c += a (16x16, row) . b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace bf16mma
