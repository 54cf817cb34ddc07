// 3xTF32 tensor-core products for the port's float32 kernels (K1
// rgcn_fused.cu, K8 ssd_intra_chunk.cu): mma.sync m16n8k8 with TF32
// operands, fragment loads from shared memory, the operand split, and the
// cp.async copies that stage the operands.
//
// Why a split: one TF32 pass keeps 10 explicit mantissa bits (~1e-3
// relative), too coarse for the kernels' float32 tolerance.  Each operand
// is split as hi = cvt.rna.tf32.f32(a), lo = cvt.rna.tf32.f32(a - hi) (the
// same bits from two integer instructions, `to_tf32`), and
//   a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b
// (small terms first, float32 accumulators); the dropped lo_a.lo_b and the
// rounding of lo leave ~2^-21 relative error per product.  A TF32 x TF32
// product is exact in the tensor core, which adds in float32.  Three passes
// at the TF32 rate (495 TFLOP/s dense on an H100 SXM) still beat float32
// FMAs (67 TFLOP/s) by ~2.5x.
//
// Fragments (PTX ISA, mma.m16n8k8 .tf32), with g = lane / 4, t = lane % 4:
//   A (16 x 8, row): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, col):  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// The loaders read a tile whose origin is `p` with row stride `ld` floats.
// Bank conflicts vanish when ld = 4 (mod 32) for the loaders that index
// rows by g (load_a_rm, load_b_nk) and ld = 8 (mod 32) for those that
// index rows by t (load_a_km, load_b_kn).  PTX as the ISA defines it; no
// PyTorch or CUTLASS headers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// a float32 rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest on
// the low 13 mantissa bits, ties away from zero), as its bits, for finite
// x: the bits are sign-magnitude, so adding half a TF32 ulp to the
// magnitude and clearing the low 13 bits rounds half away from zero.  Two
// integer instructions: cvt.rna.tf32.f32 itself issues at a fraction of
// the integer rate, and the split needs two roundings per operand.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

template <int N>
__device__ __forceinline__ void split(const float (&v)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = to_tf32(v[i]);
    lo[i] = to_tf32(v[i] - __uint_as_float(hi[i]));
  }
}

__device__ __forceinline__ FragA split_a(const float (&v)[4]) {
  FragA f;
  split(v, f.hi, f.lo);
  return f;
}

__device__ __forceinline__ FragB split_b(const float (&v)[2]) {
  FragB f;
  split(v, f.hi, f.lo);
  return f;
}

// A stored row-major, [m][k]
__device__ __forceinline__ void load_a_rm(const float* p, int ld,
                                          float (&v)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  v[0] = p[g * ld + t];
  v[1] = p[(g + 8) * ld + t];
  v[2] = p[g * ld + t + 4];
  v[3] = p[(g + 8) * ld + t + 4];
}

// A stored k-major, [k][m]
__device__ __forceinline__ void load_a_km(const float* p, int ld,
                                          float (&v)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  v[0] = p[t * ld + g];
  v[1] = p[t * ld + g + 8];
  v[2] = p[(t + 4) * ld + g];
  v[3] = p[(t + 4) * ld + g + 8];
}

// B stored [k][n]
__device__ __forceinline__ void load_b_kn(const float* p, int ld,
                                          float (&v)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  v[0] = p[t * ld + g];
  v[1] = p[(t + 4) * ld + g];
}

// B stored [n][k]
__device__ __forceinline__ void load_b_nk(const float* p, int ld,
                                          float (&v)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  v[0] = p[g * ld + t];
  v[1] = p[g * ld + t + 4];
}

// d += a . b, one TF32 pass
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[j0 + jj] += a . b[jj] for jj < 4 in 3xTF32, the passes issued term
// by term: the three MMAs into one accumulator depend on each other, so
// the four accumulators' MMAs are interleaved between them (issued per
// accumulator, each triple waits on its own results)
template <int M>
__device__ __forceinline__ void mma3_x4(float (&acc)[M][4], int j0,
                                        const FragA& a, const FragB (&b)[4]) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) mma(acc[j0 + jj], a.lo, b[jj].hi);
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) mma(acc[j0 + jj], a.hi, b[jj].lo);
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) mma(acc[j0 + jj], a.hi, b[jj].hi);
}

// an accumulator pair (columns n, n + 1 of a row of `width` floats) into
// dst = &row[n], `left` = width - n of which are real; one 8-byte store
// where the width is even (n is even, so dst is 8-byte aligned)
__device__ __forceinline__ void store_pair(float* dst, float a, float b,
                                           int left, int width) {
  if (left <= 0) return;
  if ((width & 1) == 0) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  } else {
    dst[0] = a;
    if (left > 1) dst[1] = b;
  }
}

// ---- staging ----------------------------------------------------------------

// 16 bytes global -> shared; zeros when !valid (src is then not read, but
// must still be a valid address: pass the tensor's base)
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

// cp.async.wait_group with a count known only at run time (at most 7
// pending groups are waited for exactly; more wait for fewer, which is safe)
__device__ __forceinline__ void cp_async_wait_dyn(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// rows [0, rows) x columns [0, cols_pad) of a row-major float matrix into
// shared memory with row stride `ld`: element (r, c) is read from
// src[r * src_ld + c] when r < rows_valid and c < cols_valid, else written
// as 0.  vec16: cols_pad, src_ld and src's address are multiples of 4
// floats, so every copy moves 16 bytes; otherwise 4-byte copies.  The
// block's `nthreads` threads share the copies, starting at thread `tid`.
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, size_t src_ld,
                                           int rows, int rows_valid,
                                           int cols_pad, int cols_valid,
                                           bool vec16, int tid, int nthreads) {
  if (vec16) {
    const int parts = cols_pad >> 2;
    for (int i = tid; i < rows * parts; i += nthreads) {
      const int r = i / parts, c = (i - r * parts) << 2;
      const bool valid = r < rows_valid && c < cols_valid;
      cp_async16(dst + r * ld + c, valid ? src + r * src_ld + c : src, valid);
    }
  } else {
    for (int i = tid; i < rows * cols_pad; i += nthreads) {
      const int r = i / cols_pad, c = i - r * cols_pad;
      const bool valid = r < rows_valid && c < cols_valid;
      cp_async4(dst + r * ld + c, valid ? src + r * src_ld + c : src, valid);
    }
  }
}

}  // namespace tf32x3
