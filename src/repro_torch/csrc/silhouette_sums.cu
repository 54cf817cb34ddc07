// K3 — silhouette sums for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `silhouette_sums_fwd`
// (src/repro/kernels/kmeans_assign/kernel.py, body `_sil_sums_kernel`).
// For B programs, each with points x[b] (n, d) and a (point-masked)
// one-hot onehot[b] (n, k <= 64), it computes
//
//   sums[b, i, c] = sum_j sqrt(max(|x_bi|^2 - 2 x_bi.x_bj + |x_bj|^2, 0))
//                   * onehot[b, j, c]
//
// without ever materialising an (n, n) distance matrix.  The programs are
// the grid's y dimension in all three launches, and each has its own
// slice of the scratch, so a program's sums are the same bits at any B
// and beside any other programs (B = 1 is the one-program call); one
// call covers one candidate K for every program of a sweep dispatch.
//
// What bounds it on this card: float32 operations.  Only the J rows j whose
// onehot row is not all zero (live rows) contribute, and each contributes
// to the clusters where its row is nonzero (one for a one-hot row).  At the
// sweep's main shape (n = 4096, d = 256, k = 48, J = 1200 live rows) that
// is 2 n J d ~ 2.5e9 operations against ~5 MB of inputs and outputs:
// ~37 us at the 67 TFLOP/s float32 peak (the TPU kernel and the first port
// walked all n rows j, 71 % of them multiplying by zero).
//
// Design, three launches with no host sync, each over (block, program):
// 1. sil_rows_kernel (32 rows a block, staged through shared memory in
//    128-column chunks): |x_i|^2 as a sequential fmaf chain over d — the
//    order of the tile dot products below, so a point's distance to itself
//    or to an identical point is exactly 0 — and the number of nonzeros of
//    each onehot row, with per-block totals;
// 2. sil_compact_kernel: every block adds up the totals of its program's
//    blocks before it and writes its live rows, in order: their indices
//    and norms, and a CSR of the onehot over them (entry offsets; entries
//    (cluster, value)); the program's last block writes its live count J;
// 3. silhouette_sums_kernel: a block owns TI = 32 rows i of one program
//    for the whole sweep over that program's live rows j, read from its
//    count in device memory, in tiles of TJ = 256.  Each thread owns an
//    8 x 4 register tile of the
//    32 x 256 dot products (float32 FMAs from 16-byte shared-memory loads;
//    not TF32, which would change the numbers).  The 32-column chunks of
//    x_i and of the gathered x_j rows stream through a 3-stage cp.async
//    ring, rows padded to 36 floats so the loads hit distinct banks; each
//    tile's norms and CSR entries are copied in beside its first chunk,
//    and the next tile's first chunks are in flight while this tile's
//    distances are contracted.  The distance tile goes to shared memory
//    and is contracted with the tile's CSR entries only: lane l of 8 takes
//    every 8th live row and adds into its own (32 x k) slab in shared
//    memory, no atomics; the 8 slabs are summed in a fixed order at the
//    end.  Deterministic.  What holds it back now: every block re-reads
//    all gathered x_j rows from L2 (~180 MB at the main shape), and the
//    sweep recomputes the same distances for each candidate K.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 64;
constexpr int RT = 32;           // rows per block of kernels 1-2 (2: a warp)

// One program's slice of the scratch: iscratch holds, per program, nnz
// (n), the block totals (2 nb), live_idx (n), row_ptr (n + 1), count (1)
// and ent_c (n k) ints; fscratch sq (n), live_sq (n) and ent_w (n k).
struct Scratch {
  int *nnz, *blk, *live_idx, *row_ptr, *count, *ent_c;
  float *sq, *live_sq, *ent_w;
  __host__ __device__ Scratch(int* is, float* fs, int n, int k, int b) {
    const int nb = (n + RT - 1) / RT;
    const size_t ni = 3 * static_cast<size_t>(n) + 2 * nb + 2 +
                      static_cast<size_t>(n) * k;
    const size_t nf = 2 * static_cast<size_t>(n) + static_cast<size_t>(n) * k;
    nnz = is + b * ni;
    blk = nnz + n;
    live_idx = blk + 2 * nb;
    row_ptr = live_idx + n;
    count = row_ptr + n + 1;
    ent_c = count + 1;
    sq = fs + b * nf;
    live_sq = sq + n;
    ent_w = live_sq + n;
  }
};

// ---- 1. row norms and onehot row counts ------------------------------------

__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < RT / 32; ++w) s += red[w];
  return s;
}

// the block's RT onehot rows (contiguous: RT x k floats) into shared
// memory, read coalesced; slab row stride KP1
constexpr int KP1 = 65;

__device__ __forceinline__ void stage_onehot(const float* __restrict__ onehot,
                                             float* slab, int r0, int n,
                                             int k) {
  const float* src = onehot + static_cast<size_t>(r0) * k;
  const int total = min(RT, n - r0) * k;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int row = e / k;
    slab[row * KP1 + e - row * k] = src[e];
  }
}

// |x_row|^2 as the sequential fmaf chain over d (the order of the tile dot
// products below) and the nonzeros of each onehot row, with the block's
// totals.  A block of 4 warps stages its RT rows through shared memory in
// 128-column chunks read coalesced; warp 0 runs the chains.
constexpr int AT = 128;          // threads of sil_rows_kernel
constexpr int AC = 128;          // its d chunk

__global__ void __launch_bounds__(AT)
sil_rows_kernel(const float* __restrict__ x, const float* __restrict__ onehot,
                int* __restrict__ iscratch, float* __restrict__ fscratch,
                int n, int d, int k) {
  __shared__ float slab[RT * (AC + 1)];
  const int b = blockIdx.y;
  const Scratch scr(iscratch, fscratch, n, k, b);
  float* __restrict__ sq = scr.sq;
  int* __restrict__ nnz = scr.nnz;
  int* __restrict__ blk = scr.blk;
  x += static_cast<size_t>(b) * n * d;
  onehot += static_cast<size_t>(b) * n * k;
  const int r0 = blockIdx.x * RT, row = r0 + threadIdx.x;
  const int rows = min(RT, n - r0);
  float s = 0.f;
  for (int d0 = 0; d0 < d; d0 += AC) {
    __syncthreads();
#pragma unroll 8
    for (int q = 0; q < RT * AC / AT; ++q) {
      const int e = threadIdx.x + q * AT;
      const int r = e / AC, c = e - r * AC;
      slab[r * (AC + 1) + c] = r < rows && d0 + c < d
          ? x[static_cast<size_t>(r0 + r) * d + d0 + c] : 0.f;
    }
    __syncthreads();
    if (threadIdx.x < RT) {
#pragma unroll 8
      for (int c = 0; c < AC; ++c) {
        const float v = slab[threadIdx.x * (AC + 1) + c];
        s = fmaf(v, v, s);   // zero columns past d leave s unchanged
      }
    }
  }
  __syncthreads();
  stage_onehot(onehot, slab, r0, n, k);
  __syncthreads();
  if (threadIdx.x < RT) {
    int cnt = 0;
    if (row < n) {
      for (int c = 0; c < k; ++c) cnt += slab[threadIdx.x * KP1 + c] != 0.f;
      sq[row] = s;
      nnz[row] = cnt;
    }
    int live = cnt > 0;
    for (int off = 16; off > 0; off >>= 1) {
      live += __shfl_xor_sync(0xffffffffu, live, off);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    }
    if (threadIdx.x == 0) {
      blk[2 * blockIdx.x] = live;
      blk[2 * blockIdx.x + 1] = cnt;
    }
  }
}

// ---- 2. the live rows' CSR, in row order ------------------------------------

// exclusive prefix over the block of (a, b); returns the block totals
__device__ __forceinline__ void block_scan2(int& a, int& b, int& ta, int& tb,
                                            int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ib = b;
  for (int off = 1; off < 32; off <<= 1) {
    const int ua = __shfl_up_sync(0xffffffffu, ia, off);
    const int ub = __shfl_up_sync(0xffffffffu, ib, off);
    if (lane >= off) {
      ia += ua;
      ib += ub;
    }
  }
  __syncthreads();
  if (lane == 31) {
    red[2 * warp] = ia;
    red[2 * warp + 1] = ib;
  }
  __syncthreads();
  int pa = 0, pb = 0;
  ta = tb = 0;
  for (int w = 0; w < RT / 32; ++w) {
    if (w < warp) {
      pa += red[2 * w];
      pb += red[2 * w + 1];
    }
    ta += red[2 * w];
    tb += red[2 * w + 1];
  }
  a = pa + ia - a;
  b = pb + ib - b;
}

__global__ void __launch_bounds__(RT)
sil_compact_kernel(const float* __restrict__ onehot,
                   int* __restrict__ iscratch, float* __restrict__ fscratch,
                   int n, int k) {
  __shared__ float slab[RT * KP1];
  __shared__ int red[2 * (RT / 32)];
  const int b = blockIdx.y;
  const Scratch scr(iscratch, fscratch, n, k, b);
  const float* __restrict__ sq = scr.sq;
  const int* __restrict__ nnz = scr.nnz;
  const int* __restrict__ blk = scr.blk;
  int* __restrict__ live_idx = scr.live_idx;
  float* __restrict__ live_sq = scr.live_sq;
  int* __restrict__ row_ptr = scr.row_ptr;
  int* __restrict__ ent_c = scr.ent_c;
  float* __restrict__ ent_w = scr.ent_w;
  int* __restrict__ count = scr.count;
  onehot += static_cast<size_t>(b) * n * k;
  stage_onehot(onehot, slab, blockIdx.x * RT, n, k);
  int base_rows = 0, base_ents = 0;
  for (int bb = threadIdx.x; bb < blockIdx.x; bb += RT) {
    base_rows += blk[2 * bb];
    base_ents += blk[2 * bb + 1];
  }
  base_rows = block_sum(base_rows, red);
  base_ents = block_sum(base_ents, red);
  const int row = blockIdx.x * RT + threadIdx.x;
  const int cnt = row < n ? nnz[row] : 0;
  int pos = cnt > 0, ent = cnt, tot_rows, tot_ents;
  block_scan2(pos, ent, tot_rows, tot_ents, red);
  if (cnt > 0) {
    pos += base_rows;
    ent += base_ents;
    live_idx[pos] = row;
    live_sq[pos] = sq[row];
    row_ptr[pos] = ent;
    const float* oh = slab + threadIdx.x * KP1;
    for (int c = 0; c < k; ++c) {
      const float w = oh[c];
      if (w != 0.f) {
        ent_c[ent] = c;
        ent_w[ent] = w;
        ++ent;
      }
    }
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    count[0] = base_rows + tot_rows;
    row_ptr[base_rows + tot_rows] = base_ents + tot_ents;
  }
}

// ---- 3. distance tiles over the live rows, contracted with the CSR ----------

constexpr int TI = 32;           // rows i per block
constexpr int TJ = 256;          // live rows j per tile
constexpr int DC = 32;           // d chunk per stage
constexpr int DCP = DC + 4;      // staged row stride: 9 16-byte units (odd)
constexpr int STAGES = 3;        // cp.async ring depth
constexpr int THREADS = 256;     // 4 row groups x 64 column lanes
constexpr int LANES = THREADS / TI;  // contraction lanes per row i
constexpr int KP = MAX_K + 1;    // slab row stride (distinct banks per i)
constexpr int ECAP = 4 * TJ;     // CSR entries of a tile staged in smem
constexpr int STAGE = (TI + TJ) * DCP;       // floats of one ring buffer
constexpr int META = 2 * TJ + 1 + 2 * ECAP;  // a tile's norms and CSR
constexpr int SMEM = 4 * (STAGES * STAGE + LANES * TI * KP + 2 * META);
constexpr int PARTS = DC / 4;                // 16-byte parts of a row chunk
constexpr int PER_THREAD = ((TI + TJ) * PARTS + THREADS - 1) / THREADS;
static_assert(TI * (TJ + 1) <= STAGE, "distances alias one ring buffer");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
silhouette_sums_kernel(const float* __restrict__ x,
                       int* __restrict__ iscratch,
                       float* __restrict__ fscratch, float* __restrict__ out,
                       int n, int d, int k) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const Scratch scr(iscratch, fscratch, n, k, b);
  const float* __restrict__ sq = scr.sq;
  const int* __restrict__ live_idx = scr.live_idx;
  const float* __restrict__ live_sq = scr.live_sq;
  const int* __restrict__ row_ptr = scr.row_ptr;
  const int* __restrict__ ent_c = scr.ent_c;
  const float* __restrict__ ent_w = scr.ent_w;
  const int* __restrict__ count = scr.count;
  x += static_cast<size_t>(b) * n * d;
  out += static_cast<size_t>(b) * n * k;
  float* xs = smem;                          // STAGES x (TI + TJ) x DCP
  float* ds = xs + (STAGES - 1) * STAGE;     // TI x (TJ + 1) distances
  float* slab = xs + STAGES * STAGE;         // LANES x TI x KP partial sums
  float* meta = slab + LANES * TI * KP;      // 2 x META: double-buffered
  const int tid = threadIdx.x;
  const int ty = tid >> 6, tx = tid & 63;    // rows 8 ty .. +7, cols tx + 64 m
  const int i0 = blockIdx.x * TI;
  const int J = count[0];
  const int nch = (d + DC - 1) / DC;

  for (int e = tid; e < LANES * TI * KP; e += THREADS) slab[e] = 0.f;
  float sq_i[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gi = i0 + 8 * ty + r;
    sq_i[r] = gi < n ? sq[gi] : 0.f;
  }

  // the rows this thread stages (x_i rows first, then gathered x_j rows),
  // and the next tile's live rows and CSR bounds, loaded a tile ahead
  int grow[PER_THREAD], nidx[PER_THREAD], e_beg = 0, e_end = 0;
  auto fetch = [&](int p0) {
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int row = (tid + q * THREADS) / PARTS;
      const int p = p0 + row - TI;
      nidx[q] = row >= TI && row < TI + TJ && p < J ? live_idx[p] : -1;
    }
    if (p0 < J) {
      e_beg = row_ptr[p0];
      e_end = row_ptr[min(p0 + TJ, J)];
    }
  };
  auto stage = [&](int c, int buf) {
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int e = tid + q * THREADS;
      const int row = e / PARTS, part = e - row * PARTS;
      if (row >= TI + TJ) continue;
      const int col = c * DC + 4 * part;
      const bool valid = grow[q] >= 0 && col < d;
      cp_async16(xs + buf * STAGE + row * DCP + 4 * part,
                 valid ? x + static_cast<size_t>(grow[q]) * d + col : x,
                 valid);
    }
  };
  // tile p0's first STAGES - 1 chunks, and its norms and CSR into meta
  // buffer mb (with chunk 0's group); returns the tile's first entry
  auto prologue = [&](int p0, int mb) {
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int row = (tid + q * THREADS) / PARTS;
      grow[q] = row < TI ? (i0 + row < n ? i0 + row : -1) : nidx[q];
    }
    const int tb = e_beg, tn = min(e_end - e_beg, ECAP);
    float* t_sq = meta + mb * META;
    float* t_w = t_sq + TJ;
    int* t_c = reinterpret_cast<int*>(t_w + ECAP);
    int* t_ptr = t_c + ECAP;
    for (int e = tid; e <= TJ; e += THREADS)
      cp_async4(t_ptr + e, row_ptr + min(p0 + e, J));
    for (int e = tid; e < TJ; e += THREADS)
      cp_async4(t_sq + e, live_sq + min(p0 + e, J - 1));
    for (int e = tid; e < tn; e += THREADS) {
      cp_async4(t_c + e, ent_c + tb + e);
      cp_async4(t_w + e, ent_w + tb + e);
    }
#pragma unroll
    for (int c = 0; c < STAGES - 1; ++c) {
      if (c < nch) stage(c, c);
      cp_async_commit();
    }
    return tb;
  };

  fetch(0);
  int tb = J > 0 ? prologue(0, 0) : 0;
  fetch(TJ);
  for (int p0 = 0, mb = 0; p0 < J; p0 += TJ, mb ^= 1) {
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[r][m] = 0.f;

    for (int c = 0; c < nch; ++c) {
      cp_async_wait<STAGES - 2>();   // chunk c has landed
      __syncthreads();               // ... for every thread; c - 1 is free
      if (c + STAGES - 1 < nch)
        stage(c + STAGES - 1, (c + STAGES - 1) % STAGES);
      cp_async_commit();
      const float* a_s = xs + (c % STAGES) * STAGE + 8 * ty * DCP;
      const float* b_s = xs + (c % STAGES) * STAGE + (TI + tx) * DCP;
#pragma unroll
      for (int q4 = 0; q4 < DC / 4; ++q4) {
        float4 a[8], bv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          a[r] = *reinterpret_cast<const float4*>(a_s + r * DCP + 4 * q4);
#pragma unroll
        for (int m = 0; m < 4; ++m)
          bv[m] =
              *reinterpret_cast<const float4*>(b_s + 64 * m * DCP + 4 * q4);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            float s = acc[r][m];
            s = fmaf(a[r].x, bv[m].x, s);
            s = fmaf(a[r].y, bv[m].y, s);
            s = fmaf(a[r].z, bv[m].z, s);
            acc[r][m] = fmaf(a[r].w, bv[m].w, s);
          }
      }
    }

    // distances of the tile, into the last ring buffer
    const float* t_sq = meta + mb * META;
    const float* t_w = t_sq + TJ;
    const int* t_c = reinterpret_cast<const int*>(t_w + ECAP);
    const int* t_ptr = t_c + ECAP;
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float sq_j = t_sq[tx + 64 * m];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        ds[(8 * ty + r) * (TJ + 1) + tx + 64 * m] =
            sqrtf(fmaxf(sq_i[r] - 2.f * acc[r][m] + sq_j, 0.f));
    }
    // the next tile's loads fly during this tile's contraction
    const int tb_now = tb;
    if (p0 + TJ < J) {
      tb = prologue(p0 + TJ, mb ^ 1);
      fetch(p0 + 2 * TJ);
    }
    __syncthreads();

    // contraction with the tile's CSR entries: lane l takes every 8th row,
    // four rows at a time (their one-hot entries loaded together)
    {
      const int i = tid & (TI - 1), l = tid / TI;
      float* my = slab + (l * TI + i) * KP;
      const int pend = min(TJ, J - p0);
      for (int p4 = l; p4 < pend; p4 += 4 * LANES) {
        float dv[4], w0[4];
        int eb[4], ee[4], c0[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pp = p4 + u * LANES;
          const bool in = pp < pend;
          dv[u] = in ? ds[i * (TJ + 1) + pp] : 0.f;
          eb[u] = in ? t_ptr[pp] - tb_now : 0;
          ee[u] = in ? t_ptr[pp + 1] - tb_now : 0;
          const int e = min(eb[u], ECAP - 1);
          c0[u] = t_c[e];
          w0[u] = t_w[e];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (ee[u] <= eb[u]) continue;
          if (eb[u] < ECAP) {
            my[c0[u]] += dv[u] * w0[u];
          } else {
            my[ent_c[tb_now + eb[u]]] += dv[u] * ent_w[tb_now + eb[u]];
          }
          for (int e = eb[u] + 1; e < ee[u]; ++e) {
            const int c = e < ECAP ? t_c[e] : ent_c[tb_now + e];
            my[c] += dv[u] * (e < ECAP ? t_w[e] : ent_w[tb_now + e]);
          }
        }
      }
    }
    __syncthreads();
  }

  __syncthreads();   // the slabs' zeros when no row is live
  for (int e = tid; e < TI * k; e += THREADS) {
    const int i = e / k, c = e - i * k;
    if (i0 + i >= n) continue;
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < LANES; ++l) s += slab[(l * TI + i) * KP + c];
    out[static_cast<size_t>(i0 + i) * k + c] = s;
  }
}

}  // namespace

// x: (B, n, d) f32 with d % 4 == 0; onehot: (B, n, k) f32, k <= 64; out:
// (B, n, k) f32.  iscratch: B (3 n + 2 ceil(n / 32) + n k + 2) ints;
// fscratch: B (2 n + n k) floats.  1 <= B <= 65535.  Returns
// cudaGetLastError() after the three launches.
extern "C" int silhouette_sums(const float* x, const float* onehot,
                               int* iscratch, float* fscratch, float* out,
                               int n, int d, int k, int B, void* stream) {
  if (n < 0 || d < 4 || d % 4 || k < 1 || k > MAX_K || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (n + RT - 1) / RT;
  sil_rows_kernel<<<dim3(nb, B), AT, 0, s>>>(x, onehot, iscratch, fscratch,
                                             n, d, k);
  sil_compact_kernel<<<dim3(nb, B), RT, 0, s>>>(onehot, iscratch, fscratch,
                                                n, k);
  cudaError_t err = cudaFuncSetAttribute(
      silhouette_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  silhouette_sums_kernel<<<dim3((n + TI - 1) / TI, B), THREADS, SMEM, s>>>(
      x, iscratch, fscratch, out, n, d, k);
  return static_cast<int>(cudaGetLastError());
}
