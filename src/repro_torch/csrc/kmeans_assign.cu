// K2 — masked K-Means assignment + Lloyd statistics for NVIDIA Hopper
// (sm_90a), over a batch of programs and candidates in one call.
//
// Replaces the Pallas TPU kernel `kmeans_assign_fused_fwd`
// (src/repro/kernels/kmeans_assign/kernel.py, body `_kmeans_fused_kernel`)
// as JAX's sweep runs it: every candidate K of every program of a
// dispatch in one executable (`jax.vmap` over the programs of a chunk,
// `jax.lax.map` over the candidates, src/repro/core/clustering.py).  For
// programs b < B with points x[b] (n, d) and pmask[b] (n,), and, per
// candidate c < C, centroids cent[b,c] (k, d) and the candidate's mask
// cmask[c] (k,), shared by every program, all float32, it computes
//
//   dist[p, s]     = max(|x_bp|^2 - 2 x_bp . cent[b,c,s] + |cent[b,c,s]|^2,
//                        0), +inf where cmask[c, s] == 0
//   labels[b,c,p]  = argmin_s dist[p, s]   (ties to the lowest index)
//   mind[b,c,p]    = min_s dist[p, s] * pmask[b,p]
//   sums[b,c,s]    = sum_{p : labels[b,c,p] = s} pmask[b,p] * x[b,p,:]
//   cnts[b,c,s]    = sum_{p : labels[b,c,p] = s} pmask[b,p]
//
// k <= 64, d <= 512, 1 <= C <= 1024, 1 <= B <= 1024, B n < 2^31.  A
// program's numbers never depend on B or on the programs beside it:
// every sum below is taken within one program in a fixed order, so B = 1
// gives the bits of the one-program call, and a program padded into a
// larger points bucket (its extra points with pmask 0) gives the bits of
// its own bucket.
//
// What bounds it on this card.  One program's sweep step (n = 4096,
// d = 256, the candidates K = 2..48: C = 47, sum of live slots 1175) needs
// 2 n d 1175 = 2.46e9 float32 operations, ~37 us at 67 TFLOP/s, against
// ~10 MB of inputs and outputs (~3 us at 3.35 TB/s): operations; B
// programs are B times both.  A single candidate (k = 48, 40 live) is
// 8.4e7 operations, ~1.3 us: there latency binds.
//
// Design, four launches per call, no host sync, no float atomics:
// 1. k2_prep_kernel computes every program's |x_p|^2 and the |cent[b,c,s]|^2
//    of live slots once per launch: a block stages 32 whole rows into
//    shared memory by cp.async, all in flight at once, and 32 threads
//    chain one row each, one fmaf chain in feature order.  When the
//    caller's cmask is new to its workspace (once per sweep: the masks do
//    not change over the Lloyd steps) block 0 also plans the columns,
//    once for all programs: each candidate's live slots, compacted in slot
//    order (warp ballots over cmask), are its columns — one dead column
//    when it has none, so its points still get label 0 and mind
//    +inf * pmask — and the candidates are packed into tiles of 64
//    columns by first fit in decreasing order of size; no candidate
//    straddles two tiles.  The sweep's 47 candidates fill 19 tiles (97 % of
//    their columns live); dead slots cost nothing.
// 2. k2_assign_kernel: a persistent grid (3 blocks an SM) walks the
//    (program, 64-point tile, column tile) triples.  The shared core
//    (kmeans_core.cuh) streams both tiles' rows over d in 32-column chunks
//    through a 4-stage cp.async ring and keeps a 4 x 4 register tile of
//    dot products per thread; the 64 x 64 distance tile goes to shared
//    memory, and 4 threads per point scan the candidates' column ranges
//    in slot order with a strict '<'.  L2 traffic at one program's sweep
//    step: x once per column tile (~76 MB) and the live centroids once per
//    point tile (~77 MB).  What holds it back: 16-byte shared loads feed a
//    4 x 4 tile, two loads per 16 FMAs, and the measured inner loop runs
//    at about half the float32 peak; 8 x 4 and 8 x 8 tiles over 128 points
//    measured no faster (fewer blocks an SM, more registers).
// 3. k2_stats_kernel: a block owns (a program, a segment of 256 points, 64
//    columns, up to 8 candidates); the program is a grid dimension beside
//    the column chunk, never folded into C.  The segment's x columns and
//    pmask land in shared memory by cp.async while each warp sorts its
//    candidate's points of the segment by slot (stable: warp match / popc
//    ranks, two passes; points with pmask 0 add exactly 0 and are left
//    out); then every lane walks each slot's points in point order for its
//    two columns and accumulates pmask * x in registers.  With fewer than
//    8 candidates, spare warps take a share of each candidate's slots.  It
//    writes the partial rows of the slots its segment touched, their
//    counts and a touched flag per (program, candidate, slot, segment).
// 4. k2_reduce_kernel: a thread per element of sums / cnts adds its
//    program's touched segments' partials in segment order.
// Every sum has a fixed order (points in order within a segment, segments
// in order), so the result is the same bits on every run; 50 Lloyd steps
// would otherwise turn order noise into label flips.  A call with one
// program launches the one-program forms of prep, assign and reduce
// (template MULTI = false), in which the program offsets compile out.
//
// Scratch (the wrapper's workspace, made once per sweep): per program at
// n = 4096, d = 256, k = 48, C = 47 the partial sums take nseg x C x k x d
// x 4 B = 16 x 47 x 48 x 256 x 4 = 37.0 MB (only the touched rows are
// written or read; 296 MB at B = 8), the partial counts and flags 289 KB,
// the norms 25 KB; the plan, shared by the programs, 25 KB.

#include <algorithm>
#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

#include "kmeans_core.cuh"

namespace {

using kmcore::TC;

constexpr int MAX_K = 64;
constexpr int MAX_D = 512;
constexpr int MAX_C = 1024;      // the plan works in shared memory
constexpr int MAX_B = 1024;      // programs of a call
constexpr int SEG = 256;         // points of a statistics segment
constexpr int GRP = 8;           // candidates (warps) of a statistics block
constexpr int SW = 64;           // columns of a statistics block (2 a lane)
constexpr int PREP = 128;        // threads of a prep block
constexpr int NR = 32;           // rows of a norm block
constexpr int STATS_SMEM =
    4 * (SEG * SW + SEG + GRP * (SEG + 2 * (MAX_K + 1)));
constexpr int PREP_SMEM_MAX = 4 * (4 * MAX_C + MAX_K + 1 > NR * (MAX_D + 4)
                                       ? 4 * MAX_C + MAX_K + 1
                                       : NR * (MAX_D + 4));

// An assign configuration: the block tile, the ring depth, the blocks an
// SM should hold.
template <int TP, int PT, int CT, int NT, int STAGES_, int MINB_>
struct Assign {
  using T = kmcore::Tile<TP, PT, CT, NT>;
  static constexpr int STAGES = STAGES_, MINB = MINB_;
  static constexpr int SMEM =
      4 * (STAGES * T::STAGE + (TP + TC) + TP + 2 * TC);
  static_assert(TP * (TC + 1) <= STAGES * T::STAGE,
                "the distance tile aliases the ring");
  static_assert(NT >= TP, "a thread or more per point in the argmin");
};
// 64 points x 64 columns, 4 x 4 a thread, a 4-stage ring, 3 blocks an SM
// (8 x 4 and 8 x 8 register tiles over 128 points measured no faster at
// the sweep's shapes on an H100 and slower at small n)
using AssignS = Assign<64, 4, 4, 256, 4, 3>;

// plan layout (ints): T, tile_fill[C], tile_ncand[C], col_begin[C],
// ncol[C], tile_cand[C * TC], col_row[C * TC]
__host__ __device__ constexpr size_t plan_ints(int C) {
  return 1 + 4 * static_cast<size_t>(C) + 2 * static_cast<size_t>(C) * TC;
}

__device__ __forceinline__ void live_masks(const float* __restrict__ cm,
                                           int k, int lane, uint32_t& m0,
                                           uint32_t& m1) {
  m0 = __ballot_sync(0xffffffffu, lane < k && cm[lane] > 0.f);
  m1 = __ballot_sync(0xffffffffu, lane + 32 < k && cm[lane + 32] > 0.f);
}

// Block (0, 0) (when ``replan``): the column plan, shared by every
// program.  Every candidate's live slots, compacted in slot order, form
// its columns (one dead column when it has none); the candidates are
// packed into tiles of TC columns by first fit in decreasing order of
// their column counts (stable), so no candidate straddles two tiles.  The
// blocks (x > 0, program y): the squared norms of the program's points
// and live centroid rows, NR rows a block.  MULTI: B > 1; with one
// program the offsets compile out (the kernels' MULTI = false forms are
// the one-program design's code, which the batched forms time behind).
template <bool VEC4, bool MULTI>
__global__ void __launch_bounds__(PREP)
k2_prep_kernel(const float* __restrict__ x, const float* __restrict__ cent,
               const float* __restrict__ cmask, int* __restrict__ plan,
               float* __restrict__ x2, float* __restrict__ c2, int n, int d,
               int k, int C, int replan) {
  extern __shared__ __align__(16) int psm[];
  if (blockIdx.x > 0) {          // NR rows: points, then centroid rows
    if (MULTI) {
      const size_t bn = static_cast<size_t>(blockIdx.y) * n;
      const size_t bck = static_cast<size_t>(blockIdx.y) * C * k;
      x += bn * d;
      cent += bck * d;
      x2 += bn;
      c2 += bck;
    }
    float* rs = reinterpret_cast<float*>(psm);
    const int ld = VEC4 ? d + 4 : (d | 1);       // conflict-free strides
    const int r0 = (blockIdx.x - 1) * NR, nrows = n + C * k;
    auto src = [&](int g) {
      return g < n ? x + static_cast<size_t>(g) * d
                   : cent + static_cast<size_t>(g - n) * d;
    };
    auto live = [&](int g) { return g < n || cmask[g - n] > 0.f; };
    if (VEC4) {
      for (int e = threadIdx.x; e < NR * (d / 4); e += PREP) {
        const int row = e / (d / 4), q = e - row * (d / 4), g = r0 + row;
        const bool valid = g < nrows && live(g);
        kmcore::cp_async16(rs + row * ld + 4 * q, valid ? src(g) + 4 * q : x,
                           valid);
      }
    } else {
      for (int e = threadIdx.x; e < NR * d; e += PREP) {
        const int row = e / d, q = e - row * d, g = r0 + row;
        const bool valid = g < nrows && live(g);
        kmcore::cp_async4(rs + row * ld + q, valid ? src(g) + q : x, valid);
      }
    }
    kmcore::cp_async_commit();
    kmcore::cp_async_wait<0>();
    __syncthreads();
    const int g = r0 + threadIdx.x;
    if (threadIdx.x < NR && g < nrows) {
      const float* r = rs + threadIdx.x * ld;
      float acc = 0.f;                           // one chain, feature order
      if (VEC4) {
#pragma unroll 8
        for (int q = 0; q < d / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(r + 4 * q);
          acc = fmaf(v.x, v.x, acc);
          acc = fmaf(v.y, v.y, acc);
          acc = fmaf(v.z, v.z, acc);
          acc = fmaf(v.w, v.w, acc);
        }
      } else {
#pragma unroll 8
        for (int q = 0; q < d; ++q) acc = fmaf(r[q], r[q], acc);
      }
      if (g < n) x2[g] = acc;
      else c2[g - n] = live(g) ? acc : 0.f;
    }
    return;
  }
  if (!replan || (MULTI && blockIdx.y > 0)) return;
  int* cnt_s = psm;              // live slots per candidate
  int* order = cnt_s + C;        // candidates by decreasing count
  int* room = order + C;         // free columns per tile
  int* ncand = room + C;         // candidates per tile
  int* hist = ncand + C;         // 65 counts
  int* tile_fill = plan + 1;
  int* tile_ncand = tile_fill + C;
  int* col_begin = tile_ncand + C;
  int* ncol = col_begin + C;
  int* tile_cand = ncol + C;
  int* col_row = tile_cand + static_cast<size_t>(C) * TC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < C; c += PREP / 32) {
    uint32_t m0, m1;
    live_masks(cmask + static_cast<size_t>(c) * k, k, lane, m0, m1);
    if (lane == 0) cnt_s[c] = __popc(m0) + __popc(m1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s <= MAX_K; ++s) hist[s] = 0;
    for (int c = 0; c < C; ++c) ++hist[cnt_s[c]];
    for (int s = MAX_K, pos = 0; s >= 0; --s) {
      const int h = hist[s];
      hist[s] = pos;
      pos += h;
    }
    for (int c = 0; c < C; ++c) order[hist[cnt_s[c]]++] = c;
    int T = 0;
    for (int i = 0; i < C; ++i) {
      const int c = order[i], nc = max(cnt_s[c], 1);
      int t = 0;
      while (t < T && room[t] < nc) ++t;
      if (t == T) { room[T] = TC; ncand[T] = 0; ++T; }
      col_begin[c] = t * TC + TC - room[t];
      ncol[c] = nc;
      room[t] -= nc;
      tile_cand[t * TC + ncand[t]++] = c;
    }
    for (int t = 0; t < T; ++t) {
      tile_fill[t] = TC - room[t];
      tile_ncand[t] = ncand[t];
    }
    plan[0] = T;
  }
  __syncthreads();
  const uint32_t lt = (1u << lane) - 1u;
  for (int c = warp; c < C; c += PREP / 32) {
    uint32_t m0, m1;
    live_masks(cmask + static_cast<size_t>(c) * k, k, lane, m0, m1);
    const int base = col_begin[c];
    if ((m0 >> lane) & 1u) col_row[base + __popc(m0 & lt)] = c * k + lane;
    if ((m1 >> lane) & 1u)
      col_row[base + __popc(m0) + __popc(m1 & lt)] = c * k + 32 + lane;
    if (lane == 0 && (m0 | m1) == 0u) col_row[base] = -1;   // dead column
  }
}

template <class A, bool VEC4, bool MULTI>
__global__ void __launch_bounds__(A::T::NT, A::MINB)
k2_assign_kernel(const float* __restrict__ x, const float* __restrict__ cent,
                 const float* __restrict__ pmask, const int* __restrict__ plan,
                 const float* __restrict__ x2g, const float* __restrict__ c2g,
                 int* __restrict__ labels, float* __restrict__ mind, int n,
                 int d, int k, int C, int B) {
  using T = typename A::T;
  constexpr int TP = T::TP, NT = T::NT;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                 // the ring; then the distances
  float* ds = smem;                   // TP x (TC + 1)
  int* rows = reinterpret_cast<int*>(smem + A::STAGES * T::STAGE);
  float* x2s = reinterpret_cast<float*>(rows + TP + TC);
  float* c2s = x2s + TP;
  int* slot = reinterpret_cast<int*>(c2s + TC);
  const int nt = plan[0];
  const int* tile_fill = plan + 1;
  const int* tile_ncand = tile_fill + C;
  const int* col_begin = tile_ncand + C;
  const int* ncol = col_begin + C;
  const int* tile_cand = ncol + C;
  const int* col_row = tile_cand + static_cast<size_t>(C) * TC;
  const int ntp = (n + TP - 1) / TP, per_prog = ntp * nt;
  const int tx = T::tx(), ty = T::ty();

  // (program, point tile, column tile) work items: item w is program
  // w / per_prog's item w % per_prog, stepped without a division while a
  // block stays in one program.  The staged rows are rows of the batched
  // x (B n of them) and cent (B C k): B n < 2^31, checked by the host.
  int b = MULTI ? blockIdx.x / per_prog : 0;
  int wb = blockIdx.x - b * per_prog;
  while (MULTI ? b < B : wb < per_prog) {
    const int pt = wb % ntp, t = wb / ntp, p0 = pt * TP;
    const int bn = MULTI ? b * n : 0, bck = MULTI ? b * C * k : 0;
    const int fill = tile_fill[t];
    for (int e = threadIdx.x; e < TP + TC; e += NT) {
      if (e < TP) {
        const int p = p0 + e;
        rows[e] = p < n ? bn + p : -1;
        x2s[e] = p < n ? x2g[bn + p] : 0.f;
      } else {
        const int j = e - TP;
        const int r = j < fill ? col_row[t * TC + j] : -1;
        rows[e] = r >= 0 ? bck + r : -1;
        c2s[j] = r >= 0 ? c2g[bck + r] : 0.f;
        slot[j] = r >= 0 ? r % k : -1;
      }
    }
    __syncthreads();
    float acc[T::PT][T::CT], unused;
    kmcore::tile_dots<T, A::STAGES, VEC4, false>(x, cent, d, rows, ring, acc,
                                                 unused);
#pragma unroll
    for (int i = 0; i < T::PT; ++i)
#pragma unroll
      for (int m = 0; m < T::CT; ++m) {
        const int r = ty + T::TYN * i, j = tx + T::TXN * m;
        ds[r * (TC + 1) + j] = slot[j] >= 0
                                   ? kmcore::sq_dist(x2s[r], acc[i][m], c2s[j])
                                   : kmcore::inf();
      }
    __syncthreads();
    // each candidate's columns, in slot order: the first smallest wins
    const int r = threadIdx.x % TP, p = p0 + r;
    if (p < n) {
      const float pm = pmask[bn + p];
      const float* dr = ds + r * (TC + 1);
      for (int q = threadIdx.x / TP; q < tile_ncand[t]; q += NT / TP) {
        const int c = tile_cand[t * TC + q];
        const int j0 = col_begin[c] - t * TC, j1 = j0 + ncol[c];
        float best = dr[j0];
        int arg = j0;
        for (int j = j0 + 1; j < j1; ++j) {
          const float v = dr[j];
          if (v < best) { best = v; arg = j; }
        }
        const size_t o = (static_cast<size_t>(b) * C + c) * n + p;
        labels[o] = max(slot[arg], 0);
        mind[o] = best * pm;
      }
    }
    __syncthreads();                  // rows, slot, ds: the next tile's
    wb += gridDim.x;
    if (MULTI && wb >= per_prog) {
      b += wb / per_prog;
      wb %= per_prog;
    }
  }
}

// Block (segment, (program, 64 columns), GRP candidates): the segment's x
// columns and pmask land in shared memory by cp.async while each warp
// sorts its candidate's points of the segment by slot (stable, in two
// passes of warp match/popc ranks; points with pmask 0 add exactly 0 and
// are left out); then each lane walks every slot's points in order for
// its two columns, accumulating pmask * x in registers.  Program b's
// partials are its own slice: nseg C k rows of psums from b nseg C k.
template <bool VEC4>
__global__ void __launch_bounds__(256)
k2_stats_kernel(const float* __restrict__ x, const float* __restrict__ pmask,
                const int* __restrict__ labels, float* __restrict__ psums,
                float* __restrict__ pcnt, int* __restrict__ ptouch, int n,
                int d, int k, int C, int wpc) {
  const int nchunk = (d + SW - 1) / SW;
  const int b = blockIdx.y / nchunk, chunk = blockIdx.y - b * nchunk;
  const size_t bn = static_cast<size_t>(b) * n;
  const size_t bck = static_cast<size_t>(b) * C * k;
  x += bn * d;
  pmask += bn;
  labels += bn * C;
  psums += bck * gridDim.x * d;
  pcnt += bck * gridDim.x;
  ptouch += bck * gridDim.x;
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                              // SEG x SW
  float* pms = xs + SEG * SW;                  // SEG
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* lst =
      reinterpret_cast<int*>(pms + SEG) + warp * (SEG + 2 * (MAX_K + 1));
  int* off = lst + SEG;                        // k + 1 slot offsets
  int* cur = off + MAX_K + 1;                  // k counts, then cursors
  const int seg = blockIdx.x, nseg = gridDim.x;
  // wpc warps per candidate (fewer than GRP candidates: the spare warps
  // share the slots); warp ``phase`` walks the slots phase, phase + wpc..
  const int c = blockIdx.z * (GRP / wpc) + warp / wpc, phase = warp % wpc;
  const int p0 = seg * SEG, np = min(SEG, n - p0), j0 = chunk * SW;
  if (VEC4) {
    for (int e = threadIdx.x; e < SEG * (SW / 4); e += 256) {
      const int row = e / (SW / 4), q = e - row * (SW / 4), col = j0 + 4 * q;
      const bool valid = row < np && col < d;
      kmcore::cp_async16(xs + row * SW + 4 * q,
                         valid ? x + static_cast<size_t>(p0 + row) * d + col
                               : x, valid);
    }
  } else {
    for (int e = threadIdx.x; e < SEG * SW; e += 256) {
      const int row = e / SW, q = e - row * SW, col = j0 + q;
      const bool valid = row < np && col < d;
      kmcore::cp_async4(xs + row * SW + q,
                        valid ? x + static_cast<size_t>(p0 + row) * d + col
                              : x, valid);
    }
  }
  for (int e = threadIdx.x; e < SEG; e += 256)
    kmcore::cp_async4(pms + e, pmask + p0 + min(e, np - 1), e < np);
  kmcore::cp_async_commit();

  const uint32_t lt = (1u << lane) - 1u;
  int sl[SEG / 32];
  if (c < C) {                                 // the sort, while x lands
    const int* lab = labels + static_cast<size_t>(c) * n + p0;
#pragma unroll
    for (int r = 0; r < SEG / 32; ++r) {
      const int p = r * 32 + lane;
      sl[r] = p < np && pmask[p0 + p] != 0.f ? lab[p] : -1;
    }
    for (int s = lane; s < k; s += 32) cur[s] = 0;
    __syncwarp();
#pragma unroll
    for (int r = 0; r < SEG / 32; ++r) {
      const uint32_t m = __match_any_sync(0xffffffffu, sl[r]);
      if (sl[r] >= 0 && (m & lt) == 0) cur[sl[r]] += __popc(m);
      __syncwarp();
    }
    // exclusive prefix of the counts: off[s], off[k] = the live total
    const int a = lane < k ? cur[lane] : 0;
    const int b = lane + 32 < k ? cur[lane + 32] : 0;
    int sa = a, sb = b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int ua = __shfl_up_sync(0xffffffffu, sa, o);
      const int ub = __shfl_up_sync(0xffffffffu, sb, o);
      if (lane >= o) { sa += ua; sb += ub; }
    }
    const int ta = __shfl_sync(0xffffffffu, sa, 31);
    const int tb = __shfl_sync(0xffffffffu, sb, 31);
    __syncwarp();
    if (lane < k) off[lane] = cur[lane] = sa - a;
    if (lane + 32 < k) off[lane + 32] = cur[lane + 32] = ta + sb - b;
    if (lane == 0) off[k] = ta + tb;
    __syncwarp();
#pragma unroll
    for (int r = 0; r < SEG / 32; ++r) {
      const uint32_t m = __match_any_sync(0xffffffffu, sl[r]);
      if (sl[r] >= 0) lst[cur[sl[r]] + __popc(m & lt)] = r * 32 + lane;
      __syncwarp();
      if (sl[r] >= 0 && (m & lt) == 0) cur[sl[r]] += __popc(m);
      __syncwarp();
    }
  }
  kmcore::cp_async_wait<0>();
  __syncthreads();
  if (c >= C) return;

  const int jl = 2 * lane;
  const bool v0 = j0 + jl < d, v1 = j0 + jl + 1 < d;
  const size_t cs0 = static_cast<size_t>(c) * k;
  for (int s = phase; s < k; s += wpc) {
    const int b = off[s], e = off[s + 1];
    if (chunk == 0 && lane == 0) ptouch[(cs0 + s) * nseg + seg] = e > b;
    if (b == e) continue;
    float a0 = 0.f, a1 = 0.f, cnt = 0.f;
#pragma unroll 4
    for (int q = b; q < e; ++q) {
      const int p = lst[q];
      const float w = pms[p];
      const float2 v = *reinterpret_cast<const float2*>(xs + p * SW + jl);
      a0 = fmaf(w, v.x, a0);
      a1 = fmaf(w, v.y, a1);
      cnt += w;
    }
    float* row =
        psums + ((static_cast<size_t>(seg) * C) * k + cs0 + s) * d + j0;
    if (v0) row[jl] = a0;
    if (v1) row[jl + 1] = a1;
    if (chunk == 0 && lane == 0) pcnt[(cs0 + s) * nseg + seg] = cnt;
  }
}

// Block (x, program y): a thread per element of the program's sums (C, k,
// d), then of its cnts (C, k): the touched segments' partials added in
// segment order.  The batched form indexes in 32 bits (C k d < 2^31), the
// one-program form in 64, as each measured fastest.
template <bool MULTI>
__global__ void k2_reduce_kernel(const float* __restrict__ psums,
                                 const float* __restrict__ pcnt,
                                 const int* __restrict__ ptouch,
                                 float* __restrict__ sums,
                                 float* __restrict__ cnts, int nseg, int d,
                                 int k, int C) {
  if (MULTI) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int ck = C * k, ckd = ck * d;
    const size_t bck = static_cast<size_t>(blockIdx.y) * ck;
    psums += bck * nseg * d;
    pcnt += bck * nseg;
    ptouch += bck * nseg;
    if (i < ckd) {
      const int cs = i / d, j = i - cs * d;
      const int* tch = ptouch + static_cast<size_t>(cs) * nseg;
      float acc = 0.f;
      for (int g = 0; g < nseg; ++g)
        if (tch[g]) acc += psums[(static_cast<size_t>(g) * ck + cs) * d + j];
      sums[bck * d + i] = acc;
    } else if (i < ckd + ck) {
      const int cs = i - ckd;
      float acc = 0.f;
      for (int g = 0; g < nseg; ++g)
        if (ptouch[static_cast<size_t>(cs) * nseg + g])
          acc += pcnt[static_cast<size_t>(cs) * nseg + g];
      cnts[bck + cs] = acc;
    }
    return;
  }
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t ck = static_cast<size_t>(C) * k, ckd = ck * d;
  if (i < ckd) {
    const size_t cs = i / d, j = i % d;
    const int* tch = ptouch + cs * nseg;
    float acc = 0.f;
    for (int g = 0; g < nseg; ++g)
      if (tch[g]) acc += psums[(g * ck + cs) * d + j];
    sums[i] = acc;
  } else if (i < ckd + ck) {
    const size_t cs = i - ckd;
    float acc = 0.f;
    for (int g = 0; g < nseg; ++g)
      if (ptouch[cs * nseg + g]) acc += pcnt[cs * nseg + g];
    cnts[cs] = acc;
  }
}

int g_num_sms = 0;

template <class A>
void allow_smem() {
  cudaFuncSetAttribute(k2_assign_kernel<A, true, false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, A::SMEM);
  cudaFuncSetAttribute(k2_assign_kernel<A, false, false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, A::SMEM);
  cudaFuncSetAttribute(k2_assign_kernel<A, true, true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, A::SMEM);
  cudaFuncSetAttribute(k2_assign_kernel<A, false, true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, A::SMEM);
}

template <bool VEC4, bool MULTI>
void allow_prep_smem() {
  cudaFuncSetAttribute(k2_prep_kernel<VEC4, MULTI>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       PREP_SMEM_MAX);
}

int configure() {
  if (g_num_sms > 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  allow_smem<AssignS>();
  cudaFuncSetAttribute(k2_stats_kernel<true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       STATS_SMEM);
  cudaFuncSetAttribute(k2_stats_kernel<false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       STATS_SMEM);
  allow_prep_smem<true, false>();
  allow_prep_smem<false, false>();
  allow_prep_smem<true, true>();
  allow_prep_smem<false, true>();
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  g_num_sms = sms > 0 ? sms : 132;
  return 0;
}

template <class A, bool MULTI>
void launch_assign(bool vec4, cudaStream_t s, const float* x,
                   const float* cent, const float* pmask, const int* plan,
                   const float* x2, const float* c2, int* labels, float* mind,
                   int n, int d, int k, int C, int B) {
  const long long work =
      static_cast<long long>((n + A::T::TP - 1) / A::T::TP) * C * B;
  const long long slots = static_cast<long long>(A::MINB) * g_num_sms;
  const int grid = static_cast<int>(work < slots ? work : slots);
  if (vec4)
    k2_assign_kernel<A, true, MULTI><<<grid, A::T::NT, A::SMEM, s>>>(
        x, cent, pmask, plan, x2, c2, labels, mind, n, d, k, C, B);
  else
    k2_assign_kernel<A, false, MULTI><<<grid, A::T::NT, A::SMEM, s>>>(
        x, cent, pmask, plan, x2, c2, labels, mind, n, d, k, C, B);
}

// Steps 1, 2 and 4 of a call (the statistics launch is the same for any
// B); MULTI: B > 1.
template <bool MULTI>
void launch_programs(bool vec4, cudaStream_t s, const float* x,
                     const float* cent, const float* cmask,
                     const float* pmask, int* plan, float* x2, float* c2,
                     int* labels, float* mind, int n, int d, int k, int C,
                     int B, int replan) {
  const size_t ck = static_cast<size_t>(C) * k;
  // the program rides on grid y of the prep launch
  const dim3 prep_grid(1 + static_cast<int>((n + ck + NR - 1) / NR), B);
  const size_t prep_smem =
      4 * std::max((4 * static_cast<size_t>(C) + MAX_K + 1),
                   static_cast<size_t>(NR) * (vec4 ? d + 4 : (d | 1)));
  if (vec4)
    k2_prep_kernel<true, MULTI><<<prep_grid, PREP, prep_smem, s>>>(
        x, cent, cmask, plan, x2, c2, n, d, k, C, replan);
  else
    k2_prep_kernel<false, MULTI><<<prep_grid, PREP, prep_smem, s>>>(
        x, cent, cmask, plan, x2, c2, n, d, k, C, replan);
  if (n > 0)
    launch_assign<AssignS, MULTI>(vec4, s, x, cent, pmask, plan, x2, c2,
                                  labels, mind, n, d, k, C, B);
}

}  // namespace

// x: (B, n, d); cent: (B, C, k, d); cmask: (C, k), shared by the programs;
// pmask: (B, n); labels: (B, C, n) int32; mind: (B, C, n); sums: (B, C, k,
// d); cnts: (B, C, k); all float32 unless stated.  iscratch: plan_ints(C)
// + B nseg C k ints; fscratch: B n + B C k + B nseg C k + B nseg C k d
// floats, nseg = ceil(n / 256).  replan: 1 builds the column plan from
// cmask into iscratch; 0 reuses the plan iscratch holds, which must be
// this cmask's.  Returns cudaGetLastError() after the launches.
extern "C" int kmeans_assign_fused_batched(
    const float* x, const float* cent, const float* cmask, const float* pmask,
    int* labels, float* mind, float* sums, float* cnts, int* iscratch,
    float* fscratch, int n, int d, int k, int C, int B, int replan,
    void* stream) {
  if (n < 0 || d < 1 || d > MAX_D || k < 1 || k > MAX_K || C < 1 ||
      C > MAX_C || B < 1 || B > MAX_B ||
      static_cast<long long>(B) * n > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = configure();
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nseg = (n + SEG - 1) / SEG;
  const size_t ck = static_cast<size_t>(C) * k, bck = ck * B;
  int* plan = iscratch;
  int* ptouch = iscratch + plan_ints(C);
  float* x2 = fscratch;
  float* c2 = x2 + static_cast<size_t>(B) * n;
  float* pcnt = c2 + bck;
  float* psums = pcnt + nseg * bck;
  const bool vec4 = d % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(cent) % 16 == 0;

  if (B > 1)
    launch_programs<true>(vec4, s, x, cent, cmask, pmask, plan, x2, c2,
                          labels, mind, n, d, k, C, B, replan);
  else
    launch_programs<false>(vec4, s, x, cent, cmask, pmask, plan, x2, c2,
                           labels, mind, n, d, k, C, B, replan);
  if (n > 0) {
    int wpc = 1;                               // warps per candidate
    while (wpc < GRP && wpc * C < GRP) wpc *= 2;
    const int per_block = GRP / wpc;
    // the program rides beside the column chunk (grid y <= 1024 x 8)
    const dim3 sgrid(nseg, B * ((d + SW - 1) / SW),
                     (C + per_block - 1) / per_block);
    if (vec4)
      k2_stats_kernel<true><<<sgrid, 256, STATS_SMEM, s>>>(
          x, pmask, labels, psums, pcnt, ptouch, n, d, k, C, wpc);
    else
      k2_stats_kernel<false><<<sgrid, 256, STATS_SMEM, s>>>(
          x, pmask, labels, psums, pcnt, ptouch, n, d, k, C, wpc);
  }
  // the program rides on grid y of the reduce launch
  const dim3 rgrid(static_cast<unsigned>((ck * d + ck + 255) / 256), B);
  if (B > 1)
    k2_reduce_kernel<true><<<rgrid, 256, 0, s>>>(psums, pcnt, ptouch, sums,
                                                 cnts, nseg, d, k, C);
  else
    k2_reduce_kernel<false><<<rgrid, 256, 0, s>>>(psums, pcnt, ptouch, sums,
                                                  cnts, nseg, d, k, C);
  return static_cast<int>(cudaGetLastError());
}
