// Exact single-changepoint search (binary segmentation, L2 cost): the
// device functions of both callers.
//
//   slice_scan,       a slice of a read's y already in shared memory, at
//   slice_best        tile_slot positions: the block's scan and its best
//                     candidate, the one block function every caller runs
//   slice_changepoint a read's y in the slices of the C blocks of a
//                     thread-block cluster (C = 1: one block): fused behind
//                     the step-2 signal in sum_boundary (sum_signal.cu) and
//                     greedy_boundary (greedy_signal.cu)
//   tile_sum_block,   a read in device memory cut into tiles of consecutive
//   tile_best_block   windows, one block a tile: the stand-alone entry
//                     binseg_l2 (binseg.cu)
//
// Replaces: topsicle_tpu/ops/changepoint.py::binseg_l2_device (the XLA
// program that follows the TPU kernels), and computes exactly what
// ops/changepoint.py::binseg_l2_device computes: over the candidates
// t = jump, 2*jump, ..., (W / jump)*jump that satisfy
// min_size <= t <= n - min_size, the argmax of
//
//   g(t) = A^2 / D,   A = n*S_t - t*S_n,   D = t*(n - t)
//
// with S the inclusive prefix sum of y, n the read's own window count and
// S_n = S[clamp(n - 1, 0, W - 1)].  Larger g wins, ties go to the smaller
// t, and a row with no valid candidate gives t = jump, has = false (W <
// jump gives t = 0, has = false).  The order (g descending, t ascending)
// is total, so any reduction order gives the same answer.
//
// The compare g1 > g2 is A1^2*D2 > A2^2*D1 in 192-bit integers, exact over
// the whole range the reference serves (|A| < 2^63, D < 2^62): no limb
// split by W, nothing refused.  beats_fast decides the clear cases in
// double precision first and leaves the rest to that compare.
//
// A slice: cnt values of y at shared-memory words tile_slot(p) (a word of
// padding every 32), so that a warp whose lanes read V = ceil(cnt /
// threads) consecutive values each hits distinct banks.  slice_scan: each
// thread sums its V values, one shuffle scan a warp and one shuffle scan
// over the warp sums give each thread the sum before its first value (no
// thread loops over earlier warps), and the thread that holds index n - 1
// leaves the partial sum up to it.  slice_best: each thread walks its
// candidates by stride (t from the first multiple of jump it holds, jump
// at a time, the valid range clamped before the loop, so no test runs per
// value), adding the values up to each t - 1, then shuffles and one round
// through shared memory, beats_fast at every step.  Candidate t belongs to
// the slice (and thread) that holds index t - 1, so slice edges at any
// residue give the same answer.
//
// Several slices a read need the sums of the slices before them:
//   - binseg_l2's tiles: a first launch (tile_sum_block) writes each tile's
//     sum and the partial sum up to index n - 1; the second
//     (tile_best_block) stages its tile from device memory with 16-byte
//     loads, forms its offset and S_n from pass 1, scans, picks its tile's
//     best and leaves it in scratch, and the last block of the row to
//     arrive (a ticket taken after a __threadfence(); pass 1 zeroes the
//     row's ticket, so no count outlives its launch) reduces the row's
//     bests.  A row of one tile skips the first pass and the ticket.
//   - the fused entries' cluster: each block keeps its window block's
//     slice of y in its own shared memory; after the scans a cluster.sync(),
//     then each block reads the lower ranks' sums and S_n's partial through
//     distributed shared memory (map_shared_rank), picks its best and
//     leaves it in its shared memory; after a second cluster.sync() rank 0
//     reduces the C bests in rank order and writes (t, has), and a last
//     cluster.sync() keeps every block resident until rank 0 has read it.

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace topsicle {

// A candidate: |A|, D, t; t < 0 marks "none yet" (invalid always loses).
struct Cand {
  unsigned long long a;
  unsigned long long d;
  long long t;
};

// (x*x)*m as three 64-bit words, least significant first.  x < 2^63 and
// m < 2^62, so the product is below 2^188 and the last carry cannot wrap.
__device__ __forceinline__ void sq_times(unsigned long long x, unsigned long long m,
                                         unsigned long long& w0, unsigned long long& w1,
                                         unsigned long long& w2) {
  const unsigned long long lo = x * x;
  const unsigned long long hi = __umul64hi(x, x);
  w0 = lo * m;
  const unsigned long long c0 = __umul64hi(lo, m);
  w1 = c0 + hi * m;
  w2 = __umul64hi(hi, m) + (w1 < c0 ? 1ull : 0ull);
}

// True iff candidate p beats candidate q: p exists, and q does not, or
// p's g is larger, or they tie and p's t is smaller.
__device__ __forceinline__ bool beats(const Cand& p, const Cand& q) {
  if (p.t < 0) return false;
  if (q.t < 0) return true;
  unsigned long long p0, p1, p2, q0, q1, q2;
  sq_times(p.a, q.d, p0, p1, p2);
  sq_times(q.a, p.d, q0, q1, q2);
  if (p2 != q2) return p2 > q2;
  if (p1 != q1) return p1 > q1;
  if (p0 != q0) return p0 > q0;
  return p.t < q.t;
}

// ---- binseg_l2's tiles ---------------------------------------------------------

// The largest tile a launch takes (ops/geometry.py::BINSEG_MAX_TILE): its
// shared memory, 33 KB, stays under the 48 KB a launch may ask for as is.
constexpr int kMaxTileWindows = 8192;

// Shared-memory word of tile position p: a word of padding every 32, so
// that a warp whose lanes read V = 4, 8 or 16 consecutive values each hits
// 32 distinct banks.
__host__ __device__ __forceinline__ int tile_slot(int p) { return p + (p >> 5); }

// Shared-memory bytes a tile of tw windows needs.
__host__ __device__ __forceinline__ int tile_smem_bytes(int tw) {
  return 4 * (tile_slot(tw) + 1);
}

// Shared memory the slice and tile functions need beside the slice (one
// instance).  total, upto and best are read by the other blocks of a
// cluster; nothing else writes them.
struct TileScratch {
  long long sum[32];
  long long part[32];
  unsigned long long a[32];
  unsigned long long d[32];
  long long t[32];
  long long offset;
  long long s_n;
  long long total;       // the slice's sum
  long long upto;        // its sum through index n - 1, where it holds that index
  Cand best;             // the slice's best candidate
};

// clamp(n - 1, 0, W - 1): the index whose prefix is S_n.
__device__ __forceinline__ long long s_n_index(long long n, int W) {
  return max(0ll, min(n - 1, static_cast<long long>(W) - 1));
}

// The tile of [src, src + cnt): the first 16-byte boundary at or after
// src, the whole int4 vectors from there, and the (at most three) words
// before and after them.
struct TileSpan {
  int head;      // words before the first vector
  int n_vec;     // whole vectors
  int rest;      // first word after them
};

__device__ __forceinline__ TileSpan tile_span(const int32_t* src, int cnt) {
  TileSpan s;
  s.head = min(static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(src) & 15u)) & 15u) >> 2),
               cnt);
  s.n_vec = (cnt - s.head) >> 2;
  s.rest = s.head + 4 * s.n_vec;
  return s;
}

// A thread's share of a tile, every load issued before any is used:
// vectors tid, tid + kThreads, .. of the tile's whole int4 vectors (tile
// position span.head + 4 * vector), and at most one word of the head or
// the tail.
template <int kThreads>
struct TileLoad {
  static constexpr int kVecs = kMaxTileWindows / 4 / kThreads;
  int4 q[kVecs];
  int word_pos;      // the word's tile position, -1 for none
  int word;
};

template <int kThreads>
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ src, const TileSpan& span,
                                          int cnt, TileLoad<kThreads>& ld) {
  const int tid = threadIdx.x;
  const int4* vec = reinterpret_cast<const int4*>(src + span.head);
#pragma unroll
  for (int k = 0; k < TileLoad<kThreads>::kVecs; ++k) {
    const int i = tid + k * kThreads;
    if (i < span.n_vec) ld.q[k] = __ldg(vec + i);
  }
  ld.word_pos = -1;
  if (tid < span.head) ld.word_pos = tid;
  else if (tid < span.head + cnt - span.rest) ld.word_pos = span.rest + tid - span.head;
  if (ld.word_pos >= 0) ld.word = __ldg(src + ld.word_pos);
}

__device__ __forceinline__ long long warp_sum64(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// beats(p, q), decided in double precision where the two cross products
// differ by more than a factor 1 + 2^-40 (each carries a relative error
// under 6 * 2^-53, and nothing overflows below 2^188), else by the exact
// 192-bit compare.
__device__ __forceinline__ bool beats_fast(const Cand& p, const Cand& q) {
  if (p.t < 0) return false;
  if (q.t < 0) return true;
  const double ap = static_cast<double>(p.a), aq = static_cast<double>(q.a);
  const double lp = ap * ap * static_cast<double>(q.d);
  const double lq = aq * aq * static_cast<double>(p.d);
  if (lp > lq * (1.0 + 0x1p-40)) return true;
  if (lq > lp * (1.0 + 0x1p-40)) return false;
  return beats(p, q);
}

// The best candidate of a warp's first kLanes lanes (a power of two), in
// lane 0.
template <int kLanes = 32>
__device__ __forceinline__ Cand warp_best(Cand c) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    Cand o;
    o.a = __shfl_down_sync(0xffffffffu, c.a, off);
    o.d = __shfl_down_sync(0xffffffffu, c.d, off);
    o.t = __shfl_down_sync(0xffffffffu, c.t, off);
    if (beats_fast(o, c)) c = o;
  }
  return c;
}

__device__ __forceinline__ Cand no_cand() {
  Cand c;
  c.a = 0;
  c.d = 1;
  c.t = -1;
  return c;
}

// A thread's share of a slice: values lo .. hi - 1, and the sum of the
// slice's values before lo.
struct SliceThread {
  int lo, hi;
  long long excl;
};

// The scan of a slice of cnt values of y at tile_slot positions of `ys`, by
// the first kThreads threads of the block (kThreads a multiple of 32, at
// most 1024; every thread of the block calls it, the others only meet its
// barriers), V = ceil(cnt / kThreads) consecutive values a thread.  Leaves
// sc.total = the slice's sum and, where the slice holds position `lim`
// (0 <= lim < cnt), sc.upto = its sum through `lim`; ends synchronised.
template <int kThreads>
__device__ SliceThread slice_scan(const int32_t* ys, int cnt, long long lim, TileScratch& sc) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const bool in = tid < kThreads;           // the same for a whole warp
  const int V = (cnt + kThreads - 1) / kThreads;
  SliceThread s;
  s.excl = 0;
  s.lo = in ? min(tid * V, cnt) : cnt;
  s.hi = min(s.lo + V, cnt);
  long long local = 0, incl = 0;
  if (in) {
    for (int p = s.lo; p < s.hi; ++p) local += ys[tile_slot(p)];
    incl = local;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    if (lane == 31) sc.sum[warp] = incl;
  }
  __syncthreads();
  if (in) {
    // one pass over the warp sums: every warp scans them in its lanes and
    // takes the sum before its own
    long long ws = lane < kWarps ? sc.sum[lane] : 0;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const long long up = __shfl_up_sync(0xffffffffu, ws, off);
      if (lane >= off) ws += up;
    }
    const long long prev = __shfl_sync(0xffffffffu, ws, (warp + 31) & 31);
    const long long total = __shfl_sync(0xffffffffu, ws, kWarps - 1);
    s.excl = (warp == 0 ? 0 : prev) + incl - local;
    if (tid == 0) sc.total = total;
    if (lim >= s.lo && lim < s.hi) {
      long long u = s.excl;
      for (int p = s.lo; p <= lim; ++p) u += ys[tile_slot(p)];
      sc.upto = u;
    }
  }
  __syncthreads();
  return s;
}

// The best candidate of a slice scanned by slice_scan<kThreads>: window t0
// is the slice's position 0, `run` the sum of the read's values before the
// thread's first (the slice's offset plus s.excl), n the read's window
// count and s_n its S_n.  A thread takes the candidates t whose t - 1 it
// holds (t0 + lo < t <= t0 + hi), clamped to min_size <= t <= n - min_size
// before the loop.  Every thread of the block calls it; returns the
// block's best in thread 0 (the other threads' are not); sc.a, sc.d and
// sc.t are read by warp 0 after the return, so a caller that reuses them
// synchronises first.
template <int kThreads>
__device__ Cand slice_best(const int32_t* ys, const SliceThread& s, long long t0, long long run,
                           long long s_n, long long n, int jump, int min_size,
                           TileScratch& sc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  if (threadIdx.x < kThreads) {
    long long t = max(t0 + s.lo + 1, static_cast<long long>(min_size));
    t = (t + jump - 1) / jump * jump;
    const long long t_last = min(t0 + s.hi, n - min_size);
    Cand best = no_cand();
    int p = s.lo;
    for (; t <= t_last; t += jump) {
      for (const int e = static_cast<int>(t - t0); p < e; ++p) run += ys[tile_slot(p)];
      const long long A = n * run - t * s_n;
      Cand c;
      c.a = static_cast<unsigned long long>(A < 0 ? -A : A);
      c.d = static_cast<unsigned long long>(t * (n - t));
      c.t = t;
      if (beats_fast(c, best)) best = c;
    }
    best = warp_best(best);
    if (lane == 0) {
      sc.a[warp] = best.a;
      sc.d[warp] = best.d;
      sc.t[warp] = best.t;
    }
  }
  __syncthreads();
  Cand c = no_cand();
  if (warp == 0) {
    if (lane < kWarps) {
      c.a = sc.a[lane];
      c.d = sc.d[lane];
      c.t = sc.t[lane];
    }
    c = warp_best<kWarps>(c);
  }
  return c;
}

// Pass 1, for a row of several tiles, by all kThreads threads of the
// block of tile `tile` (tw <= kMaxTileWindows windows a tile) of a row
// y_row of W windows with n valid: *tile_sum = the tile's sum, and, where
// the tile holds s_n_index(n, W), *upto_n = its sum up to and including
// that index.  The loads go straight to registers: nothing is kept.
template <int kThreads>
__device__ void tile_sum_block(const int32_t* __restrict__ y_row, int W, long long n, int tile,
                               int tw, TileScratch& sc, long long* tile_sum,
                               long long* upto_n) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const int t0 = tile * tw;
  const int cnt = min(tw, W - t0);
  const int32_t* src = y_row + t0;
  const TileSpan span = tile_span(src, cnt);
  TileLoad<kThreads> ld;
  load_tile<kThreads>(src, span, cnt, ld);
  const long long lim = s_n_index(n, W) - t0;      // tile position of S_n's index
  long long all = 0, part = 0;
#pragma unroll
  for (int k = 0; k < TileLoad<kThreads>::kVecs; ++k) {
    const int i = tid + k * kThreads;
    if (i < span.n_vec) {
      const long long p = span.head + 4 * i;
      const long long x = ld.q[k].x, y = ld.q[k].y, z = ld.q[k].z, w = ld.q[k].w;
      all += x + y + z + w;
      part += (p <= lim ? x : 0) + (p + 1 <= lim ? y : 0) + (p + 2 <= lim ? z : 0) +
              (p + 3 <= lim ? w : 0);
    }
  }
  if (ld.word_pos >= 0) {
    all += ld.word;
    part += ld.word_pos <= lim ? ld.word : 0;
  }
  all = warp_sum64(all);
  part = warp_sum64(part);
  if (lane == 0) {
    sc.sum[warp] = all;
    sc.part[warp] = part;
  }
  __syncthreads();
  if (tid == 0) {
    all = 0;
    part = 0;
    for (int w = 0; w < kWarps; ++w) {
      all += sc.sum[w];
      part += sc.part[w];
    }
    *tile_sum = all;
    if (lim >= 0 && lim < cnt) *upto_n = part;
  }
}

// Pass 2, by all kThreads threads of the block of tile `tile` of
// n_tiles (tw <= kMaxTileWindows windows a tile) of a row y_row of W
// windows with n valid; `tile_s` (the tw windows, tile_slot-padded) is the
// block's dynamic shared memory.  One tile a row (n_tiles == 1): writes
// *t_out and *has_out.  Several: tile_sums and *upto_n are the row's
// pass-1 results; the block leaves its best candidate in cands[3 * tile
// ..] (|A|, D, t), takes a ticket from *ticket (pass 1 set it to 0), and
// the block that takes the last one reduces the row's n_tiles bests and
// writes the outputs.
template <int kThreads>
__device__ void tile_best_block(const int32_t* __restrict__ y_row, int W, long long n,
                                int jump, int min_size, int tile, int n_tiles, int tw,
                                const long long* tile_sums, const long long* upto_n,
                                long long* cands, unsigned long long* ticket, int32_t* tile_s,
                                TileScratch& sc, long long* t_out, uint8_t* has_out) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (W / jump < 1) {                       // no candidate in the row at all
    if (tid == 0) {
      *t_out = 0;
      *has_out = 0;
    }
    return;
  }
  const int t0 = tile * tw;
  const int cnt = min(tw, W - t0);

  // ---- the tile into shared memory, coalesced, every load in flight at once ----
  const int32_t* src = y_row + t0;
  const TileSpan span = tile_span(src, cnt);
  TileLoad<kThreads> ld;
  load_tile<kThreads>(src, span, cnt, ld);
  const long long idx_n = s_n_index(n, W);
  // several tiles: the tile's offset and S_n from pass 1, by warp 0
  if (n_tiles > 1 && warp == 0) {
    const long long tile_n = idx_n / tw;
    long long off = 0, sn = 0;
#pragma unroll 4
    for (int j = lane; j < n_tiles; j += 32) {
      const long long v = tile_sums[j];
      off += j < tile ? v : 0;
      sn += j < tile_n ? v : 0;
    }
    off = warp_sum64(off);
    sn = warp_sum64(sn);
    if (lane == 0) {
      sc.offset = off;
      sc.s_n = sn + *upto_n;
    }
  }
#pragma unroll
  for (int k = 0; k < TileLoad<kThreads>::kVecs; ++k) {
    const int i = tid + k * kThreads;
    if (i < span.n_vec) {
      const int p = span.head + 4 * i;
      tile_s[tile_slot(p)] = ld.q[k].x;
      tile_s[tile_slot(p + 1)] = ld.q[k].y;
      tile_s[tile_slot(p + 2)] = ld.q[k].z;
      tile_s[tile_slot(p + 3)] = ld.q[k].w;
    }
  }
  if (ld.word_pos >= 0) tile_s[tile_slot(ld.word_pos)] = ld.word;
  __syncthreads();

  // ---- the tile's scan and best: one tile a row finds S_n in its own scan ----
  const SliceThread st = slice_scan<kThreads>(tile_s, cnt, idx_n - t0, sc);
  Cand c = slice_best<kThreads>(tile_s, st, t0, (n_tiles > 1 ? sc.offset : 0) + st.excl,
                                n_tiles > 1 ? sc.s_n : sc.upto, n, jump, min_size, sc);
  if (warp != 0) return;

  // ---- several tiles: the last block of the row reduces the tiles' bests ----
  if (n_tiles > 1) {
    unsigned long long taken = 0;
    if (lane == 0) {
      cands[3 * tile] = static_cast<long long>(c.a);
      cands[3 * tile + 1] = static_cast<long long>(c.d);
      cands[3 * tile + 2] = c.t;
      __threadfence();                      // the best is visible before the ticket
      taken = atomicAdd(ticket, 1ull);
    }
    taken = __shfl_sync(0xffffffffu, taken, 0);
    if (taken != static_cast<unsigned long long>(n_tiles - 1)) return;
    __threadfence();                        // every other tile's best is visible
    c = no_cand();
#pragma unroll 4
    for (int j = lane; j < n_tiles; j += 32) {
      Cand o;
      o.a = static_cast<unsigned long long>(__ldcg(cands + 3 * j));
      o.d = static_cast<unsigned long long>(__ldcg(cands + 3 * j + 1));
      o.t = __ldcg(cands + 3 * j + 2);
      if (beats_fast(o, c)) c = o;
    }
    c = warp_best(c);
  }
  if (lane == 0) {
    *t_out = c.t < 0 ? static_cast<long long>(jump) : c.t;
    *has_out = c.t < 0 ? 0 : 1;
  }
}

// ---- the fused entries: a read's y in the slices of a cluster's blocks ----

// The largest cluster a fused launch takes: the portable cluster size
// (ops/geometry.py::MAX_CLUSTER).
constexpr int kMaxCluster = 8;

// Shared-memory bytes of a slice of w windows at tile_slot positions.
__host__ __device__ __forceinline__ long long slice_smem_bytes(long long w) {
  return (4 * (w + (w >> 5)) + 15) & ~15ll;
}

// The launch of a kernel on dim3(B, C) blocks of `threads` with `smem`
// bytes of dynamic shared memory: with C > 1 (a fused entry's read on C
// blocks) in clusters of (1, C, 1), a read's blocks one cluster.  `attr`
// is the storage the configuration points at.
inline cudaLaunchConfig_t launch_config(unsigned B, unsigned C, int threads, int smem,
                                        bool cluster, cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (cluster && C > 1) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = 1;
    attr->val.clusterDim.y = C;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

// The changepoint of read b, by the first kThreads threads of each of the
// C = gridDim.y blocks of its cluster (a launch with cluster dimension (1,
// C, 1); C = 1: one block, no cluster); every thread of every block calls
// it.  Block r = blockIdx.y holds windows
// r * WB .. r * WB + cnt - 1 of the read's W in `ys` (tile_slot positions,
// written before a __syncthreads()); n is the read's window count.  Rank 0
// writes *t_out and *has_out.  Every thread of every block of the cluster
// calls it with the same W, WB, n, jump and min_size.
template <int kThreads>
__device__ void slice_changepoint(const int32_t* ys, int cnt, int W, int WB, long long n,
                                  int jump, int min_size, TileScratch& sc, long long* t_out,
                                  uint8_t* has_out) {
  const int C = gridDim.y;
  const int rank = blockIdx.y;
  if (W / jump < 1) {                       // no candidate in the read at all
    if (rank == 0 && threadIdx.x == 0) {
      *t_out = 0;
      *has_out = 0;
    }
    return;
  }
  const long long t0 = static_cast<long long>(rank) * WB;
  const long long idx_n = s_n_index(n, W);
  const SliceThread st = slice_scan<kThreads>(ys, cnt, idx_n - t0, sc);
  Cand c;
  if (C == 1) {
    c = slice_best<kThreads>(ys, st, 0, st.excl, sc.upto, n, jump, min_size, sc);
  } else {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                         // every block's total (and S_n's partial)
    // the slice's offset and S_n, by every warp from the C blocks' sums
    const int lane = threadIdx.x & 31;
    const int rank_n = static_cast<int>(idx_n / WB);
    long long off = 0, sn = 0;
    if (lane < C) {
      const TileScratch* o = cluster.map_shared_rank(&sc, lane);
      const long long v = o->total;
      off = lane < rank ? v : 0;
      sn = lane < rank_n ? v : (lane == rank_n ? o->upto : 0);
    }
    off = warp_sum64(off);
    sn = warp_sum64(sn);
    c = slice_best<kThreads>(ys, st, t0, off + st.excl, sn, n, jump, min_size, sc);
    if (threadIdx.x == 0) sc.best = c;
    cluster.sync();                         // every block's best
    if (rank == 0 && threadIdx.x == 0) {
      c = no_cand();
      for (int r = 0; r < C; ++r) {
        const Cand o = *cluster.map_shared_rank(&sc.best, r);
        if (beats_fast(o, c)) c = o;
      }
    }
    cluster.sync();                         // no block leaves while rank 0 reads it
  }
  if (rank == 0 && threadIdx.x == 0) {
    *t_out = c.t < 0 ? static_cast<long long>(jump) : c.t;
    *has_out = c.t < 0 ? 0 : 1;
  }
}

}  // namespace topsicle
