// Exact single-changepoint search (binary segmentation, L2 cost): the
// device functions of both callers.
//
//   binseg_block      one read by one thread block, y in shared or device
//                     memory: fused behind the step-2 signal in
//                     sum_boundary (sum_signal.cu) and greedy_boundary
//                     (greedy_signal.cu)
//   tile_sum_block,   a read cut into tiles of consecutive windows, one
//   tile_best_block   block a tile: the stand-alone entry binseg_l2
//                     (binseg.cu), y in device memory
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
// split by W, nothing refused.
//
// binseg_block: each thread walks a contiguous chunk of y twice (chunk
// sums for a block-wide int64 scan, then the candidates with their running
// prefix), so S is never stored; per candidate one 192-bit cross compare
// (about 12 64-bit multiplies), then 5 shuffle rounds and one round
// through shared memory.  At W = 3,312 and jump 5 that is 662 candidates
// a read.  In shared memory (the fused entries) the chunked walk costs
// little; from device memory it is one uncoalesced load a lane, which is
// why binseg_l2 does not use it.
//
// The tile functions: a block copies its tile of y into shared memory with
// 16-byte loads, neighbouring threads on neighbouring addresses, and
// then each thread takes V consecutive values from there (V = tile / 256;
// a word of padding every 32 keeps V = 4, 8 or 16 free of bank
// conflicts).  Several tiles a row need the sums of the tiles before
// them: a first pass (tile_sum_block) writes each tile's int64 sum and the
// partial sum up to index n - 1; the second (tile_best_block) forms its
// offset and S_n from them, scans, picks its tile's best candidate and
// leaves it in scratch, and the last block of the row to arrive (a ticket
// taken after a __threadfence(); pass 1 zeroes the row's ticket, so no
// count outlives its launch) reduces the row's bests.  Nothing waits on
// another block.  A row of one tile skips the first pass and the
// ticket.  Candidate t belongs to the tile that holds index t - 1.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace topsicle {

// A candidate: |A|, D, t; t < 0 marks "none yet" (invalid always loses).
struct Cand {
  unsigned long long a;
  unsigned long long d;
  long long t;
};

// Shared memory the block function needs (declare one __shared__ instance).
struct BinsegScratch {
  long long warp_sum[32];
  unsigned long long a[32];
  unsigned long long d[32];
  long long t[32];
  long long s_n;
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

// The changepoint of one read, by all kThreads threads of the block
// (kThreads a multiple of 32, at most 1024).  `y` points at W int32
// values in shared or device memory; every thread passes the same
// arguments.  Thread 0 writes *t_out and *has_out.  Ends with every
// thread past its last read of `y` and of `scratch` only after a later
// __syncthreads(), so a caller that reuses either must synchronise first.
template <int kThreads>
__device__ void binseg_block(const int32_t* y, int W, long long n, int jump, int min_size,
                             BinsegScratch& scratch, long long* t_out, uint8_t* has_out) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;

  const int n_cand = W / jump;
  if (n_cand < 1) {
    if (tid == 0) {
      *t_out = 0;
      *has_out = 0;
    }
    return;
  }

  // ---- pass 1: chunk sums, and the partial sum up to index n - 1 ----
  const int chunk = (W + kThreads - 1) / kThreads;
  const int lo = min(tid * chunk, W);
  const int hi = min(lo + chunk, W);
  long long idx_n = n - 1;
  if (idx_n < 0) idx_n = 0;
  if (idx_n > W - 1) idx_n = W - 1;
  long long local = 0;
  long long upto_n = 0;
  for (int i = lo; i < hi; ++i) {
    local += y[i];
    if (i == idx_n) upto_n = local;
  }

  // ---- block-wide exclusive scan of the chunk sums (int64) ----
  long long incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) scratch.warp_sum[warp] = incl;
  __syncthreads();
  long long offset = incl - local;
  for (int w = 0; w < warp; ++w) offset += scratch.warp_sum[w];
  if (idx_n >= lo && idx_n < hi) scratch.s_n = offset + upto_n;
  __syncthreads();
  const long long s_n = scratch.s_n;

  // ---- pass 2: the candidates of this chunk, with their running prefix ----
  Cand best;
  best.a = 0;
  best.d = 1;
  best.t = -1;
  long long run = offset;
  int next_t = (lo / jump + 1) * jump;      // the smallest multiple of jump above lo
  for (int i = lo; i < hi; ++i) {
    run += y[i];
    if (i + 1 == next_t) {
      const long long t = next_t;
      next_t += jump;
      if (t >= min_size && t <= n - min_size) {
        const long long A = n * run - t * s_n;
        Cand c;
        c.a = static_cast<unsigned long long>(A < 0 ? -A : A);
        c.d = static_cast<unsigned long long>(t * (n - t));
        c.t = t;
        if (beats(c, best)) best = c;
      }
    }
  }

  // ---- reduce: shuffles inside each warp, then one round through shared ----
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Cand o;
    o.a = __shfl_down_sync(0xffffffffu, best.a, off);
    o.d = __shfl_down_sync(0xffffffffu, best.d, off);
    o.t = __shfl_down_sync(0xffffffffu, best.t, off);
    if (beats(o, best)) best = o;
  }
  if (lane == 0) {
    scratch.a[warp] = best.a;
    scratch.d[warp] = best.d;
    scratch.t[warp] = best.t;
  }
  __syncthreads();
  if (warp == 0) {
    Cand c;
    c.a = lane < kWarps ? scratch.a[lane] : 0;
    c.d = lane < kWarps ? scratch.d[lane] : 1;
    c.t = lane < kWarps ? scratch.t[lane] : -1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Cand o;
      o.a = __shfl_down_sync(0xffffffffu, c.a, off);
      o.d = __shfl_down_sync(0xffffffffu, c.d, off);
      o.t = __shfl_down_sync(0xffffffffu, c.t, off);
      if (beats(o, c)) c = o;
    }
    if (lane == 0) {
      *t_out = c.t < 0 ? static_cast<long long>(jump) : c.t;
      *has_out = c.t < 0 ? 0 : 1;
    }
  }
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

// Shared memory the tile functions need beside the tile (one instance).
struct TileScratch {
  long long sum[32];
  long long part[32];
  unsigned long long a[32];
  unsigned long long d[32];
  long long t[32];
  long long offset;
  long long s_n;
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

// The better candidate of a warp's lanes, in lane 0.
__device__ __forceinline__ Cand warp_best(Cand c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
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
  constexpr int kWarps = kThreads / 32;

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

  // ---- each thread's V consecutive values: their sum, a block-wide scan ----
  const int V = (tw + kThreads - 1) / kThreads;
  const int lo = min(tid * V, cnt);
  const int hi = min(lo + V, cnt);
  long long local = 0, upto = 0;
  for (int p = lo; p < hi; ++p) {
    local += tile_s[tile_slot(p)];
    if (t0 + p == idx_n) upto = local;
  }
  long long incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) sc.sum[warp] = incl;
  __syncthreads();
  long long run = incl - local + (n_tiles > 1 ? sc.offset : 0);
  for (int w = 0; w < warp; ++w) run += sc.sum[w];
  if (n_tiles == 1 && idx_n >= t0 + lo && idx_n < t0 + hi) sc.s_n = run + upto;
  __syncthreads();
  const long long s_n = sc.s_n;

  // ---- the candidates t whose t - 1 this thread holds ----
  Cand best = no_cand();
  long long next_t = (static_cast<long long>(t0 + lo) / jump + 1) * jump;
  for (int p = lo; p < hi; ++p) {
    run += tile_s[tile_slot(p)];
    if (t0 + p + 1 == next_t) {
      const long long t = next_t;
      next_t += jump;
      if (t >= min_size && t <= n - min_size) {
        const long long A = n * run - t * s_n;
        Cand c;
        c.a = static_cast<unsigned long long>(A < 0 ? -A : A);
        c.d = static_cast<unsigned long long>(t * (n - t));
        c.t = t;
        if (beats_fast(c, best)) best = c;
      }
    }
  }

  // ---- the tile's best: shuffles, one round through shared memory ----
  best = warp_best(best);
  if (lane == 0) {
    sc.a[warp] = best.a;
    sc.d[warp] = best.d;
    sc.t[warp] = best.t;
  }
  __syncthreads();
  if (warp != 0) return;
  Cand c = no_cand();
  if (lane < kWarps) {
    c.a = sc.a[lane];
    c.d = sc.d[lane];
    c.t = sc.t[lane];
  }
  c = warp_best(c);

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

}  // namespace topsicle
