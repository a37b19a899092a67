// Exact single-changepoint search (binary segmentation, L2 cost) for one
// read by one thread block: a device function shared by the fused
// step-2 kernel (sum_signal.cu, y in shared memory) and the stand-alone
// kernel (binseg.cu, y in device memory).
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
// S_n = S[max(n - 1, 0)].  Larger g wins, ties go to the smaller t, and a
// row with no valid candidate gives t = jump, has = false (W < jump gives
// t = 0, has = false).  The order (g descending, t ascending) is total,
// so any reduction order gives the same answer.
//
// The compare g1 > g2 is A1^2*D2 > A2^2*D1 in 192-bit integers, exact over
// the whole range the reference serves (|A| < 2^63, D < 2^62): no limb
// split by W, nothing refused.
//
// What bounds it: operations, and few of them.  Each thread walks a
// contiguous chunk of y twice (chunk sums for a block-wide int64 scan,
// then the candidates with their running prefix), so S is never stored;
// per candidate one 192-bit cross compare (about 12 64-bit multiplies),
// then 5 shuffle rounds and one round through shared memory.  At
// W = 3,312 and jump 5 that is 662 candidates a read.

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

}  // namespace topsicle
