// The plain wire, as every kernel that reads it sees it (sum_signal.cu,
// greedy_signal.cu, step1_counts.cu): staging a row into shared memory, and
// the rolling code and validity of a position as bit fields of it.
//
// Base 4q+s sits at bits 2s of byte q (io.batch.pack_codes / pack_batch),
// beside either per-read lengths (lean) or an invalid bit-plane whose bit s
// of byte q marks position 8q+s (dense).  Read as a little-endian bit
// stream, the rolling code at position p is the 2k bits at bit 2p of the
// wire, and the validity of its k bases the k bits at bit p of the invalid
// plane: one funnel shift and a mask each, no per-base work.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace topsicle {

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// True iff a row pointer and its stride allow 16-byte loads of every row.
inline bool aligned16(const void* p, int stride) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && stride % 16 == 0;
}

// Bring `n` bytes of a row into shared memory by the first `n_threads`
// threads of the block, `tid` among them: 16 bytes a thread where the row
// allows it (the caller says), a byte a thread otherwise.
__device__ __forceinline__ void stage_row(uint8_t* dst, const uint8_t* src, int n, bool vec16,
                                          int tid, int n_threads) {
  if (vec16) {
    const int n16 = (n + 15) >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = tid; i < n16; i += n_threads) d4[i] = s4[i];
  } else {
    for (int i = tid; i < n; i += n_threads) dst[i] = src[i];
  }
}

// The same, and zeros behind the row up to `padded` bytes, so that a
// position may read the 32-bit word holding its first bit and the next one.
__device__ __forceinline__ void stage_row_padded(uint8_t* dst, const uint8_t* src, int n,
                                                 int padded, bool vec16, int tid,
                                                 int n_threads) {
  stage_row(dst, src, n, vec16, tid, n_threads);
  for (int i = n + tid; i < padded; i += n_threads)
    if (!vec16 || i >= round16(n)) dst[i] = 0;
}

// A staged row: bytes a wire row needs in shared memory, with its padding.
__host__ __device__ inline int wire_row_bytes(int L) { return round16((L + 3) / 4 + 8); }
__host__ __device__ inline int invalid_row_bytes(int L) { return round16((L + 7) / 8 + 8); }

struct WireRow {
  const uint32_t* wire;     // the staged row as 32-bit words
  const uint32_t* inv;      // the staged invalid plane as 32-bit words, or nullptr (lean)
  int k, len;               // len: the lean wire's valid length, clamped to [0, L]
  uint32_t code_mask, base_mask;
};

__device__ __forceinline__ WireRow wire_row(const uint8_t* wire8, const uint8_t* inv8, int k,
                                            int len) {
  WireRow r;
  r.wire = reinterpret_cast<const uint32_t*>(wire8);
  r.inv = reinterpret_cast<const uint32_t*>(inv8);
  r.k = k;
  r.len = len;
  r.code_mask = (1u << (2 * k)) - 1u;
  r.base_mask = (1u << k) - 1u;
  return r;
}

// True iff the k bases at position p are all valid.
__device__ __forceinline__ bool kmer_valid(const WireRow& r, int p) {
  if (r.inv != nullptr) {
    const int wi = p >> 5;
    return (__funnelshift_r(r.inv[wi], r.inv[wi + 1], p & 31) & r.base_mask) == 0;
  }
  return p + r.k <= r.len;
}

// The base-4 rolling code of the k bases at position p.
__device__ __forceinline__ uint32_t kmer_code(const WireRow& r, int p) {
  const int wi = p >> 4;
  return __funnelshift_r(r.wire[wi], r.wire[wi + 1], (p & 15) * 2) & r.code_mask;
}

// True iff two matches of the k-mer with this code can overlap: it has a
// period d < k, i.e. its last k - d bases equal its first k - d
// (kmers.smallest_period < k).  A negative code (a non-ACGT k-mer) matches
// nothing, so it never overlaps.  Greedy non-overlapping counting of an
// entry that cannot overlap is plain occurrence counting.
__device__ __forceinline__ bool self_overlaps(int32_t code, int k) {
  if (code < 0) return false;
  const uint32_t c = static_cast<uint32_t>(code);
  for (int d = 1; d < k; ++d)
    if ((c >> (2 * d)) == (c & ((1u << (2 * (k - d))) - 1u))) return true;
  return false;
}

// Take the matches in `m` (bit j: a match at offset base + j) greedily:
// a match at offset o is taken when o >= next_free, which then becomes
// o + k.  One step per match taken, by find-first-set.  `next_free` carries
// from word to word of a chain.
__device__ __forceinline__ int take_greedy(uint32_t m, int base, int k, int& next_free) {
  const int lo = next_free - base;
  if (lo >= 32) return 0;
  if (lo > 0) m &= ~0u << lo;
  int taken = 0;
  while (m != 0) {
    const int nx = __ffs(m) - 1 + k;
    ++taken;
    next_free = base + nx;
    m = nx >= 32 ? 0u : m & (~0u << nx);
  }
  return taken;
}

}  // namespace topsicle
