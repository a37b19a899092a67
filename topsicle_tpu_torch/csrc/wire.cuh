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

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace topsicle {

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// ---- shared memory past 48 KB ------------------------------------------------
//
// A block gets 48 KB of shared memory, static and dynamic together, unless
// its kernel opts in to more (cudaFuncAttributeMaxDynamicSharedMemorySize),
// up to kSmemOptin less the kernel's static part.  A launch past 48 KB in all
// without the opt-in fails with an invalid argument, even where its dynamic
// bytes alone stay under 48 KB.

constexpr int kSmemDefault = 48 * 1024;   // a block's shared memory without the opt-in
constexpr int kSmemOptin = 232448;        // an H100 block's most with it (227 KB)

// Lets `kKernel` launch with `dynamic` bytes of dynamic shared memory: opts it
// in where those and its static shared memory pass kSmemDefault.  The static
// bytes are read once (cudaFuncGetAttributes).  Returns the CUDA error, with
// CUDA's last error cleared, or cudaSuccess.
template <auto kKernel>
inline cudaError_t allow_smem(int dynamic) {
  static std::atomic<int> static_bytes{-1};
  int s = static_bytes.load(std::memory_order_relaxed);
  if (s < 0) {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, kKernel);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
    s = static_cast<int>(attr.sharedSizeBytes);
    static_bytes.store(s, std::memory_order_relaxed);
  }
  if (dynamic + s <= kSmemDefault) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
  if (e != cudaSuccess) cudaGetLastError();  // the next launch must not report it
  return e;
}

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

// ---- the window-block grid ---------------------------------------------------
//
// The step-2 signal kernels launch on blocks (b, wb): read b, window block wb
// of `WB` windows (the grid of the TPU launcher,
// topsicle_tpu/ops/pallas_kernels.py::phase_plane_geometry, without its
// planar wire).  A block stages only the bases its windows read: from window
// wb*WB's first base, rounded down to kStageAlign so that the staged wire
// and invalid plane start on a 16-byte boundary of their rows and every
// position keeps its place in a 32-bit word, through its last window's last
// base (the halo: J + k - 1 bases past the last window's start).  Positions
// inside the block count from the first staged base.  One block a read is
// the grid with WB = W and the whole row staged.

constexpr int kStageAlign = 128;    // bases: 32 bytes of wire, 16 of invalid plane
constexpr int kMaxGridY = 65535;     // blocks a read: a launch's second grid axis

// Bases a block of `WB` windows stages at most: the whole row where one
// block serves the read, else the worst misalignment, the windows' starts and
// the halo.
__host__ __device__ inline int block_span(int L, int W, int WB, int slide, int J, int k) {
  if (WB >= W) return L;
  const long long span = kStageAlign - 1 + static_cast<long long>(WB - 1) * slide + J + k - 1;
  return span < L ? static_cast<int>(span) : L;
}

struct WindowBlock {
  int w0;       // the block's first window
  int n_win;    // its windows: WB, fewer in a read's last block
  int pa;       // the first staged base, a multiple of kStageAlign
  int off;      // window w0's first base, counted from pa
  int n_bases;  // staged bases: `span`, fewer (down to 0) where the row ends
};

__host__ __device__ inline WindowBlock window_block(int wb, int WB, int W, int L, int slide,
                                                    int span) {
  WindowBlock s;
  s.w0 = wb * WB;
  s.n_win = W - s.w0 < WB ? W - s.w0 : WB;
  const long long first = static_cast<long long>(s.w0) * slide;
  const long long pa = first & ~static_cast<long long>(kStageAlign - 1);
  s.pa = static_cast<int>(pa < L ? pa : (L & ~(kStageAlign - 1)));
  s.off = static_cast<int>(first - s.pa);
  s.n_bases = L - s.pa < span ? L - s.pa : span;
  return s;
}

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
