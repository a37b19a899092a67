// Step-1 greedy count kernel for Hopper (sm_90a): one block per row.
//
// Replaces: topsicle_tpu/models/telomere.py::_step1_counts_lean and
// _step1_counts (the XLA programs of step 1, which count with
// topsicle_tpu/ops/match.py::greedy_count_chunked, or with plain sums for
// an aperiodic table).  For every row r (a read end) and table entry e it
// computes exactly what ops/match.py::greedy_count computes: the greedy
// non-overlapping count of entry e over all L - k + 1 positions of the row.
// A match at position p is taken when p >= next_free, which then becomes
// p + k: re.finditer's count, exact for every table (periodic entries,
// duplicates each counted, a negative entry matching nothing, any K,
// k <= 15).
//
// Input is the PLAIN wire (csrc/wire.cuh): packed ends uint8 [R, >= L/4]
// plus int32 [R] lengths (lean) or an invalid bit-plane (dense).  Output
// int32 [R, K].
//
// What bounds it on this card: the launch.  256 ends of 1,000 bases are
// 64 KB in and 14 KB out (0.02 us at 3.35 TB/s) and about 5 M integer
// operations (one compare a (position, entry), a count a 32-bit word of
// match bits; 0.3 us at the card's INT32 rate): both far below the few
// microseconds any launch takes.  What the kernel's own time is made of is
// latency: the dependent chain of one row, on a card that these few rows
// cannot fill.  So the design cuts the chain, in two steps as
// greedy_signal.cu does:
//   A. a block takes a row, stages it in shared memory, and its warps take
//      the row's 32-position words in turn (a warp a row, the first body,
//      walked 32 rounds one after the other: 0.017 ms for 256 ends on an
//      H100 at 700 W, against 0.005 ms for this one; see PERF.md).  Each lane forms its position's rolling code and validity
//      from the wire's bit stream (a funnel shift and a mask each); lane e
//      keeps table entry e (read once, passed round by shuffle), and K
//      ballots, eight in flight, give the 32-bit match words of the K
//      entries at these positions, which go to a plane [32][words] in
//      shared memory;
//   B. lane e of the first warp walks entry e's words: a popcount each where
//      the entry's matches cannot overlap (no period below k, found from
//      its code), else find-first-set with next_free carried from word to
//      word, one step per match taken.
// Entries beyond 32 go in further rounds of 32.  A lean row's walk ends at
// its length.

#include <cstdint>
#include <cuda_runtime.h>

#include "wire.cuh"

namespace {

constexpr int kWarps = 8;                       // warps that share a row's words
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;                      // ballots in flight
constexpr int kSmemLimit = topsicle::kSmemOptin - 1024;   // no static part

// Dynamic shared memory, in bytes: wire | invalid plane | 32 match planes of
// `pw` words.  One function for the launcher and the kernel.
__host__ __device__ inline long long planes_offset(int L, bool dense) {
  return topsicle::wire_row_bytes(L) + (dense ? topsicle::invalid_row_bytes(L) : 0);
}

__global__ void __launch_bounds__(kThreads)
step1_kernel(const uint8_t* __restrict__ packed, int packed_stride, int packed_vec16,
             const int32_t* __restrict__ lengths,
             const uint8_t* __restrict__ invalid, int invalid_stride, int invalid_vec16,
             const int32_t* __restrict__ table, int K, int k, int L, int pw,
             int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x;
  const bool dense = invalid != nullptr;
  const int wire_bytes = topsicle::wire_row_bytes(L);
  uint8_t* wire8 = smem;
  uint8_t* inv8 = smem + wire_bytes;
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem + planes_offset(L, dense));

  topsicle::stage_row_padded(wire8, packed + static_cast<size_t>(r) * packed_stride,
                             (L + 3) / 4, wire_bytes, packed_vec16 != 0, threadIdx.x,
                             kThreads);
  if (dense)
    topsicle::stage_row_padded(inv8, invalid + static_cast<size_t>(r) * invalid_stride,
                               (L + 7) / 8, topsicle::invalid_row_bytes(L),
                               invalid_vec16 != 0, threadIdx.x, kThreads);
  __syncthreads();

  const int len = lengths != nullptr ? max(0, min(lengths[r], L)) : L;
  const topsicle::WireRow row = topsicle::wire_row(wire8, dense ? inv8 : nullptr, k, len);
  const int n_pos = len - k + 1;                // positions whose k-mer lies inside the row
  const int n_words = n_pos > 0 ? (n_pos + 31) >> 5 : 0;

  for (int e0 = 0; e0 < K; e0 += 32) {
    const int nj = min(32, K - e0);
    // a lane past the table holds -1, which no code equals
    const int32_t entry = lane < nj ? table[e0 + lane] : -1;

    // ---- A. the match words of entries e0 .. e0 + nj - 1 ----
    for (int word = warp; word < n_words; word += kWarps) {
      const int p = word * 32 + lane;
      const bool valid = p < n_pos && topsicle::kmer_valid(row, p);
      const uint32_t code = valid ? topsicle::kmer_code(row, p) : 0u;
      uint32_t m = 0;
      for (int j = 0; j < nj; j += kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const uint32_t te = static_cast<uint32_t>(__shfl_sync(0xffffffffu, entry, j + u));
          const uint32_t bits = __ballot_sync(0xffffffffu, valid && code == te);
          if (lane == j + u) m = bits;
        }
      }
      if (lane < nj) planes[lane * pw + word] = m;
    }
    __syncthreads();

    // ---- B. lane e walks entry e's words ----
    if (warp == 0 && lane < nj) {
      const uint32_t* pl = planes + lane * pw;
      int32_t cnt = 0;
      if (topsicle::self_overlaps(entry, k)) {
        int next_free = 0;
        for (int word = 0; word < n_words; ++word)
          cnt += topsicle::take_greedy(pl[word], word * 32, k, next_free);
      } else {
#pragma unroll 8
        for (int word = 0; word < n_words; ++word) cnt += __popc(pl[word]);
      }
      out[static_cast<size_t>(r) * K + e0 + lane] = cnt;
    }
    if (e0 + 32 < K) __syncthreads();           // the next round writes the planes anew
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or -2
// when a row of L bases and its match planes do not fit a block's shared
// memory.  Pointers are device pointers; exactly one of `lengths` (lean
// wire) and `invalid` (dense wire) is non-null.  Needs R >= 1, K >= 1,
// 1 <= k <= 15, L >= k.
extern "C" int topsicle_step1_counts(const void* packed, int packed_stride,
                                     const void* lengths,
                                     const void* invalid, int invalid_stride,
                                     const void* table, int K, int k, int L, int R,
                                     void* out, void* stream) {
  const bool dense = invalid != nullptr;
  // words of a plane, an odd count so that the lanes' stores spread over banks
  const long long pw = ((static_cast<long long>(L) - k + 1 + 31) >> 5) | 1;
  const long long smem_bytes = planes_offset(L, dense) + 32 * 4 * pw;
  if (smem_bytes > kSmemLimit) return -2;
  const cudaError_t opt = topsicle::allow_smem<step1_kernel>(static_cast<int>(smem_bytes));
  if (opt != cudaSuccess) return static_cast<int>(opt);
  using topsicle::aligned16;
  step1_kernel<<<R, kThreads, static_cast<size_t>(smem_bytes),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), packed_stride, aligned16(packed, packed_stride),
      static_cast<const int32_t*>(lengths),
      static_cast<const uint8_t*>(invalid), invalid_stride,
      dense && aligned16(invalid, invalid_stride),
      static_cast<const int32_t*>(table), K, k, L, static_cast<int>(pw),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
