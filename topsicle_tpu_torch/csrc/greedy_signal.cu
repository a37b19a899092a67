// Step-2 greedy window-count kernel for Hopper (sm_90a), with the exact
// changepoint fused behind it: one thread block per read, or per block of a
// long read's windows.
//
// Replaces: topsicle_tpu/ops/pallas_kernels.py::_signal_kernel (the TPU
// kernel behind step2_signal_pallas and _lean) and, in the fused entry, the
// changepoint program that follows it
// (topsicle_tpu/ops/changepoint.py::binseg_l2_device).  Computes, for every
// read b, window w and table entry e, exactly what
// ops/match.py::window_counts computes: the greedy non-overlapping count of
// entry e over the J offsets p = w*slide + j, j < J.  A match at offset j
// is taken when j >= next_free, which then becomes j + k; the chain
// restarts at every window.  This is re.finditer's count, exact for every
// table: periodic entries, duplicate entries (each counted on its own), a
// negative entry (a non-ACGT k-mer, which matches nothing), any K, k <= 15.
//
// Three entry points share one kernel body:
//   topsicle_greedy_signal    y[b, w] = sum_e max(count, 1)    int32 [B, W]
//   topsicle_greedy_counts    count[b, e, w], no floor          int32 [B, K, W]
//   topsicle_greedy_boundary  y stays in shared memory, csrc/binseg.cuh
//                             finds the changepoint there (across a
//                             thread-block cluster where a read takes
//                             several blocks), and only (t int64, has
//                             uint8) leave the chip
// The second gives --rawcountpattern/--plot their per-entry counts.
//
// Input is the PLAIN wire sum_signal.cu reads (csrc/wire.cuh): 2 bits a
// base, plus per-read lengths (lean) or an invalid bit-plane (dense).
//
// What bounds it on this card: operations, not bytes.  A batch of 128
// reads of 19,968 bases moves 0.64 MB in and 1.7 MB of y out (0.7 us at
// 3.35 TB/s; the fused entry 9 bytes a read out).  The function needs one
// compare a (position, entry), and per (window, entry) the J match bits of
// the window, their count, the floor and an add: a few operations a
// 32-bit word of bits, plus one step per match that a self-overlapping
// entry's greedy chain takes.  A walk over all J offsets of every (window,
// entry) is not among the needs: windows overlap (15-fold at slide 6,
// J = 93), and the carry only matters where two matches can overlap.
//
// The design:
//   A. match planes.  The read's wire row (and invalid plane) comes into
//      shared memory once with 16-byte loads.  A warp takes 32 consecutive
//      positions; each lane forms its position's rolling code and validity
//      from the wire's bit stream, and for entry e
//      __ballot_sync(valid && code == table[e]) IS the 32-bit word of
//      entry e's match plane.  One compare a (position, entry), once, not
//      once a window.  Planes [K][words] stay in shared memory (14 x 625
//      words = 35 KB at k = 7, L = 19,968); where K planes do not fit a
//      block, the table goes in groups of entries that do, and y collects
//      the groups' sums.
//   B. a lane a window, looping over the entries: the window's J bits come
//      word by word out of the plane (a funnel shift each).  An entry
//      whose matches cannot overlap (no period below k, found from its
//      code) counts by popcount.  A self-overlapping entry counts by
//      find-first-set: clear the bits below next_free, take the lowest,
//      next_free = its offset + k; one step per match taken.  The floored
//      sum over the entries stays in the lane's register: no atomics.
//      Lanes of a warp hold neighbouring windows and the same entry, so
//      they read neighbouring words and branch alike.
//   C. the fused entry runs binseg.cuh's slice_changepoint on y in shared
//      memory, written at tile_slot positions in B.
// A batch of 128 reads gives 128 of the card's 132 SMs one block each, so
// a block is 1,024 threads: 32 warps hide the latency of the shared-memory
// reads and of the ballots, eight of which are in flight at a time (on an
// H100 at 700 W, k = 7: 512 threads and one ballot at a time took 0.057 ms
// a batch, this 0.043).
//
// Long reads: the window-block grid.  A read of which one plane, the staged
// rows (and, fused, y [W]) pass a block's 227 KB cannot be one block.
// topsicle_greedy_signal and topsicle_greedy_counts then launch on blocks
// (read, window block) of `block_windows` windows, the second grid axis of
// the TPU launcher (topsicle_tpu/ops/pallas_kernels.py::_signal_pallas_call):
// a block stages the bytes its windows read (csrc/wire.cuh::window_block),
// its match planes cover those positions only, and it writes its windows of
// y [B, W], or its [K, windows] slab of the counts, to device memory.  The
// chain restarts at every window, so nothing crosses a block's edge.  The
// fused entry takes the same blocks as one thread-block cluster a read (2
// to 8 blocks): each keeps its windows' slice of y in its own shared
// memory and binseg.cuh::slice_changepoint runs across the cluster
// (distributed shared memory).  Past 8 blocks a read the caller runs
// topsicle_greedy_signal on the grid and then csrc/binseg.cu
// (ops/geometry.py picks the route before the launch).

#include <cstdint>
#include <cuda_runtime.h>

#include "binseg.cuh"
#include "wire.cuh"

namespace {

constexpr int kThreads = 1024;
// The first kCpThreads threads of a block run the changepoint, the others
// only meet its barriers: fewer warps in its shuffle reductions.  Swept at
// B = 128 x 19,968 over 128 / 256 / 512 / 1,024 (PERF.md): 256 was the
// fastest for both bodies.
constexpr int kCpThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;                      // ballots in flight in step A
constexpr int kSmemLimit = topsicle::kSmemOptin - 2048;   // less the static part

enum Mode { kSignal, kCounts, kBoundary };

using topsicle::round16;

// Dynamic shared-memory layout, in bytes: wire | invalid plane | table (and
// kUnroll entries of -1 behind it, which match nothing) | self-overlap
// flags | y (the fused entry: the block's W windows at binseg.cuh's
// tile_slot positions) | Kg match planes of `pw` words.  `L` is the
// bases a block stages and `W` the windows it serves (the read's, with one
// block a read).  One function for the launcher and the kernel;
// ops/geometry.py mirrors it.
struct Layout {
  long long inv, tab, flag, y, planes, total;
};

__host__ __device__ inline Layout layout(int L, int W, int K, int Kg, int pw, bool dense,
                                         bool boundary) {
  Layout s;
  s.inv = topsicle::wire_row_bytes(L);
  s.tab = s.inv + (dense ? topsicle::invalid_row_bytes(L) : 0);
  s.flag = s.tab + round16(4 * (K + kUnroll));
  s.y = s.flag + round16(K);
  s.planes = s.y + (boundary ? topsicle::slice_smem_bytes(W) : 0);
  s.total = s.planes + 4ll * Kg * pw;
  return s;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
greedy_kernel(const uint8_t* __restrict__ packed, int packed_stride, int packed_vec16,
              const int32_t* __restrict__ lengths,
              const uint8_t* __restrict__ invalid, int invalid_stride, int invalid_vec16,
              const int32_t* __restrict__ table, int K, int k,
              int slide, int J, int L, int W, int WB, int span, int Kg, int pw,
              int32_t* __restrict__ out,
              const int32_t* __restrict__ n_windows, int jump, int min_size,
              long long* __restrict__ t_out, uint8_t* __restrict__ has_out) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool dense = invalid != nullptr;
  // the read's window count, loaded now so that its latency hides behind the signal
  const long long n_read = kMode == kBoundary ? static_cast<long long>(n_windows[b]) : 0;
  const topsicle::WindowBlock blk = topsicle::window_block(blockIdx.y, WB, W, L, slide, span);
  const Layout lay = layout(span, WB, K, Kg, pw, dense, kMode == kBoundary);
  uint8_t* wire8 = smem;
  uint8_t* inv8 = smem + lay.inv;
  int32_t* tab = reinterpret_cast<int32_t*>(smem + lay.tab);
  uint8_t* overlaps = smem + lay.flag;
  int32_t* y = reinterpret_cast<int32_t*>(smem + lay.y);
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem + lay.planes);

  // ---- stage the block's bytes of the row and the plane, and the table ----
  topsicle::stage_row_padded(wire8,
                             packed + static_cast<size_t>(b) * packed_stride + blk.pa / 4,
                             (blk.n_bases + 3) / 4, static_cast<int>(lay.inv),
                             packed_vec16 != 0, threadIdx.x, kThreads);
  if (dense)
    topsicle::stage_row_padded(inv8,
                               invalid + static_cast<size_t>(b) * invalid_stride + blk.pa / 8,
                               (blk.n_bases + 7) / 8, static_cast<int>(lay.tab - lay.inv),
                               invalid_vec16 != 0, threadIdx.x, kThreads);
  for (int e = threadIdx.x; e < K + kUnroll; e += kThreads) {
    tab[e] = e < K ? table[e] : -1;
    if (e < K) overlaps[e] = topsicle::self_overlaps(table[e], k);
  }
  __syncthreads();

  // Positions count from the block's first staged base; `len` is what of
  // the read's valid length lies in the staged bases.
  const int len = min((lengths != nullptr ? max(0, min(lengths[b], L)) : L) - blk.pa,
                      blk.n_bases);
  const topsicle::WireRow row = topsicle::wire_row(wire8, dense ? inv8 : nullptr, k, len);
  const int n_pos = len - k + 1;          // positions whose k-mer lies inside the read
  const int n_words = (J + 31) >> 5;      // plane words a window's bits come from
  const uint32_t last_mask = (J & 31) ? (1u << (J & 31)) - 1u : ~0u;

  for (int e0 = 0; e0 < K; e0 += Kg) {
    const int n_e = min(Kg, K - e0);

    // ---- A. the match planes of entries e0 .. e0 + n_e - 1 ----
    for (int word = warp; word < pw; word += kWarps) {
      const int p = word * 32 + lane;
      const bool valid = p < n_pos && topsicle::kmer_valid(row, p);
      const uint32_t code = valid ? topsicle::kmer_code(row, p) : 0u;
      for (int j0 = 0; j0 < n_e; j0 += 32) {
        const int nj = min(32, n_e - j0);
        uint32_t mine = 0;
        if (word * 32 < n_pos) {          // else the whole word lies past the read
          // kUnroll independent ballots at a time; an entry past the group
          // lands on a lane that stores nothing
          const int32_t* te = tab + e0 + j0;
          for (int j = 0; j < nj; j += kUnroll) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const uint32_t bits = __ballot_sync(
                  0xffffffffu, valid && code == static_cast<uint32_t>(te[j + u]));
              if (lane == j + u) mine = bits;
            }
          }
        }
        if (lane < nj) planes[(j0 + lane) * pw + word] = mine;
      }
    }
    __syncthreads();

    // ---- B. per window: the entries' greedy counts ----
    for (int w = threadIdx.x; w < blk.n_win; w += kThreads) {
      const int s = blk.off + w * slide;
      const int sh = s & 31;
      const uint32_t* first = planes + (s >> 5);
      int32_t acc = 0;
      for (int e = 0; e < n_e; ++e) {
        int32_t cnt = 0;
        if (s < n_pos) {                  // else the window starts past the read: no match
          const uint32_t* pl = first + e * pw;
          const bool chain = overlaps[e0 + e];      // the same for every lane
          uint32_t lo = pl[0];
          int next_free = 0;
#pragma unroll 4
          for (int i = 0; i < n_words; ++i) {
            const uint32_t hi = pl[i + 1];
            uint32_t m = __funnelshift_r(lo, hi, sh);
            if (i == n_words - 1) m &= last_mask;
            cnt += chain ? topsicle::take_greedy(m, 32 * i, k, next_free) : __popc(m);
            lo = hi;
          }
        }
        if (kMode == kCounts) {
          out[(static_cast<size_t>(b) * K + e0 + e) * W + blk.w0 + w] = cnt;
        } else {
          acc += max(cnt, 1);
        }
      }
      // the same thread meets window w in every group of entries
      if (kMode == kSignal) {
        int32_t* yw = out + static_cast<size_t>(b) * W + blk.w0 + w;
        *yw = e0 == 0 ? acc : *yw + acc;
      } else if (kMode == kBoundary) {
        int32_t* yw = y + topsicle::tile_slot(w);
        *yw = e0 == 0 ? acc : *yw + acc;
      }
    }
    __syncthreads();      // the next group's planes, or the changepoint's reads of y
  }

  // ---- C. the changepoint of y, in the same block or cluster ----
  if (kMode == kBoundary) {
    __shared__ topsicle::TileScratch scratch;
    topsicle::slice_changepoint<kCpThreads>(y, blk.n_win, W, WB, n_read, jump, min_size,
                                            scratch, t_out + b, has_out + b);
  }
}

// What a launch is made of: the windows a block serves (`WB`; the read's W
// with one block a read), the bases it stages, its plane words, the entries
// whose planes it holds at a time, and its shared memory.
struct Plan {
  int WB, n_blocks, span, Kg, pw, smem_bytes;
};

// The plan of a launch with `block_windows` windows a block (0, or W and
// more: one block a read); false when the staged rows, y and one match plane
// do not fit a block's shared memory.  The fused entry's blocks of a read
// are one cluster: at most kMaxCluster.
inline bool plan(int L, int W, int K, int k, int J, int slide, bool dense, bool boundary,
                 int block_windows, Plan* p) {
  p->WB = block_windows > 0 && block_windows < W ? block_windows : W;
  p->n_blocks = (W + p->WB - 1) / p->WB;
  if (p->n_blocks > topsicle::kMaxGridY || (boundary && p->n_blocks > topsicle::kMaxCluster))
    return false;
  p->span = topsicle::block_span(L, W, p->WB, slide, J, k);
  // plane words: through the word after the last one a window's bits start
  // in (a block's first window starts up to kStageAlign - 1 positions into
  // its staged bases), an odd count so that the lanes' stores of step A
  // spread over banks
  const long long first_max = p->n_blocks > 1 ? topsicle::kStageAlign - 1 : 0;
  const long long pw =
      (((first_max + static_cast<long long>(p->WB - 1) * slide) >> 5) + ((J + 31) >> 5) + 1) | 1;
  const long long fixed = layout(p->span, p->WB, K, 0, 0, dense, boundary).total;
  if (fixed + 4 * pw > kSmemLimit) return false;
  const int fit = static_cast<int>((kSmemLimit - fixed) / (4 * pw));     // planes a block holds
  const int n_groups = (K + fit - 1) / fit;
  p->Kg = (K + n_groups - 1) / n_groups;
  p->pw = static_cast<int>(pw);
  p->smem_bytes = static_cast<int>(fixed + 4 * pw * p->Kg);
  return true;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success), or -2
// when a block does not fit shared memory (ops/geometry.py picks a route
// that fits before the launch, so -2 is a fault of the caller).
template <int kMode>
int launch(const void* packed, int packed_stride, const void* lengths, const void* invalid,
           int invalid_stride, const void* table, int K, int k, int slide, int J, int L,
           int W, int B, int block_windows, void* out, const void* n_windows, int jump,
           int min_size, void* t_out, void* has_out, void* stream) {
  const bool dense = invalid != nullptr;
  Plan p;
  if (!plan(L, W, K, k, J, slide, dense, kMode == kBoundary, block_windows, &p)) return -2;
  const cudaError_t opt = topsicle::allow_smem<greedy_kernel<kMode>>(p.smem_bytes);
  if (opt != cudaSuccess) return static_cast<int>(opt);
  using topsicle::aligned16;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      topsicle::launch_config(B, p.n_blocks, kThreads, p.smem_bytes, kMode == kBoundary,
                              static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, greedy_kernel<kMode>,
      static_cast<const uint8_t*>(packed), packed_stride, aligned16(packed, packed_stride),
      static_cast<const int32_t*>(lengths),
      static_cast<const uint8_t*>(invalid), invalid_stride,
      dense && aligned16(invalid, invalid_stride),
      static_cast<const int32_t*>(table), K, k, slide, J, L, W, p.WB, p.span, p.Kg, p.pw,
      static_cast<int32_t*>(out), static_cast<const int32_t*>(n_windows), jump, min_size,
      static_cast<long long*>(t_out), static_cast<uint8_t*>(has_out));
  // read (and so clear) the last error on both paths: a failed launch must
  // not leave it set for the next launch in the process to report
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

// Pointers are device pointers; exactly one of `lengths` (lean wire) and
// `invalid` (dense wire) is non-null.  Needs J >= 1, W >= 1, B >= 1,
// K >= 1, k <= 15, W * slide + J + k < 2^31.  Window w reads offsets
// w*slide + j, j < J; offsets past L - k never match.  `block_windows`: the
// windows a block serves on the window-block grid; 0 for one block a read.

// y int32 [B, W]: sum over the K entries of max(count, 1).
extern "C" int topsicle_greedy_signal(const void* packed, int packed_stride,
                                      const void* lengths,
                                      const void* invalid, int invalid_stride,
                                      const void* table, int K, int k,
                                      int slide, int J, int L, int W, int B,
                                      int block_windows, void* out, void* stream) {
  return launch<kSignal>(packed, packed_stride, lengths, invalid, invalid_stride, table, K, k,
                         slide, J, L, W, B, block_windows, out, nullptr, 0, 0, nullptr,
                         nullptr, stream);
}

// counts int32 [B, K, W], no floor.
extern "C" int topsicle_greedy_counts(const void* packed, int packed_stride,
                                      const void* lengths,
                                      const void* invalid, int invalid_stride,
                                      const void* table, int K, int k,
                                      int slide, int J, int L, int W, int B,
                                      int block_windows, void* out, void* stream) {
  return launch<kCounts>(packed, packed_stride, lengths, invalid, invalid_stride, table, K, k,
                         slide, J, L, W, B, block_windows, out, nullptr, 0, 0, nullptr,
                         nullptr, stream);
}

// The signal, followed in the launch by the changepoint: `n_windows` [B]
// int32, `t_out` [B] int64, `has_out` [B] uint8 (0 or 1).  Needs
// jump >= 1 and min_size >= 1.  `block_windows`: 0 (or W and more) for one
// block a read; fewer for a cluster of ceil(W / block_windows) <= 8 blocks
// a read, each with its window block's slice of y.
extern "C" int topsicle_greedy_boundary(const void* packed, int packed_stride,
                                        const void* lengths,
                                        const void* invalid, int invalid_stride,
                                        const void* table, int K, int k,
                                        int slide, int J, int L, int W, int B,
                                        int block_windows, const void* n_windows, int jump,
                                        int min_size, void* t_out, void* has_out,
                                        void* stream) {
  return launch<kBoundary>(packed, packed_stride, lengths, invalid, invalid_stride, table, K,
                           k, slide, J, L, W, B, block_windows, nullptr, n_windows, jump,
                           min_size, t_out, has_out, stream);
}

// As topsicle_sum_max_clusters, for the greedy body's fused entry.
extern "C" int topsicle_greedy_max_clusters(int L, int W, int K, int k, int J, int slide,
                                            int dense, int block_windows, int* out) {
  Plan p;
  if (!plan(L, W, K, k, J, slide, dense != 0, true, block_windows, &p)) return -2;
  const cudaError_t opt = topsicle::allow_smem<greedy_kernel<kBoundary>>(p.smem_bytes);
  if (opt != cudaSuccess) return static_cast<int>(opt);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      topsicle::launch_config(1, p.n_blocks, kThreads, p.smem_bytes, true, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, greedy_kernel<kBoundary>, &cfg));
}

// What the launcher would do, without launching: out[0..4] = shared-memory
// bytes, windows a block, blocks a read, entries a group of planes, words a
// plane.  Returns 0, or -2 where the launch would.
extern "C" int topsicle_greedy_plan(int L, int W, int K, int k, int J, int slide, int dense,
                                    int boundary, int block_windows, int* out) {
  Plan p;
  if (!plan(L, W, K, k, J, slide, dense != 0, boundary != 0, block_windows, &p)) return -2;
  out[0] = p.smem_bytes;
  out[1] = p.WB;
  out[2] = p.n_blocks;
  out[3] = p.Kg;
  out[4] = p.pw;
  return 0;
}
