// Step-2 sum-signal kernel for Hopper (sm_90a), with the exact changepoint
// fused behind it: one thread block per read, or per block of a long read's
// windows.
//
// Replaces: topsicle_tpu/ops/pallas_kernels.py::_sum_signal_kernel (the
// TPU kernel behind step2_sum_signal_pallas and _lean) and, in the fused
// entry, the changepoint program that follows it
// (topsicle_tpu/ops/changepoint.py::binseg_l2_device).  For every read b
// and window w it computes exactly what ops/match.py::boundary_sum_signal
// computes:
//
//   y[b, w] = sum_{j<J} popc(word[w*slide + j]) + K - popc(OR_{j<J} word[w*slide + j])
//
// with J = window_size - k and word[p] the presence bits of the table
// entries equal to the base-4 rolling code at position p (every entry owns
// a bit, duplicates too, so popc(word) is the number of entries matching
// at p).  Exact for every table the caller hands it (K <= 31, k <= 15);
// that the sum equals the greedy non-overlapping count needs an aperiodic
// table, which the model checks.  Two entry points share the body:
//
//   topsicle_sum_signal     y [B, W] int32 goes to device memory
//   topsicle_sum_boundary   y stays in shared memory, csrc/binseg.cuh finds
//                           the changepoint there (across a thread-block
//                           cluster where a read takes several blocks),
//                           and only (t int64, has uint8) leave the chip:
//                           9 bytes a read
//
// Input is the PLAIN wire the engine already packs (csrc/wire.cuh): 2 bits
// a base, plus either per-read lengths (lean) or an invalid bit-plane
// (dense).  The rolling code of a position and the validity of its k
// bases are bit fields of it: one funnel shift and a mask each, no
// per-base work.
//
// What bounds it on this card: operations, not bytes.  The fused entry
// moves 0.64 MB a batch of 128 reads of 19,968 bases (the wire, 4,992 B a
// read; lengths and window counts; 9 B out): 0.19 us at 3.35 TB/s.  The
// stand-alone entry adds y (1.7 MB): 0.70 us.  The integer work of the
// body is 11 operations a position (3 where the k-mer lies past the
// read's length), 8 a group of `slide` positions for the two group scans,
// 8 a window and 40 a changepoint candidate: at most 0.30 M a read, 38 M
// a batch, 2.3 us at the card's 16.75 T INT32 operations a second (132
// SMs * 64 lanes * 1.98 GHz).  One block a read on 128 of 132 SMs, and
// the serial loops of the group and segment scans, keep the design's own
// floor above that.
//
// The design: a read's wire row (and invalid plane) comes into shared
// memory once with 16-byte loads (byte loads where a row is not 16-byte
// aligned).  The presence word comes from a 4^k-entry table in shared
// memory where that fits (k <= 7: at most 64 KB), else from K compares,
// and is computed once a position.  Windows cost O(1), not O(J), and no
// lane takes a branch its neighbours do not:
//
//   1. positions are cut into groups of `slide`, so every window starts on
//      a group boundary and is Q = J / slide whole groups and the first
//      R = J % slide positions of the next.  One thread a group keeps the
//      OR and the sum of popc(word) of the whole group and of its first R
//      positions;
//   2. the Q whole groups of a window are a sliding window over the group
//      array: groups are cut into segments of Q, one thread scans a
//      segment forwards (prefix) and backwards (suffix, in place), and a
//      window is the suffix at its first group joined with the prefix at
//      its last (the pieces are a suffix of one segment and a prefix of
//      the next, so the sums add without overlap);
//   3. one thread a window joins the pieces and writes y.
//
// Nothing is stored per position: six uint32 a group, 80 KB at L = 19,968,
// slide 6, beside 5 KB of wire, 2.5 KB of plane and the table, and in the
// fused entry y (13.7 KB at binseg.cuh's tile_slot positions), 100 KB in
// all, so two blocks share an SM when B > 132.  Where the windows of a
// read do not fit at once (slide 1 at that length: 19,949 windows), the
// block walks them in tiles of as many as fit, each tile with its own
// groups, and the fused entry keeps y [W] beside the tile's arrays.
//
// Long reads: the window-block grid.  A read whose staged rows (and, fused,
// y [W]) pass a block's 227 KB cannot be one block.  topsicle_sum_signal
// then launches on blocks (read, window block) of `block_windows` windows,
// the second grid axis of the TPU launcher
// (topsicle_tpu/ops/pallas_kernels.py::_signal_pallas_call): a block stages
// the bytes its windows read (csrc/wire.cuh::window_block), runs the three
// steps on them with its groups cut from its own first window, and writes
// its windows of y [B, W] to device memory, so shared memory is constant in
// the read's length.  The fused entry takes the same blocks as one
// thread-block cluster a read (2 to 8 blocks, cudaLaunchKernelEx with a
// cluster dimension): each block keeps its windows' slice of y in its own
// shared memory and binseg.cuh::slice_changepoint runs across the cluster
// (distributed shared memory), so y never reaches device memory.  Past 8
// blocks a read the caller runs topsicle_sum_signal on the grid and then
// csrc/binseg.cu (ops/geometry.py picks the route before the launch).

#include <cstdint>
#include <cuda_runtime.h>

#include "binseg.cuh"
#include "wire.cuh"

namespace {

constexpr int kThreads = 512;
// The first kCpThreads threads of a block run the changepoint, the others
// only meet its barriers: fewer warps in its shuffle reductions.  Swept at
// B = 128 x 19,968 over 128 / 256 / 512 / 1,024 (PERF.md): 256 was the
// fastest for both bodies.
constexpr int kCpThreads = 256;
constexpr int kMaxEntries = 31;
constexpr int kLutMaxK = 7;                     // 4^7 words = 64 KB
constexpr int kSmemLimit = topsicle::kSmemOptin - 2048;   // less the static part

using topsicle::round16;

// Dynamic shared-memory layout, in bytes: wire | invalid plane | y (the
// fused entry: the block's W windows at binseg.cuh's tile_slot positions,
// which the changepoint reads without bank conflicts; no group array can
// hold it, since step 3 reads them all while it writes y) | six arrays of
// one tile's tile_w + Q groups | table.  `L` is the bases a block stages
// and `W` the windows it serves (the read's, with one block a read).  One
// function for the launcher and the kernel; ops/geometry.py mirrors it.
constexpr int kGroupArrays = 6;

struct Layout {
  int wire, inv, y, grp, lut, total;
};

__host__ __device__ inline Layout layout(int L, int W, int k, int Q, bool dense, bool use_lut,
                                         int tile_w, bool boundary) {
  Layout s;
  s.wire = 0;
  // a position reads the 32-bit word holding its first bit and the next one
  s.inv = s.wire + topsicle::wire_row_bytes(L);
  s.y = s.inv + (dense ? topsicle::invalid_row_bytes(L) : 0);
  s.grp = s.y + (boundary ? static_cast<int>(topsicle::slice_smem_bytes(W)) : 0);
  s.lut = s.grp + kGroupArrays * round16(4 * (tile_w + Q));
  s.total = s.lut + (use_lut ? 4 << (2 * k) : 0);
  return s;
}

// The windows a tile holds: all W where they fit, else as many as the
// space left after the fixed parts allows (0: the read does not fit).
inline int tile_windows(int L, int W, int k, int Q, bool dense, bool use_lut, bool boundary) {
  if (layout(L, W, k, Q, dense, use_lut, W, boundary).total <= kSmemLimit) return W;
  const int fixed = layout(L, W, k, Q, dense, use_lut, 0, boundary).total;
  // 16 bytes of rounding an array, beyond what `fixed` holds for Q groups
  const int tile_w = ((kSmemLimit - fixed - 16 * kGroupArrays) / (4 * kGroupArrays)) & ~3;
  return tile_w > 0 ? tile_w : 0;
}

struct Read {
  topsicle::WireRow row;    // the staged wire row and invalid plane
  const uint32_t* lut;      // presence word by rolling code, or nullptr
  const int32_t* tab;       // the K table entries (no lut)
  int K;
};

// Presence word of position p: bit e set iff table entry e equals the
// rolling code at p and all its k bases are valid.
__device__ __forceinline__ uint32_t word_at(const Read& r, int p) {
  if (!topsicle::kmer_valid(r.row, p)) return 0;
  const uint32_t code = topsicle::kmer_code(r.row, p);
  if (r.lut != nullptr) return r.lut[code];
  uint32_t wd = 0;
  for (int e = 0; e < r.K; ++e) wd |= static_cast<uint32_t>(static_cast<int32_t>(code) == r.tab[e]) << e;
  return wd;
}

template <bool kBoundary>
__global__ void __launch_bounds__(kThreads)
sum_kernel(const uint8_t* __restrict__ packed, int packed_stride, int packed_vec16,
           const int32_t* __restrict__ lengths,
           const uint8_t* __restrict__ invalid, int invalid_stride, int invalid_vec16,
           const int32_t* __restrict__ table, int K, int k,
           int slide, int J, int L, int W, int WB, int span, int use_lut, int tile_w,
           int32_t* __restrict__ y_out,
           const int32_t* __restrict__ n_windows, int jump, int min_size,
           long long* __restrict__ t_out, uint8_t* __restrict__ has_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t tab[kMaxEntries + 1];
  __shared__ topsicle::TileScratch scratch;

  const int b = blockIdx.x;
  const bool dense = invalid != nullptr;
  // the read's window count, loaded now so that its latency hides behind the signal
  const long long n_read = kBoundary ? static_cast<long long>(n_windows[b]) : 0;
  const int Q = J / slide;            // whole groups in a window
  const int R = J - Q * slide;        // and positions of the next group
  const topsicle::WindowBlock blk = topsicle::window_block(blockIdx.y, WB, W, L, slide, span);
  const Layout lay = layout(span, WB, k, Q, dense, use_lut != 0, tile_w, kBoundary);
  uint8_t* wire8 = smem + lay.wire;
  uint8_t* inv8 = smem + lay.inv;
  const int gn = round16(4 * (tile_w + Q)) / 4;           // words per group array
  uint32_t* g_or = reinterpret_cast<uint32_t*>(smem + lay.grp);   // group, then suffix
  uint32_t* g_sum = g_or + gn;
  uint32_t* p_or = g_sum + gn;                                      // first R positions
  uint32_t* p_sum = p_or + gn;
  uint32_t* f_or = p_sum + gn;                                      // prefix in the segment
  uint32_t* f_sum = f_or + gn;
  uint32_t* lut = reinterpret_cast<uint32_t*>(smem + lay.lut);

  // ---- stage the block's bytes of the row and the plane, and the table ----
  topsicle::stage_row_padded(wire8,
                             packed + static_cast<size_t>(b) * packed_stride + blk.pa / 4,
                             (blk.n_bases + 3) / 4, lay.inv - lay.wire, packed_vec16 != 0,
                             threadIdx.x, kThreads);
  if (dense)
    topsicle::stage_row_padded(inv8,
                               invalid + static_cast<size_t>(b) * invalid_stride + blk.pa / 8,
                               (blk.n_bases + 7) / 8, lay.y - lay.inv, invalid_vec16 != 0,
                               threadIdx.x, kThreads);
  if (threadIdx.x < K) tab[threadIdx.x] = table[threadIdx.x];
  if (use_lut) {
    const int n_codes = 1 << (2 * k);
    for (int i = threadIdx.x; i < n_codes; i += kThreads) lut[i] = 0;
    __syncthreads();
    if (threadIdx.x < K) {
      const int32_t code = tab[threadIdx.x];
      if (code >= 0 && code < n_codes) atomicOr(&lut[code], 1u << threadIdx.x);
    }
  }
  __syncthreads();

  Read r;
  // the lean wire's valid length, counted like every position from the
  // block's first staged base
  r.row = topsicle::wire_row(wire8, dense ? inv8 : nullptr, k,
                             (lengths != nullptr ? max(0, min(lengths[b], L)) : L) - blk.pa);
  r.lut = use_lut ? lut : nullptr;
  r.tab = tab;
  r.K = K;

  int32_t* y = reinterpret_cast<int32_t*>(smem + lay.y);    // the fused entry's slice

  for (int w0 = 0; w0 < blk.n_win; w0 += tile_w) {
    // Positions, groups and windows are counted from the tile's first:
    // window i is groups i .. i + Q - 1 and R positions of group i + Q.
    const int n_win = min(tile_w, blk.n_win - w0);
    const int p0 = blk.off + w0 * slide;
    const int n_pos = (n_win - 1) * slide + J;      // positions the tile's windows read
    const int n_grp = n_win + Q;

    // ---- 1. per group: the OR and the sum over it and over its first R ----
    for (int g = threadIdx.x; g < n_grp; g += kThreads) {
      const int first = g * slide;
      const int n = min(slide, n_pos - first);      // the last group ends with the tile
      uint32_t acc_or = 0, acc_sum = 0, part_or = 0, part_sum = 0;
      for (int j = 0; j < n; ++j) {
        const uint32_t wd = word_at(r, p0 + first + j);
        acc_or |= wd;
        acc_sum += __popc(wd);
        if (j == R - 1) {
          part_or = acc_or;
          part_sum = acc_sum;
        }
      }
      g_or[g] = acc_or;
      g_sum[g] = acc_sum;
      p_or[g] = part_or;
      p_sum[g] = part_sum;
    }
    __syncthreads();

    // ---- 2. segments of Q groups: prefix, and suffix in place ----
    if (Q >= 1) {
      const int n_full = n_win + Q - 1;             // groups that windows hold whole
      const int n_seg = (n_full + Q - 1) / Q;
      for (int seg = threadIdx.x; seg < n_seg; seg += kThreads) {
        const int start = seg * Q;
        const int end = min(start + Q, n_full);
        uint32_t acc_or = 0, acc_sum = 0;
        for (int g = start; g < end; ++g) {
          acc_or |= g_or[g];
          acc_sum += g_sum[g];
          f_or[g] = acc_or;
          f_sum[g] = acc_sum;
        }
        acc_or = 0;
        acc_sum = 0;
        for (int g = end - 1; g >= start; --g) {
          acc_or |= g_or[g];
          acc_sum += g_sum[g];
          g_or[g] = acc_or;
          g_sum[g] = acc_sum;
        }
      }
      __syncthreads();
    }

    // ---- 3. per window: join the pieces ----
    // A window that starts on a segment boundary IS that segment: its
    // suffix holds all of it.  Else it is the suffix from its first group
    // and the next segment's prefix up to its last.
    int phase = Q >= 1 ? threadIdx.x % Q : 0;       // w % Q, kept without dividing
    const int phase_step = Q >= 1 ? kThreads % Q : 0;
    for (int w = threadIdx.x; w < n_win; w += kThreads) {
      uint32_t o = 0, sum = 0;
      if (Q >= 1) {
        o = g_or[w];
        sum = g_sum[w];
        if (phase != 0) {
          o |= f_or[w + Q - 1];
          sum += f_sum[w + Q - 1];
        }
        phase += phase_step;
        if (phase >= Q) phase -= Q;
      }
      if (R > 0) {
        o |= p_or[w + Q];
        sum += p_sum[w + Q];
      }
      const int32_t v = static_cast<int32_t>(sum) + K - __popc(o);
      if (kBoundary) {
        y[topsicle::tile_slot(w0 + w)] = v;
      } else {
        y_out[static_cast<size_t>(b) * W + blk.w0 + w0 + w] = v;
      }
    }
    __syncthreads();      // the next tile, or the changepoint, reuses the arrays
  }
  if (kBoundary) {
    topsicle::slice_changepoint<kCpThreads>(y, blk.n_win, W, WB, n_read, jump, min_size,
                                            scratch, t_out + b, has_out + b);
  }
}

// What a launch is made of: the windows a block serves (`WB`; the read's W
// with one block a read), the bases it stages, and its shared memory.
struct Plan {
  int WB, n_blocks, span, tile_w, smem_bytes;
  bool use_lut;
};

// The plan of a launch with `block_windows` windows a block (0, or W and
// more: one block a read); false when a block does not fit shared memory.
// The fused entry's blocks of a read are one cluster: at most kMaxCluster.
inline bool plan(int L, int W, int k, int J, int slide, bool dense, bool boundary,
                 int block_windows, Plan* p) {
  p->WB = block_windows > 0 && block_windows < W ? block_windows : W;
  p->n_blocks = (W + p->WB - 1) / p->WB;
  if (p->n_blocks > topsicle::kMaxGridY || (boundary && p->n_blocks > topsicle::kMaxCluster))
    return false;
  p->span = topsicle::block_span(L, W, p->WB, slide, J, k);
  // the table where it leaves room for all windows or a tile of 1,024
  const int Q = J / slide;
  p->use_lut = k <= kLutMaxK;
  p->tile_w = p->use_lut ? tile_windows(p->span, p->WB, k, Q, dense, true, boundary) : 0;
  if (p->tile_w < p->WB && p->tile_w < 1024) {
    p->use_lut = false;
    p->tile_w = tile_windows(p->span, p->WB, k, Q, dense, false, boundary);
  }
  if (p->tile_w < 1) return false;
  p->smem_bytes = layout(p->span, p->WB, k, Q, dense, p->use_lut, p->tile_w, boundary).total;
  return p->smem_bytes <= kSmemLimit;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success), or -2
// when a block does not fit shared memory (ops/geometry.py picks a route
// that fits before the launch, so -2 is a fault of the caller).
template <bool kBoundary>
int launch(const void* packed, int packed_stride, const void* lengths, const void* invalid,
           int invalid_stride, const void* table, int K, int k, int slide, int J, int L,
           int W, int B, int block_windows, void* y_out, const void* n_windows, int jump,
           int min_size, void* t_out, void* has_out, void* stream) {
  const bool dense = invalid != nullptr;
  Plan p;
  if (!plan(L, W, k, J, slide, dense, kBoundary, block_windows, &p)) return -2;
  const cudaError_t opt = topsicle::allow_smem<sum_kernel<kBoundary>>(p.smem_bytes);
  if (opt != cudaSuccess) return static_cast<int>(opt);
  using topsicle::aligned16;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      topsicle::launch_config(B, p.n_blocks, kThreads, p.smem_bytes, kBoundary,
                              static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, sum_kernel<kBoundary>,
      static_cast<const uint8_t*>(packed), packed_stride, aligned16(packed, packed_stride),
      static_cast<const int32_t*>(lengths),
      static_cast<const uint8_t*>(invalid), invalid_stride,
      dense && aligned16(invalid, invalid_stride),
      static_cast<const int32_t*>(table), K, k, slide, J, L, W, p.WB, p.span, p.use_lut,
      p.tile_w, static_cast<int32_t*>(y_out), static_cast<const int32_t*>(n_windows), jump,
      min_size, static_cast<long long*>(t_out), static_cast<uint8_t*>(has_out));
  // read (and so clear) the last error on both paths: a failed launch must
  // not leave it set for the next launch in the process to report
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

// Pointers are device pointers; exactly one of `lengths` (lean wire) and
// `invalid` (dense wire) is non-null.  Needs J >= 1, W >= 1, B >= 1,
// K <= 31, k <= 15, W * slide + J + k < 2^31.  `block_windows`: the windows
// a block serves on the window-block grid; 0 for one block a read.
extern "C" int topsicle_sum_signal(const void* packed, int packed_stride,
                                   const void* lengths,
                                   const void* invalid, int invalid_stride,
                                   const void* table, int K, int k,
                                   int slide, int J, int L, int W, int B,
                                   int block_windows, void* out, void* stream) {
  return launch<false>(packed, packed_stride, lengths, invalid, invalid_stride, table, K, k,
                       slide, J, L, W, B, block_windows, out, nullptr, 0, 0, nullptr, nullptr,
                       stream);
}

// The same, followed in the launch by the changepoint: `n_windows` [B]
// int32, `t_out` [B] int64, `has_out` [B] uint8 (0 or 1).  Needs
// jump >= 1 and min_size >= 1.  `block_windows`: 0 (or W and more) for one
// block a read; fewer for a cluster of ceil(W / block_windows) <= 8 blocks
// a read, each with its window block's slice of y.
extern "C" int topsicle_sum_boundary(const void* packed, int packed_stride,
                                     const void* lengths,
                                     const void* invalid, int invalid_stride,
                                     const void* table, int K, int k,
                                     int slide, int J, int L, int W, int B, int block_windows,
                                     const void* n_windows, int jump, int min_size,
                                     void* t_out, void* has_out, void* stream) {
  return launch<true>(packed, packed_stride, lengths, invalid, invalid_stride, table, K, k,
                      slide, J, L, W, B, block_windows, nullptr, n_windows, jump, min_size,
                      t_out, has_out, stream);
}

// The clusters of a fused launch with this geometry that the card can keep
// resident at once (cudaOccupancyMaxActiveClusters; one block a read: the
// blocks), in *out.  Returns 0, -2 where the launch would, or the CUDA
// error.
extern "C" int topsicle_sum_max_clusters(int L, int W, int k, int J, int slide, int dense,
                                         int block_windows, int* out) {
  Plan p;
  if (!plan(L, W, k, J, slide, dense != 0, true, block_windows, &p)) return -2;
  const cudaError_t opt = topsicle::allow_smem<sum_kernel<true>>(p.smem_bytes);
  if (opt != cudaSuccess) return static_cast<int>(opt);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      topsicle::launch_config(1, p.n_blocks, kThreads, p.smem_bytes, true, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, sum_kernel<true>, &cfg));
}

// What the launcher would do, without launching: out[0..4] = shared-memory
// bytes, windows a block, blocks a read, windows a tile, 1 if the presence
// table is in shared memory.  Returns 0, or -2 where the launch would.
extern "C" int topsicle_sum_plan(int L, int W, int k, int J, int slide, int dense,
                                 int boundary, int block_windows, int* out) {
  Plan p;
  if (!plan(L, W, k, J, slide, dense != 0, boundary != 0, block_windows, &p)) return -2;
  out[0] = p.smem_bytes;
  out[1] = p.WB;
  out[2] = p.n_blocks;
  out[3] = p.tile_w;
  out[4] = p.use_lut;
  return 0;
}

extern "C" const char* topsicle_cuda_error_string(int code) {
  if (code == -2)
    return "the launch does not fit: a block past shared memory, or a fused read past 8 blocks";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
