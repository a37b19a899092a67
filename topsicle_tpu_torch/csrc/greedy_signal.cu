// Step-2 greedy window-count kernel for Hopper (sm_90a).
//
// Replaces: topsicle_tpu/ops/pallas_kernels.py::_signal_kernel (the TPU
// kernel behind step2_signal_pallas and _lean).  Computes, for every read
// b, window w and table entry e, exactly what ops/match.py::window_counts
// computes: the greedy non-overlapping count of entry e over the J
// offsets p = w*slide + j, j < J.  A match at offset j is taken when
// j >= next_free, which then becomes j + k; the chain restarts at every
// window.  This is re.finditer's count, exact for every table: periodic
// entries, duplicate entries (each counted on its own), any K, k <= 15.
//
// Two entry points share one kernel body:
//   topsicle_greedy_signal  y[b, w] = sum_e max(count, 1)   int32 [B, W]
//   topsicle_greedy_counts  count[b, e, w], no floor         int32 [B, K, W]
// The second gives --rawcountpattern/--plot their per-entry counts and,
// with one window covering every offset (W = 1, J = L - k + 1), step 1's
// greedy count per read end.
//
// Input is the PLAIN wire sum_signal.cu reads (no phase-planar layout):
// base 4q+s at bits 2s of byte q (io.batch.pack_codes / pack_batch), plus
// per-read lengths (lean) or an invalid bit-plane (dense).
//
// What bounds it on this card: the sequential carry.  Each (window,
// entry) lane walks its J offsets in order, one shared-memory read, one
// compare and two selects per offset: ~B*W*K*J steps (564 M at B = 128,
// W = 3312, K = 14, J = 95), with no device-memory traffic beyond the
// L/4-byte wire and the output.  The design keeps every intermediate on
// chip: one block per (read, tile of windows) stages the tile's bases in
// shared memory once and writes one int32 rolling code per position there
// (-1 where a base is invalid or past the length); lanes take consecutive
// windows of one entry, so a warp reads positions `slide` words apart and
// writes the counts mode's output coalesced.  The signal mode floors and
// sums the K counts of a window with shared-memory atomics, so only y
// leaves the SM.  (Warp-per-window find-first-set on packed match words,
// or a scan over the periodic entries only, are later work.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kSignal>
__global__ void __launch_bounds__(kThreads)
greedy_kernel(const uint8_t* __restrict__ packed, int packed_stride,
              const int32_t* __restrict__ lengths,
              const uint8_t* __restrict__ invalid, int invalid_stride,
              const int32_t* __restrict__ table, int K, int k,
              int slide, int J, int L, int W, int tile_w,
              int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.y;
  const int w0 = blockIdx.x * tile_w;
  const int n_win = min(tile_w, W - w0);
  const int max_pos = (tile_w - 1) * slide + J;   // positions of a full tile
  const int n_pos = (n_win - 1) * slide + J;      // positions this tile reads
  const int n_base = n_pos + k - 1;
  const int p0 = w0 * slide;

  int32_t* code = reinterpret_cast<int32_t*>(smem);               // [max_pos]
  int32_t* ysum = code + max_pos;                                  // [tile_w]
  uint8_t* base = reinterpret_cast<uint8_t*>(ysum + tile_w);       // [max_pos + k - 1]

  // ---- stage the tile's bases: code 0..3, or 4 for an invalid base ----
  const uint8_t* prow = packed + static_cast<size_t>(b) * packed_stride;
  const int len = lengths != nullptr ? lengths[b] : L;
  const uint8_t* irow =
      invalid != nullptr ? invalid + static_cast<size_t>(b) * invalid_stride : nullptr;
  for (int i = threadIdx.x; i < n_base; i += blockDim.x) {
    const int g = p0 + i;
    uint8_t c = 4;
    if (g < L && g < len) {
      c = (prow[g >> 2] >> ((g & 3) * 2)) & 3;
      if (irow != nullptr && ((irow[g >> 3] >> (g & 7)) & 1)) c = 4;
    }
    base[i] = c;
  }
  if (kSignal) {
    for (int t = threadIdx.x; t < n_win; t += blockDim.x) ysum[t] = 0;
  }
  __syncthreads();

  // ---- per position: base-4 rolling code, -1 if any base is invalid ----
  for (int i = threadIdx.x; i < n_pos; i += blockDim.x) {
    int32_t c = 0;
    uint32_t bad = 0;
    for (int j = 0; j < k; ++j) {
      const uint32_t v = base[i + j];
      bad |= v >> 2;
      c |= static_cast<int32_t>(v & 3) << (2 * j);
    }
    code[i] = bad ? -1 : c;
  }
  __syncthreads();

  // ---- per (window, entry): the greedy walk over the J offsets ----
  for (int idx = threadIdx.x; idx < n_win * K; idx += blockDim.x) {
    const int t = idx % n_win;
    const int e = idx / n_win;
    // valid codes are >= 0 and invalid positions hold -1, so a negative
    // entry (a non-ACGT k-mer) must match neither
    const int32_t te = table[e] >= 0 ? table[e] : -2;
    const int32_t* c = code + t * slide;
    int nf = 0;
    int cnt = 0;
    for (int j = 0; j < J; ++j) {
      const int take = (c[j] == te) & (j >= nf);
      nf = take ? j + k : nf;
      cnt += take;
    }
    if (kSignal) {
      atomicAdd(&ysum[t], max(cnt, 1));
    } else {
      out[(static_cast<size_t>(b) * K + e) * W + w0 + t] = cnt;
    }
  }

  // ---- signal mode: the floored sums leave the SM ----
  if (kSignal) {
    __syncthreads();
    int32_t* orow = out + static_cast<size_t>(b) * W;
    for (int t = threadIdx.x; t < n_win; t += blockDim.x) orow[w0 + t] = ysum[t];
  }
}

template <bool kSignal>
int launch(const void* packed, int packed_stride, const void* lengths,
           const void* invalid, int invalid_stride, const void* table, int K,
           int k, int slide, int J, int L, int W, int B, int tile_w,
           int smem_bytes, void* out, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        greedy_kernel<kSignal>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((W + tile_w - 1) / tile_w, B);
  greedy_kernel<kSignal><<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), packed_stride,
      static_cast<const int32_t*>(lengths),
      static_cast<const uint8_t*>(invalid), invalid_stride,
      static_cast<const int32_t*>(table), K, k, slide, J, L, W, tile_w,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success).
// Pointers are device pointers; exactly one of `lengths` (lean wire) and
// `invalid` (dense wire) is non-null.  `smem_bytes` is the dynamic shared
// memory the caller computed for `tile_w` windows per block.

// y int32 [B, W]: sum over the K entries of max(count, 1).
extern "C" int topsicle_greedy_signal(const void* packed, int packed_stride,
                                      const void* lengths,
                                      const void* invalid, int invalid_stride,
                                      const void* table, int K, int k,
                                      int slide, int J, int L, int W, int B,
                                      int tile_w, int smem_bytes,
                                      void* out, void* stream) {
  return launch<true>(packed, packed_stride, lengths, invalid, invalid_stride,
                      table, K, k, slide, J, L, W, B, tile_w, smem_bytes, out, stream);
}

// counts int32 [B, K, W], no floor.
extern "C" int topsicle_greedy_counts(const void* packed, int packed_stride,
                                      const void* lengths,
                                      const void* invalid, int invalid_stride,
                                      const void* table, int K, int k,
                                      int slide, int J, int L, int W, int B,
                                      int tile_w, int smem_bytes,
                                      void* out, void* stream) {
  return launch<false>(packed, packed_stride, lengths, invalid, invalid_stride,
                       table, K, k, slide, J, L, W, B, tile_w, smem_bytes, out, stream);
}
