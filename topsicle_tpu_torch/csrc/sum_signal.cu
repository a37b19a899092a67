// Step-2 sum-signal kernel for Hopper (sm_90a).
//
// Replaces: topsicle_tpu/ops/pallas_kernels.py::_sum_signal_kernel (the
// TPU kernel behind step2_sum_signal_pallas and _lean).  Computes, for
// every read b and window w, exactly what ops/match.py::boundary_sum_signal
// computes:
//
//   y[b, w] = sum_{j<J} tot[w*slide + j] + K - popcount(OR_{j<J} word[w*slide + j])
//
// with J = window_size - k, tot[p] the number of table entries equal to the
// base-4 rolling code at position p (duplicate entries each count), and
// word[p] the presence bits of those entries.  Exact for every table the
// caller hands it (K <= 31, k <= 15); that the sum equals the greedy
// non-overlapping count needs an aperiodic table, which the model checks.
//
// Input is the PLAIN wire the engine already packs (no phase-planar
// layout): base 4q+s sits at bits 2s of byte q (io.batch.pack_codes /
// pack_batch), plus either per-read lengths (lean) or an invalid bit-plane
// whose bit s of byte q marks position 8q+s (dense).
//
// What bounds it on this card: not device memory.  The wire is L/4 bytes
// per read (5 KB at L = 19968) against ~(k + 2K) integer ops per position
// and ~3J shared-memory reads per window, so it is bound by integer issue
// and shared-memory bandwidth.  The design keeps every intermediate on
// chip: one block per (read, tile of windows) stages the tile's bases in
// shared memory once, writes one uint32 presence word and one uint8 total
// per position there, and each thread then reduces one window over its J
// positions.  Neither the codes nor the [positions] planes touch device
// memory; only y leaves the SM.  (Prefix sums for the total and fusing the
// changepoint so only (t, has) leave the SM are later work.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxEntries = 31;

__global__ void __launch_bounds__(kThreads)
sum_signal_kernel(const uint8_t* __restrict__ packed, int packed_stride,
                  const int32_t* __restrict__ lengths,
                  const uint8_t* __restrict__ invalid, int invalid_stride,
                  const int32_t* __restrict__ table, int K, int k,
                  int slide, int J, int L, int W, int tile_w,
                  int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t tab[kMaxEntries];

  const int b = blockIdx.y;
  const int w0 = blockIdx.x * tile_w;
  const int n_win = min(tile_w, W - w0);
  const int max_pos = (tile_w - 1) * slide + J;   // positions of a full tile
  const int n_pos = (n_win - 1) * slide + J;      // positions this tile reads
  const int n_base = n_pos + k - 1;
  const int p0 = w0 * slide;

  uint32_t* word = reinterpret_cast<uint32_t*>(smem);       // [max_pos]
  uint8_t* tot = smem + 4 * max_pos;                         // [max_pos]
  uint8_t* base = tot + max_pos;                             // [max_pos + k - 1]

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
  if (threadIdx.x < K) tab[threadIdx.x] = table[threadIdx.x];
  __syncthreads();

  // ---- per position: rolling code, total matches, presence word ----
  for (int i = threadIdx.x; i < n_pos; i += blockDim.x) {
    int32_t code = 0;
    uint32_t bad = 0;
    for (int j = 0; j < k; ++j) {
      const uint32_t c = base[i + j];
      bad |= c >> 2;
      code |= static_cast<int32_t>(c & 3) << (2 * j);
    }
    uint32_t wd = 0;
    uint32_t cnt = 0;
    if (!bad) {
      for (int e = 0; e < K; ++e) {
        const uint32_t eq = code == tab[e];
        cnt += eq;
        wd |= eq << e;
      }
    }
    word[i] = wd;
    tot[i] = static_cast<uint8_t>(cnt);
  }
  __syncthreads();

  // ---- per window: sum of totals, OR of words, popcount ----
  const uint32_t mask = (1u << K) - 1u;
  int32_t* orow = out + static_cast<size_t>(b) * W;
  for (int t = threadIdx.x; t < n_win; t += blockDim.x) {
    const int s0 = t * slide;
    int32_t s = 0;
    uint32_t o = 0;
    for (int j = 0; j < J; ++j) {
      s += tot[s0 + j];
      o |= word[s0 + j];
    }
    orow[w0 + t] = s + K - __popc(o & mask);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers; exactly one of `lengths` (lean wire) and
// `invalid` (dense wire) is non-null.  `smem_bytes` is the dynamic shared
// memory the caller computed for `tile_w` windows per block.
extern "C" int topsicle_sum_signal(const void* packed, int packed_stride,
                                   const void* lengths,
                                   const void* invalid, int invalid_stride,
                                   const void* table, int K, int k,
                                   int slide, int J, int L, int W, int B,
                                   int tile_w, int smem_bytes,
                                   void* out, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sum_signal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((W + tile_w - 1) / tile_w, B);
  sum_signal_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), packed_stride,
      static_cast<const int32_t*>(lengths),
      static_cast<const uint8_t*>(invalid), invalid_stride,
      static_cast<const int32_t*>(table), K, k, slide, J, L, W, tile_w,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* topsicle_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
