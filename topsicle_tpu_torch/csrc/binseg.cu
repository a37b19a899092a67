// The exact changepoint alone, for a window signal that is already in
// device memory: y [B, W] int32, each row cut into tiles of consecutive
// windows, one thread block a tile (csrc/binseg.cuh's tile functions).
// The signal kernels on their own (sum_signal, greedy_signal) are followed
// by it; the fused entries (sum_boundary, greedy_boundary) run binseg.cuh's
// slice_changepoint, the same slice functions, on y in their own shared
// memory (one block a read, or a cluster of blocks) and do not come here.
//
// Replaces: topsicle_tpu/ops/changepoint.py::binseg_l2_device (:124), the
// XLA program behind the TPU kernels (see binseg.cuh for what it
// computes).
//
// What bounds it: bytes.  y is read once at the least: 1.7 MB at the
// step-2 shape y [128, 3,312] (0.51 us at 3.35 TB/s) and 2.8 MB behind a
// megabase scan, y [4, 174,747] (0.83 us), against ~2 operations a window
// and ~40 a candidate.  One block a row walking contiguous chunks left
// both far away: 4 blocks on 132 SMs for the long rows, and lanes 2.7 KB
// apart, so no load was coalesced.  Here a row of W windows is
// ceil(W / tile) blocks, and every block copies its tile with 16-byte
// loads, neighbouring threads on neighbouring addresses (a row starts at
// b * W * 4 bytes, any residue of 16: the words before the first
// 16-byte boundary and after the last whole vector are loaded alone).  A
// row of one tile is one launch; several are two: pass 1 writes the tile
// sums, pass 2 reads y again (from L2), scans and reduces, the last block
// of a row taking the row's answer.  ops/geometry.py::binseg_tiles picks
// the tile; the wrapper allocates the scratch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "binseg.cuh"

namespace {

constexpr int kThreads = 256;

// A launch's block i is tile i % n_tiles of row i / n_tiles.
__global__ void __launch_bounds__(kThreads)
tile_sum_kernel(const int32_t* __restrict__ y, int W, const int32_t* __restrict__ n_windows,
                int tw, int n_tiles, long long* __restrict__ tile_sums,
                long long* __restrict__ upto_n, unsigned long long* __restrict__ tickets) {
  __shared__ topsicle::TileScratch sc;
  const int b = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - b * n_tiles;
  if (tile == 0 && threadIdx.x == 0) tickets[b] = 0;
  topsicle::tile_sum_block<kThreads>(y + static_cast<size_t>(b) * W, W,
                                     static_cast<long long>(n_windows[b]), tile, tw, sc,
                                     tile_sums + static_cast<size_t>(b) * n_tiles + tile,
                                     upto_n + b);
}

__global__ void __launch_bounds__(kThreads)
tile_best_kernel(const int32_t* __restrict__ y, int W, const int32_t* __restrict__ n_windows,
                 int jump, int min_size, int tw, int n_tiles,
                 const long long* __restrict__ tile_sums, const long long* __restrict__ upto_n,
                 long long* cands, unsigned long long* tickets, long long* __restrict__ t_out,
                 uint8_t* __restrict__ has_out) {
  extern __shared__ int32_t tile_s[];
  __shared__ topsicle::TileScratch sc;
  const int b = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - b * n_tiles;
  const size_t row = static_cast<size_t>(b) * n_tiles;
  const bool several = n_tiles > 1;
  topsicle::tile_best_block<kThreads>(
      y + static_cast<size_t>(b) * W, W, static_cast<long long>(n_windows[b]), jump, min_size,
      tile, n_tiles, tw, several ? tile_sums + row : nullptr, several ? upto_n + b : nullptr,
      several ? cands + 3 * row : nullptr, several ? tickets + b : nullptr, tile_s, sc,
      t_out + b, has_out + b);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// -2 where the tiles do not fit: n_tiles != ceil(W / tile_windows), a tile
// past kMaxTileWindows, or B * n_tiles blocks past a launch's grid.
// y [B, W] int32, n_windows [B] int32, t_out [B] int64, has_out [B] uint8
// (0 or 1), all device pointers.  With n_tiles > 1, scratch is B *
// (4 * n_tiles + 2) int64 of device memory (tile sums, the bests' (|A|,
// D, t), partial sums, tickets), written before it is read by the launch
// alone (pass 1 zeroes the tickets); with one tile it is not read.  Needs B >= 1, W >= 1, jump >= 1 and
// min_size >= 1.
extern "C" int topsicle_binseg_l2(const void* y, int W, int B, const void* n_windows,
                                  int jump, int min_size, int tile_windows, int n_tiles,
                                  void* scratch, void* t_out, void* has_out, void* stream) {
  if (tile_windows < 1 || n_tiles != (W - 1) / tile_windows + 1) return -2;
  const int tw = tile_windows < W ? tile_windows : W;
  if (tw > topsicle::kMaxTileWindows || static_cast<long long>(B) * n_tiles > INT_MAX) {
    return -2;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* yy = static_cast<const int32_t*>(y);
  const int32_t* nw = static_cast<const int32_t*>(n_windows);
  long long* tile_sums = static_cast<long long*>(scratch);
  long long* cands = tile_sums + static_cast<size_t>(B) * n_tiles;
  long long* upto_n = cands + 3 * static_cast<size_t>(B) * n_tiles;
  unsigned long long* tickets = reinterpret_cast<unsigned long long*>(upto_n + B);
  const unsigned blocks = static_cast<unsigned>(B) * static_cast<unsigned>(n_tiles);
  if (n_tiles > 1) {
    tile_sum_kernel<<<blocks, kThreads, 0, s>>>(yy, W, nw, tw, n_tiles, tile_sums, upto_n,
                                                tickets);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  tile_best_kernel<<<blocks, kThreads, topsicle::tile_smem_bytes(tw), s>>>(
      yy, W, nw, jump, min_size, tw, n_tiles, tile_sums, upto_n, cands, tickets,
      static_cast<long long*>(t_out), static_cast<uint8_t*>(has_out));
  return static_cast<int>(cudaGetLastError());
}
