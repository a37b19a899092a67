// The exact changepoint alone, for a window signal that is already in
// device memory: one thread block per read runs csrc/binseg.cuh on its row
// of y [B, W] int32.  The greedy step-2 kernel (greedy_signal.cu) is
// followed by it; the sum kernel has the same device function fused
// behind it (sum_signal.cu) and does not come here.
//
// Replaces: topsicle_tpu/ops/changepoint.py::binseg_l2_device, the XLA
// program behind the TPU kernels (see binseg.cuh for what it computes).
//
// What bounds it: at the step-2 shape (B = 128, W = 3,312) the bytes, 1.7
// MB of y read once (0.51 us at 3.35 TB/s), against ~4 operations a
// window and ~40 a candidate (0.04 M a read).  Each thread reads a
// contiguous chunk of its row twice; the second read comes from L1/L2.
// Any W is served: nothing is staged, so a row longer than shared memory
// (the reference's two-limb range, W > 131,071) streams through.

#include <cstdint>
#include <cuda_runtime.h>

#include "binseg.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
binseg_kernel(const int32_t* __restrict__ y, int W, const int32_t* __restrict__ n_windows,
              int jump, int min_size, long long* __restrict__ t_out,
              uint8_t* __restrict__ has_out) {
  __shared__ topsicle::BinsegScratch scratch;
  const int b = blockIdx.x;
  topsicle::binseg_block<kThreads>(y + static_cast<size_t>(b) * W, W,
                                   static_cast<long long>(n_windows[b]), jump, min_size,
                                   scratch, t_out + b, has_out + b);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// y [B, W] int32, n_windows [B] int32, t_out [B] int64, has_out [B] uint8
// (0 or 1), all device pointers.  Needs B >= 1, W >= 1, jump >= 1 and
// min_size >= 1.
extern "C" int topsicle_binseg_l2(const void* y, int W, int B, const void* n_windows,
                                  int jump, int min_size, void* t_out, void* has_out,
                                  void* stream) {
  binseg_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(y), W, static_cast<const int32_t*>(n_windows), jump,
      min_size, static_cast<long long*>(t_out), static_cast<uint8_t*>(has_out));
  return static_cast<int>(cudaGetLastError());
}
