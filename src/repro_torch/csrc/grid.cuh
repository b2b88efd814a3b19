// The host's view of the device for a launch: the current device and its
// SM count, the blocks of a kernel one SM holds, and a grid for a
// streaming kernel capped at what the device holds at once.  Shared by
// the kernel sources that size their grids to the device.
#pragma once

#include <cuda_runtime.h>

namespace grid {

constexpr int kMaxDevices = 64;

// The current device and its SM count (looked up once per device).
inline cudaError_t current_device(int* dev, int* sms) {
  static int sms_of[kMaxDevices] = {0};          // 0: not looked up yet
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms_of[*dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[*dev],
                                 cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
  }
  *sms = sms_of[*dev];
  return cudaSuccess;
}

// The blocks of `kernel` that fit on one SM of the current device at
// `threads` threads and `smem` bytes of dynamic shared memory, after
// allowing the kernel `max_smem` bytes (above 48 KB only so).  0 blocks is
// an error: such a launch could never run.
template <typename Kernel>
inline cudaError_t blocks_per_sm(Kernel kernel, int threads, int smem,
                                 int max_smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads,
                                                      smem);
  if (err == cudaSuccess && *blocks <= 0) err = cudaErrorInvalidConfiguration;
  return err;
}

// The grid of a streaming kernel whose work is `want` blocks of `smem`
// bytes of dynamic shared memory each: at most the blocks the device holds
// at once, in as many passes as that takes, the work spread evenly over
// them (4 passes of 2,048 blocks rather than 3.9 of 2,112, whose last pass
// would find 12 % of the blocks idle).
template <typename Kernel>
inline cudaError_t capped_blocks(Kernel kernel, int threads, long long want,
                                 long long* blocks, int smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = current_device(&dev, &sms);
  if (err == cudaSuccess)
    err = blocks_per_sm(kernel, threads, smem, smem, &per_sm);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)sms * per_sm;
  const long long passes = (want + resident - 1) / resident;
  *blocks = passes > 1 ? (want + passes - 1) / passes : want;
  return cudaSuccess;
}

}  // namespace grid
