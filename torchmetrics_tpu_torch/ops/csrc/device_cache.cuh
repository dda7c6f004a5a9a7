// Per-device facts that the kernels' C entry points need on every call, queried once.
//
// cudaDeviceGetAttribute costs a runtime call; the histogram kernels size their grids by
// the SM count on every launch, so each library keeps the count of each device it has
// seen. A race between two host threads writes the same value twice.

#pragma once

#include <cuda_runtime.h>

namespace tmk {

constexpr int kMaxDevices = 64;

// The number of SMs of the current device (0 if it cannot be read).
inline int sm_count() {
  static int counts[kMaxDevices] = {};
  int device = 0;
  cudaGetDevice(&device);
  if (device < 0 || device >= kMaxDevices) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    return sms;
  }
  if (counts[device] == 0) cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device);
  return counts[device];
}

}  // namespace tmk
