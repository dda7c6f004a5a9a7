// Confusion-matrix counts on Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel `confusion_matrix_pallas`
// (torchmetrics_tpu/ops/pallas_kernels.py:70). That kernel builds one-hot tiles of
// the two label vectors in VMEM and contracts them on the MXU into a [C, C] f32
// accumulator carried across a sequential grid. Here the same function,
//     out[t, p] = sum_i valid[i] * [target[i] == t] * [preds[i] == p],
// is a histogram over code = target * C + pred: no one-hot step and no product.
//
// Bound: it reads N * (4 + 4 + 1) bytes and writes C * C * 4 bytes, so it is bound
// by the card's memory rate; the counting itself is one atomic per valid sample.
//
// Design:
// - Threads stride over N. A sample that is invalid, or whose target or pred lies
//   outside [0, C), negative ones included, counts nowhere (the TPU kernel's one-hot
//   rows are all zero there) and is never written.
// - Small C (C * C int32 fits in 48 KB of shared memory): each block keeps a private
//   shared-memory histogram and flushes its non-zero bins with one global atomicAdd
//   each. Blocks run in parallel in no order; the atomics are where their partial
//   sums meet (the TPU kernel carried one sum from grid step to grid step instead).
// - Larger C (the 1000-class case is a 4 MB matrix): atomicAdd straight into the
//   global [C, C] output; with many bins the atomics rarely collide.
// - Counts are int32 and exact, past the f32 kernel's 2^24 per cell.
// - The output is allocated and zeroed by the caller; the kernel allocates nothing,
//   launches on the caller's stream and does not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBins = 48 * 1024 / 4;

__global__ void confusion_matrix_shared_kernel(const int* __restrict__ preds,
                                               const int* __restrict__ target,
                                               const unsigned char* __restrict__ valid,
                                               long long n, int num_classes,
                                               int* __restrict__ out) {
  extern __shared__ int hist[];
  const int bins = num_classes * num_classes;
  for (int b = threadIdx.x; b < bins; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const unsigned c = static_cast<unsigned>(num_classes);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned t = static_cast<unsigned>(target[i]);
    const unsigned p = static_cast<unsigned>(preds[i]);
    if (valid[i] && t < c && p < c) atomicAdd(&hist[t * c + p], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    const int v = hist[b];
    if (v) atomicAdd(&out[b], v);
  }
}

__global__ void confusion_matrix_global_kernel(const int* __restrict__ preds,
                                               const int* __restrict__ target,
                                               const unsigned char* __restrict__ valid,
                                               long long n, int num_classes,
                                               int* __restrict__ out) {
  const unsigned c = static_cast<unsigned>(num_classes);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned t = static_cast<unsigned>(target[i]);
    const unsigned p = static_cast<unsigned>(preds[i]);
    if (valid[i] && t < c && p < c) atomicAdd(&out[static_cast<long long>(t) * c + p], 1);
  }
}

}  // namespace

extern "C" {

// out: int32 [C, C], zeroed by the caller. Returns cudaGetLastError() after the launch.
int tm_confusion_matrix(const void* preds, const void* target, const void* valid, long long n,
                        int num_classes, void* out, void* stream) {
  if (n <= 0) return 0;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long needed = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const int*>(preds);
  const auto* t = static_cast<const int*>(target);
  const auto* v = static_cast<const unsigned char*>(valid);
  auto* o = static_cast<int*>(out);
  const long long bins = static_cast<long long>(num_classes) * num_classes;
  if (bins <= kSharedBins) {
    // few blocks: each one pays a flush of up to C*C bins
    const int blocks = static_cast<int>(needed < 2LL * sms ? needed : 2LL * sms);
    confusion_matrix_shared_kernel<<<blocks, kThreads, bins * sizeof(int), s>>>(p, t, v, n, num_classes, o);
  } else {
    const int blocks = static_cast<int>(needed < 8LL * sms ? needed : 8LL * sms);
    confusion_matrix_global_kernel<<<blocks, kThreads, 0, s>>>(p, t, v, n, num_classes, o);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tm_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
