// Unweighted bincount on Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel `bincount_pallas` (torchmetrics_tpu/ops/pallas_kernels.py:267)
// in its `valid=None` form, which streams only the [N] indices from HBM, builds a
// [tile, C] one-hot block in VMEM and contracts it with a ones row on the MXU into a
// [1, C] f32 accumulator carried across a sequential grid. Here the same function,
//     out[c] = #{i : x[i] == c},
// is an int32 histogram of the indices. (The masked form, `valid` given, is the K = 1
// case of weighted_bincount.cu, as on the TPU.)
//
// Bound: it reads N * 4 bytes and writes C * 4 bytes, so it is bound by the card's
// memory rate; the counting is one atomic per sample.
//
// Design:
// - C * 4 bytes within 48 KB (C <= 12288; the retrieval grouping's 6,980 queries,
//   27 KB): each block keeps a private shared-memory histogram, adds into it with
//   shared-memory atomics, and adds its non-zero bins to the global output with one
//   atomicAdd each.
// - Larger C: atomicAdd straight into the global output, where collisions are rare.
// - An index below 0 or at or above C counts nowhere, as it falls outside the TPU
//   kernel's one-hot columns.
// - Counts are int32 and exact, past the f32 kernel's 2^24 per bin.
// - The output is allocated and zeroed by the caller; the kernel allocates nothing,
//   launches on the caller's stream and does not synchronise.

#include <cuda_runtime.h>

#include "device_cache.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBins = 48 * 1024 / 4;

__global__ void bincount_shared_kernel(const int* __restrict__ x, long long n, int c, int* __restrict__ out) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < c; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const unsigned bins = static_cast<unsigned>(c);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned b = static_cast<unsigned>(x[i]);
    if (b < bins) atomicAdd(&hist[b], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < c; b += blockDim.x) {
    const int v = hist[b];
    if (v) atomicAdd(&out[b], v);
  }
}

__global__ void bincount_global_kernel(const int* __restrict__ x, long long n, int c, int* __restrict__ out) {
  const unsigned bins = static_cast<unsigned>(c);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned b = static_cast<unsigned>(x[i]);
    if (b < bins) atomicAdd(&out[b], 1);
  }
}

}  // namespace

extern "C" {

// x: int32 [N]; out: int32 [C], zeroed by the caller. Returns cudaGetLastError() after
// the launch.
int tm_bincount(const void* x, long long n, int c, void* out, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  const int sms = tmk::sm_count();
  const long long needed = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const int*>(x);
  auto* o = static_cast<int*>(out);
  if (c <= kSharedBins) {
    // few blocks: each one pays a flush of up to C bins
    const int blocks = static_cast<int>(needed < 2LL * sms ? needed : 2LL * sms);
    bincount_shared_kernel<<<blocks, kThreads, c * sizeof(int), s>>>(xi, n, c, o);
  } else {
    const int blocks = static_cast<int>(needed < 8LL * sms ? needed : 8LL * sms);
    bincount_global_kernel<<<blocks, kThreads, 0, s>>>(xi, n, c, o);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tm_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
