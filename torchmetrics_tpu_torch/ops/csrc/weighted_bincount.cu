// K weighted bincounts of one index vector on Hopper (sm_90a), bound to Python
// through ctypes.
//
// Replaces the TPU kernel `weighted_bincount_pallas`
// (torchmetrics_tpu/ops/pallas_kernels.py:205). That kernel builds a [tile, C]
// one-hot block of the indices in VMEM and contracts it against the K weight rows on
// the MXU into a [K, C] f32 accumulator carried across a sequential grid. Here the
// same function,
//     out[k, c] = sum_i w[k, i] * [x[i] == c],
// is a scatter-add of each sample's K weights into bin x[i]: no one-hot block and no
// product. Calibration error calls it with K = 3 (sum of confidences, sum of
// accuracies, count) and C = n_bins; the masked bincount with K = 1.
//
// Bound: it reads N * (4 + 4K) bytes and writes K * C * 4 bytes, so it is bound by
// the card's memory rate. The adds are one atomic per sample and row.
//
// Design:
// - Sums are float64, in shared memory and in the global scratch, and are rounded to
//   float32 once, by the second kernel. The order in which atomics land changes from
//   run to run; a float64 sum of float32 values is exact while the values span fewer
//   than 53 - 24 - log2(N) binades, and otherwise off by far less than one float32
//   ulp, so the rounded result is the same on the card and on the CPU in practice.
//   The count row (weights 0 or 1) is exact. The tests and chip_smoke.py hold the
//   float rows to the plain version within 1e-6 relative, the count row exactly.
// - Few bins (8 warps * K * C * 8 bytes within 48 KB, e.g. K = 3, C = 15): each warp
//   keeps its own copy of the [K, C] sums in shared memory. With 15 bins every
//   thread of a block would otherwise add into the same 45 addresses; per-warp
//   copies cut that contention eightfold. The block sums its copies and adds its
//   non-zero bins to the global scratch with one atomic each.
// - More bins, up to K * C * 8 bytes = 48 KB (e.g. K = 3, C = 1000): one copy per
//   block in shared memory, flushed the same way.
// - Above that (e.g. C = 8192): atomics straight into the global scratch, where
//   collisions are rare.
// - An index below 0 or at or above C counts nowhere, as it falls outside the TPU
//   kernel's one-hot columns, and is never written.
// - The one-hot contraction multiplies every weight by 0 for the bins its sample is
//   not in, and 0 * NaN and 0 * inf are NaN. So a non-finite weight of row k makes
//   every other bin of row k NaN. The kernel counts non-finite weights per row and
//   per bin, and the second kernel writes NaN into each bin that a non-finite weight
//   of another bin (or of an out-of-range index) reaches.
// - The scratch and counters are allocated and zeroed by the caller; the kernels
//   allocate nothing, launch on the caller's stream and do not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSharedBytes = 48 * 1024;

enum Mode { kPerWarp = 0, kPerBlock = 1, kGlobal = 2 };

// false for NaN and for +-inf
__device__ __forceinline__ bool finite(float v) { return fabsf(v) <= 3.402823466e+38f; }

template <int kMode>
__global__ void weighted_bincount_kernel(const int* __restrict__ x, const float* __restrict__ w,
                                         long long n, int k, int c, double* __restrict__ acc,
                                         int* __restrict__ nonfinite) {
  extern __shared__ double hist[];
  const int kc = k * c;
  double* mine = acc;
  if (kMode != kGlobal) {
    const int copies = kMode == kPerWarp ? kWarps : 1;
    for (int j = threadIdx.x; j < copies * kc; j += blockDim.x) hist[j] = 0.0;
    __syncthreads();
    mine = kMode == kPerWarp ? hist + (threadIdx.x / 32) * kc : hist;
  }
  const unsigned bins = static_cast<unsigned>(c);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned b = static_cast<unsigned>(x[i]);
    const bool in_range = b < bins;
    for (int r = 0; r < k; ++r) {
      const float v = w[r * n + i];
      if (in_range) atomicAdd(&mine[r * c + b], static_cast<double>(v));
      if (!finite(v)) {
        atomicAdd(&nonfinite[r], 1);
        if (in_range) atomicAdd(&nonfinite[k + r * c + b], 1);
      }
    }
  }
  if (kMode != kGlobal) {
    __syncthreads();
    for (int j = threadIdx.x; j < kc; j += blockDim.x) {
      double s = hist[j];
      if (kMode == kPerWarp) {
        for (int copy = 1; copy < kWarps; ++copy) s += hist[copy * kc + j];
      }
      if (s != 0.0) atomicAdd(&acc[j], s);  // NaN != 0.0, so a NaN sum is flushed
    }
  }
}

// out[k, c] = acc[k, c] rounded to float32, or NaN where a non-finite weight of row k
// lies outside bin c.
__global__ void weighted_bincount_finish_kernel(const double* __restrict__ acc,
                                                const int* __restrict__ nonfinite, int k, int c,
                                                float* __restrict__ out) {
  const long long kc = static_cast<long long>(k) * c;
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; j < kc;
       j += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(j / c);
    const bool poisoned = nonfinite[r] > nonfinite[k + j];
    out[j] = poisoned ? nanf("") : static_cast<float>(acc[j]);
  }
}

}  // namespace

extern "C" {

// x: int32 [N]; w: float32 [K, N] row-major; acc: float64 [K, C] and nonfinite: int32
// [K + K * C], both zeroed by the caller; out: float32 [K, C].
// Returns cudaGetLastError() after the launches.
int tm_weighted_bincount(const void* x, const void* w, long long n, int k, int c, void* acc,
                         void* nonfinite, void* out, void* stream) {
  if (n <= 0 || k <= 0 || c <= 0) return 0;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const int*>(x);
  const auto* wf = static_cast<const float*>(w);
  auto* a = static_cast<double*>(acc);
  auto* nf = static_cast<int*>(nonfinite);
  const long long needed = (n + kThreads - 1) / kThreads;
  const long long kc = static_cast<long long>(k) * c;
  const long long bytes = kc * static_cast<long long>(sizeof(double));
  if (bytes * kWarps <= kSharedBytes) {
    // few blocks: each one pays a flush of K * C bins
    const int blocks = static_cast<int>(needed < 2LL * sms ? needed : 2LL * sms);
    weighted_bincount_kernel<kPerWarp><<<blocks, kThreads, bytes * kWarps, s>>>(xi, wf, n, k, c, a, nf);
  } else if (bytes <= kSharedBytes) {
    const int blocks = static_cast<int>(needed < 2LL * sms ? needed : 2LL * sms);
    weighted_bincount_kernel<kPerBlock><<<blocks, kThreads, bytes, s>>>(xi, wf, n, k, c, a, nf);
  } else {
    const int blocks = static_cast<int>(needed < 8LL * sms ? needed : 8LL * sms);
    weighted_bincount_kernel<kGlobal><<<blocks, kThreads, 0, s>>>(xi, wf, n, k, c, a, nf);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long finish_needed = (kc + kThreads - 1) / kThreads;
  const int finish_blocks = static_cast<int>(finish_needed < 4LL * sms ? finish_needed : 4LL * sms);
  weighted_bincount_finish_kernel<<<finish_blocks, kThreads, 0, s>>>(a, nf, k, c, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* tm_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
