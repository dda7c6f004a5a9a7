// Per-threshold tp/fp counts of the binned curve family on Hopper (sm_90a),
// bound to Python through ctypes.
//
// Replaces the TPU kernel `binned_curve_counts_pallas`
// (torchmetrics_tpu/ops/pallas_kernels.py:140), which compares a [T, tile] block of
// scores against the thresholds in VMEM and reduces it on the MXU into a [T, 2] f32
// accumulator carried across a sequential grid. The function is
//     tp[t] = sum_i valid[i] * (label[i] != 0) * [score[i] >= thr[t]]
//     fp[t] = sum_i valid[i] * (label[i] == 0) * [score[i] >= thr[t]]
// over thresholds in any order (a user's list is not sorted), so the kernel keeps the
// O(N * T) compare.
//
// Bound: 2 * N * T simple operations (a compare and an add per pair); against the
// card's FP32 rate it is bound by operations, not by the N * 9 bytes it reads.
//
// Design:
// - Each block owns a strided set of sample tiles. It stages a tile of scores and a
//   packed pos/neg flag per sample (bit 0 positive, bit 1 negative, 0 for invalid)
//   in shared memory, and the current chunk of thresholds beside it.
// - Thresholds go in chunks of up to kThreads; each thread owns one threshold of the
//   chunk and one of kThreads / chunk lanes over the tile's samples, and counts tp
//   and fp in int32 registers with no branch.
// - After its last tile a thread adds its two counts to the global int32 [T, 2] with
//   atomicAdd: blocks run in parallel, and the atomics are where partial sums meet.
// - `>=` ties are exact; a NaN score compares false and counts nowhere, as in the
//   TPU kernel.
// - The output is allocated and zeroed by the caller; the kernel allocates nothing,
//   launches on the caller's stream and does not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void binned_curve_counts_kernel(const float* __restrict__ scores,
                                           const int* __restrict__ labels,
                                           const unsigned char* __restrict__ valid,
                                           long long n, const float* __restrict__ thresholds,
                                           int num_thresholds, int* __restrict__ out) {
  __shared__ float s_score[kTile];
  __shared__ unsigned char s_flag[kTile];
  __shared__ float s_thr[kThreads];
  const long long tiles = (n + kTile - 1) / kTile;

  for (int t0 = 0; t0 < num_thresholds; t0 += kThreads) {
    const int chunk = min(kThreads, num_thresholds - t0);
    const int lanes = kThreads / chunk;
    const int j = threadIdx.x % chunk;
    const int lane = threadIdx.x / chunk;
    const bool active = lane < lanes;

    __syncthreads();  // the previous chunk is done with s_thr
    if (threadIdx.x < chunk) s_thr[threadIdx.x] = thresholds[t0 + threadIdx.x];
    __syncthreads();
    const float thr = s_thr[j];

    int tp = 0, fp = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const long long base = tile * kTile;
      const int len = static_cast<int>(n - base < kTile ? n - base : kTile);
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < len; i += kThreads) {
        const long long g = base + i;
        s_score[i] = scores[g];
        s_flag[i] = valid[g] ? (labels[g] != 0 ? 1 : 2) : 0;
      }
      __syncthreads();
      if (active) {
        for (int i = lane; i < len; i += lanes) {
          const int ge = s_score[i] >= thr;
          const int f = s_flag[i];
          tp += ge & f;
          fp += ge & (f >> 1);
        }
      }
    }
    if (active) {
      if (tp) atomicAdd(&out[2 * (t0 + j)], tp);
      if (fp) atomicAdd(&out[2 * (t0 + j) + 1], fp);
    }
  }
}

}  // namespace

extern "C" {

// out: int32 [T, 2] (tp, fp), zeroed by the caller. Returns cudaGetLastError() after the launch.
int tm_binned_curve_counts(const void* scores, const void* labels, const void* valid, long long n,
                           const void* thresholds, int num_thresholds, void* out, void* stream) {
  if (n <= 0 || num_thresholds <= 0) return 0;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long tiles = (n + kTile - 1) / kTile;
  const int blocks = static_cast<int>(tiles < 4LL * sms ? tiles : 4LL * sms);
  binned_curve_counts_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const int*>(labels),
      static_cast<const unsigned char*>(valid), n, static_cast<const float*>(thresholds),
      num_thresholds, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* tm_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
