// Confusion-matrix counts on Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel `confusion_matrix_pallas`
// (torchmetrics_tpu/ops/pallas_kernels.py:70). That kernel builds one-hot tiles of
// the two label vectors in VMEM and contracts them on the MXU into a [C, C] f32
// accumulator carried across a sequential grid. Here the same function,
//     out[t, p] = sum_i valid[i] * [target[i] == t] * [preds[i] == p],
// is a histogram over code = target * C + pred: no one-hot step and no product.
//
// Bound: it reads N * (bytes of a pred + bytes of a target + 1) bytes and writes
// C * C * 4 bytes, so the card's memory rate bounds it: 1.2 us at the ImageNet step
// (N = 500, int64 preds, int32 target, C = 1000), 0.7 us at the binary step
// (N = 262,144, C = 2). What a call costs at those shapes is the host's work to
// enqueue it, so the design's first aim is one device kernel per call and nothing
// else: no cast, no zero fill, no allocation but the output.
//
// Design:
// - The labels are read as they arrive, int32 or int64 each (a template argument per
//   vector), and the mask as the bytes of a bool tensor. An int64 label is taken by
//   its low 32 bits, as JAX (64-bit types off) converts it to int32 on entry; then a
//   label outside [0, C), negative ones included, counts nowhere (the TPU kernel's
//   one-hot rows are all zero there) and is never written.
// - Every cell of `out` is written by the launch; the caller allocates it with
//   torch.empty.
// - C * C within shared memory (C <= 110): blocks count in shared memory. Up to
//   kSingleBlockMax samples one block counts them all and writes every cell itself.
//   Past it one cooperative launch of one 1024-thread block per SM: each block writes
//   its totals into its own slot of a scratch [blocks][C * C] in device memory, the
//   grid synchronises, then each block sums a stripe of bins over all the slots and
//   writes it to `out`. No global atomics, so no block waits on another's updates to
//   the few cache lines of a small matrix, and the scratch needs no zeroing: the
//   wrapper keeps one per (device, stream), sized to the slots of the call.
// - Few bins (C * C * 32 words within 48 KB, C <= 19: the binary step's 4 bins, C = 10's
//   100): each lane of a warp counts into its own copy of the histogram, laid out
//   [bin][lane], so a warp's 32 shared-memory atomics never meet on one address or one
//   bank whatever the labels. More bins: one copy per block.
// - C * C beyond shared memory (C >= 111; C = 1000 is a 4 MB matrix whose write is the
//   whole bound): atomics straight into `out`, which has to be zero before any block
//   counts into it. The kernel is launched cooperatively: every block zeroes its
//   stripe with 16-byte stores, the grid synchronises, then counts. The other design,
//   a cudaMemsetAsync before an ordinary launch, took less time on the card but more
//   per call, since a second device operation costs the host more to enqueue than the
//   grid barrier costs the card; PERF.md section 6 has both designs' times.
// - Counts are int32 and exact, past the f32 kernel's 2^24 per cell.
// - The kernel allocates nothing, launches on the caller's stream and does not
//   synchronise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "device_cache.cuh"

namespace {

constexpr int kThreads = 256;
// the grid of the shared-memory modes: one such block per SM
constexpr int kGridThreads = 1024;
constexpr int kSharedBytes = 48 * 1024;
// the few-bins mode's limit: one [bin][32 lanes] int32 copy within 48 KB
constexpr int kLaneBins = kSharedBytes / (32 * 4);
// the shared-memory modes' limit, and the scratch's slot size in bins
constexpr int kBlockBins = kSharedBytes / 4;
// one block up to this N: 32 samples a thread, a few microseconds
constexpr long long kSingleBlockMax = 8192;
// blocks per SM of the global mode's cooperative launch (fewer if the occupancy query
// allows fewer)
constexpr int kCooperativePerSm = 2;

enum Mode { kPerLane = 0, kPerBlock = 1 };

// The label's low 32 bits as an unsigned: below C exactly when the int32 JAX would
// make of it lies in [0, C).
template <typename T>
__device__ __forceinline__ unsigned low32(const T* __restrict__ a, long long i) {
  return static_cast<unsigned>(__ldg(a + i));
}

// kGrid false: one block counts every sample and writes `out`. kGrid true: launched
// cooperatively; block b writes its totals to slots[b][C * C], the grid synchronises,
// and each block sums its stripe of bins over the slots into `out`.
template <typename TP, typename TT, int kMode, bool kGrid>
__global__ void __launch_bounds__(kGrid ? kGridThreads : kThreads)
    confusion_matrix_shared_kernel(const TP* __restrict__ preds, const TT* __restrict__ target,
                                   const unsigned char* __restrict__ valid, long long n, int num_classes,
                                   int* __restrict__ slots, int* __restrict__ out) {
  extern __shared__ int hist[];
  const int bins = num_classes * num_classes;
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < (kMode == kPerLane ? bins * 32 : bins); j += blockDim.x) hist[j] = 0;
  __syncthreads();

  const unsigned c = static_cast<unsigned>(num_classes);
#pragma unroll 4
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned t = low32(target, i);
    const unsigned p = low32(preds, i);
    if (__ldg(valid + i) && t < c && p < c) {
      const unsigned code = t * c + p;
      atomicAdd(&hist[kMode == kPerLane ? code * 32 + lane : code], 1);
    }
  }
  __syncthreads();

  // this block's totals: `out` itself in one block, else the block's slot
  int* totals = kGrid ? slots + static_cast<long long>(blockIdx.x) * bins : out;
  if (kMode == kPerLane) {  // one warp a bin, its lanes' copies summed by a warp reduction
    for (int b = threadIdx.x >> 5; b < bins; b += blockDim.x >> 5) {
      const int v = __reduce_add_sync(0xffffffffu, hist[b * 32 + lane]);
      if (lane == 0) totals[b] = v;
    }
  } else {
    for (int b = threadIdx.x; b < bins; b += blockDim.x) totals[b] = hist[b];
  }
  if constexpr (kGrid) {
    cooperative_groups::this_grid().sync();  // every slot is written, and hist is free
    const int stripe = (bins + gridDim.x - 1) / gridDim.x;
    const int first = blockIdx.x * stripe;
    const int count = bins - first < stripe ? bins - first : stripe;
    if (count <= 0) return;
    for (int j = threadIdx.x; j < count; j += blockDim.x) hist[j] = 0;
    __syncthreads();
    // (slot, bin) pairs: neighbouring threads read neighbouring bins of one slot
    const int pairs = count * gridDim.x;
    for (int k = threadIdx.x; k < pairs; k += blockDim.x) {
      const int slot = k / count;
      const int v = __ldcg(slots + static_cast<long long>(slot) * bins + first + (k - slot * count));
      if (v) atomicAdd(&hist[k - slot * count], v);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < count; j += blockDim.x) out[first + j] = hist[j];
  }
}

// Launched cooperatively: the grid zeroes `out`, synchronises, then counts into it.
template <typename TP, typename TT>
__global__ void __launch_bounds__(kThreads)
    confusion_matrix_global_kernel(const TP* __restrict__ preds, const TT* __restrict__ target,
                                   const unsigned char* __restrict__ valid, long long n, int num_classes,
                                   int* __restrict__ out) {
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long cells = static_cast<long long>(num_classes) * num_classes;
  // 16-byte stores where `out` allows them (torch's allocator aligns it to 512 bytes)
  const long long quads = reinterpret_cast<std::uintptr_t>(out) % 16 == 0 ? cells / 4 : 0;
  int4* out4 = reinterpret_cast<int4*>(out);
  for (long long j = first; j < quads; j += stride) out4[j] = make_int4(0, 0, 0, 0);
  for (long long j = quads * 4 + first; j < cells; j += stride) out[j] = 0;
  cooperative_groups::this_grid().sync();  // every cell is zero before any is counted
  const unsigned c = static_cast<unsigned>(num_classes);
  for (long long i = first; i < n; i += stride) {
    const unsigned t = low32(target, i);
    const unsigned p = low32(preds, i);
    if (__ldg(valid + i) && t < c && p < c) atomicAdd(out + static_cast<long long>(t) * c + p, 1);
  }
}

// The blocks per SM that a cooperative launch of `kernel` may hold (all resident), at
// most `most`; `cache` keeps the answer per device (0 until queried).
template <typename Kernel>
int cooperative_per_sm(int* cache, Kernel kernel, int threads, int shared, int most) {
  int device = 0;
  cudaGetDevice(&device);
  const bool cached = device >= 0 && device < tmk::kMaxDevices;
  int got = cached ? cache[device] : 0;
  if (got == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got, kernel, threads, shared);
    got = got < most ? got : most;
    if (cached) cache[device] = got;
  }
  return got;
}

template <typename TP, typename TT, int kMode>
cudaError_t launch_shared(const TP* p, const TT* t, const unsigned char* v, long long n, int c, int* slots,
                          long long slots_bytes, int* out, cudaStream_t s) {
  const int shared = c * c * (kMode == kPerLane ? 32 : 1) * static_cast<int>(sizeof(int));
  if (n <= kSingleBlockMax) {
    confusion_matrix_shared_kernel<TP, TT, kMode, false><<<1, kThreads, shared, s>>>(p, t, v, n, c, slots, out);
    return cudaGetLastError();
  }
  const auto kernel = confusion_matrix_shared_kernel<TP, TT, kMode, true>;
  static int per_sm[tmk::kMaxDevices] = {};
  if (cooperative_per_sm(per_sm, kernel, kGridThreads, kSharedBytes, 1) < 1) {
    return cudaErrorCooperativeLaunchTooLarge;
  }
  const long long sms = tmk::sm_count() > 1 ? tmk::sm_count() : 1;
  const long long needed = (n + kGridThreads - 1) / kGridThreads;
  const long long blocks = needed < sms ? needed : sms;
  if (slots == nullptr || slots_bytes < blocks * c * c * static_cast<long long>(sizeof(int))) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned>(blocks)), block(kGridThreads);
  void* args[] = {&p, &t, &v, &n, &c, &slots, &out};
  const cudaError_t err = cudaLaunchCooperativeKernel(kernel, grid, block, args, shared, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TP, typename TT>
cudaError_t launch(const TP* p, const TT* t, const unsigned char* v, long long n, int c, int* slots,
                   long long slots_bytes, int* out, cudaStream_t s) {
  const long long bins = static_cast<long long>(c) * c;
  if (bins <= kLaneBins) return launch_shared<TP, TT, kPerLane>(p, t, v, n, c, slots, slots_bytes, out, s);
  if (bins <= kBlockBins) return launch_shared<TP, TT, kPerBlock>(p, t, v, n, c, slots, slots_bytes, out, s);
  const long long sms = tmk::sm_count() > 1 ? tmk::sm_count() : 1;
  const auto kernel = confusion_matrix_global_kernel<TP, TT>;
  static int cache[tmk::kMaxDevices] = {};
  const int per_sm = cooperative_per_sm(cache, kernel, kThreads, 0, kCooperativePerSm);
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const dim3 grid(static_cast<unsigned>(per_sm * sms)), block(kThreads);
  void* args[] = {&p, &t, &v, &n, &c, &out};
  const cudaError_t err = cudaLaunchCooperativeKernel(kernel, grid, block, args, 0, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TP>
cudaError_t launch_target(const TP* p, const void* target, int target_bytes, const unsigned char* v, long long n,
                          int c, int* slots, long long slots_bytes, int* out, cudaStream_t s) {
  if (target_bytes == 8) {
    return launch(p, static_cast<const long long*>(target), v, n, c, slots, slots_bytes, out, s);
  }
  return launch(p, static_cast<const int*>(target), v, n, c, slots, slots_bytes, out, s);
}

}  // namespace

extern "C" {

// preds, target: int32 or int64 [N] (`*_bytes` 4 or 8); valid: bool [N] as bytes;
// scratch: `scratch_bytes` bytes of any content, used by one stream at a time, at
// least min(ceil(N / 1024), SMs) * C * C * 4 when N > 8192 and C * C <= 12288 (the
// grid's slots), else unused and may be null; out: int32 [C, C], every cell written.
// Returns cudaGetLastError() after the launch.
int tm_confusion_matrix(const void* preds, int preds_bytes, const void* target, int target_bytes,
                        const void* valid, long long n, int num_classes, void* scratch, long long scratch_bytes,
                        void* out, void* stream) {
  if (num_classes <= 0 || n < 0) return 0;
  if ((preds_bytes != 4 && preds_bytes != 8) || (target_bytes != 4 && target_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const unsigned char*>(valid);
  auto* sc = static_cast<int*>(scratch);
  auto* o = static_cast<int*>(out);
  cudaError_t err;
  if (preds_bytes == 8) {
    err = launch_target(static_cast<const long long*>(preds), target, target_bytes, v, n, num_classes, sc,
                        scratch_bytes, o, s);
  } else {
    err = launch_target(static_cast<const int*>(preds), target, target_bytes, v, n, num_classes, sc, scratch_bytes,
                        o, s);
  }
  return static_cast<int>(err);
}

const char* tm_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
