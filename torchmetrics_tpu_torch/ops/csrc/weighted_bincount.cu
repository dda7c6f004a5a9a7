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
// Bound: it reads N * (4 + 4K) bytes and writes K * C * 4 bytes, so the card's memory
// rate bounds it; at the ImageNet step (N = 500, K = 3, C = 15) that is 2.4 ns, and
// what a call costs is the host's work to enqueue it. So the design's first aim is one
// device kernel per call and nothing else: no zero fill, no finish kernel, no
// allocation but the output.
//
// Design:
// - One launch. A single block takes N up to kSingleBlockMax: it sums in shared
//   memory, tracks the non-finite weights in shared memory, and writes the float32
//   output itself; it touches no global scratch.
// - Larger N: a grid of blocks, merged in the same launch by a last-block ticket
//   (option (a) of a cooperative launch or a ticket: a cooperative launch would need
//   every block resident and a grid-wide barrier per call, and still a fill of its
//   scratch; the ticket needs neither). Each block flushes its shared sums into a
//   float64 scratch in device memory with atomics, makes them visible
//   (__threadfence), and takes a ticket; the block that draws the last ticket rounds
//   the scratch into `out` and zeroes the scratch, the trackers and the ticket for the
//   next call. The wrapper allocates and zeroes that scratch once per (device, stream)
//   and keeps it: calls on one stream run one after another, so they share it safely;
//   calls on two streams get two scratches. A kernel that faults mid-call leaves its
//   scratch dirty, but a CUDA fault also poisons the context: every later call on it
//   fails, so no later result reads the dirty scratch.
// - Scatter modes, by what fits in shared memory: few bins (8 warps * K * C * 8 bytes
//   within 48 KB, e.g. K = 3, C = 15) give each warp its own copy of the [K, C] sums,
//   which cuts the contention of 256 threads on 45 addresses eightfold; more bins (K *
//   C * 8 bytes within 48 KB, e.g. K = 3, C = 1000) one copy per block; up to 226 KB
//   (e.g. K = 3, C = 8192) one copy per 1024-thread block, one block per SM, whose
//   flush adds neighbouring bins from neighbouring threads (random float64 atomics into
//   device memory, one per sample and row, took 0.0767 ms there at N = 2^20 against
//   0.0664 ms for the library's float32 index_add_, H100 80GB HBM3 at 700 W); above that
//   (e.g. C = 65536) atomics straight into the float64 scratch, where collisions are
//   rare.
// - Sums are float64 and are rounded to float32 once. The order in which atomics land
//   changes from run to run; a float64 sum of float32 values is exact while the values
//   span fewer than 53 - 24 - log2(N) binades, and otherwise off by far less than one
//   float32 ulp, so the rounded result is the same on the card and on the CPU in
//   practice. The count row (weights 0 or 1) is exact. The tests and chip_smoke.py
//   hold the float rows to the plain version within 1e-6 relative, the count row
//   exactly.
// - An index below 0 or at or above C counts nowhere, as it falls outside the TPU
//   kernel's one-hot columns, and is never written.
// - The one-hot contraction multiplies every weight by 0 for the bins its sample is
//   not in, and 0 * NaN and 0 * inf are NaN. So a non-finite weight of row k makes
//   every other bin of row k NaN. Per row the kernel records where its non-finite
//   weights went: `where[k]` is 0 for none, b + 1 for bin b (C + 1 outside [0, C)), and
//   `mixed[k]` is set once two of them went to different places. Bin c of row k is NaN
//   unless the row has none, or all of them went to c (where its own sum is already
//   inf or NaN, as in the contraction).
// - The kernel launches on the caller's stream and does not synchronise.

#include <cuda_runtime.h>

#include "device_cache.cuh"

namespace {

constexpr int kThreads = 256;
// blocks of the modes whose sums outgrow 48 KB of shared memory: one such block fills an
// SM, and the block that draws the last ticket rounds all K * C bins alone
constexpr int kWideThreads = 1024;
constexpr int kSharedBytes = 48 * 1024;
// the most dynamic shared memory a block opts into (227 KB, less room for the static part)
constexpr int kMaxSharedBytes = 227 * 1024 - 1024;
// One block up to this N. At the ImageNet step (N = 500) the call is host-bound
// whatever the device does; 8192 samples are 32 per thread, a few microseconds.
constexpr long long kSingleBlockMax = 8192;

enum Mode { kPerWarp = 0, kPerBlock = 1, kGlobal = 2 };

// false for NaN and for +-inf
__device__ __forceinline__ bool finite(float v) { return fabsf(v) <= 3.402823466e+38f; }

// Record a non-finite weight of one row that went to `code` (bin + 1, or C + 1).
__device__ __forceinline__ void note_nonfinite(int* where, int* mixed, int code) {
  const int old = atomicCAS(where, 0, code);
  if (old != 0 && old != code) atomicExch(mixed, 1);
}

__device__ __forceinline__ float finish(double sum, int where, int mixed, int bin) {
  const bool poisoned = where != 0 && (mixed != 0 || where != bin + 1);
  return poisoned ? __int_as_float(0x7fc00000) : static_cast<float>(sum);
}

// scratch: float64 acc [K * C], then int32 where [K], mixed [K], then the uint32 ticket;
// all zero between calls. Unused by a single-block launch in a shared-memory mode.
template <int kMode, int kBlock>
__global__ void __launch_bounds__(kBlock)
    weighted_bincount_kernel(const int* __restrict__ x, const float* __restrict__ w, long long n, int k,
                             int c, double* __restrict__ acc, int* __restrict__ track,
                             unsigned* __restrict__ ticket, float* __restrict__ out) {
  extern __shared__ double smem[];
  __shared__ bool last;
  const int kc = k * c;
  constexpr int kWarps = kBlock / 32;
  const int copies = kMode == kPerWarp ? kWarps : (kMode == kPerBlock ? 1 : 0);
  double* hist = smem;
  int* s_trk = reinterpret_cast<int*>(smem + copies * kc);  // the trackers, [2K]
  const bool single = gridDim.x == 1;
  int* trk = single ? s_trk : track;
  for (int j = threadIdx.x; j < copies * kc; j += blockDim.x) hist[j] = 0.0;
  if (single) {
    for (int j = threadIdx.x; j < 2 * k; j += blockDim.x) trk[j] = 0;
  }
  __syncthreads();
  double* mine = kMode == kGlobal ? acc : hist + (kMode == kPerWarp ? (threadIdx.x / 32) * kc : 0);

  const unsigned bins = static_cast<unsigned>(c);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned b = static_cast<unsigned>(__ldg(x + i));
    const bool in_range = b < bins;
    for (int r = 0; r < k; ++r) {
      const float v = __ldg(w + r * n + i);
      if (in_range) atomicAdd(&mine[r * c + b], static_cast<double>(v));
      if (!finite(v)) note_nonfinite(trk + r, trk + k + r, in_range ? static_cast<int>(b) + 1 : c + 1);
    }
  }
  __syncthreads();

  if (single) {  // this block saw every sample: round straight into `out`
    for (int j = threadIdx.x; j < kc; j += blockDim.x) {
      double s;
      if (kMode == kGlobal) {
        s = __ldcg(acc + j);
        acc[j] = 0.0;
      } else {
        s = hist[j];
        if (kMode == kPerWarp) {
          for (int copy = 1; copy < kWarps; ++copy) s += hist[copy * kc + j];
        }
      }
      const int r = j / c;
      out[j] = finish(s, trk[r], trk[k + r], j - r * c);
    }
    return;
  }

  if (kMode != kGlobal) {
    for (int j = threadIdx.x; j < kc; j += blockDim.x) {
      double s = hist[j];
      if (kMode == kPerWarp) {
        for (int copy = 1; copy < kWarps; ++copy) s += hist[copy * kc + j];
      }
      if (s != 0.0) atomicAdd(&acc[j], s);  // NaN != 0.0, so a NaN sum is flushed
    }
  }
  __threadfence();  // this thread's adds are visible before its block takes a ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = threadIdx.x; j < 2 * k; j += blockDim.x) {
    s_trk[j] = __ldcg(track + j);
    track[j] = 0;
  }
  if (threadIdx.x == 0) *ticket = 0u;
  __syncthreads();
  // one block rounds all K * C sums: kUnroll loads in flight per thread
  constexpr int kUnroll = 8;
  for (int base = threadIdx.x; base < kc; base += kUnroll * kBlock) {
    double sum[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kBlock;
      sum[u] = j < kc ? __ldcg(acc + j) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kBlock;
      if (j < kc) {
        const int r = j / c;
        out[j] = finish(sum[u], s_trk[r], s_trk[k + r], j - r * c);
        acc[j] = 0.0;
      }
    }
  }
}

template <int kMode, int kBlock>
cudaError_t launch(int blocks, long long shared, cudaStream_t s, const int* x, const float* w, long long n, int k,
                   int c, double* acc, int* track, unsigned* ticket, float* out) {
  if (shared > kSharedBytes) {  // the opt-in above 48 KB, once per device
    static bool opted[tmk::kMaxDevices] = {};
    int device = 0;
    cudaGetDevice(&device);
    if (device < 0 || device >= tmk::kMaxDevices) return cudaErrorInvalidDevice;
    if (!opted[device]) {
      const cudaError_t err = cudaFuncSetAttribute(weighted_bincount_kernel<kMode, kBlock>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
      if (err != cudaSuccess) return err;
      opted[device] = true;
    }
  }
  weighted_bincount_kernel<kMode, kBlock><<<blocks, kBlock, shared, s>>>(x, w, n, k, c, acc, track, ticket, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the scratch for K rows and C bins: float64 [K * C], int32 [2K], uint32.
long long tm_weighted_bincount_scratch_bytes(int k, int c) {
  return static_cast<long long>(k) * c * 8 + 2LL * k * 4 + 4;
}

long long tm_weighted_bincount_single_block_max() { return kSingleBlockMax; }

// x: int32 [N]; w: float32 [K, N] row-major; scratch: tm_weighted_bincount_scratch_bytes
// bytes, zero before the first call and left zero by every call; out: float32 [K, C].
// Returns cudaGetLastError() after the launch.
int tm_weighted_bincount(const void* x, const void* w, long long n, int k, int c, void* scratch, void* out,
                         void* stream) {
  if (n <= 0 || k <= 0 || c <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const int*>(x);
  const auto* wf = static_cast<const float*>(w);
  const long long kc = static_cast<long long>(k) * c;
  auto* acc = static_cast<double*>(scratch);
  auto* track = reinterpret_cast<int*>(acc + kc);
  auto* ticket = reinterpret_cast<unsigned*>(track + 2 * k);
  auto* o = static_cast<float*>(out);
  const long long bytes = kc * static_cast<long long>(sizeof(double));
  const long long trackers = 2LL * k * static_cast<long long>(sizeof(int));
  const long long per_warp = bytes * (kThreads / 32) + trackers, per_block = bytes + trackers;
  // a grid of at least two blocks past kSingleBlockMax, so that no block takes the
  // single-block branch
  const long long sms = tmk::sm_count() > 1 ? tmk::sm_count() : 1;
  const auto grid = [&](long long per_sm, long long threads) {
    if (n <= kSingleBlockMax) return 1;
    const long long needed = (n + threads - 1) / threads;
    return static_cast<int>(needed < per_sm * sms ? needed : per_sm * sms);
  };
  int rc;
  if (per_warp <= kSharedBytes) {  // few blocks: each one pays a flush of K * C bins
    rc = launch<kPerWarp, kThreads>(grid(2, kThreads), per_warp, s, xi, wf, n, k, c, acc, track, ticket, o);
  } else if (per_block <= kSharedBytes) {
    rc = launch<kPerBlock, kThreads>(grid(2, kThreads), per_block, s, xi, wf, n, k, c, acc, track, ticket, o);
  } else if (per_block <= kMaxSharedBytes) {
    // e.g. K = 3, C = 8192 (192 KB): one block per SM; its flush adds a whole row of bins
    // at a time, neighbouring threads on neighbouring bins
    rc = launch<kPerBlock, kWideThreads>(grid(1, kWideThreads), per_block, s, xi, wf, n, k, c, acc, track,
                                         ticket, o);
  } else {
    rc = launch<kGlobal, kWideThreads>(grid(2, kWideThreads), trackers, s, xi, wf, n, k, c, acc, track, ticket,
                                       o);
  }
  return rc;
}

const char* tm_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
