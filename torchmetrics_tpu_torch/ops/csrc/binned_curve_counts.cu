// Per-threshold tp/fp counts of the binned curve family on Hopper (sm_90a),
// bound to Python through ctypes.
//
// Replaces the TPU kernel `binned_curve_counts_pallas`
// (torchmetrics_tpu/ops/pallas_kernels.py:140), which compares a [T, tile] block of
// scores against the thresholds in VMEM and reduces it on the MXU into a [T, 2] f32
// accumulator carried across a sequential grid. The function is
//     tp[t] = #{i : valid[i], label[i] != 0, score[i] >= thr[t]}
//     fp[t] = #{i : valid[i], label[i] == 0, score[i] >= thr[t]}
// over thresholds in any order, with ties; a NaN score and a NaN threshold count
// nowhere.
//
// Bound: it reads each score (4 bytes), label (4 or 8) and mask byte once and the T
// thresholds, and writes int32 [T, 2]: N * (5 + label bytes) + 12 T bytes, so the
// card's memory rate bounds it (0.0013 ms at N = 500,000, T = 200). The search below
// adds N * ceil(log2(T + 1)) float compares, far below the bytes. What a call costs at
// the main path's shapes is the host's work to enqueue it, so the design's first aim
// is one device kernel per call and nothing else: no cast of int32 or int64 labels, no
// zero fill, no host synchronisation, no allocation but the output.
//
// Design, for T <= kSortedMax (the search mode):
// - Threshold order. Each block decides whether the thresholds are non-decreasing
//   (NaN only at the tail counts as sorted; the built-in grid is sorted by
//   construction, a user's list need not be). If they are not, it sorts (order key,
//   index) pairs with a bitonic sort in shared memory: NaN last, -0.0 before +0.0,
//   which float32 compares call equal, so either order serves. No host round trip.
// - Bucket search. For each valid sample, p = #{j : thr_sorted[j] <= score} by a
//   descent of a search tree over the sorted thresholds, kept in shared memory in
//   breadth-first order: the lanes of a warp read neighbouring words at the top
//   levels, where a binary search over the sorted array sends them to one bank. Each
//   step compares the float32 values themselves, never an index computed from the
//   score, so a score equal to a threshold counts exactly as float32 `>=` does. Then
//   hist[p][label == 0] += 1 in one shared histogram per block: per-warp copies and
//   warp-aggregated atomics bought nothing on the card, crowded scores included (the
//   ImageNet micro curve puts 999 of every 1000 scores below the second threshold). A
//   NaN score fails every `<=` and lands in bucket 0, which no threshold counts; a NaN
//   threshold sorts last and no score passes it.
// - Suffix sum. tp_sorted[j] = sum_{p > j} hist[p][0], fp likewise, written to
//   out[index[j]]: every cell of the output is written, which the caller allocates
//   with torch.empty.
// - Blocks. Up to kSingleBlockMax samples one block counts them all and writes `out`.
//   Past it a grid of 1024-thread blocks is merged in the same launch by a last-block
//   ticket (as the weighted bincount does): each block adds its non-zero bins into an
//   int32 scratch with atomics and takes a ticket; the block that draws the last one
//   runs the suffix sum over the scratch, writes `out`, and zeroes the scratch and the
//   ticket for the next call. The wrapper zeroes a scratch once per (device, stream)
//   and keeps it; calls on one stream run in order and share it.
// For T > kSortedMax the thresholds outgrow what a block sorts in shared memory; the
// compare mode keeps the first port's O(N * T) compare (each thread one threshold,
// samples staged in shared memory) and counts into the same scratch, merged by the
// same ticket. Both modes count in int32, exactly, past the f32 kernel's 2^24.
// Labels are read as they arrive, int32 or int64 (a template argument), an int64 by
// its low 32 bits as JAX (64-bit types off) converts it to int32 on entry; the mask as
// the bytes of a bool tensor. The kernel allocates nothing, launches on the caller's
// stream and does not synchronise.

#include <cuda_runtime.h>

#include "device_cache.cuh"

namespace {

constexpr int kThreads = 1024;
// the search mode's limit: a block sorts at most this many thresholds
constexpr int kSortedMax = 4096;
// keys a thread holds while the sorted pairs are unpacked: P <= 2 * kSortedMax
constexpr int kSortSlots = 2 * kSortedMax / kThreads;
// one block up to this N: 8 samples a thread
constexpr long long kSingleBlockMax = 8192;
// samples a thread loads before it searches them
constexpr int kUnroll = 4;
constexpr int kSharedDefault = 48 * 1024;
constexpr int kMaxSharedBytes = 227 * 1024 - 1024;
constexpr int kCompareThreads = 256;
constexpr int kTile = 1024;

__host__ __device__ inline int pow2_at_least(int t) {
  int p = 1;
  while (p < t) p <<= 1;
  return p;
}

// A label's low 32 bits are not zero.
template <typename TL>
__device__ __forceinline__ bool positive(const TL* __restrict__ labels, long long i) {
  return static_cast<unsigned>(__ldg(labels + i)) != 0u;
}

// An unsigned key that orders floats as `<` does, -0.0 before +0.0 and NaN last.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  if (x != x) return 0xffffffffu;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  if (k == 0xffffffffu) return __uint_as_float(0x7fc00000u);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The sorted position of node i (1 <= i < P) of a perfect binary search tree over P - 1
// sorted values, stored in breadth-first order (node i's children are 2i and 2i + 1).
__device__ __forceinline__ int node_position(int i, int levels) {
  const int level = 31 - __clz(i);
  return ((2 * (i - (1 << level)) + 1) << (levels - 1 - level)) - 1;
}

// Stages the thresholds as the search tree tree[1, P), P = 2^levels >= T + 1, over
// the ascending thresholds with NaN last, then NaN padding; their original indices in
// s_idx[0, T) when they did not arrive sorted. Returns true when they arrived sorted
// (s_idx is then not written: the order is the identity). `keys` (uint64 [P]) overlays
// the sorted floats (at its start) and s_idx (at 4P bytes). Ends with a barrier.
__device__ bool stage_thresholds(const float* __restrict__ thr, int t, int p, int levels, float* tree, int* s_idx,
                                 unsigned long long* keys) {
  int unsorted = 0;
  for (int j = threadIdx.x; j + 1 < t; j += blockDim.x) {
    const float a = __ldg(thr + j), b = __ldg(thr + j + 1);
    unsorted |= (b == b) && !(a <= b);  // a NaN before a number, or a > b
  }
  if (!__syncthreads_or(unsorted)) {
    for (int i = threadIdx.x + 1; i < p; i += blockDim.x) {
      const int k = node_position(i, levels);
      tree[i] = k < t ? __ldg(thr + k) : __uint_as_float(0x7fc00000u);
    }
    __syncthreads();
    return true;
  }
  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    keys[j] = j < t ? (static_cast<unsigned long long>(order_key(__ldg(thr + j))) << 32) | static_cast<unsigned>(j)
                    : ~0ull;  // padding sorts after every real key, NaN thresholds included
  }
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long a = keys[i], b = keys[l];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  unsigned long long mine[kSortSlots];
#pragma unroll
  for (int s = 0; s < kSortSlots; ++s) {
    const int j = threadIdx.x + s * blockDim.x;
    mine[s] = j < p ? keys[j] : 0ull;
  }
  __syncthreads();  // every key is in registers before the region is rewritten
  float* sorted = reinterpret_cast<float*>(keys);
#pragma unroll
  for (int s = 0; s < kSortSlots; ++s) {
    const int j = threadIdx.x + s * blockDim.x;
    if (j < p) sorted[j] = key_value(static_cast<unsigned>(mine[s] >> 32));  // the padding's key gives NaN
    if (j < t) s_idx[j] = static_cast<int>(mine[s] & 0xffffffffu);
  }
  __syncthreads();
  for (int i = threadIdx.x + 1; i < p; i += blockDim.x) tree[i] = sorted[node_position(i, levels)];
  __syncthreads();
  return false;
}

// #{j : thr_sorted[j] <= x}: a descent of the breadth-first search tree, whose first
// levels are a few neighbouring words, so the lanes of a warp rarely meet in a bank
// of shared memory (a binary search over the sorted array itself sends them to
// addresses one power of two apart, all in one bank).
__device__ __forceinline__ int bucket(const float* tree, int levels, float x) {
  int i = 1;
  for (int l = 0; l < levels; ++l) i = 2 * i + (tree[i] <= x ? 1 : 0);
  return i - (1 << levels);
}

// hist: int32 [T + 1][2] bucket counts. Writes out[index[j]] = sum_{p > j} hist[p] for
// j in [0, T) (index null: the identity) by a block-wide suffix sum.
__device__ void write_suffix(const int* hist, int t, const int* index, int* __restrict__ out) {
  __shared__ int2 warp_sum[32];
  const int m = t + 1;
  const int chunk = (m + blockDim.x - 1) / blockDim.x;
  const int lo = min(m, static_cast<int>(threadIdx.x) * chunk), hi = min(m, lo + chunk);
  int2 own = make_int2(0, 0);
  for (int q = lo; q < hi; ++q) {
    own.x += hist[2 * q];
    own.y += hist[2 * q + 1];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int2 v = own;  // the sum over this lane and the later lanes of its warp
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_down_sync(0xffffffffu, v.x, d), y = __shfl_down_sync(0xffffffffu, v.y, d);
    if (lane + d < 32) {
      v.x += x;
      v.y += y;
    }
  }
  if (lane == 0) warp_sum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int2 w = lane < warps ? warp_sum[lane] : make_int2(0, 0);
    int2 s = w;
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_down_sync(0xffffffffu, s.x, d), y = __shfl_down_sync(0xffffffffu, s.y, d);
      if (lane + d < 32) {
        s.x += x;
        s.y += y;
      }
    }
    if (lane < warps) warp_sum[lane] = make_int2(s.x - w.x, s.y - w.y);  // the later warps' sum
  }
  __syncthreads();
  int2 run = make_int2(v.x - own.x + warp_sum[warp].x, v.y - own.y + warp_sum[warp].y);
  for (int q = hi - 1; q >= lo; --q) {
    run.x += hist[2 * q];
    run.y += hist[2 * q + 1];
    if (q >= 1) {
      const int j = index ? index[q - 1] : q - 1;
      out[2 * j] = run.x;
      out[2 * j + 1] = run.y;
    }
  }
}

// The search mode. Dynamic shared memory: 8P bytes of sort keys (then the sorted
// thresholds and their indices), the search tree float [P], and the histogram int32
// [T + 1][2]. acc: int32 [2 (T + 1)] and the ticket,
// zero between calls; untouched by a single-block launch.
template <typename TL>
__global__ void __launch_bounds__(kThreads)
    curve_search_kernel(const float* __restrict__ scores, const TL* __restrict__ labels,
                        const unsigned char* __restrict__ valid, long long n, const float* __restrict__ thr, int t,
                        int* __restrict__ acc, unsigned* __restrict__ ticket, int* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  __shared__ bool last;
  const int p = pow2_at_least(t + 1);
  const int levels = 31 - __clz(p);
  int* s_idx = reinterpret_cast<int*>(smem) + p;
  float* tree = reinterpret_cast<float*>(smem + p);
  int* hist = reinterpret_cast<int*>(tree + p);
  const int bins = 2 * (t + 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int j = threadIdx.x; j < bins; j += blockDim.x) hist[j] = 0;
  const bool identity = stage_thresholds(thr, t, p, levels, tree, s_idx, smem);

  for (long long base = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; base < n;
       base += stride * kUnroll) {
    float x[kUnroll];
    int cls[kUnroll];  // 0 positive, 1 negative, -1 invalid or past N
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      x[u] = 0.0f;
      cls[u] = -1;
      if (i < n) {
        const unsigned char ok = __ldg(valid + i);
        x[u] = __ldg(scores + i);
        const bool pos = positive(labels, i);
        cls[u] = ok ? (pos ? 0 : 1) : -1;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (cls[u] >= 0) atomicAdd(&hist[2 * bucket(tree, levels, x[u]) + cls[u]], 1);
    }
  }
  __syncthreads();

  const bool single = gridDim.x == 1;
  if (!single) {
    for (int b = threadIdx.x; b < bins; b += blockDim.x) {
      if (hist[b]) atomicAdd(acc + b, hist[b]);
    }
    __threadfence();  // this thread's adds are visible before its block takes a ticket
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int b = threadIdx.x; b < bins; b += blockDim.x) {
      hist[b] = __ldcg(acc + b);
      acc[b] = 0;
    }
    if (threadIdx.x == 0) *ticket = 0u;
  }
  __syncthreads();
  write_suffix(hist, t, identity ? nullptr : s_idx, out);
}

// The compare mode (T > kSortedMax): each thread owns one threshold of a chunk and
// compares it with every sample of the block's tiles, staged in shared memory.
template <typename TL>
__global__ void __launch_bounds__(kCompareThreads)
    curve_compare_kernel(const float* __restrict__ scores, const TL* __restrict__ labels,
                         const unsigned char* __restrict__ valid, long long n, const float* __restrict__ thr, int t,
                         int* __restrict__ acc, unsigned* __restrict__ ticket, int* __restrict__ out) {
  __shared__ float s_score[kTile];
  __shared__ unsigned char s_flag[kTile];
  __shared__ bool last;
  const long long tiles = (n + kTile - 1) / kTile;
  for (int t0 = 0; t0 < t; t0 += kCompareThreads) {
    const int j = t0 + threadIdx.x;
    const float mine = j < t ? __ldg(thr + j) : __uint_as_float(0x7fc00000u);
    int tp = 0, fp = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const long long base = tile * kTile;
      const int len = static_cast<int>(n - base < kTile ? n - base : kTile);
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < len; i += blockDim.x) {
        const long long g = base + i;
        s_score[i] = __ldg(scores + g);
        s_flag[i] = __ldg(valid + g) ? (positive(labels, g) ? 1 : 2) : 0;
      }
      __syncthreads();
      for (int i = 0; i < len; ++i) {
        const int ge = s_score[i] >= mine;
        const int f = s_flag[i];
        tp += ge & f;
        fp += ge & (f >> 1);
      }
    }
    if (tp) atomicAdd(acc + 2 * j, tp);
    if (fp) atomicAdd(acc + 2 * j + 1, fp);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int b = threadIdx.x; b < 2 * t; b += blockDim.x) {
    out[b] = __ldcg(acc + b);
    acc[b] = 0;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

template <typename TL>
cudaError_t launch(const float* scores, const TL* labels, const unsigned char* valid, long long n, const float* thr,
                   int t, int* acc, unsigned* ticket, int* out, cudaStream_t s) {
  const long long sms = tmk::sm_count() > 1 ? tmk::sm_count() : 1;
  if (t > kSortedMax) {
    const long long tiles = (n + kTile - 1) / kTile;
    const long long most = 4 * sms;
    const int blocks = static_cast<int>(tiles < 1 ? 1 : (tiles < most ? tiles : most));
    curve_compare_kernel<TL><<<blocks, kCompareThreads, 0, s>>>(scores, labels, valid, n, thr, t, acc, ticket, out);
    return cudaGetLastError();
  }
  const int p = pow2_at_least(t + 1);
  const int shared = 12 * p + 8 * (t + 1);
  const auto kernel = curve_search_kernel<TL>;
  if (shared > kSharedDefault) {  // the opt-in above 48 KB, once per device
    static bool opted[tmk::kMaxDevices] = {};
    int device = 0;
    cudaGetDevice(&device);
    if (device < 0 || device >= tmk::kMaxDevices) return cudaErrorInvalidDevice;
    if (!opted[device]) {
      const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   kMaxSharedBytes);
      if (err != cudaSuccess) return err;
      opted[device] = true;
    }
  }
  long long blocks = 1;
  if (n > kSingleBlockMax) {
    const long long needed = (n + kThreads * kUnroll - 1) / (kThreads * kUnroll);
    blocks = needed < 2 * sms ? needed : 2 * sms;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, shared, s>>>(scores, labels, valid, n, thr, t, acc, ticket,
                                                                  out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the scratch for T thresholds: int32 [2 (T + 1)], then the uint32 ticket.
long long tm_binned_curve_counts_scratch_bytes(int num_thresholds) {
  return 8LL * (num_thresholds + 1) + 4;
}

// scores: float32 [N]; labels: int32 or int64 [N] (`label_bytes` 4 or 8); valid: bool
// [N] as bytes; thresholds: float32 [T], any order; scratch: at least
// tm_binned_curve_counts_scratch_bytes(T) bytes, zero before the first call and left
// zero by every call, used by one stream at a time; out: int32 [T, 2] (tp, fp), every
// cell written. Returns cudaGetLastError() after the launch.
int tm_binned_curve_counts(const void* scores, const void* labels, int label_bytes, const void* valid, long long n,
                           const void* thresholds, int num_thresholds, void* scratch, long long scratch_bytes,
                           void* out, void* stream) {
  if (num_thresholds <= 0) return 0;
  if (n < 0 || (label_bytes != 4 && label_bytes != 8) || scratch == nullptr ||
      scratch_bytes < tm_binned_curve_counts_scratch_bytes(num_thresholds)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scores);
  const auto* v = static_cast<const unsigned char*>(valid);
  const auto* thr = static_cast<const float*>(thresholds);
  auto* acc = static_cast<int*>(scratch);
  auto* ticket = reinterpret_cast<unsigned*>(acc + 2LL * (num_thresholds + 1));
  auto* o = static_cast<int*>(out);
  cudaError_t err;
  if (label_bytes == 8) {
    err = launch(sc, static_cast<const long long*>(labels), v, n, thr, num_thresholds, acc, ticket, o, s);
  } else {
    err = launch(sc, static_cast<const int*>(labels), v, n, thr, num_thresholds, acc, ticket, o, s);
  }
  return static_cast<int>(err);
}

const char* tm_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
