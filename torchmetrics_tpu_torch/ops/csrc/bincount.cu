// Unweighted bincount on Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel `bincount_pallas` (torchmetrics_tpu/ops/pallas_kernels.py:267)
// in its `valid=None` form, which streams only the [N] indices from HBM, builds a
// [tile, C] one-hot block in VMEM and contracts it with a ones row on the MXU into a
// [1, C] f32 accumulator carried across a sequential grid. Here the same function,
//     out[c] = #{i : x[i] == c},
// is an int32 histogram of the indices: no one-hot block and no product. (The masked
// form, `valid` given, is the K = 1 case of weighted_bincount.cu, as on the TPU.)
//
// Bound: it reads N * (bytes of an index) and writes C * 4 bytes, so the card's memory
// rate bounds it: 8.3 us for the retrieval grouping's 6.98 M int32 query ids (C =
// 6980), 16.7 us for the same ids as int64. Each sample costs one shared-memory atomic
// at most. The design's aims are one device kernel per call (no cast, no zero fill, no
// allocation but the output) and 16-byte loads of the indices as they are.
//
// Design:
// - The indices are read as they arrive, int32 or int64 (a template argument). An int64
//   index is taken by its low 32 bits, as JAX (64-bit types off) converts it to int32 on
//   entry; then an index outside [0, C), negative ones included, counts nowhere (the TPU
//   kernel's one-hot columns are all zero there) and is never written.
// - Loads are 16 bytes a lane (4 int32 or 2 int64), marked to be evicted first from L2.
//   Every warp of the grid takes an equal range of the vectors, so that no SM streams
//   longer than another, and walks it in chunks of 32 * kUnroll neighbouring vectors
//   (a grid-stride walk took longer on the card). The elements before the first 16-byte
//   boundary (a view at an element offset, x[1:]) and the tail after the last whole
//   vector are counted one at a time.
// - Sorted or run-length input (retrieval users pass ids grouped by query) must not
//   make 32 lanes wait on one address: a warp whose 32 vectors all hold one index adds
//   them with one atomic (one shuffle and one vote to find out), and a lane adds the
//   equal neighbours of its own vector as one.
// - Every bin of `out` is written by the launch; the caller allocates it with
//   torch.empty. All blocks have 1024 threads.
// - C within kBlockBins (C * 4 bytes within 227 KB of opt-in shared memory, C <= 57,856):
//   blocks count in shared memory. Few bins (C <= kLaneBins = 384) give each lane of a
//   warp its own copy, laid out [bin][lane], so a warp's 32 atomics never meet on one
//   address or one bank whatever the indices; more bins one copy per block. Up to
//   kSingleBlockMax samples one block counts them all and writes every bin itself.
//   Past it one cooperative launch of one block per SM (the occupancy query says
//   whether it fits; one 1024-thread block per SM keeps enough loads in flight, and
//   fewer blocks make a cheaper merge): each block writes its totals into its own slot
//   of a scratch [blocks][C rounded up to 4] in device memory, the grid synchronises,
//   then each block sums a stripe of bins over all the slots and writes it to `out`,
//   reading 16-byte quads of bins, several slots at once. At C = 6980 the slots are
//   3.7 MB, read back from L2 by all SMs at once. (The other merge, K3's last-block
//   ticket, adds every block's bins into an accumulator with global atomics, 0.92 M of
//   them here, and needs that accumulator zeroed again by the last block; the slots need
//   no zeroing: the wrapper keeps one scratch per (device, stream), sized to the call,
//   and every launch writes the slots it reads.)
// - C beyond shared memory (C = 2^20 is a 4 MB output): atomics straight into `out`,
//   where collisions are rare. The kernel is launched cooperatively: every block zeroes
//   its stripe of `out` with 16-byte stores, the grid synchronises, then counts.
// - Counts are int32 and exact, past the f32 kernel's 2^24 per bin.
// - The kernel allocates nothing, launches on the caller's stream and does not
//   synchronise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "device_cache.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// 16-byte vectors a lane loads before it counts any of them
constexpr int kUnroll = 4;
constexpr int kSharedBytes = 48 * 1024;
// the most dynamic shared memory a block opts into (227 KB, less room for the static part)
constexpr int kMaxSharedBytes = 227 * 1024 - 1024;
// the per-lane mode's limit: one [bin][32 lanes] int32 copy within 48 KB
constexpr int kLaneBins = kSharedBytes / (32 * 4);
// the shared-memory modes' limit, and the scratch's slot size in bins
constexpr int kBlockBins = kMaxSharedBytes / 4;
// one block up to this N: 8 samples a thread
constexpr long long kSingleBlockMax = 8192;
// slots a thread reads at once in the grid's merge
constexpr int kMergeLoads = 8;

enum Mode { kPerLane = 0, kPerBlock = 1, kGlobal = 2 };

// The indices of one 16-byte vector as unsigned low 32 bits: below C exactly when the
// int32 JAX would make of the index lies in [0, C).
template <typename T>
struct Vector;

template <>
struct Vector<int> {
  static constexpr int kCount = 4;
  __device__ static void split(int4 v, unsigned (&a)[kCount]) {
    a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
  }
};

template <>
struct Vector<long long> {  // little-endian: the low words of two int64 are .x and .z
  static constexpr int kCount = 2;
  __device__ static void split(int4 v, unsigned (&a)[kCount]) { a[0] = v.x, a[1] = v.z; }
};

template <int kMode>
__device__ __forceinline__ void add(int* hist, unsigned b, unsigned bins, int lane, int count) {
  if (b < bins) atomicAdd(hist + (kMode == kPerLane ? b * 32 + lane : b), count);
}

// Count the 16-byte vectors `v` of one chunk, which starts at vector `first` of a warp's
// range that ends at `end`.
template <typename T, int kMode>
__device__ __forceinline__ void count_chunk(const int4 (&v)[kUnroll], long long first, long long end,
                                            unsigned bins, int lane, int* hist) {
  constexpr int kPer = Vector<T>::kCount;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long at = first + u * 32;  // warp-uniform
    if (at >= end) break;
    unsigned a[kPer];
    Vector<T>::split(v[u], a);
    bool same = true;
#pragma unroll
    for (int j = 1; j < kPer; ++j) same = same && a[j] == a[0];
    if (at + 32 <= end) {  // all 32 lanes hold a vector: one atomic if they hold one index
      const unsigned lane0 = __shfl_sync(0xffffffffu, a[0], 0);
      if (__all_sync(0xffffffffu, same && a[0] == lane0)) {
        if (lane == 0) add<kMode>(hist, lane0, bins, 0, 32 * kPer);
        continue;
      }
    }
    if (at + lane >= end) continue;
    if (same) {
      add<kMode>(hist, a[0], bins, lane, kPer);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) add<kMode>(hist, a[j], bins, lane, 1);
    }
  }
}

// Count x[0, n) into `hist` (shared memory, or `out` itself in the global mode). `head`
// elements come before the first 16-byte boundary of x. Every warp of the grid takes an
// equal range of the whole vectors, in chunks of 32 * kUnroll.
template <typename T, int kMode>
__device__ __forceinline__ void count_all(const T* __restrict__ x, long long n, long long head, unsigned bins,
                                          int* hist) {
  constexpr int kPer = Vector<T>::kCount;
  constexpr int kChunk = 32 * kUnroll;
  const int lane = threadIdx.x & 31;
  const long long thread = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const long long body = (n - head) / kPer;  // whole vectors
  const long long tail = n - head - body * kPer;
  if (thread < head) add<kMode>(hist, static_cast<unsigned>(x[thread]), bins, lane, 1);
  if (thread < tail) add<kMode>(hist, static_cast<unsigned>(x[head + body * kPer + thread]), bins, lane, 1);

  const int4* __restrict__ xv = reinterpret_cast<const int4*>(x + head);
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long per_warp = ((body + warps - 1) / warps + 31) / 32 * 32;  // 512-byte aligned ranges
  const long long begin = (thread >> 5) * per_warp;
  const long long end = begin + per_warp < body ? begin + per_warp : body;
  if (begin >= end) return;  // warp-uniform
  for (long long first = begin; first < end; first += kChunk) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load of the chunk before any count
      const long long j = first + u * 32 + lane;
      v[u] = j < end ? __ldcs(xv + j) : make_int4(0, 0, 0, 0);  // read once: evict first
    }
    count_chunk<T, kMode>(v, first, end, bins, lane, hist);
  }
}

// A slot's bins, rounded up to whole 16-byte quads.
__host__ __device__ constexpr int padded(int c) { return (c + 3) & ~3; }

// After the grid's barrier: this block sums its stripe of quads over every slot into
// `out`. A thread sums one quad of every `groups`-th slot, kMergeLoads loads at once,
// and adds its sums into `hist`.
__device__ __forceinline__ void merge_slots(const int* __restrict__ slots, int c, int* hist, int* __restrict__ out) {
  const int quads = padded(c) / 4, blocks = static_cast<int>(gridDim.x);
  const int stripe = (quads + blocks - 1) / blocks;
  const int first = blockIdx.x * stripe;
  const int count = quads - first < stripe ? quads - first : stripe;
  if (count <= 0) return;  // block-uniform
  for (int j = threadIdx.x; j < count * 4; j += kThreads) hist[j] = 0;
  __syncthreads();
  const int groups = count < kThreads ? kThreads / count : 1;
  const int group = count < kThreads ? threadIdx.x / count : 0;
  const int4* __restrict__ slots4 = reinterpret_cast<const int4*>(slots);
  if (group < groups) {
    for (int q = count < kThreads ? threadIdx.x % count : threadIdx.x; q < count; q += kThreads) {
      int4 sum = make_int4(0, 0, 0, 0);
      for (int s0 = group; s0 < blocks; s0 += groups * kMergeLoads) {
        int4 v[kMergeLoads];
#pragma unroll
        for (int u = 0; u < kMergeLoads; ++u) {
          const int slot = s0 + u * groups;
          v[u] = slot < blocks ? __ldcg(slots4 + static_cast<long long>(slot) * quads + first + q)
                               : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kMergeLoads; ++u) sum.x += v[u].x, sum.y += v[u].y, sum.z += v[u].z, sum.w += v[u].w;
      }
      if (sum.x) atomicAdd(&hist[4 * q], sum.x);
      if (sum.y) atomicAdd(&hist[4 * q + 1], sum.y);
      if (sum.z) atomicAdd(&hist[4 * q + 2], sum.z);
      if (sum.w) atomicAdd(&hist[4 * q + 3], sum.w);
    }
  }
  __syncthreads();
  const int bins = c - first * 4 < count * 4 ? c - first * 4 : count * 4;
  for (int j = threadIdx.x; j < bins; j += kThreads) out[first * 4 + j] = hist[j];
}

// kGrid false: one block counts every sample and writes `out`. kGrid true: launched
// cooperatively; block b writes its totals to slots[b][padded(C)], the grid
// synchronises, and each block sums its stripe of bins over the slots into `out`.
template <typename T, int kMode, bool kGrid>
__global__ void __launch_bounds__(kThreads, 1)
    bincount_shared_kernel(const T* __restrict__ x, long long n, long long head, int c, int* __restrict__ slots,
                           int* __restrict__ out) {
  extern __shared__ __align__(16) int hist[];
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < (kMode == kPerLane ? c * 32 : padded(c)); j += kThreads) hist[j] = 0;
  __syncthreads();
  count_all<T, kMode>(x, n, head, static_cast<unsigned>(c), hist);
  __syncthreads();

  // this block's totals: `out` itself in one block, else the block's slot, its padding zero
  int* totals = kGrid ? slots + static_cast<long long>(blockIdx.x) * padded(c) : out;
  if (kMode == kPerLane) {  // one warp a bin, its lanes' copies summed by a warp reduction
    for (int b = threadIdx.x >> 5; b < (kGrid ? padded(c) : c); b += kWarps) {
      const int v = b < c ? __reduce_add_sync(0xffffffffu, hist[b * 32 + lane]) : 0;
      if (lane == 0) totals[b] = v;
    }
  } else if (kGrid) {  // hist holds padded(c) bins
    for (int q = threadIdx.x; q < padded(c) / 4; q += kThreads) {
      reinterpret_cast<int4*>(totals)[q] = reinterpret_cast<const int4*>(hist)[q];
    }
  } else {
    for (int b = threadIdx.x; b < c; b += kThreads) totals[b] = hist[b];
  }
  if constexpr (kGrid) {
    cooperative_groups::this_grid().sync();  // every slot is written, and hist is free
    merge_slots(slots, c, hist, out);
  }
}

// Launched cooperatively: the grid zeroes `out`, synchronises, then counts into it.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    bincount_global_kernel(const T* __restrict__ x, long long n, long long head, int c, int* __restrict__ out) {
  const long long first = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // 16-byte stores where `out` allows them (torch's allocator aligns it to 512 bytes)
  const long long quads = reinterpret_cast<std::uintptr_t>(out) % 16 == 0 ? c / 4 : 0;
  int4* out4 = reinterpret_cast<int4*>(out);
  for (long long j = first; j < quads; j += stride) out4[j] = make_int4(0, 0, 0, 0);
  for (long long j = quads * 4 + first; j < c; j += stride) out[j] = 0;
  cooperative_groups::this_grid().sync();  // every bin is zero before any is counted
  count_all<T, kGlobal>(x, n, head, static_cast<unsigned>(c), out);
}

// Whether one block of `kernel` fits on an SM with `shared` bytes of dynamic shared
// memory (opted into first where that is above 48 KB), asked once per device;
// `cache` keeps the answer (0 unknown, 1 yes, -1 no).
template <typename Kernel>
bool one_block_fits(int* cache, Kernel kernel, int shared) {
  int device = 0;
  cudaGetDevice(&device);
  const bool cached = device >= 0 && device < tmk::kMaxDevices;
  if (cached && cache[device] != 0) return cache[device] > 0;
  int per_sm = 0;
  if (shared > kSharedBytes &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared) != cudaSuccess) {
    per_sm = 0;
  } else {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, shared);
  }
  if (cached) cache[device] = per_sm >= 1 ? 1 : -1;
  return per_sm >= 1;
}

long long sms() { return tmk::sm_count() > 1 ? tmk::sm_count() : 1; }

// Blocks of a shared-memory mode's grid: one per SM at most, none idle.
long long grid_blocks(long long n) {
  const long long needed = (n + kThreads - 1) / kThreads;
  return needed < sms() ? needed : sms();
}

template <typename T, int kMode>
cudaError_t launch_shared(const T* x, long long n, long long head, int c, int* slots, long long slots_bytes,
                          int* out, cudaStream_t s) {
  // every launch of a mode's kernels fits in its largest shared size, opted into once
  const int most = kMode == kPerLane ? kSharedBytes : kMaxSharedBytes;
  const int shared = (kMode == kPerLane ? c * 32 : padded(c)) * static_cast<int>(sizeof(int));
  if (n <= kSingleBlockMax) {
    const auto kernel = bincount_shared_kernel<T, kMode, false>;
    static int fits[tmk::kMaxDevices] = {};
    if (!one_block_fits(fits, kernel, most)) return cudaErrorInvalidConfiguration;
    bincount_shared_kernel<T, kMode, false><<<1, kThreads, shared, s>>>(x, n, head, c, slots, out);
    return cudaGetLastError();
  }
  const auto kernel = bincount_shared_kernel<T, kMode, true>;
  static int fits[tmk::kMaxDevices] = {};
  if (!one_block_fits(fits, kernel, most)) return cudaErrorCooperativeLaunchTooLarge;
  const long long blocks = grid_blocks(n);
  if (slots == nullptr || slots_bytes < blocks * padded(c) * static_cast<long long>(sizeof(int))) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned>(blocks)), block(kThreads);
  void* args[] = {&x, &n, &head, &c, &slots, &out};
  const cudaError_t err = cudaLaunchCooperativeKernel(kernel, grid, block, args, shared, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* x, long long n, int c, int* slots, long long slots_bytes, int* out, cudaStream_t s) {
  const long long misaligned = static_cast<long long>(reinterpret_cast<std::uintptr_t>(x) % 16);
  long long head = misaligned ? (16 - misaligned) / static_cast<long long>(sizeof(T)) : 0;
  head = head < n ? head : n;
  if (c <= kLaneBins) return launch_shared<T, kPerLane>(x, n, head, c, slots, slots_bytes, out, s);
  if (c <= kBlockBins) return launch_shared<T, kPerBlock>(x, n, head, c, slots, slots_bytes, out, s);
  const auto kernel = bincount_global_kernel<T>;
  static int fits[tmk::kMaxDevices] = {};
  if (!one_block_fits(fits, kernel, 0)) return cudaErrorCooperativeLaunchTooLarge;
  const dim3 grid(static_cast<unsigned>(sms())), block(kThreads);
  void* args[] = {&x, &n, &head, &c, &out};
  const cudaError_t err = cudaLaunchCooperativeKernel(kernel, grid, block, args, 0, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// x: int32 or int64 [N] (`x_bytes` 4 or 8), any element-aligned address; scratch:
// `scratch_bytes` bytes of any content, 16-byte aligned, used by one stream at a time,
// at least min(ceil(N / 1024), SMs) * ceil(C / 4) * 16 when N > 8192 and C <= 57856
// (the grid's slots), else unused and may be null; out: int32 [C], every bin written.
// Returns cudaGetLastError() after the launch.
int tm_bincount(const void* x, int x_bytes, long long n, int c, void* scratch, long long scratch_bytes, void* out,
                void* stream) {
  if (c <= 0 || n < 0) return 0;
  if (x_bytes != 4 && x_bytes != 8) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<int*>(scratch);
  auto* o = static_cast<int*>(out);
  const cudaError_t err =
      x_bytes == 8 ? launch(static_cast<const long long*>(x), n, c, sc, scratch_bytes, o, s)
                   : launch(static_cast<const int*>(x), n, c, sc, scratch_bytes, o, s);
  return static_cast<int>(err);
}

const char* tm_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
