// The five SSIM window moments of padded image planes on Hopper (sm_90a), bound to
// Python through ctypes.
//
// Replaces the TPU kernel `ssim_moments_pallas`
// (torchmetrics_tpu/ops/pallas_kernels.py:334). That kernel holds one whole padded
// plane of preds p and target t in VMEM, forms the product planes p*p, t*t and p*t
// there, and runs a shift-and-add over the rows window wh and then over the columns
// window ww for each of the five planes:
//     out[plane, m, i, j] = sum_b ww[b] * sum_a wh[a] * X_m[i + a, j + b],
//     X = (p, t, p*p, t*t, p*t),  i < Ho = Hp - Kh + 1,  j < Wo = Wp - Kw + 1.
// SSIM and MS-SSIM call it once per scale with P = batch * channels planes and the
// two 1D factors of the gaussian (or uniform) window.
//
// Bound: it reads 2 * P * Hp * Wp floats and writes 5 * P * Ho * Wo, so the card's
// memory rate bounds it (at P = 12, 1366 x 2050, 11 x 11: 933 MB, 0.28 ms at
// 3.35 TB/s; its ~120 FMAs per output take 0.12 ms at the float32 rate). The three
// product planes and the rows-pass intermediate never reach device memory: the library
// route (the products stacked into a [5P, ...] tensor, then a convolution) writes and
// reads them. The writes are 71% of the bytes.
//
// Design:
// - Tiles of 16 output rows by TW output columns. A tile's input, with the window's
//   reach of Kh - 1 rows and Kw - 1 columns, is staged into shared rows of a fixed
//   pitch: the smallest of 128, 192 and 256 floats that holds at least 64 output
//   columns beside the whole columns window, TW the widest multiple of 4 that then
//   fits. At 11 x 11 that is 116 columns in a 128-float pitch (26 x 126 floats of
//   input). A block's time grows with its tile, so a window other than 11 x 11 whose
//   grid holds fewer than two tiles per SM (a small plane, a large window) halves TW,
//   down to 32 columns, until it holds them, and takes the smallest pitch that still
//   fits the whole window: 71 x 71 on P = 3 planes of 326 x 326 runs 384 tiles of
//   16 x 32 in a 128-float pitch. One block per tile: on the card that beat
//   persistent grids of one, two and three blocks per SM walking the tiles (PERF.md,
//   PR 4), and one input buffer leaves room for three blocks per SM at 11 x 11.
// - The input is copied into shared memory with cp.async, 8 bytes a copy where the
//   rows allow (Wp even), else 4: a padded plane's rows are 8-byte aligned at
//   Wp = 2050, 4-byte at odd widths, so TMA (16-byte row strides) does not take them.
//   A pixel outside the plane (a tile at the ragged edge) is zero-filled; it reaches
//   only outputs outside [Ho, Wo], which are not written. A tile that takes several
//   steps (a window in several bands or chunks) copies the next step's input in as
//   soon as the rows pass has read the buffer, under the columns pass.
// - Rows pass out of shared memory: a thread takes one input column of the tile and 8
//   output rows (2 x 126 of the 256 threads at 11 x 11), reads the 8 + Kh - 1 pixels of
//   p and t once, forms the three products in registers and keeps the 5 x 8 sums in
//   registers; it writes them to an intermediate [5][16][pitch] in shared memory.
// - Columns pass: a thread takes 4 neighbouring outputs of one row, and for each
//   moment reads the 4 + Kw - 1 intermediate values it needs once (as 16-byte loads
//   at 11 x 11, else one a tap into a sliding window of registers) and writes its 4
//   outputs as one 16-byte streaming store (__stcs) where the output row allows, else
//   one by one.
// - 11 x 11 (every SSIM and MS-SSIM call of the default gaussian and uniform windows)
//   is compiled with the window sizes and the tile fixed, so both passes unroll and the
//   taps sit in registers; any other size runs the same code with them at run time.
// - Windows of any size: the rows window is taken in bands of at most 16 taps, and a
//   columns window wider than the pitch holds beside the tile (193 taps beside 64
//   columns) in chunks, each a staged input of its own. A band after the first
//   continues the rows-pass sums from the intermediate in shared memory, and a chunk
//   after the first continues the columns-pass sums from the output it wrote, so every
//   sum runs in tap order as in one pass.
// - Sums run in tap order from tap 0, as the TPU kernel's shift-and-add does; each
//   step is one fused multiply-add, so a value can differ from the plain version's
//   separate multiply and add by a float32 rounding. A NaN pixel makes every moment
//   whose window reads it NaN, as on the TPU.
// - The kernel allocates nothing, launches on the caller's stream and does not
//   synchronise.

#include <cuda_runtime.h>

#include "device_cache.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 16;        // output rows per tile
constexpr int kRowsPerItem = 8;   // rows pass: output rows one thread sums
constexpr int kSegments = kTileH / kRowsPerItem;
constexpr int kMinTileW = 64;     // output columns a tile keeps beside its columns window
constexpr int kNarrowTileW = 32;  // the narrowest tile, for a grid too small for the card
constexpr int kMaxBand = 16;      // rows-window taps per band
constexpr int kMoments = 5;
// the tile of the 11 x 11 instantiation, as the host's rule gives it for Kw = 11
constexpr int kPitch11 = 128;
constexpr int kTileW11 = 116;

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes from global to shared; `bytes` of them are read, the rest are zero-filled
__device__ __forceinline__ void copy4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(shared_address(dst)), "l"(src),
               "r"(bytes));
}
// 8 bytes from global to shared (both 8-byte aligned); `bytes` read, the rest zero-filled
__device__ __forceinline__ void copy8(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(shared_address(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

struct Geometry {
  int hp, wp, kh, kw, ho, wo;
  int pitch, tile_w, chunk;  // floats per shared row, output columns per tile, columns taps per chunk
  int tiles_h, tiles_w, bands, chunks;
};

// The tile's shape: fixed at compile time for the 11 x 11 instantiation (KW != 0)
template <int KW>
__device__ __forceinline__ int pitch_of(const Geometry& g) { return KW ? kPitch11 : g.pitch; }
template <int KW>
__device__ __forceinline__ int tile_w_of(const Geometry& g) { return KW ? kTileW11 : g.tile_w; }
template <int KW>
__device__ __forceinline__ int chunk_of(const Geometry& g) { return KW ? kPitch11 + 1 - kTileW11 : g.chunk; }

// One step of a tile: a columns chunk and a rows band of it.
struct Step {
  int chunk, band;
};

struct Tile {
  long long plane;
  int i0, j0;
};

template <int KW>
__device__ __forceinline__ Tile tile_of(long long t, const Geometry& g) {
  const long long per_plane = static_cast<long long>(g.tiles_h) * g.tiles_w;
  const long long plane = t / per_plane;
  const int rest = static_cast<int>(t - plane * per_plane);
  return {plane, (rest / g.tiles_w) * kTileH, (rest % g.tiles_w) * tile_w_of<KW>(g)};
}

// Copy the input rows and columns that one step reads into buf (p at buf, t at
// buf + rows_max * pitch). A row whose first pixel is 8-byte aligned in p and in t
// (every row when Wp is even and the planes start aligned) goes in 8-byte copies, any
// other in 4-byte copies.
template <int KW>
__device__ __forceinline__ void stage(const float* __restrict__ p, const float* __restrict__ t, const Tile& tile,
                                      Step s, const Geometry& g, int rows_max, float* buf) {
  const int pitch = pitch_of<KW>(g), max_chunk = chunk_of<KW>(g);
  const int a0 = s.band * kMaxBand, c0 = s.chunk * max_chunk;
  const int rows = kTileH + min(g.kh - a0, kMaxBand) - 1;
  const int cols = tile_w_of<KW>(g) + min(g.kw - c0, max_chunk) - 1;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < rows; r += kWarps) {
    const int gr = tile.i0 + a0 + r;
    // columns of this row inside the plane; j0 + c0 < Wp always
    const int in_plane = gr < g.hp ? min(cols, g.wp - (tile.j0 + c0)) : 0;
    const long long first = (tile.plane * g.hp + min(gr, g.hp - 1)) * static_cast<long long>(g.wp) + tile.j0 + c0;
    const float* prow = p + first;
    const float* trow = t + first;
    float* dp = buf + r * pitch;
    float* dt = buf + (rows_max + r) * pitch;
    // a zero-fill reads nothing; it names the row's first pixel, in the plane and aligned
    if (((reinterpret_cast<unsigned long long>(prow) | reinterpret_cast<unsigned long long>(trow)) & 7) == 0) {
      for (int col = 2 * lane; col < cols; col += 64) {
        const int left = in_plane - col;
        const int bytes = left >= 2 ? 8 : (left == 1 ? 4 : 0);
        copy8(dp + col, bytes ? prow + col : prow, bytes);
        copy8(dt + col, bytes ? trow + col : trow, bytes);
      }
    } else {
      for (int col = lane; col < cols; col += 32) {
        const int bytes = col < in_plane ? 4 : 0;
        copy4(dp + col, bytes ? prow + col : prow, bytes);
        copy4(dt + col, bytes ? trow + col : trow, bytes);
      }
    }
  }
}

// Rows pass of one step: inter[m][r][col] over this band's taps of wh.
template <int KH, int KW>
__device__ __forceinline__ void rows_pass(const float* buf, int rows_max, const float* wh, Step s,
                                          const Geometry& g, float* inter) {
  const int pitch = pitch_of<KW>(g);
  const int a0 = s.band * kMaxBand;
  const int taps = KH ? KH : min(g.kh - a0, kMaxBand);
  const int cols = tile_w_of<KW>(g) + (KW ? KW : min(g.kw - s.chunk * g.chunk, g.chunk)) - 1;
  float w[KH ? KH : 1];
  if (KH) {
#pragma unroll
    for (int a = 0; a < (KH ? KH : 1); ++a) w[a] = wh[a];
  }
  for (int item = threadIdx.x; item < kSegments * cols; item += kThreads) {
    const int seg = item / cols;
    const int col = item - seg * cols;
    const float* bp = buf + seg * kRowsPerItem * pitch + col;
    const float* bt = bp + rows_max * pitch;
    float* mine = inter + seg * kRowsPerItem * pitch + col;
    float sum[kMoments][kRowsPerItem];
#pragma unroll
    for (int m = 0; m < kMoments; ++m) {
#pragma unroll
      for (int r = 0; r < kRowsPerItem; ++r) sum[m][r] = (KH || a0 == 0) ? 0.0f : mine[(m * kTileH + r) * pitch];
    }
#pragma unroll
    for (int i = 0; i < kRowsPerItem + taps - 1; ++i) {
      const float x = bp[i * pitch], y = bt[i * pitch];
      const float v[kMoments] = {x, y, x * x, y * y, x * y};
#pragma unroll
      for (int r = 0; r < kRowsPerItem; ++r) {
        const int k = i - r;  // the tap (within the band) that input row i is for output row r
        if (k >= 0 && k < taps) {
          const float wk = KH ? w[KH ? k : 0] : wh[a0 + k];
#pragma unroll
          for (int m = 0; m < kMoments; ++m) sum[m][r] = fmaf(wk, v[m], sum[m][r]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMoments; ++m) {
#pragma unroll
      for (int r = 0; r < kRowsPerItem; ++r) mine[(m * kTileH + r) * pitch] = sum[m][r];
    }
  }
}

// Columns pass of one step: this chunk's taps of ww over the intermediate, into out.
// A thread takes 4 neighbouring outputs of one row and all five moments.
template <int KW>
__device__ __forceinline__ void columns_pass(const float* inter, const float* ww, const Tile& tile, Step s,
                                             const Geometry& g, float* __restrict__ out) {
  const int pitch = pitch_of<KW>(g), quads = tile_w_of<KW>(g) / 4;
  const int c0 = s.chunk * g.chunk;
  const int taps = KW ? KW : min(g.kw - c0, g.chunk);
  const long long out_plane = static_cast<long long>(g.ho) * g.wo;
  float w[KW ? KW : 1];
  if (KW) {
#pragma unroll
    for (int b = 0; b < (KW ? KW : 1); ++b) w[b] = ww[b];
  }
  for (int item = threadIdx.x; item < kTileH * quads; item += kThreads) {
    const int r = item / quads;
    const int q = item - r * quads;
    const int oi = tile.i0 + r, oj = tile.j0 + 4 * q;
    if (oi >= g.ho || oj >= g.wo) continue;
    const int valid = min(4, g.wo - oj);
    float* o = out + tile.plane * kMoments * out_plane + static_cast<long long>(oi) * g.wo + oj;
#pragma unroll
    for (int m = 0; m < kMoments; ++m, o += out_plane) {
      const float* row = inter + (m * kTileH + r) * pitch + 4 * q;
      float acc[4];
      if (KW) {
        float v[4 * ((KW + 6) / 4)];
#pragma unroll
        for (int b = 0; b < (KW + 6) / 4; ++b) {
          const float4 f = reinterpret_cast<const float4*>(row)[b];
          v[4 * b] = f.x;
          v[4 * b + 1] = f.y;
          v[4 * b + 2] = f.z;
          v[4 * b + 3] = f.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j] = 0.0f;
#pragma unroll
          for (int b = 0; b < (KW ? KW : 1); ++b) acc[j] = fmaf(w[b], v[j + b], acc[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = (c0 == 0 || j >= valid) ? 0.0f : o[j];
        // acc[j] += ww[c0 + b] * row[j + b]: row[b .. b + 3] held in v0 .. v3
        float v0 = row[0], v1 = row[1], v2 = row[2];
        for (int b = 0; b < taps; ++b) {
          const float wb = ww[c0 + b], v3 = row[b + 3];
          acc[0] = fmaf(wb, v0, acc[0]);
          acc[1] = fmaf(wb, v1, acc[1]);
          acc[2] = fmaf(wb, v2, acc[2]);
          acc[3] = fmaf(wb, v3, acc[3]);
          v0 = v1;
          v1 = v2;
          v2 = v3;
        }
      }
      if (valid == 4 && (reinterpret_cast<unsigned long long>(o) & 15) == 0) {
        __stcs(reinterpret_cast<float4*>(o), make_float4(acc[0], acc[1], acc[2], acc[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < valid) __stcs(o + j, acc[j]);
        }
      }
    }
  }
}

// Dynamic shared memory: wh [Kh rounded up to 4], ww [Kw rounded up to 4], the
// intermediate [5][16][pitch], then the staged input of p and t [2][rows_max][pitch]. A
// tile's next step's input is copied in as soon as this step's rows pass has read the
// buffer, so the copy runs under this step's columns pass (and under the other blocks
// on the SM: 67.7 KB and at most 80 registers a thread let three blocks share an SM at
// 11 x 11). One block per tile.
template <int KH, int KW>
__global__ void __launch_bounds__(kThreads, 3)
    ssim_moments_kernel(const float* __restrict__ p, const float* __restrict__ t, const float* __restrict__ wh,
                        const float* __restrict__ ww, Geometry g, int rows_max, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int kh4 = (g.kh + 3) & ~3, kw4 = (g.kw + 3) & ~3;
  float* s_wh = smem;
  float* s_ww = s_wh + kh4;
  float* inter = s_ww + kw4;
  float* buf = inter + kMoments * kTileH * pitch_of<KW>(g);

  const Tile tile = tile_of<KW>(blockIdx.x, g);
  for (int a = threadIdx.x; a < g.kh; a += kThreads) s_wh[a] = wh[a];
  for (int b = threadIdx.x; b < g.kw; b += kThreads) s_ww[b] = ww[b];
  Step cur = {0, 0};
  stage<KW>(p, t, tile, cur, g, rows_max, buf);
  commit();
  while (true) {
    wait_all();
    __syncthreads();  // this step's input (and the taps) are in shared memory
    rows_pass<KH, KW>(buf, rows_max, s_wh, cur, g, inter);
    __syncthreads();  // the intermediate is complete and the input buffer is free
    const bool last_band = cur.band == g.bands - 1, last = last_band && cur.chunk == g.chunks - 1;
    const Step nxt = last_band ? Step{cur.chunk + 1, 0} : Step{cur.chunk, cur.band + 1};
    if (!last) {
      stage<KW>(p, t, tile, nxt, g, rows_max, buf);
      commit();
    }
    // the next step's rows pass writes the intermediate only after the barrier that
    // follows its wait, so this columns pass reads it undisturbed
    if (last_band) columns_pass<KW>(inter, s_ww, tile, cur, g, out);
    if (last) break;
    cur = nxt;
  }
}

template <int KH, int KW>
cudaError_t launch(const float* p, const float* t, const float* wh, const float* ww, const Geometry& g,
                   long long tiles, cudaStream_t stream, float* out) {
  if (KW && (g.pitch != kPitch11 || g.tile_w != kTileW11)) return cudaErrorInvalidValue;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;  // one block per tile in a 1D grid
  const int rows_max = kTileH + (g.kh < kMaxBand ? g.kh : kMaxBand) - 1;
  const size_t shared = (static_cast<size_t>((g.kh + 3) & ~3) + ((g.kw + 3) & ~3) +
                         static_cast<size_t>(kMoments * kTileH + 2 * rows_max) * g.pitch) *
                        sizeof(float);
  // the opt-in above 48 KB, once per device for the largest size so far
  static size_t shared_set[tmk::kMaxDevices] = {};
  int device = 0;
  cudaGetDevice(&device);
  if (device < 0 || device >= tmk::kMaxDevices) return cudaErrorInvalidDevice;
  if (shared > shared_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssim_moments_kernel<KH, KW>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return err;
    shared_set[device] = shared;
  }
  ssim_moments_kernel<KH, KW><<<static_cast<unsigned>(tiles), kThreads, shared, stream>>>(p, t, wh, ww, g,
                                                                                        rows_max, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// p, t: float32 [P, Hp, Wp]; wh: float32 [Kh]; ww: float32 [Kw]; all on the card and
// contiguous. out: float32 [P, 5, Ho, Wo] with Ho = Hp - Kh + 1 >= 1, Wo = Wp - Kw + 1
// >= 1. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for shapes
// it cannot take).
int tm_ssim_moments(const void* p, const void* t, const void* wh, const void* ww, long long planes, int hp,
                    int wp, int kh, int kw, void* out, void* stream) {
  if (planes <= 0) return 0;
  Geometry g;
  g.hp = hp;
  g.wp = wp;
  g.kh = kh;
  g.kw = kw;
  g.ho = hp - kh + 1;
  g.wo = wp - kw + 1;
  if (kh < 1 || kw < 1 || g.ho < 1 || g.wo < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the smallest pitch whose tile keeps kMinTileW output columns beside the whole
  // columns window; past 256 floats, the window in chunks beside kMinTileW columns
  constexpr int kPitches[] = {128, 192, 256};
  g.tile_w = kMinTileW;
  for (const int pitch : kPitches) {
    if ((pitch + 1 - kw) / 4 * 4 >= kMinTileW) {
      g.tile_w = (pitch + 1 - kw) / 4 * 4;
      break;
    }
  }
  g.tiles_h = (g.ho + kTileH - 1) / kTileH;
  g.tiles_w = (g.wo + g.tile_w - 1) / g.tile_w;
  const bool fixed = kh == 11 && kw == 11;  // the instantiation with the 128 / 116 tile
  if (!fixed) {
    const long long enough = 2LL * tmk::sm_count();
    while (g.tile_w > kNarrowTileW && planes * g.tiles_h * g.tiles_w < enough) {
      g.tile_w = (g.tile_w / 2) & ~3;
      if (g.tile_w < kNarrowTileW) g.tile_w = kNarrowTileW;
      g.tiles_w = (g.wo + g.tile_w - 1) / g.tile_w;
    }
  }
  g.pitch = 256;
  for (const int pitch : kPitches) {
    if (pitch + 1 - g.tile_w >= kw) {
      g.pitch = pitch;
      break;
    }
  }
  g.chunk = g.pitch + 1 - g.tile_w;
  g.bands = (kh + kMaxBand - 1) / kMaxBand;
  g.chunks = (kw + g.chunk - 1) / g.chunk;
  const long long tiles = planes * g.tiles_h * g.tiles_w;
  const auto* pf = static_cast<const float*>(p);
  const auto* tf = static_cast<const float*>(t);
  const auto* whf = static_cast<const float*>(wh);
  const auto* wwf = static_cast<const float*>(ww);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (kh == 11 && kw == 11) return static_cast<int>(launch<11, 11>(pf, tf, whf, wwf, g, tiles, s, o));
  return static_cast<int>(launch<0, 0>(pf, tf, whf, wwf, g, tiles, s, o));
}

const char* tm_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
