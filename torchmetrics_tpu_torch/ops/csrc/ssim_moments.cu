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
// Bound: it reads 2 * P * Hp * Wp floats and writes 5 * P * Ho * Wo, about 25 FMAs
// per output at an 11x11 window, so it is bound by the card's memory rate (at
// P = 12, 1366 x 2050, 11 x 11: 0.28 ms for the bytes, 0.11 ms for the FMAs at the
// float32 rate). The point of the kernel is that the three product planes, and the
// rows-pass intermediate, never reach device memory: the library route (the products
// stacked into a [5P, ...] tensor, then a convolution) writes and reads them.
//
// Design:
// - A plane has no VMEM-sized budget here, so the kernel tiles it: each block takes
//   one plane and a 32 x 32 tile of outputs. Blocks are numbered over (plane, tile
//   row, tile column) in one grid dimension, so any P and any plane size launch.
// - Rows pass: a thread takes one column of the tile's input (the tile's 32 columns
//   plus the Kw - 1 columns of the window's reach) and 8 consecutive output rows. It
//   reads the 8 + Kh - 1 input pixels of p and t it needs once, from device memory
//   (neighbouring threads on neighbouring columns, so the loads coalesce), forms the
//   three products in registers, and keeps the 5 x 8 partial sums in registers. It
//   writes them to a shared buffer [5][32][32 + Kw - 1].
// - Columns pass: each thread owns 4 rows of one output column (a warp covers 32
//   neighbouring columns, so the shared reads are free of bank conflicts) and sums
//   the window along the row from the shared buffer, then writes its 5 x 4 outputs.
// - Windows of any width: the columns window is taken in chunks of at most
//   kMaxChunk = 71 taps (a sigma = 10 gaussian in one chunk). For a chunk the block
//   recomputes the rows pass for the columns that chunk reaches, and the columns
//   pass adds the chunk's taps to sums kept in registers across chunks, in tap order,
//   so the sums are those of one pass. The shared buffer is at most
//   5 * 32 * (32 + 71 - 1) * 4 = 65,280 bytes; above 48 KB the launch opts into it.
//   The rows window has no limit: its taps are read from device memory in the loop.
// - The window taps are read with __ldg: every thread of a warp reads the same tap,
//   which the cache broadcasts.
// - Sums run in tap order from tap 0, as the TPU kernel's shift-and-add does; each
//   step is one fused multiply-add, so a value can differ from the plain version's
//   separate multiply and add by a float32 rounding. A NaN pixel makes every moment
//   whose window reads it NaN, as on the TPU.
// - An input pixel outside the plane (a tile at the ragged edge) is read as 0; it
//   reaches only outputs outside [Ho, Wo], which are not written.
// - The kernel allocates nothing, launches on the caller's stream and does not
//   synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;          // output columns per block: one per lane
constexpr int kTileH = 32;          // output rows per block
constexpr int kThreads = 256;       // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerItem = 8;     // rows pass: output rows one thread sums at once
constexpr int kSegments = kTileH / kRowsPerItem;
constexpr int kRowsPerThread = kTileH / kWarps;  // columns pass: output rows per thread
constexpr int kMaxChunk = 71;       // columns-window taps per chunk
constexpr int kMoments = 5;
constexpr int kDefaultSharedBytes = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
    ssim_moments_kernel(const float* __restrict__ p, const float* __restrict__ t,
                        const float* __restrict__ wh, const float* __restrict__ ww, int hp, int wp,
                        int kh, int kw, int ho, int wo, int tiles_h, int tiles_w, int chunk,
                        float* __restrict__ out) {
  extern __shared__ float rows[];  // [kMoments][kTileH][kTileW + chunk - 1]
  const int width = kTileW + chunk - 1;
  const long long tiles = static_cast<long long>(tiles_h) * tiles_w;
  const long long plane = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x - plane * tiles);
  const int i0 = (tile / tiles_w) * kTileH;
  const int j0 = (tile % tiles_w) * kTileW;
  const long long plane_size = static_cast<long long>(hp) * wp;
  const float* pp = p + plane * plane_size;
  const float* tp = t + plane * plane_size;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  float acc[kMoments][kRowsPerThread];
#pragma unroll
  for (int m = 0; m < kMoments; ++m) {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[m][r] = 0.0f;
  }

  for (int c0 = 0; c0 < kw; c0 += chunk) {
    const int taps = kw - c0 < chunk ? kw - c0 : chunk;
    const int cols = kTileW + taps - 1;

    // rows pass over wh into rows[m][r][col] for the columns this chunk reaches
    for (int item = threadIdx.x; item < kSegments * cols; item += kThreads) {
      const int seg = item / cols;
      const int col = item - seg * cols;
      const int gc = j0 + c0 + col;
      const int r0 = i0 + seg * kRowsPerItem;
      float sum[kMoments][kRowsPerItem];
#pragma unroll
      for (int m = 0; m < kMoments; ++m) {
#pragma unroll
        for (int r = 0; r < kRowsPerItem; ++r) sum[m][r] = 0.0f;
      }
      const bool col_in = gc < wp;
      for (int i = 0; i < kRowsPerItem + kh - 1; ++i) {
        const int gr = r0 + i;
        float x = 0.0f, y = 0.0f;
        if (col_in && gr < hp) {
          const long long at = static_cast<long long>(gr) * wp + gc;
          x = pp[at];
          y = tp[at];
        }
        const float v[kMoments] = {x, y, x * x, y * y, x * y};
#pragma unroll
        for (int r = 0; r < kRowsPerItem; ++r) {
          const int k = i - r;  // the tap that input row i is for output row r
          if (k >= 0 && k < kh) {
            const float w = __ldg(wh + k);
#pragma unroll
            for (int m = 0; m < kMoments; ++m) sum[m][r] = fmaf(w, v[m], sum[m][r]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kMoments; ++m) {
#pragma unroll
        for (int r = 0; r < kRowsPerItem; ++r) {
          rows[(m * kTileH + seg * kRowsPerItem + r) * width + col] = sum[m][r];
        }
      }
    }
    __syncthreads();

    // columns pass over this chunk's taps of ww
    for (int k = 0; k < taps; ++k) {
      const float w = __ldg(ww + c0 + k);
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr) {
        const int r = warp + rr * kWarps;
#pragma unroll
        for (int m = 0; m < kMoments; ++m) {
          acc[m][rr] = fmaf(w, rows[(m * kTileH + r) * width + lane + k], acc[m][rr]);
        }
      }
    }
    __syncthreads();  // the next chunk's rows pass overwrites the buffer
  }

  const int oj = j0 + lane;
  if (oj >= wo) return;
  const long long out_plane = static_cast<long long>(ho) * wo;
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int oi = i0 + warp + rr * kWarps;
    if (oi < ho) {
#pragma unroll
      for (int m = 0; m < kMoments; ++m) {
        out[(plane * kMoments + m) * out_plane + static_cast<long long>(oi) * wo + oj] = acc[m][rr];
      }
    }
  }
}

}  // namespace

extern "C" {

// p, t: float32 [P, Hp, Wp]; wh: float32 [Kh]; ww: float32 [Kw]; all on the card and
// contiguous. out: float32 [P, 5, Ho, Wo] with Ho = Hp - Kh + 1 >= 1, Wo = Wp - Kw + 1
// >= 1. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for shapes
// it cannot take).
int tm_ssim_moments(const void* p, const void* t, const void* wh, const void* ww, long long planes,
                    int hp, int wp, int kh, int kw, void* out, void* stream) {
  if (planes <= 0) return 0;
  const int ho = hp - kh + 1;
  const int wo = wp - kw + 1;
  if (kh < 1 || kw < 1 || ho < 1 || wo < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_h = (ho + kTileH - 1) / kTileH;
  const int tiles_w = (wo + kTileW - 1) / kTileW;
  const long long blocks = planes * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = kw < kMaxChunk ? kw : kMaxChunk;
  const size_t shared = static_cast<size_t>(kMoments) * kTileH * (kTileW + chunk - 1) * sizeof(float);
  if (shared > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssim_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssim_moments_kernel<<<static_cast<unsigned>(blocks), kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(t), static_cast<const float*>(wh),
      static_cast<const float*>(ww), hp, wp, kh, kw, ho, wo, tiles_h, tiles_w, chunk,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* tm_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
