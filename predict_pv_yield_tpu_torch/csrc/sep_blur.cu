// Edge-replicated separable blur of fp32 (planes, H, W) fields: a 1-D
// correlation with the same odd-length taps along W, then along H.
//
// Replaces the TPU kernel predict_pv_yield_tpu/ops/pallas_blur.py:103
// sep_blur_pallas (body _blur_kernel), whose function the JAX flow solver
// computes through _sep_blur_xla_batched: the window average of the five
// Farneback accumulator fields [g11, g12, g22, h1, h2] in _update_flow,
// 41 taps at winsize 40, three times per pyramid level.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): per output it reads 4 B, writes 4 B and does 2 * taps FMAs, so
// 8 B against 4 * taps flop. At 41 taps and (48, 5, 256, 256) that is
// 37.6 us for the bytes and 38.5 us for the operations: the kernel has to
// move each byte once and keep the FMA pipe busy.
//
// Design, and what each part does about that limit:
//  * FP32 FMAs on the CUDA cores, not a banded product on the tensor cores:
//    TF32 keeps about three decimal digits (too few for the flow solver),
//    and a 3xTF32 split triples the work on top of the band's zeros.
//  * The radius is a template parameter, one instantiation per radius
//    0..kMaxRadius, picked by radius alone. Both tap loops unroll fully, so
//    each tap is one FFMA with its weight as a uniform operand: no load, no
//    loop overhead.
//  * Register blocking. A thread emits a strip of outputs: kBandH (32) down
//    a column in the H pass, kStripW (16) along a row in the W pass. Each
//    input it loads goes into every output of the strip whose window holds
//    it, so a strip of S outputs costs S + 2r loads, not S * (2r + 1): at
//    r = 20, 2.25 loads per output in the H pass and 3.5 words (read 16 B
//    at a time) in the W pass, against 41 FFMAs in each.
//  * The H pass runs first, straight from device memory: a warp's lanes
//    take neighbouring columns, so every load is one coalesced row segment,
//    and a load inside the plane costs one address instruction (the pointer
//    walks down the column). Only the H-passed band (32 rows) is kept in
//    shared memory. The halo rows are loaded again by the next band (from
//    L1 or L2) but never computed twice: the H pass does no halo FMAs.
//  * Wide tiles: a block owns up to 256 columns, the whole width of a plane
//    up to 256, so the W pass's column halo costs no FMAs either. Columns
//    outside the plane are copies of its edge columns, filled in shared
//    memory after the H pass. Narrow planes take several bands at once so
//    that the block's threads have work.
//  * The W pass writes its strips into a shared tile, and the tile goes out
//    in coalesced rows: a thread's 16 outputs lie in one row, and writing
//    them from registers would scatter each store over 32 rows.
//  * Index arithmetic stays out of the inner loops: shared-memory offsets
//    are immediates, and the only runtime divisions are one per task (16 or
//    32 outputs).
//  * At r = 20 a block of 256 threads holds 72 KB of shared memory (band
//    and tile) and at most 80 registers a thread: three blocks share an SM.

#include <cuda_runtime.h>

#include <algorithm>
#include <array>
#include <atomic>
#include <utility>

namespace {

constexpr int kMaxRadius = 32;
constexpr int kMaxTaps = 2 * kMaxRadius + 1;
constexpr int kMaxPlanesPerLaunch = 65535;  // gridDim.z limit

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBandH = 32;  // rows of a band: outputs per H-pass task, down a column
constexpr int kStripW = 16;  // outputs per W-pass task, along a row
constexpr int kMaxTileW = 256;  // output columns per block, at most
constexpr int kMaxBands = 4;  // bands per iteration, at most
// fewer tiles than this (about 2.6 waves of 3 blocks on 132 SMs) cut the
// plane height into several walks
constexpr long long kTargetBlocks = 1024;

struct Taps {
  float w[kMaxTaps];
};

// Where a block works, fixed per launch.
struct Geometry {
  int tile_w;  // output columns per tile, a multiple of kStripW
  int bands;  // bands of kBandH rows per iteration
  int pitch;  // floats per row of the H-passed band in shared memory
  int walk_h;  // output rows per block, a multiple of kBandH * bands
};

// One H-pass task: rows [top + R, top + R + kBandH) of one column, written
// down a column of the band. With kClamp, rows outside the plane read its
// edge rows; without, the window lies inside the plane and the loads walk
// one pointer down the column (one integer instruction per load, where the
// clamped address takes five).
template <int R, bool kClamp>
__device__ __forceinline__ void h_strip(const float* __restrict__ col, int top, int height,
                                        int width, const Taps& taps, float* cell,
                                        int pitch) {
  constexpr int kTaps = 2 * R + 1;
  const float* row = col + size_t(max(top, 0)) * width;
  float acc[kBandH] = {};
#pragma unroll
  for (int p = 0; p < kBandH + 2 * R; ++p) {
    const float v = kClamp ? __ldg(col + size_t(min(max(top + p, 0), height - 1)) * width)
                           : __ldg(row);
    row += width;
#pragma unroll
    for (int j = 0; j < kBandH; ++j) {
      const int k = p - j;
      if (k >= 0 && k < kTaps) acc[j] = fmaf(taps.w[k], v, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kBandH; ++j) cell[j * pitch] = acc[j];
}

template <int R>
__global__ void __launch_bounds__(kThreads, 3)
sep_blur_kernel(const float* __restrict__ in, float* __restrict__ out,
                int height, int width, const Geometry g,
                const __grid_constant__ Taps taps) {
  constexpr int kTaps = 2 * R + 1;
  // Column c of `band` holds plane column x0 - R + c, H-passed; `tile`
  // holds the finished outputs of the band.
  extern __shared__ __align__(16) float band[];
  const int tile_pitch = g.tile_w + 4;
  float* tile = band + kBandH * g.bands * g.pitch;

  const size_t plane_size = size_t(height) * width;
  const float* src = in + blockIdx.z * plane_size;
  float* dst = out + blockIdx.z * plane_size;
  const int x0 = blockIdx.x * g.tile_w;
  const int tw = min(g.tile_w, width - x0);  // output columns of this tile
  const int hc0 = max(x0 - R, 0);  // plane columns the H pass covers
  const int n_hc = min(x0 + tw + R, width) - hc0;
  const int c_lo = hc0 - (x0 - R);  // their band columns: [c_lo, c_hi)
  const int c_hi = c_lo + n_hc;
  const int n_fill = c_lo + (tw + 2 * R - c_hi);  // band columns outside the plane
  const int rows = kBandH * g.bands;
  const int n_strips = (tw + kStripW - 1) / kStripW;
  const int y_begin = blockIdx.y * g.walk_h;
  const int y_end = min(y_begin + g.walk_h, height);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int y = y_begin; y < y_end; y += rows) {
    // H pass: task t takes column hc0 + c of band b
    for (int t = threadIdx.x; t < g.bands * n_hc; t += kThreads) {
      const int b = t / n_hc;
      const int c = t - b * n_hc;
      const int top = y + b * kBandH - R;
      float* cell = band + b * kBandH * g.pitch + c_lo + c;
      if (top >= 0 && top + kBandH + 2 * R <= height) {
        h_strip<R, false>(src + hc0 + c, top, height, width, taps, cell, g.pitch);
      } else {
        h_strip<R, true>(src + hc0 + c, top, height, width, taps, cell, g.pitch);
      }
    }
    __syncthreads();

    // band columns outside the plane repeat its edge columns
    if (n_fill > 0) {
      for (int r = warp; r < rows; r += kWarps) {
        float* line = band + r * g.pitch;
        for (int f = lane; f < n_fill; f += 32) {
          line[f < c_lo ? f : c_hi + f - c_lo] = line[f < c_lo ? c_lo : c_hi - 1];
        }
      }
      __syncthreads();
    }

    // W pass into `tile`: task t takes row t % rows, columns [16 s, 16 s + 16)
    // with s = t / rows, so the 8 lanes of a quarter-warp touch 8 rows
    // (distinct banks: both pitches / 4 are odd)
    for (int t = threadIdx.x; t < rows * n_strips; t += kThreads) {
      const int s = t / rows;
      const int r = t - s * rows;
      const float4* window =
          reinterpret_cast<const float4*>(band + r * g.pitch + s * kStripW);
      float acc[kStripW] = {};
#pragma unroll
      for (int q = 0; q < (kStripW + 2 * R + 3) / 4; ++q) {
        const float4 v4 = window[q];
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int j = 0; j < kStripW; ++j) {
            const int k = 4 * q + e - j;
            if (k >= 0 && k < kTaps) acc[j] = fmaf(taps.w[k], v[e], acc[j]);
          }
        }
      }
      float4* cell = reinterpret_cast<float4*>(tile + r * tile_pitch + s * kStripW);
#pragma unroll
      for (int j = 0; j < kStripW / 4; ++j) {
        cell[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    __syncthreads();

    // coalesced store of the finished rows
    for (int r = warp; r < rows && y + r < y_end; r += kWarps) {
      float* o = dst + size_t(y + r) * width + x0;
      for (int c = lane; c < tw; c += 32) o[c] = tile[r * tile_pitch + c];
    }
    __syncthreads();
  }
}

// The tiling of a (height, width) plane for radius r: the fewest tiles of
// at most kMaxTileW columns; bands enough that the H pass has work for the
// block's threads; walks short enough for kTargetBlocks blocks.
Geometry geometry(long long planes, int height, int width, int r) {
  Geometry g;
  const int tiles = (width + kMaxTileW - 1) / kMaxTileW;
  g.tile_w = ((width + tiles - 1) / tiles + kStripW - 1) / kStripW * kStripW;
  // the W pass reads up to 4 * ceil((kStripW + 2r) / 4) columns from a
  // strip's start; (pitch / 4) odd
  g.pitch = g.tile_w - kStripW + (kStripW + 2 * r + 3) / 4 * 4;
  if ((g.pitch / 4) % 2 == 0) g.pitch += 4;
  const int n_hc = std::min(g.tile_w + 2 * r, width);
  const int height_bands = (height + kBandH - 1) / kBandH;
  g.bands = 1;
  while (2 * g.bands <= kMaxBands && 2 * g.bands * n_hc <= kThreads &&
         g.bands < height_bands) {
    g.bands *= 2;
  }
  const int rows = kBandH * g.bands;
  const int steps = (height + rows - 1) / rows;
  const long long strips = tiles * std::min<long long>(planes, kMaxPlanesPerLaunch);
  const long long walks = std::min<long long>(
      steps, std::max<long long>(1, (kTargetBlocks + strips - 1) / strips));
  g.walk_h = int((steps + walks - 1) / walks) * rows;
  return g;
}

template <int R>
cudaError_t launch(const float* in, float* out, long long planes, int height,
                   int width, const Taps& taps, cudaStream_t stream) {
  const Geometry g = geometry(planes, height, width, R);
  const size_t smem =
      sizeof(float) * size_t(kBandH) * g.bands * (g.pitch + g.tile_w + 4);
  if (smem > 48 * 1024) {
    // the opt-in to more than 48 KB of shared memory, once per device
    static std::atomic<unsigned long long> configured{0};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = device < 64 ? 1ull << device : 0;
    if (!(configured.load() & bit)) {
      int optin = 0;
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(sep_blur_kernel<R>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      if (err != cudaSuccess) return err;
      configured.fetch_or(bit);
    }
  }

  const size_t plane_size = size_t(height) * width;
  for (long long first = 0; first < planes; first += kMaxPlanesPerLaunch) {
    const long long count =
        planes - first < kMaxPlanesPerLaunch ? planes - first : kMaxPlanesPerLaunch;
    const dim3 grid((width + g.tile_w - 1) / g.tile_w,
                    (height + g.walk_h - 1) / g.walk_h, unsigned(count));
    sep_blur_kernel<R><<<grid, kThreads, smem, stream>>>(
        in + first * plane_size, out + first * plane_size, height, width, g, taps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

using Launcher = cudaError_t (*)(const float*, float*, long long, int, int,
                                 const Taps&, cudaStream_t);

template <int... Rs>
constexpr std::array<Launcher, sizeof...(Rs)> launchers(std::integer_sequence<int, Rs...>) {
  return {{&launch<Rs>...}};
}

// one launcher per radius 0..kMaxRadius
constexpr auto kLaunchers = launchers(std::make_integer_sequence<int, kMaxRadius + 1>());

}  // namespace

extern "C" {

int sep_blur_max_taps() { return kMaxTaps; }

const char* sep_blur_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronise. `taps` is a host array of n_taps floats.
int sep_blur_f32(const float* in, float* out, long long planes, int height,
                 int width, const float* taps, int n_taps, void* stream) {
  if (planes < 0 || height <= 0 || width <= 0 || n_taps < 1 ||
      n_taps > kMaxTaps || n_taps % 2 == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (planes == 0) return 0;
  Taps t = {};
  for (int k = 0; k < n_taps; ++k) t.w[k] = taps[k];
  return static_cast<int>(kLaunchers[n_taps / 2](
      in, out, planes, height, width, t, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
