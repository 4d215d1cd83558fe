// Edge-replicated separable blur of fp32 (planes, H, W) fields: a 1-D
// correlation with the same odd-length taps along W, then along H.
//
// Replaces the TPU kernel predict_pv_yield_tpu/ops/pallas_blur.py
// sep_blur_pallas (body _blur_kernel), whose function the JAX flow solver
// computes through _sep_blur_xla_batched: the window average of the five
// Farneback accumulator fields [g11, g12, g22, h1, h2] in _update_flow,
// 41 taps at winsize 40, three times per pyramid level.
//
// Bound on an H100 SXM: per output element it reads 4 B, writes 4 B and
// does 2 * taps FMAs (164 flop at 41 taps), so 8 B against 164 flop; at
// 3.35 TB/s and 67 TFLOP/s fp32 the two limits are about equal (the blur is
// balanced). The TPU form (banded matmuls on the MXU) spent W / taps times
// the useful flops; here each tap is one FMA.
//
// Design (right and simple; not tuned):
//  * one block per (plane, TILE_H x TILE_W output tile);
//  * the tile plus its r-wide halo is staged in shared memory, with edge
//    replication done by clamping the source index, so no padded copy of
//    the input is ever written to device memory;
//  * the W pass writes a second shared buffer ((TILE_H + 2r) x TILE_W), the
//    H pass reads it and writes the output; the intermediate never leaves
//    the SM;
//  * taps travel by value in the kernel's parameter block (__grid_constant__,
//    so the indexed reads come from the constant bank, uniform across the
//    warp), any odd count up to kMaxTaps;
//  * ragged H and W are masked at the store.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 64;
constexpr int kTileH = 32;
constexpr int kThreads = 256;
constexpr int kMaxTaps = 65;  // radius <= 32
constexpr int kMaxPlanesPerLaunch = 65535;  // gridDim.z limit

struct Taps {
  float w[kMaxTaps];
};

size_t shared_bytes(int radius) {
  const int staged_h = kTileH + 2 * radius;
  const int staged_w = kTileW + 2 * radius;
  return sizeof(float) * (size_t(staged_h) * staged_w + size_t(staged_h) * kTileW);
}

__global__ void __launch_bounds__(kThreads)
sep_blur_kernel(const float* __restrict__ in, float* __restrict__ out,
                int height, int width, int radius,
                const __grid_constant__ Taps taps) {
  extern __shared__ float smem[];
  const int n_taps = 2 * radius + 1;
  const int staged_h = kTileH + 2 * radius;
  const int staged_w = kTileW + 2 * radius;
  float* stage = smem;                               // staged_h x staged_w
  float* rows = smem + staged_h * staged_w;          // staged_h x kTileW

  const size_t plane_size = size_t(height) * width;
  const float* src = in + blockIdx.z * plane_size;
  float* dst = out + blockIdx.z * plane_size;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;

  // stage tile + halo; clamped indices replicate the edges
  for (int i = threadIdx.x; i < staged_h * staged_w; i += kThreads) {
    const int sy = i / staged_w;
    const int sx = i - sy * staged_w;
    const int gy = min(max(y0 + sy - radius, 0), height - 1);
    const int gx = min(max(x0 + sx - radius, 0), width - 1);
    stage[i] = src[size_t(gy) * width + gx];
  }
  __syncthreads();

  // W pass over every staged row (the H pass needs the halo rows too)
  for (int i = threadIdx.x; i < staged_h * kTileW; i += kThreads) {
    const int sy = i / kTileW;
    const int tx = i - sy * kTileW;
    const float* row = stage + sy * staged_w + tx;
    float acc = 0.0f;
    for (int k = 0; k < n_taps; ++k) acc = fmaf(taps.w[k], row[k], acc);
    rows[i] = acc;
  }
  __syncthreads();

  // H pass, masked store for ragged tiles
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int ty = i / kTileW;
    const int tx = i - ty * kTileW;
    const int gy = y0 + ty;
    const int gx = x0 + tx;
    if (gy >= height || gx >= width) continue;
    const float* col = rows + ty * kTileW + tx;
    float acc = 0.0f;
    for (int k = 0; k < n_taps; ++k) acc = fmaf(taps.w[k], col[k * kTileW], acc);
    dst[size_t(gy) * width + gx] = acc;
  }
}

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
  const int radius = n_taps / 2;
  const size_t smem = shared_bytes(radius);
  cudaError_t err = cudaFuncSetAttribute(
      sep_blur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t plane_size = size_t(height) * width;
  const dim3 block(kThreads);
  for (long long first = 0; first < planes; first += kMaxPlanesPerLaunch) {
    const long long count =
        planes - first < kMaxPlanesPerLaunch ? planes - first : kMaxPlanesPerLaunch;
    const dim3 grid((width + kTileW - 1) / kTileW,
                    (height + kTileH - 1) / kTileH, unsigned(count));
    sep_blur_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
        in + first * plane_size, out + first * plane_size, height, width,
        radius, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
