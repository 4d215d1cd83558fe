// Weight and bias gradients of a 3x3x3 fp32 convolution, stride 1, zero
// padding of 0 or 1 in each dimension, NCDHW:
//
//   dW[co, ci, kt, kh, kw] = sum_{n,t,h,w} dY[n, co, t, h, w] * x_pad[n, ci, t+kt, h+kh, w+kw]
//   db[co]                 = sum_{n,t,h,w} dY[n, co, t, h, w]
//
// Replaces no TPU kernel: the JAX package leaves the towers' gradients to
// XLA. It is added because cuDNN's fp32 3-D weight gradient ran at 9 % of
// its bound on an H100 and took 60 % of the conv3d_sat_nwp train step.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores, 3.35
// TB/s): as a GEMM, M = C_out, N = C_in * 27 and K = N * T * H * W output
// positions, 2 * M * N * K flop, against one read of x and dY. The twelve
// tower layers of a conv3d_sat_nwp step (batch 32) are 201.3 GFLOP (3.00
// ms) against ~1.1 GB (0.33 ms): compute-bound, on FP32 FMAs (TF32 fails
// the towers' gradient limits). K is huge and the output tiny, so the
// design is a split-K reduction, not a tiled GEMM.
//
// Design, and what each part does about that limit:
//  * FP32 FFMA only; every multiply-add is one FFMA.
//  * A block owns all 32 output channels of a chunk and 16 or 32 input
//    channels times all 27 taps, and walks a contiguous run of output rows
//    (n, t, h): the split-K. The grid is one full wave of resident blocks
//    (SMs x blocks per SM), each taking an equal share of the rows, so
//    every SM works to the end and no tail wave runs half empty.
//  * A thread owns a 4 (co) x 2 (ci) x 3 (kt) x 3 (kw) register tile for
//    one kh: 72 accumulators. Along a row it keeps a sliding window of
//    three input columns per plane in registers, so each step loads one
//    float4 of dY and three float2 of x from shared memory for 72 FFMAs.
//    Each x element in shared memory serves all 27 taps across the threads.
//  * Shared memory holds, channel-innermost, a ring of four input rows for
//    each of the three time planes (three in use, one loading) and two dY
//    rows. Walking down the rows of one (n, t), the next row needs one new
//    input row per plane: cp.async copies it (4 bytes an element, zero-
//    filled where the padding lies, transposed to channel-innermost on the
//    way) while the block computes the current row. Row pitches of 20 or 36
//    floats keep the transposing writes and the float2 / float4 reads free
//    of bank conflicts.
//  * Each block writes its partial dW and db to a scratch buffer; a second
//    kernel sums the partials in a fixed order. No atomics: the result is
//    bit-identical from run to run.
//  * The kernel allocates nothing and does not synchronise, so a CUDA graph
//    captures it.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

#include "conv3d_common.cuh"

namespace {

constexpr int kCoChunk = 32;  // output channels of a block
constexpr int kCoGroups = kCoChunk / 4;  // a thread owns 4 output channels
constexpr int kRing = 4;  // input rows per plane in shared memory
constexpr int kCoPitch = kCoChunk + 4;  // floats per column of a dY row
constexpr int kMaxTileW = 64;  // output columns per row tile, at most
constexpr int kReduceCols = 32;
constexpr int kReduceSlices = 8;

// The block's shape for kCi (16 or 32) input channels a chunk.
template <int kCi>
struct Tile {
  static constexpr int kThreads = kCoGroups * (kCi / 2) * 3;  // 2 ci a thread, one kh
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kWarpsPerKh = kWarps / 3;
  static constexpr int kCiPitch = kCi + 4;  // floats per column of an input row
  static constexpr int kLines = 3 * kCi / 4;  // (plane, 4 channels) lines of a row load
  static constexpr int kMinBlocks = kCi == 16 ? 2 : 1;
};
static_assert(Tile<16>::kThreads == 192 && Tile<32>::kThreads == 384, "whole warps");
static_assert(Tile<16>::kLines == 2 * Tile<16>::kWarps && Tile<32>::kLines == 2 * Tile<32>::kWarps,
              "two lines a warp");

struct Shape {
  int n, ci, co, t, h, w;  // x is (n, ci, t, h, w)
  int pt, ph, pw;  // zero padding
  int to, ho, wo;  // dY is (n, co, to, ho, wo)
  int tile_w, tiles_w;  // output columns per row tile, tiles per row
  int ci_chunks;
  long long items;  // output rows of row tiles: n * to * tiles_w * ho
  int stride;  // floats of one block's partial: co * ci * 27 + co
};

struct Item {
  int n, t, h, c0, cols;  // sample, time, row, first column, columns
};

__device__ __forceinline__ Item decode(const Shape& s, long long i) {
  Item it;
  const long long strip = i / s.ho;
  it.h = int(i - strip * s.ho);
  const long long nt = strip / s.tiles_w;
  it.c0 = int(strip - nt * s.tiles_w) * s.tile_w;
  it.t = int(nt % s.to);
  it.n = int(nt / s.to);
  it.cols = min(s.tile_w, s.wo - it.c0);
  return it;
}

// The item after `it` (no 64-bit division on the way).
__device__ __forceinline__ Item advance(const Shape& s, Item it) {
  if (++it.h == s.ho) {
    it.h = 0;
    it.c0 += s.tile_w;
    if (it.c0 >= s.wo) {
      it.c0 = 0;
      if (++it.t == s.to) {
        it.t = 0;
        ++it.n;
      }
    }
    it.cols = min(s.tile_w, s.wo - it.c0);
  }
  return it;
}

// Loads `rows` padded input rows ending at row it.h + 2 of the item's three
// time planes into the ring, and the item's dY row into `dys`.
template <int kCi>
__device__ __forceinline__ void stage(const float* __restrict__ x, const float* __restrict__ dy,
                                      const Shape& s, const Item& it, int rows, float* xs,
                                      float* dys, int tw2, int ci_base, int co_base) {
  using T = Tile<kCi>;
  constexpr int P = T::kCiPitch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hp_first = it.h + 3 - rows;
  for (int line = warp; line < T::kLines; line += T::kWarps) {
    const int kt = line / (kCi / 4);
    const int ci_local = (line % (kCi / 4)) * 4 + (lane >> 3);
    const int ci = ci_base + ci_local;
    const int tin = it.t + kt - s.pt;
    const bool plane_ok = ci < s.ci && tin >= 0 && tin < s.t;
    const float* plane =
        plane_ok ? x + ((size_t(it.n) * s.ci + ci) * s.t + tin) * size_t(s.h) * s.w : x;
    for (int r = 0; r < rows; ++r) {
      const int hp = hp_first + r;
      const int hin = hp - s.ph;
      const bool row_ok = plane_ok && hin >= 0 && hin < s.h;
      const float* src = row_ok ? plane + size_t(hin) * s.w : x;
      float* dst = xs + (kt * kRing + (hp & (kRing - 1))) * tw2 * P + ci_local;
      for (int c = lane & 7; c < tw2; c += 8) {
        const int win = it.c0 + c - s.pw;
        const bool ok = row_ok && win >= 0 && win < s.w;
        cp_async4(dst + c * P, ok ? src + win : x, ok);
      }
    }
  }
  for (int line = warp; line < kCoChunk / 4; line += T::kWarps) {
    const int co_local = line * 4 + (lane >> 3);
    const int co = co_base + co_local;
    const bool ok = co < s.co;
    const float* src =
        ok ? dy + ((size_t(it.n) * s.co + co) * s.to + it.t) * size_t(s.ho) * s.wo +
                 size_t(it.h) * s.wo + it.c0
           : dy;
    float* dst = dys + co_local;
    for (int c = lane & 7; c < it.cols; c += 8) {
      cp_async4(dst + c * kCoPitch, ok ? src + c : dy, ok);
    }
  }
}

// One output column c (c % 3 == J) of the row: the new window column c + 2
// of each plane, the column's dY, 72 FFMAs.
template <int J, int P>
__device__ __forceinline__ void step(float (&acc)[4][2][3][3], float2 (&win)[3][3],
                                     const float* dyp, const float* x0, int plane, int c) {
  constexpr int kNew = (J + 2) % 3;
#pragma unroll
  for (int kt = 0; kt < 3; ++kt) {
    win[kt][kNew] = *reinterpret_cast<const float2*>(x0 + kt * plane + (c + 2) * P);
  }
  const float4 d4 = *reinterpret_cast<const float4*>(dyp + c * kCoPitch);
  const float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
  for (int o = 0; o < 4; ++o) {
#pragma unroll
    for (int kt = 0; kt < 3; ++kt) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const float2 v = win[kt][(J + kw) % 3];
        acc[o][0][kt][kw] = fmaf(d[o], v.x, acc[o][0][kt][kw]);
        acc[o][1][kt][kw] = fmaf(d[o], v.y, acc[o][1][kt][kw]);
      }
    }
  }
}

template <int kCi>
__global__ void __launch_bounds__(Tile<kCi>::kThreads, Tile<kCi>::kMinBlocks)
conv3d_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                    float* __restrict__ partial, const Shape s) {
  using T = Tile<kCi>;
  constexpr int P = T::kCiPitch;
  extern __shared__ __align__(16) float smem[];
  const int tw2 = s.tile_w + 2;  // input columns of a row tile
  const int plane = kRing * tw2 * P;  // floats of one plane's ring
  float* xs = smem;
  float* dys = smem + 3 * plane;  // two dY rows

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kh = warp / T::kWarpsPerKh;
  const int co_g = lane & 7;
  const int ci0 = 2 * ((warp % T::kWarpsPerKh) * 4 + (lane >> 3));
  const int cc = blockIdx.y / s.ci_chunks, ic = blockIdx.y % s.ci_chunks;
  const int co_base = cc * kCoChunk, ci_base = ic * kCi;

  const long long first = s.items * blockIdx.x / gridDim.x;
  const long long last = s.items * (blockIdx.x + 1) / gridDim.x;

  float acc[4][2][3][3];
#pragma unroll
  for (int o = 0; o < 4; ++o)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int kt = 0; kt < 3; ++kt)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) acc[o][i][kt][kw] = 0.f;
  float db = 0.f;

  Item cur = decode(s, first);
  int slot = 0;
  if (first < last) stage<kCi>(x, dy, s, cur, 3, xs, dys, tw2, ci_base, co_base);
  for (long long i = first; i < last; ++i) {
    cp_async_wait_all();
    __syncthreads();  // the item's rows are in; every thread is done with the last item
    const bool more = i + 1 < last;
    const Item next = advance(s, cur);
    const bool fresh = more && next.h == 0;  // a new (n, t, tile): three rows a plane
    float* dys_next = dys + (slot ^ 1) * s.tile_w * kCoPitch;
    if (more && !fresh) stage<kCi>(x, dy, s, next, 1, xs, dys_next, tw2, ci_base, co_base);

    const float* dys_cur = dys + slot * s.tile_w * kCoPitch;
    const float* dyp = dys_cur + 4 * co_g;
    const float* x0 = xs + ((cur.h + kh) & (kRing - 1)) * tw2 * P + ci0;
    float2 win[3][3];
#pragma unroll
    for (int kt = 0; kt < 3; ++kt) {
      win[kt][0] = *reinterpret_cast<const float2*>(x0 + kt * plane);
      win[kt][1] = *reinterpret_cast<const float2*>(x0 + kt * plane + P);
    }
    int c = 0;
    for (; c + 3 <= cur.cols; c += 3) {
      step<0, P>(acc, win, dyp, x0, plane, c);
      step<1, P>(acc, win, dyp, x0, plane, c + 1);
      step<2, P>(acc, win, dyp, x0, plane, c + 2);
    }
    if (c < cur.cols) {
      step<0, P>(acc, win, dyp, x0, plane, c);
      if (c + 1 < cur.cols) step<1, P>(acc, win, dyp, x0, plane, c + 1);
    }
    if (ic == 0) {
      for (int col = warp; col < cur.cols; col += T::kWarps) db += dys_cur[col * kCoPitch + lane];
    }

    if (fresh) {
      __syncthreads();  // the ring's rows are free for the new strip
      stage<kCi>(x, dy, s, next, 3, xs, dys_next, tw2, ci_base, co_base);
    }
    cur = next;
    slot ^= 1;
  }
  cp_async_wait_all();
  __syncthreads();

  float* out = partial + size_t(blockIdx.x) * s.stride;
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int co = co_base + 4 * co_g + o;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ci = ci_base + ci0 + i;
      if (co < s.co && ci < s.ci) {
        float* dst = out + (size_t(co) * s.ci + ci) * 27 + kh * 3;
#pragma unroll
        for (int kt = 0; kt < 3; ++kt)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) dst[kt * 9 + kw] = acc[o][i][kt][kw];
      }
    }
  }
  if (ic == 0) {  // the block's db: its warps' sums in a fixed order
    smem[warp * 32 + lane] = db;
    __syncthreads();
    if (warp == 0) {
      float sum = 0.f;
      for (int k = 0; k < T::kWarps; ++k) sum += smem[k * 32 + lane];
      const int co = co_base + lane;
      if (co < s.co) out[size_t(s.co) * s.ci * 27 + co] = sum;
    }
  }
}

// dW and db: each of the `blocks` partials summed in a fixed order (8
// slices of the blocks, then the slices in turn).
__global__ void __launch_bounds__(kReduceCols* kReduceSlices)
conv3d_wgrad_reduce_kernel(const float* __restrict__ partial, int blocks, int stride, int n_dw,
                           float* __restrict__ dw, float* __restrict__ db) {
  __shared__ float red[kReduceSlices][kReduceCols + 1];
  const int col = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int j = blockIdx.x * kReduceCols + col;
  float sum = 0.f;
  if (j < stride) {
    const int lo = blocks * slice / kReduceSlices, hi = blocks * (slice + 1) / kReduceSlices;
    for (int b = lo; b < hi; ++b) sum += partial[size_t(b) * stride + j];
  }
  red[slice][col] = sum;
  __syncthreads();
  if (slice == 0 && j < stride) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kReduceSlices; ++k) total += red[k][col];
    if (j < n_dw) {
      dw[j] = total;
    } else {
      db[j - n_dw] = total;
    }
  }
}

// A launch's plan: the shape, the kernel's chunk width, grid and shared memory.
struct Plan {
  Shape s;
  int ci_tile;  // 16 or 32
  int blocks;  // grid.x
  int chunks;  // grid.y: co chunks x ci chunks
  size_t smem;
};

template <int kCi>
size_t smem_bytes(int tile_w) {
  return sizeof(float) *
         (size_t(3) * kRing * (tile_w + 2) * Tile<kCi>::kCiPitch + size_t(2) * tile_w * kCoPitch);
}

// Blocks of `kernel` that one SM holds, with the opt-in to more than 48 KB
// of shared memory made once per device and kernel.
template <int kCi>
cudaError_t blocks_per_sm(int device, size_t smem, int* out) {
  static std::atomic<unsigned long long> configured{0};
  const unsigned long long bit = device < kMaxDevices ? 1ull << device : 0;
  if (!(configured.load() & bit)) {
    int optin = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(conv3d_wgrad_kernel<kCi>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, conv3d_wgrad_kernel<kCi>,
                                                       Tile<kCi>::kThreads, smem);
}

cudaError_t plan(int n, int ci, int co, int t, int h, int w, int pt, int ph, int pw, Plan* p) {
  if (n <= 0 || ci <= 0 || co <= 0 || t <= 0 || h <= 0 || w <= 0 || pt < 0 || pt > 1 ||
      ph < 0 || ph > 1 || pw < 0 || pw > 1) {
    return cudaErrorInvalidValue;
  }
  Shape& s = p->s;
  s.n = n, s.ci = ci, s.co = co, s.t = t, s.h = h, s.w = w;
  s.pt = pt, s.ph = ph, s.pw = pw;
  s.to = t + 2 * pt - 2, s.ho = h + 2 * ph - 2, s.wo = w + 2 * pw - 2;
  if (s.to <= 0 || s.ho <= 0 || s.wo <= 0) return cudaErrorInvalidValue;
  s.tiles_w = (s.wo + kMaxTileW - 1) / kMaxTileW;
  s.tile_w = (s.wo + s.tiles_w - 1) / s.tiles_w;
  p->ci_tile = ci <= 16 ? 16 : 32;
  s.ci_chunks = (ci + p->ci_tile - 1) / p->ci_tile;
  s.items = (long long)n * s.to * s.tiles_w * s.ho;
  const long long stride = (long long)co * ci * 27 + co;
  if (stride > (1ll << 30)) return cudaErrorInvalidValue;
  s.stride = int(stride);
  p->chunks = ((co + kCoChunk - 1) / kCoChunk) * s.ci_chunks;
  if (p->chunks > 65535) return cudaErrorInvalidValue;
  p->smem = p->ci_tile == 16 ? smem_bytes<16>(s.tile_w) : smem_bytes<32>(s.tile_w);

  int device = 0, count = 0, per_sm = 0;
  cudaError_t err = current_device_sms(&device, &count);
  if (err != cudaSuccess) return err;
  err = p->ci_tile == 16 ? blocks_per_sm<16>(device, p->smem, &per_sm)
                         : blocks_per_sm<32>(device, p->smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;  // the row tile does not fit
  long long blocks = (long long)count * per_sm / p->chunks;
  if (blocks < 1) blocks = 1;
  if (blocks > s.items) blocks = s.items;
  p->blocks = int(blocks);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* conv3d_wgrad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Floats of scratch that conv3d_wgrad_f32 needs for this shape on the
// current device (>= 0), or minus a CUDA error code.
long long conv3d_wgrad_workspace(int n, int ci, int co, int t, int h, int w, int pt, int ph,
                                 int pw) {
  Plan p;
  const cudaError_t err = plan(n, ci, co, t, h, w, pt, ph, pw, &p);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return (long long)p.blocks * p.s.stride;
}

// dw (co, ci, 3, 3, 3) and db (co) from x (n, ci, t, h, w) and dy; all
// contiguous fp32 on the current device. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
int conv3d_wgrad_f32(const float* x, const float* dy, float* dw, float* db, float* workspace,
                     long long workspace_floats, int n, int ci, int co, int t, int h, int w,
                     int pt, int ph, int pw, void* stream) {
  Plan p;
  cudaError_t err = plan(n, ci, co, t, h, w, pt, ph, pw, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (workspace_floats < (long long)p.blocks * p.s.stride) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(p.blocks, p.chunks);
  if (p.ci_tile == 16) {
    conv3d_wgrad_kernel<16><<<grid, Tile<16>::kThreads, p.smem, st>>>(x, dy, workspace, p.s);
  } else {
    conv3d_wgrad_kernel<32><<<grid, Tile<32>::kThreads, p.smem, st>>>(x, dy, workspace, p.s);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_dw = co * ci * 27;
  conv3d_wgrad_reduce_kernel<<<(p.s.stride + kReduceCols - 1) / kReduceCols,
                               kReduceCols * kReduceSlices, 0, st>>>(workspace, p.blocks,
                                                                     p.s.stride, n_dw, dw, db);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
