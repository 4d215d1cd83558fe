// Input gradient of a 3x3x3 fp32 convolution, stride 1, zero padding of 0
// or 1 in each dimension, NCDHW:
//
//   dX[n, ci, t, h, w] = sum_{co, kt, kh, kw} dY[n, co, t+pt-kt, h+ph-kh, w+pw-kw] * W[co, ci, kt, kh, kw]
//
// with dY zero outside its bounds: a stride-1 3x3x3 convolution of dY padded
// by 2 - p, with W flipped and its channel axes swapped.
//
// Replaces no TPU kernel: the JAX package leaves the towers' gradients to
// XLA. It is added because cuDNN's fp32 3-D data gradient ran at 31.5 % of
// its bound on an H100 and was the largest kernel of the conv3d_sat_nwp
// train step.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores, 3.35
// TB/s): the forward's multiply-adds, 2 * N * C_out * C_in * 27 per output
// position of the forward. Layers 1-5 of both towers of a conv3d_sat_nwp
// step (batch 32) are 183.7 GFLOP (2.74 ms) against ~0.9 GB of dY and dX
// (0.27 ms): compute-bound, on FP32 FMAs (TF32 fails the towers' gradient
// limits). As a GEMM, M = N * T * H * W input positions, N = C_in and
// K = C_out * 27: the output is large and K modest, so the design is a
// tiled direct convolution in which one thread owns each dX element.
//
// Design, and what each part does about that limit:
//  * FP32 FFMA only; every multiply-add is one FFMA.
//  * A block holds, for its chunk of 32 input channels, the weights of up
//    to 32 output channels in shared memory for its whole life
//    ([co][tap][ci]: 108 KB), loaded once by cp.async. The grid is one full
//    wave of resident blocks (one an SM, 16 warps), and their warps work
//    independently after that: no block barrier in the main loop.
//  * A warp owns a tile of 4 dX rows x L columns of one (n, t) plane, all
//    32 input channels: lane = ci, so every dY value the tile needs is a
//    broadcast load from shared memory, and a lane's nine weights of an
//    output channel and plane are nine conflict-free loads. A lane keeps
//    4 x L accumulators; each dY row window of L + 2 values feeds 3 kw x L
//    FFMAs for every dX row it reaches, so per output channel a lane issues
//    27 * 4 * L FFMAs against 3 * 6 window loads (two or three float4s each)
//    and 27 weight loads.
//  * L (4 to 8) is chosen per width by the launch's plan so that the row
//    tiles waste the fewest columns (22 -> 3 x 8, 20 -> 4 x 5, 62 -> 9 x 7).
//    Each tile's dY windows are staged at a 16-byte aligned pitch, so the
//    broadcast loads are float4.
//  * dY planes and rows that lie outside dY (the zero padding of the time
//    and row edges) are neither loaded nor multiplied: whole-warp branches,
//    since the lanes of a warp share their positions. Only the column edges
//    are zero-filled and multiplied.
//  * Each warp stages its tiles' dY through a two-stage cp.async ring, four
//    output channels a stage (3 planes x 6 rows x (L + 2) columns each), so
//    the next stage loads while the current one is multiplied. A lane's
//    source address and which of its rows to copy are worked out once a
//    tile; dY rows are not 16-byte aligned (widths of 18 or 54), so the
//    copies are 4 bytes each.
//  * Warps take contiguous runs of tiles of equal cost (the FFMAs left
//    after the skipped planes and rows), so edge tiles do not leave warps
//    idle at the end.
//  * Each dX element has one owner thread and one summation order: no
//    atomics, no scratch buffer, bit-identical from run to run. Output rows
//    go out through a transposition in shared memory, so a warp's stores
//    are runs of consecutive columns. More than 32 output channels are
//    summed by successive launches, each adding to dX in a fixed order.
//  * The kernel allocates nothing and does not synchronise, so a CUDA graph
//    captures it.
//
// On an H100 (700 W) the ten tower shapes of a batch-32 step take ~6.0 ms,
// ~46 % of the bound (cuDNN's data gradient 8.7 ms, 31 %). The rest is not
// the loads' latency (a third ring stage changes nothing) but issue: the
// 4-byte copies and the per-plane weight loads beside the FFMAs.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

#include "conv3d_common.cuh"

namespace {

constexpr int kCiChunk = 32;  // input channels of a block: one per lane
constexpr int kCoChunk = 32;  // output channels of a launch
constexpr int kTaps = 27;
constexpr int kRows = 4;  // dX rows of a tile
constexpr int kYRows = kRows + 2;  // dY rows of a tile
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kCoStage = 4;  // output channels of a ring stage
constexpr int kStages = 2;
constexpr int kScratchPitch = 33;  // floats per column of the output transposition
constexpr size_t kWeightFloats = size_t(kCoChunk) * kTaps * kCiChunk;

// dY row pairs of a tile: dX rows i with kh = i + 2 - j in [0, 2].
__host__ __device__ constexpr int pairs(int j) {
  return (j < kRows ? j : kRows - 1) - (j - 2 > 0 ? j - 2 : 0) + 1;
}

template <int L>
struct Tile {
  static constexpr int kWin = L + 2;  // dY columns of a window
  static constexpr int kPitch = (kWin + 3) / 4 * 4;  // floats per staged row
  static constexpr int kStageFloats = kCoStage * 3 * kYRows * kPitch;
  static_assert(kStageFloats >= L * kScratchPitch, "a stage holds the output transposition");
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kWeightFloats + size_t(kWarps) * kStages * kStageFloats);
};
static_assert(3 * (8 + 2) <= 32, "three staged rows a pass");

struct Shape {
  int n, ci, co, t, h, w;  // dX is (n, ci, t, h, w)
  int pt, ph, pw;  // the forward's zero padding
  int to, ho, wo;  // dY is (n, co, to, ho, wo)
  int groups, tiles_w;  // row groups of kRows, column tiles of L
  int co_base, co_count;  // the launch's output channels
  int accumulate;  // add to dX instead of writing it
};

struct Pos {
  int n, t, g, s;  // sample, time, row group, column tile
};

// A tile's place in the order (n, t, g, s), and back.
__device__ __forceinline__ int tile_index(const Shape& s, const Pos& c) {
  return ((c.n * s.t + c.t) * s.groups + c.g) * s.tiles_w + c.s;
}

__device__ __forceinline__ Pos tile_at(const Shape& s, int i) {
  Pos c;
  c.s = i % s.tiles_w, i /= s.tiles_w;
  c.g = i % s.groups, i /= s.groups;
  c.t = i % s.t, c.n = i / s.t;
  return c;
}

// Valid dY planes of dX time t (1 to 3).
__device__ __forceinline__ int plane_mask(const Shape& s, int t) {
  int mask = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int td = t + s.pt - 2 + a;
    if (td >= 0 && td < s.to) mask |= 1 << a;
  }
  return mask;
}

// Valid dY rows of row group g.
__device__ __forceinline__ int row_mask(const Shape& s, int g) {
  int mask = 0;
#pragma unroll
  for (int j = 0; j < kYRows; ++j) {
    const int hd = g * kRows + s.ph - 2 + j;
    if (hd >= 0 && hd < s.ho) mask |= 1 << j;
  }
  return mask;
}

__device__ __forceinline__ int plane_cost(const Shape& s, int t) {
  return __popc(plane_mask(s, t));
}

__device__ __forceinline__ int row_cost(const Shape& s, int g) {
  const int mask = row_mask(s, g);
  int cost = 0;
#pragma unroll
  for (int j = 0; j < kYRows; ++j) cost += (mask >> j & 1) * pairs(j);
  return cost;
}

__device__ __forceinline__ void advance(const Shape& s, Pos& c) {
  if (++c.s == s.tiles_w) {
    c.s = 0;
    if (++c.g == s.groups) {
      c.g = 0;
      if (++c.t == s.t) {
        c.t = 0;
        ++c.n;
      }
    }
  }
}

// The first tile whose cost offset is at least x, in the order (n, t, g, s):
// a tile costs its valid planes times its valid (dY row, dX row) pairs.
__device__ Pos locate(const Shape& s, long long x, long long per_row_cost, long long per_sample) {
  Pos c;
  c.n = int(x / per_sample);
  long long r = x - c.n * per_sample;
  for (c.t = 0;; ++c.t) {  // r < per_sample: ends inside the sample
    const long long block = plane_cost(s, c.t) * per_row_cost * s.tiles_w;
    if (r < block) break;
    r -= block;
  }
  const int pc = plane_cost(s, c.t);
  for (c.g = 0;; ++c.g) {
    const long long block = (long long)pc * row_cost(s, c.g) * s.tiles_w;
    if (r < block) break;
    r -= block;
  }
  const long long unit = (long long)pc * row_cost(s, c.g);
  c.s = int((r + unit - 1) / unit);
  if (c.s == s.tiles_w) {  // x lies inside the row group's last tile
    c.s = s.tiles_w - 1;
    advance(s, c);
  }
  return c;
}

constexpr int kPasses = (kYRows + 2) / 3;  // staged rows a lane copies, per plane

// What a lane copies of a tile's dY, whatever the output channels: a lane
// takes column `col` of rows r, r + 3, ...; `src` is that column of the
// tile's first output channel, first plane and row r. Planes and rows
// outside dY are not copied (and never read); a column outside it is
// zero-filled (read from the row's first column with no bytes).
struct Feed {
  const float* src;
  int dst;  // offset of the lane's first element in a stage
  int mask;  // bit a * kPasses + pass: copy that plane's row
  bool col_ok;
};

template <int L>
__device__ __forceinline__ Feed feed(const float* __restrict__ dy, const Shape& s, const Pos& c,
                                     int lane) {
  using T = Tile<L>;
  const int r = lane / T::kWin, col = lane - r * T::kWin;
  Feed f{dy, 0, 0, false};
  if (r >= 3) return f;
  const int pmask = plane_mask(s, c.t), rmask = row_mask(s, c.g);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const int j = pass * 3 + r;
      if (j < kYRows && (pmask >> a & 1) && (rmask >> j & 1)) f.mask |= 1 << (a * kPasses + pass);
    }
  const int wd = c.s * L + s.pw - 2 + col;
  f.col_ok = wd >= 0 && wd < s.wo;
  const long long row = ((long long)(c.n) * s.co + s.co_base) * s.to * s.ho +
                        (long long)(c.t + s.pt - 2) * s.ho + c.g * kRows + s.ph - 2 + r;
  f.src = dy + row * s.wo + (f.col_ok ? wd : 0);
  f.dst = r * T::kPitch + col;
  return f;
}

// Stages output channels co0 .. co0 + kCoStage - 1 of a tile's dY windows
// into `buf`: [co][plane a][row j][column] at Tile<L>::kPitch.
template <int L>
__device__ __forceinline__ void stage(const Feed& f, const Shape& s, int co0, float* buf,
                                      long long co_floats, int plane_floats) {
  using T = Tile<L>;
  if (!f.mask) return;
#pragma unroll
  for (int q = 0; q < kCoStage; ++q) {
    if (co0 + q >= s.co_count) break;
    const float* p = f.src + (co0 + q) * co_floats;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass) {
        if (!(f.mask >> (a * kPasses + pass) & 1)) continue;
        cp_async4(buf + f.dst + ((q * 3 + a) * kYRows + pass * 3) * T::kPitch,
                  p + a * plane_floats + pass * 3 * s.wo, f.col_ok);
      }
  }
}

template <int N>
__device__ __forceinline__ void window(float (&v)[N], const float* p) {
#pragma unroll
  for (int k = 0; k + 4 <= N; k += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + k);
    v[k] = f.x, v[k + 1] = f.y, v[k + 2] = f.z, v[k + 3] = f.w;
  }
  constexpr int done = N / 4 * 4;
  if constexpr (N - done >= 2) {
    const float2 f = *reinterpret_cast<const float2*>(p + done);
    v[done] = f.x, v[done + 1] = f.y;
  }
  if constexpr ((N - done) % 2 == 1) v[N - 1] = p[N - 1];
}

// The FFMAs of one output channel: its 27 weights for this lane's input
// channel, every staged window of the tile into the 4 x L accumulators.
template <int L>
__device__ __forceinline__ void multiply(float (&acc)[kRows][L], const float* ys,
                                         const float* wsm, int pmask, int rmask) {
  using T = Tile<L>;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (!(pmask >> a & 1)) continue;
    const int kt = 2 - a;
    float wr[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) wr[k] = wsm[(kt * 9 + k) * kCiChunk];
#pragma unroll
    for (int j = 0; j < kYRows; ++j) {
      if (!(rmask >> j & 1)) continue;
      float v[T::kWin];
      window(v, ys + (a * kYRows + j) * T::kPitch);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kh = i + 2 - j;
        if (kh < 0 || kh > 2) continue;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float wv = wr[kh * 3 + kw];
#pragma unroll
          for (int l = 0; l < L; ++l) acc[i][l] = fmaf(v[l + 2 - kw], wv, acc[i][l]);
        }
      }
    }
  }
}

// Writes (or adds) a finished tile's dX rows, through `scratch` so that
// consecutive lanes store consecutive columns.
template <int L>
__device__ __forceinline__ void store(float (&acc)[kRows][L], float* __restrict__ dx,
                                      const Shape& s, const Pos& c, int ci_base,
                                      float* scratch, int lane) {
  const int w0 = c.s * L;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int h = c.g * kRows + i;
    if (h >= s.h) break;
#pragma unroll
    for (int l = 0; l < L; ++l) scratch[l * kScratchPitch + lane] = acc[i][l];
    __syncwarp();
#pragma unroll
    for (int m = 0; m < L; ++m) {
      const int e = m * 32 + lane;
      const int ci_local = e / L, l = e - ci_local * L;
      const int ci = ci_base + ci_local, w = w0 + l;
      if (ci < s.ci && w < s.w) {
        float value = scratch[l * kScratchPitch + ci_local];
        float* out = dx + ((size_t(c.n) * s.ci + ci) * s.t + c.t) * size_t(s.h) * s.w +
                     size_t(h) * s.w + w;
        if (s.accumulate) value += *out;
        *out = value;
      }
    }
    __syncwarp();
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_dgrad_kernel(const float* __restrict__ dy, const float* __restrict__ weight,
                    float* __restrict__ dx, const Shape s) {
  using T = Tile<L>;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;  // [co][tap][ci]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ci_base = blockIdx.y * kCiChunk;
  float* ring = smem + kWeightFloats + size_t(warp) * kStages * T::kStageFloats;

  for (int k = threadIdx.x; k < int(kWeightFloats); k += kThreads) {
    const int ci = ci_base + k % kCiChunk, tap = k / kCiChunk % kTaps, co = k / (kCiChunk * kTaps);
    const bool ok = co < s.co_count && ci < s.ci;
    cp_async4(ws + k, ok ? weight + (size_t(s.co_base + co) * s.ci + ci) * kTaps + tap : weight, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // This warp's share of the launch's cost, in tiles of (n, t, g, s).
  long long per_row_cost = 0, plane_total = 0;
  for (int g = 0; g < s.groups; ++g) per_row_cost += row_cost(s, g);
  for (int t = 0; t < s.t; ++t) plane_total += plane_cost(s, t);
  const long long per_sample = plane_total * per_row_cost * s.tiles_w;
  const long long total = per_sample * s.n;
  const long long warps = (long long)gridDim.x * kWarps;
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  const long long begin = total * gw / warps, end = total * (gw + 1) / warps;
  if (begin >= end) return;

  // tiles [first, last) of the order (n, t, g, s)
  const int first = tile_index(s, locate(s, begin, per_row_cost, per_sample));
  const int last = tile_index(s, locate(s, end, per_row_cost, per_sample));
  if (first >= last) return;
  const int chunks = (s.co_count + kCoStage - 1) / kCoStage;
  const float* wlane = ws + lane;
  const long long co_floats = (long long)s.to * s.ho * s.wo;
  const int plane_floats = s.ho * s.wo;

  float acc[kRows][L];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int l = 0; l < L; ++l) acc[i][l] = 0.f;

  // The stages are (tile, chunk of output channels) in order; `ahead` is
  // the next one to load, kStages - 1 in front of the one multiplied.
  int ahead = first, ahead_chunk = 0;
  Feed fed = feed<L>(dy, s, tile_at(s, ahead), lane);
  auto load_ahead = [&](int slot) {
    if (ahead < last) {
      stage<L>(fed, s, ahead_chunk * kCoStage, ring + slot * T::kStageFloats, co_floats, plane_floats);
      if (++ahead_chunk == chunks) {
        ahead_chunk = 0;
        if (++ahead < last) fed = feed<L>(dy, s, tile_at(s, ahead), lane);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k + 1 < kStages; ++k) load_ahead(k);
  int cur = first, chunk = 0, slot = 0;
  Pos pos = tile_at(s, cur);
  int pmask = plane_mask(s, pos.t), rmask = row_mask(s, pos.g);
  for (;;) {
    load_ahead(slot == 0 ? kStages - 1 : slot - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();

    float* buf = ring + slot * T::kStageFloats;
    const int co0 = chunk * kCoStage;
#pragma unroll 1
    for (int q = 0; q < kCoStage && co0 + q < s.co_count; ++q) {
      multiply<L>(acc, buf + q * 3 * kYRows * T::kPitch, wlane + (co0 + q) * kTaps * kCiChunk,
                  pmask, rmask);
    }
    __syncwarp();
    slot = slot + 1 == kStages ? 0 : slot + 1;
    if (++chunk < chunks) continue;
    // the tile is done; its slot is free until the next load_ahead call
    store<L>(acc, dx, s, pos, ci_base, buf, lane);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int l = 0; l < L; ++l) acc[i][l] = 0.f;
    chunk = 0;
    if (++cur == last) break;
    pos = tile_at(s, cur);
    pmask = plane_mask(s, pos.t), rmask = row_mask(s, pos.g);
  }
  cp_async_wait<0>();
}

// A launch's plan: the shape, the tile width, grid and shared memory.
struct Plan {
  Shape s;
  int tile_w;  // L
  int blocks;  // grid.x
  int ci_chunks;  // grid.y
  size_t smem;
};

size_t smem_bytes(int tile_w) {
  switch (tile_w) {
    case 4: return Tile<4>::kSmemBytes;
    case 5: return Tile<5>::kSmemBytes;
    case 6: return Tile<6>::kSmemBytes;
    case 7: return Tile<7>::kSmemBytes;
    default: return Tile<8>::kSmemBytes;
  }
}

template <int L>
cudaError_t configure(int device, int* per_sm) {
  static std::atomic<unsigned long long> configured{0};
  const unsigned long long bit = device < kMaxDevices ? 1ull << device : 0;
  if (!(configured.load() & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3d_dgrad_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(Tile<L>::kSmemBytes));
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, conv3d_dgrad_kernel<L>, kThreads,
                                                       Tile<L>::kSmemBytes);
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
  // the tile width that wastes the fewest columns, the widest of those
  int best = 0, best_cols = 0;
  for (int l = 8; l >= 4; --l) {
    const int cols = (w + l - 1) / l * l;
    if (best == 0 || cols < best_cols) best = l, best_cols = cols;
  }
  p->tile_w = best;
  s.tiles_w = best_cols / best;
  s.groups = (h + kRows - 1) / kRows;
  if ((long long)n * t * s.groups * s.tiles_w >= (1ll << 31) || 3ll * s.ho * s.wo >= (1ll << 31)) {
    return cudaErrorInvalidValue;  // tile indices and plane offsets are ints
  }
  s.co_base = 0, s.co_count = co < kCoChunk ? co : kCoChunk;
  s.accumulate = 0;
  p->ci_chunks = (ci + kCiChunk - 1) / kCiChunk;
  if (p->ci_chunks > 65535) return cudaErrorInvalidValue;
  p->smem = smem_bytes(best);

  int device = 0, count = 0, per_sm = 0;
  cudaError_t err = current_device_sms(&device, &count);
  if (err != cudaSuccess) return err;
  switch (best) {
    case 4: err = configure<4>(device, &per_sm); break;
    case 5: err = configure<5>(device, &per_sm); break;
    case 6: err = configure<6>(device, &per_sm); break;
    case 7: err = configure<7>(device, &per_sm); break;
    default: err = configure<8>(device, &per_sm); break;
  }
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;  // the block does not fit
  long long blocks = (long long)count * per_sm / p->ci_chunks;
  if (blocks < 1) blocks = 1;
  p->blocks = int(blocks);
  return cudaSuccess;
}

template <int L>
void launch(const Plan& p, const float* dy, const float* weight, float* dx, cudaStream_t st) {
  conv3d_dgrad_kernel<L><<<dim3(p.blocks, p.ci_chunks), kThreads, p.smem, st>>>(dy, weight, dx, p.s);
}

}  // namespace

extern "C" {

const char* conv3d_dgrad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dx (n, ci, t, h, w) from dy (n, co, t + 2pt - 2, h + 2ph - 2, w + 2pw - 2)
// and the forward's weight (co, ci, 3, 3, 3); all contiguous fp32 on the
// current device. One launch a chunk of 32 output channels, in order, on
// `stream`; returns cudaGetLastError() (0 on success); does not synchronise.
int conv3d_dgrad_f32(const float* dy, const float* weight, float* dx, int n, int ci, int co,
                     int t, int h, int w, int pt, int ph, int pw, void* stream) {
  Plan p;
  cudaError_t err = plan(n, ci, co, t, h, w, pt, ph, pw, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int base = 0; base < co; base += kCoChunk) {
    p.s.co_base = base;
    p.s.co_count = co - base < kCoChunk ? co - base : kCoChunk;
    p.s.accumulate = base > 0;
    switch (p.tile_w) {
      case 4: launch<4>(p, dy, weight, dx, st); break;
      case 5: launch<5>(p, dy, weight, dx, st); break;
      case 6: launch<6>(p, dy, weight, dx, st); break;
      case 7: launch<7>(p, dy, weight, dx, st); break;
      default: launch<8>(p, dy, weight, dx, st); break;
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
