// Farnebäck dense optical flow + flow warping on the host, C++: the port's
// copy of the JAX package's native/farneback.cpp, built by _build.py with
// the same flags as native/Makefile (-O3 -fPIC -shared -std=c++17), so the
// two libraries compute the same thing. It is host code, not a device
// kernel: the port's flow runs on the card (ops/optical_flow.py); this
// library is the single-core host rate that flow_bench.py sets the card's
// rate against, and a second implementation the tests hold the port's flow to.
//
// Algorithm (G. Farnebäck, SCIA 2003):
//   1. polynomial expansion: per-pixel quadratic fit via six separable
//      Gaussian-weighted correlations and a constant 6x6 normal-equation
//      inverse;
//   2. displacement update: warped-coefficient averaging, Gaussian window
//      accumulation of A^T A / A^T db, per-pixel 2x2 solve — with OpenCV's
//      5-px border damping ramp and out-of-bounds warp branch, so results
//      match cv2.calcOpticalFlowFarneback to sub-pixel precision;
//   3. coarse-to-fine pyramid, OpenCV semantics: `levels` counts downscale
//      steps (levels+1 images, short side capped at >= 32 px), each level a
//      Gaussian-smoothed INTER_LINEAR resize of the ORIGINAL frame.
//
// API is C for ctypes (native.py).

#include <cmath>
#include <cstring>
#include <vector>

namespace {

using std::vector;

// ---------------------------------------------------------------- helpers

// Separable cross-correlation with edge-replicated borders.
// kx has radius rx (length 2*rx+1), ky radius ry.
void sep_correlate(const float* src, float* dst, int H, int W,
                   const float* kx, int rx, const float* ky, int ry,
                   float* tmp /* H*W scratch */) {
  // rows: correlate along x into tmp
  for (int y = 0; y < H; ++y) {
    const float* row = src + y * W;
    for (int x = 0; x < W; ++x) {
      float acc = 0.f;
      for (int k = -rx; k <= rx; ++k) {
        int xx = x + k;
        if (xx < 0) xx = 0;
        if (xx >= W) xx = W - 1;
        acc += row[xx] * kx[k + rx];
      }
      tmp[y * W + x] = acc;
    }
  }
  // cols: correlate along y into dst
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      float acc = 0.f;
      for (int k = -ry; k <= ry; ++k) {
        int yy = y + k;
        if (yy < 0) yy = 0;
        if (yy >= H) yy = H - 1;
        acc += tmp[yy * W + x] * ky[k + ry];
      }
      dst[y * W + x] = acc;
    }
  }
}

void gaussian_kernel(float sigma, int radius, vector<float>& k) {
  k.resize(2 * radius + 1);
  double sum = 0.0;
  for (int i = -radius; i <= radius; ++i) {
    double v = std::exp(-(double)(i * i) / (2.0 * sigma * sigma));
    k[i + radius] = (float)v;
    sum += v;
  }
  for (auto& v : k) v = (float)(v / sum);
}

// Gauss-Jordan inverse of a 6x6 (the normal-equation matrix is well
// conditioned for any sane poly_sigma).
bool invert6(double a[6][6], double inv[6][6]) {
  double aug[6][12];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) aug[i][j] = a[i][j];
    for (int j = 0; j < 6; ++j) aug[i][6 + j] = (i == j) ? 1.0 : 0.0;
  }
  for (int col = 0; col < 6; ++col) {
    int pivot = col;
    for (int r = col + 1; r < 6; ++r)
      if (std::fabs(aug[r][col]) > std::fabs(aug[pivot][col])) pivot = r;
    if (std::fabs(aug[pivot][col]) < 1e-12) return false;
    if (pivot != col)
      for (int j = 0; j < 12; ++j) std::swap(aug[col][j], aug[pivot][j]);
    double d = aug[col][col];
    for (int j = 0; j < 12; ++j) aug[col][j] /= d;
    for (int r = 0; r < 6; ++r) {
      if (r == col) continue;
      double f = aug[r][col];
      for (int j = 0; j < 12; ++j) aug[r][j] -= f * aug[col][j];
    }
  }
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) inv[i][j] = aug[i][6 + j];
  return true;
}

// ------------------------------------------------- polynomial expansion

struct PolyExp {
  vector<float> A11, A12, A22, b1, b2;  // (x, y) coordinate order
};

void polynomial_expansion(const float* img, int H, int W, int n, float sigma,
                          PolyExp& out) {
  vector<float> g(2 * n + 1), xg(2 * n + 1), xxg(2 * n + 1);
  {
    vector<float> base;
    gaussian_kernel(sigma, n, base);
    for (int i = -n; i <= n; ++i) {
      g[i + n] = base[i + n];
      xg[i + n] = base[i + n] * i;
      xxg[i + n] = base[i + n] * i * i;
    }
  }
  // 1-D applicability moments s[k] = sum g(x) x^k
  double s[5] = {0, 0, 0, 0, 0};
  for (int i = -n; i <= n; ++i)
    for (int k = 0; k < 5; ++k) s[k] += g[i + n] * std::pow((double)i, k);

  // basis exponents (p, q) for [1, x, y, x^2, y^2, xy]
  const int P[6] = {0, 1, 0, 2, 0, 1};
  const int Q[6] = {0, 0, 1, 0, 2, 1};
  double G[6][6], Ginv[6][6];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) G[i][j] = s[P[i] + P[j]] * s[Q[i] + Q[j]];
  invert6(G, Ginv);

  const int N = H * W;
  vector<float> m(6 * N), tmp(N);
  // moments: (kx, ky) pairs per basis function
  const float* KX[6] = {g.data(), xg.data(), g.data(), xxg.data(), g.data(), xg.data()};
  const float* KY[6] = {g.data(), g.data(), xg.data(), g.data(), xxg.data(), xg.data()};
  for (int k = 0; k < 6; ++k)
    sep_correlate(img, m.data() + k * N, H, W, KX[k], n, KY[k], n, tmp.data());

  out.A11.resize(N); out.A12.resize(N); out.A22.resize(N);
  out.b1.resize(N); out.b2.resize(N);
  for (int i = 0; i < N; ++i) {
    double r[6];
    for (int row = 0; row < 6; ++row) {
      double acc = 0.0;
      for (int col = 0; col < 6; ++col) acc += Ginv[row][col] * m[col * N + i];
      r[row] = acc;
    }
    out.b1[i] = (float)r[1];          // d/dx
    out.b2[i] = (float)r[2];          // d/dy
    out.A11[i] = (float)r[3];         // x^2
    out.A22[i] = (float)r[4];         // y^2
    out.A12[i] = (float)(r[5] / 2.0); // xy/2
  }
}

inline float bilinear(const float* f, int H, int W, float y, float x) {
  if (y < 0.f) y = 0.f;
  if (x < 0.f) x = 0.f;
  if (y > H - 1.f) y = H - 1.f;
  if (x > W - 1.f) x = W - 1.f;
  int y0 = (int)y, x0 = (int)x;
  int y1 = y0 + 1 < H ? y0 + 1 : H - 1;
  int x1 = x0 + 1 < W ? x0 + 1 : W - 1;
  float wy = y - y0, wx = x - x0;
  float top = f[y0 * W + x0] * (1 - wx) + f[y0 * W + x1] * wx;
  float bot = f[y1 * W + x0] * (1 - wx) + f[y1 * W + x1] * wx;
  return top * (1 - wy) + bot * wy;
}

// -------------------------------------------------------- flow update

// cv2's FarnebackUpdateMatrices border damping ramp (5 px).
const float kBorderRamp[5] = {0.14f, 0.14f, 0.4472f, 0.4472f, 0.4472f};

inline float border_scale(int x, int y, int H, int W) {
  float s = 1.f;
  if (x < 5) s *= kBorderRamp[x];
  if (x >= W - 5) s *= kBorderRamp[W - 1 - x];
  if (y < 5) s *= kBorderRamp[y];
  if (y >= H - 5) s *= kBorderRamp[H - 1 - y];
  return s;
}

void update_flow(const PolyExp& p1, const PolyExp& p2, int H, int W,
                 vector<float>& flow /* 2*N, [dx|dy] planes */, int winsize,
                 bool gaussian) {
  const int N = H * W;
  vector<float> g11(N), g12(N), g22(N), h1(N), h2(N);
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      int i = y * W + x;
      float dx = flow[i], dy = flow[N + i];
      float sx = x + dx, sy = y + dy;
      float a11, a12, a22, db1, db2;
      // cv2 only warp-samples when floor(sample) is strictly interior;
      // otherwise A-bar = A1 and only the WARPED b2 taps are zeroed, so
      // the pixel still contributes 0.5*b1 (FarnebackUpdateMatrices:
      // r2=r3=0 then r2=(R0-r2)*0.5).
      int xf = (int)std::floor(sx), yf = (int)std::floor(sy);
      if (xf >= 0 && xf <= W - 2 && yf >= 0 && yf <= H - 2) {
        a11 = 0.5f * (p1.A11[i] + bilinear(p2.A11.data(), H, W, sy, sx));
        a12 = 0.5f * (p1.A12[i] + bilinear(p2.A12.data(), H, W, sy, sx));
        a22 = 0.5f * (p1.A22[i] + bilinear(p2.A22.data(), H, W, sy, sx));
        db1 = -0.5f * (bilinear(p2.b1.data(), H, W, sy, sx) - p1.b1[i]);
        db2 = -0.5f * (bilinear(p2.b2.data(), H, W, sy, sx) - p1.b2[i]);
      } else {
        a11 = p1.A11[i];
        a12 = p1.A12[i];
        a22 = p1.A22[i];
        db1 = 0.5f * p1.b1[i];
        db2 = 0.5f * p1.b2[i];
      }
      db1 += a11 * dx + a12 * dy;
      db2 += a12 * dx + a22 * dy;
      float s = border_scale(x, y, H, W);
      a11 *= s; a12 *= s; a22 *= s; db1 *= s; db2 *= s;
      g11[i] = a11 * a11 + a12 * a12;
      g12[i] = a11 * a12 + a12 * a22;
      g22[i] = a12 * a12 + a22 * a22;
      h1[i] = a11 * db1 + a12 * db2;
      h2[i] = a12 * db1 + a22 * db2;
    }
  }
  // window accumulation
  int radius = winsize / 2;
  vector<float> kernel;
  if (gaussian) {
    float sigma = radius * 0.3f;  // cv2: sigma = (block_size/2) * 0.3
    gaussian_kernel(sigma, radius, kernel);
  } else {
    kernel.assign(2 * radius + 1, 1.0f / (2 * radius + 1));
  }
  vector<float> tmp(N), sm(N);
  float* fields[5] = {g11.data(), g12.data(), g22.data(), h1.data(), h2.data()};
  for (float* f : fields) {
    sep_correlate(f, sm.data(), H, W, kernel.data(), radius, kernel.data(), radius,
                  tmp.data());
    std::memcpy(f, sm.data(), N * sizeof(float));
  }
  for (int i = 0; i < N; ++i) {
    // cv2's unconditional additive regularisation (1/(det + 1e-3)) — a
    // sign-preserving clamp measured up to 1.07 px border error vs cv2
    float det = g11[i] * g22[i] - g12[i] * g12[i] + 1e-3f;
    flow[i] = (g22[i] * h1[i] - g12[i] * h2[i]) / det;
    flow[N + i] = (g11[i] * h2[i] - g12[i] * h1[i]) / det;
  }
}

// Separable blur with BORDER_REFLECT_101 (cv2 GaussianBlur default).
void blur_reflect101(const float* src, float* dst, int H, int W,
                     const float* k, int r, float* tmp) {
  auto reflect = [](int i, int n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
    return i;
  };
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x) {
      float acc = 0.f;
      for (int t = -r; t <= r; ++t)
        acc += src[y * W + reflect(x + t, W)] * k[t + r];
      tmp[y * W + x] = acc;
    }
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x) {
      float acc = 0.f;
      for (int t = -r; t <= r; ++t)
        acc += tmp[reflect(y + t, H) * W + x] * k[t + r];
      dst[y * W + x] = acc;
    }
}

// cv2 getGaussianKernel: fixed binomial taps when sigma<=0 at small sizes.
void pyramid_smooth_kernel(float sigma, int size, vector<float>& k) {
  if (sigma <= 0.f && size <= 7) {
    static const float k3[] = {0.25f, 0.5f, 0.25f};
    static const float k5[] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};
    static const float k7[] = {0.03125f, 0.109375f, 0.21875f, 0.28125f,
                               0.21875f, 0.109375f, 0.03125f};
    const float* src = size == 3 ? k3 : (size == 5 ? k5 : k7);
    k.assign(src, src + size);
    return;
  }
  if (sigma <= 0.f) sigma = 0.3f * ((size - 1) * 0.5f - 1.f) + 0.8f;
  gaussian_kernel(sigma, size / 2, k);
}

// Level-k input, cv2 calcOpticalFlowFarneback semantics: smooth the ORIGINAL
// image with sigma=(1/scale-1)/2 (ksize=round(5*sigma)|1, min 3), then one
// INTER_LINEAR (half-pixel, non-antialiased) resize to the level size.
void pyramid_level(const float* img, int H, int W, int level, float pyr_scale,
                   vector<float>& dst, int& h_out, int& w_out) {
  double scale = std::pow((double)pyr_scale, level);
  float sigma = (float)((1.0 / scale - 1.0) * 0.5);
  int size = (int)std::rint(sigma * 5.0) | 1;
  if (size < 3) size = 3;
  vector<float> kernel;
  pyramid_smooth_kernel(sigma, size, kernel);
  vector<float> smoothed(H * W), tmp(H * W);
  blur_reflect101(img, smoothed.data(), H, W, kernel.data(),
                  (int)kernel.size() / 2, tmp.data());
  if (level == 0) {
    h_out = H;
    w_out = W;
    dst = std::move(smoothed);
    return;
  }
  h_out = (int)std::rint(H * scale);
  w_out = (int)std::rint(W * scale);
  dst.resize(h_out * w_out);
  for (int y = 0; y < h_out; ++y) {
    float sy = (y + 0.5f) * (float)H / h_out - 0.5f;
    for (int x = 0; x < w_out; ++x) {
      float sx = (x + 0.5f) * (float)W / w_out - 0.5f;
      dst[y * w_out + x] = bilinear(smoothed.data(), H, W, sy, sx);
    }
  }
}

}  // namespace

extern "C" {

// flow: output, H*W*2 floats interleaved as (..., 2) like OpenCV (dx, dy).
void farneback_flow(const float* im1, const float* im2, int H, int W,
                    float* flow_out, int levels, int winsize, int iterations,
                    int poly_n, float poly_sigma, int gaussian) {
  const float pyr_scale = 0.5f;
  // cv2 cap: `levels` counts downscale steps; stop before the short side
  // drops below 32 px. levels_used+1 pyramid images total.
  int min_side = H < W ? H : W;
  int levels_used = 0;
  for (int k = 0; k < levels; ++k) {
    if (min_side * std::pow((double)pyr_scale, k + 1) < 32.0) break;
    levels_used = k + 1;
  }

  vector<float> flow;
  int prev_h = 0, prev_w = 0;
  for (int level = levels_used; level >= 0; --level) {
    vector<float> l1, l2;
    int h, w;
    pyramid_level(im1, H, W, level, pyr_scale, l1, h, w);
    pyramid_level(im2, H, W, level, pyr_scale, l2, h, w);
    if (flow.empty()) {
      flow.assign(2 * h * w, 0.f);
    } else if (prev_h != h || prev_w != w) {
      // INTER_LINEAR upsample (half-pixel) + rescale by 1/pyr_scale
      vector<float> up(2 * h * w);
      for (int plane = 0; plane < 2; ++plane) {
        const float* src = flow.data() + plane * prev_h * prev_w;
        for (int y = 0; y < h; ++y) {
          float sy = (y + 0.5f) * (float)prev_h / h - 0.5f;
          for (int x = 0; x < w; ++x) {
            float sx = (x + 0.5f) * (float)prev_w / w - 0.5f;
            up[plane * h * w + y * w + x] =
                bilinear(src, prev_h, prev_w, sy, sx) / pyr_scale;
          }
        }
      }
      flow = std::move(up);
    }
    prev_h = h;
    prev_w = w;
    PolyExp p1, p2;
    polynomial_expansion(l1.data(), h, w, poly_n, poly_sigma, p1);
    polynomial_expansion(l2.data(), h, w, poly_n, poly_sigma, p2);
    for (int it = 0; it < iterations; ++it)
      update_flow(p1, p2, h, w, flow, winsize, gaussian != 0);
  }

  // planes -> interleaved (H, W, 2)
  const int N = H * W;
  for (int i = 0; i < N; ++i) {
    flow_out[2 * i] = flow[i];
    flow_out[2 * i + 1] = flow[N + i];
  }
}

// Warp image forward by flow (notebook remap semantics):
// dst(y, x) = src(y - fy, x - fx), NaN outside. flow interleaved (H, W, 2).
void remap_image(const float* image, const float* flow, int H, int W,
                 float* out) {
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      int i = y * W + x;
      float sx = x - flow[2 * i];
      float sy = y - flow[2 * i + 1];
      // cv2 BORDER_CONSTANT NaNs a sample whose bilinear support crosses
      // the edge — including EXACTLY the last row/column (the 0-weight
      // NaN tap still propagates), so the far bound is exclusive
      if (sx < 0.f || sy < 0.f || sx >= W - 1.f || sy >= H - 1.f) {
        out[i] = std::nanf("");
      } else {
        out[i] = bilinear(image, H, W, sy, sx);
      }
    }
  }
}

// Batched flow over a (T, H, W) sequence -> (T-1, H, W, 2).
void farneback_flow_sequence(const float* frames, int T, int H, int W,
                             float* flows_out, int levels, int winsize,
                             int iterations, int poly_n, float poly_sigma,
                             int gaussian) {
  const int N = H * W;
  for (int t = 0; t < T - 1; ++t) {
    farneback_flow(frames + t * N, frames + (t + 1) * N, H, W,
                   flows_out + t * N * 2, levels, winsize, iterations, poly_n,
                   poly_sigma, gaussian);
  }
}

}  // extern "C"
