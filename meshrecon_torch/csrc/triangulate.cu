// GN: per-pixel Gauss-Newton triangulation on z, as three kernels with the
// batch's global exit found on the card.
//
// Replaces the eager Gauss-Newton loop of meshrecon_torch/depth/
// triangulate.py (GaussNewtonBand and gauss_newton, the plain version,
// which the CPU keeps), the port of the XLA while_loop of
// meshrecon/depth/triangulate.py:295 (no TPU kernel: XLA fuses each sweep
// there). Each pixel minimises its reprojection residuals in K side views
// over its NDC depth z; an item (a main frame) stops once at most `tail`
// of its pixels are still moving after at least `min_sweeps` sweeps, or
// after gn_iters, and the batch sweeps while any item has not stopped. The
// exit rule's numbers and the background depth are the caller's (depth/
// triangulate.py's constants), passed in.
//
// Why the exit can be found afterwards. A pixel's sweep reads no other
// pixel, an inactive pixel takes no step and stays inactive, and a stopped
// item changes nothing. So if pixel p goes inactive after its own step
// t_p (0 if it never starts, gn_iters if it never stops within the cap),
// its z after s sweeps is its z after min(s, t_p) steps, and an item's
// active count after s sweeps is the number of its pixels with t_p > s: a
// histogram of t_p per item gives each item's stop sweep S_b exactly.
//
//   - GN_SOBEL (mr_gn_sobel): the depth window's Sobel gradients, which
//     both walk and finish read.
//   - GN_WALK (mr_gn_walk): a thread a pixel derives its per-side terms
//     (n0x, n0y, w0, the measured projection, the inverse covariance)
//     from the flows, the variance and the depth window, walks up to
//     gn_iters steps while active, writes z and t_p, and adds t_p to its
//     item's histogram (shared-memory counts, then global atomics).
//   - GN_EXIT (mr_gn_exit): one CTA turns the histograms (summed over a
//     tile group's bands beforehand, exact integers) into S_b, the batch's
//     sweep count (the largest S_b) and the pixel-steps taken, which the
//     host reads once, with the main cameras' inversion status.
//   - GN_FINISH (mr_gn_finish): a thread a pixel derives the terms again,
//     keeps the walk's z where t_p <= S_b and otherwise replays S_b steps,
//     then writes point4, pdf and valid with GaussNewtonBand.result's
//     arithmetic (log(0.159) taken on the card from an argument).
//
// Rounding. Every operation is the eager path's, in its order (-fmad=false,
// IEEE division, the eager constants rounded from double to float as
// torch rounds a Python scalar). The sums over sides take torch's CUDA
// reduction order for a sum over dim 1 of K <= 128 planes: four
// accumulators, side k into accumulator k % 4, each started at 0, then
// ((a0 + a1) + a2) + a3. Sides whose side_valid is false are skipped: the
// eager sums add their exact zeros (their inverse covariance is multiplied
// by 0, their log-determinant is log 1), which differs only where such a
// side's terms are not finite.
//
// What bounds it. Each pixel's terms read its K flows and variances (12
// bytes a side) and, with exact sampling, 12 taps of the depth window and
// its gradients; a step is ~25 float operations and one IEEE reciprocal a
// side. At 4x8x480x640 and the 50-sweep cap that is ~120 MB read twice
// and at most ~12 GFLOP, which a pixel pays only while it is active (a
// warp while any of its pixels is). The terms stay in registers for K <=
// kRegSides (GnTerms); a larger bucket (--max-sides 0) derives each
// side's terms again at every step from the same inputs, with the same
// operations, so both forms give the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRegSides = 8;  // sides whose terms a thread keeps in registers
constexpr int kMaxSmem = 48 * 1024;  // dynamic shared memory without opt-in
// the eager path's Python constants, rounded once from double to float
constexpr float kTinyW = (float)1e-12;
constexpr float kTinyDet = (float)1e-20;
constexpr float kTinySecond = (float)1e-30;
constexpr float kMinVariance = (float)1e-2;
constexpr float kMinStep = (float)1e-7;
constexpr float kMinDetIc = (float)1e-30;

struct GnArgs {
  const float* flx;  // (n, k, rows, width), element step flow_step
  const float* fly;
  const float* var;  // (n, k, rows, width)
  const float* depth;  // (n, depth_rows, width): rows [depth_row0, ...)
  const float* gx;     // its Sobel gradients, same shape
  const float* gy;
  const float* cm;  // (n, k, 4, 4): side camera @ main camera inverse
  const unsigned char* side_valid;  // (n, k)
  int n, k, rows, width, height, row0, depth_row0, depth_rows, flow_step;
  float sx, sy;
  float background;  // the depth of a pixel with no surface
};

// One side's frozen terms at a pixel (GaussNewtonBand's planes).
struct Side {
  float n0x, n0y, w0, mx, my, ic11, ic12, ic22;
};

struct Pixel {
  long long at;     // in (n, rows, width)
  long long side0;  // side 0's element in (n, k, rows, width)
  long long plane;  // rows * width
  long long win;    // the item's depth window's first element
  float col, row, x, y, dep, gx, gy;
  bool center_valid;
};

// torch.clamp's: NaN passes through
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return v < lo ? lo : v;
}

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ Pixel make_pixel(const GnArgs& a, int b,
                                            long long i) {
  Pixel p;
  p.plane = (long long)a.rows * a.width;
  p.at = (long long)b * p.plane + i;
  p.side0 = (long long)b * a.k * p.plane + i;
  const int r = (int)(i / a.width);
  const int c = (int)(i - (long long)r * a.width);
  p.col = (float)c;
  p.row = (float)(a.row0 + r);
  // x = (cols - w / 2.0) * sx, y = (h / 2.0 - rows) * sy
  p.x = (p.col - 0.5f * (float)a.width) * a.sx;
  p.y = (0.5f * (float)a.height - p.row) * a.sy;
  p.win = (long long)b * a.depth_rows * a.width;
  const long long d =
      p.win + (long long)(a.row0 - a.depth_row0 + r) * a.width + c;
  p.dep = a.depth[d];
  p.gx = a.gx[d];
  p.gy = a.gy[d];
  p.center_valid = p.dep != a.background;
  return p;
}

// Side k's terms at pixel p (GaussNewtonBand.__init__, operation for
// operation); returns its mz_ndc >= -1 test. m: the side's 16 camera
// products.
template <bool kExact>
__device__ __forceinline__ bool side_terms(const GnArgs& a, const float* m,
                                           const Pixel& p, int k, Side& s) {
  const long long at = p.side0 + (long long)k * p.plane;
  const float flx = a.flx[at * a.flow_step];
  const float fly = a.fly[at * a.flow_step];
  const float fcol = p.col + flx;
  const float frow = p.row + fly;
  float zk, g1, g2;
  if (kExact) {
    // _bilinear_plane on the depth window and its gradients
    const float cf = floorf(fcol), rf = floorf(frow);
    const long long c0 = isnan(cf) ? 0 : (long long)cf;
    const long long r0 = isnan(rf) ? 0 : (long long)rf;
    const bool inside =
        c0 >= 1 && c0 < a.width - 1 && r0 >= 1 && r0 < a.height - 1;
    const long long cc = min(max(c0, 0LL), (long long)a.width - 2);
    const long long rc = min(max(r0, 0LL), (long long)a.height - 2);
    // the taps lie in the window wherever its reach is the band's
    // (sharding/tiles.py); the clamp only keeps reads in bounds
    const long long rl =
        min(max(rc - a.depth_row0, 0LL), (long long)a.depth_rows - 2);
    const long long t = p.win + rl * a.width + cc;
    const long long w = a.width;
    const float v00 = a.depth[t], v01 = a.depth[t + 1];
    const float v10 = a.depth[t + w], v11 = a.depth[t + w + 1];
    const float fc = fcol - (float)cc;
    const float fr = frow - (float)rc;
    const bool good = inside && v00 != a.background &&
                      v01 != a.background && v10 != a.background &&
                      v11 != a.background;
    if (good) {
      zk = mr_bilinear_mix(v00, v01, v10, v11, fr, fc);
      g1 = mr_bilinear_mix(a.gx[t], a.gx[t + 1], a.gx[t + w], a.gx[t + w + 1],
                           fr, fc);
      g2 = mr_bilinear_mix(a.gy[t], a.gy[t + 1], a.gy[t + w], a.gy[t + w + 1],
                           fr, fc);
    } else {
      zk = p.dep;
      g1 = p.gx;
      g2 = p.gy;
    }
  } else {
    // Sobel is 8x the central-difference derivative per pixel step
    float zt = p.dep + (p.gx * flx + p.gy * fly) * 0.125f;
    zt = clamp_nan(zt, -1.0f, 1.0f);
    const bool good = fcol >= 1.0f && fcol < (float)(a.width - 1) &&
                      frow >= 1.0f && frow < (float)(a.height - 1) &&
                      p.center_valid;
    zk = good ? zt : p.dep;
    g1 = p.gx;
    g2 = p.gy;
  }
  const float mxi = p.x + flx * a.sx;
  const float myi = p.y + fly * a.sy;
  const float m0 = ((m[0] * mxi + m[1] * myi) + m[2] * zk) + m[3];
  const float m1 = ((m[4] * mxi + m[5] * myi) + m[6] * zk) + m[7];
  const float m2 = ((m[8] * mxi + m[9] * myi) + m[10] * zk) + m[11];
  const float m3 = ((m[12] * mxi + m[13] * myi) + m[14] * zk) + m[15];
  const float mw = fabsf(m3) < kTinyW ? kTinyW : m3;
  s.mx = m0 / mw;
  s.my = m1 / mw;
  const float mz = m2 / mw;
  const float a11 = (m[0] + m[2] * g1) / mw;
  const float a12 = (m[1] + m[2] * g2) / mw;
  const float a21 = (m[4] + m[6] * g1) / mw;
  const float a22 = (m[5] + m[6] * g2) / mw;
  const float s11 = a11 * a11 + a12 * a12;
  const float s12 = a11 * a21 + a12 * a22;
  const float s22 = a21 * a21 + a22 * a22;
  float det = s11 * s22 - s12 * s12;
  det = fabsf(det) < kTinyDet ? kTinyDet : det;
  const float dv = det * clamp_min_nan(a.var[at], kMinVariance);
  s.ic11 = s22 / dv;
  s.ic12 = -s12 / dv;
  s.ic22 = s11 / dv;
  s.n0x = (m[0] * p.x + m[1] * p.y) + m[3];
  s.n0y = (m[4] * p.x + m[5] * p.y) + m[7];
  s.w0 = (m[12] * p.x + m[13] * p.y) + m[15];
  return mz >= -1.0f;
}

// GaussNewtonBand.residuals for one side
__device__ __forceinline__ void residual(const Side& s, const float* m,
                                         float z, float& rx, float& ry,
                                         float& inv) {
  float wi = s.w0 + m[14] * z;
  wi = fabsf(wi) < kTinyW ? kTinyW : wi;
  inv = 1.0f / wi;
  rx = (s.n0x + m[2] * z) * inv - s.mx;
  ry = (s.n0y + m[6] * z) * inv - s.my;
}

// One side's (first, second) terms of a step, added to accumulator j
__device__ __forceinline__ void step_side(const Side& s, const float* m,
                                          float z, float* af, float* ag,
                                          int j) {
  float rx, ry, inv;
  residual(s, m, z, rx, ry, inv);
  const float dpx = m[2] * inv;
  const float dpy = m[6] * inv;
  const float tx = s.ic11 * dpx + s.ic12 * dpy;
  const float ty = s.ic12 * dpx + s.ic22 * dpy;
  af[j] = af[j] + (rx * tx + ry * ty);
  ag[j] = ag[j] + (dpx * tx + dpy * ty);
}

// One side's (quad, log det) terms of the result, added to accumulator j
__device__ __forceinline__ void result_side(const Side& s, const float* m,
                                            float z, float* aq, float* al,
                                            int j) {
  float rx, ry, inv;
  residual(s, m, z, rx, ry, inv);
  aq[j] = aq[j] + (rx * (s.ic11 * rx + s.ic12 * ry) +
                   ry * (s.ic12 * rx + s.ic22 * ry));
  const float det = clamp_min_nan(s.ic11 * s.ic22 - s.ic12 * s.ic12,
                                  kMinDetIc);
  al[j] = al[j] + logf(det);
}

__device__ __forceinline__ float combine(const float* acc) {
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
}

// A thread's terms: in registers for k <= kRegSides, else derived again
// at each use.
template <bool kExact, bool kRegs>
struct GnTerms {
  Side side[kRegs ? kRegSides : 1];

  // Derive (registers) or test every valid side; returns ok_pixel's
  // all-sides test.
  __device__ __forceinline__ bool fill(const GnArgs& a, const float* cm,
                                       const unsigned char* valid,
                                       const Pixel& p) {
    bool ok = true;
    if (kRegs) {
#pragma unroll
      for (int k = 0; k < kRegSides; ++k) {
        if (k < a.k && valid[k]) {
          ok = side_terms<kExact>(a, cm + 16 * k, p, k, side[k]) && ok;
        }
      }
    } else {
      for (int k = 0; k < a.k; ++k) {
        if (valid[k]) {
          Side s;
          ok = side_terms<kExact>(a, cm + 16 * k, p, k, s) && ok;
        }
      }
    }
    return ok;
  }

  // One Gauss-Newton step's dz at z (GaussNewtonBand.step)
  __device__ __forceinline__ float step(const GnArgs& a, const float* cm,
                                        const unsigned char* valid,
                                        const Pixel& p, float z) const {
    float af[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float ag[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (kRegs) {
#pragma unroll
      for (int k = 0; k < kRegSides; ++k) {
        if (k < a.k && valid[k]) {
          step_side(side[k], cm + 16 * k, z, af, ag, k & 3);
        }
      }
    } else {
      for (int k0 = 0; k0 < a.k; k0 += 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + j;
          if (k < a.k && valid[k]) {
            Side s;
            side_terms<kExact>(a, cm + 16 * k, p, k, s);
            step_side(s, cm + 16 * k, z, af, ag, j);
          }
        }
      }
    }
    const float first = combine(af);
    float second = combine(ag);
    second = fabsf(second) < kTinySecond ? kTinySecond : second;
    return -first / second;
  }

  // (the sum of quad, the sum of log det_ic) at z (GaussNewtonBand.result)
  __device__ __forceinline__ void result(const GnArgs& a, const float* cm,
                                         const unsigned char* valid,
                                         const Pixel& p, float z,
                                         float& quad, float& logdet) const {
    float aq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float al[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (kRegs) {
#pragma unroll
      for (int k = 0; k < kRegSides; ++k) {
        if (k < a.k && valid[k]) {
          result_side(side[k], cm + 16 * k, z, aq, al, k & 3);
        }
      }
    } else {
      for (int k0 = 0; k0 < a.k; k0 += 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + j;
          if (k < a.k && valid[k]) {
            Side s;
            side_terms<kExact>(a, cm + 16 * k, p, k, s);
            result_side(s, cm + 16 * k, z, aq, al, j);
          }
        }
      }
    }
    quad = combine(aq);
    logdet = combine(al);
  }
};

// The item's camera products and side flags into shared memory
__device__ __forceinline__ void stage_item(const GnArgs& a, int b, float* cm,
                                           unsigned char* valid) {
  const float* src = a.cm + (long long)b * a.k * 16;
  for (int j = threadIdx.x; j < 16 * a.k; j += blockDim.x) cm[j] = src[j];
  for (int j = threadIdx.x; j < a.k; j += blockDim.x) {
    valid[j] = a.side_valid[(long long)b * a.k + j];
  }
}

// grid (pixel blocks of the band, n): a CTA holds one item's pixels
template <bool kExact, bool kRegs>
__global__ void __launch_bounds__(kThreads)
    gn_walk_kernel(GnArgs a, int gn_iters, int smem_bins, float* z_out,
                   int* t_out, int* hist) {
  extern __shared__ float smem[];
  float* cm = smem;
  int* bins = reinterpret_cast<int*>(smem + 16 * a.k);
  unsigned char* valid = reinterpret_cast<unsigned char*>(bins + smem_bins);
  const int b = blockIdx.y;
  stage_item(a, b, cm, valid);
  for (int j = threadIdx.x; j < smem_bins; j += blockDim.x) bins[j] = 0;
  __syncthreads();
  const long long plane = (long long)a.rows * a.width;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  int t = 0;
  if (i < plane) {
    const Pixel p = make_pixel(a, b, i);
    GnTerms<kExact, kRegs> terms;
    bool active = terms.fill(a, cm, valid, p) && p.center_valid;
    float z = p.dep;
    while (active && t < gn_iters) {
      const float dz = terms.step(a, cm, valid, p, z);
      z = z + dz;
      ++t;
      active = fabsf(dz) >= kMinStep;
    }
    z_out[p.at] = z;
    t_out[p.at] = t;
  }
  int* item_hist = hist + (long long)b * (gn_iters + 1);
  if (smem_bins) {
    if (t > 0) atomicAdd(&bins[t], 1);
    __syncthreads();
    for (int j = threadIdx.x; j < smem_bins; j += blockDim.x) {
      if (bins[j]) atomicAdd(&item_hist[j], bins[j]);
    }
  } else if (t > 0) {
    atomicAdd(&item_hist[t], 1);
  }
}

// one CTA: each item's stop sweep from its histogram, the largest, the
// pixel-steps taken and the singular main cameras
__global__ void gn_exit_kernel(const int* hist, const int* inv_status, int n,
                               int gn_iters, int tail, int min_sweeps,
                               int* stop, long long* info) {
  __shared__ int sweeps, singular;
  __shared__ unsigned long long steps;
  if (threadIdx.x == 0) {
    sweeps = 0;
    singular = 0;
    steps = 0;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n; b += blockDim.x) {
    if (inv_status[b] != 0) atomicAdd(&singular, 1);
    const int* h = hist + (long long)b * (gn_iters + 1);
    long long active = 0;  // pixels with t_p > s, at s = 0
    for (int t = 1; t <= gn_iters; ++t) active += h[t];
    int s = 0;
    while (active > (s < min_sweeps ? 0 : tail) && s < gn_iters) {
      ++s;
      active -= h[s];
    }
    unsigned long long taken = 0;  // sum of min(s, t_p)
    for (int t = 1; t <= gn_iters; ++t) {
      taken += (unsigned long long)h[t] * (unsigned long long)min(s, t);
    }
    stop[b] = s;
    atomicMax(&sweeps, s);
    atomicAdd(&steps, taken);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    info[0] = sweeps;
    info[1] = (long long)steps;
    info[2] = singular;
  }
}

template <bool kExact, bool kRegs>
__global__ void __launch_bounds__(kThreads)
    gn_finish_kernel(GnArgs a, const float* z_walk, const int* t_walk,
                     const int* stop, const float* main_inv, float pdf_scale,
                     float* point4, float* pdf, unsigned char* valid_out) {
  extern __shared__ float smem[];
  float* cm = smem;
  unsigned char* valid = reinterpret_cast<unsigned char*>(smem + 16 * a.k);
  const int b = blockIdx.y;
  stage_item(a, b, cm, valid);
  __syncthreads();
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)a.rows * a.width) return;
  const Pixel p = make_pixel(a, b, i);
  GnTerms<kExact, kRegs> terms;
  const bool ok = terms.fill(a, cm, valid, p) && p.center_valid;
  const int sweeps = stop[b];
  float z;
  if (t_walk[p.at] <= sweeps) {
    z = z_walk[p.at];
  } else {  // active through all of the item's sweeps
    z = p.dep;
    for (int t = 0; t < sweeps; ++t) z = z + terms.step(a, cm, valid, p, z);
  }
  float quad, logdet;
  terms.result(a, cm, valid, p, z, quad, logdet);
  const float exponent = -quad;
  const float log_pdf = (logf(pdf_scale) + logdet) + 0.5f * exponent;
  pdf[p.at] = expf(clamp_nan(log_pdf, -30.0f, 30.0f));
  const float* mi = main_inv + 16 * b;
  float4 q;
  q.x = ((mi[0] * p.x + mi[1] * p.y) + mi[2] * z) + mi[3];
  q.y = ((mi[4] * p.x + mi[5] * p.y) + mi[6] * z) + mi[7];
  q.z = ((mi[8] * p.x + mi[9] * p.y) + mi[10] * z) + mi[11];
  q.w = ((mi[12] * p.x + mi[13] * p.y) + mi[14] * z) + mi[15];
  reinterpret_cast<float4*>(point4)[p.at] = q;
  valid_out[p.at] = ok && z >= -1.0f && z <= 1.0f;
}

// grid-stride over (n, rows, width): the window's Sobel gradients
// (depth/triangulate.py's sobel_gradient: reflect-101 at its edges)
__global__ void gn_sobel_kernel(const float* __restrict__ depth,
                                float* __restrict__ gx,
                                float* __restrict__ gy, long long total,
                                int rows, int width) {
  const long long plane = (long long)rows * width;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / plane;
    const int r = (int)((i - b * plane) / width);
    const int c = (int)(i - b * plane - (long long)r * width);
    const float* d = depth + b * plane;
    const long long up = (long long)(r == 0 ? 1 : r - 1) * width;
    const long long mid = (long long)r * width;
    const long long down = (long long)(r == rows - 1 ? rows - 2 : r + 1) *
                           width;
    const int left = c == 0 ? 1 : c - 1;
    const int right = c == width - 1 ? width - 2 : c + 1;
    gx[i] = ((d[up + right] - d[up + left]) +
             2.0f * (d[mid + right] - d[mid + left])) +
            (d[down + right] - d[down + left]);
    gy[i] = ((d[down + left] - d[up + left]) +
             2.0f * (d[down + c] - d[up + c])) +
            (d[down + right] - d[up + right]);
  }
}

bool args_ok(const GnArgs& a) {
  return a.n >= 0 && a.n <= 65535 && a.k >= 0 && a.rows >= 0 &&
         a.width >= 2 && a.height >= 2 && a.depth_rows >= 2 &&
         a.row0 >= a.depth_row0 &&
         a.row0 + a.rows <= a.depth_row0 + a.depth_rows &&
         a.depth_row0 + a.depth_rows <= a.height && a.flow_step >= 1;
}

// Shared memory of a CTA: the item's camera products and side flags
int item_smem(int k) { return 16 * k * (int)sizeof(float) + k; }

}  // namespace

// depth, gx, gy: (n, rows, width), rows >= 2 and width >= 2
MR_EXPORT int mr_gn_sobel(const float* depth, float* gx, float* gy, int n,
                          int rows, int width, void* stream) {
  if (n < 0 || rows < 2 || width < 2) return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * rows * width;
  if (total == 0) return 0;
  const int blocks = (int)min((total + kThreads - 1) / kThreads, 65536LL);
  gn_sobel_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      depth, gx, gy, total, rows, width);
  return (int)cudaGetLastError();
}

// flx, fly: (n, k, rows, width) at element step flow_step (2: the two
// channels of one (..., 2) flow tensor); var: (n, k, rows, width); depth,
// gx, gy: (n, depth_rows, width), rows [depth_row0, depth_row0 +
// depth_rows) of an image of `height` rows, holding the band's rows
// [row0, row0 + rows) and every tap; cm (n, k, 4, 4); side_valid (n, k)
// bytes. Writes z_out, t_out (n, rows, width) and adds to hist (n,
// gn_iters + 1), which the caller zeroes. background: the depth of a
// pixel with no surface (BACKGROUND_DEPTH).
MR_EXPORT int mr_gn_walk(const float* flx, const float* fly, const float* var,
                         const float* depth, const float* gx, const float* gy,
                         const float* cm, const unsigned char* side_valid,
                         float* z_out, int* t_out, int* hist, int exact, int n,
                         int k, int rows, int width, int height, int row0,
                         int depth_row0, int depth_rows, int flow_step,
                         int gn_iters, float sx, float sy, float background,
                         void* stream) {
  const GnArgs a{flx,        fly,       var,        depth, gx,
                 gy,         cm,        side_valid, n,     k,
                 rows,       width,     height,     row0,  depth_row0,
                 depth_rows, flow_step, sx,         sy,    background};
  // the histogram's bins in shared memory where they fit
  const int base = item_smem(k);
  const int bins =
      base + (gn_iters + 1) * (int)sizeof(int) <= kMaxSmem ? gn_iters + 1 : 0;
  const int smem = base + bins * (int)sizeof(int);
  if (!args_ok(a) || gn_iters < 0 || base > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const long long plane = (long long)rows * width;
  if (plane * n == 0) return 0;
  const dim3 grid(mr_blocks(plane, kThreads), n);
  cudaStream_t s = (cudaStream_t)stream;
  const bool regs = k <= kRegSides;
  if (exact && regs) {
    gn_walk_kernel<true, true><<<grid, kThreads, smem, s>>>(
        a, gn_iters, bins, z_out, t_out, hist);
  } else if (exact) {
    gn_walk_kernel<true, false><<<grid, kThreads, smem, s>>>(
        a, gn_iters, bins, z_out, t_out, hist);
  } else if (regs) {
    gn_walk_kernel<false, true><<<grid, kThreads, smem, s>>>(
        a, gn_iters, bins, z_out, t_out, hist);
  } else {
    gn_walk_kernel<false, false><<<grid, kThreads, smem, s>>>(
        a, gn_iters, bins, z_out, t_out, hist);
  }
  return (int)cudaGetLastError();
}

// hist (n, gn_iters + 1) and the main cameras' inversion status (n,)
// (torch.linalg.inv_ex's info) -> stop (n,) int32 and info (3,) int64:
// the batch's sweeps, the pixel-steps taken and the singular cameras. An
// item stops at the first sweep s with at most (s < min_sweeps ? 0 :
// tail) pixels active, or at gn_iters.
MR_EXPORT int mr_gn_exit(const int* hist, const int* inv_status, int* stop,
                         long long* info, int n, int gn_iters, int tail,
                         int min_sweeps, void* stream) {
  if (n < 0 || gn_iters < 0 || tail < 0 || min_sweeps < 0) {
    return (int)cudaErrorInvalidValue;
  }
  gn_exit_kernel<<<1, 256, 0, (cudaStream_t)stream>>>(
      hist, inv_status, n, gn_iters, tail, min_sweeps, stop, info);
  return (int)cudaGetLastError();
}

// The walk's inputs, its z_walk and t_walk, stop (n,) from mr_gn_exit and
// main_inv (n, 4, 4); writes point4 (n, rows, width, 4), pdf (n, rows,
// width) and valid (n, rows, width) bytes. pdf_scale: 0.159, whose log
// is taken on the card.
MR_EXPORT int mr_gn_finish(const float* flx, const float* fly,
                           const float* var, const float* depth,
                           const float* gx, const float* gy, const float* cm,
                           const unsigned char* side_valid,
                           const float* z_walk, const int* t_walk,
                           const int* stop, const float* main_inv,
                           float* point4, float* pdf, unsigned char* valid,
                           int exact, int n, int k, int rows, int width,
                           int height, int row0, int depth_row0,
                           int depth_rows, int flow_step, float sx, float sy,
                           float background, float pdf_scale, void* stream) {
  const GnArgs a{flx,        fly,       var,        depth, gx,
                 gy,         cm,        side_valid, n,     k,
                 rows,       width,     height,     row0,  depth_row0,
                 depth_rows, flow_step, sx,         sy,    background};
  const int smem = item_smem(k);
  if (!args_ok(a) || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long plane = (long long)rows * width;
  if (plane * n == 0) return 0;
  const dim3 grid(mr_blocks(plane, kThreads), n);
  cudaStream_t s = (cudaStream_t)stream;
  const bool regs = k <= kRegSides;
  if (exact && regs) {
    gn_finish_kernel<true, true><<<grid, kThreads, smem, s>>>(
        a, z_walk, t_walk, stop, main_inv, pdf_scale, point4, pdf, valid);
  } else if (exact) {
    gn_finish_kernel<true, false><<<grid, kThreads, smem, s>>>(
        a, z_walk, t_walk, stop, main_inv, pdf_scale, point4, pdf, valid);
  } else if (regs) {
    gn_finish_kernel<false, true><<<grid, kThreads, smem, s>>>(
        a, z_walk, t_walk, stop, main_inv, pdf_scale, point4, pdf, valid);
  } else {
    gn_finish_kernel<false, false><<<grid, kThreads, smem, s>>>(
        a, z_walk, t_walk, stop, main_inv, pdf_scale, point4, pdf, valid);
  }
  return (int)cudaGetLastError();
}
