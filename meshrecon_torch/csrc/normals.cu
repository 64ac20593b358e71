// NORMALS: per-pixel surface normals from windowed moment sums, as two
// kernels.
//
// Replaces the eager ops of meshrecon_torch/depth/normals.py
// (estimate_normals_batched, the plain version, which the CPU keeps), the
// port of meshrecon/depth/normals.py. The JAX package has no TPU kernel
// for it: XLA fuses the normals there. Eager, the stage is ~700 launches
// at B=4, 480x640 and 16 camera centres (the window sums' shifted adds and
// concatenations over a (B, 10, H, W) moment stack, a dozen ops a centre);
// here it is two:
//
//   - NORMALS_COLS (mr_normals_cols): a CTA takes kColW columns of a strip
//     of kSpan - 2r output rows of one frame. It stages each pixel's
//     (vmask, px, py, pz) for the strip and its r rows above and below
//     (zero outside the frame); then a thread takes one of the 10 moments
//     (vmask, p, p p^T) of one column, its kSpan rows in registers, and
//     forms its vertical box sum of 2r+1 rows in the eager path's own tree
//     (_window_sums_chw): the doubled levels P_2k(u) = P_k(u) + P_k(u + k)
//     and the terms of the set bits of 2r+1 at their running offsets,
//     added lowest bit first. It writes the column sums to a (B, 10, H, W)
//     scratch. So r <= 31 (kSpan = 64).
//   - NORMALS_FINISH (mr_normals_finish): a CTA takes kSeg pixels of one
//     row. It stages their 10 column sums and `radius` columns either side
//     (zero outside the frame), forms the horizontal box sum in the same
//     tree, and then, a thread a pixel: where the window holds fewer than
//     3 points the fallback (the centres' inverse-distance directions),
//     elsewhere the means and covariance, the +eps diagonal, the analytic
//     smallest eigenvector, the vote over the frame's camera centres and
//     the flip; then pdf^(1/k), the scale and the finiteness guard. It
//     writes the (B, H, W, 3) normals.
//
// Rounding. Every operation is the eager path's, in its order (-fmad=false,
// IEEE division and square root, the Python constants rounded from double
// to float as torch rounds a scalar). A division by a Python scalar is
// torch's CUDA multiplication by the float reciprocal (`/ 3.0` is
// `* (1.0f / 3.0f)`); `1.0 / t` is torch's reciprocal; torch.clamp and
// torch.maximum pass NaN through; acosf, cosf, powf and sqrtf are the
// functions torch's kernels call. Operands outside the frame are +0.0, as
// the eager path's zero pads and zero-filled shifts are. The eager path
// computes the fallback and the vote at every pixel and keeps one; each is
// computed here only where it is kept, with the same operations. A padded
// centre (centers_valid false) adds 0 / ndot to the vote, which leaves it
// as it is unless ndot is NaN (the sum starts at +0 and is never -0), so
// its division is made only there; the fallback keeps every centre, and is
// computed once a CTA, by a warp, for a point at the origin (every invalid
// pixel's: p / w4 * 0), where +0 and -0 give the same sums. So the outputs
// are the eager path's bit for bit.
//
// What bounds it. Bytes. Each input byte read once and each output byte
// written once, NORMALS_COLS moves 57 bytes a pixel (point4 and valid in,
// 10 column sums out) and NORMALS_FINISH 73 (the sums, point4, valid and
// pdf in, the normal out): at B=4, 480x640 that is 160 MB, ~0.048 ms at
// 3.35 TB/s. The arithmetic is ~0.3 GFLOP (the box sums' adds, a division
// a real centre in the vote, acosf, cosf, powf), ~0.005 ms at 67 TFLOP/s.
// Shared memory is the narrower path inside the card, so NORMALS_COLS keeps
// a thread's whole window and its levels in registers (every index a
// constant, and at the default radius the tree's shape too) and issues all
// of its loads before it uses the first; NORMALS_FINISH runs its levels
// over the flattened (moment, column) rows, folds a level that is no term
// into the next, divides only where the eager path keeps the quotient, and
// takes the background's fallback from its CTA's one, whose divisions a
// warp makes side by side (one thread's chain of them held every CTA at
// its first barrier). What is left: NORMALS_FINISH's levels cost ~150
// shared-memory accesses a pixel, and a pixel's vote ~20% of its time.
#include "common.cuh"

namespace {

constexpr int kMoments = 10;  // vmask, px, py, pz, xx, yy, zz, xy, xz, yz
constexpr int kColW = 32;     // NORMALS_COLS: columns a CTA (a warp)
constexpr int kSpan = 64;     // its rows: a strip of 64 - 2r and its reach
constexpr int kSeg = 128;     // NORMALS_FINISH: pixels (threads) a CTA
constexpr int kPad = kSpan / 2;  // past its level rows: the largest read
// the radius every caller passes (depth/normals.py's default): NORMALS_COLS
// takes it as a constant, so that the compiler drops the rows and levels of
// the window that no output reads (96 registers a thread and two CTAs an
// SM, against 168 and one for a radius given at run time)
constexpr int kRadius = 10;
// the eager path's Python constants, rounded once from double to float
constexpr float kTinyW = (float)1e-20;
constexpr float kEps = (float)1e-12;
constexpr float kTinyP2 = (float)1e-30;  // also the isotropic test
constexpr float kTiny = (float)1e-12;    // ndot, d2 and the length
constexpr float kThird = 1.0f / 3.0f;    // torch: x * (1.0f / 3.0f)
constexpr float kSixth = 1.0f / 6.0f;
constexpr float kTwoThirdsPi = (float)(2.0 * 3.141592653589793 / 3.0);

struct Point {
  float v, x, y, z;  // vmask and p / w4 * vmask
};

// torch.clamp's and torch.maximum's: NaN passes through
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float maximum_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// a pixel's (vmask, p / w4 * vmask) from its point4 and valid byte
__device__ __forceinline__ Point make_point(float4 q, unsigned char valid) {
  const float w4 = fabsf(q.w) < kTinyW ? 1.0f : q.w;
  Point p;
  p.v = valid ? 1.0f : 0.0f;
  p.x = q.x / w4 * p.v;
  p.y = q.y / w4 * p.v;
  p.z = q.z / w4 * p.v;
  return p;
}

// The levels of NORMALS_COLS's tree from P_k on, k = K: v[u] holds P_k(u +
// off). P_2k(u + off) is v[u] + v[u + k]; where 2k is a bit of `size` it is
// a term, added to acc, and v shifts down by 2k. K is a template argument
// so that every index is a constant and v and acc stay in registers; R,
// where it is not -1, is the radius, and size 2R + 1 a constant too.
template <int R, int K>
__device__ __forceinline__ void levels(float (&v)[kSpan], float (&acc)[kSpan],
                                       int size_rt) {
  const int size = R >= 0 ? 2 * R + 1 : size_rt;
  if constexpr (2 * K < kSpan) {
    if (2 * K > size) return;
#pragma unroll
    for (int u = 0; u + K < kSpan; ++u) v[u] = v[u] + v[u + K];
    if (size & (2 * K)) {
#pragma unroll
      for (int o = 0; o < kSpan; ++o) acc[o] = acc[o] + v[o];
#pragma unroll
      for (int u = 0; u + 2 * K < kSpan; ++u) v[u] = v[u + 2 * K];
    }
    levels<R, 2 * K>(v, acc, size);
  }
}

// NORMALS_COLS. A CTA takes kColW columns of a strip of kSpan - 2r output
// rows of a frame. A thread stages rows m, m + 10, ... of its column, then
// takes moment m (threadIdx.y) of its column: the kSpan rows of its window
// in registers, v[u] holding P_k(u + off), off the sum of the bits of 2r+1
// below k already taken as terms: P_2k is v[u] + v[u + k], and a term is
// v[o], after which v shifts down by its bit (levels), so every index is a
// constant. R is the radius (kRadius), or -1 for radius_rt.
template <int R>
__global__ void __launch_bounds__(kColW * kMoments, R >= 0 ? 2 : 1)
    normals_cols_kernel(const float4* __restrict__ p4,
                        const unsigned char* __restrict__ valid,
                        float* __restrict__ sums, int p4_stride,
                        int valid_stride, int height, int width,
                        int radius_rt) {
  const int radius = R >= 0 ? R : radius_rt;
  __shared__ float pts[4][kSpan][kColW];  // vmask, px, py, pz
  const int strip = kSpan - 2 * radius;
  const int size = 2 * radius + 1;
  const int tx = threadIdx.x, m = threadIdx.y, b = blockIdx.z;
  const int x = blockIdx.x * kColW + tx;
  const int y0 = blockIdx.y * strip;
  // every row's loads first, so that they are in flight together
  constexpr int kRowsEach = (kSpan + kMoments - 1) / kMoments;
  float4 raw[kRowsEach];
  unsigned char vb[kRowsEach];
#pragma unroll
  for (int i = 0; i < kRowsEach; ++i) {
    const int u = m + i * kMoments, y = y0 - radius + u;
    raw[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    vb[i] = 0;
    if (u < kSpan && x < width && y >= 0 && y < height) {
      const long long at = (long long)y * width + x;
      raw[i] = p4[(long long)b * (p4_stride / 4) + at];
      vb[i] = valid[(long long)b * valid_stride + at];
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsEach; ++i) {
    const int u = m + i * kMoments;
    if (u < kSpan) {  // zero outside the frame
      const Point q = make_point(raw[i], vb[i]);
      pts[0][u][tx] = q.v;
      pts[1][u][tx] = q.x;
      pts[2][u][tx] = q.y;
      pts[3][u][tx] = q.z;
    }
  }
  __syncthreads();
  // moment m in the eager stack's order: vmask, px, py, pz, then the
  // products px px, py py, pz pz, px py, px pz, py pz
  const int fa = m < 4 ? m : (m < 7 ? m - 3 : (m < 9 ? 1 : 2));
  const int fb = m < 4 ? m : (m < 7 ? m - 3 : (m == 7 ? 2 : 3));
  float v[kSpan];
#pragma unroll
  for (int u = 0; u < kSpan; ++u) {
    const float a = pts[fa][u][tx];
    v[u] = m < 4 ? a : a * pts[fb][u][tx];
  }
  // 2r+1 is odd: its first term is P_1 at offset 0
  float acc[kSpan];
#pragma unroll
  for (int o = 0; o < kSpan; ++o) acc[o] = v[o];
#pragma unroll
  for (int u = 0; u + 1 < kSpan; ++u) v[u] = v[u + 1];
  levels<R, 1>(v, acc, size);
  if (x >= width) return;
  float* out = sums + ((long long)b * kMoments + m) * height * width + x;
#pragma unroll
  for (int o = 0; o < kSpan; ++o) {
    if (o < strip && y0 + o < height) {
      out[(long long)(y0 + o) * width] = acc[o];
    }
  }
}

// The unit eigenvector of the smallest eigenvalue of a symmetric 3x3
// (_smallest_eigvec_3x3_planes)
__device__ __forceinline__ void smallest_eigvec(float a00, float a11,
                                                float a22, float a01,
                                                float a02, float a12,
                                                float* n) {
  const float q = ((a00 + a11) + a22) * kThird;
  const float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
  const float p2 = ((b00 * b00 + b11 * b11) + b22 * b22) +
                   ((a01 * a01 + a02 * a02) + a12 * a12) * 2.0f;
  const float p = sqrtf(clamp_min_nan(p2 * kSixth, kTinyP2));
  const float inv_p = 1.0f / p;
  const float c00 = b00 * inv_p, c11 = b11 * inv_p, c22 = b22 * inv_p;
  const float c01 = a01 * inv_p, c02 = a02 * inv_p, c12 = a12 * inv_p;
  float half_det = ((c00 * (c11 * c22 - c12 * c12) -
                     c01 * (c01 * c22 - c12 * c02)) +
                    c02 * (c01 * c12 - c11 * c02)) *
                   0.5f;
  half_det = clamp_nan(half_det, -1.0f, 1.0f);
  const float phi = acosf(half_det) * kThird;
  const float lam = q + (p * 2.0f) * cosf(phi + kTwoThirdsPi);

  const float r0x = a00 - lam, r0y = a01, r0z = a02;
  const float r1x = a01, r1y = a11 - lam, r1z = a12;
  const float r2x = a02, r2y = a12, r2z = a22 - lam;
  const float cax = r0y * r1z - r0z * r1y, cay = r0z * r1x - r0x * r1z,
              caz = r0x * r1y - r0y * r1x;
  const float cbx = r0y * r2z - r0z * r2y, cby = r0z * r2x - r0x * r2z,
              cbz = r0x * r2y - r0y * r2x;
  const float ccx = r1y * r2z - r1z * r2y, ccy = r1z * r2x - r1x * r2z,
              ccz = r1x * r2y - r1y * r2x;
  const float na = (cax * cax + cay * cay) + caz * caz;
  const float nb = (cbx * cbx + cby * cby) + cbz * cbz;
  const float nc = (ccx * ccx + ccy * ccy) + ccz * ccz;

  const bool use_b = nb > na;
  float bx = use_b ? cbx : cax, by = use_b ? cby : cay,
        bz = use_b ? cbz : caz;
  const float nab = maximum_nan(na, nb);
  if (nc > nab) {
    bx = ccx;
    by = ccy;
    bz = ccz;
  }
  if (maximum_nan(nab, nc) <= kTinyP2) {  // isotropic: +z
    bx = 0.0f;
    by = 0.0f;
    bz = 1.0f;
  }
  const float inv_n =
      1.0f / sqrtf(clamp_min_nan((bx * bx + by * by) + bz * bz, kTinyP2));
  n[0] = bx * inv_n;
  n[1] = by * inv_n;
  n[2] = bz * inv_n;
}

// Centre i's term of the fallback direction at a point (p / w4 * vmask):
// its inverse-distance direction, or zeros where it is padded
__device__ __forceinline__ void fallback_term(const float* __restrict__ ctr,
                                              const unsigned char* __restrict__
                                                  cvalid,
                                              int i, float px, float py,
                                              float pz, float* t) {
  const float dx = __ldg(ctr + 3 * i) - px, dy = __ldg(ctr + 3 * i + 1) - py,
              dz = __ldg(ctr + 3 * i + 2) - pz;
  const float ci = __ldg(cvalid + i) ? 1.0f : 0.0f;
  const float d2 = clamp_min_nan((dx * dx + dy * dy) + dz * dz, kTiny);
  t[0] = ci * dx / d2;
  t[1] = ci * dy / d2;
  t[2] = ci * dz / d2;
}

// The fallback direction at a point: the centres' terms summed in the
// eager order
__device__ __forceinline__ void fallback(const float* __restrict__ ctr,
                                         const unsigned char* __restrict__
                                             cvalid,
                                         int c, float px, float py, float pz,
                                         float* n) {
  n[0] = 0.0f;
  n[1] = 0.0f;
  n[2] = 0.0f;
  for (int i = 0; i < c; ++i) {
    float t[3];
    fallback_term(ctr, cvalid, i, px, py, pz, t);
    n[0] = n[0] + t[0];
    n[1] = n[1] + t[1];
    n[2] = n[2] + t[2];
  }
}

// fallback() at the origin by a whole warp: lane i takes centre i (i + 32,
// ...), so that the divisions run side by side, and the sums take the
// lanes' terms in the centres' order. Lane 0 writes n.
__device__ __forceinline__ void fallback_at_origin_warp(
    const float* __restrict__ ctr, const unsigned char* __restrict__ cvalid,
    int c, int lane, float* n) {
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int i0 = 0; i0 < c; i0 += 32) {
    float t[3] = {0.0f, 0.0f, 0.0f};
    if (i0 + lane < c) {
      fallback_term(ctr, cvalid, i0 + lane, 0.0f, 0.0f, 0.0f, t);
    }
    const int lanes = min(32, c - i0);
    for (int j = 0; j < lanes; ++j) {
      sx = sx + __shfl_sync(0xffffffffu, t[0], j);
      sy = sy + __shfl_sync(0xffffffffu, t[1], j);
      sz = sz + __shfl_sync(0xffffffffu, t[2], j);
    }
  }
  if (lane == 0) {
    n[0] = sx;
    n[1] = sy;
    n[2] = sz;
  }
}

struct FinishArgs {
  const float* sums;  // (n, 10, height, width): the column sums
  const float4* p4;   // frame b at b * p4_stride floats
  const unsigned char* valid;  // frame b at b * valid_stride bytes
  const float* pdf;            // frame b at b * pdf_stride floats
  const float* centers;        // (n, c, 3)
  const unsigned char* centers_valid;  // (n, c)
  const void* n_side;  // (n,): float32, int32 or int64 (n_side_kind 0-2)
  float* out;          // (n, height, width, 3)
  int p4_stride, valid_stride, pdf_stride, n_side_kind, c, height, width,
      radius;
};

__device__ __forceinline__ float side_count(const FinishArgs& a, int b) {
  if (a.n_side_kind == 1) return (float)((const int*)a.n_side)[b];
  if (a.n_side_kind == 2) return (float)((const long long*)a.n_side)[b];
  return ((const float*)a.n_side)[b];
}

// NORMALS_FINISH. Shared memory: two level buffers [10][span], span = kSeg
// + 2 radius, each followed by kPad floats.
__global__ void __launch_bounds__(kSeg, 16)
    normals_finish_kernel(FinishArgs a) {
  extern __shared__ float smem[];
  const int span = kSeg + 2 * a.radius;
  const int size = 2 * a.radius + 1;
  float* lev = smem;  // P_k, then P_2k into nxt
  float* nxt = smem + kMoments * span + kPad;
  const int tx = threadIdx.x, y = blockIdx.y, b = blockIdx.z;
  const int x0 = blockIdx.x * kSeg, x = x0 + tx;
  const int width = a.width;
  const long long plane = (long long)a.height * width;
  const float* row = a.sums + (long long)b * kMoments * plane +
                     (long long)y * width;
  const float* ctr = a.centers + (long long)b * a.c * 3;
  const unsigned char* cvalid = a.centers_valid + (long long)b * a.c;
  // the fallback at the origin, where every invalid pixel's point lies
  // (+-0: c - (-0) differs from c - (+0) only in the sign of a zero, which
  // the sums, started at +0 and never -0, do not keep), by the first warp
  __shared__ float fb0[3];
  if (tx < 32) fallback_at_origin_warp(ctr, cvalid, a.c, tx, fb0);
  // the pixel's own inputs, loaded before the box sums' barriers
  const long long at = (long long)y * width + x;
  float4 raw = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  unsigned char vb = 0;
  float pdf = 0.0f;
  if (x < width) {
    raw = a.p4[(long long)b * (a.p4_stride / 4) + at];
    vb = a.valid[(long long)b * a.valid_stride + at];
    pdf = a.pdf[(long long)b * a.pdf_stride + at];
  }
  // the levels run over the flattened (moment, column) rows, so that the
  // threads share each level evenly; a row's last columns of a level read
  // past it (the next row, or kPad) and are never read
  for (int f = tx, m = 0, u = tx; f < kMoments * span; f += kSeg) {
    const int xx = x0 - a.radius + u;  // f = m * span + u; span >= kSeg
    lev[f] = xx >= 0 && xx < width ? row[m * plane + xx] : 0.0f;
    u += kSeg;
    if (u >= span) {
      u -= span;
      ++m;
    }
  }
  __syncthreads();
  // 2r+1 is odd: its first term is P_1 at offset 0
  float s[kMoments];
#pragma unroll
  for (int m = 0; m < kMoments; ++m) s[m] = lev[m * span + tx];
  int off = 1;
  for (int k = 1; 2 * k <= size;) {
    // P_2k into nxt, or P_4k = P_2k(u) + P_2k(u + 2k) in one pass where
    // P_2k is no term
    const int step = (size & (2 * k)) || 4 * k > size ? 2 : 4;
    if (step == 2) {
      for (int f = tx; f < kMoments * span; f += kSeg) {
        nxt[f] = lev[f] + lev[f + k];
      }
    } else {
      for (int f = tx; f < kMoments * span; f += kSeg) {
        nxt[f] = (lev[f] + lev[f + k]) + (lev[f + 2 * k] + lev[f + 3 * k]);
      }
    }
    __syncthreads();
    float* t = lev;
    lev = nxt;
    nxt = t;
    k *= step;
    if (size & k) {
#pragma unroll
      for (int m = 0; m < kMoments; ++m) {
        s[m] = s[m] + lev[m * span + tx + off];
      }
      off += k;
    }
  }
  if (x >= width) return;

  const float cnt = s[0];
  const Point q = make_point(raw, vb);
  float n[3];
  if (cnt < 3.0f) {
    // fewer than 3 points in the window: the fallback, which the eager
    // path takes here and nowhere else (so the eigenvector and the vote
    // are not needed)
    if (q.x == 0.0f && q.y == 0.0f && q.z == 0.0f) {
      n[0] = fb0[0];
      n[1] = fb0[1];
      n[2] = fb0[2];
    } else {
      fallback(ctr, cvalid, a.c, q.x, q.y, q.z, n);
    }
  } else {
    const float nn = clamp_min_nan(cnt, 1.0f);
    const float mx = s[1] / nn, my = s[2] / nn, mz = s[3] / nn;
    smallest_eigvec(s[4] / nn - mx * mx + kEps, s[5] / nn - my * my + kEps,
                    s[6] / nn - mz * mz + kEps, s[7] / nn - mx * my,
                    s[8] / nn - mx * mz, s[9] / nn - my * mz, n);
    // the vote: a real centre adds 1 / ndot; a padded one 0 / ndot, which
    // leaves the sum as it is (never -0) unless ndot is NaN
    float vote = 0.0f;
    for (int i = 0; i < a.c; ++i) {
      const float dx = __ldg(ctr + 3 * i) - q.x,
                  dy = __ldg(ctr + 3 * i + 1) - q.y,
                  dz = __ldg(ctr + 3 * i + 2) - q.z;
      float ndot = (n[0] * dx + n[1] * dy) + n[2] * dz;
      ndot = fabsf(ndot) < kTiny ? kTiny : ndot;
      if (__ldg(cvalid + i)) {
        vote = vote + 1.0f / ndot;
      } else if (isnan(ndot)) {
        vote = vote + 0.0f / ndot;
      }
    }
    if (vote < 0.0f) {
      n[0] = -n[0];
      n[1] = -n[1];
      n[2] = -n[2];
    }
  }
  const float kk = clamp_min_nan(side_count(a, b), 1.0f);
  const float pdf_root =
      kk > 1.0f ? powf(clamp_min_nan(pdf, 0.0f), (1.0f / kk) * 1.0f) : pdf;
  const float inv_len = 1.0f / clamp_min_nan(
      sqrtf((n[0] * n[0] + n[1] * n[1]) + n[2] * n[2]), kTiny);
  const float scale = pdf_root * inv_len * q.v;
  float* o = a.out + ((long long)b * plane + at) * 3;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float v = n[j] * scale;
    o[j] = isfinite(v) ? v : 0.0f;
  }
}

bool shape_ok(int n, int height, int width, int radius) {
  return n >= 1 && n <= 65535 && height >= 1 && height <= 65535 &&
         width >= 1 && radius >= 0;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

MR_EXPORT int mr_normals_cols(const float* point4, const unsigned char* valid,
                              float* sums, int p4_stride, int valid_stride,
                              int n, int height, int width, int radius,
                              void* stream) {
  if (!shape_ok(n, height, width, radius) || 2 * radius >= kSpan ||
      !aligned16(point4) || p4_stride % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int strip = kSpan - 2 * radius;
  const dim3 grid((width + kColW - 1) / kColW, (height + strip - 1) / strip,
                  n);
  auto kernel = radius == kRadius ? normals_cols_kernel<kRadius>
                                  : normals_cols_kernel<-1>;
  kernel<<<grid, dim3(kColW, kMoments), 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(point4), valid, sums, p4_stride,
      valid_stride, height, width, radius);
  return (int)cudaGetLastError();
}

MR_EXPORT int mr_normals_finish(const float* sums, const float* point4,
                                const unsigned char* valid, const float* pdf,
                                const float* centers,
                                const unsigned char* centers_valid,
                                const void* n_side, float* out, int p4_stride,
                                int valid_stride, int pdf_stride,
                                int n_side_kind, int n, int c, int height,
                                int width, int radius, void* stream) {
  if (!shape_ok(n, height, width, radius) || 2 * radius >= kSpan || c < 0 ||
      !aligned16(point4) || p4_stride % 4 != 0 || n_side_kind < 0 ||
      n_side_kind > 2) {
    return (int)cudaErrorInvalidValue;
  }
  FinishArgs a{sums,    reinterpret_cast<const float4*>(point4),
               valid,   pdf,
               centers, centers_valid,
               n_side,  out,
               p4_stride, valid_stride, pdf_stride, n_side_kind, c, height,
               width,   radius};
  const dim3 grid((width + kSeg - 1) / kSeg, height, n);
  const int smem =
      2 * (kMoments * (kSeg + 2 * radius) + kPad) * (int)sizeof(float);
  normals_finish_kernel<<<grid, kSeg, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
