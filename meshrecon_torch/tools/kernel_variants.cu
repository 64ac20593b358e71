// The designs K3b and R2 were chosen from, built apart from the kernel
// library by meshrecon_torch/tools/kernel_variants.py, which times them
// against the library's K3b (mr_warp_bicubic) and R2 (mr_roofline_fma) on
// the card. None of them runs on the port's path. Each computes its
// kernel's function with the same operations in the same order, so each
// must equal the library's kernel bit for bit.
//
// K3b (the Keys bicubic re-warp, csrc/warp.cu):
//   0 first:   the first design, one pixel a thread on a 1-D grid (a 64-bit
//              division a pixel), 16 clamped tap addresses;
//   1 float4:  K3's grid, 4 consecutive pixels a thread (one float4 of u,
//              of v and of the output), taps through __ldg with clamps;
//   2 window:  K3's grid, 4 pixels a thread 32 columns apart; a CTA
//              (128x8 pixels) reduces its tap origins' extent, stages the
//              clamped window in shared memory (up to 4,096 floats) and
//              reads its taps there, else from global memory;
//   3 window6: the window with the registers capped at 6 CTAs an SM, the
//              pixels' coordinates only kept across the barrier.
// R2 (the float32 FMA chain, csrc/roofline.cu):
//   0 first:   the first design, one chain a thread, 256-thread CTAs,
//              #pragma unroll 16 over a runtime count;
//   1 unroll:  the same grid, 128 FMAs between loop tests.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kCols = 32;
constexpr int kRows = 8;
constexpr int kWindow = 4096;  // floats of a CTA's staged window

__device__ __forceinline__ void cubic_weights(float t, float w[4]) {
  const float a = -0.75f;
  const float t2 = t * t;
  const float t3 = t2 * t;
  w[0] = a * ((t3 - 2.0f * t2) + t);
  w[1] = ((a + 2.0f) * t3 - (a + 3.0f) * t2) + 1.0f;
  w[2] = (-(a + 2.0f) * t3 + (2.0f * a + 3.0f) * t2) - a * t;
  w[3] = a * (t2 - t3);
}

__device__ __forceinline__ int origin(float x, int n) {
  return (int)fminf(fmaxf(floorf(x), -3.0f), (float)(n + 2));
}

// the 16 taps, each clamped, through __ldg (or plain loads: kLdg false)
template <bool kLdg>
__device__ __forceinline__ float sum_clamped(const float* __restrict__ src,
                                             float col, float row, int h,
                                             int w) {
  const float fc0 = floorf(col);
  const float fr0 = floorf(row);
  float wc[4], wr[4];
  cubic_weights(col - fc0, wc);
  cubic_weights(row - fr0, wr);
  const int c0 = origin(col, w);
  const int r0 = origin(row, h);
  int cj[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) cj[j] = min(max(c0 + j - 1, 0), w - 1);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* line = src + min(max(r0 + i - 1, 0), h - 1) * w;
    float row_acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      row_acc = row_acc + wc[j] * (kLdg ? __ldg(line + cj[j]) : line[cj[j]]);
    acc = acc + wr[i] * row_acc;
  }
  return acc;
}

// the 16 taps from a staged window whose (0, 0) is the image's
// (rmin - 1, cmin - 1), ws floats a row
__device__ __forceinline__ float sum_window(const float* win, int ws,
                                            int cmin, int rmin, float col,
                                            float row, int h, int w) {
  const float fc0 = floorf(col);
  const float fr0 = floorf(row);
  float wc[4], wr[4];
  cubic_weights(col - fc0, wc);
  cubic_weights(row - fr0, wr);
  const float* base = win + (origin(row, h) - rmin) * ws +
                      (origin(col, w) - cmin);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float row_acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) row_acc = row_acc + wc[j] * base[i * ws + j];
    acc = acc + wr[i] * row_acc;
  }
  return acc;
}

__global__ void __launch_bounds__(256)
k3b_first(const float* __restrict__ image, const float* __restrict__ u,
          const float* __restrict__ v, float* __restrict__ out,
          long long total, int height, int width) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= total) return;
  const long long plane = (long long)height * width;
  const long long img = idx / plane;
  const int pix = (int)(idx - img * plane);
  const int r = pix / width;
  const int c = pix - r * width;
  out[idx] = sum_clamped<false>(image + img * plane, (float)c + u[idx],
                                (float)r + v[idx], height, width);
}

__global__ void __launch_bounds__(kCols * kRows)
k3b_float4(const float* __restrict__ image, const float* __restrict__ u,
           const float* __restrict__ v, float* __restrict__ out, int height,
           int width) {
  const int c = (blockIdx.x * kCols + threadIdx.x) * 4;
  const int r = blockIdx.y * kRows + threadIdx.y;
  if (c >= width || r >= height) return;
  const long long plane = (long long)height * width;
  const float* src = image + blockIdx.z * plane;
  const long long at = blockIdx.z * plane + (long long)r * width + c;
  const float4 du = __ldg(reinterpret_cast<const float4*>(u + at));
  const float4 dv = __ldg(reinterpret_cast<const float4*>(v + at));
  const float fr = (float)r;
  float4 o;
  o.x = sum_clamped<true>(src, (float)c + du.x, fr + dv.x, height, width);
  o.y = sum_clamped<true>(src, (float)(c + 1) + du.y, fr + dv.y, height,
                          width);
  o.z = sum_clamped<true>(src, (float)(c + 2) + du.z, fr + dv.z, height,
                          width);
  o.w = sum_clamped<true>(src, (float)(c + 3) + du.w, fr + dv.w, height,
                          width);
  *reinterpret_cast<float4*>(out + at) = o;
}

// 4 pixels a thread, 32 columns apart: a 128x8 CTA
template <int kMinBlocks>
__global__ void __launch_bounds__(kCols * kRows, kMinBlocks)
k3b_window(const float* __restrict__ image, const float* __restrict__ u,
           const float* __restrict__ v, float* __restrict__ out, int height,
           int width) {
  constexpr int kPix = 4;
  __shared__ float win[kWindow];
  __shared__ int red[kRows][4];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int cbase = blockIdx.x * (kCols * kPix) + tx;
  const int r = blockIdx.y * kRows + ty;
  const long long plane = (long long)height * width;
  const float* src = image + blockIdx.z * plane;
  const long long at = blockIdx.z * plane + (long long)r * width;
  float col[kPix], row[kPix];
  int cmin = INT_MAX, cmax = INT_MIN, rmin = INT_MAX, rmax = INT_MIN;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int c = cbase + kCols * k;
    const bool ok = r < height && c < width;
    col[k] = (float)c + (ok ? __ldg(u + at + c) : 0.0f);
    row[k] = (float)r + (ok ? __ldg(v + at + c) : 0.0f);
    if (ok) {
      const int c0 = origin(col[k], width);
      const int r0 = origin(row[k], height);
      cmin = min(cmin, c0);
      cmax = max(cmax, c0);
      rmin = min(rmin, r0);
      rmax = max(rmax, r0);
    }
  }
  cmin = __reduce_min_sync(0xffffffffu, cmin);
  cmax = __reduce_max_sync(0xffffffffu, cmax);
  rmin = __reduce_min_sync(0xffffffffu, rmin);
  rmax = __reduce_max_sync(0xffffffffu, rmax);
  if (tx == 0) {
    red[ty][0] = cmin;
    red[ty][1] = cmax;
    red[ty][2] = rmin;
    red[ty][3] = rmax;
  }
  __syncthreads();
  const bool lane = tx < kRows;
  cmin = __reduce_min_sync(0xffffffffu, lane ? red[tx & 7][0] : INT_MAX);
  cmax = __reduce_max_sync(0xffffffffu, lane ? red[tx & 7][1] : INT_MIN);
  rmin = __reduce_min_sync(0xffffffffu, lane ? red[tx & 7][2] : INT_MAX);
  rmax = __reduce_max_sync(0xffffffffu, lane ? red[tx & 7][3] : INT_MIN);
  const int wc = cmax - cmin + 4;
  const int wr = rmax - rmin + 4;
  const bool staged = wc <= kWindow && wr <= kWindow && wc * wr <= kWindow;
  if (staged) {
    for (int rr = ty; rr < wr; rr += kRows) {
      const float* line =
          src + min(max(rmin - 1 + rr, 0), height - 1) * width;
      for (int cc = tx; cc < wc; cc += kCols)
        win[rr * wc + cc] = __ldg(line + min(max(cmin - 1 + cc, 0),
                                             width - 1));
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int c = cbase + kCols * k;
    if (r < height && c < width)
      out[at + c] = staged ? sum_window(win, wc, cmin, rmin, col[k], row[k],
                                        height, width)
                           : sum_clamped<true>(src, col[k], row[k], height,
                                               width);
  }
}

__global__ void __launch_bounds__(256)
r2_first(const float* __restrict__ x, float* __restrict__ o, int n,
         int inner) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const float xv = x[i];
  float acc = xv;
#pragma unroll 16
  for (int k = 0; k < inner; ++k) acc = __fmaf_rn(acc, xv, 1e-7f);
  o[i] = acc;
}

__global__ void __launch_bounds__(256)
r2_unroll(const float* __restrict__ x, float* __restrict__ o, int n,
          int inner) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const float xv = x[i];
  float acc = xv;
  int k = 0;
  for (; k + 128 <= inner; k += 128) {
#pragma unroll
    for (int s = 0; s < 128; ++s) acc = __fmaf_rn(acc, xv, 1e-7f);
  }
  for (; k < inner; ++k) acc = __fmaf_rn(acc, xv, 1e-7f);
  o[i] = acc;
}

}  // namespace

// K3b's variant `variant` (0-3, above) on (n, height, width) stacks
MR_EXPORT int mr_variant_k3b(int variant, const float* image, const float* u,
                             const float* v, float* out, int n, int height,
                             int width, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = (long long)n * height * width;
  if (total == 0) return 0;
  if (n > 65535 || (variant == 1 && width % 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(kCols, kRows);
  const int rows = (height + kRows - 1) / kRows;
  switch (variant) {
    case 0:
      k3b_first<<<mr_blocks(total, 256), 256, 0, s>>>(image, u, v, out,
                                                       total, height, width);
      break;
    case 1:
      k3b_float4<<<dim3((width / 4 + kCols - 1) / kCols, rows, n), block, 0,
                   s>>>(image, u, v, out, height, width);
      break;
    case 2:
      k3b_window<1><<<dim3((width + 127) / 128, rows, n), block, 0, s>>>(
          image, u, v, out, height, width);
      break;
    case 3:
      k3b_window<6><<<dim3((width + 127) / 128, rows, n), block, 0, s>>>(
          image, u, v, out, height, width);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// R2's variant `variant` (0-1, above) on n floats
MR_EXPORT int mr_variant_r2(int variant, const float* x, float* o, int n,
                            int inner, void* stream) {
  if (n <= 0) return n < 0 ? (int)cudaErrorInvalidValue : 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0:
      r2_first<<<mr_blocks(n, 256), 256, 0, s>>>(x, o, n, inner);
      break;
    case 1:
      r2_unroll<<<mr_blocks(n, 256), 256, 0, s>>>(x, o, n, inner);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
