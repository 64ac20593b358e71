// The designs K3b, R2, SETUP and BIN were chosen from, built apart from the
// kernel library by meshrecon_torch/tools/kernel_variants.py, which times
// them against the library's kernels (mr_warp_bicubic, mr_roofline_fma,
// mr_raster_setup, mr_raster_bin) on the card. None of them runs on the
// port's path. Each computes its kernel's function with the same
// operations in the same order, so each must equal the library's kernel
// bit for bit (BIN: the same counts and list prefixes).
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
// SETUP and BIN (csrc/raster_setup.cu, included here): the kept kernels'
// templates at other launch parameters, and SETUP's first design, below,
//   SETUP 0-5: 0 a thread a record (slot 1 in warps 0-3, slot 2 in 4-7 of
//              a 128-triangle CTA, at least 5 CTAs an SM); a thread a
//              triangle at least 4, 6 or 10 CTAs an SM; CTAs of 64
//              triangles, 16 or 20 an SM (the kept: a thread a triangle,
//              128 a CTA, 8 an SM);
//   BIN 0-5:   blocks of 8 x 4 tiles in clusters of 4 and of 8 CTAs;
//              8 x 2 in clusters of 4 and of 8; 8 x 1 in clusters of 8; 16
//              warps a CTA, 8 x 4 tiles in clusters of 8 (the kept: 8
//              warps, 4 CTAs an SM; 8 x 4 tiles in clusters of 4 at 1,024
//              groups or fewer, else 8 x 2 in clusters of 8).
#include <climits>

#include "common.cuh"
#include "raster_setup.cu"

namespace {

// a record with v0 in clip space
__device__ __forceinline__ void make_record(const Vtx& v0, const Vtx& v1,
                                            const Vtx& v2, bool valid,
                                            float* f) {
  float x0, y0, z0;
  project(v0, &x0, &y0, &z0);
  make_record(x0, y0, z0, v1, v2, valid, f);
}

// SETUP's first design here: a thread a record. Slot 1 of triangle t is
// record 2t, slot 2 record 2t+1; warps 0-3 build slot 1 of the CTA's 128
// triangles, warps 4-7 slot 2 (for a
// triangle that does not straddle the near plane an invalid record, whose
// fields are still computed). The camera and the CTA's triangles are read
// once into shared memory; the records go to shared memory and leave as
// float4 rows of the (16, n_rec) planes; the chunk boxes reduce with
// shuffles, a slot at a time, and the two slots' shares there.
template <int kMinBlocks, int kTris = kSetupTris>
__global__ void __launch_bounds__(2 * kTris, kMinBlocks)
record_setup_kernel(const float* __restrict__ cameras,
                    const float* __restrict__ soup,
                    const unsigned char* __restrict__ soup_valid,
                    float* __restrict__ packed, float* __restrict__ cbox,
                    int n_tri, int n_rec, int chunk) {
  constexpr int kThreads = 2 * kTris;  // a thread a record
  __shared__ float cam_m[16];
  __shared__ float tri[kTris * 9];
  __shared__ __align__(16) float rec[kFields][kThreads];
  __shared__ float part[2][4][kTris / 4];  // a slot's chunk-box shares
  const int cam = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * kTris;
  const int n_here = (int)max(0LL, min((long long)kTris, n_tri - t0));
  if (threadIdx.x < 16) cam_m[threadIdx.x] = cameras[cam * 16 + threadIdx.x];
  for (int i = threadIdx.x; i < n_here * 9; i += kThreads) {
    tri[i] = soup[t0 * 9 + i];
  }
  __syncthreads();
  const int slot = threadIdx.x / kTris;  // the same across a warp
  const int tl = threadIdx.x - slot * kTris;
  float f[kFields];
  if (tl < n_here) {
    const float* p = tri + tl * 9;
    Vtx P[3];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const float p0 = p[3 * v], p1 = p[3 * v + 1], p2 = p[3 * v + 2];
      P[v] = Vtx{clip_comp(cam_m, p0, p1, p2),
                 clip_comp(cam_m + 4, p0, p1, p2),
                 clip_comp(cam_m + 8, p0, p1, p2),
                 clip_comp(cam_m + 12, p0, p1, p2)};
    }
    const bool in0 = P[0].w >= kWEps, in1 = P[1].w >= kWEps,
               in2 = P[2].w >= kWEps;
    const int n_in = (int)in0 + (int)in1 + (int)in2;
    // canonical rotation: n_in == 1 puts the inside vertex first; n_in ==
    // 2 puts the outside vertex last
    const int first_in = in0 ? 0 : (in1 ? 1 : 2);
    const int first_out = !in0 ? 0 : (!in1 ? 1 : 2);
    const int k =
        n_in == 1 ? first_in : (n_in == 2 ? (first_out + 1) % 3 : 0);
    const Vtx A = pick3(k, P[0], P[1], P[2]);
    const Vtx B = pick3((k + 1) % 3, P[0], P[1], P[2]);
    const Vtx C = pick3((k + 2) % 3, P[0], P[1], P[2]);
    const bool one = n_in == 1, two = n_in == 2;
    const bool sv = soup_valid[t0 + tl] != 0;
    // slot 1: case1 (A, iAB, iAC); case2 (A, B, iBC); else the original;
    // slot 2: only case2 (A, iBC, iAC). One record a thread, so one copy
    // of its code.
    Vtx V1 = B, V2 = C;
    bool valid = n_in >= 1 && sv;
    if (slot == 1) {
      V1 = isect(B, C);
      V2 = isect(A, C);
      valid = two && sv;
    } else if (one) {
      V1 = isect(A, B);
      V2 = isect(A, C);
    } else if (two) {
      V2 = isect(B, C);
    }
    make_record(A, V1, V2, valid, f);
  } else {
    padding_record(f);
  }
  const int r = 2 * tl + slot;
#pragma unroll
  for (int i = 0; i < kFields; ++i) rec[i][r] = f[i];
  // each slot's share of the chunk boxes: its chunk / 2 triangles are as
  // many neighbouring lanes (chunk / 2 divides 32)
  const int half = chunk / 2;
  const float4 b = warp_union(make_float4(f[12], f[13], f[14], f[15]),
                              half / 2);
  if (tl % half == 0) {
    part[slot][0][tl / half] = b.x;
    part[slot][1][tl / half] = b.y;
    part[slot][2][tl / half] = b.z;
    part[slot][3][tl / half] = b.w;
  }
  __syncthreads();
  // the CTA's records [r0, r0 + nr) of each field, as float4 (nr and r0
  // are multiples of 8: n_rec is a multiple of chunk)
  const long long r0 = (long long)blockIdx.x * kThreads;
  const int nr = (int)min((long long)kThreads, n_rec - r0);
  constexpr int kRowVecs = kThreads / 4;
  constexpr int kRowsAtOnce = kThreads / kRowVecs;
  float* out = packed + (long long)cam * kFields * n_rec + r0;
  const int c = threadIdx.x % kRowVecs;
  if (4 * c < nr) {
#pragma unroll
    for (int i = threadIdx.x / kRowVecs; i < kFields; i += kRowsAtOnce) {
      reinterpret_cast<float4*>(out + (long long)i * n_rec)[c] =
          reinterpret_cast<const float4*>(rec[i])[c];
    }
  }
  // chunk boxes: a thread a (component, chunk), the two slots' shares
  const int nc = nr / chunk, nch = n_rec / chunk;
  for (int e = threadIdx.x; e < 4 * nc; e += kThreads) {
    const int comp = e / nc, ch = e - comp * nc;
    const float v0 = part[0][comp][ch], v1 = part[1][comp][ch];
    cbox[((long long)cam * 4 + comp) * nch + r0 / chunk + ch] =
        comp % 2 == 0 ? fminf(v0, v1) : fmaxf(v0, v1);
  }
}


template <int kMinBlocks, int kTris = kSetupTris>
int launch_record_setup(const float* cameras, const float* soup,
                 const unsigned char* soup_valid, float* packed, float* cbox,
                 int n_cams, int n_tri, int n_rec, int chunk, void* stream) {
  if ((chunk != 8 && chunk != 16 && chunk != 32 && chunk != 64) ||
      n_rec % chunk != 0 || (long long)n_rec < 2LL * n_tri || n_tri < 0 ||
      n_cams < 0 || n_cams > 65535 ||
      reinterpret_cast<uintptr_t>(packed) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_cams == 0 || n_rec == 0) return 0;
  dim3 grid(mr_blocks(n_rec, 2 * kTris), n_cams);
  record_setup_kernel<kMinBlocks, kTris>
      <<<grid, 2 * kTris, 0, (cudaStream_t)stream>>>(
          cameras, soup, soup_valid, packed, cbox, n_tri, n_rec, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

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

// SETUP's variant `variant` (0-5, above), mr_raster_setup's arguments
MR_EXPORT int mr_variant_setup(int variant, const float* cameras,
                               const float* soup,
                               const unsigned char* soup_valid, float* packed,
                               float* cbox, int n_cams, int n_tri, int n_rec,
                               int chunk, void* stream) {
#define MR_SETUP_ARGS \
  cameras, soup, soup_valid, packed, cbox, n_cams, n_tri, n_rec, chunk, stream
  switch (variant) {
    case 0:
      return launch_record_setup<5>(MR_SETUP_ARGS);
    case 1:
      return launch_setup<4>(MR_SETUP_ARGS);
    case 2:
      return launch_setup<6>(MR_SETUP_ARGS);
    case 3:
      return launch_setup<10>(MR_SETUP_ARGS);
    case 4:
      return launch_setup<16, 64>(MR_SETUP_ARGS);
    case 5:
      return launch_setup<20, 64>(MR_SETUP_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MR_SETUP_ARGS
}

// BIN's variant `variant` (0-5, above), mr_raster_bin's arguments
MR_EXPORT int mr_variant_bin(int variant, const float* cbox, const float* tx0,
                             const float* tx1, const float* ty0,
                             const float* ty1, int* lists, int* counts,
                             int n_cams, int nch, int supers, int ntx,
                             int nty, void* stream) {
#define MR_BIN_ARGS                                                         \
  cbox, tx0, tx1, ty0, ty1, lists, counts, n_cams, nch, supers, ntx, nty
  switch (variant) {
    case 0:
      return launch_bin<8, 4, 4>(MR_BIN_ARGS, 4, stream);
    case 1:
      return launch_bin<8, 4, 4>(MR_BIN_ARGS, 8, stream);
    case 2:
      return launch_bin<8, 4, 2>(MR_BIN_ARGS, 4, stream);
    case 3:
      return launch_bin<8, 4, 2>(MR_BIN_ARGS, 8, stream);
    case 4:
      return launch_bin<8, 4, 1>(MR_BIN_ARGS, 8, stream);
    case 5:
      return launch_bin<16, 2, 4>(MR_BIN_ARGS, 8, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// BIN's variant `variant` (0: blocks of 8 x 4 tiles, 1: of 8 x 2, in
// clusters of 8) with per-CTA stamps (kStamps unsigned 64-bit values a CTA
// of the grid, csrc/raster_setup.cu): the global timer (ns) at its start
// and end; the SM's cycles building the coarse level; blocks taken; cycles
// staging; cycles in all; survivors; (tile, run) pairs walked; SM; cycles
// finding the survivors, walking, taking blocks
MR_EXPORT int mr_variant_bin_timed(int variant, const float* cbox,
                                   const float* tx0, const float* tx1,
                                   const float* ty0, const float* ty1,
                                   int* lists, int* counts, int n_cams,
                                   int nch, int supers, int ntx, int nty,
                                   unsigned long long* stamps, void* stream) {
  switch (variant) {
    case 0:
      return launch_bin<8, 4, 4, true>(MR_BIN_ARGS, 8, stream, stamps);
    case 1:
      return launch_bin<kBinWarps, kBinMinBlocks, kBinTyLarge, true>(
          MR_BIN_ARGS, kBinCluster, stream, stamps);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
#undef MR_BIN_ARGS
