// K2, K3, K3b and K3c: per-pixel gathers, one thread per output pixel.
//
// K2 replaces meshrecon/flow/tile_warp.py::_warp_tile_kernel2 (launched by
// tile_warp_sample2 / tile_warp_sample2_batched for projective texturing):
// two same-shape stacks sampled at one coordinate field, source A (the
// dilated shadow depth) nearest with floor(x + 0.5) and a border clamp,
// source B (the side frame) bilinear with a border clamp. Its bilinear
// mode (the TPU kernel's nearest_a=False, --shadow-sample bilinear)
// samples A bilinearly too, on B's taps and fractions.
//
// K3 replaces meshrecon/flow/tile_warp.py::_warp_tile_kernel with taps=2
// (tile_warp_flow_batched, the flow solver's warps): one stack resampled
// bilinearly at (col + u, row + v).
//
// K3b replaces the same _warp_tile_kernel with taps=4
// (tile_warp_flow_batched(..., taps=4) from meshrecon/pipeline/fused.py:241,
// the variance re-warp of --variance-mode rewarp and -f): one stack
// resampled at (col + u, row + v) by the Keys bicubic kernel (a = -0.75,
// OpenCV's CV_INTER_CUBIC) over 4x4 taps, each tap index clamped to the
// border. It repeats meshrecon_torch.flow.remap.bicubic_sample operation
// for operation: the weights are the twin's polynomials in the fraction t
// (not the TPU kernel's |t|-piecewise form), the 16 taps are summed over
// the columns j inside the rows i. There is no residual budget, so unlike
// the TPU kernel (r_row=6, r_col=8) nothing is clamped at motion edges.
//
// K3c replaces the same _warp_tile_kernel called with a valid mask
// (tile_warp_sample_batched(..., valid=) from the plane sweep,
// meshrecon/depth/plane_sweep.py:174): one stack resampled bilinearly at
// absolute coordinates (scol, srow), defined only where valid is true and
// written as exactly 0.0 elsewhere. The sweep weights every invalid sample
// by zero, and invalid pixels (behind the side camera, off its frame) hold
// arbitrary coordinates, so the kernel skips their taps altogether.
//
// Bands (sharding/tiles.py: image rows split over a tile group). K2 writes
// an output plane apart from its source plane: the coordinate fields and
// the outputs are (n, rows, width), rows of a band whose coordinates are
// absolute, and the sources are (n, height, width). K3 and K3b take the
// band's place in the image: u, v and out hold rows [row0, row0 + rows) of
// an image of `height` rows, and the source holds rows [src_row0, src_row0
// + src_rows) of it, which must hold every tap. A pixel's sample row is its
// global row plus v, rounded as in the whole image (a local row would round
// r + v otherwise), and the border clamps act at the image's edges. The
// whole frame is rows = src_rows = height, row0 = src_row0 = 0.
//
// What bounds them here: K2, K3 and K3c device-memory bandwidth. K2 reads
// 4 floats per pixel of coordinates and sources' taps and writes 2; K3
// reads 3 and writes 1; K3c reads 2 floats and a byte, plus the taps where
// valid, and writes 1. The taps of neighbouring threads share cache lines,
// so the gathers mostly hit L1/L2. K3b reads 3 floats and writes 1 too,
// but on the card its bytes do not bound it: 16 tap loads and ~80 float
// operations a pixel, with their addressing, keep it near half its bytes
// bound (PERF.md §6, "PR 10"), and a warp's tap loads wait on L1. Its
// first design (a 1-D grid, a 64-bit division a pixel, 16 clamped
// addresses) was slower, and so was every variant that staged a CTA's
// window of taps in shared memory (meshrecon_torch/tools/kernel_variants).
//
// Design: the TPU kernels exist because TPU gathers are slow; they fit a
// per-tile integer base offset and enumerate bounded residual taps, and
// clamp residuals beyond their budget. Hopper gathers are cheap, so these
// are the plain gathers of the XLA twins (fragment.bilinear_sample,
// fragment.nearest_sample, remap.bilinear_warp) with no residual budget
// and no tile fit; consecutive threads take consecutive pixels of a row,
// so coordinate loads and output stores coalesce. K3, the flow solver's
// warp, runs on a 3-D grid (columns on x, rows on y, images on z), so no
// thread divides to find its pixel; where the width is a multiple of 4 (the
// pyramid's 640 and 320) each thread takes 4 pixels of a row with one float4
// load of u and of v and one float4 store, and it reads the image taps
// through the read-only cache (__ldg). K3b runs on the same grid, two
// pixels a thread 32 columns apart (coalesced scalar loads and stores, any
// width); a warp whose pixels' 4x4 windows all lie inside the image reads
// its taps from one corner pointer with no clamp, any other warp clamps
// each tap, and both sum the same taps in the same order.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kBilinearA>
__global__ void __launch_bounds__(kThreads)
sample_shadow_frame_kernel(const float* __restrict__ shadow,
                           const float* __restrict__ frame,
                           const float* __restrict__ scol,
                           const float* __restrict__ srow,
                           float* __restrict__ out_shadow,
                           float* __restrict__ out_frame, long long total,
                           int height, int width, int rows) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long plane = (long long)height * width;
  const long long img = idx / ((long long)rows * width);
  const float col = scol[idx];
  const float row = srow[idx];
  const float* a = shadow + img * plane;
  const float* b = frame + img * plane;
  const MrTaps t = mr_bilinear_taps(col, row, height, width);
  if (kBilinearA) {
    out_shadow[idx] = mr_bilinear_apply(a, t, width);
  } else {
    // nearest, rounding half up; the float clamp equals clamping the
    // saturated integer, and maps NaN to 0
    const float cn =
        fminf(fmaxf(floorf(col + 0.5f), 0.0f), (float)(width - 1));
    const float rn =
        fminf(fmaxf(floorf(row + 0.5f), 0.0f), (float)(height - 1));
    out_shadow[idx] = a[(int)rn * width + (int)cn];
  }
  out_frame[idx] = mr_bilinear_apply(b, t, width);
}

// K3's CTA: a warp across a row, kK3Rows rows; images on gridDim.z
constexpr int kK3Cols = 32;
constexpr int kK3Rows = 8;

// mr_bilinear with the taps read through the read-only cache; h is the
// image's rows and img points at its row src_row0 (where the source starts)
__device__ __forceinline__ float bilinear_ldg(const float* __restrict__ img,
                                              float col, float row, int h,
                                              int w, int src_row0) {
  const MrTaps t = mr_bilinear_taps(col, row, h, w);
  const int r0 = t.r0 - src_row0, r1 = t.r1 - src_row0;
  return mr_bilinear_mix(__ldg(img + r0 * w + t.c0),
                         __ldg(img + r0 * w + t.c1),
                         __ldg(img + r1 * w + t.c0),
                         __ldg(img + r1 * w + t.c1), t.fr, t.fc);
}

// Where a K3 / K3b launch's rows lie in the image (see the note on bands).
struct Band {
  int rows, row0, height, src_row0, src_rows;
};

// kPix consecutive pixels of a row a thread: 4 (float4 loads of u and v, one
// float4 store; the row's width a multiple of 4) or 1
template <int kPix>
__global__ void __launch_bounds__(kK3Cols * kK3Rows)
warp_bilinear_kernel(const float* __restrict__ image,
                     const float* __restrict__ u, const float* __restrict__ v,
                     float* __restrict__ out, Band band, int width) {
  const int c = (blockIdx.x * kK3Cols + threadIdx.x) * kPix;
  const int r = blockIdx.y * kK3Rows + threadIdx.y;
  if (c >= width || r >= band.rows) return;
  const int h = band.height, s0 = band.src_row0;
  const float* src = image + blockIdx.z * ((long long)band.src_rows * width);
  const long long at =
      blockIdx.z * ((long long)band.rows * width) + (long long)r * width + c;
  const float fr = (float)(r + band.row0);
  if (kPix == 4) {
    const float4 du = __ldg(reinterpret_cast<const float4*>(u + at));
    const float4 dv = __ldg(reinterpret_cast<const float4*>(v + at));
    float4 o;
    o.x = bilinear_ldg(src, (float)c + du.x, fr + dv.x, h, width, s0);
    o.y = bilinear_ldg(src, (float)(c + 1) + du.y, fr + dv.y, h, width, s0);
    o.z = bilinear_ldg(src, (float)(c + 2) + du.z, fr + dv.z, h, width, s0);
    o.w = bilinear_ldg(src, (float)(c + 3) + du.w, fr + dv.w, h, width, s0);
    *reinterpret_cast<float4*>(out + at) = o;
  } else {
    out[at] = bilinear_ldg(src, (float)c + __ldg(u + at), fr + __ldg(v + at),
                           h, width, s0);
  }
}

// remap._cubic_weights: the polynomials in t of the XLA twin, a = -0.75
__device__ __forceinline__ void cubic_weights(float t, float w[4]) {
  const float a = -0.75f;
  const float t2 = t * t;
  const float t3 = t2 * t;
  w[0] = a * ((t3 - 2.0f * t2) + t);
  w[1] = ((a + 2.0f) * t3 - (a + 3.0f) * t2) + 1.0f;
  w[2] = (-(a + 2.0f) * t3 + (2.0f * a + 3.0f) * t2) - a * t;
  w[3] = a * (t2 - t3);
}

// K3b's CTA: K3's (a warp across a row, kK3Rows rows, images on gridDim.z)
// with kK3bPix pixels a thread, kK3Cols columns apart, so that each tap
// load of a warp reads 32 neighbouring columns (a float4 a thread would
// spread it over 128). The minimum of CTAs an SM caps the registers so that
// more warps hide the tap loads' latency: of 1, 2, 4 and 8 pixels a thread
// and 4 to 8 CTAs an SM, timed on the card, 2 and 6 were the fastest.
constexpr int kK3bPix = 2;
constexpr int kK3bMinBlocks = 6;

// the tap origin's float clamp before the conversion: it keeps far-off (or
// NaN) coordinates in int range; every tap they reach is a border tap
// either way, as the twin's integer clamp gives
__device__ __forceinline__ int cubic_origin(float x, int n) {
  return (int)fminf(fmaxf(floorf(x), -3.0f), (float)(n + 2));
}

// The twin's sum over the 16 taps, the columns j inside the rows i, each
// tap at row r0-1+i and column c0-1+j: clamped to the image, or read from
// one pointer at the window's corner with no clamp (the caller knows the
// window lies inside). Both read the same taps in the same order. h is the
// image's rows; src points at its row src_row0.
template <bool kClamped>
__device__ __forceinline__ float bicubic_sum(const float* __restrict__ src,
                                             float col, float row, int h,
                                             int w, int src_row0) {
  const float fc0 = floorf(col);
  const float fr0 = floorf(row);
  float wc[4], wr[4];
  cubic_weights(col - fc0, wc);
  cubic_weights(row - fr0, wr);
  const int c0 = cubic_origin(col, w);
  const int r0 = cubic_origin(row, h);
  const float* corner =
      src + (r0 - 1 - src_row0) * w + (c0 - 1);  // unclamped only
  int cj[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) cj[j] = min(max(c0 + j - 1, 0), w - 1);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* line =
        kClamped ? src + (min(max(r0 + i - 1, 0), h - 1) - src_row0) * w
                 : corner + i * w;
    float row_acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      row_acc = row_acc + wc[j] * __ldg(line + (kClamped ? cj[j] : j));
    acc = acc + wr[i] * row_acc;
  }
  return acc;
}

// A warp whose every pixel's window lies inside the image reads its taps
// with no clamp (a row pointer and the column offsets 0-3); any other warp
// clamps each tap. The choice is warp-uniform, so the warp's pixels share
// one path. kCount (mr_warp_bicubic_paths only): count the warps of valid
// rows on the unclamped path.
template <bool kCount>
__global__ void __launch_bounds__(kK3Cols * kK3Rows, kK3bMinBlocks)
warp_bicubic_kernel(const float* __restrict__ image,
                    const float* __restrict__ u, const float* __restrict__ v,
                    float* __restrict__ out, Band band, int width,
                    int* __restrict__ unclamped) {
  const int c_first = blockIdx.x * (kK3Cols * kK3bPix) + threadIdx.x;
  const int r_want = blockIdx.y * kK3Rows + threadIdx.y;
  // a thread past the edge samples the last row or column and stores
  // nothing: every lane takes part in the warp's vote
  const int r = min(r_want, band.rows - 1);
  const int height = band.height, s0 = band.src_row0;
  const float* src = image + blockIdx.z * ((long long)band.src_rows * width);
  const long long at =
      blockIdx.z * ((long long)band.rows * width) + (long long)r * width;
  const float fr = (float)(r + band.row0);
  float col[kK3bPix], row[kK3bPix];
  bool inside = true;
#pragma unroll
  for (int k = 0; k < kK3bPix; ++k) {
    const int c = min(c_first + kK3Cols * k, width - 1);
    col[k] = (float)c + __ldg(u + at + c);
    row[k] = fr + __ldg(v + at + c);
    const int c0 = cubic_origin(col[k], width);
    const int r0 = cubic_origin(row[k], height);
    inside = inside && c0 >= 1 && c0 <= width - 3 && r0 >= 1 &&
             r0 <= height - 3;
  }
  float o[kK3bPix];
  if (__all_sync(0xffffffffu, inside)) {
    if (kCount && threadIdx.x == 0 && r_want < height) atomicAdd(unclamped, 1);
#pragma unroll
    for (int k = 0; k < kK3bPix; ++k)
      o[k] = bicubic_sum<false>(src, col[k], row[k], height, width, s0);
  } else {
#pragma unroll
    for (int k = 0; k < kK3bPix; ++k)
      o[k] = bicubic_sum<true>(src, col[k], row[k], height, width, s0);
  }
  if (r_want >= band.rows) return;
#pragma unroll
  for (int k = 0; k < kK3bPix; ++k)
    if (c_first + kK3Cols * k < width) out[at + c_first + kK3Cols * k] = o[k];
}

// A band that fits the image and a grid that fits the card.
bool band_ok(const Band& b, int n, int width) {
  return n >= 0 && width >= 0 && b.rows >= 0 && b.row0 >= 0 &&
         b.src_row0 >= 0 && b.src_rows >= 0 &&
         (long long)b.row0 + b.rows <= b.height &&
         (long long)b.src_row0 + b.src_rows <= b.height &&
         b.rows <= 65535LL * kK3Rows &&
         (long long)b.height * width <= INT_MAX;
}

template <bool kCount>
int launch_bicubic(const float* image, const float* u, const float* v,
                   float* out, int* unclamped, int n, const Band& band,
                   int width, void* stream) {
  if (!band_ok(band, n, width)) return (int)cudaErrorInvalidValue;
  if ((long long)n * band.rows * width == 0) return 0;
  const long long plane = (long long)band.rows * width;
  const long long src_plane = (long long)band.src_rows * width;
  const dim3 block(kK3Cols, kK3Rows);
  cudaStream_t s = (cudaStream_t)stream;
  for (int z0 = 0; z0 < n; z0 += 65535) {  // gridDim.z <= 65535
    const dim3 grid((width + kK3Cols * kK3bPix - 1) / (kK3Cols * kK3bPix),
                    (band.rows + kK3Rows - 1) / kK3Rows,
                    n - z0 < 65535 ? n - z0 : 65535);
    const long long off = z0 * plane;
    warp_bicubic_kernel<kCount><<<grid, block, 0, s>>>(
        image + z0 * src_plane, u + off, v + off, out + off, band, width,
        unclamped);
  }
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads)
sample_bilinear_masked_kernel(const float* __restrict__ image,
                              const float* __restrict__ scol,
                              const float* __restrict__ srow,
                              const unsigned char* __restrict__ valid,
                              float* __restrict__ out, long long total,
                              int height, int width) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  if (!valid[idx]) {
    out[idx] = 0.0f;
    return;
  }
  const long long plane = (long long)height * width;
  const long long img = idx / plane;
  out[idx] = mr_bilinear(image + img * plane, scol[idx], srow[idx], height,
                         width);
}

}  // namespace

// shadow, frame: (n, height, width); scol, srow, out_shadow, out_frame:
// (n, rows, width), coordinates in the sources' pixels; bilinear_a != 0
// samples the shadow bilinearly, else nearest
MR_EXPORT int mr_sample_shadow_frame(const float* shadow, const float* frame,
                                     const float* scol, const float* srow,
                                     float* out_shadow, float* out_frame,
                                     int bilinear_a, int n, int height,
                                     int width, int rows, void* stream) {
  if (n < 0 || height < 0 || width < 0 || rows < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total = (long long)n * rows * width;
  if (total == 0) return 0;
  const int blocks = mr_blocks(total, kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (bilinear_a) {
    sample_shadow_frame_kernel<true><<<blocks, kThreads, 0, s>>>(
        shadow, frame, scol, srow, out_shadow, out_frame, total, height,
        width, rows);
  } else {
    sample_shadow_frame_kernel<false><<<blocks, kThreads, 0, s>>>(
        shadow, frame, scol, srow, out_shadow, out_frame, total, height,
        width, rows);
  }
  return (int)cudaGetLastError();
}

// u, v, out: (n, rows, width), rows [row0, row0 + rows) of an image of
// `height` rows; image: (n, src_rows, width), its rows [src_row0, src_row0
// + src_rows), holding every tap. Four pixels a thread when the width is a
// multiple of 4 and u, v, out are 16-byte aligned, else one.
MR_EXPORT int mr_warp_bilinear(const float* image, const float* u,
                               const float* v, float* out, int n, int rows,
                               int width, int row0, int height, int src_row0,
                               int src_rows, void* stream) {
  const Band band{rows, row0, height, src_row0, src_rows};
  if (!band_ok(band, n, width)) return (int)cudaErrorInvalidValue;
  if ((long long)n * rows * width == 0) return 0;
  const bool vec = width % 4 == 0 &&
                   (((uintptr_t)u | (uintptr_t)v | (uintptr_t)out) & 15) == 0;
  const int per = vec ? 4 : 1;
  const long long plane = (long long)rows * width;
  const long long src_plane = (long long)src_rows * width;
  const dim3 block(kK3Cols, kK3Rows);
  cudaStream_t s = (cudaStream_t)stream;
  for (int z0 = 0; z0 < n; z0 += 65535) {  // gridDim.z <= 65535
    const dim3 grid((width / per + kK3Cols - 1) / kK3Cols,
                    (rows + kK3Rows - 1) / kK3Rows,
                    n - z0 < 65535 ? n - z0 : 65535);
    const long long off = z0 * plane;
    const float* img = image + z0 * src_plane;
    if (vec) {
      warp_bilinear_kernel<4><<<grid, block, 0, s>>>(
          img, u + off, v + off, out + off, band, width);
    } else {
      warp_bilinear_kernel<1><<<grid, block, 0, s>>>(
          img, u + off, v + off, out + off, band, width);
    }
  }
  return (int)cudaGetLastError();
}

// the arguments of mr_warp_bilinear
MR_EXPORT int mr_warp_bicubic(const float* image, const float* u,
                              const float* v, float* out, int n, int rows,
                              int width, int row0, int height, int src_row0,
                              int src_rows, void* stream) {
  return launch_bicubic<false>(image, u, v, out, nullptr, n,
                               Band{rows, row0, height, src_row0, src_rows},
                               width, stream);
}

// mr_warp_bicubic of the whole frame that also adds to unclamped[0] (a
// device int) the warps of valid rows whose taps it read unclamped: the
// path split, for the checks
MR_EXPORT int mr_warp_bicubic_paths(const float* image, const float* u,
                                    const float* v, float* out,
                                    int* unclamped, int n, int height,
                                    int width, void* stream) {
  return launch_bicubic<true>(image, u, v, out, unclamped, n,
                              Band{height, 0, height, 0, height}, width,
                              stream);
}

// K3b's geometry: out = {threads across a row, rows a CTA, pixels a thread
// (kK3Cols columns apart)}
MR_EXPORT int mr_warp_bicubic_shape(int* out) {
  out[0] = kK3Cols;
  out[1] = kK3Rows;
  out[2] = kK3bPix;
  return 0;
}

// image, scol, srow, out: (n, height, width) float; valid: the same shape,
// one byte per pixel (torch.bool)
MR_EXPORT int mr_sample_bilinear_masked(const float* image, const float* scol,
                                        const float* srow,
                                        const unsigned char* valid, float* out,
                                        int n, int height, int width,
                                        void* stream) {
  const long long total = (long long)n * height * width;
  if (total == 0) return 0;
  sample_bilinear_masked_kernel<<<mr_blocks(total, kThreads), kThreads, 0,
                                  (cudaStream_t)stream>>>(
      image, scol, srow, valid, out, total, height, width);
  return (int)cudaGetLastError();
}
