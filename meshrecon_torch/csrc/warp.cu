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
// the columns j inside the rows i. Each thread computes its 4 + 4 weights
// once and gathers its 16 taps; there is no residual budget, so unlike the
// TPU kernel (r_row=6, r_col=8) nothing is clamped at motion edges.
//
// K3c replaces the same _warp_tile_kernel called with a valid mask
// (tile_warp_sample_batched(..., valid=) from the plane sweep,
// meshrecon/depth/plane_sweep.py:174): one stack resampled bilinearly at
// absolute coordinates (scol, srow), defined only where valid is true and
// written as exactly 0.0 elsewhere. The sweep weights every invalid sample
// by zero, and invalid pixels (behind the side camera, off its frame) hold
// arbitrary coordinates, so the kernel skips their taps altogether.
//
// What bounds them here: device-memory bandwidth. K2 reads 4 floats per
// pixel of coordinates and sources' taps and writes 2; K3 reads 3 and
// writes 1; K3b reads 3 and writes 1 too, with ~70 flops a pixel for its
// weights and 16 taps (bytes still bound it: 16 B against 67 TFLOP/s);
// K3c reads 2 floats and a byte, plus the taps where valid, and writes 1.
// The taps of neighbouring threads share cache lines, so the gathers
// mostly hit L1/L2.
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
// through the read-only cache (__ldg).
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
                           int height, int width) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long plane = (long long)height * width;
  const long long img = idx / plane;
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

// mr_bilinear with the taps read through the read-only cache
__device__ __forceinline__ float bilinear_ldg(const float* __restrict__ img,
                                              float col, float row, int h,
                                              int w) {
  const MrTaps t = mr_bilinear_taps(col, row, h, w);
  return mr_bilinear_mix(__ldg(img + t.r0 * w + t.c0),
                         __ldg(img + t.r0 * w + t.c1),
                         __ldg(img + t.r1 * w + t.c0),
                         __ldg(img + t.r1 * w + t.c1), t.fr, t.fc);
}

// kPix consecutive pixels of a row a thread: 4 (float4 loads of u and v, one
// float4 store; the row's width a multiple of 4) or 1
template <int kPix>
__global__ void __launch_bounds__(kK3Cols * kK3Rows)
warp_bilinear_kernel(const float* __restrict__ image,
                     const float* __restrict__ u, const float* __restrict__ v,
                     float* __restrict__ out, int height, int width) {
  const int c = (blockIdx.x * kK3Cols + threadIdx.x) * kPix;
  const int r = blockIdx.y * kK3Rows + threadIdx.y;
  if (c >= width || r >= height) return;
  const long long plane = (long long)height * width;
  const float* src = image + blockIdx.z * plane;
  const long long at = blockIdx.z * plane + (long long)r * width + c;
  const float fr = (float)r;
  if (kPix == 4) {
    const float4 du = __ldg(reinterpret_cast<const float4*>(u + at));
    const float4 dv = __ldg(reinterpret_cast<const float4*>(v + at));
    float4 o;
    o.x = bilinear_ldg(src, (float)c + du.x, fr + dv.x, height, width);
    o.y = bilinear_ldg(src, (float)(c + 1) + du.y, fr + dv.y, height, width);
    o.z = bilinear_ldg(src, (float)(c + 2) + du.z, fr + dv.z, height, width);
    o.w = bilinear_ldg(src, (float)(c + 3) + du.w, fr + dv.w, height, width);
    *reinterpret_cast<float4*>(out + at) = o;
  } else {
    out[at] = bilinear_ldg(src, (float)c + __ldg(u + at), fr + __ldg(v + at),
                           height, width);
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

__global__ void __launch_bounds__(kThreads)
warp_bicubic_kernel(const float* __restrict__ image,
                    const float* __restrict__ u, const float* __restrict__ v,
                    float* __restrict__ out, long long total, int height,
                    int width) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long plane = (long long)height * width;
  const long long img = idx / plane;
  const int pix = (int)(idx - img * plane);
  const int r = pix / width;
  const int c = pix - r * width;
  const float col = (float)c + u[idx];
  const float row = (float)r + v[idx];
  const float fc0 = floorf(col);
  const float fr0 = floorf(row);
  float wc[4], wr[4];
  cubic_weights(col - fc0, wc);
  cubic_weights(row - fr0, wr);
  // the float clamp before the conversion keeps far-off (or NaN)
  // coordinates in int range; every tap they reach is a border tap either
  // way, as the twin's integer clamp gives
  const int c0 = (int)fminf(fmaxf(fc0, -3.0f), (float)(width + 2));
  const int r0 = (int)fminf(fmaxf(fr0, -3.0f), (float)(height + 2));
  int cj[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) cj[j] = min(max(c0 + j - 1, 0), width - 1);
  const float* src = image + img * plane;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* line = src + min(max(r0 + i - 1, 0), height - 1) * width;
    float row_acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) row_acc = row_acc + wc[j] * line[cj[j]];
    acc = acc + wr[i] * row_acc;
  }
  out[idx] = acc;
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

// shadow, frame, scol, srow, out_shadow, out_frame: (n, height, width);
// bilinear_a != 0 samples the shadow bilinearly, else nearest
MR_EXPORT int mr_sample_shadow_frame(const float* shadow, const float* frame,
                                     const float* scol, const float* srow,
                                     float* out_shadow, float* out_frame,
                                     int bilinear_a, int n, int height,
                                     int width, void* stream) {
  const long long total = (long long)n * height * width;
  if (total == 0) return 0;
  const int blocks = mr_blocks(total, kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (bilinear_a) {
    sample_shadow_frame_kernel<true><<<blocks, kThreads, 0, s>>>(
        shadow, frame, scol, srow, out_shadow, out_frame, total, height,
        width);
  } else {
    sample_shadow_frame_kernel<false><<<blocks, kThreads, 0, s>>>(
        shadow, frame, scol, srow, out_shadow, out_frame, total, height,
        width);
  }
  return (int)cudaGetLastError();
}

// image, u, v, out: (n, height, width). Four pixels a thread when the
// width is a multiple of 4 and u, v, out are 16-byte aligned, else one.
MR_EXPORT int mr_warp_bilinear(const float* image, const float* u,
                               const float* v, float* out, int n, int height,
                               int width, void* stream) {
  if (n < 0 || height < 0 || width < 0 ||
      height > 65535LL * kK3Rows) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)n * height * width == 0) return 0;
  const bool vec = width % 4 == 0 &&
                   (((uintptr_t)u | (uintptr_t)v | (uintptr_t)out) & 15) == 0;
  const int per = vec ? 4 : 1;
  const long long plane = (long long)height * width;
  const dim3 block(kK3Cols, kK3Rows);
  cudaStream_t s = (cudaStream_t)stream;
  for (int z0 = 0; z0 < n; z0 += 65535) {  // gridDim.z <= 65535
    const dim3 grid((width / per + kK3Cols - 1) / kK3Cols,
                    (height + kK3Rows - 1) / kK3Rows,
                    n - z0 < 65535 ? n - z0 : 65535);
    const long long off = z0 * plane;
    if (vec) {
      warp_bilinear_kernel<4><<<grid, block, 0, s>>>(
          image + off, u + off, v + off, out + off, height, width);
    } else {
      warp_bilinear_kernel<1><<<grid, block, 0, s>>>(
          image + off, u + off, v + off, out + off, height, width);
    }
  }
  return (int)cudaGetLastError();
}

// image, u, v, out: (n, height, width)
MR_EXPORT int mr_warp_bicubic(const float* image, const float* u,
                              const float* v, float* out, int n, int height,
                              int width, void* stream) {
  const long long total = (long long)n * height * width;
  if (total == 0) return 0;
  warp_bicubic_kernel<<<mr_blocks(total, kThreads), kThreads, 0,
                        (cudaStream_t)stream>>>(image, u, v, out, total,
                                                height, width);
  return (int)cudaGetLastError();
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
