// K2, K3 and K3c: per-pixel gathers, one thread per output pixel.
//
// K2 replaces meshrecon/flow/tile_warp.py::_warp_tile_kernel2 (launched by
// tile_warp_sample2 / tile_warp_sample2_batched for projective texturing):
// two same-shape stacks sampled at one coordinate field, source A (the
// dilated shadow depth) nearest with floor(x + 0.5) and a border clamp,
// source B (the side frame) bilinear with a border clamp.
//
// K3 replaces meshrecon/flow/tile_warp.py::_warp_tile_kernel with taps=2
// (tile_warp_flow_batched, the flow solver's warps): one stack resampled
// bilinearly at (col + u, row + v).
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
// writes 1; K3c reads 2 floats and a byte, plus the taps where valid, and
// writes 1. The taps of neighbouring threads share cache lines, so the
// gathers mostly hit L1/L2; there is no arithmetic to speak of.
//
// Design: the TPU kernels exist because TPU gathers are slow; they fit a
// per-tile integer base offset and enumerate bounded residual taps, and
// clamp residuals beyond their budget. Hopper gathers are cheap, so these
// are the plain gathers of the XLA twins (fragment.bilinear_sample,
// fragment.nearest_sample, remap.bilinear_warp) with no residual budget
// and no tile fit; consecutive threads take consecutive pixels of a row,
// so coordinate loads and output stores coalesce.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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
  // nearest, rounding half up; the float clamp equals clamping the
  // saturated integer, and maps NaN to 0
  const float cn = fminf(fmaxf(floorf(col + 0.5f), 0.0f), (float)(width - 1));
  const float rn = fminf(fmaxf(floorf(row + 0.5f), 0.0f), (float)(height - 1));
  out_shadow[idx] = a[(int)rn * width + (int)cn];
  out_frame[idx] = mr_bilinear(b, col, row, height, width);
}

__global__ void __launch_bounds__(kThreads)
warp_bilinear_kernel(const float* __restrict__ image,
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
  out[idx] = mr_bilinear(image + img * plane, (float)c + u[idx],
                         (float)r + v[idx], height, width);
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

// shadow, frame, scol, srow, out_shadow, out_frame: (n, height, width)
MR_EXPORT int mr_sample_shadow_frame(const float* shadow, const float* frame,
                                     const float* scol, const float* srow,
                                     float* out_shadow, float* out_frame,
                                     int n, int height, int width,
                                     void* stream) {
  const long long total = (long long)n * height * width;
  if (total == 0) return 0;
  sample_shadow_frame_kernel<<<mr_blocks(total, kThreads), kThreads, 0,
                               (cudaStream_t)stream>>>(
      shadow, frame, scol, srow, out_shadow, out_frame, total, height, width);
  return (int)cudaGetLastError();
}

// image, u, v, out: (n, height, width)
MR_EXPORT int mr_warp_bilinear(const float* image, const float* u,
                               const float* v, float* out, int n, int height,
                               int width, void* stream) {
  const long long total = (long long)n * height * width;
  if (total == 0) return 0;
  warp_bilinear_kernel<<<mr_blocks(total, kThreads), kThreads, 0,
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
