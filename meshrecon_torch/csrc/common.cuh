// Shared helpers of the meshrecon_torch kernels.
//
// Every C entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError() right after its launch, so that a
// refused launch (bad grid, too much shared memory) reaches the Python
// wrapper, which raises.
//
// The library is built with -fmad=false: a*b+c stays a rounded multiply and
// a rounded add, as in PyTorch's eager elementwise ops, so each kernel
// repeats its plain version's arithmetic operation for operation.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MR_EXPORT extern "C" __attribute__((visibility("default")))

static inline int mr_blocks(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

// Bilinear sample of one (h, w) image at continuous (col, row) with the
// border clamp of meshrecon/raster/fragment.py::bilinear_sample: the
// coordinate is clamped to [0, w-1] x [0, h-1] first, the +1 taps then
// clamp to the last row/column. Weights associate left to right exactly as
// the plain version writes them. The taps and fractions are computed once
// (mr_bilinear_taps) and may serve several images of one shape.
struct MrTaps {
  int r0, r1, c0, c1;
  float fr, fc;
};

__device__ __forceinline__ MrTaps mr_bilinear_taps(float col, float row,
                                                   int h, int w) {
  col = fminf(fmaxf(col, 0.0f), (float)(w - 1));
  row = fminf(fmaxf(row, 0.0f), (float)(h - 1));
  MrTaps t;
  t.c0 = (int)floorf(col);
  t.r0 = (int)floorf(row);
  t.c1 = min(t.c0 + 1, w - 1);
  t.r1 = min(t.r0 + 1, h - 1);
  t.fc = col - (float)t.c0;
  t.fr = row - (float)t.r0;
  return t;
}

// The plain version's weighted sum of the four taps.
__device__ __forceinline__ float mr_bilinear_mix(float v00, float v01,
                                                 float v10, float v11,
                                                 float fr, float fc) {
  return v00 * (1.0f - fr) * (1.0f - fc) + v01 * (1.0f - fr) * fc +
         v10 * fr * (1.0f - fc) + v11 * fr * fc;
}

__device__ __forceinline__ float mr_bilinear_apply(
    const float* __restrict__ img, const MrTaps& t, int w) {
  return mr_bilinear_mix(img[t.r0 * w + t.c0], img[t.r0 * w + t.c1],
                         img[t.r1 * w + t.c0], img[t.r1 * w + t.c1], t.fr,
                         t.fc);
}

__device__ __forceinline__ float mr_bilinear(const float* __restrict__ img,
                                             float col, float row, int h,
                                             int w) {
  return mr_bilinear_apply(img, mr_bilinear_taps(col, row, h, w), w);
}
