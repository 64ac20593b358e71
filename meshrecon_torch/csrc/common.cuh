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

#define MR_EXPORT extern "C" __attribute__((visibility("default")))

static inline int mr_blocks(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

// Bilinear sample of one (h, w) image at continuous (col, row) with the
// border clamp of meshrecon/raster/fragment.py::bilinear_sample: the
// coordinate is clamped to [0, w-1] x [0, h-1] first, the +1 taps then
// clamp to the last row/column. Weights associate left to right exactly as
// the plain version writes them.
__device__ __forceinline__ float mr_bilinear(const float* __restrict__ img,
                                             float col, float row, int h,
                                             int w) {
  col = fminf(fmaxf(col, 0.0f), (float)(w - 1));
  row = fminf(fmaxf(row, 0.0f), (float)(h - 1));
  const int c0 = (int)floorf(col);
  const int r0 = (int)floorf(row);
  const int c1 = min(c0 + 1, w - 1);
  const int r1 = min(r0 + 1, h - 1);
  const float fc = col - (float)c0;
  const float fr = row - (float)r0;
  const float v00 = img[r0 * w + c0];
  const float v01 = img[r0 * w + c1];
  const float v10 = img[r1 * w + c0];
  const float v11 = img[r1 * w + c1];
  return v00 * (1.0f - fr) * (1.0f - fc) + v01 * (1.0f - fr) * fc +
         v10 * fr * (1.0f - fc) + v11 * fr * fc;
}
