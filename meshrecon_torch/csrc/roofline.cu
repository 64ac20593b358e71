// R1-R4: the roofline probes of meshrecon_torch/tools/roofline.py.
//
// They replace the four Pallas kernels of tools/roofline.py (closures of its
// main): copy_kernel (R1, the HBM stream), fma_kernel (R2, the float32 FMA
// peak) and tiny_kernel (R3, the launch floor, and R4, the same kernel on a
// grid of n steps). Each computes what the TPU probe computes, so that the
// port's tool reads the same quantities on the card.
//
// R1 (mr_roofline_copy): o = x * 1.0000001f over n floats. Bound by bytes:
// each element read once and written once. Design: a grid-stride loop over
// 16-byte (float4) loads and stores, consecutive threads on consecutive
// addresses, a few hundred thousand threads in flight; the tail of n % 4
// floats goes to the first threads one float each. The wrapper requires
// 16-byte aligned pointers.
//
// R2 (mr_roofline_fma): one thread per element; each keeps x and acc in
// registers and runs `inner` dependent acc = fma(acc, x, 1e-7f) from
// acc = x, then stores acc. Bound by operations: 2 * n * inner float32
// operations, no memory traffic inside the loop. The library is built with
// -fmad=false, so a written a * b + c would stay a multiply and an add:
// __fmaf_rn is the fused operation that XLA's contraction gives the TPU
// probe. With one dependent chain a thread, the rate depends on enough warps
// being resident to hide the FMA latency; the block is the TPU probe's
// (256, 512), not enlarged.
//
// R3 and R4 (mr_roofline_tiny): o = x + 1.0f over (rows, 128) in nblocks
// CTAs of 128 threads, CTA b taking rows [b * rows / nblocks, (b + 1) *
// rows / nblocks), thread t its column t. R3 is 8 rows in one CTA: the
// cost of a launch. R4 is 512 rows in 1 and in 64 CTAs: on the TPU a grid
// step runs after the last on one core; here the CTAs run in parallel on
// the 132 SMs, so the 64-CTA launch measures that parallelism, not a
// sequential step.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTinyCols = 128;
constexpr int kMaxCopyBlocks = 132 * 16;

__global__ void __launch_bounds__(kThreads)
roofline_copy_kernel(const float* __restrict__ x, float* __restrict__ o,
                     long long n) {
  const float scale = 1.0000001f;
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(o);
  for (long long i = first; i < n4; i += stride) {
    float4 v = x4[i];
    v.x = v.x * scale;
    v.y = v.y * scale;
    v.z = v.z * scale;
    v.w = v.w * scale;
    o4[i] = v;
  }
  const long long tail = 4 * n4 + first;
  if (tail < n) o[tail] = x[tail] * scale;
}

__global__ void __launch_bounds__(kThreads)
roofline_fma_kernel(const float* __restrict__ x, float* __restrict__ o,
                    int n, int inner) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float xv = x[i];
  float acc = xv;
#pragma unroll 16
  for (int k = 0; k < inner; ++k) acc = __fmaf_rn(acc, xv, 1e-7f);
  o[i] = acc;
}

__global__ void __launch_bounds__(kTinyCols)
roofline_tiny_kernel(const float* __restrict__ x, float* __restrict__ o,
                     int rows_per_block) {
  const long long base =
      (long long)blockIdx.x * rows_per_block * kTinyCols + threadIdx.x;
#pragma unroll 4
  for (int r = 0; r < rows_per_block; ++r) {
    const long long i = base + (long long)r * kTinyCols;
    o[i] = x[i] + 1.0f;
  }
}

}  // namespace

// x, o: n floats, 16-byte aligned
MR_EXPORT int mr_roofline_copy(const float* x, float* o, int n,
                               void* stream) {
  if (n < 0 || (reinterpret_cast<unsigned long long>(x) & 15) ||
      (reinterpret_cast<unsigned long long>(o) & 15))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = std::min(
      std::max(mr_blocks((long long)n / 4, kThreads), 1), kMaxCopyBlocks);
  roofline_copy_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, o,
                                                                        n);
  return (int)cudaGetLastError();
}

// x, o: n floats; inner: FMAs a element
MR_EXPORT int mr_roofline_fma(const float* x, float* o, int n, int inner,
                              void* stream) {
  if (n < 0 || inner < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  roofline_fma_kernel<<<mr_blocks(n, kThreads), kThreads, 0,
                        (cudaStream_t)stream>>>(x, o, n, inner);
  return (int)cudaGetLastError();
}

// x, o: (rows, 128) floats, rows a multiple of nblocks
MR_EXPORT int mr_roofline_tiny(const float* x, float* o, int rows,
                               int nblocks, void* stream) {
  if (rows < 1 || nblocks < 1 || rows % nblocks)
    return (int)cudaErrorInvalidValue;
  roofline_tiny_kernel<<<nblocks, kTinyCols, 0, (cudaStream_t)stream>>>(
      x, o, rows / nblocks);
  return (int)cudaGetLastError();
}
