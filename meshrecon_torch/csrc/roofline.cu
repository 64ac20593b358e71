// R1-R4: the roofline probes of meshrecon_torch/tools/roofline.py.
//
// They replace the four Pallas kernels of tools/roofline.py (closures of its
// main): copy_kernel (R1, the HBM stream), fma_kernel (R2, the float32 FMA
// peak) and tiny_kernel (R3, the launch floor, and R4, the same kernel on a
// grid of n steps). Each computes what the TPU probe computes, so that the
// port's tool reads the same quantities on the card.
//
// R1 (mr_roofline_copy): o = x * 1.0000001f over n floats. Bound by bytes:
// each element read once and written once, 64 MiB each way at the tool's
// shape, more than the 50 MB L2, so the stream runs from HBM. Design: each
// CTA of 256 threads owns one whole chunk of 512 float4s (8 KiB); each
// thread issues its 2 float4 loads before any store, with streaming hints
// (__ldcs / __stcs: evict-first, the data is touched once). No thread walks
// a stride: the grid is the chunk count (8,192 CTAs at the tool's shape).
// Of the variants timed on the card (PERF.md), 2, 4 or 8 loads a thread
// and 128-1,024 threads a CTA lie within 1%, 2 loads of 256 threads the
// fastest; a persistent grid of 4 or 8 CTAs an SM lost ~5%, and a
// persistent CTA an SM streaming through a ring of bulk copies (TMA) in
// shared memory ~10%. The tail of n % 4 floats goes to the first threads
// of CTA 0, one float each. The wrapper requires 16-byte aligned pointers.
//
// R2 (mr_roofline_fma): each element keeps x and acc in registers and runs
// `inner` dependent acc = fma(acc, x, 1e-7f) from acc = x, then stores acc.
// Bound by operations: 2 * n * inner float32 operations, no memory traffic
// inside the loop. The library is built with -fmad=false, so a written
// a * b + c would stay a multiply and an add: __fmaf_rn is the fused
// operation that XLA's contraction gives the TPU probe. Design: a chain is
// sequential, so the FMA latency is hidden inside each thread, which runs
// kFmaChains independent elements interleaved, strided by the grid's thread
// count (loads and stores coalesce). The grid comes from the SM count
// (read once a device): a CTA takes one SM's share of the elements in
// chains, rounded up to whole warps (mr_roofline_fma_shape; at the tool's
// 256x512, 128 CTAs of 256 threads, two warps of four chains on each SM
// sub-partition, so no SM carries a wave more than another). The loop steps
// kFmaUnroll FMAs a chain between its counter tests, which would otherwise
// take issue slots from the FMAs; a remainder loop takes `inner` modulo
// that. Every element's chain is the same operations in the same order
// whatever the geometry, so the output does not depend on it.
//
// R3 and R4 (mr_roofline_tiny): o = x + 1.0f over (rows, 128) in nblocks
// CTAs, CTA b taking rows [b * rows / nblocks, (b + 1) * rows / nblocks).
// R3 is 8 rows in one CTA: the cost of a launch. R4 is 512 rows in 1 and in
// 64 CTAs: on the TPU a grid step runs after the last on one core; here the
// CTAs run in parallel on the 132 SMs, so the 64-CTA launch measures that
// parallelism, not a sequential step. Design: a row is 32 float4s, one warp.
// A CTA of up to 1,024 float4s (32 rows: R3, R4 at 64 CTAs) has one thread
// a float4 and no loop, the least a launch can carry; a larger one has
// 1,024 threads, each issuing 8 independent float4 loads before their
// stores, so one CTA walks 512 rows in 2 rounds of loads, not 128
// dependent ones, and is bound by one SM's share of the L2 bandwidth, not
// by load latency. The entry refuses pointers that are not 16-byte aligned.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCopyUnroll = 2;                       // float4 loads a thread
constexpr int kCopyChunk = kThreads * kCopyUnroll;   // float4s a CTA
constexpr int kTinyCols = 128;
constexpr int kTinyRow4 = kTinyCols / 4;             // float4s a row
constexpr int kTinyMaxThreads = 1024;
constexpr int kTinyBatch = 8;                        // float4 loads a thread
constexpr int kFmaChains = 4;    // independent chains a thread
constexpr int kFmaUnroll = 64;   // FMAs a chain between loop tests
constexpr int kFmaMaxThreads = 1024;

__device__ __forceinline__ float4 scale4(float4 v) {
  const float scale = 1.0000001f;
  v.x = v.x * scale;
  v.y = v.y * scale;
  v.z = v.z * scale;
  v.w = v.w * scale;
  return v;
}

__device__ __forceinline__ void copy_tail(const float* __restrict__ x,
                                          float* __restrict__ o,
                                          long long n) {
  const long long i = (n & ~3LL) + threadIdx.x;
  if (blockIdx.x == 0 && i < n) o[i] = x[i] * 1.0000001f;
}

__global__ void __launch_bounds__(kThreads)
roofline_copy_kernel(const float* __restrict__ x, float* __restrict__ o,
                     long long n) {
  const long long n4 = n / 4;
  const long long base = (long long)blockIdx.x * kCopyChunk + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x) + base;
  float4* o4 = reinterpret_cast<float4*>(o) + base;
  float4 v[kCopyUnroll];
  if (base + (kCopyUnroll - 1) * kThreads < n4) {
#pragma unroll
    for (int k = 0; k < kCopyUnroll; ++k) v[k] = __ldcs(x4 + k * kThreads);
#pragma unroll
    for (int k = 0; k < kCopyUnroll; ++k)
      __stcs(o4 + k * kThreads, scale4(v[k]));
  } else {
#pragma unroll
    for (int k = 0; k < kCopyUnroll; ++k)
      if (base + k * kThreads < n4) v[k] = __ldcs(x4 + k * kThreads);
#pragma unroll
    for (int k = 0; k < kCopyUnroll; ++k)
      if (base + k * kThreads < n4) __stcs(o4 + k * kThreads, scale4(v[k]));
  }
  copy_tail(x, o, n);
}

__global__ void __launch_bounds__(kFmaMaxThreads)
roofline_fma_kernel(const float* __restrict__ x, float* __restrict__ o,
                    int n, int inner) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float xv[kFmaChains], acc[kFmaChains];
#pragma unroll
  for (int c = 0; c < kFmaChains; ++c) {
    const long long i = first + c * stride;
    xv[c] = i < n ? x[i] : 0.0f;  // a chain past n runs and is not stored
    acc[c] = xv[c];
  }
  int k = 0;
  for (; inner - k >= kFmaUnroll; k += kFmaUnroll) {
#pragma unroll
    for (int s = 0; s < kFmaUnroll; ++s)
#pragma unroll
      for (int c = 0; c < kFmaChains; ++c)
        acc[c] = __fmaf_rn(acc[c], xv[c], 1e-7f);
  }
  for (; k < inner; ++k)
#pragma unroll
    for (int c = 0; c < kFmaChains; ++c)
      acc[c] = __fmaf_rn(acc[c], xv[c], 1e-7f);
#pragma unroll
  for (int c = 0; c < kFmaChains; ++c) {
    const long long i = first + c * stride;
    if (i < n) o[i] = acc[c];
  }
}

__device__ __forceinline__ float4 add_one4(float4 v) {
  v.x = v.x + 1.0f;
  v.y = v.y + 1.0f;
  v.z = v.z + 1.0f;
  v.w = v.w + 1.0f;
  return v;
}

// A CTA of per_block float4s: kBatch 1 takes one a thread (per_block
// threads, no loop: R3 and R4 at 64 CTAs); kBatch 8 walks the CTA's rows in
// rounds of 8 loads a thread (1,024 threads: R4 at one CTA).
template <int kBatch>
__global__ void __launch_bounds__(kTinyMaxThreads)
roofline_tiny_kernel(const float4* __restrict__ x, float4* __restrict__ o,
                     int per_block) {
  x += (long long)blockIdx.x * per_block;
  o += (long long)blockIdx.x * per_block;
  if (kBatch == 1) {
    o[threadIdx.x] = add_one4(x[threadIdx.x]);
    return;
  }
  const int step = blockDim.x;
  int first = threadIdx.x;
  for (; first + (kBatch - 1) * step < per_block; first += kBatch * step) {
    float4 v[kBatch];  // a whole batch: no bounds checks
#pragma unroll
    for (int k = 0; k < kBatch; ++k) v[k] = x[first + k * step];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) o[first + k * step] = add_one4(v[k]);
  }
  for (; first < per_block; first += step) o[first] = add_one4(x[first]);
}

bool misaligned(const void* p) {
  return reinterpret_cast<unsigned long long>(p) & 15;
}

// R2's grid for n elements on sms SMs: {CTAs, threads a CTA, chains a
// thread}. A CTA takes ceil(n / sms) elements, kFmaChains a thread, in
// whole warps (32 to 1,024 threads); element first + c * stride for chain
// c, stride = CTAs x threads.
void fma_shape(int n, int sms, int* out) {
  const long long per_sm = ((long long)n + sms - 1) / sms;
  long long threads = (per_sm + kFmaChains - 1) / kFmaChains;
  threads = std::min<long long>(
      std::max<long long>((threads + 31) / 32 * 32, 32), kFmaMaxThreads);
  out[0] = (int)(((long long)n + threads * kFmaChains - 1) /
                 (threads * kFmaChains));
  out[1] = (int)threads;
  out[2] = kFmaChains;
}

// The current device's SM count, read once a device.
cudaError_t sm_count(int* sms) {
  static int cache[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int& c = cache[dev & 63];
  if (c == 0) {
    e = cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *sms = c;
  return cudaSuccess;
}

}  // namespace

// x, o: n floats, 16-byte aligned
MR_EXPORT int mr_roofline_copy(const float* x, float* o, int n,
                               void* stream) {
  if (n < 0 || misaligned(x) || misaligned(o))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = std::max(mr_blocks((long long)n / 4, kCopyChunk), 1);
  roofline_copy_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, o,
                                                                      n);
  return (int)cudaGetLastError();
}

// x, o: n floats; inner: FMAs a element
MR_EXPORT int mr_roofline_fma(const float* x, float* o, int n, int inner,
                              void* stream) {
  if (n < 0 || inner < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  int shape[3];
  fma_shape(n, sms, shape);
  roofline_fma_kernel<<<shape[0], shape[1], 0, (cudaStream_t)stream>>>(
      x, o, n, inner);
  return (int)cudaGetLastError();
}

// R2's launch geometry for n elements on sms SMs (the launch reads the
// device's own count): out = {CTAs, threads a CTA, chains a thread}
MR_EXPORT int mr_roofline_fma_shape(int n, int sms, int* out) {
  if (n < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  fma_shape(n, sms, out);
  return 0;
}

// x, o: (rows, 128) floats, 16-byte aligned, rows a multiple of nblocks
MR_EXPORT int mr_roofline_tiny(const float* x, float* o, int rows,
                               int nblocks, void* stream) {
  if (rows < 1 || rows > INT_MAX / kTinyCols || nblocks < 1 ||
      rows % nblocks || misaligned(x) || misaligned(o))
    return (int)cudaErrorInvalidValue;
  const int per_block = rows / nblocks * kTinyRow4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(o);
  if (per_block <= kTinyMaxThreads)
    roofline_tiny_kernel<1><<<nblocks, per_block, 0, (cudaStream_t)stream>>>(
        x4, o4, per_block);
  else
    roofline_tiny_kernel<kTinyBatch><<<nblocks, kTinyMaxThreads, 0,
                                       (cudaStream_t)stream>>>(x4, o4,
                                                               per_block);
  return (int)cudaGetLastError();
}
