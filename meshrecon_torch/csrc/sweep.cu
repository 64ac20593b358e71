// SWEEP: a depth plane of the plane sweep as three kernels around K3c.
//
// Replaces the per-plane eager ops of meshrecon_torch/depth/plane_sweep.py
// (SweepWindow.evidence and the running best of sweep_windows, the plain
// version, which the CPU keeps), the port of the lax.scan body of
// meshrecon/depth/plane_sweep.py:152-205 (cost_at and step; no TPU kernel of
// their own: XLA fuses each plane there, and the Pallas tile warp, K3c here,
// samples the sides). A plane is four launches:
//
//   - SWEEP_PROJ (mr_sweep_proj): a thread maps 4 adjacent main pixels in
//     each of 4 rows of a side slot on the plane into the side camera
//     (apply_cm, the w guard, the divisions, the frame test) and writes
//     K3c's mask and, in each group of 4 where it is set anywhere, the side
//     pixels' columns and rows (K3c reads them nowhere else). A padded side
//     slot (side_valid false) gets an empty mask: its weight is 0, so the
//     sums do not change, and K3c samples nothing there.
//   - K3c (sample_bilinear_masked_kernel, csrc/warp.cu), unchanged.
//   - SWEEP_COST (mr_sweep_cost): a quad of threads sums for 4 adjacent
//     main pixels over the sides the weighted absolute difference of the
//     sample from the main frame (num) and the weight (den); a side whose
//     mask is empty there adds an exact +0 in the eager sums and is
//     skipped, reading nothing more. (1 pixel a quad where the width is not
//     a multiple of 4.)
//   - SWEEP_BEST (mr_sweep_best): a thread a main pixel box-filters
//     num / max(den, 1e-6) over its 3x3 neighbourhood (edge-replicated) and
//     updates the running (best, previous, next) costs, the best plane's
//     depth, the support and the last cost in place. A window split in
//     shards sums the shards' (num, den) before it, in shard order.
//
// Rounding. Every operation is the eager path's, in its order (-fmad=false,
// IEEE division, the Python constants rounded to float as torch rounds a
// scalar; the box filter's `/ 9.0` is torch's CUDA division by a host
// scalar, a multiplication by the float reciprocal of 9). The sums over
// sides take torch's CUDA reduction order for a sum over dim 1 of fewer than
// 256 planes: four accumulators, side k into accumulator k % 4, each started
// at 0, then ((a0 + a1) + a2) + a3 (as csrc/triangulate.cu). So the outputs
// are the eager path's bit for bit wherever the frames and weights are
// finite (a skipped side's 0 * inf would be NaN there).
//
// What bounds it. Bytes, in all three: SWEEP_PROJ writes a mask byte a
// (side, pixel) and 8 bytes of coordinates where it is set; SWEEP_COST reads
// the mask byte of each valid side and, where it is set, the sample (and the
// weight); SWEEP_BEST reads num and den (its taps hit the cache) and reads
// and writes 25 bytes of state a pixel. At 1x32x1080x1920, with ~20% of the
// side pixels in frame, that is 175, 145 and 120 MB a plane: 0.052, 0.043
// and 0.036 ms at 3.35 TB/s. So the planes move as vectors of 4 pixels, the
// divisions run only where a division-free test leaves a pixel in frame,
// and SWEEP_COST splits each pixel's chain of dependent loads (mask, then
// sample) over four threads, one a torch accumulator.
#include "common.cuh"

namespace {

// A CTA: kCols threads across a row, kRows rows; in SWEEP_PROJ and
// SWEEP_COST each thread takes kPix adjacent pixels of its row (4 where
// the width and the pointers allow vector loads and stores, else 1)
constexpr int kCols = 32, kRows = 8;
constexpr int kProjRows = 4;  // rows a SWEEP_PROJ thread maps
// the eager path's Python constants, rounded once from double to float
constexpr float kTinyW = (float)1e-6;
constexpr float kMinDen = (float)1e-6;
constexpr float kNinth = 1.0f / 9.0f;  // torch: x * (1.0f / 9.0f)

template <int kPix>
struct Pix;
template <>
struct Pix<1> {
  using F = float;
  using B = unsigned char;
  static __device__ __forceinline__ float at(const F& v, int) { return v; }
  static __device__ __forceinline__ unsigned char at(const B& v, int) {
    return v;
  }
  static __device__ __forceinline__ B pack(const bool* g) { return g[0]; }
  static __device__ __forceinline__ F make(const float* v) { return v[0]; }
};
template <>
struct Pix<4> {
  using F = float4;
  using B = uchar4;
  static __device__ __forceinline__ float at(const F& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ unsigned char at(const B& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ B pack(const bool* g) {
    return make_uchar4(g[0], g[1], g[2], g[3]);
  }
  static __device__ __forceinline__ F make(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

// grid (column blocks, row blocks, n * k): a CTA holds one side slot's
// (kRows * kProjRows) x (kCols * kPix) pixels, a thread kPix adjacent
// columns of kProjRows rows kRows apart (the camera row read once for them)
template <int kPix>
__global__ void __launch_bounds__(kCols * kRows)
    sweep_proj_kernel(const float* __restrict__ cm,
                      const float* __restrict__ zs,
                      const unsigned char* __restrict__ side_valid,
                      const float* __restrict__ cols,
                      const float* __restrict__ rows,
                      unsigned char* __restrict__ ok,
                      float* __restrict__ scol, float* __restrict__ srow,
                      int d, int n, int k, int height, int width) {
  using P = Pix<kPix>;
  const int slot = blockIdx.z;  // b * k + side
  const int r0 = blockIdx.y * kRows * kProjRows + threadIdx.y;
  const int c0 = (blockIdx.x * kCols + threadIdx.x) * kPix;
  if (r0 >= height || c0 >= width) return;
  const long long slot0 = (long long)slot * height * width + c0;
  bool good[kPix];
  if (!side_valid[slot]) {
#pragma unroll
    for (int j = 0; j < kPix; ++j) good[j] = false;
    for (int r = r0; r < height && r < r0 + kRows * kProjRows; r += kRows) {
      *reinterpret_cast<typename P::B*>(ok + slot0 + (long long)r * width) =
          P::pack(good);
    }
    return;
  }
  float m[12];  // rows 0, 1 and 3 of the camera product
  const float* src = cm + 16LL * slot;
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = src[j];
#pragma unroll
  for (int j = 0; j < 4; ++j) m[8 + j] = src[12 + j];
  const float z = zs[(long long)d * n + slot / k];
  const typename P::F xs = *reinterpret_cast<const typename P::F*>(cols + c0);
  for (int r = r0; r < height && r < r0 + kRows * kProjRows; r += kRows) {
    const long long at = slot0 + (long long)r * width;
    const float y = rows[r];
    float cc[kPix], rr[kPix];
    bool any = false;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const float x = P::at(xs, j);
      // apply_cm: ((c0 * x + c1 * y) + c2 * z) + c3 for rows 0, 1 and 3
      const float s0 = ((m[0] * x + m[1] * y) + m[2] * z) + m[3];
      const float s1 = ((m[4] * x + m[5] * y) + m[6] * z) + m[7];
      const float sw = ((m[8] * x + m[9] * y) + m[10] * z) + m[11];
      // ok = sw > 1e-6 (the guard then leaves sw as it is) and |s0 / sw|,
      // |s1 / sw| < 1. Where |s0| >= sw > 0 the quotient is >= 1 before
      // rounding and so after it: the pixel is out without a division.
      bool g = sw > kTinyW && fabsf(s0) < sw && fabsf(s1) < sw;
      float sx = s0, sy = s1;  // any value where the pixel is out
      if (g) {
        sx = s0 / sw;
        sy = s1 / sw;
        g = fabsf(sx) < 1.0f && fabsf(sy) < 1.0f;
      }
      cc[j] = ((sx + 1.0f) * 0.5f) * (float)width;
      rr[j] = ((1.0f - sy) * 0.5f) * (float)height;
      good[j] = g;
      any = any || g;
    }
    *reinterpret_cast<typename P::B*>(ok + at) = P::pack(good);
    // the coordinates where a pixel of the group is in: whole vectors
    // (scattered scalar stores took twice as long on an H100)
    if (any) {
      *reinterpret_cast<typename P::F*>(scol + at) = P::make(cc);
      *reinterpret_cast<typename P::F*>(srow + at) = P::make(rr);
    }
  }
}

// grid (column blocks, row blocks, n): a CTA holds kRows x (kCols / 4 *
// kPix) pixels of one main frame. The 4 threads of a quad share kPix
// adjacent pixels, thread j taking the sides j, j + 4, ... into its own
// sums (torch's accumulator j), which the quad then adds in order: four
// short chains of dependent loads in place of one long one.
template <bool kWeighted, int kPix>
__global__ void __launch_bounds__(kCols * kRows)
    sweep_cost_kernel(const float* __restrict__ samp,
                      const unsigned char* __restrict__ ok,
                      const unsigned char* __restrict__ side_valid,
                      const float* __restrict__ frame,
                      const float* __restrict__ weight,
                      float* __restrict__ num, float* __restrict__ den,
                      int k, int height, int width) {
  using P = Pix<kPix>;
  using F = typename P::F;
  using B = typename P::B;
  extern __shared__ unsigned char valid[];  // the item's side flags
  const int b = blockIdx.z;
  for (int s = threadIdx.y * kCols + threadIdx.x; s < k; s += kCols * kRows) {
    valid[s] = side_valid[(long long)b * k + s];
  }
  __syncthreads();
  const int j = threadIdx.x & 3;  // the accumulator
  const int r = blockIdx.y * kRows + threadIdx.y;
  const int c0 = (blockIdx.x * (kCols / 4) + (threadIdx.x >> 2)) * kPix;
  if (r >= height || c0 >= width) return;  // the whole quad
  const long long plane = (long long)height * width;
  const long long pix = (long long)r * width + c0;
  const F f = *reinterpret_cast<const F*>(frame + b * plane + pix);
  float an[kPix], ad[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) an[p] = ad[p] = 0.0f;
  for (int s = j; s < k; s += 4) {
    if (!valid[s]) continue;
    const long long at = ((long long)b * k + s) * plane + pix;
    const B o = *reinterpret_cast<const B*>(ok + at);
    bool any = false;
#pragma unroll
    for (int p = 0; p < kPix; ++p) any = any || P::at(o, p);
    if (!any) continue;
    const F v = *reinterpret_cast<const F*>(samp + at);
    F wv;
    if (kWeighted) wv = *reinterpret_cast<const F*>(weight + at);
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      if (!P::at(o, p)) continue;
      // wgt = (ok * vmask) * swt = swt, or 1 unweighted
      const float diff = fabsf(P::at(v, p) - P::at(f, p));
      if (kWeighted) {
        const float wgt = P::at(wv, p);
        an[p] = an[p] + diff * wgt;
        ad[p] = ad[p] + wgt;
      } else {
        an[p] = an[p] + diff;
        ad[p] = ad[p] + 1.0f;
      }
    }
  }
  // ((a0 + a1) + a2) + a3, in every lane of the quad; lane 0 writes
  const int lead = (threadIdx.x & 31) & ~3;
  const unsigned quad = 0xFu << lead;
  float sn[kPix], sd[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    sn[p] = __shfl_sync(quad, an[p], lead);
    sd[p] = __shfl_sync(quad, ad[p], lead);
#pragma unroll
    for (int i = 1; i < 4; ++i) {
      sn[p] = sn[p] + __shfl_sync(quad, an[p], lead + i);
      sd[p] = sd[p] + __shfl_sync(quad, ad[p], lead + i);
    }
  }
  if (j != 0) return;
  const long long out = b * plane + pix;
  *reinterpret_cast<F*>(num + out) = P::make(sn);
  *reinterpret_cast<F*>(den + out) = P::make(sd);
}

// torch.clamp(min=lo)'s: NaN passes through
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return v < lo ? lo : v;
}

// torch.maximum's: a NaN wins
__device__ __forceinline__ float maximum_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// The running best's planes in SWEEP_BEST's state, each (n, height,
// width)
enum { kBestC, kBestPrev, kBestNext, kLastC, kBestZ, kSupport };

// grid (column blocks, row blocks, n): a CTA holds kRows x kCols pixels of
// one main frame
__global__ void __launch_bounds__(kCols * kRows)
    sweep_best_kernel(const float* __restrict__ num,
                      const float* __restrict__ den,
                      const float* __restrict__ zs, float* __restrict__ state,
                      unsigned char* __restrict__ pending, int d, int n,
                      int height, int width) {
  const int b = blockIdx.z;
  const int r = blockIdx.y * kRows + threadIdx.y;
  const int c = blockIdx.x * kCols + threadIdx.x;
  if (r >= height || c >= width) return;
  const long long plane = (long long)height * width;
  const long long i = (long long)r * width + c;
  const float* nb = num + (long long)b * plane;
  const float* db = den + (long long)b * plane;
  // _box3 of num / den.clamp(min=1e-6): the nine taps in its order, rows
  // r-1, r, r+1, each at columns c-1, c, c+1, the border replicated
  float sum = 0.0f;
#pragma unroll
  for (int dr = -1; dr <= 1; ++dr) {
    const long long rr = min(max(r + dr, 0), height - 1) * (long long)width;
#pragma unroll
    for (int dc = -1; dc <= 1; ++dc) {
      const long long t = rr + min(max(c + dc, 0), width - 1);
      const float v = nb[t] / clamp_min_nan(db[t], kMinDen);
      sum = (dr == -1 && dc == -1) ? v : sum + v;
    }
  }
  const float cost = sum * kNinth;
  const long long at = (long long)b * plane + i;
  const long long step = (long long)n * plane;  // one state plane
  float* s = state + at;
  const bool is_best = cost < s[kBestC * step];
  if (is_best) {
    s[kBestPrev * step] = s[kLastC * step];
    s[kBestZ * step] = zs[(long long)d * n + b];
    s[kBestC * step] = cost;
  } else if (pending[at]) {
    s[kBestNext * step] = cost;
  }
  pending[at] = is_best;
  s[kSupport * step] = maximum_nan(s[kSupport * step], db[i]);
  s[kLastC * step] = cost;
}

bool shape_ok(int n, int k, int height, int width) {
  return n >= 0 && n <= 65535 && k >= 0 && height >= 1 && width >= 1;
}

bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// The CTAs of SWEEP_PROJ and SWEEP_COST for kPix pixels a thread
dim3 pixel_grid(int height, int width, int kpix, int planes) {
  return dim3((width + kCols * kpix - 1) / (kCols * kpix),
              (height + kRows - 1) / kRows, planes);
}

}  // namespace

// cm (n, k, 4, 4): the side cameras times the main cameras' inverse; zs
// (D, n): the planes' NDC depths, plane d read on the card; side_valid (n,
// k) bytes; cols (width,), rows (height,): the pixels' NDC positions
// (raster/rasterizer.py's pixel_grid). Writes ok (n, k, height, width)
// bytes and, where ok is set, scol and srow (n, k, height, width); their
// other values are undefined. Four pixels a thread when the width is a
// multiple of 4 and cols, ok, scol and srow are aligned for it, else one.
MR_EXPORT int mr_sweep_proj(const float* cm, const float* zs,
                            const unsigned char* side_valid,
                            const float* cols, const float* rows,
                            unsigned char* ok, float* scol, float* srow,
                            int d, int n, int k, int height, int width,
                            void* stream) {
  if (!shape_ok(n, k, height, width) || d < 0 ||
      (long long)n * k > 65535 || height > 65535 * kRows) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)n * k == 0) return 0;
  const dim3 block(kCols, kRows);
  cudaStream_t s = (cudaStream_t)stream;
  const int vec = width % 4 == 0 && aligned(cols, 16) && aligned(ok, 4) &&
                  aligned(scol, 16) && aligned(srow, 16);
  dim3 grid = pixel_grid(height, width, vec ? 4 : 1, n * k);
  grid.y = (height + kRows * kProjRows - 1) / (kRows * kProjRows);
  if (vec) {
    sweep_proj_kernel<4><<<grid, block, 0, s>>>(
        cm, zs, side_valid, cols, rows, ok, scol, srow, d, n, k, height,
        width);
  } else {
    sweep_proj_kernel<1><<<grid, block, 0, s>>>(
        cm, zs, side_valid, cols, rows, ok, scol, srow, d, n, k, height,
        width);
  }
  return (int)cudaGetLastError();
}

// samp, ok (n, k, height, width): K3c's samples and mask; side_valid (n,
// k) bytes; frame (n, height, width): the main frames; weight: the vote
// weights (n, k, height, width), or NULL for none. Writes num and den (n,
// height, width). Four pixels a thread when the width is a multiple of 4
// and the planes are aligned for it, else one.
MR_EXPORT int mr_sweep_cost(const float* samp, const unsigned char* ok,
                            const unsigned char* side_valid,
                            const float* frame, const float* weight,
                            float* num, float* den, int n, int k, int height,
                            int width, void* stream) {
  if (!shape_ok(n, k, height, width) || height > 65535 * kRows) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const bool vec = width % 4 == 0 && aligned(ok, 4) && aligned(samp, 16) &&
                   aligned(frame, 16) && aligned(weight, 16) &&
                   aligned(num, 16) && aligned(den, 16);
  const dim3 block(kCols, kRows);
  const int span = kCols / 4 * (vec ? 4 : 1);  // columns a CTA
  const dim3 grid((width + span - 1) / span, (height + kRows - 1) / kRows,
                  n);
  cudaStream_t s = (cudaStream_t)stream;
  const bool w = weight != nullptr;
#define MR_COST(W, PIX)                                                     \
  sweep_cost_kernel<W, PIX><<<grid, block, k, s>>>(                         \
      samp, ok, side_valid, frame, weight, num, den, k, height, width)
  if (w && vec) {
    MR_COST(true, 4);
  } else if (w) {
    MR_COST(true, 1);
  } else if (vec) {
    MR_COST(false, 4);
  } else {
    MR_COST(false, 1);
  }
#undef MR_COST
  return (int)cudaGetLastError();
}

// num, den (n, height, width): plane d's evidence, summed over the whole
// window; zs (D, n). Updates in place the running best: state (6, n,
// height, width) floats, the best cost, the cost before and after it, the
// last cost, the best plane's depth and the support; pending (n, height,
// width) bytes, whether the last plane was the best.
MR_EXPORT int mr_sweep_best(const float* num, const float* den,
                            const float* zs, float* state,
                            unsigned char* pending, int d, int n, int height,
                            int width, void* stream) {
  if (!shape_ok(n, 0, height, width) || d < 0 || height > 65535 * kRows) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  sweep_best_kernel<<<pixel_grid(height, width, 1, n), dim3(kCols, kRows), 0,
                      (cudaStream_t)stream>>>(num, den, zs, state, pending, d,
                                              n, height, width);
  return (int)cudaGetLastError();
}
