// K4 and K6: Horn-Schunck relaxation, several sweeps a launch, temporally
// blocked in shared memory.
//
// K4 replaces meshrecon/flow/pallas_jacobi.py::_fused_sweep_kernel (launched
// by hs_level_fused). It derives the linearization at each pixel from
// (prev, warped, u0, v0): Ix, Iy (edge-clamped central differences of the
// temporal average), cc = (b - a) - Ix*u0 - Iy*v0 and 1/(alpha^2 + Ix^2 +
// Iy^2), then runs the sweeps
//     ubar = 8-neighbour average of u (4-neighbours 1/6, diagonals 1/12)
//     num  = (Ix*ubar + Iy*vbar + cc) * (1/denom)
//     u'   = a_k * (ubar - Ix*num) + b_k * u_prev
// with (a_k, b_k) of one global Chebyshev schedule computed on the host in
// double and rounded to float (a_k = 1, b_k = 0 gives plain Jacobi). Plain
// version: meshrecon_torch.flow.variational._hs_sweeps_cheb / _hs_sweeps.
// K6 replaces meshrecon/flow/pallas_jacobi.py::_sweep_kernel (launched by
// hs_jacobi, the fixed-point reference of the multigrid solver): plain
// Jacobi sweeps given (Ix, Iy, c), c = It - Ix*u0 - Iy*v0; it forms 1/denom
// itself. Plain version: meshrecon_torch.flow.jacobi.hs_jacobi_plain.
//
// What bounds it. One sweep moves ~10 floats a pixel through device memory
// for ~33 operations, so a launch a sweep runs at HBM speed, ~35x over the
// bound (each input read once and each output written once a call). Here
// one launch runs S <= kMaxSweeps sweeps on chip, and the instruction
// rate bounds it: ~55 instructions a pixel and sweep (the four divisions of
// the two averages, 4 each, are a third of it), times the halo computed
// again by neighbouring CTAs (at 640x480 and S = 14, ~2x the pixels), at
// 20 warps an SM (the fields' registers allow one CTA an SM).
//
// Design. As the TPU kernel keeps a band and a halo of `iters` rows in
// VMEM, a CTA computes a tile of one image from a region of kRows x kCols
// pixels that holds the tile and a halo of S on each side, clipped to the
// image (shifted inward at its edges, so that every thread has a pixel).
// After sweep k the values are exact at distance >= k from the region's
// unclipped edges, so after S sweeps the tile is exact. Rows closer to an
// unclipped edge than the sweep number are skipped (the shrinking halo: a
// warp's row is uniform, so a skipped row costs no instruction slot).
//   - Shared memory holds only u and v, the fields read at neighbours, as
//     (u, v) pairs (one 64-bit access for both) in two buffers: a sweep
//     reads one and writes the other, which holds the iterate before
//     (Chebyshev's u_prev, read at the pixel itself before it is
//     overwritten), so one __syncthreads() a sweep suffices. Each buffer
//     has a ring of pad cells; at the image's edges the pads hold the
//     clamp's copies (rewritten after each sweep), so the sweep reads its
//     nine neighbours at fixed offsets, with no clamping.
//   - Registers hold the own-pixel fields (Ix, Iy, cc, 1/denom) of the
//     kRowsPer pixels of each thread's vertical strip, and a sliding 3x3
//     window of (u, v) down the strip: 3 shared loads a pixel, not 9.
//   - The region arrives by asynchronous copies (cp.async), a thread its
//     column, so no load waits on a shared store.
//   - The per-sweep (a_k, b_k) arrive by value in the launch's arguments.
//   - K4 derives the fields in every launch from (a, b, u0, v0); K6 reads
//     (Ix, Iy, c) in every launch. For iters > S the state (u, v, u_prev,
//     v_prev) crosses launches through device memory and the global
//     schedule continues unrestarted (the TPU kernel restarts it per chunk).
// Every operation is the one-sweep kernel's, in its order (-fmad=false), so
// S sweeps a launch give the bits of S launches of one sweep; its divisions
// by 6 and 12 skip IEEE division's range check and branch (div_const) and
// give its bits wherever the quotient is not subnormal.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kCols = 128;                 // region columns: a thread each
constexpr int kStrips = 5;                 // threads down a column
constexpr int kRowsPer = 12;               // rows of a thread's strip
constexpr int kRows = kStrips * kRowsPer;  // region rows
constexpr int kThreads = kCols * kStrips;
constexpr int kMaxSweeps = 24;
// a shared buffer: (u, v) pairs over the region and a ring of one pad
// cell, row-major
constexpr int kStride = kCols + 2;
constexpr int kCells = (kRows + 2) * kStride;
constexpr int kSmemBytes = 2 * kCells * (int)sizeof(float2);

struct Schedule {
  float a[kMaxSweeps];
  float b[kMaxSweeps];
};

// All (n, height, width) float32. K4 reads a, b, u0, v0; K6 ix, iy, cc.
// up/vp (the iterate before u, v) may be null only where every b_k is 0
// and up_out/vp_out are null, as on the last launch.
struct Planes {
  const float* a;
  const float* b;
  const float* u0;
  const float* v0;
  const float* ix;
  const float* iy;
  const float* cc;
  const float* u;
  const float* v;
  const float* up;
  const float* vp;
  float* u_out;
  float* v_out;
  float* up_out;
  float* vp_out;
};

// The tile's length along an axis of n pixels for a region of at most
// `ext` pixels and a halo of `halo`.
__host__ __device__ inline int tile_len(int n, int ext, int halo) {
  return n <= ext ? n : ext - 2 * halo;
}

// Tile [t0, t1) and region [start, start + len) of block `i` along an axis.
struct Span {
  int start, len, t0, t1;
};

__device__ __forceinline__ Span span(int i, int n, int ext, int halo) {
  Span s;
  s.len = min(ext, n);
  const int tile = tile_len(n, ext, halo);
  s.t0 = i * tile;
  s.t1 = min(s.t0 + tile, n);
  s.start = min(max(s.t0 - halo, 0), n - s.len);
  return s;
}

// Copies column tx of plane `src` (the image at `img`) over the thread's
// rows of the region into component `dst` (.x or .y of the shared cells),
// with the pad cells that the thread stands beside: the row above the
// region (the first strip), the row below it (the strip with the last
// row), and the column left or right of it (the first and last threads).
// Pads take the edge-clamped image, so an image edge's pad is the clamp's
// copy of the edge. The copies are asynchronous; the caller commits and
// waits.
__device__ __forceinline__ void load_plane(float* dst, const float* src,
                                           long long img, const Span& sx,
                                           const Span& sy, int height,
                                           int width, int tx, int row0) {
  if (tx >= sx.len) return;
  const float* col = src + img + sx.start + tx;
  const int left = max(sx.start - 1, 0) - (sx.start + tx);
  const int right = min(sx.start + sx.len, width - 1) - (sx.start + tx);
  const bool pad_l = tx == 0, pad_r = tx == sx.len - 1;
  float* d = dst + 2 * ((row0 + 1) * kStride + tx + 1);
#pragma unroll
  for (int i = -1; i <= kRowsPer; ++i) {
    const int r = row0 + i;  // region row; -1 and sy.len are pads
    const bool own = i >= 0 && i < kRowsPer && r < sy.len;
    if (own || (i == -1 && row0 == 0) || (i >= 1 && r == sy.len)) {
      const int g = min(max(sy.start + r, 0), height - 1);
      const float* s = col + (long long)g * width;
      float* t = d + 2 * i * kStride;
      __pipeline_memcpy_async(t, s, sizeof(float));
      if (pad_l) __pipeline_memcpy_async(t - 2, s + left, sizeof(float));
      if (pad_r) __pipeline_memcpy_async(t + 2, s + right, sizeof(float));
    }
  }
}

// x / d, rounded to nearest, for d = 6 and 12 (r = 1/d rounded), without
// the IEEE division's range check and branch: q = x * r, the exact
// residual x - q*d, one correction (Markstein's sequence); zeros keep
// their sign. It equals x / d for every float x whose quotient is not
// subnormal and x not infinite: all 2^32 floats are checked on the card
// (mr_hs_divide, tests/test_torch_kernels_cuda.py).
__device__ __forceinline__ float div_const(float x, float d, float r) {
  const float q = __fmul_rn(x, r);
  const float e = __fmaf_rn(-q, d, x);
  return copysignf(__fmaf_rn(e, r, q), x);
}

// variational._hs_average's s4 / 6 + s8 / 12
__device__ __forceinline__ float hs_mix(float s4, float s8) {
  return div_const(s4, 6.0f, 1.0f / 6.0f) +
         div_const(s8, 12.0f, 1.0f / 12.0f);
}

__global__ void hs_divide_kernel(const float* __restrict__ x,
                                 float* __restrict__ q6,
                                 float* __restrict__ q12, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  q6[i] = div_const(x[i], 6.0f, 1.0f / 6.0f);
  q12[i] = div_const(x[i], 12.0f, 1.0f / 12.0f);
}

// One sweep of a thread's strip: rows lo <= i < hi (of its kRowsPer) from
// the (u, v) cells at cu into those at nu, both at the strip's first
// pixel. kPrev: b_k != 0, so the iterate before (at nu) enters.
template <bool kPrev>
__device__ __forceinline__ void sweep_strip(
    const float2* cu, float2* nu, const float (&fx)[kRowsPer],
    const float (&fy)[kRowsPer], const float (&fc)[kRowsPer],
    const float (&fd)[kRowsPer], float ak, float bk, int lo, int hi) {
  // the window: rows i - 1, i, i + 1 at columns tx - 1, tx, tx + 1
  float2 t0 = cu[-kStride - 1], t1 = cu[-kStride], t2 = cu[1 - kStride];
  float2 m0 = cu[-1], m1 = cu[0], m2 = cu[1];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int o = i * kStride;
    const float2 b0 = cu[o + kStride - 1], b1 = cu[o + kStride],
                 b2 = cu[o + kStride + 1];
    if (i >= lo && i < hi) {
      // variational._hs_average in the plain version's order
      const float ua = hs_mix(t1.x + b1.x + m0.x + m2.x,
                              t0.x + t2.x + b0.x + b2.x);
      const float va = hs_mix(t1.y + b1.y + m0.y + m2.y,
                              t0.y + t2.y + b0.y + b2.y);
      const float num = (fx[i] * ua + fy[i] * va + fc[i]) * fd[i];
      float un = ua - fx[i] * num;
      float vn = va - fy[i] * num;
      if (kPrev) {
        const float2 before = nu[o];
        un = ak * un + bk * before.x;
        vn = ak * vn + bk * before.y;
      } else {
        un = ak * un;
        vn = ak * vn;
      }
      nu[o] = make_float2(un, vn);
    }
    t0 = m0; t1 = m1; t2 = m2;
    m0 = b0; m1 = b1; m2 = b2;
  }
}

enum Mode { kDerive = 0, kFields = 1 };

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
hs_block_kernel(Planes p, Schedule sched, int sweeps, float alpha2,
                int height, int width) {
  extern __shared__ float2 smem[];
  const Span sx = span(blockIdx.x, width, kCols, sweeps);
  const Span sy = span(blockIdx.y, height, kRows, sweeps);
  const int rw = sx.len, rh = sy.len;
  const int tx = threadIdx.x;
  const int row0 = threadIdx.y * kRowsPer;
  const bool col_ok = tx < rw;
  const long long img = (long long)blockIdx.z * height * width;
  // pixel (row0 + i, tx) of the region: global base + (row0 + i) * width,
  // shared own0 + i * kStride
  const long long base = img + (long long)sy.start * width + sx.start + tx;
  const int own0 = (row0 + 1) * kStride + tx + 1;
  float2* buf0 = smem;           // (u, v) cells
  float2* buf1 = smem + kCells;  // the other buffer

  if (kMode == kDerive) {  // (a, b) into buf1
    load_plane(&buf1->x, p.a, img, sx, sy, height, width, tx, row0);
    load_plane(&buf1->y, p.b, img, sx, sy, height, width, tx, row0);
  }
  load_plane(&buf0->x, p.u, img, sx, sy, height, width, tx, row0);
  load_plane(&buf0->y, p.v, img, sx, sy, height, width, tx, row0);
  __pipeline_commit();

  float fx[kRowsPer], fy[kRowsPer], fc[kRowsPer], fd[kRowsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) fx[i] = fy[i] = fc[i] = fd[i] = 0.0f;
  if (kMode == kDerive) {
    float u0r[kRowsPer], v0r[kRowsPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int r = row0 + i;
      const long long g = base + (long long)r * width;
      u0r[i] = col_ok && r < rh ? p.u0[g] : 0.0f;
      v0r[i] = col_ok && r < rh ? p.v0[g] : 0.0f;
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    // Ix, Iy: central differences of m = (a + b) / 2, each m formed at
    // its pixel as the one-sweep kernel did
    const float2* ab = buf1 + own0;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int o = i * kStride;
      const float2 r = ab[o + 1], l = ab[o - 1];
      const float2 dn = ab[o + kStride], up = ab[o - kStride], c = ab[o];
      const float m_r = 0.5f * (r.x + r.y), m_l = 0.5f * (l.x + l.y);
      const float m_d = 0.5f * (dn.x + dn.y), m_u = 0.5f * (up.x + up.y);
      fx[i] = (m_r - m_l) * 0.5f;
      fy[i] = (m_d - m_u) * 0.5f;
      fc[i] = (c.y - c.x) - fx[i] * u0r[i] - fy[i] * v0r[i];
      fd[i] = 1.0f / (alpha2 + fx[i] * fx[i] + fy[i] * fy[i]);
    }
    __syncthreads();  // buf1 holds the state from here
  } else {
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int r = row0 + i;
      if (col_ok && r < rh) {
        const long long g = base + (long long)r * width;
        fx[i] = p.ix[g];
        fy[i] = p.iy[g];
        fc[i] = p.cc[g];
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      fd[i] = 1.0f / (alpha2 + fx[i] * fx[i] + fy[i] * fy[i]);
    }
  }
  if (p.up != nullptr) {
    load_plane(&buf1->x, p.up, img, sx, sy, height, width, tx, row0);
    load_plane(&buf1->y, p.vp, img, sx, sy, height, width, tx, row0);
    __pipeline_commit();
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // rows this close to an unclipped region edge hold no exact value after
  // the sweep: skipped. The pads of the image's own edges are rewritten
  // after each sweep with the clamp's copies.
  const int cut_top = sy.start > 0 ? 1 : 0;
  const int cut_bot = sy.start + rh < height ? 1 : 0;
  const bool pad_l = col_ok && tx == 0 && sx.start == 0;
  const bool pad_r = col_ok && tx == rw - 1 && sx.start + rw == width;
  const bool pad_t = col_ok && row0 == 0 && !cut_top;
  const int last = rh - 1 - row0;  // the strip's index of the last row
  const bool pad_b = col_ok && !cut_bot && last >= 0 && last < kRowsPer;
  for (int k = 0; k < sweeps; ++k) {
    const float ak = sched.a[k], bk = sched.b[k];
    const float2* cu = ((k & 1) ? buf1 : buf0) + own0;
    float2* nu = ((k & 1) ? buf0 : buf1) + own0;
    const int lo = cut_top * (k + 1) - row0;
    const int hi = rh - cut_bot * (k + 1) - row0;
    if (col_ok) {
      if (bk != 0.0f) {
        sweep_strip<true>(cu, nu, fx, fy, fc, fd, ak, bk, lo, hi);
      } else {
        sweep_strip<false>(cu, nu, fx, fy, fc, fd, ak, bk, lo, hi);
      }
      // the image edges' pads: columns, then rows (corners from the
      // column pads just written by this thread)
      if (pad_l || pad_r) {
        const int side = pad_l ? -1 : 1;
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
          if (i < rh - row0) nu[i * kStride + side] = nu[i * kStride];
        }
      }
      for (int q = 0; q < 2; ++q) {
        const bool on = q == 0 ? pad_t : pad_b;
        if (!on) continue;
        const int o = q == 0 ? 0 : last * kStride;
        const int to = q == 0 ? -kStride : kStride;
        nu[o + to] = nu[o];
        if (pad_l) nu[o + to - 1] = nu[o];
        if (pad_r) nu[o + to + 1] = nu[o];
      }
    }
    __syncthreads();
  }

  // the tile: the last iterate and the one before
  const float2* now = ((sweeps & 1) ? buf1 : buf0) + own0;
  const float2* before = ((sweeps & 1) ? buf0 : buf1) + own0;
  const int c = sx.start + tx;
  if (!col_ok || c < sx.t0 || c >= sx.t1) return;
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = row0 + i;
    const int gr = sy.start + r;
    if (r < rh && gr >= sy.t0 && gr < sy.t1) {
      const long long g = base + (long long)r * width;
      const float2 uv = now[i * kStride];
      p.u_out[g] = uv.x;
      p.v_out[g] = uv.y;
      if (p.up_out != nullptr) {
        const float2 bv = before[i * kStride];
        p.up_out[g] = bv.x;
        p.vp_out[g] = bv.y;
      }
    }
  }
}

// (tile width, tile height, dynamic shared bytes, CTAs an image) of a
// launch of `sweeps` sweeps
void block_shape(int sweeps, int height, int width, int* out) {
  const int tw = tile_len(width, kCols, sweeps);
  const int th = tile_len(height, kRows, sweeps);
  out[0] = tw;
  out[1] = th;
  out[2] = kSmemBytes;
  out[3] = ((width + tw - 1) / tw) * ((height + th - 1) / th);
}

// Raises the kernel's dynamic shared memory limit once per device.
template <int kMode>
cudaError_t allow_shared() {
  static unsigned long long done = 0;  // a bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(hs_block_kernel<kMode>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e == cudaSuccess) done |= bit;
  return e;
}

bool aliases(const Planes& p) {
  const float* ins[] = {p.a, p.b, p.u0, p.v0, p.ix, p.iy,
                        p.cc, p.u, p.v, p.up, p.vp};
  const float* outs[] = {p.u_out, p.v_out, p.up_out, p.vp_out};
  for (int i = 0; i < 4; ++i) {
    if (outs[i] == nullptr) continue;
    for (const float* in : ins) {
      if (in == outs[i]) return true;
    }
    for (int j = 0; j < i; ++j) {
      if (outs[j] == outs[i]) return true;
    }
  }
  return false;
}

// coeffs: host (a_0, b_0, a_1, b_1, ...), `sweeps` pairs; null: Jacobi.
template <int kMode>
int launch(const Planes& p, const float* coeffs, int sweeps, float alpha2,
           int n, int height, int width, void* stream) {
  if ((long long)n * height * width == 0) return 0;
  if (sweeps < 1 || sweeps > kMaxSweeps || p.u_out == nullptr ||
      p.v_out == nullptr || (p.up == nullptr) != (p.vp == nullptr) ||
      (p.up_out == nullptr) != (p.vp_out == nullptr) || aliases(p)) {
    return (int)cudaErrorInvalidValue;
  }
  Schedule sched;
  bool reads_prev = p.up_out != nullptr;
  for (int k = 0; k < kMaxSweeps; ++k) {
    const bool in = k < sweeps;
    sched.a[k] = in ? (coeffs ? coeffs[2 * k] : 1.0f) : 0.0f;
    sched.b[k] = in && coeffs ? coeffs[2 * k + 1] : 0.0f;
    reads_prev = reads_prev || sched.b[k] != 0.0f;
  }
  if (reads_prev && p.up == nullptr) return (int)cudaErrorInvalidValue;
  // the iterate before is read at sweep 0 only where b_0 != 0, and handed
  // on unread from a launch of one sweep; otherwise it is not loaded
  Planes q = p;
  if (!(sched.b[0] != 0.0f || (sweeps == 1 && p.up_out != nullptr))) {
    q.up = q.vp = nullptr;
  }
  const cudaError_t e = allow_shared<kMode>();
  if (e != cudaSuccess) return (int)e;
  int shape[4];
  block_shape(sweeps, height, width, shape);
  const dim3 grid((width + shape[0] - 1) / shape[0],
                  (height + shape[1] - 1) / shape[1], n);
  hs_block_kernel<kMode><<<grid, dim3(kCols, kStrips), shape[2],
                           (cudaStream_t)stream>>>(q, sched, sweeps, alpha2,
                                                   height, width);
  return (int)cudaGetLastError();
}

}  // namespace

// K4: `sweeps` sweeps of the system linearized at (u0, v0) from the state
// (u, v, up, vp); all (n, height, width). coeffs: host (a_k, b_k) pairs of
// this launch's part of the schedule. up_out/vp_out null: the last launch,
// or plain Jacobi, whose state is (u, v) alone and whose up/vp may be null
// too. No output may alias an input.
MR_EXPORT int mr_hs_sweep(const float* a, const float* b, const float* u0,
                          const float* v0, const float* u, const float* v,
                          const float* up, const float* vp, float* u_out,
                          float* v_out, float* up_out, float* vp_out,
                          const float* coeffs, int sweeps, float alpha2,
                          int n, int height, int width, void* stream) {
  const Planes p = {a,       b,     u0,     v0,     nullptr,
                    nullptr, nullptr, u,    v,      up,
                    vp,      u_out, v_out, up_out, vp_out};
  return launch<kDerive>(p, coeffs, sweeps, alpha2, n, height, width, stream);
}

// K6: `sweeps` plain Jacobi sweeps given (ix, iy, cc) from (u, v); all
// (n, height, width). Outputs never alias inputs.
MR_EXPORT int mr_hs_jacobi_fields(const float* ix, const float* iy,
                                  const float* cc, const float* u,
                                  const float* v, float* u_out, float* v_out,
                                  int sweeps, float alpha2, int n,
                                  int height, int width, void* stream) {
  const Planes p = {nullptr, nullptr, nullptr, nullptr, ix,
                    iy,      cc,      u,       v,       nullptr,
                    nullptr, u_out,   v_out,   nullptr, nullptr};
  return launch<kFields>(p, nullptr, sweeps, alpha2, n, height, width,
                         stream);
}

// The launch geometry of `sweeps` sweeps a launch: out[0..3] = tile width,
// tile height, dynamic shared bytes a CTA, CTAs an image.
MR_EXPORT int mr_hs_block_shape(int sweeps, int height, int width,
                                int* out) {
  if (sweeps < 1 || sweeps > kMaxSweeps || height < 1 || width < 1) {
    return (int)cudaErrorInvalidValue;
  }
  block_shape(sweeps, height, width, out);
  return 0;
}

// The kernel's divisions by 6 and 12 (div_const) of n floats, for the
// check against IEEE division.
MR_EXPORT int mr_hs_divide(const float* x, float* q6, float* q12, int n,
                           void* stream) {
  if (n <= 0) return 0;
  hs_divide_kernel<<<mr_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
      x, q6, q12, n);
  return (int)cudaGetLastError();
}
