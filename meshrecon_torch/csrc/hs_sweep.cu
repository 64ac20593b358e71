// K4: Horn-Schunck relaxation sweeps (Chebyshev or plain Jacobi), one
// thread per pixel, one launch per sweep. K6: the same sweeps given the
// linearization's fields.
//
// Replaces meshrecon/flow/pallas_jacobi.py::_fused_sweep_kernel (launched by
// hs_level_fused). Plain version: meshrecon_torch.flow.variational
// ._hs_sweeps_cheb / _hs_sweeps.
//
// The first launch derives the linearization at each pixel from (prev,
// warped, u0, v0): Ix, Iy (edge-clamped central differences of the temporal
// average), cc = (b - a) - Ix*u0 - Iy*v0 and 1/(alpha^2 + Ix^2 + Iy^2),
// stores those four fields, and runs the first sweep in the same pass, as
// the TPU kernel fuses setup and sweeps. Each later launch runs one sweep:
//     ubar = 8-neighbour average of u (4-neighbours 1/6, diagonals 1/12)
//     num  = (Ix*ubar + Iy*vbar + cc) / denom
//     u'   = a_k * (ubar - Ix*num) + b_k * u_prev
// with (a_k, b_k) of one global Chebyshev schedule computed on the host in
// double and rounded to float (a_k = 1, b_k = 0 gives plain Jacobi). The TPU
// kernel restarts its schedule per band chunk when iters > 24; this one
// never does.
//
// K6 replaces meshrecon/flow/pallas_jacobi.py::_sweep_kernel (launched by
// hs_jacobi, the fixed-point reference of the multigrid solver): plain
// Jacobi sweeps (a_k = 1, b_k = 0) given (Ix, Iy, c) with
// c = It - Ix*u0 - Iy*v0. Its first launch reads those three fields, writes
// 1/(alpha^2 + Ix^2 + Iy^2) and runs the first sweep; later launches are
// K4's. Plain version: meshrecon_torch.flow.jacobi.hs_jacobi_plain. The TPU
// kernel's row bands, halos, vertically stacked batches and roll-plus-
// select borders exist for VMEM and are not ported: each pixel clamps its
// own neighbour indices.
//
// What bounds it here: device-memory bandwidth, about 10 floats moved per
// pixel per sweep against ~30 flops. Neighbour reads of u, v hit L1/L2.
//
// Design: u' of a pixel depends only on its own u_prev, so the output may
// alias u_prev: the wrapper ping-pongs two buffers and never copies.
// Temporal blocking of several sweeps in shared memory is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Nbr {
  int up, down, left, right;  // clamped neighbour offsets within an image
};

__device__ __forceinline__ Nbr neighbours(int r, int c, int h, int w) {
  Nbr n;
  n.up = (r > 0 ? r - 1 : 0) * w;
  n.down = (r < h - 1 ? r + 1 : h - 1) * w;
  n.left = c > 0 ? c - 1 : 0;
  n.right = c < w - 1 ? c + 1 : w - 1;
  return n;
}

// variational._hs_average, edge-clamped, in the plain version's order
__device__ __forceinline__ float hs_average(const float* __restrict__ f,
                                            const Nbr& n, int r, int c,
                                            int w) {
  const int row = r * w;
  const float s4 = f[n.up + c] + f[n.down + c] + f[row + n.left] +
                   f[row + n.right];
  const float s8 = f[n.up + n.left] + f[n.up + n.right] +
                   f[n.down + n.left] + f[n.down + n.right];
  return s4 / 6.0f + s8 / 12.0f;
}

// kMode: kSweep reads the stored fields; kSetup derives them from (a, b,
// u0, v0) and stores all four; kSetupFields reads ix, iy, cc and stores
// invd.
enum Mode { kSweep = 0, kSetup = 1, kSetupFields = 2 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
hs_sweep_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ u0, const float* __restrict__ v0,
                float* ix_f, float* iy_f, float* cc_f, float* invd_f,
                const float* __restrict__ u_cur,
                const float* __restrict__ v_cur, const float* u_prev,
                const float* v_prev, float* u_out, float* v_out, float ak,
                float bk, float alpha2, long long total, int height,
                int width) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long plane = (long long)height * width;
  const long long base = (idx / plane) * plane;
  const int pix = (int)(idx - base);
  const int r = pix / width;
  const int c = pix - r * width;
  const Nbr n = neighbours(r, c, height, width);

  float ix, iy, cc, invd;
  if (kMode == kSetup) {
    const float* ai = a + base;
    const float* bi = b + base;
    const int row = r * width;
    const float m_r = 0.5f * (ai[row + n.right] + bi[row + n.right]);
    const float m_l = 0.5f * (ai[row + n.left] + bi[row + n.left]);
    const float m_d = 0.5f * (ai[n.down + c] + bi[n.down + c]);
    const float m_u = 0.5f * (ai[n.up + c] + bi[n.up + c]);
    ix = (m_r - m_l) * 0.5f;
    iy = (m_d - m_u) * 0.5f;
    cc = (b[idx] - a[idx]) - ix * u0[idx] - iy * v0[idx];
    invd = 1.0f / (alpha2 + ix * ix + iy * iy);
    ix_f[idx] = ix;
    iy_f[idx] = iy;
    cc_f[idx] = cc;
    invd_f[idx] = invd;
  } else if (kMode == kSetupFields) {
    ix = ix_f[idx];
    iy = iy_f[idx];
    cc = cc_f[idx];
    invd = 1.0f / (alpha2 + ix * ix + iy * iy);
    invd_f[idx] = invd;
  } else {
    ix = ix_f[idx];
    iy = iy_f[idx];
    cc = cc_f[idx];
    invd = invd_f[idx];
  }

  const float ua = hs_average(u_cur + base, n, r, c, width);
  const float va = hs_average(v_cur + base, n, r, c, width);
  const float num = (ix * ua + iy * va + cc) * invd;
  float un = ua - ix * num;
  float vn = va - iy * num;
  if (bk != 0.0f) {
    un = ak * un + bk * u_prev[idx];
    vn = ak * vn + bk * v_prev[idx];
  } else {
    un = ak * un;
    vn = ak * vn;
  }
  u_out[idx] = un;
  v_out[idx] = vn;
}

}  // namespace

// All fields (n, height, width). setup != 0: read a, b, u0, v0 and write
// ix, iy, cc, invd; otherwise read ix, iy, cc, invd. u_out/v_out may alias
// u_prev/v_prev, never u_cur/v_cur.
MR_EXPORT int mr_hs_sweep(const float* a, const float* b, const float* u0,
                          const float* v0, float* ix, float* iy, float* cc,
                          float* invd, const float* u_cur, const float* v_cur,
                          const float* u_prev, const float* v_prev,
                          float* u_out, float* v_out, float ak, float bk,
                          float alpha2, int setup, int n, int height,
                          int width, void* stream) {
  const long long total = (long long)n * height * width;
  if (total == 0) return 0;
  if (u_out == u_cur || v_out == v_cur) return (int)cudaErrorInvalidValue;
  const int blocks = mr_blocks(total, kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (setup) {
    hs_sweep_kernel<kSetup><<<blocks, kThreads, 0, s>>>(
        a, b, u0, v0, ix, iy, cc, invd, u_cur, v_cur, u_prev, v_prev, u_out,
        v_out, ak, bk, alpha2, total, height, width);
  } else {
    hs_sweep_kernel<kSweep><<<blocks, kThreads, 0, s>>>(
        a, b, u0, v0, ix, iy, cc, invd, u_cur, v_cur, u_prev, v_prev, u_out,
        v_out, ak, bk, alpha2, total, height, width);
  }
  return (int)cudaGetLastError();
}

// K6, one plain Jacobi sweep given the fields; all (n, height, width).
// setup != 0: read ix, iy, cc and write invd first; otherwise read all
// four. u_out/v_out never alias u_cur/v_cur.
MR_EXPORT int mr_hs_jacobi_fields(const float* ix, const float* iy,
                                  const float* cc, float* invd,
                                  const float* u_cur, const float* v_cur,
                                  float* u_out, float* v_out, float alpha2,
                                  int setup, int n, int height, int width,
                                  void* stream) {
  const long long total = (long long)n * height * width;
  if (total == 0) return 0;
  if (u_out == u_cur || v_out == v_cur) return (int)cudaErrorInvalidValue;
  const int blocks = mr_blocks(total, kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  // the fields are read-only here; the kernel's shared signature takes
  // them as writable for K4's setup
  float* fx = const_cast<float*>(ix);
  float* fy = const_cast<float*>(iy);
  float* fc = const_cast<float*>(cc);
  if (setup) {
    hs_sweep_kernel<kSetupFields><<<blocks, kThreads, 0, s>>>(
        nullptr, nullptr, nullptr, nullptr, fx, fy, fc, invd, u_cur, v_cur,
        u_cur, v_cur, u_out, v_out, 1.0f, 0.0f, alpha2, total, height,
        width);
  } else {
    hs_sweep_kernel<kSweep><<<blocks, kThreads, 0, s>>>(
        nullptr, nullptr, nullptr, nullptr, fx, fy, fc, invd, u_cur, v_cur,
        u_cur, v_cur, u_out, v_out, 1.0f, 0.0f, alpha2, total, height,
        width);
  }
  return (int)cudaGetLastError();
}
