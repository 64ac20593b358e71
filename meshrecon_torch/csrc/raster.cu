// K1: binned z-buffer depth render, one CTA per 16x16 screen tile.
//
// Replaces meshrecon/raster/binned.py::_raster_kernel (the Pallas kernel
// launched by _rasterize_slab / render_depth_binned). Same per-pixel
// contract as the plain meshrecon_torch.raster.rasterizer.render_depth:
// NDC depth, background 1.0, bit for bit.
//
// What bounds it here: the per-(pixel, triangle) coverage test, about 20
// flops for every listed triangle, so the work is the sum over tiles of
// the listed triangles times 256 pixels. Device-memory traffic is small
// (16 floats per listed triangle per tile, one float out per pixel).
//
// Design: the torch side (raster/binned.py) bins 8-triangle chunks onto
// tiles and hands each tile its sorted chunk list. A CTA walks its list in
// stages of 32 chunks: its 256 threads each copy one triangle's 16-float
// record into shared memory, then every thread tests its own pixel against
// all staged triangles (shared-memory broadcast reads, no bank conflicts)
// and keeps its own z-min in a register. A per-triangle bbox test against
// the tile is uniform across the CTA, so it skips triangles without
// divergence. Cameras ride gridDim.z, so one launch renders every camera
// of a batch; the TPU's 4096-triangle slab split (an SMEM limit) is gone,
// since z-min does not depend on order.
//
// Arithmetic: l = a*px + b*py + c and z = l0*z0 + l1*z1 + l2*z2 use
// explicitly rounded multiplies and adds in the plain version's order, so
// no FMA contraction can flip an edge test at a silhouette.
#include "common.cuh"

namespace {

constexpr int kTile = 16;          // tile edge in pixels (blockDim 16x16)
constexpr int kChunk = 8;          // triangles per binned chunk
constexpr int kStageChunks = 32;   // chunks staged per round: 256 records
constexpr int kFields = 16;        // a0 b0 c0 a1 b1 c1 a2 b2 c2 z0 z1 z2
                                   // xmin xmax ymin ymax

__device__ __forceinline__ float affine(float a, float b, float c, float x,
                                        float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__global__ void __launch_bounds__(kTile * kTile)
raster_tiles_kernel(const float* __restrict__ packed,
                    const int* __restrict__ lists,
                    const int* __restrict__ counts,
                    const float* __restrict__ px,
                    const float* __restrict__ py,
                    const float* __restrict__ tx0,
                    const float* __restrict__ tx1,
                    const float* __restrict__ ty0,
                    const float* __restrict__ ty1, float* __restrict__ out,
                    int n_rec, int n_chunks, int height, int width, int ntx,
                    int nty) {
  __shared__ float rec[kFields][kStageChunks * kChunk];

  const int cam = blockIdx.z;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int row = blockIdx.y * kTile + threadIdx.y;
  const int col = blockIdx.x * kTile + threadIdx.x;
  const float pxv = px[min(col, width - 1)];
  const float pyv = py[min(row, height - 1)];
  const float x_lo = tx0[blockIdx.x], x_hi = tx1[blockIdx.x];
  const float y_lo = ty0[blockIdx.y], y_hi = ty1[blockIdx.y];

  const long long slot = (long long)cam * ntx * nty + blockIdx.y * ntx +
                         blockIdx.x;
  const int count = counts[slot];
  const int* list = lists + slot * n_chunks;
  const float* recs = packed + (long long)cam * kFields * n_rec;

  float zbuf = INFINITY;
  for (int base = 0; base < count; base += kStageChunks) {
    const int n_stage = min(kStageChunks, count - base);
    __syncthreads();  // the previous stage is fully consumed
    const int chunk_slot = tid / kChunk;
    if (chunk_slot < n_stage) {
      const long long t =
          (long long)list[base + chunk_slot] * kChunk + tid % kChunk;
#pragma unroll
      for (int f = 0; f < kFields; ++f) rec[f][tid] = recs[f * (long long)n_rec + t];
    }
    __syncthreads();
    const int n_tri = n_stage * kChunk;
    for (int i = 0; i < n_tri; ++i) {
      if (rec[12][i] <= x_hi && rec[13][i] >= x_lo && rec[14][i] <= y_hi &&
          rec[15][i] >= y_lo) {
        const float l0 = affine(rec[0][i], rec[1][i], rec[2][i], pxv, pyv);
        const float l1 = affine(rec[3][i], rec[4][i], rec[5][i], pxv, pyv);
        const float l2 = affine(rec[6][i], rec[7][i], rec[8][i], pxv, pyv);
        const float zs = __fadd_rn(
            __fadd_rn(__fmul_rn(l0, rec[9][i]), __fmul_rn(l1, rec[10][i])),
            __fmul_rn(l2, rec[11][i]));
        if (l0 >= 0.0f && l1 >= 0.0f && l2 >= 0.0f && zs >= -1.0f &&
            zs <= 1.0f) {
          zbuf = fminf(zbuf, zs);
        }
      }
    }
  }
  if (row < height && col < width) {
    out[((long long)cam * height + row) * width + col] =
        isinf(zbuf) ? 1.0f : zbuf;
  }
}

}  // namespace

// packed (n_cams, 16, n_rec); lists (n_cams, nty*ntx, n_chunks);
// counts (n_cams, nty*ntx); px (width,); py (height,); tx0/tx1 (ntx,);
// ty0/ty1 (nty,); out (n_cams, height, width).
MR_EXPORT int mr_raster_tiles(const float* packed, const int* lists,
                              const int* counts, const float* px,
                              const float* py, const float* tx0,
                              const float* tx1, const float* ty0,
                              const float* ty1, float* out, int n_cams,
                              int n_rec, int n_chunks, int height, int width,
                              int tile, int chunk, void* stream) {
  if (tile != kTile || chunk != kChunk || n_rec != n_chunks * kChunk) {
    return (int)cudaErrorInvalidValue;
  }
  const int ntx = (width + kTile - 1) / kTile;
  const int nty = (height + kTile - 1) / kTile;
  dim3 grid(ntx, nty, n_cams);
  dim3 block(kTile, kTile);
  raster_tiles_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      packed, lists, counts, px, py, tx0, tx1, ty0, ty1, out, n_rec,
      n_chunks, height, width, ntx, nty);
  return (int)cudaGetLastError();
}
