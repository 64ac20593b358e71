// K1 and K5: binned z-buffer depth renders, one CTA per 16x16 screen tile.
//
// K1 (raster_tiles_kernel) replaces meshrecon/raster/binned.py::_raster_kernel
// (:119, launched by _rasterize_slab / render_depth_binned). K5
// (raster_tiles2_kernel) replaces both two-level kernels of that file,
// _raster_kernel2 (:242, one camera, render_depth_binned(two_level=True))
// and _raster_kernel2b (:259, cameras batched,
// render_depth_binned_batched): one kernel serves both, since cameras ride
// gridDim.z here. Same per-pixel contract as the plain
// meshrecon_torch.raster.rasterizer.render_depth: NDC depth, background
// 1.0, bit for bit.
//
// What bounds them here: the per-(pixel, triangle) coverage test, about 20
// flops for every triangle that reaches it, so the work is the sum over
// tiles of those triangles times 256 pixels. Device-memory traffic is small
// (16 floats per staged triangle per tile, one float out per pixel).
//
// Design: the binning (raster/binned.py::bin_soup: on the card the SETUP and
// BIN kernels of csrc/raster_setup.cu) bins chunks of `chunk` records (8,
// 16, 32 or 64; a template argument) onto tiles. A CTA stages 256
// records at a time into shared memory, one per thread, then every thread
// tests its own pixel against all staged triangles (shared-memory broadcast
// reads, no bank conflicts) and keeps its own z-min in a register. A
// per-triangle bbox test against the tile is uniform across the CTA, so it
// skips triangles without divergence. The TPU's 4096-triangle slab split
// and its per-camera SMEM budget (an SMEM limit) are gone, since z-min does
// not depend on order.
//
// K1's tile list holds chunk ids: every listed chunk is staged. K5's holds
// superchunk ids (`supers` chunks each), so the list table is `supers`
// times smaller. Per round its 256 threads each test one chunk of the
// listed superchunks (32 superchunks at supers = 8) against the tile, the
// chunks that hit are compacted in list order (warp ballots), and only
// those are staged. What the chunk skip saves over K1: the staging and the
// per-triangle bbox tests of chunks inside a listed superchunk's box but
// outside the tile; the coverage tests themselves are the same, because K1
// already skips by the triangle's box.
//
// Arithmetic: l = a*px + b*py + c and z = l0*z0 + l1*z1 + l2*z2 use
// explicitly rounded multiplies and adds in the plain version's order, so
// no FMA contraction can flip an edge test at a silhouette.
#include "common.cuh"

namespace {

constexpr int kTile = 16;                 // tile edge in pixels (blockDim)
constexpr int kThreads = kTile * kTile;   // records staged per round
constexpr int kWarps = kThreads / 32;
constexpr int kFields = 16;  // a0 b0 c0 a1 b1 c1 a2 b2 c2 z0 z1 z2
                             // xmin xmax ymin ymax

__device__ __forceinline__ float affine(float a, float b, float c, float x,
                                        float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// One thread copies record `tid % kChunk` of chunk `chunk_id` into column
// `tid` of the stage.
template <int kChunk>
__device__ __forceinline__ void stage_record(float (*rec)[kThreads],
                                             const float* __restrict__ recs,
                                             int n_rec, int chunk_id,
                                             int tid) {
  const long long t = (long long)chunk_id * kChunk + tid % kChunk;
#pragma unroll
  for (int f = 0; f < kFields; ++f) rec[f][tid] = recs[f * (long long)n_rec + t];
}

// z-min of this thread's pixel over the first n_tri staged records.
__device__ __forceinline__ float zmin_staged(const float (*rec)[kThreads],
                                             int n_tri, float pxv, float pyv,
                                             float x_lo, float x_hi,
                                             float y_lo, float y_hi,
                                             float zbuf) {
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
  return zbuf;
}

template <int kChunk>
__global__ void __launch_bounds__(kThreads)
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
  constexpr int kStageChunks = kThreads / kChunk;
  __shared__ float rec[kFields][kThreads];

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
    if (tid / kChunk < n_stage) {
      stage_record<kChunk>(rec, recs, n_rec, list[base + tid / kChunk], tid);
    }
    __syncthreads();
    zbuf = zmin_staged(rec, n_stage * kChunk, pxv, pyv, x_lo, x_hi, y_lo,
                       y_hi, zbuf);
  }
  if (row < height && col < width) {
    out[((long long)cam * height + row) * width + col] =
        isinf(zbuf) ? 1.0f : zbuf;
  }
}

template <int kChunk>
__global__ void __launch_bounds__(kThreads)
raster_tiles2_kernel(const float* __restrict__ packed,
                     const float* __restrict__ cbox,
                     const int* __restrict__ lists,
                     const int* __restrict__ counts,
                     const float* __restrict__ px,
                     const float* __restrict__ py,
                     const float* __restrict__ tx0,
                     const float* __restrict__ tx1,
                     const float* __restrict__ ty0,
                     const float* __restrict__ ty1, float* __restrict__ out,
                     int n_rec, int nsup, int supers, int height, int width,
                     int ntx, int nty) {
  constexpr int kStageChunks = kThreads / kChunk;
  __shared__ float rec[kFields][kThreads];
  __shared__ int hits[kThreads];      // chunk ids that hit, in list order
  __shared__ int warp_hits[kWarps];

  const int cam = blockIdx.z;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.y * kTile + threadIdx.y;
  const int col = blockIdx.x * kTile + threadIdx.x;
  const float pxv = px[min(col, width - 1)];
  const float pyv = py[min(row, height - 1)];
  const float x_lo = tx0[blockIdx.x], x_hi = tx1[blockIdx.x];
  const float y_lo = ty0[blockIdx.y], y_hi = ty1[blockIdx.y];

  const long long slot = (long long)cam * ntx * nty + blockIdx.y * ntx +
                         blockIdx.x;
  const int count = counts[slot];
  const int* list = lists + slot * nsup;
  const float* recs = packed + (long long)cam * kFields * n_rec;
  const int nch = nsup * supers;
  // chunk bbox unions: rows cxmin, cxmax, cymin, cymax of this camera
  const float* cb = cbox + (long long)cam * 4 * nch;

  float zbuf = INFINITY;
  // candidates: the chunks of the listed superchunks, in list order
  const int n_cand = count * supers;
  for (int cbase = 0; cbase < n_cand; cbase += kThreads) {
    const int cand = cbase + tid;
    int c = 0;
    bool hit = false;
    if (cand < n_cand) {
      c = list[cand / supers] * supers + cand % supers;
      hit = cb[c] <= x_hi && cb[nch + c] >= x_lo && cb[2 * nch + c] <= y_hi &&
            cb[3 * nch + c] >= y_lo;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    __syncthreads();  // the previous round's hits and records are consumed
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int n_hit = 0, offset = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      offset += w < warp ? warp_hits[w] : 0;
      n_hit += warp_hits[w];
    }
    if (hit) hits[offset + __popc(ballot & ((1u << lane) - 1u))] = c;
    __syncthreads();
    for (int h0 = 0; h0 < n_hit; h0 += kStageChunks) {
      const int n_stage = min(kStageChunks, n_hit - h0);
      if (h0 > 0) __syncthreads();  // the previous stage is fully consumed
      if (tid / kChunk < n_stage) {
        stage_record<kChunk>(rec, recs, n_rec, hits[h0 + tid / kChunk], tid);
      }
      __syncthreads();
      zbuf = zmin_staged(rec, n_stage * kChunk, pxv, pyv, x_lo, x_hi, y_lo,
                         y_hi, zbuf);
    }
  }
  if (row < height && col < width) {
    out[((long long)cam * height + row) * width + col] =
        isinf(zbuf) ? 1.0f : zbuf;
  }
}

}  // namespace

// The chunk sizes the kernels take: one template instance each.
#define MR_CHUNK_SWITCH(KERNEL, ...)                                   \
  switch (chunk) {                                                     \
    case 8: KERNEL<8><<<grid, block, 0, s>>>(__VA_ARGS__); break;      \
    case 16: KERNEL<16><<<grid, block, 0, s>>>(__VA_ARGS__); break;    \
    case 32: KERNEL<32><<<grid, block, 0, s>>>(__VA_ARGS__); break;    \
    case 64: KERNEL<64><<<grid, block, 0, s>>>(__VA_ARGS__); break;    \
    default: return (int)cudaErrorInvalidValue;                        \
  }

// packed (n_cams, 16, n_rec); lists (n_cams, nty*ntx, n_chunks);
// counts (n_cams, nty*ntx); px (width,); py (height,); tx0/tx1 (ntx,);
// ty0/ty1 (nty,); out (n_cams, height, width). chunk in {8, 16, 32, 64}.
MR_EXPORT int mr_raster_tiles(const float* packed, const int* lists,
                              const int* counts, const float* px,
                              const float* py, const float* tx0,
                              const float* tx1, const float* ty0,
                              const float* ty1, float* out, int n_cams,
                              int n_rec, int n_chunks, int height, int width,
                              int tile, int chunk, void* stream) {
  if (tile != kTile || (long long)n_rec != (long long)n_chunks * chunk) {
    return (int)cudaErrorInvalidValue;
  }
  const int ntx = (width + kTile - 1) / kTile;
  const int nty = (height + kTile - 1) / kTile;
  dim3 grid(ntx, nty, n_cams);
  dim3 block(kTile, kTile);
  cudaStream_t s = (cudaStream_t)stream;
  MR_CHUNK_SWITCH(raster_tiles_kernel, packed, lists, counts, px, py, tx0,
                  tx1, ty0, ty1, out, n_rec, n_chunks, height, width, ntx,
                  nty)
  return (int)cudaGetLastError();
}

// packed (n_cams, 16, n_rec); cbox (n_cams, 4, nsup*supers) chunk bbox
// unions (xmin, xmax, ymin, ymax); lists (n_cams, nty*ntx, nsup) superchunk
// ids; counts (n_cams, nty*ntx); px, py, tx0..ty1, out as for
// mr_raster_tiles. n_rec = nsup * supers * chunk, supers >= 1.
MR_EXPORT int mr_raster_tiles2(const float* packed, const float* cbox,
                               const int* lists, const int* counts,
                               const float* px, const float* py,
                               const float* tx0, const float* tx1,
                               const float* ty0, const float* ty1,
                               float* out, int n_cams, int n_rec, int nsup,
                               int height, int width, int tile, int chunk,
                               int supers, void* stream) {
  if (tile != kTile || supers < 1 || nsup < 0 ||
      (long long)n_rec != (long long)nsup * supers * chunk) {
    return (int)cudaErrorInvalidValue;
  }
  const int ntx = (width + kTile - 1) / kTile;
  const int nty = (height + kTile - 1) / kTile;
  dim3 grid(ntx, nty, n_cams);
  dim3 block(kTile, kTile);
  cudaStream_t s = (cudaStream_t)stream;
  MR_CHUNK_SWITCH(raster_tiles2_kernel, packed, cbox, lists, counts, px, py,
                  tx0, tx1, ty0, ty1, out, n_rec, nsup, supers, height,
                  width, ntx, nty)
  return (int)cudaGetLastError();
}
