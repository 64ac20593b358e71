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
// What bounds them: not bytes (16 floats per listed record and tile at
// most, one float out per pixel) but the walk of each tile's list. A listed
// record is rarely near a given pixel: on a 16k-triangle sphere at 480x640
// only ~22% of the records a tile lists reach the tile's box, and a
// triangle covers ~10 pixels. The first design tested every listed record
// at every pixel of its tile: ~520 M per-pixel box tests and ~115 M
// coverage tests for 16 cameras.
//
// Design: one coverage walk (walk_records) for both kernels, which culls
// each record once per tile and once per warp, never per pixel:
// 1. Tile cull. 256 listed records a round, one a thread: the thread reads
//    the record's 4 box fields only and tests them against the tile's
//    sample extents. Survivors are compacted in list order (warp ballots)
//    and only they read their 12 other fields, into shared memory as 4
//    float4s a record (box; a0 b0 c0 a1; b1 c1 a2 b2; c2 z0 z1 z2),
//    structure of arrays, so that a lane's own record and a broadcast
//    record are each one conflict-free LDS.128. The next round's box is
//    loaded before the walk, its latency behind the walk.
// 2. Warp cull. Each warp owns an 8x4 footprint of the tile. A lane tests
//    one survivor's box against the footprint's sample extents, and the
//    ballot is the warp's list of those that reach it, walked in list
//    order: the record loop is warp-uniform, and only those records reach
//    the coverage test (33 M per-pixel tests instead of 115 M at 16k).
// Now the walk is instruction- and latency-bound: per round two barriers
// and two dependent L2 round trips (the fields, the next list entry), then
// the warps' passes. Measured on the card (PERF.md §6), and left out:
// an exact corner test of each edge per footprint cut the coverage tests
// by a further 28% (16k) but cost more in its own pass than it saved;
// 16x2 footprints; per-record masks of 4x4 squares walked by half-warps;
// the coverage loop unrolled by two; the fields and the next list entry
// loaded across the first barrier. Registers are capped at 40 (6 CTAs an
// SM; shared memory, 16.4 KB a CTA and 17.4 with K5's chunk list, would
// allow 8): at 32 the walk spills and was slower. The TPU's 4096-triangle
// slab split and its per-camera SMEM budget are gone: z-min does not
// depend on order, and the walk keeps list order anyway.
//
// K1's tile list holds chunk ids: every listed chunk's records are
// candidates. K5's holds superchunk ids (`supers` chunks each), so the list
// table is `supers` times smaller: per round its 256 threads each test one
// chunk of the listed superchunks against the tile, the chunks that hit
// are compacted in list order, and their records are the candidates.
//
// K1 renders a window of rows [row_lo, row_hi) into an (n_cams, row_hi -
// row_lo, width) buffer (a band of a tile group, sharding/tiles.py): CTAs
// run only for the tiles that meet the window, each tile at its global
// place with its global sample positions and list, so every pixel walks
// the same records in the same order as in the whole render and its depth
// is the same bits. A warp whose footprint misses the window skips its
// walk. The whole frame is the window [0, height).
//
// Arithmetic: l = a*px + b*py + c and z = l0*z0 + l1*z1 + l2*z2 use
// explicitly rounded multiplies and adds in the plain version's order, so
// no FMA contraction can flip an edge test at a silhouette.
#include "common.cuh"

namespace {

constexpr int kTile = 16;                 // tile edge in pixels
constexpr int kThreads = kTile * kTile;   // one pixel a thread
constexpr int kWarps = kThreads / 32;
constexpr int kFootW = 8, kFootH = 4;     // a warp's footprint in pixels
constexpr int kFootCols = kTile / kFootW;
static_assert(kFootW * kFootH == 32 && kFootCols * (kTile / kFootH) == kWarps,
              "the footprints tile the tile, one a warp");
constexpr int kBox = 12;  // packed field rows: a0 b0 c0 a1 b1 c1 a2 b2 c2
                          // z0 z1 z2, then the box xmin xmax ymin ymax
constexpr int kFields = 16;

__device__ __forceinline__ float affine(float a, float b, float c, float x,
                                        float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// Sample extents of a box of pixels: x_lo..x_hi, y_lo..y_hi in NDC.
struct Extent {
  float x_lo, x_hi, y_lo, y_hi;
};

__device__ __forceinline__ bool overlaps(const float4& box, const Extent& e) {
  return box.x <= e.x_hi && box.y >= e.x_lo && box.z <= e.y_hi &&
         box.w >= e.y_lo;
}

// Staged records of one round (tile survivors, list order).
struct Stage {
  float4 box[kThreads];  // xmin xmax ymin ymax
  float4 e0[kThreads];   // a0 b0 c0 a1
  float4 e1[kThreads];   // b1 c1 a2 b2
  float4 e2[kThreads];   // c2 z0 z1 z2
  int warp_hits[kWarps];
};

// The depth of staged record (e0, e1, e2) at sample (x, y) where it covers
// it, else +inf (which leaves a z-min as it is).
__device__ __forceinline__ float cover_z(const float4& e0, const float4& e1,
                                         const float4& e2, float x,
                                         float y) {
  const float l0 = affine(e0.x, e0.y, e0.z, x, y);
  const float l1 = affine(e0.w, e1.x, e1.y, x, y);
  const float l2 = affine(e1.z, e1.w, e2.x, x, y);
  const float zs = __fadd_rn(
      __fadd_rn(__fmul_rn(l0, e2.y), __fmul_rn(l1, e2.z)),
      __fmul_rn(l2, e2.w));
  return l0 >= 0.0f && l1 >= 0.0f && l2 >= 0.0f && zs >= -1.0f && zs <= 1.0f
             ? zs
             : INFINITY;
}

// The warp's pass over the first n staged records: cull per footprint,
// then the coverage test of each survivor at this lane's pixel.
__device__ __forceinline__ float walk_stage(const Stage& s, int n,
                                            const Extent& foot, float pxv,
                                            float pyv, int lane,
                                            float zbuf) {
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    unsigned todo =
        __ballot_sync(0xffffffffu, j < n && overlaps(s.box[j], foot));
    while (todo) {  // warp-uniform: the survivors in list order
      const int k = j0 + __ffs(todo) - 1;
      todo &= todo - 1u;
      zbuf = fminf(zbuf, cover_z(s.e0[k], s.e1[k], s.e2[k], pxv, pyv));
    }
  }
  return zbuf;
}

// What every thread of a CTA knows of its tile and its pixel.
struct Pixel {
  int tid, lane, warp, row, col;
  bool live;      // the warp's footprint has a pixel in the image
  float px, py;   // this pixel's sample position (clamped into the image)
  Extent tile;    // the tile's sample extents (tile_extents)
  Extent foot;    // the warp's footprint's sample extents
};

// ty: the tile's row of tiles; a footprint is live where it meets the
// image's columns and the window's rows [row_lo, row_hi).
__device__ __forceinline__ Pixel pixel_of(const float* __restrict__ px,
                                          const float* __restrict__ py,
                                          const float* __restrict__ tx0,
                                          const float* __restrict__ tx1,
                                          const float* __restrict__ ty0,
                                          const float* __restrict__ ty1,
                                          int height, int width, int ty,
                                          int row_lo, int row_hi) {
  Pixel p;
  p.tid = threadIdx.x;
  p.lane = p.tid & 31;
  p.warp = p.tid >> 5;
  const int c0 = blockIdx.x * kTile + (p.warp % kFootCols) * kFootW;
  const int r0 = ty * kTile + (p.warp / kFootCols) * kFootH;
  p.col = c0 + p.lane % kFootW;
  p.row = r0 + p.lane / kFootW;
  p.live = c0 < width && r0 < row_hi && r0 + kFootH > row_lo;
  p.px = px[min(p.col, width - 1)];
  p.py = py[min(p.row, height - 1)];
  p.tile = {tx0[blockIdx.x], tx1[blockIdx.x], ty0[ty], ty1[ty]};
  // px rises with the column and py falls with the row: the footprint's
  // extents are its first and last lanes' clamped samples
  p.foot = {__shfl_sync(0xffffffffu, p.px, 0),
            __shfl_sync(0xffffffffu, p.px, kFootW - 1),
            __shfl_sync(0xffffffffu, p.py, 31),
            __shfl_sync(0xffffffffu, p.py, 0)};
  return p;
}

__device__ __forceinline__ float4 load_box(const float* __restrict__ recs,
                                           int n_rec, long long t) {
  const float* r = recs + kBox * (long long)n_rec + t;
  return make_float4(r[0], r[n_rec], r[2 * (long long)n_rec],
                     r[3 * (long long)n_rec]);
}

// The coverage walk over n candidate records, in list order: candidate i
// is record i % kChunk of chunk chunk_at(i / kChunk). Returns this pixel's
// z-min folded into zbuf. Every thread of the CTA calls it with the same n.
template <int kChunk, class ChunkAt>
__device__ __forceinline__ float walk_records(Stage& s, int n,
                                              ChunkAt chunk_at,
                                              const float* __restrict__ recs,
                                              int n_rec, const Pixel& p,
                                              float zbuf) {
  long long t = 0;
  float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (p.tid < n) {
    t = (long long)chunk_at(p.tid / kChunk) * kChunk + p.tid % kChunk;
    box = load_box(recs, n_rec, t);
  }
  for (int base = 0; base < n; base += kThreads) {
    const bool hit = base + p.tid < n && overlaps(box, p.tile);
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (p.lane == 0) s.warp_hits[p.warp] = __popc(ballot);
    __syncthreads();  // the counts are in; the last round's stage is read
    int n_hit = 0, slot = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      slot += w < p.warp ? s.warp_hits[w] : 0;
      n_hit += s.warp_hits[w];
    }
    if (hit) {
      slot += __popc(ballot & ((1u << p.lane) - 1u));
      const float* r = recs + t;
      float f[kBox];
#pragma unroll
      for (int i = 0; i < kBox; ++i) f[i] = r[i * (long long)n_rec];
      s.box[slot] = box;
      s.e0[slot] = make_float4(f[0], f[1], f[2], f[3]);
      s.e1[slot] = make_float4(f[4], f[5], f[6], f[7]);
      s.e2[slot] = make_float4(f[8], f[9], f[10], f[11]);
    }
    const int next = base + kThreads + p.tid;
    if (next < n) {  // the next round's candidate, in flight over the walk
      t = (long long)chunk_at(next / kChunk) * kChunk + next % kChunk;
      box = load_box(recs, n_rec, t);
    }
    __syncthreads();  // the stage is written
    if (p.live) zbuf = walk_stage(s, n_hit, p.foot, p.px, p.py, p.lane, zbuf);
  }
  return zbuf;
}

// out holds rows [row_lo, row_hi) of each camera's render
__device__ __forceinline__ void store_depth(float* __restrict__ out,
                                            const Pixel& p, int width,
                                            int row_lo, int row_hi,
                                            float zbuf) {
  if (p.row >= row_lo && p.row < row_hi && p.col < width) {
    out[((long long)blockIdx.z * (row_hi - row_lo) + p.row - row_lo) *
            width + p.col] = isinf(zbuf) ? 1.0f : zbuf;
  }
}

// At most 40 registers a thread: 6 CTAs an SM (see the note at the top).
template <int kChunk>
__global__ void __launch_bounds__(kThreads, 6)
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
                    int nty, int row_lo, int row_hi) {
  __shared__ Stage s;
  const int ty = row_lo / kTile + blockIdx.y;  // the window's tiles only
  const Pixel p = pixel_of(px, py, tx0, tx1, ty0, ty1, height, width, ty,
                           row_lo, row_hi);
  const long long slot = ((long long)blockIdx.z * nty + ty) * ntx +
                         blockIdx.x;
  const int* list = lists + slot * n_chunks;
  const float* recs = packed + (long long)blockIdx.z * kFields * n_rec;
  const float zbuf = walk_records<kChunk>(
      s, counts[slot] * kChunk, [list](int i) { return list[i]; }, recs,
      n_rec, p, INFINITY);
  store_depth(out, p, width, row_lo, row_hi, zbuf);
}

template <int kChunk>
__global__ void __launch_bounds__(kThreads, 6)
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
  __shared__ Stage s;
  __shared__ int hits[kThreads];  // chunk ids that hit, in list order
  const Pixel p = pixel_of(px, py, tx0, tx1, ty0, ty1, height, width,
                           blockIdx.y, 0, height);
  const long long slot = ((long long)blockIdx.z * nty + blockIdx.y) * ntx +
                         blockIdx.x;
  const int count = counts[slot];
  const int* list = lists + slot * nsup;
  const float* recs = packed + (long long)blockIdx.z * kFields * n_rec;
  const int nch = nsup * supers;
  // chunk bbox unions: rows cxmin, cxmax, cymin, cymax of this camera
  const float* cb = cbox + (long long)blockIdx.z * 4 * nch;

  float zbuf = INFINITY;
  // candidates: the chunks of the listed superchunks, in list order
  const int n_cand = count * supers;
  for (int cbase = 0; cbase < n_cand; cbase += kThreads) {
    const int cand = cbase + p.tid;
    int c = 0;
    bool hit = false;
    if (cand < n_cand) {
      c = list[cand / supers] * supers + cand % supers;
      hit = overlaps(make_float4(cb[c], cb[nch + c], cb[2 * nch + c],
                                 cb[3 * nch + c]),
                     p.tile);
    }
    // the last round read hits[] and the counts before its last barrier
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (p.lane == 0) s.warp_hits[p.warp] = __popc(ballot);
    __syncthreads();
    int n_hit = 0, offset = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      offset += w < p.warp ? s.warp_hits[w] : 0;
      n_hit += s.warp_hits[w];
    }
    if (hit) hits[offset + __popc(ballot & ((1u << p.lane) - 1u))] = c;
    __syncthreads();
    zbuf = walk_records<kChunk>(
        s, n_hit * kChunk, [](int i) { return hits[i]; }, recs, n_rec,
        p, zbuf);
  }
  store_depth(out, p, width, 0, height, zbuf);
}

}  // namespace

// The chunk sizes the kernels take: one template instance each.
#define MR_CHUNK_SWITCH(KERNEL, ...)                                   \
  switch (chunk) {                                                     \
    case 8: KERNEL<8><<<grid, kThreads, 0, s>>>(__VA_ARGS__); break;   \
    case 16: KERNEL<16><<<grid, kThreads, 0, s>>>(__VA_ARGS__); break; \
    case 32: KERNEL<32><<<grid, kThreads, 0, s>>>(__VA_ARGS__); break; \
    case 64: KERNEL<64><<<grid, kThreads, 0, s>>>(__VA_ARGS__); break; \
    default: return (int)cudaErrorInvalidValue;                        \
  }

// packed (n_cams, 16, n_rec); lists (n_cams, nty*ntx, n_chunks);
// counts (n_cams, nty*ntx); px (width,); py (height,); tx0/tx1 (ntx,);
// ty0/ty1 (nty,); out (n_cams, row_hi - row_lo, width): rows [row_lo,
// row_hi) of each render, 0 <= row_lo < row_hi <= height. chunk in {8, 16,
// 32, 64}.
MR_EXPORT int mr_raster_tiles(const float* packed, const int* lists,
                              const int* counts, const float* px,
                              const float* py, const float* tx0,
                              const float* tx1, const float* ty0,
                              const float* ty1, float* out, int n_cams,
                              int n_rec, int n_chunks, int height, int width,
                              int tile, int chunk, int row_lo, int row_hi,
                              void* stream) {
  if (tile != kTile || (long long)n_rec != (long long)n_chunks * chunk ||
      row_lo < 0 || row_hi > height || row_lo >= row_hi) {
    return (int)cudaErrorInvalidValue;
  }
  const int ntx = (width + kTile - 1) / kTile;
  const int nty = (height + kTile - 1) / kTile;
  dim3 grid(ntx, (row_hi - 1) / kTile - row_lo / kTile + 1, n_cams);
  cudaStream_t s = (cudaStream_t)stream;
  MR_CHUNK_SWITCH(raster_tiles_kernel, packed, lists, counts, px, py, tx0,
                  tx1, ty0, ty1, out, n_rec, n_chunks, height, width, ntx,
                  nty, row_lo, row_hi)
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
  cudaStream_t s = (cudaStream_t)stream;
  MR_CHUNK_SWITCH(raster_tiles2_kernel, packed, cbox, lists, counts, px, py,
                  tx0, tx1, ty0, ty1, out, n_rec, nsup, supers, height,
                  width, ntx, nty)
  return (int)cudaGetLastError();
}
