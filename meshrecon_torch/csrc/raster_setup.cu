// The binning of K1 and K5 on the card: the triangle setup
// (mr_raster_setup) and the tile lists (mr_raster_bin) of
// meshrecon_torch/raster/binned.py::bin_soup.
//
// They replace the XLA code that feeds the TPU's raster kernels: the setup
// replaces meshrecon/raster/rasterizer.py:129 (clip_project_planes) and
// :241 (edge_affine_planes) with the records' bbox; the lists replace the
// dense (tiles x chunks) keys and their jnp.sort at
// meshrecon/raster/binned.py:597 (superchunks) and :612 (chunks). Their
// plain versions are binned.pack_records and binned.bin_chunks /
// bin_superchunks (torch ops), and they equal them bit for bit.
//
// SETUP (raster_setup_kernel): a thread a triangle, 128 a CTA, one camera
// a CTA. A thread repeats, operation for operation, clip_project_planes
// (the fixed association of the clip transform, the canonical rotation,
// the near-plane intersections, the safe_w divide, the area and ok),
// edge_affine_planes and coverage_bbox (float64, padded, clamped, rounded
// to float32 once) for the triangle's two records: slot 1 (record 2t) and
// slot 2 (2t+1: the second half of a triangle that straddles the near
// plane, else an invalid record whose fields are still computed, its edge
// terms carrying signs and its z fields projected). The clip transform,
// the rotation and the first vertex's projection serve both records, which
// are built one after the other and staged in shared memory as soon as
// each is done, so the thread holds one record at a time. The camera and
// the CTA's triangles are read once into shared memory; the records leave
// as float4 rows of the (16, n_rec) planes; a chunk's box reduces with
// shuffles over its chunk / 2 lanes. What bounds it: operations, not
// bytes. A triangle takes up to twenty-five IEEE float32 divisions, six
// square roots and twelve float64 divisions, in dependent chains; at 64
// registers (8 CTAs of 128 threads an SM, 40 bytes of stack) the launch
// runs at 48% of its bytes bound on 16k triangles and 55% on 65k (NVIDIA
// H100 80GB HBM3, 700 W; PERF.md). A thread a record, which repeats the
// clip transform, the rotation and the first projection in both threads,
// ran 11% slower, as did the other launch shapes tried (PERF.md §6).
//
// BIN (raster_bin_kernel): the tiles' lists without a sort. The groups (a
// group is a chunk for K1, a superchunk of `supers` chunks for K5) form
// runs of 32; a run's box is the union of its groups' boxes (the coarse
// level). The camera's tiles form blocks of 8 x 4 tiles, or 8 x 2 past
// 1,024 groups. The grid is persistent: a camera's `clusters` thread-block
// clusters (4 CTAs up to 4,096 chunks, else 8), as many as are resident at
// once, split its blocks (cluster c takes blocks c, c + clusters, ...), and
// a cluster's CTAs take its blocks from a counter in the first CTA's shared
// memory, each its first block statically. A round of up to 512 runs:
//   1. the cluster builds the coarse level once: each CTA an eighth (or a
//      quarter) of the runs, a lane a group (float4 loads of four chunk
//      boxes a plane when supers is 1), the unions stored into every CTA of
//      the cluster through distributed shared memory;
//   2. for each block it takes, a CTA keeps the runs whose union overlaps
//      the block's region (the union of its tiles) in ascending order
//      (ballots, a prefix over the warps), stages their group boxes in
//      shared memory 32 runs at a time, and a warp walks each of its tiles
//      over the staged runs whose union overlaps it, a lane a group, with
//      _tile_lists' four comparisons (branch-free); the hits are compacted
//      with __ballot_sync / __popc, so lists[slot, :count] holds the
//      ascending ids the plain version's sort gives. Entries past count are
//      not written; K1 and K5 never read them. A tile's count carries from
//      round to round through `counts`.
// What bounds it: latency, not bytes (0.6-2 us of reads and writes). CTAs
// that each read their camera's whole cbox from L2 would move 42-168 MB a
// launch; a cluster reads it once, and a CTA's time is a chain of short
// phases per block (the coarse level's barriers, staging from L2, the
// tiles' serial walks). 64 registers, no spills, ~31 KB of shared memory:
// 4 CTAs of 256 threads an SM, one wave. The block shape and cluster sizes
// were chosen on the card from variants timed against each other.
//
// Arithmetic: explicitly rounded float32 and float64 intrinsics in the plain
// version's order, IEEE division and square root, -fmad=false; Python
// scalars of the plain version are float32 operands (1e-6, 6.25e-5, 1e-12)
// or float64 ones inside coverage_bbox (1e-5, 1.0, 3e38).
#include <cooperative_groups.h>

#include <atomic>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kFields = 16;  // a0 b0 c0 a1 b1 c1 a2 b2 c2 z0 z1 z2
                             // xmin xmax ymin ymax
constexpr float kWEps = 1e-6f;      // rasterizer._W_EPS
constexpr float kSlop = 6.25e-5f;   // rasterizer.EDGE_TIE_SLOP
constexpr float kAreaEps = 1e-12f;  // the degenerate-area threshold
constexpr double kBig = 3e38;       // coverage_bbox's big
// float32 of 3e38, as torch converts the Python float (round to nearest)
constexpr float kBigF = static_cast<float>(kBig);

// SETUP
constexpr int kSetupTris = 128;    // triangles a CTA, a thread each
constexpr int kSetupMinBlocks = 8;  // resident CTAs an SM

// BIN
constexpr int kBinTx = 8;          // tiles a block row
constexpr int kBinTy = 4;          // block rows up to kSmallGroups groups
constexpr int kBinTyLarge = 2;     // block rows past them
constexpr int kSmallGroups = 1024;
constexpr int kRun = 32;           // groups a run: a lane each
constexpr int kRoundRuns = 512;    // runs a round (16,384 groups)
constexpr int kBatchRuns = 32;     // overlapping runs staged at once
constexpr int kBinWarps = 8;
constexpr int kBinMinBlocks = 4;   // resident CTAs an SM
constexpr int kBinCluster = 8;     // CTAs a cluster (at most 8: portable)
constexpr int kBinSmallCluster = 4;  // up to kSmallChunks chunks
constexpr int kSmallChunks = 4096;
constexpr int kMaxTileAxis = 256;  // tiles a row or column staged

struct Vtx {
  float x, y, z, w;
};

// clip component of point p by camera row m: ((p0*m0 + p1*m1) + p2*m2) + m3
__device__ __forceinline__ float clip_comp(const float* m, float p0, float p1,
                                           float p2) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p0, m[0]),
                                       __fmul_rn(p1, m[1])),
                             __fmul_rn(p2, m[2])),
                   m[3]);
}

__device__ __forceinline__ float lerp_w(float p, float q, float t) {
  return __fadd_rn(p, __fmul_rn(__fsub_rn(q, p), t));
}

// isect(p, q): the point of segment pq at clip w = _W_EPS
__device__ __forceinline__ Vtx isect(const Vtx& p, const Vtx& q) {
  const float t = __fdiv_rn(__fsub_rn(kWEps, p.w), __fsub_rn(q.w, p.w));
  return Vtx{lerp_w(p.x, q.x, t), lerp_w(p.y, q.y, t), lerp_w(p.z, q.z, t),
             lerp_w(p.w, q.w, t)};
}

__device__ __forceinline__ Vtx pick3(int k, const Vtx& a, const Vtx& b,
                                     const Vtx& c) {
  return k == 0 ? a : (k == 1 ? b : c);
}

// edge_coeffs of edge (a -> b): A, B, C with the tie slop baked into C
__device__ __forceinline__ void edge_coeffs(float ax, float ay, float bx,
                                            float by, float inv, float* e) {
  const float dx = __fsub_rn(bx, ax);
  const float dy = __fsub_rn(by, ay);
  const float a = __fmul_rn(-dy, inv);
  const float b = __fmul_rn(dx, inv);
  const float c = __fmul_rn(__fsub_rn(__fmul_rn(dy, ax), __fmul_rn(dx, ay)),
                            inv);
  e[0] = a;
  e[1] = b;
  e[2] = __fadd_rn(
      c, __fmul_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b))),
                   kSlop));
}

// coverage_bbox's corner of edge lines i and j (float64)
__device__ __forceinline__ void corner(const double* a, const double* b,
                                       const double* c, int i, int j,
                                       double* x, double* y) {
  const double det = __dsub_rn(__dmul_rn(a[i], b[j]), __dmul_rn(a[j], b[i]));
  *x = __ddiv_rn(__dsub_rn(__dmul_rn(b[i], c[j]), __dmul_rn(b[j], c[i])),
                 det);
  *y = __ddiv_rn(__dsub_rn(__dmul_rn(c[i], a[j]), __dmul_rn(c[j], a[i])),
                 det);
}

// coverage_bbox's padded(v, lo) of one side, edge = min (lo) or max of v
__device__ __forceinline__ float padded(double edge, bool lo, bool finite) {
  const double pad = __dmul_rn(1e-5, __dadd_rn(1.0, fabs(edge)));
  edge = lo ? __dsub_rn(edge, pad) : __dadd_rn(edge, pad);
  edge = finite ? edge : (lo ? -kBig : kBig);
  return __double2float_rn(fmin(fmax(edge, -kBig), kBig));
}

// screen(): the perspective divide by safe_w
__device__ __forceinline__ void project(const Vtx& v, float* x, float* y,
                                        float* z) {
  const float safe_w = fabsf(v.w) < kWEps ? kWEps : v.w;
  *x = __fdiv_rn(v.x, safe_w);
  *y = __fdiv_rn(v.y, safe_w);
  *z = __fdiv_rn(v.z, safe_w);
}

// One record of a screen triangle (v0, v1, v2 in clip space, v0 given
// projected: x0, y0, z0): the 16 fields of pack_records (screen(),
// edge_affine_planes, coverage_bbox).
__device__ __forceinline__ void make_record(float x0, float y0, float z0,
                                            const Vtx& v1, const Vtx& v2,
                                            bool valid, float* f) {
  float xs[3], ys[3];
  xs[0] = x0;
  ys[0] = y0;
  f[9] = z0;
  project(v1, &xs[1], &ys[1], &f[10]);
  project(v2, &xs[2], &ys[2], &f[11]);
  const float area = __fsub_rn(
      __fmul_rn(__fsub_rn(xs[1], xs[0]), __fsub_rn(ys[2], ys[0])),
      __fmul_rn(__fsub_rn(ys[1], ys[0]), __fsub_rn(xs[2], xs[0])));
  const bool ok = valid && fabsf(area) > kAreaEps;  // false for a NaN area
  const float inv = ok ? __fdiv_rn(1.0f, area) : 0.0f;
  edge_coeffs(xs[1], ys[1], xs[2], ys[2], inv, f);
  edge_coeffs(xs[2], ys[2], xs[0], ys[0], inv, f + 3);
  edge_coeffs(xs[0], ys[0], xs[1], ys[1], inv, f + 6);
  if (!ok) {  // covers nothing: (a0, b0, c0) = (0, 0, -1), the inverted box
    f[0] = 0.0f;
    f[1] = 0.0f;
    f[2] = -1.0f;
    f[12] = kBigF;
    f[13] = -kBigF;
    f[14] = kBigF;
    f[15] = -kBigF;
    return;
  }
  double a[3], b[3], c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a[i] = (double)f[3 * i];
    b[i] = (double)f[3 * i + 1];
    c[i] = (double)f[3 * i + 2];
  }
  double x[3], y[3];
  corner(a, b, c, 1, 2, &x[0], &y[0]);
  corner(a, b, c, 2, 0, &x[1], &y[1]);
  corner(a, b, c, 0, 1, &x[2], &y[2]);
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    finite = finite && isfinite(x[i]) && isfinite(y[i]);
  }
  f[12] = padded(fmin(fmin(x[0], x[1]), x[2]), true, finite);
  f[13] = padded(fmax(fmax(x[0], x[1]), x[2]), false, finite);
  f[14] = padded(fmin(fmin(y[0], y[1]), y[2]), true, finite);
  f[15] = padded(fmax(fmax(y[0], y[1]), y[2]), false, finite);
}

__device__ __forceinline__ void padding_record(float* f) {
#pragma unroll
  for (int i = 0; i < kFields; ++i) f[i] = 0.0f;
  f[2] = -1.0f;  // c0 = -1: no coverage
  f[12] = kBigF;
  f[13] = -kBigF;
  f[14] = kBigF;
  f[15] = -kBigF;
}

// boxes (xmin, xmax, ymin, ymax): their union
__device__ __forceinline__ float4 box_union(float4 a, const float4& b) {
  return make_float4(fminf(a.x, b.x), fmaxf(a.y, b.y), fminf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

// the union of the boxes of each aligned group of 2 * top lanes (top a
// power of two up to 16; the whole warp by default), in every lane
__device__ __forceinline__ float4 warp_union(float4 u, int top = 16) {
#pragma unroll
  for (int off = top; off > 0; off >>= 1) {
    u = box_union(u, make_float4(__shfl_xor_sync(0xffffffffu, u.x, off),
                                 __shfl_xor_sync(0xffffffffu, u.y, off),
                                 __shfl_xor_sync(0xffffffffu, u.z, off),
                                 __shfl_xor_sync(0xffffffffu, u.w, off)));
  }
  return u;
}

// the four comparisons of _tile_lists, combined without branches
// _tile_lists' four comparisons, combined without branches (short-circuit
// comparisons compile to branches and reconvergence in the walk's loop)
__device__ __forceinline__ bool overlaps(const float4& b, float x_lo,
                                         float x_hi, float y_lo, float y_hi) {
  return (b.x <= x_hi) & (b.y >= x_lo) & (b.z <= y_hi) & (b.w >= y_lo);
}

// group g's box: the union of its `supers` chunk boxes; past the groups,
// the empty box
__device__ __forceinline__ float4 group_box(const float* __restrict__ cb,
                                            int nch, int supers, int ngroups,
                                            int g) {
  float4 b = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
  if (g < ngroups) {
    const float* c = cb + (long long)g * supers;
    for (int s = 0; s < supers; ++s) {
      b = box_union(b, make_float4(__ldg(c + s), __ldg(c + nch + s),
                                   __ldg(c + 2LL * nch + s),
                                   __ldg(c + 3LL * nch + s)));
    }
  }
  return b;
}

// chunk boxes g .. g + 3 of the camera's planes `cb` (nch a row), one
// float4 load a plane (16-byte aligned rows, supers 1); past the groups,
// the empty box
__device__ __forceinline__ void quad_boxes(const float* __restrict__ cb,
                                           int nch, int ngroups, int g,
                                           float4* b) {
  if (g + 3 < ngroups) {
    const float4 x0 = __ldg(reinterpret_cast<const float4*>(cb + g));
    const float4 x1 = __ldg(reinterpret_cast<const float4*>(cb + nch + g));
    const float4 y0 =
        __ldg(reinterpret_cast<const float4*>(cb + 2LL * nch + g));
    const float4 y1 =
        __ldg(reinterpret_cast<const float4*>(cb + 3LL * nch + g));
    b[0] = make_float4(x0.x, x1.x, y0.x, y1.x);
    b[1] = make_float4(x0.y, x1.y, y0.y, y1.y);
    b[2] = make_float4(x0.z, x1.z, y0.z, y1.z);
    b[3] = make_float4(x0.w, x1.w, y0.w, y1.w);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) b[k] = group_box(cb, nch, 1, ngroups, g + k);
  }
}

__device__ __forceinline__ bool overlaps(const float4& b, const float4& t) {
  return overlaps(b, t.x, t.y, t.z, t.w);
}

struct BinArgs {
  const float* cbox;
  const float* tx0;
  const float* tx1;
  const float* ty0;
  const float* ty1;
  int* lists;
  int* counts;
  int nch, supers, ntx, nty, nbx, nblocks;
  int clusters;  // clusters a camera; cluster c takes blocks c, c + clusters..
};

// SETUP (the header above): a thread a triangle computes the clip
// transform, the rotation and A's projection once, then slot 1's record
// (2t) and slot 2's (2t+1) in turn, each staged in shared memory as soon
// as it is built; the rows leave as float4, and a chunk's box (chunk / 2
// triangles, as many neighbouring lanes) reduces with shuffles.
template <int kMinBlocks, int kTris = kSetupTris>
__global__ void __launch_bounds__(kTris, kMinBlocks)
raster_setup_kernel(const float* __restrict__ cameras,
                    const float* __restrict__ soup,
                    const unsigned char* __restrict__ soup_valid,
                    float* __restrict__ packed, float* __restrict__ cbox,
                    int n_tri, int n_rec, int chunk) {
  constexpr int kThreads = kTris;
  constexpr int kRecs = 2 * kTris;
  __shared__ float cam_m[16];
  __shared__ float tri[kTris * 9];
  __shared__ __align__(16) float rec[kFields][kRecs];
  const int cam = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * kTris;
  const int n_here = (int)max(0LL, min((long long)kTris, n_tri - t0));
  if (threadIdx.x < 16) cam_m[threadIdx.x] = cameras[cam * 16 + threadIdx.x];
  for (int i = threadIdx.x; i < n_here * 9; i += kThreads) {
    tri[i] = soup[t0 * 9 + i];
  }
  __syncthreads();
  const int tl = threadIdx.x;
  float4 box = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
  if (tl < n_here) {
    const float* p = tri + tl * 9;
    Vtx P[3];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const float p0 = p[3 * v], p1 = p[3 * v + 1], p2 = p[3 * v + 2];
      P[v] = Vtx{clip_comp(cam_m, p0, p1, p2),
                 clip_comp(cam_m + 4, p0, p1, p2),
                 clip_comp(cam_m + 8, p0, p1, p2),
                 clip_comp(cam_m + 12, p0, p1, p2)};
    }
    const bool in0 = P[0].w >= kWEps, in1 = P[1].w >= kWEps,
               in2 = P[2].w >= kWEps;
    const int n_in = (int)in0 + (int)in1 + (int)in2;
    const int first_in = in0 ? 0 : (in1 ? 1 : 2);
    const int first_out = !in0 ? 0 : (!in1 ? 1 : 2);
    const int k =
        n_in == 1 ? first_in : (n_in == 2 ? (first_out + 1) % 3 : 0);
    const Vtx A = pick3(k, P[0], P[1], P[2]);
    const Vtx B = pick3((k + 1) % 3, P[0], P[1], P[2]);
    const Vtx C = pick3((k + 2) % 3, P[0], P[1], P[2]);
    const bool one = n_in == 1, two = n_in == 2;
    const bool sv = soup_valid[t0 + tl] != 0;
    float ax, ay, az;
    project(A, &ax, &ay, &az);
    const Vtx iBC = isect(B, C), iAC = isect(A, C);
    float f[kFields];
    {
      Vtx V1 = B, V2 = C;
      if (one) {
        V1 = isect(A, B);
        V2 = iAC;
      } else if (two) {
        V2 = iBC;
      }
      make_record(ax, ay, az, V1, V2, n_in >= 1 && sv, f);
#pragma unroll
      for (int i = 0; i < kFields; ++i) rec[i][2 * tl] = f[i];
      box = make_float4(f[12], f[13], f[14], f[15]);
    }
    make_record(ax, ay, az, iBC, iAC, two && sv, f);
#pragma unroll
    for (int i = 0; i < kFields; ++i) rec[i][2 * tl + 1] = f[i];
    box = box_union(box, make_float4(f[12], f[13], f[14], f[15]));
  } else {
    float f[kFields];
    padding_record(f);
#pragma unroll
    for (int i = 0; i < kFields; ++i) {
      rec[i][2 * tl] = f[i];
      rec[i][2 * tl + 1] = f[i];
    }
    box = make_float4(f[12], f[13], f[14], f[15]);
  }
  // chunk / 2 triangles are as many neighbouring lanes
  const int half = chunk / 2;
  box = warp_union(box, half / 2);
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * kRecs;
  const int nr = (int)min((long long)kRecs, n_rec - r0);
  constexpr int kRowVecs = kRecs / 4;
  float* out = packed + (long long)cam * kFields * n_rec + r0;
  for (int e = threadIdx.x; e < kFields * kRowVecs; e += kThreads) {
    const int i = e / kRowVecs, c = e % kRowVecs;
    if (4 * c < nr) {
      reinterpret_cast<float4*>(out + (long long)i * n_rec)[c] =
          reinterpret_cast<const float4*>(rec[i])[c];
    }
  }
  const int nch = n_rec / chunk;
  if (tl % half == 0 && 2 * tl < nr) {
    const long long at = (long long)cam * 4 * nch + r0 / chunk + tl / half;
    cbox[at] = box.x;
    cbox[at + nch] = box.y;
    cbox[at + 2LL * nch] = box.z;
    cbox[at + 3LL * nch] = box.w;
  }
}

template <int kMinBlocks, int kTris = kSetupTris>
int launch_setup(const float* cameras, const float* soup,
                 const unsigned char* soup_valid, float* packed, float* cbox,
                 int n_cams, int n_tri, int n_rec, int chunk, void* stream) {
  if ((chunk != 8 && chunk != 16 && chunk != 32 && chunk != 64) ||
      n_rec % chunk != 0 || (long long)n_rec < 2LL * n_tri || n_tri < 0 ||
      n_cams < 0 || n_cams > 65535 ||
      reinterpret_cast<uintptr_t>(packed) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_cams == 0 || n_rec == 0) return 0;
  dim3 grid(mr_blocks(n_rec, 2 * kTris), n_cams);
  raster_setup_kernel<kMinBlocks, kTris>
      <<<grid, kTris, 0, (cudaStream_t)stream>>>(
          cameras, soup, soup_valid, packed, cbox, n_tri, n_rec, chunk);
  return (int)cudaGetLastError();
}

// the two halves of cluster.sync(): arrive (release), wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

// an arrive that publishes nothing: this CTA has started
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// BIN (the header above). A camera's tiles form blocks of kBinTx x kTy
// (row-major); the camera's `clusters` clusters take them in turn (cluster
// c blocks c, c + clusters, ...), and a cluster's CTAs take its blocks one
// at a time: CTA r first its r-th, then the next from a counter in the
// first CTA's shared memory. A round takes kRoundRuns runs of kRun groups:
//   1. coarse level: the cluster's CTAs split the round's runs, a lane a
//      group (vec: 4 groups, one float4 a plane), and store each run's
//      union into every CTA of the cluster;
//   then, for each block a CTA takes:
//   2. the runs whose union overlaps the block's region (the union of its
//      tiles), in ascending order (a warp a stretch of 32-run ballots, a
//      prefix over the warps);
//   3. those runs kBatchRuns at a time: their group boxes are staged in
//      shared memory, and a warp walks each of its tiles in turn over the
//      staged runs whose union overlaps it, a lane a group of the run, with
//      _tile_lists' four comparisons; the hits are compacted with
//      __ballot_sync / __popc, so lists[slot, :count] holds the ascending
//      ids the plain version's sort gives. A tile's count carries from
//      round to round through `counts`.
template <int kWarps, int kMinBlocks, int kTy = kBinTy>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
raster_bin_kernel(const BinArgs a) {
  constexpr int kTiles = kBinTx * kTy;  // tiles a block
  constexpr int kThreads = kWarps * 32;
  constexpr int kUnroll = 2;                       // runs a warp loads at once
  constexpr int kScan = kRoundRuns / 32 / kWarps;  // 32-run stretches a warp
  static_assert(kTiles <= 32 && kBatchRuns == 32 && kRun == 32,
                "a lane a tile, a staged run, a group");
  static_assert(kScan * 32 * kWarps == kRoundRuns, "runs a warp");
  __shared__ float4 coarse[kRoundRuns];
  __shared__ float4 fine[kBatchRuns * kRun];  // run s's group i at s*kRun+i
  __shared__ float4 tile_box[kTiles];
  __shared__ int tile_count[kTiles];
  __shared__ int survivors[kRoundRuns];
  __shared__ int warp_total[kWarps];
  __shared__ float4 region_s;
  __shared__ int next_block, block_s;
  __shared__ float ext_x[2][kMaxTileAxis], ext_y[2][kMaxTileAxis];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int cam = blockIdx.y;
  const int cl = blockIdx.x / csize;  // the cluster's index in the camera
  const int ngroups = a.nch / a.supers;
  const int nruns = (ngroups + kRun - 1) / kRun;
  const float* cb = a.cbox + (long long)cam * 4 * a.nch;
  const float4 empty = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
  // one group a chunk and 16-byte aligned rows: float4 loads of the boxes
  const bool vec = a.supers == 1 && a.nch % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.cbox) % 16 == 0;
  // round 0's arrive: every CTA of the cluster has started before any store
  // into it (every CTA of a cluster takes the same rounds: one camera)
  cluster_arrive_relaxed();
  // the tiles' extents, in shared memory when the grid fits (read after
  // the first cluster barrier)
  const bool staged_ext = a.ntx <= kMaxTileAxis && a.nty <= kMaxTileAxis;
  if (staged_ext) {
    for (int i = threadIdx.x; i < a.ntx; i += kThreads) {
      ext_x[0][i] = __ldg(a.tx0 + i);
      ext_x[1][i] = __ldg(a.tx1 + i);
    }
    for (int i = threadIdx.x; i < a.nty; i += kThreads) {
      ext_y[0][i] = __ldg(a.ty0 + i);
      ext_y[1][i] = __ldg(a.ty1 + i);
    }
  }
  // the cluster's blocks cl, cl + clusters, ..., nq of them
  const int nq = (a.nblocks - cl + a.clusters - 1) / a.clusters;
  // the i-th block of the cluster's: its tiles (past the image: the box
  // nothing overlaps), their counts so far and its region (warp 0, a lane a
  // tile); -1 past the cluster's blocks
  auto set_up = [&](int i, int r0) {
    if (i >= nq) return -1;
    const int blk = cl + i * a.clusters;
    if (warp == 0) {
      const int tx = blk % a.nbx * kBinTx + lane % kBinTx;
      const int ty = blk / a.nbx * kTy + lane / kBinTx;
      float4 b = empty;
      int n = 0;
      if (lane < kTiles && tx < a.ntx && ty < a.nty) {
        b = staged_ext
                ? make_float4(ext_x[0][tx], ext_x[1][tx], ext_y[0][ty],
                              ext_y[1][ty])
                : make_float4(__ldg(a.tx0 + tx), __ldg(a.tx1 + tx),
                              __ldg(a.ty0 + ty), __ldg(a.ty1 + ty));
        if (r0 > 0) n = a.counts[((long long)cam * a.nty + ty) * a.ntx + tx];
      }
      if (lane < kTiles) {
        tile_box[lane] = b;
        tile_count[lane] = n;
      }
      b = warp_union(b);
      if (lane == 0) region_s = b;
    }
    return blk;
  };

  // a round at least: with no runs, the blocks' counts are 0
  for (int r0 = 0; r0 == 0 || r0 < nruns; r0 += kRoundRuns) {
    const int rn = max(0, min(kRoundRuns, nruns - r0));
    // rounds past 0: every CTA is done with the last round's coarse level
    // and blocks
    if (r0 > 0) cluster_arrive();
    bool waited = false;
    const int stride = csize * kWarps;
    // (the first wait comes after a warp's first loads: they overlap the
    // barrier)
    if (vec) {
      // four runs a warp at a time: a lane takes 4 consecutive groups (one
      // float4 a plane), then the unions of 8 lanes; lane 8r + c stores
      // run r's union into CTA c
      for (int i = 4 * (rank * kWarps + warp); i < rn; i += 4 * stride) {
        float4 b[4];
        quad_boxes(cb, a.nch, ngroups, (r0 + i) * kRun + 4 * lane, b);
        const float4 u = warp_union(
            box_union(box_union(b[0], b[1]), box_union(b[2], b[3])), 4);
        if (!waited) {
          cluster_wait();
          waited = true;
        }
        const int r = i + lane / 8;
        if (lane % 8 < csize && r < rn) {
          cluster.map_shared_rank(coarse, lane % 8)[r] = u;
        }
      }
    }
    for (int i = rank * kWarps + warp; !vec && i < rn;
         i += kUnroll * stride) {
      float4 u[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int iq = i + q * stride;  // the same across the warp
        u[q] = iq < rn ? group_box(cb, a.nch, a.supers, ngroups,
                                   (r0 + iq) * kRun + lane)
                       : empty;
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) u[q] = warp_union(u[q]);
      if (!waited) {
        cluster_wait();
        waited = true;
      }
      if (lane < csize) {
        float4* dst = cluster.map_shared_rank(coarse, lane);
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          if (i + q * stride < rn) dst[i + q * stride] = u[q];
        }
      }
    }
    if (!waited) cluster_wait();
    if (rank == 0 && threadIdx.x == 0) next_block = csize;
    cluster.sync();  // every CTA's runs have landed in every CTA
    int* counter = cluster.map_shared_rank(&next_block, 0);
    for (int i = rank;;) {  // the i-th block of the cluster's
      const int blk = set_up(i, r0);
      __syncthreads();
      if (blk < 0) break;  // the same across the CTA
      const int bx = blk % a.nbx, by = blk / a.nbx;
      // the runs that overlap the region, ascending: warp w ballots the
      // stretches w * kScan .. of 32 runs, then places them after the
      // survivors of the warps before it
      const float4 region = region_s;
      unsigned keep[kScan];
      int mine = 0;
#pragma unroll
      for (int q = 0; q < kScan; ++q) {
        const int i = (warp * kScan + q) * 32 + lane;
        keep[q] = __ballot_sync(0xffffffffu,
                                i < rn && overlaps(coarse[i], region));
        mine += __popc(keep[q]);
      }
      if (lane == 0) warp_total[warp] = mine;
      __syncthreads();
      int at = 0, ns = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int n = warp_total[w];
        at += w < warp ? n : 0;
        ns += n;
      }
#pragma unroll
      for (int q = 0; q < kScan; ++q) {
        if (keep[q] & (1u << lane)) {
          survivors[at + __popc(keep[q] & below)] =
              (warp * kScan + q) * 32 + lane;
        }
        at += __popc(keep[q]);
      }
      __syncthreads();
      for (int s0 = 0; s0 < ns; s0 += kBatchRuns) {
        const int sn = min(kBatchRuns, ns - s0);
        if (vec) {  // a thread a quarter run, one float4 a plane
          for (int e = threadIdx.x; e < sn * 8; e += kThreads) {
            float4 b[4];
            quad_boxes(cb, a.nch, ngroups,
                       (r0 + survivors[s0 + e / 8]) * kRun + 4 * (e % 8), b);
#pragma unroll
            for (int k = 0; k < 4; ++k) fine[4 * e + k] = b[k];
          }
        } else {
          for (int e = threadIdx.x; e < sn * kRun; e += kThreads) {
            fine[e] = group_box(cb, a.nch, a.supers, ngroups,
                                (r0 + survivors[s0 + e / kRun]) * kRun +
                                    e % kRun);
          }
        }
        const int run = lane < sn ? survivors[s0 + lane] : 0;
        const float4 u = coarse[run];
        __syncthreads();
        // a warp walks its tiles k = warp, warp + kWarps, ... in turn
        for (int k = warp; k < kTiles; k += kWarps) {
          const float4 t = tile_box[k];
          unsigned runs =
              __ballot_sync(0xffffffffu, lane < sn && overlaps(u, t));
          if (runs == 0u) continue;  // the same across the warp
          const int tx = bx * kBinTx + k % kBinTx;
          const int ty = by * kTy + k / kBinTx;
          int* list =
              a.lists + (((long long)cam * a.nty + ty) * a.ntx + tx) * ngroups;
          int n = tile_count[k];
          do {
            const int r = __ffs(runs) - 1;
            runs &= runs - 1u;
            const int g =
                (r0 + __shfl_sync(0xffffffffu, run, r)) * kRun + lane;
            const bool hit = overlaps(fine[r * kRun + lane], t);
            const unsigned ballot = __ballot_sync(0xffffffffu, hit);
            if (hit) list[n + __popc(ballot & below)] = g;
            n += __popc(ballot);
          } while (runs != 0u);
          if (lane == 0) tile_count[k] = n;
        }
        __syncthreads();  // the batch is consumed before the next is staged
      }
      if (warp == 0) {
        const int tx = bx * kBinTx + lane % kBinTx;
        const int ty = by * kTy + lane / kBinTx;
        if (lane < kTiles && tx < a.ntx && ty < a.nty) {
          a.counts[((long long)cam * a.nty + ty) * a.ntx + tx] =
              tile_count[lane];
        }
      }
      // the next block (warp 0's count stores above come before its set-up)
      if (threadIdx.x == 0) block_s = atomicAdd(counter, 1);
      __syncthreads();
      i = block_s;
    }
  }
  // the first CTA's counter and every CTA's shared memory outlive the last
  // access from the cluster
  cluster.sync();
}

template <int kWarps, int kMinBlocks, int kTy = kBinTy>
int launch_bin(const float* cbox, const float* tx0, const float* tx1,
               const float* ty0, const float* ty1, int* lists, int* counts,
               int n_cams, int nch, int supers, int ntx, int nty,
               int cluster, void* stream) {
  if (supers < 1 || nch < 0 || nch % supers != 0 || ntx < 1 || nty < 1 ||
      n_cams < 0 || n_cams > 65535 || cluster < 1 || cluster > 8) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_cams == 0) return 0;
  auto kernel = raster_bin_kernel<kWarps, kMinBlocks, kTy>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the clusters resident at once on this device (once a device and
  // cluster size): a camera takes its share of them, one wave in all
  static std::atomic<int> resident[64][9];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int fit = resident[dev & 63][cluster].load(std::memory_order_relaxed);
  if (fit == 0) {
    cfg.gridDim = dim3(cluster * 1024);
    e = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    fit = max(fit, 1);
    resident[dev & 63][cluster].store(fit, std::memory_order_relaxed);
  }
  const int nbx = (ntx + kBinTx - 1) / kBinTx;
  const int nblocks = nbx * ((nty + kTy - 1) / kTy);
  const int clusters = max(1, min((nblocks + cluster - 1) / cluster,
                                  fit / n_cams));
  const BinArgs args = {cbox, tx0, tx1, ty0, ty1, lists, counts, nch, supers,
                        ntx, nty, nbx, nblocks, clusters};
  cfg.gridDim = dim3(clusters * cluster, n_cams);
  e = cudaLaunchKernelEx(&cfg, kernel, args);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

// cameras (n_cams, 4, 4); soup (n_tri, 3, 3) float32; soup_valid (n_tri,)
// one byte each (torch.bool); packed (n_cams, 16, n_rec), 16-byte aligned;
// cbox (n_cams, 4, n_rec / chunk). n_rec >= 2 * n_tri, a multiple of chunk,
// chunk in {8, 16, 32, 64}.
MR_EXPORT int mr_raster_setup(const float* cameras, const float* soup,
                              const unsigned char* soup_valid, float* packed,
                              float* cbox, int n_cams, int n_tri, int n_rec,
                              int chunk, void* stream) {
  return launch_setup<kSetupMinBlocks>(cameras, soup, soup_valid, packed,
                                       cbox, n_cams, n_tri, n_rec, chunk,
                                       stream);
}

// cbox (n_cams, 4, nch) chunk boxes (xmin, xmax, ymin, ymax); tx0/tx1
// (ntx,), ty0/ty1 (nty,) the tiles' NDC extents; lists (n_cams, nty*ntx,
// nch / supers) and counts (n_cams, nty*ntx) int32: per tile, the groups of
// `supers` chunks whose box union overlaps it, ascending, and their count.
MR_EXPORT int mr_raster_bin(const float* cbox, const float* tx0,
                            const float* tx1, const float* ty0,
                            const float* ty1, int* lists, int* counts,
                            int n_cams, int nch, int supers, int ntx, int nty,
                            void* stream) {
  // few chunks: smaller clusters (the coarse level is cheap to build);
  // few groups: taller blocks (fewer blocks to walk); chosen on the card
  const int cluster = nch <= kSmallChunks ? kBinSmallCluster : kBinCluster;
  if (supers > 0 && nch / supers <= kSmallGroups) {
    return launch_bin<kBinWarps, kBinMinBlocks, kBinTy>(
        cbox, tx0, tx1, ty0, ty1, lists, counts, n_cams, nch, supers, ntx,
        nty, cluster, stream);
  }
  return launch_bin<kBinWarps, kBinMinBlocks, kBinTyLarge>(
      cbox, tx0, tx1, ty0, ty1, lists, counts, n_cams, nch, supers, ntx, nty,
      cluster, stream);
}

// The launch geometry of both kernels on this device: out[0..5] = SETUP's
// threads a CTA and resident CTAs an SM; BIN's threads a CTA, resident CTAs
// an SM, CTAs a cluster and clusters resident on the card at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, ...MaxActiveClusters).
MR_EXPORT int mr_raster_setup_shape(int* out) {
  out[0] = kSetupTris;
  out[2] = kBinWarps * 32;
  out[4] = kBinCluster;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], raster_setup_kernel<kSetupMinBlocks>, kSetupTris, 0);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[3], raster_bin_kernel<kBinWarps, kBinMinBlocks>,
        kBinWarps * 32, 0);
  }
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kBinCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kBinCluster * 64);
    cfg.blockDim = dim3(kBinWarps * 32);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(
        &out[5], raster_bin_kernel<kBinWarps, kBinMinBlocks>, &cfg);
  }
  return (int)e;
}
