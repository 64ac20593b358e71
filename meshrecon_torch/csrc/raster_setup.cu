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
// Setup: one thread per (camera, triangle). It repeats, operation for
// operation, rasterizer.clip_project_planes (the fixed association of the
// clip transform, the canonical rotation, the three near-plane
// intersections, the safe_w divide, the area and ok), edge_affine_planes
// and coverage_bbox (float64, padded, clamped, rounded to float32 once),
// and writes the triangle's two records (slot 1 at 2t, slot 2 at 2t+1) into
// packed (n_cams, 16, n_rec), padding records included. The bbox unions of
// each chunk of `chunk` records (8-64: 4-32 neighbouring lanes, since a warp
// holds 32 triangles) reduce with shuffles and go to cbox (n_cams, 4,
// n_rec / chunk). What bounds it: the 64 bytes written a record (16 floats);
// its ~400 operations a triangle are far below the float32 rate.
//
// Bin: one warp per (camera, tile); a CTA holds 8 x 4 tiles. A round stages
// 1,024 group boxes in shared memory (a group is a chunk for K1, a
// superchunk of `supers` chunks for K5; a thread takes the union of its
// group's chunk boxes, and loads the next round's during this round's
// walk), with the union of each run of 32. Each warp tests the 32 unions
// against its tile at once, one a lane, and walks only the runs whose
// union overlaps it (the union holds each box, so it overlaps the tile
// whenever one of them does), testing their boxes with _tile_lists' four
// comparisons, 32 at a time. The hits are compacted with __ballot_sync /
// __popc, so lists[slot, :count] holds the ascending ids the plain
// version's sort gives. Entries past count are not
// written; K1 and K5 never read them. No sort and no dense key tensor: the
// work is the box tests, (tiles x groups) comparisons at most, and the
// traffic the group boxes (read once a CTA, from L2) and the lists written.
//
// Arithmetic: explicitly rounded float32 and float64 intrinsics in the plain
// version's order, IEEE division and square root, -fmad=false; Python
// scalars of the plain version are float32 operands (1e-6, 6.25e-5, 1e-12)
// or float64 ones inside coverage_bbox (1e-5, 1.0, 3e38).
#include "common.cuh"

namespace {

constexpr int kFields = 16;  // a0 b0 c0 a1 b1 c1 a2 b2 c2 z0 z1 z2
                             // xmin xmax ymin ymax
constexpr int kSetupThreads = 256;
constexpr float kWEps = 1e-6f;      // rasterizer._W_EPS
constexpr float kSlop = 6.25e-5f;   // rasterizer.EDGE_TIE_SLOP
constexpr float kAreaEps = 1e-12f;  // the degenerate-area threshold
constexpr double kBig = 3e38;       // coverage_bbox's big
// float32 of 3e38, as torch converts the Python float (round to nearest)
constexpr float kBigF = static_cast<float>(kBig);

constexpr int kTilesX = 8, kTilesY = 4;
constexpr int kBinWarps = kTilesX * kTilesY;  // a warp a tile
constexpr int kBinThreads = kBinWarps * 32;   // group boxes a round

struct Vtx {
  float x, y, z, w;
};

// clip component of point p by camera row m: ((p0*m0 + p1*m1) + p2*m2) + m3
__device__ __forceinline__ float clip_comp(const float* __restrict__ m,
                                           float p0, float p1, float p2) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p0, __ldg(m)),
                                       __fmul_rn(p1, __ldg(m + 1))),
                             __fmul_rn(p2, __ldg(m + 2))),
                   __ldg(m + 3));
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

// One record of a screen triangle (v0, v1, v2 in clip space): the 16 fields
// of pack_records (screen(), edge_affine_planes, coverage_bbox).
__device__ __forceinline__ void make_record(const Vtx& v0, const Vtx& v1,
                                            const Vtx& v2, bool valid,
                                            float* f) {
  float xs[3], ys[3];
  project(v0, &xs[0], &ys[0], &f[9]);
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

__global__ void __launch_bounds__(kSetupThreads)
raster_setup_kernel(const float* __restrict__ cameras,
                    const float* __restrict__ soup,
                    const unsigned char* __restrict__ soup_valid,
                    float* __restrict__ packed, float* __restrict__ cbox,
                    int n_tri, int n_rec, int chunk) {
  const int cam = blockIdx.y;
  const int t = blockIdx.x * kSetupThreads + threadIdx.x;  // triangle
  const int n_pairs = n_rec / 2;
  float r1[kFields], r2[kFields];
  if (t < n_tri) {
    const float* m = cameras + cam * 16;
    const float* p = soup + (long long)t * 9;
    Vtx P[3];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const float p0 = __ldg(p + 3 * v), p1 = __ldg(p + 3 * v + 1),
                  p2 = __ldg(p + 3 * v + 2);
      P[v] = Vtx{clip_comp(m, p0, p1, p2), clip_comp(m + 4, p0, p1, p2),
                 clip_comp(m + 8, p0, p1, p2), clip_comp(m + 12, p0, p1, p2)};
    }
    const bool in0 = P[0].w >= kWEps, in1 = P[1].w >= kWEps,
               in2 = P[2].w >= kWEps;
    const int n_in = (int)in0 + (int)in1 + (int)in2;
    // canonical rotation: n_in == 1 puts the inside vertex first; n_in ==
    // 2 puts the outside vertex last
    const int first_in = in0 ? 0 : (in1 ? 1 : 2);
    const int first_out = !in0 ? 0 : (!in1 ? 1 : 2);
    const int k = n_in == 1 ? first_in : (n_in == 2 ? (first_out + 1) % 3 : 0);
    const Vtx A = pick3(k, P[0], P[1], P[2]);
    const Vtx B = pick3((k + 1) % 3, P[0], P[1], P[2]);
    const Vtx C = pick3((k + 2) % 3, P[0], P[1], P[2]);
    const Vtx iAB = isect(A, B), iAC = isect(A, C), iBC = isect(B, C);
    const bool one = n_in == 1, two = n_in == 2;
    const bool sv = soup_valid[t] != 0;
    // slot 1: case1 (A, iAB, iAC); case2 (A, B, iBC); else the original
    make_record(A, one ? iAB : B, one ? iAC : (two ? iBC : C),
                n_in >= 1 && sv, r1);
    // slot 2: only case2 (A, iBC, iAC)
    make_record(A, iBC, iAC, two && sv, r2);
  } else {
    padding_record(r1);
    padding_record(r2);
  }
  float* out = packed + (long long)cam * kFields * n_rec + 2LL * t;
  if (t < n_pairs) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      *reinterpret_cast<float2*>(out + (long long)f * n_rec) =
          make_float2(r1[f], r2[f]);
    }
  }
  // chunk bbox unions: chunk / 2 neighbouring lanes (aligned, since a warp
  // starts at a multiple of 32 triangles); lanes past the records hold the
  // empty box and belong to no written chunk
  float bx0 = fminf(r1[12], r2[12]), bx1 = fmaxf(r1[13], r2[13]);
  float by0 = fminf(r1[14], r2[14]), by1 = fmaxf(r1[15], r2[15]);
  if (t >= n_pairs) {
    bx0 = by0 = INFINITY;
    bx1 = by1 = -INFINITY;
  }
  const int half = chunk / 2;
  for (int off = 1; off < half; off <<= 1) {
    bx0 = fminf(bx0, __shfl_xor_sync(0xffffffffu, bx0, off));
    bx1 = fmaxf(bx1, __shfl_xor_sync(0xffffffffu, bx1, off));
    by0 = fminf(by0, __shfl_xor_sync(0xffffffffu, by0, off));
    by1 = fmaxf(by1, __shfl_xor_sync(0xffffffffu, by1, off));
  }
  if (t < n_pairs && t % half == 0) {
    const int nch = n_rec / chunk;
    float* cb = cbox + (long long)cam * 4 * nch + t / half;
    cb[0] = bx0;
    cb[nch] = bx1;
    cb[2 * (long long)nch] = by0;
    cb[3 * (long long)nch] = by1;
  }
}

__device__ __forceinline__ bool overlaps(const float4& b, float x_lo,
                                         float x_hi, float y_lo, float y_hi) {
  return b.x <= x_hi && b.y >= x_lo && b.z <= y_hi && b.w >= y_lo;
}

__device__ __forceinline__ float4 box_union(float4 a, const float4& b) {
  return make_float4(fminf(a.x, b.x), fmaxf(a.y, b.y), fminf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

__global__ void __launch_bounds__(kBinThreads)
raster_bin_kernel(const float* __restrict__ cbox,
                  const float* __restrict__ tx0, const float* __restrict__ tx1,
                  const float* __restrict__ ty0, const float* __restrict__ ty1,
                  int* __restrict__ lists, int* __restrict__ counts, int nch,
                  int supers, int ntx, int nty) {
  __shared__ float4 box[kBinThreads];
  __shared__ float4 coarse[kBinWarps];
  const int cam = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = blockIdx.x * kTilesX + warp % kTilesX;
  const int ty = blockIdx.y * kTilesY + warp / kTilesX;
  const bool active = tx < ntx && ty < nty;
  float x_lo = 0.0f, x_hi = 0.0f, y_lo = 0.0f, y_hi = 0.0f;
  if (active) {
    x_lo = __ldg(tx0 + tx);
    x_hi = __ldg(tx1 + tx);
    y_lo = __ldg(ty0 + ty);
    y_hi = __ldg(ty1 + ty);
  }
  const int ngroups = nch / supers;
  const float* cb = cbox + (long long)cam * 4 * nch;
  const long long slot = ((long long)cam * nty + ty) * ntx + tx;
  int* list = lists + slot * ngroups;
  const float4 empty = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
  // group g's box: the union of its chunks' boxes; past the groups, empty
  auto load = [&](int g) {
    float4 b = empty;
    if (g < ngroups) {
      const float* c = cb + (long long)g * supers;
      for (int s = 0; s < supers; ++s) {
        b = box_union(b, make_float4(__ldg(c + s), __ldg(c + nch + s),
                                     __ldg(c + 2LL * nch + s),
                                     __ldg(c + 3LL * nch + s)));
      }
    }
    return b;
  };
  int count = 0;
  float4 b = load(threadIdx.x);
  for (int base = 0; base < ngroups; base += kBinThreads) {
    float4 u = b;  // the union of this warp's 32 boxes
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      u = box_union(u, make_float4(__shfl_xor_sync(0xffffffffu, u.x, off),
                                   __shfl_xor_sync(0xffffffffu, u.y, off),
                                   __shfl_xor_sync(0xffffffffu, u.z, off),
                                   __shfl_xor_sync(0xffffffffu, u.w, off)));
    }
    __syncthreads();  // the previous round's boxes are consumed
    box[threadIdx.x] = b;
    if (lane == 0) coarse[warp] = u;
    __syncthreads();
    b = load(base + kBinThreads + threadIdx.x);  // in flight during the walk
    if (active) {
      // the runs of 32 boxes whose union overlaps the tile, one per lane,
      // then those runs in ascending order
      unsigned runs = __ballot_sync(
          0xffffffffu, overlaps(coarse[lane], x_lo, x_hi, y_lo, y_hi));
      while (runs != 0u) {
        const int i = (__ffs(runs) - 1) * 32 + lane;  // past ngroups: empty
        runs &= runs - 1u;
        const bool hit = overlaps(box[i], x_lo, x_hi, y_lo, y_hi);
        const unsigned ballot = __ballot_sync(0xffffffffu, hit);
        if (hit) list[count + __popc(ballot & ((1u << lane) - 1u))] = base + i;
        count += __popc(ballot);
      }
    }
  }
  if (active && lane == 0) counts[slot] = count;
}

}  // namespace

// cameras (n_cams, 4, 4); soup (n_tri, 3, 3) float32; soup_valid (n_tri,)
// one byte each (torch.bool); packed (n_cams, 16, n_rec); cbox (n_cams, 4,
// n_rec / chunk). n_rec >= 2 * n_tri, a multiple of chunk, chunk in {8, 16,
// 32, 64}.
MR_EXPORT int mr_raster_setup(const float* cameras, const float* soup,
                              const unsigned char* soup_valid, float* packed,
                              float* cbox, int n_cams, int n_tri, int n_rec,
                              int chunk, void* stream) {
  if ((chunk != 8 && chunk != 16 && chunk != 32 && chunk != 64) ||
      n_rec % chunk != 0 || (long long)n_rec < 2LL * n_tri || n_tri < 0 ||
      n_cams < 0 || n_cams > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_cams == 0 || n_rec == 0) return 0;
  dim3 grid(mr_blocks(n_rec / 2, kSetupThreads), n_cams);
  raster_setup_kernel<<<grid, kSetupThreads, 0, (cudaStream_t)stream>>>(
      cameras, soup, soup_valid, packed, cbox, n_tri, n_rec, chunk);
  return (int)cudaGetLastError();
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
  if (supers < 1 || nch < 0 || nch % supers != 0 || ntx < 1 || nty < 1 ||
      n_cams < 0 || n_cams > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_cams == 0) return 0;
  dim3 grid((ntx + kTilesX - 1) / kTilesX, (nty + kTilesY - 1) / kTilesY,
            n_cams);
  raster_bin_kernel<<<grid, kBinThreads, 0, (cudaStream_t)stream>>>(
      cbox, tx0, tx1, ty0, ty1, lists, counts, nch, supers, ntx, nty);
  return (int)cudaGetLastError();
}
