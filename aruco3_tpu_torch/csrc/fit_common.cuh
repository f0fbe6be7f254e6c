// Fit device code shared by kernel 2 (coarse_fit.cu) and kernels 5-7
// (fit.cu): one spelling of segment.fit_quads' exact float32 expressions.
//
// The pieces are the TPU fit's (aruco3_tpu/ops/fit_pallas.py):
//   * rank_pool: the admission pre-filter (_rank_prep, wrap-around offsets
//     of segment.ADMIT_OFFSETS), the raster rank of admitted roots and the
//     (root, size) pair of each rank below min(n_roots, kr) (_rank_pool);
//   * topk_pick: top-k of the pool by (size descending, root ascending),
//     the order of lax.top_k on the raster-ordered pool;
//   * lane_chain: the per-lane centroid, extreme-point quad and
//     containment fraction (_lane_chain);
//   * fit_plane: the three in a row for one label plane, one warp per
//     lane (kernel 2's tail and kernel 7).
// The build has no -rdc, so shared device code lives here, in a header.
// Every reduction is exact in any order: counts are integers, centroid
// sums are summed in double, and every arg-max takes the first linear
// index among equal scores.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace a3fit {

constexpr int KR_MAX = 1024;  // rank pool a fit_plane call holds in shared memory
constexpr int K_MAX = 128;    // lanes a fit_plane call selects

struct FitOut {
  float* quads;    // (k, 4, 2)
  uint8_t* valid;  // (k,)
  int* roots;      // (k,)
  float* cents;    // (k, 2)
  int* sizes;      // (k,)
  int* qual;       // ()
};

// Batched fit outputs; frame() offsets them to frame b.
struct FitPtrs {
  float* quads;
  uint8_t* valid;
  int* roots;
  float* cents;
  int* sizes;
  int* qual;

  __device__ FitOut frame(int b, int k) const {
    FitOut o;
    o.quads = quads + static_cast<size_t>(b) * k * 8;
    o.valid = valid + static_cast<size_t>(b) * k;
    o.roots = roots + static_cast<size_t>(b) * k;
    o.cents = cents + static_cast<size_t>(b) * k * 2;
    o.sizes = sizes + static_cast<size_t>(b) * k;
    o.qual = qual + b;
    return o;
  }
};

struct FitParams {
  int ds, min_px;
  float slack;  // containment_slack * ds
  float min_containment;
};

// Shared memory of one fit_plane call (THREADS threads).
template <int THREADS>
struct FitSmem {
  int chunk[THREADS];
  int roots_r[KR_MAX];
  int sizes_r[KR_MAX];
  int sel[K_MAX];
  int n_roots;
};

static __device__ __forceinline__ float cell_x(int p, int wc, int ds) {
  return static_cast<float>(p % wc) * static_cast<float>(ds) +
         static_cast<float>(ds - 1) * 0.5f;
}

static __device__ __forceinline__ float cell_y(int p, int wc, int ds) {
  return static_cast<float>(p / wc) * static_cast<float>(ds) +
         static_cast<float>(ds - 1) * 0.5f;
}

// A root whose same-label count at ADMIT_OFFSETS (wrapping around the
// grid, as jnp.roll does) reaches t - 1, t = min(min_px, 3).
static __device__ __forceinline__ bool is_admitted_root(const int* lab, int p, int t, int hc,
                                                        int wc) {
  const int l = lab[p];
  if (l != p) return false;
  if (t <= 1) return true;
  const int y = p / wc;
  const int x = p - y * wc;
  const int off2[2][2] = {{0, 1}, {1, 0}};
  const int off3[6][2] = {{0, 1}, {0, 2}, {1, -1}, {1, 0}, {1, 1}, {2, 0}};
  const int n = t == 2 ? 2 : 6;
  int cnt = 0;
  for (int i = 0; i < n; ++i) {
    const int dy = t == 2 ? off2[i][0] : off3[i][0];
    const int dx = t == 2 ? off2[i][1] : off3[i][1];
    const int yy = ((y + dy) % hc + hc) % hc;
    const int xx = ((x + dx) % wc + wc) % wc;
    cnt += lab[yy * wc + xx] == l;
  }
  return cnt >= t - 1;
}

// Block-wide rank pool of one label plane.  roots_r / sizes_r (kr each,
// shared or global memory) get the root and member count of raster rank j
// for j < min(n_roots, kr), and (0, -1) after; returns n_roots.  cnt is a
// P-int scratch plane, chunk blockDim.x ints and n_sh one int of shared
// memory.  Ends with a barrier.
static __device__ int rank_pool(const int* lab, int hc, int wc, int kr, int min_px, int* cnt,
                                int* chunk, int* n_sh, int* roots_r, int* sizes_r) {
  const int P = hc * wc;
  const int t = min(min_px, 3);
  for (int p = threadIdx.x; p < P; p += blockDim.x) cnt[p] = 0;
  __syncthreads();
  // Each thread ranks a contiguous chunk of cells, so the ranks of its
  // roots follow from one exclusive scan of the per-chunk counts.
  const int cs = (P + blockDim.x - 1) / blockDim.x;
  const int c0 = threadIdx.x * cs;
  const int c1 = min(P, c0 + cs);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int l = lab[p];
    if (l < P) atomicAdd(&cnt[l], 1);
  }
  int mine = 0;
  for (int p = c0; p < c1; ++p) mine += is_admitted_root(lab, p, t, hc, wc);
  chunk[threadIdx.x] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int i = 0; i < static_cast<int>(blockDim.x); ++i) {
      const int c = chunk[i];
      chunk[i] = run;
      run += c;
    }
    *n_sh = run;
  }
  __syncthreads();
  const int n_roots = *n_sh;
  int rank = chunk[threadIdx.x];
  for (int p = c0; p < c1 && rank < kr; ++p) {
    if (is_admitted_root(lab, p, t, hc, wc)) roots_r[rank++] = p;
  }
  for (int j = min(n_roots, kr) + threadIdx.x; j < kr; j += blockDim.x) roots_r[j] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < kr; j += blockDim.x)
    sizes_r[j] = j < n_roots ? cnt[roots_r[j]] : -1;
  __syncthreads();
  return n_roots;
}

// The selection key: size in the high word, the root's complement in the
// low word, so a larger key is a larger size, then a lower root.  Empty
// pool entries (size -1, root 0) share one key; pool order breaks that tie.
static __device__ __forceinline__ long long pick_key(int size, int root) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<long long>(size)) << 32) |
      static_cast<unsigned>(0x7fffffff - root));
}

// sel[r] = pool index of the r-th pick, r < k: each entry counts the
// entries ahead of it.  Block-wide; ends with a barrier.
static __device__ void topk_pick(const int* roots_r, const int* sizes_r, int kr, int k, int* sel) {
  for (int j = threadIdx.x; j < kr; j += blockDim.x) {
    const long long kj = pick_key(sizes_r[j], roots_r[j]);
    int r = 0;
    for (int i = 0; i < kr; ++i) {
      const long long ki = pick_key(sizes_r[i], roots_r[i]);
      r += (ki > kj) || (ki == kj && i < j);
    }
    if (r < k) sel[r] = j;
  }
  __syncthreads();
}

static __device__ __forceinline__ void amax_update(float s, int i, float& bs, int& bi) {
  if (s > bs || (s == bs && i < bi)) {
    bs = s;
    bi = i;
  }
}

static __device__ __forceinline__ void warp_argmax_pair(float& bs, int& bi) {
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, bs, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    amax_update(os, oi, bs, bi);
  }
  bs = __shfl_sync(0xffffffffu, bs, 0);
  bi = __shfl_sync(0xffffffffu, bi, 0);
}

template <class T>
static __device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

// Reductions of one warp: the lane chain of kernels 2 and 7.
struct WarpRed {
  __device__ int rank() const { return threadIdx.x & 31; }
  __device__ int size() const { return 32; }
  template <class T>
  __device__ T sum(T v) const { return warp_sum(v); }
  __device__ int argmax(float bs, int bi) const {
    warp_argmax_pair(bs, bi);
    return bi;
  }
};

// Reductions of a whole block of NW warps: the lane chain of kernel 6.
// Every thread gets the result; the shared scratch is reused after a
// trailing barrier.
template <int NW>
struct BlockRed {
  double* sd;  // NW
  float* sf;   // NW
  int* si;     // NW
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ double sum(double v) const {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) sd[threadIdx.x >> 5] = v;
    __syncthreads();
    double t = 0.0;
    for (int w = 0; w < NW; ++w) t += sd[w];
    __syncthreads();
    return t;
  }
  __device__ int sum(int v) const {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) si[threadIdx.x >> 5] = v;
    __syncthreads();
    int t = 0;
    for (int w = 0; w < NW; ++w) t += si[w];
    __syncthreads();
    return t;
  }
  __device__ int argmax(float bs, int bi) const {
    warp_argmax_pair(bs, bi);
    if ((threadIdx.x & 31) == 0) {
      sf[threadIdx.x >> 5] = bs;
      si[threadIdx.x >> 5] = bi;
    }
    __syncthreads();
    float s = -INFINITY;
    int i = 0x7fffffff;
    for (int w = 0; w < NW; ++w) amax_update(sf[w], si[w], s, i);
    __syncthreads();
    return i;
  }
};

struct LaneFit {
  float qx[4], qy[4];  // corners A, B, C, D
  float cenx, ceny, frac;
};

// segment.fit_quads' chain for the lane of `root` with `size` members
// (size >= 0): centroid, corner A farthest from it, corner C farthest from
// A, B and D the extremes of the cross product against A->C, then the
// fraction of members inside the quad expanded by slack * edge length.
// Each arg-max takes the first cell among equal scores (cell 0 when the
// lane has no member, as the plain version's masked argmax does).
template <class Red>
static __device__ __forceinline__ LaneFit lane_chain(const Red& red, const int* lab, int P,
                                                     int wc, int root, int size, int ds,
                                                     float slack) {
  const int r0 = red.rank(), rs = red.size();
  const float szf = fmaxf(static_cast<float>(size), 1.0f);
  double sx = 0.0, sy = 0.0;
  for (int p = r0; p < P; p += rs) {
    if (lab[p] != root) continue;
    sx += static_cast<double>(cell_x(p, wc, ds));
    sy += static_cast<double>(cell_y(p, wc, ds));
  }
  LaneFit f;
  f.cenx = static_cast<float>(red.sum(sx)) / szf;
  f.ceny = static_cast<float>(red.sum(sy)) / szf;

  auto first = [](int i) { return i == 0x7fffffff ? 0 : i; };
  float bs = -INFINITY;
  int bi = 0x7fffffff;
  for (int p = r0; p < P; p += rs) {
    if (lab[p] != root) continue;
    const float dxx = cell_x(p, wc, ds) - f.cenx;
    const float dyy = cell_y(p, wc, ds) - f.ceny;
    amax_update(dxx * dxx + dyy * dyy, p, bs, bi);
  }
  const int ia = first(red.argmax(bs, bi));
  const float ax = cell_x(ia, wc, ds), ay = cell_y(ia, wc, ds);

  bs = -INFINITY;
  bi = 0x7fffffff;
  for (int p = r0; p < P; p += rs) {
    if (lab[p] != root) continue;
    const float dxx = cell_x(p, wc, ds) - ax;
    const float dyy = cell_y(p, wc, ds) - ay;
    amax_update(dxx * dxx + dyy * dyy, p, bs, bi);
  }
  const int ic = first(red.argmax(bs, bi));
  const float qcx = cell_x(ic, wc, ds), qcy = cell_y(ic, wc, ds);

  const float dx = qcx - ax;
  const float dy = qcy - ay;
  float bsb = -INFINITY, bsd = -INFINITY;
  int bib = 0x7fffffff, bid = 0x7fffffff;
  for (int p = r0; p < P; p += rs) {
    if (lab[p] != root) continue;
    const float cross = (cell_x(p, wc, ds) - ax) * dy - (cell_y(p, wc, ds) - ay) * dx;
    amax_update(cross, p, bsb, bib);
    amax_update(-cross, p, bsd, bid);
  }
  const int ib = first(red.argmax(bsb, bib));
  const int id = first(red.argmax(bsd, bid));

  float* qx = f.qx;
  float* qy = f.qy;
  qx[0] = ax; qy[0] = ay;
  qx[1] = cell_x(ib, wc, ds); qy[1] = cell_y(ib, wc, ds);
  qx[2] = qcx; qy[2] = qcy;
  qx[3] = cell_x(id, wc, ds); qy[3] = cell_y(id, wc, ds);

  // Containment in the expanded per-edge form of segment.fit_quads.
  float ex[4], ey[4], term[4];
  for (int e = 0; e < 4; ++e) {
    const int n = (e + 1) & 3;
    ex[e] = qx[n] - qx[e];
    ey[e] = qy[n] - qy[e];
    term[e] = qx[e] * qy[n] - qx[n] * qy[e];
  }
  const float area2 = ((term[0] + term[1]) + term[2]) + term[3];
  const float sgn = area2 >= 0.0f ? 1.0f : -1.0f;
  float av[4], bv[4], rhs[4];
  for (int e = 0; e < 4; ++e) {
    const float elen = sqrtf(ex[e] * ex[e] + ey[e] * ey[e]) + 1e-6f;
    av[e] = sgn * ex[e];
    bv[e] = sgn * ey[e];
    const float c0e = bv[e] * qx[e] - av[e] * qy[e];
    rhs[e] = -slack * elen - c0e;
  }
  int inside = 0;
  for (int p = r0; p < P; p += rs) {
    if (lab[p] != root) continue;
    const float px = cell_x(p, wc, ds), py = cell_y(p, wc, ds);
    bool in = true;
    for (int e = 0; e < 4; ++e) in = in && (py * av[e] - px * bv[e] >= rhs[e]);
    inside += in;
  }
  f.frac = static_cast<float>(red.sum(inside)) / szf;
  return f;
}

// One lane's outputs; a lane that is not fitted (unused, or skipped as a
// twin) gets zero corners, centroid and fraction.
static __device__ __forceinline__ void write_lane(const FitOut& o, int l, const LaneFit* f,
                                                  int root, int size, bool used,
                                                  const FitParams& pr) {
  for (int c = 0; c < 4; ++c) {
    o.quads[(l * 4 + c) * 2] = f ? f->qx[c] : 0.0f;
    o.quads[(l * 4 + c) * 2 + 1] = f ? f->qy[c] : 0.0f;
  }
  const float frac = f ? f->frac : 0.0f;
  o.valid[l] = used && (size >= pr.min_px) && (frac >= pr.min_containment);
  o.roots[l] = root;
  o.cents[l * 2] = f ? f->cenx : 0.0f;
  o.cents[l * 2 + 1] = f ? f->ceny : 0.0f;
  o.sizes[l] = size;
}

// Lanes of an earlier fit whose exact twins (same root and size as one of
// its valid lanes) are not fitted: merge_fits drops them anyway.
struct Twins {
  const int* roots;  // nullptr: no lane is skipped
  const int* sizes;
  const uint8_t* valid;
  int k;

  __device__ bool has(int root, int size) const {
    if (roots == nullptr) return false;
    for (int i = 0; i < k; ++i)
      if (valid[i] && roots[i] == root && sizes[i] == size) return true;
    return false;
  }
};

// segment.fit_quads of one label plane: k lanes from a pool of kr roots,
// one warp per lane.  Block-wide; ends with a barrier.
template <int THREADS>
static __device__ void fit_plane(const int* lab, int hc, int wc, int k, int kr, const FitOut o,
                                 int* cnt, FitSmem<THREADS>& s, const FitParams& pr,
                                 const Twins& twins) {
  const int P = hc * wc;
  const int n_roots =
      rank_pool(lab, hc, wc, kr, pr.min_px, cnt, s.chunk, &s.n_roots, s.roots_r, s.sizes_r);
  topk_pick(s.roots_r, s.sizes_r, kr, k, s.sel);
  if (threadIdx.x == 0) *o.qual = n_roots;

  const WarpRed red{};
  const int lane = threadIdx.x & 31;
  for (int l = threadIdx.x >> 5; l < k; l += THREADS / 32) {
    const int j = s.sel[l];
    const int sz = s.sizes_r[j];
    const int root = s.roots_r[j];
    const int size = max(sz, 0);
    if (sz < 0 || twins.has(root, size)) {
      if (lane == 0) write_lane(o, l, nullptr, root, size, sz >= 0, pr);
      continue;
    }
    const LaneFit f = lane_chain(red, lab, P, wc, root, size, pr.ds, pr.slack);
    if (lane == 0) write_lane(o, l, &f, root, size, true, pr);
  }
  __syncthreads();
}

}  // namespace a3fit
