// Fit device code shared by kernel 2 (coarse_fit.cu) and kernels 5-7
// (fit.cu): one spelling of segment.fit_quads' exact float32 expressions.
//
// The pieces are the TPU fit's (aruco3_tpu/ops/fit_pallas.py):
//   * is_admitted_root, pool_slot, claim: the admission pre-filter
//     (_rank_prep, wrap-around offsets of segment.ADMIT_OFFSETS), a root's
//     slot in an ascending pool, warp-aggregated counts (kernels 2, 5-7);
//   * rank_pool: the raster rank of admitted roots and the (root, size)
//     pair of each rank below min(n_roots, kr) (_rank_pool), block-wide
//     (kernels 2 and 7; kernel 5 splits a frame over a cluster);
//   * topk_select: top-k of the pool by (size descending, pool position
//     ascending), the order of lax.top_k on the raster-ordered pool;
//   * lane_chain: one warp's centroid, extreme-point quad and containment
//     fraction of one lane over its member list (_lane_chain; kernels 2, 6
//     and 7);
//   * fit_plane: rank pool, top-k and lane chains in a row for one label
//     plane (kernel 2's tail and kernel 7).
// The build has no -rdc, so shared device code lives here, in a header.
//
// What bounds the fit on an H100: latency, not bytes.  In fit_plane a
// frame's label plane (in shared memory as uint16_t where the grid has
// fewer than 65,536 cells and it fits; else in device memory, with the
// scratch below) is read three times by one block: the admission pass (a warp per
// row, one ballot per 32 cells; the bits are kept, so each root's raster
// rank follows from one scan of the row counts), the count pass (each
// member cell finds its root's pool slot by binary search in the
// ascending pool; warp-aggregated atomics) and the scatter pass (the
// members of each selected lane to a compact list).  The top-k is a
// binary search for the k-th size (one barrier a step) plus a rank among
// the fewer than k larger entries, not a comparison of all kr^2 pairs.
// Each lane's chain (one warp per lane, five passes) then walks only its
// own members.  Every reduction is exact in any order: counts are
// integers, centroid sums are summed in double over half-integer cell
// centres, and every arg-max takes the first linear index among equal
// scores.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace a3fit {

constexpr int KR_MAX = 1024;  // rank pool of a fit_plane call (kernels 2 and 7)
constexpr int K_MAX = 128;    // lanes a fit_plane call selects
constexpr long long SMEM_MAX = 232448;  // dynamic shared memory a block may take

// Where a kernel keeps a frame's working state, as its launcher decides
// from the grid: dynamic shared memory of `smem` bytes a block (0: none)
// and device scratch of `scratch` ints a frame.  The a3_*_layout exports
// hand it to the wrappers, which size the scratch and the block from it.
struct Layout {
  bool in_smem;
  long long smem, scratch;
};

inline int put_layout(const Layout& l, long long* out) {
  out[0] = l.smem;
  out[1] = l.scratch;
  return 0;
}

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

// A label plane: cell p = y * wc + x lives at ptr[y * pitch + x]; T is
// int (device memory) or uint16_t (shared memory, when hc * wc < 65536).
template <class T>
struct Labels {
  const T* ptr;
  int hc, wc, pitch;
  __device__ __forceinline__ int at(int y, int x) const {
    return static_cast<int>(ptr[y * pitch + x]);
  }
};

// The ints of one fit_plane call's scratch (shared or device memory):
// roots_r, sizes_r and lane_of (kr each), the row counts (hc + 1), the
// admission bits (rank_pool_ints), the selection (K_MAX), lane offsets
// (K_MAX + 1), lane fills (K_MAX) and the top-k's counters (TOPK_INTS).
constexpr int TOPK_INTS = 64 + 2 * K_MAX + 32;
__host__ __device__ constexpr int rank_pool_ints(int hc, int wc) {
  return hc + 1 + hc * ((wc + 31) / 32);
}
__host__ __device__ constexpr int scratch_ints(int kr, int hc, int wc) {
  return 3 * kr + rank_pool_ints(hc, wc) + K_MAX + (K_MAX + 1) + K_MAX + TOPK_INTS;
}

struct FitScratch {
  int *roots_r, *sizes_r, *lane_of, *row_off, *sel, *lane_off, *fill, *topk;

  __device__ static FitScratch carve(int* base, int kr, int hc, int wc) {
    FitScratch s;
    s.roots_r = base;
    s.sizes_r = s.roots_r + kr;
    s.lane_of = s.sizes_r + kr;
    s.row_off = s.lane_of + kr;
    s.sel = s.row_off + rank_pool_ints(hc, wc);
    s.lane_off = s.sel + K_MAX;
    s.fill = s.lane_off + K_MAX + 1;
    s.topk = s.fill + K_MAX;
    return s;
  }
};

static __device__ __forceinline__ float cell_x(int p, int wc, int ds) {
  return static_cast<float>(p % wc) * static_cast<float>(ds) +
         static_cast<float>(ds - 1) * 0.5f;
}

static __device__ __forceinline__ float cell_y(int p, int wc, int ds) {
  return static_cast<float>(p / wc) * static_cast<float>(ds) +
         static_cast<float>(ds - 1) * 0.5f;
}

static __device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// A root whose same-label count at ADMIT_OFFSETS (wrapping around the
// grid, as jnp.roll does) reaches t - 1, t = min(min_px, 3).
template <class T>
static __device__ __forceinline__ bool is_admitted_root(const Labels<T>& lab, int y, int x,
                                                        int t) {
  const int l = lab.at(y, x);
  if (l != y * lab.wc + x) return false;
  if (t <= 1) return true;
  const int hc = lab.hc, wc = lab.wc;
  const int off2[2][2] = {{0, 1}, {1, 0}};
  const int off3[6][2] = {{0, 1}, {0, 2}, {1, -1}, {1, 0}, {1, 1}, {2, 0}};
  const int n = t == 2 ? 2 : 6;
  int cnt = 0;
  for (int i = 0; i < n; ++i) {
    const int dy = t == 2 ? off2[i][0] : off3[i][0];
    const int dx = t == 2 ? off2[i][1] : off3[i][1];
    const int yy = ((y + dy) % hc + hc) % hc;
    const int xx = ((x + dx) % wc + wc) % wc;
    cnt += lab.at(yy, xx) == l;
  }
  return cnt >= t - 1;
}

// Exclusive scan of a[0..n) in place by one whole warp; *total gets the sum.
static __device__ void warp_scan_inplace(int* a, int n, int* total) {
  const int lane = threadIdx.x & 31;
  const int c = (n + 31) / 32;
  const int i0 = min(n, lane * c), i1 = min(n, i0 + c);
  int mine = 0;
  for (int i = i0; i < i1; ++i) mine += a[i];
  int incl = mine;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  int run = incl - mine;
  for (int i = i0; i < i1; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  if (lane == 31) *total = incl;
  __syncwarp();
}

// Exclusive block-wide scan of one int a thread; wt is 32 ints of scratch.
// Every thread gets its prefix; *total the sum.  Contains barriers.
static __device__ int block_scan(int v, int* wt, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) wt[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = lane < nw ? wt[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t += o;
    }
    wt[lane] = t;
    if (lane == nw - 1) *total = t;
  }
  __syncthreads();
  const int out = (warp > 0 ? wt[warp - 1] : 0) + incl - v;
  __syncthreads();
  return out;
}

// Slot of root l in the ascending pool roots[0..n), or -1.
static __device__ __forceinline__ int pool_slot(const int* roots, int n, int l) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (roots[mid] < l) lo = mid + 1; else hi = mid;
  }
  return lo < n && roots[lo] == l ? lo : -1;
}

// Warp-aggregated atomicAdd(&ctr[s], 1) for the lanes whose s >= 0 (all
// 32 lanes call); each such lane gets its old value (distinct per lane).
static __device__ __forceinline__ int claim(int* ctr, int s) {
  const unsigned peers = __match_any_sync(0xffffffffu, s);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (s >= 0 && static_cast<int>(threadIdx.x & 31) == leader) base = atomicAdd(&ctr[s], __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  return base + __popc(peers & lanes_below());
}

// Block-wide rank pool of one label plane.  roots_r / sizes_r (kr each,
// shared or device memory) get the root and member count of raster rank j
// for j < min(n_roots, kr), and (0, -1) after; row_off is rank_pool_ints
// of scratch (row counts, then each row's admission bits, 32 cells a
// word).  Returns n_roots; ends with a barrier.
template <class T>
static __device__ int rank_pool(const Labels<T>& lab, int kr, int min_px, int* row_off,
                                int* roots_r, int* sizes_r) {
  const int hc = lab.hc, wc = lab.wc, P = hc * wc, nw = (wc + 31) / 32;
  const int t = min(min_px, 3);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  unsigned* adm = reinterpret_cast<unsigned*>(row_off + hc + 1);
  for (int y = warp; y < hc; y += nwarps) {
    int c = 0;
    for (int j = 0; j < nw; ++j) {
      const int x = 32 * j + lane;
      const unsigned bits = __ballot_sync(0xffffffffu, x < wc && is_admitted_root(lab, y, x, t));
      if (lane == 0) adm[y * nw + j] = bits;
      c += __popc(bits);
    }
    if (lane == 0) row_off[y] = c;
  }
  for (int j = threadIdx.x; j < kr; j += blockDim.x) sizes_r[j] = 0;
  __syncthreads();
  if (warp == 0) warp_scan_inplace(row_off, hc, row_off + hc);
  __syncthreads();
  const int n_roots = row_off[hc];
  const int n_pool = min(n_roots, kr);
  // Raster ranks: a thread a word of admission bits.
  for (int i = threadIdx.x; i < hc * nw; i += blockDim.x) {
    const int y = i / nw;
    const int j = i - y * nw;
    unsigned bits = adm[i];
    int rank = row_off[y];
    for (int jj = 0; jj < j && rank < kr; ++jj) rank += __popc(adm[y * nw + jj]);
    for (; bits && rank < kr; bits &= bits - 1, ++rank) roots_r[rank] = y * wc + 32 * j + __ffs(bits) - 1;
  }
  for (int j = n_pool + threadIdx.x; j < kr; j += blockDim.x) roots_r[j] = 0;
  __syncthreads();
  for (int y = warp; y < hc; y += nwarps) {
    for (int x0 = 0; x0 < wc; x0 += 32) {
      const int x = x0 + lane;
      const int l = x < wc ? lab.at(y, x) : P;
      claim(sizes_r, l < P ? pool_slot(roots_r, n_pool, l) : -1);
    }
  }
  __syncthreads();
  for (int j = n_pool + threadIdx.x; j < kr; j += blockDim.x) sizes_r[j] = -1;
  __syncthreads();
  return n_roots;
}

// sel[r] = pool index of the r-th pick, r < k <= kr: by size descending,
// then pool position ascending (the pool is in raster order, so this is
// the root order of lax.top_k's ties).  The k-th size T comes from a
// binary search on counts; the fewer than k entries above T are ranked
// among themselves, the entries equal to T in pool order by a block scan.
// tk is TOPK_INTS of scratch.  Block-wide; ends with a barrier.
static __device__ void topk_select(const int* sizes_r, int kr, int k, int* sel, int* tk) {
  int* cnt = tk;          // [0, 32): counts of the search steps; 32: max; 33: n above
  int* gs = tk + 64;      // sizes of the entries above T
  int* gj = gs + K_MAX;   // their pool positions
  int* wt = gj + K_MAX;   // block_scan scratch
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 64) tk[threadIdx.x] = 0;
  __syncthreads();
  // Each thread owns a contiguous chunk of the pool (block_scan below
  // needs pool order across threads).
  const int ch = (kr + blockDim.x - 1) / blockDim.x;
  const int j0 = min(kr, static_cast<int>(threadIdx.x) * ch), j1 = min(kr, j0 + ch);
  int mx = -1;
  for (int j = j0; j < j1; ++j) mx = max(mx, sizes_r[j]);
  for (int d = 16; d > 0; d >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, d));
  if (lane == 0) atomicMax(&cnt[32], mx);
  __syncthreads();
  int lo = -1, hi = cnt[32] + 1;  // count(size >= lo) >= k > count(size >= hi)
  for (int it = 0; hi - lo > 1; ++it) {
    const int mid = (lo + hi) >> 1;
    int c = 0;
    for (int j = j0; j < j1; ++j) c += sizes_r[j] >= mid;
    for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(0xffffffffu, c, d);
    if (lane == 0 && c) atomicAdd(&cnt[it], c);
    __syncthreads();
    if (cnt[it] >= k) lo = mid; else hi = mid;
  }
  const int T = lo;
  int eq = 0;
  for (int j = j0; j < j1; ++j) {
    const int s = sizes_r[j];
    eq += s == T;
    if (s > T) {
      const int g = atomicAdd(&cnt[33], 1);
      gs[g] = s;
      gj[g] = j;
    }
  }
  int total;
  int r = block_scan(eq, wt, &total);  // its barriers also publish gs, gj
  const int n_above = cnt[33];
  r += n_above;
  for (int j = j0; j < j1 && r < k; ++j) {
    if (sizes_r[j] != T) continue;
    sel[r++] = j;
  }
  for (int g = threadIdx.x; g < n_above; g += blockDim.x) {
    int rank = 0;
    for (int h = 0; h < n_above; ++h)
      rank += gs[h] > gs[g] || (gs[h] == gs[g] && gj[h] < gj[g]);
    sel[rank] = gj[g];
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

struct LaneFit {
  float qx[4], qy[4];  // corners A, B, C, D
  float cenx, ceny, frac;
};

// segment.fit_quads' chain for one lane of the given size (the divisor of
// its centroid and containment), by one warp over the lane's n >= 0
// member cells m[0..n): centroid, corner A farthest from it, corner C
// farthest from A, B and D the extremes of the cross product against
// A->C, then the fraction of members inside the quad expanded by slack *
// edge length.  Each arg-max takes the first cell among equal scores
// (cell 0 when the lane has no member, as the plain version's masked
// argmax does).
template <class Idx>
static __device__ __forceinline__ LaneFit lane_chain(const Idx* m, int n, int wc, int size,
                                                     int ds, float slack) {
  const int r0 = threadIdx.x & 31;
  const float szf = fmaxf(static_cast<float>(size), 1.0f);
  double sx = 0.0, sy = 0.0;
  for (int i = r0; i < n; i += 32) {
    const int p = static_cast<int>(m[i]);
    sx += static_cast<double>(cell_x(p, wc, ds));
    sy += static_cast<double>(cell_y(p, wc, ds));
  }
  LaneFit f;
  f.cenx = static_cast<float>(warp_sum(sx)) / szf;
  f.ceny = static_cast<float>(warp_sum(sy)) / szf;

  auto first = [](int i) { return i == 0x7fffffff ? 0 : i; };
  float bs = -INFINITY;
  int bi = 0x7fffffff;
  for (int i = r0; i < n; i += 32) {
    const int p = static_cast<int>(m[i]);
    const float dxx = cell_x(p, wc, ds) - f.cenx;
    const float dyy = cell_y(p, wc, ds) - f.ceny;
    amax_update(dxx * dxx + dyy * dyy, p, bs, bi);
  }
  warp_argmax_pair(bs, bi);
  const int ia = first(bi);
  const float ax = cell_x(ia, wc, ds), ay = cell_y(ia, wc, ds);

  bs = -INFINITY;
  bi = 0x7fffffff;
  for (int i = r0; i < n; i += 32) {
    const int p = static_cast<int>(m[i]);
    const float dxx = cell_x(p, wc, ds) - ax;
    const float dyy = cell_y(p, wc, ds) - ay;
    amax_update(dxx * dxx + dyy * dyy, p, bs, bi);
  }
  warp_argmax_pair(bs, bi);
  const int ic = first(bi);
  const float qcx = cell_x(ic, wc, ds), qcy = cell_y(ic, wc, ds);

  const float dx = qcx - ax;
  const float dy = qcy - ay;
  float bsb = -INFINITY, bsd = -INFINITY;
  int bib = 0x7fffffff, bid = 0x7fffffff;
  for (int i = r0; i < n; i += 32) {
    const int p = static_cast<int>(m[i]);
    const float cross = (cell_x(p, wc, ds) - ax) * dy - (cell_y(p, wc, ds) - ay) * dx;
    amax_update(cross, p, bsb, bib);
    amax_update(-cross, p, bsd, bid);
  }
  warp_argmax_pair(bsb, bib);
  warp_argmax_pair(bsd, bid);
  const int ib = first(bib);
  const int id = first(bid);

  float* qx = f.qx;
  float* qy = f.qy;
  qx[0] = ax; qy[0] = ay;
  qx[1] = cell_x(ib, wc, ds); qy[1] = cell_y(ib, wc, ds);
  qx[2] = qcx; qy[2] = qcy;
  qx[3] = cell_x(id, wc, ds); qy[3] = cell_y(id, wc, ds);

  // Containment in the expanded per-edge form of segment.fit_quads.
  float ex[4], ey[4], term[4];
  for (int e = 0; e < 4; ++e) {
    const int nx = (e + 1) & 3;
    ex[e] = qx[nx] - qx[e];
    ey[e] = qy[nx] - qy[e];
    term[e] = qx[e] * qy[nx] - qx[nx] * qy[e];
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
  for (int i = r0; i < n; i += 32) {
    const int p = static_cast<int>(m[i]);
    const float px = cell_x(p, wc, ds), py = cell_y(p, wc, ds);
    bool in = true;
    for (int e = 0; e < 4; ++e) in = in && (py * av[e] - px * bv[e] >= rhs[e]);
    inside += in;
  }
  f.frac = static_cast<float>(warp_sum(inside)) / szf;
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

// segment.fit_quads of one label plane: k <= K_MAX lanes from a pool of
// kr <= KR_MAX roots.  members holds at least hc * wc cell indices (Idx
// holds hc * wc).  Block-wide; ends with a barrier.
template <class T, class Idx>
static __device__ void fit_plane(const Labels<T>& lab, int k, int kr, const FitOut o,
                                 const FitScratch& s, Idx* members, const FitParams& pr,
                                 const Twins& twins) {
  const int hc = lab.hc, wc = lab.wc, P = hc * wc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int n_roots = rank_pool(lab, kr, pr.min_px, s.row_off, s.roots_r, s.sizes_r);
  const int n_pool = min(n_roots, kr);
  topk_select(s.sizes_r, kr, k, s.sel, s.topk);
  if (threadIdx.x == 0) *o.qual = n_roots;

  // Fitted lanes: their pool slots map to the lane, and their members get
  // consecutive ranges of the list.
  for (int j = threadIdx.x; j < kr; j += blockDim.x) s.lane_of[j] = -1;
  __syncthreads();
  if (warp == 0) {
    for (int l = lane; l < k; l += 32) {
      const int j = s.sel[l];
      const int sz = s.sizes_r[j];
      const bool fitted = sz >= 0 && !twins.has(s.roots_r[j], max(sz, 0));
      s.lane_off[l] = fitted ? sz : 0;
      s.fill[l] = 0;
      if (fitted) s.lane_of[j] = l;
    }
    __syncwarp();
    warp_scan_inplace(s.lane_off, k, s.lane_off + k);
  }
  __syncthreads();
  for (int y = warp; y < hc; y += nwarps) {
    for (int x0 = 0; x0 < wc; x0 += 32) {
      const int x = x0 + lane;
      const int l = x < wc ? lab.at(y, x) : P;
      const int slot = l < P ? pool_slot(s.roots_r, n_pool, l) : -1;
      const int r = slot >= 0 ? s.lane_of[slot] : -1;
      const int pos = claim(s.fill, r);
      if (r >= 0) members[s.lane_off[r] + pos] = static_cast<Idx>(y * wc + x);
    }
  }
  __syncthreads();

  for (int l = warp; l < k; l += nwarps) {
    const int j = s.sel[l];
    const int sz = s.sizes_r[j];
    const int root = s.roots_r[j];
    const int size = max(sz, 0);
    if (sz < 0 || twins.has(root, size)) {
      if (lane == 0) write_lane(o, l, nullptr, root, size, sz >= 0, pr);
      continue;
    }
    const LaneFit f = lane_chain(members + s.lane_off[l], size, wc, size, pr.ds, pr.slack);
    if (lane == 0) write_lane(o, l, &f, root, size, true, pr);
  }
  __syncthreads();
}

}  // namespace a3fit
