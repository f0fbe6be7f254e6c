// Kernel 2: coarse labelling of both planes and the quad fit of each.
//
// Replaces the TPU kernel aruco3_tpu/ops/coarse_pallas.py coarse_labels
// (pallas_call at :1470) with its fused fit tail _packed_fit_tail (:94),
// entered through aruco3_tpu/ops/fit_pallas.py fused_coarsefit_batch
// (:923).  Its specification is the XLA code it reproduces:
// segment.label_planes (hole fill, outer CCL, depth-peeled inner labels),
// segment.fit_quads on both label planes (size admission, raster rank
// pool, top-k by size, centroid, extreme-point quad, containment) and the
// dilated inner footprint _dilate3(labels2 < Hc*Wc).
//
// Semantics kept exactly: every flood and CCL is round-limited with
// synchronous rounds.  A flood round ORs the neighbours of the previous
// plane, then transports along whole row runs, then whole column runs; a
// CCL round takes the 4-neighbour min of the previous plane, then the full
// row-run min, then the full column-run min.  A forward and a backward
// serial scan give each cell the same full run min (or OR) the doubling
// scan computes.  Ties: top-k by size takes
// the lower pool index, each masked argmax the first cell.
//
// What bounds it on an H100: latency.  A 108x192 grid is small; the
// rounds (about 60 of them) are chains of dependent steps separated by
// block barriers, and the run transports are serial per row and column,
// written as uniform scans so that a warp's 32 rows never diverge.
// Design: one block of 1024 threads per frame, so a batch of 128 frames
// fills the card's 132 SMs once; the ten boolean planes the floods work
// on live in shared memory when they fit (10 byte planes with an odd-word
// row pitch, 212 KB at 1080p with ds = 10) and otherwise in global
// scratch; the int32 label
// planes are global scratch (L2-resident).  The fit gives each lane to one
// warp, which walks the plane with warp-shuffle reductions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int KR_MAX = 1024;
constexpr int K_MAX = 128;
constexpr int N_U8_PLANES = 10;
constexpr int N_INT_PLANES = 4;

// Cell p = y * wc + x is the linear index the labels carry; byte planes
// store it at y * pitch + x, with an odd number of 4-byte words per row so
// that the 32 rows a warp walks at once fall in 32 different banks.
struct Geo {
  int hc, wc, p, pitch;
};

__host__ __device__ __forceinline__ int byte_pitch(int wc) { return (((wc + 3) / 4) | 1) * 4; }

__device__ __forceinline__ int qof(int p, const Geo& g) {
  return p + (p / g.wc) * (g.pitch - g.wc);
}

struct FitOut {
  float* quads;   // (k, 4, 2)
  uint8_t* valid; // (k,)
  int* roots;     // (k,)
  float* cents;   // (k, 2)
  int* sizes;     // (k,)
  int* qual;      // ()
};

struct Params {
  int ds, k1, k2, kr1, kr2;
  int fill_rounds, ccl_rounds, bg_rounds, inner_depths;
  int inner_flood_rounds, inner_fill_rounds, inner_ccl_rounds;
  int min_px;
  float slack;  // containment_slack * ds
  float min_containment;
};

struct FitSmem {
  int chunk[THREADS];
  int roots_r[KR_MAX];
  int sizes_r[KR_MAX];
  int sel[K_MAX];
  int n_roots;
};

__device__ __forceinline__ bool on_border(int p, const Geo& g) {
  const int y = p / g.wc;
  const int x = p - y * g.wc;
  return y == 0 || y == g.hc - 1 || x == 0 || x == g.wc - 1;
}

__device__ __forceinline__ uint8_t dil3_at(const uint8_t* m, int p, const Geo& g) {
  const int y = p / g.wc;
  const int x = p - y * g.wc;
  uint8_t v = 0;
  for (int dy = -1; dy <= 1; ++dy) {
    const int yy = y + dy;
    if (yy < 0 || yy >= g.hc) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      const int xx = x + dx;
      if (xx < 0 || xx >= g.wc) continue;
      v |= m[yy * g.pitch + xx];
    }
  }
  return v;
}

// `reach` holds medium & seed on entry and the flood after `rounds`.
__device__ void flood(uint8_t* reach, const uint8_t* med, uint8_t* tmp,
                      int rounds, bool diag, const Geo& g) {
  const int hc = g.hc, wc = g.wc, pw = g.pitch;
  for (int it = 0; it < rounds; ++it) {
    for (int p = threadIdx.x; p < g.p; p += blockDim.x) {
      const int y = p / wc;
      const int x = p - y * wc;
      const int q = y * pw + x;
      uint8_t v = reach[q];
      if (y > 0) v |= reach[q - pw];
      if (y < hc - 1) v |= reach[q + pw];
      if (x > 0) v |= reach[q - 1];
      if (x < wc - 1) v |= reach[q + 1];
      if (diag) {
        if (y > 0 && x > 0) v |= reach[q - pw - 1];
        if (y > 0 && x < wc - 1) v |= reach[q - pw + 1];
        if (y < hc - 1 && x > 0) v |= reach[q + pw - 1];
        if (y < hc - 1 && x < wc - 1) v |= reach[q + pw + 1];
      }
      tmp[q] = v & med[q];
    }
    __syncthreads();
    // Run transport: a forward scan leaves each cell the OR of its run up
    // to it; a backward scan over those gives every cell its whole run's
    // OR.  One uniform loop per pass: no divergence inside a warp.
    for (int y = threadIdx.x; y < hc; y += blockDim.x) {
      uint8_t* r = tmp + y * pw;
      const uint8_t* m = med + y * pw;
      uint8_t acc = 0;
      for (int x = 0; x < wc; ++x) r[x] = acc = m[x] ? (acc | r[x]) : 0;
      acc = 0;
      for (int x = wc - 1; x >= 0; --x) r[x] = acc = m[x] ? (acc | r[x]) : 0;
    }
    __syncthreads();
    for (int x = threadIdx.x; x < wc; x += blockDim.x) {
      uint8_t acc = 0;
      for (int y = 0; y < hc; ++y) {
        const int q = y * pw + x;
        reach[q] = acc = med[q] ? (acc | tmp[q]) : 0;
      }
      acc = 0;
      for (int y = hc - 1; y >= 0; --y) {
        const int q = y * pw + x;
        reach[q] = acc = med[q] ? (acc | reach[q]) : 0;
      }
    }
    __syncthreads();
  }
}

// Round-limited 4-connected CCL of `blk`; lbl is (re)initialised here.
__device__ void ccl(int* lbl, const uint8_t* blk, int* tmpi, int rounds,
                    const Geo& g) {
  const int hc = g.hc, wc = g.wc, P = g.p, pw = g.pitch;
  for (int p = threadIdx.x; p < P; p += blockDim.x) lbl[p] = blk[qof(p, g)] ? p : P;
  __syncthreads();
  for (int it = 0; it < rounds; ++it) {
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      if (!blk[qof(p, g)]) { tmpi[p] = P; continue; }
      const int y = p / wc;
      const int x = p - y * wc;
      int m = lbl[p];
      if (y > 0) m = min(m, lbl[p - wc]);
      if (y < hc - 1) m = min(m, lbl[p + wc]);
      if (x > 0) m = min(m, lbl[p - 1]);
      if (x < wc - 1) m = min(m, lbl[p + 1]);
      tmpi[p] = m;
    }
    __syncthreads();
    // Run mins by a forward and a backward scan, as in flood().
    for (int y = threadIdx.x; y < hc; y += blockDim.x) {
      int* r = tmpi + y * wc;
      const uint8_t* m = blk + y * pw;
      int acc = P;
      for (int x = 0; x < wc; ++x) r[x] = acc = m[x] ? min(acc, r[x]) : P;
      acc = P;
      for (int x = wc - 1; x >= 0; --x) r[x] = acc = m[x] ? min(acc, r[x]) : P;
    }
    __syncthreads();
    for (int x = threadIdx.x; x < wc; x += blockDim.x) {
      int acc = P;
      for (int y = 0; y < hc; ++y) {
        lbl[y * wc + x] = acc = blk[y * pw + x] ? min(acc, tmpi[y * wc + x]) : P;
      }
      acc = P;
      for (int y = hc - 1; y >= 0; --y) {
        lbl[y * wc + x] = acc = blk[y * pw + x] ? min(acc, lbl[y * wc + x]) : P;
      }
    }
    __syncthreads();
  }
}

// Admission of fit_quads: a root whose same-label count at ADMIT_OFFSETS
// (wrapping around the grid, as jnp.roll does) reaches t - 1.
__device__ bool is_admitted_root(const int* lab, int p, int t, const Geo& g) {
  const int l = lab[p];
  if (l != p) return false;
  if (t <= 1) return true;
  const int y = p / g.wc;
  const int x = p - y * g.wc;
  const int off2[2][2] = {{0, 1}, {1, 0}};
  const int off3[6][2] = {{0, 1}, {0, 2}, {1, -1}, {1, 0}, {1, 1}, {2, 0}};
  const int n = t == 2 ? 2 : 6;
  int cnt = 0;
  for (int i = 0; i < n; ++i) {
    const int dy = t == 2 ? off2[i][0] : off3[i][0];
    const int dx = t == 2 ? off2[i][1] : off3[i][1];
    const int yy = ((y + dy) % g.hc + g.hc) % g.hc;
    const int xx = ((x + dx) % g.wc + g.wc) % g.wc;
    cnt += lab[yy * g.wc + xx] == l;
  }
  return cnt >= t - 1;
}

__device__ __forceinline__ void amax_update(float s, int i, float& bs, int& bi) {
  if (s > bs || (s == bs && i < bi)) { bs = s; bi = i; }
}

__device__ __forceinline__ int warp_argmax(float bs, int bi) {
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, bs, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    amax_update(os, oi, bs, bi);
  }
  return __shfl_sync(0xffffffffu, bi, 0);
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

__device__ __forceinline__ int warp_sum_i(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

__device__ __forceinline__ float cell_x(int p, const Geo& g, int ds) {
  return static_cast<float>(p % g.wc) * static_cast<float>(ds) +
         static_cast<float>(ds - 1) * 0.5f;
}
__device__ __forceinline__ float cell_y(int p, const Geo& g, int ds) {
  return static_cast<float>(p / g.wc) * static_cast<float>(ds) +
         static_cast<float>(ds - 1) * 0.5f;
}

// segment.fit_quads of one label plane, k lanes from a pool of kr roots.
__device__ void fit_quads(const int* lab, int k, int kr, const FitOut o,
                          int* cnt, FitSmem& s, const Geo& g, const Params& pr) {
  const int P = g.p;
  const int t = min(pr.min_px, 3);
  for (int p = threadIdx.x; p < P; p += blockDim.x) cnt[p] = 0;
  __syncthreads();
  const int cs = (P + blockDim.x - 1) / blockDim.x;
  const int c0 = threadIdx.x * cs;
  const int c1 = min(P, c0 + cs);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int l = lab[p];
    if (l < P) atomicAdd(&cnt[l], 1);
  }
  int mine = 0;
  for (int p = c0; p < c1; ++p) mine += is_admitted_root(lab, p, t, g);
  s.chunk[threadIdx.x] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int i = 0; i < static_cast<int>(blockDim.x); ++i) {
      const int c = s.chunk[i];
      s.chunk[i] = run;
      run += c;
    }
    s.n_roots = run;
  }
  __syncthreads();
  const int n_roots = s.n_roots;
  int rank = s.chunk[threadIdx.x];
  for (int p = c0; p < c1 && rank < kr; ++p) {
    if (is_admitted_root(lab, p, t, g)) s.roots_r[rank++] = p;
  }
  for (int j = min(n_roots, kr) + threadIdx.x; j < kr; j += blockDim.x) s.roots_r[j] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < kr; j += blockDim.x)
    s.sizes_r[j] = j < n_roots ? cnt[s.roots_r[j]] : -1;
  __syncthreads();
  // Top-k by size, ties to the lower pool index (jax.lax.top_k's order).
  for (int j = threadIdx.x; j < kr; j += blockDim.x) {
    const int sj = s.sizes_r[j];
    int r = 0;
    for (int i = 0; i < kr; ++i) {
      const int si = s.sizes_r[i];
      r += (si > sj) || (si == sj && i < j);
    }
    if (r < k) s.sel[r] = j;
  }
  __syncthreads();
  if (threadIdx.x == 0) *o.qual = n_roots;

  const int lane = threadIdx.x & 31;
  const int ds = pr.ds;
  for (int l = threadIdx.x >> 5; l < k; l += WARPS) {
    const int j = s.sel[l];
    const int sz = s.sizes_r[j];
    const int root = s.roots_r[j];
    const int size = max(sz, 0);
    const float szf = fmaxf(static_cast<float>(size), 1.0f);
    if (sz < 0) {
      // Unused lane: no member, every masked argmax is cell 0.
      if (lane == 0) {
        const float x0 = cell_x(0, g, ds), y0 = cell_y(0, g, ds);
        for (int c = 0; c < 4; ++c) {
          o.quads[(l * 4 + c) * 2] = x0;
          o.quads[(l * 4 + c) * 2 + 1] = y0;
        }
        o.valid[l] = 0;
        o.roots[l] = root;
        o.cents[l * 2] = 0.0f;
        o.cents[l * 2 + 1] = 0.0f;
        o.sizes[l] = 0;
      }
      continue;
    }
    double sx = 0.0, sy = 0.0;
    for (int p = lane; p < P; p += 32) {
      if (lab[p] != root) continue;
      sx += static_cast<double>(cell_x(p, g, ds));
      sy += static_cast<double>(cell_y(p, g, ds));
    }
    const float cenx = static_cast<float>(warp_sum(sx)) / szf;
    const float ceny = static_cast<float>(warp_sum(sy)) / szf;

    float bs = -INFINITY;
    int bi = 0x7fffffff;
    for (int p = lane; p < P; p += 32) {
      if (lab[p] != root) continue;
      const float dxx = cell_x(p, g, ds) - cenx;
      const float dyy = cell_y(p, g, ds) - ceny;
      amax_update(dxx * dxx + dyy * dyy, p, bs, bi);
    }
    const int ia = warp_argmax(bs, bi);
    const float ax = cell_x(ia, g, ds), ay = cell_y(ia, g, ds);

    bs = -INFINITY;
    bi = 0x7fffffff;
    for (int p = lane; p < P; p += 32) {
      if (lab[p] != root) continue;
      const float dxx = cell_x(p, g, ds) - ax;
      const float dyy = cell_y(p, g, ds) - ay;
      amax_update(dxx * dxx + dyy * dyy, p, bs, bi);
    }
    const int ic = warp_argmax(bs, bi);
    const float qcx = cell_x(ic, g, ds), qcy = cell_y(ic, g, ds);

    const float dx = qcx - ax;
    const float dy = qcy - ay;
    float bsb = -INFINITY, bsd = -INFINITY;
    int bib = 0x7fffffff, bid = 0x7fffffff;
    for (int p = lane; p < P; p += 32) {
      if (lab[p] != root) continue;
      const float cross = (cell_x(p, g, ds) - ax) * dy - (cell_y(p, g, ds) - ay) * dx;
      amax_update(cross, p, bsb, bib);
      amax_update(-cross, p, bsd, bid);
    }
    const int ib = warp_argmax(bsb, bib);
    const int id = warp_argmax(bsd, bid);

    float qx[4], qy[4];
    qx[0] = ax; qy[0] = ay;
    qx[1] = cell_x(ib, g, ds); qy[1] = cell_y(ib, g, ds);
    qx[2] = qcx; qy[2] = qcy;
    qx[3] = cell_x(id, g, ds); qy[3] = cell_y(id, g, ds);

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
      rhs[e] = -pr.slack * elen - c0e;
    }
    int inside = 0;
    for (int p = lane; p < P; p += 32) {
      if (lab[p] != root) continue;
      const float px = cell_x(p, g, ds), py = cell_y(p, g, ds);
      bool in = true;
      for (int e = 0; e < 4; ++e) in = in && (py * av[e] - px * bv[e] >= rhs[e]);
      inside += in;
    }
    const float frac = static_cast<float>(warp_sum_i(inside)) / szf;
    if (lane == 0) {
      for (int c = 0; c < 4; ++c) {
        o.quads[(l * 4 + c) * 2] = qx[c];
        o.quads[(l * 4 + c) * 2 + 1] = qy[c];
      }
      o.valid[l] = (size >= pr.min_px) && (frac >= pr.min_containment);
      o.roots[l] = root;
      o.cents[l * 2] = cenx;
      o.cents[l * 2 + 1] = ceny;
      o.sizes[l] = size;
    }
  }
  __syncthreads();
}

__device__ FitOut frame_out(float* quads, uint8_t* valid, int* roots, float* cents,
                            int* sizes, int* qual, int b, int k) {
  FitOut o;
  o.quads = quads + static_cast<size_t>(b) * k * 8;
  o.valid = valid + static_cast<size_t>(b) * k;
  o.roots = roots + static_cast<size_t>(b) * k;
  o.cents = cents + static_cast<size_t>(b) * k * 2;
  o.sizes = sizes + static_cast<size_t>(b) * k;
  o.qual = qual + b;
  return o;
}

__global__ void __launch_bounds__(THREADS)
coarse_fit_kernel(const uint8_t* __restrict__ coarse, float* quads1, uint8_t* valid1,
                  int* roots1, float* cents1, int* sizes1, int* qual1, float* quads2,
                  uint8_t* valid2, int* roots2, float* cents2, int* sizes2, int* qual2,
                  uint8_t* inner_coarse, int* scratch_i, uint8_t* scratch_u8,
                  int hc, int wc, Params pr, int u8_in_smem) {
  extern __shared__ uint8_t dyn[];
  __shared__ FitSmem fs;
  const int b = blockIdx.x;
  Geo g;
  g.hc = hc;
  g.wc = wc;
  g.p = hc * wc;
  g.pitch = byte_pitch(wc);
  const int P = g.p;
  const int Q = hc * g.pitch;  // bytes of one byte plane
  const uint8_t* C = coarse + static_cast<size_t>(b) * P;
  uint8_t* base8 = u8_in_smem ? dyn : scratch_u8 + static_cast<size_t>(b) * N_U8_PLANES * Q;
  uint8_t* WHITE = base8;
  uint8_t* R = base8 + Q;
  uint8_t* TMP = base8 + 2 * Q;
  uint8_t* F1 = base8 + 3 * Q;
  uint8_t* BG = base8 + 4 * Q;     // later: the CCL mask of a peel depth
  uint8_t* M2 = base8 + 5 * Q;     // first: the coarse mask itself
  uint8_t* KNOWN = base8 + 6 * Q;
  uint8_t* LEV = base8 + 7 * Q;
  uint8_t* OK = base8 + 8 * Q;     // later: the complement of a level
  uint8_t* REM = base8 + 9 * Q;
  int* basei = scratch_i + static_cast<size_t>(b) * N_INT_PLANES * P;
  int* LABA = basei;
  int* LAB2 = basei + P;
  int* TMPI = basei + 2 * P;
  int* CNT = basei + 3 * P;

  // Outer pass: fill_holes, then the CCL of the filled plane.
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int q = qof(p, g);
    const uint8_t w = !C[p];
    WHITE[q] = w;
    R[q] = w && on_border(p, g);
    M2[q] = C[p];
  }
  __syncthreads();
  flood(R, WHITE, TMP, pr.fill_rounds, true, g);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int q = qof(p, g);
    F1[q] = M2[q] | (WHITE[q] & !R[q]);
  }
  __syncthreads();
  ccl(LABA, F1, TMPI, pr.ccl_rounds, g);
  fit_quads(LABA, pr.k1, pr.kr1,
            frame_out(quads1, valid1, roots1, cents1, sizes1, qual1, b, pr.k1), CNT,
            fs, g, pr);

  uint8_t* IC = inner_coarse + static_cast<size_t>(b) * P;
  if (pr.k2 <= 0) {
    for (int p = threadIdx.x; p < P; p += blockDim.x) IC[p] = 0;
    return;
  }

  // Inner pass (segment.label_planes): background, known outside, depth 0.
  for (int p = threadIdx.x; p < P; p += blockDim.x) BG[qof(p, g)] = C[p] && on_border(p, g);
  __syncthreads();
  flood(BG, M2, TMP, pr.bg_rounds, false, g);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int q = qof(p, g);
    M2[q] = M2[q] & !BG[q];
    KNOWN[q] = WHITE[q] & (on_border(p, g) | dil3_at(BG, p, g));
  }
  __syncthreads();
  flood(KNOWN, WHITE, TMP, pr.fill_rounds, true, g);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int q = qof(p, g);
    LEV[q] = M2[q] & dil3_at(KNOWN, p, g);
  }
  __syncthreads();
  flood(LEV, M2, TMP, pr.inner_flood_rounds, false, g);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int q = qof(p, g);
    OK[q] = LEV[q] && LABA[p] == p;
  }
  __syncthreads();
  flood(OK, F1, TMP, pr.ccl_rounds, false, g);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int q = qof(p, g);
    const uint8_t ok = OK[q] & LEV[q];
    LAB2[p] = ok ? LABA[p] : P;
    REM[q] = M2[q] & !ok;
    KNOWN[q] = KNOWN[q] | (dil3_at(LEV, p, g) & WHITE[q]);
  }
  __syncthreads();
  flood(KNOWN, WHITE, TMP, pr.inner_flood_rounds, true, g);

  uint8_t* NOTLEV = OK;
  uint8_t* BLK = BG;
  for (int depth = 1; depth < pr.inner_depths; ++depth) {
    int any = 0;
    for (int p = threadIdx.x; p < P; p += blockDim.x) any |= REM[qof(p, g)];
    if (!__syncthreads_or(any)) break;  // an exhausted peel changes nothing
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const int q = qof(p, g);
      LEV[q] = REM[q] & dil3_at(KNOWN, p, g);
    }
    __syncthreads();
    flood(LEV, REM, TMP, pr.inner_flood_rounds, false, g);
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const int q = qof(p, g);
      NOTLEV[q] = !LEV[q];
      R[q] = KNOWN[q] & !LEV[q];
    }
    __syncthreads();
    flood(R, NOTLEV, TMP, pr.inner_fill_rounds, true, g);
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const int q = qof(p, g);
      BLK[q] = !R[q];
    }
    __syncthreads();
    ccl(LABA, BLK, TMPI, pr.inner_ccl_rounds, g);
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const int q = qof(p, g);
      if (LEV[q]) LAB2[p] = LABA[p];
      REM[q] = REM[q] & !LEV[q];
      KNOWN[q] = KNOWN[q] | (dil3_at(LEV, p, g) & WHITE[q]);
    }
    __syncthreads();
    flood(KNOWN, WHITE, TMP, pr.inner_flood_rounds, true, g);
  }

  fit_quads(LAB2, pr.k2, pr.kr2,
            frame_out(quads2, valid2, roots2, cents2, sizes2, qual2, b, pr.k2), CNT,
            fs, g, pr);
  for (int p = threadIdx.x; p < P; p += blockDim.x) TMP[qof(p, g)] = LAB2[p] < P;
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) IC[p] = dil3_at(TMP, p, g);
}

}  // namespace

// Shared memory the u8 planes may take beside the fit's static arrays.
constexpr size_t kSmemBudget = 227 * 1024 - sizeof(FitSmem) - 1024;

// coarse (B,hc,wc) 0/1 bytes -> both fits and inner_coarse.  Scratch per
// frame: 4*hc*wc ints and 10*hc*(wc+8) bytes (the bytes go unused when the
// planes fit in shared memory).  Returns cudaGetLastError().
extern "C" int a3_coarse_fit(
    const uint8_t* coarse, float* quads1, uint8_t* valid1, int* roots1, float* cents1,
    int* sizes1, int* qual1, float* quads2, uint8_t* valid2, int* roots2,
    float* cents2, int* sizes2, int* qual2, uint8_t* inner_coarse, int* scratch_i,
    uint8_t* scratch_u8, int B, int hc, int wc, int ds, int k1, int k2, int kr1,
    int kr2, int fill_rounds, int ccl_rounds, int bg_rounds, int inner_depths,
    int inner_flood_rounds, int inner_fill_rounds, int inner_ccl_rounds,
    float slack, float min_containment, int min_px, cudaStream_t stream) {
  if (k1 > K_MAX || k2 > K_MAX || kr1 > KR_MAX || kr2 > KR_MAX) return cudaErrorInvalidValue;
  Params pr;
  pr.ds = ds; pr.k1 = k1; pr.k2 = k2; pr.kr1 = kr1; pr.kr2 = kr2;
  pr.fill_rounds = fill_rounds; pr.ccl_rounds = ccl_rounds; pr.bg_rounds = bg_rounds;
  pr.inner_depths = inner_depths; pr.inner_flood_rounds = inner_flood_rounds;
  pr.inner_fill_rounds = inner_fill_rounds; pr.inner_ccl_rounds = inner_ccl_rounds;
  pr.min_px = min_px; pr.slack = slack; pr.min_containment = min_containment;
  const size_t u8_bytes = static_cast<size_t>(N_U8_PLANES) * hc * byte_pitch(wc);
  const int in_smem = u8_bytes <= kSmemBudget;
  const size_t smem = in_smem ? u8_bytes : 0;
  cudaError_t e = cudaFuncSetAttribute(coarse_fit_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  coarse_fit_kernel<<<B, THREADS, smem, stream>>>(
      coarse, quads1, valid1, roots1, cents1, sizes1, qual1, quads2, valid2, roots2,
      cents2, sizes2, qual2, inner_coarse, scratch_i, scratch_u8, hc, wc, pr, in_smem);
  return cudaGetLastError();
}
