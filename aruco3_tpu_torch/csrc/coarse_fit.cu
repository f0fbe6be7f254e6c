// Kernel 2: coarse labelling of both planes and, in its fit mode, the quad
// fit of each.
//
// Replaces the TPU kernel aruco3_tpu/ops/coarse_pallas.py coarse_labels
// (pallas_call at :1470).  Fit mode (a3_coarse_fit) is that kernel with its
// fused fit tail _packed_fit_tail (:94), entered through
// aruco3_tpu/ops/fit_pallas.py fused_coarsefit_batch (:923); labels mode
// (a3_coarse_labels) is coarse_labels with fit_cfg=None (:872) and writes
// the two label planes out.  Its specification is the XLA code it
// reproduces: segment.label_planes (hole fill, outer CCL, depth-peeled
// inner labels), segment.fit_quads on both label planes (size admission,
// raster rank pool, top-k by size, centroid, extreme-point quad,
// containment; fit_common.cuh) and the dilated inner footprint
// _dilate3(labels2 < Hc*Wc).
//
// Semantics kept exactly: every flood and CCL is round-limited with
// synchronous rounds.  A flood round ORs the neighbours of the previous
// plane, then transports along whole row runs, then whole column runs; a
// CCL round takes the 4-neighbour min of the previous plane, then the full
// row-run min, then the full column-run min.  A forward and a backward
// serial scan give each cell the same full run min (or OR) the doubling
// scan computes.  Ties: top-k by size takes the lower root, each masked
// argmax the first cell.
//
// What bounds it on an H100: latency.  A 108x192 grid is small; the
// rounds (about 60 of them) are chains of dependent steps separated by
// block barriers, and the run transports are serial per row and column,
// written as uniform scans so that a warp's 32 rows never diverge.
// Design: one block of 1024 threads per frame, so a batch of 128 frames
// fills the card's 132 SMs once; the ten boolean planes the floods work
// on live in shared memory when they fit (10 byte planes with an odd-word
// row pitch, 212 KB at 1080p with ds = 10) and otherwise in global
// scratch; the int32 label planes are global scratch (L2-resident).  The
// fit gives each lane to one warp, which walks the plane with warp-shuffle
// reductions.

#include "fit_common.cuh"

namespace {

using a3fit::FitOut;
using a3fit::FitParams;
using a3fit::FitPtrs;

constexpr int THREADS = 1024;
constexpr int N_U8_PLANES = 10;
constexpr int N_INT_PLANES = 4;

using FitSmem = a3fit::FitSmem<THREADS>;

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

struct Params {
  int k1, k2, kr1, kr2;
  int fill_rounds, ccl_rounds, bg_rounds, inner_depths;
  int inner_flood_rounds, inner_fill_rounds, inner_ccl_rounds;
  FitParams fit;
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

__global__ void __launch_bounds__(THREADS)
coarse_kernel(const uint8_t* __restrict__ coarse, FitPtrs fit1, FitPtrs fit2,
              uint8_t* inner_coarse, int* labels1, int* labels2, int* scratch_i,
              uint8_t* scratch_u8, int hc, int wc, Params pr, int u8_in_smem) {
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
  // Labels mode (labels1 given): no fit; the inner plane is built in place
  // in its output and the outer plane copied out before the peel's CCLs
  // reuse LABA.
  const bool labels_only = labels1 != nullptr;
  int* LAB2 = labels_only ? labels2 + static_cast<size_t>(b) * P : basei + P;
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
  const a3fit::Twins none = {nullptr, nullptr, nullptr, 0};
  if (labels_only) {
    int* L1 = labels1 + static_cast<size_t>(b) * P;
    for (int p = threadIdx.x; p < P; p += blockDim.x) L1[p] = LABA[p];
    if (pr.k2 <= 0) {
      for (int p = threadIdx.x; p < P; p += blockDim.x) LAB2[p] = P;
      return;
    }
  } else {
    a3fit::fit_plane(LABA, hc, wc, pr.k1, pr.kr1, fit1.frame(b, pr.k1), CNT, fs, pr.fit, none);
    if (pr.k2 <= 0) {
      uint8_t* IC = inner_coarse + static_cast<size_t>(b) * P;
      for (int p = threadIdx.x; p < P; p += blockDim.x) IC[p] = 0;
      return;
    }
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

  if (labels_only) return;
  a3fit::fit_plane(LAB2, hc, wc, pr.k2, pr.kr2, fit2.frame(b, pr.k2), CNT, fs, pr.fit, none);
  uint8_t* IC = inner_coarse + static_cast<size_t>(b) * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) TMP[qof(p, g)] = LAB2[p] < P;
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) IC[p] = dil3_at(TMP, p, g);
}

// Shared memory the u8 planes may take beside the fit's static arrays.
constexpr size_t kSmemBudget = 227 * 1024 - sizeof(FitSmem) - 1024;

int launch(const uint8_t* coarse, FitPtrs fit1, FitPtrs fit2, uint8_t* inner_coarse,
           int* labels1, int* labels2, int* scratch_i, uint8_t* scratch_u8, int B, int hc,
           int wc, const Params& pr, cudaStream_t stream) {
  const size_t u8_bytes = static_cast<size_t>(N_U8_PLANES) * hc * byte_pitch(wc);
  const int in_smem = u8_bytes <= kSmemBudget;
  const size_t smem = in_smem ? u8_bytes : 0;
  cudaError_t e = cudaFuncSetAttribute(coarse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  coarse_kernel<<<B, THREADS, smem, stream>>>(coarse, fit1, fit2, inner_coarse, labels1, labels2,
                                              scratch_i, scratch_u8, hc, wc, pr, in_smem);
  return cudaGetLastError();
}

Params round_params(int fill_rounds, int ccl_rounds, int bg_rounds, int inner_depths,
                    int inner_flood_rounds, int inner_fill_rounds, int inner_ccl_rounds) {
  Params pr = {};
  pr.fill_rounds = fill_rounds; pr.ccl_rounds = ccl_rounds; pr.bg_rounds = bg_rounds;
  pr.inner_depths = inner_depths; pr.inner_flood_rounds = inner_flood_rounds;
  pr.inner_fill_rounds = inner_fill_rounds; pr.inner_ccl_rounds = inner_ccl_rounds;
  return pr;
}

}  // namespace

// Fit mode: coarse (B,hc,wc) 0/1 bytes -> both fits and inner_coarse.
// Scratch per frame: 4*hc*wc ints and 10*hc*(wc+8) bytes (the bytes go
// unused when the planes fit in shared memory).  Returns
// cudaGetLastError().
extern "C" int a3_coarse_fit(
    const uint8_t* coarse, float* quads1, uint8_t* valid1, int* roots1, float* cents1,
    int* sizes1, int* qual1, float* quads2, uint8_t* valid2, int* roots2,
    float* cents2, int* sizes2, int* qual2, uint8_t* inner_coarse, int* scratch_i,
    uint8_t* scratch_u8, int B, int hc, int wc, int ds, int k1, int k2, int kr1,
    int kr2, int fill_rounds, int ccl_rounds, int bg_rounds, int inner_depths,
    int inner_flood_rounds, int inner_fill_rounds, int inner_ccl_rounds,
    float slack, float min_containment, int min_px, cudaStream_t stream) {
  if (k1 > a3fit::K_MAX || k2 > a3fit::K_MAX || kr1 > a3fit::KR_MAX || kr2 > a3fit::KR_MAX)
    return cudaErrorInvalidValue;
  Params pr = round_params(fill_rounds, ccl_rounds, bg_rounds, inner_depths,
                           inner_flood_rounds, inner_fill_rounds, inner_ccl_rounds);
  pr.k1 = k1; pr.k2 = k2; pr.kr1 = kr1; pr.kr2 = kr2;
  pr.fit.ds = ds; pr.fit.min_px = min_px; pr.fit.slack = slack;
  pr.fit.min_containment = min_containment;
  const FitPtrs fit1 = {quads1, valid1, roots1, cents1, sizes1, qual1};
  const FitPtrs fit2 = {quads2, valid2, roots2, cents2, sizes2, qual2};
  return launch(coarse, fit1, fit2, inner_coarse, nullptr, nullptr, scratch_i, scratch_u8, B,
                hc, wc, pr, stream);
}

// Labels mode: coarse (B,hc,wc) 0/1 bytes -> labels1, labels2 (B,hc,wc)
// int32 with sentinel hc*wc; labels2 is all sentinel unless `inner`.
// Scratch as for a3_coarse_fit.  Returns cudaGetLastError().
extern "C" int a3_coarse_labels(const uint8_t* coarse, int* labels1, int* labels2,
                                int* scratch_i, uint8_t* scratch_u8, int B, int hc, int wc,
                                int inner, int fill_rounds, int ccl_rounds, int bg_rounds,
                                int inner_depths, int inner_flood_rounds, int inner_fill_rounds,
                                int inner_ccl_rounds, cudaStream_t stream) {
  Params pr = round_params(fill_rounds, ccl_rounds, bg_rounds, inner_depths,
                           inner_flood_rounds, inner_fill_rounds, inner_ccl_rounds);
  pr.k2 = inner ? 1 : 0;
  const FitPtrs none = {};
  return launch(coarse, none, none, nullptr, labels1, labels2, scratch_i, scratch_u8, B, hc, wc,
                pr, stream);
}
