// Kernel 3: full-resolution corner refinement.
//
// Replaces the TPU kernel aruco3_tpu/ops/refine_pallas.py refine_eval
// (pallas_call at :391), entered through refine_corners_batch (:414).  Its
// specification is segment.refine_corners: for each corner of a valid
// lane, in the wn x wn window at clip(round(q) - wn/2, 0, max(dim - wn, 0))
// (round half to even), a pixel is ink when its grey value is below the
// window mean (the exact integer sum of the window's pixels inside the
// image divided by wn^2 in float32) and the near mask is set (on inner
// lanes also the upsampled inner footprint); among ink pixels within
// ds + 2 of the coarse corner the one maximising x * dir0 + y * dir1
// wins, the first in row-major order on ties; a window without such a
// pixel keeps the coarse corner.  dir = (q - c) / (|q - c| + 1e-6) from
// the corner q and the lane's centroid c, as segment.corner_dirs.
//
// What bounds it on an H100: latency and bytes of scattered windows, not
// arithmetic.  A 1080p batch of 128 frames has about 4,000 valid windows
// of 28 x 28 pixels.  Design: a warp per window, eight windows (two
// lanes) a block, so an invalid lane costs its warps one byte test.  A
// thread takes one window row (two for wn > 32) and reads it once, grey and
// near, as 16-byte chunks all issued before any is used; the row's bytes
// stay in registers.  A window wider than 64 (a QuadParams.refine_window
// set by hand) goes in strips of 64 columns, a thread's rows read once for
// the sum and again to score.  The
// mean comes from an exact integer sum (__vsadu4 per word, then shuffles).
// The ink test runs four pixels a word: g < mean is g < ceil(mean) for
// integer g, a byte compare (__vcmpltu4); the ink of a row becomes a
// 64-bit column mask (with near, the clamp box and, on inner lanes, one
// footprint lookup per coarse cell the row crosses), and only its set bits
// are scored.  Built with -fmad=false so the directions round as the
// reference's separate multiplies and adds do; the score's one fma is
// explicit (XLA's contraction of x * d0 + y * d1 on the CPU).
//
// A chunk is read whole only where it holds a byte of the row inside the
// image: an aligned 16-byte chunk never crosses an allocation's end
// (allocations are aligned to far more than 16 bytes), and the bytes
// outside the row are masked.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void amax_update(float s, int i, float& bs, int& bi) {
  if (s > bs || (s == bs && i < bi)) {
    bs = s;
    bi = i;
  }
}

// 0/1 bytes of a word -> 4 bits (byte k to bit k).
__device__ __forceinline__ uint32_t nibble(uint32_t v) {
  return ((v & 0x01010101u) * 0x10204080u) >> 28;
}

// Bits [off, off + 64) of the 96-bit value p0 | p1 << 32 | p2 << 64.
__device__ __forceinline__ uint64_t window64(uint32_t p0, uint32_t p1, uint32_t p2, int off) {
  return static_cast<uint64_t>(__funnelshift_r(p0, p1, off)) |
         static_cast<uint64_t>(__funnelshift_r(p1, p2, off)) << 32;
}

// Bits [lo, hi) of a 64-bit mask, 0 <= lo <= hi <= 64.
__device__ __forceinline__ uint64_t bit_range(int lo, int hi) {
  const uint64_t below_hi = hi >= 64 ? ~0ull : (1ull << hi) - 1;
  return below_hi & ~((1ull << lo) - 1);
}

// One window row as read from device memory: CH aligned 16-byte chunks of
// grey, and of near packed to one bit a byte as a column mask.
template <int CH>
struct Row {
  uint32_t g[CH * 4];
  uint64_t near;
  int goff;  // the row's first byte in its first chunk
  bool in;   // a row of the window inside the image
};

// The chunks of grey and near that hold bytes of the row [a, a + ncols).
template <int CH>
__device__ __forceinline__ void fetch(uint4 (&gv)[CH], uint4 (&nv)[CH], bool in,
                                      const uint8_t* g, const uint8_t* nm, int ncols) {
  const uintptr_t ga = reinterpret_cast<uintptr_t>(g);
  const uintptr_t na = reinterpret_cast<uintptr_t>(nm);
  const uint4* gc = reinterpret_cast<const uint4*>(ga & ~uintptr_t(15));
  const uint4* nc = reinterpret_cast<const uint4*>(na & ~uintptr_t(15));
  const int goff = static_cast<int>(ga & 15);
  const int noff = static_cast<int>(na & 15);
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    gv[j] = (in && 16 * j < goff + ncols) ? __ldg(gc + j) : make_uint4(0, 0, 0, 0);
    nv[j] = (in && 16 * j < noff + ncols) ? __ldg(nc + j) : make_uint4(0, 0, 0, 0);
  }
}

template <int CH>
__device__ __forceinline__ void pack(Row<CH>& row, const uint4 (&gv)[CH], const uint4 (&nv)[CH],
                                     const uint8_t* g, const uint8_t* nm) {
  row.goff = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
  uint32_t p[3] = {0, 0, 0};
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    row.g[4 * j] = gv[j].x;
    row.g[4 * j + 1] = gv[j].y;
    row.g[4 * j + 2] = gv[j].z;
    row.g[4 * j + 3] = gv[j].w;
    const uint32_t nib = nibble(nv[j].x) | nibble(nv[j].y) << 4 | nibble(nv[j].z) << 8 |
                         nibble(nv[j].w) << 12;
    p[j / 2] |= nib << (16 * (j % 2));
  }
  row.near = window64(p[0], p[1], p[2], static_cast<int>(reinterpret_cast<uintptr_t>(nm) & 15));
}

// Sum of the row's bytes at positions [goff, goff + ncols) of its chunks.
template <int CH>
__device__ __forceinline__ int row_sum(const Row<CH>& row, int ncols) {
  if (!row.in) return 0;
  const uint32_t lo = 0x01010101u * row.goff;
  const uint32_t hi = 0x01010101u * (row.goff + ncols);
  int s = 0;
#pragma unroll
  for (int k = 0; k < CH * 4; ++k) {
    const uint32_t pos = 0x01010101u * (4 * k) + 0x03020100u;
    const uint32_t keep = __vcmpgeu4(pos, lo) & __vcmpltu4(pos, hi);
    s += __vsadu4(row.g[k] & keep, 0u);
  }
  return s;
}

// Column mask of the row's pixels below the threshold (g < t, t <= 255).
template <int CH>
__device__ __forceinline__ uint64_t row_dark(const Row<CH>& row, uint32_t t) {
  const uint32_t t4 = 0x01010101u * t;
  uint32_t p[3] = {0, 0, 0};
#pragma unroll
  for (int k = 0; k < CH * 4; ++k) p[k / 8] |= nibble(__vcmpltu4(row.g[k], t4)) << (4 * (k % 8));
  return window64(p[0], p[1], p[2], row.goff);
}

// A lane's window and what scoring it needs.
struct Win {
  const uint8_t* g;    // grey of the frame
  const uint8_t* nm;   // near of the frame
  const uint8_t* icf;  // inner_coarse of the frame
  int H, W, wc, ds, wn;
  int tlx, tly, ncols;  // the window, ncols of its columns inside the image
  bool inner;
  float qx, qy, clamp_r, d0, d1;
};

// Mask of the columns [x0, x0 + n) of row y in the inner footprint, one
// lookup per coarse cell the columns cross.
__device__ __forceinline__ uint64_t footprint(const Win& w, int y, int x0, int n) {
  const uint8_t* icr = w.icf + static_cast<size_t>(y / w.ds) * w.wc;
  uint64_t fp = 0;
  const int last = (x0 + n - 1) / w.ds;
  for (int cx = x0 / w.ds; cx <= last; ++cx) {
    if (icr[cx]) fp |= bit_range(max(cx * w.ds - x0, 0), min((cx + 1) * w.ds - x0, n));
  }
  return fp;
}

// Columns [x0, x0 + n) of the window (n <= 64) inside the clamp box, as a
// mask; every lane of the warp takes part.
__device__ __forceinline__ uint64_t clamp_columns(const Win& w, int x0, int n, int lane) {
  const bool c0 = lane < n && fabsf(static_cast<float>(x0 + lane) - w.qx) <= w.clamp_r;
  const bool c1 = lane + 32 < n && fabsf(static_cast<float>(x0 + lane + 32) - w.qx) <= w.clamp_r;
  return static_cast<uint64_t>(__ballot_sync(FULL, c0)) |
         static_cast<uint64_t>(__ballot_sync(FULL, c1)) << 32;
}

// Scores the ink of window row r (columns c0 + the mask's bits) into the
// running arg-max: fma(x, d0, y * d1) (the reference's x * d0 + y * d1 as
// XLA on the CPU contracts it; segment.refine_windows), the index
// r * wn + column.
__device__ __forceinline__ void score(const Win& w, uint64_t ink, int r, int c0, float& bs,
                                      int& bi) {
  const float yd = static_cast<float>(w.tly + r) * w.d1;
  while (ink) {
    const int c = __ffsll(static_cast<long long>(ink)) - 1;
    ink &= ink - 1;
    amax_update(__fmaf_rn(static_cast<float>(w.tlx + c0 + c), w.d0, yd), r * w.wn + c0 + c,
                bs, bi);
  }
}

__device__ __forceinline__ bool row_in_box(const Win& w, int y) {
  return fabsf(static_cast<float>(y) - w.qy) <= w.clamp_r;
}

// Windows up to 64 wide: ROWS rows a thread, CH chunks a row, read once.
template <int CH, int ROWS>
__device__ __forceinline__ void score_rows(const Win& w, int lane, float& bs, int& bi) {
  const uint64_t xmask = clamp_columns(w, w.tlx, w.ncols, lane);
  // Every load of the thread's rows issued before any is used.
  Row<CH> rows[ROWS];
  uint4 gv[ROWS][CH], nv[ROWS][CH];
  size_t at[ROWS];
#pragma unroll
  for (int ri = 0; ri < ROWS; ++ri) {
    const int r = lane + 32 * ri;
    rows[ri].in = r < w.wn && w.tly + r < w.H;
    at[ri] = static_cast<size_t>(rows[ri].in ? w.tly + r : w.tly) * w.W + w.tlx;
    fetch(gv[ri], nv[ri], rows[ri].in, w.g + at[ri], w.nm + at[ri], w.ncols);
  }
#pragma unroll
  for (int ri = 0; ri < ROWS; ++ri) pack(rows[ri], gv[ri], nv[ri], w.g + at[ri], w.nm + at[ri]);
  int sum = 0;
#pragma unroll
  for (int ri = 0; ri < ROWS; ++ri) sum += row_sum(rows[ri], w.ncols);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
  const float mean = static_cast<float>(sum) / static_cast<float>(w.wn * w.wn);
  // For an integer g, g < mean exactly when g < ceil(mean) (<= 255).
  const uint32_t t = static_cast<uint32_t>(ceilf(mean));
#pragma unroll
  for (int ri = 0; ri < ROWS; ++ri) {
    const int r = lane + 32 * ri;
    if (!rows[ri].in || !row_in_box(w, w.tly + r)) continue;
    uint64_t ink = row_dark(rows[ri], t) & xmask & rows[ri].near;
    if (w.inner && ink) ink &= footprint(w, w.tly + r, w.tlx, w.ncols);
    score(w, ink, r, 0, bs, bi);
  }
}

// One row segment of up to 64 columns, [x0, x0 + n) of row y.
__device__ __forceinline__ Row<5> read_segment(const Win& w, int y, int x0, int n) {
  const size_t at = static_cast<size_t>(y) * w.W + x0;
  Row<5> row;
  uint4 gv[5], nv[5];
  row.in = true;
  fetch(gv, nv, true, w.g + at, w.nm + at, n);
  pack(row, gv, nv, w.g + at, w.nm + at);
  return row;
}

// Windows wider than 64: strips of 64 columns; a thread's rows are read
// for the sum, and the rows in the clamp box again to score.
__device__ void score_strips(const Win& w, int lane, float& bs, int& bi) {
  const int rows = min(w.wn, w.H - w.tly);
  long long sum = 0;
  for (int r = lane; r < rows; r += 32) {
    for (int c0 = 0; c0 < w.ncols; c0 += 64) {
      const int n = min(64, w.ncols - c0);
      sum += row_sum(read_segment(w, w.tly + r, w.tlx + c0, n), n);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
  const float mean = static_cast<float>(sum) / static_cast<float>(static_cast<long long>(w.wn) * w.wn);
  const uint32_t t = static_cast<uint32_t>(ceilf(mean));
  for (int c0 = 0; c0 < w.ncols; c0 += 64) {
    const int n = min(64, w.ncols - c0);
    const uint64_t xmask = clamp_columns(w, w.tlx + c0, n, lane);
    if (!xmask) continue;
    for (int r = lane; r < rows; r += 32) {
      if (!row_in_box(w, w.tly + r)) continue;
      const Row<5> row = read_segment(w, w.tly + r, w.tlx + c0, n);
      uint64_t ink = row_dark(row, t) & xmask & row.near;
      if (w.inner && ink) ink &= footprint(w, w.tly + r, w.tlx + c0, n);
      score(w, ink, r, c0, bs, bi);
    }
  }
}

// ROWS = 0: a window wider than 64 (score_strips).
template <int CH, int ROWS>
__global__ void __launch_bounds__(THREADS)
refine_kernel(const uint8_t* __restrict__ grey, const uint8_t* __restrict__ near,
              const float* __restrict__ quads, const float* __restrict__ centroids,
              const uint8_t* __restrict__ inner_coarse, const uint8_t* __restrict__ is_inner,
              const uint8_t* __restrict__ valid, float* __restrict__ out, int nq, int K, int H,
              int W, int hc, int wc, int ds, int wn) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);  // (b * K + k) * 4 + corner
  if (q >= nq) return;
  const int ln = q >> 2;  // b * K + k
  const float qx = quads[q * 2];
  const float qy = quads[q * 2 + 1];
  if (!valid[ln]) {
    if (lane == 0) {
      out[q * 2] = qx;
      out[q * 2 + 1] = qy;
    }
    return;
  }
  const int b = ln / K;
  Win w;
  // segment.corner_dirs: d = q - c, d / (|d| + 1e-6).
  const float dx = qx - centroids[ln * 2];
  const float dy = qy - centroids[ln * 2 + 1];
  const float nrm = sqrtf(dx * dx + dy * dy) + 1e-6f;
  w.d0 = dx / nrm;
  w.d1 = dy / nrm;
  w.qx = qx;
  w.qy = qy;
  w.tlx = min(max(static_cast<int>(rintf(qx)) - wn / 2, 0), max(W - wn, 0));
  w.tly = min(max(static_cast<int>(rintf(qy)) - wn / 2, 0), max(H - wn, 0));
  w.ncols = min(wn, W - w.tlx);
  w.clamp_r = static_cast<float>(ds + 2);
  const size_t plane = static_cast<size_t>(H) * W;
  w.g = grey + b * plane;
  w.nm = near + b * plane;
  w.icf = inner_coarse + static_cast<size_t>(b) * hc * wc;
  w.H = H;
  w.W = W;
  w.wc = wc;
  w.ds = ds;
  w.wn = wn;
  w.inner = is_inner[ln] != 0;

  float bs = -INFINITY;
  int bi = 0x7fffffff;
  if constexpr (ROWS > 0) {
    score_rows<CH, ROWS>(w, lane, bs, bi);
  } else {
    score_strips(w, lane, bs, bi);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(FULL, bs, off);
    const int oi = __shfl_down_sync(FULL, bi, off);
    amax_update(os, oi, bs, bi);
  }
  if (lane == 0) {
    const bool has = bi != 0x7fffffff;
    out[q * 2] = has ? static_cast<float>(w.tlx + bi % wn) : qx;
    out[q * 2 + 1] = has ? static_cast<float>(w.tly + bi / wn) : qy;
  }
}

template <int CH, int ROWS>
cudaError_t launch(int blocks, cudaStream_t stream, const uint8_t* grey, const uint8_t* near,
                   const float* quads, const float* centroids, const uint8_t* inner_coarse,
                   const uint8_t* is_inner, const uint8_t* valid, float* out, int nq, int K,
                   int H, int W, int hc, int wc, int ds, int wn) {
  refine_kernel<CH, ROWS><<<blocks, THREADS, 0, stream>>>(
      grey, near, quads, centroids, inner_coarse, is_inner, valid, out, nq, K, H, W, hc, wc, ds,
      wn);
  return cudaGetLastError();
}

}  // namespace

// grey/near (B,H,W) bytes, quads (B,K,4,2) f32, centroids (B,K,2) f32,
// inner_coarse (B,hc,wc), is_inner/valid (B,K) -> out (B,K,4,2) f32, a warp
// a corner window (window (b * K + k) * 4 + corner), eight a block.
// wn >= 1 and ds >= 1, else cudaErrorInvalidValue.
extern "C" int a3_refine(const uint8_t* grey, const uint8_t* near, const float* quads,
                         const float* centroids, const uint8_t* inner_coarse,
                         const uint8_t* is_inner, const uint8_t* valid, float* out, int B, int K,
                         int H, int W, int hc, int wc, int ds, int wn, cudaStream_t stream) {
  const int nq = B * K * 4;
  if (wn < 1 || ds < 1) return cudaErrorInvalidValue;
  if (nq == 0) return cudaSuccess;
  const int blocks = (nq + THREADS / 32 - 1) / (THREADS / 32);
  // Chunks of a row: a row of wn bytes starts anywhere in its first chunk.
  const int ch = (wn + 15 + 15) / 16;
#define A3_REFINE_ARGS                                                                       \
  blocks, stream, grey, near, quads, centroids, inner_coarse, is_inner, valid, out, nq, K, H, \
      W, hc, wc, ds, wn
  if (wn <= 32) return ch <= 2 ? launch<2, 1>(A3_REFINE_ARGS) : launch<3, 1>(A3_REFINE_ARGS);
  if (ch <= 3) return launch<3, 2>(A3_REFINE_ARGS);
  if (wn <= 64) return ch <= 4 ? launch<4, 2>(A3_REFINE_ARGS) : launch<5, 2>(A3_REFINE_ARGS);
  return launch<5, 0>(A3_REFINE_ARGS);
#undef A3_REFINE_ARGS
}
