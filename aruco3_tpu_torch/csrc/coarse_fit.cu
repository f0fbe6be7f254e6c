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
// inner labels), segment.fit_quads on both label planes (fit_common.cuh)
// and the dilated inner footprint _dilate3(labels2 < Hc*Wc).
//
// Semantics kept exactly: every flood and CCL is round-limited with
// synchronous rounds.  A flood round ORs the neighbours of the previous
// plane, then transports along whole row runs, then whole column runs; a
// CCL round takes the 4-neighbour min of the previous plane, then the full
// row-run min, then the full column-run min.  Round limits are QuadParams'.
//
// What bounds it on an H100: latency.  At the default QuadParams a frame
// takes 54 dependent rounds (45 flood, 9 CCL), each a chain of steps
// separated by barriers, on a grid far too small to keep an SM's issue
// slots busy.  So a frame's planes stay on chip, in one of three layouts
// (the wrapper's plan, ops.coarse_fit.plan, picks one):
//   * smem: one block a frame, every plane in its shared memory (grids
//     below 65,536 cells that fit: the fused route's 108x192 and 120x160,
//     labels mode on portrait 1080p).
//   * cluster (labels mode only): a thread-block cluster of C blocks a
//     frame (any C from 2 to 8; the plan takes 8), block r a band of
//     whole rows in its own shared memory, each plane with a halo row above
//     and below (a3_coarse_cluster_layout; the dense 4K cell's 216x384).
//     Row work stays in a block; three kinds of step cross a band edge: a
//     neighbour read (flood OR, dil3, the CCL's 4-neighbour min) reads the
//     adjacent bands' edge rows into the halo through distributed shared
//     memory (DSMEM) first; a column run is scanned a thread a column in
//     each band, each band publishes its column summaries (run-end value,
//     run-start value, pass-through) and, after a cluster barrier, combines
//     those of the bands before and after it, then writes; and the peel's
//     early exit is a cluster-wide OR.  Barriers that order such steps are
//     cluster barriers; no DSMEM access follows the last one.  On an H100
//     (700 W) a batch of 16 dense 4K frames takes 0.38 ms on clusters of 8
//     blocks of 512 threads, against 3.66 ms in device scratch.
//   * scratch: one block a frame, int32 planes in device scratch (grids no
//     block holds in fit mode, and grids no cluster of 8 holds, such as
//     1080x1920 at coarse_factor 1).
// One block a frame (smem, scratch):
//   * Flood planes are bit planes, 32 columns a word, rows of nw words at
//     an odd word pitch (ten 108x192 planes: 30 KB).  A round is two
//     barrier-separated steps: a thread per row takes the neighbour OR
//     (word shifts with the neighbouring words' carries) and then the
//     row-run transport as word arithmetic ((M + s) ^ M) & M | s with the
//     add's carry running across the row's words, and the same on the
//     bit-reversed row for the other direction; then a warp per word
//     column transports along column runs, 32 columns at once.
//   * CCL label planes are uint16_t in shared memory (the grid has fewer
//     than 65,536 cells, so the sentinel hc*wc fits), at a row pitch of an
//     odd number of words.  A round is two steps: a warp per row takes the
//     4-neighbour min and the row-run min of its row, a warp per column the
//     column-run min.  A cell is in the CCL's mask iff its label is below
//     the sentinel, so the run scans read labels only.
//   * Every run scan (flood columns, CCL rows and columns) gives each lane
//     an odd number of consecutive cells (a column's 32 lanes then read 32
//     banks), held in registers PC at a time so that their loads issue
//     together; one pass gives the lane's run-end value, run-start value
//     and whether the run passes through; a segmented Kogge-Stone scan over
//     shuffles (five steps each way) joins the lanes; a forward and a
//     backward pass write the results.
//   * The fit (fit mode) is fit_common.cuh's fit_plane on the uint16_t
//     planes; its member lists use the CCL's second plane.
// Critical path at the defaults: 45 x 2 + 9 x 2 = 108 barrier steps, each
// a chain of ~nw word steps (row transport) or three register passes and
// ~20 dependent shuffles (run scans), plus each fit's ~30 barriers.
// The scratch layout runs the same body on int32 labels and planes in
// device memory (coarse_layout decides, and a3_coarse_layout tells the
// wrapper).  The cluster layout runs it too, on its band of rows, with
// its own barrier, halo and column steps (the Band policy below; the
// one-block layouts' Whole policy compiles them away).  Threads per block
// come from ops.fit.threads_per_block for one block a frame (1,024 when
// the batch fits the card's SMs once, fewer when several blocks share an
// SM); clusters take 512 (ops.coarse_fit.CLUSTER_THREADS: at 1,024 a block
// fills an SM's registers and an H100 holds 15 clusters of 8 at once, at
// 512 it holds 30).

#include <cooperative_groups.h>

#include "fit_common.cuh"

namespace cg = cooperative_groups;

namespace {

using a3fit::FitOut;
using a3fit::FitParams;
using a3fit::FitPtrs;

constexpr int N_PLANES = 10;
constexpr int CLUSTER_MAX = 8;  // portable cluster size (ops.fit.RANK_CLUSTER_MAX)

// Rows (or cells) a lane holds in registers at once in the run scans, so
// that their loads issue together.
constexpr int PC = 8;

struct Params {
  int k1, k2, kr1, kr2;
  int fill_rounds, ccl_rounds, bg_rounds, inner_depths;
  int inner_flood_rounds, inner_fill_rounds, inner_ccl_rounds;
  FitParams fit;
};

// Grid geometry.  Bit planes: word j of row y (columns 32j..32j+31, bit i
// = column 32j + i) at y * npw + j, npw = nw | 1; bits at and beyond wc
// stay 0.  Label planes: cell (y, x) at y * lp + x.  Chunks: a lane of a
// row warp owns cw consecutive cells, a lane of a column warp ch
// consecutive rows (both odd).
struct Geo {
  int hc, wc, P, nw, npw, lp, cw, ch;
  uint32_t last;  // valid bits of word nw - 1
};

__host__ __device__ inline int odd_at_least(int n) { return n | 1; }

__host__ __device__ inline Geo make_geo(int hc, int wc, bool smem) {
  Geo g;
  g.hc = hc;
  g.wc = wc;
  g.P = hc * wc;
  g.nw = (wc + 31) / 32;
  g.npw = odd_at_least(g.nw);
  g.lp = smem ? 2 * odd_at_least((wc + 1) / 2) : wc;
  g.cw = odd_at_least((wc + 31) / 32);
  g.ch = odd_at_least((hc + 31) / 32);
  g.last = (wc & 31) ? (1u << (wc & 31)) - 1u : 0xffffffffu;
  return g;
}

// Where a frame's planes live: on chip (the ten bit planes, two uint16_t
// label planes and the fit scratch in shared memory), when the grid has
// fewer than 65,536 cells and they fit; else in device scratch as int32
// (two label planes, the fit scratch, the bit planes).  Fit mode keeps
// the inner label plane in device scratch either way (first in a frame's
// share).  fit_ints: the fit scratch (0 in labels mode).
a3fit::Layout coarse_layout(int hc, int wc, int fit_ints) {
  const long long lab2 = fit_ints ? static_cast<long long>(hc) * wc : 0;
  const Geo s = make_geo(hc, wc, true);
  const long long smem = static_cast<long long>(N_PLANES) * hc * s.npw * 4 +
                         2LL * hc * s.lp * 2 + 4LL * fit_ints;
  if (s.P < 65536 && smem <= a3fit::SMEM_MAX) return {true, smem, lab2};
  return {false, 0, lab2 + 2LL * s.P + fit_ints + static_cast<long long>(N_PLANES) * hc * s.npw};
}

// The cluster layout's shared memory a block, for clusters of c blocks:
// a band of `rows` rows (the last band fewer), each of its ten bit planes
// and two int32 label planes stored with a halo row above and below; then
// the column summaries (three ints a column) and the exit flags.
struct BandLayout {
  int rows;
  long long plane_words, label_ints, bytes;
};

__host__ __device__ inline BandLayout band_layout(int hc, int wc, int c) {
  const Geo g = make_geo(hc, wc, false);
  BandLayout l;
  l.rows = (hc + c - 1) / c;
  l.plane_words = (l.rows + 2LL) * g.npw;
  l.label_ints = (l.rows + 2LL) * g.lp;
  l.bytes = 4 * (N_PLANES * l.plane_words + 2 * l.label_ints + 3LL * wc + CLUSTER_MAX);
  return l;
}

// On chip when c is 2 to 8, every band has a row and a band fits.
a3fit::Layout cluster_layout(int hc, int wc, int c) {
  if (c < 2 || c > CLUSTER_MAX || hc <= 0 || wc <= 0) return {false, 0, 0};
  const BandLayout l = band_layout(hc, wc, c);
  if ((c - 1) * l.rows >= hc || l.bytes > a3fit::SMEM_MAX) return {false, 0, 0};
  return {true, l.bytes, 0};
}

__device__ __forceinline__ uint32_t wmask(const Geo& g, int j) {
  return j == g.nw - 1 ? g.last : 0xffffffffu;
}

__device__ __forceinline__ uint32_t border_word(const Geo& g, int y, int j) {
  if (y == 0 || y == g.hc - 1) return wmask(g, j);
  uint32_t w = j == 0 ? 1u : 0u;
  if (j == g.nw - 1) w |= 1u << ((g.wc - 1) & 31);
  return w;
}

__device__ __forceinline__ bool bit(const uint32_t* X, const Geo& g, int y, int x) {
  return (X[y * g.npw + (x >> 5)] >> (x & 31)) & 1u;
}

// Each cell x of a word takes its own bit and those of x - 1 and x + 1.
__device__ __forceinline__ uint32_t hdil(uint32_t left, uint32_t mid, uint32_t right) {
  return mid | (mid << 1) | (left >> 31) | (mid >> 1) | (right << 31);
}

__device__ __forceinline__ uint32_t vor(const uint32_t* X, const Geo& g, int y, int j) {
  uint32_t v = X[y * g.npw + j];
  if (y > 0) v |= X[(y - 1) * g.npw + j];
  if (y < g.hc - 1) v |= X[(y + 1) * g.npw + j];
  return v;
}

// Word (y, j) of the 3x3 dilation of X.
__device__ __forceinline__ uint32_t dil3(const uint32_t* X, const Geo& g, int y, int j) {
  const uint32_t l = j > 0 ? vor(X, g, y, j - 1) : 0u;
  const uint32_t r = j < g.nw - 1 ? vor(X, g, y, j + 1) : 0u;
  return hdil(l, vor(X, g, y, j), r) & wmask(g, j);
}

// The rows a block holds and how its steps meet.  Planes are addressed by
// frame row y everywhere (a band's pointers are shifted by its first row).
//
// Whole: one block a frame holds every row; block barriers, no halo.
struct Whole {
  static constexpr bool split = false;
  __device__ Whole(int, int, uint32_t*) {}
  __device__ __forceinline__ int frame() const { return blockIdx.x; }
  __device__ __forceinline__ int y0() const { return 0; }
  __device__ __forceinline__ int y1(const Geo& g) const { return g.hc; }
  __device__ __forceinline__ int plane_rows(const Geo& g) const { return g.hc; }
  __device__ __forceinline__ int shift(int) const { return 0; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  template <class T>
  __device__ __forceinline__ void halo(T*, int) const {}
  __device__ __forceinline__ bool any(bool p) const { return __syncthreads_or(p); }
};

// Band: block r of a cluster of c holds rows [ya, yb), stored from a halo
// row (ya - 1) to a halo row (yb); every band but the last has `rows` rows.
struct Band {
  static constexpr bool split = true;
  int r, c, rows, ya, yb;
  int* sum;    // column summaries: run-end, run-start, pass-through (wc each)
  int sum_w;
  int* flags;  // the exit flags of the cluster's blocks
  __device__ Band(int hc, int wc, uint32_t* dyn) {
    cg::cluster_group cl = cg::this_cluster();
    c = static_cast<int>(cl.num_blocks());
    r = static_cast<int>(cl.block_rank());
    const BandLayout l = band_layout(hc, wc, c);
    rows = l.rows;
    ya = r * rows;
    yb = min(hc, ya + rows);
    sum = reinterpret_cast<int*>(dyn) + N_PLANES * l.plane_words + 2 * l.label_ints;
    sum_w = wc;
    flags = sum + 3 * wc;
  }
  __device__ __forceinline__ int frame() const { return blockIdx.y; }
  __device__ __forceinline__ int y0() const { return ya; }
  __device__ __forceinline__ int y1(const Geo&) const { return yb; }
  __device__ __forceinline__ int plane_rows(const Geo&) const { return rows + 2; }
  __device__ __forceinline__ int shift(int pitch) const { return (1 - ya) * pitch; }
  __device__ __forceinline__ void sync() const { cg::this_cluster().sync(); }

  // The halo rows of X (row pitch `pitch`) from the adjacent bands: row
  // ya - 1 is band r - 1's last row, row yb band r + 1's first.  Their
  // rows must be final (a cluster barrier since they were written).
  // Ends with a block barrier.
  template <class T>
  __device__ void halo(T* X, int pitch) const {
    cg::cluster_group cl = cg::this_cluster();
    for (int i = threadIdx.x; i < 2 * pitch; i += blockDim.x) {
      const bool below = i >= pitch;
      const int x = below ? i - pitch : i;
      if (below ? r + 1 < c : r > 0) {
        T* src = X + (below ? ya : ya + rows - 1) * pitch + x;
        X[(below ? yb : ya - 1) * pitch + x] = *cl.map_shared_rank(src, below ? r + 1 : r - 1);
      }
    }
    __syncthreads();
  }

  // Whether p holds on any thread of the cluster.  Each block writes its
  // OR into every block's flag of it before the barrier, so nothing is
  // read across the cluster after it.
  __device__ bool any(bool p) const {
    const int mine = __syncthreads_or(p);
    cg::cluster_group cl = cg::this_cluster();
    if (static_cast<int>(threadIdx.x) < c) *cl.map_shared_rank(flags + r, threadIdx.x) = mine;
    cl.sync();
    int all = 0;
    for (int q = 0; q < c; ++q) all |= flags[q];
    return all != 0;
  }

  // Summary k (0 run-end, 1 run-start, 2 pass-through) of column i in
  // band q.
  __device__ __forceinline__ int summary(int k, int i, int q) const {
    return *cg::this_cluster().map_shared_rank(sum + k * sum_w + i, q);
  }

  // The flood's column runs, a thread a word column (32 columns): the
  // band's summaries of T within M, a cluster barrier, then each column's
  // carries from the bands before and after it, and the forward and
  // backward passes into R.
  __device__ void flood_columns(uint32_t* R, const uint32_t* M, const uint32_t* T,
                                int nw, int npw) const {
    for (int j = threadIdx.x; j < nw; j += blockDim.x) {
      uint32_t f = 0u, b = 0u, p = 0xffffffffu;
      for (int ys = ya; ys < yb; ys += PC) {
        uint32_t mm[PC], tt[PC];
#pragma unroll
        for (int i = 0; i < PC; ++i) {
          const int q = (ys + i) * npw + j;
          mm[i] = ys + i < yb ? M[q] : 0xffffffffu;
          tt[i] = ys + i < yb ? T[q] : 0u;
        }
#pragma unroll
        for (int i = 0; i < PC; ++i) {
          f = mm[i] & (tt[i] | f);
          p &= mm[i];
          b |= tt[i] & p;
        }
      }
      sum[j] = static_cast<int>(f);
      sum[sum_w + j] = static_cast<int>(b);
      sum[2 * sum_w + j] = static_cast<int>(p);
    }
    sync();
    for (int j = threadIdx.x; j < nw; j += blockDim.x) {
      uint32_t f = 0u, b = 0u;
      for (int q = 0; q < r; ++q)
        f = static_cast<uint32_t>(summary(0, j, q)) | (static_cast<uint32_t>(summary(2, j, q)) & f);
      for (int q = c - 1; q > r; --q)
        b = static_cast<uint32_t>(summary(1, j, q)) | (static_cast<uint32_t>(summary(2, j, q)) & b);
      for (int ys = ya; ys < yb; ys += PC) {
        uint32_t mm[PC], tt[PC];
#pragma unroll
        for (int i = 0; i < PC; ++i) {
          const int q = (ys + i) * npw + j;
          mm[i] = ys + i < yb ? M[q] : 0u;
          tt[i] = ys + i < yb ? T[q] : 0u;
        }
#pragma unroll
        for (int i = 0; i < PC; ++i) {
          if (ys + i < yb) {
            f = mm[i] & (tt[i] | f);
            R[(ys + i) * npw + j] = f;
          }
        }
      }
      // Backward over the forward values: each cell then holds its whole
      // run's OR.
      for (int ye = yb; ye > ya; ye -= PC) {
        uint32_t mm[PC], rr[PC];
#pragma unroll
        for (int i = 0; i < PC; ++i) {
          const int q = (ye - 1 - i) * npw + j;
          mm[i] = ye - 1 - i >= ya ? M[q] : 0u;
          rr[i] = ye - 1 - i >= ya ? R[q] : 0u;
        }
#pragma unroll
        for (int i = 0; i < PC; ++i) {
          if (ye - 1 - i >= ya) {
            b = mm[i] & (rr[i] | b);
            R[(ye - 1 - i) * npw + j] = b;
          }
        }
      }
    }
  }

  // The CCL's column-run min of src into dst, a thread a column: as
  // flood_columns, with run mins (identity and mask bound `sent`).
  template <class L>
  __device__ void ccl_columns(const L* src, L* dst, int wc, int lp, int sent) const {
    for (int x = threadIdx.x; x < wc; x += blockDim.x) {
      int f = sent, b = sent;
      bool all = true;
      for (int ys = ya; ys < yb; ys += PC) {
        int v[PC];
#pragma unroll
        for (int i = 0; i < PC; ++i) v[i] = ys + i < yb ? static_cast<int>(src[(ys + i) * lp + x]) : sent;
#pragma unroll
        for (int i = 0; i < PC; ++i) {
          if (ys + i >= yb) break;
          const bool in = v[i] < sent;
          f = in ? min(f, v[i]) : sent;
          if (all && in) b = min(b, v[i]);
          all = all && in;
        }
      }
      sum[x] = f;
      sum[sum_w + x] = b;
      sum[2 * sum_w + x] = all;
    }
    sync();
    for (int x = threadIdx.x; x < wc; x += blockDim.x) {
      int f = sent, b = sent;
      for (int q = 0; q < r; ++q) {
        const int v = summary(0, x, q);
        f = summary(2, x, q) ? min(f, v) : v;
      }
      for (int q = c - 1; q > r; --q) {
        const int v = summary(1, x, q);
        b = summary(2, x, q) ? min(b, v) : v;
      }
      for (int ys = ya; ys < yb; ys += PC) {
        int v[PC];
#pragma unroll
        for (int i = 0; i < PC; ++i) v[i] = ys + i < yb ? static_cast<int>(src[(ys + i) * lp + x]) : sent;
#pragma unroll
        for (int i = 0; i < PC; ++i) {
          if (ys + i >= yb) break;
          f = v[i] < sent ? min(f, v[i]) : sent;
          dst[(ys + i) * lp + x] = static_cast<L>(f);
        }
      }
      for (int ye = yb; ye > ya; ye -= PC) {
        int v[PC];
#pragma unroll
        for (int i = 0; i < PC; ++i)
          v[i] = ye - 1 - i >= ya ? static_cast<int>(dst[(ye - 1 - i) * lp + x]) : sent;
#pragma unroll
        for (int i = 0; i < PC; ++i) {
          if (ye - 1 - i < ya) break;
          b = v[i] < sent ? min(b, v[i]) : sent;
          dst[(ye - 1 - i) * lp + x] = static_cast<L>(b);
        }
      }
    }
  }
};

// f(q, y, j) for every word of the block's rows of a plane (q = y * npw + j).
template <class B, class F>
__device__ __forceinline__ void each_word(const Geo& g, const B& band, F f) {
  for (int i = threadIdx.x; i < (band.y1(g) - band.y0()) * g.nw; i += blockDim.x) {
    const int y = band.y0() + i / g.nw;
    const int j = i - (y - band.y0()) * g.nw;
    f(y * g.npw + j, y, j);
  }
}

// f(y, x) for every cell of the block's rows.
template <class B, class F>
__device__ __forceinline__ void each_cell(const Geo& g, const B& band, F f) {
  for (int p = threadIdx.x; p < (band.y1(g) - band.y0()) * g.wc; p += blockDim.x) {
    const int y = band.y0() + p / g.wc;
    f(y, p - (y - band.y0()) * g.wc);
  }
}

// out[y, j] bit i = pred(y, 32j + i): a warp a word, one ballot.
template <class B, class F>
__device__ __forceinline__ void pack(uint32_t* out, const Geo& g, const B& band, F pred) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < (band.y1(g) - band.y0()) * g.nw; i += blockDim.x >> 5) {
    const int y = band.y0() + i / g.nw;
    const int j = i - (y - band.y0()) * g.nw;
    const int x = 32 * j + lane;
    const uint32_t w = __ballot_sync(0xffffffffu, x < g.wc && pred(y, x));
    if (lane == 0) out[y * g.npw + j] = w;
  }
}

// Row-run transport of the seeds t (within m) toward higher columns: the
// add's carry runs from each seed through the rest of its run.
__device__ __forceinline__ uint32_t run_up(uint32_t m, uint32_t t, uint32_t& carry) {
  const unsigned long long sum = static_cast<unsigned long long>(m) + t + carry;
  carry = static_cast<uint32_t>(sum >> 32);
  return ((static_cast<uint32_t>(sum) ^ m) & m) | t;
}

// Segmented Kogge-Stone across a warp's lanes, 32 bit columns at once: v
// is a lane's run-end value, p the columns its whole chunk passes through.
// Returns the carry into the lane from the lanes before it (up) or after
// it (down).
__device__ __forceinline__ uint32_t carry_in_up(uint32_t v, uint32_t p) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t ov = __shfl_up_sync(0xffffffffu, v, d);
    const uint32_t op = __shfl_up_sync(0xffffffffu, p, d);
    if (lane >= d) {
      v |= p & ov;
      p &= op;
    }
  }
  const uint32_t c = __shfl_up_sync(0xffffffffu, v, 1);
  return lane == 0 ? 0u : c;
}

__device__ __forceinline__ uint32_t carry_in_down(uint32_t v, uint32_t p) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t ov = __shfl_down_sync(0xffffffffu, v, d);
    const uint32_t op = __shfl_down_sync(0xffffffffu, p, d);
    if (lane + d < 32) {
      v |= p & ov;
      p &= op;
    }
  }
  const uint32_t c = __shfl_down_sync(0xffffffffu, v, 1);
  return lane == 31 ? 0u : c;
}

// The same for run mins with a flag per lane (the whole chunk in the
// mask); the identity is `sent`.
__device__ __forceinline__ int min_in_up(int v, bool p, int sent) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const int ov = __shfl_up_sync(0xffffffffu, v, d);
    const bool op = __shfl_up_sync(0xffffffffu, p, d);
    if (lane >= d) {
      if (p) v = min(v, ov);
      p = p && op;
    }
  }
  const int c = __shfl_up_sync(0xffffffffu, v, 1);
  return lane == 0 ? sent : c;
}

__device__ __forceinline__ int min_in_down(int v, bool p, int sent) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const int ov = __shfl_down_sync(0xffffffffu, v, d);
    const bool op = __shfl_down_sync(0xffffffffu, p, d);
    if (lane + d < 32) {
      if (p) v = min(v, ov);
      p = p && op;
    }
  }
  const int c = __shfl_down_sync(0xffffffffu, v, 1);
  return lane == 31 ? sent : c;
}

// `R` holds medium & seed on entry and the flood after `rounds`; T is
// scratch.  The block's rows of R must be final across the cluster on
// entry (band.sync()).  Ends with band.sync().
template <class B>
__device__ void flood(uint32_t* R, const uint32_t* M, uint32_t* T, int rounds, bool diag,
                      const Geo& g, const B& band) {
  const int lane = threadIdx.x & 31;
  const int y0 = min(g.hc, lane * g.ch), y1 = min(g.hc, y0 + g.ch);
  for (int it = 0; it < rounds; ++it) {
    band.halo(R, g.npw);
    // Neighbour OR and row runs: a thread a row.
    for (int y = band.y0() + threadIdx.x; y < band.y1(g); y += blockDim.x) {
      const uint32_t* __restrict__ r = R + y * g.npw;
      const uint32_t* __restrict__ up = y > 0 ? r - g.npw : nullptr;
      const uint32_t* __restrict__ dn = y < g.hc - 1 ? r + g.npw : nullptr;
      const uint32_t* __restrict__ m = M + y * g.npw;
      uint32_t* __restrict__ t = T + y * g.npw;
      auto v = [&](int j) -> uint32_t {
        if (j < 0 || j >= g.nw) return 0u;
        uint32_t w = r[j];
        if (diag) {
          if (up) w |= up[j];
          if (dn) w |= dn[j];
        }
        return w;
      };
      uint32_t prev = 0u, cur = v(0), carry = 0u;
      for (int j = 0; j < g.nw; ++j) {
        const uint32_t next = v(j + 1);
        uint32_t n = hdil(prev, cur, next);
        if (!diag) {
          if (up) n |= up[j];
          if (dn) n |= dn[j];
        }
        const uint32_t mm = m[j];
        t[j] = run_up(mm, n & mm, carry);
        prev = cur;
        cur = next;
      }
      carry = 0u;
      for (int j = g.nw - 1; j >= 0; --j)
        t[j] = __brev(run_up(__brev(m[j]), __brev(t[j]), carry));
    }
    __syncthreads();
    if constexpr (B::split) {
      band.flood_columns(R, M, T, g.nw, g.npw);
      band.sync();
      continue;
    }
    // Column runs: a warp a word column, a lane ch rows.  One pass gives
    // the lane's run-end value f, run-start value b and pass-through p.
    for (int j = threadIdx.x >> 5; j < g.nw; j += blockDim.x >> 5) {
      uint32_t f = 0u, b = 0u, p = y0 < y1 ? 0xffffffffu : 0u;
      for (int ys = y0; ys < y1; ys += PC) {
        uint32_t mm[PC], tt[PC];
#pragma unroll
        for (int i = 0; i < PC; ++i) {
          const int q = (ys + i) * g.npw + j;
          mm[i] = ys + i < y1 ? M[q] : 0xffffffffu;
          tt[i] = ys + i < y1 ? T[q] : 0u;
        }
#pragma unroll
        for (int i = 0; i < PC; ++i) {
          f = mm[i] & (tt[i] | f);
          p &= mm[i];
          b |= tt[i] & p;
        }
      }
      f = carry_in_up(f, p);
      b = carry_in_down(b, p);
      for (int ys = y0; ys < y1; ys += PC) {
#pragma unroll
        for (int i = 0; i < PC; ++i) {
          const int q = (ys + i) * g.npw + j;
          if (ys + i < y1) {
            f = M[q] & (T[q] | f);
            R[q] = f;
          }
        }
      }
      // Backward over the forward values: each cell then holds its whole
      // run's OR.
      for (int ye = y1; ye > y0; ye -= PC) {
#pragma unroll
        for (int i = 1; i <= PC; ++i) {
          const int q = (ye - i) * g.npw + j;
          if (ye - i >= y0) {
            b = M[q] & (R[q] | b);
            R[q] = b;
          }
        }
      }
    }
    __syncthreads();
  }
}

// A lane's chunk of a run scan over n cells at src[i * stride], i in
// [i0, i1): one pass gives its run-end min f, run-start min b and whether
// every cell is in the mask (value below `sent`); the chunks are joined
// across the warp; then a forward and a backward pass write every cell's
// whole run min to dst (which may be src).
template <class L>
__device__ __forceinline__ void run_min(const L* src, L* dst, int stride, int i0, int i1,
                                        int sent) {
  int f = sent, b = sent;
  bool all = i0 < i1, lead = true;
  for (int is = i0; is < i1; is += PC) {
    int v[PC];
#pragma unroll
    for (int k = 0; k < PC; ++k) v[k] = is + k < i1 ? static_cast<int>(src[(is + k) * stride]) : sent;
#pragma unroll
    for (int k = 0; k < PC; ++k) {
      if (is + k >= i1) break;
      const bool in = v[k] < sent;
      f = in ? min(f, v[k]) : sent;
      all = all && in;
      lead = lead && in;
      if (lead) b = min(b, v[k]);
    }
  }
  f = min_in_up(f, all, sent);
  b = min_in_down(b, all, sent);
  for (int is = i0; is < i1; is += PC) {
    int v[PC];
#pragma unroll
    for (int k = 0; k < PC; ++k) v[k] = is + k < i1 ? static_cast<int>(src[(is + k) * stride]) : sent;
#pragma unroll
    for (int k = 0; k < PC; ++k) {
      if (is + k >= i1) break;
      f = v[k] < sent ? min(f, v[k]) : sent;
      dst[(is + k) * stride] = static_cast<L>(f);
    }
  }
  for (int ie = i1; ie > i0; ie -= PC) {
    int v[PC];
#pragma unroll
    for (int k = 1; k <= PC; ++k) v[k - 1] = ie - k >= i0 ? static_cast<int>(dst[(ie - k) * stride]) : sent;
#pragma unroll
    for (int k = 1; k <= PC; ++k) {
      if (ie - k < i0) break;
      b = v[k - 1] < sent ? min(b, v[k - 1]) : sent;
      dst[(ie - k) * stride] = static_cast<L>(b);
    }
  }
}

// Round-limited 4-connected CCL of `blk` into lbl (initialised here); tmp
// is a second label plane.  A cell is in `blk` iff its label is below the
// sentinel P, so the run scans read no mask.  Ends with band.sync().
template <class L, class B>
__device__ void ccl(L* lbl, const uint32_t* blk, L* tmp, int rounds, const Geo& g, const B& band) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int P = g.P, lp = g.lp;
  each_cell(g, band, [&](int y, int x) {
    lbl[y * lp + x] = static_cast<L>(bit(blk, g, y, x) ? y * g.wc + x : P);
  });
  band.sync();
  const int x0 = min(g.wc, lane * g.cw), x1 = min(g.wc, x0 + g.cw);
  const int y0 = min(g.hc, lane * g.ch), y1 = min(g.hc, y0 + g.ch);
  for (int it = 0; it < rounds; ++it) {
    band.halo(lbl, lp);
    // 4-neighbour min into tmp, then its row-run min: a warp a row.
    for (int y = band.y0() + warp; y < band.y1(g); y += nwarps) {
      const L* __restrict__ r = lbl + y * lp;
      L* __restrict__ t = tmp + y * lp;
      const uint32_t* brow = blk + y * g.npw;
      for (int xs = x0; xs < x1; xs += PC) {
        int m[PC];
#pragma unroll
        for (int k = 0; k < PC; ++k) {
          const int x = xs + k;
          m[k] = P;
          if (x < x1 && ((brow[x >> 5] >> (x & 31)) & 1u)) {
            int v = r[x];
            if (y > 0) v = min(v, static_cast<int>(r[x - lp]));
            if (y < g.hc - 1) v = min(v, static_cast<int>(r[x + lp]));
            if (x > 0) v = min(v, static_cast<int>(r[x - 1]));
            if (x < g.wc - 1) v = min(v, static_cast<int>(r[x + 1]));
            m[k] = v;
          }
        }
#pragma unroll
        for (int k = 0; k < PC; ++k)
          if (xs + k < x1) t[xs + k] = static_cast<L>(m[k]);
      }
      run_min(t, t, 1, x0, x1, P);
    }
    __syncthreads();
    // Column-run min: a warp a column (a thread a column of a band).
    if constexpr (B::split) band.ccl_columns(tmp, lbl, g.wc, lp, P);
    else for (int x = warp; x < g.wc; x += nwarps) run_min(tmp + x, lbl + x, lp, y0, y1, P);
    band.sync();
  }
}

struct Args {
  const uint8_t* coarse;
  FitPtrs fit1, fit2;
  uint8_t* inner_coarse;
  int* labels1;  // labels mode: the outputs; nullptr in fit mode
  int* labels2;
  int* scratch;  // scratch_ints per frame
  size_t frame_ints;
  int hc, wc;
  Params pr;
};

// Whole, L = uint16_t: planes, labels and fit scratch in shared memory
// (smem); Whole, L = int: in device scratch (scratch); Band, L = int: a
// band of a frame's planes and labels in each block's shared memory, on a
// cluster (cluster; labels mode only).
template <class L, class B>
__global__ void __launch_bounds__(1024) coarse_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t dyn[];
  constexpr bool smem = sizeof(L) == 2 || B::split;
  const B band(a.hc, a.wc, dyn);
  const Params& pr = a.pr;
  const int b = band.frame();
  const Geo g = make_geo(a.hc, a.wc, sizeof(L) == 2);
  const int P = g.P;
  const bool labels_only = B::split || a.labels1 != nullptr;
  const int fit_ints = labels_only ? 0 : a3fit::scratch_ints(max(pr.kr1, pr.kr2), g.hc, g.wc);
  // Words of a bit plane's storage.
  const size_t pw = static_cast<size_t>(band.plane_rows(g)) * g.npw;
  int* fs = a.scratch + static_cast<size_t>(b) * a.frame_ints;
  int* LAB2 = labels_only ? a.labels2 + static_cast<size_t>(b) * P : fs;
  if (!labels_only) fs += P;
  uint32_t* planes;
  L* LABA;
  int* fit_base;
  if (smem) {
    planes = dyn + band.shift(g.npw);
    LABA = reinterpret_cast<L*>(dyn + N_PLANES * pw) + band.shift(g.lp);
    fit_base = reinterpret_cast<int*>(LABA + 2 * g.hc * g.lp);
  } else {
    LABA = reinterpret_cast<L*>(fs);
    fit_base = fs + 2 * P;
    planes = reinterpret_cast<uint32_t*>(fit_base + fit_ints);
  }
  L* TMPI = LABA + band.plane_rows(g) * g.lp;
  uint32_t* WHITE = planes;
  uint32_t* R = planes + pw;
  uint32_t* TMP = planes + 2 * pw;
  uint32_t* F1 = planes + 3 * pw;
  uint32_t* BG = planes + 4 * pw;     // later: the CCL mask of a peel depth
  uint32_t* M2 = planes + 5 * pw;     // first: the coarse mask itself
  uint32_t* KNOWN = planes + 6 * pw;
  uint32_t* LEV = planes + 7 * pw;
  uint32_t* OK = planes + 8 * pw;     // later: the complement of a level
  uint32_t* REM = planes + 9 * pw;
  const uint8_t* C = a.coarse + static_cast<size_t>(b) * P;
  const a3fit::FitScratch fsc = a3fit::FitScratch::carve(fit_base, max(pr.kr1, pr.kr2), g.hc, g.wc);
  const a3fit::Twins none = {nullptr, nullptr, nullptr, 0};

  // Outer pass: fill_holes, then the CCL of the filled plane.
  pack(M2, g, band, [&](int y, int x) { return C[y * g.wc + x] != 0; });
  __syncthreads();
  each_word(g, band, [&](int q, int y, int j) {
    const uint32_t w = ~M2[q] & wmask(g, j);
    WHITE[q] = w;
    R[q] = w & border_word(g, y, j);
  });
  band.sync();
  flood(R, WHITE, TMP, pr.fill_rounds, true, g, band);
  each_word(g, band, [&](int q, int, int) { F1[q] = M2[q] | (WHITE[q] & ~R[q]); });
  __syncthreads();
  ccl(LABA, F1, TMPI, pr.ccl_rounds, g, band);
  if (labels_only) {
    int* L1 = a.labels1 + static_cast<size_t>(b) * P;
    each_cell(g, band, [&](int y, int x) { L1[y * g.wc + x] = LABA[y * g.lp + x]; });
    if (pr.k2 <= 0) {
      each_cell(g, band, [&](int y, int x) { LAB2[y * g.wc + x] = P; });
      return;
    }
  } else {
    a3fit::fit_plane(a3fit::Labels<L>{LABA, g.hc, g.wc, g.lp}, pr.k1, pr.kr1,
                     a.fit1.frame(b, pr.k1), fsc, TMPI, pr.fit, none);
    if (pr.k2 <= 0) {
      uint8_t* IC = a.inner_coarse + static_cast<size_t>(b) * P;
      for (int p = threadIdx.x; p < P; p += blockDim.x) IC[p] = 0;
      return;
    }
  }

  // Inner pass (segment.label_planes): background, known outside, depth 0.
  // A dil3 of a plane reads the adjacent bands' edge rows: band.halo first.
  each_word(g, band, [&](int q, int y, int j) { BG[q] = M2[q] & border_word(g, y, j); });
  band.sync();
  flood(BG, M2, TMP, pr.bg_rounds, false, g, band);
  band.halo(BG, g.npw);
  each_word(g, band, [&](int q, int y, int j) {
    M2[q] &= ~BG[q];
    KNOWN[q] = WHITE[q] & (border_word(g, y, j) | dil3(BG, g, y, j));
  });
  band.sync();
  flood(KNOWN, WHITE, TMP, pr.fill_rounds, true, g, band);
  band.halo(KNOWN, g.npw);
  each_word(g, band, [&](int q, int y, int j) { LEV[q] = M2[q] & dil3(KNOWN, g, y, j); });
  band.sync();
  flood(LEV, M2, TMP, pr.inner_flood_rounds, false, g, band);
  pack(OK, g, band, [&](int y, int x) {
    return bit(LEV, g, y, x) && static_cast<int>(LABA[y * g.lp + x]) == y * g.wc + x;
  });
  band.sync();
  flood(OK, F1, TMP, pr.ccl_rounds, false, g, band);
  each_cell(g, band, [&](int y, int x) {
    const bool ok = bit(OK, g, y, x) && bit(LEV, g, y, x);
    LAB2[y * g.wc + x] = ok ? static_cast<int>(LABA[y * g.lp + x]) : P;
  });
  band.halo(LEV, g.npw);
  each_word(g, band, [&](int q, int y, int j) {
    REM[q] = M2[q] & ~(OK[q] & LEV[q]);
    KNOWN[q] |= dil3(LEV, g, y, j) & WHITE[q];
  });
  band.sync();
  flood(KNOWN, WHITE, TMP, pr.inner_flood_rounds, true, g, band);

  uint32_t* NOTLEV = OK;
  uint32_t* BLK = BG;
  for (int depth = 1; depth < pr.inner_depths; ++depth) {
    uint32_t any = 0u;
    each_word(g, band, [&](int q, int, int) { any |= REM[q]; });
    if (!band.any(any != 0u)) break;  // an exhausted peel changes nothing
    band.halo(KNOWN, g.npw);
    each_word(g, band, [&](int q, int y, int j) { LEV[q] = REM[q] & dil3(KNOWN, g, y, j); });
    band.sync();
    flood(LEV, REM, TMP, pr.inner_flood_rounds, false, g, band);
    each_word(g, band, [&](int q, int, int j) {
      NOTLEV[q] = ~LEV[q] & wmask(g, j);
      R[q] = KNOWN[q] & ~LEV[q];
    });
    band.sync();
    flood(R, NOTLEV, TMP, pr.inner_fill_rounds, true, g, band);
    each_word(g, band, [&](int q, int, int j) { BLK[q] = ~R[q] & wmask(g, j); });
    __syncthreads();
    ccl(LABA, BLK, TMPI, pr.inner_ccl_rounds, g, band);
    each_cell(g, band, [&](int y, int x) {
      if (bit(LEV, g, y, x)) LAB2[y * g.wc + x] = LABA[y * g.lp + x];
    });
    band.halo(LEV, g.npw);
    each_word(g, band, [&](int q, int y, int j) {
      REM[q] &= ~LEV[q];
      KNOWN[q] |= dil3(LEV, g, y, j) & WHITE[q];
    });
    band.sync();
    flood(KNOWN, WHITE, TMP, pr.inner_flood_rounds, true, g, band);
  }

  if (labels_only) return;
  // The inner plane back on chip for its fit (LABA is free now).
  each_cell(g, band, [&](int y, int x) { LABA[y * g.lp + x] = static_cast<L>(LAB2[y * g.wc + x]); });
  __syncthreads();
  a3fit::fit_plane(a3fit::Labels<L>{LABA, g.hc, g.wc, g.lp}, pr.k2, pr.kr2,
                   a.fit2.frame(b, pr.k2), fsc, TMPI, pr.fit, none);
  pack(TMP, g, band, [&](int y, int x) { return static_cast<int>(LABA[y * g.lp + x]) < P; });
  __syncthreads();
  uint8_t* IC = a.inner_coarse + static_cast<size_t>(b) * P;
  each_cell(g, band, [&](int y, int x) {
    IC[y * g.wc + x] = (dil3(TMP, g, y, x >> 5) >> (x & 31)) & 1u;
  });
}

template <class K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The fit scratch of a rank pool of kr (0: labels mode, no fit).
int fit_scratch(int kr, int hc, int wc) { return kr > 0 ? a3fit::scratch_ints(kr, hc, wc) : 0; }

// Labels mode's B frames on clusters of c blocks of `threads`, in the
// cluster layout (no scratch).
int launch_cluster(Args a, int B, int threads, int c, cudaStream_t stream) {
  const a3fit::Layout l = cluster_layout(a.hc, a.wc, c);
  if (!l.in_smem || a.labels1 == nullptr || B <= 0 || B > 65535) return cudaErrorInvalidValue;
  cudaError_t e = set_smem(coarse_kernel<int, Band>, static_cast<size_t>(l.smem));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(l.smem);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  a.frame_ints = 0;
  e = cudaLaunchKernelEx(&cfg, coarse_kernel<int, Band>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// A frame a block (cluster 0 or 1: smem or scratch, as coarse_layout
// decides), or on a cluster of `cluster` blocks (2 to 8; labels mode).
int launch(Args a, int B, int threads, int cluster, long long scratch_per_frame,
           cudaStream_t stream) {
  if (threads % 32 != 0 || threads < 64 || threads > 1024) return cudaErrorInvalidValue;
  if (cluster > 1) return launch_cluster(a, B, threads, cluster, stream);
  const a3fit::Layout l = coarse_layout(a.hc, a.wc, fit_scratch(max(a.pr.kr1, a.pr.kr2), a.hc, a.wc));
  if (cluster < 0 || scratch_per_frame < l.scratch) return cudaErrorInvalidValue;
  a.frame_ints = static_cast<size_t>(scratch_per_frame);
  if (l.in_smem) {
    cudaError_t e = set_smem(coarse_kernel<uint16_t, Whole>, static_cast<size_t>(l.smem));
    if (e != cudaSuccess) return e;
    coarse_kernel<uint16_t, Whole><<<B, threads, l.smem, stream>>>(a);
  } else {
    coarse_kernel<int, Whole><<<B, threads, 0, stream>>>(a);
  }
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

// out[0], out[1]: bytes of shared memory a block and ints of device
// scratch a frame that kernel 2 takes for an hc x wc grid, in fit mode
// with a rank pool of kr (the larger of the two), in labels mode if kr is 0.
extern "C" int a3_coarse_layout(int hc, int wc, int kr, long long* out) {
  return a3fit::put_layout(coarse_layout(hc, wc, fit_scratch(kr, hc, wc)), out);
}

// out[0], out[1]: bytes of shared memory a block (0 where the band does
// not fit, or a band would be empty) and ints of device scratch a frame
// (0) that labels mode takes for an hc x wc grid on clusters of c blocks.
extern "C" int a3_coarse_cluster_layout(int hc, int wc, int c, long long* out) {
  return a3fit::put_layout(cluster_layout(hc, wc, c), out);
}

// Fit mode: coarse (B,hc,wc) 0/1 bytes -> both fits and inner_coarse.
// threads: a multiple of 32 in [64, 1024]; scratch: scratch_per_frame
// ints a frame, at least a3_coarse_layout's.  Returns cudaGetLastError().
extern "C" int a3_coarse_fit(
    const uint8_t* coarse, float* quads1, uint8_t* valid1, int* roots1, float* cents1,
    int* sizes1, int* qual1, float* quads2, uint8_t* valid2, int* roots2,
    float* cents2, int* sizes2, int* qual2, uint8_t* inner_coarse, int* scratch,
    int B, int hc, int wc, int ds, int k1, int k2, int kr1,
    int kr2, int fill_rounds, int ccl_rounds, int bg_rounds, int inner_depths,
    int inner_flood_rounds, int inner_fill_rounds, int inner_ccl_rounds,
    float slack, float min_containment, int min_px, int threads, long long scratch_per_frame,
    cudaStream_t stream) {
  if (k1 <= 0 || k1 > a3fit::K_MAX || k2 > a3fit::K_MAX || kr1 > a3fit::KR_MAX ||
      kr2 > a3fit::KR_MAX || k1 > kr1 || (k2 > 0 && k2 > kr2))
    return cudaErrorInvalidValue;
  Args a = {};
  a.pr = round_params(fill_rounds, ccl_rounds, bg_rounds, inner_depths, inner_flood_rounds,
                      inner_fill_rounds, inner_ccl_rounds);
  a.pr.k1 = k1; a.pr.k2 = k2; a.pr.kr1 = kr1; a.pr.kr2 = kr2;
  a.pr.fit.ds = ds; a.pr.fit.min_px = min_px; a.pr.fit.slack = slack;
  a.pr.fit.min_containment = min_containment;
  a.coarse = coarse;
  a.fit1 = {quads1, valid1, roots1, cents1, sizes1, qual1};
  a.fit2 = {quads2, valid2, roots2, cents2, sizes2, qual2};
  a.inner_coarse = inner_coarse;
  a.scratch = scratch;
  a.hc = hc;
  a.wc = wc;
  return launch(a, B, threads, 1, scratch_per_frame, stream);
}

// Labels mode: coarse (B,hc,wc) 0/1 bytes -> labels1, labels2 (B,hc,wc)
// int32 with sentinel hc*wc; labels2 is all sentinel unless `inner`.
// cluster: 0 or 1, a frame a block, threads and scratch as for
// a3_coarse_fit (with a3_coarse_layout's kr 0); 2 to 8, a frame on a
// cluster of that many blocks (a3_coarse_cluster_layout's, no scratch).
// Returns cudaGetLastError().
extern "C" int a3_coarse_labels(const uint8_t* coarse, int* labels1, int* labels2, int* scratch,
                                int B, int hc, int wc, int inner, int fill_rounds, int ccl_rounds,
                                int bg_rounds, int inner_depths, int inner_flood_rounds,
                                int inner_fill_rounds, int inner_ccl_rounds, int threads,
                                int cluster, long long scratch_per_frame, cudaStream_t stream) {
  Args a = {};
  a.pr = round_params(fill_rounds, ccl_rounds, bg_rounds, inner_depths, inner_flood_rounds,
                      inner_fill_rounds, inner_ccl_rounds);
  a.pr.k2 = inner ? 1 : 0;
  a.coarse = coarse;
  a.labels1 = labels1;
  a.labels2 = labels2;
  a.scratch = scratch;
  a.hc = hc;
  a.wc = wc;
  return launch(a, B, threads, cluster, scratch_per_frame, stream);
}
