// Kernel 1: adaptive threshold, opening, pooling, near mask, level 1.
//
// Replaces the TPU kernel aruco3_tpu/ops/frontend_pallas.py
// fused_threshold_open_pool (pallas_call at :1222).  Its specification is
// the XLA path it reproduces: frontend.adaptive_threshold (clamped box of
// radius r, white iff g*area >= sum), segment.open_mask (r_open erosions
// padding True, then r_open dilations padding False), segment.pool_black
// (count*2 >= max(ds, 2), padding False), the near mask
// _dilate3(_dilate3(opened)) of segment.refine_corners, and pyramid level 1
// of the zero-padded frame in one of two modes, as the route asks: on the
// refine route the TPU kernel's own (emit_level1, bit-identical to
// rectify.build_packed_pyramid's chain): r = bf16(g[2i] + g[2i+1]) per
// column, then bf16(0.25 r[2j] + 0.25 r[2j+1]), each sum in float32, stored
// as bfloat16; on the tail route rectify.build_pyramid's exact float32 2x2
// means, stored as float32.
//
// What bounds it on an H100: device-memory bytes in principle, the SM's
// integer and shared-memory pipes in practice.  Per 1080p frame the
// function reads the frame (2.07 MB) and writes the near mask (2.07 MB),
// level 1 (1.04 MB in bfloat16, 2.07 MB in float32) and the coarse plane:
// 0.20 ms per batch of 128 at 3.35 TB/s on the refine route.  Once each
// pixel is read from device memory once and every intermediate plane stays
// on chip, what is left is per-pixel instructions (every one a pixel costs
// about 0.02 ms a batch on the integer pipes) and
// the grey halo each tile stages again.  So the design counts instructions
// per pixel and sizes tiles to cut the halo.
//
// One launch; one block of 288 threads per tile of th x tw output pixels
// (ops/frontend.py plan: multiples of lcm(ds, 2), tw also of 16 for frames
// 16 bytes wide, so every coarse and level-1 cell lies inside one tile and
// such rows store whole 16-byte chunks; th and tw chosen to stage the
// fewest grey pixels with two blocks an SM).  Each block:
//  1. stages the tile's grey with its halo of r + eb pixels (eb = 2 r_open
//     + 2, what the morphology chain needs) as u8 rows in shared memory,
//     16 bytes an item from five aligned 32-bit loads funnel-shifted to the
//     row's alignment, so rows of any width and alignment load whole; zeros
//     outside the image; a thread issues all its loads before it stores;
//  2. slides column sums of 2r+1 rows down, one grey column a thread (u16,
//     u32 for r > 128);
//  3. gives each thread one 32-column word of one mask row: the box sum
//     slides along the word in a register and the black bits (g * area <
//     sum) pack into it directly;
//  4. runs r_open erosions, r_open dilations (the opened mask, kept) and
//     two dilations (the near mask) in registers: a warp holds whole mask
//     rows of a 32-row window (64 for open radii above 4), and a step is
//     one funnel shift per word for the neighbours along the row and one
//     shuffle for the rows above and below; cells outside the image take
//     the padding of the op about to read them, as the XLA code pads each
//     stage.  The warps without a window meanwhile take level 1 from the
//     staged grey: four columns of two rows an item, the row pairs of two
//     columns at a time summed in the 16-bit halves of a word;
//  5. writes the near mask (and the opened mask where asked for) as 16-byte
//     stores of one bool a pixel, narrower at unaligned row ends, and each
//     coarse cell from popcounts of at most two words a row.
// The grey and column-sum row pitches are odd in 4-byte words, so the 32
// rows a warp reads fall in 32 banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 288;
constexpr int WARPS = THREADS / 32;
constexpr int NWMAX = 9;  // mask words a row: tw + 2 eb <= 288
constexpr int SMEM_MAX = 232448;
constexpr int STAGE = 8;  // staging items a thread loads before it stores

struct Layout {
  int eb, eg, mr, mc, nw, gr, gc, go, pc, pg;
  size_t off_c, off_g, total;
  bool wide;
};

__host__ __device__ inline size_t r16(size_t n) { return (n + 15) / 16 * 16; }

// The block's shared memory; ops/frontend.py smem_bytes mirrors it.
__host__ __device__ inline Layout layout(int th, int tw, int r, int r_open) {
  Layout l;
  l.eb = 2 * r_open + 2;          // mask halo the morphology chain needs
  l.eg = r + l.eb;                // grey halo
  l.mr = th + 2 * l.eb;           // mask rows
  l.mc = tw + 2 * l.eb;           // mask columns
  l.nw = (l.mc + 31) / 32;        // mask words per row
  l.gr = th + 2 * l.eg;           // grey rows
  l.gc = tw + 2 * l.eg;           // grey columns
  l.go = (4 - l.eg % 4) % 4;      // grey column c at byte go + c: tile column 0 4-aligned
  l.wide = (2 * r + 1) * 255 > 65535;
  l.pc = l.wide ? (l.gc | 1) : l.gc + ((2 - l.gc) % 4 + 4) % 4;
  l.pg = (l.go + l.gc + 3) / 8 * 8 + 4;
  l.off_c = r16(size_t(2) * l.nw * l.mr * 4);
  l.off_g = l.off_c + r16(size_t(l.mr) * l.pc * (l.wide ? 4 : 2));
  l.total = l.off_g + r16(size_t(l.gr) * l.pg);
  return l;
}

struct Args {
  const uint8_t* grey;
  uint8_t* near;
  uint8_t* opened;  // may be null
  uint8_t* coarse;
  void* level1;  // __nv_bfloat16 where chain, else float
  int chain;
  int H, W, r, r_open, ds, th, tw, hc, wc, h1, w1;
};

// Mask rows a lane holds in the morphology: a 32-row window keeps 32 - 2 eb
// exact rows, a 64-row one 64 - 2 eb; ops/frontend.py plan mirrors this.
__host__ __device__ inline int morph_rows_per_lane(int eb) { return eb <= 10 ? 1 : 2; }

// q / d for q * d < 2^32: the high word of q * ceil(2^32 / d).
struct Div {
  uint32_t m;  // 0 for d = 1
  __device__ explicit Div(int d) : m(d > 1 ? 0xffffffffu / uint32_t(d) + 1u : 0u) {}
  __device__ __forceinline__ int operator()(int q) const {
    return m ? int(__umulhi(uint32_t(q), m)) : q;
  }
};

// Bits j of a mask word whose column xb + j lies in [0, W).
__device__ __forceinline__ uint32_t col_mask(int xb, int W) {
  const int lo = min(max(-xb, 0), 32);
  const int hi = min(max(W - xb, 0), 32);
  if (hi <= lo) return 0u;
  const uint32_t upto = hi == 32 ? ~0u : ((1u << hi) - 1u);
  return upto & ~((1u << lo) - 1u);
}

__device__ __forceinline__ uint32_t bit_range(int lo, int hi) {  // 0 <= lo < hi <= 32
  return (hi == 32 ? ~0u : ((1u << hi) - 1u)) & ~((1u << lo) - 1u);
}

// 4 bits -> 4 bytes of 0/1 (byte j = bit j).
__device__ __forceinline__ uint32_t spread4(uint32_t n) { return (n * 0x00204081u) & 0x01010101u; }

// One mask plane (words M, [word][row]) of the tile's output rows into a
// (B, H, W) byte plane, a half-warp a row: 16-byte stores where an aligned
// chunk lies inside the row's tile span, 4-byte or 1-byte ones at its ends.
__device__ void store_mask(uint8_t* plane, const uint32_t* M, const Layout& L, const Args& a,
                           int b, int y0, int x0) {
  const int rows = min(a.th, a.H - y0);
  const int xend = min(x0 + a.tw, a.W);
  if (rows <= 0 || xend <= x0) return;
  const int nch = a.tw / 16 + 2;
  for (int t = threadIdx.x >> 4; t < rows; t += THREADS / 16) {
    const int i = t + L.eb;
    uint8_t* row = plane + (size_t(b) * a.H + y0 + t) * a.W;
    const uintptr_t start = reinterpret_cast<uintptr_t>(row + x0);
    for (int kk = threadIdx.x & 15; kk < nch; kk += 16) {
      const uintptr_t A = (start & ~uintptr_t(15)) + uintptr_t(16) * kk;
      const int xf = x0 + int(intptr_t(A - start));
      if (xf >= xend || xf + 16 <= x0) continue;
      // Bits of columns xf .. xf + 15: mask bit m - 16 onwards, m >= 1.
      const int m = xf - x0 + L.eb + 16;
      const int k = m >> 5, o = m & 31;
      const uint32_t w0 = (k >= 1 && k - 1 < L.nw) ? M[(k - 1) * L.mr + i] : 0u;
      const uint32_t w1 = k < L.nw ? M[k * L.mr + i] : 0u;
      const uint32_t w2 = k + 1 < L.nw ? M[(k + 1) * L.mr + i] : 0u;
      const uint32_t bits =
          o >= 16 ? __funnelshift_r(w1, w2, o - 16) : __funnelshift_r(w0, w1, o + 16);
      const uint32_t v[4] = {spread4(bits & 15u), spread4((bits >> 4) & 15u),
                             spread4((bits >> 8) & 15u), spread4((bits >> 12) & 15u)};
      if (xf >= x0 && xf + 16 <= xend) {
        *reinterpret_cast<uint4*>(A) = make_uint4(v[0], v[1], v[2], v[3]);
        continue;
      }
      for (int q = 0; q < 4; ++q) {
        const int x = xf + 4 * q;
        if (x >= x0 && x + 4 <= xend) {
          reinterpret_cast<uint32_t*>(A)[q] = v[q];
        } else {
          for (int j = 0; j < 4; ++j)
            if (x + j >= x0 && x + j < xend) row[x + j] = (v[q] >> (8 * j)) & 1u;
        }
      }
    }
  }
}

// One staging item: bytes 16 (q % nch) .. + 15 of staged row q / nch of
// the tile at (y0, x0) of frame b, as four words.  Staged row j is image
// row y0 - eg + j from image column x0 - eg - go; zeros outside the image.
__device__ __forceinline__ void load_item(uint32_t (&w)[4], const Args& a, const Layout& L,
                                          const Div& by_nch, int nch, int b, int y0, int x0,
                                          int q) {
  const int row = by_nch(q);
  const int y = y0 - L.eg + row;
  const int xf = x0 - L.eg - L.go + 16 * (q - row * nch);
  const int H = a.H, W = a.W;
  const uint8_t* g = a.grey + size_t(b) * H * W;
  const uintptr_t at = reinterpret_cast<uintptr_t>(g) + uintptr_t(intptr_t(y) * W + xf);
  const int lead = int(at & 3u);
  if (y >= 0 && y < H && xf - lead >= 0 && xf - lead + 20 <= W) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(at - lead);
    uint32_t x[5];
#pragma unroll
    for (int m = 0; m < 5; ++m) x[m] = __ldg(src + m);
#pragma unroll
    for (int m = 0; m < 4; ++m) w[m] = __funnelshift_r(x[m], x[m + 1], 8 * lead);
  } else {
    const bool row_in = y >= 0 && y < H;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t word = 0;
      for (int j = 0; j < 4; ++j) {
        const int x = xf + 4 * m + j;
        if (row_in && x >= 0 && x < W) word |= uint32_t(g[size_t(y) * W + x]) << (8 * j);
      }
      w[m] = word;
    }
  }
}

__device__ __forceinline__ void store_item(const uint32_t (&w)[4], uint8_t* gs, const Layout& L,
                                           const Div& by_nch, int nch, int q) {
  const int row = by_nch(q);
  const int c0 = 16 * (q - row * nch);
  uint32_t* dst = reinterpret_cast<uint32_t*>(gs + row * L.pg + c0);
#pragma unroll
  for (int m = 0; m < 4; ++m)
    if (c0 + 4 * m < L.pg) dst[m] = w[m];
}

// The chain's level-1 value of a column pair from its two row-pair sums
// (integers up to 510): each rounded to bfloat16, then 0.25 of each summed
// in float32 (exact) and rounded to bfloat16.
__device__ __forceinline__ __nv_bfloat16 chain_pair(uint32_t r0, uint32_t r1) {
  const float a = __bfloat162float(__float2bfloat16_rn(static_cast<float>(r0)));
  const float c = __bfloat162float(__float2bfloat16_rn(static_cast<float>(r1)));
  return __float2bfloat16_rn(0.25f * a + 0.25f * c);
}

// Level 1 of the tile from the staged grey (zeros outside the image),
// items first, first + stride, ...: an item is four tile columns of a pair
// of rows, two 32-bit loads; the row pairs of columns 0 and 2 (and of 1
// and 3) add up in the two 16-bit halves of a word.
__device__ void level1_items(const Args& a, const Layout& L, const uint8_t* gs, int b, int y0,
                             int x0, int first, int stride) {
  const int yi0 = y0 / 2;
  const int nyi = max(min(a.th / 2, a.h1 - yi0), 0);
  const int nq = (a.tw + 3) / 4;
  const Div by_nq(nq);
  const uint8_t* tile = gs + L.eg * L.pg + L.go + L.eg;  // 4-byte aligned
  for (int q = first; q < nyi * nq; q += stride) {
    const int p = by_nq(q);
    const int cq = q - p * nq;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(tile + 2 * p * L.pg) + cq;
    const uint32_t u0 = src[0], u1 = src[L.pg / 4];
    const uint32_t ev = (u0 & 0x00ff00ffu) + (u1 & 0x00ff00ffu);
    const uint32_t od = ((u0 >> 8) & 0x00ff00ffu) + ((u1 >> 8) & 0x00ff00ffu);
    const int xi = x0 / 2 + 2 * cq;
    const size_t at = (size_t(b) * a.h1 + yi0 + p) * a.w1 + xi;
    const bool second = 4 * cq + 4 <= a.tw && xi + 1 < a.w1;
    if (a.chain) {
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.level1) + at;
      if (xi < a.w1) dst[0] = chain_pair(ev & 0xffffu, od & 0xffffu);
      if (second) dst[1] = chain_pair(ev >> 16, od >> 16);
    } else {
      const uint32_t s = ev + od;
      float* dst = static_cast<float*>(a.level1) + at;
      if (xi < a.w1) dst[0] = float(s & 0xffffu) * 0.25f;
      if (second) dst[1] = float(s >> 16) * 0.25f;
    }
  }
}

template <typename CT>
__global__ void __launch_bounds__(THREADS, 2) frontend_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(a.th, a.tw, a.r, a.r_open);
  uint32_t* cur = reinterpret_cast<uint32_t*>(smem);  // mask words, [word][row]: black, then near
  uint32_t* opn = cur + L.nw * L.mr;                   // the opened mask
  CT* cs = reinterpret_cast<CT*>(smem + L.off_c);     // column sums, [mask row][grey col]
  uint8_t* gs = smem + L.off_g;                        // grey, [grey row][go + grey col]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int H = a.H, W = a.W, r = a.r;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * a.th;
  const int x0 = blockIdx.x * a.tw;

  // 1. Stage the tile's grey: every load of a thread's items is issued
  //    before any of them is stored.
  {
    const int nch = (L.go + L.gc + 15) / 16;
    const int nitems = L.gr * nch;
    const Div by_nch(nch);
    for (int q0 = 0; q0 < nitems; q0 += STAGE * THREADS) {
      uint32_t w[STAGE][4];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int q = q0 + u * THREADS + tid;
        if (q < nitems) load_item(w[u], a, L, by_nch, nch, b, y0, x0, q);
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int q = q0 + u * THREADS + tid;
        if (q < nitems) store_item(w[u], gs, L, by_nch, nch, q);
      }
    }
  }
  __syncthreads();

  // 2. Column sums: mask row i sums grey rows i .. i + 2r; four rows a
  //    step, their loads ahead of the stores.
  const int d2 = 2 * r;
  for (int c = tid; c < L.gc; c += THREADS) {
    const uint8_t* col = gs + L.go + c;
    CT* out = cs + c;
    int s = 0;
    for (int d = 0; d <= d2; ++d) s += col[d * L.pg];
    out[0] = static_cast<CT>(s);
    const uint8_t* in = col + (d2 + 1) * L.pg;  // row entering at mask row 1
    const uint8_t* gone = col;                  // row leaving at mask row 1
    int i = 1;
    for (; i + 4 <= L.mr; i += 4) {
      int add[4], sub[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) add[u] = in[u * L.pg], sub[u] = gone[u * L.pg];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s += add[u] - sub[u];
        out[(i + u) * L.pc] = static_cast<CT>(s);
      }
      in += 4 * L.pg;
      gone += 4 * L.pg;
    }
    for (; i < L.mr; ++i) {
      s += int(*in) - int(*gone);
      out[i * L.pc] = static_cast<CT>(s);
      in += L.pg;
      gone += L.pg;
    }
  }

  __syncthreads();

  // 3. Black bits, one (mask row, word) per thread; mask column m is image
  //    column x0 - eb + m, and its box covers column sums m .. m + 2r.
  {
    const int items = L.mr * L.nw;
    const Div by_mr(L.mr);
    for (int q = tid; q < items; q += THREADS) {
      const int k = by_mr(q);
      const int i = q - k * L.mr;
      const int y = y0 - L.eb + i;
      uint32_t bits = 0;
      if (y >= 0 && y < H) {
        const int ah = min(y + r, H - 1) - max(y - r, 0) + 1;
        const int m0 = 32 * k;
        const CT* crow = cs + i * L.pc + m0;
        const uint8_t* grow = gs + (i + r) * L.pg + L.go + r + m0;
        const int n = min(32, L.mc - m0);
        const int xb = x0 - L.eb + m0;
        int s = 0;
        for (int d = 0; d <= d2; ++d) s += crow[d];
        if (n == 32 && xb - r >= 0 && xb + 31 + r < W) {
          // All 32 boxes inside the image: one area for the word.
          const int area = ah * (d2 + 1);
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            if (j > 0) s += int(crow[j + d2]) - int(crow[j - 1]);
            if (int(grow[j]) * area < s) bits |= 1u << j;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            if (j < n) {
              if (j > 0) s += int(crow[j + d2]) - int(crow[j - 1]);
              const int x = xb + j;
              if (x >= 0 && x < W) {
                const int aw = min(x + r, W - 1) - max(x - r, 0) + 1;
                if (int(grow[j]) * ah * aw < s) bits |= 1u << j;
              }
            }
          }
        }
      }
      cur[k * L.mr + i] = bits;
      if (a.r_open == 0) opn[k * L.mr + i] = bits;
    }
  }
  __syncthreads();

  // 4. The morphology chain in registers, beside level 1.  Warp w < nwin
  //    takes a window of 32 mask rows a lane-row (rpl = 1, lane l row l)
  //    or, for a wide halo, of 64 (rpl = 2, lane l rows 2l and 2l + 1),
  //    each row whole (NWMAX words).  A step spoils one more row at each
  //    end of the window, so after eb steps its middle rows are exact and
  //    the windows' middles tile the output rows.  The other warps take
  //    level 1 meanwhile.  The near rows go back into `cur` once every
  //    warp has read its window.
  const int rpl = morph_rows_per_lane(L.eb);
  const int step_rows = 32 * rpl - 2 * L.eb;
  const int nwin = (a.th + step_rows - 1) / step_rows;
  const int warp = tid >> 5;
  const int base = warp * step_rows;
  const int li0 = rpl * lane;  // first row of the lane in the window
  const bool in_win = warp < nwin;
  const bool out0 = in_win && li0 >= L.eb && li0 < L.eb + step_rows && base + li0 < L.mr;
  const bool out1 = in_win && rpl == 2 && li0 + 1 >= L.eb && li0 + 1 < L.eb + step_rows &&
                    base + li0 + 1 < L.mr;
  const int i0 = base + li0;
  uint32_t v[2][NWMAX];
  if (in_win) {
    uint32_t cm[NWMAX], rm[2];
#pragma unroll
    for (int d = 0; d < NWMAX; ++d) cm[d] = d < L.nw ? col_mask(x0 - L.eb + 32 * d, W) : 0u;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = i0 + j;
      const int y = y0 - L.eb + i;
      rm[j] = (y >= 0 && y < H) ? ~0u : 0u;
#pragma unroll
      for (int d = 0; d < NWMAX; ++d)
        v[j][d] = (d < L.nw && i < L.mr && j < rpl) ? cur[d * L.mr + i] : 0u;
    }
    for (int st = 0; st < L.eb; ++st) {
      const bool erode = st < a.r_open;
      uint32_t h[2][NWMAX];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j == 1 && rpl == 1) break;
        uint32_t p[NWMAX];
        // Cells outside the image take the padding of this step's op.
#pragma unroll
        for (int d = 0; d < NWMAX; ++d)
          p[d] = erode ? (v[j][d] | ~(cm[d] & rm[j])) : (v[j][d] & cm[d] & rm[j]);
#pragma unroll
        for (int d = 0; d < NWMAX; ++d) {
          const uint32_t lf = d > 0 ? __funnelshift_l(p[d - 1], p[d], 1) : (p[d] << 1);
          const uint32_t rt = d + 1 < NWMAX ? __funnelshift_r(p[d], p[d + 1], 1) : (p[d] >> 1);
          h[j][d] = erode ? (p[d] & lf & rt) : (p[d] | lf | rt);
        }
      }
      if (rpl == 1) {
#pragma unroll
        for (int d = 0; d < NWMAX; ++d) {
          const uint32_t up = __shfl_up_sync(0xffffffffu, h[0][d], 1);
          const uint32_t dn = __shfl_down_sync(0xffffffffu, h[0][d], 1);
          v[0][d] = erode ? (up & h[0][d] & dn) : (up | h[0][d] | dn);
        }
      } else {
#pragma unroll
        for (int d = 0; d < NWMAX; ++d) {
          const uint32_t up = __shfl_up_sync(0xffffffffu, h[1][d], 1);    // row 2l - 1
          const uint32_t dn = __shfl_down_sync(0xffffffffu, h[0][d], 1);  // row 2l + 2
          v[0][d] = erode ? (up & h[0][d] & h[1][d]) : (up | h[0][d] | h[1][d]);
          v[1][d] = erode ? (h[0][d] & h[1][d] & dn) : (h[0][d] | h[1][d] | dn);
        }
      }
      if (st == 2 * a.r_open - 1) {
#pragma unroll
        for (int d = 0; d < NWMAX; ++d) {
          if (d < L.nw && out0) opn[d * L.mr + i0] = v[0][d];
          if (d < L.nw && out1) opn[d * L.mr + i0 + 1] = v[1][d];
        }
      }
    }
  } else {
    level1_items(a, L, gs, b, y0, x0, tid - 32 * nwin, THREADS - 32 * nwin);
  }
  __syncthreads();
  if (nwin == WARPS) level1_items(a, L, gs, b, y0, x0, tid, THREADS);
#pragma unroll
  for (int d = 0; d < NWMAX; ++d) {
    if (d < L.nw && out0) cur[d * L.mr + i0] = v[0][d];
    if (d < L.nw && out1) cur[d * L.mr + i0 + 1] = v[1][d];
  }
  __syncthreads();

  // 5. Outputs.
  store_mask(a.near, cur, L, a, b, y0, x0);
  if (a.opened != nullptr) store_mask(a.opened, opn, L, a, b, y0, x0);

  const int ds = a.ds;
  const int cy0 = y0 / ds, cx0 = x0 / ds;
  const int ncy = min(a.th / ds, a.hc - cy0);
  const int ncx = min(a.tw / ds, a.wc - cx0);
  if (ncy > 0 && ncx > 0) {
    const Div by_ncx(ncx);
    for (int q = tid; q < ncy * ncx; q += THREADS) {
      const int qy = by_ncx(q);
      const int cy = cy0 + qy;
      const int cx = cx0 + q - qy * ncx;
      const int ye = min(cy * ds + ds, H);
      const int m0 = cx * ds - x0 + L.eb;
      const int m1 = min(cx * ds + ds, W) - x0 + L.eb;
      int count = 0;
      if (m1 - m0 <= 32) {
        // At most two words a row: their masks once for the cell.
        const int k = m0 >> 5;
        const uint32_t s0 = bit_range(m0 - 32 * k, min(m1 - 32 * k, 32));
        const uint32_t s1 = m1 > 32 * (k + 1) ? bit_range(0, m1 - 32 * (k + 1)) : 0u;
        const uint32_t* c0 = opn + k * L.mr;
        const uint32_t* c1 = s1 ? c0 + L.mr : c0;
        for (int y = cy * ds; y < ye; ++y) {
          const int i = y - y0 + L.eb;
          count += __popc(c0[i] & s0) + __popc(c1[i] & s1);
        }
      } else {
        for (int y = cy * ds; y < ye; ++y) {
          const int i = y - y0 + L.eb;
          for (int k = m0 >> 5; k <= (m1 - 1) >> 5; ++k) {
            const uint32_t sel = bit_range(max(m0 - 32 * k, 0), min(m1 - 32 * k, 32));
            count += __popc(opn[k * L.mr + i] & sel);
          }
        }
      }
      a.coarse[(size_t(b) * a.hc + cy) * a.wc + cx] = count * 2 >= max(ds, 2) ? 1 : 0;
    }
  }
}

}  // namespace

// grey (B,H,W) u8 -> near (B,H,W) and, unless null, opened (B,H,W) as 0/1
// bytes, coarse (B,hc,wc) 0/1 bytes, level1 (B,h1,w1) (bf16 by the chain
// where chain, else exact f32), in one launch of th x tw tiles
// (ops/frontend.py plan).  Returns a cudaError_t.
extern "C" int a3_frontend(const uint8_t* grey, uint8_t* near, uint8_t* opened,
                           uint8_t* coarse, void* level1, int chain, int B, int H, int W, int r,
                           int r_open, int ds, int th, int tw, int hc, int wc, int h1, int w1,
                           cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  if (B > 65535 || r < 0 || r_open < 0 || 2 * r_open + 2 >= 32 || ds < 1 || th <= 0 ||
      tw <= 0 || th % ds || tw % ds || th % 2 || tw % 2)
    return cudaErrorInvalidValue;
  const Layout L = layout(th, tw, r, r_open);
  // Whole mask rows in NWMAX words; one morphology window a warp.
  if (L.total > size_t(SMEM_MAX) || L.nw > NWMAX ||
      (th - 1) / (32 * morph_rows_per_lane(L.eb) - 2 * L.eb) + 1 > WARPS)
    return cudaErrorInvalidValue;
  const Args a{grey, near, opened, coarse, level1, chain, H, W, r, r_open, ds, th, tw, hc, wc,
               h1,   w1};
  const dim3 grid((max(W, 2 * w1) + tw - 1) / tw, (max(H, 2 * h1) + th - 1) / th, B);
  const int smem = static_cast<int>(L.total);
  auto kernel = L.wide ? frontend_kernel<uint32_t> : frontend_kernel<uint16_t>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}
