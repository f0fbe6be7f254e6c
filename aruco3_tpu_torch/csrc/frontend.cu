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
// What bounds it on an H100: device-memory bytes in principle (per 1080p
// frame it reads the frame, 2.07 MB, and writes the near mask, 2.07 MB,
// level 1, 1.04 MB in bfloat16, and the coarse plane: 0.20 ms a batch of
// 128 at 3.35 TB/s on the refine route); in practice each block's latency:
// every phase between two barriers waits on its slowest warp's chain of
// dependent loads and adds.  A block that stages a whole tile stages its
// vertical halo again (24% more grey rows at 1080p) and waits on that
// load.  So a block walks:
//
// One launch; a block of 288 threads owns a column strip of one frame (tw
// output columns and a grey halo of eg = r + eb each side, eb = 2 r_open + 2
// the morphology's) and walks down a run of its rows in chunks of R rows
// (ops/frontend.py plan: R, the run and tw multiples of lcm(ds, 2), tw also
// of 16 for frames 16 bytes wide, so every coarse and level-1 cell lies in
// one chunk of one strip; R at most 64 rows and letting two blocks
// share an SM, as a chunk's barriers cost about the same at any height and
// the registers hold two blocks; a frame alone takes one chunk a block).
// Over the walk each grey row is staged once, and each mask row computed
// once, apart from a run's first 2 eb:
//  1. grey rows go into a ring of shared memory by cp.async 16-byte copies:
//     the next chunk's rows are in flight while a chunk is computed.  A row
//     is copied as the aligned 16-byte pieces that cover its span, its
//     first byte at offset o (0..15) in its slot; a table a chunk gives
//     each of its rows' slot and offset.  Pieces outside the image are
//     zero-filled; bytes of a piece outside the row are never read as
//     pixels;
//  2. each thread owns one grey column (two where the strip and its halo
//     are wider than the block: r above ~137 at open radius 2) and carries its
//     box column sum (2r + 1 rows; u16, u32 for r > 127) down the strip: a
//     row that enters added, the row that leaves taken off, each mask
//     row's sum stored;
//  3. each thread takes one 32-column word of one mask row: the box sum
//     slides along the word in a register and the black bits (g * area <
//     sum) pack into it directly, the grey bytes taken from the 4-byte
//     words that hold them (a warp's 32 rows share 8 banks);
//  4. r_open erosions, r_open dilations (the opened mask) and two
//     dilations (the near mask) in registers, each erosion a dilation of
//     the complement: a warp holds whole mask rows of a 32-row window (64
//     for open radii above 4), and a step is one funnel shift per word for
//     the neighbours along the row and one shuffle for the rows above and
//     below; cells outside the image take the padding of the op about to
//     read them, as the XLA code pads each stage.  A chunk's windows cover
//     mask rows eb above and below its own rows; the last 2 eb black rows
//     carry to the next chunk.  The warps without a window meanwhile take
//     the chunk's level 1 from the ring: four columns of two rows an item,
//     the row pairs of two columns at a time summed in the 16-bit halves
//     of a word, converted to float by exponent bits (no conversion
//     instruction) and stored in pairs;
//  5. stores the chunk's near mask (and the opened mask where asked for) as
//     16-byte stores of one bool a pixel, narrower at unaligned row ends,
//     and each of its coarse cells from popcounts of at most two words a
//     row.
// The near and opened words of a chunk replace its column sums once the
// black bits are made; the column-sum pitch is odd in 4-byte words, so the
// 32 rows a warp reads fall in 32 banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 288;
constexpr int WARPS = THREADS / 32;
constexpr int NWMAX = 9;  // mask words a row: tw + 2 eb <= 288
constexpr int SMEM_MAX = 232448;

struct Layout {
  int eb, eg, mr, nw, gc, nch, pg, nr, tr, pc;
  size_t off_c, off_g, off_t, total;
  bool wide;
};

__host__ __device__ inline size_t r16(size_t n) { return (n + 15) / 16 * 16; }

// The block's shared memory for chunks of R rows; a walk of more than one
// chunk keeps the next chunk's rows, and its table, too.  ops/frontend.py
// smem_bytes mirrors it.
__host__ __device__ inline Layout layout(int R, int tw, int r, int r_open, bool walk) {
  Layout l;
  l.eb = 2 * r_open + 2;             // mask halo the morphology chain needs
  l.eg = r + l.eb;                   // grey halo
  l.mr = R + 2 * l.eb;               // mask rows of a chunk's windows
  l.nw = (tw + 2 * l.eb + 31) / 32;  // mask words per row
  l.gc = tw + 2 * l.eg;              // grey columns
  l.nch = ((l.gc + 33) / 16) | 1;    // 16-byte pieces a slot (offset, span, load4's reach), odd
  l.pg = 16 * l.nch;                 // ring slot pitch
  l.nr = (walk ? 2 * R : R) + 2 * l.eg;  // ring slots
  l.tr = R + 2 * l.eg;                   // rows of a chunk's table
  l.wide = (2 * r + 1) * 255 > 65535;
  l.pc = l.wide ? (l.gc | 1) : l.gc + ((2 - l.gc) % 4 + 4) % 4;
  const size_t sums = r16(size_t(l.mr) * l.pc * (l.wide ? 4 : 2));
  const size_t masks = r16(size_t(2) * l.nw * R * 4);
  l.off_c = r16(size_t(l.nw) * l.mr * 4);
  l.off_g = l.off_c + (sums > masks ? sums : masks);
  l.off_t = l.off_g + size_t(l.nr) * l.pg;
  l.total = l.off_t + r16(size_t(walk ? 2 : 1) * l.tr * 4);
  return l;
}

struct Args {
  const uint8_t* grey;
  uint8_t* near;
  uint8_t* opened;  // may be null
  uint8_t* coarse;
  void* level1;  // __nv_bfloat16 where chain, else float
  int chain;
  int H, W, r, r_open, ds, run, R, tw, hc, wc, h1, w1;
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

// Four bytes from shared memory at any alignment (two aligned words).
__device__ __forceinline__ uint32_t load4(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  return __funnelshift_r(w[0], w[1], 8 * uint32_t(a & 3u));
}

__device__ __forceinline__ void copy16(void* dst, const void* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Where the block is: frame b's strip at x0, its run from y0.  Staged
// column c is image column xs + c (xs = x0 - eg); image row y is in ring
// slot (y - yg0) mod nr (yg0 = y0 - eg, the run's first staged row).
struct Place {
  uintptr_t frame;  // address of frame b's pixel (0, 0)
  int b, x0, y0, xs, yg0;
};

// Start the copies of image rows [ys, ys + n) into their ring slots.
__device__ void stage_rows(const Args& a, const Layout& L, const Place& P, uint8_t* ring,
                           const Div& by_nch, const Div& by_nr, int ys, int n) {
  const int items = n * L.nch;
  for (int q = threadIdx.x; q < items; q += THREADS) {
    const int j = by_nch(q);
    const int p = q - j * L.nch;
    const int y = ys + j;
    const int rel = y - P.yg0;
    const int slot = rel - L.nr * by_nr(rel);
    const uintptr_t row = P.frame + intptr_t(y) * a.W;
    const uintptr_t src = ((row + intptr_t(P.xs)) & ~uintptr_t(15)) + uintptr_t(16) * p;
    const bool in = y >= 0 && y < a.H && src < row + a.W && src + 16 > row;
    copy16(ring + size_t(slot) * L.pg + 16 * p,
           in ? reinterpret_cast<const void*>(src) : static_cast<const void*>(a.grey), in);
  }
}

// Chunk table: entry t is the byte in the ring of staged column 0 of image
// row Y - eg + t (its slot's start plus the row's offset there).
__device__ void fill_table(uint32_t* T, const Args& a, const Layout& L, const Place& P,
                           const Div& by_nr, int Y) {
  for (int t = threadIdx.x; t < L.tr; t += THREADS) {
    const int y = Y - L.eg + t;
    const int rel = y - P.yg0;
    const int slot = rel - L.nr * by_nr(rel);
    const uintptr_t at = P.frame + intptr_t(y) * a.W + intptr_t(P.xs);
    T[t] = uint32_t(slot) * uint32_t(L.pg) + uint32_t(at & 15u);
  }
}

// One mask plane's words M ([word][row], R rows: the chunk's output rows)
// into a (B, H, W) byte plane, a half-warp a row: 16-byte stores where an
// aligned chunk lies inside the row's strip span, 4-byte or 1-byte ones at
// its ends.  Mask bit m is image column x0 - eb + m.
__device__ void store_mask(uint8_t* plane, const uint32_t* M, const Layout& L, const Args& a,
                           int b, int Y, int x0) {
  const int rows = min(a.R, a.H - Y);
  const int xend = min(x0 + a.tw, a.W);
  if (rows <= 0 || xend <= x0) return;
  const int nch = a.tw / 16 + 2;
  for (int t = threadIdx.x >> 4; t < rows; t += THREADS / 16) {
    uint8_t* row = plane + (size_t(b) * a.H + Y + t) * a.W;
    const uintptr_t start = reinterpret_cast<uintptr_t>(row + x0);
    for (int kk = threadIdx.x & 15; kk < nch; kk += 16) {
      const uintptr_t A = (start & ~uintptr_t(15)) + uintptr_t(16) * kk;
      const int xf = x0 + int(intptr_t(A - start));
      if (xf >= xend || xf + 16 <= x0) continue;
      // Bits of columns xf .. xf + 15: mask bit m - 16 onwards, m >= 1.
      const int m = xf - x0 + L.eb + 16;
      const int k = m >> 5, o = m & 31;
      const uint32_t w0 = (k >= 1 && k - 1 < L.nw) ? M[(k - 1) * a.R + t] : 0u;
      const uint32_t w1 = k < L.nw ? M[k * a.R + t] : 0u;
      const uint32_t w2 = k + 1 < L.nw ? M[(k + 1) * a.R + t] : 0u;
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

// n as a float, exactly, for n < 2^23 (on the full-rate pipes).
__device__ __forceinline__ float int_float(uint32_t n) {
  return __uint_as_float(0x4B000000u | n) - 8388608.0f;
}

// The chain's level-1 values of two column pairs from their row-pair sums
// (integers up to 510; pair 0's in the low halves of ev and od, ev the
// even column's): each sum rounded to bfloat16, then 0.25 of each summed
// in float32 (exact) and rounded to bfloat16.
__device__ __forceinline__ __nv_bfloat162 chain_pairs(uint32_t ev, uint32_t od) {
  const float2 p0 = __bfloat1622float2(
      __floats2bfloat162_rn(int_float(ev & 0xffffu), int_float(od & 0xffffu)));
  const float2 p1 = __bfloat1622float2(__floats2bfloat162_rn(int_float(ev >> 16), int_float(od >> 16)));
  return __floats2bfloat162_rn(0.25f * p0.x + 0.25f * p0.y, 0.25f * p1.x + 0.25f * p1.y);
}

// Level 1 of the chunk's rows Y .. Y + R - 1 from the ring (zeros outside
// the image), items first, first + stride, ...: an item is four strip
// columns of a pair of rows; the row pairs of columns 0 and 2 (and of 1
// and 3) add up in the two 16-bit halves of a word.
__device__ void level1_items(const Args& a, const Layout& L, const uint8_t* ring,
                             const uint32_t* T, int b, int Y, int x0, int first, int stride) {
  const int yi0 = Y / 2;
  const int nyi = max(min(a.R / 2, a.h1 - yi0), 0);
  const int nq = (a.tw + 3) / 4;
  const Div by_nq(nq);
#pragma unroll 2
  for (int q = first; q < nyi * nq; q += stride) {
    const int p = by_nq(q);
    const int cq = q - p * nq;
    const int col = L.eg + 4 * cq;  // staged column of strip column 4 cq
    const int valid = min(max(a.W - (x0 + 4 * cq), 0), 4);
    const uint32_t keep = valid == 4 ? ~0u : ((1u << (8 * valid)) - 1u);
    const uint32_t u0 = load4(ring + T[L.eg + 2 * p] + col) & keep;
    const uint32_t u1 = load4(ring + T[L.eg + 2 * p + 1] + col) & keep;
    const uint32_t ev = (u0 & 0x00ff00ffu) + (u1 & 0x00ff00ffu);
    const uint32_t od = ((u0 >> 8) & 0x00ff00ffu) + ((u1 >> 8) & 0x00ff00ffu);
    const int xi = x0 / 2 + 2 * cq;
    const size_t at = (size_t(b) * a.h1 + yi0 + p) * a.w1 + xi;
    const bool second = 4 * cq + 4 <= a.tw && xi + 1 < a.w1;
    // Both values in one store where the pair is aligned.
    if (a.chain) {
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.level1) + at;
      const __nv_bfloat162 v = chain_pairs(ev, od);
      if (second && (at & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = v;
      } else {
        if (xi < a.w1) dst[0] = v.x;
        if (second) dst[1] = v.y;
      }
    } else {
      const uint32_t s = ev + od;
      float* dst = static_cast<float*>(a.level1) + at;
      const float v0 = int_float(s & 0xffffu) * 0.25f, v1 = int_float(s >> 16) * 0.25f;
      if (second && (at & 1) == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        if (xi < a.w1) dst[0] = v0;
        if (second) dst[1] = v1;
      }
    }
  }
}

// TWO: strips wider than the block, a thread taking a second grey column.
template <typename CT, int RPL, bool TWO>
__global__ void __launch_bounds__(THREADS, 2) frontend_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = a.R;
  const Layout L = layout(R, a.tw, a.r, a.r_open, a.run > R);
  uint32_t* M = reinterpret_cast<uint32_t*>(smem);    // black words, [word][mask row]
  CT* cs = reinterpret_cast<CT*>(smem + L.off_c);    // column sums, [mask row][grey col]
  uint32_t* N = reinterpret_cast<uint32_t*>(smem + L.off_c);  // near words, [word][row]
  uint32_t* O = N + L.nw * R;                                 // opened words
  uint8_t* ring = smem + L.off_g;
  uint32_t* tables = reinterpret_cast<uint32_t*>(smem + L.off_t);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int H = a.H, W = a.W, r = a.r;

  Place P;
  P.b = blockIdx.z;
  P.x0 = blockIdx.x * a.tw;
  P.y0 = blockIdx.y * a.run;
  P.xs = P.x0 - L.eg;
  P.yg0 = P.y0 - L.eg;
  P.frame = reinterpret_cast<uintptr_t>(a.grey) + size_t(P.b) * H * W;
  const int b = P.b, x0 = P.x0;
  const int nk = (min(a.run, max(H, 2 * a.h1) - P.y0) + R - 1) / R;  // chunks of the walk
  const Div by_nch(L.nch), by_nr(L.nr);

  // The first chunk's grey rows, eg above it and eg below.
  stage_rows(a, L, P, ring, by_nch, by_nr, P.yg0, R + 2 * L.eg);
  fill_table(tables, a, L, P, by_nr, P.y0);
  copies_commit();

  int S[2] = {0, 0};  // box sums of grey columns tid (and tid + THREADS), carried down the strip
  const int carried = 2 * L.eb * L.nw;
  uint32_t carry[2] = {0u, 0u};

  const int step_rows = 32 * RPL - 2 * L.eb;
  const int nwin = (R + step_rows - 1) / step_rows;
  const int warp = tid >> 5;
  const int li0 = RPL * lane;  // first row of the lane in the window
  const bool in_win = warp < nwin;
  const int base = warp * step_rows;
  // Output row (of the chunk) of the lane's rows, where exact and inside it.
  const int p0 = base + li0 - L.eb;
  const bool out0 = in_win && li0 >= L.eb && li0 < L.eb + step_rows && p0 < R;
  const bool out1 = in_win && RPL == 2 && li0 + 1 >= L.eb && li0 + 1 < L.eb + step_rows &&
                    p0 + 1 < R;

  for (int k = 0; k < nk; ++k) {
    const int Y = P.y0 + k * R;  // the chunk's first output row
    const uint32_t* T = tables + (k & 1) * L.tr;
    copies_wait();
    __syncthreads();  // the chunk's rows and table are in; the last chunk is done
    const int i0 = k == 0 ? 0 : 2 * L.eb;  // mask rows computed here
    if (k > 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = tid + u * THREADS;
        if (q < carried) M[(q / (2 * L.eb)) * L.mr + q % (2 * L.eb)] = carry[u];
      }
    }
    if (k + 1 < nk) {  // the next chunk's new rows, in flight while this one is computed
      stage_rows(a, L, P, ring, by_nch, by_nr, Y + R + L.eg, R);
      fill_table(tables + ((k + 1) & 1) * L.tr, a, L, P, by_nr, Y + R);
      copies_commit();
    }

    // 2. Column sums: mask row i (image row Y - eb + i) sums the grey rows
    //    of table entries i .. i + 2r; row i + 2r enters, row i - 1 leaves.
#pragma unroll
    for (int u = 0; u < (TWO ? 2 : 1); ++u) {
      const int c = tid + u * THREADS;
      if (c >= L.gc) break;
      CT* out = cs + c;
      const int xc = P.xs + c;
      if (xc < 0 || xc >= W) {
        for (int i = i0; i < L.mr; ++i) out[i * L.pc] = 0;
        continue;
      }
      const uint8_t* g = ring + c;
      int& s = S[u];
      int i = i0;
      if (k == 0) {
        s = 0;
        for (int d = 0; d <= 2 * r; ++d) s += g[T[d]];
        out[0] = static_cast<CT>(s);
        i = 1;
      }
      for (; i + 4 <= L.mr; i += 4) {
        int add[4], sub[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) add[v] = g[T[i + v + 2 * r]], sub[v] = g[T[i + v - 1]];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          s += add[v] - sub[v];
          out[(i + v) * L.pc] = static_cast<CT>(s);
        }
      }
      for (; i < L.mr; ++i) {
        s += int(g[T[i + 2 * r]]) - int(g[T[i - 1]]);
        out[i * L.pc] = static_cast<CT>(s);
      }
    }
    __syncthreads();

    // 3. Black bits, one (mask row, word) per thread; mask column m is image
    //    column x0 - eb + m, grey column m + r, and its box covers column
    //    sums m .. m + 2r.
    {
      const int nrow = L.mr - i0;
      const int items = nrow * L.nw;
      const Div by_rows(nrow);
      const int d2 = 2 * r;
      for (int q = tid; q < items; q += THREADS) {
        const int kw = by_rows(q);
        const int i = i0 + q - kw * nrow;
        const int y = Y - L.eb + i;
        uint32_t bits = 0;
        if (y >= 0 && y < H) {
          const int ah = min(y + r, H - 1) - max(y - r, 0) + 1;
          const int m0 = 32 * kw;
          const CT* crow = cs + i * L.pc + m0;
          // The word's 32 grey bytes from the 4-byte words that hold them.
          const uintptr_t ga = reinterpret_cast<uintptr_t>(ring + T[i + r] + r + m0);
          const uint32_t* gw = reinterpret_cast<const uint32_t*>(ga & ~uintptr_t(3));
          const uint32_t sh = 8u * uint32_t(ga & 3u);
          const int n = min(32, L.gc - d2 - m0);
          const int xb = x0 - L.eb + m0;
          int s = 0;
          {  // the first box: four partial sums at a time
            int s1 = 0, s2 = 0, s3 = 0, d = 0;
            for (; d + 4 <= d2 + 1; d += 4) {
              s += crow[d];
              s1 += crow[d + 1];
              s2 += crow[d + 2];
              s3 += crow[d + 3];
            }
            for (; d <= d2; ++d) s += crow[d];
            s += s1 + s2 + s3;
          }
          if (n == 32 && xb - r >= 0 && xb + 31 + r < W) {
            // All 32 boxes inside the image: one area for the word.
            const int area = ah * (d2 + 1);
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const uint32_t g4 = __funnelshift_r(gw[q], gw[q + 1], sh);
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                const int j = 4 * q + jj;
                if (j > 0) s += int(crow[j + d2]) - int(crow[j - 1]);
                if (int(__byte_perm(g4, 0u, 0x4440u | jj)) * area < s) bits |= 1u << j;
              }
            }
          } else {
            for (int j = 0; j < n; ++j) {
              if (j > 0) s += int(crow[j + d2]) - int(crow[j - 1]);
              const int x = xb + j;
              if (x >= 0 && x < W) {
                const int aw = min(x + r, W - 1) - max(x - r, 0) + 1;
                const uint32_t g4 = __funnelshift_r(gw[j >> 2], gw[(j >> 2) + 1], sh);
                if (int((g4 >> (8 * (j & 3))) & 0xffu) * ah * aw < s) bits |= 1u << j;
              }
            }
          }
        }
        M[kw * L.mr + i] = bits;
      }
    }
    __syncthreads();

    // 4. The morphology chain in registers, beside level 1.  Warp w < nwin
    //    takes a window of 32 mask rows a lane-row (RPL = 1, lane l row l)
    //    or, for a wide halo, of 64 (RPL = 2, lane l rows 2l and 2l + 1),
    //    each row whole (NWMAX words).  A step spoils one more row at each
    //    end of the window, so after eb steps its middle rows are exact and
    //    the windows' middles tile the chunk's rows.  The other warps take
    //    level 1 meanwhile.
    if (in_win) {
      // Erosion is dilation of the complement (padding False for True):
      // the window holds ~black through the r_open erosions, then the mask.
      uint32_t x[RPL][NWMAX], cm[NWMAX], rm[RPL];
      const uint32_t flip = a.r_open > 0 ? ~0u : 0u;
#pragma unroll
      for (int d = 0; d < NWMAX; ++d) cm[d] = d < L.nw ? col_mask(x0 - L.eb + 32 * d, W) : 0u;
#pragma unroll
      for (int j = 0; j < RPL; ++j) {
        const int i = base + li0 + j;
        const int y = Y - L.eb + i;
        rm[j] = (y >= 0 && y < H) ? ~0u : 0u;
#pragma unroll
        for (int d = 0; d < NWMAX; ++d)
          x[j][d] = ((d < L.nw && i < L.mr) ? M[d * L.mr + i] : 0u) ^ flip;
      }
      for (int st = 0; st <= L.eb; ++st) {
        if (st == a.r_open && st > 0) {
#pragma unroll
          for (int j = 0; j < RPL; ++j)
#pragma unroll
            for (int d = 0; d < NWMAX; ++d) x[j][d] = ~x[j][d];
        }
        if (st == 2 * a.r_open) {  // the opened mask (the black mask at r_open 0)
#pragma unroll
          for (int d = 0; d < NWMAX; ++d) {
            if (d < L.nw && out0) O[d * R + p0] = x[0][d];
            if (d < L.nw && out1) O[d * R + p0 + 1] = x[RPL - 1][d];
          }
        }
        if (st == L.eb) break;
        // One dilation: cells outside the image are False.
        uint32_t h[RPL][NWMAX];
#pragma unroll
        for (int j = 0; j < RPL; ++j) {
          uint32_t p[NWMAX];
#pragma unroll
          for (int d = 0; d < NWMAX; ++d) p[d] = x[j][d] & cm[d] & rm[j];
#pragma unroll
          for (int d = 0; d < NWMAX; ++d) {
            const uint32_t lf = d > 0 ? __funnelshift_l(p[d - 1], p[d], 1) : (p[d] << 1);
            const uint32_t rt = d + 1 < NWMAX ? __funnelshift_r(p[d], p[d + 1], 1) : (p[d] >> 1);
            h[j][d] = p[d] | lf | rt;
          }
        }
#pragma unroll
        for (int d = 0; d < NWMAX; ++d) {
          const uint32_t up = __shfl_up_sync(0xffffffffu, h[RPL - 1][d], 1);  // row RPL l - 1
          const uint32_t dn = __shfl_down_sync(0xffffffffu, h[0][d], 1);      // row RPL l + RPL
          if (RPL == 1) {
            x[0][d] = up | h[0][d] | dn;
          } else {
            x[0][d] = up | h[0][d] | h[RPL - 1][d];
            x[RPL - 1][d] = h[0][d] | h[RPL - 1][d] | dn;
          }
        }
      }
#pragma unroll
      for (int d = 0; d < NWMAX; ++d) {
        if (d < L.nw && out0) N[d * R + p0] = x[0][d];
        if (d < L.nw && out1) N[d * R + p0 + 1] = x[RPL - 1][d];
      }
    } else {
      level1_items(a, L, ring, T, b, Y, x0, tid - 32 * nwin, THREADS - 32 * nwin);
    }
    __syncthreads();
    if (nwin == WARPS) level1_items(a, L, ring, T, b, Y, x0, tid, THREADS);
    if (k + 1 < nk) {  // the last 2 eb black rows, for the next chunk
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = tid + u * THREADS;
        if (q < carried) carry[u] = M[(q / (2 * L.eb)) * L.mr + R + q % (2 * L.eb)];
      }
    }

    // 5. Outputs of the chunk's rows.
    store_mask(a.near, N, L, a, b, Y, x0);
    if (a.opened != nullptr) store_mask(a.opened, O, L, a, b, Y, x0);

    const int ds = a.ds;
    const int cy0 = Y / ds, cx0 = x0 / ds;
    const int ncy = min(R / ds, a.hc - cy0);
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
          const int kw = m0 >> 5;
          const uint32_t s0 = bit_range(m0 - 32 * kw, min(m1 - 32 * kw, 32));
          const uint32_t s1 = m1 > 32 * (kw + 1) ? bit_range(0, m1 - 32 * (kw + 1)) : 0u;
          const uint32_t* c0 = O + kw * R;
          const uint32_t* c1 = s1 ? c0 + R : c0;
          for (int y = cy * ds; y < ye; ++y) {
            const int i = y - Y;
            count += __popc(c0[i] & s0) + __popc(c1[i] & s1);
          }
        } else {
          for (int y = cy * ds; y < ye; ++y) {
            const int i = y - Y;
            for (int kw = m0 >> 5; kw <= (m1 - 1) >> 5; ++kw) {
              const uint32_t sel = bit_range(max(m0 - 32 * kw, 0), min(m1 - 32 * kw, 32));
              count += __popc(O[kw * R + i] & sel);
            }
          }
        }
        a.coarse[(size_t(b) * a.hc + cy) * a.wc + cx] = count * 2 >= max(ds, 2) ? 1 : 0;
      }
    }
  }
}

using Kernel = void (*)(const Args);

template <typename CT, int RPL>
Kernel pick(bool two) {
  return two ? frontend_kernel<CT, RPL, true> : frontend_kernel<CT, RPL, false>;
}

}  // namespace

// grey (B,H,W) u8 -> near (B,H,W) and, unless null, opened (B,H,W) as 0/1
// bytes, coarse (B,hc,wc) 0/1 bytes, level1 (B,h1,w1) (bf16 by the chain
// where chain, else exact f32), in one launch: a block a strip of tw
// columns and a run of `run` rows, walked in chunks of R rows
// (ops/frontend.py plan).  Returns a cudaError_t.
extern "C" int a3_frontend(const uint8_t* grey, uint8_t* near, uint8_t* opened,
                           uint8_t* coarse, void* level1, int chain, int B, int H, int W, int r,
                           int r_open, int ds, int run, int R, int tw, int hc, int wc, int h1,
                           int w1, cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  if (B > 65535 || r < 0 || r_open < 0 || 2 * r_open + 2 >= 32 || ds < 1 || R <= 0 ||
      tw <= 0 || run < R || run % R || R % ds || tw % ds || R % 2 || tw % 2)
    return cudaErrorInvalidValue;
  const Layout L = layout(R, tw, r, r_open, run > R);
  const int rpl = morph_rows_per_lane(L.eb);
  // Whole mask rows in NWMAX words; at most two grey columns a thread; one
  // morphology window a warp.
  if (L.total > size_t(SMEM_MAX) || L.nw > NWMAX || L.gc > 2 * THREADS ||
      (R - 1) / (32 * rpl - 2 * L.eb) + 1 > WARPS)
    return cudaErrorInvalidValue;
  const Args a{grey, near, opened, coarse, level1, chain, H, W, r, r_open, ds, run, R, tw,
               hc,   wc,   h1,     w1};
  const dim3 grid((max(W, 2 * w1) + tw - 1) / tw, (max(H, 2 * h1) + run - 1) / run, B);
  const int smem = static_cast<int>(L.total);
  const bool two = L.gc > THREADS;
  const Kernel kernel = L.wide ? (rpl == 1 ? pick<uint32_t, 1>(two) : pick<uint32_t, 2>(two))
                               : (rpl == 1 ? pick<uint16_t, 1>(two) : pick<uint16_t, 2>(two));
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}
