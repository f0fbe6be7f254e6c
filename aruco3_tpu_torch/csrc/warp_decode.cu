// Kernel 4: perspective warp of each candidate and its cell-grid decode.
//
// Replaces the TPU kernel aruco3_tpu/ops/warp_gather.py warp_gather_eval
// (pallas_call at :516) with its fused decode epilogue, entered through
// aruco3_tpu/rectify.py warp_patches_dma (:457).  Its specification is the
// XLA code it reproduces: the pyramid warp of rectify._warp_setup /
// warp_patches_mxu (one pyramid level per lane, chosen from the quad's
// bounding box, one 64-px window, separable bilinear weights
// max(0, 1 - |u - j|), zero outside the window and the image, zero for a
// degenerate homography), then rectify.decode_patches up to the cell grid:
// 256-bin Otsu on the samples rounded half to even, binarize with
// `> level`, the Triangle resize of _triangle_resize_matrix(S, m) over
// rows then columns, and `> 127`.  The column weights are rounded to
// bfloat16, as both JAX warps round them (warp_gather's wxT,
// warp_patches_mxu's wx); the row weights and the blend stay float32, as
// in warp_gather.  A sample near a cell's Otsu level decodes otherwise.
//
// What bounds it on an H100: the bytes of the samples output (every lane,
// valid or not, gets its S*S floats) and, for the valid lanes, the
// arithmetic of the taps (two IEEE divisions a sample) and each block's
// chain of phases.  Design: one block per (frame, lane).  An invalid lane
// writes its zeros and leaves.  A valid lane stages its 64-px window in
// shared memory in one coalesced pass (every thread's loads issued before
// any is stored), inside a border of zeros two cells wide, so the four
// taps of a sample are shared-memory reads with no bounds test; a thread
// keeps its samples in registers (10 for S up to 50, 16 up to 64: a
// template parameter, so S = 49 holds no unused ones; a larger patch reads
// them back from its output), and the window's buffer is reused by the
// resize.  A warp counts its samples into its own histogram, summed once
// (faster on the card than one add per distinct bin of a warp with
// __match_any_sync).  One warp scans the 256 bins (8 a lane, shuffle scans
// of the exact integer sums) and reduces the Otsu arg-max, lowest bin on
// ties.  The resize sums each output's run of nonzero taps only, in
// ascending order, so the float32 sums are those of the plain version term
// for term; a warp takes one output row or column, a lane holds one tap's
// weight (32 taps at a time) and the sum takes each by a shuffle.  The tap
// table is a device buffer the wrapper builds once per (S, m, device); the
// level pointers and dimensions go by value, so the wrapper copies nothing
// to the device per call.  The levels' struct is __grid_constant__: a
// by-value struct indexed at run time is otherwise copied to local memory
// by every thread of every block (120 bytes a thread, ~126 MB a 1080p
// batch of 4,096 lanes, which cost more than the rest of the kernel).
// Built with -fmad=false so the bilinear blend and the Otsu score round as
// the reference's separate products do; the homography rows keep the one
// fused step (fmaf) that the reference's float32 dot takes on the CPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Pyramid levels above 0 a launch takes: more than a frame of int32
// dimensions can have (rectify.num_levels gives at most 26 above 0).
#define A3_MAX_UPPERS 32

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WIN = 64;
constexpr int PAD = 2;  // zero cells around the staged window
constexpr int PW = WIN + 2 * PAD;
constexpr unsigned FULL = 0xffffffffu;

struct Uppers {
  const float* ptr[A3_MAX_UPPERS];  // level l + 1, (B, h[l], w[l]) float32
  int h[A3_MAX_UPPERS];
  int w[A3_MAX_UPPERS];
  int n;
};

// Dynamic shared memory of a block: the staged window, then the row pass
// (m*S floats) and the binarized samples (S*S bytes) over it.
size_t smem_bytes(int S, int m) {
  const size_t resize = static_cast<size_t>(m) * S * 4 + static_cast<size_t>(S) * S;
  const size_t win = static_cast<size_t>(PW) * PW * 4;
  return ((resize > win ? resize : win) + 15) & ~size_t(15);
}

// The lane's 64x64 window of its level, zero outside the level's plane,
// inside a zero border of PAD cells (a PW x PW buffer).
template <typename T>
__device__ __forceinline__ void stage_window(const T* __restrict__ plane, int ph, int pw, int ox,
                                             int oy, float* __restrict__ win) {
  constexpr int PER = WIN * WIN / THREADS;
  float v[PER];
  const int col = threadIdx.x % WIN;
  const int row0 = threadIdx.x / WIN;
  const int x = ox + col;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int y = oy + row0 + j * (THREADS / WIN);
    v[j] = (x >= 0 && x < pw && y >= 0 && y < ph)
               ? static_cast<float>(plane[static_cast<size_t>(y) * pw + x])
               : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) win[(row0 + j * (THREADS / WIN) + PAD) * PW + col + PAD] = v[j];
  // The zero border: its rows above and below whole, then its columns
  // left and right of the window's rows.
  for (int e = threadIdx.x; e < 2 * PAD * (PW + WIN); e += THREADS) {
    const bool band = e < 2 * PAD * PW;
    const int i = band ? e : e - 2 * PAD * PW;
    int r = band ? i / PW : PAD + i / (2 * PAD);
    int c = band ? i % PW : i % (2 * PAD);
    if (band && r >= PAD) r += WIN;
    if (!band && c >= PAD) c += WIN;
    win[r * PW + c] = 0.0f;
  }
}

// Sample (x, y) of the patch: the homography, then the bilinear taps of
// the staged window.
__device__ __forceinline__ float warp_sample(const float (&hh)[9], int L, float inv_scale,
                                             float oxf, float oyf, const float* __restrict__ win,
                                             int xi, int yi) {
  const float x = static_cast<float>(xi);
  const float y = static_cast<float>(yi);
  // One explicit fused step per row, as the reference's float32 dot.
  const float sxh = fmaf(hh[1], y, hh[0] * x) + hh[2];
  const float syh = fmaf(hh[4], y, hh[3] * x) + hh[5];
  const float wd = fmaf(hh[7], y, hh[6] * x) + hh[8];
  const bool bad = fabsf(wd) < 1e-12f;
  const float ws = bad ? 1.0f : wd;
  const float sx = sxh / ws;
  const float sy = syh / ws;
  // Level 0 samples at the image coordinates themselves (no ulp lost).
  const float ux = (L == 0 ? sx : (sx + 0.5f) * inv_scale - 0.5f) - oxf;
  const float uy = (L == 0 ? sy : (sy + 0.5f) * inv_scale - 0.5f) - oyf;
  const float x0 = floorf(ux), x1 = x0 + 1.0f;
  const float y0 = floorf(uy), y1 = y0 + 1.0f;
  const float wx0 = __bfloat162float(__float2bfloat16_rn(fmaxf(1.0f - fabsf(ux - x0), 0.0f)));
  const float wx1 = __bfloat162float(__float2bfloat16_rn(fmaxf(1.0f - fabsf(ux - x1), 0.0f)));
  const float wy0 = fmaxf(1.0f - fabsf(uy - y0), 0.0f);
  const float wy1 = fmaxf(1.0f - fabsf(uy - y1), 0.0f);
  // A tap outside the window reads the zero border: a cell clamped to
  // [-2, 64] keeps both taps of a pair outside when the first is.  (A NaN
  // coordinate converts to 0, but its weights are 0: the sample is 0 as
  // with the plain version's zero taps.)
  const int cx = min(max(__float2int_rz(x0), -PAD), WIN);
  const int cy = min(max(__float2int_rz(y0), -PAD), WIN);
  const int at = (cy + PAD) * PW + cx + PAD;
  const float v00 = win[at];
  const float v01 = win[at + 1];
  const float v10 = win[at + PW];
  const float v11 = win[at + PW + 1];
  const float top = wx0 * v00 + wx1 * v01;
  const float bot = wx0 * v10 + wx1 * v11;
  return bad ? 0.0f : wy0 * top + wy1 * bot;
}

// The sum over output o's run of taps of src[j * stride] * weight j, in
// ascending order (first term alone, then acc + term), as the plain
// version does; every lane of the warp takes part (32 weights at a time,
// a lane holding one, shuffled to all).
template <typename Src>
__device__ __forceinline__ float tap_sum(const int* __restrict__ taps, int m, int T, int o,
                                         int lane, Src src) {
  const int cnt = __ldg(taps + m + o);
  const float* w = reinterpret_cast<const float*>(taps + 2 * m) + o * T;
  float acc = 0.0f;
  for (int j0 = 0; j0 < cnt; j0 += 32) {
    const float wl = j0 + lane < cnt ? __ldg(w + j0 + lane) : 0.0f;
    const int n = min(32, cnt - j0);
    for (int j = 0; j < n; ++j) {
      const float term = src(j0 + j) * __shfl_sync(FULL, wl, j);
      acc = j0 + j == 0 ? term : acc + term;
    }
  }
  return acc;
}

// SPT samples a thread held in registers (ceil(S * S / THREADS)); 0 for a
// larger patch, whose samples are read back from the output.
template <int SPT>
__global__ void __launch_bounds__(THREADS)
warp_decode_kernel(const uint8_t* __restrict__ grey, const __grid_constant__ Uppers up,
                   const float* __restrict__ Hm,
                   const int* __restrict__ lvl, const int* __restrict__ tlx,
                   const int* __restrict__ tly, const uint8_t* __restrict__ valid,
                   const int* __restrict__ taps, float* __restrict__ samples,
                   int* __restrict__ levels,
                   uint8_t* __restrict__ grids, int K, int H, int W, int S, int m, int T) {
  // The window; after the taps, the row pass t1 (m*S) and the binarized
  // samples (S*S bytes).
  extern __shared__ __align__(16) float win[];
  float* t1 = win;
  uint8_t* bits = reinterpret_cast<uint8_t*>(t1 + m * S);
  __shared__ int whist[WARPS][256];  // a histogram a warp, then their sum
  __shared__ __align__(16) int hist[256];
  __shared__ int s_level;

  const int n = blockIdx.x;
  const int S2 = S * S;
  float* out_s = samples + static_cast<size_t>(n) * S2;
  uint8_t* out_g = grids + static_cast<size_t>(n) * m * m;
  if (!valid[n]) {
    for (int i = threadIdx.x; i < S2; i += THREADS) out_s[i] = 0.0f;
    for (int i = threadIdx.x; i < m * m; i += THREADS) out_g[i] = 0;
    if (threadIdx.x == 0) levels[n] = 0;
    return;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = n / K;
  const int L = lvl[n];
  const int ox = tlx[n];
  const int oy = tly[n];
  if (L == 0) {
    stage_window(grey + static_cast<size_t>(b) * H * W, H, W, ox, oy, win);
  } else {
    const bool have = L >= 1 && L <= up.n;  // else the plain version's zeros
    const int ph = have ? up.h[L - 1] : 0, pw = have ? up.w[L - 1] : 0;
    const float* plane = have ? up.ptr[L - 1] + static_cast<size_t>(b) * ph * pw : nullptr;
    stage_window(plane, ph, pw, ox, oy, win);
  }
  for (int i = threadIdx.x; i < WARPS * 256; i += THREADS) (&whist[0][0])[i] = 0;
  const float* h = Hm + static_cast<size_t>(n) * 9;
  float hh[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) hh[i] = h[i];
  // x / 2^L and x * 2^-L round alike: the same real value.
  const float inv_scale = 1.0f / static_cast<float>(1 << (L > 0 ? L : 0));
  const float oxf = static_cast<float>(ox);
  const float oyf = static_cast<float>(oy);
  __syncthreads();

  // Sample i = threadIdx.x + j * THREADS = y * S + x; (x, y) stepped
  // without a division.
  const int iters = SPT > 0 ? SPT : (S2 + THREADS - 1) / THREADS;
  float v[SPT > 0 ? SPT : 1];
  int xi = threadIdx.x % S, yi = threadIdx.x / S;
  const int step_x = THREADS % S, step_y = THREADS / S;
#pragma unroll
  for (int j = 0; j < iters; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (i < S2) {
      const float val = warp_sample(hh, L, inv_scale, oxf, oyf, win, xi, yi);
      out_s[i] = val;
      if constexpr (SPT > 0) {
        v[j] = val;
      } else {
        atomicAdd(&whist[warp][static_cast<int>(fminf(fmaxf(rintf(val), 0.0f), 255.0f))], 1);
      }
    }
    xi += step_x;
    yi += step_y;
    if (xi >= S) {
      xi -= S;
      ++yi;
    }
  }
  // Histogram of the rounded samples: a warp adds into its own copy, and
  // the copies are summed once.
  if constexpr (SPT > 0) {
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      if (threadIdx.x + j * THREADS < S2)
        atomicAdd(&whist[warp][static_cast<int>(fminf(fmaxf(rintf(v[j]), 0.0f), 255.0f))], 1);
    }
  }
  __syncthreads();
  {
    int c = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) c += whist[w][threadIdx.x];
    hist[threadIdx.x] = c;  // THREADS == 256
  }
  __syncthreads();

  // Otsu: one warp, 8 bins a lane.  The class counts W and value sums M
  // are exact integers (inclusive shuffle scans); the score
  // (MT*W - M*n)^2 / (W*(n - W)) is float32 from them; the first maximum
  // wins.
  if (warp == 0) {
    const int4 ha = reinterpret_cast<const int4*>(hist)[2 * lane];
    const int4 hb = reinterpret_cast<const int4*>(hist)[2 * lane + 1];
    const int hv[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
    int cw[8], cm[8];
    int c = 0, mm = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      c += hv[k];
      mm += hv[k] * (8 * lane + k);
      cw[k] = c;
      cm[k] = mm;
    }
    int sc = c, sm_ = mm;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int oc = __shfl_up_sync(FULL, sc, off);
      const int om = __shfl_up_sync(FULL, sm_, off);
      if (lane >= off) {
        sc += oc;
        sm_ += om;
      }
    }
    const int ec = sc - c, em = sm_ - mm;
    const float nf = static_cast<float>(S2);
    const float mt = static_cast<float>(__shfl_sync(FULL, sm_, 31));
    float bs = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float wf = static_cast<float>(cw[k] + ec);
      const float mf = static_cast<float>(cm[k] + em);
      const float den = wf * (nf - wf);
      const float num = mt * wf - mf * nf;
      const float sig = den > 0.0f ? (num * num) / den : -1.0f;
      if (sig > bs) {
        bs = sig;
        bi = 8 * lane + k;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(FULL, bs, off);
      const int oi = __shfl_down_sync(FULL, bi, off);
      if (os > bs || (os == bs && oi < bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      s_level = bi;
      levels[n] = bi;
    }
  }
  __syncthreads();
  const float lv = static_cast<float>(s_level);
#pragma unroll
  for (int j = 0; j < iters; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (i < S2) {
      float val;
      if constexpr (SPT > 0) {
        val = v[j];
      } else {
        val = out_s[i];  // this thread's own store
      }
      bits[i] = val > lv ? 1 : 0;
    }
  }
  __syncthreads();
  // Triangle resize, rows then columns.  A warp takes one output row
  // (column) at a time, its lanes the columns (rows) of that output.
  for (int o = warp; o < m; o += WARPS) {
    const int st = __ldg(taps + o);
    for (int x0 = 0; x0 < S; x0 += 32) {
      const int x = min(x0 + lane, S - 1);
      const uint8_t* col = bits + st * S + x;
      const float acc =
          tap_sum(taps, m, T, o, lane, [&](int j) { return col[j * S] ? 255.0f : 0.0f; });
      if (x0 + lane < S) t1[o * S + x] = acc;
    }
  }
  __syncthreads();
  for (int p = warp; p < m; p += WARPS) {
    const int st = __ldg(taps + p);
    for (int o0 = 0; o0 < m; o0 += 32) {
      const int o = min(o0 + lane, m - 1);
      const float* row = t1 + o * S + st;
      const float acc = tap_sum(taps, m, T, p, lane, [&](int j) { return row[j]; });
      if (o0 + lane < m) out_g[o * m + p] = acc > 127.0f ? 1 : 0;
    }
  }
}

template <int SPT>
cudaError_t launch(int N, size_t smem, cudaStream_t stream, const uint8_t* grey,
                   const Uppers& up, const float* Hm, const int* lvl, const int* tlx,
                   const int* tly, const uint8_t* valid, const int* taps, float* samples,
                   int* levels, uint8_t* grids, int K, int H, int W, int S, int m, int T) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        warp_decode_kernel<SPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return cudaErrorInvalidValue;  // a patch too large for an SM
  }
  warp_decode_kernel<SPT><<<N, THREADS, smem, stream>>>(grey, up, Hm, lvl, tlx, tly, valid,
                                                        taps, samples, levels, grids, K, H, W,
                                                        S, m, T);
  return cudaGetLastError();
}

}  // namespace

// grey (B,H,W) u8 is level 0; levels 1..n_uppers are float32 (B,ph,pw)
// planes whose device pointers and (ph, pw) pairs come in host arrays
// (level_ptrs, level_dims).  taps is the resize table on the device, int32
// words: start (m), count (m), then m rows of T float32 weights (row o's
// run of taps at columns start[o] .. start[o] + count[o] - 1, count[o] <=
// T).  Per lane n = b*K + k: H (N,3,3), lvl, tlx, tly (N,) int32, valid
// (N,) -> samples (N,S*S) f32, levels (N,) int32, grids (N,m*m) 0/1 bytes.
// Returns cudaErrorInvalidValue for more than A3_MAX_UPPERS levels or a
// patch whose resize buffers do not fit an SM's shared memory.
extern "C" int a3_warp_decode(const uint8_t* grey, const long long* level_ptrs,
                              const int* level_dims, int n_uppers, const float* Hm, const int* lvl,
                              const int* tlx, const int* tly, const uint8_t* valid,
                              const int* taps, float* samples, int* levels, uint8_t* grids, int N,
                              int K, int H, int W, int S, int m, int T, cudaStream_t stream) {
  if (n_uppers < 0 || n_uppers > A3_MAX_UPPERS || m < 1 || S < 1 || T < 1)
    return cudaErrorInvalidValue;
  Uppers up = {};
  up.n = n_uppers;
  for (int l = 0; l < n_uppers; ++l) {
    up.ptr[l] = reinterpret_cast<const float*>(level_ptrs[l]);
    up.h[l] = level_dims[2 * l];
    up.w[l] = level_dims[2 * l + 1];
  }
  if (N == 0) return cudaSuccess;
  const size_t smem = smem_bytes(S, m);
#define A3_WARP_DECODE_ARGS                                                                    \
  N, smem, stream, grey, up, Hm, lvl, tlx, tly, valid, taps, samples, levels, grids, K, H, W, \
      S, m, T
  if (S * S <= 10 * THREADS) return launch<10>(A3_WARP_DECODE_ARGS);  // up to S = 50
  if (S * S <= 16 * THREADS) return launch<16>(A3_WARP_DECODE_ARGS);  // up to S = 64
  return launch<0>(A3_WARP_DECODE_ARGS);
#undef A3_WARP_DECODE_ARGS
}
