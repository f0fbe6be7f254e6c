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
// rows then columns, and `> 127`.  The weights are float32 here; the XLA
// warp rounds them to bfloat16 (a stated deviation of the port).
//
// What bounds it on an H100: latency of the scattered taps.  Per lane it
// reads 4 * S^2 = 9604 taps from one 64-px window of one level and does a
// few arithmetic operations per tap; the Otsu and the resize are tiny.
// Design: one block per valid (frame, lane), taps read straight from the
// level planes (level 0 is the frame itself, level 1 the frontend's plane,
// levels >= 2 the torch pyramid), samples and the histogram kept in shared
// memory, so only the samples, the level and the cell grid are written.
// Built with -fmad=false so the bilinear blend and the Otsu score round as
// the reference's separate products do; the homography rows keep the one
// fused step (fmaf) that the reference's float32 dot takes on the CPU.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WIN = 64;

__device__ __forceinline__ float tap(const uint8_t* g8, const float* gf, int ph, int pw,
                                     float yy, float xx, float oy, float ox, bool iny,
                                     bool inx) {
  const float r = yy + oy;
  const float c = xx + ox;
  if (!(iny && inx && r >= 0.0f && r < static_cast<float>(ph) && c >= 0.0f &&
        c < static_cast<float>(pw)))
    return 0.0f;
  const size_t o = static_cast<size_t>(r) * pw + static_cast<size_t>(c);
  return g8 ? static_cast<float>(g8[o]) : gf[o];
}

__global__ void __launch_bounds__(THREADS)
warp_decode_kernel(const uint8_t* __restrict__ grey, const long long* __restrict__ level_ptrs,
                   const int* __restrict__ level_dims, const float* __restrict__ Hm,
                   const int* __restrict__ lvl, const int* __restrict__ tlx,
                   const int* __restrict__ tly, const uint8_t* __restrict__ valid,
                   const float* __restrict__ lmat, float* __restrict__ samples,
                   int* __restrict__ levels, uint8_t* __restrict__ grids, int K, int H,
                   int W, int S, int m) {
  extern __shared__ float sm[];
  const int S2 = S * S;
  float* samp = sm;                                      // S*S
  float* t1 = samp + S2;                                 // m*S
  int* hist = reinterpret_cast<int*>(t1 + m * S);        // 256
  int* cw = hist + 256;                                  // 256
  int* cm = cw + 256;                                    // 256
  float* sig = reinterpret_cast<float*>(cm + 256);       // 256
  __shared__ int s_level;

  const int n = blockIdx.x;
  const int b = n / K;
  float* out_s = samples + static_cast<size_t>(n) * S2;
  uint8_t* out_g = grids + static_cast<size_t>(n) * m * m;
  if (!valid[n]) {
    for (int i = threadIdx.x; i < S2; i += blockDim.x) out_s[i] = 0.0f;
    for (int i = threadIdx.x; i < m * m; i += blockDim.x) out_g[i] = 0;
    if (threadIdx.x == 0) levels[n] = 0;
    return;
  }

  const float* h = Hm + static_cast<size_t>(n) * 9;
  const int L = lvl[n];
  const float ox = static_cast<float>(tlx[n]);
  const float oy = static_cast<float>(tly[n]);
  const float scale = static_cast<float>(1 << L);
  const uint8_t* g8 = nullptr;
  const float* gf = nullptr;
  int ph, pw;
  if (L == 0) {
    g8 = grey + static_cast<size_t>(b) * H * W;
    ph = H;
    pw = W;
  } else {
    ph = level_dims[(L - 1) * 2];
    pw = level_dims[(L - 1) * 2 + 1];
    gf = reinterpret_cast<const float*>(level_ptrs[L - 1]) + static_cast<size_t>(b) * ph * pw;
  }

  for (int i = threadIdx.x; i < S2; i += blockDim.x) {
    const float x = static_cast<float>(i % S);
    const float y = static_cast<float>(i / S);
    // One explicit fused step per row, as the reference's float32 dot.
    const float sxh = fmaf(h[1], y, h[0] * x) + h[2];
    const float syh = fmaf(h[4], y, h[3] * x) + h[5];
    const float wd = fmaf(h[7], y, h[6] * x) + h[8];
    const bool bad = fabsf(wd) < 1e-12f;
    const float ws = bad ? 1.0f : wd;
    const float sx = sxh / ws;
    const float sy = syh / ws;
    // Level 0 samples at the image coordinates themselves (no ulp lost).
    const float ux = (L == 0 ? sx : (sx + 0.5f) / scale - 0.5f) - ox;
    const float uy = (L == 0 ? sy : (sy + 0.5f) / scale - 0.5f) - oy;
    const float x0 = floorf(ux), x1 = x0 + 1.0f;
    const float y0 = floorf(uy), y1 = y0 + 1.0f;
    const float wx0 = fmaxf(1.0f - fabsf(ux - x0), 0.0f);
    const float wx1 = fmaxf(1.0f - fabsf(ux - x1), 0.0f);
    const float wy0 = fmaxf(1.0f - fabsf(uy - y0), 0.0f);
    const float wy1 = fmaxf(1.0f - fabsf(uy - y1), 0.0f);
    const bool inx0 = x0 >= 0.0f && x0 < WIN, inx1 = x1 >= 0.0f && x1 < WIN;
    const bool iny0 = y0 >= 0.0f && y0 < WIN, iny1 = y1 >= 0.0f && y1 < WIN;
    const float v00 = tap(g8, gf, ph, pw, y0, x0, oy, ox, iny0, inx0);
    const float v01 = tap(g8, gf, ph, pw, y0, x1, oy, ox, iny0, inx1);
    const float v10 = tap(g8, gf, ph, pw, y1, x0, oy, ox, iny1, inx0);
    const float v11 = tap(g8, gf, ph, pw, y1, x1, oy, ox, iny1, inx1);
    const float top = wx0 * v00 + wx1 * v01;
    const float bot = wx0 * v10 + wx1 * v11;
    const float v = bad ? 0.0f : wy0 * top + wy1 * bot;
    samp[i] = v;
    out_s[i] = v;
  }
  for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < S2; i += blockDim.x) {
    const float v = fminf(fmaxf(rintf(samp[i]), 0.0f), 255.0f);
    atomicAdd(&hist[static_cast<int>(v)], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int w = 0, mm = 0;
    for (int t = 0; t < 256; ++t) {
      w += hist[t];
      mm += hist[t] * t;
      cw[t] = w;
      cm[t] = mm;
    }
  }
  __syncthreads();
  // Otsu score (MT*W - M*n)^2 / (W*(n - W)) in float32 from exact sums.
  const float nf = static_cast<float>(S2);
  const float mt = static_cast<float>(cm[255]);
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    const float wf = static_cast<float>(cw[t]);
    const float mf = static_cast<float>(cm[t]);
    const float den = wf * (nf - wf);
    const float num = mt * wf - mf * nf;
    sig[t] = den > 0.0f ? (num * num) / den : -1.0f;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    float bs = -INFINITY;
    int bi = 0x7fffffff;
    for (int t = threadIdx.x; t < 256; t += 32) {
      if (sig[t] > bs) { bs = sig[t]; bi = t; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, bs, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (os > bs || (os == bs && oi < bi)) { bs = os; bi = oi; }
    }
    if (threadIdx.x == 0) {
      s_level = bi;
      levels[n] = bi;
    }
  }
  __syncthreads();
  const float lv = static_cast<float>(s_level);
  for (int i = threadIdx.x; i < S2; i += blockDim.x) samp[i] = samp[i] > lv ? 255.0f : 0.0f;
  __syncthreads();
  // Triangle resize: rows, then columns, each summing the nonzero taps in
  // ascending order.
  for (int i = threadIdx.x; i < m * S; i += blockDim.x) {
    const int o = i / S;
    const int x = i % S;
    float acc = 0.0f;
    bool first = true;
    for (int y = 0; y < S; ++y) {
      const float wgt = lmat[o * S + y];
      if (wgt == 0.0f) continue;
      const float term = samp[y * S + x] * wgt;
      acc = first ? term : acc + term;
      first = false;
    }
    t1[i] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m * m; i += blockDim.x) {
    const int o = i / m;
    const int p = i % m;
    float acc = 0.0f;
    bool first = true;
    for (int x = 0; x < S; ++x) {
      const float wgt = lmat[p * S + x];
      if (wgt == 0.0f) continue;
      const float term = t1[o * S + x] * wgt;
      acc = first ? term : acc + term;
      first = false;
    }
    out_g[i] = acc > 127.0f ? 1 : 0;
  }
}

}  // namespace

// grey (B,H,W) u8 is level 0; level_ptrs/level_dims describe the float32
// levels 1..L-1, each (B,ph,pw).  Per lane n = b*K + k: H (N,3,3), lvl,
// tlx, tly (N,) int32, valid (N,), lmat (m,S) -> samples (N,S*S) f32,
// levels (N,) int32, grids (N,m*m) 0/1 bytes.
extern "C" int a3_warp_decode(const uint8_t* grey, const long long* level_ptrs,
                              const int* level_dims, const float* Hm, const int* lvl,
                              const int* tlx, const int* tly, const uint8_t* valid,
                              const float* lmat, float* samples, int* levels,
                              uint8_t* grids, int N, int K, int H, int W, int S, int m,
                              cudaStream_t stream) {
  if (N == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (S * S + m * S) + sizeof(int) * 256 * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        warp_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  warp_decode_kernel<<<N, THREADS, smem, stream>>>(grey, level_ptrs, level_dims, Hm, lvl, tlx,
                                                   tly, valid, lmat, samples, levels, grids, K,
                                                   H, W, S, m);
  return cudaGetLastError();
}
