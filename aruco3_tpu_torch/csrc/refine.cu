// Kernel 3: full-resolution corner refinement.
//
// Replaces the TPU kernel aruco3_tpu/ops/refine_pallas.py refine_eval
// (pallas_call at :391), entered through refine_corners_batch (:414).  Its
// specification is segment.refine_corners: for each corner of a valid
// lane, in the wn x wn window at clip(round(q) - wn/2, 0, max(dim - wn, 0))
// (round half to even), a pixel is ink when its grey value is below the
// window mean (the exact integer sum divided by wn^2 in float32) and the
// near mask is set (on inner lanes also the upsampled inner footprint);
// among ink pixels within ds + 2 of the coarse corner the one maximising
// x * dir0 + y * dir1 wins, the first in row-major order on ties; a window
// without such a pixel keeps the coarse corner.
//
// What bounds it on an H100: latency and bytes of scattered windows, not
// arithmetic.  A 1080p batch of 128 frames has at most 16384 windows of
// 28 x 28 = 784 pixels, about 13 MB of reads in total.  Design: one warp per
// corner window, four warps (one lane's corners) per block, invalid lanes
// skipped; each warp reads its window twice (sum, then score) through L1,
// and reduces with shuffles.  Built with -fmad=false so the score rounds
// as the reference's separate multiply and add do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void amax_update(float s, int i, float& bs, int& bi) {
  if (s > bs || (s == bs && i < bi)) { bs = s; bi = i; }
}

__global__ void __launch_bounds__(128)
refine_kernel(const uint8_t* __restrict__ grey, const uint8_t* __restrict__ near,
              const float* __restrict__ quads, const float* __restrict__ dirs,
              const uint8_t* __restrict__ inner_coarse,
              const uint8_t* __restrict__ is_inner, const uint8_t* __restrict__ valid,
              float* __restrict__ out, int K, int H, int W, int hc, int wc, int ds,
              int wn) {
  const int lane_id = blockIdx.x;  // b * K + k
  const int b = lane_id / K;
  const int c = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int q = lane_id * 4 + c;
  const float qx = quads[q * 2];
  const float qy = quads[q * 2 + 1];
  if (!valid[lane_id]) {
    if (t == 0) {
      out[q * 2] = qx;
      out[q * 2 + 1] = qy;
    }
    return;
  }
  const float d0 = dirs[q * 2];
  const float d1 = dirs[q * 2 + 1];
  const int tlx = min(max(static_cast<int>(rintf(qx)) - wn / 2, 0), max(W - wn, 0));
  const int tly = min(max(static_cast<int>(rintf(qy)) - wn / 2, 0), max(H - wn, 0));
  const size_t plane = static_cast<size_t>(H) * W;
  const uint8_t* g = grey + b * plane;
  const uint8_t* nm = near + b * plane;
  const uint8_t* ic = inner_coarse + static_cast<size_t>(b) * hc * wc;
  const bool inner = is_inner[lane_id] != 0;
  const int n = wn * wn;

  int sum = 0;
  for (int i = t; i < n; i += 32) {
    const int y = tly + i / wn;
    const int x = tlx + i % wn;
    if (y < H && x < W) sum += g[static_cast<size_t>(y) * W + x];
  }
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float mean = static_cast<float>(sum) / static_cast<float>(n);
  const float clamp_r = static_cast<float>(ds + 2);

  float bs = -INFINITY;
  int bi = 0x7fffffff;
  for (int i = t; i < n; i += 32) {
    const int y = tly + i / wn;
    const int x = tlx + i % wn;
    if (y >= H || x >= W) continue;
    const size_t o = static_cast<size_t>(y) * W + x;
    bool ink = static_cast<float>(g[o]) < mean && nm[o] != 0;
    if (inner) ink = ink && ic[(y / ds) * wc + x / ds] != 0;
    const float xf = static_cast<float>(x);
    const float yf = static_cast<float>(y);
    if (!ink || fabsf(xf - qx) > clamp_r || fabsf(yf - qy) > clamp_r) continue;
    amax_update(xf * d0 + yf * d1, i, bs, bi);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, bs, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    amax_update(os, oi, bs, bi);
  }
  if (t == 0) {
    const bool has = bi != 0x7fffffff;
    out[q * 2] = has ? static_cast<float>(tlx + bi % wn) : qx;
    out[q * 2 + 1] = has ? static_cast<float>(tly + bi / wn) : qy;
  }
}

}  // namespace

// grey/near (B,H,W) bytes, quads/dirs (B,K,4,2) f32, inner_coarse
// (B,hc,wc), is_inner/valid (B,K) -> out (B,K,4,2) f32.
extern "C" int a3_refine(const uint8_t* grey, const uint8_t* near, const float* quads,
                         const float* dirs, const uint8_t* inner_coarse,
                         const uint8_t* is_inner, const uint8_t* valid, float* out,
                         int B, int K, int H, int W, int hc, int wc, int ds, int wn,
                         cudaStream_t stream) {
  if (B * K == 0) return cudaSuccess;
  refine_kernel<<<B * K, 128, 0, stream>>>(grey, near, quads, dirs, inner_coarse, is_inner,
                                            valid, out, K, H, W, hc, wc, ds, wn);
  return cudaGetLastError();
}
