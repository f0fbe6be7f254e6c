// Kernel 1: adaptive threshold, 5x5 opening, pooling, near mask, level 1.
//
// Replaces the TPU kernel aruco3_tpu/ops/frontend_pallas.py
// fused_threshold_open_pool (pallas_call at :1222).  Its specification is
// the XLA path it reproduces: frontend.adaptive_threshold (clamped box of
// radius r, white iff g*area >= sum), segment.open_mask (r_open erosions
// padding True, then r_open dilations padding False), segment.pool_black
// (count*2 >= max(ds, 2), padding False), the near mask
// _dilate3(_dilate3(opened)) of segment.refine_corners, and pyramid level 1
// of rectify.build_pyramid (2x2 means of the zero-padded frame, exact in
// float32).
//
// What bounds it on an H100: device-memory bytes set its floor (the frame
// read once, opened/near/level 1 written once: about 7 MB per 1080p frame,
// 2 microseconds at 3.35 TB/s); inside a block the work is shared-memory
// traffic.  Design: one block per 32x32 output tile stages the tile plus a
// halo of r + 2*r_open + 2 grey pixels in shared memory; box sums slide
// down columns, then along rows (about 10 shared loads per pixel), and the
// thresholded mask is packed into one 64-bit word per row, so each
// erosion or dilation is a few shifts and ANDs/ORs per row for one warp.
// No intermediate mask reaches device memory except the opened mask that
// the pooling launch reads.  Pooling and level 1 are two small launches
// of their own.  Out-of-image cells take each stage's padding value, as
// the XLA code pads each stage.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;
using u64 = unsigned long long;

__device__ __forceinline__ bool in_image(int y, int x, int H, int W) {
  return y >= 0 && y < H && x >= 0 && x < W;
}

// A mask row as one 64-bit word: bit j is column x0 - eb + j.  Cells
// outside the image take the padding value of the op about to read them:
// true before an erosion, false before a dilation.
__device__ __forceinline__ u64 padded(u64 w, bool row_in, u64 colmask, bool erode) {
  if (!row_in) return erode ? ~0ull : 0ull;
  return erode ? (w | ~colmask) : (w & colmask);
}

__global__ void __launch_bounds__(THREADS)
threshold_open_near_kernel(const uint8_t* __restrict__ grey,
                           uint8_t* __restrict__ opened,
                           uint8_t* __restrict__ near, int H, int W, int r,
                           int r_open) {
  extern __shared__ int smem[];
  const int eb = 2 * r_open + 2;  // black mask extent the chain needs
  const int eg = r + eb;          // grey extent
  const int ng = TILE + 2 * eg;   // grey buffer side
  const int nb = TILE + 2 * eb;   // black buffer side, <= 64 bits
  int* sg = smem;                 // ng x ng grey, 0 outside the image
  int* cs = sg + ng * ng;         // nb x ng column sums of 2r+1 grey rows
  u64* cur = reinterpret_cast<u64*>(cs + nb * ng);  // nb mask rows
  u64* tmp = cur + nb;
  u64* keep = tmp + nb;           // the opened mask rows

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const size_t plane = static_cast<size_t>(H) * W;
  const uint8_t* g = grey + b * plane;

  for (int row = tid >> 6; row < ng; row += THREADS >> 6) {
    const int y = y0 - eg + row;
    for (int col = tid & 63; col < ng; col += 64) {
      const int x = x0 - eg + col;
      sg[row * ng + col] = in_image(y, x, H, W) ? g[static_cast<size_t>(y) * W + x] : 0;
    }
  }
  if (tid < nb) cur[tid] = 0;
  __syncthreads();

  // Column sums, sliding down four row chunks per column.  Buffer row i
  // covers grey rows i .. i + 2r (centre: grey row i + r).
  {
    const int rows = (nb + 3) / 4;
    const int r0 = (tid >> 6) * rows;
    const int r1 = min(nb, r0 + rows);
    for (int col = tid & 63; col < ng && r0 < r1; col += 64) {
      int s = 0;
      for (int d = 0; d <= 2 * r; ++d) s += sg[(r0 + d) * ng + col];
      cs[r0 * ng + col] = s;
      for (int i = r0 + 1; i < r1; ++i) {
        s += sg[(i + 2 * r) * ng + col] - sg[(i - 1) * ng + col];
        cs[i * ng + col] = s;
      }
    }
  }
  __syncthreads();

  // Row sums of the column sums give the clamped box sums (zeros outside
  // the image); black = not (g * area >= sum), packed into row words.
  if (tid < 4 * nb) {
    const int row = tid >> 2;
    const int cols = (nb + 3) / 4;
    const int c0 = (tid & 3) * cols;
    const int c1 = min(nb, c0 + cols);
    const int y = y0 - eb + row;
    const int* cr = cs + row * ng;
    u64 bits = 0;
    if (c0 < c1) {
      int s = 0;
      for (int d = 0; d <= 2 * r; ++d) s += cr[c0 + d];
      for (int c = c0; c < c1; ++c) {
        if (c > c0) s += cr[c + 2 * r] - cr[c - 1];
        const int x = x0 - eb + c;
        if (in_image(y, x, H, W)) {
          const int ah = min(y + r, H - 1) - max(y - r, 0) + 1;
          const int aw = min(x + r, W - 1) - max(x - r, 0) + 1;
          const int gv = sg[(row + r) * ng + c + r];
          if (!(gv * ah * aw >= s)) bits |= 1ull << c;
        }
      }
      atomicOr(&cur[row], bits);
    }
  }
  __syncthreads();

  // r_open erosions, r_open dilations (the opened mask), two more
  // dilations (the near mask): one warp, shifts and ANDs/ORs of row words.
  if (tid < 32) {
    const int lo = max(0, eb - x0);
    const int hi = min(nb, W - x0 + eb);
    const u64 colmask = ((hi >= 64) ? ~0ull : ((1ull << hi) - 1)) & ~((1ull << lo) - 1);
    if (r_open == 0)
      for (int i = tid; i < nb; i += 32) keep[i] = cur[i];
    for (int k = 0; k < 2 * r_open + 2; ++k) {
      const bool erode = k < r_open;
      for (int i = tid; i < nb; i += 32) {
        const int y = y0 - eb + i;
        const u64 x = padded(cur[i], y >= 0 && y < H, colmask, erode);
        tmp[i] = erode ? (x & (x << 1) & (x >> 1)) : (x | (x << 1) | (x >> 1));
      }
      __syncwarp();
      const u64 edge = erode ? ~0ull : 0ull;  // beyond the buffer: unused
      for (int i = tid; i < nb; i += 32) {
        const u64 up = i > 0 ? tmp[i - 1] : edge;
        const u64 dn = i < nb - 1 ? tmp[i + 1] : edge;
        cur[i] = erode ? (up & tmp[i] & dn) : (up | tmp[i] | dn);
        if (k == 2 * r_open - 1) keep[i] = cur[i];
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int i = tid; i < TILE * TILE; i += THREADS) {
    const int y = y0 + (i >> 5);
    const int x = x0 + (i & 31);
    if (!in_image(y, x, H, W)) continue;
    const int bit = eb + (i & 31);
    const size_t o = b * plane + static_cast<size_t>(y) * W + x;
    opened[o] = (keep[eb + (i >> 5)] >> bit) & 1;
    near[o] = (cur[eb + (i >> 5)] >> bit) & 1;
  }
}

__global__ void pool_kernel(const uint8_t* __restrict__ opened,
                            uint8_t* __restrict__ coarse, int B, int H, int W,
                            int ds, int hc, int wc) {
  const int64_t n = static_cast<int64_t>(B) * hc * wc;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int b = static_cast<int>(i / (hc * wc));
    const int cy = static_cast<int>((i / wc) % hc);
    const int cx = static_cast<int>(i % wc);
    const uint8_t* o = opened + static_cast<size_t>(b) * H * W;
    int count = 0;
    for (int dy = 0; dy < ds; ++dy) {
      const int y = cy * ds + dy;
      if (y >= H) break;
      for (int dx = 0; dx < ds; ++dx) {
        const int x = cx * ds + dx;
        if (x >= W) break;
        count += o[static_cast<size_t>(y) * W + x];
      }
    }
    coarse[i] = (count * 2 >= max(ds, 2)) ? 1 : 0;
  }
}

__global__ void level1_kernel(const uint8_t* __restrict__ grey,
                              float* __restrict__ level1, int B, int H, int W,
                              int h1, int w1) {
  const int64_t n = static_cast<int64_t>(B) * h1 * w1;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int b = static_cast<int>(i / (static_cast<int64_t>(h1) * w1));
    const int yi = static_cast<int>((i / w1) % h1);
    const int xi = static_cast<int>(i % w1);
    const uint8_t* g = grey + static_cast<size_t>(b) * H * W;
    float s = 0.0f;
    for (int dy = 0; dy < 2; ++dy) {
      for (int dx = 0; dx < 2; ++dx) {
        const int y = 2 * yi + dy;
        const int x = 2 * xi + dx;
        if (in_image(y, x, H, W)) s += static_cast<float>(g[static_cast<size_t>(y) * W + x]);
      }
    }
    level1[i] = s * 0.25f;
  }
}

int grid_for(int64_t n) {
  const int64_t blocks = (n + 255) / 256;
  return static_cast<int>(blocks < 65535 * 16 ? blocks : 65535 * 16);
}

}  // namespace

// grey (B,H,W) u8 -> opened (B,H,W) scratch, near (B,H,W), coarse
// (B,hc,wc) as 0/1 bytes, level1 (B,h1,w1) f32.  Returns cudaGetLastError().
extern "C" int a3_frontend(const uint8_t* grey, uint8_t* opened, uint8_t* near,
                           uint8_t* coarse, float* level1, int B, int H, int W,
                           int r, int r_open, int ds, int h1, int w1,
                           cudaStream_t stream) {
  const int eb = 2 * r_open + 2;
  if (TILE + 2 * eb > 64) return cudaErrorInvalidValue;  // mask rows are 64-bit words
  const int ng = TILE + 2 * (r + eb);
  const int nb = TILE + 2 * eb;
  const size_t smem = sizeof(int) * (ng * ng + nb * ng) + sizeof(u64) * 3 * nb;
  cudaError_t e = cudaFuncSetAttribute(threshold_open_near_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  threshold_open_near_kernel<<<grid, THREADS, smem, stream>>>(grey, opened, near, H, W,
                                                              r, r_open);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int hc = (H + ds - 1) / ds;
  const int wc = (W + ds - 1) / ds;
  const int64_t nc = static_cast<int64_t>(B) * hc * wc;
  pool_kernel<<<grid_for(nc), 256, 0, stream>>>(opened, coarse, B, H, W, ds, hc, wc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t nl = static_cast<int64_t>(B) * h1 * w1;
  level1_kernel<<<grid_for(nl), 256, 0, stream>>>(grey, level1, B, H, W, h1, w1);
  return cudaGetLastError();
}
