// Kernel 8: bilinear evaluation of pre-sliced 64 x 64 pyramid windows.
//
// Replaces the TPU kernel aruco3_tpu/ops/warp_pallas.py warp_eval
// (pallas_call at :80), the window evaluation of the XLA pyramid warp
// rectify.warp_patches_mxu.  Its specification: for window n and sample s,
//
//   out[n, s] = sum_y wy[s, y] * sum_x wx[s, x] * window[n, y, x]
//
// over x, y in 0..63, with wx = max(0, 1 - |ux - x|) and wy the same in y.
// Only the taps floor(u) and floor(u) + 1 that lie inside the window carry
// weight (a coordinate in (-1, 0) or (63, 64) keeps one partial tap; one
// further out none), so each sample is four taps.  The weights are float32;
// the TPU kernel rounds wx and the windows to bfloat16 (a stated deviation
// of the port).
//
// What bounds it on an H100: bytes.  Per window it reads 16 KB of window
// and 8 * S^2 bytes of coordinates and writes 4 * S^2 bytes of samples, and
// does about 20 operations per sample, far below the card's float32 rate
// per byte.  Design: one block per window; the window is staged in shared
// memory with 16-byte loads, then each thread evaluates samples s, s + 256,
// ... with coalesced reads of the coordinates and a coalesced write of the
// result.  Every lane given is evaluated, as on the TPU.
//
// Rounding: each row sum accumulates its taps in ascending x with one
// fused multiply-add per tap (fmaf), as a float32 matrix product does; the
// row blend is a separate product and sum (built with -fmad=false), as the
// plain version's elementwise product and reduction are.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WIN = 64;

struct Taps {
  int j0;       // first tap, floor(u); valid where in0
  float w0, w1;  // weights of floor(u) and floor(u) + 1
  bool in0, in1;
};

__device__ __forceinline__ Taps taps(float u) {
  const float f0 = floorf(u);
  const float f1 = f0 + 1.0f;
  Taps t;
  t.w0 = fmaxf(1.0f - fabsf(u - f0), 0.0f);
  t.w1 = fmaxf(1.0f - fabsf(u - f1), 0.0f);
  t.in0 = f0 >= 0.0f && f0 < static_cast<float>(WIN);
  t.in1 = f1 >= 0.0f && f1 < static_cast<float>(WIN);
  t.j0 = (t.in0 || t.in1) ? static_cast<int>(f0) : 0;
  return t;
}

// sum_x wx[x] * row[x] over the (at most two) taps, ascending x.
__device__ __forceinline__ float row_sum(const float* row, const Taps& x) {
  float acc = 0.0f;
  if (x.in0) acc = fmaf(x.w0, row[x.j0], acc);
  if (x.in1) acc = fmaf(x.w1, row[x.j0 + 1], acc);
  return acc;
}

__global__ void __launch_bounds__(THREADS)
warp_eval_kernel(const float* __restrict__ windows, const float* __restrict__ ux,
                 const float* __restrict__ uy, float* __restrict__ out, int S2) {
  __shared__ __align__(16) float win[WIN * WIN];
  const size_t n = blockIdx.x;
  const float4* src = reinterpret_cast<const float4*>(windows + n * WIN * WIN);
  float4* dst = reinterpret_cast<float4*>(win);
  for (int i = threadIdx.x; i < WIN * WIN / 4; i += THREADS) dst[i] = src[i];
  __syncthreads();

  const float* px = ux + n * S2;
  const float* py = uy + n * S2;
  float* po = out + n * S2;
  for (int s = threadIdx.x; s < S2; s += THREADS) {
    const Taps x = taps(px[s]);
    const Taps y = taps(py[s]);
    const float t0 = y.in0 ? row_sum(win + y.j0 * WIN, x) : 0.0f;
    const float t1 = y.in1 ? row_sum(win + (y.j0 + 1) * WIN, x) : 0.0f;
    po[s] = y.w0 * t0 + y.w1 * t1;
  }
}

}  // namespace

// windows (N, 64, 64) f32, ux/uy (N, S2) f32 -> out (N, S2) f32.
extern "C" int a3_warp_eval(const float* windows, const float* ux, const float* uy, float* out,
                            int N, int S2, cudaStream_t stream) {
  if (N == 0 || S2 == 0) return cudaSuccess;
  warp_eval_kernel<<<N, THREADS, 0, stream>>>(windows, ux, uy, out, S2);
  return cudaGetLastError();
}
