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
// further out none), so each sample is four taps.  As the TPU kernel does,
// it rounds wx and each window value to bfloat16 (__float2bfloat16_rn) and
// keeps wy, the row sums and the blend float32.  A product of two bfloat16
// values is exact in float32, so a row sum of two taps rounds once, in
// whatever order the TPU kernel's matrix product adds them: the samples
// are the TPU kernel's bit for bit.
//
// What bounds it on an H100: bytes at many lanes, latency at few.  Per
// window it reads 16 KB of window and 8 * S^2 bytes of coordinates and
// writes 4 * S^2 bytes of samples, about 20 operations per sample.  One
// block per window reaches the bytes bound at thousands of windows, but at
// 128 windows it is one thin wave on 132 SMs with ~10 samples walked in
// turn by each thread.  Design: a block takes one window and one chunk of
// `chunk` consecutive samples (a multiple of the block), chosen by the
// wrapper from N (ops/warp_eval.py chunk_size).  With one chunk per window
// (many windows) the block stages the window in shared memory with 16-byte
// loads and evaluates its samples from there, four a step so that their
// coordinate loads overlap.  With several chunks a window (few windows)
// the grid holds up to two waves of blocks and each thread reads its
// sample's taps straight from the window through the read-only cache: two
// dependent loads a sample, as grid_sample makes, and no staging.  Every
// lane given is evaluated, as on the TPU.
//
// Rounding: each row sum accumulates its two taps with one fused
// multiply-add each (fmaf; the products are exact, so the sum rounds once);
// the row blend is a separate product and sum (built with -fmad=false), as
// the plain version's elementwise product and reduction are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WIN = 64;

// The two taps of a coordinate: floor(u) and floor(u) + 1, each with its
// weight and whether it lies in the window.  Indices outside the window are
// clamped to 0 and read but weigh nothing, so a sample makes its four loads
// without branches and their latencies overlap.
struct Taps {
  int j0, j1;
  float w0, w1;
  bool in0, in1;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ Taps taps(float u) {
  const float f0 = floorf(u);
  const float f1 = f0 + 1.0f;
  Taps t;
  t.w0 = fmaxf(1.0f - fabsf(u - f0), 0.0f);
  t.w1 = fmaxf(1.0f - fabsf(u - f1), 0.0f);
  t.in0 = f0 >= 0.0f && f0 < static_cast<float>(WIN);
  t.in1 = f1 >= 0.0f && f1 < static_cast<float>(WIN);
  t.j0 = t.in0 ? static_cast<int>(f0) : 0;
  t.j1 = t.in1 ? static_cast<int>(f1) : 0;
  return t;
}

// A tap from shared memory, or from device memory through the read-only
// cache, rounded to bfloat16.
template <bool kGlobal>
__device__ __forceinline__ float tap(const float* p) {
  return bf16_round(kGlobal ? __ldg(p) : *p);
}

// sum_x wx[x] * row[x] over the two taps, ascending x, with the weights
// rounded to bfloat16.  A tap outside the window adds 0 * (a finite grey
// value), which leaves the sum as skipping it would.
template <bool kGlobal>
__device__ __forceinline__ float row_sum(const float* row, const Taps& x) {
  const float v0 = tap<kGlobal>(row + x.j0);
  const float v1 = tap<kGlobal>(row + x.j1);
  const float acc = fmaf(x.in0 ? bf16_round(x.w0) : 0.0f, v0, 0.0f);
  return fmaf(x.in1 ? bf16_round(x.w1) : 0.0f, v1, acc);
}

// One sample: four taps of `win` (in device memory if kGlobal).
template <bool kGlobal>
__device__ __forceinline__ float sample(const float* win, float u, float v) {
  const Taps x = taps(u);
  const Taps y = taps(v);
  const float r0 = row_sum<kGlobal>(win + y.j0 * WIN, x);
  const float r1 = row_sum<kGlobal>(win + y.j1 * WIN, x);
  const float t0 = y.in0 ? r0 : 0.0f;
  const float t1 = y.in1 ? r1 : 0.0f;
  return y.w0 * t0 + y.w1 * t1;
}

__global__ void __launch_bounds__(THREADS)
warp_eval_kernel(const float* __restrict__ windows, const float* __restrict__ ux,
                 const float* __restrict__ uy, float* __restrict__ out, int S2, int chunk) {
  __shared__ __align__(16) float staged[WIN * WIN];
  const size_t n = blockIdx.x;
  const int s0 = blockIdx.y * chunk;
  const int s1 = min(S2, s0 + chunk);
  const float* px = ux + n * S2;
  const float* py = uy + n * S2;
  float* po = out + n * S2;
  const float* win = windows + n * WIN * WIN;

  if (chunk >= S2) {
    // One block per window: stage it, then every sample from shared memory,
    // four a step.  The window's loads and the first step's coordinate
    // loads are in flight together, and each step loads the next step's
    // coordinates before it evaluates its own.
    const float4* src = reinterpret_cast<const float4*>(win);
    float4* dst = reinterpret_cast<float4*>(staged);
    float4 part[WIN * WIN / 4 / THREADS];
#pragma unroll
    for (int i = 0; i < WIN * WIN / 4 / THREADS; ++i) part[i] = __ldg(src + threadIdx.x + i * THREADS);
    float u[4], v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = min(int(threadIdx.x) + j * THREADS, S2 - 1);
      u[j] = __ldg(px + t);
      v[j] = __ldg(py + t);
    }
#pragma unroll
    for (int i = 0; i < WIN * WIN / 4 / THREADS; ++i) dst[threadIdx.x + i * THREADS] = part[i];
    __syncthreads();
    for (int s = threadIdx.x; s < S2; s += 4 * THREADS) {
      float nu[4], nv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = min(s + (4 + j) * THREADS, S2 - 1);
        nu[j] = __ldg(px + t);
        nv[j] = __ldg(py + t);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (s + j * THREADS < S2) po[s + j * THREADS] = sample<false>(staged, u[j], v[j]);
        u[j] = nu[j];
        v[j] = nv[j];
      }
    }
    return;
  }
  // Few windows, many blocks: taps straight from the window through the
  // read-only cache, two samples a step so that their loads overlap.
  int s = s0 + threadIdx.x;
  for (; s + THREADS < s1; s += 2 * THREADS) {
    const float u0 = __ldg(px + s), v0 = __ldg(py + s);
    const float u1 = __ldg(px + s + THREADS), v1 = __ldg(py + s + THREADS);
    const float a = sample<true>(win, u0, v0);
    const float c = sample<true>(win, u1, v1);
    po[s] = a;
    po[s + THREADS] = c;
  }
  if (s < s1) po[s] = sample<true>(win, __ldg(px + s), __ldg(py + s));
}

}  // namespace

// windows (N, 64, 64) f32, ux/uy (N, S2) f32 -> out (N, S2) f32; one block
// per window and chunk of `chunk` samples (a positive multiple of 256).
extern "C" int a3_warp_eval(const float* windows, const float* ux, const float* uy, float* out,
                            int N, int S2, int chunk, cudaStream_t stream) {
  if (N == 0 || S2 == 0) return cudaSuccess;
  if (chunk <= 0 || chunk % THREADS != 0) return cudaErrorInvalidValue;
  const dim3 grid(N, (S2 + chunk - 1) / chunk);
  warp_eval_kernel<<<grid, THREADS, 0, stream>>>(windows, ux, uy, out, S2, chunk);
  return cudaGetLastError();
}
