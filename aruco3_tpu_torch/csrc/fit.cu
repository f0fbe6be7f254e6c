// Kernels 5, 6 and 7: the standalone fit of label planes.
//
// Replace the TPU kernels of aruco3_tpu/ops/fit_pallas.py:
//   * a3_rank_roots (kernel 5): rank_roots_kernel (:271), the raster rank
//     pool of one label plane;
//   * a3_fit_lanes (kernel 6): fit_lanes_kernel (:331), the per-lane fit
//     chain of selected (root, size) lanes;
//   * a3_fused_fit (kernel 7): _fused_fit_call (:445, entered through
//     fused_fit_batch :823), rank pool + top-k + fit chain of both label
//     planes in one launch, with the inner pass's twin skip.
// Their specification is segment.fit_quads (and merge_fits' exact-twin
// rule for the skip); the shared pieces are in fit_common.cuh.
//
// What bounds them on an H100: latency, not bytes.  A 108x192 int32 plane
// is 83 KB and stays in L2; the work is chains of block- or warp-wide
// reductions over it (five passes per lane, each ending in a reduction).
// Design: kernels 5 and 7 run one block of 1024 threads per frame (the
// rank pool is a block-wide scan; kernel 7 then gives each lane to one
// warp, as kernel 2's tail does).  Kernel 6 runs one block of 256 threads
// per (lane, frame), so K = 160 lanes of a frame spread over the SMs;
// blocks of unused lanes write zeros and stop.

#include "fit_common.cuh"

namespace {

using a3fit::FitParams;
using a3fit::FitPtrs;

constexpr int RANK_THREADS = 1024;
constexpr int LANE_THREADS = 256;
constexpr int LANE_WARPS = LANE_THREADS / 32;

__global__ void __launch_bounds__(RANK_THREADS)
rank_roots_kernel(const int* __restrict__ labels, int* roots_r, int* sizes_r, int* n_roots,
                  int* scratch, int hc, int wc, int kr, int min_px) {
  __shared__ int chunk[RANK_THREADS];
  __shared__ int n_sh;
  const int b = blockIdx.x;
  const size_t P = static_cast<size_t>(hc) * wc;
  const int n = a3fit::rank_pool(labels + b * P, hc, wc, kr, min_px, scratch + b * P, chunk,
                                 &n_sh, roots_r + static_cast<size_t>(b) * kr,
                                 sizes_r + static_cast<size_t>(b) * kr);
  if (threadIdx.x == 0) n_roots[b] = n;
}

__global__ void __launch_bounds__(LANE_THREADS)
fit_lanes_kernel(const int* __restrict__ labels, const int* __restrict__ roots,
                 const int* __restrict__ sizes, const uint8_t* __restrict__ use, float* quads,
                 float* cents, float* frac, int hc, int wc, int k, int ds, float slack) {
  __shared__ double sd[LANE_WARPS];
  __shared__ float sf[LANE_WARPS];
  __shared__ int si[LANE_WARPS];
  const int P = hc * wc;
  const size_t lane = static_cast<size_t>(blockIdx.y) * k + blockIdx.x;
  float* q = quads + lane * 8;
  if (!use[lane]) {
    if (threadIdx.x < 8) q[threadIdx.x] = 0.0f;
    if (threadIdx.x < 2) cents[lane * 2 + threadIdx.x] = 0.0f;
    if (threadIdx.x == 0) frac[lane] = 0.0f;
    return;
  }
  const a3fit::BlockRed<LANE_WARPS> red = {sd, sf, si};
  const a3fit::LaneFit f = a3fit::lane_chain(red, labels + static_cast<size_t>(blockIdx.y) * P, P,
                                             wc, roots[lane], sizes[lane], ds, slack);
  if (threadIdx.x == 0) {
    for (int c = 0; c < 4; ++c) {
      q[c * 2] = f.qx[c];
      q[c * 2 + 1] = f.qy[c];
    }
    cents[lane * 2] = f.cenx;
    cents[lane * 2 + 1] = f.ceny;
    frac[lane] = f.frac;
  }
}

__global__ void __launch_bounds__(RANK_THREADS)
fused_fit_kernel(const int* __restrict__ labels1, const int* __restrict__ labels2,
                 FitPtrs fit1, FitPtrs fit2, int* scratch, int hc, int wc, int k1, int k2,
                 int kr1, int kr2, FitParams pr, int dup_skip) {
  __shared__ a3fit::FitSmem<RANK_THREADS> fs;
  const int b = blockIdx.x;
  const size_t P = static_cast<size_t>(hc) * wc;
  int* cnt = scratch + b * P;
  const a3fit::FitOut o1 = fit1.frame(b, k1);
  const a3fit::Twins none = {nullptr, nullptr, nullptr, 0};
  a3fit::fit_plane(labels1 + b * P, hc, wc, k1, kr1, o1, cnt, fs, pr, none);
  if (k2 <= 0) return;
  // The outer lanes are this block's own writes, visible after the
  // barrier that ends fit_plane.
  const a3fit::Twins twins = {o1.roots, o1.sizes, o1.valid, k1};
  a3fit::fit_plane(labels2 + b * P, hc, wc, k2, kr2, fit2.frame(b, k2), cnt, fs, pr,
                   dup_skip ? twins : none);
}

}  // namespace

// labels (B,hc,wc) int32 -> roots_r, sizes_r (B,kr) int32 (fill 0 / -1)
// and n_roots (B,).  Scratch: B*hc*wc ints.  Returns cudaGetLastError().
extern "C" int a3_rank_roots(const int* labels, int* roots_r, int* sizes_r, int* n_roots,
                             int* scratch, int B, int hc, int wc, int kr, int min_px,
                             cudaStream_t stream) {
  rank_roots_kernel<<<B, RANK_THREADS, 0, stream>>>(labels, roots_r, sizes_r, n_roots, scratch,
                                                    hc, wc, kr, min_px);
  return cudaGetLastError();
}

// labels (B,hc,wc) int32, roots / sizes (B,K) int32, use (B,K) bool ->
// quads (B,K,4,2), centroids (B,K,2), frac (B,K) float32; unused lanes get
// zeros.  Returns cudaGetLastError().
extern "C" int a3_fit_lanes(const int* labels, const int* roots, const int* sizes,
                            const uint8_t* use, float* quads, float* cents, float* frac, int B,
                            int hc, int wc, int k, int ds, float slack, cudaStream_t stream) {
  if (k <= 0 || B <= 0) return cudaSuccess;
  if (B > 65535) return cudaErrorInvalidValue;
  fit_lanes_kernel<<<dim3(k, B), LANE_THREADS, 0, stream>>>(labels, roots, sizes, use, quads,
                                                            cents, frac, hc, wc, k, ds, slack);
  return cudaGetLastError();
}

// labels1, labels2 (B,hc,wc) int32 -> the fits of both planes (k2 = 0:
// the outer plane only).  Scratch: B*hc*wc ints.  Returns
// cudaGetLastError().
extern "C" int a3_fused_fit(const int* labels1, const int* labels2, float* quads1,
                            uint8_t* valid1, int* roots1, float* cents1, int* sizes1, int* qual1,
                            float* quads2, uint8_t* valid2, int* roots2, float* cents2,
                            int* sizes2, int* qual2, int* scratch, int B, int hc, int wc, int ds,
                            int k1, int k2, int kr1, int kr2, float slack,
                            float min_containment, int min_px, int dup_skip,
                            cudaStream_t stream) {
  if (k1 <= 0 || k1 > a3fit::K_MAX || k2 > a3fit::K_MAX || kr1 > a3fit::KR_MAX ||
      kr2 > a3fit::KR_MAX)
    return cudaErrorInvalidValue;
  const FitPtrs fit1 = {quads1, valid1, roots1, cents1, sizes1, qual1};
  const FitPtrs fit2 = {quads2, valid2, roots2, cents2, sizes2, qual2};
  FitParams pr;
  pr.ds = ds;
  pr.min_px = min_px;
  pr.slack = slack;
  pr.min_containment = min_containment;
  fused_fit_kernel<<<B, RANK_THREADS, 0, stream>>>(labels1, labels2, fit1, fit2, scratch, hc, wc,
                                                   k1, k2, kr1, kr2, pr, dup_skip);
  return cudaGetLastError();
}
