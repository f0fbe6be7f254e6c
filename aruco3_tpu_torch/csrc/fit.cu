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
// What bounds them on an H100: latency, not bytes (an int32 108x192 plane
// is 83 KB).  Kernel 7 is fit_common.cuh's fit_plane twice in one block
// per frame, each plane first staged into shared memory as uint16_t (16
// bytes a thread) beside its member lists and the fit scratch (grids below
// 65,536 cells where they fit; else all three stay in device memory, the
// scratch a frame's share of the wrapper's buffer: fused_layout).  The
// wrapper takes threads per block from the batch and that shared memory
// (ops.fit.threads_per_block): a batch of up to 132 frames gets 1,024
// threads a frame, a larger one smaller blocks, several resident per SM.
// Kernel 5 is fit_plane's rank pool alone (its admission words in shared
// memory where they fit, else in device scratch).  Kernel 6 runs one block
// of 256 threads per (lane, frame), so K = 160 lanes of a frame spread
// over the SMs; blocks of unused lanes write zeros and stop.

#include <type_traits>

#include "fit_common.cuh"

namespace {

using a3fit::FitParams;
using a3fit::FitPtrs;

constexpr int RANK_THREADS = 1024;
constexpr int LANE_THREADS = 256;
constexpr int LANE_WARPS = LANE_THREADS / 32;

// Kernel 5's rank_pool_ints of row counts and admission bits: in shared
// memory when they fit, else a frame's device scratch.
a3fit::Layout rank_layout(int hc, int wc) {
  const long long ints = a3fit::rank_pool_ints(hc, wc);
  if (ints * 4 <= a3fit::SMEM_MAX) return {true, ints * 4, 0};
  return {false, 0, ints};
}

// scratch: nullptr when the admission words are in shared memory.
__global__ void __launch_bounds__(RANK_THREADS)
rank_roots_kernel(const int* __restrict__ labels, int* roots_r, int* sizes_r, int* n_roots,
                  int* scratch, int hc, int wc, int kr, int min_px) {
  extern __shared__ int dyn_rank[];
  const int b = blockIdx.x;
  const size_t P = static_cast<size_t>(hc) * wc;
  int* row_off = scratch ? scratch + static_cast<size_t>(b) * a3fit::rank_pool_ints(hc, wc)
                         : dyn_rank;
  const a3fit::Labels<int> lab = {labels + b * P, hc, wc, wc};
  const int n = a3fit::rank_pool(lab, kr, min_px, row_off, roots_r + static_cast<size_t>(b) * kr,
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
  const a3fit::PlaneMembers mem = {labels + static_cast<size_t>(blockIdx.y) * P, P, roots[lane]};
  const a3fit::LaneFit f = a3fit::lane_chain(red, mem, wc, sizes[lane], ds, slack);
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

// Stage a frame's int32 label plane into shared memory as uint16_t.
__device__ void stage(const int* __restrict__ src, uint16_t* dst, int P) {
  if ((P & 3) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    for (int i = threadIdx.x; i < P / 4; i += blockDim.x) {
      const int4 v = s4[i];
      dst[4 * i] = static_cast<uint16_t>(v.x);
      dst[4 * i + 1] = static_cast<uint16_t>(v.y);
      dst[4 * i + 2] = static_cast<uint16_t>(v.z);
      dst[4 * i + 3] = static_cast<uint16_t>(v.w);
    }
  } else {
    for (int i = threadIdx.x; i < P; i += blockDim.x) dst[i] = static_cast<uint16_t>(src[i]);
  }
  __syncthreads();
}

// Kernel 7 on chip: the fit scratch, the staged uint16_t plane and the
// member list in shared memory (grids below 65,536 cells where they fit);
// else all three in device memory: the planes read where they lie, a
// frame's scratch the member list (hc * wc ints) and then the fit scratch.
a3fit::Layout fused_layout(int hc, int wc, int kr) {
  const long long P = static_cast<long long>(hc) * wc;
  const long long ints = a3fit::scratch_ints(kr, hc, wc);
  const long long smem = ints * 4 + 2 * ((P + 7) / 8 * 16);
  if (P < 65536 && smem <= a3fit::SMEM_MAX) return {true, smem, 0};
  return {false, 0, P + ints};
}

// SMEM: fused_layout's on-chip layout in dyn; else its device scratch.
template <bool SMEM>
__global__ void __launch_bounds__(1024)
fused_fit_kernel(const int* __restrict__ labels1, const int* __restrict__ labels2,
                 FitPtrs fit1, FitPtrs fit2, int* scratch, int hc, int wc, int k1, int k2,
                 int kr1, int kr2, FitParams pr, int dup_skip) {
  using Idx = typename std::conditional<SMEM, uint16_t, int>::type;
  extern __shared__ __align__(16) int dyn[];
  const int b = blockIdx.x;
  const int P = hc * wc;
  const int kr = max(kr1, kr2);
  const int ints = a3fit::scratch_ints(kr, hc, wc);
  int* frame = SMEM ? nullptr : scratch + static_cast<size_t>(b) * (static_cast<size_t>(P) + ints);
  const a3fit::FitScratch s = a3fit::FitScratch::carve(SMEM ? dyn : frame + P, kr, hc, wc);
  uint16_t* staged = reinterpret_cast<uint16_t*>(dyn + ints);
  uint16_t* members16 = staged + (P + 7) / 8 * 8;
  Idx* members = SMEM ? reinterpret_cast<Idx*>(members16) : reinterpret_cast<Idx*>(frame);
  const int* lab1 = labels1 + static_cast<size_t>(b) * P;
  const int* lab2 = labels2 + static_cast<size_t>(b) * P;
  const a3fit::FitOut o1 = fit1.frame(b, k1);
  const a3fit::Twins none = {nullptr, nullptr, nullptr, 0};
  const a3fit::Twins twins = {o1.roots, o1.sizes, o1.valid, k1};
  for (int plane = 0; plane < (k2 > 0 ? 2 : 1); ++plane) {
    const int* lab = plane ? lab2 : lab1;
    const int k = plane ? k2 : k1;
    const int kp = plane ? kr2 : kr1;
    const a3fit::FitOut o = plane ? fit2.frame(b, k2) : o1;
    // The outer lanes are this block's own writes, visible after the
    // barrier that ends the first fit_plane.
    const a3fit::Twins& tw = plane && dup_skip ? twins : none;
    if (SMEM) {
      stage(lab, staged, P);
      a3fit::fit_plane(a3fit::Labels<uint16_t>{staged, hc, wc, wc}, k, kp, o, s, members, pr, tw);
    } else {
      a3fit::fit_plane(a3fit::Labels<int>{lab, hc, wc, wc}, k, kp, o, s, members, pr, tw);
    }
  }
}

template <class K>
int launch_smem(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// out[0], out[1]: bytes of shared memory a block and ints of device
// scratch a frame that a3_rank_roots (kernel 5) and a3_fused_fit (kernel 7)
// take for an hc x wc grid (kr: the larger rank pool).
extern "C" int a3_rank_layout(int hc, int wc, long long* out) {
  return a3fit::put_layout(rank_layout(hc, wc), out);
}

extern "C" int a3_fused_layout(int hc, int wc, int kr, long long* out) {
  return a3fit::put_layout(fused_layout(hc, wc, kr), out);
}

// labels (B,hc,wc) int32 -> roots_r, sizes_r (B,kr) int32 (fill 0 / -1)
// and n_roots (B,).  scratch: scratch_ints a frame, at least
// a3_rank_layout's.  Returns cudaGetLastError().
extern "C" int a3_rank_roots(const int* labels, int* roots_r, int* sizes_r, int* n_roots,
                             int* scratch, long long scratch_ints, int B, int hc, int wc, int kr,
                             int min_px, cudaStream_t stream) {
  const a3fit::Layout l = rank_layout(hc, wc);
  if (scratch_ints < l.scratch) return cudaErrorInvalidValue;
  cudaError_t e = static_cast<cudaError_t>(launch_smem(rank_roots_kernel, static_cast<int>(l.smem)));
  if (e != cudaSuccess) return e;
  rank_roots_kernel<<<B, RANK_THREADS, l.smem, stream>>>(
      labels, roots_r, sizes_r, n_roots, l.in_smem ? nullptr : scratch, hc, wc, kr, min_px);
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
// the outer plane only).  threads: a multiple of 32 in [64, 1024];
// scratch: scratch_ints a frame, at least a3_fused_layout's.  Returns
// cudaGetLastError().
extern "C" int a3_fused_fit(const int* labels1, const int* labels2, float* quads1,
                            uint8_t* valid1, int* roots1, float* cents1, int* sizes1, int* qual1,
                            float* quads2, uint8_t* valid2, int* roots2, float* cents2,
                            int* sizes2, int* qual2, int* scratch, int B, int hc, int wc, int ds,
                            int k1, int k2, int kr1, int kr2, float slack,
                            float min_containment, int min_px, int dup_skip, int threads,
                            long long scratch_ints, cudaStream_t stream) {
  const a3fit::Layout l = fused_layout(hc, wc, max(kr1, kr2));
  if (k1 <= 0 || k1 > a3fit::K_MAX || k2 > a3fit::K_MAX || kr1 > a3fit::KR_MAX ||
      kr2 > a3fit::KR_MAX || k1 > kr1 || (k2 > 0 && k2 > kr2) || threads % 32 != 0 ||
      threads < 64 || threads > 1024 || scratch_ints < l.scratch)
    return cudaErrorInvalidValue;
  const FitPtrs fit1 = {quads1, valid1, roots1, cents1, sizes1, qual1};
  const FitPtrs fit2 = {quads2, valid2, roots2, cents2, sizes2, qual2};
  FitParams pr;
  pr.ds = ds;
  pr.min_px = min_px;
  pr.slack = slack;
  pr.min_containment = min_containment;
  if (l.in_smem) {
    cudaError_t e = static_cast<cudaError_t>(launch_smem(fused_fit_kernel<true>, l.smem));
    if (e != cudaSuccess) return e;
    fused_fit_kernel<true><<<B, threads, l.smem, stream>>>(
        labels1, labels2, fit1, fit2, scratch, hc, wc, k1, k2, kr1, kr2, pr, dup_skip);
  } else {
    fused_fit_kernel<false><<<B, threads, 0, stream>>>(
        labels1, labels2, fit1, fit2, scratch, hc, wc, k1, k2, kr1, kr2, pr, dup_skip);
  }
  return cudaGetLastError();
}
