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
// is 83 KB, L2-resident after kernel 2).
//
// Kernel 7 is fit_common.cuh's fit_plane twice in one block per frame,
// each plane first staged into shared memory as uint16_t (16 bytes a
// thread) beside its member lists and the fit scratch (grids below 65,536
// cells where they fit; else all three stay in device memory, the scratch
// a frame's share of the wrapper's buffer: fused_layout).  The wrapper
// takes threads per block from the batch and that shared memory
// (ops.fit.threads_per_block).
//
// Kernel 5 runs a frame on a thread-block cluster of C blocks (C from
// ops.fit.rank_cluster: up to 8 while the batch leaves SMs idle), block r
// a band of rows: admission ballots of its band (bits and row counts in
// its shared memory, or device scratch where a band does not fit:
// rank_layout); after a cluster barrier, its raster-rank offset and
// n_roots from the other bands' totals through distributed shared memory
// (DSMEM), its segment of the ascending pool to roots_r and to its shared
// memory; after another, the whole pool gathered from the cluster; its
// cells counted per pool slot (binary search, warp-aggregated atomics),
// each count added into the slot owner's shared memory (a DSMEM atomic);
// after a last barrier each owner writes its slots' sizes.  All integer:
// the same result in any order.
//
// Kernel 6 fits a group of G lanes of a frame in one block (G from
// ops.fit.lane_group: about one block an SM, 20 lanes a block on dense's
// 16 frames): the group's used lanes sorted by root in shared memory,
// beside a 65,536-bit filter of their roots; the frame's plane staged on
// chip as uint16_t; two passes over it (a cell finds its root's slot by
// the filter, then a binary search among the sorted roots) count each
// root's members and list them root after root (warp-aggregated atomics);
// then a warp a lane runs fit_common.cuh's lane_chain over its root's
// list with its own size divisor (lanes that share a root share a list),
// the chain of kernels 2 and 7.  So the plane is read three times a block,
// not five times a lane.  Grids of 65,536 cells or more, or too big for
// shared memory, read the plane where it lies and keep a block's list in
// device scratch (lanes_layout; lane_group then takes the fewest blocks).
// Five plane passes instead, each advancing all G lanes with shared
// atomics per member cell (arg-max keys under a 64-bit atomicMax), took
// 0.099 ms per dense batch on an H100 against this design's 0.022, most of
// it in the per-cell work (PERF.md).

#include <cooperative_groups.h>

#include <type_traits>

#include "fit_common.cuh"

namespace cg = cooperative_groups;

namespace {

using a3fit::FitParams;
using a3fit::FitPtrs;

constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------- kernel 5

constexpr int RANK_THREADS = 512;
constexpr int RANK_CLUSTER_MAX = 8;     // portable cluster size
constexpr int RANK_HDR = 16;            // band total, then the C + 1 band offsets

// Rows of a band, and the ints of its row counts and admission words.
__host__ __device__ inline int band_rows(int hc, int c) { return (hc + c - 1) / c; }
__host__ __device__ inline long long band_ints(int hc, int wc, int c) {
  const long long r = band_rows(hc, c);
  return r + 1 + r * ((wc + 31) / 32);
}

// Kernel 5's shared memory a block (header, then pool, local counts and
// owned sizes, kr each, then the band's row counts and admission words
// where they fit) and device scratch a frame (the bands' where they do
// not).
a3fit::Layout rank_layout(int hc, int wc, int kr, int c) {
  const long long fixed = 4LL * (RANK_HDR + 3LL * kr);
  const long long band = 4 * band_ints(hc, wc, c);
  if (fixed + band <= a3fit::SMEM_MAX) return {true, fixed + band, 0};
  return {false, fixed, c * band_ints(hc, wc, c)};
}

// Cluster rank of the band that holds pool slot j (off: C + 1 offsets).
__device__ __forceinline__ int slot_owner(const int* off, int c, int j) {
  int q = 0;
  while (q + 1 < c && off[q + 1] <= j) ++q;
  return q;
}

// grid (C, B), clusters of (C, 1, 1); scratch: nullptr when the bands
// are in shared memory.
__global__ void __launch_bounds__(RANK_THREADS)
rank_roots_kernel(const int* __restrict__ labels, int* roots_r, int* sizes_r, int* n_roots,
                  int* scratch, int hc, int wc, int kr, int min_px) {
  extern __shared__ __align__(16) int dyn[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int P = hc * wc, nw = (wc + 31) / 32;
  const int R = band_rows(hc, c);
  const int y0 = min(hc, r * R), rows = min(hc, y0 + R) - y0, items = rows * nw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int* hdr = dyn;                // [0]: band total; [1, c + 2): band offsets, n_roots last
  int* pool = dyn + RANK_HDR;    // the ascending pool (kr)
  int* lcnt = pool + kr;         // this band's cells per slot
  int* osz = lcnt + kr;          // the whole frame's cells per slot this band owns
  int* row_cnt = scratch ? scratch + (static_cast<size_t>(b) * c + r) * band_ints(hc, wc, c)
                         : osz + kr;
  unsigned* adm = reinterpret_cast<unsigned*>(row_cnt + R + 1);
  int* out_roots = roots_r + static_cast<size_t>(b) * kr;
  int* out_sizes = sizes_r + static_cast<size_t>(b) * kr;
  const a3fit::Labels<int> lab = {labels + static_cast<size_t>(b) * P, hc, wc, wc};

  for (int i = threadIdx.x; i < rows; i += blockDim.x) row_cnt[i] = 0;
  for (int j = threadIdx.x; j < kr; j += blockDim.x) lcnt[j] = osz[j] = 0;
  __syncthreads();
  // Admission: a warp a word of the band, one ballot per 32 cells.
  const int t = min(min_px, 3);
  for (int it = warp; it < items; it += nwarps) {
    const int yy = it / nw, x = 32 * (it - yy * nw) + lane;
    const unsigned bits =
        __ballot_sync(FULL, x < wc && a3fit::is_admitted_root(lab, y0 + yy, x, t));
    if (lane == 0) {
      adm[it] = bits;
      if (bits) atomicAdd(&row_cnt[yy], __popc(bits));
    }
  }
  __syncthreads();
  if (warp == 0) a3fit::warp_scan_inplace(row_cnt, rows, &hdr[0]);
  cluster.sync();

  // Band offsets and n_roots from the cluster's band totals.
  int* off = hdr + 1;
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int q = 0; q < c; ++q) {
      off[q] = acc;
      acc += *cluster.map_shared_rank(hdr, q);
    }
    off[c] = acc;
  }
  __syncthreads();
  const int n_all = off[c], n_pool = min(n_all, kr), base = off[r];
  // Raster ranks of this band's roots: a thread a word.
  for (int i = threadIdx.x; i < items && base < kr; i += blockDim.x) {
    const int yy = i / nw, j = i - yy * nw;
    int rank = base + row_cnt[yy];
    for (int jj = 0; jj < j && rank < kr; ++jj) rank += __popc(adm[yy * nw + jj]);
    for (unsigned bits = adm[i]; bits && rank < kr; bits &= bits - 1, ++rank) {
      const int cell = (y0 + yy) * wc + 32 * j + __ffs(bits) - 1;
      pool[rank] = cell;
      out_roots[rank] = cell;
    }
  }
  for (int j = n_pool + r * blockDim.x + threadIdx.x; j < kr; j += c * blockDim.x) {
    out_roots[j] = 0;
    out_sizes[j] = -1;
  }
  cluster.sync();

  // The whole pool: the other bands' segments through DSMEM.
  for (int j = threadIdx.x; j < n_pool; j += blockDim.x) {
    const int q = slot_owner(off, c, j);
    if (q != r) pool[j] = *cluster.map_shared_rank(pool + j, q);
  }
  __syncthreads();
  // This band's cells per pool slot.
  for (int it = warp; it < items; it += nwarps) {
    const int yy = it / nw, x = 32 * (it - yy * nw) + lane;
    const int l = x < wc ? lab.at(y0 + yy, x) : P;
    a3fit::claim(lcnt, l < P ? a3fit::pool_slot(pool, n_pool, l) : -1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_pool; j += blockDim.x)
    if (lcnt[j]) atomicAdd(cluster.map_shared_rank(osz + j, slot_owner(off, c, j)), lcnt[j]);
  cluster.sync();

  // No DSMEM access after the last cluster barrier: a block may exit.
  for (int j = base + threadIdx.x; j < min(off[r + 1], n_pool); j += blockDim.x)
    out_sizes[j] = osz[j];
  if (r == 0 && threadIdx.x == 0) n_roots[b] = n_all;
}

// ---------------------------------------------------------------- kernels 6, 7

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

constexpr int LANE_THREADS = 1024;
constexpr int LANE_GROUP_MAX = 64;  // ops.fit.LANE_GROUP_MAX
// A 65,536-bit filter of the group's roots (bit root & 0xffff): most cells
// are no lane's member and skip the binary search.
constexpr int FILTER_WORDS = 2048;
constexpr long long LANE_STATIC_SMEM = 16384;  // fit_lanes_kernel's __shared__ arrays, rounded up

// Kernel 6's staged uint16_t plane and member list in shared memory (grids
// below 65,536 cells where they fit); else the plane read where it lies
// and a block's member list (hc * wc ints) in device scratch.
a3fit::Layout lanes_layout(int hc, int wc) {
  const long long P = static_cast<long long>(hc) * wc;
  const long long smem = 2 * ((P + 7) / 8 * 16);
  if (P < 65536 && smem + LANE_STATIC_SMEM <= a3fit::SMEM_MAX) return {true, smem, 0};
  return {false, 0, P};
}

// f(p, s) for every cell p of the plane: s is the group slot whose root is
// its label (the first slot of the root's run), or -1.  The whole warp
// iterates together.
template <class T, class F>
__device__ __forceinline__ void each_cell(const T* plane, int P, const unsigned* filter,
                                          const int* sroot, int g, F f) {
  const int P32 = (P + 31) & ~31;
  for (int p = threadIdx.x; p < P32; p += blockDim.x) {
    int s = -1;
    if (p < P) {
      const int l = static_cast<int>(plane[p]);
      if (filter[(l >> 5) & (FILTER_WORDS - 1)] >> (l & 31) & 1u) s = a3fit::pool_slot(sroot, g, l);
    }
    f(p, s);
  }
}

// grid (ceil(k / group), B): block x fits lanes [x * group, +group) of
// frame y.  SMEM: lanes_layout's on-chip layout in dyn; else scratch holds
// a block's member list.
template <bool SMEM>
__global__ void __launch_bounds__(LANE_THREADS)
fit_lanes_kernel(const int* __restrict__ labels, const int* __restrict__ roots,
                 const int* __restrict__ sizes, const uint8_t* __restrict__ use, float* quads,
                 float* cents, float* frac, int* scratch, int hc, int wc, int k, int group, int ds,
                 float slack) {
  using Idx = typename std::conditional<SMEM, uint16_t, int>::type;
  constexpr int G = LANE_GROUP_MAX;
  extern __shared__ __align__(16) int dyn[];
  __shared__ int raw[G], sroot[G], slane[G], ssize[G], cnt[G], off[G + 1], fill[G], used[G + 1];
  __shared__ unsigned filter[FILTER_WORDS];
  const int P = hc * wc, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  const int k0 = blockIdx.x * group, gk = min(group, k - k0);
  const size_t lane0 = static_cast<size_t>(blockIdx.y) * k + k0;
  const int* lab = labels + static_cast<size_t>(blockIdx.y) * P;
  uint16_t* staged = reinterpret_cast<uint16_t*>(dyn);
  Idx* members = SMEM ? reinterpret_cast<Idx*>(staged + (P + 7) / 8 * 8)
                      : reinterpret_cast<Idx*>(
                            scratch + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * P);

  // The group's used lanes, sorted by (root, lane), and the filter of their
  // roots; unused lanes get zeros.
  for (int i = t; i < FILTER_WORDS; i += blockDim.x) filter[i] = 0;
  if (t < gk) {
    const size_t l = lane0 + t;
    used[t] = use[l] != 0;
    raw[t] = roots[l];
    if (!used[t]) {
      for (int i = 0; i < 8; ++i) quads[l * 8 + i] = 0.0f;
      cents[l * 2] = cents[l * 2 + 1] = 0.0f;
      frac[l] = 0.0f;
    }
    cnt[t] = fill[t] = 0;
  }
  __syncthreads();
  if (t < gk && used[t]) {
    int rank = 0;
    for (int i = 0; i < gk; ++i)
      rank += used[i] && (raw[i] < raw[t] || (raw[i] == raw[t] && i < t));
    sroot[rank] = raw[t];
    slane[rank] = t;
    ssize[rank] = sizes[lane0 + t];
    atomicOr(&filter[(raw[t] >> 5) & (FILTER_WORDS - 1)], 1u << (raw[t] & 31));
  }
  if (t == 0) {
    int n = 0;
    for (int i = 0; i < gk; ++i) n += used[i];
    used[G] = n;
  }
  if (SMEM) stage(lab, staged, P);  // ends with a barrier
  else __syncthreads();
  const int g = used[G];
  if (g == 0) return;
  const Idx* plane = SMEM ? reinterpret_cast<const Idx*>(staged) : reinterpret_cast<const Idx*>(lab);

  // Members of each root, counted, then listed root after root.
  each_cell(plane, P, filter, sroot, g, [&](int, int s) {
    if (__ballot_sync(FULL, s >= 0)) a3fit::claim(cnt, s);
  });
  __syncthreads();
  if (warp == 0) {
    for (int i = lane; i < g; i += 32) off[i] = cnt[i];
    __syncwarp();
    a3fit::warp_scan_inplace(off, g, off + g);
  }
  __syncthreads();
  each_cell(plane, P, filter, sroot, g, [&](int p, int s) {
    if (!__ballot_sync(FULL, s >= 0)) return;
    const int pos = a3fit::claim(fill, s);
    if (s >= 0) members[off[s] + pos] = static_cast<Idx>(p);
  });
  __syncthreads();

  // A warp a lane: its root's members, its own size.
  for (int j = warp; j < g; j += nwarps) {
    int s = j;
    while (s > 0 && sroot[s - 1] == sroot[j]) --s;
    const a3fit::LaneFit f = a3fit::lane_chain(members + off[s], cnt[s], wc, ssize[j], ds, slack);
    if (lane == 0) {
      const size_t l = lane0 + slane[j];
      for (int c = 0; c < 4; ++c) {
        quads[l * 8 + 2 * c] = f.qx[c];
        quads[l * 8 + 2 * c + 1] = f.qy[c];
      }
      cents[l * 2] = f.cenx;
      cents[l * 2 + 1] = f.ceny;
      frac[l] = f.frac;
    }
  }
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
                 int kr1, int kr2, FitParams pr) {
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
    // The inner plane skips the twins of valid outer lanes: this block's
    // own writes, visible after the barrier that ends the first fit_plane.
    const a3fit::Twins& tw = plane ? twins : none;
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
// scratch a frame that a3_rank_roots (kernel 5, clusters of c blocks) and
// a3_fused_fit (kernel 7) take for an hc x wc grid (kr: the larger rank
// pool).
extern "C" int a3_rank_layout(int hc, int wc, int kr, int c, long long* out) {
  return a3fit::put_layout(rank_layout(hc, wc, kr, c), out);
}

extern "C" int a3_fused_layout(int hc, int wc, int kr, long long* out) {
  return a3fit::put_layout(fused_layout(hc, wc, kr), out);
}

// out[0], out[1]: bytes of shared memory and ints of device scratch a
// block of a3_fit_lanes (kernel 6) takes for an hc x wc grid.
extern "C" int a3_lanes_layout(int hc, int wc, long long* out) {
  return a3fit::put_layout(lanes_layout(hc, wc), out);
}

// labels (B,hc,wc) int32 -> roots_r, sizes_r (B,kr) int32 (fill 0 / -1)
// and n_roots (B,), on clusters of `cluster` blocks a frame (1 to 8).
// scratch: scratch_ints a frame, at least a3_rank_layout's.  Returns
// cudaGetLastError().
extern "C" int a3_rank_roots(const int* labels, int* roots_r, int* sizes_r, int* n_roots,
                             int* scratch, long long scratch_ints, int B, int hc, int wc, int kr,
                             int min_px, int cluster, cudaStream_t stream) {
  if (cluster < 1 || cluster > RANK_CLUSTER_MAX || B <= 0 || B > 65535 || kr <= 0)
    return cudaErrorInvalidValue;
  const a3fit::Layout l = rank_layout(hc, wc, kr, cluster);
  if (scratch_ints < l.scratch || l.smem > a3fit::SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = static_cast<cudaError_t>(launch_smem(rank_roots_kernel, static_cast<int>(l.smem)));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B);
  cfg.blockDim = dim3(RANK_THREADS);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int* band_scratch = l.in_smem ? nullptr : scratch;
  e = cudaLaunchKernelEx(&cfg, rank_roots_kernel, labels, roots_r, sizes_r, n_roots, band_scratch,
                         hc, wc, kr, min_px);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// labels (B,hc,wc) int32, roots / sizes (B,K) int32, use (B,K) bool ->
// quads (B,K,4,2), centroids (B,K,2), frac (B,K) float32; unused lanes get
// zeros.  group: lanes a block, 1 to 64; scratch: scratch_ints a block,
// at least a3_lanes_layout's.  Returns cudaGetLastError().
extern "C" int a3_fit_lanes(const int* labels, const int* roots, const int* sizes,
                            const uint8_t* use, float* quads, float* cents, float* frac,
                            int* scratch, long long scratch_ints, int B, int hc, int wc, int k,
                            int group, int ds, float slack, cudaStream_t stream) {
  if (k <= 0 || B <= 0) return cudaSuccess;
  const a3fit::Layout l = lanes_layout(hc, wc);
  if (B > 65535 || group < 1 || group > LANE_GROUP_MAX || scratch_ints < l.scratch)
    return cudaErrorInvalidValue;
  const dim3 grid((k + group - 1) / group, B);
  if (l.in_smem) {
    cudaError_t e = static_cast<cudaError_t>(launch_smem(fit_lanes_kernel<true>, l.smem));
    if (e != cudaSuccess) return e;
    fit_lanes_kernel<true><<<grid, LANE_THREADS, l.smem, stream>>>(
        labels, roots, sizes, use, quads, cents, frac, scratch, hc, wc, k, group, ds, slack);
  } else {
    fit_lanes_kernel<false><<<grid, LANE_THREADS, 0, stream>>>(
        labels, roots, sizes, use, quads, cents, frac, scratch, hc, wc, k, group, ds, slack);
  }
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
                            float min_containment, int min_px, int threads,
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
        labels1, labels2, fit1, fit2, scratch, hc, wc, k1, k2, kr1, kr2, pr);
  } else {
    fused_fit_kernel<false><<<B, threads, 0, stream>>>(
        labels1, labels2, fit1, fit2, scratch, hc, wc, k1, k2, kr1, kr2, pr);
  }
  return cudaGetLastError();
}
