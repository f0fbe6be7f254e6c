// IPPE pose solve: one thread a marker lane.
//
// Replaces no TPU kernel: the JAX package's pose (aruco3_tpu/pose.py
// solve_normalized_batch) is plain jnp arithmetic that XLA fuses into a
// few loops.  Eagerly in PyTorch the same solve (ops/ippe.py plain) is
// about 690 elementwise launches a call, and issuing them took the host
// longer than the card took to detect the frame: the pose set the pace of
// every caller that runs it outside a CUDA graph.  This kernel is the whole
// solve in one launch: the homography from the marker square, both
// rotation candidates, their least-squares translations and reprojection
// errors, and the swap that puts the lower error first.
//
// What bounds it on an H100: its one launch.  A lane reads 32 bytes (four
// corners) and writes 104 (two rotations, two translations, two errors):
// 5,632 lanes (128 1080p frames of 44 lanes) move 0.77 MB, 0.23 us at
// 3.35 TB/s, and its 662 float32 operations a lane take less still.
// Design: everything in registers, 128 threads a block.
//
// Bit-equal to the plain version on the card.  Each of its operations is
// repeated here one for one and in its order, each rounded to float32 (the
// library is built with -fmad=false, so no multiply and add contract):
// Python constants are float32 literals; 1.0 / x is an IEEE divide (torch's
// reciprocal, then * 1.0); torch.rsqrt is rsqrtf and torch.sqrt sqrtf;
// torch.clamp(min=) passes NaN through; sums run left to right over the
// four corners.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;

// torch.clamp(v, min=lo) on the card: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

struct Pose {
  float r[9];
  float t[3];
  float err;
};

// What both candidates share: the rotation to the origin's ray (rv), the
// 2x2 block of the candidate's columns (rt) and their third components
// (b0, b1), the marker's corners (ox, oy, oz) and the image points' sums.
struct Canonical {
  float rv[9];
  float rt00, rt01, rt10, rt11, b0, b1;
  float ox[4], oy[4], oz[4], u[4], v[4];
  float sa, sb, sab;
};

// solve_canonical_form's candidate(sign).
__device__ __forceinline__ Pose candidate(const Canonical& c, float sign) {
  const float c0x = c.rt00, c0y = c.rt10, c0z = sign * c.b0;
  const float c1x = c.rt01, c1y = c.rt11, c1z = sign * c.b1;
  const float c2x = c0y * c1z - c0z * c1y;
  const float c2y = c0z * c1x - c0x * c1z;
  const float c2z = c0x * c1y - c0y * c1x;
  Pose p;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float r0 = c.rv[3 * i], r1 = c.rv[3 * i + 1], r2 = c.rv[3 * i + 2];
    p.r[3 * i] = r0 * c0x + r1 * c0y + r2 * c0z;
    p.r[3 * i + 1] = r0 * c1x + r1 * c1y + r2 * c1z;
    p.r[3 * i + 2] = r0 * c2x + r1 * c2y + r2 * c2z;
  }
  float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
  float rpx[4], rpy[4], rpz[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rpx[k] = p.r[0] * c.ox[k] + p.r[1] * c.oy[k] + p.r[2] * c.oz[k];
    rpy[k] = p.r[3] * c.ox[k] + p.r[4] * c.oy[k] + p.r[5] * c.oz[k];
    rpz[k] = p.r[6] * c.ox[k] + p.r[7] * c.oy[k] + p.r[8] * c.oz[k];
    const float bxk = c.u[k] * rpz[k] - rpx[k];
    const float byk = c.v[k] * rpz[k] - rpy[k];
    r0 = r0 + bxk;
    r1 = r1 + byk;
    r2 = r2 - c.u[k] * bxk - c.v[k] * byk;
  }
  const float denz = 4.0f * c.sab - c.sa * c.sa - c.sb * c.sb;
  const float tz = (4.0f * r2 - c.sa * r0 - c.sb * r1) / denz;
  p.t[0] = (r0 - c.sa * tz) * 0.25f;
  p.t[1] = (r1 - c.sb * tz) * 0.25f;
  p.t[2] = tz;
  float err = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float z = clamp_min(rpz[k] + tz, 1e-5f);
    const float dx = (rpx[k] + p.t[0]) / z - c.u[k];
    const float dy = (rpy[k] + p.t[1]) / z - c.v[k];
    err = err + sqrtf(dx * dx + dy * dy);
  }
  p.err = err;
  return p;
}

__device__ __forceinline__ void store(const Pose& p, float* rot, float* tr, float* err) {
#pragma unroll
  for (int j = 0; j < 9; ++j) rot[j] = p.r[j];
#pragma unroll
  for (int j = 0; j < 3; ++j) tr[j] = p.t[j];
  *err = p.err;
}

// Lane i: pts[i] (4, 2) -> rot[i] (2, 3, 3), tr[i] (2, 3), err[i] (2).
// sizes (per-lane marker sizes) or, where it is null, the half-width hw and
// 1 / size (inv2) shared by every lane.
__global__ void __launch_bounds__(THREADS)
ippe_kernel(const float* __restrict__ pts, const float* __restrict__ sizes, float hw_all,
            float inv2_all, float* __restrict__ rot, float* __restrict__ tr,
            float* __restrict__ err, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  Canonical c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.u[k] = __ldg(pts + 8 * i + 2 * k);
    c.v[k] = __ldg(pts + 8 * i + 2 * k + 1);
  }
  float hw = hw_all, inv2 = inv2_all;
  if (sizes != nullptr) {
    hw = 0.5f * __ldg(sizes + i);
    inv2 = 1.0f / (2.0f * hw);
  }

  // compute_homography_from_marker_square.
  const float u0 = c.u[0], u1 = c.u[1], u2 = c.u[2], u3 = c.u[3];
  const float v0 = c.v[0], v1 = c.v[1], v2 = c.v[2], v3 = c.v[3];
  const float d1u = u1 - u2, d1v = v1 - v2;
  const float d2u = u3 - u2, d2v = v3 - v2;
  const float su = u0 - u1 + u2 - u3;
  const float sv = v0 - v1 + v2 - v3;
  float den = d1u * d2v - d2u * d1v;
  den = fabsf(den) < 1e-20f ? 1e-20f : den;
  const float g = (su * d2v - sv * d2u) / den;
  const float hh = (d1u * sv - d1v * su) / den;
  const float a11 = u1 - u0 + g * u1;
  const float a12 = u3 - u0 + hh * u3;
  const float a21 = v1 - v0 + g * v1;
  const float a22 = v3 - v0 + hh * v3;
  const float s = 1.0f / (0.5f * (g + hh) + 1.0f);
  const float H00 = (a11 * inv2) * s;
  const float H01 = (-a12 * inv2) * s;
  const float H02 = (0.5f * (a11 + a12) + u0) * s;
  const float H10 = (a21 * inv2) * s;
  const float H11 = (-a22 * inv2) * s;
  const float H12 = (0.5f * (a21 + a22) + v0) * s;
  const float H20 = (g * inv2) * s;
  const float H21 = (-hh * inv2) * s;

  // solve_canonical_form.
  const float j00 = H00 - H20 * H02;
  const float j01 = H01 - H21 * H02;
  const float j10 = H10 - H20 * H12;
  const float j11 = H11 - H21 * H12;
  const float tx = H02, ty = H12;
  const float inv_norm = rsqrtf(tx * tx + ty * ty + 1.0f);
  const float ax = tx * inv_norm, ay = ty * inv_norm, az = inv_norm;
  const bool degenerate = fabsf(1.0f + az) < 1e-6f;
  const float d = 1.0f / (degenerate ? 1.0f : 1.0f + az);
  const float ax2 = ax * ax, ay2 = ay * ay, axay = ax * ay;
  c.rv[0] = degenerate ? 1.0f : -ax2 * d + 1.0f;
  c.rv[1] = degenerate ? 0.0f : -axay * d;
  c.rv[2] = degenerate ? 0.0f : ax;
  c.rv[3] = degenerate ? 0.0f : -axay * d;
  c.rv[4] = degenerate ? 1.0f : -ay2 * d + 1.0f;
  c.rv[5] = degenerate ? 0.0f : ay;
  c.rv[6] = degenerate ? 0.0f : -ax;
  c.rv[7] = degenerate ? 0.0f : -ay;
  c.rv[8] = degenerate ? -1.0f : 1.0f - (ax2 + ay2) * d;

  const float b00 = c.rv[0] - tx * c.rv[6];
  const float b01 = c.rv[1] - tx * c.rv[7];
  const float b10 = c.rv[3] - ty * c.rv[6];
  const float b11 = c.rv[4] - ty * c.rv[7];
  const float idet = 1.0f / (b00 * b11 - b01 * b10);
  const float a00 = (b11 * j00 - b01 * j10) * idet;
  const float a01 = (b11 * j01 - b01 * j11) * idet;
  const float a10 = (b00 * j10 - b10 * j00) * idet;
  const float a11_ = (b00 * j11 - b10 * j01) * idet;

  const float ata00 = a00 * a00 + a01 * a01;
  const float ata01 = a00 * a10 + a01 * a11_;
  const float ata11 = a10 * a10 + a11_ * a11_;
  const float dd = ata00 - ata11;
  const float gamma = sqrtf(0.5f * (ata00 + ata11 + sqrtf(dd * dd + 4.0f * (ata01 * ata01))));
  const float inv_g = 1.0f / gamma;
  c.rt00 = a00 * inv_g;
  c.rt01 = a01 * inv_g;
  c.rt10 = a10 * inv_g;
  c.rt11 = a11_ * inv_g;

  c.b0 = sqrtf(clamp_min(1.0f - c.rt00 * c.rt00 - c.rt10 * c.rt10, 0.0f));
  const float b1 = sqrtf(clamp_min(1.0f - c.rt01 * c.rt01 - c.rt11 * c.rt11, 0.0f));
  const float sp = -c.rt00 * c.rt01 - c.rt10 * c.rt11;
  c.b1 = sp < 0.0f ? -b1 : b1;

  // make_marker_square: clockwise from top-left at z = 0.
  const float ox[4] = {-hw, hw, hw, -hw}, oy[4] = {hw, hw, -hw, -hw};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.ox[k] = ox[k];
    c.oy[k] = oy[k];
    c.oz[k] = 0.0f;
  }
  c.sa = -(u0 + u1 + u2 + u3);
  c.sb = -(v0 + v1 + v2 + v3);
  float sab = u0 * u0 + v0 * v0;
#pragma unroll
  for (int k = 1; k < 4; ++k) sab = sab + (c.u[k] * c.u[k] + c.v[k] * c.v[k]);
  c.sab = sab;

  const Pose p1 = candidate(c, 1.0f);
  const Pose p2 = candidate(c, -1.0f);
  // The lower error first; a NaN error keeps the order.
  const bool swap = p2.err < p1.err;
  store(swap ? p2 : p1, rot + 18 * i, tr + 6 * i, err + 2 * i);
  store(swap ? p1 : p2, rot + 18 * i + 9, tr + 6 * i + 3, err + 2 * i + 1);
}

}  // namespace

// pts (N, 4, 2) f32 -> rot (N, 2, 3, 3), tr (N, 2, 3), err (N, 2) f32, the
// lower-error pose first.  sizes: N per-lane marker sizes, or null for one
// size given as its half-width hw and its float32 reciprocal inv2.
extern "C" int a3_ippe(const float* pts, const float* sizes, float hw, float inv2, float* rot,
                       float* tr, float* err, long long N, cudaStream_t stream) {
  if (N < 0) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const long long blocks = (N + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ippe_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(pts, sizes, hw, inv2, rot,
                                                                     tr, err, N);
  return cudaGetLastError();
}
