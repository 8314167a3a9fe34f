// Pieces shared by the fused Gauss-Newton kernels gn_lidar.cu (B3) and
// gn_vo.cu (B4), one copy each, mirroring vloam_tpu/ops/pallas_gn.py:
//   * rot_rows      the 3x3 rotation of a unit xyzw quaternion (_rot_rows, :102-112);
//   * accumulate    the weighted J^T J (upper 21) and J^T r (6) sums of one
//                   residual block (_accumulate, :115-135), into 32 registers
//                   (27 sums, 5 zeros: one per lane of a warp);
//   * warp_reduce_scatter  the 27 sums over a warp in 31 shuffles, lane l
//                   ending with sum l;
//   * block_sum     lane l's sum over the block's warps, in every warp;
//   * block_scan    the exclusive prefix of two per-thread counts (the
//                   compaction of valid rows at load);
//   * solve_update  damping A_ii += lambda A_ii + 1e-10, the unrolled 6x6
//                   Cholesky with pivot floor max(s, 1e-12) under the square
//                   root (_chol_solve6, :54-81; one rsqrt a pivot, multiplies
//                   after it) and the normalised quaternion update with the
//                   theta < 1e-8 small-angle branch (_quat_update, :84-99;
//                   below theta = 0.1 by series, see quat_update).
//                   Every thread runs it on the same sums and holds the same
//                   pose in registers, so no barrier publishes it.
//
// Inputs are read where the caller keeps them: a row of a (B, w) float32
// array is w floats at row * stride, a (B,) array (values, bool masks read as
// bytes) one element at row * stride.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace vloam_gn {

constexpr int kSums = 27;  // 21 of J^T J (upper triangle) + 6 of J^T r
constexpr int kLanes = 32;

static __device__ inline void load3(const float* __restrict__ a, long long stride, int i,
                                    float v[3]) {
  const float* row = a + i * stride;
  v[0] = __ldg(row);
  v[1] = __ldg(row + 1);
  v[2] = __ldg(row + 2);
}

static __device__ inline float load1(const float* __restrict__ a, long long stride, int i) {
  return __ldg(a + i * stride);
}

static __device__ inline bool load_mask(const unsigned char* __restrict__ m, long long stride,
                                        int i) {
  return __ldg(m + i * stride) != 0;
}

// 0 for a finite value, NaN for inf or NaN: a dropped row (mask 0) adds
// 0 * value to the sums, as the plain version's multiply by the mask does.
static __device__ inline float poison(float x) { return 0.f * x; }

static __device__ inline void rot_rows(float x, float y, float z, float w, float R[3][3]) {
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0][0] = 1.f - 2.f * (yy + zz);
  R[0][1] = 2.f * (xy - wz);
  R[0][2] = 2.f * (xz + wy);
  R[1][0] = 2.f * (xy + wz);
  R[1][1] = 1.f - 2.f * (xx + zz);
  R[1][2] = 2.f * (yz - wx);
  R[2][0] = 2.f * (xz - wy);
  R[2][1] = 2.f * (yz + wx);
  R[2][2] = 1.f - 2.f * (xx + yy);
}

static __device__ inline void rotate(const float R[3][3], const float p[3], float out[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) out[a] = R[a][0] * p[0] + R[a][1] * p[1] + R[a][2] * p[2];
}

// Cycles of one thread per phase of an iteration, summed over the launch's
// iterations: compiled in only under -DVLOAM_GN_PHASES (tools/gn_check.py
// --phases builds that library beside the shipped one); otherwise the marks
// are empty.
constexpr int kPhases = 6;
#ifdef VLOAM_GN_PHASES
struct PhaseClock {
  long long last = 0, sum[kPhases] = {};
  __device__ void start() { last = clock64(); }
  __device__ void mark(int k) {
    const long long now = clock64();
    sum[k] += now - last;
    last = now;
  }
};
#else
struct PhaseClock {
  __device__ void start() {}
  __device__ void mark(int) {}
};
#endif

// Huber block weight sqrt(valid * rho'(s)): 1 inside the delta ball,
// delta / |r| outside, as delta * rsqrt(max(|r|^2, 1e-20)).
static __device__ inline float huber_sw(float sq, float valid, float delta) {
  const float w2 = valid * (sq <= delta * delta ? 1.f : delta * rsqrtf(fmaxf(sq, 1e-20f)));
  return sqrtf(w2);
}

// col: 6 Jacobian columns of rdim components (col[m * 3 + d]); r: rdim values.
static __device__ inline void accumulate(float (&acc)[kLanes], const float* col, int rdim,
                                         const float* r, float sw) {
  float wc[6][3];
  float wr[3];
#pragma unroll
  for (int m = 0; m < 6; ++m) {
#pragma unroll
    for (int d = 0; d < 3; ++d) wc[m][d] = d < rdim ? sw * col[m * 3 + d] : 0.f;
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) wr[d] = d < rdim ? sw * r[d] : 0.f;
  int s = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      acc[s++] += wc[i][0] * wc[j][0] + wc[i][1] * wc[j][1] + wc[i][2] * wc[j][2];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    acc[21 + i] += wc[i][0] * wr[0] + wc[i][1] * wr[1] + wc[i][2] * wr[2];
  }
}

// One halving step of warp_reduce_scatter: lanes with bit H set keep the
// upper H of their values and send the lower H to lane ^ H, which does the
// opposite.  H is a template argument so that every index is a constant:
// a run-time index would move the 32 values to local memory.
template <int H>
static __device__ inline void reduce_step(float (&v)[kLanes], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = upper ? v[j] : v[j + H];
    const float keep = upper ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// The transposed warp reduction: five halving steps (16 + 8 + 4 + 2 + 1 =
// 31 shuffles).  On return lane l holds the warp's sum of v[l]; v is
// clobbered.
static __device__ inline float warp_reduce_scatter(float (&v)[kLanes]) {
  const int lane = threadIdx.x & 31;
  reduce_step<16>(v, lane);
  reduce_step<8>(v, lane);
  reduce_step<4>(v, lane);
  reduce_step<2>(v, lane);
  reduce_step<1>(v, lane);
  return v[0];
}

// Exclusive prefix over the block of the per-thread counts (a, b); the
// block's totals go to *total.  scratch: kThreads / 32 int2 of shared memory.
// One barrier; scratch may be reused only after another.
template <int kThreads>
static __device__ inline int2 block_scan(int2 v, int2* scratch, int2* total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int2 x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ya = __shfl_up_sync(0xffffffffu, x.x, off);
    const int yb = __shfl_up_sync(0xffffffffu, x.y, off);
    if (lane >= off) {
      x.x += ya;
      x.y += yb;
    }
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int2 base = make_int2(0, 0), tot = make_int2(0, 0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int2 s = scratch[w];
    if (w < warp) {
      base.x += s.x;
      base.y += s.y;
    }
    tot.x += s.x;
    tot.y += s.y;
  }
  *total = tot;
  return make_int2(base.x + x.x - v.x, base.y + x.y - v.y);
}

// Lane l's value summed over the block's warps, in warp order, returned to
// lane l of every warp.  part: kWarps * 32 floats of shared memory.  One
// barrier; part may be written again only after another barrier (or from a
// second buffer).
template <int kThreads>
static __device__ inline float block_sum(float v, float* part) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  part[(threadIdx.x >> 5) * kLanes + lane] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += part[w * kLanes + lane];
  return s;
}

// out[s] = lane s's v, in every lane.
static __device__ inline void broadcast_sums(float v, float out[kSums]) {
#pragma unroll
  for (int s = 0; s < kSums; ++s) out[s] = __shfl_sync(0xffffffffu, v, s);
}

// Solves (A) x = b by Cholesky.  inv[j] = 1 / L_jj = rsqrt(max(s_j, 1e-12)),
// so the reference's divisions by L_jj become multiplies.
static __device__ inline void chol_solve6(const float A[6][6], const float b[6], float x[6]) {
  float L[6][6];
  float inv[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    inv[j] = rsqrtf(fmaxf(s, 1e-12f));
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t * inv[j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

// q <- normalize(exp(dtheta) (x) q), xyzw Hamilton product.  With
// theta = |dtheta|, the update quaternion is (dtheta sin(theta/2)/theta,
// cos(theta/2)).  Below theta = 0.1 both come from their Taylor series in
// theta^2 (the next terms are under 1e-11: exact to float32), which spares
// the chain a square root, sincosf and a division; theta < 1e-8 gives 0.5
// and 1 exactly, the reference's small-angle branch.
static __device__ inline void quat_update(float q[4], const float dtheta[3]) {
  const float th2 = dtheta[0] * dtheta[0] + dtheta[1] * dtheta[1] + dtheta[2] * dtheta[2];
  float kk, dw;
  if (th2 < 0.01f) {
    kk = 0.5f - th2 * (1.f / 48.f) * (1.f - th2 * (1.f / 80.f));
    dw = 1.f - th2 * 0.125f * (1.f - th2 * (1.f / 48.f) * (1.f - th2 * (1.f / 120.f)));
  } else {
    const float theta = sqrtf(th2);
    float sh;
    sincosf(0.5f * theta, &sh, &dw);
    kk = sh / theta;
  }
  const float dx = dtheta[0] * kk, dy = dtheta[1] * kk, dz = dtheta[2] * kk;
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float nx = dw * x + dx * w + dy * z - dz * y;
  const float ny = dw * y - dx * z + dy * w + dz * x;
  const float nz = dw * z + dx * y - dy * x + dz * w;
  const float nw = dw * w - dx * x - dy * y - dz * z;
  const float inv = rsqrtf(nx * nx + ny * ny + nz * nz + nw * nw);
  q[0] = nx * inv;
  q[1] = ny * inv;
  q[2] = nz * inv;
  q[3] = nw * inv;
}

// One damped GN step from the reduced sums; pose = [qx qy qz qw tx ty tz]
// is updated in place.
static __device__ inline void solve_update(const float total[kSums], float lm_lambda,
                                           float pose[7]) {
  float A[6][6];
  int s = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[i][j] = total[s];
      A[j][i] = total[s];
      ++s;
    }
  }
  float b[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) b[i] = -total[21 + i];
#pragma unroll
  for (int i = 0; i < 6; ++i) A[i][i] = A[i][i] + lm_lambda * A[i][i] + 1e-10f;
  float dx[6];
  chol_solve6(A, b, dx);
  quat_update(pose, dx);
  pose[4] += dx[3];
  pose[5] += dx[4];
  pose[6] += dx[5];
}

}  // namespace vloam_gn
