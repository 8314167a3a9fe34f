// Pieces shared by the fused Gauss-Newton kernels gn_lidar.cu (B3) and
// gn_vo.cu (B4), one copy each, mirroring vloam_tpu/ops/pallas_gn.py:
//   * rot_rows      the 3x3 rotation of a unit xyzw quaternion (_rot_rows, :102-112);
//   * accumulate    the weighted J^T J (upper 21) and J^T r (6) sums of one
//                   residual block (_accumulate, :115-135);
//   * block_reduce  the 27 sums over the block: warp shuffles, then shared memory;
//   * solve_update  damping A_ii += lambda A_ii + 1e-10, the unrolled 6x6
//                   Cholesky with pivot floor sqrt(max(s, 1e-12)) (_chol_solve6,
//                   :54-81) and the normalised quaternion update with the
//                   theta < 1e-8 small-angle branch (_quat_update, :84-99).

#pragma once

#include <cuda_runtime.h>

namespace vloam_gn {

constexpr int kSums = 27;  // 21 of J^T J (upper triangle) + 6 of J^T r

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

// Huber block weight sqrt(valid * rho'(s)): 1 inside the delta ball,
// delta / |r| outside, as delta * rsqrt(max(|r|^2, 1e-20)).
static __device__ inline float huber_sw(float sq, float valid, float delta) {
  const float w2 = valid * (sq <= delta * delta ? 1.f : delta * rsqrtf(fmaxf(sq, 1e-20f)));
  return sqrtf(w2);
}

// col: 6 Jacobian columns of rdim components (col[m * 3 + d]); r: rdim values.
static __device__ inline void accumulate(float* acc, const float* col, int rdim,
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

// Sums acc[kSums] over the block into total[kSums].  partial holds
// kWarps * kSums floats of shared memory.  Ends with a barrier.
template <int kThreads>
static __device__ inline void block_reduce(const float* acc, float* partial, float* total) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int s = 0; s < kSums; ++s) {
    float v = acc[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) partial[warp * kSums + s] = v;
  }
  __syncthreads();
  if (tid < kSums) {
    float v = 0.f;
    for (int wp = 0; wp < kWarps; ++wp) v += partial[wp * kSums + tid];
    total[tid] = v;
  }
  __syncthreads();
}

static __device__ inline void chol_solve6(float A[6][6], const float b[6], float x[6]) {
  float L[6][6];
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    L[j][j] = sqrtf(fmaxf(s, 1e-12f));
    const float inv_d = 1.f / L[j][j];
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i][j];
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t * inv_d;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// q <- normalize(exp(dtheta) (x) q), xyzw Hamilton product.
static __device__ inline void quat_update(float q[4], const float dtheta[3]) {
  const float theta =
      sqrtf(dtheta[0] * dtheta[0] + dtheta[1] * dtheta[1] + dtheta[2] * dtheta[2]);
  const bool small = theta < 1e-8f;
  const float kk = small ? 0.5f : sinf(0.5f * theta) / fmaxf(theta, 1e-12f);
  const float dx = dtheta[0] * kk, dy = dtheta[1] * kk, dz = dtheta[2] * kk;
  const float dw = small ? 1.f : cosf(0.5f * theta);
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float nx = dw * x + dx * w + dy * z - dz * y;
  const float ny = dw * y - dx * z + dy * w + dz * x;
  const float nz = dw * z + dx * y - dy * x + dz * w;
  const float nw = dw * w - dx * x - dy * y - dz * z;
  const float inv = 1.f / sqrtf(nx * nx + ny * ny + nz * nz + nw * nw);
  q[0] = nx * inv;
  q[1] = ny * inv;
  q[2] = nz * inv;
  q[3] = nw * inv;
}

// One damped GN step from the reduced sums; pose = [qx qy qz qw tx ty tz]
// is updated in place.  Run by one thread.
static __device__ inline void solve_update(const float* total, float lm_lambda, float* pose) {
  float A[6][6];
  int s = 0;
  for (int i = 0; i < 6; ++i) {
    for (int j = i; j < 6; ++j) {
      A[i][j] = total[s];
      A[j][i] = total[s];
      ++s;
    }
  }
  float b[6];
  for (int i = 0; i < 6; ++i) b[i] = -total[21 + i];
  for (int i = 0; i < 6; ++i) A[i][i] = A[i][i] + lm_lambda * A[i][i] + 1e-10f;
  float dx[6];
  chol_solve6(A, b, dx);
  quat_update(pose, dx);
  pose[4] += dx[3];
  pose[5] += dx[4];
  pose[6] += dx[5];
}

}  // namespace vloam_gn
