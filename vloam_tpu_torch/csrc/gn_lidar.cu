// Fused Gauss-Newton solve for the two lidar factor types: all inner
// iterations of one solve in one launch.
//
// Replaces: vloam_tpu/ops/pallas_gn.py, _gn_kernel (:138-205), launched by
// _gn_call (:348) for solve_pose_gn_lidar.
//
// Per iteration:
//   * edge residual r = lp x c + k, with lp = R p + t, c = (a-b)/|a-b| and
//     k = (a x b)/|a-b| precomputed in torch (pallas_gn.py:394-397);
//     plane residual r = n . lp + d;
//   * analytic Jacobians under q <- exp(dtheta) (x) q, t <- t + dt;
//   * Huber block weights w^2 = valid * min(1, delta / |r|), as
//     delta * rsqrt(max(|r|^2, 1e-20)) outside the delta ball;
//   * the 21 upper-triangle sums of J^T W J and the 6 sums of J^T W r;
//   * damping A_ii += lambda A_ii + 1e-10, an unrolled 6x6 Cholesky with the
//     pivot floor sqrt(max(s, 1e-12)), and the normalised quaternion update
//     with the theta < 1e-8 small-angle branch.
//
// What bounds it on Hopper: latency, not bandwidth or arithmetic.  The data
// (at most 4096 edges x 10 floats + 8192 planes x 8 floats, ~420 KB) is read
// once per iteration and stays in L2; the work per iteration is ~100 flops
// per residual, a few microseconds of one SM.  What costs is the serial
// chain: iteration i+1 needs the pose from iteration i.  Launching one
// kernel per step (the plain PyTorch version issues dozens of small kernels
// per iteration) pays launch latency every time; here the whole loop is one
// block, and the only serial parts are two block-wide barriers and the
// 6x6 solve by one thread.
//
// Design: one block of kThreads threads.  Each thread strides over the
// edges and planes and accumulates its 27 partial sums in registers; a warp
// shuffle tree and then shared memory combine them; thread 0 solves and
// publishes the new pose through shared memory.  Inputs are plain
// structure-of-arrays rows (no TPU-style (8, B/8) packing).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;  // 21 of J^T J (upper triangle) + 6 of J^T r

__device__ __forceinline__ void accumulate(float* acc, const float* col, int rdim,
                                           const float* r, float sw) {
  // col: 6 Jacobian columns of rdim components (col[m * 3 + d]); r: rdim
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

__device__ void chol_solve6(float A[6][6], const float b[6], float x[6]) {
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

__global__ void __launch_bounds__(kThreads)
gn_lidar_kernel(const float* __restrict__ pose0, const float* __restrict__ ed, int be,
                const float* __restrict__ pl, int bs, int iters, float huber_delta,
                float lm_lambda, float* __restrict__ pose_out) {
  __shared__ float pose_s[7];
  __shared__ float partial[kWarps][kSums];
  __shared__ float total[kSums];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid < 7) pose_s[tid] = pose0[tid];
  __syncthreads();

  const float delta2 = huber_delta * huber_delta;

  for (int it = 0; it < iters; ++it) {
    const float x = pose_s[0], y = pose_s[1], z = pose_s[2], w = pose_s[3];
    const float t[3] = {pose_s[4], pose_s[5], pose_s[6]};
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, xz = x * z, yz = y * z;
    const float wx = w * x, wy = w * y, wz = w * z;
    const float R[3][3] = {
        {1.f - 2.f * (yy + zz), 2.f * (xy - wz), 2.f * (xz + wy)},
        {2.f * (xy + wz), 1.f - 2.f * (xx + zz), 2.f * (yz - wx)},
        {2.f * (xz - wy), 2.f * (yz + wx), 1.f - 2.f * (xx + yy)},
    };

    float acc[kSums];
#pragma unroll
    for (int s = 0; s < kSums; ++s) acc[s] = 0.f;

    // ---- edge factor: r = lp x c + k ----------------------------------------
    for (int i = tid; i < be; i += kThreads) {
      const float p[3] = {ed[0 * be + i], ed[1 * be + i], ed[2 * be + i]};
      const float c[3] = {ed[3 * be + i], ed[4 * be + i], ed[5 * be + i]};
      const float k[3] = {ed[6 * be + i], ed[7 * be + i], ed[8 * be + i]};
      const float v = ed[9 * be + i];
      float rp[3], lp[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        rp[a] = R[a][0] * p[0] + R[a][1] * p[1] + R[a][2] * p[2];
        lp[a] = rp[a] + t[a];
      }
      const float r[3] = {lp[1] * c[2] - lp[2] * c[1] + k[0],
                          lp[2] * c[0] - lp[0] * c[2] + k[1],
                          lp[0] * c[1] - lp[1] * c[0] + k[2]};
      // rotation column m: (e_m x rp) x c; translation column m: e_m x c
      const float col[18] = {
          -(c[1] * rp[1] + c[2] * rp[2]), c[0] * rp[1], c[0] * rp[2],
          c[1] * rp[0], -(c[0] * rp[0] + c[2] * rp[2]), c[1] * rp[2],
          c[2] * rp[0], c[2] * rp[1], -(c[0] * rp[0] + c[1] * rp[1]),
          0.f, -c[2], c[1],
          c[2], 0.f, -c[0],
          -c[1], c[0], 0.f,
      };
      const float sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
      const float w2 = v * (sq <= delta2 ? 1.f : huber_delta * rsqrtf(fmaxf(sq, 1e-20f)));
      accumulate(acc, col, 3, r, sqrtf(w2));
    }

    // ---- plane factor: r = n . lp + d ---------------------------------------
    for (int i = tid; i < bs; i += kThreads) {
      const float p[3] = {pl[0 * bs + i], pl[1 * bs + i], pl[2 * bs + i]};
      const float n[3] = {pl[3 * bs + i], pl[4 * bs + i], pl[5 * bs + i]};
      const float d = pl[6 * bs + i];
      const float v = pl[7 * bs + i];
      float rp[3], lp[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        rp[a] = R[a][0] * p[0] + R[a][1] * p[1] + R[a][2] * p[2];
        lp[a] = rp[a] + t[a];
      }
      const float r[1] = {n[0] * lp[0] + n[1] * lp[1] + n[2] * lp[2] + d};
      // rotation column m: e_m . (rp x n); translation column m: n_m
      const float col[18] = {
          rp[1] * n[2] - rp[2] * n[1], 0.f, 0.f,
          rp[2] * n[0] - rp[0] * n[2], 0.f, 0.f,
          rp[0] * n[1] - rp[1] * n[0], 0.f, 0.f,
          n[0], 0.f, 0.f,
          n[1], 0.f, 0.f,
          n[2], 0.f, 0.f,
      };
      const float sq = r[0] * r[0];
      const float w2 = v * (sq <= delta2 ? 1.f : huber_delta * rsqrtf(fmaxf(sq, 1e-20f)));
      accumulate(acc, col, 1, r, sqrtf(w2));
    }

    // ---- block reduction: warp shuffles, then shared memory -----------------
#pragma unroll
    for (int s = 0; s < kSums; ++s) {
      float v = acc[s];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) partial[warp][s] = v;
    }
    __syncthreads();
    if (tid < kSums) {
      float v = 0.f;
      for (int wp = 0; wp < kWarps; ++wp) v += partial[wp][tid];
      total[tid] = v;
    }
    __syncthreads();

    // ---- damped 6x6 solve + pose update (one thread) ------------------------
    if (tid == 0) {
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

      const float theta = sqrtf(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]);
      const bool small = theta < 1e-8f;
      const float kk = small ? 0.5f : sinf(0.5f * theta) / fmaxf(theta, 1e-12f);
      const float qx = dx[0] * kk, qy = dx[1] * kk, qz = dx[2] * kk;
      const float qw = small ? 1.f : cosf(0.5f * theta);
      const float nx = qw * x + qx * w + qy * z - qz * y;
      const float ny = qw * y - qx * z + qy * w + qz * x;
      const float nz = qw * z + qx * y - qy * x + qz * w;
      const float nw = qw * w - qx * x - qy * y - qz * z;
      const float inv = 1.f / sqrtf(nx * nx + ny * ny + nz * nz + nw * nw);
      pose_s[0] = nx * inv;
      pose_s[1] = ny * inv;
      pose_s[2] = nz * inv;
      pose_s[3] = nw * inv;
      pose_s[4] = t[0] + dx[3];
      pose_s[5] = t[1] + dx[4];
      pose_s[6] = t[2] + dx[5];
    }
    __syncthreads();
  }
  if (tid < 7) pose_out[tid] = pose_s[tid];
}

}  // namespace

// ed: (10, be) rows p.xyz, c.xyz, k.xyz, valid; pl: (8, bs) rows p.xyz,
// n.xyz, d, valid; pose0/pose_out: (7,) [qx qy qz qw tx ty tz].
// Returns cudaGetLastError() after the launch.
extern "C" int vloam_gn_lidar(const float* pose0, const float* ed, int be, const float* pl,
                              int bs, int iters, float huber_delta, float lm_lambda,
                              float* pose_out, void* stream) {
  gn_lidar_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pose0, ed, be, pl, bs, iters, huber_delta, lm_lambda, pose_out);
  return static_cast<int>(cudaGetLastError());
}
