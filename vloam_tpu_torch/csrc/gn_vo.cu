// Fused Gauss-Newton solve for visual odometry: all iterations of one VO
// solve in one launch.
//
// Replaces: vloam_tpu/ops/pallas_gn.py, _vo_kernel (:208-281), launched by
// _vo_call (:287) for solve_pose_gn_vo (visual_odometry.py:204).
//
// Per iteration, each match contributes EITHER
//   * the 3D-2D reprojection residual r = [Y_x - Y_z xb1, Y_y - Y_z yb1],
//     Y = R X0 + t, weighted by has_depth (pallas_gn.py:242-256), OR
//   * the 2D-2D epipolar residual r = t . ((R X0b) x X1b), X0b = (xb0, 1),
//     X1b = (xb1, 1), weighted by no_depth (:258-271),
// with the Jacobian columns of pallas_gn.py:247-254 and :264-269 under
// q <- exp(dtheta) (x) q, t <- t + dt; Huber block weights, the 21 + 6 sums,
// the damped 6x6 Cholesky and the quaternion update as in gn_common.cuh.
//
// What bounds it on Hopper: latency.  The data is M = max_features = 1024
// matches x 9 floats (36 KB), read once per iteration from L2; the work is
// ~150 flops per match per iteration, microseconds of one SM.  What costs
// is the chain of 10 dependent iterations.  The plain PyTorch version pays
// dozens of small launches per iteration; here the loop is one block, and
// the serial part per iteration is two block barriers and the 6x6 solve by
// one thread.
//
// Design: one block of kThreads threads, as gn_lidar.cu.  Each thread
// strides over the matches and accumulates both residual blocks' 27 sums
// in registers; warp shuffles then shared memory reduce them; thread 0
// solves and publishes the pose through shared memory.  Input is one SoA
// (9, M) array, with no padding (the TPU's (8, M/8) packing to a multiple
// of 1024 is not carried over).

#include <cuda_runtime.h>

#include "gn_common.cuh"

namespace {

using vloam_gn::kSums;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
gn_vo_kernel(const float* __restrict__ pose0, const float* __restrict__ in, int m, int iters,
             float huber_delta, float lm_lambda, float* __restrict__ pose_out) {
  __shared__ float pose_s[7];
  __shared__ float partial[kWarps * kSums];
  __shared__ float total[kSums];
  const int tid = threadIdx.x;
  if (tid < 7) pose_s[tid] = pose0[tid];
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    float R[3][3];
    vloam_gn::rot_rows(pose_s[0], pose_s[1], pose_s[2], pose_s[3], R);
    const float t[3] = {pose_s[4], pose_s[5], pose_s[6]};

    float acc[kSums];
#pragma unroll
    for (int s = 0; s < kSums; ++s) acc[s] = 0.f;

    for (int i = tid; i < m; i += kThreads) {
      const float X0[3] = {in[0 * m + i], in[1 * m + i], in[2 * m + i]};
      const float xb0[2] = {in[3 * m + i], in[4 * m + i]};
      const float xb1[2] = {in[5 * m + i], in[6 * m + i]};
      const float hd = in[7 * m + i];
      const float nd = in[8 * m + i];

      // ---- 3D-2D reprojection: r = [Yx - Yz xb1, Yy - Yz yb1] --------------
      float u[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) u[a] = R[a][0] * X0[0] + R[a][1] * X0[1] + R[a][2] * X0[2];
      const float Y[3] = {u[0] + t[0], u[1] + t[1], u[2] + t[2]};
      const float r2[2] = {Y[0] - Y[2] * xb1[0], Y[1] - Y[2] * xb1[1]};
      // rotation column m: dr/dY (e_m x u), dr/dY rows (1,0,-xb), (0,1,-yb);
      // translation column m: dr/dY e_m
      const float col2[18] = {
          -u[1] * xb1[0], -u[2] - u[1] * xb1[1], 0.f,
          u[2] + u[0] * xb1[0], u[0] * xb1[1], 0.f,
          -u[1], u[0], 0.f,
          1.f, 0.f, 0.f,
          0.f, 1.f, 0.f,
          -xb1[0], -xb1[1], 0.f,
      };
      vloam_gn::accumulate(acc, col2, 2, r2,
                           vloam_gn::huber_sw(r2[0] * r2[0] + r2[1] * r2[1], hd, huber_delta));

      // ---- 2D-2D epipolar: r = X1b . (t x (R X0b)) = t . (v x X1b) ----------
      const float X1b[3] = {xb1[0], xb1[1], 1.f};
      float v[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) v[a] = R[a][0] * xb0[0] + R[a][1] * xb0[1] + R[a][2];
      const float c[3] = {v[1] * X1b[2] - v[2] * X1b[1],
                          v[2] * X1b[0] - v[0] * X1b[2],
                          v[0] * X1b[1] - v[1] * X1b[0]};
      const float r1[1] = {t[0] * c[0] + t[1] * c[1] + t[2] * c[2]};
      const float tv = t[0] * v[0] + t[1] * v[1] + t[2] * v[2];
      const float xv = X1b[0] * v[0] + X1b[1] * v[1] + X1b[2] * v[2];
      const float col1[18] = {
          X1b[0] * tv - t[0] * xv, 0.f, 0.f,
          X1b[1] * tv - t[1] * xv, 0.f, 0.f,
          X1b[2] * tv - t[2] * xv, 0.f, 0.f,
          c[0], 0.f, 0.f,
          c[1], 0.f, 0.f,
          c[2], 0.f, 0.f,
      };
      vloam_gn::accumulate(acc, col1, 1, r1, vloam_gn::huber_sw(r1[0] * r1[0], nd, huber_delta));
    }

    vloam_gn::block_reduce<kThreads>(acc, partial, total);
    if (tid == 0) vloam_gn::solve_update(total, lm_lambda, pose_s);
    __syncthreads();
  }
  if (tid < 7) pose_out[tid] = pose_s[tid];
}

}  // namespace

// in: (9, m) rows X0.xyz, xb0.xy, xb1.xy, has_depth, no_depth (as 0/1 floats);
// pose0/pose_out: (7,) [qx qy qz qw tx ty tz].
// Returns cudaGetLastError() after the launch.
extern "C" int vloam_gn_vo(const float* pose0, const float* in, int m, int iters,
                           float huber_delta, float lm_lambda, float* pose_out, void* stream) {
  gn_vo_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pose0, in, m, iters, huber_delta, lm_lambda, pose_out);
  return static_cast<int>(cudaGetLastError());
}
