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
// structure-of-arrays rows (no TPU-style (8, B/8) packing).  The rotation,
// Huber weight, sums, reduction and 6x6 solve live in gn_common.cuh, shared
// with the VO solve (gn_vo.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_common.cuh"

namespace {

using vloam_gn::kSums;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
gn_lidar_kernel(const float* __restrict__ pose0, const float* __restrict__ ed, int be,
                const float* __restrict__ pl, int bs, int iters, float huber_delta,
                float lm_lambda, float* __restrict__ pose_out) {
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
      vloam_gn::accumulate(acc, col, 3, r, vloam_gn::huber_sw(sq, v, huber_delta));
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
      vloam_gn::accumulate(acc, col, 1, r, vloam_gn::huber_sw(r[0] * r[0], v, huber_delta));
    }

    // ---- block reduction, then the damped 6x6 solve + pose update -----------
    vloam_gn::block_reduce<kThreads>(acc, partial, total);
    if (tid == 0) vloam_gn::solve_update(total, lm_lambda, pose_s);
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
