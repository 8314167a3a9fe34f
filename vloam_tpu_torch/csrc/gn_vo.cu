// Fused Gauss-Newton solve for visual odometry: all iterations of one VO
// solve in one launch.
//
// Replaces: vloam_tpu/ops/pallas_gn.py, _vo_kernel (:208-281), launched by
// _vo_call (:287) for solve_pose_gn_vo (visual_odometry.py:204).
//
// Per iteration, each match contributes the 3D-2D reprojection residual
// r = [Y_x - Y_z xb1, Y_y - Y_z yb1], Y = R X0 + t, where has_depth
// (pallas_gn.py:242-256), and the 2D-2D epipolar residual
// r = t . ((R X0b) x X1b), X0b = (xb0, 1), X1b = (xb1, 1), where no_depth
// (:258-271), with the Jacobian columns of pallas_gn.py:247-254 and :264-269
// under q <- exp(dtheta) (x) q, t <- t + dt; Huber block weights, the 21 + 6
// sums, the damped 6x6 Cholesky and the quaternion update as in gn_common.cuh.
//
// What bounds it on Hopper: latency.  The data is M = max_features = 1024
// matches of 30 bytes, read once; the work is ~150 flops per live match and
// iteration.  What costs is the chain of 10 dependent iterations, each a
// pass over the matches, a reduction of 27 sums and a 6x6 solve.
//
// Design: one block of kThreads threads (1024 matches need no cluster).
// At load thread tid reads matches tid, tid + kThreads, ... where the caller
// keeps them (strided views, bool masks as bytes); a block scan gives it a
// place in one shared-memory list for the matches with depth (X0, xb1) and
// one for those without (xb0, xb1), so that each iteration walks only the
// live matches (276 of 1024 at frame 15 of the chip course) and computes
// only the residual each one has.  A dropped match adds 0 * its values to
// the sums, as the plain version's multiply by the mask does.  Matches past
// the staging budget (never at M = 1024) are read from global memory on
// every iteration instead.  An iteration: the rows into 32 registers, the
// 31-shuffle warp reduction, the warps' partials through shared memory (two
// buffers: the iteration's one barrier), the 27 sums broadcast by shuffles,
// and the 6x6 solve in every thread, which all hold the same pose.

#include <cuda_runtime.h>

#include "gn_common.cuh"

#ifdef VLOAM_GN_PHASES
__device__ long long g_vo_phases[vloam_gn::kPhases];
#endif

namespace {

using vloam_gn::kLanes;
using vloam_gn::kSums;

constexpr int kThreads = 256;
constexpr int kDepthFloats = 5;  // X0 xyz, xb1 xy
constexpr int kEpiFloats = 4;    // xb0 xy, xb1 xy
constexpr int kStageBytes = 96 * 1024;

struct VoArgs {
  const float* pose0;
  long long s_pose;
  const float* X0;
  long long s_X0;
  const float* xb0;
  long long s_xb0;
  const float* xb1;
  long long s_xb1;
  const unsigned char* hd;
  long long s_hd;
  const unsigned char* nd;
  long long s_nd;
  int m;
  int iters;
  float huber_delta;
  float lm_lambda;
  int stage;  // matches staged in each list
  float* pose_out;
};

__device__ inline void load_match(const VoArgs& g, int i, float X0[3], float xb0[2],
                                  float xb1[2]) {
  vloam_gn::load3(g.X0, g.s_X0, i, X0);
  const float* a = g.xb0 + i * g.s_xb0;
  const float* b = g.xb1 + i * g.s_xb1;
  xb0[0] = __ldg(a);
  xb0[1] = __ldg(a + 1);
  xb1[0] = __ldg(b);
  xb1[1] = __ldg(b + 1);
}

// rotation column m: dr/dY (e_m x u), dr/dY rows (1,0,-xb), (0,1,-yb);
// translation column m: dr/dY e_m
__device__ inline void reproj_row(float (&acc)[kLanes], const float R[3][3], const float t[3],
                                  const float X0[3], const float xb1[2], float valid,
                                  float delta) {
  float u[3];
  vloam_gn::rotate(R, X0, u);
  const float Y[3] = {u[0] + t[0], u[1] + t[1], u[2] + t[2]};
  const float r[2] = {Y[0] - Y[2] * xb1[0], Y[1] - Y[2] * xb1[1]};
  const float col[18] = {
      -u[1] * xb1[0], -u[2] - u[1] * xb1[1], 0.f,
      u[2] + u[0] * xb1[0], u[0] * xb1[1], 0.f,
      -u[1], u[0], 0.f,
      1.f, 0.f, 0.f,
      0.f, 1.f, 0.f,
      -xb1[0], -xb1[1], 0.f,
  };
  vloam_gn::accumulate(acc, col, 2, r, vloam_gn::huber_sw(r[0] * r[0] + r[1] * r[1], valid, delta));
}

// r = X1b . (t x (R X0b)) = t . (v x X1b)
__device__ inline void epipolar_row(float (&acc)[kLanes], const float R[3][3], const float t[3],
                                    const float xb0[2], const float xb1[2], float valid,
                                    float delta) {
  const float X0b[3] = {xb0[0], xb0[1], 1.f};
  const float X1b[3] = {xb1[0], xb1[1], 1.f};
  float v[3];
  vloam_gn::rotate(R, X0b, v);
  const float c[3] = {v[1] * X1b[2] - v[2] * X1b[1],
                      v[2] * X1b[0] - v[0] * X1b[2],
                      v[0] * X1b[1] - v[1] * X1b[0]};
  const float r[1] = {t[0] * c[0] + t[1] * c[1] + t[2] * c[2]};
  const float tv = t[0] * v[0] + t[1] * v[1] + t[2] * v[2];
  const float xv = X1b[0] * v[0] + X1b[1] * v[1] + X1b[2] * v[2];
  const float col[18] = {
      X1b[0] * tv - t[0] * xv, 0.f, 0.f,
      X1b[1] * tv - t[1] * xv, 0.f, 0.f,
      X1b[2] * tv - t[2] * xv, 0.f, 0.f,
      c[0], 0.f, 0.f,
      c[1], 0.f, 0.f,
      c[2], 0.f, 0.f,
  };
  vloam_gn::accumulate(acc, col, 1, r, vloam_gn::huber_sw(r[0] * r[0], valid, delta));
}

__global__ void __launch_bounds__(kThreads) gn_vo_kernel(const VoArgs g) {
  extern __shared__ float stage[];  // [kDepthFloats][stage] then [kEpiFloats][stage]
  __shared__ float part[2][(kThreads / 32) * kLanes];
  __shared__ int2 scan[kThreads / 32];

  const int tid = threadIdx.x;
  float* sa = stage;
  float* sb = stage + kDepthFloats * g.stage;
  const int st = min(g.m, g.stage);
  float pose[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) pose[k] = vloam_gn::load1(g.pose0, g.s_pose, k);

  // ---- load, pass 1: count each list's matches (thread tid takes matches
  // tid, tid + kThreads, ...), reading every match's values ------------------
  int2 kept = make_int2(0, 0);
  float bad = 0.f;
#pragma unroll 4
  for (int j = tid; j < st; j += kThreads) {
    const bool h = vloam_gn::load_mask(g.hd, g.s_hd, j);
    const bool n = vloam_gn::load_mask(g.nd, g.s_nd, j);
    float X0[3], xb0[2], xb1[2];
    load_match(g, j, X0, xb0, xb1);
    const float p1 = vloam_gn::poison(xb1[0]) + vloam_gn::poison(xb1[1]);
    kept.x += h;
    kept.y += n;
    if (!h) bad += vloam_gn::poison(X0[0]) + vloam_gn::poison(X0[1]) + vloam_gn::poison(X0[2]) + p1;
    if (!n) bad += vloam_gn::poison(xb0[0]) + vloam_gn::poison(xb0[1]) + p1;
  }
  int2 live;
  const int2 at = vloam_gn::block_scan<kThreads>(kept, scan, &live);

  // ---- load, pass 2: stage each thread's matches from its offsets on -------
  int oa = at.x, ob = at.y;
  for (int j = tid; j < st; j += kThreads) {
    const bool h = vloam_gn::load_mask(g.hd, g.s_hd, j);
    const bool n = vloam_gn::load_mask(g.nd, g.s_nd, j);
    if (!h && !n) continue;
    float X0[3], xb0[2], xb1[2];
    load_match(g, j, X0, xb0, xb1);
    if (h) {
      const float v[kDepthFloats] = {X0[0], X0[1], X0[2], xb1[0], xb1[1]};
#pragma unroll
      for (int f = 0; f < kDepthFloats; ++f) sa[f * g.stage + oa] = v[f];
      ++oa;
    }
    if (n) {
      const float v[kEpiFloats] = {xb0[0], xb0[1], xb1[0], xb1[1]};
#pragma unroll
      for (int f = 0; f < kEpiFloats; ++f) sb[f * g.stage + ob] = v[f];
      ++ob;
    }
  }
  __syncthreads();

  // phases: 0 rows, 1 warp reduction, 2 block sum, 3 broadcast, 4 solve
  vloam_gn::PhaseClock clk;
  clk.start();
  for (int it = 0; it < g.iters; ++it) {
    float R[3][3];
    vloam_gn::rot_rows(pose[0], pose[1], pose[2], pose[3], R);
    const float t[3] = {pose[4], pose[5], pose[6]};
    float acc[kLanes];
#pragma unroll
    for (int s = 0; s < kLanes; ++s) acc[s] = s < kSums ? bad : 0.f;

    for (int j = tid; j < live.x; j += kThreads) {
      const float X0[3] = {sa[0 * g.stage + j], sa[1 * g.stage + j], sa[2 * g.stage + j]};
      const float xb1[2] = {sa[3 * g.stage + j], sa[4 * g.stage + j]};
      reproj_row(acc, R, t, X0, xb1, 1.f, g.huber_delta);
    }
    for (int j = tid; j < live.y; j += kThreads) {
      const float xb0[2] = {sb[0 * g.stage + j], sb[1 * g.stage + j]};
      const float xb1[2] = {sb[2 * g.stage + j], sb[3 * g.stage + j]};
      epipolar_row(acc, R, t, xb0, xb1, 1.f, g.huber_delta);
    }
    // matches past the staging budget, from global memory
    for (int j = st + tid; j < g.m; j += kThreads) {
      float X0[3], xb0[2], xb1[2];
      load_match(g, j, X0, xb0, xb1);
      reproj_row(acc, R, t, X0, xb1, vloam_gn::load_mask(g.hd, g.s_hd, j) ? 1.f : 0.f,
                 g.huber_delta);
      epipolar_row(acc, R, t, xb0, xb1, vloam_gn::load_mask(g.nd, g.s_nd, j) ? 1.f : 0.f,
                   g.huber_delta);
    }

    // the one barrier of the iteration is block_sum's (the two buffers alternate)
    clk.mark(0);
    const float warp_sum = vloam_gn::warp_reduce_scatter(acc);
    clk.mark(1);
    const float sum = vloam_gn::block_sum<kThreads>(warp_sum, part[it & 1]);
    clk.mark(2);
    float sums[kSums];
    vloam_gn::broadcast_sums(sum, sums);
    clk.mark(3);
    vloam_gn::solve_update(sums, g.lm_lambda, pose);
    clk.mark(4);
  }
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 7; ++k) g.pose_out[k] = pose[k];
#ifdef VLOAM_GN_PHASES
    for (int k = 0; k < vloam_gn::kPhases; ++k) g_vo_phases[k] = clk.sum[k];
#endif
  }
}

}  // namespace

#ifdef VLOAM_GN_PHASES
// The phase cycles of the last launch's thread 0 (kPhases values).
extern "C" int vloam_gn_vo_phases(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_vo_phases, sizeof(g_vo_phases)));
}
#endif

// Once, when the library is loaded: dynamic shared memory above 48 KB.
extern "C" int vloam_gn_vo_setup() {
  return static_cast<int>(cudaFuncSetAttribute(
      gn_vo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes));
}

// X0: (m, 3), xb0 and xb1: (m, 2) float32 rows at the given row strides
// (elements); has_depth, no_depth: (m,) bool; pose0 and pose_out (7,)
// [qx qy qz qw tx ty tz], pose0 at stride s_pose.  Returns the launch's
// error code.
extern "C" int vloam_gn_vo(const float* pose0, long long s_pose, const float* X0, long long s_X0,
                           const float* xb0, long long s_xb0, const float* xb1, long long s_xb1,
                           const unsigned char* hd, long long s_hd, const unsigned char* nd,
                           long long s_nd, int m, int iters, float huber_delta, float lm_lambda,
                           float* pose_out, void* stream) {
  if (m < 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int budget = kStageBytes / (4 * (kDepthFloats + kEpiFloats));
  const int stage = m < budget ? m : budget;
  const VoArgs g{pose0, s_pose, X0, s_X0, xb0, s_xb0, xb1, s_xb1, hd, s_hd, nd, s_nd,
                 m, iters, huber_delta, lm_lambda, stage, pose_out};
  const size_t smem = static_cast<size_t>(4 * (kDepthFloats + kEpiFloats) * stage);
  gn_vo_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
