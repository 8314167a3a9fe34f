// Fused Gauss-Newton solve for the two lidar factor types: all inner
// iterations of one solve in one launch of one thread-block cluster; a batch
// of independent solves (loop closure's seeds) runs one cluster each along
// gridDim.y, in the same launch.
//
// Replaces: vloam_tpu/ops/pallas_gn.py, _gn_kernel (:138-205), launched by
// _gn_call (:348) for solve_pose_gn_lidar (and under jax.vmap for the seeds
// of vloam_tpu/parallel/loop_closure.py's registration).
//
// Per iteration:
//   * edge residual r = (lp - a) x c, with lp = R p + t and c = (a-b)/|a-b|
//     (formed here once per row at load, pallas_gn.py:394-397).  It is the
//     reference's lp x c + k with k = (a x b)/|a-b| = -a x c, the subtraction
//     taken first: lp x c and k are each of the size of the points (tens of
//     m) and cancel to a residual of mm, so summed last they leave an error
//     of several float32 steps of |lp| in every row, which the plain version,
//     (lp - a) x (lp - b) / |a - b|, does not have.  Plane residual
//     r = n . lp + d;
//   * analytic Jacobians under q <- exp(dtheta) (x) q, t <- t + dt;
//   * Huber block weights w^2 = valid * min(1, delta / |r|), as
//     delta * rsqrt(max(|r|^2, 1e-20)) outside the delta ball;
//   * the 21 upper-triangle sums of J^T W J and the 6 sums of J^T W r;
//   * damping A_ii += lambda A_ii + 1e-10, the 6x6 Cholesky with the pivot
//     floor max(s, 1e-12), and the normalised quaternion update with the
//     theta < 1e-8 small-angle branch (gn_common.cuh).
//
// What bounds it on Hopper: latency.  The rows (at most 4096 edges of 37
// bytes + 8192 planes of 29 at the kitti_hdl64 caps) are read once; the work
// is ~100 flops per live residual and iteration.  What costs is the chain:
// iteration i+1 needs the pose from iteration i, so each iteration pays a
// pass over the rows, a reduction of 27 sums across the cluster, and a 6x6
// solve, in series.
//
// Design: one cluster of kCluster = 8 CTAs (the portable size) of kThreads
// threads.  CTA `rank` owns the 32-row blocks rank, rank + 8, ... of each
// factor type, so a warp's loads are 32 neighbouring rows and a live prefix
// (MO's stacks) spreads evenly.
//   * Load, once per call: each thread reads its rows where the caller
//     keeps them (strided (B, 3) views, bool masks as bytes), a block scan
//     gives it a place for the rows whose mask is set, and it stages their
//     p, a, c (edges) and p, n, d (planes) in shared memory.  A dropped row
//     adds 0 * its values to the sums (0, or NaN for a non-finite value), as
//     the plain version's multiply by the mask does.  Rows past the staging
//     budget (never at the kitti_hdl64 caps) are read from global memory on
//     every iteration instead.
//   * Each iteration: every thread sums its staged rows into 32 registers
//     (27 sums); a transposed warp reduction (31 shuffles) leaves sum l in
//     lane l; the warps' partials meet in shared memory (two buffers, one
//     barrier); warp 0 pushes the CTA's 27 sums through distributed shared
//     memory into slot `rank` of every CTA (two buffers of slots); after one
//     cluster barrier every warp sums the slots in its own shared memory in
//     rank order, and every thread solves the 6x6 system itself: all hold
//     the bit-identical pose in registers, so nothing publishes it.  (Each
//     warp reading every CTA's slot instead costs ~1000 cycles an iteration:
//     each SM then serves 64 remote reads.  CTA 0 solving alone and writing
//     the pose into every CTA behind a second cluster barrier, and 16 CTAs,
//     were both measured slower: PERF.md.)
// Local memory: none on the iteration path (the 32 accumulators are indexed
// by constants only; sincosf, called only for steps of 0.1 rad or more,
// keeps a small array there for its huge-argument reduction).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gn_common.cuh"

namespace cg = cooperative_groups;

#ifdef VLOAM_GN_PHASES
__device__ long long g_lidar_phases[vloam_gn::kPhases];
#endif

namespace {

using vloam_gn::kLanes;
using vloam_gn::kSums;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEdgeFloats = 9;    // p, a, c
constexpr int kPlaneFloats = 7;   // p, n, d
constexpr int kStageBytes = 96 * 1024;
constexpr int kCluster = 8;

struct LidarArgs {
  const float* pose0;
  long long s_pose;
  const float* ep;
  long long s_ep;
  const float* ea;
  long long s_ea;
  const float* eb;
  long long s_eb;
  const unsigned char* ev;
  long long s_ev;
  int be;
  const float* pp;
  long long s_pp;
  const float* pn;
  long long s_pn;
  const float* pd;
  long long s_pd;
  const unsigned char* pv;
  long long s_pv;
  int bs;
  int iters;
  float huber_delta;
  float lm_lambda;
  int stage_e;  // rows of each type a CTA stages in shared memory
  int stage_s;
  float* pose_out;
};

// Edge row i: p, a, c = (a-b)/|a-b|.
__device__ inline void edge_consts(const LidarArgs& g, int i, float p[3], float a[3],
                                   float c[3]) {
  float b[3];
  vloam_gn::load3(g.ep, g.s_ep, i, p);
  vloam_gn::load3(g.ea, g.s_ea, i, a);
  vloam_gn::load3(g.eb, g.s_eb, i, b);
  const float d[3] = {a[0] - b[0], a[1] - b[1], a[2] - b[2]};
  const float inv = 1.f / fmaxf(sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]), 1e-10f);
  c[0] = d[0] * inv;
  c[1] = d[1] * inv;
  c[2] = d[2] * inv;
}

// 0 if edge row i's inputs are finite, else NaN.
__device__ inline float edge_poison(const LidarArgs& g, int i) {
  float p[3], a[3], b[3];
  vloam_gn::load3(g.ep, g.s_ep, i, p);
  vloam_gn::load3(g.ea, g.s_ea, i, a);
  vloam_gn::load3(g.eb, g.s_eb, i, b);
  float bad = 0.f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    bad += vloam_gn::poison(p[d]) + vloam_gn::poison(a[d]) + vloam_gn::poison(b[d]);
  }
  return bad;
}

__device__ inline void plane_load(const LidarArgs& g, int i, float p[3], float n[3], float* d) {
  vloam_gn::load3(g.pp, g.s_pp, i, p);
  vloam_gn::load3(g.pn, g.s_pn, i, n);
  *d = vloam_gn::load1(g.pd, g.s_pd, i);
}

// r = (lp - a) x c; rotation column m: (e_m x rp) x c; translation column m: e_m x c
__device__ inline void edge_row(float (&acc)[kLanes], const float R[3][3], const float t[3],
                                const float p[3], const float a[3], const float c[3],
                                float valid, float delta) {
  float rp[3];
  vloam_gn::rotate(R, p, rp);
  const float u[3] = {rp[0] + t[0] - a[0], rp[1] + t[1] - a[1], rp[2] + t[2] - a[2]};
  const float r[3] = {u[1] * c[2] - u[2] * c[1],
                      u[2] * c[0] - u[0] * c[2],
                      u[0] * c[1] - u[1] * c[0]};
  const float col[18] = {
      -(c[1] * rp[1] + c[2] * rp[2]), c[0] * rp[1], c[0] * rp[2],
      c[1] * rp[0], -(c[0] * rp[0] + c[2] * rp[2]), c[1] * rp[2],
      c[2] * rp[0], c[2] * rp[1], -(c[0] * rp[0] + c[1] * rp[1]),
      0.f, -c[2], c[1],
      c[2], 0.f, -c[0],
      -c[1], c[0], 0.f,
  };
  const float sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  vloam_gn::accumulate(acc, col, 3, r, vloam_gn::huber_sw(sq, valid, delta));
}

// r = n . lp + d; rotation column m: e_m . (rp x n); translation column m: n_m
__device__ inline void plane_row(float (&acc)[kLanes], const float R[3][3], const float t[3],
                                 const float p[3], const float n[3], float d, float valid,
                                 float delta) {
  float rp[3];
  vloam_gn::rotate(R, p, rp);
  const float r[1] = {n[0] * (rp[0] + t[0]) + n[1] * (rp[1] + t[1]) + n[2] * (rp[2] + t[2]) + d};
  const float col[18] = {
      rp[1] * n[2] - rp[2] * n[1], 0.f, 0.f,
      rp[2] * n[0] - rp[0] * n[2], 0.f, 0.f,
      rp[0] * n[1] - rp[1] * n[0], 0.f, 0.f,
      n[0], 0.f, 0.f,
      n[1], 0.f, 0.f,
      n[2], 0.f, 0.f,
  };
  vloam_gn::accumulate(acc, col, 1, r, vloam_gn::huber_sw(r[0] * r[0], valid, delta));
}

// CTA `rank` owns the 32-row blocks rank, rank + kCluster, rank + 2 kCluster,
// ... of each factor type: its local row j is global row global_row(rank, j),
// and it owns local_rows(b, rank) of b rows (CTA 0 the most).  A warp's 32
// loads of one component are 32 neighbouring rows, and a live prefix spreads
// evenly.
__device__ inline int global_row(int rank, int j) {
  return ((j >> 5) * kCluster + rank) * 32 + (j & 31);
}

__host__ __device__ inline int local_rows(int b, int rank) {
  constexpr int kRound = 32 * kCluster;
  const int rest = b % kRound - 32 * rank;
  return (b / kRound) * 32 + (rest < 0 ? 0 : rest > 32 ? 32 : rest);
}

// Lane l of the slots pushed by the cluster's CTAs, summed in rank order
// (every load issued before the first add).
__device__ inline float cluster_sum(const float (*buf)[kLanes], int lane) {
  float v[kCluster];
#pragma unroll
  for (int r = 0; r < kCluster; ++r) v[r] = buf[r][lane];
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < kCluster; ++r) s += v[r];
  return s;
}

// The batch strides (elements) between one problem's array and the next.
struct LidarBatch {
  long long pose0, ep, ea, eb, ev, pp, pn, pd, pv, pose_out;
};

// Problem blockIdx.y of a batch: its own cluster (the grid's clusters run
// along x), its arrays at blockIdx.y batch strides from the first problem's.
__global__ void __launch_bounds__(kThreads)
    gn_lidar_kernel(const LidarArgs g0, const LidarBatch b) {
  const long long k = blockIdx.y;
  LidarArgs g = g0;
  g.pose0 += k * b.pose0;
  g.ep += k * b.ep;
  g.ea += k * b.ea;
  g.eb += k * b.eb;
  g.ev += k * b.ev;
  g.pp += k * b.pp;
  g.pn += k * b.pn;
  g.pd += k * b.pd;
  g.pv += k * b.pv;
  g.pose_out += k * b.pose_out;
  extern __shared__ float stage[];  // [kEdgeFloats][stage_e] then [kPlaneFloats][stage_s]
  __shared__ float part[2][kWarps * kLanes];
  __shared__ float slots[2][kCluster][kLanes];  // [buffer][source rank][sum], pushed
  __shared__ int2 scan[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  float* se = stage;
  float* ss = stage + kEdgeFloats * g.stage_e;
  const int n_e = local_rows(g.be, rank);
  const int n_s = local_rows(g.bs, rank);
  const int st_e = min(n_e, g.stage_e);
  const int st_s = min(n_s, g.stage_s);
  float pose[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) pose[k] = vloam_gn::load1(g.pose0, g.s_pose, k);

  // ---- load, pass 1: count the kept rows (thread tid takes local rows tid,
  // tid + kThreads, ...); every row's values are read, kept or not, so that
  // the loads do not wait on the mask, and pass 2 finds them in L1 ---------
  int2 kept = make_int2(0, 0);
  float bad = 0.f;
#pragma unroll 4
  for (int j = tid; j < st_e; j += kThreads) {
    const int i = global_row(rank, j);
    const bool keep = vloam_gn::load_mask(g.ev, g.s_ev, i);
    const float row_bad = edge_poison(g, i);
    if (keep) {
      ++kept.x;
    } else {
      bad += row_bad;
    }
  }
#pragma unroll 4
  for (int j = tid; j < st_s; j += kThreads) {
    const int i = global_row(rank, j);
    const bool keep = vloam_gn::load_mask(g.pv, g.s_pv, i);
    float p[3], n[3], d;
    plane_load(g, i, p, n, &d);
    if (keep) {
      ++kept.y;
    } else {
      bad += vloam_gn::poison(p[0]) + vloam_gn::poison(p[1]) + vloam_gn::poison(p[2]) +
             vloam_gn::poison(n[0]) + vloam_gn::poison(n[1]) + vloam_gn::poison(n[2]) +
             vloam_gn::poison(d);
    }
  }
  int2 live;
  const int2 at = vloam_gn::block_scan<kThreads>(kept, scan, &live);

  // ---- load, pass 2: stage each thread's kept rows from its offset on -----
  int o = at.x;
  for (int j = tid; j < st_e; j += kThreads) {
    const int i = global_row(rank, j);
    if (!vloam_gn::load_mask(g.ev, g.s_ev, i)) continue;
    float v[kEdgeFloats];
    edge_consts(g, i, v, v + 3, v + 6);
#pragma unroll
    for (int f = 0; f < kEdgeFloats; ++f) se[f * g.stage_e + o] = v[f];
    ++o;
  }
  o = at.y;
  for (int j = tid; j < st_s; j += kThreads) {
    const int i = global_row(rank, j);
    if (!vloam_gn::load_mask(g.pv, g.s_pv, i)) continue;
    float v[kPlaneFloats];
    plane_load(g, i, v, v + 3, v + 6);
#pragma unroll
    for (int f = 0; f < kPlaneFloats; ++f) ss[f * g.stage_s + o] = v[f];
    ++o;
  }
  cluster.sync();  // staged, and every CTA has started before any push into its slots

  // phases: 0 rows, 1 warp reduction, 2 block sum, 3 push + cluster barrier,
  // 4 slot sums + broadcast, 5 solve
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
      const float p[3] = {se[0 * g.stage_e + j], se[1 * g.stage_e + j], se[2 * g.stage_e + j]};
      const float a[3] = {se[3 * g.stage_e + j], se[4 * g.stage_e + j], se[5 * g.stage_e + j]};
      const float c[3] = {se[6 * g.stage_e + j], se[7 * g.stage_e + j], se[8 * g.stage_e + j]};
      edge_row(acc, R, t, p, a, c, 1.f, g.huber_delta);
    }
    for (int j = tid; j < live.y; j += kThreads) {
      const float p[3] = {ss[0 * g.stage_s + j], ss[1 * g.stage_s + j], ss[2 * g.stage_s + j]};
      const float n[3] = {ss[3 * g.stage_s + j], ss[4 * g.stage_s + j], ss[5 * g.stage_s + j]};
      plane_row(acc, R, t, p, n, ss[6 * g.stage_s + j], 1.f, g.huber_delta);
    }
    // rows past the staging budget, from global memory
    for (int j = st_e + tid; j < n_e; j += kThreads) {
      const int i = global_row(rank, j);
      float p[3], a[3], c[3];
      edge_consts(g, i, p, a, c);
      edge_row(acc, R, t, p, a, c, vloam_gn::load_mask(g.ev, g.s_ev, i) ? 1.f : 0.f,
               g.huber_delta);
    }
    for (int j = st_s + tid; j < n_s; j += kThreads) {
      const int i = global_row(rank, j);
      float p[3], n[3], d;
      plane_load(g, i, p, n, &d);
      plane_row(acc, R, t, p, n, d, vloam_gn::load_mask(g.pv, g.s_pv, i) ? 1.f : 0.f,
                g.huber_delta);
    }

    // ---- the 27 sums: warp, CTA, then the cluster (both buffers alternate) --
    clk.mark(0);
    const float warp_sum = vloam_gn::warp_reduce_scatter(acc);
    clk.mark(1);
    const float cta_sum = vloam_gn::block_sum<kThreads>(warp_sum, part[it & 1]);
    clk.mark(2);
    float (*buf)[kLanes] = slots[it & 1];
    if (tid < kLanes) {  // push this CTA's sums into slot `rank` of every CTA
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        cluster.map_shared_rank(&buf[rank][0], r)[lane] = cta_sum;
      }
    }
    cluster.sync();
    clk.mark(3);
    float sums[kSums];
    vloam_gn::broadcast_sums(cluster_sum(buf, lane), sums);
    clk.mark(4);
    vloam_gn::solve_update(sums, g.lm_lambda, pose);
    clk.mark(5);
  }
  if (rank == 0 && tid == 0) {
#pragma unroll
    for (int k = 0; k < 7; ++k) g.pose_out[k] = pose[k];
#ifdef VLOAM_GN_PHASES
    for (int k = 0; k < vloam_gn::kPhases; ++k) g_lidar_phases[k] = clk.sum[k];
#endif
  }
}

}  // namespace

#ifdef VLOAM_GN_PHASES
// The phase cycles of the last launch's thread 0 of CTA 0 (kPhases values).
extern "C" int vloam_gn_lidar_phases(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_lidar_phases, sizeof(g_lidar_phases)));
}
#endif

// Once, when the library is loaded: dynamic shared memory above 48 KB.
extern "C" int vloam_gn_lidar_setup() {
  return static_cast<int>(cudaFuncSetAttribute(
      gn_lidar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes));
}

// `batch` independent solves in one launch, one cluster of kCluster CTAs
// each.  ep, ea, eb: (be, 3) float32 rows at the given row strides
// (elements), ev (be,) bool; pp, pn: (bs, 3), pd (bs,) float32, pv (bs,)
// bool; pose0 and pose_out (7,) [qx qy qz qw tx ty tz], pose0 at stride
// s_pose.  Problem k's arrays start k batch strides (the b_* arguments,
// elements; 0 shares one array among all problems) past the pointers given;
// its pose goes to pose_out + k * b_out.  Returns the launch's error code.
extern "C" int vloam_gn_lidar(
    int batch, const float* pose0, long long s_pose, long long b_pose, const float* ep,
    long long s_ep, long long b_ep, const float* ea, long long s_ea, long long b_ea,
    const float* eb, long long s_eb, long long b_eb, const unsigned char* ev, long long s_ev,
    long long b_ev, int be, const float* pp, long long s_pp, long long b_pp, const float* pn,
    long long s_pn, long long b_pn, const float* pd, long long s_pd, long long b_pd,
    const unsigned char* pv, long long s_pv, long long b_pv, int bs, int iters,
    float huber_delta, float lm_lambda, float* pose_out, long long b_out, void* stream) {
  if (batch < 0 || batch > 65535 || be < 0 || bs < 0 || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  // stage every row of the largest share (CTA 0's) if it fits the budget,
  // else the same fraction of each type (the rest is read from global memory)
  const long long share_e = local_rows(be, 0);
  const long long share_s = local_rows(bs, 0);
  const long long need = 4 * (kEdgeFloats * share_e + kPlaneFloats * share_s);
  long long stage_e = share_e, stage_s = share_s;
  if (need > kStageBytes) {
    stage_e = share_e * kStageBytes / need;
    stage_s = share_s * kStageBytes / need;
  }
  const LidarArgs g{pose0, s_pose, ep, s_ep, ea, s_ea, eb, s_eb, ev, s_ev, be,
                    pp, s_pp, pn, s_pn, pd, s_pd, pv, s_pv, bs, iters, huber_delta,
                    lm_lambda, static_cast<int>(stage_e), static_cast<int>(stage_s), pose_out};
  const LidarBatch b{b_pose, b_ep, b_ea, b_eb, b_ev, b_pp, b_pn, b_pd, b_pv, b_out};

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(4 * (kEdgeFloats * stage_e + kPlaneFloats * stage_s));
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gn_lidar_kernel, g, b);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
