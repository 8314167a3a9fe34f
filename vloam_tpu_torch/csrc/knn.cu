// Exact brute-force k-NN for one (query set, candidate set) problem per call.
//
// Replaces: vloam_tpu/ops/pallas_knn.py, _knn_kernel (:53-89), launched by
// _lanemin_keys (:92) and wrapped by knn_lanemin (:377-432).  The TPU kernel
// keeps a running lane-minimum over VMEM tiles, which is approximate (two
// neighbours sharing a lane class idx % 128 return only the nearer one), and
// returns NaN for queries past the valid count.  This kernel is exact and
// follows the port's one k-NN contract (ops/knn.py): d2 bit-equal to the
// plain version, ties to the lower index, +inf / index 0 for unfilled slots
// and for queries past the valid count.  It takes no radius: knn_lanemin has
// none.
//
// What bounds it on Hopper: operations, as for knn_pair.cu (nine unfusable
// floating operations and a compare per pair; the inputs sit in L2).
//
// Design: the stages of knn_common.cuh on one problem, for k in {1, 5, 8, 16},
// the values the system calls: the tile boxes (here only for the rebase
// centre), the pilot's bound where the search is long enough (every 4th row),
// the sweep over (query tile, candidate split) blocks with the k best pairs
// of two queries per thread in registers (RegTopK<K>), and the merge: 3 or 4
// __global__ launches a call.  At the map association's shapes the sweep runs
// 16 x 32 = 512 blocks (4096x16384) and 32 x 17 = 544 (8192x49152).
// Any other k <= 128 takes 2 launches: the tile boxes, then one thread per
// query walking all candidates with an insertion-sorted list in local memory
// and k read at run time (LocalTopK); a 128-deep list does not fit the
// registers the split sweep lives on, and no caller of the system uses it.
// Insertions become rare once a list has warmed up, so that sweep still runs
// from registers and shared memory.

#include <math.h>

#include "knn_common.cuh"

namespace {

using namespace vloam_knn_detail;

constexpr int kMaxK = 128;
constexpr int kAnyThreads = 64;     // queries per block of the run-time-k sweep
constexpr int kAnyTile = 1024;      // candidates staged per step there

struct LocalTopK {
  float bd[kMaxK];
  int bi[kMaxK];
  int k_;
  __device__ __forceinline__ void init() {
    for (int s = 0; s < k_; ++s) {
      bd[s] = CUDART_INF_F;
      bi[s] = 0;
    }
  }
  __device__ __forceinline__ void store(const Problem& p, int qi) const {
    for (int s = 0; s < k_; ++s) store_slot(p, qi, k_, s, bd[s], bi[s]);
  }
  __device__ __forceinline__ void offer(float d, int j) {
    if (d < bd[k_ - 1]) {
      int s = k_ - 1;
      // equal distances do not move: the earlier (lower) index stays ahead
      while (s > 0 && bd[s - 1] > d) {
        bd[s] = bd[s - 1];
        bi[s] = bi[s - 1];
        --s;
      }
      bd[s] = d;
      bi[s] = j;
    }
  }
};

__global__ void __launch_bounds__(kPreThreads) knn_prepass(Problem p) {
  prepass_block(p, blockIdx.x);
}

template <int K>
__global__ void __launch_bounds__(kThreads) knn_sweep(Problem p) {
  __shared__ SweepSmem sm;
  sweep_block<K>(p, blockIdx.x, sm);
}

template <int K>
__global__ void __launch_bounds__(kMergeThreads) knn_merge(Problem p) {
  __shared__ MergeSmem<K> sm;
  merge_block<K>(p, blockIdx.x, sm);
}

// One thread per query, all candidates, k at run time.
__global__ void __launch_bounds__(kAnyThreads) knn_any_k(Problem p, int k) {
  __shared__ float4 tile[kAnyTile];
  __shared__ float cen[3];
  const int tid = threadIdx.x;
  const int qi = blockIdx.x * kAnyThreads + tid;
  const int q_n = live_count(p.q_count, p.q_count_host, p.m);
  const int c_n = live_count(p.c_count, p.c_count_host, p.n);
  block_center(p, cen);
  const float c0 = cen[0], c1 = cen[1], c2 = cen[2];
  const bool live = qi < q_n;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const float* row = p.q + static_cast<int64_t>(qi) * p.q_stride;
    qx = __fsub_rn(row[0], c0);
    qy = __fsub_rn(row[1], c1);
    qz = __fsub_rn(row[2], c2);
  }
  LocalTopK best;
  best.k_ = k;
  best.init();

  // uniform across the block, so the __syncthreads below are safe
  if (static_cast<int>(blockIdx.x) * kAnyThreads < q_n) {
    for (int base = 0; base < c_n; base += kAnyTile) {
      const int n = min(kAnyTile, c_n - base);
      for (int j = tid; j < n; j += kAnyThreads) {
        const int gj = base + j;
        float4 v = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.f);
        if (p.mask[gj]) {
          const float* row = p.c + static_cast<int64_t>(gj) * p.c_stride;
          v.x = __fsub_rn(row[0], c0);
          v.y = __fsub_rn(row[1], c1);
          v.z = __fsub_rn(row[2], c2);
        }
        tile[j] = v;
      }
      __syncthreads();
      if (live) {
        for (int j = 0; j < n; ++j) best.offer(dist2(qx, qy, qz, tile[j]), base + j);
      }
      __syncthreads();
    }
  }

  if (qi < p.m) best.store(p, qi);
}

template <int K>
__global__ void __launch_bounds__(kThreads) knn_bound(Problem p) {
  __shared__ float4 tile[kTileC];
  __shared__ float cen[3];
  bound_block<K>(p, blockIdx.x, tile, cen);
}

template <int K>
void launch(const Problem& p, const Problem& pilot, cudaStream_t s) {
  knn_prepass<<<prepass_blocks(p), kPreThreads, 0, s>>>(p);
  if (pilot.m > 0) knn_bound<K><<<sweep_blocks(pilot), kThreads, 0, s>>>(pilot);
  knn_sweep<K><<<sweep_blocks(p), kThreads, 0, s>>>(p);
  knn_merge<K><<<merge_blocks(p), kMergeThreads, 0, s>>>(p);
}

}  // namespace

// Bytes of scratch one problem needs (a multiple of 16, so problems stack).
extern "C" int vloam_knn_scratch_bytes(int m, int n, int k, int splits, int pilot_step,
                                       int pilot_splits) {
  if (m < 0 || n < 0 || k < 1 || splits < 1 || pilot_step < 0 ||
      (pilot_step > 0 && pilot_splits < 1))
    return -1;
  return static_cast<int>(scratch_layout(0, m, n, k, splits, pilot_step).end);
}

// The arguments of one problem as in vloam_knn_pair, without a radius.
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue for a
// k outside [1, 128]).
extern "C" int vloam_knn(
    const float* q, int q_stride, const float* c, int c_stride, const uint8_t* mask,
    const int64_t* q_count, int q_count_host, const int64_t* c_count, int c_count_host,
    int m, int n, int k, int splits, int pilot_step, int pilot_splits,
    float* d2, int64_t* idx, void* scratch, void* stream) {
  if (k < 1 || k > kMaxK || splits < 1 || pilot_step < 0 || (pilot_step > 0 && pilot_splits < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Problem p{q, c, mask, q_count, c_count, d2, idx, m, n, q_stride, c_stride,
            q_count_host, c_count_host, splits, HUGE_VALF, 1, k};
  Problem pilot;
  bind_scratch(p, pilot, static_cast<char*>(scratch), 0, pilot_step, pilot_splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  switch (k) {
    case 1: launch<1>(p, pilot, s); break;
    case 5: launch<5>(p, pilot, s); break;
    case 8: launch<8>(p, pilot, s); break;
    case 16: launch<16>(p, pilot, s); break;
    default:   // no pilot: the wrapper passes pilot_step 0 for a run-time k
      knn_prepass<<<prepass_blocks(p), kPreThreads, 0, s>>>(p);
      knn_any_k<<<ceil_div(m, kAnyThreads), kAnyThreads, 0, s>>>(p, k);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread (nvcc 12.9, sm_90a; no stack frame, no spill), sweep /
// merge / pilot: K=1 59 / 26 / 40; K=5 75 / 30 / 39; K=8 90 / 37 / 48; K=16
// 121 / 52 / 64.  The prepass uses 31.  knn_any_k uses 48 and keeps its two
// 128-entry lists in 1,032 bytes of local memory.
