// Exact brute-force k-NN for one (query set, candidate set) problem per
// launch.
//
// Replaces: vloam_tpu/ops/pallas_knn.py, _knn_kernel (:53-89), launched by
// _lanemin_keys (:92) and wrapped by knn_lanemin (:377-432).  The TPU kernel
// keeps a running lane-minimum over VMEM tiles, which is approximate (two
// neighbours sharing a lane class idx % 128 return only the nearer one), and
// returns NaN for queries past the valid count.  This kernel is exact and
// follows the port's one k-NN contract (ops/knn.py): d2 bit-equal to the
// plain version, ties to the lower index, +inf / index 0 for unfilled slots
// and for queries past the valid count.
//
// What bounds it on Hopper: arithmetic, as for knn_pair.cu.  Every (live
// query, live candidate) pair costs 3 subtractions, 3 multiplies, 2 adds and
// a compare; candidates are read from device memory once per block of 64
// queries and then served from shared memory.
//
// Design: the per-block sweep of knn_common.cuh (one thread per query,
// candidate tiles staged through shared memory, dynamic counts read on the
// device), with two kinds of per-thread top-k:
//   * k in {1, 5, 8, 16}, the values the system calls: the k best pairs are
//     insertion-sorted in registers (RegTopK<K>);
//   * any other k <= 128: the same insertion sort over per-thread arrays in
//     local memory with k read at run time (LocalTopK).  Insertions become
//     rare once the list has warmed up, so the sweep itself still runs from
//     registers and shared memory.

#include "knn_common.cuh"

namespace {

using namespace vloam_knn_detail;

constexpr int kMaxK = 128;

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
  __device__ __forceinline__ void store(const Group& g, int qi) const {
    for (int s = 0; s < k_; ++s) store_slot(g, qi, k_, s, bd[s], bi[s]);
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

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(Group g, const int* __restrict__ counts) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];
  RegTopK<K> best;
  knn_block(g, counts[0], counts[1], blockIdx.x, sx, sy, sz, best);
}

__global__ void __launch_bounds__(kThreads)
knn_kernel_any_k(Group g, const int* __restrict__ counts, int k) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];
  LocalTopK best;
  best.k_ = k;
  knn_block(g, counts[0], counts[1], blockIdx.x, sx, sy, sz, best);
}

}  // namespace

// counts: device int32[2] = (query count, candidate count).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a k
// outside [1, 128]).
extern "C" int vloam_knn(
    const float* q, const float* c, const uint8_t* mask, const float* center, int m, int n,
    int k, float* d2, int64_t* idx, const int* counts, void* stream) {
  const Group g{q, c, mask, center, d2, idx, m, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const int blocks = (m + kThreads - 1) / kThreads;
  switch (k) {
    case 1: knn_kernel<1><<<blocks, kThreads, 0, s>>>(g, counts); break;
    case 5: knn_kernel<5><<<blocks, kThreads, 0, s>>>(g, counts); break;
    case 8: knn_kernel<8><<<blocks, kThreads, 0, s>>>(g, counts); break;
    case 16: knn_kernel<16><<<blocks, kThreads, 0, s>>>(g, counts); break;
    default: knn_kernel_any_k<<<blocks, kThreads, 0, s>>>(g, counts, k); break;
  }
  return static_cast<int>(cudaGetLastError());
}
