// Exact brute-force k-NN for two independent (query set, candidate set)
// problems in one launch.
//
// Replaces: vloam_tpu/ops/pallas_knn.py, _grouped_kernel (:124-163), launched
// by knn_lanemin_pair (:333).  The TPU kernel keeps a running lane-minimum
// over VMEM tiles with each candidate's id packed into the low mantissa bits
// of its distance, which is approximate (two neighbours sharing a lane class
// idx % 128 return only the nearer one).  This kernel is exact: each query
// keeps its own top-k in registers.
//
// What bounds it on Hopper: arithmetic.  Every (query, candidate) pair costs
// 3 subtractions, 3 multiplies, 2 adds and a compare; candidates are read
// from device memory once per block of queries and then served from shared
// memory, so at the slice's shapes (up to 8192 x 49152) the FP32 pipes, not
// HBM, are the limit.
//
// Design (the per-block sweep is knn_common.cuh, shared with knn.cu):
//   * one thread per query, kThreads queries per block; blocks [0, blocks_a)
//     serve group A and the rest group B, so both problems share one launch;
//   * candidate tiles of kTile points are staged through shared memory as
//     structure-of-arrays floats, already rebased to the group's centre;
//   * the sweep stops at the dynamic valid candidate count, read on the
//     device (no host round trip), and a block wholly past the valid query
//     count skips the sweep;
//   * each thread keeps the k best (d2, index) pairs insertion-sorted in
//     registers (k is a template parameter so the arrays stay in registers);
//     a candidate enters only if strictly nearer than the current k-th, and
//     candidates arrive in index order, so ties go to the lower index;
//   * d2 is in difference form after rebasing to the centre of the valid
//     candidates' bounding box (computed in torch before the launch), with
//     every operation rounded separately (__f*_rn: no FMA contraction), so
//     it is bit-identical to the plain PyTorch version;
//   * masked candidates are staged as +inf and never enter; unfilled slots
//     and queries past their valid count return d2 = +inf with index 0,
//     an in-range index that callers may gather with.

#include "knn_common.cuh"

namespace {

using namespace vloam_knn_detail;

template <int KA, int KB>
__global__ void __launch_bounds__(kThreads)
knn_pair_kernel(Group a, Group b, const int* __restrict__ counts, int blocks_a) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];
  if ((int)blockIdx.x < blocks_a) {
    RegTopK<KA> best;
    knn_block(a, counts[0], counts[1], blockIdx.x, sx, sy, sz, best);
  } else {
    RegTopK<KB> best;
    knn_block(b, counts[2], counts[3], blockIdx.x - blocks_a, sx, sy, sz, best);
  }
}

template <int KA, int KB>
void launch(const Group& a, const Group& b, const int* counts, cudaStream_t stream) {
  const int blocks_a = (a.m + kThreads - 1) / kThreads;
  const int blocks_b = (b.m + kThreads - 1) / kThreads;
  knn_pair_kernel<KA, KB><<<blocks_a + blocks_b, kThreads, 0, stream>>>(a, b, counts, blocks_a);
}

}  // namespace

// counts: device int32[4] = (query count A, candidate count A,
//                            query count B, candidate count B).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// (ka, kb) pair that is not instantiated).
extern "C" int vloam_knn_pair(
    const float* qa, const float* ca, const uint8_t* ma, const float* cen_a, int m_a, int n_a,
    int ka, float* d2_a, int64_t* idx_a,
    const float* qb, const float* cb, const uint8_t* mb, const float* cen_b, int m_b, int n_b,
    int kb, float* d2_b, int64_t* idx_b,
    const int* counts, void* stream) {
  const Group a{qa, ca, ma, cen_a, d2_a, idx_a, m_a, n_a};
  const Group b{qb, cb, mb, cen_b, d2_b, idx_b, m_b, n_b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m_a + m_b == 0) return 0;
  if (ka == 8 && kb == 16) {
    launch<8, 16>(a, b, counts, s);
  } else if (ka == 5 && kb == 5) {
    launch<5, 5>(a, b, counts, s);
  } else if (ka == 8 && kb == 8) {
    launch<8, 8>(a, b, counts, s);
  } else if (ka == 16 && kb == 16) {
    launch<16, 16>(a, b, counts, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
