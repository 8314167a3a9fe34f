// Exact brute-force k-NN for two independent (query set, candidate set)
// problems per call, with an optional search radius per problem.
//
// Replaces: vloam_tpu/ops/pallas_knn.py, _grouped_kernel (:124-163), launched
// by knn_lanemin_pair (:184-366), including its radius pruning (_block_aabb,
// _box_dist2 and the schedule, :166-181, :288-312).  The TPU kernel keeps a
// running lane-minimum over VMEM tiles with each candidate's id packed into
// the low mantissa bits of its distance, which is approximate (two
// neighbours sharing a lane class idx % 128 return only the nearer one), and
// with a radius it may or may not report a neighbour beyond it.  This kernel
// is exact, and with a radius it reports every slot beyond it as +inf with
// index 0, whatever it skipped.
//
// What bounds it on Hopper: operations.  Every (query, candidate) pair costs
// 3 subtractions, 3 multiplies, 2 adds and a compare, none of which may fuse;
// the inputs are a few hundred kilobytes and every block finds them in L2.
// The first version was bound by latency instead: at LO's shapes 36 blocks
// of 64 threads, each thread walking up to 32,768 candidates through a
// dependent compare-and-insert chain (2.96 ms a call; MO's 1.23 ms).
//
// Design (the stages are knn_common.cuh, shared with knn.cu, where the
// reasons are):
//   * a call makes 3 __global__ launches, or 4 with the pilot: the tile
//     boxes, the pilot's bound, the sweep over (query tile, candidate split)
//     blocks of both problems, the merge;
//   * candidates are split as well as queries, the number of splits chosen
//     by the wrapper from the shapes (ops/knn.knn_plan) so that the sweep
//     fills the card;
//   * one staged float4 per candidate feeds two queries per thread from one
//     LDS.128, tiles arrive through a 2-slot cp.async ring, and insertions
//     are deferred so that a warp pays for them together;
//   * with a radius, a (256 queries x 256 candidates) step is skipped when
//     the two bounding boxes lie farther apart; Morton-ordered rows make the
//     boxes small (models/laser_mapping.mapping_step);
//   * the rebase centre, the clamped counts and the boxes are computed here,
//     on the device, and rows are read through their stride; the wrapper
//     only checks, allocates and launches.
//
// Sweep blocks (128 threads) at the frame step's four shapes, from
// ops/knn.knn_plan: LO 768x7680 k=8: 3 query tiles x 15 splits = 45, and
// LO 1536x32768 k=16: 6 x 32 = 192, so an LO call sweeps with 237 blocks
// (its pilot, every 4th row, with 9 + 96); MO 4096x16384 k=5: 16 x 32 = 512,
// and MO 8192x49152 k=5: 32 x 96 = 3,072, so an MO call launches 3,584, of
// which those past the live counts or with no surviving tile return at once
// (at frame 35 of the synthetic course 993 of 4,408 live tile steps survive).

#include "knn_common.cuh"

namespace {

using namespace vloam_knn_detail;

__global__ void __launch_bounds__(kPreThreads)
pair_prepass(Problem a, Problem b, int blocks_a) {
  if (static_cast<int>(blockIdx.x) < blocks_a) {
    prepass_block(a, blockIdx.x);
  } else {
    prepass_block(b, blockIdx.x - blocks_a);
  }
}

template <int KA, int KB>
__global__ void __launch_bounds__(kThreads)
pair_sweep(Problem a, Problem b, int blocks_a) {
  __shared__ SweepSmem sm;
  if (static_cast<int>(blockIdx.x) < blocks_a) {
    sweep_block<KA>(a, blockIdx.x, sm);
  } else {
    sweep_block<KB>(b, blockIdx.x - blocks_a, sm);
  }
}

template <int KA, int KB>
__global__ void __launch_bounds__(kMergeThreads)
pair_merge(Problem a, Problem b, int blocks_a) {
  __shared__ MergeSmem<(KA > KB ? KA : KB)> sm;
  if (static_cast<int>(blockIdx.x) < blocks_a) {
    merge_block<KA>(a, blockIdx.x, sm);
  } else {
    merge_block<KB>(b, blockIdx.x - blocks_a, sm);
  }
}

template <int KA, int KB>
__global__ void __launch_bounds__(kThreads)
pair_bound(Problem a, Problem b, int blocks_a) {
  __shared__ float4 tile[kTileC];
  __shared__ float cen[3];
  if (static_cast<int>(blockIdx.x) < blocks_a) {
    bound_block<KA>(a, blockIdx.x, tile, cen);
  } else {
    bound_block<KB>(b, blockIdx.x - blocks_a, tile, cen);
  }
}

template <int KA, int KB>
void launch(const Problem& a, const Problem& b, const Problem& pilot_a, const Problem& pilot_b,
            cudaStream_t s) {
  pair_prepass<<<prepass_blocks(a) + prepass_blocks(b), kPreThreads, 0, s>>>(
      a, b, prepass_blocks(a));
  if (pilot_a.m + pilot_b.m > 0)
    pair_bound<KA, KB><<<sweep_blocks(pilot_a) + sweep_blocks(pilot_b), kThreads, 0, s>>>(
        pilot_a, pilot_b, sweep_blocks(pilot_a));
  pair_sweep<KA, KB><<<sweep_blocks(a) + sweep_blocks(b), kThreads, 0, s>>>(
      a, b, sweep_blocks(a));
  pair_merge<KA, KB><<<merge_blocks(a) + merge_blocks(b), kMergeThreads, 0, s>>>(
      a, b, merge_blocks(a));
}

}  // namespace

// Per problem: queries and their row stride in floats, candidates and theirs,
// the mask, the two valid-prefix lengths (a device int64 or, where the
// pointer is null, the host int), the rows, k, the candidate splits, the
// pilot's row step (0: no pilot) and splits, the squared radius (+inf: none)
// and the outputs.  ``scratch`` holds vloam_knn_scratch_bytes of both
// problems back to back; ``stats`` is null or a zeroed device int32[4]:
// (tile steps swept, skipped) per problem.
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue for a
// (ka, kb) pair that is not instantiated).
extern "C" int vloam_knn_pair(
    const float* qa, int qsa, const float* ca, int csa, const uint8_t* ma,
    const int64_t* qna, int qna_host, const int64_t* cna, int cna_host,
    int m_a, int n_a, int ka, int splits_a, int pilot_step_a, int pilot_splits_a, float r2_a,
    float* d2_a, int64_t* idx_a,
    const float* qb, int qsb, const float* cb, int csb, const uint8_t* mb,
    const int64_t* qnb, int qnb_host, const int64_t* cnb, int cnb_host,
    int m_b, int n_b, int kb, int splits_b, int pilot_step_b, int pilot_splits_b, float r2_b,
    float* d2_b, int64_t* idx_b,
    void* scratch, int* stats, void* stream) {
  if (splits_a < 1 || splits_b < 1 || pilot_step_a < 0 || pilot_step_b < 0 ||
      (pilot_step_a > 0 && pilot_splits_a < 1) || (pilot_step_b > 0 && pilot_splits_b < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Problem a{qa, ca, ma, qna, cna, d2_a, idx_a, m_a, n_a, qsa, csa, qna_host, cna_host,
            splits_a, r2_a, 1, ka};
  Problem b{qb, cb, mb, qnb, cnb, d2_b, idx_b, m_b, n_b, qsb, csb, qnb_host, cnb_host,
            splits_b, r2_b, 1, kb};
  a.stats = stats;
  b.stats = stats ? stats + 2 : nullptr;
  Problem pilot_a, pilot_b;
  char* base = static_cast<char*>(scratch);
  const size_t off = bind_scratch(a, pilot_a, base, 0, pilot_step_a, pilot_splits_a);
  bind_scratch(b, pilot_b, base, off, pilot_step_b, pilot_splits_b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m_a + m_b == 0) return 0;
  if (ka == 8 && kb == 16) {
    launch<8, 16>(a, b, pilot_a, pilot_b, s);
  } else if (ka == 5 && kb == 5) {
    launch<5, 5>(a, b, pilot_a, pilot_b, s);
  } else if (ka == 8 && kb == 8) {
    launch<8, 8>(a, b, pilot_a, pilot_b, s);
  } else if (ka == 16 && kb == 16) {
    launch<16, 16>(a, b, pilot_a, pilot_b, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread (nvcc 12.9, sm_90a; no stack frame, no spill), sweep /
// merge / pilot: <8, 16> 123 / 80 / 64; <5, 5> 79 / 37 / 39; <8, 8> 90 / 47 /
// 48; <16, 16> 123 / 78 / 64.  The prepass uses 32.
