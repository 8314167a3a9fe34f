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
// Design:
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

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 1024;

struct Group {
  const float* q;        // (m, 3) queries, row-major
  const float* c;        // (n, 3) candidates, row-major
  const uint8_t* mask;   // (n,) candidate validity
  const float* center;   // (3,) rebase centre
  float* d2;             // (m, k) out
  int64_t* idx;          // (m, k) out
  int m;
  int n;
};

template <int K>
__device__ __forceinline__ void knn_block(const Group& g, int q_count, int c_count, int block,
                                          float* sx, float* sy, float* sz) {
  const int tid = threadIdx.x;
  const int qi = block * kThreads + tid;
  q_count = min(max(q_count, 0), g.m);
  c_count = min(max(c_count, 0), g.n);
  const float c0 = g.center[0], c1 = g.center[1], c2 = g.center[2];
  const bool live = qi < q_count;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = __fsub_rn(g.q[3 * qi + 0], c0);
    qy = __fsub_rn(g.q[3 * qi + 1], c1);
    qz = __fsub_rn(g.q[3 * qi + 2], c2);
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = 0;
  }

  // uniform across the block, so the __syncthreads below are safe
  if (block * kThreads < q_count) {
    for (int base = 0; base < c_count; base += kTile) {
      const int n = min(kTile, c_count - base);
      for (int j = tid; j < n; j += kThreads) {
        const int gj = base + j;
        if (g.mask[gj]) {
          sx[j] = __fsub_rn(g.c[3 * gj + 0], c0);
          sy[j] = __fsub_rn(g.c[3 * gj + 1], c1);
          sz[j] = __fsub_rn(g.c[3 * gj + 2], c2);
        } else {
          sx[j] = CUDART_INF_F;
          sy[j] = CUDART_INF_F;
          sz[j] = CUDART_INF_F;
        }
      }
      __syncthreads();
      if (live) {
        for (int j = 0; j < n; ++j) {
          const float dx = __fsub_rn(qx, sx[j]);
          const float dy = __fsub_rn(qy, sy[j]);
          const float dz = __fsub_rn(qz, sz[j]);
          const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                    __fmul_rn(dz, dz));
          if (d < bd[K - 1]) {
            bd[K - 1] = d;
            bi[K - 1] = base + j;
#pragma unroll
            for (int s = K - 1; s > 0; --s) {
              if (bd[s] < bd[s - 1]) {
                const float td = bd[s];
                bd[s] = bd[s - 1];
                bd[s - 1] = td;
                const int ti = bi[s];
                bi[s] = bi[s - 1];
                bi[s - 1] = ti;
              }
            }
          }
        }
      }
      __syncthreads();
    }
  }

  if (qi < g.m) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const bool found = bd[s] < CUDART_INF_F;
      g.d2[(int64_t)qi * K + s] = found ? bd[s] : CUDART_INF_F;
      g.idx[(int64_t)qi * K + s] = found ? (int64_t)bi[s] : 0;
    }
  }
}

template <int KA, int KB>
__global__ void __launch_bounds__(kThreads)
knn_pair_kernel(Group a, Group b, const int* __restrict__ counts, int blocks_a) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];
  if ((int)blockIdx.x < blocks_a) {
    knn_block<KA>(a, counts[0], counts[1], blockIdx.x, sx, sy, sz);
  } else {
    knn_block<KB>(b, counts[2], counts[3], blockIdx.x - blocks_a, sx, sy, sz);
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
