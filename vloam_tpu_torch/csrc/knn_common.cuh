// Shared by the two exact brute-force k-NN kernels: knn_pair.cu (two problems
// in one launch) and knn.cu (one problem per launch).
//
// One thread per query, kThreads queries per block.  Candidate tiles of kTile
// points are staged through shared memory as structure-of-arrays floats,
// already rebased to the problem's centre; masked candidates are staged as
// +inf and never enter.  The sweep stops at the dynamic valid candidate count
// and a block wholly past the valid query count skips it.  d2 is in
// difference form with every operation rounded separately (__f*_rn: no FMA
// contraction), so it is bit-identical to the plain PyTorch version.
// Candidates arrive in index order and enter only if strictly nearer than the
// current k-th, so ties go to the lower index.  Unfilled slots and queries
// past their valid count return d2 = +inf with index 0.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace vloam_knn_detail {

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

// Write slot s of query qi: an unfilled slot is d2 = +inf with index 0.
__device__ __forceinline__ void store_slot(const Group& g, int qi, int k, int s, float d, int j) {
  const bool found = d < CUDART_INF_F;
  g.d2[(int64_t)qi * k + s] = found ? d : CUDART_INF_F;
  g.idx[(int64_t)qi * k + s] = found ? (int64_t)j : 0;
}

// A query's k best (d2, index) pairs, insertion-sorted.  K is a template
// parameter so that, once the loops are unrolled, both arrays stay in
// registers.
template <int K>
struct RegTopK {
  float bd[K];
  int bi[K];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[s] = CUDART_INF_F;
      bi[s] = 0;
    }
  }
  __device__ __forceinline__ void store(const Group& g, int qi) const {
#pragma unroll
    for (int s = 0; s < K; ++s) store_slot(g, qi, K, s, bd[s], bi[s]);
  }
  __device__ __forceinline__ void offer(float d, int j) {
    if (d < bd[K - 1]) {
      bd[K - 1] = d;
      bi[K - 1] = j;
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
};

// One block's share of one problem: stage candidate tiles, sweep them for
// this thread's query, write the k best.  ``best`` is a RegTopK<K> or any
// type with its init / offer / store.
template <class TopK>
__device__ __forceinline__ void knn_block(const Group& g, int q_count, int c_count, int block,
                                          float* sx, float* sy, float* sz, TopK& best) {
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
  best.init();

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
          best.offer(d, base + j);
        }
      }
      __syncthreads();
    }
  }

  if (qi < g.m) best.store(g, qi);
}

}  // namespace vloam_knn_detail
