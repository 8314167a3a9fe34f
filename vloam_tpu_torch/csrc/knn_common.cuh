// Shared by the two exact brute-force k-NN kernels: knn_pair.cu (two problems
// per call) and knn.cu (one problem per call).  Both run the same __global__
// stages on one Problem each, so they cannot drift apart:
//
//   1. prepass_block: one block per tile of kTileC candidates or kTileQ
//      queries writes the tile's axis-aligned bounding boxes (raw
//      coordinates; candidates: one box over the masked rows, for the rebase
//      centre, and one over the masked rows below the candidate count, for
//      pruning; queries: the rows below the query count).
//   1b. bound_block (the pilot; only for a long search without a radius):
//      over every pilot_step-th candidate row it keeps, per query, the
//      minimum of each of k disjoint groups.  The largest of the k minima
//      bounds the query's k-th distance from above.
//   2. sweep_block: one block per (query tile, candidate split).  The block
//      derives the rebase centre 0.5 * (lo + hi) from the tile boxes (0 when
//      nothing is valid), rebases its kQ queries per thread into registers,
//      and walks the candidate tiles of its split: a tile whose box lies
//      farther than the radius from the query tile's box is skipped; the
//      others are fetched with cp.async through a 2-slot ring while the
//      previous tile is swept, turned into one float4 per candidate (rebased,
//      masked -> +inf, its row in .w) and swept from shared memory, one
//      LDS.128 per candidate feeding kQ distances per thread.  Each query's k
//      best pairs go to scratch.
//   3. merge_block: eight threads per query merge the splits' lists and
//      write (d2, idx).
//
// Exactness.  d2 is in difference form with every operation rounded
// separately (__f*_rn: no FMA contraction), so it is bit-identical to the
// plain PyTorch version.  A list (RegTopK) is ordered by (d2, index), the
// key the plain version sorts by, so neither the order in which candidates
// reach it nor which block finished first shows in the result: ties go to
// the lower index.  Masked candidates and candidates past the count are
// staged as +inf and never enter.  Unfilled slots and queries past their
// count return d2 = +inf with index 0.  With a radius every slot whose d2
// exceeds r2 returns +inf and index 0, so skipping is invisible: rounding is
// monotone, hence no d2 computed in a tile is below the box distance
// computed here with the same operation order.  The pilot only ever removes
// candidates farther than k others; its minima meet through integer
// atomicMin on the bits of non-negative floats, which commutes.  No float
// atomics anywhere.
//
// What the design is about.  The fast path is nine floating operations and a
// compare per pair, and the card can do about 2.6e12 such pairs a second.
// What stands in its way is the lists:
//   * an insertion is 5 K instructions, and in a warp it runs for one lucky
//     lane while 31 wait.  So a candidate that passes a query's test is only
//     appended to a small per-thread buffer in shared memory; when a buffer
//     of the warp runs full every lane drains its own into its list, and the
//     insertions run for all lanes at once.  An insertion computes each
//     slot's new value from the old values alone (no chain of swaps), so its
//     K steps are independent;
//   * every split warms up a list of its own from +inf, and a scan-ordered
//     cloud approaches a query monotonically, so that for a while every
//     candidate is a new best.  Three things bound that: a tile's rows are
//     staged in scattered order ((r * kScatter) % kTileC), which turns a
//     monotone run into a random one (the LO call: 0.54 -> 0.22 ms); the test
//     is against min(k-th, bar), the bar being r2 under a radius (a slot
//     beyond it would be reported +inf anyway) and the pilot's bound
//     otherwise (0.21 -> 0.17 ms); and without a radius no more than 32
//     splits;
//   * under a radius most (query tile, split) blocks return at once and the
//     work sits where the surviving tiles lie, so the splits are two tiles
//     fine and parallelism follows the survivors (0.21 -> 0.13 ms on MO).
// Numbers: NVIDIA H100 80GB HBM3, 700 W, device ms of a knn_pair call at the
// frame step's shapes inside a replayed CUDA graph.
//
// Resources (nvcc 12.9 -Xptxas -v, sm_90a): no stack frame and no spill in
// any kernel that holds a RegTopK; the sweep uses 30,736 bytes of static
// shared memory and 128 threads per block, the pilot 4,108 bytes, the merge
// 1,024 x K bytes; registers per thread are listed at the end of
// knn_pair.cu and knn.cu.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

namespace vloam_knn_detail {

constexpr int kThreads = 128;              // threads of a sweep block
constexpr int kQ = 2;                      // queries per sweep thread
constexpr int kTileQ = kThreads * kQ;      // queries per sweep block = per query box
constexpr int kTileC = 256;                // candidates per staged tile = per candidate box
constexpr int kChunk = 4;                  // candidates between two warp votes
constexpr int kBuf = 8;                    // deferred insertions a query can hold
constexpr int kScatter = 159;              // a tile's row r is staged at (r * kScatter) % kTileC
constexpr int kPreThreads = 256;
constexpr int kMergeThreads = 128;
constexpr unsigned kFullWarp = 0xffffffffu;

static_assert(kTileC == 2 * kThreads, "a sweep thread stages two candidates per tile");
static_assert(kTileC % kChunk == 0 && kBuf >= 2 * kChunk, "chunks fit tiles and buffers");
static_assert(kScatter % 2 == 1 && (kTileC & (kTileC - 1)) == 0, "the scatter is a permutation");

// One (query set, candidate set) problem and its scratch.
struct Problem {
  const float* q;            // (m, 3) queries, q_stride floats between rows
  const float* c;            // (n, 3) candidates, c_stride floats between rows
  const uint8_t* mask;       // (n,) candidate validity
  const int64_t* q_count;    // device valid-prefix length of q, or null: q_count_host
  const int64_t* c_count;    // device valid-prefix length of c, or null: c_count_host
  float* d2;                 // (m, k) out
  int64_t* idx;              // (m, k) out
  int m, n;
  int q_stride, c_stride;
  int q_count_host, c_count_host;
  int splits;                // candidate splits per query tile
  float r2;                  // squared radius; +inf: none
  int c_step;                // the pilot's candidate j is row j * c_step (elsewhere 1)
  int k;
  float* cbox;               // (c_tiles, 12): masked rows' lo, hi; live rows' lo, hi
  float* qbox;               // (q_tiles, 6): live rows' lo, hi
  int* flags;                // (q_tiles, splits): 1 where a list was written
  float* part_d;             // (splits, k, m) the splits' lists
  int* part_j;
  float* tau;                // null, or the pilot's (m, k) group minima (a row's largest bounds)
  int* stats;                // null, or (2,): tile steps swept, tile steps skipped
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ int live_count(const int64_t* ptr, int host, int total) {
  const int64_t v = ptr ? *ptr : static_cast<int64_t>(host);
  return v < 0 ? 0 : (v > total ? total : static_cast<int>(v));
}

// Where a problem's scratch arrays start, from ``off`` (a multiple of 16).
struct Layout {
  size_t cbox, qbox, flags, part_d, part_j, tau, end;
};

inline Layout scratch_layout(size_t off, int m, int n, int k, int splits, int pilot_step) {
  auto take = [&off](size_t bytes) {
    const size_t at = off;
    off += (bytes + 15) & ~static_cast<size_t>(15);
    return at;
  };
  const size_t q_tiles = ceil_div(m, kTileQ), c_tiles = ceil_div(n, kTileC);
  const size_t lists = static_cast<size_t>(k) * m;
  Layout l;
  l.cbox = take(c_tiles * 12 * sizeof(float));
  l.qbox = take(q_tiles * 6 * sizeof(float));
  l.flags = take(q_tiles * splits * sizeof(int));
  l.part_d = take(splits * lists * sizeof(float));
  l.part_j = take(splits * lists * sizeof(int));
  l.tau = take((pilot_step > 0 ? lists : 0) * sizeof(float));
  l.end = off;
  return l;
}

// Point a problem at its scratch and derive its pilot (zero queries when
// pilot_step is 0); returns the offset after it.
//
// The pilot (bound_block) goes over every pilot_step-th candidate row before
// the sweep, with the same rebase centre and the same d2, and keeps per query
// the minimum of each of k disjoint groups of them.  The largest of the k
// minima bounds the query's k-th distance from above (k different candidates
// are that near), so the sweep starts with lists that already reject nearly
// everything: of n candidates about k * ln(k) * pilot_step pass, instead of
// every split warming up a list of its own from +inf.
inline size_t bind_scratch(Problem& p, Problem& pilot, char* scratch, size_t off, int pilot_step,
                           int pilot_splits) {
  const Layout l = scratch_layout(off, p.m, p.n, p.k, p.splits, pilot_step);
  p.cbox = reinterpret_cast<float*>(scratch + l.cbox);
  p.qbox = reinterpret_cast<float*>(scratch + l.qbox);
  p.flags = reinterpret_cast<int*>(scratch + l.flags);
  p.part_d = reinterpret_cast<float*>(scratch + l.part_d);
  p.part_j = reinterpret_cast<int*>(scratch + l.part_j);
  p.tau = pilot_step > 0 ? reinterpret_cast<float*>(scratch + l.tau) : nullptr;
  pilot = p;
  if (pilot_step > 0) {
    pilot.c_step = pilot_step;
    pilot.splits = pilot_splits;
  } else {
    pilot.m = 0;
  }
  return l.end;
}

inline int prepass_blocks(const Problem& p) {
  return ceil_div(p.n, kTileC) + ceil_div(p.m, kTileQ);
}
inline int sweep_blocks(const Problem& p) { return ceil_div(p.m, kTileQ) * p.splits; }

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float dist2(float qx, float qy, float qz, const float4 c) {
  const float dx = __fsub_rn(qx, c.x);
  const float dy = __fsub_rn(qy, c.y);
  const float dz = __fsub_rn(qz, c.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Write slot s of query qi.  Unfilled slots, and with a radius slots beyond
// it, are d2 = +inf with index 0.
__device__ __forceinline__ void store_slot(const Problem& p, int qi, int k, int s, float d, int j) {
  const bool found = d < CUDART_INF_F && d <= p.r2;
  p.d2[static_cast<int64_t>(qi) * k + s] = found ? d : CUDART_INF_F;
  p.idx[static_cast<int64_t>(qi) * k + s] = found ? static_cast<int64_t>(j) : 0;
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
  __device__ __forceinline__ void store(const Problem& p, int qi) const {
#pragma unroll
    for (int s = 0; s < K; ++s) store_slot(p, qi, K, s, bd[s], bi[s]);
  }
  // (d, j) sorts before (bd, bj): nearer, or as near with the lower index.
  static __device__ __forceinline__ bool before(float d, int j, float bd, int bj) {
    return d < bd || (d == bd && j < bj);
  }
  // Insert (d, j) at its place in (d2, index) order, whatever order the
  // candidates arrive in.  Each slot takes its upper neighbour, the newcomer
  // or itself, from the old values alone, so the K updates are independent of
  // one another (a chain of compare-and-swaps would make an insertion K
  // dependent steps long).
  __device__ __forceinline__ void offer(float d, int j) {
    if (before(d, j, bd[K - 1], bi[K - 1])) {
#pragma unroll
      for (int s = K - 1; s > 0; --s) {
        const bool here = before(d, j, bd[s], bi[s]);
        const bool up = before(d, j, bd[s - 1], bi[s - 1]);
        bd[s] = up ? bd[s - 1] : (here ? d : bd[s]);
        bi[s] = up ? bi[s - 1] : (here ? j : bi[s]);
      }
      if (before(d, j, bd[0], bi[0])) {
        bd[0] = d;
        bi[0] = j;
      }
    }
  }
};

// ---- stage 1: tile boxes ---------------------------------------------------

// Blocks [0, c_tiles) take candidate tiles, the rest query tiles.
__device__ __forceinline__ void prepass_block(const Problem& p, int block) {
  __shared__ float red[kPreThreads / 32][12];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c_tiles = ceil_div(p.n, kTileC);
  // v[0..2] / v[3..5]: lo / hi of box 0; v[6..11]: of box 1
  float v[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) v[i] = (i % 6 < 3) ? CUDART_INF_F : -CUDART_INF_F;

  if (block < c_tiles) {
    const int c_n = live_count(p.c_count, p.c_count_host, p.n);
    for (int r = tid; r < kTileC; r += kPreThreads) {
      const int j = block * kTileC + r;
      if (j < p.n && p.mask[j]) {
        const float* row = p.c + static_cast<int64_t>(j) * p.c_stride;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float x = row[a];
          v[a] = fminf(v[a], x);
          v[3 + a] = fmaxf(v[3 + a], x);
          if (j < c_n) {
            v[6 + a] = fminf(v[6 + a], x);
            v[9 + a] = fmaxf(v[9 + a], x);
          }
        }
      }
    }
  } else {
    const int q_n = live_count(p.q_count, p.q_count_host, p.m);
    for (int r = tid; r < kTileQ; r += kPreThreads) {
      const int i = (block - c_tiles) * kTileQ + r;
      if (p.tau && i < p.m) {   // the pilot takes minima into these
        for (int g = 0; g < p.k; ++g) p.tau[static_cast<int64_t>(i) * p.k + g] = CUDART_INF_F;
      }
      if (i < q_n) {
        const float* row = p.q + static_cast<int64_t>(i) * p.q_stride;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float x = row[a];
          v[a] = fminf(v[a], x);
          v[3 + a] = fmaxf(v[3 + a], x);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 12; ++i) {
    for (int o = 16; o > 0; o >>= 1) {
      const float other = __shfl_xor_sync(kFullWarp, v[i], o);
      v[i] = (i % 6 < 3) ? fminf(v[i], other) : fmaxf(v[i], other);
    }
    if (lane == 0) red[warp][i] = v[i];
  }
  __syncthreads();
  const int n_out = block < c_tiles ? 12 : 6;
  if (tid < n_out) {
    float r = red[0][tid];
    for (int w = 1; w < kPreThreads / 32; ++w)
      r = (tid % 6 < 3) ? fminf(r, red[w][tid]) : fmaxf(r, red[w][tid]);
    if (block < c_tiles) {
      p.cbox[block * 12 + tid] = r;
    } else {
      p.qbox[(block - c_tiles) * 6 + tid] = r;
    }
  }
}

// The rebase centre of a problem into cen[0..2] (shared memory), from the
// candidate tiles' boxes: 0.5 * (lo + hi) of the masked rows, 0 when there
// are none.  Every thread of the block must call it; the block needs at
// least one warp.
__device__ __forceinline__ void block_center(const Problem& p, float* cen) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int c_tiles = ceil_div(p.n, kTileC);
    float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
    float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    for (int t = lane; t < c_tiles; t += 32) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = fminf(lo[a], p.cbox[t * 12 + a]);
        hi[a] = fmaxf(hi[a], p.cbox[t * 12 + 3 + a]);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      for (int o = 16; o > 0; o >>= 1) {
        lo[a] = fminf(lo[a], __shfl_xor_sync(kFullWarp, lo[a], o));
        hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFullWarp, hi[a], o));
      }
      if (lane == 0)
        cen[a] = fabsf(lo[a]) < CUDART_INF_F ? __fmul_rn(0.5f, __fadd_rn(lo[a], hi[a])) : 0.f;
    }
  }
  __syncthreads();
}

// ---- stage 1b: the pilot's bound --------------------------------------------

// One block per (query tile, candidate split) of the pilot problem.  Group g
// of a tile's candidates are its rows g, g + K, ...: a pure sweep, nine
// floating operations and a minimum per pair, no list.  The splits' minima
// meet in p.tau through integer atomicMin on the bits of the non-negative
// floats, whose result does not depend on the order.
template <int K>
__device__ __forceinline__ void bound_block(const Problem& p, int block, float4* tile,
                                            float* cen) {
  const int tid = threadIdx.x;
  const int qt = block / p.splits, split = block % p.splits;
  const int q_n = live_count(p.q_count, p.q_count_host, p.m);
  // the pilot's candidates: every c_step-th row below the candidate count
  const int c_n = ceil_div(live_count(p.c_count, p.c_count_host, p.n), p.c_step);
  if (qt * kTileQ >= q_n) return;
  const int per = ceil_div(ceil_div(c_n, p.splits), kTileC) * kTileC;
  const int c_begin = split * per;
  const int c_end = min(c_n, c_begin + per);
  if (c_begin >= c_end) return;

  block_center(p, cen);
  const float c0 = cen[0], c1 = cen[1], c2 = cen[2];
  float qx[kQ], qy[kQ], qz[kQ], lo[kQ][K];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int qi = qt * kTileQ + i * kThreads + tid;
    qx[i] = qy[i] = qz[i] = CUDART_NAN_F;   // fminf ignores what a dead query yields
    if (qi < q_n) {
      const float* row = p.q + static_cast<int64_t>(qi) * p.q_stride;
      qx[i] = __fsub_rn(row[0], c0);
      qy[i] = __fsub_rn(row[1], c1);
      qz[i] = __fsub_rn(row[2], c2);
    }
#pragma unroll
    for (int g = 0; g < K; ++g) lo[i][g] = CUDART_INF_F;
  }

  for (int base = c_begin; base < c_end; base += kTileC) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = u * kThreads + tid, gj = base + r;
      const int64_t at = static_cast<int64_t>(gj) * p.c_step;
      float4 v = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.f);
      if (gj < c_end && p.mask[at]) {
        const float* row = p.c + at * p.c_stride;
        v.x = __fsub_rn(row[0], c0);
        v.y = __fsub_rn(row[1], c1);
        v.z = __fsub_rn(row[2], c2);
      }
      tile[r] = v;
    }
    __syncthreads();
    for (int j = 0; j + K <= kTileC; j += K) {
#pragma unroll
      for (int g = 0; g < K; ++g) {
        const float4 c = tile[j + g];
#pragma unroll
        for (int i = 0; i < kQ; ++i) lo[i][g] = fminf(lo[i][g], dist2(qx[i], qy[i], qz[i], c));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int qi = qt * kTileQ + i * kThreads + tid;
    if (qi < q_n) {
#pragma unroll
      for (int g = 0; g < K; ++g) {
        if (lo[i][g] < CUDART_INF_F)
          atomicMin(reinterpret_cast<int*>(p.tau) + static_cast<int64_t>(qi) * K + g,
                    __float_as_int(lo[i][g]));
      }
    }
  }
}

// ---- stage 2: the sweep ----------------------------------------------------

struct SweepSmem {
  float4 tile[2][kTileC];               // rebased candidates, masked -> +inf
  float raw[2][6][kThreads];            // cp.async ring: this thread's two candidates, raw
  float2 buf[kBuf * kQ][kThreads];      // deferred insertions (d2, index bits), slot-major
  float cen[3];
};

// A query of a sweep thread: its rebased coordinates, the bar no distance of
// use exceeds, the distance the fast path tests against (its k-th, or the
// bar if that is nearer), its list and how many insertions wait in its buffer.
template <int K>
struct SweepQuery {
  float x, y, z, bar, kth;
  int cnt;
  RegTopK<K> best;
};

// Empty every buffer of this thread into its lists and refresh the distances
// the fast path tests against.
template <int K>
__device__ __forceinline__ void drain(SweepSmem& sm, SweepQuery<K> (&q)[kQ]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    for (int e = 0; e < q[i].cnt; ++e) {
      const float2 v = sm.buf[e * kQ + i][tid];
      q[i].best.offer(v.x, __float_as_int(v.y));
    }
    q[i].cnt = 0;
    q[i].kth = fminf(q[i].best.bd[K - 1], q[i].bar);
  }
}

template <int K>
__device__ __forceinline__ void sweep_block(const Problem& p, int block, SweepSmem& sm) {
  const int tid = threadIdx.x;
  const int qt = block / p.splits, split = block % p.splits;
  const int q_n = live_count(p.q_count, p.q_count_host, p.m);
  const int c_n = live_count(p.c_count, p.c_count_host, p.n);
  if (qt * kTileQ >= q_n) return;   // the merge never reads a dead query tile

  // this split's candidates: whole tiles, so the splits share no box
  const int per = ceil_div(ceil_div(c_n, p.splits), kTileC) * kTileC;
  const int c_begin = split * per;
  const int c_end = min(c_n, c_begin + per);
  int* flag = p.flags + qt * p.splits + split;
  if (c_begin >= c_end) {
    if (tid == 0) *flag = 0;
    return;
  }

  block_center(p, sm.cen);
  const float c0 = sm.cen[0], c1 = sm.cen[1], c2 = sm.cen[2];

  const bool prune = p.r2 < CUDART_INF_F;
  float qlo[3] = {0.f, 0.f, 0.f}, qhi[3] = {0.f, 0.f, 0.f};
  if (prune) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      qlo[a] = __fsub_rn(p.qbox[qt * 6 + a], sm.cen[a]);
      qhi[a] = __fsub_rn(p.qbox[qt * 6 + 3 + a], sm.cen[a]);
    }
  }
  // Squared distance between the query tile's box and candidate tile t's, in
  // the rebased frame and in dist2's operation order; an empty box is
  // (+inf, -inf) and lies infinitely far.
  auto survives = [&](int t) -> bool {
    if (!prune) return true;
    const float* b = p.cbox + t * 12 + 6;
    float g2[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float clo = __fsub_rn(b[a], sm.cen[a]);
      const float chi = __fsub_rn(b[3 + a], sm.cen[a]);
      const float gap = fmaxf(0.f, fmaxf(__fsub_rn(qlo[a], chi), __fsub_rn(clo, qhi[a])));
      g2[a] = __fmul_rn(gap, gap);
    }
    return !(__fadd_rn(__fadd_rn(g2[0], g2[1]), g2[2]) > p.r2);
  };
  const int t_end = ceil_div(c_end, kTileC);
  int swept = 0, skipped = 0;
  auto next_tile = [&](int t) -> int {
    while (t < t_end && !survives(t)) {
      ++t;
      ++skipped;
    }
    return t;
  };

  // What a distance must not exceed to be worth a slot: a query's current
  // k-th, and the bar.  With a radius the bar is r2, since a slot beyond it
  // would be reported as +inf anyway (after the first few candidates hardly
  // any distance passes); without one it is the largest finite float, which
  // keeps the +inf of a masked candidate out of a list that is not full yet.
  const float bar = prune ? p.r2 : 3.402823466e38f;
  SweepQuery<K> q[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int qi = qt * kTileQ + i * kThreads + tid;
    // a query past the count is NaN: no distance to it ever passes a test
    q[i].x = q[i].y = q[i].z = CUDART_NAN_F;
    q[i].bar = bar;
    if (qi < q_n) {
      const float* row = p.q + static_cast<int64_t>(qi) * p.q_stride;
      q[i].x = __fsub_rn(row[0], c0);
      q[i].y = __fsub_rn(row[1], c1);
      q[i].z = __fsub_rn(row[2], c2);
      if (p.tau) {   // the pilot's bound lowers the bar: no farther candidate ends up among the k
        float bound = 0.f;
#pragma unroll
        for (int g = 0; g < K; ++g) bound = fmaxf(bound, p.tau[static_cast<int64_t>(qi) * K + g]);
        q[i].bar = fminf(bar, bound);
      }
    }
    q[i].best.init();
    q[i].kth = q[i].bar;
    q[i].cnt = 0;
  }

  // Start the copy of this thread's two candidates of tile t into ring slot
  // s; ok[u] says whether candidate u is live (inside the split and unmasked).
  auto fetch = [&](int t, int s, bool (&ok)[2]) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int gj = t * kTileC + u * kThreads + tid;
      ok[u] = gj < c_end && p.mask[gj];
      if (gj < c_end) {
        const float* row = p.c + static_cast<int64_t>(gj) * p.c_stride;
#pragma unroll
        for (int a = 0; a < 3; ++a) cp_async4(&sm.raw[s][u * 3 + a][tid], row + a);
      }
    }
  };

  int t = next_tile(c_begin / kTileC);
  bool ok_cur[2] = {false, false}, ok_next[2] = {false, false};
  if (t < t_end) fetch(t, 0, ok_cur);
  cp_async_commit();
  int s = 0;
  while (t < t_end) {
    const int t_next = next_tile(t + 1);
    if (t_next < t_end) fetch(t_next, s ^ 1, ok_next);
    cp_async_commit();       // an empty group keeps the count of groups in step
    cp_async_wait<1>();      // this thread's part of tile t has landed; nobody else reads it
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = u * kThreads + tid;   // the candidate's row in the tile, kept in .w
      float4 v = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, __int_as_float(r));
      if (ok_cur[u]) {
        v.x = __fsub_rn(sm.raw[s][u * 3 + 0][tid], c0);
        v.y = __fsub_rn(sm.raw[s][u * 3 + 1][tid], c1);
        v.z = __fsub_rn(sm.raw[s][u * 3 + 2][tid], c2);
      }
      sm.tile[s][(r * kScatter) % kTileC] = v;
    }
    // One barrier a tile is enough: tile[s] was last swept two iterations
    // ago, and a warp passes the barrier in between only after that sweep.
    __syncthreads();

    const float4* tile = sm.tile[s];
    const int base = t * kTileC;
    for (int j = 0; j < kTileC; j += kChunk) {
      float4 c[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) c[u] = tile[j + u];
      float d[kQ][kChunk];
      bool hit = false;
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          d[i][u] = dist2(q[i].x, q[i].y, q[i].z, c[u]);
          hit |= d[i][u] <= q[i].kth;
        }
      }
      if (__any_sync(kFullWarp, hit)) {
        bool full = false;
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            if (d[i][u] <= q[i].kth) {
              sm.buf[q[i].cnt * kQ + i][tid] =
                  make_float2(d[i][u], __int_as_float(base + __float_as_int(c[u].w)));
              ++q[i].cnt;
            }
          }
          full |= q[i].cnt > kBuf - kChunk;
        }
        if (__any_sync(kFullWarp, full)) drain(sm, q);
      }
    }
    ++swept;
    t = t_next;
    s ^= 1;
    ok_cur[0] = ok_next[0];
    ok_cur[1] = ok_next[1];
  }
  cp_async_wait<0>();
  drain(sm, q);

  if (tid == 0) {
    *flag = swept > 0;
    if (p.stats) {
      atomicAdd(p.stats, swept);
      atomicAdd(p.stats + 1, skipped);
    }
  }
  if (swept == 0) return;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int qi = qt * kTileQ + i * kThreads + tid;
    if (qi < q_n) {
#pragma unroll
      for (int e = 0; e < K; ++e) {
        const size_t at = (static_cast<size_t>(split) * K + e) * p.m + qi;
        p.part_d[at] = q[i].best.bd[e];
        p.part_j[at] = q[i].best.bi[e];
      }
    }
  }
}

// ---- stage 3: the merge ----------------------------------------------------

// kMergeGroups threads per query.  The splits hold ascending candidate ranges
// and each list is sorted by (d2, index); they are offered in split order, so
// a head that does not beat the k-th strictly cannot enter (an equal one has
// the higher index).  A thread alone would be one long chain of loads from
// L2: so thread g of a query merges the g-th run of consecutive splits,
// asking for kMergeAhead lists' heads at once and dropping a list whose head
// cannot enter (then nothing behind it can), and group 0 then merges the
// groups' lists, in group order, from shared memory.
constexpr int kMergeGroups = 8;
constexpr int kMergeQueries = kMergeThreads / kMergeGroups;   // queries per merge block
constexpr int kMergeAhead = 8;
static_assert(kTileQ % kMergeQueries == 0, "a merge block lies inside one query tile");

template <int KMAX>
struct MergeSmem {
  float d[kMergeGroups][KMAX][kMergeQueries];
  int j[kMergeGroups][KMAX][kMergeQueries];
};

inline int merge_blocks(const Problem& p) { return ceil_div(p.m, kMergeQueries); }

template <int K, int KMAX>
__device__ __forceinline__ void merge_block(const Problem& p, int block, MergeSmem<KMAX>& sm) {
  const int g = threadIdx.x / kMergeQueries, ql = threadIdx.x % kMergeQueries;
  const int qi = block * kMergeQueries + ql;
  const int q_n = live_count(p.q_count, p.q_count_host, p.m);
  RegTopK<K> best;
  best.init();
  if (qi < q_n) {
    const int* flags = p.flags + (qi / kTileQ) * p.splits;
    const size_t list = static_cast<size_t>(K) * p.m;   // one split's entries
    const int per = ceil_div(p.splits, kMergeGroups);
    const int s_end = min(p.splits, (g + 1) * per);
    for (int s0 = g * per; s0 < s_end; s0 += kMergeAhead) {
      // which of the next kMergeAhead lists have a head that can enter now
      // (the k-th only falls, so the others never will)
      unsigned open = 0;
#pragma unroll
      for (int u = 0; u < kMergeAhead; ++u) {
        const int s = s0 + u;
        const float head = (s < s_end && flags[s]) ? p.part_d[s * list + qi] : CUDART_INF_F;
        open |= (head < best.bd[K - 1] ? 1u : 0u) << u;
      }
      while (open) {   // one copy of the insertion code, not kMergeAhead * K of them
        const int u = __ffs(open) - 1;
        open &= open - 1;
        const size_t at = (s0 + u) * list + qi;
        float d[K];
        int j[K];
#pragma unroll
        for (int e = 0; e < K; ++e) {
          d[e] = p.part_d[at + static_cast<size_t>(e) * p.m];
          j[e] = p.part_j[at + static_cast<size_t>(e) * p.m];
        }
#pragma unroll
        for (int e = 0; e < K; ++e) {
          if (!(d[e] < best.bd[K - 1])) break;   // nor can anything behind it
          best.offer(d[e], j[e]);
        }
      }
    }
  }
  if (g > 0) {
#pragma unroll
    for (int e = 0; e < K; ++e) {
      sm.d[g][e][ql] = best.bd[e];
      sm.j[g][e][ql] = best.bi[e];
    }
  }
  __syncthreads();
  if (g == 0 && qi < p.m) {
    for (int g2 = 1; g2 < kMergeGroups; ++g2) {
#pragma unroll
      for (int e = 0; e < K; ++e) {
        const float d = sm.d[g2][e][ql];
        if (!(d < best.bd[K - 1])) break;
        best.offer(d, sm.j[g2][e][ql]);
      }
    }
    best.store(p, qi);
  }
}

}  // namespace vloam_knn_detail
