// Strip sweeps: how fast can the card read the (P+8)-row full-width strips of
// the padded images that a strip-based patch gather would stream, under
// different copy disciplines?  Measurement kernels, not on the frame step.
//
// Replaces: tools/gather_experiments.py, strip_sweep (:107), strip_sweep_db
// (:143), strip_sweep_batched (:188), strip_sweep_flat (:229) and
// whole_image (:270).
//
// What they compute.  The TPU grid runs in order and every step overwrites
// one (1, 1) output, so the TPU kernels return the value of their last step
// only.  Blocks of a CUDA grid run in no order, so here every unit of work
// keeps its own result and each copy is held against the plain version:
//   sweep_sync, sweep_tma_ring  one f32 per strip (n_img * n_bases of them),
//                             the maximum over the whole strip
//                             padded[b, base:base+40, :];
//   sweep_ring11 (+ _flat)    one f32 per group of 11 consecutive strips:
//                             the 11 strip maxima added in order;
//   whole_image               one f32 per repeat: the maximum of both images.
// Every maximum propagates NaN, as jnp.max and torch.amax do (max_nan): a
// strip, group or repeat that holds a NaN gives NaN.
//
// What bounds them: bytes.  The function's inputs are the two padded images
// (4.3 MB) and its outputs a few floats, but by its definition a sweep reads
// 88 strips of 40 x 1408 f32 (19.8 MB) and whole_image the images ten times
// (43.3 MB).  Both images fit in the 50 MB L2, so once they are there the
// repeats and the overlapping strips are served from L2, not from HBM: the
// rate a sweep reaches is an L2 read rate.
//
// Design.  As on the TPU the strip sweeps pass their data through on-chip
// memory: every strip is staged in shared memory and reduced from there.  One
// strip (225,280 bytes) just fits a block's shared memory, two do not, so
// they split a strip over a cluster or keep row chunks of it in flight:
//   sweep_sync     (G1) a cluster of 4 CTAs a strip, each its 40 x (w/4)
//                  column slice (56,320 bytes at w = 1408): 16-byte loads,
//                  store to shared memory, __syncthreads(), reduce (the
//                  reduction reads another thread's element than the one it
//                  staged, so the round trip is real); nothing is in flight
//                  across the barrier, as on the TPU, where the whole strip is
//                  copied, waited for, then reduced.  352 CTAs, all resident
//                  at once; the four partial maxima meet in rank 0's shared
//                  memory (distributed shared memory) and rank 0 writes the
//                  strip's maximum;
//   sweep_tma_ring (G2) the TPU kernel's two-slot ring of make_async_copy and
//                  DMA semaphores, on Hopper's own copy engine: G1's cluster
//                  of 4 CTAs a strip, each streaming its column slice as 5
//                  chunks of 8 rows (11,264 bytes at w = 1408) through two
//                  slots.  One thread hands each chunk to the TMA, one bulk
//                  copy a row, onto its slot's mbarrier (initialised once; one
//                  expect_tx a use; waited for by phase parity); chunk j+1 is
//                  in flight while chunk j is reduced, and a slot is refilled
//                  only after a __syncthreads() says every thread has read it.
//                  No thread spends registers or instructions on the copy;
//   sweep_ring11   (G3) an eleven-slot cp.async ring of 2-row chunks (eleven
//                  fit), eleven strips to a block, 8 blocks: few workers,
//                  deep queues;
//   sweep_ring11_flat (G4) the same ring addressed through the (n_img * H_pad,
//                  W_pad) 2-D view: index arithmetic only on this machine;
//   whole_image    (G5) one launch, one cluster of 16 CTAs a repeat (160
//                  CTAs at ten repeats, all resident at once on the 132 SMs),
//                  whose CTAs read the array in 16-byte loads, cluster-stride,
//                  eight in flight a thread; the CTAs' maxima meet in rank
//                  0's shared memory, which writes out[r] once.  No fill
//                  before it, no atomics.  The TPU kernel copies the whole
//                  image into on-chip memory as one DMA a step, the largest
//                  copy there is; its counterpart here, each CTA streaming a
//                  contiguous share as bulk copies of ~30 KB through a
//                  three-slot mbarrier ring, was timed beside this read in
//                  one call and lost at every cluster size tried (8, 13, 16
//                  CTAs: 0.0112-0.0153 ms against 0.0078-0.0080): the bulk
//                  copies, like G2's, stop at 2.8-3.9 TB/s, where 16-byte
//                  loads from every thread reach 5.4-5.7 TB/s from L2.  The
//                  array is reduced once as it arrives, so staging would only
//                  add the round trip.  Clusters of 4 / 8 / 12 / 13 CTAs a
//                  repeat read 0.0159 / 0.0098 / 0.0084 / 0.0082 ms, 16
//                  0.0078-0.0080 (the sizes were timed as copies of this
//                  file with kWholeCtas changed).
//
// Rates reached, device time a call inside a replayed CUDA graph (NVIDIA
// H100 80GB HBM3, 700 W; tools/gather_experiments; PERF.md section 6): G1
// streams its 19.8 MB at 3.1-3.2 TB/s, G2 at 3.3-3.4 TB/s, G5 its 43.3 MB at
// 5.4-5.5 TB/s, G3 and G4 at 0.2 TB/s (eight blocks).

#include <cooperative_groups.h>

#include <stdint.h>

#include "gather_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gather;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlices = 4;       // sweep_sync, sweep_tma_ring: CTAs of a strip's cluster, a column slice each
constexpr int kDbRows = 8;       // sweep_tma_ring: rows of a chunk
constexpr int kDbChunks = kP8 / kDbRows;
constexpr int kDeepRows = 2;     // sweep_ring11: 20 chunks a strip
constexpr int kDeep = 11;        // ring depth and strips per block of sweep_ring11
constexpr int kWholeCtas = 16;   // whole_image: CTAs of a repeat's cluster (non-portable size)
constexpr int kWholeLoads = 8;      // whole_image: 16-byte loads in flight a thread
static_assert(kP8 % kWarps == 0, "sweep_sync: each warp stages the same number of rows");
static_assert(kP8 % kDbRows == 0, "sweep_tma_ring: a strip is whole chunks");

// G1's shared memory for images w wide: one CTA's 40 x (w / 4) slice.
int sync_smem(int w) { return kP8 * (w / kSlices) * 4; }

// G2's: two slots of kDbRows rows of one CTA's column slice.
int db_smem(int w) { return 2 * kDbRows * (w / kSlices) * 4; }

// Every CTA of the cluster has started before any pushes into rank 0's
// shared memory: arrive at entry, wait just before the push (cluster_max),
// long after it was reached.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// Each CTA's m (valid in thread 0) is pushed into part[rank] of rank 0, whose
// thread 0 writes their maximum, taken in rank order, to *dst.  Every thread
// of every CTA calls it once, after cluster_arrive.
__device__ __forceinline__ void cluster_max(float m, float* part, float* dst) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x == 0) *cluster.map_shared_rank(&part[rank], 0) = m;
  cluster.sync();   // the pushes have landed
  if (rank == 0 && threadIdx.x == 0) {
    const int n = static_cast<int>(cluster.num_blocks());
    float s = part[0];
    for (int r = 1; r < n; ++r) s = max_nan(s, part[r]);
    *dst = s;
  }
}

// The cluster's CTAs split the strip by columns; each stages its slice
// synchronously (warp v copies rows v, v + 8, ..., a 16-byte load a lane and
// column step, every row's loads issued before its stores) and reduces it.
__global__ void __cluster_dims__(kSlices, 1, 1) __launch_bounds__(kThreads)
sweep_sync_kernel(const float* __restrict__ imgs, int h_pad, int w, int n_bases,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float part[kSlices];   // rank 0's: the slices' maxima, pushed by their CTAs
  cluster_arrive();
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int strip = blockIdx.x / kSlices;
  const int b = strip / n_bases, base = 8 * (strip % n_bases);
  const int w4 = w / 4, cols4 = w4 / kSlices;   // float4 columns of a row, of a slice
  const float4* src = reinterpret_cast<const float4*>(
                          imgs + (static_cast<size_t>(b) * h_pad + base) * w) + rank * cols4;
  float4* buf = reinterpret_cast<float4*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = lane; c < cols4; c += 32) {
    float4 v[kP8 / kWarps];
#pragma unroll
    for (int j = 0; j < kP8 / kWarps; ++j) v[j] = src[(warp + kWarps * j) * w4 + c];
#pragma unroll
    for (int j = 0; j < kP8 / kWarps; ++j) buf[(warp + kWarps * j) * cols4 + c] = v[j];
  }
  __syncthreads();
  const int n4 = kP8 * cols4;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < n4; i += kThreads) m = max4(m, buf[n4 - 1 - i]);
  cluster_max(block_max(m), part, out + strip);
}

// G2: the cluster's CTAs split the strip by columns as in G1; each streams
// its slice in kDbChunks chunks of kDbRows rows through two slots, each slot
// with its own mbarrier.  Thread 0 issues a chunk as one bulk copy a row.
__global__ void __cluster_dims__(kSlices, 1, 1) __launch_bounds__(kThreads)
sweep_tma_ring_kernel(const float* __restrict__ imgs, int h_pad, int w, int n_bases,
                      float* __restrict__ out) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[2];   // slot s's chunk has landed
  __shared__ float part[kSlices];
  cluster_arrive();
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int strip = blockIdx.x / kSlices;
  const int b = strip / n_bases, base = 8 * (strip % n_bases);
  const int cols = w / kSlices, chunk = kDbRows * cols;   // floats of a slice row, of a chunk
  const float* src = imgs + (static_cast<size_t>(b) * h_pad + base) * w + rank * cols;
  if (threadIdx.x == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
  }
  __syncthreads();   // the barriers are initialised before anyone waits on them
  auto issue = [&](int j) {   // thread 0 only
    uint64_t* bar = &full[j & 1];
    float* dst = smem + (j & 1) * chunk;
    mbar_expect_tx(bar, chunk * 4);
    for (int r = 0; r < kDbRows; ++r)
      bulk_copy(dst + r * cols, src + static_cast<size_t>(j * kDbRows + r) * w, cols * 4, bar);
  };
  if (threadIdx.x == 0) {
    issue(0);
    issue(1);
  }
  float m = -INFINITY;
  for (int j = 0; j < kDbChunks; ++j) {
    mbar_wait(&full[j & 1], (j >> 1) & 1);   // the slot's (j / 2)-th use
    const float4* slot = reinterpret_cast<const float4*>(smem + (j & 1) * chunk);
    for (int i = threadIdx.x; i < chunk / 4; i += kThreads) m = max4(m, slot[i]);
    if (j + 2 < kDbChunks) {
      __syncthreads();             // every thread has read the slot
      if (threadIdx.x == 0) issue(j + 2);
    }
  }
  cluster_max(block_max(m), part, out + strip);
}

// A ring of DEPTH slots of ROWS-row chunks; the block walks strips_per_block
// consecutive strips and adds their maxima in order.  While chunk j is
// reduced, chunks j+1 .. j+DEPTH-1 are in flight.
template <int DEPTH, int ROWS, bool FLAT>
__global__ void __launch_bounds__(kThreads)
sweep_ring_kernel(const float* __restrict__ src, int h_pad, int w, int n_bases,
                  int strips_per_block, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int chunk4 = ROWS * w / 4;
  constexpr int kChunks = kP8 / ROWS;
  const int total = strips_per_block * kChunks;

  auto issue = [&](int j) {
    if (j < total) {
      const int strip = blockIdx.x * strips_per_block + j / kChunks;
      const int b = strip / n_bases, base = 8 * (strip % n_bases);
      const float* rows = FLAT ? src + static_cast<size_t>(b * h_pad + base) * w
                               : src + static_cast<size_t>(b) * h_pad * w +
                                     static_cast<size_t>(base) * w;
      const float4* g = reinterpret_cast<const float4*>(rows) + (j % kChunks) * chunk4;
      float4* s = reinterpret_cast<float4*>(smem) + (j % DEPTH) * chunk4;
      for (int i = threadIdx.x; i < chunk4; i += kThreads) cp_async16(s + i, g + i);
    }
    cp_async_commit();   // an empty group keeps the count of groups in step
  };

  for (int j = 0; j < DEPTH - 1; ++j) issue(j);
  float acc = 0.0f, m = -INFINITY;
  for (int j = 0; j < total; ++j) {
    issue(j + DEPTH - 1);          // into the slot chunk j-1 left, freed by the barrier below
    cp_async_wait<DEPTH - 1>();    // this thread's part of chunk j has landed
    __syncthreads();               // ... and everyone else's
    const float4* s = reinterpret_cast<const float4*>(smem) + (j % DEPTH) * chunk4;
    for (int i = threadIdx.x; i < chunk4; i += kThreads) m = max4(m, s[chunk4 - 1 - i]);
    __syncthreads();
    if ((j + 1) % kChunks == 0) {
      acc += block_max(m);         // meaningful in thread 0 only
      m = -INFINITY;
    }
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

// G5: repeat r is the cluster of CTAs r * kWholeCtas .. (r + 1) * kWholeCtas
// - 1.  The cluster reads the array in 16-byte units, cluster-stride: CTA
// `rank` takes units rank * kThreads + t, then kWholeCtas * kThreads further
// on, kWholeLoads loads in flight a thread.
__global__ void __launch_bounds__(kThreads)
whole_image_kernel(const float4* __restrict__ img4, int n4, float* __restrict__ out) {
  __shared__ float part[kWholeCtas];
  constexpr int stride = kWholeCtas * kThreads;
  cluster_arrive();
  cg::cluster_group cluster = cg::this_cluster();
  float m[kWholeLoads];
#pragma unroll
  for (int k = 0; k < kWholeLoads; ++k) m[k] = -INFINITY;
  int i = static_cast<int>(cluster.block_rank()) * kThreads + threadIdx.x;
  for (; i + (kWholeLoads - 1) * stride < n4; i += kWholeLoads * stride) {
    float4 v[kWholeLoads];
#pragma unroll
    for (int k = 0; k < kWholeLoads; ++k) v[k] = img4[i + k * stride];
#pragma unroll
    for (int k = 0; k < kWholeLoads; ++k) m[k] = max4(m[k], v[k]);
  }
  for (; i < n4; i += stride) m[0] = max4(m[0], img4[i]);
#pragma unroll
  for (int k = 1; k < kWholeLoads; ++k) m[0] = max_nan(m[0], m[k]);
  cluster_max(block_max(m[0]), part, out + blockIdx.x / kWholeCtas);
}

template <int DEPTH, int ROWS, bool FLAT>
int launch_ring(const float* src, int n_img, int h_pad, int w, int strips_per_block, float* out,
                void* stream) {
  const int n_bases = (h_pad - kP8) / 8 + 1;
  const int strips = n_img * n_bases;
  if (w % 4 != 0 || strips % strips_per_block != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = DEPTH * ROWS * w * 4;
  if (bytes > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  sweep_ring_kernel<DEPTH, ROWS, FLAT>
      <<<strips / strips_per_block, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
          src, h_pad, w, n_bases, strips_per_block, out);
  return static_cast<int>(cudaGetLastError());
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

// G5's launch: one cluster of kWholeCtas CTAs a repeat, reps of them.  A
// cluster larger than the portable 8 is set at launch, not by
// __cluster_dims__.
cudaLaunchConfig_t whole_config(int reps, cudaLaunchAttribute* attr, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(reps * kWholeCtas);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kWholeCtas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Once, when the library is loaded (kernels.lib() calls it): every staged
// sweep may take all of a block's shared memory beside its static part, and
// G5's cluster may be larger than the portable 8.  No launch sets a kernel
// attribute.
extern "C" int vloam_sweeps_setup() {
  auto allow = [](auto kernel) {
    cudaFuncAttributes attr;
    cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kMaxDynamicSmem - static_cast<int>(attr.sharedSizeBytes));
    return static_cast<int>(rc);
  };
  int rc = allow(sweep_sync_kernel);
  if (rc == 0) rc = allow(sweep_tma_ring_kernel);
  if (rc == 0) rc = allow(sweep_ring_kernel<kDeep, kDeepRows, false>);
  if (rc == 0) rc = allow(sweep_ring_kernel<kDeep, kDeepRows, true>);
  if (rc == 0)
    rc = static_cast<int>(cudaFuncSetAttribute(
        whole_image_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  return rc;
}

// All strip sweeps: imgs (n_img, h_pad, w) row-major f32 on 16 bytes, the
// padded images (w a multiple of 4, so every row starts on 16 bytes; G1 and
// G2 want a multiple of 16, so that each of their four slices does); n_bases
// = (h_pad-40)/8 + 1 strips per image.  Each returns the first CUDA error of
// its launch.

// out: (n_img * n_bases,) f32.
extern "C" int vloam_sweep_sync(const float* imgs, int n_img, int h_pad, int w, float* out,
                                void* stream) {
  if (w % (4 * kSlices) != 0 || sync_smem(w) > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_bases = (h_pad - kP8) / 8 + 1;
  sweep_sync_kernel<<<n_img * n_bases * kSlices, kThreads, sync_smem(w),
                      static_cast<cudaStream_t>(stream)>>>(imgs, h_pad, w, n_bases, out);
  return static_cast<int>(cudaGetLastError());
}

// out: (n_img * n_bases,) f32.
extern "C" int vloam_sweep_tma_ring(const float* imgs, int n_img, int h_pad, int w, float* out,
                                    void* stream) {
  if (w % (4 * kSlices) != 0 || db_smem(w) > kMaxDynamicSmem || misaligned(imgs))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_bases = (h_pad - kP8) / 8 + 1;
  sweep_tma_ring_kernel<<<n_img * n_bases * kSlices, kThreads, db_smem(w),
                          static_cast<cudaStream_t>(stream)>>>(imgs, h_pad, w, n_bases, out);
  return static_cast<int>(cudaGetLastError());
}

// out: (n_img * n_bases / 11,) f32; n_img * n_bases must be a multiple of 11.
extern "C" int vloam_sweep_ring11(const float* imgs, int n_img, int h_pad, int w, float* out,
                                  void* stream) {
  return launch_ring<kDeep, kDeepRows, false>(imgs, n_img, h_pad, w, kDeep, out, stream);
}

// img2d: the same memory seen as (n_img * h_pad, w).
extern "C" int vloam_sweep_ring11_flat(const float* img2d, int n_img, int h_pad, int w,
                                       float* out, void* stream) {
  return launch_ring<kDeep, kDeepRows, true>(img2d, n_img, h_pad, w, kDeep, out, stream);
}

// G5.  img2d: (n_floats,) f32 on 16 bytes, n_floats a multiple of 4; out:
// (reps,) f32, each written once, by the rank 0 of its repeat's cluster.
extern "C" int vloam_whole_image(const float* img2d, int n_floats, int reps, float* out,
                                 void* stream) {
  if (n_floats % 4 != 0 || reps < 1 || misaligned(img2d))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = whole_config(reps, &attr, stream);
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, whole_image_kernel,
                                            reinterpret_cast<const float4*>(img2d), n_floats / 4,
                                            out);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

// How many of G5's clusters the card can hold at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
extern "C" int vloam_whole_image_clusters() {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = whole_config(1, &attr, nullptr);
  int n = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveClusters(&n, whole_image_kernel, &cfg);
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}
