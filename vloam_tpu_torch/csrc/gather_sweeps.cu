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
//   sweep_sync, sweep_ring2   one f32 per strip (n_img * n_bases of them),
//                             the maximum over the whole strip
//                             padded[b, base:base+40, :];
//   sweep_ring11 (+ _flat)    one f32 per group of 11 consecutive strips:
//                             the 11 strip maxima added in order;
//   whole_image               one f32 per repeat: the maximum of both images.
//
// What bounds them: bytes.  The function's inputs are the two padded images
// (4.3 MB) and its outputs a few floats, but by its definition a sweep reads
// 88 strips of 40 x 1408 f32 (19.8 MB) and whole_image the images ten times
// (43.3 MB).  Both images fit in the 50 MB L2, so once they are there the
// repeats and the overlapping strips are served from L2, not from HBM.
//
// Design.  As on the TPU the data passes through on-chip memory: every strip
// is staged in shared memory and reduced from there (the reduction reads
// another thread's element than the one it staged, so the round trip is
// real).  One strip (225,280 bytes) just fits a block's shared memory, two do
// not, so the ring variants keep row chunks of a strip, contiguous in the
// padded image, in flight, and G1 splits each strip over a cluster:
//   sweep_sync     a cluster of 4 CTAs a strip, each its 40 x (w/4) column
//                  slice (56,320 bytes at w = 1408): 16-byte loads, store to
//                  shared memory, __syncthreads(), reduce; nothing is in
//                  flight across the barrier, as on the TPU, where the whole
//                  strip is copied, waited for, then reduced.  352 CTAs, four
//                  an SM, all resident at once; the four partial maxima meet
//                  in rank 0's shared memory (distributed shared memory) and
//                  rank 0 writes the strip's maximum.  It still reads every
//                  strip in full: 19.8 MB, 4.6x the images;
//   sweep_ring2    a two-slot cp.async ring of 8-row chunks: chunk i+1 is in
//                  flight while chunk i is reduced; one block per strip;
//   sweep_ring11   an eleven-slot ring of 2-row chunks (eleven fit), eleven
//                  strips to a block, 8 blocks: few workers, deep queues;
//   sweep_ring11_flat  the same ring addressed through the (n_img * H_pad,
//                  W_pad) 2-D view: index arithmetic only on this machine;
//   whole_image    no staging: a grid-stride sweep with 16-byte loads, the
//                  card's plain read rate; blocks meet in an atomic maximum.

#include <cooperative_groups.h>

#include <algorithm>

#include "gather_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gather;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlices = 4;       // sweep_sync: CTAs of a strip's cluster, a column slice each
constexpr int kRingRows = 8;     // sweep_ring2: 5 chunks a strip
constexpr int kDeepRows = 2;     // sweep_ring11: 20 chunks a strip
constexpr int kDeep = 11;        // ring depth and strips per block of sweep_ring11
static_assert(kP8 % kWarps == 0, "sweep_sync: each warp stages the same number of rows");

// G1's shared memory for images w wide: one CTA's 40 x (w / 4) slice.
int sync_smem(int w) { return kP8 * (w / kSlices) * 4; }

// The cluster's CTAs split the strip by columns; each stages its slice
// synchronously (warp v copies rows v, v + 8, ..., a 16-byte load a lane and
// column step, every row's loads issued before its stores) and reduces it.
__global__ void __cluster_dims__(kSlices, 1, 1) __launch_bounds__(kThreads)
sweep_sync_kernel(const float* __restrict__ imgs, int h_pad, int w, int n_bases,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float part[kSlices];   // rank 0's: the slices' maxima, pushed by their CTAs
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  // every CTA of the cluster has started before any pushes into rank 0 (waited
  // for below, long after it was reached)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
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
  m = block_max(m);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x == 0) *cluster.map_shared_rank(&part[rank], 0) = m;
  cluster.sync();   // the pushes have landed
  if (rank == 0 && threadIdx.x == 0) {
    float s = part[0];
#pragma unroll
    for (int r = 1; r < kSlices; ++r) s = fmaxf(s, part[r]);
    out[strip] = s;
  }
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

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  // the bits of non-negative floats order as signed ints, those of negative
  // floats in reverse as unsigned ints; *addr starts at -inf
  if (v >= 0.0f) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
  }
}

__global__ void __launch_bounds__(kThreads)
whole_image_kernel(const float4* __restrict__ img, int n4, float* __restrict__ out) {
  float m = -INFINITY;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n4; i += gridDim.x * kThreads)
    m = max4(m, img[i]);
  m = block_max(m);
  if (threadIdx.x == 0) atomic_max_float(out + blockIdx.y, m);
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

}  // namespace

// Once, when the library is loaded (kernels.lib() calls it): every staged
// sweep may take all of a block's shared memory beside its static part
// (block_max's).  No launch sets a kernel attribute.
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
  if (rc == 0) rc = allow(sweep_ring_kernel<2, kRingRows, false>);
  if (rc == 0) rc = allow(sweep_ring_kernel<kDeep, kDeepRows, false>);
  if (rc == 0) rc = allow(sweep_ring_kernel<kDeep, kDeepRows, true>);
  return rc;
}

// All sweeps: imgs (n_img, h_pad, w) row-major f32, the padded images (w a
// multiple of 4, so every row starts on 16 bytes; G1 wants a multiple of 16,
// so that each of its four slices does); n_bases = (h_pad-40)/8 + 1 strips
// per image.  Each returns the first CUDA error of its launch.

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
extern "C" int vloam_sweep_ring2(const float* imgs, int n_img, int h_pad, int w, float* out,
                                 void* stream) {
  return launch_ring<2, kRingRows, false>(imgs, n_img, h_pad, w, 1, out, stream);
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

// img2d: (n_floats,) f32 with n_floats a multiple of 4; out: (reps,) f32,
// filled with -inf by the caller.
extern "C" int vloam_whole_image(const float* img2d, int n_floats, int reps, float* out,
                                 void* stream) {
  if (n_floats % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n4 = n_floats / 4;
  const int blocks = std::min((n4 + kThreads - 1) / kThreads, 1056);   // 8 blocks an SM
  whole_image_kernel<<<dim3(blocks, reps), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(img2d), n4, out);
  return static_cast<int>(cudaGetLastError());
}
