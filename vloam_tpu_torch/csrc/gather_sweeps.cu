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
// What bounds them: bytes.  A sweep reads 88 strips of 40 x 1408 f32
// (19.8 MB) and writes a few floats; whole_image reads 4.3 MB ten times.
// Both images fit in the 50 MB L2, so once they are there the repeats and
// the overlapping strips are served from L2, not from HBM.
//
// Design.  As on the TPU the data passes through on-chip memory: every strip
// is staged in shared memory and reduced from there (the reduction reads
// another thread's element than the one it staged, so the round trip is
// real).  One strip (225,280 bytes) just fits a block's shared memory, two do
// not, so the unit in flight is a row chunk of a strip, contiguous in the
// padded image, and the variants differ in how chunks are kept in flight:
//   sweep_sync     one 8-row chunk: 16-byte loads, store to shared memory,
//                  __syncthreads(), reduce, repeat; nothing overlaps;
//   sweep_ring2    a two-slot cp.async ring of 8-row chunks: chunk i+1 is in
//                  flight while chunk i is reduced; one block per strip;
//   sweep_ring11   an eleven-slot ring of 2-row chunks (eleven fit), eleven
//                  strips to a block, 8 blocks: few workers, deep queues;
//   sweep_ring11_flat  the same ring addressed through the (n_img * H_pad,
//                  W_pad) 2-D view: index arithmetic only on this machine;
//   whole_image    no staging: a grid-stride sweep with 16-byte loads, the
//                  card's plain read rate; blocks meet in an atomic maximum.

#include <algorithm>

#include "gather_common.cuh"

namespace {

using namespace gather;

constexpr int kThreads = 256;
constexpr int kSyncRows = 8;     // sweep_sync and sweep_ring2: 5 chunks a strip
constexpr int kDeepRows = 2;     // sweep_ring11: 20 chunks a strip
constexpr int kDeep = 11;        // ring depth and strips per block of sweep_ring11

__global__ void __launch_bounds__(kThreads)
sweep_sync_kernel(const float* __restrict__ imgs, int h_pad, int w, int n_bases,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int strip = blockIdx.x;
  const int b = strip / n_bases, base = 8 * (strip % n_bases);
  const float4* src =
      reinterpret_cast<const float4*>(imgs + (static_cast<size_t>(b) * h_pad + base) * w);
  float4* buf = reinterpret_cast<float4*>(smem);
  const int chunk4 = kSyncRows * w / 4;
  float m = -INFINITY;
  for (int c = 0; c < kP8 / kSyncRows; ++c) {
    for (int i = threadIdx.x; i < chunk4; i += kThreads) buf[i] = src[c * chunk4 + i];
    __syncthreads();
    for (int i = threadIdx.x; i < chunk4; i += kThreads) m = max4(m, buf[chunk4 - 1 - i]);
    __syncthreads();
  }
  m = block_max(m);
  if (threadIdx.x == 0) out[strip] = m;
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

template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int DEPTH, int ROWS, bool FLAT>
int launch_ring(const float* src, int n_img, int h_pad, int w, int strips_per_block, float* out,
                void* stream) {
  const int n_bases = (h_pad - kP8) / 8 + 1;
  const int strips = n_img * n_bases;
  if (w % 4 != 0 || strips % strips_per_block != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = DEPTH * ROWS * w * 4;
  auto kernel = sweep_ring_kernel<DEPTH, ROWS, FLAT>;
  const int rc = allow_smem(kernel, bytes);
  if (rc != 0) return rc;
  kernel<<<strips / strips_per_block, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      src, h_pad, w, n_bases, strips_per_block, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All sweeps: imgs (n_img, h_pad, w) row-major f32, the padded images (w a
// multiple of 4, so every row starts on 16 bytes); n_bases = (h_pad-40)/8 + 1
// strips per image.  Each returns the first CUDA error of its set-up and launch.

// out: (n_img * n_bases,) f32.
extern "C" int vloam_sweep_sync(const float* imgs, int n_img, int h_pad, int w, float* out,
                                void* stream) {
  if (w % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_bases = (h_pad - gather::kP8) / 8 + 1;
  const int bytes = kSyncRows * w * 4;
  const int rc = allow_smem(sweep_sync_kernel, bytes);
  if (rc != 0) return rc;
  sweep_sync_kernel<<<n_img * n_bases, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      imgs, h_pad, w, n_bases, out);
  return static_cast<int>(cudaGetLastError());
}

// out: (n_img * n_bases,) f32.
extern "C" int vloam_sweep_ring2(const float* imgs, int n_img, int h_pad, int w, float* out,
                                 void* stream) {
  return launch_ring<2, kSyncRows, false>(imgs, n_img, h_pad, w, 1, out, stream);
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
