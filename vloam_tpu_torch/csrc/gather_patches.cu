// Patch gather for the KLT tracker: the (P, P) window img[cy:cy+P, cx:cx+P]
// at every corner of two images, in one launch.
//
// Replaces: vloam_tpu/ops/pallas_gather.py, _gather_stacked_tpu (:57-112),
// launched at :108 by gather_patches_pair (:153-178), which the KLT levels
// call at image_ops.py:375 and :453.
//
// What bounds it on Hopper: memory traffic, and little of it.  At the main
// path's size (N = 1024 corners per image, P = 32) one launch reads and
// writes 2 x 1024 x 32 x 32 floats = 8 MiB each way, a few microseconds of
// HBM bandwidth; the 376 x 1248 image (1.8 MiB) stays in L2, so the reads
// of overlapping windows hit L2.  Launch latency is of the same order.
//
// Design: an exact copy with none of the TPU's tricks (no 128-lane DMA
// bands, lane roll or sublane select, no padded image, no blocking of the
// corners).  One block per patch: blockIdx.x < N takes image a, the rest
// image b, read by pointer (no stacked copy of the two images).  The block
// is 32 x 8 threads; each warp copies whole 32-float rows, so every read
// and every write of a row is one coalesced 128-byte transaction when
// P = 32.  The corners arrive pre-clipped to [0, W-P] x [0, H-P] (the
// caller's contract, pallas_gather.py:155-157): the kernel clamps nothing,
// and a device assert traps a corner outside its image.
//
// A second entry, vloam_gather_patches_stack, is the stacked form the TPU
// kernel has: imgs (n_img, H, W), one image id per patch, (n_img * n, P, P)
// out.  Both of its callers (one image; a blur stack of one octave) cut every
// corner from every image, so the id of patch k is k / n and its corner is
// k % n: no id array is built or read.  Same block, same copy.

#include <assert.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 32;
constexpr int kRowsPerPass = 8;

__global__ void __launch_bounds__(kRowThreads * kRowsPerPass)
gather_patches_kernel(const float* __restrict__ img_a, int ha, int wa,
                      const float* __restrict__ img_b, int hb, int wb,
                      const int* __restrict__ corners_a, const int* __restrict__ corners_b,
                      int n, int p, float* __restrict__ out_a, float* __restrict__ out_b) {
  const bool second = blockIdx.x >= n;
  const int k = second ? blockIdx.x - n : blockIdx.x;
  const float* img = second ? img_b : img_a;
  const int h = second ? hb : ha;
  const int w = second ? wb : wa;
  const int* corners = second ? corners_b : corners_a;
  float* out = (second ? out_b : out_a) + static_cast<size_t>(k) * p * p;
  const int cx = corners[2 * k];
  const int cy = corners[2 * k + 1];
  assert(cx >= 0 && cy >= 0 && cx + p <= w && cy + p <= h);
  for (int r = threadIdx.y; r < p; r += kRowsPerPass) {
    const float* src = img + static_cast<size_t>(cy + r) * w + cx;
    for (int c = threadIdx.x; c < p; c += kRowThreads) out[r * p + c] = src[c];
  }
}

__global__ void __launch_bounds__(kRowThreads * kRowsPerPass)
gather_stack_kernel(const float* __restrict__ imgs, int h, int w,
                    const int* __restrict__ corners, int n, int p, float* __restrict__ out) {
  const int img_id = blockIdx.x / n;
  const int k = blockIdx.x - img_id * n;
  const float* img = imgs + static_cast<size_t>(img_id) * h * w;
  float* dst = out + static_cast<size_t>(blockIdx.x) * p * p;
  const int cx = corners[2 * k];
  const int cy = corners[2 * k + 1];
  assert(cx >= 0 && cy >= 0 && cx + p <= w && cy + p <= h);
  for (int r = threadIdx.y; r < p; r += kRowsPerPass) {
    const float* src = img + static_cast<size_t>(cy + r) * w + cx;
    for (int c = threadIdx.x; c < p; c += kRowThreads) dst[r * p + c] = src[c];
  }
}

}  // namespace

// img_a (ha, wa), img_b (hb, wb): row-major f32; corners_a, corners_b: (n, 2)
// int32 (x, y); out_a, out_b: (n, p, p) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int vloam_gather_patches(const float* img_a, int ha, int wa, const float* img_b,
                                    int hb, int wb, const int* corners_a, const int* corners_b,
                                    int n, int p, float* out_a, float* out_b, void* stream) {
  if (n > 0) {
    const dim3 block(kRowThreads, kRowsPerPass);
    gather_patches_kernel<<<2 * n, block, 0, static_cast<cudaStream_t>(stream)>>>(
        img_a, ha, wa, img_b, hb, wb, corners_a, corners_b, n, p, out_a, out_b);
  }
  return static_cast<int>(cudaGetLastError());
}

// imgs (n_img, h, w): row-major f32; corners: (n, 2) int32 (x, y), shared by
// every image; out: (n_img, n, p, p) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int vloam_gather_patches_stack(const float* imgs, int n_img, int h, int w,
                                          const int* corners, int n, int p, float* out,
                                          void* stream) {
  if (n_img * n > 0) {
    const dim3 block(kRowThreads, kRowsPerPass);
    gather_stack_kernel<<<n_img * n, block, 0, static_cast<cudaStream_t>(stream)>>>(
        imgs, h, w, corners, n, p, out);
  }
  return static_cast<int>(cudaGetLastError());
}
