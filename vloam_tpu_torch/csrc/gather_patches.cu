// Patch gather for the KLT tracker: the (P, P) window img[cy:cy+P, cx:cx+P]
// at every corner of two images, in one launch.
//
// Replaces: vloam_tpu/ops/pallas_gather.py, _gather_stacked_tpu (:57-112),
// launched at :108 by gather_patches_pair (:153-178), which the KLT levels
// call at image_ops.py:375 and :453.
//
// What bounds it on Hopper: memory traffic, and little of it.  At the main
// path's size (N = 1024 corners per image, P = 32) one launch writes 2 x
// 1024 x 32 x 32 floats (8.4 MB) and reads the image floats under the
// windows (at frame 15 of the validation course 57 % of the two 376 x 1248
// images, 2.1 MB; overlapping windows read them again from L2): 0.00315 ms
// of HBM.  Launch latency is of the same order.
//
// Design: an exact copy with none of the TPU's tricks (no 128-lane DMA
// bands, lane roll or sublane select, no padded image, no blocking of the
// corners).  A warp a patch: warp j < n takes patch j of image a, the rest
// patch j - n of image b, read by pointer (no stacked copy of the two
// images).  It runs gather::warp_copy_window: lane l copies column l of the
// patch and loads all 32 of its rows into registers before it stores any,
// so a lane has 32 loads in flight and a patch pays the copy's latency once,
// not once a row; each row is one 128-byte warp access each way.  The side
// is a compile-time constant for P = 32 (every caller's); another P takes
// the run-time instantiation, in 32-column chunks, 32 rows a batch.  The
// corners arrive pre-clipped to [0, W-P] x [0, H-P] (the caller's contract,
// pallas_gather.py:155-157): the kernel clamps nothing, and a device assert
// traps a corner outside its image.  Times: PERF.md, kernel table, B2.
//
// A second entry, vloam_gather_patches_stack, is the stacked form the TPU
// kernel has: imgs (n_img, H, W), one image id per patch, (n_img * n, P, P)
// out.  Both of its callers (one image; a blur stack of one octave) cut every
// corner from every image, so the id of patch j is j / n and its corner is
// j % n: no id array is built or read.  It runs the same warp a patch.  A
// TMA tiled load of the box at (cx, cy) into a ring of shared memory with
// one bulk store a patch (G7's design) stops on an illegal instruction: a
// tiled copy's innermost start must lie on 16 bytes, and cx is any column.

#include <assert.h>
#include <cuda_runtime.h>

#include "gather_common.cuh"

namespace {

constexpr int kPatchWarps = 8;   // patches a block, a warp each (both forms)

// Patch j = img_id * n + k of the n_img * n is warp j's.  kSide: the patch
// side when fixed at compile time, or 0 to take p.
template <int kSide>
__global__ void __launch_bounds__(kPatchWarps * 32)
gather_stack_kernel(const float* __restrict__ imgs, int h, int w,
                    const int* __restrict__ corners, int n, int total, int p_run,
                    float* __restrict__ out) {
  const int p = kSide > 0 ? kSide : p_run;
  const int j = static_cast<int>(blockIdx.x) * kPatchWarps + (threadIdx.x >> 5);
  if (j >= total) return;
  const int lane = threadIdx.x & 31;
  const int img_id = j / n, k = j - img_id * n;
  const int cx = corners[2 * k];
  const int cy = corners[2 * k + 1];
  assert(cx >= 0 && cy >= 0 && cx + p <= w && cy + p <= h);
  gather::warp_copy_window<kSide>(imgs + (static_cast<size_t>(img_id) * h + cy) * w + cx, w,
                                  out + static_cast<size_t>(j) * p * p, p, lane);
}

// Patch j < n is patch j of image a, patch n + k patch k of image b: warp j's.
template <int kSide>
__global__ void __launch_bounds__(kPatchWarps * 32)
gather_pair_kernel(const float* __restrict__ img_a, int ha, int wa,
                   const float* __restrict__ img_b, int hb, int wb,
                   const int* __restrict__ corners_a, const int* __restrict__ corners_b,
                   int n, int p_run, float* __restrict__ out_a, float* __restrict__ out_b) {
  const int p = kSide > 0 ? kSide : p_run;
  const int j = static_cast<int>(blockIdx.x) * kPatchWarps + (threadIdx.x >> 5);
  if (j >= 2 * n) return;
  const bool second = j >= n;
  const int k = second ? j - n : j;
  const float* img = second ? img_b : img_a;
  const int h = second ? hb : ha;
  const int w = second ? wb : wa;
  const int* corners = second ? corners_b : corners_a;
  const int cx = corners[2 * k];
  const int cy = corners[2 * k + 1];
  assert(cx >= 0 && cy >= 0 && cx + p <= w && cy + p <= h);
  gather::warp_copy_window<kSide>(img + static_cast<size_t>(cy) * w + cx, w,
                                  (second ? out_b : out_a) + static_cast<size_t>(k) * p * p, p,
                                  threadIdx.x & 31);
}

}  // namespace

// img_a (ha, wa), img_b (hb, wb): row-major f32; corners_a, corners_b: (n, 2)
// int32 (x, y); out_a, out_b: (n, p, p) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int vloam_gather_patches(const float* img_a, int ha, int wa, const float* img_b,
                                    int hb, int wb, const int* corners_a, const int* corners_b,
                                    int n, int p, float* out_a, float* out_b, void* stream) {
  if (n > 0) {
    auto kernel = p == 32 ? gather_pair_kernel<32> : gather_pair_kernel<0>;
    kernel<<<(2 * n + kPatchWarps - 1) / kPatchWarps, kPatchWarps * 32, 0,
             static_cast<cudaStream_t>(stream)>>>(img_a, ha, wa, img_b, hb, wb, corners_a,
                                                  corners_b, n, p, out_a, out_b);
  }
  return static_cast<int>(cudaGetLastError());
}

// imgs (n_img, h, w): row-major f32; corners: (n, 2) int32 (x, y), shared by
// every image; out: (n_img, n, p, p) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int vloam_gather_patches_stack(const float* imgs, int n_img, int h, int w,
                                          const int* corners, int n, int p, float* out,
                                          void* stream) {
  const int total = n_img * n;
  if (total > 0) {
    auto kernel = p == 32 ? gather_stack_kernel<32> : gather_stack_kernel<0>;
    kernel<<<(total + kPatchWarps - 1) / kPatchWarps, kPatchWarps * 32, 0,
             static_cast<cudaStream_t>(stream)>>>(imgs, h, w, corners, n, total, p, out);
  }
  return static_cast<int>(cudaGetLastError());
}
