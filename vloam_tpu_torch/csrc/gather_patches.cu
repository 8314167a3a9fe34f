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
// corner from every image, so the id of patch j is j / n and its corner is
// j % n: no id array is built or read.
//
// Its design: a warp a patch.  Lane l copies column l of the patch, and
// loads all 32 of its rows into registers before it stores any, so a lane
// has 32 loads in flight and a patch pays the copy's latency once, not once
// a row; each row is one 128-byte warp access each way.  What bounds it is
// bytes: at the ORB frontend's 1024 corners of a 376 x 1248 image, 1.9 MB
// of image (from L2 after the first windows) and 4.2 MB of patches, 0.00181
// ms of HBM.  The pair form's block of 256 threads a patch, which this form
// shared before, reached 43-46 % of that bound here (NVIDIA H100 80GB HBM3,
// 700 W; tools/gather_experiments, PERF.md); a TMA tiled load of
// the box at (cx, cy) into a ring of shared memory with one bulk store a
// patch (G7's design) stops on an illegal instruction: a tiled copy's
// innermost start must lie on 16 bytes, and cx is any column.  The side is
// a compile-time constant for P = 32 (every caller's; with P read at run
// time the same copy ran 13 % slower); another P takes the run-time
// instantiation, in 32-column chunks, 32 rows a batch.

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

constexpr int kStackWarps = 8;      // patches a block of the stacked form, a warp each
constexpr int kRowsInFlight = 32;   // rows a lane loads before it stores

// Patch j = img_id * n + k of the n_img * n is warp j's.  kSide: the patch
// side when fixed at compile time, or 0 to take p.
template <int kSide>
__global__ void __launch_bounds__(kStackWarps * 32)
gather_stack_kernel(const float* __restrict__ imgs, int h, int w,
                    const int* __restrict__ corners, int n, int total, int p_run,
                    float* __restrict__ out) {
  const int p = kSide > 0 ? kSide : p_run;
  const int j = static_cast<int>(blockIdx.x) * kStackWarps + (threadIdx.x >> 5);
  if (j >= total) return;
  const int lane = threadIdx.x & 31;
  const int img_id = j / n, k = j - img_id * n;
  const int cx = corners[2 * k];
  const int cy = corners[2 * k + 1];
  assert(cx >= 0 && cy >= 0 && cx + p <= w && cy + p <= h);
  const float* src = imgs + (static_cast<size_t>(img_id) * h + cy) * w + cx;
  float* dst = out + static_cast<size_t>(j) * p * p;
  for (int c = lane; c - lane < p; c += 32) {
    for (int r0 = 0; r0 < p; r0 += kRowsInFlight) {
      float v[kRowsInFlight];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r)
        if (c < p && r0 + r < p) v[r] = src[static_cast<size_t>(r0 + r) * w + c];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r)
        if (c < p && r0 + r < p) dst[(r0 + r) * p + c] = v[r];
    }
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
  const int total = n_img * n;
  if (total > 0) {
    auto kernel = p == 32 ? gather_stack_kernel<32> : gather_stack_kernel<0>;
    kernel<<<(total + kStackWarps - 1) / kStackWarps, kStackWarps * 32, 0,
             static_cast<cudaStream_t>(stream)>>>(imgs, h, w, corners, n, total, p, out);
  }
  return static_cast<int>(cudaGetLastError());
}
