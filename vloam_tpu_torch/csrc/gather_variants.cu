// Six formulations of the patch gather out[k] = img[b_k, cy_k:cy_k+32,
// cx_k:cx_k+32], measured against the shipped kernel (gather_patches.cu).
// Measurement kernels, not on the frame step.
//
// Replaces: tools/gather_experiments.py, gather_narrow (:304), dma_only
// (:389), compact_only (:439), gather_vmem_resident (:497), gather_mxu (:546)
// and gather_vmem_mxu (:612).  Each TPU kernel asks one question about the
// gather (do bytes bind?  transport or compaction?  does residency help?
// can the matrix unit do the column shift?); the question is carried over,
// not the TPU's blocks of 32 keypoints.
//
// All take the padded images (n_img, h_pad, w), in which a 40-row band from
// the 8-aligned row base cy8 and a 256-column band from the 128-aligned
// column base cx128 of any legal corner stay in bounds, and meta (3, n2)
// int32, rows (image id; cx; cy).  All write (n2, 32, 32) f32.
//
// What bounds them: bytes, and few.  The work is a copy of n2 * 4 KB; the
// images (4.3 MB) stay in L2.  The tensor-core variants add a dense
// (48, 256) x (256, 32) product per keypoint that the function does not
// need: it is the method under test.
//
//   gather_narrow    the exact gather, fetching only the aligned 128-byte
//                    lines a window touches: one line per row when
//                    cx % 32 == 0, else two (16-byte loads into shared
//                    memory), then compaction from there.  One block a
//                    keypoint.
//   dma_only         transport only: the whole (40, 256) band is brought to
//                    shared memory with cp.async, and its raw corner
//                    band[:32, :32] is written; no shift by (dy, dx).
//   compact_only     compaction only: one band per block of 32 keypoints
//                    (that of the block's first keypoint), and every
//                    keypoint's window is cut from it at its own (dy, dx).
//   gather_resident  the exact gather with each image byte fetched once: the
//                    caller buckets the keypoints by (image, 8-row band);
//                    one block per bucket brings the 40-row full-width strip
//                    (225,280 bytes, all of a block's shared memory) in once
//                    and a warp per keypoint writes its window from there.
//                    An empty bucket's block returns at once.
//   gather_mma       the exact gather, the column shift as a product with a
//                    one-hot (256, 32) matrix on the tensor cores
//                    (mma.sync m16n8k8, TF32), the row offset applied when
//                    the accumulators are stored.  TF32 keeps 11 significant
//                    bits, so each f32 is cut into three TF32 terms (hi, mid,
//                    lo, by masking: each is exact and all have the sign of
//                    x), each term gets its own accumulator, in which exactly
//                    one non-zero product lands, and (hi + mid) + lo in f32
//                    gives back x bit for bit.  The one-hot operand is built
//                    in registers.  One block (4 warps, a column tile each)
//                    a keypoint.
//   gather_resident_mma  gather_resident's strip feeding gather_mma's
//                    extraction; a warp per keypoint.

#include <assert.h>

#include "gather_common.cuh"

namespace {

using namespace gather;

constexpr int kThreads = 256;
constexpr int kResidentThreads = 512;
constexpr int kMmaThreads = 128;

__device__ __forceinline__ void check_addr(const Addr& a, int n_img, int h_pad, int w) {
  assert(a.b >= 0 && a.b < n_img && a.cx >= 0 && a.cy >= 0 && a.cy8 + kP8 <= h_pad &&
         a.cx128 + kBand <= w);
}

// The (40, 256) band at (cy8, cx128) of one image into shared memory.
__device__ __forceinline__ void stage_band(float* band, const float* __restrict__ img, int w,
                                           int cy8, int cx128) {
  for (int i = threadIdx.x; i < kP8 * (kBand / 4); i += blockDim.x) {
    const int r = i / (kBand / 4), c4 = i % (kBand / 4);
    cp_async16(band + r * kBand + 4 * c4, img + static_cast<size_t>(cy8 + r) * w + cx128 + 4 * c4);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// The 40-row full-width strip from row `row0` of one image into shared memory.
__device__ __forceinline__ void stage_strip(float* strip, const float* __restrict__ img, int w,
                                            int row0) {
  const float* src = img + static_cast<size_t>(row0) * w;
  for (int i = threadIdx.x; i < kP8 * w / 4; i += blockDim.x) cp_async16(strip + 4 * i, src + 4 * i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
gather_narrow_kernel(const float* __restrict__ imgs, int n_img, int h_pad, int w,
                     const int* __restrict__ meta, int n2, float* __restrict__ out) {
  __shared__ __align__(16) float lines[kP][2 * kP];
  const int k = blockIdx.x;
  const Addr a = decode(meta, n2, k);
  check_addr(a, n_img, h_pad, w);
  const int dxl = a.cx & 31, cx32 = a.cx - dxl;
  const int row4 = dxl == 0 ? kP / 4 : 2 * kP / 4;     // 16-byte loads per row: one line or two
  const float* img = imgs + static_cast<size_t>(a.b) * h_pad * w;
  for (int i = threadIdx.x; i < kP * row4; i += kThreads) {
    const int r = i / row4, c4 = i % row4;
    *reinterpret_cast<float4*>(&lines[r][4 * c4]) = *reinterpret_cast<const float4*>(
        img + static_cast<size_t>(a.cy + r) * w + cx32 + 4 * c4);
  }
  __syncthreads();
  float* dst = out + static_cast<size_t>(k) * kP * kP;
  for (int i = threadIdx.x; i < kP * kP; i += kThreads) dst[i] = lines[i >> 5][dxl + (i & 31)];
}

__global__ void __launch_bounds__(kThreads)
dma_only_kernel(const float* __restrict__ imgs, int n_img, int h_pad, int w,
                const int* __restrict__ meta, int n2, float* __restrict__ out) {
  __shared__ __align__(16) float band[kP8 * kBand];
  const int k = blockIdx.x;
  const Addr a = decode(meta, n2, k);
  check_addr(a, n_img, h_pad, w);
  stage_band(band, imgs + static_cast<size_t>(a.b) * h_pad * w, w, a.cy8, a.cx128);
  float* dst = out + static_cast<size_t>(k) * kP * kP;
  for (int i = threadIdx.x; i < kP * kP; i += kThreads) dst[i] = band[(i >> 5) * kBand + (i & 31)];
}

__global__ void __launch_bounds__(kThreads)
compact_only_kernel(const float* __restrict__ imgs, int n_img, int h_pad, int w,
                    const int* __restrict__ meta, int n2, float* __restrict__ out) {
  __shared__ __align__(16) float band[kP8 * kBand];
  const int k0 = blockIdx.x * kBlockKp;
  const Addr a0 = decode(meta, n2, k0);
  check_addr(a0, n_img, h_pad, w);
  stage_band(band, imgs + static_cast<size_t>(a0.b) * h_pad * w, w, a0.cy8, a0.cx128);
  for (int kk = 0; kk < kBlockKp; ++kk) {
    const Addr a = decode(meta, n2, k0 + kk);
    float* dst = out + static_cast<size_t>(k0 + kk) * kP * kP;
    for (int i = threadIdx.x; i < kP * kP; i += kThreads)
      dst[i] = band[(a.dy + (i >> 5)) * kBand + a.dx + (i & 31)];
  }
}

// order: (n2,) keypoint indices sorted by bucket = b * n_bands + cy / 8;
// offsets: (n_img * n_bands + 1,) where each bucket starts in `order`.
__global__ void __launch_bounds__(kResidentThreads)
gather_resident_kernel(const float* __restrict__ imgs, int h_pad, int w,
                       const int* __restrict__ meta, int n2,
                       const long long* __restrict__ order,
                       const long long* __restrict__ offsets, int n_bands,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) float strip[];
  const int start = static_cast<int>(offsets[blockIdx.x]);
  const int end = static_cast<int>(offsets[blockIdx.x + 1]);
  if (start == end) return;
  const int b = blockIdx.x / n_bands, row0 = 8 * (blockIdx.x % n_bands);
  stage_strip(strip, imgs + static_cast<size_t>(b) * h_pad * w, w, row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = start + warp; i < end; i += kResidentThreads / 32) {
    const int k = static_cast<int>(order[i]);
    const int cx = meta[n2 + k], dy = meta[2 * n2 + k] - row0;
    assert(meta[k] == b && dy >= 0 && dy < 8 && cx >= 0 && cx + kP <= w);
    float* dst = out + static_cast<size_t>(k) * kP * kP;
    for (int r = 0; r < kP; ++r) dst[r * kP + lane] = strip[(dy + r) * w + cx + lane];
  }
}

// --- column extraction on the tensor cores ----------------------------------

constexpr unsigned kTf32Mask = 0xFFFFE000u;   // sign, exponent and the 10 stored mantissa bits
constexpr unsigned kOne = 0x3F800000u;        // 1.0f

// x = hi + mid + lo, each exact in TF32 and of x's sign: hi keeps the top 11
// significant bits of x, mid those of the remainder (at most 13 bits), lo
// the last two.
__device__ __forceinline__ void split3(float x, unsigned& hi, unsigned& mid, unsigned& lo) {
  hi = __float_as_uint(x) & kTf32Mask;
  const float r = x - __uint_as_float(hi);
  mid = __float_as_uint(r) & kTf32Mask;
  lo = __float_as_uint(r - __uint_as_float(mid));
}

// c (16 x 8) += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 out.  Lane
// l = 4 g + t holds a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
// b0 (t, g), b1 (t+4, g); c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: columns [8 nt, 8 nt + 8) of the window whose band A (kP8 rows
// of kBand columns, row stride lda, in shared memory) holds it at (dy, dx):
// rolled = A (48 x 256, rows >= 40 zero) * S, S[c][j] = (c == j + dx), then
// rows dy .. dy+31 of rolled go to dst (32 x 32).
__device__ __forceinline__ void mma_extract(const float* A, int lda, int dx, int dy,
                                            float* __restrict__ dst, int nt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int hot = nt * 8 + g + dx;          // the band column that feeds window column 8 nt + g
  for (int mt = 0; mt < 3; ++mt) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    const float* a_r0 = A + r0 * lda + t;
    const float* a_r1 = A + r1 * lda + t;
    float c_hi[4] = {0.f, 0.f, 0.f, 0.f}, c_mid[4] = {0.f, 0.f, 0.f, 0.f},
          c_lo[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kb = 0; kb < kBand; kb += 8) {
      const float a[4] = {r0 < kP8 ? a_r0[kb] : 0.f, r1 < kP8 ? a_r1[kb] : 0.f,
                          r0 < kP8 ? a_r0[kb + 4] : 0.f, r1 < kP8 ? a_r1[kb + 4] : 0.f};
      unsigned hi[4], mid[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split3(a[i], hi[i], mid[i], lo[i]);
      const unsigned b0 = (kb + t == hot) ? kOne : 0u;
      const unsigned b1 = (kb + t + 4 == hot) ? kOne : 0u;
      mma_tf32(c_hi, hi, b0, b1);
      mma_tf32(c_mid, mid, b0, b1);
      mma_tf32(c_lo, lo, b0, b1);
    }
    float c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = (c_hi[i] + c_mid[i]) + c_lo[i];
    const int col = nt * 8 + 2 * t;
    if (r0 >= dy && r0 < dy + kP)
      *reinterpret_cast<float2*>(dst + (r0 - dy) * kP + col) = make_float2(c[0], c[1]);
    if (r1 >= dy && r1 < dy + kP)
      *reinterpret_cast<float2*>(dst + (r1 - dy) * kP + col) = make_float2(c[2], c[3]);
  }
}

__global__ void __launch_bounds__(kMmaThreads)
gather_mma_kernel(const float* __restrict__ imgs, int n_img, int h_pad, int w,
                  const int* __restrict__ meta, int n2, float* __restrict__ out) {
  __shared__ __align__(16) float band[kP8 * kBand];
  const int k = blockIdx.x;
  const Addr a = decode(meta, n2, k);
  check_addr(a, n_img, h_pad, w);
  stage_band(band, imgs + static_cast<size_t>(a.b) * h_pad * w, w, a.cy8, a.cx128);
  mma_extract(band, kBand, a.dx, a.dy, out + static_cast<size_t>(k) * kP * kP, threadIdx.x >> 5);
}

__global__ void __launch_bounds__(kResidentThreads)
gather_resident_mma_kernel(const float* __restrict__ imgs, int h_pad, int w,
                           const int* __restrict__ meta, int n2,
                           const long long* __restrict__ order,
                           const long long* __restrict__ offsets, int n_bands,
                           float* __restrict__ out) {
  extern __shared__ __align__(16) float strip[];
  const int start = static_cast<int>(offsets[blockIdx.x]);
  const int end = static_cast<int>(offsets[blockIdx.x + 1]);
  if (start == end) return;
  const int b = blockIdx.x / n_bands, row0 = 8 * (blockIdx.x % n_bands);
  stage_strip(strip, imgs + static_cast<size_t>(b) * h_pad * w, w, row0);
  const int warp = threadIdx.x >> 5;
  for (int i = start + warp; i < end; i += kResidentThreads / 32) {
    const int k = static_cast<int>(order[i]);
    const int cx = meta[n2 + k], dy = meta[2 * n2 + k] - row0;
    const int dx = cx & 127, cx128 = cx - dx;
    assert(meta[k] == b && dy >= 0 && dy < 8 && cx >= 0 && cx128 + kBand <= w);
    float* dst = out + static_cast<size_t>(k) * kP * kP;
    for (int nt = 0; nt < kP / 8; ++nt) mma_extract(strip + cx128, w, dx, dy, dst, nt);
  }
}

using BandKernel = void (*)(const float*, int, int, int, const int*, int, float*);
using BucketKernel = void (*)(const float*, int, int, const int*, int, const long long*,
                              const long long*, int, float*);

int launch_bucketed(BucketKernel kernel, const float* imgs, int n_img, int h_pad, int w,
                    const int* meta, int n2, const long long* order, const long long* offsets,
                    float* out, void* stream) {
  const int bytes = kP8 * w * 4;
  if (w % 4 != 0 || bytes > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (rc != 0) return rc;
  const int n_bands = (h_pad - kP8) / 8 + 1;
  if (n2 > 0) {
    kernel<<<n_img * n_bands, kResidentThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        imgs, h_pad, w, meta, n2, order, offsets, n_bands, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_band(BandKernel kernel, int blocks, int threads, const float* imgs, int n_img,
                int h_pad, int w, const int* meta, int n2, float* out, void* stream) {
  if (w % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(imgs, n_img, h_pad, w,
                                                                       meta, n2, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// imgs (n_img, h_pad, w) f32, padded (w a multiple of 128, h_pad of 8);
// meta (3, n2) int32; out (n2, 32, 32) f32.  Each returns the first CUDA
// error of its set-up and launch.

extern "C" int vloam_gather_narrow(const float* imgs, int n_img, int h_pad, int w,
                                   const int* meta, int n2, float* out, void* stream) {
  return launch_band(gather_narrow_kernel, n2, kThreads, imgs, n_img, h_pad, w, meta, n2, out,
                     stream);
}

extern "C" int vloam_gather_dma_only(const float* imgs, int n_img, int h_pad, int w,
                                     const int* meta, int n2, float* out, void* stream) {
  return launch_band(dma_only_kernel, n2, kThreads, imgs, n_img, h_pad, w, meta, n2, out, stream);
}

// n2 must be a multiple of 32.
extern "C" int vloam_gather_compact_only(const float* imgs, int n_img, int h_pad, int w,
                                         const int* meta, int n2, float* out, void* stream) {
  if (n2 % gather::kBlockKp != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_band(compact_only_kernel, n2 / gather::kBlockKp, kThreads, imgs, n_img, h_pad, w,
                     meta, n2, out, stream);
}

// order (n2,) int64 and offsets (n_img * n_bands + 1,) int64 as described at
// gather_resident_kernel; n_bands = (h_pad - 40) / 8 + 1; 40 * w * 4 bytes of
// shared memory must fit a block.
extern "C" int vloam_gather_resident(const float* imgs, int n_img, int h_pad, int w,
                                     const int* meta, int n2, const long long* order,
                                     const long long* offsets, float* out, void* stream) {
  return launch_bucketed(gather_resident_kernel, imgs, n_img, h_pad, w, meta, n2, order, offsets,
                         out, stream);
}

extern "C" int vloam_gather_mma(const float* imgs, int n_img, int h_pad, int w, const int* meta,
                                int n2, float* out, void* stream) {
  return launch_band(gather_mma_kernel, n2, kMmaThreads, imgs, n_img, h_pad, w, meta, n2, out,
                     stream);
}

extern "C" int vloam_gather_resident_mma(const float* imgs, int n_img, int h_pad, int w,
                                         const int* meta, int n2, const long long* order,
                                         const long long* offsets, float* out, void* stream) {
  return launch_bucketed(gather_resident_mma_kernel, imgs, n_img, h_pad, w, meta, n2, order,
                         offsets, out, stream);
}
