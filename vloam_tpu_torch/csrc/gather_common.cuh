// Shared by the patch-gather measurement kernels (gather_sweeps.cu,
// gather_variants.cu): the fixed sizes of the experiment, asynchronous
// 16-byte copies into shared memory (cp.async), rows copied by the TMA onto
// an mbarrier, a block-wide maximum, and the decoding of a keypoint's
// (image id, cx, cy) into the aligned band the TPU formulations fetch.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gather {

constexpr int kP = 32;         // patch side
constexpr int kP8 = kP + 8;    // rows of a strip or band: P rows below any 8-aligned base
constexpr int kBand = 256;     // columns of a band, from a 128-aligned base
constexpr int kBlockKp = 32;   // keypoints per block where a formulation shares one band
constexpr int kMaxDynamicSmem = 232448;   // bytes a block may have on sm_90

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One thread's whole part of a copy by the TMA: initialise the mbarrier at
// `bar` for one arrival that expects rows * cols floats, then issue one bulk
// copy a row, src rows at stride src_ld floats landing at stride dst_ld.
// Addresses and row bytes must be multiples of 16, the total under 2^20
// bytes.  Other threads wait on `bar` (mbar_wait) only after a __syncthreads
// that follows this call.
__device__ __forceinline__ void tma_rows(float* dst, int dst_ld, const float* src, size_t src_ld,
                                         int rows, int cols, uint64_t* bar) {
  const unsigned bar_s = smem_u32(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar_s), "r"(1) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_s),
               "r"(rows * cols * 4) : "memory");
  for (int r = 0; r < rows; ++r) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst + r * dst_ld)), "l"(src + r * src_ld), "r"(cols * 4), "r"(bar_s)
        : "memory");
  }
}

// Wait until the phase `parity` of the mbarrier at `bar` has completed.
__device__ __forceinline__ void mbar_wait(const uint64_t* bar, unsigned parity) {
  const unsigned bar_s = smem_u32(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar_s), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ float max4(float m, const float4 v) {
  return fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
}

// Maximum over the block; valid in thread 0.  Every thread must call it.
__device__ __forceinline__ float block_max(float m) {
  __shared__ float warp_m[32];
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();   // warp_m may still be read from an earlier call
  if (lane == 0) warp_m[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < static_cast<int>((blockDim.x + 31) >> 5) ? warp_m[lane] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  return m;
}

// meta is (3, n2) int32, rows (image id; cx; cy).  The band of a keypoint
// starts at (cy8, cx128), the window at (dy, dx) inside it.
struct Addr {
  int b, cx, cy, dy, cy8, dx, cx128;
};

__device__ __forceinline__ Addr decode(const int* __restrict__ meta, int n2, int k) {
  Addr a;
  a.b = meta[k];
  a.cx = meta[n2 + k];
  a.cy = meta[2 * n2 + k];
  a.dy = a.cy & 7;
  a.cy8 = a.cy - a.dy;
  a.dx = a.cx & 127;
  a.cx128 = a.cx - a.dx;
  return a;
}

}  // namespace gather
