// Shared by the patch-gather kernels (gather_patches.cu, gather_sweeps.cu,
// gather_variants.cu): the fixed sizes of the experiment, asynchronous
// 16-byte copies into shared memory (cp.async), bulk copies by the TMA onto
// an mbarrier, a NaN-propagating block-wide maximum, the decoding of a
// keypoint's (image id, cx, cy) into the aligned band the TPU formulations
// fetch, and the register copy of one window by one warp.

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

// The mbarrier at `bar`: initialise it for `count` arrivals (one thread; the
// others may use it only after a __syncthreads that follows), and announce
// the bytes the copies of its current phase will bring (under 2^20).
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}

// One bulk copy by the TMA of `bytes` (a multiple of 16, both addresses on
// 16 bytes) from global to shared memory, landing on the mbarrier at `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// One thread's whole part of a copy by the TMA: initialise the mbarrier at
// `bar` for one arrival that expects rows * cols floats, then issue one bulk
// copy a row, src rows at stride src_ld floats landing at stride dst_ld.
// Addresses and row bytes must be multiples of 16, the total under 2^20
// bytes.  Other threads wait on `bar` (mbar_wait) only after a __syncthreads
// that follows this call.
__device__ __forceinline__ void tma_rows(float* dst, int dst_ld, const float* src, size_t src_ld,
                                         int rows, int cols, uint64_t* bar) {
  mbar_init(bar, 1);
  mbar_expect_tx(bar, rows * cols * 4);
  for (int r = 0; r < rows; ++r) bulk_copy(dst + r * dst_ld, src + r * src_ld, cols * 4, bar);
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

// The larger of a and b, NaN if either is NaN (PTX max.NaN, sm_80 and later,
// at max.f32's rate): jnp.max and torch.amax propagate NaN, fmaxf drops it.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max4(float m, const float4 v) {
  return max_nan(m, max_nan(max_nan(v.x, v.y), max_nan(v.z, v.w)));
}

// Maximum over the block, NaN if any thread's m is; valid in thread 0.  Every
// thread must call it.
__device__ __forceinline__ float block_max(float m) {
  __shared__ float warp_m[32];
  for (int o = 16; o > 0; o >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();   // warp_m may still be read from an earlier call
  if (lane == 0) warp_m[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < static_cast<int>((blockDim.x + 31) >> 5) ? warp_m[lane] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
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

constexpr int kRowsInFlight = 32;   // rows a lane of warp_copy_window loads before it stores

// One warp copies the (p, p) window at src, rows w floats apart, to dst, p x p
// row-major.  Lane l takes columns l, l + 32, ... and loads kRowsInFlight rows
// of its column into registers before it stores any, so a window pays the
// copy's latency once, not once a row; each row is one 128-byte warp access
// each way when p = 32.  kSide: p fixed at compile time, or 0 to take p_run.
template <int kSide>
__device__ __forceinline__ void warp_copy_window(const float* __restrict__ src, size_t w,
                                                 float* __restrict__ dst, int p_run, int lane) {
  const int p = kSide > 0 ? kSide : p_run;
  for (int c = lane; c - lane < p; c += 32) {
    for (int r0 = 0; r0 < p; r0 += kRowsInFlight) {
      float v[kRowsInFlight];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r)
        if (c < p && r0 + r < p) v[r] = src[(r0 + r) * w + c];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r)
        if (c < p && r0 + r < p) dst[(r0 + r) * p + c] = v[r];
    }
  }
}

}  // namespace gather
