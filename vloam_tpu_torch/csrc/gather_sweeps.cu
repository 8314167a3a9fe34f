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
//   sweep_batched (+ _flat)   one f32 per group of 11 consecutive strips:
//                             the 11 strip maxima added in order from 0.0f;
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
//   sweep_batched  (G3) the TPU kernel's discipline of eleven copies started
//                  at once, then each waited for in order and reduced, on
//                  Hopper's copy engine from a tensor map: one cluster of 16
//                  CTAs a group of eleven strips (128 CTAs at the tool's 88
//                  strips), each CTA one column slice of w/16 columns (88 at
//                  w = 1408) of every strip of its group.  One thread starts
//                  eleven TMA tiled copies, one instruction a 20-row half of
//                  a strip slice (20 x 88 f32, 7,040 bytes), each into its
//                  own slot on its own mbarrier (initialised once, one
//                  expect_tx a use); every thread waits for slot k in order
//                  and keeps a partial maximum per strip, and once every
//                  thread has read slot k (a __syncthreads()) it is refilled
//                  with the strip's other half, so eleven copies stay in
//                  flight.  Whole 40-row slots (154,880 bytes a CTA) leave
//                  room for one CTA an SM, and the H100 then holds only 7 of
//                  the 8 clusters of 16 at once (cudaOccupancyMaxActiveClusters):
//                  the eighth ran as a second wave.  Half slots (77,440
//                  bytes) let two CTAs share an SM, and 14 clusters fit.  The
//                  slices' maxima meet in rank 0's shared memory (distributed
//                  shared memory), whose thread 0 takes each strip's maximum
//                  over the 16 ranks in rank order, adds the eleven in order
//                  and writes out[g] once.  The copies come from a 3-D tensor
//                  map over (w, H_pad, n_img), box (w/16, 20, 1), as the TPU
//                  kernel's copy source has a leading image axis;
//   sweep_batched_flat (G4) the same kernel on a 2-D tensor map over the flat
//                  (w, n_img * H_pad) view, box (w/16, 20), as the TPU
//                  kernel's source is the flattened array.  The maps are
//                  encoded on the host at every call (cuTensorMapEncodeTiled,
//                  found once through the runtime, so no -lcuda) and passed
//                  as __grid_constant__ kernel parameters;
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
// 5.4-5.5 TB/s, G3 and G4 at 2.3-2.4 TB/s (0.0084-0.0085 ms; as eight blocks
// of an eleven-slot cp.async ring they read 0.19-0.20 TB/s, 0.101-0.102 ms).
// G4's 2-D map and G3's 3-D map read the same.  Timed beside G3 and G4 as
// copies of this file: whole 40-row slots 0.0113-0.0114 ms (7 of the 8
// clusters resident at once, so a second wave), 8-row slots filled five
// times 0.0196-0.0201, cp.async 16-byte copies from every thread into the
// same half slots 0.0165-0.0167, an L2 promotion of 256 B in the maps
// 0.0084-0.0086.  The map's encoding costs the host 1.1-1.5 us a call.

#include <cooperative_groups.h>
#include <cuda.h>

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
constexpr int kBatch = 11;       // sweep_batched: strips of a group, a slot and a copy each
constexpr int kGroupCtas = 16;   // sweep_batched: CTAs of a group's cluster (non-portable size)
constexpr int kSlotRows = 20;    // sweep_batched: rows of a slot, half a strip: filled twice
constexpr int kFills = kP8 / kSlotRows;
constexpr int kBoxMax = 256;     // elements a tensor map's box may span in one dimension
constexpr int kWholeCtas = 16;   // whole_image: CTAs of a repeat's cluster (non-portable size)
constexpr int kWholeLoads = 8;      // whole_image: 16-byte loads in flight a thread
static_assert(kP8 % kWarps == 0, "sweep_sync: each warp stages the same number of rows");
static_assert(kP8 % kDbRows == 0, "sweep_tma_ring: a strip is whole chunks");
static_assert(kP8 % kSlotRows == 0, "sweep_batched: a strip is whole slot fills");

// G1's shared memory for images w wide: one CTA's 40 x (w / 4) slice.
int sync_smem(int w) { return kP8 * (w / kSlices) * 4; }

// G2's: two slots of kDbRows rows of one CTA's column slice.
int db_smem(int w) { return 2 * kDbRows * (w / kSlices) * 4; }

// G3's and G4's: kBatch slots, each kSlotRows rows of one strip's w /
// kGroupCtas column slice (77,440 bytes at w = 1408, so two blocks fit an
// SM; each slot 7,040, a multiple of 128).
int batched_smem(int w) { return kBatch * kSlotRows * (w / kGroupCtas) * 4; }

// The tensor map's rules for images w wide: the box's inner extent a
// multiple of 16 bytes and at most kBoxMax elements, the slots within a
// block's shared memory.
bool batched_width_ok(int w) {
  return w % (4 * kGroupCtas) == 0 && w / kGroupCtas <= kBoxMax &&
         batched_smem(w) <= kMaxDynamicSmem;
}

// cuTensorMapEncodeTiled, a driver function: found once by
// vloam_sweeps_setup through the runtime, so the library links cudart only.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled = nullptr;

// One tiled copy by the TMA of the box at (c0, c1) / (c0, c1, c2)
// (innermost first) of the tensor map at `map` into dst (on 128 bytes),
// landing on the mbarrier at `bar`.
__device__ __forceinline__ void tma_tile(float* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void tma_tile(float* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
        "r"(smem_u32(bar)) : "memory");
}

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
  extern __shared__ __align__(16) float smem[];   // bulk copies want 16 bytes
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

// G3 (FLAT false: `map` is 3-D over (w, h_pad, n_img)) and G4 (FLAT true:
// 2-D over the flat (w, n_img * h_pad) view).  Group g is the cluster of CTAs
// g * kGroupCtas .. (g + 1) * kGroupCtas - 1, strips g * kBatch ..; CTA
// `rank` takes column slice `rank` (w / kGroupCtas columns) of each.  Thread
// 0 starts kBatch copies, the first kSlotRows rows of each strip's slice, each
// into its own slot on its own mbarrier; every thread then waits for slot k
// in order and keeps m[k], its part of strip k's maximum, and once every
// thread has read slot k, thread 0 refills it with the strip's next rows.
template <bool FLAT>
__global__ void __launch_bounds__(kThreads)
sweep_batched_kernel(const __grid_constant__ CUtensorMap map, int h_pad, int w, int n_bases,
                     float* __restrict__ out) {
  // The slots: their own dynamic symbol, since the other kernels' `smem`
  // is declared on 16 bytes and tiled copies land on 128.
  extern __shared__ __align__(128) float slots[];
  __shared__ __align__(8) uint64_t full[kBatch];   // slot k's copy has landed
  __shared__ float warp_m[kWarps][kBatch];
  __shared__ float part[kGroupCtas][kBatch];        // rank 0's: each slice's strip maxima
  cluster_arrive();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = blockIdx.x / kGroupCtas;
  const int cols = w / kGroupCtas, slot = kSlotRows * cols;   // floats of a slice row, of a slot
  auto issue = [&](int k, int fill) {   // thread 0 only
    const int strip = group * kBatch + k;
    const int b = strip / n_bases, row = 8 * (strip % n_bases) + fill * kSlotRows;
    mbar_expect_tx(&full[k], slot * 4);   // the box's bytes, exactly
    if (FLAT)
      tma_tile(slots + k * slot, &map, rank * cols, b * h_pad + row, &full[k]);
    else
      tma_tile(slots + k * slot, &map, rank * cols, row, b, &full[k]);
  };
  if (threadIdx.x == 0) {
    if (smem_u32(slots) % 128 != 0) __trap();   // a tiled copy's destination
#pragma unroll
    for (int k = 0; k < kBatch; ++k) mbar_init(&full[k], 1);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) issue(k, 0);
  }
  __syncthreads();   // the barriers are initialised before anyone waits on them
  float m[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) m[k] = -INFINITY;
  const int n4 = slot / 4;
#pragma unroll
  for (int fill = 0; fill < kFills; ++fill) {
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      mbar_wait(&full[k], fill & 1);   // the slot's fill-th use
      const float4* s = reinterpret_cast<const float4*>(slots + k * slot);
      float v = m[k];
      for (int i = threadIdx.x; i < n4; i += kThreads) v = max4(v, s[i]);
      m[k] = v;
      if (fill + 1 < kFills) {
        __syncthreads();   // every thread has read the slot
        if (threadIdx.x == 0) issue(k, fill + 1);
      }
    }
  }
  // The block's part of each strip's maximum: across each warp by shuffles,
  // then thread k over the warps.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    for (int o = 16; o > 0; o >>= 1) m[k] = max_nan(m[k], __shfl_xor_sync(0xffffffffu, m[k], o));
    if (lane == 0) warp_m[warp][k] = m[k];
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");   // every CTA has started
  if (threadIdx.x < kBatch) {
    float v = warp_m[0][threadIdx.x];
    for (int u = 1; u < kWarps; ++u) v = max_nan(v, warp_m[u][threadIdx.x]);
    *cluster.map_shared_rank(&part[rank][threadIdx.x], 0) = v;
  }
  cluster.sync();   // the pushes have landed
  if (rank == 0 && threadIdx.x == 0) {
    float acc = 0.0f;
    for (int k = 0; k < kBatch; ++k) {
      float v = part[0][k];
      for (int r = 1; r < kGroupCtas; ++r) v = max_nan(v, part[r][k]);
      acc += v;
    }
    out[group] = acc;
  }
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

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

// A launch of `clusters` clusters of `ctas` CTAs each.  A cluster larger
// than the portable 8 is set at launch, not by __cluster_dims__.
cudaLaunchConfig_t cluster_config(int clusters, int ctas, int smem, cudaLaunchAttribute* attr,
                                  void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of `cfg`'s launch of `kernel` the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
template <typename Kernel>
int resident_clusters(Kernel kernel, const cudaLaunchConfig_t& cfg) {
  int n = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}

// G3's (flat false) or G4's (flat true) tensor map over imgs (n_img, h_pad,
// w) f32: the box is kSlotRows rows of one strip's column slice, (w /
// kGroupCtas, kSlotRows, 1) or (w / kGroupCtas, kSlotRows).  No swizzle, no
// interleave, element strides 1; every box lies inside the array, so the
// out-of-bounds fill never applies.
CUresult encode_batched(CUtensorMap* map, const float* imgs, int n_img, int h_pad, int w,
                        bool flat) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(h_pad),
                              static_cast<cuuint64_t>(n_img)};
  const cuuint64_t flat_dims[2] = {static_cast<cuuint64_t>(w),
                                   static_cast<cuuint64_t>(n_img) * h_pad};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(w) * 4,   // bytes, of dims 1 and 2
                                 static_cast<cuuint64_t>(h_pad) * w * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(w / kGroupCtas), kSlotRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, flat ? 2 : 3,
                      const_cast<float*>(imgs), flat ? flat_dims : dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// G3's and G4's launch: the checks, the map's encoding, one cluster of
// kGroupCtas CTAs a group of kBatch strips.
template <bool FLAT>
int launch_batched(const float* imgs, int n_img, int h_pad, int w, float* out, void* stream) {
  const int n_bases = (h_pad - kP8) / 8 + 1;
  const int strips = n_img * n_bases;
  if (!batched_width_ok(w) || h_pad < kP8 || strips % kBatch != 0 || misaligned(imgs))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const CUresult enc = encode_batched(&map, imgs, n_img, h_pad, w, FLAT);
  if (enc != CUDA_SUCCESS) return static_cast<int>(enc);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(strips / kBatch, kGroupCtas, batched_smem(w), &attr, stream);
  const cudaError_t rc =
      cudaLaunchKernelEx(&cfg, sweep_batched_kernel<FLAT>, map, h_pad, w, n_bases, out);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

}  // namespace

// Once, when the library is loaded (kernels.lib() calls it): every staged
// sweep may take all of a block's shared memory beside its static part, G3's,
// G4's and G5's clusters may be larger than the portable 8, and G3 and G4
// find cuTensorMapEncodeTiled.  No launch sets a kernel attribute.
extern "C" int vloam_sweeps_setup() {
  auto allow = [](auto kernel) {
    cudaFuncAttributes attr;
    cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kMaxDynamicSmem - static_cast<int>(attr.sharedSizeBytes));
    return static_cast<int>(rc);
  };
  auto large_cluster = [](auto kernel) {
    return static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  };
  int rc = allow(sweep_sync_kernel);
  if (rc == 0) rc = allow(sweep_tma_ring_kernel);
  if (rc == 0) rc = allow(sweep_batched_kernel<false>);
  if (rc == 0) rc = allow(sweep_batched_kernel<true>);
  if (rc == 0) rc = large_cluster(sweep_batched_kernel<false>);
  if (rc == 0) rc = large_cluster(sweep_batched_kernel<true>);
  if (rc == 0) rc = large_cluster(whole_image_kernel);
  if (rc == 0) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    rc = static_cast<int>(
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found));
    if (rc == 0 && (found != cudaDriverEntryPointSuccess || fn == nullptr))
      rc = static_cast<int>(cudaErrorSymbolNotFound);
    if (rc == 0) encode_tiled = reinterpret_cast<EncodeTiled>(fn);
  }
  return rc;
}

// All strip sweeps: imgs (n_img, h_pad, w) row-major f32 on 16 bytes, the
// padded images (w a multiple of 4, so every row starts on 16 bytes; G1 and
// G2 want a multiple of 16, so that each of their four slices does, G3 and
// G4 a multiple of 64, so that each of their 16 does); n_bases
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

// G3.  out: (n_img * n_bases / 11,) f32, each written once, by the rank 0 of
// its group's cluster; n_img * n_bases must be a multiple of 11, w a
// multiple of 64 with w / 16 <= 256 and the eleven slots within a block's
// shared memory (batched_width_ok).  Returns the CUDA error of the launch or
// the CUresult of the tensor map's encoding.
extern "C" int vloam_sweep_batched(const float* imgs, int n_img, int h_pad, int w, float* out,
                                   void* stream) {
  return launch_batched<false>(imgs, n_img, h_pad, w, out, stream);
}

// G4.  img2d: the same memory seen as (n_img * h_pad, w).
extern "C" int vloam_sweep_batched_flat(const float* img2d, int n_img, int h_pad, int w,
                                        float* out, void* stream) {
  return launch_batched<true>(img2d, n_img, h_pad, w, out, stream);
}

// One encoding of G3's (flat 0) or G4's (flat 1) tensor map, thrown away:
// the host step that every G3 and G4 call takes before its launch.
// Returns its CUresult.
extern "C" int vloam_sweep_batched_encode(const float* imgs, int n_img, int h_pad, int w,
                                          int flat) {
  CUtensorMap map;
  return static_cast<int>(encode_batched(&map, imgs, n_img, h_pad, w, flat != 0));
}

// How many of G3's clusters for images w wide the card holds at once
// (G4's launch is the same), or minus the CUDA error.
extern "C" int vloam_sweep_batched_clusters(int w) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, kGroupCtas, batched_smem(w), &attr, nullptr);
  return resident_clusters(sweep_batched_kernel<false>, cfg);
}

// G5.  img2d: (n_floats,) f32 on 16 bytes, n_floats a multiple of 4; out:
// (reps,) f32, each written once, by the rank 0 of its repeat's cluster.
extern "C" int vloam_whole_image(const float* img2d, int n_floats, int reps, float* out,
                                 void* stream) {
  if (n_floats % 4 != 0 || reps < 1 || misaligned(img2d))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(reps, kWholeCtas, 0, &attr, stream);
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, whole_image_kernel,
                                            reinterpret_cast<const float4*>(img2d), n_floats / 4,
                                            out);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

// How many of G5's clusters the card can hold at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
extern "C" int vloam_whole_image_clusters() {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, kWholeCtas, 0, &attr, nullptr);
  return resident_clusters(whole_image_kernel, cfg);
}
