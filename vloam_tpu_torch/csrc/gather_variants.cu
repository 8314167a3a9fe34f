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
// images (4.3 MB) stay in L2.  The tensor-core variants add a one-hot
// product per window that the function does not need: it is the method
// under test.
//
//   gather_narrow    the exact gather, fetching only the aligned 128-byte
//                    lines a window touches: one line per row when
//                    cx % 32 == 0, else two (16-byte loads into shared
//                    memory), then compaction from there.  One block a
//                    keypoint.
//   dma_only         (G7) transport only: out[k] is the raw corner of the
//                    keypoint's band, img[b, cy8:cy8+32, cx128:cx128+32], a
//                    window whose rows start on 512 bytes; no shift by (dy,
//                    dx).  The TPU kernel stages the whole (40, 256) band
//                    because its unit of copy is an (8, 128) tile; the
//                    function needs only the 4 KB it writes.  A warp a
//                    window holds all of it in flight, eight 16-byte loads
//                    a lane, then eight 16-byte stores.  Bound: bytes, the
//                    image floats the windows read once (0.94 MB at the
//                    tool's 2048 keypoints, since corners a band row apart
//                    overlap) and the 8.4 MB written: 0.00279 ms of HBM.
//                    Timed beside it as copies of this file (NVIDIA H100
//                    80GB HBM3, 700 W; tools/gather_experiments, device ms
//                    a call in a replayed graph; PERF.md): this copy
//                    0.00414-0.00453; the copy engine alone (a tiled TMA
//                    load of the 32 x 32 box from a 3-D tensor map into an
//                    8-slot ring, one 4 KB bulk store a window, one issuing
//                    thread a CTA) 0.00464-0.00494 at one CTA an SM, 0.00458
//                    at two, 0.00462 at four; 32 bulk copies of a row a
//                    window 0.02094; the staged band before it (41 KB a
//                    window, 84 MB through L2) 0.0118-0.0121.
//   compact_only     (G8) compaction only: one band per block of 32
//                    keypoints (that of the block's first keypoint), and
//                    every keypoint's window is cut from it at its own (dy,
//                    dx).  The TPU kernel stages the (40, 256) band because
//                    its unit of copy is an (8, 128) tile; here a warp a
//                    window reads it straight from the band, which stays in
//                    L2 for the 32 warps of its block (they read at most 39
//                    rows x 159 columns of it): gather::warp_copy_window,
//                    B2's copy (a lane a column, all 32 rows loaded before
//                    any store), at the band's origin shifted by the
//                    keypoint's own (dy, dx); 8 warps a block, 256 blocks at
//                    the tool's 2048 keypoints.  Bound: bytes, the band
//                    floats the windows read once and the 8.4 MB written.
//                    It runs within a few per cent of G7, so on this card
//                    compaction at an arbitrary shift costs nothing beyond
//                    transport; the designs it was timed against (16-byte
//                    stores shifted by a shuffle, a multicast cluster, the
//                    staged band) and their times are in PERF.md.
//   gather_resident  (G9, for gather_vmem_resident) the exact gather from a
//                    strip staged once, in one launch with no sort.  The TPU
//                    kernel holds both images in VMEM; 227 KB of shared
//                    memory holds one 40-row strip, so one block per (image,
//                    8-row band) starts its strip's copy by the TMA (one bulk
//                    copy a row onto an mbarrier) and, while it is in flight,
//                    finds its own keypoints in meta: each warp takes a share
//                    (three passes of 512 loaded at once) and reserves slots
//                    in a list with one shared atomicAdd of its ballot's
//                    popc, so a round of 1536 keypoints costs one barrier;
//                    the list (1776 slots beside the 225,280-byte strip at
//                    stride w) is drained before it could overflow, so a
//                    bucket of any size fits.  Then a warp a keypoint copies
//                    its window from the strip, a row a store.  Bound: each
//                    image row is staged by five overlapping strips, ~19.8 MB
//                    through L2, and every block reads all of meta.  An empty
//                    bucket writes nothing and lets its copy land before it
//                    exits.
//   gather_mma       (G10, for gather_mxu) the exact gather, the column shift
//                    on the tensor cores (mma_window below).  The TPU kernel
//                    fetches a (40, 256) band a keypoint because its unit of
//                    copy is an (8, 128) tile; here the unit is 16 bytes, so
//                    each warp copies only its window's 32 rows x 40 columns
//                    from column cx & ~7 (5,120 B) with cp.async into a
//                    two-slab ring, the next keypoint's rows in flight while
//                    this one's product runs, and the tensor cores do only
//                    the shift by cx % 8 that a 16-byte copy cannot.  Bound:
//                    L2 bytes (~10.5 MB in, 8 MB out for 2048 windows) and
//                    the latency of one copy a warp.  8 warps a block (80 KB
//                    of slabs, two blocks an SM), a grid of at most two
//                    blocks an SM that walks the keypoints.
//   gather_resident_mma  (G11, for gather_vmem_mxu) the exact gather from a
//                    strip staged once, the column shift on the tensor
//                    cores.  The TPU kernel holds both images in VMEM and
//                    walks the keypoints in order; 227 KB of shared memory
//                    holds one 40-row strip, so one block per (image, 8-row
//                    band) stages its strip with the TMA (one thread issues
//                    a bulk copy a row to an mbarrier) and, while the copy is
//                    in flight, finds its own keypoints in meta (its loads of
//                    four passes of 512 issued at once; a ballot and a popc
//                    prefix compact them into shared memory, in chunks of
//                    1024, so a bucket of any size fits); then a warp a
//                    keypoint runs mma_window on the strip.  One launch, no
//                    sort.  Bound: each image row is staged by five
//                    overlapping strips, ~19.8 MB through L2 for two
//                    376x1248 images, at one 225 KB strip an SM (88 blocks).
//                    An empty bucket writes nothing and lets its copy land
//                    before it exits.

#include <assert.h>
#include <stdint.h>

#include <algorithm>

#include "gather_common.cuh"

namespace {

using namespace gather;

constexpr int kThreads = 256;
constexpr int kResidentThreads = 512;

__device__ __forceinline__ void check_addr(const Addr& a, int n_img, int h_pad, int w) {
  assert(a.b >= 0 && a.b < n_img && a.cx >= 0 && a.cy >= 0 && a.cy8 + kP8 <= h_pad &&
         a.cx128 + kBand <= w);
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

constexpr int kDmaWarps = 8;                    // G7: windows a block, a warp each
constexpr int kDmaLoads = kP * kP / 4 / 32;     // 16-byte loads a lane: the whole window

// Lane l moves the window's 16-byte units l, l + 32, ...: unit i is column
// 4 (i % 8) of row i / 8.  Every load is issued before the first store.
__global__ void __launch_bounds__(kDmaWarps * 32)
dma_only_kernel(const float* __restrict__ imgs, int n_img, int h_pad, int w,
                const int* __restrict__ meta, int n2, float* __restrict__ out) {
  const int k = static_cast<int>(blockIdx.x) * kDmaWarps + (threadIdx.x >> 5);
  if (k >= n2) return;
  const int lane = threadIdx.x & 31;
  const Addr a = decode(meta, n2, k);
  check_addr(a, n_img, h_pad, w);
  const float4* src = reinterpret_cast<const float4*>(
      imgs + (static_cast<size_t>(a.b) * h_pad + a.cy8) * w + a.cx128);
  float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(k) * kP * kP);
  float4 v[kDmaLoads];
#pragma unroll
  for (int j = 0; j < kDmaLoads; ++j) {
    const int i = j * 32 + lane;
    v[j] = src[(i >> 3) * (w >> 2) + (i & 7)];
  }
#pragma unroll
  for (int j = 0; j < kDmaLoads; ++j) dst[j * 32 + lane] = v[j];
}

constexpr int kCompactWarps = 8;   // G8: windows a block, a warp each, all of one band
static_assert(kBlockKp % kCompactWarps == 0, "compact_only: a block's warps share one band");

// Warp k writes window k from the band of keypoint k - k % 32 (the block's
// first), at keypoint k's own (dy, dx): lane l copies column l, every row
// loaded before the first store.  n2 is a multiple of 32, the grid exact.
__global__ void __launch_bounds__(kCompactWarps * 32)
compact_only_kernel(const float* __restrict__ imgs, int n_img, int h_pad, int w,
                    const int* __restrict__ meta, int n2, float* __restrict__ out) {
  const int k = static_cast<int>(blockIdx.x) * kCompactWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const Addr a0 = decode(meta, n2, k - k % kBlockKp);
  check_addr(a0, n_img, h_pad, w);
  const Addr a = decode(meta, n2, k);
  const float* band = imgs + (static_cast<size_t>(a0.b) * h_pad + a0.cy8) * w + a0.cx128;
  warp_copy_window<kP>(band + static_cast<size_t>(a.dy) * w + a.dx, w,
                       out + static_cast<size_t>(k) * kP * kP, kP, lane);
}

// --- G9: one launch that stages a strip and finds its own keypoints ---------------

constexpr int kResidentWarps = kResidentThreads / 32;
constexpr int kScanPasses = 3;                            // passes of 512 keypoints a round
constexpr int kRound = kScanPasses * kResidentThreads;   // keypoints scanned between barriers
constexpr int kResidentList = 1776;                       // keypoint indices G9 holds at once

// G9's dynamic shared memory: the strip (40 rows at stride w), its mbarrier,
// three round counters (16 bytes each with padding), the keypoint list.
int resident_smem(int w) { return kP8 * w * 4 + 32 + 4 * kResidentList; }

__global__ void __launch_bounds__(kResidentThreads)
gather_resident_kernel(const float* __restrict__ imgs, int n_img, int h_pad, int w,
                       const int* __restrict__ meta, int n2, float* __restrict__ out) {
  extern __shared__ __align__(16) float strip[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(strip + kP8 * w);
  int* count = reinterpret_cast<int*>(bar + 2);   // round r adds into count[r % 3]
  int* list = count + 4;
  const int n_bands = (h_pad - kP8) / 8 + 1;
  const int b = blockIdx.x / n_bands, band = blockIdx.x % n_bands, row0 = 8 * band;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    count[0] = 0;
    tma_rows(strip, w, imgs + (static_cast<size_t>(b) * h_pad + row0) * w, w, kP8, w, bar);
  }

  // Rounds of kRound keypoints: every thread loads its three passes' meta at
  // once; each warp's matches of a pass take consecutive slots of `list`,
  // reserved by one atomicAdd; one barrier ends the round, after which every
  // thread reads the round's count.  Thread 0 clears the counter of round r+1
  // before that barrier: it was last read after round r-2's, which every
  // thread has passed.  The list is drained before a round could overflow it.
  bool staged = false;
  int n_list = 0;   // the same in every thread
  for (int base = 0, round = 0; base < n2; base += kRound, ++round) {
    int kbs[kScanPasses], cys[kScanPasses];
#pragma unroll
    for (int j = 0; j < kScanPasses; ++j) {
      const int k = base + j * kResidentThreads + threadIdx.x;
      kbs[j] = k < n2 ? meta[k] : -1;
      cys[j] = k < n2 ? meta[2 * n2 + k] : 0;
      if (blockIdx.x == 0 && k < n2) {   // every keypoint lies in some bucket
        const int cx = meta[n2 + k];
        assert(kbs[j] >= 0 && kbs[j] < n_img && cys[j] >= 0 && (cys[j] >> 3) < n_bands &&
               cx >= 0 && cx + kP <= w);
      }
    }
    if (round == 0) __syncthreads();   // count[0] is cleared and the mbarrier initialised
#pragma unroll
    for (int j = 0; j < kScanPasses; ++j) {
      const int pass = base + j * kResidentThreads;
      if (pass >= n2) break;
      const bool mine = kbs[j] == b && (cys[j] >> 3) == band;
      const unsigned ballot = __ballot_sync(0xffffffffu, mine);
      if (ballot != 0) {   // the same in every lane
        int slot = 0;
        if (lane == 0) slot = atomicAdd(&count[round % 3], __popc(ballot));
        slot = n_list + __shfl_sync(0xffffffffu, slot, 0);
        if (mine) list[slot + __popc(ballot & ((1u << lane) - 1u))] = pass + threadIdx.x;
      }
    }
    if (threadIdx.x == 0) count[(round + 1) % 3] = 0;
    __syncthreads();   // the round's slots are written and counted
    n_list += count[round % 3];
    const bool last = base + kRound >= n2;
    if (n_list > 0 && (last || n_list > kResidentList - kRound)) {
      if (!staged) {
        mbar_wait(bar, 0);
        staged = true;
      }
      for (int i = warp; i < n_list; i += kResidentWarps) {
        const int k = list[i];
        const float* src = strip + (meta[2 * n2 + k] - row0) * w + meta[n2 + k];
        float* dst = out + static_cast<size_t>(k) * kP * kP;
#pragma unroll 8
        for (int r = 0; r < kP; ++r) dst[r * kP + lane] = src[r * w + lane];
      }
      if (!last) __syncthreads();   // the list is read before the next round rewrites it
      n_list = 0;
    }
  }
  if (!staged) mbar_wait(bar, 0);   // an empty bucket lets its copy land before it exits
}

// --- the column shift on the tensor cores (G10, G11) ---------------------------
//
// One warp writes one window from A, the window's 32 rows in shared memory
// from its 8-aligned left column cx & ~7 (row stride lda floats; the row
// offset is in A's base), so the window starts at column s = cx % 8 of A:
// out = A (32 x 40) * S, S[c][j] = (c == j + s).  Window column tile nt (8
// columns) takes its 1s from A's k-block nt and, when s != 0, from k-block
// nt + 1: 2 row tiles x 4 column tiles x at most 2 k-steps x 3 terms = at
// most 48 mma.sync.m16n8k8 (TF32) a window.  The one-hot fragments of the
// lower and the upper k-block are the same for every nt and are made once
// in registers; a k-block shared by two tiles is loaded and split once.
//
// Exactness: TF32 keeps 11 significant bits, so each value x of A is cut by
// masking into hi (its top 11 significant bits), mid (the top 11 of x - hi)
// and lo (the last 2), each exact in TF32 and of x's sign.  Each term has its
// own accumulator, in which exactly one non-zero product (the term times 1)
// lands beside products with 0, and (hi + mid) + lo in f32 gives x back bit
// for bit.  This holds for finite x with |x| >= 2^-103 (about 9.9e-32) and
// for +0.0: below 2^-103 the remainder terms can fall among the subnormals,
// where masking the representation no longer leaves a TF32-exact term; an
// infinity or a NaN times 0 is a NaN.  An input of -0.0 comes back as +0.0,
// because the accumulators start at +0.0 (torch.equal counts the two equal).
//
// Banks: lane (g, t) of a fragment load reads row g, column t of a k-block.
// G11's strip pads its row stride to w + 4 (4 mod 32), so the 32 lanes fall
// in 32 banks and the TMA still writes plain rows.  G10's slab keeps the
// stride at 40 (8 mod 32), which leaves its 16-byte copies conflict-free, and
// swaps the two 16-byte halves of each k-block in the rows whose index has
// bit 2 set (an XOR swizzle of the 16-byte chunk by row bit 2): rows g and
// g + 4 then fall 4 banks apart, and the fragment loads are conflict-free too.

constexpr unsigned kTf32Mask = 0xFFFFE000u;   // sign, exponent and the 10 stored mantissa bits
constexpr unsigned kOne = 0x3F800000u;        // 1.0f

// c (16 x 8) += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 out.  Lane
// l = 4 g + t holds a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
// b0 (t, g), b1 (t+4, g); c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment cut into its three TF32 terms.
struct Split3 {
  unsigned hi[4], mid[4], lo[4];
};

// The fragment of the k-block at `a` (the lane's row g, column t), split;
// flip = 4 where the row's two 16-byte halves of the k-block are swapped.
__device__ __forceinline__ Split3 load_split(const float* a, int lda, int flip) {
  const float x[4] = {a[flip], a[8 * lda + flip], a[4 - flip], a[8 * lda + 4 - flip]};
  Split3 f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = __float_as_uint(x[i]) & kTf32Mask;
    const float r = x[i] - __uint_as_float(f.hi[i]);
    f.mid[i] = __float_as_uint(r) & kTf32Mask;
    f.lo[i] = __float_as_uint(r - __uint_as_float(f.mid[i]));
  }
  return f;
}

__device__ __forceinline__ void mma3(float (&c)[3][4], const Split3& f, unsigned b0, unsigned b1) {
  mma_tf32(c[0], f.hi, b0, b1);
  mma_tf32(c[1], f.mid, b0, b1);
  mma_tf32(c[2], f.lo, b0, b1);
}

// One warp: dst (32 x 32, row-major, global) = columns s .. s+31 of A's 32
// rows.  s is the same in every lane.  With `swizzled`, A's rows whose
// index has bit 2 set hold each 8-column k-block's two 16-byte halves
// swapped (G10's slab, below).
__device__ __forceinline__ void mma_window(const float* A, int lda, int s, bool swizzled,
                                           float* __restrict__ dst) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int flip = swizzled ? g & 4 : 0;   // rows g and g + 8 of every row tile share bit 2
  // column g of a tile is fed by A's column g + s from the tile's own k-block
  // (lower) or, past its end, from the next one (upper)
  const unsigned lo_b0 = t == g + s ? kOne : 0u, lo_b1 = t + 4 == g + s ? kOne : 0u;
  const unsigned up_b0 = t + 8 == g + s ? kOne : 0u, up_b1 = t + 12 == g + s ? kOne : 0u;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const float* a = A + (16 * mt + g) * lda + t;
    Split3 cur = load_split(a, lda, flip);
#pragma unroll
    for (int nt = 0; nt < kP / 8; ++nt) {
      float c[3][4] = {};
      mma3(c, cur, lo_b0, lo_b1);
      if (s != 0 || nt < kP / 8 - 1) {
        const Split3 next = load_split(a + 8 * (nt + 1), lda, flip);
        if (s != 0) mma3(c, next, up_b0, up_b1);
        cur = next;
      }
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = (c[0][i] + c[1][i]) + c[2][i];
      float* d = dst + (16 * mt + g) * kP + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(d) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(d + 8 * kP) = make_float2(v[2], v[3]);
    }
  }
}

// --- G10: a copy of the window's own rows per keypoint ---------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaBlocksPerSm = 2;
constexpr int kSlabCols = kP + 8;                 // from cx & ~7: the window and its shift
constexpr int kSlabFloats = kP * kSlabCols;       // row stride 40, swizzled (see Banks above)
constexpr int kMmaSmem = kMmaWarps * 2 * kSlabFloats * 4;   // two slabs a warp: 81,920 bytes

int g_sm_count = 0;   // the card's SMs, set by vloam_gather_variants_setup

// This lane's share of the 32 x 40 copy of keypoint a's rows into a slab;
// row r's 16-byte chunk c lands at chunk c ^ ((r >> 2) & 1).
__device__ __forceinline__ void copy_window_rows(float* slab, const float* __restrict__ imgs,
                                                 int h_pad, int w, const Addr& a) {
  const float* src = imgs + (static_cast<size_t>(a.b) * h_pad + a.cy) * w + (a.cx & ~7);
  for (int i = threadIdx.x & 31; i < kP * (kSlabCols / 4); i += 32) {
    const int r = i / (kSlabCols / 4), c4 = i % (kSlabCols / 4);
    cp_async16(slab + r * kSlabCols + 4 * (c4 ^ ((r >> 2) & 1)),
               src + static_cast<size_t>(r) * w + 4 * c4);
  }
}

__global__ void __launch_bounds__(kMmaWarps * 32)
gather_mma_kernel(const float* __restrict__ imgs, int n_img, int h_pad, int w,
                  const int* __restrict__ meta, int n2, float* __restrict__ out) {
  extern __shared__ __align__(16) float slabs[];
  const int warp = threadIdx.x >> 5;
  float* ring = slabs + warp * 2 * kSlabFloats;
  const int stride = gridDim.x * kMmaWarps;
  int k = blockIdx.x * kMmaWarps + warp;
  if (k >= n2) return;   // per warp: no block barrier follows
  Addr cur = decode(meta, n2, k);
  check_addr(cur, n_img, h_pad, w);
  copy_window_rows(ring, imgs, h_pad, w, cur);
  cp_async_commit();
  for (int slot = 0; k < n2; k += stride, slot ^= 1) {
    const int next = k + stride;
    Addr nxt = cur;
    if (next < n2) {
      nxt = decode(meta, n2, next);
      check_addr(nxt, n_img, h_pad, w);
      copy_window_rows(ring + (slot ^ 1) * kSlabFloats, imgs, h_pad, w, nxt);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this keypoint's rows have landed, the next one's may be in flight
    __syncwarp();
    mma_window(ring + slot * kSlabFloats, kSlabCols, cur.cx & 7, true,
               out + static_cast<size_t>(k) * kP * kP);
    __syncwarp();         // the slab is read before the copy after next overwrites it
    cur = nxt;
  }
}

// --- G11: one launch that stages a strip and finds its own keypoints ------------------

constexpr int kListCap = 1024;   // keypoint indices a block holds at once
constexpr int kScanDepth = 4;    // passes of 512 keypoints whose meta a thread loads at once

// G11's dynamic shared memory: the strip (40 rows at stride w + 4), its
// mbarrier (16 bytes with padding), the warps' counts, the keypoint list.
int resident_mma_smem(int w) {
  return kP8 * (w + 4) * 4 + 16 + 4 * kResidentWarps + 4 * kListCap;
}

__global__ void __launch_bounds__(kResidentThreads)
gather_resident_mma_kernel(const float* __restrict__ imgs, int n_img, int h_pad, int w,
                           const int* __restrict__ meta, int n2, float* __restrict__ out) {
  extern __shared__ __align__(16) float strip[];
  const int ld = w + 4;
  uint64_t* bar = reinterpret_cast<uint64_t*>(strip + kP8 * ld);
  int* warp_n = reinterpret_cast<int*>(bar + 2);
  int* list = warp_n + kResidentWarps;
  const int n_bands = (h_pad - kP8) / 8 + 1;
  const int b = blockIdx.x / n_bands, band = blockIdx.x % n_bands, row0 = 8 * band;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the strip's copy first: one bulk copy a row, all completing on one mbarrier
  if (threadIdx.x == 0)
    tma_rows(strip, ld, imgs + (static_cast<size_t>(b) * h_pad + row0) * w, w, kP8, w, bar);

  // then this bucket's keypoints, found in meta while the strip is in flight:
  // the meta of kScanDepth passes of 512 keypoints loaded at once, then each
  // pass compacted into `list` by a ballot and a popc prefix; the list is
  // drained before it could overflow
  bool staged = false;
  int n_list = 0;   // the same in every thread
  for (int base = 0; base < n2; base += kScanDepth * kResidentThreads) {
    int kbs[kScanDepth], cys[kScanDepth];
#pragma unroll
    for (int j = 0; j < kScanDepth; ++j) {
      const int k = base + j * kResidentThreads + threadIdx.x;
      kbs[j] = k < n2 ? meta[k] : -1;
      cys[j] = k < n2 ? meta[2 * n2 + k] : 0;
      if (blockIdx.x == 0 && k < n2) {   // every keypoint lies in some bucket
        const int cx = meta[n2 + k];
        assert(kbs[j] >= 0 && kbs[j] < n_img && cys[j] >= 0 && (cys[j] >> 3) < n_bands &&
               cx >= 0 && (cx & ~127) + kBand <= w);
      }
    }
#pragma unroll
    for (int j = 0; j < kScanDepth; ++j) {
      const int pass = base + j * kResidentThreads;
      if (pass >= n2) break;
      const bool mine = kbs[j] == b && (cys[j] >> 3) == band;
      const unsigned ballot = __ballot_sync(0xffffffffu, mine);
      if (lane == 0) warp_n[warp] = __popc(ballot);
      __syncthreads();
      int off = n_list;
#pragma unroll
      for (int i = 0; i < kResidentWarps; ++i) {
        off += i < warp ? warp_n[i] : 0;
        n_list += warp_n[i];
      }
      if (mine) list[off + __popc(ballot & ((1u << lane) - 1u))] = pass + threadIdx.x;
      __syncthreads();   // the list is written; warp_n may be rewritten
      if (n_list > 0 && (n_list > kListCap - kResidentThreads || pass + kResidentThreads >= n2)) {
        if (!staged) {
          mbar_wait(bar, 0);
          staged = true;
        }
        for (int i = warp; i < n_list; i += kResidentWarps) {
          const int kk = list[i];
          const int cx = meta[n2 + kk], dy = meta[2 * n2 + kk] - row0;
          mma_window(strip + dy * ld + (cx & ~7), ld, cx & 7, false,
                     out + static_cast<size_t>(kk) * kP * kP);
        }
        __syncthreads();   // the list is read before the next pass rewrites it
        n_list = 0;
      }
    }
  }
  if (!staged) mbar_wait(bar, 0);   // an empty bucket lets its copy land before it exits
}

using BandKernel = void (*)(const float*, int, int, int, const int*, int, float*);
int launch_band(BandKernel kernel, int blocks, int threads, const float* imgs, int n_img,
                int h_pad, int w, const int* meta, int n2, float* out, void* stream,
                int smem = 0) {
  if (w % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(imgs, n_img, h_pad, w,
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

// G7: imgs on 16 bytes (its loads are 16 bytes wide).
extern "C" int vloam_gather_dma_only(const float* imgs, int n_img, int h_pad, int w,
                                     const int* meta, int n2, float* out, void* stream) {
  return launch_band(dma_only_kernel, (n2 + kDmaWarps - 1) / kDmaWarps, kDmaWarps * 32, imgs,
                     n_img, h_pad, w, meta, n2, out, stream);
}

// G8: n2 must be a multiple of 32.
extern "C" int vloam_gather_compact_only(const float* imgs, int n_img, int h_pad, int w,
                                         const int* meta, int n2, float* out, void* stream) {
  if (n2 % gather::kBlockKp != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_band(compact_only_kernel, n2 / kCompactWarps, kCompactWarps * 32, imgs, n_img,
                     h_pad, w, meta, n2, out, stream);
}

// Once, when the library is loaded (kernels.lib() calls it): the
// shared-memory limits of G9, G10 and G11, and the SM count that sizes G10's
// grid.  No launch sets a kernel attribute.
extern "C" int vloam_gather_variants_setup() {
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc == 0)
    rc = static_cast<int>(cudaDeviceGetAttribute(&g_sm_count, cudaDevAttrMultiProcessorCount, dev));
  if (rc == 0)
    rc = static_cast<int>(cudaFuncSetAttribute(
        gather_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem));
  if (rc == 0)
    rc = static_cast<int>(cudaFuncSetAttribute(
        gather_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem));
  if (rc == 0)
    rc = static_cast<int>(cudaFuncSetAttribute(
        gather_resident_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem));
  return rc;
}

// n_bands = (h_pad - 40) / 8 + 1 blocks an image; resident_smem(w) bytes of
// shared memory must fit a block.
extern "C" int vloam_gather_resident(const float* imgs, int n_img, int h_pad, int w,
                                     const int* meta, int n2, float* out, void* stream) {
  if (resident_smem(w) > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int n_bands = (h_pad - kP8) / 8 + 1;
  return launch_band(gather_resident_kernel, n2 > 0 ? n_img * n_bands : 0, kResidentThreads, imgs,
                     n_img, h_pad, w, meta, n2, out, stream, resident_smem(w));
}

extern "C" int vloam_gather_mma(const float* imgs, int n_img, int h_pad, int w, const int* meta,
                                int n2, float* out, void* stream) {
  const int blocks =
      std::min((n2 + kMmaWarps - 1) / kMmaWarps, kMmaBlocksPerSm * std::max(g_sm_count, 1));
  return launch_band(gather_mma_kernel, blocks, kMmaWarps * 32, imgs, n_img, h_pad, w, meta, n2,
                     out, stream, kMmaSmem);
}

// n_bands = (h_pad - 40) / 8 + 1 blocks an image; resident_mma_smem(w) bytes
// of shared memory must fit a block.
extern "C" int vloam_gather_resident_mma(const float* imgs, int n_img, int h_pad, int w,
                                         const int* meta, int n2, float* out, void* stream) {
  if (w % 4 != 0 || resident_mma_smem(w) > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_bands = (h_pad - kP8) / 8 + 1;
  if (n2 > 0) {
    gather_resident_mma_kernel<<<n_img * n_bands, kResidentThreads, resident_mma_smem(w),
                                 static_cast<cudaStream_t>(stream)>>>(imgs, n_img, h_pad, w, meta,
                                                                      n2, out);
  }
  return static_cast<int>(cudaGetLastError());
}
