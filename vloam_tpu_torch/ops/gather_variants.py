"""The eleven measurement kernels of the patch-gather family (counterparts of
the kernels inside ``tools/gather_experiments.py`` of the reference).

They ask what limits the patch gather of ``ops/patch_gather`` and are run by
``vloam_tpu_torch.tools.gather_experiments``, not by the frame step:

  ====  ======================  ===========================================
  G1    ``strip_sweep``         read every 40-row strip, synchronous staging
  G2    ``strip_sweep_db``      ... the next chunk in flight (2 slots, TMA)
  G3    ``strip_sweep_batched`` ... eleven strips in flight, TMA from a 3-D map
  G4    ``strip_sweep_flat``    G3 from a 2-D map over the flat view
  G5    ``whole_image``         both images, contiguous, ``reps`` times
  G6    ``gather_narrow``       exact gather from the 128-byte lines it needs
  G7    ``dma_only``            transport only: the band's raw corner
  G8    ``compact_only``        compaction only: one band per 32 keypoints
  G9    ``gather_resident``     exact gather from a strip staged once, one launch
  G10   ``gather_mma``          exact gather, column shift on tensor cores
  G11   ``gather_resident_mma`` G9's strip feeding G10's shift, one launch
  ====  ======================  ===========================================

The sweeps (G1-G5) reduce what they read so that every copy can be checked:
G1 and G2 return the maximum of each strip ``padded[b, base:base+40, :]``
(``n_img * n_bases`` floats, bases 0, 8, ...), G3 and G4 the sum, added in
order, of each 11 consecutive strip maxima, G5 ``reps`` times the maximum of
the whole array.  A maximum propagates NaN, as ``jnp.max`` and
``torch.amax`` do.  (The TPU kernels keep only their last step's value:
their grid runs in order, a CUDA grid does not.)  The gathers (G6-G11) take the
padded image stack ``(n_img, H_pad, W_pad)`` and ``meta`` ``(3, N)`` int32,
rows ``(image id; cx; cy)``, and return ``(N, 32, 32)``; G6, G9, G10 and G11
are the exact gather, G7 and G8 are defined on the padded array (see their
plain versions).

Every wrapper launches its kernel (``csrc/gather_sweeps.cu``,
``csrc/gather_variants.cu``) for CUDA tensors and counts the launch in
``LAUNCHES``; CPU tensors take the plain PyTorch version (``*_reference``).
Nothing falls back from one to the other.  All results are bit-equal to the
plain versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vloam_tpu_torch import kernels

P = 32            # patch side
P8 = P + 8        # rows of a strip or band
BAND = 256        # columns of a band, from a 128-aligned base
BLOCK_KP = 32     # keypoints that share one band in compact_only
BATCH = 11        # strips of a batched sweep's group, all in flight at once
GROUP_CTAS = 16   # CTAs of a batched sweep's cluster, a column slice each (kGroupCtas)
SLOT_ROWS = 20    # rows of a batched sweep's slot, half a strip (kSlotRows)
BOX_MAX = 256     # elements a tensor map's box may span in one dimension
REPS = 10         # repeats of whole_image
SMEM_MAX = 232448  # bytes of shared memory a block may have on sm_90

NAMES = ("strip_sweep", "strip_sweep_db", "strip_sweep_batched", "strip_sweep_flat",
         "whole_image", "gather_narrow", "dma_only", "compact_only", "gather_resident",
         "gather_mma", "gather_resident_mma")
LAUNCHES = {name: 0 for name in NAMES}   # kernel launches per wrapper (plain calls do not count)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pad_img(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H_pad, W_pad), zero-padded so that a 40-row band from the
    8-aligned row base, and a 256-column band from the 128-aligned column
    base, of any legal corner stay in bounds (the reference's ``pad_img``)."""
    H, W = img.shape
    H_pad = ((H - 1) // 8 + 2) * 8
    W_pad = ((W - 1) // 128 + 2) * 128
    return F.pad(img, (0, W_pad - W, 0, H_pad - H))


def n_bases(h_pad: int) -> int:
    """8-aligned row bases of the 40-row strips of one padded image."""
    return (h_pad - P8) // 8 + 1


def batched_smem(w: int) -> int:
    """Bytes of shared memory one G3 or G4 block takes for images ``w``
    wide: eleven slots, each 20 rows of one strip's w / 16 column slice
    (``batched_smem`` in ``csrc/gather_sweeps.cu``)."""
    return BATCH * SLOT_ROWS * (w // GROUP_CTAS) * 4


# --- plain versions -----------------------------------------------------------

def strip_maxima(imgs: torch.Tensor) -> torch.Tensor:
    """(n_img, H_pad, W_pad) -> (n_img * n_bases,): max of every strip."""
    return imgs.unfold(1, P8, 8).amax(dim=(2, 3)).reshape(-1)


def strip_sweep_reference(imgs):
    return strip_maxima(imgs)


strip_sweep_db_reference = strip_sweep_reference


def strip_sweep_batched_reference(imgs):
    m = strip_maxima(imgs).reshape(-1, BATCH)
    acc = torch.zeros_like(m[:, 0])
    for k in range(BATCH):           # added in order, as the kernel adds them
        acc = acc + m[:, k]
    return acc


def strip_sweep_flat_reference(img2d, n_img: int):
    return strip_sweep_batched_reference(img2d.reshape(n_img, -1, img2d.shape[1]))


def whole_image_reference(img2d, reps: int = REPS):
    return img2d.amax().repeat(reps)


def _windows(imgs, ids, rows, cols):
    """imgs[ids[k], rows[k]:rows[k]+P, cols[k]:cols[k]+P] for every k."""
    n_img, h, w = imgs.shape
    ids, rows, cols = ids.to(torch.int64), rows.to(torch.int64), cols.to(torch.int64)
    bad = (ids < 0) | (ids >= n_img) | (rows < 0) | (cols < 0) | (rows > h - P) | (cols > w - P)
    if bool(bad.any()):
        raise ValueError("gather variants: a window lies outside its image")
    off = torch.arange(P, device=imgs.device)
    return imgs[ids[:, None, None], (rows[:, None] + off)[:, :, None],
                (cols[:, None] + off)[:, None, :]]


def gather_reference(imgs, meta):
    """The exact gather: the plain version of G6, G9, G10 and G11."""
    return _windows(imgs, meta[0], meta[2], meta[1])


gather_narrow_reference = gather_resident_reference = gather_reference
gather_mma_reference = gather_resident_mma_reference = gather_reference


def dma_only_origins(meta):
    """(ids, rows, cols) of G7's windows: the raw corner (cy8, cx128) of each
    keypoint's band."""
    return meta[0], meta[2] - meta[2] % 8, meta[1] - meta[1] % 128


def compact_only_origins(meta):
    """(ids, rows, cols) of G8's windows: the band of the block's first
    keypoint, at the k-th keypoint's own (dy, dx) = (cy % 8, cx % 128)."""
    first = meta[:, ::BLOCK_KP].repeat_interleave(BLOCK_KP, dim=1)
    return (first[0], first[2] - first[2] % 8 + meta[2] % 8,
            first[1] - first[1] % 128 + meta[1] % 128)


def dma_only_reference(imgs, meta):
    """out[k] = imgs[b, cy8:cy8+P, cx128:cx128+P]: the raw corner of the band."""
    return _windows(imgs, *dma_only_origins(meta))


def compact_only_reference(imgs, meta):
    """Every block of 32 keypoints cuts from the band of its first keypoint:
    out[k] = band0[dy_k:dy_k+P, dx_k:dx_k+P] with the k-th keypoint's own
    (dy, dx) = (cy % 8, cx % 128)."""
    return _windows(imgs, *compact_only_origins(meta))


# --- wrappers -------------------------------------------------------------------

def _check_imgs(name, imgs, dims):
    """The checks a kernel needs of the padded images, cheapest first (a
    sweep's whole host path is a few microseconds); returns their shape."""
    if not imgs.is_cuda:
        kernels.require_cuda(name, imgs)
    shape = imgs.shape
    if len(shape) != dims or imgs.dtype is not torch.float32 or not imgs.is_contiguous():
        raise ValueError(f"{name}: the images must be a contiguous float32 tensor of {dims} dims")
    if shape[-1] % 128 != 0 or shape[-2] % 8 != 0 or shape[-2] < P8:
        raise ValueError(f"{name}: the images must be padded (pad_img)")
    if imgs.data_ptr() % 16 != 0:
        raise ValueError(f"{name}: the images must start on 16 bytes")
    return shape


def _sweep(name, entry, imgs, n_img, h_pad, w, per_block):
    """Checks done: one allocation (``new_empty``: an uninitialised
    ``torch.empty`` of the images' dtype and device), one ctypes call."""
    strips = n_img * n_bases(h_pad)
    if strips % per_block != 0:
        raise ValueError(f"{name}: {strips} strips do not split into groups of {per_block}")
    out = imgs.new_empty(strips // per_block)
    rc = kernels.entry(entry)(imgs.data_ptr(), n_img, h_pad, w, out.data_ptr(),
                              kernels.stream_ptr(imgs.device))
    kernels.check(rc, name)
    LAUNCHES[name] += 1
    return out


def strip_sweep(imgs):
    """G1: (n_img, H_pad, W_pad) -> (n_img * n_bases,) strip maxima.  Every
    strip is read in full with synchronous staging, split by columns over a
    cluster of four blocks whose partial maxima meet in distributed shared
    memory."""
    if imgs.is_cpu:
        return strip_sweep_reference(imgs)
    n_img, h_pad, w = _check_imgs("strip_sweep", imgs, 3)
    return _sweep("strip_sweep", "vloam_sweep_sync", imgs, n_img, h_pad, w, 1)


def strip_sweep_db(imgs):
    """G2: as G1, each block streaming its column slice in 8-row chunks
    through a two-slot ring of bulk copies by the TMA, the next chunk in
    flight while one is reduced."""
    if imgs.is_cpu:
        return strip_sweep_db_reference(imgs)
    n_img, h_pad, w = _check_imgs("strip_sweep_db", imgs, 3)
    return _sweep("strip_sweep_db", "vloam_sweep_tma_ring", imgs, n_img, h_pad, w, 1)


def _check_box(name, w):
    """The tensor map's rules for G3's and G4's width: the box, 20 rows of a
    strip's column slice of w / 16 columns, spans a multiple of 16 bytes and
    at most 256 columns, and the eleven slots fit a block's shared memory."""
    if w % (4 * GROUP_CTAS) != 0 or w // GROUP_CTAS > BOX_MAX or batched_smem(w) > SMEM_MAX:
        raise ValueError(f"{name}: {w} columns do not split into {GROUP_CTAS} tensor-map boxes "
                         f"of at most {BOX_MAX} columns and 16-byte rows whose eleven slots "
                         f"fit {SMEM_MAX} bytes")


def strip_sweep_batched(imgs):
    """G3: -> (n_img * n_bases / 11,) sums of 11 strip maxima, added in
    order.  One cluster of 16 blocks a group of eleven strips, each block one
    column slice of every strip of the group: eleven TMA tiled copies from a
    3-D tensor map over (W_pad, H_pad, n_img), all in flight at once, each
    waited for in order and reduced, each slot then refilled once with the
    strip's other 20 rows; the slices' maxima meet in distributed shared
    memory and each output is written once."""
    if imgs.is_cpu:
        return strip_sweep_batched_reference(imgs)
    n_img, h_pad, w = _check_imgs("strip_sweep_batched", imgs, 3)
    _check_box("strip_sweep_batched", w)
    return _sweep("strip_sweep_batched", "vloam_sweep_batched", imgs, n_img, h_pad, w, BATCH)


def strip_sweep_flat(img2d, n_img: int):
    """G4: G3 on the (n_img * H_pad, W_pad) view of the same memory, its
    copies from a 2-D tensor map over that view."""
    if img2d.is_cpu:
        return strip_sweep_flat_reference(img2d, n_img)
    rows, w = _check_imgs("strip_sweep_flat", img2d, 2)
    if rows % n_img != 0:
        raise ValueError("strip_sweep_flat: the rows do not split into n_img images")
    _check_box("strip_sweep_flat", w)
    return _sweep("strip_sweep_flat", "vloam_sweep_batched_flat", img2d, n_img, rows // n_img, w,
                  BATCH)


def whole_image(img2d, reps: int = REPS):
    """G5: -> (reps,), each the maximum of the whole array.  One launch, one
    cluster of 16 blocks a repeat, reading the array in 16-byte
    loads; the blocks' maxima meet in distributed shared memory and each
    ``out[r]`` is written once."""
    if img2d.is_cpu:
        return whole_image_reference(img2d, reps)
    rows, w = _check_imgs("whole_image", img2d, 2)
    if reps < 1:
        raise ValueError(f"whole_image: {reps} repeats")
    out = img2d.new_empty(reps)
    rc = kernels.entry("vloam_whole_image")(img2d.data_ptr(), rows * w, reps, out.data_ptr(),
                                            kernels.stream_ptr(img2d.device))
    kernels.check(rc, "whole_image")
    LAUNCHES["whole_image"] += 1
    return out


def _check_meta(name, imgs, meta):
    _check_imgs(name, imgs, 3)
    kernels.require_cuda(name, imgs, meta)
    if meta.dim() != 2 or meta.shape[0] != 3 or meta.dtype != torch.int32 \
            or not meta.is_contiguous():
        raise ValueError(f"{name}: meta must be contiguous (3, N) int32")


def _gather(name, entry, imgs, meta):
    n_img, h_pad, w = imgs.shape
    n2 = meta.shape[1]
    out = imgs.new_empty((n2, P, P))
    rc = kernels.entry(entry)(imgs.data_ptr(), n_img, h_pad, w, meta.data_ptr(), n2,
                              out.data_ptr(), kernels.stream_ptr(imgs.device))
    kernels.check(rc, name)
    LAUNCHES[name] += 1
    return out


def gather_narrow(imgs, meta):
    """G6: the exact gather, staging only the 128-byte lines each window touches."""
    if imgs.device.type == "cpu":
        return gather_narrow_reference(imgs, meta)
    _check_meta("gather_narrow", imgs, meta)
    return _gather("gather_narrow", "vloam_gather_narrow", imgs, meta)


def dma_only(imgs, meta):
    """G7: each keypoint's raw corner, the 32 x 32 window at (cy8, cx128),
    copied by a warp a window with the whole window in flight (eight
    16-byte loads a lane, then eight stores)."""
    if imgs.device.type == "cpu":
        return dma_only_reference(imgs, meta)
    _check_meta("dma_only", imgs, meta)
    return _gather("dma_only", "vloam_gather_dma_only", imgs, meta)


def compact_only(imgs, meta):
    """G8: one band per block of 32 keypoints, every window cut from it."""
    if meta.shape[1] % BLOCK_KP != 0:
        raise ValueError(f"compact_only: the keypoint count must be a multiple of {BLOCK_KP}")
    if imgs.device.type == "cpu":
        return compact_only_reference(imgs, meta)
    _check_meta("compact_only", imgs, meta)
    return _gather("compact_only", "vloam_gather_compact_only", imgs, meta)


def resident_smem(w: int) -> int:
    """Bytes of shared memory one G9 block takes for images ``w`` wide: the
    40-row strip at row stride w, its barrier, three round counters and a list
    of 1776 keypoint indices (``resident_smem`` in ``csrc/gather_variants.cu``)."""
    return P8 * w * 4 + 32 + 4 * 1776


def gather_resident(imgs, meta):
    """G9: the exact gather in one launch.  One block per (image, 8-row band)
    stages its 40-row strip once with the TMA, finds its own keypoints in
    ``meta`` while the copy is in flight, and copies their windows from the
    strip; no sort, no PyTorch operation before the launch."""
    if imgs.device.type == "cpu":
        return gather_resident_reference(imgs, meta)
    _check_meta("gather_resident", imgs, meta)
    if resident_smem(imgs.shape[2]) > SMEM_MAX:
        raise ValueError(f"gather_resident: a 40-row strip of {imgs.shape[2]} columns does not "
                         "fit a block's shared memory")
    return _gather("gather_resident", "vloam_gather_resident", imgs, meta)


def gather_mma(imgs, meta):
    """G10: the exact gather with the column shift on the tensor cores.  Each
    warp copies its window's 32 rows from the 8-aligned column below cx (40
    columns) into a two-slab ring and shifts them by cx % 8 as a one-hot
    product (``mma.sync`` TF32 over the one or two k-steps that hold the 1s,
    three exact terms per value): bit-equal to a copy for finite values of
    magnitude at least 2**-103 and zero (-0.0 comes back as +0.0)."""
    if imgs.device.type == "cpu":
        return gather_mma_reference(imgs, meta)
    _check_meta("gather_mma", imgs, meta)
    return _gather("gather_mma", "vloam_gather_mma", imgs, meta)


def resident_mma_smem(w: int) -> int:
    """Bytes of shared memory one G11 block takes for images ``w`` wide: the
    40-row strip at row stride w + 4, its barrier, the warps' counts and a
    list of 1024 keypoint indices (``resident_mma_smem`` in
    ``csrc/gather_variants.cu``)."""
    return P8 * (w + 4) * 4 + 16 + 4 * 16 + 4 * 1024


def gather_resident_mma(imgs, meta):
    """G11: the exact gather in one launch.  One block per (image, 8-row band)
    stages its 40-row strip with the TMA, finds its own keypoints in ``meta``
    while the copy is in flight, and writes their windows with G10's
    tensor-core shift; no sort, no PyTorch operation before the launch."""
    if imgs.device.type == "cpu":
        return gather_resident_mma_reference(imgs, meta)
    _check_meta("gather_resident_mma", imgs, meta)
    if resident_mma_smem(imgs.shape[2]) > SMEM_MAX:
        raise ValueError(f"gather_resident_mma: a 40-row strip of {imgs.shape[2]} columns does "
                         "not fit a block's shared memory")
    return _gather("gather_resident_mma", "vloam_gather_resident_mma", imgs, meta)
