"""Rotated-BRIEF descriptors and Hamming matching (port of
``vloam_tpu/ops/orb.py``): the reference's default frontend, selected by
``optical_flow_match=False``.

  * orientation: the intensity centroid of a 32x32 patch sliced once per
    keypoint (``ops/patch_gather.gather_patches``, the single-image launch
    of the CUDA patch gather), quantised to ORB's 30 pre-rotated patterns;
  * descriptor: 256 comparisons of smoothed-image taps on a seeded Gaussian
    BRIEF pattern, packed into 8 words of 32 bits;
  * matching: XOR and popcount over all pairs, then 2-NN with Lowe's ratio
    test or mutual nearest neighbours; or the FLANN stand-in
    (``match_descriptors_approx``, ``matcher_type="flann"``): a seeded
    subset of words prefilters candidates, the full width re-ranks them.
    The matchers serve every binary family (BRISK, FREAK and AKAZE too).

Descriptor words are **int32 holding the reference's uint32 bit patterns**
(bit 31 is the sign bit): PyTorch has little arithmetic on ``uint32``.
XOR and AND do not care; every right shift here is masked back to a logical
one.  ``numpy_array.view(np.uint32)`` gives the reference's values.

Ties are common among small integer distances, and ``torch.topk`` and
``torch.argmin`` promise no order among equal values, so nearest neighbours
are taken as "the lowest index among the minima", which is ``lax.top_k``'s
and ``jnp.argmin``'s rule.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from plainref.config import VisualConfig
from plainref.ops.image_ops import _sep_conv
from plainref.ops.patch_gather import gather_patches

PATCH = 32          # descriptor patch (covers the 31x31 ORB window)
N_BITS = 256
N_ANGLES = 30       # ORB's 12-degree orientation quantisation (Rublee et al. 2011, 4.1)
MASKED = 1e9        # distance of a masked-out descriptor


def _pattern() -> np.ndarray:
    """(256, 4) sampling pairs (x1, y1, x2, y2), Gaussian around the centre
    (sigma = patch/5), clipped to +-13 so any rotation stays inside the
    31x31 window."""
    rng = np.random.default_rng(1234)
    p = rng.normal(scale=PATCH / 5.0, size=(N_BITS, 4))
    return np.clip(p, -13.0, 13.0).astype(np.float32)


_PAT = _pattern()


def _pattern_bank() -> tuple[np.ndarray, np.ndarray]:
    """(N_ANGLES, 256) integer tap indices into the flattened 32x32 patch for
    each pattern endpoint, one row per quantised orientation (nearest tap)."""
    half = PATCH // 2
    banks = []
    for px, py in ((_PAT[:, 0], _PAT[:, 1]), (_PAT[:, 2], _PAT[:, 3])):
        rows = []
        for a in range(N_ANGLES):
            th = 2.0 * np.pi * a / N_ANGLES
            c, s = np.cos(th), np.sin(th)
            x = c * px - s * py + (half - 0.5)
            y = s * px + c * py + (half - 0.5)
            xi = np.clip(np.round(x), 0, PATCH - 1).astype(np.int32)
            yi = np.clip(np.round(y), 0, PATCH - 1).astype(np.int32)
            rows.append(yi * PATCH + xi)
        banks.append(np.stack(rows))
    return banks[0], banks[1]


_BANK1, _BANK2 = _pattern_bank()
# the 5-tap smoothing kernel [1 2 3 2 1] / 9, rounded to f32 as the reference's
_SMOOTH = [float(v) for v in
           np.array([1.0, 2.0, 3.0, 2.0, 1.0], np.float32) / np.float32(9.0)]
# bit b of a word weighs 1 << b; as int32, bit 31 is -2**31
_BIT_WEIGHTS = (np.uint32(1) << np.arange(32, dtype=np.uint32)).view(np.int32)


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """The pattern banks, the bit weights and the moment axis on ``device``,
    uploaded once (an upload per frame would be a synchronising copy)."""
    half = PATCH // 2
    return {
        "bank1": torch.tensor(_BANK1.astype(np.int64), device=device),
        "bank2": torch.tensor(_BANK2.astype(np.int64), device=device),
        "weights": torch.tensor(_BIT_WEIGHTS, device=device),
        "ax": torch.arange(PATCH, dtype=torch.float32, device=device) - (half - 0.5),
    }


def orb_descriptors(img: torch.Tensor, pts: torch.Tensor, mask: torch.Tensor,
                    cfg: VisualConfig, rotate: bool = True):
    """Returns (descriptors (N, 8) int32, valid (N,)).

    ``rotate=True`` gives ORB (BRIEF steered by the intensity centroid),
    ``rotate=False`` plain BRIEF.  Keypoints whose 32x32 patch leaves the
    image are invalidated."""
    H, W = img.shape
    k = _consts(img.device)
    smooth = _sep_conv(img, _SMOOTH, _SMOOTH)

    half = PATCH // 2
    corner = torch.round(pts).to(torch.int32) - half
    inside = ((corner[:, 0] >= 0) & (corner[:, 0] <= W - PATCH)
              & (corner[:, 1] >= 0) & (corner[:, 1] <= H - PATCH))
    corner = torch.stack([torch.clamp(corner[:, 0], 0, W - PATCH),
                          torch.clamp(corner[:, 1], 0, H - PATCH)], dim=-1)
    patches = gather_patches(smooth, corner, PATCH)          # (N, 32, 32)

    if rotate:
        m10 = torch.einsum("nyx,x->n", patches, k["ax"])
        m01 = torch.einsum("nyx,y->n", patches, k["ax"])
        theta = torch.atan2(m01, m10)                        # (-pi, pi]
        abin = torch.remainder(
            torch.round(theta * (N_ANGLES / (2.0 * math.pi))).to(torch.int64), N_ANGLES)
    else:
        abin = torch.zeros((pts.shape[0],), dtype=torch.int64, device=img.device)

    bits = _descriptor_bits(patches.reshape(patches.shape[0], -1), abin)
    return pack_bits(bits), mask & inside


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 32 * n_words) bool -> (N, n_words) int32 words, bit b of a word
    from column 32 * word + b (the reference's ``_pack_bits``)."""
    words = bits.reshape(bits.shape[0], -1, 32)
    # the signed weights of a word's set bits add up inside the int32 range
    return torch.sum(torch.where(words, _consts(bits.device)["weights"], 0),
                     dim=-1).to(torch.int32)


def _descriptor_bits(flat: torch.Tensor, abin: torch.Tensor) -> torch.Tensor:
    """Pattern comparisons on flattened patches: (N, 256) bits, by gathering
    each keypoint's angle bin's integer taps (exact f32, as the reference
    computes them off the TPU).  The reference's TPU branch, one product
    against the (30 * 256, 1024) matrix of +-1 tap differences, gives the
    same bits and ran 30x slower on an H100 (chip_smoke.py phase 3)."""
    k = _consts(flat.device)
    abin = abin.to(torch.int64)
    idx1 = k["bank1"][abin]                                  # (N, 256)
    idx2 = k["bank2"][abin]
    return torch.gather(flat, 1, idx1) < torch.gather(flat, 1, idx2)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of int32 words read as 32 unsigned bits (Hacker's
    Delight 5-2).  ``>>`` on int32 is arithmetic: every mask below has its
    top bits clear, which makes each shift logical."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + ((x >> 4) & 0x0FFFFFFF)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _first_argmin(d: torch.Tensor, dim: int):
    """(min, index of the first minimum) along ``dim``: the lowest index
    among equal minima, on every device."""
    best = torch.amin(d, dim=dim, keepdim=True)
    n = d.shape[dim]
    shape = [1, 1]
    shape[dim] = n
    ar = torch.arange(n, device=d.device).reshape(shape)
    idx = torch.amin(torch.where(d == best, ar, n), dim=dim)
    return best.squeeze(dim), idx


def _hamming(desc0: torch.Tensor, desc1: torch.Tensor) -> torch.Tensor:
    x = desc0[:, None, :] ^ desc1[None, :, :]                # (N0, N1, words)
    return torch.sum(_popcount32(x), dim=-1).to(torch.float32)


def _two_smallest(d: torch.Tensor):
    """(best, second, index of best) per row, ties to the lower index."""
    best, idx = _first_argmin(d, 1)
    rest = d.scatter(1, idx[:, None], float("inf"))
    return best, torch.amin(rest, dim=1), idx


def match_descriptors(desc0, mask0, desc1, mask1, ratio: float = 0.8, select: str = "knn"):
    """Brute-force Hamming matching of query (previous frame) against train
    (current frame) descriptors.

    ``select="knn"``: 2-NN and Lowe's ratio test.  ``select="nn"``: nearest
    neighbour with cross-checking (kept only when mutually nearest).
    Returns (match_idx (N0,) into desc1, valid (N0,))."""
    d = _hamming(desc0, desc1)
    d = torch.where(mask1[None, :], d, MASKED)
    if select == "nn":
        d = torch.where(mask0[:, None], d, MASKED)
        best, fwd = _first_argmin(d, 1)                      # (N0,)
        _, bwd = _first_argmin(d, 0)                         # (N1,)
        mutual = bwd[fwd] == torch.arange(desc0.shape[0], device=d.device)
        return fwd, mask0 & mutual & (best < 256.0)
    best, second, idx = _two_smallest(d)
    valid = mask0 & (best < ratio * second) & (best < 256.0)
    return idx, valid


@functools.lru_cache(maxsize=None)
def _probe_words(n_words: int, n_probe: int, seed: int, device: torch.device) -> torch.Tensor:
    """The approximate matcher's seeded word subset on ``device``, uploaded
    once (an upload per call would be a synchronising copy)."""
    probe = np.sort(np.random.default_rng(seed).permutation(n_words)[:n_probe])
    return torch.tensor(probe, device=device)


def match_descriptors_approx(desc0, mask0, desc1, mask1, ratio: float = 0.8,
                             n_probe_words: int = 2, rerank: int = 8, seed: int = 0):
    """Approximate Hamming matcher (the reference's FLANN analogue): the
    distance on a seeded subset of ``n_probe_words`` words prefilters
    ``rerank`` candidates per query, the full-width distance re-ranks those."""
    W = desc0.shape[1]
    p = _probe_words(W, n_probe_words, seed, desc0.device)
    d_pre = _hamming(desc0[:, p], desc1[:, p])
    d_pre = torch.where(mask1[None, :], d_pre, MASKED)
    # the `rerank` smallest in lax.top_k's order: ties to the lower index
    cand = torch.sort(d_pre, dim=1, stable=True).indices[:, :rerank]
    c1 = desc1[cand]                                         # (N0, rerank, W)
    d = torch.sum(_popcount32(desc0[:, None, :] ^ c1), dim=-1).to(torch.float32)
    d = torch.where(mask1[cand], d, MASKED)
    best, second, order = _two_smallest(d)
    idx = torch.gather(cand, 1, order[:, None])[:, 0]
    valid = mask0 & (best < ratio * second) & (best < float(W * 32))
    return idx, valid
