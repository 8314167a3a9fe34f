"""The reference's random draw for RANSAC, reproduced exactly in NumPy.

The reference draws its minimal samples as the top 8 of a Gumbel draw per
hypothesis, ``lax.top_k(where(mask, jax.random.gumbel(PRNGKey(seed), (H, N)),
-inf), 8)`` (``vloam_tpu/ops/epipolar.find_essential_ransac``).  That draw is
threefry-2x32 (20 rounds) keyed by ``(0, seed)``, over counters laid out as
the flat index split into (hi, lo) 32-bit words; the 32 random bits of an
element are the XOR of threefry's two output words.  The Gumbel value is
``-log(-log(u))`` with ``u`` an increasing function of ``bits >> 9`` alone,
and distinct keys give distinct ``u``.  So ordering the 23-bit keys
descending, ties (the masked ``-1``s) to the lower index, selects the same
samples in the same order as ``lax.top_k`` over the Gumbel values, with no
float maths on either side.

The keys do not depend on the data: ``gumbel_keys`` builds them on the host
and ``device_keys`` uploads them once per (seed, H, N, device).  The
selection runs where the match mask lives (``select_samples``).
"""

from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
N_SAMPLE = 8   # the 8-point solver's minimal sample


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32, 20 rounds, on uint32 counter words ``x1``, ``x2`` under
    the key words ``k1``, ``k2`` (Salmon et al., SC 2011; JAX's
    ``threefry2x32_p``).  Returns the two uint32 output words."""
    ks = (np.uint32(k1), np.uint32(k2), np.uint32(k1) ^ np.uint32(k2) ^ _PARITY)
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key_words(seed: int) -> tuple[int, int]:
    """``PRNGKey(seed)``'s two words for a 32-bit integer seed: (0, seed mod 2^32)."""
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return 0, seed & 0xFFFFFFFF


def random_bits(seed: int, shape) -> np.ndarray:
    """``jax.random.bits(PRNGKey(seed), shape)`` (uint32), bit for bit."""
    n = int(np.prod(shape, dtype=np.int64))
    flat = np.arange(n, dtype=np.uint64)
    hi = (flat >> np.uint64(32)).astype(np.uint32)
    lo = (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = threefry2x32(*key_words(seed), hi, lo)
    return (b1 ^ b2).reshape(shape)


def gumbel_keys(seed: int, n_hypotheses: int, n: int) -> np.ndarray:
    """(H, N) int32 keys, each in [0, 2^23), ordered as the reference's
    Gumbel values of the same shape and seed."""
    return (random_bits(seed, (n_hypotheses, n)) >> np.uint32(9)).astype(np.int32)


_DEVICE_KEYS: dict = {}


def device_keys(seed: int, n_hypotheses: int, n: int, device) -> torch.Tensor:
    """``gumbel_keys`` as a tensor on ``device``, uploaded on first use and kept."""
    device = torch.device(device)
    key = (seed, n_hypotheses, n, device)
    if key not in _DEVICE_KEYS:
        _DEVICE_KEYS[key] = torch.from_numpy(gumbel_keys(seed, n_hypotheses, n)).to(device)
    return _DEVICE_KEYS[key]


def select_samples(keys: torch.Tensor, mask: torch.Tensor, k: int = N_SAMPLE) -> torch.Tensor:
    """(H, k) int64 sample indices: per row, the k largest keys among the
    valid matches, then (when fewer than k are valid) the lowest masked
    indices, as ``lax.top_k`` orders -inf ties."""
    if keys.shape[1] < k:
        raise ValueError(f"select_samples: {keys.shape[1]} matches, fewer than {k}")
    masked = torch.where(mask[None, :], keys, -1)
    return torch.sort(masked, dim=1, descending=True, stable=True).indices[:, :k]
