"""The port's ORB/BRIEF descriptors and Hamming matchers (``ops/orb``)
against the JAX functions on the same NumPy inputs (the cases of
tests/test_orb.py).

Descriptor words are int32 in the port and uint32 in the reference: the
comparison is on the bits (``view(np.uint32)``).

Bounds, with their reasons:
  * popcount, both ``_descriptor_bits`` formulations and the matchers
    (masks, and indices on valid rows) are integer or exact-f32 work:
    equality.  The matchers break distance ties to the lower index in both;
    one case is built to have many ties;
  * ``orb_descriptors``: the angle bin rounds ``atan2`` of two f32 sums of
    1024 terms whose order differs between XLA and PyTorch, so a keypoint on
    a bin edge may land in the neighbouring bin and then its whole
    descriptor differs.  Descriptors are equal wherever the bins agree
    (detected as: all 8 words equal), and at most 1 % of the valid
    keypoints may differ (measured on this pair: 0 of 385 valid keypoints on both
    images).  BRIEF has no bin: equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.config import VisualConfig
from vloam_tpu.data import synthetic as jsyn
from vloam_tpu.ops import image_ops as jio
from vloam_tpu.ops import orb as jorb
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch.ops import orb as torb

VC = VisualConfig(img_height=376, img_width=1248)
TVC = tconfig.VisualConfig(img_height=376, img_width=1248)
MAX_FLIPPED = 0.01


def bits(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.int32
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def blob_pair():
    """tests/test_orb.py's pair: 400 blobs, a pure shift of (6, -3) px."""
    rng = np.random.default_rng(3)
    pts = np.stack([rng.uniform(40, VC.img_width - 40, 400),
                    rng.uniform(40, VC.img_height - 40, 400), np.ones(400)], axis=-1)
    img0 = jsyn.render_blob_image(pts, np.eye(3), VC.img_height, VC.img_width, seed=5)
    pts1 = pts.copy()
    pts1[:, :2] += np.array([6.0, -3.0])
    img1 = jsyn.render_blob_image(pts1, np.eye(3), VC.img_height, VC.img_width, seed=5)
    return np.asarray(img0, np.float32), np.asarray(img1, np.float32)


@pytest.fixture(scope="module")
def described(blob_pair):
    """Per image and descriptor kind: the reference's corners and both
    sides' descriptors on them."""
    out = {}
    for i, img in enumerate(blob_pair):
        kp, mask, _ = jio.detect_corners(jnp.array(img), VC)
        kp, mask = np.asarray(kp), np.asarray(mask)
        for rotate in (True, False):
            jd, jm = jorb.orb_descriptors(jnp.array(img), jnp.array(kp), jnp.array(mask), VC,
                                          rotate=rotate)
            td, tm = torb.orb_descriptors(torch.tensor(img), torch.tensor(kp), torch.tensor(mask),
                                          TVC, rotate=rotate)
            out[(i, rotate)] = (np.asarray(jd), np.asarray(jm), td, tm)
    return out


def test_popcount():
    x = np.array([0, 1, 3, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0xF0F0F0F0], np.uint32)
    got = torb._popcount32(torch.tensor(x.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), [0, 1, 2, 32, 1, 31, 16])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jorb._popcount32(jnp.array(x))))


def test_popcount_random(rng):
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    got = torb._popcount32(torch.tensor(x.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jorb._popcount32(jnp.array(x))))


def test_pattern_banks_equal_reference():
    np.testing.assert_array_equal(torb._PAT, jorb._PAT)
    np.testing.assert_array_equal(torb._BANK1, jorb._BANK1)
    np.testing.assert_array_equal(torb._BANK2, jorb._BANK2)


@pytest.mark.parametrize("use_matmul", [False, True])
def test_descriptor_bits(use_matmul):
    rng = np.random.default_rng(7)
    flat = rng.uniform(0, 255, (64, torb.PATCH * torb.PATCH)).astype(np.float32)
    abin = rng.integers(0, torb.N_ANGLES, 64).astype(np.int32)
    want = np.asarray(jorb._descriptor_bits(jnp.array(flat), jnp.array(abin), use_matmul=use_matmul))
    got = torb._descriptor_bits(torch.tensor(flat), torch.tensor(abin), use_matmul=use_matmul)
    np.testing.assert_array_equal(got.numpy(), want)
    other = torb._descriptor_bits(torch.tensor(flat), torch.tensor(abin), use_matmul=not use_matmul)
    assert torch.equal(got, other)


@pytest.mark.parametrize("image", [0, 1])
@pytest.mark.parametrize("rotate", [True, False])
def test_descriptors(described, image, rotate):
    jd, jm, td, tm = described[(image, rotate)]
    assert tuple(td.shape) == jd.shape == (VC.max_features, 8)
    np.testing.assert_array_equal(tm.numpy(), jm)
    same = (bits(td) == jd).all(axis=1)
    n_valid = int(jm.sum())
    flipped = int((~same & jm).sum())
    assert n_valid > 300
    if rotate:
        # rows differ only as whole descriptors (another angle bin), and rarely
        assert flipped <= MAX_FLIPPED * n_valid, (flipped, n_valid)
    else:
        assert flipped == 0
    print(f"image {image} rotate={rotate}: {flipped} of {n_valid} valid descriptors differ")


def match_both(d0, m0, d1, m1, **kw):
    want = jorb.match_descriptors(jnp.array(d0), jnp.array(m0), jnp.array(d1), jnp.array(m1), **kw)
    t = lambda d: torch.tensor(d.view(np.int32))  # noqa: E731
    got = torb.match_descriptors(t(d0), torch.tensor(m0), t(d1), torch.tensor(m1), **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def assert_matches_equal(want, got):
    (widx, wvalid), (gidx, gvalid) = want, got
    np.testing.assert_array_equal(gvalid, wvalid)
    np.testing.assert_array_equal(gidx[wvalid], widx[wvalid])
    return int(wvalid.sum())


@pytest.mark.parametrize("select", ["knn", "nn"])
@pytest.mark.parametrize("rotate", [True, False])
def test_match_descriptors(described, select, rotate):
    """The reference's descriptors of both images through both matchers."""
    d0, m0, _, _ = described[(0, rotate)]
    d1, m1, _, _ = described[(1, rotate)]
    want, got = match_both(d0, m0, d1, m1, select=select)
    n = assert_matches_equal(want, got)
    assert n > (100 if select == "knn" else 50)          # tests/test_orb.py:56, :101
    # unmasked rows too: the index rule is the same everywhere
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("select", ["knn", "nn"])
def test_match_descriptors_with_ties(select, rng):
    """Descriptors with few distinct bits: most rows have several train
    descriptors at the minimum distance, duplicates included."""
    base = rng.integers(0, 4, (24, 8)).astype(np.uint32)           # 2 live bits a word
    d0 = base[rng.integers(0, 24, 128)] ^ (rng.random((128, 8)) < 0.1).astype(np.uint32) * 4
    d1 = np.tile(base, (4, 1))[rng.permutation(96)]                # every row four times
    m0, m1 = rng.random(128) < 0.9, rng.random(96) < 0.9
    want, got = match_both(d0, m0, d1, m1, select=select, ratio=1.1)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    x = d0[:, None, :] ^ d1[None, :, :]
    d = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.float32)
    d[:, ~m1] = 1e9
    tied = (d == d.min(axis=1, keepdims=True)).sum(axis=1) > 1
    assert tied.mean() > 0.5


def test_match_descriptors_approx(described):
    d0, m0, _, _ = described[(0, True)]
    d1, m1, _, _ = described[(1, True)]
    want = jorb.match_descriptors_approx(jnp.array(d0), jnp.array(m0), jnp.array(d1), jnp.array(m1))
    t = lambda d: torch.tensor(d.view(np.int32))  # noqa: E731
    got = torb.match_descriptors_approx(t(d0), torch.tensor(m0), t(d1), torch.tensor(m1))
    assert_matches_equal([np.asarray(w) for w in want], [g.numpy() for g in got])


def test_self_match_and_shift(blob_pair, described):
    """tests/test_orb.py's behaviour checks on the port alone: a frame
    matched against itself is the identity, and across the shift most
    ratio-test survivors carry the true flow."""
    _, _, td0, tm0 = described[(0, True)]
    _, _, td1, tm1 = described[(1, True)]
    idx, valid = torb.match_descriptors(td0, tm0, td0, tm0)
    v = valid.numpy()
    assert v.sum() > 0.8 * int(tm0.sum())
    np.testing.assert_array_equal(idx.numpy()[v], np.arange(len(v))[v])
    kp0 = np.asarray(jio.detect_corners(jnp.array(blob_pair[0]), VC)[0])
    kp1 = np.asarray(jio.detect_corners(jnp.array(blob_pair[1]), VC)[0])
    idx, valid = torb.match_descriptors(td0, tm0, td1, tm1)
    v = valid.numpy()
    assert v.sum() > 100
    flow = (kp1[idx.numpy()] - kp0)[v]
    good = np.abs(flow - np.array([6.0, -3.0])).max(axis=1) < 1.5
    assert good.mean() > 0.8
