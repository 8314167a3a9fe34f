"""The port's BRISK detector and BRISK / FREAK descriptors (``ops/brisk``)
against the JAX module on the same NumPy inputs, the contracts of
tests/test_brisk.py on the port, and ``vo_step`` with (brisk, brisk, bf)
and (brisk, freak, bf) against the JAX ``vo_step``.

Inputs: the reference tests' 192 x 256 blob textures from the ``rng``
fixture, 256 keypoint slots.

Bounds, with their reasons:
  * the pattern, pair and tap tables, and ``_pack_bits``: NumPy or integer
    work, bit-equal;
  * ``brisk_detect``: the FAST responses are the same f32 sums in the same
    order and the per-octave top-k is exact in both (ties to the lower
    index): ``pts``, ``octave`` and ``mask`` equal, ``response`` within
    1e-4 relative (measured: equal);
  * descriptors on the reference's keypoints: the port samples by a
    four-tap gather where the reference multiplies by its dense bank, the
    same bf16-rounded products added in another order, and the orientation
    is an f32 product whose sum order differs between XLA and PyTorch.  A
    sampled intensity may move by an ulp, which flips a near-tie bit, or an
    angle on a bin edge may land in the next bin, which changes the whole
    descriptor.  So >= 99 % of the valid descriptors are bit-identical, and
    every other one differs in <= 16 of its 512 bits or has its rotation
    bin one off (measured: all identical); validity is equal;
  * ``vo_step``: tests/torch_features.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_features
from test_torch_runtime import few_threads  # noqa: F401  (two threads a worker)
from torch_features import MIN_SAME, assert_binary_close, bits_of
from vloam_tpu.ops import brisk as jbrisk
from vloam_tpu_torch.ops import brisk as tbrisk
from vloam_tpu_torch.ops import orb as torb

N_KP = 256


def texture(rng):
    return torch_features.texture(rng, blobs=80)


def test_tables_equal_reference():
    for name in ("_BRISK_XY", "_BRISK_LV", "_BRISK_SHORT", "_BRISK_LONG", "_FREAK_XY",
                 "_FREAK_LV", "_FREAK_DESC_PAIRS", "_FREAK_ORI_PAIRS"):
        got, want = getattr(tbrisk, name), getattr(jbrisk, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for xy, lv in ((tbrisk._BRISK_XY, tbrisk._BRISK_LV), (tbrisk._FREAK_XY, tbrisk._FREAK_LV)):
        for n_rot in (1, tbrisk.N_ROT):
            for got, want in zip(tbrisk._pattern_tap_bank(xy, lv, n_rot),
                                 jbrisk._pattern_tap_bank(xy, lv, n_rot)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


def test_pack_bits_matches_reference(rng):
    bits = rng.random((37, tbrisk.N_BITS)) < 0.5
    bits[0] = True                                        # every word's sign bit set
    want = np.asarray(jbrisk._pack_bits(jnp.array(bits)))
    np.testing.assert_array_equal(bits_of(torb.pack_bits(torch.tensor(bits))), want)


@pytest.fixture(scope="module")
def pair():
    """The image and its keypoints through both detectors."""
    img = texture(np.random.default_rng(0))
    jkp = jbrisk.brisk_detect(jnp.array(img), N_KP)
    tkp = tbrisk.brisk_detect(torch.tensor(img), N_KP)
    return img, jkp, tkp


def test_brisk_detect_matches_reference(pair):
    img, jkp, tkp = pair
    for name in ("pts", "octave", "mask"):
        np.testing.assert_array_equal(getattr(tkp, name).numpy(), np.asarray(getattr(jkp, name)),
                                      err_msg=name)
    np.testing.assert_allclose(tkp.response.numpy(), np.asarray(jkp.response), rtol=1e-4, atol=0)
    # the contract of tests/test_brisk.py::test_brisk_detect, on the port
    mask = tkp.mask.numpy()
    assert mask.sum() > 60
    pts = tkp.pts.numpy()[mask]
    assert (pts >= 0).all() and pts[:, 0].max() < img.shape[1] and pts[:, 1].max() < img.shape[0]
    assert len(np.unique(tkp.octave.numpy()[mask])) >= 2


def reference_bins(img, jkp, family):
    """The reference's rotation bins (vloam_tpu/ops/brisk.py:319-326,
    :339-347), from its own upright sampling."""
    if family == "brisk":
        xy, lv, pi, pj = jbrisk._BRISK_XY, jbrisk._BRISK_LV, jbrisk._BRISK_LONG[:, 1], \
            jbrisk._BRISK_LONG[:, 0]
    else:
        xy, lv, pi, pj = jbrisk._FREAK_XY, jbrisk._FREAK_LV, jbrisk._FREAK_ORI_PAIRS[:, 0], \
            jbrisk._FREAK_ORI_PAIRS[:, 1]
    vals, _ = jbrisk._sample_pattern(jnp.array(img), jkp, xy, lv, None)
    pat = jnp.asarray(xy)
    dxy = jnp.take(pat, pi, 0) - jnp.take(pat, pj, 0)
    dI = jnp.take(vals, pi, 1) - jnp.take(vals, pj, 1)
    if family == "brisk":
        g = jnp.einsum("nl,lk->nk", dI / jnp.maximum(jnp.sum(dxy ** 2, -1), 1e-9), dxy)
    else:
        dxy = dxy / jnp.maximum(jnp.linalg.norm(dxy, axis=-1, keepdims=True), 1e-9)
        g = jnp.einsum("nl,lk->nk", dI, dxy)
    angle = jnp.arctan2(g[:, 1], g[:, 0])
    return np.asarray(jnp.mod(jnp.round(angle * (jbrisk.N_ROT / (2.0 * jnp.pi))).astype(jnp.int32),
                              jbrisk.N_ROT))


@pytest.mark.parametrize("family", ["brisk", "freak"])
def test_descriptors_match_reference(pair, family):
    """Both sides describe the reference's keypoints."""
    img, jkp, _ = pair
    jfn = getattr(jbrisk, f"{family}_descriptors")
    tfn = getattr(tbrisk, f"{family}_descriptors")
    jd, jv = (np.asarray(x) for x in jfn(jnp.array(img), jkp))
    td, tv = tfn(torch.tensor(img), tbrisk.ScaleKeypoints(*(torch.tensor(np.asarray(x))
                                                            for x in jkp)))
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert jv.sum() > 60 and td.shape == (N_KP, 16)

    tbins = tbrisk._orientation_bins(torch.tensor(img), tbrisk.ScaleKeypoints(
        *(torch.tensor(np.asarray(x)) for x in jkp)), family)[0].numpy()
    jbins = reference_bins(img, jkp, family)
    assert (tbins == jbins)[jv].mean() >= MIN_SAME
    off_one = lambda r: (tbins[r] - jbins[r]) % tbrisk.N_ROT in (1, tbrisk.N_ROT - 1)  # noqa: E731
    assert_binary_close(bits_of(td), jd, jv, off_one)


def _match_translation(rng, describe, shift=6, min_matches=25):
    """tests/test_brisk.py::_match_translation on the port, 256 slots."""
    img0 = texture(rng)
    img1 = np.roll(img0, (0, shift), axis=(0, 1))
    kp0 = tbrisk.brisk_detect(torch.tensor(img0), N_KP)
    kp1 = tbrisk.brisk_detect(torch.tensor(img1), N_KP)
    d0, m0 = describe(torch.tensor(img0), kp0)
    d1, m1 = describe(torch.tensor(img1), kp1)
    idx, ok = torb.match_descriptors(d0, m0, d1, m1, ratio=0.8)
    ok = ok.numpy()
    assert ok.sum() >= min_matches
    med = np.median(kp1.pts.numpy()[idx.numpy()[ok]] - kp0.pts.numpy()[ok], axis=0)
    assert abs(med[0] - shift) < 1.5 and abs(med[1]) < 1.5


@pytest.mark.parametrize("family", ["brisk", "freak"])
def test_descriptor_matching_translation(rng, family):
    _match_translation(rng, getattr(tbrisk, f"{family}_descriptors"))


def test_brisk_rotation_tolerance(rng):
    """Orientation normalisation keeps matches under a 90-degree rotation
    (tests/test_brisk.py::test_brisk_rotation_tolerance, on the port)."""
    img0 = texture(rng)
    img1 = np.rot90(img0).copy()
    kp0 = tbrisk.brisk_detect(torch.tensor(img0), N_KP)
    kp1 = tbrisk.brisk_detect(torch.tensor(img1), N_KP)
    d0, m0 = tbrisk.brisk_descriptors(torch.tensor(img0), kp0)
    d1, m1 = tbrisk.brisk_descriptors(torch.tensor(img1), kp1)
    idx, ok = torb.match_descriptors(d0, m0, d1, m1, ratio=0.75)
    ok = ok.numpy()
    assert ok.sum() >= 10
    p0 = kp0.pts.numpy()[ok]
    p1 = kp1.pts.numpy()[idx.numpy()[ok]]
    pred = np.stack([p0[:, 1], img0.shape[1] - 1 - p0[:, 0]], -1)
    assert np.median(np.linalg.norm(pred - p1, axis=1)) < 4.0


@pytest.mark.parametrize("case", ["brisk", "freak"])
def test_vo_step_matches_reference(case, rng):
    torch_features.check(case, rng)
