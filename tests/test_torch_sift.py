"""The port's SIFT (``ops/sift``) against the JAX module on the same NumPy
inputs, the contracts of tests/test_sift.py on the port, and ``vo_step``
with (sift, sift, flann) against the JAX ``vo_step``.

Inputs: the reference tests' 192 x 256 blob textures from the ``rng``
fixture, 256 keypoint slots.

Bounds, with their reasons:
  * the sampling bank and the FLANN projection: bit-equal (the projection
    is JAX's threefry draw, carried by the port as a constant and
    regenerated here);
  * the Gaussian octaves: the same separable taps summed in the same
    order, within 1e-4 on the 0-255 scale (measured: equal);
  * ``detect``: ``pts``, ``octave``, ``level`` and ``mask`` equal,
    ``response`` within 1e-4 relative (measured: equal);
  * ``orient`` on the reference's keypoints: the histogram is an f32 sum of
    576 terms whose order differs between XLA and PyTorch, so a peak may
    tie-break to the neighbouring bin: the angle is equal on >= 99 % of the
    valid keypoints (measured: all);
  * ``describe`` on the reference's oriented keypoints: within 1e-4
    wherever the orientation bin agrees, which it does on >= 99 %
    (measured: 9e-8);
  * the matchers on the reference's descriptors: equal indices and masks
    (distances are f32 dot products; no near-ties on these inputs);
  * ``vo_step``: tests/torch_features.py, with the 128-float state carried.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_features
from test_torch_runtime import few_threads  # noqa: F401  (two threads a worker)
from torch_features import MIN_SAME
from vloam_tpu.ops import sift as jsift
from vloam_tpu_torch.ops import sift as tsift

N_KP = 256


def texture(rng):
    return torch_features.texture(rng, blobs=60)


def to_port(kp):
    return tsift.SiftKeypoints(*(torch.tensor(np.asarray(x)) for x in kp))


def test_rot_bank_equals_reference():
    for got, want in zip(tsift._sift_rot_bank(), jsift._sift_rot_bank()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_flann_projection_equals_jax_draw():
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(tsift.FLANN_PROJ_SEED),
                                        (128, tsift.FLANN_PROJ_DIM))
                      / math.sqrt(tsift.FLANN_PROJ_DIM))
    got = np.load(tsift.FLANN_PROJ_FILE)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    d = torch.zeros((4, 128))
    m = torch.ones((4,), dtype=torch.bool)
    for kw in (dict(seed=1), dict(proj_dim=16)):
        with pytest.raises(ValueError, match="sift_flann_proj.npy"):
            tsift.match_float_descriptors_approx(d, m, d, m, **kw)


@pytest.fixture(scope="module")
def ref():
    """One image through the reference: octaves, keypoints, oriented
    keypoints, descriptors; and a shifted copy's descriptors to match."""
    img0 = texture(np.random.default_rng(0))
    img1 = np.roll(img0, (0, 4), axis=(0, 1))
    octs = jsift.gaussian_octaves(jnp.array(img0))
    kp = jsift.detect(jnp.array(img0), N_KP)
    okp = jsift.orient(octs, kp)
    desc, _ = jsift.describe(octs, okp)
    kp1, desc1 = jsift.sift_features(jnp.array(img1), N_KP)
    return dict(img=img0, octs=octs, kp=kp, okp=okp, desc=np.asarray(desc), mask=np.asarray(kp.mask),
                desc1=np.asarray(desc1), mask1=np.asarray(kp1.mask))


def test_gaussian_octaves_match_reference(ref):
    got = tsift.gaussian_octaves(torch.tensor(ref["img"]))
    assert len(got) == len(ref["octs"]) == tsift.N_OCTAVES
    for g, w in zip(got, ref["octs"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def test_detect_matches_reference(ref):
    img, want = ref["img"], ref["kp"]
    got = tsift.detect(torch.tensor(img), N_KP)
    for name in ("pts", "octave", "level", "mask", "angle"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.response.numpy(), np.asarray(want.response), rtol=1e-4, atol=0)
    # the contract of tests/test_sift.py::test_detect_finds_blobs, on the port
    mask = got.mask.numpy()
    assert mask.sum() > 50
    pts = got.pts.numpy()[mask]
    assert (pts >= 0).all() and pts[:, 0].max() < img.shape[1] and pts[:, 1].max() < img.shape[0]


def test_orient_and_describe_match_reference(ref):
    octs = tsift.gaussian_octaves(torch.tensor(ref["img"]))
    okp = tsift.orient(octs, to_port(ref["kp"]))
    mask = ref["mask"]
    same = okp.angle.numpy() == np.asarray(ref["okp"].angle)
    assert same[mask].mean() >= MIN_SAME, same[mask].mean()
    # the descriptor from the reference's orientation, compared where the bins agree
    desc, dmask = tsift.describe(octs, to_port(ref["okp"]))
    np.testing.assert_array_equal(dmask.numpy(), mask)
    assert desc.shape == (N_KP, 128) and desc.dtype == torch.float32
    rows = mask & same
    np.testing.assert_allclose(desc.numpy()[rows], ref["desc"][rows], rtol=0, atol=1e-4)


@pytest.mark.parametrize("matcher,select", [("bf", "nn"), ("bf", "knn"), ("flann", "knn")])
def test_float_matchers_match_reference(ref, matcher, select):
    args = (ref["desc"], ref["mask"], ref["desc1"], ref["mask1"])
    if matcher == "bf":
        want = jsift.match_float_descriptors(*map(jnp.array, args), select=select)
        got = tsift.match_float_descriptors(*map(torch.tensor, args), select=select)
    else:
        want = jsift.match_float_descriptors_approx(*map(jnp.array, args))
        got = tsift.match_float_descriptors_approx(*map(torch.tensor, args))
    widx, wok = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[1].numpy(), wok)
    np.testing.assert_array_equal(got[0].numpy()[wok], widx[wok])
    assert wok.sum() >= 30


def _features(img):
    return tsift.sift_features(torch.tensor(img), N_KP)


def test_translation_matching(rng):
    """tests/test_sift.py::test_translation_matching on the port."""
    img0 = texture(rng)
    shift = 6
    img1 = np.roll(img0, (0, shift), axis=(0, 1))
    (kp0, d0), (kp1, d1) = _features(img0), _features(img1)
    idx, ok = tsift.match_float_descriptors(d0, kp0.mask, d1, kp1.mask)
    ok = ok.numpy()
    assert ok.sum() >= 30
    med = np.median(kp1.pts.numpy()[idx.numpy()[ok]] - kp0.pts.numpy()[ok], axis=0)
    assert abs(med[0] - shift) < 1.0 and abs(med[1]) < 1.0


def test_rotation_invariance(rng):
    """tests/test_sift.py::test_rotation_invariance on the port."""
    img0 = texture(rng)
    img1 = np.rot90(img0).copy()
    (kp0, d0), (kp1, d1) = _features(img0), _features(img1)
    idx, ok = tsift.match_float_descriptors(d0, kp0.mask, d1, kp1.mask, ratio=0.75)
    ok = ok.numpy()
    assert ok.sum() >= 20
    p0 = kp0.pts.numpy()[ok]
    p1 = kp1.pts.numpy()[idx.numpy()[ok]]
    pred = np.stack([p0[:, 1], img0.shape[1] - 1 - p0[:, 0]], -1)
    assert np.median(np.linalg.norm(pred - p1, axis=1)) < 3.0


def test_flann_equivalent_matches_exact(rng):
    """tests/test_sift.py::test_flann_equivalent_matches_exact on the port."""
    img0 = texture(rng)
    img1 = np.roll(img0, (0, 4), axis=(0, 1))
    (kp0, d0), (kp1, d1) = _features(img0), _features(img1)
    i_ex, ok_ex = tsift.match_float_descriptors(d0, kp0.mask, d1, kp1.mask)
    i_ap, ok_ap = tsift.match_float_descriptors_approx(d0, kp0.mask, d1, kp1.mask)
    ok_ex, ok_ap = ok_ex.numpy(), ok_ap.numpy()
    both = ok_ex & ok_ap
    assert both.sum() > 0.7 * max(ok_ex.sum(), 1)
    assert (i_ex.numpy()[both] == i_ap.numpy()[both]).mean() > 0.9


def test_vo_step_matches_reference(rng):
    torch_features.check("sift", rng)
