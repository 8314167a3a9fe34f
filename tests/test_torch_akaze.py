"""The port's AKAZE (``ops/akaze``) against the JAX module on the same NumPy
inputs, the contracts of tests/test_akaze.py on the port, and ``vo_step``
with (akaze, akaze, bf) against the JAX ``vo_step``.

Inputs: the reference tests' 192 x 256 blob textures from the ``rng``
fixture, 256 keypoint slots.

Bounds, with their reasons:
  * the cell pairs and the sampling bank: bit-equal;
  * the scale space: the contrast factor is the mean of an f32 image, a sum
    whose order differs between XLA and PyTorch (and PyTorch's CPU sqrt is
    not always correctly rounded), so k moves by an ulp and the 72
    diffusion steps carry that along: within 1e-3 on the 0-255 scale
    (measured: 3.8e-5);
  * ``detect``: a determinant-of-Hessian response of the diffused images
    moves by ~1e-5 relative, which can swap two near-equal responses
    around a top-k slot: >= 98 % of the slots have equal ``pts``,
    ``octave`` and ``mask``, and on those ``response`` is within 1e-4
    relative (measured on this image: 254 of 256 slots, 1.9e-5; another
    seed reaches 1.1e-4);
  * ``describe`` on the reference's keypoints (its own scale space): the
    orientation is an f32 sum of 1024 terms and the cell means sums of
    36-144, whose orders differ between XLA and PyTorch, and the sampling
    is a four-tap gather where the reference multiplies by its dense bank.
    So >= 99 % of the valid descriptors are bit-identical and every other
    one differs in <= 16 of its 512 bits or has its rotation bin one off
    (measured: all identical); validity is equal, and the quantised angle
    equal on >= 99 % of the keypoints;
  * ``vo_step``: tests/torch_features.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_features
from test_torch_runtime import few_threads  # noqa: F401  (two threads a worker)
from torch_features import MIN_SAME, assert_binary_close, bits_of
from vloam_tpu.ops import akaze as jakaze
from vloam_tpu_torch.ops import akaze as takaze
from vloam_tpu_torch.ops import orb as torb

N_KP = 256
MIN_SLOTS = 0.98


def texture(rng):
    return torch_features.texture(rng, blobs=80)


def test_tables_equal_reference():
    np.testing.assert_array_equal(takaze._PAIRS, jakaze._PAIRS)
    assert takaze._PAIRS.shape == (162, 2)
    for got, want in zip(takaze._rot_bank_build(), jakaze._rot_bank()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_diffusion_preserves_edges(rng):
    """tests/test_akaze.py::test_diffusion_preserves_edges on the port, and
    the same scale space as the reference's."""
    img = np.zeros((64, 64), np.float32)
    img[:, 32:] = 200.0
    img += rng.normal(0, 4, img.shape).astype(np.float32)
    octs = takaze.nonlinear_scale_space(torch.tensor(img))
    out = octs[0][-1].numpy()
    assert out[10:50, 5:25].std() < img[10:50, 5:25].std() * 0.7
    assert np.abs(out[:, 33] - out[:, 30]).mean() > 120.0
    for g, w in zip(octs, jakaze.nonlinear_scale_space(jnp.array(img))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def pair():
    img = texture(np.random.default_rng(0))
    return img, jakaze.detect(jnp.array(img), N_KP), takaze.detect(torch.tensor(img), N_KP)


def test_detect_matches_reference(pair):
    img, jkp, tkp = pair
    for g, w in zip(takaze.nonlinear_scale_space(torch.tensor(img)),
                    jakaze.nonlinear_scale_space(jnp.array(img))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-3)
    same = ((tkp.pts.numpy() == np.asarray(jkp.pts)).all(axis=1)
            & (tkp.octave.numpy() == np.asarray(jkp.octave))
            & (tkp.mask.numpy() == np.asarray(jkp.mask)))
    assert same.mean() >= MIN_SLOTS, same.mean()
    np.testing.assert_allclose(tkp.response.numpy()[same], np.asarray(jkp.response)[same],
                               rtol=1e-4, atol=0)
    np.testing.assert_array_equal(tkp.angle.numpy(), 0.0)
    # the contract of tests/test_akaze.py::test_akaze_detect, on the port
    mask = tkp.mask.numpy()
    assert mask.sum() > 40
    pts = tkp.pts.numpy()[mask]
    assert (pts >= 0).all() and pts[:, 0].max() < img.shape[1] and pts[:, 1].max() < img.shape[0]


def test_describe_matches_reference(pair):
    img, jkp, _ = pair
    jd, jv, jk = jakaze.describe(jnp.array(img), jkp)
    jd, jv = np.asarray(jd), np.asarray(jv)
    td, tv, tk = takaze.describe(torch.tensor(img), takaze.AkazeKeypoints(
        *(torch.tensor(np.asarray(x)) for x in jkp)))
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert jv.sum() > 40 and td.shape == (N_KP, 16)
    step = 2 * np.pi / takaze.N_ROT
    tbins = np.round(tk.angle.numpy() / step).astype(np.int64)
    jbins = np.round(np.asarray(jk.angle) / step).astype(np.int64)
    assert (tbins == jbins)[jv].mean() >= MIN_SAME
    off_one = lambda r: (tbins[r] - jbins[r]) % takaze.N_ROT in (1, takaze.N_ROT - 1)  # noqa: E731
    assert_binary_close(bits_of(td), jd, jv, off_one)


def test_akaze_matching_translation(rng):
    """tests/test_akaze.py::test_akaze_matching_translation on the port."""
    img0 = texture(rng)
    shift = 6
    img1 = np.roll(img0, (0, shift), axis=(0, 1))
    kp0, d0, m0 = takaze.akaze_features(torch.tensor(img0), N_KP)
    kp1, d1, m1 = takaze.akaze_features(torch.tensor(img1), N_KP)
    idx, ok = torb.match_descriptors(d0, m0, d1, m1, ratio=0.8)
    ok = ok.numpy()
    assert ok.sum() >= 20
    med = np.median(kp1.pts.numpy()[idx.numpy()[ok]] - kp0.pts.numpy()[ok], axis=0)
    assert abs(med[0] - shift) < 1.5 and abs(med[1]) < 1.5


def test_vo_step_matches_reference(rng):
    torch_features.check("akaze", rng)
