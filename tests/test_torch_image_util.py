"""The port's ImageUtil facade (``image_util``) against the JAX facade on
the same NumPy inputs, the contracts of tests/test_image_util.py on the
port, and ``vo_step`` with (orb, bf, shitomasi) and (brief, flann, fast)
against the JAX ``vo_step``.

Inputs: the reference tests' 192 x 256 blob textures from the ``rng``
fixture, the ``kitti_hdl64`` visual config (1024 keypoint slots).

The facade dispatches; each family's module is held against the reference
in its own file (tests/test_torch_brisk.py, _sift.py, _akaze.py, _orb.py).
Here the single-scale detectors, the ORB detector, ORB / BRIEF
descriptors, the NMS and the matchers on the reference's own descriptors
are held against the JAX facade (equal arrays: the same exact top-k, the
same integer or exact-f32 work, but the Shi-Tomasi response within 1e-6
relative: PyTorch's CPU sqrt is not always correctly rounded; the
descriptors as tests/test_torch_orb.py holds them), and each scale-space
family through the facade must equal the port's module called directly.
The KLT flow is held within 0.05 px.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_features
from test_torch_runtime import few_threads  # noqa: F401  (two threads a worker)
from torch_features import bits_of
from vloam_tpu import image_util as jiu
from vloam_tpu.config import kitti_hdl64
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch import image_util as tiu
from vloam_tpu_torch.ops import akaze as takaze
from vloam_tpu_torch.ops import brisk as tbrisk
from vloam_tpu_torch.ops import sift as tsift

JCFG, TCFG = kitti_hdl64().visual, tconfig.kitti_hdl64().visual
NATURAL = {"brisk": "brisk", "freak": "brisk", "akaze": "akaze", "sift": "sift",
           "orb": "shitomasi", "brief": "shitomasi"}   # test_image_util.py:38-40


def texture(rng):
    return torch_features.texture(rng, blobs=80)


def port_kp(img, det, cfg=TCFG):
    return tiu.det_keypoints(torch.tensor(img), det, cfg)


def test_names_equal_reference():
    for name in ("DETECTOR_TYPES", "DESCRIPTOR_TYPES", "MATCHER_TYPES", "SELECT_TYPES"):
        assert getattr(tiu, name) == getattr(jiu, name), name


@pytest.mark.parametrize("det", tiu.DETECTOR_TYPES)
def test_every_detector(det, rng):
    img = texture(rng)
    kp = port_kp(img, det)
    # tests/test_image_util.py::test_every_detector, on the port
    assert kp.pts.shape == (TCFG.max_corners, 2)
    assert int(kp.mask.sum()) > 30, det
    assert kp.octave.dtype == torch.int32 and kp.angle.dtype == torch.float32
    if det in ("shitomasi", "fast", "orb"):
        want = jiu.det_keypoints(jnp.array(img), det, JCFG)
        for name, g, w in zip(tiu.Keypoints._fields, kp, want):
            if name == "response":    # an f32 sqrt: PyTorch's CPU one is not always correctly rounded
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{det} {name}")
        return
    # the scale-space families: the facade is the module, called directly
    t = torch.tensor(img)
    direct = {"brisk": lambda: tbrisk.brisk_detect(t, TCFG.max_corners, TCFG.fast_threshold),
              "akaze": lambda: takaze.detect(t, TCFG.max_corners),
              "sift": lambda: tsift.detect(t, TCFG.max_corners)}[det]()
    for name in ("pts", "mask", "response", "octave"):
        assert torch.equal(getattr(kp, name), getattr(direct, name)), (det, name)
    assert not kp.angle.any()


@pytest.mark.parametrize("desc", tiu.DESCRIPTOR_TYPES)
def test_every_descriptor_matches_translation(desc, rng):
    """tests/test_image_util.py::test_every_descriptor_matches_translation,
    on the port; ORB and BRIEF are also held against the JAX facade."""
    img0 = texture(rng)
    img1 = np.roll(img0, (0, 5), axis=(0, 1))
    kp0, kp1 = port_kp(img0, NATURAL[desc]), port_kp(img1, NATURAL[desc])
    d0, m0 = tiu.desc_keypoints(torch.tensor(img0), kp0, desc, TCFG)
    d1, m1 = tiu.desc_keypoints(torch.tensor(img1), kp1, desc, TCFG)
    assert d0.dtype == (torch.float32 if desc == "sift" else torch.int32)
    assert d0.shape[1] == {"sift": 128, "orb": 8, "brief": 8}.get(desc, 16)
    idx, ok = tiu.match(d0, m0, d1, m1)
    ok = ok.numpy()
    assert ok.sum() >= 15, desc
    med = np.median(kp1.pts.numpy()[idx.numpy()[ok]] - kp0.pts.numpy()[ok], axis=0)
    assert abs(med[0] - 5) < 1.5 and abs(med[1]) < 1.5, desc
    if desc in ("orb", "brief"):
        jkp = jiu.det_keypoints(jnp.array(img0), NATURAL[desc], JCFG)
        wd, wm = (np.asarray(x) for x in jiu.desc_keypoints(jnp.array(img0), jkp, desc, JCFG))
        np.testing.assert_array_equal(m0.numpy(), wm)
        same = (bits_of(d0) == wd).all(axis=1)[wm]
        # ORB's angle bin rounds atan2 of two f32 sums: tests/test_torch_orb.py's 1 %
        assert same.mean() >= (0.99 if desc == "orb" else 1.0), same.mean()


@pytest.mark.parametrize("matcher,select", [("bf", "nn"), ("bf", "knn"), ("flann", "knn")])
def test_matcher_modes(matcher, select, rng):
    """tests/test_image_util.py::test_matcher_modes on the port, and the
    port's matchers on the reference's descriptors: equal indices and masks."""
    img0 = texture(rng)
    img1 = np.roll(img0, (0, 4), axis=(0, 1))
    kp0, kp1 = port_kp(img0, "shitomasi"), port_kp(img1, "shitomasi")
    d0, m0 = tiu.desc_keypoints(torch.tensor(img0), kp0, "orb", TCFG)
    d1, m1 = tiu.desc_keypoints(torch.tensor(img1), kp1, "orb", TCFG)
    idx, ok = tiu.match(d0, m0, d1, m1, matcher_type=matcher, select=select)
    ok = ok.numpy()
    assert ok.sum() >= 20
    med = np.median(kp1.pts.numpy()[idx.numpy()[ok]] - kp0.pts.numpy()[ok], axis=0)
    assert abs(med[0] - 4) < 1.5 and abs(med[1]) < 1.5

    ref = []
    for img in (img0, img1):
        jkp = jiu.det_keypoints(jnp.array(img), "shitomasi", JCFG)
        ref += [np.asarray(x) for x in jiu.desc_keypoints(jnp.array(img), jkp, "orb", JCFG)]
    widx, wok = (np.asarray(x) for x in jiu.match(*map(jnp.array, ref), matcher_type=matcher,
                                                  select=select))
    args = [torch.tensor(x.view(np.int32) if x.dtype == np.uint32 else x) for x in ref]
    gidx, gok = tiu.match(*args, matcher_type=matcher, select=select)
    np.testing.assert_array_equal(gok.numpy(), wok)
    np.testing.assert_array_equal(gidx.numpy()[wok], widx[wok])


def test_nms_and_flow(rng):
    """tests/test_image_util.py::test_nms_and_flow on the port, and the NMS
    mask and the tracked points against the JAX facade's."""
    jcfg = dataclasses.replace(JCFG, keypoint_nms=True)
    tcfg = dataclasses.replace(TCFG, keypoint_nms=True)
    img0 = texture(rng)
    img1 = np.roll(img0, (0, 3), axis=(0, 1))
    kp = tiu.key_points_nms(port_kp(img0, "shitomasi", tcfg), tcfg)
    assert int(kp.mask.sum()) > 10
    curr, ok = tiu.calculate_optical_flow(torch.tensor(img0), torch.tensor(img1), kp, tcfg)
    ok = ok.numpy() & kp.mask.numpy()
    flow = curr.numpy()[ok] - kp.pts.numpy()[ok]
    assert ok.sum() > 10
    assert abs(np.median(flow[:, 0]) - 3) < 0.5

    jkp = jiu.key_points_nms(jiu.det_keypoints(jnp.array(img0), "shitomasi", jcfg), jcfg)
    np.testing.assert_array_equal(kp.mask.numpy(), np.asarray(jkp.mask))
    jcurr, jok = jiu.calculate_optical_flow(jnp.array(img0), jnp.array(img1), jkp, jcfg)
    both = ok & np.asarray(jok)
    assert both.sum() >= 0.98 * ok.sum()
    np.testing.assert_allclose(curr.numpy()[both], np.asarray(jcurr)[both], rtol=0, atol=0.05)


def test_unknown_names_raise(rng):
    img = torch.tensor(texture(rng))
    kp = port_kp(texture(rng), "shitomasi")
    with pytest.raises(ValueError, match="detector_type"):
        tiu.det_keypoints(img, "harris", TCFG)
    with pytest.raises(ValueError, match="descriptor_type"):
        tiu.desc_keypoints(img, kp, "surf", TCFG)
    d, m = tiu.desc_keypoints(img, kp, "orb", TCFG)
    with pytest.raises(ValueError, match="matcher_type"):
        tiu.match(d, m, d, m, matcher_type="lsh")
    with pytest.raises(ValueError, match="int32 words or float32"):
        tiu.match(d.to(torch.int64), m, d.to(torch.int64), m)


@pytest.mark.parametrize("case", ["orb", "brief"])
def test_vo_step_matches_reference(case, rng):
    torch_features.check(case, rng)
