"""The port's frontend options against the JAX package: the FAST detector,
bucketed keypoint NMS and CLAHE, alone and inside ``vo_step``.

* ``fast_response`` on an image with corners planted at the border, where
  the circle wraps: equal arrays (the 16 excess terms are summed in the
  reference's order).
* ``detect_corners(detector_type="fast")``: equal corners, mask and
  response (the port's exact top-k is the reference's CPU branch); an
  unknown detector raises ``ValueError`` as in the reference.
* ``bucket_nms`` on random keypoints with ties, masked rows and points on
  bucket edges: equal masks.
* ``clahe`` on a full 376 x 1248 blob image and on a noisy one: within
  1e-3 on the 0-255 scale (the CDFs are float32 cumulative sums).
* ``vo_step`` with ``clahe``, ``keypoint_nms`` and ``detector_type="fast"``
  over three blob frames of the synthetic course against the JAX
  ``vo_step`` (un-jitted): the f2f pose within 4 mm and 1e-3 rad, the
  detected keypoints' masks agreeing on >= 98 % of the slots.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.config import kitti_hdl64
from vloam_tpu.models import visual_odometry as jvo
from vloam_tpu.ops import clahe as jclahe
from vloam_tpu.ops import image_ops as jimg
from vloam_tpu.ops.depth_map import DepthBuckets as JBuckets
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch.data import stream
from vloam_tpu_torch.models import frame_graph as tfg
from vloam_tpu_torch.models import visual_odometry as tvo
from vloam_tpu_torch.ops import clahe as tclahe
from vloam_tpu_torch.ops import image_ops as timg
from vloam_tpu_torch.ops.depth_map import DepthBuckets as TBuckets

N_FRAMES = 3
N_FEATURES = 256
SC = dict(ring_cap=512, max_points=32768, less_flat_cap=8192)
T_TOL, R_TOL = 4e-3, 1e-3
OPTIONS = dict(clahe=True, keypoint_nms=True, detector_type="fast",
               max_features=N_FEATURES, max_corners=N_FEATURES)


def _vis(**kw):
    j, t = kitti_hdl64(), tconfig.kitti_hdl64()
    return dataclasses.replace(j.visual, **kw), dataclasses.replace(t.visual, **kw)


def _corner_image(rng, H=96, W=160):
    """Bright squares on a noisy background, two of them cut by the image
    border (the circle wraps there) and one straddling a corner."""
    img = rng.uniform(0, 40, (H, W)).astype(np.float32)
    for y, x in ((20, 30), (50, 90), (70, 130), (-3, 60), (40, W - 4), (H - 5, W - 5)):
        img[max(y, 0):y + 9, max(x, 0):x + 9] = 200.0 + rng.uniform(0, 30)
    return img


def test_fast_response_matches_reference(rng):
    img = _corner_image(rng)
    want = np.asarray(jimg.fast_response(jnp.array(img), 20.0))
    got = timg.fast_response(torch.tensor(img), 20.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).sum() > 20
    # the wrap: responses on the border rows/columns come from the far side
    assert (want[:3] > 0).any() and (want[:, -3:] > 0).any()


def test_detect_corners_fast_matches_reference(rng):
    img = _corner_image(rng, 120, 200)
    jv, tv = _vis(detector_type="fast", max_corners=64)
    want = [np.asarray(x) for x in jimg.detect_corners(jnp.array(img), jv)]
    got = [x.numpy() for x in timg.detect_corners(torch.tensor(img), tv)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 5 < want[1].sum() < 64
    with pytest.raises(ValueError, match="detector_type"):
        timg.detect_corners(torch.tensor(img), dataclasses.replace(tv, detector_type="harris"))


def test_bucket_nms_matches_reference(rng):
    jv, tv = _vis(nms_max_total=120)           # 52 buckets at 376 x 1248: 2 a bucket
    n = 512
    pts = np.stack([rng.integers(0, 1248, n), rng.integers(0, 376, n)], -1).astype(np.float32)
    pts[:40, 0] = 100.0 * rng.integers(0, 12, 40)           # on bucket edges
    resp = rng.choice(np.linspace(1, 50, 20), n).astype(np.float32)   # many ties
    mask = rng.random(n) < 0.85
    want = np.asarray(jimg.bucket_nms(jnp.array(pts), jnp.array(mask), jnp.array(resp), jv))
    got = timg.bucket_nms(torch.tensor(pts), torch.tensor(mask), torch.tensor(resp), tv).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < mask.sum()


@pytest.fixture(scope="module")
def frames():
    _, tv = _vis()
    tcfg = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**SC))
    ext = tfg.kitti_default_extrinsics("cpu")
    fr, _ = stream.gen_frames(tcfg, ext, N_FRAMES, n_azimuth=600)
    K, _ = stream.camera_matrices(ext)
    return [(f[0], f[3]) for f in fr], K.astype(np.float32)


@pytest.mark.parametrize("image", ["blobs", "noise"])
def test_clahe_matches_reference(image, frames, rng):
    img = frames[0][0][0]
    if image == "noise":
        img = np.clip(img + rng.normal(0, 25, img.shape), -10, 270).astype(np.float32)
    want = np.asarray(jclahe.clahe(jnp.array(img), 2.0))
    got = tclahe.clahe(torch.tensor(img), 2.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert np.abs(want - img).max() > 10.0                  # it did equalise


@pytest.fixture(scope="module")
def runs(frames):
    imgs, K = frames
    jv, tv = _vis(**OPTIONS)
    jcfg = kitti_hdl64().replace(visual=jv)
    tcfg = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**SC), visual=tv)
    jstate, ref = jvo.init_vo_state(jcfg), []
    cloud, cmask, proj = jnp.zeros((8, 3)), jnp.zeros((8,), bool), jnp.zeros((3, 4))
    for img, bk in imgs:
        jstate, pose = jvo.vo_step(jstate, jnp.array(img), cloud, cmask, proj, jnp.array(K), jcfg,
                                   pre_buckets=JBuckets(*(jnp.array(b) for b in bk)))
        ref.append((np.asarray(pose), np.asarray(jstate.prev_pts_mask),
                    np.asarray(jstate.prev_img)))
    tstate, port = tvo.init_vo_state(tcfg, "cpu"), []
    for img, bk in imgs:
        tstate, pose = tvo.vo_step(tstate, torch.tensor(img), torch.tensor(K), tcfg,
                                   pre_buckets=TBuckets(*(torch.tensor(b) for b in bk)))
        port.append((pose.numpy(), tstate.prev_pts_mask.numpy(), tstate.prev_img.numpy()))
    return ref, port


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_vo_step_with_options_matches_reference(runs, frame):
    ref, port = runs
    (got, gmask, gimg), (want, wmask, wimg) = port[frame], ref[frame]
    np.testing.assert_allclose(gimg, wimg, atol=1e-3, rtol=0)      # the CLAHE'd image rolls
    assert (gmask == wmask).mean() >= 0.98 and wmask.sum() >= 20, (frame, wmask.sum())
    # at most nms_max_total // 52 buckets = 7 keypoints a bucket survive
    assert wmask.sum() <= 7 * 52
    dt = np.abs(got[4:] - want[4:]).max()
    ang = 2.0 * np.arccos(min(1.0, abs(float(np.dot(got[:4], want[:4])))))
    assert np.isfinite(got).all() and dt < T_TOL and ang < R_TOL, (frame, dt, ang, got, want)
    if frame >= 1:
        assert np.abs(want[4:]).max() > 0.1                 # a real solve, not the fallback
