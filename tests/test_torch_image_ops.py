"""The port's KLT frontend, depth query and frame graph against the JAX
reference on its CPU path, on the blob image pair of tests/test_image_ops.py
(full 376 x 1248 images, a pure shift of (3.4, -2.2) px).

Bounds, with their reasons:
  * Shi-Tomasi response rtol 1e-5, atol 1e-2 (grey levels up to 255,
    squared gradients summed: ~1e4 magnitudes in f32);
  * detected corners: >= 99 % of the slots where both masks are set hold
    the same pixel (the top-k order breaks ties by index in both, but the
    response can differ in its last bit);
  * pyramid allclose 1e-4; window sampling 1e-3 (bf16-rounded inputs, f32
    sums in another order);
  * KLT: ok decisions agree on >= 99 % of features, flows within 0.01 px
    and the mean photometric error within 0.05 grey levels where both
    accept;
  * depth query: identical valid decisions, depths within 1e-4 m;
  * frame graph and matrix_to_quat: atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu import geometry as jgeo
from vloam_tpu.config import VisualConfig
from vloam_tpu.data import gridding as jgrid
from vloam_tpu.data import synthetic as jsyn
from vloam_tpu.models import frame_graph as jfg
from vloam_tpu.ops import depth_map as jdm
from vloam_tpu.ops import image_ops as jio
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch import geometry as tgeo
from vloam_tpu_torch.data import gridding as tgrid
from vloam_tpu_torch.data import synthetic as tsyn
from vloam_tpu_torch.models import frame_graph as tfg
from vloam_tpu_torch.models.visual_odometry import inv3
from vloam_tpu_torch.ops import depth_map as tdm
from vloam_tpu_torch.ops import image_ops as tio

VC = VisualConfig(img_height=376, img_width=1248)
TVC = tconfig.VisualConfig(img_height=376, img_width=1248)
SHIFT = np.array([3.4, -2.2])


@pytest.fixture(scope="module")
def blob_pair():
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(30, VC.img_width - 30, 400),
                    rng.uniform(30, VC.img_height - 30, 400), np.ones(400)], axis=-1)
    img0 = jsyn.render_blob_image(pts, np.eye(3), VC.img_height, VC.img_width)
    pts1 = pts.copy()
    pts1[:, :2] += SHIFT
    img1 = jsyn.render_blob_image(pts1, np.eye(3), VC.img_height, VC.img_width)
    return img0, img1


@pytest.fixture(scope="module")
def corners(blob_pair):
    kp, mask, _ = jio.detect_corners(jnp.array(blob_pair[0]), VC)
    return np.asarray(kp), np.asarray(mask)


def test_camera_synthetic_copies_equal_reference():
    K = jsyn.kitti_like_intrinsics()
    np.testing.assert_array_equal(tsyn.kitti_like_intrinsics(), K)
    np.testing.assert_array_equal(tsyn.CAM_R_WORLD, jsyn.CAM_R_WORLD)
    rng = np.random.default_rng(3)
    uv = np.stack([rng.uniform(0, 1248, 300), rng.uniform(0, 376, 300)], -1)
    R_wc = jsyn.CAM_R_WORLD.T
    for a, b in zip(tsyn.raycast_camera(R_wc, np.zeros(3), jsyn.default_scene(), K, uv),
                    jsyn.raycast_camera(R_wc, np.zeros(3), jsyn.default_scene(), K, uv)):
        np.testing.assert_array_equal(a, b)
    pc = np.stack([rng.uniform(-5, 5, 200), rng.uniform(-2, 2, 200), rng.uniform(1, 40, 200)], -1)
    np.testing.assert_array_equal(tsyn.render_blob_image(pc, K.astype(np.float64), 376, 1248),
                                  jsyn.render_blob_image(pc, K.astype(np.float64), 376, 1248))


def test_shi_tomasi_response(blob_pair):
    img = blob_pair[0]
    want = np.asarray(jio.shi_tomasi_response(jnp.array(img), VC.block_size))
    got = tio.shi_tomasi_response(torch.tensor(img), TVC.block_size).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)


def test_approx_max_k_is_exact_on_the_cpu_reference(blob_pair):
    """The JAX CPU path's approx_max_k (image_ops.py:159) is lax.top_k."""
    score = jio.shi_tomasi_response(jnp.array(blob_pair[0]), VC.block_size).reshape(1, -1)
    a_val, a_idx = jax.lax.approx_max_k(score, VC.max_corners, recall_target=0.95)
    t_val, t_idx = jax.lax.top_k(score, VC.max_corners)
    np.testing.assert_array_equal(np.asarray(a_val), np.asarray(t_val))
    np.testing.assert_array_equal(np.asarray(a_idx), np.asarray(t_idx))


def test_detect_corners(blob_pair, corners):
    kp, mask = corners
    tkp, tmask, _ = tio.detect_corners(torch.tensor(blob_pair[0]), TVC)
    tkp, tmask = tkp.numpy(), tmask.numpy()
    assert mask.sum() > 200 and abs(int(tmask.sum()) - int(mask.sum())) <= 0.01 * mask.sum()
    both = mask & tmask
    same = np.all(tkp[both] == kp[both], axis=-1)
    assert same.mean() >= 0.99, same.mean()


def test_gaussian_pyramid(blob_pair):
    want = jio.gaussian_pyramid(jnp.array(blob_pair[0]), 2)
    got = tio.gaussian_pyramid(torch.tensor(blob_pair[0]), 2)
    assert [tuple(g.shape) for g in got] == [(376, 1248), (188, 624), (94, 312)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def test_sample_windows(rng):
    n, w, P = 256, 15, 32
    patch = rng.uniform(0, 255, (n, P, P)).astype(np.float32)
    xs = (rng.uniform(0, 16, (n, 1)) + np.arange(w)).astype(np.float32)
    ys = (rng.uniform(0, 16, (n, 1)) + np.arange(w)).astype(np.float32)
    want = jio._sample_windows(jnp.array(patch), jio._tent_weights(jnp.array(ys), P),
                               jio._tent_weights(jnp.array(xs), P))
    wy, wx = tio._tent_weights(torch.tensor(ys), P), tio._tent_weights(torch.tensor(xs), P)
    np.testing.assert_array_equal(wy.numpy(), np.asarray(jio._tent_weights(jnp.array(ys), P)))
    got = tio._sample_windows(torch.tensor(patch), wy, wx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)


@pytest.mark.parametrize("mode", ["no_prior", "prior_skip_coarse", "prior_with_coarse"])
def test_lk_track_fb(blob_pair, corners, mode):
    img0, img1 = blob_pair
    kp, mask = corners
    init = skip = None
    if mode != "no_prior":
        init = (SHIFT + np.random.default_rng(1).normal(0, 0.5, kp.shape)).astype(np.float32)
        skip = mode == "prior_skip_coarse"
    jpts, jok = jio.lk_track_fb(jnp.array(img0), jnp.array(img1), jnp.array(kp), jnp.array(mask),
                                VC, None if init is None else jnp.array(init),
                                skip_coarse=None if skip is None else jnp.array(skip))
    tpts, tok = tio.lk_track_fb(torch.tensor(img0), torch.tensor(img1), torch.tensor(kp),
                                torch.tensor(mask), TVC,
                                None if init is None else torch.tensor(init), skip_coarse=skip)
    jpts, jok, tpts, tok = np.asarray(jpts), np.asarray(jok), tpts.numpy(), tok.numpy()
    assert jok.sum() > 150
    assert (jok == tok).mean() >= 0.99, (jok == tok).mean()
    both = jok & tok
    np.testing.assert_allclose(tpts[both], jpts[both], rtol=0, atol=0.01)
    np.testing.assert_allclose(np.median(tpts[both] - kp[both], axis=0), SHIFT, atol=0.05)


def test_lk_track(blob_pair, corners):
    """The single-pass tracker (klt_fb_check=False) with its photometric error."""
    img0, img1 = blob_pair
    kp, mask = corners
    jpts, jok, jerr = jio.lk_track(jnp.array(img0), jnp.array(img1), jnp.array(kp),
                                   jnp.array(mask), VC, return_err=True)
    tpts, tok, terr = tio.lk_track(torch.tensor(img0), torch.tensor(img1), torch.tensor(kp),
                                   torch.tensor(mask), TVC, return_err=True)
    jpts, jok, tpts, tok = np.asarray(jpts), np.asarray(jok), tpts.numpy(), tok.numpy()
    assert jok.sum() > 150 and (jok == tok).mean() >= 0.99
    both = jok & tok
    np.testing.assert_allclose(tpts[both], jpts[both], rtol=0, atol=0.01)
    np.testing.assert_allclose(terr.numpy()[both], np.asarray(jerr)[both], rtol=0, atol=0.05)


@pytest.fixture(scope="module")
def buckets():
    cfg_scan = tconfig.ScanConfig()
    ext = jfg.kitti_default_extrinsics()
    proj = np.asarray(ext.P_rect0 @ ext.R_rect0 @ ext.cam_T_velo)
    cloud = jsyn.simulate_scan(np.eye(3), np.zeros(3), jsyn.default_scene(), n_azimuth=1800,
                               noise=0.005, seed=2)
    grid, gmask, _ = tgrid.grid_cloud(cloud, cfg_scan)
    pts, m = grid.reshape(-1, 4), gmask.reshape(-1)
    got = tgrid.depth_buckets(pts, m, proj, TVC)
    want = jgrid.depth_buckets(pts, m, proj, VC)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return got


def test_query_depth(buckets, rng):
    # float pixels and integer ones (bucket edges at multiples of 5)
    q = np.concatenate([
        np.stack([rng.uniform(0, 1248, 600), rng.uniform(0, 376, 600)], -1),
        np.stack([rng.integers(0, 250, 424) * 5.0, rng.integers(0, 76, 424) * 5.0], -1),
    ]).astype(np.float32)
    want = np.asarray(jdm.query_depth(jdm.DepthBuckets(*(jnp.array(b) for b in buckets)),
                                      jnp.array(q), VC))
    got = tdm.query_depth(tdm.DepthBuckets(*(torch.tensor(b) for b in buckets)),
                          torch.tensor(q), TVC).numpy()
    assert (want > 0).sum() > 100
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got[want > 0], want[want > 0], rtol=0, atol=1e-4)


def _rand_poses(rng, n):
    aa = rng.normal(0, 0.7, (n, 3)).astype(np.float32)
    q = np.asarray(jgeo.angle_axis_to_quat(jnp.array(aa)))
    return np.concatenate([q, rng.normal(0, 0.5, (n, 3)).astype(np.float32)], -1)


def test_matrix_to_quat(rng):
    q = _rand_poses(rng, 60)[:, :4]
    mats = np.concatenate([np.asarray(jgeo.quat_to_matrix(jnp.array(q))),
                           np.diag([1.0, -1, -1])[None], np.diag([-1.0, 1, -1])[None],
                           np.diag([-1.0, -1, 1])[None], np.eye(3)[None]]).astype(np.float32)
    np.testing.assert_allclose(tgeo.matrix_to_quat(torch.tensor(mats)).numpy(),
                               np.asarray(jgeo.matrix_to_quat(jnp.array(mats))), rtol=0, atol=1e-6)


def test_frame_graph(rng):
    jext, text = jfg.kitti_default_extrinsics(), tfg.kitti_default_extrinsics("cpu")
    for a, b in zip(text, jext):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    a, b = _rand_poses(rng, 1)[0], _rand_poses(rng, 1)[0]
    cases = [
        ("vo_to_velo", (a,)), ("lo_delta_to_cam0", (a,)), ("cam0_init_pose", (a,)),
        ("world_to_cam0_start", (a, b)), ("accumulate_world", (a, b)),
        ("accumulate_world", (a, np.full(7, np.nan, np.float32))),
    ]
    for name, args in cases:
        want = getattr(jfg, name)(*(jnp.array(x) for x in args), jext) if name != "accumulate_world" \
            else jfg.accumulate_world(*(jnp.array(x) for x in args))
        got = getattr(tfg, name)(*(torch.tensor(x) for x in args), text) if name != "accumulate_world" \
            else tfg.accumulate_world(*(torch.tensor(x) for x in args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6, err_msg=name)


def test_inverse_of_the_intrinsics():
    K = tfg.kitti_default_extrinsics("cpu").P_rect0[:, :3]
    np.testing.assert_allclose(inv3(K).numpy(), np.linalg.inv(K.numpy().astype(np.float64)),
                               rtol=1e-6, atol=1e-9)
