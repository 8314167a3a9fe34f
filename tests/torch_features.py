"""Shared by the ``tests/test_torch_*`` files of the feature families: the
reference tests' blob texture, the comparison of binary descriptors, and
the six descriptor-mode cases of tests/test_vo_descriptor_modes.py run
through the JAX ``vo_step`` (un-jitted) and the port's on the same inputs.

The scene is that test's: one 192 x 256 blob texture seen three times from
the same pose, a flat wall of lidar points 10 m ahead, 256 feature slots.
The port's VO builds its depth buckets from the cloud, as the reference's
does here.  After the reference's second frame its state crosses into the
port (``vo_state_from_numpy``: uint32 words as int32, SIFT's floats as they
are) and the port runs the third frame from it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from vloam_tpu.config import kitti_hdl64
from vloam_tpu.models import visual_odometry as jvo
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch import geometry as tgeo
from vloam_tpu_torch.models import visual_odometry as tvo

MIN_SAME = 0.99     # share of valid binary descriptors that must be bit-identical
MAX_BITS = 16       # bits (of 512) another may differ in, unless its rotation bin is one off
N_FRAMES = 3
T_TOL, R_TOL = 4e-3, 1e-3                # port vs reference, every frame
IDENT_T_TOL, IDENT_R_TOL = 5e-2, 5e-3    # the static scene's identity contract
CASES = {   # descriptor, matcher, detector (tests/test_vo_descriptor_modes.py:40-47)
    "orb": ("orb", "bf", "shitomasi"),
    "brief": ("brief", "flann", "fast"),
    "brisk": ("brisk", "bf", "brisk"),
    "freak": ("freak", "bf", "brisk"),
    "akaze": ("akaze", "bf", "akaze"),
    "sift": ("sift", "flann", "sift"),
}


def texture(rng, H=192, W=256, blobs=60):
    """The blob texture of the reference's tests (test_vo_descriptor_modes.py:28-35)."""
    img = rng.uniform(0, 1, (H // 8, W // 8))
    img = np.kron(img, np.ones((8, 8)))
    for _ in range(blobs):
        y, x = rng.integers(20, H - 20), rng.integers(20, W - 20)
        img[y - 3: y + 3, x - 3: x + 3] += rng.uniform(0.5, 1.0)
    return (img / img.max() * 255.0).astype(np.float32)


def bits_of(desc: torch.Tensor) -> np.ndarray:
    """int32 descriptor words -> the reference's uint32 view of the bits."""
    assert desc.dtype == torch.int32
    return desc.numpy().view(np.uint32)


def popcount(words: np.ndarray) -> np.ndarray:
    """Set bits a row of uint32 words."""
    return np.unpackbits(words.view(np.uint8), axis=-1).sum(axis=-1)


def assert_binary_close(got, want, valid, off_one):
    """>= MIN_SAME of the valid rows bit-identical; every other row within
    MAX_BITS bits, or its rotation bin one off (``off_one(row)`` says)."""
    same = (got == want).all(axis=1)
    assert same[valid].mean() >= MIN_SAME, same[valid].mean()
    for r in np.where(valid & ~same)[0]:
        assert popcount(got[r] ^ want[r]) <= MAX_BITS or off_one(r), r


def configs(case):
    desc, matcher, det = CASES[case]
    kw = dict(img_height=192, img_width=256, max_features=256, max_corners=256,
              optical_flow_match=False, detector_type=det, descriptor_type=desc,
              matcher_type=matcher)
    j, t = kitti_hdl64(), tconfig.kitti_hdl64()
    return (dataclasses.replace(j, visual=dataclasses.replace(j.visual, **kw)),
            dataclasses.replace(t, visual=dataclasses.replace(t.visual, **kw)))


def run(case, rng):
    """Both ``vo_step``s over the static scene.  Returns (reference poses,
    port poses, port pose of frame 3 from the reference's state, the
    reference's state after frame 2)."""
    jcfg, tcfg = configs(case)
    vc = tcfg.visual
    K = np.array([[200.0, 0, vc.img_width / 2], [0, 200.0, vc.img_height / 2], [0, 0, 1]],
                 np.float32)
    proj = np.zeros((3, 4), np.float32)
    proj[:, :3] = K
    img = texture(rng, vc.img_height, vc.img_width)
    uv = np.stack(np.meshgrid(np.arange(8, vc.img_width - 8, 4),
                              np.arange(8, vc.img_height - 8, 4)), -1).reshape(-1, 2)
    cloud = (np.concatenate([uv, np.ones((len(uv), 1))], 1) @ np.linalg.inv(K).T * 10.0
             ).astype(np.float32)
    cmask = np.ones((len(cloud),), bool)

    jstate, ref, carried = jvo.init_vo_state(jcfg), [], None
    for i in range(N_FRAMES):
        if i == N_FRAMES - 1:
            carried = jvo.VoState(*(np.asarray(x) if not isinstance(x, tuple)
                                    else type(x)(*(np.asarray(b) for b in x)) for x in jstate))
        jstate, pose = jvo.vo_step(jstate, jnp.array(img), jnp.array(cloud), jnp.array(cmask),
                                   jnp.array(proj), jnp.array(K), jcfg)
        ref.append(np.asarray(pose))
    t = torch.tensor
    step = lambda s: tvo.vo_step(s, t(img), t(K), tcfg, cloud=t(cloud), cloud_mask=t(cmask),  # noqa: E731
                                 proj=t(proj))
    tstate, port = tvo.init_vo_state(tcfg, "cpu"), []
    for _ in range(N_FRAMES):
        tstate, pose = step(tstate)
        port.append(pose.numpy())
    from_ref = step(tvo.vo_state_from_numpy(carried, "cpu"))[1].numpy()
    return ref, port, from_ref, carried


def pose_gap(got, want):
    """(max translation difference, rotation angle between the two)."""
    dt = float(np.abs(got[4:] - want[4:]).max())
    return dt, 2.0 * float(np.arccos(min(1.0, abs(float(np.dot(got[:4], want[:4]))))))


def check(case, rng):
    """The six-case contract: every frame within T_TOL / R_TOL of the
    reference, the carried state's frame too, and the identity contract on
    the last frame (tests/test_vo_descriptor_modes.py:67-72)."""
    ref, port, from_ref, carried = run(case, rng)
    desc = CASES[case][0]
    width, dtype = (128, np.float32) if desc == "sift" else ((8, np.uint32) if desc in
                                                            ("orb", "brief") else (16, np.uint32))
    assert carried.prev_desc.shape == (256, width) and carried.prev_desc.dtype == dtype
    for i, (got, want) in enumerate(zip(port + [from_ref], ref + [ref[-1]])):
        dt, ang = pose_gap(got, want)
        assert np.isfinite(got).all() and dt < T_TOL and ang < R_TOL, (case, i, dt, ang, got, want)
    pose = port[-1]
    np.testing.assert_allclose(pose[4:], 0.0, atol=IDENT_T_TOL)
    R = tgeo.quat_to_matrix(torch.tensor(pose[:4])).numpy()
    np.testing.assert_allclose(R, np.eye(3), atol=IDENT_R_TOL)
