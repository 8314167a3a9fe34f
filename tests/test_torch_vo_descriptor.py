"""The port's descriptor-match mode of VO (``optical_flow_match=False``,
ORB and BRIEF, brute-force Hamming matching) against the JAX ``vo_step``,
and the mode through the runtime entry point.

Three frames of the synthetic course (full 376 x 1248 blob images and their
lidar depth buckets, 256 feature slots) go through both ``vo_step``s from a
fresh state, and the reference's state after two frames is carried into the
port for the third.  The JAX side runs un-jitted.

Bounds: the f2f pose within 4 mm in translation and 1e-3 rad in rotation
of the reference's, as the other VO tests hold it; the sets of valid matches
agree on >= 98 % of the slots (a corner whose response differs in its last
bit can change slots).  ``run_synthetic`` on the CPU at the small scan and
map sizes writes three finite trajectories of the right length.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.config import kitti_hdl64
from vloam_tpu.models import visual_odometry as jvo
from vloam_tpu.ops import orb as jorb
from vloam_tpu.ops.depth_map import DepthBuckets as JBuckets
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch.data import stream
from vloam_tpu_torch.models import frame_graph as tfg
from vloam_tpu_torch.models import visual_odometry as tvo
from vloam_tpu_torch.ops import orb as torb
from vloam_tpu_torch.ops.depth_map import DepthBuckets as TBuckets
from vloam_tpu_torch.runtime import driver as tdriver
from vloam_tpu_torch.utils import trajectory as ttraj

N_FRAMES = 3
N_FEATURES = 256
SC = dict(ring_cap=512, max_points=32768, less_flat_cap=8192)
T_TOL, R_TOL = 4e-3, 1e-3
MODES = ("orb", "brief")


def configs(descriptor):
    kw = dict(optical_flow_match=False, descriptor_type=descriptor, max_features=N_FEATURES,
              max_corners=N_FEATURES)
    j = kitti_hdl64()
    j = j.replace(visual=dataclasses.replace(j.visual, **kw))
    t = tconfig.kitti_hdl64()
    t = t.replace(scan=tconfig.ScanConfig(**SC), visual=dataclasses.replace(t.visual, **kw))
    return j, t


@pytest.fixture(scope="module")
def frames():
    _, tcfg = configs("orb")
    ext = tfg.kitti_default_extrinsics("cpu")
    fr, _ = stream.gen_frames(tcfg, ext, N_FRAMES, n_azimuth=600)
    K, _ = stream.camera_matrices(ext)
    return [(f[0], f[3]) for f in fr], K.astype(np.float32)


@pytest.fixture(scope="module", params=MODES)
def runs(request, frames):
    imgs, K = frames
    jcfg, tcfg = configs(request.param)
    jstate, ref = jvo.init_vo_state(jcfg), []
    cloud, cmask, proj = jnp.zeros((8, 3)), jnp.zeros((8,), bool), jnp.zeros((3, 4))
    for img, bk in imgs:
        prev = jstate
        jstate, pose = jvo.vo_step(jstate, jnp.array(img), cloud, cmask, proj, jnp.array(K), jcfg,
                                   pre_buckets=JBuckets(*(jnp.array(b) for b in bk)))
        _, valid = jorb.match_descriptors(prev.prev_desc, prev.prev_desc_mask, jstate.prev_desc,
                                          jstate.prev_desc_mask)
        ref.append(dict(pose=np.asarray(pose), valid=np.asarray(valid),
                        state=jvo.VoState(*(np.asarray(x) if not isinstance(x, tuple)
                                            else JBuckets(*(np.asarray(b) for b in x))
                                            for x in jstate))))
    tstate, port = tvo.init_vo_state(tcfg, "cpu"), []
    for img, bk in imgs:
        prev = tstate
        tstate, pose = tvo.vo_step(tstate, torch.tensor(img), torch.tensor(K), tcfg,
                                   pre_buckets=TBuckets(*(torch.tensor(b) for b in bk)))
        _, valid = torb.match_descriptors(prev.prev_desc, prev.prev_desc_mask, tstate.prev_desc,
                                          tstate.prev_desc_mask)
        port.append(dict(pose=pose.numpy(), valid=valid.numpy(), state=tstate))
    return request.param, ref, port


def assert_pose_close(got, want, what):
    dt = np.abs(got[4:] - want[4:]).max()
    ang = 2.0 * np.arccos(min(1.0, abs(float(np.dot(got[:4], want[:4])))))
    assert np.isfinite(got).all() and dt < T_TOL and ang < R_TOL, (what, dt, ang, got, want)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_frame_pose_matches_reference(runs, frame):
    mode, ref, port = runs
    assert_pose_close(port[frame]["pose"], ref[frame]["pose"], f"{mode} frame {frame}")
    agree = (port[frame]["valid"] == ref[frame]["valid"]).mean()
    assert agree >= 0.98, (mode, frame, agree)
    if frame >= 1:
        # a real solve, not the fewer-than-10-matches fallback
        assert ref[frame]["valid"].sum() >= 10 and port[frame]["valid"].sum() >= 10
        assert np.abs(port[frame]["pose"][4:]).max() > 0.1


def test_descriptor_state_rolls(runs):
    mode, ref, port = runs
    for frame in range(N_FRAMES):
        st = port[frame]["state"]
        assert st.prev_desc.dtype == torch.int32 and st.count == frame + 1
        assert tuple(st.prev_desc.shape) == (N_FEATURES, 8)
        np.testing.assert_array_equal(st.prev_desc_mask.numpy(), ref[frame]["state"].prev_desc_mask)
        same = (st.prev_desc.numpy().view(np.uint32) == ref[frame]["state"].prev_desc).all(axis=1)
        assert same.mean() >= 0.98, (mode, frame, same.mean())


def test_state_carried_across_from_reference(runs, frames):
    """Two reference frames, the reference's state (uint32 descriptors) moves
    into the port, and the third frame runs there."""
    mode, ref, _ = runs
    imgs, K = frames
    _, tcfg = configs(mode)
    state = tvo.vo_state_from_numpy(ref[1]["state"], "cpu")
    assert state.count == 2 and state.prev_desc.dtype == torch.int32
    np.testing.assert_array_equal(state.prev_desc.numpy().view(np.uint32), ref[1]["state"].prev_desc)
    img, bk = imgs[2]
    _, pose = tvo.vo_step(state, torch.tensor(img), torch.tensor(K), tcfg,
                          pre_buckets=TBuckets(*(torch.tensor(b) for b in bk)))
    assert_pose_close(pose.numpy(), ref[2]["pose"], f"{mode} carried")


def test_other_families_still_raise():
    """Every family of the reference runs (tests/test_torch_image_util.py and
    the family files); a name it does not know raises ValueError, as there."""
    _, tcfg = configs("orb")
    for kw, what in ((dict(detector_type="harris"), "detector_type"),
                     (dict(descriptor_type="surf"), "descriptor_type"),
                     (dict(matcher_type="lsh"), "matcher_type")):
        cfg = tcfg.replace(visual=dataclasses.replace(tcfg.visual, **kw))
        with pytest.raises(ValueError, match=what):
            state = tvo.init_vo_state(configs("orb")[1] if "descriptor_type" in kw else cfg, "cpu")
            tvo.vo_step(state, torch.zeros((376, 1248)), torch.eye(3), cfg,
                        pre_buckets=TBuckets(*(torch.zeros((2, 2)) for _ in range(4))))


@pytest.mark.parametrize("descriptor", MODES)
def test_run_synthetic_descriptor_mode(descriptor, tmp_path):
    _, tcfg = configs(descriptor)
    tcfg = tcfg.replace(
        scan=tconfig.ScanConfig(ring_cap=128, max_points=4096, less_flat_cap=4096),
        mapping=tconfig.MappingConfig(grid_w=5, grid_h=5, grid_d=3, corner_cube_cap=128,
                                      surf_cube_cap=256, corner_stack_cap=256,
                                      surf_stack_cap=512))
    res = tdriver.run_synthetic(tcfg, n_frames=3, n_azimuth=120, out_dir=str(tmp_path),
                                verbose=False, device="cpu")
    assert res["frames"] == 3 and np.isfinite(res["final_err_vo_m"])
    for name in ("VO1.txt", "LO1.txt", "MO1.txt"):
        traj = ttraj.load_kitti_trajectory(str(tmp_path / name))
        assert traj.shape == (3, 3, 4) and np.isfinite(traj).all()
