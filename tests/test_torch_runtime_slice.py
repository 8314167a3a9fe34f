"""The port's runtime slice as a whole: ``VloamDriver.process`` over 5 small
synthetic frames (raw clouds and full-size images in, trajectory files out)
against the JAX ``VloamDriver`` at the small sizes of
tests/test_torch_vloam.py.

The JAX side runs op by op (``jax.disable_jit``): the compiled reference
moves its own MO pose by millimetres (ROADMAP C).  One such run, with a
checkpoint at frame 3, is shared by every test here.

Bounds: per frame the VO, LO and MO world poses within 4 mm and 1e-3 rad;
the exported rows within 5 mm.  A ``_driver.npz`` written by the JAX driver
restores into the port's driver exactly, and the port then continues the
JAX run within the same bounds.
"""

import os

import jax
import numpy as np
import pytest

from test_torch_runtime import FILES, MC, SC, configs, few_threads, make_frames  # noqa: F401
from vloam_tpu.models import frame_graph as jfg
from vloam_tpu.runtime import driver as jdriver
from vloam_tpu_torch.models import frame_graph as tfg
from vloam_tpu_torch.models.vloam import vloam_state_from_numpy
from vloam_tpu_torch.runtime import driver as tdriver
from vloam_tpu_torch.utils import trajectory as ttraj

N_FRAMES, N_AZIMUTH = 5, 500
T_TOL, R_TOL, ROW_TOL = 4e-3, 1e-3, 5e-3
WORLD_KEYS = ("world_vo", "world_lo", "world_mo")


def rot_angle(qa, qb):
    return 2.0 * np.arccos(np.clip(abs(float(np.dot(qa, qb))), 0.0, 1.0))


@pytest.fixture(scope="module")
def frames():
    return make_frames(configs(SC, MC)[1], N_FRAMES, N_AZIMUTH)[0]


@pytest.fixture(scope="module")
def jax_run(frames, tmp_path_factory):
    """One op-by-op run of the JAX driver, with a checkpoint at frame 3."""
    root = tmp_path_factory.mktemp("jax_run")
    jcfg = configs(SC, MC)[0]
    drv = jdriver.VloamDriver(jcfg, jfg.kitti_default_extrinsics(), out_dir=str(root / "out"),
                              checkpoint_dir=str(root / "ck"), checkpoint_every=3)
    outs, chains, state3 = [], [], None
    with jax.disable_jit():
        for img, cloud in frames:
            out = drv.process(img, cloud)
            outs.append({k: np.asarray(v) for k, v in out._asdict().items()})
            chains.append({k: getattr(drv, k).copy() for k in ("_w_vo64", "_w_lo64", "_w_mo64")})
            if drv.count == 3:
                state3 = jax.tree.map(np.asarray, drv.state)
    drv.close()
    return dict(outs=outs, chains=chains, state3=state3, out_dir=str(root / "out"),
                npz=str(root / "ck" / "ckpt_000003_driver.npz"),
                anchor=drv._anchor64.copy(), divergence=dict(drv.f32_divergence_m))


@pytest.fixture(scope="module")
def port_run(frames, tmp_path_factory):
    root = tmp_path_factory.mktemp("port_run")
    tcfg = configs(SC, MC)[1]
    drv = tdriver.VloamDriver(tcfg, tfg.kitti_default_extrinsics("cpu"), out_dir=str(root),
                              device="cpu")
    outs = []
    for img, cloud in frames:
        out = drv.process(img, cloud)
        outs.append({k: v.numpy() for k, v in out._asdict().items()})
        for k in tdriver.HOST_POSE_FIELDS + ("lo_corr",):   # what the host read is what the step gave
            np.testing.assert_array_equal(getattr(drv.host_out, k), outs[-1][k])
    drv.close()
    return dict(outs=outs, out_dir=str(root), driver=drv)


def _assert_poses_close(got, want, what):
    for key in WORLD_KEYS:
        dt = np.abs(got[key][4:] - want[key][4:]).max()
        ang = rot_angle(got[key][:4], want[key][:4])
        assert dt < T_TOL and ang < R_TOL, f"{what} {key}: {dt} m, {ang} rad"


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_driver_matches_jax_driver(frame, jax_run, port_run):
    _assert_poses_close(port_run["outs"][frame], jax_run["outs"][frame], f"frame {frame}")
    np.testing.assert_array_equal(port_run["outs"][frame]["lo_corr"] > 10,
                                  jax_run["outs"][frame]["lo_corr"] > 10)


@pytest.mark.parametrize("name", FILES)
def test_exported_rows_match_jax_driver(name, jax_run, port_run):
    got = ttraj.load_kitti_trajectory(os.path.join(port_run["out_dir"], name))
    want = ttraj.load_kitti_trajectory(os.path.join(jax_run["out_dir"], name))
    assert got.shape == want.shape == (N_FRAMES, 3, 4)
    assert np.abs(got - want).max() < ROW_TOL
    # the f64 host chain stays within f32 rounding of the step's own f32 chain
    assert max(port_run["driver"].f32_divergence_m.values()) < 1e-4
    counts = port_run["driver"].timer.count
    assert counts["vloam_step"] == N_FRAMES
    for layer in ("visual_odometry", "scan_registration", "laser_odometry", "laser_mapping"):
        assert counts[layer] == N_FRAMES, layer   # each layer's span once a frame


def test_restore_from_jax_driver_checkpoint(frames, jax_run, tmp_path):
    """The JAX driver's host state (``_driver.npz``) and device state at
    frame 3 start the port's driver; frames 3-4 then agree with the JAX
    run's, and the exported rows continue its files."""
    tcfg = configs(SC, MC)[1]
    drv = tdriver.VloamDriver(tcfg, tfg.kitti_default_extrinsics("cpu"), out_dir=str(tmp_path),
                              device="cpu")
    drv.state = vloam_state_from_numpy(jax_run["state3"], "cpu")
    drv.count = 3
    drv.load_host_state(jax_run["npz"])
    for k, v in jax_run["chains"][2].items():
        np.testing.assert_array_equal(getattr(drv, k), v)
    np.testing.assert_array_equal(drv._anchor64, jax_run["anchor"])
    for i in (3, 4):
        out = drv.process(*frames[i])
        _assert_poses_close({k: v.numpy() for k, v in out._asdict().items()},
                            jax_run["outs"][i], f"resumed frame {i}")
    drv.close()
    for name in FILES:
        got = ttraj.load_kitti_trajectory(os.path.join(str(tmp_path), name))
        want = ttraj.load_kitti_trajectory(os.path.join(jax_run["out_dir"], name))[3:]
        assert got.shape == (2, 3, 4) and np.abs(got - want).max() < ROW_TOL
