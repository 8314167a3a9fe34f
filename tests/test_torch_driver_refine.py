"""The port's ``close()`` epilogue (``VloamDriver.refine_trajectory`` with
loop closure, its checkpoint keys and the CLI flags) against the JAX
driver's, on the CPU.

One JAX-format ``_driver.npz`` carries the state: ``world_hist`` of a
drifted ring course (the course of tests/test_driver_loop_closure.py, its
three chains integrated in NumPy from the true motion with a yaw bias and
noise) and the ring grids of six keyframes of the ring scene (the port's
``synthetic`` and ``gridding`` copies), placed so that the revisit gate
finds one pair, the loop's closing one.  The JAX driver gets the state by
its attributes, the port's through ``load_host_state``; then
``refine_trajectory()`` on both, each registering from the chain seed alone
(the seven-seed registration costs the JAX side ~120 s on the CPU):

* ``refine_report``: equal ``loop_factors`` and ``fallback``;
* the refined poses within 1e-3 m and 1e-3 rad of each other;
* ``MO1_refined.txt``: the same rows within that bound.

The same without keyframes (refinement alone); a checkpoint round trip
with keyframes, where the resumed run equals the uninterrupted one exactly
(the CPU path has no float atomics); ``--refine --loop-closure`` through the
CLI; and, marked slow as its JAX twin is, the port's
``test_driver_loop_closure_end_to_end``.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from test_driver_loop_closure import CFG as JCFG_E2E
from test_driver_loop_closure import _ring_scene
from test_torch_runtime import FILES, MC_TINY, SC_TINY, configs, make_frames, read, run_cli
from vloam_tpu.models import frame_graph as jfg
from vloam_tpu.parallel import loop_closure as jlc
from vloam_tpu.runtime import driver as jdriver
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch import geometry_np as gnp
from vloam_tpu_torch.data import gridding, synthetic
from vloam_tpu_torch.models import frame_graph as tfg
from vloam_tpu_torch.runtime import driver as tdriver
from vloam_tpu_torch.utils.trajectory import load_kitti_trajectory

N, SPEED = 56, 1.1
YAW_RATE = 2 * np.pi / N
KEYFRAMES = (0, 10, 20, 30, 40, 55)
LOOP_KW = dict(keyframe_every=5, loop_radius=6.0, loop_min_travel=25.0, loop_drift_rate=0.02,
               loop_min_gap=3)
POSE_TOL = 1e-3     # m, and rad (each quaternion component within half of it)

JCFG = JCFG_E2E
TCFG = tconfig.kitti_hdl64().replace(
    scan=tconfig.ScanConfig(ring_cap=512, max_points=32768, less_flat_cap=8192),
    mapping=tconfig.MappingConfig(grid_w=7, grid_h=7, grid_d=3, corner_cube_cap=1024,
                                  surf_cube_cap=2048, corner_stack_cap=2048,
                                  surf_stack_cap=4096),
    verbose_level=0)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _chain(bias, noise, seed):
    """(N, 7) f64 world poses integrated from the course's true motion (yaw
    YAW_RATE, SPEED ahead) with a yaw bias and noise per frame."""
    rng = np.random.default_rng(seed)
    w = gnp.pose_identity()
    out = [w]
    for _ in range(N - 1):
        a = YAW_RATE + bias + noise * rng.normal()
        d = np.concatenate([[0.0, 0.0, np.sin(a / 2), np.cos(a / 2)],
                            [SPEED, 0.0, 0.0] + noise * rng.normal(size=3)])
        w = gnp.pose_compose(w, d)
        out.append(w)
    return np.stack(out)


def write_state(path, keyframes=True):
    """A ``_driver.npz`` in the reference driver's keys."""
    vo, lo, mo = _chain(0.003, 0.004, 1), _chain(0.004, 0.003, 2), _chain(0.002, 0.002, 3)
    b = gnp.as_pose64(tfg.kitti_default_extrinsics("cpu").base_T_cam0.numpy())
    arrs = {
        "w_vo64": vo[-1], "w_lo64": lo[-1], "w_mo64": mo[-1],
        "anchor64": gnp.pose_compose(gnp.pose_compose(gnp.pose_inverse(b), vo[0]), b),
        "divergence": np.zeros(3), "world_hist": np.stack([vo, lo, mo], axis=1),
        "kf_ids": np.array(KEYFRAMES if keyframes else [], np.int64),
    }
    if keyframes:
        poses = synthetic.straight_trajectory(N, speed=SPEED, yaw_rate=YAW_RATE)
        scene = _ring_scene(SPEED / YAW_RATE)
        for fid in KEYFRAMES:
            R, t = poses[fid]
            cloud = synthetic.simulate_scan(R, t, scene, n_azimuth=500, noise=0.01, seed=fid)
            arrs[f"kf_grid_{fid}"], arrs[f"kf_mask_{fid}"], _ = gridding.grid_cloud(cloud,
                                                                                  TCFG.scan)
    np.savez(path, **arrs)
    return path


def refine_both(tmp_path, monkeypatch, keyframes):
    """refine_trajectory() of the JAX driver and of the port's on one state:
    ((refined, report, MO1_refined rows) of each).  Both register from the
    chain seed alone (``use_coarse=False``; the MO chain drifts little
    enough that it registers): the coarse seeds' path is held to the
    reference piece by piece in test_torch_loop_closure.py, and seven seeds
    would cost the JAX side ~120 s on the CPU (ROADMAP C8)."""
    for mod, name in ((jlc, "register_loop"), (tdriver, "register_loop")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), use_coarse=False))
    npz = write_state(str(tmp_path / "state_driver.npz"), keyframes)
    z = np.load(npz)
    jd = jdriver.VloamDriver(JCFG, jfg.kitti_default_extrinsics(), out_dir=str(tmp_path / "j"),
                             loop_closure=True, **LOOP_KW)
    jd._w_vo64, jd._w_lo64, jd._w_mo64 = z["w_vo64"], z["w_lo64"], z["w_mo64"]
    jd._anchor64 = z["anchor64"]
    wh = z["world_hist"]
    jd._world_hist = [(wh[i, 0], wh[i, 1], wh[i, 2]) for i in range(len(wh))]
    jd._keyframes = {int(f): (z[f"kf_grid_{f}"], z[f"kf_mask_{f}"]) for f in z["kf_ids"]}

    td = tdriver.VloamDriver(TCFG, tfg.kitti_default_extrinsics("cpu"),
                             out_dir=str(tmp_path / "t"), loop_closure=True, device="cpu",
                             **LOOP_KW)
    td.load_host_state(npz)
    assert sorted(td._keyframes) == sorted(jd._keyframes) and len(td._world_hist) == N

    out = []
    for d, sub in ((jd, "j"), (td, "t")):
        refined = d.refine_trajectory()
        rows = load_kitti_trajectory(str(tmp_path / sub / "MO1_refined.txt"))
        out.append((np.asarray(refined), dict(d.refine_report), rows))
    return out


def assert_same_refinement(jax_side, port_side, loops):
    (rj, repj, rowsj), (rt, rept, rowst) = jax_side, port_side
    assert rept["loop_factors"] == repj["loop_factors"] == loops, (rept, repj)
    assert rept["fallback"] == repj["fallback"]
    assert rt.shape == rj.shape == (N, 7) and np.isfinite(rt).all()
    np.testing.assert_allclose(rt[:, 4:], rj[:, 4:], atol=POSE_TOL, rtol=0)
    sign = np.sign(np.sum(rt[:, :4] * rj[:, :4], axis=1, keepdims=True))
    np.testing.assert_allclose(rt[:, :4] * sign, rj[:, :4], atol=POSE_TOL / 2, rtol=0)
    assert rowst.shape == rowsj.shape == (N, 3, 4)
    np.testing.assert_allclose(rowst, rowsj, atol=POSE_TOL, rtol=0)
    for key in ("loop_resid_raw_m", "loop_resid_refined_m"):
        if key in repj:
            assert abs(rept[key] - repj[key]) < POSE_TOL, (key, rept[key], repj[key])


def test_refine_with_loop_closure_matches_reference(tmp_path, monkeypatch):
    jax_side, port_side = refine_both(tmp_path, monkeypatch, keyframes=True)
    assert_same_refinement(jax_side, port_side, loops=1)
    report = port_side[1]
    # the loop factor pulls the revisit together
    assert report["loop_resid_refined_m"] < 0.5 * report["loop_resid_raw_m"], report


def test_refine_without_keyframes_matches_reference(tmp_path, monkeypatch):
    jax_side, port_side = refine_both(tmp_path, monkeypatch, keyframes=False)
    assert_same_refinement(jax_side, port_side, loops=0)


def test_checkpoint_round_trip_with_keyframes(tmp_path):
    """A run checkpointed at frame 3 and resumed keeps its keyframes and its
    refinement history: refined trajectory, MO1_refined.txt, world history
    and keyframes equal to the uninterrupted run's."""
    import dataclasses

    tcfg = configs(SC_TINY, MC_TINY)[1]
    tcfg = tcfg.replace(visual=dataclasses.replace(tcfg.visual, img_height=192, img_width=624,
                                                   max_corners=256, max_features=256))
    frames, _ = make_frames(tcfg, 6, 300, yaw_rate=0.004)
    ext = tfg.kitti_default_extrinsics("cpu")
    kw = dict(loop_closure=True, keyframe_every=2, device="cpu")

    da = tdriver.VloamDriver(tcfg, ext, out_dir=str(tmp_path / "a"), **kw)
    for f in frames:
        da.process(*f)
    da.close()

    ck = str(tmp_path / "ck")
    db = tdriver.VloamDriver(tcfg, ext, out_dir=str(tmp_path / "b"), checkpoint_dir=ck,
                             checkpoint_every=3, **kw)
    for f in frames[:4]:
        db.process(*f)
    for w in db.writers.values():
        w.flush()
    del db                                   # no close(): a crash after frame 3
    z = np.load(os.path.join(ck, "ckpt_000003_driver.npz"))
    assert list(z["kf_ids"]) == [0, 2] and z["world_hist"].shape == (3, 3, 7)

    dc = tdriver.VloamDriver(tcfg, ext, out_dir=str(tmp_path / "b"), **kw)
    assert dc.restore_checkpoint(os.path.join(ck, "ckpt_000003")) == 3
    for f in frames[3:]:
        dc.process(*f)
    dc.close()

    assert da.refine_report == dc.refine_report == {"loop_factors": 0, "fallback": False}
    np.testing.assert_array_equal(dc._refined, da._refined)
    assert read(str(tmp_path / "b" / "MO1_refined.txt")) == read(str(tmp_path / "a" / "MO1_refined.txt"))
    for name in FILES:
        assert read(str(tmp_path / "b" / name)) == read(str(tmp_path / "a" / name)), name
    assert len(dc._world_hist) == len(da._world_hist) == 6
    for ha, hc in zip(da._world_hist, dc._world_hist):
        for a, c in zip(ha, hc):
            np.testing.assert_array_equal(a, c)
    assert sorted(dc._keyframes) == sorted(da._keyframes) == [0, 2, 4]
    for fid in da._keyframes:
        for a, c in zip(da._keyframes[fid], dc._keyframes[fid]):
            np.testing.assert_array_equal(a, c)


def test_cli_refine_and_loop_closure(tmp_path):
    res = run_cli("--device", "cpu", "--dataset", "synthetic", "--frames", "4", "--json",
                  "--out", str(tmp_path), "--refine", "--loop-closure", "--keyframe-every", "2",
                  "--loop-radius", "5.0", "--loop-min-travel", "10.0", "--loop-drift-rate",
                  "0.03", "--loop-min-gap", "2")
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    assert out["frames"] == 4 and np.isfinite(out["final_err_refined_m"])
    assert out["final_err_refined_m"] / out["path_len_m"] < 0.1
    for name in FILES + ("MO1_refined.txt",):
        assert load_kitti_trajectory(str(tmp_path / name)).shape == (4, 3, 4)


def test_run_synthetic_refine_reports_refined_error():
    tcfg = configs(SC_TINY, MC_TINY)[1]
    res = tdriver.run_synthetic(tcfg, n_frames=4, n_azimuth=300, verbose=False, lidar_only=True,
                                refine=True, loop_closure=True, keyframe_every=2,
                                loop_kw=dict(loop_min_travel=1.0), device="cpu")
    assert np.isfinite(res["final_err_refined_m"])
    assert abs(res["final_err_refined_m"] - res["final_err_mo_m"]) < 0.05


@pytest.mark.slow
def test_driver_loop_closure_end_to_end():
    """The port's twin of tests/test_driver_loop_closure.py's test: the
    ring course through VloamDriver.process, then refinement with loop
    closure."""
    poses = synthetic.straight_trajectory(N, speed=SPEED, yaw_rate=YAW_RATE)
    scene = _ring_scene(SPEED / YAW_RATE)
    driver = tdriver.VloamDriver(TCFG, tfg.kitti_default_extrinsics("cpu"), loop_closure=True,
                                 device="cpu", **LOOP_KW)
    mo = []
    for i, (R, t) in enumerate(poses):
        cloud = synthetic.simulate_scan(R, t, scene, n_azimuth=500, noise=0.01, seed=i)
        driver.process(None, cloud)
        mo.append(driver.host_out.world_mo)
    mo = np.stack(mo)
    gt = np.stack([t for _, t in poses])
    raw_ate = float(np.mean(np.linalg.norm(mo[:, 4:] - gt, axis=1)))
    refined = driver.refine_trajectory()
    assert refined is not None and refined.shape == (N, 7)
    factors = driver._loop_factors(mo)
    assert factors is not None, "no loop factor registered on a closed ring"
    assert int(factors.valid.sum()) >= 1
    ref_ate = float(np.mean(np.linalg.norm(refined[:, 4:] - gt, axis=1)))
    assert ref_ate < max(1.5 * raw_ate, 0.25), (raw_ate, ref_ate)
    driver.close()
