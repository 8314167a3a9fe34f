"""Where the port's and the JAX package's long drives part (ROADMAP C-i).
Run on the CPU from the repo root:

    env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_drive_gap.py [--frames 200] [--couple]

It drives the validation drive's snake course (``tools/validate_drive``:
speed 0.9 m a frame, yaw amplitude 0.004) at the small scan and map sizes
of ``tests/test_torch_scenarios.py`` (n_azimuth 500, ring cap 512, a 7 x 7 x
3 cube grid; images and features at full size) through the JAX package's
jitted ``vloam_step`` and the port's ``vloam_step``, both on the CPU and
over the same host frames (the port's stream, equal to
``bench._gen_frames``), each package in a worker process of its own.  It
prints the MO position difference every 10 frames and the first frame where
it passes 1 mm, then one JSON line with each chain's KITTI-protocol error
(100-800 m segments), ATE and final error.  No tier-1 test: a measurement.
"""

import argparse
import dataclasses
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_scenarios import MC, SC  # noqa: E402
from vloam_tpu.config import MappingConfig, ScanConfig, kitti_hdl64  # noqa: E402
from vloam_tpu.models import frame_graph as jfg  # noqa: E402
from vloam_tpu.models.vloam import init_vloam_state as jinit, vloam_step as jstep  # noqa: E402
from vloam_tpu.ops.depth_map import DepthBuckets  # noqa: E402
from vloam_tpu_torch import config as tconfig, geometry_np as gnp  # noqa: E402
from vloam_tpu_torch.data import stream  # noqa: E402
from vloam_tpu_torch.models import frame_graph as tfg  # noqa: E402
from vloam_tpu_torch.models.vloam import frame_to_device, init_vloam_state, vloam_step  # noqa: E402
from vloam_tpu_torch.utils import kitti_eval  # noqa: E402


def score(mo, poses):
    est = np.stack([gnp.pose_to_matrix(p.astype(np.float64))[:3] for p in mo])
    gt = np.stack([np.concatenate([R, t[:, None]], axis=1) for R, t in poses])
    res = kitti_eval.evaluate(gt, est)
    return dict(mo_trans_pct=res["trans_pct"], mo_rot_deg_per_m=res["rot_deg_per_m"],
                segments=res["segments"], ate_m=kitti_eval.ate(gt, est),
                final_err_m=float(np.linalg.norm(est[-1, :3, 3] - gt[-1, :3, 3])))


def configs(couple: bool):
    kw = dict(detach_vo_lo=not couple, verbose_level=0)
    jcfg = kitti_hdl64().replace(scan=ScanConfig(**SC), mapping=MappingConfig(**MC), **kw)
    tcfg = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**SC),
                                         mapping=tconfig.MappingConfig(**MC), **kw)
    assert dataclasses.asdict(jcfg.mapping) == dataclasses.asdict(tcfg.mapping)
    return jcfg, tcfg


def frames_of(tcfg, n):
    return stream.gen_frames(tcfg, tfg.kitti_default_extrinsics("cpu"), n, speed=0.9,
                             yaw_rate=0.004, n_azimuth=500, snake=True)


def chain(side: str, n: int, couple: bool):
    """One package's MO world chain (n, 7) over the course, and its seconds
    (frame generation excluded).  Runs in a worker process of its own."""
    torch.set_num_threads(3)
    jcfg, tcfg = configs(couple)
    frames, _ = frames_of(tcfg, n)
    mo = []
    t0 = time.perf_counter()
    if side == "jax":
        ext = jfg.kitti_default_extrinsics()
        step = jax.jit(lambda s, i, c, m, b, t: jstep(s, i, c, m, ext, jcfg, pre_gridded=True,
                                                       pre_buckets=b, pre_lf_table=t))
        state = jinit(jcfg)
        for img, grid, gmask, bk, (sg, bs, nr) in frames:
            state, out = step(state, jnp.array(img), jnp.array(grid), jnp.array(gmask),
                              DepthBuckets(*(jnp.array(b) for b in bk)),
                              (jnp.array(sg), jnp.array(bs), jnp.int32(nr)))
            mo.append(np.asarray(out.world_mo))
    else:
        ext = tfg.kitti_default_extrinsics("cpu")
        state = init_vloam_state(tcfg, "cpu")
        for f in frames:
            img, grid, gmask, bk, lf = frame_to_device(*f, "cpu")
            state, out = vloam_step(state, img, grid, gmask, ext, tcfg, pre_gridded=True,
                                    pre_buckets=bk, pre_lf_table=lf)
            mo.append(out.world_mo.numpy())
    return np.stack(mo), time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--couple", action="store_true")
    args = ap.parse_args()
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        runs = {side: pool.submit(chain, side, args.frames, args.couple)
                for side in ("jax", "port")}
        (jmo, jsec), (tmo, tsec) = runs["jax"].result(), runs["port"].result()
    _, poses = frames_of(configs(args.couple)[1], args.frames)
    gaps = np.abs(jmo[:, 4:] - tmo[:, 4:]).max(axis=1)
    first = int(np.argmax(gaps > 1e-3)) if (gaps > 1e-3).any() else None
    for k in range(9, args.frames, 10):
        print(f"frame {k}: MO position gap {gaps[k]:.3e} m "
              f"(largest so far {gaps[:k + 1].max():.3e})")
    print(f"first frame with a gap above 1 mm: {first}; JAX {jsec:.0f} s, port {tsec:.0f} s")
    result = dict(frames=args.frames, mode="coupled_C" if args.couple else "decoupled_D",
                  jax_cpu=score(jmo, poses), port_cpu=score(tmo, poses),
                  gap_m=[round(float(g), 6) for g in gaps],
                  rot_gap=float(np.abs(jmo[:, :4] - tmo[:, :4]).max()))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
