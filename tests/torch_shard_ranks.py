"""Rank processes for the sharded tests of the port: each job runs on every
rank of a gloo map mesh on the CPU, spawned by ``run_job``.

A job is ``fn(mesh, payload) -> result``; ``run_job`` writes the payload to
a file, spawns S ranks (``parallel.mesh.run_ranks``) that join one process
group through a file store under the test's temporary directory (so
concurrent test workers never share a port), and returns every rank's
result.  This module imports torch and the port only, so a rank starts
without JAX.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from vloam_tpu_torch.models.frame_graph import kitti_default_extrinsics
from vloam_tpu_torch.models.laser_mapping import init_map_state
from vloam_tpu_torch.models.vloam import frame_to_device, init_vloam_state
from vloam_tpu_torch.ops.knn import knn_reference
from vloam_tpu_torch.parallel import mapping_shard, mesh as pmesh
from vloam_tpu_torch.parallel.pose_graph import optimize_pose_graph
from vloam_tpu_torch.parallel.vloam_shard import make_sharded_vloam_step, shard_vloam_state

RANK_TIMEOUT = 300.0    # s, a whole job (spawn, rendezvous, work)


def merge_job(mesh, p):
    nbr, d2 = mapping_shard._merge_topk(p["packets"][mesh.rank], p["k"], mesh)
    return dict(nbr=nbr, d2=d2, bytes=mapping_shard.MERGE_BYTES)


def window_box_job(mesh, p):
    """This rank's k-NN of ``p["query"]`` among its candidates, rebased to
    its own box's centre and to the window's (``_window_box``)."""
    cand, mask, n = p["cand"][mesh.rank], p["mask"][mesh.rank], p["count"][mesh.rank]
    ((boxed, bmask),) = mapping_shard._window_box(((cand, mask),), mesh)
    return dict(own=knn_reference(p["query"], cand, mask, p["k"], cand_count=n),
                window=knn_reference(p["query"], boxed, bmask, p["k"], cand_count=n),
                box=boxed[-2:])


def mapping_job(mesh, p):
    """The sharded mapping step over ``p["feeds"]``, from ``p["wmap_wodom"]``
    where the payload has one (the identity otherwise)."""
    cfg = p["cfg"]
    state = init_map_state(cfg, "cpu", n_shards=mesh.size)
    if "wmap_wodom" in p:
        state = state._replace(wmap_wodom=p["wmap_wodom"])
    state = pmesh.shard_map_state(state, mesh)
    step = mapping_shard.make_sharded_step(cfg, mesh)
    poses = []
    for feed in p["feeds"]:
        state, pose = step(state, *feed)
        poses.append(pose)
    return dict(poses=torch.stack(poses), state=state._asdict(), bytes=mapping_shard.MERGE_BYTES)


def vloam_job(mesh, p):
    cfg = p["cfg"]
    state = shard_vloam_state(init_vloam_state(cfg, "cpu", n_map_shards=mesh.size), mesh)
    step = make_sharded_vloam_step(cfg, p["ext"], mesh)
    outs = []
    for f in p["frames"]:
        img, g, m, bk, lf = frame_to_device(*f, "cpu")
        state, out = step(state, img, g, m, pre_gridded=True, pre_buckets=bk, pre_lf_table=lf)
        outs.append(out._asdict())
    return dict(outs=outs, map=state.mp._asdict())


def vloam_raw_job(mesh, p):
    """The sharded step on raw padded clouds (``pre_gridded=False``)."""
    cfg = p["cfg"]
    ext = kitti_default_extrinsics("cpu")
    state = shard_vloam_state(init_vloam_state(cfg, "cpu", n_map_shards=mesh.size), mesh)
    step = make_sharded_vloam_step(cfg, ext, mesh)
    outs = []
    for img, cloud, mask in p["frames"]:
        state, out = step(state, torch.tensor(img), torch.tensor(cloud), torch.tensor(mask))
        outs.append(out._asdict())
    return dict(outs=outs, map=state.mp._asdict())


def default_device_job(mesh, p):
    """What ``map_mesh`` does when no device is given (the mesh passed in
    was asked for the CPU)."""
    try:
        return str(pmesh.map_mesh(mesh.size).device)
    except RuntimeError as e:
        return f"RuntimeError: {e}"


def pose_graph_job(mesh, p):
    return optimize_pose_graph(p["poses"], p["factors"][mesh.rank], iters=p["iters"], group=mesh)


JOBS = {"merge": merge_job, "window_box": window_box_job, "mapping": mapping_job,
        "vloam": vloam_job, "vloam_raw": vloam_raw_job, "pose_graph": pose_graph_job,
        "default_device": default_device_job}


def rank_main(rank, S, job, workdir):
    torch.set_num_threads(1)
    pmesh.init_distributed("gloo", f"file://{workdir}/store", S, rank,
                           timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    try:
        payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
        out = JOBS[job](pmesh.map_mesh(S, device="cpu"), payload)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_job(workdir, job: str, S: int, payload) -> list:
    """Every rank's result of ``job`` on an S-rank gloo mesh."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    torch.save(payload, os.path.join(workdir, "payload.pt"))
    pmesh.run_ranks(rank_main, S, args=(S, job, workdir), timeout=RANK_TIMEOUT)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(S)]
