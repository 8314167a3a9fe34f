"""The sharded step's rebase centre on the card (ROADMAP C-n).  Run from the
repo root on a machine with one GPU:

    env PYTHONPATH=. python3 tests/torch_shard_centre.py

It runs ``chip_smoke.py``'s phase 15 (b) and (c) on phase 2's first 12
frames (after phases 4 and 5, whose launches and syncs (b) and (c) are held
to), then two more S = 2 drives over gloo on the card: every rank rebasing
its k-NN searches to the whole window's box centre (the step as it is), and
each rank rebasing to its own slice's centre (``mapping_shard._window_box``
replaced in the ranks by the identity, the step before the repair), and
prints each rank's largest output difference from (b) frame by frame.  No
tier-1 test: it needs the card.
"""

import os
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs


def rank_own_centre(rank, S, backend, workdir):
    """A phase 15 (c) rank whose searches rebase to its own slice's centre."""
    from vloam_tpu_torch.parallel import mapping_shard

    mapping_shard._window_box = lambda problems, mesh: problems
    cs.shard_rank(rank, S, backend, workdir)


def two_ranks(fn, cfg, short, graph):
    from vloam_tpu_torch.parallel.mesh import run_ranks
    from vloam_tpu_torch.parallel.pose_graph import concat_factors

    factors = concat_factors(graph["chain"], graph["loop"])
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(dict(job="vloam", cfg=cfg, frames=short, pg_poses=graph["poses"].float().cpu(),
                        pg_factors=cs.split_factors(factors, 2)), os.path.join(tmp, "payload.pt"))
        run_ranks(fn, 2, args=(2, "gloo", tmp), timeout=cs.SHARD_TIMEOUT)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(2)]


def ring_graph(dev, W=56):
    """A ring of W poses with one loop factor: the pose-graph job the ranks run last."""
    from vloam_tpu_torch import geometry as geo
    from vloam_tpu_torch.parallel import pose_graph as pg

    steps = torch.tensor([[0, 0, np.sin(0.056), np.cos(0.056), 1.0, 0.02, 0]] * (W - 1),
                         dtype=torch.float32)
    poses = [torch.tensor([0, 0, 0, 1.0, 0, 0, 0])]
    for d in steps:
        poses.append(geo.pose_compose(poses[-1], d))
    loop = pg.PoseGraphFactors(i=torch.tensor([0]), j=torch.tensor([W - 1]),
                               z=torch.tensor([[0, 0, 0, 1.0, 0.5, 0, 0]]),
                               weight=torch.tensor([10.0]), valid=torch.ones(1, dtype=torch.bool))
    on = lambda f: pg.PoseGraphFactors(*(x.to(dev) for x in f))  # noqa: E731
    return dict(poses=torch.stack(poses).to(dev), chain=on(pg.odometry_factors(steps)),
                loop=on(loop))


def main():
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.config import kitti_hdl64
    from vloam_tpu_torch.data import stream
    from vloam_tpu_torch.models import frame_graph as fg
    from vloam_tpu_torch.models.vloam import frame_to_device

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, torch.__version__, torch.version.cuda)
    kernels.build()
    kernels.lib()
    cfg = kitti_hdl64()
    ext = fg.kitti_default_extrinsics(dev)
    raw, poses = stream.gen_raw(cfg, ext, cs.N_SHORT, speed=cs.SPEED, yaw_rate=cs.YAW_RATE)
    proj = stream.camera_matrices(ext)[1]
    short = [stream.host_frame(cfg, proj, img, cloud) for img, cloud in raw]
    dframes = [frame_to_device(*f, dev) for f in short]
    slice_syncs = cs.check_slice(cfg, dframes, poses, card)
    _, per_frame, syncs, ms = cs.check_step(cfg, ext, dframes, poses, card, slice_syncs)
    graph = ring_graph(dev)
    outs, counts, _ = cs.check_shard_one(cfg, ext, dframes, card, per_frame, syncs, ms)
    del dframes
    cs.fresh_device(dev)
    cs.check_shard_two(cfg, short, card, outs, counts, per_frame, graph, dev)
    for label, fn in (("window box", cs.shard_rank), ("own centre", rank_own_centre)):
        for r, x in enumerate(two_ranks(fn, cfg, short, graph)):
            per = [max(float((o[k] - ref[k]).abs().max()) for k in cs.SHARD_OUTPUTS)
                   for o, ref in zip(x["outs"], outs)]
            print(f"{label}, rank {r}: largest |S=2 - S=1| a frame "
                  + " ".join(f"{v:.2e}" for v in per)
                  + f"; points {x['counts']}, window {x['window']} [{card}]")


if __name__ == "__main__":
    sys.exit(main())
