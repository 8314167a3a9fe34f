"""Time the banded pose-graph solve (``parallel/pose_graph.py``) and its
parts on the GPU and on the host CPU.

    python -m vloam_tpu_torch.tools.pose_graph_check [W ...]

builds, for each window W (default 56, 560 and 4541: the ring course of
chip_smoke phase 10, ten of it, and the frame count of KITTI sequence 00),
a ring course of W poses with three noisy odometry chains over it (the
driver's MO, LO and VO chains) and one loop factor from the last pose to
the first, and prints for each device the host milliseconds (behind a
device sync, median of 3) of

  eval     ``_eval_factors`` over the chain factors (vmap of jacfwd);
  thomas   one ``_block_thomas_solve`` with 1 + 6 right-hand sides (the
           Woodbury form with one loop factor);
  banded   ``optimize_pose_graph_banded`` with the given iterations (8, as
           ``refine_trajectory`` calls it, for W <= 560; 1 above, so the
           whole run stays short), and that per iteration.

Plain PyTorch throughout (the reference has no Pallas kernel here), so the
times show where the solve's time goes: the ``eval`` share against the
block loops of ``thomas``.  It needs a GPU and exits nonzero without one.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from vloam_tpu_torch import geometry as geo
from vloam_tpu_torch.parallel import pose_graph as pg
from vloam_tpu_torch.tools.gather_experiments import card_line

RUNS = 3


def ring_problem(W: int, device):
    """(poses (W, 7), chain factors, loop factor) of a noisy ring course,
    from NumPy's ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    yaw = 2 * np.pi / W
    steps = []
    for _ in range(3):
        a = yaw + rng.normal(0, 0.002, W - 1)
        q = np.stack([np.zeros(W - 1), np.zeros(W - 1), np.sin(a / 2), np.cos(a / 2)], -1)
        t = np.array([1.1, 0.0, 0.0]) + rng.normal(0, 0.01, (W - 1, 3))
        steps.append(torch.tensor(np.concatenate([q, t], -1), dtype=torch.float32))
    poses = [geo.pose_identity()]
    for k in range(W - 1):
        poses.append(geo.pose_compose(poses[-1], steps[0][k]))
    poses = torch.stack(poses).to(device)
    chain = pg.concat_factors(*[pg.odometry_factors(s.to(device), w)
                                for s, w in zip(steps, (1.0, 0.5, 0.25))])
    close = geo.pose_compose(geo.pose_inverse(poses[-1].cpu()), poses[0].cpu())
    loop = pg.PoseGraphFactors(
        i=torch.tensor([W - 1], device=device), j=torch.tensor([0], device=device),
        z=(close + torch.tensor([0, 0, 0, 0, 0.5, -0.3, 0.0]))[None].to(device),
        weight=torch.ones(1, device=device), valid=torch.ones(1, dtype=torch.bool, device=device))
    return poses, chain, loop


def host_ms(fn, device) -> float:
    """Median host milliseconds of fn() behind a device sync, after one
    warm-up call."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    fn()
    sync()
    times = []
    for _ in range(RUNS):
        t = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def measure(W: int, device) -> dict:
    poses, chain, loop = ring_problem(W, device)
    iters = 8 if W <= 560 else 1
    gen = torch.Generator().manual_seed(0)
    diag = torch.eye(6).repeat(W, 1, 1) * 4 + 0.1 * torch.rand((W, 6, 6), generator=gen)
    diag = (diag + diag.transpose(1, 2)).to(device)
    upper = (-0.1 * torch.rand((W - 1, 6, 6), generator=gen)).to(device)
    rhs = torch.rand((W, 6, 7), generator=gen).to(device)
    out = {
        "eval": host_ms(lambda: pg._eval_factors(poses, chain, 0.5), device),
        "thomas": host_ms(lambda: pg._block_thomas_solve(diag, upper, rhs), device),
        "banded": host_ms(lambda: pg.optimize_pose_graph_banded(poses, chain, loop, iters=iters),
                          device),
        "iters": iters,
    }
    refined = pg.optimize_pose_graph_banded(poses, chain, loop, iters=iters)
    assert bool(torch.isfinite(refined).all()), f"W={W} on {device}: non-finite poses"
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("pose_graph_check: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    sizes = [int(a) for a in argv] or [56, 560, 4541]
    print(f"banded pose-graph solve, 3 chains + 1 loop factor, host ms behind a device sync "
          f"(median of {RUNS}) [{card}; host CPU: {torch.get_num_threads()} threads]")
    for W in sizes:
        for dev in (torch.device("cuda", 0), torch.device("cpu")):
            r = measure(W, dev)
            print(f"W={W} {dev.type}: eval {r['eval']:.2f} ms, thomas (7 RHS) {r['thomas']:.2f} "
                  f"ms, banded {r['iters']} iterations {r['banded']:.2f} ms "
                  f"({r['banded'] / r['iters']:.2f} ms an iteration)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
