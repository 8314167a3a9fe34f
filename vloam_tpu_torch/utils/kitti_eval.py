"""KITTI odometry benchmark metrics — translational RMSE (%) and rotational
error (deg/m) over 100..800 m sub-trajectories.

The reference delegates this to an external tool
(LeoQLi/KITTI_odometry_evaluation_tool, README.md:27-31); implementing the
standard protocol here makes golden-trajectory regression self-contained:
compare our exports against the reference's saved results/ trajectories or
against ground truth with the same numbers as the paper table.

Pure NumPy, reference protocol: for every start frame and every length in
{100, 200, ..., 800} m, find the frame reaching that distance along the
ground-truth path and measure the relative-pose error of the aligned segment.
"""

from __future__ import annotations

import numpy as np

LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def _to_se3(traj: np.ndarray) -> np.ndarray:
    """(N, 3, 4) -> (N, 4, 4)."""
    n = traj.shape[0]
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :4] = traj
    return out


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Cumulative path length at each frame."""
    d = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(d)])


def _first_frame_past(dist: np.ndarray, start: int, length: float) -> int:
    target = dist[start] + length
    idx = np.searchsorted(dist, target)
    return int(idx) if idx < len(dist) else -1


def rotation_error(R: np.ndarray) -> float:
    tr = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    return float(np.arccos(tr))


def kitti_errors(
    gt: np.ndarray,        # (N, 3, 4) ground truth (or reference trajectory)
    est: np.ndarray,       # (N, 3, 4) estimate
    step: int = 10,        # evaluate every 10th start frame (KITTI protocol)
) -> list[tuple[int, float, float, float]]:
    """[(first_frame, rot_err_per_m, trans_err_ratio, length), ...]."""
    n = min(len(gt), len(est))
    gt4, est4 = _to_se3(gt[:n]), _to_se3(est[:n])
    dist = trajectory_distances(gt4)
    errors = []
    for start in range(0, n, step):
        for length in LENGTHS:
            end = _first_frame_past(dist, start, length)
            if end < 0 or end >= n:
                continue
            gt_rel = np.linalg.inv(gt4[start]) @ gt4[end]
            est_rel = np.linalg.inv(est4[start]) @ est4[end]
            err = np.linalg.inv(est_rel) @ gt_rel
            r_err = rotation_error(err[:3, :3]) / length
            t_err = np.linalg.norm(err[:3, 3]) / length
            errors.append((start, r_err, t_err, length))
    return errors


def evaluate(gt: np.ndarray, est: np.ndarray, step: int = 10) -> dict:
    """Headline numbers: translational RMSE %% and rotational deg/m (averages
    over all sub-trajectories, the Table-I convention)."""
    errs = kitti_errors(gt, est, step)
    if not errs:
        return {"trans_pct": float("nan"), "rot_deg_per_m": float("nan"), "segments": 0}
    r = np.array([e[1] for e in errs])
    t = np.array([e[2] for e in errs])
    return {
        "trans_pct": float(np.mean(t) * 100.0),
        "rot_deg_per_m": float(np.degrees(np.mean(r))),
        "segments": len(errs),
    }


def ate(gt: np.ndarray, est: np.ndarray) -> float:
    """Absolute trajectory error (RMSE of translation, no alignment)."""
    n = min(len(gt), len(est))
    d = gt[:n, :3, 3] - est[:n, :3, 3]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))
