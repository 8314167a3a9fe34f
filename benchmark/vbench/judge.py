"""The comparison that decides ``correct``.

The timed path's answers are the VO, LO and MO rows that each window driver
exported (KITTI files under the run's scratch directory).  They are judged
two ways.

Against the generator's exact poses, every row of every window driver: the
drift of each chain, ``<chain>_drift_pct``, is the widest position error as
a share of the distance driven, over the frames past ``drift_from_m``.  The
truth is independent of the program; it catches a fault that the program
and its plain reference would share.

Against the plain reference (``plainref``: the port's frame step as it
stood at commit 2b93434, every hand-written kernel replaced by its plain
version, the host tables written from the host library's source,
deterministic algorithms), the first ``judged_frames`` rows of the window's
first driver: ``<chain>_gap_m`` is the widest distance, in metres, between
the program's and the reference's positions over those frames, from frame 0.
The step carries its state from frame to frame, so the reference replays the
drive from its first frame, from the same raw frames, and works out its own
map, grids and buckets.  The judged frames run past the first cube crossing
of the map.  This is the kernels' and the host library's check: the
reference shares the port's logic, so it cannot catch a fault of that logic.

Every window driver must also have exported one finite row a chain for each
frame it was fed.  A problem fails the run whatever the numbers.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

CHAINS = ("vo", "lo", "mo")


def read_rows(run_dir: str, detach: int) -> dict:
    """{chain: (n, 3, 4) float64 poses} of one driver's exported files."""
    out = {}
    for c in CHAINS:
        path = os.path.join(run_dir, f"{c.upper()}{detach}.txt")
        rows = np.loadtxt(path, dtype=np.float64, ndmin=2) if os.path.exists(path) \
            and os.path.getsize(path) else np.zeros((0, 12))
        out[c] = rows.reshape(-1, 3, 4)
    return out


def exports(rows: dict, fed: dict) -> list:
    """[problems] of every driver's exported rows {run: {chain: (n, 3, 4)}}
    against the frames it was fed {run: n}."""
    problems = []
    for key, r in sorted(rows.items()):
        for c in CHAINS:
            if len(r[c]) != fed[key] or not np.all(np.isfinite(r[c])):
                problems.append(f"driver {key}: {len(r[c])} {c.upper()} rows for {fed[key]} "
                                f"frames fed" + ("" if np.all(np.isfinite(r[c])) else
                                                 ", not all finite"))
    return problems


def truth_rows(R: np.ndarray, t: np.ndarray, cam_T_base: np.ndarray) -> np.ndarray:
    """(n, 3, 4): the generator's sensor poses world_T_base (R, t) as the
    rows the driver exports, cam0_start_T_cam0_i = C T_0^-1 T_i C^-1 with
    C = ``cam_T_base`` (4, 4)."""
    T = np.zeros((len(R), 4, 4))
    T[:, :3, :3], T[:, :3, 3], T[:, 3, 3] = R, t, 1.0
    rel = np.linalg.inv(T[0]) @ T
    return (cam_T_base @ rel @ np.linalg.inv(cam_T_base))[:, :3, :4]


def drift(rows: dict, truth: np.ndarray, from_m: float) -> dict:
    """{"<chain>_drift_pct": the widest position error over the distance
    driven, in %, over frames past ``from_m`` metres} of every driver's rows
    {run: {chain: (n, 3, 4)}} against ``truth`` (frames, 3, 4), the widest
    over the drivers.  A non-finite row reads infinite."""
    dist = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(truth[:, :, 3], axis=0),
                                                          axis=1))])
    out = {f"{c}_drift_pct": 0.0 for c in CHAINS}
    for r in rows.values():
        for c in CHAINS:
            p = r[c][:len(truth)]
            far = dist[:len(p)] >= from_m
            if not far.any():
                continue
            err = np.linalg.norm(p[far, :, 3] - truth[:len(p)][far, :, 3], axis=1)
            worst = float(np.max(100.0 * err / dist[:len(p)][far]))
            out[f"{c}_drift_pct"] = max(out[f"{c}_drift_pct"],
                                        worst if np.isfinite(worst) else float("inf"))
    return out


def reference_rows(ref_cfg, frames: list, judged: int, device, tf32: bool = False) -> dict:
    """The plain reference's poses {chain: (judged, 3, 4)} of the drive
    ``frames``.  ``tf32`` computes it with TF32 on: the precision control."""
    import plainref  # noqa: F401  (sets the numeric policy)
    from plainref import geometry_np as gnp
    from plainref.driver import PlainDriver

    dev = torch.device(device)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.are_deterministic_algorithms_enabled())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            drv = PlainDriver(ref_cfg, dev)
            for img, cloud in frames[:judged]:
                drv.process(img, cloud)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.use_deterministic_algorithms(prev[2])
    return {c: np.array([gnp.pose_to_matrix(r)[:3, :4] for r in drv.rows[c]])
            .reshape(-1, 3, 4) for c in CHAINS}


def frame_gaps(program: dict, reference: dict, judged: int) -> dict:
    """{chain: [position gap a frame]} (m), for the log."""
    out = {}
    for c in CHAINS:
        m = min(len(program[c]), len(reference[c]), judged)
        out[c] = np.linalg.norm(program[c][:m, :, 3] - reference[c][:m, :, 3], axis=1).tolist()
    return out


def gaps(program: dict, reference: dict, judged: int) -> tuple[dict, list]:
    """({"<chain>_gap_m": widest position gap}, [problems]) of the program's
    poses against the reference's over the first ``judged`` frames."""
    worst, problems = {}, []
    for c in CHAINS:
        p = program[c][:judged]
        if len(p) < judged:
            problems.append(f"{len(p)} {c.upper()} rows judged, {judged} wanted")
        if not np.all(np.isfinite(p)):
            problems.append(f"a judged {c.upper()} row is not finite")
            worst[f"{c}_gap_m"] = float("inf")
            continue
        g = frame_gaps(program, reference, judged)[c]
        worst[f"{c}_gap_m"] = float(max(g, default=0.0))
    return worst, problems


def verdict(numbers: dict, limits: dict, problems: list) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number that ``limits``
    names within its limit, and no problem.  A number the run could not
    read fails."""
    checks = {k: {"value": numbers.get(k, float("inf")), "limit": v} for k, v in limits.items()}
    ok = not problems and all(v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
