"""KITTI-format trajectory export — reference: vloam_tf.cpp:100-106.

Rows are the 12 floats of the 3x4 [R|t], row-major, written with "%f"
(6 fixed decimals) so files are byte-compatible with the reference output
under src/vloam_main/results/ and feed the same external evaluator
(LeoQLi/KITTI_odometry_evaluation_tool)."""

from __future__ import annotations

import numpy as np

from vloam_tpu_torch import geometry_np as gnp


def pose_to_kitti_row(pose) -> str:
    # host-only f64 conversion (geometry_np): the writer sits on VloamDriver's
    # f64 pose chains and never touches the device
    m = gnp.pose_to_matrix(np.asarray(pose, np.float64))[:3, :4].reshape(-1)
    return " ".join("%f" % v for v in m)


class TrajectoryWriter:
    """Streaming writer for one trajectory file (VO*.txt / LO*.txt / MO*.txt).

    The file opens lazily on the first ``append`` so a resumed run can call
    ``resume_at(n)`` first: truncate the file to the checkpointed row count
    and continue in append mode instead of clobbering the pre-resume rows
    (the reference never resumes; a fresh run overwrites, as here by
    default)."""

    def __init__(self, path):
        self.path = path
        self._f = None
        self._mode = "w"
        self.rows = 0

    def resume_at(self, n_rows: int) -> None:
        """Keep the first ``n_rows`` rows of an existing file and append
        after them.  Must be called before the first ``append``."""
        if self._f is not None:
            raise RuntimeError("resume_at must precede the first append")
        import os

        lines = []
        if os.path.exists(self.path):
            with open(self.path) as f:
                lines = f.readlines()[:n_rows]
        with open(self.path, "w") as f:
            f.writelines(lines)
        self.rows = len(lines)
        self._mode = "a"

    def append(self, pose) -> None:
        if self._f is None:
            self._f = open(self.path, self._mode)
        self._f.write(pose_to_kitti_row(pose) + "\n")
        self.rows += 1

    def flush(self) -> None:
        """Push buffered rows to disk (called at checkpoint time so the
        file provably holds every pre-checkpoint row a resume will keep)."""
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_kitti_trajectory(path) -> np.ndarray:
    """Read a KITTI pose file -> (N, 3, 4)."""
    rows = np.loadtxt(path, dtype=np.float64)
    if rows.ndim == 1:
        rows = rows[None]
    return rows.reshape(-1, 3, 4)
