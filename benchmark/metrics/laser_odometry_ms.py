"""laser_odometry_ms: LO a frame (ms), from VloamDriver's StageTimer: the
step's ``laser_odometry`` span around ``lo_step`` and ``lo_delta_to_cam0``,
summed over the window drivers and divided by the frames of their
``vloam_step`` stage.  A program without the span reads nothing."""

SPAN = "laser_odometry"


def read(run):
    frames = run.stages.get("vloam_step", (0.0, 0))[1]
    return run.stages[SPAN][0] / frames if frames and SPAN in run.stages else None
