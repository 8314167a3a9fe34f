"""visual_odometry_ms: VO a frame (ms), from VloamDriver's StageTimer: the
step's ``visual_odometry`` span around ``vo_step`` (KLT or ORB, the depth
association, B2 and B4), summed over the window drivers and divided by the
frames of their ``vloam_step`` stage.  A program without the span reads
nothing."""

SPAN = "visual_odometry"


def read(run):
    frames = run.stages.get("vloam_step", (0.0, 0))[1]
    return run.stages[SPAN][0] / frames if frames and SPAN in run.stages else None
