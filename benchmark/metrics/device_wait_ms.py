"""device_wait_ms: the host blocked on the card a frame (ms), from
VloamDriver's StageTimer: every ``wait.<site>`` span (the frame's fetch, and
MO's host decisions and copies to the card; a new site counts as it
appears), summed over the window drivers and divided by the frames of their
``vloam_step`` stage.  A program without such spans reads nothing."""


def read(run):
    frames = run.stages.get("vloam_step", (0.0, 0))[1]
    waits = [ms for name, (ms, _) in run.stages.items() if name.startswith("wait.")]
    return sum(waits) / frames if frames and waits else None
