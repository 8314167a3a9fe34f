"""step_ms: the frame step a frame (ms), from VloamDriver's StageTimer stage
vloam_step (the uploads, ``vloam_step`` and the frame's one fetch, which
waits for the device), over every frame the window's drivers processed."""


def read(run):
    total, frames = run.stages.get("vloam_step", (0.0, 0))
    return total / frames if frames else None
