"""host_stages_ms: VloamDriver's host stages a frame (ms), from its
StageTimer: host_grid + host_buckets + host_lf_voxel + host_f64_chain, summed
over every frame the window's drivers processed and divided by them."""

STAGES = ("host_grid", "host_buckets", "host_lf_voxel", "host_f64_chain")


def read(run):
    frames = run.stages.get("host_grid", (0.0, 0))[1]
    if not frames:
        return None
    return sum(run.stages.get(s, (0.0, 0))[0] for s in STAGES) / frames
