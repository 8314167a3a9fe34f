"""syncs_per_frame: synchronising CUDA calls a steady frame, counted with
``torch.cuda.set_sync_debug_mode("warn")`` on the frames fed to the last
window driver after the window (vbench.syncs.SyncCounter)."""


def read(run):
    return sum(run.syncs) / len(run.syncs) if run.syncs else None
