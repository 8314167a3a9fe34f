"""sift_gather_roofline: B2's single form at SIFT's 24x24 window (the
run-time instantiation ``gather_stack_kernel<0>`` of
``csrc/gather_patches.cu``; in the SIFT cell nothing else launches it)
against its roofline over the traced span: the summed bound of its calls
over their summed device time in the trace.

A call cuts every keypoint's window from one octave's middle Gaussian level:
N = (max_corners // 4) * 4 keypoints (4 octaves, the strongest
max_corners // 4 of each), N x 24 x 24 float32 written and N int32 (x, y)
corners read.  The image floats the windows read are left out, so the bound
is low and the share can only read low.  The calls are the kernels in the
trace; the bound is bytes / PEAK_BW."""

import re

from vbench import arith

KERNEL = re.compile(r"\bgather_stack_kernel<0>")
PATCH = 24
OCTAVES = 4


def call_bytes(n: int) -> int:
    """Bytes one call must move: the windows written and the corners read."""
    return n * PATCH * PATCH * 4 + n * 2 * 4


def read(run):
    tr = run.window.trace
    if tr is None:
        return None
    times = [e - s for name, s, e in tr.device_ops if KERNEL.search(name)]
    if not times or sum(times) <= 0:
        return None
    n = run.cell.config["vloam"]["visual"]["max_corners"] // OCTAVES * OCTAVES
    bound = len(times) * call_bytes(n) / arith.PEAK_BW
    return 100.0 * bound / (sum(times) * 1e-9)
