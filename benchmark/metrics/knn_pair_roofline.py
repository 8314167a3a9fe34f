"""knn_pair_roofline: B1 (``ops.fused_knn.knn_pair`` ->
``csrc/knn_pair.cu``) against its roofline over the traced span: the summed
bound of the calls LO and MO made while the profiler ran (``arith.knn_work``
at each call's live counts; the larger of operations / PEAK_F32 and bytes /
PEAK_BW), over the summed device time of B1's kernels in the trace."""

import re

from vbench import arith

B1_KERNELS = re.compile(r"\bpair_(prepass|sweep|merge|bound)\b")


def read(run):
    tr = run.window.trace
    if tr is None or not run.knn:
        return None
    device_ns = sum(e - s for name, s, e in tr.device_ops if B1_KERNELS.search(name))
    if device_ns <= 0:
        return None
    bound = 0.0
    for call in run.knn:
        ops = sum(arith.knn_work(*p)[0] for p in call)
        nbytes = sum(arith.knn_work(*p)[1] for p in call)
        bound += arith.bound_s(ops, nbytes)
    return 100.0 * bound / (device_ns * 1e-9)
