"""Two k-NN problems in one call (counterpart of
``vloam_tpu/ops/pallas_knn.knn_lanemin_pair``).

``knn_pair`` launches the CUDA kernels of ``csrc/knn_pair.cu`` for CUDA
tensors and uses the plain PyTorch version, ``knn_pair_reference``, for CPU
tensors; it never falls back from one to the other.  Both return the same
contract, which is exact (unlike the TPU kernel's lane-class approximation):

* d2 in difference form after rebasing to the centre of the valid
  candidates' bounding box, ties to the lower candidate index;
* masked candidates and candidates at or past the candidate count never
  enter; unfilled slots are d2 = +inf with index 0 (in range, so LO and MO
  may gather with it);
* queries at or past the query count return d2 = +inf, index 0;
* with ``prune_radius`` (per problem a float or None), every slot whose d2
  exceeds ``float32(r) ** 2`` is +inf with index 0 (``ops/knn.clamp_radius``).
  The kernel then skips every (query tile, candidate tile) step whose two
  bounding boxes lie farther apart; what it skips never shows in the result.

Returns ``((d2_a (Ma, ka) f32, idx_a (Ma, ka) int64), (d2_b, idx_b))``.
"""

from __future__ import annotations

import torch

from vloam_tpu_torch import kernels
from vloam_tpu_torch.ops.knn import (clamp_radius, knn_plan, knn_reference, problem_args,
                                     radius_sq)

# knn_pair calls that launched (3 or 4 __global__ launches each; plain calls do not count)
LAUNCHES = 0

KERNEL_K_PAIRS = ((8, 16), (5, 5), (8, 8), (16, 16))  # instantiated in knn_pair.cu


def knn_pair_reference(qa, ca, ma, ka, qb, cb, mb, kb,
                       a_counts=(None, None), b_counts=(None, None),
                       prune_radius=(None, None)):
    """Plain PyTorch version: two blocked exact top-k searches, each followed
    by the radius rule (it launches no kernel of this package, on either
    device)."""
    return (
        clamp_radius(*knn_reference(qa, ca, ma, ka, cand_count=a_counts[1],
                                    query_count=a_counts[0]), prune_radius[0]),
        clamp_radius(*knn_reference(qb, cb, mb, kb, cand_count=b_counts[1],
                                    query_count=b_counts[0]), prune_radius[1]),
    )


def knn_pair(qa, ca, ma, ka, qb, cb, mb, kb,
             a_counts=(None, None), b_counts=(None, None),
             prune_radius=(None, None), stats=None):
    """k-NN of queries ``qa`` among candidates ``ca`` (mask ``ma``) and of
    ``qb`` among ``cb`` (mask ``mb``) in one call.  ``*_counts`` are
    (query_count, cand_count) dynamic valid-prefix lengths (0-d tensors,
    ints or None).  ``stats`` (measurement only): a zeroed int32 (4,) CUDA
    tensor that receives the (query tile, candidate tile) steps swept and
    skipped, per problem."""
    global LAUNCHES
    if qa.device.type == "cpu":
        return knn_pair_reference(qa, ca, ma, ka, qb, cb, mb, kb, a_counts, b_counts,
                                  prune_radius)
    kernels.require_cuda("knn_pair", qa, ca, ma, qb, cb, mb)
    if (ka, kb) not in KERNEL_K_PAIRS:
        raise ValueError(f"knn_pair: k pair {(ka, kb)} not instantiated in knn_pair.cu")
    if ma.dtype != torch.bool or mb.dtype != torch.bool:
        raise ValueError("knn_pair: masks must be bool")
    for q, c, m in ((qa, ca, ma), (qb, cb, mb)):
        if q.shape[1:] != (3,) or c.shape[1:] != (3,) or m.shape != c.shape[:1]:
            raise ValueError(f"knn_pair: shapes {tuple(q.shape)}, {tuple(c.shape)}, "
                             f"{tuple(m.shape)}; want (M, 3), (N, 3), (N,)")
    if stats is not None and (stats.dtype != torch.int32 or stats.shape != (4,)
                              or stats.device != qa.device):
        raise ValueError("knn_pair: stats must be an int32 (4,) tensor on the inputs' device")
    dev = qa.device
    lib = kernels.lib()
    problems, scratch_bytes = [], 0
    for q, c, mask, k, counts, r in ((qa, ca, ma, ka, a_counts, prune_radius[0]),
                                     (qb, cb, mb, kb, b_counts, prune_radius[1])):
        m, n = q.shape[0], c.shape[0]
        args, alive = problem_args(q, c, mask, k, counts[0], counts[1])
        plan = knn_plan(m, n, pruned=r is not None)
        scratch_bytes += lib.vloam_knn_scratch_bytes(m, n, k, *plan)
        d2 = torch.empty((m, k), dtype=torch.float32, device=dev)
        idx = torch.empty((m, k), dtype=torch.int64, device=dev)
        problems.append((d2, idx, alive, (*args, *plan, float("inf") if r is None else radius_sq(r),
                                          d2.data_ptr(), idx.data_ptr())))
    scratch = torch.empty((scratch_bytes,), dtype=torch.uint8, device=dev)
    rc = lib.vloam_knn_pair(
        *problems[0][3], *problems[1][3], scratch.data_ptr(),
        None if stats is None else stats.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(rc, "knn_pair")
    LAUNCHES += 1
    return problems[0][:2], problems[1][:2]
