"""Two k-NN problems in one kernel launch (counterpart of
``vloam_tpu/ops/pallas_knn.knn_lanemin_pair``).

``knn_pair`` launches the CUDA kernel ``csrc/knn_pair.cu`` for CUDA tensors
and uses the plain PyTorch version, ``knn_pair_reference``, for CPU tensors;
it never falls back from one to the other.  Both return the same contract,
which is exact (unlike the TPU kernel's lane-class approximation):

* d2 in difference form after rebasing to the centre of the valid
  candidates' bounding box, ties to the lower candidate index;
* masked candidates and candidates at or past the candidate count never
  enter; unfilled slots are d2 = +inf with index 0 (in range, so LO and MO
  may gather with it);
* queries at or past the query count return d2 = +inf, index 0.

Returns ``((d2_a (Ma, ka) f32, idx_a (Ma, ka) int64), (d2_b, idx_b))``.
"""

from __future__ import annotations

import torch

from vloam_tpu_torch import kernels
from vloam_tpu_torch.ops.knn import as_count, center_of, knn_reference

LAUNCHES = 0  # kernel launches by knn_pair (plain-version calls do not count)

KERNEL_K_PAIRS = ((8, 16), (5, 5), (8, 8), (16, 16))  # instantiated in knn_pair.cu


def knn_pair_reference(qa, ca, ma, ka, qb, cb, mb, kb,
                       a_counts=(None, None), b_counts=(None, None)):
    """Plain PyTorch version: two blocked exact top-k searches (it launches
    no kernel of this package, on either device)."""
    return (
        knn_reference(qa, ca, ma, ka, cand_count=a_counts[1], query_count=a_counts[0]),
        knn_reference(qb, cb, mb, kb, cand_count=b_counts[1], query_count=b_counts[0]),
    )


def knn_pair(qa, ca, ma, ka, qb, cb, mb, kb,
             a_counts=(None, None), b_counts=(None, None)):
    """k-NN of queries ``qa`` among candidates ``ca`` (mask ``ma``) and of
    ``qb`` among ``cb`` (mask ``mb``) in one launch.  ``*_counts`` are
    (query_count, cand_count) dynamic valid-prefix lengths (0-d tensors,
    ints or None)."""
    global LAUNCHES
    if qa.device.type == "cpu":
        return knn_pair_reference(qa, ca, ma, ka, qb, cb, mb, kb, a_counts, b_counts)
    if (ka, kb) not in KERNEL_K_PAIRS:
        raise ValueError(f"knn_pair: k pair {(ka, kb)} not instantiated in knn_pair.cu")
    qa, ca, qb, cb = (x.to(torch.float32).contiguous() for x in (qa, ca, qb, cb))
    ma, mb = ma.contiguous(), mb.contiguous()
    kernels.require_cuda("knn_pair", qa, ca, ma, qb, cb, mb)
    if ma.dtype != torch.bool or mb.dtype != torch.bool:
        raise ValueError("knn_pair: masks must be bool")
    dev = qa.device
    cen_a = center_of(ca, ma).contiguous()
    cen_b = center_of(cb, mb).contiguous()
    counts = torch.stack([
        as_count(a_counts[0], qa.shape[0], dev), as_count(a_counts[1], ca.shape[0], dev),
        as_count(b_counts[0], qb.shape[0], dev), as_count(b_counts[1], cb.shape[0], dev),
    ]).to(torch.int32)
    d2a = torch.empty((qa.shape[0], ka), dtype=torch.float32, device=dev)
    ia = torch.empty((qa.shape[0], ka), dtype=torch.int64, device=dev)
    d2b = torch.empty((qb.shape[0], kb), dtype=torch.float32, device=dev)
    ib = torch.empty((qb.shape[0], kb), dtype=torch.int64, device=dev)
    rc = kernels.lib().vloam_knn_pair(
        qa.data_ptr(), ca.data_ptr(), ma.data_ptr(), cen_a.data_ptr(),
        qa.shape[0], ca.shape[0], ka, d2a.data_ptr(), ia.data_ptr(),
        qb.data_ptr(), cb.data_ptr(), mb.data_ptr(), cen_b.data_ptr(),
        qb.shape[0], cb.shape[0], kb, d2b.data_ptr(), ib.data_ptr(),
        counts.data_ptr(), kernels.stream_ptr(dev),
    )
    kernels.check(rc, "knn_pair")
    LAUNCHES += 1
    return (d2a, ia), (d2b, ib)
