"""Two k-NN problems in one call (counterpart of
``vloam_tpu/ops/pallas_knn.knn_lanemin_pair``).

In this copy ``knn_pair`` is its plain PyTorch version,
``knn_pair_reference``, on every device.  The contract is exact (unlike the
TPU kernel's lane-class approximation):

* d2 in difference form after rebasing to the centre of the bounding box
  of the masked candidates, those at or past the candidate count included,
  ties to the lower candidate index;
* masked candidates and candidates at or past the candidate count never
  enter; unfilled slots are d2 = +inf with index 0 (in range, so LO and MO
  may gather with it);
* queries at or past the query count return d2 = +inf, index 0;
* with ``prune_radius`` (per problem a float or None), every slot whose d2
  exceeds ``float32(r) ** 2`` is +inf with index 0 (``ops/knn.clamp_radius``).

Returns ``((d2_a (Ma, ka) f32, idx_a (Ma, ka) int64), (d2_b, idx_b))``.
"""

from __future__ import annotations

from plainref.ops.knn import clamp_radius, knn_reference

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
    return knn_pair_reference(qa, ca, ma, ka, qb, cb, mb, kb, a_counts, b_counts,
                              prune_radius)
