"""Exact nearest-neighbour search and its helpers (port of the parts of
``vloam_tpu/ops/knn.py`` the lidar path uses).

``knn`` solves one k-NN problem: for CUDA tensors it launches the CUDA kernel
``csrc/knn.cu`` (the counterpart of ``vloam_tpu/ops/pallas_knn.knn_lanemin``)
and for CPU tensors it uses the plain PyTorch version ``knn_reference``; it
never falls back from one to the other.  ``nn1`` is its k = 1 form.  The
two-problem launch is ``ops/fused_knn.knn_pair``; all of them follow one
contract, which differs from the reference's ``knn`` on purpose, in three
ways:

* distances are in difference form, (qx-cx)^2 + (qy-cy)^2 + (qz-cz)^2, after
  rebasing both sets to the centre of the valid candidates' bounding box
  (the reference's CPU path uses the matmul form q^2 + c^2 - 2 q.c, which at
  +-60 m differs by ~1e-3 m^2 and can swap near-tied neighbours);
* masked candidates and unfilled slots are +inf (the reference: 3.4e38, and
  NaN from its TPU kernel for queries past the count), and an unfilled
  slot's index is 0, so callers may gather with it;
* the dynamic valid counts are honoured: candidates at or past
  ``cand_count`` never enter, and queries at or past ``query_count`` return
  +inf everywhere (the reference's CPU path ignores both counts).

The search is exact (the TPU kernel keeps one neighbour per lane class) and
ties go to the lower candidate index.
"""

from __future__ import annotations

import torch

from vloam_tpu_torch import kernels

LAUNCHES = 0  # kernel launches by knn / nn1 (plain-version calls do not count)

MAX_K = 128  # the range of the kernel it replaces (knn_lanemin)

_INF = 3.4e38  # masked_argmin sentinel (finite, as in the reference)
_INF_KEY = 0x7F800000 << 32  # sort key of d2 = +inf (f32 bits of inf, index 0)


def center_of(cand: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Centre of the valid candidates' axis-aligned bounding box ((3,); 0 when
    no candidate is valid)."""
    lo = torch.where(mask[:, None], cand, torch.inf).amin(dim=0)
    hi = torch.where(mask[:, None], cand, -torch.inf).amax(dim=0)
    return torch.where(torch.isfinite(lo), 0.5 * (lo + hi), 0.0)


def as_count(count, total: int, device) -> torch.Tensor:
    """A valid-prefix length (None, int or 0-d tensor) as a 0-d int64 tensor
    in [0, total]; None means all ``total`` rows."""
    if count is None:
        return torch.full((), total, dtype=torch.int64, device=device)
    return torch.as_tensor(count, device=device).to(torch.int64).clamp(0, total)


def knn_reference(
    query: torch.Tensor,       # (M, 3)
    cand: torch.Tensor,        # (N, 3)
    cand_mask: torch.Tensor,   # (N,) bool
    k: int,
    cand_count=None,           # () valid-prefix length of cand
    query_count=None,          # () valid-prefix length of query
    block: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``knn``: (d2 (M, k) f32, idx (M, k) int64).

    Blocked over the candidate axis with a running top-k merge.  Exact ties
    are broken by index: each distance is keyed as the int64
    ``(float bits << 32) | index`` (non-negative floats order like their
    bits), so one top-k over keys orders by (d2, index)."""
    m, n = query.shape[0], cand.shape[0]
    dev = query.device
    c_n = as_count(cand_count, n, dev)
    q_n = as_count(query_count, m, dev)
    valid = cand_mask & (torch.arange(n, device=dev) < c_n)
    cen = center_of(cand, cand_mask)
    qc = query - cen
    cc = cand - cen

    best = torch.full((m, k), _INF_KEY, dtype=torch.int64, device=dev)
    for s in range(0, n, block):
        e = min(s + block, n)
        dx = qc[:, 0:1] - cc[None, s:e, 0]
        dy = qc[:, 1:2] - cc[None, s:e, 1]
        dz = qc[:, 2:3] - cc[None, s:e, 2]
        d2 = dx * dx + dy * dy + dz * dz
        d2 = torch.where(valid[None, s:e], d2, torch.inf)
        keys = (d2.view(torch.int32).to(torch.int64) << 32) | torch.arange(
            s, e, dtype=torch.int64, device=dev)[None, :]
        kb = min(k, e - s)
        blk = torch.topk(keys, kb, dim=1, largest=False, sorted=True).values
        best = torch.topk(torch.cat([best, blk], dim=1), k, dim=1,
                          largest=False, sorted=True).values

    d2 = (best >> 32).to(torch.int32).view(torch.float32)
    idx = best & 0xFFFFFFFF
    live = (torch.arange(m, device=dev) < q_n)[:, None] & torch.isfinite(d2)
    return torch.where(live, d2, torch.inf), torch.where(live, idx, 0)


def knn(
    query: torch.Tensor,       # (M, 3)
    cand: torch.Tensor,        # (N, 3)
    cand_mask: torch.Tensor,   # (N,) bool
    k: int,
    cand_count=None,           # () valid-prefix length of cand
    query_count=None,          # () valid-prefix length of query
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest candidates per query: (d2 (M, k) f32, idx (M, k) int64).
    The counts are dynamic valid-prefix lengths (0-d tensors, ints or None),
    read on the device."""
    global LAUNCHES
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn: k = {k} outside [1, {MAX_K}]")
    if query.device.type == "cpu":
        return knn_reference(query, cand, cand_mask, k, cand_count, query_count)
    query, cand = query.to(torch.float32).contiguous(), cand.to(torch.float32).contiguous()
    cand_mask = cand_mask.contiguous()
    kernels.require_cuda("knn", query, cand, cand_mask)
    if cand_mask.dtype != torch.bool:
        raise ValueError("knn: the mask must be bool")
    if query.shape[1:] != (3,) or cand.shape[1:] != (3,) or cand_mask.shape != cand.shape[:1]:
        raise ValueError(f"knn: shapes {tuple(query.shape)}, {tuple(cand.shape)}, "
                         f"{tuple(cand_mask.shape)}; want (M, 3), (N, 3), (N,)")
    dev = query.device
    m, n = query.shape[0], cand.shape[0]
    cen = center_of(cand, cand_mask).contiguous()
    counts = torch.stack([as_count(query_count, m, dev), as_count(cand_count, n, dev)]
                         ).to(torch.int32)
    d2 = torch.empty((m, k), dtype=torch.float32, device=dev)
    idx = torch.empty((m, k), dtype=torch.int64, device=dev)
    rc = kernels.lib().vloam_knn(
        query.data_ptr(), cand.data_ptr(), cand_mask.data_ptr(), cen.data_ptr(), m, n, k,
        d2.data_ptr(), idx.data_ptr(), counts.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(rc, "knn")
    LAUNCHES += 1
    return d2, idx


def nn1_reference(query, cand, cand_mask, cand_count=None, query_count=None):
    """Plain PyTorch version of ``nn1``."""
    d2, idx = knn_reference(query, cand, cand_mask, 1, cand_count, query_count)
    return d2[:, 0], idx[:, 0]


def nn1(query, cand, cand_mask, cand_count=None, query_count=None):
    """Single nearest neighbour: (d2 (M,), idx (M,)), column 0 of ``knn``."""
    d2, idx = knn(query, cand, cand_mask, 1, cand_count, query_count)
    return d2[:, 0], idx[:, 0]


def masked_argmin(d2: torch.Tensor, valid: torch.Tensor):
    """Argmin along the last axis under a mask; returns (min, argmin).
    Masked entries count as 3.4e38; ties go to the first index."""
    d2m = torch.where(valid, d2, _INF)
    idx = torch.argmin(d2m, dim=-1)
    return torch.gather(d2m, -1, idx[..., None])[..., 0], idx


def compact_rows(pts: torch.Tensor, counts: torch.Tensor, out_cap: int):
    """Concatenate per-group valid prefixes into one dense (out_cap, D)
    buffer: destination row = exclusive-cumsum offset + rank.

    pts: (C, cap, D); counts: (C,).  Returns (out (out_cap, D), mask)."""
    C, cap, D = pts.shape
    dev = pts.device
    offs = torch.cumsum(counts, 0) - counts
    col = torch.arange(cap, device=dev)[None, :]
    dest = offs[:, None] + col
    ok = (col < counts[:, None]) & (dest < out_cap)
    # rejects land on one scrap row past the end (the reference's mode="drop")
    dest = torch.where(ok, dest, out_cap).reshape(-1)
    out = torch.zeros((out_cap + 1, D), dtype=pts.dtype, device=dev)
    out.index_put_((dest,), torch.where(ok.reshape(-1)[:, None], pts.reshape(-1, D), 0.0))
    total = torch.clamp(counts.sum(), max=out_cap)
    return out[:out_cap], torch.arange(out_cap, device=dev) < total
