"""Measure formulations of the patch gather on the GPU (counterpart of the
reference's ``tools/gather_experiments.py``).

    python -m vloam_tpu_torch.tools.gather_experiments [--src DIR]

At the ``kitti_hdl64`` shapes (two 376x1248 f32 images, 1024 corners per
image from ``default_rng(0)``, 32x32 patches; padded images 384x1408, 88
strips of 40 rows) it times, by CUDA events, and checks against its plain
PyTorch version (equality):

  A       the shipped two-image kernel ``gather_patches_pair``;
  B2      its single-image form (one image, 1024 corners: the ORB
          frontend's shape) and its stacked form (three images);
  G1-G5   strip and whole-image sweeps under different copy disciplines;
  G6-G11  other formulations of the gather (``ops/gather_variants``);
  C       the plain index gather.

One line per variant: the median ms of one call by CUDA events (at these
sizes mostly the launch path: an empty kernel times about the same), the
device ms per call when 20 calls are captured in one CUDA graph and replayed
(no Python and no launch path in it: the number to compare formulations by),
GB/s of the device time for the sweeps (what they stream: all repeats after
the first find the 4.3 MB of images in the L2 cache, so this is an L2 rate,
not an HBM rate), the plain version's ms, the ms of the one PyTorch call
that computes the same function where there is one (``library``: ``amax``
over an ``unfold`` or ``expand`` view for G1, G2 and G5, one index call on an
``unfold`` view for the exact gathers, and for G7 and G8 at their windows'
origins, computed before the timed call), ``correct=``; then what the
gathers must move on these inputs (``needed_bytes``, ``patch_bytes``: every
image float some window reads, once, beside the corners or meta and the
output; the bound of every gather row counts these bytes), G5's and G3's
(G4's) launches (blocks a cluster, clusters resident at once), the host
microseconds of the steps of one G1-G5 call (G3's and G4's tensor map
encoding among them) beside one ``amax`` call's, the four exact gathers,
B2's single-image and stacked forms, G7, G8 and the plain version on inputs
made to break them (``CASES``; G8 on each case's whole blocks of 32), B2's
two forms, G7 and G8 on images full of NaN, -0.0, subnormals and
infinities (``special_case``), the five sweeps on negative
images with planted maxima (``sweep_case``) and with a NaN (``nan_case``), G5
with its maximum at each end of what each block reads
(``whole_image_case``), the device kernels one call of B2's three forms,
G1-G5 and G7-G11 runs (torch.profiler), and the card's name and power
limit.  It needs a GPU and
exits nonzero without one.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

RUNS = 20
PEAK_BW = 3.35e12   # bytes/s: the HBM3 bandwidth of one H100 SXM (NVIDIA's data sheet)
LABELS = {
    "patches_single": "B2 single-image form (1 img, ORB)",
    "patches_stack": "B2 stacked form (3 images)",
    "strip_sweep": "G1 strip sweep, synchronous staging",
    "strip_sweep_db": "G2 strip sweep, two-slot TMA ring",
    "strip_sweep_batched": "G3 batched sweep, TMA from a 3-D map",
    "strip_sweep_flat": "G4 batched sweep, TMA from a 2-D map",
    "whole_image": "G5 whole images x10, cluster a repeat",
    "gather_narrow": "G6 gather from the needed 128-B lines",
    "dma_only": "G7 transport only (raw corner)",
    "compact_only": "G8 compaction only (1 band/32 kp)",
    "gather_resident": "G9 gather from a resident strip",
    "gather_mma": "G10 gather, tensor-core column shift",
    "gather_resident_mma": "G11 resident strip + tensor cores",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, runs: int = RUNS) -> float:
    """Median milliseconds of fn() over ``runs`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls: int = 20, replays: int = 7) -> float:
    """Device milliseconds per call of fn(): ``calls`` calls captured into one
    CUDA graph, the median replay time divided by ``calls``."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, replays) / calls


def make_inputs(device):
    """The experiment's inputs, from NumPy's ``default_rng(0)`` in the order
    the reference tool draws them."""
    from vloam_tpu_torch.config import kitti_hdl64
    from vloam_tpu_torch.ops import gather_variants as gv

    vc = kitti_hdl64().visual
    H, W, N, P = vc.img_height, vc.img_width, vc.max_features, gv.P
    rng = np.random.default_rng(0)
    img_a = torch.tensor(rng.uniform(0, 255, (H, W)).astype(np.float32), device=device)
    img_b = torch.tensor(rng.uniform(0, 255, (H, W)).astype(np.float32), device=device)
    corners = torch.tensor(
        np.stack([rng.integers(0, W - P, N), rng.integers(0, H - P, N)], -1).astype(np.int32),
        device=device)
    imgs = torch.stack([gv.pad_img(img_a), gv.pad_img(img_b)])
    ids = torch.cat([torch.zeros(N, dtype=torch.int32, device=device),
                     torch.ones(N, dtype=torch.int32, device=device)])
    cxy = torch.cat([corners, corners])
    meta = torch.stack([ids, cxy[:, 0], cxy[:, 1]]).contiguous()
    return img_a, img_b, corners, imgs, meta


def window_view(imgs, P: int | None = None):
    """(..., H, W) -> (..., H-P+1, W-P+1, P, P): every (P, P) window, as a
    view (P: the tool's 32 unless given)."""
    from vloam_tpu_torch.ops import gather_variants as gv

    P = gv.P if P is None else P
    return imgs.unfold(-2, P, 1).unfold(-2, P, 1)


def run(device="cuda", runs: int = RUNS) -> list[dict]:
    """Time and check every variant; one dict per line of the report:
    name, label, ms (one call, CUDA events), device_ms (per call inside a
    replayed CUDA graph; None for the plain gather, which reads the device),
    plain_ms, library_ms and library_device_ms (the one PyTorch call that
    computes the same function, itself held equal to the plain version, timed
    both ways; None where there is none), nbytes (what the function must
    move: inputs once, outputs once; for a sweep the padded images and its
    few floats, though it reads 4.6x (G1-G4) or 10x (G5) those bytes; for a
    gather the image floats its windows read, ``patch_bytes`` or
    ``needed_bytes``),
    sweep_bytes (what a sweep reads, for its GB/s; None for the gathers),
    max_abs_err (kernel against plain), correct."""
    from vloam_tpu_torch.ops import gather_variants as gv
    from vloam_tpu_torch.ops import patch_gather

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("gather_experiments measures the GPU kernels: it needs a CUDA device")
    img_a, img_b, corners, imgs, meta = make_inputs(device)
    n_img, h_pad, w_pad = imgs.shape
    img2d = imgs.reshape(n_img * h_pad, w_pad)
    img_bytes = imgs.numel() * 4
    n_strips = n_img * gv.n_bases(h_pad)
    sweep_bytes = n_strips * gv.P8 * w_pad * 4
    rows = []

    def add(name, label, kernel, plain, nbytes, swept=None, library=None):
        tup = lambda v: v if isinstance(v, tuple) else (v,)  # noqa: E731
        got, want = tup(kernel()), tup(plain())
        torch.cuda.synchronize()
        if library is not None and not torch.equal(library().reshape(want[0].shape), want[0]):
            raise AssertionError(f"{name}: the library call differs from the plain version")
        rows.append({"name": name, "label": label, "ms": time_ms(kernel, runs),
                     "device_ms": None if kernel is plain else graph_ms(kernel),
                     "plain_ms": time_ms(plain, runs),
                     "library_ms": None if library is None else time_ms(library, runs),
                     "library_device_ms": None if library is None else graph_ms(library),
                     "nbytes": nbytes, "sweep_bytes": swept,
                     "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
                     "correct": all(torch.equal(g, w) for g, w in zip(got, want))})

    # the floats under both images' windows and both corner sets read once, both
    # patch stacks written once
    pair_bytes = 2 * patch_bytes(img_a.shape, corners)
    pair = lambda: patch_gather.gather_patches_pair(img_a, img_b, corners, corners, gv.P)  # noqa: E731
    plain_pair = lambda: patch_gather.gather_patches_pair_reference(  # noqa: E731
        img_a, img_b, corners, corners, gv.P)
    add("gather_patches_pair", "A shipped two-image kernel", pair, plain_pair, pair_bytes)
    # the single-image and stacked forms: the floats under the windows and the
    # corners read once, the patches written once; the library call is one index
    # call on the view of all windows
    stack = torch.stack([img_a, img_b, 0.5 * (img_a + img_b)])
    cx, cy = corners[:, 0], corners[:, 1]
    for name, x, fn, plain, view in (
            ("patches_single", img_a, patch_gather.gather_patches,
             patch_gather.gather_patches_reference, lambda w: w[cy, cx]),
            ("patches_stack", stack, patch_gather.gather_patches_stack,
             patch_gather.gather_patches_stack_reference, lambda w: w[:, cy, cx])):
        windows = window_view(x)
        add(name, LABELS[name], lambda f=fn, x=x: f(x, corners), lambda f=plain, x=x: f(x, corners),
            patch_bytes(img_a.shape, corners, x.numel() // img_a.numel()),
            library=lambda v=view, w=windows: v(w))

    for name, args in (("strip_sweep", (imgs,)), ("strip_sweep_db", (imgs,)),
                       ("strip_sweep_batched", (imgs,)), ("strip_sweep_flat", (img2d, n_img))):
        kernel, plain = getattr(gv, name), getattr(gv, name + "_reference")
        n_out = n_strips // (1 if name in ("strip_sweep", "strip_sweep_db") else gv.BATCH)
        # G1, G2: one amax over the strips' view.  G3, G4: a maximum per strip and
        # then a sum per eleven strips are two reductions, so no one call.
        library = (lambda: imgs.unfold(1, gv.P8, 8).amax(dim=(2, 3))) if n_out == n_strips else None
        add(name, LABELS[name], lambda k=kernel, a=args: k(*a), lambda p=plain, a=args: p(*a),
            img_bytes + 4 * n_out, sweep_bytes, library)
    add("whole_image", LABELS["whole_image"], lambda: gv.whole_image(img2d),
        lambda: gv.whole_image_reference(img2d), img_bytes + 4 * gv.REPS,
        gv.REPS * img_bytes, lambda: img2d.expand(gv.REPS, -1, -1).amax(dim=(1, 2)))

    # every image float one of the windows reads, once, with meta and the patches
    # (needed_bytes): G6 and G9-G11 at the keypoints' own corners (the padding
    # serves the band arithmetic, no window reads it), G7 and G8 at theirs
    windows = window_view(imgs)
    for name in ("gather_narrow", "dma_only", "compact_only", "gather_resident", "gather_mma",
                 "gather_resident_mma"):
        kernel, plain = getattr(gv, name), getattr(gv, name + "_reference")
        # one index call on the view of all windows, at the origins of each
        # keypoint's window (for G7 and G8 computed here, outside the timed call)
        origins = library_origins(name, meta)
        add(name, LABELS[name], lambda k=kernel: k(imgs, meta), lambda p=plain: p(imgs, meta),
            needed_bytes(name, imgs, meta), library=lambda o=origins: windows[o])

    add("plain_gather", "C plain PyTorch index gather", plain_pair, plain_pair, pair_bytes)
    return rows


CASES = ("one_bucket", "alignments", "magnitudes", "sparse")
EXACT = ("gather_narrow", "gather_resident", "gather_mma", "gather_resident_mma")
TRANSPORT = ("dma_only", "compact_only")   # G7, G8: defined on the padded array


def library_origins(name, meta):
    """(ids, rows, cols) on meta's device, the origins of the windows
    ``name`` writes: the keypoints' own corners for the exact gathers, G7's
    and G8's from their plain versions' index arithmetic."""
    from vloam_tpu_torch.ops import gather_variants as gv

    if name in TRANSPORT:
        return getattr(gv, name + "_origins")(meta)
    return meta[0], meta[2], meta[1]


def host_origins(name, meta) -> tuple:
    """(ids, rows, cols) int64 NumPy arrays of the windows ``name`` writes,
    from meta (3, N) on the host: the keypoint's own corner (the exact
    gathers), the raw corner (cy - cy % 8, cx - cx % 128) of its band (G7),
    or the band of its block's first keypoint at its own (cy % 8, cx % 128)
    (G8, whose N is a multiple of 32)."""
    from vloam_tpu_torch.ops.gather_variants import BLOCK_KP

    ids, cx, cy = meta.cpu().numpy().astype(np.int64)
    if name == "dma_only":
        return ids, cy - cy % 8, cx - cx % 128
    if name == "compact_only":
        b0, cx0, cy0 = (np.repeat(v[::BLOCK_KP], BLOCK_KP) for v in (ids, cx, cy))
        return b0, cy0 - cy0 % 8 + cy % 8, cx0 - cx0 % 128 + cx % 128
    return ids, cy, cx


def window_floats(shape, ids, rows, cols, P: int | None = None) -> int:
    """How many distinct floats of an (n_img, H, W) array the (P, P) windows
    (P: the tool's 32 unless given) at (ids, rows, cols) read: where windows
    overlap, or leave parts of the images unread, this is not their count
    times P * P."""
    from vloam_tpu_torch.ops import gather_variants as gv

    P = gv.P if P is None else P
    seen = np.zeros(tuple(shape), bool)
    for b, r, c in zip(ids, rows, cols):
        seen[b, r:r + P, c:c + P] = True
    return int(seen.sum())


def patch_bytes(shape, corners, n_img: int = 1, P: int | None = None) -> int:
    """What B2 must move for n_img images of ``shape`` (H, W) that share the
    (n, 2) int32 (x, y) corners: every image float under a (P, P) window (P:
    the tool's 32 unless given) read once (the same floats of every image),
    the corners read once, the (n_img, n, P, P) windows written once.  The
    pair form is two such single calls."""
    from vloam_tpu_torch.ops import gather_variants as gv

    P = gv.P if P is None else P
    cx, cy = corners.cpu().numpy().astype(np.int64).T
    floats = window_floats((1, *shape), np.zeros_like(cx), cy, cx, P)
    return 4 * (n_img * floats + corners.numel() + n_img * cx.size * P * P)


def needed_bytes(name, imgs, meta) -> int:
    """What gather ``name`` must move on these inputs: every float of the
    padded images that one of its windows reads (``host_origins``), counted
    once, then meta read once and the (N, 32, 32) windows written once.
    Windows overlap (G7's corners step by 8 rows and span 32; G8's windows of
    a block share a band; random corners cross) and leave floats unread, so
    this is less than their count times 4 KB, and less than the images."""
    from vloam_tpu_torch.ops.gather_variants import P

    ids, rows, cols = host_origins(name, meta)
    return 4 * (window_floats(imgs.shape, ids, rows, cols) + meta.numel() + ids.size * P * P)


def needed_line(imgs, meta) -> str:
    """What the exact gathers, G7 and G8 (on meta's whole blocks of 32) must
    move on these inputs, beside the padded images' size: the bytes their
    bounds count."""
    from vloam_tpu_torch.ops.gather_variants import BLOCK_KP

    whole = whole_blocks(meta)
    ids, cx, cy = meta.cpu().numpy().astype(np.int64)
    corners = len(set(zip(ids, cy - cy % 8, cx - cx % 128)))
    firsts = whole.cpu().numpy().astype(np.int64)[:, ::BLOCK_KP]
    bands = len(set(zip(firsts[0], firsts[2] - firsts[2] % 8, firsts[1] - firsts[1] % 128)))
    parts = []
    for name, m, what in (("exact (G6, G9-G11)", meta, f"{meta.shape[1]} corners"),
                          ("G7", meta, f"{corners} distinct corners"),
                          ("G8", whole, f"{bands} distinct bands of {whole.shape[1] // BLOCK_KP} "
                                        "blocks")):
        need = needed_bytes({"G7": "dma_only", "G8": "compact_only"}.get(name, "gather_narrow"),
                            imgs, m)
        read = need - m.numel() * 4 - m.shape[1] * 4096
        parts.append(f"{name} {need / 1e6:.3f} MB ({what}; {read / 1e6:.3f} MB of image floats "
                     f"read once, {m.numel() * 4} B of meta, {m.shape[1] * 4096 / 1e6:.3f} MB of "
                     "windows)")
    return (f"gather bytes needed: {'; '.join(parts)}; G7's distinct corners as whole 4 KB "
            f"boxes {corners * 4096 / 1e6:.3f} MB; the padded images {imgs.numel() * 4 / 1e6:.3f} "
            "MB")
SPARSE_N = 37   # keypoints of the sparse case: a multiple of neither 32 nor 512


def case_inputs(case: str, H: int, W: int, n: int, device="cpu"):
    """Inputs made to break the exact gathers, from NumPy's
    ``default_rng(1)``: (imgs, the two H x W images padded by ``pad_img``;
    meta (3, m) int32 of legal corners).

      one_bucket  n keypoints in one (image, 8-row band) bucket, so that G9
                  and G11 drain their keypoint lists more than once when n
                  exceeds them;
      alignments  every cx % 8 in 0..7 and cx % 128 in {0, 1, 96, 127}, each
                  at every cy % 8 in both images, max(1, n // 80) times, then
                  the 64 windows of each image that touch its right and bottom
                  edges, and three corners; shuffled;
      magnitudes  n random corners of images whose values are
                  sign * 10**U(-30, 30) of both signs, one in twenty +0.0
                  (-0.0 comes back as +0.0 from the tensor cores);
      sparse      37 keypoints (SPARSE_N, whatever n is), all in the first and
                  the last band of legal corners of each image, so that
                  almost every block of G9 and G11 finds an empty bucket
                  while its copy is in flight.
    """
    from vloam_tpu_torch.ops import gather_variants as gv

    P = gv.P
    rng = np.random.default_rng(1)
    if case == "magnitudes":
        mag = 10.0 ** rng.uniform(-30, 30, (2, H, W))
        vals = np.where(rng.random((2, H, W)) < 0.5, -mag, mag)
        raw = np.where(rng.random((2, H, W)) < 0.05, 0.0, vals).astype(np.float32)
    else:
        raw = rng.uniform(0, 255, (2, H, W)).astype(np.float32)
    if case == "one_bucket":
        band = int(rng.integers(0, (H - P) // 8 + 1))
        rows = 8 * band + rng.integers(0, min(8, H - P - 8 * band + 1), n)
        ids = np.full(n, int(rng.integers(0, 2)))
        cols = rng.integers(0, W - P + 1, n)
    elif case == "alignments":
        res = np.array([0, 1, 2, 3, 4, 5, 6, 7, 96, 127])
        ids, res, dy = (a.ravel() for a in np.meshgrid(
            [0, 1], res, np.arange(8), np.arange(max(1, n // 80)), indexing="ij")[:3])
        cols = 128 * rng.integers(0, (W - P - res) // 128 + 1) + res
        rows = 8 * rng.integers(0, (H - P - dy) // 8 + 1) + dy
        ex, ey = np.meshgrid(W - P - np.arange(8), H - P - np.arange(8), indexing="ij")
        edge_c = np.concatenate([ex.ravel(), [0, W - P, 0]])
        edge_r = np.concatenate([ey.ravel(), [0, 0, H - P]])
        ids = np.concatenate([ids, np.repeat([0, 1], edge_c.size)])
        cols = np.concatenate([cols, edge_c, edge_c])
        rows = np.concatenate([rows, edge_r, edge_r])
        order = rng.permutation(ids.size)
        ids, cols, rows = ids[order], cols[order], rows[order]
    elif case == "magnitudes":
        ids = rng.integers(0, 2, n)
        cols, rows = rng.integers(0, W - P + 1, n), rng.integers(0, H - P + 1, n)
    elif case == "sparse":
        last = (H - P) // 8   # the band of the lowest legal corner
        ids = rng.integers(0, 2, SPARSE_N)
        cols = rng.integers(0, W - P + 1, SPARSE_N)
        rows = np.where(rng.random(SPARSE_N) < 0.5, rng.integers(0, 8, SPARSE_N),
                        rng.integers(8 * last, H - P + 1, SPARSE_N))
    else:
        raise KeyError(case)
    imgs = torch.stack([gv.pad_img(torch.tensor(r, device=device)) for r in raw])
    meta = torch.tensor(np.stack([ids, cols, rows]).astype(np.int32), device=device)
    return imgs, meta


def host_windows(imgs, meta, name: str = "gather_narrow") -> np.ndarray:
    """The windows ``name`` writes, cut on the host with NumPy: the cases'
    expected output."""
    from vloam_tpu_torch.ops.gather_variants import P

    padded = imgs.cpu().numpy()
    ids, cy, cx = host_origins(name, meta)
    off = np.arange(P)
    return padded[ids[:, None, None], cy[:, None, None] + off[None, :, None],
                  cx[:, None, None] + off[None, None, :]]


SLICES = 16   # column slices of sweep_case's plants: G3's and G4's 16, four to each of G1's


def sweep_case(n_img: int = 2, h_pad: int = 384, w: int = 1408, device="cpu"):
    """Padded images made to break a strip sweep, from NumPy's
    ``default_rng(2)``: every value negative, U(-255, -1), and one planted
    value in (-1, 0) in each 8-row band of each image, all distinct, in a
    random row of the band and a random column of one of ``SLICES`` column
    slices.  A strip's maximum is the largest plant of its five bands, so it
    lies in a different 8-row chunk from strip to strip.  The bands that
    hold some strip's maximum take, in order (j = 0, 1, ...), slice (j % 4)
    * 4 + (j // 4) % 4: consecutive maxima fall in different quarters (G1's
    and G2's four slices), and 16 of them in each of G3's and G4's 16; every
    other band takes slice ``band % 16``.  A sweep whose accumulator starts
    at 0, or that combines the wrong partial maxima, gives another answer."""
    from vloam_tpu_torch.ops.gather_variants import P8, n_bases

    rng = np.random.default_rng(2)
    raw = rng.uniform(-255, -1, (n_img, h_pad, w))
    bands, q = h_pad // 8, w // SLICES
    plants = -rng.permutation(np.linspace(0.05, 0.95, n_img * bands)).reshape(n_img, bands)
    winners = sorted({(b, s + int(plants[b, s:s + P8 // 8].argmax()))
                      for b in range(n_img) for s in range(n_bases(h_pad))})
    slice_of = {band: (j % 4) * 4 + (j // 4) % 4 for j, band in enumerate(winners)}
    for b in range(n_img):
        for i in range(bands):
            col = slice_of.get((b, i), i % SLICES) * q + int(rng.integers(0, q))
            raw[b, 8 * i + int(rng.integers(0, 8)), col] = plants[b, i]
    return torch.tensor(raw.astype(np.float32), device=device)


SWEEPS = ("strip_sweep", "strip_sweep_db", "strip_sweep_batched", "strip_sweep_flat",
          "whole_image")
WHOLE_CTAS = 16   # blocks of G5's cluster, one cluster a repeat (kWholeCtas in gather_sweeps.cu)


def sweep_calls(imgs) -> dict:
    """Each sweep's kernel and plain version on the image stack ``imgs``."""
    from vloam_tpu_torch.ops import gather_variants as gv

    n_img = imgs.shape[0]
    img2d = imgs.reshape(-1, imgs.shape[2])
    args = {"strip_sweep_flat": (img2d, n_img), "whole_image": (img2d,)}
    return {name: (lambda f=getattr(gv, name), a=args.get(name, (imgs,)): f(*a),
                   lambda f=getattr(gv, name + "_reference"), a=args.get(name, (imgs,)): f(*a))
            for name in SWEEPS}


def host_strip_maxima(imgs) -> np.ndarray:
    """Every strip's maximum, computed on the host with NumPy."""
    from vloam_tpu_torch.ops.gather_variants import P8, n_bases

    x = imgs.cpu().numpy()
    return np.stack([x[:, 8 * s:8 * s + P8].max(axis=(1, 2))
                     for s in range(n_bases(x.shape[1]))], axis=1).reshape(-1)


def same(got, want) -> bool:
    """Equal shapes, NaN at the same places, every other value bit for bit
    (``torch.equal`` is False wherever both hold a NaN)."""
    if got.shape != want.shape:
        return False
    nan = torch.isnan(got)
    return torch.equal(nan, torch.isnan(want)) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def check_sweep_case(device="cuda", n_img: int = 2, h_pad: int = 384, w: int = 1408) -> tuple:
    """The five sweeps on ``sweep_case`` (at the tool's padded size by
    default): each kernel held with ``torch.equal`` to its plain version, and
    the plain strip maxima to the host's.  One (line, all equal)."""
    from vloam_tpu_torch.ops import gather_variants as gv

    imgs = sweep_case(n_img, h_pad, w, device)
    equal = {name: torch.equal(kernel(), plain())
             for name, (kernel, plain) in sweep_calls(imgs).items()}
    equal["plain maxima"] = np.array_equal(gv.strip_maxima(imgs).cpu().numpy(),
                                           host_strip_maxima(imgs))
    return (f"sweep case: {tuple(imgs.shape)} negative images, planted maxima, kernels equal to "
            "their plain versions: " + ", ".join(f"{k} {v}" for k, v in equal.items()),
            all(equal.values()))


def nan_case(n_img: int = 2, h_pad: int = 384, w: int = 1408, device="cpu"):
    """``sweep_case`` with one NaN: in the last image, row 3 of 8-row band
    min(5, last band), column 7 of G1's third column slice.  Returns (images,
    the strips that hold it as indices into the ``n_img * n_bases`` strip
    maxima)."""
    from vloam_tpu_torch.ops import gather_variants as gv

    imgs = sweep_case(n_img, h_pad, w, device)
    band = min(5, h_pad // 8 - 1)
    imgs[n_img - 1, 8 * band + 3, 2 * (w // 4) + 7] = float("nan")
    nb = gv.n_bases(h_pad)
    strips = [(n_img - 1) * nb + s for s in range(max(0, band - 4), min(band, nb - 1) + 1)]
    return imgs, strips


def check_nan_case(device="cuda", n_img: int = 2, h_pad: int = 384, w: int = 1408) -> tuple:
    """The five sweeps on ``nan_case``: each kernel held to its plain version
    with NaN-aware equality (``same``), and the plain strip maxima NaN exactly
    at the strips that hold the NaN.  One (line, all equal)."""
    from vloam_tpu_torch.ops import gather_variants as gv

    imgs, strips = nan_case(n_img, h_pad, w, device)
    equal = {name: same(kernel(), plain())
             for name, (kernel, plain) in sweep_calls(imgs).items()}
    nan_at = torch.isnan(gv.strip_maxima(imgs)).nonzero().flatten().tolist()
    equal["plain NaN strips"] = nan_at == strips
    return (f"NaN case: {tuple(imgs.shape)}, a NaN in strips {strips}, kernels equal to their "
            "plain versions (NaN where they hold NaN): "
            + ", ".join(f"{k} {v}" for k, v in equal.items()), all(equal.values()))


def whole_image_positions(n_floats: int) -> list[int]:
    """Where ``whole_image_case`` plants its maximum: the first and the last
    float each block of G5's cluster reads, found by walking every 16-byte
    unit (block q takes the units q * 256 + t, t < 256, then 256 *
    WHOLE_CTAS units further on, as ``whole_image_kernel`` does), and the
    array's two ends."""
    block = np.arange(n_floats // 4) % (256 * WHOLE_CTAS) // 256   # the reader of each unit
    ends = {0, n_floats - 1}
    for q in range(WHOLE_CTAS):
        units = np.flatnonzero(block == q)
        if units.size:
            ends |= {4 * int(units[0]), 4 * int(units[-1]) + 3}
    return sorted(ends)


def whole_image_case(n_img: int = 2, h_pad: int = 384, w: int = 1408, device="cpu"):
    """The (n_img * h_pad, w) array of ``sweep_case`` (every value negative),
    and the positions at which ``check_whole_image_case`` plants 0.5."""
    img2d = sweep_case(n_img, h_pad, w, device).reshape(-1, w)
    return img2d, whole_image_positions(img2d.numel())


def check_whole_image_case(device="cuda", n_img: int = 2, h_pad: int = 384,
                           w: int = 1408) -> tuple:
    """G5 with its maximum planted at each position of ``whole_image_case``,
    one call each: the kernel held with ``same`` to its plain version, which
    must give 0.5 for every repeat.  One (line, all equal)."""
    from vloam_tpu_torch.ops import gather_variants as gv

    img2d, positions = whole_image_case(n_img, h_pad, w, device)
    flat = img2d.view(-1)
    bad = []
    for pos in positions:
        old = flat[pos].clone()
        flat[pos] = 0.5
        want = gv.whole_image_reference(img2d)
        if not (same(gv.whole_image(img2d), want) and bool((want == 0.5).all())):
            bad.append(pos)
        flat[pos] = old
    return (f"G5 case: {tuple(img2d.shape)} negative, the maximum at {len(positions)} positions "
            f"(the first and last float each of the cluster's {WHOLE_CTAS} blocks reads, the "
            f"array's two ends), one call each: kernel equal to its plain version at "
            f"{len(positions) - len(bad)} of {len(positions)}" + (f", not at {bad}" if bad else ""),
            not bad)


def sweep_checks(device="cuda") -> list[tuple]:
    """The sweeps' three cases at the tool's size: (line, all equal) each."""
    return [check_sweep_case(device), check_nan_case(device), check_whole_image_case(device)]


def whole_blocks(meta):
    """meta's first keypoints, as many as fill whole blocks of 32 (G8's input)."""
    from vloam_tpu_torch.ops.gather_variants import BLOCK_KP

    return meta[:, :meta.shape[1] // BLOCK_KP * BLOCK_KP].contiguous()


def special_case(H: int, W: int, n: int, device="cpu"):
    """The magnitudes case with every fifth float of the images replaced, in
    turn, by NaN, -0.0, the smallest subnormal, +inf and -inf: values a
    transport must carry bit for bit."""
    imgs, meta = case_inputs("magnitudes", H, W, n, device)
    specials = torch.tensor([float("nan"), -0.0, 1e-45, float("inf"), -float("inf")],
                            device=device)
    flat = imgs.view(-1)
    at = torch.arange(0, flat.numel(), 5, device=device)
    flat[at] = specials[torch.arange(at.numel(), device=device) % specials.numel()]
    return imgs, meta


def b2_forms(imgs, meta, equal) -> dict:
    """B2's single-image form on each image at its own keypoints' corners,
    and its stacked form at every keypoint's corner in every image, each held
    with ``equal`` to the windows cut on the host."""
    from vloam_tpu_torch.ops import patch_gather

    device = imgs.device
    corners = meta[1:].T.contiguous()
    single = True
    for b in range(imgs.shape[0]):
        mine = meta[0] == b
        want = torch.tensor(host_windows(imgs, meta[:, mine]), device=device)
        single &= equal(patch_gather.gather_patches(imgs[b], corners[mine].contiguous()), want)
    want = torch.stack([torch.tensor(host_windows(imgs, torch.cat([torch.full_like(meta[:1], b),
                                                                   meta[1:]])), device=device)
                        for b in range(imgs.shape[0])])
    return {"B2 single": bool(single),
            "B2 stack": bool(equal(patch_gather.gather_patches_stack(imgs, corners), want))}


def check_cases(device="cuda", H: int = 376, W: int = 1248, n: int = 2048) -> list[tuple]:
    """The four exact gathers, B2's single-image and stacked forms, G7, G8
    and the exact gather's plain version on each of ``CASES`` (at the tool's
    image size by default; G8 on the case's whole blocks of 32), each held
    with ``torch.equal`` to the windows it must write, cut on the host; then
    B2's two forms, G7 and G8 on ``special_case``, held with ``same`` (the
    NaN masks, then every other value bit for bit).  One (line, all equal) a
    case."""
    from vloam_tpu_torch.ops import gather_variants as gv

    def host(imgs, meta, name):
        return torch.tensor(host_windows(imgs, meta, name), device=device)

    out = []
    for case in CASES:
        imgs, meta = case_inputs(case, H, W, n, device)
        want = host(imgs, meta, "gather_narrow")
        equal = {name: torch.equal(getattr(gv, name)(imgs, meta), want) for name in EXACT}
        equal["plain"] = torch.equal(gv.gather_reference(imgs, meta), want)
        equal.update(b2_forms(imgs, meta, torch.equal))
        equal["dma_only"] = torch.equal(gv.dma_only(imgs, meta), host(imgs, meta, "dma_only"))
        whole = whole_blocks(meta)
        equal["compact_only"] = torch.equal(gv.compact_only(imgs, whole),
                                            host(imgs, whole, "compact_only"))
        out.append((f"case {case}: {meta.shape[1]} keypoints ({whole.shape[1]} for G8), equal "
                    f"to the windows cut on the host: "
                    + ", ".join(f"{k} {v}" for k, v in equal.items()), all(equal.values())))
    imgs, meta = special_case(H, W, n, device)
    whole = whole_blocks(meta)
    equal = b2_forms(imgs, meta, same)
    equal["dma_only"] = same(gv.dma_only(imgs, meta), host(imgs, meta, "dma_only"))
    equal["compact_only"] = same(gv.compact_only(imgs, whole), host(imgs, whole, "compact_only"))
    out.append((f"case specials: {meta.shape[1]} keypoints on images of NaN, -0.0, 1e-45, +-inf "
                "and magnitudes 1e-30..1e30, equal bit for bit to the windows cut on the host: "
                + ", ".join(f"{k} {v}" for k, v in equal.items()), all(equal.values())))
    return out


def kernels_per_call(names=("patches_pair", "patches_single", "patches_stack", "strip_sweep",
                            "strip_sweep_db", "strip_sweep_batched", "strip_sweep_flat",
                            "whole_image", "dma_only", "compact_only", "gather_resident",
                            "gather_mma", "gather_resident_mma")) -> list[tuple]:
    """The device kernels one wrapper call runs on the tool's inputs, by
    torch.profiler: (line, names or None) a kernel.  B2's pair form takes the
    tool's two images and corners (``run``'s row A), its single-image and
    stacked forms the first image and the corners (``run``'s B2 rows).  Run
    it after every timing: once the profiler has run, launches cost more on
    the host."""
    from vloam_tpu_torch.ops import gather_variants as gv
    from vloam_tpu_torch.ops import patch_gather
    from vloam_tpu_torch.tools.gn_check import device_kernels

    img_a, img_b, corners, imgs, meta = make_inputs(torch.device("cuda"))
    stack = torch.stack([img_a, img_b, 0.5 * (img_a + img_b)])
    calls = {name: kernel for name, (kernel, _) in sweep_calls(imgs).items()}
    calls["patches_pair"] = lambda: patch_gather.gather_patches_pair(img_a, img_b, corners,
                                                                     corners, gv.P)
    calls["patches_single"] = lambda: patch_gather.gather_patches(img_a, corners)
    calls["patches_stack"] = lambda: patch_gather.gather_patches_stack(stack, corners)
    out = []
    for name in names:
        got = device_kernels(calls.get(name) or (lambda f=getattr(gv, name): f(imgs, meta)))
        kern = ("not measured (the profiler showed no device event)" if got is None else
                f"{len(got)} ({', '.join(sorted(set(g[:40] for g in got)))})")
        out.append((f"{name}: device kernels per wrapper call {kern}", got))
    return out


def cluster_line() -> str:
    """G5's and G3's launches on the tool's inputs (G4's is G3's), with the
    clusters of each that the card holds at once
    (cudaOccupancyMaxActiveClusters): G3 needs all its clusters at once to
    run in one wave."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.ops import gather_variants as gv

    _, _, _, imgs, _ = make_inputs(torch.device("cuda"))
    n_img, h_pad, w = imgs.shape
    groups = n_img * gv.n_bases(h_pad) // gv.BATCH
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    whole = kernels.entry("vloam_whole_image_clusters")()
    batched = kernels.entry("vloam_sweep_batched_clusters")(w)
    return (f"G5 launch: a cluster of {WHOLE_CTAS} blocks a repeat x {gv.REPS} repeats = "
            f"{WHOLE_CTAS * gv.REPS} blocks on {sms} SMs; clusters resident at once: "
            f"{whole} (cudaOccupancyMaxActiveClusters).  G3/G4 launch: a cluster of "
            f"{gv.GROUP_CTAS} blocks a group x {groups} groups = {gv.GROUP_CTAS * groups} blocks "
            f"of {gv.batched_smem(w)} B of slots; clusters resident at once: {batched} "
            f"(needs {groups})")


def host_steps(calls: int = 1000) -> list[str]:
    """The host microseconds of each step of one G1, G2, G3, G4 and G5 call
    on the tool's inputs (the wrapper's checks, the output's allocation, the
    stream handle, for G3 and G4 the tensor map's encoding alone, the ctypes
    call with the encoding and the launch inside it), of the whole wrapper
    and of the one ``amax`` call that computes the same function (G1, G2,
    G5); and of the ctypes call of G6, a launch without a cluster: one line
    each, the mean over ``calls`` calls by ``time.perf_counter_ns``."""
    import time

    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.ops import gather_variants as gv

    _, _, _, imgs, meta = make_inputs(torch.device("cuda"))
    n_img, h_pad, w = imgs.shape
    img2d = imgs.reshape(-1, w)
    dev, strips, n = imgs.device, n_img * gv.n_bases(h_pad), img2d.numel()
    out = torch.empty((strips,), dtype=torch.float32, device=dev)
    out5 = torch.empty((gv.REPS,), dtype=torch.float32, device=dev)
    patches = torch.empty((meta.shape[1], gv.P, gv.P), dtype=torch.float32, device=dev)
    stream = kernels.stream_ptr(dev)

    def sweep_steps(name, entry, x=imgs, args=(imgs,), flat=None):
        """flat: None for G1 and G2; 0 (G3) or 1 (G4), whose tensor map is
        encoded inside the ctypes call and timed alone as a step too."""
        fn, n_out = kernels.entry(entry), strips if flat is None else strips // gv.BATCH
        check = ((lambda: gv._check_imgs(name, x, x.dim())) if flat is None else
                 (lambda: (gv._check_imgs(name, x, x.dim()), gv._check_box(name, w))))
        steps = {"checks": check, "allocation": lambda: x.new_empty(n_out),
                 "stream": lambda: kernels.stream_ptr(dev)}
        if flat is not None:
            encode = kernels.entry("vloam_sweep_batched_encode")
            steps["tensor map"] = lambda: encode(x.data_ptr(), n_img, h_pad, w, flat)
        steps["ctypes call and launch"] = lambda: fn(x.data_ptr(), n_img, h_pad, w,
                                                     out.data_ptr(), stream)
        steps["whole wrapper"] = lambda: getattr(gv, name)(*args)
        if flat is None:
            steps["library call (amax)"] = lambda: imgs.unfold(1, gv.P8, 8).amax(dim=(2, 3))
        return steps

    whole, narrow = kernels.entry("vloam_whole_image"), kernels.entry("vloam_gather_narrow")
    groups = {
        "G1": sweep_steps("strip_sweep", "vloam_sweep_sync"),
        "G2": sweep_steps("strip_sweep_db", "vloam_sweep_tma_ring"),
        "G3": sweep_steps("strip_sweep_batched", "vloam_sweep_batched", flat=0),
        "G4": sweep_steps("strip_sweep_flat", "vloam_sweep_batched_flat", img2d, (img2d, n_img),
                          flat=1),
        "G5": {
            "checks": lambda: gv._check_imgs("whole_image", img2d, 2),
            "allocation": lambda: img2d.new_empty(gv.REPS),
            "stream": lambda: kernels.stream_ptr(dev),
            "ctypes call and launch": lambda: whole(img2d.data_ptr(), n, gv.REPS, out5.data_ptr(),
                                                    stream),
            "whole wrapper": lambda: gv.whole_image(img2d),
            "library call (amax)": lambda: img2d.expand(gv.REPS, -1, -1).amax(dim=(1, 2)),
        },
        "G6": {
            "ctypes call and launch, no cluster": lambda: narrow(
                imgs.data_ptr(), n_img, h_pad, w, meta.data_ptr(), meta.shape[1],
                patches.data_ptr(), stream),
        },
    }
    lines = []
    for label, steps in groups.items():
        for name, step in steps.items():
            step()
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(calls):
                step()
            us = (time.perf_counter_ns() - t0) / calls / 1e3
            torch.cuda.synchronize()
            lines.append(f"{label} host step {name}: {us:.2f} us a call (mean of {calls})")
    return lines


def report(rows, card: str) -> list[str]:
    lines = []
    for r in rows:
        line = f"{r['label']:<40}: {r['ms']:8.4f} ms"
        if r["device_ms"] is not None:
            bound = r["nbytes"] / PEAK_BW * 1e3
            line += (f", on the device {r['device_ms']:.5f} ms (bound {bound:.5f} ms, "
                     f"{bound / r['device_ms']:.1%} of it)")
        if r["sweep_bytes"] is not None:
            line += (f" ({r['sweep_bytes'] / 1e6:.1f} MB, "
                     f"{r['sweep_bytes'] / 1e6 / r['device_ms']:.0f} GB/s, L2 after the first pass)")
        if r["name"] not in ("gather_patches_pair", "plain_gather"):
            line += f"  plain {r['plain_ms']:.4f} ms"
        if r["library_ms"] is not None:
            line += (f"  library {r['library_ms']:.4f} ms, on the device "
                     f"{r['library_device_ms']:.4f} ms"
                     + (" (one index call at its windows' origins)" if r["name"] in TRANSPORT
                        else ""))
        lines.append(line + f"  correct={r['correct']}")
    lines.append(card)
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", help="build the kernels from this copy of csrc/ instead "
                        "(to time an edited copy beside the tree in one call)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    if args.src:
        from vloam_tpu_torch import kernels

        kernels.SRC_DIR = Path(args.src).resolve()
    card = card_line()
    rows = run("cuda")
    _, _, _, imgs, meta = make_inputs(torch.device("cuda"))
    steps = [needed_line(imgs, meta), cluster_line()] + host_steps()
    cases = check_cases() + sweep_checks()
    counts = kernels_per_call()
    print("\n".join(report(rows, card)[:-1] + steps + [line for line, _ in cases + counts]
                    + [card]))
    ok = all(r["correct"] for r in rows) and all(good for _, good in cases)
    return 0 if ok and all(got is not None and len(got) == 1 for _, got in counts) else 1


if __name__ == "__main__":
    sys.exit(main())
