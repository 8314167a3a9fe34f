"""Check and time the k-NN kernels on the GPU, away from the frame step.

    python -m vloam_tpu_torch.tools.knn_check

``cases`` builds, from a seed with NumPy, small problems made to break a
kernel that splits the candidates and merges: exact distance ties whose
indices lie in different splits, counts that end inside a tile and a split,
counts of 0, a fully masked candidate set, a block of queries far from every
candidate under a radius, one pruned problem on Morton-ordered and on
shuffled rows, and candidates read as a column slice of a wider buffer.
``check_case`` holds ``ops/fused_knn.knn_pair`` (and ``ops/knn.knn`` on each
problem without a radius) to the plain PyTorch version bit for bit, d2 and
idx.  The CPU tests run the same cases through the plain version; on a GPU
they go through the kernels.

``street`` builds the frame step's four call shapes on a synthetic street
(Morton-ordered where the mapping step orders its rows), and ``main`` prints
for each call the wrapper's ms by CUDA events, the device ms per call inside
a replayed CUDA graph, the tile steps skipped, and the card.  It needs a GPU
and exits nonzero without one.

    python -m vloam_tpu_torch.tools.knn_check --frame-step [N]

times instead the two ``knn_pair`` calls that frame N - 1 (default 16) of the
full step makes at ``kitti_hdl64`` on the synthetic course, as the tree it
runs in passes them.  This mode uses nothing an earlier tree of the package
lacks, so the same file, run from another checkout's root, measures that
tree's kernel on that tree's arguments: two versions on one card, one after
the other.
"""

from __future__ import annotations

import statistics
import sys
import time
from unittest import mock

import numpy as np
import torch

from vloam_tpu_torch.ops import fused_knn, knn
from vloam_tpu_torch.tools.gather_experiments import card_line, graph_ms, time_ms


def _line_cloud(rng, n, extent, noise):
    """Points along a box-shaped street, like a voxel-downsampled scene."""
    pts = rng.uniform(0, 1, (n, 1)) * np.asarray(extent, np.float32)
    return (pts + rng.normal(0, noise, (n, 3))).astype(np.float32)


def _sorted(pts, mask, cell):
    out, m = knn.morton_sort(torch.tensor(pts), torch.tensor(mask), cell)
    return out.numpy(), m.numpy()


def cases(seed: int = 0) -> list[dict]:
    """The problems, as dicts of ``knn_pair``'s arguments in NumPy:
    name, qa, ca, ma, ka, qb, cb, mb, kb, a_counts, b_counts, prune_radius."""
    rng = np.random.default_rng(seed)
    out = []

    def add(name, a, b, a_counts=(None, None), b_counts=(None, None), radius=(None, None)):
        (qa, ca, ma, ka), (qb, cb, mb, kb) = a, b
        out.append(dict(name=name, qa=qa, ca=ca, ma=ma, ka=ka, qb=qb, cb=cb, mb=mb, kb=kb,
                        a_counts=a_counts, b_counts=b_counts, prune_radius=radius))

    # exact ties: lattice candidates repeat all over the index range, so equal
    # distances meet in different splits and the lower index has to win
    def lattice(m, n, k):
        cand = rng.integers(-3, 4, (n, 3)).astype(np.float32)
        query = rng.integers(-3, 4, (m, 3)).astype(np.float32) + 0.5
        return query, cand, rng.random(n) < 0.9, k

    add("ties across splits", lattice(300, 4096, 8), lattice(700, 8192, 16))
    add("ties across splits, k=5", lattice(513, 2048, 5), lattice(256, 6000, 5))

    def cloud(m, n, k, p_mask=0.85):
        cand = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
        query = (cand[rng.integers(0, n, m)] + rng.normal(0, 0.5, (m, 3))).astype(np.float32)
        return query, cand, rng.random(n) < p_mask, k

    add("counts inside a tile and a split", cloud(512, 4096, 5), cloud(1000, 5000, 5),
        a_counts=(300, 1037), b_counts=(1000, 4999))
    add("counts of 0", cloud(256, 1024, 8), cloud(256, 1024, 16),
        a_counts=(0, 1024), b_counts=(256, 0))
    add("counts past the capacity", cloud(100, 700, 5), cloud(64, 64, 5),
        a_counts=(1000, 10**6), b_counts=(-3, 64))
    q, c, _, k = cloud(300, 2048, 5)
    add("all candidates masked", (q, c, np.zeros(2048, bool), k), cloud(128, 512, 5, p_mask=0.0))

    # a whole query tile far from every candidate, under a radius: +inf, never NaN
    qa = rng.uniform(-5, 5, (512, 3)).astype(np.float32)
    qa[256:] = rng.uniform(395, 405, (256, 3)).astype(np.float32)
    ca = rng.uniform(-6, 6, (2048, 3)).astype(np.float32)
    ones = np.ones(2048, bool)
    add("isolated query tile, radius 1", (qa, ca, ones, 5), (qa + 0.1, ca, ones, 5),
        radius=(1.0, 1.0))

    # one pruned problem on Morton-ordered rows and on the rows as drawn
    m, n, r = 1024, 8192, 1.001
    qs = _line_cloud(rng, m, (80, 4, 2), 1.0)
    cs = _line_cloud(rng, n, (80, 4, 2), 1.2)
    ms = rng.random(n) < 0.9
    add("pruned, rows as drawn", (qs, cs, ms, 5), (qs + 0.3, cs, ms, 5), radius=(r, r))
    cs_s, ms_s = _sorted(cs, ms, 2.0)
    qs_s, _ = _sorted(qs, np.ones(m, bool), 2.0)
    n_live = int(ms_s.sum())
    add("pruned, Morton order", (qs_s, cs_s, ms_s, 5), (qs_s + 0.3, cs_s, ms_s, 5),
        a_counts=(None, n_live), b_counts=(m - 100, n_live), radius=(r, r))
    add("one radius of two", (qs_s, cs_s, ms_s, 8), (qs_s + 0.3, cs_s, ms_s, 16),
        radius=(None, 0.5))
    return out


def to_torch(case: dict, device, wide: bool = False):
    """(args, kwargs) of ``knn_pair`` on ``device``.  ``wide``: candidates and
    queries become column slices of (N, 4) buffers, as the mapping step
    passes its submap."""
    def pts(x):
        t = torch.tensor(x, device=device)
        if wide:
            t = torch.cat([t, torch.full_like(t[:, :1], 7.0)], dim=1)[:, :3]
        return t

    def counts(cs):
        return tuple(None if v is None else torch.tensor(v, device=device) for v in cs)

    args = (pts(case["qa"]), pts(case["ca"]), torch.tensor(case["ma"], device=device), case["ka"],
            pts(case["qb"]), pts(case["cb"]), torch.tensor(case["mb"], device=device), case["kb"])
    return args, dict(a_counts=counts(case["a_counts"]), b_counts=counts(case["b_counts"]),
                      prune_radius=case["prune_radius"])


def assert_bit_equal(name, got, want):
    """(d2, idx) pairs equal bit for bit, and no NaN."""
    for g, w, what in ((got[0], want[0], "d2"), (got[1], want[1], "idx")):
        assert not bool(torch.isnan(g.to(torch.float32)).any()), f"{name}: NaN in {what}"
        if not torch.equal(g, w):
            bad = (g != w).nonzero()
            r, s = (int(v) for v in bad[0])
            raise AssertionError(
                f"{name}: {what} differs from the plain version in {bad.shape[0]} of {g.numel()} "
                f"slots, first at query {r} slot {s}: {g[r].tolist()} vs {w[r].tolist()}")


def check_case(case: dict, device) -> None:
    """``knn_pair`` on the case (as given and as column slices) and ``knn``
    on each of its problems, each bit-equal to the plain version."""
    name = case["name"]
    args, kw = to_torch(case, device)
    want = fused_knn.knn_pair_reference(*args, **kw)
    for wide in (False, True):
        w_args, _ = to_torch(case, device, wide=wide)
        got = fused_knn.knn_pair(*w_args, **kw)
        for grp in (0, 1):
            assert_bit_equal(f"{name} [{'ab'[grp]}{', strided' if wide else ''}]", got[grp],
                             want[grp])
    free = fused_knn.knn_pair_reference(*args, a_counts=kw["a_counts"], b_counts=kw["b_counts"])
    for grp, (q, c, m, k) in enumerate((args[:4], args[4:])):
        cnt = kw["a_counts" if grp == 0 else "b_counts"]
        got = knn.knn(q, c, m, k, cand_count=cnt[1], query_count=cnt[0])
        assert_bit_equal(f"{name} [knn {'ab'[grp]}]", got, free[grp])
        # the radius rule: the unpruned result wherever it lies inside, +inf / 0 elsewhere
        r = kw["prune_radius"][grp]
        if r is not None:
            inside = free[grp][0] <= knn.radius_sq(r)
            assert torch.equal(want[grp][0], torch.where(inside, free[grp][0], torch.inf))
            assert torch.equal(want[grp][1], torch.where(inside, free[grp][1], 0))


def street(device, seed: int = 0) -> dict:
    """The frame step's two calls at ``kitti_hdl64`` shapes on a synthetic
    street: {"LO": (args, kw), "MO": (args, kw)}.  LO's rows come as drawn
    (scan order has no spatial sort) and take no radius; MO's are
    Morton-ordered prefixes with the mapping step's radius."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.tensor(x, device=device)  # noqa: E731

    def lo_group(m, n, k):
        cand = _line_cloud(rng, n, (100, 30, 4), 2.0)
        query = (cand[rng.integers(0, n, m)] + rng.normal(0, 0.3, (m, 3))).astype(np.float32)
        return t(query), t(cand), t(rng.random(n) < 0.9), k

    def mo_group(m, live_m, n, live_n, k):
        cand = np.zeros((n, 3), np.float32)
        cand[:live_n] = _line_cloud(rng, live_n, (150, 150, 6), 3.0)
        mask = np.arange(n) < live_n
        query = np.zeros((m, 3), np.float32)
        query[:live_m] = cand[rng.integers(0, live_n, live_m)] + rng.normal(0, 0.3, (live_m, 3))
        cand, mask = _sorted(cand, mask, 4.0)
        query, _ = _sorted(query, np.arange(m) < live_m, 2.0)
        return (t(query), t(cand), t(mask), k), (t(np.int64(live_m)), t(np.int64(live_n)))

    (a, ac), (b, bc) = mo_group(4096, 1500, 16384, 9800, 5), mo_group(8192, 8000, 49152, 34800, 5)
    return {"LO": (lo_group(768, 7680, 8) + lo_group(1536, 32768, 16), {}),
            "MO": (a + b, dict(a_counts=ac, b_counts=bc, prune_radius=(1.001, 1.001)))}


def skipped_share(args, kw) -> tuple[float, list[int]]:
    """One more ``knn_pair`` call with the step counters on: (share of the
    (query tile, candidate tile) steps skipped, the four counters)."""
    stats = torch.zeros((4,), dtype=torch.int32, device=args[0].device)
    fused_knn.knn_pair(*args, **kw, stats=stats)
    s = [int(v) for v in stats.tolist()]
    steps = sum(s)
    return ((s[1] + s[3]) / steps if steps else 0.0), s


def frame_step_calls(device, n_frames: int = 16):
    """Drive ``vloam_step`` over ``n_frames`` of the synthetic course at
    ``kitti_hdl64``: ({"LO": (args, kw), "MO": (args, kw)}, the first
    ``knn_pair`` call of each stage on the last frame; ms per frame)."""
    from vloam_tpu_torch.config import kitti_hdl64
    from vloam_tpu_torch.data import stream
    from vloam_tpu_torch.models import frame_graph, laser_mapping, lidar_odometry
    from vloam_tpu_torch.models.vloam import frame_to_device, init_vloam_state, vloam_step

    cfg = kitti_hdl64()
    ext = frame_graph.kitti_default_extrinsics(device)
    frames, _ = stream.gen_frames(cfg, ext, n_frames, speed=0.8, yaw_rate=0.005)
    calls, frame_ms = {}, []
    real = fused_knn.knn_pair

    def recorder(site):
        def record(*args, **kw):
            calls.setdefault(site, (args, kw))
            return real(*args, **kw)
        return record

    state = init_vloam_state(cfg, device)
    for i, f in enumerate(frames):
        img, g, m, bk, lf = frame_to_device(*f, device)
        if i == n_frames - 1:
            calls.clear()
        t0 = time.perf_counter()
        with mock.patch.object(lidar_odometry, "knn_pair", recorder("LO")), \
                mock.patch.object(laser_mapping, "knn_pair", recorder("MO")):
            state, _ = vloam_step(state, img, g, m, ext, cfg, pre_gridded=True, pre_buckets=bk,
                                  pre_lf_table=lf)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    return calls, frame_ms


def main_frame_step(n_frames: int) -> int:
    dev = torch.device("cuda", 0)
    card = card_line()
    calls, frame_ms = frame_step_calls(dev, n_frames)
    for site, (args, kw) in calls.items():
        got = fused_knn.knn_pair(*args, **kw)
        want = fused_knn.knn_pair_reference(*args, **kw)
        for grp in (0, 1):
            assert_bit_equal(f"frame {n_frames - 1} {site} [{'ab'[grp]}]", got[grp], want[grp])
        call = lambda: fused_knn.knn_pair(*args, **kw)  # noqa: E731
        shapes = " + ".join(f"{q.shape[0]}x{c.shape[0]} k={k}" for q, c, k in
                            ((args[0], args[1], args[3]), (args[4], args[5], args[7])))
        print(f"frame {n_frames - 1} {site} pair ({shapes}; {sorted(kw)}): bit-equal to the plain "
              f"version; wrapper {time_ms(call):.4f} ms, device {graph_ms(call):.4f} ms a call "
              f"inside a replayed CUDA graph of 20 calls [{card}]")
    print(f"vloam_step ms/frame (host clock, synchronised), frames 5..{n_frames - 1}: median "
          f"{statistics.median(frame_ms[5:]):.3f}, min {min(frame_ms[5:]):.3f} [{card}]")
    print(card)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("knn_check: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 1
    if argv and argv[0] == "--frame-step":
        return main_frame_step(int(argv[1]) if len(argv) > 1 else 16)
    dev = torch.device("cuda", 0)
    card = card_line()
    for case in cases():
        check_case(case, dev)
        print(f"{case['name']}: knn_pair and knn bit-equal to the plain version")
    for site, (args, kw) in street(dev).items():
        got = fused_knn.knn_pair(*args, **kw)
        want = fused_knn.knn_pair_reference(*args, **kw)
        for grp in (0, 1):
            assert_bit_equal(f"street {site} [{'ab'[grp]}]", got[grp], want[grp])
        share, s = skipped_share(args, kw)
        call = lambda: fused_knn.knn_pair(*args, **kw)  # noqa: E731
        print(f"street {site} pair: bit-equal; wrapper {time_ms(call):.4f} ms, device "
              f"{graph_ms(call):.4f} ms a call inside a CUDA graph; tile steps swept/skipped "
              f"{s}, {share * 100:.1f} % skipped [{card}]")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
