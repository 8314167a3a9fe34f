"""On a CUDA card: the driver's step replayed from CUDA graphs
(``models/graph_step``) against its eager step, on the first 40 frames of
the benchmark's ``street1`` drive at the KITTI configurations of the three
cells (KLT, ORB, SIFT), in deterministic mode (float atomics reorder sums
from run to run otherwise, ROADMAP C-b):

* every frame's outputs equal the eager driver's bit for bit, and so does
  the state after the drive;
* a steady frame synchronises 3 times (MO's two decisions and the fetch);
* ``graph_step`` opens on every frame from the first steady one (frame 2);
* VO's device span (``dev.visual_odometry``) is read on every frame, within
  the frame: no synchronisation is added for it;
* an output a caller keeps is unchanged after the next frame;
* ``restore_checkpoint`` into the driver, then the frames again, equals the
  uninterrupted run;

and a ``--trace 1`` run of each cell prints every per-layer metric of the
cell, with ``knn_pair_roofline``, the four layer spans and
``graph_step_pct`` where the cell reports them, ``vo_device_ms`` in every
cell and ``sift_gather_roofline`` (0-100 %) in the SIFT cell.

``device_span`` off the card (a CPU device) is a no-op, tested here too.

The card tests are skipped without a card.  This file imports no JAX; on the
card run it without the suite's conftest:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graph_card.py -q -s``.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
# deterministic cuBLAS (read when its first handle is made)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
N_FRAMES = 40
CELLS = {"kitti_hdl64_klt": "klt.street1", "kitti_hdl64_orb": "orb.street1",
         "kitti_hdl64_sift": "sift.street1"}
SEED = 2**31 + 2203


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda:0")


def street_frames(config, card):
    """The configuration as the cell runs it and the first frames of its drive."""
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from vbench import spec, traffic
    from vloam_tpu_torch import config as port_config
    from vloam_tpu_torch.models import frame_graph as fg
    cell = spec.load_cell(ROOT, CELLS[config])
    cfg = spec.build_config(port_config, cell.config["vloam"])
    K = fg.kitti_default_extrinsics("cpu").P_rect0[:, :3].numpy().astype(np.float64)
    frames, _ = traffic.make_drive(cell.traffic, cfg.visual.img_height, cfg.visual.img_width,
                                   K, SEED, 0, card, n_frames=N_FRAMES)
    return cfg, frames


def outputs(out):
    return {k: v.clone() for k, v in out._asdict().items()}


@pytest.mark.parametrize("config", sorted(CELLS))
def test_graph_step_equals_eager_step_on_the_card(config, card):
    from vloam_tpu_torch.models import frame_graph as fg
    from vloam_tpu_torch.runtime.driver import VloamDriver
    from vloam_tpu_torch.utils.checkpoint import tree_leaves
    sys.path.insert(0, BENCH)
    from vbench.syncs import SyncCounter

    cfg, frames = street_frames(config, card)
    ext = fg.kitti_default_extrinsics(card)
    torch.use_deterministic_algorithms(True)
    try:
        eager = VloamDriver(cfg, ext, device=card)
        assert eager._graph is not None
        eager._graph = None      # the eager step
        want, want_syncs = [], None
        for i, f in enumerate(frames):
            with SyncCounter() if i == 30 else contextlib.nullcontext() as sc:
                want.append(outputs(eager.process(*f)))
            want_syncs = sc if i == 30 else want_syncs

        with tempfile.TemporaryDirectory() as ckpt:
            drv = VloamDriver(cfg, ext, device=card, checkpoint_dir=ckpt, checkpoint_every=20)
            got, kept_ok, syncs = [], True, None
            for i, f in enumerate(frames):
                with SyncCounter() if i == 30 else contextlib.nullcontext() as sc:
                    out = drv.process(*f)
                syncs = sc if i == 30 else syncs
                if got:   # the last frame's outputs, after this frame
                    kept, given = got[-1]
                    kept_ok &= all(torch.equal(v, getattr(given, k)) for k, v in kept.items())
                got.append((outputs(out), out))
            replayed = drv.timer.count["graph_step"]
            vo_device = drv.timer.count["dev.visual_odometry"]
            vo_device_pending = len(drv.timer.pending)
            for a, b in zip(tree_leaves(drv.state), tree_leaves(eager.state)):
                assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            # again from the checkpoint of frame 20, into the driver and its graphs
            assert drv.restore_checkpoint(os.path.join(ckpt, "ckpt_000020")) == 20
            again = [outputs(drv.process(*f)) for f in frames[20:]]
    finally:
        torch.use_deterministic_algorithms(False)

    bad = [(i, k) for i, ((g, _), w) in enumerate(zip(got, want)) for k in w
           if not torch.equal(g[k], w[k])]
    gap = max(float((g[k].double() - w[k].double()).abs().max())
              for (g, _), w in zip(got, want) for k in w)
    print(f"{config}: {len(got)} frames, {replayed} replayed; outputs unequal at {bad[:6]} "
          f"(largest gap {gap:.3g}); frame 30 syncs: graph {syncs.count} {syncs.sites}, "
          f"eager {want_syncs.count} {want_syncs.sites}; VO on the card "
          f"{drv.timer.total_ms['dev.visual_odometry'] / max(vo_device, 1):.3f} ms a frame")
    assert not bad
    assert replayed == N_FRAMES - 2
    assert vo_device == N_FRAMES and vo_device_pending == 0
    assert syncs.count == 3 and want_syncs.count == 3
    assert kept_ok
    assert all(torch.equal(a[k], w[k]) for a, w in zip(again, want[20:]) for k in w)


@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_traced_run_reads_every_metric(cell, card):
    """A ``--trace 1`` run of the cell: ``correct``, and every per-layer
    metric of the cell in its result line, the k-NN roofline, the four
    layer spans and ``graph_step_pct`` among them."""
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                           "--seed", str(SEED + 7), "--seconds", "20", "--trace", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    print(proc.stderr[-3000:])
    assert proc.returncode == 0
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    want = {m["name"] for m in bench["per_layer"] if cell in m.get("workloads", [cell])}
    got = result["metrics"]
    print(cell, json.dumps(got))
    assert result["correct"] and want <= set(got)
    for name in ("knn_pair_roofline", "visual_odometry_ms", "scan_registration_ms",
                 "laser_odometry_ms", "laser_mapping_ms", "vo_device_ms"):
        if name in want:
            assert got[name]["value"] > 0
    assert "vo_device_ms" in want
    if "graph_step_pct" in want:
        assert got["graph_step_pct"]["value"] >= 95.0
    if "sift_gather_roofline" in want:
        assert 0.0 < got["sift_gather_roofline"]["value"] <= 100.0


def test_device_span_is_a_no_op_off_the_card():
    """``device_span`` on a CPU device records nothing and opens no stage or
    span of its own, inside a stage or outside one."""
    from vloam_tpu_torch.utils.profiling import StageTimer, device_span, span
    timer = StageTimer()
    with timer.stage("vloam_step"):
        with span("visual_odometry"), device_span("visual_odometry", "cpu"):
            x = torch.ones(8).sum()
        with device_span("visual_odometry", torch.device("cpu")):
            x = x + 1
    with device_span("visual_odometry", "cpu"):
        x = x + 1
    assert float(x) == 10.0
    assert set(timer.count) == {"vloam_step", "visual_odometry"}
    assert set(timer.parent) == {"vloam_step", "visual_odometry"}
    assert not timer.pending
    assert [name for name, _, _ in timer.timeline] == ["visual_odometry", "vloam_step"]
