"""The frame step as segments (``models/segments``, ``models/vloam.run_step``)
and the driver's graph step (``models/graph_step``), on the CPU.

* ``GraphStep`` over a 12-frame drive with a cube crossing (MO's rebuild
  branch on a steady frame), KLT and ORB: its segments run through the
  runner's fixed buffers, and from the first steady frame on a CPU stand-in
  for each captured CUDA graph replays the segment on the inputs it was
  captured on (the runner's buffers, and copies it refills), as a graph
  does.  Every output and the state equal eager ``vloam_step``'s bit for
  bit; the outputs a caller keeps do not change under it; each variant is
  captured once, the branches when first taken.
* The engagement rule: a CUDA device, no distortion, the insert-dedup map;
  every other step, and the frames before the step is steady, stay eager.
* The constants that were uploaded a call and the less-flat run count as a
  tensor leave ``coord_to_slot``, the cache's window test and
  ``extract_features_from_grid`` bit-equal.
* No segment of the steady step reads the device from the host (what a
  capture refuses): a dispatch mode watches every op the stand-ins run.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch.data import stream, synthetic
from vloam_tpu_torch.models import frame_graph as tfg
from vloam_tpu_torch.models import graph_step, segments
from vloam_tpu_torch.models import laser_mapping as lm
from vloam_tpu_torch.models.vloam import frame_to_device, init_vloam_state, vloam_step
from vloam_tpu_torch.ops.depth_map import DepthBuckets
from vloam_tpu_torch.ops.scan_registration import extract_features_from_grid
from vloam_tpu_torch.runtime.driver import VloamDriver
from vloam_tpu_torch.utils.checkpoint import tree_leaves, tree_unflatten
from vloam_tpu_torch.utils.profiling import StageTimer

N_FRAMES = 12
N_AZIMUTH = 400
SC = dict(ring_cap=512, max_points=32768, less_flat_cap=4096)
# 10 m cubes: the drive, 0.8 m a frame, crosses the first cube face at frame 7; 17 x 17
# cubes wrap past the lidar's reach, so no two of a scan's cubes share a slot (whose
# coordinate the insert would then write in no fixed order)
MC = dict(grid_w=17, grid_h=17, grid_d=3, corner_cube_cap=1024, surf_cube_cap=2048,
          corner_stack_cap=1024, surf_stack_cap=2048, submap_corner_cap=2048,
          submap_surf_cap=4096, cube_size=10.0)


def small_cfg(**visual):
    cfg = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**SC),
                                        mapping=tconfig.MappingConfig(**MC))
    return cfg.replace(visual=dataclasses.replace(cfg.visual, max_features=256,
                                                  max_corners=256, **visual))


MODES = {"klt": {}, "orb": dict(optical_flow_match=False)}
SKIP = {"klt": 1, "orb": 1, "klt.skip2": 2}   # mapping every frame, or every other


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the small ops of these drives run ~15x slower
    when several workers' thread pools share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    cfg = small_cfg()
    return stream.gen_frames(cfg, tfg.kitti_default_extrinsics("cpu"), N_FRAMES,
                             n_azimuth=N_AZIMUTH)[0]


HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "unique", "unique_dim",
              "_unique2", "unique_consecutive", "equal", "is_nonzero", "allclose"}


class HostReads(TorchDispatchMode):
    """Records the ops that read the device from the host, take a shape
    from data or a tensor from host data: what a capture refuses.  The
    kernels' plain versions, which stand in for them on the CPU, may."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        index = args[1] if name.startswith("index") and len(args) > 1 else ()
        bool_index = isinstance(index, (list, tuple)) and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in index)
        # a host array made a tensor (a Python scalar is passed to a kernel as it is)
        host_array = name == "lift_fresh" and args[0].dim() > 0
        if (name in HOST_READS or bool_index or host_array) and not any(
                f.function.endswith("_reference") or f.function == "_slice_patches"
                for f in inspect.stack()):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


class _Replayed(segments._Graph):
    """A CPU stand-in for a captured graph: each replay runs the segment on
    the inputs it was captured on and writes the same buffers, its ops
    watched for host reads.  Capturing runs nothing, as on a card."""

    def __init__(self, runner, name, fn, args, static, copied, out):
        super().__init__(name, self, static, copied, None)
        self.runner, self.fn, self.args, self.out = runner, fn, args, out

    def replay(self):
        with HostReads() as watch:
            value = self.fn(*tree_unflatten(self.args, iter(self.static)))
            self.result = self.runner._store(self.name, value, self.out)
        assert not watch.seen, f"segment {self.name} reads the device: {watch.seen}"


def emulated_capture(captured):
    """``SegmentRunner._capture`` on the CPU: the real one's static inputs,
    a ``_Replayed`` for the graph."""
    def capture(self, name, fn, args, leaves, out):
        static, copied = [], []
        for i, x in enumerate(leaves):
            if isinstance(x, torch.Tensor) and not self._stable_input(x):
                x = x.clone()
                copied.append(i)
            static.append(x)
        captured.append(name)
        return _Replayed(self, name, fn, args, static, set(copied), out)
    return capture


def eager_drive(cfg, frames):
    ext = tfg.kitti_default_extrinsics("cpu")
    state, outs = init_vloam_state(cfg, "cpu"), []
    for f in frames:
        img, grid, gmask, bk, lf = frame_to_device(*f, "cpu")
        state, out = vloam_step(state, img, grid, gmask, ext, cfg, pre_gridded=True,
                                pre_buckets=bk, pre_lf_table=lf)
        outs.append(out)
    return state, outs


def uploads(gs, frame):
    """A host frame through the graph step's upload buffers, as the driver
    sends it: (img, grid, gmask, buckets, less-flat table)."""
    img, grid, gmask, bk, (sg, bs, nr) = frame
    up = gs.upload
    return (up("image", img), up("grid", grid), up("gmask", gmask),
            DepthBuckets(*(up(f"buckets.{j}", b) for j, b in enumerate(bk))),
            (up("lf_table.slots", sg), up("lf_table.sums", bs), up("lf_table.runs", np.int64(nr))))


def graph_drive(cfg, frames, monkeypatch):
    """The frames through a GraphStep whose runner replays (CPU stand-ins)
    once the step is steady, fed as the driver feeds it."""
    captured = []
    monkeypatch.setattr(segments.SegmentRunner, "_capture", emulated_capture(captured))
    ext = tfg.kitti_default_extrinsics("cpu")
    start = init_vloam_state(cfg, "cpu")
    gs = graph_step.GraphStep(cfg, ext, start, "cpu")
    gs.capture = True
    timer, outs, kept, replayed = StageTimer(), [], [], []
    for f in frames:
        with timer.stage("vloam_step"):
            n = timer.count["graph_step"]
            state, out = gs.step(*uploads(gs, f))
            replayed.append(timer.count["graph_step"] > n)
        outs.append(out)
        kept.append(tuple(t.clone() for t in out))
    return gs, start, state, outs, kept, replayed, captured


@pytest.mark.parametrize("mode", sorted(SKIP))
def test_graph_step_equals_eager_step(mode, frames, monkeypatch):
    cfg = small_cfg(**MODES[mode.split(".")[0]])
    cfg = cfg.replace(mapping=dataclasses.replace(cfg.mapping, skip_frame=SKIP[mode]))
    want_state, want = eager_drive(cfg, frames)
    gs, start, state, got, kept, replayed, captured = graph_drive(cfg, frames, monkeypatch)
    assert replayed == [False, False] + [True] * (N_FRAMES - 2)
    for i, (g, w) in enumerate(zip(got, want)):
        for name in w._fields:
            assert torch.equal(getattr(g, name), getattr(w, name)), (i, name)
    # the outputs a caller kept are those it was given
    for k, g in zip(kept, got):
        assert all(torch.equal(a, b) for a, b in zip(k, g))
    for a, b in zip(tree_leaves(state), tree_leaves(want_state)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    # the state lives where it started
    assert all(a is b for a, b in zip(tree_leaves(state), tree_leaves(start))
               if isinstance(a, torch.Tensor))
    # each variant captured once, the rebuild branch at the crossing (the rows
    # once more on a skipped frame's pose); the k-NN results are the only inputs
    # a graph copies in
    graphs = [g for gs_ in gs.runner.graphs.values() for g in gs_]
    assert len(captured) == len(graphs) and captured.count("laser_mapping.window") == 2
    assert captured.count("frame_graph.rows") == SKIP[mode]
    copied = {g.name for g in graphs if g.copied}
    assert copied == {"laser_odometry.iter0", "laser_odometry.iter1",
                      "laser_mapping.iter0", "laser_mapping.iter1"}


def test_engagement_rule():
    """Only a CUDA device with the insert-dedup map and no distortion
    replays; the driver on the CPU runs the eager step; the raw-cloud step
    and a mapping_fn never reach a runner; a frame replays only once the
    step is steady."""
    cfg = small_cfg()
    cuda = torch.device("cuda")
    assert graph_step.engages(cfg, cuda)
    assert not graph_step.engages(cfg, "cpu")
    assert not graph_step.engages(cfg.replace(odom=dataclasses.replace(cfg.odom, distortion=True)),
                                  cuda)
    assert not graph_step.engages(
        cfg.replace(mapping=dataclasses.replace(cfg.mapping, insert_dedup=False)), cuda)
    assert VloamDriver(cfg, tfg.kitti_default_extrinsics("cpu"), device="cpu")._graph is None

    state = init_vloam_state(cfg, "cpu")
    assert not graph_step.steady(state)
    assert not graph_step.steady(state._replace(vo=state.vo._replace(count=2)))
    assert not graph_step.steady(state._replace(lo=state.lo._replace(initialized=True)))
    assert graph_step.steady(state._replace(vo=state.vo._replace(count=2),
                                            lo=state.lo._replace(initialized=True)))
    gs = graph_step.GraphStep(cfg, tfg.kitti_default_extrinsics("cpu"), state, "cpu")
    assert not gs.capture


@pytest.mark.parametrize("path", ["raw_cloud", "mapping_fn"])
def test_other_steps_run_eagerly(path, frames, monkeypatch):
    """The raw-cloud step and a step with a mapping_fn call every segment
    through the plain runner."""
    cfg = small_cfg()
    monkeypatch.setattr(segments.SegmentRunner, "__call__",
                        lambda *a, **k: pytest.fail("a runner ran"))
    seen = []

    def fn(*args):
        seen.append(args[-2])
        return lm.mapping_step(*args)

    ext = tfg.kitti_default_extrinsics("cpu")
    img, grid, gmask, bk, lf = frame_to_device(*frames[0], "cpu")
    state = init_vloam_state(cfg, "cpu")
    if path == "raw_cloud":
        cloud = stream.gen_raw(cfg, ext, 1, n_azimuth=N_AZIMUTH)[0][0][1]
        cloud, mask = (torch.from_numpy(x) for x in synthetic.pad_cloud(cloud, SC["max_points"]))
        _, out = vloam_step(state, img, cloud, mask, ext, cfg, pre_gridded=False)
    else:
        _, out = vloam_step(state, img, grid, gmask, ext, cfg, pre_gridded=True,
                            pre_buckets=bk, pre_lf_table=lf, mapping_fn=fn)
        assert len(seen) == 1
    assert torch.isfinite(out.world_mo).all()


def test_hoisted_constants_and_run_count_are_bit_equal(frames):
    """``coord_to_slot`` and the cache's window test with the constants
    uploaded once equal the same arithmetic on fresh copies; the less-flat
    run count as a 0-d or (1,) tensor gives the features an int gives."""
    cfg = small_cfg()
    mc = cfg.mapping
    g = torch.Generator().manual_seed(0)
    coord = torch.randint(-40, 40, (5000, 3), generator=g)
    dims = torch.tensor([mc.grid_w, mc.grid_h, mc.grid_d])
    m = torch.remainder(coord, dims)
    want = m[..., 0] + mc.grid_w * m[..., 1] + mc.grid_w * mc.grid_h * m[..., 2]
    assert torch.equal(lm.coord_to_slot(coord, cfg), want)
    radii = lm.int_vector((mc.submap_rx, mc.submap_rx, mc.submap_rz), coord.device)
    assert radii is lm.int_vector((mc.submap_rx, mc.submap_rx, mc.submap_rz), coord.device)
    fresh = torch.tensor([mc.submap_rx, mc.submap_rx, mc.submap_rz])
    center = torch.tensor([1, -2, 0])
    assert radii.dtype == fresh.dtype and torch.equal(
        torch.all(torch.abs(coord - center) <= radii, dim=-1),
        torch.all(torch.abs(coord - center) <= fresh, dim=-1))

    _, grid, gmask, _, (sg, bs, nr) = frame_to_device(*frames[3], "cpu")
    want = extract_features_from_grid(grid, gmask, gmask.sum(dim=1), cfg.scan,
                                      lf_table=(sg, bs, int(nr)))
    for runs in (torch.tensor(int(nr)), torch.tensor([int(nr)])):
        got = extract_features_from_grid(grid, gmask, gmask.sum(dim=1), cfg.scan,
                                         lf_table=(sg, bs, runs))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
