"""The driver's frame step, replayed from CUDA graphs.

Eagerly, the frame step dispatches ~3200-4100 small PyTorch ops and kernel
launches from Python a frame, and the card waits on them.  ``GraphStep``
owns the captured step of one ``runtime/driver.VloamDriver``:

* the state: the driver's ``VloamState``, whose tensors keep their
  addresses: each segment of ``models/vloam.run_step`` writes its layer's
  new state into them;
* the uploads: one device buffer each (the image, the ring grid and its
  mask, the depth buckets, the less-flat table and its run count, which
  reaches the step as a tensor), each filled from a pinned host buffer by
  one copy;
* the segments' buffers and graphs, in one memory pool
  (``models/segments.SegmentRunner``).

Once the step is steady (VO past its second frame, LO initialised) a frame
replays its segments, each of MO's host decisions picking its branch's
graph, captured the first time the branch is taken; the ``knn_pair`` calls
run eagerly between them.  Earlier frames run the same segments eagerly
through the same buffers, and so does every frame on a CPU device.  The
``graph_step`` span opens around each frame that replays.  The outputs a
frame returns are copies, which the next frame leaves alone.

``engages`` is the driver's rule: a CUDA device, and a step whose only
host decisions are MO's two (``wait.submap_moved``, ``wait.map_ready``).
With ``OdometryConfig.distortion`` LO solves by the generic GN, and with
``MappingConfig.insert_dedup`` off MO decides more on the host: the driver
runs those steps eagerly.  Its step is pre-gridded and maps with
``mapping_step`` by construction.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from vloam_tpu_torch.config import VloamConfig
from vloam_tpu_torch.models import frame_graph as fg
from vloam_tpu_torch.models.segments import SegmentRunner
from vloam_tpu_torch.models.vloam import VloamOutputs, VloamState, run_step
from vloam_tpu_torch.utils.checkpoint import tree_leaves, tree_unflatten
from vloam_tpu_torch.utils.profiling import span

# the float (7,) fields of VloamOutputs, returned as views of one copy
POSE_FIELDS = tuple(f for f in VloamOutputs._fields if f != "lo_corr")


def engages(cfg: VloamConfig, device) -> bool:
    """Whether the driver replays its step from CUDA graphs."""
    return (torch.device(device).type == "cuda" and not cfg.odom.distortion
            and cfg.mapping.insert_dedup)


def steady(state: VloamState) -> bool:
    """From this state on every frame runs the same segments, up to MO's
    two decisions."""
    return state.vo.count >= 2 and state.lo.initialized


class GraphStep:
    def __init__(self, cfg: VloamConfig, ext: fg.Extrinsics, state: VloamState, device):
        self.cfg, self.ext, self.device = cfg, ext, torch.device(device)
        self.state = state
        self.capture = self.device.type == "cuda"
        self.runner = SegmentRunner(self.device)
        self.runner.register(state, ext)
        self._uploads: dict[str, tuple] = {}    # name -> (host buffer, device buffer)
        self._done = None   # event after the last frame's step: its uploads have been read

    def upload(self, name: str, array) -> torch.Tensor:
        """``array`` in the device buffer ``name`` (made the first time),
        copied there through its pinned host buffer."""
        a = np.asarray(array)
        bufs = self._uploads.get(name)
        if bufs is None:
            dtype = torch.from_numpy(np.zeros(0, a.dtype)).dtype
            cuda = self.device.type == "cuda"
            host = torch.empty(a.shape, dtype=dtype, pin_memory=cuda)
            dev = torch.empty(a.shape, dtype=dtype, device=self.device)
            self.runner.register(dev)
            bufs = self._uploads[name] = (host, dev)
        host, dev = bufs
        if host.shape != a.shape:
            raise ValueError(f"upload {name}: {a.shape}, its buffer {tuple(host.shape)}")
        if self._done is not None and not self._done.query():
            self._done.synchronize()   # the last frame's copy out of the host buffer
        host.numpy()[...] = a
        dev.copy_(host, non_blocking=True)
        return dev

    def step(self, img, grid, gmask, buckets, lf_table):
        """One frame of the pre-gridded step on the uploads: returns (state,
        VloamOutputs), the outputs copies of the step's buffers."""
        self.runner.replay = self.capture and steady(self.state)
        with span("graph_step") if self.runner.replay else contextlib.nullcontext():
            self.state, out = run_step(self.state, img, grid, gmask, self.ext, self.cfg, True,
                                       buckets, lf_table, None, self.runner)
        packed = torch.cat([getattr(out, f) for f in POSE_FIELDS])
        out = VloamOutputs(lo_corr=out.lo_corr.clone(), **dict(zip(POSE_FIELDS, packed.split(7))))
        if self.device.type == "cuda":
            self._done = torch.cuda.Event()
            self._done.record()
        return self.state, out

    def load(self, state: VloamState) -> VloamState:
        """Take ``state`` (a restored checkpoint) into the step's tensors;
        its host values (the counters, the ``initialized`` flags) as they are."""
        leaves = []
        for buf, new in zip(tree_leaves(self.state), tree_leaves(state)):
            if isinstance(buf, torch.Tensor):
                buf.copy_(new)
                new = buf
            leaves.append(new)
        self.state = tree_unflatten(state, iter(leaves))
        return self.state

    def close(self) -> None:
        """Drop the graphs, the segments' buffers and the uploads."""
        self.runner.close()
        self._uploads.clear()
        self._done = None
