"""The frame step's segments and the runners that call them.

``models/vloam.run_step`` cuts the frame step (with ``lidar_odometry.
lo_segments`` and ``laser_mapping.mapping_segments``) into segments:
functions of tensors that lie between the step's host decisions and its
k-NN calls (B1, ``knn_pair``, which always runs eagerly between two
segments).  Each segment is called through a runner,
``run(name, fn, *args, out=None)``:

* ``eager`` calls ``fn(*args)``: ``vloam_step``, ``lo_step`` and
  ``mapping_step`` run their segments so, for every caller;
* ``SegmentRunner`` calls them through fixed buffers and, on a card,
  replays each from a CUDA graph (``models/graph_step``).

``args`` are trees of tuples (NamedTuples included) whose leaves are
tensors or host values.  The host values (flags, counters clamped to what
the segment reads of them) pick the segment's variant: one variant runs
the same program on every call.  Everything else a segment reads (the
configuration, the extrinsics, cached constants) it takes from its closure,
and it is fixed for a runner's life.  ``out``, a tree shaped like the
result (or a prefix of it, None below), names the tensors the result's
leaves become: the step's state, which the segment writes at its end in
place of the value it read; leaves under None are kept in buffers of the
runner's own.  A segment reads its inputs before it writes its ``out``.
"""

from __future__ import annotations

import functools

import torch

from vloam_tpu_torch.utils.checkpoint import tree_leaves, tree_unflatten


@functools.lru_cache(maxsize=None)
def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream captures run on, one a device for the process: each
    new stream would get a cuBLAS workspace of its own that outlives it."""
    return torch.cuda.Stream(device)


def eager(name, fn, *args, out=None):
    """The plain runner: call the segment."""
    return fn(*args)


def _is(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                       and a.stride() == b.stride() and a.dtype == b.dtype))


def _dests(out, value) -> list:
    """``out`` expanded to one entry per leaf of ``value`` (None: the
    runner's own buffer)."""
    if out is None:
        return [None] * len(tree_leaves(value))
    if isinstance(value, tuple):
        return [d for o, v in zip(out, value) for d in _dests(o, v)]
    return [out]


class _Graph:
    """One captured variant of a segment: its static inputs (the tensors it
    was captured on: the runner's buffers, or copies that each call
    refills) and its result (the runner's buffers and host values)."""

    def __init__(self, name, graph, static, copied, result):
        self.name, self.graph, self.static, self.result = name, graph, static, result
        self.copied = copied
        self.bound = [(i, x.data_ptr()) for i, x in enumerate(static)
                      if isinstance(x, torch.Tensor) and i not in copied]

    def reads(self, leaves) -> bool:
        """Whether the inputs it reads in place are where they were at its
        capture."""
        return all(leaves[i].data_ptr() == ptr for i, ptr in self.bound)

    def run(self, leaves):
        for i in self.copied:
            if leaves[i].data_ptr() != self.static[i].data_ptr():
                self.static[i].copy_(leaves[i])
        self.graph.replay()
        return self.result


class SegmentRunner:
    """Runs segments through fixed buffers.  Each segment name owns buffers
    for the result's leaves that have no ``out``; every variant of the name
    writes the same buffers, so what follows reads one place whichever
    variant ran.  With ``replay`` set (on a card), a variant is captured
    into a CUDA graph the first time it is called (on inputs at new
    addresses, again) and replayed from then on; a name whose buffers do
    not exist yet runs eagerly once first.  All
    the graphs share one memory pool: no tensor of the pool is read after
    its graph's replay (results go to the buffers, inputs that are not
    buffers are copied in), so the graphs may run in any order.

    ``register`` marks tensors whose address holds for the runner's life
    (the state, the uploads, the extrinsics): a graph reads them where
    they are; any other input tensor is copied into the graph's own input
    buffer before each replay."""

    # graphs of one variant on inputs at other addresses (a skipped mapping
    # frame's pose in place of the map's); more means an input moves every call
    MAX_GRAPHS = 4

    def __init__(self, device):
        self.device = torch.device(device)
        self.replay = False
        self.buffers: dict[str, list] = {}     # name -> own result buffers
        self.graphs: dict[tuple, list] = {}    # (name, host values of the args) -> graphs
        self._stable: set[int] = set()         # storage addresses of registered tensors
        self._pool = None

    def register(self, *trees) -> None:
        for t in tree_leaves(trees):
            if isinstance(t, torch.Tensor):
                self._stable.add(t.untyped_storage().data_ptr())

    def _stable_input(self, t: torch.Tensor) -> bool:
        return t.untyped_storage().data_ptr() in self._stable

    def __call__(self, name, fn, *args, out=None):
        leaves = tree_leaves(args)
        if self.replay and name in self.buffers:
            key = (name,) + tuple(x for x in leaves if not isinstance(x, torch.Tensor))
            graphs = self.graphs.setdefault(key, [])
            g = next((g for g in graphs if g.reads(leaves)), None)
            if g is None:
                if len(graphs) == self.MAX_GRAPHS:
                    raise RuntimeError(f"segment {name}: its inputs moved {len(graphs)} times")
                g = self._capture(name, fn, args, leaves, out)
                graphs.append(g)
            return g.run(leaves)
        return self._store(name, fn(*args), out)

    def _store(self, name, value, out):
        """``value``'s tensor leaves written to their ``out`` or to the
        name's buffers (made here, outside any capture, the first time);
        returns ``value`` with those tensors in place of its leaves."""
        leaves, dests = tree_leaves(value), _dests(out, value)
        own = self.buffers.get(name)
        first = own is None
        if first:
            own = []
        written, result, k = set(), [], 0
        for x, d in zip(leaves, dests):
            if not isinstance(x, torch.Tensor):
                result.append(x)
                continue
            if d is None:
                if first:
                    d = torch.empty_like(x)
                    own.append(d)
                    self.register(d)
                else:
                    if k >= len(own):
                        raise ValueError(f"segment {name}: more results than its buffers")
                    d = own[k]
                    if d.shape != x.shape or d.dtype != x.dtype:
                        raise ValueError(f"segment {name}: result {k} is {tuple(x.shape)} "
                                         f"{x.dtype}, its buffer {tuple(d.shape)} {d.dtype}")
                k += 1
            if not _is(x, d):
                if x.untyped_storage().data_ptr() in written:
                    raise ValueError(f"segment {name}: a result reads a buffer the segment "
                                     "has already written")
                d.copy_(x)
                written.add(d.untyped_storage().data_ptr())
            result.append(d)
        if first:
            self.buffers[name] = own
        return tree_unflatten(value, iter(result))

    def _capture(self, name, fn, args, leaves, out) -> _Graph:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static, copied = [], []
        for i, x in enumerate(leaves):
            if isinstance(x, torch.Tensor) and not self._stable_input(x):
                x = x.clone()
                copied.append(i)
            static.append(x)
        graph = torch.cuda.CUDAGraph()
        main, side = torch.cuda.current_stream(self.device), capture_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            graph.capture_begin(pool=self._pool)
            try:
                result = self._store(name, fn(*tree_unflatten(args, iter(static))), out)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass   # the capture was invalidated by the error raised above
                raise
            graph.capture_end()
        main.wait_stream(side)
        return _Graph(name, graph, static, set(copied), result)

    def close(self) -> None:
        """Drop the graphs and the buffers."""
        self.graphs.clear()
        self.buffers.clear()
        self._stable.clear()
        self._pool = None
