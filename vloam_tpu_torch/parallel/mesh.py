"""The map mesh: ranks of ``torch.distributed`` over which the cube map is
sharded (port of ``vloam_tpu/parallel/mesh.py``), and the collectives the
sharded mapping step needs, named after the reference's.

One process is one rank.  Nothing on a machine tells a program of its
cluster, so every rank is given the rendezvous (``init_method``: a
``tcp://host:port`` or a ``file://`` store every rank can reach), the world
size and its rank.  With NCCL each rank drives one GPU of its own
(``cuda:LOCAL_RANK``); NCCL refuses two ranks on one device ("invalid
usage", NCCL 2.28 on an H100).  With gloo the ranks may share a GPU or run
on the CPU: the helpers below copy a CUDA tensor to host memory, run the
collective there and copy the result back (each copy waits for the device).
Gloo took CUDA tensors for ``all_reduce`` and ``all_gather`` there too, but
not every gloo build does, and the butterfly's send/receive pair is not
among them, so every collective takes the one host path.  On NCCL a CUDA
tensor goes as it is; the helpers never copy there.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)


class MapMesh(NamedTuple):
    group: object            # the process group (the world group when every rank is in it)
    rank: int                # this rank's shard index
    size: int                # the number of shards S
    device: torch.device     # where this rank's shard lives
    backend: str             # "nccl" or "gloo"


def init_distributed(backend: str, init_method: str, world_size: int, rank: int,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the process group (``torch.distributed.init_process_group``).
    Idempotent: a process already in a group returns at once."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=timeout)


def map_mesh(n: int | None = None, device=None) -> MapMesh:
    """The 1-D map mesh over the first ``n`` ranks (every rank by default).
    Every rank calls it (a subgroup is made collectively).  ``device``
    defaults to ``cuda:LOCAL_RANK``, on either backend, and raises when no
    GPU is there; the CPU is taken only when it is asked for
    (``device="cpu"``)."""
    if not dist.is_initialized():
        raise RuntimeError("map_mesh: call init_distributed first")
    world = dist.get_world_size()
    n = world if n is None else n
    if world < n:
        raise RuntimeError(f"map_mesh({n}) needs {n} ranks but the process group has {world}")
    backend = dist.get_backend()
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        raise RuntimeError(f"map_mesh({n}): rank {rank} is not in the mesh")
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))) if device is None else (
        torch.device(device))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"map_mesh: device {device} requested but torch.cuda.is_available() is "
                           "false; pass device='cpu' to run on the CPU")
    return MapMesh(group, rank, n, device, backend)


def shard_map_state(state, mesh: MapMesh):
    """This rank's block of a map built with ``init_map_state(cfg, device,
    n_shards=S)`` (at S = 1 the single-device layout does too): slots [r * nc_local, (r + 1) * nc_local) plus a scrap
    slot of its own, cache block r; poses, flags and the window centre are
    replicated.  The blocks are copies, so the global arrays can be freed:
    no rank keeps the whole cube map."""
    from vloam_tpu_torch.parallel.mapping_shard import MAP_SHARDED_FIELDS

    r, S = mesh.rank, mesh.size
    out = {}
    for name, leaf in state._asdict().items():
        if name in MAP_SHARDED_FIELDS:
            leaf = leaf.reshape((-1,) + tuple(leaf.shape[1:]))   # a 0-d count: one block
            rows = leaf.shape[0] - 1 if name == "cube_pts" else leaf.shape[0]
            n = rows // S
            block = leaf[r * n:(r + 1) * n]
            if name == "cube_pts":
                block = torch.cat([block, torch.zeros_like(block[:1])])
            leaf = block.to(mesh.device, copy=True).contiguous()
        elif isinstance(leaf, torch.Tensor):
            leaf = leaf.to(mesh.device)
        out[name] = leaf
    return type(state)(**out)


def _via_host(x: torch.Tensor, mesh: MapMesh) -> bool:
    return mesh.backend == "gloo" and x.device.type == "cuda"


def axis_index(mesh: MapMesh) -> int:
    return mesh.rank


def axis_size(mesh: MapMesh) -> int:
    return mesh.size


def psum(x: torch.Tensor, mesh: MapMesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks (``all_reduce``), on every rank."""
    out = x.cpu() if _via_host(x, mesh) else x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out.to(x.device) if _via_host(x, mesh) else out


def broadcast(x: torch.Tensor, mesh: MapMesh) -> torch.Tensor:
    """Rank 0's ``x`` on every rank."""
    out = x.cpu() if _via_host(x, mesh) else x.clone()
    dist.broadcast(out, src=0, group=mesh.group)
    return out.to(x.device) if _via_host(x, mesh) else out


def ppermute_xor(x: torch.Tensor, step: int, mesh: MapMesh) -> torch.Tensor:
    """Swap ``x`` with rank ``rank ^ step`` (one butterfly round):
    ``batch_isend_irecv`` of one send and one receive."""
    partner = mesh.rank ^ step   # a mesh is the first S ranks: group rank = global rank
    src = x.cpu().contiguous() if _via_host(x, mesh) else x.contiguous()
    out = torch.empty_like(src)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, src, partner, group=mesh.group),
                                   dist.P2POp(dist.irecv, out, partner, group=mesh.group)])
    for req in reqs:
        req.wait()
    return out.to(x.device) if _via_host(x, mesh) else out


def all_gather(x: torch.Tensor, mesh: MapMesh) -> torch.Tensor:
    """(S, *x.shape): every rank's ``x``, in rank order, on every rank
    (``all_gather_into_tensor`` on NCCL, ``all_gather`` on gloo)."""
    if mesh.backend == "nccl":
        out = torch.empty((mesh.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
        return out
    src = x.cpu().contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.stack(parts).to(x.device)


def run_ranks(fn, n: int, args=(), timeout: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``n`` spawned processes and wait for all
    of them.  A rank that raises fails the call with its traceback; ranks
    still running after ``timeout`` seconds are killed and the call raises
    ``TimeoutError``.  ``fn`` must be importable by name (a module-level
    function) and returns nothing: ranks report through files."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"run_ranks: {n} ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
