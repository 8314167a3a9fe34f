"""The full VLOAM frame step with the map sharded over a map mesh (port of
``vloam_tpu/parallel/vloam_shard.py``).

Every rank runs the whole step.  VO, scan registration and LO are
replicated: they are small and each depends on the last, so every rank
computes the same copy.  The mapping stage runs the sharded twin
(``parallel/mapping_shard.sharded_mapping_step``): each rank keeps its block
of the cube slots and of the submap cache, searches its slice of the window
and merges the top-k with the other ranks.
"""

from __future__ import annotations

from vloam_tpu_torch.config import VloamConfig
from vloam_tpu_torch.models import frame_graph as fg
from vloam_tpu_torch.models.vloam import VloamState, vloam_step
from vloam_tpu_torch.parallel.mapping_shard import MAP_SHARDED_FIELDS, sharded_mapping_step
from vloam_tpu_torch.parallel.mesh import MapMesh, shard_map_state


def shard_vloam_state(state: VloamState, mesh: MapMesh) -> VloamState:
    """This rank's view of a state from ``init_vloam_state(cfg, device,
    n_map_shards=S)``: its block of the map, the rest as it is."""
    return state._replace(mp=shard_map_state(state.mp, mesh))


def state_partition_specs() -> frozenset:
    """The fields of a VloamState split over the ranks (dotted paths); every
    other field is replicated."""
    return frozenset(f"mp.{name}" for name in MAP_SHARDED_FIELDS)


def make_sharded_vloam_step(cfg: VloamConfig, ext: fg.Extrinsics, mesh: MapMesh):
    """(state, img, cloud, cloud_mask, **vloam_step options) -> (state,
    VloamOutputs) on this rank of ``mesh``; the outputs are the same on
    every rank."""

    def mapping_fn(st, ci, cm, si, sm, pw, cfg_):
        return sharded_mapping_step(st, ci, cm, si, sm, pw, cfg_, mesh)

    def step(state, img, cloud, cloud_mask, **kw):
        return vloam_step(state, img, cloud, cloud_mask, ext, cfg, mapping_fn=mapping_fn, **kw)

    return step
