"""The sorting path of the port's ``voxel_downsample`` (``presorted=False``)
and the map re-voxelisation ``laser_mapping._refilter_cubes`` against the
JAX package on the same NumPy inputs.

* ``voxel_downsample(presorted=False)``: random clouds with and without a
  group key, cap truncation, an empty cloud, and the interleaved-invalid
  layout of ``tests/test_voxel.py``: equal masks, centroids within 1e-5 (the
  segment sums add the same rows in the same order on the CPU; float
  atomics reorder them on a card).
* The batched form quantises each cloud from its own masked minimum: each
  row equals the unbatched call on that cloud alone.
* ``_refilter_cubes`` on a filled map: a window of slots in a larger grid,
  with two slot ids past the last cube (gathered clipped, dropped on scatter),
  against the JAX function: the same counts, every cube row within 1e-5,
  and the slots outside the window untouched.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.config import MappingConfig
from vloam_tpu.config import kitti_hdl64 as jkitti
from vloam_tpu.models import laser_mapping as jmap
from vloam_tpu.ops import voxel as jvox
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch.models import laser_mapping as tmap
from vloam_tpu_torch.ops import voxel as tvox

ATOL = 1e-5


def _both(pts, mask, leaf, cap, group=None, max_grid=1024):
    jp, jm = jvox.voxel_downsample(jnp.array(pts), jnp.array(mask), leaf, cap,
                                   group_key=None if group is None else jnp.array(group),
                                   max_grid=max_grid)
    tp, tm = tvox.voxel_downsample(torch.tensor(pts), torch.tensor(mask), leaf, cap,
                                   group_key=None if group is None else torch.tensor(group).long(),
                                   max_grid=max_grid, presorted=False)
    return (np.asarray(jp), np.asarray(jm)), (tp.numpy(), tm.numpy())


def _cloud(rng, n, span=8.0, p_mask=0.8):
    pts = np.concatenate([rng.uniform(-span, span, (n, 3)), rng.uniform(0, 64, (n, 1))], axis=1)
    return pts.astype(np.float32), rng.random(n) < p_mask


@pytest.mark.parametrize("case", ["plain", "group_key", "cap_truncates", "empty"])
def test_sorted_voxel_downsample_matches_reference(case, rng):
    pts, mask = _cloud(rng, 2000)
    group, cap = None, 2048
    if case == "group_key":
        group = rng.integers(0, 6, 2000).astype(np.int32)
    elif case == "cap_truncates":
        cap = 100
    elif case == "empty":
        mask[:] = False
    (jp, jm), (tp, tm) = _both(pts, mask, 0.7, cap, group)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tp, jp, atol=ATOL, rtol=0)
    n_out = int(tm.sum())
    if case == "empty":
        assert n_out == 0 and not tp.any()
    elif case == "cap_truncates":
        assert n_out == cap
    else:
        assert 100 < n_out < int(mask.sum())       # voxels did merge


def test_sorted_voxel_downsample_interleaved_invalid(rng):
    """Invalid rows between valid runs (tests/test_voxel.py's ring-grid
    layout), each ring one cluster and one group: one centroid per ring."""
    R, C = 8, 64
    pts = np.zeros((R * C, 4), np.float32)
    mask = np.zeros((R * C,), bool)
    for r in range(R):
        n_valid = 10 + 3 * r
        pts[r * C:r * C + n_valid, :3] = (np.array([10.0 * r, -5.0 * r, 1.0])
                                          + rng.uniform(0, 0.5, (n_valid, 3)))
        mask[r * C:r * C + n_valid] = True
    ring_id = np.repeat(np.arange(R, dtype=np.int32), C)
    (jp, jm), (tp, tm) = _both(pts, mask, 4.0, 64, ring_id)
    np.testing.assert_array_equal(tm, jm)
    assert int(tm.sum()) == R
    np.testing.assert_allclose(tp, jp, atol=ATOL, rtol=0)


def test_batched_quantises_each_cloud_from_its_own_minimum(rng):
    """Three clouds far apart in one batch: each row equals the unbatched
    call, so no cloud's voxel boundaries move with another's minimum."""
    clouds = [_cloud(rng, 700, span=4.0) for _ in range(3)]
    pts = np.stack([p + np.float32([37.3 * i, -11.1 * i, 5.55 * i, 0]) for i, (p, _) in
                    enumerate(clouds)])
    mask = np.stack([m for _, m in clouds])
    bp, bm = tvox.voxel_downsample_batched(torch.tensor(pts), torch.tensor(mask), 0.4, 700,
                                           max_grid=256, presorted=False)
    for i in range(3):
        (jp, jm), (tp, tm) = _both(pts[i], mask[i], 0.4, 700, max_grid=256)
        np.testing.assert_array_equal(bm[i].numpy(), tm)
        np.testing.assert_array_equal(bp[i].numpy(), tp)
        np.testing.assert_allclose(bp[i].numpy(), jp, atol=ATOL, rtol=0)


# ---- _refilter_cubes ----------------------------------------------------------

MC = dict(grid_w=7, grid_h=7, grid_d=3, corner_cube_cap=128, surf_cube_cap=256)
JCFG = jkitti().replace(mapping=MappingConfig(**MC))
TCFG = tconfig.kitti_hdl64().replace(mapping=tconfig.MappingConfig(**MC))


def test_refilter_cubes_matches_reference(rng):
    mc = JCFG.mapping
    nc = mc.grid_w * mc.grid_h * mc.grid_d
    capc, caps = mc.corner_cube_cap, mc.surf_cube_cap
    # each cube holds a few dense clusters at its own origin, so voxels merge
    origin = rng.uniform(-100, 100, (nc, 1, 3))
    xyz = origin + rng.choice([0.0, 3.0, 17.0], (nc, capc + caps, 3)) + rng.uniform(
        0, 1.5, (nc, capc + caps, 3))
    cube = np.concatenate([xyz, rng.uniform(0, 64, (nc, capc + caps, 1))], -1).astype(np.float32)
    c_cnt = rng.integers(0, capc + 1, nc).astype(np.int32)
    s_cnt = rng.integers(0, caps + 1, nc).astype(np.int32)
    c_cnt[:3], s_cnt[:3] = capc, 0
    # rows past a cube's counts hold stale data, which must not leak in
    coords = jnp.array([3, -2, 1], jnp.int32)
    slots = np.array(jmap.coord_to_slot(jmap._submap_coords(coords, JCFG), JCFG))
    # another shard's cubes: its caller passes them as ids >= n_cubes
    # (vloam_tpu/parallel/mapping_shard.py:88; a negative id would wrap there)
    slots[[5, 40]] = (nc, nc + 3)
    want = [np.asarray(x) for x in jmap._refilter_cubes(
        jnp.array(cube), jnp.array(c_cnt), jnp.array(s_cnt), jnp.array(slots), JCFG)]

    t_cube = torch.cat([torch.tensor(cube), torch.zeros((1, capc + caps, 4))])
    got_c, got_s = tmap._refilter_cubes(t_cube, torch.tensor(c_cnt).long(),
                                        torch.tensor(s_cnt).long(), torch.tensor(slots).long(),
                                        TCFG)
    np.testing.assert_array_equal(got_c.numpy(), want[1])
    np.testing.assert_array_equal(got_s.numpy(), want[2])
    np.testing.assert_allclose(t_cube[:nc].numpy(), want[0], atol=ATOL, rtol=0)
    window = np.unique(slots[(slots >= 0) & (slots < nc)])
    assert len(window) == 73
    assert (got_c.numpy()[window] < c_cnt[window]).any()          # cubes did shrink
    outside = np.setdiff1d(np.arange(nc), window)
    np.testing.assert_array_equal(t_cube[outside].numpy(), cube[outside])
