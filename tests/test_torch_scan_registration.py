"""The port's scan registration (from a host ring grid and less-flat table)
against the JAX reference on one synthetic scan.

The JAX side runs op by op (``jax.disable_jit``) so that each f32 operation
rounds on its own, as the port's do; the compiled reference may fuse
multiply-adds, which moves curvature by an ulp.  The sharp, less-sharp and
flat masks must be equal, the feature points equal to 1e-5, and the
less-flat centroids (sums of up to dozens of points) to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.config import ScanConfig
from vloam_tpu.data import synthetic
from vloam_tpu.data.gridding import grid_cloud, less_flat_voxel_table
from vloam_tpu.ops.scan_registration import extract_features_from_grid as jax_extract
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch.ops.scan_registration import extract_features_from_grid

SC = dict(ring_cap=512, max_points=32768, less_flat_cap=8192)
JCFG = ScanConfig(**SC)
TCFG = tconfig.ScanConfig(**SC)


@pytest.fixture(scope="module")
def both():
    R, t = synthetic.straight_trajectory(3, speed=0.8, yaw_rate=0.005)[2]
    pts = synthetic.simulate_scan(R, t, synthetic.default_scene(), n_azimuth=700,
                                  noise=0.005, seed=2)
    grid, gmask, n_per_ring = grid_cloud(pts, JCFG)
    lf = less_flat_voxel_table(grid, gmask, JCFG)
    with jax.disable_jit():
        want = jax_extract(jnp.array(grid), jnp.array(gmask), jnp.array(n_per_ring), JCFG,
                           lf_table=(jnp.array(lf[0]), jnp.array(lf[1]), jnp.int32(lf[2])))
    got = extract_features_from_grid(
        torch.tensor(grid), torch.tensor(gmask), torch.tensor(n_per_ring), TCFG,
        lf_table=(torch.tensor(lf[0]), torch.tensor(lf[1]), lf[2]))
    return got, jax.tree.map(np.asarray, want), (grid, gmask, n_per_ring, lf)


@pytest.mark.parametrize("cloud,atol", [("sharp", 1e-5), ("less_sharp", 1e-5), ("flat", 1e-5),
                                        ("less_flat", 1e-4)])
def test_features_match_reference(both, cloud, atol):
    got, want, _ = both
    mask = getattr(want, cloud + "_mask")
    np.testing.assert_array_equal(getattr(got, cloud + "_mask").numpy(), mask)
    assert mask.sum() > 50
    np.testing.assert_allclose(getattr(got, cloud).numpy(), getattr(want, cloud), atol=atol, rtol=0)
