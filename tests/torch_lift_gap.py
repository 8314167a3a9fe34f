"""How far the port's single-device mapping step lies from the JAX package's
when the map is lifted (ROADMAP C-m).  Run on the CPU from the repo root:

    env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_lift_gap.py

It drives ``tests/test_torch_mapping_shard.py``'s three frames through both
packages' ``mapping_step``, each frame from the same state (the port's is
JAX's, carried across), from the identity map and from the map lifted by
that file's ``LIFT``, and prints the largest pose difference a frame and
each package's distance from the synthetic truth (lift taken off).  It
repeats the drive with JAX's pairwise distances taken as direct differences
instead of the expanded form, to see whether the expansion's rounding at
larger coordinates accounts for the gap.  No tier-1 test: a measurement.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_mapping_shard as t  # noqa: E402
import vloam_tpu.ops.knn as jknn  # noqa: E402
from vloam_tpu.models import laser_mapping as jmap  # noqa: E402
from vloam_tpu_torch.data import synthetic  # noqa: E402
from vloam_tpu_torch.models import laser_mapping as tmap  # noqa: E402


def direct_sqdist(q, c):
    d = q[:, None, :] - c[None, :, :]
    return jnp.sum(d * d, axis=-1)


def main():
    feeds = t.make_feeds(t.TCFG, t.N_FRAMES, 600)
    truth = [tt for _, tt in synthetic.straight_trajectory(t.N_FRAMES, speed=0.8, yaw_rate=0.01)]
    identity = t.LIFT.clone()
    identity[4:] = 0.0
    for form in ("expanded", "direct"):
        if form == "direct":
            jknn.pairwise_sqdist = direct_sqdist
        for name, start in (("identity", identity), ("lifted", t.LIFT)):
            st = tmap.init_map_state(t.TCFG, "cpu")._replace(wmap_wodom=start)
            js = jmap.init_map_state(t.JCFG)._replace(wmap_wodom=jnp.array(start.numpy()))
            gaps, off_port, off_jax = [], [], []
            lift = start[4:].numpy()
            for f, tt in zip(feeds, truth):
                st, p = tmap.mapping_step(st, *f, t.TCFG)
                js, q = jmap.mapping_step(js, *(jnp.array(x.numpy()) for x in f), t.JCFG)
                p, q = p.numpy(), np.asarray(q)
                gaps.append(float(np.abs(p - q).max()))
                off_port.append(float(np.linalg.norm(p[4:] - lift - tt)))
                off_jax.append(float(np.linalg.norm(q[4:] - lift - tt)))
                st = tmap.map_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
            print(f"JAX distances {form}, map from the {name}: largest pose difference a frame "
                  f"{gaps}; position from the truth: port {off_port}, JAX {off_jax}")


if __name__ == "__main__":
    main()
