"""The port's single-problem k-NN (``ops/knn.knn`` and ``nn1``; on the CPU
the plain version of the CUDA kernel ``csrc/knn.cu``) against the Pallas
kernel it replaces, ``pallas_knn.knn_lanemin``, run in interpret mode on the
inputs of tests/test_pallas_knn.py; and the map association built on it
(``laser_mapping._corner_correspondences`` / ``_surf_correspondences``)
against the JAX functions on their CPU path.

Bounds: the port is exact, so its recall against an f64 brute force is 1.0
and never below the Pallas kernel's (which keeps one neighbour per lane
class); where both return the same neighbour their d2 agree within
2e-3 m^2 + 2^-13 relative (the kernel floor-rounds d2 by < 2^-14 relative);
against the JAX CPU path (matmul-form distances) d2 agree within 2e-3 m^2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vloam_tpu.config import kitti_hdl64
from vloam_tpu.models import laser_mapping as jmap
from vloam_tpu.ops.knn import nn1 as jax_nn1
from vloam_tpu.ops.pallas_knn import knn_lanemin
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch.models import laser_mapping as tmap
from vloam_tpu_torch.ops import knn as tknn

K = 5
D2_TOL = 2e-3


def brute(q, cand, mask, k=K):
    d2 = np.sum((q[:, None, :].astype(np.float64) - cand[None, :, :].astype(np.float64)) ** 2, -1)
    d2[:, ~mask] = np.inf
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d2, idx, axis=1), idx


def pallas(q, cand, mask, k=K, **counts):
    counts = {name: jnp.int32(v) for name, v in counts.items()}
    with pltpu.force_tpu_interpret_mode():
        d2, idx = knn_lanemin(jnp.array(q), jnp.array(cand), jnp.array(mask), k, **counts)
    return np.asarray(d2), np.asarray(idx)


def port(q, cand, mask, k=K, **counts):
    counts = {name: torch.tensor(v) for name, v in counts.items()}
    d2, idx = tknn.knn(torch.tensor(q), torch.tensor(cand), torch.tensor(mask), k, **counts)
    return d2.numpy(), idx.numpy()


def _planted(rng):
    """Each query's true 5-NN planted at consecutive candidate indices."""
    M, N = 300, 4096
    q = rng.uniform(-50, 50, (M, 3)).astype(np.float32)
    cand = rng.uniform(-60, 60, (N, 3)).astype(np.float32)
    for i in range(M):
        base = (i * 13) % (N - 8)
        cand[base:base + K] = q[i] + rng.normal(0, 0.05, (K, 3))
    return q, cand, np.ones(N, bool)


def _masked(rng):
    q = rng.uniform(-20, 20, (256, 3)).astype(np.float32)
    cand = rng.uniform(-25, 25, (2048, 3)).astype(np.float32)
    return q, cand, rng.random(2048) < 0.8


def _random(rng):
    q = rng.uniform(-30, 30, (256, 3)).astype(np.float32)
    cand = rng.uniform(-30, 30, (8192, 3)).astype(np.float32)
    return q, cand, np.ones(8192, bool)


CASES = {"planted": _planted, "masked": _masked, "random": _random}


def recall(idx, ref_idx):
    return np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(idx, ref_idx)])


@pytest.mark.parametrize("case", list(CASES))
def test_exact_and_never_below_pallas_kernel(case, rng):
    q, cand, mask = CASES[case](rng)
    d2, idx = port(q, cand, mask)
    ref_d2, ref_idx = brute(q, cand, mask)
    pd2, pidx = pallas(q, cand, mask)

    np.testing.assert_array_equal(idx, ref_idx)             # exact, in order
    np.testing.assert_allclose(d2, ref_d2, atol=1e-4, rtol=1e-5)
    assert recall(idx, ref_idx) == 1.0 >= recall(pidx, ref_idx)
    assert mask[idx].all()                                  # masked candidates never returned
    # the k-th distance is never larger than the kernel's
    assert (d2[:, -1] <= pd2[:, -1] * (1 + 2.0 ** -13) + 1e-6).all()
    # where both return the same neighbour, the distances agree
    for row, prow, drow, pdrow in zip(idx, pidx, d2, pd2):
        common, ri, pi = np.intersect1d(row, prow, return_indices=True)
        np.testing.assert_allclose(drow[ri], pdrow[pi], atol=D2_TOL, rtol=2.0 ** -13)


def test_all_masked_gives_inf_and_index_zero():
    q = np.zeros((8, 3), np.float32)
    cand = np.ones((512, 3), np.float32)
    d2, idx = port(q, cand, np.zeros(512, bool))
    assert np.isinf(d2).all() and (idx == 0).all()
    pd2, _ = pallas(q, cand, np.zeros(512, bool))
    assert (pd2 > 1e10).all()                               # the kernel's sentinel


def test_dynamic_counts_honoured(rng):
    q, cand, mask = _masked(rng)
    q_n, c_n = 100, 1500
    mask[c_n:] = True                                       # unmasked, but past the count
    d2, idx = port(q, cand, mask, cand_count=c_n, query_count=q_n)
    assert np.isinf(d2[q_n:]).all() and (idx[q_n:] == 0).all()
    ref_d2, ref_idx = brute(q[:q_n], cand[:c_n], mask[:c_n])
    np.testing.assert_array_equal(idx[:q_n], ref_idx)
    np.testing.assert_allclose(d2[:q_n], ref_d2, atol=1e-4, rtol=1e-5)
    # the Pallas kernel skips whole tiles past the counts: compare below them
    pd2, pidx = pallas(q, cand, mask & (np.arange(len(mask)) < c_n), cand_count=c_n,
                       query_count=q_n)
    assert recall(idx[:q_n], ref_idx) == 1.0 >= recall(pidx[:q_n], ref_idx)
    assert (d2[:q_n, -1] <= pd2[:q_n, -1] * (1 + 2.0 ** -13) + 1e-6).all()


def test_nn1_is_column_zero(rng):
    q, cand, mask = _masked(rng)
    t = (torch.tensor(q), torch.tensor(cand), torch.tensor(mask))
    d2, idx = tknn.knn(*t, K)
    d1, i1 = tknn.nn1(*t)
    assert d1.shape == i1.shape == (len(q),)
    assert torch.equal(d1, d2[:, 0]) and torch.equal(i1, idx[:, 0])
    r1, ri1 = tknn.nn1_reference(*t)
    assert torch.equal(d1, r1) and torch.equal(i1, ri1)
    # the JAX nn1 on its CPU path (matmul-form distances)
    jd, ji = jax_nn1(jnp.array(q), jnp.array(cand), jnp.array(mask))
    np.testing.assert_allclose(d1.numpy(), np.asarray(jd), atol=D2_TOL, rtol=0)
    second = d2[:, 1].numpy()
    clear = second - d1.numpy() > D2_TOL
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(i1.numpy()[clear], np.asarray(ji)[clear])


@pytest.mark.parametrize("k", [1, 8, 16, 32, 128])
def test_any_k_up_to_128(k, rng):
    q, cand, mask = _masked(rng)
    d2, idx = port(q[:64], cand, mask, k)
    ref_d2, ref_idx = brute(q[:64], cand, mask, k)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(d2, ref_d2, atol=1e-4, rtol=1e-5)


def test_k_out_of_range_raises(rng):
    q, cand, mask = _masked(rng)
    t = (torch.tensor(q), torch.tensor(cand), torch.tensor(mask))
    for k in (0, 129):
        with pytest.raises(ValueError, match="outside"):
            tknn.knn(*t, k)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch(rng):
    q, cand, mask = _masked(rng)
    t = (torch.tensor(q), torch.tensor(cand), torch.tensor(mask))
    before = tknn.LAUNCHES
    got = tknn.knn(*t, K, cand_count=torch.tensor(1500), query_count=torch.tensor(100))
    ref = tknn.knn_reference(*t, K, cand_count=torch.tensor(1500), query_count=torch.tensor(100))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert tknn.LAUNCHES == before


# ---------------------------------------------------------------------------
# the map association built on it
# ---------------------------------------------------------------------------

def _structured_map(rng, kind, n_cand, n_query):
    """Candidates on noisy line segments (corner) or jittered plane lattices
    (surf) plus uniform clutter, prefix-compacted into a padded buffer;
    queries near random candidates.  The corner world spans +-20 m (the
    matmul form's d2 error stays < 2e-3 there).  The surf world spans +-3 m:
    the plane fit solves its f32 normal equations by Cramer's rule in world
    coordinates, which at tens of metres loses the plane to cancellation in
    either framework, so the two can only be compared near the origin."""
    ext, step, noise = (20.0, 0.3, 0.02) if kind == "corner" else (3.0, 0.15, 0.003)
    n_feat = 40
    per = int(n_cand * 0.6) // n_feat
    pts = []
    for _ in range(n_feat):
        origin = rng.uniform(-0.9 * ext, 0.9 * ext, 3)
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        if kind == "corner":
            s = np.arange(per) * step
            p = origin + s[:, None] * u + rng.normal(0, noise, (per, 3))
        else:
            # a jittered lattice, so a query's 5 nearest are never collinear
            v = np.cross(u, rng.normal(size=3))
            v /= np.linalg.norm(v)
            side = int(np.sqrt(per))
            ab = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1).reshape(-1, 2) * step
            ab = ab + rng.uniform(-step / 6, step / 6, ab.shape)
            p = (origin + ab[:, :1] * u + ab[:, 1:] * v
                 + rng.normal(0, noise, (len(ab), 1)) * np.cross(u, v))
        pts.append(p)
    n_struct = sum(len(p) for p in pts)
    pts = np.concatenate(pts + [rng.uniform(-ext, ext, (n_cand - n_struct, 3))])
    n_live = int(n_cand * 0.9)
    cand = np.zeros((n_cand, 4), np.float32)
    cand[:, :3] = pts[rng.permutation(n_cand)]
    cand[n_live:] = 0.0
    cand_mask = np.arange(n_cand) < n_live
    q_live = int(n_query * 0.8)
    stack = np.zeros((n_query, 4), np.float32)
    stack[:, :3] = cand[rng.integers(0, n_live, n_query), :3] + rng.normal(0, step / 3, (n_query, 3))
    stack_mask = np.arange(n_query) < q_live
    return stack, stack_mask, cand, cand_mask, q_live, n_live


@pytest.mark.parametrize("kind", ["corner", "surf"])
def test_map_correspondences_match_jax(kind, rng):
    jcfg, tcfg = kitti_hdl64(), tconfig.kitti_hdl64()
    stack, stack_mask, cand, cand_mask, q_n, c_n = _structured_map(rng, kind, 3072, 768)
    pose = np.array([0.0, 0.0, np.sin(0.01), np.cos(0.01), 0.05, -0.03, 0.01], np.float32)
    jfn, tfn = ((jmap._corner_correspondences, tmap._corner_correspondences) if kind == "corner"
                else (jmap._surf_correspondences, tmap._surf_correspondences))
    want = [np.asarray(x) for x in jfn(jnp.array(pose), jnp.array(stack), jnp.array(stack_mask),
                                       jnp.array(cand), jnp.array(cand_mask), jcfg)]
    got = [x.numpy() for x in tfn(torch.tensor(pose), torch.tensor(stack),
                                  torch.tensor(stack_mask), torch.tensor(cand),
                                  torch.tensor(cand_mask), tcfg,
                                  cand_count=torch.tensor(c_n), query_count=torch.tensor(q_n))]
    p, a, b, valid, nn = got
    jp, ja, jb, jvalid, jnn = want
    np.testing.assert_array_equal(p, jp)
    live = stack_mask
    np.testing.assert_allclose(nn[live], jnn[live], atol=D2_TOL, rtol=0)
    assert np.isinf(nn[~live]).all()                        # queries past the count
    assert not valid[~live].any() and not jvalid[~live].any()

    # rows whose 5-NN set is unambiguous and whose distance gate is clear
    from vloam_tpu_torch import geometry as geo
    tq = geo.pose_apply(torch.tensor(pose), torch.tensor(stack[:, :3]))
    d6, i6 = tknn.knn_reference(tq, torch.tensor(cand[:, :3]), torch.tensor(cand_mask), 6)
    d6, nbr = d6.numpy(), cand[i6.numpy()[:, :5], :3].astype(np.float64)
    gate = tcfg.mapping.neighbor_dist_sq
    clear = live & (np.diff(d6, axis=1).min(axis=1) > D2_TOL) & (np.abs(d6[:, 4] - gate) > D2_TOL)
    if kind == "surf":
        # ... and whose plane is well determined in f32 (the normal equations
        # square the condition number: 300^2 * 6e-8 ~ 5e-3) with the fit
        # residuals away from the tolerance
        tol = tcfg.mapping.plane_fit_tol
        for r in np.flatnonzero(clear):
            n = np.linalg.lstsq(nbr[r], -np.ones(5), rcond=None)[0]
            worst = np.abs(nbr[r] @ n + 1.0).max() / np.linalg.norm(n)
            clear[r] = np.linalg.cond(nbr[r]) < 300 and abs(worst - tol) > 0.1 * tol
    assert clear.sum() > 0.4 * live.sum(), (clear.sum(), live.sum())
    np.testing.assert_array_equal(valid[clear], jvalid[clear])
    both = clear & valid
    assert both.sum() > 50, both.sum()
    if kind == "corner":
        np.testing.assert_allclose(a[both], ja[both], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(b[both], jb[both], atol=1e-4, rtol=1e-4)
    else:
        # unit normals: 95 % within 2 degrees, all within 15 degrees (what
        # the f32 Cramer solve leaves of a plane a few metres from the
        # origin); offsets 1 / |n|: half within 0.1 %, 95 % within 5 %
        dots = np.abs(np.sum(a[both] * ja[both], axis=1))
        assert np.quantile(dots, 0.05) > np.cos(np.radians(2.0)), np.quantile(dots, 0.05)
        assert dots.min() > np.cos(np.radians(15.0)), dots.min()
        rel = np.abs(b[both] - jb[both]) / jb[both]
        assert np.median(rel) < 1e-3 and np.quantile(rel, 0.95) < 5e-2, np.quantile(rel, [.5, .95])
