"""The port's exact k-NN pair (the plain version of the CUDA k-NN kernel)
against the JAX reference at LO-like and MO-like shapes, with masks, masked
holes inside a valid prefix, and dynamic counts.

Against the JAX CPU path (``knn(exact=True)``, matmul-form distances): d2
within 2e-3 m^2 below the largest gate (the matmul form's f32 cancellation
at +-60 m; beyond it the error grows with d2, so 2e-5 relative), indices
equal wherever the neighbour gaps exceed that, and identical outcomes of
the 1.0 m^2 (mapping fits) and 25.0 m^2 (LO) gates.

Against the Pallas pair kernel in interpret mode (lane-class approximate,
d2 floor-rounded by < 2^-14 relative): the exact port's k-th distance is
never larger than the kernel's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vloam_tpu.ops.knn import knn as jax_knn
from vloam_tpu.ops.pallas_knn import knn_lanemin_pair
from vloam_tpu_torch.ops import fused_knn
from vloam_tpu_torch.ops.knn import knn as port_knn

D2_TOL = 2e-3
GATES = (1.0, 25.0)


def _cloud(rng, n_cand, n_query, spread=0.6):
    """Candidates over +-60 m; queries near random candidates so the gates
    see both near and far neighbours."""
    cand = rng.uniform(-60, 60, (n_cand, 3)).astype(np.float32)
    base = cand[rng.integers(0, n_cand, n_query)]
    query = (base + rng.normal(0, spread, (n_query, 3))).astype(np.float32)
    return query, cand


def _case(name, rng):
    """Two problems the way LO or MO builds them (small shapes)."""
    if name == "lo":
        qa, ca = _cloud(rng, 1536, 192)
        ma = rng.random(1536) < 0.85
        qb, cb = _cloud(rng, 2048, 384)
        mb = rng.random(2048) < 0.8
        mb[1700:] = False                                   # padding past the prefix
        n_b = int(np.flatnonzero(mb).max()) + 1             # last valid + 1, holes inside
        return (qa, ca, ma, 8, qb, cb, mb, 16), (None, None), (None, n_b)
    qa, ca = _cloud(rng, 1024, 256)
    qb, cb = _cloud(rng, 2048, 512)
    ma = np.arange(1024) < 700                              # prefix-compacted submaps
    mb = np.arange(2048) < 1900
    return (qa, ca, ma, 5, qb, cb, mb, 5), (200, 700), (450, 1900)


def _port(args, a_counts, b_counts):
    t = [torch.tensor(x) if isinstance(x, np.ndarray) else x for x in args]
    c = lambda cs: tuple(None if v is None else torch.tensor(v) for v in cs)  # noqa: E731
    (d2a, ia), (d2b, ib) = fused_knn.knn_pair(*t, a_counts=c(a_counts), b_counts=c(b_counts))
    return (d2a.numpy(), ia.numpy()), (d2b.numpy(), ib.numpy())


def _check_against_cpu_path(q, c, m, k, counts, got):
    d2, idx = got
    q_n = len(q) if counts[0] is None else counts[0]
    jd2, jidx = jax_knn(jnp.array(q), jnp.array(c), jnp.array(m), k, exact=True)
    jd2, jidx = np.asarray(jd2)[:q_n], np.asarray(jidx)[:q_n]
    jd2 = np.where(jd2 > 1e38, np.inf, jd2)                 # reference sentinel 3.4e38
    d2q, idxq = d2[:q_n], idx[:q_n]
    assert np.isinf(d2[q_n:]).all() and (idx[q_n:] == 0).all()   # past the query count
    np.testing.assert_array_equal(np.isinf(d2q), np.isinf(jd2))
    fin = np.isfinite(jd2)
    near = fin & (jd2 < max(GATES))                         # the range any consumer reads
    np.testing.assert_allclose(d2q[near], jd2[near], atol=D2_TOL, rtol=0)
    np.testing.assert_allclose(d2q[fin], jd2[fin], atol=D2_TOL, rtol=2e-5)
    gap = np.diff(np.concatenate([np.full((q_n, 1), -np.inf), jd2,
                                  np.full((q_n, 1), np.inf)], axis=1), axis=1)
    clear = (np.minimum(gap[:, :-1], gap[:, 1:]) > D2_TOL) & fin
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(idxq[clear], jidx[clear])
    assert (idxq[~fin] == 0).all()                          # unfilled slots gather in range
    for g in GATES:
        np.testing.assert_array_equal(d2q < g, jd2 < g)


@pytest.mark.parametrize("name", ["lo", "mo"])
def test_matches_jax_cpu_path(name, rng):
    args, a_counts, b_counts = _case(name, rng)
    got_a, got_b = _port(args, a_counts, b_counts)
    qa, ca, ma, ka, qb, cb, mb, kb = args
    _check_against_cpu_path(qa, ca, ma, ka, a_counts, got_a)
    _check_against_cpu_path(qb, cb, mb, kb, b_counts, got_b)


@pytest.mark.parametrize("name", ["lo", "mo"])
def test_never_worse_than_pallas_kernel(name, rng):
    args, a_counts, b_counts = _case(name, rng)
    got = _port(args, a_counts, b_counts)
    qa, ca, ma, ka, qb, cb, mb, kb = args
    j = lambda v: None if v is None else jnp.int32(v)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        want = knn_lanemin_pair(
            jnp.array(qa), jnp.array(ca), jnp.array(ma), ka,
            jnp.array(qb), jnp.array(cb), jnp.array(mb), kb,
            a_counts=tuple(map(j, a_counts)), b_counts=tuple(map(j, b_counts)),
            _force_tpu_path=True,
        )
    for (d2, _), (pd2, _), counts in zip(got, want, (a_counts, b_counts)):
        # the kernel skips query tiles, not queries: compare below the count
        q_n = len(d2) if counts[0] is None else counts[0]
        d2, pd2 = d2[:q_n], np.asarray(pd2)[:q_n]
        real = pd2 < 1e10                                   # below the kernel's sentinel
        assert (d2[real] <= pd2[real] * (1 + 2.0 ** -13) + 1e-6).all()
        assert np.isinf(d2[~real]).all()


def test_contract_counts_masks_and_ties():
    """Candidates past the count never enter even when unmasked; masked
    candidates never enter; ties go to the lower index; unfilled slots and
    queries past the count are +inf with index 0."""
    cand = np.array([[0, 0, 0], [1, 0, 0], [1, 0, 0], [0.5, 0, 0], [0.1, 0, 0]], np.float32)
    mask = np.array([True, True, True, False, True])
    q = np.array([[0.9, 0, 0], [5, 5, 5]], np.float32)
    d2, idx = port_knn(torch.tensor(q), torch.tensor(cand), torch.tensor(mask), 4,
                       cand_count=torch.tensor(4), query_count=torch.tensor(1))
    d2, idx = d2.numpy(), idx.numpy()
    np.testing.assert_array_equal(idx[0], [1, 2, 0, 0])     # tie 1 before 2; 3 masked; 4 past count
    np.testing.assert_allclose(d2[0, :3], [0.01, 0.01, 0.81], rtol=1e-5)
    assert np.isinf(d2[0, 3]) and np.isinf(d2[1]).all() and (idx[1] == 0).all()


def test_wrapper_on_cpu_is_the_plain_version(rng):
    args, a_counts, b_counts = _case("mo", rng)
    t = [torch.tensor(x) if isinstance(x, np.ndarray) else x for x in args]
    c = lambda cs: tuple(None if v is None else torch.tensor(v) for v in cs)  # noqa: E731
    got = fused_knn.knn_pair(*t, a_counts=c(a_counts), b_counts=c(b_counts))
    want = fused_knn.knn_pair_reference(*t, a_counts=c(a_counts), b_counts=c(b_counts))
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    assert fused_knn.LAUNCHES == 0
