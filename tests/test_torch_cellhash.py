"""The port's cell-hash tables (``vloam_tpu_torch/ops/cellhash.py``) against
the JAX package's ``ops/cellhash.py`` on the same seeded inputs, and against
``tests/test_cellhash.py``'s contracts (brute-force NumPy k-NN within the
gate, append equals rebuild, an empty table reports far), on the CPU.

The hash, the tables and their counts must equal the reference's exactly
(stable bucket sorts on both sides); ``cell_knn``'s distances within 1e-6
relative (a three-term sum each side) and its neighbours exactly wherever
the reference's distance lies inside the gate.  The op loads no jax in a
process of its own.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cellhash import CAP, CELL, H, K, brute_knn, make_points
from vloam_tpu.ops import cellhash as jch
from vloam_tpu_torch.ops import cellhash as tch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(x):
    return torch.tensor(np.asarray(x))


def tables(seed=0, n=3000, keep=0.9):
    rng = np.random.default_rng(seed)
    cand = make_points(rng, n)
    mask = rng.random(n) < keep
    return rng, cand, mask


def test_cell_hash_matches_jax():
    rng = np.random.default_rng(5)
    cells = rng.integers(-2**20, 2**20, (4000, 3)).astype(np.int32)
    cells[:8] = [[0, 0, 0], [-1, -1, -1], [2**20, -2**20, 7], [-40, 40, -3],
                 [1, 0, 0], [0, 1, 0], [0, 0, 1], [-2**20, -2**20, -2**20]]
    for size in (1, 16, 4096, 2**16):
        got = tch.cell_hash(t(cells), size)
        assert torch.equal(got, t(jch.cell_hash(jnp.array(cells), size)).to(torch.int64))
        assert int(got.min()) >= 0 and int(got.max()) < size
    with pytest.raises(ValueError):
        tch.cell_hash(t(cells), 3000)


@pytest.mark.parametrize("cap", [CAP, 2])
def test_build_and_append_match_jax(cap):
    """Exact tables and counts, with room and with buckets that overflow."""
    rng, a, ma = tables(1, 2000, 1.0)
    b = make_points(rng, 500)
    mb = rng.random(500) < 0.8
    jt, jc = jch.build_cell_table(jnp.array(a), jnp.array(ma), CELL, H, cap)
    tt, tc = tch.build_cell_table(t(a), t(ma), CELL, H, cap)
    assert torch.equal(tt, t(jt)) and torch.equal(tc, t(jc))
    jt, jc = jch.append_cell_table(jt, jc, jnp.array(b), jnp.array(mb), CELL)
    tt, tc = tch.append_cell_table(tt, tc, t(b), t(mb), CELL)
    assert torch.equal(tt, t(jt)) and torch.equal(tc, t(jc))
    assert int(tc.max()) == cap if cap == 2 else int(tc.max()) < cap


def test_cell_knn_matches_jax():
    rng, cand, mask = tables(0)
    q = cand[rng.integers(0, 3000, 500), :3] + rng.normal(0, 0.3, (500, 3)).astype(np.float32)
    jt, _ = jch.build_cell_table(jnp.array(cand), jnp.array(mask), CELL, H, CAP)
    jd2, jnbr = jch.cell_knn(jnp.array(q), jt, CELL, K, exact=True)
    td2, tnbr = tch.cell_knn(t(q), t(jt), CELL, K)
    jd2, jnbr = np.asarray(jd2), np.asarray(jnbr)
    np.testing.assert_allclose(td2.numpy(), jd2, rtol=1e-6, atol=1e-7)
    inside = jd2 < CELL ** 2
    assert inside.sum() >= 400          # nearly every query has a neighbour inside the gate
    np.testing.assert_array_equal(tnbr.numpy()[inside], jnbr[inside])


def test_cell_knn_matches_brute_within_gate():
    """tests/test_cellhash.py's contract on the port."""
    rng, cand, mask = tables(0)
    q = cand[rng.integers(0, 3000, 500), :3] + rng.normal(0, 0.3, (500, 3)).astype(np.float32)
    tbl, cnt = tch.build_cell_table(t(cand), t(mask), CELL, H, CAP)
    d2, nbr = tch.cell_knn(t(q), tbl, CELL, K)
    d2, nbr = d2.numpy(), nbr.numpy()
    ref = brute_knn(q.astype(np.float64), cand[mask, :3].astype(np.float64))
    for j in range(K):
        inside = ref[:, j] < CELL ** 2
        np.testing.assert_allclose(d2[inside, j], ref[inside, j], rtol=1e-4, atol=1e-5)
    d2_re = np.sum((nbr - q[:, None, :]) ** 2, axis=-1)
    close = d2 < CELL ** 2
    np.testing.assert_allclose(d2[close], d2_re[close], rtol=1e-4, atol=1e-5)
    assert int(cnt.sum()) == int(mask.sum())


def test_append_equals_rebuild():
    rng = np.random.default_rng(1)
    a, b = make_points(rng, 2000), make_points(rng, 500)
    ma, mb = np.ones(2000, bool), rng.random(500) < 0.8
    t1, c1 = tch.build_cell_table(t(a), t(ma), CELL, H, CAP)
    t1, c1 = tch.append_cell_table(t1, c1, t(b), t(mb), CELL)
    both = np.concatenate([a, b[mb]])
    t2, c2 = tch.build_cell_table(t(both), torch.ones(len(both), dtype=torch.bool), CELL, H, CAP)
    assert int(c1.sum()) == int(c2.sum())
    q = t(make_points(rng, 300)[:, :3])
    d2a, _ = tch.cell_knn(q, t1, CELL, K)
    d2b, _ = tch.cell_knn(q, t2, CELL, K)
    np.testing.assert_allclose(d2a.numpy(), d2b.numpy(), rtol=1e-5, atol=1e-6)


def test_empty_table_reports_far():
    tbl = tch.empty_cell_table(H, CAP, "cpu")
    assert torch.equal(tbl, t(jnp.full((H, CAP * 4), jch.SENTINEL)))
    d2, _ = tch.cell_knn(torch.zeros(8, 3), tbl, CELL, K)
    assert bool(torch.all(d2 > 1e6))


def test_cellhash_imports_no_jax():
    """The port's op, run in a fresh process, loads no jax and nothing of
    the reference package."""
    code = textwrap.dedent("""
        import sys, torch
        from vloam_tpu_torch.ops import cellhash
        pts = torch.rand(500, 4) * 20
        tbl, cnt = cellhash.build_cell_table(pts, torch.ones(500, dtype=torch.bool), 1.0, 1024, 8)
        one = torch.ones(50, dtype=torch.bool)
        tbl, cnt = cellhash.append_cell_table(tbl, cnt, pts[:50], one, 1.0)
        d2, nbr = cellhash.cell_knn(pts[:20, :3], tbl, 1.0, 5)
        assert bool((d2[:, 0] == 0).all())
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "vloam_tpu.")))
        assert not bad, bad
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
