"""Both packages' map fits on the same neighbours (ROADMAP C-m, C-a).

The 5-NN neighbourhoods of frame 1 of ``torch_lift_gap.py``'s drive (the
map from the identity and lifted 24 m; the port's own drive, since the two
packages' searches agree there) go through the port's and the JAX
package's ``fit_surf_planes`` and ``fit_corner_lines`` on the same inputs,
and through a float64 NumPy solve of the same equations (the uncentred
normal equations A n = -1 of the planes; the centred covariance's leading
eigenvector of the lines).

* The planes where the equations are well conditioned: the neighbourhoods
  centred and set 2 m out along their own normal (cond(A) < 1e3, hundreds
  of rows): the port's normals lie within 4 cond(A) float32 epsilons of
  JAX's and of the float64 solve's, row by row (measured: 2.5).
* The lines: directions within 5e-5 of JAX's and of float64.
* The planes as the drive fits them, at 25 m coordinates: both float32 fits
  sit far from the float64 solve and about as far from each other
  (measured medians of the normals' largest entry gap, lifted map: port to
  float64 0.979, JAX to float64 0.974, port to JAX 0.613; identity map
  0.103, 0.0971, 0.0625; ``python tests/test_torch_fit_conditioning.py``
  prints them).  The Cramer solve of the uncentred sums loses the planes to
  float32 cancellation in both packages (C-a); the packages round it
  differently, which is the gap between their mapping steps (C-m).  Not a
  port fault: the port computes JAX's formula, and matches it wherever the
  formula is well conditioned.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_mapping_shard as t  # noqa: E402  (tests/ on the path)
from vloam_tpu.models import laser_mapping as jmap
from vloam_tpu_torch.models import laser_mapping as tmap

EPS = float(np.finfo(np.float32).eps)
COND_MAX = 1e3          # the well-conditioned planes
COND_EPS = 4.0          # |port - JAX|, |port - f64| <= COND_EPS * cond(A) * eps, row by row
LINE_TOL = 5e-5         # line directions


def capture_fit_inputs():
    """{"identity" | "lifted": {"surf" | "corner": (stack, mask, nbr, d2)}} of
    frame 1's last outer iteration."""
    feeds = t.make_feeds(t.TCFG, 2, 600)
    real = tmap.fit_surf_planes, tmap.fit_corner_lines
    out = {}
    for name in ("identity", "lifted"):
        rec = {}

        def surf(*a):
            rec["surf"] = a[:4]
            return real[0](*a)

        def corner(*a):
            rec["corner"] = a[:4]
            return real[1](*a)

        st = tmap.init_map_state(t.TCFG, "cpu")
        if name == "lifted":
            st = st._replace(wmap_wodom=t.LIFT)
        tmap.fit_surf_planes, tmap.fit_corner_lines = surf, corner
        try:
            for feed in feeds:
                st, _ = tmap.mapping_step(st, *feed, t.TCFG)
        finally:
            tmap.fit_surf_planes, tmap.fit_corner_lines = real
        out[name] = dict(rec)
    return out


@pytest.fixture(scope="module")
def fit_inputs():
    return capture_fit_inputs()


def both_planes(stack, mask, nbr, d2):
    """((port normals, port valid), (JAX normals, JAX valid)) in float64."""
    _, pn, _, pv = tmap.fit_surf_planes(stack, mask, nbr, d2, t.TCFG)
    _, jn, _, jv = jmap.fit_surf_planes(*(jnp.array(x.numpy()) for x in (stack, mask, nbr, d2)),
                                        t.JCFG)
    return (pn.double().numpy(), pv.numpy()), (np.asarray(jn, np.float64), np.asarray(jv))


def f64_planes(nbr: np.ndarray):
    """(unit normals, cond(A)) of A n = -sum(x), A = sum(x x^T), in float64
    (rows whose A is singular get NaN normals)."""
    A = np.einsum("mki,mkj->mij", nbr, nbr)
    b = -nbr.sum(axis=1)
    cond = np.linalg.cond(A)
    ok = np.isfinite(cond) & (cond < 1e14)
    n = np.full(b.shape, np.nan)
    n[ok] = np.linalg.solve(A[ok], b[ok][..., None])[..., 0]
    return n / np.linalg.norm(n, axis=1, keepdims=True), cond


def well_conditioned(stack, mask, nbr, d2):
    """The neighbourhoods centred and set 2 m out along their own normal:
    (rows both packages accept with cond(A) < COND_MAX, and per row
    |port - JAX|, |port - f64| and cond(A))."""
    x = nbr.double().numpy()
    z = x - x.mean(axis=1, keepdims=True)
    normal = np.linalg.eigh(np.einsum("mki,mkj->mij", z, z))[1][..., 0]
    moved = torch.tensor(z + 2.0 * normal[:, None, :], dtype=torch.float32)
    (pn, pv), (jn, jv) = both_planes(stack, mask, moved, d2)
    n64, cond = f64_planes(moved.double().numpy())
    rows = pv & jv & (cond < COND_MAX)
    return (rows, np.abs(pn[rows] - jn[rows]).max(axis=1),
            np.abs(pn[rows] - n64[rows]).max(axis=1), cond[rows])


@pytest.mark.parametrize("start", ["identity", "lifted"])
def test_plane_fit_matches_jax_where_well_conditioned(start, fit_inputs):
    rows, port_jax, port64, cond = well_conditioned(*fit_inputs[start]["surf"])
    assert rows.sum() >= 100, rows.sum()
    assert np.all(port_jax <= COND_EPS * cond * EPS)
    assert np.all(port64 <= COND_EPS * cond * EPS)


@pytest.mark.parametrize("start", ["identity", "lifted"])
def test_line_fit_matches_jax(start, fit_inputs):
    stack, mask, nbr, d2 = fit_inputs[start]["corner"]
    _, pa, pb, pv = tmap.fit_corner_lines(stack, mask, nbr, d2, t.TCFG)
    _, ja, jb, jv = jmap.fit_corner_lines(*(jnp.array(x.numpy()) for x in (stack, mask, nbr, d2)),
                                          t.JCFG)
    x = nbr.double().numpy()
    z = x - x.mean(axis=1, keepdims=True)
    v3 = np.linalg.eigh(np.einsum("mki,mkj->mij", z, z))[1][..., 2]
    rows = pv.numpy() & np.asarray(jv)
    assert rows.sum() >= 500, rows.sum()

    def direction(a, b):
        d = (np.asarray(a, np.float64) - np.asarray(b, np.float64))[rows]
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return d * np.sign((d * v3[rows]).sum(axis=1, keepdims=True))

    pdir, jdir = direction(pa.numpy(), pb.numpy()), direction(ja, jb)
    assert np.abs(pdir - jdir).max() <= LINE_TOL
    assert np.abs(pdir - v3[rows]).max() <= LINE_TOL


def plane_spread(stack, mask, nbr, d2):
    """On the rows both packages accept: medians of |port - f64|, |JAX -
    f64|, |port - JAX| (the normals' largest entry gap) and of cond(A)."""
    (pn, pv), (jn, jv) = both_planes(stack, mask, nbr, d2)
    n64, cond = f64_planes(nbr.double().numpy())
    rows = pv & jv & np.isfinite(n64).all(axis=1)
    gap = lambda a, b: float(np.median(np.abs(a[rows] - b[rows]).max(axis=1)))  # noqa: E731
    return gap(pn, n64), gap(jn, n64), gap(pn, jn), float(np.median(cond[rows]))


def test_plane_fit_spread_is_both_packages(fit_inputs):
    """The planes as the drive fits them: on the lifted map both float32
    fits lie about as far from the float64 solve (each median within 1.5x of
    the other's) as the port lies from JAX, and farther than from the
    identity map: the uncentred solve's conditioning, shared (C-a)."""
    spread = {start: plane_spread(*fit_inputs[start]["surf"]) for start in ("identity", "lifted")}
    port64, jax64, port_jax, _ = spread["lifted"]
    assert port64 <= 1.5 * jax64 and jax64 <= 1.5 * port64, spread
    assert port_jax <= max(port64, jax64), spread
    assert min(port64, jax64) > 2.0 * max(spread["identity"][:2]), spread


if __name__ == "__main__":
    # the numbers ROADMAP C-m quotes:
    #   env JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_fit_conditioning.py
    for start, fits in capture_fit_inputs().items():
        p64, j64, pj, cond = plane_spread(*fits["surf"])
        rows, port_jax, port64, c = well_conditioned(*fits["surf"])
        ratio = np.maximum(port_jax, port64) / (c * EPS)
        print(f"{start}: planes as fitted, medians port-f64 {p64:.3g}, JAX-f64 {j64:.3g}, "
              f"port-JAX {pj:.3g}, cond(A) {cond:.3g}; well conditioned: {int(rows.sum())} rows, "
              f"largest gap {ratio.max():.3g} cond(A) eps")
