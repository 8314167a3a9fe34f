"""The plain versions of the eleven patch-gather measurement kernels
(``vloam_tpu_torch/ops/gather_variants``) against NumPy on padded images,
and the four exact-gather formulations also against the JAX
``_slice_patches``.  Everything is a copy, a maximum or a sum of eleven
floats added in order, so the arrays must be equal.

The JAX kernels themselves cannot be called here: they are closures inside
``main()`` of the reference's ``tools/gather_experiments.py``, which exits
before defining them on any backend but the TPU.  On the CPU every wrapper
of the port takes its plain version; the CUDA kernels are held against the
same plain versions on the card by ``chip_smoke.py``.

Small size: two 100 x 300 images (padded 112 x 512), 64 corners per image.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.ops.image_ops import _slice_patches as jax_slice_patches
from vloam_tpu.ops.pallas_gather import pad_img as jax_pad_img
from vloam_tpu_torch.ops import gather_variants as gv
from vloam_tpu_torch.tools import gather_experiments as tool

H, W, N, P = 100, 300, 64, gv.P


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    img_a = rng.uniform(0, 255, (H, W)).astype(np.float32)
    img_b = rng.uniform(0, 255, (H, W)).astype(np.float32)
    corners = np.stack([rng.integers(0, W - P + 1, N), rng.integers(0, H - P + 1, N)], -1)
    corners[:4] = [[0, 0], [W - P, 0], [0, H - P], [W - P, H - P]]
    corners = corners.astype(np.int32)
    padded = np.stack([np.asarray(jax_pad_img(jnp.array(i))) for i in (img_a, img_b)])
    ids = np.concatenate([np.zeros(N, np.int32), np.ones(N, np.int32)])
    cxy = np.concatenate([corners, corners])
    meta = np.stack([ids, cxy[:, 0], cxy[:, 1]])
    return img_a, img_b, corners, padded, meta


def test_pad_img_equals_reference(data):
    img_a, img_b, _, padded, _ = data
    for img, want in zip((img_a, img_b), padded):
        got = gv.pad_img(torch.tensor(img)).numpy()
        assert got.shape == (112, 512)
        np.testing.assert_array_equal(got, want)


def np_strip_maxima(padded):
    n_bases = (padded.shape[1] - 40) // 8 + 1
    return np.array([padded[b, 8 * i:8 * i + 40, :].max()
                     for b in range(padded.shape[0]) for i in range(n_bases)], np.float32)


def np_sums_in_order(m):
    acc = np.zeros(m.shape[0] // gv.BATCH, np.float32)
    for k in range(gv.BATCH):
        acc = acc + m.reshape(-1, gv.BATCH)[:, k]
    return acc


def np_windows(padded, ids, rows, cols):
    return np.stack([padded[b, r:r + P, c:c + P] for b, r, c in zip(ids, rows, cols)])


def np_expected(name, data):
    _, _, _, padded, meta = data
    ids, cx, cy = meta
    if name in ("strip_sweep", "strip_sweep_db"):
        return np_strip_maxima(padded)
    if name == "whole_image":
        return np.full(gv.REPS, padded.max(), np.float32)
    if name in ("gather_narrow", "gather_resident", "gather_mma", "gather_resident_mma"):
        return np_windows(padded, ids, cy, cx)
    if name == "dma_only":
        return np_windows(padded, ids, cy - cy % 8, cx - cx % 128)
    if name == "compact_only":
        first = np.repeat(meta[:, ::gv.BLOCK_KP], gv.BLOCK_KP, axis=1)
        return np_windows(padded, first[0], first[2] - first[2] % 8 + cy % 8,
                          first[1] - first[1] % 128 + cx % 128)
    raise KeyError(name)


def call(name, data):
    _, _, _, padded, meta = data
    imgs, tmeta = torch.tensor(padded), torch.tensor(meta)
    if name in ("strip_sweep", "strip_sweep_db"):
        return getattr(gv, name)(imgs)
    if name == "whole_image":
        return gv.whole_image(imgs.reshape(-1, imgs.shape[2]))
    return getattr(gv, name)(imgs, tmeta)


@pytest.mark.parametrize("name", [n for n in gv.NAMES
                                  if n not in ("strip_sweep_batched", "strip_sweep_flat")])
def test_plain_equals_numpy(name, data):
    got = call(name, data)
    want = np_expected(name, data)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert gv.LAUNCHES[name] == 0


@pytest.mark.parametrize("name", ["strip_sweep_batched", "strip_sweep_flat"])
def test_batched_sweeps(name, rng):
    """Eleven images of 3 bases each: 33 strips, 3 groups of eleven."""
    padded = np.zeros((11, 56, 128), np.float32)
    padded[:, :44, :100] = rng.uniform(-50, 255, (11, 44, 100)).astype(np.float32)
    want = np_sums_in_order(np_strip_maxima(padded))
    imgs = torch.tensor(padded)
    got = (gv.strip_sweep_batched(imgs) if name == "strip_sweep_batched"
           else gv.strip_sweep_flat(imgs.reshape(-1, 128), 11))
    assert tuple(got.shape) == (3,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert gv.LAUNCHES[name] == 0


@pytest.mark.parametrize("name", ["gather_narrow", "gather_resident", "gather_mma",
                                  "gather_resident_mma"])
def test_exact_gathers_equal_jax_slice_patches(name, data):
    img_a, img_b, corners, _, _ = data
    want = np.concatenate([np.asarray(jax_slice_patches(jnp.array(i), jnp.array(corners), P))
                           for i in (img_a, img_b)])
    np.testing.assert_array_equal(call(name, data).numpy(), want)


@pytest.mark.parametrize("bad", [(0, -1, 0), (0, 0, 112 - P + 1), (2, 0, 0)])
def test_window_outside_raises(bad, data):
    _, _, _, padded, meta = data
    meta = meta.copy()
    meta[:, 5] = bad
    with pytest.raises(ValueError):
        gv.gather_narrow(torch.tensor(padded), torch.tensor(meta))


def test_compact_only_wants_whole_blocks(data):
    _, _, _, padded, meta = data
    with pytest.raises(ValueError, match="multiple"):
        gv.compact_only(torch.tensor(padded), torch.tensor(meta[:, :40]))


def test_wrappers_never_fall_back():
    """A tensor that is not on the CPU goes to the kernel or raises: it is
    never quietly given to the plain version."""
    from vloam_tpu_torch.ops import patch_gather

    imgs = torch.zeros((2, 112, 512), device="meta")
    meta = torch.zeros((3, 64), dtype=torch.int32, device="meta")
    for name in ("strip_sweep", "strip_sweep_db", "strip_sweep_batched"):
        with pytest.raises(ValueError):
            getattr(gv, name)(imgs)
    for fn in (gv.whole_image, lambda x: gv.strip_sweep_flat(x, 2)):
        with pytest.raises(ValueError):
            fn(imgs.reshape(-1, 512))
    for name in gv.NAMES[5:]:
        with pytest.raises(ValueError):
            getattr(gv, name)(imgs, meta)
    corners = torch.zeros((8, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        patch_gather.gather_patches(imgs[0], corners)
    with pytest.raises(ValueError):
        patch_gather.gather_patches_stack(imgs, corners)
    assert not any(gv.LAUNCHES.values())


def test_tool_and_new_modules_never_import_jax_and_need_a_gpu():
    """The measurement tool imports no jax, builds nothing at import, and
    exits nonzero without a GPU."""
    import os
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "from vloam_tpu_torch.ops import gather_variants, orb\n"
            "from vloam_tpu_torch.tools import gather_experiments as tool\n"
            "rc = tool.main()\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
            "assert not bad, bad\n"
            "sys.exit(rc)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=repo,
                         env=env, timeout=120)
    assert res.returncode == 1 and "needs a CUDA GPU" in res.stderr, res.stderr[-2000:]
    assert res.stdout == ""


# --- the inputs made to break the exact gathers and the sweeps, small -------

CASE_H, CASE_W, CASE_N = 100, 300, 64


@pytest.mark.parametrize("name", ["gather_narrow", "gather_resident", "gather_mma",
                                  "gather_resident_mma"])
@pytest.mark.parametrize("case", tool.CASES)
def test_exact_gathers_on_cases(case, name):
    """The plain versions of the four exact gathers on small versions of the
    tool's cases, against NumPy and the JAX ``_slice_patches`` of each image."""
    imgs, meta = tool.case_inputs(case, CASE_H, CASE_W, CASE_N)
    padded, (ids, cx, cy) = imgs.numpy(), meta.numpy()
    got = getattr(gv, name)(imgs, meta).numpy()
    np.testing.assert_array_equal(got, np_windows(padded, ids, cy, cx))
    for b in (0, 1):
        corners = np.stack([cx[ids == b], cy[ids == b]], -1)
        want = np.asarray(jax_slice_patches(jnp.array(padded[b]), jnp.array(corners), P))
        np.testing.assert_array_equal(got[ids == b], want)
    assert gv.LAUNCHES[name] == 0


def test_cases_cover_what_they_claim():
    _, meta = tool.case_inputs("one_bucket", CASE_H, CASE_W, CASE_N)
    ids, cx, cy = meta.numpy()
    assert len(set(ids)) == 1 and len(set(cy // 8)) == 1 and meta.shape[1] == CASE_N
    _, meta = tool.case_inputs("alignments", CASE_H, CASE_W, CASE_N)
    ids, cx, cy = meta.numpy()
    assert set(cx % 8) == set(range(8)) and {0, 1, 96, 127} <= set(cx % 128)
    assert set(cy % 8) == set(range(8)) and set(ids) == {0, 1}
    assert cx.max() == CASE_W - P and cy.max() == CASE_H - P and cx.min() == 0
    assert {CASE_W - P - i for i in range(8)} <= set(cx[cy == CASE_H - P])
    imgs, _ = tool.case_inputs("magnitudes", CASE_H, CASE_W, CASE_N)
    x = imgs.numpy()[:, :CASE_H, :CASE_W]
    nz = np.abs(x[x != 0])
    assert 1e-30 <= nz.min() < 1e-28 and 1e28 < nz.max() <= 1e30
    assert (x < 0).any() and not np.signbit(x[x == 0]).any()
    _, meta = tool.case_inputs("sparse", CASE_H, CASE_W, CASE_N)
    ids, cx, cy = meta.numpy()
    last = (CASE_H - P) // 8
    assert meta.shape[1] == tool.SPARSE_N == 37 and set(ids) == {0, 1}
    assert set(cy // 8) == {0, last} and cy.max() <= CASE_H - P
    assert tool.SPARSE_N % 32 != 0 and tool.SPARSE_N % 512 != 0


def test_tool_check_cases_on_cpu():
    """The check phase 3c runs on the card, here on the plain versions: a
    line a case, B2's two forms, G7 and G8 held to their own host windows,
    then the specials line."""
    out = tool.check_cases("cpu", CASE_H, CASE_W, CASE_N)
    assert [ok for _, ok in out] == [True] * (len(tool.CASES) + 1)
    assert all("gather_resident True" in line and "gather_resident_mma True" in line
               and "B2 single True, B2 stack True" in line and "dma_only True" in line
               and "compact_only True" in line for line, _ in out[:-1])
    line = out[-1][0]
    assert line.startswith("case specials") and "B2 single True, B2 stack True" in line
    assert "dma_only True, compact_only True" in line


@pytest.mark.parametrize("name", tool.TRANSPORT)
@pytest.mark.parametrize("case", tool.CASES)
def test_transport_plain_on_cases(case, name):
    """G7's and G8's plain versions on small versions of the tool's cases
    (G8 on the case's whole blocks of 32), against windows cut with NumPy at
    their origins: the band's raw corner (G7), or the block's first band at
    each keypoint's own (cy % 8, cx % 128) (G8)."""
    imgs, meta = tool.case_inputs(case, CASE_H, CASE_W, CASE_N)
    if name == "compact_only":
        meta = tool.whole_blocks(meta)
        assert meta.shape[1] % gv.BLOCK_KP == 0 and meta.shape[1] >= gv.BLOCK_KP
    padded, (ids, cx, cy) = imgs.numpy(), meta.numpy()
    if name == "dma_only":
        want = np_windows(padded, ids, cy - cy % 8, cx - cx % 128)
    else:
        first = np.repeat(meta.numpy()[:, ::gv.BLOCK_KP], gv.BLOCK_KP, axis=1)
        want = np_windows(padded, first[0], first[2] - first[2] % 8 + cy % 8,
                          first[1] - first[1] % 128 + cx % 128)
    np.testing.assert_array_equal(getattr(gv, name)(imgs, meta).numpy(), want)
    assert gv.LAUNCHES[name] == 0


@pytest.mark.parametrize("name", tool.TRANSPORT + ("gather_narrow",))
def test_needed_bytes_counts_each_image_float_once(name):
    """The bytes the gathers' bounds count, against a count of the image
    cells their windows read kept in a Python set, on the alignments case
    (whose windows overlap): meta and the windows are added once each.  G7
    and G8 read at their bands' corners, the exact gathers at the keypoints'
    own."""
    imgs, meta = tool.case_inputs("alignments", CASE_H, CASE_W, CASE_N)
    meta = tool.whole_blocks(meta)
    ids, cx, cy = meta.numpy().astype(np.int64)
    if name == "dma_only":
        origins = zip(ids, cy - cy % 8, cx - cx % 128)
    elif name == "compact_only":
        b0, cx0, cy0 = (np.repeat(v[::gv.BLOCK_KP], gv.BLOCK_KP) for v in (ids, cx, cy))
        origins = zip(b0, cy0 - cy0 % 8 + cy % 8, cx0 - cx0 % 128 + cx % 128)
    else:
        origins = zip(ids, cy, cx)
    cells = {(b, r + i, c + j) for b, r, c in origins for i in range(P) for j in range(P)}
    assert len(cells) < meta.shape[1] * P * P   # the windows overlap
    want = 4 * (len(cells) + meta.numel() + meta.shape[1] * P * P)
    assert tool.needed_bytes(name, imgs, meta) == want


@pytest.mark.parametrize("n_img", [1, 3])
def test_patch_bytes_counts_each_image_float_once(n_img):
    """B2's bytes: the floats under the windows of one image, against a
    Python set, times the images that share the corners, with the corners
    once and the windows of every image.  Crossing windows count their shared
    floats once, and floats no window covers not at all."""
    corners = torch.tensor([[0, 0], [10, 4], [10, 4], [40, 30], [56, 0]], dtype=torch.int32)
    shape = (70, 100)
    cells = {(int(y) + i, int(x) + j) for x, y in corners for i in range(P) for j in range(P)}
    assert len(cells) < corners.shape[0] * P * P and len(cells) < shape[0] * shape[1]
    want = 4 * (n_img * len(cells) + corners.numel() + n_img * corners.shape[0] * P * P)
    assert tool.patch_bytes(shape, corners, n_img) == want


@pytest.mark.parametrize("name", tool.TRANSPORT)
def test_transport_library_call_equals_plain(name):
    """The library yardstick of G7 and G8: one index call on the view of all
    windows at the origins the tool prepares before the timed call, equal to
    the plain version."""
    imgs, meta = tool.case_inputs("alignments", CASE_H, CASE_W, CASE_N)
    meta = tool.whole_blocks(meta)
    ids, rows, cols = tool.library_origins(name, meta)
    got = tool.window_view(imgs)[ids, rows, cols]
    assert torch.equal(got, getattr(gv, name + "_reference")(imgs, meta))


def test_special_case_covers_what_it_claims():
    """The specials case holds NaN, -0.0, subnormals and both infinities in
    every window, and G7's and G8's plain versions carry them bit for bit."""
    imgs, meta = tool.special_case(CASE_H, CASE_W, CASE_N)
    for name, m in (("dma_only", meta), ("compact_only", tool.whole_blocks(meta))):
        got = getattr(gv, name)(imgs, m)
        x = got.numpy()
        assert np.isnan(x).any() and np.isposinf(x).any() and np.isneginf(x).any()
        assert (np.signbit(x) & (x == 0)).any()
        assert ((x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)).any()
        assert tool.same(got, torch.tensor(tool.host_windows(imgs, m, name)))


# the sweep case, small: two padded images of 120 rows have 11 bases each, so
# their 22 strips split into the batched sweeps' groups of eleven
SWEEP_SHAPE = (2, 120, 512)


@pytest.mark.parametrize("name", tool.SWEEPS)
def test_sweeps_on_sweep_case(name):
    """The plain version of each sweep on negative images with planted
    maxima, against NumPy."""
    imgs = tool.sweep_case(*SWEEP_SHAPE)
    padded = imgs.numpy()
    maxima = np_strip_maxima(padded)
    want = {"strip_sweep": maxima, "strip_sweep_db": maxima,
            "strip_sweep_batched": np_sums_in_order(maxima),
            "strip_sweep_flat": np_sums_in_order(maxima),
            "whole_image": np.full(gv.REPS, padded.max(), np.float32)}[name]
    kernel, _ = tool.sweep_calls(imgs)[name]
    np.testing.assert_array_equal(kernel().numpy(), want)
    assert gv.LAUNCHES[name] == 0


def test_sweep_case_covers_what_it_claims():
    """Every value is negative, and the strips' maxima lie in every 8-row
    chunk and in every one of G1's four column slices; at the tool's size
    also in every one of G3's and G4's 16."""
    for shape in (SWEEP_SHAPE, (2, 384, 1408)):
        x = tool.sweep_case(*shape).numpy()
        assert x.max() < 0
        chunks, slices, slices16 = set(), set(), set()
        for b in range(shape[0]):
            for i in range(gv.n_bases(shape[1])):
                r, c = np.unravel_index(x[b, 8 * i:8 * i + gv.P8].argmax(), (gv.P8, shape[2]))
                chunks.add(int(r) // 8)
                slices.add(int(c) // (shape[2] // 4))
                slices16.add(int(c) // (shape[2] // gv.GROUP_CTAS))
        assert chunks == set(range(5)) and slices == set(range(4))
        if shape[1:] == (384, 1408):
            assert slices16 == set(range(gv.GROUP_CTAS)) and tool.SLICES == gv.GROUP_CTAS
    np.testing.assert_array_equal(tool.host_strip_maxima(tool.sweep_case(*SWEEP_SHAPE)),
                                  np_strip_maxima(tool.sweep_case(*SWEEP_SHAPE).numpy()))


def test_tool_check_sweep_case_on_cpu():
    line, ok = tool.check_sweep_case("cpu", *SWEEP_SHAPE)
    assert ok and "strip_sweep True" in line and "whole_image True" in line


def test_resident_shared_memory():
    """G9's block holds a 40-row strip of the padded width at stride w and
    its keypoint list: it fits at the tool's 1408 columns, not at 1536."""
    assert gv.resident_smem(1408) <= gv.SMEM_MAX < gv.resident_smem(1536)


def test_resident_mma_shared_memory():
    """G11's block holds a 40-row strip of the padded width at stride w + 4
    and its keypoint list: it fits at the tool's 1408 columns, not at 1536."""
    assert gv.resident_mma_smem(1408) <= gv.SMEM_MAX < gv.resident_mma_smem(1536)


# --- the exactness argument of the tensor-core shift ---------------------------

TF32_MASK = np.uint32(0xFFFFE000)


def split3(x):
    """x = hi + mid + lo by masking, as the kernels cut each value before the
    one-hot product (csrc/gather_variants.cu, load_split)."""
    hi = (x.view(np.uint32) & TF32_MASK).view(np.float32)
    r = x - hi
    mid = (r.view(np.uint32) & TF32_MASK).view(np.float32)
    return hi, mid, r - mid


def bit_sweep():
    """Every exponent of |x| >= 2**-103 with fixed and random mantissas, both signs."""
    rng = np.random.default_rng(0)
    mant = np.concatenate([[0, 1, 2, 0x1FFF, 0x2000, 0x3FFF, 0x400000, 0x555555, 0x2AAAAA,
                            0x7FFFFF], rng.integers(0, 1 << 23, 64)]).astype(np.uint32)
    exp = np.arange(24, 255, dtype=np.uint32)   # biased; 24 is 2**-103, 254 the largest finite
    bits = (exp[:, None] << np.uint32(23)) | mant[None, :]
    bits = np.concatenate([bits.ravel(), bits.ravel() | np.uint32(0x80000000)])
    return bits.view(np.float32)


@pytest.mark.parametrize("values", ["magnitudes", "bit_sweep", "zero"])
def test_three_term_split_is_exact(values):
    """Each term is exact in TF32 (its low 13 mantissa bits are zero) and of
    x's sign, and (hi + mid) + lo gives x back bit for bit."""
    if values == "magnitudes":
        imgs, _ = tool.case_inputs("magnitudes", CASE_H, CASE_W, CASE_N)
        x = imgs.numpy().ravel()
    elif values == "bit_sweep":
        x = bit_sweep()
    else:
        x = np.zeros(4, np.float32)
    hi, mid, lo = split3(x)
    for term in (hi, mid, lo):
        assert not (term.view(np.uint32) & np.uint32(0x1FFF)).any()
        nz = term != 0
        np.testing.assert_array_equal(np.signbit(term[nz]), np.signbit(x[nz]))
    np.testing.assert_array_equal(((hi + mid) + lo).view(np.uint32), x.view(np.uint32))


def test_three_term_split_bound():
    """Below 2**-103 the remainder can be subnormal and the masked split no
    longer gives TF32-exact terms: why the kernels' claim stops there."""
    x = np.array([0x00800001], np.uint32).view(np.float32)   # 2**-126 (1 + 2**-23)
    _, mid, lo = split3(x)
    assert mid[0] == 0 and (lo.view(np.uint32) & np.uint32(0x1FFF)).any()


# --- NaN, G5's plan and the sweep wrappers' host path ---------------------------

@pytest.mark.parametrize("name", tool.SWEEPS)
def test_sweeps_propagate_nan_like_jnp_max(name):
    """Each sweep's plain version on ``nan_case`` against ``jnp.max`` over
    the same strips (or the whole array): the strips that hold the NaN, the
    groups of eleven that hold those, and every G5 repeat come back NaN, and
    every other value is the one the images without the NaN give."""
    imgs, strips = tool.nan_case(*SWEEP_SHAPE)
    x = imgs.numpy()
    nb = gv.n_bases(x.shape[1])
    maxima = np.array([np.asarray(jnp.max(jnp.array(x[b, 8 * s:8 * s + gv.P8])))
                       for b in range(x.shape[0]) for s in range(nb)], np.float32)
    whole = np.float32(np.asarray(jnp.max(jnp.array(x))))
    want, nan_at = {
        "strip_sweep": (maxima, strips), "strip_sweep_db": (maxima, strips),
        "strip_sweep_batched": (np_sums_in_order(maxima), sorted({s // gv.BATCH for s in strips})),
        "strip_sweep_flat": (np_sums_in_order(maxima), sorted({s // gv.BATCH for s in strips})),
        "whole_image": (np.full(gv.REPS, whole, np.float32), list(range(gv.REPS))),
    }[name]
    got = tool.sweep_calls(imgs)[name][0]()
    assert tool.same(got, torch.tensor(want))
    assert np.flatnonzero(np.isnan(got.numpy())).tolist() == nan_at
    clean = tool.sweep_calls(tool.sweep_case(*SWEEP_SHAPE))[name][0]().numpy()
    keep = ~np.isnan(got.numpy())
    np.testing.assert_array_equal(got.numpy()[keep], clean[keep])
    assert gv.LAUNCHES[name] == 0


def test_same_is_nan_aware_and_bitwise():
    nan = float("nan")
    assert tool.same(torch.tensor([nan, 1.0]), torch.tensor([nan, 1.0]))
    assert not tool.same(torch.tensor([nan, 1.0]), torch.tensor([1.0, nan]))
    assert not tool.same(torch.tensor([0.0, 1.0]), torch.tensor([-0.0, 1.0]))
    assert not tool.same(torch.tensor([1.0]), torch.tensor([1.0, 1.0]))


def test_tool_check_nan_case_on_cpu():
    line, ok = tool.check_nan_case("cpu", *SWEEP_SHAPE)
    assert ok and "whole_image True" in line and "plain NaN strips True" in line


def test_tool_check_whole_image_case_on_cpu():
    """The G5 case's check passes on the plain version at the small size."""
    line, ok = tool.check_whole_image_case("cpu", *SWEEP_SHAPE)
    assert ok, line


@pytest.mark.parametrize("shape", [(2, 384, 1408), SWEEP_SHAPE, (1, 48, 128)])
def test_whole_image_positions(shape):
    """The G5 case plants its maximum at the first and the last float each
    block of the cluster reads, and at the array's ends.  Held here in closed
    form: block q starts at unit 256 q, and its last unit is 256 q + 255 of
    the last whole round of 256 * 16 units, or of the partial round after
    it, cut at the array's end."""
    n = shape[0] * shape[1] * shape[2]
    n4, ctas = n // 4, tool.WHOLE_CTAS
    rounds, rest = divmod(n4, 256 * ctas)
    want = {0, n - 1}
    for q in range(min(ctas, -(-n4 // 256))):
        first = 256 * q
        last = (256 * ctas * rounds + min(rest, first + 256) - 1 if rest > first
                else 256 * ctas * (rounds - 1) + first + 255)
        want |= {4 * first, 4 * last + 3}
    assert tool.whole_image_positions(n) == sorted(want)


def test_whole_image_cluster_fits_the_source():
    """The G5 case plants its maximum for the kernel's own cluster, and that
    cluster covers the card's 132 SMs at the tool's ten repeats."""
    import re

    text = (tool.Path(gv.kernels.SRC_DIR) / "gather_sweeps.cu").read_text()
    ctas = int(re.search(r"constexpr int kWholeCtas = (\d+);", text).group(1))
    assert tool.WHOLE_CTAS == ctas == 16
    assert ctas * gv.REPS >= 132


def test_batched_cluster_fits_the_source():
    """G3's and G4's cluster and slots, mirrored in Python, are the
    kernel's: 16 CTAs a group of eleven strips, 8 groups at the tool's size
    (128 CTAs, no more than the 132 SMs), eleven slots of 20-row half slices
    (77,440 B at 1408 columns, so that two blocks share an SM), each slot on
    128 bytes, and the tensor map's box rules at every width the tests and
    the tool use."""
    import re

    text = (tool.Path(gv.kernels.SRC_DIR) / "gather_sweeps.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert gv.GROUP_CTAS == const("kGroupCtas") == 16
    assert gv.BATCH == const("kBatch") == 11 and gv.BOX_MAX == const("kBoxMax") == 256
    assert gv.SLOT_ROWS == const("kSlotRows") == gv.P8 // 2
    groups = 2 * gv.n_bases(384) // gv.BATCH
    assert groups == 8 and gv.GROUP_CTAS * groups == 128 <= 132
    assert gv.batched_smem(1408) == 11 * 20 * 88 * 4 == 77_440
    assert 2 * gv.batched_smem(1408) <= gv.SMEM_MAX
    assert gv.batched_smem(1408) // gv.BATCH % 128 == 0   # each slot starts on 128 bytes
    for w in (128, 512, 1408):
        cols = w // gv.GROUP_CTAS
        assert cols * 4 % 16 == 0 and cols <= gv.BOX_MAX and gv.SLOT_ROWS <= gv.BOX_MAX
        assert gv.batched_smem(w) <= gv.SMEM_MAX
        gv._check_box("strip_sweep_batched", w)


@pytest.mark.parametrize("name", ["strip_sweep_batched", "strip_sweep_flat"])
@pytest.mark.parametrize("w", [4224, 8448])
def test_batched_sweeps_refuse_widths_the_tensor_map_cannot_box(name, w, monkeypatch):
    """A padded width whose column slice overflows a box (4224: 264
    columns; 8448: 528, whose eleven slots also overflow a block's shared
    memory) raises ValueError before anything is allocated or launched."""
    monkeypatch.setattr(gv.kernels, "require_cuda", lambda *tensors: None)
    monkeypatch.setattr(gv.kernels, "entry", lambda entry_name: pytest.fail("launched"))
    assert w // gv.GROUP_CTAS > gv.BOX_MAX and (w < 8448 or gv.batched_smem(w) > gv.SMEM_MAX)
    imgs = torch.empty((2, 120, w), device="meta")
    arg = (imgs,) if name == "strip_sweep_batched" else (imgs.reshape(-1, w), 2)
    with pytest.raises(ValueError, match="tensor-map boxes"):
        getattr(gv, name)(*arg)
    assert gv.LAUNCHES[name] == 0


@pytest.mark.parametrize("name", ["strip_sweep", "strip_sweep_db", "strip_sweep_batched",
                                  "strip_sweep_flat", "whole_image", "dma_only", "compact_only"])
def test_sweep_wrappers_run_nothing_before_the_launch(name, monkeypatch):
    """On the kernel's path a wrapper (the five sweeps, G7 and G8) runs no
    PyTorch operation but the output's allocation (``new_empty``, which is
    ``torch.empty`` with the images' dtype and device), then one launch, then
    nothing: recorded with the library replaced by a stand-in and every
    dispatched ATen operation logged."""
    from torch.utils._python_dispatch import TorchDispatchMode

    log = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            log.append(str(func))
            return func(*args, **(kwargs or {}))

    def entry(entry_name):
        def launch(*args):
            assert len(args) == len(gv.kernels._SIGNATURES[entry_name])
            log.append(("launch", entry_name))
            return 0
        return launch

    monkeypatch.setattr(gv.kernels, "entry", entry)
    monkeypatch.setattr(gv.kernels, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(gv.kernels, "require_cuda", lambda *tensors: None)
    monkeypatch.setitem(gv.LAUNCHES, name, 0)
    imgs = torch.empty((2, 384, 1408), device="meta")
    meta = torch.empty((3, 2048), dtype=torch.int32, device="meta")
    args = {"whole_image": (imgs.reshape(-1, 1408),),
            "strip_sweep_flat": (imgs.reshape(-1, 1408), 2),
            "dma_only": (imgs, meta), "compact_only": (imgs, meta)}.get(name, (imgs,))
    with Record():
        out = getattr(gv, name)(*args)
    entry_name = {"strip_sweep": "vloam_sweep_sync", "strip_sweep_db": "vloam_sweep_tma_ring",
                  "strip_sweep_batched": "vloam_sweep_batched",
                  "strip_sweep_flat": "vloam_sweep_batched_flat",
                  "whole_image": "vloam_whole_image", "dma_only": "vloam_gather_dma_only",
                  "compact_only": "vloam_gather_compact_only"}[name]
    assert log == ["aten.new_empty.default", ("launch", entry_name)]
    assert tuple(out.shape) == {"whole_image": (gv.REPS,), "strip_sweep_batched": (8,),
                                "strip_sweep_flat": (8,), "dma_only": (2048, P, P),
                                "compact_only": (2048, P, P)}.get(name, (88,))
    assert gv.LAUNCHES[name] == 1


def test_kernels_per_call_counts_g2_and_g5():
    import inspect

    names = inspect.signature(tool.kernels_per_call).parameters["names"].default
    assert {"patches_pair", "patches_single", "patches_stack", "strip_sweep", "strip_sweep_db",
            "strip_sweep_batched", "strip_sweep_flat", "whole_image", "dma_only", "compact_only",
            "gather_resident", "gather_mma", "gather_resident_mma"} <= set(names)


def test_register_copies_fit_the_source():
    """G7 and B2's three forms are register copies with a warp a window:
    G7's eight warps a block hold a whole 4 KB window in flight (eight
    16-byte loads a lane, every load before the first store), and B2's eight
    warps a block (pair, single and stacked) each run the shared warp copy,
    whose lanes load 32 rows of their column before they store; B2's side is
    a compile-time 32, another side the run-time instantiation."""
    import re

    src = tool.Path(gv.kernels.SRC_DIR)
    variants = (src / "gather_variants.cu").read_text()
    patches = (src / "gather_patches.cu").read_text()
    common = (src / "gather_common.cuh").read_text()
    assert re.search(r"constexpr int kDmaWarps = 8;", variants)
    assert "constexpr int kDmaLoads = kP * kP / 4 / 32;" in variants and P * P // 4 // 32 == 8
    assert "(n2 + kDmaWarps - 1) / kDmaWarps, kDmaWarps * 32" in variants
    assert re.search(r"constexpr int kPatchWarps = 8;", patches)
    assert re.search(r"constexpr int kRowsInFlight = 32;", common)
    assert '#include "gather_common.cuh"' in patches
    assert patches.count("gather::warp_copy_window<kSide>(") == 2
    assert "p == 32 ? gather_stack_kernel<32> : gather_stack_kernel<0>" in patches
    assert "p == 32 ? gather_pair_kernel<32> : gather_pair_kernel<0>" in patches
    assert "(2 * n + kPatchWarps - 1) / kPatchWarps, kPatchWarps * 32" in patches


def test_compact_only_fits_the_source():
    """G8 is a warp a window with no shared memory: eight warps a block, all
    cutting from one band (32 keypoints a band), launched as n2 / 8 blocks, so
    the tool's 2048 keypoints give a grid that covers the H100's 132 SMs."""
    import re

    variants = (tool.Path(gv.kernels.SRC_DIR) / "gather_variants.cu").read_text()
    kernel = variants[variants.index("compact_only_kernel(const float*"):]
    kernel = kernel[:kernel.index("\n}\n")]
    warps = int(re.search(r"constexpr int kCompactWarps = (\d+);", variants).group(1))
    assert warps == 8 and gv.BLOCK_KP % warps == 0
    assert "n2 / kCompactWarps" in variants
    assert "__shared__" not in kernel
    meta = tool.make_inputs(torch.device("cpu"))[4]
    assert meta.shape[1] == 2048 and meta.shape[1] // warps >= 132
