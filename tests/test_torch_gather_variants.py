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


def test_band_buckets(data):
    """Every bucket holds exactly the keypoints of its (image, 8-row band),
    in the callers' order."""
    _, _, _, padded, meta = data
    order, offsets = gv.band_buckets(torch.tensor(padded), torch.tensor(meta))
    n_bands = gv.n_bases(padded.shape[1])
    key = meta[0] * n_bands + meta[2] // 8
    assert offsets.shape == (2 * n_bands + 1,) and offsets[0] == 0 and offsets[-1] == 2 * N
    for b in range(2 * n_bands):
        got = order[offsets[b]:offsets[b + 1]].numpy()
        np.testing.assert_array_equal(got, np.flatnonzero(key == b))


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
