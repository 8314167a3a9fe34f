"""The port's debug visualisations (``utils/visualize``, a NumPy copy of
``vloam_tpu/utils/visualize.py``) and the driver's debug dumps.

* Every draw function gives the array the JAX package's gives on the same
  inputs (points on and off the image, masked points, NaN-free random
  depths), and ``save_png`` writes a PNG that decodes back to its array.
* ``run_synthetic`` with ``debug_dir`` and ``debug_every=2`` over five
  frames writes ``keypoints_``, ``flow_`` and ``depth_%06d.png`` for frames
  0, 2 and 4 (no flow for the first dump: no earlier dumped frame), each
  decoding to the image's shape with something drawn on it.
"""

import os

import numpy as np
import pytest
from PIL import Image

from test_torch_runtime import MC_TINY, SC_TINY, configs, few_threads  # noqa: F401
from vloam_tpu.utils import visualize as jviz
from vloam_tpu_torch.runtime import driver as tdriver
from vloam_tpu_torch.utils import visualize as tviz

H, W = 60, 90


def _inputs(rng, n=40):
    img = rng.uniform(-20, 280, (H, W)).astype(np.float32)      # clipped to 0..255
    p0 = np.stack([rng.uniform(-5, W + 5, n), rng.uniform(-5, H + 5, n)], -1)
    p1 = p0 + rng.normal(0, 6, (n, 2))
    ok = rng.random(n) < 0.7
    z = rng.uniform(-2, 90, n)
    return img, p0, p1, ok, z


@pytest.mark.parametrize("fn", ["draw_keypoints", "draw_flow", "draw_matches", "depth_colormap",
                                "draw_depth"])
def test_draw_functions_equal_reference(fn, rng):
    img, p0, p1, ok, z = _inputs(rng)
    args = {"draw_keypoints": (img, p0, ok), "draw_flow": (img, p0, p1, ok),
            "draw_matches": (img, img[::-1], p0, p1, ok), "depth_colormap": (z,),
            "draw_depth": (img, p0, z, ok)}[fn]
    want = getattr(jviz, fn)(*args)
    got = getattr(tviz, fn)(*args)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert got.any()


def test_save_png_round_trip(tmp_path, rng):
    img, p0, _, ok, _ = _inputs(rng)
    rgb = tviz.draw_keypoints(img, p0, ok)
    path = tmp_path / "k.png"
    tviz.save_png(str(path), rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), rgb)


def test_run_synthetic_writes_debug_pngs(tmp_path):
    tcfg = configs(SC_TINY, MC_TINY)[1]
    dbg = tmp_path / "dbg"
    tdriver.run_synthetic(tcfg, n_frames=5, n_azimuth=120, verbose=False, debug_dir=str(dbg),
                          debug_every=2, device="cpu")
    want = {f"{kind}_{i:06d}.png" for i in (0, 2, 4) for kind in ("keypoints", "depth")}
    want |= {f"flow_{i:06d}.png" for i in (2, 4)}
    assert set(os.listdir(dbg)) == want
    vc = tcfg.visual
    for name in want:
        arr = np.asarray(Image.open(dbg / name))
        assert arr.shape == (vc.img_height, vc.img_width, 3) and arr.dtype == np.uint8
        # green keypoints / flow, depth colours: not a plain grey image
        assert (arr[..., 0] != arr[..., 1]).any(), name
