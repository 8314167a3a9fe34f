"""The port's plain patch gather (the CUDA kernel B2's plain version) against
the JAX ``gather_patches_pair`` on its CPU path (``_slice_patches``), and
its single-image and stacked launch forms against ``gather_patches`` and
``gather_patches_stack``.

The gather is an exact copy, so the arrays must be equal, at the three KLT
pyramid level sizes with N = 1024 corners (P = 32), the extreme legal
corners included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.ops.pallas_gather import gather_patches as jax_gather
from vloam_tpu.ops.pallas_gather import gather_patches_pair as jax_gather_pair
from vloam_tpu.ops.pallas_gather import gather_patches_stack as jax_gather_stack
from vloam_tpu_torch.ops import patch_gather

P, N = 32, 1024


def _inputs(rng, h, w):
    img_a = rng.uniform(0, 255, (h, w)).astype(np.float32)
    img_b = rng.uniform(0, 255, (h, w)).astype(np.float32)

    def corners():
        c = np.stack([rng.integers(0, w - P + 1, N), rng.integers(0, h - P + 1, N)], -1)
        c[:4] = [[0, 0], [w - P, 0], [0, h - P], [w - P, h - P]]
        return c.astype(np.int32)

    return img_a, img_b, corners(), corners()


@pytest.mark.parametrize("h,w", [(376, 1248), (188, 624), (94, 312)])
def test_plain_equals_jax(h, w, rng):
    img_a, img_b, ca, cb = _inputs(rng, h, w)
    want = jax_gather_pair(*(jnp.array(x) for x in (img_a, img_b, ca, cb)), P)
    got = patch_gather.gather_patches_pair(*(torch.tensor(x) for x in (img_a, img_b, ca, cb)), P)
    for g, w_ in zip(got, want):
        assert g.shape == (N, P, P)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert patch_gather.LAUNCHES == 0


@pytest.mark.parametrize("form", ["pair", "single", "stack"])
def test_launch_forms_equal_jax(form, rng):
    """The three launch forms at the ORB frontend's image size; the stack is
    a blur stack's three images."""
    img_a, img_b, ca, cb = _inputs(rng, 376, 1248)
    if form == "pair":
        want = jax_gather_pair(*(jnp.array(x) for x in (img_a, img_b, ca, cb)), P)
        got = patch_gather.gather_patches_pair(*(torch.tensor(x) for x in (img_a, img_b, ca, cb)), P)
        shape = (N, P, P)
    elif form == "single":
        want = (jax_gather(jnp.array(img_a), jnp.array(ca), P),)
        got = (patch_gather.gather_patches(torch.tensor(img_a), torch.tensor(ca), P),)
        shape = (N, P, P)
    else:
        stack = np.stack([img_a, img_b, 0.5 * (img_a + img_b)])
        want = (jax_gather_stack(jnp.array(stack), jnp.array(ca), P),)
        got = (patch_gather.gather_patches_stack(torch.tensor(stack), torch.tensor(ca), P),)
        shape = (3, N, P, P)
    for g, w_ in zip(got, want):
        assert tuple(g.shape) == shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert (patch_gather.LAUNCHES, patch_gather.LAUNCHES_SINGLE, patch_gather.LAUNCHES_STACK) \
        == (0, 0, 0)


@pytest.mark.parametrize("bad", [(-1, 0), (0, -1), (1248 - P + 1, 0), (0, 376 - P + 1)])
def test_out_of_range_corner_raises(bad, rng):
    img_a, img_b, ca, cb = _inputs(rng, 376, 1248)
    cb[7] = bad
    with pytest.raises(ValueError):
        patch_gather.gather_patches_pair_reference(
            *(torch.tensor(x) for x in (img_a, img_b, ca, cb)), P)



@pytest.mark.parametrize("form", ["pair", "single", "stack"])
def test_single_and_stack_run_nothing_before_the_launch(form, monkeypatch):
    """On the kernel's path the pair, single-image and stacked forms run no
    PyTorch operation but views and the outputs' allocation, then one launch
    of their entry (the pair's own, the stacked one for the other two), then
    a view: recorded with the library replaced by a stand-in and every
    dispatched ATen operation logged."""
    from torch.utils._python_dispatch import TorchDispatchMode

    log = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            log.append(str(func))
            return func(*args, **(kwargs or {}))

    def entry(name):
        def launch(self, *args):
            assert len(args) == len(patch_gather.kernels._SIGNATURES[name])
            log.append(name)
            return 0
        return launch

    class Lib:
        vloam_gather_patches = entry("vloam_gather_patches")
        vloam_gather_patches_stack = entry("vloam_gather_patches_stack")

    monkeypatch.setattr(patch_gather.kernels, "lib", Lib)
    monkeypatch.setattr(patch_gather.kernels, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(patch_gather.kernels, "require_cuda", lambda *tensors: None)
    for counter in ("LAUNCHES", "LAUNCHES_SINGLE", "LAUNCHES_STACK"):
        monkeypatch.setattr(patch_gather, counter, 0)
    imgs = torch.empty((3, 376, 1248), device="meta")
    corners = torch.empty((N, 2), dtype=torch.int32, device="meta")
    with Record():
        if form == "pair":
            out = patch_gather.gather_patches_pair(imgs[0], imgs[1], corners, corners, P)
        elif form == "single":
            out = patch_gather.gather_patches(imgs[0], corners)
        else:
            out = patch_gather.gather_patches_stack(imgs, corners)
    launch = "vloam_gather_patches" if form == "pair" else "vloam_gather_patches_stack"
    allocs = [op for op in log if op != launch and not op.startswith(
        ("aten.unsqueeze", "aten.select", "aten.alias", "aten.view"))]
    assert allocs == ["aten.empty.memory_format"] + (
        ["aten.empty_like.default"] if form == "pair" else [])
    assert log.count(launch) == 1 and log.index(launch) > max(log.index(op) for op in allocs)
    shapes = [tuple(o.shape) for o in (out if form == "pair" else (out,))]
    assert shapes == {"pair": [(N, P, P)] * 2, "single": [(N, P, P)],
                      "stack": [(3, N, P, P)]}[form]
    assert (patch_gather.LAUNCHES, patch_gather.LAUNCHES_SINGLE, patch_gather.LAUNCHES_STACK) == \
        {"pair": (1, 0, 0), "single": (0, 1, 0), "stack": (0, 0, 1)}[form]
