"""The port's RANSAC draw (``vloam_tpu_torch.ops.threefry``) against JAX's,
on the CPU.

* ``random_bits`` equals ``jax.random.bits(PRNGKey(seed), shape)`` bit for
  bit, at several seeds (a negative one and the largest int32 among them)
  and shapes (square, non-square, one-dimensional).
* ``select_samples`` over ``gumbel_keys`` equals the indices of
  ``lax.top_k(where(mask, jax.random.gumbel(...), -inf), 8)`` exactly, in
  order: at masked (H, N), with every match valid, and with fewer than 8
  valid matches, where the reference fills the sample with the lowest masked
  indices (its -inf ties go to the lower index) and so does the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu_torch.ops import epipolar, threefry


@pytest.mark.parametrize("seed", [0, 7, 123, -5, 2**31 - 1])
@pytest.mark.parametrize("shape", [(256, 400), (64, 1024), (3, 5), (17,)])
def test_random_bits_equal_jax(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape))
    got = threefry.random_bits(seed, shape)
    assert got.dtype == np.uint32 and got.shape == shape
    np.testing.assert_array_equal(got, want)


def _jax_samples(seed, H, mask):
    g = jax.random.gumbel(jax.random.PRNGKey(seed), (H, mask.shape[0]))
    return np.asarray(jax.lax.top_k(jnp.where(jnp.array(mask)[None, :], g, -jnp.inf), 8)[1])


@pytest.mark.parametrize("seed,H,N,p_masked", [
    (0, 256, 400, 0.3), (3, 256, 1024, 0.3), (1, 64, 37, 0.3), (9, 256, 1024, 0.0),
    (2, 16, 20, 0.8),   # 4 valid: the rest of each sample is masked indices
])
def test_selection_equals_jax_top_k(seed, H, N, p_masked):
    mask = np.random.default_rng(seed).random(N) >= p_masked
    want = _jax_samples(seed, H, mask)
    keys = torch.from_numpy(threefry.gumbel_keys(seed, H, N))
    got = threefry.select_samples(keys, torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    # what ransac_samples (the RANSAC entry's draw) selects, through the key cache
    np.testing.assert_array_equal(
        epipolar.ransac_samples(torch.from_numpy(mask), H, seed).numpy(), want)
    if mask.sum() < 8:
        assert not mask[got[:, mask.sum():]].any()


def test_keys_are_23_bit_and_cached():
    keys = threefry.gumbel_keys(4, 8, 50)
    assert keys.dtype == np.int32 and keys.min() >= 0 and keys.max() < 2**23
    a = threefry.device_keys(4, 8, 50, "cpu")
    assert threefry.device_keys(4, 8, 50, "cpu") is a
    np.testing.assert_array_equal(a.numpy(), keys)
    with pytest.raises(ValueError):
        threefry.select_samples(a[:, :5], torch.ones(5, dtype=torch.bool))
