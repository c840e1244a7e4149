"""Port parity: canonical k-mer hashes (int64 carrier) vs the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localhgt_tpu.ops import encode as jax_encode
from localhgt_tpu_torch.ops import encode


@pytest.mark.parametrize("k", [18, 20, 24, 31, 32])
def test_canonical_hashes_match_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (6, 97)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.03] = 4     # N bases
    codes[2, :] = 3                                # all-T row: extreme hashes
    masks, _ = encode.hasher_for(k, 3, seed=1)

    want_h, want_v = jax_encode.canonical_hashes(
        jnp, jnp.asarray(codes), jnp.asarray(masks), k)
    got_h, got_v = encode.canonical_hashes(
        torch.from_numpy(codes).to("cpu"), masks, k)

    want_v = np.asarray(want_v)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    want_h = np.asarray(want_h).astype(np.int64)
    assert got_h.dtype == torch.int64
    assert int(got_h.max()) < (1 << 32) and int(got_h.min()) >= 0
    # compare where the window is valid (beyond it both hold garbage)
    np.testing.assert_array_equal(
        np.where(want_v[None], got_h.numpy(), 0),
        np.where(want_v[None], want_h, 0))


def test_canonical_hashes_match_host_numpy_path():
    """The numpy formulation of the reference agrees on every position."""
    k = 32
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 5, (4, 80)).astype(np.uint8)
    masks, _ = encode.hasher_for(k, 3, seed=7)
    want_h, want_v = jax_encode.canonical_hashes(np, codes, masks, k)
    got_h, got_v = encode.canonical_hashes(torch.from_numpy(codes), masks, k)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(
        np.where(want_v[None], got_h.numpy(), 0),
        np.where(want_v[None], want_h.astype(np.int64), 0))
