"""Bitonic row-sort tests (pattern of the reference's wg-sort test,
/root/reference/mcmc/algorithm/sort.cc + its CTest target: random
segments, sorted output)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_ammsb.ops.sort import bitonic_sort_rows


@pytest.mark.parametrize("n", [1, 2, 7, 32, 100, 128])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.int32])
def test_sort_matches_numpy(n, dtype):
    rng = np.random.RandomState(n)
    if dtype == jnp.float32:
        x = rng.randn(16, n).astype(np.float32)
    else:
        x = rng.randint(-1000, 1000, (16, n)).astype(np.int32)
    got = np.asarray(jax.jit(bitonic_sort_rows)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.sort(x, axis=-1))


def test_sort_descending_and_batch_dims():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 5, 33).astype(np.float32)
    got = np.asarray(jax.jit(
        lambda a: bitonic_sort_rows(a, descending=True))(jnp.asarray(x)))
    np.testing.assert_array_equal(got, -np.sort(-x, axis=-1))


def test_sort_with_duplicates_and_vmap():
    x = jnp.asarray([[3, 1, 3, 1], [2, 2, 2, 2]], jnp.int32)
    got = jax.vmap(bitonic_sort_rows)(x[None].repeat(3, 0))
    np.testing.assert_array_equal(np.asarray(got[0]),
                                  [[1, 1, 3, 3], [2, 2, 2, 2]])
