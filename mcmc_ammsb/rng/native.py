"""Native JAX RNG backend (threefry counter-based streams).

The reference provisions one xorshift128+ stream per GPU thread with the
seed law seed_i = base + i (/root/reference/mcmc/random.cc:31-44); the
equivalent here is jax.random's counter-based keys: one key per
logical purpose, folded with the step counter, giving reproducible,
order-independent streams under jit/scan/shard_map.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def key_from_seed(seed_pair) -> jax.Array:
    """Derive a jax PRNG key from the reference's (x, y) ulong2 seed."""
    x, y = seed_pair
    return jax.random.fold_in(jax.random.PRNGKey(int(x) & 0x7FFFFFFF),
                              int(y) & 0x7FFFFFFF)


def randn(key: jax.Array, shape, dtype=jnp.float32) -> jax.Array:
    return jax.random.normal(key, shape, dtype)


def gamma(key: jax.Array, shape, a: float, scale: float,
          dtype=jnp.float32) -> jax.Array:
    """Gamma(shape=a, scale) — matches std::gamma_distribution(a, scale)
    used for theta/pi init (learner.cc:150-155)."""
    return jax.random.gamma(key, a, shape, dtype) * jnp.asarray(scale, dtype)
