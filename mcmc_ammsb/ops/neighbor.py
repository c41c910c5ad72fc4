"""On-device neighbor sampler.

For each minibatch node, draw ``n`` uniform random neighbor candidates
from [0, N) that are distinct and != the node itself — the role of the
reference's ``generate_random_int_kernel``, which dedups via a per-sample
open-addressing hash probed serially per thread
(/root/reference/mcmc/sample.cc:13-78).

Here: draw all candidates at once, then run a few fully
vectorized *fixup rounds* that redraw any candidate equal to the node or
to an earlier candidate in its row (an [B, n, n] lane-parallel comparison
— n is small). Each round multiplies the collision probability by
~(n/N)^2; with the default n=32 the dedup converges in 2-3 rounds and
the residual duplicate probability after ``rounds`` is negligible
(< (n^2/N)^rounds). Exact distinctness is asserted by tests at the
reference's tolerance (wg-sample-test.cc checks exact dedup for its hash
scheme; we verify no duplicates remain across the sampled rounds).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sample_neighbors(
    key: jax.Array,
    nodes: jnp.ndarray,   # [B] int32
    num_nodes: int,
    num_samples: int,     # n
    rounds: int = 4,
) -> jnp.ndarray:
    """Returns [B, n] int32 neighbor ids, distinct per row and != node."""
    b = nodes.shape[0]
    keys = jax.random.split(key, rounds + 1)
    draw = jax.random.randint(
        keys[0], (b, num_samples), 0, num_nodes, dtype=jnp.int32
    )

    def fixup(i, draw):
        eq_node = draw == nodes[:, None]
        eq_pair = draw[:, :, None] == draw[:, None, :]          # [B, n, n]
        earlier = jnp.tril(jnp.ones((num_samples, num_samples), jnp.bool_), -1)
        dup = jnp.any(eq_pair & earlier, axis=-1)               # [B, n]
        bad = eq_node | dup
        fresh = jax.random.fold_in(keys[1], i)
        redraw = jax.random.randint(
            fresh, (b, num_samples), 0, num_nodes, dtype=jnp.int32
        )
        return jnp.where(bad, redraw, draw)

    return jax.lax.fori_loop(0, rounds, fixup, draw)
