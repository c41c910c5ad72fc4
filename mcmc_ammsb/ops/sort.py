"""Batched in-row bitonic sort — the counterpart of the reference's
workgroup-collective sort (/root/reference/mcmc/algorithm/sort.cc:9-38,
WG_SORT_TT), which is built and tested there but not used by the
training path; the same status holds here (SURVEY.md §2 #12).

Where the reference sorts one power-of-two segment per workgroup with
a local-memory compare-exchange network, this version runs the same
bitonic network as a fixed sequence of STATIC lane permutations +
min/max selects over the last axis of a batched array — every stage is
a compile-time-constant gather that XLA lowers to vector shuffles, so
the whole network fuses into one kernel with no data-dependent control
flow. Rows sort independently (one row = one "workgroup").

For production sorting needs ``jax.lax.sort`` is the right tool; this
module exists for parity and as the building block the reference's
test exercises.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def bitonic_sort_rows(x: jnp.ndarray, descending: bool = False) -> jnp.ndarray:
    """Sort each row (last axis) of ``x`` with a bitonic network.

    Non-power-of-two rows are padded with the dtype's max (min when
    descending), sorted at the padded width, and truncated — the padding
    lanes sink to the tail, matching the reference's power-of-two
    restriction (sort.cc:14) without imposing it on callers.
    """
    n = x.shape[-1]
    if n <= 1:
        return x
    m = 1 << (n - 1).bit_length()
    if jnp.issubdtype(x.dtype, jnp.floating):
        pad_val = jnp.inf if not descending else -jnp.inf
    else:
        info = jnp.iinfo(x.dtype)
        pad_val = info.max if not descending else info.min
    if m != n:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, m - n)]
        x = jnp.pad(x, pad, constant_values=pad_val)

    idx = np.arange(m)
    k = 2
    while k <= m:
        j = k >> 1
        while j >= 1:
            partner = idx ^ j                       # static permutation
            px = x[..., partner]
            keep_small = ((idx & k) == 0) == (idx < partner)
            if descending:
                keep_small = ~keep_small
            lo = jnp.minimum(x, px)
            hi = jnp.maximum(x, px)
            x = jnp.where(jnp.asarray(keep_small), lo, hi)
            j >>= 1
        k <<= 1
    return x[..., :n]
