"""Row collectives: sums and normalization.

The counterparts of the reference's workgroup tree-reduction
primitives (WG_SUM / WG_NORMALIZE, /root/reference/mcmc/algorithm/
{sum,normalize}.cc). Here these are single row reductions — XLA emits
the reduction tree itself — so the
"collective" is just a jnp row op, kept standalone (and standalone-tested,
mirroring wg-sum-test.cc / wg-normalize-test.cc) because the phi/beta/ppx
kernels compose them exactly like the reference composes kernel source.
"""

from __future__ import annotations

import jax.numpy as jnp


def row_sums(x: jnp.ndarray) -> jnp.ndarray:
    """Per-row sum of a [rows, cols] matrix (WG_SUM_KERNEL_TT analog,
    /root/reference/mcmc/algorithm/sum.cc:20-42)."""
    return jnp.sum(x, axis=-1)


def row_normalize(x: jnp.ndarray):
    """Normalize each row to sum 1; returns (normalized, sums).

    Analog of WG_NORMALIZE / PartitionedNormalizer which also emits the
    row sums used as phi (/root/reference/mcmc/algorithm/normalize.cc:11-61,
    normalize.h:49-91).
    """
    s = jnp.sum(x, axis=-1, keepdims=True)
    return x / s, jnp.squeeze(s, -1)


def row_sort(x: jnp.ndarray) -> jnp.ndarray:
    """Per-row ascending sort.

    Parity of the reference's in-workgroup bitonic sort (WG_SORT_TT,
    /root/reference/mcmc/algorithm/sort.cc:9-38 — built and tested but
    unused by the training path); XLA's sort lowers to a native
    sorting kernel, so no hand-written kernel is warranted.
    """
    return jnp.sort(x, axis=-1)


def slice_normalize(x: jnp.ndarray, slice_size: int) -> jnp.ndarray:
    """Normalize a flat vector in consecutive groups of ``slice_size``.

    Analog of the reference ``Normalizer`` with a fixed slice (used with
    slice=2 to turn theta pairs into beta,
    /root/reference/mcmc/algorithm/normalize.h:17-47, beta.cc:376-383).
    """
    g = x.reshape(-1, slice_size)
    return (g / jnp.sum(g, axis=-1, keepdims=True)).reshape(x.shape)
