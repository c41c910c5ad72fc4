"""Held-out perplexity estimator.

Numerics follow /root/reference/mcmc/perplexity.cc:14-85:

  link edge:     L = sum_k pi_uk pi_vk beta_k
  non-link edge: L = sum_k pi_uk pi_vk (1 - beta_k)
                     + (1 - sum_k pi_uk pi_vk)(1 - eps)
  floored at 1e-30; folded into a per-edge running average across calls
  ppx_e <- (ppx_e * (c - 1) + L) / c   with c = call count
  result = -mean_e log(ppx_e);  the caller exponentiates
  (learner.cc:196-202).

The running per-edge average state persists across evaluations and is
checkpointed — dropping it would diverge trajectories from the reference
(SURVEY.md §7 "hard parts"). The reference's 4 Boost.Compute/Thrust
reductions (perplexity.cc:318-331) are plain masked sums fused by XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from mcmc_ammsb.config import Config
from mcmc_ammsb.ops.edgeset import EdgeSet


class PpxResult(NamedTuple):
    ppx_per_edge: jnp.ndarray   # [H] updated running averages
    neg_avg_log: jnp.ndarray    # scalar; exp() of it is the perplexity
    link_likelihood: jnp.ndarray
    non_link_likelihood: jnp.ndarray
    link_count: jnp.ndarray
    non_link_count: jnp.ndarray


def perplexity_step(
    cfg: Config,
    pi: jnp.ndarray,            # [N, K]
    beta: jnp.ndarray,          # [K]
    heldout_set: EdgeSet,       # membership => link/non-link label
    edges_u: jnp.ndarray,       # [H] evaluation edges (real + fake)
    edges_v: jnp.ndarray,       # [H]
    ppx_per_edge: jnp.ndarray,  # [H] running averages (state)
    avg_count: jnp.ndarray,     # scalar int: number of this call (1-based)
) -> PpxResult:
    y = heldout_set.has_edges(edges_u, edges_v)             # [H]
    mask = jnp.ones(edges_u.shape, jnp.bool_)
    cdt = beta.dtype  # fp32 compute even with bf16 pi storage
    return perplexity_core(cfg, pi[edges_u].astype(cdt),
                           pi[edges_v].astype(cdt), y, mask, beta,
                           ppx_per_edge, avg_count)


def perplexity_core(
    cfg: Config,
    pi_u: jnp.ndarray,          # [H, K] gathered endpoint rows
    pi_v: jnp.ndarray,          # [H, K]
    y: jnp.ndarray,             # [H] bool link labels
    mask: jnp.ndarray,          # [H] bool (False for padding lanes)
    beta: jnp.ndarray,          # [K]
    ppx_per_edge: jnp.ndarray,  # [H]
    avg_count: jnp.ndarray,
) -> PpxResult:
    """Likelihood math on pre-gathered rows (shared with the sharded
    path, which pads the held-out population to the mesh and reduces
    partial sums with psum). Padding lanes are excluded from every sum
    and keep their running-average state unchanged."""
    if pi_u.shape[-2] == 0:
        raise ValueError("empty held-out population: heldout_ratio too "
                         "small for this graph")
    eps = cfg.epsilon
    pp = pi_u * pi_v                                        # [H, K]
    pi_sum = jnp.sum(pp, axis=-1)                           # [H]
    s_link = jnp.sum(pp * beta, axis=-1)
    s_non = jnp.sum(pp * (1.0 - beta), axis=-1) + (1.0 - pi_sum) * (1.0 - eps)
    lik = jnp.maximum(jnp.where(y, s_link, s_non), 1e-30)

    dtype = pi_u.dtype
    c = avg_count.astype(dtype)
    ppx_new = (ppx_per_edge * (c - 1.0) + lik) / c
    ppx_new = jnp.where(mask, ppx_new, ppx_per_edge)
    # Padding lanes carry ppx_per_edge == 0, and 1e-38 is SUBNORMAL in
    # fp32: XLA's flush-to-zero turns log(max(0, 1e-38)) into -inf, and
    # -inf * 0-mask = NaN. Exclude masked lanes with where, not by
    # multiplying the mask in afterwards.
    lg = jnp.where(mask, jnp.log(jnp.maximum(ppx_new, 1e-30)), 0.0)

    mf = mask.astype(dtype)
    yf = y.astype(dtype) * mf
    link_lik = jnp.sum(lg * yf)
    non_link_lik = jnp.sum(lg * (mf - yf))
    link_count = jnp.sum((y & mask).astype(jnp.int32))
    non_link_count = jnp.sum(mask.astype(jnp.int32)) - link_count
    total = link_count + non_link_count
    neg_avg = -(link_lik + non_link_lik) / total.astype(dtype)
    return PpxResult(ppx_new, neg_avg, link_lik, non_link_lik,
                     link_count, non_link_count)
