"""The theta/beta SGRLD update.

Numerics follow the reference 4-kernel pipeline
(/root/reference/mcmc/beta.cc:30-137, launch order :334-384):

  theta_sum_k = theta_k0 + theta_k1                       (sum_theta)
  per minibatch edge (u, v) with label y = [edge in training set]:
    pp_k     = pi_uk * pi_vk
    probs_k  = (y ? beta_k : 1 - beta_k) * pp_k
    prob_0   = (y ? eps : 1 - eps) * (1 - sum_k pp_k)
    f_k      = probs_k / (sum_k' probs_k' + prob_0)
    grad_k0 += f_k * ((1 - y)/theta_k0 - 1/theta_sum_k)   (calculate_grads_
    grad_k1 += f_k * (y/theta_k1 - 1/theta_sum_k)          partial+sum_grads)
  theta'_ki = max(1e-24, | theta_ki + eps_t/2 (eta_i - theta_ki
                  + scale * grad_ki) + sqrt(eps_t theta_ki) xi_ki |)
                                                          (update_theta)
  beta_k = theta'_k1 / (theta'_k0 + theta'_k1)            (normalize slice=2,
                                                           beta.cc:376-383)

Here the per-edge partial-gradient buffers + fan-in kernel collapse
into one masked reduction over the edge axis that XLA fuses with the
elementwise math. beta reads element [2k+1] of the pair-normalized copy
(learner.cc:28-30), i.e. theta1/(theta0+theta1).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from mcmc_ammsb.config import Config
from mcmc_ammsb.ops.edgeset import EdgeSet

_THETA_FLOOR = 1e-24


def beta_gradients(
    cfg: Config,
    theta: jnp.ndarray,      # [K, 2]
    beta: jnp.ndarray,       # [K]
    pi: jnp.ndarray,         # [N, K]
    edge_set: EdgeSet,
    edges_u: jnp.ndarray,    # [E] int32 minibatch edges, padded
    edges_v: jnp.ndarray,    # [E]
    edge_mask: jnp.ndarray,  # [E] bool
) -> jnp.ndarray:
    """Masked gradient fan-in over the minibatch edges. Returns [K, 2]."""
    y = edge_set.has_edges(edges_u, edges_v)                 # [E] bool
    cdt = theta.dtype  # fp32 compute even with bf16 pi storage
    return beta_gradients_core(cfg, theta, beta,
                               pi[edges_u].astype(cdt),
                               pi[edges_v].astype(cdt), y, edge_mask)


def beta_gradients_core(
    cfg: Config,
    theta: jnp.ndarray,      # [K, 2]
    beta: jnp.ndarray,       # [K]
    pi_u: jnp.ndarray,       # [E, K] gathered rows of edge endpoint u
    pi_v: jnp.ndarray,       # [E, K] gathered rows of edge endpoint v
    y: jnp.ndarray,          # [E] bool edge labels
    edge_mask: jnp.ndarray,  # [E] bool
) -> jnp.ndarray:
    """Gradient math on pre-gathered rows (shared with the shard_map
    path, which fetches rows via masked gather + psum over 'model')."""
    eps = cfg.epsilon
    theta_sum = theta[:, 0] + theta[:, 1]                    # [K]
    pi = pi_u  # dtype carrier
    yf = y.astype(pi.dtype)
    pp = pi_u * pi_v                                         # [E, K]
    pi_sum = jnp.sum(pp, axis=-1)                            # [E]
    probs = jnp.where(y[:, None], beta, 1.0 - beta) * pp     # [E, K]
    prob_0 = jnp.where(y, eps, 1.0 - eps) * (1.0 - pi_sum)   # [E]
    probs_sum = jnp.sum(probs, axis=-1) + prob_0             # [E]
    f = probs / probs_sum[:, None]                           # [E, K]

    inv_ts = 1.0 / theta_sum                                 # [K]
    g0 = f * ((1.0 - yf)[:, None] / theta[:, 0] - inv_ts)    # [E, K]
    g1 = f * (yf[:, None] / theta[:, 1] - inv_ts)            # [E, K]
    m = edge_mask.astype(pi.dtype)[:, None]
    return jnp.stack(
        [jnp.sum(g0 * m, axis=0), jnp.sum(g1 * m, axis=0)], axis=-1
    )                                                        # [K, 2]


def theta_step(
    cfg: Config,
    theta: jnp.ndarray,       # [K, 2]
    grads: jnp.ndarray,       # [K, 2]
    scale: jnp.ndarray,       # scalar: sampling-strategy importance weight
    count_calls: jnp.ndarray, # scalar int: beta updater's own step counter
    noise: jnp.ndarray,       # [K, 2] N(0,1) draws
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """SGRLD step on theta + pairwise normalization into beta.

    Returns (theta', beta'). Matches update_theta (beta.cc:51-82): the
    eta prior enters per column (eta0 for theta[:,0], eta1 for
    theta[:,1]).
    """
    eps_t = jnp.asarray(cfg.eps_t(count_calls), theta.dtype)
    eta = jnp.asarray([cfg.eta0, cfg.eta1], theta.dtype)
    theta_new = jnp.abs(
        theta
        + eps_t / 2.0 * (eta - theta + scale * grads)
        + jnp.sqrt(eps_t * theta) * noise
    )
    theta_new = jnp.maximum(theta_new, _THETA_FLOOR)
    # ellipsis indexing: works for [K, 2] and for a leading chain axis
    beta_new = theta_new[..., 1] / (theta_new[..., 0] + theta_new[..., 1])
    return theta_new, beta_new


def update_beta(
    cfg: Config,
    theta: jnp.ndarray,
    beta: jnp.ndarray,
    pi: jnp.ndarray,
    edge_set: EdgeSet,
    edges_u: jnp.ndarray,
    edges_v: jnp.ndarray,
    edge_mask: jnp.ndarray,
    scale: jnp.ndarray,
    count_calls: jnp.ndarray,
    noise: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full beta pipeline: gradients + SGRLD step + normalize."""
    grads = beta_gradients(cfg, theta, beta, pi, edge_set,
                           edges_u, edges_v, edge_mask)
    return theta_step(cfg, theta, grads, scale, count_calls, noise)
