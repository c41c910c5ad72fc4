"""The phi/pi SGRLD update — the hottest op in the model.

Numerics follow /root/reference/mcmc/phi.cc:84-122 (update_phi_for_node)
and :154-173 (update_pi) exactly:

  per minibatch node a with neighbors b_1..b_n:
    y_j   = [ (a, b_j) in training set ]
    f_jk  = y_j ? (beta_k - eps) : (eps - beta_k)
    e_j   = y_j ? eps : 1 - eps
    probs_jk = pi_ak * (pi_{b_j,k} * f_jk + e_j)
    grads_k  = sum_j [ (probs_jk / sum_k' probs_jk') / (pi_ak * phi_a)
                       - 1 / phi_a ]
    phi'_ak  = max(1e-24, | phi_ak + eps_t/2 (alpha - phi_ak
                              + (N/n) grads_k) + sqrt(eps_t phi_ak) xi |)
    pi'_a    = phi'_a / sum(phi'_a);  phi_a = sum(phi'_a)

where phi_ak = pi_ak * phi_a (pi rows are kept normalized alongside their
sums, /root/reference/mcmc/learner.h:53-54).

The reference offers 4 GPU schedules of this math (thread/workgroup/
shared/codegen modes); here XLA fuses the gathers and elementwise math
of this file, checked against the numpy oracle by the same
noise-disabled golden tests the reference uses (wg-phi-test.cc:116-158).

Every contraction runs at ``Precision.HIGHEST``: on GPUs XLA may
otherwise lower f32 dots to TF32 (~11 significant bits), which is not
the fp32 math of the reference.

Staged-write semantics: all reads use pre-step pi/phi; updates land in a
[B, K] staging buffer scattered back once per step — the functional
equivalent of the reference's separate phi_vec buffer + update_pi pass.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from mcmc_ammsb.config import Config
from mcmc_ammsb.ops.edgeset import EdgeSet
from mcmc_ammsb.ops.rowops import row_normalize

_PHI_FLOOR = 1e-24
_HI = jax.lax.Precision.HIGHEST


def phi_update_rows(
    cfg: Config,
    pi: jnp.ndarray,         # [N, K] normalized memberships
    phi_sum: jnp.ndarray,    # [N] row sums
    beta: jnp.ndarray,       # [K]
    edge_set: EdgeSet,       # training-edge membership
    nodes: jnp.ndarray,      # [B] int32 minibatch nodes (deduped, padded)
    neighbors: jnp.ndarray,  # [B, n] int32
    step_count: jnp.ndarray, # scalar int
    noise: jnp.ndarray,      # [B, K] N(0,1) draws (ones when disabled)
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Compute staged phi' for the minibatch rows.

    Returns (pi_rows [B, K] renormalized, sums [B]) — the caller scatters
    them with `scatter_rows`. Padded lanes produce garbage that the
    scatter drops.
    """
    cdt = phi_sum.dtype  # fp32 compute even with bf16 pi storage
    pi_n = pi[nodes].astype(cdt)              # [B, K]
    phis = phi_sum[nodes]                     # [B]
    pi_nb = pi[neighbors].astype(cdt)         # [B, n, K]
    y = edge_set.has_edges(nodes[:, None], neighbors)  # [B, n] bool
    return phi_update_core(cfg, pi_n, phis, pi_nb, y, beta, step_count,
                           noise)


def phi_update_core(
    cfg: Config,
    pi_n: jnp.ndarray,       # [B, K] gathered pi rows of the nodes
    phis: jnp.ndarray,       # [B] gathered phi sums
    pi_nb: jnp.ndarray,      # [B, n, K] gathered neighbor rows
                             # (or [1, n, K] shared across the batch)
    y: jnp.ndarray,          # [B, n] bool edge labels
    beta: jnp.ndarray,       # [K]
    step_count: jnp.ndarray,
    noise: jnp.ndarray,      # [B, K]
    nbr_mask: jnp.ndarray = None,  # [B, n] bool; False lanes excluded
                             # with a count-aware N/n_valid scale
                             # (shared-neighbor self-collisions)
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The phi math on pre-gathered rows — shared between the
    single-device gather path and the shard_map cross-chip path
    (parallel/sharded.py), which fetches rows with a masked
    gather + psum over the 'model' mesh axis."""
    eps = cfg.epsilon
    n_neighbors = cfg.num_node_sample

    # Factorized contraction (same math as the naive form, zero [B,n,K]
    # elementwise intermediates in device memory). With
    #   g_bnk = s_bn (beta_k - eps) pinb_nk + e_bn,  s = +/-1, e in {eps, 1-eps}
    # the per-neighbor likelihood is p_bn = sum_k pi_bk g_bnk
    #   = s_bn * (pi_b(beta - eps)) . pinb_n + e_bn      (pi rows sum to 1)
    # and the gradient contraction sum_n g_bnk / p_bn splits into
    #   (beta_k - eps) * sum_n (s/p) pinb_nk  +  sum_n e/p
    # — two [B,K]x[K,n]-shaped matmuls instead of streaming
    # several [B,n,K] tensors through HBM. The old form's division by
    # pi_n cancels algebraically and is gone (probs = pi_n * g).
    dtype = pi_n.dtype
    shared = pi_nb.shape[0] == 1 and pi_n.shape[0] != 1
    # beta arrives as [K] (single model) or [B, 1, K] (chain engines
    # broadcast per-chain rows); either way it is constant over n
    beta_b = beta[:, 0, :] if beta.ndim == 3 else beta      # [B|1, K]
    sgn = jnp.where(y, 1.0, -1.0).astype(dtype)             # [B, n]
    e = jnp.where(y, eps, 1.0 - eps).astype(dtype)          # [B, n]
    w = pi_n * (beta_b - eps)                               # [B, K]
    if shared:
        q = jnp.dot(w, pi_nb[0].T, precision=_HI,
                    preferred_element_type=dtype)           # [B, n]
    else:
        q = jnp.einsum("bk,bnk->bn", w, pi_nb, precision=_HI,
                       preferred_element_type=dtype)
    p = sgn * q + e                                         # [B, n]
    inv_p = 1.0 / p
    a = sgn * inv_p                                         # [B, n]
    if nbr_mask is None:
        n_valid = jnp.asarray(float(n_neighbors), dtype)
        scale_n = jnp.asarray(cfg.N / n_neighbors, dtype)
        ce = jnp.sum(e * inv_p, axis=1, keepdims=True)      # [B, 1]
    else:
        mf = nbr_mask.astype(dtype)                         # [B, n]
        a = a * mf
        ce = jnp.sum(e * inv_p * mf, axis=1, keepdims=True)
        n_valid = jnp.sum(mf, axis=1, keepdims=True)        # [B, 1]
        scale_n = cfg.N / n_valid
    if shared:
        contrib = jnp.dot(a, pi_nb[0], precision=_HI,
                          preferred_element_type=dtype)     # [B, K]
    else:
        contrib = jnp.einsum("bn,bnk->bk", a, pi_nb, precision=_HI,
                             preferred_element_type=dtype)
    s_contrib = (beta_b - eps) * contrib + ce               # [B, K]

    inv_phi = 1.0 / phis[:, None]                           # [B, 1]
    grads = (s_contrib - n_valid) * inv_phi                 # [B, K]

    eps_t = jnp.asarray(cfg.eps_t(step_count), pi_n.dtype)
    phi_k = pi_n * phis[:, None]                            # [B, K]
    phi_new = jnp.abs(
        phi_k
        + eps_t / 2.0 * (cfg.alpha_value - phi_k + scale_n * grads)
        + jnp.sqrt(eps_t * phi_k) * noise
    )
    phi_new = jnp.maximum(phi_new, _PHI_FLOOR)
    return row_normalize(phi_new)


def scatter_rows(
    pi: jnp.ndarray,
    phi_sum: jnp.ndarray,
    nodes: jnp.ndarray,      # [B] int32, padded
    node_mask: jnp.ndarray,  # [B] bool
    pi_rows: jnp.ndarray,    # [B, K]
    sums: jnp.ndarray,       # [B]
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Write staged rows back (update_pi analog, mcmc/phi.cc:154-173).

    Masked lanes are redirected to an out-of-range index and dropped —
    the node list is already deduplicated, so writes never collide
    (the reference guarantees the same via host-side dedup,
    learner.cc:162-173).
    """
    safe = jnp.where(node_mask, nodes, pi.shape[0])
    # staged rows are fp32; quantize only here when pi storage is bf16
    pi = pi.at[safe].set(pi_rows.astype(pi.dtype), mode="drop")
    phi_sum = phi_sum.at[safe].set(sums, mode="drop")
    return pi, phi_sum
