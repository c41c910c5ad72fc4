"""Full (non-assortative) Mixed-Membership Stochastic Blockmodel.

A model family BEYOND the reference (which implements only the
assortative special case, SURVEY.md §0): the community interaction is a
full matrix B in [0,1]^{K x K} instead of a diagonal beta [K] with a
shared epsilon background:

    B_kl   ~ Beta(eta0, eta1)                    block link strengths
    pi_a   ~ Dirichlet(alpha 1_K)
    y_ab   ~ Bernoulli(pi_a^T B pi_b)            (memberships collapsed)

Posterior sampling is the same SGRLD scheme as the a-MMSB (expanded-
mean Gamma parameterizations): theta_B [K, K, 2] with
B = theta_B[..., 1] / theta_B.sum(-1).

Why this model suits an accelerator: the per-pair likelihood
p = pi_a^T F pi_b (F = B if linked else 1-B) makes the phi-stage inner
loop a [B*n, K] x [K, K] MATMUL, unlike the a-MMSB's purely
elementwise probs — and the theta_B gradient is a sum of
responsibility outer products, also matmul-shaped. Every contraction
runs at ``Precision.HIGHEST`` (no TF32 in the fp32 math).

Identifiability caveat (measured; tests/test_mmsb.py): without the
a-MMSB's epsilon background, the full model admits an attracting
label-symmetric plateau (pi uniform, B ~ graph density) on weakly
identified data — at reference-default step sizes SGRLD reaches the
plateau quickly (held-out perplexity ~= the coin-flip bound) but
escapes it slowly; diagonal-tilted initialization (init_mmsb_state)
helps only transiently. This is precisely the regularization argument
for the assortative variant the reference hardwires. The standard
escape levers are now first-class config knobs: ``mmsb_prior_diag``
(informative per-cell prior tilting diagonal theta_B cells),
``mmsb_noise_scale`` (SGRLD noise tempering), and longer step-size
decay via the existing a/b/c. With them the model recovers planted
partitions (tests/test_mmsb.py::test_mmsb_recovers_planted_blocks).

Update laws (derived exactly as the reference's, which exploit that p
is linear in pi_a so probs_k = pi_ak * (F pi_b)_k sums to p):

    phi:    grads_k = sum_j [ (probs_jk / p_j) / phi_ak - 1 / phi_a ]
            then the SGRLD mirror step of mcmc/phi.cc:113-121 verbatim
    theta:  r_kl = pi_ak pi_bl F_kl / p   (responsibilities)
            grad_kl0 += r_kl ((1-y)/theta_kl0 - 1/thetasum_kl)
            grad_kl1 += r_kl (y/theta_kl1 - 1/thetasum_kl)
            then the SGRLD step of mcmc/beta.cc:51-82 per (k, l)
    ppx:    link L = pi_a^T B pi_b; non-link L = pi_a^T (1-B) pi_b
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_ammsb.config import Config
from mcmc_ammsb.data import DataSplit, Graph
from mcmc_ammsb.learner import DeviceBatch
from mcmc_ammsb.ops.edgeset import EdgeSet, build_edge_set
from mcmc_ammsb.ops.neighbor import sample_neighbors
from mcmc_ammsb.ops.rowops import row_normalize
from mcmc_ammsb.rng import native as native_rng
from mcmc_ammsb.sampling import MiniBatchSampler
from mcmc_ammsb.utils.timing import StageTimers

_FLOOR = 1e-24
_HI = jax.lax.Precision.HIGHEST


class MMSBState(NamedTuple):
    pi: jnp.ndarray            # [N, K]
    phi_sum: jnp.ndarray       # [N]
    theta_b: jnp.ndarray       # [K, K, 2]
    b: jnp.ndarray             # [K, K]
    step_count: jnp.ndarray
    theta_count: jnp.ndarray
    ppx_per_edge: jnp.ndarray  # [H]
    ppx_count: jnp.ndarray
    phi_key: jax.Array
    theta_key: jax.Array
    neighbor_key: jax.Array
    sample_key: jax.Array      # device-sampling stream


def init_mmsb_state(cfg: Config, heldout_size: int,
                    dtype=jnp.float32) -> MMSBState:
    from mcmc_ammsb.learner import chunked_gamma_rows

    root = native_rng.key_from_seed((cfg.init_seed & 0xFFFFFFFF,
                                     cfg.init_seed >> 32))
    k_theta, k_pi = jax.random.split(root)
    theta_b = native_rng.gamma(k_theta, (cfg.K, cfg.K, 2), cfg.eta0,
                               cfg.eta1, dtype)
    # undirected graphs: B is symmetric. theta starts symmetric here and
    # the gradient + noise are symmetrized each step (mmsb_theta_grads /
    # mmsb_train_step), so it stays exactly symmetric — one consistent
    # likelihood per unordered pair regardless of orientation.
    theta_b = 0.5 * (theta_b + theta_b.transpose(1, 0, 2))
    # break the label-symmetry saddle (pi uniform + B ~ density) with a
    # diagonal tilt at init — the full model has no epsilon background
    # forcing assortativity, so without it SGRLD can stall at the
    # uninformative fixed point on weakly-identified data
    diag_boost = 1.0 + 2.0 * jnp.eye(cfg.K, dtype=dtype)
    theta_b = theta_b.at[..., 1].mul(diag_boost)
    b = theta_b[..., 1] / theta_b.sum(-1)
    # chunked rows: one-shot gamma at N*K >= ~300M would OOM (see
    # learner.init_state)
    phi_raw = chunked_gamma_rows(cfg, k_pi, dtype)
    phi_sum = phi_raw.sum(-1)
    return MMSBState(
        pi=phi_raw / phi_sum[:, None],
        phi_sum=phi_sum,
        theta_b=theta_b,
        b=b,
        step_count=jnp.asarray(1, jnp.int32),
        theta_count=jnp.asarray(0, jnp.int32),
        ppx_per_edge=jnp.zeros(heldout_size, dtype),
        ppx_count=jnp.asarray(0, jnp.int32),
        phi_key=native_rng.key_from_seed(cfg.phi_seed),
        theta_key=native_rng.key_from_seed(cfg.beta_seed),
        neighbor_key=native_rng.key_from_seed(cfg.neighbor_seed),
        sample_key=native_rng.key_from_seed((cfg.sample_seed, 0x5A)),
    )


def mmsb_phi_rows(cfg: Config, pi, phi_sum, b, edge_set, nodes,
                  neighbors, step_count, noise):
    """Staged phi' rows. The inner product over communities is
    g = F @ pi_b — a matmul over the [B*n, K] neighbor batch."""
    y = edge_set.has_edges(nodes[:, None], neighbors)  # [B, n]
    return _phi_rows_core(cfg, pi[nodes], phi_sum[nodes], b,
                          pi[neighbors], y, step_count, noise)


def _phi_rows_core(cfg: Config, pi_n, phis, b, pi_nb, y,
                   step_count, noise):
    """phi math on pre-gathered rows (pi_n [B,K], phis [B], pi_nb
    [B,n,K]) with membership labels precomputed (hoisted scan; the
    pre-gathered contract also lets the chain engine vmap this core
    over a chain axis)."""
    n_nb = cfg.num_node_sample

    flat_nb = pi_nb.reshape(-1, cfg.K)
    g_link = jnp.dot(flat_nb, b.T, precision=_HI,
                     preferred_element_type=jnp.float32)
    # (1-B) pi_b = rowsum(pi_b) - B pi_b; pi rows are normalized, so the
    # non-link contraction is free given the link one (one matmul, not two)
    g_non = flat_nb.sum(-1, keepdims=True) - g_link
    g = jnp.where(y.reshape(-1, 1), g_link, g_non).reshape(pi_nb.shape)

    probs = pi_n[:, None, :] * g                       # [B, n, K]
    p = jnp.sum(probs, axis=-1, keepdims=True)         # [B, n, 1]
    inv_phi = 1.0 / phis[:, None]
    grads = (jnp.sum(probs / p, axis=1) / pi_n * inv_phi
             - n_nb * inv_phi)

    eps_t = jnp.asarray(cfg.eps_t(step_count), pi_n.dtype)
    phi_k = pi_n * phis[:, None]
    phi_new = jnp.abs(
        phi_k
        + eps_t / 2.0 * (cfg.alpha_value - phi_k
                         + (cfg.N / n_nb) * grads)
        + jnp.sqrt(eps_t * phi_k) * noise)
    return row_normalize(jnp.maximum(phi_new, _FLOOR))


def _phi_rows_core_shared(cfg: Config, pi_n, phis, b, pi_nb,
                          y, nbr_mask, step_count, noise):
    """Shared-draw phi math: ONE n-neighbor set for the whole minibatch
    (pi_nb [n, K]), factorized so no [B, n, K] tensor exists — the
    full-B analog of the a-MMSB factorization (ops/phi.py):

        g_jk    = y_bj ? (B pi_b_j)_k : ((1-B) pi_b_j)_k
        p_bj    = pi_b . g_j  ->  y ? (pi_n G_link^T) : (pi_n G_non^T)
        grads_k = (sum_j g_jk / p_bj - n_valid) / phi_b

    four matmuls total ([n,K]x[K,K] once, then three [B,n]-shaped),
    with self-collision lanes excluded via the count-aware N/n_valid
    scale exactly like the a-MMSB shared path. Operates on
    pre-gathered rows (pi_n [B,K], phis [B]) so the chain engine can
    vmap it over a chain axis."""
    dtype = pi_n.dtype
    g_link = jnp.dot(pi_nb, b.T, precision=_HI,
                     preferred_element_type=jnp.float32)   # [n, K]
    # (1-B) pi_b = rowsum(pi_b) - B pi_b (rows are normalized)
    g_non = pi_nb.sum(-1, keepdims=True) - g_link
    p_link = jnp.dot(pi_n, g_link.T, precision=_HI,
                     preferred_element_type=jnp.float32)   # [B, n]
    p_non = jnp.dot(pi_n, g_non.T, precision=_HI,
                    preferred_element_type=jnp.float32)
    yf = y.astype(dtype)                               # [B, n]
    p = jnp.where(y, p_link, p_non)
    inv_p = 1.0 / p
    mf = nbr_mask.astype(dtype)                        # [B, n]
    w_link = yf * inv_p * mf
    w_non = (1.0 - yf) * inv_p * mf
    s = (jnp.dot(w_link, g_link, precision=_HI,
                 preferred_element_type=jnp.float32)
         + jnp.dot(w_non, g_non, precision=_HI,
                   preferred_element_type=jnp.float32))    # [B, K]
    n_valid = mf.sum(-1, keepdims=True)                # [B, 1]
    inv_phi = 1.0 / phis[:, None]
    grads = (s - n_valid) * inv_phi

    eps_t = jnp.asarray(cfg.eps_t(step_count), dtype)
    phi_k = pi_n * phis[:, None]
    phi_new = jnp.abs(
        phi_k
        + eps_t / 2.0 * (cfg.alpha_value - phi_k
                         + (cfg.N / n_valid) * grads)
        + jnp.sqrt(eps_t * phi_k) * noise)
    return row_normalize(jnp.maximum(phi_new, _FLOOR))


def mmsb_theta_grads(cfg: Config, theta_b, b, pi, edge_set,
                     eu, ev, mask):
    """Responsibility outer-product fan-in. Returns [K, K, 2]."""
    y = edge_set.has_edges(eu, ev)                     # [E]
    return _theta_grads_core(cfg, theta_b, b, pi[eu], pi[ev], y, mask)


def _theta_grads_core(cfg: Config, theta_b, b, pi_u, pi_v, y, mask):
    """Gradient math on pre-gathered rows + precomputed labels."""
    pi = pi_u  # dtype carrier
    f = jnp.where(y[:, None, None], b, 1.0 - b)        # [E, K, K]
    outer = pi_u[:, :, None] * pi_v[:, None, :]        # [E, K, K]
    num = outer * f
    p = jnp.sum(num, axis=(1, 2), keepdims=True)
    r = num / p                                        # [E, K, K]
    theta_sum = theta_b.sum(-1)                        # [K, K]
    inv_ts = 1.0 / theta_sum
    yf = y.astype(pi.dtype)[:, None, None]
    g0 = r * ((1.0 - yf) / theta_b[..., 0] - inv_ts)
    g1 = r * (yf / theta_b[..., 1] - inv_ts)
    m = mask.astype(pi.dtype)[:, None, None]
    g = jnp.stack([(g0 * m).sum(0), (g1 * m).sum(0)], axis=-1)
    # undirected graphs: B is symmetric; averaging the gradient with its
    # transpose is processing each edge in both orientations
    return 0.5 * (g + g.transpose(1, 0, 2))


def mmsb_theta_step(cfg: Config, theta_b, grads, scale, count, noise):
    eps_t = jnp.asarray(cfg.eps_t(count), theta_b.dtype)
    eta = jnp.asarray([cfg.eta0, cfg.eta1], theta_b.dtype)
    if cfg.mmsb_prior_diag is not None:
        # informative per-cell prior: diagonal cells pull toward the
        # assortative regime, the identifiability lever the a-MMSB gets
        # for free from its epsilon background
        eye = jnp.eye(cfg.K, dtype=bool)[..., None]
        eta = jnp.where(eye, jnp.asarray(cfg.mmsb_prior_diag,
                                         theta_b.dtype), eta)
    theta_new = jnp.abs(
        theta_b + eps_t / 2.0 * (eta - theta_b + scale * grads)
        + jnp.sqrt(eps_t * theta_b) * noise)
    theta_new = jnp.maximum(theta_new, _FLOOR)
    b_new = theta_new[..., 1] / theta_new.sum(-1)
    return theta_new, b_new


def _symmetrize_noise(cfg: Config, t_noise: jnp.ndarray) -> jnp.ndarray:
    """Symmetric theta noise keeps theta_b exactly symmetric: the upper
    triangle is the true parameter set. Off-diagonal pairs are tied
    ((xi + xi^T)/sqrt(2) restores unit marginal variance); diagonal
    entries keep their own draw (variance would double otherwise)."""
    sym = (t_noise + t_noise.transpose(1, 0, 2)) / jnp.sqrt(2.0)
    eye = jnp.eye(cfg.K, dtype=bool)[..., None]
    return jnp.where(eye, t_noise, sym)


def mmsb_train_step(cfg: Config, edge_set: EdgeSet, state: MMSBState,
                    batch: DeviceBatch) -> MMSBState:
    step = state.step_count
    k_nbr = jax.random.fold_in(state.neighbor_key, step)
    neighbors = sample_neighbors(k_nbr, batch.nodes, cfg.N,
                                 cfg.num_node_sample)
    b_nodes = batch.nodes.shape[0]
    if cfg.phi_disable_noise:
        noise = jnp.ones((b_nodes, cfg.K), state.pi.dtype)
    else:
        noise = native_rng.randn(
            jax.random.fold_in(state.phi_key, step),
            (b_nodes, cfg.K), state.pi.dtype)
        if cfg.mmsb_noise_scale != 1.0:
            noise = noise * cfg.mmsb_noise_scale
    rows, sums = mmsb_phi_rows(cfg, state.pi, state.phi_sum, state.b,
                               edge_set, batch.nodes, neighbors, step,
                               noise)
    safe = jnp.where(batch.node_mask, batch.nodes, cfg.N)
    pi = state.pi.at[safe].set(rows, mode="drop")
    phi_sum = state.phi_sum.at[safe].set(sums, mode="drop")

    count = state.theta_count + 1
    t_noise = native_rng.randn(
        jax.random.fold_in(state.theta_key, step),
        (cfg.K, cfg.K, 2), state.pi.dtype)
    t_noise = _symmetrize_noise(cfg, t_noise)
    if cfg.mmsb_noise_scale != 1.0:
        t_noise = t_noise * cfg.mmsb_noise_scale
    grads = mmsb_theta_grads(cfg, state.theta_b, state.b, pi, edge_set,
                             batch.edges_u, batch.edges_v,
                             batch.edge_mask)
    theta_b, b = mmsb_theta_step(cfg, state.theta_b, grads,
                                 batch.weight, count, t_noise)
    return state._replace(pi=pi, phi_sum=phi_sum, theta_b=theta_b, b=b,
                          step_count=step + 1, theta_count=count)


def mmsb_perplexity(cfg: Config, heldout_set: EdgeSet, eu, ev,
                    state: MMSBState):
    count = state.ppx_count + 1
    y = heldout_set.has_edges(eu, ev)
    pi_u = state.pi[eu]
    pi_v = state.pi[ev]
    link = jnp.einsum("ek,kl,el->e", pi_u, state.b, pi_v, precision=_HI)
    # pi rows normalized: sum_kl pi_u (1-B) pi_v = 1 - link
    non = 1.0 - link
    lik = jnp.maximum(jnp.where(y, link, non), 1e-30)
    c = count.astype(pi_u.dtype)
    ppx_new = (state.ppx_per_edge * (c - 1.0) + lik) / c
    neg_avg = -jnp.mean(jnp.log(ppx_new))
    state = state._replace(ppx_per_edge=ppx_new, ppx_count=count)
    return state, neg_avg


def mmsb_steps_scan(cfg: Config, edge_set: EdgeSet, state: MMSBState,
                    batches: DeviceBatch) -> MMSBState:
    """Scan with the same state-independent hoisting as the a-MMSB
    (learner.train_steps_scan; measured 2x there): neighbor draws,
    noise, and membership labels for all S steps are produced in one
    vectorized block before the loop. ``cfg.window`` is ignored: the
    full model has no windowed engine."""
    s_len, b_sz = batches.nodes.shape
    steps = state.step_count + jnp.arange(s_len, dtype=jnp.int32)

    nbr_keys = jax.vmap(
        lambda s: jax.random.fold_in(state.neighbor_key, s))(steps)
    if cfg.shared_neighbors:
        # one shared n-draw per step (unbiased per node; the a-MMSB
        # fast path's estimator, _phi_rows_core_shared)
        sentinel = jnp.full((1,), cfg.N, jnp.int32)
        neighbors = jax.vmap(lambda k: sample_neighbors(
            k, sentinel, cfg.N, cfg.num_node_sample))(nbr_keys)[:, 0]
        # [S, n]
        y_phi = edge_set.has_edges(batches.nodes[:, :, None],
                                   neighbors[:, None, :])   # [S,B,n]
    else:
        neighbors = jax.vmap(
            lambda k, nd: sample_neighbors(k, nd, cfg.N,
                                           cfg.num_node_sample)
        )(nbr_keys, batches.nodes)
        y_phi = edge_set.has_edges(batches.nodes[:, :, None], neighbors)
    if cfg.phi_disable_noise:
        phi_noise = jnp.ones((s_len, b_sz, cfg.K), state.pi.dtype)
    else:
        phi_noise = jax.vmap(lambda s: native_rng.randn(
            jax.random.fold_in(state.phi_key, s), (b_sz, cfg.K),
            state.pi.dtype))(steps)
        if cfg.mmsb_noise_scale != 1.0:
            phi_noise = phi_noise * cfg.mmsb_noise_scale
    t_noise = jax.vmap(lambda s: _symmetrize_noise(cfg, native_rng.randn(
        jax.random.fold_in(state.theta_key, s), (cfg.K, cfg.K, 2),
        state.pi.dtype)))(steps)
    if cfg.mmsb_noise_scale != 1.0:
        t_noise = t_noise * cfg.mmsb_noise_scale
    y_edges = edge_set.has_edges(batches.edges_u, batches.edges_v)
    def body(s: MMSBState, xs):
        batch, nbrs, y_n, n_phi, n_theta, y_e = xs
        if cfg.shared_neighbors:
            # self-collision mask is a trivial in-body recompute — no
            # need to stream an [S,B,n] operand through the scan
            nm = nbrs[None, :] != batch.nodes[:, None]
            rows, sums = _phi_rows_core_shared(
                cfg, s.pi[batch.nodes], s.phi_sum[batch.nodes], s.b,
                s.pi[nbrs], y_n, nm, s.step_count, n_phi)
        else:
            rows, sums = _phi_rows_core(
                cfg, s.pi[batch.nodes], s.phi_sum[batch.nodes], s.b,
                s.pi[nbrs], y_n, s.step_count, n_phi)
        safe = jnp.where(batch.node_mask, batch.nodes, cfg.N)
        pi = s.pi.at[safe].set(rows, mode="drop")
        phi_sum = s.phi_sum.at[safe].set(sums, mode="drop")
        count = s.theta_count + 1
        grads = _theta_grads_core(cfg, s.theta_b, s.b, pi[batch.edges_u],
                                  pi[batch.edges_v], y_e,
                                  batch.edge_mask)
        theta_b, b = mmsb_theta_step(cfg, s.theta_b, grads, batch.weight,
                                     count, n_theta)
        return s._replace(pi=pi, phi_sum=phi_sum, theta_b=theta_b, b=b,
                          step_count=s.step_count + 1,
                          theta_count=count), None

    xs = (batches, neighbors, y_phi, phi_noise, t_noise, y_edges)
    state, _ = jax.lax.scan(body, state, xs, unroll=cfg.scan_unroll)
    return state


def mmsb_steps_fused(cfg: Config, edge_set: EdgeSet,
                     heldout_set: EdgeSet, state: MMSBState,
                     num_steps: int, adjacency=None) -> MMSBState:
    """Fully-fused MMSB loop: minibatches for the whole chunk drawn ON
    DEVICE (the sampler is model-agnostic — learner.train_steps_fused's
    structure), then mmsb_steps_scan consumes them."""
    from mcmc_ammsb.ops.device_sampling import sample_minibatches_device

    chunk_key = jax.random.fold_in(state.sample_key, state.step_count)
    ds = sample_minibatches_device(cfg, edge_set, heldout_set,
                                   chunk_key, num_steps, adjacency)
    batches = DeviceBatch(ds.edges_u, ds.edges_v, ds.edge_mask,
                          ds.nodes, ds.node_mask, ds.weight)
    return mmsb_steps_scan(cfg, edge_set, state, batches)


def mmsb_steps_fused_ppx(cfg: Config, edge_set: EdgeSet,
                         heldout_set: EdgeSet, state: MMSBState,
                         eu: jnp.ndarray, ev: jnp.ndarray,
                         num_evals: int, interval: int,
                         adjacency=None):
    """num_evals x (interval fused MMSB steps + one eval) in one
    dispatch (learner.train_steps_fused_ppx's structure). Returns
    (state, neg_avg_log [num_evals])."""
    def outer(s: MMSBState, _):
        s = mmsb_steps_fused(cfg, edge_set, heldout_set, s, interval,
                             adjacency)
        return mmsb_perplexity(cfg, heldout_set, eu, ev, s)

    return jax.lax.scan(outer, state, None, length=num_evals)


class FullMMSBLearner:
    """Orchestrator for the full-B MMSB (mirrors learner.Learner)."""

    def __init__(self, cfg: Config, graph: Graph, split: DataSplit):
        if cfg.pi_dtype != "float32":
            raise ValueError("the full-MMSB family keeps pi in fp32; "
                             "pi_dtype=bfloat16 is a-MMSB single-chip "
                             "only")
        self.cfg = cfg
        self.graph = graph
        self.split = split
        self.training_set = build_edge_set(
            cfg.edgeset_backend, cfg.N, graph.edges_u, graph.edges_v)
        self.heldout_set = build_edge_set(
            cfg.edgeset_backend, cfg.N, split.heldout_u, split.heldout_v)
        self.heldout_u = jnp.asarray(split.heldout_edges_u)
        self.heldout_v = jnp.asarray(split.heldout_edges_v)
        self.state = init_mmsb_state(cfg, len(split.heldout_edges_u))
        self.sampler = MiniBatchSampler(cfg, graph, split)
        self.adjacency = (jnp.asarray(graph.offsets, jnp.int32),
                          jnp.asarray(graph.cols, jnp.int32))
        self.timers = StageTimers()
        self._scan = jax.jit(partial(mmsb_steps_scan, cfg),
                             donate_argnums=(1,))
        self._fused = jax.jit(partial(mmsb_steps_fused, cfg),
                              static_argnames="num_steps",
                              donate_argnums=(2,))
        self._fused_ppx = jax.jit(
            partial(mmsb_steps_fused_ppx, cfg),
            static_argnames=("num_evals", "interval"),
            donate_argnums=(2,))
        self._ppx = jax.jit(partial(mmsb_perplexity, cfg),
                            donate_argnums=(3,))

    def run(self, max_iters: int) -> None:
        spc = max(1, self.cfg.steps_per_call)
        with self.timers.stage("total"):
            done = 0
            while done < max_iters:
                take = min(spc, max_iters - done)
                if self.cfg.device_sampling:
                    with self.timers.stage("device_step"):
                        self.state = self._fused(
                            self.training_set, self.heldout_set,
                            self.state, num_steps=take,
                            adjacency=self.adjacency)
                else:
                    with self.timers.stage("sampling"):
                        stacked = self.sampler.sample_many(take)
                        batches = DeviceBatch.from_stacked(stacked)
                    with self.timers.stage("device_step"):
                        self.state = self._scan(self.training_set,
                                                self.state, batches)
                done += take
            int(self.state.step_count)  # fence inside the timer

    def run_with_ppx(self, max_iters: int, interval: int):
        """Fused eval series (Learner.run_with_ppx contract, scalar
        ppx per eval). Requires cfg.device_sampling."""
        if not self.cfg.device_sampling:
            raise RuntimeError("run_with_ppx requires device_sampling")
        from mcmc_ammsb.learner import run_fused_eval_series

        spc = max(1, self.cfg.steps_per_call)

        def dispatch(take):
            self.state, neg = self._fused_ppx(
                self.training_set, self.heldout_set, self.state,
                self.heldout_u, self.heldout_v,
                num_evals=take, interval=interval,
                adjacency=self.adjacency)
            # device array; the pipelined driver materializes it
            # (jnp.exp: heldout_perplexity exps with XLA too)
            return jnp.exp(neg)

        def tail(t):
            with self.timers.stage("device_step"):
                self.state = self._fused(
                    self.training_set, self.heldout_set, self.state,
                    num_steps=t, adjacency=self.adjacency)
            int(self.state.step_count)  # fence

        return run_fused_eval_series(
            self.timers, spc, max_iters, interval, dispatch,
            lambda: int(self.state.step_count),
            lambda pv, i, step: {"step": step, "ppx": float(pv[i])},
            tail)

    def heldout_perplexity(self) -> float:
        with self.timers.stage("ppx"):
            self.state, neg = self._ppx(
                self.heldout_set, self.heldout_u, self.heldout_v,
                self.state)
            return float(jnp.exp(neg))

    def print_stats(self, log=print) -> None:
        self.timers.print_table(log)

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Multi-chain engine: C independent full-MMSB chains in one fused
# program, flat row layout (the chains_flat.py formulation applied to
# the full-B family — pi [C*N, K] with chain c's node u at row c*N+u so
# the hot scatter/gather stays a plain 1-D-index op; per-chain theta_B
# [C, K, K, 2] carried by vmapping the pre-gathered-row cores).
# ---------------------------------------------------------------------------


class MMSBChainState(NamedTuple):
    pi: jnp.ndarray            # [C*N, K]
    phi_sum: jnp.ndarray       # [C*N]
    theta_b: jnp.ndarray       # [C, K, K, 2]
    b: jnp.ndarray             # [C, K, K]
    step_count: jnp.ndarray    # scalar (chains advance in lockstep)
    theta_count: jnp.ndarray
    ppx_per_edge: jnp.ndarray  # [C, H]
    ppx_count: jnp.ndarray
    phi_key: jax.Array
    theta_key: jax.Array
    neighbor_key: jax.Array
    sample_key: jax.Array


def _mmsb_chains_chunk(cfg: Config, num_chains: int, edge_set: EdgeSet,
                       heldout_set: EdgeSet, adjacency,
                       state: MMSBChainState,
                       num_steps: int) -> MMSBChainState:
    """Advance all chains num_steps in one fused program (the
    chains_flat._chunk structure with the full-B cores)."""
    from mcmc_ammsb.ops.device_sampling import sample_minibatches_device

    c = num_chains
    n_rows = cfg.N
    e_cap, b_cap = cfg.max_batch_edges, cfg.max_batch_nodes
    s_len = num_steps
    k = cfg.K

    chunk_key = jax.random.fold_in(state.sample_key, state.step_count)
    with jax.named_scope("device_sampling"):
        ds = sample_minibatches_device(cfg, edge_set, heldout_set,
                                       chunk_key, s_len * c, adjacency,
                                       alt_period=c)

    def r(x, cap):
        return x.reshape(s_len, c, cap, *x.shape[2:])

    nodes = r(ds.nodes, b_cap)           # [S,C,B] (sentinel = N)
    node_mask = r(ds.node_mask, b_cap)
    eu = r(ds.edges_u, e_cap)
    ev = r(ds.edges_v, e_cap)
    emask = r(ds.edge_mask, e_cap)
    weight = ds.weight.reshape(s_len, c)

    steps = state.step_count + jnp.arange(s_len, dtype=jnp.int32)
    nbr_keys = jax.vmap(
        lambda s: jax.random.fold_in(state.neighbor_key, s))(steps)
    if cfg.shared_neighbors:
        # one n-draw per (step, chain): chains keep independent
        # streams (R-hat validity); within a chain every node reads
        # the same set — the unbiased shared estimator
        sentinel = jnp.full((c,), cfg.N, jnp.int32)
        with jax.named_scope("neighbor_draws"):
            neighbors = jax.vmap(lambda key: sample_neighbors(
                key, sentinel, cfg.N, cfg.num_node_sample))(nbr_keys)
            # [S, C, n] chain-local ids
        with jax.named_scope("membership"):
            y_phi = edge_set.has_edges(
                nodes[..., None], neighbors[:, :, None, :])  # [S,C,B,n]
    else:
        flat_nodes_all = nodes.reshape(s_len, c * b_cap)
        with jax.named_scope("neighbor_draws"):
            neighbors = jax.vmap(lambda key, nd: sample_neighbors(
                key, nd, cfg.N, cfg.num_node_sample))(
                nbr_keys, flat_nodes_all)     # [S, C*B, n]
        with jax.named_scope("membership"):
            y_phi = edge_set.has_edges(
                flat_nodes_all[:, :, None], neighbors
            ).reshape(s_len, c, b_cap, -1)                   # [S,C,B,n]
    with jax.named_scope("noise"):
        if cfg.phi_disable_noise:
            phi_noise = jnp.ones((s_len, c, b_cap, k), jnp.float32)
        else:
            phi_noise = jax.vmap(lambda s: native_rng.randn(
                jax.random.fold_in(state.phi_key, s),
                (c, b_cap, k)))(steps)
            if cfg.mmsb_noise_scale != 1.0:
                phi_noise = phi_noise * cfg.mmsb_noise_scale
        t_noise = jax.vmap(lambda s: jax.vmap(
            partial(_symmetrize_noise, cfg))(native_rng.randn(
                jax.random.fold_in(state.theta_key, s),
                (c, k, k, 2))))(steps)                      # [S,C,K,K,2]
        if cfg.mmsb_noise_scale != 1.0:
            t_noise = t_noise * cfg.mmsb_noise_scale
    with jax.named_scope("membership"):
        y_edges = edge_set.has_edges(eu, ev)   # [S,C,E]

    # chain row offsets; sentinel rows (id == N) map to the global
    # sentinel C*N so they never collide with another chain's row 0
    offsets = (jnp.arange(c, dtype=jnp.int32) * n_rows)[:, None]  # [C,1]

    def body(st: MMSBChainState, xs):
        (nodes_s, nmask_s, eu_s, ev_s, emask_s, w_s,
         nbrs_s, y_n, n_phi, n_theta, y_e) = xs
        flat_nodes = jnp.where(nodes_s < n_rows, nodes_s + offsets,
                               c * n_rows).reshape(-1)       # [C*B]
        flat_mask = nmask_s.reshape(-1)
        with jax.named_scope("pi_gather"):
            pi_n = st.pi[flat_nodes].reshape(c, b_cap, k)
            phis = st.phi_sum[flat_nodes].reshape(c, b_cap)
            if cfg.shared_neighbors:
                pi_nb = st.pi[nbrs_s + offsets]              # [C, n, K]
            else:
                flat_nbrs = (nbrs_s.reshape(c, b_cap, -1)
                             + offsets[:, :, None])
                pi_nb = st.pi[flat_nbrs]                 # [C, B, n, K]
        with jax.named_scope("phi_update"):
            if cfg.shared_neighbors:
                nm = nbrs_s[:, None, :] != nodes_s[..., None]  # [C,B,n]
                rows_c, sums_c = jax.vmap(
                    lambda pn, ps, bb, pnb, yy, mm, nz:
                    _phi_rows_core_shared(cfg, pn, ps, bb, pnb, yy, mm,
                                          st.step_count, nz)
                )(pi_n, phis, st.b, pi_nb, y_n, nm, n_phi)
            else:
                rows_c, sums_c = jax.vmap(
                    lambda pn, ps, bb, pnb, yy, nz:
                    _phi_rows_core(cfg, pn, ps, bb, pnb, yy,
                                   st.step_count, nz)
                )(pi_n, phis, st.b, pi_nb, y_n, n_phi)
            rows = rows_c.reshape(c * b_cap, k)
            sums = sums_c.reshape(-1)
        with jax.named_scope("pi_scatter"):
            safe = jnp.where(flat_mask, flat_nodes, c * n_rows)
            pi = st.pi.at[safe].set(rows, mode="drop")
            phi_sum = st.phi_sum.at[safe].set(sums, mode="drop")
        count = st.theta_count + 1
        with jax.named_scope("theta_grads"):
            flat_eu = (eu_s + offsets).reshape(-1)
            flat_ev = (ev_s + offsets).reshape(-1)
            pi_u = pi[flat_eu].reshape(c, e_cap, k)
            pi_v = pi[flat_ev].reshape(c, e_cap, k)
            grads = jax.vmap(
                lambda tb, bb, pu, pv, yy, mm:
                _theta_grads_core(cfg, tb, bb, pu, pv, yy, mm)
            )(st.theta_b, st.b, pi_u, pi_v, y_e, emask_s)
        with jax.named_scope("theta_update"):
            theta_b, b = jax.vmap(
                lambda tb, g, w, nz:
                mmsb_theta_step(cfg, tb, g, w, count, nz)
            )(st.theta_b, grads, w_s, n_theta)
        return st._replace(
            pi=pi, phi_sum=phi_sum, theta_b=theta_b, b=b,
            step_count=st.step_count + 1, theta_count=count), None

    state, _ = jax.lax.scan(
        body, state,
        (nodes, node_mask, eu, ev, emask, weight, neighbors, y_phi,
         phi_noise, t_noise, y_edges),
        unroll=cfg.scan_unroll)
    return state


def _mmsb_chains_ppx(cfg: Config, num_chains: int, heldout_set: EdgeSet,
                     eu: jnp.ndarray, ev: jnp.ndarray,
                     state: MMSBChainState):
    """Per-chain perplexity over the shared heldout population."""
    c = num_chains
    h = eu.shape[0]
    k = cfg.K
    count = state.ppx_count + 1
    y = heldout_set.has_edges(eu, ev)                        # [H]
    offsets = (jnp.arange(c, dtype=jnp.int32) * cfg.N)[:, None]
    pi_u = state.pi[(eu[None, :] + offsets).reshape(-1)].reshape(c, h, k)
    pi_v = state.pi[(ev[None, :] + offsets).reshape(-1)].reshape(c, h, k)
    link = jnp.einsum("chk,ckl,chl->ch", pi_u, state.b, pi_v,
                      precision=_HI)
    non = 1.0 - link     # pi rows normalized: pi_u (1-B) pi_v = 1-link
    lik = jnp.maximum(jnp.where(y[None, :], link, non), 1e-30)
    cnt = count.astype(pi_u.dtype)
    ppx_new = (state.ppx_per_edge * (cnt - 1.0) + lik) / cnt   # [C,H]
    neg_avg = -jnp.mean(jnp.log(ppx_new), axis=-1)             # [C]
    state = state._replace(ppx_per_edge=ppx_new, ppx_count=count)
    return state, neg_avg


def _mmsb_chains_chunk_ppx(cfg: Config, num_chains: int,
                           edge_set: EdgeSet, heldout_set: EdgeSet,
                           adjacency, eu, ev, state: MMSBChainState,
                           num_evals: int, interval: int):
    def outer(st: MMSBChainState, _):
        st = _mmsb_chains_chunk(cfg, num_chains, edge_set, heldout_set,
                                adjacency, st, interval)
        return _mmsb_chains_ppx(cfg, num_chains, heldout_set, eu, ev, st)

    return jax.lax.scan(outer, state, None, length=num_evals)


class MMSBChainLearner:
    """C independent full-MMSB chains, one flat row space, one fused
    program per chunk (FlatChainLearner's surface for --model mmsb)."""

    def __init__(self, cfg: Config, graph: Graph, split: DataSplit,
                 num_chains: int):
        from mcmc_ammsb.config import RngBackend
        assert num_chains >= 1
        if cfg.rng_backend != RngBackend.NATIVE:
            raise ValueError("MMSBChainLearner supports the native RNG "
                             "backend only")
        if cfg.pi_dtype != "float32":
            raise ValueError("chain engines keep pi in fp32")
        if len(split.heldout_edges_u) == 0:
            raise ValueError("no held-out edges: heldout_ratio too "
                             "small for this graph")
        cfg = cfg.replace(device_sampling=True)
        self.cfg = cfg
        self.num_chains = num_chains
        self.training_set = build_edge_set(
            cfg.edgeset_backend, cfg.N, graph.edges_u, graph.edges_v)
        self.heldout_set = build_edge_set(
            cfg.edgeset_backend, cfg.N, split.heldout_u, split.heldout_v)
        self.heldout_u = jnp.asarray(split.heldout_edges_u)
        self.heldout_v = jnp.asarray(split.heldout_edges_v)
        self.adjacency = (jnp.asarray(graph.offsets, jnp.int32),
                          jnp.asarray(graph.cols, jnp.int32))
        self.timers = StageTimers()

        h = len(split.heldout_edges_u)
        pis, phis, thetas, bs = [], [], [], []
        base = None
        for ci in range(num_chains):
            st = init_mmsb_state(
                cfg.replace(init_seed=cfg.init_seed + ci), h)
            base = st
            pis.append(st.pi); phis.append(st.phi_sum)
            thetas.append(st.theta_b); bs.append(st.b)
        self.state = MMSBChainState(
            pi=jnp.concatenate(pis, axis=0),
            phi_sum=jnp.concatenate(phis, axis=0),
            theta_b=jnp.stack(thetas),
            b=jnp.stack(bs),
            step_count=base.step_count,
            theta_count=base.theta_count,
            ppx_per_edge=jnp.zeros((num_chains, h), jnp.float32),
            ppx_count=jnp.asarray(0, jnp.int32),
            phi_key=base.phi_key,
            theta_key=base.theta_key,
            neighbor_key=base.neighbor_key,
            sample_key=base.sample_key,
        )
        self._chunk = jax.jit(
            partial(_mmsb_chains_chunk, cfg, num_chains),
            static_argnames="num_steps", donate_argnums=(3,))
        self._ppx = jax.jit(partial(_mmsb_chains_ppx, cfg, num_chains),
                            donate_argnums=(3,))
        self._chunk_ppx = jax.jit(
            partial(_mmsb_chains_chunk_ppx, cfg, num_chains),
            static_argnames=("num_evals", "interval"),
            donate_argnums=(5,))

    def run(self, max_iters: int) -> None:
        spc = max(1, self.cfg.steps_per_call)
        with self.timers.stage("total"):
            done = 0
            while done < max_iters:
                take = min(spc, max_iters - done)
                with self.timers.stage("device_step"):
                    self.state = self._chunk(
                        self.training_set, self.heldout_set,
                        self.adjacency, self.state, num_steps=take)
                done += take
            int(self.state.step_count)  # fence inside the timer

    def run_with_ppx(self, max_iters: int, interval: int):
        """Fused per-chain eval series ({step, ppx: [C]} dicts)."""
        from mcmc_ammsb.learner import run_fused_eval_series

        spc = max(1, self.cfg.steps_per_call)

        def dispatch(take):
            self.state, neg = self._chunk_ppx(
                self.training_set, self.heldout_set, self.adjacency,
                self.heldout_u, self.heldout_v, self.state,
                num_evals=take, interval=interval)
            return neg              # [take, C] device; driver blocks

        def tail(t):
            with self.timers.stage("device_step"):
                self.state = self._chunk(
                    self.training_set, self.heldout_set,
                    self.adjacency, self.state, num_steps=t)
            int(self.state.step_count)  # fence

        # np.exp in record: bit-exact with heldout_perplexity's numpy exp
        return run_fused_eval_series(
            self.timers, spc, max_iters, interval, dispatch,
            lambda: int(self.state.step_count),
            lambda neg_np, i, step: {"step": step,
                                     "ppx": np.exp(neg_np[i])},
            tail)

    def heldout_perplexity(self) -> np.ndarray:
        with self.timers.stage("ppx"):
            self.state, neg = self._ppx(
                self.heldout_set, self.heldout_u, self.heldout_v,
                self.state)
            return np.exp(np.asarray(neg))

    def print_stats(self, log=print) -> None:
        self.timers.print_table(log)

    def close(self) -> None:
        pass
