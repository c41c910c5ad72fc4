"""Flat-layout multi-chain engine: C independent SGRLD chains whose
state shares ONE row dimension — pi [C*N, K] with chain c's node u at
row c*N + u — so the hot scatter/gather of every step stays a plain
1-D-index operation (the vmap formulation in chains.py batches the
scatter instead).

Per step, all C chains' minibatches are processed as one [C*B]-node
flat batch: the phi stage is exactly ops.phi.phi_update_core with
per-chain beta rows broadcast in; the beta stage reduces per chain.
Aggregate statistical throughput approaches C x the single-chain rate
until bandwidth binds.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_ammsb.config import Config
from mcmc_ammsb.data import DataSplit, Graph
from mcmc_ammsb.learner import init_state
from mcmc_ammsb.ops import beta as beta_ops
from mcmc_ammsb.ops import phi as phi_ops
from mcmc_ammsb.ops.device_sampling import sample_minibatches_device
from mcmc_ammsb.ops.edgeset import EdgeSet, build_edge_set
from mcmc_ammsb.ops.neighbor import sample_neighbors
from mcmc_ammsb.rng import native as native_rng
from mcmc_ammsb.utils.timing import StageTimers


class ChainState(NamedTuple):
    pi: jnp.ndarray            # [C*N, K]
    phi_sum: jnp.ndarray       # [C*N]
    theta: jnp.ndarray         # [C, K, 2]
    beta: jnp.ndarray          # [C, K]
    step_count: jnp.ndarray    # scalar (chains advance in lockstep)
    beta_count: jnp.ndarray
    ppx_per_edge: jnp.ndarray  # [C, H]
    ppx_count: jnp.ndarray
    phi_key: jax.Array
    beta_key: jax.Array
    neighbor_key: jax.Array
    sample_key: jax.Array


def _beta_gradients_chains(cfg: Config, theta, beta, pi_u, pi_v, y, mask):
    """Per-chain gradient fan-in: the math of
    ops.beta.beta_gradients_core with a leading chain axis.
    Shapes: theta [C,K,2], beta [C,K], pi_u/pi_v [C,E,K], y/mask [C,E].
    Returns [C,K,2]."""
    eps = cfg.epsilon
    theta_sum = theta[..., 0] + theta[..., 1]                # [C,K]
    yf = y.astype(pi_u.dtype)
    pp = pi_u * pi_v                                         # [C,E,K]
    pi_sum = jnp.sum(pp, axis=-1)                            # [C,E]
    probs = jnp.where(y[..., None], beta[:, None, :],
                      1.0 - beta[:, None, :]) * pp
    prob_0 = jnp.where(y, eps, 1.0 - eps) * (1.0 - pi_sum)
    probs_sum = jnp.sum(probs, axis=-1) + prob_0
    f = probs / probs_sum[..., None]                         # [C,E,K]
    inv_ts = 1.0 / theta_sum[:, None, :]                     # [C,1,K]
    g0 = f * ((1.0 - yf)[..., None] / theta[:, None, :, 0] - inv_ts)
    g1 = f * (yf[..., None] / theta[:, None, :, 1] - inv_ts)
    m = mask.astype(pi_u.dtype)[..., None]
    return jnp.stack([jnp.sum(g0 * m, axis=1),
                      jnp.sum(g1 * m, axis=1)], axis=-1)     # [C,K,2]


def _chunk(cfg: Config, num_chains: int, edge_set: EdgeSet,
           heldout_set: EdgeSet, adjacency, state: ChainState,
           num_steps: int) -> ChainState:
    """Advance all chains num_steps in one fused program."""
    c = num_chains
    n_rows = cfg.N
    e_cap, b_cap = cfg.max_batch_edges, cfg.max_batch_nodes
    s_len = num_steps
    k = cfg.K

    # one batched draw covers every (step, chain) minibatch
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
    flat_nodes_all = nodes.reshape(s_len, c * b_cap)
    nbr_keys = jax.vmap(
        lambda s: jax.random.fold_in(state.neighbor_key, s))(steps)
    if cfg.shared_neighbors:
        # ONE n-draw per (step, chain): each chain keeps its own
        # independent stream (sharing across chains would correlate
        # the chains and void the R-hat diagnostics), but within a
        # chain every minibatch node reads the same neighbor set —
        # the same unbiased-per-node estimator as the single-chain
        # fast path (config.py shared_neighbors doc), cutting the
        # dominant pi_nb gather from C*B*n to C*n rows per step.
        sentinel = jnp.full((c,), cfg.N, jnp.int32)
        with jax.named_scope("neighbor_draws"):
            neighbors = jax.vmap(lambda key: sample_neighbors(
                key, sentinel, cfg.N, cfg.num_node_sample))(nbr_keys)
            # [S, C, n] chain-local ids
        with jax.named_scope("membership"):
            y_phi = edge_set.has_edges(
                nodes[..., None], neighbors[:, :, None, :])  # [S,C,B,n]
        nbr_mask = (neighbors[:, :, None, :]
                    != nodes[..., None])                      # [S,C,B,n]
        # beta endpoint rows come from the step's STAGED phi rows (the
        # edge_lanes trick of learner.train_steps_scan): endpoints are
        # a subset of the chain's deduped node lanes by construction
        lanes_u = jnp.argmax(eu[..., None] == nodes[:, :, None, :],
                             axis=-1).astype(jnp.int32)       # [S,C,E]
        lanes_v = jnp.argmax(ev[..., None] == nodes[:, :, None, :],
                             axis=-1).astype(jnp.int32)
    else:
        with jax.named_scope("neighbor_draws"):
            neighbors = jax.vmap(lambda key, nd: sample_neighbors(
                key, nd, cfg.N, cfg.num_node_sample))(
                nbr_keys, flat_nodes_all)     # [S, C*B, n]
        with jax.named_scope("membership"):
            y_phi = edge_set.has_edges(flat_nodes_all[:, :, None],
                                       neighbors)
        nbr_mask = jnp.zeros((s_len,), jnp.bool_)   # unused placeholder
        lanes_u = lanes_v = jnp.zeros((s_len,), jnp.int32)
    with jax.named_scope("noise"):
        if cfg.phi_disable_noise:
            phi_noise = jnp.ones((s_len, c * b_cap, k), jnp.float32)
        else:
            phi_noise = jax.vmap(lambda s: native_rng.randn(
                jax.random.fold_in(state.phi_key, s),
                (c * b_cap, k)))(steps)
        beta_noise = jax.vmap(lambda s: native_rng.randn(
            jax.random.fold_in(state.beta_key, s), (c, k, 2)))(steps)
    with jax.named_scope("membership"):
        y_edges = edge_set.has_edges(eu, ev)   # [S,C,E]

    # chain row offsets; sentinel rows (id == N) map to the global
    # sentinel C*N so they never collide with another chain's row 0
    offsets = (jnp.arange(c, dtype=jnp.int32) * n_rows)[:, None]  # [C,1]

    def body(st: ChainState, xs):
        (nodes_s, nmask_s, eu_s, ev_s, emask_s, w_s,
         nbrs_s, y_n, n_phi, n_beta, y_e, nm_s, lu_s, lv_s) = xs
        # ---- phi stage over the flat [C*B] node batch ----------------
        flat_nodes = jnp.where(nodes_s < n_rows, nodes_s + offsets,
                               c * n_rows).reshape(-1)       # [C*B]
        flat_mask = nmask_s.reshape(-1)
        with jax.named_scope("pi_gather"):
            # bf16 pi storage: gathered rows upcast, compute stays fp32
            # (the single-chip discipline, learner.py pi_storage_dtype)
            pi_n = st.pi[flat_nodes].astype(jnp.float32)     # [C*B, K]
            phis = st.phi_sum[flat_nodes]
            if cfg.shared_neighbors:
                pi_nb = st.pi[nbrs_s + offsets].astype(
                    jnp.float32)                             # [C, n, K]
            else:
                flat_nbrs = (nbrs_s.reshape(c, b_cap, -1)
                             + offsets[:, :, None]).reshape(c * b_cap, -1)
                pi_nb = st.pi[flat_nbrs].astype(
                    jnp.float32)                             # [C*B, n, K]
        with jax.named_scope("phi_update"):
            if cfg.shared_neighbors:
                rows_c, sums_c = jax.vmap(
                    lambda pn, ps, pnb, yy, bt, nz, nm:
                    phi_ops.phi_update_core(cfg, pn, ps, pnb[None], yy,
                                            bt, st.step_count, nz, nm)
                )(pi_n.reshape(c, b_cap, k), phis.reshape(c, b_cap),
                  pi_nb, y_n, st.beta, n_phi.reshape(c, b_cap, k), nm_s)
                rows = rows_c.reshape(c * b_cap, k)
                sums = sums_c.reshape(-1)
            else:
                beta_rows = jnp.repeat(st.beta, b_cap, axis=0)[:, None, :]
                rows, sums = phi_ops.phi_update_core(
                    cfg, pi_n, phis, pi_nb, y_n.reshape(c * b_cap, -1),
                    beta_rows, st.step_count, n_phi)
        with jax.named_scope("pi_scatter"):
            safe = jnp.where(flat_mask, flat_nodes, c * n_rows)
            pi = st.pi.at[safe].set(rows.astype(st.pi.dtype),
                                    mode="drop")
            phi_sum = st.phi_sum.at[safe].set(sums, mode="drop")
        # ---- beta stage per chain ------------------------------------
        with jax.named_scope("beta_grads"):
            if cfg.shared_neighbors:
                # endpoint rows from the staged buffer (no [C*N,K]
                # gathers); masked node lanes hold staging garbage the
                # scatter drops — sanitize before the small lane
                # gathers (NaN*0 != 0)
                rows_safe = jnp.where(flat_mask[:, None], rows,
                                      1.0 / k).reshape(c, b_cap, k)
                pi_u = jnp.take_along_axis(rows_safe, lu_s[..., None],
                                           axis=1)
                pi_v = jnp.take_along_axis(rows_safe, lv_s[..., None],
                                           axis=1)
            else:
                flat_eu = (eu_s + offsets).reshape(-1)
                flat_ev = (ev_s + offsets).reshape(-1)
                pi_u = pi[flat_eu].astype(jnp.float32).reshape(
                    c, e_cap, k)
                pi_v = pi[flat_ev].astype(jnp.float32).reshape(
                    c, e_cap, k)
            grads = _beta_gradients_chains(
                cfg, st.theta, st.beta, pi_u, pi_v, y_e, emask_s)
        beta_count = st.beta_count + 1
        with jax.named_scope("theta_update"):
            theta, beta = beta_ops.theta_step(
                cfg, st.theta, grads, w_s[:, None, None], beta_count,
                n_beta)
        return st._replace(
            pi=pi, phi_sum=phi_sum, theta=theta, beta=beta,
            step_count=st.step_count + 1, beta_count=beta_count), None

    xs = (nodes, node_mask, eu, ev, emask, weight, neighbors, y_phi,
          phi_noise, beta_noise, y_edges, nbr_mask, lanes_u, lanes_v)
    if cfg.window > 1 and cfg.shared_neighbors:
        return _windowed_chain_scan(cfg, c, state, xs, body)
    state, _ = jax.lax.scan(body, state, xs, unroll=cfg.scan_unroll)
    return state


def _windowed_chain_scan(cfg: Config, num_chains: int,
                         state: ChainState, xs, body) -> ChainState:
    """T-step windowed multi-chain scan: each window runs ONE bulk
    gather of every chain's rows, the T-step window body
    (ops/window.window_steps) vmapped over the chain axis, and ONE
    last-write-wins scatter in place of T scan-body iterations. Chain
    c's flat row ids are disjoint from every other chain's, so
    intra-window collision corrections stay per chain. Any non-multiple
    tail runs through the sequential ``body``. Trajectory semantics
    are exactly the sequential chain scan's (golden-tested,
    test_chains_flat.py)."""
    from mcmc_ammsb.ops.window import (_correction_codes,
                                       _last_write_wins, window_steps)

    t_win = cfg.window
    c = num_chains
    s_len = xs[0].shape[0]
    n_win = s_len // t_win
    tail = s_len - n_win * t_win
    if n_win == 0:
        state, _ = jax.lax.scan(body, state, xs, unroll=cfg.scan_unroll)
        return state

    b_cap, k = cfg.max_batch_nodes, cfg.K
    n_rows = cfg.N
    xs_w = jax.tree.map(
        lambda a: a[: n_win * t_win].reshape(n_win, t_win, *a.shape[1:]),
        xs)

    def chain_major(a):                  # [T, C, ...] -> [C, T, ...]
        return jnp.swapaxes(a, 0, 1)

    def wbody(st: ChainState, xw):
        (nodes, nmask, _eu, _ev, emask_s, wts, nbrs, y_n, n_phi,
         n_beta, y_e, _nm, lu, lv) = xw
        offsets = (jnp.arange(c, dtype=jnp.int32) * n_rows)[None, :,
                                                            None]
        nodes_f = jnp.where(nodes < n_rows, nodes + offsets,
                            c * n_rows)                   # [T, C, B]
        nbrs_f = nbrs + offsets                           # [T, C, n]
        with jax.named_scope("window_gather"):
            read_idx = jnp.concatenate([nodes_f, nbrs_f], axis=2)
            g = st.pi[read_idx].astype(jnp.float32)       # [T,C,B+n,K]
            sums_g = st.phi_sum[nodes_f]                  # [T, C, B]
        with jax.named_scope("window_correct"):
            mcode = jax.vmap(partial(_correction_codes, cfg),
                             in_axes=(1, 1, 1), out_axes=1)(
                nodes_f, nmask, nbrs_f)                   # [T,C,B+n,1]
        per_chain = [g, sums_g, mcode, nodes, nmask, emask_s, wts, nbrs,
                     y_n, n_phi.reshape(t_win, c, b_cap, k), n_beta,
                     y_e, lu, lv]
        rows, sums, theta, beta = jax.vmap(
            lambda th, bt, *a: window_steps(
                cfg, th, bt, st.step_count, st.beta_count, *a))(
            st.theta, st.beta, *map(chain_major, per_chain))
        with jax.named_scope("window_scatter"):
            # staged rows are CHAIN-major [C, T*B]; match the indices
            nodes_cm = chain_major(nodes_f)               # [C, T, B]
            keep = jax.vmap(_last_write_wins, in_axes=(0, 0, None))(
                nodes_cm, chain_major(nmask), t_win)      # [C, T, B]
            safe = jnp.where(keep.reshape(-1),
                             nodes_cm.reshape(-1), c * n_rows)
            pi = st.pi.at[safe].set(
                rows.reshape(-1, k).astype(st.pi.dtype), mode="drop")
            phi_sum = st.phi_sum.at[safe].set(sums.reshape(-1),
                                              mode="drop")
        return st._replace(
            pi=pi, phi_sum=phi_sum, theta=theta, beta=beta,
            step_count=st.step_count + t_win,
            beta_count=st.beta_count + t_win), None

    state, _ = jax.lax.scan(wbody, state, xs_w)
    if tail:
        xs_tail = jax.tree.map(lambda a: a[n_win * t_win:], xs)
        state, _ = jax.lax.scan(body, state, xs_tail,
                                unroll=cfg.scan_unroll)
    return state


def _chunk_ppx(cfg: Config, num_chains: int, edge_set: EdgeSet,
               heldout_set: EdgeSet, adjacency,
               eu: jnp.ndarray, ev: jnp.ndarray, state: ChainState,
               num_evals: int, interval: int):
    """num_evals x (interval fused chain steps + one per-chain eval) in
    ONE dispatch — the chain-engine analog of
    learner.train_steps_fused_ppx. Returns (state, neg_avg_log
    [num_evals, C])."""
    def outer(st: ChainState, _):
        st = _chunk(cfg, num_chains, edge_set, heldout_set, adjacency,
                    st, interval)
        return _ppx(cfg, num_chains, heldout_set, eu, ev, st)

    return jax.lax.scan(outer, state, None, length=num_evals)


def _ppx(cfg: Config, num_chains: int, heldout_set: EdgeSet,
         eu: jnp.ndarray, ev: jnp.ndarray, state: ChainState):
    """Per-chain perplexity over the shared heldout population."""
    c = num_chains
    h = eu.shape[0]
    k = cfg.K
    count = state.ppx_count + 1
    y = heldout_set.has_edges(eu, ev)                        # [H]
    offsets = (jnp.arange(c, dtype=jnp.int32) * cfg.N)[:, None]
    pi_u = state.pi[(eu[None, :] + offsets).reshape(-1)].astype(
        jnp.float32).reshape(c, h, k)
    pi_v = state.pi[(ev[None, :] + offsets).reshape(-1)].astype(
        jnp.float32).reshape(c, h, k)
    eps = cfg.epsilon
    pp = pi_u * pi_v
    pi_sum = jnp.sum(pp, axis=-1)
    s_link = jnp.sum(pp * state.beta[:, None, :], axis=-1)
    s_non = (jnp.sum(pp * (1.0 - state.beta[:, None, :]), axis=-1)
             + (1.0 - pi_sum) * (1.0 - eps))
    lik = jnp.maximum(jnp.where(y[None, :], s_link, s_non), 1e-30)
    cnt = count.astype(pp.dtype)
    ppx_new = (state.ppx_per_edge * (cnt - 1.0) + lik) / cnt   # [C,H]
    neg_avg = -jnp.mean(jnp.log(ppx_new), axis=-1)             # [C]
    state = state._replace(ppx_per_edge=ppx_new, ppx_count=count)
    return state, neg_avg


class FlatChainLearner:
    """C chains, one flat row space, one fused program per chunk."""

    def __init__(self, cfg: Config, graph: Graph, split: DataSplit,
                 num_chains: int):
        from mcmc_ammsb.config import RngBackend
        assert num_chains >= 1
        if cfg.rng_backend != RngBackend.NATIVE:
            raise ValueError("FlatChainLearner supports the native RNG "
                             "backend only (per-thread reference streams "
                             "are single-chain semantics)")
        if cfg.pi_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown pi_dtype {cfg.pi_dtype!r}")
        if cfg.window > 1 and not cfg.shared_neighbors:
            raise ValueError("window > 1 on the chain engine requires "
                             "shared_neighbors (the window body "
                             "operates on the shared-draw layout)")
        if len(split.heldout_edges_u) == 0:
            raise ValueError("no held-out edges: heldout_ratio too small "
                             "for this graph")
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
        pis, phis, thetas, betas = [], [], [], []
        base = None
        for ci in range(num_chains):
            st = init_state(cfg.replace(init_seed=cfg.init_seed + ci), h)
            base = st
            pis.append(st.pi); phis.append(st.phi_sum)
            thetas.append(st.theta); betas.append(st.beta)
        self.state = ChainState(
            pi=jnp.concatenate(pis, axis=0),
            phi_sum=jnp.concatenate(phis, axis=0),
            theta=jnp.stack(thetas),
            beta=jnp.stack(betas),
            step_count=base.step_count,
            beta_count=base.beta_count,
            ppx_per_edge=jnp.zeros((num_chains, h), jnp.float32),
            ppx_count=jnp.asarray(0, jnp.int32),
            phi_key=base.phi_key,
            beta_key=base.beta_key,
            neighbor_key=base.neighbor_key,
            sample_key=base.sample_key,
        )
        self._chunk = jax.jit(
            partial(_chunk, cfg, num_chains),
            static_argnames="num_steps", donate_argnums=(3,))
        self._ppx = jax.jit(partial(_ppx, cfg, num_chains),
                            donate_argnums=(3,))
        self._chunk_ppx = jax.jit(
            partial(_chunk_ppx, cfg, num_chains),
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
        """Train max_iters steps with a per-chain held-out eval every
        ``interval`` steps fused into single dispatches (_chunk_ppx) —
        the chain-engine analog of Learner.run_with_ppx. Returns a list
        of {step, ppx: [C] array} dicts; bit-exact with the chunked
        host loop (tested)."""
        from mcmc_ammsb.learner import run_fused_eval_series

        spc = max(1, self.cfg.steps_per_call)

        def dispatch(take):
            self.state, neg = self._chunk_ppx(
                self.training_set, self.heldout_set, self.adjacency,
                self.heldout_u, self.heldout_v, self.state,
                num_evals=take, interval=interval)
            return neg               # [take, C] device; driver blocks

        def tail(t):
            with self.timers.stage("device_step"):
                self.state = self._chunk(
                    self.training_set, self.heldout_set,
                    self.adjacency, self.state, num_steps=t)
            int(self.state.step_count)  # fence

        # np.exp in record (not jnp in dispatch): heldout_perplexity
        # exps with numpy, and the series contract is bit-exact
        # equality with it
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

    def beta_rhat(self, draws: int = 10) -> np.ndarray:
        """Gelman-Rubin PSRF [K] over beta across the chains (the
        population-level convergence diagnostic a single chain cannot
        provide — chains.rhat)."""
        from mcmc_ammsb.chains import beta_rhat_series

        return beta_rhat_series(self, draws)

    def fused_stage_profile(self, iters=None) -> dict:
        """TRUE per-stage attribution of the fused multi-chain program
        (Learner.fused_stage_profile contract): a traced production
        chunk aggregated by the named_scope stages in _chunk."""
        from mcmc_ammsb.utils import profiling

        spc = max(1, self.cfg.steps_per_call)
        hlo_text = self._chunk.lower(
            self.training_set, self.heldout_set, self.adjacency,
            self.state, num_steps=spc).compile().as_text()
        return profiling.traced_stage_profile(self.run, hlo_text, spc,
                                              iters)

    def print_stage_profile(self, log=print, iters=None) -> None:
        from mcmc_ammsb.utils import profiling

        profiling.print_stage_profile(self.fused_stage_profile(iters), log)
