"""Vectorized independent MCMC chains — a capability beyond the
reference (which runs exactly one chain per GPU process).

At reference-default minibatch sizes a single SGRLD chain is latency-
bound: each step's ~2MB of work cannot saturate an accelerator.
Running C independent chains batches that work C-fold at nearly the
same wall-clock per step — the classic MCMC answer to spare parallel
hardware, and it buys convergence diagnostics (between-chain variance,
Gelman-Rubin R-hat) that a single chain cannot provide.

Implementation: the chain axis is a leading vmap axis over the SAME
fused device-sampled loop as the single-chain path — one compiled
program advances every chain. Each chain gets independent, over-
dispersed initialization and independent noise/minibatch streams
(all keys folded with the chain index). Memory: pi becomes [C, N, K].

The vmapped scatter/gather is a batched scatter; the flat engine
(chains_flat.py) instead folds the chain axis into the row dimension
(pi [C*N, K] with indices offset by c*N) so the hot scatter stays a
plain 1-D-index scatter. This class is kept as the cross-check of the
flat engine and for its convergence diagnostics.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_ammsb.config import Config
from mcmc_ammsb.data import DataSplit, Graph
from mcmc_ammsb.learner import (TrainState, heldout_perplexity_step,
                                init_state, train_steps_fused)
from mcmc_ammsb.ops.edgeset import build_edge_set
from mcmc_ammsb.utils.timing import StageTimers


def rhat(samples: np.ndarray) -> np.ndarray:
    """Gelman-Rubin potential scale reduction factor.

    samples: [C, T, ...] — C chains, T kept draws per chain. Values
    near 1 indicate between-chain agreement. Computed elementwise over
    trailing dims.
    """
    c, t = samples.shape[:2]
    assert c >= 2 and t >= 2, (c, t)
    chain_means = samples.mean(axis=1)                    # [C, ...]
    chain_vars = samples.var(axis=1, ddof=1)              # [C, ...]
    w = chain_vars.mean(axis=0)                           # within
    b = t * chain_means.var(axis=0, ddof=1)               # between
    var_plus = (t - 1) / t * w + b / t
    return np.sqrt(var_plus / np.maximum(w, 1e-30))


def beta_rhat_series(engine, draws: int = 10) -> np.ndarray:
    """R-hat over beta across any chain engine exposing ``run``,
    ``cfg`` and ``state.beta [C, K]`` (flat and sharded engines): runs
    ``draws`` chunks keeping beta after each, returns per-community
    PSRF [K]."""
    assert draws >= 2, draws
    kept = []
    for _ in range(draws):
        engine.run(max(1, engine.cfg.steps_per_call))
        kept.append(np.asarray(engine.state.beta))       # [C, K]
    return rhat(np.stack(kept, axis=1))                  # [C, T, K]


class MultiChainLearner:
    """C independent samplers advanced by one fused device program.

    Requires device sampling (the whole loop must live on device) and
    the Node-family strategies. API mirrors Learner where it can;
    perplexity returns a [C] array (one estimate per chain).
    """

    def __init__(self, cfg: Config, graph: Graph, split: DataSplit,
                 num_chains: int):
        assert num_chains >= 1
        if len(split.heldout_edges_u) == 0:
            raise ValueError("no held-out edges: heldout_ratio too small "
                             "for this graph")
        if cfg.pi_dtype != "float32":
            raise ValueError(
                "the vmap chain engine keeps pi in fp32 (it is the slow "
                "golden cross-check); use the flat/sharded chain engines "
                "for pi_dtype=bfloat16")
        if not cfg.device_sampling:
            cfg = cfg.replace(device_sampling=True)
        self.cfg = cfg
        self.num_chains = num_chains
        self.graph = graph
        self.split = split
        self.training_set = build_edge_set(
            cfg.edgeset_backend, cfg.N, graph.edges_u, graph.edges_v)
        self.heldout_set = build_edge_set(
            cfg.edgeset_backend, cfg.N, split.heldout_u, split.heldout_v)
        self.heldout_u = jnp.asarray(split.heldout_edges_u)
        self.heldout_v = jnp.asarray(split.heldout_edges_v)
        self.adjacency = (jnp.asarray(graph.offsets, jnp.int32),
                          jnp.asarray(graph.cols, jnp.int32))
        self.timers = StageTimers()

        # overdispersed starts + independent streams: every per-chain
        # key (init, phi/beta noise, neighbors, minibatches) is the
        # single-chain key folded with the chain index
        h = len(split.heldout_edges_u)
        states = []
        for c in range(num_chains):
            st = init_state(cfg.replace(init_seed=cfg.init_seed + c), h)
            st = st._replace(
                phi_key=jax.random.fold_in(st.phi_key, c),
                beta_key=jax.random.fold_in(st.beta_key, c),
                neighbor_key=jax.random.fold_in(st.neighbor_key, c),
                sample_key=jax.random.fold_in(st.sample_key, c),
            )
            states.append(st)
        self.states: TrainState = jax.tree.map(
            lambda *xs: jnp.stack(xs), *states)

        # edge sets / heldout arrays are jit ARGUMENTS (broadcast over
        # the chain vmap axis), not trace-time constants
        self._fused_fns = {}

        def make_fused(num_steps):
            return jax.jit(jax.vmap(
                lambda tr, ho, adj, st: train_steps_fused(
                    cfg, tr, ho, st, num_steps, adj),
                in_axes=(None, None, None, 0)), donate_argnums=(3,))

        self._make_fused = make_fused
        self._ppx = jax.jit(jax.vmap(
            lambda ho, hu, hv, st: heldout_perplexity_step(
                cfg, ho, hu, hv, st),
            in_axes=(None, None, None, 0)), donate_argnums=(3,))

    def run(self, max_iters: int) -> None:
        spc = max(1, self.cfg.steps_per_call)
        with self.timers.stage("total"):
            done = 0
            while done < max_iters:
                take = min(spc, max_iters - done)
                if take not in self._fused_fns:
                    self._fused_fns[take] = self._make_fused(take)
                with self.timers.stage("device_step"):
                    self.states = self._fused_fns[take](
                        self.training_set, self.heldout_set,
                        self.adjacency, self.states)
                done += take
            int(self.states.step_count[0])  # fence inside the timer

    def heldout_perplexity(self) -> np.ndarray:
        """Per-chain perplexities [C]."""
        with self.timers.stage("ppx"):
            self.states, res = self._ppx(
                self.heldout_set, self.heldout_u, self.heldout_v,
                self.states)
            return np.exp(np.asarray(res.neg_avg_log))

    def beta_rhat(self, draws: int = 10) -> np.ndarray:
        """R-hat over beta across chains: runs `draws` chunks, keeping
        beta after each, and returns the per-community PSRF [K]."""
        kept = []
        for _ in range(draws):
            self.run(self.cfg.steps_per_call)
            kept.append(np.asarray(self.states.beta))    # [C, K]
        samples = np.stack(kept, axis=1)                 # [C, T, K]
        return rhat(samples)
