"""The assortative Mixed-Membership Stochastic Blockmodel (a-MMSB).

Generative model (the one the reference trains, SURVEY.md §0;
/root/reference/mcmc/learner.h:53-54, mcmc/perplexity.cc:16-38):

    beta_k ~ Beta(eta0, eta1)                    community link strength
    pi_a   ~ Dirichlet(alpha * 1_K)              node memberships
    for each node pair (a, b):
        z_ab ~ Categorical(pi_a), z_ba ~ Categorical(pi_b)
        y_ab ~ Bernoulli(beta_k)   if z_ab = z_ba = k
        y_ab ~ Bernoulli(epsilon)  otherwise       ("assortative": only
                                                    same-community pairs
                                                    link strongly)

Posterior sampling is SGRLD on the expanded-mean parameterizations
phi (for pi) and theta (for beta) — the update laws live in
ops/phi.py and ops/beta.py with their reference citations.

This class is the model-family facade: it owns the static model data
(config, edge sets, held-out population) and exposes the pure
functional surface (init / step / eval) that orchestrators build on —
`learner.Learner` (single chip), `parallel.ShardedLearner`
(multi-chip), `chains_flat.FlatChainLearner` (vectorized chains) are
all drivers of this same surface.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from mcmc_ammsb.config import Config
from mcmc_ammsb.data import DataSplit, Graph
from mcmc_ammsb.learner import (DeviceBatch, TrainState,
                                heldout_perplexity_step, init_state,
                                train_step, train_steps_scan)
from mcmc_ammsb.ops import perplexity as ppx_ops
from mcmc_ammsb.ops.edgeset import EdgeSet, build_edge_set


class AMMSB:
    """Model-family object: static data + pure functional surface."""

    def __init__(self, cfg: Config, graph: Graph, split: DataSplit):
        self.cfg = cfg
        self.graph = graph
        self.split = split
        self.training_set: EdgeSet = build_edge_set(
            cfg.edgeset_backend, cfg.N, graph.edges_u, graph.edges_v)
        self.heldout_set: EdgeSet = build_edge_set(
            cfg.edgeset_backend, cfg.N, split.heldout_u, split.heldout_v)
        self.heldout_u = jnp.asarray(split.heldout_edges_u)
        self.heldout_v = jnp.asarray(split.heldout_edges_v)

    # -- pure functional surface ------------------------------------------

    def init(self) -> TrainState:
        """Draw the initial posterior sample (learner.cc:149-155 laws)."""
        return init_state(self.cfg, len(self.split.heldout_edges_u))

    def step(self, state: TrainState, batch: DeviceBatch) -> TrainState:
        """One SGRLD transition. Pure; jit/scan/shard_map compatible."""
        return train_step(self.cfg, self.training_set, state, batch)

    def steps(self, state: TrainState, batches: DeviceBatch) -> TrainState:
        """A scan of pre-sampled transitions (one device dispatch)."""
        return train_steps_scan(self.cfg, self.training_set, state,
                                batches)

    def eval(self, state: TrainState
             ) -> Tuple[TrainState, ppx_ops.PpxResult]:
        """Held-out perplexity evaluation (running-average semantics)."""
        return heldout_perplexity_step(
            self.cfg, self.heldout_set, self.heldout_u, self.heldout_v,
            state)
