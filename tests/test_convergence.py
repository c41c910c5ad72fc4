"""Pinned held-out perplexity trajectory — convergence as a TESTED
CONTRACT, not just "decreases".

The reference's primary experiment output is the ppx[i] series
(/root/reference/main.cc:160-168). Real SNAP datasets cannot be fetched
in this zero-egress image (scripts/fetch_datasets.py documents the
blocker), so the contract is pinned on a fixed planted-partition (SBM)
graph with fixed seeds: the full fused device-sampled training loop is
a pure function of (graph, config, seeds), so on the CPU test platform
the trajectory reproduces bit-identically — any numerics change that
alters the MCMC trajectory fails this test loudly and the pin must be
consciously regenerated (values below were produced by exactly this
code at round 2, verified identical across independent runs).
"""

import numpy as np
import pytest

from mcmc_ammsb.config import Config
from mcmc_ammsb.data import Graph, generate_sets, synthetic_sbm_edges
from mcmc_ammsb.learner import Learner

pytestmark = pytest.mark.slow  # quick tier: -m 'not slow'

# ppx after 0, 250, ..., 1500 fused device-sampled steps (recipe below).
# The edge-set backend is pinned explicitly: membership LABELS are
# backend-identical (oracle-tested), but a different membership subgraph
# changes XLA's fusion and thus float reduction order, which a chaotic
# MCMC trajectory amplifies — so the pin is per-backend by nature.
# Regenerated round 3: _structural_nodes orders the node list pivot-
# first instead of sorted, which reassigns per-lane RNG streams — a
# different (statistically equivalent) trajectory.
PINNED_TRAJECTORY = [3.898526, 3.511903, 3.443108, 3.420263,
                     3.394908, 3.361047, 3.327672]


def build_learner():
    from mcmc_ammsb.config import EdgeSetBackend
    n, u, v = synthetic_sbm_edges(2000, 8, p_in=0.05, p_out=0.001, seed=5)
    split = generate_sets(n, u, v, heldout_ratio=0.05, seed=6)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=16, num_node_sample=16,
                 steps_per_call=50, device_sampling=True,
                 edgeset_backend=EdgeSetBackend.ADJACENCY)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    assert (cfg.N, cfg.E, len(split.heldout_edges_u)) == (2000, 14052, 702)
    return Learner(cfg, graph, split, prefetch=False)


def test_pinned_ppx_trajectory():
    lrn = build_learner()
    traj = [lrn.heldout_perplexity()]
    for _ in range(len(PINNED_TRAJECTORY) - 1):
        lrn.run(250)
        traj.append(lrn.heldout_perplexity())
    lrn.close()
    np.testing.assert_allclose(traj, PINNED_TRAJECTORY, rtol=1e-4)
    # and the qualitative convergence property the pin encodes
    assert traj[-1] < traj[0] * 0.9
