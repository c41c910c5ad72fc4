"""Retry-budget semantics of the numpy host samplers.

The native sampler fails with rc=-4 when a rejection loop exhausts its
budget (csrc/sampler.cpp:63-114); the numpy fallback must fail the
same way — loudly, via SamplerExhausted — instead of spinning forever
on pathological inputs (near-complete graphs where the requested
non-links do not exist). Reference behavior: the host samplers there
simply loop (mcmc/sample.cc:275-293) — the budget is a robustness
addition mirrored across both of our host paths.
"""

import numpy as np
import pytest

from mcmc_ammsb.config import Config, SampleStrategy
from mcmc_ammsb.data import Graph, generate_sets
from mcmc_ammsb.sampling import MiniBatchSampler, SamplerExhausted


def complete_graph(n):
    iu, iv = np.triu_indices(n, k=1)
    return iu.astype(np.int32), iv.astype(np.int32)


@pytest.fixture(scope="module")
def complete_setup():
    # ratio 0: a complete graph HAS no non-edges, so the held-out fake
    # sampler could never succeed (its own budget is tested below)
    n = 8
    u, v = complete_graph(n)
    split = generate_sets(n, u, v, heldout_ratio=0.0, seed=1)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    return n, split, graph


def test_generate_sets_budget_on_complete_graph():
    n = 12
    u, v = complete_graph(n)
    with pytest.raises(ValueError, match="too dense"):
        generate_sets(n, u, v, heldout_ratio=0.5, seed=1)


def make_sampler(complete_setup, strategy, m=4):
    n, split, graph = complete_setup
    cfg = Config(K=4, mini_batch_size=m, num_node_sample=4,
                 strategy=SampleStrategy.parse(strategy),
                 host_sampler="numpy")
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    return MiniBatchSampler(cfg, graph, split)


def test_node_non_link_budget_on_complete_graph(complete_setup):
    # every pair is a training or held-out edge: no non-link exists
    sampler = make_sampler(complete_setup, "NodeNonLink")
    with pytest.raises(SamplerExhausted, match="NodeNonLink"):
        sampler.sample()


def test_bf_non_link_budget_on_complete_graph(complete_setup):
    sampler = make_sampler(complete_setup, "BFNonLink")
    with pytest.raises(SamplerExhausted, match="BFNonLink"):
        sampler.sample()


def test_budget_does_not_trip_on_normal_graphs(complete_setup):
    # sparse graph: every strategy samples fine within budget
    n = 60
    rng = np.random.RandomState(0)
    u = rng.randint(0, n, 200).astype(np.int32)
    v = rng.randint(0, n, 200).astype(np.int32)
    keep = u != v
    split = generate_sets(n, u[keep], v[keep], heldout_ratio=0.1, seed=2)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    for strategy in ["NodeLink", "NodeNonLink", "Node", "BFLink",
                     "BFNonLink", "BF"]:
        cfg = Config(K=4, mini_batch_size=8,
                     strategy=SampleStrategy.parse(strategy),
                     host_sampler="numpy")
        cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
        sampler = MiniBatchSampler(cfg, graph, split)
        for _ in range(5):
            b = sampler.sample()
            assert b.edge_mask.sum() > 0
