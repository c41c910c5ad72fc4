"""Device-sampled breadth-first family tests.

Two independent anchors pin ops/device_sampling._bf_expand:

1. A pure-python ORACLE that replays the device algorithm's exact
   semantics (FIFO rounds, bounded budgets, queue/row caps, keep-first
   dedup) consuming the very same jax.random draws — device output must
   match BIT-FOR-BIT.
2. The unbounded host FIFO walk of sampling.py::_bf_link (itself the
   parity model for /root/reference/mcmc/sample.cc:210-239): on graphs
   where no budget binds, the device batch must equal the host's
   first-m edge stream from the same pivot — this catches any shared
   assumption between the device code and oracle #1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_ammsb.config import Config, EdgeSetBackend, SampleStrategy
from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb.learner import Learner
from mcmc_ammsb.ops.device_sampling import (
    sample_minibatch_device, sample_minibatches_device)
from mcmc_ammsb.ops.edgeset import build_edge_set
from mcmc_ammsb.types import pack_edges

from oracle import bf_oracle, device_edges


@pytest.fixture(scope="module")
def setup():
    n, u, v = synthetic_edges(300, 8, seed=21)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=22)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    tr = build_edge_set(EdgeSetBackend.CSR, n, graph.edges_u,
                        graph.edges_v)
    ho = build_edge_set(EdgeSetBackend.CSR, n, split.heldout_u,
                        split.heldout_v)
    return n, split, graph, tr, ho


def _cfg(setup, strategy, **kw):
    n, split, graph, tr, ho = setup
    cfg = Config(K=8, mini_batch_size=16, num_node_sample=8,
                 strategy=strategy, device_sampling=True, **kw)
    return cfg.finalize(n, split.total_edges, graph.max_fan_out)


def _host_bf_link_walk(graph, pivot, m):
    """The unbounded host FIFO walk (sampling.py::_bf_link, single
    component, no budgets)."""
    q, seen, edges, eset = [pivot], set(), [], set()
    while len(edges) < m and q:
        u = q.pop(0)
        if u in seen:
            continue
        seen.add(u)
        for v in graph.neighbors_of(u):
            if len(edges) >= m:
                break
            q.append(int(v))
            ab = (min(u, int(v)), max(u, int(v)))
            if ab not in eset:
                eset.add(ab)
                edges.append(ab)
    return edges


def test_bf_link_matches_oracle_bitwise(setup):
    n, split, graph, tr, ho = setup
    cfg = _cfg(setup, SampleStrategy.BF_LINK)
    s_len = 6
    key = jax.random.PRNGKey(7)
    _, k_link, _ = jax.random.split(key, 3)
    ds = jax.jit(lambda k: sample_minibatches_device(
        cfg, tr, ho, k, s_len, adjacency=(
            jnp.asarray(graph.offsets, jnp.int32),
            jnp.asarray(graph.cols, jnp.int32))))(key)
    oracle = bf_oracle(cfg, graph, None, k_link, s_len, "link")
    for s in range(s_len):
        assert device_edges(ds, s) == oracle[s]
        m_eff = len(oracle[s])
        assert float(np.asarray(ds.weight)[s]) == pytest.approx(
            cfg.E / max(m_eff, 1))


def test_bf_link_matches_unbounded_host_walk(setup):
    """On this graph (mean degree ~8 >> m/budget) the expansion budget
    never binds, so the device batch must equal the HOST walk's first-m
    stream from the same pivot — the independent semantic anchor."""
    n, split, graph, tr, ho = setup
    cfg = _cfg(setup, SampleStrategy.BF_LINK)
    s_len = 6
    key = jax.random.PRNGKey(3)
    _, k_link, _ = jax.random.split(key, 3)
    ds = jax.jit(lambda k: sample_minibatches_device(
        cfg, tr, ho, k, s_len, adjacency=(
            jnp.asarray(graph.offsets, jnp.int32),
            jnp.asarray(graph.cols, jnp.int32))))(key)
    for s in range(s_len):
        kr = jax.random.fold_in(k_link, 0)
        pivot = int(np.asarray(jax.random.randint(
            jax.random.fold_in(kr, 0), (s_len,), 0, cfg.N,
            jnp.int32))[s])
        edges = device_edges(ds, s)
        assert len(edges) == cfg.mini_batch_size
        assert edges == _host_bf_link_walk(graph, pivot,
                                           cfg.mini_batch_size)


def test_bf_non_link_matches_oracle_bitwise(setup):
    n, split, graph, tr, ho = setup
    cfg = _cfg(setup, SampleStrategy.BF_NON_LINK)
    s_len = 6
    key = jax.random.PRNGKey(11)
    _, _, k_non = jax.random.split(key, 3)
    training_keys = set(zip(graph.edges_u.tolist(),
                            graph.edges_v.tolist()))
    ds = jax.jit(lambda k: sample_minibatches_device(
        cfg, tr, ho, k, s_len))(key)
    oracle = bf_oracle(cfg, graph, training_keys, k_non, s_len, "non")
    for s in range(s_len):
        assert device_edges(ds, s) == oracle[s]


def test_bf_non_link_properties(setup):
    n, split, graph, tr, ho = setup
    cfg = _cfg(setup, SampleStrategy.BF_NON_LINK)
    training = set(pack_edges(graph.edges_u, graph.edges_v).tolist())
    fn = jax.jit(lambda k: sample_minibatch_device(cfg, tr, ho, k))
    total = cfg.N * (cfg.N - 1) / 2.0 - cfg.E
    for trial in range(4):
        ds = fn(jax.random.PRNGKey(40 + trial))
        mask = np.asarray(ds.edge_mask)
        m_eff = int(mask.sum())
        assert m_eff == cfg.mini_batch_size     # rejections are rare
        eu = np.asarray(ds.edges_u)[mask]
        ev = np.asarray(ds.edges_v)[mask]
        assert (eu < ev).all()
        keys = pack_edges(eu, ev)
        assert len(set(keys.tolist())) == m_eff
        assert not any(int(k) in training for k in keys)
        # exact masked-count reweight invariant
        assert float(ds.weight) * m_eff == pytest.approx(total)
        # node extraction covers exactly the edge endpoints
        nodes = np.asarray(ds.nodes)[np.asarray(ds.node_mask)]
        assert set(nodes.tolist()) == set(eu.tolist()) | set(ev.tolist())


@pytest.mark.slow  # statistical coin property; oracle bitwise tests cover quick
def test_bf_coin_selects_both(setup):
    n, split, graph, tr, ho = setup
    cfg = _cfg(setup, SampleStrategy.BF)
    training = set(pack_edges(graph.edges_u, graph.edges_v).tolist())
    adj = (jnp.asarray(graph.offsets, jnp.int32),
           jnp.asarray(graph.cols, jnp.int32))
    s_len = 32
    ds = jax.jit(lambda k: sample_minibatches_device(
        cfg, tr, ho, k, s_len, adjacency=adj))(jax.random.PRNGKey(5))
    kinds = []
    for s in range(s_len):
        edges = device_edges(ds, s)
        in_train = [(int(pack_edges(np.array([a]), np.array([b]))[0])
                     in training) for a, b in edges]
        assert all(in_train) or not any(in_train)
        kinds.append(all(in_train))
    assert any(kinds) and not all(kinds)    # coin hit both branches


@pytest.mark.slow  # sampler-output alternation e2e
def test_bf_alternate_coin_strict(setup):
    n, split, graph, tr, ho = setup
    cfg = _cfg(setup, SampleStrategy.BF, node_coin="alternate")
    training = set(pack_edges(graph.edges_u, graph.edges_v).tolist())
    adj = (jnp.asarray(graph.offsets, jnp.int32),
           jnp.asarray(graph.cols, jnp.int32))
    s_len = 8
    ds = jax.jit(lambda k: sample_minibatches_device(
        cfg, tr, ho, k, s_len, adjacency=adj))(jax.random.PRNGKey(6))
    for s in range(s_len):
        edges = device_edges(ds, s)
        in_train = [(int(pack_edges(np.array([a]), np.array([b]))[0])
                     in training) for a, b in edges]
        assert all(in_train) == (s % 2 == 0)    # even steps = links


@pytest.mark.slow  # e2e fused-loop train
def test_bf_link_fused_loop_trains(setup):
    n, split, graph, tr, ho = setup
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=8,
                 strategy=SampleStrategy.BF_LINK, device_sampling=True,
                 steps_per_call=25)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    lrn = Learner(cfg, graph, split, prefetch=False)
    p0 = lrn.heldout_perplexity()
    lrn.run(100)
    p1 = lrn.heldout_perplexity()
    assert int(lrn.state.step_count) == 101
    assert np.isfinite([p0, p1]).all() and p1 < p0
    lrn.close()


@pytest.mark.slow  # e2e fused-loop comparison
def test_bf_mixed_fused_loop_matches_host_behavior(setup):
    """The mixed BF strategy does NOT monotonically reduce held-out ppx
    on tiny graphs (the BFNonLink weight (N(N-1)/2-E)/m dwarfs the link
    signal — the HOST path shows the same curve); the fused e2e
    contract is that the device
    path stays finite and runs the full step budget."""
    n, split, graph, tr, ho = setup
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=8,
                 strategy=SampleStrategy.BF, device_sampling=True,
                 steps_per_call=25)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    lrn = Learner(cfg, graph, split, prefetch=False)
    p0 = lrn.heldout_perplexity()
    lrn.run(100)
    p1 = lrn.heldout_perplexity()
    assert int(lrn.state.step_count) == 101
    assert np.isfinite([p0, p1]).all()
    lrn.close()


def test_bf_link_hub_graph_bitwise():
    """Cap-binding regime: on a power-law graph
    whose max fan-out is far beyond the 2m row-gather cap, the device
    BFLink batch STILL bit-equals the unbounded host FIFO walk — the
    truncation is exact at any degree, because an expansion processes
    at most m row positions before the host walk breaks (see the
    _sample_bf_link_batch docstring proof)."""
    from mcmc_ammsb.data import synthetic_powerlaw_edges

    n, u, v = synthetic_powerlaw_edges(600, 6.0, max_degree=200,
                                       seed=31)
    split = generate_sets(n, u, v, heldout_ratio=0.05, seed=32)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    assert graph.max_fan_out > 40          # cap 2m = 16 binds HARD
    tr = build_edge_set(EdgeSetBackend.CSR, n, graph.edges_u,
                        graph.edges_v)
    ho = build_edge_set(EdgeSetBackend.CSR, n, split.heldout_u,
                        split.heldout_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                 strategy=SampleStrategy.BF_LINK, device_sampling=True)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    assert graph.max_fan_out > 2 * cfg.mini_batch_size

    s_len = 8
    key = jax.random.PRNGKey(11)
    _, k_link, _ = jax.random.split(key, 3)
    ds = jax.jit(lambda k: sample_minibatches_device(
        cfg, tr, ho, k, s_len, adjacency=(
            jnp.asarray(graph.offsets, jnp.int32),
            jnp.asarray(graph.cols, jnp.int32))))(key)
    checked = 0
    hub_hit = False
    for s in range(s_len):
        kr = jax.random.fold_in(k_link, 0)
        pivot = int(np.asarray(jax.random.randint(
            jax.random.fold_in(kr, 0), (s_len,), 0, cfg.N,
            jnp.int32))[s])
        edges = device_edges(ds, s)
        want = _host_bf_link_walk(graph, pivot, cfg.mini_batch_size)
        if len(want) == cfg.mini_batch_size:
            # single-component walk filled the batch: the device
            # stream must match it exactly, truncation and all
            assert edges == want
            checked += 1
            deg = [len(graph.neighbors_of(a)) for e in want for a in e]
            if max(deg) > 2 * cfg.mini_batch_size:
                hub_hit = True
    assert checked >= 4    # the anchor actually ran
    assert hub_hit         # ...and walked through a truncated hub row
