"""Device-side minibatch sampling tests: strategy invariants mirroring
the host-sampler tests, plus the fully-fused training loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_ammsb.config import Config, EdgeSetBackend, SampleStrategy
from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb.learner import Learner
from mcmc_ammsb.ops.device_sampling import sample_minibatch_device
from mcmc_ammsb.ops.edgeset import build_edge_set
from mcmc_ammsb.types import pack_edges


@pytest.fixture(scope="module")
def setup():
    n, u, v = synthetic_edges(400, 10, seed=9)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=10)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    tr = build_edge_set(EdgeSetBackend.CSR, n, graph.edges_u, graph.edges_v)
    ho = build_edge_set(EdgeSetBackend.CSR, n, split.heldout_u,
                        split.heldout_v)
    return n, split, graph, tr, ho


def _cfg(setup, strategy):
    n, split, graph, tr, ho = setup
    cfg = Config(K=8, mini_batch_size=16, num_node_sample=8,
                 strategy=strategy, device_sampling=True)
    return cfg.finalize(n, split.total_edges, graph.max_fan_out)


def test_device_node_link(setup):
    n, split, graph, tr, ho = setup
    cfg = _cfg(setup, SampleStrategy.NODE_LINK)
    training = set(pack_edges(graph.edges_u, graph.edges_v).tolist())
    fn = jax.jit(lambda k: sample_minibatch_device(cfg, tr, ho, k))
    for trial in range(5):
        ds = fn(jax.random.PRNGKey(trial))
        ne = int(np.asarray(ds.edge_mask).sum())
        eu = np.asarray(ds.edges_u)[:ne]
        ev = np.asarray(ds.edges_v)[:ne]
        assert ne > 0
        assert all(int(k) in training for k in pack_edges(eu, ev))
        # all edges share one pivot node; count = its full degree
        ids, counts = np.unique(np.concatenate([eu, ev]),
                                return_counts=True)
        pivot = ids[counts.argmax()]
        assert counts.max() == ne
        assert ne == len(graph.neighbors_of(int(pivot)))
        assert float(ds.weight) == cfg.N
        # node extraction: deduped endpoints (structural order: pivot
        # then partners; masked lanes hold the sentinel)
        nmask = np.asarray(ds.node_mask)
        nodes = np.asarray(ds.nodes)[nmask]
        assert len(set(nodes.tolist())) == len(nodes)
        assert set(nodes.tolist()) == set(eu.tolist()) | set(ev.tolist())
        assert (np.asarray(ds.nodes)[~nmask] == cfg.N).all()


def test_device_node_non_link(setup):
    n, split, graph, tr, ho = setup
    cfg = _cfg(setup, SampleStrategy.NODE_NON_LINK)
    training = set(pack_edges(graph.edges_u, graph.edges_v).tolist())
    heldout = set(pack_edges(split.heldout_u, split.heldout_v).tolist())
    fn = jax.jit(lambda k: sample_minibatch_device(cfg, tr, ho, k))
    for trial in range(5):
        ds = fn(jax.random.PRNGKey(100 + trial))
        mask = np.asarray(ds.edge_mask)
        ne = int(mask.sum())
        assert ne >= cfg.mini_batch_size - 1  # residual collisions rare
        eu = np.asarray(ds.edges_u)[mask]
        ev = np.asarray(ds.edges_v)[mask]
        keys = pack_edges(eu, ev)
        assert len(set(keys.tolist())) == ne
        assert not any(int(k) in training or int(k) in heldout
                       for k in keys)
        # masked-count-aware scale: weight * m_eff == 2E exactly, the
        # invariant the host sampler satisfies with exactly m draws
        assert np.isclose(float(ds.weight) * ne, 2.0 * cfg.E)


def test_device_non_link_weight_unbiased_under_collisions():
    """Statistical bound on the residual-mask bias
    (/root/reference/mcmc/sample.cc:275-293 semantics): on a DENSE graph
    where redraw collisions are common, the effective minibatch m_eff
    may fall below m — the weight must scale to 2E/m_eff per step so
    weight * m_eff == 2E always, and the m_eff deficit itself must stay
    small at realistic densities."""
    n, u, v = synthetic_edges(60, 12, seed=77)   # ~20% dense
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=78)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=4, mini_batch_size=16, num_node_sample=4,
                 strategy=SampleStrategy.NODE_NON_LINK,
                 device_sampling=True,
                 # explicit: at 20% density the default single round
                 # leaves ~10% of lanes masked (unbiased but below this
                 # test's deficit bound, which checks the ROUNDS work)
                 ds_nonlink_rounds=4)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    tr = build_edge_set(EdgeSetBackend.CSR, n, graph.edges_u,
                        graph.edges_v)
    ho = build_edge_set(EdgeSetBackend.CSR, n, split.heldout_u,
                        split.heldout_v)

    from mcmc_ammsb.ops.device_sampling import \
        sample_minibatches_device
    s_len = 512
    ds = jax.jit(lambda k: sample_minibatches_device(
        cfg, tr, ho, k, s_len))(jax.random.PRNGKey(3))
    m_eff = np.asarray(ds.edge_mask).sum(-1)          # [S]
    w = np.asarray(ds.weight)
    # exact unbiasedness invariant, every step
    np.testing.assert_allclose(w * np.maximum(m_eff, 1), 2.0 * cfg.E,
                               rtol=1e-6)
    # deficit bound: even on this unusually dense graph the 4 redraw
    # rounds leave the mean effective batch within 5% of m
    assert m_eff.mean() >= 0.95 * cfg.mini_batch_size, m_eff.mean()
    assert (m_eff > 0).all()


def test_alternate_coin_strict_stratification(setup):
    """node_coin='alternate': steps strictly alternate link (weight N,
    all edges share the pivot) and non-link (weight 2E/m_eff) draws,
    and each draw individually satisfies its strategy's invariants."""
    from mcmc_ammsb.ops.device_sampling import \
        sample_minibatches_device

    n, split, graph, tr, ho = setup
    cfg = _cfg(setup, SampleStrategy.NODE).replace(node_coin="alternate")
    adj = (jnp.asarray(graph.offsets, jnp.int32),
           jnp.asarray(graph.cols, jnp.int32))
    s_len = 33                                   # odd: trailing link
    ds = jax.jit(lambda k: sample_minibatches_device(
        cfg, tr, ho, k, s_len, adj))(jax.random.PRNGKey(11))
    training = set(pack_edges(graph.edges_u, graph.edges_v).tolist())
    w = np.asarray(ds.weight)
    masks = np.asarray(ds.edge_mask)
    for s in range(s_len):
        eu = np.asarray(ds.edges_u[s])[masks[s]]
        ev = np.asarray(ds.edges_v[s])[masks[s]]
        keys = pack_edges(eu, ev)
        if s % 2 == 0:                           # link step
            assert w[s] == cfg.N, s
            assert all(int(x) in training for x in keys), s
        else:                                    # non-link step
            m_eff = masks[s].sum()
            assert np.isclose(w[s] * m_eff, 2.0 * cfg.E), s
            assert not any(int(x) in training for x in keys), s


def test_alternate_coin_chain_period(setup):
    """alt_period=C alternates by STEP: every chain of a step draws
    the same kind (no chain is pinned to one strategy)."""
    from mcmc_ammsb.ops.device_sampling import \
        sample_minibatches_device

    n, split, graph, tr, ho = setup
    cfg = _cfg(setup, SampleStrategy.NODE).replace(node_coin="alternate")
    adj = (jnp.asarray(graph.offsets, jnp.int32),
           jnp.asarray(graph.cols, jnp.int32))
    c, steps = 3, 8
    ds = jax.jit(lambda k: sample_minibatches_device(
        cfg, tr, ho, k, steps * c, adj, alt_period=c))(
        jax.random.PRNGKey(12))
    w = np.asarray(ds.weight).reshape(steps, c)
    link_like = w == cfg.N
    for s in range(steps):
        assert (link_like[s] == (s % 2 == 0)).all(), (s, w[s])


@pytest.mark.slow  # e2e train; test_fused_loop_trains is the quick-tier canary
def test_alternate_coin_trains_and_rejects_host_sampling(setup):
    n, split, graph, tr, ho = setup
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=8,
                 device_sampling=True, steps_per_call=25,
                 node_coin="alternate")
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    lrn = Learner(cfg, graph, split, prefetch=False)
    p0 = lrn.heldout_perplexity()
    lrn.run(200)
    p1 = lrn.heldout_perplexity()
    assert np.isfinite([p0, p1]).all() and p1 < p0
    lrn.close()
    with pytest.raises(ValueError, match="alternate"):
        Config(K=8, device_sampling=False,
               node_coin="alternate").finalize(
            n, split.total_edges, graph.max_fan_out)


def test_structural_nodes_match_sorted_dedup(setup):
    """_structural_nodes (lane 0 = pivot, lane 1+i = edge lane i's
    partner; no sorts) is set-equal per batch to the sort-based
    _extract_nodes golden for every Node-family strategy."""
    from mcmc_ammsb.ops.device_sampling import (
        _extract_nodes, sample_minibatches_device)

    n, split, graph, tr, ho = setup
    for strategy in (SampleStrategy.NODE, SampleStrategy.NODE_LINK,
                     SampleStrategy.NODE_NON_LINK):
        cfg = _cfg(setup, strategy)
        adj = (jnp.asarray(graph.offsets, jnp.int32),
               jnp.asarray(graph.cols, jnp.int32))
        ds = jax.jit(lambda k: sample_minibatches_device(
            cfg, tr, ho, k, 64, adj))(jax.random.PRNGKey(9))
        ref_nodes, ref_mask = jax.jit(
            lambda e, f, m: _extract_nodes(cfg, e, f, m))(
            ds.edges_u, ds.edges_v, ds.edge_mask)
        got_n, got_m = np.asarray(ds.nodes), np.asarray(ds.node_mask)
        ref_n, ref_m = np.asarray(ref_nodes), np.asarray(ref_mask)
        for s in range(64):
            got = got_n[s][got_m[s]]
            assert len(set(got.tolist())) == len(got), strategy
            assert set(got.tolist()) == set(
                ref_n[s][ref_m[s]].tolist()), strategy


def test_fused_loop_trains(setup):
    n, split, graph, tr, ho = setup
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=8,
                 device_sampling=True, steps_per_call=25)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    lrn = Learner(cfg, graph, split, prefetch=False)
    p0 = lrn.heldout_perplexity()
    lrn.run(100)
    p1 = lrn.heldout_perplexity()
    assert int(lrn.state.step_count) == 101
    assert np.isfinite([p0, p1]).all() and p1 < p0
    lrn.close()


def test_device_sampling_perfect_backend_with_adjacency(setup):
    """Non-CSR membership backends supply the graph CSR explicitly;
    link strategies without it must raise."""
    import jax.numpy as jnp
    n, split, graph, _, _ = setup
    tr = build_edge_set(EdgeSetBackend.PERFECT, n, graph.edges_u,
                        graph.edges_v)
    ho = build_edge_set(EdgeSetBackend.PERFECT, n, split.heldout_u,
                        split.heldout_v)
    cfg = _cfg(setup, SampleStrategy.NODE)
    adj = (jnp.asarray(graph.offsets, jnp.int32),
           jnp.asarray(graph.cols, jnp.int32))
    ds = jax.jit(lambda k: sample_minibatch_device(cfg, tr, ho, k, adj))(
        jax.random.PRNGKey(0))
    assert bool(ds.edge_mask.any())
    with pytest.raises(ValueError, match="adjacency"):
        sample_minibatch_device(cfg, tr, ho, jax.random.PRNGKey(0))


# ---------------------------------------------------------------------------
# degree-capped NodeLink (ds_link_cap): heavy-tail graphs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hub_setup():
    """A star hub (degree 50) plus a ring so every node is non-isolated."""
    d = 50
    u = np.concatenate([np.zeros(d, np.int32),
                        np.arange(1, d + 1, dtype=np.int32)])
    v = np.concatenate([np.arange(1, d + 1, dtype=np.int32),
                        np.arange(1, d + 1, dtype=np.int32) % d + 1])
    graph = Graph.from_edges(d + 1, u, v)
    tr = build_edge_set(EdgeSetBackend.CSR, d + 1, graph.edges_u,
                        graph.edges_v)
    # empty-ish held-out set (one self-pair never queried as an edge)
    ho = build_edge_set(EdgeSetBackend.CSR, d + 1,
                        np.array([0], np.int32), np.array([0], np.int32))
    return d, graph, tr, ho


def test_link_cap_shrinks_buffers_and_validates():
    cfg = Config(mini_batch_size=8, strategy=SampleStrategy.NODE_LINK,
                 device_sampling=True, ds_link_cap=16)
    cfg = cfg.finalize(1000, 5000, 300)
    assert cfg.max_batch_edges == 16
    assert cfg.max_batch_nodes == 17
    with pytest.raises(ValueError, match="device-sampling lever"):
        Config(ds_link_cap=16).finalize(1000, 5000, 300)
    with pytest.raises(ValueError, match=">= 0"):
        Config(ds_link_cap=-1, device_sampling=True).finalize(100, 50, 3)


def test_link_cap_hub_batches_valid_and_reweighted(hub_setup):
    """Capped hub draws: distinct training edges through the pivot,
    HT weight N/p; small-degree pivots keep the exact reference batch."""
    from mcmc_ammsb.ops.device_sampling import sample_minibatches_device
    d, graph, tr, ho = hub_setup
    cap = 8
    cfg = Config(K=4, mini_batch_size=cap, num_node_sample=4,
                 strategy=SampleStrategy.NODE_LINK, device_sampling=True,
                 ds_link_cap=cap).finalize(d + 1, len(graph.edges_u),
                                           graph.max_fan_out)
    assert cfg.max_batch_edges == cap
    training = set(pack_edges(graph.edges_u, graph.edges_v).tolist())
    S = 512
    ds = jax.jit(lambda k: sample_minibatches_device(cfg, tr, ho, k, S))(
        jax.random.PRNGKey(3))
    piv = np.asarray(ds.nodes[:, 0])
    cnt = np.asarray(ds.edge_mask.sum(-1))
    w = np.asarray(ds.weight)
    eu, ev = np.asarray(ds.edges_u), np.asarray(ds.edges_v)
    mask = np.asarray(ds.edge_mask)
    p_inc = 1.0 - (1.0 - 1.0 / d) ** cap
    hub = piv == 0
    assert hub.any() and (~hub).any()
    np.testing.assert_allclose(w[hub], cfg.N / p_inc, rtol=1e-6)
    assert (w[~hub] == cfg.N).all()
    assert (cnt[~hub] == 3).all()          # ring degree, take-all path
    for i in np.flatnonzero(hub)[:50]:
        pairs = list(zip(eu[i][mask[i]].tolist(), ev[i][mask[i]].tolist()))
        assert len(set(pairs)) == len(pairs)            # keep-first dedup
        assert all(pack_edges(np.array([a], np.int32),
                              np.array([b], np.int32))[0] in training
                   for a, b in pairs)
        assert all(0 in p for p in pairs)               # all through pivot


def test_link_cap_weight_unbiased(hub_setup):
    """E[weight * kept-edge count | pivot] == N * degree(pivot) — the
    invariant the take-all path satisfies exactly, recovered in
    expectation by the Horvitz-Thompson reweight on capped hubs."""
    from mcmc_ammsb.ops.device_sampling import sample_minibatches_device
    d, graph, tr, ho = hub_setup
    cfg = Config(K=4, mini_batch_size=8, num_node_sample=4,
                 strategy=SampleStrategy.NODE_LINK, device_sampling=True,
                 ds_link_cap=8).finalize(d + 1, len(graph.edges_u),
                                         graph.max_fan_out)
    S = 20000
    ds = jax.jit(lambda k: sample_minibatches_device(cfg, tr, ho, k, S))(
        jax.random.PRNGKey(0))
    piv = np.asarray(ds.nodes[:, 0])
    est = (np.asarray(ds.weight) * np.asarray(ds.edge_mask.sum(-1)))
    hub = piv == 0
    assert hub.sum() > 200
    np.testing.assert_allclose(est[hub].mean() / cfg.N, d, rtol=0.05)


def test_link_cap_off_is_bit_exact():
    """cap >= max_fan_out (or cap unset) leaves the draw stream
    untouched — pinned trajectories stay pinned."""
    from mcmc_ammsb.ops.device_sampling import sample_minibatches_device
    n, u, v = synthetic_edges(300, 8, seed=4)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=5)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    tr = build_edge_set(EdgeSetBackend.CSR, n, graph.edges_u, graph.edges_v)
    ho = build_edge_set(EdgeSetBackend.CSR, n, split.heldout_u,
                        split.heldout_v)
    base = Config(K=4, mini_batch_size=8, num_node_sample=4,
                  strategy=SampleStrategy.NODE, device_sampling=True)
    cfg0 = base.finalize(n, split.total_edges, graph.max_fan_out)
    cfg1 = base.replace(ds_link_cap=graph.max_fan_out + 5).finalize(
        n, split.total_edges, graph.max_fan_out)
    assert cfg1.max_batch_edges == cfg0.max_batch_edges
    k = jax.random.PRNGKey(11)
    a = jax.jit(lambda k: sample_minibatches_device(cfg0, tr, ho, k, 32))(k)
    b = jax.jit(lambda k: sample_minibatches_device(cfg1, tr, ho, k, 32))(k)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.slow  # e2e powerlaw train; unit cap tests cover quick
def test_link_cap_fused_loop_trains_on_powerlaw():
    """End-to-end: the fused device-sampled loop trains on a
    heavy-tailed graph with buffers sized by the cap, not the hub."""
    from mcmc_ammsb.data import synthetic_powerlaw_edges
    n, u, v = synthetic_powerlaw_edges(600, avg_degree=8, exponent=2.2,
                                       seed=7)
    split = generate_sets(n, u, v, heldout_ratio=0.05, seed=8)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cap = 16
    assert graph.max_fan_out > cap, "fixture must actually have a hub"
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=8,
                 device_sampling=True, steps_per_call=25,
                 ds_link_cap=cap)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    assert cfg.max_batch_edges == cap
    lrn = Learner(cfg, graph, split, prefetch=False)
    p0 = lrn.heldout_perplexity()
    lrn.run(150)
    p1 = lrn.heldout_perplexity()
    assert int(lrn.state.step_count) == 151
    assert np.isfinite([p0, p1]).all() and p1 < p0
    lrn.close()
