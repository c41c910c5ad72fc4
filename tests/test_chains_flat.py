"""Flat-layout multi-chain engine tests."""

import numpy as np
import pytest

from mcmc_ammsb.chains_flat import FlatChainLearner
from mcmc_ammsb.config import Config
from mcmc_ammsb.data import Graph, generate_sets, synthetic_sbm_edges

pytestmark = pytest.mark.slow  # quick tier: -m 'not slow'


@pytest.fixture(scope="module")
def flat_learner():
    n, u, v = synthetic_sbm_edges(300, 4, p_in=0.15, p_out=0.005, seed=8)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=9)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=8,
                 steps_per_call=20)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    return FlatChainLearner(cfg, graph, split, num_chains=3), n


def test_flat_chains_train(flat_learner):
    l, n = flat_learner
    p0 = l.heldout_perplexity()
    assert p0.shape == (3,)
    l.run(80)
    assert int(l.state.step_count) == 81
    p1 = l.heldout_perplexity()
    assert np.isfinite(p1).all()
    assert (p1 < p0).all()


def test_flat_chains_rows_normalized_and_independent(flat_learner):
    l, n = flat_learner
    pi = np.asarray(l.state.pi)
    c = l.num_chains
    pi3 = pi.reshape(c, n, -1)
    np.testing.assert_allclose(pi3.sum(-1), 1.0, atol=1e-5)
    assert not np.allclose(pi3[0], pi3[1])
    assert not np.allclose(pi3[1], pi3[2])
    # theta stays per-chain distinct
    th = np.asarray(l.state.theta)
    assert not np.allclose(th[0], th[1])


def _fresh_flat(num_chains=2):
    n, u, v = synthetic_sbm_edges(250, 4, p_in=0.15, p_out=0.005, seed=21)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=22)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                 steps_per_call=5)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    return FlatChainLearner(cfg, graph, split, num_chains=num_chains)


def test_flat_chains_shared_neighbors_converge_like_private():
    """The shared per-(step,chain) neighbor draw is the chain-engine
    version of the single-chain fast path: each chain keeps its own
    independent stream; per-chain held-out ppx must land within a few
    percent of the private-draw engine after the same steps."""
    n, u, v = synthetic_sbm_edges(300, 4, p_in=0.15, p_out=0.005, seed=8)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=9)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=8,
                 steps_per_call=20)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    a = FlatChainLearner(cfg.replace(shared_neighbors=True), graph,
                         split, num_chains=3)
    b = FlatChainLearner(cfg, graph, split, num_chains=3)
    a.run(400); b.run(400)
    pa, pb = a.heldout_perplexity(), b.heldout_perplexity()
    assert np.isfinite(pa).all() and (pa > 1.0).all()
    np.testing.assert_allclose(pa, pb, rtol=0.06)
    # chains stay distinct (independent neighbor streams per chain)
    pi = np.asarray(a.state.pi).reshape(3, n, -1)
    assert not np.allclose(pi[0], pi[1])


def test_flat_chains_checkpoint_bit_exact_resume(tmp_path):
    """The multi-chain engine checkpoints like the single-chip learner
    (serialize-test.cc EndToEnd pattern): run, save, run on; restore,
    run the same steps; trajectories bit-exact per chain."""
    from mcmc_ammsb.checkpoint import load_checkpoint, save_checkpoint

    path = str(tmp_path / "flat_ck.npz")
    a = _fresh_flat()
    a.run(10)
    save_checkpoint(path, a)
    a.run(10)
    ppx_a = a.heldout_perplexity()

    b = _fresh_flat()
    load_checkpoint(path, b)
    assert int(b.state.step_count) == 11
    b.run(10)
    ppx_b = b.heldout_perplexity()
    np.testing.assert_array_equal(ppx_a, ppx_b)
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))


def test_flat_chains_checkpoint_rejects_chain_mismatch(tmp_path):
    from mcmc_ammsb.checkpoint import load_checkpoint, save_checkpoint

    path = str(tmp_path / "flat_ck2.npz")
    save_checkpoint(path, _fresh_flat(num_chains=2))
    with pytest.raises(ValueError, match="num_chains"):
        load_checkpoint(path, _fresh_flat(num_chains=3))


def test_flat_chains_fused_ppx_series_matches_host_loop():
    """run_with_ppx on the chain engine: same bit-exactness contract
    as Learner.run_with_ppx, per chain."""
    n, u, v = synthetic_sbm_edges(250, 4, p_in=0.15, p_out=0.005, seed=21)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=22)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                 steps_per_call=40)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    a = FlatChainLearner(cfg, graph, split, num_chains=2)
    b = FlatChainLearner(cfg, graph, split, num_chains=2)

    series = a.run_with_ppx(45, 10)   # 4 evals + 5-step tail
    assert [ev["step"] for ev in series] == [11, 21, 31, 41]
    assert int(a.state.step_count) == 46

    for ev in series:
        b.run(10)
        np.testing.assert_array_equal(ev["ppx"], b.heldout_perplexity())
    b.run(5)
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))


def test_vmap_chains_shared_neighbors_smoke():
    """The vmap cross-check engine composes train_steps_fused, so
    shared draws work per chain there too."""
    from mcmc_ammsb.chains import MultiChainLearner

    n, u, v = synthetic_sbm_edges(250, 4, p_in=0.15, p_out=0.005, seed=21)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=22)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=8,
                 steps_per_call=20, shared_neighbors=True)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    l = MultiChainLearner(cfg, graph, split, num_chains=2)
    p0 = l.heldout_perplexity()
    l.run(200)
    p1 = l.heldout_perplexity()
    assert np.isfinite(p1).all() and (p1 < p0).all()


def _windowed_pair(window, num_chains=3, n_nodes=300):
    """Sequential vs windowed chain engines on a collision-heavy graph
    (small N makes intra-window collisions frequent, stressing the
    exact staged-row corrections)."""
    from mcmc_ammsb.data import synthetic_edges

    n, u, v = synthetic_edges(n_nodes, 8, seed=21)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=22)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=8,
                 steps_per_call=24, device_sampling=True,
                 shared_neighbors=True)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    seq = FlatChainLearner(cfg, graph, split, num_chains)
    win = FlatChainLearner(cfg.replace(window=window), graph, split,
                           num_chains)
    return seq, win


def test_windowed_chains_match_sequential():
    """The windowed multi-chain engine reproduces the sequential chain
    scan's trajectory — all chains, collision corrections included."""
    seq, win = _windowed_pair(window=4)
    seq.run(24)
    win.run(24)
    assert int(win.state.step_count) == int(seq.state.step_count)
    np.testing.assert_allclose(np.asarray(win.state.pi),
                               np.asarray(seq.state.pi),
                               rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(np.asarray(win.state.theta),
                               np.asarray(seq.state.theta),
                               rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(win.heldout_perplexity(),
                               seq.heldout_perplexity(), rtol=1e-5)


def test_windowed_chains_tail_and_ppx_series():
    """Non-multiple tails run sequentially; the fused per-chain eval
    series matches the sequential engine's."""
    seq, win = _windowed_pair(window=5)
    s1 = seq.run_with_ppx(23, 6)
    s2 = win.run_with_ppx(23, 6)
    assert [e["step"] for e in s1] == [e["step"] for e in s2]
    for e1, e2 in zip(s1, s2):
        np.testing.assert_allclose(e2["ppx"], e1["ppx"], rtol=1e-5)
    assert int(win.state.step_count) == int(seq.state.step_count)


def test_windowed_chains_require_shared_draws():
    from mcmc_ammsb.data import synthetic_edges

    n, u, v = synthetic_edges(300, 8, seed=21)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=22)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=8,
                 window=4).finalize(n, split.total_edges,
                                    graph.max_fan_out)
    with pytest.raises(ValueError, match="shared_neighbors"):
        FlatChainLearner(cfg, graph, split, 2)


def test_windowed_chains_with_link_cap_match_sequential():
    """Capped hub draws flow through the blocked chain window kernel:
    the windowed trajectory equals the sequential chain scan's on a
    heavy-tailed graph with ds_link_cap binding."""
    from mcmc_ammsb.data import synthetic_powerlaw_edges

    n, u, v = synthetic_powerlaw_edges(300, 6, exponent=2.2,
                                       max_degree=60, seed=31)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=32)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=8,
                 steps_per_call=24, device_sampling=True,
                 shared_neighbors=True, ds_link_cap=8)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    assert graph.max_fan_out > 8
    seq = FlatChainLearner(cfg, graph, split, 3)
    win = FlatChainLearner(cfg.replace(window=4), graph, split, 3)
    seq.run(24)
    win.run(24)
    assert int(win.state.step_count) == int(seq.state.step_count)
    np.testing.assert_allclose(np.asarray(win.state.pi),
                               np.asarray(seq.state.pi),
                               rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(win.heldout_perplexity(),
                               seq.heldout_perplexity(), rtol=1e-5)
