"""Chains-over-devices engine: whole chains per chip, no collectives.

Runs on the 8-device virtual CPU mesh (conftest). Beyond-reference
capability (the reference is single-GPU single-chain,
/root/reference/main.cc:94-96); correctness contract = per-chain
update semantics of FlatChainLearner + group-independent RNG streams
+ the generic checkpoint's bit-exact resume."""

import numpy as np
import pytest

from mcmc_ammsb.config import Config
from mcmc_ammsb.data import Graph, generate_sets, synthetic_sbm_edges
from mcmc_ammsb.parallel.chains_sharded import (ShardedChainLearner,
                                                make_chain_mesh)

pytestmark = pytest.mark.slow  # quick tier: -m 'not slow'


def _make(num_chains=8, groups=4, spc=10, seed=8, **cfg_kw):
    n, u, v = synthetic_sbm_edges(300, 4, p_in=0.15, p_out=0.005,
                                  seed=seed)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=seed + 1)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=8,
                 steps_per_call=spc, **cfg_kw)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    return ShardedChainLearner(cfg, graph, split, num_chains,
                               make_chain_mesh(groups)), n


@pytest.fixture(scope="module")
def chains8():
    return _make()


def test_sharded_chains_train(chains8):
    l, n = chains8
    p0 = l.heldout_perplexity()
    assert p0.shape == (8,)
    l.run(60)
    assert int(l.state.step_count) == 61
    p1 = l.heldout_perplexity()
    assert np.isfinite(p1).all()
    assert (p1 < p0).all()


def test_sharded_chains_rows_normalized_chains_distinct(chains8):
    l, n = chains8
    pi = np.asarray(l.state.pi).reshape(l.num_chains, n, -1)
    np.testing.assert_allclose(pi.sum(-1), 1.0, atol=1e-5)
    # chains within one group AND across groups must all differ
    assert not np.allclose(pi[0], pi[1])      # same group
    assert not np.allclose(pi[0], pi[2])      # neighboring group
    # per-group RNG streams are distinct by construction
    keys = np.asarray(
        np.frombuffer(np.asarray(
            __import__("jax").random.key_data(l.state.sample_key)
        ).tobytes(), np.uint32)).reshape(4, -1)
    assert len({k.tobytes() for k in keys}) == 4


def test_sharded_chains_deterministic():
    a, _ = _make(num_chains=4, groups=2, spc=5, seed=30)
    b, _ = _make(num_chains=4, groups=2, spc=5, seed=30)
    a.run(20)
    b.run(20)
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
    np.testing.assert_array_equal(a.heldout_perplexity(),
                                  b.heldout_perplexity())


def test_sharded_chains_checkpoint_bit_exact_resume(tmp_path):
    from mcmc_ammsb.checkpoint import load_checkpoint, save_checkpoint

    a, _ = _make(num_chains=4, groups=2, spc=5, seed=40)
    a.run(10)
    path = str(tmp_path / "chains.npz")
    save_checkpoint(path, a)
    a.run(15)
    ppx_a = a.heldout_perplexity()

    b, _ = _make(num_chains=4, groups=2, spc=5, seed=40)
    load_checkpoint(path, b)
    assert int(b.state.step_count) == int(a.state.step_count) - 15
    b.run(15)
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
    np.testing.assert_array_equal(ppx_a, b.heldout_perplexity())


def test_sharded_chains_geometry_errors():
    with pytest.raises(ValueError, match="divisible"):
        _make(num_chains=3, groups=2)


def test_sharded_chains_windowed_matches_sequential():
    """The windowed chain engine rides inside the ('chains',)
    shard_map unchanged (each device windows its own chain block):
    windowed sharded chains reproduce the sequential sharded-chain
    trajectory — the test_window.py exactness contract per device."""
    seq, n = _make(num_chains=4, groups=2, spc=24, seed=50,
                   shared_neighbors=True)
    win, _ = _make(num_chains=4, groups=2, spc=24, seed=50,
                   shared_neighbors=True, window=4)
    seq.run(24)
    win.run(24)
    assert int(win.state.step_count) == int(seq.state.step_count)
    # window-vs-scan float scheduling: same tolerance class as the
    # flat engine's window goldens (test_chains_flat.py)
    np.testing.assert_allclose(np.asarray(win.state.pi),
                               np.asarray(seq.state.pi),
                               rtol=5e-5, atol=1e-8)
    np.testing.assert_allclose(np.asarray(win.state.theta),
                               np.asarray(seq.state.theta),
                               rtol=5e-5, atol=1e-8)
    np.testing.assert_allclose(win.heldout_perplexity(),
                               seq.heldout_perplexity(), rtol=1e-5)


def test_sharded_chains_window_requires_shared_draws():
    with pytest.raises(ValueError, match="shared_neighbors"):
        _make(num_chains=4, groups=2, window=4)


def test_sharded_chains_fused_ppx_series_matches_host_loop():
    """run_with_ppx across the chain mesh: same bit-exactness contract
    as FlatChainLearner's, per chain, all groups in one program."""
    a, _ = _make(num_chains=4, groups=2, spc=40)
    b, _ = _make(num_chains=4, groups=2, spc=40)

    series = a.run_with_ppx(45, 10)   # 4 evals + 5-step tail
    assert [ev["step"] for ev in series] == [11, 21, 31, 41]
    assert int(a.state.step_count) == 46
    for ev in series:
        assert ev["ppx"].shape == (4,)
        b.run(10)
        np.testing.assert_array_equal(ev["ppx"], b.heldout_perplexity())
    b.run(5)
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
