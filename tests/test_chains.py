"""Multi-chain learner tests: independent trajectories, per-chain
perplexity, R-hat diagnostic."""

import numpy as np
import pytest

from mcmc_ammsb.chains import MultiChainLearner, rhat
from mcmc_ammsb.config import Config
from mcmc_ammsb.data import Graph, generate_sets, synthetic_sbm_edges

pytestmark = pytest.mark.slow  # quick tier: -m 'not slow'


@pytest.fixture(scope="module")
def chain_learner():
    n, u, v = synthetic_sbm_edges(300, 4, p_in=0.15, p_out=0.005, seed=8)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=9)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=8,
                 steps_per_call=20)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    return MultiChainLearner(cfg, graph, split, num_chains=3)


def test_chains_advance_together(chain_learner):
    l = chain_learner
    assert l.states.pi.shape[0] == 3
    p0 = l.heldout_perplexity()
    assert p0.shape == (3,)
    l.run(60)
    assert np.all(np.asarray(l.states.step_count) == 61)
    p1 = l.heldout_perplexity()
    assert np.isfinite(p1).all()
    assert (p1 < p0).all()  # every chain improves


def test_chains_are_independent(chain_learner):
    l = chain_learner
    pi = np.asarray(l.states.pi)
    # overdispersed inits + independent streams: chains differ
    assert not np.allclose(pi[0], pi[1])
    assert not np.allclose(pi[1], pi[2])


def test_rhat_math():
    rng = np.random.RandomState(0)
    # identical-distribution chains -> rhat ~ 1
    same = rng.randn(4, 500, 3)
    r = rhat(same)
    assert r.shape == (3,)
    assert np.all(r < 1.05)
    # shifted chain -> rhat >> 1
    shifted = same.copy()
    shifted[0] += 5.0
    assert np.all(rhat(shifted) > 1.5)


def test_beta_rhat_runs(chain_learner):
    r = chain_learner.beta_rhat(draws=3)
    assert r.shape == (chain_learner.cfg.K,)
    assert np.isfinite(r).all()


def test_beta_rhat_flat_engine(chain_learner):
    """beta_rhat on the production (flat) engine: same diagnostic over
    state.beta [C, K] via the shared beta_rhat_series helper."""
    from mcmc_ammsb.chains_flat import FlatChainLearner

    l = chain_learner  # reuse the module dataset/config
    flat = FlatChainLearner(l.cfg, l.graph, l.split, num_chains=3)
    r = flat.beta_rhat(draws=3)
    assert r.shape == (l.cfg.K,)
    assert np.isfinite(r).all() and np.all(r > 0)


def test_cli_rhat_draws(caplog):
    """--rhat-draws logs the Gelman-Rubin table after a chain run and
    validates its preconditions."""
    import logging

    from mcmc_ammsb import cli

    argv = ["--synthetic", "200,6", "-k", "8", "-m", "8", "-n", "4",
            "--heldout-ratio", "0.1", "--num-chains", "2", "-x", "10",
            "-i", "10", "--steps-per-call", "5", "--rhat-draws", "2"]
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb"):
        rc = cli.main(argv)
    assert rc == 0
    assert "beta R-hat over 2 chains" in caplog.text

    assert cli.main(argv[:-1] + ["1"]) == 1          # draws < 2
    single = ["--synthetic", "200,6", "-k", "8", "-x", "5", "-i", "5",
              "--rhat-draws", "2"]
    assert cli.main(single) == 1                     # single chain
