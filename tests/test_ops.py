"""Golden tests of the phi/beta/perplexity ops against the numpy oracle.

The reference validates its parallel kernel modes against each other at
2% relative tolerance with noise disabled (wg-phi-test.cc:116-158,
wg-beta-test.cc:105-154, wg-perplexity-test.cc:86-111); here the oracle
is an independent float64 numpy implementation, so we hold the jnp ops
to much tighter fp32 tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_ammsb.config import Config, EdgeSetBackend
from mcmc_ammsb.ops import beta as beta_ops
from mcmc_ammsb.ops import perplexity as ppx_ops
from mcmc_ammsb.ops import phi as phi_ops
from mcmc_ammsb.ops.edgeset import build_edge_set
from mcmc_ammsb.ops.neighbor import sample_neighbors
from mcmc_ammsb.ops.rowops import row_normalize, row_sums, slice_normalize

from oracle import (beta_grads_oracle, perplexity_oracle, phi_oracle,
                    theta_step_oracle)


@pytest.fixture(scope="module")
def model_fixture(small_dataset, small_config):
    n, split, graph = small_dataset
    cfg = small_config
    rng = np.random.RandomState(0)
    pi_raw = rng.gamma(1.0, 1.0, size=(n, cfg.K)).astype(np.float32)
    phi_sum = pi_raw.sum(-1)
    pi = pi_raw / phi_sum[:, None]
    theta = rng.gamma(1.0, 1.0, size=(cfg.K, 2)).astype(np.float32)
    beta = theta[:, 1] / theta.sum(-1)
    es = build_edge_set(EdgeSetBackend.CSR, n, graph.edges_u, graph.edges_v)
    return cfg, graph, pi, phi_sum, theta, beta, es


def test_rowops():
    rng = np.random.RandomState(1)
    # ragged-ish lengths incl. non-powers-of-2 (wg-sum-test.cc pattern)
    for cols in [1, 2, 5, 16, 33, 127, 128, 200]:
        x = rng.rand(7, cols).astype(np.float32) + 0.1
        np.testing.assert_allclose(np.asarray(row_sums(jnp.asarray(x))),
                                   x.sum(-1), rtol=1e-5)
        normed, sums = row_normalize(jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(normed), x / x.sum(-1, keepdims=True),
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(sums), x.sum(-1), rtol=1e-5)
    flat = rng.rand(12).astype(np.float32) + 0.1
    sn = np.asarray(slice_normalize(jnp.asarray(flat), 2))
    pair = flat.reshape(-1, 2)
    np.testing.assert_allclose(sn.reshape(-1, 2),
                               pair / pair.sum(-1, keepdims=True), rtol=1e-5)


def test_neighbor_sampler_invariants(small_config):
    """Distinctness + exclusion invariants (wg-sample-test.cc:22-72)."""
    cfg = small_config
    key = jax.random.PRNGKey(3)
    nodes = jnp.arange(40, dtype=jnp.int32)
    nbrs = np.asarray(jax.jit(
        lambda k, nd: sample_neighbors(k, nd, cfg.N, 16))(key, nodes))
    assert nbrs.shape == (40, 16)
    assert nbrs.min() >= 0 and nbrs.max() < cfg.N
    for i in range(40):
        row = nbrs[i]
        assert len(set(row.tolist())) == len(row), f"duplicates in row {i}"
        assert i not in row, f"self-sample in row {i}"


def test_phi_update_matches_oracle(model_fixture):
    cfg, graph, pi, phi_sum, theta, beta, es = model_fixture
    rng = np.random.RandomState(2)
    b = 12
    nodes = rng.choice(cfg.N, b, replace=False).astype(np.int32)
    neighbors = rng.randint(0, cfg.N, size=(b, cfg.num_node_sample)).astype(np.int32)
    noise = rng.randn(b, cfg.K).astype(np.float32)
    step = 5

    fn = jax.jit(lambda *a: phi_ops.phi_update_rows(cfg, *a))
    got_rows, got_sums = fn(
        jnp.asarray(pi), jnp.asarray(phi_sum), jnp.asarray(beta), es,
        jnp.asarray(nodes), jnp.asarray(neighbors),
        jnp.asarray(step, jnp.int32), jnp.asarray(noise),
    )
    want_rows, want_sums = phi_oracle(
        cfg, pi, phi_sum, beta, graph.has_edge, nodes, neighbors, step, noise
    )
    np.testing.assert_allclose(np.asarray(got_rows), want_rows,
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(got_sums), want_sums, rtol=2e-4)


def test_phi_scatter_dedup_and_mask(model_fixture):
    cfg, graph, pi, phi_sum, theta, beta, es = model_fixture
    nodes = jnp.asarray([3, 7, 0, 0], jnp.int32)  # last two masked out
    mask = jnp.asarray([True, True, False, False])
    rows = jnp.ones((4, cfg.K)) * jnp.arange(1, 5)[:, None]
    sums = jnp.asarray([10.0, 20.0, 30.0, 40.0])
    new_pi, new_phi = phi_ops.scatter_rows(
        jnp.asarray(pi), jnp.asarray(phi_sum), nodes, mask, rows, sums)
    np.testing.assert_allclose(np.asarray(new_pi[3]), 1.0)
    np.testing.assert_allclose(np.asarray(new_pi[7]), 2.0)
    np.testing.assert_allclose(np.asarray(new_phi[3]), 10.0)
    # masked writes dropped: row 0 unchanged
    np.testing.assert_allclose(np.asarray(new_pi[0]), pi[0], rtol=1e-6)


def test_beta_update_matches_oracle(model_fixture):
    cfg, graph, pi, phi_sum, theta, beta, es = model_fixture
    rng = np.random.RandomState(4)
    ne = 10
    # half real training edges, half random pairs
    eu = np.concatenate([graph.edges_u[:ne // 2],
                         rng.randint(0, cfg.N, ne // 2).astype(np.int32)])
    ev = np.concatenate([graph.edges_v[:ne // 2],
                         rng.randint(0, cfg.N, ne // 2).astype(np.int32)])
    keep = eu != ev
    eu, ev = eu[keep], ev[keep]
    pad = cfg.max_batch_edges
    peu = np.zeros(pad, np.int32); peu[:len(eu)] = eu
    pev = np.zeros(pad, np.int32); pev[:len(ev)] = ev
    mask = np.arange(pad) < len(eu)
    noise = rng.randn(cfg.K, 2).astype(np.float32)
    scale, count = 37.5, 3

    fn = jax.jit(lambda *a: beta_ops.update_beta(cfg, *a))
    got_theta, got_beta = fn(
        jnp.asarray(theta), jnp.asarray(beta), jnp.asarray(pi), es,
        jnp.asarray(peu), jnp.asarray(pev), jnp.asarray(mask),
        jnp.asarray(scale, jnp.float32), jnp.asarray(count, jnp.int32),
        jnp.asarray(noise),
    )
    grads = beta_grads_oracle(cfg, theta, beta, pi, graph.has_edge, eu, ev)
    want_theta, want_beta = theta_step_oracle(cfg, theta, grads, scale,
                                              count, noise)
    np.testing.assert_allclose(np.asarray(got_theta), want_theta,
                               rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got_beta), want_beta,
                               rtol=5e-4, atol=1e-6)


def test_perplexity_matches_oracle(model_fixture, small_dataset):
    cfg, graph, pi, phi_sum, theta, beta, es = model_fixture
    n, split, _ = small_dataset
    ho_set = build_edge_set(EdgeSetBackend.CSR, n, split.heldout_u,
                            split.heldout_v)
    eu, ev = split.heldout_edges_u, split.heldout_edges_v
    h = len(eu)
    ppx0 = np.random.RandomState(6).rand(h).astype(np.float32)

    def ho_oracle(a, b):
        row = np.concatenate([split.heldout_u, split.heldout_v])
        col = np.concatenate([split.heldout_v, split.heldout_u])
        return bool(np.any((row == a) & (col == b)))

    for count in (1, 4):
        fn = jax.jit(lambda *a: ppx_ops.perplexity_step(cfg, *a))
        res = fn(
            jnp.asarray(pi), jnp.asarray(beta), ho_set,
            jnp.asarray(eu), jnp.asarray(ev), jnp.asarray(ppx0),
            jnp.asarray(count, jnp.int32),
        )
        want_ppx, want_neg, y = perplexity_oracle(
            cfg, pi, beta, ho_oracle, eu, ev, ppx0, count)
        np.testing.assert_allclose(np.asarray(res.ppx_per_edge), want_ppx,
                                   rtol=2e-4)
        np.testing.assert_allclose(float(res.neg_avg_log), want_neg, rtol=2e-4)
        assert int(res.link_count) == int(y.sum())
        assert int(res.non_link_count) == int((~y).sum())


def test_row_sort():
    from mcmc_ammsb.ops.rowops import row_sort
    rng = np.random.RandomState(3)
    for cols in [2, 7, 64, 128, 1000]:  # incl. non-powers-of-2
        x = rng.rand(5, cols).astype(np.float32)
        got = np.asarray(row_sort(jnp.asarray(x)))
        np.testing.assert_allclose(got, np.sort(x, axis=-1), rtol=1e-6)


def test_perplexity_rejects_empty_population():
    from mcmc_ammsb.ops.perplexity import perplexity_core
    cfg = Config(K=4, num_node_sample=4).finalize(10, 20, 5)
    z = jnp.zeros((0, 4))
    with pytest.raises(ValueError, match="held-out"):
        perplexity_core(cfg, z, z, jnp.zeros(0, bool), jnp.zeros(0, bool),
                        jnp.ones(4), jnp.zeros(0), jnp.int32(1))
