"""Shared-neighbor sampling: one n-draw per step instead of per node.

Validity argument lives in the config.py knob doc; these tests pin the
math (masking is exactly lane exclusion with a count-aware scale), the
scan/single-step bit-identity, and convergence of the full loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_ammsb.config import Config, RngBackend
from mcmc_ammsb.data import Graph, generate_sets, synthetic_sbm_edges
from mcmc_ammsb.learner import Learner
from mcmc_ammsb.ops import phi as phi_ops

pytestmark = pytest.mark.slow  # quick tier: -m 'not slow'


def _core_inputs(b, n, k, seed=0):
    rng = np.random.RandomState(seed)
    pi_raw = rng.gamma(1.0, 1.0, (b, k)).astype(np.float32)
    phis = pi_raw.sum(-1)
    pi_n = pi_raw / phis[:, None]
    nb_raw = rng.gamma(1.0, 1.0, (b, n, k)).astype(np.float32)
    pi_nb = nb_raw / nb_raw.sum(-1, keepdims=True)
    y = rng.rand(b, n) < 0.3
    beta = rng.rand(k).astype(np.float32)
    noise = rng.randn(b, k).astype(np.float32)
    return (jnp.asarray(pi_n), jnp.asarray(phis), jnp.asarray(pi_nb),
            jnp.asarray(y), jnp.asarray(beta), noise)


def test_all_true_mask_is_bitwise_identity():
    cfg = Config(K=8, mini_batch_size=4, num_node_sample=5).finalize(
        100, 50, 10)
    pi_n, phis, pi_nb, y, beta, noise = _core_inputs(4, 5, 8)
    step = jnp.asarray(3, jnp.int32)
    a = phi_ops.phi_update_core(cfg, pi_n, phis, pi_nb, y, beta, step,
                                jnp.asarray(noise))
    b = phi_ops.phi_update_core(cfg, pi_n, phis, pi_nb, y, beta, step,
                                jnp.asarray(noise),
                                jnp.ones((4, 5), jnp.bool_))
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


def test_masked_lane_equals_dropping_the_neighbor():
    """Masking lane j with the count-aware scale must equal running the
    core with that neighbor physically removed (n-1 config) — the
    correctness contract of the self-collision handling."""
    n = 5
    cfg5 = Config(K=8, mini_batch_size=4, num_node_sample=n).finalize(
        100, 50, 10)
    cfg4 = cfg5.replace(num_node_sample=n - 1)
    pi_n, phis, pi_nb, y, beta, noise = _core_inputs(4, n, 8)
    step = jnp.asarray(7, jnp.int32)
    drop = 2
    mask = np.ones((4, n), bool)
    mask[:, drop] = False
    got = phi_ops.phi_update_core(cfg5, pi_n, phis, pi_nb, y, beta,
                                  step, jnp.asarray(noise),
                                  jnp.asarray(mask))
    keep = [i for i in range(n) if i != drop]
    want = phi_ops.phi_update_core(
        cfg4, pi_n, phis, pi_nb[:, keep], y[:, keep], beta, step,
        jnp.asarray(noise))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=1e-6)
    # and the masked lane's CONTENT is irrelevant
    pi_nb2 = pi_nb.at[:, drop].set(1.0 / 8)
    got2 = phi_ops.phi_update_core(cfg5, pi_n, phis, pi_nb2, y, beta,
                                   step, jnp.asarray(noise),
                                   jnp.asarray(mask))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(got2[0]))


@pytest.fixture(scope="module")
def sbm():
    n, u, v = synthetic_sbm_edges(1000, 4, p_in=0.08, p_out=0.002, seed=13)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=14)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    return n, split, graph


def make_learner(sbm, **kw):
    n, split, graph = sbm
    kw.setdefault("steps_per_call", 25)
    cfg = Config(K=8, mini_batch_size=16, num_node_sample=16, **kw)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    return Learner(cfg, graph, split, prefetch=False)


def test_shared_scan_matches_single_steps(sbm):
    """Scan path == step-at-a-time path with shared draws (the identity
    the private-draw paths pin). numpy host sampler: only it keeps one
    RNG stream across sample()/sample_many (the native sampler reseeds
    per chunk); tolerance covers fusion-order fp32 rounding only."""
    a = make_learner(sbm, shared_neighbors=True, steps_per_call=1,
                     host_sampler="numpy")
    b = make_learner(sbm, shared_neighbors=True, steps_per_call=5,
                     host_sampler="numpy")
    a.run(10)
    b.run(10)
    np.testing.assert_allclose(np.asarray(a.state.pi),
                               np.asarray(b.state.pi),
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(a.state.theta),
                               np.asarray(b.state.theta),
                               rtol=2e-4, atol=1e-7)
    a.close(); b.close()


def test_shared_neighbors_converges_like_private(sbm):
    """Statistical equivalence on a planted-partition graph: the shared
    variant's held-out perplexity after the same number of steps lands
    within a few percent of the private-draw run."""
    priv = make_learner(sbm)
    shar = make_learner(sbm, shared_neighbors=True)
    p0 = priv.heldout_perplexity()
    s0 = shar.heldout_perplexity()
    assert p0 == s0  # identical init
    priv.run(2000)
    shar.run(2000)
    p1 = priv.heldout_perplexity()
    s1 = shar.heldout_perplexity()
    assert s1 < 0.9 * s0          # converges outright
    assert abs(s1 - p1) / p1 < 0.05, (p1, s1)
    priv.close(); shar.close()


def test_shared_neighbors_device_sampled(sbm):
    lrn = make_learner(sbm, shared_neighbors=True, device_sampling=True)
    p0 = lrn.heldout_perplexity()
    lrn.run(500)
    p1 = lrn.heldout_perplexity()
    assert np.isfinite(p1) and p1 < p0
    lrn.close()


def test_shared_neighbors_rejects_incompatible_backends(sbm):
    with pytest.raises(ValueError, match="shared_neighbors"):
        make_learner(sbm, shared_neighbors=True,
                     rng_backend=RngBackend.REFERENCE)
