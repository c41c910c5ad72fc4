"""Exact-equality pins for the block-decoded reference RNG
(rng/refblock.py) against the faithful while-loop implementations
(rng/reference.py, mirroring /root/reference/mcmc/random.cl.inc:221-274
and /root/reference/mcmc/sample.cc:13-78).

The block decoder must be BIT-identical: same values, same order, same
stream positions afterwards — including when a deliberately tiny buffer
pad forces mid-draw refills (the restart-handle path).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_ammsb.rng import reference as ref
from mcmc_ammsb.rng import refblock


def _seeds(seed_pair, lanes):
    return ref.make_seeds(seed_pair, lanes)


def _randn_loop(seeds, k, mask=None):
    cols = []
    for _ in range(k):
        x, seeds = ref.randn(seeds, mask)
        cols.append(x)
    return jnp.stack(cols, axis=-1), seeds


# the loop-twin oracle compiles one while region per draw, so large-k
# pins are multi-minute CPU compiles — slow tier (the quick tier keeps
# k<=2 + one refill/neighbor case of every code path)
_SLOW = pytest.mark.slow


@pytest.mark.parametrize("seed_pair",
                         [(42, 43),
                          pytest.param((6342455113 & 0xFFFFFFFF, 17),
                                       marks=_SLOW)])
@pytest.mark.parametrize("k", [1, 2, pytest.param(7, marks=_SLOW),
                               pytest.param(64, marks=_SLOW)])
def test_randn_block_bit_exact(seed_pair, k):
    lanes = 257
    want, want_seeds = _randn_loop(_seeds(seed_pair, lanes), k)
    got, got_seeds = refblock.randn_block(_seeds(seed_pair, lanes), k)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))
    np.testing.assert_array_equal(np.asarray(want_seeds),
                                  np.asarray(got_seeds))


def test_randn_block_mask_semantics():
    lanes, k = 64, 9
    mask = (jnp.arange(lanes) % 3) != 0
    want, want_seeds = _randn_loop(_seeds((5, 6), lanes), k, mask)
    want = jnp.where(mask[:, None], want, 0.0)
    got, got_seeds = refblock.randn_block(_seeds((5, 6), lanes), k,
                                          mask=mask)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))
    np.testing.assert_array_equal(np.asarray(want_seeds),
                                  np.asarray(got_seeds))


@pytest.mark.parametrize("pad", [0, pytest.param(1, marks=_SLOW),
                                 pytest.param(3, marks=_SLOW)])
def test_randn_block_tiny_pad_refill(pad):
    """Force many refills: buffer barely larger than k words, while a
    draw can consume up to 3 — exercises the mid-draw restart handle."""
    lanes, k = 31, 13
    want, want_seeds = _randn_loop(_seeds((1001, 7), lanes), k)
    got, got_seeds = refblock.randn_block(_seeds((1001, 7), lanes), k,
                                          pad=pad)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))
    np.testing.assert_array_equal(np.asarray(want_seeds),
                                  np.asarray(got_seeds))


@_SLOW
def test_randn_block_sequential_composition():
    """Two block calls back-to-back == one longer loop (stream position
    after call 1 is exact, not merely distribution-correct)."""
    lanes = 40
    want, _ = _randn_loop(_seeds((9, 9), lanes), 10)
    a, s = refblock.randn_block(_seeds((9, 9), lanes), 4)
    b, _ = refblock.randn_block(s, 6)
    got = jnp.concatenate([a, b], axis=1)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))


@pytest.mark.parametrize("num_nodes,num",
                         [(400, 8),
                          pytest.param(50, 20, marks=_SLOW),
                          pytest.param(1000, 32, marks=_SLOW)])
def test_neighbors_block_bit_exact(num_nodes, num):
    lanes = 65
    nodes = jnp.arange(lanes, dtype=jnp.int32) % num_nodes
    want, want_seeds = ref.sample_neighbors_reference(
        _seeds((3, 4), lanes), nodes, num_nodes, num)
    got, got_seeds = refblock.sample_neighbors_block(
        _seeds((3, 4), lanes), nodes, num_nodes, num)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))
    np.testing.assert_array_equal(np.asarray(want_seeds),
                                  np.asarray(got_seeds))


def test_neighbors_block_tiny_pad_refill():
    """num=20 from 25 nodes with pad=2: heavy duplicate rejection and
    guaranteed refills — exercises the cross-buffer duplicate check."""
    lanes, num_nodes, num = 33, 25, 20
    nodes = jnp.arange(lanes, dtype=jnp.int32) % num_nodes
    want, want_seeds = ref.sample_neighbors_reference(
        _seeds((77, 78), lanes), nodes, num_nodes, num)
    got, got_seeds = refblock.sample_neighbors_block(
        _seeds((77, 78), lanes), nodes, num_nodes, num, pad=2)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))
    np.testing.assert_array_equal(np.asarray(want_seeds),
                                  np.asarray(got_seeds))


def test_neighbors_block_mask_semantics():
    lanes, num_nodes, num = 48, 300, 16
    nodes = (jnp.arange(lanes, dtype=jnp.int32) * 7) % num_nodes
    mask = (jnp.arange(lanes) % 4) != 1
    want, want_seeds = ref.sample_neighbors_reference(
        _seeds((11, 12), lanes), nodes, num_nodes, num, mask)
    got, got_seeds = refblock.sample_neighbors_block(
        _seeds((11, 12), lanes), nodes, num_nodes, num, mask=mask)
    live = np.asarray(mask)
    np.testing.assert_array_equal(np.asarray(want)[live],
                                  np.asarray(got)[live])
    np.testing.assert_array_equal(np.asarray(want_seeds),
                                  np.asarray(got_seeds))


@pytest.mark.slow
def test_learner_block_vs_loop_bit_exact():
    """End-to-end: the full reference-backend training trajectory is
    bit-identical whichever decoder runs (Config.ref_rng_block)."""
    from mcmc_ammsb.config import Config, RngBackend
    from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
    from mcmc_ammsb.learner import Learner

    def build(block):
        n, u, v = synthetic_edges(200, 8, seed=41)
        split = generate_sets(n, u, v, heldout_ratio=0.1, seed=42)
        graph = Graph.from_edges(n, split.training_u, split.training_v)
        cfg = Config(K=8, mini_batch_size=8, num_node_sample=4,
                     rng_backend=RngBackend.REFERENCE,
                     ref_rng_block=block)
        cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
        return Learner(cfg, graph, split, prefetch=False)

    a, b = build(True), build(False)
    a.run(30); b.run(30)
    np.testing.assert_array_equal(np.asarray(a.state.pi),
                                  np.asarray(b.state.pi))
    np.testing.assert_array_equal(np.asarray(a.state.theta),
                                  np.asarray(b.state.theta))
    for fa, fb in zip(a.state.ref_seeds, b.state.ref_seeds):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
    a.close(); b.close()
