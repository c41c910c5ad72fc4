"""Edge-membership tests against a host oracle — the pattern of
/root/reference/mcmc/cuckoo-test.cc:29-115 (positive + negative keys
checked on both host structure and device lookup)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_ammsb.config import EdgeSetBackend
from mcmc_ammsb.data import synthetic_edges
from mcmc_ammsb.ops.edgeset import build_edge_set
from mcmc_ammsb.types import pack_edges

BACKENDS = [EdgeSetBackend.CSR, EdgeSetBackend.SORTED, EdgeSetBackend.CUCKOO,
            EdgeSetBackend.PERFECT, EdgeSetBackend.ADJACENCY]


@pytest.fixture(scope="module")
def edge_data():
    n, u, v = synthetic_edges(num_nodes=500, avg_degree=12, seed=11)
    oracle = set(pack_edges(u, v).tolist())
    rng = np.random.RandomState(5)
    qu = rng.randint(0, n, 4000).astype(np.int32)
    qv = rng.randint(0, n, 4000).astype(np.int32)
    # mix in guaranteed positives, half given in reversed order
    pu = np.concatenate([u[:500], v[500:1000]]).astype(np.int32)
    pv = np.concatenate([v[:500], u[500:1000]]).astype(np.int32)
    qu = np.concatenate([qu, pu])
    qv = np.concatenate([qv, pv])
    keep = qu != qv
    qu, qv = qu[keep], qv[keep]
    expected = np.array([
        int(pack_edges(min(a, b), max(a, b))) in oracle
        for a, b in zip(qu.tolist(), qv.tolist())
    ])
    return n, u, v, qu, qv, expected


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
def test_membership_matches_oracle(edge_data, backend):
    n, u, v, qu, qv, expected = edge_data
    es = build_edge_set(backend, n, u, v)
    got = np.asarray(jax.jit(es.has_edges)(qu, qv))
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
def test_membership_2d_batch(edge_data, backend):
    n, u, v, qu, qv, expected = edge_data
    es = build_edge_set(backend, n, u, v)
    m = (len(qu) // 8) * 8
    got = np.asarray(es.has_edges(qu[:m].reshape(8, -1),
                                  qv[:m].reshape(8, -1)))
    np.testing.assert_array_equal(got.ravel(), expected[:m])


def test_empty_rows_negative():
    # nodes with no edges must always test negative (csr backend)
    u = np.array([0, 1], np.int32)
    v = np.array([1, 2], np.int32)
    es = build_edge_set(EdgeSetBackend.CSR, 10, u, v)
    got = np.asarray(es.has_edges(
        np.array([5, 0, 9], np.int32), np.array([6, 1, 0], np.int32)))
    np.testing.assert_array_equal(got, [False, True, False])


def test_adjacency_broadcast_query_shapes(edge_data):
    """The adjacency backend gathers rows for the smaller query side
    pre-broadcast — the [S, B, 1] x [S, B, n] neighbor-membership shape
    must agree with the hash backend elementwise."""
    n, u, v, qu, qv, expected = edge_data
    adj = build_edge_set(EdgeSetBackend.ADJACENCY, n, u, v)
    ph = build_edge_set(EdgeSetBackend.PERFECT, n, u, v)
    rng = np.random.RandomState(7)
    nodes = rng.randint(0, n, (6, 8)).astype(np.int32)
    nbrs = rng.randint(0, n, (6, 8, 5)).astype(np.int32)
    a = np.asarray(jax.jit(adj.has_edges)(nodes[:, :, None], nbrs))
    b = np.asarray(jax.jit(ph.has_edges)(nodes[:, :, None], nbrs))
    assert a.shape == (6, 8, 5)
    np.testing.assert_array_equal(a, b)


def test_auto_backend_resolution():
    """AUTO -> adjacency when the [N, max_deg] matrix fits the budget,
    else the perfect hash."""
    from mcmc_ammsb.ops import edgeset as es_mod
    n, u, v = synthetic_edges(num_nodes=300, avg_degree=8, seed=3)
    assert build_edge_set(EdgeSetBackend.AUTO, n, u, v).backend == \
        "adjacency"
    old = es_mod.ADJACENCY_AUTO_BUDGET_BYTES
    try:
        es_mod.ADJACENCY_AUTO_BUDGET_BYTES = 16  # force the fallback
        assert build_edge_set(EdgeSetBackend.AUTO, n, u, v).backend == \
            "perfect"
    finally:
        es_mod.ADJACENCY_AUTO_BUDGET_BYTES = old


def test_perfect_empty_and_singleton():
    """Degenerate sizes: empty table answers all-False; a single edge
    is found in both query orders."""
    es = build_edge_set(EdgeSetBackend.PERFECT, 10,
                        np.array([], np.int32), np.array([], np.int32))
    r = np.asarray(es.has_edges(jnp.asarray([1, 2]), jnp.asarray([3, 4])))
    assert not r.any()
    es = build_edge_set(EdgeSetBackend.PERFECT, 10,
                        np.array([2], np.int32), np.array([7], np.int32))
    r = np.asarray(es.has_edges(jnp.asarray([7, 2, 0]),
                                jnp.asarray([2, 7, 1])))
    assert r.tolist() == [True, True, False]
