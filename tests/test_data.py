"""Data/ETL tests — property patterns of /root/reference/mcmc/data-test.cc."""

import numpy as np
import pytest

from mcmc_ammsb.data import (Graph, dump_dataset, generate_sets,
                             load_dataset, load_snap_edges,
                             renumber_dedup_shuffle, synthetic_edges)
from mcmc_ammsb.types import canonicalize, pack_edges, unpack_edges


def test_pack_unpack_roundtrip():
    rng = np.random.RandomState(0)
    u = rng.randint(0, 2**31 - 1, 1000)
    v = rng.randint(0, 2**31 - 1, 1000)
    pu, pv = unpack_edges(pack_edges(u, v))
    np.testing.assert_array_equal(pu, u)
    np.testing.assert_array_equal(pv, v)


def test_renumber_dedup():
    a = np.array([10, 20, 10, 30, 30, 5])
    b = np.array([20, 10, 20, 5, 5, 5])  # dup edges + one self loop
    n, u, v = renumber_dedup_shuffle(a, b)
    assert n == 4  # {5, 10, 20, 30}
    assert len(u) == 2  # (10,20) and (5,30), deduped; (5,5) dropped
    assert np.all(u < v)
    assert np.all(u >= 0) and np.all(v < n)


def test_snap_loader(tmp_path):
    p = tmp_path / "graph.txt"
    p.write_text(
        "# Directed graph\n# Nodes: 4 Edges: 4\n# header\n# FromNodeId\tToNodeId\n"
        "100\t200\n200\t100\n100\t300\n300\t400\n"
    )
    n, u, v = load_snap_edges(str(p))
    assert n == 4
    assert len(u) == 3  # (100,200) deduped


def test_graph_csr(small_dataset):
    n, split, graph = small_dataset
    assert graph.num_nodes == n
    # symmetric adjacency property (data-test.cc:27-53)
    for u, v in zip(split.training_u[:50], split.training_v[:50]):
        assert graph.has_edge(int(u), int(v))
        assert graph.has_edge(int(v), int(u))
    assert graph.max_fan_out == int(graph.degrees.max())
    # rows sorted
    r = graph.neighbors_of(int(split.training_u[0]))
    assert np.all(np.diff(r) > 0)


def test_generate_sets_invariants(small_dataset):
    n, split, graph = small_dataset
    e = split.total_edges
    heldout_len = len(split.heldout_u)
    training_len = len(split.training_u)
    assert training_len + heldout_len == e
    assert training_len == int(np.ceil((1 - 0.2 / 2) * e))
    # evaluation edges: real heldout then equal count of fakes
    assert len(split.heldout_edges_u) == 2 * heldout_len
    # fakes are not real edges (neither training nor heldout)
    all_real = set(pack_edges(
        np.concatenate([split.training_u, split.heldout_u]),
        np.concatenate([split.training_v, split.heldout_v]),
    ).tolist())
    fakes = pack_edges(split.heldout_edges_u[heldout_len:],
                       split.heldout_edges_v[heldout_len:])
    assert not (set(fakes.tolist()) & all_real)
    assert len(set(fakes.tolist())) == heldout_len  # distinct fakes


def test_dataset_cache_roundtrip(tmp_path, small_dataset):
    n, split, _ = small_dataset
    u = np.concatenate([split.heldout_u, split.training_u])
    v = np.concatenate([split.heldout_v, split.training_v])
    path = str(tmp_path / "cache.npz")
    dump_dataset(path, n, 0.2, u, v)
    n2, ratio, u2, v2 = load_dataset(path)
    assert n2 == n and ratio == 0.2
    np.testing.assert_array_equal(u2, u)
    np.testing.assert_array_equal(v2, v)


def test_dataset_cache_reference_format(tmp_path, small_dataset):
    """fmt="ref" writes the reference's exact gzip binary layout
    (main.cc:110-126): uint64 N, float32 ratio, uint64 count, packed
    uint64 edges — verified byte-by-byte here, and load_dataset
    auto-detects it from the gzip magic."""
    import gzip

    n, split, _ = small_dataset
    u = np.concatenate([split.heldout_u, split.training_u])
    v = np.concatenate([split.heldout_v, split.training_v])
    path = str(tmp_path / "cache.gz")
    dump_dataset(path, n, 0.25, u, v, fmt="ref")

    # byte-level layout check against a hand-built reference stream
    from mcmc_ammsb.types import pack_edges
    expect = (np.uint64(n).astype("<u8").tobytes()
              + np.float32(0.25).astype("<f4").tobytes()
              + np.uint64(len(u)).astype("<u8").tobytes()
              + np.ascontiguousarray(pack_edges(u, v), "<u8").tobytes())
    with gzip.open(path, "rb") as f:
        assert f.read() == expect

    n2, ratio, u2, v2 = load_dataset(path)
    assert n2 == n and ratio == np.float32(0.25)
    np.testing.assert_array_equal(u2, u)
    np.testing.assert_array_equal(v2, v)


def test_dataset_cache_ref_truncation_raises(tmp_path, small_dataset):
    import gzip

    n, split, _ = small_dataset
    path = str(tmp_path / "cache.gz")
    dump_dataset(path, n, 0.25, split.training_u, split.training_v,
                 fmt="ref")
    with gzip.open(path, "rb") as f:
        blob = f.read()
    with gzip.open(path, "wb") as f:
        f.write(blob[:-8])  # drop the last edge
    with pytest.raises(IOError, match="header says"):
        load_dataset(path)


def test_dump_unknown_format_raises(tmp_path):
    with pytest.raises(ValueError, match="format"):
        dump_dataset(str(tmp_path / "x"), 4, 0.1,
                     np.array([0]), np.array([1]), fmt="hdf")


def test_synthetic_sbm_structure():
    from mcmc_ammsb.data import synthetic_sbm_edges
    n, u, v = synthetic_sbm_edges(600, 4, p_in=0.2, p_out=0.002, seed=5)
    assert n <= 600
    assert np.all(u < v)
    # edge count should be dominated by intra-community pairs:
    # expected intra ~ 4 * C(150,2) * 0.2 = 8940, inter ~ 360
    assert 5000 < len(u) < 15000


def test_powerlaw_generator_heavy_tail_and_labels():
    """Degree-corrected power-law surrogate: heavy-tailed degrees
    (max >> avg, unlike the near-regular uniform generator), planted
    structure (intra-community edge share ~ intra_fraction), labels
    aligned with renumbered ids."""
    from mcmc_ammsb.data import Graph, synthetic_powerlaw_edges

    n, u, v, labels = synthetic_powerlaw_edges(
        5000, 8.0, exponent=2.5, max_degree=150, num_communities=8,
        intra_fraction=0.8, seed=3, return_labels=True)
    assert len(labels) == n
    g = Graph.from_edges(n, u, v)
    deg = np.diff(g.offsets)
    avg = deg.mean()
    assert deg.max() > 5 * avg          # heavy tail
    assert deg.max() <= 260             # cap respected (Poisson slack)
    intra = (labels[u] == labels[v]).mean()
    assert intra > 0.6                  # planted structure present
    # canonical, deduped, no self loops (generator contract)
    assert (u < v).all()
    from mcmc_ammsb.types import pack_edges
    assert len(np.unique(pack_edges(u, v))) == len(u)
