"""Native C++ sampler tests: same invariants as the numpy strategies
(cross-implementation check, the host-side analog of the reference's
cross-mode kernel tests)."""

import numpy as np
import pytest

from mcmc_ammsb import native
from mcmc_ammsb.config import Config, SampleStrategy
from mcmc_ammsb.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb.sampling import MiniBatchSampler
from mcmc_ammsb.types import pack_edges

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ toolchain")


@pytest.fixture(scope="module")
def setup():
    n, u, v = synthetic_edges(500, 10, seed=3)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=4)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    return n, split, graph


@pytest.mark.parametrize("strategy", ["NodeLink", "NodeNonLink", "Node",
                                      "BFLink", "BFNonLink", "BF"])
def test_native_batches_invariants(setup, strategy):
    n, split, graph = setup
    cfg = Config(K=8, mini_batch_size=16,
                 strategy=SampleStrategy.parse(strategy),
                 host_sampler="native")
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    sampler = MiniBatchSampler(cfg, graph, split)
    assert sampler.use_native
    stacked = sampler.sample_many(8)
    training = set(pack_edges(graph.edges_u, graph.edges_v).tolist())
    heldout = set(pack_edges(split.heldout_u, split.heldout_v).tolist())
    for s in range(8):
        ne = int(stacked.edge_mask[s].sum())
        assert ne > 0
        eu = stacked.edges_u[s][:ne]
        ev = stacked.edges_v[s][:ne]
        assert np.all(eu < ev)
        keys = pack_edges(eu, ev)
        assert len(set(keys.tolist())) == ne          # edges distinct
        # mask is a clean prefix
        assert not stacked.edge_mask[s][ne:].any()
        # node list = deduped endpoints
        nn = int(stacked.node_mask[s].sum())
        got_nodes = set(stacked.nodes[s][:nn].tolist())
        assert got_nodes == set(eu.tolist()) | set(ev.tolist())
        if strategy == "NodeLink":
            assert all(int(k) in training for k in keys)
            assert stacked.weight[s] == cfg.N
        elif strategy == "NodeNonLink":
            assert ne == cfg.mini_batch_size
            assert not any(int(k) in training or int(k) in heldout
                           for k in keys)
            assert np.isclose(stacked.weight[s],
                              2.0 * cfg.E / cfg.mini_batch_size)
        elif strategy == "BFLink":
            assert all(int(k) in training for k in keys)
        elif strategy == "BFNonLink":
            assert not any(int(k) in training for k in keys)


def test_native_deterministic(setup):
    n, split, graph = setup
    cfg = Config(K=8, mini_batch_size=8, host_sampler="native")
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    a = MiniBatchSampler(cfg, graph, split).sample_many(4)
    b = MiniBatchSampler(cfg, graph, split).sample_many(4)
    np.testing.assert_array_equal(a.edges_u, b.edges_u)
    np.testing.assert_array_equal(a.weight, b.weight)


def test_native_snap_parse(tmp_path, setup):
    p = tmp_path / "g.txt"
    p.write_text("# comment\n# another\n5\t7\n7\t5\n5\t5\n9 11\n")
    u, v = native.snap_parse(str(p))
    # self loop dropped; canonicalized; duplicates retained for numpy dedup
    assert len(u) == 3
    assert list(u) == [5, 5, 9] and list(v) == [7, 7, 11]


def test_native_matches_python_parser(tmp_path):
    from mcmc_ammsb.data import load_snap_edges, renumber_dedup_shuffle
    rng = np.random.RandomState(0)
    a = rng.randint(0, 1000, 5000)
    b = rng.randint(0, 1000, 5000)
    p = tmp_path / "big.txt"
    p.write_text("# hdr\n" + "\n".join(f"{x}\t{y}" for x, y in zip(a, b)))
    n1, u1, v1 = load_snap_edges(str(p), use_native="never")
    un, vn = native.snap_parse(str(p))
    n2, u2, v2 = renumber_dedup_shuffle(un, vn)
    assert n1 == n2
    np.testing.assert_array_equal(u1, u2)
    np.testing.assert_array_equal(v1, v2)


def test_native_snap_parse_rejects_malformed(tmp_path, setup):
    """Strict parse: a non-comment line that is not two ints raises
    (parity with numpy's loadtxt on the fallback path)."""
    p = tmp_path / "bad.csv"
    p.write_text("1,2\n3,4\n")
    with pytest.raises(IOError, match="malformed"):
        native.snap_parse(str(p))
    p2 = tmp_path / "bad2.txt"
    p2.write_text("1 2\n3\n")
    with pytest.raises(IOError, match="malformed"):
        native.snap_parse(str(p2))
    p3 = tmp_path / "neg.txt"
    p3.write_text("1 2\n-3 4\n")
    with pytest.raises(IOError, match="malformed"):
        native.snap_parse(str(p3))


def test_gz_always_native_raises(tmp_path):
    from mcmc_ammsb.data import load_snap_edges
    import gzip as _gz
    p = tmp_path / "g.txt.gz"
    with _gz.open(p, "wt") as f:
        f.write("1 2\n")
    with pytest.raises(RuntimeError, match="gzip"):
        load_snap_edges(str(p), use_native="always")
    # numpy path still reads it
    n, u, v = load_snap_edges(str(p), use_native="auto")
    assert n == 2 and len(u) == 1


def test_native_chd_build_matches_numpy(setup):
    """Native and numpy CHD constructions must produce identical tables
    (same greedy order, same hashes)."""
    import numpy as np
    from mcmc_ammsb.ops import edgeset as es
    rng = np.random.RandomState(7)
    a = rng.randint(0, 3000, 20000)
    b = rng.randint(0, 3000, 20000)
    keep = a != b
    u = np.minimum(a, b)[keep].astype(np.int64)
    v = np.maximum(a, b)[keep].astype(np.int64)
    pk = np.unique(u * 3000 + v)
    u, v = (pk // 3000).astype(np.int32), (pk % 3000).astype(np.int32)
    E = len(u)
    M = 1 << int(np.ceil(np.log2(max(2, E / 0.8))))
    NB = 1 << max(0, int(np.ceil(np.log2(max(1, E // 4)))))
    with np.errstate(over="ignore"):
        seed = np.uint32(1)
        got = native.chd_build(u, v, M, NB, int(seed))
        want = es._chd_attempt_numpy(u.astype(np.uint32),
                                     v.astype(np.uint32), M, NB, seed)
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_ref_theta_init_bit_stream():
    """The exact reference theta-init stream (learner.cc:149-153):
    deterministic, gamma-distributed, interleaved layout — and wired
    through Config.theta_init into init_state."""
    a = native.ref_theta_init(1.0, 1.0, 6342455113, 64)
    b = native.ref_theta_init(1.0, 1.0, 6342455113, 64)
    np.testing.assert_array_equal(a, b)          # deterministic
    assert (a > 0).all()
    # a different seed gives a different stream; the 32-bit truncation
    # law matters: 6342455113 % 2**32 must give the SAME stream (the
    # reference passes the long literal straight into std::mt19937)
    c = native.ref_theta_init(1.0, 1.0, 6342455113 % 2**32, 64)
    np.testing.assert_array_equal(a, c)
    d = native.ref_theta_init(1.0, 1.0, 12345, 64)
    assert (a != d).any()
    # gamma(2, 3): mean 6, var 18 — sanity at scale
    big = native.ref_theta_init(2.0, 3.0, 7, 200_000)
    assert abs(big.mean() - 6.0) < 0.1
    assert abs(big.var() - 18.0) < 1.0

    from mcmc_ammsb.learner import init_state

    n, u, v = synthetic_edges(60, 6, seed=3)
    split = generate_sets(n, u, v, heldout_ratio=0.2, seed=4)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=4, num_node_sample=4,
                 theta_init="libstdc++").finalize(
        n, split.total_edges, graph.max_fan_out)
    st = init_state(cfg, len(split.heldout_edges_u))
    want = native.ref_theta_init(cfg.eta0, cfg.eta1, cfg.init_seed,
                                 16).reshape(8, 2)
    np.testing.assert_array_equal(np.asarray(st.theta), want)
    np.testing.assert_allclose(
        np.asarray(st.beta), want[:, 1] / want.sum(-1), rtol=1e-6)
